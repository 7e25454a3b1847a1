"""Supernodal partitioned Cholesky: the config-4 large-graph solve.

Port of ``ndtpu/graph/supernodal.py``. The host plans once per topology
(an optional RCM ordering, ``dist.schur.plan_partition`` into P contiguous
supernodes, each shard's local separator set); each damped Gauss-Newton
step then

1. assembles the partitioned normal equations ``h_ii [P, 3ni, 3ni]``,
   ``h_is [P, 3ni, 3nsl]`` (against the shard's LOCAL separators), ``h_ss
   [3ns, 3ns]``, ``b_i [P, 3ni]`` and ``b_s [3ns]`` from K5's factor blocks
   (K9a ``supernodal_assemble``, ``kernels/csrc/supernodal.cu``);
2. eliminates every interior in one batched Cholesky and solves against
   ``[h_is | b_i]`` (``cholesky_ex`` / ``cholesky_solve``, as the reference
   leaves them to XLA), and forms each shard's Schur part ``h_is^T w``;
3. routes the parts into the global separator system and damps it (K9b
   ``schur_reduce``), solves it (``cholesky_ex``), and back-substitutes
   the interiors.

The kernels route by tables the plan builds on the host
(``dist.schur.build_routes``, which the distributed solve's K9c shares):
for every target 3x3 block (and 3-vector) of step 1 the ordered endpoint
pairs that land there, in pair order; for every separator row of step 3
the shards whose local sets hold it, and the columns some such shard
holds (:func:`touch_table`, which the plan adds to those tables: K9b sums
those entries and copies ``h_ss`` elsewhere). One owner
sums each target in that fixed order with no float atomics, so a step is
the same on every launch. The plain versions
(:func:`supernodal_assemble_ref`, :func:`schur_reduce_ref`: the
reference's segment sums) take CPU tensors and are the kernels' oracle;
CUDA tensors go to the kernels or raise. :func:`supernodal_assemble_model`
and :func:`schur_reduce_model` are the plain models of K9a's and K9b's sum
orders, which the kernels equal bit for bit.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import NamedTuple

import numpy as np
import torch

from ndtpu_torch import kernels
from ndtpu_torch.config import SolverConfig
from ndtpu_torch.dist.schur import (INTERIOR, SEPARATOR, Routes, SchurPlan,
                                    _assemble_model, _block_ids,
                                    _local_blocks, _seg_sum, _vec_ids,
                                    build_routes, plan_partition)
from ndtpu_torch.graph import factors as fct
from ndtpu_torch.graph import solve as slv

__all__ = ["SupernodalPlan", "tables_on", "plan_supernodal",
           "supernodal_assemble", "supernodal_assemble_ref",
           "supernodal_assemble_model", "schur_reduce",
           "schur_reduce_ref", "schur_reduce_model", "touch_table",
           "interior_parts", "separator_solve",
           "back_substitute", "supernodal_delta", "optimize_supernodal"]


#: The SchurPlan arrays the plain versions and the step read.
_PLAN_ARRAYS = ("fac_idx", "fac_mask", "i_role", "i_loc", "j_role", "j_loc",
                "pri_idx", "pri_mask", "p_role", "p_loc", "int_mask",
                "sep_mask")


def tables_on(plan: "SupernodalPlan", device) -> SimpleNamespace:
    """The routes' tables and the plan's arrays (``_PLAN_ARRAYS`` and the
    local slots ``i/j/p_loc_l``) as tensors on ``device``, made once per
    device. The plan's integer arrays become int64 (the plain versions'
    flat ids); the kernels' tables keep their int32."""
    key = str(torch.device(device))
    cache = plan.routes._on
    if key not in cache:
        src = {k: getattr(plan.schur, k) for k in _PLAN_ARRAYS}
        src.update(i_loc_l=plan.i_loc_l, j_loc_l=plan.j_loc_l,
                   p_loc_l=plan.p_loc_l)
        src = {k: np.asarray(v, np.int64) if v.dtype.kind in "iu" else v
               for k, v in src.items()}
        src.update(plan.routes.host)
        cache[key] = SimpleNamespace(**{
            k: torch.as_tensor(np.ascontiguousarray(v), device=device)
            for k, v in src.items()})
    return cache[key]


def touch_table(ls_global, ls_mask, ns: int):
    """K9b's held columns: ``(touch_ptr [ns+1], touch_col)``, for each
    separator row the ascending union of the local separator sets of the
    shards that hold it, and the row itself (so its diagonal is always
    among them). :func:`plan_supernodal` adds both to its routes' tables
    (``Routes.host``)."""
    pairs = [np.arange(ns, dtype=np.int64) * (ns + 1)]
    for g, m in zip(ls_global, ls_mask):
        held = g[m].astype(np.int64)
        pairs.append((held[:, None] * ns + held[None, :]).reshape(-1))
    keys = np.unique(np.concatenate(pairs))
    ptr = np.zeros(ns + 1, np.int64)
    np.cumsum(np.bincount(keys // ns, minlength=ns), out=ptr[1:])
    return ptr, keys % ns


class SupernodalPlan(NamedTuple):
    schur: SchurPlan
    perm: np.ndarray       # [V] ordering (position -> original pose)
    n_shards: int
    ns_loc: int            # padded local separator slots per shard
    ls_global: np.ndarray  # [P, NSL] global separator slot per local slot
    ls_mask: np.ndarray    # [P, NSL]
    i_loc_l: np.ndarray    # [P, F] LOCAL separator slot of endpoint i
    j_loc_l: np.ndarray    # [P, F]
    p_loc_l: np.ndarray    # [P, Q]
    routes: Routes         # the kernels' tables (the port's own)


def plan_supernodal(graph: fct.PoseGraph, n_shards: int,
                    use_rcm: bool = False) -> SupernodalPlan:
    """Host-side symbolic analysis: ordering, supernode partition, each
    shard's local separator set and the kernels' routing tables.

    ``use_rcm=False`` by default: SLAM trajectories and Manhattan walks are
    near-banded in their natural order, whose contiguous partition gives
    the smallest separators; RCM (``ndtpu_torch.native.rcm_order``) is for
    graphs whose order has no locality (e.g. shuffled g2o files)."""
    bet_i = graph.bet_i.cpu().numpy()
    bet_j = graph.bet_j.cpu().numpy()
    bet_mask = graph.bet_mask.cpu().numpy()
    v = graph.poses.shape[0]

    if use_rcm:
        from ndtpu_torch.native import rcm_order
        perm = rcm_order(bet_i[bet_mask], bet_j[bet_mask], v)
    else:
        perm = np.arange(v, dtype=np.int32)
    inv = np.empty(v, np.int64)
    inv[perm] = np.arange(v)

    plan = plan_partition(
        inv[bet_i].astype(np.int32), inv[bet_j].astype(np.int32), bet_mask,
        inv[graph.prior_idx.cpu().numpy()].astype(np.int32),
        graph.prior_mask.cpu().numpy(), v, n_shards)
    p_dim, ni, ns = plan.fac_idx.shape[0], plan.ni, plan.ns
    # Which global separator slots each shard's factors and priors touch.
    sep_sets = []
    for s in range(p_dim):
        slots = set()
        fm = plan.fac_mask[s]
        slots.update(plan.i_loc[s][fm & (plan.i_role[s] == 1)].tolist())
        slots.update(plan.j_loc[s][fm & (plan.j_role[s] == 1)].tolist())
        pm = plan.pri_mask[s]
        slots.update(plan.p_loc[s][pm & (plan.p_role[s] == 1)].tolist())
        sep_sets.append(sorted(slots))
    ns_loc = max(1, max(len(x) for x in sep_sets))
    ls_global = np.zeros((p_dim, ns_loc), np.int32)
    ls_mask = np.zeros((p_dim, ns_loc), bool)
    local_of = [dict() for _ in range(p_dim)]
    for s, slots in enumerate(sep_sets):
        ls_global[s, : len(slots)] = slots
        ls_mask[s, : len(slots)] = True
        local_of[s] = {gs: k for k, gs in enumerate(slots)}

    def to_local(role, loc, mask):
        out = np.zeros_like(loc)
        for s in range(p_dim):
            sep_rows = mask[s] & (role[s] == 1)
            out[s, sep_rows] = [local_of[s][gs]
                                for gs in loc[s, sep_rows].tolist()]
        return out.astype(np.int32)

    i_loc_l = to_local(plan.i_role, plan.i_loc, plan.fac_mask)
    j_loc_l = to_local(plan.j_role, plan.j_loc, plan.fac_mask)
    p_loc_l = to_local(plan.p_role, plan.p_loc, plan.pri_mask)

    # The reference's guard, kept so the same graphs are refused: its
    # plain assembly routes blocks by flat ids below a 2**30 sentinel, and
    # a huge separator makes the dense [3ns, 3ns] solve dominate.
    n_ii = p_dim * ni * ni * 9
    n_is = p_dim * ni * ns_loc * 9
    n_ss = ns * ns * 9
    if n_ii + n_is + n_ss >= 2**30 or ns > 20000:
        raise ValueError(
            f"graph too large for the supernodal path (ns={ns}, "
            f"ns_loc={ns_loc}, flat ids={n_ii + n_is + n_ss:.2e} vs the "
            f"2**30 sentinel bound): this graph partitions poorly at "
            f"n_shards={n_shards}. Use fewer shards, "
            f"or the matrix-free PCG solver "
            f"(ndtpu_torch.graph.solve.optimize(method='pcg'); on the card "
            f"K6g takes graphs of any size device memory holds).")

    # The variable maps in ORIGINAL pose indices, so the step writes
    # straight into the unpermuted delta.
    plan = plan._replace(int_global=perm[plan.int_global].astype(np.int32),
                         sep_global=perm[plan.sep_global].astype(np.int32))
    routes = build_routes(plan, ns_loc, ls_global, ls_mask, i_loc_l, j_loc_l,
                     p_loc_l, bet_i.shape[0], graph.prior_idx.shape[0])
    touch_ptr, touch_col = touch_table(ls_global, ls_mask, ns)
    routes.host.update(touch_ptr=touch_ptr.astype(np.int32),
                       touch_col=touch_col.astype(np.int32))
    return SupernodalPlan(schur=plan, perm=np.asarray(perm),
                          n_shards=n_shards, ns_loc=ns_loc,
                          ls_global=ls_global, ls_mask=ls_mask,
                          i_loc_l=i_loc_l, j_loc_l=j_loc_l, p_loc_l=p_loc_l,
                          routes=routes)


def supernodal_assemble_ref(plan: SupernodalPlan, ai, aj, r, ap, rp):
    """The plain version of K9a (CPU path and oracle): the reference's
    segment sums. Every ordered endpoint pair's ``A^T B`` goes by flat id
    into exactly one of ``h_ii``, ``h_is`` (local separator columns) or
    ``h_ss`` by the roles of its endpoints (separator-interior pairs are
    dropped), and every endpoint's ``A^T r`` into ``b_i`` or ``b_s``.
    Returns ``(h_ii, h_is, h_ss, b_i [P, 3ni], b_s [3ns])``."""
    t = tables_on(plan, ai.device)
    sp = plan.schur
    ni, ns, nsl = sp.ni, sp.ns, plan.ns_loc
    p_dim, fmax = sp.fac_idx.shape
    flat = lambda x: x.reshape(-1)
    # Each shard's factor and prior slots, flattened (masked slots are
    # dropped by their flags).
    (ra, la, rb, lb, vals, valid), (rv, lv, vecs, validv) = _local_blocks(
        ai[t.fac_idx].reshape(-1, 3, 3), aj[t.fac_idx].reshape(-1, 3, 3),
        r[t.fac_idx].reshape(-1, 3), ap[t.pri_idx].reshape(-1, 3, 3),
        rp[t.pri_idx].reshape(-1, 3), flat(t.fac_mask), flat(t.i_role),
        flat(t.i_loc), flat(t.j_role), flat(t.j_loc), flat(t.pri_mask),
        flat(t.p_role), flat(t.p_loc))
    shard = torch.arange(p_dim, device=ai.device)
    sh_f = flat(shard[:, None].expand(p_dim, fmax))
    sh_q = flat(shard[:, None].expand_as(t.pri_idx))
    shards = torch.cat([sh_f, sh_f, sh_f, sh_f, sh_q])
    lb_l = torch.cat([flat(x) for x in (t.i_loc_l, t.j_loc_l, t.i_loc_l,
                                        t.j_loc_l, t.p_loc_l)])
    ii = (ra == INTERIOR) & (rb == INTERIOR) & valid
    is_ = (ra == INTERIOR) & (rb == SEPARATOR) & valid
    ss = (ra == SEPARATOR) & (rb == SEPARATOR) & valid
    irow = shards * ni + la
    h_ii = _seg_sum(vals, _block_ids(irow, lb, ni, ii), p_dim * ni * ni * 9)
    h_is = _seg_sum(vals, _block_ids(irow, lb_l, nsl, is_),
                    p_dim * ni * nsl * 9)
    h_ss = _seg_sum(vals, _block_ids(la, lb, ns, ss), ns * ns * 9)
    vrow = torch.cat([sh_f, sh_f, sh_q]) * ni + lv
    b_i = _seg_sum(vecs, _vec_ids(vrow, (rv == INTERIOR) & validv),
                   p_dim * ni * 3)
    b_s = _seg_sum(vecs, _vec_ids(lv, (rv == SEPARATOR) & validv), ns * 3)
    return (h_ii.reshape(p_dim, 3 * ni, 3 * ni),
            h_is.reshape(p_dim, 3 * ni, 3 * nsl),
            h_ss.reshape(3 * ns, 3 * ns), b_i.reshape(p_dim, 3 * ni), b_s)


def supernodal_assemble(plan: SupernodalPlan, ai, aj, r, ap, rp):
    """K9a wrapper: CUDA tensors go to the kernel (one launch; the same on
    every launch), CPU tensors to :func:`supernodal_assemble_ref`. The
    linearization must be of the graph the plan was made for (its routes
    index the factor and prior slots)."""
    if (ai.shape[0], ap.shape[0]) != (plan.routes.n_fac, plan.routes.n_pri):
        raise ValueError(
            f"supernodal_assemble: {ai.shape[0]} factor and {ap.shape[0]} "
            f"prior rows, the plan was made for {plan.routes.n_fac} and "
            f"{plan.routes.n_pri}")
    if not ai.is_cuda:
        return supernodal_assemble_ref(plan, ai, aj, r, ap, rp)
    t = tables_on(plan, ai.device)
    sp = plan.schur
    return kernels.supernodal_assemble(
        ai, aj, r, ap, rp, t.row_ptr, t.tgt_col, t.tgt_ptr, t.code,
        t.vec_ptr, t.vcode, sp.fac_idx.shape[0], sp.ni, plan.ns_loc, sp.ns)


def supernodal_assemble_model(plan: SupernodalPlan, ai, aj, r, ap, rp):
    """Plain model of K9a's sum order, op for op, which the kernel equals
    bit for bit on the card (``dist.schur._assemble_model`` on the plan's
    routing tables): every target entry summed over its pairs in
    ``tgt_ptr`` order from +0 as ``mtm3`` writes it, ``b`` as ``mtv3``,
    zeros elsewhere. Returns ``(h_ii, h_is, h_ss, b_i, b_s)``. Nothing on
    the main path calls this."""
    sp = plan.schur
    return _assemble_model(plan.routes.host, sp.fac_idx.shape[0], sp.ni,
                           plan.ns_loc, sp.ns, ai, aj, r, ap, rp)


def schur_reduce_ref(plan: SupernodalPlan, s_part, rhs_part, h_ss, b_s, lam):
    """The plain version of K9b (CPU path and oracle): the shards' Schur
    parts ``s_part [P, 3nsl, 3nsl]`` and ``rhs_part [P, 3nsl]`` summed into
    the global separator system by flat ids, ``s_tot = h_ss - sum + diag(lam
    * max(|diag h_ss|, 1e-8) + (1 - live))`` (the damping reads ``h_ss``
    before the subtraction) and ``rhs_tot = b_s - sum``."""
    t = tables_on(plan, s_part.device)
    ns3 = 3 * plan.schur.ns
    dt = s_part.dtype
    gidx, gvalid = t.gidx, t.gvalid
    pair_idx = torch.where(gvalid[:, :, None] & gvalid[:, None, :],
                           gidx[:, :, None] * ns3 + gidx[:, None, :],
                           torch.full_like(gidx[:, :, None], ns3 * ns3))
    s_red = _seg_sum(s_part.reshape(-1), pair_idx.reshape(-1),
                     ns3 * ns3).reshape(ns3, ns3)
    rhs_red = _seg_sum(rhs_part.reshape(-1),
                       torch.where(gvalid, gidx, ns3).reshape(-1), ns3)
    s_tot = h_ss - s_red
    rhs_tot = b_s - rhs_red
    live_s = t.sep_mask.to(dt).repeat_interleave(3)
    damp_s = (lam * torch.clamp(torch.abs(torch.diagonal(h_ss)), min=1e-8)
              + (1.0 - live_s))
    return s_tot + torch.diag(damp_s), rhs_tot


def schur_reduce_model(plan: SupernodalPlan, s_part, rhs_part, h_ss, b_s,
                       lam):
    """Plain model of K9b's sum order, op for op, which the kernel equals
    bit for bit on the card: ``s_tot`` is ``h_ss`` but at the held entries
    (the columns ``touch_col`` of each separator row), where ``acc`` starts
    at +0 and adds the part of each of the row's holders in shard order
    that also holds the column, then ``h_ss - acc``, on the diagonal plus
    ``lam * max(|h_ss|, 1e-8) + (1 - live)``; ``rhs_tot = b_s - acc`` with
    ``acc`` over the holders in the same order. A holder that does not hold
    the column adds +0, which leaves an ``acc`` from +0 unchanged. Nothing
    on the main path calls this."""
    t = tables_on(plan, s_part.device)
    sp = plan.schur
    ns, ns3, nsl3 = sp.ns, 3 * sp.ns, 3 * plan.ns_loc
    dev = s_part.device
    hold_ptr = t.hold_ptr.long()
    n_hold = hold_ptr[1:] - hold_ptr[:-1]                       # [ns]
    depth = int(n_hold.max()) if ns else 0
    # The held entries, row-major within each separator's 3 x 3 blocks.
    touch_ptr = t.touch_ptr.long()
    g1 = torch.repeat_interleave(torch.arange(ns, device=dev),
                                 touch_ptr[1:] - touch_ptr[:-1])
    e, comp = g1.shape[0], torch.arange(3, device=dev)
    per_entry = lambda x: x.expand(e, 3, 3).reshape(-1)
    rr, cb = per_entry(comp[:, None]), per_entry(comp)
    g1e = per_entry(g1[:, None, None])
    g2e = per_entry(t.touch_col.long()[:, None, None])
    rows, cols = 3 * g1e + rr, 3 * g2e + cb
    s_flat, r_flat = s_part.reshape(-1), rhs_part.reshape(-1)
    acc = torch.zeros(rows.shape[0], dtype=s_part.dtype, device=dev)
    racc = torch.zeros((ns, 3), dtype=s_part.dtype, device=dev)
    zero = torch.zeros((), dtype=s_part.dtype, device=dev)
    for j in range(depth):
        has = n_hold > j
        h = torch.where(has, hold_ptr[:-1] + j, torch.zeros_like(hold_ptr[:-1]))
        p, k1 = t.hold_shard.long()[h], t.hold_loc.long()[h]     # [ns]
        pe, k1e = p[g1e], k1[g1e]
        k2 = t.loc_of.long()[pe, g2e]
        use = has[g1e] & (k2 >= 0)
        at = ((pe * nsl3 + 3 * k1e + rr) * nsl3 + 3 * k2.clamp(min=0) + cb)
        acc = acc + torch.where(use, s_flat[at], zero)
        rat = (p[:, None] * nsl3 + 3 * k1[:, None] + comp[None, :])
        racc = racc + torch.where(has[:, None], r_flat[rat], zero)
    at = rows * ns3 + cols
    hv = h_ss.reshape(-1)[at]
    v = hv - acc
    live = t.sep_mask.to(s_part.dtype)[g1e]
    damp = lam * torch.clamp(torch.abs(hv), min=1e-8) + (1.0 - live)
    v = torch.where(rows == cols, v + damp, v)
    s_tot = h_ss.clone().reshape(-1)
    s_tot[at] = v
    return s_tot.reshape(ns3, ns3), b_s - racc.reshape(-1)


def schur_reduce(plan: SupernodalPlan, s_part, rhs_part, h_ss, b_s, lam):
    """K9b wrapper: CUDA tensors go to the kernel (one launch, no float
    atomics; :func:`schur_reduce_model`'s bits), CPU tensors to
    :func:`schur_reduce_ref`. ``lam`` is a Python float."""
    if not s_part.is_cuda:
        return schur_reduce_ref(plan, s_part, rhs_part, h_ss, b_s, lam)
    t = tables_on(plan, s_part.device)
    return kernels.schur_reduce(s_part, rhs_part, h_ss, b_s, t.hold_ptr,
                                t.hold_shard, t.hold_loc, t.loc_of,
                                t.touch_ptr, t.touch_col, t.sep_mask, lam,
                                plan.ns_loc)


def interior_parts(plan: SupernodalPlan, h_ii, h_is, b_i, lam):
    """Damp every interior (in place on ``h_ii``'s diagonal), factor them
    in one batched Cholesky and solve against ``[h_is | b_i]``; returns
    ``(w, y, s_part, rhs_part)`` with the shards' Schur parts ``h_is^T w
    [P, 3nsl, 3nsl]`` and ``h_is^T y [P, 3nsl]``. A failed Cholesky gives
    NaN (no host check), which the LM accept test rejects."""
    t = tables_on(plan, h_ii.device)
    nsl3 = 3 * plan.ns_loc
    live_i = t.int_mask.to(h_ii.dtype).repeat_interleave(3, dim=1)
    diag_i = torch.diagonal(h_ii, dim1=-2, dim2=-1)
    diag_i += lam * torch.clamp(torch.abs(diag_i), min=1e-8) + (1.0 - live_i)
    l, _ = torch.linalg.cholesky_ex(h_ii)
    sol = torch.cholesky_solve(torch.cat([h_is, b_i[..., None]], -1), l)
    st = h_is.transpose(-1, -2) @ sol                    # h_is^T [w | y]
    return (sol[..., :nsl3], sol[..., nsl3], st[..., :nsl3].contiguous(),
            st[..., nsl3].contiguous())


def separator_solve(s_tot, rhs_tot):
    """The damped separator system's solution ``x_s [3ns]``."""
    ls, _ = torch.linalg.cholesky_ex(s_tot)
    return torch.cholesky_solve(-rhs_tot[:, None], ls)[:, 0]


def back_substitute(plan: SupernodalPlan, n_poses: int, w, y, x_s):
    """The interiors from the separators' solution, and both written into
    the delta ``[V, 3]``. Padded slots name pose 0: only live slots are
    written."""
    t = tables_on(plan, x_s.device)
    x_s_loc = torch.where(t.gvalid, x_s[t.gidx.clamp(0, x_s.shape[0] - 1)],
                          torch.zeros((), dtype=x_s.dtype,
                                      device=x_s.device))
    x_i = -(y + (w @ x_s_loc[..., None])[..., 0])                 # [P, ni3]
    delta = torch.zeros((n_poses, 3), dtype=x_s.dtype, device=x_s.device)
    delta.index_copy_(0, t.int_pose, x_i.reshape(-1, 3)[t.int_rows])
    delta.index_copy_(0, t.sep_pose, x_s.reshape(-1, 3)[t.sep_rows])
    return delta


def supernodal_delta(graph: fct.PoseGraph, lin, plan: SupernodalPlan, lam):
    """One damped Gauss-Newton step by batched supernodal elimination;
    delta ``[V, 3]``. ``lam`` is a Python float."""
    (ai, aj, r), (ap, rp) = lin
    h_ii, h_is, h_ss, b_i, b_s = supernodal_assemble(plan, ai, aj, r, ap, rp)
    w, y, s_part, rhs_part = interior_parts(plan, h_ii, h_is, b_i, lam)
    s_tot, rhs_tot = schur_reduce(plan, s_part, rhs_part, h_ss, b_s, lam)
    return back_substitute(plan, graph.poses.shape[0], w, y,
                           separator_solve(s_tot, rhs_tot))


def optimize_supernodal(graph: fct.PoseGraph, cfg: SolverConfig,
                        n_shards: int = 32, huber_delta: float = 0.0,
                        plan: SupernodalPlan | None = None
                        ) -> slv.SolveResult:
    """The nonlinear LM loop around the supernodal step (config 4's entry
    point). As in the reference, the accept test and the step's size are
    read on the host every iteration."""
    if plan is None:
        plan = plan_supernodal(graph, n_shards)
    dt, dev = graph.poses.dtype, graph.poses.device
    lam = cfg.init_lambda
    chi = float(fct.chi2(graph, huber_delta))
    it, converged = 0, False
    for it in range(1, cfg.max_iter + 1):
        lin = fct.linearize(graph, huber_delta)
        delta = supernodal_delta(graph, lin, plan, lam)
        trial = graph._replace(
            poses=slv._apply_delta(graph.poses, delta, graph.pose_mask))
        chi_t = float(fct.chi2(trial, huber_delta))
        if chi_t < chi:
            graph, chi = trial, chi_t
            lam = max(lam / cfg.lambda_down, 1e-12)
            if float(torch.max(torch.abs(delta))) < cfg.tol:
                converged = True
                break
        else:
            lam *= cfg.lambda_up
            if lam > 1e8:
                break
    return slv.SolveResult(graph=graph,
                           chi2=torch.tensor(chi, dtype=dt, device=dev),
                           n_iter=torch.tensor(it, dtype=torch.int32,
                                               device=dev),
                           converged=torch.tensor(converged, device=dev))
