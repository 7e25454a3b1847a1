"""Distributed pose-graph solve: Schur-complement reduction over separators.

Port of ``ndtpu/dist/schur.py``. The host plans once per topology
(``SchurPlan``, ``plan_partition``; numpy, array for array equal to the
reference's): poses split into contiguous shards, a pose touched by a
factor across shards is a separator, every factor and prior goes to one
shard. The supernodal solve (``graph/supernodal.py``) builds on the plan;
the incremental smoother's k-hop local path uses
:func:`assemble_local` (``h_ii``, ``b_i`` only; K7b
``csrc/local_system.cu`` on the card, :func:`assemble_local_ref` on the
CPU).

The distributed solve (:func:`optimize_schur`, :func:`schur_delta`) runs
one rank per process, each holding only its own shard's factor rows
(:func:`shard_factor_data_local`). Per damped Gauss-Newton step a rank

1. linearizes its rows (K5 ``factor_linearize``, :func:`_linearize_shard`);
2. assembles its five parts ``h_ii [3ni, 3ni]`` (damped), ``h_is [3ni,
   3ns]``, ``h_ss [3ns, 3ns]``, ``b_i``, ``b_s`` (K9c
   ``schur_local_assemble``, K9a's body on one-shard routes from
   :func:`rank_routes`; :func:`schur_local_assemble_ref` on the CPU);
3. eliminates its interiors (``cholesky_ex`` / ``cholesky_solve`` and two
   products, as the reference leaves them to XLA);
4. sums ``[s_part | rhs_part | diag h_ss]`` over the ranks in ONE
   all-reduce (the reference's fused ``psum``), damps and solves the
   separator system (identical on every rank), back-substitutes its
   interiors, and sums the delta in a second all-reduce.

The LM loop adds the chi^2 of the linearization and of the trial as two
more all-reduces (four per iteration, as the reference's four ``psum``),
and the host reads two control values per iteration (accept, step size).
The collective is :func:`ndtpu_torch.dist.mesh.all_reduce`:
``torch.distributed`` over gloo, which takes CUDA tensors, so ranks may
share one card (NCCL refuses two ranks on one device). NCCL is for ranks
on cards of their own, which a one-card machine cannot test (ROADMAP
C-w9).
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import NamedTuple

import numpy as np
import torch

from ndtpu_torch import kernels
from ndtpu_torch.config import SolverConfig
from ndtpu_torch.dist import mesh as dmesh
from ndtpu_torch.graph import factors as fct
from ndtpu_torch.graph import solve as slv

__all__ = ["INTERIOR", "SEPARATOR", "SchurPlan", "ShardData", "Routes",
           "plan_partition", "build_routes", "shard_factor_data", "shard_factor_data_local",
           "assemble_local_parts", "assemble_local", "assemble_local_ref",
           "rank_routes", "rank_tables", "schur_local_assemble",
           "schur_local_assemble_ref", "schur_delta", "optimize_schur"]

INTERIOR, SEPARATOR = 0, 1


class SchurPlan(NamedTuple):
    """Host-built static partition plan (numpy)."""

    n_shards: int
    ni: int               # padded interior slots per shard
    ns: int               # total separator count (padded to >= 1)
    fmax: int             # padded factors per shard
    pmax: int             # padded priors per shard
    # factor assignment [S, Fmax]:
    fac_idx: np.ndarray   # index into the global between-factor arrays
    fac_mask: np.ndarray  # bool
    i_role: np.ndarray    # INTERIOR/SEPARATOR of endpoint i
    i_loc: np.ndarray     # local slot (interior) or separator slot of i
    j_role: np.ndarray
    j_loc: np.ndarray
    # prior assignment [S, Pmax]:
    pri_idx: np.ndarray
    pri_mask: np.ndarray
    p_role: np.ndarray
    p_loc: np.ndarray
    # variable maps (padded slots hold pose 0, masked):
    int_global: np.ndarray  # [S, NI] global pose index per interior slot
    int_mask: np.ndarray    # [S, NI]
    sep_global: np.ndarray  # [NS]
    sep_mask: np.ndarray    # [NS]


def plan_partition(bet_i, bet_j, bet_mask, pri_idx, pri_mask, n_poses: int,
                   n_shards: int) -> SchurPlan:
    """Contiguous-range partition of poses ``0..n_poses-1`` into
    ``n_shards``; poses touched by a factor across shards are separators,
    the rest the interiors of their shard. Each live factor goes to the
    shard of its endpoint i, each live prior to its pose's shard."""
    bet_i, bet_j = np.asarray(bet_i), np.asarray(bet_j)
    bet_mask = np.asarray(bet_mask)
    pri_idx, pri_mask = np.asarray(pri_idx), np.asarray(pri_mask)

    shard_of = np.minimum(
        np.arange(n_poses) * n_shards // max(n_poses, 1), n_shards - 1)
    cross = bet_mask & (shard_of[bet_i] != shard_of[bet_j])
    is_sep = np.zeros(n_poses, bool)
    is_sep[bet_i[cross]] = True
    is_sep[bet_j[cross]] = True

    sep_ids = np.nonzero(is_sep)[0]
    ns = max(len(sep_ids), 1)
    sep_slot = np.full(n_poses, -1, np.int64)
    sep_slot[sep_ids] = np.arange(len(sep_ids))

    interiors = [np.nonzero((shard_of == s) & ~is_sep)[0]
                 for s in range(n_shards)]
    ni = max(1, max(len(x) for x in interiors))
    int_global = np.zeros((n_shards, ni), np.int32)
    int_mask = np.zeros((n_shards, ni), bool)
    int_slot = np.full(n_poses, -1, np.int64)
    for s, ids in enumerate(interiors):
        int_global[s, : len(ids)] = ids
        int_mask[s, : len(ids)] = True
        int_slot[ids] = np.arange(len(ids))

    def role_loc(pose_ids):
        role = np.where(is_sep[pose_ids], SEPARATOR, INTERIOR)
        loc = np.where(is_sep[pose_ids], sep_slot[pose_ids],
                       int_slot[pose_ids])
        return role.astype(np.int32), np.maximum(loc, 0).astype(np.int32)

    def assign(shard, live, cols):
        per = [np.nonzero(live & (shard == s))[0] for s in range(n_shards)]
        width = max(1, max(len(x) for x in per))
        idx = np.zeros((n_shards, width), np.int32)
        mask = np.zeros((n_shards, width), bool)
        out = [np.zeros((n_shards, width), np.int32)
               for _ in range(2 * len(cols))]
        for s, ids in enumerate(per):
            k = len(ids)
            idx[s, :k] = ids
            mask[s, :k] = True
            for c, pose_ids in enumerate(cols):
                out[2 * c][s, :k], out[2 * c + 1][s, :k] = \
                    role_loc(pose_ids[ids])
        return width, idx, mask, out

    fmax, fac_idx, fac_mask, (i_role, i_loc, j_role, j_loc) = assign(
        shard_of[bet_i], bet_mask, [bet_i, bet_j])
    pmax, pri_idx_a, pri_mask_a, (p_role, p_loc) = assign(
        shard_of[np.clip(pri_idx, 0, n_poses - 1)], pri_mask, [pri_idx])

    sep_mask = np.zeros(ns, bool)
    sep_mask[: len(sep_ids)] = True
    sep_global = np.zeros(ns, np.int32)
    sep_global[: len(sep_ids)] = sep_ids
    return SchurPlan(
        n_shards=n_shards, ni=ni, ns=ns, fmax=fmax, pmax=pmax,
        fac_idx=fac_idx, fac_mask=fac_mask,
        i_role=i_role, i_loc=i_loc, j_role=j_role, j_loc=j_loc,
        pri_idx=pri_idx_a, pri_mask=pri_mask_a, p_role=p_role, p_loc=p_loc,
        int_global=int_global, int_mask=int_mask,
        sep_global=sep_global, sep_mask=sep_mask)


class Routes:
    """The kernels' routing tables, built on the host once per plan.

    K9a (one owner per block row: ``P * ni`` interior rows, then ``ns``
    separator rows): ``row_ptr [R+1]`` into the row's targets, ``tgt_col``
    (interior rows: ``< ni`` a column of ``h_ii``, else ``ni +`` a local
    separator column of ``h_is``; separator rows: a column of ``h_ss``),
    ``tgt_ptr [T+1]`` into ``code`` (``4 f + kind`` for the pairs (i,i),
    (i,j), (j,i), (j,j) of between factor ``f``, ``4 F + q`` for prior
    ``q``), ``vec_ptr [R+1]`` into ``vcode`` (``2 f + side``, ``2 F +
    q``). K9b: ``hold_ptr [ns+1]`` into ``hold_shard``/``hold_loc`` (the
    shards holding each separator, with its local slot, in shard order) and
    ``loc_of [P, ns]`` (a separator's local slot in a shard, -1 where not
    held). The step's gathers: ``gidx``/``gvalid [P, 3nsl]`` (each local
    separator row's global row) and the live interior and separator rows
    with their poses. The plan's own arrays stay in the plan
    (``graph.supernodal.tables_on`` converts both)."""

    def __init__(self, host: dict, n_fac: int, n_pri: int):
        self.host = host
        self.n_fac, self.n_pri = n_fac, n_pri   # the graph's factor slots
        self._on: dict = {}


def _cat(*arrays):
    return np.concatenate([np.asarray(a).reshape(-1) for a in arrays])


def _csr(keys, n_rows):
    """``(order, row_ptr)``: a stable sort of ``keys`` and each row's
    start in it."""
    order = np.argsort(keys, kind="stable")
    ptr = np.zeros(n_rows + 1, np.int64)
    np.cumsum(np.bincount(keys, minlength=n_rows), out=ptr[1:])
    return order, ptr


def build_routes(sp: SchurPlan, ns_loc, ls_global, ls_mask, i_loc_l,
                 j_loc_l, p_loc_l, n_fac: int, n_pri: int) -> Routes:
    """K9a's (and K9c's) routing tables for a plan whose shards hold the
    local separator sets ``ls_global``/``ls_mask`` ``[P, NSL]``, with each
    factor's and prior's local separator slots ``i/j/p_loc_l``; ``n_fac``
    and ``n_pri`` are the graph's slot counts (see :class:`Routes`)."""
    p_dim, fmax = sp.fac_idx.shape
    pmax = sp.pri_idx.shape[1]
    ni, ns = sp.ni, sp.ns
    n_int = p_dim * ni
    shard_f = np.repeat(np.arange(p_dim), fmax)
    shard_q = np.repeat(np.arange(p_dim), pmax)
    f = sp.fac_idx.reshape(-1).astype(np.int64)
    q = sp.pri_idx.reshape(-1).astype(np.int64)

    # K9a: the ordered endpoint pairs in the reference's order (i,i), (i,j),
    # (j,i), (j,j), (p,p), each class routed to its owner row and column.
    ra = _cat(sp.i_role, sp.i_role, sp.j_role, sp.j_role, sp.p_role)
    la = _cat(sp.i_loc, sp.i_loc, sp.j_loc, sp.j_loc, sp.p_loc)
    rb = _cat(sp.i_role, sp.j_role, sp.i_role, sp.j_role, sp.p_role)
    lb = _cat(sp.i_loc, sp.j_loc, sp.i_loc, sp.j_loc, sp.p_loc)
    lb_l = _cat(i_loc_l, j_loc_l, i_loc_l, j_loc_l, p_loc_l)
    shard = _cat(shard_f, shard_f, shard_f, shard_f, shard_q)
    valid = _cat(sp.fac_mask, sp.fac_mask, sp.fac_mask, sp.fac_mask,
                 sp.pri_mask)
    code = _cat(4 * f, 4 * f + 1, 4 * f + 2, 4 * f + 3, 4 * n_fac + q)
    ii = valid & (ra == INTERIOR) & (rb == INTERIOR)
    is_ = valid & (ra == INTERIOR) & (rb == SEPARATOR)
    ss = valid & (ra == SEPARATOR) & (rb == SEPARATOR)
    keep = ii | is_ | ss
    row = np.where(ss, n_int + la, shard * ni + la)[keep].astype(np.int64)
    col = np.where(is_, ni + lb_l, lb)[keep].astype(np.int64)
    key = row * (ni + ns_loc + ns) + col
    order = np.argsort(key, kind="stable")
    key = key[order]
    first = np.ones(len(key), bool)
    first[1:] = key[1:] != key[:-1]
    starts = np.nonzero(first)[0]
    tgt_row = row[order][starts]
    _, row_ptr = _csr(tgt_row, n_int + ns)
    tgt_ptr = np.append(starts, len(key))

    # The right-hand side: one A^T r per factor endpoint (i, j, p).
    rv = _cat(sp.i_role, sp.j_role, sp.p_role)
    lv = _cat(sp.i_loc, sp.j_loc, sp.p_loc)
    vshard = _cat(shard_f, shard_f, shard_q)
    vvalid = _cat(sp.fac_mask, sp.fac_mask, sp.pri_mask)
    vcode = _cat(2 * f, 2 * f + 1, 2 * n_fac + q)
    vrow = np.where(rv == SEPARATOR, n_int + lv, vshard * ni + lv)[vvalid]
    vorder, vec_ptr = _csr(vrow.astype(np.int64), n_int + ns)

    # K9b: the shards holding each separator, in shard order.
    hs, hk = np.nonzero(ls_mask)
    hg = ls_global[hs, hk].astype(np.int64)
    horder, hold_ptr = _csr(hg, ns)
    loc_of = np.full((p_dim, ns), -1, np.int32)
    loc_of[hs, hg] = hk

    # The step's gathers.
    nsl3 = 3 * ns_loc
    gidx = (ls_global[:, :, None].astype(np.int64) * 3
            + np.arange(3)).reshape(p_dim, nsl3)
    int_rows = np.nonzero(sp.int_mask.reshape(-1))[0]
    sep_rows = np.nonzero(sp.sep_mask)[0]
    i32 = lambda a: np.ascontiguousarray(a, np.int32)
    i64 = lambda a: np.ascontiguousarray(a, np.int64)
    return Routes(dict(
        row_ptr=i32(row_ptr), tgt_col=i32(col[order][starts]),
        tgt_ptr=i32(tgt_ptr), code=i32(code[keep][order]),
        vec_ptr=i32(vec_ptr), vcode=i32(vcode[vvalid][vorder]),
        hold_ptr=i32(hold_ptr), hold_shard=i32(hs[horder]),
        hold_loc=i32(hk[horder]), loc_of=loc_of, gidx=gidx,
        gvalid=np.repeat(ls_mask, 3, axis=1),
        int_rows=int_rows, int_pose=i64(sp.int_global.reshape(-1)[int_rows]),
        sep_rows=sep_rows, sep_pose=i64(sp.sep_global[sep_rows])),
        n_fac=n_fac, n_pri=n_pri)


def _seg_sum(vals, ids, n):
    """``segment_sum`` with ids ``>= n`` dropped (routed to a spare slot)."""
    ids = torch.where(ids < n, ids, torch.full_like(ids, n))
    out = torch.zeros(n + 1, dtype=vals.dtype, device=vals.device)
    return out.index_add_(0, ids, vals)[:-1]


def _block_ids(row, col, n_cols, match):
    """Flat ids of each 3 x 3 block's entries in a ``[3 rows, 3 n_cols]``
    target; unmatched blocks go past the end (dropped)."""
    comp = torch.arange(3, device=row.device)
    row = torch.where(match, row, torch.full_like(row, -1))
    ids = ((row[:, None, None] * 3 + comp[:, None]) * (3 * n_cols)
           + col[:, None, None] * 3 + comp[None, :])
    return torch.where(match[:, None, None], ids,
                       torch.full_like(ids, 2 ** 30)).reshape(-1)


def _vec_ids(row, match):
    comp = torch.arange(3, device=row.device)
    row = torch.where(match, row, torch.full_like(row, -1))
    ids = row[:, None] * 3 + comp[None, :]
    return torch.where(match[:, None], ids,
                       torch.full_like(ids, 2 ** 30)).reshape(-1)


def _local_blocks(ai, aj, r, ap, rp, s_fac_mask, s_i_role, s_i_loc,
                  s_j_role, s_j_loc, s_pri_mask, s_p_role, s_p_loc):
    """Every 3x3 block ``G_a^T G_b`` of a local linearization with its row
    and column role and slot and its mask, and every 3-vector ``G^T r``
    likewise: ``((ra, la, rb, lb, vals, valid), (rv, lv, vecs, validv))``."""
    ra = torch.cat([s_i_role, s_i_role, s_j_role, s_j_role, s_p_role])
    la = torch.cat([s_i_loc, s_i_loc, s_j_loc, s_j_loc, s_p_loc])
    rb = torch.cat([s_i_role, s_j_role, s_i_role, s_j_role, s_p_role])
    lb = torch.cat([s_i_loc, s_j_loc, s_i_loc, s_j_loc, s_p_loc])
    ga = torch.cat([ai, ai, aj, aj, ap])
    gb = torch.cat([ai, aj, ai, aj, ap])
    valid = torch.cat([s_fac_mask] * 4 + [s_pri_mask])
    vals = (ga.transpose(-1, -2) @ gb).reshape(-1)              # [K * 9]
    res = torch.cat([r, r, rp])
    rv = torch.cat([s_i_role, s_j_role, s_p_role])
    lv = torch.cat([s_i_loc, s_j_loc, s_p_loc])
    gv = torch.cat([ai, aj, ap])
    validv = torch.cat([s_fac_mask, s_fac_mask, s_pri_mask])
    vecs = (gv * res[..., :, None]).sum(-2).reshape(-1)         # [K * 3]
    return (ra, la, rb, lb, vals, valid), (rv, lv, vecs, validv)


def assemble_local_ref(ni, *parts):
    """The plain version of K7b (CPU path and oracle): ``(h_ii [3ni, 3ni],
    b_i [3ni])`` of :func:`assemble_local_parts`, without the separator
    parts, by the same segment sums. ``parts`` are its arguments from
    ``ai`` to ``s_p_loc``."""
    (ra, la, rb, lb, vals, valid), (rv, lv, vecs, validv) = \
        _local_blocks(*parts)
    ii = (ra == INTERIOR) & (rb == INTERIOR) & valid
    h_ii = _seg_sum(vals, _block_ids(la, lb, ni, ii), ni * ni * 9)
    b_i = _seg_sum(vecs, _vec_ids(lv, (rv == INTERIOR) & validv), ni * 3)
    return h_ii.reshape(3 * ni, 3 * ni), b_i


def assemble_local(ni, ai, aj, r, ap, rp, s_fac_mask, s_i_role, s_i_loc,
                   s_j_role, s_j_loc, s_pri_mask, s_p_role, s_p_loc):
    """K7b wrapper: the local system ``(h_ii, b_i)`` of ``ni`` interior
    poses. CUDA tensors go to the kernel (no float atomics: the same on
    every launch), CPU tensors to :func:`assemble_local_ref`."""
    if not ai.is_cuda:
        return assemble_local_ref(ni, ai, aj, r, ap, rp, s_fac_mask,
                                  s_i_role, s_i_loc, s_j_role, s_j_loc,
                                  s_pri_mask, s_p_role, s_p_loc)
    return kernels.local_assemble(ni, ai, aj, r, ap, rp, s_fac_mask,
                                  s_i_role, s_i_loc, s_j_role, s_j_loc,
                                  s_pri_mask, s_p_role, s_p_loc)


def assemble_local_parts(ni, ns, ai, aj, r, ap, rp, s_fac_mask,
                         s_i_role, s_i_loc, s_j_role, s_j_loc,
                         s_pri_mask, s_p_role, s_p_loc, dt):
    """``(h_ii [3ni,3ni], h_is [3ni,3ns], h_ss [3ns,3ns], b_i [3ni],
    b_s [3ns])`` from a local linearization, each 3x3 factor block routed
    by a flat segment id into its target (no dense local matrix)."""
    (ra, la, rb, lb, vals, valid), (rv, lv, vecs, validv) = _local_blocks(
        ai, aj, r, ap, rp, s_fac_mask, s_i_role, s_i_loc, s_j_role, s_j_loc,
        s_pri_mask, s_p_role, s_p_loc)
    ii = (ra == INTERIOR) & (rb == INTERIOR) & valid
    is_ = (ra == INTERIOR) & (rb == SEPARATOR) & valid
    ss = (ra == SEPARATOR) & (rb == SEPARATOR) & valid
    h_ii = _seg_sum(vals, _block_ids(la, lb, ni, ii), ni * ni * 9)
    h_is = _seg_sum(vals, _block_ids(la, lb, ns, is_), ni * ns * 9)
    h_ss = _seg_sum(vals, _block_ids(la, lb, ns, ss), ns * ns * 9)
    b_i = _seg_sum(vecs, _vec_ids(lv, (rv == INTERIOR) & validv), ni * 3)
    b_s = _seg_sum(vecs, _vec_ids(lv, (rv == SEPARATOR) & validv), ns * 3)
    return (h_ii.reshape(3 * ni, 3 * ni), h_is.reshape(3 * ni, 3 * ns),
            h_ss.reshape(3 * ns, 3 * ns), b_i, b_s)


class ShardData(NamedTuple):
    """Per-shard slices of the factor SoA (leading axis = shard; one row
    from :func:`shard_factor_data_local`)."""

    bi: torch.Tensor     # [S, Fmax] global pose index of endpoint i
    bj: torch.Tensor     # [S, Fmax]
    z: torch.Tensor      # [S, Fmax, 3]
    sqi: torch.Tensor    # [S, Fmax, 3, 3]
    fmask: torch.Tensor  # [S, Fmax] bool
    pidx: torch.Tensor   # [S, Pmax] global pose index of each prior
    pz: torch.Tensor     # [S, Pmax, 3]
    psqi: torch.Tensor   # [S, Pmax, 3, 3]
    pmask: torch.Tensor  # [S, Pmax] bool


def _shard_rows(graph, fi, pi, fac_mask, pri_mask) -> ShardData:
    return ShardData(
        bi=graph.bet_i[fi], bj=graph.bet_j[fi], z=graph.bet_z[fi],
        sqi=graph.bet_sqrt_info[fi], fmask=fac_mask & graph.bet_mask[fi],
        pidx=graph.prior_idx[pi], pz=graph.prior_z[pi],
        psqi=graph.prior_sqrt_info[pi], pmask=pri_mask & graph.prior_mask[pi])


def shard_factor_data(graph: fct.PoseGraph, plan: SchurPlan) -> ShardData:
    """Every shard's measurement slice, ``[S, Fmax]`` / ``[S, Pmax]``, on
    the graph's device (one process holding all shards)."""
    dev = graph.poses.device
    t = lambda a: torch.as_tensor(np.asarray(a), device=dev)
    return _shard_rows(graph, t(plan.fac_idx).long(), t(plan.pri_idx).long(),
                       t(plan.fac_mask), t(plan.pri_mask))


def shard_factor_data_local(graph: fct.PoseGraph, plan: SchurPlan,
                            shard_id: int) -> ShardData:
    """ONE shard's row of :class:`ShardData` (leading axis 1), sliced on
    the host from the graph's arrays and moved to the graph's device: a
    rank holds O(F/S) of the factors."""
    dev = graph.poses.device
    host = {k: v.detach().cpu() for k, v in graph._asdict().items()}
    fi = torch.as_tensor(plan.fac_idx[shard_id], dtype=torch.long)
    pi = torch.as_tensor(plan.pri_idx[shard_id], dtype=torch.long)
    rows = _shard_rows(fct.PoseGraph(**host), fi, pi,
                       torch.as_tensor(plan.fac_mask[shard_id]),
                       torch.as_tensor(plan.pri_mask[shard_id]))
    return ShardData(*(x[None].to(dev) for x in rows))


def _plan_dev_args(plan: SchurPlan, device, shard: int):
    """One shard's role, slot and interior arrays of the plan as tensors on
    ``device`` (int64 / bool)."""
    out = {}
    for k in ("i_role", "i_loc", "j_role", "j_loc", "p_role", "p_loc",
              "int_global", "int_mask"):
        a = np.asarray(getattr(plan, k)[shard])
        out[k] = torch.as_tensor(a.astype(np.int64) if a.dtype.kind in "iu"
                                 else a, device=device)
    return out


def rank_routes(plan: SchurPlan, shard: int) -> dict:
    """K9c's routing tables for one rank: K9a's (:func:`build_routes`)
    for a one-shard plan whose factor and prior slots are the rank's local
    rows and whose local separator set is all ``ns`` separators. int32
    numpy arrays ``row_ptr``, ``tgt_col``, ``tgt_ptr``, ``code``,
    ``vec_ptr``, ``vcode``."""
    one = lambda a: np.asarray(a)[shard:shard + 1]
    ns = plan.ns
    sp = plan._replace(
        n_shards=1, fac_idx=np.arange(plan.fmax, dtype=np.int32)[None],
        fac_mask=one(plan.fac_mask), i_role=one(plan.i_role),
        i_loc=one(plan.i_loc), j_role=one(plan.j_role),
        j_loc=one(plan.j_loc),
        pri_idx=np.arange(plan.pmax, dtype=np.int32)[None],
        pri_mask=one(plan.pri_mask), p_role=one(plan.p_role),
        p_loc=one(plan.p_loc), int_global=one(plan.int_global),
        int_mask=one(plan.int_mask))
    routes = build_routes(sp, ns, np.arange(ns, dtype=np.int32)[None],
                     np.ones((1, ns), bool), sp.i_loc, sp.j_loc, sp.p_loc,
                     plan.fmax, plan.pmax)
    return {k: routes.host[k] for k in ("row_ptr", "tgt_col", "tgt_ptr",
                                        "code", "vec_ptr", "vcode")}


def rank_tables(plan: SchurPlan, shard: int, device) -> SimpleNamespace:
    """What one rank's step reads, on ``device``: its plan rows
    (:func:`_plan_dev_args`), the live interior slots with their poses and
    the live separators with theirs, the separator mask, and K9c's routes
    (on CUDA devices only)."""
    args = _plan_dev_args(plan, device, shard)
    int_mask = np.asarray(plan.int_mask[shard])
    int_rows = np.nonzero(int_mask)[0]
    sep_rows = np.nonzero(plan.sep_mask)[0]
    t = lambda a, dt=torch.long: torch.as_tensor(np.asarray(a), dtype=dt,
                                                 device=device)
    args.update(
        shard=shard, ni=plan.ni, ns=plan.ns,
        int_rows=t(int_rows),
        int_pose=t(np.asarray(plan.int_global[shard])[int_rows]),
        sep_rows=t(sep_rows), sep_pose=t(plan.sep_global[sep_rows]),
        sep_mask=t(plan.sep_mask, torch.bool))
    if torch.device(device).type == "cuda":
        args.update({k: t(v, torch.int32)
                     for k, v in rank_routes(plan, shard).items()})
    return SimpleNamespace(**args)


def schur_local_assemble_ref(t: SimpleNamespace, lam: float, ai, aj, r, ap,
                             rp, fac_mask, pri_mask):
    """The plain version of K9c (CPU path and oracle): the reference's
    :func:`assemble_local_parts` of one rank's rows, then its interior
    damping ``h_ii + diag(lam * max(|diag h_ii|, 1e-8) + (1 - live))``.
    Returns ``(h_ii, h_is, h_ss, b_i, b_s)``."""
    h_ii, h_is, h_ss, b_i, b_s = assemble_local_parts(
        t.ni, t.ns, ai, aj, r, ap, rp, fac_mask, t.i_role, t.i_loc,
        t.j_role, t.j_loc, pri_mask, t.p_role, t.p_loc, ai.dtype)
    live_i = t.int_mask.to(ai.dtype).repeat_interleave(3)
    damp_i = lam * torch.clamp(torch.abs(torch.diagonal(h_ii)), min=1e-8)
    return h_ii + torch.diag(damp_i + (1.0 - live_i)), h_is, h_ss, b_i, b_s


def schur_local_assemble(t: SimpleNamespace, lam: float, ai, aj, r, ap, rp,
                         fac_mask, pri_mask):
    """K9c wrapper: CUDA tensors go to the kernel (one launch, no float
    atomics; the masks are already in K5's rows), CPU tensors to
    :func:`schur_local_assemble_ref`. ``lam`` is a Python float."""
    if not ai.is_cuda:
        return schur_local_assemble_ref(t, lam, ai, aj, r, ap, rp, fac_mask,
                                        pri_mask)
    return kernels.schur_local_assemble(
        ai, aj, r, ap, rp, t.row_ptr, t.tgt_col, t.tgt_ptr, t.code,
        t.vec_ptr, t.vcode, t.int_mask, lam, t.ni, t.ns)


def _linearize_shard(poses, bi, bj, z, sqi, fmask, pidx, pz, psqi, pmask,
                     huber_delta: float = 0.0):
    """One shard's whitened, robust, masked linearization (K5 on the
    card): ``(ai, aj, r, ap, rp)``."""
    (ai, aj, r), (ap, rp) = fct.factor_linearize(
        poses, bi, bj, z, sqi, fmask, pidx, pz, psqi, pmask, huber_delta)
    return ai, aj, r, ap, rp


def _chi_shard(poses, bi, bj, z, sqi, fmask, pidx, pz, psqi, pmask,
               huber_delta: float = 0.0):
    """One shard's chi^2 contribution (K5's chi^2-only mode on the card)."""
    return fct.factor_linearize(poses, bi, bj, z, sqi, fmask, pidx, pz, psqi,
                                pmask, huber_delta, chi_only=True)


def _rank_parts(t: SimpleNamespace, lam: float, lin, fac_mask, pri_mask):
    """A rank's assembly and interior elimination: ``(w, y, packed)`` with
    ``w = h_ii^-1 h_is``, ``y = h_ii^-1 b_i`` and ``packed = [s_part |
    rhs_part | diag h_ss]`` (flat), the buffer the ranks sum. A failed
    Cholesky gives NaN (no host check), which the accept test rejects."""
    ai, aj, r, ap, rp = lin
    h_ii, h_is, h_ss, b_i, b_s = schur_local_assemble(
        t, lam, ai, aj, r, ap, rp, fac_mask, pri_mask)
    ns3 = 3 * t.ns
    l, _ = torch.linalg.cholesky_ex(h_ii)
    sol = torch.cholesky_solve(torch.cat([h_is, b_i[:, None]], 1), l)
    w, y = sol[:, :ns3], sol[:, ns3]
    st = h_is.T @ sol                                  # h_is^T [w | y]
    packed = torch.cat([(h_ss - st[:, :ns3]).reshape(-1),
                        b_s - st[:, ns3], torch.diagonal(h_ss)])
    return w, y, packed


def _separator_solve(t: SimpleNamespace, lam: float, packed):
    """The separator step from the summed ``packed`` buffer (identical on
    every rank): damping scaled by the PRE-elimination ``diag h_ss``, as
    the reference's ``solve_dense``; returns ``x_s [3ns]``."""
    ns3 = 3 * t.ns
    s_tot = packed[:ns3 * ns3].view(ns3, ns3)
    rhs_tot = packed[ns3 * ns3:ns3 * ns3 + ns3]
    diag_ss = packed[ns3 * ns3 + ns3:]
    live_s = t.sep_mask.to(packed.dtype).repeat_interleave(3)
    damp_s = lam * torch.clamp(torch.abs(diag_ss), min=1e-8)
    ls, _ = torch.linalg.cholesky_ex(s_tot + torch.diag(damp_s + (1.0
                                                                 - live_s)))
    return torch.cholesky_solve(-rhs_tot[:, None], ls)[:, 0]


def _interior_delta(t: SimpleNamespace, n_poses: int, w, y, x_s):
    """This rank's interiors back-substituted, ``x_i = -(y + w x_s)``,
    written at their poses of a zero ``[V, 3]`` (live slots only)."""
    x_i = -(y + w @ x_s)
    mine = torch.zeros((n_poses, 3), dtype=x_s.dtype, device=x_s.device)
    return mine.index_copy_(0, t.int_pose, x_i.view(-1, 3)[t.int_rows])


def _add_separators(t: SimpleNamespace, delta, x_s):
    """The summed delta plus the separators' solution at their poses."""
    return delta.index_add_(0, t.sep_pose, x_s.view(-1, 3)[t.sep_rows])


def _schur_delta_local(t: SimpleNamespace, lam: float, n_poses: int, lin,
                       fac_mask, pri_mask, reduce):
    """One rank's elimination, the fused separator sum, the separator
    solve and the back-substitution: the replicated delta ``[V, 3]``.
    ``reduce`` sums a tensor over the ranks in place and returns it
    (:func:`ndtpu_torch.dist.mesh.all_reduce`)."""
    w, y, packed = _rank_parts(t, lam, lin, fac_mask, pri_mask)
    x_s = _separator_solve(t, lam, reduce(packed))
    delta = reduce(_interior_delta(t, n_poses, w, y, x_s))
    return _add_separators(t, delta, x_s)


def _rank_inputs(mesh, graph: fct.PoseGraph, plan: SchurPlan,
                 sd: ShardData | None):
    """``(tables, local rows)`` of ``mesh``'s rank: ``sd`` may be the
    whole stack or the rank's own row."""
    if plan.n_shards != mesh.size:
        raise ValueError(f"the plan has {plan.n_shards} shards for "
                         f"{mesh.size} ranks")
    if sd is None:
        sd = shard_factor_data_local(graph, plan, mesh.rank)
    row = 0 if sd.bi.shape[0] == 1 else mesh.rank
    loc = tuple(x[row] for x in sd)
    return rank_tables(plan, mesh.rank, graph.poses.device), loc


def schur_delta(mesh, graph: fct.PoseGraph, plan: SchurPlan, lam,
                huber_delta: float = 0.0, sd: ShardData | None = None):
    """One damped Gauss-Newton step by distributed Schur elimination: this
    rank linearizes only its shard; returns the replicated delta ``[V,
    3]``. ``lam`` is a Python float."""
    t, loc = _rank_inputs(mesh, graph, plan, sd)
    lin = _linearize_shard(graph.poses, *loc, huber_delta)
    return _schur_delta_local(t, float(lam), graph.poses.shape[0], lin,
                              loc[4], loc[8],
                              lambda x: dmesh.all_reduce(mesh, x))


def optimize_schur(mesh, graph: fct.PoseGraph, plan: SchurPlan,
                   cfg: SolverConfig, huber_delta: float = 0.0,
                   sd: ShardData | None = None) -> slv.SolveResult:
    """The nonlinear LM loop around the distributed Schur step. Per
    iteration each rank linearizes its shard (K5), sums chi^2 (all-reduce
    1), takes the step (K9c, all-reduces 2-3), and sums the trial's chi^2
    (K5 chi^2 only, all-reduce 4); the host reads the accept test and the
    step size, as the reference's loop reads its two control scalars.
    Every rank takes the same decisions from the same summed values."""
    t, loc = _rank_inputs(mesh, graph, plan, sd)
    reduce = lambda x: dmesh.all_reduce(mesh, x)
    v = graph.poses.shape[0]
    poses, lam = graph.poses, cfg.init_lambda
    chi = torch.tensor(float("inf"), dtype=poses.dtype, device=poses.device)
    it, converged = 0, False
    for it in range(1, cfg.max_iter + 1):
        ai, aj, r, ap, rp = lin = _linearize_shard(poses, *loc, huber_delta)
        chi_c = reduce((torch.sum(r * r) + torch.sum(rp * rp)).reshape(1))
        delta = _schur_delta_local(t, lam, v, lin, loc[4], loc[8], reduce)
        trial = slv._apply_delta(poses, delta, graph.pose_mask)
        chi_t = reduce(_chi_shard(trial, *loc, huber_delta).reshape(1))
        accept = bool(chi_t < chi_c)
        step = float(torch.max(torch.abs(delta)))
        if accept:
            poses, chi = trial, chi_t[0]
            lam = max(lam / cfg.lambda_down, 1e-12)
            if step < cfg.tol:
                converged = True
                break
        else:
            chi = chi_c[0]
            lam *= cfg.lambda_up
            if lam > 1e8:
                break
    dev = poses.device
    return slv.SolveResult(graph=graph._replace(poses=poses), chi2=chi,
                           n_iter=torch.tensor(it, dtype=torch.int32,
                                               device=dev),
                           converged=torch.tensor(converged, device=dev))
