"""Incremental pose-graph smoothing (the iSAM2-capability smoother).

Port of ``ndtpu/graph/incremental.py`` without the marginals (ROADMAP A10):
warm-started LM-PCG updates, the settled-estimate skip, the k-hop local
update with its static capacities, and the periodic full solve.

Each ``lax.cond`` of the JAX version is a Python ``if`` on a 0-d tensor:
one host sync, and only the taken branch runs, as in ``cond``. ``lax.top_k``
over 0/1 flags becomes a stable descending sort, so ties keep the lower
index first exactly as ``top_k`` orders them.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ndtpu_torch.config import SolverConfig
from ndtpu_torch.graph import factors as fct
from ndtpu_torch.graph import solve as slv

__all__ = ["SmootherState", "init_smoother", "incremental_update",
           "local_update", "fresh_residual_max", "full_solve"]


class SmootherState(NamedTuple):
    graph: fct.PoseGraph
    lam: torch.Tensor             # [] LM damping carried across updates
    last_max_delta: torch.Tensor  # [] inf-norm of the last accepted step
    step: torch.Tensor            # [] int64 update counter


def init_smoother(graph: fct.PoseGraph) -> SmootherState:
    dt, dev = graph.poses.dtype, graph.poses.device
    return SmootherState(graph=graph,
                         lam=torch.tensor(1e-4, dtype=dt, device=dev),
                         last_max_delta=torch.tensor(float("inf"), dtype=dt,
                                                     device=dev),
                         step=torch.zeros((), dtype=torch.long, device=dev))


def _top_flags(flags, k):
    """Indices of the ``k`` largest 0/1 flags, ties in index order (the
    order ``lax.top_k`` returns)."""
    return torch.sort(flags.to(torch.int32), descending=True,
                      stable=True).indices[:k]


def _one_lm_step(graph, lam, chi, cfg: SolverConfig, huber_delta: float):
    """One accept/reject LM iteration with a PCG inner solve."""
    lin = fct.linearize(graph, huber_delta)
    delta, _ = slv.pcg(graph, lin, lam, cfg)
    trial_poses = slv._apply_delta(graph.poses, delta, graph.pose_mask)
    chi_t = fct.chi2(graph._replace(poses=trial_poses), huber_delta)
    accept = chi_t < chi
    graph_n = graph._replace(poses=torch.where(accept, trial_poses,
                                               graph.poses))
    chi_n = torch.where(accept, chi_t, chi)
    lam_n = torch.where(accept, torch.clamp(lam / cfg.lambda_down, min=1e-12),
                        lam * cfg.lambda_up)
    max_delta = torch.where(accept, torch.max(torch.abs(delta)),
                            torch.zeros_like(chi))
    return graph_n, chi_n, lam_n, max_delta


def _fresh_start(g: fct.PoseGraph, k: int):
    f_cap = g.bet_mask.shape[0]
    k = min(k, f_cap)
    return k, torch.clamp(g.n_between - k, 0, f_cap - k)


def fresh_residual_max(g: fct.PoseGraph, k: int = 64):
    """Max |whitened residual| over the K newest between-factor slots."""
    k, start = _fresh_start(g, k)
    sl = start + torch.arange(k, device=start.device)
    r = fct.between_error(g.poses[g.bet_i[sl]], g.poses[g.bet_j[sl]],
                          g.bet_z[sl])
    wr = (g.bet_sqrt_info[sl] * r[:, None, :]).sum(-1)
    return torch.max(torch.where(g.bet_mask[sl][:, None], torch.abs(wr),
                                 torch.zeros_like(wr)))


def _fresh_slice(g: fct.PoseGraph, k: int, since=None):
    """(i, j, mask) of the newest between-factor slots (``since``: factor
    count at the previous update)."""
    k, start = _fresh_start(g, k)
    slots = start + torch.arange(k, device=start.device)
    fresh_live = slots < g.n_between
    if since is not None:
        fresh_live = fresh_live & (slots >= since)
    return g.bet_i[slots], g.bet_j[slots], g.bet_mask[slots] & fresh_live


def _active_probe(g: fct.PoseGraph, cfg: SolverConfig, since=None):
    """k-hop active set around the newest factors (a fresh loop factor seeds
    its whole index interval) and whether it fits the local capacities.
    Returns ``(act [V] bool, touch [F] bool, ok [] bool)``."""
    v = g.poses.shape[0]
    dev = g.poses.device
    fi, fj, fm = _fresh_slice(g, cfg.local_fresh_k, since)
    loopy_f = fm & (torch.abs(fi - fj) > cfg.local_span_gap)
    lo = torch.min(torch.where(loopy_f, torch.minimum(fi, fj),
                               torch.full_like(fi, v)))
    hi = torch.max(torch.where(loopy_f, torch.maximum(fi, fj),
                               torch.full_like(fi, -1)))
    ids = torch.arange(v, device=dev)
    cyc = (ids >= lo) & (ids <= hi)

    act = torch.zeros(v, dtype=torch.long, device=dev)
    fm_l = fm.to(torch.long)
    act = act.scatter_reduce(0, fi, fm_l, "amax")
    act = act.scatter_reduce(0, fj, fm_l, "amax")
    act = torch.maximum(act, cyc.to(torch.long))
    m_l = g.bet_mask.to(torch.long)
    for _ in range(cfg.local_hops):
        fa = m_l * torch.maximum(act[g.bet_i], act[g.bet_j])
        act = act.scatter_reduce(0, g.bet_i, fa, "amax")
        act = act.scatter_reduce(0, g.bet_j, fa, "amax")
    act = act.to(torch.bool) & g.pose_mask
    touch = g.bet_mask & (act[g.bet_i] | act[g.bet_j])
    ok = ((act.sum() <= cfg.local_poses)
          & (touch.sum() <= cfg.local_factors))
    if since is not None:
        k = min(cfg.local_fresh_k, g.bet_mask.shape[0])
        ok = ok & (g.n_between - since <= k)
    return act, touch, ok


def _local_select(g: fct.PoseGraph, cfg: SolverConfig, since=None,
                  probe=None):
    """Topology-only selection for the k-hop local system: pose slots, the
    local index map, gathered-factor ids and endpoint roles."""
    from ndtpu_torch.dist.schur import INTERIOR, SEPARATOR

    v = g.poses.shape[0]
    dev = g.poses.device
    p_loc = min(cfg.local_poses, v)
    f_loc = min(cfg.local_factors, g.bet_mask.shape[0])
    act, touch, ok = (probe if probe is not None
                      else _active_probe(g, cfg, since))
    pid = _top_flags(act, p_loc)
    in_set = act[pid]
    loc_of = torch.zeros(v, dtype=torch.long, device=dev)
    loc_of[pid] = torch.arange(p_loc, device=dev)
    fid = _top_flags(touch, f_loc)
    f_sel = touch[fid]
    bi, bj = g.bet_i[fid], g.bet_j[fid]
    role = lambda ids: torch.where(act[ids], INTERIOR, SEPARATOR)
    p_act = act[g.prior_idx] & g.prior_mask
    return dict(p_loc=p_loc, pid=pid, in_set=in_set, loc_of=loc_of,
                fid=fid, f_sel=f_sel, bi=bi, bj=bj, ri=role(bi), rj=role(bj),
                rp=role(g.prior_idx), p_act=p_act, ok=ok)


def _local_system(g: fct.PoseGraph, cfg: SolverConfig, huber_delta: float,
                  sel):
    """The k-hop active subproblem (inactive endpoints held fixed).
    Returns ``(solve(lam) -> delta [V, 3], chi_local(poses))``."""
    from ndtpu_torch.dist.schur import assemble_local_parts

    v = g.poses.shape[0]
    p_loc = sel["p_loc"]
    pid, in_set, loc_of = sel["pid"], sel["in_set"], sel["loc_of"]
    fid, f_sel, bi, bj = sel["fid"], sel["f_sel"], sel["bi"], sel["bj"]
    p_act = sel["p_act"]
    sqi_f, z_f = g.bet_sqrt_info[fid], g.bet_z[fid]

    pi, pj = g.poses[bi], g.poses[bj]
    e = fct.between_error(pi, pj, z_f)
    ji, jj = fct._between_jacobians(pi, pj)
    ai, aj, r = sqi_f @ ji, sqi_f @ jj, (sqi_f * e[:, None, :]).sum(-1)
    if huber_delta > 0.0:
        w = fct.robust_weight(torch.linalg.norm(r, dim=-1), huber_delta)
        ai, aj, r = ai * w[:, None, None], aj * w[:, None, None], r * w[:, None]
    mf = f_sel.to(r.dtype)
    ai, aj, r = ai * mf[:, None, None], aj * mf[:, None, None], r * mf[:, None]

    ep0 = fct.prior_error(g.poses[g.prior_idx], g.prior_z)
    ap = g.prior_sqrt_info
    rp = (ap * ep0[:, None, :]).sum(-1)
    mp = p_act.to(rp.dtype)
    ap, rp = ap * mp[:, None, None], rp * mp[:, None]

    h_ii, _, _, b_i, _ = assemble_local_parts(
        p_loc, 1, ai, aj, r, ap, rp, f_sel, sel["ri"], loc_of[bi], sel["rj"],
        loc_of[bj], p_act, sel["rp"], loc_of[g.prior_idx], r.dtype)

    def solve(lam):
        live = in_set.to(r.dtype).repeat_interleave(3)
        damp = lam * torch.clamp(torch.abs(torch.diagonal(h_ii)), min=1e-8)
        h = h_ii + torch.diag(damp + (1.0 - live))
        l = torch.linalg.cholesky(h)
        x = torch.cholesky_solve(-b_i[:, None], l)[:, 0]
        delta = torch.zeros((v, 3), dtype=r.dtype, device=r.device)
        return delta.index_add_(0, pid, x.reshape(p_loc, 3)
                                * in_set[:, None].to(r.dtype))

    def chi_local(poses):
        e = fct.between_error(poses[bi], poses[bj], z_f)
        rr = (sqi_f * e[:, None, :]).sum(-1)
        if huber_delta > 0.0:
            rr = rr * fct.robust_weight(torch.linalg.norm(rr, dim=-1),
                                        huber_delta)[:, None]
        rr = rr * mf[:, None]
        ep = fct.prior_error(poses[g.prior_idx], g.prior_z)
        rrp = (g.prior_sqrt_info * ep[:, None, :]).sum(-1) * mp[:, None]
        return torch.sum(rr * rr) + torch.sum(rrp * rrp)

    return solve, chi_local


def local_update(g: fct.PoseGraph, lam, cfg: SolverConfig,
                 huber_delta: float = 0.0, since=None, probe=None):
    """``cfg.inc_iters`` damped-GN iterations on the k-hop local system;
    ``(graph, lam, max_delta)``. A failed probe zeroes the step and leaves
    ``(graph, lam)`` unchanged."""
    dt = g.poses.dtype
    sel = _local_select(g, cfg, since, probe)
    okf = sel["ok"].to(dt)
    _, chi_local = _local_system(g, cfg, huber_delta, sel)
    poses, chi, lam0 = g.poses, chi_local(g.poses), lam
    md = torch.zeros((), dtype=dt, device=g.poses.device)
    for _ in range(cfg.inc_iters):
        solve, _ = _local_system(g._replace(poses=poses), cfg, huber_delta,
                                 sel)
        delta = solve(lam) * okf
        trial = slv._apply_delta(poses, delta, g.pose_mask)
        chi_t = chi_local(trial)
        accept = chi_t < chi
        poses = torch.where(accept, trial, poses)
        chi = torch.where(accept, chi_t, chi)
        md = torch.where(accept, torch.maximum(md, torch.max(torch.abs(delta))),
                         md)
        lam = torch.where(accept, torch.clamp(lam / cfg.lambda_down, min=1e-12),
                          lam * cfg.lambda_up)
    lam = torch.where(sel["ok"], lam, lam0)
    return g._replace(poses=poses), lam, md


def incremental_update(state: SmootherState, cfg: SolverConfig,
                       huber_delta: float = 0.0, fresh_since=None,
                       return_take: bool = False):
    """Bounded-cost refinement after new factors were appended.

    Skips when the last update moved nothing beyond ``relin_threshold`` and
    the new factors (or, second tier, the preconditioned gradient) show
    nothing to correct; otherwise the k-hop local update when it fits, else
    ``inc_iters`` warm-started global LM-PCG steps. Every
    ``full_solve_every``-th update adds a full PCG optimization. The take
    code is 0 = skip, 1 = global, 2 = local.
    """
    g = state.graph
    dt, dev = g.poses.dtype, g.poses.device
    code = lambda c: torch.tensor(c, dtype=torch.int32, device=dev)

    def do_global(g, lam):
        chi = fct.chi2(g, huber_delta)
        md = torch.zeros((), dtype=dt, device=dev)
        for _ in range(cfg.inc_iters):
            g, chi, lam, md_i = _one_lm_step(g, lam, chi, cfg, huber_delta)
            md = torch.maximum(md, md_i)
        return g, lam, md, code(1)

    def do_update(g, lam):
        if cfg.local_poses <= 0:
            return do_global(g, lam)
        probe = _active_probe(g, cfg, fresh_since)
        if bool(probe[2]):
            g2, lam2, md2 = local_update(g, lam, cfg, huber_delta,
                                         fresh_since, probe=probe)
            return g2, lam2, md2, code(2)
        return do_global(g, lam)

    def skip(g, lam):
        return g, lam, torch.zeros((), dtype=dt, device=dev), code(0)

    def slow_check(g, lam):
        lin = fct.linearize(g, huber_delta)
        grad = slv.gradient(g, lin)
        dblocks = slv.block_diag_hessian(g, lin)
        live = g.pose_mask.to(dt)
        eye = torch.eye(3, dtype=dt, device=dev)
        dblocks = dblocks + (1e-8 + (1.0 - live))[:, None, None] * eye
        step = (slv._inv3(dblocks) * grad[:, None, :]).sum(-1)
        if bool(torch.max(torch.abs(step)) < cfg.relin_threshold):
            return skip(g, lam)
        return do_update(g, lam)

    settled = bool(state.last_max_delta < cfg.relin_threshold)
    if settled and bool(fresh_residual_max(g) < cfg.relin_threshold):
        graph, lam, md, take = skip(g, state.lam)
    elif settled:
        graph, lam, md, take = slow_check(g, state.lam)
    else:
        graph, lam, md, take = do_update(g, state.lam)

    step = state.step + 1
    if cfg.full_solve_every > 0 and int(step) % cfg.full_solve_every == 0:
        graph = slv.optimize(graph, cfg, method="pcg",
                             huber_delta=huber_delta).graph
        lam = torch.tensor(cfg.init_lambda, dtype=dt, device=dev)
    out = SmootherState(graph=graph, lam=lam, last_max_delta=md, step=step)
    return (out, take) if return_take else out


def full_solve(state: SmootherState, cfg: SolverConfig, method: str = "pcg",
               huber_delta: float = 0.0) -> SmootherState:
    """Full batched optimization (the caller applies the cadence)."""
    res = slv.optimize(state.graph, cfg, method=method,
                       huber_delta=huber_delta)
    dt, dev = state.graph.poses.dtype, state.graph.poses.device
    return SmootherState(graph=res.graph,
                         lam=torch.tensor(cfg.init_lambda, dtype=dt,
                                          device=dev),
                         last_max_delta=torch.tensor(float("inf"), dtype=dt,
                                                     device=dev),
                         step=state.step)
