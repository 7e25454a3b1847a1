"""Incremental pose-graph smoothing (the iSAM2-capability smoother).

Port of ``ndtpu/graph/incremental.py``: warm-started LM-PCG updates, the
settled-estimate skip, the k-hop local update with its static capacities,
the periodic full solve, and the marginal covariances (three PCG solves
against unit vectors, or the dense inverse).

Each ``lax.cond`` of the JAX version is a Python ``if`` on a host bool, and
only the taken branch runs, as in ``cond``: the predicates that read only
the input state (:func:`gate_flags`) come to the host in one transfer, and
the slow settled check and the local probe each read their result where
they run. On the card
the factors are linearized by K5, the PCG solves run in K6 (graphs that fit
one block) or K6g (larger ones, such as bench.py's 10k poses), and the local
path selects (K7a: ``lax.top_k`` over 0/1 flags as stable compactions, ties
in index order as ``top_k`` orders them) and assembles (K7b) without host
syncs; the dense local Cholesky is ``cholesky_ex``. On the CPU the plain
versions run (``lax.top_k`` as a stable descending sort).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ndtpu_torch import kernels
from ndtpu_torch.config import SolverConfig
from ndtpu_torch.graph import factors as fct
from ndtpu_torch.graph import solve as slv

__all__ = ["SmootherState", "Gates", "gate_flags", "init_smoother",
           "incremental_update",
           "local_update", "local_select", "local_select_ref",
           "fresh_residual_max", "fresh_residual_max_ref",
           "fresh_residual_max_stacked", "fresh_residual_max_stacked_ref",
           "full_solve",
           "marginal_covariance_pcg", "marginal_covariance"]


class SmootherState(NamedTuple):
    graph: fct.PoseGraph
    lam: torch.Tensor             # [] LM damping carried across updates
    last_max_delta: torch.Tensor  # [] inf-norm of the last accepted step
    step: torch.Tensor            # [] int64 update counter


class Gates(NamedTuple):
    """:func:`incremental_update`'s decisions that depend only on its input
    state, as host bools (:func:`gate_flags`, read with one transfer)."""
    settled: bool      # the last update moved nothing past the threshold
    fresh_small: bool  # the newest factors' residuals are below it too
    full_solve: bool   # this update is a ``full_solve_every``-th one


def gate_flags(state: SmootherState, cfg: SolverConfig) -> torch.Tensor:
    """``[settled, fresh_small, full_solve]`` (bool) on the state's device,
    without a host sync: the predicates of the JAX version's ``lax.cond``s
    that read only the input state (``fresh_residual_max`` runs always, as
    there)."""
    thr = cfg.relin_threshold
    settled = state.last_max_delta < thr
    fresh_small = fresh_residual_max(state.graph) < thr
    if cfg.full_solve_every > 0:
        full = (state.step + 1) % cfg.full_solve_every == 0
    else:
        full = torch.zeros_like(settled)
    return torch.stack([settled, fresh_small, full])


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
    """Max |whitened residual| over the K newest between-factor slots. CUDA
    tensors go to K5's fresh-window mode (``n_between`` read on the card),
    CPU tensors to :func:`fresh_residual_max_ref`."""
    if not g.poses.is_cuda:
        return fresh_residual_max_ref(g, k)
    return kernels.fresh_residual_max(*fct._graph_args(g), g.n_between, k)


def fresh_residual_max_ref(g: fct.PoseGraph, k: int = 64):
    """The plain version of K5's fresh-window mode."""
    k, start = _fresh_start(g, k)
    sl = start + torch.arange(k, device=start.device)
    r = fct.between_error(g.poses[g.bet_i[sl]], g.poses[g.bet_j[sl]],
                          g.bet_z[sl])
    wr = (g.bet_sqrt_info[sl] * r[:, None, :]).sum(-1)
    return torch.max(torch.where(g.bet_mask[sl][:, None], torch.abs(wr),
                                 torch.zeros_like(wr)))


def fresh_residual_max_stacked(g8: fct.PoseGraph, k: int = 64):
    """:func:`fresh_residual_max` of ``S`` sessions (every field of ``g8``
    with a leading session axis): ``[S]``. CUDA tensors go to one K5 launch
    (its fresh window of S sessions, each value the bits of its own
    launch), CPU tensors to :func:`fresh_residual_max_stacked_ref`."""
    if not g8.poses.is_cuda:
        return fresh_residual_max_stacked_ref(g8, k)
    return kernels.fresh_residual_max_stacked(
        g8.poses.contiguous(), g8.bet_i.contiguous(), g8.bet_j.contiguous(),
        g8.bet_z.contiguous(), g8.bet_sqrt_info.contiguous(),
        g8.bet_mask.contiguous(), g8.n_between.contiguous(), k)


def fresh_residual_max_stacked_ref(g8: fct.PoseGraph, k: int = 64):
    """The plain version of K5's fresh window of S sessions: the vmap of
    :func:`fresh_residual_max_ref` as one batched gather over ``[S, k]``
    slots."""
    f_cap = g8.bet_mask.shape[1]
    k = min(k, f_cap)
    start = torch.clamp(g8.n_between - k, 0, f_cap - k)
    sl = start[:, None] + torch.arange(k, device=start.device)   # [S, k]
    rows = lambda a: torch.gather(
        a, 1, sl.reshape(sl.shape + (1,) * (a.dim() - 2)).expand(
            sl.shape + a.shape[2:]))
    ends = lambda idx: torch.gather(
        g8.poses, 1, rows(idx)[..., None].expand(-1, -1, 3))
    r = fct.between_error(ends(g8.bet_i), ends(g8.bet_j), rows(g8.bet_z))
    wr = (rows(g8.bet_sqrt_info) * r[..., None, :]).sum(-1)
    return torch.where(rows(g8.bet_mask)[..., None], torch.abs(wr),
                       torch.zeros_like(wr)).amax((1, 2))


def _fresh_slice(g: fct.PoseGraph, k: int, since=None):
    """(i, j, mask) of the newest between-factor slots (``since``: factor
    count at the previous update)."""
    k, start = _fresh_start(g, k)
    slots = start + torch.arange(k, device=start.device)
    fresh_live = slots < g.n_between
    if since is not None:
        fresh_live = fresh_live & (slots >= since)
    return g.bet_i[slots], g.bet_j[slots], g.bet_mask[slots] & fresh_live


def _active_probe_ref(g: fct.PoseGraph, cfg: SolverConfig, since=None):
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


def local_select_ref(g: fct.PoseGraph, cfg: SolverConfig, since=None):
    """The plain version of K7a (CPU path and oracle): the probe
    (:func:`_active_probe_ref`), then the pose slots, gathered-factor ids,
    endpoint roles and local slots."""
    from ndtpu_torch.dist.schur import INTERIOR, SEPARATOR

    act, touch, ok = _active_probe_ref(g, cfg, since)
    v = g.poses.shape[0]
    dev = g.poses.device
    p_loc = min(cfg.local_poses, v)
    f_loc = min(cfg.local_factors, g.bet_mask.shape[0])
    pid = _top_flags(act, p_loc)
    loc_of = torch.zeros(v, dtype=torch.long, device=dev)
    loc_of[pid] = torch.arange(p_loc, device=dev)
    fid = _top_flags(touch, f_loc)
    bi, bj = g.bet_i[fid], g.bet_j[fid]
    role = lambda ids: torch.where(act[ids], INTERIOR, SEPARATOR)
    return dict(p_loc=p_loc, ok=ok, pid=pid, in_set=act[pid], fid=fid,
                f_sel=touch[fid], ri=role(bi), rj=role(bj), li=loc_of[bi],
                lj=loc_of[bj], rp=role(g.prior_idx), lp=loc_of[g.prior_idx],
                p_act=act[g.prior_idx] & g.prior_mask)


def local_select(g: fct.PoseGraph, cfg: SolverConfig, since=None) -> dict:
    """K7a wrapper: the fits test ``ok`` of the k-hop active set and the
    local selection the local path reads (``pid``, ``in_set``, ``fid``,
    ``f_sel``, the endpoints' roles ``ri``/``rj`` and local slots
    ``li``/``lj``, the priors' ``rp``/``lp``/``p_act``, and the static
    ``p_loc``). CUDA tensors go to the kernel (one launch, no host sync),
    CPU tensors to :func:`local_select_ref`."""
    if not g.poses.is_cuda:
        return local_select_ref(g, cfg, since)
    if since is not None:
        since = torch.as_tensor(since, dtype=torch.long,
                                device=g.poses.device)
    return kernels.local_select(g.bet_i, g.bet_j, g.bet_mask, g.pose_mask,
                                g.prior_idx, g.prior_mask, g.n_between,
                                since, cfg)


def _local_lin(g: fct.PoseGraph, poses, sel, huber_delta: float,
               chi_only: bool = False):
    """K5 on the gathered factors (masked by ``f_sel``) and the active
    priors at ``poses``: the local linearization, or ``chi_local``."""
    return fct.factor_linearize(
        poses, g.bet_i, g.bet_j, g.bet_z, g.bet_sqrt_info, sel["f_sel"],
        g.prior_idx, g.prior_z, g.prior_sqrt_info, sel["p_act"], huber_delta,
        fid=sel["fid"], chi_only=chi_only)


def _local_step(g: fct.PoseGraph, poses, lam, sel, huber_delta: float):
    """One damped GN step of the k-hop active subproblem at ``poses``
    (inactive endpoints held fixed): ``delta [V, 3]``. K5 and K7b, then
    the dense Cholesky; where it fails (``info != 0``) the step is NaN, as
    JAX's ``cholesky`` gives, so the accept test rejects it."""
    from ndtpu_torch.dist.schur import assemble_local

    (ai, aj, r), (ap, rp) = _local_lin(g, poses, sel, huber_delta)
    p_loc, in_set = sel["p_loc"], sel["in_set"]
    h_ii, b_i = assemble_local(p_loc, ai, aj, r, ap, rp, sel["f_sel"],
                               sel["ri"], sel["li"], sel["rj"], sel["lj"],
                               sel["p_act"], sel["rp"], sel["lp"])
    live = in_set.to(r.dtype).repeat_interleave(3)
    damp = lam * torch.clamp(torch.abs(torch.diagonal(h_ii)), min=1e-8)
    l, info = torch.linalg.cholesky_ex(h_ii + torch.diag(damp + (1.0 - live)))
    x = torch.cholesky_solve(-b_i[:, None], l)[:, 0]
    x = torch.where(info == 0, x, torch.full_like(x, float("nan")))
    delta = torch.zeros((poses.shape[0], 3), dtype=r.dtype,
                        device=r.device)
    return delta.index_add_(0, sel["pid"], x.reshape(p_loc, 3)
                            * in_set[:, None].to(r.dtype))


def local_update(g: fct.PoseGraph, lam, cfg: SolverConfig,
                 huber_delta: float = 0.0, since=None, probe=None):
    """``cfg.inc_iters`` damped-GN iterations on the k-hop local system;
    ``(graph, lam, max_delta)``. ``probe`` is a selection from
    :func:`local_select` (the JAX version's ``(act, touch, ok)`` probe
    with the selection made from it). A failed probe zeroes the step and
    leaves ``(graph, lam)`` unchanged. On the card no step reads back to
    the host."""
    dt = g.poses.dtype
    sel = probe if probe is not None else local_select(g, cfg, since)
    okf = sel["ok"].to(dt)
    poses, lam0 = g.poses, lam
    chi = _local_lin(g, poses, sel, huber_delta, chi_only=True)
    md = torch.zeros((), dtype=dt, device=g.poses.device)
    for _ in range(cfg.inc_iters):
        delta = _local_step(g, poses, lam, sel, huber_delta) * okf
        trial = slv._apply_delta(poses, delta, g.pose_mask)
        chi_t = _local_lin(g, trial, sel, huber_delta, chi_only=True)
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
                       return_take: bool = False, gates: Gates = None):
    """Bounded-cost refinement after new factors were appended.

    Skips when the last update moved nothing beyond ``relin_threshold`` and
    the new factors (or, second tier, the preconditioned gradient) show
    nothing to correct; otherwise the k-hop local update when it fits, else
    ``inc_iters`` warm-started global LM-PCG steps. Every
    ``full_solve_every``-th update adds a full PCG optimization. The take
    code is 0 = skip, 1 = global, 2 = local.

    ``gates`` are :func:`gate_flags` read by the caller (the window step
    reads them with its other decisions); None reads them here, with one
    transfer. Besides, the slow settled check and the local probe read their
    kernels' results mid-branch (one host sync each where they run).
    """
    g = state.graph
    dt, dev = g.poses.dtype, g.poses.device
    # torch.full fills on the device; torch.tensor would copy from the host
    # and wait for the card.
    code = lambda c: torch.full((), c, dtype=torch.int32, device=dev)

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
        probe = local_select(g, cfg, fresh_since)
        if bool(probe["ok"]):
            g2, lam2, md2 = local_update(g, lam, cfg, huber_delta,
                                         fresh_since, probe=probe)
            return g2, lam2, md2, code(2)
        return do_global(g, lam)

    def skip(g, lam):
        return g, lam, torch.zeros((), dtype=dt, device=dev), code(0)

    def slow_check(g, lam):
        # The block-Jacobi preconditioned gradient's max |entry| is K6's
        # (or K6g's) set-up with lam = 0, damping 1e-8 and no iteration.
        _, _, step = slv.pcg_solve(g, fct.linearize(g, huber_delta), None,
                                   0.0, 0, cfg.pcg_tol, damp_abs=1e-8)
        if bool(step < cfg.relin_threshold):
            return skip(g, lam)
        return do_update(g, lam)

    if gates is None:
        gates = Gates(*gate_flags(state, cfg).tolist())
    if gates.settled and gates.fresh_small:
        graph, lam, md, take = skip(g, state.lam)
    elif gates.settled:
        graph, lam, md, take = slow_check(g, state.lam)
    else:
        graph, lam, md, take = do_update(g, state.lam)

    step = state.step + 1
    if gates.full_solve:
        graph = slv.optimize(graph, cfg, method="pcg",
                             huber_delta=huber_delta).graph
        lam = torch.full((), cfg.init_lambda, dtype=dt, device=dev)
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


def marginal_covariance_pcg(graph: fct.PoseGraph, idx: int,
                            cfg: SolverConfig, huber_delta: float = 0.0,
                            lam: float = 1e-8):
    """3x3 marginal covariance of pose ``idx`` on large graphs: three
    matrix-free PCG solves ``H x = e_k`` against the unit vectors of the
    pose's block (one K6 or K6g launch each on the card; each takes one
    right-hand side per launch), never forming the ``[3V, 3V]`` Hessian."""
    lin = fct.linearize(graph, huber_delta)
    v, dt, dev = graph.poses.shape[0], graph.poses.dtype, graph.poses.device
    lam_t = torch.tensor(lam, dtype=dt, device=dev)
    cols = []
    for k in range(3):
        rhs = torch.zeros((v, 3), dtype=dt, device=dev)
        rhs[idx, k] = 1.0
        x, _ = slv.pcg_rhs(graph, lin, rhs, lam_t, cfg)
        cols.append(x[idx])
    cols = torch.stack(cols)                       # [3, 3] rows = columns
    return 0.5 * (cols + cols.T)


def marginal_covariance(graph: fct.PoseGraph, idx: int,
                        huber_delta: float = 0.0):
    """3x3 marginal covariance of pose ``idx``: the diagonal block of
    ``H^-1`` by the dense inverse (small and medium graphs)."""
    lin = fct.linearize(graph, huber_delta)
    h, _ = slv.normal_equations(graph, lin)
    live = graph.pose_mask.to(h.dtype).repeat_interleave(3)
    cov = torch.linalg.inv(h + torch.diag(1e-8 + (1.0 - live)))
    return cov[3 * idx:3 * idx + 3, 3 * idx:3 * idx + 3]
