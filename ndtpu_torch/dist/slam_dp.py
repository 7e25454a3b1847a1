"""Stacked multi-session SLAM: S sessions through one windowed program.

Port of ``ndtpu/dist/slam_dp.py``: :func:`run_sessions_sharded` splits
sessions over the ranks of a mesh axis, and the single-card serving path
``run_sessions_stacked`` steps
S independent sessions window by window with the same per-session
semantics as ``pipeline.run_slam_windowed`` under a :func:`serving_config`:

- the front end runs the S*W registration lanes of a pass as ONE grouped
  ``lm_ndt`` launch (``group`` = session) against the S map tables, which
  K4s packs in one launch, and builds the S pass-2 temporary maps with one
  K3s launch;
- the appends and the loop verification run per session with the
  single-session ``pipeline._wb_appends`` (S gated verify launches and S
  sets of host syncs per window; the fused form is a ROADMAP item);
- the smoother runs all sessions on one block-diagonal flat graph: K5
  linearizes it, and K6b solves S independent PCGs (per-session Krylov
  scalars, damping, accept and step) in one launch;
- the map extend and the top-M refresh are one K3s launch each.

JAX hoists the smoother's and the refresh's ``lax.cond`` to batch level
(``jnp.any`` of the per-session predicates) and masks the update per
session. The port branches on the host there: one sync per window for
each, and most serving windows then skip the work, while a taken branch
runs the same masked form, so the states equal the reference's either way.

The window step takes ownership of the stacked keyframe table cache
(``state8.kf.tables``, ``[S, K, R, L]``): each session's K8a writes land in
place in its own slice, through a view, so no session's tables ever reach
another's. A caller that needs the input state afterwards clones the cache
first.
"""

from __future__ import annotations

import dataclasses

import torch

from ndtpu_torch.config import PipelineConfig
from ndtpu_torch.dist import mesh as dmesh
from ndtpu_torch.graph import factors as fct
from ndtpu_torch.graph import incremental as inc
from ndtpu_torch.graph import solve as slv
from ndtpu_torch.lie import se2
from ndtpu_torch.ndt import grid as ndt_grid
from ndtpu_torch.ndt import match as ndt_match
from ndtpu_torch.slam import pipeline
from ndtpu_torch.slam.odometry import chain_deltas, gate_poses

__all__ = ["run_sessions", "run_sessions_sharded", "run_sessions_stacked",
           "serving_config", "vmap_cond_hazards"]


def vmap_cond_hazards(cfg: PipelineConfig) -> list[str]:
    """Config fields whose rare branches the stacked path would pay for
    every window (JAX: a ``lax.cond`` under ``vmap`` runs both branches),
    in the JAX package's measured cost order. ``run_sessions_stacked``
    refuses a config with any of them."""
    bad = []
    if cfg.refresh_top_m == 0:
        bad.append("refresh_top_m=0 (full map rebuild every window)")
    elif cfg.full_rebuild_every > 0:
        bad.append("full_rebuild_every>0 (periodic rebuild every window)")
    if cfg.solver.full_solve_every > 0:
        bad.append("solver.full_solve_every>0 (full LM solve every window)")
    if cfg.solver.local_poses > 0:
        bad.append("solver.local_poses>0 (local AND global paths every "
                   "window)")
    return bad


def serving_config(cfg: PipelineConfig, refresh_top_m: int = 12,
                   fast: bool = True) -> PipelineConfig:
    """The stacked-serving variant of ``cfg``: the top-M refresh on loop
    windows instead of the full rebuild, the global warm-started PCG
    smoother only; with ``fast`` also the serving preset (loop verification
    at 6 LM iterations on every 2nd beam, the smoother at 1 LM iteration x
    6 PCG iterations, straggler compaction at width 16)."""
    solver = dataclasses.replace(cfg.solver, local_poses=0,
                                 full_solve_every=0)
    loop = cfg.loop
    match = cfg.match
    if fast:
        solver = dataclasses.replace(solver, pcg_max_iter=6, inc_iters=1)
        loop = dataclasses.replace(loop, verify_max_iter=6,
                                   verify_beam_stride=2)
        match = dataclasses.replace(match, phase2_width=16)
    return dataclasses.replace(cfg, refresh_top_m=refresh_top_m,
                               refresh_eps=0.0, full_rebuild_every=0,
                               loop=loop, solver=solver, match=match)


def _take(tree, i: int):
    """Session ``i`` of a stacked state: views, no copies."""
    if tree is None:
        return None
    if isinstance(tree, tuple):
        return type(tree)(*(_take(x, i) for x in tree))
    return tree[i]


def _stack(trees):
    """Stack per-session states along a new leading axis (copies)."""
    first = trees[0]
    if first is None:
        return None
    if isinstance(first, tuple):
        return type(first)(*(_stack(f) for f in zip(*trees)))
    return torch.stack(trees)


def run_sessions(points, mask, odom, cfg: PipelineConfig):
    """S sessions, each through ``pipeline.run_slam_windowed`` in turn.
    points ``[S, T, N, 2]``, mask ``[S, T, N]``, odom ``[S, T, 3]`` (or
    sequences of S per-session tensors, whose lengths may then differ);
    returns the stacked ``(SlamState, SlamStepOut)``. (The JAX package
    vmaps the pipeline, which runs both branches of every ``lax.cond``; a
    loop keeps real branching, so no config is a hazard here.)"""
    runs = [pipeline.run_slam_windowed(points[i], mask[i], odom[i], cfg)
            for i in range(len(points))]
    return _stack([r[0] for r in runs]), _stack([r[1] for r in runs])


def run_sessions_sharded(mesh: dmesh.RankMesh, points, mask, odom,
                         cfg: PipelineConfig):
    """This rank's share of S sessions: rank ``r`` of ``d`` along
    ``"batch"`` runs sessions ``[r * S/d, (r + 1) * S/d)`` through
    :func:`run_sessions` (with one session per rank, ``run_slam_windowed``
    unbatched, as the reference) and returns their stacked ``(SlamState,
    SlamStepOut)`` with a leading axis of S/d. No collective: sessions are
    independent. The inputs are :func:`run_sessions`', the same on every
    rank."""
    d = dmesh.axis_size(mesh, "batch")
    s = len(points)
    if s % d:
        raise ValueError(f"{s} sessions do not split over the {d} ranks of "
                         f"axis 'batch'")
    r, k = dmesh.axis_index(mesh, "batch"), s // d
    lo, hi = r * k, (r + 1) * k
    return run_sessions(points[lo:hi], mask[lo:hi], odom[lo:hi], cfg)


def _flat_graph(graph8: fct.PoseGraph) -> fct.PoseGraph:
    """S per-session pose graphs as ONE block-diagonal flat graph: the
    arrays concatenate and the indices take a per-session offset (``s *
    V``), so padded factor and prior slots point at pose 0 of their own
    session, masked off."""
    s, v = graph8.poses.shape[:2]
    dev = graph8.poses.device
    off = torch.arange(s, device=dev)[:, None] * v
    full = lambda n: torch.full((), n, dtype=torch.long, device=dev)
    return fct.PoseGraph(
        poses=graph8.poses.reshape(s * v, 3),
        pose_mask=graph8.pose_mask.reshape(-1),
        prior_idx=(graph8.prior_idx + off).reshape(-1),
        prior_z=graph8.prior_z.reshape(-1, 3),
        prior_sqrt_info=graph8.prior_sqrt_info.reshape(-1, 3, 3),
        prior_mask=graph8.prior_mask.reshape(-1),
        bet_i=(graph8.bet_i + off).reshape(-1),
        bet_j=(graph8.bet_j + off).reshape(-1),
        bet_z=graph8.bet_z.reshape(-1, 3),
        bet_sqrt_info=graph8.bet_sqrt_info.reshape(-1, 3, 3),
        bet_mask=graph8.bet_mask.reshape(-1),
        n_poses=full(s * v), n_priors=full(graph8.prior_mask.shape[1] * s),
        n_between=full(graph8.bet_mask.shape[1] * s))


def _skip_stacked(state8, graph8, any_kf8):
    """The smoother's skip for every session: poses and damping kept; the
    sessions whose window had a keyframe record a 0 step."""
    sm = inc.SmootherState(
        graph=graph8, lam=state8.sm_lam,
        last_max_delta=torch.where(any_kf8,
                                   torch.zeros_like(state8.sm_last_delta),
                                   state8.sm_last_delta),
        step=state8.sm_step + any_kf8.to(state8.sm_step.dtype))
    return sm, torch.zeros(any_kf8.shape, dtype=torch.int32,
                           device=any_kf8.device)


def _smooth_stacked(state8, graph8, any_kf8, need8, cfg: PipelineConfig):
    """Damped GN/PCG smoothing of all sessions on one flat graph:
    ``inc_iters`` iterations, each one K5 linearization, one K6b solve (S
    PCGs with per-session scalars) and a per-session chi^2 accept, taken
    from the same linearization's residuals. ``need8`` gates the update
    per session (a settled session gets the skip semantics, never a free
    step); sessions whose window had no keyframe keep their history.
    Returns ``(SmootherState, take [S] int32)`` (1 = global update)."""
    huber = cfg.solver.huber_delta
    scfg = cfg.solver
    s, v = graph8.poses.shape[:2]
    f = graph8.bet_mask.shape[1]
    p = graph8.prior_mask.shape[1]
    flat = _flat_graph(graph8)

    def chi_from(lin):
        (_, _, r), (_, rp) = lin
        return ((r.reshape(s, f, 3) ** 2).sum((1, 2))
                + (rp.reshape(s, p, 3) ** 2).sum((1, 2)))

    poses, lam8 = flat.poses, state8.sm_lam
    md8 = torch.zeros(s, dtype=poses.dtype, device=poses.device)
    for _ in range(scfg.inc_iters):
        g = flat._replace(poses=poses)
        lin = fct.linearize(g, huber)
        chi8 = chi_from(lin)
        delta = slv.pcg_solve_blocked(g, lin, None, lam8, s,
                                      scfg.pcg_max_iter)
        trial = slv._apply_delta(poses, delta, g.pose_mask)
        chi_t = chi_from(fct.linearize(g._replace(poses=trial), huber))
        accept8 = (chi_t < chi8) & need8
        poses = torch.where(accept8.repeat_interleave(v)[:, None], trial,
                            poses)
        d8 = torch.abs(delta.reshape(s, v * 3)).amax(1)
        md8 = torch.where(accept8, torch.maximum(md8, d8), md8)
        lam8 = torch.where(
            accept8, torch.clamp(lam8 / scfg.lambda_down, min=1e-12),
            torch.where(need8, lam8 * scfg.lambda_up, lam8))
    sm = inc.SmootherState(
        graph=graph8._replace(poses=poses.reshape(s, v, 3)), lam=lam8,
        last_max_delta=torch.where(
            need8, md8, torch.where(any_kf8, torch.zeros_like(md8),
                                    state8.sm_last_delta)),
        step=state8.sm_step + any_kf8.to(state8.sm_step.dtype))
    return sm, need8.to(torch.int32)


def _kf_flags8(last_kf8, poses8, cfg: PipelineConfig):
    """``slam.odometry.kf_select`` of every session at once: ``is_kf [S,
    W]`` from ``last_kf8 [S, 3]`` and ``poses8 [S, W, 3]``."""
    kcfg = cfg.keyframe
    s, w = poses8.shape[:2]
    dev = poses8.device
    all_p = torch.cat([last_kf8[:, None], poses8], 1)          # [S, W+1, 3]
    d = all_p[:, None, :, :] - all_p[:, :, None, :]
    trig = ((torch.sqrt(d[..., 0] ** 2 + d[..., 1] ** 2) > kcfg.dist_thresh)
            | (torch.abs(se2.wrap(d[..., 2])) > kcfg.angle_thresh))
    jj = torch.arange(w + 1, device=dev)
    cand = trig & (jj[None, None, :] > jj[None, :, None])
    first = torch.argmax(cand.to(torch.int32), -1)
    nxt = torch.where(cand.any(-1), first, torch.full_like(first, w + 1))
    nxt = torch.cat([nxt, torch.full((s, 1), w + 1, dtype=nxt.dtype,
                                      device=dev)], 1)         # sink loops
    visited = torch.zeros((s, w + 2), dtype=torch.bool, device=dev)
    cur = torch.zeros((s, 1), dtype=torch.long, device=dev)
    for _ in range(w):
        cur = torch.gather(nxt, 1, cur)
        visited.scatter_(1, cur, True)
    return visited[:, 1:w + 1]


def _frontend_stacked(state8, lkr8, pts8, msk8, deltas8,
                      cfg: PipelineConfig):
    """The 2-pass window front end of all S sessions: per pass one K4s
    launch packs the S map tables and one grouped ``lm_ndt`` launch
    registers the S*W lanes (``group`` = session); pass 2's temporary maps
    are one K3s launch. As the JAX function, and unlike
    ``pipeline._window_frontend``, pass 2 always starts from ``compose([pose,
    poses[:-1]], deltas)`` (``pass2_warm_start`` is not read) and its maps
    are built from ``state8.stats`` with ``msk8 & kf_prev8``. Returns
    ``(poses [S, W, 3], MatchResult [S, W, ...], is_kf [S, W])``."""
    s, w = pts8.shape[:2]
    dev = pts8.device
    group = torch.arange(s, dtype=torch.int32,
                         device=dev).repeat_interleave(w)
    stride = max(1, cfg.frontend_beam_stride)
    mpts8, mmsk8 = ((pts8, msk8) if stride == 1
                    else (pts8[:, :, ::stride], msk8[:, :, ::stride]))

    def flat(a):
        return a.reshape((s * w,) + a.shape[2:])

    def pack8(stats8):
        return ndt_grid.finalize_pack_stacked(stats8, cfg.ndt, cfg.grid,
                                              cfg.match.compact_table)

    inits = torch.stack([chain_deltas(state8.pose[i], deltas8[i])
                         for i in range(s)])                   # [S, W, 3]
    res = ndt_match.match_batch_packed(
        flat(mpts8), flat(mmsk8), pack8(state8.stats), flat(inits), cfg.grid,
        cfg.match, group=group)
    poses8, _ = gate_poses(res.pose.reshape(s, w, 3),
                           res.converged.reshape(s, w), inits, cfg.odom_gate)
    mcfg2 = cfg.match
    if cfg.pass2_max_iter > 0:
        mcfg2 = dataclasses.replace(cfg.match, max_iter=cfg.pass2_max_iter)
    for _ in range(max(0, cfg.window_passes - 1)):
        kf_prev8 = _kf_flags8(lkr8, poses8, cfg)
        tmp8 = ndt_grid.add_points_stacked(
            state8.stats, se2.transform(poses8, pts8).reshape(s, -1, 2),
            (msk8 & kf_prev8[..., None]).reshape(s, -1), cfg.grid)
        prev = torch.cat([state8.pose[:, None], poses8[:, :-1]], 1)
        inits2 = se2.compose(prev, deltas8)
        res = ndt_match.match_batch_packed(
            flat(pts8), flat(msk8), pack8(tmp8), flat(inits2), cfg.grid,
            mcfg2, group=group)
        poses8, _ = gate_poses(res.pose.reshape(s, w, 3),
                               res.converged.reshape(s, w), inits2,
                               cfg.odom_gate)
    res8 = ndt_match.MatchResult(*(a.reshape((s, w) + a.shape[1:])
                                   for a in res))
    return poses8, res8, _kf_flags8(lkr8, poses8, cfg)


def _set_rows8(arr8, slots8, ok8, vals8):
    """``pipeline._set_rows`` of every session in one write: rows
    ``slots8 [S, W]`` of ``arr8 [S, K, ...]`` where ``ok8``."""
    s, k = arr8.shape[:2]
    off = torch.arange(s, device=arr8.device)[:, None] * k
    out = pipeline._set_rows(arr8.reshape((s * k,) + arr8.shape[2:]),
                             (slots8 + off).reshape(-1), ok8.reshape(-1),
                             vals8.reshape((-1,) + vals8.shape[2:]))
    return out.reshape(arr8.shape)


def _extend_stacked(state8, poses8, pts8, msk8, is_kf8, kslot8, kslot_ok8,
                    cfg: PipelineConfig):
    """``pipeline._wb_extend`` of every session: the window's keyframe
    scans inserted at their registration-time poses in one K3s launch.
    Returns ``(stats8, mkp8)``."""
    s = pts8.shape[0]
    mkp8 = _set_rows8(state8.map_kf_poses, kslot8, kslot_ok8, poses8)
    stats8 = ndt_grid.add_points_stacked(
        state8.stats, se2.transform(poses8, pts8).reshape(s, -1, 2),
        (msk8 & is_kf8[..., None]).reshape(s, -1), cfg.grid)
    return stats8, mkp8


def _refresh_stacked(stats8, kf8, mkp8, cfg: PipelineConfig, enable8):
    """``pipeline._refresh_map(..., enable=)`` of every session: each
    session's top-M selection, then one weighted K3s launch. Returns
    ``(stats8, mkp8)``."""
    parts = [pipeline._refresh_points(_take(kf8, i), mkp8[i], cfg,
                                      enable8[i])
             for i in range(mkp8.shape[0])]
    both8, bmsk8, wts8, sel8, do8 = (torch.stack(f) for f in zip(*parts))
    stats8 = ndt_grid.add_points_stacked(stats8, both8, bmsk8, cfg.grid,
                                         weight=wts8)
    poses_sel = torch.gather(kf8.poses, 1, sel8[..., None].expand(-1, -1, 3))
    return stats8, _set_rows8(mkp8, sel8, do8, poses_sel)


def _appends_stacked(state8, lkr8, poses8, hessians8, pts8, msk8, is_kf8,
                     cfg: PipelineConfig):
    """``pipeline._wb_appends`` per session, on views of the stacked state.
    Each session's K8a writes go to its own slice of the stacked table
    cache, which the result keeps (no copy). Returns ``(graph8, kf8,
    aux8)``."""
    outs = [pipeline._wb_appends(_take(state8, i), lkr8[i], poses8[i],
                                 hessians8[i], pts8[i], msk8[i], is_kf8[i],
                                 cfg)
            for i in range(pts8.shape[0])]
    tables8 = state8.kf.tables
    if tables8 is not None:
        for i, (_, kf, _) in enumerate(outs):
            if kf.tables.data_ptr() != tables8[i].data_ptr():
                raise RuntimeError("a session's table cache left the stack")
    kf8 = _stack([kf._replace(tables=None) for _, kf, _ in outs])
    aux8 = {key: torch.stack([aux[key] for _, _, aux in outs])
            for key in outs[0][2]}
    return (_stack([g for g, _, _ in outs]), kf8._replace(tables=tables8),
            aux8)


def _stacked_window_step(state8, lkr8, pts8, msk8, deltas8,
                         cfg: PipelineConfig):
    """One window of all S sessions. Returns ``((state8, lkr8),
    SlamStepOut [S, W, ...])``; takes ownership of ``state8.kf.tables``."""
    s, w = pts8.shape[:2]
    poses8, res8, is_kf8 = _frontend_stacked(state8, lkr8, pts8, msk8,
                                             deltas8, cfg)
    graph8, kf8, aux8 = _appends_stacked(state8, lkr8, poses8, res8.hessian,
                                         pts8, msk8, is_kf8, cfg)
    any_kf8 = aux8["any_kf"]

    # The smoother: need = not the tier-1 skip test, per session. The host
    # branch costs one sync; the skip is exactly what the masked update
    # gives when no session needs it.
    thr = cfg.solver.relin_threshold
    settled8 = state8.sm_last_delta < thr
    fresh8 = torch.stack([inc.fresh_residual_max(_take(graph8, i))
                          for i in range(s)])
    need8 = any_kf8 & ~(settled8 & (fresh8 < thr))
    if bool(need8.any()):
        sm8, take8 = _smooth_stacked(state8, graph8, any_kf8, need8, cfg)
    else:
        sm8, take8 = _skip_stacked(state8, graph8, any_kf8)
    graph8 = sm8.graph
    kf8 = kf8._replace(poses=graph8.poses[:, :kf8.poses.shape[1]])

    # Map maintenance: extend always; refresh where a loop landed (one host
    # branch; ``enable`` masks the sessions whose trigger is false).
    stats8, mkp8 = _extend_stacked(state8, poses8, pts8, msk8, is_kf8,
                                   aux8["kslot"], aux8["kslot_ok"], cfg)
    trig8 = (torch.ones_like(any_kf8) if cfg.refresh_always
             else aux8["n_loops_new"] > 0)
    if bool(trig8.any()):
        stats8, mkp8 = _refresh_stacked(stats8, kf8, mkp8, cfg, trig8)

    last_idx8, lkr8n = aux8["last_idx"], aux8["lkr"]
    anchor8 = graph8.poses[torch.arange(s, device=pts8.device), last_idx8]
    pose_out8 = se2.compose(anchor8, se2.between(lkr8n, poses8[:, -1]))
    new_state8 = pipeline.SlamState(
        stats=stats8, kf=kf8, graph=graph8, sm_lam=sm8.lam,
        sm_last_delta=sm8.last_max_delta, sm_step=sm8.step, pose=pose_out8,
        last_kf_idx=last_idx8, n_loops=state8.n_loops + aux8["n_loops_new"],
        map_kf_poses=mkp8)
    out8 = pipeline.SlamStepOut(
        pose=poses8, kf_idx=aux8["kf_idx_out"], rel=aux8["rel_out"],
        score=res8.score, is_keyframe=is_kf8, n_loops_new=aux8["nl_out"],
        n_dropped=aux8["nd_out"], n_innov_rej=aux8["ni_out"],
        local_take=take8[:, None].expand(s, w))
    return (new_state8, lkr8n), out8


def init_sessions(points0, mask0, cfg: PipelineConfig):
    """The stacked state of S sessions from their first scans ``[S, N, 2]``:
    ``pipeline.init_slam`` per session, stacked, so every session owns its
    own table cache."""
    return _stack([pipeline.init_slam(cfg, points0[i], mask0[i])
                   for i in range(points0.shape[0])])


def run_sessions_stacked(points, mask, odom, cfg: PipelineConfig):
    """S concurrent sessions, one stacked window step at a time: the
    single-card serving entry point. points ``[S, T, N, 2]``, mask ``[S, T,
    N]``, odom ``[S, T, 3]`` (shorter sessions padded with all-false masks
    and identity odometry). Returns ``(SlamState, SlamStepOut)`` with a
    leading session axis; ``cfg`` must be serving-shaped (no
    :func:`vmap_cond_hazards`)."""
    bad = vmap_cond_hazards(cfg)
    if bad:
        raise ValueError(
            "run_sessions_stacked requires a serving-shaped config "
            f"(offenders: {'; '.join(bad)}); wrap with serving_config().")
    s, t = points.shape[:2]
    state8 = init_sessions(points[:, 0], mask[:, 0], cfg)
    # [n_win, S, W, ...], each window's slice contiguous.
    wins = [pipeline.window_inputs(points[i], mask[i], odom[i], cfg.window)
            for i in range(s)]
    pts_w, msk_w, odo_w = (torch.stack(f, 1).contiguous()
                           for f in list(zip(*wins))[:3])
    carry, outs = (state8, state8.pose), []
    for k in range(pts_w.shape[0]):
        carry, out = _stacked_window_step(carry[0], carry[1], pts_w[k],
                                          msk_w[k], odo_w[k], cfg)
        outs.append(out)
    return carry[0], pipeline.SlamStepOut(
        *(torch.cat(f, 1)[:, :t - 1] for f in zip(*outs)))
