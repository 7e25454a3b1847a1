"""Windowed SLAM pipeline: NDT odometry + keyframing + smoothing + map.

Port of the windowed path of ``ndtpu/slam/pipeline.py`` (configs 1-3).
One window of W scans runs:

1. ``_window_frontend``: K4 finalize+pack of the map, W-lane LM
   registration through K1, K3 insert of the window's provisional
   keyframes into a temporary map, K4 again, and a second registration
   pass; then ``kf_select``.
2. ``_wb_appends``: all of the window's keyframes and odometry factors are
   appended with one masked write per graph array. With loop closure on,
   K8a writes the new keyframes' local tables into the cache, and one flat
   detection over the window's first ``max_detect_per_window`` keyframes
   (``K*C`` lanes through grouped K1, then the K8b gate) appends the
   accepted loop factors.
3. ``_wb_smooth``: ``incremental_update`` when a keyframe landed.
4. ``_wb_maps``: the K3 insert of the window's keyframes (or the rebuild /
   top-M refresh the config selects; a landed loop factor triggers it).

JAX's ``.at[idx].set(..., mode="drop")`` with the ``1 << 30`` sentinel
becomes a write of only the rows its mask keeps (torch raises on
out-of-range indices); each ``lax.cond`` becomes a Python ``if`` on a 0-d
tensor. Keyframe store index == pose-graph variable index.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ndtpu_torch.config import PipelineConfig
from ndtpu_torch.graph import factors as fct
from ndtpu_torch.graph import incremental as inc
from ndtpu_torch.lie import se2
from ndtpu_torch.loop import closure
from ndtpu_torch.ndt import grid as ndt_grid
from ndtpu_torch.ndt import match as ndt_match
from ndtpu_torch.slam import keyframes as kfs
from ndtpu_torch.slam.odometry import (_pad_to_windows, chain_deltas,
                                       gate_poses, kf_select)

__all__ = ["SlamState", "SlamStepOut", "init_slam", "slam_window_step",
           "run_slam_windowed", "recover_trajectory"]


class SlamState(NamedTuple):
    stats: ndt_grid.NDTStats     # online NDT map sufficient statistics
    kf: kfs.KeyframeStore        # keyframe scans + poses (index == graph)
    graph: fct.PoseGraph         # pose graph over keyframes
    sm_lam: torch.Tensor         # [] smoother damping
    sm_last_delta: torch.Tensor  # [] smoother last max step
    sm_step: torch.Tensor        # [] smoother update counter
    pose: torch.Tensor           # [3] current pose estimate
    last_kf_idx: torch.Tensor    # [] graph index of the latest keyframe
    n_loops: torch.Tensor        # [] accepted loop closures so far
    map_kf_poses: torch.Tensor   # [K, 3] keyframe poses the map was built at


class SlamStepOut(NamedTuple):
    pose: torch.Tensor         # per-scan pose estimate (at processing time)
    kf_idx: torch.Tensor       # keyframe this scan hangs off
    rel: torch.Tensor          # pose relative to that keyframe
    score: torch.Tensor        # NDT match quality
    is_keyframe: torch.Tensor  # bool
    n_loops_new: torch.Tensor  # loops accepted at this step
    n_dropped: torch.Tensor    # keyframes/factors dropped at capacity
    n_innov_rej: torch.Tensor  # innovation-rejected loop candidates
    local_take: torch.Tensor   # smoother path: 0 skip, 1 global, 2 local


def _check_slice(cfg: PipelineConfig, device) -> None:
    if cfg.match.compact_table and torch.device(device).type == "cuda":
        raise NotImplementedError(
            "compact_table=True on the card is ROADMAP Queue B (K1/K4 "
            "bf16-pair rows)")


def init_slam(cfg: PipelineConfig, first_points, first_mask,
              init_pose=None) -> SlamState:
    """Bootstrap: scan 0 becomes keyframe 0 / graph pose 0 with a prior.
    State lives on ``first_points``' device, in its dtype."""
    _check_slice(cfg, first_points.device)
    dt, dev = first_points.dtype, first_points.device
    t0 = (torch.zeros(3, dtype=dt, device=dev) if init_pose is None
          else init_pose.to(dt))
    cap = cfg.keyframe.capacity
    stats = ndt_grid.add_points(ndt_grid.empty_stats(cfg.grid, dt, dev),
                                se2.transform(t0, first_points), first_mask,
                                cfg.grid)
    tshape = (closure.local_table_shape(cfg.loop, cfg.match.compact_table)
              if cfg.use_loop_closure else None)
    kf = kfs.add_keyframe(
        kfs.empty_store(cap, first_points.shape[0], dt, dev, tshape), t0,
        first_points, first_mask)
    if cfg.use_loop_closure:
        # Keyframe 0's local table, built in place into cache slot 0.
        closure.write_local_tables(
            kf.tables, torch.zeros(1, dtype=torch.long, device=dev),
            torch.ones(1, dtype=torch.bool, device=dev), first_points[None],
            first_mask[None], cfg.loop, cfg.ndt, cfg.match.compact_table)
    graph = fct.empty_graph(cap, 4, 2 * cap, dt, dev)
    graph = fct.add_pose(graph, t0)
    prior_sq = 100.0 * torch.eye(3, dtype=dt, device=dev)
    graph = fct.add_prior(graph, 0, t0, prior_sq)
    zl = lambda: torch.zeros((), dtype=torch.long, device=dev)
    return SlamState(
        stats=stats, kf=kf, graph=graph,
        sm_lam=torch.tensor(cfg.solver.init_lambda, dtype=dt, device=dev),
        sm_last_delta=torch.tensor(float("inf"), dtype=dt, device=dev),
        sm_step=zl(), pose=t0, last_kf_idx=zl(), n_loops=zl(),
        map_kf_poses=kf.poses)


def _odom_info_sqrt(hessian):
    """Between-factor sqrt information from registration Hessians
    ``[..., 3, 3]``."""
    eye = torch.eye(3, dtype=hessian.dtype, device=hessian.device)
    h = 0.5 * (hessian + hessian.transpose(-1, -2)) + 1e-3 * eye
    return fct.info_to_sqrt_info(h)


def _set_rows(arr, slots, ok, vals):
    """``arr.at[where(ok, slots, big)].set(vals, mode="drop")`` as a new
    tensor: only the rows ``ok`` keeps are written."""
    out = arr.clone()
    keep = ok.nonzero().squeeze(-1)
    if isinstance(vals, torch.Tensor) and vals.dim() > 0:
        vals = vals[keep]
    out[slots[keep]] = vals
    return out


def _map_table(stats, cfg: PipelineConfig):
    return ndt_grid.finalize_pack(stats, cfg.ndt, cfg.grid,
                                  cfg.match.compact_table)


def _refresh_map(stats, kf: kfs.KeyframeStore, mkp, cfg: PipelineConfig):
    """Re-place the ``refresh_top_m`` stalest keyframes: subtract each at
    the pose the map saw it at, add it at its smoothed pose (one weighted
    K3 call). Returns ``(stats, mkp)``."""
    m_top = min(cfg.refresh_top_m, kf.capacity)
    d_xy = torch.linalg.norm(kf.poses[:, :2] - mkp[:, :2], dim=-1)
    d_th = torch.abs(se2.wrap(kf.poses[:, 2:] - mkp[:, 2:]))[:, 0]
    stale = torch.where(kf.live, torch.maximum(d_xy, d_th),
                        torch.zeros_like(d_xy))
    val, sel = torch.topk(stale, m_top)
    do = val > cfg.refresh_eps
    smsk = (kf.masks[sel] & kf.live[sel][:, None] & do[:, None]).reshape(-1)
    spts = kf.points[sel]
    old_w = se2.transform(mkp[sel], spts).reshape(-1, 2)
    new_w = se2.transform(kf.poses[sel], spts).reshape(-1, 2)
    both = torch.cat([old_w, new_w], 0)
    wts = torch.cat([torch.full((old_w.shape[0],), -1.0, dtype=both.dtype,
                                device=both.device),
                     torch.ones(new_w.shape[0], dtype=both.dtype,
                                device=both.device)])
    stats = ndt_grid.add_points(stats, both, torch.cat([smsk, smsk]),
                                cfg.grid, weight=wts)
    return stats, _set_rows(mkp, sel, do, kf.poses[sel])


def _window_frontend(state: SlamState, last_kf_reg, pts, msk, deltas,
                     cfg: PipelineConfig, passes: int):
    """Batched registration of one window against the (refreshed) map.
    Returns ``(poses [W,3], MatchResult, is_kf [W])``."""
    kcfg = cfg.keyframe
    stride = max(1, cfg.frontend_beam_stride)
    mpts, mmsk = ((pts, msk) if stride == 1
                  else (pts[:, ::stride], msk[:, ::stride]))
    inits = chain_deltas(state.pose, deltas)
    res = ndt_match.match_batch_packed(mpts, mmsk, _map_table(state.stats, cfg),
                                       inits, cfg.grid, cfg.match)
    poses, _ = gate_poses(res.pose, res.converged, inits, cfg.odom_gate)
    mcfg2 = cfg.match
    if cfg.pass2_max_iter > 0:
        mcfg2 = dataclasses.replace(cfg.match, max_iter=cfg.pass2_max_iter)
    for _ in range(max(0, passes - 1)):
        kf_prev, _ = kf_select(last_kf_reg, poses, kcfg.dist_thresh,
                               kcfg.angle_thresh)
        tmp = ndt_grid.add_points(
            state.stats, se2.transform(poses, pts).reshape(-1, 2),
            (msk & kf_prev[:, None]).reshape(-1), cfg.grid)
        if cfg.pass2_warm_start:
            inits2 = poses
        else:
            prev = torch.cat([state.pose[None], poses[:-1]], 0)
            inits2 = se2.compose(prev, deltas)
        res = ndt_match.match_batch_packed(pts, msk, _map_table(tmp, cfg),
                                           inits2, cfg.grid, mcfg2)
        poses, _ = gate_poses(res.pose, res.converged, inits2, cfg.odom_gate)
    is_kf, _ = kf_select(last_kf_reg, poses, kcfg.dist_thresh,
                         kcfg.angle_thresh)
    return poses, res, is_kf


def _wb_appends(state: SlamState, last_kf_reg, poses, hessians, pts, msk,
                is_kf, cfg: PipelineConfig):
    """Window backend stage 1: keyframe/factor appends (one masked write per
    array; slots are a cumsum over the keyframe flags). Returns ``(graph,
    kf, aux)``; ``kf`` is not yet pose-synced."""
    w = poses.shape[0]
    dev = poses.device
    graph, kf = state.graph, state.kf
    cap_v = graph.capacity
    cap_f = graph.bet_mask.shape[0]

    cum = torch.cumsum(is_kf.to(torch.long), 0)
    slot = graph.n_poses + cum - 1                               # [W]
    ok = is_kf & (slot < cap_v)
    k_new = ok.sum()

    idx = torch.arange(w, device=dev)
    gov = torch.cummax(torch.where(ok, idx, torch.full_like(idx, -1)), 0).values
    anchor_reg = torch.where((gov >= 0)[:, None],
                             poses[torch.clamp(gov, min=0)], last_kf_reg)
    prev_gov = torch.cat([torch.full((1,), -1, device=dev), gov[:-1]])
    parent_reg = torch.where((prev_gov >= 0)[:, None],
                             poses[torch.clamp(prev_gov, min=0)], last_kf_reg)
    parent_idx = torch.where(cum > 1, graph.n_poses + cum - 2,
                             state.last_kf_idx)

    anchor_node = graph.poses[state.last_kf_idx]
    node_vals = se2.compose(anchor_node[None, :],
                            se2.between(last_kf_reg[None, :], poses))
    z_odo = se2.between(parent_reg, poses)
    sqrt_infos = _odom_info_sqrt(hessians)

    graph = graph._replace(
        poses=_set_rows(graph.poses, slot, ok, node_vals),
        pose_mask=_set_rows(graph.pose_mask, slot, ok, True),
        n_poses=graph.n_poses + k_new)
    fslot = graph.n_between + cum - 1
    fok = ok & (fslot < cap_f)
    graph = graph._replace(
        bet_i=_set_rows(graph.bet_i, fslot, fok, parent_idx),
        bet_j=_set_rows(graph.bet_j, fslot, fok, slot),
        bet_z=_set_rows(graph.bet_z, fslot, fok, z_odo),
        bet_sqrt_info=_set_rows(graph.bet_sqrt_info, fslot, fok, sqrt_infos),
        bet_mask=_set_rows(graph.bet_mask, fslot, fok, True),
        n_between=graph.n_between + fok.sum())
    kslot = kf.n + cum - 1
    kf = kf._replace(
        poses=_set_rows(kf.poses, kslot, ok, node_vals),
        points=_set_rows(kf.points, kslot, ok, pts),
        masks=_set_rows(kf.masks, kslot, ok, msk),
        live=_set_rows(kf.live, kslot, ok, True),
        n=kf.n + k_new)
    last_idx = torch.where(k_new > 0, graph.n_poses - 1, state.last_kf_idx)
    lkr = anchor_reg[-1]

    zeros_w = torch.zeros(w, dtype=torch.int32, device=dev)
    nl_out, ld_out, ni_out = zeros_w, zeros_w, zeros_w
    if cfg.use_loop_closure:
        # The new keyframes' local tables, written into the cache in place
        # (the cache is ~315 MB at config 3; a copy per window would move
        # it twice).
        closure.write_local_tables(kf.tables, kslot, ok, pts, msk, cfg.loop,
                                   cfg.ndt, cfg.match.compact_table)
        graph, nl_out, ld_out, ni_out = _wb_loops(graph, kf, pts, msk,
                                                  node_vals, slot, cum, ok,
                                                  cfg)

    nd_out = ((is_kf & ~ok).to(torch.int32) + (ok & ~fok).to(torch.int32)
              + ld_out)
    cum_ok = torch.cumsum(ok.to(torch.long), 0)
    kf_idx_out = torch.where(cum_ok > 0, state.graph.n_poses + cum_ok - 1,
                             state.last_kf_idx)
    rel_out = se2.between(anchor_reg, poses)
    aux = dict(kslot=kslot, kslot_ok=ok, last_idx=last_idx, lkr=lkr,
               any_kf=is_kf.any(), n_loops_new=nl_out.sum(),
               kf_idx_out=kf_idx_out, rel_out=rel_out, nl_out=nl_out,
               nd_out=nd_out, ni_out=ni_out)
    return graph, kf, aux


def _wb_loops(graph, kf, pts, msk, node_vals, slot, cum, ok,
              cfg: PipelineConfig):
    """Loop detection for the window's first ``max_detect_per_window``
    keyframes as ONE flat ``K*C``-lane verification, and the masked append
    of the accepted loop factors. Returns ``(graph, nl [W], ld [W], ni
    [W])``: loops appended, loops dropped at factor capacity, and
    innovation-budget rejections, at each query's scan."""
    w = pts.shape[0]
    dev = pts.device
    cap_f = graph.bet_mask.shape[0]
    kmax = min(cfg.loop.max_detect_per_window or w, w)
    ranks = torch.arange(kmax, device=dev)
    # sel[r] = scan index of the window's r-th keyframe (0 if absent).
    hit = (cum[None, :] - 1 == ranks[:, None]) & ok[None, :]      # [K, W]
    sel = torch.argmax(hit.to(torch.uint8), 1)
    has = hit.any(1)
    slot_k = slot[sel]
    do = has & (slot_k % cfg.loop.detect_every == 0)
    loops = closure.detect_loops_cached_flat(kf, pts[sel], msk[sel],
                                             node_vals[sel], slot_k,
                                             cfg.loop, cfg.match)
    accept = loops.accept & do[:, None]                           # [K, C]
    acc_flat = accept.reshape(-1)
    lslot = graph.n_between + torch.cumsum(acc_flat.to(torch.long), 0) - 1
    lok = acc_flat & (lslot < cap_f)
    iflat = slot_k[:, None].expand(accept.shape).reshape(-1)
    graph = graph._replace(
        bet_i=_set_rows(graph.bet_i, lslot, lok, loops.j.reshape(-1)),
        bet_j=_set_rows(graph.bet_j, lslot, lok, iflat),
        bet_z=_set_rows(graph.bet_z, lslot, lok, loops.z.reshape(-1, 3)),
        bet_sqrt_info=_set_rows(graph.bet_sqrt_info, lslot, lok,
                                loops.sqrt_info.reshape(-1, 3, 3)),
        bet_mask=_set_rows(graph.bet_mask, lslot, lok, True),
        n_between=graph.n_between + lok.sum())

    def per_scan(flags):                 # [K, C] -> count at each scan [W]
        n = torch.where(has, flags.sum(1), torch.zeros_like(has,
                                                            dtype=torch.long))
        return torch.zeros(w, dtype=torch.int32, device=dev).index_add_(
            0, sel, n.to(torch.int32))

    return (graph, per_scan(lok.reshape(accept.shape)),
            per_scan((acc_flat & ~lok).reshape(accept.shape)),
            per_scan(loops.innov_rej & do[:, None]))


def _wb_smooth(state: SlamState, graph, any_kf, cfg: PipelineConfig):
    """Window backend stage 2: one smoothing pass per window with a new
    keyframe. Returns ``(SmootherState, take_code)``."""
    sm = inc.SmootherState(graph=graph, lam=state.sm_lam,
                           last_max_delta=state.sm_last_delta,
                           step=state.sm_step)
    if bool(any_kf):
        return inc.incremental_update(
            sm, cfg.solver, huber_delta=cfg.solver.huber_delta,
            fresh_since=state.graph.n_between, return_take=True)
    return sm, torch.zeros((), dtype=torch.int32, device=graph.poses.device)


def _wb_extend(state: SlamState, poses, pts, msk, is_kf, kslot, kslot_ok,
               cfg: PipelineConfig):
    """Insert this window's keyframe scans at their registration-time poses
    (K3). Returns ``(stats, mkp)``."""
    mkp = _set_rows(state.map_kf_poses, kslot, kslot_ok, poses)
    wpts = se2.transform(poses, pts)
    stats = ndt_grid.add_points(state.stats, wpts.reshape(-1, 2),
                                (msk & is_kf[:, None]).reshape(-1), cfg.grid)
    return stats, mkp


def _wb_maps(state: SlamState, kf, poses, pts, msk, is_kf, kslot, kslot_ok,
             n_loops_new, sm_step, any_kf, cfg: PipelineConfig):
    """Window backend stage 3: map maintenance (extend; then the top-M
    refresh, or the legacy rebuild when a loop factor landed)."""

    def rebuild():
        world = se2.transform(kf.poses, kf.points)
        m = kf.masks & kf.live[:, None]
        return (ndt_grid.build_stats(world.reshape(-1, 2), m.reshape(-1),
                                     cfg.grid), kf.poses)

    if cfg.refresh_top_m > 0:
        stats, mkp = _wb_extend(state, poses, pts, msk, is_kf, kslot,
                                kslot_ok, cfg)
        if cfg.refresh_always or bool(n_loops_new > 0):
            stats, mkp = _refresh_map(stats, kf, mkp, cfg)
        if cfg.full_rebuild_every > 0 and bool(
                (sm_step % cfg.full_rebuild_every
                 == cfg.full_rebuild_every - 1) & any_kf):
            stats, mkp = rebuild()
        return stats, mkp
    if bool(n_loops_new > 0):
        return rebuild()
    return _wb_extend(state, poses, pts, msk, is_kf, kslot, kslot_ok, cfg)


def _window_backend(state: SlamState, last_kf_reg, poses, hessians, pts, msk,
                    is_kf, cfg: PipelineConfig):
    """Appends, smoothing and map maintenance for one registered window.
    Returns ``(state, last_kf_reg, kf_idx, rel, nl, nd, ni, take)``."""
    graph, kf, aux = _wb_appends(state, last_kf_reg, poses, hessians, pts,
                                 msk, is_kf, cfg)
    sm, take = _wb_smooth(state, graph, aux["any_kf"], cfg)
    graph = sm.graph
    kf = kf._replace(poses=graph.poses[: kf.capacity])
    stats, mkp = _wb_maps(state, kf, poses, pts, msk, is_kf, aux["kslot"],
                          aux["kslot_ok"], aux["n_loops_new"], sm.step,
                          aux["any_kf"], cfg)
    last_idx, lkr = aux["last_idx"], aux["lkr"]
    pose_out = se2.compose(graph.poses[last_idx], se2.between(lkr, poses[-1]))
    new_state = SlamState(
        stats=stats, kf=kf, graph=graph, sm_lam=sm.lam,
        sm_last_delta=sm.last_max_delta, sm_step=sm.step, pose=pose_out,
        last_kf_idx=last_idx, n_loops=state.n_loops + aux["n_loops_new"],
        map_kf_poses=mkp)
    return (new_state, lkr, aux["kf_idx_out"], aux["rel_out"],
            aux["nl_out"], aux["nd_out"], aux["ni_out"], take)


def slam_window_step(state: SlamState, last_kf_reg, pts, msk, deltas,
                     cfg: PipelineConfig):
    """Process one window of W scans (registration + backend).
    Returns ``((state, last_kf_reg), SlamStepOut over W scans)``.

    With loop closure on, the step takes ownership of the input state's
    keyframe table cache (``state.kf.tables``): it writes the window's new
    tables into that tensor in place and hands it on in the new state. A
    caller that needs the input state afterwards clones its cache first."""
    _check_slice(cfg, pts.device)
    poses, res, is_kf = _window_frontend(state, last_kf_reg, pts, msk, deltas,
                                         cfg, cfg.window_passes)
    state, last_kf_reg, kf_idx, rel, nl, nd, ni, take = _window_backend(
        state, last_kf_reg, poses, res.hessian, pts, msk, is_kf, cfg)
    w = poses.shape[0]
    out = SlamStepOut(pose=poses, kf_idx=kf_idx, rel=rel, score=res.score,
                      is_keyframe=is_kf, n_loops_new=nl, n_dropped=nd,
                      n_innov_rej=ni, local_take=take.expand(w))
    return (state, last_kf_reg), out


def window_inputs(points, mask, odom, window: int):
    """Steps 1..T-1 cut into padded windows: ``(pts [n,W,N,2], msk [n,W,N],
    odo [n,W,3], n_win)``."""
    pts_w, msk_w, odo_w, n_win, _ = _pad_to_windows(points[1:], mask[1:],
                                                    odom[1:], window)
    return (pts_w.reshape(n_win, window, *pts_w.shape[1:]),
            msk_w.reshape(n_win, window, *msk_w.shape[1:]),
            odo_w.reshape(n_win, window, 3), n_win)


def stack_outs(outs, t_steps: int) -> SlamStepOut:
    """Concatenate per-window outputs and cut the padding."""
    return SlamStepOut(*(torch.cat(f)[:t_steps] for f in zip(*outs)))


def run_slam_windowed(points, mask, odom, cfg: PipelineConfig,
                      init_pose=None):
    """Window-batched full SLAM (configs 1-3).

    points ``[T, N, 2]``, mask ``[T, N]``, odom ``[T, 3]`` on the device the
    run should use. Returns ``(final SlamState, SlamStepOut over T-1
    scans)``.
    """
    state = init_slam(cfg, points[0], mask[0], init_pose)
    pts_w, msk_w, odo_w, n_win = window_inputs(points, mask, odom, cfg.window)
    carry, outs = (state, state.pose), []
    for k in range(n_win):
        carry, out = slam_window_step(carry[0], carry[1], pts_w[k], msk_w[k],
                                      odo_w[k], cfg)
        outs.append(out)
    return carry[0], stack_outs(outs, points.shape[0] - 1)


def recover_trajectory(state: SlamState, outs: SlamStepOut, init_pose=None):
    """Per-scan trajectory ``[T, 3]``: each scan re-anchored on its
    keyframe's smoothed pose."""
    anchors = state.graph.poses[outs.kf_idx]
    poses = se2.compose(anchors, outs.rel)
    p0 = state.graph.poses[0] if init_pose is None else init_pose
    return torch.cat([p0[None].to(poses.dtype), poses], 0)
