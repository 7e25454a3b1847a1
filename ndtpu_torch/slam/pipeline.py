"""SLAM pipeline: NDT odometry + keyframing + smoothing + map, per window
of W scans or per scan.

Port of ``ndtpu/slam/pipeline.py`` (configs 1-3). One window of W scans
runs:

1. ``_window_frontend``: K4 finalize+pack of the map, W-lane LM
   registration through K1, K3 insert of the window's provisional
   keyframes into a temporary map, K4 again, and a second registration
   pass; then ``kf_select``.
2. ``_wb_appends``: all of the window's keyframes and odometry factors are
   appended, with the map's keyframe poses, in one K14 launch
   (``slam.appends``: one masked write per graph, keyframe and map-pose
   array). With loop closure on, K8a writes the new keyframes' local
   tables into the cache, and one flat detection over the window's first
   ``max_detect_per_window`` keyframes (``K*C`` lanes through grouped K1,
   then the K8b gate) yields the loop factors, which K14's loop entry
   appends in one more launch.
3. ``_window_flags``: every branch decision of the window, computed on the
   device and read with one transfer.
4. ``_wb_smooth``: ``incremental_update`` when a keyframe landed.
5. ``_wb_maps``: the K3 insert of the window's keyframes (or the rebuild /
   top-M refresh the config selects; a landed loop factor triggers it).

The per-scan path (:func:`slam_step`, :func:`run_slam`) registers each
scan against the map's K4 table (one ``lm_ndt`` lane), and on a keyframe
(:func:`_keyframe_branch`) appends the pose and odometry factor, writes
the keyframe's local table into the cache (K8a, in place), runs the
per-query cached loop verify (one gated ``lm_ndt`` launch), appends the
accepted loop factors, runs ``incremental_update`` and keeps the map by
the legacy policy: a K3 rebuild from every keyframe when a loop landed,
else a K3 insert of the scan.

JAX's ``.at[idx].set(..., mode="drop")`` with the ``1 << 30`` sentinel
becomes K14 on the windowed path (new arrays, the kept rows substituted;
no host sync) and a one-row ``index_copy`` per scan; each ``lax.cond``
becomes a Python ``if`` on a host bool: the window reads its decisions in
one transfer and the smoother at most two more mid-branch (and its full
solve one), the per-scan step once per scan on its keyframe test.
Keyframe store index == pose-graph variable index.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ndtpu_torch import kernels
from ndtpu_torch.config import PipelineConfig
from ndtpu_torch.graph import factors as fct
from ndtpu_torch.graph import incremental as inc
from ndtpu_torch.lie import se2
from ndtpu_torch.loop import closure
from ndtpu_torch.ndt import grid as ndt_grid
from ndtpu_torch.ndt import match as ndt_match
from ndtpu_torch.slam import appends
from ndtpu_torch.slam import keyframes as kfs
from ndtpu_torch.slam.appends import _odom_info_sqrt
from ndtpu_torch.slam.odometry import (_pad_to_windows, chain_deltas,
                                       gate_poses, kf_select)

__all__ = ["SlamState", "SlamStepOut", "init_slam", "slam_step", "run_slam",
           "slam_window_step", "run_slam_windowed", "recover_trajectory"]


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


def init_slam(cfg: PipelineConfig, first_points, first_mask,
              init_pose=None) -> SlamState:
    """Bootstrap: scan 0 becomes keyframe 0 / graph pose 0 with a prior.
    State lives on ``first_points``' device, in its dtype."""
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


def _map_table(stats, cfg: PipelineConfig):
    return ndt_grid.finalize_pack(stats, cfg.ndt, cfg.grid,
                                  cfg.match.compact_table)


def _refresh_map(stats, kf: kfs.KeyframeStore, mkp, cfg: PipelineConfig,
                 enable=True):
    """Re-place the ``refresh_top_m`` stalest keyframes: subtract each at
    the pose the map saw it at, add it at its smoothed pose (one weighted
    K3 call). ``enable`` (a bool or a 0-d bool tensor) masks the whole
    refresh to a no-op, as the stacked multi-session path runs it for the
    sessions whose trigger is false. The points are
    :func:`_refresh_points` at one session (K16 on the card). Returns
    ``(stats, mkp)``."""
    if isinstance(enable, torch.Tensor):
        enable = enable.reshape(1)
    both, bmsk, wts, sel, do, rows = _refresh_points(
        _lead(kf), mkp[None], cfg, enable)
    stats = ndt_grid.add_points(stats, both[0], bmsk[0], cfg.grid,
                                weight=wts[0])
    return stats, appends.set_rows(mkp[None], sel, do, rows)[0]


def _refresh_points(kf8: kfs.KeyframeStore, mkp8, cfg: PipelineConfig,
                    enable8=True):
    """The refresh's weighted points for ``S`` sessions (``kf8`` and
    ``mkp8 [S, cap, 3]`` with a leading session axis; ``enable8`` a bool
    or ``[S]`` bool): :func:`refresh_points_ref`'s outputs, from K16
    ``refresh_points`` (one launch) on CUDA tensors, from
    :func:`refresh_points_ref` on CPU tensors."""
    m_top = min(cfg.refresh_top_m, kf8.poses.shape[1])
    if enable8 is True:
        enable8 = None
    elif enable8 is False:
        enable8 = torch.zeros(mkp8.shape[0], dtype=torch.bool,
                              device=mkp8.device)
    args = (kf8.poses.contiguous(), kf8.live.contiguous(),
            kf8.points.contiguous(), kf8.masks.contiguous(),
            mkp8.contiguous(), enable8, m_top, cfg.refresh_eps)
    if mkp8.is_cuda:
        return kernels.refresh_points(*args)
    return refresh_points_ref(*args)


def refresh_staleness(kf_poses, kf_live, mkp):
    """How far each keyframe moved since the map saw it: ``max(sqrt(dx dx +
    dy dy), |wrap(dth)|)`` of ``kf_poses`` against ``mkp`` where live, else
    0 (``[..., cap]``; K16 computes it in this order)."""
    dx = kf_poses[..., 0] - mkp[..., 0]
    dy = kf_poses[..., 1] - mkp[..., 1]
    d_xy = torch.sqrt(dx * dx + dy * dy)
    d_th = torch.abs(se2.wrap(kf_poses[..., 2] - mkp[..., 2]))
    return torch.where(kf_live, torch.maximum(d_xy, d_th),
                       torch.zeros_like(d_xy))


def refresh_points_ref(kf_poses, kf_live, kf_points, kf_masks, mkp, enable,
                       m: int, eps: float) -> tuple:
    """The plain version of K16 (``kernels.refresh_points``): for each of
    ``S`` sessions the ``m`` stalest keyframes (staleness ``max(|dxy|,
    |wrap(dth)|)`` of ``kf_poses`` against ``mkp`` where live, else 0;
    ``lax.top_k`` as a stable descending sort, equal staleness in index
    order) at their old poses (weight -1) then at their smoothed poses
    (+1). Returns ``(both [S, 2 m N, 2], bmsk [S, 2 m N], wts [S, 2 m N],
    sel [S, m], do [S, m], rows [S, m, 3])``, ``do = stale > eps &
    enable`` (``enable [S]`` or None) and ``rows = kf_poses[sel]``."""
    s, _, n = kf_masks.shape
    stale = refresh_staleness(kf_poses, kf_live, mkp)
    val, order = torch.sort(stale, dim=1, descending=True, stable=True)
    val, sel = val[:, :m], order[:, :m]
    do = val > eps
    if enable is not None:
        do = do & enable[:, None]
    take = lambda a: torch.gather(
        a, 1, sel.reshape((s, m) + (1,) * (a.dim() - 2)).expand(
            (s, m) + a.shape[2:]))
    rows = take(kf_poses)
    smsk = (take(kf_masks) & take(kf_live)[..., None]
            & do[..., None]).reshape(s, m * n)
    spts = take(kf_points)
    old_w = se2.transform(take(mkp), spts).reshape(s, m * n, 2)
    new_w = se2.transform(rows, spts).reshape(s, m * n, 2)
    dt, dev = kf_points.dtype, kf_points.device
    wts = torch.cat([torch.full((s, m * n), -1.0, dtype=dt, device=dev),
                     torch.ones((s, m * n), dtype=dt, device=dev)], 1)
    return (torch.cat([old_w, new_w], 1), torch.cat([smsk, smsk], 1), wts,
            sel, do, rows)


def _row(arr, idx):
    """``arr[idx]`` for a 0-d index tensor, clamped to the rows (JAX's
    gather), without reading the index back to the host."""
    return arr.index_select(0, torch.clamp(idx, max=arr.shape[0] - 1)
                            .reshape(1))[0]


def _keyframe_branch(state: SlamState, pts, msk, pose, hessian,
                     cfg: PipelineConfig):
    """Everything that happens when a scan becomes a keyframe. Returns
    ``(state, n_new, n_drop, n_innov, take)``. With loop closure on, the
    keyframe's local table is written into ``state.kf.tables`` in place."""
    cap = state.graph.capacity
    new_idx = state.graph.n_poses

    # 1. New pose variable and odometry factor (noise from the Hessian).
    graph = fct.add_pose(state.graph, pose)
    z_odo = se2.between(_row(state.graph.poses, state.last_kf_idx), pose)
    graph = fct.add_between(graph, state.last_kf_idx, new_idx, z_odo,
                            _odom_info_sqrt(hessian))

    # 2. Keyframe store append (before detection: the query is no candidate
    #    of itself by the index-gap test); K8a writes its table in place.
    kf = kfs.add_keyframe(state.kf, pose, pts, msk)
    zero = torch.zeros((), dtype=torch.int32, device=pose.device)
    n_new = n_innov = zero
    if cfg.use_loop_closure:
        slot = torch.clamp(state.kf.n, max=kf.capacity - 1)[None]
        closure.write_local_tables(kf.tables, slot,
                                   (state.kf.n < kf.capacity)[None],
                                   pts[None], msk[None], cfg.loop, cfg.ndt,
                                   cfg.match.compact_table)
        # 3. Loop detection and the masked loop-factor appends.
        loops = closure.detect_loops_cached(kf, pts, msk, pose, new_idx,
                                            cfg.loop, cfg.match)
        for i in range(loops.j.shape[-1]):
            graph = fct.add_between(graph, loops.j[i], new_idx, loops.z[i],
                                    loops.sqrt_info[i],
                                    enabled=loops.accept[i])
        n_new = loops.accept.sum(dtype=torch.int32)
        n_innov = loops.innov_rej.sum(dtype=torch.int32)

    # Appends above are masked; count what the capacity dropped.
    n_drop = ((1 - (graph.n_poses - state.graph.n_poses))
              + (1 - (kf.n - state.kf.n))
              + (1 + n_new - (graph.n_between - state.graph.n_between))
              ).to(torch.int32)

    # 4. Incremental smoothing.
    sm = inc.SmootherState(graph=graph, lam=state.sm_lam,
                           last_max_delta=state.sm_last_delta,
                           step=state.sm_step)
    sm, take = inc.incremental_update(sm, cfg.solver,
                                      huber_delta=cfg.solver.huber_delta,
                                      fresh_since=state.graph.n_between,
                                      return_take=True)
    graph = sm.graph

    # 5. Keyframe poses from the graph; the current pose is the newest.
    kf = kf._replace(poses=graph.poses[: kf.capacity])
    pose_out = _row(graph.poses, new_idx)

    # 6. The map: rebuilt from every keyframe at its smoothed pose when a
    #    loop landed, else extended by this scan.
    mkp = fct._masked_set(state.map_kf_poses,
                          torch.clamp(new_idx, max=cap - 1), pose_out,
                          new_idx < state.map_kf_poses.shape[0])
    if cfg.use_loop_closure and bool(n_new > 0):
        world = se2.transform(kf.poses, kf.points)
        m = kf.masks & kf.live[:, None]
        stats = ndt_grid.build_stats(world.reshape(-1, 2), m.reshape(-1),
                                     cfg.grid)
        mkp = kf.poses
    else:
        stats = ndt_grid.add_points(state.stats, se2.transform(pose_out, pts),
                                    msk, cfg.grid)
    return SlamState(
        stats=stats, kf=kf, graph=graph, sm_lam=sm.lam,
        sm_last_delta=sm.last_max_delta, sm_step=sm.step, pose=pose_out,
        last_kf_idx=new_idx, n_loops=state.n_loops + n_new,
        map_kf_poses=mkp), n_new, n_drop, n_innov, take


def slam_step(state: SlamState, pts, msk, odom_delta, cfg: PipelineConfig):
    """Process one scan (``pts [N, 2]``, ``msk [N]``, ``odom_delta [3]``);
    returns ``(new_state, SlamStepOut)`` of 0-d / ``[3]`` tensors.

    Registration is one ``match_batch_packed`` lane against the map's K4
    table; the keyframe test is the step's one host sync. With loop closure
    on, a keyframe step takes ownership of the input state's table cache
    (K8a writes into it in place): a caller that needs the input state
    afterwards clones ``state.kf.tables`` first."""
    init = se2.compose(state.pose, odom_delta)
    res = ndt_match.match_batch_packed(pts[None], msk[None],
                                       _map_table(state.stats, cfg),
                                       init[None], cfg.grid, cfg.match)
    res = ndt_match.MatchResult(*(a[0] for a in res))
    pose, _ = gate_poses(res.pose, res.converged, init, cfg.odom_gate)
    diff = se2.between(_row(state.graph.poses, state.last_kf_idx), pose)
    is_kf = ((torch.linalg.norm(diff[:2]) > cfg.keyframe.dist_thresh)
             | (torch.abs(diff[2]) > cfg.keyframe.angle_thresh))
    if bool(is_kf):
        state, n_new, n_drop, n_innov, take = _keyframe_branch(
            state, pts, msk, pose, res.hessian, cfg)
    else:
        state = state._replace(pose=pose)
        n_new = n_drop = n_innov = take = torch.zeros(
            (), dtype=torch.int32, device=pose.device)
    anchor = _row(state.graph.poses, state.last_kf_idx)
    out = SlamStepOut(pose=state.pose, kf_idx=state.last_kf_idx,
                      rel=se2.between(anchor, state.pose), score=res.score,
                      is_keyframe=is_kf, n_loops_new=n_new, n_dropped=n_drop,
                      n_innov_rej=n_innov, local_take=take)
    return state, out


def stack_scan_outs(outs) -> SlamStepOut:
    """Per-scan outputs stacked over the scans."""
    return SlamStepOut(*(torch.stack(f) for f in zip(*outs)))


def run_slam(points, mask, odom, cfg: PipelineConfig, init_pose=None):
    """Full-sequence SLAM, one :func:`slam_step` per scan (configs 2-3).

    points ``[T, N, 2]``, mask ``[T, N]``, odom ``[T, 3]`` on the device the
    run should use. Returns ``(final SlamState, SlamStepOut stacked over
    T-1 scans)``."""
    state = init_slam(cfg, points[0], mask[0], init_pose)
    outs = []
    for t in range(1, points.shape[0]):
        state, out = slam_step(state, points[t], mask[t], odom[t], cfg)
        outs.append(out)
    return state, stack_scan_outs(outs)


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


def _retuple(like, items):
    return type(like)(*items) if hasattr(like, "_fields") else tuple(items)


def _lead(tree):
    """A (nested) NamedTuple of tensors with a leading session axis of 1
    (views)."""
    if tree is None or isinstance(tree, (bool, int, float)):
        return tree
    if isinstance(tree, tuple):
        return _retuple(tree, [_lead(x) for x in tree])
    return tree[None]


def _first(tree):
    """Session 0 of a (nested) NamedTuple or dict of tensors (views)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _first(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return _retuple(tree, [_first(x) for x in tree])
    return tree[0]


def _wb_appends(state: SlamState, last_kf_reg, poses, hessians, pts, msk,
                is_kf, cfg: PipelineConfig):
    """Window backend stage 1: :func:`appends_stacked` of one session (a
    leading session axis of 1). Returns ``(graph, kf, aux)``; ``kf`` is not
    yet pose-synced. No host sync."""
    return _first(appends_stacked(
        _lead(state.graph), _lead(state.kf), state.map_kf_poses[None],
        state.last_kf_idx[None], last_kf_reg[None], poses[None],
        hessians[None], pts[None], msk[None], is_kf[None], cfg))


def appends_stacked(graph8, kf8, mkp8, last_kf_idx8, lkr8, poses8,
                    hessians8, pts8, msk8, is_kf8, cfg: PipelineConfig):
    """The window's appends for ``S`` sessions (every argument with a
    leading session axis; ``pipeline._wb_appends`` of the JAX package,
    vmapped over sessions in serving): the keyframe and factor appends
    with ``map_kf_poses``' rows (K14, one launch on the card), the new
    keyframes' local tables (K8a, one launch into the flat view of the
    stacked cache, in place), the loop verify (:func:`_loop_lanes`: one
    K15 and one gated ``lm_ndt`` launch for all sessions) and the accepted
    loop factors (K14's loop entry, one launch). Returns ``(graph8, kf8,
    aux8)``; ``kf8`` is not yet pose-synced. No host sync."""
    s, w = is_kf8.shape
    app = appends.append_window(graph8, kf8, mkp8, last_kf_idx8, lkr8,
                                poses8, hessians8, pts8, msk8, is_kf8)
    graph8, kf8 = app.graph, app.kf
    zeros = torch.zeros((s, w), dtype=torch.int32, device=pts8.device)
    nl8, ld8, ni8 = zeros, zeros, zeros
    if cfg.use_loop_closure:
        # Session s's slot k is row s cap + k of the flat cache; a slot at
        # or past cap is dropped, never written into session s + 1. The
        # cache is ~315 MB at config 3: written in place, not copied.
        cap = kf8.tables.shape[1]
        keep = app.ok & (app.kslot >= 0) & (app.kslot < cap)
        rows = torch.where(keep, app.kslot + cap * torch.arange(
            s, device=pts8.device)[:, None], torch.full_like(app.kslot, -1))
        closure.write_local_tables(
            kf8.tables.view((s * cap,) + kf8.tables.shape[2:]),
            rows.reshape(-1), keep.reshape(-1), pts8.reshape(
                (s * w,) + pts8.shape[2:]), msk8.reshape(s * w, -1),
            cfg.loop, cfg.ndt, cfg.match.compact_table)
        lanes = _loop_lanes(kf8, pts8, msk8, app.node_vals, app.slot,
                            app.cum, app.ok, cfg)
        graph8, nl8, ld8, ni8 = _append_loops(graph8, lanes, w)
    aux8 = dict(kslot=app.kslot, kslot_ok=app.ok, last_idx=app.last_idx,
                lkr=app.lkr, any_kf=app.any_kf, n_loops_new=nl8.sum(1),
                kf_idx_out=app.kf_idx_out, rel_out=app.rel_out, nl_out=nl8,
                nd_out=app.nd_out + ld8, ni_out=ni8,
                map_kf_poses=app.map_kf_poses)
    return graph8, kf8, aux8


class LoopLanes(NamedTuple):
    """A window's loop lanes, S sessions x K queries x C candidates (K14's
    loop entry's input)."""
    accept: torch.Tensor     # [S, K, C] accepted, masked by the cadence
    j: torch.Tensor          # [S, K, C] candidate keyframe
    z: torch.Tensor          # [S, K, C, 3]
    sqrt_info: torch.Tensor  # [S, K, C, 3, 3]
    innov: torch.Tensor      # [S, K, C] innovation-rejected, masked likewise
    slot_k: torch.Tensor     # [S, K] the query's graph slot
    sel: torch.Tensor        # [S, K] the query's scan in the window
    has: torch.Tensor        # [S, K] the window has a K-th keyframe


def _loop_lanes(kf8, pts8, msk8, node_vals8, slot8, cum8, ok8,
                cfg: PipelineConfig) -> LoopLanes:
    """Loop detection for each session's first ``max_detect_per_window``
    keyframes of the window as ONE ``S K C``-lane verification
    (``closure.detect_loops_stacked``)."""
    w = pts8.shape[1]
    kmax = min(cfg.loop.max_detect_per_window or w, w)
    ranks = torch.arange(kmax, device=pts8.device)
    # sel[s, r] = scan index of session s's r-th keyframe (0 if absent).
    hit = (cum8[:, None, :] - 1 == ranks[:, None]) & ok8[:, None, :]
    sel = torch.argmax(hit.to(torch.uint8), 2)                    # [S, K]
    has = hit.any(2)
    slot_k = torch.gather(slot8, 1, sel)
    do = (has & (slot_k % cfg.loop.detect_every == 0))[..., None]
    loops = closure.detect_loops_stacked(kf8, pts8, msk8, node_vals8, sel,
                                         slot_k, cfg.loop, cfg.match)
    return LoopLanes(loops.accept & do, loops.j, loops.z, loops.sqrt_info,
                     loops.innov_rej & do, slot_k, sel, has)


def _append_loops(graph: fct.PoseGraph, lanes: LoopLanes, w: int):
    """K14's loop entry on stacked sessions (every field with a leading
    session axis): ``(graph, nl [S, W], ld [S, W], ni [S, W])``, loops
    appended, dropped at factor capacity and innovation-rejected at each
    query's scan."""
    out = appends.loop_append(graph.bet_i, graph.bet_j, graph.bet_z,
                              graph.bet_sqrt_info, graph.bet_mask,
                              graph.n_between, *lanes, w)
    return (graph._replace(bet_i=out[0], bet_j=out[1], bet_z=out[2],
                           bet_sqrt_info=out[3], bet_mask=out[4],
                           n_between=out[5]), out[6], out[7], out[8])


class WindowFlags(NamedTuple):
    """The window's branch decisions, as host bools."""
    any_kf: bool            # a keyframe landed: the smoother runs
    loop_landed: bool       # a loop factor landed: refresh or rebuild
    rebuild: bool           # the periodic full rebuild is due
    gates: inc.Gates        # the smoother's settled / fresh / full-solve


def _window_flags(state: SlamState, graph, aux,
                  cfg: PipelineConfig) -> WindowFlags:
    """Every branch decision of the window (JAX's ``lax.cond`` predicates:
    ``_wb_smooth``'s, ``_wb_maps``' triggers, ``incremental_update``'s
    settled and fresh tests and its full-solve cadence), computed on the
    device and read with ONE transfer."""
    any_kf = aux["any_kf"]
    sm = inc.SmootherState(graph=graph, lam=state.sm_lam,
                           last_max_delta=state.sm_last_delta,
                           step=state.sm_step)
    gates = inc.gate_flags(sm, cfg.solver)
    fre = cfg.full_rebuild_every
    if cfg.refresh_top_m > 0 and fre > 0:
        # The smoother's step after this window: +1 where it runs.
        step = state.sm_step + any_kf.to(state.sm_step.dtype)
        rebuild = (step % fre == fre - 1) & any_kf
    else:
        rebuild = torch.zeros_like(any_kf)
    vals = torch.cat([torch.stack([any_kf, aux["n_loops_new"] > 0, rebuild]),
                      gates]).tolist()
    return WindowFlags(*vals[:3], inc.Gates(*vals[3:]))


def _wb_smooth(state: SlamState, graph, any_kf: bool, gates: inc.Gates,
               cfg: PipelineConfig):
    """Window backend stage 2: one smoothing pass per window with a new
    keyframe (``any_kf`` and the smoother's ``gates``, host bools from
    :func:`_window_flags`). Returns ``(SmootherState, take_code)``."""
    sm = inc.SmootherState(graph=graph, lam=state.sm_lam,
                           last_max_delta=state.sm_last_delta,
                           step=state.sm_step)
    if any_kf:
        return inc.incremental_update(
            sm, cfg.solver, huber_delta=cfg.solver.huber_delta,
            fresh_since=state.graph.n_between, return_take=True, gates=gates)
    return sm, torch.zeros((), dtype=torch.int32, device=graph.poses.device)


def _wb_extend(state: SlamState, mkp, poses, pts, msk, is_kf,
               cfg: PipelineConfig):
    """Insert this window's keyframe scans at their registration-time poses
    (K3). ``mkp`` is ``map_kf_poses`` with the window's rows, which K14
    wrote with the appends. Returns ``(stats, mkp)``."""
    wpts = se2.transform(poses, pts)
    stats = ndt_grid.add_points(state.stats, wpts.reshape(-1, 2),
                                (msk & is_kf[:, None]).reshape(-1), cfg.grid)
    return stats, mkp


def _wb_maps(state: SlamState, kf, poses, pts, msk, is_kf, mkp,
             loop_landed: bool, rebuild_due: bool, cfg: PipelineConfig):
    """Window backend stage 3: map maintenance (extend; then the top-M
    refresh, or the legacy rebuild when a loop factor landed). The triggers
    are host bools (:func:`_window_flags`)."""

    def rebuild():
        world = se2.transform(kf.poses, kf.points)
        m = kf.masks & kf.live[:, None]
        return (ndt_grid.build_stats(world.reshape(-1, 2), m.reshape(-1),
                                     cfg.grid), kf.poses)

    if cfg.refresh_top_m > 0:
        stats, mkp = _wb_extend(state, mkp, poses, pts, msk, is_kf, cfg)
        if cfg.refresh_always or loop_landed:
            stats, mkp = _refresh_map(stats, kf, mkp, cfg)
        if rebuild_due:
            stats, mkp = rebuild()
        return stats, mkp
    if loop_landed:
        return rebuild()
    return _wb_extend(state, mkp, poses, pts, msk, is_kf, cfg)


def _window_backend(state: SlamState, last_kf_reg, poses, hessians, pts, msk,
                    is_kf, cfg: PipelineConfig):
    """Appends, smoothing and map maintenance for one registered window.
    Its branch decisions are read with one transfer (:func:`_window_flags`);
    the smoother reads at most two more mid-branch (the slow settled check,
    the local probe) and the periodic full solve one. Returns ``(state,
    last_kf_reg, kf_idx, rel, nl, nd, ni, take)``."""
    graph, kf, aux = _wb_appends(state, last_kf_reg, poses, hessians, pts,
                                 msk, is_kf, cfg)
    flags = _window_flags(state, graph, aux, cfg)
    sm, take = _wb_smooth(state, graph, flags.any_kf, flags.gates, cfg)
    graph = sm.graph
    kf = kf._replace(poses=graph.poses[: kf.capacity])
    stats, mkp = _wb_maps(state, kf, poses, pts, msk, is_kf,
                          aux["map_kf_poses"], flags.loop_landed,
                          flags.rebuild, cfg)
    last_idx, lkr = aux["last_idx"], aux["lkr"]
    pose_out = se2.compose(_row(graph.poses, last_idx),
                           se2.between(lkr, poses[-1]))
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
    caller that needs the input state afterwards clones its cache first.
    Every other array of the input state stays as it was: the appends (K14)
    write new graph, keyframe and map-pose arrays, and nothing else writes
    in place, so the new state may share unchanged arrays with the input
    state but never changes them."""
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
    anchors = state.graph.poses[torch.clamp(outs.kf_idx,
                                            max=state.graph.capacity - 1)]
    poses = se2.compose(anchors, outs.rel)
    p0 = state.graph.poses[0] if init_pose is None else init_pose
    return torch.cat([p0[None].to(poses.dtype), poses], 0)
