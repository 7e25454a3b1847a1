"""NDT odometry: the per-scan and the window-batched front ends.

Port of ``ndtpu/slam/odometry.py`` (``run_odometry``, ``gate_poses``,
``chain_deltas``, ``kf_select``, ``_pad_to_windows``,
``run_odometry_windowed``). The loops over scans and windows are Python
loops; the map insert and the quad table go through the K3 / K4 kernels on
the card (``ndt.grid``), registration through ``lm_ndt`` (``ndt.match``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ndtpu_torch.config import (GridConfig, KeyframeConfig, MatchConfig,
                                NDTMapConfig)
from ndtpu_torch.lie import se2
from ndtpu_torch.ndt import grid as ndt_grid
from ndtpu_torch.ndt import match as ndt_match

__all__ = ["OdometryResult", "run_odometry", "gate_poses", "chain_deltas",
           "kf_select", "run_odometry_windowed"]


class OdometryResult(NamedTuple):
    poses: torch.Tensor        # [T, 3]
    scores: torch.Tensor       # [T]
    n_iters: torch.Tensor      # [T] int32
    converged: torch.Tensor    # [T] bool
    is_keyframe: torch.Tensor  # [T] bool
    stats: ndt_grid.NDTStats


def run_odometry(points, mask, odom, grid: GridConfig, ndt_cfg: NDTMapConfig,
                 match_cfg: MatchConfig, kf_cfg: KeyframeConfig,
                 init_pose=None) -> OdometryResult:
    """Scan-to-map NDT odometry, one scan at a time: each scan registers
    (one ``lm_ndt`` lane) against the K4 table of the map so far from its
    odometry prediction, and a keyframe (distance or angle from the last
    one over its threshold) is inserted into the map (K3, masked: no host
    sync). points ``[T, N, 2]``, mask ``[T, N]``, odom ``[T, 3]`` relative
    deltas (``odom[0]`` ignored); scan 0 is the first keyframe."""
    dt, dev = points.dtype, points.device
    t0 = (torch.zeros(3, dtype=dt, device=dev) if init_pose is None
          else init_pose.to(dt))
    stats = ndt_grid.add_points(ndt_grid.empty_stats(grid, dt, dev),
                                se2.transform(t0, points[0]), mask[0], grid)
    pose, last_kf, outs = t0, t0, []
    for t in range(1, points.shape[0]):
        init = se2.compose(pose, odom[t])
        table = ndt_grid.finalize_pack(stats, ndt_cfg, grid,
                                       match_cfg.compact_table)
        res = ndt_match.match_batch_packed(points[t][None], mask[t][None],
                                           table, init[None], grid, match_cfg)
        pose = res.pose[0]
        diff = se2.between(last_kf, pose)
        is_kf = ((torch.sqrt(diff[0] ** 2 + diff[1] ** 2)
                  > kf_cfg.dist_thresh)
                 | (torch.abs(diff[2]) > kf_cfg.angle_thresh))
        stats = ndt_grid.add_points(stats, se2.transform(pose, points[t]),
                                    mask[t] & is_kf, grid)
        last_kf = torch.where(is_kf, pose, last_kf)
        outs.append((pose, res.score[0], res.n_iter[0], res.converged[0],
                     is_kf))
    one_true = torch.ones(1, dtype=torch.bool, device=dev)
    st = lambda i: torch.stack([o[i] for o in outs])
    return OdometryResult(
        poses=torch.cat([t0[None], st(0)]),
        scores=torch.cat([torch.ones(1, dtype=dt, device=dev), st(1)]),
        n_iters=torch.cat([torch.zeros(1, dtype=torch.int32, device=dev),
                           st(2).to(torch.int32)]),
        converged=torch.cat([one_true, st(3)]),
        is_keyframe=torch.cat([one_true, st(4)]),
        stats=stats)


def gate_poses(res_pose, converged, inits, gate: float):
    """Keep a registration only if it converged and stays within ``gate``
    meters of its odometry-predicted init. Returns ``(poses, ok)``."""
    if gate <= 0.0:
        return torch.where(converged[..., None], res_pose, inits), converged
    dev = torch.sqrt(torch.sum((res_pose[..., :2] - inits[..., :2]) ** 2, -1))
    ok = converged & (dev <= gate)
    return torch.where(ok[..., None], res_pose, inits), ok


def _window_cumsum(x):
    """Prefix sums along the last (window) axis. With leading axes each row
    is summed as a column of the ``[W, ...]`` transpose: PyTorch's scan
    over an outer dimension adds each column left to right, as its scan of
    one ``[W]`` row adds on the H100 at windows of up to 16 scans (serving's
    is 8), while its scan of many rows along the innermost dimension adds
    in a tree order, to other bits."""
    return torch.cumsum(x.movedim(-1, 0), 0).movedim(0, -1)


def chain_deltas(pose0, deltas):
    """Dead-reckoned poses ``[..., W, 3]``: pose_i = pose0 . delta_1 ...
    delta_i (the JAX package's closed form: two prefix sums), for
    ``pose0 [..., 3]`` and ``deltas [..., W, 3]``: one call for every
    session of a stacked window (the JAX package's ``jax.vmap``)."""
    th0 = pose0[..., 2:3]
    th = th0 + _window_cumsum(deltas[..., 2])
    th_prev = torch.cat([th0, th[..., :-1]], -1)
    c, s = torch.cos(th_prev), torch.sin(th_prev)
    dx = c * deltas[..., 0] - s * deltas[..., 1]
    dy = s * deltas[..., 0] + c * deltas[..., 1]
    x = pose0[..., 0:1] + _window_cumsum(dx)
    y = pose0[..., 1:2] + _window_cumsum(dy)
    return torch.stack([x, y, se2.wrap(th)], -1)


def kf_select(last_kf, poses, dist_thresh: float, angle_thresh: float):
    """Greedy keyframe selection over a window: walk the scans and spawn a
    keyframe whenever the distance or angle from the LAST spawned keyframe
    exceeds a threshold. Returns ``(is_kf [W] bool, last_out [3])``.

    Same result as the JAX package's transitive closure: ``next(i)`` is the
    first ``j > i`` that triggers from ``i``, and the keyframes are the
    orbit of the pre-window keyframe (node 0), followed here by ``W``
    pointer hops on the device.
    """
    w = poses.shape[0]
    dev = poses.device
    all_p = torch.cat([last_kf[None], poses], 0)                # [W+1, 3]
    d = all_p[None, :, :] - all_p[:, None, :]
    trig = ((torch.sqrt(d[..., 0] ** 2 + d[..., 1] ** 2) > dist_thresh)
            | (torch.abs(se2.wrap(d[..., 2])) > angle_thresh))
    jj = torch.arange(w + 1, device=dev)
    cand = trig & (jj[None, :] > jj[:, None])
    first = torch.argmax(cand.to(torch.int32), 1)
    nxt = torch.where(cand.any(1), first, torch.full_like(first, w + 1))
    nxt = torch.cat([nxt, torch.tensor([w + 1], device=dev)])   # sink loops
    visited = torch.zeros(w + 2, dtype=torch.bool, device=dev)
    cur = torch.zeros((), dtype=torch.long, device=dev)
    for _ in range(w):
        cur = nxt[cur]
        visited[cur] = True
    is_kf = visited[1: w + 1]
    idx = torch.arange(w, device=dev)
    last_i = torch.max(torch.where(is_kf, idx, torch.full_like(idx, -1)))
    last_out = torch.where(last_i >= 0, poses[torch.clamp(last_i, min=0)],
                           last_kf)
    return is_kf, last_out


def _pad_to_windows(points, mask, odom, window):
    """Pad a step sequence to whole windows with identity odometry and an
    all-false mask (the matcher exits in 0 iterations on padded steps)."""
    t = points.shape[0]
    n_win = -(-t // window)
    pad = n_win * window - t
    if pad:
        points = torch.cat([points, points.new_zeros((pad,) + points.shape[1:])])
        mask = torch.cat([mask, mask.new_zeros((pad,) + mask.shape[1:])])
        odom = torch.cat([odom, odom.new_zeros((pad, 3))])
    return points, mask, odom, n_win, pad


def run_odometry_windowed(points, mask, odom, grid: GridConfig,
                          ndt_cfg: NDTMapConfig, match_cfg: MatchConfig,
                          kf_cfg: KeyframeConfig, window: int = 16,
                          passes: int = 2, odom_gate: float = 1.0,
                          init_pose=None) -> OdometryResult:
    """Window-batched scan-to-map NDT odometry (config 1's front end)."""
    dt, dev = points.dtype, points.device
    t0 = (torch.zeros(3, dtype=dt, device=dev) if init_pose is None
          else init_pose.to(dt))
    stats = ndt_grid.add_points(ndt_grid.empty_stats(grid, dt, dev),
                                se2.transform(t0, points[0]), mask[0], grid)
    pts_w, msk_w, odo_w, n_win, _ = _pad_to_windows(points[1:], mask[1:],
                                                    odom[1:], window)
    w = window
    pts_w = pts_w.reshape(n_win, w, *pts_w.shape[1:])
    msk_w = msk_w.reshape(n_win, w, *msk_w.shape[1:])
    odo_w = odo_w.reshape(n_win, w, 3)

    def table_of(st):
        return ndt_grid.finalize_pack(st, ndt_cfg, grid,
                                      match_cfg.compact_table)

    def insert_kf(st, poses, is_kf, pts, msk):
        wpts = se2.transform(poses, pts)
        return ndt_grid.add_points(st, wpts.reshape(-1, 2),
                                   (msk & is_kf[:, None]).reshape(-1), grid)

    pose_last, last_kf0 = t0, t0
    outs = []
    for k in range(n_win):
        pts, msk, deltas = pts_w[k], msk_w[k], odo_w[k]
        inits = chain_deltas(pose_last, deltas)
        res = ndt_match.match_batch_packed(pts, msk, table_of(stats), inits,
                                           grid, match_cfg)
        poses, _ = gate_poses(res.pose, res.converged, inits, odom_gate)
        for _ in range(max(0, passes - 1)):
            kf_prev, _ = kf_select(last_kf0, poses, kf_cfg.dist_thresh,
                                   kf_cfg.angle_thresh)
            tmp = insert_kf(stats, poses, kf_prev, pts, msk)
            prev = torch.cat([pose_last[None], poses[:-1]], 0)
            inits2 = se2.compose(prev, deltas)
            res = ndt_match.match_batch_packed(pts, msk, table_of(tmp), inits2,
                                               grid, match_cfg)
            poses, _ = gate_poses(res.pose, res.converged, inits2, odom_gate)
        is_kf, last_kf0 = kf_select(last_kf0, poses, kf_cfg.dist_thresh,
                                    kf_cfg.angle_thresh)
        stats = insert_kf(stats, poses, is_kf, pts, msk)
        pose_last = poses[-1]
        outs.append((poses, res.score, res.n_iter, res.converged, is_kf))

    t_steps = points.shape[0] - 1
    cat = lambda i: torch.cat([o[i] for o in outs])[:t_steps]
    one_true = torch.ones(1, dtype=torch.bool, device=dev)
    return OdometryResult(
        poses=torch.cat([t0[None], cat(0)]),
        scores=torch.cat([torch.ones(1, dtype=dt, device=dev), cat(1)]),
        n_iters=torch.cat([torch.zeros(1, dtype=torch.int32, device=dev),
                           cat(2)]),
        converged=torch.cat([one_true, cat(3)]),
        is_keyframe=torch.cat([one_true, cat(4)]),
        stats=stats)
