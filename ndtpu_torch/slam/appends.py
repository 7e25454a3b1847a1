"""A window's masked appends: K14 ``window_append`` and its plain version.

Port of the masked scatters of ``ndtpu/slam/pipeline.py::_wb_appends``
(:361-475: the keyframe slots, anchors, node values, odometry factors and
their sqrt-information, and one ``.at[where(ok, slot, big)].set(v,
mode="drop")`` per graph and keyframe array), with ``_wb_extend``'s write of
``map_kf_poses`` (:556), the loop factors' append (:464-490) and
``_refresh_map``'s row write (:161). Every function takes ``S`` sessions
along a leading axis (the windowed pipeline passes ``S = 1``, stacked
serving its sessions) and returns new tensors, as JAX's scatters do: the
inputs are never written.

CUDA tensors go to K14 (``csrc/window_append.cu``: one launch for each of
:func:`window_append`, :func:`loop_append` and :func:`set_rows`), CPU
tensors to the plain versions (``*_ref``), which are sync-free too: each
write is one ``index_copy_`` into a copy of the array with a spare row,
where every dropped row lands.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ndtpu_torch import kernels
from ndtpu_torch.graph import factors as fct
from ndtpu_torch.lie import se2
from ndtpu_torch.slam import keyframes as kfs

__all__ = ["Appended", "append_window", "window_append", "window_append_ref",
           "loop_append", "loop_append_ref", "set_rows", "set_rows_ref"]


class Appended(NamedTuple):
    """:func:`append_window`'s result, every field with a leading session
    axis: the graph and keyframe store with the window's rows, the map's
    keyframe poses with the window's keyframes at their registration-time
    poses, and the window's aux."""
    graph: fct.PoseGraph
    kf: kfs.KeyframeStore     # tables passed through; not yet pose-synced
    map_kf_poses: torch.Tensor
    slot: torch.Tensor        # [S, W] graph slot of each scan (n_poses+cum-1)
    ok: torch.Tensor          # [S, W] keyframe kept (within pose capacity)
    cum: torch.Tensor         # [S, W] keyframes among scans 0..w
    kslot: torch.Tensor       # [S, W] keyframe store slot (kf.n+cum-1)
    node_vals: torch.Tensor   # [S, W, 3] each scan's node value
    last_idx: torch.Tensor    # [S] graph index of the newest keyframe
    lkr: torch.Tensor         # [S, 3] its registration-time pose
    any_kf: torch.Tensor      # [S] bool
    kf_idx_out: torch.Tensor  # [S, W] keyframe each scan hangs off
    rel_out: torch.Tensor     # [S, W, 3] scan pose relative to it
    nd_out: torch.Tensor      # [S, W] int32 keyframes / factors dropped


def _odom_info_sqrt(hessian):
    """Between-factor sqrt information from registration Hessians
    ``[..., 3, 3]``."""
    eye = torch.eye(3, dtype=hessian.dtype, device=hessian.device)
    h = 0.5 * (hessian + hessian.transpose(-1, -2)) + 1e-3 * eye
    return fct.info_to_sqrt_info(h)


def _put(arr, slots, keep, vals):
    """``arr [S, R, ...]`` with row ``slots[s, w]`` set to ``vals[s, w]``
    where ``keep`` (a new tensor; a dropped write lands in a spare row past
    the last session's and is cut off). ``vals`` a tensor ``[S, W, ...]`` or
    a Python scalar."""
    s, r = arr.shape[:2]
    tail = arr.shape[2:]
    flat = torch.cat([arr.reshape((s * r,) + tail),
                      arr.new_zeros((1,) + tail)])
    off = torch.arange(s, device=arr.device)[:, None] * r
    tgt = torch.where(keep & (slots >= 0) & (slots < r), slots + off,
                      torch.full_like(slots, s * r))
    if not isinstance(vals, torch.Tensor):
        vals = torch.full(tgt.shape + tail, vals, dtype=arr.dtype,
                          device=arr.device)
    flat.index_copy_(0, tgt.reshape(-1),
                     vals.to(arr.dtype).reshape((-1,) + tail))
    return flat[:s * r].reshape(arr.shape)


def _dense(tensors) -> list:
    """The kernel's arguments as contiguous tensors (no copy where they
    are)."""
    return [t.contiguous() for t in tensors]


def _rows(arr, idx):
    """``arr [S, R, ...]`` at rows ``idx [S, W]`` (clamped, as JAX's
    gather): ``[S, W, ...]``."""
    s = arr.shape[0]
    idx = torch.clamp(idx, 0, arr.shape[1] - 1)
    return arr[torch.arange(s, device=arr.device)[:, None], idx]


def window_append_ref(g_poses, pose_mask, bet_i, bet_j, bet_z, bet_sqrt_info,
                      bet_mask, n_poses, n_between, kf_poses, kf_points,
                      kf_masks, kf_live, kf_n, map_kf_poses, last_kf_idx,
                      last_kf_reg, poses, hessians, pts, msk,
                      is_kf) -> tuple:
    """The plain version of K14 (``kernels.window_append``, same arguments
    and results): JAX's ``_wb_appends`` scatters and ``_wb_extend``'s
    ``map_kf_poses`` write for each session, with no host sync."""
    s, w = is_kf.shape
    dev = is_kf.device
    cap_v, cap_f = g_poses.shape[1], bet_i.shape[1]
    cum = torch.cumsum(is_kf.to(torch.long), 1)                    # [S, W]
    slot = n_poses[:, None] + cum - 1
    ok = is_kf & (slot < cap_v)
    k_new = ok.sum(1)

    idx = torch.arange(w, device=dev).expand(s, w)
    gov = torch.cummax(torch.where(ok, idx, torch.full_like(idx, -1)),
                       1).values
    lkr3 = last_kf_reg[:, None, :]
    anchor_reg = torch.where((gov >= 0)[..., None], _rows(poses, gov), lkr3)
    prev_gov = torch.cat([torch.full((s, 1), -1, dtype=gov.dtype,
                                     device=dev), gov[:, :-1]], 1)
    parent_reg = torch.where((prev_gov >= 0)[..., None],
                             _rows(poses, prev_gov), lkr3)
    parent_idx = torch.where(cum > 1, n_poses[:, None] + cum - 2,
                             last_kf_idx[:, None])
    anchor_node = _rows(g_poses, last_kf_idx[:, None])             # [S, 1, 3]
    node_vals = se2.compose(anchor_node, se2.between(lkr3, poses))
    z_odo = se2.between(parent_reg, poses)
    sqrt_infos = _odom_info_sqrt(hessians)

    fslot = n_between[:, None] + cum - 1
    fok = ok & (fslot < cap_f)
    kslot = kf_n[:, None] + cum - 1
    cum_ok = torch.cumsum(ok.to(torch.long), 1)
    kf_idx_out = torch.where(cum_ok > 0, n_poses[:, None] + cum_ok - 1,
                             last_kf_idx[:, None])
    nd_out = ((is_kf & ~ok).to(torch.int32) + (ok & ~fok).to(torch.int32))
    return (_put(g_poses, slot, ok, node_vals),
            _put(pose_mask, slot, ok, True),
            _put(bet_i, fslot, fok, parent_idx),
            _put(bet_j, fslot, fok, slot),
            _put(bet_z, fslot, fok, z_odo),
            _put(bet_sqrt_info, fslot, fok, sqrt_infos),
            _put(bet_mask, fslot, fok, True),
            n_poses + k_new, n_between + fok.sum(1),
            _put(kf_poses, kslot, ok, node_vals),
            _put(kf_points, kslot, ok, pts),
            _put(kf_masks, kslot, ok, msk),
            _put(kf_live, kslot, ok, True),
            kf_n + k_new,
            _put(map_kf_poses, kslot, ok, poses),
            slot, ok, cum, kslot, node_vals,
            torch.where(k_new > 0, n_poses + k_new - 1, last_kf_idx),
            anchor_reg[:, -1], is_kf.any(1), kf_idx_out,
            se2.between(anchor_reg, poses), nd_out)


def window_append(*args) -> tuple:
    """K14 on CUDA tensors (one launch), :func:`window_append_ref` on CPU
    tensors; the arguments and results of ``kernels.window_append``."""
    if args[0].is_cuda:
        return kernels.window_append(*_dense(args))
    return window_append_ref(*args)


def append_window(graph: fct.PoseGraph, kf: kfs.KeyframeStore, map_kf_poses,
                  last_kf_idx, last_kf_reg, poses, hessians, pts, msk,
                  is_kf) -> Appended:
    """:func:`window_append` on the stacked state (every field with a
    leading session axis): the graph and keyframe arrays it writes come back
    new, its priors and ``kf.tables`` passed through."""
    out = window_append(
        graph.poses, graph.pose_mask, graph.bet_i, graph.bet_j, graph.bet_z,
        graph.bet_sqrt_info, graph.bet_mask, graph.n_poses, graph.n_between,
        kf.poses, kf.points, kf.masks, kf.live, kf.n, map_kf_poses,
        last_kf_idx, last_kf_reg, poses, hessians, pts, msk, is_kf)
    g = graph._replace(poses=out[0], pose_mask=out[1], bet_i=out[2],
                       bet_j=out[3], bet_z=out[4], bet_sqrt_info=out[5],
                       bet_mask=out[6], n_poses=out[7], n_between=out[8])
    k = kf._replace(poses=out[9], points=out[10], masks=out[11],
                    live=out[12], n=out[13])
    return Appended(g, k, *out[14:])


def loop_append_ref(bet_i, bet_j, bet_z, bet_sqrt_info, bet_mask, n_between,
                    accept, loop_j, loop_z, loop_sqrt_info, innov, slot_k,
                    sel, has, w: int) -> tuple:
    """The plain version of K14's loop entry (``kernels.loop_append``, same
    arguments and results)."""
    s, kq, c = accept.shape
    cap_f = bet_i.shape[1]
    acc = accept.reshape(s, kq * c)
    lslot = n_between[:, None] + torch.cumsum(acc.to(torch.long), 1) - 1
    lok = acc & (lslot < cap_f)
    iflat = slot_k[:, :, None].expand(s, kq, c).reshape(s, -1)

    def per_scan(flags):          # [S, K, C] -> count at each scan [S, W]
        n = torch.where(has, flags.sum(2), torch.zeros_like(sel))
        return torch.zeros((s, w), dtype=torch.int32,
                           device=accept.device).scatter_add_(
            1, sel, n.to(torch.int32))

    return (_put(bet_i, lslot, lok, loop_j.reshape(s, -1)),
            _put(bet_j, lslot, lok, iflat),
            _put(bet_z, lslot, lok, loop_z.reshape(s, -1, 3)),
            _put(bet_sqrt_info, lslot, lok,
                 loop_sqrt_info.reshape(s, -1, 3, 3)),
            _put(bet_mask, lslot, lok, True),
            n_between + lok.sum(1),
            per_scan(lok.reshape(s, kq, c)),
            per_scan((acc & ~lok).reshape(s, kq, c)),
            per_scan(innov))


def loop_append(*args) -> tuple:
    """K14's loop entry on CUDA tensors (one launch), :func:`loop_append_ref`
    on CPU tensors; the arguments and results of ``kernels.loop_append``."""
    if args[0].is_cuda:
        return kernels.loop_append(*_dense(args[:-1]), args[-1])
    return loop_append_ref(*args)


def set_rows_ref(dst, idx, ok, src) -> torch.Tensor:
    """The plain version of K14's row entry (``kernels.rows_set``): a new
    ``[S, R, C]`` tensor, ``dst`` with row ``idx[s, m]`` set to ``src[s, m]``
    where ``ok[s, m]``; an index outside ``[0, R)`` writes nothing."""
    return _put(dst, idx, ok, src)


def set_rows(dst, idx, ok, src) -> torch.Tensor:
    """``dst.at[where(ok, idx, big)].set(src, mode="drop")`` per session
    (``dst [S, R, C]``, ``idx`` / ``ok [S, M]``, ``src [S, M, C]``): K14's row
    entry on CUDA tensors (one launch), :func:`set_rows_ref` on CPU
    tensors."""
    if dst.is_cuda:
        return kernels.rows_set(*_dense((dst, idx, ok, src)))
    return set_rows_ref(dst, idx, ok, src)
