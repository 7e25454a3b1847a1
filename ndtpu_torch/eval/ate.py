"""Trajectory evaluation: ATE (Umeyama-aligned RMSE) and RPE.

Port of ``ndtpu/eval/ate.py``.
"""

from __future__ import annotations

import torch

from ndtpu_torch.lie import se2

__all__ = ["align_se2", "ate_rmse", "rpe"]


def _rot(theta, dtype):
    c, s = torch.cos(theta), torch.sin(theta)
    return torch.stack([torch.stack([c, -s]), torch.stack([s, c])]).to(dtype)


def align_se2(est_xy, gt_xy):
    """Closed-form 2D Umeyama: rotation + translation minimizing
    ``sum ||gt - (R est + t)||^2``. Returns ``(theta, t [2])``."""
    em = est_xy.mean(0)
    gm = gt_xy.mean(0)
    e = est_xy - em
    g = gt_xy - gm
    dot = torch.sum(e * g)
    cross = torch.sum(e[:, 0] * g[:, 1] - e[:, 1] * g[:, 0])
    theta = torch.atan2(cross, dot)
    t = gm - _rot(theta, est_xy.dtype) @ em
    return theta, t


def ate_rmse(est_poses, gt_poses, align: bool = True):
    """Absolute trajectory error (RMSE of positions, meters)."""
    e, g = est_poses[:, :2], gt_poses[:, :2]
    if align:
        theta, t = align_se2(e, g)
        e = e @ _rot(theta, e.dtype).T + t
    return torch.sqrt(torch.mean(torch.sum((e - g) ** 2, -1)))


def rpe(est_poses, gt_poses, delta: int = 1):
    """Relative pose error over a step of ``delta`` frames:
    ``(trans_rmse, rot_rmse)``."""
    e_rel = se2.between(est_poses[:-delta], est_poses[delta:])
    g_rel = se2.between(gt_poses[:-delta], gt_poses[delta:])
    err = se2.between(g_rel, e_rel)
    t_rmse = torch.sqrt(torch.mean(torch.sum(err[:, :2] ** 2, -1)))
    r_rmse = torch.sqrt(torch.mean(err[:, 2] ** 2))
    return t_rmse, r_rmse
