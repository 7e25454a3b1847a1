"""Pose-graph factors as structure-of-arrays tensors.

Port of ``ndtpu/graph/factors.py``: fixed-capacity SoA arrays ``(i, j, z,
sqrt_info, mask)`` for priors and between factors, masked appends, the
between error ``e = [R_i^T (t_j - t_i) - t_z ; wrap(th_j - th_i - th_z)]``
with analytic Jacobians, robust (IRLS) weights, and batched linearization.
Index fields are int64 (torch's index type); ``ndtpu_torch.convert`` maps
them to and from the JAX package's int32.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ndtpu_torch.lie import se2

__all__ = ["PoseGraph", "empty_graph", "add_pose", "add_prior",
           "add_between", "prior_error", "between_error", "linearize",
           "chi2", "info_to_sqrt_info", "robust_weight"]


class PoseGraph(NamedTuple):
    poses: torch.Tensor            # [V, 3]
    pose_mask: torch.Tensor        # [V] bool
    prior_idx: torch.Tensor        # [P] int64
    prior_z: torch.Tensor          # [P, 3]
    prior_sqrt_info: torch.Tensor  # [P, 3, 3]
    prior_mask: torch.Tensor       # [P] bool
    bet_i: torch.Tensor            # [F] int64
    bet_j: torch.Tensor            # [F] int64
    bet_z: torch.Tensor            # [F, 3]
    bet_sqrt_info: torch.Tensor    # [F, 3, 3]
    bet_mask: torch.Tensor         # [F] bool
    n_poses: torch.Tensor          # [] int64
    n_priors: torch.Tensor         # [] int64
    n_between: torch.Tensor        # [] int64

    @property
    def capacity(self):
        return self.poses.shape[0]


def empty_graph(max_poses: int, max_priors: int, max_between: int,
                dtype=torch.float32, device="cpu") -> PoseGraph:
    f = dict(dtype=dtype, device=device)
    i = dict(dtype=torch.long, device=device)
    b = dict(dtype=torch.bool, device=device)
    return PoseGraph(
        poses=torch.zeros((max_poses, 3), **f),
        pose_mask=torch.zeros((max_poses,), **b),
        prior_idx=torch.zeros((max_priors,), **i),
        prior_z=torch.zeros((max_priors, 3), **f),
        prior_sqrt_info=torch.zeros((max_priors, 3, 3), **f),
        prior_mask=torch.zeros((max_priors,), **b),
        bet_i=torch.zeros((max_between,), **i),
        bet_j=torch.zeros((max_between,), **i),
        bet_z=torch.zeros((max_between, 3), **f),
        bet_sqrt_info=torch.zeros((max_between, 3, 3), **f),
        bet_mask=torch.zeros((max_between,), **b),
        n_poses=torch.zeros((), **i), n_priors=torch.zeros((), **i),
        n_between=torch.zeros((), **i))


def _masked_set(arr, slot, value, ok):
    """``arr[slot] = value`` only when ``ok`` (a new tensor)."""
    out = arr.clone()
    out[slot] = torch.where(ok, torch.as_tensor(value, dtype=arr.dtype,
                                                device=arr.device), arr[slot])
    return out


def _set_flag(mask, slot, ok):
    out = mask.clone()
    out[slot] = ok | mask[slot]
    return out


def add_pose(g: PoseGraph, pose, enabled=True) -> PoseGraph:
    """Masked append of a pose variable (index = the pre-append n_poses)."""
    slot = torch.clamp(g.n_poses, max=g.capacity - 1)
    ok = torch.as_tensor(enabled, device=g.n_poses.device) & (
        g.n_poses < g.capacity)
    return g._replace(poses=_masked_set(g.poses, slot, pose, ok),
                      pose_mask=_set_flag(g.pose_mask, slot, ok),
                      n_poses=g.n_poses + ok.to(torch.long))


def add_prior(g: PoseGraph, idx, z, sqrt_info, enabled=True) -> PoseGraph:
    cap = g.prior_mask.shape[0]
    slot = torch.clamp(g.n_priors, max=cap - 1)
    ok = torch.as_tensor(enabled, device=g.n_priors.device) & (
        g.n_priors < cap)
    return g._replace(
        prior_idx=_masked_set(g.prior_idx, slot, idx, ok),
        prior_z=_masked_set(g.prior_z, slot, z, ok),
        prior_sqrt_info=_masked_set(g.prior_sqrt_info, slot, sqrt_info, ok),
        prior_mask=_set_flag(g.prior_mask, slot, ok),
        n_priors=g.n_priors + ok.to(torch.long))


def add_between(g: PoseGraph, i, j, z, sqrt_info, enabled=True) -> PoseGraph:
    cap = g.bet_mask.shape[0]
    slot = torch.clamp(g.n_between, max=cap - 1)
    ok = torch.as_tensor(enabled, device=g.n_between.device) & (
        g.n_between < cap)
    return g._replace(
        bet_i=_masked_set(g.bet_i, slot, i, ok),
        bet_j=_masked_set(g.bet_j, slot, j, ok),
        bet_z=_masked_set(g.bet_z, slot, z, ok),
        bet_sqrt_info=_masked_set(g.bet_sqrt_info, slot, sqrt_info, ok),
        bet_mask=_set_flag(g.bet_mask, slot, ok),
        n_between=g.n_between + ok.to(torch.long))


def info_to_sqrt_info(info):
    """Upper-triangular ``R`` with ``R^T R = info`` (closed-form 3x3
    Cholesky, batched; ``info`` must be SPD)."""
    a = info
    l11 = torch.sqrt(torch.clamp(a[..., 0, 0], min=1e-12))
    l21 = a[..., 1, 0] / l11
    l31 = a[..., 2, 0] / l11
    l22 = torch.sqrt(torch.clamp(a[..., 1, 1] - l21 * l21, min=1e-12))
    l32 = (a[..., 2, 1] - l31 * l21) / l22
    l33 = torch.sqrt(torch.clamp(a[..., 2, 2] - l31 * l31 - l32 * l32,
                                 min=1e-12))
    z = torch.zeros_like(l11)
    return torch.stack([torch.stack([l11, l21, l31], -1),
                        torch.stack([z, l22, l32], -1),
                        torch.stack([z, z, l33], -1)], -2)


def prior_error(pose, z):
    """Unwhitened prior error ``[..., 3]``."""
    return torch.cat([pose[..., :2] - z[..., :2],
                      se2.wrap(pose[..., 2:3] - z[..., 2:3])], -1)


def between_error(pose_i, pose_j, z):
    """Unwhitened between error ``[..., 3]`` (batched over leading axes)."""
    c, s = torch.cos(pose_i[..., 2]), torch.sin(pose_i[..., 2])
    dx = pose_j[..., 0] - pose_i[..., 0]
    dy = pose_j[..., 1] - pose_i[..., 1]
    et = torch.stack([c * dx + s * dy - z[..., 0],
                      -s * dx + c * dy - z[..., 1]], -1)
    eth = se2.wrap(pose_j[..., 2:3] - pose_i[..., 2:3] - z[..., 2:3])
    return torch.cat([et, eth], -1)


def _between_jacobians(pose_i, pose_j):
    """Analytic ``(de/dxi [..., 3, 3], de/dxj [..., 3, 3])``."""
    c, s = torch.cos(pose_i[..., 2]), torch.sin(pose_i[..., 2])
    dx = pose_j[..., 0] - pose_i[..., 0]
    dy = pose_j[..., 1] - pose_i[..., 1]
    dth_x = -s * dx + c * dy
    dth_y = -c * dx - s * dy
    z, o = torch.zeros_like(c), torch.ones_like(c)
    ji = torch.stack([torch.stack([-c, -s, dth_x], -1),
                      torch.stack([s, -c, dth_y], -1),
                      torch.stack([z, z, -o], -1)], -2)
    jj = torch.stack([torch.stack([c, s, z], -1),
                      torch.stack([-s, c, z], -1),
                      torch.stack([z, z, o], -1)], -2)
    return ji, jj


def robust_weight(r_norm, delta, kind: str = "huber"):
    """IRLS sqrt-weights of the standard robust kernels."""
    r = torch.clamp(r_norm, min=1e-12)
    if kind == "huber":
        return torch.where(r <= delta, torch.ones_like(r),
                           torch.sqrt(delta / r))
    if kind == "cauchy":
        return 1.0 / torch.sqrt(1.0 + (r / delta) ** 2)
    if kind == "tukey":
        u = torch.clamp(r / delta, max=1.0)
        return 1.0 - u * u
    if kind == "geman":
        return delta / (delta + r * r)
    raise ValueError(f"unknown robust kernel {kind!r}")


def _mv(m, v):
    """Batched ``m @ v`` for ``[..., 3, 3] x [..., 3]``."""
    return (m * v[..., None, :]).sum(-1)


def linearize(g: PoseGraph, huber_delta: float = 0.0, robust: str = "huber"):
    """Whitened Jacobian blocks and residuals of every factor:
    ``((Ai [F,3,3], Aj [F,3,3], r [F,3]), (Ap [P,3,3], rp [P,3]))``, dead
    rows zero; the linear system is ``min || A delta + r ||^2``."""
    pi, pj = g.poses[g.bet_i], g.poses[g.bet_j]
    e = between_error(pi, pj, g.bet_z)
    ji, jj = _between_jacobians(pi, pj)
    sqi = g.bet_sqrt_info
    ai, aj, r = sqi @ ji, sqi @ jj, _mv(sqi, e)
    if huber_delta > 0.0:
        w = robust_weight(torch.linalg.norm(r, dim=-1), huber_delta, robust)
        ai, aj, r = ai * w[:, None, None], aj * w[:, None, None], r * w[:, None]
    m = g.bet_mask.to(r.dtype)
    ai, aj, r = ai * m[:, None, None], aj * m[:, None, None], r * m[:, None]
    ap = g.prior_sqrt_info
    rp = _mv(ap, prior_error(g.poses[g.prior_idx], g.prior_z))
    mp = g.prior_mask.to(rp.dtype)
    return (ai, aj, r), (ap * mp[:, None, None], rp * mp[:, None])


def chi2(g: PoseGraph, huber_delta: float = 0.0, robust: str = "huber"):
    """Total weighted squared error."""
    (_, _, r), (_, rp) = linearize(g, huber_delta, robust)
    return torch.sum(r * r) + torch.sum(rp * rp)
