"""Pose-graph factors as structure-of-arrays tensors.

Port of ``ndtpu/graph/factors.py``: fixed-capacity SoA arrays ``(i, j, z,
sqrt_info, mask)`` for priors and between factors, masked appends, the
between error ``e = [R_i^T (t_j - t_i) - t_z ; wrap(th_j - th_i - th_z)]``
with analytic Jacobians, robust (IRLS) weights, and batched linearization
(K5 ``csrc/factor_linearize.cu`` on the card, :func:`factor_linearize_ref`
on the CPU). Index fields are int64 (torch's index type);
``ndtpu_torch.convert`` maps them to and from the JAX package's int32.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ndtpu_torch import kernels
from ndtpu_torch.lie import se2

__all__ = ["PoseGraph", "empty_graph", "add_pose", "add_prior",
           "add_between", "prior_error", "between_error", "linearize",
           "chi2", "info_to_sqrt_info", "robust_weight", "factor_linearize",
           "factor_linearize_ref"]


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
    """``arr[slot] = value`` only when ``ok`` (a new tensor). ``slot`` is a
    0-d tensor, used as a one-element index: indexing with a 0-d tensor
    would read it back to the host."""
    idx = slot.reshape(1)
    cur = arr.index_select(0, idx)
    return arr.index_copy(0, idx, torch.where(
        ok, torch.as_tensor(value, dtype=arr.dtype, device=arr.device), cur))


def _set_flag(mask, slot, ok):
    idx = slot.reshape(1)
    return mask.index_copy(0, idx, ok | mask.index_select(0, idx))


def _append_ok(count, cap: int, enabled):
    """``enabled & (count < cap)``; a Python ``enabled`` is never copied to
    the device (a copy from the host waits for the card)."""
    ok = count < cap
    if isinstance(enabled, bool):
        return ok if enabled else torch.zeros_like(ok)
    return ok & enabled


def add_pose(g: PoseGraph, pose, enabled=True) -> PoseGraph:
    """Masked append of a pose variable (index = the pre-append n_poses)."""
    slot = torch.clamp(g.n_poses, max=g.capacity - 1)
    ok = _append_ok(g.n_poses, g.capacity, enabled)
    return g._replace(poses=_masked_set(g.poses, slot, pose, ok),
                      pose_mask=_set_flag(g.pose_mask, slot, ok),
                      n_poses=g.n_poses + ok.to(torch.long))


def add_prior(g: PoseGraph, idx, z, sqrt_info, enabled=True) -> PoseGraph:
    cap = g.prior_mask.shape[0]
    slot = torch.clamp(g.n_priors, max=cap - 1)
    ok = _append_ok(g.n_priors, cap, enabled)
    return g._replace(
        prior_idx=_masked_set(g.prior_idx, slot, idx, ok),
        prior_z=_masked_set(g.prior_z, slot, z, ok),
        prior_sqrt_info=_masked_set(g.prior_sqrt_info, slot, sqrt_info, ok),
        prior_mask=_set_flag(g.prior_mask, slot, ok),
        n_priors=g.n_priors + ok.to(torch.long))


def add_between(g: PoseGraph, i, j, z, sqrt_info, enabled=True) -> PoseGraph:
    cap = g.bet_mask.shape[0]
    slot = torch.clamp(g.n_between, max=cap - 1)
    ok = _append_ok(g.n_between, cap, enabled)
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


def factor_linearize_ref(poses, bet_i, bet_j, bet_z, bet_sqrt_info,
                         row_mask, prior_idx, prior_z, prior_sqrt_info,
                         prior_mask, huber_delta: float = 0.0,
                         robust: str = "huber", fid=None):
    """The plain version of K5 (CPU path and oracle): whitened Jacobian
    blocks and residuals of every between slot (or of the gathered slots
    ``fid``, rows masked by ``row_mask``) and of the priors (masked by
    ``prior_mask``): ``((Ai, Aj, r), (Ap, rp))``, dead rows zero."""
    if fid is not None:
        bet_i, bet_j = bet_i[fid], bet_j[fid]
        bet_z, bet_sqrt_info = bet_z[fid], bet_sqrt_info[fid]
    pi, pj = poses[bet_i], poses[bet_j]
    e = between_error(pi, pj, bet_z)
    ji, jj = _between_jacobians(pi, pj)
    sqi = bet_sqrt_info
    ai, aj, r = sqi @ ji, sqi @ jj, _mv(sqi, e)
    if huber_delta > 0.0:
        w = robust_weight(torch.linalg.norm(r, dim=-1), huber_delta, robust)
        ai, aj, r = ai * w[:, None, None], aj * w[:, None, None], r * w[:, None]
    m = row_mask.to(r.dtype)
    ai, aj, r = ai * m[:, None, None], aj * m[:, None, None], r * m[:, None]
    ap = prior_sqrt_info
    rp = _mv(ap, prior_error(poses[prior_idx], prior_z))
    mp = prior_mask.to(rp.dtype)
    return (ai, aj, r), (ap * mp[:, None, None], rp * mp[:, None])


def factor_linearize(poses, bet_i, bet_j, bet_z, bet_sqrt_info, row_mask,
                     prior_idx, prior_z, prior_sqrt_info, prior_mask,
                     huber_delta: float = 0.0, robust: str = "huber",
                     fid=None, chi_only: bool = False):
    """K5 wrapper: CUDA tensors go to the kernel (f32, every ``robust``
    kind of :func:`robust_weight`), CPU tensors to
    :func:`factor_linearize_ref`. Returns ``((Ai, Aj, r), (Ap, rp))``, or
    with ``chi_only`` the total weighted squared error ``[]``."""
    if not poses.is_cuda:
        lin = factor_linearize_ref(poses, bet_i, bet_j, bet_z, bet_sqrt_info,
                                   row_mask, prior_idx, prior_z,
                                   prior_sqrt_info, prior_mask, huber_delta,
                                   robust, fid)
        if not chi_only:
            return lin
        (_, _, r), (_, rp) = lin
        return torch.sum(r * r) + torch.sum(rp * rp)
    return kernels.factor_linearize(
        poses, bet_i, bet_j, bet_z, bet_sqrt_info, row_mask, prior_idx,
        prior_z, prior_sqrt_info, prior_mask, huber_delta, fid=fid,
        chi_only=chi_only, robust=robust)


def _graph_args(g: PoseGraph):
    return (g.poses, g.bet_i, g.bet_j, g.bet_z, g.bet_sqrt_info, g.bet_mask,
            g.prior_idx, g.prior_z, g.prior_sqrt_info, g.prior_mask)


def linearize(g: PoseGraph, huber_delta: float = 0.0, robust: str = "huber"):
    """Whitened Jacobian blocks and residuals of every factor:
    ``((Ai [F,3,3], Aj [F,3,3], r [F,3]), (Ap [P,3,3], rp [P,3]))``, dead
    rows zero; the linear system is ``min || A delta + r ||^2``. K5 on the
    card (:func:`factor_linearize`)."""
    return factor_linearize(*_graph_args(g), huber_delta, robust)


def chi2(g: PoseGraph, huber_delta: float = 0.0, robust: str = "huber"):
    """Total weighted squared error (K5's chi^2-only mode on the card)."""
    return factor_linearize(*_graph_args(g), huber_delta, robust,
                            chi_only=True)
