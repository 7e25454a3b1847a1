"""Synthetic 2D lidar worlds, trajectories, and scan simulation.

Port of ``ndtpu/data/synth.py``. Worlds and trajectories are built exactly
as the JAX package builds them (same numpy code, same f32 cast), and the
raycast is the same broadcasted ray/segment intersection over
``[..., N, S]``. The one deliberate difference is the noise: the JAX
package draws it with ``jax.random``; here it comes from
``np.random.default_rng(seed)``, in this order: range noise ``[T, N]``, then
odometry translation noise ``[T-1, 2]``, then rotation noise ``[T-1, 1]``.

:func:`make_sequence` simulates in f64 on the CPU and casts to the pose
dtype at the end, so a seed gives the same arrays on any machine; the
result is then moved to ``device``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ndtpu_torch.lie import se2

__all__ = ["World", "box_world", "corridor_loop_world",
           "rectangle_trajectory", "raycast", "simulate_scans",
           "noisy_odometry", "polar_to_xy", "beam_angles", "Sequence2D",
           "make_sequence"]


class World(NamedTuple):
    """Line-segment world: segments ``[S, 2, 2]`` as (start, end) points."""

    segments: torch.Tensor


def _rect(x0, y0, x1, y1):
    return [[[x0, y0], [x1, y0]], [[x1, y0], [x1, y1]],
            [[x1, y1], [x0, y1]], [[x0, y1], [x0, y0]]]


def box_world(half: float = 12.0, device="cpu") -> World:
    """Rectangular room with interior obstacles (f32, as in the JAX package)."""
    segs = _rect(-half, -half, half, half)
    segs += _rect(-half * 0.5, -half * 0.4, -half * 0.2, half * 0.1)
    segs += _rect(half * 0.25, -half * 0.6, half * 0.55, -half * 0.25)
    segs += _rect(half * 0.2, half * 0.35, half * 0.7, half * 0.6)
    segs += [[[-half * 0.7, half * 0.5], [-half * 0.3, half * 0.8]]]
    return World(torch.as_tensor(np.asarray(segs, np.float32), device=device))


def corridor_loop_world(outer: float = 20.0, width: float = 4.0,
                        device="cpu") -> World:
    """Square ring corridor with wall notches (the CLI's synthetic world)."""
    inner = outer - width
    segs = _rect(-outer, -outer, outer, outer)
    segs += _rect(-inner, -inner, inner, inner)
    rng = np.random.default_rng(7)
    for k in range(-3, 4):
        x = k * outer / 3.5 + rng.uniform(-0.5, 0.5)
        d = 0.6
        segs += [[[x, -outer], [x, -outer + d]],
                 [[x + 0.8, outer], [x + 0.8, outer - d]],
                 [[-outer, x], [-outer + d, x]],
                 [[outer, x + 0.8], [outer - d, x + 0.8]]]
    return World(torch.as_tensor(np.asarray(segs, np.float32), device=device))


def rectangle_trajectory(n_steps: int, half: float, step: float = 0.25,
                         dtype=torch.float32, device="cpu") -> torch.Tensor:
    """Poses ``[T, 3]`` driving a rounded rectangle CCW, heading tangent."""
    perim = 8.0 * half
    t = np.arange(n_steps) * step
    u = (t % perim) / perim * 4.0
    xs, ys, hs = [], [], []
    for ui in u:
        side, frac = int(ui), ui - int(ui)
        if side == 0:
            x, y, h = -half + 2 * half * frac, -half, 0.0
        elif side == 1:
            x, y, h = half, -half + 2 * half * frac, np.pi / 2
        elif side == 2:
            x, y, h = half - 2 * half * frac, half, np.pi
        else:
            x, y, h = -half, half - 2 * half * frac, -np.pi / 2
        xs.append(x), ys.append(y), hs.append(h)
    poses = np.stack([xs, ys, np.unwrap(hs)], axis=-1)
    k = 5
    pad = np.pad(poses[:, 2], (k // 2, k // 2), mode="edge")
    poses[:, 2] = np.convolve(pad, np.ones(k) / k, mode="valid")[:n_steps]
    poses[:, 2] = (poses[:, 2] + np.pi) % (2 * np.pi) - np.pi
    return torch.as_tensor(poses, dtype=dtype, device=device)


def beam_angles(n_beams: int, fov: float = 2.0 * np.pi, dtype=torch.float32,
                device="cpu") -> torch.Tensor:
    """Evenly spaced beam angles ``[N]`` in the sensor frame."""
    a = np.linspace(-fov / 2, fov / 2, n_beams, endpoint=False)
    return torch.as_tensor(a, dtype=dtype, device=device)


def raycast(world: World, poses, angles, max_range: float, eps: float = 1e-9):
    """Ranges ``[..., N]`` of beams from ``poses [..., 3]`` at ``angles [N]``."""
    a = world.segments[:, 0]                                  # [S, 2]
    ab = world.segments[:, 1] - a                             # [S, 2]
    th = poses[..., 2:3] + angles                             # [..., N]
    d = torch.stack([torch.cos(th), torch.sin(th)], -1)       # [..., N, 2]
    orig = poses[..., None, None, :2]                         # [..., 1, 1, 2]
    ao = a - orig                                             # [..., 1, S, 2]
    dn = d[..., :, None, :]                                   # [..., N, 1, 2]
    denom = dn[..., 0] * ab[..., 1] - dn[..., 1] * ab[..., 0]   # [..., N, S]
    denom_safe = torch.where(torch.abs(denom) < eps,
                             torch.ones_like(denom), denom)
    t = (ao[..., 0] * ab[..., 1] - ao[..., 1] * ab[..., 0]) / denom_safe
    u = (ao[..., 0] * dn[..., 1] - ao[..., 1] * dn[..., 0]) / denom_safe
    hit = (torch.abs(denom) >= eps) & (t > 1e-4) & (u >= 0.0) & (u <= 1.0)
    t = torch.where(hit, t, torch.full_like(t, max_range))
    return torch.amin(t, dim=-1)


def simulate_scans(world: World, poses, angles, max_range: float,
                   noise_std: float, rng: np.random.Generator):
    """Noisy range scans ``[T, N]`` along a trajectory ``[T, 3]``."""
    ranges = raycast(world, poses, angles, max_range)
    noise = torch.as_tensor(rng.standard_normal(tuple(ranges.shape)),
                            dtype=ranges.dtype, device=ranges.device)
    return torch.where(ranges < max_range,
                       torch.clamp(ranges + noise_std * noise, min=0.0),
                       torch.full_like(ranges, max_range))


def noisy_odometry(poses, rng: np.random.Generator, trans_std: float = 0.02,
                   rot_std: float = 0.005):
    """Relative odometry deltas ``[T, 3]`` with per-step noise; deltas[0] = 0."""
    rel = se2.between(poses[:-1], poses[1:])
    kw = dict(dtype=rel.dtype, device=rel.device)
    noise_t = torch.as_tensor(rng.standard_normal((rel.shape[0], 2)), **kw)
    noise_r = torch.as_tensor(rng.standard_normal((rel.shape[0], 1)), **kw)
    noisy = torch.cat([rel[:, :2] + trans_std * noise_t,
                       se2.wrap(rel[:, 2:] + rot_std * noise_r)], -1)
    return torch.cat([torch.zeros((1, 3), **kw), noisy], 0)


def polar_to_xy(ranges, angles, min_range: float, max_range: float):
    """Polar -> Cartesian points ``[..., N, 2]`` and validity mask ``[..., N]``."""
    x = ranges * torch.cos(angles)
    y = ranges * torch.sin(angles)
    mask = (ranges > min_range) & (ranges < 0.999 * max_range)
    return torch.stack([x, y], -1), mask


class Sequence2D(NamedTuple):
    points: torch.Tensor    # [T, N, 2] sensor-frame points
    mask: torch.Tensor      # [T, N] bool
    odom: torch.Tensor      # [T, 3] noisy relative odometry (odom[0] = 0)
    gt_poses: torch.Tensor  # [T, 3] ground-truth trajectory
    angles: torch.Tensor    # [N]


def make_sequence(world: World, poses, n_beams: int, max_range: float,
                  min_range: float, seed: int = 0, range_noise: float = 0.01,
                  odom_trans_std: float = 0.02, odom_rot_std: float = 0.005,
                  device="cpu") -> Sequence2D:
    """Simulate scans + noisy odometry + ground truth from ``seed``."""
    rng = np.random.default_rng(seed)
    dt = poses.dtype
    w64 = World(world.segments.detach().to("cpu", torch.float64))
    p64 = poses.detach().to("cpu", torch.float64)
    ang = beam_angles(n_beams, dtype=torch.float64)
    ranges = simulate_scans(w64, p64, ang, max_range, range_noise, rng)
    points, mask = polar_to_xy(ranges, ang, min_range, max_range)
    odom = noisy_odometry(p64, rng, odom_trans_std, odom_rot_std)
    to = lambda a: a.to(device=device, dtype=dt)
    return Sequence2D(points=to(points), mask=mask.to(device), odom=to(odom),
                      gt_poses=poses.to(device), angles=to(ang))
