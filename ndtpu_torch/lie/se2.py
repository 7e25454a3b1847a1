"""SE(2) Lie-group operations on ``[..., 3]`` pose tensors.

Port of ``ndtpu/lie/se2.py`` (same conventions, same op order): a pose is
``[x, y, theta]``, ``R(theta) = [[c, -s], [s, c]]``, ``compose(a, b)``
applies ``b`` in ``a``'s frame, tangent vectors are ``[vx, vy, omega]``, and
``wrap`` maps angles to ``(-pi, pi]``. Every function is vectorized over
leading axes and follows its input's dtype and device.
"""

from __future__ import annotations

import math

import torch

__all__ = ["wrap", "rotmat", "compose", "inverse", "between", "transform",
           "transform_inv", "expmap", "logmap", "adjoint", "retract"]


def wrap(theta):
    """Wrap angles to the interval (-pi, pi]. Shape-preserving."""
    return theta - 2.0 * math.pi * torch.floor(
        (theta + math.pi) / (2.0 * math.pi))


def rotmat(theta):
    """Rotation matrices ``[..., 2, 2]`` for angles ``[...]``."""
    c, s = torch.cos(theta), torch.sin(theta)
    return torch.stack([torch.stack([c, -s], -1), torch.stack([s, c], -1)],
                       -2)


def compose(a, b):
    """Pose composition ``a * b`` for ``[..., 3]`` pose tensors."""
    ca, sa = torch.cos(a[..., 2]), torch.sin(a[..., 2])
    x = a[..., 0] + ca * b[..., 0] - sa * b[..., 1]
    y = a[..., 1] + sa * b[..., 0] + ca * b[..., 1]
    return torch.stack([x, y, wrap(a[..., 2] + b[..., 2])], -1)


def inverse(a):
    """Pose inverse for ``[..., 3]`` pose tensors."""
    ca, sa = torch.cos(a[..., 2]), torch.sin(a[..., 2])
    x = -(ca * a[..., 0] + sa * a[..., 1])
    y = -(-sa * a[..., 0] + ca * a[..., 1])
    return torch.stack([x, y, wrap(-a[..., 2])], -1)


def between(a, b):
    """Relative pose ``a^{-1} * b``."""
    ca, sa = torch.cos(a[..., 2]), torch.sin(a[..., 2])
    dx = b[..., 0] - a[..., 0]
    dy = b[..., 1] - a[..., 1]
    x = ca * dx + sa * dy
    y = -sa * dx + ca * dy
    return torch.stack([x, y, wrap(b[..., 2] - a[..., 2])], -1)


def transform(pose, points):
    """Local points ``[..., N, 2]`` to the world frame: ``R(theta) p + t``."""
    c = torch.cos(pose[..., 2])[..., None]
    s = torch.sin(pose[..., 2])[..., None]
    px, py = points[..., 0], points[..., 1]
    x = c * px - s * py + pose[..., 0][..., None]
    y = s * px + c * py + pose[..., 1][..., None]
    return torch.stack([x, y], -1)


def transform_inv(pose, points):
    """World points into the pose's local frame."""
    c = torch.cos(pose[..., 2])[..., None]
    s = torch.sin(pose[..., 2])[..., None]
    dx = points[..., 0] - pose[..., 0][..., None]
    dy = points[..., 1] - pose[..., 1][..., None]
    return torch.stack([c * dx + s * dy, -s * dx + c * dy], -1)


def _sinc(x):
    """sin(x)/x, safe at 0 (series to O(x^4))."""
    small = torch.abs(x) < 1e-4
    xs = torch.where(small, torch.ones_like(x), x)
    return torch.where(small, 1.0 - x * x / 6.0, torch.sin(xs) / xs)


def _cosc(x):
    """(1 - cos(x))/x, safe at 0."""
    small = torch.abs(x) < 1e-4
    xs = torch.where(small, torch.ones_like(x), x)
    return torch.where(small, x / 2.0 - x ** 3 / 24.0,
                       (1.0 - torch.cos(xs)) / xs)


def expmap(xi):
    """SE(2) exponential map: twist ``[..., 3]`` -> pose."""
    v1, v2, w = xi[..., 0], xi[..., 1], xi[..., 2]
    sc, cc = _sinc(w), _cosc(w)
    return torch.stack([sc * v1 - cc * v2, cc * v1 + sc * v2, wrap(w)], -1)


def logmap(pose):
    """SE(2) logarithm map: pose -> twist ``[..., 3]``."""
    x, y, w = pose[..., 0], pose[..., 1], wrap(pose[..., 2])
    sc, cc = _sinc(w), _cosc(w)
    den = sc * sc + cc * cc
    v1 = (sc * x + cc * y) / den
    v2 = (-cc * x + sc * y) / den
    return torch.stack([v1, v2, w], -1)


def adjoint(pose):
    """Adjoint matrices ``[..., 3, 3]``."""
    c, s = torch.cos(pose[..., 2]), torch.sin(pose[..., 2])
    x, y = pose[..., 0], pose[..., 1]
    z, o = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack([torch.stack([c, -s, y], -1),
                        torch.stack([s, c, -x], -1),
                        torch.stack([z, z, o], -1)], -2)


def retract(pose, delta):
    """Manifold update ``pose * exp(delta)``."""
    return compose(pose, expmap(delta))
