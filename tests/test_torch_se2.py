"""Parity of ndtpu_torch.lie.se2 with ndtpu.lie.se2 on the same f64 inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndtpu.lie import se2 as jse2
from ndtpu_torch.lie import se2 as tse2

torch.set_num_threads(2)


def _poses(seed, n=64):
    rng = np.random.default_rng(seed)
    p = np.stack([rng.uniform(-10, 10, n), rng.uniform(-10, 10, n),
                  rng.uniform(-4.0, 4.0, n)], -1)
    p[:4, 2] = [0.0, 1e-6, -3e-5, np.pi]     # small-angle and wrap edges
    return p


def _close(a, b, rtol=1e-12):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    scale = max(1.0, float(np.abs(b).max()))
    np.testing.assert_allclose(a, b, rtol=0, atol=rtol * scale)


@pytest.mark.parametrize("name", ["wrap", "rotmat"])
def test_angle_functions(name):
    th = _poses(0)[:, 2]
    _close(getattr(tse2, name)(torch.as_tensor(th)).numpy(),
           getattr(jse2, name)(jnp.asarray(th)))


@pytest.mark.parametrize("name", ["inverse", "expmap", "logmap", "adjoint"])
def test_unary(name):
    p = _poses(1)
    _close(getattr(tse2, name)(torch.as_tensor(p)).numpy(),
           getattr(jse2, name)(jnp.asarray(p)))


@pytest.mark.parametrize("name", ["compose", "between", "retract"])
def test_binary(name):
    a, b = _poses(2), _poses(3) * 0.3
    _close(getattr(tse2, name)(torch.as_tensor(a), torch.as_tensor(b)).numpy(),
           getattr(jse2, name)(jnp.asarray(a), jnp.asarray(b)))


@pytest.mark.parametrize("name", ["transform", "transform_inv"])
def test_point_transforms(name):
    p = _poses(4, 8)
    pts = np.random.default_rng(5).normal(0, 5, (8, 30, 2))
    _close(getattr(tse2, name)(torch.as_tensor(p), torch.as_tensor(pts)).numpy(),
           getattr(jse2, name)(jnp.asarray(p), jnp.asarray(pts)))


def test_exp_log_roundtrip_and_dtype():
    p = torch.as_tensor(_poses(6), dtype=torch.float32)
    back = tse2.expmap(tse2.logmap(p))
    assert back.dtype == torch.float32
    d = tse2.between(p, back)
    assert float(d.abs().max()) < 1e-4
