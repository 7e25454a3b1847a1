"""ndtpu_torch.data.synth against ndtpu.data.synth, and the box-world
fixture hashes of tests/data/torch_config2_box300_ref.json."""

import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from ndtpu.data import synth as jsynth
from ndtpu_torch.data import synth as tsynth

torch.set_num_threads(2)

REF = Path(__file__).parent / "data" / "torch_config2_box300_ref.json"


@pytest.mark.parametrize("make", [
    lambda m: m.box_world(11.0), lambda m: m.box_world(),
    lambda m: m.corridor_loop_world(outer=18.0, width=5.0)])
def test_worlds_exact(make):
    t, j = make(tsynth).segments, make(jsynth).segments
    assert t.dtype == torch.float32
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("args", [(120, 8.0, 0.25), (300, 7.0, 0.2),
                                  (300, 15.0, 0.25)])
def test_rectangle_trajectory_exact(args):
    n, half, step = args
    t = tsynth.rectangle_trajectory(n, half=half, step=step)
    j = jsynth.rectangle_trajectory(n, half=half, step=step)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_raycast_and_polar_match_jax_f32():
    """Noise-free ranges and points within 1e-4 m of the JAX simulator."""
    world_t, world_j = tsynth.box_world(11.0), jsynth.box_world(11.0)
    traj = jsynth.rectangle_trajectory(60, half=7.0, step=0.2)
    ang_j = jsynth.beam_angles(180)
    ang_t = tsynth.beam_angles(180)
    np.testing.assert_allclose(ang_t.numpy(), np.asarray(ang_j), atol=1e-6)
    r_j = np.asarray(jsynth.raycast(world_j, traj, ang_j, 20.0))
    r_t = tsynth.raycast(world_t, torch.as_tensor(np.asarray(traj)),
                         torch.as_tensor(np.asarray(ang_j)), 20.0)
    assert r_t.dtype == torch.float32
    np.testing.assert_allclose(r_t.numpy(), r_j, atol=1e-4)
    xy_j, m_j = jsynth.polar_to_xy(jnp.asarray(r_j), ang_j, 0.1, 20.0)
    xy_t, m_t = tsynth.polar_to_xy(torch.as_tensor(r_j),
                                   torch.as_tensor(np.asarray(ang_j)), 0.1,
                                   20.0)
    np.testing.assert_allclose(xy_t.numpy(), np.asarray(xy_j), atol=1e-4)
    np.testing.assert_array_equal(m_t.numpy(), np.asarray(m_j))


def test_make_sequence_shapes_and_noise():
    world = tsynth.box_world(11.0)
    traj = tsynth.rectangle_trajectory(50, half=7.0, step=0.2)
    a = tsynth.make_sequence(world, traj, 90, 20.0, 0.1, seed=4,
                             odom_trans_std=0.04, odom_rot_std=0.01)
    b = tsynth.make_sequence(world, traj, 90, 20.0, 0.1, seed=4,
                             odom_trans_std=0.04, odom_rot_std=0.01)
    c = tsynth.make_sequence(world, traj, 90, 20.0, 0.1, seed=5,
                             odom_trans_std=0.04, odom_rot_std=0.01)
    assert a.points.shape == (50, 90, 2) and a.mask.shape == (50, 90)
    assert a.odom.shape == (50, 3) and a.points.dtype == torch.float32
    assert torch.equal(a.points, b.points) and torch.equal(a.odom, b.odom)
    assert not torch.equal(a.odom, c.odom)
    assert float(a.odom[0].abs().max()) == 0.0
    # Odometry noise has the requested scale around the true relative poses.
    rel = tsynth.se2.between(traj[:-1].double(), traj[1:].double())
    dev = (a.odom[1:, :2].double() - rel[:, :2]).std().item()
    assert 0.02 < dev < 0.06, dev


@pytest.mark.parametrize("draw", [0, 1, 2])
def test_fixture_hashes_reproduce(draw):
    ref = json.loads(REF.read_text())["draws"][draw]
    seq = chip_smoke.box_sequence(ref["seed"], 360)
    assert chip_smoke.sequence_hashes(seq) == ref["sha256"]
