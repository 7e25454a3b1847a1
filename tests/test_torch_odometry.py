"""ndtpu_torch.slam.odometry against ndtpu.slam.odometry on f64 inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndtpu.config import GridConfig, KeyframeConfig, MatchConfig, NDTMapConfig
from ndtpu.slam import odometry as jodo
from ndtpu_torch.data import synth as tsynth
from ndtpu_torch.slam import odometry as todo

torch.set_num_threads(2)


def _t(a):
    return torch.as_tensor(np.array(a))


@pytest.mark.parametrize("seed", range(4))
def test_chain_deltas(seed):
    rng = np.random.default_rng(seed)
    pose0 = rng.normal(0, [5, 5, 2])
    deltas = rng.normal(0, [0.3, 0.1, 0.2], (8, 3))
    np.testing.assert_allclose(
        todo.chain_deltas(_t(pose0), _t(deltas)).numpy(),
        np.asarray(jodo.chain_deltas(jnp.asarray(pose0), jnp.asarray(deltas))),
        rtol=0, atol=1e-12)


@pytest.mark.parametrize("step", [0.05, 0.2, 0.45, 0.8])
def test_kf_select_flags_exact(step):
    """Random walks at several step sizes (from no keyframe to every scan
    a keyframe), 25 windows each."""
    rng = np.random.default_rng(int(step * 100))
    for _ in range(25):
        last = rng.normal(0, [3, 3, 1])
        poses = last + np.cumsum(rng.normal(0, [step, step, step / 2],
                                            (8, 3)), 0)
        kt, lt = todo.kf_select(_t(last), _t(poses), 0.5, 0.3)
        kj, lj = jodo.kf_select(jnp.asarray(last), jnp.asarray(poses), 0.5,
                                0.3)
        np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))
        np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))


@pytest.mark.parametrize("gate", [0.0, 0.3])
def test_gate_poses(gate):
    rng = np.random.default_rng(3)
    res, init = rng.normal(size=(10, 3)), rng.normal(size=(10, 3))
    conv = rng.random(10) > 0.3
    pt, ot = todo.gate_poses(_t(res), _t(conv), _t(init), gate)
    pj, oj = jodo.gate_poses(jnp.asarray(res), jnp.asarray(conv),
                             jnp.asarray(init), gate)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    np.testing.assert_array_equal(ot.numpy(), np.asarray(oj))


def test_pad_to_windows():
    pts, msk, odo = torch.ones(13, 5, 2), torch.ones(13, 5, dtype=torch.bool), \
        torch.ones(13, 3)
    p, m, o, n_win, pad = todo._pad_to_windows(pts, msk, odo, 4)
    assert (n_win, pad) == (4, 3) and p.shape == (16, 5, 2)
    assert not bool(m[13:].any()) and float(o[13:].abs().sum()) == 0.0


def test_run_odometry_windowed_matches_jax():
    world = tsynth.box_world(11.0)
    traj = tsynth.rectangle_trajectory(41, half=7.0, step=0.2,
                                       dtype=torch.float64)
    seq = tsynth.make_sequence(world, traj, 90, 20.0, 0.1, seed=2,
                               odom_trans_std=0.04, odom_rot_std=0.01)
    grid = GridConfig(x0=-16.0, y0=-16.0, cell=1.0, nx=32, ny=32, overlap=4)
    args = (grid, NDTMapConfig(), MatchConfig(),
            KeyframeConfig(dist_thresh=0.5, angle_thresh=0.3, capacity=64))
    rt = todo.run_odometry_windowed(seq.points, seq.mask, seq.odom, *args,
                                    window=8, passes=2)
    rj = jodo.run_odometry_windowed(jnp.asarray(seq.points.numpy()),
                                    jnp.asarray(seq.mask.numpy()),
                                    jnp.asarray(seq.odom.numpy()), *args,
                                    window=8, passes=2)
    np.testing.assert_array_equal(rt.is_keyframe.numpy(),
                                  np.asarray(rj.is_keyframe))
    np.testing.assert_array_equal(rt.n_iters.numpy(), np.asarray(rj.n_iters))
    np.testing.assert_allclose(rt.poses.numpy(), np.asarray(rj.poses),
                               rtol=0, atol=1e-8)
    for a, b in zip(rt.stats, rj.stats):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-9 * float(np.abs(b).max()))
