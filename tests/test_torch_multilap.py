"""The multilap (bench.py §3b; ``tests/test_multilap.py``'s guard) through
ndtpu_torch against the JAX package.

``tests/test_multilap.py``'s scene (box world of half 8 m, 480 scans x 180
beams, ~6.8 laps of a 14 m rectangle, seed 7) is made by the port's synth
(numpy noise) and run at f64 through ``ndtpu_torch`` and through the jitted
JAX pipeline: keyframes, the smoother's takes and keyframe indices equal,
poses within 1e-6, and the JAX guard's loop budget and ATE on both.

``PYTHONPATH=. python tests/test_torch_multilap.py`` regenerates
``tests/data/torch_multilap1000_ref.json``: the JAX package's run (CPU,
jitted, f32 and f64) of bench.py §3b at full size (1,000 scans x 360
beams, bench.py's widths and capacity 512; ``chip_smoke.MULTILAP``) on the
port's sequence, with the sequence's hashes; ``chip_smoke.py``'s multilap
phase gates the card's run against its f32 ATE (~2 min).
"""

import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from ndtpu import config as jconfig
from ndtpu.eval.ate import ate_rmse as jate
from ndtpu.slam import pipeline as jpipe
from ndtpu_torch import config as tconfig
from ndtpu_torch.data import synth as tsynth
from ndtpu_torch.eval.ate import ate_rmse
from ndtpu_torch.slam import pipeline as tpipe

torch.set_num_threads(2)


def _cfg(c):
    """``tests/test_multilap.py``'s config from the config module ``c``."""
    return c.PipelineConfig(
        grid=c.GridConfig(x0=-10.0, y0=-10.0, cell=0.5, nx=40, ny=40,
                          overlap=4),
        keyframe=c.KeyframeConfig(dist_thresh=0.5, angle_thresh=0.3,
                                  capacity=256),
        loop=c.LoopConfig(radius=3.0, min_index_gap=10, max_candidates=8,
                          local_half_extent=8.0),
        solver=c.SolverConfig(inc_iters=2, pcg_max_iter=60),
        n_beams=180, use_loop_closure=True, window=8, window_passes=2)


def _jax(a):
    return jnp.asarray(np.array(a))


@pytest.fixture(scope="module")
def scene():
    """The scene at f64 (port synth), and the JAX package's jitted run."""
    world = tsynth.box_world(8.0)
    traj = tsynth.rectangle_trajectory(480, half=1.75, step=0.2)
    s = tsynth.make_sequence(world, traj, 180, 20.0, 0.1, seed=7,
                             odom_trans_std=0.04, odom_rot_std=0.01)
    s = s._replace(points=s.points.double(), odom=s.odom.double(),
                   gt_poses=s.gt_poses.double())
    cfg = _cfg(jconfig)
    run = jax.jit(lambda p, m, o: jpipe.run_slam_windowed(p, m, o, cfg))
    jst, jouts = run(_jax(s.points), _jax(s.mask), _jax(s.odom))
    jtraj = np.asarray(jpipe.recover_trajectory(jst, jouts))
    return s, jst, jouts, jtraj


def test_multilap_matches_jax_and_holds_the_guard(scene):
    s, jst, jouts, jtraj = scene
    st, outs = tpipe.run_slam_windowed(s.points, s.mask, s.odom,
                                       _cfg(tconfig))
    for key in ("is_keyframe", "local_take", "kf_idx"):
        np.testing.assert_array_equal(getattr(outs, key).numpy(),
                                      np.asarray(getattr(jouts, key)), key)
    np.testing.assert_allclose(outs.pose.numpy(), np.asarray(jouts.pose),
                               rtol=0, atol=1e-6)
    traj = tpipe.recover_trajectory(st, outs)
    np.testing.assert_allclose(traj.numpy(), jtraj, rtol=0, atol=1e-6)
    assert int(st.n_loops) == int(jst.n_loops)
    # tests/test_multilap.py's guard, on both packages' runs.
    for n_loops, ate in ((int(st.n_loops), float(ate_rmse(traj,
                                                          s.gt_poses))),
                         (int(jst.n_loops), float(jate(jtraj,
                                                       _jax(s.gt_poses))))):
        assert 0 < n_loops < 400, n_loops
        assert ate < 0.15, (ate, n_loops)
    # The run exercises the smoother's local path under loop load.
    assert int((outs.local_take == 2).sum()) > 0


def test_multilap_reference_matches_the_port_sequence():
    """The reference file's sequence is the one ``chip_smoke`` makes (the
    port's synth at ``chip_smoke.MULTILAP``), and its JAX runs hold bench.py
    §3b's guard."""
    ref = json.loads(chip_smoke.REF_MULTILAP_FILE.read_text())
    seq = chip_smoke.multilap_sequence()
    assert chip_smoke.sequence_hashes(seq) == ref["sequence_sha256"]
    assert ref["scenario"]["multilap"] == chip_smoke.MULTILAP
    for dt in ("float32", "float64"):
        run = ref["jax"][dt]
        assert run["ate_m"] < 0.15 and run["loops"] > 0, (dt, run)
        assert sum(run["takes"].values()) == (
            chip_smoke.MULTILAP["n_scans"]
            // chip_smoke.multilap_config(tconfig).window)


def regenerate_reference(path=chip_smoke.REF_MULTILAP_FILE):
    """The JAX package (CPU, jitted) on bench.py §3b's sequence from the
    port's synth, in f32 (the smoke's gate) and f64."""
    seq = chip_smoke.multilap_sequence()
    cfg = chip_smoke.multilap_config(jconfig)
    runs = {}
    for x64, dt in ((False, torch.float32), (True, torch.float64)):
        jax.config.update("jax_enable_x64", x64)
        run = jax.jit(lambda p, m, o: jpipe.run_slam_windowed(p, m, o, cfg))
        st, outs = run(_jax(seq.points.to(dt)), _jax(seq.mask),
                       _jax(seq.odom.to(dt)))
        traj = jpipe.recover_trajectory(st, outs)
        res = chip_smoke.multilap_summary(
            float(jate(traj, _jax(seq.gt_poses.to(dt)))), int(st.n_loops),
            int(st.kf.n), np.asarray(outs.local_take)[::cfg.window],
            int(np.asarray(outs.n_innov_rej).sum()))
        runs[str(dt).split(".")[1]] = res
        print(dt, res, file=sys.stderr, flush=True)
    jax.config.update("jax_enable_x64", False)
    doc = dict(
        scenario=dict(multilap=chip_smoke.MULTILAP,
                      config="chip_smoke.multilap_config: bench.py "
                             "pcfg_base (bench.py:260-269) with loop "
                             "closure"),
        reference="ndtpu.slam.pipeline.run_slam_windowed under jax.jit on "
                  "the CPU at f32 and f64; regenerate with PYTHONPATH=. "
                  "python tests/test_torch_multilap.py",
        sequence_sha256=chip_smoke.sequence_hashes(seq), jax=runs)
    Path(path).write_text(json.dumps(doc, indent=1) + "\n")


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    regenerate_reference()
