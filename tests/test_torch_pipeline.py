"""The windowed SLAM slice of ndtpu_torch against ndtpu at reduced size,
state conversion between the packages, and the CLI on the CPU.

``python tests/test_torch_pipeline.py`` regenerates
``tests/data/torch_config2_box300_ref.json``: the JAX package's ATE (CPU,
f32) on draws 0-2 of the port's box-world sequences at the config-2 width,
with the sequences' hashes and dead-reckoning ATE, which ``chip_smoke.py``
gates the port's ATE on the card against. ``python
tests/test_torch_pipeline.py config3`` writes the config-3 file
(``torch_config3_box300_ref.json``, with the JAX loop counts).
"""

import dataclasses
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndtpu.config import (GridConfig, KeyframeConfig, LoopConfig,
                          MatchConfig, PipelineConfig, SolverConfig)
from ndtpu.slam import pipeline as jpipe
from ndtpu_torch import convert
from ndtpu_torch.data import synth as tsynth
from ndtpu_torch.eval.ate import ate_rmse
from ndtpu_torch.slam import pipeline as tpipe

torch.set_num_threads(2)

REF = Path(__file__).parent / "data" / "torch_config2_box300_ref.json"
REF3 = Path(__file__).parent / "data" / "torch_config3_box300_ref.json"


def _cfg(**over):
    base = dict(
        grid=GridConfig(x0=-16.0, y0=-16.0, cell=1.0, nx=32, ny=32,
                        overlap=4),
        keyframe=KeyframeConfig(dist_thresh=0.5, angle_thresh=0.3,
                                capacity=64),
        solver=SolverConfig(inc_iters=2, pcg_max_iter=60, full_solve_every=4,
                            local_poses=12, local_factors=32),
        n_beams=90, use_loop_closure=False, window=8, window_passes=2)
    base.update(over)
    return PipelineConfig(**base)


@pytest.fixture(scope="module")
def seq():
    world = tsynth.box_world(11.0)
    traj = tsynth.rectangle_trajectory(41, half=7.0, step=0.2)
    s = tsynth.make_sequence(world, traj, 90, 20.0, 0.1, seed=0,
                             odom_trans_std=0.04, odom_rot_std=0.01)
    return s._replace(points=s.points.double(), odom=s.odom.double())


def _jax(a):
    return jnp.asarray(np.array(a))


@pytest.fixture(scope="module")
def jax_default(seq):
    """The JAX package's run of the sequence at the default test config."""
    return jpipe.run_slam_windowed(_jax(seq.points), _jax(seq.mask),
                                   _jax(seq.odom), _cfg())


@pytest.mark.parametrize("variant", ["default", "refresh_top_m"])
def test_run_slam_windowed_matches_jax(seq, jax_default, variant):
    over = {} if variant == "default" else dict(
        refresh_top_m=4, refresh_always=True, full_rebuild_every=3)
    cfg = _cfg(**over)
    st, outs = tpipe.run_slam_windowed(seq.points, seq.mask, seq.odom, cfg)
    jst, jouts = (jax_default if variant == "default" else
                  jpipe.run_slam_windowed(_jax(seq.points), _jax(seq.mask),
                                          _jax(seq.odom), cfg))
    np.testing.assert_array_equal(outs.is_keyframe.numpy(),
                                  np.asarray(jouts.is_keyframe))
    np.testing.assert_array_equal(outs.local_take.numpy(),
                                  np.asarray(jouts.local_take))
    np.testing.assert_array_equal(outs.kf_idx.numpy(),
                                  np.asarray(jouts.kf_idx))
    assert set(outs.local_take.tolist()) >= {0, 2}
    np.testing.assert_allclose(outs.pose.numpy(), np.asarray(jouts.pose),
                               rtol=0, atol=1e-6)
    traj = tpipe.recover_trajectory(st, outs)
    np.testing.assert_allclose(
        traj.numpy(), np.asarray(jpipe.recover_trajectory(jst, jouts)),
        rtol=0, atol=1e-6)
    assert float(ate_rmse(traj, seq.gt_poses.double())) < 0.1


def test_capacity_overflow_counts_drops(seq):
    cfg = _cfg(keyframe=KeyframeConfig(dist_thresh=0.5, angle_thresh=0.3,
                                       capacity=6))
    st, outs = tpipe.run_slam_windowed(seq.points, seq.mask, seq.odom, cfg)
    jst, jouts = jpipe.run_slam_windowed(_jax(seq.points), _jax(seq.mask),
                                         _jax(seq.odom), cfg)
    assert int(st.kf.n) == 6 and int(outs.n_dropped.sum()) > 0
    np.testing.assert_array_equal(outs.n_dropped.numpy(),
                                  np.asarray(jouts.n_dropped))
    assert bool(torch.isfinite(tpipe.recover_trajectory(st, outs)).all())


def test_convert_round_trip_and_resume_from_jax_state(seq, jax_default):
    """The port continues from a mid-run JAX state (2 windows) exactly as
    the JAX run did."""
    cfg = _cfg()
    w, n0 = cfg.window, 1 + 2 * cfg.window
    jstate, jouts2 = jpipe.run_slam_windowed(
        _jax(seq.points[:n0]), _jax(seq.mask[:n0]), _jax(seq.odom[:n0]), cfg)
    tstate = convert.from_numpy(jstate)
    back = convert.to_numpy(tstate)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(jstate)):
        b = np.asarray(b)
        assert a.dtype == b.dtype and np.array_equal(a, b)
    # Registration-time pose of the newest keyframe (the window carry).
    kf = np.nonzero(np.asarray(jouts2.is_keyframe))[0]
    lkr = torch.as_tensor(np.array(jouts2.pose[kf[-1]]))
    carry, outs = (tstate, lkr), []
    for k in range(2, 5):
        sl = slice(1 + k * w, 1 + (k + 1) * w)
        carry, out = tpipe.slam_window_step(carry[0], carry[1],
                                            seq.points[sl], seq.mask[sl],
                                            seq.odom[sl], cfg)
        outs.append(out)
    tout = tpipe.stack_outs(outs, seq.points.shape[0] - n0)
    jst, jouts = jax_default
    np.testing.assert_array_equal(tout.is_keyframe.numpy(),
                                  np.asarray(jouts.is_keyframe[n0 - 1:]))
    np.testing.assert_allclose(tout.pose.numpy(),
                               np.asarray(jouts.pose[n0 - 1:]), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(carry[0].graph.poses.numpy(),
                               np.asarray(jst.graph.poses), rtol=0, atol=1e-6)
    assert int(carry[0].graph.n_between) == int(jst.graph.n_between)


def test_unported_options_raise(seq):
    """Loop closure runs now; compact tables on the card do not (the check
    needs no card: it looks at the device the state would live on)."""
    with pytest.raises(NotImplementedError, match="ROADMAP Queue B"):
        tpipe._check_slice(_cfg(match=MatchConfig(compact_table=True)),
                           "cuda")
    tpipe._check_slice(_cfg(use_loop_closure=True), "cuda")


def _loop_cfg():
    """Config 3 cut to a 3.5 m square lap at 90 beams, where loops fire."""
    return _cfg(use_loop_closure=True,
                loop=LoopConfig(min_index_gap=5, max_candidates=4,
                                local_half_extent=4.0))


@pytest.fixture(scope="module")
def loop_seq():
    world = tsynth.box_world(11.0)
    traj = tsynth.rectangle_trajectory(57, half=1.75, step=0.25)
    s = tsynth.make_sequence(world, traj, 90, 20.0, 0.1, seed=0,
                             odom_trans_std=0.04, odom_rot_std=0.01)
    return s._replace(points=s.points.double(), odom=s.odom.double())


@pytest.fixture(scope="module")
def jax_loop_run(loop_seq):
    """The JAX package's config-3 run, window by window through
    ``slam_window_step_jit``: ``(final state, outs, carry after window
    3)``."""
    cfg = _loop_cfg()
    p, m, o = (_jax(a) for a in (loop_seq.points, loop_seq.mask,
                                 loop_seq.odom))
    state = jpipe.init_slam(cfg, p[0], m[0])
    carry, outs, mid = (state, state.pose), [], None
    for k in range(7):
        sl = slice(1 + 8 * k, 9 + 8 * k)
        carry, out = jpipe.slam_window_step_jit(carry[0], carry[1], p[sl],
                                                m[sl], o[sl], cfg=cfg)
        outs.append(out)
        if k == 2:
            mid = carry
    jouts = jax.tree_util.tree_map(lambda *a: jnp.concatenate(a), *outs)
    return carry[0], jouts, mid


def _check_loop_outs(tout, jouts):
    for f in ("is_keyframe", "n_loops_new", "n_innov_rej", "n_dropped",
              "kf_idx", "local_take"):
        np.testing.assert_array_equal(getattr(tout, f).numpy(),
                                      np.asarray(getattr(jouts, f)), f)
    np.testing.assert_allclose(tout.pose.numpy(), np.asarray(jouts.pose),
                               rtol=0, atol=1e-6)


def test_loop_closure_run_matches_jax(loop_seq, jax_loop_run):
    """Config 3 (cut): both packages close loops, with the same keyframes,
    loop counts, innovation rejections and drops per scan, and the same
    poses and smoothed graph."""
    jst, jouts, _ = jax_loop_run
    st, outs = tpipe.run_slam_windowed(loop_seq.points, loop_seq.mask,
                                       loop_seq.odom, _loop_cfg())
    assert int(jst.n_loops) > 0 and int(st.n_loops) == int(jst.n_loops)
    assert int(outs.n_innov_rej.sum()) > 0
    _check_loop_outs(outs, jouts)
    np.testing.assert_allclose(st.graph.poses.numpy(),
                               np.asarray(jst.graph.poses), rtol=0, atol=1e-6)
    assert int(st.graph.n_between) == int(jst.graph.n_between)
    np.testing.assert_allclose(st.kf.tables.numpy(), np.asarray(jst.kf.tables),
                               rtol=0, atol=1e-9)
    traj = tpipe.recover_trajectory(st, outs)
    np.testing.assert_allclose(
        traj.numpy(), np.asarray(jpipe.recover_trajectory(jst, jouts)),
        rtol=0, atol=1e-6)


def test_convert_round_trip_with_tables_and_resume(loop_seq, jax_loop_run):
    """A mid-run JAX state that holds the table cache converts both ways
    bit for bit, and the port continues from it as the JAX run did."""
    jst, jouts, (jmid, lkr) = jax_loop_run
    tstate = convert.from_numpy(jmid)
    assert tstate.kf.tables is not None
    back = convert.to_numpy(tstate)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(jmid)):
        b = np.asarray(b)
        assert a.dtype == b.dtype and np.array_equal(a, b)
    carry, outs = (tstate, torch.as_tensor(np.array(lkr))), []
    for k in range(3, 7):
        sl = slice(1 + 8 * k, 9 + 8 * k)
        carry, out = tpipe.slam_window_step(
            carry[0], carry[1], loop_seq.points[sl], loop_seq.mask[sl],
            loop_seq.odom[sl], _loop_cfg())
        outs.append(out)
    tout = tpipe.stack_outs(outs, 32)
    _check_loop_outs(tout, jax.tree_util.tree_map(lambda a: a[24:], jouts))
    np.testing.assert_allclose(carry[0].graph.poses.numpy(),
                               np.asarray(jst.graph.poses), rtol=0, atol=1e-6)
    assert int(carry[0].n_loops) == int(jst.n_loops)


def _write_cfg(tmp_path):
    cfg = _cfg(grid=GridConfig(x0=-20.0, y0=-20.0, cell=1.0, nx=40, ny=40,
                               overlap=4))
    path = tmp_path / "cfg.json"
    cfg.to_json(str(path))
    return path


def test_cli_runs_on_cpu(tmp_path, capsys):
    from ndtpu_torch import run

    path = _write_cfg(tmp_path)
    out = run.main(["--config", str(path), "--max-scans", "33",
                    "--device", "cpu", "--out-traj", str(tmp_path / "t.txt"),
                    "--out-metrics", str(tmp_path / "m.jsonl")])
    err = capsys.readouterr().err
    assert "scans/s" in err and "ATE" in err and "#" in err
    assert out["traj"].shape == (33, 3) and np.isfinite(out["traj"]).all()
    assert out["n_keyframes"] > 0
    assert np.loadtxt(tmp_path / "t.txt").shape == (33, 3)
    lines = (tmp_path / "m.jsonl").read_text().splitlines()
    assert json.loads(lines[-1])["summary"]["n_scans"] == 4


def test_cli_runs_config3_on_cpu(tmp_path, capsys):
    """Loop closure through the CLI. With a 5-keyframe index gap, loops
    close along the corridor itself; the summary line reports them."""
    from ndtpu_torch import run

    cfg = dataclasses.replace(
        _loop_cfg(), grid=GridConfig(x0=-20.0, y0=-20.0, cell=1.0, nx=40,
                                     ny=40, overlap=4))
    path = tmp_path / "cfg3.json"
    cfg.to_json(str(path))
    out = run.main(["--config", str(path), "--max-scans", "33",
                    "--device", "cpu"])
    err = capsys.readouterr().err
    assert "loop_closure=True" in err and f"loops={out['n_loops']}" in err
    assert out["n_loops"] > 0 and np.isfinite(out["traj"]).all()


@pytest.mark.parametrize("extra", [["--dataset", "x.clf"], ["--mode", "scan"],
                                   ["--checkpoint-dir", "ck"]])
def test_cli_unported_options_raise(tmp_path, extra):
    from ndtpu_torch import run

    with pytest.raises(NotImplementedError, match="ROADMAP"):
        run.main(["--config", str(_write_cfg(tmp_path)), "--device", "cpu",
                  *extra])


def test_cli_cuda_without_card_raises(tmp_path):
    from ndtpu_torch import run

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run.main(["--config", str(_write_cfg(tmp_path)), "--max-scans", "9"])


def _chip_smoke():
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    return chip_smoke


def _jax_box_draws(config, n_scans: int):
    """The JAX package (CPU, f32) on draws 0-2 of the port-made box-world
    sequences at ``n_scans``: per draw the inputs' hashes, the ATE, the
    loop count (with loop closure on) and dead reckoning."""
    from ndtpu.eval.ate import ate_rmse as jate

    chip_smoke = _chip_smoke()
    jax.config.update("jax_enable_x64", False)
    cfg = jpipe.PipelineConfig.from_json(str(config))
    run = jax.jit(lambda p, m, o: jpipe.run_slam_windowed(p, m, o, cfg))
    draws = []
    for seed in (0, 1, 2):
        s = chip_smoke.box_sequence(seed, cfg.n_beams, n_scans=n_scans)
        st, outs = run(_jax(s.points), _jax(s.mask), _jax(s.odom))
        traj = jpipe.recover_trajectory(st, outs)
        dr = chip_smoke.dead_reckoning(s.odom.double())
        draw = dict(seed=seed, sha256=chip_smoke.sequence_hashes(s),
                    jax_ate_m=float(jate(traj, _jax(s.gt_poses))))
        if cfg.use_loop_closure:
            draw["jax_n_loops"] = int(st.n_loops)
        draw["dead_reckoning_ate_m"] = float(ate_rmse(dr,
                                                      s.gt_poses.double()))
        draws.append(draw)
    return draws


def _scenario(n_scans: int) -> str:
    return (f"box_world(11), rectangle_trajectory({n_scans}, half=7, "
            "step=0.2), 360 beams, max_range 20, min_range 0.1, odometry "
            "noise 0.04 m / 0.01 rad; sequences from ndtpu_torch.data.synth."
            "make_sequence(seed)")


def regenerate_box300_reference(path=REF):
    """Run the JAX package (CPU, f32) on draws 0-2 of the port-made
    box-world sequences and write the config-2 ATE reference file."""
    chip_smoke = _chip_smoke()
    doc = dict(
        scenario=_scenario(300),
        config="configs/config2_full_sequence.json",
        reference="ndtpu.slam.pipeline.run_slam_windowed under jax.jit on "
                  "the CPU at f32; regenerate with python "
                  "tests/test_torch_pipeline.py",
        draws=_jax_box_draws(chip_smoke.CONFIG2, 300))
    Path(path).write_text(json.dumps(doc, indent=1) + "\n")


def regenerate_config3_reference(path=REF3):
    """The config-3 reference: as :func:`regenerate_box300_reference` with
    ``configs/config3_loop_closure.json``, plus the JAX loop count. If JAX
    closes no loop on a draw at 300 scans, all draws run 420 (1.5 laps)."""
    chip_smoke = _chip_smoke()
    n_scans = 300
    draws = _jax_box_draws(chip_smoke.CONFIG3, n_scans)
    if any(d["jax_n_loops"] == 0 for d in draws):
        n_scans = 420
        draws = _jax_box_draws(chip_smoke.CONFIG3, n_scans)
    doc = dict(
        scenario=_scenario(n_scans), n_scans=n_scans,
        config="configs/config3_loop_closure.json",
        reference="ndtpu.slam.pipeline.run_slam_windowed under jax.jit on "
                  "the CPU at f32; regenerate with python "
                  "tests/test_torch_pipeline.py config3",
        draws=draws)
    Path(path).write_text(json.dumps(doc, indent=1) + "\n")


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    if sys.argv[1:] == ["config3"]:
        regenerate_config3_reference()
    else:
        regenerate_box300_reference()
