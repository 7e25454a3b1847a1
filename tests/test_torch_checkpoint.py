"""Checkpoints and the CLI's inputs in the port: ``utils.checkpoint``
(save, restore, rotation; a restored state continues bit for bit), and
``python -m ndtpu_torch.run`` / ``ndtpu_torch.serve`` on the CPU at a cut
size: ``--mode scan``'s per-scan records, checkpoints per mode and
``--resume`` in both modes (bit-identical to an uninterrupted run),
``--dataset`` and ``serve --datasets`` on logs written by ``write_carmen``
(their inputs equal to the JAX package's readers'), and
``downsample_voxel`` (the kept count equal to the JAX package's). The
counterparts of ``tests/test_checkpoint.py`` and ``tests/test_cli.py``."""

import argparse
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from ndtpu.config import (GridConfig, KeyframeConfig, LoopConfig,
                          PipelineConfig, SolverConfig)
from ndtpu.data import carmen as jcarmen
from ndtpu import serve as jserve
from ndtpu.data.preprocess import voxel_downsample as jvoxel
from ndtpu_torch import run, serve
from ndtpu_torch.config import PipelineConfig as TorchConfig
from ndtpu_torch.data import carmen as tcarmen
from ndtpu_torch.data import synth as tsynth
from ndtpu_torch.eval.ate import ate_rmse
from ndtpu_torch.slam import pipeline as tpipe
from ndtpu_torch.utils import checkpoint as ckpt

torch.set_num_threads(2)


def _cfg(loops: bool = False):
    """``tests/test_checkpoint.py``'s config."""
    return PipelineConfig(
        grid=GridConfig(x0=-12.0, y0=-12.0, cell=1.0, nx=24, ny=24,
                        overlap=4),
        keyframe=KeyframeConfig(dist_thresh=0.6, angle_thresh=0.3,
                                capacity=64),
        loop=LoopConfig(radius=3.0, min_index_gap=8, max_candidates=4,
                        local_half_extent=8.0),
        solver=SolverConfig(inc_iters=1, pcg_max_iter=40),
        use_loop_closure=loops)


def _bit_equal(a, b):
    la, lb = ckpt.leaves(a), ckpt.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.mark.parametrize("loops", [False, True], ids=["no_loops", "loops"])
def test_save_restore_roundtrip(tmp_path, loops):
    """A state saved mid-run and restored continues bit for bit as the
    original (with loop closure: the table cache too, no shared storage)."""
    world = tsynth.box_world(half=9.0)
    traj = tsynth.rectangle_trajectory(60, half=3.0, step=0.3)
    seq = tsynth.make_sequence(world, traj, n_beams=90, max_range=15.0,
                               min_range=0.1, seed=1)
    cfg = _cfg(loops)
    state = tpipe.init_slam(cfg, seq.points[0], seq.mask[0])
    for t in range(1, 25):
        state, _ = tpipe.slam_step(state, seq.points[t], seq.mask[t],
                                   seq.odom[t], cfg)
    p = str(tmp_path / "state.npz")
    ckpt.save_state(p, state)
    restored = ckpt.restore_state(p, state)
    _bit_equal(restored, state)
    if loops:
        assert restored.kf.tables.data_ptr() != state.kf.tables.data_ptr()
    for t in range(25, 60):
        state, _ = tpipe.slam_step(state, seq.points[t], seq.mask[t],
                                   seq.odom[t], cfg)
        restored, _ = tpipe.slam_step(restored, seq.points[t], seq.mask[t],
                                      seq.odom[t], cfg)
    _bit_equal(restored, state)
    if loops:
        assert int(state.n_loops) > 0


def test_restore_shape_mismatch_rejected(tmp_path):
    p = str(tmp_path / "x.npz")
    ckpt.save_state(p, (torch.zeros(3),))
    with pytest.raises(ValueError, match="checkpoint leaf"):
        ckpt.restore_state(p, (torch.zeros(4),))
    with pytest.raises(ValueError, match="checkpoint leaf"):
        ckpt.restore_state(p, (torch.zeros(3, dtype=torch.float64),))


def test_manager_rotation(tmp_path):
    mgr = ckpt.CheckpointManager(str(tmp_path / "ck"), every=2, keep=2)
    s = (torch.arange(4), None)
    for step in range(1, 9):
        mgr.maybe_save(step, s)
    assert mgr.latest_step() == 8
    assert len(list((tmp_path / "ck").iterdir())) == 2
    step, restored = mgr.restore_latest(s)
    assert step == 8 and restored[1] is None
    assert torch.equal(restored[0], torch.arange(4))


# ---------------------------------------------------------------------------
# The CLI.

def _cli_cfg(tmp_path, **over):
    """``tests/test_cli.py``'s config."""
    cfg = {"grid": {"x0": -12.0, "y0": -12.0, "cell": 1.0, "nx": 24,
                    "ny": 24, "overlap": 4},
           "keyframe": {"capacity": 32},
           "loop": {"max_candidates": 4, "local_half_extent": 6.0},
           "solver": {"inc_iters": 1, "pcg_max_iter": 30},
           "use_loop_closure": False, "n_beams": 90}
    cfg.update(over)
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg))
    return str(path)


def _main(cfg_path, *extra):
    return run.main(["--config", cfg_path, "--device", "cpu", *extra])


def test_cli_scan_mode_per_scan_records(tmp_path):
    traj_path, m_path = tmp_path / "traj.txt", tmp_path / "m.jsonl"
    out = _main(_cli_cfg(tmp_path), "--max-scans", "12", "--mode", "scan",
                "--out-traj", str(traj_path), "--out-metrics", str(m_path))
    traj = np.loadtxt(traj_path)
    assert traj.shape == (12, 3) and np.isfinite(traj).all()
    lines = [json.loads(x) for x in m_path.read_text().splitlines()]
    assert len(lines) == 12                 # 11 scan records + summary
    assert [r["scan"] for r in lines[:-1]] == list(range(1, 12))
    assert {"step_s", "score", "is_kf", "loops"} <= set(lines[0])
    assert lines[-1]["summary"]["n_scans"] == 11
    assert out["n_keyframes"] == 1 + sum(r["is_kf"] for r in lines[:-1])


def test_cli_windowed_checkpoints_are_written(tmp_path):
    ck = tmp_path / "ckpts"
    _main(_cli_cfg(tmp_path), "--max-scans", "24", "--checkpoint-dir",
          str(ck), "--checkpoint-every", "8")
    files = sorted(p.name for p in ck.iterdir())
    assert files and all(f.startswith("ckpt_win_") for f in files), files


def test_cli_checkpoint_modes_are_namespaced(tmp_path):
    """A scan-mode resume in a directory of windowed checkpoints starts
    fresh under its own prefix instead of restoring the other mode's
    state."""
    cfg_path, ck = _cli_cfg(tmp_path), tmp_path / "ckpts"
    _main(cfg_path, "--max-scans", "24", "--checkpoint-dir", str(ck),
          "--checkpoint-every", "8")
    _main(cfg_path, "--max-scans", "12", "--mode", "scan", "--resume",
          "--checkpoint-dir", str(ck), "--checkpoint-every", "4")
    names = sorted(p.name for p in ck.iterdir())
    assert any(n.startswith("ckpt_win_") for n in names)
    assert any(n.startswith("ckpt_scan_") for n in names)


@pytest.mark.parametrize("mode", ["windowed", "scan"])
def test_cli_resume_is_bit_identical(tmp_path, mode):
    """``--resume`` from the newest checkpoint of a run (loop closure on)
    ends in the state of the uninterrupted run, bit for bit, and gives the
    same trajectory rows for the scans it ran."""
    cfg_path = _cli_cfg(tmp_path, use_loop_closure=True,
                        loop={"max_candidates": 4, "local_half_extent": 6.0,
                              "min_index_gap": 5},
                        grid={"x0": -20.0, "y0": -20.0, "cell": 1.0,
                              "nx": 40, "ny": 40, "overlap": 4})
    args = ["--max-scans", "41", "--mode", mode]
    full = _main(cfg_path, *args)
    ck = str(tmp_path / "ck")
    _main(cfg_path, *args, "--checkpoint-dir", ck, "--checkpoint-every", "16")
    resumed = _main(cfg_path, *args, "--checkpoint-dir", ck,
                    "--checkpoint-every", "16", "--resume")
    _bit_equal(resumed["state"], full["state"])
    assert full["n_loops"] > 0
    n = resumed["traj"].shape[0] - 1
    assert 0 < n < 40
    np.testing.assert_array_equal(resumed["traj"][1:], full["traj"][-n:])


def _written_log(tmp_path, name, n_scans, seed=0):
    """A log of the CLI's corridor sequence (90 beams), written by the
    port's ``write_carmen``; returns ``(path, sequence)``."""
    world = tsynth.corridor_loop_world(outer=18.0, width=5.0)
    traj = tsynth.rectangle_trajectory(n_scans, half=15.0, step=0.25)
    seq = tsynth.make_sequence(world, traj, n_beams=90, max_range=20.0,
                               min_range=0.1, seed=seed,
                               odom_trans_std=0.03, odom_rot_std=0.008)
    path = tmp_path / name
    tcarmen.write_carmen(str(path), chip_smoke.sequence_log(seq, 20.0),
                         style="robotlaser")
    return str(path), seq


@pytest.mark.parametrize("mode", ["windowed", "scan"])
def test_cli_dataset(tmp_path, mode):
    """``--dataset`` on a written log: the port reads the inputs the JAX
    package's reader gives, and the run is the port's pipeline on them,
    within 0.2 m ATE of the sequence's ground truth."""
    path, seq = _written_log(tmp_path, "corridor.clf", 41)
    cfg_path = _cli_cfg(tmp_path, grid={"x0": -20.0, "y0": -20.0,
                                        "cell": 1.0, "nx": 40, "ny": 40,
                                        "overlap": 4})
    got = tcarmen.to_sequence(tcarmen.read_log(path), max_range=20.0,
                              min_range=0.1)
    ref = jcarmen.to_sequence(jcarmen.read_carmen(path), max_range=20.0,
                              min_range=0.1)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    out = _main(cfg_path, "--dataset", path, "--mode", mode, "--max-scans",
                "40")
    assert out["ate"] is None and out["traj"].shape == (40, 3)
    pts, msk, odo = (torch.as_tensor(a[:40]) for a in got)
    slam = tpipe.run_slam if mode == "scan" else tpipe.run_slam_windowed
    st, outs = slam(pts, msk, odo, _torch_cfg(cfg_path))
    np.testing.assert_array_equal(out["traj"],
                                  tpipe.recover_trajectory(st, outs).numpy())
    assert float(ate_rmse(torch.as_tensor(out["traj"]),
                          seq.gt_poses[:40])) < 0.2


def _torch_cfg(path):
    return TorchConfig.from_json(path)


def test_serve_datasets(tmp_path, capsys):
    """``serve --datasets`` on two written logs of different lengths: the
    padded inputs equal the JAX package's loader's, and both sessions run
    (no ATE without ground truth)."""
    p1, _ = _written_log(tmp_path, "a.clf", 30, seed=0)
    p2, _ = _written_log(tmp_path, "b.clf", 24, seed=1)
    cfg_path = _cli_cfg(tmp_path, grid={"x0": -20.0, "y0": -20.0,
                                        "cell": 1.0, "nx": 40, "ny": 40,
                                        "overlap": 4},
                        use_loop_closure=True)
    jcfg = PipelineConfig.from_json(cfg_path)
    jp, jm, jo, jlen, jgt = jserve._load_sessions(
        argparse.Namespace(datasets=[p1, p2], max_scans=None), jcfg)
    seqs = serve.dataset_sessions(_torch_cfg(cfg_path), [p1, p2], None)
    tp, tm, to, tlen = serve.pad_sessions(seqs)
    assert jgt is None and tlen == jlen == [30, 24]
    for a, b in ((tp, jp), (tm, jm), (to, jo)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    res = serve.main(["--config", cfg_path, "--datasets", p1, p2,
                      "--device", "cpu"])
    assert res["sessions"] == 2 and res["scans_total"] == 54
    for rec in res["per_session"]:
        assert "ate_m" not in rec and rec["keyframes"] > 1
    assert np.isfinite(res["traj"]).all()


def test_cli_downsample_voxel(tmp_path, capsys):
    """``downsample_voxel`` through the CLI: the kept count printed and
    returned equals the JAX package's ``voxel_downsample`` on the same
    inputs, and the run uses the thinned mask."""
    cfg_path = _cli_cfg(tmp_path, downsample_voxel=0.5)
    out = _main(cfg_path, "--max-scans", "12", "--mode", "scan")
    cfg = _torch_cfg(cfg_path)
    a = argparse.Namespace(dataset=None, max_scans=12)
    pts, msk, _, _ = run._build_inputs(a, cfg, torch.device("cpu"))
    kept = int(np.asarray(jvoxel(jnp.asarray(pts.numpy()),
                                 jnp.asarray(msk.numpy()), 0.5)).sum())
    assert out["n_kept"] == kept < int(msk.sum())
    assert f"{kept} points kept" in capsys.readouterr().err
