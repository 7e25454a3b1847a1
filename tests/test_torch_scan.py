"""The per-scan path of ndtpu_torch against ndtpu: ``run_slam`` and
``slam_step`` (with and without loop closure), ``run_odometry``, the
per-query cached verify (``detect_loops_cached``) and the fresh-map verify
(``detect_loops``), in f64 on the CPU (the JAX side jitted), and the
per-scan step's ownership of the table cache (ROADMAP C-w7).

``PYTHONPATH=. python tests/test_torch_scan.py`` regenerates
``tests/data/torch_scan_box300_ref.json``: the JAX package's per-scan
``run_slam`` (CPU, f32 and f64) on draws 0-2 of the port's box-world
sequences at configs 2 and 3, with the sequences' hashes, ATE, loops and
dead reckoning, which ``chip_smoke.py`` gates the port's per-scan runs on
the card against.
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
                          MatchConfig, NDTMapConfig, PipelineConfig,
                          SolverConfig)
from ndtpu.loop import closure as jclosure
from ndtpu.slam import keyframes as jkfs
from ndtpu.slam import odometry as jodo
from ndtpu.slam import pipeline as jpipe
from ndtpu_torch.data import synth as tsynth
from ndtpu_torch.eval.ate import ate_rmse
from ndtpu_torch.loop import closure as tclosure
from ndtpu_torch.slam import keyframes as tkfs
from ndtpu_torch.slam import odometry as todo
from ndtpu_torch.slam import pipeline as tpipe

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
REF_SCAN = Path(__file__).parent / "data" / "torch_scan_box300_ref.json"


def _jax(a):
    return jnp.asarray(np.array(a))


def _chip_smoke():
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    return chip_smoke


def _scenario(n_scans: int) -> str:
    return (f"box_world(11), rectangle_trajectory({n_scans}, half=7, "
            "step=0.2), 360 beams, max_range 20, min_range 0.1, odometry "
            "noise 0.04 m / 0.01 rad; sequences from ndtpu_torch.data.synth."
            "make_sequence(seed)")


def regenerate_scan_reference(path=REF_SCAN, n_scans: int = 300):
    """JAX ``run_slam`` (per scan) on box-world draws 0-2 at configs 2 and
    3, f32 (the gates') and f64."""
    from ndtpu.eval.ate import ate_rmse as jate

    cs = _chip_smoke()
    runs = {}
    for name, config in (("config2", cs.CONFIG2), ("config3", cs.CONFIG3)):
        cfg = PipelineConfig.from_json(str(config))

        def fn(p, m, o, cfg=cfg):
            st, outs = jpipe.run_slam(p, m, o, cfg)
            return jpipe.recover_trajectory(st, outs), st.n_loops

        run = jax.jit(fn)
        draws = []
        for seed in (0, 1, 2):
            s = cs.box_sequence(seed, cfg.n_beams, n_scans=n_scans)
            draw = dict(seed=seed, sha256=cs.sequence_hashes(s))
            for x64, key in ((False, ""), (True, "_f64")):
                jax.config.update("jax_enable_x64", x64)
                dt = torch.float64 if x64 else torch.float32
                traj, n_loops = run(_jax(s.points.to(dt)), _jax(s.mask),
                                    _jax(s.odom.to(dt)))
                draw[f"jax_ate{key}_m"] = float(jate(traj, _jax(
                    s.gt_poses.to(dt))))
                draw[f"jax_n_loops{key}"] = int(n_loops)
            dr = cs.dead_reckoning(s.odom.double())
            draw["dead_reckoning_ate_m"] = float(ate_rmse(
                dr, s.gt_poses.double()))
            draw["jax_fails_dead_reckoning"] = (
                draw["jax_ate_m"] >= 0.75 * draw["dead_reckoning_ate_m"])
            print(name, draw, file=sys.stderr, flush=True)
            draws.append(draw)
        jax.config.update("jax_enable_x64", False)
        runs[name] = dict(config=str(Path(config).relative_to(cs.ROOT)),
                          n_scans=n_scans, draws=draws)
    doc = dict(
        scenario=_scenario(n_scans),
        reference="ndtpu.slam.pipeline.run_slam (the per-scan path) under "
                  "jax.jit on the CPU at f32 (jax_ate_m, jax_n_loops: the "
                  "gates') and f64; regenerate with PYTHONPATH=. python "
                  "tests/test_torch_scan.py",
        runs=runs)
    Path(path).write_text(json.dumps(doc, indent=1) + "\n")


def _np(a):
    return np.asarray(a)


def _loop_cfg(**over) -> PipelineConfig:
    """``tests/test_pipeline.py``'s loop scenario config."""
    base = dict(
        grid=GridConfig(x0=-12.0, y0=-12.0, cell=1.0, nx=24, ny=24,
                        overlap=4),
        ndt=NDTMapConfig(), match=MatchConfig(),
        keyframe=KeyframeConfig(dist_thresh=0.6, angle_thresh=0.3,
                                capacity=128),
        loop=LoopConfig(radius=3.0, min_index_gap=8, max_candidates=4,
                        score_gate=0.30, local_half_extent=8.0,
                        local_cell=1.0),
        solver=SolverConfig(inc_iters=2, pcg_max_iter=60),
        use_loop_closure=True)
    base.update(over)
    return PipelineConfig(**base)


@pytest.fixture(scope="module")
def loop_seq():
    """``tests/test_pipeline.py``'s loop sequence (box world 9 m, 135 scans
    x 180 beams) from the port's synth, in f64."""
    world = tsynth.box_world(half=9.0)
    traj = tsynth.rectangle_trajectory(135, half=6.0, step=0.2)
    s = tsynth.make_sequence(world, traj, n_beams=180, max_range=15.0,
                             min_range=0.1, seed=3, range_noise=0.01,
                             odom_trans_std=0.05, odom_rot_std=0.01)
    return s._replace(points=s.points.double(), odom=s.odom.double(),
                      gt_poses=s.gt_poses.double())


_JAX_RUNS = {}


def _jax_run_slam(seq, cfg):
    """JAX ``run_slam`` under ``jax.jit`` (one compile per config)."""
    if cfg not in _JAX_RUNS:
        _JAX_RUNS[cfg] = jax.jit(lambda p, m, o: jpipe.run_slam(p, m, o,
                                                                cfg))
    st, outs = _JAX_RUNS[cfg](_jax(seq.points), _jax(seq.mask),
                              _jax(seq.odom))
    return (jax.tree_util.tree_map(_np, st),
            jax.tree_util.tree_map(_np, outs))


def _rel_close(got, ref, rtol):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    scale = max(np.abs(ref).max(), 1e-30)
    np.testing.assert_allclose(got, ref, rtol=0, atol=rtol * scale)


@pytest.mark.parametrize("loops", [True, False], ids=["loops", "no_loops"])
def test_run_slam_matches_jax(loop_seq, loops):
    """Per scan: the same keyframe, loop, drop and take decisions; poses
    within 1e-8; the final graph and map within 1e-9 relative."""
    cfg = _loop_cfg(use_loop_closure=loops)
    jst, jouts = _jax_run_slam(loop_seq, cfg)
    st, outs = tpipe.run_slam(loop_seq.points, loop_seq.mask, loop_seq.odom,
                              cfg)
    for f in ("is_keyframe", "kf_idx", "n_loops_new", "local_take",
              "n_dropped", "n_innov_rej"):
        np.testing.assert_array_equal(getattr(outs, f).numpy(),
                                      getattr(jouts, f), err_msg=f)
    if loops:
        assert int(st.n_loops) == int(jst.n_loops) > 0
    np.testing.assert_allclose(outs.pose.numpy(), jouts.pose, rtol=0,
                               atol=1e-8)
    np.testing.assert_allclose(outs.rel.numpy(), jouts.rel, rtol=0,
                               atol=1e-8)
    g, jg = st.graph, jst.graph
    assert int(g.n_poses) == int(jg.n_poses)
    assert int(g.n_between) == int(jg.n_between)
    for f in ("pose_mask", "bet_i", "bet_j", "bet_mask"):
        np.testing.assert_array_equal(getattr(g, f).numpy(), getattr(jg, f))
    for f in ("poses", "bet_z", "bet_sqrt_info"):
        _rel_close(getattr(g, f).numpy(), getattr(jg, f), 1e-9)
    for a, b in zip(st.stats, jst.stats):
        _rel_close(a.numpy(), b, 1e-9)
    _rel_close(st.map_kf_poses.numpy(), jst.map_kf_poses, 1e-9)
    traj = tpipe.recover_trajectory(st, outs)
    jtraj = _np(jpipe.recover_trajectory(jst, jouts))
    np.testing.assert_allclose(traj.numpy(), jtraj, rtol=0, atol=1e-8)
    assert abs(float(ate_rmse(traj, loop_seq.gt_poses))
               - float(ate_rmse(torch.as_tensor(jtraj.copy()),
                                loop_seq.gt_poses))) < 1e-8


def test_run_odometry_matches_jax(loop_seq):
    cfg = _loop_cfg()
    args = (cfg.grid, cfg.ndt, cfg.match, cfg.keyframe)
    ref = jax.jit(lambda p, m, o: jodo.run_odometry(p, m, o, *args))(
        _jax(loop_seq.points), _jax(loop_seq.mask), _jax(loop_seq.odom))
    got = todo.run_odometry(loop_seq.points, loop_seq.mask, loop_seq.odom,
                            *args)
    for f in ("is_keyframe", "n_iters", "converged"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      _np(getattr(ref, f)), err_msg=f)
    np.testing.assert_allclose(got.poses.numpy(), _np(ref.poses), rtol=0,
                               atol=1e-8)
    np.testing.assert_allclose(got.scores.numpy(), _np(ref.scores), rtol=0,
                               atol=1e-8)
    for a, b in zip(got.stats, ref.stats):
        _rel_close(a.numpy(), b, 1e-9)


# ---------------------------------------------------------------------------
# The loop verifies, at tests/test_loop.py's and
# tests/test_map_maintenance.py:116's cases (stores built by the port).

LINE_LOOP = LoopConfig(radius=4.0, min_index_gap=3, max_candidates=4,
                       score_gate=0.3, local_half_extent=8.0, local_cell=0.8)
MAINT_LOOP = LoopConfig(radius=4.0, min_index_gap=8, max_candidates=4,
                        local_half_extent=8.0)


def _store(poses, points, masks, capacity, loop_cfg):
    """The port's keyframe store (with its local-table cache) of the given
    keyframes, and the same store as the JAX package's."""
    n_beams = points.shape[1]
    shape = tclosure.local_table_shape(loop_cfg, False)
    kf = tkfs.empty_store(capacity, n_beams, torch.float64,
                          table_shape=shape)
    for p, x, m in zip(poses, points, masks):
        kf = tkfs.add_keyframe(kf, p, x, m,
                               table=tclosure.build_local_table(
                                   x, m, loop_cfg, NDTMapConfig(), False))
    jkf = jkfs.KeyframeStore(
        poses=_jax(kf.poses), points=_jax(kf.points), masks=_jax(kf.masks),
        live=_jax(kf.live), n=jnp.asarray(int(kf.n), jnp.int32),
        tables=_jax(kf.tables))
    return kf, jkf


def _scan(world, pose, angles, seed):
    rng = np.random.default_rng(seed)
    r = tsynth.simulate_scans(world, pose[None], angles, 15.0, 0.005, rng)[0]
    return tsynth.polar_to_xy(r, angles, 0.1, 15.0)


def _line_case():
    """``tests/test_loop.py``: 8 keyframes marching +x, exact poses; a
    query near keyframe 2 at a drifted belief, query index 8."""
    world = tsynth.World(tsynth.box_world(half=10.0).segments.double())
    angles = tsynth.beam_angles(180, dtype=torch.float64)
    poses = [torch.tensor([k - 4.0, 0.0, 0.0], dtype=torch.float64)
             for k in range(8)]
    scans = [_scan(world, p, angles, k) for k, p in enumerate(poses)]
    kf, jkf = _store(poses, torch.stack([s[0] for s in scans]),
                     torch.stack([s[1] for s in scans]), 12, LINE_LOOP)
    true_pose = torch.tensor([-1.7, 0.2, 0.1], dtype=torch.float64)
    qpts, qmsk = _scan(world, true_pose, angles, 99)
    drifted = true_pose + torch.tensor([0.25, -0.2, 0.05],
                                       dtype=torch.float64)
    return kf, jkf, qpts, qmsk, drifted, 8


def _maint_case():
    """``tests/test_map_maintenance.py:116``: 50 keyframes (every second
    scan of a 100-scan lap), the query at scan 90, query index 45."""
    world = tsynth.box_world(half=10.0)
    traj = tsynth.rectangle_trajectory(100, half=3.5, step=0.35,
                                       dtype=torch.float64)
    seq = tsynth.make_sequence(world, traj, n_beams=180, max_range=20.0,
                               min_range=0.1, seed=3)
    kf, jkf = _store(seq.gt_poses[0:100:2], seq.points[0:100:2],
                     seq.mask[0:100:2], 60, MAINT_LOOP)
    q = 90
    qpose = seq.gt_poses[q] + torch.tensor([0.05, -0.04, 0.01],
                                           dtype=torch.float64)
    return kf, jkf, seq.points[q], seq.mask[q], qpose, 45


_CASES = {"line": (_line_case, LINE_LOOP), "maint": (_maint_case, MAINT_LOOP)}
_KNOBS = dict(verify_max_iter=2, verify_beam_stride=3)


@pytest.fixture(scope="module")
def loop_cases():
    return {k: fn() for k, (fn, _) in _CASES.items()}


@pytest.mark.parametrize("case,route,over", [
    ("line", "fresh", {}), ("line", "fresh_w0", {}), ("line", "cached", {}),
    ("line", "fresh", dict(max_accept_per_query=1)),
    ("maint", "fresh_w0", {}), ("maint", "cached", {}),
    ("maint", "cached", _KNOBS), ("maint", "fresh", _KNOBS),
], ids=["line-fresh", "line-fresh_w0", "line-cached", "line-fresh-budget1",
        "maint-fresh_w0", "maint-cached", "maint-cached-knobs",
        "maint-fresh-knobs"])
def test_detect_loops_matches_jax(loop_cases, case, route, over):
    """``detect_loops`` (fresh local maps, window 1 or 0) and
    ``detect_loops_cached`` (per query) against the JAX package. With the
    serving knobs set, both routes ignore them, as the JAX package's
    per-query routes do."""
    kf, jkf, qpts, qmsk, qpose, qidx = loop_cases[case]
    loop = dataclasses.replace(_CASES[case][1], **over)
    ncfg, mcfg = NDTMapConfig(), MatchConfig()
    jq = (jkf, _jax(qpts), _jax(qmsk), _jax(qpose),
          jnp.asarray(qidx, jnp.int32))
    tq = (kf, qpts, qmsk, qpose, torch.tensor(qidx))
    if route == "cached":
        ref = jax.jit(lambda *a: jclosure.detect_loops_cached(
            *a, loop, mcfg))(*jq)
        got = tclosure.detect_loops_cached(*tq, loop, mcfg)
    else:
        w = 0 if route == "fresh_w0" else 1
        ref = jax.jit(lambda *a: jclosure.detect_loops(
            *a, loop, ncfg, mcfg, window=w))(*jq)
        got = tclosure.detect_loops(*tq, loop, ncfg, mcfg, window=w)
    for f in ("j", "accept", "innov_rej"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      _np(getattr(ref, f)), err_msg=f)
    assert got.accept.any()
    if over.get("max_accept_per_query") == 1:
        assert int(got.accept.sum()) == 1
    for f in ("z", "score", "sqrt_info"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   _np(getattr(ref, f)), rtol=1e-8,
                                   atol=1e-8, err_msg=f)


def _f32_case(kf, jkf, qpts, qpose):
    """A loop case's float leaves in f32 (compact rows are held in f32,
    ROADMAP C-w13)."""
    f32 = lambda t: t.float() if t.is_floating_point() else t
    kf = type(kf)(*(f32(t) for t in kf))
    jkf = type(jkf)(*(x.astype(jnp.float32)
                      if jnp.issubdtype(x.dtype, jnp.floating) else x
                      for x in jkf))
    return kf, jkf, qpts.float(), qpose.float()


@pytest.mark.parametrize("case", ["line", "maint"])
@pytest.mark.parametrize("overlap,compact", [(1, False), (4, True),
                                             (1, True)],
                         ids=["g1l8", "g4l4", "g1l4"])
def test_fresh_verify_in_layouts_matches_jax(loop_cases, case, overlap,
                                             compact):
    """The fresh-map verify (``detect_loops``: ``find_candidates``, then
    ``verify_candidates`` with its K3s maps, K4s tables and gated grouped
    registration) against the JAX package's in the other table layouts
    (``local_overlap = 1``, compact rows, both): full rows in f64 (as the
    published layout's test: candidates, accept and rejection flags equal,
    z, scores and information within 1e-8), compact rows in f32
    (candidates and flags equal, z within 1e-4 m / rad, scores within
    1e-3 of their value, information within 1e-3 of its largest entry:
    bf16 table entries)."""
    kf, jkf, qpts, qmsk, qpose, qidx = loop_cases[case]
    if compact:
        kf, jkf, qpts, qpose = _f32_case(kf, jkf, qpts, qpose)
    loop = dataclasses.replace(_CASES[case][1], local_overlap=overlap)
    ncfg, mcfg = NDTMapConfig(), MatchConfig(compact_table=compact)
    jq = (jkf, _jax(qpts), _jax(qmsk), _jax(qpose),
          jnp.asarray(qidx, jnp.int32))
    ref = jax.jit(lambda *a: jclosure.detect_loops(*a, loop, ncfg, mcfg,
                                                   window=1))(*jq)
    got = tclosure.detect_loops(kf, qpts, qmsk, qpose, torch.tensor(qidx),
                                loop, ncfg, mcfg, window=1)
    for f in ("j", "accept", "innov_rej"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      _np(getattr(ref, f)), err_msg=f)
    assert got.accept.any()
    big = float(np.abs(_np(ref.sqrt_info)).max())
    tol = dict(z=(0, 1e-4), score=(1e-3, 0), sqrt_info=(0, 1e-3 * big)) \
        if compact else dict(z=(1e-8, 1e-8), score=(1e-8, 1e-8),
                             sqrt_info=(1e-8, 1e-8))
    for f, (rtol, atol) in tol.items():
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   _np(getattr(ref, f)), rtol=rtol,
                                   atol=atol, err_msg=f)


def test_per_query_verify_is_the_flat_verify_without_knobs(loop_cases):
    """The per-query cached verify equals the flat verify at K = 1 when no
    serving knob is set, and ignores the knobs where the flat one applies
    them."""
    kf, _, qpts, qmsk, qpose, qidx = loop_cases["maint"]
    mcfg = MatchConfig()
    one = tclosure.detect_loops_cached(kf, qpts, qmsk, qpose,
                                       torch.tensor(qidx), MAINT_LOOP, mcfg)
    flat = tclosure.detect_loops_cached_flat(
        kf, qpts[None], qmsk[None], qpose[None], torch.tensor([qidx]),
        MAINT_LOOP, mcfg)
    for a, b in zip(one, flat):
        assert torch.equal(a, b[0])
    knobs = dataclasses.replace(MAINT_LOOP, **_KNOBS)
    one_k = tclosure.detect_loops_cached(kf, qpts, qmsk, qpose,
                                         torch.tensor(qidx), knobs, mcfg)
    flat_k = tclosure.detect_loops_cached_flat(
        kf, qpts[None], qmsk[None], qpose[None], torch.tensor([qidx]), knobs,
        mcfg)
    for a, b in zip(one, one_k):
        assert torch.equal(a, b)
    assert not torch.equal(flat_k.z[0], one_k.z)


def _clone_state(st):
    return st._replace(kf=st.kf._replace(tables=st.kf.tables.clone()))


def test_slam_step_table_cache_per_copy(loop_seq):
    """ROADMAP C-w7 for the per-scan branch: two copies of one state step
    different scans; each copy's cache holds, in every live slot, the local
    table of that copy's own keyframe, and the original is untouched."""
    cfg = _loop_cfg()
    p, m, o = loop_seq.points, loop_seq.mask, loop_seq.odom
    st = tpipe.init_slam(cfg, p[0], m[0])
    for t in range(1, 20):
        st, _ = tpipe.slam_step(st, p[t], m[t], o[t], cfg)
    before = st.kf.tables.clone()
    a, b = _clone_state(st), _clone_state(st)
    for t in range(20, 35):
        a, _ = tpipe.slam_step(a, p[t], m[t], o[t], cfg)
    for t in range(60, 75):     # other scans, from the same state
        b, _ = tpipe.slam_step(b, p[t], m[t], o[t],
                               cfg)
    assert torch.equal(st.kf.tables, before)
    n0 = int(st.kf.n)
    assert int(a.kf.n) > n0 and int(b.kf.n) > n0
    assert not torch.equal(a.kf.tables[n0], b.kf.tables[n0])
    for s in (a, b):
        for k in range(int(s.kf.n)):
            ref = tclosure.build_local_table(s.kf.points[k], s.kf.masks[k],
                                             cfg.loop, cfg.ndt, False)
            assert torch.equal(s.kf.tables[k], ref), k
        assert not s.kf.tables[int(s.kf.n):].any()


def test_scan_reference_matches_the_sequences():
    """``torch_scan_box300_ref.json`` was made from the port's box-world
    draws at 300 scans (hash of draw 0), and JAX closed loops on config 3's
    draws."""
    cs = _chip_smoke()
    doc = json.loads(REF_SCAN.read_text())
    run3 = doc["runs"]["config3"]
    assert all(d["jax_n_loops"] > 0 for d in run3["draws"])
    d0 = doc["runs"]["config2"]["draws"][0]
    assert cs.sequence_hashes(cs.box_sequence(0, 360)) == d0["sha256"]


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    regenerate_scan_reference()
