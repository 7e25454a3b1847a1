"""Stacked multi-session serving of ndtpu_torch against ndtpu (f64, CPU).

``python tests/test_torch_serve.py`` regenerates
``tests/data/torch_serving8_box300_ref.json``: the JAX package's stacked
serving run (``ndtpu.dist.slam_dp.run_sessions_stacked`` under
``serving_config``, capacity 160, on the CPU) of the 8 sessions that
``python -m ndtpu_torch.serve --config configs/config_serving.json
--sessions 8 --max-scans 300`` serves: per session the inputs' hashes, the
f32 and f64 ATE, loops and keyframes, and dead reckoning, which
``chip_smoke.py`` gates the port's card run against session by session.
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
                          MatchConfig, SolverConfig)
from ndtpu.config import PipelineConfig as JPipelineConfig
from ndtpu.dist import slam_dp as jdp
from ndtpu.graph import factors as jfct
from ndtpu.ndt import grid as jgrid
from ndtpu.slam import pipeline as jpipe
from ndtpu_torch import convert, serve
from ndtpu_torch.config import PipelineConfig
from ndtpu_torch.data import synth as tsynth
from ndtpu_torch.dist import slam_dp as tdp
from ndtpu_torch.eval.ate import ate_rmse
from ndtpu_torch.graph import factors as tfct
from ndtpu_torch.ndt import grid as tgrid
from ndtpu_torch.slam import odometry as todo
from ndtpu_torch.slam import pipeline as tpipe

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
SERVING = ROOT / "configs" / "config_serving.json"
REF = Path(__file__).parent / "data" / "torch_serving8_box300_ref.json"
REF_LAYOUTS = (Path(__file__).parent / "data"
               / "torch_serving8_layouts_box300_ref.json")


def _jax(a):
    return jnp.asarray(np.array(a))


def _np_recover(g_poses, kf_idx, rel):
    """The JAX package's serve.py trajectory recovery (numpy, ``[S, T,
    3]``), as ``ndtpu/serve.py`` writes it."""
    anchors = np.take_along_axis(g_poses, kf_idx[..., None], axis=1)
    c, sn = np.cos(anchors[..., 2]), np.sin(anchors[..., 2])
    traj = np.stack([
        anchors[..., 0] + c * rel[..., 0] - sn * rel[..., 1],
        anchors[..., 1] + sn * rel[..., 0] + c * rel[..., 1],
        np.arctan2(np.sin(anchors[..., 2] + rel[..., 2]),
                   np.cos(anchors[..., 2] + rel[..., 2])),
    ], axis=-1)
    return np.concatenate([g_poses[:, :1], traj], axis=1)



#: The quad-table layouts ``(overlap, compact)``: the published one, then
#: overlap-1 grids, compact bf16-pair rows, and both (``kernels.LAYOUTS``).
LAYOUTS = [(4, False), (1, False), (4, True), (1, True)]
LAYOUT_IDS = ["g4l8", "g1l8", "g4l4", "g1l4"]


def session_cfg(overlap: int = 4, compact: bool = False, **over):
    """The JAX package's serving test config (180 beams, capacity 256), in
    a table layout: ``overlap`` for the map and the local tables,
    ``compact`` rows."""
    base = dict(
        grid=GridConfig(x0=-14.0, y0=-14.0, cell=0.5, nx=56, ny=56,
                        overlap=overlap),
        keyframe=KeyframeConfig(dist_thresh=0.5, angle_thresh=0.3,
                                capacity=256),
        loop=LoopConfig(radius=3.0, min_index_gap=10, max_candidates=4,
                        local_half_extent=8.0, local_overlap=overlap),
        match=MatchConfig(compact_table=compact),
        solver=SolverConfig(inc_iters=2, pcg_max_iter=40),
        n_beams=180, max_range=20.0, window=8, window_passes=2,
        use_loop_closure=True)
    base.update(over)
    return JPipelineConfig(**base)


def box_sessions(lengths, base_seed: int = 40):
    """Port-made box-world sessions (f64), one lap size per session."""
    world = tsynth.box_world(11.0)
    seqs = []
    for k, n in enumerate(lengths):
        traj = tsynth.rectangle_trajectory(n, half=6.0 + 0.3 * k, step=0.2)
        s = tsynth.make_sequence(world, traj, 180, 20.0, 0.1,
                                 seed=base_seed + k, odom_trans_std=0.04,
                                 odom_rot_std=0.01)
        seqs.append(s._replace(points=s.points.double(),
                               odom=s.odom.double(),
                               gt_poses=s.gt_poses.double()))
    return seqs


def jax_stacked(points, mask, odom, cfg):
    return jax.jit(lambda p, m, o: jdp.run_sessions_stacked(p, m, o, cfg))(
        _jax(points), _jax(mask), _jax(odom))


def check_runs(tst, tout, jst, jout):
    """Graph poses within 1e-6 (m, rad); keyframes, loops, drops, the
    smoother's takes and every per-scan count equal."""
    np.testing.assert_allclose(tst.graph.poses.numpy(),
                               np.asarray(jst.graph.poses), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(tst.kf.n.numpy(), np.asarray(jst.kf.n))
    np.testing.assert_array_equal(tst.n_loops.numpy(),
                                  np.asarray(jst.n_loops))
    for f in ("kf_idx", "is_keyframe", "n_loops_new", "n_dropped",
              "n_innov_rej", "local_take"):
        np.testing.assert_array_equal(getattr(tout, f).numpy(),
                                      np.asarray(getattr(jout, f)), f)
    np.testing.assert_allclose(tout.pose.numpy(), np.asarray(jout.pose),
                               rtol=0, atol=1e-6)


#: name: (session lengths, cfg overrides). "loop" is one lap of the 6 m
#: rectangle and more at 0.2 m steps, where the laps close.
RUNS = {"equal": ((90, 90), {}), "unequal": ((90, 70), {}),
        "loop": ((260, 260), dict(keyframe=KeyframeConfig(
            dist_thresh=0.5, angle_thresh=0.3, capacity=160)))}


@pytest.fixture(scope="module", params=list(RUNS))
def stacked_run(request):
    lengths, over = RUNS[request.param]
    seqs = box_sessions(lengths)
    points, mask, odom, lens = serve.pad_sessions(seqs)
    jcfg = jdp.serving_config(session_cfg(**over))
    jst, jout = jax_stacked(points, mask, odom, jcfg)
    tst, tout = tdp.run_sessions_stacked(points, mask, odom,
                                         tdp.serving_config(
                                             session_cfg(**over)))
    return dict(name=request.param, seqs=seqs, lengths=lens, jax=(jst, jout),
                port=(tst, tout))


def test_run_sessions_stacked_matches_jax(stacked_run):
    """The slice end to end: ``run_sessions_stacked`` against the JAX
    package's on the same (padded) sessions, f64."""
    tst, tout = stacked_run["port"]
    jst, jout = stacked_run["jax"]
    check_runs(tst, tout, jst, jout)
    assert int(tout.n_dropped.sum()) == 0
    if stacked_run["name"] == "loop":
        assert int(tst.n_loops.max()) > 0
        assert bool((tout.n_loops_new.sum(1) > 0).any())
    if stacked_run["name"] == "unequal":
        # The padded tail of the short session registers nothing new.
        t = stacked_run["lengths"][1]
        assert not bool(tout.is_keyframe[1, t - 1:].any())


@pytest.mark.parametrize("overlap,compact", LAYOUTS[1:], ids=LAYOUT_IDS[1:])
def test_run_sessions_stacked_layouts_match_jax(overlap, compact):
    """Two 33-scan sessions (four stacked windows) through
    ``run_sessions_stacked`` against the JAX package's in the other table
    layouts: full rows in f64 by :func:`check_runs`; compact rows in f32
    (C-w13): keyframe flags and counts equal, graph poses and per-scan
    poses within 5 cm and 20 mrad, each session's ATE within 1 cm of
    JAX's (as ``test_torch_layouts`` holds the windowed odometry: the two
    packages' f32 finalize round in another order, which moves a bf16
    entry of the tables now and then, and the registrations follow)."""
    cfg = jdp.serving_config(session_cfg(
        overlap, compact, keyframe=KeyframeConfig(
            dist_thresh=0.5, angle_thresh=0.3, capacity=64)))
    seqs = box_sessions((33, 33))
    points, mask, odom, _ = serve.pad_sessions(seqs)
    if compact:
        points, odom = points.float(), odom.float()
    jst, jout = jax_stacked(points, mask, odom, cfg)
    tst, tout = tdp.run_sessions_stacked(points, mask, odom, cfg)
    assert tst.stats.n.shape[1] == overlap
    assert tst.kf.tables.shape[-1] == overlap * (4 if compact else 8)
    assert int(tout.n_dropped.sum()) == 0 and int(tst.kf.n.min()) > 4
    if not compact:
        check_runs(tst, tout, jst, jout)
        return
    np.testing.assert_array_equal(tst.kf.n.numpy(), np.asarray(jst.kf.n))
    np.testing.assert_array_equal(tout.is_keyframe.numpy(),
                                  np.asarray(jout.is_keyframe))
    from test_torch_layouts import _pose_diff

    for a, b in ((tst.graph.poses, jst.graph.poses), (tout.pose, jout.pose)):
        d = _pose_diff(a.numpy(), np.asarray(b))
        assert d[..., :2].max() <= 5e-2 and d[..., 2].max() <= 2e-2, d.max()
    traj = serve.trajectories(tst, tout).numpy()
    jtraj = _np_recover(np.asarray(jst.graph.poses), np.asarray(jout.kf_idx),
                        np.asarray(jout.rel))
    for k, seq in enumerate(seqs):
        gt = seq.gt_poses
        ate = [float(ate_rmse(torch.as_tensor(np.asarray(x[k], np.float64)),
                              gt)) for x in (traj, jtraj)]
        assert abs(ate[0] - ate[1]) <= 1e-2, (k, ate)


def test_trajectories_match_jax_serve_recovery(stacked_run):
    """``serve.trajectories`` (the shared ``pipeline.recover_trajectory``
    per session) equals ``ndtpu/serve.py``'s numpy recovery applied to the
    same state, and ATE per session is the JAX run's."""
    tst, tout = stacked_run["port"]
    traj = serve.trajectories(tst, tout).numpy()
    ref = _np_recover(tst.graph.poses.numpy(), tout.kf_idx.numpy(),
                      tout.rel.numpy())
    np.testing.assert_allclose(traj, ref, rtol=0, atol=1e-12)
    jst, jout = stacked_run["jax"]
    jtraj = _np_recover(np.asarray(jst.graph.poses), np.asarray(jout.kf_idx),
                        np.asarray(jout.rel))
    for k, (seq, t) in enumerate(zip(stacked_run["seqs"],
                                     stacked_run["lengths"])):
        a = float(ate_rmse(torch.as_tensor(traj[k, :t]), seq.gt_poses))
        b = float(ate_rmse(torch.as_tensor(jtraj[k, :t]), seq.gt_poses))
        assert abs(a - b) < 1e-6 and a < 0.15, (k, a, b)


def test_vmap_cond_hazards_and_serving_config():
    for cfg in (session_cfg(), JPipelineConfig.from_json(str(SERVING))):
        tc = PipelineConfig.from_json(str(SERVING)) if cfg.n_beams == 360 \
            else PipelineConfig(**{f.name: getattr(cfg, f.name)
                                   for f in dataclasses.fields(cfg)})
        assert tdp.vmap_cond_hazards(tc) == jdp.vmap_cond_hazards(cfg)
        assert tdp.vmap_cond_hazards(tc)
        for fast in (True, False):
            js = jdp.serving_config(cfg, fast=fast)
            ts = tdp.serving_config(tc, fast=fast)
            assert dataclasses.asdict(ts) == dataclasses.asdict(js)
            assert tdp.vmap_cond_hazards(ts) == []
    with pytest.raises(ValueError, match="serving_config"):
        tdp.run_sessions_stacked(torch.zeros(2, 9, 4, 2),
                                 torch.zeros(2, 9, 4, dtype=torch.bool),
                                 torch.zeros(2, 9, 3), session_cfg())


def test_auto_capacity_and_padding():
    cfg = PipelineConfig.from_json(str(SERVING))
    assert serve.auto_capacity(cfg, 300) == 160
    seqs = box_sessions((12, 9))
    points, mask, odom, lengths = serve.pad_sessions(seqs)
    assert lengths == [12, 9] and points.shape == (2, 12, 180, 2)
    assert not bool(mask[1, 9:].any()) and float(odom[1, 9:].abs().max()) == 0
    assert torch.equal(points[1, :9], seqs[1].points)


def _inert_state8(s: int, lam=1e-4, last=float("inf"), step=0):
    """The fields ``_smooth_stacked`` reads (lam, last step, counter); the
    rest are placeholders, as in the JAX package's test."""
    return dict(stats=None, kf=None, graph=None,
                sm_lam=np.full(s, lam), sm_last_delta=np.full(s, last),
                sm_step=np.full(s, step, np.int32), pose=np.zeros((s, 3)),
                last_kf_idx=np.zeros(s, np.int32),
                n_loops=np.zeros(s, np.int32), map_kf_poses=np.zeros((s, 1, 3)))


#: (any_kf8, need8) per case: every session needs an update, a mixed batch
#: (one keyframed session settled, one idle), and none (the skip of the
#: batch-level cond, here with keyframed sessions).
NEED = {"all": ((True, True, True), (True, True, True)),
        "mixed": ((True, True, False), (True, False, False)),
        "none": ((True, False, True), (False, False, False))}


@pytest.mark.parametrize("need", list(NEED))
def test_smooth_stacked_matches_jax(need):
    from test_torch_blocked_pcg import chain_graph, stack

    rng = np.random.default_rng(5)
    graph8 = stack([chain_graph(rng, n, z) for n, z in ((12, 0.05), (9, 0.3),
                                                       (14, 0.05))])
    cfg = session_cfg(solver=SolverConfig(inc_iters=2, pcg_max_iter=6,
                                          local_poses=0,
                                          full_solve_every=0))
    any_kf8, need8 = (np.array(f) for f in NEED[need])
    fields = _inert_state8(3, last=0.5)
    jstate = jpipe.SlamState(**{k: (None if v is None else jnp.asarray(v))
                                for k, v in fields.items()})
    jsm, jtake = jdp._smooth_stacked(jstate, graph8, jnp.asarray(any_kf8),
                                     jnp.asarray(need8), cfg)
    tstate = tpipe.SlamState(**{k: (None if v is None else
                                    torch.as_tensor(v).to(
                                        torch.long if v.dtype == np.int32
                                        else torch.float64))
                                for k, v in fields.items()})
    tgraph8 = convert.from_numpy(graph8)
    tsm, ttake = tdp._smooth_stacked(tstate, tgraph8, torch.as_tensor(any_kf8),
                                     torch.as_tensor(need8), cfg)
    np.testing.assert_allclose(tsm.graph.poses.numpy(),
                               np.asarray(jsm.graph.poses), rtol=0, atol=1e-9)
    for f in ("lam", "last_max_delta"):
        np.testing.assert_allclose(getattr(tsm, f).numpy(),
                                   np.asarray(getattr(jsm, f)), rtol=1e-9,
                                   atol=1e-12)
    np.testing.assert_array_equal(tsm.step.numpy(), np.asarray(jsm.step))
    np.testing.assert_array_equal(ttake.numpy(), np.asarray(jtake))
    # Sessions without need keep their poses bit for bit; with none, the
    # result is exactly the skip the host branch takes instead.
    for i in np.nonzero(~need8)[0]:
        assert torch.equal(tsm.graph.poses[i], tgraph8.poses[i])
    if need == "none":
        skip, take0 = tdp._skip_stacked(tstate, tgraph8,
                                        torch.as_tensor(any_kf8))
        for a, b in zip(jax.tree_util.tree_leaves(tuple(tsm)),
                        jax.tree_util.tree_leaves(tuple(skip))):
            assert torch.equal(a, b)
        assert torch.equal(ttake, take0)


def test_flat_graph_matches_jax():
    from test_torch_blocked_pcg import chain_graph, stack

    rng = np.random.default_rng(6)
    graph8 = stack([chain_graph(rng, n, 0.1) for n in (12, 5)])
    jflat = jdp._flat_graph(graph8)
    tflat = tdp._flat_graph(convert.from_numpy(graph8))
    for name, a, b in zip(tflat._fields, tflat, jflat):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), name)
    # Padded slots point at pose 0 of their own session, masked off; their
    # rows of the linearization are zero, so chi^2 adds up per session.
    (_, _, r), (_, rp) = tfct.linearize(tflat)
    assert float(r[~tflat.bet_mask].abs().max()) == 0.0
    assert float(rp[~tflat.prior_mask].abs().max()) == 0.0
    assert abs(float(tfct.chi2(tflat)) - float(jfct.chi2(jflat))) < 1e-9


def _two_sessions(overlap: int = 4, compact: bool = False):
    """Two 10-scan sessions and both packages' stacked initial states in a
    table layout; the port's is the JAX state carried across with
    ``convert.from_numpy``. Compact rows are held in f32 (ROADMAP C-w13:
    the JAX package's x64 ``pack_quad`` flushes a compact lane's
    denormals), full rows in f64."""
    cfg = jdp.serving_config(session_cfg(overlap, compact))
    seqs = box_sessions((10, 10), base_seed=80)
    points, mask, odom, _ = serve.pad_sessions(seqs)
    if compact:
        points, odom = points.float(), odom.float()
    init = jax.vmap(lambda p, m: jpipe.init_slam(cfg, p, m))
    if compact:             # an eager compact pack_quad can abort (C-w13)
        init = jax.jit(init)
    jstate = init(_jax(points[:, 0]), _jax(mask[:, 0]))
    tstate = convert.from_numpy(jstate)
    return cfg, points, mask, odom, jstate, tstate


@pytest.fixture(scope="module")
def two_sessions():
    return _two_sessions()


def test_convert_carries_stacked_states(two_sessions):
    """``from_numpy`` is structural: a JAX stacked state (leading S axis)
    becomes the port's, leaf for leaf, and back; it equals the port's own
    ``init_sessions``, and its sessions own separate table caches."""
    cfg, points, mask, _, jstate, tstate = two_sessions
    back = convert.to_numpy(tstate)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(jstate)):
        assert np.array_equal(a, np.asarray(b))
    own = tdp.init_sessions(points[:, 0], mask[:, 0], cfg)
    for name, a, b in zip(tstate._fields, tstate, own):
        for x, y in zip(jax.tree_util.tree_leaves(a),
                        jax.tree_util.tree_leaves(b)):
            np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=0,
                                       atol=1e-12, err_msg=name)
    assert tstate.kf.tables.shape[0] == 2
    assert tstate.kf.tables[0].data_ptr() != tstate.kf.tables[1].data_ptr()


@pytest.mark.parametrize("overlap,compact", LAYOUTS, ids=LAYOUT_IDS)
def test_frontend_stacked_matches_jax(two_sessions, overlap, compact):
    """The stacked front end (both passes: K4s' tables, the grouped
    registration, K3s' pass-2 maps, the keyframe flags) against the JAX
    package's from the same state, in each table layout: full rows in f64
    (poses atol 1e-9, Hessians rtol 1e-9), compact rows in f32 (keyframe
    flags equal, poses within 1e-4 m / rad: each package's f32 finalize
    rounds in its own order, which moves a bf16 entry now and then)."""
    cfg, points, mask, odom, jstate, tstate = (
        two_sessions if (overlap, compact) == (4, False)
        else _two_sessions(overlap, compact))
    w = cfg.window
    p, m, o = points[:, 1:1 + w], mask[:, 1:1 + w], odom[:, 1:1 + w]
    jposes, jres, jkf = jax.jit(jdp._frontend_stacked, static_argnames="cfg")(
        jstate, jstate.pose, _jax(p), _jax(m), _jax(o), cfg=cfg)
    tposes, tres, tkf = tdp._frontend_stacked(tstate, tstate.pose, p, m, o,
                                              cfg)
    np.testing.assert_array_equal(tkf.numpy(), np.asarray(jkf))
    if compact:
        assert tposes.dtype == torch.float32
        np.testing.assert_allclose(tposes.numpy(), np.asarray(jposes),
                                   rtol=0, atol=1e-4)
        return
    np.testing.assert_allclose(tposes.numpy(), np.asarray(jposes), rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(tres.hessian.numpy(),
                               np.asarray(jres.hessian), rtol=1e-9, atol=1e-6)
    np.testing.assert_array_equal(tres.converged.numpy(),
                                  np.asarray(jres.converged))


def test_stacked_window_step_from_jax_state(two_sessions):
    """One window from the carried-across JAX state: the new state's
    statistics, graph and counters within 1e-9 of the JAX step's."""
    cfg, points, mask, odom, jstate, tstate = two_sessions
    w = cfg.window
    p, m, o = points[:, 1:1 + w], mask[:, 1:1 + w], odom[:, 1:1 + w]
    (jst, _), jout = jax.jit(jdp._stacked_window_step,
                             static_argnames="cfg")(
        jstate, jstate.pose, _jax(p), _jax(m), _jax(o), cfg=cfg)
    tables = tstate.kf.tables.clone()
    (tst, _), tout = tdp._stacked_window_step(
        tstate._replace(kf=tstate.kf._replace(tables=tables)), tstate.pose,
        p, m, o, cfg)
    for name, a, b in zip(tst._fields, tst, jst):
        for x, y in zip(jax.tree_util.tree_leaves(a),
                        jax.tree_util.tree_leaves(b)):
            y = np.asarray(y)
            if x.dtype == torch.bool or not x.is_floating_point():
                np.testing.assert_array_equal(x.numpy(), y, name)
            else:
                np.testing.assert_allclose(x.numpy(), y, rtol=0,
                                           atol=1e-9 * max(1.0,
                                                           np.abs(y).max()),
                                           err_msg=name)
    np.testing.assert_array_equal(tout.is_keyframe.numpy(),
                                  np.asarray(jout.is_keyframe))


def test_kf_flags8_matches_kf_select():
    rng = np.random.default_rng(9)
    cfg = session_cfg()
    last = torch.as_tensor(rng.normal(0, 0.3, (4, 3)))
    poses = last[:, None] + torch.as_tensor(
        np.cumsum(rng.normal(0, 0.25, (4, 8, 3)), 1))
    flags = tdp._kf_flags8(last, poses, cfg)
    for i in range(4):
        ref, _ = todo.kf_select(last[i], poses[i], cfg.keyframe.dist_thresh,
                                cfg.keyframe.angle_thresh)
        assert torch.equal(flags[i], ref)


@pytest.mark.parametrize("overlap,compact", LAYOUTS, ids=LAYOUT_IDS)
@pytest.mark.parametrize("weights", ["scalar", "per_point"])
def test_stacked_map_ops_match_jax_vmap(weights, overlap, compact):
    """K3s' and K4s' plain twins (the per-map functions over S maps)
    against the JAX package's vmapped ``add_points`` and ``finalize`` +
    ``pack_quad`` over stacked statistics, in each table layout: the
    statistics in f64 (rtol 1e-12), full-row tables in f64 (1e-9), compact
    tables in f32 (``test_torch_layouts._compact_close``, C-w13); each
    stacked table equals its map's own K4 plain table bit for bit."""
    rng = np.random.default_rng(11)
    cfg = session_cfg(overlap, compact)
    grid = cfg.grid
    s, n = 3, 500
    pts = rng.uniform(-12, 12, (s, n, 2))
    msk = rng.random((s, n)) < 0.9
    base = rng.uniform(-12, 12, (s, 2000, 2))
    wts = (1.0 if weights == "scalar"
           else np.where(rng.random((s, n)) < 0.5, -1.0, 1.0))
    jstats = jax.vmap(lambda p: jgrid.add_points(
        jgrid.empty_stats(grid, jnp.float64), p, jnp.ones(2000, bool),
        grid))(_jax(base))
    if weights == "scalar":
        jout = jax.vmap(lambda st, p, m: jgrid.add_points(st, p, m, grid))(
            jstats, _jax(pts), _jax(msk))
    else:
        jout = jax.vmap(lambda st, p, m, w_: jgrid.add_points(
            st, p, m, grid, weight=w_))(jstats, _jax(pts), _jax(msk),
                                        _jax(wts))
    tstats = convert.from_numpy(jstats)
    tw = wts if weights == "scalar" else torch.as_tensor(wts)
    tout = tgrid.add_points_stacked(tstats, torch.as_tensor(pts),
                                    torch.as_tensor(msk), grid, weight=tw)
    for a, b in zip(tout, jout):
        assert a.shape == np.asarray(b).shape == (s, overlap) + a.shape[2:]
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12,
                                   atol=1e-9)
    if compact:
        from test_torch_layouts import _compact_close

        tout = tgrid.NDTStats(*(t.float() for t in tout))
        jout = jgrid.NDTStats(*(_jax(t) for t in tout))
    jtab = jax.jit(jax.vmap(lambda st: jgrid.pack_quad(
        jgrid.finalize(st, cfg.ndt), grid, compact=compact)))(jout)
    ttab = tgrid.finalize_pack_stacked(tout, cfg.ndt, grid, compact)
    lanes = 4 if compact else 8
    assert ttab.shape == np.asarray(jtab).shape == (
        s, int(np.prod(tgrid._quad_lattice(grid))), overlap * lanes)
    if compact:
        for i in range(s):
            _compact_close(ttab[i], np.asarray(jtab[i]))
    else:
        np.testing.assert_allclose(ttab.numpy(), np.asarray(jtab), rtol=1e-9,
                                   atol=1e-9)
    for i in range(s):
        one = tgrid.finalize_pack(tgrid.NDTStats(*(t[i] for t in tout)),
                                  cfg.ndt, grid, compact)
        assert torch.equal(ttab[i].view(torch.int32 if compact
                                        else torch.int64),
                           one.view(torch.int32 if compact else torch.int64))


@pytest.mark.parametrize("enable", [True, False])
def test_refresh_map_enable_matches_jax(stacked_run_equal, enable):
    """``_refresh_map(..., enable=)`` against the JAX package's on a real
    session state whose keyframes moved; ``enable=False`` is a no-op."""
    tst = stacked_run_equal
    cfg = jdp.serving_config(session_cfg())
    st = tdp._take(tst, 0)
    rng = np.random.default_rng(12)
    shift = torch.as_tensor(rng.normal(0.0, 0.05, st.map_kf_poses.shape))
    mkp = st.map_kf_poses + shift * st.kf.live[:, None].double()
    jkf = jax.tree_util.tree_map(jnp.asarray, convert.to_numpy(st.kf))
    jstats = jax.tree_util.tree_map(jnp.asarray, convert.to_numpy(st.stats))
    js, jm = jpipe._refresh_map(jstats, jkf, _jax(mkp), cfg,
                                enable=jnp.asarray(enable))
    ts, tm = tpipe._refresh_map(st.stats, st.kf, mkp, cfg,
                                enable=torch.tensor(enable))
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=0, atol=0)
    for a, b in zip(ts, js):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12,
                                   atol=1e-9)
    if not enable:
        assert torch.equal(tm, mkp)
        for a, b in zip(ts, st.stats):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                       atol=1e-9)


@pytest.fixture(scope="module")
def stacked_run_equal():
    seqs = box_sessions((41, 41))
    points, mask, odom, _ = serve.pad_sessions(seqs)
    st, _ = tdp.run_sessions_stacked(points, mask, odom,
                                     tdp.serving_config(session_cfg()))
    return st


def test_sessions_from_one_first_scan_keep_their_own_tables():
    """ROADMAP C-w7: two sessions that start from an identical first scan
    (identical initial states) and then step different windows. Each
    session's keyframe table cache, graph and keyframes equal its own
    single-session run's: no session's K8a writes reach the other's."""
    cfg = tdp.serving_config(session_cfg(keyframe=KeyframeConfig(
        dist_thresh=0.5, angle_thresh=0.3, capacity=64)))
    seqs = box_sessions((41, 41))
    points, mask, odom, _ = serve.pad_sessions(seqs)
    points[1, 0], mask[1, 0] = points[0, 0], mask[0, 0]
    st, out = tdp.run_sessions_stacked(points, mask, odom, cfg)
    assert int(st.kf.n[0]) > 1 and int(st.kf.n[1]) > 1
    assert torch.equal(st.kf.tables[0, 0], st.kf.tables[1, 0])
    assert not torch.equal(st.kf.tables[0, 1], st.kf.tables[1, 1])
    for k in range(2):
        s1, o1 = tpipe.run_slam_windowed(points[k], mask[k], odom[k], cfg)
        assert int(s1.kf.n) == int(st.kf.n[k])
        assert torch.equal(s1.kf.tables, st.kf.tables[k])
        assert torch.equal(o1.is_keyframe, out.is_keyframe[k])
        np.testing.assert_allclose(s1.graph.poses.numpy(),
                                   st.graph.poses[k].numpy(), rtol=0,
                                   atol=1e-9)


def test_serve_cli_runs_on_cpu(tmp_path, monkeypatch, capsys):
    """``python -m ndtpu_torch.serve --device cpu --sessions 2 --max-scans
    40`` at the serving config's width: the summary, the trajectory files,
    and trajectories equal to ``ndtpu/serve.py``'s numpy recovery of the
    same (last) run's state."""
    runs = []
    real = tdp.run_sessions_stacked

    def recorded(*a, **k):
        runs.append(real(*a, **k))
        return runs[-1]

    monkeypatch.setattr(tdp, "run_sessions_stacked", recorded)
    res = serve.main(["--config", str(SERVING), "--device", "cpu",
                      "--sessions", "2", "--max-scans", "40", "--out-dir",
                      str(tmp_path)])
    assert len(runs) == 4                     # one first run, then 3
    st, outs = runs[-1]
    ref = _np_recover(st.graph.poses.numpy(), outs.kf_idx.numpy(),
                      outs.rel.numpy())
    np.testing.assert_allclose(res["traj"], ref, rtol=0, atol=1e-5)
    assert res["capacity"] == 32 and res["sessions"] == 2
    assert res["aggregate_scans_per_s"] > 0
    for rec in res["per_session"]:
        assert rec["dropped"] == 0 and rec["keyframes"] > 1
        assert rec["ate_m"] < 0.15
        assert np.loadtxt(tmp_path / f"traj_{rec['session']}.txt").shape \
            == (40, 3)
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed["per_session"] == res["per_session"]
    assert (tmp_path / "serve_metrics.json").is_file()


def test_serve_unported_and_missing_card():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serve.main(["--config", str(SERVING), "--sessions", "1",
                        "--max-scans", "9"])


def _serving_runs(config, sessions: int, n_scans: int):
    """The JAX package (CPU; f32, then f64) on the port's serving sessions
    at ``config`` (a JSON path) under ``serving_config``: ``(per-session
    records, capacity)``."""
    from ndtpu.eval.ate import ate_rmse as jate

    sys.path.insert(0, str(ROOT))
    import chip_smoke

    tcfg = PipelineConfig.from_json(str(config))
    seqs = serve.synthetic_sessions(tcfg, sessions, n_scans)
    points, mask, odom, lengths = serve.pad_sessions(seqs)
    cap = serve.auto_capacity(tcfg, points.shape[1])
    runs = {}
    for name, x64 in (("f32", False), ("f64", True)):
        jax.config.update("jax_enable_x64", x64)
        dt = np.float64 if x64 else np.float32
        cfg = jdp.serving_config(JPipelineConfig.from_json(str(config)))
        cfg = dataclasses.replace(
            cfg, keyframe=dataclasses.replace(cfg.keyframe, capacity=cap))
        run = jax.jit(lambda p, m, o: jdp.run_sessions_stacked(p, m, o, cfg))
        st, outs = run(jnp.asarray(points.numpy().astype(dt)),
                       jnp.asarray(mask.numpy()),
                       jnp.asarray(odom.numpy().astype(dt)))
        traj = _np_recover(np.asarray(st.graph.poses),
                           np.asarray(outs.kf_idx), np.asarray(outs.rel))
        runs[name] = dict(
            ate=[float(jate(jnp.asarray(traj[k, :lengths[k]]),
                            _jax(seqs[k].gt_poses.numpy().astype(dt))))
                 for k in range(sessions)],
            loops=np.asarray(st.n_loops).tolist(),
            keyframes=np.asarray(st.kf.n).tolist(),
            dropped=np.asarray(outs.n_dropped).sum(1).tolist())
        print(config, name, runs[name], file=sys.stderr, flush=True)
    jax.config.update("jax_enable_x64", True)
    per = []
    for k, s in enumerate(seqs):
        dr = chip_smoke.dead_reckoning(s.odom.double())
        per.append(dict(
            session=k, sha256=chip_smoke.sequence_hashes(s),
            **{f"jax_{name}": dict(ate_m=runs[name]["ate"][k],
                                   loops=runs[name]["loops"][k],
                                   keyframes=runs[name]["keyframes"][k],
                                   dropped=runs[name]["dropped"][k])
               for name in ("f32", "f64")},
            dead_reckoning_ate_m=float(ate_rmse(dr, s.gt_poses.double()))))
    return per, cap


def _serving_scenario(sessions: int, n_scans: int) -> str:
    return (f"{sessions} sessions x {n_scans} scans from "
            "ndtpu_torch.serve.synthetic_sessions (box_world(11), "
            "rectangle laps of half 6 + 0.2 k m at 0.2 m steps, seed "
            "cfg.seed + 20 + k, 360 beams, odometry noise 0.04 m / "
            "0.01 rad)")


def regenerate_serving_reference(path=REF, sessions: int = 8,
                                 n_scans: int = 300):
    """Run the JAX package (CPU; f32, then f64) on the port's serving
    sessions and write the per-session reference file."""
    per, cap = _serving_runs(SERVING, sessions, n_scans)
    doc = dict(
        scenario=_serving_scenario(sessions, n_scans),
        config="configs/config_serving.json under serving_config(), "
               f"keyframe capacity {cap}",
        reference="ndtpu.dist.slam_dp.run_sessions_stacked under jax.jit "
                  "on the CPU at f32 and at f64, trajectories by "
                  "ndtpu/serve.py's recovery; regenerate with python "
                  "tests/test_torch_serve.py",
        sessions=per)
    Path(path).write_text(json.dumps(doc, indent=1) + "\n")


def regenerate_serving_layouts_reference(path=REF_LAYOUTS,
                                         sessions: int = 8,
                                         n_scans: int = 300):
    """The same, per run of ``chip_smoke.SERVING_LAYOUT_RUNS``: the serving
    config with only the run's fields changed (written to a temporary
    JSON, as the smoke writes it), which ``chip_smoke.py`` phase 10b gates
    the card's runs against session by session."""
    import tempfile

    sys.path.insert(0, str(ROOT))
    import chip_smoke

    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, changes in chip_smoke.SERVING_LAYOUT_RUNS:
            cfg_path = Path(tmp) / f"{name}.json"
            cfg_path.write_text(json.dumps(chip_smoke.layout_json(SERVING,
                                                                  changes)))
            per, cap = _serving_runs(cfg_path, sessions, n_scans)
            runs[name] = dict(changes=changes, capacity=cap, sessions=per)
    doc = dict(
        scenario=_serving_scenario(sessions, n_scans),
        config="configs/config_serving.json under serving_config() with "
               "only each run's `changes` set",
        reference="ndtpu.dist.slam_dp.run_sessions_stacked under jax.jit "
                  "on the CPU at f32 and at f64, trajectories by "
                  "ndtpu/serve.py's recovery; regenerate with python "
                  "tests/test_torch_serve.py layouts",
        runs=runs)
    Path(path).write_text(json.dumps(doc, indent=1) + "\n")


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    if sys.argv[1:] in ([], ["serving"]):
        regenerate_serving_reference()
    if sys.argv[1:] in ([], ["layouts"]):
        regenerate_serving_layouts_reference()
