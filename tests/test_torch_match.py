"""ndtpu_torch.ndt.match against ndtpu.ndt.match on the same f64 inputs:
the K1 twin against lookup_quad + point_terms_quad, and the batched LM
registration (one-phase and two-phase) per lane."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndtpu.config import GridConfig, MatchConfig, NDTMapConfig
from ndtpu.data import synth as jsynth
from ndtpu.lie import se2 as jse2
from ndtpu.ndt import grid as jgrid
from ndtpu.ndt import match as jmatch
from ndtpu_torch.ndt import grid as tgrid
from ndtpu_torch.ndt import match as tmatch

torch.set_num_threads(2)

GRID = GridConfig(x0=-14.0, y0=-14.0, cell=1.0, nx=28, ny=28, overlap=4)
NDT = NDTMapConfig()


def _t(a):
    return torch.as_tensor(np.array(a))


@pytest.fixture(scope="module")
def scene():
    """A 20-scan map of the box world and 24 perturbed registrations."""
    world = jsynth.box_world(11.0)
    traj = jsynth.rectangle_trajectory(48, half=7.0, step=0.2,
                                       dtype=jnp.float64)
    seq = jsynth.make_sequence(world, traj, n_beams=90, max_range=20.0,
                               min_range=0.1, seed=0)
    pts = np.asarray(seq.points, np.float64)
    mask = np.asarray(seq.mask)
    gt = np.asarray(traj)
    wpts = np.asarray(jse2.transform(jnp.asarray(gt[:20]),
                                     jnp.asarray(pts[:20]))).reshape(-1, 2)
    stats = jgrid.build_stats(jnp.asarray(wpts),
                              jnp.asarray(mask[:20].reshape(-1)), GRID)
    rng = np.random.default_rng(1)
    lanes = np.arange(20, 44)
    init = gt[lanes] + rng.normal(0, [0.15, 0.15, 0.04], (24, 3))
    init[3] = [40.0, 40.0, 0.0]              # fully out of the map
    m = mask[lanes].copy()
    m[5] = False                             # no valid beams
    return dict(stats=stats, pts=pts[lanes], mask=m, init=init)


def _tables(scene, compact=False):
    mj = jgrid.finalize(scene["stats"], NDT)
    qj = jgrid.pack_quad(mj, GRID, compact=compact)
    st = tgrid.NDTStats(*(_t(a) for a in scene["stats"]))
    qt = tgrid.pack_quad(tgrid.finalize(st, NDT), GRID, compact=compact)
    return qj, qt


def _rel_close(a, b, tol):
    a, b = np.asarray(a), np.asarray(b)
    scale = np.maximum(1.0, np.abs(b).max(axis=tuple(range(1, b.ndim)),
                                          keepdims=True)) if b.ndim else 1.0
    assert np.all(np.abs(a - b) <= tol * scale), np.abs(a - b).max()


def test_ndt_terms_ref_matches_lookup_and_point_terms(scene):
    qj, qt = _tables(scene)
    poses = scene["init"]
    px, py = scene["pts"][..., 0], scene["pts"][..., 1]
    mask_f = scene["mask"].astype(np.float64)
    sums = tmatch.ndt_terms_ref(_t(poses), _t(px), _t(py), _t(mask_f), qt,
                                GRID, 0.5, 40.0)
    # JAX: the composition inside match_batch_packed.make_sgh.
    cfg = MatchConfig()
    p = jnp.asarray(poses)
    c, s = jnp.cos(p[:, 2])[:, None], jnp.sin(p[:, 2])[:, None]
    x = c * px - s * py + p[:, 0, None]
    y = s * px + c * py + p[:, 1, None]
    rows, inb = jgrid.lookup_quad(qj, x, y, GRID)
    f, g, h, wsum, w0sum = jmatch.point_terms_quad(
        p, x, y, -s * px - c * py, c * px - s * py, rows,
        jnp.asarray(mask_f) * inb, cfg, 4)
    tf, tg, th, tws, tw0 = tmatch._assemble(sums, cfg.d2)
    for a, b in [(tf, f), (tg, g), (th, h), (tws, wsum), (tw0, w0sum)]:
        _rel_close(a.numpy(), b, 1e-10)


def test_point_terms_quad_compact(scene):
    """bf16-pair rows, in f32 on both sides (the JAX package packs compact
    tables from f32 Gaussians; the tables are bit-exact, see
    test_torch_grid)."""
    mj = jgrid.NDTMap(*(x.astype(jnp.float32)
                        for x in jgrid.finalize(scene["stats"], NDT)))
    qj = jgrid.pack_quad(mj, GRID, compact=True)
    qt = _t(qj)
    cfg = MatchConfig(compact_table=True)
    f32 = lambda a: np.asarray(a, np.float32)
    p = f32(scene["init"])
    px, py = f32(scene["pts"][..., 0]), f32(scene["pts"][..., 1])
    c, s = np.cos(p[:, 2])[:, None], np.sin(p[:, 2])[:, None]
    x, y = c * px - s * py + p[:, :1], s * px + c * py + p[:, 1:2]
    dpx, dpy = -s * px - c * py, c * px - s * py
    rows_j, inb_j = jgrid.lookup_quad(qj, jnp.asarray(x), jnp.asarray(y), GRID)
    rows_t, inb_t = tgrid.lookup_quad(qt, _t(x), _t(y), GRID)
    np.testing.assert_array_equal(inb_t.numpy(), np.asarray(inb_j))
    wm = f32(scene["mask"])
    out_j = jmatch.point_terms_quad(jnp.asarray(p), x, y, dpx, dpy, rows_j,
                                    wm * np.asarray(inb_j, np.float32), cfg, 4)
    out_t = tmatch.point_terms_quad(_t(p), _t(x), _t(y), _t(dpx), _t(dpy),
                                    rows_t, _t(wm) * inb_t, cfg, 4)
    for a, b in zip(out_t, out_j):
        _rel_close(a.numpy(), b, 1e-5)


def test_solve3_and_transform_terms():
    rng = np.random.default_rng(2)
    a = rng.normal(size=(16, 3, 3)) + 3 * np.eye(3)
    b = rng.normal(size=(16, 3))
    np.testing.assert_allclose(tmatch.solve3(_t(a), _t(b)).numpy(),
                               np.asarray(jmatch.solve3(a, b)), atol=1e-12)
    pose, pts = np.array([0.3, -1.2, 0.7]), rng.normal(size=(30, 2))
    for x, y in zip(tmatch.transform_terms(_t(pose), _t(pts)),
                    jmatch.transform_terms(jnp.asarray(pose), pts)):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), atol=1e-12)


def _check_result(rt, rj):
    np.testing.assert_array_equal(rt.n_iter.numpy(), np.asarray(rj.n_iter))
    np.testing.assert_array_equal(rt.converged.numpy(),
                                  np.asarray(rj.converged))
    np.testing.assert_allclose(rt.pose.numpy(), np.asarray(rj.pose),
                               rtol=0, atol=1e-8)
    _rel_close(rt.hessian.numpy(), rj.hessian, 1e-8)
    _rel_close(rt.score.numpy(), rj.score, 1e-8)


@pytest.mark.parametrize("phase2_width", [0, 8], ids=["one_phase",
                                                      "two_phase"])
def test_match_batch_packed_per_lane(scene, phase2_width):
    qj, qt = _tables(scene)
    cfg = MatchConfig(phase2_width=phase2_width, phase1_iters=4)
    rj = jmatch.match_batch_packed(jnp.asarray(scene["pts"]),
                                   jnp.asarray(scene["mask"]), qj,
                                   jnp.asarray(scene["init"]), GRID, cfg)
    rt = tmatch.match_batch_packed(_t(scene["pts"]), _t(scene["mask"]), qt,
                                   _t(scene["init"]), GRID, cfg)
    _check_result(rt, rj)
    assert not bool(rt.converged[3]) and int(rt.n_iter[5]) == 0


def test_two_phase_equals_one_phase(scene):
    _, qt = _tables(scene)
    args = (_t(scene["pts"]), _t(scene["mask"]), qt, _t(scene["init"]), GRID)
    r1 = tmatch.match_batch_packed(*args, MatchConfig())
    r2 = tmatch.match_batch_packed(*args, MatchConfig(phase2_width=5,
                                                      phase1_iters=3))
    for a, b in zip(r1, r2):
        assert torch.equal(a, b)


def test_match_and_match_batch(scene):
    cfg = dataclasses.replace(MatchConfig(), max_iter=12)
    mj = jgrid.finalize(scene["stats"], NDT)
    mt = tgrid.NDTMap(*(_t(a) for a in mj))
    rj = jmatch.match_batch(jnp.asarray(scene["pts"][:6]),
                            jnp.asarray(scene["mask"][:6]), mj,
                            jnp.asarray(scene["init"][:6]), GRID, cfg)
    rt = tmatch.match_batch(_t(scene["pts"][:6]), _t(scene["mask"][:6]), mt,
                            _t(scene["init"][:6]), GRID, cfg)
    _check_result(rt, rj)
    one_t = tmatch.match(_t(scene["pts"][0]), _t(scene["mask"][0]), mt,
                         _t(scene["init"][0]), GRID, cfg)
    one_j = jmatch.match(jnp.asarray(scene["pts"][0]),
                         jnp.asarray(scene["mask"][0]), mj,
                         jnp.asarray(scene["init"][0]), GRID, cfg)
    np.testing.assert_allclose(one_t.pose.numpy(), np.asarray(one_j.pose),
                               atol=1e-8)
    assert int(one_t.n_iter) == int(one_j.n_iter)


def test_ndt_terms_wrapper_uses_twin_on_cpu(scene):
    from ndtpu_torch import kernels

    _, qt = _tables(scene)
    kernels.reset_launches()
    args = (_t(scene["init"]), _t(scene["pts"][..., 0]),
            _t(scene["pts"][..., 1]), _t(scene["mask"].astype(np.float64)),
            qt, GRID, 0.5, 40.0)
    assert torch.equal(tmatch.ndt_terms(*args), tmatch.ndt_terms_ref(*args))
    assert kernels.LAUNCHES["ndt_terms"] == 0
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.ndt_terms(*args)


@pytest.fixture(scope="module")
def stacked(scene):
    """Three maps (scans 0-19, 6-25, 12-31 of the lap) as a stack of quad
    tables [3, R, L], and a random table per lane."""
    world = jsynth.box_world(11.0)
    traj = jsynth.rectangle_trajectory(48, half=7.0, step=0.2,
                                       dtype=jnp.float64)
    seq = jsynth.make_sequence(world, traj, n_beams=90, max_range=20.0,
                               min_range=0.1, seed=0)
    pts = np.asarray(seq.points, np.float64)
    gt = np.asarray(traj)
    tables = []
    for lo in (0, 6, 12):
        w = np.asarray(jse2.transform(jnp.asarray(gt[lo:lo + 20]),
                                      jnp.asarray(pts[lo:lo + 20])))
        st = jgrid.build_stats(jnp.asarray(w.reshape(-1, 2)), jnp.asarray(
            np.asarray(seq.mask)[lo:lo + 20].reshape(-1)), GRID)
        tables.append(jgrid.pack_quad(jgrid.finalize(st, NDT), GRID))
    group = np.random.default_rng(8).integers(0, 3, 24)
    return jnp.stack(tables), group


@pytest.mark.parametrize("phase2_width", [0, 8], ids=["one_phase",
                                                      "two_phase"])
@pytest.mark.parametrize("layout", ["per_lane", "grouped"])
def test_match_batch_packed_stacked_tables(scene, stacked, layout,
                                           phase2_width):
    """Per-lane [B, R, L] tables and grouped [S, R, L] tables with
    ``group [B]`` against JAX, lane by lane."""
    qj, group = stacked
    cfg = MatchConfig(phase2_width=phase2_width, phase1_iters=4)
    args = (scene["pts"], scene["mask"])
    if layout == "per_lane":
        tj, gj, tt, gt = qj[group], None, _t(qj[group]), None
    else:
        tj, gj, tt, gt = qj, jnp.asarray(group, jnp.int32), _t(qj), _t(group)
    rj = jmatch.match_batch_packed(*map(jnp.asarray, args), tj,
                                   jnp.asarray(scene["init"]), GRID, cfg,
                                   group=gj)
    rt = tmatch.match_batch_packed(*map(_t, args), tt, _t(scene["init"]),
                                   GRID, cfg, group=gt)
    _check_result(rt, rj)
    # The grouped/per-lane twin is a shared-table lookup per lane.
    lane = 7
    one = tmatch.match_batch_packed(_t(scene["pts"][lane:lane + 1]),
                                    _t(scene["mask"][lane:lane + 1]),
                                    _t(qj[group[lane]]),
                                    _t(scene["init"][lane:lane + 1]), GRID,
                                    MatchConfig())
    np.testing.assert_allclose(one.pose[0].numpy(), rt.pose[lane].numpy(),
                               rtol=0, atol=1e-12)


def test_two_phase_terminates_with_capped_lanes(scene):
    """Repair (ROADMAP C-r1): with more than ``phase2_width`` lanes stopped
    at the iteration cap unconverged, the two-phase loop kept picking those
    lanes and never ended. It now ends with the one-phase loop's results."""
    import signal

    _, qt = _tables(scene)
    rng = np.random.default_rng(9)
    init = scene["init"] + rng.normal(0, [0.5, 0.5, 0.1], (24, 3))
    args = (_t(scene["pts"]), _t(scene["mask"]), qt, _t(init), GRID)
    r1 = tmatch.match_batch_packed(*args, MatchConfig(max_iter=3))
    capped = int(((r1.n_iter == 3) & ~r1.converged).sum())
    assert capped > 2

    def stuck(*_):
        raise TimeoutError("the two-phase loop did not end")

    old = signal.signal(signal.SIGALRM, stuck)
    signal.alarm(60)
    try:
        r2 = tmatch.match_batch_packed(*args, MatchConfig(
            max_iter=3, phase2_width=2, phase1_iters=1))
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)
    for a, b in zip(r1, r2):
        assert torch.equal(a, b)
