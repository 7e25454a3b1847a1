"""The windowed path in every quad-table layout, the port against the JAX
package on the CPU: overlap-1 grids (``GridConfig.overlap = 1``,
``LoopConfig.local_overlap = 1``), compact bf16-pair tables
(``MatchConfig.compact_table = True``), and both. The JAX side is jitted
(an eager x64 ``pack_quad(compact=True)`` at overlap 4 can abort the
process).

Full rows are held in f64, as the published layout's tests hold them.
Compact tables are held in f32: a compact lane whose high bf16 half is 0
(an invalid cell, or ``i01 == 0``) is an f32 denormal, and the JAX
package's x64 ``pack_quad`` promotes the lanes to f64 through XLA's CPU
runtime, which flushes denormals to zero and so loses ``i00`` there
(ROADMAP C-w13, pinned by
:func:`test_x64_compact_table_flushes_denormal_lanes`).

``PYTHONPATH=. python tests/test_torch_layouts.py`` regenerates
``tests/data/torch_config1_box300_ref.json`` (config 1,
``run_odometry_windowed``) and ``tests/data/torch_layouts_box300_ref.json``
(``chip_smoke.LAYOUT_RUNS``, ``run_slam_windowed``): the JAX package's f32
and f64 ATE (and loops) on draws 0-2 of the port's box-world sequences,
with the sequences' hashes and dead-reckoning ATE, which ``chip_smoke.py``
gates the port's runs on the card against.
"""

import json
import sys
import tempfile
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
from ndtpu.ndt import grid as jgrid
from ndtpu.ndt import match as jmatch
from ndtpu.slam import odometry as jodo
from ndtpu.slam import pipeline as jpipe
from ndtpu_torch.data import synth as tsynth
from ndtpu_torch.eval.ate import ate_rmse
from ndtpu_torch.lie import se2
from ndtpu_torch.loop import closure as tclosure
from ndtpu_torch.ndt import grid as tgrid
from ndtpu_torch.ndt import match as tmatch
from ndtpu_torch.slam import odometry as todo
from ndtpu_torch.slam import pipeline as tpipe

torch.set_num_threads(2)

DATA = Path(__file__).parent / "data"
REF1 = DATA / "torch_config1_box300_ref.json"
REF_LAYOUTS = DATA / "torch_layouts_box300_ref.json"

#: (overlap, compact) of the layouts this slice adds; (4, False) is the
#: published layout, held by the other tests.
LAYOUTS = [(1, False), (4, True), (1, True)]
IDS = ["overlap1", "compact", "overlap1_compact"]
NDT = NDTMapConfig()


def _jax(a):
    return jnp.asarray(np.array(a))


def _t(a):
    return torch.as_tensor(np.array(a))


def _u32(a):
    """The bits of an f32 array as uint32."""
    return np.asarray(a, dtype=np.float32).view(np.uint32)


def _close(a, b, rtol=1e-12):
    """Within ``rtol`` of the larger of 1 and the reference's max |value|
    (the repo's f64 parity rule, ``test_torch_grid._close``)."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    scale = max(1.0, float(np.abs(b).max()))
    np.testing.assert_allclose(a, b, rtol=0, atol=rtol * scale)


def _compact_close(got, want):
    """Two f32 compact tables built from the same points by two packages:
    valid flags equal, means within rtol 1e-6, the bf16 inverse covariance
    entries within two bf16 steps (2^-7 of the value): each package's f32
    finalize rounds in its own order, and a one-ulp change of an entry
    moves its bf16 rounding now and then."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype == np.float32
    _close(got[:, 0::4], want[:, 0::4], 1e-6)
    _close(got[:, 1::4], want[:, 1::4], 1e-6)
    unpack = lambda lane: [x.numpy() for x in tgrid.unpack_bf16_pair(
        torch.as_tensor(np.ascontiguousarray(lane)))]
    (a00, a01), (a11, av) = unpack(got[:, 2::4]), unpack(got[:, 3::4])
    (b00, b01), (b11, bv) = unpack(want[:, 2::4]), unpack(want[:, 3::4])
    np.testing.assert_array_equal(av, bv)
    scale = np.maximum(np.abs(b00), np.abs(b11))       # the cell's icov
    for a, b in ((a00, b00), (a01, b01), (a11, b11)):
        assert np.all(np.abs(a - b) <= 2.0 ** -7 * scale)


def _grid(overlap):
    return GridConfig(x0=-16.0, y0=-16.0, cell=1.0, nx=32, ny=32,
                      overlap=overlap)


def _points(seed, n, half=14.0):
    """Clustered points snapped to 2^-16 m (f32 and f64 bin them alike)."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-half, half, (40, 2))
    p = centers[rng.integers(0, 40, n)] + rng.normal(0, 0.4, (n, 2))
    return np.round(p * 65536.0) / 65536.0, rng.random(n) > 0.05


@jax.jit
def _jax_add_points(stats, points, mask, weight):
    return jgrid.add_points(stats, points, mask, _grid(1), weight)


# -- K3 at overlap 1 ----------------------------------------------------------


@pytest.mark.parametrize("weights", ["ones", "signed"])
def test_overlap1_add_points_matches_jax_f64(weights):
    """The plain K3 at overlap 1 (``add_points``' segment sum) against the
    JAX package in f64, on top of non-empty statistics; and its
    fixed-point model within 2^-30 of each cell's magnitude."""
    g = _grid(1)
    base_p, base_m = _points(1, 3000)
    pts, mask = _points(2, 4000)
    w = (np.ones(4000) if weights == "ones"
         else np.where(np.arange(4000) % 3 == 0, -1.0, 1.0))
    base = tgrid.add_points(tgrid.empty_stats(g, torch.float64), _t(base_p),
                            _t(base_m), g)
    got = tgrid.add_points(base, _t(pts), _t(mask), g, weight=_t(w))
    jbase = jgrid.NDTStats(*(_jax(x) for x in base))
    want = _jax_add_points(jbase, _jax(pts), _jax(mask), _jax(w))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12,
                                   atol=1e-9)
    model = tgrid.halfcell_add_fixed_ref(base, _t(pts), _t(mask), _t(w), g)
    np.testing.assert_array_equal(model.n.numpy(), got.n.numpy())
    r = float(np.abs(pts).max())
    for k, (a, b) in enumerate(zip(model[1:], got[1:]), start=1):
        mag = (np.abs(base[k].numpy())
               + tgrid.add_points(tgrid.empty_stats(g, torch.float64),
                                  _t(pts), _t(mask), g)[0].numpy()
               .reshape(1, -1, *([1] * k)) * r ** k)
        err = np.abs(a.numpy() - b.numpy())
        assert np.all(err <= 2.0 ** -30 * mag + 1e-12)


def test_overlap1_fixed_model_order_free_and_cancelling():
    """The overlap-1 fixed-point model: the same bits under a permutation of
    the points, and a -1 copy of every point cancels its +1 copy exactly."""
    g = _grid(1)
    pts, mask = _points(3, 5000)
    p32, m = torch.as_tensor(pts, dtype=torch.float32), _t(mask)
    empty = tgrid.empty_stats(g, torch.float32)
    one = tgrid.halfcell_add_fixed_ref(empty, p32, m, 1.0, g)
    perm = torch.as_tensor(np.random.default_rng(4).permutation(5000))
    two = tgrid.halfcell_add_fixed_ref(empty, p32[perm], m[perm], 1.0, g)
    for a, b in zip(one, two):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    both = torch.cat([p32, p32])
    w = torch.cat([torch.ones(5000), -torch.ones(5000)])
    zero = tgrid.halfcell_add_fixed_ref(empty, both, torch.cat([m, m]), w, g)
    for a in zero:
        assert not bool(a.any())
    assert float(one.n.sum()) == float(mask.sum()
                                       - (np.abs(pts) >= 16.0).any(1)[mask]
                                       .sum())


# -- K4 and K8a: the tables ---------------------------------------------------


_jax_pack = jax.jit(lambda m, o, c: jgrid.pack_quad(m, _grid(o), compact=c),
                    static_argnums=(1, 2))
_jax_finalize = jax.jit(jgrid.finalize, static_argnums=(1,))


@pytest.mark.parametrize("overlap,compact", LAYOUTS, ids=IDS)
def test_finalize_pack_matches_jax(overlap, compact):
    """The tables against JAX ``pack_quad(finalize(stats))``. The layout
    (``pack_quad``) from the same Gaussians: full rows bit for bit in f64,
    compact rows bit for bit as uint32 in f32. The whole route from the
    statistics (``finalize_pack_ref``): full rows in f64 within 1e-9 of the
    table's max (each package's finalize rounds in its own order, and
    ``ss/n - mean^2`` cancels up to |mean|^2 / var ~ 1e4 on these 1 m
    cells 14 m out), compact rows in f32 by :func:`_compact_close`."""
    g = _grid(overlap)
    pts, mask = _points(5, 20000)
    if not compact:
        st = tgrid.add_points(tgrid.empty_stats(g, torch.float64), _t(pts),
                              _t(mask), g)
        jmap = _jax_finalize(jgrid.NDTStats(*(_jax(x) for x in st)), NDT)
        want = np.asarray(_jax_pack(jmap, overlap, False))
        same = tgrid.pack_quad(tgrid.NDTMap(*(_t(x) for x in jmap)), g)
        np.testing.assert_array_equal(same.numpy(), want)
        _close(tgrid.finalize_pack_ref(st, NDT, g, False).numpy(), want,
               1e-9)
        return
    st = tgrid.add_points(tgrid.empty_stats(g, torch.float32),
                          torch.as_tensor(pts, dtype=torch.float32),
                          _t(mask), g)
    jmap = _jax_finalize(jgrid.NDTStats(*(_jax(x) for x in st)), NDT)
    want = np.asarray(_jax_pack(jmap, overlap, True))
    got = tgrid.pack_quad(tgrid.NDTMap(*(_t(x) for x in jmap)), g, True)
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_array_equal(_u32(got.numpy()), _u32(want))
    _compact_close(tgrid.finalize_pack_ref(st, NDT, g, True), want)


_jax_local = jax.jit(jclosure.build_local_table, static_argnums=(2, 3, 4))


@pytest.mark.parametrize("overlap,compact", LAYOUTS, ids=IDS)
def test_write_local_tables_matches_jax(overlap, compact):
    """``write_local_tables_ref`` against JAX ``build_local_table`` for
    three keyframes written into slots 2, 0 and 3 of a 4-slot cache (slot
    1 untouched): full rows in f64 at rtol 1e-12, compact rows in f32 by
    :func:`_compact_close`."""
    loop = LoopConfig(local_half_extent=8.0, local_overlap=overlap)
    dt = torch.float32 if compact else torch.float64
    scans = [_points(10 + k, 360, half=7.0) for k in range(3)]
    pts = torch.stack([torch.as_tensor(p, dtype=dt) for p, _ in scans])
    msk = torch.stack([_t(m) for _, m in scans])
    cache = torch.full((4,) + tclosure.local_table_shape(loop, compact), 7.0,
                       dtype=dt)
    tclosure.write_local_tables_ref(cache, torch.tensor([2, 0, 3]),
                                    torch.ones(3, dtype=torch.bool), pts, msk,
                                    loop, NDT, compact)
    assert bool((cache[1] == 7.0).all())
    for k, slot in enumerate((2, 0, 3)):
        want = np.asarray(_jax_local(_jax(pts[k]), _jax(msk[k]), loop, NDT,
                                     compact))
        got = cache[slot].numpy()
        assert got.shape == want.shape
        if compact:
            _compact_close(got, want)
        else:
            _close(got, want)


# -- bf16 packing -------------------------------------------------------------


def _bf16_rne(u):
    """The kernels' ``__float2bfloat16_rn`` on uint32 words of finite f32
    values: round the low 16 bits away to nearest, ties to even."""
    u = u.astype(np.uint64)
    lsb = (u >> 16) & 1
    return (((u + 0x7FFF + lsb) >> 16) & 0xFFFF).astype(np.uint32)


def test_bf16_rounding_model_matches_torch():
    """A numpy model of round-to-nearest-even on uint32 words equals
    ``torch.to(bfloat16)`` on f32, on random words and on every kind of
    tie (the low half exactly 0x8000, with the kept half odd and even), and
    ``_pack_bf16_pair`` composes the halves with ``a`` low."""
    rng = np.random.default_rng(0)
    words = rng.integers(0, 2 ** 32, 200000, dtype=np.uint64).astype(np.uint32)
    words = words[np.isfinite(words.view(np.float32))]
    ties = ((words & 0xFFFF0000) | 0x8000).astype(np.uint32)
    below = ((words & 0xFFFF0000) | 0x7FFF).astype(np.uint32)
    for w in (words, ties, below):
        w = w[np.isfinite(((w.astype(np.uint64) + 0x10000) & 0xFFFFFFFF)
                          .astype(np.uint32).view(np.float32))]
        f = torch.as_tensor(w.view(np.float32))
        got = (f.to(torch.bfloat16).view(torch.int16).numpy()
               .astype(np.uint32) & 0xFFFF)
        np.testing.assert_array_equal(got, _bf16_rne(w))
    a = torch.as_tensor(words[:1000].view(np.float32))
    b = torch.as_tensor(words[1000:2000].view(np.float32))
    lane = tgrid._pack_bf16_pair(a, b).numpy().view(np.uint32)
    np.testing.assert_array_equal(lane & 0xFFFF, _bf16_rne(words[:1000]))
    np.testing.assert_array_equal(lane >> 16, _bf16_rne(words[1000:2000]))
    lo, hi = tgrid.unpack_bf16_pair(torch.as_tensor(lane.view(np.float32)))
    np.testing.assert_array_equal(lo.numpy().view(np.uint32),
                                  _bf16_rne(words[:1000]) << 16)
    np.testing.assert_array_equal(hi.numpy().view(np.uint32),
                                  _bf16_rne(words[1000:2000]) << 16)


def test_x64_compact_table_flushes_denormal_lanes():
    """ROADMAP C-w13: a compact lane whose high half is 0 (``i01 == 0`` in a
    valid cell, or any invalid cell) is an f32 denormal. The JAX package's
    x64 ``pack_quad`` promotes the lanes to f64 through XLA's CPU runtime,
    which flushes them: ``i00`` is lost there; the port's f64 table keeps
    it. In f32 both tables are equal, bit for bit."""
    g = _grid(1)
    rng = np.random.default_rng(7)
    c = g.n_cells
    i00 = rng.uniform(0.5, 4.0, (1, c))
    i01 = np.where(rng.random((1, c)) < 0.2, 0.0, rng.uniform(-1, 1, (1, c)))
    i11 = rng.uniform(0.5, 4.0, (1, c))
    icov = np.stack([np.stack([i00, i01], -1), np.stack([i01, i11], -1)], -2)
    valid = (rng.random((1, c)) < 0.7).astype(np.float64)
    mean = rng.uniform(-16, 16, (1, c, 2))
    zero_hi = (valid[0] > 0) & (i01[0] == 0)
    assert zero_hi.sum() > 10
    m64 = (mean, icov, valid)
    got = tgrid.pack_quad(tgrid.NDTMap(*(_t(x) for x in m64)), g, True)
    want = np.asarray(_jax_pack(jgrid.NDTMap(*(_jax(x) for x in m64)), 1,
                                True))
    assert got.dtype == torch.float64 and want.dtype == np.float64
    i00_port = tgrid.unpack_bf16_pair(got[:, 2])[0].numpy()
    i00_jax = np.asarray(jgrid.unpack_bf16_pair(_jax(want[:, 2]))[0])
    assert np.all(i00_port[zero_hi] > 0)         # kept by the port
    assert np.all(i00_jax[zero_hi] == 0)         # flushed in JAX x64
    np.testing.assert_array_equal(i00_port[~zero_hi & (valid[0] > 0)],
                                  i00_jax[~zero_hi & (valid[0] > 0)])
    m32 = tuple(x.astype(np.float32) for x in m64)
    got32 = tgrid.pack_quad(tgrid.NDTMap(*(_t(x) for x in m32)), g, True)
    want32 = np.asarray(_jax_pack(jgrid.NDTMap(*(_jax(x) for x in m32)), 1,
                                  True))
    np.testing.assert_array_equal(_u32(got32.numpy()), _u32(want32))


# -- K1 / lm_ndt: registration ------------------------------------------------


@pytest.fixture(scope="module")
def box():
    world = tsynth.box_world(11.0)
    traj = tsynth.rectangle_trajectory(41, half=7.0, step=0.2)
    return tsynth.make_sequence(world, traj, 90, 20.0, 0.1, seed=0,
                                odom_trans_std=0.04, odom_rot_std=0.01)


def _dtype(compact):
    """Compact tables are held in f32 (C-w13), full rows in f64."""
    return torch.float32 if compact else torch.float64


def _match_case(box, overlap, compact, grouped):
    """Lanes registering scans 20-27 of the box world against a map of
    scans 0-19 at their true poses (shared), or each against the local
    table of the scan before it (grouped over a 6-slot cache)."""
    dt = _dtype(compact)
    pts, msk = box.points.to(dt), box.mask
    gt = box.gt_poses.to(dt)
    rng = np.random.default_rng(8)
    noise = torch.as_tensor(rng.normal(0, [0.1, 0.1, 0.03], (8, 3)),
                            dtype=dt)
    mcfg = MatchConfig(compact_table=compact)
    q = torch.arange(20, 28)
    if not grouped:
        g = _grid(overlap)
        world = se2.transform(gt[:20], pts[:20]).reshape(-1, 2)
        st = tgrid.add_points(tgrid.empty_stats(g, dt), world,
                              msk[:20].reshape(-1), g)
        table = tgrid.finalize_pack_ref(st, NDT, g, compact)
        return pts[q], msk[q], table, gt[q] + noise, g, mcfg, None
    loop = LoopConfig(local_half_extent=10.0, local_overlap=overlap)
    src = torch.tensor([19, 21, 23, 25, 0, 0])
    tables = torch.zeros((6,) + tclosure.local_table_shape(loop, compact),
                         dtype=dt)
    tclosure.write_local_tables_ref(tables, torch.arange(4),
                                    torch.ones(4, dtype=torch.bool),
                                    pts[src[:4]], msk[src[:4]], loop, NDT,
                                    compact)
    group = torch.tensor([0, 0, 1, 1, 2, 2, 3, 3])
    rel = se2.between(gt[src[group]], gt[q])
    return (pts[q], msk[q], tables, rel + noise,
            tclosure.local_grid_config(loop), mcfg, group)


@pytest.mark.parametrize("grouped", [False, True], ids=["shared", "grouped"])
@pytest.mark.parametrize("overlap,compact", LAYOUTS, ids=IDS)
def test_match_batch_packed_matches_jax(box, overlap, compact, grouped):
    """``match_batch_packed`` (``lm_ndt_ref``; grouped over a table cache,
    as the loop verify calls it) against the JAX package's: full rows in
    f64 (poses atol 1e-9, iterations and converged flags equal), compact
    rows in f32 (poses within 1e-4, iterations within one on every lane
    and equal on 7 of 8)."""
    pts, msk, table, init, g, mcfg, group = _match_case(box, overlap,
                                                        compact, grouped)
    got = tmatch.match_batch_packed(pts, msk, table, init, g, mcfg,
                                    group=group)
    jfn = jax.jit(lambda p, m, t, i, gr: jmatch.match_batch_packed(
        p, m, t, i, g, mcfg, group=gr))
    want = jfn(_jax(pts), _jax(msk), _jax(table), _jax(init),
               None if group is None else _jax(group.to(torch.int32)))
    assert bool(got.converged.sum() >= 6)
    if not compact:
        np.testing.assert_allclose(got.pose.numpy(), np.asarray(want.pose),
                                   rtol=0, atol=1e-9)
        np.testing.assert_array_equal(got.n_iter.numpy(),
                                      np.asarray(want.n_iter))
        np.testing.assert_array_equal(got.converged.numpy(),
                                      np.asarray(want.converged))
        return
    np.testing.assert_allclose(got.pose.numpy(), np.asarray(want.pose),
                               rtol=0, atol=1e-4)
    d_it = np.abs(got.n_iter.numpy() - np.asarray(want.n_iter))
    assert d_it.max() <= 1 and (d_it == 0).sum() >= 7


def test_gated_verify_plain_route_in_layouts(box):
    """The loop verify's plain route (``verify_candidates_cached_flat`` on
    the CPU: the grouped registration, then ``_gate_and_pack``) against the
    JAX package's, in f64 at overlap 1 with full rows, and in f32 with
    compact rows (accept flags equal; poses within 1e-4)."""
    from ndtpu_torch.slam.keyframes import KeyframeStore
    from ndtpu.slam.keyframes import KeyframeStore as JStore

    for overlap, compact in LAYOUTS:
        dt = _dtype(compact)
        loop = LoopConfig(local_half_extent=10.0, local_overlap=overlap,
                          max_candidates=4, min_index_gap=5, radius=3.0)
        cap = 24
        pts, msk = box.points[:cap].to(dt), box.mask[:cap]
        tables = torch.zeros((cap,) + tclosure.local_table_shape(loop,
                                                                 compact),
                             dtype=dt)
        tclosure.write_local_tables_ref(tables, torch.arange(cap),
                                        torch.ones(cap, dtype=torch.bool),
                                        pts, msk, loop, NDT, compact)
        live = torch.arange(cap) < 18
        kf = KeyframeStore(poses=box.gt_poses[:cap].to(dt), points=pts,
                           masks=msk, live=live, n=torch.tensor(18),
                           tables=tables)
        jkf = JStore(*(_jax(x) for x in kf))
        q = torch.tensor([22, 23])
        noise = torch.as_tensor(np.random.default_rng(9).normal(
            0, [0.05, 0.05, 0.01], (2, 3)), dtype=dt)
        qpose = box.gt_poses[q].to(dt) + noise
        mcfg = MatchConfig(compact_table=compact)
        cands = tclosure.find_candidates(kf, qpose, q, loop)
        assert bool(cands.mask.sum() >= 4)
        got = tclosure.verify_candidates_cached_flat(
            kf, box.points[q].to(dt), box.mask[q], qpose, cands, loop, mcfg, q)
        jc = jclosure.LoopCandidates(*(_jax(x) for x in cands))
        want = jax.jit(lambda k, p, m, pose, c, qi:
                       jclosure.verify_candidates_cached_flat(
                           k, p, m, pose, c, loop, mcfg, qi))(
            jkf, _jax(box.points[q].to(dt)), _jax(box.mask[q]), _jax(qpose),
            jc, _jax(q))
        np.testing.assert_array_equal(got.accept.numpy(),
                                      np.asarray(want.accept))
        assert bool(got.accept.any())
        tol = 1e-4 if compact else 1e-9
        np.testing.assert_allclose(got.z.numpy(), np.asarray(want.z),
                                   rtol=0, atol=tol)


# -- the windowed path --------------------------------------------------------


def _odo_run(box, overlap, compact, package):
    dt = _dtype(compact)
    args = (box.points.to(dt), box.mask, box.odom.to(dt))
    kw = dict(window=8, passes=2)
    cfgs = (_grid(overlap), NDT, MatchConfig(compact_table=compact),
            KeyframeConfig(dist_thresh=0.5, angle_thresh=0.3, capacity=64))
    if package == "port":
        return todo.run_odometry_windowed(*args, *cfgs, **kw)
    run = jax.jit(lambda p, m, o: jodo.run_odometry_windowed(p, m, o, *cfgs,
                                                             **kw))
    return run(*(_jax(a) for a in args))


@pytest.mark.parametrize("overlap,compact", LAYOUTS, ids=IDS)
def test_run_odometry_windowed_matches_jax(box, overlap, compact):
    """Config 1's front end (41 scans, 90 beams, 32 x 32 at 1 m, W = 8, two
    passes): full rows in f64 (poses atol 1e-8, keyframes and iterations
    equal), compact rows against JAX f32 (keyframes equal, poses within 5
    cm and 20 mrad: the two packages' f32 finalize round in another order,
    which moves a bf16 entry of the tables now and then, and the
    registrations of a 90-beam scan follow; ATE within 1 cm of JAX's)."""
    got = _odo_run(box, overlap, compact, "port")
    want = _odo_run(box, overlap, compact, "jax")
    np.testing.assert_array_equal(got.is_keyframe.numpy(),
                                  np.asarray(want.is_keyframe))
    if not compact:
        np.testing.assert_allclose(got.poses.numpy(), np.asarray(want.poses),
                                   rtol=0, atol=1e-8)
        np.testing.assert_array_equal(got.n_iters.numpy(),
                                      np.asarray(want.n_iters))
        return
    d = _pose_diff(got.poses.numpy(), np.asarray(want.poses))
    assert d[:, :2].max() <= 5e-2 and d[:, 2].max() <= 2e-2, d.max(0)
    gt = box.gt_poses
    ate = [float(ate_rmse(torch.as_tensor(np.asarray(x)), gt))
           for x in (got.poses, want.poses)]
    assert abs(ate[0] - ate[1]) <= 1e-2, ate


def _pose_diff(a, b):
    """|a - b| per pose component, the angle wrapped into (-pi, pi]."""
    d = np.asarray(a, np.float64) - np.asarray(b, np.float64)
    d[..., 2] = (d[..., 2] + np.pi) % (2 * np.pi) - np.pi
    return np.abs(d)


def _loop_cfg(overlap, compact):
    """Config 3 cut to a 3.5 m square lap at 90 beams, where loops fire
    (``test_torch_pipeline._loop_cfg``), in the layout."""
    return PipelineConfig(
        grid=_grid(overlap),
        keyframe=KeyframeConfig(dist_thresh=0.5, angle_thresh=0.3,
                                capacity=64),
        solver=SolverConfig(inc_iters=2, pcg_max_iter=60, full_solve_every=4,
                            local_poses=12, local_factors=32),
        match=MatchConfig(compact_table=compact),
        loop=LoopConfig(min_index_gap=5, max_candidates=4,
                        local_half_extent=4.0, local_overlap=overlap),
        n_beams=90, use_loop_closure=True, window=8, window_passes=2)


@pytest.fixture(scope="module")
def lap():
    world = tsynth.box_world(11.0)
    traj = tsynth.rectangle_trajectory(57, half=1.75, step=0.25)
    return tsynth.make_sequence(world, traj, 90, 20.0, 0.1, seed=0,
                                odom_trans_std=0.04, odom_rot_std=0.01)


@pytest.mark.parametrize("overlap,compact", LAYOUTS, ids=IDS)
def test_run_slam_windowed_with_loops_matches_jax(lap, overlap, compact):
    """The windowed SLAM with loop closure on the 3.5 m lap: full rows in
    f64 (poses and smoothed graph atol 1e-8; keyframes, loops and takes
    equal), compact rows against JAX f32 (keyframes and loop counts equal,
    trajectories within 1 cm and 10 mrad)."""
    cfg = _loop_cfg(overlap, compact)
    dt = _dtype(compact)
    args = (lap.points.to(dt), lap.mask, lap.odom.to(dt))
    st, outs = tpipe.run_slam_windowed(*args, cfg)
    run = jax.jit(lambda p, m, o: jpipe.run_slam_windowed(p, m, o, cfg))
    jst, jouts = run(*(_jax(a) for a in args))
    assert int(st.n_loops) > 0 and int(st.n_loops) == int(jst.n_loops)
    for f in ("is_keyframe", "n_loops_new", "kf_idx"):
        np.testing.assert_array_equal(getattr(outs, f).numpy(),
                                      np.asarray(getattr(jouts, f)), f)
    traj = tpipe.recover_trajectory(st, outs).numpy()
    jtraj = np.asarray(jpipe.recover_trajectory(jst, jouts))
    if not compact:
        np.testing.assert_array_equal(outs.local_take.numpy(),
                                      np.asarray(jouts.local_take))
        np.testing.assert_allclose(st.graph.poses.numpy(),
                                   np.asarray(jst.graph.poses), rtol=0,
                                   atol=1e-8)
        np.testing.assert_allclose(traj, jtraj, rtol=0, atol=1e-8)
        return
    d = _pose_diff(traj, jtraj)
    assert d[:, :2].max() <= 1e-2 and d[:, 2].max() <= 1e-2, d.max(0)


# -- the JAX references of chip_smoke.py --------------------------------------


def _chip_smoke():
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    return chip_smoke


def _jax_draws(run, n_beams: int, n_scans: int, loops: bool):
    """The JAX package on draws 0-2 of the port-made box-world sequences,
    at f32 and f64: per draw the inputs' hashes, the ATE at each precision
    (and loops), and dead reckoning. ``run`` is a jitted ``(points, mask,
    odom) -> (trajectory, n_loops)``."""
    from ndtpu.eval.ate import ate_rmse as jate

    cs = _chip_smoke()
    draws = []
    for seed in (0, 1, 2):
        s = cs.box_sequence(seed, n_beams, n_scans=n_scans)
        draw = dict(seed=seed, sha256=cs.sequence_hashes(s))
        for x64, key in ((False, ""), (True, "_f64")):
            jax.config.update("jax_enable_x64", x64)
            dt = torch.float64 if x64 else torch.float32
            traj, n_loops = run(_jax(s.points.to(dt)), _jax(s.mask),
                                _jax(s.odom.to(dt)))
            draw[f"jax_ate{key}_m"] = float(jate(traj, _jax(
                s.gt_poses.to(dt))))
            if loops:
                draw[f"jax_n_loops{key}"] = int(n_loops)
        dr = cs.dead_reckoning(s.odom.double())
        draw["dead_reckoning_ate_m"] = float(ate_rmse(dr,
                                                      s.gt_poses.double()))
        draw["jax_fails_dead_reckoning"] = (
            draw["jax_ate_m"] >= 0.75 * draw["dead_reckoning_ate_m"])
        print(draw, file=sys.stderr)
        draws.append(draw)
    jax.config.update("jax_enable_x64", False)
    return draws


def regenerate_config1_reference(path=REF1):
    """Config 1 as published through ``run_odometry_windowed``."""
    cs = _chip_smoke()
    cfg = PipelineConfig.from_json(str(cs.CONFIG1))

    run = jax.jit(lambda p, m, o: (jodo.run_odometry_windowed(
        p, m, o, cfg.grid, cfg.ndt, cfg.match, cfg.keyframe,
        window=cfg.window, passes=cfg.window_passes,
        odom_gate=cfg.odom_gate).poses, 0))

    doc = dict(
        scenario=_scenario(300), n_scans=300,
        config="configs/config1_odometry.json",
        reference="ndtpu.slam.odometry.run_odometry_windowed (window, "
                  "passes, odom_gate from the config) under jax.jit on the "
                  "CPU at f32 (jax_ate_m, the gate's) and f64; regenerate "
                  "with PYTHONPATH=. python tests/test_torch_layouts.py",
        draws=_jax_draws(run, cfg.n_beams, 300, False))
    Path(path).write_text(json.dumps(doc, indent=1) + "\n")


def regenerate_layouts_reference(path=REF_LAYOUTS):
    """Each of ``chip_smoke.LAYOUT_RUNS`` through ``run_slam_windowed``."""
    cs = _chip_smoke()
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, config, _, changes in cs.LAYOUT_RUNS:
            cfg_path = Path(tmp) / f"{name}.json"
            cfg_path.write_text(json.dumps(cs.layout_json(cs.ROOT / config,
                                                          changes)))
            cfg = PipelineConfig.from_json(str(cfg_path))

            def fn(p, m, o, cfg=cfg):
                st, outs = jpipe.run_slam_windowed(p, m, o, cfg)
                return jpipe.recover_trajectory(st, outs), st.n_loops

            runs[name] = dict(config=config, changes=changes, n_scans=300,
                              draws=_jax_draws(jax.jit(fn), cfg.n_beams, 300,
                                               cfg.use_loop_closure))
    doc = dict(
        scenario=_scenario(300),
        reference="ndtpu.slam.pipeline.run_slam_windowed under jax.jit on "
                  "the CPU at f32 (jax_ate_m, jax_n_loops: the gates') and "
                  "f64, on the published config with only `changes` set; "
                  "regenerate with PYTHONPATH=. python "
                  "tests/test_torch_layouts.py",
        runs=runs)
    Path(path).write_text(json.dumps(doc, indent=1) + "\n")


def _scenario(n_scans: int) -> str:
    return (f"box_world(11), rectangle_trajectory({n_scans}, half=7, "
            "step=0.2), 360 beams, max_range 20, min_range 0.1, odometry "
            "noise 0.04 m / 0.01 rad; sequences from ndtpu_torch.data.synth."
            "make_sequence(seed)")


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    if sys.argv[1:] in ([], ["config1"]):
        regenerate_config1_reference()
    if sys.argv[1:] in ([], ["layouts"]):
        regenerate_layouts_reference()
