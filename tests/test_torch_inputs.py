"""The port's inputs against the JAX package: K13's plain version
(``voxel_downsample_ref``), K11's (``raycast_ref``) in f64 and f32 (also
past the segment count the first K11 refused), a numpy model of K11's
rejection test against the plain version bit for bit, the CARMEN reader
and writer (logs written by each package, read by both), the native parser
against the Python one, and the native orderings. The CUDA wrappers take
their plain versions on CPU tensors and the kernels refuse CPU tensors."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from ndtpu.data import carmen as jcarmen
from ndtpu.data import preprocess as jpre
from ndtpu.data import synth as jsynth
from ndtpu_torch import kernels, native
from ndtpu_torch.data import carmen as tcarmen
from ndtpu_torch.data import preprocess as tpre
from ndtpu_torch.data import synth as tsynth

torch.set_num_threads(2)

_JV = jax.jit(jpre.voxel_downsample, static_argnums=2)


def _voxel_case(name):
    """``tests/test_preprocess.py``'s three cases."""
    rng = np.random.default_rng(0 if name == "one_per_cell" else 1)
    if name == "one_per_cell":
        return (rng.uniform(-5, 5, (400, 2)).astype(np.float32),
                rng.random(400) > 0.1, 0.5)
    if name == "batched":
        return (rng.uniform(-3, 3, (4, 128, 2)).astype(np.float32),
                np.ones((4, 128), bool), 0.25)
    pts = np.stack([np.linspace(0.0, 0.09, 50), np.zeros(50)],
                   -1).astype(np.float32)
    return pts, np.ones(50, bool), 1.0


@pytest.mark.parametrize("name", ["one_per_cell", "batched", "coarse"])
def test_voxel_downsample_matches_jax_on_preprocess_cases(name):
    pts, msk, voxel = _voxel_case(name)
    ref = np.asarray(_JV(jnp.asarray(pts), jnp.asarray(msk), voxel))
    got = tpre.voxel_downsample(torch.as_tensor(pts), torch.as_tensor(msk),
                                voxel)
    np.testing.assert_array_equal(got.numpy(), ref)
    if name == "coarse":
        assert int(got.sum()) == 1 and bool(got[0])


@pytest.fixture(scope="module")
def box300():
    return chip_smoke.box_sequence(0, 360)


@pytest.mark.parametrize("voxel", [0.05, 0.1, 0.5])
def test_voxel_downsample_matches_jax_on_box_world(box300, voxel):
    """300 x 360 box-world scans: the same masks, and the plain version
    keeps the lowest-index valid point of each voxel (K13's rule)."""
    ref = np.asarray(_JV(jnp.asarray(box300.points.numpy()),
                         jnp.asarray(box300.mask.numpy()), voxel))
    got = tpre.voxel_downsample(box300.points, box300.mask, voxel)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert 0 < int(got.sum()) < int(box300.mask.sum())
    q = np.floor(box300.points[5].numpy() / voxel).astype(np.int64)
    ids = q[:, 0] * 10**6 + q[:, 1]
    m = box300.mask[5].numpy()
    first = {}
    for i in np.nonzero(m)[0]:
        first.setdefault(ids[i], i)
    want = np.zeros_like(m)
    want[list(first.values())] = True
    np.testing.assert_array_equal(got[5].numpy(), want)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("world", ["box", "corridor"])
def test_raycast_ref_matches_jax(dtype, world):
    """K11's plain version against ``ndtpu.data.synth.raycast`` on the same
    inputs: f64 to 1e-12 m, f32 to 1e-4 m; hits (range < max) equal."""
    if world == "box":
        seg = np.asarray(jsynth.box_world(11.0).segments)
        traj = np.asarray(jsynth.rectangle_trajectory(60, 7.0, 0.2))
    else:
        seg = np.asarray(jsynth.corridor_loop_world(18.0, 5.0).segments)
        traj = np.asarray(jsynth.rectangle_trajectory(60, 15.0, 0.25))
    ang = np.linspace(-np.pi, np.pi, 360, endpoint=False)
    x64 = dtype == "float64"
    jax.config.update("jax_enable_x64", x64)
    try:
        seg, traj, ang = (a.astype(dtype) for a in (seg, traj, ang))
        ref = np.asarray(jax.jit(jsynth.raycast, static_argnums=3)(
            jsynth.World(jnp.asarray(seg)), jnp.asarray(traj),
            jnp.asarray(ang), 20.0))
    finally:
        jax.config.update("jax_enable_x64", True)
    got = tsynth.raycast_ref(tsynth.World(torch.as_tensor(seg)),
                             torch.as_tensor(traj), torch.as_tensor(ang),
                             20.0).numpy()
    assert got.dtype == np.dtype(dtype)
    np.testing.assert_array_equal(got < 20.0, ref < 20.0)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12 if x64 else 1e-4)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_raycast_ref_matches_jax_past_the_old_limit(dtype):
    """At 4,004 segments (``chip_smoke.K11_MANY``'s pillars; the first K11
    held at most 1,536 in f64): K11's plain version against
    ``ndtpu.data.synth.raycast``, as above."""
    m = chip_smoke.K11_MANY
    seg = chip_smoke.pillar_segments(m["half"], m["pillars"], m["seed"])
    traj = np.asarray(jsynth.rectangle_trajectory(6, 7.0, 4.0))
    ang = np.linspace(-np.pi, np.pi, 180, endpoint=False)
    assert seg.shape == (4004, 2, 2)
    x64 = dtype == "float64"
    jax.config.update("jax_enable_x64", x64)
    try:
        seg, traj, ang = (a.astype(dtype) for a in (seg, traj, ang))
        ref = np.asarray(jax.jit(jsynth.raycast, static_argnums=3)(
            jsynth.World(jnp.asarray(seg)), jnp.asarray(traj),
            jnp.asarray(ang), 20.0))
    finally:
        jax.config.update("jax_enable_x64", True)
    got = tsynth.raycast_ref(tsynth.World(torch.as_tensor(seg)),
                             torch.as_tensor(traj), torch.as_tensor(ang),
                             20.0).numpy()
    assert 0.5 < float((got < 20.0).mean()) < 1.0
    np.testing.assert_array_equal(got < 20.0, ref < 20.0)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12 if x64 else 1e-4)


def _raycast_model(seg, poses, ang, max_range, eps=1e-9):
    """``csrc/raycast.cu``'s per-segment arithmetic in numpy, in the inputs'
    dtype (the beams' cos/sin from torch, as the plain version's): the
    rejection test before any division (segment 0 too, where the bound is
    still +inf; t's sign from its bits), the miss update for a rejected
    segment, the plain version's divisions and tests for the others.
    Returns the ranges and the segments that took the divisions."""
    dt = seg.dtype.type
    th = torch.as_tensor(poses[:, 2:3]) + torch.as_tensor(ang)[None]
    dx, dy = torch.cos(th).numpy(), torch.sin(th).numpy()
    m = dt(2.0 ** -40 if dt == np.float64 else 2.0 ** -16)
    tiny, inf, grow = dt(2.0 ** -60), dt(np.inf), dt(1) + m
    eps, mr, zero, one, small = dt(eps), dt(max_range), dt(0), dt(1), dt(
        1e-4)
    lo = max(eps, tiny)
    best = np.full(dx.shape, mr, dt)
    bm = np.full(dx.shape, inf, dt)
    px, py = poses[:, 0:1], poses[:, 1:2]
    divided = 0
    with np.errstate(all="ignore"):
        for s in range(seg.shape[0]):
            ax, ay = seg[s, 0, 0], seg[s, 0, 1]
            abx, aby = seg[s, 1, 0] - ax, seg[s, 1, 1] - ay
            aox, aoy = ax - px, ay - py
            tn = aox * aby - aoy * abx
            denom = dx * aby - dy * abx
            ad = np.abs(denom)
            un = aox * dy - aoy * dx
            neg = np.signbit(denom)
            tq, uq = np.where(neg, -tn, tn), np.where(neg, -un, un)
            dm = ad * m
            pos = (tq.view(np.int64) >> 32 if dt == np.float64
                   else tq.view(np.int32)) > 0
            passes = pos & (tq < ad * bm) & (uq >= -dm) & (uq <= ad + dm)
            exact = np.where(ad >= lo, passes, ad >= eps)
            divided += int(exact.sum())
            ok = ad >= eps
            den = np.where(ok, denom, one)
            t, u = tn / den, un / den
            v = np.where(ok & (t > small) & (u >= zero) & (u <= one), t, mr)
            hit = exact & ((s == 0) | (v < best))
            miss = ~exact & ((s == 0) | (mr < best))
            best = np.where(hit, v, np.where(miss, mr, best))
            bm = np.where(hit | miss, np.where(
                (best >= tiny) & (best <= mr), best * grow, inf), bm)
    return best, divided


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("kind", ["corridor", "serving", "pillars"])
def test_raycast_rejection_model_is_bit_equal_to_plain(kind, dtype):
    """K11's test before dividing rejects only segments that cannot change
    the running minimum (see ``csrc/raycast.cu``): its numpy model gives the
    plain version's ranges bit for bit on the smoke's inputs (the corridor,
    serving's box world, 4,004 pillar segments; every 10th / 40th / 8th
    pose), dividing on a few segments per beam."""
    world, poses, ang = chip_smoke.k11_inputs(kind, getattr(torch, dtype),
                                              "cpu")
    poses = poses.reshape(-1, 3)[::{"corridor": 10, "serving": 40,
                                    "pillars": 8}[kind]]
    ref = tsynth.raycast_ref(world, poses, ang, 20.0).numpy()
    got, divided = _raycast_model(world.segments.numpy(), poses.numpy(),
                                  ang.numpy(), 20.0)
    assert got.dtype == ref.dtype
    assert np.array_equal(got.view(f"u{got.itemsize}"),
                          ref.view(f"u{ref.itemsize}"))
    assert divided / got.size < 3.0


def test_wrappers_take_the_plain_versions_on_cpu_and_kernels_refuse_cpu():
    world = tsynth.World(tsynth.box_world(11.0).segments.double())
    poses = tsynth.rectangle_trajectory(5, 7.0, 0.2, dtype=torch.float64)
    ang = tsynth.beam_angles(36, dtype=torch.float64)
    assert torch.equal(tsynth.raycast(world, poses, ang, 20.0),
                       tsynth.raycast_ref(world, poses, ang, 20.0))
    pts = torch.randn(3, 36, 2, generator=torch.Generator().manual_seed(0))
    msk = torch.ones(3, 36, dtype=torch.bool)
    assert torch.equal(tpre.voxel_downsample(pts, msk, 0.5),
                       tpre.voxel_downsample_ref(pts, msk, 0.5))
    with pytest.raises(ValueError, match="CUDA"):
        kernels.raycast(poses, ang, world.segments, 20.0, 1e-9)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.voxel_downsample(pts, msk, 0.5)
    assert kernels.LAUNCHES["raycast"] == kernels.LAUNCHES[
        "voxel_downsample"] == 0


# ---------------------------------------------------------------------------
# CARMEN logs (tests/test_carmen.py's, written by each package).

def _log(mod, t=5, n=181, mixed=False, extrinsics=False):
    rng = np.random.default_rng(0)
    odom = np.cumsum(rng.normal(0, 0.1, (t, 3)), axis=0)
    lp = odom.copy()
    if extrinsics:      # a laser 0.3 m ahead of and 0.05 rad off the robot
        c, s = np.cos(odom[:, 2]), np.sin(odom[:, 2])
        lp = np.stack([odom[:, 0] + 0.3 * c, odom[:, 1] + 0.3 * s,
                       odom[:, 2] + 0.05], -1)
    nb = np.full(t, n, np.int32)
    if mixed:
        nb[1::2] = n - 1
    return mod.CarmenLog(
        ranges=rng.uniform(0.5, 20.0, (t, n)).astype(np.float32),
        n_beams=nb, laser_pose=lp, odom_pose=odom,
        timestamps=np.arange(t, dtype=np.float64))


def _equal_logs(a, b):
    for f in ("ranges", "n_beams", "laser_pose", "odom_pose", "timestamps"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                      err_msg=f)
    for f in ("start_angle", "fov", "log_max_range"):
        x, y = getattr(a, f), getattr(b, f)
        assert (math.isnan(x) and math.isnan(y)) or x == y, f


@pytest.mark.parametrize("style", ["flaser", "robotlaser"])
@pytest.mark.parametrize("kind", ["plain", "mixed", "extrinsics"])
def test_carmen_round_trip_equals_jax(tmp_path, style, kind):
    """Each package writes the same log; each reads both files to the same
    ``CarmenLog`` and the same ``to_sequence`` inputs (mixed beam counts
    and laser extrinsics included)."""
    kw = dict(mixed=kind == "mixed", extrinsics=kind == "extrinsics")
    pt, pj = tmp_path / "t.clf", tmp_path / "j.clf"
    tcarmen.write_carmen(str(pt), _log(tcarmen, **kw), style=style)
    jcarmen.write_carmen(str(pj), _log(jcarmen, **kw), style=style)
    assert pt.read_text() == pj.read_text()
    for p in (pt, pj):
        got, ref = tcarmen.read_carmen(str(p)), jcarmen.read_carmen(str(p))
        _equal_logs(got, ref)
        np.testing.assert_allclose(got.ranges[:, :180],
                                   _log(tcarmen, **kw).ranges[:, :180],
                                   atol=1e-3)
        for a, b in zip(tcarmen.to_sequence(got, max_range=25.0),
                        jcarmen.to_sequence(ref, max_range=25.0)):
            np.testing.assert_array_equal(a, b)
    if kind == "mixed":
        assert got.ranges.shape[1] == 181
        assert list(got.n_beams[:2]) == [181, 180]


def test_carmen_robotlaser1_spec_lines(tmp_path):
    """Hand-written ROBOTLASER1 lines (with and without the remission
    block, an integer laser x) and a malformed line: the same log as the
    JAX package's reader."""
    r = " ".join(f"{x:.2f}" for x in np.linspace(1.0, 5.0, 5))
    lines = [
        f"ROBOTLASER1 0 -1.570796 3.141593 0.785398 50.0 0.01 0 5 {r} "
        "2 0.5 0.6 0.1 0.2 0.05 0.1 0.2 0.05 0.3 0.0 0.5 0.4 0.2 "
        "12.5 robot 12.6",
        f"ROBOTLASER1 0 -1.570796 3.141593 0.785398 50.0 0.01 0 5 {r} "
        "0.11 0.22 0.06 0.11 0.22 0.06 0.3 0.0 0.5 0.4 0.2 13.5 robot 13.6",
        f"ROBOTLASER1 0 -1.570796 3.141593 0.785398 50.0 0.01 0 5 {r} "
        "0 0.2 0.07 0 0.2 0.07 0.3 0.0 0.5 0.4 0.2 14.5 robot 14.6",
        "FLASER 99 1.0 2.0",
    ]
    p = tmp_path / "rl.log"
    p.write_text("\n".join(lines) + "\n")
    with pytest.warns(UserWarning, match="malformed"):
        got = tcarmen.read_carmen(str(p))
    with pytest.warns(UserWarning, match="malformed"):
        ref = jcarmen.read_carmen(str(p))
    _equal_logs(got, ref)
    assert got.ranges.shape == (3, 5) and got.start_angle == -1.570796
    np.testing.assert_array_equal(tcarmen.to_sequence(got)[0],
                                  jcarmen.to_sequence(ref)[0])


def test_native_parser_equals_python_parser(tmp_path):
    """The g++-built scanner gives the same log as the Python parser (the
    ranges as floats of the same text), for both line styles."""
    assert native.ndtpu_native_available()
    for style in ("flaser", "robotlaser"):
        p = tmp_path / f"{style}.clf"
        tcarmen.write_carmen(str(p), _log(tcarmen, t=7, mixed=True,
                                          extrinsics=True), style=style)
        py, cc = tcarmen.read_carmen(str(p)), native.parse_carmen_native(
            str(p))
        np.testing.assert_array_equal(cc.n_beams, py.n_beams)
        np.testing.assert_allclose(cc.ranges, py.ranges, rtol=0, atol=1e-6)
        for f in ("laser_pose", "odom_pose", "timestamps"):
            np.testing.assert_allclose(getattr(cc, f), getattr(py, f),
                                       rtol=0, atol=1e-9)
        _equal_logs(tcarmen.read_log(str(p)), cc)


def test_native_orderings():
    """``amd_order`` is a permutation; ``rcm_order`` (scipy) reduces the
    bandwidth of a scrambled chain."""
    rng = np.random.default_rng(2)
    v = 120
    ei = rng.integers(0, v, 400).astype(np.int32)
    ej = rng.integers(0, v, 400).astype(np.int32)
    assert sorted(native.amd_order(ei, ej, v).tolist()) == list(range(v))
    perm = rng.permutation(v)
    ci, cj = perm[:-1].astype(np.int32), perm[1:].astype(np.int32)
    order = native.rcm_order(ci, cj, v)
    pos = np.empty(v, np.int64)
    pos[order] = np.arange(v)
    assert sorted(order.tolist()) == list(range(v))
    assert np.abs(pos[ci] - pos[cj]).max() < np.abs(ci - cj).max()
