"""Config 5's slab-sharded map (``ndtpu_torch.dist.gridmap``), sharded
registration (``dist.registration``), the single-pose LM loop
(``ndt.match.lm_loop``) and ``launch --task slam`` against the JAX
package's ``ndtpu.dist`` on the conftest's 8 virtual CPU devices, in f64.

The per-rank functions that need no collective run in this process, one
``RankMesh(rank, d, "cpu")`` per rank. The paths with collectives (the
halo exchange, ``match_slab``'s per-evaluation SUM) run as two real
processes over gloo, with JAX and the JAX package made unimportable in
them; the JAX reference is computed here in the parent.

Tolerances: the port and the reference do the same f64 arithmetic in
another order (segment sums, reductions over grids and beams), so sums
agree to ~1e-12 relative; ``RTOL`` = 1e-10 leaves room for
reassociation. Poses after an LM loop are held to ``POSE_TOL`` = 1e-9:
the same decisions, each step off by reassociation only.
"""

import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndtpu import dist as jdist
from ndtpu.config import GridConfig as JGridConfig
from ndtpu.config import MatchConfig as JMatchConfig
from ndtpu.config import NDTMapConfig as JNDTMapConfig
from ndtpu.data import synth as jsynth
from ndtpu.dist import gridmap as jgridmap
from ndtpu.ndt import grid as jgrid
from ndtpu.ndt import match as jmatch
from ndtpu_torch import convert
from ndtpu_torch.config import GridConfig, MatchConfig, NDTMapConfig
from ndtpu_torch.dist import gridmap as tgridmap
from ndtpu_torch.dist import launch as tlaunch
from ndtpu_torch.dist import mesh as tmesh
from ndtpu_torch.ndt import grid as tgrid
from ndtpu_torch.ndt import match as tmatch

torch.set_num_threads(2)

RTOL = 1e-10
POSE_TOL = 1e-9
F64 = torch.float64

GRID = GridConfig(x0=-8.0, y0=-8.0, cell=1.0, nx=16, ny=16, overlap=4)
JGRID = JGridConfig(x0=-8.0, y0=-8.0, cell=1.0, nx=16, ny=16, overlap=4)
#: The same grids at overlap 1 (one grid, unshifted).
GRID1 = GridConfig(x0=-8.0, y0=-8.0, cell=1.0, nx=16, ny=16, overlap=1)
JGRID1 = JGridConfig(x0=-8.0, y0=-8.0, cell=1.0, nx=16, ny=16, overlap=1)
GRIDS = {4: (GRID, JGRID), 1: (GRID1, JGRID1)}


def _cpu_mesh(rank, d):
    return tmesh.RankMesh(rank, d, torch.device("cpu"), ("space",))


@pytest.fixture(scope="module")
def cloud():
    """test_dist.py:22's cloud (512 points uniform in [-7.5, 7.5]^2), drawn
    with numpy, with every 7th point masked off."""
    rng = np.random.default_rng(0)
    pts = rng.uniform(-7.5, 7.5, (512, 2))
    mask = np.arange(512) % 7 != 3
    return pts, mask


@pytest.fixture(scope="module")
def jslabs(cloud):
    """The reference's ``build_slab_stats`` of the cloud on ``space_mesh(d)``
    for d = 2 and 4 (numpy leaves; at overlap 1 keyed ``(d, 1)``), and
    ``finalize_slab`` of d = 2's."""
    pts, mask = cloud
    out = {(d if o == 4 else (d, 1)): jax.jit(
        lambda p, m, mesh=jdist.space_mesh(d), g=GRIDS[o][1]:
        jdist.build_slab_stats(mesh, p, m, g))(jnp.asarray(pts),
                                               jnp.asarray(mask))
        for d in (2, 4) for o in (4, 1)}
    out["map2"] = jdist.finalize_slab(out[2], JNDTMapConfig())
    return {k: type(v)(*(np.asarray(x) for x in v)) for k, v in out.items()}


@pytest.fixture(scope="module")
def room():
    """test_dist.py:75's box room: the map scan from the origin, and the
    scan from ``true_pose``, from the JAX simulator (f64)."""
    world = jsynth.box_world(half=6.0)
    angles = jsynth.beam_angles(180)
    r0 = jsynth.raycast(world, jnp.zeros((1, 3), jnp.float64), angles,
                        12.0)[0]
    map_pts, map_msk = jsynth.polar_to_xy(r0, angles, 0.1, 12.0)
    true_pose = np.array([0.4, -0.3, 0.15])
    r1 = jsynth.raycast(world, jnp.asarray(true_pose)[None], angles, 12.0)[0]
    scan_pts, scan_msk = jsynth.polar_to_xy(r1, angles, 0.1, 12.0)
    return tuple(np.asarray(x) for x in (map_pts, map_msk, scan_pts,
                                          scan_msk)) + (true_pose,)


def _t(x):
    return torch.as_tensor(np.array(x))


def _close(got, ref, rtol=RTOL, atol=1e-12):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("overlap", [4, 1])
def test_accum_local_matches_jax(cloud, overlap):
    """The reference's ``_accum_local`` (three segment sums into a local
    ix-major slab) and K10a's plain version (the binning, the slab mask
    and those sums) against the JAX package, on an off-centre slab with a
    halo that runs off the map, at both overlaps."""
    pts, mask = cloud
    GRID, JGRID = GRIDS[overlap]
    x_lo, width = -3, 10
    ix, iy, inb = jgridmap._cell_xy(jnp.asarray(pts), JGRID)
    lx = ix - x_lo
    live = jnp.asarray(mask)[None] & inb & (lx >= 0) & (lx < width)
    ref = jgridmap._accum_local(jnp.asarray(pts), live.astype(jnp.float64),
                                jnp.clip(lx, 0, width - 1), iy, width, JGRID)
    got = tgridmap._accum_local(
        _t(pts), _t(live).to(F64), _t(np.clip(lx, 0, width - 1)), _t(iy),
        width, GRID)
    plain = tgridmap.slab_accumulate_ref(_t(pts), _t(mask), GRID, x_lo,
                                         width)
    assert float(plain.n.sum()) > 100 / (4 // overlap)
    for a, b, r in zip(got, plain, ref):
        assert a.shape == tuple(r.shape) and a.shape[0] == overlap
        _close(a, r)
        _close(b, r)


def test_fixed_model_is_order_free_and_close_to_plain(cloud):
    """K10a's fixed-point model: the same bits under any order of the
    points, and the plain f64 sums to within the fixed point's rounding
    (2^-33 of a cell per term)."""
    pts, mask = cloud
    p, m = _t(pts), _t(mask)
    fixed = tgridmap.slab_accumulate_fixed_ref(p, m, GRID, 4, 12)
    perm = torch.as_tensor(np.random.default_rng(1).permutation(512))
    again = tgridmap.slab_accumulate_fixed_ref(p[perm], m[perm], GRID, 4, 12)
    plain = tgridmap.slab_accumulate_ref(p, m, GRID, 4, 12)
    for a, b, c in zip(fixed, again, plain):
        assert torch.equal(a, b)
        _close(a, c, rtol=1e-9, atol=1e-8)
    # f32 points: the model rounds each moment to f32 once.
    f32 = tgridmap.slab_accumulate_fixed_ref(p.float(), m, GRID, 4, 12)
    assert all(x.dtype == torch.float32 for x in f32)
    _close(f32.n, fixed.n, rtol=0, atol=0)


@pytest.mark.parametrize("overlap", [4, 1])
@pytest.mark.parametrize("d", [2, 4])
def test_build_slab_stats_matches_jax_per_rank(cloud, jslabs, d, overlap):
    """Each rank's ``build_slab_stats`` (no collective: in process) against
    the reference's sharded output on ``space_mesh(d)``, sliced by rank,
    at both overlaps."""
    pts, mask = cloud
    GRID = GRIDS[overlap][0]
    ref = jslabs[d if overlap == 4 else (d, 1)]
    nxl = GRID.nx // d
    for rank in range(d):
        got = tgridmap.build_slab_stats(_cpu_mesh(rank, d), _t(pts),
                                        _t(mask), GRID)
        for a, r in zip(got, ref):
            _close(a, np.asarray(r)[:, rank * nxl:(rank + 1) * nxl])


def test_dense_slab_layout_round_trip(cloud, jslabs):
    """``dense_to_slab`` is test_dist.py:29's ``_dense_to_slab``, and
    ``slab_to_dense`` its inverse; ``convert`` carries the JAX package's
    ``SlabStats`` and ``SlabMap`` in the slab layout."""
    pts, mask = cloud
    dense = tgrid.build_stats(_t(pts), _t(mask), GRID)
    slab = tgridmap.dense_to_slab(dense, GRID)
    assert isinstance(slab, tgridmap.SlabStats)
    assert slab.ss.shape == (4, 16, 16, 2, 2)
    jd = jgrid.build_stats(jnp.asarray(pts), jnp.asarray(mask), JGRID)
    for a, b in zip(slab, jdist.SlabStats(*(
            jnp.transpose(x.reshape((4, 16, 16) + x.shape[2:]),
                          (0, 2, 1) + tuple(range(3, x.ndim + 1)))
            for x in jd))):
        _close(a, b)
    back = tgridmap.slab_to_dense(slab, GRID)
    assert isinstance(back, tgrid.NDTStats)
    for a, b in zip(back, dense):
        assert torch.equal(a, b)
    m = tgrid.finalize(dense, NDTMapConfig())
    assert isinstance(tgridmap.dense_to_slab(m, GRID), tgridmap.SlabMap)
    for tree in (jslabs[2], jslabs["map2"]):
        got = convert.from_numpy(type(tree)(*(np.asarray(x) for x in tree)))
        assert type(got).__name__ == type(tree).__name__
        assert got.__class__.__module__ == "ndtpu_torch.dist.gridmap"
        for a, b in zip(got, tree):
            _close(a, b, rtol=0, atol=0)
        back = convert.to_numpy(got)
        for a, b in zip(back, tree):
            np.testing.assert_array_equal(a, np.asarray(b))


def test_finalize_slab_matches_jax(jslabs):
    """``finalize_slab`` (``ndt.grid.finalize`` in the slab layout, K10b's
    plain version on the CPU) against the reference on the same slab
    statistics; the valid flags exactly."""
    ref = jslabs["map2"]
    stats = convert.from_numpy(jslabs[2])
    got = tgridmap.finalize_slab(stats, NDTMapConfig())
    assert float(got.valid.sum()) > 50
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
    for a, r in zip(got, ref):
        _close(a, r, atol=1e-10)
    # The same statistics as the halo exchange hands them on (views of its
    # 7-float records, K10b's in-place layout) give the same map.
    recs = tgridmap._exchange(None, stats, 0, stats.n.shape[1])
    assert tgrid.kernels.finalize_inputs(*recs)[0] == "records"
    for a, b in zip(tgridmap.finalize_slab(recs, NDTMapConfig()), got):
        assert torch.equal(a, b)


@pytest.mark.parametrize("overlap", [4, 1])
@pytest.mark.parametrize("hw", [0, 2])
def test_exchange_returns_views_of_its_records(cloud, hw, overlap,
                                               monkeypatch):
    """``_exchange`` hands back ``n``, ``s`` and ``ss`` as views of its
    packed core (K10b's record layout, which it reads in place), equal to
    the statistics summed as before: the interior columns plus, with a
    halo, what the ring exchange (here a stand-in: 2 x the far halo from
    the left, the near halo + 1 from the right) brings. On the CPU
    ``finalize_slab`` of the views is that of their contiguous copies."""
    pts, mask = cloud
    grid = GRIDS[overlap][0]
    nxl = 8
    ext = tgridmap.slab_accumulate(_t(pts), _t(mask), grid, 4 - hw,
                                   nxl + 2 * hw)
    calls = []

    def ring(mesh, lo, hi, axis):
        calls.append(axis)
        return 2.0 * hi, lo + 1.0

    monkeypatch.setattr(tgridmap.dmesh, "ring_exchange", ring)
    got = tgridmap._exchange(None, ext, hw, nxl)
    assert calls == (["space"] if hw else [])
    assert tgrid.kernels.finalize_inputs(*got)[0] == "records"
    base = got.n.untyped_storage().data_ptr()
    assert all(x.untyped_storage().data_ptr() == base for x in got)
    for x, e in zip(got, ext):
        want = e[:, hw:hw + nxl].clone()
        if hw:
            want[:, :hw] += 2.0 * e[:, nxl + hw:]
            want[:, nxl - hw:] += e[:, :hw] + 1.0
        assert torch.equal(x, want)
    copies = tgridmap.SlabStats(*(x.contiguous() for x in got))
    for a, b in zip(tgridmap.finalize_slab(got, NDTMapConfig()),
                    tgridmap.finalize_slab(copies, NDTMapConfig())):
        assert torch.equal(a, b)


@pytest.mark.parametrize("overlap", [4, 1])
@pytest.mark.parametrize("d", [2, 4])
def test_rank_terms_sum_to_the_dense_objective(room, d, overlap):
    """K10c's plain version (the reference's per-rank ``sgh`` before its
    psum), summed over the ranks, against ``ndtpu.ndt.match.
    score_grad_hess`` on the dense map, at several poses, at both
    overlaps."""
    map_pts, map_msk, scan_pts, scan_msk, true_pose = room
    GRID, JGRID = GRIDS[overlap]
    jmap = jgrid.finalize(jgrid.build_stats(jnp.asarray(map_pts),
                                            jnp.asarray(map_msk), JGRID),
                          JNDTMapConfig())
    slab = tgridmap.dense_to_slab(convert.from_numpy(jgrid.NDTMap(
        *(np.asarray(x) for x in jmap))), GRID)
    rng = np.random.default_rng(3)
    poses = true_pose + rng.normal(0, [0.3, 0.3, 0.1], (5, 3))
    poses[0] = 0.0
    nxl = GRID.nx // d
    vec = sum(tgridmap.slab_sgh_ref(
        _t(poses), _t(scan_pts), _t(scan_msk),
        tgridmap.SlabMap(*(x[:, r * nxl:(r + 1) * nxl] for x in slab)),
        GRID, r * nxl, MatchConfig()) for r in range(d))
    f, g, h, score = jax.jit(jax.vmap(
        lambda p: jmatch.score_grad_hess(p, jnp.asarray(scan_pts),
                                         jnp.asarray(scan_msk), jmap, JGRID,
                                         JMatchConfig())))(jnp.asarray(poses))
    assert bool((f < -10).all())
    _close(vec[:, 0], f)
    _close(vec[:, 3:6], g, atol=1e-9)
    _close(vec[:, 6:].reshape(-1, 3, 3), h, atol=1e-9)
    _close(vec[:, 1] / torch.clamp(vec[:, 2], min=1.0), score)


def _lm_case(room, reject_tol, init):
    """``lm_loop`` of both packages on ``score_grad_hess`` of the room
    scan from ``init``; returns both results and whether the port's loop
    stopped on a rejected step under ``reject_tol``."""
    map_pts, map_msk, scan_pts, scan_msk, _ = room
    jmap = jgrid.finalize(jgrid.build_stats(jnp.asarray(map_pts),
                                            jnp.asarray(map_msk), JGRID),
                          JNDTMapConfig())
    tmap = convert.from_numpy(jgrid.NDTMap(*(np.asarray(x) for x in jmap)))
    jcfg = JMatchConfig(reject_tol=reject_tol)
    tcfg = MatchConfig(reject_tol=reject_tol)
    ref = jmatch.lm_loop(
        lambda p: jmatch.score_grad_hess(p, jnp.asarray(scan_pts),
                                         jnp.asarray(scan_msk), jmap, JGRID,
                                         jcfg), jnp.asarray(init), jcfg)
    evals = []

    def sgh(p):
        out = tmatch.score_grad_hess(p, _t(scan_pts), _t(scan_msk), tmap,
                                     GRID, tcfg)
        evals.append((p, out[0]))
        return out

    got = tmatch.lm_loop(sgh, _t(init), tcfg)
    # Stopped on a rejection: the last trial did not lower f, and its
    # step was under reject_tol.
    f_best = float(got.hessian.new_tensor(0) + min(float(e[1])
                                                  for e in evals))
    last_p, last_f = evals[-1]
    step = float(torch.linalg.norm(last_p - got.pose))
    rejected = (float(last_f) >= f_best and step < reject_tol
                and int(got.n_iter) < tcfg.max_iter)
    return ref, got, rejected


@pytest.mark.parametrize("reject_tol,init", [
    (3e-3, [0.0, 0.0, 0.0]),
    (3e-3, [0.7, -0.6, 0.3]),
    (2e-2, [0.2, 0.1, -0.05]),
])
def test_lm_loop_matches_jax(room, reject_tol, init):
    """The single-pose LM loop against ``ndtpu.ndt.match.lm_loop`` with
    ``score_grad_hess``: pose, Hessian, score, iterations, converged."""
    ref, got, _ = _lm_case(room, reject_tol, np.asarray(init, np.float64))
    assert int(got.n_iter) == int(ref.n_iter)
    assert bool(got.converged) == bool(ref.converged)
    _close(got.pose, ref.pose, rtol=0, atol=POSE_TOL)
    _close(got.hessian, ref.hessian, rtol=1e-8, atol=1e-8)
    _close(got.score, ref.score)


def test_lm_loop_stops_on_a_rejected_small_step(room):
    """A case whose loop ends on a rejected step under ``reject_tol``, in
    both packages alike (the reference's second stop rule)."""
    ref, got, rejected = _lm_case(room, 5e-2, np.array([0.45, -0.25, 0.1]))
    assert rejected
    assert int(got.n_iter) == int(ref.n_iter)
    assert bool(got.converged) and bool(ref.converged)
    _close(got.pose, ref.pose, rtol=0, atol=POSE_TOL)


def test_halo_past_the_slab_is_refused(cloud):
    """``halo > nx_local`` (the reference's two halo adds overlap there)
    and ``nx`` not divisible by the ranks raise before any collective."""
    pts, mask = cloud
    with pytest.raises(ValueError, match="halo"):
        tgridmap.build_slab_stats_psharded(_cpu_mesh(0, 2), _t(pts),
                                           _t(mask), GRID, halo=9)
    with pytest.raises(ValueError, match="divisible"):
        tgridmap.build_slab_stats(_cpu_mesh(0, 3), _t(pts), _t(mask), GRID)
    assert tgridmap.slab_halo(_t(pts), _t(mask), GRID, 2, 0) == 8


# -- Two processes over gloo ------------------------------------------------

_BLOCK_JAX = """import sys
sys.modules["jax"] = None          # any "import jax" raises ImportError
sys.modules["ndtpu"] = None        # ... and any "import ndtpu[.x]"
"""

#: One rank of the slab path on the CPU: the point-sharded build (halo 2),
#: the replicated build, ``match_slab`` and ``match_batch_sharded``, and a
#: 2D mesh's collectives; writes ``<out>.<rank>.npz``.
_WORKER = r'''
import sys
import numpy as np
import torch
from ndtpu_torch.config import GridConfig, MatchConfig, NDTMapConfig
from ndtpu_torch.dist import gridmap, launch, mesh, registration
from ndtpu_torch.ndt import grid as ndt_grid

rank, world, port, inp, out = (int(sys.argv[1]), int(sys.argv[2]),
                               sys.argv[3], sys.argv[4], sys.argv[5])
launch.initialize(f"localhost:{port}", world, rank)
d = {k: torch.as_tensor(v) for k, v in np.load(inp).items()}
grid = GridConfig(x0=-8.0, y0=-8.0, cell=1.0, nx=16, ny=16, overlap=4)
space, batch = mesh.space_mesh("cpu"), mesh.batch_mesh("cpu")
mesh.reset_collectives()
ps = gridmap.build_slab_stats_psharded(space, d["ppts"][rank],
                                       d["pmask"][rank], grid, halo=2)
coll = dict(mesh.COLLECTIVES)
rep = gridmap.build_slab_stats(space, d["map_pts"], d["map_msk"], grid)
slab_map = gridmap.finalize_slab(rep, NDTMapConfig())
mesh.reset_collectives()
res = gridmap.match_slab(space, d["scan_pts"], d["scan_msk"], slab_map,
                         torch.zeros(3, dtype=torch.float64), grid,
                         MatchConfig())
sums = mesh.COLLECTIVES["all_reduce"]
dense = ndt_grid.finalize(ndt_grid.build_stats(d["map_pts"], d["map_msk"],
                                               grid), NDTMapConfig())
mb = registration.match_batch_sharded(batch, d["spts"], d["smsk"], dense,
                                      torch.zeros_like(d["sposes"]), grid,
                                      MatchConfig())
g2 = mesh.grid_mesh(1, world, "cpu")
x = torch.tensor([float(rank + 1)])
mesh.psum(g2, x, "space")
y = torch.tensor([float(rank + 1)])
mesh.psum(g2, y, "batch")
np.savez(out + f".{rank}.npz", n=ps.n.numpy(), s=ps.s.numpy(),
         ss=ps.ss.numpy(), rep_n=rep.n.numpy(), pose=res.pose.numpy(),
         n_iter=res.n_iter.numpy(), conv=res.converged.numpy(),
         hess=res.hessian.numpy(), mb_pose=mb.pose.numpy(),
         mb_iter=mb.n_iter.numpy(), mb_conv=mb.converged.numpy(),
         exchanges=coll["exchange"], exchange_reduces=coll["all_reduce"],
         sums=sums, coords=[mesh.axis_index(g2, "batch"),
                            mesh.axis_index(g2, "space")],
         space_sum=x.numpy(), batch_sum=y.numpy())
launch.shutdown()
'''


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _no_jax_env(tmp_path, monkeypatch):
    """An environment whose children cannot import JAX or the JAX package
    (checked), with the repository on their path."""
    block = tmp_path / "block"
    block.mkdir()
    (block / "sitecustomize.py").write_text(_BLOCK_JAX)
    monkeypatch.setenv("PYTHONPATH", str(block))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(tlaunch.ROOT),
                                                       str(block)]))
    probe = subprocess.run([sys.executable, "-c", "import ndtpu.config"],
                           env=env, cwd=str(tlaunch.ROOT),
                           capture_output=True, text=True, timeout=120)
    assert probe.returncode != 0 and "ModuleNotFoundError" in probe.stderr
    return env


@pytest.fixture(scope="module")
def slab_inputs(room):
    """test_dist.py:54's psharded layout cut to two ranks (each rank's 64
    points clustered around its slab, reaching 1-2 columns into the
    other's), the room scans, and 16 scans of the room from poses along a
    line (test_dist.py:115's)."""
    map_pts, map_msk, scan_pts, scan_msk, _ = room
    rng = np.random.default_rng(5)
    ppts = np.stack([rng.uniform([-7.5, -7.5], [1.5, 7.5], (64, 2)),
                     rng.uniform([-1.5, -7.5], [7.5, 7.5], (64, 2))])
    pmask = np.ones((2, 64), bool)
    pmask[:, ::9] = False
    world = jsynth.box_world(half=6.0)
    angles = jsynth.beam_angles(180)
    b = 16
    sposes = np.stack([np.linspace(-0.3, 0.3, b), np.linspace(0.2, -0.2, b),
                       np.linspace(-0.1, 0.1, b)], -1)
    rr = jsynth.raycast(world, jnp.asarray(sposes), angles, 12.0)
    spts, smsk = (np.asarray(x) for x in jsynth.polar_to_xy(rr, angles, 0.1,
                                                            12.0))
    return dict(ppts=ppts, pmask=pmask, map_pts=map_pts, map_msk=map_msk,
                scan_pts=scan_pts, scan_msk=scan_msk, spts=spts, smsk=smsk,
                sposes=sposes)


def test_slab_path_over_gloo_matches_jax(slab_inputs, tmp_path,
                                         monkeypatch):
    """Two processes over gloo on the CPU, JAX unimportable in both:
    ``build_slab_stats_psharded`` (halo 2: one ring exchange), the
    replicated build, ``match_slab`` (one SUM per LM evaluation, the same
    pose on both ranks bit for bit) and ``match_batch_sharded`` (each
    rank's 8 lanes) against ``ndtpu.dist`` on ``space_mesh(2)`` /
    ``batch_mesh(2)``; and a ``grid_mesh(1, 2)``'s axes."""
    env = _no_jax_env(tmp_path, monkeypatch)
    inp = tmp_path / "in.npz"
    np.savez(inp, **slab_inputs)
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    port, out = str(_free_port()), str(tmp_path / "out")
    procs = [subprocess.Popen([sys.executable, str(script), str(r), "2",
                               port, str(inp), out], env=env,
                              cwd=str(tlaunch.ROOT), stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    # The reference, jitted (eager shard_map is slow), while the ranks run.
    i = {k: jnp.asarray(v) for k, v in slab_inputs.items()}
    space, batch = jdist.space_mesh(2), jdist.batch_mesh(2)
    ref = jax.jit(lambda p, m: jdist.build_slab_stats_psharded(
        space, p, m, JGRID, halo=2))(i["ppts"], i["pmask"])
    dense = jgrid.build_stats(i["ppts"].reshape(-1, 2),
                              i["pmask"].reshape(-1), JGRID)
    jres = jax.jit(lambda p, m, sp, sm: jdist.match_slab(
        space, sp, sm, jdist.finalize_slab(
            jdist.build_slab_stats(space, p, m, JGRID), JNDTMapConfig()),
        jnp.zeros(3), JGRID, JMatchConfig()))(
            i["map_pts"], i["map_msk"], i["scan_pts"], i["scan_msk"])
    jdense = jgrid.finalize(jgrid.build_stats(i["map_pts"], i["map_msk"],
                                              JGRID), JNDTMapConfig())
    jmb = jdist.match_batch_sharded(batch, i["spts"], i["smsk"], jdense,
                                    jnp.zeros((16, 3)), JGRID,
                                    JMatchConfig())
    for p in procs:
        so, se = p.communicate(timeout=300)
        assert p.returncode == 0, se[-3000:]
    ranks = [dict(np.load(f"{out}.{r}.npz")) for r in range(2)]
    for r, got in enumerate(ranks):
        cols = slice(8 * r, 8 * r + 8)
        for k, x in zip(("n", "s", "ss"), ref):
            _close(got[k], np.asarray(x)[:, cols])
        # The halo build equals the dense build: no point past the halo.
        np.testing.assert_array_equal(
            got["n"], tgridmap.dense_to_slab(convert.from_numpy(
                jgrid.NDTStats(*(np.asarray(x) for x in dense))),
                GRID).n.numpy()[:, cols])
        assert int(got["exchanges"]) == 1
        assert int(got["exchange_reduces"]) == 0
        assert int(got["sums"]) == int(got["n_iter"]) + 1
        _close(got["pose"], jres.pose, rtol=0, atol=POSE_TOL)
        assert int(got["n_iter"]) == int(jres.n_iter)
        assert bool(got["conv"]) == bool(jres.converged)
        lanes = slice(8 * r, 8 * r + 8)
        _close(got["mb_pose"], np.asarray(jmb.pose)[lanes], rtol=0,
               atol=POSE_TOL)
        np.testing.assert_array_equal(got["mb_iter"],
                                      np.asarray(jmb.n_iter)[lanes])
        np.testing.assert_array_equal(got["mb_conv"],
                                      np.asarray(jmb.converged)[lanes])
        assert list(got["coords"]) == [0, r]
        assert float(got["space_sum"][0]) == 3.0
        assert float(got["batch_sum"][0]) == r + 1.0
    assert ranks[0]["pose"].tobytes() == ranks[1]["pose"].tobytes()
    assert ranks[0]["hess"].tobytes() == ranks[1]["hess"].tobytes()
    assert bool(jres.converged)


def _jax_slam_rehearsal(n_scans: int) -> dict:
    """``ndtpu.dist.run_sessions_sharded`` on ``batch_mesh(2)`` over the
    port's ``--task slam`` sessions (the port's synth, so both packages
    get the same inputs), in f64: keyframes and ATE per session."""
    import dataclasses

    from ndtpu import config as jconfig
    from ndtpu.eval.ate import ate_rmse
    from ndtpu.slam import pipeline as jpipe

    cfg, seqs = tlaunch.slam_sessions(2, n_scans)
    jcfg = jconfig._from_dict(jconfig.PipelineConfig,
                              dataclasses.asdict(cfg))
    pts, msk, odo = (jnp.asarray(np.stack([getattr(q, k).numpy()
                                           for q in seqs]))
                     for k in ("points", "mask", "odom"))
    pts, odo = pts.astype(jnp.float64), odo.astype(jnp.float64)
    mesh = jdist.batch_mesh(2)
    st, outs = jax.jit(lambda p, m, o: jdist.run_sessions_sharded(
        mesh, p, m, o, jcfg))(pts, msk, odo)      # eager shard_map is slow
    ates = []
    for k in range(2):
        take = lambda a: a[k]
        traj = jpipe.recover_trajectory(jax.tree_util.tree_map(take, st),
                                        jax.tree_util.tree_map(take, outs))
        ates.append(float(ate_rmse(traj, jnp.asarray(
            seqs[k].gt_poses.numpy(), jnp.float64))))
    return {"n_scans": n_scans, "keyframes": [int(x) for x in st.kf.n],
            "ates": ates}


#: ``launch --task slam``'s ATE (f32 ranks) against the JAX package's f64
#: run of the same sessions, m. The two packages' f64 runs agree to ~1e-13;
#: the port's f32 roundoff moves the ATE by a few 1e-6. The JAX package's
#: own f32 run is no reference here: it ends session 1 in another f32
#: basin (ATE 0.0330 m against 0.0264 m in f64, as ROADMAP C-w1b
#: records for other runs).
SLAM_ATE_TOL = 1e-4


def test_launch_slam_over_gloo(tmp_path, monkeypatch):
    """``launch_local(2, task="slam", device="cpu")``, JAX unimportable in
    the workers: test_launch.py:38's gates (more than 5 keyframes and ATE
    under 0.3 m per session), each session's keyframe count equal to the
    JAX package's ``run_sessions_sharded`` on ``batch_mesh(2)`` over the
    same sessions in f64 (computed here while the ranks run) and its ATE
    within :data:`SLAM_ATE_TOL` of it, and each state digest equal to an
    in-process ``run_slam_windowed`` of its session."""
    from concurrent.futures import ThreadPoolExecutor

    from ndtpu_torch.slam import pipeline as tpipe

    _no_jax_env(tmp_path, monkeypatch)
    n_scans = 48
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(tlaunch.launch_local, 2, n_poses=n_scans,
                            port=_free_port(), task="slam", device="cpu",
                            timeout_s=300.0)
        ref = _jax_slam_rehearsal(n_scans)
        rec = ranks.result()
    assert rec["task"] == "slam" and rec["n_devices"] == 2
    assert rec["device"] == "cpu" and rec["n_scans"] == n_scans
    assert all(k > 5 for k in rec["keyframes"]), rec
    assert all(a < 0.3 for a in rec["ates"]), rec
    assert rec["keyframes"] == ref["keyframes"], (rec, ref)
    np.testing.assert_allclose(rec["ates"], ref["ates"], rtol=0,
                               atol=SLAM_ATE_TOL)
    cfg, seqs = tlaunch.slam_sessions(2, n_scans)
    for k, q in enumerate(seqs):
        st, _ = tpipe.run_slam_windowed(q.points, q.mask, q.odom, cfg)
        assert tlaunch.state_sha256(st) == rec["state_sha256"][k]
        assert rec["sessions"][k]["launches"] == {}   # plain versions
