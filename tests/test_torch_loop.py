"""ndtpu_torch.loop.closure against ndtpu.loop.closure on the same f64
inputs: candidate search, the local tables (single and batched into the
cache), the gate, and the flat cached verification per lane; and the CPU
dispatch of the K8a / K8b wrappers."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndtpu.config import LoopConfig, MatchConfig, NDTMapConfig
from ndtpu.loop import closure as jclosure
from ndtpu.ndt.match import MatchResult as JMatchResult
from ndtpu.slam import keyframes as jkfs
from ndtpu_torch import convert, kernels
from ndtpu_torch.data import synth as tsynth
from ndtpu_torch.loop import closure as tclosure
from ndtpu_torch.ndt.match import MatchResult
from ndtpu_torch.slam import keyframes as tkfs

torch.set_num_threads(2)

LOOP = LoopConfig(radius=5.0, min_index_gap=5, max_candidates=4,
                  local_half_extent=4.0, max_accept_per_query=2)
NDT = NDTMapConfig()


def _t(a):
    return torch.as_tensor(np.array(a))


def _close(a, b, rtol=1e-12):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    scale = max(1.0, float(np.abs(b).max()))
    np.testing.assert_allclose(a, b, rtol=0, atol=rtol * scale)


@pytest.fixture(scope="module")
def scans():
    """A 64-scan box-world lap (90 beams, f64) from the port's synth."""
    world = tsynth.box_world(11.0)
    traj = tsynth.rectangle_trajectory(64, half=2.0, step=0.25)
    s = tsynth.make_sequence(world, traj, 90, 20.0, 0.1, seed=3)
    return dict(points=s.points.double().numpy(), mask=s.mask.numpy(),
                gt=s.gt_poses.double().numpy())


@pytest.fixture(scope="module")
def stores(scans):
    """Every 2nd scan as a keyframe (32 of capacity 40) at a perturbed
    pose, with its local table: the JAX store and the port's copy."""
    rng = np.random.default_rng(4)
    sel = np.arange(0, 64, 2)
    cap, n = 40, len(sel)
    poses = np.zeros((cap, 3))
    poses[:n] = scans["gt"][sel] + rng.normal(0, [0.05, 0.05, 0.01], (n, 3))
    pts = np.zeros((cap, 90, 2))
    pts[:n] = scans["points"][sel]
    msk = np.zeros((cap, 90), bool)
    msk[:n] = scans["mask"][sel]
    build = jax.jit(jax.vmap(lambda p, m: jclosure.build_local_table(
        p, m, LOOP, NDT, False)))
    tables = np.array(build(jnp.asarray(pts), jnp.asarray(msk)))
    tables[n:] = 0.0
    live = np.arange(cap) < n
    jstore = jkfs.KeyframeStore(
        poses=jnp.asarray(poses), points=jnp.asarray(pts),
        masks=jnp.asarray(msk), live=jnp.asarray(live),
        n=jnp.asarray(n, jnp.int32), tables=jnp.asarray(tables))
    return jstore, convert.from_numpy(jstore)


def test_find_candidates_ties_and_edges():
    """Equal distances come out in index order; the radius and the index
    gap are inclusive at their edges; dead slots never qualify."""
    cap = 16
    poses = np.zeros((cap, 3))
    # Distances from the query at the origin: 3 (radius, in), 4 (out),
    # 2.0 x 4 (ties at 1, 5, 7, 9), 1.0 (slot 11: gap edge), 0.5 (slot 12:
    # one short of the gap), 1.5 (slot 3, dead).
    poses[0] = [3.0, 0.0, 0.0]
    poses[2] = [0.0, 4.0, 0.0]
    for k in (1, 5, 7, 9):
        poses[k] = [0.0, -2.0, 0.3] if k % 4 == 1 else [-2.0, 0.0, 0.0]
    poses[11] = [1.0, 0.0, 0.0]
    poses[12] = [0.0, 0.5, 0.0]
    poses[3] = [1.5, 0.0, 0.0]
    for k in (4, 6, 8, 10):
        poses[k] = [10.0 + k, 0.0, 0.0]
    live = np.ones(cap, bool)
    live[3] = False
    live[13:] = False
    loop = dataclasses.replace(LOOP, radius=3.0, min_index_gap=5,
                               max_candidates=6)
    jstore = jkfs.KeyframeStore(
        poses=jnp.asarray(poses), points=jnp.zeros((cap, 4, 2)),
        masks=jnp.zeros((cap, 4), bool), live=jnp.asarray(live),
        n=jnp.asarray(13, jnp.int32))
    tstore = convert.from_numpy(jstore)
    qp = np.array([[0.0, 0.0, 0.0], [-2.0, -2.0, 1.0], [50.0, 0.0, 0.0]])
    qi = np.array([16, 14, 16])
    jc = jax.vmap(jclosure.find_candidates, in_axes=(None, 0, 0, None))(
        jstore, jnp.asarray(qp), jnp.asarray(qi, jnp.int32), loop)
    tc = tclosure.find_candidates(tstore, _t(qp), _t(qi), loop)
    for a, b in zip(tc, jc):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # Query 0: slot 11 (d=1) first, the four ties at d=2 in index order,
    # then slot 0 at d=3 == radius; slot 12 is one index short of the gap.
    assert tc.idx[0].tolist() == [11, 1, 5, 7, 9, 0]
    assert tc.mask[0].all() and not tc.mask[2].any()


def test_build_local_table_matches_jax(scans):
    pts, msk = scans["points"][10], scans["mask"][10]
    for cfg in (LOOP, dataclasses.replace(
            LOOP, local_half_extent=3.0, local_cell=0.75)):
        tj = jclosure.build_local_table(jnp.asarray(pts), jnp.asarray(msk),
                                        cfg, NDT, False)
        tt = tclosure.build_local_table(_t(pts), _t(msk), cfg, NDT, False)
        assert tt.shape == tclosure.local_table_shape(cfg, False)
        valid = [8 * g + 5 for g in range(4)]
        np.testing.assert_array_equal(tt[:, valid].numpy(),
                                      np.asarray(tj)[:, valid])
        assert float(tt[:, valid].sum()) > 0
        _close(tt.numpy(), tj)


def test_write_local_tables_batched_into_cache(scans):
    """The batched twin writes only the ``ok`` rows, at their slots, and
    drops slots outside the cache (JAX's mode='drop')."""
    w = 6
    pts, msk = scans["points"][20:20 + w], scans["mask"][20:20 + w]
    slot = np.array([3, 0, 7, 9, 2, 8])
    ok = np.array([True, False, True, True, True, False])
    shape = (9,) + tclosure.local_table_shape(LOOP, False)
    built = jax.vmap(lambda p, m: jclosure.build_local_table(
        p, m, LOOP, NDT, False))(jnp.asarray(pts), jnp.asarray(msk))
    base = np.random.default_rng(5).normal(size=shape)
    ref = jnp.asarray(base).at[jnp.where(ok, slot, 1 << 30)].set(
        built, mode="drop")
    kernels.reset_launches()
    out = tclosure.write_local_tables(_t(base), _t(slot), _t(ok), _t(pts),
                                      _t(msk), LOOP, NDT)
    assert kernels.LAUNCHES["local_tables"] == 0
    valid = [8 * g + 5 for g in range(4)]
    np.testing.assert_array_equal(out[..., valid].numpy(),
                                  np.asarray(ref)[..., valid])
    _close(out.numpy(), ref)


def _gate_inputs():
    """3 queries x 6 candidates: top-K ties (row 0), fewer than K accepted
    (row 1), innovation rejections and an accepted indefinite Hessian
    (row 2)."""
    rng = np.random.default_rng(6)
    k, c = 3, 6
    a = rng.normal(size=(k, c, 3, 3))
    hess = np.einsum("kcij,kclj->kcil", a, a) + 50.0 * np.eye(3)
    hess[2, 1] = np.diag([40.0, -5.0, 2.0])                 # indefinite
    hess[2, 1, 0, 2] = hess[2, 1, 2, 0] = 3.0
    score = np.array([[0.9, 0.8, 0.8, 0.5, 0.95, 0.8],
                      [0.2, 0.6, 0.1, 0.25, 0.29, 0.0],
                      [0.7, 0.9, 0.65, 0.8, 0.85, 0.6]])
    conv = np.ones((k, c), bool)
    conv[0, 4] = False
    mask = np.ones((k, c), bool)
    mask[1, 0] = False
    init = rng.normal(0, 1.0, (k, c, 3))
    pose = init + rng.normal(0, 0.05, (k, c, 3))
    pose[2, 0, :2] += [3.0, 0.0]      # far beyond its budget
    pose[2, 3, :2] += [0.0, 1.5]      # inside the budget of gap 40
    idx = np.array([[1, 2, 3, 4, 5, 6], [0, 1, 2, 3, 4, 5],
                    [5, 12, 30, 2, 8, 9]])
    qidx = np.array([30, 30, 42])
    return (JMatchResult(pose=pose, hessian=hess, score=score,
                         n_iter=np.zeros((k, c), np.int32), converged=conv),
            jclosure.LoopCandidates(idx=idx, mask=mask,
                                    dist=np.zeros((k, c))), init, qidx)


def test_gate_and_pack_matches_jax():
    res, cands, init, qidx = _gate_inputs()
    loop = dataclasses.replace(LOOP, max_candidates=6,
                               max_innovation_per_kf=0.02)
    jr = jax.vmap(lambda r, cd, i0, qi: jclosure._gate_and_pack(
        r, cd, loop, jnp.float64, i0, qi))(
        JMatchResult(*map(jnp.asarray, res)),
        jclosure.LoopCandidates(*map(jnp.asarray, cands)),
        jnp.asarray(init), jnp.asarray(qidx, jnp.int32))
    kernels.reset_launches()
    tr = tclosure.gate_and_pack(
        MatchResult(*map(_t, res)),
        tclosure.LoopCandidates(*map(_t, cands)), loop, _t(init), _t(qidx))
    assert kernels.LAUNCHES["loop_gate"] == 0
    np.testing.assert_array_equal(tr.accept.numpy(), np.asarray(jr.accept))
    np.testing.assert_array_equal(tr.innov_rej.numpy(),
                                  np.asarray(jr.innov_rej))
    _close(tr.sqrt_info.numpy(), jr.sqrt_info)
    for a, b in [(tr.j, jr.j), (tr.z, jr.z), (tr.score, jr.score)]:
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    acc = tr.accept.numpy()
    # Row 0: the K=2 budget keeps 0.9 and all three tied 0.8s.
    assert acc[0].tolist() == [True, True, True, False, False, True]
    # Row 1: one lane over the gate, fewer than K: it stays.
    assert acc[1].tolist() == [False, True, False, False, False, False]
    # Row 2: lane 0 is innovation-rejected (lane 3 moved 1.5 m, inside its
    # budget), the budget keeps the top two scores, and the indefinite
    # lane 1 is accepted with a finite, floored information (R^T R >=
    # 1e-3 I).
    assert tr.innov_rej[2].tolist() == [True] + [False] * 5
    assert acc[2].tolist() == [False, True, False, False, True, False]
    r = tr.sqrt_info[2, 1]
    assert bool(torch.isfinite(r).all())
    assert float(torch.linalg.eigvalsh(r.T @ r).min()) >= 1e-3 - 1e-9


@pytest.mark.parametrize("knobs", ["default", "serving", "two_phase"])
def test_verify_candidates_cached_flat_matches_jax(scans, stores, knobs):
    """Per lane against JAX: pose, score and flags of 3 queries x 4
    candidates; "serving" caps the iterations and strides the beams
    (``verify_max_iter``, ``verify_beam_stride``), "two_phase" compacts
    the LM's stragglers across all 12 lanes."""
    jstore, tstore = stores
    loop, mcfg = LOOP, MatchConfig()
    if knobs == "serving":
        loop = dataclasses.replace(LOOP, verify_max_iter=8,
                                   verify_beam_stride=2)
    elif knobs == "two_phase":
        mcfg = MatchConfig(phase2_width=4, phase1_iters=3)
    rng = np.random.default_rng(7)
    q = np.array([62, 63, 40])
    qpose = scans["gt"][q] + rng.normal(0, [0.1, 0.1, 0.03], (3, 3))
    qidx = np.array([32, 33, 34])
    qpts, qmsk = scans["points"][q], scans["mask"][q]

    @jax.jit
    def jrun(kf, p, m, qp, qi):
        cands = jax.vmap(jclosure.find_candidates,
                         in_axes=(None, 0, 0, None))(kf, qp, qi, loop)
        return cands, jclosure.verify_candidates_cached_flat(
            kf, p, m, qp, cands, loop, mcfg, qi)

    jc, jr = jrun(jstore, jnp.asarray(qpts), jnp.asarray(qmsk),
                  jnp.asarray(qpose), jnp.asarray(qidx, jnp.int32))
    tr = tclosure.detect_loops_cached_flat(tstore, _t(qpts), _t(qmsk),
                                           _t(qpose), _t(qidx), loop, mcfg)
    np.testing.assert_array_equal(tr.j.numpy(), np.asarray(jc.idx))
    assert bool(np.asarray(jc.mask).all())
    np.testing.assert_array_equal(tr.accept.numpy(), np.asarray(jr.accept))
    np.testing.assert_array_equal(tr.innov_rej.numpy(),
                                  np.asarray(jr.innov_rej))
    np.testing.assert_allclose(tr.z.numpy(), np.asarray(jr.z), rtol=0,
                               atol=1e-8)
    np.testing.assert_allclose(tr.score.numpy(), np.asarray(jr.score),
                               rtol=0, atol=1e-10)
    _close(tr.sqrt_info.numpy(), jr.sqrt_info, 1e-8)
    assert tr.accept.any()


def test_kernel_entry_points_refuse_cpu_and_oversized_lattices(stores):
    _, tstore = stores
    res, cands, init, qidx = _gate_inputs()
    f32 = lambda a: _t(a).float()
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.loop_gate(_t(cands.mask), _t(res.converged), f32(res.score),
                          f32(res.pose), f32(init), f32(res.hessian),
                          _t(cands.idx).int(), _t(qidx).int(), 0.3, 1.0, 0.02,
                          2)
    w = 2
    args = (torch.zeros(w, dtype=torch.int32), torch.ones(w, dtype=torch.bool),
            torch.zeros((w, 90, 2)), torch.ones((w, 90), dtype=torch.bool))
    lgrid = tclosure.local_grid_config(LOOP)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.local_tables(tstore.tables.float(), *args, lgrid, NDT)
    # K8a holds one band of 3 lattice rows in 48 KB: a 361-wide lattice
    # (180 x 180 cells) needs 51,984 B.
    big = tclosure.local_grid_config(dataclasses.replace(
        LOOP, local_half_extent=90.0))
    with pytest.raises(ValueError, match="shared memory"):
        kernels.local_tables(tstore.tables.float(), *args, big, NDT)


def test_keyframe_store_with_tables_matches_jax():
    """``empty_store(table_shape=)`` / ``add_keyframe(table=)``: the table
    lands in the keyframe's slot; an append past capacity changes
    nothing."""
    rng = np.random.default_rng(10)
    shape = (5, 8)
    js = jkfs.empty_store(2, 3, jnp.float64, table_shape=shape)
    ts = convert.from_numpy(js)
    assert tuple(ts.tables.shape) == (2,) + shape
    for k in range(3):
        pose, pts = rng.normal(size=3), rng.normal(size=(3, 2))
        msk, tbl = rng.random(3) > 0.5, rng.normal(size=shape)
        js = jkfs.add_keyframe(js, jnp.asarray(pose), jnp.asarray(pts),
                               jnp.asarray(msk), table=jnp.asarray(tbl))
        ts = tkfs.add_keyframe(ts, _t(pose), _t(pts), _t(msk), table=_t(tbl))
    for a, b in zip(convert.to_numpy(ts), js):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert int(ts.n) == 2
