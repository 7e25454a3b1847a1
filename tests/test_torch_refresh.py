"""Serving's map refresh (K16 ``refresh_points``), the smoother's need test
over S sessions (K5's fresh window of S sessions) and the chained initial
poses of S sessions, on the CPU.

- ``pipeline.refresh_points_ref`` (K16's plain twin) on three seeded
  stores against the JAX package's ``_refresh_map`` vmapped over them
  (jitted, f64), its inputs to ``add_points`` and its ``lax.top_k``
  captured: ``sel``, ``do`` and the masks exact, the staleness, points and
  weights within 1e-12. The stores hold equal positive staleness across
  the M-th place (``lax.top_k`` keeps the lower indices; ``torch.topk``
  need not), fewer than M stale keyframes,
  dead slots with moved poses, a session with ``enable`` false, and
  ``refresh_eps`` 0 and above the ties.
- ``slam_dp._refresh_stacked`` (one K16, one K3s, one K14 row write)
  against one ``pipeline._refresh_map`` a session and against the JAX
  package's vmapped ``_refresh_map``: statistics and ``map_kf_poses``.
- ``incremental.fresh_residual_max_stacked_ref`` against ``jax.vmap`` of
  the JAX package's ``fresh_residual_max``, and bit for bit against one
  ``fresh_residual_max_ref`` a session.
- ``odometry.chain_deltas`` with a leading session axis against
  ``jax.vmap(chain_deltas)``, and bit for bit against one call a session.
- K16's and the stacked K5 window's size checks (raised before any device
  work) and the CPU routing (no kernel reached; the kernels refuse CPU
  tensors).
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndtpu.config import GridConfig as JG, PipelineConfig as JP
from ndtpu.graph import factors as jfct
from ndtpu.graph import incremental as jinc
from ndtpu.ndt import grid as jgrid
from ndtpu.slam import keyframes as jkfs
from ndtpu.slam import odometry as jodo
from ndtpu.slam import pipeline as jpipe
from ndtpu_torch import convert, kernels
from ndtpu_torch.config import GridConfig as TG, PipelineConfig as TP
from ndtpu_torch.dist import slam_dp
from ndtpu_torch.graph import factors as tfct
from ndtpu_torch.graph import incremental as tinc
from ndtpu_torch.lie import se2
from ndtpu_torch.ndt import grid as tgrid
from ndtpu_torch.slam import keyframes as tkfs
from ndtpu_torch.slam import odometry as todo
from ndtpu_torch.slam import pipeline as tpipe

torch.set_num_threads(2)

CAP, N, M = 24, 7, 5
GRID = dict(x0=-8.0, y0=-8.0, cell=1.0, nx=16, ny=16, overlap=4)


def _cfgs(eps: float):
    """The same refresh in both packages' configs."""
    kw = dict(refresh_top_m=M, refresh_eps=eps)
    return (TP(grid=TG(**GRID), **kw), JP(grid=JG(**GRID), **kw))


def _moved(rng, live, offsets):
    """Keyframe poses on a 0.25 m lattice (dyadic: every difference below
    exact in both packages) and the poses the map saw them at, ``offsets``
    ``{slot: (dx, dy, dth)}`` apart; dead slots moved as well."""
    poses = np.zeros((CAP, 3))
    poses[:, :2] = rng.integers(-12, 13, (CAP, 2)) * 0.25
    poses[:, 2] = rng.integers(-8, 9, CAP) * 0.25
    mkp = poses.copy()
    for i, d in offsets.items():
        mkp[i] -= d
    return poses, mkp, live


def _session_ties(rng):
    """Staleness 1.0 (slot 2), 0.75 (7, by angle), 0.5 (1 and 9, a tie
    within the top M), 0.25 (3, 5 and 11: a tie across the M-th place, of
    which ``lax.top_k`` keeps slot 3), 0.125 (13); slot 20 dead and moved
    by 2 m; 16 live slots."""
    live = np.arange(CAP) < 16
    off = {2: (1.0, 0.0, 0.0), 7: (0.0, 0.0, 0.75), 1: (0.5, 0.0, 0.0),
           9: (0.0, 0.5, 0.0), 3: (0.25, 0.0, 0.0), 5: (0.0, -0.25, 0.0),
           11: (-0.25, 0.0, 0.0), 13: (0.0, 0.0, -0.125),
           20: (2.0, 0.0, 0.0)}
    return _moved(rng, live, off)


def _session_few(rng):
    """Two stale keyframes of six live: the other three selected rows are
    the lowest-index slots of staleness 0 (``do`` false); dead slots moved
    far."""
    live = np.arange(CAP) < 6
    off = {4: (0.5, 0.25, 0.0), 0: (0.0, 0.0, 0.5), 10: (3.0, 0.0, 1.0),
           17: (0.0, 2.0, 0.0)}
    return _moved(rng, live, off)


def _session_full(rng):
    """Every slot live, each moved by a seeded non-lattice offset."""
    live = np.ones(CAP, bool)
    off = {i: tuple(rng.normal(0.0, [0.3, 0.3, 0.2])) for i in range(CAP)}
    return _moved(rng, live, off)


SESSIONS = (_session_ties, _session_few, _session_full)
#: Which sessions' refresh is enabled.
ENABLES = {"all": (True, True, True), "one_off": (True, True, False)}


def _stores(seed: int = 0):
    """Three sessions (f64): keyframe poses, the poses their maps saw,
    live flags, scans ``[S, CAP, N, 2]`` and beam masks."""
    rng = np.random.default_rng(seed)
    parts = [f(rng) for f in SESSIONS]
    poses, mkp, live = (np.stack([p[i] for p in parts]) for i in range(3))
    pts = rng.normal(0.0, 2.0, (3, CAP, N, 2))
    msk = rng.random((3, CAP, N)) < 0.8
    return poses, mkp, live, pts, msk


def _jax_store(poses, pts, msk, live):
    return jkfs.KeyframeStore(
        poses=jnp.asarray(poses), points=jnp.asarray(pts),
        masks=jnp.asarray(msk), live=jnp.asarray(live),
        n=jnp.asarray(live.sum(-1), jnp.int32))


def _jax_refresh(stats8, kf8, mkp8, enable8, jcfg):
    """The JAX package's ``_refresh_map`` vmapped over the sessions
    (jitted), with what it gives ``add_points`` and what ``lax.top_k``
    returns: ``(stats8, mkp8, got)``."""

    def one(st, kf, mkp, en):
        got = {}
        add, top = jgrid.add_points, jax.lax.top_k

        def add_seen(stats, pts, msk, grid, weight=1.0):
            got.update(both=pts, bmsk=msk, wts=weight)
            return add(stats, pts, msk, grid, weight=weight)

        def top_seen(x, k):
            got["stale"] = x
            got["val"], got["sel"] = top(x, k)
            return got["val"], got["sel"]

        jgrid.add_points, jax.lax.top_k = add_seen, top_seen
        try:
            out = jpipe._refresh_map(st, kf, mkp, jcfg, enable=en)
        finally:
            jgrid.add_points, jax.lax.top_k = add, top
        return out + (got,)

    return jax.jit(jax.vmap(one))(stats8, kf8, mkp8, enable8)


def _stats8(pts, msk, poses):
    """Three sessions' maps (f64): every keyframe inserted at its pose."""
    grid = TG(**GRID)
    maps = []
    for i in range(pts.shape[0]):
        st = tgrid.empty_stats(grid, torch.float64, "cpu")
        world = se2.transform(torch.as_tensor(poses[i]),
                              torch.as_tensor(pts[i]))
        maps.append(tgrid.add_points(st, world.reshape(-1, 2),
                                     torch.as_tensor(msk[i]).reshape(-1),
                                     grid))
    return tgrid.NDTStats(*(torch.stack(f) for f in zip(*maps)))


@pytest.mark.parametrize("enable", list(ENABLES))
@pytest.mark.parametrize("eps", [0.0, 0.3])
def test_refresh_points_ref_matches_jax(eps, enable):
    """K16's twin against the JAX package's refresh inputs: ``sel``,
    ``do`` and the masks exact, points and weights within 1e-12; the tie
    across the M-th place resolved as ``lax.top_k`` resolves it."""
    poses, mkp, live, pts, msk = _stores()
    tcfg, jcfg = _cfgs(eps)
    en = np.asarray(ENABLES[enable])
    t = torch.as_tensor
    both, bmsk, wts, sel, do, rows = tpipe.refresh_points_ref(
        t(poses), t(live), t(pts), t(msk), t(mkp), t(en), M, eps)
    s = poses.shape[0]
    assert both.shape == (s, 2 * M * N, 2) and sel.dtype == torch.int64
    stats8 = convert.to_numpy(_stats8(pts, msk, poses))
    _, _, got = _jax_refresh(jax.tree_util.tree_map(jnp.asarray, stats8),
                             _jax_store(poses, pts, msk, live),
                             jnp.asarray(mkp), jnp.asarray(en), jcfg)
    np.testing.assert_array_equal(sel.numpy(), np.asarray(got["sel"]))
    jdo = (np.asarray(got["val"]) > eps) & en[:, None]
    np.testing.assert_array_equal(do.numpy(), jdo)
    np.testing.assert_array_equal(bmsk.numpy(), np.asarray(got["bmsk"]))
    np.testing.assert_allclose(both.numpy(), np.asarray(got["both"]),
                               rtol=0, atol=1e-12)
    np.testing.assert_array_equal(wts.numpy(), np.asarray(got["wts"]))
    np.testing.assert_array_equal(rows.numpy(),
                                  np.take_along_axis(poses, sel.numpy()[
                                      ..., None], 1))
    # The staleness the selection ranked within 1e-12 of JAX's.
    stale = tpipe.refresh_staleness(t(poses), t(live), t(mkp))
    np.testing.assert_allclose(stale.numpy(), np.asarray(got["stale"]),
                               rtol=0, atol=1e-12)
    # The cases are there: the tie keeps slot 3 (not 5 or 11), the few
    # session selects three zero rows in index order, switched off.
    assert sel[0].tolist() == [2, 7, 1, 9, 3]
    assert sel[1].tolist() == [4, 0, 1, 2, 3]
    assert do[1].tolist()[2:] == [False] * 3
    if eps > 0.25:
        assert not bool(do[0, 4])
    if enable == "one_off":
        assert not bool(do[2].any()) and not bool(bmsk[2].any())


def test_refresh_map_tie_matches_jax():
    """The single-session ``_refresh_map`` (the windowed path's) at the tie
    across the M-th place: the same keyframes re-placed and the same
    ``map_kf_poses`` rows written as the JAX package's."""
    poses, mkp, live, pts, msk = (a[0] for a in _stores(1))
    tcfg, jcfg = _cfgs(0.0)
    stats = tgrid.NDTStats(*(f[0] for f in _stats8(pts[None], msk[None],
                                                   poses[None])))
    kf = tkfs.KeyframeStore(torch.as_tensor(poses), torch.as_tensor(pts),
                            torch.as_tensor(msk), torch.as_tensor(live),
                            torch.as_tensor(live.sum()), None)
    ts, tm = tpipe._refresh_map(stats, kf, torch.as_tensor(mkp), tcfg)
    jstats = jax.tree_util.tree_map(jnp.asarray, convert.to_numpy(stats))
    js, jm = jax.jit(lambda s_, k_, m_: jpipe._refresh_map(
        s_, k_, m_, jcfg))(jstats, _jax_store(poses, pts, msk, live),
                           jnp.asarray(mkp))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    moved = np.flatnonzero((tm.numpy() != mkp).any(-1))
    assert moved.tolist() == [1, 2, 3, 7, 9]
    for a, b in zip(ts, js):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12,
                                   atol=1e-9)


@pytest.mark.parametrize("enable", list(ENABLES))
def test_refresh_stacked_matches_singles_and_jax(enable):
    """``_refresh_stacked`` (one K16, one K3s, one row write) against one
    ``_refresh_map`` a session (bit for bit) and the JAX package's vmapped
    ``_refresh_map`` (``map_kf_poses`` exact, statistics within 1e-12)."""
    poses, mkp, live, pts, msk = _stores(2)
    tcfg, jcfg = _cfgs(0.0)
    en = np.asarray(ENABLES[enable])
    t = torch.as_tensor
    stats8 = _stats8(pts, msk, poses)
    kf8 = tkfs.KeyframeStore(t(poses), t(pts), t(msk), t(live),
                             t(live.sum(-1)), None)
    ts8, tm8 = slam_dp._refresh_stacked(stats8, kf8, t(mkp), tcfg, t(en))
    for i in range(poses.shape[0]):
        st, mk = tpipe._refresh_map(
            tgrid.NDTStats(*(f[i] for f in stats8)), slam_dp._take(kf8, i),
            t(mkp[i]), tcfg, enable=t(en[i]))
        assert torch.equal(tm8[i], mk)
        for a, b in zip(ts8, st):
            assert torch.equal(a[i], b)
    js8, jm8, _ = _jax_refresh(
        jax.tree_util.tree_map(jnp.asarray, convert.to_numpy(stats8)),
        _jax_store(poses, pts, msk, live), jnp.asarray(mkp),
        jnp.asarray(en), jcfg)
    np.testing.assert_array_equal(tm8.numpy(), np.asarray(jm8))
    for a, b in zip(ts8, js8):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12,
                                   atol=1e-9)
    if enable == "one_off":
        assert torch.equal(tm8[2], t(mkp[2]))


F_CAP, V_CAP = 80, 40


def _graphs8(seed: int = 0):
    """Three sessions' pose graphs (f64, numpy): ``n_between`` 10 (the
    window clamped at slot 0), 70 and 80 (clamped at F - k), a dead factor
    inside each window."""
    rng = np.random.default_rng(seed)
    s = 3
    nb = np.array([10, 70, 80])
    a = np.triu(rng.normal(0.0, 2.0, (s, F_CAP, 3, 3))) + 5 * np.eye(3)
    return dict(
        poses=rng.normal(0.0, 3.0, (s, V_CAP, 3)),
        pose_mask=np.ones((s, V_CAP), bool),
        prior_idx=np.zeros((s, 4), np.int64), prior_z=np.zeros((s, 4, 3)),
        prior_sqrt_info=np.broadcast_to(np.eye(3), (s, 4, 3, 3)).copy(),
        prior_mask=np.zeros((s, 4), bool),
        bet_i=rng.integers(0, V_CAP, (s, F_CAP)),
        bet_j=rng.integers(0, V_CAP, (s, F_CAP)),
        bet_z=rng.normal(0.0, 1.0, (s, F_CAP, 3)), bet_sqrt_info=a,
        bet_mask=(np.arange(F_CAP) < nb[:, None])
        & (rng.random((s, F_CAP)) < 0.9),
        n_poses=np.full(s, V_CAP), n_priors=np.zeros(s, np.int64),
        n_between=nb)


def test_fresh_residual_max_stacked_matches_jax():
    g = _graphs8()
    tg = tfct.PoseGraph(**{k: torch.as_tensor(v) for k, v in g.items()})
    out = tinc.fresh_residual_max_stacked_ref(tg)
    ints = ("prior_idx", "bet_i", "bet_j", "n_poses", "n_priors",
            "n_between")
    jg = jfct.PoseGraph(**{k: jnp.asarray(v, jnp.int32 if k in ints
                                          else None)
                           for k, v in g.items()})
    ref = jax.jit(jax.vmap(jinc.fresh_residual_max))(jg)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-12)
    for i in range(3):
        one = tinc.fresh_residual_max_ref(slam_dp._take(tg, i))
        assert torch.equal(out[i], one)
    assert out.shape == (3,) and bool((out > 0).all())


def test_chain_deltas_batched_matches_jax():
    rng = np.random.default_rng(5)
    pose0 = rng.normal(0.0, [2.0, 2.0, 3.0], (4, 3))
    deltas = rng.normal(0.0, [0.3, 0.1, 0.2], (4, 8, 3))
    out = todo.chain_deltas(torch.as_tensor(pose0), torch.as_tensor(deltas))
    ref = jax.jit(jax.vmap(jodo.chain_deltas))(jnp.asarray(pose0),
                                               jnp.asarray(deltas))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-12)
    for i in range(4):
        one = todo.chain_deltas(torch.as_tensor(pose0[i]),
                                torch.as_tensor(deltas[i]))
        assert torch.equal(out[i], one)


def test_refresh_and_fresh_size_checks_raise_before_the_card():
    """K16's limits raise on CPU-built shapes before any device check:
    more keyframes than slots, a store whose staleness and selection
    exceed one block's shared memory (the launcher's formula, read from
    the source); K5's window of S sessions past one row block. Within the
    limits both kernels refuse CPU tensors: no fallback."""
    src = (Path(kernels.__file__).parent / "csrc"
           / "refresh_points.cu").read_text()
    cand_b, m_b = map(int, re.search(
        r"smem < (\d+) \* max_candidates\(cap, m\) \+ (\d+) \* m",
        src).groups())
    per_warp = re.search(r"per_warp = m < (\d+) \? m : (\d+);", src)
    assert per_warp.groups() == ("32", "32")
    for cap, m in ((512, 12), (160, 12), (1000, 40), (7, 7)):
        cand = min(cap, -(-cap // 32) * min(m, 32))
        assert kernels.refresh_smem(cap, m) == -(-(cand_b * cand + m_b * m)
                                                 // 16) * 16
    big = kernels.refresh_max_cap(12) + 1
    assert kernels.refresh_smem(big - 1, 12) <= kernels.SMEM_MAX
    assert kernels.refresh_smem(big, 12) > kernels.SMEM_MAX
    assert kernels.refresh_max_cap(512) >= 512 and big > 16384

    def call(cap, m, n=4):
        z = torch.zeros
        return kernels.refresh_points(
            z((1, cap, 3)), z((1, cap), dtype=torch.bool), z((1, cap, n, 2)),
            z((1, cap, n), dtype=torch.bool), z((1, cap, 3)), None, m, 0.0)

    with pytest.raises(ValueError, match="shared memory"):
        call(big, 12, 1)
    with pytest.raises(ValueError, match="from a store of 8"):
        call(8, 9)
    with pytest.raises(ValueError, match="CUDA"):
        call(big - 1, 12, 1)
    g = tfct.PoseGraph(**{k: torch.as_tensor(v) for k, v in
                          _graphs8().items()})
    g = g._replace(bet_i=torch.zeros(3, 300, dtype=torch.long))
    with pytest.raises(ValueError, match="300 slots"):
        kernels.fresh_residual_max_stacked(
            g.poses, g.bet_i, g.bet_i, g.bet_z, g.bet_sqrt_info, g.bet_mask,
            g.n_between, 300)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.fresh_residual_max_stacked(
            g.poses.float(), g.bet_i, g.bet_j, g.bet_z.float(),
            g.bet_sqrt_info.float(), g.bet_mask, g.n_between, 64)


def test_cpu_route_reaches_no_kernel(monkeypatch):
    """On CPU tensors the refresh (stacked and single), the stacked need
    test and the chained poses run the twins: no kernel is reached."""

    def refuse(*a, **k):
        raise AssertionError("a kernel was reached on the CPU")

    for name in ("refresh_points", "fresh_residual_max_stacked",
                 "halfcell_add", "halfcell_add_stacked", "rows_set"):
        monkeypatch.setattr(kernels, name, refuse)
    poses, mkp, live, pts, msk = (torch.as_tensor(a) for a in _stores(3))
    tcfg, _ = _cfgs(0.0)
    kf8 = tkfs.KeyframeStore(poses, pts, msk, live, live.sum(-1), None)
    stats8 = _stats8(pts.numpy(), msk.numpy(), poses.numpy())
    kernels.reset_launches()
    slam_dp._refresh_stacked(stats8, kf8, mkp, tcfg, torch.ones(3, dtype=bool))
    tpipe._refresh_map(tgrid.NDTStats(*(f[0] for f in stats8)),
                       slam_dp._take(kf8, 0), mkp[0], tcfg)
    g = tfct.PoseGraph(**{k: torch.as_tensor(v) for k, v in
                          _graphs8().items()})
    tinc.fresh_residual_max_stacked(g)
    todo.chain_deltas(poses[:, 0], poses)
    assert not any(kernels.LAUNCHES.values())
