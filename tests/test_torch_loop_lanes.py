"""The loop verify's set-up (K15 ``loop_lanes``) and serving's verify fused
across sessions, on the CPU.

- ``closure.loop_lanes_ref`` (K15's plain twin: the candidate search and
  the gated ``lm_ndt``'s lanes of ``S x K`` queries) against the JAX
  package's ``find_candidates`` (vmapped over the queries) and the lane
  set-up of ``verify_candidates_cached_flat`` (``ndtpu/loop/closure.py``
  :285-291), jitted, in f64, per session: indices, masks and groups exact,
  distances and initial poses within 1e-12, the lanes' scans exact. The
  stores hold equal distances (duplicate poses), queries with fewer than C
  eligible keyframes (the masked lanes in index order), keyframes exactly
  at the radius and at the index gap, dead slots, and three sessions of
  different fill.
- ``slam_dp._appends_stacked`` (one K8a write, one K15 and one gated
  verify for all sessions) against one ``pipeline._wb_appends`` per
  session, bit for bit, on windows with loops; a session whose keyframe
  slot reaches the cache's capacity writes nothing into the next session's
  tables.
- K15's size checks (a store past the sort's shared memory, more than 128
  candidates), which raise before any device work, and the CPU routing
  (no kernel reached; the kernel refuses CPU tensors).
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndtpu.config import LoopConfig
from ndtpu.lie import se2 as jse2
from ndtpu.loop import closure as jclosure
from ndtpu.slam import keyframes as jkfs
from ndtpu_torch import kernels
from ndtpu_torch.config import (GridConfig as TG, KeyframeConfig as TK,
                                LoopConfig as TL, PipelineConfig as TP,
                                SolverConfig as TS)
from ndtpu_torch.data import synth as tsynth
from ndtpu_torch.dist import slam_dp
from ndtpu_torch.loop import closure as tclosure
from ndtpu_torch.slam import pipeline as tpipe

torch.set_num_threads(2)

CAP, W, N, C = 24, 5, 7, 6
LOOP = LoopConfig(radius=3.0, min_index_gap=5, max_candidates=C)


def _session_edges(rng):
    """Distances from the origin: 3 (the radius, in), 4 (out), four ties at
    2 (slots 1, 5, 7, 9), 1 at slot 11 (the gap's edge for a query at
    16), 0.5 at slot 12 (one short of it), 1.5 at dead slot 3; 13 live
    slots."""
    poses = np.zeros((CAP, 3))
    poses[:, 2] = rng.uniform(-3.0, 3.0, CAP)
    poses[0, :2] = [3.0, 0.0]
    poses[2, :2] = [0.0, 4.0]
    for k in (1, 5, 7, 9):
        poses[k, :2] = [0.0, -2.0] if k % 4 == 1 else [-2.0, 0.0]
    poses[11, :2] = [1.0, 0.0]
    poses[12, :2] = [0.0, 0.5]
    poses[3, :2] = [1.5, 0.0]
    for k in (4, 6, 8, 10):
        poses[k, :2] = [10.0 + k, 0.0]
    live = np.arange(CAP) < 13
    live[3] = False
    qp = np.array([[0.0, 0.0, 0.2], [-2.0, -2.0, 1.0], [50.0, 0.0, -0.4]])
    return poses, live, qp, np.array([16, 14, 16])


def _session_few(rng):
    """Two eligible keyframes of eight live: the other four lanes take the
    lowest-index ineligible slots, masked."""
    poses = np.zeros((CAP, 3))
    poses[:, :2] = rng.uniform(20.0, 30.0, (CAP, 2))
    poses[:, 2] = rng.uniform(-3.0, 3.0, CAP)
    poses[2, :2] = [0.5, -0.25]
    poses[6, :2] = [-1.0, 1.0]
    live = np.arange(CAP) < 8
    qp = np.array([[0.0, 0.0, 0.0], [0.25, 0.0, 2.5], [1.0, 1.0, -3.0]])
    return poses, live, qp, np.array([12, 7, 6])


def _session_full(rng):
    """Every slot live, poses on a 0.5 m lattice (many equal distances),
    some duplicated."""
    poses = np.zeros((CAP, 3))
    poses[:, :2] = rng.integers(-4, 5, (CAP, 2)) * 0.5
    poses[:, 2] = rng.uniform(-3.0, 3.0, CAP)
    poses[[5, 17, 20]] = poses[2]
    live = np.ones(CAP, bool)
    qp = np.array([[0.0, 0.0, 0.1], [0.5, -0.5, 3.0], [1.5, 1.0, -2.0]])
    return poses, live, qp, np.array([30, 24, 12])


SESSIONS = (_session_edges, _session_few, _session_full)


def _stores(seed: int):
    """Three sessions' stores and windows (f64): poses, live flags, the
    windows' scans and poses with each session's queries at seeded rows
    ``sel``, and the queries' indices."""
    rng = np.random.default_rng(seed)
    parts = [f(rng) for f in SESSIONS]
    poses = np.stack([p[0] for p in parts])
    live = np.stack([p[1] for p in parts])
    qidx = np.stack([p[3] for p in parts])
    s, k = qidx.shape
    sel = np.stack([rng.permutation(W)[:k] for _ in range(s)])
    wposes = rng.normal(0.0, 5.0, (s, W, 3))
    for i in range(s):
        wposes[i, sel[i]] = parts[i][2]
    pts = rng.normal(0.0, 4.0, (s, W, N, 2))
    msk = rng.random((s, W, N)) < 0.8
    return poses, live, pts, msk, wposes, sel, qidx


@jax.jit
def _jax_search(poses, live, qpose, qidx):
    kf = jkfs.KeyframeStore(poses=poses, points=jnp.zeros((CAP, 1, 2)),
                            masks=jnp.zeros((CAP, 1), bool), live=live,
                            n=jnp.asarray(0, jnp.int32))
    return jax.vmap(jclosure.find_candidates, in_axes=(None, 0, 0, None))(
        kf, qpose, qidx, LOOP)


@jax.jit
def _jax_init(poses, cand_idx, qpose):
    """``verify_candidates_cached_flat``'s lane set-up (:285-289)."""
    k, c = cand_idx.shape
    flat_idx = cand_idx.reshape(-1)
    qp = jnp.broadcast_to(qpose[:, None, :], (k, c, 3)).reshape(-1, 3)
    return jse2.between(poses[flat_idx], qp)


def _jax_scans(qpts, qmsk, c: int, stride: int):
    """Its broadcast query scans (:280-282, :290-291)."""
    qpts, qmsk = qpts[:, ::stride], qmsk[:, ::stride]
    k, n = qmsk.shape
    pts = np.broadcast_to(qpts[:, None], (k, c, n, 2)).reshape(k * c, n, 2)
    msk = np.broadcast_to(qmsk[:, None], (k, c, n)).reshape(k * c, n)
    return pts, msk


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("seed", [0, 1])
def test_loop_lanes_ref_matches_jax(seed, stride):
    poses, live, pts, msk, wposes, sel, qidx = _stores(seed)
    t = torch.as_tensor
    out = tclosure.loop_lanes_ref(t(poses), t(live), t(pts), t(msk),
                                  t(wposes), t(sel), t(qidx), LOOP.radius,
                                  LOOP.min_index_gap, C, stride)
    idx, mask, dist, init, group, qi, px, py, mask_f = out
    s, k = qidx.shape
    assert idx.shape == (s, k, C) and init.shape == (s * k * C, 3)
    n_out = -(-N // stride)
    assert px.shape == (s * k * C, n_out) and group.dtype == torch.int32
    masked = 0
    for i in range(s):
        qpose = wposes[i, sel[i]]
        jc = _jax_search(jnp.asarray(poses[i]), jnp.asarray(live[i]),
                         jnp.asarray(qpose), jnp.asarray(qidx[i], jnp.int32))
        np.testing.assert_array_equal(idx[i].numpy(), np.asarray(jc.idx))
        np.testing.assert_array_equal(mask[i].numpy(), np.asarray(jc.mask))
        np.testing.assert_allclose(dist[i].numpy(), np.asarray(jc.dist),
                                   rtol=0, atol=1e-12)
        lanes = slice(i * k * C, (i + 1) * k * C)
        np.testing.assert_allclose(
            init[lanes].numpy(),
            np.asarray(_jax_init(jnp.asarray(poses[i]), jc.idx,
                                 jnp.asarray(qpose))), rtol=0, atol=1e-12)
        np.testing.assert_array_equal(group[lanes].numpy(),
                                      np.asarray(jc.idx).reshape(-1)
                                      + i * CAP)
        np.testing.assert_array_equal(qi[i * k:(i + 1) * k].numpy(),
                                      qidx[i] + i * CAP)
        jpts, jmsk = _jax_scans(pts[i, sel[i]], msk[i, sel[i]], C, stride)
        np.testing.assert_array_equal(px[lanes].numpy(), jpts[..., 0])
        np.testing.assert_array_equal(py[lanes].numpy(), jpts[..., 1])
        np.testing.assert_array_equal(mask_f[lanes].numpy(),
                                      jmsk.astype(np.float64))
        masked += int((~np.asarray(jc.mask)).sum())
    # The edge cases are there: query 0 of session 0 takes slot 11 at the
    # gap's edge, the ties in index order and slot 0 at the radius; session
    # 1's queries have masked lanes at the lowest ineligible slots.
    assert idx[0, 0].tolist() == [11, 1, 5, 7, 9, 0]
    assert mask[0, 0].all() and not mask[0, 2].any()
    assert idx[1, 0].tolist() == [2, 6, 0, 1, 3, 4]
    assert mask[1, 0].tolist() == [True] * 2 + [False] * 4
    assert masked > 0


def test_loop_lanes_ref_search_alone_and_given_candidates():
    """Without lanes the twin returns the search alone; with given
    candidates it returns them and their lanes, as after its own search."""
    poses, live, pts, msk, wposes, sel, qidx = (torch.as_tensor(a) for a in
                                                _stores(2))
    args = (poses, live, pts, msk, wposes, sel, qidx, LOOP.radius,
            LOOP.min_index_gap, C)
    full = tclosure.loop_lanes_ref(*args)
    alone = tclosure.loop_lanes_ref(poses, live, None, None, wposes, sel,
                                    qidx, LOOP.radius, LOOP.min_index_gap, C,
                                    lanes=False)
    assert all(x is None for x in alone[3:])
    for a, b in zip(alone[:3], full[:3]):
        assert torch.equal(a, b)
    given = tclosure.loop_lanes_ref(*args, 1, True, full[0], full[1])
    assert given[2] is None and given[0] is full[0]
    for a, b in zip(given[3:], full[3:]):
        assert torch.equal(a, b)


#: K15's search block: its warps (``kThreads / 32`` of
#: ``csrc/loop_lanes.cu``), each streaming its share of the store.
_SRC = (Path(kernels.__file__).parent / "csrc" / "loop_lanes.cu").read_text()
K15_WARPS = int(re.search(r"kThreads = (\d+);", _SRC).group(1)) // 32
_NONE = np.uint64(2 ** 64 - 1)


def _f32_dist(poses, qpose) -> np.ndarray:
    """``sqrt(dx dx + dy dy)`` in f32 as the plain version computes it on
    this device (torch: its CPU ``sqrt`` may differ from numpy's in the last
    bit; on the card both it and the kernel's ``sqrtf`` round correctly)."""
    p = torch.as_tensor(poses[:, :2], dtype=torch.float32)
    q = torch.as_tensor(qpose[:2], dtype=torch.float32)
    dx, dy = p[:, 0] - q[0], p[:, 1] - q[1]
    return torch.sqrt(dx * dx + dy * dy).numpy()


def _k15_model(poses, live, qpose, qidx, radius, gap, c):
    """K15's search for one query, as the kernel runs it (numpy, f32): the
    keys (distance bits << 32 | slot; :func:`_f32_dist`), each warp's
    running top ``c`` over rounds of 32 slots (slot ``i`` in warp ``(i //
    32) % warps``; a round's keys below the list's c-th merged in), then
    each warp-list candidate's rank as the count of smaller keys in every
    list (binary searches), the candidates ranked below ``c`` at their
    rank. Returns ``(idx, mask, dist)``."""
    f32 = np.float32
    cap = poses.shape[0]
    slots = np.arange(cap)
    d = _f32_dist(poses, qpose)
    ok = live & (d <= f32(radius)) & (qidx - slots >= gap)
    dm = np.where(ok, d, f32(np.inf)).astype(f32)
    keys = (dm.view(np.uint32).astype(np.uint64) << np.uint64(32)) | \
        slots.astype(np.uint64)
    span = 32 * K15_WARPS
    rounds = -(-cap // span)
    keys = np.concatenate([keys, np.full(rounds * span - cap, _NONE)])
    lists = np.full((K15_WARPS, c), _NONE)
    for new in keys.reshape(rounds, K15_WARPS, 32):
        enter = np.where(new < lists[:, -1:], new, _NONE)
        lists = np.sort(np.concatenate([lists, enter], 1), axis=1)[:, :c]
    cand = lists.reshape(-1)
    rank = sum(np.searchsorted(lst, cand, "left") for lst in lists)
    out = np.full(c, _NONE)
    keep = (cand != _NONE) & (rank < c)
    out[rank[keep]] = cand[keep]
    assert not (out == _NONE).any()
    dist = (out >> np.uint64(32)).astype(np.uint32).view(f32)
    return (out & np.uint64(0xffffffff)).astype(np.int64), \
        np.isfinite(dist), dist


def _model_store(kind: str, cap: int, c: int, rng):
    """A store for the model: ``random`` (a quarter to three quarters
    live, ~2 c keyframes within the radius of a query), ``ties`` (poses on
    a 0.5 m lattice, so most distances repeat), ``full`` (every slot live)
    or ``masked`` (no slot live: the lowest-index slots, masked). Three
    queries near live keyframes, indexed past the fill; radius 5 m, gap
    25."""
    fill = cap if kind == "full" else int(rng.integers(cap // 4,
                                                        3 * cap // 4))
    side = float(np.sqrt(np.pi * 25.0 * fill / (2.0 * c)))
    poses = np.zeros((cap, 3))
    poses[:, :2] = rng.uniform(0.0, side, (cap, 2))
    if kind == "ties":
        poses[:, :2] = np.round(poses[:, :2] * 2.0) / 2.0
    poses[:, 2] = rng.uniform(-np.pi, np.pi, cap)
    live = np.arange(cap) < fill
    if kind == "masked":
        live[:] = False
    qp = poses[rng.integers(0, fill, 3)] + rng.normal(0.0, [0.5, 0.5, 0.1],
                                                      (3, 3))
    if kind == "ties":
        qp[:, :2] = np.round(qp[:, :2] * 2.0) / 2.0
    return poses, live, qp, fill + np.arange(3)


@pytest.mark.parametrize("c", [1, 16, 64, 128])
@pytest.mark.parametrize("kind,cap", [("random", 1024), ("ties", 4096),
                                      ("full", 16384), ("masked", 512)])
def test_k15_selection_model_matches_plain_and_stable_sort(kind, cap, c):
    """The kernel's selection (per-warp running top C, then each candidate's
    rank among all warps' candidates), modelled in numpy, against
    ``loop_lanes_ref`` (torch, f32) and a stable sort of the masked
    distances: the same slots in the same order, the same masks and
    distance bits, over seeded stores from 512 to 16,384 slots (random,
    tie-heavy, full, every slot masked off) at C = 1, 16, 64 and 128."""
    rng = np.random.default_rng(cap + c)
    poses, live, qp, qidx = _model_store(kind, cap, c, rng)
    radius, gap = 5.0, 25
    t = lambda a, dt=None: torch.as_tensor(np.asarray(a, dt))
    ref = tclosure.loop_lanes_ref(
        t(poses[None], np.float32), t(live[None]), None, None,
        t(qp[None], np.float32), t(np.arange(3)[None]), t(qidx[None]),
        radius, gap, c, lanes=False)
    n_in = 0
    for q in range(3):
        idx, mask, dist = _k15_model(poses, live, qp[q], qidx[q], radius,
                                     gap, c)
        assert np.array_equal(idx, ref[0][0, q].numpy())
        assert np.array_equal(mask, ref[1][0, q].numpy())
        assert np.array_equal(dist.view(np.uint32),
                              ref[2][0, q].numpy().view(np.uint32))
        d = _f32_dist(poses, qp[q])
        ok = live & (d <= np.float32(radius)) & (qidx[q] - np.arange(cap)
                                                 >= gap)
        order = np.argsort(np.where(ok, d, np.inf), kind="stable")[:c]
        assert np.array_equal(idx, order)
        n_in += int(mask.sum())
    if kind == "masked":
        assert n_in == 0
    else:
        assert n_in > 0


def _cfg(capacity: int = 64):
    return TP(grid=TG(x0=-16.0, y0=-16.0, cell=1.0, nx=32, ny=32, overlap=4),
              keyframe=TK(dist_thresh=0.5, angle_thresh=0.3,
                          capacity=capacity),
              solver=TS(inc_iters=2, pcg_max_iter=60, full_solve_every=4,
                        local_poses=12, local_factors=32),
              loop=TL(min_index_gap=5, max_candidates=4,
                      local_half_extent=4.0),
              n_beams=90, use_loop_closure=True, window=8, window_passes=2)


def _clone(x):
    if x is None:
        return None
    if isinstance(x, tuple):
        items = [_clone(y) for y in x]
        return type(x)(*items) if hasattr(x, "_fields") else tuple(items)
    return x.clone()


@pytest.fixture(scope="module")
def windows():
    """Three box-world sessions of different lengths (f64, the windowed
    pipeline): each session's ``_wb_appends`` inputs at its window with the
    most loop factors."""
    cfg = _cfg()
    world = tsynth.box_world(11.0)
    picked = []
    for seed, n in ((0, 33), (1, 41), (2, 49)):
        traj = tsynth.rectangle_trajectory(n, half=1.75, step=0.25)
        seq = tsynth.make_sequence(world, traj, 90, 20.0, 0.1, seed=seed,
                                   odom_trans_std=0.04, odom_rot_std=0.01)
        seen, real = [], tpipe._wb_appends

        def record(*a, **k):
            args = _clone(a[:7])
            out = real(*a, **k)
            seen.append((int(out[2]["nl_out"].sum()), args))
            return out

        tpipe._wb_appends = record
        try:
            tpipe.run_slam_windowed(seq.points.double(), seq.mask,
                                    seq.odom.double(), cfg)
        finally:
            tpipe._wb_appends = real
        picked.append(max(seen, key=lambda e: e[0]))
    assert sum(n for n, _ in picked) > 0
    return cfg, [args for _, args in picked]


def _singles(cfg, sessions):
    return [tpipe._wb_appends(*_clone(args), cfg) for args in sessions]


def _stacked(cfg, sessions):
    sessions = [_clone(args) for args in sessions]
    state8 = slam_dp._stack([args[0] for args in sessions])
    rest = [torch.stack([args[i] for args in sessions]) for i in range(1, 7)]
    return slam_dp._appends_stacked(state8, *rest, cfg), state8


def _same_as_singles(out8, singles):
    graph8, kf8, aux8 = out8
    for i, (graph, kf, aux) in enumerate(singles):
        for name, a, b in zip(graph._fields, graph8, graph):
            assert torch.equal(a[i], b), (i, "graph", name)
        for name, a, b in zip(kf._fields, kf8, kf):
            assert torch.equal(a[i], b), (i, "kf", name)
        assert aux.keys() == aux8.keys()
        for name in aux:
            assert torch.equal(aux8[name][i], aux[name]), (i, name)


def test_stacked_appends_equal_single_sessions(windows):
    """One stacked call (one K8a write into the flat cache, one K15 and one
    gated verify over every session's lanes) gives each session's graph,
    keyframe store (tables included), loop factors and counters of its own
    ``_wb_appends``, bit for bit."""
    cfg, sessions = windows
    singles = _singles(cfg, sessions)
    out8, _ = _stacked(cfg, sessions)
    _same_as_singles(out8, singles)
    loops = [int(aux["n_loops_new"]) for _, _, aux in singles]
    assert sum(1 for n in loops if n > 0) >= 2, loops


def test_stacked_k8a_drops_a_slot_at_capacity(windows):
    """Session 0's keyframe store one slot short of full while its graph
    has room: the window's second keyframe gets store slot ``cap``, which
    the stacked write must drop (as the single session's write does),
    not land in session 1's slot 0."""
    cfg, sessions = windows
    sessions = [_clone(args) for args in sessions]
    st, lkr, poses, hess, pts, msk, is_kf = sessions[0]
    is_kf = torch.zeros_like(is_kf)
    is_kf[[2, 5]] = True
    cap = cfg.keyframe.capacity
    kf = st.kf._replace(n=torch.tensor(cap - 1),
                        live=torch.ones_like(st.kf.live))
    sessions[0] = (st._replace(kf=kf), lkr, poses, hess, pts, msk, is_kf)
    singles = _singles(cfg, sessions)
    aux = singles[0][2]
    assert aux["kslot_ok"][5] and int(aux["kslot"][5]) == cap
    out8, _ = _stacked(cfg, sessions)
    _same_as_singles(out8, singles)


def test_loop_lanes_size_checks_raise_before_the_card():
    """K15's limits raise on CPU-built shapes, before any device check:
    a store past ``LOOP_LANES_MAX_CAP``, more candidates than the gate's
    128 threads or than the store has; the limit and the gate width are
    the source's, and the search's shared memory (two lists of C 8-byte
    keys a warp, a round's entering keys, each list's place and fill) fits
    what a block can opt in to, at any store."""
    slots = int(re.search(r"kMaxSlots = (\d+);", _SRC).group(1))
    lanes = int(re.search(r"kMaxLanes = (\d+);", _SRC).group(1))
    assert slots == kernels.LOOP_LANES_MAX_CAP
    assert lanes == kernels.GATE_MAX_LANES
    smem = 2 * K15_WARPS * lanes * 8 + K15_WARPS * 32 * 8 + K15_WARPS * 8
    assert smem <= kernels.SMEM_MAX

    def call(cap, c):
        z = torch.zeros
        kernels.loop_lanes(z((1, cap, 3)), z((1, cap), dtype=torch.bool),
                           z((1, 2, 4, 2)), z((1, 2, 4), dtype=torch.bool),
                           z((1, 2, 3)), z((1, 1), dtype=torch.long),
                           z((1, 1), dtype=torch.long), 3.0, 5, c)

    with pytest.raises(ValueError, match="16384"):
        call(kernels.LOOP_LANES_MAX_CAP + 1, 4)
    with pytest.raises(ValueError, match="128"):
        call(512, 129)
    with pytest.raises(ValueError, match="from a store of 8"):
        call(8, 9)
    # Within the limits the kernel refuses CPU tensors: no fallback.
    with pytest.raises(ValueError, match="CUDA"):
        call(kernels.LOOP_LANES_MAX_CAP, 128)


def test_cpu_route_reaches_no_kernel(windows, monkeypatch):
    """On CPU tensors the stacked verify, the search and the per-query
    verify run the twins: no kernel wrapper is called."""
    from ndtpu_torch.ndt import match as tmatch

    def refuse(*a, **k):
        raise AssertionError("a kernel was reached on the CPU")

    for name in ("loop_lanes", "lm_ndt", "local_tables", "loop_gate",
                 "window_append", "loop_append"):
        monkeypatch.setattr(kernels, name, refuse)
    kernels.reset_launches()
    cfg, sessions = windows
    out8, _ = _stacked(cfg, sessions[:2])
    st = sessions[0][0]
    q = int(st.kf.n) - 1
    tclosure.find_candidates(st.kf, st.kf.poses[q], q, cfg.loop)
    tclosure.detect_loops_cached(st.kf, st.kf.points[q], st.kf.masks[q],
                                 st.kf.poses[q], q, cfg.loop, cfg.match)
    assert not any(kernels.LAUNCHES.values())
    assert tmatch.CALLS["match_batch_packed"] > 0
    assert out8[2]["n_loops_new"].shape == (2,)
