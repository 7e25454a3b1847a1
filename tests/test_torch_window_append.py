"""K14 ``window_append``'s plain version against the JAX package's
``_wb_appends``, its stacked form, and the window's host syncs.

The JAX side runs jitted (f64 on the CPU); the port's plain versions
(``ndtpu_torch.slam.appends``) are held to it exactly on every index, mask
and counter and to 1e-12 on the values, on seeded states at small
capacities: no keyframe, every scan a keyframe, the pose, keyframe-store
and factor capacities overflowing, and the loop factors overflowing the
factor capacity. A host-sync counter (``Tensor.__bool__``, ``item``,
``tolist``, ``nonzero``, boolean-mask indexing, ...) holds the writes to
none and the window backend to at most three a window at config-2 and
config-3 shapes.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
from collections import defaultdict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndtpu.config import (GridConfig, KeyframeConfig, LoopConfig,
                          PipelineConfig)
from ndtpu.graph import factors as jfct
from ndtpu.ndt import grid as jgrid
from ndtpu.slam import keyframes as jkfs
from ndtpu.slam import pipeline as jpipe
from ndtpu_torch.data import synth as tsynth
from ndtpu_torch.loop import closure as tclosure
from ndtpu_torch.slam import appends
from ndtpu_torch.slam import pipeline as tpipe

torch.set_num_threads(2)

W, N = 8, 24
CAP = 16


def _cfg(loops: bool = False, cap: int = CAP):
    return PipelineConfig(
        grid=GridConfig(x0=-8.0, y0=-8.0, cell=1.0, nx=16, ny=16, overlap=4),
        keyframe=KeyframeConfig(dist_thresh=0.5, angle_thresh=0.3,
                                capacity=cap),
        loop=LoopConfig(min_index_gap=3, max_candidates=4,
                        local_half_extent=2.0, max_detect_per_window=3),
        n_beams=N, use_loop_closure=loops, window=W, window_passes=2)


def _spd(rng, shape):
    a = rng.normal(0.0, 3.0, shape + (3, 3))
    return a @ np.swapaxes(a, -1, -2) + 5.0 * np.eye(3)


#: name: (is_kf pattern, n_poses, n_between, kf.n) at CAP poses and 2 CAP
#: factors.
CASES = {
    "no_keyframe": ([0] * W, 5, 9, 5),
    "every_scan": ([1] * W, 3, 4, 3),
    "pose_overflow": ([1, 0, 1, 1, 1, 0, 1, 1], CAP - 3, 20, CAP - 3),
    "store_overflow": ([0, 1, 1, 0, 1, 1, 1, 0], 6, 11, CAP - 2),
    "factor_overflow": ([1, 1, 0, 1, 1, 1, 0, 1], 7, 2 * CAP - 2, 7),
}


def _state(cfg, case: str, seed: int):
    """A seeded port state (f64, CPU) and window inputs for ``case``."""
    pattern, n0, nb0, kn0 = CASES[case] if case in CASES else (
        [1, 0, 1, 1, 0, 1, 1, 0], 6, 2 * CAP - 3, 6)
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(np.asarray(a))
    pts0 = t(rng.normal(0.0, 3.0, (N, 2)))
    st = tpipe.init_slam(cfg, pts0, t(np.ones(N, bool)))
    v, f, k = CAP, 2 * CAP, CAP
    g = st.graph._replace(
        poses=t(rng.normal(0.0, 2.0, (v, 3))),
        pose_mask=t(np.arange(v) < n0),
        bet_i=t(rng.integers(0, v, f)), bet_j=t(rng.integers(0, v, f)),
        bet_z=t(rng.normal(0.0, 1.0, (f, 3))),
        bet_sqrt_info=t(rng.normal(0.0, 1.0, (f, 3, 3))),
        bet_mask=t(np.arange(f) < nb0),
        n_poses=torch.tensor(n0), n_between=torch.tensor(nb0))
    kf = st.kf._replace(
        poses=t(rng.normal(0.0, 2.0, (k, 3))),
        points=t(rng.normal(0.0, 3.0, (k, N, 2))),
        masks=t(rng.random((k, N)) < 0.8), live=t(np.arange(k) < kn0),
        n=torch.tensor(kn0))
    st = st._replace(graph=g, kf=kf,
                     map_kf_poses=t(rng.normal(0.0, 2.0, (k, 3))),
                     last_kf_idx=torch.tensor(max(n0 - 1, 0)))
    win = dict(last_kf_reg=t(rng.normal(0.0, 1.0, 3)),
               poses=t(rng.normal(0.0, 2.0, (W, 3))),
               hessians=t(_spd(rng, (W,))),
               pts=t(rng.normal(0.0, 3.0, (W, N, 2))),
               msk=t(rng.random((W, N)) < 0.9), is_kf=t(np.array(pattern, bool)))
    return st, win


def _to_jax(tree, cls):
    """A port NamedTuple -> the JAX package's class ``cls`` (f64 leaves,
    int32 indices, by field name)."""
    def leaf(x):
        if x is None:
            return None
        a = x.numpy()
        return jnp.asarray(a.astype(np.int32) if a.dtype.kind in "iu" else a)
    return cls(**{name: leaf(getattr(tree, name)) for name in cls._fields})


def _jax_state(st):
    return jpipe.SlamState(
        stats=_to_jax(st.stats, jgrid.NDTStats),
        kf=_to_jax(st.kf, jkfs.KeyframeStore),
        graph=_to_jax(st.graph, jfct.PoseGraph),
        **{name: jnp.asarray(getattr(st, name).numpy().astype(np.int32)
                             if getattr(st, name).dtype == torch.long
                             else getattr(st, name).numpy())
           for name in ("sm_lam", "sm_last_delta", "sm_step", "pose",
                        "last_kf_idx", "n_loops", "map_kf_poses")})


_JAX_APPENDS = jax.jit(jpipe._wb_appends, static_argnames="cfg")
_JAX_EXTEND = jax.jit(jpipe._wb_extend, static_argnames="cfg")


def _jax_run(st, win, cfg):
    js = _jax_state(st)
    args = [jnp.asarray(win[k].numpy()) for k in
            ("last_kf_reg", "poses", "hessians", "pts", "msk", "is_kf")]
    graph, kf, aux = _JAX_APPENDS(js, *args, cfg=cfg)
    _, mkp = _JAX_EXTEND(js, args[1], args[3], args[4], args[5],
                         aux["kslot"], cfg=cfg)
    return graph, kf, aux, mkp


def _same(name, port, ref, exact):
    port = port.numpy()
    ref = np.asarray(ref)
    assert port.shape == ref.shape, name
    if exact or port.dtype.kind in "biu":
        np.testing.assert_array_equal(port, ref.astype(port.dtype), name)
    else:
        np.testing.assert_allclose(port, ref, rtol=0, atol=1e-12,
                                   err_msg=name)


_GRAPH = ("poses", "pose_mask", "bet_i", "bet_j", "bet_z", "bet_sqrt_info",
          "bet_mask", "n_poses", "n_between")
_KF = ("poses", "points", "masks", "live", "n")
_AUX = ("last_idx", "lkr", "any_kf", "kf_idx_out", "rel_out", "nd_out")


def _check_against_jax(graph, kf, aux, mkp, jgraph, jkf, jaux, jmkp):
    for name in _GRAPH:
        _same(f"graph.{name}", getattr(graph, name), getattr(jgraph, name),
              exact=False)
    for name in _KF:
        _same(f"kf.{name}", getattr(kf, name), getattr(jkf, name),
              exact=name in ("points", "masks"))
    for name in _AUX:
        _same(name, aux[name], jaux[name], exact=False)
    _same("map_kf_poses", mkp, jmkp, exact=True)


@pytest.mark.parametrize("case", sorted(CASES))
def test_window_append_ref_matches_jax(case):
    """The plain version of K14 (through ``append_window`` with S = 1)
    equals JAX's ``_wb_appends`` + ``_wb_extend`` write with loop closure
    off."""
    cfg = _cfg()
    st, win = _state(cfg, case, seed=len(case))
    app = tpipe._first(appends.append_window(
        tpipe._lead(st.graph), tpipe._lead(st.kf), st.map_kf_poses[None],
        st.last_kf_idx[None], *(win[k][None] for k in (
            "last_kf_reg", "poses", "hessians", "pts", "msk", "is_kf"))))
    jgraph, jkf, jaux, jmkp = _jax_run(st, win, cfg)
    aux = dict(app._asdict())
    _check_against_jax(app.graph, app.kf, aux, app.map_kf_poses, jgraph,
                       jkf, jaux, jmkp)
    # kslot where the keyframe was kept (JAX drops the others' rows).
    ok = app.ok.numpy()
    np.testing.assert_array_equal(app.kslot.numpy()[ok],
                                  np.asarray(jaux["kslot"])[ok])
    # The stage itself: pipeline._wb_appends on the same state.
    graph, kf, aux = tpipe._wb_appends(st, win["last_kf_reg"], win["poses"],
                                       win["hessians"], win["pts"],
                                       win["msk"], win["is_kf"], cfg)
    _check_against_jax(graph, kf, aux, aux["map_kf_poses"], jgraph, jkf,
                       jaux, jmkp)
    for name in ("nl_out", "ni_out", "n_loops_new"):
        _same(name, aux[name], jaux[name], exact=True)


def _fake_loops(rng, kq: int, c: int, v: int, as_jax: bool):
    """Seeded verify results: most lanes accepted, some innovation-
    rejected."""
    acc = rng.random((kq, c)) < 0.75
    innov = ~acc & (rng.random((kq, c)) < 0.5)
    vals = dict(j=rng.integers(0, v, (kq, c)), z=rng.normal(0, 1, (kq, c, 3)),
                sqrt_info=rng.normal(0, 1, (kq, c, 3, 3)),
                score=rng.random((kq, c)), accept=acc, innov_rej=innov)
    if as_jax:
        from ndtpu.loop import closure as jclosure
        return jclosure.LoopResult(**{
            k: jnp.asarray(a.astype(np.int32) if k == "j" else a)
            for k, a in vals.items()})
    return tclosure.LoopResult(**{k: torch.as_tensor(a)
                                  for k, a in vals.items()})


def test_loop_overflow_matches_jax(monkeypatch):
    """Loop closure on, the verify replaced in both packages by the same
    seeded results: the accepted loop factors overflow the factor capacity
    (JAX's ``lok``), every array, counter and per-scan count equal."""
    from ndtpu.loop import closure as jclosure

    cfg = _cfg(loops=True)
    st, win = _state(cfg, "loop_overflow", seed=99)
    kq, c = cfg.loop.max_detect_per_window, cfg.loop.max_candidates
    monkeypatch.setattr(jclosure, "detect_loops_cached_flat",
                        lambda *a, **k: _fake_loops(
                            np.random.default_rng(5), kq, c, CAP, True))
    # The port verifies its sessions' queries in one stacked call (one
    # session here): the same results with a leading session axis.
    monkeypatch.setattr(tclosure, "detect_loops_stacked",
                        lambda *a, **k: tclosure.LoopResult(*(
                            x[None] for x in _fake_loops(
                                np.random.default_rng(5), kq, c, CAP,
                                False))))
    appends_jit = jax.jit(jpipe._wb_appends, static_argnames="cfg")
    js = _jax_state(st)
    args = [jnp.asarray(win[k].numpy()) for k in
            ("last_kf_reg", "poses", "hessians", "pts", "msk", "is_kf")]
    jgraph, jkf, jaux = appends_jit(js, *args, cfg=cfg)
    graph, kf, aux = tpipe._wb_appends(st, win["last_kf_reg"], win["poses"],
                                       win["hessians"], win["pts"],
                                       win["msk"], win["is_kf"], cfg)
    assert int(np.asarray(jgraph.n_between)) == 2 * CAP
    assert int(np.asarray(jaux["nd_out"]).sum()) > 0
    _, jmkp = _JAX_EXTEND(js, args[1], args[3], args[4], args[5],
                          jaux["kslot"], cfg=cfg)
    _check_against_jax(graph, kf, aux, aux["map_kf_poses"], jgraph, jkf,
                       jaux, jmkp)
    for name in ("nl_out", "ni_out", "n_loops_new"):
        _same(name, aux[name], jaux[name], exact=True)


def _stacked_inputs(cases, cfg):
    states, wins = zip(*(_state(cfg, case, seed=i)
                         for i, case in enumerate(cases)))
    stack = lambda ts: torch.stack(list(ts))
    graph = type(states[0].graph)(*map(stack, zip(*(s.graph
                                                      for s in states))))
    kf = states[0].kf._replace(**{
        name: stack(getattr(s.kf, name) for s in states) for name in _KF})
    return states, wins, (graph, kf._replace(tables=None),
                          stack(s.map_kf_poses for s in states),
                          stack(s.last_kf_idx for s in states),
                          *(stack(w[k] for w in wins) for k in (
                              "last_kf_reg", "poses", "hessians", "pts",
                              "msk", "is_kf")))


def _bits(a, b):
    return a.shape == b.shape and torch.equal(a, b)


def test_three_stacked_sessions_equal_three_single_calls():
    """S = 3 sessions in one call of each entry point equal three S = 1
    calls, bit for bit."""
    cfg = _cfg()
    cases = ("every_scan", "pose_overflow", "factor_overflow")
    states, wins, stacked = _stacked_inputs(cases, cfg)
    out3 = appends.window_append(*_flat(*stacked))
    for i in range(3):
        one = appends.window_append(*(t[i:i + 1] for t in _flat(*stacked)))
        for a, b in zip(out3, one):
            assert _bits(a[i:i + 1], b)
    rng = np.random.default_rng(3)
    kq, c = 3, 4
    lanes = [_fake_loops(rng, kq, c, CAP, False) for _ in range(3)]
    acc = torch.stack([x.accept for x in lanes])
    loop_args = (out3[2], out3[3], out3[4], out3[5], out3[6], out3[8], acc,
                 torch.stack([x.j for x in lanes]),
                 torch.stack([x.z for x in lanes]),
                 torch.stack([x.sqrt_info for x in lanes]),
                 torch.stack([x.innov_rej for x in lanes]),
                 torch.as_tensor(rng.integers(0, CAP, (3, kq))),
                 torch.as_tensor(rng.integers(0, W, (3, kq))),
                 torch.as_tensor(rng.random((3, kq)) < 0.8))
    loops3 = appends.loop_append(*loop_args, W)
    for i in range(3):
        one = appends.loop_append(*(t[i:i + 1] for t in loop_args), W)
        for a, b in zip(loops3, one):
            assert _bits(a[i:i + 1], b)
    mkp = out3[14]
    sel = torch.as_tensor(np.stack([rng.permutation(CAP)[:5]
                                    for _ in range(3)]))
    do = torch.as_tensor(rng.random((3, 5)) < 0.6)
    src = torch.as_tensor(rng.normal(0, 1, (3, 5, 3)))
    rows3 = appends.set_rows(mkp, sel, do, src)
    for i in range(3):
        one = appends.set_rows(mkp[i:i + 1], sel[i:i + 1], do[i:i + 1],
                               src[i:i + 1])
        assert _bits(rows3[i:i + 1], one)
        ref = mkp[i].clone()
        for m in range(5):
            if do[i, m]:
                ref[sel[i, m]] = src[i, m]
        assert _bits(rows3[i], ref)


def _flat(graph, kf, mkp, last_idx, lkr, poses, hess, pts, msk, is_kf):
    return (graph.poses, graph.pose_mask, graph.bet_i, graph.bet_j,
            graph.bet_z, graph.bet_sqrt_info, graph.bet_mask, graph.n_poses,
            graph.n_between, kf.poses, kf.points, kf.masks, kf.live, kf.n,
            mkp, last_idx, lkr, poses, hess, pts, msk, is_kf)


# --- host syncs ------------------------------------------------------------

#: The plain versions of the kernels a window launches: on the card each is
#: one launch without a host read (the smoke holds them so), so their CPU
#: bodies are not counted. The loop verify's own launch routing is counted
#: apart.
PLAIN_TWINS = (("ndtpu_torch.graph.solve", "pcg_solve_ref"),
               ("ndtpu_torch.graph.incremental", "local_select_ref"),
               ("ndtpu_torch.graph.incremental", "fresh_residual_max_ref"),
               ("ndtpu_torch.graph.factors", "factor_linearize_ref"),
               ("ndtpu_torch.dist.schur", "assemble_local_ref"),
               ("ndtpu_torch.ndt.grid", "halfcell_add_ref"),
               ("ndtpu_torch.ndt.grid", "finalize_pack_ref"),
               ("ndtpu_torch.ndt.match", "lm_ndt_ref"),
               ("ndtpu_torch.loop.closure", "write_local_tables_ref"))
VERIFY = ("ndtpu_torch.loop.closure", "detect_loops_stacked")


class SyncCounter:
    """Counts the calls that read a tensor back to the host, by site."""

    METHODS = ("__bool__", "__int__", "__float__", "__index__", "item",
               "tolist", "nonzero", "cpu", "numpy")

    def __init__(self):
        self.n = 0
        self.paused = 0
        self.sites = defaultdict(int)

    def hit(self, what):
        if not self.paused:
            self.n += 1
            self.sites[what] += 1

    @contextlib.contextmanager
    def patched(self, monkeypatch, skip=PLAIN_TWINS):
        counter = self
        for name in self.METHODS:
            real = getattr(torch.Tensor, name)

            def wrapped(t, *a, _real=real, _name=name, **k):
                counter.hit(_name)
                return _real(t, *a, **k)
            monkeypatch.setattr(torch.Tensor, name, wrapped)
        real_get = torch.Tensor.__getitem__

        def getitem(t, idx):
            items = idx if isinstance(idx, tuple) else (idx,)
            if any(isinstance(x, torch.Tensor) and x.dtype == torch.bool
                   for x in items):
                counter.hit("bool-mask index")
            return real_get(t, idx)
        monkeypatch.setattr(torch.Tensor, "__getitem__", getitem)
        real_nonzero = torch.nonzero

        def nonzero(*a, **k):
            counter.hit("torch.nonzero")
            return real_nonzero(*a, **k)
        monkeypatch.setattr(torch, "nonzero", nonzero)
        for mod_name, name in skip:
            mod = importlib.import_module(mod_name)
            fn = getattr(mod, name)

            def paused(*a, _fn=fn, **k):
                counter.paused += 1
                try:
                    return _fn(*a, **k)
                finally:
                    counter.paused -= 1
            monkeypatch.setattr(mod, name, paused)
        yield self


def test_sync_counter_sees_host_reads(monkeypatch):
    counter = SyncCounter()
    t = torch.arange(4)
    with counter.patched(monkeypatch):
        bool(t[0] > 1), int(t[1]), t.sum().item(), t.tolist(), t[t > 1]
    assert counter.n == 5


def test_writes_make_no_host_sync(monkeypatch):
    """The append, loop-append, extend and refresh writes read nothing back
    to the host (plain versions, on the CPU)."""
    cfg = dataclasses.replace(_cfg(), refresh_top_m=3, refresh_eps=0.0)
    st, win = _state(cfg, "every_scan", seed=4)
    counter = SyncCounter()
    rng = np.random.default_rng(8)
    lanes = _fake_loops(rng, 3, 4, CAP, False)
    with counter.patched(monkeypatch):
        app = tpipe._first(appends.append_window(
            tpipe._lead(st.graph), tpipe._lead(st.kf), st.map_kf_poses[None],
            st.last_kf_idx[None], *(win[k][None] for k in (
                "last_kf_reg", "poses", "hessians", "pts", "msk", "is_kf"))))
        n_append = counter.n
        tpipe._append_loops(tpipe._lead(app.graph), tpipe._lead(
            tpipe.LoopLanes(lanes.accept, lanes.j, lanes.z, lanes.sqrt_info,
                            lanes.innov_rej, app.slot[:3], app.cum[:3] - 1,
                            torch.ones(3, dtype=torch.bool))), W)
        n_loops = counter.n - n_append
        mkp = app.map_kf_poses
        sel = torch.tensor([1, 4, 7])
        do = torch.tensor([True, False, True])
        appends.set_rows(mkp[None], sel[None], do[None],
                         app.kf.poses[sel][None])
        n_rows = counter.n - n_append - n_loops
        tpipe._wb_extend(st, mkp, win["poses"], win["pts"], win["msk"],
                         win["is_kf"], cfg)
        tpipe._refresh_map(st.stats, app.kf, mkp, cfg)
        n_maps = counter.n - n_append - n_loops - n_rows
    assert (n_append, n_loops, n_rows, n_maps) == (0, 0, 0, 0), dict(
        counter.sites)


def _backend_syncs(monkeypatch, cfg, seq):
    """Host syncs in each ``_window_backend`` call of a windowed run,
    outside the kernels' plain versions; and those inside the loop verify.
    Returns ``(per-window counts, verify counts, outs)``."""
    counter = SyncCounter()
    backend = tpipe._window_backend
    verify_mod = importlib.import_module(VERIFY[0])
    verify = getattr(verify_mod, VERIFY[1])
    per_window, in_verify = [], [0]

    def counted_verify(*a, **k):
        n0, p0 = counter.n, counter.paused
        counter.paused = 0
        try:
            return verify(*a, **k)
        finally:
            in_verify[0] += counter.n - n0
            counter.n = n0
            counter.paused = p0

    def counted_backend(*a, **k):
        n0 = counter.n
        out = backend(*a, **k)
        per_window.append(counter.n - n0)
        return out

    with counter.patched(monkeypatch):
        monkeypatch.setattr(verify_mod, VERIFY[1], counted_verify)
        monkeypatch.setattr(tpipe, "_window_backend", counted_backend)
        _, outs = tpipe.run_slam_windowed(seq.points, seq.mask, seq.odom,
                                          cfg)
    return per_window, in_verify[0], outs, dict(counter.sites)


@pytest.fixture(scope="module")
def box_seq():
    world = tsynth.box_world(11.0)
    traj = tsynth.rectangle_trajectory(57, half=1.75, step=0.25)
    s = tsynth.make_sequence(world, traj, 90, 20.0, 0.1, seed=0,
                             odom_trans_std=0.04, odom_rot_std=0.01)
    return s._replace(points=s.points.double(), odom=s.odom.double())


def _pipeline_cfg(loops: bool):
    from ndtpu_torch.config import (GridConfig as TG, KeyframeConfig as TK,
                                    LoopConfig as TL,
                                    PipelineConfig as TP,
                                    SolverConfig as TS)
    return TP(grid=TG(x0=-16.0, y0=-16.0, cell=1.0, nx=32, ny=32,
                      overlap=4),
              keyframe=TK(dist_thresh=0.5, angle_thresh=0.3, capacity=64),
              solver=TS(inc_iters=2, pcg_max_iter=60, full_solve_every=4,
                        local_poses=12, local_factors=32),
              loop=TL(min_index_gap=5, max_candidates=4,
                      local_half_extent=4.0),
              n_beams=90, use_loop_closure=loops, window=8, window_passes=2)


@pytest.mark.parametrize("loops", [False, True], ids=["config2", "config3"])
def test_window_backend_syncs_at_most_three(monkeypatch, box_seq, loops):
    """At config-2 and config-3 shapes (the full solve every 4th update,
    the local path on) every window's backend reads at most three times:
    the branch decisions once, then where they run the slow settled check,
    the local probe and the full solve's early exit."""
    cfg = _pipeline_cfg(loops)
    per_window, in_verify, outs, sites = _backend_syncs(monkeypatch, cfg,
                                                        box_seq)
    assert len(per_window) == 7
    assert min(per_window) >= 1 and max(per_window) <= 3, (per_window,
                                                           sites)
    takes = set(outs.local_take.tolist())
    assert 2 in takes, takes
    if loops:
        assert int(outs.n_loops_new.sum()) > 0


def test_cpu_tensors_take_the_plain_version_and_the_kernel_refuses_them(
        monkeypatch):
    """CPU tensors go to the plain versions (the kernel entry points are
    never called), and the kernel wrappers refuse CPU tensors rather than
    fall back."""
    from ndtpu_torch import kernels

    cfg = _cfg()
    st, win = _state(cfg, "every_scan", seed=2)
    args = _flat(tpipe._lead(st.graph), tpipe._lead(st.kf),
                 st.map_kf_poses[None], st.last_kf_idx[None],
                 *(win[k][None] for k in ("last_kf_reg", "poses", "hessians",
                                          "pts", "msk", "is_kf")))
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.window_append(*args)
    for name in ("window_append", "loop_append", "rows_set"):
        monkeypatch.setattr(kernels, name, None)
    out = appends.window_append(*args)
    assert all(_bits(a, b) for a, b in
               zip(out, appends.window_append_ref(*args)))
    sel = torch.tensor([[1, 2]])
    assert _bits(appends.set_rows(out[14], sel, torch.tensor([[True, False]]),
                                  out[9][:, :2]),
                 appends.set_rows_ref(out[14], sel,
                                      torch.tensor([[True, False]]),
                                      out[9][:, :2]))
