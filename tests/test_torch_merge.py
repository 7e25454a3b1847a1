"""Config 5's merge (``ndtpu_torch.slam.merge``) and the unpacked-map NDT
terms it ranks hypotheses with (``ndt.grid.lookup``, ``ndt.match.
point_terms`` / ``score_grad_hess`` / ``score_grad_hess_batch_ref``, K12's
plain version) against the JAX package, in f64 on the CPU.

The sessions are those of ``tests/test_multisession_e2e.py:154`` (24 x 24
grid at 1 m, 180 beams, capacity 48, no loop closure; A a 49-scan lap of a
9 m box world, B 33 scans of a smaller lap from [1.5, 2, 0.7]) made by the
port's synth (numpy noise, so both packages get the same inputs) and run
through the JAX package's ``run_slam_windowed`` in f64. Both packages then
merge the same states; the JAX chain is computed once per test session
(shared by the xdist workers through a file lock).

``python tests/test_torch_merge.py`` regenerates
``tests/data/torch_config5_merge_ref.json``: the JAX package's config-5
merge (``configs/config5_multisession.json`` as it is) on the pair
``chip_smoke.config5_sessions`` makes, in f32 and f64, which
``chip_smoke.py`` phases 12-13 gate the card's run against.
"""

import json
import pickle
import sys
import tempfile
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from filelock import FileLock

from ndtpu.config import PipelineConfig, SolverConfig
from ndtpu.graph import factors as jfct
from ndtpu.graph import solve as jslv
from ndtpu.lie import se2 as jse2
from ndtpu.loop import closure as jclosure
from ndtpu.ndt import grid as jgrid
from ndtpu.ndt import match as jmatch
from ndtpu.slam import merge as jmerge
from ndtpu.slam import pipeline as jpipe
from ndtpu_torch import config as tconfig
from ndtpu_torch import convert
from ndtpu_torch.data import synth as tsynth
from ndtpu_torch.graph import solve as tslv
from ndtpu_torch.ndt import grid as tgrid
from ndtpu_torch.ndt import match as tmatch
from ndtpu_torch.slam import merge as tmerge

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
REF5 = ROOT / "tests" / "data" / "torch_config5_merge_ref.json"
REF5_OVERLAP1 = ROOT / "tests" / "data" / "torch_config5_overlap1_ref.json"

#: f64 tolerance of the NDT terms against the JAX package's: the same sums
#: in another order.
RTOL = 1e-10
#: The perturbation of the merge transform (bench.py:622-623).
PERTURB = [0.25, -0.2, 0.06]


def _cfg(c=None):
    """``test_multisession_e2e``'s config, of the JAX package's config
    classes or (``c=tconfig``) the port's."""
    c = c or sys.modules["ndtpu.config"]
    return c.PipelineConfig(
        grid=c.GridConfig(x0=-12.0, y0=-12.0, cell=1.0, nx=24, ny=24,
                          overlap=4),
        keyframe=c.KeyframeConfig(dist_thresh=0.7, angle_thresh=0.35,
                                  capacity=48),
        loop=c.LoopConfig(radius=3.0, min_index_gap=8, max_candidates=4,
                          local_half_extent=8.0),
        solver=c.SolverConfig(inc_iters=1, pcg_max_iter=40),
        use_loop_closure=False)


def _sequences():
    world = tsynth.box_world(half=9.0)
    traj_a = tsynth.rectangle_trajectory(49, half=6.0, step=0.3,
                                         dtype=torch.float64)
    b0 = torch.tensor([1.5, 2.0, 0.7], dtype=torch.float64)
    from ndtpu_torch.lie import se2 as tse2
    traj_b = tse2.compose(b0.expand(33, 3), tsynth.rectangle_trajectory(
        33, half=4.0, step=0.25, dtype=torch.float64))
    seqs = [tsynth.make_sequence(world, traj, 180, 16.0, 0.1, seed=seed)
            for traj, seed in ((traj_a, 5), (traj_b, 6))]
    return seqs, tse2.between(traj_a[0], traj_b[0])


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_chain():
    """The JAX package's config-5 story at the small size, f64: sessions,
    alignment, both loop searches, both merges, the merged map, and the
    merged graphs solved (PCG, 15 iterations, as the e2e test). numpy
    leaves only."""
    cfg = _cfg()
    seqs, t_true = _sequences()
    j = lambda t: jnp.asarray(t.numpy())
    states = [jpipe.run_slam_windowed(j(s.points), j(s.mask), j(s.odom),
                                      cfg)[0] for s in seqs]
    sa, sb = states
    res = jmerge.global_align(jgrid.finalize(sa.stats, cfg.ndt), cfg.grid,
                              sb.kf.points[0], sb.kf.masks[0])
    t_bad = jse2.compose(res.transform, jnp.asarray(PERTURB, jnp.float64))
    loops = jmerge.find_inter_session_loops(sa.kf, sb.kf, t_bad, cfg.loop,
                                            cfg.match, ndt_cfg=cfg.ndt)
    tables = jax.vmap(lambda p, m: jclosure.build_local_table(
        p, m, cfg.loop, cfg.ndt, False))(sa.kf.points, sa.kf.masks)
    loops_tab = jmerge.find_inter_session_loops(
        sa.kf._replace(tables=tables), sb.kf, t_bad, cfg.loop, cfg.match,
        ndt_cfg=cfg.ndt)
    sq = np.diag([10.0, 10.0, 20.0])
    anchor = (np.asarray([0]), np.asarray([0]), t_bad[None, :], sq[None])
    g_anchor = jmerge.merge_graphs(sa.graph, sb.graph, t_bad, anchor)
    g_auto = jmerge.merge_graphs(sa.graph, sb.graph, t_bad, loops)
    solved = [jslv.optimize(g, SolverConfig(max_iter=15), method="pcg")
              for g in (g_anchor, g_auto)]
    return _np(dict(
        sa=sa, sb=sb, t_true=t_true.numpy(), align=res, t_bad=t_bad,
        top64=jax.lax.top_k(res.grid_scores, 64)[1], loops=loops,
        tables=tables, loops_tab=loops_tab, g_anchor=g_anchor, g_auto=g_auto,
        stats=jmerge.merged_map_stats(sa.kf, sb.kf, t_bad, cfg.grid),
        solved=[s.graph.poses for s in solved],
        chi2=[float(s.chi2) for s in solved]))


@pytest.fixture(scope="session")
def chain(tmp_path_factory, worker_id):
    if worker_id == "master":
        return _jax_chain()
    path = tmp_path_factory.getbasetemp().parent / "torch_merge_chain.pkl"
    with FileLock(str(path) + ".lock"):
        if not path.is_file():
            path.write_bytes(pickle.dumps(_jax_chain()))
        return pickle.loads(path.read_bytes())


def _port(x):
    return convert.from_numpy(x)


def _close(a, b, what, rtol=RTOL, atol=1e-12):
    a = a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), rtol=rtol, atol=atol,
                               err_msg=what)


def _grid1(c=None):
    """``_cfg``'s grid at overlap 1."""
    import dataclasses

    return dataclasses.replace(_cfg(c).grid, overlap=1)


def _map_a(chain, overlap: int = 4):
    """The JAX package's map of session A: its statistics as the session
    left them (overlap 4), or at overlap 1 rebuilt from its live keyframe
    points at their poses (``build_stats`` on the overlap-1 grid)."""
    sa = chain["sa"]
    if overlap == 4:
        stats = jgrid.NDTStats(*sa.stats)
    else:
        kf = sa.kf
        pts = jse2.transform(jnp.asarray(kf.poses),
                             jnp.asarray(kf.points))
        msk = jnp.asarray(kf.masks) & jnp.asarray(kf.live)[:, None]
        stats = jgrid.build_stats(pts.reshape(-1, 2), msk.reshape(-1),
                                  _grid1())
    return jgrid.finalize(stats, _cfg().ndt)


def _probe(chain, n_poses=300, seed=0, overlap: int = 4):
    """Poses on and off session A's map (some wholly off), probe B's first
    keyframe scan, and the JAX package's map of session A (at the
    overlap) in both packages (the same arrays)."""
    rng = np.random.default_rng(seed)
    poses = np.stack([rng.uniform(-14, 14, n_poses),
                      rng.uniform(-14, 14, n_poses),
                      rng.uniform(-np.pi, np.pi, n_poses)], -1)
    jmap = _map_a(chain, overlap)
    tmap = _port(_np(jmap))
    return poses, chain["sb"].kf.points[0], chain["sb"].kf.masks[0], jmap, \
        tmap


def test_lookup_and_point_terms_match_jax(chain):
    """``lookup`` gathers the same cells (exactly), and ``point_terms`` /
    ``score_grad_hess`` give the reference's terms at single poses (rtol
    1e-10)."""
    cfg, tcfg = _cfg(), _cfg(tconfig)
    poses, pts, msk, jmap, tmap = _probe(chain, 12)
    for pose in poses:
        xw, dxdphi = jmatch.transform_terms(jnp.asarray(pose), pts)
        txw, tdx = tmatch.transform_terms(torch.as_tensor(pose),
                                          torch.as_tensor(pts.copy()))
        _close(txw, xw, "xw", rtol=0, atol=1e-15)
        jl = jgrid.lookup(jmap, xw, cfg.grid)
        tl = tgrid.lookup(tmap, torch.as_tensor(np.asarray(xw)), tcfg.grid)
        for a, b, name in zip(tl, jl, ("mean", "icov", "w")):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), name)
        w0 = jl[2] * msk[None, :]
        jt = jmatch.point_terms(jnp.asarray(pose), xw, dxdphi, *jl[:2], w0,
                                cfg.match)
        tt = tmatch.point_terms(torch.as_tensor(pose), txw, tdx, *tl[:2],
                                torch.as_tensor(np.asarray(w0)), tcfg.match)
        for a, b, name in zip(tt, jt, ("f", "g", "h", "wsum", "w0sum")):
            _close(a, b, name)
        js = jmatch.score_grad_hess(jnp.asarray(pose), pts, msk, jmap,
                                    cfg.grid, cfg.match)
        ts = tmatch.score_grad_hess(torch.as_tensor(pose),
                                    torch.as_tensor(pts),
                                    torch.as_tensor(msk), tmap, tcfg.grid,
                                    tcfg.match)
        for a, b, name in zip(ts, js, ("f", "g", "h", "score")):
            _close(a, b, name)


@pytest.mark.parametrize("overlap", [4, 1])
def test_score_grad_hess_batch_matches_jax_vmap(chain, overlap):
    """K12's plain version (and its CPU dispatch) against ``jax.vmap``
    of ``score_grad_hess`` over 600 poses, on and off the map, one shared
    scan (two chunks of the plain version), on maps of 4 and 1 grids."""
    cfg, tcfg = _cfg(), _cfg(tconfig)
    grid, tgrid_ = ((cfg.grid, tcfg.grid) if overlap == 4
                    else (_grid1(), _grid1(tconfig)))
    poses, pts, msk, jmap, tmap = _probe(chain, 600, seed=1, overlap=overlap)
    assert tmap.valid.shape[0] == overlap
    ref = jax.jit(jax.vmap(lambda p: jmatch.score_grad_hess(
        p, pts, msk, jmap, grid, cfg.match)))(jnp.asarray(poses))
    args = (torch.as_tensor(poses), torch.as_tensor(pts),
            torch.as_tensor(msk), tmap, tgrid_, tcfg.match)
    for out in (tmatch.score_grad_hess_batch_ref(*args),
                tmatch.score_grad_hess_batch(*args)):
        for a, b, name in zip(out, ref, ("f", "g", "h", "score")):
            assert a.shape == np.asarray(b).shape, name
            _close(a, b, name)
    assert float(ref[3].min()) == 0.0 < float(ref[3].max())   # off and on


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_hypothesis_grid_matches_jax(dtype):
    """The hypotheses: f32 (every card path's dtype) exactly, at the
    published grid (span 8, step 1, 16 headings) and three others; in f64
    the translations exactly and the headings within 1e-15 (2 ulp at pi):
    XLA's CPU backend contracts ``jnp.linspace``'s ``start (1 - t) + stop t``
    into fused multiply-adds lane by lane, which no plain formula
    reproduces to the last bit, and an f32 cast hides it."""
    for span, step, n_theta in ((8.0, 1.0, 16), (2.5, 0.7, 7),
                                (4.0, 0.5, 8), (6.0, 1.5, 32)):
        ref = np.asarray(jmerge._hypothesis_grid(span, step, n_theta,
                                                 jnp.dtype(dtype)))
        out = tmerge._hypothesis_grid(span, step, n_theta,
                                      getattr(torch, dtype)).numpy()
        assert out.dtype == ref.dtype and out.shape == ref.shape
        if dtype == "float32":
            np.testing.assert_array_equal(out, ref)
        else:
            np.testing.assert_array_equal(out[:, :2], ref[:, :2])
            np.testing.assert_allclose(out[:, 2], ref[:, 2], rtol=0,
                                       atol=1e-15)


def test_global_align_matches_jax(chain):
    """Every hypothesis's coarse total mass (rtol 1e-7: five LM iterations
    on 4,624 lanes from headings that differ by an ulp, where a few
    ill-conditioned lanes amplify last-bit differences), the same top-64
    ranking, and the same refined transform (1e-8). The map is the JAX
    package's, in both."""
    cfg = _cfg(tconfig)
    tmap = _probe(chain, 1)[4]
    sb = chain["sb"]
    res = tmerge.global_align(tmap, cfg.grid,
                              torch.as_tensor(sb.kf.points[0].copy()),
                              torch.as_tensor(sb.kf.masks[0].copy()))
    ref = chain["align"]
    _close(res.grid_scores, ref.grid_scores, "grid_scores", rtol=1e-7,
           atol=1e-9)
    np.testing.assert_array_equal(
        tmerge._descending(res.grid_scores, 64).numpy(), chain["top64"])
    _close(res.transform, ref.transform, "transform", rtol=0, atol=1e-8)
    _close(res.score, ref.score, "score", rtol=1e-8)
    assert bool(res.converged) == bool(ref.converged)
    err = np.abs(np.asarray(jse2.between(ref.transform, chain["t_true"])))
    assert err[0] < 0.3 and err[1] < 0.3 and err[2] < 0.15, err


def test_global_align_overlap1_matches_jax(chain):
    """``global_align`` on session A's overlap-1 map (the merge of config 5
    at ``grid.overlap = 1``) against the JAX package's, jitted, with the
    tolerances of the overlap-4 test above: coarse masses rtol 1e-7, the
    same top-64 ranking, the refined transform within 1e-8."""
    tcfg = _cfg(tconfig)
    jmap = _map_a(chain, 1)
    tmap = _port(_np(jmap))
    sb = chain["sb"]
    pts, msk = sb.kf.points[0], sb.kf.masks[0]
    ref = jax.jit(lambda m, p, k: jmerge.global_align(m, _grid1(), p, k))(
        jmap, jnp.asarray(pts), jnp.asarray(msk))
    res = tmerge.global_align(tmap, _grid1(tconfig),
                              torch.as_tensor(pts.copy()),
                              torch.as_tensor(msk.copy()))
    assert tmap.valid.shape[0] == 1 and tcfg.grid.overlap == 4
    _close(res.grid_scores, ref.grid_scores, "grid_scores", rtol=1e-7,
           atol=1e-9)
    np.testing.assert_array_equal(
        tmerge._descending(res.grid_scores, 64).numpy(),
        np.asarray(jax.lax.top_k(ref.grid_scores, 64)[1]))
    _close(res.transform, ref.transform, "transform", rtol=0, atol=1e-8)
    _close(res.score, ref.score, "score", rtol=1e-8)
    assert bool(res.converged) == bool(ref.converged)
    err = np.abs(np.asarray(jse2.between(ref.transform, chain["t_true"])))
    assert err[0] < 0.3 and err[1] < 0.3 and err[2] < 0.15, err


def test_convert_carries_the_merge_states(chain):
    """``convert`` carries ``AlignResult``, ``NDTMap`` and a
    ``KeyframeStore`` without tables across, both ways."""
    jmap = _np(jgrid.finalize(jgrid.NDTStats(*chain["sa"].stats),
                              _cfg().ndt))
    for tree in (chain["align"], jmap, chain["sa"].kf):
        port = _port(tree)
        assert type(port).__module__.startswith("ndtpu_torch")
        back = convert.to_numpy(port)
        assert type(back).__name__ == type(tree).__name__
        for a, b in zip(back, tree):
            if b is None:
                assert a is None
            else:
                np.testing.assert_array_equal(a, np.asarray(b))
    assert _port(chain["sa"].kf).tables is None


def _same_loops(out, ref):
    assert out[0].shape[0] == np.asarray(ref[0]).shape[0] > 0
    for a, b, name in zip(out, ref, ("i_a", "j_b", "z", "sqrt_info")):
        if name in ("i_a", "j_b"):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), name)
        else:
            _close(a, b, name, rtol=1e-8, atol=1e-8)


@pytest.mark.parametrize("tables", ["none", "given"])
def test_find_inter_session_loops_matches_jax(chain, tables):
    """The accepted pairs, their measurements and sqrt information; A's
    local tables built on the way (``tables=None``, K8a's plain version)
    or given."""
    cfg = _cfg(tconfig)
    kf_a = _port(chain["sa"].kf)
    if tables == "given":
        kf_a = kf_a._replace(tables=torch.as_tensor(chain["tables"]))
        ref = chain["loops_tab"]
    else:
        assert kf_a.tables is None
        ref = chain["loops"]
    out = tmerge.find_inter_session_loops(kf_a, _port(chain["sb"].kf),
                                          torch.as_tensor(chain["t_bad"]),
                                          cfg.loop, cfg.match,
                                          ndt_cfg=cfg.ndt)
    _same_loops(out, ref)


def _same_graph(g, ref):
    for name in jfct.PoseGraph._fields:
        a, b = getattr(g, name).numpy(), np.asarray(getattr(ref, name))
        if a.dtype.kind == "f":
            _close(a, b, name, rtol=0, atol=1e-12)
        else:
            np.testing.assert_array_equal(a, b, name)


@pytest.mark.parametrize("inter", ["none", "anchor", "auto"])
def test_merge_graphs_matches_jax(chain, inter):
    sa, sb = chain["sa"], chain["sb"]
    t_bad = chain["t_bad"]
    if inter == "none":
        ref = _np(jmerge.merge_graphs(jfct.PoseGraph(*sa.graph),
                                      jfct.PoseGraph(*sb.graph), t_bad))
        factors = None
    elif inter == "anchor":
        ref = chain["g_anchor"]
        factors = (np.asarray([0]), np.asarray([0]), t_bad[None, :],
                   np.diag([10.0, 10.0, 20.0])[None])
    else:
        ref = chain["g_auto"]
        factors = tuple(torch.as_tensor(np.asarray(x))
                        for x in chain["loops"])
    g = tmerge.merge_graphs(_port(sa.graph), _port(sb.graph),
                            torch.as_tensor(t_bad), factors)
    _same_graph(g, ref)


def test_merged_map_stats_matches_jax(chain):
    stats = tmerge.merged_map_stats(_port(chain["sa"].kf),
                                    _port(chain["sb"].kf),
                                    torch.as_tensor(chain["t_bad"]),
                                    _cfg(tconfig).grid)
    for a, b, name in zip(stats, chain["stats"], ("n", "s", "ss")):
        _close(a, b, name, rtol=1e-10, atol=1e-9)


def _b_placement_err(graph_poses, sa, sb, t_true):
    na = sa.graph.poses.shape[0]
    idx = np.flatnonzero(np.asarray(sb.kf.live))
    true_b = np.asarray(jse2.compose(jnp.broadcast_to(t_true, (idx.size, 3)),
                                     sb.graph.poses[idx]))
    d = np.asarray(graph_poses)[na + idx, :2] - true_b[:, :2]
    return float(np.hypot(d[:, 0], d[:, 1]).mean())


def test_merge_end_to_end_matches_jax(chain):
    """The JAX package's session states, converted, through the port's
    whole merge (align, perturb, loops, both merges, the merged map, both
    graphs solved by PCG): the same transform, factors, graphs, map,
    chi^2 and session-B placement errors (rtol 1e-6 after 15 LM
    iterations)."""
    cfg = _cfg(tconfig)
    sa, sb = _port(chain["sa"]), _port(chain["sb"])
    res = tmerge.global_align(tgrid.finalize(sa.stats, cfg.ndt), cfg.grid,
                              sb.kf.points[0], sb.kf.masks[0])
    _close(res.transform, chain["align"].transform, "transform", rtol=0,
           atol=1e-8)
    from ndtpu_torch.lie import se2 as tse2
    t_bad = tse2.compose(res.transform,
                         torch.tensor(PERTURB, dtype=torch.float64))
    loops = tmerge.find_inter_session_loops(sa.kf, sb.kf, t_bad, cfg.loop,
                                            cfg.match, ndt_cfg=cfg.ndt)
    _same_loops(loops, chain["loops"])
    anchor = (torch.tensor([0]), torch.tensor([0]), t_bad[None],
              torch.diag(torch.tensor([10.0, 10.0, 20.0],
                                      dtype=torch.float64))[None])
    graphs = [tmerge.merge_graphs(sa.graph, sb.graph, t_bad, anchor),
              tmerge.merge_graphs(sa.graph, sb.graph, t_bad, loops)]
    stats = tmerge.merged_map_stats(sa.kf, sb.kf, t_bad, cfg.grid)
    for a, b in zip(stats, chain["stats"]):
        _close(a, b, "stats", rtol=1e-9, atol=1e-8)
    errs = []
    for g, ref, ref_poses, ref_chi in zip(graphs, ("g_anchor", "g_auto"),
                                          chain["solved"], chain["chi2"]):
        _same_graph(g, chain[ref])
        out = tslv.optimize(g, tconfig.SolverConfig(max_iter=15),
                            method="pcg")
        _close(out.chi2, ref_chi, "chi2", rtol=1e-6, atol=1e-10)
        err = _b_placement_err(out.graph.poses.numpy(), chain["sa"],
                               chain["sb"], chain["t_true"])
        ref_err = _b_placement_err(ref_poses, chain["sa"], chain["sb"],
                                   chain["t_true"])
        assert err == pytest.approx(ref_err, rel=1e-6, abs=1e-9)
        errs.append(err)
    assert errs[1] < errs[0], errs      # the auto factors pull B back


# --------------------------------------------------------------------------
# The config-5 reference file (``python tests/test_torch_merge.py``).


def regenerate_config5_reference(path=REF5, changes=None):
    """The JAX package (CPU) on ``chip_smoke.config5_sessions``'s pair at
    ``configs/config5_multisession.json`` (with only the fields of
    ``changes`` set, as ``chip_smoke.layout_json`` sets them), in f32 and
    f64: the alignment,
    its coarse top-64, the inter-session loops (with each accepted
    factor's translation error against the sessions' poses placed by the
    true transform), the perturbed merges solved as the e2e test solves
    them (PCG, 15 iterations) with session B's placement error, and the
    chi^2 before and after ``optimize_schur`` (one shard, 10 iterations,
    as the launch worker) of the graph the distributed solve takes: the
    sessions merged at the aligned transform with the inter-session
    factors found there."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from ndtpu.dist import mesh as jmesh
    from ndtpu.dist import schur as jschur

    doc5 = chip_smoke.layout_json(chip_smoke.CONFIG5, changes or {})
    with tempfile.TemporaryDirectory() as tmp:
        cfg_path = Path(tmp) / "config5.json"
        cfg_path.write_text(json.dumps(doc5))
        cfg5 = PipelineConfig.from_json(str(cfg_path))
    seqs, t_true, scenario = chip_smoke.config5_sessions("cpu")
    doc = dict(scenario=scenario, config="configs/config5_multisession.json",
               **({"changes": changes} if changes else {}),
               t_true=[float(x) for x in t_true],
               reference="ndtpu.slam.merge on ndtpu.slam.pipeline."
                         "run_slam_windowed sessions, on the CPU; regenerate "
                         "with python tests/test_torch_merge.py"
                         + (" overlap1" if changes else ""),
               perturb=PERTURB)
    for name, x64 in (("f32", False), ("f64", True)):
        jax.config.update("jax_enable_x64", x64)
        dt = jnp.float64 if x64 else jnp.float32
        t0 = time.perf_counter()
        run = jax.jit(lambda p, m, o: jpipe.run_slam_windowed(p, m, o, cfg5))
        sa, sb = (run(jnp.asarray(s.points.numpy(), dt),
                      jnp.asarray(s.mask.numpy()),
                      jnp.asarray(s.odom.numpy(), dt))[0] for s in seqs)
        res = jmerge.global_align(jgrid.finalize(sa.stats, cfg5.ndt),
                                  cfg5.grid, sb.kf.points[0],
                                  sb.kf.masks[0])
        t_bad = jse2.compose(res.transform, jnp.asarray(PERTURB, dt))
        loops = jmerge.find_inter_session_loops(
            sa.kf, sb.kf, t_bad, cfg5.loop, cfg5.match, ndt_cfg=cfg5.ndt)
        sq = jnp.asarray(np.diag([10.0, 10.0, 20.0]), dt)
        anchor = (np.asarray([0]), np.asarray([0]), t_bad[None, :],
                  sq[None])
        g_anchor = jmerge.merge_graphs(sa.graph, sb.graph, t_bad, anchor)
        g_auto = jmerge.merge_graphs(sa.graph, sb.graph, t_bad, loops)
        errs = [_b_placement_err(jslv.optimize(
            g, SolverConfig(max_iter=15), method="pcg").graph.poses, sa, sb,
            jnp.asarray(t_true, dt)) for g in (g_anchor, g_auto)]
        i_a, j_b, z = (np.asarray(x) for x in loops[:3])
        t64 = jnp.asarray(t_true, dt)
        zt = jse2.between(sa.kf.poses[i_a], jse2.compose(
            jnp.broadcast_to(t64, (j_b.size, 3)), sb.kf.poses[j_b]))
        loop_err = np.hypot(*(np.asarray(zt)[:, :2] - z[:, :2]).T)
        loops_al = jmerge.find_inter_session_loops(
            sa.kf, sb.kf, res.transform, cfg5.loop, cfg5.match,
            ndt_cfg=cfg5.ndt)
        g_dist = jmerge.merge_graphs(sa.graph, sb.graph, res.transform,
                                     loops_al)
        plan = jschur.plan_partition(
            np.asarray(g_dist.bet_i), np.asarray(g_dist.bet_j),
            np.asarray(g_dist.bet_mask), np.asarray(g_dist.prior_idx),
            np.asarray(g_dist.prior_mask), g_dist.poses.shape[0], 1)
        sol = jschur.optimize_schur(jmesh.space_mesh(1), g_dist, plan,
                                    SolverConfig(max_iter=10))
        stats = jmerge.merged_map_stats(sa.kf, sb.kf, t_bad, cfg5.grid)
        doc[name] = dict(
            transform=[float(x) for x in res.transform],
            transform_err=[float(x) for x in
                           jse2.between(res.transform,
                                        jnp.asarray(t_true, dt))],
            converged=bool(res.converged),
            coarse_top64=[int(i) for i in
                          jax.lax.top_k(res.grid_scores, 64)[1]],
            keyframes=[int(sa.kf.n), int(sb.kf.n)],
            in_session_loops=[int(sa.n_loops), int(sb.n_loops)],
            inter_loops=int(loops[0].size),
            inter_loop_err_m=dict(
                median=float(np.median(loop_err)),
                p90=float(np.percentile(loop_err, 90)),
                over_0_3=int((loop_err > 0.3).sum())),
            b_placement_err_anchor_m=errs[0],
            b_placement_err_auto_m=errs[1],
            merged_stats_n=float(jnp.sum(stats.n)),
            aligned_inter_loops=int(loops_al[0].size),
            schur_chi2_before=float(jfct.chi2(g_dist)),
            schur_chi2_after=float(jfct.chi2(sol.graph)),
            schur_iters=int(sol.n_iter),
            seconds=time.perf_counter() - t0)
        print(name, json.dumps(doc[name]), flush=True)
    path.write_text(json.dumps(doc, indent=1) + "\n")


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    if sys.argv[1:] in ([], ["merge"]):
        regenerate_config5_reference()
    if sys.argv[1:] in ([], ["overlap1"]):
        sys.path.insert(0, str(ROOT))
        import chip_smoke
        regenerate_config5_reference(REF5_OVERLAP1,
                                     chip_smoke.CONFIG5_OVERLAP1)
