"""The port's distributed Schur solve (``ndtpu_torch.dist.schur``, ``mesh``,
``launch``) against the JAX package's ``ndtpu.dist``, in f64 on the CPU.

The per-rank step is held against ``ndtpu.dist.schur._schur_delta_local``
run over the shard axis by ``jax.vmap(..., axis_name="space")`` in one
process, with the port's shards summed in-process where its ranks would
all-reduce. The whole solve runs once more as two real processes over gloo
(``python -m ndtpu_torch.dist.launch``), on the merged graph of
``tests/test_multisession_e2e.py:154``'s sequences, with JAX and the JAX
package made unimportable in the workers.
"""

import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from filelock import FileLock

from ndtpu.config import SolverConfig as JSolverConfig
from ndtpu.data import g2o as jg2o
from ndtpu.dist import launch as jlaunch
from ndtpu.dist import mesh as jmesh
from ndtpu.dist import schur as jschur
from ndtpu.graph import factors as jfct
from ndtpu.graph import solve as jslv
from ndtpu_torch import convert
from ndtpu_torch.config import SolverConfig
from ndtpu_torch.dist import launch as tlaunch
from ndtpu_torch.dist import mesh as tmesh
from ndtpu_torch.dist import schur as tschur
from ndtpu_torch.graph import factors as tfct

torch.set_num_threads(2)

#: f64 tolerance of the port's step against the JAX package's: the same
#: elimination, summed in another order (Cholesky, products, segment sums).
RTOL = 1e-10


def _manhattan(n=120, seed=0):
    """The launch worker's default problem (120-pose Manhattan world, loop
    probability 0.2, poses jittered by N(0, 0.05)), in f64 in both
    packages."""
    data = jg2o.manhattan_world(n, seed=seed, loop_prob=0.2)
    g = jg2o.to_graph(data, dtype=jnp.float64)
    rng = np.random.default_rng(0)
    g = g._replace(poses=g.poses + rng.normal(0, 0.05, g.poses.shape))
    gn = jax.tree_util.tree_map(np.asarray, g)
    return g, convert.from_numpy(gn)


def _plans(g, tg, shards):
    args = lambda x: (np.asarray(x.bet_i), np.asarray(x.bet_j),
                      np.asarray(x.bet_mask), np.asarray(x.prior_idx),
                      np.asarray(x.prior_mask), int(x.poses.shape[0]), shards)
    return (jschur.plan_partition(*args(g)),
            tschur.plan_partition(*(a.cpu().numpy() if torch.is_tensor(a)
                                    else a for a in args(tg))))


def _jax_shard_deltas(g, plan, lam):
    """The reference's per-shard step under ``vmap(axis_name="space")``:
    every shard's delta ``[S, V, 3]``."""
    sd = jschur.shard_factor_data(g, plan)
    v = g.poses.shape[0]

    def step(bi, bj, z, sqi, fmask, pidx, pz, psqi, pmask, i_role, i_loc,
             j_role, j_loc, p_role, p_loc, int_global, int_mask):
        lin = jschur._linearize_shard(g.poses, bi, bj, z, sqi, fmask, pidx,
                                      pz, psqi, pmask, 0.0)
        return jschur._schur_delta_local(
            plan, jnp.asarray(lam), g.poses.dtype, v, "space",
            jnp.asarray(plan.sep_global), jnp.asarray(plan.sep_mask), *lin,
            fmask, i_role, i_loc, j_role, j_loc, pmask, p_role, p_loc,
            int_global, int_mask)

    args = dict(sd._asdict(), **jschur._plan_dev_args(plan))
    return np.asarray(jax.vmap(step, axis_name="space")(*args.values()))


def _port_delta_in_process(tg, plan, lam):
    """The port's ranks run in one process: each shard's parts, summed
    where the ranks all-reduce, then the separator solve and the
    back-substitution."""
    sd = tschur.shard_factor_data(tg, plan)
    v = tg.poses.shape[0]
    ranks = []
    for s in range(plan.n_shards):
        t = tschur.rank_tables(plan, s, "cpu")
        loc = tuple(x[s] for x in sd)
        lin = tschur._linearize_shard(tg.poses, *loc)
        ranks.append((t, tschur._rank_parts(t, lam, lin, loc[4], loc[8])))
    packed = sum(p[2] for _, p in ranks)
    x_s = tschur._separator_solve(ranks[0][0], lam, packed)
    mine = sum(tschur._interior_delta(t, v, w, y, x_s)
               for t, (w, y, _) in ranks)
    return tschur._add_separators(ranks[0][0], mine, x_s)


@pytest.mark.parametrize("shards", [2, 3])
def test_rank_step_matches_jax_under_vmap(shards):
    g, tg = _manhattan()
    plan, tplan = _plans(g, tg, shards)
    lam = 1e-3
    jd = _jax_shard_deltas(g, plan, lam)
    for s in range(1, shards):
        np.testing.assert_array_equal(jd[s], jd[0])    # replicated
    delta = _port_delta_in_process(tg, tplan, lam).numpy()
    np.testing.assert_allclose(delta, jd[0], rtol=RTOL, atol=1e-13)
    dense = np.asarray(jslv.solve_dense(g, jfct.linearize(g), lam))
    np.testing.assert_allclose(delta, dense, rtol=RTOL, atol=1e-13)


def test_shard_data_matches_jax():
    g, tg = _manhattan()
    plan, tplan = _plans(g, tg, 3)
    for name in plan._fields:
        a, b = getattr(plan, name), getattr(tplan, name)
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), name)
    full_j = jschur.shard_factor_data(g, plan)
    full_t = tschur.shard_factor_data(tg, tplan)
    for s in range(3):
        loc_j = jschur.shard_factor_data_local(g, plan, s)
        loc_t = tschur.shard_factor_data_local(tg, tplan, s)
        for name in jschur.ShardData._fields:
            ref = np.asarray(getattr(loc_j, name))
            np.testing.assert_array_equal(
                getattr(loc_t, name).numpy(), ref, name)
            np.testing.assert_array_equal(
                getattr(full_t, name)[s].numpy(),
                np.asarray(getattr(full_j, name))[s], name)


def _model_k9c(routes, t, lam, ai, aj, r, ap, rp):
    """K9c's fixed-order sums over the rank's routes, then its damping
    (numpy, as ``csrc/supernodal.cu`` loops)."""
    ni, ns, f = t.ni, t.ns, ai.shape[0]
    h_ii = np.zeros((ni, 3, 3 * ni))
    h_is = np.zeros((ni, 3, 3 * ns))
    h_ss = np.zeros((ns, 3, 3 * ns))
    b = np.zeros((ni + ns, 3))
    mtm = lambda a, c: sum(a[k][:, None] * c[k][None, :] for k in range(3))
    for row in range(ni + ns):
        for k in range(routes["vec_ptr"][row], routes["vec_ptr"][row + 1]):
            c = routes["vcode"][k]
            g, res = ((ap[c - 2 * f], rp[c - 2 * f]) if c >= 2 * f else
                      ((aj if c & 1 else ai)[c >> 1], r[c >> 1]))
            b[row] = b[row] + (g[0] * res[0] + g[1] * res[1] + g[2] * res[2])
        for tg in range(routes["row_ptr"][row], routes["row_ptr"][row + 1]):
            acc = np.zeros((3, 3))
            for k in range(routes["tgt_ptr"][tg], routes["tgt_ptr"][tg + 1]):
                c = routes["code"][k]
                if c >= 4 * f:
                    ga = gb = ap[c - 4 * f]
                else:
                    ga = (ai if (c & 3) < 2 else aj)[c >> 2]
                    gb = (aj if c & 1 else ai)[c >> 2]
                acc = acc + mtm(ga, gb)
            col = routes["tgt_col"][tg]
            if row >= ni:
                h_ss[row - ni, :, 3 * col:3 * col + 3] = acc
            elif col >= ni:
                h_is[row, :, 3 * (col - ni):3 * (col - ni) + 3] = acc
            else:
                h_ii[row, :, 3 * col:3 * col + 3] = acc
    h_ii = h_ii.reshape(3 * ni, 3 * ni)
    live = np.repeat(t.int_mask.numpy().astype(float), 3)
    d = np.diagonal(h_ii).copy()
    h_ii[np.diag_indices(3 * ni)] = d + (lam * np.maximum(np.abs(d), 1e-8)
                                         + (1.0 - live))
    return (h_ii, h_is.reshape(3 * ni, 3 * ns), h_ss.reshape(3 * ns, 3 * ns),
            b[:ni].reshape(-1), b[ni:].reshape(-1))


@pytest.mark.parametrize("values", ["integers", "floats"])
def test_rank_routes_reproduce_the_plain_parts(values):
    """K9c's routing, modelled in numpy, against its plain version (the
    reference's segment sums and damping) on every rank: exact on
    small-integer blocks, rtol 1e-12 on floats. Also the plain version
    against the JAX package's ``assemble_local_parts`` of the same rows."""
    g, tg = _manhattan(90, seed=2)
    plan, tplan = _plans(g, tg, 3)
    rng = np.random.default_rng(3)
    draw = ((lambda *s: rng.integers(-3, 4, s).astype(np.float64))
            if values == "integers" else (lambda *s: rng.normal(size=s)))
    lam = 0.25
    for s in range(3):
        t = tschur.rank_tables(tplan, s, "cpu")
        routes = tschur.rank_routes(tplan, s)
        f, q = tplan.fmax, tplan.pmax
        lin = [draw(f, 3, 3), draw(f, 3, 3), draw(f, 3), draw(q, 3, 3),
               draw(q, 3)]
        fm = torch.as_tensor(tplan.fac_mask[s])
        pm = torch.as_tensor(tplan.pri_mask[s])
        m = [lin[0] * fm.numpy()[:, None, None], lin[1] * fm.numpy()[
            :, None, None], lin[2] * fm.numpy()[:, None],
             lin[3] * pm.numpy()[:, None, None], lin[4] * pm.numpy()[:, None]]
        ref = tschur.schur_local_assemble_ref(t, lam,
                                              *map(torch.as_tensor, m), fm,
                                              pm)
        model = _model_k9c(routes, t, lam, *m)
        jparts = jschur.assemble_local_parts(
            plan.ni, plan.ns, *m, plan.fac_mask[s], plan.i_role[s],
            plan.i_loc[s], plan.j_role[s], plan.j_loc[s], plan.pri_mask[s],
            plan.p_role[s], plan.p_loc[s], jnp.float64)
        for k, (a, b) in enumerate(zip(model, ref)):
            b = b.numpy()
            if values == "integers":
                np.testing.assert_array_equal(a, b)
            else:
                np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12)
            if k > 0:        # h_ii is the damped one here
                np.testing.assert_allclose(b, np.asarray(jparts[k]),
                                           rtol=1e-12, atol=1e-12)


def test_optimize_schur_one_rank_matches_jax():
    """P = 1 (a one-device mesh against the port's one-rank mesh): the
    same LM schedule, chi^2 and poses; one step equals the dense solve."""
    g, tg = _manhattan()
    plan, tplan = _plans(g, tg, 1)
    jr = jschur.optimize_schur(jmesh.space_mesh(1), g, plan,
                               JSolverConfig(max_iter=10))
    mesh = tmesh.multihost_mesh("cpu")
    assert (mesh.rank, mesh.size) == (0, 1)
    tr = tschur.optimize_schur(mesh, tg, tplan, SolverConfig(max_iter=10))
    assert int(tr.n_iter) == int(jr.n_iter)
    assert bool(tr.converged) == bool(jr.converged)
    np.testing.assert_allclose(float(tr.chi2), float(jr.chi2), rtol=1e-6,
                               atol=1e-14)
    np.testing.assert_allclose(tr.graph.poses.numpy(),
                               np.asarray(jr.graph.poses), atol=1e-10)
    delta = tschur.schur_delta(mesh, tg, tplan, 1e-3)
    ref = jslv.solve_dense(g, jfct.linearize(g), 1e-3)
    np.testing.assert_allclose(delta.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=1e-13)


def _merged_graph_npz(path):
    """``test_multisession_e2e.py:154``'s sequences (the JAX package's
    synth), merged as that test merges them (two windowed sessions, global
    alignment, one anchor factor at the aligned transform) plus the
    inter-session factors found at that transform, so the joint solve has
    work to do, by the port on the CPU in f32 (``tests/test_torch_merge.
    py`` holds each step to the JAX package's), and saved by the JAX
    package's ``save_graph_npz``."""
    from ndtpu.data import synth
    from ndtpu.lie import se2
    from ndtpu_torch import config as tconfig
    from ndtpu_torch.ndt import grid as tgrid
    from ndtpu_torch.slam import merge as tmerge
    from ndtpu_torch.slam import pipeline as tpipe

    c = tconfig
    cfg = c.PipelineConfig(
        grid=c.GridConfig(x0=-12.0, y0=-12.0, cell=1.0, nx=24, ny=24,
                          overlap=4),
        keyframe=c.KeyframeConfig(dist_thresh=0.7, angle_thresh=0.35,
                                  capacity=48),
        loop=c.LoopConfig(radius=3.0, min_index_gap=8, max_candidates=4,
                          local_half_extent=8.0),
        solver=c.SolverConfig(inc_iters=1, pcg_max_iter=40),
        use_loop_closure=False)
    world = synth.box_world(half=9.0)
    traj_a = synth.rectangle_trajectory(49, half=6.0, step=0.3)
    b0 = jnp.asarray([1.5, 2.0, 0.7], jnp.float32)
    traj_b = se2.compose(jnp.broadcast_to(b0, (33, 3)),
                         synth.rectangle_trajectory(33, half=4.0, step=0.25))
    t = lambda a: torch.as_tensor(np.array(a))
    states = []
    for traj, seed in ((traj_a, 5), (traj_b, 6)):
        seq = synth.make_sequence(world, traj, n_beams=180, max_range=16.0,
                                  min_range=0.1, seed=seed)
        states.append(tpipe.run_slam_windowed(t(seq.points), t(seq.mask),
                                              t(seq.odom), cfg)[0])
    sa, sb = states
    res = tmerge.global_align(tgrid.finalize(sa.stats, cfg.ndt), cfg.grid,
                              sb.kf.points[0], sb.kf.masks[0])
    assert bool(res.converged)
    sq = torch.diag(torch.tensor([10.0, 10.0, 20.0]))
    loops = tmerge.find_inter_session_loops(sa.kf, sb.kf, res.transform,
                                            cfg.loop, cfg.match,
                                            ndt_cfg=cfg.ndt)
    assert loops[0].shape[0] > 0
    anchor = (torch.tensor([0]), torch.tensor([0]), res.transform[None],
              sq[None])
    g = tmerge.merge_graphs(sa.graph, sb.graph, res.transform,
                            [torch.cat([a, b]) for a, b in zip(anchor,
                                                               loops)])
    jlaunch.save_graph_npz(str(path),
                           jfct.PoseGraph(*convert.to_numpy(g)))
    return str(path)


@pytest.fixture(scope="session")
def merged_graph_npz(tmp_path_factory, worker_id):
    if worker_id == "master":
        return _merged_graph_npz(tmp_path_factory.mktemp("merged")
                                 / "merged_graph.npz")
    path = tmp_path_factory.getbasetemp().parent / "torch_merged_graph.npz"
    with FileLock(str(path) + ".lock"):
        if not path.is_file():
            _merged_graph_npz(path)
        return str(path)


def test_graph_npz_round_trips_between_packages(merged_graph_npz, tmp_path):
    jg = jlaunch.load_graph_npz(merged_graph_npz)
    tg = tlaunch.load_graph_npz(merged_graph_npz)
    for name in tfct.PoseGraph._fields:
        np.testing.assert_array_equal(getattr(tg, name).numpy(),
                                      np.asarray(getattr(jg, name)), name)
    assert tg.bet_i.dtype == torch.long and tg.poses.dtype == torch.float32
    path = str(tmp_path / "port.npz")
    tlaunch.save_graph_npz(path, tg)
    back = jlaunch.load_graph_npz(path)
    for name in tfct.PoseGraph._fields:
        a, b = np.asarray(getattr(back, name)), np.asarray(getattr(jg, name))
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, name)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


_BLOCK_JAX = """import sys
sys.modules["jax"] = None          # any "import jax" raises ImportError
sys.modules["ndtpu"] = None        # ... and any "import ndtpu[.x]"
"""


def test_two_processes_over_gloo_solve_the_merged_graph(
        merged_graph_npz, tmp_path, monkeypatch):
    """``python -m ndtpu_torch.dist.launch`` as two real processes over
    gloo on the CPU, JAX and the JAX package unimportable in both: the
    chi^2 gates of ``test_multisession_e2e.py:187-190``, four all-reduces
    per iteration on every rank (no kernel launches on the CPU), and the
    result of the same solve in one process (the Schur elimination is
    exact, so P = 2 equals P = 1 up to f32 roundoff: rtol 1e-4)."""
    block = tmp_path / "block"
    block.mkdir()
    (block / "sitecustomize.py").write_text(_BLOCK_JAX)
    monkeypatch.setenv("PYTHONPATH", str(block))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(tlaunch.ROOT),
                                                       str(block)]))
    for mod in ("jax", "ndtpu.config"):       # the block holds in a child
        probe = subprocess.run([sys.executable, "-c", f"import {mod}"],
                               env=env, cwd=str(tlaunch.ROOT),
                               capture_output=True, text=True, timeout=120)
        assert probe.returncode != 0, mod
        assert "ModuleNotFoundError" in probe.stderr, mod
    rec = tlaunch.launch_local(2, graph_npz=merged_graph_npz,
                               port=_free_port(), device="cpu",
                               timeout_s=300.0)
    assert rec["num_processes"] == 2 and rec["device"] == "cpu"
    assert rec["chi2_after"] <= rec["chi2_before"] + 1e-6, rec
    assert rec["chi2_after"] < max(0.5 * rec["chi2_before"], 50.0), rec
    iters = rec["iters"]
    for rank in rec["ranks"]:
        assert rank["iters"] == iters
        assert rank["k5"] == rank["k9c"] == 0   # plain versions on the CPU
        assert rank["all_reduce"] == 4 * iters  # the reference's 4 psums
    tg = tlaunch.load_graph_npz(merged_graph_npz)
    _, tplan = _plans(tg, tg, 1)
    one = tschur.optimize_schur(tmesh.multihost_mesh("cpu"), tg, tplan,
                                SolverConfig(max_iter=10))
    assert float(tfct.chi2(tg)) == pytest.approx(rec["chi2_before"],
                                                 rel=1e-6)
    assert rec["chi2_before"] > 0.5           # a solve with work to do
    assert float(tfct.chi2(one.graph)) == pytest.approx(rec["chi2_after"],
                                                        rel=1e-4)


def test_launch_refuses_unported_task_and_missing_card(monkeypatch):
    """The worker (``--task schur`` and ``--task slam``), ``launch_local``
    and the meshes run on the card unless the CPU is asked for."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlaunch.worker_main(["--num-processes", "1", "--process-id", "0"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlaunch.worker_main(["--num-processes", "1", "--process-id", "0",
                             "--task", "slam"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlaunch.launch_local(2, device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlaunch.launch_local(2, device="cuda", task="slam")
    for make in (tmesh.multihost_mesh, tmesh.batch_mesh, tmesh.space_mesh,
                 lambda: tmesh.grid_mesh(1, 1)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()                            # the card unless asked
    mesh = tmesh.multihost_mesh("cpu")
    assert (mesh.rank, mesh.size, mesh.device) == (0, 1, torch.device("cpu"))


def test_one_process_worker_reports_as_the_reference(tmp_path, capsys):
    """One CPU worker on the default 120-pose Manhattan problem: the
    reference worker's report fields, chi^2 falling."""
    out = tmp_path / "rec.json"
    tlaunch.worker_main(["--num-processes", "1", "--process-id", "0",
                         "--device", "cpu", "--out", str(out)])
    rec = json.loads(out.read_text())
    for key in ("num_processes", "chi2_before", "chi2_after", "solve_s",
                "psum_s", "device", "iters"):
        assert key in rec
    assert rec["num_processes"] == 1 and rec["n_poses"] == 120
    assert rec["chi2_after"] < 0.5 * rec["chi2_before"]
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == rec
