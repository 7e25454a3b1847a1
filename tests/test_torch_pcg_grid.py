"""Large-graph PCG, the paths K6g carries on the card, against the JAX
package in f64 at bench.py's 10k poses (its §4 graph: ``manhattan_world(
10000, seed=0, loop_prob=0.1)`` with its poses jittered by N(0, 0.05)):
``optimize(method="pcg")``, ``incremental_update``'s global take and
settled check under bench.py §5's solver, ``marginal_covariance_pcg`` and
``solve_g2o --method pcg``, all through ``pcg_solve_ref`` (the plain
version K6g is held to on the card); ``kernels.pcg_route`` against K6's
launcher; and K5's robust kinds (K5r): the kind codes, and each kind's
plain linearization at 10k against the JAX package.

Every JAX reference is jitted. ``PYTHONPATH=. python
tests/test_torch_pcg_grid.py`` regenerates
``tests/data/torch_config4_pcg10k_ref.json``, the JAX package's f32 and
f64 ``solve_g2o --manhattan 10000 --method pcg`` results, which
``chip_smoke.py`` holds the card's run to (~2 min)."""

import functools
import json
import re
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndtpu.config import SolverConfig as JSolverConfig
from ndtpu.data import g2o as jg2o
from ndtpu.graph import factors as jfct
from ndtpu.graph import incremental as jinc
from ndtpu.graph import solve as jslv
from ndtpu_torch import convert, kernels
from ndtpu_torch.config import SolverConfig
from ndtpu_torch.graph import factors as tfct
from ndtpu_torch.graph import incremental as tinc
from ndtpu_torch.graph import solve as tslv

torch.set_num_threads(2)

REF = (Path(__file__).resolve().parent / "data"
       / "torch_config4_pcg10k_ref.json")
N10K = 10000
#: bench.py §5's solver for the incremental updates, and its damping.
ICFG = dict(inc_iters=2, pcg_max_iter=25, full_solve_every=0)
LAM = 1e-3
#: The robust threshold of the K5r cases (whitened units): about the median
#: residual norm of the 10k graph (5.45; they reach ~1,650), so every kind
#: weighs inliers and outliers alike (chip_smoke.K5R_DELTA).
ROBUST_DELTA = 5.0


def _jax_graph(n=N10K, seed=0, dtype=jnp.float64):
    """bench.py §4's graph (``solve_g2o --manhattan n --seed seed``'s)."""
    data = jg2o.manhattan_world(n, seed=seed, loop_prob=0.1)
    data = data._replace(poses=data.poses + np.random.default_rng(
        seed).normal(0, 0.05, data.poses.shape))
    return jg2o.to_graph(data, dtype=dtype)


def _to_port(tree):
    return convert.from_numpy(jax.tree_util.tree_map(np.asarray, tree))


@pytest.fixture(scope="module")
def graphs():
    """The 10k graph in f64 in both packages, and the graph bench.py §5
    settles with ``optimize(SolverConfig(max_iter=30, pcg_max_iter=250),
    method="pcg")`` (computed by the JAX package, jitted)."""
    gj = _jax_graph()
    opt = jax.jit(functools.partial(
        jslv.optimize, cfg=JSolverConfig(max_iter=30, pcg_max_iter=250),
        method="pcg"))
    settled = opt(gj).graph
    return gj, _to_port(gj), settled, _to_port(settled)


def _c_pcg_smem():
    """K6's launcher's shared-memory formula, read from its source."""
    src = (Path(kernels.__file__).parent / "csrc" / "pcg_solve.cu").read_text()
    body = re.search(r"inline size_t pcg_smem\(int v, int f, int p\) \{\s*"
                     r"return (.*?);", src, re.S).group(1)
    expr = " ".join(body.replace("(size_t)", "").split())
    return lambda v, f, p: eval(expr, {}, dict(v=v, f=f, p=p))


@pytest.mark.parametrize("v,f,p,route", [
    (1024, 2048, 4, "block"),      # configs 2-3: pose and factor capacity
    (160, 320, 1, "block"),        # one serving session
    (1468, 2936, 4, "block"),      # the largest at F = 2V, P = 4
    (1469, 2938, 4, "grid"),
    (2048, 4096, 8, "grid"),       # config 5's merged graph
    (10000, 10305, 1, "grid"),     # config 4 / bench.py §4
    (10064, 10369, 1, "grid"),     # bench.py §5b's local graph
    (25000, 25750, 1, "grid"),
])
def test_pcg_route_equals_the_launchers_test(v, f, p, route):
    """``pcg_route`` says "block" exactly where K6's launcher's
    ``pcg_smem`` is within the 227 KB a block can opt in to on Hopper."""
    c_smem = _c_pcg_smem()
    assert kernels.SMEM_MAX == 232448
    assert kernels.pcg_smem(v, f, p) == c_smem(v, f, p)
    assert kernels.pcg_route(v, f, p) == route
    assert (route == "block") == (c_smem(v, f, p) <= 232448)


def test_optimize_pcg_at_10k_matches_jax(graphs):
    """The port's ``optimize(method="pcg")`` (its plain PCG, as K6g's
    oracle) on bench.py §4's 10k graph in f64, 3 LM iterations of 250 PCG
    iterations each, against the JAX package's: chi^2 rtol 1e-9, poses
    atol 1e-7."""
    gj, gt, _, _ = graphs
    cfg = dict(max_iter=3, pcg_max_iter=250)
    ref = jax.jit(functools.partial(jslv.optimize, cfg=JSolverConfig(**cfg),
                                    method="pcg"))(gj)
    got = tslv.optimize(gt, SolverConfig(**cfg), method="pcg")
    assert int(got.n_iter) == int(ref.n_iter) == 3
    np.testing.assert_allclose(float(got.chi2), float(ref.chi2), rtol=1e-9)
    assert float(got.chi2) < float(tfct.chi2(gt))
    np.testing.assert_allclose(got.graph.poses.numpy(),
                               np.asarray(ref.graph.poses), rtol=0,
                               atol=1e-7)


@pytest.mark.parametrize("case", ["active", "settled"])
def test_incremental_update_at_10k_matches_jax(graphs, case):
    """``incremental_update`` at 10k poses under bench.py §5's solver
    (``inc_iters=2, pcg_max_iter=25, full_solve_every=0``, lam 1e-3): the
    active step on the §4 graph (the global take: its fresh loop factors
    overflow the local capacities) and the step on the settled graph, whose
    last step moved nothing. Take codes equal, poses atol 1e-7."""
    gj, gt, sj, st = graphs
    g_j, g_t = (gj, gt) if case == "active" else (sj, st)
    last = float("inf") if case == "active" else 0.0
    state_j = jinc.SmootherState(graph=g_j, lam=jnp.asarray(LAM),
                                 last_max_delta=jnp.asarray(last),
                                 step=jnp.asarray(0, jnp.int32))
    upd = jax.jit(functools.partial(jinc.incremental_update,
                                    cfg=JSolverConfig(**ICFG),
                                    return_take=True))
    out_j, take_j = upd(state_j)
    state_t = tinc.SmootherState(
        graph=g_t, lam=torch.tensor(LAM, dtype=torch.float64),
        last_max_delta=torch.tensor(last, dtype=torch.float64),
        step=torch.zeros((), dtype=torch.long))
    out_t, take_t = tinc.incremental_update(state_t, SolverConfig(**ICFG),
                                            return_take=True)
    assert int(take_t) == int(take_j) == (1 if case == "active" else 0)
    np.testing.assert_allclose(out_t.graph.poses.numpy(),
                               np.asarray(out_j.graph.poses), rtol=0,
                               atol=1e-7)
    np.testing.assert_allclose(float(out_t.lam), float(out_j.lam), rtol=0)


def test_marginal_covariance_pcg_at_10k_matches_jax(graphs):
    """``marginal_covariance_pcg`` of pose 5,000 of the settled 10k graph
    (three unit-vector PCG solves, K6g's path on the card) against the JAX
    package's, rtol 1e-7."""
    _, _, sj, st = graphs
    ref = jax.jit(functools.partial(jinc.marginal_covariance_pcg, idx=5000,
                                    cfg=JSolverConfig()))(sj)
    got = tinc.marginal_covariance_pcg(st, 5000, SolverConfig())
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-7,
                               atol=0)


def test_solve_g2o_pcg_at_10k_matches_jax(tmp_path, capsys):
    """Both CLIs on ``--manhattan 10000 --method pcg --max-iter 3`` (f32,
    the port on the CPU): method pcg, 3 iterations each, chi^2 falling; the
    written graphs' chi^2 (in f64) within rtol 1e-4 and poses within 1e-3
    of each other (f32 PCG in two packages sums in two orders; 3
    iterations leave chi^2 ~1,600 x its optimum, so a step taken
    differently would move it far past that)."""
    from ndtpu import solve_g2o as jcli
    from ndtpu_torch import solve_g2o as tcli
    from ndtpu_torch.data import g2o as tg2o

    args = ["--manhattan", "10000", "--method", "pcg", "--max-iter", "3"]
    jout, tout = str(tmp_path / "j.g2o"), str(tmp_path / "t.g2o")
    jcli.main(args + ["-o", jout])
    j_err = capsys.readouterr().err
    res = tcli.main(args + ["--device", "cpu", "-o", tout])
    capsys.readouterr()
    assert res["method"] == "pcg" and "method=pcg" in j_err
    assert res["n_iter"] == 3 and " in 3 iters" in j_err
    assert res["chi2_final"] < res["chi2_initial"]
    got, ref = tg2o.read_g2o(tout), jg2o.read_g2o(jout)
    np.testing.assert_array_equal(got.edges_ij, ref.edges_ij)
    chi = [float(tfct.chi2(tg2o.to_graph(d, dtype=torch.float64)))
           for d in (got, ref)]
    np.testing.assert_allclose(chi[0], chi[1], rtol=1e-4)
    np.testing.assert_allclose(got.poses, ref.poses, rtol=0, atol=1e-3)


def test_pcg_solve_grid_refuses_cpu_tensors():
    """K6g's raw entry point takes CUDA tensors only (``graph.solve.
    pcg_solve`` sends CPU tensors to ``pcg_solve_ref`` first)."""
    g = tfct.empty_graph(8, 2, 16, torch.float32)
    lin = tfct.factor_linearize_ref(*tfct._graph_args(g))
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        kernels.pcg_solve_grid(g.bet_i, g.bet_j, g.bet_mask, g.prior_idx,
                               g.prior_mask, g.pose_mask, lin, None, 1e-4,
                               10, 1e-5)


def test_robust_kind_codes():
    """K5r's kind codes follow ``csrc/pose_graph.cuh`` (huber 0, cauchy 1,
    tukey 2, geman 3); an unknown kind raises ``ValueError`` before any
    check or launch when a weight would apply (``huber_delta > 0``), as
    the JAX package's ``robust_weight`` does, and not at all without one."""
    assert kernels.ROBUST_KINDS == ("huber", "cauchy", "tukey", "geman")
    assert [kernels.robust_code(k) for k in kernels.ROBUST_KINDS] == [0, 1,
                                                                      2, 3]
    with pytest.raises(ValueError, match="unknown robust kernel 'bogus'"):
        kernels.robust_code("bogus")
    g = tfct.empty_graph(8, 2, 16, torch.float32)
    args = tfct._graph_args(g)
    launches = dict(kernels.LAUNCHES)
    with pytest.raises(ValueError, match="unknown robust kernel"):
        kernels.factor_linearize(*args, 1.0, robust="bogus")
    assert kernels.LAUNCHES == launches
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        kernels.factor_linearize(*args, 0.0, robust="bogus")
    with pytest.raises(ValueError, match="unknown robust kernel"):
        tfct.linearize(g, 1.0, "bogus")
    with pytest.raises(ValueError, match="unknown robust kernel"):
        jfct.linearize(jfct.empty_graph(8, 2, 16, jnp.float32), 1.0, "bogus")
    tfct.linearize(g, 0.0, "bogus")
    jfct.linearize(jfct.empty_graph(8, 2, 16, jnp.float32), 0.0, "bogus")


@pytest.mark.parametrize("kind", ["huber", "cauchy", "tukey", "geman"])
def test_robust_linearize_at_10k_matches_jax(graphs, kind):
    """K5r's plain version (``factor_linearize_ref``, the port's CPU path)
    with each robust kind at threshold ``ROBUST_DELTA`` against the JAX
    package's ``linearize`` in f64: every array within rtol 1e-12 of its
    max, chi^2 within rtol 1e-12."""
    gj, gt, _, _ = graphs
    ref = jax.jit(functools.partial(jfct.linearize, huber_delta=ROBUST_DELTA,
                                    robust=kind))(gj)
    got = tfct.linearize(gt, ROBUST_DELTA, kind)
    for a, b in zip([*got[0], *got[1]], [*ref[0], *ref[1]]):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=1e-12 * np.abs(b).max())
    chi_j = float(jax.jit(functools.partial(jfct.chi2,
                                            huber_delta=ROBUST_DELTA,
                                            robust=kind))(gj))
    np.testing.assert_allclose(float(tfct.chi2(gt, ROBUST_DELTA, kind)),
                               chi_j, rtol=1e-12)


def make_reference(path=REF):
    """The JAX package's ``solve_g2o --manhattan 10000 --method pcg`` (the
    CLI's solver: ``optimize(method="pcg")``, ``SolverConfig(max_iter=50,
    pcg_max_iter=500)``), in f32 as the CLI runs it and in f64."""
    jax.config.update("jax_enable_x64", True)
    out = dict(command="PYTHONPATH=. python tests/test_torch_pcg_grid.py",
               graph="ndtpu.data.g2o.manhattan_world(10000, seed=0, "
                     "loop_prob=0.1), poses + N(0, 0.05) from "
                     "default_rng(0), prior on pose 0",
               solver="ndtpu.graph.solve.optimize(method='pcg'), "
                      "SolverConfig(max_iter=50, pcg_max_iter=500)")
    cfg = JSolverConfig(max_iter=50, pcg_max_iter=500)
    opt = jax.jit(functools.partial(jslv.optimize, cfg=cfg, method="pcg"))
    for name, dt in (("jax_f32", jnp.float32), ("jax_f64", jnp.float64)):
        g = _jax_graph(dtype=dt)
        res = opt(g)
        out[name] = dict(chi2_initial=float(jfct.chi2(g)),
                         chi2_final=float(res.chi2),
                         n_iter=int(res.n_iter),
                         converged=bool(res.converged))
        print(name, out[name])
    path.write_text(json.dumps(out, indent=1) + "\n")


if __name__ == "__main__":
    make_reference(Path(sys.argv[1]) if len(sys.argv) > 1 else REF)
