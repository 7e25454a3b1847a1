"""ndtpu_torch.graph (factors, solve, incremental) against ndtpu.graph on a
small f64 pose graph: a noisy odometry chain, a prior and loop factors."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndtpu.config import SolverConfig
from ndtpu.graph import factors as jfct
from ndtpu.graph import incremental as jinc
from ndtpu.graph import solve as jslv
from ndtpu.lie import se2 as jse2
from ndtpu_torch import convert
from ndtpu_torch.graph import factors as tfct
from ndtpu_torch.graph import incremental as tinc
from ndtpu_torch.graph import solve as tslv

torch.set_num_threads(2)

V, F = 24, 64
SQI = np.diag([10.0, 10.0, 20.0])


def _close(a, b, tol=1e-10):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_allclose(a, b, rtol=0,
                               atol=tol * max(1.0, float(np.abs(b).max())))


def _build(mod, se2, arr, loops, seed=0):
    """The same graph through either package's append functions."""
    rng = np.random.default_rng(seed)
    gt = np.stack([np.cos(np.arange(V) * 0.25) * 5,
                   np.sin(np.arange(V) * 0.25) * 5,
                   np.arange(V) * 0.25 + np.pi / 2], -1)
    init = gt + rng.normal(0, [0.1, 0.1, 0.03], gt.shape)
    g = mod.empty_graph(V + 8, 4, F, arr(np.zeros(0)).dtype)
    for i in range(V):
        g = mod.add_pose(g, arr(init[i]))
    g = mod.add_prior(g, 0, arr(gt[0]), arr(SQI * 10))
    pairs = [(i, i + 1) for i in range(V - 1)] + loops
    for i, j in pairs:
        z = np.asarray(se2.between(arr(gt[i]), arr(gt[j])))
        z = z + rng.normal(0, [0.02, 0.02, 0.005])
        g = mod.add_between(g, i, j, arr(z), arr(SQI))
    return g


def _jax_graph(loops=((2, 23),)):
    return _build(jfct, jse2, jnp.asarray, list(loops))


def _pair(loops=((2, 23),)):
    gj = _jax_graph(loops)
    return gj, convert.from_numpy(gj)


def test_appends_match_jax():
    from ndtpu_torch.lie import se2 as tse2

    gj = _jax_graph()
    gt = _build(tfct, tse2, lambda a: torch.as_tensor(np.array(a)),
                [(2, 23)])
    for name, a, b in zip(gt._fields, convert.to_numpy(gt), gj):
        _close(a, np.asarray(b)) if a.dtype.kind == "f" else \
            np.testing.assert_array_equal(a, np.asarray(b), err_msg=name)


def test_append_overflow_is_dropped():
    g = tfct.empty_graph(2, 1, 1, torch.float64)
    for k in range(3):
        g = tfct.add_pose(g, torch.full((3,), float(k), dtype=torch.float64))
    g = tfct.add_between(g, 0, 1, torch.zeros(3, dtype=torch.float64),
                         torch.eye(3, dtype=torch.float64))
    g = tfct.add_between(g, 1, 0, torch.ones(3, dtype=torch.float64),
                         torch.eye(3, dtype=torch.float64))
    assert int(g.n_poses) == 2 and int(g.n_between) == 1
    assert float(g.poses[1, 0]) == 1.0 and int(g.bet_i[0]) == 0


@pytest.mark.parametrize("huber", [0.0, 0.5])
def test_linearize_and_chi2(huber):
    gj, gt = _pair()
    (ai, aj, r), (ap, rp) = jfct.linearize(gj, huber)
    (bi, bj, s), (bp, sp) = tfct.linearize(gt, huber)
    for x, y in [(bi, ai), (bj, aj), (s, r), (bp, ap), (sp, rp)]:
        _close(x.numpy(), y)
    _close(tfct.chi2(gt, huber).numpy(), jfct.chi2(gj, huber))


@pytest.mark.parametrize("kind", ["huber", "cauchy", "tukey", "geman"])
def test_robust_weight(kind):
    r = np.linspace(0.0, 6.0, 25)
    _close(tfct.robust_weight(torch.as_tensor(r), 1.5, kind).numpy(),
           jfct.robust_weight(jnp.asarray(r), 1.5, kind))


def test_info_to_sqrt_info():
    rng = np.random.default_rng(1)
    a = rng.normal(size=(8, 3, 3))
    info = a @ a.transpose(0, 2, 1) + np.eye(3)
    _close(tfct.info_to_sqrt_info(torch.as_tensor(info)).numpy(),
           jfct.info_to_sqrt_info(jnp.asarray(info)))


def test_linear_algebra_pieces():
    gj, gt = _pair()
    lj, lt = jfct.linearize(gj, 0.0), tfct.linearize(gt, 0.0)
    hj, bj = jslv.normal_equations(gj, lj)
    ht, bt = tslv.normal_equations(gt, lt)
    _close(ht.numpy(), hj)
    _close(bt.numpy(), bj)
    x = np.random.default_rng(2).normal(size=(V + 8, 3))
    _close(tslv.hessian_matvec(gt, lt, torch.as_tensor(x)).numpy(),
           jslv.hessian_matvec(gj, lj, jnp.asarray(x)))
    _close(tslv.gradient(gt, lt).numpy(), jslv.gradient(gj, lj))
    dj, dt = jslv.block_diag_hessian(gj, lj), tslv.block_diag_hessian(gt, lt)
    _close(dt.numpy(), dj)
    d = np.asarray(dj) + np.eye(3)
    _close(tslv._inv3(torch.as_tensor(d)).numpy(), jslv._inv3(jnp.asarray(d)))


@pytest.mark.parametrize("lam", [1e-4, 1.0])
def test_solve_dense_and_pcg(lam):
    gj, gt = _pair()
    lj, lt = jfct.linearize(gj, 0.0), tfct.linearize(gt, 0.0)
    lam_t = torch.tensor(lam, dtype=torch.float64)
    _close(tslv.solve_dense(gt, lt, lam_t).numpy(),
           jslv.solve_dense(gj, lj, jnp.asarray(lam)), 1e-9)
    cfg = SolverConfig(pcg_max_iter=40, pcg_tol=1e-8)
    xt, it_t = tslv.pcg(gt, lt, lam_t, cfg)
    xj, it_j = jslv.pcg(gj, lj, jnp.asarray(lam), cfg)
    assert int(it_t) == int(it_j)
    _close(xt.numpy(), xj, 1e-9)


@pytest.mark.parametrize("method", ["dense", "pcg"])
def test_optimize(method):
    gj, gt = _pair()
    cfg = SolverConfig(max_iter=8, pcg_max_iter=60)
    rj = jslv.optimize(gj, cfg, method=method, huber_delta=5.0)
    rt = tslv.optimize(gt, cfg, method=method, huber_delta=5.0)
    assert int(rt.n_iter) == int(rj.n_iter)
    assert bool(rt.converged) == bool(rj.converged)
    _close(rt.graph.poses.numpy(), rj.graph.poses, 1e-8)
    _close(rt.chi2.numpy(), rj.chi2, 1e-8)
    assert float(rt.chi2) < 0.1 * float(tfct.chi2(gt, 5.0))


def test_fresh_residual_max():
    gj, gt = _pair()
    for k in (4, 64, 200):
        _close(tinc.fresh_residual_max(gt, k).numpy(),
               jinc.fresh_residual_max(gj, k))


def _smoother_pair(gj, last_delta, step=0):
    sj = jinc.SmootherState(graph=gj, lam=jnp.asarray(1e-4),
                            last_max_delta=jnp.asarray(last_delta),
                            step=jnp.asarray(step, jnp.int32))
    return sj, convert.from_numpy(sj)


CASES = {
    # name: (loops, solver overrides, last_max_delta, step, fresh_since, take)
    "local": ((), dict(local_poses=16, local_factors=48), np.inf, 0, 20, 2),
    "local_loop_cycle": (((4, 23),), dict(local_poses=32, local_factors=64),
                         np.inf, 0, 20, 2),
    "global_overflow": ((), dict(local_poses=2, local_factors=4), np.inf, 0,
                        20, 1),
    "global_no_local": ((), dict(local_poses=0), np.inf, 0, None, 1),
    "settled_slow_check": ((), dict(local_poses=16, local_factors=48), 0.0, 0,
                           20, 2),
    "full_solve": ((), dict(local_poses=16, local_factors=48,
                            full_solve_every=3), np.inf, 2, 20, 2),
}


@pytest.mark.parametrize("case", list(CASES))
def test_incremental_update(case):
    loops, over, last_delta, step, since, take = CASES[case]
    gj = _jax_graph(loops)
    cfg = dataclasses.replace(SolverConfig(inc_iters=2, pcg_max_iter=60,
                                           local_fresh_k=8), **over)
    sj, st = _smoother_pair(gj, last_delta, step)
    fs_j = None if since is None else jnp.asarray(since, jnp.int32)
    fs_t = None if since is None else torch.tensor(since)
    oj, kj = jinc.incremental_update(sj, cfg, huber_delta=5.0,
                                     fresh_since=fs_j, return_take=True)
    ot, kt = tinc.incremental_update(st, cfg, huber_delta=5.0,
                                     fresh_since=fs_t, return_take=True)
    assert int(kt) == int(kj) == take
    _close(ot.graph.poses.numpy(), oj.graph.poses, 1e-8)
    _close(ot.lam.numpy(), oj.lam, 1e-12)
    _close(ot.last_max_delta.numpy(), oj.last_max_delta, 1e-8)
    assert int(ot.step) == int(oj.step)


def test_incremental_settled_skip():
    """At the optimum with last step 0, the update skips (take 0)."""
    gj = jslv.optimize(_jax_graph(), SolverConfig(max_iter=20),
                       method="dense").graph
    cfg = SolverConfig(local_poses=16, local_factors=48)
    sj, st = _smoother_pair(gj, 0.0)
    oj, kj = jinc.incremental_update(sj, cfg, return_take=True)
    ot, kt = tinc.incremental_update(st, cfg, return_take=True)
    assert int(kt) == int(kj) == 0
    _close(ot.graph.poses.numpy(), oj.graph.poses, 1e-12)
