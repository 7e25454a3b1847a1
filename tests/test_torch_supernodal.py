"""ndtpu_torch's config-4 solve against ndtpu's, in f64 on the CPU: the
partition and supernodal plans (array for array), the plain assembly (K9a's
oracle) and Schur reduction (K9b's), a numpy model of the kernels'
fixed-order sums over the plan's routing tables, the supernodal step, the
LM loop and the marginal covariances. The inputs are made from seeds with
numpy and go through both packages.

Run as a script (``PYTHONPATH=. python tests/test_torch_supernodal.py``)
it writes ``tests/data/torch_config4_manhattan10k_ref.json``: the JAX
package's final chi^2 and iteration counts, f32 and f64, of ``solve_g2o
--manhattan 10000 --shards 64``'s graph, which ``chip_smoke.py`` holds the
card's run to.
"""

import json
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
from ndtpu.graph import supernodal as jsn
from ndtpu_torch import convert
from ndtpu_torch.config import SolverConfig
from ndtpu_torch.data import g2o as tg2o
from ndtpu_torch.graph import factors as tfct
from ndtpu_torch.graph import incremental as tinc
from ndtpu_torch.graph import solve as tslv
from ndtpu_torch.graph import supernodal as tsn

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
REF4 = ROOT / "tests" / "data" / "torch_config4_manhattan10k_ref.json"


def _graphs(n, seed=3, loop_prob=0.15, jitter=0.03, jitter_seed=0):
    """The same jittered Manhattan graph in both packages (f64)."""
    data = jg2o.manhattan_world(n, seed=seed, loop_prob=loop_prob)
    noise = np.random.default_rng(jitter_seed).normal(0, jitter,
                                                      data.poses.shape)
    gj = jg2o.to_graph(data, dtype=jnp.float64)
    gj = gj._replace(poses=gj.poses + jnp.asarray(noise))
    gt = tg2o.to_graph(data, dtype=torch.float64)
    gt = gt._replace(poses=gt.poses + torch.as_tensor(noise))
    return gj, gt


def _bench_graphs(n=10000):
    """bench.py's / ``solve_g2o --manhattan n``'s graph (seed 0, loop_prob
    0.1, jitter N(0, 0.05) from default_rng(0))."""
    return _graphs(n, seed=0, loop_prob=0.1, jitter=0.05)


def _assert_plans_equal(pj, pt):
    for name in pj.schur._fields:
        a, b = getattr(pj.schur, name), getattr(pt.schur, name)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(b, a, err_msg=name)
    for name in pj._fields[1:]:
        a, b = getattr(pj, name), getattr(pt, name)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(b, a, err_msg=name)


@pytest.mark.parametrize("n,shards,use_rcm", [(240, 8, False),
                                              (120, 4, False)])
def test_plans_equal_to_jax(n, shards, use_rcm):
    gj, gt = _graphs(n)
    _assert_plans_equal(jsn.plan_supernodal(gj, shards, use_rcm=use_rcm),
                        tsn.plan_supernodal(gt, shards, use_rcm=use_rcm))


@pytest.fixture(scope="module")
def bench10k():
    """The 10k-pose graph and its P = 64 plans in both packages."""
    gj, gt = _bench_graphs()
    return gj, gt, jsn.plan_supernodal(gj, 64), tsn.plan_supernodal(gt, 64)


def test_plans_equal_to_jax_full_width(bench10k):
    gj, gt, pj, pt = bench10k
    assert (gt.poses.shape[0], gt.bet_i.shape[0]) == (10000, 10305)
    assert (pt.schur.ni, pt.schur.ns, pt.ns_loc, pt.schur.fmax) == (155, 558,
                                                                   51, 182)
    _assert_plans_equal(pj, pt)


def _lins(gj, gt):
    return jfct.linearize(gj), tfct.linearize(gt)


def _flat(lin):
    return [*lin[0], *lin[1]]


def test_assemble_ref_matches_jax():
    gj, gt = _graphs(240)
    pj, pt = jsn.plan_supernodal(gj, 8), tsn.plan_supernodal(gt, 8)
    linj, lint = _lins(gj, gt)
    ref = jsn._assemble_parts(pj, *_flat(linj), jnp.float64)
    got = tsn.supernodal_assemble_ref(pt, *_flat(lint))
    for a, b in zip(got, ref):
        b = np.asarray(b)
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-12,
                                   atol=1e-12 * np.abs(b).max())
    # The wrapper sends CPU tensors to the plain version, and refuses a
    # linearization of another graph.
    for a, b in zip(tsn.supernodal_assemble(pt, *_flat(lint)), got):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="plan was made for"):
        tsn.supernodal_assemble(pt, *_flat(lint)[:3], lint[1][0][:0],
                                lint[1][1][:0])


def _jax_schur_reduce(plan, s_part, rhs_part, h_ss, b_s, lam):
    """ndtpu/graph/supernodal.py:331-361 on given Schur parts."""
    sp = plan.schur
    p_dim = sp.fac_idx.shape[0]
    nsl3, ns3 = 3 * plan.ns_loc, 3 * sp.ns
    ls_global = jnp.asarray(plan.ls_global)
    comp = jnp.arange(3, dtype=jnp.int32)
    gidx = (ls_global[:, :, None] * 3 + comp[None, None, :]).reshape(
        p_dim, nsl3)
    gvalid = jnp.repeat(jnp.asarray(plan.ls_mask), 3, axis=1)
    pair_idx = jnp.where(gvalid[:, :, None] & gvalid[:, None, :],
                         gidx[:, :, None] * ns3 + gidx[:, None, :],
                         ns3 * ns3)
    seg = jax.ops.segment_sum
    s_red = seg(s_part.reshape(-1), pair_idx.reshape(-1),
                num_segments=ns3 * ns3 + 1)[:-1].reshape(ns3, ns3)
    rhs_red = seg(rhs_part.reshape(-1),
                  jnp.where(gvalid, gidx, ns3).reshape(-1),
                  num_segments=ns3 + 1)[:-1]
    s_tot = h_ss - s_red
    rhs_tot = b_s - rhs_red
    diag_ss = jnp.diagonal(h_ss)
    live_s = jnp.repeat(jnp.asarray(sp.sep_mask).astype(h_ss.dtype), 3)
    damp_s = lam * jnp.maximum(jnp.abs(diag_ss), 1e-8) + (1.0 - live_s)
    return s_tot + jnp.diag(damp_s), rhs_tot


def test_schur_reduce_ref_matches_jax():
    gj, gt = _graphs(240)
    pj, pt = jsn.plan_supernodal(gj, 8), tsn.plan_supernodal(gt, 8)
    _, lint = _lins(gj, gt)
    _, _, h_ss, _, b_s = tsn.supernodal_assemble_ref(pt, *_flat(lint))
    rng = np.random.default_rng(4)
    nsl3 = 3 * pt.ns_loc
    s_part = rng.normal(size=(8, nsl3, nsl3))
    rhs_part = rng.normal(size=(8, nsl3))
    got = tsn.schur_reduce_ref(pt, torch.as_tensor(s_part),
                               torch.as_tensor(rhs_part), h_ss, b_s, 1e-3)
    ref = _jax_schur_reduce(pj, jnp.asarray(s_part), jnp.asarray(rhs_part),
                            jnp.asarray(h_ss.numpy()),
                            jnp.asarray(b_s.numpy()), 1e-3)
    for a, b in zip(got, ref):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-12,
                                   atol=1e-12 * np.abs(b).max())
    for a, b in zip(tsn.schur_reduce(pt, torch.as_tensor(s_part),
                                     torch.as_tensor(rhs_part), h_ss, b_s,
                                     1e-3), got):
        assert torch.equal(a, b)


def _mtm(a, b):
    """A^T B with k summed in order 0, 1, 2 (pose_graph.cuh::mtm3)."""
    return a[0][:, None] * b[0][None, :] + a[1][:, None] * b[1][None, :] \
        + a[2][:, None] * b[2][None, :]


def _model_k9a(plan, ai, aj, r, ap, rp):
    """K9a's fixed-order sums over the plan's tables (numpy)."""
    t = plan.routes.host
    sp = plan.schur
    p_dim, ni, nsl, ns = sp.fac_idx.shape[0], sp.ni, plan.ns_loc, sp.ns
    f = ai.shape[0]
    h_ii = np.zeros((p_dim * ni, 3, 3 * ni))
    h_is = np.zeros((p_dim * ni, 3, 3 * nsl))
    h_ss = np.zeros((ns, 3, 3 * ns))
    b = np.zeros((p_dim * ni + ns, 3))
    n_int = p_dim * ni
    for row in range(n_int + ns):
        for k in range(t["vec_ptr"][row], t["vec_ptr"][row + 1]):
            c = t["vcode"][k]
            g, res = ((ap[c - 2 * f], rp[c - 2 * f]) if c >= 2 * f else
                      ((aj if c & 1 else ai)[c >> 1], r[c >> 1]))
            b[row] = b[row] + (g[0] * res[0] + g[1] * res[1]
                               + g[2] * res[2])
        for tg in range(t["row_ptr"][row], t["row_ptr"][row + 1]):
            acc = np.zeros((3, 3))
            for k in range(t["tgt_ptr"][tg], t["tgt_ptr"][tg + 1]):
                c = t["code"][k]
                if c >= 4 * f:
                    ga = gb = ap[c - 4 * f]
                else:
                    kind = c & 3
                    ga = (ai if kind < 2 else aj)[c >> 2]
                    gb = (aj if kind & 1 else ai)[c >> 2]
                acc = acc + _mtm(ga, gb)
            col = t["tgt_col"][tg]
            if row >= n_int:
                h_ss[row - n_int, :, 3 * col:3 * col + 3] = acc
            elif col >= ni:
                h_is[row, :, 3 * (col - ni):3 * (col - ni) + 3] = acc
            else:
                h_ii[row, :, 3 * col:3 * col + 3] = acc
    return (h_ii.reshape(p_dim, 3 * ni, 3 * ni),
            h_is.reshape(p_dim, 3 * ni, 3 * nsl), h_ss.reshape(3 * ns, 3 * ns),
            b[:n_int].reshape(p_dim, 3 * ni), b[n_int:].reshape(-1))


def _model_k9b(plan, s_part, rhs_part, h_ss, b_s, lam):
    """K9b's fixed-order sums over the plan's tables (numpy)."""
    t = plan.routes.host
    ns = plan.schur.ns
    s_red = np.zeros_like(h_ss)
    rhs_red = np.zeros_like(b_s)
    for g1 in range(ns):
        for h in range(t["hold_ptr"][g1], t["hold_ptr"][g1 + 1]):
            p, k1 = t["hold_shard"][h], t["hold_loc"][h]
            rhs_red[3 * g1:3 * g1 + 3] += rhs_part[p, 3 * k1:3 * k1 + 3]
            for g2 in range(ns):
                k2 = t["loc_of"][p, g2]
                if k2 >= 0:
                    s_red[3 * g1:3 * g1 + 3, 3 * g2:3 * g2 + 3] += \
                        s_part[p, 3 * k1:3 * k1 + 3, 3 * k2:3 * k2 + 3]
    live = np.repeat(plan.schur.sep_mask.astype(float), 3)
    damp = lam * np.maximum(np.abs(np.diagonal(h_ss)), 1e-8) + (1.0 - live)
    return h_ss - s_red + np.diag(damp), b_s - rhs_red


@pytest.mark.parametrize("values", ["integers", "floats"])
def test_routing_tables_reproduce_the_segment_sums(values):
    """A numpy model of K9a's and K9b's fixed-order sums over the plan's
    tables, held to the plain versions: with small-integer inputs every sum
    is exact, so the routing must match entry for entry; with float inputs
    within rtol 1e-12."""
    gj, gt = _graphs(160, seed=5)
    plan = tsn.plan_supernodal(gt, 6)
    rng = np.random.default_rng(7)
    f, q = gt.bet_i.shape[0], gt.prior_idx.shape[0]
    draw = ((lambda *s: rng.integers(-3, 4, s).astype(np.float64))
            if values == "integers" else (lambda *s: rng.normal(size=s)))
    lin = [draw(f, 3, 3), draw(f, 3, 3), draw(f, 3), draw(q, 3, 3),
           draw(q, 3)]
    ref = tsn.supernodal_assemble_ref(plan, *map(torch.as_tensor, lin))
    model = _model_k9a(plan, *lin)
    nsl3 = 3 * plan.ns_loc
    s_part, rhs_part = draw(6, nsl3, nsl3), draw(6, nsl3)
    h_ss, b_s = model[2], model[4]
    ref_b = tsn.schur_reduce_ref(plan, torch.as_tensor(s_part),
                                 torch.as_tensor(rhs_part),
                                 torch.as_tensor(h_ss), torch.as_tensor(b_s),
                                 0.5)
    model_b = _model_k9b(plan, s_part, rhs_part, h_ss, b_s, 0.5)
    for a, b in zip([*model, *model_b], [*ref, *ref_b]):
        b = b.numpy()
        assert a.shape == b.shape
        if values == "integers":
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-12,
                                       atol=1e-12 * np.abs(b).max())


@pytest.mark.parametrize("n,shards,lam,use_rcm", [(240, 8, 1e-3, False),
                                                  (240, 8, 1e-3, True),
                                                  (120, 4, 1e-2, False),
                                                  (60, 1, 1e-3, False)])
def test_supernodal_delta_matches_jax_and_dense(n, shards, lam, use_rcm):
    """As test_supernodal.py:21-40; with RCM the deltas only (the JAX
    package may order by its g++ RCM, whose order can differ). One shard
    has no separator: its one padded separator slot is dead."""
    gj, gt = _graphs(n)
    pj = jsn.plan_supernodal(gj, shards, use_rcm=use_rcm)
    pt = tsn.plan_supernodal(gt, shards, use_rcm=use_rcm)
    linj, lint = _lins(gj, gt)
    got = tsn.supernodal_delta(gt, lint, pt, lam)
    ref = np.asarray(jsn.supernodal_delta(gj, linj, pj,
                                          jnp.asarray(lam, jnp.float64)))
    dense = tslv.solve_dense(gt, lint, torch.tensor(lam, dtype=torch.float64))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(got.numpy(), dense.numpy(), rtol=1e-6,
                               atol=1e-9)


def test_port_rcm_shrinks_separator():
    """As test_supernodal.py:51-66, with the port's (scipy) RCM."""
    data = tg2o.manhattan_world(300, seed=9, loop_prob=0.1)
    g = tg2o.to_graph(data, dtype=torch.float64)
    perm = torch.as_tensor(np.random.default_rng(1).permutation(
        g.poses.shape[0]))
    g2 = g._replace(poses=g.poses[torch.argsort(perm)], bet_i=perm[g.bet_i],
                    bet_j=perm[g.bet_j], prior_idx=perm[g.prior_idx])
    p_nat = tsn.plan_supernodal(g2, 8, use_rcm=False)
    p_rcm = tsn.plan_supernodal(g2, 8, use_rcm=True)
    assert p_rcm.schur.ns < p_nat.schur.ns, (p_rcm.schur.ns, p_nat.schur.ns)
    assert sorted(p_rcm.perm.tolist()) == list(range(300))


def test_full_width_step_matches_jax(bench10k):
    """One step at config 4's full width (10k poses, P = 64)."""
    gj, gt, pj, pt = bench10k
    linj, lint = _lins(gj, gt)
    got = tsn.supernodal_delta(gt, lint, pt, 1e-3)
    ref = np.asarray(jsn.supernodal_delta(gj, linj, pj,
                                          jnp.asarray(1e-3, jnp.float64)))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-9)


#: The last LM iteration of the loop tests' graph whose accept test is
#: decided above roundoff: its step lowers chi^2 by 1.4e-11 relative; the
#: next moves it by 2.6e-16 (two ulps), up in the JAX package and down in
#: the port.
SCHEDULE = 7


@pytest.fixture(scope="module")
def lm_runs():
    """Both packages' ``optimize_supernodal`` on a graph with 9 loop
    closures (the optimum's chi^2 is 27.46, not 0), run to their own stop
    and capped at ``SCHEDULE`` iterations: ``{(package, cap): result}``."""
    gj, gt = _graphs(200, seed=4, loop_prob=0.3)
    pj, pt = jsn.plan_supernodal(gj, 8), tsn.plan_supernodal(gt, 8)
    out = {}
    for cap in (30, SCHEDULE):
        out["jax", cap] = jsn.optimize_supernodal(
            gj, JSolverConfig(max_iter=cap), plan=pj)
        out["port", cap] = tsn.optimize_supernodal(
            gt, SolverConfig(max_iter=cap), plan=pt)
    return out


def test_optimize_supernodal_schedule_matches_jax(lm_runs):
    """Both loops capped at ``SCHEDULE`` iterations: neither stops early,
    and chi^2 agrees within rtol 1e-12 and the poses within 1e-9. A step
    accepted or rejected differently, or another lambda, anywhere in the
    schedule would move chi^2 by at least the last accepted step's 1.4e-11
    relative."""
    got, ref = lm_runs["port", SCHEDULE], lm_runs["jax", SCHEDULE]
    assert int(got.n_iter) == int(ref.n_iter) == SCHEDULE
    assert not bool(got.converged) and not bool(ref.converged)
    np.testing.assert_allclose(float(got.chi2), float(ref.chi2), rtol=1e-12)
    np.testing.assert_allclose(got.graph.poses.numpy(),
                               np.asarray(ref.graph.poses), rtol=0,
                               atol=1e-9)


def test_optimize_supernodal_matches_jax(lm_runs):
    """Both loops run to their own stop: converged alike, chi^2 within
    rtol 1e-9, poses within the stop test's 1e-6. The iteration counts
    agree through the schedule (the test above) and end within one of each
    other, and every iteration past the schedule moves chi^2 only at
    roundoff (within rtol 1e-13 of the capped run's) in both: there the
    accept test ``chi_t < chi`` compares chi^2 values equal to their last
    bits, so the summation order decides it. The JAX package's own count
    moves with the partition alone on this graph: 8 iterations at 4 and 16
    shards, 9 at 8."""
    got, ref = lm_runs["port", 30], lm_runs["jax", 30]
    n_t, n_j = int(got.n_iter), int(ref.n_iter)
    assert min(n_t, n_j) > SCHEDULE and abs(n_t - n_j) <= 1
    assert bool(got.converged) and bool(ref.converged)
    np.testing.assert_allclose(float(got.chi2), float(ref.chi2), rtol=1e-9)
    for pkg in ("port", "jax"):
        np.testing.assert_allclose(float(lm_runs[pkg, 30].chi2),
                                   float(lm_runs[pkg, SCHEDULE].chi2),
                                   rtol=1e-13, err_msg=pkg)
    np.testing.assert_allclose(got.graph.poses.numpy(),
                               np.asarray(ref.graph.poses), rtol=0,
                               atol=1e-6)


def _chain_pair(n=20, noise=0.05, seed=0):
    """test_incremental.py's noisy chain with a prior, in both packages,
    after the JAX package's dense optimization."""
    from ndtpu.lie import se2

    rng = np.random.default_rng(seed)
    gt = np.zeros((n, 3))
    for k in range(1, n):
        gt[k] = gt[k - 1] + [1.0, 0.0, 2 * np.pi / n]
        gt[k, 2] = (gt[k, 2] + np.pi) % (2 * np.pi) - np.pi
    sq = jnp.asarray(np.diag([10.0, 10.0, 20.0]))
    g = jfct.empty_graph(n, 2, 2 * n, jnp.float64)
    noisy = gt + rng.normal(0, noise, gt.shape)
    noisy[0] = gt[0]
    g = g._replace(poses=jnp.asarray(noisy), pose_mask=jnp.ones((n,), bool),
                   n_poses=jnp.asarray(n, jnp.int32))
    g = jfct.add_prior(g, 0, jnp.asarray(gt[0]), sq)
    for k in range(1, n):
        g = jfct.add_between(g, k - 1, k, se2.between(jnp.asarray(gt[k - 1]),
                                                      jnp.asarray(gt[k])), sq)
    g = jslv.optimize(g, JSolverConfig(max_iter=30), method="dense").graph
    return g, convert.from_numpy(g)


@pytest.mark.parametrize("route", ["dense", "pcg"])
def test_marginals_match_jax(route):
    """As test_incremental.py:131-150: the port's marginal covariances
    against the JAX package's (and the PCG ones against the dense)."""
    gj, gt = _chain_pair()
    for idx in (0, 7, 19):
        if route == "dense":
            got = tinc.marginal_covariance(gt, idx).numpy()
            ref = np.asarray(jinc.marginal_covariance(gj, idx))
            np.testing.assert_allclose(got, ref, rtol=1e-9, atol=1e-14)
        else:
            got = tinc.marginal_covariance_pcg(
                gt, idx, SolverConfig(pcg_max_iter=400, pcg_tol=1e-10))
            ref = np.asarray(jinc.marginal_covariance_pcg(
                gj, idx, JSolverConfig(pcg_max_iter=400, pcg_tol=1e-10)))
            np.testing.assert_allclose(got.numpy(), ref, rtol=1e-7,
                                       atol=1e-12)
            dense = tinc.marginal_covariance(gt, idx).numpy()
            np.testing.assert_allclose(got.numpy(), dense, rtol=1e-3,
                                       atol=1e-8)
    c0 = tinc.marginal_covariance(gt, 0)
    c19 = tinc.marginal_covariance(gt, 19)
    assert float(torch.trace(c19)) > float(torch.trace(c0))


def make_reference(path=REF4):
    """The JAX package's final chi^2 and iterations on ``solve_g2o
    --manhattan 10000 --shards 64``'s graph, f32 (as the CLI runs) and
    f64."""
    jax.config.update("jax_enable_x64", True)
    out = dict(command="PYTHONPATH=. python tests/test_torch_supernodal.py",
               graph="ndtpu.data.g2o.manhattan_world(10000, seed=0, "
                     "loop_prob=0.1), poses + N(0, 0.05) from "
                     "default_rng(0), prior on pose 0",
               solver="ndtpu.graph.supernodal.optimize_supernodal, "
                      "n_shards=64, SolverConfig(max_iter=50, "
                      "pcg_max_iter=500)")
    data = jg2o.manhattan_world(10000, seed=0, loop_prob=0.1)
    data = data._replace(poses=data.poses + np.random.default_rng(0).normal(
        0, 0.05, data.poses.shape))
    cfg = JSolverConfig(max_iter=50, pcg_max_iter=500)
    for name, dt in (("jax_f32", jnp.float32), ("jax_f64", jnp.float64)):
        g = jg2o.to_graph(data, dtype=dt)
        res = jsn.optimize_supernodal(g, cfg, n_shards=64)
        out[name] = dict(chi2_initial=float(jfct.chi2(g)),
                         chi2_final=float(res.chi2),
                         n_iter=int(res.n_iter),
                         converged=bool(res.converged))
        print(name, out[name])
    path.write_text(json.dumps(out, indent=1) + "\n")


if __name__ == "__main__":
    make_reference(Path(sys.argv[1]) if len(sys.argv) > 1 else REF4)
