"""The smoother's kernel-shaped plain versions (K5 factor_linearize, K6
pcg_solve, K7a local_select, K7b assemble_local) against the JAX package
in f64, at the real capacities of configs 2 and 3 (1,024 poses, 2,048
between slots, 4 priors; local_poses 256, local_factors 1,024) on a graph
of 300 live poses with loop factors; and the whole incremental update
through both the local take and the overflow-to-global take."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndtpu.config import SolverConfig
from ndtpu.dist import schur as jschur
from ndtpu.graph import factors as jfct
from ndtpu.graph import incremental as jinc
from ndtpu.graph import solve as jslv
from ndtpu_torch import convert
from ndtpu_torch.dist import schur as tschur
from ndtpu_torch.graph import factors as tfct
from ndtpu_torch.graph import incremental as tinc
from ndtpu_torch.graph import solve as tslv

torch.set_num_threads(2)

V, F, P = 1024, 2048, 4      # pipeline.py: capacity, 2 x capacity, 4
N = 300                      # live poses
LOOPS = [(12, 70), (40, 118), (150, 212), (181, 259)]
#: The configs' solver (configs/config{2,3}_*.json) with the defaults the
#: port keeps (local_poses 256, local_factors 1,024, 2 hops, 32 fresh).
CFG = SolverConfig(max_iter=20, tol=1e-6, init_lambda=1e-4, lambda_up=10.0,
                   lambda_down=3.0, pcg_max_iter=100, pcg_tol=1e-5,
                   relin_threshold=0.05, inc_iters=2, full_solve_every=50)
HUBER = 5.0


def _close(a, b, tol=1e-10):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_allclose(a, b, rtol=0,
                               atol=tol * max(1.0, float(np.abs(b).max())))


def _wrap(t):
    return t - 2 * np.pi * np.floor((t + np.pi) / (2 * np.pi))


def _between(a, b):
    c, s = np.cos(a[2]), np.sin(a[2])
    d = b[:2] - a[:2]
    return np.array([c * d[0] + s * d[1], -s * d[0] + c * d[1],
                     _wrap(b[2] - a[2])])


def _graph(extra=(), seed=0):
    """A JAX-package graph at full capacity: ``N`` poses along two laps of
    a loop with drift, odometry factors, ``LOOPS`` and then ``extra``
    (the newest factors), one prior; some odometry sqrt-infos weak, one
    loop factor an outlier (Huber)."""
    rng = np.random.default_rng(seed)
    k = np.arange(N)
    gt = np.stack([12 * np.cos(k * 0.045), 8 * np.sin(k * 0.045),
                   _wrap(k * 0.045 + np.pi / 2)], -1)
    init = gt + np.cumsum(rng.normal(0, [0.02, 0.02, 0.004], gt.shape), 0)
    poses = np.zeros((V, 3))
    poses[:N] = init
    pairs = [(i, i + 1) for i in range(N - 1)] + LOOPS + list(extra)
    bi, bj = np.zeros(F, np.int32), np.zeros(F, np.int32)
    bz, sqi = np.zeros((F, 3)), np.zeros((F, 3, 3))
    for n, (i, j) in enumerate(pairs):
        bi[n], bj[n] = i, j
        bz[n] = _between(gt[i], gt[j]) + rng.normal(0, [0.02, 0.02, 0.005])
        a = rng.normal(0, 0.3, (3, 3))
        sqi[n] = np.triu(np.diag([10.0, 10.0, 25.0]) + a)
    bz[N + 1] += [1.5, -1.0, 0.2]          # an outlier loop
    bm = np.zeros(F, bool)
    bm[:len(pairs)] = True
    pm = np.zeros(P, bool)
    pm[0] = True
    psqi = np.zeros((P, 3, 3))
    psqi[0] = np.eye(3) * 100.0
    pz = np.zeros((P, 3))
    pz[0] = gt[0]
    pose_mask = np.zeros(V, bool)
    pose_mask[:N] = True
    g = jfct.PoseGraph(
        poses=jnp.asarray(poses), pose_mask=jnp.asarray(pose_mask),
        prior_idx=jnp.zeros(P, jnp.int32), prior_z=jnp.asarray(pz),
        prior_sqrt_info=jnp.asarray(psqi), prior_mask=jnp.asarray(pm),
        bet_i=jnp.asarray(bi), bet_j=jnp.asarray(bj), bet_z=jnp.asarray(bz),
        bet_sqrt_info=jnp.asarray(sqi), bet_mask=jnp.asarray(bm),
        n_poses=jnp.asarray(N, jnp.int32), n_priors=jnp.asarray(1, jnp.int32),
        n_between=jnp.asarray(len(pairs), jnp.int32))
    return g, convert.from_numpy(g), len(pairs)


#: name: (newest factors, fresh_since offset from n_between, take)
TAKES = {
    "local": ([(287, 299)], -3, 2),
    "local_loop_cycle": ([(232, 285)], -2, 2),
    "overflow_global": ([(6, 296)], -2, 1),
}


@pytest.fixture(scope="module")
def graphs():
    return {name: _graph(extra) for name, (extra, _, _) in TAKES.items()}


def _graph_args(gt):
    return (gt.poses, gt.bet_i, gt.bet_j, gt.bet_z, gt.bet_sqrt_info,
            gt.bet_mask, gt.prior_idx, gt.prior_z, gt.prior_sqrt_info,
            gt.prior_mask)


@pytest.mark.parametrize("huber", [0.0, HUBER])
def test_factor_linearize_full_and_chi2(graphs, huber):
    gj, gt, _ = graphs["local"]
    (ai, aj, r), (ap, rp) = jfct.linearize(gj, huber)
    out = tfct.factor_linearize_ref(*_graph_args(gt), huber)
    for x, y in zip([*out[0], *out[1]], [ai, aj, r, ap, rp]):
        _close(x.numpy(), y)
    _close(tfct.factor_linearize(*_graph_args(gt), huber,
                                 chi_only=True).numpy(), jfct.chi2(gj, huber))


def test_factor_linearize_gathered(graphs):
    """Gathered rows (the local path's ``fid`` with its own mask ``f_sel``,
    priors masked by ``p_act``) equal JAX's linearize of the graph whose
    factor arrays are gathered the same way."""
    gj, gt, nb = graphs["local"]
    rng = np.random.default_rng(3)
    fid = rng.permutation(F)[:1024]
    fid[:200] = np.arange(nb - 200, nb)
    f_sel = rng.random(1024) < 0.8
    p_act = np.array([True, False, True, False])
    gg = gj._replace(bet_i=gj.bet_i[fid], bet_j=gj.bet_j[fid],
                     bet_z=gj.bet_z[fid], bet_sqrt_info=gj.bet_sqrt_info[fid],
                     bet_mask=jnp.asarray(f_sel),
                     prior_mask=jnp.asarray(p_act))
    (ai, aj, r), (ap, rp) = jfct.linearize(gg, HUBER)
    args = (gt.poses, gt.bet_i, gt.bet_j, gt.bet_z, gt.bet_sqrt_info,
            torch.as_tensor(f_sel), gt.prior_idx, gt.prior_z,
            gt.prior_sqrt_info, torch.as_tensor(p_act), HUBER)
    fid_t = torch.as_tensor(fid, dtype=torch.long)
    out = tfct.factor_linearize_ref(*args, fid=fid_t)
    for x, y in zip([*out[0], *out[1]], [ai, aj, r, ap, rp]):
        _close(x.numpy(), y)
    _close(tfct.factor_linearize(*args, fid=fid_t, chi_only=True).numpy(),
           jfct.chi2(gg, HUBER))


@pytest.mark.parametrize("k", [1, 32, 64, F])
def test_fresh_residual_max_window(graphs, k):
    gj, gt, _ = graphs["local_loop_cycle"]
    _close(tinc.fresh_residual_max(gt, k).numpy(),
           jinc.fresh_residual_max(gj, k))


@pytest.mark.parametrize("lam", [1e-4, 1e2])
def test_pcg_solve_matches_pcg_rhs(graphs, lam):
    gj, gt, _ = graphs["local"]
    lj, lt = jfct.linearize(gj, HUBER), tfct.linearize(gt, HUBER)
    lam_t = torch.tensor(lam, dtype=torch.float64)
    xj, it_j = jslv.pcg(gj, lj, jnp.asarray(lam), CFG)
    xt, it_t, _ = tslv.pcg_solve(gt, lt, None, lam_t, CFG.pcg_max_iter,
                                 CFG.pcg_tol)
    assert int(it_t) == int(it_j) >= 2
    _close(xt.numpy(), xj, 1e-9)
    rhs = np.random.default_rng(4).normal(size=(V, 3))
    xj, it_j = jslv.pcg_rhs(gj, lj, jnp.asarray(rhs), jnp.asarray(lam), CFG)
    xt, it_t, _ = tslv.pcg_solve(gt, lt, torch.as_tensor(rhs), lam_t,
                                 CFG.pcg_max_iter, CFG.pcg_tol)
    assert int(it_t) == int(it_j)
    _close(xt.numpy(), xj, 1e-9)


def test_pcg_solve_zero_iterations_is_the_settled_step(graphs):
    """With lam 0, damping 1e-8 and no iteration, K6's max |M^-1 rhs| is
    the settled check's preconditioned gradient (JAX incremental.py:
    399-414), and x stays 0."""
    gj, gt, _ = graphs["local"]
    lj = jfct.linearize(gj, HUBER)
    live = gj.pose_mask.astype(jnp.float64)
    d = jslv.block_diag_hessian(gj, lj) + (1e-8 + (1.0 - live))[:, None,
                                                                None] \
        * jnp.eye(3)
    step = jnp.einsum("vab,vb->va", jslv._inv3(d), jslv.gradient(gj, lj))
    x, it, zmax = tslv.pcg_solve(gt, tfct.linearize(gt, HUBER), None, 0.0, 0,
                                 CFG.pcg_tol, damp_abs=1e-8)
    assert int(it) == 0 and not bool(x.any())
    _close(zmax.numpy(), jnp.max(jnp.abs(step)))


#: fresh_since: none (the newest 32 slots count as fresh), the take's own,
#: or further back than the fresh window holds (the overflow term).
SINCE = {"none": None, "take": None, "overflowed": -40}


@pytest.mark.parametrize("take", list(TAKES))
@pytest.mark.parametrize("since", list(SINCE))
def test_local_select_matches_probe_and_top_k(graphs, take, since):
    gj, gt, nb = graphs[take]
    off = TAKES[take][1] if since == "take" else SINCE[since]
    s = None if off is None else nb + off
    sj = None if s is None else jnp.asarray(s, jnp.int32)
    st = None if s is None else torch.tensor(s)
    act, touch, ok = jinc._active_probe(gj, CFG, sj)
    ref = jinc._local_select(gj, CFG, sj, (act, touch, ok))
    sel = tinc.local_select(gt, CFG, st)
    act_t, touch_t, ok_t = tinc._active_probe_ref(gt, CFG, st)
    exact = lambda a, b: np.testing.assert_array_equal(
        np.asarray(a), np.asarray(b))
    exact(act_t, act)
    exact(touch_t, touch)
    exact(ok_t, ok)
    exact(sel["ok"], ok)
    for key in ("pid", "in_set", "fid", "f_sel", "ri", "rj", "rp", "p_act"):
        exact(sel[key], ref[key])
    exact(sel["li"], ref["loc_of"][ref["bi"]])
    exact(sel["lj"], ref["loc_of"][ref["bj"]])
    exact(sel["lp"], ref["loc_of"][gj.prior_idx])
    assert sel["p_loc"] == ref["p_loc"] == 256
    if since == "take":
        assert bool(ok) == (TAKES[take][2] == 2)
    if since == "overflowed":
        assert not bool(ok)


def test_assemble_local_matches_parts(graphs):
    """h_ii and b_i alone (K7b's plain version) equal the JAX package's
    assemble_local_parts at one separator, on a real local selection."""
    gj, gt, nb = graphs["local_loop_cycle"]
    sel = tinc.local_select(gt, CFG, torch.tensor(nb - 2))
    assert bool(sel["ok"]) and int(sel["in_set"].sum()) > 40
    (ai, aj, r), (ap, rp) = tinc._local_lin(gt, gt.poses, sel, HUBER)
    h, b = tschur.assemble_local(sel["p_loc"], ai, aj, r, ap, rp,
                                 sel["f_sel"], sel["ri"], sel["li"],
                                 sel["rj"], sel["lj"], sel["p_act"],
                                 sel["rp"], sel["lp"])
    j = lambda t: jnp.asarray(t.numpy())
    h_ii, _, _, b_i, _ = jschur.assemble_local_parts(
        sel["p_loc"], 1, j(ai), j(aj), j(r), j(ap), j(rp), j(sel["f_sel"]),
        j(sel["ri"]), j(sel["li"]), j(sel["rj"]), j(sel["lj"]),
        j(sel["p_act"]), j(sel["rp"]), j(sel["lp"]), jnp.float64)
    assert h.shape == (768, 768)
    _close(h.numpy(), h_ii)
    _close(b.numpy(), b_i)


@pytest.mark.parametrize("take", list(TAKES))
def test_incremental_update_at_capacity(graphs, take):
    """The whole update at the real capacities: the local take (also with
    a loop factor's cycle seeded) and the overflow-to-global take."""
    gj, _, nb = graphs[take]
    _, since, code = TAKES[take]
    sj = jinc.SmootherState(graph=gj, lam=jnp.asarray(1e-4),
                            last_max_delta=jnp.asarray(np.inf),
                            step=jnp.asarray(0, jnp.int32))
    st = convert.from_numpy(sj)
    oj, kj = jinc.incremental_update(sj, CFG, huber_delta=HUBER,
                                     fresh_since=jnp.asarray(nb + since,
                                                             jnp.int32),
                                     return_take=True)
    ot, kt = tinc.incremental_update(st, CFG, huber_delta=HUBER,
                                     fresh_since=torch.tensor(nb + since),
                                     return_take=True)
    assert int(kt) == int(kj) == code
    moved = np.abs(np.asarray(oj.graph.poses) - np.asarray(gj.poses)).max()
    assert moved > 1e-4
    _close(ot.graph.poses.numpy(), oj.graph.poses, 1e-8)
    _close(ot.lam.numpy(), oj.lam, 1e-12)
    _close(ot.last_max_delta.numpy(), oj.last_max_delta, 1e-8)


def test_indefinite_local_system_rejects_the_step(graphs):
    """A damping that makes the local system indefinite (negative lam):
    JAX's cholesky gives NaN, the port's cholesky_ex is made to; in both
    packages the step is rejected, the poses stay and lam is multiplied by
    lambda_up on each iteration."""
    gj, gt, nb = graphs["local"]
    cfg = dataclasses.replace(CFG, inc_iters=2)
    sj = jnp.asarray(nb - 3, jnp.int32)
    gj2, lam_j, md_j = jinc.local_update(gj, jnp.asarray(-1.0), cfg, HUBER,
                                         since=sj)
    gt2, lam_t, md_t = tinc.local_update(gt, torch.tensor(-1.0,
                                                          dtype=torch.float64),
                                         cfg, HUBER,
                                         since=torch.tensor(nb - 3))
    np.testing.assert_array_equal(np.asarray(gj2.poses), np.asarray(gj.poses))
    np.testing.assert_array_equal(gt2.poses.numpy(), gt.poses.numpy())
    assert float(lam_j) == float(lam_t) == -1.0 * cfg.lambda_up ** 2
    assert float(md_j) == float(md_t) == 0.0
