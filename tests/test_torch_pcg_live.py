"""The invariant K6's compaction rests on (``csrc/pcg_solve.cu``: the set-up
keeps only the live factors, the live priors and the active poses), held
in the JAX package's ``pcg_rhs`` (jitted, x64) and in the port's
``pcg_solve_ref`` (f64) at config 3's capacities (1,024 pose, 2,048
factor and 4 prior slots):

- a pose with no live incidence and a zero right-hand side stays exactly
  0 in x (so the kernel may skip it and write 0);
- a dead pose with a non-zero right-hand side does not stay 0 (so the
  kernel must keep it, with its damping's dead term).

Two graphs: 97 live poses in the first slots, as the pipeline fills them,
and the same trajectory scattered through the slots, with live poses that
no factor touches and dead factor slots that point at live poses. Each
with ``rhs = -gradient`` (``pcg``) and with an explicit right-hand side
that is zero on the untouched poses and non-zero on some dead ones.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndtpu.config import SolverConfig
from ndtpu.graph import factors as jfct
from ndtpu.graph import solve as jslv
from ndtpu_torch import convert
from ndtpu_torch.graph import factors as tfct
from ndtpu_torch.graph import solve as tslv

torch.set_num_threads(2)

V, F, P = 1024, 2048, 4      # config 3: capacity, 2 x capacity, 4 priors
N = 97                       # live poses (chip_smoke's config-3 graph)
LOOPS = [(3, 60), (10, 88), (25, 95)]
CFG = SolverConfig(pcg_max_iter=100, pcg_tol=1e-5)
HUBER = 5.0
LAM = 1e-4


def _wrap(t):
    return t - 2 * np.pi * np.floor((t + np.pi) / (2 * np.pi))


def _between(a, b):
    c, s = np.cos(a[2]), np.sin(a[2])
    d = b[:2] - a[:2]
    return np.array([c * d[0] + s * d[1], -s * d[0] + c * d[1],
                     _wrap(b[2] - a[2])])


def _graph(kind: str, seed: int = 0):
    """``(JAX graph, port graph, untouched, dead)``: ``untouched`` the pose
    slots with no live incidence, ``dead`` the dead ones among them."""
    rng = np.random.default_rng(seed)
    k = np.arange(N)
    gt = np.stack([10 * np.cos(k * 0.07), 7 * np.sin(k * 0.07),
                   _wrap(k * 0.07 + np.pi / 2)], -1)
    init = gt + np.cumsum(rng.normal(0, [0.02, 0.02, 0.004], gt.shape), 0)
    if kind == "capacity":
        slot, fslot = np.arange(N), np.arange(F)
    else:
        slot, fslot = rng.permutation(V)[:N], rng.permutation(F)
    pose_mask = np.zeros(V, bool)
    pose_mask[slot] = True
    poses = np.zeros((V, 3))
    poses[slot] = init
    pairs = [(i, i + 1) for i in range(N - 1)] + LOOPS
    bi, bj = np.zeros(F, np.int32), np.zeros(F, np.int32)
    bz, sqi = np.zeros((F, 3)), np.zeros((F, 3, 3))
    bm = np.zeros(F, bool)
    for n, (i, j) in enumerate(pairs):
        m = fslot[n]
        bi[m], bj[m], bm[m] = slot[i], slot[j], True
        bz[m] = _between(gt[i], gt[j]) + rng.normal(0, [0.02, 0.02, 0.005])
        sqi[m] = np.triu(np.diag([10.0, 10.0, 25.0])
                         + rng.normal(0, 0.3, (3, 3)))
    if kind != "capacity":
        # Live poses no factor touches, and dead factor slots that point
        # at live poses (their rows are masked to 0).
        free = np.flatnonzero(~pose_mask)
        pose_mask[rng.choice(free, 40, replace=False)] = True
        dead_f = fslot[len(pairs):len(pairs) + 30]
        bi[dead_f] = rng.choice(slot, 30)
        bj[dead_f] = rng.choice(slot, 30)
        sqi[dead_f] = np.eye(3) * 5.0
    pm = np.zeros(P, bool)
    pm[0] = True
    psqi = np.zeros((P, 3, 3))
    psqi[0] = np.eye(3) * 100.0
    pz = np.zeros((P, 3))
    pz[0] = gt[0]
    pidx = np.full(P, slot[0], np.int32)
    g = jfct.PoseGraph(
        poses=jnp.asarray(poses), pose_mask=jnp.asarray(pose_mask),
        prior_idx=jnp.asarray(pidx), prior_z=jnp.asarray(pz),
        prior_sqrt_info=jnp.asarray(psqi), prior_mask=jnp.asarray(pm),
        bet_i=jnp.asarray(bi), bet_j=jnp.asarray(bj), bet_z=jnp.asarray(bz),
        bet_sqrt_info=jnp.asarray(sqi), bet_mask=jnp.asarray(bm),
        n_poses=jnp.asarray(N, jnp.int32), n_priors=jnp.asarray(1, jnp.int32),
        n_between=jnp.asarray(len(pairs), jnp.int32))
    touched = np.zeros(V, bool)
    touched[bi[bm]] = touched[bj[bm]] = True
    touched[pidx[pm]] = True
    untouched = np.flatnonzero(~touched)
    return g, convert.from_numpy(g), untouched, untouched[
        ~pose_mask[untouched]]


@pytest.fixture(scope="module")
def graphs():
    return {kind: _graph(kind) for kind in ("capacity", "dead_slots")}


@functools.lru_cache(maxsize=None)
def _jax_solve():
    return jax.jit(lambda g, lin, rhs, lam: jslv.pcg_rhs(g, lin, rhs, lam,
                                                         CFG))


def _rhs(untouched, dead, seed: int = 1):
    """Non-zero on every pose slot but the untouched ones; 8 of the dead
    ones get a non-zero entry back. Returns ``(rhs, dead_with_rhs)``."""
    rng = np.random.default_rng(seed)
    rhs = rng.normal(size=(V, 3))
    rhs[untouched] = 0.0
    back = rng.choice(dead, 8, replace=False)
    rhs[back] = rng.normal(size=(8, 3))
    return rhs, back


def _solve(package: str, gj, gt, rhs):
    """x of ``package``'s PCG (``rhs`` None: -gradient), and its
    iterations."""
    if package == "jax":
        lin = jfct.linearize(gj, HUBER)
        b = -jslv.gradient(gj, lin) if rhs is None else jnp.asarray(rhs)
        x, it = _jax_solve()(gj, lin, b, jnp.asarray(LAM))
        return np.asarray(x), int(it)
    lin = tfct.linearize(gt, HUBER)
    x, it, _ = tslv.pcg_solve_ref(
        gt, lin, None if rhs is None else torch.as_tensor(rhs),
        torch.tensor(LAM, dtype=torch.float64), CFG.pcg_max_iter, CFG.pcg_tol)
    return x.numpy(), int(it)


@pytest.mark.parametrize("package", ["jax", "port"])
@pytest.mark.parametrize("kind", ["capacity", "dead_slots"])
def test_untouched_poses_stay_zero_under_the_gradient(graphs, kind, package):
    """rhs = -gradient: every pose with no live incidence has a zero rhs
    and stays exactly 0; the poses the factors touch move."""
    gj, gt, untouched, _ = graphs[kind]
    x, it = _solve(package, gj, gt, None)
    assert it >= 2
    assert len(untouched) >= V - N
    assert not np.any(x[untouched])
    touched = np.setdiff1d(np.arange(V), untouched)
    assert np.all(np.any(x[touched] != 0.0, axis=-1))


@pytest.mark.parametrize("package", ["jax", "port"])
@pytest.mark.parametrize("kind", ["capacity", "dead_slots"])
def test_dead_poses_with_a_rhs_do_not_stay_zero(graphs, kind, package):
    """An explicit rhs, zero on the untouched poses but for 8 dead ones: the
    zero ones stay exactly 0, each of the 8 does not."""
    gj, gt, untouched, dead = graphs[kind]
    rhs, back = _rhs(untouched, dead)
    x, it = _solve(package, gj, gt, rhs)
    assert it >= 2
    zero = np.setdiff1d(untouched, back)
    assert not np.any(x[zero])
    assert np.all(np.any(x[back] != 0.0, axis=-1))


@pytest.mark.parametrize("kind", ["capacity", "dead_slots"])
def test_port_plain_pcg_equals_jax_here(graphs, kind):
    """On these graphs the port's plain PCG is the JAX package's: the same
    iterations, x within 1e-9 x max(1, max|x|), for both right-hand
    sides."""
    gj, gt, untouched, dead = graphs[kind]
    for rhs in (None, _rhs(untouched, dead)[0]):
        xj, itj = _solve("jax", gj, gt, rhs)
        xt, itt = _solve("port", gj, gt, rhs)
        assert itj == itt
        np.testing.assert_allclose(
            xt, xj, rtol=0, atol=1e-9 * max(1.0, float(np.abs(xj).max())))
