"""``pcg_rhs_blocked`` of ndtpu_torch against ndtpu (f64, CPU): S
independent PCGs in lockstep on the stacked sessions' flat graph, with
per-session Krylov scalars (ROADMAP C-w4) and exactly ``pcg_max_iter``
iterations. The kernel (K6b) is held to the plain version on the card by
``tests/test_torch_kernels.py`` and ``chip_smoke.py``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndtpu.config import SolverConfig as JSolverConfig
from ndtpu.dist import slam_dp as jdp
from ndtpu.graph import factors as jfct
from ndtpu.graph import solve as jslv
from ndtpu.lie import se2 as jse2
from ndtpu_torch import convert
from ndtpu_torch.config import SolverConfig
from ndtpu_torch.dist import slam_dp as tdp
from ndtpu_torch.graph import factors as tfct
from ndtpu_torch.graph import solve as tslv

CAP = 16
#: Poses and odometry noise (m, rad) per session; session 2 starts far off
#: (the large-residual session of C-w4).
SESSIONS = ((12, 0.05), (7, 0.05), (15, 0.6))
LAM8 = (1e-4, 1e-3, 1e-2)


def _lam8():
    return torch.tensor(LAM8, dtype=torch.float64)


def chain_graph(rng, n: int, noise: float, cap: int = CAP):
    """A noisy pose chain with a prior, as the JAX package's test_serve
    builds it, noise from numpy."""
    g = jfct.empty_graph(cap, 2, 2 * cap, jnp.float64)
    pose = jnp.zeros(3, jnp.float64)
    g = jfct.add_pose(g, pose)
    g = jfct.add_prior(g, 0, pose, jnp.eye(3, dtype=jnp.float64) * 10)
    step = jnp.asarray([1.0, 0.0, 0.1], jnp.float64)
    for i in range(1, n):
        pose = jse2.compose(pose, step + noise * rng.normal(size=3))
        g = jfct.add_pose(g, pose)
        g = jfct.add_between(g, i - 1, i, step,
                             jnp.eye(3, dtype=jnp.float64) * 5)
    return g


def stack(graphs):
    return jax.tree_util.tree_map(lambda *a: jnp.stack(a), *graphs)


@pytest.fixture(scope="module")
def graphs():
    rng = np.random.default_rng(21)
    return [chain_graph(rng, n, noise) for n, noise in SESSIONS]


def _cfgs(max_iter: int = 6):
    j = JSolverConfig(pcg_max_iter=max_iter)
    return j, SolverConfig(**dataclasses.asdict(j))


def _jax_blocked(graph_list, lam8, cfg):
    flat = jdp._flat_graph(stack(graph_list))
    lin = jfct.linearize(flat)
    lam_v = jnp.repeat(jnp.asarray(lam8, jnp.float64),
                       flat.poses.shape[0] // len(graph_list))[:, None]
    x, it = jslv.pcg_rhs_blocked(flat, lin, -jslv.gradient(flat, lin), lam_v,
                                 cfg, len(graph_list))
    return np.asarray(x), int(it)


def _port_flat(graph_list):
    return tdp._flat_graph(convert.from_numpy(stack(graph_list)))


@pytest.mark.parametrize("max_iter", [1, 6, 40])
def test_pcg_rhs_blocked_matches_jax(graphs, max_iter):
    jcfg, tcfg = _cfgs(max_iter)
    xj, itj = _jax_blocked(graphs, LAM8, jcfg)
    flat = _port_flat(graphs)
    lin = tfct.linearize(flat)
    lam_v = torch.tensor(LAM8, dtype=torch.float64).repeat_interleave(
        CAP)[:, None]
    x, it = tslv.pcg_rhs_blocked(flat, lin, -tslv.gradient(flat, lin), lam_v,
                                 tcfg, len(graphs))
    assert int(it) == itj == max_iter
    np.testing.assert_allclose(x.numpy(), xj, rtol=1e-10,
                               atol=1e-10 * np.abs(xj).max())
    # rhs None (-gradient) and a per-session lam give the same x.
    x2 = tslv.pcg_solve_blocked(flat, lin, None, _lam8(), 3,
                                max_iter)
    np.testing.assert_allclose(x2.numpy(), x.numpy(), rtol=0, atol=1e-14)


@pytest.mark.parametrize("session", range(len(SESSIONS)))
def test_each_session_equals_its_own_solve(graphs, session):
    """Per-session scalars make the lockstep iteration exactly S
    independent PCGs: a session's x equals its graph solved alone with the
    same fixed iteration count."""
    _, tcfg = _cfgs(6)
    flat = _port_flat(graphs)
    x = tslv.pcg_solve_blocked(flat, tfct.linearize(flat), None,
                               _lam8(), 3, 6)
    alone = convert.from_numpy(graphs[session])
    xs = tslv.pcg_solve_blocked(alone, tfct.linearize(alone), None,
                                _lam8()[session:session + 1], 1, 6)
    np.testing.assert_allclose(x[session * CAP:(session + 1) * CAP].numpy(),
                               xs.numpy(), rtol=0, atol=1e-10)


def test_global_scalars_would_differ(graphs):
    """The fault the blocked form avoids (C-w4): with global alpha and beta
    over the joint system (``pcg_rhs`` at the same fixed count) the small
    sessions' steps differ from their own solves."""
    flat = _port_flat(graphs)
    lin = tfct.linearize(flat)
    lam_v = torch.tensor(LAM8, dtype=torch.float64).repeat_interleave(
        CAP)[:, None]
    xg, _, _ = tslv.pcg_solve_ref(flat, lin, None, lam_v, 6, 0.0)
    xb = tslv.pcg_solve_blocked(flat, lin, None, _lam8(), 3, 6)
    assert float((xg[:CAP] - xb[:CAP]).abs().max()) > 1e-6


def test_zero_rhs_session_stays_at_zero(graphs):
    """A session whose right-hand side is 0 from the start (only its prior,
    at the prior's value; and one with no live pose at all) takes guarded
    steps: alpha = beta = 0, x stays 0, no NaN; the others are
    unchanged."""
    prior_only = chain_graph(np.random.default_rng(0), 1, 0.0)
    empty = jfct.empty_graph(CAP, 2, 2 * CAP, jnp.float64)
    for idle in (prior_only, empty):
        glist = [graphs[0], idle, graphs[2]]
        flat = _port_flat(glist)
        x = tslv.pcg_solve_blocked(flat, tfct.linearize(flat), None,
                                   _lam8(), 3, 6)
        assert bool(torch.isfinite(x).all())
        assert float(x[CAP:2 * CAP].abs().max()) == 0.0
        xj, _ = _jax_blocked(glist, LAM8, _cfgs(6)[0])
        np.testing.assert_allclose(x.numpy(), xj, rtol=1e-10, atol=1e-12)


def test_kernel_refuses_cpu_tensors(graphs):
    from ndtpu_torch import kernels

    flat = _port_flat(graphs)
    flat = tfct.PoseGraph(*(t.float() if t.is_floating_point() else t
                            for t in flat))
    lin = tfct.linearize(flat)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.pcg_solve_blocked(flat.bet_i, flat.bet_j, flat.bet_mask,
                                  flat.prior_idx, flat.prior_mask,
                                  flat.pose_mask, lin, None,
                                  torch.tensor(LAM8, dtype=torch.float32), 3,
                                  6)
