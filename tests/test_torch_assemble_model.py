"""The plain models of K9a's and K9c's sum order, on the CPU.

``graph.supernodal.supernodal_assemble_model`` (K9a) and
``dist.schur.schur_local_assemble_model`` (K9c, with the interior damping)
run the kernels' arithmetic op for op: each target entry summed over its
pairs in ``tgt_ptr`` order from +0 as ``mtm3`` writes it, ``b`` as
``mtv3``, zeros elsewhere (on the card the kernels equal them bit for bit:
``tests/test_torch_kernels.py``). Here they are held against

- the port's plain versions (``supernodal_assemble_ref``,
  ``schur_local_assemble_ref``: the reference's segment sums), in f64
  within 1e-12 and in f32 within 1e-5 of each output's largest entry (the
  two sum a target's pairs in other orders);
- the JAX package's ``_assemble_parts`` and ``assemble_local_parts`` plus
  the interior damping of ``_schur_delta_local`` (jitted), in f64 within
  1e-12 of each output's largest entry, on ``manhattan_world`` graphs of
  60-600 poses at P = 3-8.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndtpu.dist import schur as jschur
from ndtpu.graph import supernodal as jsn
from ndtpu_torch.data import g2o as tg2o
from ndtpu_torch.dist import schur as tschur
from ndtpu_torch.graph import factors as tfct
from ndtpu_torch.graph import supernodal as tsn

torch.set_num_threads(2)

#: (poses, shards, seed): K9a's plans, 60-600 poses at P = 3-8 (their
#: (ni, nsl, ns) odd and even).
K9A_CASES = [(60, 8, 1), (200, 3, 1), (240, 4, 2), (600, 5, 3)]
#: (poses, ranks, seed): K9c's splits (60 and 150 over 3 ranks have dead
#: interior slots).
K9C_CASES = [(60, 3, 1), (150, 3, 1), (600, 2, 2)]
LAM = 1e-3


def _graph(n, seed, dtype=torch.float64):
    """A jittered Manhattan graph (``manhattan_world`` draws the JAX
    package's arrays; ``tests/test_torch_g2o.py``)."""
    g = tg2o.to_graph(tg2o.manhattan_world(n, seed=seed, loop_prob=0.2),
                      dtype)
    noise = np.random.default_rng(seed).normal(0, 0.03, tuple(g.poses.shape))
    return g._replace(poses=g.poses + torch.as_tensor(noise, dtype=dtype))


def _jax_plan(plan):
    """The JAX package's plan with the port's arrays (array for array the
    JAX planner's: ``tests/test_torch_supernodal.py``)."""
    return jsn.SupernodalPlan(
        schur=jschur.SchurPlan(**plan.schur._asdict()),
        **{k: getattr(plan, k) for k in jsn.SupernodalPlan._fields[1:]})


def _jnp(xs):
    return tuple(jnp.asarray(x.numpy()) for x in xs)


def _close(got, want, rtol):
    for a, b in zip(got, want):
        b = torch.as_tensor(np.asarray(b))
        assert a.shape == b.shape and a.dtype == b.dtype
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=rtol * float(b.abs().max()))


@pytest.mark.parametrize("n,shards,seed", K9A_CASES)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_supernodal_assemble_model_matches_plain(n, shards, seed, dtype):
    gt = _graph(n, seed, dtype)
    plan = tsn.plan_supernodal(gt, shards)
    (ai, aj, r), (ap, rp) = tfct.linearize(gt)
    model = tsn.supernodal_assemble_model(plan, ai, aj, r, ap, rp)
    ref = tsn.supernodal_assemble_ref(plan, ai, aj, r, ap, rp)
    _close(model, ref, 1e-12 if dtype == torch.float64 else 1e-5)


@pytest.mark.parametrize("n,shards,seed", K9A_CASES)
def test_supernodal_assemble_model_matches_jax(n, shards, seed):
    """On the same K5 rows (the port's f64 linearization)."""
    gt = _graph(n, seed)
    plan = tsn.plan_supernodal(gt, shards)
    (ai, aj, r), (ap, rp) = tfct.linearize(gt)
    pj = _jax_plan(plan)
    want = jax.jit(lambda *x: jsn._assemble_parts(pj, *x, jnp.float64))(
        *_jnp((ai, aj, r, ap, rp)))
    _close(tsn.supernodal_assemble_model(plan, ai, aj, r, ap, rp), want,
           1e-12)


def _rank_inputs(gt, n, ranks):
    plan = tschur.plan_partition(
        gt.bet_i.numpy(), gt.bet_j.numpy(), gt.bet_mask.numpy(),
        gt.prior_idx.numpy(), gt.prior_mask.numpy(), n, ranks)
    for rank in range(ranks):
        loc = tuple(x[0] for x in tschur.shard_factor_data_local(gt, plan,
                                                                 rank))
        yield plan, rank, loc, tschur._linearize_shard(gt.poses, *loc)


@pytest.mark.parametrize("n,ranks,seed", K9C_CASES)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_schur_local_assemble_model_matches_plain(n, ranks, seed, dtype):
    gt = _graph(n, seed, dtype)
    dead = 0
    for plan, rank, loc, lin in _rank_inputs(gt, n, ranks):
        t = tschur.rank_tables(plan, rank, "cpu")
        model = tschur.schur_local_assemble_model(plan, rank, LAM, *lin)
        ref = tschur.schur_local_assemble_ref(t, LAM, *lin, loc[4], loc[8])
        _close(model, ref, 1e-12 if dtype == torch.float64 else 1e-5)
        for slot in np.nonzero(~plan.int_mask[rank])[0]:
            d = torch.diagonal(model[0])[3 * slot:3 * slot + 3]
            # 0 + (lam * max(0, 1e-8) + 1): 1 in f32, 1 + 1e-11 in f64
            assert torch.equal(d, torch.full((3,), LAM * 1e-8 + 1.0,
                                             dtype=dtype))
            dead += 1
    assert dead > 0 or n == 600


@pytest.mark.parametrize("n,ranks,seed", K9C_CASES)
def test_schur_local_assemble_model_matches_jax(n, ranks, seed):
    """Against ``assemble_local_parts`` of the same rows and the damping
    ``_schur_delta_local`` applies after it (ndtpu/dist/schur.py:386-400)."""
    gt = _graph(n, seed)

    @jax.jit
    def parts(lin, masks, roles, int_mask):
        h_ii, h_is, h_ss, b_i, b_s = jschur.assemble_local_parts(
            ni, ns, *lin, masks[0], *roles[:4], masks[1], *roles[4:],
            jnp.float64)
        live_i = jnp.repeat(int_mask.astype(jnp.float64), 3)
        damp_i = LAM * jnp.maximum(jnp.abs(jnp.diagonal(h_ii)), 1e-8)
        return h_ii + jnp.diag(damp_i + (1.0 - live_i)), h_is, h_ss, b_i, b_s

    for plan, rank, loc, lin in _rank_inputs(gt, n, ranks):
        ni, ns = plan.ni, plan.ns
        roles = tuple(jnp.asarray(getattr(plan, k)[rank])
                      for k in ("i_role", "i_loc", "j_role", "j_loc",
                                "p_role", "p_loc"))
        want = parts(_jnp(lin), _jnp((loc[4], loc[8])), roles,
                     jnp.asarray(plan.int_mask[rank]))
        _close(tschur.schur_local_assemble_model(plan, rank, LAM, *lin),
               want, 1e-12)
