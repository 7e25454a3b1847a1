"""K9b schur_reduce's host-built held columns and the plain model of its
sum order, on the CPU.

- ``graph.supernodal.touch_table`` (``Routes.host["touch_ptr"]`` /
  ``["touch_col"]``, added by ``plan_supernodal``): for every separator row of config 4's plan (10k
  poses, P = 64), of another seeded 10k plan and of config 4's cut plan
  (600 poses, P = 8, the card tests' "small" case), the ascending union of
  the local separator sets of the shards that hold the row, and the row
  itself: the entries K9b sums; every other entry is a copy of ``h_ss``.
- ``graph.supernodal.schur_reduce_model`` (holders in shard order, ``acc``
  from +0, the kernel's op order; on the card K9b equals it bit for bit)
  against ``schur_reduce_ref`` (the reference's segment sums, held against
  the JAX package in ``tests/test_torch_supernodal.py``) in f64 and in
  f32.
"""

import numpy as np
import pytest
import torch

import chip_smoke as cs
from ndtpu_torch.graph import supernodal as tsn

torch.set_num_threads(2)

#: (poses, shards, seed) of the plans: config 4's (solve_g2o --manhattan
#: 10000 --shards 64), another seeded 10k graph, config 4's cut case.
PLANS = {"config4": (10000, 64, 0), "10k seed 3": (10000, 64, 3),
         "config4 cut": (600, 8, 0)}


@pytest.fixture(scope="module", params=list(PLANS))
def plan(request):
    n, shards, seed = PLANS[request.param]
    g = cs.config4_graph("cpu", torch.float64, seed, n)
    return tsn.plan_supernodal(g, shards)


def test_touch_table_is_the_holders_union(plan):
    t = plan.routes.host
    ns = plan.schur.ns
    held = [set(g[m].tolist()) for g, m in zip(plan.ls_global,
                                                plan.ls_mask)]
    ptr, col = t["touch_ptr"], t["touch_col"]
    assert ptr.dtype == col.dtype == np.int32
    assert ptr.shape == (ns + 1,) and ptr[0] == 0 and ptr[-1] == col.size
    for g1 in range(ns):
        got = col[ptr[g1]:ptr[g1 + 1]].tolist()
        want = {g1}
        for h in range(t["hold_ptr"][g1], t["hold_ptr"][g1 + 1]):
            want |= held[t["hold_shard"][h]]
        assert got == sorted(want), g1
    # At 10k poses most of s_tot is a copy of h_ss: the held columns are a
    # few percent of the 558 x 558 blocks.
    if ns > 500:
        assert col.size < 0.1 * ns * ns


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_schur_reduce_model_matches_plain(plan, dtype):
    rng = np.random.default_rng(19)
    p_dim, nsl3 = plan.schur.fac_idx.shape[0], 3 * plan.ns_loc
    ns3 = 3 * plan.schur.ns
    args = [torch.as_tensor(rng.normal(size=s), dtype=dtype)
            for s in ((p_dim, nsl3, nsl3), (p_dim, nsl3), (ns3, ns3),
                      (ns3,))]
    model = tsn.schur_reduce_model(plan, *args, 1e-3)
    ref = tsn.schur_reduce_ref(plan, *args, 1e-3)
    rtol = 1e-12 if dtype == torch.float64 else 1e-5
    for a, b in zip(model, ref):
        assert a.dtype == dtype and a.shape == b.shape
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=rtol * float(b.abs().max()))
    # Outside the held columns the model is h_ss's bits, as K9b copies it.
    t = plan.routes.host
    held = np.zeros((plan.schur.ns, plan.schur.ns), bool)
    for g1 in range(plan.schur.ns):
        held[g1, t["touch_col"][t["touch_ptr"][g1]:t["touch_ptr"][g1 + 1]]] = 1
    copy = torch.as_tensor(np.kron(~held, np.ones((3, 3), bool)))
    assert torch.equal(model[0][copy], args[2][copy])
