"""The CUDA kernels (K1 ndt_terms shared and grouped, K3 halfcell_add, K4
finalize_pack, K8a local_tables, K8b loop_gate) against their plain twins,
on the card.

Every test here needs a CUDA card and skips without one (the kernels have
no CPU mode; their twins are covered by test_torch_grid / test_torch_match).
On a machine with a card (``tests/conftest.py`` imports JAX, which such a
machine may lack): ``python -m pytest --noconftest
tests/test_torch_kernels.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from ndtpu.config import GridConfig, LoopConfig, NDTMapConfig
from ndtpu_torch import kernels
from ndtpu_torch.loop import closure
from ndtpu_torch.ndt import grid as tgrid
from ndtpu_torch.ndt import match as tmatch
from ndtpu_torch.ndt.match import MatchResult

torch.set_num_threads(2)

pytestmark = pytest.mark.cuda

GRID = GridConfig(x0=-12.0, y0=-12.0, cell=0.5, nx=48, ny=48, overlap=4)
NDT = NDTMapConfig()


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _points(seed, n, dev):
    """Clustered points snapped to 2^-16 m (f32 and f64 bin them alike)."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-11, 11, (60, 2))
    p = centers[rng.integers(0, 60, n)] + rng.normal(0, 0.4, (n, 2))
    p = np.round(p * 65536.0) / 65536.0
    mask = rng.random(n) > 0.05
    return (torch.as_tensor(p, dtype=torch.float32, device=dev),
            torch.as_tensor(mask, device=dev))


def _stats(dev, seed=0, n=40000):
    pts, mask = _points(seed, n, dev)
    return tgrid.halfcell_add_ref(tgrid.empty_stats(GRID, torch.float32, dev),
                                  pts, mask, 1.0, GRID)


@pytest.mark.parametrize("weights", ["ones", "signed"])
def test_halfcell_add_matches_f64_twin(dev, weights):
    base = _stats(dev, 1)
    pts, mask = _points(2, 50000, dev)
    w = 1.0 if weights == "ones" else torch.as_tensor(
        np.where(np.arange(50000) % 2 == 0, -1.0, 1.0), dtype=torch.float32,
        device=dev)
    kernels.reset_launches()
    out = tgrid.halfcell_add(base, pts, mask, w, GRID)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["halfcell_add"] == 2     # scatter + pool
    w64 = w if isinstance(w, float) else w.cpu().double()
    ref = tgrid.halfcell_add_ref(
        tgrid.NDTStats(*(t.cpu().double() for t in base)), pts.cpu().double(),
        mask.cpu(), w64, GRID)
    if weights == "ones":
        assert torch.equal(out.n.cpu().double(), ref.n)
    for o, r in zip(out, ref):
        scale = r.abs().max().item()
        torch.testing.assert_close(o.cpu().double(), r, rtol=0,
                                   atol=1e-5 * scale)


def test_finalize_pack_matches_twin(dev):
    st = _stats(dev)
    out = tgrid.finalize_pack(st, NDT, GRID)
    ref = tgrid.finalize_pack_ref(st, NDT, GRID)
    torch.cuda.synchronize()
    valid = [8 * g + 5 for g in range(4)]
    assert torch.equal(out[:, valid], ref[:, valid])
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)


def test_ndt_terms_matches_twin(dev):
    st = _stats(dev)
    table = tgrid.finalize_pack(st, NDT, GRID)
    rng = np.random.default_rng(3)
    b, n = 64, 360
    poses = torch.as_tensor(rng.normal(0, [2, 2, 1], (b, 3)),
                            dtype=torch.float32, device=dev)
    pts = torch.as_tensor(rng.normal(0, 6, (b, n, 2)), dtype=torch.float32,
                          device=dev)
    mask = torch.as_tensor(rng.random((b, n)) > 0.1, dtype=torch.float32,
                           device=dev)
    args = (poses, pts[..., 0].contiguous(), pts[..., 1].contiguous(), mask,
            table, GRID, 0.5, 40.0)
    out = tmatch.ndt_terms(*args)
    ref = tmatch.ndt_terms_ref(*args)
    torch.cuda.synchronize()
    assert bool(((out - ref).abs() <= 1e-3 * ref.abs().clamp(min=1)).all())


def test_kernels_refuse_f64(dev):
    st = tgrid.NDTStats(*(t.double() for t in _stats(dev)))
    with pytest.raises(TypeError, match="float32"):
        tgrid.finalize_pack(st, NDT, GRID)


def test_ndt_terms_grouped_matches_twin(dev):
    """Lane b reads table group[b] of a stack; the same sums as the twin,
    and as the shared-table kernel on that one table."""
    stack = torch.stack([tgrid.finalize_pack(_stats(dev, seed), NDT, GRID)
                         for seed in range(5)])
    rng = np.random.default_rng(4)
    b, n = 64, 360
    group = torch.as_tensor(rng.integers(0, 5, b), dtype=torch.int32,
                            device=dev)
    poses = torch.as_tensor(rng.normal(0, [2, 2, 1], (b, 3)),
                            dtype=torch.float32, device=dev)
    pts = torch.as_tensor(rng.normal(0, 6, (b, n, 2)), dtype=torch.float32,
                          device=dev)
    mask = torch.as_tensor(rng.random((b, n)) > 0.1, dtype=torch.float32,
                           device=dev)
    args = (poses, pts[..., 0].contiguous(), pts[..., 1].contiguous(), mask,
            stack, GRID, 0.5, 40.0)
    kernels.reset_launches()
    out = tmatch.ndt_terms(*args, group=group)
    assert kernels.LAUNCHES["ndt_terms_grouped"] == 1
    ref = tmatch.ndt_terms_ref(*args, group=group)
    torch.cuda.synchronize()
    assert bool(((out - ref).abs() <= 1e-3 * ref.abs().clamp(min=1)).all())
    for g in range(5):
        lanes = (group == g).nonzero().squeeze(-1)
        one = tmatch.ndt_terms(poses[lanes].contiguous(),
                               args[1][lanes].contiguous(),
                               args[2][lanes].contiguous(),
                               mask[lanes].contiguous(), stack[g], GRID, 0.5,
                               40.0)
        assert torch.equal(one, out[lanes])


@pytest.mark.parametrize("half", [8.0, 12.0, 15.0],
                         ids=["33x33", "49x49_57KB", "61x61_89KB"])
def test_local_tables_matches_twin(dev, half):
    """K8a against its f32 twin on the card, at lattices below and above
    the 48 KB default shared memory (config 3's 49 x 49 needs 57,624 B).
    Points on a 2^-4 m grid keep every moment sum exact in f32, so both
    sides finalize the same statistics; only the ``ok`` slots change."""
    loop = dataclasses.replace(LoopConfig(), local_half_extent=half)
    w, n = 12, 360
    rng = np.random.default_rng(5)
    ang = np.linspace(-np.pi, np.pi, n, endpoint=False)
    rad = rng.uniform(0.5, half * 1.3, (w, 1)) * (1 + 0.3 * np.sin(3 * ang))
    pts = np.stack([rad * np.cos(ang), rad * np.sin(ang)], -1)
    pts = torch.as_tensor(np.round(pts * 16) / 16, dtype=torch.float32,
                          device=dev)
    mask = torch.as_tensor(rng.random((w, n)) > 0.05, device=dev)
    slot = torch.as_tensor(rng.permutation(20)[:w], device=dev)
    ok = torch.as_tensor(rng.random(w) > 0.3, device=dev)
    shape = (20,) + closure.local_table_shape(loop, False)
    base = torch.randn(shape, device=dev)
    kernels.reset_launches()
    out = closure.write_local_tables(base.clone(), slot, ok, pts, mask, loop,
                                     NDT)
    assert kernels.LAUNCHES["local_tables"] == 1
    ref = closure.write_local_tables_ref(base.clone(), slot, ok, pts, mask,
                                         loop, NDT)
    torch.cuda.synchronize()
    valid = [8 * g + 5 for g in range(4)]
    assert torch.equal(out[..., valid], ref[..., valid])
    assert float(ref[slot[ok]][..., valid].sum()) > 0
    col_max = ref.abs().reshape(-1, 32).amax(0)
    tol = 1e-5 * torch.maximum(ref.abs(), 1e-3 * col_max)
    assert bool(((out - ref).abs() <= tol).all())
    untouched = torch.ones(20, dtype=torch.bool, device=dev)
    untouched[slot[ok]] = False
    assert torch.equal(out[untouched], base[untouched])


def test_loop_gate_matches_f64_twin(dev):
    """K8b against _gate_and_pack in f64: score ties under the top-K
    budget, fewer than K accepted, innovation rejections and an accepted
    indefinite Hessian (its information floored, finite)."""
    rng = np.random.default_rng(6)
    k, c = 3, 16
    a = rng.normal(size=(k, c, 3, 3))
    hess = np.einsum("kcij,kclj->kcil", a, a) + 50.0 * np.eye(3)
    hess[2, 1] = [[40.0, 0.0, 3.0], [0.0, -5.0, 0.0], [3.0, 0.0, 2.0]]
    score = rng.uniform(0.35, 0.8, (k, c))
    score[0, [1, 2, 5]] = 0.875                    # exact ties in f32
    score[0, 0] = 0.9375
    score[1] = 0.1
    score[1, 3] = 0.6
    score[2, 1] = 0.99
    conv = rng.random((k, c)) > 0.1
    conv[0, [0, 1, 2, 5]] = conv[1, 3] = conv[2, :2] = True
    mask = np.ones((k, c), bool)
    init = rng.normal(0, 1.0, (k, c, 3))
    pose = init + rng.normal(0, 0.05, (k, c, 3))
    pose[2, 0, :2] += [3.0, 0.0]
    idx = rng.integers(0, 20, (k, c))
    qidx = np.array([40, 40, 45])
    loop = dataclasses.replace(LoopConfig(), max_candidates=c)
    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32)
    res = MatchResult(pose=f32(pose), hessian=f32(hess), score=f32(score),
                      n_iter=torch.zeros((k, c), dtype=torch.int32),
                      converged=torch.as_tensor(conv))
    cands = closure.LoopCandidates(idx=torch.as_tensor(idx),
                                   mask=torch.as_tensor(mask),
                                   dist=torch.zeros((k, c)))
    on = lambda t: t.to(dev)
    kernels.reset_launches()
    out = closure.gate_and_pack(MatchResult(*map(on, res)),
                                closure.LoopCandidates(*map(on, cands)), loop,
                                on(f32(init)), on(torch.as_tensor(qidx)))
    assert kernels.LAUNCHES["loop_gate"] == 1
    ref = closure._gate_and_pack(
        MatchResult(*(t.double() if t.is_floating_point() else t
                      for t in res)), cands, loop, f32(init).double(),
        torch.as_tensor(qidx))
    torch.cuda.synchronize()
    assert torch.equal(out.accept.cpu(), ref.accept)
    assert torch.equal(out.innov_rej.cpu(), ref.innov_rej)
    assert int(ref.accept[0].sum()) == 4 and int(ref.accept[1].sum()) == 1
    assert bool(ref.innov_rej[2, 0]) and bool(ref.accept[2, 1])
    err = (out.sqrt_info.cpu().double() - ref.sqrt_info).abs()
    lane_max = ref.sqrt_info.abs().amax((-2, -1), keepdim=True)
    assert bool((err <= 1e-4 * lane_max).all())
