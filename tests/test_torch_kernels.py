"""The CUDA kernels (K1 ndt_terms, K3 halfcell_add, K4 finalize_pack)
against their plain twins, on the card.

Every test here needs a CUDA card and skips without one (the kernels have
no CPU mode; their twins are covered by test_torch_grid / test_torch_match).
On a machine with a card: ``python -m pytest tests/test_torch_kernels.py``.
"""

import numpy as np
import pytest
import torch

from ndtpu.config import GridConfig, NDTMapConfig
from ndtpu_torch import kernels
from ndtpu_torch.ndt import grid as tgrid
from ndtpu_torch.ndt import match as tmatch

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
