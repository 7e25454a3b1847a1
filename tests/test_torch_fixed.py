"""The plain model of the map build's fixed-point arithmetic
(``ndtpu_torch.ndt.grid.halfcell_add_fixed_ref``, which the CUDA kernels K3
and K8a equal bit for bit on the card) against the f64 twin and the JAX
package, on the config-2 and config-3 grids; and the properties the
fixed-point sums buy: the same result under any order of the points, and
exact cancellation of a -1 copy of a point against its +1 copy."""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndtpu.config import PipelineConfig
from ndtpu.ndt import grid as jgrid
from ndtpu_torch.ndt import grid as tgrid

torch.set_num_threads(2)

CONFIGS = Path(__file__).resolve().parents[1] / "configs"
GRIDS = {name: PipelineConfig.from_json(str(CONFIGS / f)).grid
         for name, f in (("config2", "config2_full_sequence.json"),
                         ("config3", "config3_loop_closure.json"))}


def _scene(grid, seed, n=4000):
    """Clustered points, thin walls (the cancellation-prone cells), points
    outside the lattice and points exactly on half-cell boundaries; a mask
    and +-1 weights."""
    rng = np.random.default_rng(seed)
    lo = np.array([grid.x0, grid.y0])
    span = np.array([grid.nx, grid.ny]) * grid.cell
    centers = lo + rng.uniform(0.05, 0.95, (60, 2)) * span
    pts = centers[rng.integers(0, 60, n)] + rng.normal(0, 0.3 * grid.cell,
                                                       (n, 2))
    t = rng.uniform(0, 1, 600)
    pts[:600, 0] = lo[0] + 0.3 * span[0] + 0.4 * span[0] * t
    pts[:600, 1] = lo[1] + 0.6 * span[1] + rng.normal(0, 1e-3, 600)
    pts[600:640] = rng.uniform(lo - 5.0, lo + span + 5.0, (40, 2))
    h = grid.cell / 2.0
    pts[640:700, 0] = grid.x0 + h * rng.integers(0, 2 * grid.nx + 1, 60)
    pts[700:760, 1] = grid.y0 + h * rng.integers(0, 2 * grid.ny + 1, 60)
    mask = rng.random(n) > 0.1
    sign = np.where(rng.random(n) < 0.3, -1.0, 1.0)
    return pts, mask, sign


def _base(grid, seed):
    pts, mask, _ = _scene(grid, seed, 2000)
    return tgrid.halfcell_add_ref(tgrid.empty_stats(grid, torch.float64),
                                  torch.as_tensor(pts), torch.as_tensor(mask),
                                  1.0, grid)


def _assert_within_magnitude(out, ref, base, pts, mask, w, grid, rel):
    """|out - ref| <= rel x (|base| + (sum of |w| in the cell) x R^k) for
    the k-th order moment, R the largest |coordinate| of the lattice."""
    n_abs = tgrid.halfcell_add_ref(
        tgrid.empty_stats(grid, torch.float64), pts, mask,
        torch.as_tensor(np.abs(w)), grid).n
    r = max(abs(grid.x0), abs(grid.y0), abs(grid.x0 + grid.nx * grid.cell),
            abs(grid.y0 + grid.ny * grid.cell))
    for k, (o, f, b) in enumerate(zip(out, ref, base)):
        f = torch.as_tensor(np.array(f))
        cnt = n_abs.reshape(n_abs.shape + (1,) * (f.dim() - 2))
        tol = rel * (b.abs() + cnt * r ** k)
        err = (o - f).abs()
        assert bool((err <= tol).all()), \
            f"moment order {k}: off by {float((err / tol).max()):.3g} x tol"


@pytest.mark.parametrize("name", sorted(GRIDS))
def test_fixed_ref_matches_f64_twin(name):
    grid = GRIDS[name]
    pts, mask, sign = _scene(grid, 1)
    base = _base(grid, 2)
    p, m, w = (torch.as_tensor(a) for a in (pts, mask, sign))
    out = tgrid.halfcell_add_fixed_ref(base, p, m, w, grid)
    assert all(t.dtype == torch.float64 for t in out)
    ref = tgrid.halfcell_add_ref(base, p, m, w, grid)
    assert torch.equal(out.n, ref.n)             # +-1 counts are exact
    _assert_within_magnitude(out, ref, base, p, m, sign, grid, 1e-9)


@pytest.mark.parametrize("name", sorted(GRIDS))
def test_fixed_ref_matches_jax_halfcell(name):
    grid = GRIDS[name]
    pts, mask, sign = _scene(grid, 3)
    base = _base(grid, 4)
    j = jgrid._add_points_halfcell(
        jgrid.NDTStats(*(jnp.asarray(t.numpy()) for t in base)),
        jnp.asarray(pts), jnp.asarray(mask), grid, jnp.asarray(sign))
    p, m, w = (torch.as_tensor(a) for a in (pts, mask, sign))
    out = tgrid.halfcell_add_fixed_ref(base, p, m, w, grid)
    np.testing.assert_array_equal(out.n.numpy(), np.asarray(j.n))
    _assert_within_magnitude(out, j, base, p, m, sign, grid, 1e-9)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_fixed_ref_is_bit_identical_under_permutation(dtype):
    grid = GRIDS["config2"]
    pts, mask, sign = _scene(grid, 5)
    base = tgrid.NDTStats(*(t.to(dtype) for t in _base(grid, 6)))
    perm = np.random.default_rng(7).permutation(len(pts))
    args = [(torch.as_tensor(pts[i], dtype=dtype), torch.as_tensor(mask[i]),
             torch.as_tensor(sign[i], dtype=dtype))
            for i in (np.arange(len(pts)), perm)]
    a, b = (tgrid.halfcell_add_fixed_ref(base, *x, grid) for x in args)
    for x, y in zip(a, b):
        assert x.dtype == dtype
        assert torch.equal(x.view(torch.uint8), y.view(torch.uint8))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_fixed_ref_plus_and_minus_copies_cancel_exactly(dtype):
    grid = GRIDS["config3"]
    pts, mask, _ = _scene(grid, 8)
    base = tgrid.NDTStats(*(t.to(dtype) for t in _base(grid, 9)))
    both = torch.as_tensor(np.concatenate([pts, pts[::-1]]), dtype=dtype)
    msk = torch.as_tensor(np.concatenate([mask, mask[::-1]]))
    w = torch.cat([torch.ones(len(pts)), -torch.ones(len(pts))]).to(dtype)
    out = tgrid.halfcell_add_fixed_ref(base, both, msk, w, grid)
    for x, y in zip(out, base):
        assert torch.equal(x.view(torch.uint8), y.view(torch.uint8))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_fixed_ref_keeps_the_twins_cells_on_boundaries_and_edges(dtype):
    """Points exactly on half-cell boundaries, on the lattice's first and
    last half-cells, just outside it and on its far edge: the same counts
    per cell as the twin, and nothing from outside the lattice."""
    grid = GRIDS["config3"]
    h = grid.cell / 2.0
    wh, hh = 2 * grid.nx + 1, 2 * grid.ny + 1
    x1, y1 = grid.x0 + wh * h, grid.y0 + hh * h      # far edges (outside)
    k = np.arange(0, 2 * grid.nx + 1, 7)
    xs = np.concatenate([grid.x0 + h * k, [grid.x0, x1 - 1e-3, x1,
                                            grid.x0 - 1e-3]])
    ys = np.concatenate([grid.y0 + h * k[::-1], [grid.y0, y1 - 1e-3, y1,
                                                 y1 - 1e-3]])
    pts = np.stack(np.meshgrid(xs, ys), -1).reshape(-1, 2)
    p = torch.as_tensor(pts, dtype=dtype)
    m = torch.ones(len(pts), dtype=torch.bool)
    empty = tgrid.empty_stats(grid, dtype)
    out = tgrid.halfcell_add_fixed_ref(empty, p, m, 1.0, grid)
    ref = tgrid.halfcell_add_ref(empty, p, m, 1.0, grid)
    assert torch.equal(out.n, ref.n)
    inside = ((xs >= grid.x0) & (xs < x1)).sum() * ((ys >= grid.y0)
                                                    & (ys < y1)).sum()
    # Every in-lattice point lands in exactly one cell of each grid whose
    # cells cover it; grid (0, 0) covers the lattice but its last row and
    # column of half-cells.
    assert float(out.n.sum()) <= 4 * inside
    assert float(out.n.sum()) > 0
    # f64: the fixed point's 2^-33 rounding of each term; f32: the sums.
    tol = 1e-6 if dtype == torch.float32 else 1e-9
    scale = max(abs(grid.x0), abs(x1)) ** 2 * float(ref.n.max())
    for o, r in zip(out, ref):
        assert float((o - r).abs().max()) <= tol * scale
