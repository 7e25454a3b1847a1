"""ndtpu_torch.ndt.grid.pack_map / lookup_packed against
ndtpu.ndt.grid's on the same f64 map: the table exactly, the look-up
within 1e-12 and equal to the port's own ``lookup``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndtpu.config import GridConfig as JGridConfig
from ndtpu.config import NDTMapConfig as JNDTMapConfig
from ndtpu.ndt import grid as jgrid
from ndtpu_torch import convert
from ndtpu_torch.config import GridConfig
from ndtpu_torch.ndt import grid as tgrid

torch.set_num_threads(2)

ATOL = 1e-12
GRIDS = {o: (GridConfig(x0=-8.0, y0=-8.0, cell=0.5, nx=32, ny=32,
                        overlap=o),
             JGridConfig(x0=-8.0, y0=-8.0, cell=0.5, nx=32, ny=32,
                         overlap=o)) for o in (4, 1)}


@pytest.fixture(scope="module", params=[4, 1], ids=["overlap4",
                                                    "overlap1"])
def case(request):
    """``(grid, JAX grid, JAX's f64 map, the same map in the port, query
    points)`` from a seed: clustered map points, and queries on the map,
    on cell edges and off it."""
    grid, jg = GRIDS[request.param]
    rng = np.random.default_rng(23)
    centers = rng.uniform(-7.5, 7.5, (30, 2))
    pts = centers[rng.integers(0, 30, 3000)] + rng.normal(0, 0.35, (3000, 2))
    mask = rng.random(3000) > 0.05
    jmap = jax.jit(lambda p, m: jgrid.finalize(
        jgrid.build_stats(p, m, jg), JNDTMapConfig()))(jnp.asarray(pts),
                                                       jnp.asarray(mask))
    q = rng.uniform(-9.0, 9.0, (500, 2))
    q[:40] = np.round(q[:40] * 4.0) / 4.0         # on half-cell edges
    assert int(np.asarray(jmap.valid).sum()) > 100
    return grid, jg, jmap, convert.from_numpy(jmap), q


def test_pack_map_matches_jax_exactly(case):
    _, _, jmap, tmap, _ = case
    got = tgrid.pack_map(tmap)
    ref = np.asarray(jax.jit(jgrid.pack_map)(jmap))
    assert got.shape == ref.shape == (ref.shape[0], 32 * 32, 8)
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy(), ref)
    assert not got[..., 6:].any()


def test_lookup_packed_matches_jax_and_lookup(case):
    grid, jg, jmap, tmap, q = case
    packed = tgrid.pack_map(tmap)
    got = tgrid.lookup_packed(packed, torch.as_tensor(q), grid)
    ref = jax.jit(lambda p, x: jgrid.lookup_packed(p, x, jg))(
        jgrid.pack_map(jmap), jnp.asarray(q))
    for a, b in zip(got, ref):
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=ATOL)
    own = tgrid.lookup(tmap, torch.as_tensor(q), grid)
    for a, b in zip(got, own):
        assert torch.equal(a, b)
    assert 50 < int((got[2] > 0).sum()) < got[2].numel()


def test_lookup_packed_f32(case):
    """In f32 the packed look-up is the f32 map's own ``lookup``."""
    grid, _, _, tmap, q = case
    m32 = tgrid.NDTMap(*(x.float() for x in tmap))
    q32 = torch.as_tensor(q, dtype=torch.float32)
    got = tgrid.lookup_packed(tgrid.pack_map(m32), q32, grid)
    for a, b in zip(got, tgrid.lookup(m32, q32, grid)):
        assert a.dtype == torch.float32 and torch.equal(a, b)
