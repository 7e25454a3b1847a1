"""ndtpu_torch.ndt.grid against ndtpu.ndt.grid on the same f64 inputs, and
the CPU dispatch of the K3 / K4 wrappers."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndtpu.config import GridConfig, NDTMapConfig
from ndtpu.ndt import grid as jgrid
from ndtpu_torch import kernels
from ndtpu_torch.ndt import grid as tgrid

torch.set_num_threads(2)

G4 = GridConfig(x0=-8.0, y0=-6.0, cell=1.0, nx=16, ny=12, overlap=4)
G1 = GridConfig(x0=-8.0, y0=-6.0, cell=0.5, nx=32, ny=24, overlap=1)
NDT = NDTMapConfig()


def _t(a):
    return torch.as_tensor(np.array(a))


def _close(a, b, rtol=1e-12):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    scale = max(1.0, float(np.abs(b).max()))
    np.testing.assert_allclose(a, b, rtol=0, atol=rtol * scale)


def _points(seed, n=2000, grid=G4):
    """Clustered points (dense cells) plus edge / out-of-bounds points and
    points exactly on half-cell boundaries."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform([grid.x0, grid.y0],
                          [grid.x0 + grid.nx * grid.cell,
                           grid.y0 + grid.ny * grid.cell], (40, 2))
    pts = centers[rng.integers(0, 40, n)] + rng.normal(0, 0.3, (n, 2))
    pts[:20] = rng.uniform(-20, 20, (20, 2))
    pts[20:40, 0] = grid.x0 + 0.5 * grid.cell * rng.integers(0, 2 * grid.nx,
                                                             20)
    mask = rng.random(n) > 0.1
    return pts, mask


def _stats_pair(grid, seed=0):
    pts, mask = _points(seed, grid=grid)
    j = jgrid.build_stats(jnp.asarray(pts), jnp.asarray(mask), grid)
    t = tgrid.build_stats(_t(pts), _t(mask), grid)
    return j, t


def test_cell_ids():
    pts, _ = _points(1)
    ids_j, inb_j = jgrid.cell_ids(jnp.asarray(pts), G4)
    ids_t, inb_t = tgrid.cell_ids(_t(pts), G4)
    np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids_j))
    np.testing.assert_array_equal(inb_t.numpy(), np.asarray(inb_j))


@pytest.mark.parametrize("grid", [G4, G1], ids=["overlap4", "overlap1"])
@pytest.mark.parametrize("weight", ["one", "minus_one", "per_point"])
def test_add_points(grid, weight):
    pts, mask = _points(2, grid=grid)
    base_j = jgrid.build_stats(jnp.asarray(pts[::3]), jnp.asarray(mask[::3]),
                               grid)
    base_t = tgrid.NDTStats(*(_t(a) for a in base_j))
    w = {"one": 1.0, "minus_one": -1.0,
         "per_point": np.where(np.arange(len(pts)) % 3 == 0, -1.0, 1.0)}[weight]
    wj = jnp.asarray(w) if isinstance(w, np.ndarray) else w
    wt = _t(w) if isinstance(w, np.ndarray) else w
    j = jgrid.add_points(base_j, jnp.asarray(pts), jnp.asarray(mask), grid, wj)
    t = tgrid.add_points(base_t, _t(pts), _t(mask), grid, wt)
    for a, b in zip(t, j):
        _close(a.numpy(), b)


def test_halfcell_counts_exact():
    j, t = _stats_pair(G4)
    np.testing.assert_array_equal(t.n.numpy(), np.asarray(j.n))


@pytest.mark.parametrize("grid", [G4, G1], ids=["overlap4", "overlap1"])
def test_finalize(grid):
    j, t = _stats_pair(grid, seed=3)
    mj, mt = jgrid.finalize(j, NDT), tgrid.finalize(t, NDT)
    for a, b in zip(mt, mj):
        _close(a.numpy(), b)


def test_eig2x2_sym_edge_cases():
    a = np.array([1.0, 2.0, 1.0, 0.0, 3.0, 1e-8, 5.0])
    b = np.array([0.0, 0.0, 1e-21, 0.0, 0.5, 1e-9, -2.0])
    c = np.array([2.0, 1.0, 1.0, 0.0, 3.0, 1e-8, 1.0])
    jt = jgrid._eig2x2_sym(*(jnp.asarray(x) for x in (a, b, c)))
    tt = tgrid._eig2x2_sym(*(_t(x) for x in (a, b, c)))
    for x, y in zip(tt, jt):
        _close(x.numpy(), y)


@pytest.mark.parametrize("grid", [G4, G1], ids=["overlap4", "overlap1"])
@pytest.mark.parametrize("compact", [False, True])
def test_pack_quad(grid, compact):
    j, t = _stats_pair(grid, seed=4)
    if compact:
        # From the same f32 Gaussians the bf16-pair table is bit-exact.
        mj = jgrid.NDTMap(*(x.astype(jnp.float32)
                            for x in jgrid.finalize(j, NDT)))
        mt = tgrid.NDTMap(*(x.float() for x in tgrid.finalize(t, NDT)))
        qj = np.asarray(jgrid.pack_quad(mj, grid, compact=True))
        qt = tgrid.pack_quad(mt, grid, compact=True).numpy()
        assert qt.dtype == np.float32 and qt.shape == qj.shape
        np.testing.assert_array_equal(qt.view(np.uint32), qj.view(np.uint32))
        return
    qj = jgrid.pack_quad(jgrid.finalize(j, NDT), grid)
    qt = tgrid.pack_quad(tgrid.finalize(t, NDT), grid)
    _close(qt.numpy(), qj)


def test_bf16_pair_bit_exact():
    rng = np.random.default_rng(5)
    a = rng.normal(0, 30, 4096).astype(np.float32)
    b = rng.normal(0, 1e-3, 4096).astype(np.float32)
    b[:4] = [0.0, 1.0, -0.0, 3.0e38]
    pj = np.asarray(jgrid._pack_bf16_pair(jnp.asarray(a), jnp.asarray(b)))
    pt = tgrid._pack_bf16_pair(_t(a), _t(b)).numpy()
    np.testing.assert_array_equal(pt.view(np.uint32), pj.view(np.uint32))
    for x, y in zip(tgrid.unpack_bf16_pair(_t(pt)),
                    jgrid.unpack_bf16_pair(jnp.asarray(pj))):
        np.testing.assert_array_equal(x.numpy().view(np.uint32),
                                      np.asarray(y).view(np.uint32))


@pytest.mark.parametrize("grid", [G4, G1], ids=["overlap4", "overlap1"])
def test_lookup_quad(grid):
    j, t = _stats_pair(grid, seed=6)
    qj = jgrid.pack_quad(jgrid.finalize(j, NDT), grid)
    qt = tgrid.pack_quad(tgrid.finalize(t, NDT), grid)
    pts, _ = _points(7, 500, grid)
    rj, ij = jgrid.lookup_quad(qj, jnp.asarray(pts[:, 0]),
                               jnp.asarray(pts[:, 1]), grid)
    rt, it = tgrid.lookup_quad(qt, _t(pts[:, 0]), _t(pts[:, 1]), grid)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    _close(rt.numpy(), rj)


@pytest.mark.parametrize("grid", [G4, G1], ids=["overlap4", "overlap1"])
def test_lookup_quad_grouped_and_multi(grid):
    """Lane ``b`` gathers from table ``group[b]`` of a stack (grouped) or
    from its own table (multi), as in the JAX package."""
    tabs = []
    for seed in (11, 12, 13):
        j, _ = _stats_pair(grid, seed=seed)
        tabs.append(jgrid.pack_quad(jgrid.finalize(j, NDT), grid))
    stack = jnp.stack(tabs)                              # [S, R, L]
    s, r, l = stack.shape
    rng = np.random.default_rng(14)
    pts = np.stack([_points(15 + b, 200, grid)[0] for b in range(5)])
    x, y = pts[..., 0], pts[..., 1]
    group = rng.integers(0, s, 5)
    rj, ij = jgrid.lookup_quad_grouped(stack.reshape(s * r, l), r,
                                       jnp.asarray(group, jnp.int32),
                                       jnp.asarray(x), jnp.asarray(y), grid)
    rt, it = tgrid.lookup_quad_grouped(_t(stack).reshape(s * r, l), r,
                                       _t(group), _t(x), _t(y), grid)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    _close(rt.numpy(), rj)
    mj, mij = jgrid.lookup_quad_multi(stack[group], jnp.asarray(x),
                                      jnp.asarray(y), grid)
    mt, mit = tgrid.lookup_quad_multi(_t(stack[group]), _t(x), _t(y), grid)
    np.testing.assert_array_equal(mit.numpy(), np.asarray(mij))
    _close(mt.numpy(), mj)
    _close(mt.numpy(), rt.numpy())


@pytest.mark.parametrize("compact", [False, True])
def test_finalize_pack_ref_matches_jax(compact):
    j, t = _stats_pair(G4, seed=8)
    if compact:
        # The CPU wrapper builds the bf16-pair table as pack_quad does
        # (pack_quad's compact layout is held against JAX in test_pack_quad).
        t = tgrid.NDTStats(*(x.float() for x in t))
        qt = tgrid.finalize_pack(t, NDT, G4, compact=True)
        ref = tgrid.pack_quad(tgrid.finalize(t, NDT), G4, compact=True)
        assert qt.shape == (25 * 33, 16)
        np.testing.assert_array_equal(qt.numpy().view(np.uint32),
                                      ref.numpy().view(np.uint32))
        return
    _close(tgrid.finalize_pack_ref(t, NDT, G4).numpy(),
           jgrid.pack_quad(jgrid.finalize(j, NDT), G4))


def test_halfcell_add_ref_matches_jax_halfcell():
    pts, mask = _points(9)
    base = jgrid.empty_stats(G4, jnp.float64)
    j = jgrid._add_points_halfcell(base, jnp.asarray(pts), jnp.asarray(mask),
                                   G4, 1.0)
    t = tgrid.halfcell_add_ref(tgrid.empty_stats(G4, torch.float64),
                               _t(pts), _t(mask), 1.0, G4)
    for a, b in zip(t, j):
        _close(a.numpy(), b)


def test_wrappers_take_the_twin_on_cpu_and_kernels_refuse_cpu():
    """CPU tensors go to the twins (no kernel launch); the kernel entry
    points never fall back: they raise on a CPU tensor."""
    kernels.reset_launches()
    pts, mask = _points(10)
    st = tgrid.halfcell_add(tgrid.empty_stats(G4, torch.float32),
                            _t(pts).float(), _t(mask), 1.0, G4)
    tgrid.finalize_pack(st, NDT, G4)
    assert set(kernels.LAUNCHES) >= {"ndt_terms", "halfcell_add",
                                     "finalize_pack"}
    assert not any(kernels.LAUNCHES.values())
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.finalize_pack(st.n, st.s, st.ss, NDT, G4)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.halfcell_add(st.n, st.s, st.ss, _t(pts).float(), _t(mask),
                             1.0, G4)
    # Every table layout has a kernel now (overlap 1 too), the stacked
    # serving kernels included: each refuses the CPU tensor, not the layout.
    st1 = tgrid.empty_stats(G1, torch.float32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.finalize_pack(st1.n, st1.s, st1.ss, NDT, G1)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.finalize_pack_stacked(st1.n[None], st1.s[None],
                                      st1.ss[None], NDT, G1)


# -- K10b's input layouts (``kernels.finalize_inputs``, host code) ---------

def _records(lead, seed=0, offset=0):
    """Seeded 7-float records ``[*lead, 7]`` (``[n, sx, sy, sxx, sxy,
    syx, syy]``) starting ``offset`` floats into a fresh buffer, and the
    three views of them."""
    c = int(np.prod(lead))
    buf = torch.as_tensor(np.random.default_rng(seed).normal(
        size=7 * c + offset), dtype=torch.float32)
    rec = buf[offset:].view(tuple(lead) + (7,))
    return rec, (rec[..., 0], rec[..., 1:3], rec[..., 3:].view(
        tuple(lead) + (2, 2)))


def _k3_layout(lead):
    """K3's and K10a's outputs: ``ss``, then ``s``, then ``n`` in one
    allocation, each contiguous."""
    c = int(np.prod(lead))
    out = torch.arange(7 * c, dtype=torch.float32)
    return (out[6 * c:].view(lead), out[4 * c:6 * c].view(lead + (2,)),
            out[:4 * c].view(lead + (2, 2)))


_LAYOUTS = {
    # name: (stats, expected layout, which of n, s, ss are read in place)
    "slab_records": lambda: (_records((4, 8, 6))[1], "records",
                             (True,) * 3),
    "dense_records": lambda: (_records((4, 96))[1], "records", (True,) * 3),
    "one_cell_record": lambda: (_records((1,))[1], "records", (True,) * 3),
    "records_4k_plus_3": lambda: (_records((43,))[1], "records",
                                  (True,) * 3),
    "three_arrays": lambda: (tuple(x.contiguous() for x in _records(
        (4, 8, 6))[1]), "arrays", (True,) * 3),
    "k3_layout": lambda: (_k3_layout((4, 48)), "arrays", (True,) * 3),
    "k3_layout_odd_cells": lambda: (_k3_layout((1, 45)), "arrays",
                                    (True,) * 3),
    "records_at_any_offset": lambda: (_records((4, 8, 6), offset=7)[1],
                                      "records", (True,) * 3),
    "records_sliced_columns": lambda: (tuple(
        x[:, 2:6] for x in _records((4, 8, 6))[1]), "arrays", (False,) * 3),
    "records_of_another_order": lambda: ((lambda r: (
        r[..., 6], r[..., 4:6], r[..., :4].view(4, 8, 6, 2, 2)))(
            _records((4, 8, 6))[0]), "arrays", (False,) * 3),
    "mixed_storages": lambda: ((lambda v: (v[0].contiguous(), v[1], v[2]))(
        _records((4, 8, 6))[1]), "arrays", (True, False, False)),
    "transposed_arrays": lambda: (tuple(
        x.transpose(1, 2) for x in _k3_layout((4, 8, 6))), "arrays",
        (False,) * 3),
}


@pytest.mark.parametrize("name", list(_LAYOUTS))
def test_finalize_inputs_layout(name):
    """Which statistics K10b reads in place (the slab exchange's records,
    or three contiguous aligned arrays) and which the wrapper copies first
    (any other layout): the layout chosen, each tensor passed on or a
    contiguous copy of it, equal in value; and on the CPU the wrapper's
    plain version gives the same bits whichever layout holds the cells."""
    stats, layout, kept = _LAYOUTS[name]()
    got = kernels.finalize_inputs(*stats)
    assert got[0] == layout
    for a, b, same in zip(got[1:], stats, kept):
        assert (a.data_ptr() == b.data_ptr()) == same
        assert same or a.is_contiguous()
        assert torch.equal(a, b)
    if layout == "arrays":
        assert got[1].is_contiguous() and got[2].data_ptr() % 8 == 0
        assert got[3].is_contiguous() and got[3].data_ptr() % 16 == 0
    st = tgrid.NDTStats(n=stats[0].abs() * 10.0, s=stats[1], ss=stats[2])
    ref = tgrid.finalize(tgrid.NDTStats(*(x.contiguous() for x in st)), NDT)
    for a, b in zip(tgrid.finalize(st, NDT), ref):
        assert torch.equal(a, b)


def test_finalize_cells_threads_is_checked():
    """K10b's threads per block: the default is restored by 0, and counts
    the kernel cannot launch are refused before any build."""
    kernels.finalize_cells_threads(64)
    assert kernels._finalize_threads == 64
    kernels.finalize_cells_threads()
    assert kernels._finalize_threads == kernels.FINALIZE_THREADS == 256
    for bad in (16, 96, 100, 1024, -32):
        with pytest.raises(ValueError, match="threads a block"):
            kernels.finalize_cells_threads(bad)
    assert kernels._finalize_threads == kernels.FINALIZE_THREADS
