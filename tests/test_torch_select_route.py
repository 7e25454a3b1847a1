"""K7a's routes and shared-memory layout, and the card-only size limits of
other kernels' host-side checks, on the CPU.

- ``kernels.select_smem`` against the expression of
  ``csrc/local_system.cu``'s ``select_smem``, read from the source (as
  ``tests/test_torch_lm_spread.py`` reads ``lm_smem``'s), and
  ``kernels.select_route`` on both sides of its limits: the shared route
  up to 65,535 pose slots and 128 factors per thread of a 1,024-thread
  block (the graph staged whole where ``select_smem`` fits what one block
  can have, else its endpoints read from the graph), else a device
  scratch; every graph the first design kept in shared memory stays on
  the shared route, staged whole at F = V and F = 2V. No result depends
  on the route; the card tests hold each route bit-equal to the plain
  selection.
- The plain selection ``local_select_ref`` (the CPU route of
  ``graph.incremental.local_select``) against the JAX package's
  ``_active_probe`` + ``_local_select``, jitted in x64, on a graph past the
  shared route (70,000 pose and 140,000 factor slots): integers,
  bit-equal.
- K4's and K8a's host-side band checks (``kernels.finalize_bands``,
  ``kernels.local_bands``) refuse exactly past the lattice widths the
  README names.
- K7b's per-call scratch: ``kernels.assemble_scratch`` against
  ``csrc/local_system.cu``'s ``assemble_scratch``, read from the source;
  and its plain version ``assemble_local_ref`` against the JAX package's
  ``assemble_local_parts`` at 8,192 gathered slots, past the ~7,258 the
  first K7b held in shared memory.
"""

import functools
import re
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndtpu.config import SolverConfig as JSolverConfig
from ndtpu.dist import schur as jschur
from ndtpu.graph import factors as jfct
from ndtpu.graph import incremental as jinc
from ndtpu_torch import convert, kernels
from ndtpu_torch.config import GridConfig, SolverConfig
from ndtpu_torch.dist import schur as tschur
from ndtpu_torch.graph import incremental as tinc


def _c_select_smem():
    """``select_smem(v, f, staged)`` of ``csrc/local_system.cu``, as
    Python (its integer division as ``//``)."""
    src = (Path(kernels.__file__).parent / "csrc"
           / "local_system.cu").read_text()
    expr = re.search(r"inline size_t select_smem\(int v, int f, int staged\)"
                     r" \{\s*return (.*?);", src, re.S).group(1)
    expr = " ".join(expr.split()).replace("(size_t)", "").replace("/", "//")
    return lambda v, f, staged: eval(expr, {}, dict(v=v, f=f, staged=staged))


@pytest.mark.parametrize("v,f", [(1, 1), (1024, 2048), (10064, 10369),
                                 (20633, 41266), (25064, 26005)])
def test_select_smem_matches_the_kernels_layout(v, f):
    """3 B per pose slot (its local slot, its byte of mask and level), a
    bit per factor slot (its mask, in 4-byte words), the pair scan's and
    the interval's 40 slots of 8 B; staged, 4 B more per factor slot (its
    endpoints as a 16-bit pair)."""
    c_smem = _c_select_smem()
    for staged in (1, 0):
        assert kernels.select_smem(v, f, staged) == c_smem(v, f, staged)
    assert kernels.select_smem(v, f) == c_smem(v, f, 1)
    assert c_smem(0, 0, 1) == 320
    assert c_smem(v, f, 1) - c_smem(v, f, 0) == 4 * f
    assert c_smem(v, f, 0) == 320 + 3 * v + 4 * -(-f // 32)


@pytest.mark.parametrize("v,f,route,staged", [
    (1024, 2048, "shared", True),            # configs 2-3 capacity
    (10064, 10369, "shared", True),          # bench.py §5b's local graph
    (20633, 2 * 20633, "shared", True),      # the last staged at F = 2V
    (20634, 2 * 20634, "shared", False),
    (32578, 32578, "shared", True),          # the last staged at F = V
    (32579, 32579, "shared", False),
    (25064, 26005, "shared", True),          # the smoke's phase 8d graph
    (65535, 2 * 65535, "shared", False),     # the last pose count
    (65536, 2 * 65536, "scratch", None),
    (65535, 65535, "shared", False),
    (65536, 65536, "scratch", None),
    (1000, 128 * 1024, "shared", False),     # the last factor count
    (1000, 128 * 1024 + 1, "scratch", None),
    (100000, 200000, "scratch", None),
])
def test_select_route(v, f, route, staged):
    assert kernels.select_route(v, f) == route
    if route == "shared":
        assert (kernels.select_smem(v, f) <= kernels.SMEM_MAX) == staged
        assert kernels.select_smem(v, f, 0) <= kernels.SMEM_MAX
        assert -(-max(f, v) // 1024) <= kernels.SELECT_MAX_CHUNK


def _parent_select_smem(v, f):
    """The first design's shared route: 8 B per pose, 2 B per factor and
    40 ints, up to what one block can have."""
    return 4 * (2 * v + 40) + 2 * f


@pytest.mark.parametrize("ratio", [1, 2])
def test_select_route_keeps_every_graph_the_first_design_kept(ratio):
    """Every (V, F = ratio x V) that the first design held in shared memory
    is on the shared route, staged whole."""
    for v in range(1, 40000, 37):
        f = ratio * v
        if _parent_select_smem(v, f) > kernels.SMEM_MAX:
            continue
        assert kernels.select_route(v, f) == "shared", (v, f)
        assert kernels.select_smem(v, f) <= kernels.SMEM_MAX, (v, f)


def test_select_route_takes_every_factor_count_the_first_design_took():
    """At any F the first design held in shared memory beside V poses, up
    to its ~116,000 factor slots, the shared route takes the graph."""
    for v in range(1, 30000, 997):
        f_max = (kernels.SMEM_MAX - 4 * (2 * v + 40)) // 2
        for f in (1, f_max // 3, f_max):
            if 1 <= f <= f_max:
                assert kernels.select_route(v, f) == "shared", (v, f)
                assert kernels.select_smem(v, f, 0) <= kernels.SMEM_MAX


V, F, P = 70000, 140000, 4   # past the shared route's 65,535 poses
N = 69990                    # live poses


def _graph(extra):
    """A JAX-package graph of V pose and F factor slots: a chain of N
    poses, 300 seeded loop factors, then ``extra`` (the newest factors);
    one dead pose in the middle, one prior. Only the topology matters to
    the selection."""
    rng = np.random.default_rng(16)
    lo = rng.integers(0, N - 60, 300)
    loops = [(int(i), int(i + rng.integers(50, N - i))) for i in lo]
    pairs = [(i, i + 1) for i in range(N - 1)] + loops + list(extra)
    bi, bj = np.zeros(F, np.int32), np.zeros(F, np.int32)
    bi[:len(pairs)], bj[:len(pairs)] = np.array(pairs).T
    bm = np.zeros(F, bool)
    bm[:len(pairs)] = True
    bm[5] = False                                 # a dead factor slot
    pose_mask = np.zeros(V, bool)
    pose_mask[:N] = True
    pose_mask[N // 2] = False
    pm = np.zeros(P, bool)
    pm[0] = True
    g = jfct.PoseGraph(
        poses=jnp.zeros((V, 3)), pose_mask=jnp.asarray(pose_mask),
        prior_idx=jnp.asarray([0, 0, N - 1, 7], jnp.int32),
        prior_z=jnp.zeros((P, 3)), prior_sqrt_info=jnp.zeros((P, 3, 3)),
        prior_mask=jnp.asarray(pm), bet_i=jnp.asarray(bi),
        bet_j=jnp.asarray(bj), bet_z=jnp.zeros((F, 3)),
        bet_sqrt_info=jnp.zeros((F, 3, 3)), bet_mask=jnp.asarray(bm),
        n_poses=jnp.asarray(N, jnp.int32), n_priors=jnp.asarray(1, jnp.int32),
        n_between=jnp.asarray(len(pairs), jnp.int32))
    return g, convert.from_numpy(g), len(pairs)


@functools.partial(jax.jit, static_argnums=1)
def _jax_select(g, cfg, since):
    probe = jinc._active_probe(g, cfg, since)
    return jinc._local_select(g, cfg, since, probe)


#: name: (newest factors, since as an offset from n_between or None, ok)
CASES = {
    "local": ([(N - 3, N - 2), (N - 2, N - 1)], -2, True),
    # since None: the newest 32 slots, loop factors among them.
    "fresh_window": ([(N - 3, N - 1)], None, False),
    "long_loop": ([(120, N - 1)], -1, False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_local_select_ref_matches_jax_past_one_block(case):
    extra, off, ok = CASES[case]
    gj, gt, nb = _graph(extra)
    assert kernels.select_route(V, F) == "scratch"
    s = None if off is None else nb + off
    sj = None if s is None else jnp.asarray(s, jnp.int32)
    st = None if s is None else torch.tensor(s)
    ref = _jax_select(gj, JSolverConfig(), sj)
    sel = tinc.local_select(gt, SolverConfig(), st)
    exact = lambda a, b: np.testing.assert_array_equal(np.asarray(a),
                                                       np.asarray(b))
    for key in ("ok", "pid", "in_set", "fid", "f_sel", "ri", "rj", "rp",
                "p_act"):
        exact(sel[key], ref[key])
    exact(sel["li"], ref["loc_of"][ref["bi"]])
    exact(sel["lj"], ref["loc_of"][ref["bj"]])
    exact(sel["lp"], ref["loc_of"][gj.prior_idx])
    assert bool(sel["ok"]) == ok
    assert sel["p_loc"] == 256 and sel["fid"].shape[0] == 1024


@pytest.mark.parametrize("compact,nx", [(False, 1814), (True, 3630)])
def test_finalize_bands_refuse_past_one_band_row(compact, nx):
    """K4 at overlap 4 holds one band row in shared memory: nx 1,813
    (3,629 with compact rows) is the widest grid it takes."""
    grid = lambda n: GridConfig(x0=0.0, y0=0.0, cell=0.5, nx=n, ny=10)
    rows, _, _, smem = kernels.finalize_bands(grid(nx - 1), None, compact)
    assert rows == 1 and smem <= kernels.SMEM_MAX
    with pytest.raises(ValueError, match="shared memory"):
        kernels.finalize_bands(grid(nx), None, compact)


@pytest.mark.parametrize("overlap,nx,lattice", [(4, 171, 343),
                                                (1, 1025, 1025)])
def test_local_bands_refuse_past_48_kb(overlap, nx, lattice):
    """K8a holds a band's int64 sums (48 B per lattice bin, with a two-row
    halo at overlap 4) within 48 KB: a local lattice at most 341 bins wide
    at overlap 4 (nx 170), 1,024 at overlap 1."""
    grid = lambda n: GridConfig(x0=0.0, y0=0.0, cell=0.5, nx=n, ny=10,
                                overlap=overlap)
    assert kernels._lattice(grid(nx))[0] == lattice
    rows, _, smem = kernels.local_bands(8, grid(nx - 1), None)
    assert rows >= 1 and smem <= kernels.SMEM_BLOCK
    with pytest.raises(ValueError, match="shared memory"):
        kernels.local_bands(8, grid(nx), None)


def _c_assemble_scratch():
    """``assemble_scratch(k, p, n)`` of ``csrc/local_system.cu``, as
    Python."""
    src = (Path(kernels.__file__).parent / "csrc"
           / "local_system.cu").read_text()
    expr = re.search(r"inline size_t assemble_scratch\(int k, int p, int n\)"
                     r" \{\s*return (.*?);", src, re.S).group(1)
    expr = " ".join(expr.split()).replace("(size_t)", "")
    return lambda k, p, n: eval(expr, {}, dict(k=k, p=p, n=n))


@pytest.mark.parametrize("k,p,n", [(0, 0, 1), (32, 4, 12), (1024, 1, 256),
                                   (8192, 16, 256), (40000, 64, 4096)])
def test_assemble_scratch_matches_the_kernels_layout(k, p, n):
    """Two int32 words (column block, code) per contribution in the
    bucketed and in the sorted list, at most 4 k + p contributions (each
    slot's own and cross blocks on both sides, one per prior), and the n +
    1 bucket offsets."""
    assert kernels.assemble_scratch(k, p, n) == _c_assemble_scratch()(k, p,
                                                                      n)
    assert kernels.assemble_scratch(k, p, n) == 4 * (4 * k + p) + n + 1


def _chip_smoke():
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    return chip_smoke


@functools.partial(jax.jit, static_argnums=(0, 1))
def _jax_parts(ni, ns, *parts):
    return jschur.assemble_local_parts(ni, ns, *parts, jnp.float64)


def test_assemble_local_ref_matches_jax_past_the_old_limit():
    """K7b's plain version against ``assemble_local_parts``' h_ii and b_i in
    f64 on ``chip_smoke.k7b_random_args`` at 8,192 gathered slots, 256
    local poses and 16 priors (separator endpoints at separator slots
    < 256): the same sums in another order, to 1e-12 of their max."""
    cs = _chip_smoke()
    args = cs.k7b_random_args("cpu", **cs.K7B_PAST)
    n = args[0]
    parts = [a.double() if a.is_floating_point() else a for a in args[1:]]
    h_ii, b_i = tschur.assemble_local_ref(n, *parts)
    jp = _jax_parts(n, n, *(jnp.asarray(a.numpy()) for a in parts))
    assert parts[0].shape[0] == 8192 > 7258
    for got, ref in ((h_ii, jp[0]), (b_i, jp[3])):
        ref = np.asarray(ref)
        assert got.shape == ref.shape and got.dtype == torch.float64
        np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                   atol=1e-12 * np.abs(ref).max())
    assert int((h_ii != 0).any(1).sum()) == 3 * n

