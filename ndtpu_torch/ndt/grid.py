"""NDT grid-map construction: sufficient statistics, finalize, quad table.

Port of ``ndtpu/ndt/grid.py``. The map is a dense SoA over all ``G x C``
cells (``G`` overlap grids, ``C = nx*ny``); ``add_points`` accumulates
``(n, sum p, sum p p^T)``, ``finalize`` derives the regularized Gaussians,
and ``pack_quad`` lays them out as the half-cell quad table the matcher
gathers one row per point from (``pack_map`` / ``lookup_packed``, a row per
cell, are the JAX package's unused alternative, kept for parity).

Three hot ops have hand-written CUDA kernels (``ndtpu_torch.kernels``), each
with a plain twin of the same signature here:

- :func:`halfcell_add` (K3) / :func:`halfcell_add_ref`: the overlap-4
  half-cell moment scatter + 2x2 pooling (``_add_points_halfcell``), and at
  overlap 1 the same scatter on the cells of the one grid (``add_points``'
  segment_sum); the kernel sums in 64-bit fixed point, and
  :func:`halfcell_add_fixed_ref` is the plain model of that arithmetic at
  both overlaps, which it equals bit for bit;
- :func:`finalize_pack` (K4) / :func:`finalize_pack_ref`: ``finalize`` +
  ``pack_quad`` in one pass, in every table layout (overlap 4 or 1, full
  or compact rows);
- :func:`finalize` (K10b) / :func:`finalize_ref`: ``finalize`` alone, in
  the statistics' own layout (config 5's slab map, ``dist.gridmap``).

The stacked multi-session path (``dist.slam_dp``) keeps S maps with a
leading session axis and adds to them, and packs them, in one launch each:
:func:`halfcell_add_stacked` (K3s) and :func:`finalize_pack_stacked` (K4s),
whose twins are the per-map functions looped over the maps.

The public function sends CUDA tensors to the kernel and CPU tensors to the
twin; nothing else selects between them. The binning op orders are the JAX
package's, in the twins and in the kernels alike: the half-cell lattice and
the matcher's lookup multiply, ``floor((x - x0) * inv)`` with ``inv = 2 /
cell`` (``1 / cell`` for the matcher at overlap 1); ``cell_ids``, and with
it the overlap-1 map build, divides, ``floor(((x - x0) - off) / cell)``.
The two agree at the published cells (0.5 and 1.0 m), not in general.

A compact lane (``_pack_bf16_pair``) is a bit pattern: with its high half
0 (an invalid cell, or ``i01 == 0``) it reads as an f32 denormal. Compare
compact tables as ``view(torch.int32)``, and keep such lanes out of float
arithmetic and dtype conversions other than the exact f32 -> f64 -> f32
round trip of the f64 twins (ROADMAP C-w13).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ndtpu_torch import kernels
from ndtpu_torch.config import GridConfig, NDTMapConfig

__all__ = ["NDTStats", "NDTMap", "cell_ids", "empty_stats", "add_points",
           "build_stats", "finalize", "finalize_ref", "pack_quad", "lookup",
           "pack_map", "lookup_packed",
           "lookup_quad", "lookup_quad_multi", "lookup_quad_grouped", "unpack_bf16_pair",
           "halfcell_add", "halfcell_add_ref", "halfcell_add_fixed_ref",
           "finalize_pack", "finalize_pack_ref", "add_points_stacked",
           "halfcell_add_stacked", "halfcell_add_stacked_ref",
           "finalize_pack_stacked", "finalize_pack_stacked_ref"]


class NDTStats(NamedTuple):
    """Raw per-cell sufficient statistics (the incremental map state).

    n ``[G, C]``, s ``[G, C, 2]``, ss ``[G, C, 2, 2]``.
    """

    n: torch.Tensor
    s: torch.Tensor
    ss: torch.Tensor


class NDTMap(NamedTuple):
    """Finalized Gaussian view: mean ``[G, C, 2]``, icov ``[G, C, 2, 2]``,
    valid ``[G, C]`` (1.0 where the cell has >= min_pts points)."""

    mean: torch.Tensor
    icov: torch.Tensor
    valid: torch.Tensor


_SHIFTS = ((0, 0), (1, 0), (0, 1), (1, 1))   # (gx, gy) per overlap grid


def _grid_offsets(grid: GridConfig, dtype, device):
    h = grid.cell / 2.0
    if grid.overlap == 1:
        offs = [(0.0, 0.0)]
    elif grid.overlap == 4:
        offs = [(gx * h, gy * h) for gx, gy in _SHIFTS]
    else:
        raise ValueError(f"overlap must be 1 or 4, got {grid.overlap}")
    return torch.tensor(offs, dtype=dtype, device=device)


def cell_ids(points, grid: GridConfig):
    """Flat cell index ``[..., G, N]`` (clipped) and in-bounds mask for each
    point ``[..., N, 2]`` in each overlap grid. The divisor is a tensor on
    the points' device: PyTorch on the card divides by a Python float as a
    multiply by its reciprocal, which off a power-of-two cell bins a point
    unlike the CPU, the JAX package and the kernels (IEEE division)."""
    dt, dev = points.dtype, points.device
    offs = _grid_offsets(grid, dt, dev)
    frame = torch.tensor([grid.x0, grid.y0, grid.cell], dtype=dt, device=dev)
    origin, cell = frame[:2], frame[2]
    rel = (points[..., None, :, :] - origin - offs[:, None, :]) / cell
    ix = torch.floor(rel[..., 0]).long()
    iy = torch.floor(rel[..., 1]).long()
    inb = (ix >= 0) & (ix < grid.nx) & (iy >= 0) & (iy < grid.ny)
    ix = ix.clamp(0, grid.nx - 1)
    iy = iy.clamp(0, grid.ny - 1)
    return iy * grid.nx + ix, inb


def empty_stats(grid: GridConfig, dtype=torch.float32, device="cpu"):
    g, c = grid.overlap, grid.n_cells
    kw = dict(dtype=dtype, device=device)
    return NDTStats(n=torch.zeros((g, c), **kw), s=torch.zeros((g, c, 2), **kw),
                    ss=torch.zeros((g, c, 2, 2), **kw))


def add_points(stats: NDTStats, points, mask, grid: GridConfig,
               weight=1.0) -> NDTStats:
    """Accumulate masked points ``[N, 2]`` into the statistics (a new
    ``NDTStats``; the input is not modified). ``weight`` is a scalar or a
    per-point ``[N]`` tensor (``-1`` subtracts). K3 at either overlap
    (:func:`halfcell_add`)."""
    return halfcell_add(stats, points, mask, weight, grid)


def _cell_add_ref(stats: NDTStats, points, mask, weight,
                  grid: GridConfig) -> NDTStats:
    """``add_points`` by ``cell_ids``: one ``index_add_`` of the moments
    per overlap grid (the JAX package's overlap-1 route)."""
    g, c = grid.overlap, grid.n_cells
    dt, dev = points.dtype, points.device
    ids, inb = cell_ids(points, grid)                       # [G, N]
    w = (mask[None, :] & inb).to(dt) * torch.as_tensor(weight, dtype=dt,
                                                       device=dev)
    seg = (ids + torch.arange(g, device=dev)[:, None] * c).reshape(-1)
    wp = (w[..., None] * points[None]).reshape(-1, 2)
    outer = points[:, :, None] * points[:, None, :]
    wpp = (w[..., None, None] * outer[None]).reshape(-1, 2, 2)
    kw = dict(dtype=dt, device=dev)
    dn = torch.zeros(g * c, **kw).index_add_(0, seg, w.reshape(-1))
    ds = torch.zeros((g * c, 2), **kw).index_add_(0, seg, wp)
    dss = torch.zeros((g * c, 2, 2), **kw).index_add_(0, seg, wpp)
    return NDTStats(n=stats.n + dn.reshape(g, c),
                    s=stats.s + ds.reshape(g, c, 2),
                    ss=stats.ss + dss.reshape(g, c, 2, 2))


def halfcell_add_ref(stats: NDTStats, points, mask, weight,
                     grid: GridConfig) -> NDTStats:
    """Plain twin of K3. Overlap 4: one half-cell ``index_add_`` of six
    moments onto the ``(2ny+1, 2nx+1)`` lattice, then a 2x2 sum-pool per
    shifted grid (a cell of grid ``(gx, gy)`` is the lattice block at
    ``(2j+gy, 2i+gx)``). Overlap 1: the moments' ``index_add_`` onto the
    cells ``cell_ids`` gives (``add_points``' segment_sum)."""
    if grid.overlap == 1:
        return _cell_add_ref(stats, points, mask, weight, grid)
    dt, dev = points.dtype, points.device
    wh, hh = 2 * grid.nx + 1, 2 * grid.ny + 1
    inv = 2.0 / grid.cell
    fx = torch.floor((points[:, 0] - grid.x0) * inv)
    fy = torch.floor((points[:, 1] - grid.y0) * inv)
    inb = (fx >= 0) & (fx < wh) & (fy >= 0) & (fy < hh)
    w = (mask & inb).to(dt) * torch.as_tensor(weight, dtype=dt, device=dev)
    fid = (fy * wh + fx).long().clamp(0, wh * hh - 1)
    px, py = points[:, 0], points[:, 1]
    vals = torch.stack([w, w * px, w * py, w * px * px, w * px * py,
                        w * py * py], -1)
    fine = torch.zeros((wh * hh, 6), dtype=dt, device=dev).index_add_(
        0, fid, vals).reshape(hh, wh, 6)
    pooled = []
    for gx, gy in _SHIFTS:
        blk = fine[gy: gy + 2 * grid.ny, gx: gx + 2 * grid.nx]
        pooled.append(blk.reshape(grid.ny, 2, grid.nx, 2, 6).sum(dim=(1, 3))
                      .reshape(grid.n_cells, 6))
    p = torch.stack(pooled)                                  # [4, C, 6]
    dss = torch.stack([p[..., 3], p[..., 4], p[..., 4], p[..., 5]],
                      -1).reshape(4, grid.n_cells, 2, 2)
    return NDTStats(n=stats.n + p[..., 0], s=stats.s + p[..., 1:3],
                    ss=stats.ss + dss)


_FIX = 2.0 ** 32


def halfcell_add_fixed_ref(stats: NDTStats, points, mask, weight,
                           grid: GridConfig) -> NDTStats:
    """Plain model of K3's fixed-point arithmetic
    (``kernels/csrc/halfcell_fixed.cuh``), op for op, so that the kernel
    equals it bit for bit, at both overlaps.

    Each point of weight ``w`` in bin ``(hx, hy)`` of the frame (overlap 4:
    the half cells of the twin's binning, ``h = cell/2``; overlap 1: the
    cells ``cell_ids`` gives, ``h = cell``; in the points' dtype) adds
    ``round(w * q * 2^32)`` as int64 for ``q`` in ``(1, a, b, a*a, a*b,
    b*b)``, where ``(a, b)`` is its offset from the bin's lower corner
    ``(x0 + hx*h, y0 + hy*h)`` over ``h``, in f64. Each bin's moments are
    then reconstructed in f64, pooled 2x2 in K3's order (overlap 4; at
    overlap 1 a cell is its own bin), added to the statistics in f64 and
    returned in the statistics' dtype. The int64 sums do not depend on the
    order of the points, and a ``-1`` copy of a point cancels its ``+1``
    copy exactly. Nothing on the main path calls this."""
    f64, dev = torch.float64, points.device
    if grid.overlap == 1:
        wh, hh = grid.nx, grid.ny
        inv, h = 1.0 / grid.cell, grid.cell
        ids, inb = cell_ids(points, grid)
        fid, inb = ids[0], inb[0]
        fx, fy = (fid % wh).to(points.dtype), (fid // wh).to(points.dtype)
    else:
        wh, hh = 2 * grid.nx + 1, 2 * grid.ny + 1
        inv, h = 2.0 / grid.cell, grid.cell / 2.0
        fx = torch.floor((points[:, 0] - grid.x0) * inv)
        fy = torch.floor((points[:, 1] - grid.y0) * inv)
        inb = (fx >= 0) & (fx < wh) & (fy >= 0) & (fy < hh)
        fid = (fy * wh + fx).long().clamp(0, wh * hh - 1)
    w = torch.as_tensor(weight, dtype=points.dtype, device=dev).to(f64)
    w = torch.broadcast_to(w, mask.shape)
    live = mask & inb & (w != 0)
    a = (points[:, 0].to(f64) - (grid.x0 + fx.to(f64) * h)) * inv
    b = (points[:, 1].to(f64) - (grid.y0 + fy.to(f64) * h)) * inv
    q = torch.stack([torch.ones_like(a), a, b, a * a, a * b, b * b], -1)
    vals = torch.round((w[:, None] * q) * _FIX)
    vals = torch.where(live[:, None], vals, torch.zeros_like(vals))
    acc = torch.zeros((wh * hh, 6), dtype=torch.int64, device=dev).index_add_(
        0, fid, vals.to(torch.int64))
    s_ = acc.to(f64).reshape(hh, wh, 6) * 2.0 ** -32
    n, au, av, auu, auv, avv = s_.unbind(-1)
    xc = (grid.x0 + torch.arange(wh, dtype=f64, device=dev) * h)[None, :]
    yc = (grid.y0 + torch.arange(hh, dtype=f64, device=dev) * h)[:, None]
    h2 = h * h
    fine = torch.stack([
        n,
        h * au + xc * n,
        h * av + yc * n,
        (h2 * auu + ((2.0 * xc) * h) * au) + (xc * xc) * n,
        ((h2 * auv + (xc * h) * av) + (yc * h) * au) + (xc * yc) * n,
        (h2 * avv + ((2.0 * yc) * h) * av) + (yc * yc) * n], -1)
    if grid.overlap == 1:
        p = fine.reshape(1, grid.n_cells, 6)
    else:
        pooled = []
        for gx, gy in _SHIFTS:
            blk = fine[gy: gy + 2 * grid.ny, gx: gx + 2 * grid.nx]
            r0, r1 = blk[0::2], blk[1::2]
            pooled.append((((r0[:, 0::2] + r0[:, 1::2]) + r1[:, 0::2])
                           + r1[:, 1::2]).reshape(grid.n_cells, 6))
        p = torch.stack(pooled)                              # [4, C, 6]
    g = p.shape[0]
    dss = torch.stack([p[..., 3], p[..., 4], p[..., 4], p[..., 5]],
                      -1).reshape(g, grid.n_cells, 2, 2)
    out = lambda base, d: (base.to(f64) + d).to(base.dtype)
    return NDTStats(n=out(stats.n, p[..., 0]), s=out(stats.s, p[..., 1:3]),
                    ss=out(stats.ss, dss))


def halfcell_add(stats: NDTStats, points, mask, weight,
                 grid: GridConfig) -> NDTStats:
    """K3 wrapper, at overlap 4 or 1: CUDA tensors go to the kernel (f32
    only; 64-bit fixed-point sums, so the result is the same on every run
    and equals :func:`halfcell_add_fixed_ref` bit for bit), CPU tensors to
    :func:`halfcell_add_ref`."""
    if not points.is_cuda:
        return halfcell_add_ref(stats, points, mask, weight, grid)
    n, s, ss = kernels.halfcell_add(stats.n, stats.s, stats.ss,
                                    points.contiguous(), mask.contiguous(),
                                    weight, grid)
    return NDTStats(n=n, s=s, ss=ss)


def build_stats(points, mask, grid: GridConfig) -> NDTStats:
    """Statistics from scratch for a point set ``[N, 2]``."""
    return add_points(empty_stats(grid, points.dtype, points.device), points,
                      mask, grid)


def _eig2x2_sym(a, b, c):
    """Closed-form eigendecomposition of symmetric [[a, b], [b, c]]:
    ``(l1, l2, v1)`` with ``l1 >= l2`` and ``v1`` the unit eigenvector of
    ``l1``; the 1e-20 / 1e-30 guards are the JAX package's."""
    half_tr = 0.5 * (a + c)
    amc = a - c
    d = torch.sqrt(torch.clamp(0.25 * (amc * amc) + b * b, min=0.0))
    l1, l2 = half_tr + d, half_tr - d
    b_small = torch.abs(b) <= 1e-20
    one, zero = torch.ones_like(a), torch.zeros_like(a)
    vx = torch.where(b_small, torch.where(a >= c, one, zero), b)
    vy = torch.where(b_small, torch.where(a >= c, zero, one), l1 - a)
    nrm = torch.sqrt(vx * vx + vy * vy)
    nrm = torch.where(nrm <= 1e-30, one, nrm)
    return l1, l2, torch.stack([vx / nrm, vy / nrm], -1)


def finalize(stats: NDTStats, cfg: NDTMapConfig) -> NDTMap:
    """Mean, eigenvalue-floored inverse covariance and validity per cell,
    elementwise over any leading shape (the dense ``[G, C]`` and the slab
    ``[G, nx_local, ny]`` layouts alike). K10b wrapper: CUDA tensors go to
    the kernel (``csrc/finalize_cells.cu``, f32), which reads three arrays
    or, where ``n``, ``s`` and ``ss`` are views of one tensor of 7-float
    records (``dist.gridmap``'s slab exchange), the records in place
    (``kernels.finalize_inputs``); CPU tensors to :func:`finalize_ref`."""
    if not stats.n.is_cuda:
        return finalize_ref(stats, cfg)
    return NDTMap(*kernels.finalize_cells(stats.n, stats.s, stats.ss, cfg))


def finalize_ref(stats: NDTStats, cfg: NDTMapConfig) -> NDTMap:
    """Plain version of K10b (``ndtpu/ndt/grid.py::finalize``)."""
    n = stats.n
    safe_n = torch.clamp(n, min=1.0)
    mean = stats.s / safe_n[..., None]
    cov = (stats.ss / safe_n[..., None, None]
           - mean[..., :, None] * mean[..., None, :])
    a, b, c = cov[..., 0, 0], cov[..., 0, 1], cov[..., 1, 1]
    l1, l2, v1 = _eig2x2_sym(a, b, c)
    lmax = torch.clamp(l1, min=cfg.eig_abs_min)
    lmin = torch.maximum(l2, torch.clamp(cfg.eig_ratio * lmax,
                                         min=cfg.eig_abs_min))
    v2 = torch.stack([-v1[..., 1], v1[..., 0]], -1)
    icov = (v1[..., :, None] * v1[..., None, :] / lmax[..., None, None]
            + v2[..., :, None] * v2[..., None, :] / lmin[..., None, None])
    valid = (n >= cfg.min_pts).to(mean.dtype)
    return NDTMap(mean=mean, icov=icov, valid=valid)


def lookup(ndt_map: NDTMap, points, grid: GridConfig):
    """Per-point Gaussians of every overlap grid for world points ``[..., N,
    2]``: ``(mean [..., G, N, 2], icov [..., G, N, 2, 2], w [..., G, N])``,
    ``w`` = valid x in-bounds. The plain gather of K12 (``ndt.match.
    score_grad_hess_batch``), which reads the unpacked map the same way."""
    ids, inb = cell_ids(points, grid)                       # [..., G, N]
    g = torch.arange(grid.overlap, device=ids.device)[:, None]
    mean = ndt_map.mean[g, ids]
    icov = ndt_map.icov[g, ids]
    return mean, icov, ndt_map.valid[g, ids] * inb.to(points.dtype)


def pack_map(ndt_map: NDTMap):
    """The Gaussian view as one table ``[G, C, 8]`` (any leading shape), a
    row per cell: ``[mu_x, mu_y, i00, i01, i11, valid, 0, 0]`` (``icov`` is
    symmetric: 3 entries). Plain torch on either device; port of
    ``ndtpu/ndt/grid.py::pack_map``, which nothing on a path calls."""
    mean, icov, valid = ndt_map.mean, ndt_map.icov, ndt_map.valid
    zeros = torch.zeros_like(valid)
    return torch.stack([mean[..., 0], mean[..., 1], icov[..., 0, 0],
                        icov[..., 0, 1], icov[..., 1, 1], valid, zeros,
                        zeros], -1)


def lookup_packed(packed, points, grid: GridConfig):
    """:func:`lookup` from a :func:`pack_map` table ``[G, C, 8]``: the same
    ``(mean [G, N, 2], icov [G, N, 2, 2], w [G, N])`` for world points ``[N,
    2]``. Plain torch on either device; port of
    ``ndtpu/ndt/grid.py::lookup_packed``."""
    ids, inb = cell_ids(points, grid)                       # [G, N]
    g = torch.arange(grid.overlap, device=ids.device)[:, None]
    rows = packed[g, ids]                                   # [G, N, 8]
    icov = torch.stack([torch.stack([rows[..., 2], rows[..., 3]], -1),
                        torch.stack([rows[..., 3], rows[..., 4]], -1)], -2)
    return rows[..., 0:2], icov, rows[..., 5] * inb.to(points.dtype)


def _quad_lattice(grid: GridConfig):
    """Half-cell lattice dims ``(wh, hh)`` (overlap 4) or the cell grid."""
    if grid.overlap == 4:
        return 2 * grid.nx + 1, 2 * grid.ny + 1
    return grid.nx, grid.ny


def _u32_to_f32(u):
    """int64 tensor of uint32 bit patterns -> float32 with those bits."""
    u = torch.where(u >= 2 ** 31, u - 2 ** 32, u)
    return u.to(torch.int32).view(torch.float32)


def _pack_bf16_pair(a, b):
    """Pack two arrays as a bf16 pair inside one f32 lane (a = low bits)."""
    ua = a.to(torch.bfloat16).view(torch.int16).to(torch.int64) & 0xFFFF
    ub = b.to(torch.bfloat16).view(torch.int16).to(torch.int64) & 0xFFFF
    return _u32_to_f32((ub << 16) | ua)


def unpack_bf16_pair(lane, dtype=torch.float32):
    """Invert :func:`_pack_bf16_pair` (an f64 lane is demoted first)."""
    u = lane.to(torch.float32).view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    a = _u32_to_f32((u << 16) & 0xFFFFFFFF)
    b = _u32_to_f32(u & 0xFFFF0000)
    return a.to(dtype), b.to(dtype)


def pack_quad(ndt_map: NDTMap, grid: GridConfig, compact: bool = False):
    """Half-cell quad table ``[(2ny+1)*(2nx+1), G*8]`` (overlap 4) or
    ``[ny*nx, 8]`` (overlap 1); row layout per grid ``[mu_x, mu_y, i00, i01,
    i11, valid, 0, 0]`` (``compact``: ``[mu_x, mu_y, bf16(i00|i01),
    bf16(i11|valid)]``). Lattice slots outside grid ``g`` are zero rows."""
    mean, icov, valid = ndt_map.mean, ndt_map.icov, ndt_map.valid
    g_dim = valid.shape[0]
    if compact:
        comp = torch.stack(
            [mean[..., 0], mean[..., 1],
             _pack_bf16_pair(icov[..., 0, 0], icov[..., 0, 1]).to(mean.dtype),
             _pack_bf16_pair(icov[..., 1, 1], valid).to(mean.dtype)], -1)
        width = 4
    else:
        zeros = torch.zeros_like(valid)
        comp = torch.stack([mean[..., 0], mean[..., 1], icov[..., 0, 0],
                            icov[..., 0, 1], icov[..., 1, 1], valid, zeros,
                            zeros], -1)
        width = 8
    comp = comp.reshape(g_dim, grid.ny, grid.nx, width)
    if grid.overlap == 1:
        return comp[0].reshape(grid.n_cells, width)
    wh, hh = _quad_lattice(grid)
    blocks = []
    for g, (gx, gy) in enumerate(_SHIFTS):
        up = comp[g].repeat_interleave(2, 0).repeat_interleave(2, 1)
        up = torch.nn.functional.pad(up, (0, 0, gx, 1 - gx, gy, 1 - gy))
        blocks.append(up)
    return torch.cat(blocks, -1).reshape(hh * wh, width * g_dim)


def _quad_index(x, y, grid: GridConfig):
    """Clipped quad-table row ``[...]`` and in-bounds mask of each point."""
    wh, hh = _quad_lattice(grid)
    inv = (2.0 if grid.overlap == 4 else 1.0) / grid.cell
    hx = torch.floor((x - grid.x0) * inv)
    hy = torch.floor((y - grid.y0) * inv)
    inb = (hx >= 0) & (hx < wh) & (hy >= 0) & (hy < hh)
    return (hy * wh + hx).long().clamp(0, wh * hh - 1), inb


def lookup_quad(table, x, y, grid: GridConfig):
    """Gather quad-table rows for world points given as ``x``/``y`` planes:
    ``(rows [..., L], inb [...])``."""
    idx, inb = _quad_index(x, y, grid)
    return table[idx], inb


def lookup_quad_multi(tables, x, y, grid: GridConfig):
    """Per-lane tables: lane ``b`` gathers from ``tables[b]`` —
    ``tables [B, R, L]``, ``x``/``y`` ``[B, N]`` -> ``(rows [B, N, L],
    inb [B, N])``."""
    b, r, l = tables.shape
    group = torch.arange(b, device=x.device)
    return lookup_quad_grouped(tables.reshape(b * r, l), r, group, x, y, grid)


def lookup_quad_grouped(tables_flat, r: int, group, x, y, grid: GridConfig):
    """Shared-per-group tables: lane ``b`` gathers from table ``group[b]``
    of ``tables_flat [S*R, L]`` (``r`` rows per table) -> ``(rows [B, N,
    L], inb [B, N])``. The plain twin of K1's grouped row offset."""
    idx, inb = _quad_index(x, y, grid)
    g = group.long().reshape(group.shape + (1,) * (idx.dim() - group.dim()))
    return tables_flat[idx + g * r], inb


def finalize_pack_ref(stats: NDTStats, ndt_cfg: NDTMapConfig,
                      grid: GridConfig, compact: bool = False):
    """Plain twin of K4: ``pack_quad(finalize(stats), compact)``."""
    return pack_quad(finalize_ref(stats, ndt_cfg), grid, compact=compact)


def finalize_pack(stats: NDTStats, ndt_cfg: NDTMapConfig, grid: GridConfig,
                  compact: bool = False):
    """K4 wrapper: the matcher's quad table straight from the statistics,
    in any layout (overlap 4 or 1, full or ``compact`` rows). CUDA tensors
    go to the kernel (f32), CPU tensors to :func:`finalize_pack_ref`."""
    if not stats.n.is_cuda:
        return finalize_pack_ref(stats, ndt_cfg, grid, compact)
    return kernels.finalize_pack(stats.n, stats.s, stats.ss, ndt_cfg, grid,
                                 compact)


def _map(stats8: NDTStats, i: int) -> NDTStats:
    return NDTStats(*(t[i] for t in stats8))


def _stack_maps(maps) -> NDTStats:
    return NDTStats(*(torch.stack(f) for f in zip(*maps)))


def _weight_of(weight, i: int):
    return weight[i] if isinstance(weight, torch.Tensor) else weight


def add_points_stacked(stats8: NDTStats, points, mask, grid: GridConfig,
                       weight=1.0) -> NDTStats:
    """:func:`add_points` for S maps at once: statistics with a leading
    session axis, points ``[S, M, 2]``, mask ``[S, M]``, ``weight`` a scalar
    or ``[S, M]``, at either overlap: :func:`halfcell_add_stacked` (one K3s
    launch on the card)."""
    return halfcell_add_stacked(stats8, points, mask, weight, grid)


def halfcell_add_stacked_ref(stats8: NDTStats, points, mask, weight,
                             grid: GridConfig) -> NDTStats:
    """Plain twin of K3s: :func:`halfcell_add_ref` per map (at overlap 1
    ``add_points``' segment sum, the JAX package's route)."""
    return _stack_maps([halfcell_add_ref(_map(stats8, i), points[i], mask[i],
                                         _weight_of(weight, i), grid)
                        for i in range(points.shape[0])])


def halfcell_add_stacked(stats8: NDTStats, points, mask, weight,
                         grid: GridConfig) -> NDTStats:
    """K3s wrapper: CUDA tensors go to the kernel (one launch for the S
    maps, each map bit-equal to its own K3 call), CPU tensors to
    :func:`halfcell_add_stacked_ref`."""
    if not points.is_cuda:
        return halfcell_add_stacked_ref(stats8, points, mask, weight, grid)
    if isinstance(weight, torch.Tensor):
        weight = weight.contiguous()
    return NDTStats(*kernels.halfcell_add_stacked(
        stats8.n, stats8.s, stats8.ss, points.contiguous(), mask.contiguous(),
        weight, grid))


def finalize_pack_stacked_ref(stats8: NDTStats, ndt_cfg: NDTMapConfig,
                              grid: GridConfig, compact: bool = False):
    """Plain twin of K4s: :func:`finalize_pack_ref` per map, stacked."""
    return torch.stack([finalize_pack_ref(_map(stats8, i), ndt_cfg, grid,
                                          compact)
                        for i in range(stats8.n.shape[0])])


def finalize_pack_stacked(stats8: NDTStats, ndt_cfg: NDTMapConfig,
                          grid: GridConfig, compact: bool = False):
    """K4s wrapper: the S maps' quad tables ``[S, R, L]``. CUDA tensors go
    to the kernel (one launch), CPU tensors to
    :func:`finalize_pack_stacked_ref`."""
    if not stats8.n.is_cuda:
        return finalize_pack_stacked_ref(stats8, ndt_cfg, grid, compact)
    return kernels.finalize_pack_stacked(stats8.n, stats8.s, stats8.ss,
                                         ndt_cfg, grid, compact)
