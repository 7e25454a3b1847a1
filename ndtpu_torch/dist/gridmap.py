"""Spatially sharded NDT map: x-slabs of the grid across a mesh axis.

Port of ``ndtpu/dist/gridmap.py`` (BASELINE config 5: a map too large for
one device, or one built from several robots' points, split into
contiguous x-slabs). Every function runs this rank's part, SPMD, on a
``dist.mesh.RankMesh``; rank ``r`` of ``d`` along ``axis`` owns grid
columns ``[r * nx/d, (r + 1) * nx/d)`` of every overlap grid, along the
mesh's ``"space"`` axis.

Layout: a slab is ``[G, nx_local, ny, ...]``, **ix-major** (the
reference's, so contiguous chunks are x-slabs), where the port's dense
``NDTStats``/``NDTMap`` are ``[G, ny * nx, ...]``, iy-major;
:func:`dense_to_slab` and :func:`slab_to_dense` convert.

- :func:`build_slab_stats`: points replicated, each rank accumulates the
  cells it owns (ownership masking). No communication.
- :func:`build_slab_stats_psharded`: each rank holds only its own points
  (one robot's or session's). It accumulates into a slab extended by
  ``halo`` columns on each side, then the halo columns go to their owners
  (``dist.mesh.ring_exchange``, the reference's two ring ``ppermute``\\ s)
  and are added. Points past the halo are dropped, as the dense build
  drops points off the map; rank 0's low halo and rank d-1's high halo lie
  off the map and carry zeros round the ring.
- :func:`finalize_slab`: ``ndt.grid.finalize``, elementwise in the slab
  layout.
- :func:`match_slab`: LM registration of a replicated scan against the
  sharded map: each rank sums the terms of the beams that land in its
  slab, one 15-float SUM over the axis per evaluation fuses them, and the
  LM loop (``ndt.match.lm_loop``) runs on the host on the summed vector,
  which is the same on every rank, so every rank takes the same decisions
  bit for bit.

Three hand-written CUDA kernels (``ndtpu_torch.kernels``) carry it on the
card, each beside its plain version here; CPU tensors go to the plain
versions, CUDA tensors to the kernels:

- K10a :func:`slab_accumulate` / :func:`slab_accumulate_ref`: the cell
  binning, the slab mask and the moment sums (``csrc/slab_accum.cu``, in
  64-bit fixed point relative to each cell, so the map is the same on
  every run; :func:`slab_accumulate_fixed_ref` is the plain model of that
  arithmetic, which the kernel equals bit for bit);
- K10b ``ndt.grid.finalize`` / ``finalize_ref`` (``csrc/finalize_cells.cu``);
- K10c :func:`slab_sgh` / :func:`slab_sgh_ref`: the rank's 15 raw sums at
  a pose (``csrc/ndt_unpacked.cu``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ndtpu_torch import kernels
from ndtpu_torch.config import GridConfig, MatchConfig, NDTMapConfig
from ndtpu_torch.dist import mesh as dmesh
from ndtpu_torch.ndt import grid as ndt_grid
from ndtpu_torch.ndt import match as ndt_match

__all__ = ["SlabStats", "SlabMap", "dense_to_slab", "slab_to_dense",
           "slab_halo", "slab_accumulate", "slab_accumulate_ref",
           "slab_accumulate_fixed_ref", "build_slab_stats",
           "build_slab_stats_psharded", "finalize_slab", "slab_sgh",
           "slab_sgh_ref", "match_slab"]


class SlabStats(NamedTuple):
    """This rank's sufficient statistics in slab layout: n ``[G,
    nx_local, ny]``, s ``[G, nx_local, ny, 2]``, ss ``[G, nx_local, ny, 2,
    2]``."""

    n: torch.Tensor
    s: torch.Tensor
    ss: torch.Tensor


class SlabMap(NamedTuple):
    """This rank's finalized slab: mean ``[G, nx_local, ny, 2]``, icov
    ``[G, nx_local, ny, 2, 2]``, valid ``[G, nx_local, ny]``."""

    mean: torch.Tensor
    icov: torch.Tensor
    valid: torch.Tensor


def dense_to_slab(tree, grid: GridConfig):
    """Dense ``[G, ny * nx, ...]`` leaves (``NDTStats`` -> ``SlabStats``,
    ``NDTMap`` -> ``SlabMap``) to the whole map in slab layout ``[G, nx,
    ny, ...]``; rank ``r``'s slab is columns ``[r * nx/d, (r + 1) *
    nx/d)`` of axis 1."""
    g = grid.overlap

    def conv(x):
        lead = tuple(x.shape[2:])
        k = len(lead)
        return x.reshape((g, grid.ny, grid.nx) + lead).permute(
            (0, 2, 1) + tuple(range(3, 3 + k))).contiguous()

    out = SlabMap if isinstance(tree, ndt_grid.NDTMap) else SlabStats
    return out(*(conv(x) for x in tree))


def slab_to_dense(tree, grid: GridConfig):
    """Inverse of :func:`dense_to_slab`: the whole map in slab layout (the
    ranks' slabs concatenated along axis 1) to dense ``NDTStats`` /
    ``NDTMap``."""
    g = grid.overlap

    def conv(x):
        lead = tuple(x.shape[3:])
        k = len(lead)
        return x.permute((0, 2, 1) + tuple(range(3, 3 + k))).reshape(
            (g, grid.ny * grid.nx) + lead).contiguous()

    out = ndt_grid.NDTMap if isinstance(tree, SlabMap) else ndt_grid.NDTStats
    return out(*(conv(x) for x in tree))


def _cell_xy(points, grid: GridConfig):
    """Per-overlap-grid integer cell coords ``(ix, iy, inb)``, each ``[...,
    G, N]`` (``ndt.grid.cell_ids``' clamped index, split)."""
    ids, inb = ndt_grid.cell_ids(points, grid)
    return ids % grid.nx, ids // grid.nx, inb


def _slab_of(mesh: dmesh.RankMesh, grid: GridConfig):
    """``(d, nx_local, x0)``: ranks along ``"space"``, columns per slab and
    this rank's first column."""
    d = dmesh.axis_size(mesh, "space")
    if grid.nx % d:
        raise ValueError(f"nx = {grid.nx} is not divisible by the {d} ranks "
                         f"of axis 'space'")
    nxl = grid.nx // d
    return d, nxl, dmesh.axis_index(mesh, "space") * nxl


def slab_halo(points, mask, grid: GridConfig, d: int, rank: int) -> int:
    """The smallest halo that drops none of ``points [..., 2]`` (``mask
    [...]``) in :func:`build_slab_stats_psharded` on rank ``rank`` of
    ``d``: the farthest column, over the overlap grids, of a masked
    in-bounds point outside the rank's slab, counted from the slab's
    edge (the reference leaves the choice to the caller: "callers pick halo
    from the point spread")."""
    nxl = grid.nx // d
    x0 = rank * nxl
    ix, _, inb = _cell_xy(points.reshape(-1, 2), grid)
    live = mask.reshape(-1)[None] & inb
    past = torch.maximum(x0 - ix, ix - (x0 + nxl - 1)).clamp(min=0)
    past = torch.where(live, past, torch.zeros_like(past))
    return int(past.max()) if past.numel() else 0


def _accum_local(points, w, ix_local, iy, nx_local: int, grid: GridConfig):
    """The reference's ``_accum_local``: segment sums of ``w [G, N]``,
    ``w * p`` and ``w * p p^T`` into a local slab ``[G, nx_local, ny]`` at
    the ix-major local cell ``ix_local * ny + iy`` (both ``[G, N]``, in
    range), as three ``index_add_``\\ s in the points' dtype."""
    g, dt, dev = grid.overlap, points.dtype, points.device
    c = nx_local * grid.ny
    seg = (ix_local * grid.ny + iy
           + torch.arange(g, device=dev)[:, None] * c).reshape(-1)
    wp = (w[..., None] * points[None]).reshape(-1, 2)
    outer = points[:, :, None] * points[:, None, :]
    wpp = (w[..., None, None] * outer[None]).reshape(-1, 2, 2)
    n = torch.zeros(g * c, dtype=dt, device=dev).index_add_(0, seg,
                                                             w.reshape(-1))
    s = torch.zeros((g * c, 2), dtype=dt, device=dev).index_add_(0, seg, wp)
    ss = torch.zeros((g * c, 2, 2), dtype=dt, device=dev).index_add_(0, seg,
                                                                     wpp)
    return SlabStats(n=n.reshape(g, nx_local, grid.ny),
                     s=s.reshape(g, nx_local, grid.ny, 2),
                     ss=ss.reshape(g, nx_local, grid.ny, 2, 2))


def _slab_cells(points, mask, grid: GridConfig, x_lo: int, width: int):
    """Each point's cell in each grid, its local column ``ix - x_lo``
    clipped into ``[0, width)``, and ``live``: masked, on the map and in
    columns ``[x_lo, x_lo + width)`` (all ``[G, N]``)."""
    ix, iy, inb = _cell_xy(points, grid)
    lx = ix - x_lo
    live = mask[None] & inb & (lx >= 0) & (lx < width)
    return ix, lx.clamp(0, width - 1), iy, live


def slab_accumulate_ref(points, mask, grid: GridConfig, x_lo: int,
                        width: int) -> SlabStats:
    """Plain version of K10a: the statistics of grid columns ``[x_lo, x_lo
    + width)`` (``[G, width, ny, ...]``) of masked points ``[N, 2]``, each
    counted in the cell ``cell_ids`` gives it in each grid if that cell is
    on the map and in the slab (the reference's two callers of
    ``_accum_local``: ``x_lo = x0, width = nx_local`` for the ownership
    mask, ``x_lo = x0 - halo, width = nx_local + 2 halo`` for the
    halo-extended slab)."""
    _, lx, iy, live = _slab_cells(points, mask, grid, x_lo, width)
    return _accum_local(points, live.to(points.dtype), lx, iy, width, grid)


_FIX = 2.0 ** 32


def slab_accumulate_fixed_ref(points, mask, grid: GridConfig, x_lo: int,
                              width: int) -> SlabStats:
    """Plain model of K10a's arithmetic (``csrc/slab_accum.cu``), op for
    op, which the kernel equals bit for bit: each live (grid, point) in
    cell ``(ix, iy)`` adds ``round(q * 2^32)`` as int64 for ``q`` in ``(1,
    a, b, a*a, a*b, b*b)``, ``(a, b)`` its offset from the cell's lower
    corner over the cell size in f64; the cell's sums are then turned into
    ``n``, ``s`` and ``ss`` about the origin in f64 and rounded to the
    points' dtype once. Nothing on the main path calls this."""
    f64, dev = torch.float64, points.device
    g, ny, cell = grid.overlap, grid.ny, grid.cell
    ix, lx, iy, live = _slab_cells(points, mask, grid, x_lo, width)
    offs = ndt_grid._grid_offsets(grid, f64, dev)            # [G, 2]
    gx0 = (grid.x0 + offs[:, 0])[:, None]                     # [G, 1]
    gy0 = (grid.y0 + offs[:, 1])[:, None]
    inv = 1.0 / cell
    a = (points[None, :, 0].to(f64) - (gx0 + ix.to(f64) * cell)) * inv
    b = (points[None, :, 1].to(f64) - (gy0 + iy.to(f64) * cell)) * inv
    q = torch.stack([torch.ones_like(a), a, b, a * a, a * b, b * b], -1)
    vals = torch.where(live[..., None], torch.round(q * _FIX),
                       torch.zeros_like(q)).to(torch.int64)
    seg = ((torch.arange(g, device=dev)[:, None] * width + lx) * ny
           + iy).reshape(-1)
    acc = torch.zeros((g * width * ny, 6), dtype=torch.int64,
                      device=dev).index_add_(0, seg, vals.reshape(-1, 6))
    n, au, av, auu, auv, avv = (acc.to(f64) * 2.0 ** -32).reshape(
        g, width, ny, 6).unbind(-1)
    cols = torch.arange(width, dtype=f64, device=dev) + x_lo
    xc = gx0[:, :, None] + cols[None, :, None] * cell         # [G, W, 1]
    yc = gy0[:, :, None] + torch.arange(ny, dtype=f64,
                                        device=dev)[None, None] * cell
    h, h2 = cell, cell * cell
    sxy = ((h2 * auv + (xc * h) * av) + (yc * h) * au) + (xc * yc) * n
    dt = points.dtype
    return SlabStats(
        n=n.to(dt),
        s=torch.stack([h * au + xc * n, h * av + yc * n], -1).to(dt),
        ss=torch.stack([
            (h2 * auu + ((2.0 * xc) * h) * au) + (xc * xc) * n, sxy, sxy,
            (h2 * avv + ((2.0 * yc) * h) * av) + (yc * yc) * n],
            -1).to(dt).reshape(g, width, ny, 2, 2))


def slab_accumulate(points, mask, grid: GridConfig, x_lo: int,
                    width: int) -> SlabStats:
    """K10a wrapper: CUDA tensors go to the kernel (f32, 64-bit fixed-point
    sums: equal to :func:`slab_accumulate_fixed_ref` bit for bit), CPU
    tensors to :func:`slab_accumulate_ref`."""
    if not points.is_cuda:
        return slab_accumulate_ref(points, mask, grid, x_lo, width)
    return SlabStats(*kernels.slab_accumulate(
        points.contiguous(), mask.contiguous(), grid, x_lo, width))


def build_slab_stats(mesh: dmesh.RankMesh, points, mask,
                     grid: GridConfig) -> SlabStats:
    """This rank's slab of the map of replicated points ``[N, 2]``, ``mask
    [N]``: the cells it owns (ownership masking, no communication)."""
    _, nxl, x0 = _slab_of(mesh, grid)
    return slab_accumulate(points, mask, grid, x0, nxl)


def _exchange(mesh, ext: SlabStats, hw: int, nxl: int):
    """The reference's halo exchange of all three statistics at once: the
    low ``hw`` columns of the extended slab go to the left neighbour's
    high interior, the high ones to the right neighbour's low interior, and
    are added there (low first, as ``core.at[:, :hw].add`` then
    ``core.at[:, -hw:].add``)."""
    g, _, ny = ext.n.shape
    pk = torch.cat([ext.n[..., None], ext.s, ext.ss.reshape(g, -1, ny, 4)],
                   -1)                                       # [G, W, ny, 7]
    core = pk[:, hw:nxl + hw].clone()
    if hw > 0:
        from_left, from_right = dmesh.ring_exchange(
            mesh, pk[:, :hw].contiguous(), pk[:, nxl + hw:].contiguous(),
            "space")
        core[:, :hw] += from_left
        core[:, nxl - hw:] += from_right
    return SlabStats(n=core[..., 0].contiguous(),
                     s=core[..., 1:3].contiguous(),
                     ss=core[..., 3:].reshape(g, nxl, ny, 2, 2).contiguous())


def build_slab_stats_psharded(mesh: dmesh.RankMesh, points, mask,
                              grid: GridConfig, halo: int = 2) -> SlabStats:
    """This rank's slab of the map of every rank's points, from this rank's
    own points ``[..., 2]`` (``mask [...]``; the reference's per-device
    block of its sharded leading axis): accumulated into the slab extended
    by ``halo`` columns each side, then the halo exchange
    (:func:`dist.mesh.ring_exchange`, one all-reduce). ``halo`` columns
    suffice when this rank's points reach at most ``halo`` cells past its
    slab (:func:`slab_halo`); the rest are dropped. ``0 <= halo <=
    nx_local``: past that the reference's two halo adds overlap in a way no
    test holds, so it raises."""
    d, nxl, x0 = _slab_of(mesh, grid)
    if not 0 <= halo <= nxl:
        raise ValueError(f"halo = {halo} must be within [0, nx_local = "
                         f"{nxl}]")
    ext = slab_accumulate(points.reshape(-1, 2), mask.reshape(-1), grid,
                          x0 - halo, nxl + 2 * halo)
    return _exchange(mesh, ext, halo, nxl)


def finalize_slab(stats: SlabStats, cfg: NDTMapConfig) -> SlabMap:
    """Elementwise Gaussian finalization in the slab layout
    (``ndt.grid.finalize``: K10b on the card)."""
    m = ndt_grid.finalize(ndt_grid.NDTStats(*stats), cfg)
    return SlabMap(*m)


def slab_sgh_ref(poses, points, mask, slab_map: SlabMap, grid: GridConfig,
                 x_lo: int, cfg: MatchConfig):
    """Plain version of K10c: the reference's per-rank ``sgh`` before its
    psum, at every pose of ``poses [B, 3]`` for one scan ``points [N, 2]``
    (``mask [N]``) over this rank's slab (grid columns ``[x_lo, x_lo +
    nx_local)``): ``[B, 15]`` rows ``(f, wsum, w0sum, g [3], H [9])``."""
    dt = points.dtype
    nxl = slab_map.valid.shape[1]
    c = torch.cos(poses[:, 2])[:, None]
    s = torch.sin(poses[:, 2])[:, None]
    px, py = points[:, 0], points[:, 1]
    xw = torch.stack([c * px - s * py + poses[:, 0, None],
                      s * px + c * py + poses[:, 1, None]], -1)
    dxdphi = torch.stack([-s * px - c * py, c * px - s * py], -1)
    ix, iy, inb = _cell_xy(xw, grid)                          # [B, G, N]
    mine = (ix >= x_lo) & (ix < x_lo + nxl)
    ixl = (ix - x_lo).clamp(0, nxl - 1)
    gi = torch.arange(grid.overlap, device=ix.device)[:, None]
    w0 = (slab_map.valid[gi, ixl, iy] * (mine & inb).to(dt)
          * mask.to(dt)[None, None])
    f, g, h, wsum, w0sum = ndt_match.point_terms(
        poses, xw, dxdphi, slab_map.mean[gi, ixl, iy],
        slab_map.icov[gi, ixl, iy], w0, cfg)
    return torch.cat([torch.stack([f, wsum, w0sum], -1), g,
                      h.reshape(-1, 9)], -1)


def slab_sgh(poses, points, mask, slab_map: SlabMap, grid: GridConfig,
             x_lo: int, cfg: MatchConfig):
    """K10c wrapper: CUDA tensors go to the kernel (one block per pose, a
    fixed-order reduction: the same partial on every launch), CPU tensors
    to :func:`slab_sgh_ref`."""
    if not points.is_cuda:
        return slab_sgh_ref(poses, points, mask, slab_map, grid, x_lo, cfg)
    return kernels.slab_sgh(
        poses.contiguous(), points.contiguous(),
        mask.to(points.dtype).contiguous(),
        *(t.contiguous() for t in slab_map), grid, x_lo, cfg.d2,
        cfg.exp_clip)


def match_slab(mesh: dmesh.RankMesh, points, mask, slab_map: SlabMap,
               init_pose, grid: GridConfig,
               cfg: MatchConfig) -> ndt_match.MatchResult:
    """LM registration of a replicated scan ``points [N, 2]`` (``mask
    [N]``) from ``init_pose [3]`` against the sharded map (this rank's
    ``slab_map``); the same math as ``ndt.match.match`` on the whole map.
    Per evaluation: K10c on the rank's beams, the 15 sums to the host and
    one SUM over ``"space"`` (``dist.mesh.psum``); the LM carry lives on the
    host and is the same on every rank. The result is on the points'
    device."""
    _, _, x0 = _slab_of(mesh, grid)
    dev, dt = points.device, points.dtype
    mask_f = mask.to(dt)

    def sgh(pose):
        vec = slab_sgh(pose.to(dev)[None], points, mask_f, slab_map, grid,
                       x0, cfg)[0].cpu()
        vec = dmesh.psum(mesh, vec, "space")
        return (vec[0], vec[3:6], vec[6:15].reshape(3, 3),
                vec[1] / torch.clamp(vec[2], min=1.0))

    res = ndt_match.lm_loop(sgh, torch.as_tensor(init_pose).detach().to(
        "cpu", dt), cfg)
    return ndt_match.MatchResult(*(t.to(dev) for t in res))
