"""Loop-closure detection: proximity candidates + batched NDT verification
against cached per-keyframe local tables.

Port of the windowed pipeline's path through ``ndtpu/loop/closure.py``:
candidates are the nearest live keyframes within ``radius`` and an index
gap; every (query, candidate) pair of a window registers the query scan
against the candidate's cached local table in ONE batched LM call, and the
gate turns the registrations into loop factors.

Two kernels carry it, each with a plain twin of the same signature here:

- :func:`write_local_tables` (K8a) / :func:`write_local_tables_ref`: the
  local tables of a window's keyframes, written into the cache in place;
- :func:`gate_and_pack` (K8b) / :func:`_gate_and_pack`: the acceptance
  gate and the factors' sqrt information.

The verification itself is ``match_batch_packed`` with the whole cache and
``group`` = candidate index (K1's grouped row offset). ``lax.top_k`` over
masked distances becomes a stable ascending sort, which orders equal
distances by index as ``top_k`` does.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ndtpu_torch import kernels
from ndtpu_torch.config import GridConfig, LoopConfig, MatchConfig, \
    NDTMapConfig
from ndtpu_torch.graph.factors import info_to_sqrt_info
from ndtpu_torch.lie import se2
from ndtpu_torch.ndt import grid as ndt_grid
from ndtpu_torch.ndt import match as ndt_match
from ndtpu_torch.slam.keyframes import KeyframeStore

__all__ = ["LoopCandidates", "LoopResult", "local_grid_config",
           "local_table_shape", "build_local_table", "write_local_tables",
           "write_local_tables_ref", "find_candidates", "gate_and_pack",
           "verify_registrations", "verify_candidates_cached_flat",
           "detect_loops_cached_flat"]


class LoopCandidates(NamedTuple):
    idx: torch.Tensor    # [..., C] int64 candidate keyframe indices
    mask: torch.Tensor   # [..., C] bool — candidate slot is real
    dist: torch.Tensor   # [..., C] distance from the query pose


class LoopResult(NamedTuple):
    """Loop factors from keyframe ``j`` (candidate) to the query frame;
    ``z`` is the query scan's pose in keyframe ``j``'s frame."""

    j: torch.Tensor          # [..., C] candidate index
    z: torch.Tensor          # [..., C, 3]
    sqrt_info: torch.Tensor  # [..., C, 3, 3]
    score: torch.Tensor      # [..., C] mean per-point NDT score
    accept: torch.Tensor     # [..., C] bool — passed every gate
    innov_rej: torch.Tensor  # [..., C] bool — rejected by the innovation
                             #   budget only


def local_grid_config(cfg: LoopConfig) -> GridConfig:
    """Grid of a keyframe's local NDT map, centred on its sensor origin."""
    half = cfg.local_half_extent
    n = int(round(2.0 * half / cfg.local_cell))
    return GridConfig(x0=-half, y0=-half, cell=cfg.local_cell, nx=n, ny=n,
                      overlap=cfg.local_overlap)


def local_table_shape(loop_cfg: LoopConfig, compact: bool) -> tuple:
    """``(rows, lanes)`` of one keyframe's cached local quad table."""
    lgrid = local_grid_config(loop_cfg)
    wh, hh = ndt_grid._quad_lattice(lgrid)
    width = 4 if compact else 8
    if lgrid.overlap == 1:
        return lgrid.n_cells, width
    return wh * hh, width * lgrid.overlap


def _local_table_plain(points, mask, lgrid: GridConfig,
                       ndt_cfg: NDTMapConfig, compact: bool):
    stats = ndt_grid.empty_stats(lgrid, points.dtype, points.device)
    if lgrid.overlap == 4:
        stats = ndt_grid.halfcell_add_ref(stats, points, mask, 1.0, lgrid)
    else:
        stats = ndt_grid.add_points(stats, points, mask, lgrid)
    return ndt_grid.finalize_pack_ref(stats, ndt_cfg, lgrid, compact)


def write_local_tables_ref(tables, slot, ok, points, mask,
                           loop_cfg: LoopConfig, ndt_cfg: NDTMapConfig,
                           compact: bool = False):
    """Plain twin of K8a: for every ``w`` with ``ok[w]``, the local table of
    scan ``points[w] [N, 2]`` (sensor frame) goes to ``tables[slot[w]]``
    (in place; slots outside the cache are dropped). Returns ``tables``."""
    lgrid = local_grid_config(loop_cfg)
    for w in ok.nonzero().squeeze(-1).tolist():
        s = int(slot[w])
        if 0 <= s < tables.shape[0]:
            tables[s] = _local_table_plain(points[w], mask[w], lgrid, ndt_cfg,
                                           compact)
    return tables


def write_local_tables(tables, slot, ok, points, mask, loop_cfg: LoopConfig,
                       ndt_cfg: NDTMapConfig, compact: bool = False):
    """K8a wrapper: the local tables of ``points [W, N, 2]`` written into
    the cache ``tables [K, R, L]`` at ``slot [W]`` where ``ok [W]``, in
    place. CUDA tensors go to the kernel (f32, overlap 4, full-width rows),
    CPU tensors to :func:`write_local_tables_ref`."""
    if not points.is_cuda:
        return write_local_tables_ref(tables, slot, ok, points, mask,
                                      loop_cfg, ndt_cfg, compact)
    if compact:
        raise NotImplementedError(
            "compact_table on the card is ROADMAP Queue B (K4/K8a bf16-pair "
            "rows)")
    return kernels.local_tables(tables, slot.to(torch.int32).contiguous(),
                                ok.contiguous(), points.contiguous(),
                                mask.contiguous(), local_grid_config(loop_cfg),
                                ndt_cfg)


def build_local_table(points, mask, loop_cfg: LoopConfig,
                      ndt_cfg: NDTMapConfig, compact: bool):
    """One keyframe's local NDT map as a packed quad table ``[R, L]``, from
    its own scan ``[N, 2]`` in its own sensor frame."""
    dev = points.device
    out = torch.zeros((1,) + local_table_shape(loop_cfg, compact),
                      dtype=points.dtype, device=dev)
    return write_local_tables(out, torch.zeros(1, dtype=torch.long,
                                               device=dev),
                              torch.ones(1, dtype=torch.bool, device=dev),
                              points[None], mask[None], loop_cfg, ndt_cfg,
                              compact)[0]


def find_candidates(kf: KeyframeStore, query_pose, query_index,
                    cfg: LoopConfig) -> LoopCandidates:
    """The ``max_candidates`` nearest live keyframes within ``radius`` and
    at least ``min_index_gap`` below ``query_index``, for queries
    ``query_pose [..., 3]`` / ``query_index [...]``; equal distances in
    index order."""
    d = torch.linalg.norm(kf.poses[:, :2] - query_pose[..., None, :2],
                          dim=-1)                                 # [..., K]
    idx_all = torch.arange(kf.capacity, device=d.device)
    ok = (kf.live & (d <= cfg.radius)
          & (torch.as_tensor(query_index, device=d.device)[..., None]
             - idx_all >= cfg.min_index_gap))
    d_masked = torch.where(ok, d, torch.full_like(d, float("inf")))
    dist, idx = torch.sort(d_masked, dim=-1, stable=True)
    c = cfg.max_candidates
    return LoopCandidates(idx=idx[..., :c], mask=torch.isfinite(dist[..., :c]),
                          dist=dist[..., :c])


def _gate_and_pack(res: ndt_match.MatchResult, cands: LoopCandidates,
                   loop_cfg: LoopConfig, init, query_index) -> LoopResult:
    """Plain twin of K8b for queries ``[...]`` x candidates ``C``:
    convergence/score gate, innovation budget, top-K accept budget (ties
    kept), eigenvalue-floored Hessian -> sqrt information, finiteness."""
    accept = (cands.mask & res.converged
              & (res.score >= loop_cfg.score_gate))
    innov_rej = torch.zeros_like(accept)
    if loop_cfg.max_innovation_per_kf > 0:
        innov = torch.linalg.norm(res.pose[..., :2] - init[..., :2], dim=-1)
        gap = torch.abs(torch.as_tensor(query_index, device=innov.device)
                        [..., None] - cands.idx).to(innov.dtype)
        budget = (loop_cfg.max_innovation_base
                  + loop_cfg.max_innovation_per_kf * gap)
        innov_rej = accept & (innov > budget)
        accept = accept & (innov <= budget)
    k = loop_cfg.max_accept_per_query
    if k and k < loop_cfg.max_candidates:
        ranked = torch.where(accept, res.score,
                             torch.full_like(res.score, float("-inf")))
        kth = torch.topk(ranked, k, dim=-1).values[..., -1:]
        accept = accept & (ranked >= kth)
    h = 0.5 * (res.hessian + res.hessian.transpose(-1, -2))
    eye = torch.eye(3, dtype=h.dtype, device=h.device)
    h = torch.where(accept[..., None, None], h, eye)
    w, v = torch.linalg.eigh(h)
    w = torch.clamp(w, 1e-3, 1e8)
    h = torch.einsum("...ik,...k,...jk->...ij", v, w, v)
    sqrt_info = info_to_sqrt_info(h + 1e-6 * eye)
    finite = torch.isfinite(sqrt_info).all(-1).all(-1)
    return LoopResult(j=cands.idx, z=res.pose,
                      sqrt_info=torch.where(finite[..., None, None],
                                            sqrt_info, eye),
                      score=res.score, accept=accept & finite,
                      innov_rej=innov_rej)


def gate_and_pack(res: ndt_match.MatchResult, cands: LoopCandidates,
                  loop_cfg: LoopConfig, init, query_index) -> LoopResult:
    """K8b wrapper over ``[K, C]`` lanes: CUDA tensors go to the kernel
    (f32, C <= 32), CPU tensors to :func:`_gate_and_pack`."""
    if not res.pose.is_cuda:
        return _gate_and_pack(res, cands, loop_cfg, init, query_index)
    k = loop_cfg.max_accept_per_query
    acc, rej, sqrt_info = kernels.loop_gate(
        cands.mask.contiguous(), res.converged.contiguous(),
        res.score.contiguous(), res.pose.contiguous(), init.contiguous(),
        res.hessian.contiguous(), cands.idx.to(torch.int32).contiguous(),
        torch.as_tensor(query_index, device=res.pose.device)
        .to(torch.int32).contiguous(),
        loop_cfg.score_gate, loop_cfg.max_innovation_base,
        loop_cfg.max_innovation_per_kf,
        k if k and k < loop_cfg.max_candidates else 0)
    return LoopResult(j=cands.idx, z=res.pose, sqrt_info=sqrt_info,
                      score=res.score, accept=acc, innov_rej=rej)


def verify_registrations(kf: KeyframeStore, query_points, query_mask,
                         query_poses, cands: LoopCandidates,
                         loop_cfg: LoopConfig, match_cfg: MatchConfig):
    """The registrations of :func:`verify_candidates_cached_flat`, before
    the gate: ``(MatchResult [K, C], init [K, C, 3])``."""
    if kf.tables is None:
        raise ValueError("KeyframeStore built without tables")
    lgrid = local_grid_config(loop_cfg)
    if loop_cfg.verify_max_iter > 0:
        match_cfg = dataclasses.replace(match_cfg,
                                        max_iter=loop_cfg.verify_max_iter)
    stride = max(1, loop_cfg.verify_beam_stride)
    if stride > 1:
        query_points = query_points[:, ::stride]
        query_mask = query_mask[:, ::stride]
    k, c = cands.idx.shape
    n = query_points.shape[-2]
    flat_idx = cands.idx.reshape(-1)                              # [K*C]
    qp = query_poses[:, None, :].expand(k, c, 3).reshape(-1, 3)
    init = se2.between(kf.poses[flat_idx], qp)                    # [K*C, 3]
    pts = query_points[:, None].expand(k, c, n, 2).reshape(k * c, n, 2)
    msk = query_mask[:, None].expand(k, c, n).reshape(k * c, n)
    res = ndt_match.match_batch_packed(pts, msk, kf.tables, init, lgrid,
                                       match_cfg, group=flat_idx)
    return (ndt_match.MatchResult(*(a.reshape((k, c) + a.shape[1:])
                                    for a in res)),
            init.reshape(k, c, 3))


def verify_candidates_cached_flat(kf: KeyframeStore, query_points,
                                  query_mask, query_poses,
                                  cands: LoopCandidates,
                                  loop_cfg: LoopConfig,
                                  match_cfg: MatchConfig,
                                  query_index) -> LoopResult:
    """Verify ``K`` queries x ``C`` candidates (``cands [K, C]``) as ONE
    ``K*C``-lane registration against the cached tables: lane ``(k, c)``
    registers ``query_points[k] [N, 2]`` against ``kf.tables[idx[k, c]]``
    (the whole cache goes to K1 with ``group`` = candidate index) from the
    estimate-predicted relative pose, then the gate. ``verify_max_iter``
    and ``verify_beam_stride`` apply. Every lane runs, masked ones
    included."""
    res, init = verify_registrations(kf, query_points, query_mask,
                                     query_poses, cands, loop_cfg, match_cfg)
    return gate_and_pack(res, cands, loop_cfg, init, query_index)


def detect_loops_cached_flat(kf: KeyframeStore, query_points, query_mask,
                             query_poses, query_index, loop_cfg: LoopConfig,
                             match_cfg: MatchConfig) -> LoopResult:
    """Candidate search + flat cached verification for ``K`` queries (the
    windowed pipeline's path)."""
    cands = find_candidates(kf, query_poses, query_index, loop_cfg)
    return verify_candidates_cached_flat(kf, query_points, query_mask,
                                         query_poses, cands, loop_cfg,
                                         match_cfg, query_index)
