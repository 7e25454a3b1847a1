"""Loop-closure detection: proximity candidates + batched NDT verification
against cached per-keyframe local tables.

Port of ``ndtpu/loop/closure.py``: candidates are the nearest live
keyframes within ``radius`` and an index gap; every (query, candidate)
pair registers the query scan against a local map of the candidate in ONE
batched LM call, and the gate turns the registrations into loop factors.
Three verifies share that shape: the windowed pipeline's flat one (``K``
queries of a window against the cached tables,
:func:`verify_candidates_cached_flat`), the per-scan pipeline's per-query
one (:func:`verify_candidates_cached`, the same at ``K = 1`` without the
serving knobs ``verify_max_iter`` / ``verify_beam_stride``, as the JAX
package), and the fresh-map one (:func:`verify_candidates`: C local maps
built from each candidate's ``+-window`` keyframes, K3s then K4s on the
card, then one grouped registration with ``group`` = lane).

Two kernels carry it, each with a plain twin of the same signature here:

- :func:`write_local_tables` (K8a) / :func:`write_local_tables_ref`: the
  local tables of a window's keyframes, written into the cache in place;
- :func:`gate_and_pack` (K8b) / :func:`_gate_and_pack`: the acceptance
  gate and the factors' sqrt information.

The verification itself registers against the whole cache with ``group`` =
candidate index (K1's grouped row offset). On the card it is one launch
that also gates the lanes (``ndt.match.match_batch_packed_gated``, K8b's
device code inside ``lm_ndt``); on the CPU it is ``match_batch_packed``
followed by :func:`_gate_and_pack`. ``lax.top_k`` over masked distances
becomes a stable ascending sort, which orders equal distances by index as
``top_k`` does.
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
           "verify_registrations", "verify_candidates",
           "verify_candidates_cached", "verify_candidates_cached_flat",
           "detect_loops", "detect_loops_cached", "detect_loops_cached_flat"]


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
    stats = ndt_grid.halfcell_add_ref(
        ndt_grid.empty_stats(lgrid, points.dtype, points.device), points,
        mask, 1.0, lgrid)
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
    place. CUDA tensors go to the kernel (f32, any layout: local overlap 4
    or 1, full or ``compact`` rows), CPU tensors to
    :func:`write_local_tables_ref`."""
    if not points.is_cuda:
        return write_local_tables_ref(tables, slot, ok, points, mask,
                                      loop_cfg, ndt_cfg, compact)
    return kernels.local_tables(tables, slot.to(torch.int32).contiguous(),
                                ok.contiguous(), points.contiguous(),
                                mask.contiguous(), local_grid_config(loop_cfg),
                                ndt_cfg, compact)


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


def _k_budget(loop_cfg: LoopConfig) -> int:
    """The top-K accept budget the kernels take (0: none)."""
    k = loop_cfg.max_accept_per_query
    return k if k and k < loop_cfg.max_candidates else 0


def gate_and_pack(res: ndt_match.MatchResult, cands: LoopCandidates,
                  loop_cfg: LoopConfig, init, query_index) -> LoopResult:
    """K8b wrapper over ``[K, C]`` lanes of registrations made elsewhere:
    CUDA tensors go to the standalone kernel (f32, C <= 128), CPU tensors
    to :func:`_gate_and_pack`."""
    if not res.pose.is_cuda:
        return _gate_and_pack(res, cands, loop_cfg, init, query_index)
    acc, rej, sqrt_info = kernels.loop_gate(
        cands.mask.contiguous(), res.converged.contiguous(),
        res.score.contiguous(), res.pose.contiguous(), init.contiguous(),
        res.hessian.contiguous(), cands.idx.contiguous(),
        torch.as_tensor(query_index, dtype=torch.int64,
                        device=res.pose.device).contiguous(),
        loop_cfg.score_gate, loop_cfg.max_innovation_base,
        loop_cfg.max_innovation_per_kf, _k_budget(loop_cfg))
    return LoopResult(j=cands.idx, z=res.pose, sqrt_info=sqrt_info,
                      score=res.score, accept=acc, innov_rej=rej)


def _verify_lanes(kf: KeyframeStore, query_points, query_mask,
                  query_poses, cands: LoopCandidates, loop_cfg: LoopConfig,
                  match_cfg: MatchConfig, knobs: bool = True):
    """The verify's ``K*C`` flat lanes: ``(points, mask, init, grid,
    match_cfg, group)`` for a grouped call over the whole cache, with
    ``verify_max_iter`` and ``verify_beam_stride`` applied if ``knobs``."""
    if kf.tables is None:
        raise ValueError("KeyframeStore built without tables")
    lgrid = local_grid_config(loop_cfg)
    if knobs and loop_cfg.verify_max_iter > 0:
        match_cfg = dataclasses.replace(match_cfg,
                                        max_iter=loop_cfg.verify_max_iter)
    stride = max(1, loop_cfg.verify_beam_stride) if knobs else 1
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
    return pts, msk, init, lgrid, match_cfg, flat_idx


def verify_registrations(kf: KeyframeStore, query_points, query_mask,
                         query_poses, cands: LoopCandidates,
                         loop_cfg: LoopConfig, match_cfg: MatchConfig,
                         knobs: bool = True):
    """The registrations of :func:`verify_candidates_cached_flat` (or, with
    ``knobs=False``, of the per-query verify), before the gate:
    ``(MatchResult [K, C], init [K, C, 3])``."""
    pts, msk, init, lgrid, mcfg, flat_idx = _verify_lanes(
        kf, query_points, query_mask, query_poses, cands, loop_cfg,
        match_cfg, knobs)
    res = ndt_match.match_batch_packed(pts, msk, kf.tables, init, lgrid,
                                       mcfg, group=flat_idx)
    k, c = cands.idx.shape
    return (ndt_match.MatchResult(*(a.reshape((k, c) + a.shape[1:])
                                    for a in res)),
            init.reshape(k, c, 3))


def _gated_verify(points, mask, tables, init, lgrid: GridConfig,
                  match_cfg: MatchConfig, group, cands: LoopCandidates,
                  loop_cfg: LoopConfig, query_index) -> LoopResult:
    """The card's verify of ``K x C`` lanes (``cands [K, C]``,
    ``query_index [K]``): ONE gated ``lm_ndt`` launch that registers lane
    ``b`` against ``tables[group[b]]`` and gates, no host sync."""
    gate = kernels.LoopGate(
        cands.mask.contiguous(),
        torch.as_tensor(query_index, dtype=torch.int64,
                        device=points.device).contiguous(),
        loop_cfg.score_gate, loop_cfg.max_innovation_base,
        loop_cfg.max_innovation_per_kf, _k_budget(loop_cfg))
    res, (acc, rej, sqrt_info) = ndt_match.match_batch_packed_gated(
        points, mask, tables, init, lgrid, match_cfg, group, gate)
    k, c = cands.idx.shape
    return LoopResult(j=cands.idx, z=res.pose.reshape(k, c, 3),
                      sqrt_info=sqrt_info, score=res.score.reshape(k, c),
                      accept=acc, innov_rej=rej)


def _verify_cached(kf: KeyframeStore, query_points, query_mask, query_poses,
                   cands: LoopCandidates, loop_cfg: LoopConfig,
                   match_cfg: MatchConfig, query_index, knobs: bool
                   ) -> LoopResult:
    if not query_points.is_cuda:
        res, init = verify_registrations(kf, query_points, query_mask,
                                         query_poses, cands, loop_cfg,
                                         match_cfg, knobs)
        return _gate_and_pack(res, cands, loop_cfg, init, query_index)
    pts, msk, init, lgrid, mcfg, flat_idx = _verify_lanes(
        kf, query_points, query_mask, query_poses, cands, loop_cfg,
        match_cfg, knobs)
    return _gated_verify(pts, msk, kf.tables, init, lgrid, mcfg, flat_idx,
                         cands, loop_cfg, query_index)


def verify_candidates_cached_flat(kf: KeyframeStore, query_points,
                                  query_mask, query_poses,
                                  cands: LoopCandidates,
                                  loop_cfg: LoopConfig,
                                  match_cfg: MatchConfig,
                                  query_index) -> LoopResult:
    """Verify ``K`` queries x ``C`` candidates (``cands [K, C]``) as ONE
    ``K*C``-lane registration against the cached tables: lane ``(k, c)``
    registers ``query_points[k] [N, 2]`` against ``kf.tables[idx[k, c]]``
    (the whole cache with ``group`` = candidate index) from the
    estimate-predicted relative pose, then the gate. ``verify_max_iter``
    and ``verify_beam_stride`` apply. Every lane runs, masked ones
    included. On the card registration and gate are one launch
    (``match_batch_packed_gated``), bit-equal to ``match_batch_packed``
    followed by :func:`gate_and_pack`, with no host sync; on the CPU,
    :func:`verify_registrations` and :func:`_gate_and_pack`."""
    return _verify_cached(kf, query_points, query_mask, query_poses, cands,
                          loop_cfg, match_cfg, query_index, knobs=True)


def verify_candidates_cached(kf: KeyframeStore, query_points, query_mask,
                             query_pose, cands: LoopCandidates,
                             loop_cfg: LoopConfig, match_cfg: MatchConfig,
                             query_index=None) -> LoopResult:
    """Verify one query (``query_points [N, 2]``, ``query_pose [3]``)
    against its ``C`` candidates' cached tables (``cands [C]``): the flat
    verify at ``K = 1``, one gated launch on the card, but with the match
    config as given (the JAX package's per-query route applies neither
    ``verify_max_iter`` nor ``verify_beam_stride``). ``query_index``
    defaults to ``kf.n``. Returns a ``[C]`` ``LoopResult``."""
    if query_index is None:
        query_index = kf.n
    qi = torch.as_tensor(query_index, device=query_points.device)[None]
    out = _verify_cached(kf, query_points[None], query_mask[None],
                         query_pose[None],
                         LoopCandidates(*(x[None] for x in cands)),
                         loop_cfg, match_cfg, qi, knobs=False)
    return LoopResult(*(x[0] for x in out))


def _local_points(kf: KeyframeStore, j, window: int):
    """Points of keyframes ``j-window .. j+window`` in ``j``'s frame, for
    candidates ``j [C]``: ``(pts [C, (2w+1) N, 2], msk [C, (2w+1) N])``;
    indices past the store are clipped and masked."""
    offs = torch.arange(-window, window + 1, device=j.device)
    nbr = j[:, None] + offs                                       # [C, W]
    nb = torch.clamp(nbr, 0, kf.capacity - 1)
    in_range = (nbr >= 0) & (nbr < kf.capacity)
    msk = kf.masks[nb] & kf.live[nb][..., None] & in_range[..., None]
    world = se2.transform(kf.poses[nb], kf.points[nb])        # [C, W, N, 2]
    c = j.shape[0]
    local = se2.transform_inv(kf.poses[j], world.reshape(c, -1, 2))
    return local, msk.reshape(c, -1)


def verify_candidates(kf: KeyframeStore, query_points, query_mask,
                      query_pose, cands: LoopCandidates,
                      loop_cfg: LoopConfig, ndt_cfg: NDTMapConfig,
                      match_cfg: MatchConfig, window: int = 1,
                      query_index=None) -> LoopResult:
    """Verify one query against ``C`` fresh local maps (``cands [C]``):
    each candidate's map holds its ``+-window`` keyframes in its frame
    (:func:`_local_points`), built from scratch (``add_points_stacked``:
    one K3s launch on the card) and packed (``finalize_pack_stacked``: one
    K4s launch); lane ``c`` registers the query against table ``c`` (one
    gated ``lm_ndt`` launch on the card, ``group`` = lane), then the gate.
    The match config is used as given; every table layout
    (``local_overlap``, ``compact_table``) runs on the card. Returns a
    ``[C]`` ``LoopResult``."""
    if query_index is None:
        query_index = kf.n
    lgrid = local_grid_config(loop_cfg)
    dt, dev = query_points.dtype, query_points.device
    c, n = cands.idx.shape[0], query_points.shape[0]
    local, lmsk = _local_points(kf, cands.idx, window)
    empty = ndt_grid.empty_stats(lgrid, dt, dev)
    stats = ndt_grid.add_points_stacked(
        ndt_grid.NDTStats(*(x.expand((c,) + x.shape).contiguous()
                            for x in empty)), local, lmsk, lgrid)
    tables = ndt_grid.finalize_pack_stacked(stats, ndt_cfg, lgrid,
                                            match_cfg.compact_table)
    init = se2.between(kf.poses[cands.idx], query_pose[None, :])  # [C, 3]
    pts = query_points[None].expand(c, n, 2)
    msk = query_mask[None].expand(c, n)
    lanes = torch.arange(c, device=dev)
    if not query_points.is_cuda:
        res = ndt_match.match_batch_packed(pts, msk, tables, init, lgrid,
                                           match_cfg, group=lanes)
        return _gate_and_pack(res, cands, loop_cfg, init, query_index)
    qi = torch.as_tensor(query_index, device=dev)[None]
    out = _gated_verify(pts.contiguous(), msk.contiguous(), tables, init,
                        lgrid, match_cfg, lanes,
                        LoopCandidates(*(x[None] for x in cands)), loop_cfg,
                        qi)
    return LoopResult(*(x[0] for x in out))


def detect_loops_cached_flat(kf: KeyframeStore, query_points, query_mask,
                             query_poses, query_index, loop_cfg: LoopConfig,
                             match_cfg: MatchConfig) -> LoopResult:
    """Candidate search + flat cached verification for ``K`` queries (the
    windowed pipeline's path)."""
    cands = find_candidates(kf, query_poses, query_index, loop_cfg)
    return verify_candidates_cached_flat(kf, query_points, query_mask,
                                         query_poses, cands, loop_cfg,
                                         match_cfg, query_index)


def detect_loops(kf: KeyframeStore, query_points, query_mask, query_pose,
                 query_index, loop_cfg: LoopConfig, ndt_cfg: NDTMapConfig,
                 match_cfg: MatchConfig, window: int = 1) -> LoopResult:
    """Candidate search + the fresh-map verify (:func:`verify_candidates`)
    for one query."""
    cands = find_candidates(kf, query_pose, query_index, loop_cfg)
    return verify_candidates(kf, query_points, query_mask, query_pose, cands,
                             loop_cfg, ndt_cfg, match_cfg, window,
                             query_index=query_index)


def detect_loops_cached(kf: KeyframeStore, query_points, query_mask,
                        query_pose, query_index, loop_cfg: LoopConfig,
                        match_cfg: MatchConfig) -> LoopResult:
    """Candidate search + the per-query cached verify
    (:func:`verify_candidates_cached`): the per-scan pipeline's path."""
    cands = find_candidates(kf, query_pose, query_index, loop_cfg)
    return verify_candidates_cached(kf, query_points, query_mask, query_pose,
                                    cands, loop_cfg, match_cfg,
                                    query_index=query_index)
