"""Loop-closure detection: proximity candidates + batched NDT verification
against cached per-keyframe local tables.

Port of ``ndtpu/loop/closure.py``: candidates are the nearest live
keyframes within ``radius`` and an index gap; every (query, candidate)
pair registers the query scan against a local map of the candidate in ONE
batched LM call, and the gate turns the registrations into loop factors.
The cached verify of ``K`` queries in each of ``S`` sessions is
:func:`detect_loops_stacked` (the windowed pipeline's at ``S = 1``,
stacked serving's for all sessions, the per-scan pipeline's at ``K = 1``
without the serving knobs ``verify_max_iter`` / ``verify_beam_stride``, as
the JAX package); :func:`verify_candidates_cached_flat` and
:func:`verify_candidates_cached` verify given candidates; the fresh-map
verify (:func:`verify_candidates`) builds C local maps from each
candidate's ``+-window`` keyframes (K3s then K4s on the card) and
registers lane ``c`` against map ``c``.

Three kernels carry it, each with a plain twin of the same signature here:

- :func:`write_local_tables` (K8a) / :func:`write_local_tables_ref`: the
  local tables of a window's keyframes, written into the cache in place;
- :func:`verify_lanes` (K15 ``kernels.loop_lanes``) /
  :func:`loop_lanes_ref`: the candidate search (``lax.top_k`` over masked
  distances: equal distances in index order) and every lane the gated
  ``lm_ndt`` takes, ``S x K`` queries in one launch;
- :func:`gate_and_pack` (K8b) / :func:`_gate_and_pack`: the acceptance
  gate and the factors' sqrt information.

The verification registers against the whole cache (the flat ``[S cap, R,
L]`` view of a stacked one) with ``group`` = ``s cap`` + candidate index
(K1's grouped row offset). On the card it is one launch that also gates
the lanes (``ndt.match.match_lanes`` with a gate, K8b's device code inside
``lm_ndt``); on the CPU ``lm_ndt``'s twin followed by
:func:`_gate_and_pack`.
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

__all__ = ["LoopCandidates", "LoopResult", "VerifyLanes", "local_grid_config",
           "local_table_shape", "build_local_table", "write_local_tables",
           "write_local_tables_ref", "loop_lanes_ref", "verify_lanes",
           "find_candidates", "gate_and_pack", "verify_registrations",
           "verify_candidates", "verify_candidates_cached",
           "verify_candidates_cached_flat", "detect_loops",
           "detect_loops_cached", "detect_loops_cached_flat",
           "detect_loops_stacked"]


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



class VerifyLanes(NamedTuple):
    """The loop verify's set-up for ``S x K`` queries of ``C`` candidates
    (K15's outputs, :func:`verify_lanes`): the candidates, then the gated
    ``lm_ndt``'s ``S K C`` lanes."""

    idx: torch.Tensor        # [S, K, C] int64 candidate keyframe (per session)
    mask: torch.Tensor       # [S, K, C] bool — candidate slot is real
    dist: torch.Tensor       # [S, K, C] distance (None for given candidates)
    init: torch.Tensor       # [S K C, 3] the query in the candidate's frame
    group: torch.Tensor      # [S K C] int32 s cap + idx: the flat cache's row
    query_idx: torch.Tensor  # [S K] int64 the query's index + s cap
    px: torch.Tensor         # [S K C, N'] the query's scan, every stride-th
    py: torch.Tensor         #   beam
    mask_f: torch.Tensor     # [S K C, N'] its mask as 0 / 1


def loop_lanes_ref(kf_poses, kf_live, points, mask, poses, sel, query_index,
                   radius: float, min_gap: int, c: int, stride: int = 1,
                   lanes: bool = True, cand_idx=None, cand_mask=None
                   ) -> tuple:
    """Plain twin of K15 (``kernels.loop_lanes``: the same arguments and
    outputs) in the kernel's op order, so that on the card the kernel
    equals it bit for bit. Per query ``(s, k)`` (its pose ``poses[s,
    sel[s, k]]``): ``d = sqrt(dx dx + dy dy)`` to every slot of store
    ``s``, the slots that are live, within ``radius`` and at least
    ``min_gap`` below ``query_index[s, k]`` first, nearest first, in index
    order among equal distances and among the others (a stable sort, as
    ``lax.top_k``), the first ``c`` kept; then the lanes (``init =
    se2.between(kf_poses[s, idx], pose)``, ``group = s cap + idx``,
    ``query_idx = query_index + s cap``, the query's scan at every
    ``stride``-th beam). ``points`` and ``mask`` may be None without
    ``lanes``."""
    s, cap = kf_live.shape
    k = sel.shape[1]
    dev = kf_poses.device
    qpose = torch.gather(poses, 1, sel[..., None].expand(s, k, 3))
    if cand_idx is None:
        dx = kf_poses[:, None, :, 0] - qpose[..., 0, None]        # [S, K, cap]
        dy = kf_poses[:, None, :, 1] - qpose[..., 1, None]
        d = torch.sqrt(dx * dx + dy * dy)
        slots = torch.arange(cap, device=dev)
        ok = (kf_live[:, None, :] & (d <= radius)
              & (query_index[..., None] - slots >= min_gap))
        d_masked = torch.where(ok, d, torch.full_like(d, float("inf")))
        dist, idx = torch.sort(d_masked, dim=-1, stable=True)
        cands = (idx[..., :c], torch.isfinite(dist[..., :c]), dist[..., :c])
    else:
        cands = (cand_idx, cand_mask, None)
    if not lanes:
        return cands + (None,) * 6
    off = torch.arange(s, device=dev)[:, None, None] * cap
    row = torch.clamp(cands[0], 0, cap - 1) + off
    init = se2.between(kf_poses.reshape(-1, 3)[row.reshape(-1)],
                       qpose[:, :, None].expand(s, k, c, 3).reshape(-1, 3))
    n = mask.shape[-1]
    rows = torch.gather(points, 1, sel[..., None, None].expand(s, k, n, 2))
    rmsk = torch.gather(mask, 1, sel[..., None].expand(s, k, n))
    rows, rmsk = rows[:, :, ::stride], rmsk[:, :, ::stride]

    def lane(x):
        return x[:, :, None].expand((s, k, c) + x.shape[2:]).reshape(
            (s * k * c,) + x.shape[2:]).contiguous()

    return cands + (init, (cands[0] + off).reshape(-1).to(torch.int32),
                    (query_index + off[:, :, 0]).reshape(-1),
                    lane(rows[..., 0]), lane(rows[..., 1]),
                    lane(rmsk.to(points.dtype)))


def _knobs(loop_cfg: LoopConfig, match_cfg: MatchConfig, knobs: bool):
    """The match config of a verify: ``verify_max_iter`` applied if
    ``knobs``."""
    if knobs and loop_cfg.verify_max_iter > 0:
        return dataclasses.replace(match_cfg,
                                   max_iter=loop_cfg.verify_max_iter)
    return match_cfg


def verify_lanes(kf8: KeyframeStore, points, mask, poses, sel, query_index,
                 loop_cfg: LoopConfig, knobs: bool = True,
                 cands: LoopCandidates | None = None,
                 lanes: bool = True) -> VerifyLanes:
    """The verify's set-up for ``K`` queries in each of ``S`` sessions:
    stores ``kf8`` (every field with a leading session axis), windows
    ``points [S, W, N, 2]``, ``mask [S, W, N]``, ``poses [S, W, 3]``, the
    queries' rows ``sel [S, K]`` and indices ``query_index [S, K]``. The
    candidate search (:func:`loop_lanes_ref`; or the given ``cands [S, K,
    C]``), then, with ``lanes``, the lanes (the beam stride applied if
    ``knobs``). CUDA tensors go to K15, one launch; CPU tensors to
    :func:`loop_lanes_ref`."""
    stride = max(1, loop_cfg.verify_beam_stride) if knobs else 1
    args = [kf8.poses, kf8.live, points, mask, poses, sel,
            query_index.to(torch.int64)]
    if kf8.poses.is_cuda:
        args = [None if t is None else t.contiguous() for t in args]
        fn = kernels.loop_lanes
    else:
        fn = loop_lanes_ref
    c = loop_cfg.max_candidates if cands is None else cands.idx.shape[-1]
    given = (() if cands is None
             else (cands.idx.to(torch.int64).contiguous(),
                   cands.mask.contiguous()))
    return VerifyLanes(*fn(*args, loop_cfg.radius, loop_cfg.min_index_gap, c,
                           stride, lanes, *given))


def _one(kf: KeyframeStore) -> KeyframeStore:
    """A store with a leading session axis of 1 (views)."""
    return KeyframeStore(*(None if t is None else t[None] for t in kf))


def _queries(query_index, shape, dev) -> torch.Tensor:
    """``query_index`` (a number or a tensor that broadcasts to ``shape``)
    as one session's queries: int64 ``[1, prod(shape)]``."""
    return torch.as_tensor(query_index, device=dev).to(torch.int64).expand(
        shape).reshape(1, -1)


def find_candidates(kf: KeyframeStore, query_pose, query_index,
                    cfg: LoopConfig) -> LoopCandidates:
    """The ``max_candidates`` nearest live keyframes within ``radius`` and
    at least ``min_index_gap`` below ``query_index``, for queries
    ``query_pose [..., 3]`` / ``query_index [...]``; equal distances in
    index order, then the lowest-index others (``mask`` false) where fewer
    qualify: K15's search alone on the card (one launch), its twin on the
    CPU."""
    lead = query_pose.shape[:-1]
    qp = query_pose.reshape(1, -1, 3)
    out = verify_lanes(_one(kf), None, None, qp,
                       torch.arange(qp.shape[1], device=qp.device)[None],
                       _queries(query_index, lead, qp.device), cfg,
                       lanes=False)
    return LoopCandidates(*(x.reshape(lead + x.shape[2:])
                            for x in out[:3]))


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




def _verify(lanes: VerifyLanes, query_index, tables, loop_cfg: LoopConfig,
            match_cfg: MatchConfig, knobs: bool, group=None,
            gate: bool = True) -> LoopResult:
    """Register ``S x K x C`` lanes (:func:`verify_lanes`) against
    ``tables`` (the flat ``[S cap, R, L]`` view of the stacked cache, lane
    ``b`` reading row ``lanes.group[b]``; or with ``group`` its own rows)
    and gate them: on the card ONE gated ``lm_ndt`` launch (no host sync),
    on the CPU ``lm_ndt``'s twin and :func:`_gate_and_pack`. Returns ``[S,
    K, C]`` fields, ``j`` the candidates' per-session indices; with
    ``gate=False`` the registrations ``(MatchResult, init)`` instead (the
    CPU route, any device)."""
    mcfg = _knobs(loop_cfg, match_cfg, knobs)
    s, k, c = lanes.idx.shape
    q = s * k
    cands = LoopCandidates(lanes.idx.reshape(q, c), lanes.mask.reshape(q, c),
                           None)
    args = (lanes.init, lanes.px, lanes.py, lanes.mask_f,
            lanes.group if group is None else group, tables,
            local_grid_config(loop_cfg), mcfg)
    split = lambda x: x.reshape((s, k, c) + x.shape[2:])
    if not (gate and lanes.px.is_cuda):
        res = ndt_match.MatchResult(*(a.reshape((q, c) + a.shape[1:])
                                      for a in ndt_match.match_lanes(*args)))
        init = lanes.init.reshape(q, c, 3)
        if not gate:
            return (ndt_match.MatchResult(*map(split, res)), split(init))
        out = _gate_and_pack(res, cands, loop_cfg, init,
                             query_index.reshape(q))
        return LoopResult(*map(split, out))
    # The gate's innovation gap is |query_idx - candidate|: the lanes'
    # session offsets, or the candidates themselves where the rows are
    # another table's (``group``).
    g = kernels.LoopGate(
        cands.mask, lanes.query_idx if group is None
        else query_index.reshape(q).to(torch.int64).contiguous(),
        loop_cfg.score_gate, loop_cfg.max_innovation_base,
        loop_cfg.max_innovation_per_kf, _k_budget(loop_cfg),
        None if group is None else cands.idx.contiguous())
    res, (acc, rej, sqrt_info) = ndt_match.match_lanes(*args, gate=g)
    return LoopResult(*map(split, (cands.idx, res.pose.reshape(q, c, 3),
                                   sqrt_info, res.score.reshape(q, c), acc,
                                   rej)))


def _flat_tables(kf8: KeyframeStore):
    """The stacked cache ``[S, cap, R, L]`` as one ``[S cap, R, L]`` view."""
    if kf8.tables is None:
        raise ValueError("KeyframeStore built without tables")
    return kf8.tables.view((-1,) + kf8.tables.shape[2:])


def detect_loops_stacked(kf8: KeyframeStore, points, mask, poses, sel,
                         query_index, loop_cfg: LoopConfig,
                         match_cfg: MatchConfig, knobs: bool = True
                         ) -> LoopResult:
    """Candidate search and cached verify of ``K`` queries in each of ``S``
    sessions as ONE ``S K C``-lane registration (the JAX package's
    ``detect_loops_cached_flat`` vmapped over sessions): stores ``kf8``
    (leading session axis), windows ``points [S, W, N, 2]``, ``mask [S, W,
    N]``, ``poses [S, W, 3]``, queries at rows ``sel [S, K]`` with indices
    ``query_index [S, K]``. Lane ``(s, k, c)`` registers query ``(s, k)``'s
    scan against its candidate's cached table from the estimate-predicted
    relative pose, then the gate; ``verify_max_iter`` and
    ``verify_beam_stride`` apply if ``knobs``; every lane runs, masked
    ones included. On the card: one K15 launch and one gated ``lm_ndt``
    launch over the flat cache, no host sync. Returns ``[S, K, C]``
    fields."""
    lanes = verify_lanes(kf8, points, mask, poses, sel, query_index,
                         loop_cfg, knobs)
    return _verify(lanes, query_index, _flat_tables(kf8), loop_cfg,
                   match_cfg, knobs)


def _given(kf: KeyframeStore, query_points, query_mask, query_poses,
           cands: LoopCandidates, loop_cfg: LoopConfig, query_index,
           knobs: bool):
    """``(lanes, query_index [1, K])`` of one session's ``K`` queries
    against given candidates ``cands [K, C]``."""
    k = query_poses.shape[0]
    qi = _queries(query_index, (k,), query_poses.device)
    sel = torch.arange(k, device=query_poses.device)[None]
    lanes = verify_lanes(_one(kf), query_points[None], query_mask[None],
                         query_poses[None], sel, qi, loop_cfg, knobs,
                         LoopCandidates(*(None if x is None else x[None]
                                          for x in cands)))
    return lanes, qi


def verify_registrations(kf: KeyframeStore, query_points, query_mask,
                         query_poses, cands: LoopCandidates,
                         loop_cfg: LoopConfig, match_cfg: MatchConfig,
                         knobs: bool = True):
    """The registrations of :func:`verify_candidates_cached_flat` (or, with
    ``knobs=False``, of the per-query verify), before the gate:
    ``(MatchResult [K, C], init [K, C, 3])``."""
    lanes, qi = _given(kf, query_points, query_mask, query_poses, cands,
                       loop_cfg, 0, knobs)
    res, init = _verify(lanes, qi, _flat_tables(_one(kf)), loop_cfg,
                        match_cfg, knobs, gate=False)
    return ndt_match.MatchResult(*(a[0] for a in res)), init[0]


def verify_candidates_cached_flat(kf: KeyframeStore, query_points,
                                  query_mask, query_poses,
                                  cands: LoopCandidates,
                                  loop_cfg: LoopConfig,
                                  match_cfg: MatchConfig,
                                  query_index) -> LoopResult:
    """Verify ``K`` queries x ``C`` given candidates (``cands [K, C]``) as
    ONE ``K*C``-lane registration against the cached tables: lane ``(k,
    c)`` registers ``query_points[k] [N, 2]`` against
    ``kf.tables[idx[k, c]]`` (the whole cache with ``group`` = candidate
    index) from the estimate-predicted relative pose, then the gate.
    ``verify_max_iter`` and ``verify_beam_stride`` apply. Every lane runs,
    masked ones included. On the card: K15 (the lanes, no search) and ONE
    gated ``lm_ndt`` launch, bit-equal to ``match_batch_packed`` followed
    by :func:`gate_and_pack`, with no host sync; on the CPU,
    :func:`verify_registrations` and :func:`_gate_and_pack`."""
    lanes, qi = _given(kf, query_points, query_mask, query_poses, cands,
                       loop_cfg, query_index, True)
    out = _verify(lanes, qi, _flat_tables(_one(kf)), loop_cfg, match_cfg,
                  True)
    return LoopResult(*(x[0] for x in out))


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
    lanes, qi = _given(kf, query_points[None], query_mask[None],
                       query_pose[None],
                       LoopCandidates(*(None if x is None else x[None]
                                        for x in cands)),
                       loop_cfg, query_index, False)
    out = _verify(lanes, qi, _flat_tables(_one(kf)), loop_cfg, match_cfg,
                  False)
    return LoopResult(*(x[0, 0] for x in out))


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
    K4s launch); the lanes from K15 (given candidates, no search); lane
    ``c`` registers the query against table ``c`` and the gate takes the
    candidates' indices (one gated ``lm_ndt`` launch on the card). The
    match config is used as given; every table layout (``local_overlap``,
    ``compact_table``) runs on the card. Returns a ``[C]``
    ``LoopResult``."""
    if query_index is None:
        query_index = kf.n
    lgrid = local_grid_config(loop_cfg)
    dt, dev = query_points.dtype, query_points.device
    c = cands.idx.shape[0]
    local, lmsk = _local_points(kf, cands.idx, window)
    empty = ndt_grid.empty_stats(lgrid, dt, dev)
    stats = ndt_grid.add_points_stacked(
        ndt_grid.NDTStats(*(x.expand((c,) + x.shape).contiguous()
                            for x in empty)), local, lmsk, lgrid)
    tables = ndt_grid.finalize_pack_stacked(stats, ndt_cfg, lgrid,
                                            match_cfg.compact_table)
    lanes, qi = _given(kf, query_points[None], query_mask[None],
                       query_pose[None],
                       LoopCandidates(*(None if x is None else x[None]
                                        for x in cands)),
                       loop_cfg, query_index, False)
    out = _verify(lanes, qi, tables, loop_cfg, match_cfg, False,
                  group=torch.arange(c, dtype=torch.int32, device=dev))
    return LoopResult(*(x[0, 0] for x in out))


def detect_loops_cached_flat(kf: KeyframeStore, query_points, query_mask,
                             query_poses, query_index, loop_cfg: LoopConfig,
                             match_cfg: MatchConfig) -> LoopResult:
    """Candidate search + flat cached verification for ``K`` queries
    (``query_points [K, N, 2]``, ``query_poses [K, 3]``, ``query_index
    [K]``): :func:`detect_loops_stacked` of one session, one K15 and one
    gated ``lm_ndt`` launch on the card. Returns ``[K, C]`` fields."""
    k = query_poses.shape[0]
    dev = query_poses.device
    out = detect_loops_stacked(
        _one(kf), query_points[None], query_mask[None], query_poses[None],
        torch.arange(k, device=dev)[None], _queries(query_index, (k,), dev),
        loop_cfg, match_cfg)
    return LoopResult(*(x[0] for x in out))


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
    """Candidate search + the per-query cached verify: the per-scan
    pipeline's path, :func:`detect_loops_stacked` at ``S = K = 1`` without
    the serving knobs (one K15 and one gated ``lm_ndt`` launch on the
    card). Returns a ``[C]`` ``LoopResult``."""
    dev = query_pose.device
    out = detect_loops_stacked(
        _one(kf), query_points[None, None], query_mask[None, None],
        query_pose[None, None], torch.zeros((1, 1), dtype=torch.int64,
                                            device=dev),
        _queries(query_index, (1,), dev), loop_cfg, match_cfg, knobs=False)
    return LoopResult(*(x[0, 0] for x in out))
