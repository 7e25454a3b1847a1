"""Multi-session map merging (config 5): align, fuse graphs, fuse maps.

Port of ``ndtpu/slam/merge.py``. Two sessions with unknown relative
transform become one pose graph and one map:

1. :func:`global_align` places a scan of session B in A's map: every pose
   of a translation x heading grid (``_hypothesis_grid``) runs a short
   batched LM registration (``match_batch``: one ``lm_ndt`` launch on the
   card), the hypotheses are ranked by the total NDT mass of the probe
   scan at their result (K12 ``ndt_sgh_unpacked`` through
   ``ndt.match.score_grad_hess_batch``: one launch per pass), the top
   ``top_k`` are refined with the full budget (a second ``lm_ndt`` launch)
   and re-ranked the same way.
2. :func:`find_inter_session_loops` verifies B keyframes against A's
   cached local tables (the gated verify, one launch; A's tables are built
   by K8a when A ran without loop closure) into inter-session factors.
3. :func:`merge_graphs` appends B's graph to A's with an index offset;
   :func:`merged_map_stats` rebuilds the map from both sessions' keyframe
   scans (one K3 ``halfcell_add`` launch).

``lax.top_k`` (ties to the lower index) becomes a stable sort, and
``argmax`` takes the first maximum, as JAX's does.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ndtpu_torch.config import (GridConfig, LoopConfig, MatchConfig,
                                NDTMapConfig)
from ndtpu_torch.graph import factors as fct
from ndtpu_torch.lie import se2
from ndtpu_torch.loop import closure
from ndtpu_torch.ndt import grid as ndt_grid
from ndtpu_torch.ndt import match as ndt_match
from ndtpu_torch.slam.keyframes import KeyframeStore

__all__ = ["AlignResult", "global_align", "find_inter_session_loops",
           "merge_graphs", "merged_map_stats"]


class AlignResult(NamedTuple):
    transform: torch.Tensor    # [3] pose of session B's frame in A's frame
    score: torch.Tensor        # [] refined NDT score
    converged: torch.Tensor    # [] bool
    grid_scores: torch.Tensor  # [H] coarse total mass of every hypothesis


def _hypothesis_grid(span: float, step: float, n_theta: int, dtype,
                     device="cpu"):
    """``[H, 3]`` hypotheses: translations ``arange(-span, span + step/2,
    step)`` in ``dtype`` squared x ``n_theta`` headings over ``[-pi, pi)``
    by ``jnp.linspace``'s formula ``start (1 - t) + stop t``, ``t = k /
    n_theta``, in f64 and cast to ``dtype``: the reference's values."""
    np_dt = torch.empty((), dtype=dtype).numpy().dtype
    xs = torch.as_tensor(np.arange(-span, span + step / 2, step, dtype=np_dt),
                         device=device)
    t = np.arange(n_theta) / n_theta
    th = torch.as_tensor(-np.pi * (1 - t) + np.pi * t,
                         device=device).to(dtype)
    gx, gy, gt = torch.meshgrid(xs, xs, th, indexing="ij")
    return torch.stack([gx.reshape(-1), gy.reshape(-1), gt.reshape(-1)], -1)


def _descending(x, k: int):
    """The indices of the ``k`` largest entries, ties to the lower index
    (``lax.top_k``)."""
    return torch.sort(x, descending=True, stable=True).indices[:k]


def global_align(map_a: ndt_grid.NDTMap, grid_a: GridConfig, probe_points,
                 probe_mask, span: float = 8.0, step: float = 1.0,
                 n_theta: int = 16, match_cfg: MatchConfig | None = None,
                 coarse_iters: int = 5, top_k: int = 64) -> AlignResult:
    """The pose of a probe scan ``[N, 2]`` (session B's base frame) in map
    A. ``match_cfg.reject_tol`` is always 1e-3 here (the reference's
    override: the throughput default can hand the win to a pi-flipped alias
    in symmetric rooms). All ``H = (2 span / step + 1)^2 n_theta``
    hypotheses run ``coarse_iters`` LM iterations in one batch; the
    ``top_k`` with the largest total mass are refined with the full budget,
    and the converged one of largest total mass wins."""
    mcfg = dataclasses.replace(match_cfg or MatchConfig(), reject_tol=1e-3)
    hyp = _hypothesis_grid(span, step, n_theta, probe_points.dtype,
                           probe_points.device)
    h, n = hyp.shape[0], probe_points.shape[0]
    coarse_cfg = MatchConfig(
        max_iter=coarse_iters, tol=mcfg.tol, d2=mcfg.d2, reject_tol=1e-3,
        init_lambda=mcfg.init_lambda, step_clip=mcfg.step_clip)
    coarse = ndt_match.match_batch(probe_points.expand(h, n, 2),
                                   probe_mask.expand(h, n), map_a, hyp,
                                   grid_a, coarse_cfg)

    # Rank by TOTAL matched mass (the reference's reason: an aliased pose
    # that throws half the scan off-map is graded only on the easy half
    # under the mean score).
    def total_mass(poses):
        return -ndt_match.score_grad_hess_batch(
            poses, probe_points, probe_mask, map_a, grid_a, mcfg)[0]

    mass_c = total_mass(coarse.pose)
    k = min(top_k, h)
    best_idx = _descending(mass_c, k)
    refined = ndt_match.match_batch(probe_points.expand(k, n, 2),
                                    probe_mask.expand(k, n), map_a,
                                    coarse.pose[best_idx], grid_a, mcfg)
    mass_r = total_mass(refined.pose)
    best = torch.argmax(torch.where(refined.converged, mass_r,
                                    torch.full_like(mass_r, -1.0)))
    return AlignResult(transform=refined.pose[best],
                       score=refined.score[best],
                       converged=refined.converged[best],
                       grid_scores=mass_c)


def find_inter_session_loops(kf_a: KeyframeStore, kf_b: KeyframeStore,
                             t_ab, loop_cfg: LoopConfig,
                             match_cfg: MatchConfig, max_queries: int = 64,
                             candidates_per_query: int = 4,
                             innovation_budget: float = 2.0,
                             ndt_cfg: NDTMapConfig | None = None):
    """Inter-session loop factors after :func:`global_align`: up to
    ``max_queries`` evenly spaced live B keyframes, placed in A's frame by
    ``t_ab``, each against its ``candidates_per_query`` nearest live A
    keyframes within ``loop_cfg.radius`` (no index-gap test), verified by
    the cached flat verify with the in-session gates and a flat innovation
    budget. Returns ``(i_a [L], j_b [L], z [L, 3], sqrt_info [L, 3, 3])``
    of the accepted pairs on the keyframes' device (``z``: B keyframe
    ``j_b``'s scan in A keyframe ``i_a``'s frame), for
    ``merge_graphs(inter_factors=...)``."""
    dev = kf_b.poses.device
    if kf_a.tables is None:
        # A ran without in-session loop closure: its local tables, once.
        cap = kf_a.capacity
        tables = torch.zeros(
            (cap,) + closure.local_table_shape(loop_cfg,
                                               match_cfg.compact_table),
            dtype=kf_a.points.dtype, device=kf_a.points.device)
        closure.write_local_tables(
            tables, torch.arange(cap, device=kf_a.points.device),
            torch.ones(cap, dtype=torch.bool, device=kf_a.points.device),
            kf_a.points, kf_a.masks, loop_cfg, ndt_cfg or NDTMapConfig(),
            match_cfg.compact_table)
        kf_a = kf_a._replace(tables=tables)

    live_b = np.flatnonzero(kf_b.live.cpu().numpy())
    if live_b.size == 0:
        return (torch.zeros(0, dtype=torch.long, device=dev),
                torch.zeros(0, dtype=torch.long, device=dev),
                torch.zeros((0, 3), dtype=kf_b.poses.dtype, device=dev),
                torch.zeros((0, 3, 3), dtype=kf_b.poses.dtype, device=dev))
    if live_b.size > max_queries:
        live_b = live_b[np.linspace(0, live_b.size - 1, max_queries)
                        .round().astype(int)]
    sel = torch.as_tensor(live_b, dtype=torch.long, device=dev)    # [K]
    t_ab = torch.as_tensor(t_ab, dtype=kf_b.poses.dtype, device=dev)
    poses_q = se2.compose(t_ab.expand(sel.shape[0], 3), kf_b.poses[sel])

    # Nearest live A keyframes within the radius (no gap test).
    d = torch.linalg.norm(kf_a.poses[None, :, :2] - poses_q[:, None, :2],
                          dim=-1)                                  # [K, A]
    okc = kf_a.live[None, :] & (d <= loop_cfg.radius)
    dm = torch.where(okc, d, torch.full_like(d, float("inf")))
    c = min(candidates_per_query, kf_a.capacity)
    dist, idx = torch.sort(dm, dim=-1, stable=True)
    cands = closure.LoopCandidates(idx=idx[:, :c],
                                   mask=torch.isfinite(dist[:, :c]),
                                   dist=dist[:, :c])
    cfg2 = dataclasses.replace(loop_cfg,
                               max_innovation_base=innovation_budget,
                               max_innovation_per_kf=1e-12)
    loops = closure.verify_candidates_cached_flat(
        kf_a, kf_b.points[sel], kf_b.masks[sel], poses_q, cands, cfg2,
        match_cfg, torch.zeros_like(sel))
    ki, ci = torch.nonzero(loops.accept, as_tuple=True)
    return (loops.j[ki, ci], sel[ki], loops.z[ki, ci],
            loops.sqrt_info[ki, ci])


def merge_graphs(ga: fct.PoseGraph, gb: fct.PoseGraph, t_ab,
                 inter_factors=None, dtype=None) -> fct.PoseGraph:
    """Fuse two pose graphs: B's poses move into A's frame by ``t_ab`` and
    its variables and factors append at A's capacity (B's priors are
    dropped: A's anchors the merged frame). ``inter_factors``: optional
    ``(i_a [K], j_b [K], z [K, 3], sqrt_info [K, 3, 3])`` (``j_b`` in B's
    indexing), appended as between factors. Capacities add."""
    dtype = dtype or ga.poses.dtype
    dev = ga.poses.device
    na, fa = ga.capacity, ga.bet_mask.shape[0]
    t_ab = torch.as_tensor(t_ab, dtype=dtype, device=dev)
    moved = lambda x: se2.compose(t_ab.expand(x.shape[0], 3), x)
    cat = torch.cat
    g = fct.PoseGraph(
        poses=cat([ga.poses, moved(gb.poses)]),
        pose_mask=cat([ga.pose_mask, gb.pose_mask]),
        prior_idx=cat([ga.prior_idx, gb.prior_idx + na]),
        prior_z=cat([ga.prior_z, moved(gb.prior_z)]),
        prior_sqrt_info=cat([ga.prior_sqrt_info, gb.prior_sqrt_info]),
        prior_mask=cat([ga.prior_mask, torch.zeros_like(gb.prior_mask)]),
        bet_i=cat([ga.bet_i, gb.bet_i + na]),
        bet_j=cat([ga.bet_j, gb.bet_j + na]),
        bet_z=cat([ga.bet_z, gb.bet_z]),
        bet_sqrt_info=cat([ga.bet_sqrt_info, gb.bet_sqrt_info]),
        bet_mask=cat([ga.bet_mask, gb.bet_mask]),
        # Append cursors past B's storage, so later appends cannot
        # overwrite its live slots (A's dead tail slots stay dead).
        n_poses=na + gb.n_poses, n_priors=ga.n_priors.clone(),
        n_between=fa + gb.n_between)
    if inter_factors is not None:
        i_a, j_b, z, sq = (torch.as_tensor(np.asarray(x) if not isinstance(
            x, torch.Tensor) else x, device=dev) for x in inter_factors)
        for k in range(i_a.shape[0]):
            g = fct.add_between(g, i_a[k], j_b[k] + na, z[k].to(dtype),
                                sq[k].to(dtype))
    return g


def merged_map_stats(kf_a: KeyframeStore, kf_b: KeyframeStore, t_ab,
                     grid: GridConfig) -> ndt_grid.NDTStats:
    """Joint NDT statistics of both sessions' live keyframe scans (B moved
    by ``t_ab``): one accumulation (one K3 launch on the card)."""
    wa = se2.transform(kf_a.poses, kf_a.points)
    t_ab = torch.as_tensor(t_ab, dtype=kf_b.poses.dtype,
                           device=kf_b.poses.device)
    wb = se2.transform(se2.compose(t_ab.expand_as(kf_b.poses), kf_b.poses),
                       kf_b.points)
    pts = torch.cat([wa.reshape(-1, 2), wb.reshape(-1, 2)])
    msk = torch.cat([(kf_a.masks & kf_a.live[:, None]).reshape(-1),
                     (kf_b.masks & kf_b.live[:, None]).reshape(-1)])
    return ndt_grid.build_stats(pts, msk, grid)
