#!/usr/bin/env python3
"""Where the time goes in the port's windowed and per-scan pipelines, on
the card.

Run from the root of a checkout, on a machine with one CUDA card::

    python3 profile_port.py [--config configs/config3_loop_closure.json]
                            [--seed 0] [--runs 3] [--out FILE.json]
    python3 profile_port.py --scan [--config ...] [--seed 0] [--runs 3]
                            [--out FILE.json]
    python3 profile_port.py --kernels [--seed 0] [--out FILE.json]
    python3 profile_port.py --hot [--seed 0] [--out FILE.json]
    python3 profile_port.py --raycast-sweep [--out FILE.json]
    python3 profile_port.py --finalize-sweep [--seed 0] [--out FILE.json]
    python3 profile_port.py --layouts [--seed 0] [--out FILE.json]
    python3 profile_port.py --serving [--sessions 8] [--max-scans 300]
                            [--runs 3] [--out FILE.json]
    python3 profile_port.py --serving-layouts [--sessions 8]
                            [--max-scans 300] [--seed 0] [--out FILE.json]
    python3 profile_port.py --serving-steps serving_overlap1 [--sessions 8]
                            [--max-scans 300] [--out FILE.json]
    python3 profile_port.py --takes [--out FILE.json]

On box-world draw ``--seed`` (the scenario of ``chip_smoke.py``'s ATE gates,
300 scans, 360 beams), after two warm-up runs of ``run_slam_windowed``:

1. wall time of ``--runs`` synchronized runs through each registration
   route, in turns (kernel, composite, composite, kernel, ...): ``kernel``
   is the port's path (``lm_ndt``, one launch per ``match_batch_packed``
   call), ``composite`` the LM step in torch around K1 (the path before
   ``lm_ndt``), swapped in for ``ndt.match.lm_ndt``;
2. one run of the kernel route with every phase synchronized at its
   edges: the front end (``_window_frontend``), the appends
   (``_wb_appends``) and inside them the K8a table writes and the loop
   detection (``_loop_lanes``: its set-up ``verify_lanes``, K15, and its
   registration and gate ``_verify``; ``_wb_loops`` in checkouts before
   K15) and the loop factors' append (``_append_loops``), the
   smoother (``_wb_smooth``; and inside it, each exclusive of the others,
   the probe and selection (K7a), the local assembly and Cholesky (K7b,
   ``cholesky_ex``), the linearizations (K5) and the PCG solves (K6), the
   rest being host glue) and the map maintenance (``_wb_maps``); then one
   run with ``set_sync_debug_mode("warn")`` inside each ``_window_backend``
   call: its host syncs per window (and of them the smoother's and the
   loop verify's), and where they are;
3. one run of the kernel route under ``torch.profiler`` (and one more
   without it after, ``wall_after_profiler_s``: a profiler session leaves
   the later launches of the process slower): device kernels
   per scan, the union of their busy intervals over the profiled span,
   the largest kernels by device time, ``lm_ndt``'s device time per launch
   (the gated verify's launches apart), and the card time per call of K3
   ``halfcell_add`` (memset, scatter and pool) and K8a ``local_tables``, by
   call shape (K3: the window's scans, the rebuild of every keyframe slot,
   others by point count), and of K4 ``finalize_pack``, by role (the map
   table of a window's first pass, the temporary map's of its second),
   and of the smoother's K5, K6, K7a and K7b by role;
4. with ``--shadow``, one more run in which every ``lm_ndt`` call is also
   made on the composite route and compared bit for bit.

``--serving`` runs only :func:`serving_profile`: stacked multi-session
serving (``configs/config_serving.json``, the sessions of ``python -m
ndtpu_torch.serve``): wall time, the stacked window's stages, host syncs
and launches per window, and the device's busy share.

``--kernels`` runs only :func:`kernel_times` (event and card ms per call of
K4 at three shapes, the standalone K8b at 4 x 16 and 4 x 64, and the
config-3 loop verify as the pipeline calls it). It uses only entry points
that older checkouts of the port also have, so a copy of this script run
from such a checkout's root times that checkout's kernels (a route it
lacks reads null).

``--scan`` runs only :func:`scan_profile`: the per-scan path
(``run_slam``) on the same draw, and its input preparation (K11, K13).

``--takes`` runs only :func:`take_codes` (box-world draws 0-2 at configs
2 and 3 through ``run_slam_windowed``, as ``chip_smoke.py``'s ATE gates
run them: each window's take code, loops and ATE, to compare two
checkouts).

``--hot`` runs only :func:`hot_times` (event and card ms per call of
``lm_ndt`` at the window, verify and gated-verify shapes and at bench.py's
headline shape, of K6, K6b, K5, K6g, K7a, K7b, K11, K10a-c, K12, K13,
K9a-c, K14's three entries and K15 (:func:`k14_k15_calls`, with
``torch.topk`` and copy floors beside them), the slab map's exchange and
finalize together, two floors (an empty kernel, a copy) and the 10k
smoother update, with hashes of their
outputs and of configs 1-3's box-world trajectories and the served
sessions, and bench.py §5's smoother cells, for comparing two commits).

``--finalize-sweep`` runs only :func:`finalize_sweep` (K10b's card ms
per call at each block size, on the slab's records and arrays and the
dense map).

``--raycast-sweep`` runs only :func:`raycast_sweep` (K11's card ms per
call at the CLI corridor's 600 poses x 360 beams, f64, for 1 to 144
segments: the cost per segment and the fixed cost apart; a copy run from
an older checkout times its K11 the same way).

``--layouts`` runs only :func:`layout_times` (event and card ms per call
of K1, ``lm_ndt`` shared and grouped, the gated verify, K3, K4 and K8a in
every table layout: overlap 1, compact rows, both, and the published
one).

``--serving-steps LAYOUT`` runs only :func:`serving_steps` (the serve's
runs in a table layout, and each stacked window step on the card against
the plain f32 step from the same state).

``--serving-layouts`` runs only :func:`serving_layout_times` (event and
card ms per call of K3s and K4s in every table layout at the serving
path's shapes, and of K12, K10a and K10c at both overlaps at config 5's).

Prints one line per section and, last, one JSON object with every number
(also written to ``--out``). Fails without a card: no number here comes
from the CPU.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def card_ms(fn, names=None, reps: int = 20, per_call=None):
    """Card time per call of ``fn`` (ms): the device time of the kernels
    (and memsets, copies) whose names contain one of ``names``, or of all of
    them for None, summed over ``reps`` calls under ``torch.profiler`` after
    a warm-up and divided by ``reps``. A session often records only part of
    the calls' device events (on the H100, in a long process of the port's
    kernels), so a session counts only when it records ``per_call`` such
    operations per call, where the caller knows the design's launches;
    else (an older design's launches may differ, a library's are unknown)
    the most that any session recorded, once a second session has recorded
    as many. That cannot tell a count that every session falls short of
    from a whole one: give ``per_call`` where it is known. Up to ten
    sessions; None when none counts. ``card_ms.counts`` keeps the
    operations each session of the last call recorded, ``card_ms.taken``
    the operations per call of the session whose time it returned (None
    where none counted), ``card_ms.detail`` the last session's by name."""
    import collections

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    counts = card_ms.counts = []
    card_ms.taken = None
    for _ in range(10):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA
              and (names is None or any(n in e.name for n in names))]
        n = len(ev)
        if per_call is not None:
            whole = n == per_call * reps
        else:
            whole = n > 0 and n in counts and n >= max(counts)
        counts.append(n)
        card_ms.detail = sorted(collections.Counter(e.name[:40]
                                                    for e in ev).items())
        if whole:
            card_ms.taken = n / reps
            us = sum(e.time_range.end - e.time_range.start for e in ev)
            return us / 1e3 / reps
    return None


def seeded_stats(grid, seed: int, dev, n_points: int = 400_000):
    """Map statistics on ``grid`` from ``n_points`` clustered points made
    from ``seed`` over the grid's whole extent (K3 on the card)."""
    import numpy as np
    import torch

    from ndtpu_torch.ndt import grid as ndt_grid

    rng = np.random.default_rng(seed + 7)
    lo = np.array([grid.x0, grid.y0])
    span = np.array([grid.nx, grid.ny]) * grid.cell
    centers = lo + rng.uniform(0.02, 0.98, (n_points // 200, 2)) * span
    pts = (centers[rng.integers(0, len(centers), n_points)]
           + rng.normal(0.0, 0.6, (n_points, 2)))
    pts = torch.as_tensor(pts, dtype=torch.float32, device=dev)
    return ndt_grid.halfcell_add(
        ndt_grid.empty_stats(grid, torch.float32, dev), pts.contiguous(),
        torch.ones(n_points, dtype=torch.bool, device=dev), 1.0, grid)


#: K10a's inputs' slab on config 5's grid: rank 0's halo-extended slab of
#: two ranks of 128 columns with a 44-column halo (x_lo = -44, 216
#: columns).
K10A_HALO = 44
#: K10a's kernels per call in the card time: the tiled design's bin, scan
#: and sum, or an older design's memset, scatter and moments (three each).
K10A_NAMES = ["slab_tile", "slab_scatter", "slab_moments", "Memset"]


def k10a_random_points(grid, seed: int, dev, n: int = 368_640):
    """``n`` points around 2,000 centres drawn from ``seed`` in the middle
    40% of ``grid`` (N(0, 0.6 m) about each), all masked: K10a's
    random-order input."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed + 14)
    lo = np.array([grid.x0, grid.y0])
    span = np.array([grid.nx, grid.ny]) * grid.cell
    centers = lo + rng.uniform(0.3, 0.7, (2000, 2)) * span
    pts = torch.as_tensor(centers[rng.integers(0, 2000, n)]
                          + rng.normal(0.0, 0.6, (n, 2)),
                          dtype=torch.float32, device=dev).contiguous()
    return pts, torch.ones(n, dtype=torch.bool, device=dev)


def k10a_scan_points(seed: int, dev, n_beams: int, n_scans: int = 1024):
    """Box-world draw ``seed`` of ``n_scans`` scans of ``n_beams`` beams at
    their true poses, in scan order (``1,024 x 360 = 368,640`` points, the
    box's walls crowded into few cells): K10a's scan-ordered input."""
    from chip_smoke import box_sequence
    from ndtpu_torch.lie import se2

    seq = box_sequence(seed, n_beams, n_scans=n_scans)
    pts = se2.transform(seq.gt_poses, seq.points).reshape(-1, 2)
    return (pts.to(dev).contiguous(),
            seq.mask.reshape(-1).to(dev).contiguous())


def loop_queries(cfg3, seq, kf, seed: int, dev, c: int):
    """A real verification at the end of the box-world lap: 4 queries
    (scans 284-296 at their true poses + noise) x ``c`` candidates of the
    keyframe cache ``kf``, with config 3's loop settings and
    ``max_candidates = c``. Returns ``(loop, (points, mask, poses), query
    indices, candidates)``."""
    import dataclasses

    import numpy as np
    import torch

    from ndtpu_torch.loop import closure

    loop = dataclasses.replace(cfg3.loop, max_candidates=c)
    rng = np.random.default_rng(seed + 3)
    q = torch.tensor([284, 288, 292, 296])
    qpose = (seq.gt_poses[q].double() + torch.as_tensor(
        rng.normal(0.0, [0.1, 0.1, 0.02], (4, 3)))).float().to(dev)
    qidx = q.to(dev)
    cands = closure.find_candidates(kf, qpose, qidx, loop)
    return (loop, (seq.points[q].to(dev), seq.mask[q].to(dev), qpose), qidx,
            cands)


def kernel_times(seed: int, dev) -> dict:
    """Event ms (median of 20 synchronized calls) and card ms (profiler,
    mean of 20) per call of: K4 on the config-2 and config-3 map tables of
    box-world draw ``seed`` (300 scans at their true poses) and on config
    5's 513 x 513 lattice (statistics from ``seed``); the standalone K8b
    (``closure.gate_and_pack``) and the loop verify as the pipeline calls
    it (``closure.verify_candidates_cached_flat``, every device kernel of
    the call) on :func:`loop_queries` x 16 and x 64 candidates of a
    config-3 keyframe cache. Every event time is read before the
    first profiler session (which leaves later launches slower), and once
    more after the last (``ms_after_profiler``). A route this checkout
    refuses (the older gate took at most 32 candidates) reads None with the
    reason."""
    from chip_smoke import box_sequence, box_store, map_stats, time_ms
    from ndtpu_torch.config import PipelineConfig
    from ndtpu_torch.loop import closure
    from ndtpu_torch.ndt import grid as ndt_grid

    calls = {}     # key -> (fn, kernel names for the card time)
    out = {}
    cfg3 = PipelineConfig.from_json(str(ROOT / "configs"
                                        / "config3_loop_closure.json"))
    seq = box_sequence(seed, cfg3.n_beams)
    for name in ("config2_full_sequence", "config3_loop_closure",
                 "config5_multisession"):
        cfg = PipelineConfig.from_json(str(ROOT / "configs"
                                           / f"{name}.json"))
        st = (seeded_stats(cfg.grid, seed, dev) if name.startswith("config5")
              else map_stats(seq, cfg.grid, dev))
        key = f"finalize_pack {name.split('_')[0]}"
        calls[key] = (lambda st=st, cfg=cfg: ndt_grid.finalize_pack(
            st, cfg.ndt, cfg.grid), ["finalize_pack_kernel"])
        out[key] = dict(rows=int(calls[key][0]().shape[0]))
    kf = box_store(cfg3, seq, dev)
    for c in (16, 64):
        loop, (qpts, qmsk, qpose), qidx, cands = loop_queries(
            cfg3, seq, kf, seed, dev, c)
        res, init = closure.verify_registrations(kf, qpts, qmsk, qpose,
                                                 cands, loop, cfg3.match)
        gate = (lambda res=res, cands=cands, loop=loop, init=init,
                qidx=qidx: closure.gate_and_pack(res, cands, loop, init, qidx))
        verify = (lambda cands=cands, loop=loop, q=(qpts, qmsk, qpose),
                  qidx=qidx: closure.verify_candidates_cached_flat(
                      kf, *q, cands, loop, cfg3.match, qidx))
        for key, fn, names in ((f"loop_gate K=4 C={c}", gate,
                                ["loop_gate_kernel"]),
                               (f"verify K=4 C={c}", verify, None)):
            try:
                fn()
            except ValueError as exc:
                out[key] = dict(ms=None, card_ms=None, refused=str(exc))
                continue
            calls[key] = (fn, names)
            out[key] = {}
    for key, (fn, _) in calls.items():
        out[key]["ms"] = time_ms(fn)
    for key, (fn, names) in calls.items():
        out[key]["card_ms"] = card_ms(fn, names, per_call=per_call.get(key))
    for key, (fn, _) in calls.items():
        out[key]["ms_after_profiler"] = time_ms(fn)
    return out


def layout_times(seed: int, dev) -> dict:
    """Event ms (median of 20 synchronized calls) and card ms (profiler,
    mean of 20) per call of the windowed path's kernels in every table
    layout (``kernels.LAYOUTS``), at the main path's shapes, on box-world
    draw ``seed``: K3 at a window insert (8 scans) at both overlaps; per
    layout K4 at the config-2 and config-3 map tables, K1 and ``lm_ndt`` at
    the config-2 window (8 lanes x 360 beams), K8a at a window of 8
    keyframes, ``lm_ndt`` grouped at the config-3 verify shape (64 lanes
    over a 1,024-slot cache in the layout) and the gated verify
    (:func:`loop_queries` x 16 candidates). In a process of its own: card
    times read at the end of ``chip_smoke.py``'s long run are not
    trustworthy (after its many phases the profiler there has read some
    kernels at half and others at twice their time), while in a fresh
    process repeated sessions of one call agree. Every event time is read
    before the first profiler session."""
    import torch

    from chip_smoke import (box_sequence, box_store, layout_cfg,
                            lm_verify_args, lm_window_args, map_stats, snap,
                            time_ms)
    from ndtpu_torch import kernels
    from ndtpu_torch.config import PipelineConfig
    from ndtpu_torch.loop import closure
    from ndtpu_torch.ndt import grid as ndt_grid
    from ndtpu_torch.ndt import match

    cfg2 = PipelineConfig.from_json(str(ROOT / "configs"
                                        / "config2_full_sequence.json"))
    cfg3 = PipelineConfig.from_json(str(ROOT / "configs"
                                        / "config3_loop_closure.json"))
    seq = box_sequence(seed, cfg2.n_beams)
    calls = {}     # key -> (fn, kernel names for the card time)
    w = cfg2.window
    pts = snap(seq.points[:w].to(dev).reshape(-1, 2), 16).contiguous()
    msk = seq.mask[:w].to(dev).reshape(-1).contiguous()
    for g, l in kernels.LAYOUTS:
        cp = l == 4                      # bound into each timed call
        c2, c3 = layout_cfg(cfg2, g, l), layout_cfg(cfg3, g, l)
        v = lambda k: kernels.variant(k, g, l)
        st2 = map_stats(seq, c2.grid, dev)
        st3 = map_stats(seq, c3.grid, dev)
        if l == 8:
            calls[kernels.variant("halfcell_add", g)] = (
                lambda st=st2, c=c2: kernels.halfcell_add(
                    st.n, st.s, st.ss, pts, msk, 1.0, c.grid), None)
        for label, c, st in (("config2", c2, st2), ("config3", c3, st3)):
            calls[f"{v('finalize_pack')} {label}"] = (
                lambda st=st, c=c, cp=cp: kernels.finalize_pack(
                    st.n, st.s, st.ss, c.ndt, c.grid, cp), ["finalize_pack"])
        table = ndt_grid.finalize_pack(st2, c2.ndt, c2.grid, cp)
        a2 = lm_window_args(c2, seq, table, seed, dev, w)
        calls[v("ndt_terms")] = (
            lambda a=a2, c=c2, cp=cp: kernels.ndt_terms(
                *a[:6], c.match.d2, c.match.exp_clip, compact=cp),
            ["ndt_terms"])
        calls[v("lm_ndt")] = (lambda a=a2, c=c2: match.lm_ndt(
            *a[:6], c.match), ["lm_ndt_kernel"])
        lgrid = closure.local_grid_config(c3.loop)
        cache = torch.zeros((w,) + closure.local_table_shape(c3.loop, cp),
                            device=dev)
        slot = torch.arange(w, dtype=torch.int32, device=dev)
        ok = torch.ones(w, dtype=torch.bool, device=dev)
        kp = seq.points[:w].to(dev).contiguous()
        km = seq.mask[:w].to(dev).contiguous()
        calls[v("local_tables")] = (
            lambda cache=cache, lgrid=lgrid, c=c3, cp=cp:
            kernels.local_tables(cache, slot, ok, kp, km, lgrid, c.ndt, cp),
            None)
        kf = box_store(c3, seq, dev)
        k = c3.loop.max_detect_per_window * c3.loop.max_candidates
        a3 = lm_verify_args(c3, seq, kf, seed, dev, k)
        calls[v("lm_ndt_grouped")] = (lambda a=a3, c=c3: match.lm_ndt(
            *a[:6], c.match, a[6]), ["lm_ndt_kernel"])
        loop, (qpts, qmsk, qpose), qidx, cands = loop_queries(
            c3, seq, kf, seed, dev, c3.loop.max_candidates)
        pts_l, msk_l, init, lg, mcfg, flat = gated_lanes(
            kf, qpts, qmsk, qpose, cands, loop, c3.match)
        gate = kernels.LoopGate(cands.mask.contiguous(), qidx.contiguous(),
                                loop.score_gate, loop.max_innovation_base,
                                loop.max_innovation_per_kf,
                                closure._k_budget(loop))
        calls[v("loop_gate_fused")] = (
            lambda kf=kf, a=(pts_l, msk_l, init, lg, mcfg, flat, gate):
            match.match_batch_packed_gated(a[0], a[1], kf.tables, a[2],
                                           a[3], a[4], a[5], a[6]),
            ["lm_ndt_kernel"])
    out = {key: dict(ms=time_ms(fn)) for key, (fn, _) in calls.items()}
    for key, (fn, names) in calls.items():
        out[key]["card_ms"] = card_ms(fn, names)
    return out


def hot_times(seed: int, dev) -> dict:
    """Event ms (median of 20 synchronized calls) and card ms (profiler,
    mean of 20) per call of the two kernels the main path spends the most
    card time in, at its shapes, in a process of its own: ``lm_ndt`` at the
    config-2 window (8 lanes x 360 beams), grouped at the config-3 verify
    (64 lanes over a 1,024-slot cache), gated (:func:`loop_queries` x 16
    candidates, as the pipeline calls it) and at bench.py §1's headline
    shape (``chip_smoke.headline_args``: 4,096 lanes x 720 beams); K6 on
    ``chip_smoke``'s config-3 graph (box-world draw 2 through
    ``run_slam_windowed``, ``smoother_state``), its full solve and its
    0-iteration settled step; K6b on 8 served sessions of 300 scans (the
    smoke's phase 11); K5 on that config-3 graph (whole graph, gathered
    rows, fresh window: ``chip_smoke.k5_calls``) and at config 4's 10,305
    rows; K6g on config 4's 10k graph (lam 1e-3, 250 iterations, tol 1e-5)
    and its 0-iteration set-up; bench.py §5's active 10k
    ``incremental_update``; K7a on the config-3 graph, past the first
    design's shared memory (``chip_smoke.check_k7a_past_block``'s
    25,064-slot graph; ``"raises"`` where an older K7a refuses it), on
    bench.py §5b's 10,064-slot local graph and on the scratch route (the
    25,000 poses in ``chip_smoke.SELECT_SCRATCH_SLOTS``); K10c on both
    ranks' slabs (two
    ranks of 128 columns) and K12 at config 5's 4,624 hypotheses and 64
    refine poses (:func:`k12_inputs`), each at both overlaps, on config 5's
    grid holding the box-world scans at their true poses; K13 at 0.1 m on
    the CLI's 600 corridor scans of 360 beams; K7b on that graph's local
    selection (``chip_smoke.k7b_args``), on the last call of the config-3
    run above (the pipeline's shape) and at 8,192 seeded gathered slots
    (``chip_smoke.K7B_PAST``); K11 at ``chip_smoke.K11_CASES``' corridor
    (f64, f32), serving (f64) and 4,004-segment (f64) inputs (each
    ``"raises"`` where an older kernel refuses it); K10a at rank 0's
    halo-extended slab of config 5's grid (:data:`K10A_HALO`), at both
    overlaps, on the box-world scans at their true poses in scan order
    (:func:`k10a_scan_points`) and on seeded random-order points
    (:func:`k10a_random_points`); K9a and K9b on config 4's 10k graph (P =
    64, lam 1e-3: ``chip_smoke.check_k9b``'s inputs); K9c on both ranks of
    :func:`k9c_graph` split in two (``chip_smoke.k9c_ranks``); K10b and
    the slab map's exchange and finalize together, with an empty kernel and
    a copy beside them (:func:`k10b_calls`); K15 and K14's three entries
    at ``chip_smoke``'s config-2, config-3 and serving cases, with
    ``torch.topk`` and copy floors beside them (:func:`k14_k15_calls`);
    K9a's and
    K9c's library calls (``chip_smoke.k9a_library_call``,
    ``k9c_library_call``; card ms, no hash: float atomics). Beside them each
    launch's outputs' sha256 and, for configs 1, 2 and 3 on box-world
    draws 0-2, the ATE and the trajectory's sha256
    (``run_odometry_windowed``, ``run_slam_windowed``), and the served
    sessions' poses' sha256; then
    bench.py §5's three 10k smoother cells and config 4's ms per LM
    iteration by PCG (``chip_smoke.run_incremental_10k``,
    ``run_config4_pcg``); where the port chooses ``lm_ndt``'s threads per
    lane (``kernels.lm_spread``), also the window's and verify's card ms
    at R = 1-4; for each key the device operations per call in the
    profiler session whose time was taken (``launches_per_call``; None
    with the card ms). It uses only entry
    points older checkouts of the port also have, and ``chip_smoke.py``'s helpers (``compare_port.sh`` copies
    both scripts into the older checkout), so two commits compare in one
    call. Every event time is read before the first profiler session."""
    import dataclasses

    import torch

    from chip_smoke import (CONFIG1, CONFIG2, CONFIG3, CONFIG4, CONFIG5,
                            CORRIDOR_SCANS, ICFG_10K, K6G_10K, K7B_PAST,
                            K11_CASES, cli_inputs,
                            SELECT_PAST_POSES, SELECT_SCRATCH_SLOTS,
                            SERVING, _moved_graph8,
                            box_sequence, box_store, config4_graph,
                            headline_args, k5_calls, k7b_args,
                            k7b_random_args, k9a_library_call,
                            k9c_library_call, k9c_ranks, k11_inputs,
                            lm_verify_args, lm_window_args, local_graph,
                            map_stats, run_config4_pcg, run_incremental_10k,
                            smoother_state, time_ms)
    from ndtpu_torch import kernels, serve
    from ndtpu_torch.config import PipelineConfig, SolverConfig
    from ndtpu_torch.data import preprocess, synth
    from ndtpu_torch.dist import gridmap, schur, slam_dp
    from ndtpu_torch.eval.ate import ate_rmse
    from ndtpu_torch.graph import factors as fct
    from ndtpu_torch.graph import incremental as inc
    from ndtpu_torch.graph import solve as slv
    from ndtpu_torch.graph import supernodal as sn
    from ndtpu_torch.loop import closure
    from ndtpu_torch.ndt import grid as ndt_grid
    from ndtpu_torch.ndt import match
    from ndtpu_torch.slam import pipeline
    from ndtpu_torch.slam.odometry import run_odometry_windowed

    sha = bits_sha
    out = {}
    cfg2 = PipelineConfig.from_json(str(CONFIG2))
    cfg3 = PipelineConfig.from_json(str(CONFIG3))
    seq = box_sequence(seed, cfg2.n_beams)
    calls = {}    # key -> (fn, kernel names for the card time)
    per_call = {}   # key -> launches per call, where the design's is known
    no_hash = set()   # keys whose outputs are not deterministic
    table = ndt_grid.finalize_pack(map_stats(seq, cfg2.grid, dev), cfg2.ndt,
                                   cfg2.grid)
    a2 = lm_window_args(cfg2, seq, table, seed, dev, cfg2.window)
    calls["lm_ndt window B=8"] = (lambda: match.lm_ndt(*a2[:6], cfg2.match),
                                  ["lm_ndt_kernel"])
    kf = box_store(cfg3, seq, dev)
    k = cfg3.loop.max_detect_per_window * cfg3.loop.max_candidates
    a3 = lm_verify_args(cfg3, seq, kf, seed, dev, k)
    calls[f"lm_ndt grouped B={k}"] = (
        lambda: match.lm_ndt(*a3[:6], cfg3.match, a3[6]), ["lm_ndt_kernel"])
    loop, (qpts, qmsk, qpose), qidx, cands = loop_queries(
        cfg3, seq, kf, seed, dev, cfg3.loop.max_candidates)
    calls[f"gated verify K=4 C={cfg3.loop.max_candidates}"] = (
        lambda: closure.verify_candidates_cached_flat(
            kf, qpts, qmsk, qpose, cands, loop, cfg3.match, qidx),
        ["lm_ndt_kernel"])
    ah, mh = headline_args(seed, dev)
    calls[f"lm_ndt headline B={ah[1].shape[0]} N={ah[1].shape[1]}"] = (
        lambda: match.lm_ndt(*ah[:6], mh), ["lm_ndt_kernel"])
    s3 = box_sequence(2, cfg3.n_beams)
    # K7b's calls in this run: the last one is the pipeline-shaped case.
    k7b_seen = []
    assemble = schur.assemble_local

    def assemble_kept(*a):
        k7b_seen[:] = [tuple(x.clone() if isinstance(x, torch.Tensor) else x
                             for x in a)]
        return assemble(*a)

    schur.assemble_local = assemble_kept
    try:
        state, _ = pipeline.run_slam_windowed(
            s3.points.to(dev), s3.mask.to(dev), s3.odom.to(dev), cfg3)
    finally:
        schur.assemble_local = assemble
    sm = smoother_state(state, seed)
    g, scfg = sm.graph, cfg3.solver
    lin = fct.factor_linearize_ref(*fct._graph_args(g), scfg.huber_delta)
    lam = torch.tensor(scfg.init_lambda, dtype=torch.float32, device=dev)
    calls["K6 solve"] = (lambda: slv.pcg_solve(g, lin, None, lam,
                                               scfg.pcg_max_iter,
                                               scfg.pcg_tol), ["pcg_solve"])
    calls["K6 settled step"] = (lambda: slv.pcg_solve(
        g, lin, None, 0.0, 0, scfg.pcg_tol, 1e-8), ["pcg_solve"])
    cfg8 = slam_dp.serving_config(PipelineConfig.from_json(str(SERVING)))
    cfg8 = dataclasses.replace(cfg8, keyframe=dataclasses.replace(
        cfg8.keyframe, capacity=serve.auto_capacity(cfg8, 300)))
    pts8, msk8, odo8, _ = serve.pad_sessions(
        serve.synthetic_sessions(cfg8, 8, 300))
    state8, _ = slam_dp.run_sessions_stacked(pts8.to(dev), msk8.to(dev),
                                             odo8.to(dev), cfg8)
    graph8 = _moved_graph8(state8.graph, seed)
    flat = slam_dp._flat_graph(graph8)
    lin8 = fct.linearize(flat, cfg8.solver.huber_delta)
    lam8 = state8.sm_lam.contiguous()
    n8 = graph8.poses.shape[0]
    calls[f"K6b S={n8}"] = (lambda: slv.pcg_solve_blocked(
        flat, lin8, None, lam8, n8, cfg8.solver.pcg_max_iter),
        ["pcg_solve"])
    # K5 on config 3's graph by mode and at config 4's 10,305 rows; K6g at
    # 10k, its solve and its 0-iteration set-up; bench.py §5's active 10k
    # update; K7a on config 3's graph and past one block's shared memory.
    k5 = k5_calls(sm, cfg3)
    for mode in ("whole graph", "gathered", "fresh window"):
        calls[f"K5 {mode}"] = (k5[mode], ["linearize"])
    g4 = config4_graph(dev, torch.float32, 0, CONFIG4["n_poses"])
    calls["K5 config 4"] = (lambda: fct.linearize(g4), ["linearize"])
    lin4 = fct.linearize(g4)
    lam4 = torch.tensor(K6G_10K["lam"], dtype=torch.float32, device=dev)
    mi, tol = K6G_10K["max_iter"], K6G_10K["tol"]
    calls["K6g 10k solve"] = (lambda: slv.pcg_solve(g4, lin4, None, lam4, mi,
                                                    tol), ["pcg_grid"])
    calls["K6g 10k set-up"] = (lambda: slv.pcg_solve(
        g4, lin4, None, 0.0, 0, tol, 1e-8), ["pcg_grid"])
    icfg = SolverConfig(**ICFG_10K)
    st10 = inc.SmootherState(
        g4, lam4, torch.tensor(float("inf"), device=dev),
        torch.zeros((), dtype=torch.long, device=dev))
    calls["incremental_update 10k active"] = (
        lambda: inc.incremental_update(st10, icfg), None)
    calls["K7a config 3"] = (lambda: inc.local_select(
        g, scfg, g.n_between - 1), ["local_select"])
    g25 = config4_graph(dev, torch.float32, 0, SELECT_PAST_POSES)
    gp, sp = local_graph(g25, SELECT_PAST_POSES + 64)
    calls["K7a past one block"] = (lambda: inc.local_select(gp, icfg, sp),
                                   ["local_select"])
    g10, s10 = local_graph(g4)
    calls["K7a §5b local graph"] = (lambda: inc.local_select(g10, icfg, s10),
                                    ["local_select"])
    gs, ss = local_graph(g25, SELECT_SCRATCH_SLOTS)
    calls["K7a scratch route"] = (lambda: inc.local_select(gs, icfg, ss),
                                  ["local_select"])
    for key in ("K7a config 3", "K7a past one block", "K7a §5b local graph",
                "K7a scratch route"):
        per_call[key] = 1
    # K10c on both ranks' slabs (two ranks of 128 columns) and K12 over
    # config 5's 4,624 hypotheses, at both overlaps, on config 5's grid
    # holding the box-world scans at their true poses; the probe is the
    # scan of largest true x (rank 1 owns most of its beams, as in the
    # smoke's phase 15) at its true pose moved by (0.05, -0.03, 0.01).
    cfg5 = PipelineConfig.from_json(str(CONFIG5))
    s5, probe, probe_m, pose5, k12 = k12_inputs(seed, dev)
    nxl, m5 = cfg5.grid.nx // 2, cfg5.match
    for key, fn in k12.items():
        calls[key] = (fn, ["ndt_sgh_unpacked"])
        per_call[key] = 1
    for gn in (4, 1):
        gr = dataclasses.replace(cfg5.grid, overlap=gn)
        dense = ndt_grid.finalize(map_stats(s5, gr, dev), cfg5.ndt)
        slab = gridmap.dense_to_slab(dense, gr)
        for r in range(2):
            half = [x[:, r * nxl:(r + 1) * nxl].contiguous() for x in slab]
            key = kernels.variant("K10c slab_sgh", gn) + f" rank {r}"
            calls[key] = (lambda h=half, gr=gr, r=r: kernels.slab_sgh(
                pose5, probe, probe_m, *h, gr, r * nxl, m5.d2, m5.exp_clip),
                ["slab_sgh"])
            per_call[key] = 1
    # K10a at rank 0's halo-extended slab on config 5's grid, at both
    # overlaps: the box-world scans at their true poses in scan order and
    # the seeded random-order points.
    k10a_inputs = {"scan-ordered": k10a_scan_points(seed, dev, cfg5.n_beams),
                   "random-order": k10a_random_points(cfg5.grid, seed, dev)}
    for gn in (4, 1):
        gr = dataclasses.replace(cfg5.grid, overlap=gn)
        for label, (p10, m10) in k10a_inputs.items():
            key = kernels.variant("K10a slab_accumulate", gn) + f" {label}"
            calls[key] = (lambda p10=p10, m10=m10, gr=gr:
                          kernels.slab_accumulate(
                              p10, m10, gr, -K10A_HALO,
                              nxl + 2 * K10A_HALO), K10A_NAMES)
            per_call[key] = 3
    # K10b on rank 0's slab (4 x 128 x 256) and on the dense 4 x 65,536
    # map as three arrays (seeded statistics, K3's layout); the slab's
    # finalize as the point-sharded build calls it (the halo exchange at
    # halo 0, then finalize_slab: every device kernel of the two); and
    # beside them the card's floor at these sizes: an empty kernel and a
    # copy of 56 B per cell.
    for key, fn, names, calls_per in k10b_calls(cfg5, seed, dev):
        calls[key] = (fn, names)
        if calls_per is not None:
            per_call[key] = calls_per
        if key.startswith("floor"):
            no_hash.add(key)
    # K15 at config 3's and serving's shapes (the search with its lanes and
    # alone, torch.topk beside them) and K14's three entries at configs 2
    # and 3 and serving, a copy_ of the bytes each writes beside them.
    for key, fn, names, calls_per, hashed in k14_k15_calls(seed, dev):
        calls[key] = (fn, names)
        if calls_per is not None:
            per_call[key] = calls_per
        if not hashed:
            no_hash.add(key)
    # K9a and K9b on config 4's 10k graph (P = 64), on the inputs
    # chip_smoke.check_k9b builds: K9a's outputs and the interior
    # elimination at lam 1e-3.
    plan4 = sn.plan_supernodal(g4, CONFIG4["shards"])
    lin4f = [*lin4[0], *lin4[1]]
    calls["K9a supernodal_assemble 10k"] = (
        lambda: sn.supernodal_assemble(plan4, *lin4f),
        ["supernodal_assemble"])
    h_ii4, h_is4, h_ss4, b_i4, b_s4 = sn.supernodal_assemble(plan4, *lin4f)
    _, _, s_part4, rhs_part4 = sn.interior_parts(
        plan4, h_ii4.clone(), h_is4, b_i4, CONFIG4["lam"])
    calls["K9b schur_reduce 10k"] = (
        lambda: sn.schur_reduce(plan4, s_part4, rhs_part4, h_ss4, b_s4,
                                CONFIG4["lam"]), ["schur_reduce"])
    per_call["K9a supernodal_assemble 10k"] = 1
    per_call["K9b schur_reduce 10k"] = 1
    # K9c on both ranks of K9C_GRAPH split in two, and K9a's and K9c's
    # library calls (their outputs come from float atomics: no hash).
    calls["K9a library call 10k"] = (k9a_library_call(plan4, lin4), None)
    no_hash.add("K9a library call 10k")
    for rank, (t9, lin9, masks9) in enumerate(k9c_ranks(
            k9c_graph(dev), 2)[1]):
        key = f"K9c schur_local_assemble rank {rank}"
        calls[key] = (lambda t9=t9, lin9=lin9, masks9=masks9:
                      schur.schur_local_assemble(t9, K9C_LAM, *lin9,
                                                 *masks9),
                      ["supernodal_assemble_kernel<true"])
        per_call[key] = 1
        calls[f"K9c library call rank {rank}"] = (
            k9c_library_call(t9, lin9, masks9), None)
        no_hash.add(f"K9c library call rank {rank}")
    # K11 at the corridor (f64, f32) and serving shapes, and past the first
    # design's 48 KB (4,004 segments); K7b on the config-3 graph's local
    # selection (the smoke's), the pipeline's own last call and past the
    # first design's shared memory (8,192 gathered slots).
    for name, kind, dt in K11_CASES:
        if name in ("serving_f32", "pillars_f32"):
            continue
        world, poses, ang = k11_inputs(kind, getattr(torch, dt), dev)
        calls[f"K11 {name}"] = (
            lambda w=world, p=poses, a=ang: synth.raycast(w, p, a, 20.0),
            ["raycast"])
        per_call[f"K11 {name}"] = 1
    # K13 at 0.1 m on the CLI's 600 corridor scans of 360 beams.
    cli = cli_inputs(CONFIG3, CORRIDOR_SCANS, dev)
    calls["K13 voxel_downsample 0.1 m"] = (
        lambda: preprocess.voxel_downsample(cli.points, cli.mask, 0.1),
        ["voxel_downsample"])
    per_call["K13 voxel_downsample 0.1 m"] = 1
    ka, _ = k7b_args(sm, cfg3)
    calls["K7b config 3"] = (lambda: schur.assemble_local(*ka),
                             ["local_assemble"])
    if k7b_seen:
        kp = k7b_seen[0]
        calls["K7b pipeline"] = (lambda: schur.assemble_local(*kp),
                                 ["local_assemble"])
    kb = k7b_random_args(dev, **K7B_PAST)
    calls["K7b K=8192"] = (lambda: schur.assemble_local(*kb),
                           ["local_assemble"])
    for key in ("K7b config 3", "K7b pipeline", "K7b K=8192"):
        per_call[key] = 1
    for key, (fn, _) in list(calls.items()):
        try:
            res = fn()
        except ValueError as exc:   # an older K7a, K7b or K11 past its limit
            out[key] = dict(sha256="raises", error=str(exc))
            del calls[key]
            continue
        torch.cuda.synchronize()
        out[key] = {} if key in no_hash else dict(sha256=sha(res))
    out["K6 solve"]["iterations"] = int(calls["K6 solve"][0]()[1])
    out["K6g 10k solve"]["iterations"] = int(calls["K6g 10k solve"][0]()[1])
    out["K6 solve"].update(slots=list(g.poses.shape[:1]) + [g.bet_i.shape[0]],
                           live=[int(g.pose_mask.sum()),
                                 int(g.bet_mask.sum())])
    for key, (fn, _) in calls.items():
        out[key]["ms"] = time_ms(fn)
    traj = {}
    for name, config in (("config1", CONFIG1), ("config2", CONFIG2),
                         ("config3", CONFIG3)):
        cfg = PipelineConfig.from_json(str(config))
        for draw in (0, 1, 2):
            sq = box_sequence(draw, cfg.n_beams)
            p, m, o = (t.to(dev) for t in (sq.points, sq.mask, sq.odom))
            if name == "config1":
                poses = run_odometry_windowed(
                    p, m, o, cfg.grid, cfg.ndt, cfg.match, cfg.keyframe,
                    window=cfg.window, passes=cfg.window_passes,
                    odom_gate=cfg.odom_gate).poses
            else:
                st, outs = pipeline.run_slam_windowed(p, m, o, cfg)
                poses = pipeline.recover_trajectory(st, outs)
            traj[f"{name} draw {draw}"] = dict(
                ate=float(ate_rmse(poses.cpu(), sq.gt_poses)),
                sha256=sha(poses))
    traj["serving 8 x 300"] = dict(sha256=sha((state8.graph.poses,
                                               state8.kf.poses)))
    out["trajectories"] = traj
    # bench.py §5's three 10k smoother cells and config 4 by PCG, through
    # the smoke's phases 8c and 8b (host clock, before any profiler
    # session).
    _, inc10k = run_incremental_10k(dict(g=g4), "", seed)
    _, pcg4 = run_config4_pcg(dev, "")
    out["smoother cells"] = dict(
        incremental_update_ms_10k=inc10k["incremental_update_ms_10k"],
        incremental_settled_ms_10k=inc10k["incremental_settled_ms_10k"],
        incremental_local_ms_10k=inc10k["incremental_local_ms_10k"],
        config4_pcg_ms_per_lm_iteration=pcg4["seconds"] * 1e3
        / max(pcg4["n_iter"], 1),
        config4_pcg_n_iter=pcg4["n_iter"],
        config4_pcg_chi2_final=pcg4["chi2_final"])
    for key, (fn, names) in calls.items():
        out[key]["card_ms"] = card_ms(fn, names, per_call=per_call.get(key))
        out[key]["launches_per_call"] = card_ms.taken
    if hasattr(kernels, "lm_spread"):      # lm_ndt's threads per lane
        saved, spreads = kernels.lm_spread, {}
        try:
            for r in range(1, 5):
                kernels.lm_spread = lambda *a, r=r: r
                spreads[r] = {k: card_ms(calls[k][0], ["lm_ndt_kernel"])
                              for k in ("lm_ndt window B=8",
                                        f"lm_ndt grouped B={k}")}
        finally:
            kernels.lm_spread = saved
        out["lm_ndt card ms at R"] = spreads
    return out


#: K12's refine poses: the probe's true pose moved by seeded uniform
#: jitter of up to these (m, m, rad), as the merge's refine stage sees its
#: top 64 hypotheses.
K12_REFINE = dict(poses=64, jitter=(0.3, 0.3, 0.05))


def k12_inputs(seed: int, dev):
    """K12 at config 5's calls, at both overlaps, on config 5's grid holding
    the box-world scans of draw ``seed`` at their true poses: the probe is
    the scan of largest true x, the coarse call its 4,624 hypotheses
    (``merge._hypothesis_grid``), the refine call :data:`K12_REFINE`'s 64
    poses around its true pose. Returns ``(seq, probe, probe_mask, pose5,
    calls)``: ``pose5`` the probe's true pose moved by (0.05, -0.03, 0.01)
    (K10c's pose), ``calls`` the four launches by their ``--hot`` key."""
    import dataclasses

    import numpy as np
    import torch

    from chip_smoke import CONFIG5, box_sequence, map_stats
    from ndtpu_torch import kernels
    from ndtpu_torch.config import PipelineConfig
    from ndtpu_torch.ndt import grid as ndt_grid
    from ndtpu_torch.slam import merge

    cfg5 = PipelineConfig.from_json(str(CONFIG5))
    s5 = box_sequence(seed, cfg5.n_beams)
    k5 = int(s5.gt_poses[:, 0].argmax())
    probe = s5.points[k5].to(dev).contiguous()
    probe_m = s5.mask[k5].to(dev).float().contiguous()
    true5 = s5.gt_poses[k5:k5 + 1].to(dev)
    pose5 = (true5 + torch.tensor([0.05, -0.03, 0.01],
                                  device=dev)).contiguous()
    jit = np.random.default_rng(seed).uniform(
        -1.0, 1.0, (K12_REFINE["poses"], 3)) * K12_REFINE["jitter"]
    refine = (true5 + torch.as_tensor(jit, dtype=torch.float32,
                                      device=dev)).contiguous()
    hyp = merge._hypothesis_grid(8.0, 1.0, 16, torch.float32, dev)
    m5, calls = cfg5.match, {}
    for gn in (4, 1):
        gr = dataclasses.replace(cfg5.grid, overlap=gn)
        dense = ndt_grid.finalize(map_stats(s5, gr, dev), cfg5.ndt)
        for stage, poses in (("coarse", hyp), ("refine", refine)):
            key = kernels.variant("K12 ndt_sgh_unpacked", gn) + f" {stage}"
            calls[key] = (lambda d=dense, gr=gr, p=poses:
                          kernels.ndt_sgh_unpacked(p, probe, probe_m, *d, gr,
                                                   m5.d2, m5.exp_clip))
    return s5, probe, probe_m, pose5, calls


def sgh_sweep(seed: int, dev) -> dict:
    """K12's card ms per call (profiler, ``per_call=1``) at each R = 1..8
    (``kernels.sgh_spread`` held) at :func:`k12_inputs`' coarse and refine
    calls, both overlaps. Each output's sha256 must be the same at every
    R; the wrapper's own choice is the row "default"."""
    import hashlib

    import torch

    from ndtpu_torch import kernels

    def sha(res) -> str:
        h = hashlib.sha256()
        for x in res:
            h.update(x.contiguous().cpu().view(torch.uint8).numpy().tobytes())
        return h.hexdigest()[:16]

    _, _, _, _, calls = k12_inputs(seed, dev)
    rows, want = {}, {}
    saved = kernels.sgh_spread
    try:
        for r in [None] + list(range(1, 9)):
            if r is not None:
                kernels.sgh_spread = lambda *a, r=r: r
            row = {}
            for key, fn in calls.items():
                h = sha(fn())
                if want.setdefault(key, h) != h:
                    raise RuntimeError(f"{key}: R = {r} changes the output's "
                                       f"bits")
                row[key] = card_ms(fn, ["ndt_sgh_unpacked"], per_call=1)
            rows["default" if r is None else str(r)] = row
            print(f"[profile] sgh_spread {r}: {row}", flush=True)
    finally:
        kernels.sgh_spread = saved
    rows["sha256"] = want
    return rows


def k10b_calls(cfg5, seed: int, dev):
    """K10b's ``--hot`` calls on config 5's grid, ``(key, fn, kernel
    names, device operations per call or None)``: ``finalize_cells`` as
    three arrays on rank 0's slab of two (4 x 128 x 256, from
    :func:`seeded_stats` in the slab layout, each array contiguous) and on
    the dense 4 x 65,536 map (:func:`seeded_stats` itself); ``slab_finalize``
    (``gridmap._exchange(None, ext, 0, 128)`` then ``finalize_slab``,
    every device kernel, on rank 0's statistics of
    :func:`k10a_random_points`); the floors: an empty kernel
    (``torch.cuda._sleep(0)``) and a ``copy_`` of 28 B per cell each way
    on the slab's and the map's cells. It uses only entry points older
    checkouts of the port also have."""
    import torch

    from ndtpu_torch.dist import gridmap
    from ndtpu_torch.ndt import grid as ndt_grid

    grid, ndt = cfg5.grid, cfg5.ndt
    nxl = grid.nx // 2
    dense = seeded_stats(grid, seed, dev)
    slab = ndt_grid.NDTStats(*(x[:, :nxl].contiguous() for x in
                               gridmap.dense_to_slab(dense, grid)))
    pts, msk = k10a_random_points(grid, seed, dev)
    ext = gridmap.slab_accumulate(pts, msk, grid, 0, nxl)
    out = [("K10b finalize_cells slab", lambda: ndt_grid.finalize(slab, ndt),
            ["finalize_cells"], 1),
           ("K10b finalize_cells dense",
            lambda: ndt_grid.finalize(dense, ndt), ["finalize_cells"], 1),
           ("slab_finalize", lambda: gridmap.finalize_slab(
               gridmap._exchange(None, ext, 0, nxl), ndt), None, None),
           ("floor empty kernel", lambda: torch.cuda._sleep(0), None, 1)]
    for label, st in (("slab", slab), ("dense", dense)):
        src = torch.rand(7 * st.n.numel(), device=dev)
        dst = torch.empty_like(src)
        out.append((f"floor copy_ 56 B a cell {label}",
                    lambda src=src, dst=dst: dst.copy_(src), None, 1))
    return out


def k14_k15_calls(seed: int, dev):
    """K15's and K14's ``--hot`` calls, ``(key, fn, kernel names, device
    operations per call or None, hashed)``: K15 ``loop_lanes`` at
    ``chip_smoke.K15_CASES``' config-3 and serving cases, the search with
    its lanes and the search alone, each with its library call beside it
    (``chip_smoke.k15_library_call``: ``torch.topk`` of the masked
    distances; its order among equal distances is not guaranteed, so not
    hashed); K14's append, loop and row entries at ``K14_CASES``' config-2,
    config-3 and serving cases (the loop entry where the case has lanes,
    the row entry at serving's refresh shape: ``chip_smoke.check_k14``'s
    inputs), each with a ``copy_`` of the bytes its outputs hold beside it
    (the copy floor, L2-warm). It uses only entry points older checkouts of
    the port also have."""
    import torch

    from chip_smoke import (K14_CASES, K15_CASES, k14_inputs,
                            k14_loop_inputs, k14_rows_inputs,
                            k15_inputs, k15_library_call)
    from ndtpu_torch import kernels

    out = []
    for i, case in enumerate(K15_CASES):
        label, s, k, c, cap, n, stride, radius, gap, ties, full = case
        if label not in ("config3", "serving"):
            continue
        a = k15_inputs(seed + i, dev, s, k, c, cap, n, stride, radius, gap,
                       ties, full)
        out += [(f"K15 loop_lanes {label}", lambda a=a: kernels.loop_lanes(
                    *a), ["loop_lanes_kernel"], 1, True),
                (f"K15 loop_lanes search alone {label}",
                 lambda a=a: kernels.loop_lanes(*a[:-1], lanes=False),
                 ["loop_lanes_kernel"], 1, True),
                (f"K15 library call {label}", k15_library_call(a), None,
                 None, False)]

    def floor(tensors):
        n = sum(t.numel() * t.element_size() for t in tensors) // 4
        src = torch.rand(n, device=dev)
        dst = torch.empty_like(src)
        return lambda: dst.copy_(src)

    for i, (label, s, cap, lanes, _) in enumerate(K14_CASES):
        if label == "overflow":
            continue
        a = k14_inputs(seed + i, dev, s, cap, False)
        res = kernels.window_append(*a)
        out += [(f"K14 window_append {label}",
                 lambda a=a: kernels.window_append(*a),
                 ["window_append_kernel"], 1, True),
                (f"floor copy_ K14 window_append {label}", floor(res[:15]),
                 None, 1, False)]
        if lanes:
            la = k14_loop_inputs(seed + i, res, lanes)
            lres = kernels.loop_append(*la, 8)
            out += [(f"K14 loop_append {label}",
                     lambda la=la: kernels.loop_append(*la, 8),
                     ["loop_append_kernel"], 1, True),
                    (f"floor copy_ K14 loop_append {label}",
                     floor(lres[:6]), None, 1, False)]
        if label == "serving":
            ra = k14_rows_inputs(seed + i, res)
            out += [("K14 rows_set serving",
                     lambda ra=ra: kernels.rows_set(*ra),
                     ["rows_set_kernel"], 1, True),
                    ("floor copy_ K14 rows_set serving", floor(ra[:1]), None,
                     1, False)]
    return out


#: --finalize-sweep's threads per block (``kernels.finalize_cells_threads``).
FINALIZE_THREADS = (32, 64, 128, 256, 512)


def finalize_sweep(seed: int, dev) -> dict:
    """K10b's card ms per call (profiler, ``per_call=1``) at each block
    size of :data:`FINALIZE_THREADS` on config 5's grid: rank 0's slab as
    the exchange's records (``_exchange`` of :func:`k10a_random_points`'
    statistics, the main path's layout) and as three arrays, and the dense
    4 x 65,536 map (:func:`seeded_stats`). Each output's sha256 must be the
    same at every size; the default's row is marked."""
    import hashlib

    import torch

    from chip_smoke import CONFIG5
    from ndtpu_torch import kernels
    from ndtpu_torch.config import PipelineConfig
    from ndtpu_torch.dist import gridmap
    from ndtpu_torch.ndt import grid as ndt_grid

    cfg5 = PipelineConfig.from_json(str(CONFIG5))
    grid, ndt = cfg5.grid, cfg5.ndt
    nxl = grid.nx // 2
    pts, msk = k10a_random_points(grid, seed, dev)
    rec = gridmap._exchange(None, gridmap.slab_accumulate(pts, msk, grid, 0,
                                                          nxl), 0, nxl)
    arrays = ndt_grid.NDTStats(*(x.contiguous() for x in rec))
    dense = seeded_stats(grid, seed, dev)
    calls = {"slab records": rec, "slab arrays": arrays, "dense": dense}
    assert kernels.finalize_inputs(*rec)[0] == "records"

    def sha(res) -> str:
        h = hashlib.sha256()
        for x in res:
            h.update(x.contiguous().cpu().view(torch.uint8).numpy().tobytes())
        return h.hexdigest()[:16]

    out, want = {}, {}
    try:
        for threads in (0,) + FINALIZE_THREADS:
            kernels.finalize_cells_threads(threads)
            row = {}
            for key, st in calls.items():
                fn = lambda st=st: ndt_grid.finalize(st, ndt)
                h = sha(fn())
                if want.setdefault(key, h) != h:
                    raise RuntimeError(f"{key}: {threads} threads change "
                                       f"the output's bits")
                row[key] = card_ms(fn, ["finalize_cells"], per_call=1)
            name = (f"default {kernels.FINALIZE_THREADS}" if threads == 0
                    else str(threads))
            out[name] = row
            print(f"[profile] finalize threads {name}: {row}", flush=True)
    finally:
        kernels.finalize_cells_threads()
    out["sha256"] = want
    return out


#: K9c's --hot graph: a seeded 2,048-pose Manhattan world (config 5's
#: merged graph is about as large), split over two ranks, at lam 1e-3.
K9C_POSES, K9C_SEED, K9C_LAM = 2048, 5, 1e-3


def k9c_graph(dev):
    """:data:`K9C_POSES` poses of ``manhattan_world`` from :data:`K9C_SEED`
    (loop_prob 0.1, poses jittered by N(0, 0.05) from the same seed), f32 on
    ``dev``."""
    import numpy as np
    import torch

    from ndtpu_torch.data import g2o

    data = g2o.manhattan_world(K9C_POSES, seed=K9C_SEED, loop_prob=0.1)
    data = data._replace(poses=data.poses + np.random.default_rng(
        K9C_SEED).normal(0, 0.05, data.poses.shape))
    return g2o.to_graph(data, torch.float32, device=dev)


#: --assemble-sweep's launch shapes: (threads per block, staged floats per
#: unit, blocks per SM of a persistent grid or 0 for one block per unit).
ASSEMBLE_SHAPES = [(t, c, b) for t in (64, 128, 256)
                   for c in (1024, 2048, 4096, 8192, 12288)
                   for b in (0, min(32, 2048 // t))]


def assemble_sweep(dev) -> dict:
    """K9a's and K9c's card ms per call (profiler, ``per_call=1``) at each
    launch shape of :data:`ASSEMBLE_SHAPES` (``kernels.
    supernodal_assemble_shape``): K9a on config 4's 10k graph (P = 64), K9c
    on both ranks of :func:`k9c_graph` split in two; each output's sha256
    must be the same at every shape. The default shape's row is marked.
    Beside them, one ``zero_`` of as many floats as each call writes (the
    store stream alone)."""
    import hashlib

    import torch

    from chip_smoke import CONFIG4, config4_graph, k9c_ranks
    from ndtpu_torch import kernels
    from ndtpu_torch.dist import schur
    from ndtpu_torch.graph import factors as fct
    from ndtpu_torch.graph import supernodal as sn

    g4 = config4_graph(dev, torch.float32, 0, CONFIG4["n_poses"])
    plan4 = sn.plan_supernodal(g4, CONFIG4["shards"])
    (ai, aj, r), (ap, rp) = fct.linearize(g4)
    calls = {"K9a 10k": (lambda: sn.supernodal_assemble(plan4, ai, aj, r, ap,
                                                        rp),
                         ["supernodal_assemble"])}
    for rank, (t, lin, masks) in enumerate(k9c_ranks(k9c_graph(dev), 2)[1]):
        calls[f"K9c rank {rank}"] = (
            lambda t=t, lin=lin, masks=masks: schur.schur_local_assemble(
                t, K9C_LAM, *lin, *masks),
            ["supernodal_assemble_kernel<true"])

    def sha(res) -> str:
        h = hashlib.sha256()
        for x in res:
            h.update(x.contiguous().cpu().view(torch.uint8).numpy().tobytes())
        return h.hexdigest()[:16]

    out, want = {}, {}
    try:
        for shape in [(0, 0, 0)] + ASSEMBLE_SHAPES:
            kernels.supernodal_assemble_shape(*shape)
            row = {}
            for key, (fn, names) in calls.items():
                h = sha(fn())
                if want.setdefault(key, h) != h:
                    raise RuntimeError(f"{key}: shape {shape} changes the "
                                       f"output's bits")
                row[key] = card_ms(fn, names, per_call=1)
            out["default" if shape == (0, 0, 0) else str(shape)] = row
            print(f"[profile] assemble shape {shape}: {row}", flush=True)
    finally:
        kernels.supernodal_assemble_shape()
    out["sha256"] = want
    # The store stream alone: one fill of each call's outputs (no kernel of
    # the port; the floor a single write of those bytes reaches).
    for key, (fn, _) in calls.items():
        n = sum(x.numel() for x in fn())
        buf = torch.empty(n, device=dev)
        out.setdefault("fill", {})[key] = card_ms(lambda buf=buf: buf.zero_(),
                                                  None, per_call=1)
    print(f"[profile] fill of the outputs: {out['fill']}", flush=True)
    return out


def raycast_sweep(dev) -> dict:
    """K11's card ms per call (profiler, ``per_call=1``) at the CLI
    corridor's 600 poses x 360 beams in f64 (``chip_smoke.k11_inputs``)
    against the first 1, 4, 9, 17, 36, 72 and 144 segments of the
    corridor's 36, repeated: the slope is the cost per segment, the
    intercept the fixed cost (launch, sin/cos, staging, stores)."""
    import torch

    from chip_smoke import k11_inputs
    from ndtpu_torch.data import synth

    world, poses, ang = k11_inputs("corridor", torch.float64, dev)
    seg = world.segments
    out = {}
    for s in (1, 4, 9, 17, 36, 72, 144):
        reps = -(-s // seg.shape[0])
        w = synth.World(torch.cat([seg] * reps)[:s].contiguous())
        out[f"S={s}"] = card_ms(lambda w=w: synth.raycast(w, poses, ang,
                                                          20.0),
                                ["raycast"], per_call=1)
    return out


def serving_layout_times(seed: int, dev, sessions: int, n_scans: int
                         ) -> dict:
    """Event ms (median of 20 synchronized calls) and card ms (profiler,
    mean of 20) per call of the kernels that stacked serving and config 5
    run in every table layout, in a process of its own (see
    :func:`layout_times`): K3s at both overlaps at the serving path's
    window and refresh shapes (and the overlap-1 rebuild of each session's
    keyframes) and K4s in each layout of ``kernels.LAYOUTS``, on the state
    of one stacked run of ``sessions`` x ``n_scans`` of
    ``configs/config_serving.json``; K12 at config 5's 4,624 hypotheses,
    K10a at a halo-extended slab of 368,640 points and K10c at one pose,
    each at both overlaps on a map of ``configs/config5_multisession.json``
    from ``seed``. Every event time is read before the first profiler
    session."""
    import dataclasses

    import numpy as np
    import torch

    from chip_smoke import CONFIG5, box_sequence, time_ms
    from ndtpu_torch import kernels
    from ndtpu_torch.config import PipelineConfig
    from ndtpu_torch.dist import gridmap
    from ndtpu_torch.lie import se2
    from ndtpu_torch.ndt import grid as ndt_grid
    from ndtpu_torch.slam import merge

    inputs, cfg, _ = serving_inputs(dev, sessions, n_scans)
    state8, _ = serving_once(inputs, cfg)[1]
    kf, s = state8.kf, sessions
    w, m_top = cfg.window, cfg.refresh_top_m
    win = se2.transform(kf.poses[:, :w], kf.points[:, :w]).reshape(s, -1, 2)
    win_m = kf.masks[:, :w].reshape(s, -1).contiguous()
    old = se2.transform(kf.poses[:, :m_top], kf.points[:, :m_top])
    new = se2.transform(kf.poses[:, :m_top] + torch.tensor(
        [0.02, -0.01, 0.003], device=dev), kf.points[:, :m_top])
    ref_pts = torch.cat([old.reshape(s, -1, 2), new.reshape(s, -1, 2)],
                        1).contiguous()
    ref_m = kf.masks[:, :m_top].reshape(s, -1).repeat(1, 2).contiguous()
    half = ref_pts.shape[1] // 2
    wts = torch.cat([-torch.ones(s, half, device=dev),
                     torch.ones(s, half, device=dev)], 1).contiguous()
    world = se2.transform(kf.poses, kf.points).reshape(s, -1, 2).contiguous()
    live = (kf.masks & kf.live[..., None]).reshape(s, -1).contiguous()
    g1 = dataclasses.replace(cfg.grid, overlap=1)
    empty1 = ndt_grid.NDTStats(*(x.expand((s,) + x.shape).contiguous()
                                 for x in ndt_grid.empty_stats(
                                     g1, torch.float32, dev)))
    stats = {4: state8.stats,
             1: ndt_grid.halfcell_add_stacked(empty1, world, live, 1.0, g1)}
    grids = {4: cfg.grid, 1: g1}
    calls = {}
    for g in (4, 1):
        st, gr = stats[g], grids[g]
        k3s = kernels.variant("halfcell_add_stacked", g)
        for label, p, m, wt in (("window", win.contiguous(), win_m, 1.0),
                                ("refresh", ref_pts, ref_m, wts)):
            calls[f"{k3s} {label}"] = (
                lambda st=st, gr=gr, p=p, m=m, wt=wt:
                kernels.halfcell_add_stacked(st.n, st.s, st.ss, p, m, wt, gr),
                ["halfcell", "cell_moments", "Memset"])
    calls[kernels.variant("halfcell_add_stacked", 1) + " rebuild"] = (
        lambda: kernels.halfcell_add_stacked(*empty1, world, live, 1.0, g1),
        ["halfcell", "cell_moments", "Memset"])
    for g, lanes in kernels.LAYOUTS:
        st, gr = stats[g], grids[g]
        calls[kernels.variant("finalize_pack_stacked", g, lanes)] = (
            lambda st=st, gr=gr, cp=lanes == 4: kernels.finalize_pack_stacked(
                st.n, st.s, st.ss, cfg.ndt, gr, cp), ["finalize_pack"])
    # Config 5's kernels on a seeded map of its grid, at both overlaps.
    cfg5 = PipelineConfig.from_json(str(CONFIG5))
    seq = box_sequence(seed, cfg5.n_beams)
    probe = seq.points[0].to(dev).contiguous()
    probe_m = seq.mask[0].to(dev).contiguous()
    hyp = merge._hypothesis_grid(8.0, 1.0, 16, torch.float32, dev)
    pts5, msk5 = k10a_random_points(cfg5.grid, seed, dev)
    nxl, halo = cfg5.grid.nx // 2, K10A_HALO
    pose1 = torch.zeros((1, 3), device=dev)
    for g in (4, 1):
        gr = dataclasses.replace(cfg5.grid, overlap=g)
        m5 = ndt_grid.finalize(seeded_stats(gr, seed, dev), cfg5.ndt)
        slab = gridmap.SlabMap(*(x[:, :nxl].contiguous() for x in
                                 gridmap.dense_to_slab(m5, gr)))
        calls[kernels.variant("ndt_sgh_unpacked", g) + " coarse"] = (
            lambda m5=m5, gr=gr: kernels.ndt_sgh_unpacked(
                hyp, probe, probe_m.float(), *m5, gr, cfg5.match.d2,
                cfg5.match.exp_clip), ["ndt_sgh_unpacked"])
        calls[kernels.variant("slab_accumulate", g) + " halo-extended"] = (
            lambda gr=gr: kernels.slab_accumulate(pts5, msk5, gr, -halo,
                                                  nxl + 2 * halo),
            K10A_NAMES)
        calls[kernels.variant("slab_sgh", g) + " B=1"] = (
            lambda slab=slab, gr=gr: kernels.slab_sgh(
                pose1, probe, probe_m.float(), *slab, gr, 0, cfg5.match.d2,
                cfg5.match.exp_clip), ["slab_sgh"])
    out = {key: dict(ms=time_ms(fn)) for key, (fn, _) in calls.items()}
    for key, (fn, names) in calls.items():
        out[key]["card_ms"] = card_ms(fn, names)
    return out


def serving_steps(dev, layout: str, sessions: int, n_scans: int) -> dict:
    """Stacked serving in a table layout of ``chip_smoke.SERVING_LAYOUT_RUNS``
    (or ``published``): each session's ATE and loops in the runs ``python
    -m ndtpu_torch.serve`` makes (the inputs as given, then moved by its
    three 1e-6 m offsets), and, on the last run's inputs, every stacked
    window step on the card against the plain f32 step on the host from a
    copy of the same state: the largest pose and graph difference per
    window and session, whether the keyframe and loop decisions differ,
    and the card's per-scan pose error against the truth in the session's
    start frame (the drift). A kernel fault shows as a window far apart;
    roundoff near an LM or gate tie as small differences (ROADMAP
    C-w1b)."""
    import dataclasses
    import tempfile

    import numpy as np
    import torch

    from chip_smoke import SERVING, SERVING_LAYOUT_RUNS, layout_json
    from ndtpu_torch import serve
    from ndtpu_torch.config import PipelineConfig
    from ndtpu_torch.dist import slam_dp
    from ndtpu_torch.eval.ate import ate_rmse
    from ndtpu_torch.lie import se2
    from ndtpu_torch.slam import pipeline

    changes = dict(SERVING_LAYOUT_RUNS).get(layout, {})
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "config.json"
        path.write_text(json.dumps(layout_json(SERVING, changes)))
        cfg = PipelineConfig.from_json(str(path))
    scfg = slam_dp.serving_config(cfg)
    scfg = dataclasses.replace(scfg, keyframe=dataclasses.replace(
        scfg.keyframe, capacity=serve.auto_capacity(cfg, n_scans)))
    seqs = serve.synthetic_sessions(cfg, sessions, n_scans, device=dev)
    points, mask, odom, _ = serve.pad_sessions(seqs)
    rng = np.random.default_rng(cfg.seed)
    shifts = [0.0] + [float(rng.normal(0.0, 1e-6)) for _ in range(3)]
    runs = []
    for sh in shifts:
        st, outs = slam_dp.run_sessions_stacked(points + sh, mask, odom,
                                                scfg)
        traj = serve.trajectories(st, outs).cpu()
        runs.append(dict(shift_m=sh, loops=st.n_loops.tolist(), ate_m=[
            float(ate_rmse(traj[k], seqs[k].gt_poses.to(traj)))
            for k in range(sessions)]))
        print(f"[profile] serving {layout} shift {sh:+.3e} m: ATE "
              + " ".join(f"{a:.4f}" for a in runs[-1]["ate_m"])
              + f"; loops {runs[-1]['loops']}", flush=True)

    def to_cpu(x):
        if isinstance(x, torch.Tensor):
            return x.detach().cpu().clone()
        if isinstance(x, tuple):
            items = [to_cpu(y) for y in x]
            return type(x)(*items) if hasattr(x, "_fields") else tuple(items)
        return x

    pts = points + shifts[-1]
    state = slam_dp.init_sessions(pts[:, 0], mask[:, 0], scfg)
    wins = [pipeline.window_inputs(pts[i], mask[i], odom[i], scfg.window)
            for i in range(sessions)]
    pts_w, msk_w, odo_w = (torch.stack(f, 1).contiguous()
                           for f in list(zip(*wins))[:3])
    gt = torch.stack([q.gt_poses for q in seqs]).to(dev)
    truth = se2.between(gt[:, :1].expand_as(gt), gt)   # the start frame
    carry, windows = (state, state.pose), []
    for k in range(pts_w.shape[0]):
        cpu_state, cpu_lkr = to_cpu(carry[0]), to_cpu(carry[1])
        card, out_c = slam_dp._stacked_window_step(
            carry[0], carry[1], pts_w[k], msk_w[k], odo_w[k], scfg)
        plain, out_p = slam_dp._stacked_window_step(
            cpu_state, cpu_lkr, pts_w[k].cpu(), msk_w[k].cpu(),
            odo_w[k].cpu(), scfg)
        d = out_c.pose.cpu() - out_p.pose
        d[..., 2] = torch.remainder(d[..., 2] + np.pi, 2 * np.pi) - np.pi
        gd = card[0].graph.poses.cpu() - plain[0].graph.poses
        w = scfg.window
        ref = truth[:, 1 + k * w:1 + (k + 1) * w, :2]
        drift = (out_c.pose[:, :ref.shape[1], :2] - ref).norm(dim=-1)
        windows.append(dict(
            drift_m=drift.amax(1).tolist(),
            pose_diff=d.abs().amax(dim=(1, 2)).tolist(),
            graph_diff=gd.abs().amax(dim=(1, 2)).tolist(),
            keyframes_differ=(out_c.is_keyframe.cpu()
                              != out_p.is_keyframe).any(1).tolist(),
            loops_card=out_c.n_loops_new.sum(1).tolist(),
            loops_plain=out_p.n_loops_new.sum(1).tolist()))
        carry = card
    worst = max(max(w["pose_diff"]) for w in windows)
    print(f"[profile] serving {layout}: drift per window (m, session by "
          f"session): " + "; ".join(
              f"{k} " + " ".join(f"{x:.3f}" for x in w["drift_m"])
              for k, w in enumerate(windows)))
    print(f"[profile] serving {layout}: card window steps vs the plain f32 "
          f"steps from the same states, largest pose difference {worst:.3e} "
          f"m; windows over 1e-3 m: "
          + str([(k, [round(x, 5) for x in w["pose_diff"]])
                 for k, w in enumerate(windows)
                 if max(w["pose_diff"]) > 1e-3]))
    return dict(layout=layout, runs=runs, windows=windows,
                max_window_pose_diff_m=worst)


def shadow_run(inputs, cfg):
    """One run of the kernel route in which every ``lm_ndt`` call is also
    made on the composite route from the same inputs: calls, lanes, lanes
    whose result is not bit-equal, and the largest pose difference."""
    import torch

    from chip_smoke import lm_composite
    from ndtpu_torch.ndt import match

    fused, tally = match.lm_ndt, defaultdict(float)

    def both(init_poses, px, py, mask_f, table, grid, cfg_m, group=None):
        out = fused(init_poses, px, py, mask_f, table, grid, cfg_m, group)
        ref = lm_composite(init_poses, px, py, mask_f, table, grid, cfg_m,
                           group)
        same = torch.ones_like(out.converged)
        for a, b in zip(out, ref):
            same &= (a == b).reshape(a.shape[0], -1).all(-1)
        tally["calls"] += 1
        tally["lanes"] += out.converged.numel()
        tally["lanes_differ"] += int((~same).sum())
        tally["n_iter_differ"] += int((out.n_iter != ref.n_iter).sum())
        tally["max_pose_diff"] = max(tally["max_pose_diff"], float(
            (out.pose - ref.pose).abs().max()))
        return out

    match.lm_ndt = both
    try:
        wall, state, traj = run_once(inputs, cfg)
    finally:
        match.lm_ndt = fused
    return dict(tally), traj


def device_events(prof):
    """A profile's device events ``[(start, end, name)]`` in time order,
    ``{name: [count, ms]}``, and the union of their intervals (us)."""
    from torch.autograd import DeviceType

    events, by_name = [], defaultdict(lambda: [0, 0.0])
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        a, b = e.time_range.start, e.time_range.end
        events.append((a, b, e.name))
        by_name[e.name][0] += 1
        by_name[e.name][1] += (b - a) / 1e3
    events.sort()
    busy, end = 0.0, None
    for a, b, _ in events:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return events, by_name, busy


def run_once(inputs, cfg):
    import torch

    from ndtpu_torch.slam import pipeline

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, outs = pipeline.run_slam_windowed(*inputs, cfg)
    traj = pipeline.recover_trajectory(state, outs)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, state, traj


def bits_sha(x) -> str:
    """The first 16 hex digits of the sha256 of every tensor in ``x`` (a
    tensor, or nested tuples, lists and dicts of them), their bytes in
    order: equal digests mean equal bits."""
    import hashlib

    import torch

    def tensors(y):
        if isinstance(y, torch.Tensor):
            yield y
        elif isinstance(y, dict):
            for v in y.values():
                yield from tensors(v)
        elif isinstance(y, (tuple, list)):
            for v in y:
                yield from tensors(v)

    h = hashlib.sha256()
    for t in tensors(x):
        h.update(t.detach().contiguous().cpu().reshape(-1).view(
            torch.uint8).numpy().tobytes())
    return h.hexdigest()[:16]


def take_codes(dev) -> dict:
    """Box-world draws 0-2 (made on the CPU, as ``chip_smoke.ate_gate``
    makes them) at configs 2 and 3 through ``run_slam_windowed`` on the
    card: per draw the smoother's take code of each window
    (``chip_smoke.window_takes``), the loops, the ATE and the
    :func:`bits_sha` of the trajectory and of the final state."""
    import torch

    from chip_smoke import CONFIG2, CONFIG3, box_sequence, window_takes
    from ndtpu_torch.config import PipelineConfig
    from ndtpu_torch.eval.ate import ate_rmse
    from ndtpu_torch.slam import pipeline

    out = {}
    for config in (CONFIG2, CONFIG3):
        cfg = PipelineConfig.from_json(str(config))
        for seed in (0, 1, 2):
            seq = box_sequence(seed, cfg.n_beams)
            p, m, o = (t.to(dev) for t in (seq.points, seq.mask, seq.odom))
            state, outs = pipeline.run_slam_windowed(p, m, o, cfg)
            traj = pipeline.recover_trajectory(state, outs)
            torch.cuda.synchronize()
            row = dict(takes=window_takes(outs, cfg.window),
                       loops=int(state.n_loops),
                       ate_m=float(ate_rmse(traj.cpu(), seq.gt_poses)),
                       traj_sha=bits_sha(traj), state_sha=bits_sha(state))
            out[f"{config.stem} draw {seed}"] = row
            print(f"[profile] takes {config.stem} draw {seed}: {row}")
    return out


#: The smoother's parts (``_wb_smooth``), each timed exclusive of the parts
#: nested in it; what is left of ``_wb_smooth`` is the host glue. Functions
#: an older checkout lacks are skipped, and its own names (the last four)
#: are timed under the same labels.
SMOOTHER_PARTS = (("ndtpu_torch.graph.incremental", "local_select",
                   "probe/select"),
                  ("ndtpu_torch.graph.incremental", "_local_step",
                   "assembly + Cholesky"),
                  ("ndtpu_torch.graph.factors", "factor_linearize",
                   "linearize"),
                  ("ndtpu_torch.graph.incremental", "fresh_residual_max",
                   "linearize"),
                  ("ndtpu_torch.graph.solve", "pcg_solve", "PCG"),
                  ("ndtpu_torch.graph.incremental", "_active_probe",
                   "probe/select"),
                  ("ndtpu_torch.graph.incremental", "_local_system",
                   "assembly + Cholesky"),
                  ("ndtpu_torch.graph.factors", "linearize", "linearize"),
                  ("ndtpu_torch.graph.solve", "pcg_rhs", "PCG"))


def phase_run(inputs, cfg):
    """One run with the phases synchronized at their edges; seconds per
    phase (nested phases are also inside their parents), and the
    smoother's parts (:data:`SMOOTHER_PARTS`, exclusive) with its host glue
    (the rest of ``_wb_smooth``)."""
    import importlib

    import torch

    from ndtpu_torch.loop import closure
    from ndtpu_torch.slam import pipeline

    spent = defaultdict(float)
    parts = defaultdict(float)
    stack = []
    patched = [(pipeline, "_window_frontend"), (pipeline, "_wb_appends"),
               (pipeline, "_wb_loops"), (pipeline, "_loop_lanes"),
               (pipeline, "_append_loops"), (pipeline, "_wb_smooth"),
               (pipeline, "_wb_maps"), (closure, "write_local_tables"),
               (closure, "verify_lanes"), (closure, "_verify"),
               (closure, "verify_registrations")]
    # A stage an older (or newer) checkout lacks is skipped.
    saved = [(mod, name, getattr(mod, name)) for mod, name in patched
             if hasattr(mod, name)]
    part_saved = [(importlib.import_module(m), name, label)
                  for m, name, label in SMOOTHER_PARTS]
    part_saved = [(mod, name, label, getattr(mod, name))
                  for mod, name, label in part_saved if hasattr(mod, name)]

    def timed(name, fn):
        def wrapper(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            spent[name] += time.perf_counter() - t0
            return out
        return wrapper

    def part(label, fn):
        def wrapper(*a, **k):
            torch.cuda.synchronize()
            stack.append(0.0)
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            inner = stack.pop()
            parts[label] += dt - inner
            if stack:
                stack[-1] += dt
            return out
        return wrapper

    for mod, name, fn in saved:
        setattr(mod, name, timed(name, fn))
    for mod, name, label, fn in part_saved:
        setattr(mod, name, part(label, fn))
    try:
        wall, _, _ = run_once(inputs, cfg)
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
        for mod, name, _, fn in part_saved:
            setattr(mod, name, fn)
    parts["host glue"] = spent["_wb_smooth"] - sum(parts.values())
    return wall, dict(spent), dict(parts)


def verify_entry(closure) -> str:
    """The windowed pipeline's loop-verify call in ``closure``:
    ``detect_loops_stacked`` (every session's queries in one K15 and one
    gated launch), or ``detect_loops_cached_flat`` in checkouts before
    it."""
    return ("detect_loops_stacked" if hasattr(closure, "detect_loops_stacked")
            else "detect_loops_cached_flat")


def gated_lanes(kf, qpts, qmsk, qpose, cands, loop, mcfg):
    """The gated verify's lanes of ``K`` queries x their candidates as
    ``match.match_batch_packed_gated`` takes them: ``(points, mask, init,
    grid, match_cfg, group)``; from K15 (``closure.verify_lanes``, the
    candidates given) where the checkout has it, else from the older
    ``closure._verify_lanes``."""
    import torch

    from ndtpu_torch.loop import closure

    if not hasattr(closure, "verify_lanes"):
        return closure._verify_lanes(kf, qpts, qmsk, qpose, cands, loop,
                                     mcfg)
    k, dev = qpose.shape[0], qpose.device
    lanes = closure.verify_lanes(
        closure._one(kf), qpts[None], qmsk[None], qpose[None],
        torch.arange(k, device=dev)[None],
        torch.zeros((1, k), dtype=torch.long, device=dev), loop,
        cands=closure.LoopCandidates(cands.idx[None], cands.mask[None], None))
    return (torch.stack([lanes.px, lanes.py], -1), lanes.mask_f > 0,
            lanes.init, closure.local_grid_config(loop),
            closure._knobs(loop, mcfg, True), lanes.group)


def sync_run(inputs, cfg):
    """One run with ``torch.cuda.set_sync_debug_mode("warn")`` inside each
    ``_window_backend`` call: the host syncs per window (every one inside
    the backend; of them those inside ``incremental_update``, which a
    window with a new keyframe runs, and inside the loop verify,
    :func:`verify_entry`) and where they are. The wrappers take any
    arguments, so an older checkout is counted the same way."""
    import warnings

    import torch

    from ndtpu_torch.graph import incremental as inc
    from ndtpu_torch.loop import closure
    from ndtpu_torch.slam import pipeline

    names = (("_window_backend", pipeline), ("incremental_update", inc),
             (verify_entry(closure), closure))
    saved = {name: (mod, getattr(mod, name)) for name, mod in names}
    calls = {name: [] for name, _ in names}
    where = defaultdict(int)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        syncs = lambda: [w for w in caught if "synchroniz" in str(w.message)]

        def counted(name, fn):
            def inner(*a, **k):
                n0 = len(syncs())
                top = name == "_window_backend"
                if top:
                    torch.cuda.set_sync_debug_mode("warn")
                try:
                    return fn(*a, **k)
                finally:
                    if top:
                        torch.cuda.set_sync_debug_mode(0)
                    calls[name].append(len(syncs()) - n0)
            return inner

        for name, (mod, fn) in saved.items():
            setattr(mod, name, counted(name, fn))
        try:
            run_once(inputs, cfg)
        finally:
            for name, (mod, fn) in saved.items():
                setattr(mod, name, fn)
        for w in syncs():
            where[f"{Path(w.filename).name}:{w.lineno}"] += 1
    win, updates = calls["_window_backend"], calls["incremental_update"]
    verify = calls[verify_entry(closure)]
    n_win = max(len(win), 1)
    # One verify a window with loop closure on, none without.
    outside = [a - b for a, b in zip(
        win, verify if len(verify) == len(win) else [0] * len(win))]
    return dict(windows=len(win), syncs_per_window=sum(win) / n_win,
                max_per_window=max(win, default=0),
                verify_syncs_per_window=sum(verify) / n_win,
                outside_verify_max=max(outside, default=0),
                updates=len(updates), syncs=sum(updates),
                syncs_per_update=(sum(updates) / len(updates)
                                  if updates else None),
                sync_sites=dict(sorted(where.items(), key=lambda kv: -kv[1])))


def finalize_calls(events, k4_roles) -> dict:
    """Card-only ms per call of K4, by role (``map``: a window's first
    table, of the map; ``pass2``: the temporary map's), from its device
    events in stream order."""
    k4 = defaultdict(list)
    tables = [e for e in events if "finalize_pack_kernel" in e[2]]
    for role, e in zip(k4_roles, tables):
        k4[role].append((e[1] - e[0]) / 1e3)
    return dict(calls=len(k4_roles), events=len(tables), **{
        role: dict(calls=len(v), ms_per_call=sum(v) / len(v), ms_max=max(v))
        for role, v in k4.items()})


def map_build_calls(events, k3_calls, k8a_calls, cfg):
    """Card-only ms per call of K3 and K8a, by call shape, from the device
    events in stream order. A K3 call zeroes its lattice (a memset, or a
    fill kernel), scatters (when it has points) and pools, back to back on
    the one stream; its i-th pool event is its i-th call. K3 shapes:
    ``window`` (W scans), ``rebuild`` (every keyframe slot), else
    ``M=<points>``; K8a shapes: ``W=<keyframes>``."""
    window_m = cfg.window * cfg.n_beams
    rebuild_m = cfg.keyframe.capacity * cfg.n_beams
    label = {window_m: "window", rebuild_m: "rebuild"}
    k3, k8a = defaultdict(list), defaultdict(list)
    parts = defaultdict(lambda: defaultdict(float))   # shape -> op -> us
    pools = [i for i, e in enumerate(events) if "halfcell_pool" in e[2]]
    for call, i in zip(k3_calls, pools):
        shape = label.get(call, f"M={call}")
        ops, j = {"pool": events[i][1] - events[i][0]}, i - 1
        if call > 0 and j >= 0 and "halfcell_scatter" in events[j][2]:
            ops["scatter"], j = events[j][1] - events[j][0], j - 1
        if j >= 0 and ("Memset" in events[j][2]
                       or "FillFunctor" in events[j][2]):
            ops["zero"] = events[j][1] - events[j][0]
        for op, us in ops.items():
            parts[shape][op] += us
        k3[shape].append(sum(ops.values()) / 1e3)
    tables = [e for e in events if "local_tables_kernel" in e[2]]
    for call, e in zip(k8a_calls, tables):
        k8a[f"W={call}"].append((e[1] - e[0]) / 1e3)
    summary = lambda d: {k: dict(calls=len(v), ms_per_call=sum(v) / len(v),
                                 ms_max=max(v)) for k, v in d.items()}
    out = summary(k3)
    for shape, ops in parts.items():
        out[shape]["ms_per_call_by_op"] = {
            op: us / 1e3 / out[shape]["calls"] for op, us in ops.items()}
    return dict(halfcell_add=out, local_tables=summary(k8a),
                halfcell_add_calls=len(k3_calls), halfcell_pool_events=len(
                    pools), local_tables_calls=len(k8a_calls),
                local_tables_events=len(tables))


def smoother_calls(events, roles) -> dict:
    """Card-only ms per call of the smoother's kernels by role, from their
    device events in stream order: K5 (one kernel per call; in older
    checkouts a rows kernel and a finish kernel; roles ``full``,
    ``full_chi2``, ``gathered``, ``gathered_chi2``, ``window``), K6
    (``solve``, ``settled_step``), K7a and K7b."""
    out = {}
    for name, ev_names in (("factor_linearize", ("linearize_finish",
                                                 "factor_linearize_kernel")),
                           ("pcg_solve", ("pcg_solve_kernel",)),
                           ("local_select", ("local_select_kernel",)),
                           ("local_assemble", ("local_assemble_kernel",))):
        evs = [e for e in events if any(n in e[2] for n in ev_names)]
        rows = [e for e in events if "linearize_rows" in e[2]]
        by_role = defaultdict(list)
        for i, (role, e) in enumerate(zip(roles[name], evs)):
            us = e[1] - e[0]
            if name == "factor_linearize":
                prior = [r for r in rows if r[1] <= e[0]]
                if prior and (i == 0 or prior[-1][0] >= evs[i - 1][1]):
                    us += prior[-1][1] - prior[-1][0]
            by_role[role].append(us / 1e3)
        out[name] = dict(calls=len(roles[name]), events=len(evs), **{
            role: dict(calls=len(v), ms_per_call=sum(v) / len(v),
                       ms_max=max(v)) for role, v in by_role.items()})
    return out


def profiled_run(inputs, cfg, n_scans: int):
    """Device kernels per scan, device busy share of the profiled span,
    top kernels, lm_ndt's and the gated verify's device time per launch,
    K3's and K8a's card time per call by call shape, K4's by role, and the
    smoother's kernels' by role (:func:`smoother_calls`)."""
    from torch.profiler import ProfilerActivity, profile

    from ndtpu_torch import kernels
    from ndtpu_torch.slam import pipeline

    k3_calls, k8a_calls, k4_roles = [], [], []
    k3, k8a, k4 = kernels.halfcell_add, kernels.local_tables, \
        kernels.finalize_pack
    frontend = pipeline._window_frontend

    def k3_logged(n, s, ss, points, *a, **k):
        k3_calls.append(points.shape[0])
        return k3(n, s, ss, points, *a, **k)

    def k8a_logged(tables, slot, *a, **k):
        k8a_calls.append(slot.shape[0])
        return k8a(tables, slot, *a, **k)

    def k4_logged(*a, **k):
        k4_roles.append("pass2" if k4_roles and k4_roles[-1] != "window"
                        else "map")
        return k4(*a, **k)

    def frontend_logged(*a, **k):
        k4_roles.append("window")       # dropped below
        return frontend(*a, **k)

    sm_roles = defaultdict(list)
    sm_saved = {name: getattr(kernels, name) for name in
                ("factor_linearize", "fresh_residual_max", "pcg_solve",
                 "local_select", "local_assemble") if hasattr(kernels, name)}

    def lin_logged(*a, fid=None, chi_only=False, **k):
        sm_roles["factor_linearize"].append(
            ("gathered" if fid is not None else "full")
            + ("_chi2" if chi_only else ""))
        return sm_saved["factor_linearize"](*a, fid=fid, chi_only=chi_only,
                                            **k)

    def window_logged(*a, **k):
        sm_roles["factor_linearize"].append("window")
        return sm_saved["fresh_residual_max"](*a, **k)

    def pcg_logged(*a, **k):
        max_iter = a[9] if len(a) > 9 else k["max_iter"]
        sm_roles["pcg_solve"].append("solve" if max_iter > 0
                                     else "settled_step")
        return sm_saved["pcg_solve"](*a, **k)

    def one_role(name):
        def inner(*a, **k):
            sm_roles[name].append("all")
            return sm_saved[name](*a, **k)
        return inner

    kernels.halfcell_add, kernels.local_tables = k3_logged, k8a_logged
    kernels.finalize_pack, pipeline._window_frontend = k4_logged, \
        frontend_logged
    logged = dict(factor_linearize=lin_logged,
                  fresh_residual_max=window_logged, pcg_solve=pcg_logged,
                  local_select=one_role("local_select"),
                  local_assemble=one_role("local_assemble"))
    for name in sm_saved:
        setattr(kernels, name, logged[name])
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            wall, _, _ = run_once(inputs, cfg)
    finally:
        kernels.halfcell_add, kernels.local_tables = k3, k8a
        kernels.finalize_pack, pipeline._window_frontend = k4, frontend
        for name, fn in sm_saved.items():
            setattr(kernels, name, fn)
    k4_roles = [r for r in k4_roles if r != "window"]
    events, by_name, busy = device_events(prof)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    lm = [v for k, v in by_name.items()
          if "lm_ndt_kernel" in k and "lm_ndt_kernel<true>" not in k]
    lm_n = sum(v[0] for v in lm)
    gated = [v for k, v in by_name.items() if "lm_ndt_kernel<true>" in k]
    gated_n = sum(v[0] for v in gated)
    return dict(
        profiled_wall_s=wall, device_events=len(events),
        device_events_per_scan=len(events) / n_scans,
        device_busy_ms=busy / 1e3,
        device_busy_share=busy / 1e6 / wall,
        lm_ndt_launches=lm_n,
        lm_ndt_device_ms_per_launch=(sum(v[1] for v in lm) / lm_n
                                     if lm_n else None),
        gated_verify_launches=gated_n,
        gated_verify_device_ms_per_launch=(sum(v[1] for v in gated)
                                           / gated_n if gated_n else None),
        finalize_pack=finalize_calls(events, k4_roles),
        map_build=map_build_calls(events, k3_calls, k8a_calls, cfg),
        smoother=smoother_calls(events, sm_roles),
        top=[dict(name=k[:80], count=v[0], ms=v[1]) for k, v in top])


#: The stacked window's stages (``dist/slam_dp.py``), each synchronized at
#: its edges, as ``(module, function, label)``: the loop verify
#: (``_loop_lanes``: since K15 one call for all sessions, its set-up
#: ``verify_lanes`` and its gated launch ``_verify``; before, one
#: ``_loop_lanes`` a session, or ``_wb_loops`` before K14) and
#: ``write_local_tables`` run inside the appends; ``need_test`` is the
#: smoother's need test (one ``fresh_residual_max_stacked`` call for all
#: sessions, or in older checkouts one ``fresh_residual_max`` a session);
#: ``refresh_points`` is the refresh's selection and points inside
#: ``_refresh_stacked`` (one ``_refresh_points`` call for all sessions
#: since K16, one a session before it).
SERVING_STAGES = (
    ("ndtpu_torch.dist.slam_dp", "_frontend_stacked", "_frontend_stacked"),
    ("ndtpu_torch.dist.slam_dp", "_appends_stacked", "_appends_stacked"),
    ("ndtpu_torch.slam.pipeline", "_wb_loops", "_wb_loops"),
    ("ndtpu_torch.slam.pipeline", "_loop_lanes", "_loop_lanes"),
    ("ndtpu_torch.loop.closure", "verify_lanes", "verify_lanes"),
    ("ndtpu_torch.loop.closure", "_verify", "_verify"),
    ("ndtpu_torch.loop.closure", "write_local_tables",
     "write_local_tables"),
    ("ndtpu_torch.graph.incremental", "fresh_residual_max", "need_test"),
    ("ndtpu_torch.graph.incremental", "fresh_residual_max_stacked",
     "need_test"),
    ("ndtpu_torch.dist.slam_dp", "_smooth_stacked", "_smooth_stacked"),
    ("ndtpu_torch.dist.slam_dp", "_extend_stacked", "_extend_stacked"),
    ("ndtpu_torch.dist.slam_dp", "_refresh_stacked", "_refresh_stacked"),
    ("ndtpu_torch.slam.pipeline", "_refresh_points", "refresh_points"))


def serving_inputs(dev, sessions: int, n_scans: int):
    """The serving workload of ``python -m ndtpu_torch.serve --config
    configs/config_serving.json``: ``(inputs, cfg, sequences)``."""
    import dataclasses

    from ndtpu_torch import serve
    from ndtpu_torch.config import PipelineConfig
    from ndtpu_torch.dist import slam_dp

    cfg = slam_dp.serving_config(PipelineConfig.from_json(
        str(ROOT / "configs" / "config_serving.json")))
    cfg = dataclasses.replace(cfg, keyframe=dataclasses.replace(
        cfg.keyframe, capacity=serve.auto_capacity(cfg, n_scans)))
    seqs = serve.synthetic_sessions(cfg, sessions, n_scans)
    points, mask, odom, _ = serve.pad_sessions(seqs)
    return tuple(t.to(dev) for t in (points, mask, odom)), cfg, seqs


def serving_once(inputs, cfg):
    import torch

    from ndtpu_torch.dist import slam_dp

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = slam_dp.run_sessions_stacked(*inputs, cfg)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def serving_profile(dev, sessions: int, n_scans: int, runs: int) -> dict:
    """Where a stacked serving run's time goes: wall time of ``runs`` runs
    (after two warm-ups), one run with the stages of
    :data:`SERVING_STAGES` synchronized at their edges, one with
    ``set_sync_debug_mode("warn")`` around each window step (host syncs per
    window and where), launches per window, and one under
    ``torch.profiler`` (device busy share, device events per window, the
    largest kernels)."""
    import importlib
    import warnings

    import torch
    from torch.profiler import ProfilerActivity, profile

    from ndtpu_torch import kernels
    from ndtpu_torch.dist import slam_dp
    from ndtpu_torch.eval.ate import ate_rmse
    from ndtpu_torch.serve import trajectories

    inputs, cfg, seqs = serving_inputs(dev, sessions, n_scans)
    scans = sessions * n_scans
    for _ in range(2):
        serving_once(inputs, cfg)
    walls = []
    for _ in range(runs):
        kernels.reset_launches()
        wall, (state, outs) = serving_once(inputs, cfg)
        walls.append(wall)
    launches = dict(kernels.LAUNCHES)
    windows = -(-(n_scans - 1) // cfg.window)
    traj = trajectories(state, outs).cpu()
    ates = [float(ate_rmse(traj[k], seqs[k].gt_poses))
            for k in range(sessions)]
    shas = dict(traj=bits_sha(traj), state=bits_sha(state),
                outs=bits_sha(outs))
    print(f"[profile] serving {sessions} x {n_scans} scans: "
          + ", ".join(f"{w:.4f} s ({scans / w:.1f} scans/s)" for w in walls)
          + f"; ATE per session " + " ".join(f"{a:.4f}" for a in ates)
          + f"; sha256 {shas}")

    spent = defaultdict(float)
    saved = [(importlib.import_module(m), name, label)
             for m, name, label in SERVING_STAGES]
    # A stage an older (or newer) checkout lacks is skipped.
    saved = [(mod, name, label, getattr(mod, name))
             for mod, name, label in saved if hasattr(mod, name)]

    def timed(name, fn):
        def wrapper(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            spent[name] += time.perf_counter() - t0
            return out
        return wrapper

    for mod, name, label, fn in saved:
        setattr(mod, name, timed(label, fn))
    try:
        wall_p, _ = serving_once(inputs, cfg)
    finally:
        for mod, name, _, fn in saved:
            setattr(mod, name, fn)
    print(f"[profile] serving stages ({wall_p:.4f} s): " + ", ".join(
        f"{k} {v:.4f} s ({v / wall_p:.1%})" for k, v in spent.items()))

    step, per_window, sites = slam_dp._stacked_window_step, [], \
        defaultdict(int)

    def counted(*a, **k):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                out = step(*a, **k)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        syncs = [w for w in caught if "synchroniz" in str(w.message)]
        per_window.append(len(syncs))
        for w in syncs:
            sites[f"{Path(w.filename).name}:{w.lineno}"] += 1
        return out

    slam_dp._stacked_window_step = counted
    try:
        serving_once(inputs, cfg)
    finally:
        slam_dp._stacked_window_step = step
    syncs = dict(per_window=sum(per_window) / len(per_window),
                 max=max(per_window),
                 sites=dict(sorted(sites.items(), key=lambda kv: -kv[1])[:12]))
    print(f"[profile] serving host syncs per window: {syncs['per_window']:.1f}"
          f" (max {syncs['max']}); sites {syncs['sites']}")

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall_prof, _ = serving_once(inputs, cfg)
    events, by_name, busy = device_events(prof)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    print(f"[profile] serving under torch.profiler: {len(events)} device "
          f"events ({len(events) / windows:.1f} per window), busy "
          f"{busy / 1e3:.2f} ms of {wall_prof:.4f} s "
          f"({busy / 1e6 / wall_prof:.1%})")
    for name, (n, ms) in top:
        print(f"[profile]   {ms:9.3f} ms {n:6d} x {name[:80]}")
    return dict(sessions=sessions, scans=scans, windows=windows,
                wall_s=walls, aggregate_scans_per_s=[scans / w for w in walls],
                ate_m=ates, sha256=shas, stage_wall_s=wall_p,
                stage_s=dict(spent),
                launches_per_window={k: v / windows
                                     for k, v in launches.items() if v},
                host_syncs=syncs, profiled_wall_s=wall_prof,
                device_events_per_window=len(events) / windows,
                device_busy_ms=busy / 1e3,
                device_busy_share=busy / 1e6 / wall_prof,
                top=[dict(name=k[:80], count=v[0], ms=v[1])
                     for k, v in top])


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config", default=str(
        ROOT / "configs" / "config3_loop_closure.json"))
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--runs", type=int, default=3)
    parser.add_argument("--out", default=None)
    parser.add_argument("--shadow", action="store_true",
                        help="also check every lm_ndt call of one run "
                        "against the composite route, bit for bit")
    parser.add_argument("--kernels", action="store_true",
                        help="time K4, K8b and the loop verify alone "
                        "(kernel_times) and nothing else")
    parser.add_argument("--layouts", action="store_true",
                        help="time the windowed path's kernels in every "
                        "table layout (layout_times) and nothing else")
    parser.add_argument("--serving", action="store_true",
                        help="profile stacked serving (serving_profile) "
                        "and nothing else")
    parser.add_argument("--serving-steps", default=None, metavar="LAYOUT",
                        help="serving in a layout of chip_smoke."
                        "SERVING_LAYOUT_RUNS (or 'published'): the serve's "
                        "runs and each window step against the plain f32 "
                        "step (serving_steps), and nothing else")
    parser.add_argument("--serving-layouts", action="store_true",
                        help="time K3s/K4s and config 5's K12, K10a, K10c "
                        "in every layout (serving_layout_times) and nothing "
                        "else")
    parser.add_argument("--scan", action="store_true",
                        help="profile the per-scan path and its inputs "
                        "(scan_profile) and nothing else")
    parser.add_argument("--raycast-sweep", action="store_true",
                        help="K11's card ms against the segment count "
                        "(raycast_sweep) and nothing else")
    parser.add_argument("--assemble-sweep", action="store_true",
                        help="K9a's and K9c's card ms at each launch shape "
                        "(assemble_sweep) and nothing else")
    parser.add_argument("--sgh-sweep", action="store_true",
                        help="K12's card ms at each R (sgh_sweep) and "
                        "nothing else")
    parser.add_argument("--finalize-sweep", action="store_true",
                        help="K10b's card ms at each block size "
                        "(finalize_sweep) and nothing else")
    parser.add_argument("--hot", action="store_true",
                        help="time lm_ndt and K6 / K6b at the main path's "
                        "shapes and bench.py's headline shape, with output "
                        "hashes and config 1-2 trajectories (hot_times), "
                        "and nothing else")
    parser.add_argument("--takes", action="store_true",
                        help="the take codes, loops and ATE of box-world "
                        "draws 0-2 at configs 2 and 3 (take_codes), and "
                        "nothing else")
    parser.add_argument("--sessions", type=int, default=8)
    parser.add_argument("--max-scans", type=int, default=300)
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import subprocess

    import torch

    if not torch.cuda.is_available():
        print("profile_port: no CUDA device is available", file=sys.stderr)
        return 1
    from chip_smoke import box_sequence, lm_composite
    from ndtpu_torch import kernels
    from ndtpu_torch.config import PipelineConfig
    from ndtpu_torch.eval.ate import ate_rmse
    from ndtpu_torch.ndt import match

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    dev = torch.device("cuda", 0)
    if args.kernels:
        kernels.build()
        result = dict(card=smi, kernels=kernel_times(args.seed, dev))
        for key, row in result["kernels"].items():
            print(f"[profile] {key}: {row}")
        return _emit(result, smi, args.out)
    if args.raycast_sweep:
        kernels.build()
        result = dict(card=smi, raycast_sweep=raycast_sweep(dev))
        print(f"[profile] raycast sweep: {result['raycast_sweep']}")
        return _emit(result, smi, args.out)
    if args.assemble_sweep:
        kernels.build()
        result = dict(card=smi, assemble_sweep=assemble_sweep(dev))
        return _emit(result, smi, args.out)
    if args.sgh_sweep:
        kernels.build()
        result = dict(card=smi, sgh_sweep=sgh_sweep(args.seed, dev))
        return _emit(result, smi, args.out)
    if args.finalize_sweep:
        kernels.build()
        result = dict(card=smi, finalize_sweep=finalize_sweep(args.seed,
                                                              dev))
        return _emit(result, smi, args.out)
    if args.takes:
        kernels.build()
        result = dict(card=smi, takes=take_codes(dev))
        return _emit(result, smi, args.out)
    if args.hot:
        kernels.build()
        result = dict(card=smi, hot=hot_times(args.seed, dev))
        for key, row in result["hot"].items():
            print(f"[profile] {key}: {row}")
        return _emit(result, smi, args.out)
    if args.layouts:
        kernels.build()
        result = dict(card=smi, layouts=layout_times(args.seed, dev))
        for key, row in result["layouts"].items():
            print(f"[profile] {key}: {row}")
        return _emit(result, smi, args.out)
    if args.scan:
        kernels.build()
        result = dict(card=smi, scan=scan_profile(dev, args.config,
                                                  args.seed, args.runs))
        return _emit(result, smi, args.out)
    if args.serving_steps:
        kernels.build()
        result = dict(card=smi, serving_steps=serving_steps(
            dev, args.serving_steps, args.sessions, args.max_scans))
        return _emit(result, smi, args.out)
    if args.serving_layouts:
        kernels.build()
        result = dict(card=smi, serving_layouts=serving_layout_times(
            args.seed, dev, args.sessions, args.max_scans))
        for key, row in result["serving_layouts"].items():
            print(f"[profile] {key}: {row}")
        return _emit(result, smi, args.out)
    if args.serving:
        kernels.build()
        result = dict(card=smi, serving=serving_profile(
            dev, args.sessions, args.max_scans, args.runs))
        return _emit(result, smi, args.out)
    cfg = PipelineConfig.from_json(args.config)
    seq = box_sequence(args.seed, cfg.n_beams)
    inputs = tuple(t.to(dev) for t in (seq.points, seq.mask, seq.odom))
    n = seq.points.shape[0]
    kernels.build()
    for _ in range(2):
        run_once(inputs, cfg)

    fused = match.lm_ndt
    walls = {"kernel": [], "composite": []}
    order = ["kernel", "composite", "composite", "kernel"]
    for i in range(2 * args.runs):
        route = order[i % 4]
        match.lm_ndt = fused if route == "kernel" else lm_composite
        try:
            kernels.reset_launches()
            match.CALLS["match_batch_packed"] = 0
            wall, state, traj = run_once(inputs, cfg)
        finally:
            match.lm_ndt = fused
        ate = float(ate_rmse(traj.cpu(), seq.gt_poses))
        loops = int(state.n_loops) if cfg.use_loop_closure else 0
        walls[route].append(wall)
        print(f"[profile] {route:9s} route: {wall:.4f} s, {(n - 1) / wall:.1f}"
              f" scans/s, ATE {ate:.4f} m, loops {loops}, "
              f"{match.CALLS['match_batch_packed']} match_batch_packed "
              f"calls, launches {dict(kernels.LAUNCHES)}")

    shadow = None
    if args.shadow:
        shadow, traj = shadow_run(inputs, cfg)
        shadow["ate_m"] = float(ate_rmse(traj.cpu(), seq.gt_poses))
        print(f"[profile] shadow run: {shadow}")
    wall_p, spent, parts = phase_run(inputs, cfg)
    shares = {k: v / wall_p for k, v in spent.items()}
    print(f"[profile] phases ({wall_p:.4f} s): " + ", ".join(
        f"{k} {v:.4f} s ({shares[k]:.1%})" for k, v in spent.items()))
    print(f"[profile] _wb_smooth by part: " + ", ".join(
        f"{k} {v:.4f} s ({v / wall_p:.1%} of the run)"
        for k, v in parts.items()))
    syncs = sync_run(inputs, cfg)
    print(f"[profile] host syncs in _window_backend: "
          f"{syncs['syncs_per_window']:.2f} per window (at most "
          f"{syncs['max_per_window']}) over {syncs['windows']} windows, "
          f"{syncs['verify_syncs_per_window']:.2f} of them in the loop "
          f"verify; in incremental_update {syncs['syncs']} over "
          f"{syncs['updates']} calls ({syncs['syncs_per_update']} each); "
          f"sites {syncs['sync_sites']}")
    prof = profiled_run(inputs, cfg, n)
    wall_after, _, _ = run_once(inputs, cfg)
    print(f"[profile] one more run after the profiler: {wall_after:.4f} s "
          f"(the profiler leaves later launches slower)")
    print(f"[profile] torch.profiler: {prof['device_events']} device events "
          f"({prof['device_events_per_scan']:.1f} per scan), busy "
          f"{prof['device_busy_ms']:.2f} ms of {prof['profiled_wall_s']:.4f}"
          f" s ({prof['device_busy_share']:.1%}); lm_ndt "
          f"{prof['lm_ndt_launches']} launches, "
          f"{prof['lm_ndt_device_ms_per_launch']} ms each on the card; gated "
          f"verify {prof['gated_verify_launches']} launches, "
          f"{prof['gated_verify_device_ms_per_launch']} ms each")
    for t in prof["top"]:
        print(f"[profile]   {t['ms']:9.3f} ms {t['count']:6d} x {t['name']}")
    mb = prof["map_build"]
    for name in ("halfcell_add", "local_tables"):
        print(f"[profile] {name} on the card per call: " + ", ".join(
            f"{shape} {v['ms_per_call']:.4f} ms (max {v['ms_max']:.4f}, "
            f"{v['calls']} calls" + "".join(
                f", {op} {ms:.4f}" for op, ms in
                v.get("ms_per_call_by_op", {}).items()) + ")"
            for shape, v in mb[name].items()))
    for name, v in prof["smoother"].items():
        print(f"[profile] {name} on the card per call ({v['calls']} calls, "
              f"{v['events']} events): " + ", ".join(
                  f"{role} {r['ms_per_call']:.4f} ms (max {r['ms_max']:.4f},"
                  f" {r['calls']} calls)" for role, r in v.items()
                  if isinstance(r, dict)))
    k4 = prof["finalize_pack"]
    print(f"[profile] finalize_pack on the card per call: " + ", ".join(
        f"{role} {v['ms_per_call']:.4f} ms (max {v['ms_max']:.4f}, "
        f"{v['calls']} calls)" for role, v in k4.items()
        if isinstance(v, dict)))
    result = dict(card=smi, config=Path(args.config).name, seed=args.seed,
                  scans=n, wall_s=walls,
                  scans_per_s={k: [(n - 1) / w for w in v]
                               for k, v in walls.items()},
                  phase_wall_s=wall_p, phase_s=spent, smoother_parts_s=parts,
                  smoother_syncs=syncs, profiler=prof,
                  wall_after_profiler_s=wall_after, shadow=shadow)
    return _emit(result, smi, args.out)


#: The per-scan path's stages, timed synchronized at their edges (nested
#: stages are also inside their parents).
SCAN_STAGES = (("ndtpu_torch.slam.pipeline", "_map_table", "K4 map table"),
               ("ndtpu_torch.ndt.match", "match_batch_packed",
                "registration"),
               ("ndtpu_torch.slam.pipeline", "_keyframe_branch",
                "keyframe branch"),
               ("ndtpu_torch.loop.closure", "write_local_tables",
                "K8a table"),
               ("ndtpu_torch.loop.closure", "detect_loops_cached",
                "loop detection"),
               ("ndtpu_torch.graph.incremental", "incremental_update",
                "smoother"),
               ("ndtpu_torch.ndt.grid", "build_stats", "map rebuild"))


def scan_profile(dev, config: str, seed: int, runs: int) -> dict:
    """The per-scan path on box-world draw ``seed`` at ``config``: event ms
    per call of its input preparation (K11 ``raycast`` at the CLI's
    corridor run in f64, K13 ``voxel_downsample`` at 0.1 m on those scans)
    and of its verifies (the per-query cached verify at the end-of-lap
    query, the fresh-map verify); wall time of ``runs`` ``run_slam`` runs
    after a warm-up; one run with every stage (:data:`SCAN_STAGES`)
    synchronized at its edges; one run under ``set_sync_debug_mode("warn")``
    (host syncs per scan and where); then, under ``torch.profiler``, the
    card ms per call of K11, K13 and the verifies and one profiled run
    (device busy share, device events per scan, the largest kernels)."""
    import importlib
    import warnings

    import torch

    from chip_smoke import (box_sequence, cli_inputs, k11_inputs, time_ms)
    from ndtpu_torch.config import PipelineConfig
    from ndtpu_torch.data import preprocess, synth
    from ndtpu_torch.eval.ate import ate_rmse
    from ndtpu_torch.loop import closure
    from ndtpu_torch.slam import pipeline

    cfg = PipelineConfig.from_json(config)
    cfg3 = PipelineConfig.from_json(str(ROOT / "configs"
                                        / "config3_loop_closure.json"))
    world, poses, ang = k11_inputs("corridor", torch.float64, dev)
    cli = cli_inputs(ROOT / "configs" / "config3_loop_closure.json", 600,
                     dev)
    seq = box_sequence(seed, cfg.n_beams, device=dev)
    inputs = (seq.points, seq.mask, seq.odom)
    n = seq.points.shape[0]

    def run():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, outs = pipeline.run_slam(*inputs, cfg)
        traj = pipeline.recover_trajectory(state, outs)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, state, traj

    run()
    walls = []
    for _ in range(runs):
        wall, state, traj = run()
        walls.append(wall)
    ate = float(ate_rmse(traj.cpu(), seq.gt_poses.cpu()))
    # The end-of-lap query of a config-3 per-scan run (its last scan).
    st3, _ = pipeline.run_slam(*inputs, cfg3)
    q = (st3.kf, seq.points[-1], seq.mask[-1], st3.pose, st3.kf.n)
    calls = {
        "raycast corridor f64": (lambda: synth.raycast(world, poses, ang,
                                                       20.0), ["raycast"]),
        "voxel_downsample 0.1 m": (lambda: preprocess.voxel_downsample(
            cli.points, cli.mask, 0.1), ["voxel_downsample"]),
        "verify K=1 C=16 (per query)": (lambda: closure.detect_loops_cached(
            *q, cfg3.loop, cfg3.match), None),
        "fresh verify C=16": (lambda: closure.detect_loops(
            *q, cfg3.loop, cfg3.ndt, cfg3.match), None)}
    kernels_out = {k: dict(ms=time_ms(fn)) for k, (fn, _) in calls.items()}

    spent = defaultdict(float)
    saved = []
    for m, name, label in SCAN_STAGES:
        mod = importlib.import_module(m)
        fn = getattr(mod, name)
        saved.append((mod, name, fn))

        def timed(*a, _fn=fn, _label=label, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = _fn(*a, **k)
            torch.cuda.synchronize()
            spent[_label] += time.perf_counter() - t0
            return out
        setattr(mod, name, timed)
    try:
        wall_p, state_p, _ = run()
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    keyframes = int(state_p.kf.n) - 1

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            run()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = [w for w in caught if "synchroniz" in str(w.message)]
    where = defaultdict(int)
    for w in syncs:
        where[f"{Path(w.filename).name}:{w.lineno}"] += 1

    for key, (fn, names) in calls.items():
        kernels_out[key]["card_ms"] = card_ms(fn, names)
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall_prof, _, _ = run()
    events, by_name, busy = device_events(prof)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
    out = dict(
        config=Path(config).name, seed=seed, scans=n, wall_s=walls,
        scans_per_s=[(n - 1) / w for w in walls], ate_m=ate,
        keyframe_steps=keyframes, inputs_and_verifies=kernels_out,
        phase_wall_s=wall_p, phase_s=dict(spent),
        phase_share={k: v / wall_p for k, v in spent.items()},
        host_syncs=len(syncs), host_syncs_per_scan=len(syncs) / (n - 1),
        sync_sites=dict(sorted(where.items(), key=lambda kv: -kv[1])[:12]),
        profiled_wall_s=wall_prof, device_events=len(events),
        device_events_per_scan=len(events) / (n - 1),
        device_busy_ms=busy / 1e3,
        device_busy_share=busy / 1e6 / wall_prof,
        top=[dict(name=k, count=c, ms=ms) for k, (c, ms) in top])
    print(f"[profile] per-scan {out['config']} draw {seed}: "
          + ", ".join(f"{(n - 1) / w:.1f}" for w in walls)
          + f" scans/s, ATE {ate:.4f} m, {keyframes} keyframe steps")
    print("[profile] stages (" + f"{wall_p:.4f} s): " + ", ".join(
        f"{k} {v:.4f} s ({v / wall_p:.1%})" for k, v in spent.items()))
    print(f"[profile] host syncs: {len(syncs)} ({len(syncs) / (n - 1):.2f} "
          f"per scan); sites {out['sync_sites']}")
    print(f"[profile] device: {len(events)} events "
          f"({out['device_events_per_scan']:.1f} per scan), busy "
          f"{busy / 1e3:.2f} ms of {wall_prof:.4f} s "
          f"({out['device_busy_share']:.1%})")
    for key, row in kernels_out.items():
        print(f"[profile] {key}: {row}")
    return out


def _emit(result: dict, smi: str, out) -> int:
    print(smi)
    line = json.dumps(result)
    if out:
        Path(out).parent.mkdir(parents=True, exist_ok=True)
        Path(out).write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
