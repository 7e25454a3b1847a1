#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on the card.

Run from the root of a checkout, on a machine with one CUDA card::

    python3 chip_smoke.py [--seed 0]

Phases (any failure exits non-zero, and no result line is printed):

1. the card: ``torch.cuda.is_available()``, then its name and power limit
   as ``nvidia-smi`` reports them;
2. the build of the CUDA kernels from ``ndtpu_torch/kernels/csrc`` (one
   ``nvcc`` per source, in parallel; seconds and the register report);
3. each kernel against its plain twin at real size, on inputs made from
   ``--seed``, with medians of 20 synchronized runs of kernel and twin
   (events) and, where noted, the kernel's own card time (``torch.profiler``,
   mean of 20): ``lm_ndt`` (the whole LM registration, one launch) at the
   config-2 window shape (8 lanes x 360 beams, the 100 x 100 table) and
   the config-3 verify shape (64 lanes grouped over the 1,024-slot cache),
   against the composite route (the LM step in torch around K1, the old
   path, timed beside it) and its f32 twin ``lm_ndt_ref``; its H and score
   bit-equal to K1's sums at its output poses, and all its outputs on a
   relaunch and at R = 1 (K1's 128 threads per lane), shared, grouped and
   gated at 360, 720 and 1,100 beams; and at bench.py §1's headline shape
   (4,096 lanes x 720 beams, one 128 x 128 table), timed;
   K1 ``ndt_terms`` (512 lanes, then the window's 8 lanes, x 360 beams
   against a config-2 table built from a 300-scan map), K3
   ``halfcell_add`` (1,024, then 8, scans of 360 points, against the twin in
   f64 on the CPU, all-+1 and mixed +-1 weights; bit for bit against the
   plain model of its fixed-point arithmetic, on a second launch and under
   a permutation of the points; also at the rebuild shape, the 1,024 x 360
   points of a keyframe store), K4 ``finalize_pack`` by bands of table rows
   (the config-2 and config-3 map tables and config 5's 513 x 513 lattice
   on statistics from ``--seed``; also bit-identical on a second launch);
   then on config 3's shapes K8a ``local_tables`` (256, then the window's
   8, keyframes; also bit-identical on a second launch, under permutation
   and to K4 of K3), K1 grouped (64 verify lanes x 360 beams against a
   1,024-slot table cache, random tables), the standalone K8b
   ``loop_gate`` (a real verification of 4 queries at the end of the
   box-world lap x 16, then x 64, candidates, against the gate's f64 twin)
   and the gated verify (one ``lm_ndt`` launch that registers and gates
   the same lanes: bit-equal to ``lm_ndt_grouped`` followed by the
   standalone K8b, and on a second call; no host sync; timed against the
   unfused route); then the same kernels in the other table layouts
   (:func:`check_layouts`: overlap-1 grids, compact bf16-pair rows, and
   both): K3 at overlap 1 (window and rebuild shapes, +1 and +-1
   weights; bit-equal to its fixed-point model, on a second launch and
   under permutation), and per layout K4 at the config-2 and config-3
   maps and K8a at a window (compact lanes bit-equal as int32 to the
   plain version on the same f32 statistics; K8a also to K4 of K3), K1
   and ``lm_ndt`` at the config-2 window shape, K1 grouped, ``lm_ndt``
   grouped and the gated verify at the config-3 verify shape over a
   1,024-slot cache of the layout, each against its f32 plain version;
   then
   ``_window_frontend`` twice from one state (bit-equal poses and map
   tables), and box-world config-3 draw 2 and config-2 draw 0 three times
   each (their ATEs, and the first window and stage where runs part);
   then the smoother's kernels on the graph of that config-3 run (1,024
   pose and 2,048 factor slots, its newest poses moved): K5
   ``factor_linearize`` (whole graph, gathered rows, chi^2, the fresh
   window; one launch per call in each of its five modes, by the launch
   counter and the profiler's device operations) and K7b
   ``local_assemble`` (also at 8,192 seeded gathered slots, past the
   first design's limit) against their f32 plain versions at
   rtol 1e-5, K6 ``pcg_solve`` against the f32 and f64 plain solves (also
   its 0-iteration mode, timed, one launch and no host sync per ``pcg``
   call, and the dense library solve timed beside it; then on the graph
   scattered through its slots in six orders, and on a 1,200-pose graph
   whose loop runs through the device scratch), K7a ``local_select`` bit for
   bit (also on bench.py §5b's 10,064-slot local graph), each
   bit-identical on a second launch, and K6g ``pcg_solve_grid``
   on the same graph beside K6 (the same gates); and ``incremental_update``
   through the kernels (no plain version reached) against the plain route
   in f32 and f64 for the local and global takes, the settled check and
   the full solve, and ``local_update`` with a K7a probe without a host
   sync; then config 4's kernels on bench.py's 10k-pose Manhattan graph
   (P = 64 shards): K5 at its 10,305 rows, K5r (K5 with each robust kind:
   huber, cauchy, tukey, geman) against its f32 and f64 plain versions
   there and through tests/test_robust.py's IRLS chain on the card, K6g
   ``pcg_solve_grid`` (the PCG past one block, one cooperative launch)
   against the f32 and f64 plain solves at lam 1e-3, 250 iterations (also
   its 0-iteration mode, the set-up, timed, its time per iteration past it
   beside the four-sync design's, one launch and no host sync per ``pcg``
   call, the dense library solve timed beside it), K9a
   ``supernodal_assemble`` and K9b ``schur_reduce`` against their plain
   versions in f32 on the card and in f64 on the CPU (rtol 1e-5 of each
   target's max; bit-identical on a
   second launch), one ``supernodal_delta`` on the card against the f64
   plain route (within 2 x the f32 plain route's error), and the bench's
   ``ba_solve_ms_per_iter_10k`` (one K5 linearize + ``supernodal_delta``,
   the median of 10 host-fenced calls after a warm-up) with the step's
   card-time split; then the input preparation: K11 ``raycast`` in f64 at
   the CLI's corridor run (600 poses x 360 beams x 36 segments), at
   serving's 8 x 300 box-world poses (17 segments) and among 4,004
   segments (past the first design's 48 KB; hits identical, within 1e-9 m
   of the f64 plain version), in f32 at the same three against the f32
   plain version, and K13 ``voxel_downsample`` on the CLI's 600 x 360 corridor
   scans at 0.05 / 0.1 / 0.5 m (masks bit-equal; the table route) and on 8
   seeded scans of 20,000 points past its table (the scan route,
   ``voxel_downsample[scan]``, through the entry point), each
   bit-identical on a second launch; then K14 ``window_append``
   (:func:`check_k14`) against ``window_append_ref`` on the same f32 card
   inputs at configs 2 and 3 (one session, 1,024 slots), serving (8 x 512)
   and full capacities (indices, masks, counters and copied rows bit-equal,
   the computed values within :data:`K14_RTOL`, and on a second launch),
   its loop entry against ``loop_append_ref`` and its row entry against
   ``set_rows_ref`` (bit-equal), each timed beside its plain version; K15
   ``loop_lanes`` (:func:`check_k15`); K16 ``refresh_points``
   (:func:`check_k16`) against ``pipeline.refresh_points_ref`` at
   serving's 8 x 512 slots and the smoke's 160 (M = 12, 360 beams), with
   equal staleness across the M-th place, a full store and every session
   off: all outputs bit-equal, timed beside its plain version and
   ``torch.topk``;
4. config 2 through its entry point: ``ndtpu_torch.run.main`` on
   ``configs/config2_full_sequence.json``, 300 scans, ``--device cuda``,
   with every launch counter (and the counts of ``match_batch_packed``
   and loop-detection calls, the smoother's takes, full solves, and K6's
   settled checks and solves) reset just before and read just after; the
   run's final map (K10b on the card) rasterized by
   ``eval.render.rasterize_map`` on the host (lit pixels counted; no PNG);
5. the config-2 ATE gate: box-world draws 0-2 through
   ``run_slam_windowed``, against the JAX reference's ATE on the same
   sequences (``tests/data/torch_config2_box300_ref.json``) and dead
   reckoning;
6. config 3 (loop closure) through the entry point, 600 scans (the
   corridor's 120 m lap takes 480), counters reset and read as in phase 4
   (in both, one K14 launch a window, and one of its loop entry a window
   with loop closure);
6b. the windowed path's host syncs (:func:`check_window_syncs`): box-world
    draw 0 at configs 2 and 3 through ``run_slam_windowed`` with
    ``set_sync_debug_mode("warn")`` inside each ``_window_backend`` call:
    every sync of a window printed (a parent checkout counts the same way)
    and at most :data:`WINDOW_SYNC_BUDGET` a window outside the loop
    verify's own routing;
7. the config-3 ATE gate against ``tests/data/torch_config3_box300_ref.json``
   (also: the port closes a loop on every draw where JAX does);
7b. config 1 (:func:`run_config1`): ``run_odometry_windowed`` at
    ``configs/config1_odometry.json``'s widths on box-world draws 0-2,
    counters reset just before and read just after, each draw's scans/s
    and ATE beside the JAX package's f32 and f64 ATE
    (``tests/data/torch_config1_box300_ref.json``), gated by config 2's
    rule;
7c. the windowed path in the other table layouts through its entry point
    (:func:`run_layouts`, :data:`LAYOUT_RUNS`): ``ndtpu_torch.run.main`` on
    config 2 with ``grid.overlap = 1`` (300 scans), config 3 with
    ``match.compact_table`` (600), with ``grid.overlap = 1``,
    ``loop.local_overlap = 1`` and ``compact_table`` (600), and with the
    two overlaps at 1 (600), every plain version refusing CUDA tensors;
    each run must launch its layout's variants; then the box-world ATE
    gates of each against the JAX package under the same flags
    (``tests/data/torch_layouts_box300_ref.json``);
7d. bench.py §3b's multilap at full size (:func:`run_multilap`: 1,000
    scans, 3.5 laps of the box world, 360 beams, seed 7; the sequence made
    by K11), ``run_slam_windowed`` with every plain version refusing CUDA
    tensors, counters reset just before and read just after: ATE within
    max(0.15 m, 2 x the JAX package's f32 run on the same sequence,
    ``tests/data/torch_multilap1000_ref.json``), loops > 0, one K11
    launch, K7b launched ``inc_iters`` times per local take; it prints
    the loops, keyframes, take fractions and innovation-rejected count;
8. config 4 through its entry point: ``ndtpu_torch.solve_g2o.main``
   with ``--manhattan 10000 --shards 64`` on the card (supernodal by
   ``auto``), counters reset just before and read just after: one K9a and
   one K9b launch per LM iteration, K5 launched, chi^2 falling and the final
   chi^2 within 1.02 x the JAX package's f32 final chi^2 on the same graph
   (``tests/data/torch_config4_manhattan10k_ref.json``);
8b. config 4 by PCG through its entry point (:func:`run_config4_pcg`):
    ``solve_g2o.main`` with ``--manhattan 10000 --method pcg``, counters
    reset just before and read just after, no plain version reached: one
    K6g launch per ``pcg`` call, no K6, chi^2 falling and the final chi^2
    within 1.02 x the JAX package's f32 ``--method pcg`` final chi^2
    (``tests/data/torch_config4_pcg10k_ref.json``); then ``--manhattan
    25000`` with ``auto``, which must take PCG;
8c. bench.py §5 on the card under its protocol (:func:`run_incremental_10k`):
    ``incremental_update_ms_10k`` (the active 10k update, the global take
    through K6g), ``incremental_settled_ms_10k`` and
    ``incremental_local_ms_10k`` (§5b's 10,064-slot graph through K7a /
    K7b), each with its take code, its kernels and one call's poses
    against the f64 plain route; ``marginal_covariance_pcg`` at 10k against
    its f64 plain version;
8d. K7a past the first design's shared memory
    (:func:`check_k7a_past_block`): 25,000 poses of config 4's Manhattan
    graph with four new poses chained, in 25,064 pose slots (the shared
    route, staged) and in 70,064 (the scratch route), and the 10k graph in
    60,000 factor slots (the shared route, the endpoints read from the
    graph), each bit-equal to the plain selection and on a second launch,
    timed; then the path on the first two, one ``incremental_update``
    through the kernels, counters reset just before and read just after
    (the local take through ``local_select`` or ``local_select[scratch]``
    and K7b), against the f32 and f64 plain routes; and K6g on the
    25,000-pose graph against the f32 and f64 plain solves;
9. sessions of different lengths (:func:`check_padded_sessions`): the
   padding the serving CLI adds is inert on the card (all-masked
   ``lm_ndt`` lanes, K3s, K4s, the gated verify) and in a stacked run;
10. stacked serving through its entry point (:func:`run_serving`):
    ``ndtpu_torch.serve.main`` on ``configs/config_serving.json``, 8
    sessions x 300 scans, twice (bit-equal), counters reset just before the
    first and read just after it: per window one ``lm_ndt_grouped`` launch
    per front-end pass, K3s and K4s once per use and never per map, K6b
    ``inc_iters`` times per smoother call, no twin on CUDA tensors, no
    drop, one K14 append and one loop-entry launch a window and one row
    launch a refresh, one K5 fresh-window launch a window (the need test
    of every session) and one K16 launch a refresh (every session's
    selection and points); the gated verify of all sessions' 128 lanes
    timed alone on a window's inputs; then each session's gates against the JAX package's run of the
    same sessions (``tests/data/torch_serving8_box300_ref.json``,
    :func:`serving_gates`);
10b. stacked serving in the other table layouts (:func:`run_serving_layouts`,
    :data:`SERVING_LAYOUT_RUNS`): the serving config with only
    ``grid.overlap`` and ``loop.local_overlap`` at 1, with
    ``match.compact_table``, and with both, one invocation of
    ``ndtpu_torch.serve.main`` each (8 x 300), counters reset just before
    and read just after, every plain version refusing CUDA tensors: per
    window the layout's front-end ``lm_ndt_grouped`` per pass, K3s and K4s
    once per use, the gated verify; each session's median ATE over the
    invocation's four runs gated by :func:`serving_gates`' rule against the
    JAX package's run under the same flags
    (``tests/data/torch_serving8_layouts_box300_ref.json``); the aggregate
    scans/s printed beside phase 10's;
11. K6b ``pcg_solve_blocked`` (against its plain version in f32 and f64,
    rtol 1e-4 per session, an idle session at 0, each session bit-equal
    to its own K6 launch), K3s
    ``halfcell_add_stacked`` at the window and refresh shapes and K4s
    ``finalize_pack_stacked`` (each bit-equal to 8 single K3 / K4
    launches), all bit-identical on a second launch, and K5's fresh window
    of 8 sessions (bit-equal to 8 single-session launches), on the state
    the serving run left, each timed beside the single launches it
    replaces;
    then in the other layouts (:func:`check_stacked_layouts`): K3s at
    overlap 1 at the rebuild, window and refresh shapes (bit-equal to 8
    single K3[g1] launches and to the fixed-point model), K4s in g1l8,
    g4l4 and g1l4 (bit-equal as int32 to 8 single K4 launches of the
    layout);
12. config 5's merge in process (:func:`run_merge`), at
    ``configs/config5_multisession.json``: two corridor sessions
    (:func:`config5_sessions`) through ``run_slam_windowed``, then, with the
    counters reset just before and read just after, ``global_align``,
    ``find_inter_session_loops`` at a perturbed transform, the merges and
    ``merged_map_stats`` (two K12 and two ``lm_ndt`` launches, one gated
    verify, one K3), and the two placement solves by PCG as the reference
    runs them (``optimize(method="pcg")``, 15 iterations: K6g, one launch
    per ``pcg`` call), gated against the JAX package's run of the same pair
    (``tests/data/torch_config5_merge_ref.json``); K12 against its plain
    version at the alignment's two shapes;
12b. config 5's merge at overlap 1 (:func:`run_merge` with
    :data:`CONFIG5_OVERLAP1`): the same pair and merge on the config with
    only ``grid.overlap`` and ``loop.local_overlap`` at 1, counters in the
    layout (two ``ndt_sgh_unpacked[g1]`` over the 4,624 hypotheses and
    the refinement, two ``lm_ndt[g1l8]``, one gated verify, one K3[g1]),
    gated against the JAX package's overlap-1 merge
    (``tests/data/torch_config5_overlap1_ref.json``): the alignment within
    max(0.1 m / 0.02 rad, 2 x JAX f32's error), a loop wherever JAX closes
    one, B's placement as phase 12's; K12[g1] against its plain versions
    at the alignment's two shapes;
13. the distributed solve (:func:`run_distributed`): ``python -m
    ndtpu_torch.dist.launch`` as two ranks on the card over gloo
    (``launch_local``), on phase 12's merged graph, gated on chi^2 and
    against phase 12's in-process solve, each rank's counters reset in the
    rank just before its solve (one K9c and two K5 launches and four
    all-reduces per iteration); then K9c against its plain version on both
    ranks' rows;
14. the reference's multi-process SLAM rehearsal (:func:`run_slam_launch`):
    ``launch_local(2, task="slam", device="cuda")``, two box-world
    sessions of 120 scans, one per rank, every plain version raising on
    CUDA tensors in the ranks; gated on keyframes and ATE
    (test_launch.py:38) and each rank's state bit-equal to an in-process
    ``run_slam_windowed`` of its session on the card;
15. config 5's slab-sharded map (:func:`run_slab`) at its published widths
    (256 x 256 at 0.5 m, two ranks of 128 columns): each rank runs its
    session of phase 12's pair through ``run_sessions_sharded`` (bit-equal
    to phase 12's), builds its slab of the merged map from its own
    session's keyframe points (K10a ``slab_accumulate`` and the halo
    exchange, the smallest halo that drops no point) and from both
    sessions' (replicated), finalizes it (K10b ``finalize_cells``, on
    the exchange's records in place for the point-sharded build),
    registers 16 of B's keyframe scans with ``match_slab`` (K10c
    ``slab_sgh`` and one SUM per evaluation) and 64 with
    ``match_batch_sharded``; gated against each other, phase 12's merged
    map (K3) and f64 sums, the in-process ``lm_loop`` on K12 and
    ``match_batch``; then K10a, K10b (as three arrays and as records)
    and K10c against their plain versions at the ranks' shapes;
15b. the slab map at overlap 1 (:func:`run_slab` with
    :data:`CONFIG5_OVERLAP1`) on phase 12b's sessions and merged map: the
    same builds, exchange, finalize and registrations in two ranks
    (``slab_accumulate[g1]``, ``finalize_cells``, ``slab_sgh[g1]``), the
    same gates against 12b's K3[g1] map, and K10a[g1], K10b and K10c[g1]
    against their plain versions (K10a then at G = 4 on the same slab
    shape: its tile plan and work buffer follow the grid count);
16. the per-scan path and the inputs (:func:`run_scan_phase`), every
    plain version (``pack_quad`` included) refusing CUDA tensors:
    ``ndtpu_torch.run.main --mode scan`` on config 2 (300 scans) and config
    3 (600), counters reset just before and read just after (one K11
    launch for the input, one ``lm_ndt`` and one K4 per scan, on config 3
    one K8a and one gated verify per keyframe); the card-made corridor
    sequence against the CPU-made one; box-world draws 0-2 of both configs
    through ``run_slam`` on card-made sequences (each against the CPU-made
    one: equal hashes, or every differing element printed and at most 10
    of one f32 ulp), gated by config 2's rule against the JAX package's
    per-scan run (``tests/data/torch_scan_box300_ref.json``, a loop
    wherever JAX closes one); ``detect_loops`` (the fresh-map verify: one
    K3s, one K4s, one gated ``lm_ndt``) at the end-of-lap query of config
    3's draw 0 against its plain route, in every table layout of its local
    maps (``loop.local_overlap``, ``match.compact_table``), with the plain
    route's time on the host's CPU; the step's host syncs (one per
    scan, at most two more on a keyframe besides the smoother's);
    ``--dataset`` in both modes at
    config 3 on a CARMEN log written from the CLI's corridor sequence (the
    native parser equal to the Python one; within 0.5 m ATE of the written
    sequence),
    ``serve --datasets`` on two written logs; config 2 with
    ``downsample_voxel = 0.1`` through the CLI (one K13 launch, the kept
    count equal to the plain version's); ``--checkpoint-dir`` with
    ``--resume`` in both modes at config 3 (600 corridor scans, resumed at
    scan 512: the final state bit-equal to the uninterrupted run's);
17. every kernel launched in its entry-point phase (``lm_ndt``, K3, K4 in
    phases 4 and 7b; each layout variant, ``lm_ndt[g1l8]`` and the like, in the
    phase-7c runs of its layout; also ``lm_ndt_grouped``, K8a and the gated
    verify ``loop_gate_fused`` in phase 6; K3s, K4s, K5, K6b, K8a and the gated
    verify in phase 10; each layout's K3s and K4s (``halfcell_add_stacked
    [g1]``, ``finalize_pack_stacked[g4l4]``, ...), grouped ``lm_ndt``, K8a
    and gated verify in its phase-10b run; ``lm_ndt``, K12, K3 and the gated
    verify in phase 12, ``ndt_sgh_unpacked[g1]`` and K3[g1] in 12b;
    K9c and K5 in phase 13's ranks; K10a, K10b and K10c in phase 15's ranks,
    ``slab_accumulate[g1]``, K10b and ``slab_sgh[g1]`` in 15b's;
    K6g in phases 8b, 8c and 12; ``local_select[scratch]`` (K7a past the
    shared route) in phase 8d's update; K11 in phases 4, 6, 7d, 10 and 16, K7a
    and K7b also in 7d, K13 in phase 16; K14 in phases 4, 6, 7d and 10, its
    loop entry in 6, 7d and 10, its row entry and K16 in 10), exactly one ``lm_ndt*`` launch
    per ``match_batch_packed`` call (phases 4, 6 and 16), and in phase 6 one gated verify per
    loop-detection call and no standalone K8b launch; K5, K7a and K7b launched
    in phases 4 and 6, K6 in phase 6 (config 2 may never take the global path),
    one ``pcg_solve`` launch per PCG solve, and a full solve in phase 6; K5,
    K9a and K9b in phase 8. K1's and K8b's own launches are not required there:
    on the main path their code runs inside ``lm_ndt``, and they are held to
    their twins in phase 3.

The second-to-last line is one JSON object with the kernels' launches (phases
4, 6, 7b, 7c, 7d, 8, 8b, 8c, 8d, 10, 10b, 12, 12b and 13-16, 15b together),
errors,
times and bounds,
config 1's and the layout runs' results (``config1``, ``layouts``), the
repeated runs' ATEs, the smoother's counts and bench.py §5's three 10k cells,
the multilap's results (``multilap``),
config 4's runs (supernodal and PCG) and step timing, the serving run's
aggregate scans/s and per-session results, and config 5's merge, distributed
solve, SLAM rehearsal and slab map (and the overlap-1 merge and slab
map), and each phase's seconds (``phase_s``); the last line is ``{"ok":
true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CONFIG2 = ROOT / "configs" / "config2_full_sequence.json"
CONFIG3 = ROOT / "configs" / "config3_loop_closure.json"
CONFIG5 = ROOT / "configs" / "config5_multisession.json"
REF_FILE = ROOT / "tests" / "data" / "torch_config2_box300_ref.json"
REF3_FILE = ROOT / "tests" / "data" / "torch_config3_box300_ref.json"
#: Config 4 (BASELINE's 10k-pose Manhattan world; bench.py's BA cell and
#: ``solve_g2o --manhattan 10000 --shards 64``): poses, shards, the step's
#: damping, and the JAX package's final chi^2 on the same graph.
CONFIG4 = dict(n_poses=10000, shards=64, lam=1e-3)
REF4_FILE = ROOT / "tests" / "data" / "torch_config4_manhattan10k_ref.json"
#: The JAX package's ``solve_g2o --manhattan 10000 --method pcg`` results.
REF4_PCG_FILE = ROOT / "tests" / "data" / "torch_config4_pcg10k_ref.json"
#: Stacked multi-session serving: ``python -m ndtpu_torch.serve --config
#: configs/config_serving.json --sessions 8 --max-scans 300``, and the JAX
#: package's per-session results on the same 8 sessions.
SERVING = ROOT / "configs" / "config_serving.json"
SERVING_ARGS = ["--config", str(SERVING), "--sessions", "8", "--max-scans",
                "300"]
REF_SERVING_FILE = ROOT / "tests" / "data" / "torch_serving8_box300_ref.json"
#: Stacked serving in the other table layouts (phase 10b): ``(name, the
#: fields changed)`` on ``configs/config_serving.json``, and the JAX
#: package's per-session results on the same 8 sessions under the same
#: flags.
SERVING_LAYOUT_RUNS = (
    ("serving_overlap1", {"grid": {"overlap": 1},
                          "loop": {"local_overlap": 1}}),
    ("serving_compact", {"match": {"compact_table": True}}),
    ("serving_overlap1_compact", {"grid": {"overlap": 1},
                                  "loop": {"local_overlap": 1},
                                  "match": {"compact_table": True}}),
)
REF_SERVING_LAYOUTS_FILE = (ROOT / "tests" / "data"
                            / "torch_serving8_layouts_box300_ref.json")
#: Config 1, the windowed odometry front end, and the JAX package's results
#: on box-world draws 0-2 at its widths.
CONFIG1 = ROOT / "configs" / "config1_odometry.json"
REF1_FILE = ROOT / "tests" / "data" / "torch_config1_box300_ref.json"
#: The windowed path in the other table layouts (``kernels.LAYOUTS``):
#: ``(name, published config, CLI scans, the fields changed)``, and the JAX
#: package's box-world results under the same flags.
LAYOUT_RUNS = (
    ("config2_overlap1", "configs/config2_full_sequence.json", 300,
     {"grid": {"overlap": 1}}),
    ("config3_compact", "configs/config3_loop_closure.json", 600,
     {"match": {"compact_table": True}}),
    ("config3_overlap1_compact", "configs/config3_loop_closure.json", 600,
     {"grid": {"overlap": 1}, "loop": {"local_overlap": 1},
      "match": {"compact_table": True}}),
    ("config3_overlap1", "configs/config3_loop_closure.json", 600,
     {"grid": {"overlap": 1}, "loop": {"local_overlap": 1}}),
)
REF_LAYOUTS_FILE = ROOT / "tests" / "data" / "torch_layouts_box300_ref.json"
#: The JAX package's per-scan ``run_slam`` on box-world draws 0-2 at
#: configs 2 and 3 (phase 16's gates).
REF_SCAN_FILE = ROOT / "tests" / "data" / "torch_scan_box300_ref.json"

#: One H100 SXM's published peaks (NVIDIA's data sheet, at 700 W): HBM
#: bytes/s and f32 FLOP/s outside the tensor cores.
HBM_BYTES_S = 3.35e12
F32_FLOP_S = 67e12
#: ... and its f64 FLOP/s outside the tensor cores (K11 runs in f64).
F64_FLOP_S = 34e12
def beam_flops(grids: int = 4, lanes: int = 8) -> int:
    """Operations per in-bounds beam per evaluation of the 11 sums in a table
    layout, counted from ``csrc/ndt_sums.cuh``: 20 f32 for the transform,
    binning and derivatives, 71 for each overlap grid, and 4 integer
    operations per grid to unpack a compact slot's two bf16 pairs (two
    shifts, two masks)."""
    return 20 + grids * 71 + (4 * grids if lanes == 4 else 0)


def table_layout(table, grid) -> tuple:
    """``(G, L)`` of a quad table (or stack of them) on ``grid``."""
    return grid.overlap, table.shape[-1] // grid.overlap
#: f32 operations of one LM step of a lane (damped Cramer solve, clip,
#: accept and stop tests), counted from ``csrc/lm_ndt.cu``.
STEP_FLOPS = 80

#: The box-world scenario of bench.py's end-to-end section.
BOX = dict(half=11.0, n_scans=300, traj_half=7.0, step=0.2, max_range=20.0,
           min_range=0.1, odom_trans_std=0.04, odom_rot_std=0.01)

#: Config 5's merge pair at ``configs/config5_multisession.json``: session
#: A one lap of the corridor ring (``corridor_loop_world(outer=20,
#: width=4)``, 480 scans at 0.3 m along its centre line, 144 m), session B
#: 300 scans of the same ring starting 20 steps (6 m) along from A's start,
#: each with its own noise seed; the JAX package's results on this pair are
#: ``tests/data/torch_config5_merge_ref.json``.
CONFIG5_PAIR = dict(outer=20.0, width=4.0, half=18.0, step=0.3, n_a=480,
                    n_b=300, shift=20, seeds=(0, 1), odom_trans_std=0.03,
                    odom_rot_std=0.008)
REF5_FILE = ROOT / "tests" / "data" / "torch_config5_merge_ref.json"
#: Config 5 at overlap 1 (phases 12b and 15b): the fields changed on
#: ``configs/config5_multisession.json``, and the JAX package's overlap-1
#: merge of the same pair.
CONFIG5_OVERLAP1 = {"grid": {"overlap": 1}, "loop": {"local_overlap": 1}}
REF5_OVERLAP1_FILE = (ROOT / "tests" / "data"
                      / "torch_config5_overlap1_ref.json")

_CSRC = "ndtpu_torch/kernels/csrc/"
#: Every kernel, with the entry-point runs that must launch it (``paths``:
#: config 2, 3 and 4 are phases 4, 6 and 8), or the kernel whose launch
#: runs its code on the main path (``inside``).
KERNELS = [
    dict(name="lm_ndt", source=_CSRC + "lm_ndt.cu",
         replaces="ndtpu/ndt/match.py:308",
         paths=("config1", "config2", "config3", "config5")),
    dict(name="lm_ndt_grouped", source=_CSRC + "lm_ndt.cu",
         replaces="ndtpu/ndt/match.py:308",
         paths=("config3", "serving", "config5")),
    dict(name="ndt_terms", source=_CSRC + "ndt_terms.cu",
         replaces="ndtpu/ndt/match.py:237", inside="lm_ndt"),
    dict(name="ndt_terms_grouped", source=_CSRC + "ndt_terms.cu",
         replaces="ndtpu/ndt/grid.py:450", inside="lm_ndt_grouped"),
    dict(name="halfcell_add", source=_CSRC + "halfcell_add.cu",
         replaces="ndtpu/ndt/grid.py:161",
         paths=("config1", "config2", "config3", "config5")),
    # K3s and K4s: the serving path's map ops over all 8 sessions' maps.
    dict(name="halfcell_add_stacked", source=_CSRC + "halfcell_add.cu",
         replaces="ndtpu/dist/slam_dp.py:317", paths=("serving",)),
    dict(name="finalize_pack", source=_CSRC + "finalize_pack.cu",
         replaces="ndtpu/ndt/grid.py:232",
         paths=("config1", "config2", "config3")),
    dict(name="finalize_pack_stacked", source=_CSRC + "finalize_pack.cu",
         replaces="ndtpu/dist/slam_dp.py:300", paths=("serving",)),
    dict(name="local_tables", source=_CSRC + "local_tables.cu",
         replaces="ndtpu/loop/closure.py:84", paths=("config3", "serving")),
    dict(name="loop_gate", source=_CSRC + "loop_gate.cu",
         replaces="ndtpu/loop/closure.py:171", inside="loop_gate_fused"),
    dict(name="loop_gate_fused", source=_CSRC + "lm_ndt.cu",
         replaces="ndtpu/loop/closure.py:171",
         paths=("config3", "serving", "config5")),
    dict(name="factor_linearize", source=_CSRC + "factor_linearize.cu",
         replaces="ndtpu/graph/factors.py:225",
         paths=("config2", "config3", "config4", "serving", "config5_dist")),
    # Config 2's runs may never take the global path nor reach the full
    # solve (PERF.md), so K6 is required in the config-3 phase only.
    dict(name="pcg_solve", source=_CSRC + "pcg_solve.cu",
         replaces="ndtpu/graph/solve.py:167", paths=("config3",)),
    # K6g: K6 past one block; config 4 by PCG (phase 8b), bench.py §5's
    # active 10k update (phase 8c) and config 5's merge solves (phase 12).
    dict(name="pcg_solve_grid", source=_CSRC + "pcg_grid.cu",
         replaces="ndtpu/graph/solve.py:167",
         paths=("config4_pcg", "incremental_10k", "config5")),
    # K6b: the stacked smoother's per-session PCGs, serving only.
    dict(name="pcg_solve_blocked", source=_CSRC + "pcg_solve.cu",
         replaces="ndtpu/graph/solve.py:215", paths=("serving",)),
    dict(name="local_select", source=_CSRC + "local_system.cu",
         replaces="ndtpu/graph/incremental.py:120",
         paths=("config2", "config3", "multilap")),
    # K7a's scratch route: a local-path update on a graph of 70,064 pose
    # slots, past the shared route (phase 8d).
    dict(name="local_select[scratch]", source=_CSRC + "local_system.cu",
         replaces="ndtpu/graph/incremental.py:173",
         paths=("select_past_block",)),
    dict(name="local_assemble", source=_CSRC + "local_system.cu",
         replaces="ndtpu/dist/schur.py:318",
         paths=("config2", "config3", "multilap")),
    # The supernodal step runs on config 4's path only.
    dict(name="supernodal_assemble", source=_CSRC + "supernodal.cu",
         replaces="ndtpu/graph/supernodal.py:158", paths=("config4",)),
    dict(name="schur_reduce", source=_CSRC + "supernodal.cu",
         replaces="ndtpu/graph/supernodal.py:338", paths=("config4",)),
    # Config 5: K12 ranks the merge's hypotheses (phase 12); K9c is each
    # rank's step of the distributed solve (phase 13, counted in the ranks).
    dict(name="ndt_sgh_unpacked", source=_CSRC + "ndt_unpacked.cu",
         replaces="ndtpu/ndt/match.py:108", paths=("config5",)),
    dict(name="schur_local_assemble", source=_CSRC + "supernodal.cu",
         replaces="ndtpu/dist/schur.py:386", paths=("config5_dist",)),
    # Config 5's slab map (phase 15, counted in its two ranks): K10a builds
    # each rank's slab, K10b finalizes it, K10c is match_slab's per-rank
    # terms.
    dict(name="slab_accumulate", source=_CSRC + "slab_accum.cu",
         replaces="ndtpu/dist/gridmap.py:66", paths=("config5_slab",)),
    dict(name="finalize_cells", source=_CSRC + "finalize_cells.cu",
         replaces="ndtpu/ndt/grid.py:232",
         paths=("config5_slab", "config5_slab_overlap1")),
    dict(name="slab_sgh", source=_CSRC + "ndt_unpacked.cu",
         replaces="ndtpu/dist/gridmap.py:189", paths=("config5_slab",)),
    # K11: every synthetic sequence made on the card (the CLI's in both
    # modes, serving's sessions, the multilap's); K13: the CLI with
    # downsample_voxel > 0.
    dict(name="raycast", source=_CSRC + "raycast.cu",
         replaces="ndtpu/data/synth.py:124",
         paths=("config2", "config3", "serving", "scan_config2",
                "scan_config3", "multilap")),
    dict(name="voxel_downsample", source=_CSRC + "voxel_downsample.cu",
         replaces="ndtpu/data/preprocess.py:24", paths=("downsample",)),
    # K13's scan route: scans past its table's shared memory (phase 3).
    dict(name="voxel_downsample[scan]", source=_CSRC + "voxel_downsample.cu",
         replaces="ndtpu/data/preprocess.py:24",
         paths=("downsample_past_table",)),
    # K14: the window's masked appends (one launch a window on the windowed
    # path, one a stacked pass in serving), its loop entry (a window with
    # loop closure on) and its row write (serving's refresh).
    dict(name="window_append", source=_CSRC + "window_append.cu",
         replaces="ndtpu/slam/pipeline.py:419",
         paths=("config2", "config3", "serving", "multilap")),
    dict(name="window_append[loops]", source=_CSRC + "window_append.cu",
         replaces="ndtpu/slam/pipeline.py:484",
         paths=("config3", "serving", "multilap")),
    dict(name="window_append[rows]", source=_CSRC + "window_append.cu",
         replaces="ndtpu/slam/pipeline.py:161", paths=("serving",)),
    # K15: the loop verify's set-up, one launch a detection (config 3's
    # windows, serving's stacked windows for all sessions, the per-scan
    # path's keyframes, the multilap); the merge's loop search (the
    # candidates given).
    dict(name="loop_lanes", source=_CSRC + "loop_lanes.cu",
         replaces="ndtpu/loop/closure.py:101",
         paths=("config3", "serving", "scan_config3", "multilap", "config5",
                "config3_overlap1", "serving_overlap1")),
    # K16: serving's top-M map refresh, one launch a refresh for all
    # sessions.
    dict(name="refresh_points", source=_CSRC + "refresh_points.cu",
         replaces="ndtpu/slam/pipeline.py:146", paths=("serving",)),
    # K3 at overlap 1, in the layout runs whose map has one grid.
    dict(name="halfcell_add[g1]", source=_CSRC + "halfcell_add.cu",
         replaces="ndtpu/ndt/grid.py:120",
         paths=("config2_overlap1", "config3_overlap1",
                "config3_overlap1_compact", "config5_overlap1")),
    # Stacked serving in the other layouts (phase 10b): K3s at overlap 1,
    # K4s in the three other layouts.
    dict(name="halfcell_add_stacked[g1]", source=_CSRC + "halfcell_add.cu",
         replaces="ndtpu/dist/slam_dp.py:317",
         paths=("serving_overlap1", "serving_overlap1_compact")),
    dict(name="finalize_pack_stacked[g1l8]",
         source=_CSRC + "finalize_pack.cu",
         replaces="ndtpu/dist/slam_dp.py:300", paths=("serving_overlap1",)),
    dict(name="finalize_pack_stacked[g4l4]",
         source=_CSRC + "finalize_pack.cu",
         replaces="ndtpu/dist/slam_dp.py:300", paths=("serving_compact",)),
    dict(name="finalize_pack_stacked[g1l4]",
         source=_CSRC + "finalize_pack.cu",
         replaces="ndtpu/dist/slam_dp.py:300",
         paths=("serving_overlap1_compact",)),
    # Config 5 at overlap 1: K12 in the merge (phase 12b), K10a and K10c in
    # the slab map's ranks (phase 15b).
    dict(name="ndt_sgh_unpacked[g1]", source=_CSRC + "ndt_unpacked.cu",
         replaces="ndtpu/ndt/match.py:108", paths=("config5_overlap1",)),
    dict(name="slab_accumulate[g1]", source=_CSRC + "slab_accum.cu",
         replaces="ndtpu/dist/gridmap.py:66",
         paths=("config5_slab_overlap1",)),
    dict(name="slab_sgh[g1]", source=_CSRC + "ndt_unpacked.cu",
         replaces="ndtpu/dist/gridmap.py:189",
         paths=("config5_slab_overlap1",)),
]


def _layout_variants(grids: int, lanes: int, map_runs, local_runs) -> list:
    """KERNELS' rows of one table layout (``kernels.variant``'s names):
    ``lm_ndt``, K4 in the runs whose map has the layout, the grouped
    ``lm_ndt``, K8a and the gated verify in those whose local tables have
    it; K1 runs inside ``lm_ndt`` there."""
    v = lambda name: f"{name}[g{grids}l{lanes}]"
    return [
        dict(name=v("lm_ndt"), source=_CSRC + "lm_ndt.cu",
             replaces="ndtpu/ndt/match.py:308", paths=map_runs),
        dict(name=v("lm_ndt_grouped"), source=_CSRC + "lm_ndt.cu",
             replaces="ndtpu/ndt/match.py:308", paths=local_runs),
        dict(name=v("ndt_terms"), source=_CSRC + "ndt_terms.cu",
             replaces="ndtpu/ndt/match.py:237", inside=v("lm_ndt")),
        dict(name=v("ndt_terms_grouped"), source=_CSRC + "ndt_terms.cu",
             replaces="ndtpu/ndt/grid.py:450", inside=v("lm_ndt_grouped")),
        dict(name=v("finalize_pack"), source=_CSRC + "finalize_pack.cu",
             replaces="ndtpu/ndt/grid.py:336", paths=map_runs),
        dict(name=v("local_tables"), source=_CSRC + "local_tables.cu",
             replaces="ndtpu/loop/closure.py:84", paths=local_runs),
        dict(name=v("loop_gate_fused"), source=_CSRC + "lm_ndt.cu",
             replaces="ndtpu/loop/closure.py:171", paths=local_runs)]


KERNELS += (_layout_variants(1, 8, ("config2_overlap1", "config3_overlap1"),
                             ("config3_overlap1", "serving_overlap1"))
            + _layout_variants(4, 4, ("config3_compact",),
                               ("config3_compact", "serving_compact"))
            + _layout_variants(1, 4, ("config3_overlap1_compact",),
                               ("config3_overlap1_compact",
                                "serving_overlap1_compact")))


class SmokeFailure(RuntimeError):
    pass


def require(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def box_sequence(seed: int, n_beams: int, device="cpu",
                 n_scans: int = BOX["n_scans"]):
    """Draw ``seed`` of the box-world scenario (port synth)."""
    from ndtpu_torch.data import synth

    world = synth.box_world(BOX["half"])
    traj = synth.rectangle_trajectory(n_scans, half=BOX["traj_half"],
                                      step=BOX["step"])
    return synth.make_sequence(world, traj, n_beams=n_beams,
                               max_range=BOX["max_range"],
                               min_range=BOX["min_range"], seed=seed,
                               odom_trans_std=BOX["odom_trans_std"],
                               odom_rot_std=BOX["odom_rot_std"], device=device)


def config5_sessions(device="cpu"):
    """Config 5's two sessions (:data:`CONFIG5_PAIR`, the port's synth, f32)
    on ``device``: ``([seq_a, seq_b], t_true [3], scenario)``, ``t_true``
    the pose of B's first scan in A's first scan's frame (each session
    anchors its frame at its first scan)."""
    from ndtpu_torch.config import PipelineConfig
    from ndtpu_torch.data import synth
    from ndtpu_torch.lie import se2

    c = CONFIG5_PAIR
    cfg = PipelineConfig.from_json(str(CONFIG5))
    world = synth.corridor_loop_world(outer=c["outer"], width=c["width"])
    traj_a = synth.rectangle_trajectory(c["n_a"], half=c["half"],
                                        step=c["step"])
    traj_b = synth.rectangle_trajectory(c["n_b"] + c["shift"],
                                        half=c["half"],
                                        step=c["step"])[c["shift"]:]
    seqs = [synth.make_sequence(world, traj, cfg.n_beams, cfg.max_range,
                                cfg.min_range, seed=seed,
                                odom_trans_std=c["odom_trans_std"],
                                odom_rot_std=c["odom_rot_std"], device=device)
            for traj, seed in zip((traj_a, traj_b), c["seeds"])]
    scenario = (f"corridor_loop_world(outer={c['outer']}, width={c['width']})"
                f"; A rectangle_trajectory({c['n_a']}, half={c['half']}, "
                f"step={c['step']}), B the next {c['n_b']} poses of that "
                f"trajectory from step {c['shift']}; {cfg.n_beams} beams, "
                f"odometry noise {c['odom_trans_std']} m / "
                f"{c['odom_rot_std']} rad, seeds {c['seeds']}; sequences "
                f"from ndtpu_torch.data.synth.make_sequence")
    return seqs, se2.between(traj_a[0], traj_b[0]), scenario


def sequence_hashes(seq) -> dict:
    """sha256 of the f32 points, bool mask and f32 odometry bytes."""
    out = {}
    for key in ("points", "mask", "odom"):
        a = getattr(seq, key).detach().cpu().contiguous().numpy()
        out[key] = hashlib.sha256(a.tobytes()).hexdigest()
    return out


def dead_reckoning(odom):
    """Poses ``[T, 3]`` chained from identity through the odometry."""
    import torch

    from ndtpu_torch.lie import se2

    poses = [torch.zeros(3, dtype=odom.dtype, device=odom.device)]
    for t in range(1, odom.shape[0]):
        poses.append(se2.compose(poses[-1], odom[t]))
    return torch.stack(poses)


def sequence_log(seq, max_range: float):
    """A CARMEN log (``ndtpu_torch.data.carmen.CarmenLog``) of a synthetic
    sequence, for ``write_carmen(..., style="robotlaser")``: each valid
    beam's range (``|point|``), ``max_range`` elsewhere; robot and laser at
    the dead-reckoned odometry poses (no extrinsics); the metadata of
    ``synth.beam_angles`` (start -pi, sweep 2 pi (N - 1) / N), so
    ``to_sequence`` gives the sequence's points back to the log's print
    precision."""
    import math

    import numpy as np

    from ndtpu_torch.data import carmen

    pts = seq.points.double().cpu().numpy()
    msk = seq.mask.cpu().numpy()
    t, n = msk.shape
    ranges = np.where(msk, np.hypot(pts[..., 0], pts[..., 1]),
                      max_range).astype(np.float32)
    odo = dead_reckoning(seq.odom.double()).cpu().numpy()
    return carmen.CarmenLog(
        ranges=ranges, n_beams=np.full(t, n, np.int32), laser_pose=odo,
        odom_pose=odo.copy(), timestamps=np.arange(t, dtype=np.float64),
        start_angle=-math.pi, fov=2.0 * math.pi * (n - 1) / n,
        log_max_range=float(max_range))


def map_stats(seq, grid, device):
    """Map statistics of every scan inserted at its true pose."""
    from ndtpu_torch.lie import se2
    from ndtpu_torch.ndt import grid as ndt_grid

    pts = se2.transform(seq.gt_poses.to(device), seq.points.to(device))
    return ndt_grid.add_points(
        ndt_grid.empty_stats(grid, pts.dtype, device), pts.reshape(-1, 2),
        seq.mask.to(device).reshape(-1), grid)


def time_ms(fn, reps: int = 20) -> float:
    """Median of ``reps`` synchronized runs, by CUDA events (after warm-up)."""
    import torch

    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        ts.append(a.elapsed_time(b))
    return statistics.median(ts)


def snap(t, bits: int):
    """Round to multiples of 2^-bits m."""
    import torch

    scale = float(2 ** bits)
    return torch.round(t * scale) / scale


def _table_check(name, out, ref, layout=(4, 8)):
    """K4's rule: valid flags exact, the rest within 1e-5 x max(|ref|,
    1e-3 x the column's max |ref|). Compact rows (``layout`` ``(G, 4)``):
    the bf16-pair lanes (i00|i01, i11|valid) bit-equal as int32, the means
    by the rule. Returns the max abs error."""
    import torch

    g_dim, lanes = layout
    if lanes == 4:
        packed = [4 * g + k for g in range(g_dim) for k in (2, 3)]
        means = [4 * g + k for g in range(g_dim) for k in (0, 1)]
        require(torch.equal(out[..., packed].contiguous().view(torch.int32),
                            ref[..., packed].contiguous().view(torch.int32)),
                f"{name}: bf16-pair lanes not bit-equal (int32)")
        out, ref = out[..., means], ref[..., means]
    else:
        valid_cols = [8 * g + 5 for g in range(g_dim)]
        require(bool((out[..., valid_cols] == ref[..., valid_cols]).all()),
                f"{name}: valid flags differ")
    require(bool(torch.isfinite(out).all()), f"{name}: non-finite table")
    err = (out - ref).abs()
    col_max = ref.abs().reshape(-1, ref.shape[-1]).amax(0)
    tol = 1e-5 * torch.maximum(ref.abs(), 1e-3 * col_max)
    require(bool((err <= tol).all()),
            f"{name}: table off by {float((err / (tol + 1e-30)).max()):.3g} "
            f"x tol")
    return float(err.max())


def valid_slots(table, layout=(4, 8)) -> int:
    """Valid cell slots of a quad table (the valid lane, or the high half
    of a compact slot's last lane)."""
    import torch

    g_dim, lanes = layout
    if lanes == 8:
        return int(table[..., [8 * g + 5 for g in range(g_dim)]].sum())
    bits = table[..., [4 * g + 3 for g in range(g_dim)]].contiguous()
    hi = bits.view(torch.int32) & -65536           # 0xFFFF0000
    return int(hi.view(torch.float32).sum())


def bound(n_bytes: float, n_flops: float, flop_s: float = F32_FLOP_S
          ) -> dict:
    """The least time the card could take for work that must move
    ``n_bytes`` (each input read once, each output written once) and do
    ``n_flops`` operations at ``flop_s`` (f32 unless given): the larger of
    the two times at the H100's peaks. No single PyTorch call computes any
    of these kernels' functions, so ``library_ms`` is null for every row."""
    tb = n_bytes / HBM_BYTES_S * 1e3
    tf = n_flops / flop_s * 1e3
    return dict(bound_ms=max(tb, tf),
                bound_by="bytes" if tb >= tf else "operations",
                library_ms=None)


def lane_rows(poses, px, py, mask_f, grid, group=None):
    """Keys of the quad rows the lanes gather at ``poses`` (table index x R
    + row, one per masked in-bounds beam) and each lane's count of such
    beams, by the kernels' binning."""
    import torch

    from ndtpu_torch import kernels
    from ndtpu_torch.ndt import match

    x, y, _, _ = match._lane_transform(poses, px, py)
    wh, hh = kernels._lattice(grid)
    inv = kernels._inv(grid)
    hx = torch.floor((x - grid.x0) * inv)
    hy = torch.floor((y - grid.y0) * inv)
    ok = (mask_f > 0) & (hx >= 0) & (hx < wh) & (hy >= 0) & (hy < hh)
    key = hy.long() * wh + hx.long()
    if group is not None:
        key = key + group[:, None].long() * (wh * hh)
    return key[ok], ok.sum(-1)


def k1_bound(args, group=None):
    """K1's bound: poses, beams (and ``group``) read, each distinct row
    gathered once (G x L x 4 B: 128 B in the published layout), 11 sums
    written; :func:`beam_flops` per in-bounds beam."""
    poses, px, py, mask_f, table, grid = args[:6]
    g, l = table_layout(table, grid)
    keys, beams = lane_rows(poses, px, py, mask_f, grid, group)
    b, n = px.shape
    n_bytes = (b * 12 + b * n * 12 + keys.unique().numel() * g * l * 4
               + b * 44 + (0 if group is None else b * 4))
    return bound(n_bytes, float(beams.sum()) * beam_flops(g, l))


def check_k1(cfg, seq, table, seed, dev, b, jobs=None):
    """K1 vs ndt_terms_ref on the card: ``b`` lanes x 360 beams, in the
    layout of ``cfg`` (``grid.overlap``, ``match.compact_table``)."""
    import numpy as np
    import torch

    from ndtpu_torch import kernels
    from ndtpu_torch.ndt import match

    compact = cfg.match.compact_table
    name = kernels.variant("K1 ndt_terms", *kernels._layout(cfg.grid,
                                                            compact))
    rng = np.random.default_rng(seed)
    lane = np.arange(b) % seq.points.shape[0]
    noise = rng.normal(0.0, [0.05, 0.05, 0.01], (b, 3))
    poses = (seq.gt_poses[lane].double() + torch.as_tensor(noise)).float()
    args = (poses.to(dev).contiguous(),
            seq.points[lane, :, 0].to(dev).contiguous(),
            seq.points[lane, :, 1].to(dev).contiguous(),
            seq.mask[lane].float().to(dev).contiguous(), table, cfg.grid,
            cfg.match.d2, cfg.match.exp_clip)
    kern = lambda: kernels.ndt_terms(*args, compact=compact)
    twin = lambda: match.ndt_terms_ref(*args, compact)
    out, ref = kern(), twin()
    torch.cuda.synchronize()
    err = (out - ref).abs()
    tol = 1e-3 * torch.clamp(ref.abs(), min=1.0)
    require(bool(torch.isfinite(out).all()), f"{name}: non-finite sums")
    require(bool((err <= tol).all()),
            f"{name}: sums off by up to {float((err / tol).max()):.3g} x "
            f"tolerance")
    rel = float((err / torch.clamp(ref.abs(), min=1.0)).max())
    ms = time_ms(kern)
    plain = time_ms(twin)
    bd = k1_bound(args)
    print(f"[smoke] {name} B={b} N={seq.points.shape[1]}: max abs err "
          f"{float(err.max()):.3e}, max rel err {rel:.3e} (tol 1e-3 x "
          f"max(1,|ref|)); kernel {ms:.4f} ms, plain {plain:.4f} ms, bound "
          f"{bd['bound_ms']:.6f} ms ({bd['bound_by']})")
    row = dict(max_abs_err=float(err.max()), ms=ms, plain_ms=plain, **bd)
    card_time(jobs, f"{name} B={b}", row, "card_ms", kern,
              ["ndt_terms_kernel"])
    return row


def card_time(jobs, label, row, key, fn, names=None, measure=None,
              per_call=None):
    """``fn``'s card time (``profile_port.card_ms``, with ``per_call`` the
    design's launches of ``names`` per call where it is known; or
    ``measure(fn, names)``, another reading under ``torch.profiler``) into
    ``row[key]``: at once when ``jobs`` is None, else queued in ``jobs`` for
    :func:`read_card_times`. A ``torch.profiler`` session leaves the later
    CUDA launches of the process slower, so the smoke reads card times after
    its event-timed and entry-point phases."""
    if jobs is None:
        from profile_port import card_ms

        row[key] = (measure(fn, names) if measure
                    else card_ms(fn, names, per_call=per_call))
    else:
        jobs.append((label, row, key, fn, names, measure, per_call))


def read_card_times(jobs):
    """Run the queued card timings (and other profiler readings), one line
    each."""
    from profile_port import card_ms

    for label, row, key, fn, names, measure, per_call in jobs:
        if measure is None:
            row[key] = card_ms(fn, names, per_call=per_call)
            print(f"[smoke] card time {label}: {_fmt(row[key])} per call "
                  f"(torch.profiler, mean of 20; operations per session "
                  f"{card_ms.counts})")
            if row[key] is None:
                print(f"[smoke]   last session: {card_ms.detail}"[:600])
        else:
            row[key] = measure(fn, names)
            print(f"[smoke] {label}: "
                  f"{'not measured' if row[key] is None else row[key]}")


def _fmt(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


def bits_equal(a, b) -> bool:
    """Tensors (or tuples of them) equal bit for bit."""
    import torch

    if isinstance(a, torch.Tensor):
        raw = lambda t: t.clone(memory_format=torch.contiguous_format
                                ).reshape(-1).view(torch.uint8)
        return (a.shape == b.shape and a.dtype == b.dtype
                and torch.equal(raw(a), raw(b)))
    return all(bits_equal(x, y) for x, y in zip(a, b))


def k3_identity(label, base, pts, msk, weight, grid, seed):
    """K3 bit for bit: equal to ``halfcell_add_fixed_ref`` on the same card
    inputs, on a second launch, and with the points (and weights) in a
    random order."""
    import numpy as np
    import torch

    from ndtpu_torch.ndt import grid as ndt_grid

    perm = torch.as_tensor(np.random.default_rng(seed).permutation(
        pts.shape[0]), device=pts.device)
    wp = weight[perm] if isinstance(weight, torch.Tensor) else weight
    one = ndt_grid.halfcell_add(base, pts, msk, weight, grid)
    two = ndt_grid.halfcell_add(base, pts, msk, weight, grid)
    shuf = ndt_grid.halfcell_add(base, pts[perm].contiguous(),
                                 msk[perm].contiguous(), wp, grid)
    model = ndt_grid.halfcell_add_fixed_ref(base, pts, msk, weight, grid)
    torch.cuda.synchronize()
    require(bits_equal(one, model),
            f"K3 {label}: not bit-equal to halfcell_add_fixed_ref")
    require(bits_equal(one, two), f"K3 {label}: two launches differ")
    require(bits_equal(one, shuf), f"K3 {label}: permuted points differ")
    return one


def _k3_case(cfg, base, pts, msk, weight, exact_counts):
    import torch

    from ndtpu_torch import kernels
    from ndtpu_torch.ndt import grid as ndt_grid

    grid = cfg.grid
    out = k3_identity(f"M={pts.shape[0]}", base, pts, msk, weight, grid,
                      pts.shape[0])
    cpu = lambda t: t.detach().cpu().double()
    w64 = cpu(weight) if isinstance(weight, torch.Tensor) else weight
    ref = ndt_grid.halfcell_add_ref(
        ndt_grid.NDTStats(*(cpu(t) for t in base)), cpu(pts), msk.cpu(), w64,
        grid)
    # Per-cell magnitude: |base| + (sum of |w| in the cell) * R^k for the
    # k-th order moment, R the largest |coordinate|; f32 adds in any order
    # stay within a few ulp of it.
    wabs = w64.abs() if isinstance(w64, torch.Tensor) else abs(w64)
    n_abs = ndt_grid.halfcell_add_ref(
        ndt_grid.NDTStats(*(torch.zeros_like(cpu(t)) for t in base)),
        cpu(pts), msk.cpu(), wabs, grid).n
    r = float(cpu(pts).abs().max())

    def off(stats):
        worst, max_err = 0.0, 0.0
        for k, (o, rf, b) in enumerate(zip(stats, ref, base)):
            scale = n_abs.reshape(n_abs.shape + (1,) * (rf.dim() - 2)) * r ** k
            mag = cpu(b).abs() + scale
            err = (cpu(o) - rf).abs()
            max_err = max(max_err, float(err.max()))
            worst = max(worst, float((err / (1e-5 * mag + 1e-30)).max()))
        return max_err, worst

    max_err, worst = off(out)
    if exact_counts:
        require(bool((cpu(out.n) == ref.n).all()), "K3: counts not exact")
    require(worst <= 1.0, f"K3: moments off by {worst:.3g} x tolerance")
    args = (base, pts, msk, weight, grid)
    # The f32 twin on the card (float sums in index_add_'s atomic order),
    # in the same units, for comparison.
    _, worst_f32 = off(ndt_grid.halfcell_add_ref(*args))
    ms = time_ms(lambda: kernels.halfcell_add(
        base.n, base.s, base.ss, pts, msk, weight, grid))
    plain = time_ms(lambda: ndt_grid.halfcell_add_ref(*args))
    return max_err, worst, worst_f32, ms, plain


def check_k3(cfg, seq, base, seed, dev, k, jobs=None):
    """K3 vs the f64 CPU twin: ``k`` x 360 points, +1 and mixed +-1, on
    ``cfg.grid`` (overlap 4 or 1)."""
    import numpy as np
    import torch

    from ndtpu_torch import kernels
    from ndtpu_torch.lie import se2

    rng = np.random.default_rng(seed + 1)
    lane = np.arange(k) % seq.points.shape[0]
    noise = rng.normal(0.0, [0.05, 0.05, 0.01], (k, 3))
    poses = (seq.gt_poses[lane].double() + torch.as_tensor(noise)).float()
    pts = se2.transform(poses.to(dev), seq.points[lane].to(dev)).reshape(-1, 2)
    # Snap to multiples of 2^-16 m: then x - x0 and the x4 of the binning are
    # exact in f32 as in f64, so both sides bin every point alike and the
    # counts can be held exact.
    pts = snap(pts, 16).contiguous()
    msk = seq.mask[lane].to(dev).reshape(-1).contiguous()
    e1, w1, f1, ms1, pl1 = _k3_case(cfg, base, pts, msk, 1.0, True)
    sign = np.where(rng.random(pts.shape[0]) < 0.5, -1.0, 1.0)
    wts = torch.as_tensor(sign, dtype=torch.float32, device=dev)
    e2, w2, f2, ms2, pl2 = _k3_case(cfg, base, pts, msk, wts, False)
    m = pts.shape[0]
    bd = k3_bound(m, cfg.grid)
    name = kernels.variant("K3 halfcell_add", cfg.grid.overlap)
    print(f"[smoke] {name} M={m}: bit-equal to the fixed-point "
          f"model, on a second launch and under permutation; +1 weights max "
          f"abs err {e1:.3e} ({w1:.3f} x tol, counts exact; f32 twin "
          f"{f1:.3f} x tol), +-1 weights max abs err {e2:.3e} ({w2:.3f} x "
          f"tol; f32 twin {f2:.3f} x tol; tol 1e-5 x per-cell magnitude); "
          f"kernel {ms1:.4f} / {ms2:.4f} ms, plain {pl1:.4f} / {pl2:.4f} ms, "
          f"bound {bd['bound_ms']:.6f} ms ({bd['bound_by']})")
    row = dict(max_abs_err=max(e1, e2), ms=ms1, plain_ms=pl1, **bd,
               tol_units=max(w1, w2), f32_twin_tol_units=max(f1, f2))
    card_time(jobs, f"{name} M={m}", row, "card_ms",
              lambda: kernels.halfcell_add(base.n, base.s, base.ss, pts, msk,
                                           1.0, cfg.grid), per_call=3)
    return row


def k3_bound(m: int, grid, maps: int = 1, per_point: bool = False) -> dict:
    """K3's bound (K3s: ``maps`` maps of ``m`` points each): points (8 B)
    and mask (1 B) read, with ``per_point`` weights 4 B more, the 7 floats
    of (n, s, ss) per cell of each of the G grids read and written; ~10
    operations per point to bin and weigh it, 35 per (grid, cell) to pool 7
    moments (the overlap-4 pool; 7 at overlap 1) and add them. The lattice
    scratch is not the function's."""
    c, g = grid.n_cells, grid.overlap
    per_cell = 35.0 if g == 4 else 7.0
    return bound(maps * (m * (13 if per_point else 9) + 2 * 7 * 4 * g * c),
                 maps * (10.0 * m + per_cell * g * c))


def check_k3_rebuild(cfg3, kf, dev):
    """K3 at the rebuild shape of ``_wb_maps``: every slot of the keyframe
    cache (1,024 x 360 points, live mask from the store) onto empty
    config-3 statistics; bit-equal to the fixed-point model, on a second
    launch and under permutation; timed against the plain twin."""
    import torch

    from ndtpu_torch import kernels
    from ndtpu_torch.lie import se2
    from ndtpu_torch.ndt import grid as ndt_grid

    grid = cfg3.grid
    world = se2.transform(kf.poses, kf.points).reshape(-1, 2).contiguous()
    live = (kf.masks & kf.live[:, None]).reshape(-1).contiguous()
    empty = ndt_grid.empty_stats(grid, torch.float32, dev)
    k3_identity("rebuild", empty, world, live, 1.0, grid, 11)
    ms = time_ms(lambda: kernels.halfcell_add(
        empty.n, empty.s, empty.ss, world, live, 1.0, grid))
    plain = time_ms(lambda: ndt_grid.halfcell_add_ref(empty, world, live,
                                                      1.0, grid))
    m = world.shape[0]
    bd = k3_bound(m, grid)
    name = kernels.variant("K3 halfcell_add", grid.overlap)
    print(f"[smoke] {name} rebuild M={m} ({int(live.sum())} live): "
          f"bit-equal to the fixed-point model, on a second launch and under "
          f"permutation; kernel {ms:.4f} ms, plain {plain:.4f} ms, bound "
          f"{bd['bound_ms']:.6f} ms ({bd['bound_by']})")
    return dict(rebuild_m=m, rebuild_ms=ms, rebuild_plain_ms=plain,
                rebuild_bound_ms=bd["bound_ms"])


def k4_bound(grid, compact: bool = False) -> dict:
    """K4's bound: (n, s, ss) read (7 floats per cell of each grid), the
    [R, G*L] table written; ~40 operations to finalize each of the G x C
    cells. The row also keeps the two counts (``bytes``, ``operations``)."""
    from ndtpu_torch import kernels

    c, g = grid.n_cells, grid.overlap
    wh, hh = kernels._lattice(grid)
    lanes = 4 if compact else 8
    n_bytes, ops = 28 * g * c + wh * hh * g * lanes * 4, 40.0 * g * c
    return dict(bound(n_bytes, ops), bytes=n_bytes, operations=ops)


def check_k4(label, ndt_cfg, grid, stats, jobs=None, compact: bool = False):
    """K4 vs finalize_pack_ref on the card at ``grid`` in the layout
    (``grid.overlap``, ``compact``) on the same f32 statistics (valid flags
    exact, compact bf16-pair lanes bit-equal as int32, the rest within K4's
    rtol 1e-5), bit-identical on a second launch; event, card and plain
    times, and the bound."""
    import torch

    from ndtpu_torch import kernels
    from ndtpu_torch.ndt import grid as ndt_grid

    layout = kernels._layout(grid, compact)
    name = kernels.variant("K4 finalize_pack", *layout) + f" {label}"
    run = lambda: kernels.finalize_pack(stats.n, stats.s, stats.ss, ndt_cfg,
                                        grid, compact)
    plain_fn = lambda: ndt_grid.finalize_pack_ref(stats, ndt_cfg, grid,
                                                  compact)
    out, again = run(), run()
    ref = plain_fn()
    torch.cuda.synchronize()
    require(bits_equal(out, again), f"{name}: two launches differ")
    err = _table_check(name, out, ref, layout)
    whole = bits_equal(out, ref)
    valid = valid_slots(ref, layout)
    ms = time_ms(run)
    plain = time_ms(plain_fn)
    shape = ("one thread per cell" if grid.overlap == 1 else
             "{1} bands of {0} rows, {2} threads and {3} B of shared memory "
             "each".format(*kernels.finalize_bands(grid, out.device,
                                                   compact)))
    bd = k4_bound(grid, compact)
    print(f"[smoke] {name} R={out.shape[0]} ({shape}; {valid} valid "
          f"slots): bit-identical on a second launch, valid exact"
          f"{', bf16-pair lanes bit-equal' if compact else ''}, max abs "
          f"err {err:.3e} (rtol 1e-5), whole table bit-equal to the plain "
          f"version: {whole}; kernel {ms:.4f} ms, plain "
          f"{plain:.4f} ms, bound {bd['bound_ms']:.6f} ms ({bd['bound_by']})")
    row = dict(max_abs_err=err, ms=ms, plain_ms=plain, rows=out.shape[0],
               bit_equal_to_plain=whole, **bd)
    card_time(jobs, name, row, "card_ms", run, ["finalize_pack"])
    return row


def check_k4_shapes(cfg, cfg3, seq, stats, seed, dev, jobs=None):
    """K4 at the config-2 and config-3 map tables (300-scan box-world maps)
    and at config 5's 513 x 513 lattice (statistics from ``seed``); the
    config-2 row is the result line's, the others ride along in it."""
    from ndtpu_torch.config import PipelineConfig
    from profile_port import seeded_stats

    cfg5 = PipelineConfig.from_json(str(CONFIG5))
    row = check_k4("config 2", cfg.ndt, cfg.grid, stats, jobs)
    row["shapes"] = {
        "config3": check_k4("config 3", cfg3.ndt, cfg3.grid,
                            map_stats(seq, cfg3.grid, dev), jobs),
        "config5": check_k4("config 5", cfg5.ndt, cfg5.grid,
                            seeded_stats(cfg5.grid, seed, dev), jobs)}
    return row


def box_store(cfg3, seq, dev):
    """A keyframe store at config-3 capacity: slot s holds scan s % T of
    ``seq`` at its true pose, live for s < T, its local table built by
    K8a in ``cfg3``'s layout (``loop.local_overlap``,
    ``match.compact_table``)."""
    import torch

    from ndtpu_torch.loop import closure
    from ndtpu_torch.slam.keyframes import KeyframeStore

    cap, t = cfg3.keyframe.capacity, seq.points.shape[0]
    src = torch.arange(cap) % t
    pts = seq.points[src].to(dev).contiguous()
    msk = seq.mask[src].to(dev).contiguous()
    compact = cfg3.match.compact_table
    tables = torch.zeros((cap,) + closure.local_table_shape(cfg3.loop,
                                                            compact),
                         dtype=torch.float32, device=dev)
    closure.write_local_tables(tables, torch.arange(cap, device=dev),
                               torch.ones(cap, dtype=torch.bool, device=dev),
                               pts, msk, cfg3.loop, cfg3.ndt, compact)
    return KeyframeStore(poses=seq.gt_poses[src].to(dev), points=pts,
                         masks=msk, live=torch.arange(cap, device=dev) < t,
                         n=torch.tensor(t, device=dev), tables=tables)


def _unpacked(table, layout):
    """A quad table's ``(valid, means, icov)`` lanes as f64 columns, compact
    slots unpacked (``ndt.grid.unpack_bf16_pair``)."""
    import torch

    from ndtpu_torch.ndt import grid as ndt_grid

    g_dim, lanes = layout
    valid, means, icov = [], [], []
    for g in range(g_dim):
        row = table[..., lanes * g: lanes * (g + 1)]
        means += [row[..., 0], row[..., 1]]
        if lanes == 8:
            icov += [row[..., 2], row[..., 3], row[..., 4]]
            valid.append(row[..., 5])
        else:
            i00, i01 = ndt_grid.unpack_bf16_pair(row[..., 2], torch.float64)
            i11, v = ndt_grid.unpack_bf16_pair(row[..., 3], torch.float64)
            icov += [i00, i01, i11]
            valid.append(v)
    cols = lambda xs: torch.stack([x.double() for x in xs], -1)
    return cols(valid), cols(means), cols(icov)


def check_k8a(cfg3, seq, seed, dev, w, jobs=None):
    """K8a vs its twin: ``w`` keyframes into random slots of a ``w``-slot
    cache, in ``cfg3``'s layout (``loop.local_overlap``,
    ``match.compact_table``). (a) Points snapped to 2^-4 m, so every
    moment sum is exact in f32 and kernel and twin see the same
    statistics: against the twin on the card at K4's rule (compact
    bf16-pair lanes bit-equal as int32). (b) Points snapped to 2^-16 m (f32
    and f64 bin them alike): against the f64 twin on the CPU, valid flags
    exact, means at rtol 1e-5, and the inverse covariances' error reported
    (f32 cancellation in ss/n - mean^2 on thin wall cells bounds it; bf16
    rounding in compact rows). (c) The scans as they are: bit-identical on
    a second launch, with each scan's points in a random order, and to K4
    of K3's statistics of each scan. Timed writing into a cache allocated
    once, as the main path does."""
    import numpy as np
    import torch

    from ndtpu_torch import kernels
    from ndtpu_torch.loop import closure
    from ndtpu_torch.ndt import grid as ndt_grid

    compact = cfg3.match.compact_table
    rng = np.random.default_rng(seed + 4)
    lane = torch.as_tensor(rng.integers(0, seq.points.shape[0], w))
    slots = torch.as_tensor(rng.permutation(w))
    ok = torch.ones(w, dtype=torch.bool)
    shape = (w,) + closure.local_table_shape(cfg3.loop, compact)
    msk = seq.mask[lane]
    lgrid = closure.local_grid_config(cfg3.loop)
    layout = kernels._layout(lgrid, compact)
    name = kernels.variant("K8a local_tables", *layout)
    cache = torch.zeros(shape, dtype=torch.float32, device=dev)
    slot_d, ok_d, msk_d = slots.to(dev, torch.int32), ok.to(dev), msk.to(dev)

    def kernel(pts, m=msk_d):
        return kernels.local_tables(cache, slot_d, ok_d, pts, m, lgrid,
                                    cfg3.ndt, compact)

    raw = seq.points[lane].to(dev).contiguous()
    one = kernel(raw).clone()
    two = kernel(raw).clone()
    perm = torch.as_tensor(rng.permutation(raw.shape[1]), device=dev)
    shuf = kernel(raw[:, perm].contiguous(), msk_d[:, perm].contiguous())
    torch.cuda.synchronize()
    require(bits_equal(one, two), f"{name}: two launches differ")
    require(bits_equal(one, shuf), f"{name}: permuted points differ")
    for k in range(w):
        st = ndt_grid.halfcell_add(
            ndt_grid.empty_stats(lgrid, torch.float32, dev), raw[k],
            msk_d[k], 1.0, lgrid)
        require(bits_equal(one[int(slots[k])],
                           ndt_grid.finalize_pack(st, cfg3.ndt, lgrid,
                                                  compact)),
                f"{name}: keyframe {k}'s table differs from K4 of K3")
    rows, bands, smem = kernels.local_bands(w, lgrid, dev)

    p4 = snap(seq.points[lane], 4).to(dev).contiguous()
    twin = lambda: closure.write_local_tables_ref(
        torch.zeros(shape, dtype=torch.float32, device=dev), slots.to(dev),
        ok.to(dev), p4, msk.to(dev), cfg3.loop, cfg3.ndt, compact)
    out, ref = kernel(p4).clone(), twin()
    torch.cuda.synchronize()
    err4 = _table_check(name, out, ref, layout)

    p16 = snap(seq.points[lane].double(), 16)
    out16 = kernel(p16.float().to(dev).contiguous()).cpu()
    ref64 = closure.write_local_tables_ref(
        torch.zeros(shape, dtype=torch.float64), slots, ok, p16, msk,
        cfg3.loop, cfg3.ndt, compact)
    (v_o, m_o, i_o), (v_r, m_r, i_r) = (_unpacked(out16, layout),
                                        _unpacked(ref64, layout))
    require(bool((v_o == v_r).all()),
            f"{name}: valid flags differ from the f64 twin")
    merr = (m_o - m_r).abs()
    mtol = 1e-5 * torch.clamp(m_r.abs(), min=1e-3 * float(m_r.abs().max()))
    require(bool((merr <= mtol).all()),
            f"{name}: means off the f64 twin by "
            f"{float((merr / mtol).max()):.3g} x tol")
    ierr = (i_o - i_r).abs()
    irel = float(ierr.max() / i_r.abs().max())
    require(bool(torch.isfinite(m_o).all() and torch.isfinite(i_o).all()),
            f"{name}: non-finite table")
    ms = time_ms(lambda: kernel(p4))
    plain = time_ms(twin)
    # Points (8 B), mask (1 B), slot and ok read, W tables written; ~10
    # operations per point and 40 per finalized cell slot.
    n = seq.points.shape[1]
    g_dim, lanes = layout
    bd = bound(w * (n * 9 + 5) + w * shape[1] * g_dim * lanes * 4,
               10.0 * w * n + 40.0 * w * shape[1] * g_dim)
    print(f"[smoke] {name} W={w} N={seq.points.shape[1]} "
          f"({shape[1]} rows; {bands} bands of {rows} rows, {w * bands} "
          f"blocks, {smem} B of shared memory each): bit-identical on a "
          f"second launch, under permutation and to K4 of K3; vs f32 "
          f"twin (2^-4 m points) max abs err "
          f"{err4:.3e} (K4 rtol 1e-5"
          f"{'; bf16-pair lanes bit-equal' if compact else ''}), "
          f"valid exact; vs f64 twin (2^-16 m) "
          f"valid exact, means within rtol 1e-5, icov max err "
          f"{float(ierr.max()):.3e} = {irel:.3e} of its max; kernel "
          f"{ms:.4f} ms, plain {plain:.4f} ms, bound {bd['bound_ms']:.6f} ms "
          f"({bd['bound_by']})")
    row = dict(max_abs_err=err4, ms=ms, plain_ms=plain, **bd)
    card_time(jobs, f"{name} W={w}", row, "card_ms", lambda: kernel(p4))
    return row


def check_k1_grouped(cfg3, seq, kf, seed, dev, b, jobs=None):
    """K1 with ``group`` vs ``ndt_terms_ref`` on the card: ``b`` lanes x 360
    beams against the 1,024-slot cache, random tables; lane ``b`` registers
    the scan after its table's scan from the true relative pose + noise."""
    import numpy as np
    import torch

    from ndtpu_torch import kernels
    from ndtpu_torch.lie import se2
    from ndtpu_torch.loop import closure
    from ndtpu_torch.ndt import match

    rng = np.random.default_rng(seed + 2)
    t = seq.points.shape[0]
    group = torch.as_tensor(rng.integers(0, kf.capacity, b))
    src, q = group % t, (group + 1) % t
    rel = se2.between(seq.gt_poses[src].double(), seq.gt_poses[q].double())
    poses = (rel + torch.as_tensor(rng.normal(0.0, [0.05, 0.05, 0.01],
                                              (b, 3)))).float()
    args = (poses.to(dev).contiguous(),
            seq.points[q, :, 0].to(dev).contiguous(),
            seq.points[q, :, 1].to(dev).contiguous(),
            seq.mask[q].float().to(dev).contiguous(), kf.tables,
            closure.local_grid_config(cfg3.loop), cfg3.match.d2,
            cfg3.match.exp_clip)
    g32 = group.to(dev, torch.int32)
    compact = cfg3.match.compact_table
    name = kernels.variant("K1 ndt_terms grouped",
                           *kernels._layout(args[5], compact))
    kern = lambda: kernels.ndt_terms(*args, group=g32, compact=compact)
    twin = lambda: match.ndt_terms_ref(*args, compact=compact, group=g32)
    out, ref = kern(), twin()
    torch.cuda.synchronize()
    err = (out - ref).abs()
    tol = 1e-3 * torch.clamp(ref.abs(), min=1.0)
    require(bool(torch.isfinite(out).all()), f"{name}: non-finite sums")
    require(bool((err <= tol).all()),
            f"{name}: sums off by up to {float((err / tol).max()):.3g} x "
            f"tolerance")
    hit = float((ref[:, 1] > 0).float().mean())
    ms = time_ms(kern)
    plain = time_ms(twin)
    bd = k1_bound(args, g32)
    print(f"[smoke] {name} B={b} N={seq.points.shape[1]} "
          f"S={kf.capacity}: max abs err {float(err.max()):.3e} (tol 1e-3 x "
          f"max(1,|ref|)), {hit:.2f} of lanes see valid cells; kernel "
          f"{ms:.4f} ms, plain {plain:.4f} ms, bound {bd['bound_ms']:.6f} ms "
          f"({bd['bound_by']})")
    row = dict(max_abs_err=float(err.max()), ms=ms, plain_ms=plain, **bd)
    card_time(jobs, name, row, "card_ms", kern, ["ndt_terms"])
    return row


def loop_queries(cfg3, seq, kf, seed, dev, c: int):
    """``profile_port.loop_queries`` (4 queries at the end of the box-world
    lap x ``c`` candidates) and its lanes as ``profile_port.gated_lanes``
    gives them (K15 on the candidates): ``(loop, query, query indices,
    candidates, lanes)``."""
    from profile_port import gated_lanes
    from profile_port import loop_queries as queries

    loop, query, qidx, cands = queries(cfg3, seq, kf, seed, dev, c)
    lanes = gated_lanes(kf, *query, cands, loop, cfg3.match)
    return loop, query, qidx, cands, lanes


def clear_of_gates(loop, res, init, cands, qidx):
    """``cands`` with the lanes within 1e-4 of the score gate or of the
    innovation budget masked out (f32 and f64 may fall on either side of
    those), and the count masked."""
    import torch

    r64 = res.score.cpu().double()
    innov = torch.linalg.norm(res.pose[..., :2].cpu().double()
                              - init[..., :2].cpu().double(), dim=-1)
    budget = (loop.max_innovation_base + loop.max_innovation_per_kf
              * (qidx.cpu()[:, None] - cands.idx.cpu()).abs().double())
    clear = (((r64 - loop.score_gate).abs() >= 1e-4)
             & ((innov - budget).abs() >= 1e-4))
    return (cands._replace(mask=cands.mask & clear.to(cands.mask.device)),
            int((~clear).sum()))


def gate_vs_f64(name, out, res, cands, loop, init, qidx):
    """Gate outputs against ``_gate_and_pack`` in f64 on the CPU, on the
    same registrations: flags exact, sqrt_info within 1e-4 x the lane's
    largest entry. Returns ``(max abs err, f64 result)``."""
    from ndtpu_torch.loop import closure
    from ndtpu_torch.ndt.match import MatchResult

    r64 = MatchResult(*(a.cpu().double() if a.is_floating_point()
                        else a.cpu() for a in res))
    c_cpu = closure.LoopCandidates(*(a.cpu() for a in cands))
    ref = closure._gate_and_pack(r64, c_cpu, loop, init.cpu().double(),
                                 qidx.cpu())
    accept, innov_rej, sqrt_info = out
    require(bool((accept.cpu() == ref.accept).all()),
            f"{name}: accept flags differ from the f64 twin")
    require(bool((innov_rej.cpu() == ref.innov_rej).all()),
            f"{name}: innovation flags differ from the f64 twin")
    require(bool(ref.accept.any()), f"{name}: no lane accepted; weak check")
    err = (sqrt_info.cpu().double() - ref.sqrt_info).abs()
    lane_max = ref.sqrt_info.abs().amax((-2, -1), keepdim=True)
    require(bool((err <= 1e-4 * lane_max).all()),
            f"{name}: sqrt_info off by "
            f"{float((err / (1e-4 * lane_max)).max()):.3g} x tol")
    return float(err.max()), ref


def check_k8b(cfg3, seq, kf, seed, dev, c: int, jobs=None):
    """The standalone K8b vs ``_gate_and_pack`` (f64, CPU) on a real
    verification of 4 queries x ``c`` candidates (:func:`loop_queries`);
    lanes near a gate masked (:func:`clear_of_gates`)."""
    from ndtpu_torch.loop import closure

    loop, (qpts, qmsk, qpose), qidx, cands, _ = loop_queries(
        cfg3, seq, kf, seed, dev, c)
    res, init = closure.verify_registrations(kf, qpts, qmsk, qpose, cands,
                                             loop, cfg3.match)
    cands, near = clear_of_gates(loop, res, init, cands, qidx)
    run = lambda: closure.gate_and_pack(res, cands, loop, init, qidx)
    out = run()
    err, ref = gate_vs_f64(f"K8b C={c}", (out.accept, out.innov_rej,
                                          out.sqrt_info), res, cands, loop,
                           init, qidx)
    ms = time_ms(run)
    plain = time_ms(lambda: closure._gate_and_pack(res, cands, loop, init,
                                                   qidx))
    # Per lane: mask, converged, score, pose, init, hessian, index read (74
    # B), accept, innov_rej, sqrt_info written (38 B); ~800 operations (8
    # Jacobi sweeps on the 3 x 3, the Cholesky, the gates).
    lanes = res.score.numel()
    bd = bound(lanes * 112 + 4 * 8, 800.0 * lanes)
    print(f"[smoke] K8b loop_gate K=4 C={c}: {int(cands.mask.sum())} live "
          f"lanes ({near} masked near a gate), {int(ref.accept.sum())} "
          f"accepted, {int((res.converged & cands.mask).sum())} converged; "
          f"flags exact, sqrt_info max abs err {err:.3e} (tol 1e-4 x lane "
          f"max); kernel {ms:.4f} ms, plain {plain:.4f} ms, bound "
          f"{bd['bound_ms']:.6f} ms ({bd['bound_by']})")
    row = dict(max_abs_err=err, ms=ms, plain_ms=plain, **bd)
    card_time(jobs, f"K8b loop_gate C={c}", row, "card_ms", run,
              ["loop_gate_kernel"])
    return row


def gated_verify_identity(cfg3, seq, kf, seed, dev, c: int):
    """The gated verify (one ``lm_ndt`` launch that registers and gates 4
    queries x ``c`` candidates, :func:`loop_queries`) on a real
    verification: (a) bit-equal to ungated ``lm_ndt_grouped`` followed by
    the standalone K8b on the same inputs (the five registration outputs
    and the three gate outputs), and on a second gated call (the arrival
    counters reset); one ``lm_ndt_grouped`` launch, one
    ``loop_gate_fused``, no standalone K8b; (b)
    ``verify_candidates_cached_flat`` on the card makes no host sync; (c)
    its gate against ``_gate_and_pack`` in f64 on its own registrations
    (lanes near a gate masked). Returns what :func:`check_gated_verify`
    times."""
    import torch

    from ndtpu_torch import kernels
    from ndtpu_torch.loop import closure
    from ndtpu_torch.ndt import match

    loop, (qpts, qmsk, qpose), qidx, cands, lanes = loop_queries(
        cfg3, seq, kf, seed, dev, c)
    pts, msk, init, lgrid, mcfg, flat = lanes
    k = qidx.shape[0]
    res_u, init_u = closure.verify_registrations(kf, qpts, qmsk, qpose,
                                                 cands, loop, cfg3.match)
    cands, near = clear_of_gates(loop, res_u, init_u, cands, qidx)
    gate = kernels.LoopGate(cands.mask.contiguous(), qidx.contiguous(),
                            loop.score_gate, loop.max_innovation_base,
                            loop.max_innovation_per_kf,
                            closure._k_budget(loop))
    fused = lambda: match.match_batch_packed_gated(
        pts, msk, kf.tables, init, lgrid, mcfg, flat, gate)
    layout = kernels._layout(lgrid, mcfg.compact_table)
    grouped = kernels.variant("lm_ndt_grouped", *layout)
    kernels.reset_launches()
    one = fused()
    torch.cuda.synchronize()
    require(kernels.LAUNCHES[grouped] == 1
            and kernels.LAUNCHES[kernels.variant("loop_gate_fused", *layout)]
            == 1 and sum(kernels.LAUNCHES.values()) == 2,
            f"gated verify: launches {launches_nonzero(kernels.LAUNCHES)}, "
            f"expected one {grouped} counted as its loop_gate_fused")
    two = fused()
    reg = match.match_batch_packed(pts, msk, kf.tables, init, lgrid, mcfg,
                                   group=flat)
    split = lambda t: t.reshape((k, c) + t.shape[1:]).contiguous()
    standalone = kernels.loop_gate(
        gate.cand_mask, split(reg.converged), split(reg.score),
        split(reg.pose), split(init), split(reg.hessian),
        cands.idx.contiguous(), gate.query_idx, gate.score_gate,
        gate.innov_base, gate.innov_per_kf, gate.k_budget)
    torch.cuda.synchronize()
    require(bits_equal(tuple(one[0]), tuple(reg)),
            f"gated verify C={c}: registrations differ from lm_ndt_grouped")
    require(bits_equal(tuple(one[1]), tuple(standalone)),
            f"gated verify C={c}: gate outputs differ from the standalone "
            f"K8b")
    require(bits_equal(one, two), f"gated verify C={c}: two calls differ")

    verify = lambda: closure.verify_candidates_cached_flat(
        kf, qpts, qmsk, qpose, cands, loop, cfg3.match, qidx)
    verify()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = verify()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    res = match.MatchResult(*(split(t) for t in one[0]))
    err, ref = gate_vs_f64(f"gated verify C={c}",
                           (out.accept, out.innov_rej, out.sqrt_info), res,
                           cands, loop, split(init), qidx)
    return dict(loop=loop, query=(qpts, qmsk, qpose), qidx=qidx, cands=cands,
                lanes=lanes, reg=reg, near=near, err=err, ref=ref)


def check_gated_verify(cfg3, seq, kf, seed, dev, c: int, jobs=None):
    """:func:`gated_verify_identity`, then the times of the gated launch on
    the prepared lanes (``match_batch_packed_gated``: the row's ``ms`` and
    ``card_ms``), of its plain route (``lm_ndt_ref`` and ``_gate_and_pack``
    on the card), and of the whole verify as the pipeline calls it
    (``verify_candidates_cached_flat``, lanes prepared in the call) against
    the unfused route (``verify_registrations`` and ``gate_and_pack``: the
    registration launch, then the standalone gate)."""
    import torch

    from ndtpu_torch import kernels
    from ndtpu_torch.loop import closure
    from ndtpu_torch.ndt import match

    g = gated_verify_identity(cfg3, seq, kf, seed, dev, c)
    loop, cands, qidx, reg = g["loop"], g["cands"], g["qidx"], g["reg"]
    qpts, qmsk, qpose = g["query"]
    pts, msk, init, lgrid, mcfg, flat = g["lanes"]
    k = qidx.shape[0]
    split = lambda t: t.reshape((k, c) + t.shape[1:]).contiguous()
    gate = kernels.LoopGate(cands.mask.contiguous(), qidx.contiguous(),
                            loop.score_gate, loop.max_innovation_base,
                            loop.max_innovation_per_kf,
                            closure._k_budget(loop))
    fused = lambda: match.match_batch_packed_gated(
        pts, msk, kf.tables, init, lgrid, mcfg, flat, gate)
    verify = lambda: closure.verify_candidates_cached_flat(
        kf, qpts, qmsk, qpose, cands, loop, cfg3.match, qidx)

    def unfused():
        r, i = closure.verify_registrations(kf, qpts, qmsk, qpose, cands,
                                            loop, cfg3.match)
        return closure.gate_and_pack(r, cands, loop, i, qidx)

    def plain():
        group = flat.to(torch.int32)
        r = match.lm_ndt_ref(init, pts[..., 0].contiguous(),
                             pts[..., 1].contiguous(), msk.float(),
                             kf.tables, lgrid, mcfg, group)
        return closure._gate_and_pack(
            match.MatchResult(*(split(t) for t in r)), cands, loop,
            split(init), qidx)

    ms, plain_ms = time_ms(fused), time_ms(plain, reps=5)
    verify_ms, unfused_ms = time_ms(verify), time_ms(unfused)
    args = (init, pts[..., 0].contiguous(), pts[..., 1].contiguous(),
            msk.float(), kf.tables, lgrid, flat.to(torch.int32))
    lb = lm_bound(args, reg)
    lanes_n = k * c
    bd = bound(lb["n_bytes"] + lanes_n * 39 + k * 8,
               lb["n_flops"] + 800.0 * lanes_n)
    vname = kernels.variant("gated verify",
                            *kernels._layout(lgrid, mcfg.compact_table))
    print(f"[smoke] {vname} K=4 C={c}: one lm_ndt_grouped launch "
          f"counted as loop_gate_fused; registrations and gate bit-equal to "
          f"lm_ndt_grouped + standalone K8b and on a second call; no host "
          f"sync; {int(cands.mask.sum())} live lanes ({g['near']} masked "
          f"near a gate), {int(g['ref'].accept.sum())} accepted; vs f64 gate "
          f"twin flags exact, sqrt_info max abs err {g['err']:.3e}; gated "
          f"launch {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
          f"{bd['bound_ms']:.6f} ms ({bd['bound_by']}); the whole verify "
          f"{verify_ms:.4f} ms against {unfused_ms:.4f} ms unfused")
    row = dict(max_abs_err=g["err"], ms=ms, plain_ms=plain_ms, **bd,
               verify_ms=verify_ms, unfused_verify_ms=unfused_ms)
    card_time(jobs, f"{vname} C={c}, the gated lm_ndt launch", row,
              "card_ms", fused, ["lm_ndt_kernel"])
    card_time(jobs, f"{vname} C={c}, every kernel of the verify", row,
              "verify_card_ms", verify)
    card_time(jobs, f"unfused {vname} C={c}, every kernel of the verify",
              row, "unfused_verify_card_ms", unfused)
    return row


def clone_tree(x):
    """A copy of a (nested) NamedTuple / tuple of tensors."""
    import torch

    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, tuple):
        items = [clone_tree(y) for y in x]
        return type(x)(*items) if hasattr(x, "_fields") else tuple(items)
    return x


def fingerprint(obj):
    """Bit-level fingerprint of every tensor in a (nested) output, in order:
    per tensor, the sum of its bit patterns read as integers, plain and
    weighted by position (integer sums, so the same on every run)."""
    import torch

    sums = []

    def walk(x):
        if isinstance(x, torch.Tensor):
            t = x.detach().contiguous().reshape(-1)
            if t.dtype == torch.bool:
                t = t.to(torch.uint8)
            ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32,
                    8: torch.int64}[t.element_size()]
            v = t.view(ints).to(torch.int64)
            pos = torch.arange(v.numel(), device=v.device) % 8191 + 1
            sums.append(torch.stack([v.sum(), (v * pos).sum()]))
        elif isinstance(x, dict):
            for k in sorted(x):
                walk(x[k])
        elif isinstance(x, (tuple, list)):
            for y in x:
                walk(y)

    walk(obj)
    return torch.stack(sums).cpu() if sums else None


#: The window step's stages, in the order they finish within a window.
STAGES = ("_window_frontend", "_loop_lanes", "_wb_appends", "_wb_smooth",
          "_wb_maps")


def recorded_run(inputs, cfg):
    """``run_slam_windowed`` with every stage's output fingerprinted as it
    returns: ``(state, trajectory, [(window, stage, fingerprint)])``."""
    import torch

    from ndtpu_torch.slam import pipeline

    log, saved = [], {name: getattr(pipeline, name) for name in STAGES}

    def wrap(name, fn):
        def inner(*a, **k):
            out = fn(*a, **k)
            win = sum(1 for e in log if e[1] == "_window_frontend")
            log.append((win - (name != "_window_frontend"), name,
                        fingerprint(out)))
            return out
        return inner

    for name, fn in saved.items():
        setattr(pipeline, name, wrap(name, fn))
    try:
        state, outs = pipeline.run_slam_windowed(*inputs, cfg)
        traj = pipeline.recover_trajectory(state, outs)
        torch.cuda.synchronize()
    finally:
        for name, fn in saved.items():
            setattr(pipeline, name, fn)
    return state, traj, log


def check_frontend_twice(cfg, seq, dev, n_windows: int = 20):
    """``_window_frontend`` run twice from clones of one state (the state
    after ``n_windows`` windows of ``seq``) on the next window: poses,
    registrations, keyframe flags and both map tables (pass 1 and the pass-2
    temporary map) bit-equal."""
    from ndtpu_torch.slam import pipeline

    p, m, o = (t.to(dev) for t in (seq.points, seq.mask, seq.odom))
    state = pipeline.init_slam(cfg, p[0], m[0])
    pts_w, msk_w, odo_w, _ = pipeline.window_inputs(p, m, o, cfg.window)
    carry = (state, state.pose)
    for k in range(n_windows):
        carry, _ = pipeline.slam_window_step(carry[0], carry[1], pts_w[k],
                                             msk_w[k], odo_w[k], cfg)
    k = n_windows
    tables, map_table = [], pipeline._map_table

    def recording(stats, c):
        tables.append(map_table(stats, c))
        return tables[-1]

    pipeline._map_table = recording
    try:
        runs = [pipeline._window_frontend(
            clone_tree(carry[0]), carry[1].clone(), pts_w[k], msk_w[k],
            odo_w[k], cfg, cfg.window_passes) for _ in range(2)]
    finally:
        pipeline._map_table = map_table
    half = len(tables) // 2
    require(bits_equal(runs[0], runs[1]),
            "_window_frontend: two runs from one state differ")
    require(half >= 1 and bits_equal(tables[:half], tables[half:]),
            "_window_frontend: the map tables of two runs differ")
    print(f"[smoke] _window_frontend twice from one state (window {k}): "
          f"poses, registrations, keyframe flags and {half} map tables "
          f"bit-equal")


def check_repeat_runs(dev, config, seed: int, runs: int = 3, keep=None):
    """Box-world draw ``seed`` through ``run_slam_windowed`` ``runs`` times:
    the ATEs, and where the runs first part (window and stage, from the
    stages' fingerprints) if they do. The first run's final state is
    appended to ``keep`` (a list) when given."""
    import torch

    from ndtpu_torch.config import PipelineConfig
    from ndtpu_torch.eval.ate import ate_rmse

    cfg = PipelineConfig.from_json(str(config))
    seq = box_sequence(seed, cfg.n_beams)
    inputs = tuple(t.to(dev) for t in (seq.points, seq.mask, seq.odom))
    results = [recorded_run(inputs, cfg) for _ in range(runs)]
    ates = [float(ate_rmse(traj.cpu(), seq.gt_poses)) for _, traj, _ in
            results]
    loops = [int(state.n_loops) for state, _, _ in results]
    same = [bits_equal(results[0][1], r[1]) for r in results[1:]]
    parts = []
    for _, _, log in results[1:]:
        first = next(((w, name) for (w, name, f), (_, _, f0)
                      in zip(log, results[0][2])
                      if not (f is None or torch.equal(f, f0))), None)
        parts.append(first)
    if keep is not None:
        keep.append(results[0][0])
    print(f"[smoke] {config.name} box-world draw {seed}, {runs} runs: ATE "
          + " / ".join(f"{a:.4f}" for a in ates) + " m, loops "
          + " / ".join(map(str, loops)) + "; trajectories bit-equal to run "
          f"0: {same}; first (window, stage) where a run parts from run 0: "
          f"{parts}")
    return dict(ates=ates, loops=loops, bit_equal=same, first_parting=parts)


def lm_window_args(cfg, seq, table, seed, dev, b):
    """``b`` lanes of the config-2 window shape: scan ``t`` from its true
    pose + noise (0.1 m, 0.1 m, 0.02 rad) against the config-2 table, as
    ``(init, px, py, mask_f, table, grid, group)``."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed + 5)
    lane = torch.as_tensor(rng.integers(0, seq.points.shape[0], b))
    noise = rng.normal(0.0, [0.1, 0.1, 0.02], (b, 3))
    init = (seq.gt_poses[lane].double() + torch.as_tensor(noise)).float()
    return (init.to(dev).contiguous(),
            seq.points[lane, :, 0].to(dev).contiguous(),
            seq.points[lane, :, 1].to(dev).contiguous(),
            seq.mask[lane].float().to(dev).contiguous(), table, cfg.grid,
            None)


def lm_verify_args(cfg3, seq, kf, seed, dev, b):
    """``b`` verify lanes over the whole keyframe cache: lane ``b``
    registers the scan after its table's scan from the true relative pose +
    noise (0.1 m, 0.1 m, 0.02 rad), ``group`` = table slot."""
    import numpy as np
    import torch

    from ndtpu_torch.lie import se2
    from ndtpu_torch.loop import closure

    rng = np.random.default_rng(seed + 6)
    t = seq.points.shape[0]
    group = torch.as_tensor(rng.integers(0, kf.capacity, b))
    src, q = group % t, (group + 1) % t
    rel = se2.between(seq.gt_poses[src].double(), seq.gt_poses[q].double())
    init = (rel + torch.as_tensor(rng.normal(0.0, [0.1, 0.1, 0.02],
                                             (b, 3)))).float()
    return (init.to(dev).contiguous(),
            seq.points[q, :, 0].to(dev).contiguous(),
            seq.points[q, :, 1].to(dev).contiguous(),
            seq.mask[q].float().to(dev).contiguous(), kf.tables,
            closure.local_grid_config(cfg3.loop),
            group.to(dev, torch.int32))


def lm_composite(init_poses, px, py, mask_f, table, grid, cfg, group=None):
    """The composite route, with ``ndt.match.lm_ndt``'s signature: the
    batched LM loop in torch around K1 launches (the card path before
    ``lm_ndt``)."""
    from ndtpu_torch.ndt import match

    sgh = match.terms_sgh(px, py, mask_f, table, grid, cfg, group,
                          terms=match.ndt_terms)
    return match.lm_loop_batch(sgh, init_poses, cfg)


def accept_tie(args, cfg, lane: int):
    """Replay ``lane`` one iteration at a time on the composite route and
    on ``lm_ndt`` (run with ``max_iter = k``). At the first iteration where
    one accepts its trial pose and the other rejects it, return ``(k, f,
    f2, |f2 - f| / |f|)`` from the composite route; None when the two part
    in another way (a stop test) or never."""
    import dataclasses

    import torch

    from ndtpu_torch.ndt import match

    init, px, py, mask_f, table, grid, group = args
    sl = slice(lane, lane + 1)
    one = (init[sl], px[sl], py[sl], mask_f[sl], table, grid,
           None if group is None else group[sl])
    sgh = match.terms_sgh(*one[1:6], cfg, one[6], terms=match.ndt_terms)
    c = match._lm_carry_init(sgh, one[0], cfg)
    prev = one[0]
    for k in range(1, cfg.max_iter + 1):
        active = (c.it < cfg.max_iter) & ~c.done
        if not bool(active[0]):
            return None
        _, pose_try = match._lm_trial(c, cfg, active)
        f2 = float(sgh(pose_try)[0][0])
        f = float(c.f[0])
        kres = match.lm_ndt(*one[:6], dataclasses.replace(cfg, max_iter=k),
                            one[6])
        if int(kres.n_iter[0]) < k:
            return None
        if (not torch.equal(kres.pose, prev)) != (f2 < f):
            return k, f, f2, abs(f2 - f) / max(abs(f), 1e-30)
        prev = kres.pose
        c = match._lm_body(sgh, c, cfg, cfg.max_iter)
    return None


def check_lm(label, args, cfg, jobs=None):
    """``lm_ndt`` against the composite route (n_iter and converged equal
    on every lane, pose and score within 1e-5 x max(|ref|, 1), H within
    1e-5 x the lane's largest entry, or the lane shown to be an accept tie,
    |f2 - f| <= 1e-6 |f|) and against its f32 twin ``lm_ndt_ref`` (sums in
    another order: poses within 1e-3 m / rad on lanes converged in both;
    the converged flags are pooled over both shapes by the caller). Returns
    the result row and ``(lanes with equal converged flags, lanes)``."""
    import torch

    from ndtpu_torch import kernels
    from ndtpu_torch.ndt import match

    init, px, py, mask_f, table, grid, group = args
    name = kernels.variant("lm_ndt", *table_layout(table, grid)) + f" {label}"
    run = lambda: match.lm_ndt(*args[:6], cfg, group)
    twin = lambda: match.lm_ndt_ref(*args[:6], cfg, group)
    composite = lambda: lm_composite(*args[:6], cfg, group)
    kres, cres, tres = run(), composite(), twin()
    torch.cuda.synchronize()
    for field in ("pose", "hessian", "score"):
        require(bool(torch.isfinite(getattr(kres, field)).all()),
                f"{name}: non-finite {field}")
    tol = lambda ref: 1e-5 * ref.abs().clamp(min=1.0)
    hmax = cres.hessian.abs().amax((-2, -1), keepdim=True)
    same = ((kres.n_iter == cres.n_iter)
            & (kres.converged == cres.converged)
            & ((kres.pose - cres.pose).abs() <= tol(cres.pose)).all(-1)
            & ((kres.score - cres.score).abs() <= tol(cres.score))
            & ((kres.hessian - cres.hessian).abs()
               <= 1e-5 * hmax).all(-1).all(-1))
    ties = 0
    for lane in (~same).nonzero().flatten().tolist():
        tie = accept_tie(args, cfg, lane)
        require(tie is not None and tie[3] <= 1e-6,
                f"{name}: lane {lane} differs from the composite "
                f"route (n_iter {int(kres.n_iter[lane])} vs "
                f"{int(cres.n_iter[lane])}, converged "
                f"{bool(kres.converged[lane])} vs "
                f"{bool(cres.converged[lane])}) and is no accept tie: {tie}")
        print(f"[smoke] {name}: lane {lane} parts from the composite "
              f"route at an accept tie: iteration {tie[0]}, f {tie[1]!r}, "
              f"f2 {tie[2]!r}, |f2 - f| / |f| = {tie[3]:.3e}")
        ties += 1
    cerr = float((kres.pose - cres.pose)[same].abs().max()) \
        if bool(same.any()) else 0.0
    conv_eq = int((kres.converged == tres.converged).sum())
    both = kres.converged & tres.converged
    terr = float((kres.pose - tres.pose)[both].abs().max()) \
        if bool(both.any()) else 0.0
    require(terr <= 1e-3, f"{name}: poses {terr:.3e} off the f32 "
            f"twin on lanes converged in both (tol 1e-3)")
    ms = time_ms(run)
    comp_ms = time_ms(composite)
    plain = time_ms(twin)
    lb = lm_bound(args, kres)
    bd = bound(lb["n_bytes"], lb["n_flops"])
    b, n = px.shape
    its = kres.n_iter.long()
    print(f"[smoke] {name} B={b} N={n}: n_iter mean "
          f"{float(its.float().mean()):.2f} max {int(its.max())}, "
          f"{int(kres.converged.sum())}/{b} converged; vs composite route "
          f"{int(same.sum())}/{b} lanes equal (n_iter, converged; pose rtol "
          f"1e-5, max abs err {cerr:.3e}), {ties} accept ties; vs f32 twin "
          f"converged equal on {conv_eq}/{b}, pose max abs err {terr:.3e} "
          f"(tol 1e-3); kernel {ms:.4f} ms, composite route {comp_ms:.4f} "
          f"ms, plain twin {plain:.4f} ms, bound {bd['bound_ms']:.6f} ms "
          f"({bd['bound_by']}), {ms * 1e3 / max(int(its.max()), 1):.2f} us "
          f"per iteration of the longest lane")
    row = dict(max_abs_err=terr, ms=ms, plain_ms=plain, **bd,
               composite_ms=comp_ms, composite_max_abs_err=cerr,
               accept_ties=ties)
    card_time(jobs, name, row, "card_ms", run, ["lm_ndt_kernel"])
    return row, (conv_eq, b)


def lm_bound(args, kres) -> dict:
    """``lm_ndt``'s work on ``args`` as run to ``kres``: bytes (init, beams
    and group read, each distinct row gathered at the initial or final
    poses once, pose/H/score/n_iter/converged written) and operations
    ((n_iter + 1) evaluations of each lane's in-bounds beams, n_iter LM
    steps)."""
    import torch

    init, px, py, mask_f, table, grid, group = args
    g, l = table_layout(table, grid)
    keys0, _ = lane_rows(init, px, py, mask_f, grid, group)
    keys1, beams = lane_rows(kres.pose, px, py, mask_f, grid, group)
    b, n = px.shape
    rows = torch.cat([keys0, keys1]).unique().numel()
    its = kres.n_iter.long()
    return dict(n_bytes=b * 12 + b * n * 12 + rows * g * l * 4 + b * 57
                + (0 if group is None else b * 4),
                n_flops=float(((its + 1) * beams).sum()) * beam_flops(g, l)
                + float(its.sum()) * STEP_FLOPS)


def check_no_sync(args, cfg):
    """One ``match_batch_packed`` call on the card under
    ``set_sync_debug_mode("error")``: any host sync raises."""
    import torch

    from ndtpu_torch import kernels
    from ndtpu_torch.ndt import match

    init, px, py, mask_f, table, grid, _ = args
    points, mask = torch.stack([px, py], -1), mask_f > 0
    before = kernels.LAUNCHES["lm_ndt"]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        match.match_batch_packed(points, mask, table, init, grid, cfg)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    require(kernels.LAUNCHES["lm_ndt"] == before + 1,
            "match_batch_packed: not one lm_ndt launch")
    print("[smoke] match_batch_packed on the card: one lm_ndt launch, no "
          "host sync (set_sync_debug_mode('error'))")


#: bench.py §1's headline registration shape (bench.py:181-207): B lanes of
#: N beams against one table of a 128 x 128 grid at 0.5 m, overlap 4,
#: ``MatchConfig(phase2_width=128, phase1_iters=16)``.
HEADLINE = dict(batch=4096, n_beams=720, phase2_width=128, phase1_iters=16,
                grid=dict(x0=-32.0, y0=-32.0, cell=0.5, nx=128, ny=128,
                          overlap=4))


def headline_args(seed: int, dev):
    """bench.py §1's scene (bench.py:181-207) with the port's synth, in f64
    on the card (K11) from numpy seed ``seed`` (JAX's PRNG keys have no
    port): the box world of half 28; the map from 64 scans along a
    rectangle of half 18 m at 1.5 m steps, its table finalized and packed
    (K3, K4); :data:`HEADLINE`'s 4,096 scans of 720 beams along a
    rectangle of half 17 m at 1.1 m steps, 40 m range, 0.01 m range noise,
    points in (0.1, 40) m; initial poses the truth + (0.2, -0.15, 0.04).
    Returns ``((init, px, py, mask_f, table, grid, None), MatchConfig)``
    in f32."""
    import numpy as np
    import torch

    from ndtpu_torch.config import GridConfig, MatchConfig, NDTMapConfig
    from ndtpu_torch.data import synth
    from ndtpu_torch.lie import se2
    from ndtpu_torch.ndt import grid as ndt_grid

    h = HEADLINE
    f64 = dict(dtype=torch.float64, device=dev)
    grid = GridConfig(**h["grid"])
    mcfg = MatchConfig(phase2_width=h["phase2_width"],
                       phase1_iters=h["phase1_iters"])
    rng = np.random.default_rng(seed)
    world = synth.World(synth.box_world(half=28.0).segments.to(**f64))
    ang = synth.beam_angles(h["n_beams"], **f64)
    map_poses = synth.rectangle_trajectory(64, half=18.0, step=1.5, **f64)
    mpts, mmsk = synth.polar_to_xy(
        synth.simulate_scans(world, map_poses, ang, 40.0, 0.01, rng), ang,
        0.1, 40.0)
    wpts = se2.transform(map_poses, mpts).float().reshape(-1, 2)
    stats = ndt_grid.build_stats(wpts.contiguous(), mmsk.reshape(-1), grid)
    table = ndt_grid.finalize_pack(stats, NDTMapConfig(), grid)
    poses = synth.rectangle_trajectory(h["batch"], half=17.0, step=1.1,
                                       **f64)
    spts, smsk = synth.polar_to_xy(
        synth.simulate_scans(world, poses, ang, 40.0, 0.01, rng), ang, 0.1,
        40.0)
    init = poses + torch.tensor([0.2, -0.15, 0.04], **f64)
    spts = spts.float()
    return ((init.float().contiguous(), spts[..., 0].contiguous(),
             spts[..., 1].contiguous(), smsk.float().contiguous(), table,
             grid, None), mcfg)


def lm_vs_k1(name, args, cfg, gate=None) -> int:
    """``lm_ndt`` (gated with ``gate``) against K1 at its own output poses:
    its H (d2 x S5..10) and score (S0 / max(S1, 1)) bit-equal to those of
    K1's sums there (``kernels.ndt_terms``), all its outputs bit-identical
    on a relaunch and on a launch at R = 1 (K1's 128 threads per lane,
    ``kernels.lm_spread`` held at 1). Returns the launch's R."""
    import torch

    from ndtpu_torch import kernels

    init, px, py, mask_f, table, grid, group = args
    run = lambda: kernels.lm_ndt(init, px, py, mask_f, table, grid, cfg,
                                 group, gate=gate)
    out, again = run(), run()
    saved = kernels.lm_spread
    kernels.lm_spread = lambda *a: 1
    try:
        one = run()
    finally:
        kernels.lm_spread = saved
    s = kernels.ndt_terms(out[0], px, py, mask_f, table, grid, cfg.d2,
                          cfg.exp_clip, group, cfg.compact_table)
    d2 = torch.tensor(cfg.d2, dtype=torch.float32, device=s.device)
    hess = (d2 * s[:, [5, 6, 7, 6, 8, 9, 7, 9, 10]]).reshape(-1, 3, 3)
    score = s[:, 0] / torch.clamp(s[:, 1], min=1.0)
    torch.cuda.synchronize()
    require(bool(torch.isfinite(out[1]).all()), f"{name}: non-finite H")
    require(bits_equal(out, again), f"{name}: a relaunch differs")
    require(bits_equal(out, one), f"{name}: the launch at R = 1 differs")
    require(bits_equal(out[1], hess) and bits_equal(out[2], score),
            f"{name}: H or score differs from K1's sums at the output "
            f"poses (H {int((out[1] != hess).sum())}, score "
            f"{int((out[2] != score).sum())} entries)")
    b, n = px.shape
    return kernels.lm_spread(b, n, table_layout(table, grid)[0],
                             kernels._sm_count(px.device))


def check_lm_sums(cfg, cfg3, seed, dev, layouts=None,
                  beams=(360, 720, 1100)) -> dict:
    """:func:`lm_vs_k1` for each table layout (``kernels.LAYOUTS`` by
    default) and beam count (1,100 takes the chunks past 1,024 beams) at
    the three launches of the main path: shared (the config-2 window),
    grouped (the config-3 verify, K x C lanes over a 1,024-slot cache of
    the layout) and gated (the same lanes and the loop gate). The maps and
    caches are built from box-world draw ``seed`` at 360 beams; the scans
    at ``n`` beams are the same draw's. Returns each case's R."""
    import torch

    from ndtpu_torch import kernels
    from ndtpu_torch.loop import closure
    from ndtpu_torch.ndt import grid as ndt_grid

    seq0 = box_sequence(seed, cfg.n_beams)
    seqs = {n: seq0 if n == cfg.n_beams else box_sequence(seed, n)
            for n in beams}
    spreads = {}
    for g, l in layouts or kernels.LAYOUTS:
        c2, c3 = layout_cfg(cfg, g, l), layout_cfg(cfg3, g, l)
        table = ndt_grid.finalize_pack(map_stats(seq0, c2.grid, dev), c2.ndt,
                                       c2.grid, l == 4)
        kf = box_store(c3, seq0, dev)
        k, c = c3.loop.max_detect_per_window, c3.loop.max_candidates
        loop = c3.loop
        gate = kernels.LoopGate(
            torch.ones((k, c), dtype=torch.bool, device=dev),
            torch.arange(200, 200 + 40 * k, 40, device=dev),
            loop.score_gate, loop.max_innovation_base,
            loop.max_innovation_per_kf, closure._k_budget(loop))
        for n, seq in seqs.items():
            v = kernels.variant("lm_ndt", g, l) + f" N={n}"
            a2 = lm_window_args(c2, seq, table, seed, dev, c2.window)
            a3 = lm_verify_args(c3, seq, kf, seed, dev, k * c)
            spreads[v] = dict(
                shared=lm_vs_k1(f"{v} shared", a2, c2.match),
                grouped=lm_vs_k1(f"{v} grouped", a3, c3.match),
                gated=lm_vs_k1(f"{v} gated", a3, c3.match, gate))
        del kf
    print(f"[smoke] lm_ndt vs K1: H and score bit-equal to K1's sums at the "
          f"output poses, bit-identical on a relaunch and at R = 1, for "
          f"every case (R per case: {spreads})")
    return spreads


def check_lm_headline(seed, dev, jobs=None) -> dict:
    """``lm_ndt`` at bench.py §1's headline shape (:func:`headline_args`:
    4,096 lanes x 720 beams, one 128 x 128 table): finite, bit-identical on
    a relaunch, H and score bit-equal to K1's sums at its output poses
    (:func:`lm_vs_k1`), and against its f32 twin on the first 64 lanes
    (converged flags equal on >= 95% of them, poses within the LM's
    ``reject_tol`` where both converged: a lane stops at a rejected step
    shorter than that, and two sum orders may stop that far apart at 720
    beams); event and card ms and the bound, on a line of its own."""
    import torch

    from ndtpu_torch.ndt import match

    args, mcfg = headline_args(seed, dev)
    b, n = args[1].shape
    spread = lm_vs_k1("lm_ndt headline", args, mcfg)
    run = lambda: match.lm_ndt(*args[:6], mcfg)
    kres = run()
    sub = tuple(a[:64] for a in args[:4]) + args[4:6]
    tres = match.lm_ndt_ref(*sub, mcfg)
    torch.cuda.synchronize()
    conv_eq = int((kres.converged[:64] == tres.converged).sum())
    both = kres.converged[:64] & tres.converged
    terr = float((kres.pose[:64] - tres.pose)[both].abs().max()) \
        if bool(both.any()) else 0.0
    require(conv_eq >= 0.95 * 64 and terr <= mcfg.reject_tol,
            f"lm_ndt headline: converged equal to the f32 twin on "
            f"{conv_eq}/64 lanes, poses {terr:.3e} off where both converged")
    ms = time_ms(run)
    lb = lm_bound(args, kres)
    bd = bound(lb["n_bytes"], lb["n_flops"])
    its = kres.n_iter.long()
    print(f"[smoke] lm_ndt headline (bench.py §1: B={b} x {n} beams, a 128 "
          f"x 128 table at overlap 4; R={spread}): n_iter mean "
          f"{float(its.float().mean()):.2f} max {int(its.max())}, "
          f"{int(kres.converged.sum())}/{b} converged; H and score "
          f"bit-equal to K1's sums at the output poses, bit-identical on a "
          f"relaunch and at R = 1; vs the f32 twin on 64 lanes converged "
          f"equal on {conv_eq}, pose max abs err {terr:.3e} (tol "
          f"{mcfg.reject_tol:g}); kernel "
          f"{ms:.4f} ms ({b / ms * 1e3:.0f} registrations/s), bound "
          f"{bd['bound_ms']:.6f} ms ({bd['bound_by']})")
    row = dict(batch=b, n_beams=n, spread=spread, ms=ms, max_abs_err=terr,
               converged=int(kres.converged.sum()),
               n_iter_mean=float(its.float().mean()), **bd)
    card_time(jobs, "lm_ndt headline", row, "card_ms", run, ["lm_ndt_kernel"])
    return row


def layout_cfg(cfg, grids: int, lanes: int):
    """``cfg`` in the table layout ``(grids, lanes)``: ``grid.overlap`` and
    ``loop.local_overlap`` = ``grids``, ``match.compact_table`` = ``lanes
    == 4``; nothing else changes."""
    import dataclasses

    return dataclasses.replace(
        cfg, grid=dataclasses.replace(cfg.grid, overlap=grids),
        loop=dataclasses.replace(cfg.loop, local_overlap=grids),
        match=dataclasses.replace(cfg.match, compact_table=lanes == 4))


def check_layouts(cfg, cfg3, seq, stats, kf, seed, dev, jobs=None):
    """Phase 3 in the other table layouts (``kernels.LAYOUTS``: overlap 1,
    compact rows, both), each kernel against its plain version at the main
    path's shapes: K3 at overlap 1 (window and rebuild shapes, +1 and +-1
    weights; bit-equal to its fixed-point model, on a second launch and
    under permutation), and per layout K4 at the config-2 and config-3 map
    tables, K1 and ``lm_ndt`` at the config-2 window shape, K8a at a
    window, K1 grouped, ``lm_ndt`` grouped and the gated verify at the
    config-3 verify shape over a 1,024-slot cache in the layout. ``stats``
    is the overlap-4 config-2 map, ``kf`` the published layout's store
    (its scans and poses are reused). Returns the rows by launch counter."""
    from ndtpu_torch import kernels
    from ndtpu_torch.ndt import grid as ndt_grid

    rows, eq, lanes_n = {}, 0, 0
    c1 = layout_cfg(cfg, 1, 8)
    stats1 = map_stats(seq, c1.grid, dev)
    row = check_k3(c1, seq, stats1, seed, dev, cfg.window, jobs)
    row.update(check_k3_rebuild(layout_cfg(cfg3, 1, 8), kf, dev))
    rows[kernels.variant("halfcell_add", 1)] = row
    for g, l in kernels.LAYOUTS[1:]:
        c2, c3 = layout_cfg(cfg, g, l), layout_cfg(cfg3, g, l)
        v = lambda k: kernels.variant(k, g, l)
        st = stats1 if g == 1 else stats
        table = ndt_grid.finalize_pack(st, c2.ndt, c2.grid, l == 4)
        k4 = check_k4("config 2", c2.ndt, c2.grid, st, jobs, l == 4)
        k4["shapes"] = {"config3": check_k4(
            "config 3", c3.ndt, c3.grid, map_stats(seq, c3.grid, dev), jobs,
            l == 4)}
        rows[v("finalize_pack")] = k4
        rows[v("ndt_terms")] = check_k1(c2, seq, table, seed, dev, c2.window,
                                        jobs)
        rows[v("lm_ndt")], (e, b) = check_lm(
            "window", lm_window_args(c2, seq, table, seed, dev, c2.window),
            c2.match, jobs)
        eq, lanes_n = eq + e, lanes_n + b
        rows[v("local_tables")] = check_k8a(c3, seq, seed, dev, c3.window,
                                            jobs)
        kf_l = box_store(c3, seq, dev)
        k = c3.loop.max_detect_per_window * c3.loop.max_candidates
        rows[v("ndt_terms_grouped")] = check_k1_grouped(c3, seq, kf_l, seed,
                                                        dev, k, jobs)
        rows[v("lm_ndt_grouped")], (e, b) = check_lm(
            "verify", lm_verify_args(c3, seq, kf_l, seed, dev, k), c3.match,
            jobs)
        eq, lanes_n = eq + e, lanes_n + b
        rows[v("loop_gate_fused")] = check_gated_verify(
            c3, seq, kf_l, seed, dev, c3.loop.max_candidates, jobs)
        del kf_l
    require(eq >= 0.98 * lanes_n,
            f"lm_ndt layouts: converged flags equal to the f32 twin's on "
            f"{eq}/{lanes_n} lanes (>= 98% required)")
    return rows


def smoother_state(state, seed: int):
    """The smoother's state at the end of a run (``state``: a ``SlamState``)
    with its 20 newest live poses moved by seeded noise (0.05 m, 0.01 rad),
    so an update has work to do, and its last step set to inf."""
    import numpy as np
    import torch

    from ndtpu_torch.graph import incremental as inc

    g = state.graph
    n = int(g.n_poses)
    lo = max(n - 20, 0)
    rng = np.random.default_rng(seed + 8)
    poses = g.poses.clone()
    noise = rng.normal(0.0, [0.05, 0.05, 0.01], (n - lo, 3))
    poses[lo:n] += torch.as_tensor(noise, dtype=poses.dtype,
                                   device=poses.device)
    return inc.SmootherState(
        graph=g._replace(poses=poses), lam=state.sm_lam,
        last_max_delta=torch.full_like(state.sm_last_delta, float("inf")),
        step=state.sm_step)


def graph_on(g, device, dtype):
    """A pose graph's copy on ``device``, float fields in ``dtype``."""
    return type(g)(*(t.to(device, dtype) if t.is_floating_point()
                     else t.to(device) for t in g))


def _rel_check(name, out, ref, rtol=1e-5):
    """``|out - ref| <= rtol * max|ref|`` per array, all finite; returns the
    largest abs error."""
    import torch

    worst = 0.0
    for k, (o, r) in enumerate(zip(out, ref)):
        require(bool(torch.isfinite(o).all()),
                f"{name}: output {k} not finite")
        err = float((o - r).abs().max()) if o.numel() else 0.0
        scale = float(r.abs().max()) if r.numel() else 0.0
        require(err <= rtol * scale, f"{name}: output {k} off by {err:.3e} "
                f"(tol {rtol:g} x max {scale:.3e})")
        worst = max(worst, err)
    return worst


#: f32 operations per row of K5 (between error and Jacobians, two 3 x 3
#: products, the whitened residual, the Huber weight, weight and mask, the
#: chi^2 term), counted from csrc/pose_graph.cuh; ~30 per prior.
K5_ROW_FLOPS = 180
#: K6, counted from csrc/pcg_solve.cu: per live factor in the set-up (two
#: sides' A^T A and A^T r) and per iteration (y_f, two sides' A^T y); per
#: pose in the set-up (damping, _inv3, M^-1 r, dots) and per iteration
#: (damp * p, the updates of x, r, z, p, three dots).
K6_SETUP_FACTOR, K6_ITER_FACTOR = 120, 69
K6_SETUP_POSE, K6_ITER_POSE = 80, 57


def _flat(lin):
    return [*lin[0], *lin[1]]


def k5_calls(sm, cfg3) -> dict:
    """K5's calls on the smoother's path, by mode, on ``sm``'s graph: the
    whole graph (an LM step's linearization), its chi^2, the local path's
    gathered rows and their chi^2 (the selection with the newest factor
    fresh), and the fresh window's max."""
    from ndtpu_torch.graph import factors as fct
    from ndtpu_torch.graph import incremental as inc

    g, huber = sm.graph, cfg3.solver.huber_delta
    sel = inc.local_select(g, cfg3.solver, g.n_between - 1)
    return {"whole graph": lambda: fct.linearize(g, huber),
            "chi2": lambda: fct.chi2(g, huber),
            "gathered": lambda: inc._local_lin(g, g.poses, sel, huber),
            "gathered chi2": lambda: inc._local_lin(g, g.poses, sel, huber,
                                                    chi_only=True),
            "fresh window": lambda: inc.fresh_residual_max(g)}


def device_kernels(fn, names=None, reps: int = 3):
    """The device operations (kernels, memsets, copies) ``fn`` makes per
    call, by name, read under ``torch.profiler`` over ``reps`` calls after a
    warm-up; None when five sessions record none. A session sometimes
    records only part of the calls' device events, so with ``names`` (one
    launch per call expected, a kernel's name fragments) sessions are
    retried until one records ``reps`` operations; None (not measured)
    when none of five does, else the check is that no session records
    more and that every one recorded is one kernel, named so (the
    two-launch design shows two names)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    seen = []
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        ev = [e.name for e in prof.events()
              if e.device_type == DeviceType.CUDA]
        if ev:
            seen.append(ev)
            if names is None or len(ev) >= reps:
                break
    counts = [len(ev) for ev in seen]
    if not seen or (names is not None and max(counts) < reps):
        return None
    distinct = sorted({e for ev in seen for e in ev})
    if names is not None:
        require(len(distinct) == 1 and any(n in distinct[0] for n in names)
                and max(counts) == reps,
                f"{names}: device operations {distinct}, {counts} per "
                f"session of {reps} calls (one launch per call expected)")
    return distinct


def check_k5_one_launch(sm, cfg3, jobs=None) -> dict:
    """One K5 launch per call in every mode (:func:`k5_calls`):
    ``LAUNCHES["factor_linearize"]`` grows by one per call, and the
    profiler sees at most one device operation per call, all of them one
    kernel, K5's (:func:`device_kernels`; read at once without ``jobs``,
    else queued with the card times). Returns, per mode, the launches per
    call and (once read) the kernel's name."""
    from ndtpu_torch import kernels

    row = {}
    for mode, fn in k5_calls(sm, cfg3).items():
        before = kernels.LAUNCHES["factor_linearize"]
        fn()
        n = kernels.LAUNCHES["factor_linearize"] - before
        require(n == 1, f"K5 {mode}: {n} launches per call (one expected)")
        row[mode] = dict(launches_per_call=n)
        card_time(jobs, f"K5 {mode}: device operations per call", row[mode],
                  "device_kernels", fn, ["linearize"],
                  measure=device_kernels)
    return row


def check_k5(sm, cfg3, jobs=None):
    """K5 against ``factor_linearize_ref`` (f32, on the card) on a real
    graph: the whole graph, the local path's gathered rows, chi^2 only and
    the fresh window; each array within rtol 1e-5 of its max, chi^2 and
    the window's max within rtol 1e-5; bit-identical on a second launch;
    one launch per call in every mode (:func:`check_k5_one_launch`)."""
    import torch

    from ndtpu_torch.graph import factors as fct
    from ndtpu_torch.graph import incremental as inc

    g, huber = sm.graph, cfg3.solver.huber_delta
    args = fct._graph_args(g)
    run = lambda: fct.linearize(g, huber)
    out, again = run(), run()
    ref = fct.factor_linearize_ref(*args, huber)
    chi, chi2 = fct.chi2(g, huber), fct.chi2(g, huber)
    chi_ref = torch.sum(ref[0][2] ** 2) + torch.sum(ref[1][1] ** 2)
    torch.cuda.synchronize()
    require(bits_equal(_flat(out), _flat(again)), "K5: two launches differ")
    require(bits_equal(chi, chi2), "K5 chi2: two launches differ")
    err = _rel_check("K5 linearize", _flat(out), _flat(ref))
    _rel_check("K5 chi2", [chi[None]], [chi_ref[None]])
    sel = inc.local_select(g, cfg3.solver, g.n_between - 1)
    loc = inc._local_lin(g, g.poses, sel, huber)
    loc_ref = fct.factor_linearize_ref(
        g.poses, g.bet_i, g.bet_j, g.bet_z, g.bet_sqrt_info, sel["f_sel"],
        g.prior_idx, g.prior_z, g.prior_sqrt_info, sel["p_act"], huber,
        fid=sel["fid"])
    require(bits_equal(_flat(loc), _flat(inc._local_lin(g, g.poses, sel,
                                                        huber))),
            "K5 gathered: two launches differ")
    err = max(err, _rel_check("K5 gathered", _flat(loc), _flat(loc_ref)))
    win, win_ref = inc.fresh_residual_max(g), inc.fresh_residual_max_ref(g)
    _rel_check("K5 fresh window", [win[None]], [win_ref[None]])
    one = check_k5_one_launch(sm, cfg3, jobs)
    ms = time_ms(run)
    plain = time_ms(lambda: fct.factor_linearize_ref(*args, huber))
    f, p = g.bet_i.shape[0], g.prior_idx.shape[0]
    live = int(g.bet_mask.sum())
    # Every row's mask read and Ai, Aj, r written (85 B); a live row's two
    # poses (24 B), z, sqrt-info and two indices read (88 B); per prior
    # 61 B read, 48 written. Only live rows need the arithmetic.
    bd = bound(f * 85 + live * 88 + p * 109 + 16,
               live * K5_ROW_FLOPS + p * 30)
    print(f"[smoke] K5 factor_linearize F={f} ({live} live) "
          f"P={p}: vs f32 plain max abs err {err:.3e} (rtol 1e-5 of each "
          f"array's max; also the gathered K={sel['fid'].shape[0]} rows), "
          f"chi2 {float(chi):.6e} vs {float(chi_ref):.6e}, fresh-window max "
          f"{float(win):.6e} vs {float(win_ref):.6e}; bit-identical on a "
          f"second launch; one launch per call in each of its five modes; "
          f"kernel {ms:.4f} ms, plain {plain:.4f} ms, bound "
          f"{bd['bound_ms']:.6f} ms ({bd['bound_by']})")
    row = dict(max_abs_err=err, ms=ms, plain_ms=plain, **bd)
    row["one_launch"] = one
    card_time(jobs, "K5 factor_linearize", row, "card_ms", run,
              ["linearize_"], per_call=1)
    return row


def k6_bound(g, n_it: int) -> dict:
    """K6's and K6g's bound on a solve of ``n_it`` iterations: every
    factor's mask (1 B), a live factor's linearization and indices (100 B),
    the priors (57 B) and the pose mask read once; x [V, 3] and the two
    scalars written. A dead pose's rhs is 0, so its r, z, p and x stay 0:
    only live factors and poses need the arithmetic."""
    v, f, p = g.poses.shape[0], g.bet_i.shape[0], g.prior_idx.shape[0]
    live, live_v = int(g.bet_mask.sum()), int(g.pose_mask.sum())
    return bound(f + live * 100 + p * 57 + v + v * 12 + 8,
                 live * (K6_SETUP_FACTOR + n_it * K6_ITER_FACTOR)
                 + live_v * (K6_SETUP_POSE + n_it * K6_ITER_POSE))


def k6g_traffic_ms(g, n_it: int) -> float:
    """What K6g's design moves through memory, at HBM rate: each iteration,
    for each of a live factor's two list places, its Ai and Aj (72 B), the
    other endpoint's z and p_old (24 B) and the place's key and other
    endpoint (8 B); a prior's Ap and place (44 B); each live pose's list
    offsets (8 B), M^-1 (36 B), z and p_old read, p, q, x, r and z written,
    damping, q, x and r read (12 B each). Beside the bound's one read of
    the inputs; not the bound (the state stays in L2), the cost of keeping
    the graph in global memory."""
    live, live_v = int(g.bet_mask.sum()), int(g.pose_mask.sum())
    pri = int(g.prior_mask.sum())
    return n_it * (live * 2 * 104 + pri * 44 + live_v * 176) / HBM_BYTES_S \
        * 1e3


def pcg_vs_plain(name, run, g, lin, lam, max_iter: int, tol: float,
                 it_slack: float):
    """``run()`` (K6 or K6g) against the f32 plain ``pcg_solve_ref`` on the
    card and the f64 plain version (CPU) on the same system: bit-identical
    on a second launch, x finite, its error against f64 <= 2 x the f32
    plain version's + 1e-6 x max|x|, its iterations within max(1, it_slack
    x) the f32 plain version's. Returns ``(row fields, x, iterations)``."""
    import torch

    from ndtpu_torch.graph import solve as slv

    x, it, _ = run()
    again = run()
    xp, itp, _ = slv.pcg_solve_ref(g, lin, None, lam, max_iter, tol)
    lin64 = tuple(tuple(t.cpu().double() for t in part) for part in lin)
    lam64 = lam.cpu().double() if isinstance(lam, torch.Tensor) else lam
    x64, it64, _ = slv.pcg_solve_ref(graph_on(g, "cpu", torch.float64), lin64,
                                     None, lam64, max_iter, tol)
    torch.cuda.synchronize()
    require(bits_equal((x, it), again[:2]), f"{name}: two launches differ")
    require(bool(torch.isfinite(x).all()), f"{name}: x not finite")
    ek = float((x.cpu().double() - x64).abs().max())
    ep = float((xp.cpu().double() - x64).abs().max())
    xmax = float(x64.abs().max())
    require(ek <= 2.0 * ep + 1e-6 * xmax,
            f"{name}: {ek:.3e} off f64, over 2 x the f32 plain version's "
            f"{ep:.3e} + 1e-6 x {xmax:.3e}")
    n_it, n_itp = int(it), int(itp)
    require(abs(n_it - n_itp) <= max(1, it_slack * n_itp),
            f"{name}: {n_it} iterations, the f32 plain version {n_itp}")
    return (dict(max_abs_err=ek, plain_f32_err_vs_f64=ep, iterations=n_it,
                 plain_f32_iterations=n_itp, f64_iterations=int(it64),
                 max_abs_x=xmax), x, it)


def check_settled_step(name, solve, g, lin, tol):
    """The 0-iteration mode (the settled check's preconditioned step): no
    iteration, max |M^-1 rhs| within rtol 1e-5 of the plain version's."""
    from ndtpu_torch.graph import solve as slv

    _, it0, z0 = solve(g, lin, None, 0.0, 0, tol, 1e-8)
    _, _, z0p = slv.pcg_solve_ref(g, lin, None, 0.0, 0, tol, 1e-8)
    require(int(it0) == 0, f"{name}: iterations with max_iter 0")
    _rel_check(f"{name} settled step", [z0[None]], [z0p[None]])
    return float(z0), float(z0p)


def check_one_launch(name, counter, g, lin, lam, cfg):
    """One ``counter`` launch, and no other PCG kernel's, per ``pcg`` call,
    and no host sync in it."""
    import torch

    from ndtpu_torch import kernels
    from ndtpu_torch.graph import solve as slv

    pcgs = ("pcg_solve", "pcg_solve_grid")
    before = {k: kernels.LAUNCHES[k] for k in pcgs}
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        slv.pcg(g, lin, lam, cfg)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    require(all(kernels.LAUNCHES[k] == before[k] + (k == counter)
                for k in pcgs),
            f"{name}: not one {counter} launch per pcg call")


def check_k6(sm, cfg3, jobs=None):
    """K6 against the f32 plain ``pcg_solve_ref`` (on the card) and the f64
    plain version (CPU) on the same system (:func:`pcg_vs_plain`; the
    kernel sums in another order than either, so it is not bit-equal to
    them; iterations within 1 of the f32 plain version's). Also: one
    launch per ``pcg`` call and no host sync in it, the 0-iteration mode
    (the settled check's step) within rtol 1e-5, and the dense library
    solve of the same damped system timed beside it. Then K6g on the same
    1,024-slot graph (where the route takes K6), held to the same gates
    and timed beside K6: ``row["grid"]``."""
    import torch

    from ndtpu_torch import kernels
    from ndtpu_torch.graph import factors as fct
    from ndtpu_torch.graph import solve as slv

    g, cfg = sm.graph, cfg3.solver
    lin = fct.factor_linearize_ref(*fct._graph_args(g), cfg.huber_delta)
    lam = torch.tensor(cfg.init_lambda, dtype=torch.float32,
                       device=g.poses.device)
    v, f, p = g.poses.shape[0], g.bet_i.shape[0], g.prior_idx.shape[0]
    require(kernels.pcg_route(v, f, p) == "block",
            f"K6: the route sends {v} poses, {f} factors to K6g")
    run = lambda: slv.pcg_solve(g, lin, None, lam, cfg.pcg_max_iter,
                                cfg.pcg_tol)
    row, _, it = pcg_vs_plain("K6", run, g, lin, lam, cfg.pcg_max_iter,
                              cfg.pcg_tol, 0.0)
    z0, z0p = check_settled_step("K6", slv.pcg_solve, g, lin, cfg.pcg_tol)
    check_one_launch("K6", "pcg_solve", g, lin, lam, cfg)
    settled = lambda: slv.pcg_solve(g, lin, None, 0.0, 0, cfg.pcg_tol, 1e-8)
    ms = time_ms(run)
    settled_ms = time_ms(settled)
    plain = time_ms(lambda: slv.pcg_solve_ref(g, lin, None, lam,
                                              cfg.pcg_max_iter, cfg.pcg_tol),
                    reps=5)
    h, b = slv.normal_equations(g, lin)
    damp = lam * torch.clamp(torch.abs(torch.diagonal(h)), min=1e-8)
    dead = (1.0 - g.pose_mask.float()).repeat_interleave(3)
    hd = h + torch.diag(damp + dead)

    def library():
        chol, _ = torch.linalg.cholesky_ex(hd)
        return torch.cholesky_solve(-b[:, None], chol)

    lib = time_ms(library)
    live, n_it = int(g.bet_mask.sum()), int(it)
    live_v = int(g.pose_mask.sum())
    bd = k6_bound(g, n_it)
    print(f"[smoke] K6 pcg_solve V={v} ({live_v} live) F={f} ({live} live): "
          f"{n_it} "
          f"iterations (f32 plain {row['plain_f32_iterations']}, f64 "
          f"{row['f64_iterations']}); vs f64 max "
          f"abs err {row['max_abs_err']:.3e} (f32 plain "
          f"{row['plain_f32_err_vs_f64']:.3e}; max|x| "
          f"{row['max_abs_x']:.3e}); "
          f"bit-identical on a second launch; one launch per pcg call, no "
          f"host sync; settled step {z0:.6e} vs {z0p:.6e}, kernel "
          f"{settled_ms:.4f} ms; "
          f"kernel {ms:.4f} ms ({ms * 1e3 / max(n_it, 1):.3f} us per "
          f"iteration, the set-up included), plain {plain:.4f} ms, library "
          f"(dense "
          f"cholesky_ex + cholesky_solve of the {3 * v} x {3 * v} damped "
          f"system: a direct solve) {lib:.4f} ms, bound {bd['bound_ms']:.6f} "
          f"ms ({bd['bound_by']})")
    row.update(ms=ms, plain_ms=plain, **bd, settled_ms=settled_ms,
               us_per_iteration=ms * 1e3 / max(n_it, 1))
    row.update(library_ms=lib, library="torch.linalg.cholesky_ex + "
               "torch.cholesky_solve of solve_dense's damped system: a "
               "direct solve, not the same algorithm")
    card_time(jobs, "K6 pcg_solve", row, "card_ms", run, ["pcg_solve"],
              per_call=1)
    card_time(jobs, "K6 settled step (0 iterations)", row, "settled_card_ms",
              settled, ["pcg_solve"], per_call=1)
    grid = lambda: kernels.pcg_solve_grid(
        g.bet_i, g.bet_j, g.bet_mask, g.prior_idx, g.prior_mask, g.pose_mask,
        lin, None, lam, cfg.pcg_max_iter, cfg.pcg_tol)
    row_g, _, it_g = pcg_vs_plain("K6g on config 3's graph", grid, g, lin,
                                  lam, cfg.pcg_max_iter, cfg.pcg_tol, 0.02)
    ms_g = time_ms(grid)
    blocks = kernels.pcg_grid_plan(v, f, p)[0]
    row_g.update(ms=ms_g, grid_blocks=blocks, **k6_bound(g, int(it_g)))
    print(f"[smoke] K6g pcg_solve_grid on the same graph ({blocks} blocks): "
          f"{int(it_g)} iterations, vs f64 max abs err "
          f"{row_g['max_abs_err']:.3e}; bit-identical on a second launch; "
          f"kernel {ms_g:.4f} ms beside K6's {ms:.4f} ms")
    card_time(jobs, "K6g pcg_solve_grid on config 3's graph", row_g,
              "card_ms", grid, ["pcg_grid"], per_call=1)
    row["grid"] = row_g
    row["scattered"] = check_k6_scattered(sm, cfg3)
    row["scratch"] = check_k6_scratch(g.poses.device)
    return row


def permuted_graph(g, seed: int):
    """``g`` with its pose slots and its factor slots each in a random order
    from ``seed`` (pose ``k`` to slot ``perm[k]``; the factors' and priors'
    indices follow). Returns ``(graph, perm)``."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    dev = g.poses.device
    v, f = g.poses.shape[0], g.bet_i.shape[0]
    pv = torch.as_tensor(rng.permutation(v), device=dev)
    pf = torch.as_tensor(rng.permutation(f), device=dev)
    inv_v, inv_f = torch.argsort(pv), torch.argsort(pf)
    fac = lambda t: t[inv_f].contiguous()
    return g._replace(
        poses=g.poses[inv_v].contiguous(),
        pose_mask=g.pose_mask[inv_v].contiguous(),
        prior_idx=pv[g.prior_idx].to(g.prior_idx.dtype).contiguous(),
        bet_i=fac(pv[g.bet_i].to(g.bet_i.dtype)),
        bet_j=fac(pv[g.bet_j].to(g.bet_j.dtype)), bet_z=fac(g.bet_z),
        bet_sqrt_info=fac(g.bet_sqrt_info), bet_mask=fac(g.bet_mask)), pv


#: Slot orders of :func:`check_k6_scattered`: the graph scattered by
#: ``permuted_graph(g, SCATTER_SEEDS[0])``, then that graph permuted by each
#: of the others.
SCATTER_SEEDS = (11, 12, 13, 14, 15, 16)


def check_k6_scattered(sm, cfg3) -> dict:
    """K6 on the graph of :func:`check_k6` with its live poses and factors
    scattered through the slots (:func:`permuted_graph`), and on that graph
    with its slots permuted five times more, each order held to
    :func:`pcg_vs_plain`'s gates: bit-identical on a second launch, x
    finite, iterations within 1 of the f32 plain version's, and K6's error
    against f64 within 2 x the f32 plain version's + 1e-6 x max|x|. The
    plain version runs on the CPU here (its sums are then in one order on
    every run), and the error gate holds for the medians over the orders:
    100 iterations stop short of the tolerance, so one solve's f32 error
    scatters several-fold with the sums' order, for the plain version as
    for K6 (and the card's plain version, whose ``index_add_`` sums are
    atomic, changes from run to run). Also prints how far each order's
    solution, back in the first order's slots, is from the first."""
    import torch

    from ndtpu_torch.graph import factors as fct
    from ndtpu_torch.graph import solve as slv

    cfg = cfg3.solver
    lam = torch.tensor(cfg.init_lambda, dtype=torch.float32,
                       device=sm.graph.poses.device)
    ga, _ = permuted_graph(sm.graph, SCATTER_SEEDS[0])
    orders = [(ga, None)] + [permuted_graph(ga, s) for s in SCATTER_SEEDS[1:]]
    ek, ep, its, diffs, xmax = [], [], [], [], 0.0
    for n, (g, perm) in enumerate(orders):
        name = f"K6 scattered, order {n}"
        lin = fct.factor_linearize_ref(*fct._graph_args(g), cfg.huber_delta)
        run = lambda: slv.pcg_solve(g, lin, None, lam, cfg.pcg_max_iter,
                                    cfg.pcg_tol)
        (x, it, _), again = run(), run()
        cpu = lambda dt: (graph_on(g, "cpu", dt), tuple(
            tuple(t.cpu().to(dt) for t in part) for part in lin))
        g32, lin32 = cpu(torch.float32)
        g64, lin64 = cpu(torch.float64)
        xp, itp, _ = slv.pcg_solve_ref(g32, lin32, None, lam.cpu(),
                                       cfg.pcg_max_iter, cfg.pcg_tol)
        x64, _, _ = slv.pcg_solve_ref(g64, lin64, None, lam.cpu().double(),
                                      cfg.pcg_max_iter, cfg.pcg_tol)
        torch.cuda.synchronize()
        require(bits_equal((x, it), again[:2]), f"{name}: two launches differ")
        require(bool(torch.isfinite(x).all()), f"{name}: x not finite")
        require(abs(int(it) - int(itp)) <= 1, f"{name}: {int(it)} "
                f"iterations, the f32 plain version {int(itp)}")
        ek.append(float((x.cpu().double() - x64).abs().max()))
        ep.append(float((xp.double() - x64).abs().max()))
        its.append(int(it))
        xmax = max(xmax, float(x64.abs().max()))
        back = x if perm is None else x[perm]
        if n == 0:
            first = back
        diffs.append(float((back - first).abs().max()))
    med_k, med_p = statistics.median(ek), statistics.median(ep)
    require(med_k <= 2.0 * med_p + 1e-6 * xmax,
            f"K6 scattered: the median error over {len(orders)} slot orders "
            f"{med_k:.3e} off f64, over 2 x the f32 plain version's "
            f"{med_p:.3e} + 1e-6 x {xmax:.3e}")
    print(f"[smoke] K6 on the graph with its live poses and factors "
          f"scattered through the slots, in {len(orders)} slot orders: "
          f"iterations {its}; vs f64 max abs err {[f'{e:.2e}' for e in ek]} "
          f"(f32 plain on the CPU {[f'{e:.2e}' for e in ep]}; median "
          f"{med_k:.3e} vs {med_p:.3e}); "
          f"each order's x from the first's, in its slots: "
          f"{[f'{d:.2e}' for d in diffs]}")
    return dict(iterations=its, max_abs_err=ek, plain_f32_err_vs_f64=ep,
                diff_from_first=diffs)


#: A graph whose live data K6 cannot keep in the shared memory its layout
#: leaves (16 B per list place and 76 B per live factor: ~130 KB here,
#: where ~75 KB are left), so its loop reads through L1 and the device
#: scratch: config 4's Manhattan generator at this many poses, every slot
#: live.
K6_SCRATCH_POSES = 1200


def check_k6_scratch(dev) -> dict:
    """K6 on :data:`K6_SCRATCH_POSES` poses of config 4's Manhattan graph
    (its route says K6), at K6g's 10k settings (lam 1e-3, 250 iterations,
    tol 1e-5): :func:`pcg_vs_plain` (iterations within max(1, 2%), as K6g
    is held)."""
    import torch

    from ndtpu_torch import kernels
    from ndtpu_torch.graph import factors as fct
    from ndtpu_torch.graph import solve as slv

    g = config4_graph(dev, torch.float32, 0, K6_SCRATCH_POSES)
    v, f, p = g.poses.shape[0], g.bet_i.shape[0], g.prior_idx.shape[0]
    require(kernels.pcg_route(v, f, p) == "block",
            f"K6 scratch: the route sends {v} poses to K6g")
    lin = fct.linearize(g)
    lam = torch.tensor(K6G_10K["lam"], dtype=torch.float32, device=dev)
    mi, tol = K6G_10K["max_iter"], K6G_10K["tol"]
    before = kernels.LAUNCHES["pcg_solve"]
    row, _, it = pcg_vs_plain("K6 through the scratch",
                              lambda: slv.pcg_solve(g, lin, None, lam, mi,
                                                    tol), g, lin, lam, mi,
                              tol, 0.02)
    require(kernels.LAUNCHES["pcg_solve"] == before + 2,
            "K6 scratch: not K6's launches")
    print(f"[smoke] K6 on a {v}-pose graph, every slot live ({f} factors; "
          f"its loop through L1 and the device scratch): {int(it)} "
          f"iterations (f32 plain {row['plain_f32_iterations']}), vs f64 "
          f"max abs err {row['max_abs_err']:.3e} (f32 plain "
          f"{row['plain_f32_err_vs_f64']:.3e}); bit-identical on a second "
          f"launch")
    return row


def finish_per_iteration(row, label) -> None:
    """A PCG kernel's card time per iteration, once the card times are
    read: the solve's less the 0-iteration launch's (the set-up), over its
    iterations; not measured unless both readings were taken and the
    solve's is the longer."""
    ms, setup = row.get("card_ms"), row.get("settled_card_ms")
    row["card_us_per_iteration"] = (
        None if ms is None or setup is None or ms <= setup
        else (ms - setup) * 1e3 / max(row["iterations"], 1))
    print(f"[smoke] {label} card time: {_fmt(ms)} per "
          f"{row['iterations']}-iteration solve, its set-up "
          f"{_fmt(setup)}, "
          + ("per iteration not measured"
             if row["card_us_per_iteration"] is None else
             f"{row['card_us_per_iteration']:.3f} us per iteration"))


#: K6g on bench.py §4's 10k-pose graph: its damping, PCG cap and tolerance
#: (bench.py's BA step and solve_g2o's PCG).
K6G_10K = dict(lam=1e-3, max_iter=250, tol=1e-5)
#: The four-sync K6g's event time per iteration there, us (PERF.md §6, on
#: an H100 80GB HBM3 at 700 W), beside which the smoke prints the two-sync
#: design's.
K6G_FOUR_SYNC_US = (11.83, 12.44)


def check_k6g(c4, jobs=None):
    """K6g on config 4's (bench.py §4's) 10k-pose graph, 10,305 factors,
    K5-linearized, at lam 1e-3, 250 iterations, tol 1e-5: through
    ``graph.solve.pcg_solve``'s route (it must say grid), against the f32
    plain version on the card and the f64 one on the CPU
    (:func:`pcg_vs_plain`, iterations within max(1, 2%)), bit-identical on
    a second launch, the 0-iteration mode within rtol 1e-5, one launch and
    no host sync per ``pcg`` call; event, card and plain times, the
    library's dense Cholesky solve of the damped 30,000 x 30,000 system
    (median of 5), the bound and K6g's own traffic."""
    import torch

    from ndtpu_torch import kernels
    from ndtpu_torch.config import SolverConfig
    from ndtpu_torch.graph import solve as slv

    g, lin = c4["g"], c4["lin"]
    dev = g.poses.device
    v, f, p = g.poses.shape[0], g.bet_i.shape[0], g.prior_idx.shape[0]
    require(kernels.pcg_route(v, f, p) == "grid",
            f"K6g: the route keeps {v} poses, {f} factors on K6")
    lam = torch.tensor(K6G_10K["lam"], dtype=torch.float32, device=dev)
    mi, tol = K6G_10K["max_iter"], K6G_10K["tol"]
    run = lambda: slv.pcg_solve(g, lin, None, lam, mi, tol)
    row, _, it = pcg_vs_plain("K6g", run, g, lin, lam, mi, tol, 0.02)
    z0, z0p = check_settled_step("K6g", slv.pcg_solve, g, lin, tol)
    check_one_launch("K6g", "pcg_solve_grid", g, lin, lam,
                     SolverConfig(pcg_max_iter=mi, pcg_tol=tol))
    settled = lambda: slv.pcg_solve(g, lin, None, 0.0, 0, tol, 1e-8)
    ms = time_ms(run)
    settled_ms = time_ms(settled)
    plain = time_ms(lambda: slv.pcg_solve_ref(g, lin, None, lam, mi, tol),
                    reps=5)
    h, b = slv.normal_equations(g, lin)
    damp = lam * torch.clamp(torch.abs(torch.diagonal(h)), min=1e-8)
    hd = h + torch.diag(damp + (1.0 - g.pose_mask.float()).repeat_interleave(
        3))
    del h

    def library():
        chol, _ = torch.linalg.cholesky_ex(hd)
        return torch.cholesky_solve(-b[:, None], chol)

    lib = time_ms(library, reps=5)
    del hd, b
    torch.cuda.empty_cache()
    n_it = int(it)
    blocks = kernels.pcg_grid_plan(v, f, p)[0]
    bd = k6_bound(g, n_it)
    traffic = k6g_traffic_ms(g, n_it)
    us_it = (ms - settled_ms) * 1e3 / max(n_it, 1)
    row.update(ms=ms, ms_per_iter=ms / max(n_it, 1), plain_ms=plain,
               settled_ms=settled_ms, us_per_iteration=us_it,
               grid_blocks=blocks, traffic_ms=traffic, **bd)
    row.update(library_ms=lib, library="torch.linalg.cholesky_ex + "
               "torch.cholesky_solve of solve_dense's damped 30,000 x 30,000 "
               "system (median of 5): a direct solve, not the same "
               "algorithm")
    print(f"[smoke] K6g pcg_solve_grid V={v} F={f} ({blocks} blocks): "
          f"{n_it} iterations (f32 plain "
          f"{row['plain_f32_iterations']}, f64 {row['f64_iterations']}); vs "
          f"f64 max abs err {row['max_abs_err']:.3e} (f32 plain "
          f"{row['plain_f32_err_vs_f64']:.3e}; max|x| "
          f"{row['max_abs_x']:.3e}); bit-identical on a second launch; one "
          f"launch per pcg call, no host sync; settled step {z0:.6e} vs "
          f"{z0p:.6e}, its set-up alone {settled_ms:.4f} ms; kernel "
          f"{ms:.4f} ms ({us_it:.2f} us per iteration past the set-up; the "
          f"four-sync design {K6G_FOUR_SYNC_US[0]}-{K6G_FOUR_SYNC_US[1]} us "
          f"with it, PERF.md), plain {plain:.4f} ms, library (dense "
          f"cholesky_ex + cholesky_solve of the {3 * v} x {3 * v} damped "
          f"system: a direct solve) {lib:.4f} ms, bound "
          f"{bd['bound_ms']:.6f} ms ({bd['bound_by']}), K6g's own traffic "
          f"at HBM rate {traffic:.4f} ms")
    card_time(jobs, "K6g pcg_solve_grid 10k", row, "card_ms", run,
              ["pcg_grid"], per_call=1)
    card_time(jobs, "K6g 10k settled step (0 iterations: the set-up)", row,
              "settled_card_ms", settled, ["pcg_grid"], per_call=1)
    return row


#: What K7a writes: the selection the local path reads.
SELECT_KEYS = ("ok", "pid", "in_set", "fid", "f_sel", "ri", "rj", "li", "lj",
               "rp", "lp", "p_act")


def k7a_bound(g, cfg, sel) -> dict:
    """K7a's bound on graph ``g``: indices and masks read (17 B per factor,
    1 per pose, 9 per prior), the flags and int64 outputs written; ~8
    integer operations per factor per pass (the sweeps and two more) and
    per pose, at the f32 rate."""
    v, f, p = g.poses.shape[0], g.bet_i.shape[0], g.prior_idx.shape[0]
    p_loc, f_loc = sel["p_loc"], sel["fid"].shape[0]
    return bound(f * 17 + v + p * 9 + 16 + (1 + p_loc + f_loc + p)
                 + 8 * (p_loc + 5 * f_loc + 2 * p),
                 8.0 * f * (cfg.local_hops + 2) + 8.0 * v)


def k7a_case(label, g, cfg, since, jobs=None):
    """K7a on graph ``g`` bit-equal to ``local_select_ref`` (on the card)
    with ``since`` = the given factor index, none, and 40 factors back, and
    on a second launch, each a launch of the route ``kernels.select_route``
    names and no other; timed at ``since`` (event ms, the plain version's,
    the bound; card ms queued in ``jobs``). Returns the row."""
    import torch

    from ndtpu_torch import kernels
    from ndtpu_torch.graph import incremental as inc

    v, f = g.poses.shape[0], g.bet_i.shape[0]
    route = kernels.select_route(v, f)
    counter = "local_select" if route == "shared" else "local_select[scratch]"
    other = ({"local_select", "local_select[scratch]"} - {counter}).pop()
    oks = []
    for sn in (since, None, since - 40):
        before = dict(kernels.LAUNCHES)
        one, two = (inc.local_select(g, cfg, sn) for _ in range(2))
        ref = inc.local_select_ref(g, cfg, sn)
        torch.cuda.synchronize()
        require(kernels.LAUNCHES[counter] == before[counter] + 2
                and kernels.LAUNCHES[other] == before[other],
                f"K7a {label}: not two {counter} launches")
        for key in SELECT_KEYS:
            require(bits_equal(one[key], ref[key].to(one[key].dtype)),
                    f"K7a {label}: {key} differs from the plain selection")
            require(bits_equal(one[key], two[key]),
                    f"K7a {label}: {key} differs on a second launch")
        oks.append(bool(one["ok"]))
    run = lambda: inc.local_select(g, cfg, since)
    ms = time_ms(run)
    plain = time_ms(lambda: inc.local_select_ref(g, cfg, since))
    sel = run()
    bd = k7a_bound(g, cfg, sel)
    smem = kernels.select_smem(v, f)
    layout = ("a device scratch" if route == "scratch"
              else f"staged in {smem} B of shared memory"
              if smem <= kernels.SMEM_MAX
              else f"{kernels.select_smem(v, f, 0)} B of shared memory, "
                   f"the endpoints read from the graph")
    print(f"[smoke] K7a local_select {label} (V={v}, F={f}; {layout}): "
          f"bit-equal to the plain selection and on a second launch "
          f"(since = {int(since)}, none, 40 back: ok {oks}); "
          f"{int(sel['in_set'].sum())} active poses and "
          f"{int(sel['f_sel'].sum())} touched factors selected; kernel "
          f"{ms:.4f} ms, plain {plain:.4f} ms, bound {bd['bound_ms']:.6f} "
          f"ms ({bd['bound_by']})")
    row = dict(max_abs_err=0.0, ms=ms, plain_ms=plain, **bd, pose_slots=v,
               factor_slots=f, select_smem=smem)
    card_time(jobs, f"K7a {counter} {label}", row, "card_ms", run,
              ["local_select"], per_call=1)
    return row


def check_k7a(sm, cfg3, jobs=None):
    """K7a (:func:`k7a_case`) on the config-3 graph of ``sm`` (1,024 pose
    slots) and on bench.py §5b's local graph (:func:`local_graph` of config
    4's 10k Manhattan graph: 10,064 pose slots), each timed with the newest
    factor fresh (config 3) or the four new ones (§5b). Returns the
    config-3 row, with §5b's under ``local_10k``."""
    import torch

    from ndtpu_torch.config import SolverConfig

    g = sm.graph
    row = k7a_case("config 3", g, cfg3.solver, g.n_between - 1, jobs)
    g10, s10 = local_graph(config4_graph(g.poses.device, torch.float32, 0,
                                         CONFIG4["n_poses"]))
    row["local_10k"] = k7a_case("bench §5b local graph", g10,
                                SolverConfig(**ICFG_10K), s10, jobs)
    return row


def k7b_args(sm, cfg3):
    """K7b's arguments on a real local selection of ``sm``'s graph (the
    newest factor fresh): ``(n, ai, aj, r, ap, rp, f_sel, ri, li, rj, lj,
    p_act, p_role, lp)``, and the selection."""
    from ndtpu_torch.graph import incremental as inc

    g, cfg = sm.graph, cfg3.solver
    sel = inc.local_select(g, cfg, g.n_between - 1)
    (ai, aj, r), (ap, rp) = inc._local_lin(g, g.poses, sel, cfg.huber_delta)
    return (sel["p_loc"], ai, aj, r, ap, rp, sel["f_sel"], sel["ri"],
            sel["li"], sel["rj"], sel["lj"], sel["p_act"], sel["rp"],
            sel["lp"]), sel


#: K7b past the old kernel's shared-memory limit (~7,258 gathered slots):
#: 8,192 slots, 256 local poses, 16 priors.
K7B_PAST = dict(k=8192, n=256, p=16)


def k7b_random_args(dev, k: int, n: int, p: int, seed: int = 0):
    """K7b's arguments on seeded random rows (numpy): ``k`` gathered slots,
    3 in 4 selected, each endpoint interior with probability 0.8 at a
    uniform local slot in [0, n) (so ~2.2 k / n contributions per row:
    buckets past one warp's 32 places at k >> n, repeated pairs), ``p``
    priors, half active, interior with probability 0.8; blocks of f32
    standard normals."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    t = lambda a, dt=None: torch.as_tensor(a, dtype=dt, device=dev)
    f32 = torch.float32
    ai, aj = (t(rng.standard_normal((k, 3, 3)), f32) for _ in range(2))
    r = t(rng.standard_normal((k, 3)), f32)
    ap, rp = t(rng.standard_normal((p, 3, 3)), f32), t(
        rng.standard_normal((p, 3)), f32)
    f_sel = t(rng.random(k) < 0.75)
    role = lambda m: t((rng.random(m) >= 0.8).astype(np.int64))
    loc = lambda m: t(rng.integers(0, n, m))
    ri, li, rj, lj = role(k), loc(k), role(k), loc(k)
    p_act, p_role, lp = t(rng.random(p) < 0.5), role(p), loc(p)
    return (n, ai, aj, r, ap, rp, f_sel, ri, li, rj, lj, p_act, p_role, lp)


def k7b_bound(args) -> dict:
    """Blocks and selection read (117 B per row, 65 per prior), h_ii and b_i
    written; 54 operations per 3 x 3 contribution (own and cross), 18 per
    A^T r."""
    n, ai, _, _, ap, _, fs, ri, _, rj, _, pa, pr, _ = args
    k, p = ai.shape[0], ap.shape[0]
    ii, jj = fs & (ri == 0), fs & (rj == 0)
    own = int(ii.sum()) + int(jj.sum()) + int((pa & (pr == 0)).sum())
    both = int((ii & jj).sum())
    return bound(k * 117 + p * 65 + 36 * n * n + 12 * n,
                 54.0 * (own + 2 * both) + 18.0 * own)


def k7b_case(label, args, jobs=None, card_key=None):
    """One K7b case against ``assemble_local_ref`` (f32, on the card): h_ii
    and b_i within rtol 1e-5 of their max, bit-identical on a second
    launch; timed. Returns the row."""
    import torch

    from ndtpu_torch.dist import schur

    run = lambda: schur.assemble_local(*args)
    out, again = run(), run()
    ref = schur.assemble_local_ref(*args)
    torch.cuda.synchronize()
    require(bits_equal(out, again), f"K7b {label}: two launches differ")
    err = _rel_check(f"K7b {label}", out, ref)
    ms = time_ms(run)
    plain = time_ms(lambda: schur.assemble_local_ref(*args))
    bd = k7b_bound(args)
    n, k = args[0], args[1].shape[0]
    print(f"[smoke] K7b local_assemble {label} n={n} K={k} "
          f"({int(args[6].sum())} selected): vs f32 plain max abs err "
          f"{err:.3e} (rtol 1e-5 of the max); bit-identical on a second "
          f"launch; kernel {ms:.4f} ms, plain {plain:.4f} ms, bound "
          f"{bd['bound_ms']:.6f} ms ({bd['bound_by']})")
    row = dict(max_abs_err=err, ms=ms, plain_ms=plain, **bd)
    if card_key:
        card_time(jobs, card_key, row, "card_ms", run, ["local_assemble"],
                  per_call=1)
    return row


def check_k7b(sm, cfg3, jobs=None):
    """K7b against ``assemble_local_ref`` (f32, on the card) on a real
    local selection (the newest factor fresh) and past the old kernel's
    limit (:data:`K7B_PAST`, seeded rows): h_ii and b_i within rtol 1e-5
    of their max, bit-identical on a second launch."""
    args, sel = k7b_args(sm, cfg3)
    require(bool(sel["ok"]), "K7b: the selection does not fit")
    row = k7b_case(f"({int(sel['in_set'].sum())} interior poses)", args,
                   jobs, "K7b local_assemble")
    row["past_8k"] = k7b_case("past the old limit",
                              k7b_random_args(args[1].device, **K7B_PAST),
                              jobs, "K7b local_assemble K=8192")
    return row


#: The plain versions the smoother must not reach with CUDA tensors.
PLAIN_SMOOTHER = (("ndtpu_torch.graph.factors", "factor_linearize_ref"),
                  ("ndtpu_torch.graph.solve", "pcg_solve_ref"),
                  ("ndtpu_torch.graph.incremental", "local_select_ref"),
                  ("ndtpu_torch.graph.incremental", "fresh_residual_max_ref"),
                  ("ndtpu_torch.dist.schur", "assemble_local_ref"))
#: ... and every plain twin the stacked serving path could reach.
PLAIN_SERVING = PLAIN_SMOOTHER + (
    ("ndtpu_torch.graph.solve", "pcg_solve_blocked_ref"),
    ("ndtpu_torch.ndt.grid", "halfcell_add_ref"),
    ("ndtpu_torch.ndt.grid", "halfcell_add_stacked_ref"),
    ("ndtpu_torch.ndt.grid", "finalize_pack_ref"),
    ("ndtpu_torch.ndt.grid", "finalize_pack_stacked_ref"),
    ("ndtpu_torch.ndt.match", "lm_ndt_ref"),
    ("ndtpu_torch.loop.closure", "write_local_tables_ref"),
    ("ndtpu_torch.loop.closure", "loop_lanes_ref"),
    ("ndtpu_torch.data.synth", "raycast_ref"),
    ("ndtpu_torch.slam.appends", "window_append_ref"),
    ("ndtpu_torch.slam.appends", "loop_append_ref"),
    ("ndtpu_torch.slam.appends", "set_rows_ref"),
    ("ndtpu_torch.slam.pipeline", "refresh_points_ref"),
    ("ndtpu_torch.graph.incremental", "fresh_residual_max_stacked_ref"))
#: ... and every plain version config 5's merge and in-process solves could
#: reach.
PLAIN_CONFIG5 = PLAIN_SERVING + (
    ("ndtpu_torch.ndt.match", "score_grad_hess_batch_ref"),
    ("ndtpu_torch.dist.schur", "schur_local_assemble_ref"),
    ("ndtpu_torch.graph.supernodal", "supernodal_assemble_ref"),
    ("ndtpu_torch.graph.supernodal", "schur_reduce_ref"))


@contextlib.contextmanager
def no_plain_on_card(plain=PLAIN_SMOOTHER):
    """While open, a plain version in ``plain`` (module, name) called on
    CUDA tensors raises."""
    import importlib

    import torch

    def on_card(x):
        if isinstance(x, torch.Tensor):
            return x.is_cuda
        return isinstance(x, tuple) and any(on_card(y) for y in x)

    saved = []
    for mod_name, name in plain:
        mod = importlib.import_module(mod_name)
        fn = getattr(mod, name)
        saved.append((mod, name, fn))

        def refuse(*a, _fn=fn, _name=name, **k):
            if any(on_card(x) for x in a):
                raise SmokeFailure(f"{_name} ran on CUDA tensors")
            return _fn(*a, **k)
        setattr(mod, name, refuse)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


#: The routes an update is compared over: (name, device, float type).
ROUTES = (("kernel", "cuda", "float32"), ("f32", "cpu", "float32"),
          ("f64", "cpu", "float64"))
#: name: (solver overrides, state edits) of each take the smoke drives.
TAKE_CASES = {
    "local": ({}, ()),
    "global": (dict(local_poses=0), ()),
    "settled_check": (dict(relin_threshold=1e-6), ("settled",)),
    "full_solve": ({}, ("step",)),
}


def check_incremental_takes(sm, cfg3):
    """``incremental_update`` through the kernels (no plain version
    reached) against the plain route in f32 and f64 (CPU) on one state, for
    the local take, the global take, the settled check and the periodic
    full solve: take codes equal, poses within 2 x the f32 plain route's
    error against f64 + 1e-6 x max|pose|. Then ``local_update`` with a K7a
    probe under ``set_sync_debug_mode("error")``. Returns the takes."""
    import dataclasses

    import torch

    from ndtpu_torch.graph import incremental as inc

    cfg, huber = cfg3.solver, cfg3.solver.huber_delta
    since = sm.graph.n_between - 1
    lines, takes_seen = [], {}
    for name, (over, edits) in TAKE_CASES.items():
        c = dataclasses.replace(cfg, **over)
        s = sm
        if "settled" in edits:
            s = s._replace(last_max_delta=torch.zeros_like(s.last_max_delta))
        if "step" in edits:
            s = s._replace(step=torch.full_like(s.step,
                                                c.full_solve_every - 1))
        res = {}
        for route, dev, dt in ROUTES:
            dt = getattr(torch, dt)
            st = inc.SmootherState(graph_on(s.graph, dev, dt),
                                   s.lam.to(dev, dt),
                                   s.last_max_delta.to(dev, dt),
                                   s.step.to(dev))
            if route == "kernel":
                with no_plain_on_card():
                    out, take = inc.incremental_update(
                        st, c, huber_delta=huber, fresh_since=since,
                        return_take=True)
                torch.cuda.synchronize()
            else:
                out, take = inc.incremental_update(
                    st, c, huber_delta=huber, fresh_since=since.cpu(),
                    return_take=True)
            res[route] = (out.graph.poses.cpu().double(), int(take))
        takes = {k: v[1] for k, v in res.items()}
        require(len(set(takes.values())) == 1,
                f"incremental {name}: take codes differ: {takes}")
        p64, pk = res["f64"][0], res["kernel"][0]
        ek = float((pk - p64).abs().max())
        ep = float((res["f32"][0] - p64).abs().max())
        pmax = float(p64.abs().max())
        require(bool(torch.isfinite(pk).all()),
                f"incremental {name}: poses not finite")
        require(ek <= 2.0 * ep + 1e-6 * pmax,
                f"incremental {name}: poses {ek:.3e} off f64, over 2 x the "
                f"f32 plain route's {ep:.3e} + 1e-6 x {pmax:.3e}")
        takes_seen[name] = takes["kernel"]
        lines.append(f"{name} take {takes['kernel']}: {ek:.3e} (f32 plain "
                     f"{ep:.3e})")
    sel = inc.local_select(sm.graph, cfg, since)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        inc.local_update(sm.graph, sm.lam, cfg, huber, since, probe=sel)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    print("[smoke] incremental_update through the kernels (no plain "
          "version reached) vs the f32 and f64 plain routes, max abs pose "
          "err vs f64: " + "; ".join(lines) + "; local_update with a K7a "
          "probe: no host sync")
    return takes_seen


def config4_graph(device, dtype, seed: int, n_poses: int):
    """``solve_g2o --manhattan n_poses --seed seed``'s graph, a prior on
    pose 0."""
    from ndtpu_torch.data import g2o
    from ndtpu_torch.solve_g2o import manhattan_data

    return g2o.to_graph(manhattan_data(n_poses, seed), dtype=dtype,
                        device=device)


def config4_case(dev, seed: int, n_poses: int = CONFIG4["n_poses"],
                 shards: int = CONFIG4["shards"]):
    """The config-4 graph on the card (f32) and on the CPU (f64), its plan,
    K5's linearization on the card and the plain one in f64."""
    import torch

    from ndtpu_torch.graph import factors as fct
    from ndtpu_torch.graph import supernodal as sn

    g = config4_graph(dev, torch.float32, seed, n_poses)
    g64 = config4_graph("cpu", torch.float64, seed, n_poses)
    t0 = time.perf_counter()
    plan = sn.plan_supernodal(g, shards)
    plan_s = time.perf_counter() - t0
    return dict(g=g, g64=g64, plan=plan, plan_s=plan_s, lin=fct.linearize(g),
                lin64=fct.linearize(g64), lam=CONFIG4["lam"])


def _cpu64(ts):
    return [t.cpu().double() for t in ts]


def check_k5_config4(c4):
    """K5 at config 4's F = 10,305 rows (41 row blocks and the one-warp
    finish) against its f32 plain version at rtol 1e-5, chi^2 too, and
    bit-identical on a second launch."""
    import torch

    from ndtpu_torch.graph import factors as fct

    g = c4["g"]
    args = fct._graph_args(g)
    again = fct.linearize(g)
    ref = fct.factor_linearize_ref(*args)
    chi, chi_again = fct.chi2(g), fct.chi2(g)
    chi_ref = torch.sum(ref[0][2] ** 2) + torch.sum(ref[1][1] ** 2)
    torch.cuda.synchronize()
    require(bits_equal(_flat(c4["lin"]), _flat(again)),
            "K5 config 4: two launches differ")
    require(bits_equal(chi, chi_again), "K5 config 4 chi2: two launches "
            "differ")
    err = _rel_check("K5 config 4", _flat(c4["lin"]), _flat(ref))
    _rel_check("K5 config 4 chi2", [chi[None]], [chi_ref[None]])
    ms = time_ms(lambda: fct.linearize(g))
    plain = time_ms(lambda: fct.factor_linearize_ref(*args))
    f, p = g.bet_i.shape[0], g.prior_idx.shape[0]
    bd = bound(f * 85 + f * 88 + p * 109 + 16, f * K5_ROW_FLOPS + p * 30)
    print(f"[smoke] K5 factor_linearize config 4 F={f}: vs f32 plain max abs "
          f"err {err:.3e} (rtol 1e-5 of each array's max), chi2 "
          f"{float(chi):.6e} vs {float(chi_ref):.6e}; bit-identical on a "
          f"second launch; kernel {ms:.4f} ms, plain {plain:.4f} ms, bound "
          f"{bd['bound_ms']:.6f} ms ({bd['bound_by']})")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain, **bd)


#: K5r's cases: the robust threshold (whitened units; about the median
#: residual norm of config 4's 10k graph, 5.45, which reach ~1,650, so
#: every kind weighs inliers and outliers alike) and the IRLS chain's
#: bounds on the largest pose error (tests/test_robust.py).
K5R_DELTA = 5.0
IRLS_BOUND = {"cauchy": 0.2, "tukey": 0.1, "geman": 0.1}


def check_k5r(c4):
    """K5 with each robust kind (K5r) on config 4's 10k graph at
    ``K5R_DELTA``: against its f32 plain version on the card, each array
    and chi^2 within rtol 1e-5 of its max; against its f64 plain version on
    the CPU, each array and chi^2 within 2 x the f32 plain version's own
    error against f64 + 1e-6 x its max (rtol 1e-5 against f64 is past f32's
    reach here: the f32 plain version itself is up to 2e-5 of the max off
    f64 for tukey, whose weight 1 - u^2 cancels near u = 1); bit-identical
    on a second launch. Returns the kinds' rows, and the IRLS chain's
    (:func:`check_irls_chain`)."""
    import torch

    from ndtpu_torch.graph import factors as fct

    g = c4["g"]
    args = fct._graph_args(g)
    args64 = fct._graph_args(graph_on(g, "cpu", torch.float64))
    rows = {}
    for kind in ("huber", "cauchy", "tukey", "geman"):
        run = lambda: fct.linearize(g, K5R_DELTA, kind)
        out, again = run(), run()
        chi, chi_again = fct.chi2(g, K5R_DELTA, kind), fct.chi2(
            g, K5R_DELTA, kind)
        ref = fct.factor_linearize_ref(*args, K5R_DELTA, kind)
        ref64 = fct.factor_linearize_ref(*args64, K5R_DELTA, kind)
        torch.cuda.synchronize()
        require(bits_equal(_flat(out), _flat(again))
                and bits_equal(chi, chi_again),
                f"K5r {kind}: two launches differ")
        chi_ref = torch.sum(ref[0][2] ** 2) + torch.sum(ref[1][1] ** 2)
        chi_64 = torch.sum(ref64[0][2] ** 2) + torch.sum(ref64[1][1] ** 2)
        err = _rel_check(f"K5r {kind}", _flat(out) + [chi[None]],
                         _flat(ref) + [chi_ref[None]])
        err64 = 0.0
        for k, (o, r, r64) in enumerate(zip(
                _cpu64(_flat(out) + [chi[None]]),
                _cpu64(_flat(ref) + [chi_ref[None]]),
                _flat(ref64) + [chi_64[None]])):
            ek = float((o - r64).abs().max())
            ep = float((r - r64).abs().max())
            scale = float(r64.abs().max())
            require(ek <= 2.0 * ep + 1e-6 * scale,
                    f"K5r {kind}: output {k} {ek:.3e} off f64, over 2 x the "
                    f"f32 plain version's {ep:.3e} + 1e-6 x {scale:.3e}")
            err64 = max(err64, ek)
        ms = time_ms(run)
        plain = time_ms(lambda: fct.factor_linearize_ref(*args, K5R_DELTA,
                                                         kind))
        rows[kind] = dict(max_abs_err=err, max_abs_err_vs_f64=err64, ms=ms,
                          plain_ms=plain, chi2=float(chi))
        print(f"[smoke] K5r factor_linearize {kind} (delta {K5R_DELTA:g}) "
              f"on the 10k graph: vs f32 plain max abs err {err:.3e} (rtol "
              f"1e-5 of each array's max), vs f64 {err64:.3e} (within 2 x "
              f"the f32 plain version's), chi2 {float(chi):.6e} vs f64 "
              f"{float(chi_64):.6e}; bit-identical on a second launch; "
              f"kernel {ms:.4f} ms, plain {plain:.4f} ms")
    rows["irls"] = check_irls_chain(g.poses.device)
    return rows


def irls_chain(device, dtype):
    """tests/test_robust.py's chain: 24 poses 1 m apart with noise, a prior
    on pose 0, odometry factors and one wildly wrong loop factor (0 ->
    23). Returns ``(graph, ground truth [24, 3])``."""
    import numpy as np
    import torch

    from ndtpu_torch.graph import factors as fct
    from ndtpu_torch.lie import se2

    n = 24
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    sq = t(np.diag([10.0, 10.0, 20.0]))
    gt = np.zeros((n, 3))
    for k in range(1, n):
        gt[k] = gt[k - 1] + [1.0, 0.0, 0.0]
    noisy = gt + np.random.default_rng(0).normal(0, 0.02, gt.shape)
    noisy[0] = 0.0
    g = fct.empty_graph(n, 2, 2 * n, dtype, device)
    g = g._replace(poses=t(noisy),
                   pose_mask=torch.ones(n, dtype=torch.bool, device=device),
                   n_poses=torch.full((), n, dtype=torch.long,
                                      device=device))
    g = fct.add_prior(g, 0, t(np.zeros(3)), sq)
    for k in range(1, n):
        g = fct.add_between(g, k - 1, k, se2.between(t(gt[k - 1]), t(gt[k])),
                            sq)
    g = fct.add_between(g, 0, n - 1, t([2.0, 5.0, 1.5]), sq)
    return g, gt


def check_irls_chain(device):
    """tests/test_robust.py's IRLS (30 damped Gauss-Newton steps of the
    robustly weighted chain at delta 1, dense solve) on the card, K5r
    linearizing, per redescending kind: the largest pose error within the
    test's bound (0.2 m cauchy, 0.1 m tukey and geman), and beside it the
    f64 plain run's."""
    import torch

    from ndtpu_torch.graph import factors as fct
    from ndtpu_torch.graph import solve as slv

    out = {}
    for kind, lim in IRLS_BOUND.items():
        errs = []
        for dev, dt in ((device, torch.float32), ("cpu", torch.float64)):
            graph, gt = irls_chain(dev, dt)
            for _ in range(30):
                d = slv.solve_dense(graph, fct.linearize(graph, 1.0, kind),
                                    1e-6)
                graph = graph._replace(poses=slv._apply_delta(
                    graph.poses, d, graph.pose_mask))
            errs.append(float((graph.poses[:, :2].cpu().double()
                               - torch.as_tensor(gt[:, :2])).abs().max()))
        require(errs[0] < lim, f"K5r IRLS {kind}: largest pose error "
                f"{errs[0]:.4f} m, over {lim} m")
        out[kind] = dict(err_m=errs[0], f64_plain_err_m=errs[1], bound_m=lim)
    print("[smoke] K5r IRLS chain with a false loop on the card: largest "
          "pose error " + ", ".join(f"{k} {v['err_m']:.4f} m (f64 plain "
                                    f"{v['f64_plain_err_m']:.4f}; bound "
                                    f"{v['bound_m']})"
                                    for k, v in out.items()))
    return out


def k9a_bound(plan, lin) -> dict:
    """Bytes: K5's blocks and the routing tables read once, the five
    targets written; operations: 54 per routed 3x3 pair (A^T B and its
    add), 18 per routed A^T r."""
    t = plan.routes.host
    (ai, _, _), (ap, _) = lin
    sp = plan.schur
    p, ni, nsl, ns = sp.fac_idx.shape[0], sp.ni, plan.ns_loc, sp.ns
    out = 9 * p * ni * (ni + nsl) + 9 * ns * ns + 3 * (p * ni + ns)
    tables = sum(t[k].size for k in ("row_ptr", "tgt_col", "tgt_ptr", "code",
                                     "vec_ptr", "vcode"))
    return bound(ai.shape[0] * 84 + ap.shape[0] * 48 + tables * 4 + out * 4,
                 54.0 * t["code"].size + 18.0 * t["vcode"].size)


def check_k9a(c4, jobs=None):
    """K9a against ``supernodal_assemble_ref`` in f32 on the card and in
    f64 on the CPU, each target within rtol 1e-5 of its max |.|;
    bit-identical on a second launch. Returns the row and the outputs."""
    import torch

    from ndtpu_torch.graph import supernodal as sn

    plan, lin = c4["plan"], c4["lin"]
    run = lambda: sn.supernodal_assemble(plan, *_flat(lin))
    out, again = run(), run()
    model = sn.supernodal_assemble_model(plan, *_flat(lin))
    ref = sn.supernodal_assemble_ref(plan, *_flat(lin))
    ref64 = sn.supernodal_assemble_ref(plan, *_cpu64(_flat(lin)))
    torch.cuda.synchronize()
    require(bits_equal(out, again), "K9a: two launches differ")
    require(bits_equal(out, model), "K9a: differs from the plain model of "
            "its sum order (supernodal_assemble_model)")
    del model
    err = _rel_check("K9a vs f32 plain", out, ref)
    err64 = _rel_check("K9a vs f64 plain", _cpu64(out), ref64)
    ms = time_ms(run)
    plain = time_ms(lambda: sn.supernodal_assemble_ref(plan,
                                                       *_flat(lin)))
    lib_fn = k9a_library_call(plan, lin)
    lib = time_ms(lib_fn)
    bd = k9a_bound(plan, lin)
    sp = plan.schur
    t = plan.routes.host
    print(f"[smoke] K9a supernodal_assemble P={sp.fac_idx.shape[0]} "
          f"ni={sp.ni} ns={sp.ns} ns_loc={plan.ns_loc} "
          f"({t['tgt_col'].size} target blocks, {t['code'].size} pairs): vs "
          f"f32 plain max abs err {err:.3e}, vs f64 plain {err64:.3e} (rtol "
          f"1e-5 of each target's max); bit-equal to the plain model of its "
          f"sum order and on a second launch; "
          f"kernel {ms:.4f} ms, plain {plain:.4f} ms, library (index_add_ "
          f"of the routed blocks into the zeroed targets) {lib:.4f} ms, "
          f"bound {bd['bound_ms']:.6f} ms ({bd['bound_by']})")
    row = dict(max_abs_err=err, max_abs_err_f64=err64, ms=ms, plain_ms=plain,
               **bd)
    row.update(library_ms=lib, library="torch.Tensor.index_add_ of the "
               "routed 3x3 blocks (A^T B made beforehand) into the zeroed "
               "h_ii, h_is and h_ss (flat): the same sums, without b_i, b_s")
    card_time(jobs, "K9a supernodal_assemble", row, "card_ms", run,
              ["supernodal_assemble"], per_call=1)
    card_time(jobs, "K9a library call", row, "library_card_ms", lib_fn)
    return row, out


def k9a_library_call(plan, lin):
    """One ``index_add_`` computing K9a's three matrices: every routed
    pair's ``A^T B`` (made beforehand, as the plain version makes them) into
    the zeroed, flat ``h_ii``, ``h_is`` and ``h_ss`` by the plain version's
    flat ids; K9a's yardstick (``library_ms``), not on any path."""
    import torch

    from ndtpu_torch.dist import schur
    from ndtpu_torch.graph import supernodal as sn

    t = sn.tables_on(plan, lin[0][0].device)
    sp = plan.schur
    ni, ns, nsl = sp.ni, sp.ns, plan.ns_loc
    p_dim, fmax = sp.fac_idx.shape
    (ai, aj, r), (ap, rp) = lin
    flat = lambda x: x.reshape(-1)
    (ra, la, rb, lb, vals, valid), _ = schur._local_blocks(
        ai[t.fac_idx].reshape(-1, 3, 3), aj[t.fac_idx].reshape(-1, 3, 3),
        r[t.fac_idx].reshape(-1, 3), ap[t.pri_idx].reshape(-1, 3, 3),
        rp[t.pri_idx].reshape(-1, 3), flat(t.fac_mask), flat(t.i_role),
        flat(t.i_loc), flat(t.j_role), flat(t.j_loc), flat(t.pri_mask),
        flat(t.p_role), flat(t.p_loc))
    shard = torch.arange(p_dim, device=ai.device)
    sh_f = flat(shard[:, None].expand(p_dim, fmax))
    sh_q = flat(shard[:, None].expand_as(t.pri_idx))
    shards = torch.cat([sh_f, sh_f, sh_f, sh_f, sh_q])
    lb_l = torch.cat([flat(x) for x in (t.i_loc_l, t.j_loc_l, t.i_loc_l,
                                        t.j_loc_l, t.p_loc_l)])
    irow = shards * ni + la
    n_ii, n_is = p_dim * ni * ni * 9, p_dim * ni * nsl * 9
    n_ss = ns * ns * 9
    ids = torch.cat([
        schur._block_ids(irow, lb, ni, (ra == 0) & (rb == 0) & valid),
        schur._block_ids(irow, lb_l, nsl, (ra == 0) & (rb == 1) & valid)
        + n_ii,
        schur._block_ids(la, lb, ns, (ra == 1) & (rb == 1) & valid)
        + n_ii + n_is])
    vv = torch.cat([vals, vals, vals])
    keep = ids < n_ii + n_is + n_ss
    ids, vv = ids[keep], vv[keep]
    return lambda: torch.zeros(n_ii + n_is + n_ss,
                               device=vv.device).index_add_(0, ids, vv)


def k9b_bound(plan) -> dict:
    """Bytes: the held part entries (a shard's parts are read only where
    it holds both the row's and the column's separator, ``(3 m_p)^2 + 3
    m_p`` of them for a shard holding ``m_p``), ``h_ss``, ``b_s`` and the
    routing tables read once, ``s_tot`` and ``rhs_tot`` written;
    operations: one add per held part entry, the subtraction per output
    entry, 3 for each diagonal's damping."""
    t = plan.routes.host
    ns3 = 3 * plan.schur.ns
    routed = sum((3 * int(m.sum())) ** 2 + 3 * int(m.sum())
                 for m in plan.ls_mask)
    tables = sum(t[k].size for k in ("hold_ptr", "hold_shard", "hold_loc",
                                     "loc_of")) * 4 + plan.schur.ns
    return bound(4 * (routed + 2 * (ns3 * ns3 + ns3)) + tables,
                 routed + ns3 * ns3 + ns3 + 3 * ns3)


def check_k9b(c4, k9a_out, jobs=None):
    """K9b against ``schur_reduce_ref`` in f32 on the card and in f64 on
    the CPU (inputs from the card's K9a and interior elimination), each
    output within rtol 1e-5 of its max |.|; bit-identical on a second
    launch; ``index_add_`` of the routed parts into a copy of ``h_ss``
    (the same sum, without the damping) timed beside it."""
    import torch

    from ndtpu_torch.graph import supernodal as sn

    plan, lam = c4["plan"], c4["lam"]
    h_ii, h_is, h_ss, b_i, b_s = (x.clone() for x in k9a_out)
    _, _, s_part, rhs_part = sn.interior_parts(plan, h_ii, h_is, b_i, lam)
    args = (s_part, rhs_part, h_ss, b_s, lam)
    run = lambda: sn.schur_reduce(plan, *args)
    out, again = run(), run()
    model = sn.schur_reduce_model(plan, *args)
    ref = sn.schur_reduce_ref(plan, *args)
    ref64 = sn.schur_reduce_ref(plan, *_cpu64(args[:4]), lam)
    torch.cuda.synchronize()
    require(bool(torch.isfinite(s_part).all()), "K9b: Schur parts not finite")
    require(bits_equal(out, again), "K9b: two launches differ")
    require(bits_equal(out, model), "K9b: differs from the plain model of "
            "its sum order (schur_reduce_model)")
    err = _rel_check("K9b vs f32 plain", out, ref)
    err64 = _rel_check("K9b vs f64 plain", _cpu64(out), ref64)
    ms = time_ms(run)
    plain = time_ms(lambda: sn.schur_reduce_ref(plan, *args))
    t = sn.tables_on(plan, s_part.device)
    ns3 = h_ss.shape[0]
    pair = torch.where(t.gvalid[:, :, None] & t.gvalid[:, None, :],
                       t.gidx[:, :, None] * ns3 + t.gidx[:, None, :],
                       torch.zeros_like(t.gidx[:, :, None])).reshape(-1)
    keep = (t.gvalid[:, :, None] & t.gvalid[:, None, :]).reshape(-1)
    idx, src = pair[keep], s_part.reshape(-1)[keep]
    flat = h_ss.reshape(-1)
    lib_fn = lambda: flat.clone().index_add_(0, idx, src, alpha=-1.0)
    lib = time_ms(lib_fn)
    bd = k9b_bound(plan)
    print(f"[smoke] K9b schur_reduce ns={plan.schur.ns} "
          f"ns_loc={plan.ns_loc}: vs f32 plain max abs err {err:.3e}, vs f64 "
          f"plain {err64:.3e} (rtol 1e-5 of each output's max); bit-equal "
          f"to the plain model of its sum order and on a second launch; "
          f"kernel {ms:.4f} ms, plain "
          f"{plain:.4f} ms, library (index_add_ of the routed parts into a "
          f"copy of h_ss, no damping) {lib:.4f} ms, bound "
          f"{bd['bound_ms']:.6f} ms ({bd['bound_by']})")
    row = dict(max_abs_err=err, max_abs_err_f64=err64, ms=ms, plain_ms=plain,
               **bd)
    row.update(library_ms=lib, library="torch.Tensor.index_add_(alpha=-1) "
               "of the routed Schur parts into a copy of h_ss: the same sum "
               "without the damping")
    card_time(jobs, "K9b schur_reduce", row, "card_ms", run,
              ["schur_reduce"], per_call=1)
    card_time(jobs, "K9b library call", row, "library_card_ms", lib_fn)
    return row


def check_supernodal_step(c4):
    """One ``supernodal_delta`` on the card (K5's linearization, K9a, the
    library factorizations, K9b) against the f64 plain route on the CPU:
    its max error within 2 x the f32 plain route's (CPU) own error against
    f64 + 1e-6 x max|delta|."""
    import torch

    from ndtpu_torch.graph import factors as fct
    from ndtpu_torch.graph import supernodal as sn

    plan, lam = c4["plan"], c4["lam"]
    g32 = graph_on(c4["g64"], "cpu", torch.float32)
    d_card = sn.supernodal_delta(c4["g"], c4["lin"], plan, lam)
    d32 = sn.supernodal_delta(g32, fct.linearize(g32), plan, lam)
    d64 = sn.supernodal_delta(c4["g64"], c4["lin64"], plan, lam)
    torch.cuda.synchronize()
    require(bool(torch.isfinite(d_card).all()), "supernodal step: not finite")
    ek = float((d_card.cpu().double() - d64).abs().max())
    ep = float((d32.double() - d64).abs().max())
    dmax = float(d64.abs().max())
    require(ek <= 2.0 * ep + 1e-6 * dmax,
            f"supernodal step: {ek:.3e} off f64, over 2 x the f32 plain "
            f"route's {ep:.3e} + 1e-6 x {dmax:.3e}")
    print(f"[smoke] supernodal_delta on the card vs the f64 plain route: "
          f"max abs err {ek:.3e} (f32 plain route {ep:.3e}; max|delta| "
          f"{dmax:.3e}; plan {c4['plan_s']:.2f} s on the host)")
    return dict(max_abs_err=ek, plain_f32_err_vs_f64=ep, max_delta=dmax)


def ba_step_timing(c4, card, jobs):
    """bench.py's BA protocol at 10k poses: one step (K5 linearize +
    ``supernodal_delta``), a warm-up, then the median of 10 calls, each
    fenced by a host read. Queues the step's card-time split (K5, K9a, the
    batched interior Cholesky and solves, K9b, the separator solve, the
    rest) for after the event-timed phases."""
    import torch

    from ndtpu_torch.graph import factors as fct
    from ndtpu_torch.graph import supernodal as sn

    g, plan, lam = c4["g"], c4["plan"], c4["lam"]
    step = lambda: sn.supernodal_delta(g, fct.linearize(g), plan, lam)
    step()[0].cpu()
    ts = []
    for _ in range(10):
        t0 = time.perf_counter()
        out = step()
        out[0].cpu()                       # host read: a real fence
        ts.append(time.perf_counter() - t0)
    ms = statistics.median(ts) * 1e3
    print(f"[smoke] ba_solve_ms_per_iter_10k {ms:.3f} ms ({card}; median of "
          f"10 steps, each fenced by a host read; spread "
          f"{min(ts) * 1e3:.3f}-{max(ts) * 1e3:.3f} ms)")
    lin = fct.linearize(g)
    h_ii, h_is, h_ss, b_i, b_s = sn.supernodal_assemble(plan, *_flat(lin))
    # interior_parts damps h_ii in place: each timed call damps it again,
    # which keeps it definite and changes no shape or time.
    parts = sn.interior_parts(plan, h_ii, h_is, b_i, lam)
    s_tot, rhs_tot = sn.schur_reduce(plan, parts[2], parts[3], h_ss, b_s, lam)
    split = dict(ms_per_iter=ms, times_ms=[t * 1e3 for t in ts])
    stages = [
        ("step", step, None),
        ("K5 factor_linearize", lambda: fct.linearize(g), ["linearize_"]),
        ("K9a supernodal_assemble",
         lambda: sn.supernodal_assemble(plan, *_flat(lin)),
         ["supernodal_assemble"]),
        ("interior Cholesky and solves",
         lambda: sn.interior_parts(plan, h_ii, h_is, b_i, lam), None),
        ("K9b schur_reduce",
         lambda: sn.schur_reduce(plan, parts[2], parts[3], h_ss, b_s, lam),
         ["schur_reduce"]),
        ("separator solve", lambda: sn.separator_solve(s_tot, rhs_tot), None),
    ]
    for label, fn, names in stages:
        card_time(jobs, f"config-4 step: {label}", split, label, fn, names)
    return split


#: The config-4 step's card-time split, in the order it runs.
SPLIT = ("K5 factor_linearize", "K9a supernodal_assemble",
         "interior Cholesky and solves", "K9b schur_reduce",
         "separator solve")


def finish_split(split):
    """The step's card time less its timed stages is the rest (K5's chi^2
    is not in a step; the rest is the back substitution and the small
    torch ops)."""
    known = [split.get(k) for k in ("step",) + SPLIT]
    split["rest"] = (None if None in known
                     else known[0] - sum(known[1:]))
    print("[smoke] config-4 step card time (torch.profiler, mean of 20): "
          + ", ".join(f"{k} {_fmt(split[k])}"
                      for k in ("step",) + SPLIT + ("rest",)))


def _counting(module, name):
    """Replace ``module.name`` by a wrapper that counts its calls; returns
    ``(counts, restore)``, ``counts["n"]`` the calls so far."""
    saved = getattr(module, name)
    counts = {"n": 0}

    def counted(*a, **k):
        counts["n"] += 1
        return saved(*a, **k)

    setattr(module, name, counted)
    return counts, lambda: setattr(module, name, saved)


def run_config4(dev, card):
    """Config 4 through its entry point: ``ndtpu_torch.solve_g2o.main
    (["--manhattan", "10000", "--shards", "64"])`` on the card, with every
    launch counter reset just before and read just after, and the LM
    iterations counted (``supernodal_delta`` calls). Requires one K9a and
    one K9b launch per iteration, K5 launched, chi^2 falling and the final
    chi^2 within 1.02 x the JAX package's f32 final chi^2 on the same graph
    (``tests/data/torch_config4_manhattan10k_ref.json``)."""
    import numpy as np

    from ndtpu_torch import kernels, solve_g2o
    from ndtpu_torch.graph import supernodal as sn

    ref = json.loads(REF4_FILE.read_text())
    counts, restore = _counting(sn, "supernodal_delta")
    try:
        kernels.reset_launches()
        res = solve_g2o.main(["--manhattan", str(CONFIG4["n_poses"]),
                              "--shards", str(CONFIG4["shards"])])
        launches = dict(kernels.LAUNCHES)
    finally:
        restore()
    steps = counts["n"]
    require(res["method"] == "supernodal",
            f"config 4: method {res['method']}, not supernodal")
    require(np.isfinite(res["poses"]).all(), "config 4: poses not finite")
    require(steps == res["n_iter"] > 0
            and launches["supernodal_assemble"] == steps
            and launches["schur_reduce"] == steps,
            f"config 4: {launches['supernodal_assemble']} K9a and "
            f"{launches['schur_reduce']} K9b launches for {steps} steps "
            f"({res['n_iter']} iterations; one each expected)")
    require(launches["factor_linearize"] > 0, "config 4: K5 not launched")
    chi0, chi1 = res["chi2_initial"], res["chi2_final"]
    j32, j64 = ref["jax_f32"]["chi2_final"], ref["jax_f64"]["chi2_final"]
    require(chi1 < chi0, f"config 4: chi2 {chi0:.6e} -> {chi1:.6e} did not "
            f"fall")
    require(chi1 <= 1.02 * j32, f"config 4: final chi2 {chi1:.6e} over 1.02 "
            f"x the JAX package's f32 {j32:.6e}")
    print(f"[smoke] config 4 entry point (solve_g2o --manhattan "
          f"{CONFIG4['n_poses']} --shards {CONFIG4['shards']}, {card}): "
          f"chi2 {chi0:.6e} -> {chi1:.6e} in {res['n_iter']} iterations "
          f"(converged={res['converged']}), {res['seconds']:.3f} s; JAX f32 "
          f"{j32:.6e} in {ref['jax_f32']['n_iter']} iterations (ratio "
          f"{chi1 / j32:.6f}), JAX f64 {j64:.6e} in "
          f"{ref['jax_f64']['n_iter']} (ratio {chi1 / j64:.6f}); launches "
          f"{ {k: v for k, v in launches.items() if v} }")
    return launches, dict(n_iter=res["n_iter"], chi2_initial=chi0,
                          chi2_final=chi1, seconds=res["seconds"],
                          converged=res["converged"],
                          ratio_jax_f32=chi1 / j32, ratio_jax_f64=chi1 / j64)


def run_config4_pcg(dev, card):
    """Config 4 by PCG through its entry point: ``solve_g2o.main([
    "--manhattan", "10000", "--method", "pcg"])`` on the card, every launch
    counter reset just before and read just after, every plain version
    refusing CUDA tensors, and the LM iterations counted (``pcg`` calls).
    Requires method pcg, one K6g launch per ``pcg`` call and at least one
    call per executed iteration, no K6 launch, chi^2 falling and the final
    chi^2 within 1.02 x the JAX package's f32 ``--method pcg`` final chi^2
    on the same graph (``tests/data/torch_config4_pcg10k_ref.json``). Then
    ``--manhattan 25000`` with ``auto``: it must take pcg (K6g, one launch
    per ``pcg`` call), chi^2 must fall and the poses stay finite."""
    import numpy as np

    from ndtpu_torch import kernels, solve_g2o
    from ndtpu_torch.graph import solve as slv

    ref = json.loads(REF4_PCG_FILE.read_text())
    runs = {}
    for n, method in ((CONFIG4["n_poses"], "pcg"), (25000, "auto")):
        argv = ["--manhattan", str(n)] + (["--method", method]
                                          if method != "auto" else [])
        counts, restore = _counting(slv, "pcg")
        try:
            with no_plain_on_card():
                kernels.reset_launches()
                res = solve_g2o.main(argv)
                launches = dict(kernels.LAUNCHES)
        finally:
            restore()
        calls = counts["n"]
        chi0, chi1 = res["chi2_initial"], res["chi2_final"]
        require(res["method"] == "pcg",
                f"solve_g2o {argv}: method {res['method']}, not pcg")
        require(np.isfinite(res["poses"]).all(),
                f"solve_g2o {argv}: poses not finite")
        require(launches["pcg_solve_grid"] == calls >= res["n_iter"] > 0
                and launches["pcg_solve"] == 0
                and launches["factor_linearize"] > 0,
                f"solve_g2o {argv}: {launches['pcg_solve_grid']} K6g and "
                f"{launches['pcg_solve']} K6 launches for {calls} pcg calls "
                f"({res['n_iter']} iterations; one K6g launch per call, no "
                f"K6, K5 launched expected)")
        require(chi1 < chi0, f"solve_g2o {argv}: chi2 {chi0:.6e} -> "
                f"{chi1:.6e} did not fall")
        runs[n] = (launches, dict(method=res["method"], n_iter=res["n_iter"],
                                  pcg_calls=calls, chi2_initial=chi0,
                                  chi2_final=chi1, seconds=res["seconds"],
                                  converged=res["converged"]))
    launches, out = runs[CONFIG4["n_poses"]]
    j32, j64 = ref["jax_f32"]["chi2_final"], ref["jax_f64"]["chi2_final"]
    chi1 = out["chi2_final"]
    require(chi1 <= 1.02 * j32, f"config 4 by PCG: final chi2 {chi1:.6e} "
            f"over 1.02 x the JAX package's f32 {j32:.6e}")
    out.update(ratio_jax_f32=chi1 / j32, ratio_jax_f64=chi1 / j64,
               auto_25k=runs[25000][1])
    a = out["auto_25k"]
    print(f"[smoke] config 4 by PCG (solve_g2o --manhattan "
          f"{CONFIG4['n_poses']} --method pcg, {card}): chi2 "
          f"{out['chi2_initial']:.6e} -> {chi1:.6e} in {out['n_iter']} "
          f"iterations (converged={out['converged']}), {out['seconds']:.3f} "
          f"s; JAX f32 {j32:.6e} in {ref['jax_f32']['n_iter']} iterations "
          f"(ratio {chi1 / j32:.6f}), JAX f64 {j64:.6e} (ratio "
          f"{chi1 / j64:.6f}); launches "
          f"{ {k: v for k, v in launches.items() if v} }; --manhattan 25000 "
          f"auto: method {a['method']}, chi2 {a['chi2_initial']:.6e} -> "
          f"{a['chi2_final']:.6e} in {a['n_iter']} iterations, "
          f"{a['seconds']:.3f} s")
    return launches, out


#: bench.py §5's incremental-update protocol at 10k poses: the solver, the
#: damping, and the local cell's graph (10,064 pose slots, 64 more factor
#: slots, four new poses chained by odometry) and its chaining.
ICFG_10K = dict(inc_iters=2, pcg_max_iter=25, full_solve_every=0)
INC_10K = dict(lam=1e-3, slots=10064, extra_factors=64, new_poses=4,
               chain=8)


def _fenced_median_ms(fn, reps: int, fence):
    """bench.py's protocol: a warm-up, then the median of ``reps`` calls,
    each fenced by a host read (``fence(out)``). Returns ``(median, all)``
    in ms."""
    fence(fn())
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fence(fn())
        ts.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ts), ts


def local_graph(sg, slots: int = INC_10K["slots"],
                extra_factors: int = INC_10K["extra_factors"]):
    """bench.py §5b's graph: the graph ``sg`` (the settled 10k graph there)
    in a graph of ``slots`` pose slots (10,064 there) and F +
    ``extra_factors`` factor slots (64 there), then four new poses chained
    to the last by 1 m odometry (sqrt-info 10 I). Returns ``(graph,
    since)``, ``since`` the factor count before the new factors."""
    import torch

    from ndtpu_torch.graph import factors as fct
    from ndtpu_torch.lie import se2

    dev, dt = sg.poses.device, sg.poses.dtype
    f0 = sg.bet_mask.shape[0]
    big = fct.empty_graph(slots, 4, f0 + extra_factors, dt, dev)

    def put(dst, src):
        out = dst.clone()
        out[:src.shape[0]] = src
        return out

    big = big._replace(
        poses=put(big.poses, sg.poses), pose_mask=put(big.pose_mask,
                                                      sg.pose_mask),
        prior_idx=sg.prior_idx, prior_z=sg.prior_z,
        prior_sqrt_info=sg.prior_sqrt_info, prior_mask=sg.prior_mask,
        bet_i=put(big.bet_i, sg.bet_i), bet_j=put(big.bet_j, sg.bet_j),
        bet_z=put(big.bet_z, sg.bet_z),
        bet_sqrt_info=put(big.bet_sqrt_info, sg.bet_sqrt_info),
        bet_mask=put(big.bet_mask, sg.bet_mask), n_poses=sg.n_poses,
        n_priors=sg.n_priors, n_between=sg.n_between)
    since = big.n_between.clone()
    last = int(big.n_poses) - 1
    step = torch.tensor([1.0, 0.02, 0.01], dtype=dt, device=dev)
    odo = torch.tensor([1.0, 0.0, 0.0], dtype=dt, device=dev)
    sq = torch.eye(3, dtype=dt, device=dev) * 10.0
    for k in range(INC_10K["new_poses"]):
        idx = int(big.n_poses)
        big = fct.add_pose(big, se2.compose(big.poses[last + k], step))
        big = fct.add_between(big, last + k, idx, odo, sq)
    return big, since


def update_vs_plain(name, state, icfg, since=None):
    """One ``incremental_update`` through the kernels (no plain version
    reached; launches counted) against the plain route in f32 and f64 on
    the CPU from the same state: take codes equal, poses within 2 x the
    f32 plain route's error against f64 + 1e-6 x max|pose| (the kernels
    do the plain route's f32 arithmetic in other summation orders, so
    their distance from f64 is of the f32 route's size). Returns ``(take,
    launches, kernel error, f32 plain error)``."""
    import torch

    from ndtpu_torch import kernels
    from ndtpu_torch.graph import incremental as inc

    res = {}
    for route, dev, dt in ROUTES:
        dt = getattr(torch, dt)
        st = inc.SmootherState(graph_on(state.graph, dev, dt),
                               state.lam.to(dev, dt),
                               state.last_max_delta.to(dev, dt),
                               state.step.to(dev))
        sn = None if since is None else since.to(dev)
        if route == "kernel":
            with no_plain_on_card():
                kernels.reset_launches()
                out, take = inc.incremental_update(st, icfg, fresh_since=sn,
                                                   return_take=True)
                torch.cuda.synchronize()
                launches = dict(kernels.LAUNCHES)
        else:
            out, take = inc.incremental_update(st, icfg, fresh_since=sn,
                                               return_take=True)
        res[route] = (out.graph.poses.cpu().double(), int(take))
    takes = {k: v[1] for k, v in res.items()}
    require(len(set(takes.values())) == 1,
            f"{name}: take codes differ: {takes}")
    p64, pk = res["f64"][0], res["kernel"][0]
    ek = float((pk - p64).abs().max())
    ep = float((res["f32"][0] - p64).abs().max())
    pmax = float(p64.abs().max())
    require(bool(torch.isfinite(pk).all()), f"{name}: poses not finite")
    require(ek <= 2.0 * ep + 1e-6 * pmax,
            f"{name}: poses {ek:.3e} off f64, over 2 x the f32 plain "
            f"route's {ep:.3e} + 1e-6 x {pmax:.3e}")
    return takes["kernel"], launches, ek, ep


def run_incremental_10k(c4, card, seed: int):
    """bench.py §5 on the card under its own protocol (``ICFG_10K``, lam
    1e-3, medians of 10 host-fenced calls, the local path's of 6 chains of
    8, each call's poses jiggled by N(0, 1e-6) from ``seed``):
    ``incremental_update_ms_10k`` (the active step on bench.py §4's graph:
    the global take, K5 + K6g), ``incremental_settled_ms_10k`` (the graph
    settled by ``optimize(SolverConfig(max_iter=30, pcg_max_iter=250),
    method="pcg")`` on the card, last step 0) and
    ``incremental_local_ms_10k`` (§5b's 10,064-slot graph: ``local_update``
    chained x8 in a Python loop, per update). Per path: the take code (1
    active, 2 local, settled as the plain route decides), the kernels
    launched (K6g and no K6 for the active take; K7a and K7b and no PCG
    kernel for the local one), and one call's poses against the plain
    route (:func:`update_vs_plain`). Then ``marginal_covariance_pcg`` of
    pose 5,000 of the settled graph against its f64 plain version, rtol
    1e-3. Returns ``(the active take's launches, record)``."""
    import numpy as np
    import torch

    from ndtpu_torch.config import SolverConfig
    from ndtpu_torch.graph import incremental as inc
    from ndtpu_torch.graph import solve as slv

    icfg = SolverConfig(**ICFG_10K)
    g = c4["g"]
    dev = g.poses.device
    lam = torch.tensor(INC_10K["lam"], dtype=torch.float32, device=dev)
    rng = np.random.default_rng(seed + 5)
    state = lambda gr, last: inc.SmootherState(
        gr, lam, torch.tensor(last, dtype=torch.float32, device=dev),
        torch.zeros((), dtype=torch.long, device=dev))
    jiggle_graph = lambda gr: gr._replace(
        poses=gr.poses + float(rng.normal(0, 1e-6)))
    jiggle = lambda s: s._replace(graph=jiggle_graph(s.graph))
    fence = lambda out: out.graph.poses[0].cpu()
    rec = {}
    launches = {}
    # The active step: the global take on the §4 graph.
    st = state(g, float("inf"))
    take, launches["active"], ek, ep = update_vs_plain(
        "incremental active 10k", st, icfg)
    la = launches["active"]
    require(take == 1 and la["pcg_solve_grid"] == icfg.inc_iters
            and la["pcg_solve"] == 0,
            f"incremental active 10k: take {take}, {la['pcg_solve_grid']} "
            f"K6g and {la['pcg_solve']} K6 launches (take 1, one K6g per "
            f"LM step, no K6 expected)")
    ms, ts = _fenced_median_ms(
        lambda: inc.incremental_update(jiggle(st), icfg), 10, fence)
    rec["incremental_update_ms_10k"] = ms
    rec["active"] = dict(take=take, err_vs_f64=ek, plain_f32_err_vs_f64=ep,
                         times_ms=ts, launches=launches_nonzero(la))
    # The settled graph.
    t0 = time.perf_counter()
    sol = slv.optimize(g, SolverConfig(max_iter=30, pcg_max_iter=250),
                       method="pcg")
    sg = sol.graph
    settle_s = time.perf_counter() - t0
    st2 = state(sg, 0.0)
    take2, launches["settled"], ek2, ep2 = update_vs_plain(
        "incremental settled 10k", st2, icfg)
    ls = launches["settled"]
    require(ls["pcg_solve"] == 0, "incremental settled 10k: K6 launched")
    ms2, ts2 = _fenced_median_ms(
        lambda: inc.incremental_update(jiggle(st2), icfg), 10, fence)
    rec["incremental_settled_ms_10k"] = ms2
    rec["settled"] = dict(take=take2, err_vs_f64=ek2,
                          plain_f32_err_vs_f64=ep2, times_ms=ts2,
                          launches=launches_nonzero(ls), settle_s=settle_s,
                          settle_iters=int(sol.n_iter),
                          settle_chi2=float(sol.chi2))
    # The local update on §5b's graph.
    big, since = local_graph(sg)
    take3, launches["local"], ek3, ep3 = update_vs_plain(
        "incremental local 10k", state(big, float("inf")), icfg, since)
    ll = launches["local"]
    require(take3 == 2 and ll["local_select"] > 0 and ll["local_assemble"]
            > 0 and ll["pcg_solve"] == 0 and ll["pcg_solve_grid"] == 0,
            f"incremental local 10k: take {take3}, launches "
            f"{launches_nonzero(ll)} "
            f"(take 2 through K7a and K7b, no PCG kernel expected)")

    def chain():
        gg, ll_ = jiggle_graph(big), lam
        for _ in range(INC_10K["chain"]):
            gg, ll_, _ = inc.local_update(
                gg._replace(poses=gg.poses + 1e-9), ll_, icfg, since=since)
        return gg

    ms3, ts3 = _fenced_median_ms(chain, 6, lambda gg: gg.poses[0].cpu())
    rec["incremental_local_ms_10k"] = ms3 / INC_10K["chain"]
    rec["local"] = dict(take=take3, err_vs_f64=ek3, plain_f32_err_vs_f64=ep3,
                        chain_times_ms=ts3, launches=launches_nonzero(ll),
                        pose_slots=int(big.poses.shape[0]),
                        factor_slots=int(big.bet_i.shape[0]))
    rec["marginal_covariance_pcg"] = check_marginal_10k(sg)
    print(f"[smoke] bench.py §5 on the card ({card}; inc_iters 2, "
          f"pcg_max_iter 25, medians of 10 host-fenced calls): "
          f"incremental_update_ms_10k {ms:.3f} (take 1, poses {ek:.3e} off "
          f"f64, f32 plain {ep:.3e}; launches {rec['active']['launches']}), "
          f"incremental_settled_ms_10k {ms2:.3f} (take {take2}, graph settled "
          f"in {settle_s:.2f} s, {int(sol.n_iter)} iterations, chi2 "
          f"{float(sol.chi2):.6e}; launches {rec['settled']['launches']}), "
          f"incremental_local_ms_10k {rec['incremental_local_ms_10k']:.3f} "
          f"(take 2 on {big.poses.shape[0]} pose slots, poses {ek3:.3e} off "
          f"f64, f32 plain {ep3:.3e}; chained x{INC_10K['chain']}, median "
          f"of 6; launches {rec['local']['launches']})")
    return la, rec


#: Config 4's Manhattan graph at this many poses (phase 8b's ``auto``
#: run). Its local graph (:func:`local_graph`, 25,064 pose and 26,005
#: factor slots) was past the first K7a's shared memory (~253 KB of the
#: 227 KB one block can have); staged, it takes ~180 KB.
SELECT_PAST_POSES = 25000
#: Pose slots past K7a's shared route (65,535, ``kernels.select_route``):
#: the same 25,000 poses in a graph of 70,064 slots take the scratch route.
SELECT_SCRATCH_SLOTS = 70064
#: Factor slots beside 10,064 pose slots past K7a's staged layout
#: (``kernels.select_smem`` over the limit): the shared route reads the
#: endpoints from the graph.
SELECT_WIDE_FACTORS = 60000


def check_k7a_past_block(dev, seed: int, jobs=None):
    """K7a past the first design's shared memory, on
    :data:`SELECT_PAST_POSES` poses of config 4's Manhattan graph with four
    new poses chained to it (:func:`local_graph`), each case bit-equal to
    ``local_select_ref`` (on the card) with ``since`` = the new factors',
    none, and 40 factors back, and on a second launch (:func:`k7a_case`),
    and timed as the local path calls it: in 25,064 pose slots (the shared
    route, staged), in :data:`SELECT_SCRATCH_SLOTS` (the scratch route,
    ``local_select[scratch]``), and config 4's 10k graph in 10,064 pose
    slots and :data:`SELECT_WIDE_FACTORS` factor slots (the shared route
    with the endpoints read from the graph). Then the path on the first
    two: one ``incremental_update`` through the kernels (bench.py §5's
    solver, no plain version reached; launches counted from 0) against the
    f32 and f64 plain routes (:func:`update_vs_plain`: take 2, the local
    take, through K7a's route and K7b). Returns ``(the scratch update's
    launches, the scratch row, the shared row)``, the shared row holding
    the wide one under ``endpoints_in_graph``."""
    import torch

    from ndtpu_torch import kernels
    from ndtpu_torch.config import SolverConfig
    from ndtpu_torch.graph import incremental as inc

    icfg = SolverConfig(**ICFG_10K)
    sg = config4_graph(dev, torch.float32, seed, SELECT_PAST_POSES)
    cases = {"staged": (SELECT_PAST_POSES + 64, INC_10K["extra_factors"]),
             "scratch": (SELECT_SCRATCH_SLOTS, INC_10K["extra_factors"])}
    rows, launches = {}, {}
    for name, (slots, extra) in cases.items():
        g, since = local_graph(sg, slots, extra)
        v, f = g.poses.shape[0], g.bet_i.shape[0]
        want = "scratch" if name == "scratch" else "shared"
        require(kernels.select_route(v, f) == want
                and (name != "staged"
                     or kernels.select_smem(v, f) <= kernels.SMEM_MAX),
                f"K7a {name}: {v} poses, {f} factors route "
                f"{kernels.select_route(v, f)} ({kernels.select_smem(v, f)} "
                f"B staged)")
        row = k7a_case(f"{name} past the first design's block", g, icfg,
                       since, jobs)
        lam = torch.tensor(INC_10K["lam"], dtype=torch.float32, device=dev)
        st = inc.SmootherState(g, lam,
                               torch.tensor(float("inf"), device=dev),
                               torch.zeros((), dtype=torch.long, device=dev))
        take, la, ek, ep = update_vs_plain(
            f"incremental local {v} poses", st, icfg, since)
        counter = ("local_select[scratch]" if name == "scratch"
                   else "local_select")
        other = ({"local_select", "local_select[scratch]"} - {counter}).pop()
        require(take == 2 and la[counter] > 0 and la[other] == 0
                and la["local_assemble"] > 0,
                f"incremental local {v} poses: take {take}, launches "
                f"{launches_nonzero(la)} (take 2 through {counter} and K7b "
                f"expected)")
        print(f"[smoke] incremental_update on {v} pose slots: take {take}, "
              f"poses {ek:.3e} off f64 (f32 plain {ep:.3e}); launches "
              f"{launches_nonzero(la)}")
        row["update"] = dict(take=take, err_vs_f64=ek,
                             plain_f32_err_vs_f64=ep)
        rows[name], launches[name] = row, la
    g10 = config4_graph(dev, torch.float32, seed, CONFIG4["n_poses"])
    g, since = local_graph(g10, INC_10K["slots"],
                           SELECT_WIDE_FACTORS - g10.bet_i.shape[0])
    v, f = g.poses.shape[0], g.bet_i.shape[0]
    require(kernels.select_route(v, f) == "shared"
            and kernels.select_smem(v, f) > kernels.SMEM_MAX,
            f"K7a endpoints in the graph: {v} poses, {f} factors are "
            f"staged or off the shared route")
    rows["staged"]["endpoints_in_graph"] = k7a_case(
        "endpoints in the graph", g, icfg, since, jobs)
    return launches["scratch"], rows["scratch"], rows["staged"]


def check_k6g_past(dev, seed: int, n_poses: int = SELECT_PAST_POSES):
    """K6g on ``n_poses`` poses of config 4's Manhattan graph (K5's
    linearization) at its 10k settings (lam 1e-3, 250 iterations, tol
    1e-5): :func:`pcg_vs_plain`, iterations within max(1, 2%); event
    times of the solve and of its 0-iteration set-up."""
    import torch

    from ndtpu_torch import kernels
    from ndtpu_torch.graph import factors as fct
    from ndtpu_torch.graph import solve as slv

    g = config4_graph(dev, torch.float32, seed, n_poses)
    v, f, p = g.poses.shape[0], g.bet_i.shape[0], g.prior_idx.shape[0]
    require(kernels.pcg_route(v, f, p) == "grid",
            f"K6g {v}: the route keeps it on K6")
    lin = fct.linearize(g)
    lam = torch.tensor(K6G_10K["lam"], dtype=torch.float32, device=dev)
    mi, tol = K6G_10K["max_iter"], K6G_10K["tol"]
    run = lambda: slv.pcg_solve(g, lin, None, lam, mi, tol)
    row, _, it = pcg_vs_plain(f"K6g {v}", run, g, lin, lam, mi, tol, 0.02)
    ms = time_ms(run)
    settled_ms = time_ms(lambda: slv.pcg_solve(g, lin, None, 0.0, 0, tol,
                                               1e-8))
    row.update(ms=ms, settled_ms=settled_ms,
               us_per_iteration=(ms - settled_ms) * 1e3 / max(int(it), 1))
    print(f"[smoke] K6g on {v} poses ({f} factors, "
          f"{kernels.pcg_grid_plan(v, f, p)[0]} blocks): {int(it)} "
          f"iterations (f32 plain {row['plain_f32_iterations']}), vs f64 max "
          f"abs err {row['max_abs_err']:.3e} (f32 plain "
          f"{row['plain_f32_err_vs_f64']:.3e}); bit-identical on a second "
          f"launch; kernel {ms:.4f} ms, its set-up alone {settled_ms:.4f} "
          f"ms ({row['us_per_iteration']:.2f} us per iteration past it)")
    return row


def check_marginal_10k(sg):
    """``marginal_covariance_pcg`` of the middle pose (5,000) of the settled
    10k graph
    on the card (three K6g solves against unit vectors) against its f64
    plain version on the CPU (the same linearization in f64): rtol 1e-3
    of the covariance's largest entry."""
    import torch

    from ndtpu_torch import kernels
    from ndtpu_torch.config import SolverConfig
    from ndtpu_torch.graph import incremental as inc

    cfg, idx = SolverConfig(), sg.poses.shape[0] // 2
    before = kernels.LAUNCHES["pcg_solve_grid"]
    with no_plain_on_card():
        cov = inc.marginal_covariance_pcg(sg, idx, cfg)
        torch.cuda.synchronize()
    n = kernels.LAUNCHES["pcg_solve_grid"] - before
    cov64 = inc.marginal_covariance_pcg(graph_on(sg, "cpu", torch.float64),
                                        idx, cfg)
    err = _rel_check("marginal_covariance_pcg 10k", [cov.cpu().double()],
                     [cov64], rtol=1e-3)
    require(n == 3, f"marginal_covariance_pcg 10k: {n} K6g launches (three "
            f"expected)")
    print(f"[smoke] marginal_covariance_pcg of pose {idx} at 10k on the card "
          f"(three K6g launches): max abs err {err:.3e} vs f64 (rtol 1e-3 of "
          f"the largest entry {float(cov64.abs().max()):.6e})")
    return dict(pose=idx, max_abs_err=err, max_abs=float(cov64.abs().max()),
                k6g_launches=n)


def render_final_map(label, state, cfg) -> dict:
    """The run's final map (K10b on the card from K3's statistics) through
    ``eval.render.rasterize_map`` (host numpy, no PNG, no PIL): an image of
    the grid's shape, finite, in [0, 1], with lit pixels; its valid cells
    those of the plain ``finalize_ref`` on the same statistics. Returns the
    counts."""
    import numpy as np

    from ndtpu_torch.eval import render
    from ndtpu_torch.ndt import grid as ndt_grid

    m = ndt_grid.finalize(state.stats, cfg.ndt)
    ref = ndt_grid.finalize_ref(ndt_grid.NDTStats(*(x.cpu()
                                                    for x in state.stats)),
                                cfg.ndt)
    valid = int(m.valid.sum())
    require(valid == int(ref.valid.sum()) > 0,
            f"{label}: {valid} valid cells on the card, "
            f"{int(ref.valid.sum())} in the plain finalize")
    t0 = time.perf_counter()
    img = render.rasterize_map(m, cfg.grid)
    secs = time.perf_counter() - t0
    g = cfg.grid
    require(img.shape == (4 * g.ny, 4 * g.nx) and bool(np.isfinite(img).all())
            and float(img.min()) >= 0.0 and float(img.max()) <= 1.0,
            f"{label}: the rendered map is not a finite [0, 1] image of "
            f"{(4 * g.ny, 4 * g.nx)} pixels")
    lit = int((img > 0.0).sum())
    bright = int((img > 0.5).sum())
    require(bright > 0, f"{label}: the rendered map has no lit pixel")
    print(f"[smoke] {label}: final map rendered ({img.shape[1]} x "
          f"{img.shape[0]} px, upscale 4, {secs:.2f} s on the host): {lit} "
          f"lit pixels, {bright} above 0.5, from {valid} valid cells")
    return dict(render_lit_pixels=lit, render_pixels_above_half=bright,
                render_valid_cells=valid)


def run_entry_point(dev, config, n_scans: int, label=None, render=False):
    """The CLI main path on ``config``, with fresh launch counters and
    counts of the loop-detection calls (``detect_loops_stacked``, one K15
    launch each),
    the smoother's takes (0 skip, 1 global, 2 local), its full solves and
    its PCG calls (``graph.solve.pcg_solve``, one ``pcg_solve`` launch
    each), split into the settled checks (0 iterations) and the solves; the
    run's scans/s, seconds, ATE, keyframes and loops ride
    along in the counts (with ``render``, :func:`render_final_map`'s
    too). Returns ``(launches, counts)``."""
    import numpy as np

    from ndtpu_torch import kernels, run
    from ndtpu_torch.config import PipelineConfig
    from ndtpu_torch.graph import incremental as inc
    from ndtpu_torch.graph import solve as slv
    from ndtpu_torch.loop import closure
    from ndtpu_torch.ndt import match
    from ndtpu_torch.slam import pipeline

    windows = -(-n_scans // PipelineConfig.from_json(str(config)).window)
    saved = [(closure, "detect_loops_stacked"),
             (inc, "incremental_update"), (slv, "optimize"),
             (slv, "pcg_solve"), (pipeline, "_window_backend")]
    saved = [(mod, name, getattr(mod, name)) for mod, name in saved]
    counts = dict(detections=0, full_solves=0, pcg_solves=0,
                  pcg_settled_checks=0, windows=0)
    takes = []

    def counted(fn, key):
        def inner(*a, **k):
            counts[key] += 1
            return fn(*a, **k)
        return inner

    def pcg_counted(*a, **k):
        # The settled check is the 0-iteration solve; the rest iterate.
        max_iter = a[4] if len(a) > 4 else k["max_iter"]
        counts["pcg_settled_checks" if max_iter == 0 else "pcg_solves"] += 1
        return saved[3][2](*a, **k)

    def recorded(*a, **k):
        out = saved[1][2](*a, **k)
        takes.append(out[1])
        return out

    closure.detect_loops_stacked = counted(saved[0][2], "detections")
    inc.incremental_update = recorded
    slv.optimize = counted(saved[2][2], "full_solves")
    slv.pcg_solve = pcg_counted
    pipeline._window_backend = counted(saved[4][2], "windows")
    try:
        kernels.reset_launches()
        match.CALLS["match_batch_packed"] = 0
        res = run.main(["--config", str(config), "--max-scans", str(n_scans),
                        "--device", str(dev)])
        launches = dict(kernels.LAUNCHES)
        calls = match.CALLS["match_batch_packed"]
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    traj = res["traj"]
    label = label or config.name
    require(traj.shape == (n_scans, 3) and bool(np.isfinite(traj).all()),
            "entry point: trajectory not finite or of the wrong shape")
    require(res["n_keyframes"] > 0, "entry point: no keyframes")
    lm = sum(v for k, v in launches.items() if k.startswith("lm_ndt"))
    require(lm == calls, f"entry point {label}: {lm} lm_ndt launches "
            f"for {calls} match_batch_packed calls (one each expected)")
    if render:
        counts.update(render_final_map(f"entry point {label}",
                                       res["state"],
                                       PipelineConfig.from_json(str(config))))
    loops = PipelineConfig.from_json(str(config)).use_loop_closure
    require(launches["window_append"] == counts["windows"] > 0
            and launches["window_append[loops]"]
            == (counts["windows"] if loops else 0),
            f"entry point {label}: K14 {launches['window_append']} append and "
            f"{launches['window_append[loops]']} loop launches for "
            f"{counts['windows']} windows (one append each, and one loop "
            f"append each with loop closure, expected)")
    require(launches["loop_lanes"] == counts["detections"]
            == (counts["windows"] if loops else 0),
            f"entry point {label}: {launches['loop_lanes']} K15 launches for "
            f"{counts['detections']} loop-detection calls in "
            f"{counts['windows']} windows (one each with loop closure "
            f"expected)")
    pcg_calls = counts["pcg_solves"] + counts["pcg_settled_checks"]
    require(launches["pcg_solve"] == pcg_calls,
            f"entry point {label}: {launches['pcg_solve']} pcg_solve "
            f"launches for {pcg_calls} PCG solves and settled checks (one "
            f"each expected)")
    codes = [int(t) for t in takes]
    counts["takes"] = {c: codes.count(c) for c in (0, 1, 2)}
    counts.update(scans_per_s=res["scans_per_s"], seconds=res["seconds"],
                  ate_m=res["ate"], keyframes=res["n_keyframes"],
                  loops=res["n_loops"], match_batch_packed=calls)
    print(f"[smoke] entry point {label}: {n_scans} scans, "
          f"{res['scans_per_s']:.1f} scans/s ({res['seconds']:.2f} s), "
          f"keyframes={res['n_keyframes']}, loops={res['n_loops']}, ATE "
          f"{res['ate']:.4f} m, {calls} match_batch_packed calls, "
          f"{lm / windows:.2f} lm_ndt launches per window ({windows} "
          f"windows), {counts['detections']} loop-detection calls; smoother: "
          f"{len(codes)} updates, takes (0 skip, 1 global, 2 local) "
          f"{counts['takes']}, {counts['full_solves']} full solves; K6 "
          f"{counts['pcg_settled_checks']} settled checks (0 iterations) "
          f"and {counts['pcg_solves']} solves; launches "
          f"{launches_nonzero(launches)}")
    return launches, counts


def draw_gate(label, draws):
    """The box-world gates on ``draws`` (per draw: the port's ``ate``, the
    reference's ``jax_ate_m`` and ``dead_reckoning_ate_m``): each draw below
    0.75 x dead reckoning, or, where the JAX package's own f32 run is not
    (recorded as ``jax_fails_dead_reckoning``), within 2 x its ATE; the
    median at most max(0.10 m, 2 x JAX's median). Returns the gate's
    summary."""
    failing = []
    for d in draws:
        dr = d["dead_reckoning_ate_m"]
        if d["jax_ate_m"] >= 0.75 * dr:
            failing.append(d["seed"])
            require(d["ate"] <= 2.0 * d["jax_ate_m"],
                    f"ATE gate {label}: draw {d['seed']} ATE {d['ate']:.4f} "
                    f"m above 2 x JAX's {d['jax_ate_m']:.4f} m (JAX itself "
                    f"fails 0.75 x dead reckoning {dr:.4f} m there)")
        else:
            require(d["ate"] < 0.75 * dr,
                    f"ATE gate {label}: draw {d['seed']} ATE {d['ate']:.4f} "
                    f"m is not below 0.75 x dead reckoning {dr:.4f} m")
    med = statistics.median(d["ate"] for d in draws)
    jmed = statistics.median(d["jax_ate_m"] for d in draws)
    limit = max(0.10, 2.0 * jmed)
    print(f"[smoke] ATE gate {label}: median {med:.4f} m vs limit "
          f"{limit:.4f} m (max(0.10, 2 x JAX median {jmed:.4f}))"
          + (f"; JAX fails 0.75 x dead reckoning on draws {failing}, gated "
             f"against 2 x JAX there" if failing else ""))
    require(med <= limit, f"ATE gate {label}: median ATE above the limit")
    return dict(median_ate_m=med, limit_m=limit, jax_median_ate_m=jmed,
                jax_fails_dead_reckoning=failing)


#: bench.py §3b's multilap (bench.py:332-364): 1,000 scans (3.5 laps of
#: the box world) at 360 beams, seed 7, bench.py's odometry noise.
MULTILAP = dict(half=11.0, n_scans=1000, traj_half=7.0, step=0.2,
                n_beams=360, max_range=20.0, min_range=0.1, seed=7,
                odom_trans_std=0.04, odom_rot_std=0.01)
REF_MULTILAP_FILE = ROOT / "tests" / "data" / "torch_multilap1000_ref.json"


def multilap_config(c):
    """bench.py §3b's ``PipelineConfig`` (``pcfg_base``, bench.py:260-269,
    with loop closure, :336) from the config module ``c``: the port's
    ``ndtpu_torch.config`` here, the JAX package's in the CPU tests."""
    return c.PipelineConfig(
        grid=c.GridConfig(x0=-14.0, y0=-14.0, cell=0.5, nx=56, ny=56,
                          overlap=4),
        keyframe=c.KeyframeConfig(dist_thresh=0.5, angle_thresh=0.3,
                                  capacity=512),
        loop=c.LoopConfig(radius=3.0, min_index_gap=10, max_candidates=8,
                          local_half_extent=8.0),
        solver=c.SolverConfig(inc_iters=2, pcg_max_iter=60),
        n_beams=360, max_range=20.0, window=8, window_passes=2,
        use_loop_closure=True)


def multilap_sequence(device="cpu"):
    """bench.py §3b's sequence from the port's synth (K11 on a CUDA
    ``device``; the noise from numpy)."""
    from ndtpu_torch.data import synth

    m = MULTILAP
    world = synth.box_world(m["half"])
    traj = synth.rectangle_trajectory(m["n_scans"], half=m["traj_half"],
                                      step=m["step"])
    return synth.make_sequence(world, traj, n_beams=m["n_beams"],
                               max_range=m["max_range"],
                               min_range=m["min_range"], seed=m["seed"],
                               odom_trans_std=m["odom_trans_std"],
                               odom_rot_std=m["odom_rot_std"], device=device)


def multilap_summary(ate_m: float, n_loops: int, n_keyframes: int, takes,
                     n_innov_rej: int) -> dict:
    """bench.py §3b's numbers of one run: ATE (m), loops, keyframes, the
    smoother's takes per window (``takes``: one code per window, 0 skip, 1
    global, 2 local) as counts and fractions, innovation-rejected loop
    candidates."""
    takes = [int(t) for t in takes]
    n = max(len(takes), 1)
    counts = {c: takes.count(c) for c in (0, 1, 2)}
    return dict(ate_m=ate_m, loops=n_loops, keyframes=n_keyframes,
                takes=counts,
                take_frac={name: counts[c] / n for c, name in
                           ((0, "skip"), (1, "global"), (2, "local"))},
                innov_rejected=n_innov_rej)


def run_multilap(dev):
    """Phase 7d: bench.py §3b's multilap at full size on the card: the
    sequence made by K11, ``run_slam_windowed`` through the kernels (every
    plain version refusing CUDA tensors), counters reset just before and
    read just after. Gates: ATE <= max(0.15 m, 2 x the JAX package's f32
    run on the same sequence, ``tests/data/torch_multilap1000_ref.json``),
    loops > 0, one K11 launch, and K7b launched ``inc_iters`` times per
    local take. Returns ``(launches, result)``."""
    import torch

    from ndtpu_torch import config as tconfig
    from ndtpu_torch import kernels
    from ndtpu_torch.eval.ate import ate_rmse
    from ndtpu_torch.slam import pipeline

    ref = json.loads(REF_MULTILAP_FILE.read_text())
    cfg = multilap_config(tconfig)
    kernels.reset_launches()
    t0 = time.perf_counter()
    with no_plain_on_card(PLAIN_WINDOWED):
        seq = multilap_sequence(dev)
        st, outs = pipeline.run_slam_windowed(seq.points, seq.mask,
                                              seq.odom, cfg)
        traj = pipeline.recover_trajectory(st, outs)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    require(bool(torch.isfinite(traj).all()), "multilap: poses not finite")
    res = multilap_summary(
        float(ate_rmse(traj.cpu(), seq.gt_poses.cpu())), int(st.n_loops),
        int(st.kf.n), outs.local_take.cpu()[::cfg.window],
        int(outs.n_innov_rej.sum()))
    same_seq = sequence_hashes(seq) == ref["sequence_sha256"]
    res.update(seconds=seconds, sequence_equals_cpu=same_seq,
               launches={k: launches[k] for k in
                         ("raycast", "local_select", "local_assemble")})
    jf32, jf64 = ref["jax"]["float32"], ref["jax"]["float64"]
    print(f"[smoke] multilap (bench.py §3b, 1,000 scans, 3.5 laps) on the "
          f"card: ATE {res['ate_m']:.4f} m (JAX f32 {jf32['ate_m']:.4f}, "
          f"f64 {jf64['ate_m']:.4f}), loops {res['loops']} (JAX "
          f"{jf32['loops']} / {jf64['loops']}), keyframes "
          f"{res['keyframes']}, takes skip / global / local "
          f"{res['takes'][0]} / {res['takes'][1]} / {res['takes'][2]} "
          f"(fractions {res['take_frac']['skip']:.3f} / "
          f"{res['take_frac']['global']:.3f} / "
          f"{res['take_frac']['local']:.3f}; JAX f32 "
          f"{jf32['takes']}), innovation-rejected {res['innov_rejected']}; "
          f"K11 / K7a / K7b launches {launches['raycast']} / "
          f"{launches['local_select']} / {launches['local_assemble']}; "
          f"sequence equal to the CPU-made one: {same_seq}; "
          f"{seconds:.1f} s")
    limit = max(0.15, 2.0 * jf32["ate_m"])
    require(res["ate_m"] <= limit, f"multilap: ATE {res['ate_m']:.4f} m "
            f"over {limit:.4f} m (max(0.15, 2 x JAX f32's))")
    require(res["loops"] > 0, "multilap: no loop closed")
    require(launches["raycast"] == 1, f"multilap: {launches['raycast']} "
            f"K11 launches for one sequence")
    want = cfg.solver.inc_iters * res["takes"][2]
    require(launches["local_assemble"] == want,
            f"multilap: {launches['local_assemble']} K7b launches for "
            f"{res['takes'][2]} local takes x inc_iters "
            f"{cfg.solver.inc_iters} = {want}")
    return launches, res


def ate_gate(dev, config, ref, label=None):
    """Box-world draws through ``run_slam_windowed`` vs the JAX reference
    ``ref`` (a file, or its loaded dict): ATE by :func:`draw_gate`, and
    with loop closure on a loop wherever JAX closes one. Returns the
    per-draw results and the gate's summary."""
    import torch

    from ndtpu_torch.config import PipelineConfig
    from ndtpu_torch.eval.ate import ate_rmse
    from ndtpu_torch.slam import pipeline

    if isinstance(ref, Path):
        ref = json.loads(ref.read_text())
    cfg = PipelineConfig.from_json(str(config))
    label = label or config.name
    draws = []
    for draw in ref["draws"]:
        seq = box_sequence(draw["seed"], cfg.n_beams,
                           n_scans=ref.get("n_scans", BOX["n_scans"]))
        same = sequence_hashes(seq) == draw["sha256"]
        dr = float(ate_rmse(dead_reckoning(seq.odom.double()),
                            seq.gt_poses.double()))
        p, m, o = (t.to(dev) for t in (seq.points, seq.mask, seq.odom))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, outs = pipeline.run_slam_windowed(p, m, o, cfg)
        traj = pipeline.recover_trajectory(state, outs)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        require(bool(torch.isfinite(traj).all()), "ATE gate: non-finite")
        ate = float(ate_rmse(traj.cpu(), seq.gt_poses))
        loops = ""
        takes = window_takes(outs, cfg.window)
        row = dict(draw, ate=ate, scans_per_s=(p.shape[0] - 1) / dt,
                   takes=takes)
        row.pop("sha256")
        if cfg.use_loop_closure:
            n_loops = int(state.n_loops)
            row["n_loops"] = n_loops
            loops = (f", loops {n_loops} (JAX {draw['jax_n_loops']})")
            require(n_loops > 0 or draw["jax_n_loops"] == 0,
                    f"ATE gate {label}: draw {draw['seed']} closed no loop "
                    f"where JAX closed {draw['jax_n_loops']}")
        f64 = (f", JAX f64 {draw['jax_ate_f64_m']:.4f} m"
               if "jax_ate_f64_m" in draw else "")
        print(f"[smoke] ATE gate {label} draw {draw['seed']}: "
              f"{(p.shape[0] - 1) / dt:.1f} scans/s, ATE {ate:.4f} m, JAX "
              f"ATE {draw['jax_ate_m']:.4f} m{f64}{loops}, dead reckoning "
              f"{dr:.4f} m (reference {draw['dead_reckoning_ate_m']:.4f} m), "
              f"inputs {'match' if same else 'DIFFER FROM'} the reference "
              f"hashes; take codes {takes}")
        draws.append(row)
    return dict(draws=draws, **draw_gate(label, draws))


def window_takes(outs, window: int) -> str:
    """The smoother's take code of each window (0 skip, 1 global, 2 local)
    as one string, the form ``profile_port.py --takes`` prints for any
    checkout."""
    return "".join(str(c) for c in outs.local_take[::window].tolist())


#: Every plain version the windowed path could reach (the layout runs and
#: config 1 hold them all off CUDA tensors).
PLAIN_WINDOWED = PLAIN_SERVING + (
    ("ndtpu_torch.ndt.match", "ndt_terms_ref"),
    ("ndtpu_torch.ndt.grid", "finalize_ref"),
    ("ndtpu_torch.loop.closure", "_gate_and_pack"))


def run_config1(dev):
    """Config 1 (``configs/config1_odometry.json`` as published: 80 x 80 at
    0.5 m, W = 8, two passes, 360 beams) through
    ``run_odometry_windowed`` on box-world draws 0-2 (300 scans), every
    plain version refusing CUDA tensors, the launch counters reset just
    before the first draw and read just after the last: one ``lm_ndt``
    launch per ``match_batch_packed`` call, K3 and K4 launched. Each draw's
    scans/s (wall, synchronized) and ATE beside the JAX package's f32 and
    f64 ATE (``tests/data/torch_config1_box300_ref.json``), gated by
    :func:`draw_gate`. Returns ``(launches, summary)``."""
    import torch

    from ndtpu_torch import kernels
    from ndtpu_torch.config import PipelineConfig
    from ndtpu_torch.eval.ate import ate_rmse
    from ndtpu_torch.ndt import match
    from ndtpu_torch.slam.odometry import run_odometry_windowed

    ref = json.loads(REF1_FILE.read_text())
    cfg = PipelineConfig.from_json(str(CONFIG1))
    draws = []
    kernels.reset_launches()
    match.CALLS["match_batch_packed"] = 0
    with no_plain_on_card(PLAIN_WINDOWED):
        for draw in ref["draws"]:
            seq = box_sequence(draw["seed"], cfg.n_beams,
                               n_scans=ref["n_scans"])
            same = sequence_hashes(seq) == draw["sha256"]
            p, m, o = (t.to(dev) for t in (seq.points, seq.mask, seq.odom))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = run_odometry_windowed(
                p, m, o, cfg.grid, cfg.ndt, cfg.match, cfg.keyframe,
                window=cfg.window, passes=cfg.window_passes,
                odom_gate=cfg.odom_gate)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            require(bool(torch.isfinite(res.poses).all())
                    and res.poses.shape == (p.shape[0], 3),
                    "config 1: poses not finite or of the wrong shape")
            ate = float(ate_rmse(res.poses.cpu(), seq.gt_poses))
            row = dict(draw, ate=ate, scans_per_s=(p.shape[0] - 1) / dt,
                       seconds=dt, keyframes=int(res.is_keyframe.sum()))
            row.pop("sha256")
            print(f"[smoke] config 1 draw {draw['seed']}: "
                  f"{row['scans_per_s']:.1f} scans/s ({dt:.3f} s), ATE "
                  f"{ate:.4f} m, JAX f32 {draw['jax_ate_m']:.4f} m, f64 "
                  f"{draw['jax_ate_f64_m']:.4f} m, dead reckoning "
                  f"{draw['dead_reckoning_ate_m']:.4f} m, "
                  f"{row['keyframes']} keyframes, inputs "
                  f"{'match' if same else 'DIFFER FROM'} the reference hashes")
            draws.append(row)
    launches = dict(kernels.LAUNCHES)
    calls = match.CALLS["match_batch_packed"]
    require(launches["lm_ndt"] == calls > 0
            and sum(v for k, v in launches.items() if k.startswith("lm_ndt"))
            == calls,
            f"config 1: {launches['lm_ndt']} lm_ndt launches for {calls} "
            f"match_batch_packed calls (one each expected)")
    require(launches["halfcell_add"] > 0 and launches["finalize_pack"] > 0,
            "config 1: K3 or K4 not launched")
    gate = draw_gate("config 1", draws)
    return launches, dict(draws=draws, match_batch_packed=calls,
                          launches=launches_nonzero(launches), **gate)


def layout_json(config, changes: dict) -> dict:
    """The published JSON of ``config`` with only the fields of
    ``changes`` (``{section: {field: value}}``) set."""
    doc = json.loads(Path(config).read_text())
    for section, fields in changes.items():
        doc.setdefault(section, {}).update(fields)
    return doc


def layout_kernels(cfg) -> list:
    """The launch counters a windowed run in ``cfg``'s layouts must raise:
    ``lm_ndt``, K3 and K4 in the map's layout, and with loop closure the
    grouped ``lm_ndt``, K8a and the gated verify in the local tables'."""
    from ndtpu_torch import kernels

    lanes = 4 if cfg.match.compact_table else 8
    g = cfg.grid.overlap
    need = [kernels.variant("lm_ndt", g, lanes),
            kernels.variant("halfcell_add", g),
            kernels.variant("finalize_pack", g, lanes)]
    if cfg.use_loop_closure:
        lg = (cfg.loop.local_overlap, lanes)
        need += [kernels.variant(k, *lg) for k in
                 ("lm_ndt_grouped", "local_tables", "loop_gate_fused")]
    return need


def run_layouts(dev):
    """The windowed path in the other table layouts through its entry point
    (:data:`LAYOUT_RUNS`: the published JSON with only the named fields
    changed, written to a temporary file): ``ndtpu_torch.run.main`` with
    the counters reset just before and read just after (each run must
    launch its layout's ``lm_ndt``, K3, K4 and, with loop closure, K8a and
    the gated verify, one gated verify per loop-detection call), every
    plain version refusing CUDA tensors; then box-world draws 0-2 of the
    same config through ``run_slam_windowed`` against the JAX package's f32
    ATE and loops under the same flags
    (``tests/data/torch_layouts_box300_ref.json``). Returns ``(launches by
    run, results by run)``."""
    from ndtpu_torch.config import PipelineConfig

    ref = json.loads(REF_LAYOUTS_FILE.read_text())
    launches_by, out = {}, {}
    with tempfile.TemporaryDirectory(prefix="ndtpu_layouts_") as tmp:
        for name, config, n_scans, changes in LAYOUT_RUNS:
            path = Path(tmp) / f"{name}.json"
            path.write_text(json.dumps(layout_json(ROOT / config, changes)))
            cfg = PipelineConfig.from_json(str(path))
            with no_plain_on_card(PLAIN_WINDOWED):
                launches, counts = run_entry_point(dev, path, n_scans, name)
                gate = ate_gate(dev, path, ref["runs"][name], name)
            for k in layout_kernels(cfg):
                require(launches[k] > 0,
                        f"layout run {name}: {k} launched no time")
            if cfg.use_loop_closure:
                fused = layout_kernels(cfg)[-1]
                require(launches[fused] == counts["detections"] > 0,
                        f"layout run {name}: {launches[fused]} gated "
                        f"verifies for {counts['detections']} loop-detection "
                        f"calls (one each expected)")
            launches_by[name] = launches
            out[name] = dict(config=config, changes=changes,
                             cli_scans=n_scans, cli=counts,
                             launches=launches_nonzero(launches), **gate)
    return launches_by, out


def check_padded_sessions(dev):
    """Sessions of different lengths on the card: the serving CLI pads the
    shorter ones with all-false masks and identity odometry. ``lm_ndt``
    (grouped, as the front end calls it) ends an all-masked lane after 0
    iterations at its initial pose; K3s leaves an all-masked session's map
    bit for bit as it was, and K4s packs an empty map into finite, invalid
    rows; the gated verify takes queries with no real candidate without
    NaN and accepts nothing; and a stacked run of sessions of 40 and 17
    scans (padded to 40) gives finite poses and no keyframe, loop or drop
    in the padded tail, on the card as on the CPU's plain twins (their
    trajectories' distance is printed)."""
    import dataclasses

    import torch

    from ndtpu_torch import kernels, serve
    from ndtpu_torch.config import PipelineConfig
    from ndtpu_torch.dist import slam_dp
    from ndtpu_torch.ndt import grid as ndt_grid
    from ndtpu_torch.ndt import match

    cfg = slam_dp.serving_config(PipelineConfig.from_json(str(SERVING)))
    cfg = dataclasses.replace(cfg, keyframe=dataclasses.replace(
        cfg.keyframe, capacity=32))
    seqs = serve.synthetic_sessions(cfg, 2, 40)
    seqs[1] = seqs[1]._replace(points=seqs[1].points[:17],
                               mask=seqs[1].mask[:17],
                               odom=seqs[1].odom[:17],
                               gt_poses=seqs[1].gt_poses[:17])
    points, mask, odom, lengths = serve.pad_sessions(seqs)
    grid, n = cfg.grid, points.shape[2]
    stats = ndt_grid.add_points_stacked(
        ndt_grid.NDTStats(*(torch.stack([t, t]) for t in
                            ndt_grid.empty_stats(grid, torch.float32, dev))),
        points[:, 0].to(dev).contiguous(), mask[:, 0].to(dev).contiguous(),
        grid)
    pts = points[:, 30:32].to(dev).reshape(2, -1, 2).contiguous()
    msk = mask[:, 30:32].to(dev).reshape(2, -1).contiguous()
    added = ndt_grid.add_points_stacked(stats, pts, msk, grid)
    tables = ndt_grid.finalize_pack_stacked(
        ndt_grid.NDTStats(*(torch.zeros_like(t) for t in stats)), cfg.ndt,
        grid)
    init = torch.tensor([[0.1, -0.2, 0.05]] * 2, device=dev)
    res = match.match_batch_packed(
        points[1, 30:32].to(dev), mask[1, 30:32].to(dev),
        ndt_grid.finalize_pack_stacked(stats, cfg.ndt, grid), init, grid,
        cfg.match, group=torch.zeros(2, dtype=torch.int32, device=dev))
    loop = dataclasses.replace(cfg.loop, max_candidates=4)
    gate = kernels.LoopGate(torch.zeros(1, 4, dtype=torch.bool, device=dev),
                            torch.zeros(1, dtype=torch.long, device=dev),
                            loop.score_gate, loop.max_innovation_base,
                            loop.max_innovation_per_kf, 2)
    vres, (acc, _, sqi) = match.match_batch_packed_gated(
        torch.zeros(4, n, 2, device=dev), torch.zeros(4, n,
                                                      dtype=torch.bool,
                                                      device=dev),
        tables, init[:1].expand(4, 3).contiguous(), grid, cfg.match,
        torch.zeros(4, dtype=torch.int32, device=dev), gate)
    torch.cuda.synchronize()
    require(bits_equal(tuple(t[1] for t in added), tuple(t[1] for t in stats)),
            "padded sessions: K3s changed an all-masked session's map")
    require(bool(torch.isfinite(tables).all())
            and float(tables[..., [5, 13, 21, 29]].abs().max()) == 0.0,
            "padded sessions: K4s of an empty map is not finite and invalid")
    require(bool((res.n_iter == 0).all()) and bits_equal(res.pose, init)
            and bool(torch.isfinite(res.hessian).all()),
            "padded sessions: lm_ndt ran on an all-masked lane")
    require(bool(torch.isfinite(sqi).all()) and not bool(acc.any())
            and bool((vres.n_iter == 0).all()),
            "padded sessions: the gated verify of empty candidates")
    runs = {}
    for name, device in (("card", dev), ("cpu", torch.device("cpu"))):
        st, outs = slam_dp.run_sessions_stacked(
            points.to(device), mask.to(device), odom.to(device), cfg)
        traj = serve.trajectories(st, outs).cpu()
        runs[name] = (st, outs, traj)
        t = lengths[1]
        require(bool(torch.isfinite(traj).all()),
                f"padded sessions ({name}): non-finite trajectory")
        require(not bool(outs.is_keyframe[1, t - 1:].any())
                and not bool(outs.n_loops_new[1, t - 1:].any())
                and int(outs.n_dropped.sum()) == 0,
                f"padded sessions ({name}): the padded tail made keyframes, "
                f"loops or drops")
    (sc, oc, tc), (sp, op, tp) = runs["card"], runs["cpu"]
    same_kf = torch.equal(oc.is_keyframe.cpu(), op.is_keyframe)
    dev_m = float((tc - tp).abs().max())
    print(f"[smoke] padded sessions (lengths {lengths}, padded to "
          f"{points.shape[1]}): all-masked lm_ndt lanes 0 iterations at "
          f"their initial pose, K3s leaves an all-masked map bit for bit, "
          f"K4s of an empty map finite and invalid, the gated verify of "
          f"empty candidates accepts nothing (finite); stacked run finite, "
          f"no keyframe, loop or drop in the padded tail; keyframes "
          f"{sc.kf.n.tolist()} (the CPU twins' {sp.kf.n.tolist()}, flags "
          f"{'equal' if same_kf else 'differ'}), trajectories within "
          f"{dev_m:.2e} m of theirs")
    return dev_m


def run_serving(dev, card, config=SERVING, label="serving",
                twice: bool = True, jobs=None):
    """Stacked serving through its entry point: ``ndtpu_torch.serve.main``
    with ``SERVING_ARGS`` (8 sessions x 300 scans of ``config``,
    ``configs/config_serving.json`` or a table layout of it; 360 beams,
    capacity 160), every launch counter reset just before the first
    invocation and read just after it, with no plain twin reachable on CUDA
    tensors. Each invocation is one first run and 3 timed runs. Requires,
    per stacked window, in the config's table layout (``kernels.variant``'s
    counters): one ``lm_ndt_grouped`` launch per front-end pass for all 8
    sessions, one K8a, one K15 and one gated verify per window for all 8
    sessions (K8a also once a session in ``init_slam``), one
    K3s launch per use (pass-2 maps, extend, and refresh where one fires)
    and two K4s, never a per-map K3 or K4 (K3 runs only in each session's
    ``init_slam``); one K5 fresh-window launch a window for all sessions
    (the need test: K5 launches = windows + 2 ``inc_iters`` a smoother
    call) and no single-session fresh window; where a refresh fires one
    K16, one ``_refresh_points`` call for all sessions and one K14 row
    write; at most ``inc_iters`` K6b launches (exactly that per smoother
    call) and no K6; no drop; with ``twice``, a second invocation whose
    trajectories and final states are bit-equal to the first's. With
    ``jobs``, the window's gated verify over all sessions' S K C lanes is
    timed alone on the first such launch's inputs (``gated_verify`` in the
    summary; its card time queued in ``jobs``). Returns ``(launches,
    summary, state)``, the state of the last run; the summary also holds
    ``run_ate_m``, each session's ATE in each of the first invocation's
    runs (the last one's is the CLI's own)."""
    import torch

    from ndtpu_torch import kernels, serve
    from ndtpu_torch.config import PipelineConfig
    from ndtpu_torch.dist import slam_dp
    from ndtpu_torch.graph import incremental as inc
    from ndtpu_torch.ndt import match
    from ndtpu_torch.slam import pipeline

    cfg = slam_dp.serving_config(PipelineConfig.from_json(str(config)))
    args = ["--config", str(config)] + SERVING_ARGS[2:]
    g = cfg.grid.overlap
    gl = (g, 4 if cfg.match.compact_table else 8)
    local = (cfg.loop.local_overlap, gl[1])
    k3s = kernels.variant("halfcell_add_stacked", g)
    k4s = kernels.variant("finalize_pack_stacked", *gl)
    front = kernels.variant("lm_ndt_grouped", *gl)
    gated = kernels.variant("loop_gate_fused", *local)
    grouped_verify = kernels.variant("lm_ndt_grouped", *local)
    counts = dict(windows=0, refreshes=0, smooths=0, runs=0,
                  refresh_points=0, fresh_stacked=0, fresh_single=0)
    finals = []
    saved = [(slam_dp, name, getattr(slam_dp, name)) for name in
             ("_stacked_window_step", "_refresh_stacked", "_smooth_stacked",
              "run_sessions_stacked")]
    saved += [(pipeline, "_refresh_points", pipeline._refresh_points),
              (inc, "fresh_residual_max_stacked",
               inc.fresh_residual_max_stacked),
              (inc, "fresh_residual_max", inc.fresh_residual_max),
              (match, "match_lanes", match.match_lanes)]
    lanes = cfg.loop.max_detect_per_window * cfg.loop.max_candidates
    verify_args = []

    def record_verify(*a, **k):
        gate = k.get("gate")
        if (jobs is not None and gate is not None and not verify_args
                and a[0].shape[0] == n_sessions * lanes):
            keep = lambda x: x.clone() if isinstance(x, torch.Tensor) else x
            verify_args.append(([keep(x) for x in a],
                                type(gate)(*map(keep, gate))))
        return saved[-1][2](*a, **k)

    def counted(fn, key):
        def inner(*a, **k):
            counts[key] += 1
            out = fn(*a, **k)
            if key == "runs":
                finals.append(out)
            return out
        return inner

    n_sessions = int(SERVING_ARGS[SERVING_ARGS.index("--sessions") + 1])
    for (mod, name, fn), key in zip(saved, (
            "windows", "refreshes", "smooths", "runs", "refresh_points",
            "fresh_stacked", "fresh_single")):
        setattr(mod, name, counted(fn, key))
    match.match_lanes = record_verify
    try:
        with no_plain_on_card(PLAIN_SERVING):
            kernels.reset_launches()
            res = serve.main(args)
            launches = dict(kernels.LAUNCHES)
            first = dict(counts)
            res2 = serve.main(args) if twice else None
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    torch.cuda.synchronize()
    n_s, runs, w = res["sessions"], first["runs"], first["windows"]
    passes = cfg.window_passes
    require(res["device"] == torch.cuda.get_device_name(0),
            f"{label} ran on {res['device']}")
    n_scans = int(SERVING_ARGS[SERVING_ARGS.index("--max-scans") + 1])
    require(runs == 4 and w == runs * -(-(n_scans - 1) // cfg.window),
            f"{label}: {runs} runs of {w} windows in all")
    verify = launches[gated]
    k8a = kernels.variant("local_tables", *local)
    require(verify == w and launches[grouped_verify] >= verify
            and launches["loop_lanes"] == w
            and launches[k8a] == w + n_s * runs,
            f"{label}: {verify} gated verifies ({gated}), "
            f"{launches['loop_lanes']} K15 and {launches[k8a]} {k8a} "
            f"launches for {w} windows (one each a window for all {n_s} "
            f"sessions, and K8a once a session in each run's init_slam)")
    front_n = launches[front] - (verify if front == grouped_verify else 0)
    require(front_n == passes * w
            and launches[kernels.variant("lm_ndt", *gl)] == 0,
            f"{label}: {front_n} front-end {front} launches for {w} windows "
            f"x {passes} passes (one each for all {n_s} sessions expected) "
            f"and {launches[kernels.variant('lm_ndt', *gl)]} shared-table "
            f"launches")
    k3 = kernels.variant("halfcell_add", g)
    require(launches[k3s] == (passes - 1) * w + w + first["refreshes"]
            and launches[k3] == n_s * runs,
            f"{label}: {launches[k3s]} {k3s} launches for {w} windows and "
            f"{first['refreshes']} refreshes, {launches[k3]} per-map {k3} "
            f"launches ({n_s} per run expected, in init_slam)")
    k4 = kernels.variant("finalize_pack", *gl)
    require(launches[k4s] == passes * w and launches[k4] == 0,
            f"{label}: {launches[k4s]} {k4s} and {launches[k4]} {k4} "
            f"launches for {w} windows")
    k6b = launches["pcg_solve_blocked"]
    require(k6b == cfg.solver.inc_iters * first["smooths"] > 0
            and k6b <= cfg.solver.inc_iters * w
            and launches["pcg_solve"] == 0,
            f"{label}: {k6b} K6b launches for {first['smooths']} smoother "
            f"calls in {w} windows (inc_iters {cfg.solver.inc_iters}), "
            f"{launches['pcg_solve']} K6 launches")
    k5 = launches["factor_linearize"]
    require(first["fresh_stacked"] == w and first["fresh_single"] == 0
            and k5 == w + 2 * cfg.solver.inc_iters * first["smooths"],
            f"{label}: {first['fresh_stacked']} stacked and "
            f"{first['fresh_single']} single-session need tests, {k5} K5 "
            f"launches for {w} windows and {first['smooths']} smoother calls "
            f"(one fresh-window launch a window for all {n_s} sessions, two "
            f"a smoother iteration)")
    require(launches["refresh_points"] == first["refreshes"]
            == first["refresh_points"] > 0,
            f"{label}: {launches['refresh_points']} K16 launches and "
            f"{first['refresh_points']} _refresh_points calls for "
            f"{first['refreshes']} refreshes (one each for all {n_s} "
            f"sessions expected)")
    require(launches["window_append"] == w
            and launches["window_append[loops]"] == w
            and launches["window_append[rows]"] == first["refreshes"],
            f"{label}: K14 {launches['window_append']} append, "
            f"{launches['window_append[loops]']} loop and "
            f"{launches['window_append[rows]']} row launches for {w} windows "
            f"and {first['refreshes']} refreshes (one each expected)")
    dropped = sum(r["dropped"] for r in res["per_session"])
    require(dropped == 0, f"{label}: {dropped} keyframes/factors dropped")
    from ndtpu_torch.eval.ate import ate_rmse

    seqs = serve.synthetic_sessions(cfg, n_s, n_scans, device=dev)
    res["run_ate_m"] = [
        [float(ate_rmse(traj[k], seqs[k].gt_poses.to(traj)))
         for k in range(n_s)]
        for traj in (serve.trajectories(*fin).cpu() for fin in finals[:runs])]
    require(res["run_ate_m"][-1] == [r["ate_m"] for r in res["per_session"]],
            f"{label}: the last run's ATE differs from the CLI's")
    st2 = finals[-1][0]
    if twice:
        st1 = finals[runs - 1][0]
        require(bits_equal(torch.as_tensor(res["traj"]),
                           torch.as_tensor(res2["traj"]))
                and bits_equal(st1.graph.poses, st2.graph.poses)
                and bits_equal(tuple(st1.stats), tuple(st2.stats)),
                f"{label}: two invocations differ")
    per_w = {k: v / w for k, v in launches.items() if v}
    print(f"[smoke] {label} entry point (serve {' '.join(args[1:])}, "
          f"{card}): aggregate_scans_per_s {res['aggregate_scans_per_s']:.1f}"
          f" (median of {len(res['run_s'])} runs "
          f"{', '.join(f'{t:.4f}' for t in res['run_s'])} s; first run "
          f"{res['first_run_s']:.3f} s), capacity {res['capacity']}, "
          f"{w // runs} windows per run, {first['smooths']} smoother calls "
          f"and {first['refreshes']} refreshes in {runs} runs"
          + ("; bit-equal across two invocations" if twice else "")
          + "; launches per window "
          + ", ".join(f"{k} {v:.2f}" for k, v in per_w.items()))
    if jobs is not None:
        require(len(verify_args) == 1, f"{label}: no gated verify of all "
                f"{n_s} sessions' {n_s * lanes} lanes ran")
        (vargs, gate), = verify_args
        fused = lambda: match.match_lanes(*vargs, gate=gate)
        row = dict(sessions=n_s, lanes=int(vargs[0].shape[0]),
                   ms=time_ms(fused))
        card_time(jobs, f"{label} gated verify, {row['lanes']} lanes of "
                  f"{n_s} sessions", row, "card_ms", fused,
                  ["lm_ndt_kernel"])
        res["gated_verify"] = row
        print(f"[smoke] {label} gated verify alone (one launch, {n_s} "
              f"sessions x {cfg.loop.max_detect_per_window} queries x "
              f"{cfg.loop.max_candidates} candidates = {row['lanes']} "
              f"lanes, a window's inputs): {row['ms']:.4f} ms")
    return launches, res, st2


def serving_gates(res, ref=None, label="serving", median_of_runs=False):
    """Per-session gates against the JAX package's run of the same 8
    sessions (``ref``, its sessions' records; by default those of
    ``tests/data/torch_serving8_box300_ref.json``); with
    ``median_of_runs``, each session's ATE is the median over the
    invocation's runs (``res["run_ate_m"]``: the first run and the three
    on inputs moved by 1e-6 m offsets), not the last run's alone: ATE <=
    max(0.15 m, 2 x JAX's f32 ATE of that session); ATE below 0.75 x the
    session's dead reckoning wherever JAX's f32 run is (session 4 of this
    workload drifts to ~6.6 m in JAX, at f32 and f64: the gate cannot hold
    there for a faithful port, so it is reported, not applied); a loop
    wherever JAX closes one. Prints every session's ATE, loops and the JAX
    f32 and f64 ATEs beside it (f32 basins, ROADMAP C-w1b)."""
    if ref is None:
        ref = json.loads(REF_SERVING_FILE.read_text())["sessions"]
    require(len(ref) == len(res["per_session"]),
            f"{label} gates: session counts differ")
    rows = []
    for rec, r in zip(res["per_session"], ref):
        k, ate, loops = rec["session"], rec["ate_m"], rec["loops"]
        runs = [a[k] for a in res["run_ate_m"]] if median_of_runs else [ate]
        ate = statistics.median(runs)
        j32, j64, dr = r["jax_f32"], r["jax_f64"], r["dead_reckoning_ate_m"]
        limit = max(0.15, 2.0 * j32["ate_m"])
        dr_gate = j32["ate_m"] < 0.75 * dr
        print(f"[smoke] {label} session {k}: ATE {ate:.4f} m"
              + (f" (median of runs "
                 f"{', '.join(f'{a:.4f}' for a in runs)})"
                 if median_of_runs else "") + " (limit "
              f"{limit:.4f}; JAX f32 {j32['ate_m']:.4f}, f64 "
              f"{j64['ate_m']:.4f}), dead reckoning {dr:.4f} m ("
              + ("gate 0.75 x" if dr_gate else
                 "not gated: JAX's own run is above 0.75 x")
              + f"), loops {loops} (JAX f32 {j32['loops']}, f64 "
              f"{j64['loops']}), keyframes {rec['keyframes']} (JAX f32 "
              f"{j32['keyframes']})")
        require(ate <= limit, f"{label} session {k}: ATE {ate:.4f} m over "
                f"{limit:.4f}")
        require(not dr_gate or ate < 0.75 * dr,
                f"{label} session {k}: ATE {ate:.4f} m not below 0.75 x "
                f"dead reckoning {dr:.4f} m")
        require(loops > 0 or j32["loops"] == 0,
                f"{label} session {k}: no loop where JAX closed "
                f"{j32['loops']}")
        rows.append(dict(session=k, ate_m=ate, loops=loops,
                         **({"run_ate_m": runs} if median_of_runs else {}),
                         jax_f32_ate_m=j32["ate_m"],
                         jax_f64_ate_m=j64["ate_m"], dr_gated=dr_gate))
    return rows


def run_serving_layouts(dev, card):
    """Phase 10b: stacked serving in the other table layouts through its
    entry point (:data:`SERVING_LAYOUT_RUNS`: ``configs/config_serving.json``
    with only the named fields changed, written to a temporary JSON), one
    invocation each (:func:`run_serving` with ``twice=False``: the layout's
    K3s, K4s, front-end ``lm_ndt_grouped`` and gated verify counted per
    window, no plain version on CUDA tensors, no drop), then each session
    against the JAX package's run of the same sessions under the same flags
    (``tests/data/torch_serving8_layouts_box300_ref.json``) by
    :func:`serving_gates`' rule on the median of the invocation's four
    runs: at overlap 1 sessions 4 and 7 are bistable in f32 (a run on
    inputs moved by a 1e-6-scale offset can end metres off while the
    card's window steps agree with the plain f32 steps from the same
    states, ``profile_port.py --serving-steps``; ROADMAP C-w1b), so one
    run's ATE is a draw from two basins. Returns ``(launches by run,
    results by run)``."""
    ref = json.loads(REF_SERVING_LAYOUTS_FILE.read_text())["runs"]
    launches_by, out = {}, {}
    with tempfile.TemporaryDirectory(prefix="ndtpu_serving_") as tmp:
        for name, changes in SERVING_LAYOUT_RUNS:
            t0 = time.perf_counter()
            path = Path(tmp) / f"{name}.json"
            path.write_text(json.dumps(layout_json(SERVING, changes)))
            launches, res, _ = run_serving(dev, card, path, name,
                                           twice=False)
            launches_by[name] = launches
            out[name] = dict(
                changes=changes,
                aggregate_scans_per_s=res["aggregate_scans_per_s"],
                run_s=res["run_s"], first_run_s=res["first_run_s"],
                sessions=serving_gates(res, ref[name]["sessions"], name,
                                       median_of_runs=True),
                launches=launches_nonzero(launches),
                phase_s=time.perf_counter() - t0)
    return launches_by, out


def _moved_graph8(graph8, seed: int):
    """The stacked graphs with each session's 20 newest live poses moved
    by seeded noise (0.05 m, 0.01 rad), so a solve has work to do."""
    import numpy as np
    import torch

    poses = graph8.poses.clone()
    rng = np.random.default_rng(seed + 9)
    for i in range(poses.shape[0]):
        n = int(graph8.n_poses[i])
        lo = max(n - 20, 1)
        noise = rng.normal(0.0, [0.05, 0.05, 0.01], (n - lo, 3))
        poses[i, lo:n] += torch.as_tensor(noise, dtype=poses.dtype,
                                          device=poses.device)
    return graph8._replace(poses=poses)


#: K6b, counted as K6's per session (pcg_solve.cu), with max_iter fixed.
def check_k6b(state8, cfg, seed: int, jobs=None):
    """K6b against its plain version ``pcg_solve_blocked_ref`` in f32 on
    the card and in f64 on the CPU, on the flat graph of the serving run's
    8 sessions (1,280 pose and 2,560 factor slots; each session's newest
    poses moved): within rtol 1e-4 of each reference's max, session by
    session; bit-identical on a second launch; a session with a zero
    right-hand side (its factors masked off) stays at x = 0 with no NaN;
    each session bit-equal to the single-session K6 launch it replaces
    (tol = 0, the same iteration count), and timed beside those 8
    launches."""
    import torch

    from ndtpu_torch import kernels
    from ndtpu_torch.dist import slam_dp
    from ndtpu_torch.graph import factors as fct
    from ndtpu_torch.graph import solve as slv

    scfg, huber = cfg.solver, cfg.solver.huber_delta
    graph8 = _moved_graph8(state8.graph, seed)
    s, v = graph8.poses.shape[:2]
    flat = slam_dp._flat_graph(graph8)
    lin = fct.linearize(flat, huber)
    lam8 = state8.sm_lam.contiguous()
    it = scfg.pcg_max_iter
    run = lambda: slv.pcg_solve_blocked(flat, lin, None, lam8, s, it)
    x, again = run(), run()
    ref32 = slv.pcg_solve_blocked_ref(flat, lin, None, lam8, s, it)
    lin64 = tuple(tuple(t.cpu().double() for t in part) for part in lin)
    ref64 = slv.pcg_solve_blocked_ref(graph_on(flat, "cpu", torch.float64),
                                      lin64, None, lam8.cpu().double(), s, it)
    torch.cuda.synchronize()
    require(bits_equal(x, again), "K6b: two launches differ")
    require(bool(torch.isfinite(x).all()), "K6b: x not finite")
    xc = x.cpu().double()
    err64 = err32 = 0.0
    for i in range(s):
        sl = slice(i * v, (i + 1) * v)
        for name, ref in (("f64", ref64), ("f32", ref32.cpu().double())):
            e = float((xc[sl] - ref[sl]).abs().max())
            scale = float(ref[sl].abs().max())
            require(e <= 1e-4 * scale + 1e-12, f"K6b session {i}: {e:.3e} "
                    f"off the {name} plain version (rtol 1e-4 x {scale:.3e})")
        err64 = max(err64, float((xc - ref64).abs().max()))
        err32 = max(err32, float((xc - ref32.cpu().double()).abs().max()))
    # Session 0 idle: no live factor or prior, so its rhs is 0.
    idle = flat._replace(bet_mask=flat.bet_mask.clone(),
                         prior_mask=flat.prior_mask.clone())
    idle.bet_mask[:graph8.bet_mask.shape[1]] = False
    idle.prior_mask[:graph8.prior_mask.shape[1]] = False
    lin_idle = fct.linearize(idle, huber)
    xi = slv.pcg_solve_blocked(idle, lin_idle, None, lam8, s, it)
    torch.cuda.synchronize()
    require(bool(torch.isfinite(xi).all()) and float(xi[:v].abs().max())
            == 0.0, "K6b: a zero right-hand side did not stay at x = 0")
    require(bits_equal(xi[v:], x[v:]),
            "K6b: an idle session changed the others' solves")
    # The launches K6b replaces: one K6 per session, fixed iterations.
    singles = [slam_dp._take(graph8, i) for i in range(s)]
    singles = [(g, fct.linearize(g, huber), lam8[i].contiguous())
               for i, g in enumerate(singles)]

    def single():
        return [kernels.pcg_solve(g.bet_i, g.bet_j, g.bet_mask, g.prior_idx,
                                  g.prior_mask, g.pose_mask, lg, None, lam,
                                  it, 0.0)[0]
                for g, lg, lam in singles]

    xs = single()
    torch.cuda.synchronize()
    for i, xi_ in enumerate(xs):
        require(bits_equal(xi_, x[i * v:(i + 1) * v]),
                f"K6b session {i}: not bit-equal to its own K6 launch")
    ms = time_ms(run)
    plain = time_ms(lambda: slv.pcg_solve_blocked_ref(flat, lin, None, lam8,
                                                      s, it), reps=5)
    single_ms = time_ms(single)
    f = flat.bet_i.shape[0]
    p = flat.prior_idx.shape[0]
    live = int(flat.bet_mask.sum())
    live_v = int(flat.pose_mask.sum())
    bd = bound(f + live * 100 + p * 57 + s * v + s * v * 12 + 4 * s,
               live * (K6_SETUP_FACTOR + it * K6_ITER_FACTOR)
               + live_v * (K6_SETUP_POSE + it * K6_ITER_POSE))
    print(f"[smoke] K6b pcg_solve_blocked S={s} x V={v} ({live_v} live) F="
          f"{f} ({live} live), {it} iterations: vs f64 plain max abs err "
          f"{err64:.3e}, vs f32 plain {err32:.3e} (rtol 1e-4 of each "
          f"session's max); bit-identical on a second launch and, session "
          f"by session, to its own K6 launch; an idle "
          f"session stays at 0; kernel {ms:.4f} ms, plain {plain:.4f} ms, "
          f"{s} single K6 launches {single_ms:.4f} ms, bound "
          f"{bd['bound_ms']:.6f} ms ({bd['bound_by']})")
    row = dict(max_abs_err=err64, max_abs_err_f32_plain=err32, ms=ms,
               plain_ms=plain, single_launches_ms=single_ms, sessions=s,
               iterations=it, **bd)
    card_time(jobs, "K6b pcg_solve_blocked", row, "card_ms", run,
              ["pcg_solve"], per_call=1)
    card_time(jobs, f"{s} single K6 launches", row,
              "single_launches_card_ms", single, ["pcg_solve"], per_call=s)
    return row


def _k3s_case(label, stats8, pts, msk, wt, grid, jobs):
    """One K3s shape, at the grid's overlap: bit-equal to S single K3
    launches, to the plain model of its fixed-point arithmetic per map
    (``halfcell_add_fixed_ref``) and on a second launch; event, card,
    single-launch and plain times; the bound."""
    import torch

    from ndtpu_torch import kernels
    from ndtpu_torch.dist.slam_dp import _take
    from ndtpu_torch.ndt import grid as ndt_grid

    s, m = msk.shape
    name = kernels.variant("K3s halfcell_add_stacked", grid.overlap)
    per_point = isinstance(wt, torch.Tensor)
    run = lambda: kernels.halfcell_add_stacked(stats8.n, stats8.s, stats8.ss,
                                               pts, msk, wt, grid)

    def single():
        return [kernels.halfcell_add(*_take(stats8, i), pts[i], msk[i],
                                     wt[i] if per_point else wt, grid)
                for i in range(s)]

    out, again = run(), run()
    ones = tuple(torch.stack(f) for f in zip(*single()))
    model = tuple(torch.stack(f) for f in zip(*(
        ndt_grid.halfcell_add_fixed_ref(_take(stats8, i), pts[i], msk[i],
                                        wt[i] if per_point else wt, grid)
        for i in range(s))))
    torch.cuda.synchronize()
    require(bits_equal(out, again), f"{name} {label}: two launches differ")
    require(bits_equal(out, ones),
            f"{name} {label}: not bit-equal to {s} single K3 launches")
    require(bits_equal(out, model),
            f"{name} {label}: not bit-equal to the fixed-point model")
    ms = time_ms(run)
    plain = time_ms(lambda: ndt_grid.halfcell_add_stacked_ref(
        stats8, pts, msk, wt, grid))
    single_ms = time_ms(single)
    one = k3_bound(m, grid)
    bd = k3_bound(m, grid, maps=s, per_point=per_point)
    print(f"[smoke] {name} {label} S={s} x M={m}: bit-equal to {s} single "
          f"K3 launches, to the fixed-point model and on a second launch; "
          f"kernel {ms:.4f} ms, {s} single K3 {single_ms:.4f} ms, plain "
          f"{plain:.4f} ms, bound {bd['bound_ms']:.6f} ms ({bd['bound_by']}; "
          f"one map's {one['bound_ms']:.6f})")
    row = dict(max_abs_err=0.0, ms=ms, plain_ms=plain,
               single_launches_ms=single_ms, m=m, **bd)
    card_time(jobs, f"{name} {label}", row, "card_ms", run,
              ["halfcell", "cell_moments", "Memset"], per_call=3)
    card_time(jobs, f"{s} single K3 {label} (G={grid.overlap})", row,
              "single_launches_card_ms", single,
              ["halfcell", "cell_moments", "Memset"], per_call=3 * s)
    return row


def check_k3s(state8, cfg, jobs=None):
    """K3s at the serving path's two shapes, on the serving run's 8 maps:
    a window's 8 keyframe scans per session (2,880 points, the pass-2 maps
    and the extend) and the top-12 refresh (8,640 points, -1 at the old
    pose and +1 at a moved one). Bit-equal to 8 single K3 launches and on a
    second launch; timed beside them and the plain twin."""
    import torch

    from ndtpu_torch.lie import se2

    grid, kf, stats8 = cfg.grid, state8.kf, state8.stats
    s = stats8.n.shape[0]
    w, m_top = cfg.window, cfg.refresh_top_m
    win = se2.transform(kf.poses[:, :w], kf.points[:, :w]).reshape(s, -1, 2)
    win_m = kf.masks[:, :w].reshape(s, -1)
    old = se2.transform(kf.poses[:, :m_top], kf.points[:, :m_top])
    moved = kf.poses[:, :m_top] + torch.tensor([0.02, -0.01, 0.003],
                                               device=kf.poses.device)
    new = se2.transform(moved, kf.points[:, :m_top])
    ref_pts = torch.cat([old.reshape(s, -1, 2), new.reshape(s, -1, 2)], 1)
    ref_m = kf.masks[:, :m_top].reshape(s, -1).repeat(1, 2)
    half = old.shape[1] * old.shape[2]
    wts = torch.cat([-torch.ones(s, half, device=ref_pts.device),
                     torch.ones(s, half, device=ref_pts.device)], 1)
    rows = {label: _k3s_case(label, stats8, pts.contiguous(),
                             msk.contiguous(), weight, grid, jobs)
            for label, pts, msk, weight in (
                ("window", win, win_m, 1.0),
                ("refresh", ref_pts, ref_m, wts.contiguous()))}
    row = rows["window"]
    row["refresh"] = rows["refresh"]
    return row


def check_k4s(state8, cfg, jobs=None, stats8=None, grid=None,
              compact: bool = False):
    """K4s on 8 maps (the serving run's, 57 x 57 lattice, 3,249 rows each;
    or ``stats8`` on ``grid``) in the layout (``grid.overlap``,
    ``compact``): bit-equal to 8 single K4 launches of the layout (compact
    lanes compared as int32) and on a second launch; valid flags exact
    (compact bf16-pair lanes bit-equal) and the rest within K4's rtol 1e-5
    of the plain twin; timed beside the single launches and the twin."""
    import torch

    from ndtpu_torch import kernels
    from ndtpu_torch.dist.slam_dp import _take
    from ndtpu_torch.ndt import grid as ndt_grid

    grid = grid or cfg.grid
    stats8 = state8.stats if stats8 is None else stats8
    layout = kernels._layout(grid, compact)
    name = kernels.variant("K4s finalize_pack_stacked", *layout)
    s = stats8.n.shape[0]
    run = lambda: kernels.finalize_pack_stacked(stats8.n, stats8.s,
                                                stats8.ss, cfg.ndt, grid,
                                                compact)

    def single():
        return [kernels.finalize_pack(*_take(stats8, i), cfg.ndt, grid,
                                      compact) for i in range(s)]

    out, again = run(), run()
    ones = torch.stack(single())
    ref = ndt_grid.finalize_pack_stacked_ref(stats8, cfg.ndt, grid, compact)
    torch.cuda.synchronize()
    as_int = lambda t: t.view(torch.int32)
    require(bits_equal(as_int(out), as_int(again)),
            f"{name}: two launches differ")
    require(bits_equal(as_int(out), as_int(ones)),
            f"{name}: not bit-equal to {s} single K4 launches (int32)")
    err = max(_table_check(f"{name} map {i}", out[i], ref[i], layout)
              for i in range(s))
    ms = time_ms(run)
    plain = time_ms(lambda: ndt_grid.finalize_pack_stacked_ref(
        stats8, cfg.ndt, grid, compact))
    single_ms = time_ms(single)
    one = k4_bound(grid, compact)
    rows = out.shape[1]
    bd = bound(s * one["bytes"], s * one["operations"])
    print(f"[smoke] {name} S={s} x R={rows} x {out.shape[2]} lanes: "
          f"bit-equal (int32) to {s} single K4 launches and on a second "
          f"launch, vs the twin max abs err {err:.3e} (valid exact"
          f"{', bf16-pair lanes bit-equal' if compact else ''}, rtol 1e-5); "
          f"kernel {ms:.4f} ms, {s} single K4 {single_ms:.4f} ms, plain "
          f"{plain:.4f} ms, bound {bd['bound_ms']:.6f} ms ({bd['bound_by']}; "
          f"one map's {one['bound_ms']:.6f})")
    row = dict(max_abs_err=err, ms=ms, plain_ms=plain,
               single_launches_ms=single_ms, **bd)
    card_time(jobs, name, row, "card_ms", run, ["finalize_pack"],
              per_call=1)
    card_time(jobs, f"{s} single K4 ({name})", row,
              "single_launches_card_ms", single, ["finalize_pack"],
              per_call=s)
    return row


def check_stacked_layouts(state8, cfg, jobs=None):
    """K3s and K4s in the other table layouts, on the serving run's 8
    sessions (phase 11): each session's live keyframe points put onto an
    empty overlap-1 map by K3s[g1] (the rebuild shape; bit-equal to 8
    single K3[g1] launches and to the fixed-point model), then K3s[g1] at
    the window and refresh shapes on those maps (:func:`check_k3s`), and
    K4s in g1l8 and g1l4 on them and in g4l4 on the run's own overlap-4
    maps (:func:`check_k4s`). Returns the rows by counter name."""
    import dataclasses

    import torch

    from ndtpu_torch import kernels
    from ndtpu_torch.lie import se2
    from ndtpu_torch.ndt import grid as ndt_grid

    kf = state8.kf
    s = kf.poses.shape[0]
    g1 = dataclasses.replace(cfg.grid, overlap=1)
    empty = ndt_grid.NDTStats(*(x.expand((s,) + x.shape).contiguous() for x in
                                ndt_grid.empty_stats(g1, torch.float32,
                                                     kf.poses.device)))
    world = se2.transform(kf.poses, kf.points).reshape(s, -1, 2)
    live = (kf.masks & kf.live[..., None]).reshape(s, -1)
    rows = {}
    k3s = kernels.variant("halfcell_add_stacked", 1)
    rebuild = _k3s_case("rebuild", empty, world.contiguous(),
                        live.contiguous(), 1.0, g1, jobs)
    stats1 = ndt_grid.halfcell_add_stacked(empty, world, live, 1.0, g1)
    cfg1 = dataclasses.replace(cfg, grid=g1)
    rows[k3s] = check_k3s(state8._replace(stats=stats1), cfg1, jobs)
    rows[k3s]["rebuild"] = rebuild
    for g, lanes in kernels.LAYOUTS[1:]:
        grid, st = (g1, stats1) if g == 1 else (cfg.grid, state8.stats)
        rows[kernels.variant("finalize_pack_stacked", g, lanes)] = check_k4s(
            state8, cfg, jobs, stats8=st, grid=grid, compact=lanes == 4)
    return rows



# --------------------------------------------------------------------------
# Input preparation (K11, K13; phase 3) and the per-scan path (phase 16).

#: K11's tolerances: f64 ranges against the f64 plain version (m); f32
#: ranges against the f32 plain version (m), and the share of beams that
#: may exceed it (a beam grazing a segment's end may pick the wall behind
#: when its f32 sin/cos differ in the last bit).
K11_F64_TOL = 1e-9
K11_F32_TOL = 1e-3
K11_F32_OUTLIERS = 1e-4
#: Operations per (pose, beam, segment) of K11 (``csrc/raycast.cu``): the
#: denominator (3), the two numerators (6), two divisions, the four tests,
#: the select and the min.
K11_FLOPS = 18
#: f32 operations per point of K13's quantize and pack; the hash table's
#: probes and the id comparisons run from shared memory and are not
#: counted (the bound is by bytes).
K13_POINT_FLOPS = 12
#: K13 past its table route (``kernels.voxel_route``): seeded scans of this
#: many points (+-15 m, 10% masked out), 0.1 m.
K13_PAST = dict(scans=8, points=20_000, voxel=0.1)
#: The CLI's synthetic corridor (``run._build_inputs``).
CORRIDOR_SCANS = 600


def cli_inputs(config, n_scans: int, device):
    """The CLI's synthetic inputs on ``device`` (``run._build_inputs``: the
    corridor world, simulated there) as a ``Sequence2D``."""
    import argparse as ap

    from ndtpu_torch import run
    from ndtpu_torch.config import PipelineConfig
    from ndtpu_torch.data import synth

    cfg = PipelineConfig.from_json(str(config))
    p, m, o, gt = run._build_inputs(ap.Namespace(dataset=None,
                                                 max_scans=n_scans), cfg,
                                    device)
    return synth.Sequence2D(points=p, mask=m, odom=o, gt_poses=gt,
                            angles=None)


#: K11 past the old 48 KB limit (1,536 segments in f64): the box world of
#: half 40 m and 1,000 square pillars (4,004 segments), 64 poses.
K11_MANY = dict(half=40.0, pillars=1000, seed=3, poses=64)


def pillar_segments(half: float, pillars: int, seed: int):
    """``[4 + 4 pillars, 2, 2]`` f64 numpy segments: the box world's four
    walls and ``pillars`` axis-aligned squares (sides 0.2-0.6 m) centred
    uniformly within it, from a numpy seed."""
    import numpy as np

    rng = np.random.default_rng(seed)
    h = half
    box = [[[-h, -h], [h, -h]], [[h, -h], [h, h]], [[h, h], [-h, h]],
           [[-h, h], [-h, -h]]]
    c = rng.uniform(-h + 1.0, h - 1.0, (pillars, 2))
    e = rng.uniform(0.1, 0.3, (pillars, 1))
    corners = [c + e * np.array(d) for d in ((-1, -1), (1, -1), (1, 1),
                                             (-1, 1))]
    sides = [np.stack([corners[i], corners[(i + 1) % 4]], 1)
             for i in range(4)]
    pil = np.stack(sides, 1).reshape(-1, 2, 2)
    return np.concatenate([np.asarray(box, np.float64), pil])


def k11_inputs(kind: str, dtype, dev):
    """``(world, poses, angles)`` on ``dev`` in ``dtype``: the CLI's corridor
    run (600 poses x 360 beams x 36 segments), serving's 8 sessions x 300
    box-world poses (x 17 segments), or :data:`K11_MANY`'s pillars (64
    poses of a box lap x 360 beams x 4,004 segments)."""
    import torch

    from ndtpu_torch.data import synth

    if kind == "corridor":
        world = synth.corridor_loop_world(outer=18.0, width=5.0)
        poses = synth.rectangle_trajectory(CORRIDOR_SCANS, half=15.0,
                                           step=0.25)
    elif kind == "serving":
        world = synth.box_world(half=11.0)
        poses = torch.stack([synth.rectangle_trajectory(
            300, half=6.0 + 0.2 * k, step=0.2) for k in range(8)])
    else:
        m = K11_MANY
        world = synth.World(torch.as_tensor(pillar_segments(
            m["half"], m["pillars"], m["seed"])))
        poses = synth.rectangle_trajectory(m["poses"], half=7.0, step=0.85)
    ang = synth.beam_angles(360, dtype=torch.float64)
    return (synth.World(world.segments.to(dev, dtype)),
            poses.to(dev, dtype), ang.to(dev, dtype))


def k11_bound(poses, angles, segments) -> dict:
    """Poses, angles and segments read, ranges written; K11_FLOPS per (pose,
    beam, segment) at the f64 (or f32) peak."""
    import torch

    p, n, s = poses.numel() // 3, angles.numel(), segments.shape[0]
    b = poses.element_size()
    f64 = poses.dtype == torch.float64
    return bound(b * (3 * p + n + 4 * s + p * n), K11_FLOPS * p * n * s,
                 F64_FLOP_S if f64 else F32_FLOP_S)


def raycast_cpu(world, poses, ang, max_range: float, chunk: int = 8):
    """K11's plain version on the CPU, ``chunk`` poses at a time (its [...,
    N, S] intermediates stay small at thousands of segments)."""
    import torch

    from ndtpu_torch.data import synth

    w = synth.World(world.segments.cpu())
    p, a = poses.cpu(), ang.cpu()
    flat = p.reshape(-1, 3)
    out = torch.cat([synth.raycast_ref(w, flat[i:i + chunk], a, max_range)
                     for i in range(0, flat.shape[0], chunk)])
    return out.reshape(p.shape[:-1] + a.shape)


#: K11's cases: (name, inputs, dtype). f64 is make_sequence's type; f32 at
#: 36, 17 and 4,004 segments.
K11_CASES = (("corridor", "corridor", "float64"),
             ("serving", "serving", "float64"),
             ("corridor_f32", "corridor", "float32"),
             ("serving_f32", "serving", "float32"),
             ("pillars", "pillars", "float64"),
             ("pillars_f32", "pillars", "float32"))


def check_k11(dev, jobs=None):
    """K11 ``raycast`` (``synth.raycast`` on CUDA tensors) against its plain
    version on the CPU, for each of :data:`K11_CASES`: in f64 hits
    identical and within K11_F64_TOL, in f32 hits and K11_F32_TOL but for
    K11_F32_OUTLIERS of the beams; bit-identical on a second launch.
    Returns the row (the corridor's f64 case; the others under their
    names)."""
    import torch

    from ndtpu_torch.data import synth

    row = {}
    for name, kind, dt in K11_CASES:
        dt = getattr(torch, dt)
        world, poses, ang = k11_inputs(kind, dt, dev)
        # Bound now: the corridor's card time is read after the loop.
        run = lambda w=world, p=poses, a=ang: synth.raycast(w, p, a, 20.0)
        out, again = run(), run()
        ref = raycast_cpu(world, poses, ang, 20.0)
        torch.cuda.synchronize()
        require(bits_equal(out, again), f"K11 {name}: two launches differ")
        o = out.cpu()
        hits = int(((o < 20.0) != (ref < 20.0)).sum())
        d = (o - ref).abs()
        err = float(d.max())
        if dt == torch.float64:
            require(hits == 0 and err <= K11_F64_TOL,
                    f"K11 {name}: {hits} hit flags differ, max abs err "
                    f"{err:.3e} m (<= {K11_F64_TOL:g} required)")
            over = 0
        else:
            over = int((d > K11_F32_TOL).sum())
            require(over <= K11_F32_OUTLIERS * d.numel(),
                    f"K11 {name}: {over} of {d.numel()} beams off by more "
                    f"than {K11_F32_TOL:g} m ({hits} hit flags differ)")
        bd = k11_bound(poses, ang, world.segments)
        ms = time_ms(run)
        plain_ms = time_ms(lambda: synth.raycast_ref(world, poses, ang,
                                                     20.0))
        print(f"[smoke] K11 raycast {name} {tuple(out.shape)} x "
              f"{world.segments.shape[0]} segments: vs {dt} plain (CPU) max "
              f"abs err {err:.3e} m, {hits} hit flags differ, {over} beams "
              f"past {K11_F32_TOL:g} m; bit-identical on a second launch; "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
              f"{bd['bound_ms']:.6f} ms ({bd['bound_by']})")
        case = dict(max_abs_err=err, hit_flags_differ=hits, ms=ms,
                    plain_ms=plain_ms, **bd)
        if name == "corridor":
            row.update(case)
            card_time(jobs, "K11 raycast corridor f64", row, "card_ms", run,
                      ["raycast"], per_call=1)
        else:
            row[name] = case
    return row


def check_k13(dev, jobs=None):
    """K13 ``voxel_downsample`` on the CLI's 600 x 360 corridor scans at
    0.05 / 0.1 / 0.5 m: masks bit-equal to its plain version's (CPU) and on
    a second launch. Returns the row (times at 0.1 m)."""
    import torch

    from ndtpu_torch.data import preprocess

    seq = cli_inputs(CONFIG3, CORRIDOR_SCANS, dev)
    p, m = seq.points, seq.mask
    row = dict(max_abs_err=0.0, kept={})
    for voxel in (0.05, 0.1, 0.5):
        # Bound now: the card time at 0.1 m is read after the loop.
        run = lambda v=voxel: preprocess.voxel_downsample(p, m, v)
        out, again = run(), run()
        ref = preprocess.voxel_downsample_ref(p.cpu(), m.cpu(), voxel)
        torch.cuda.synchronize()
        require(torch.equal(out, again), f"K13 {voxel} m: two launches "
                f"differ")
        n_diff = int((out.cpu() != ref).sum())
        require(n_diff == 0, f"K13 {voxel} m: {n_diff} mask entries differ "
                f"from the plain version's")
        row["kept"][str(voxel)] = int(ref.sum())
        if voxel == 0.1:
            row["ms"] = time_ms(run)
            row["plain_ms"] = time_ms(
                lambda: preprocess.voxel_downsample_ref(p, m, voxel))
            n = m.numel()
            row.update(bound(10 * n, K13_POINT_FLOPS * n))
            card_time(jobs, "K13 voxel_downsample 0.1 m", row, "card_ms",
                      run, ["voxel_downsample"])
    print(f"[smoke] K13 voxel_downsample {tuple(m.shape)} "
          f"({int(m.sum())} valid): kept {row['kept']} (0.05 / 0.1 / 0.5 m), "
          f"masks bit-equal to the plain version's and on a second launch; "
          f"kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, bound "
          f"{row['bound_ms']:.6f} ms ({row['bound_by']})")
    return row


def check_k13_scan(dev, jobs=None):
    """K13's scan route on :data:`K13_PAST`'s scans, past the table route's
    shared memory, through ``preprocess.voxel_downsample`` with the launch
    counts reset: bit-equal to its plain version (CPU) and on a second
    launch. Returns ``(launches, row)``."""
    import numpy as np
    import torch

    from ndtpu_torch import kernels
    from ndtpu_torch.data import preprocess

    t, n, voxel = K13_PAST["scans"], K13_PAST["points"], K13_PAST["voxel"]
    require(kernels.voxel_route(n) == "scan",
            f"K13: {n} points take the table route, not the scan route")
    rng = np.random.default_rng(n)
    p = torch.as_tensor(rng.uniform(-15.0, 15.0, (t, n, 2)),
                        dtype=torch.float32, device=dev)
    m = torch.as_tensor(rng.random((t, n)) > 0.1, device=dev)
    run = lambda: preprocess.voxel_downsample(p, m, voxel)
    kernels.reset_launches()
    out = run()
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    again = run()
    ref = preprocess.voxel_downsample_ref(p.cpu(), m.cpu(), voxel)
    require(torch.equal(out, again), "K13 scan route: two launches differ")
    n_diff = int((out.cpu() != ref).sum())
    require(n_diff == 0, f"K13 scan route: {n_diff} mask entries differ from "
            f"the plain version's")
    row = dict(max_abs_err=0.0, kept=int(ref.sum()), ms=time_ms(run),
               plain_ms=time_ms(lambda: preprocess.voxel_downsample_ref(
                   p, m, voxel)),
               **bound(10 * t * n, K13_POINT_FLOPS * t * n))
    card_time(jobs, "K13 voxel_downsample[scan]", row, "card_ms", run,
              ["voxel_downsample"], per_call=1)
    print(f"[smoke] K13 voxel_downsample[scan] {tuple(m.shape)} at {voxel} "
          f"m: kept {row['kept']}, mask bit-equal to the plain version's and "
          f"on a second launch; kernel {row['ms']:.4f} ms, plain "
          f"{row['plain_ms']:.4f} ms, bound {row['bound_ms']:.6f} ms "
          f"({row['bound_by']})")
    return launches, row


#: K14's cases on the card: (label, sessions, capacity, the loop entry's
#: queries x candidates or None, counters near the capacities). Configs 2
#: and 3 run one session at the published capacity, serving 8 of
#: ``config_serving.json``'s; the last fills the pose, factor and loop
#: capacities.
K14_CASES = (("config2", 1, 1024, None, False),
             ("config3", 1, 1024, (4, 16), False),
             ("serving", 8, 512, (4, 4), False),
             ("overflow", 3, 1024, (4, 16), True))
#: K14's tolerance on the values it computes (node values, odometry
#: measurements and sqrt-information, relative poses): |kernel - plain| <=
#: K14_RTOL x max(1, |plain|), both in f32 on the card. Indices, masks,
#: counters and copied rows must be bit-equal.
K14_RTOL = 1e-5
K14_OUTS = ("graph.poses", "graph.pose_mask", "graph.bet_i", "graph.bet_j",
            "graph.bet_z", "graph.bet_sqrt_info", "graph.bet_mask",
            "graph.n_poses", "graph.n_between", "kf.poses", "kf.points",
            "kf.masks", "kf.live", "kf.n", "map_kf_poses", "slot", "ok",
            "cum", "kslot", "node_vals", "last_idx", "lkr", "any_kf",
            "kf_idx_out", "rel_out", "nd_out")
K14_COMPUTED = ("graph.poses", "graph.bet_z", "graph.bet_sqrt_info",
                "kf.poses", "node_vals", "rel_out")
K14_LOOP_OUTS = ("bet_i", "bet_j", "bet_z", "bet_sqrt_info", "bet_mask",
                 "n_between", "nl", "ld", "ni")
#: The refresh's rows a session (``serving_config``'s ``refresh_top_m``).
K14_REFRESH_ROWS = 12


def k14_inputs(seed: int, dev, sessions: int, cap: int, full: bool,
               n_beams: int = 360, w: int = 8) -> tuple:
    """Seeded stacked state and window for K14 (f32 on ``dev``): ``cap``
    pose and keyframe slots, ``2 cap`` factor slots, counters a quarter to
    a half full (or a few slots short of full with ``full``), poses over an
    80 m square, registration Hessians of NDT scale. The 22 arguments of
    ``kernels.window_append``."""
    import math

    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    s, v, f = sessions, cap, 2 * cap
    if full:
        n0 = v - rng.integers(1, 5, s)
        nb0 = f - rng.integers(1, 6, s)
    else:
        n0 = rng.integers(cap // 4, cap // 2, s)
        nb0 = 2 * n0 - rng.integers(0, 3, s)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    i64 = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=dev)
    b8 = lambda a: torch.as_tensor(np.asarray(a, bool), device=dev)

    def poses(shape):
        p = rng.uniform(-40.0, 40.0, shape + (3,))
        p[..., 2] = rng.uniform(-math.pi, math.pi, shape)
        return p

    a = rng.normal(0.0, 30.0, (s, w, 3, 3))
    hess = a @ np.swapaxes(a, -1, -2) + 10.0 * np.eye(3)
    return (f32(poses((s, v))), b8(np.arange(v) < n0[:, None]),
            i64(rng.integers(0, v, (s, f))), i64(rng.integers(0, v, (s, f))),
            f32(rng.normal(0.0, 1.0, (s, f, 3))),
            f32(rng.normal(0.0, 5.0, (s, f, 3, 3))),
            b8(np.arange(f) < nb0[:, None]), i64(n0), i64(nb0),
            f32(poses((s, v))), f32(rng.normal(0.0, 8.0, (s, v, n_beams, 2))),
            b8(rng.random((s, v, n_beams)) < 0.9),
            b8(np.arange(v) < n0[:, None]), i64(n0), f32(poses((s, v))),
            i64(n0 - 1), f32(poses((s,))), f32(poses((s, w))), f32(hess),
            f32(rng.normal(0.0, 8.0, (s, w, n_beams, 2))),
            b8(rng.random((s, w, n_beams)) < 0.9),
            b8(rng.random((s, w)) < (0.9 if full else 0.4)))


def k14_loop_inputs(seed: int, out, lanes, w: int = 8) -> tuple:
    """The loop entry's arguments on K14's output ``out``: ``lanes = (K,
    C)`` seeded lanes (60% accepted), queries at seeded scans."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    s, v = out[0].shape[:2]
    kq, c = lanes
    dev = out[0].device
    t = lambda a, dt=None: torch.as_tensor(np.asarray(a, dt), device=dev)
    acc = rng.random((s, kq, c)) < 0.6
    return (out[2], out[3], out[4], out[5], out[6], out[8], t(acc),
            t(rng.integers(0, v, (s, kq, c)), np.int64),
            t(rng.normal(0.0, 1.0, (s, kq, c, 3)), np.float32),
            t(rng.normal(0.0, 5.0, (s, kq, c, 3, 3)), np.float32),
            t(~acc & (rng.random((s, kq, c)) < 0.5)),
            t(rng.integers(0, v, (s, kq)), np.int64),
            t(rng.integers(0, w, (s, kq)), np.int64),
            t(rng.random((s, kq)) < 0.8))


def k14_rows_inputs(seed: int, out) -> tuple:
    """The row entry's arguments on K14's output ``out`` at serving's
    refresh shape: ``map_kf_poses`` with :data:`K14_REFRESH_ROWS` distinct
    seeded rows a session (70% kept) set to their ``kf.poses`` rows."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    mkp, kf_poses = out[14], out[9]
    s, cap = mkp.shape[:2]
    m, dev = K14_REFRESH_ROWS, mkp.device
    sel = torch.as_tensor(np.stack([rng.permutation(cap)[:m]
                                    for _ in range(s)]), device=dev)
    do = torch.as_tensor(rng.random((s, m)) < 0.7, device=dev)
    src = torch.gather(kf_poses, 1, sel[..., None].expand(-1, -1, 3))
    return mkp, sel, do, src


def k14_compare(label, out, ref, names, computed=()) -> tuple:
    """K14's outputs against the plain version's on the same card inputs:
    ``computed`` fields within :data:`K14_RTOL`, every other one bit-equal.
    Returns ``(max abs error, all bit-equal)``."""
    import torch

    err, bit = 0.0, True
    for name, a, b in zip(names, out, ref):
        require(a.shape == b.shape and a.dtype == b.dtype,
                f"K14 {label}: {name} {tuple(a.shape)} {a.dtype} against "
                f"{tuple(b.shape)} {b.dtype}")
        same = bits_equal(a, b)
        if name in computed:
            d = (a - b).abs()
            require(bool(torch.isfinite(a).all())
                    and bool((d <= K14_RTOL * b.abs().clamp(min=1.0)).all()),
                    f"K14 {label}: {name} off the plain version by "
                    f"{float(d.max()):.3g}")
            err = max(err, float(d.max()))
            bit &= same
        else:
            require(same, f"K14 {label}: {name} not bit-equal to the plain "
                    f"version")
    return err, bit


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def check_k14(seed: int, dev, jobs=None) -> dict:
    """K14 ``window_append`` against ``window_append_ref`` on the card at
    :data:`K14_CASES` (the same f32 inputs; :func:`k14_compare`), also
    bit-identical on a second launch; its loop entry against
    ``loop_append_ref`` where the case has lanes, and its row entry against
    ``set_rows_ref`` at serving's refresh shape. Each timed beside its
    plain version (events), with its card time and bytes bound. Returns the
    three rows (config 3's shapes for the appends and the loop entry, the
    other cases under ``cases``)."""
    import torch

    from ndtpu_torch import kernels
    from ndtpu_torch.slam import appends

    rows = {"window_append": {}, "window_append[loops]": {},
            "window_append[rows]": {}}
    for i, (label, s, cap, lanes, full) in enumerate(K14_CASES):
        args = k14_inputs(seed + i, dev, s, cap, full)
        run = lambda a=args: kernels.window_append(*a)
        out, again = run(), run()
        ref = appends.window_append_ref(*args)
        torch.cuda.synchronize()
        require(bits_equal(out, again), f"K14 {label}: two launches differ")
        err, bit = k14_compare(label, out, ref, K14_OUTS, K14_COMPUTED)
        row = dict(max_abs_err=err, bit_equal=bit, sessions=s, capacity=cap,
                   kept=int(out[16].sum()), dropped=int(out[25].sum()),
                   ms=time_ms(run),
                   plain_ms=time_ms(lambda a=args:
                                    appends.window_append_ref(*a)),
                   **bound(_nbytes(args) + _nbytes(out), 0))
        card_time(jobs, f"K14 window_append {label}", row, "card_ms", run,
                  ["window_append_kernel"], per_call=1)
        rows["window_append"][label] = row
        line = (f"[smoke] K14 window_append {label} (S={s}, {cap} slots): "
                f"{row['kept']} kept, {row['dropped']} dropped, values "
                f"within {err:.3g} of the plain version "
                f"({'bit-equal' if bit else f'rtol {K14_RTOL}'}), the rest "
                f"bit-equal, and on a second launch; kernel "
                f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, bound "
                f"{row['bound_ms']:.6f} ms ({row['bound_by']})")
        if lanes:
            largs = k14_loop_inputs(seed + i, out, lanes)
            lrun = lambda a=largs: kernels.loop_append(*a, 8)
            lout, lagain = lrun(), lrun()
            lref = appends.loop_append_ref(*largs, 8)
            torch.cuda.synchronize()
            require(bits_equal(lout, lagain),
                    f"K14 loops {label}: two launches differ")
            k14_compare(f"loops {label}", lout, lref, K14_LOOP_OUTS)
            lrow = dict(max_abs_err=0.0, bit_equal=True,
                        appended=int((lout[5] - largs[5]).sum()),
                        dropped=int(lout[7].sum()), ms=time_ms(lrun),
                        plain_ms=time_ms(lambda a=largs:
                                         appends.loop_append_ref(*a, 8)),
                        **bound(_nbytes(largs) + _nbytes(lout), 0))
            card_time(jobs, f"K14 loop_append {label}", lrow, "card_ms",
                      lrun, ["loop_append_kernel"], per_call=1)
            rows["window_append[loops]"][label] = lrow
            line += (f"; loop entry {lanes[0]} x {lanes[1]} lanes: "
                     f"{lrow['appended']} appended, {lrow['dropped']} "
                     f"dropped, bit-equal, kernel {lrow['ms']:.4f} ms, plain "
                     f"{lrow['plain_ms']:.4f} ms")
        if label == "serving":
            m = K14_REFRESH_ROWS
            mkp, sel, do, src = k14_rows_inputs(seed, out)
            rrun = lambda: kernels.rows_set(mkp, sel, do, src)
            rout = rrun()
            rref = appends.set_rows_ref(mkp, sel, do, src)
            torch.cuda.synchronize()
            require(bits_equal(rout, rrun()) and bits_equal(rout, rref),
                    "K14 rows: not bit-equal to the plain version or on a "
                    "second launch")
            rrow = dict(max_abs_err=0.0, bit_equal=True, rows=m,
                        ms=time_ms(rrun),
                        plain_ms=time_ms(lambda: appends.set_rows_ref(
                            mkp, sel, do, src)),
                        **bound(_nbytes((mkp, sel, do, src, rout)), 0))
            card_time(jobs, "K14 rows_set serving", rrow, "card_ms", rrun,
                      ["rows_set_kernel"], per_call=1)
            rows["window_append[rows]"][label] = rrow
            line += (f"; row entry ({m} rows a session) bit-equal, kernel "
                     f"{rrow['ms']:.4f} ms, plain {rrow['plain_ms']:.4f} ms")
        print(line)
    main = {"window_append": "config3", "window_append[loops]": "config3",
            "window_append[rows]": "serving"}
    out = {}
    for name, label in main.items():
        # The row itself (its card time is filled in later), the other
        # cases under it.
        out[name] = rows[name].pop(label)
        out[name]["cases"] = rows[name]
    return out


#: K15's cases: (label, sessions S, queries K a session, candidates C,
#: store slots, beams, beam stride, radius m, index gap, duplicate poses,
#: every slot live). Config 3's window (its loop config, 1,024 slots) is the
#: row; serving's stacked window (``serving_config``: stride 2, 512
#: slots); equal distances; a full store.
K15_CASES = (("config3", 1, 4, 16, 1024, 360, 1, 5.0, 25, False, False),
             ("serving", 8, 4, 4, 512, 360, 2, 3.0, 10, False, False),
             ("ties", 2, 4, 16, 1024, 360, 1, 5.0, 25, True, False),
             ("full", 1, 4, 16, 1024, 360, 1, 5.0, 25, False, True))
#: K15's outputs, in ``kernels.loop_lanes``' order.
K15_OUTS = ("idx", "mask", "dist", "init", "group", "query_idx", "px", "py",
            "mask_f")


def k15_inputs(seed: int, dev, sessions: int, k: int, c: int, cap: int,
               n_beams: int, stride: int, radius: float, gap: int,
               ties: bool, full: bool, w: int = 8) -> tuple:
    """Seeded stores and windows for K15 (f32 on ``dev``): each session a
    quarter to three quarters full (every slot with ``full``), keyframes
    spread so that ~2 C of them lie within ``radius`` of a query, a quarter
    of them on another's position with ``ties``; ``k`` queries a session at
    seeded rows of a ``w``-scan window, each near a live keyframe, indexed
    past the store's fill. The arguments of ``kernels.loop_lanes``."""
    import math

    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    s = sessions
    fill = (np.full(s, cap) if full
            else rng.integers(cap // 4, 3 * cap // 4, s))
    poses = np.zeros((s, cap, 3))
    for i in range(s):
        side = math.sqrt(math.pi * radius ** 2 * fill[i] / (2.0 * c))
        poses[i, :, :2] = rng.uniform(0.0, side, (cap, 2))
        if ties:
            dup = rng.permutation(fill[i])[:fill[i] // 4]
            poses[i, dup, :2] = poses[i, rng.integers(0, fill[i],
                                                      dup.size), :2]
    poses[..., 2] = rng.uniform(-math.pi, math.pi, (s, cap))
    live = np.arange(cap) < fill[:, None]
    sel = np.stack([rng.permutation(w)[:k] for _ in range(s)])
    wposes = rng.normal(0.0, 5.0, (s, w, 3))
    for i in range(s):
        near = poses[i, rng.integers(0, fill[i], k)]
        wposes[i, sel[i]] = near + rng.normal(0.0, [0.5, 0.5, 0.1], (k, 3))
    qidx = fill[:, None] + np.arange(k)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    return (f32(poses), torch.as_tensor(live, device=dev),
            f32(rng.normal(0.0, 8.0, (s, w, n_beams, 2))),
            torch.as_tensor(rng.random((s, w, n_beams)) < 0.9, device=dev),
            f32(wposes), torch.as_tensor(sel, device=dev),
            torch.as_tensor(qidx, dtype=torch.int64, device=dev),
            radius, gap, c, stride)


def k15_bound(args) -> dict:
    """Bytes: each store (12 B a pose, 1 B a live flag), the queries' rows
    and indices, poses and strided scans (9 B a beam) read once; the
    candidates (13 B each), the lanes' initial poses and groups (16 B) and
    scans (12 B a beam), the queries' offset indices written once.
    Operations: 6 a (query, slot) distance test."""
    poses, live, points, _, _, sel, _, _, _, c, stride = args
    s, cap = live.shape
    k, n = sel.shape[1], points.shape[2]
    q, n_out = s * k, -(-n // stride)
    n_bytes = (s * cap * 13 + q * (16 + 12 + 9 * n_out)
               + q * c * (13 + 16 + 12 * n_out) + q * 8)
    return bound(n_bytes, 6.0 * q * cap)


def k15_library_call(args):
    """K15's library call on :func:`k15_inputs`' ``args``: ``torch.topk(
    d_masked, C, largest=False)`` over the plain version's masked distances
    (computed here, outside the call): the search alone, its order among
    equal distances not guaranteed."""
    import torch

    poses, live, _, _, wposes, sel, qidx, radius, gap, c = args[:10]
    s, cap = live.shape
    qp = torch.gather(wposes, 1, sel[..., None].expand(-1, -1, 3))
    dx = poses[:, None, :, 0] - qp[..., 0, None]
    dy = poses[:, None, :, 1] - qp[..., 1, None]
    d = torch.sqrt(dx * dx + dy * dy)
    slots = torch.arange(cap, device=poses.device)
    ok = live[:, None] & (d <= radius) & (qidx[..., None] - slots >= gap)
    dm = torch.where(ok, d, torch.full_like(d, float("inf"))).reshape(
        -1, cap)
    return lambda: torch.topk(dm, c, dim=-1, largest=False)


def check_k15(dev, seed: int, jobs=None) -> dict:
    """K15 ``loop_lanes`` against ``closure.loop_lanes_ref`` on the card at
    :data:`K15_CASES`: all nine outputs bit-equal, and on a second launch;
    with the candidates given (the merge's and the fresh-map verify's
    route) the lanes bit-equal to the search's. Each case timed beside its
    plain version (events), with its card time, its bound and the library
    call ``torch.topk(d_masked, C, largest=False)`` on the twin's masked
    distances (events and card; its order among equal distances is not
    guaranteed, so it is no oracle). Returns config 3's row, the other
    cases under ``cases``."""
    import torch

    from ndtpu_torch import kernels
    from ndtpu_torch.loop import closure

    rows = {}
    for i, case in enumerate(K15_CASES):
        label, s, k, c, cap, n, stride, radius, gap, ties, full = case
        args = k15_inputs(seed + i, dev, s, k, c, cap, n, stride, radius,
                          gap, ties, full)
        run = lambda a=args: kernels.loop_lanes(*a)
        twin = lambda a=args: closure.loop_lanes_ref(*a)
        out, again, ref = run(), run(), twin()
        given = kernels.loop_lanes(*args, cand_idx=out[0], cand_mask=out[1])
        torch.cuda.synchronize()
        require(bits_equal(out, again), f"K15 {label}: two launches differ")
        for name, a, b in zip(K15_OUTS, out, ref):
            require(bits_equal(a, b), f"K15 {label}: {name} not bit-equal "
                    f"to the plain version")
        require(given[2] is None and bits_equal(given[3:], out[3:]),
                f"K15 {label}: the lanes of given candidates differ from "
                f"the search's")
        mask, dist = out[1], out[2]
        masked = int((~mask).sum())
        tied = int(((dist[..., 1:] == dist[..., :-1]) & mask[..., 1:]).sum())
        require(int(mask.sum()) > 0, f"K15 {label}: no candidate found")
        require(not ties or tied > 0, f"K15 {label}: no equal distances")
        lib = k15_library_call(args)
        row = dict(max_abs_err=0.0, bit_equal=True, sessions=s, queries=k,
                   candidates=c, capacity=cap, stride=stride, masked=masked,
                   tied=tied, ms=time_ms(run), plain_ms=time_ms(twin),
                   **k15_bound(args))
        row.update(library_ms=time_ms(lib), library=(
            "torch.topk(d_masked, C, largest=False) on the plain version's "
            "masked distances: the search alone, its order among equal "
            "distances not guaranteed"))
        card_time(jobs, f"K15 loop_lanes {label}", row, "card_ms", run,
                  ["loop_lanes_kernel"], per_call=1)
        card_time(jobs, f"K15 library call {label}", row, "library_card_ms",
                  lib)
        rows[label] = row
        print(f"[smoke] K15 loop_lanes {label} (S={s} x K={k} queries, C={c}"
              f", {cap} slots, stride {stride}): all outputs bit-equal to "
              f"the plain version and on a second launch, given candidates "
              f"the same lanes; {masked} masked lanes, {tied} tied; kernel "
              f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, library "
              f"(topk) {row['library_ms']:.4f} ms, bound "
              f"{row['bound_ms']:.6f} ms ({row['bound_by']})")
    out = rows.pop("config3")
    out["cases"] = rows
    return out


#: K16's cases: (label, sessions, slots, M, beams, ties, full, enable,
#: eps): serving's 8 x 512 slots (its published capacity, M = 12), the
#: smoke's serving run (160 slots, every other session on, eps above 0),
#: equal staleness across the M-th place, every slot live, every session
#: off.
K16_CASES = (("serving", 8, 512, 12, 360, False, False, "all", 0.0),
             ("smoke", 8, 160, 12, 360, False, False, "some", 0.05),
             ("ties", 8, 512, 12, 360, True, False, "all", 0.0),
             ("full", 8, 512, 12, 360, False, True, "all", 0.0),
             ("off", 8, 512, 12, 360, False, False, "none", 0.0))
#: K16's outputs, in ``kernels.refresh_points``' order.
K16_OUTS = ("both", "bmsk", "wts", "sel", "do", "rows")


def k16_inputs(seed: int, dev, sessions: int, cap: int, m: int,
               n_beams: int, ties: bool, full: bool, enable: str,
               eps: float) -> tuple:
    """Seeded stores for K16 (f32 on ``dev``): each session a quarter to
    three quarters full (every slot with ``full``), keyframe poses on a
    0.25 m lattice within 8 m, a third of the slots (dead ones too) seen by
    their map a seeded 0-0.3 m / 0-0.2 rad away, the rest where they are
    (staleness 0); with ``ties`` the moved slots moved by 0.25 or 0.5 m
    along one axis (exact in f32), so equal staleness spans the M-th
    place. ``enable``: "all" (None), "some" (every other session) or
    "none". The arguments of ``kernels.refresh_points``."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    s = sessions
    fill = (np.full(s, cap) if full
            else rng.integers(cap // 4, 3 * cap // 4, s))
    poses = np.zeros((s, cap, 3))
    poses[..., :2] = rng.integers(-32, 33, (s, cap, 2)) * 0.25
    poses[..., 2] = rng.integers(-12, 13, (s, cap)) * 0.25
    mkp = poses.copy()
    moved = rng.random((s, cap)) < 1.0 / 3.0
    if ties:
        step = rng.integers(1, 3, (s, cap)) * 0.25
        axis = rng.integers(0, 2, (s, cap))
        for a in (0, 1):
            mkp[..., a] -= np.where(moved & (axis == a), step, 0.0)
    else:
        mkp -= np.where(moved[..., None],
                        rng.uniform(-1.0, 1.0, (s, cap, 3))
                        * [0.3, 0.3, 0.2], 0.0)
    live = np.arange(cap) < fill[:, None]
    on = {"all": None, "some": np.arange(s) % 2 == 0,
          "none": np.zeros(s, bool)}[enable]
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    return (f32(poses), torch.as_tensor(live, device=dev),
            f32(rng.normal(0.0, 8.0, (s, cap, n_beams, 2))),
            torch.as_tensor(rng.random((s, cap, n_beams)) < 0.9, device=dev),
            f32(mkp), None if on is None else torch.as_tensor(on,
                                                                device=dev),
            m, eps)


def k16_bound(args) -> dict:
    """Bytes: each store's poses, map poses and live flags (25 B a slot)
    and the selected scans (9 B a beam) read once; the 2 M N points, masks
    and weights (13 B each) and per selected keyframe its slot, flag and
    row (21 B) written once. Operations: ~14 a slot's staleness, 12 a
    point's two transforms."""
    poses, live, points, _, _, _, m, _ = args
    s, cap, n = points.shape[:3]
    n_bytes = (s * cap * 25 + s * m * n * 9 + s + s * 2 * m * n * 13
               + s * m * 21)
    return bound(n_bytes, 14.0 * s * cap + 12.0 * s * m * n)


def check_k16(dev, seed: int, jobs=None) -> dict:
    """K16 ``refresh_points`` against ``pipeline.refresh_points_ref`` on
    the card at :data:`K16_CASES`: all six outputs bit-equal, and on a
    second launch, one launch a call. Each case timed beside its plain
    version (events), with its card time, its bound and the library call
    ``torch.topk(stale, M, dim=1)`` on the twin's staleness (events and
    card; the selection alone, its order among equal values not
    guaranteed, so no oracle). Returns serving's row, the other cases
    under ``cases``."""
    import torch

    from ndtpu_torch import kernels
    from ndtpu_torch.slam import pipeline

    rows = {}
    for i, case in enumerate(K16_CASES):
        label, s, cap, m, n, ties, full, enable, eps = case
        args = k16_inputs(seed + i, dev, s, cap, m, n, ties, full, enable,
                          eps)
        run = lambda a=args: kernels.refresh_points(*a)
        twin = lambda a=args: pipeline.refresh_points_ref(*a)
        kernels.reset_launches()
        out, again = run(), run()
        require(kernels.LAUNCHES["refresh_points"] == 2,
                f"K16 {label}: {kernels.LAUNCHES['refresh_points']} "
                f"launches for two calls")
        ref = twin()
        torch.cuda.synchronize()
        require(bits_equal(out, again), f"K16 {label}: two launches differ")
        for name, a, b in zip(K16_OUTS, out, ref):
            require(bits_equal(a, b), f"K16 {label}: {name} not bit-equal "
                    f"to the plain version")
        stale = pipeline.refresh_staleness(args[0], args[1], args[4])
        top = torch.sort(stale, dim=1, descending=True).values
        tied = int((top[:, m - 1] == top[:, m]).logical_and(
            top[:, m] > 0).sum())
        on = int(out[4].sum())
        require(not ties or tied > 0,
                f"K16 {label}: no equal staleness across the M-th place")
        require((on == 0) == (enable == "none"),
                f"K16 {label}: {on} selected keyframes re-placed")
        lib = lambda st=stale, m=m: torch.topk(st, m, dim=1)
        row = dict(max_abs_err=0.0, bit_equal=True, sessions=s,
                   capacity=cap, m=m, beams=n, enabled=on, tied=tied,
                   ms=time_ms(run), plain_ms=time_ms(twin), **k16_bound(args))
        row.update(library_ms=time_ms(lib), library=(
            "torch.topk(stale, M, dim=1) on the plain version's staleness: "
            "the selection alone, its order among equal values not "
            "guaranteed"))
        card_time(jobs, f"K16 refresh_points {label}", row, "card_ms", run,
                  ["refresh_points"], per_call=1)
        card_time(jobs, f"K16 library call {label}", row, "library_card_ms",
                  lib)
        rows[label] = row
        print(f"[smoke] K16 refresh_points {label} (S={s} x {cap} slots, "
              f"M={m}, N={n}, eps {eps}, enable {enable}): all outputs "
              f"bit-equal to the plain version and on a second launch; "
              f"{on} keyframes re-placed, {tied} sessions tied at the M-th "
              f"place; kernel {row['ms']:.4f} ms, plain "
              f"{row['plain_ms']:.4f} ms, library (topk) "
              f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.6f} ms "
              f"({row['bound_by']})")
    out = rows.pop("serving")
    out["cases"] = rows
    return out


def check_k5_stacked(state8, jobs=None) -> dict:
    """K5's fresh window of S sessions on the serving run's 8 graphs (each
    session's newest poses moved, so the residuals are not 0): bit-equal
    to one single-session K5 launch a session, within rtol 1e-5 of the f32
    plain version, one launch a call; timed beside the S single launches
    and the plain version."""
    import torch

    from ndtpu_torch import kernels
    from ndtpu_torch.dist import slam_dp
    from ndtpu_torch.graph import incremental as inc

    g8 = _moved_graph8(state8.graph, 5)
    s = g8.poses.shape[0]
    run = lambda: inc.fresh_residual_max_stacked(g8)
    singles = lambda: torch.stack([
        inc.fresh_residual_max(slam_dp._take(g8, i)) for i in range(s)])
    kernels.reset_launches()
    out = run()
    require(kernels.LAUNCHES["factor_linearize"] == 1,
            f"K5 fresh window of {s} sessions: "
            f"{kernels.LAUNCHES['factor_linearize']} launches")
    one, ref = singles(), inc.fresh_residual_max_stacked_ref(g8)
    torch.cuda.synchronize()
    require(bits_equal(out, one), "K5 fresh window of S sessions: not "
            "bit-equal to the single-session launches")
    err = _rel_check("K5 fresh window of S sessions", [out], [ref])
    require(bool((out > 0).all()), "K5 fresh window: a session's max is 0")
    k = min(64, g8.bet_mask.shape[1])
    # Per slot its mask, indices, z and sqrt-info (61 B) and two poses
    # (24 B) read; S floats written.
    bd = bound(s * k * 85 + s * 12, s * k * K5_ROW_FLOPS)
    row = dict(sessions=s, window=k, max_abs_err=err, bit_equal_singles=True,
               ms=time_ms(run), singles_ms=time_ms(singles),
               plain_ms=time_ms(lambda: inc.fresh_residual_max_stacked_ref(
                   g8)), **bd)
    card_time(jobs, f"K5 fresh window of {s} sessions", row, "card_ms", run,
              ["linearize_"], per_call=1)
    card_time(jobs, f"K5 fresh window, {s} single launches", row,
              "singles_card_ms", singles, ["linearize_"], per_call=s)
    print(f"[smoke] K5 fresh window of {s} sessions ({k} slots each): "
          f"bit-equal to {s} single launches, max abs err vs f32 plain "
          f"{err:.3e}; one launch {row['ms']:.4f} ms against "
          f"{row['singles_ms']:.4f} ms for {s}, plain {row['plain_ms']:.4f} "
          f"ms, bound {bd['bound_ms']:.6f} ms ({bd['bound_by']})")
    return row


#: The most host syncs a window's backend may make outside the loop
#: verify's own routing (the branch decisions once, then where they run the
#: slow settled check, the local probe and the full solve's early exit).
WINDOW_SYNC_BUDGET = 3


def check_window_syncs(dev, config, seed: int = 0) -> dict:
    """The windowed path's host syncs on box-world draw ``seed`` at
    ``config`` (``set_sync_debug_mode("warn")`` inside each
    ``_window_backend`` call): all of a window's, which a parent checkout
    counts the same way (``profile_port.py``'s sync run), and of them those
    inside the loop verify (``detect_loops_stacked``). Fails where a
    window makes more than :data:`WINDOW_SYNC_BUDGET` outside the verify.
    Returns the counts."""
    import warnings

    import torch

    from ndtpu_torch.config import PipelineConfig
    from ndtpu_torch.loop import closure
    from ndtpu_torch.slam import pipeline

    cfg = PipelineConfig.from_json(str(config))
    seq = box_sequence(seed, cfg.n_beams, device=dev)
    backend, verify = pipeline._window_backend, closure.detect_loops_stacked
    per_window, in_verify = [], []
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        syncs = lambda: sum("synchroniz" in str(w.message) for w in caught)

        def counted_verify(*a, **k):
            n0 = syncs()
            out = verify(*a, **k)
            in_verify[-1] += syncs() - n0
            return out

        def counted(*a, **k):
            in_verify.append(0)
            n0 = syncs()
            torch.cuda.set_sync_debug_mode("warn")
            try:
                return backend(*a, **k)
            finally:
                torch.cuda.set_sync_debug_mode(0)
                per_window.append(syncs() - n0)

        pipeline._window_backend = counted
        closure.detect_loops_stacked = counted_verify
        try:
            pipeline.run_slam_windowed(seq.points, seq.mask, seq.odom, cfg)
            torch.cuda.synchronize()
        finally:
            pipeline._window_backend = backend
            closure.detect_loops_stacked = verify
    outside = [n - v for n, v in zip(per_window, in_verify)]
    n_win = len(per_window)
    row = dict(windows=n_win, all_per_window=sum(per_window) / n_win,
               all_max=max(per_window),
               verify_per_window=sum(in_verify) / n_win,
               outside_per_window=sum(outside) / n_win,
               outside_max=max(outside),
               outside_counts={c: outside.count(c) for c in sorted(
                   set(outside))})
    print(f"[smoke] window host syncs ({config.name}, draw {seed}; the "
          f"parent-comparable count, every sync inside _window_backend): "
          f"{row['all_per_window']:.2f} per window, at most {row['all_max']}")
    require(row["outside_max"] <= WINDOW_SYNC_BUDGET,
            f"window host syncs ({config.name}): up to {row['outside_max']} "
            f"a window outside the loop verify (budget "
            f"{WINDOW_SYNC_BUDGET}); counts {row['outside_counts']}")
    print(f"[smoke] window host syncs ({config.name}): "
          f"{row['outside_per_window']:.2f} per window outside the loop "
          f"verify, at most {row['outside_max']} (budget "
          f"{WINDOW_SYNC_BUDGET}; windows by count "
          f"{row['outside_counts']}), {row['verify_per_window']:.2f} inside "
          f"it, over {n_win} windows")
    return row


#: Every plain version the per-scan path, the CLI's inputs and the stacked
#: sessions of logs could reach, ``pack_quad`` (the plain table pack)
#: included.
PLAIN_SCAN = PLAIN_WINDOWED + (
    ("ndtpu_torch.data.preprocess", "voxel_downsample_ref"),
    ("ndtpu_torch.ndt.grid", "pack_quad"))


def card_vs_cpu(label, card_seq, cpu_seq) -> int:
    """A card-made sequence against the CPU-made one: equal hashes, or else
    every differing element printed, and each one at most one f32 ulp off
    (no mask flag), at most 10 per sequence. Returns the count."""
    import torch

    if sequence_hashes(card_seq) == sequence_hashes(cpu_seq):
        return 0
    n_diff, worst = 0, 0
    for key in ("points", "mask", "odom"):
        a, b = getattr(card_seq, key).cpu(), getattr(cpu_seq, key).cpu()
        idx = (a != b).nonzero().tolist()
        n_diff += len(idx)
        for i in idx:
            x, y = a[tuple(i)], b[tuple(i)]
            ulp = (int(x.view(torch.int32)) - int(y.view(torch.int32))
                   if key != "mask" else 1 << 30)
            worst = max(worst, abs(ulp))
            print(f"[smoke] {label}: {key}{i} card {x.item()!r} CPU "
                  f"{y.item()!r} ({abs(ulp)} ulp)")
    require(worst <= 1 and n_diff <= 10,
            f"{label}: the card-made sequence differs from the CPU-made one "
            f"in {n_diff} elements, up to {worst} ulp (at most 10 elements "
            f"of one ulp allowed)")
    return n_diff


def run_scan_cli(dev, config, n_scans: int):
    """``run.main --mode scan`` on ``config`` (the CLI's corridor on the
    card), every launch counter reset just before and read just after, no
    plain version reachable on CUDA tensors. Requires one K11 launch (the
    input), one ``lm_ndt`` and one K4 per scan, one ``lm_ndt*`` per
    ``match_batch_packed`` call, K3 and K5; with loop closure, one K8a and
    one K15 and one gated verify per keyframe (``detect_loops_cached``)
    and no standalone K8b. Returns ``(launches, summary)``."""
    import numpy as np

    from ndtpu_torch import kernels, run
    from ndtpu_torch.config import PipelineConfig
    from ndtpu_torch.loop import closure
    from ndtpu_torch.ndt import match

    cfg = PipelineConfig.from_json(str(config))
    real = closure.detect_loops_cached
    detections = []

    def counted(*a, **k):
        detections.append(1)
        return real(*a, **k)

    closure.detect_loops_cached = counted
    try:
        with no_plain_on_card(PLAIN_SCAN):
            kernels.reset_launches()
            match.CALLS["match_batch_packed"] = 0
            res = run.main(["--config", str(config), "--max-scans",
                            str(n_scans), "--mode", "scan", "--device",
                            str(dev)])
            launches = dict(kernels.LAUNCHES)
            calls = match.CALLS["match_batch_packed"]
    finally:
        closure.detect_loops_cached = real
    label = f"per-scan CLI {config.name}"
    traj, kf = res["traj"], res["n_keyframes"]
    require(traj.shape == (n_scans, 3) and bool(np.isfinite(traj).all()),
            f"{label}: trajectory not finite or of the wrong shape")
    lm = sum(v for k, v in launches.items() if k.startswith("lm_ndt"))
    steps = n_scans - 1
    require(launches["raycast"] == 1, f"{label}: {launches['raycast']} K11 "
            f"launches for the input (1 expected)")
    require(lm == calls and launches["lm_ndt"] == steps
            and launches["finalize_pack"] == steps,
            f"{label}: {launches['lm_ndt']} lm_ndt and "
            f"{launches['finalize_pack']} K4 launches for {steps} scans, {lm} "
            f"lm_ndt* for {calls} match_batch_packed calls")
    require(launches["halfcell_add"] > 0 and launches["factor_linearize"] > 0,
            f"{label}: K3 or K5 never launched")
    if cfg.use_loop_closure:
        require(launches["loop_gate_fused"] == len(detections) == kf - 1
                and launches["loop_lanes"] == len(detections)
                and launches["local_tables"] == kf
                and launches["loop_gate"] == 0,
                f"{label}: {launches['loop_gate_fused']} gated verifies, "
                f"{launches['loop_lanes']} K15 and "
                f"{launches['local_tables']} K8a launches for {kf} keyframes "
                f"({len(detections)} detections)")
    summary = dict(scans_per_s=res["scans_per_s"], seconds=res["seconds"],
                   ate_m=res["ate"], keyframes=kf, loops=res["n_loops"],
                   match_batch_packed=calls)
    print(f"[smoke] {label}: {n_scans} scans, {res['scans_per_s']:.1f} "
          f"scans/s ({res['seconds']:.2f} s), keyframes={kf}, "
          f"loops={res['n_loops']}, ATE {res['ate']:.4f} m; launches "
          f"{launches_nonzero(launches)}")
    return launches, summary


def scan_ate_gate(dev, name: str, config, ref, keep=None):
    """Box-world draws through the per-scan ``run_slam`` on the card, on
    card-made sequences (each against the CPU-made one, :func:`card_vs_cpu`;
    the CPU-made ones against the reference's hashes) vs the JAX package's
    per-scan run (``ref["runs"][name]``): ATE by :func:`draw_gate`, a loop
    wherever JAX closes one. Appends ``(state, seq)`` of draw 0 to ``keep``.
    Returns the per-draw results, the gate's summary and the differing
    element counts."""
    import torch

    from ndtpu_torch.config import PipelineConfig
    from ndtpu_torch.eval.ate import ate_rmse
    from ndtpu_torch.slam import pipeline

    cfg = PipelineConfig.from_json(str(config))
    runref = ref["runs"][name]
    label = f"per-scan {name}"
    draws, diffs = [], {}
    for draw in runref["draws"]:
        seed = draw["seed"]
        cpu_seq = box_sequence(seed, cfg.n_beams, n_scans=runref["n_scans"])
        require(sequence_hashes(cpu_seq) == draw["sha256"],
                f"{label} draw {seed}: the CPU-made inputs differ from the "
                f"reference's hashes")
        seq = box_sequence(seed, cfg.n_beams, device=dev,
                           n_scans=runref["n_scans"])
        diffs[seed] = card_vs_cpu(f"{label} draw {seed}", seq, cpu_seq)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with no_plain_on_card(PLAIN_SCAN):
            state, outs = pipeline.run_slam(seq.points, seq.mask, seq.odom,
                                            cfg)
            traj = pipeline.recover_trajectory(state, outs)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        require(bool(torch.isfinite(traj).all()), f"{label}: non-finite")
        ate = float(ate_rmse(traj.cpu(), seq.gt_poses.cpu()))
        n_loops = int(state.n_loops)
        require(n_loops > 0 or draw["jax_n_loops"] == 0,
                f"{label} draw {seed}: closed no loop where JAX closed "
                f"{draw['jax_n_loops']}")
        sps = (seq.points.shape[0] - 1) / dt
        print(f"[smoke] {label} draw {seed}: {sps:.1f} scans/s, ATE "
              f"{ate:.4f} m, JAX f32 {draw['jax_ate_m']:.4f} m / f64 "
              f"{draw['jax_ate_f64_m']:.4f} m, loops {n_loops} (JAX "
              f"{draw['jax_n_loops']} / {draw['jax_n_loops_f64']}), "
              f"keyframes {int(state.kf.n)}, card-made inputs "
              f"{'equal to' if diffs[seed] == 0 else 'ulp off'} the "
              f"CPU-made ones")
        row = dict(draw, ate=ate, n_loops=n_loops, scans_per_s=sps)
        row.pop("sha256")
        draws.append(row)
        if keep is not None and seed == 0:
            keep.append((state, seq))
    return dict(draws=draws, sequence_diffs=diffs, **draw_gate(label, draws))


def check_scan_syncs(dev, config=CONFIG3, seed: int = 0,
                     n_scans: int = BOX["n_scans"]) -> dict:
    """The per-scan step's host syncs (``set_sync_debug_mode("warn")``) on
    box-world draw ``seed``: one on a scan that is no keyframe (the
    keyframe test), and on a keyframe at most two besides the smoother's
    own (the keyframe test and, with loop closure, "a loop landed"): K8a,
    the verify, the appends and the map take none. Returns the counts."""
    import warnings

    import torch

    from ndtpu_torch.config import PipelineConfig
    from ndtpu_torch.graph import incremental as inc
    from ndtpu_torch.slam import pipeline

    cfg = PipelineConfig.from_json(str(config))
    seq = box_sequence(seed, cfg.n_beams, device=dev, n_scans=n_scans)
    state = pipeline.init_slam(cfg, seq.points[0], seq.mask[0])
    real = inc.incremental_update
    steps, flags = [], []
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        syncs = lambda: sum("synchroniz" in str(w.message) for w in caught)
        smoother = [0]

        def counted(*a, **k):
            n0 = syncs()
            out = real(*a, **k)
            smoother[0] += syncs() - n0
            return out

        inc.incremental_update = counted
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for t in range(1, n_scans):
                n0, s0 = syncs(), smoother[0]
                state, out = pipeline.slam_step(state, seq.points[t],
                                                seq.mask[t], seq.odom[t], cfg)
                steps.append(syncs() - n0 - (smoother[0] - s0))
                flags.append(out.is_keyframe)
        finally:
            torch.cuda.set_sync_debug_mode(0)
            inc.incremental_update = real
    is_kf = torch.stack(flags).tolist()
    plain = [n for n, k in zip(steps, is_kf) if not k]
    keyf = [n for n, k in zip(steps, is_kf) if k]
    require(set(plain) == {1} and max(keyf) <= 2,
            f"per-scan host syncs: {sorted(set(plain))} on scans without a "
            f"keyframe (1 expected), up to {max(keyf)} on keyframes besides "
            f"the smoother's (2 at most)")
    row = dict(scans=n_scans - 1, keyframes=len(keyf),
               syncs_outside_smoother=sum(steps), smoother_syncs=smoother[0],
               syncs_per_scan=(sum(steps) + smoother[0]) / (n_scans - 1))
    print(f"[smoke] per-scan host syncs ({config.name}, draw {seed}): 1 on "
          f"each of {len(plain)} scans without a keyframe, {sum(keyf)} on "
          f"{len(keyf)} keyframes outside the smoother, {smoother[0]} in the "
          f"smoother ({row['syncs_per_scan']:.2f} per scan in all)")
    return row


def check_fresh_detect(state, seq, cfg3, dev, layout=(4, 8)):
    """``detect_loops`` (the fresh-map verify) at the end-of-lap query of a
    per-scan run (its last scan at its pose, against the run's keyframes)
    on the card, its local maps in the table ``layout`` (``(G, L)``: the
    config with ``loop.local_overlap = G`` and ``match.compact_table`` at
    L = 4): one K3s, one K4s and one gated ``lm_ndt`` launch of the layout
    and two K15 (the search, the lanes), against its plain route on the CPU
    copies (f32): the same candidates, the same accept flags and innovation
    rejections but on lanes within 1e-3 of the score gate or of the
    innovation budget, accepted measurements within 1e-3. Returns the
    row."""
    import dataclasses

    import torch

    from ndtpu_torch import kernels
    from ndtpu_torch.lie import se2
    from ndtpu_torch.loop import closure

    g, lanes = layout
    cfg3 = dataclasses.replace(
        cfg3, loop=dataclasses.replace(cfg3.loop, local_overlap=g),
        match=dataclasses.replace(cfg3.match, compact_table=lanes == 4))
    tag = "fresh detect_loops" + ("" if layout == (4, 8)
                                  else f" [g{g}l{lanes}]")
    kf = state.kf
    q = (kf, seq.points[-1], seq.mask[-1], state.pose, kf.n)
    run = lambda: closure.detect_loops(*q, cfg3.loop, cfg3.ndt, cfg3.match)
    kernels.reset_launches()
    with no_plain_on_card(PLAIN_SCAN):
        out = run()
    launches = dict(kernels.LAUNCHES)
    kf_cpu = type(kf)(*(None if t is None else t.cpu() for t in kf))
    ref = closure.detect_loops(kf_cpu, *(t.cpu() for t in q[1:]), cfg3.loop,
                               cfg3.ndt, cfg3.match)
    require(launches[kernels.variant("halfcell_add_stacked", g)] == 1
            and launches[kernels.variant("finalize_pack_stacked", g,
                                         lanes)] == 1
            and launches[kernels.variant("loop_gate_fused", g, lanes)] == 1
            and launches["loop_lanes"] == 2,
            f"{tag}: launches {launches_nonzero(launches)} (one K3s, one "
            f"K4s, one gated lm_ndt of the layout, two K15 (the search, "
            f"the lanes) expected)")
    require(torch.equal(out.j.cpu(), ref.j), f"{tag}: candidates differ "
            f"from the plain route's")
    # The gates: score, and the innovation budget over the candidates'
    # index gaps (the lanes' rows are the fresh tables', not the
    # candidates'); lanes within 1e-3 of either may fall either way in f32.
    loop = cfg3.loop
    init = se2.between(kf_cpu.poses[ref.j], q[3].cpu()[None])
    innov = torch.linalg.norm(ref.z[:, :2] - init[:, :2], dim=-1)
    budget = (loop.max_innovation_base + loop.max_innovation_per_kf
              * (kf_cpu.n - ref.j).abs().to(innov.dtype))
    near = (((ref.score - loop.score_gate).abs() < 1e-3)
            | ((innov - budget).abs() < 1e-3))
    flags = (((out.accept.cpu() != ref.accept)
              | (out.innov_rej.cpu() != ref.innov_rej)) & ~near)
    require(not bool(flags.any()) and bool(ref.accept.any()),
            f"{tag}: accept flags {out.accept.tolist()} and innovation "
            f"rejections {out.innov_rej.tolist()} vs the plain route's "
            f"{ref.accept.tolist()}, {ref.innov_rej.tolist()}")
    both = out.accept.cpu() & ref.accept
    err = float((out.z.cpu() - ref.z)[both].abs().amax()) if both.any() \
        else 0.0
    require(err <= 1e-3, f"{tag}: accepted measurements off by {err:.3e}")
    ms = time_ms(run)
    plain_s = []
    for _ in range(5):
        t0 = time.perf_counter()
        closure.detect_loops(kf_cpu, *(t.cpu() for t in q[1:]), cfg3.loop,
                             cfg3.ndt, cfg3.match)
        plain_s.append(time.perf_counter() - t0)
    plain_ms = 1e3 * statistics.median(plain_s)
    print(f"[smoke] {tag} (end-of-lap query, "
          f"{int(kf.n)} keyframes, C={cfg3.loop.max_candidates}): "
          f"{int(ref.accept.sum())} accepted as the plain route, accepted "
          f"measurements within {err:.3e}; one K3s, one K4s, one gated "
          f"lm_ndt; {ms:.4f} ms per call (events), the plain route on the "
          f"host's CPU {plain_ms:.4f} ms (median of 5)")
    return dict(accepted=int(ref.accept.sum()), max_abs_err=err, ms=ms,
                plain_ms=plain_ms)


def run_dataset_phase(dev, tmp: Path):
    """``--dataset`` in both modes on a log written (``write_carmen``,
    ROBOTLASER1) from the CLI's 600-scan corridor sequence at config 3 (a
    lap and a half; without loop closure the per-scan path drifts along
    the corridor, 1.6 m ATE at config 2 in both packages): the native
    parser builds and parses it as the Python parser does; each run's
    trajectory is finite and within 0.5 m ATE of the sequence's ground
    truth. Then ``serve --datasets`` on logs of two serving sessions.
    Returns ``(launches of the runs, summary)``."""
    import numpy as np
    import torch

    from ndtpu_torch import kernels, native, run, serve
    from ndtpu_torch.config import PipelineConfig
    from ndtpu_torch.data import carmen
    from ndtpu_torch.eval.ate import ate_rmse

    cfg = PipelineConfig.from_json(str(CONFIG3))
    seq = cli_inputs(CONFIG3, CORRIDOR_SCANS, "cpu")
    path = tmp / "corridor.clf"
    carmen.write_carmen(str(path), sequence_log(seq, cfg.max_range),
                        style="robotlaser")
    require(native.ndtpu_native_available(),
            f"the native CARMEN parser did not build: {native._build_error}")
    py, cc = carmen.read_carmen(str(path)), native.parse_carmen_native(
        str(path))
    for f in ("ranges", "n_beams", "laser_pose", "odom_pose", "timestamps"):
        require(np.array_equal(getattr(py, f), getattr(cc, f)),
                f"native parser: {f} differ from the Python parser's")
    out, launches = dict(), {}
    for mode in ("windowed", "scan"):
        with no_plain_on_card(PLAIN_SCAN):
            kernels.reset_launches()
            res = run.main(["--config", str(CONFIG3), "--dataset", str(path),
                            "--mode", mode, "--device", str(dev)])
            launches[mode] = dict(kernels.LAUNCHES)
        traj = torch.as_tensor(res["traj"])
        require(traj.shape == (CORRIDOR_SCANS, 3)
                and bool(torch.isfinite(traj).all()),
                f"--dataset {mode}: trajectory not finite")
        ate = float(ate_rmse(traj.double(), seq.gt_poses.double()))
        require(ate <= 0.5, f"--dataset {mode}: ATE {ate:.4f} m > 0.5 m")
        out[mode] = dict(ate_m=ate, scans_per_s=res["scans_per_s"],
                         keyframes=res["n_keyframes"], loops=res["n_loops"])
        print(f"[smoke] --dataset {mode} (config 3, a {CORRIDOR_SCANS}-scan "
              f"corridor log): {res['scans_per_s']:.1f} scans/s, ATE "
              f"{ate:.4f} m vs the written sequence, keyframes "
              f"{res['n_keyframes']}, loops {res['n_loops']}")
    scfg = PipelineConfig.from_json(str(SERVING))
    sessions = serve.synthetic_sessions(scfg, 2, 300)
    logs = []
    for k, s in enumerate(sessions):
        logs.append(str(tmp / f"session{k}.clf"))
        carmen.write_carmen(logs[-1], sequence_log(s, scfg.max_range),
                            style="robotlaser")
    with no_plain_on_card(PLAIN_SERVING):
        res = serve.main(["--config", str(SERVING), "--datasets", *logs,
                          "--device", str(dev)])
    ates = [float(ate_rmse(torch.as_tensor(res["traj"][k]).double(),
                           s.gt_poses.double()))
            for k, s in enumerate(sessions)]
    require(res["sessions"] == 2 and bool(np.isfinite(res["traj"]).all())
            and all(r["keyframes"] > 1 for r in res["per_session"])
            and max(ates) <= 0.5,
            f"serve --datasets: {res['per_session']}, ATE {ates}")
    out["serve_datasets"] = dict(
        aggregate_scans_per_s=res["aggregate_scans_per_s"], ate_m=ates)
    print(f"[smoke] serve --datasets (2 logs of serving sessions): "
          f"{res['aggregate_scans_per_s']:.1f} aggregate scans/s, ATE "
          f"{', '.join(f'{a:.4f}' for a in ates)} m")
    return launches, out


def run_downsample(dev, tmp: Path):
    """Config 2 with ``downsample_voxel = 0.1`` through the CLI (300 scans,
    windowed): one K13 launch, and the kept count equal to the plain
    version's on the same (card-made) inputs. Returns ``(launches,
    summary)``."""
    import numpy as np

    from ndtpu_torch import kernels, run
    from ndtpu_torch.data import preprocess

    doc = json.loads(CONFIG2.read_text())
    doc["downsample_voxel"] = 0.1
    path = tmp / "config2_downsample.json"
    path.write_text(json.dumps(doc))
    seq = cli_inputs(path, 300, dev)
    kept = int(preprocess.voxel_downsample_ref(seq.points.cpu(),
                                               seq.mask.cpu(), 0.1).sum())
    with no_plain_on_card(PLAIN_SCAN):
        kernels.reset_launches()
        res = run.main(["--config", str(path), "--max-scans", "300",
                        "--device", str(dev)])
        launches = dict(kernels.LAUNCHES)
    require(launches["voxel_downsample"] == 1 and res["n_kept"] == kept,
            f"downsample: {launches['voxel_downsample']} K13 launches, "
            f"{res['n_kept']} points kept against the plain version's "
            f"{kept}")
    require(bool(np.isfinite(res["traj"]).all()), "downsample: non-finite")
    print(f"[smoke] config 2 with downsample_voxel 0.1 (CLI, 300 scans): "
          f"{res['n_kept']} of {int(seq.mask.sum())} points kept, as the "
          f"plain version; {res['scans_per_s']:.1f} scans/s, ATE "
          f"{res['ate']:.4f} m")
    return launches, dict(kept=kept, valid=int(seq.mask.sum()),
                          scans_per_s=res["scans_per_s"], ate_m=res["ate"])


def run_resume(dev, tmp: Path, n_scans: int = CORRIDOR_SCANS,
               every: int = 256):
    """``--checkpoint-dir`` with ``--resume`` in both modes at config 3 on
    the CLI's corridor: a run that checkpoints every ``every`` scans, then
    a run resumed from its newest checkpoint (scan 512: the rest of the
    run closes the lap's loops), whose final state must equal the first's
    bit for bit. Returns the scans each resumed run ran and its loops."""
    from ndtpu_torch import run
    from ndtpu_torch.utils.checkpoint import leaves

    out = {}
    for mode in ("windowed", "scan"):
        args = ["--config", str(CONFIG3), "--max-scans", str(n_scans),
                "--mode", mode, "--device", str(dev), "--checkpoint-dir",
                str(tmp / f"ck_{mode}"), "--checkpoint-every", str(every)]
        with no_plain_on_card(PLAIN_SCAN):
            full = run.main(args)
            resumed = run.main(args + ["--resume"])
        ran = resumed["traj"].shape[0] - 1
        require(0 < ran < n_scans - 1 and resumed["n_loops"] > 0,
                f"--resume {mode}: ran {ran} of {n_scans - 1} scans, "
                f"{resumed['n_loops']} loops in all")
        require(bits_equal(leaves(full["state"]), leaves(resumed["state"])),
                f"--resume {mode}: the final state differs from the "
                f"uninterrupted run's")
        out[mode] = dict(resumed_scans=ran, loops=resumed["n_loops"])
        print(f"[smoke] --checkpoint-dir / --resume {mode} (config 3, "
              f"{n_scans} scans, every {every}): resumed for the last {ran} "
              f"scans, final state bit-equal to the uninterrupted run's")
    return out


def run_scan_phase(dev, jobs):
    """Phase 16: the per-scan path and the inputs through their entry
    points (the fresh-map verify in every table layout). Returns ``(paths'
    launches, summary)``."""
    from ndtpu_torch import kernels
    from ndtpu_torch.config import PipelineConfig

    ref = json.loads(REF_SCAN_FILE.read_text())
    paths, out = {}, {}
    paths["scan_config2"], out["cli_config2"] = run_scan_cli(dev, CONFIG2,
                                                            300)
    paths["scan_config3"], out["cli_config3"] = run_scan_cli(
        dev, CONFIG3, CORRIDOR_SCANS)
    card = cli_inputs(CONFIG3, CORRIDOR_SCANS, dev)
    cpu = cli_inputs(CONFIG3, CORRIDOR_SCANS, "cpu")
    out["cli_sequence_diffs"] = card_vs_cpu("CLI corridor 600", card, cpu)
    keep = []
    out["box_config2"] = scan_ate_gate(dev, "config2", CONFIG2, ref)
    out["box_config3"] = scan_ate_gate(dev, "config3", CONFIG3, ref, keep)
    cfg3 = PipelineConfig.from_json(str(CONFIG3))
    out["fresh_detect"] = check_fresh_detect(*keep[0], cfg3, dev)
    for g, lanes in kernels.LAYOUTS[1:]:
        out["fresh_detect"][kernels.variant("layout", g, lanes)] = \
            check_fresh_detect(*keep[0], cfg3, dev, (g, lanes))
    out["host_syncs"] = check_scan_syncs(dev)
    del keep
    with tempfile.TemporaryDirectory(prefix="ndtpu_smoke_") as tmp:
        tmp = Path(tmp)
        paths["dataset"], out["dataset"] = run_dataset_phase(dev, tmp)
        paths["downsample"], out["downsample"] = run_downsample(dev, tmp)
        out["resume"] = run_resume(dev, tmp)
    paths["dataset_scan"] = paths["dataset"].pop("scan")
    paths["dataset"] = paths["dataset"].pop("windowed")
    diffs = (out["cli_sequence_diffs"]
             + sum(out["box_config2"]["sequence_diffs"].values())
             + sum(out["box_config3"]["sequence_diffs"].values()))
    print(f"[smoke] phase 16: card-made sequences differ from the CPU-made "
          f"ones in {diffs} elements in all (7 sequences)")
    return paths, out



# --------------------------------------------------------------------------
# Config 5: the two-session merge (phase 12) and the distributed solve
# (phase 13).

#: f32 operations of K12 per masked beam (transform, phi-derivative,
#: offsets) and per (beam, grid) (binning 6, counted from
#: ``csrc/ndt_unpacked.cu``) and per (beam, grid) in a valid in-map cell
#: (the 71 of ``csrc/ndt_sums.cuh``'s ``ndt_gauss_terms`` and their sum).
K12_BEAM_FLOPS, K12_BIN_FLOPS, K12_CELL_FLOPS = 14, 6, 71


def k12_bound(poses, points, mask, ndt_map, grid) -> dict:
    """Bytes: the poses, the scan and its mask, each distinct map cell the
    run gathers (mean 8 B, inverse covariance 16 B, valid 4 B) read once,
    the ``[B, 14]`` outputs written; operations: per masked beam and pose
    the transform, per (beam, grid) the binning, per (beam, grid) in a valid
    cell the 71 of the sums, as this run's data needs them."""
    import torch

    from ndtpu_torch.ndt import grid as ndt_grid
    from ndtpu_torch.ndt import match as ndt_match

    b, n = poses.shape[0], points.shape[0]
    live = int(mask.sum())
    touched = torch.zeros(grid.overlap * grid.n_cells, dtype=torch.bool,
                          device=poses.device)
    valid_terms = 0
    for i in range(0, b, 512):
        p = poses[i:i + 512]
        xw = torch.stack(ndt_match._lane_transform(
            p, points[:, 0][None], points[:, 1][None])[:2], -1)
        ids, inb = ndt_grid.cell_ids(xw, grid)                # [b, G, N]
        hit = inb & mask[None, None, :]
        g = torch.arange(grid.overlap, device=ids.device)[:, None]
        v = ndt_map.valid[g, ids] > 0
        valid_terms += int((hit & v).sum())
        touched[(ids + g * grid.n_cells)[hit]] = True
    n_bytes = b * 12 + n * 12 + int(touched.sum()) * 28 + b * 14 * 4
    flops = (b * live * (K12_BEAM_FLOPS + grid.overlap * K12_BIN_FLOPS)
             + valid_terms * K12_CELL_FLOPS)
    return bound(n_bytes, flops)


#: A world point's f32 position is off by a few roundings inside the 64 m
#: map (one f32 ulp there is 3.8e-6 m): a (pose, grid, beam) whose cell
#: differs between f32 and f64 must lie this close (m) to a cell edge.
K12_EDGE_EPS = 2e-5
#: K12 against its f64 plain version fed the f32 cells: each output within
#: this fraction of its max |.|. The same f32 rounding of the world point
#: (~1e-5 m) against inverse covariances up to 1e2 m^-2 (the 1e-2 m^2
#: eigenvalue floor) moves each term's ``q = icov d`` by ~1e-3, and the
#: gradient sums ~1,400 such terms to a max of a few hundred.
K12_F64_RTOL = 1e-4


def k12_f64_on_f32_cells(poses, points, mask, ndt_map, grid, mcfg):
    """K12's f64 plain version fed the f32 binning: ``score_grad_hess`` in
    f64 on the CPU, each (pose, grid, beam) gathering the cell that f32 on
    the card gives it (the f32 plain version's binning, which K12 must
    match). Also counts the (pose, grid, beam) triples of live beams whose
    cell or in-bounds flag differs between f32 and f64, and the largest
    f64 distance of one of them to a cell edge of its grid: ``((f, g, H,
    score), n_flip, edge_max_m)``."""
    import torch

    from ndtpu_torch.ndt import grid as ndt_grid
    from ndtpu_torch.ndt import match as ndt_match

    pts64, mask64 = points.cpu().double(), mask.cpu()
    map64 = ndt_grid.NDTMap(*(t.cpu().double() for t in ndt_map))
    offs = ndt_grid._grid_offsets(grid, torch.float64, "cpu")
    origin = torch.tensor([grid.x0, grid.y0], dtype=torch.float64)
    g = torch.arange(grid.overlap)[:, None]
    outs, n_flip, edge_max = [], 0, 0.0
    for i in range(0, poses.shape[0], 512):
        p32 = poses[i:i + 512]
        x, y, _, _ = ndt_match._lane_transform(p32, points[:, 0][None],
                                               points[:, 1][None])
        ids32, inb32 = (t.cpu() for t in ndt_grid.cell_ids(
            torch.stack([x, y], -1), grid))                 # [b, G, N]
        p64 = p32.cpu().double()
        x, y, dpx, dpy = ndt_match._lane_transform(p64, pts64[:, 0][None],
                                                   pts64[:, 1][None])
        xw = torch.stack([x, y], -1)
        ids64, inb64 = ndt_grid.cell_ids(xw, grid)
        flip = ((ids32 != ids64) | (inb32 != inb64)) & mask64[None, None]
        rel = (xw[:, None] - origin - offs[:, None, :]) / grid.cell
        edge = ((rel - torch.round(rel)).abs() * grid.cell).amin(-1)[flip]
        n_flip += int(flip.sum())
        edge_max = max([edge_max] + ([float(edge.max())] if n_flip else []))
        w0 = (map64.valid[g, ids32] * inb32.double()
              * mask64.double()[None, None])
        f, gr, h, wsum, w0sum = ndt_match.point_terms(
            p64, xw, torch.stack([dpx, dpy], -1), map64.mean[g, ids32],
            map64.icov[g, ids32], w0, mcfg)
        outs.append((f, gr, h, wsum / torch.clamp(w0sum, min=1.0)))
    return tuple(torch.cat(x) for x in zip(*outs)), n_flip, edge_max


def check_k12(label, poses, points, mask, ndt_map, grid, mcfg, jobs=None):
    """K12 ``ndt_sgh_unpacked`` at ``poses`` against its plain version in
    f32 on the card (each output within rtol 1e-5 of its max |.|: the same
    cells, the same sums in another order), bit-identical on a second
    launch, and against its f64 plain version on the CPU. A beam within an
    f32 rounding of a cell edge falls in the other cell in f64, and one
    such beam moves the gradient by up to d2 x |icov| x |d| (~25 at the
    1e-2 m^2 eigenvalue floor), so the f64 gate requires each (pose, grid,
    beam) whose cell differs between f32 and f64 to lie within
    :data:`K12_EDGE_EPS` of a cell edge, and holds K12 to the f64 plain
    version fed the f32 cells within :data:`K12_F64_RTOL`; the distance to
    the f64 plain version on its own cells is reported. Returns the row."""
    import torch

    from ndtpu_torch.ndt import grid as ndt_grid
    from ndtpu_torch.ndt import match as ndt_match

    from ndtpu_torch import kernels

    args = (poses, points, mask, ndt_map, grid, mcfg)
    run = lambda: ndt_match.score_grad_hess_batch(*args)
    out, again = run(), run()
    ref = ndt_match.score_grad_hess_batch_ref(*args)
    cpu = lambda x: x.cpu().double()
    ref64 = ndt_match.score_grad_hess_batch_ref(
        cpu(poses), cpu(points), mask.cpu(),
        ndt_grid.NDTMap(*(cpu(t) for t in ndt_map)), grid, mcfg)
    torch.cuda.synchronize()
    require(bits_equal(out, again), f"K12 {label}: two launches differ")
    err = _rel_check(f"K12 {label} vs f32 plain", out, ref)
    err64_own = max(float((cpu(x) - r).abs().max())
                    for x, r in zip(out, ref64))
    ref64_f32, n_flip, edge_max = k12_f64_on_f32_cells(*args)
    require(edge_max <= K12_EDGE_EPS,
            f"K12 {label}: a beam's cell differs between f32 and f64 "
            f"{edge_max:.3e} m from a cell edge (> {K12_EDGE_EPS:g} m)")
    err64 = _rel_check(f"K12 {label} vs f64 plain on the f32 cells",
                       [cpu(x) for x in out], ref64_f32, rtol=K12_F64_RTOL)
    ms = time_ms(run)
    plain = time_ms(lambda: ndt_match.score_grad_hess_batch_ref(*args))
    bd = k12_bound(poses, points, mask, ndt_map, grid)
    n_triples = poses.shape[0] * grid.overlap * int(mask.sum())
    name = kernels.variant("K12 ndt_sgh_unpacked", grid.overlap)
    print(f"[smoke] {name} {label} B={poses.shape[0]} N={points.shape[0]} "
          f"G={grid.overlap} x {grid.n_cells} cells: vs f32 plain max "
          f"abs err {err:.3e} (rtol 1e-5 of each output's max); bit-identical "
          f"on a second launch; {n_flip} of {n_triples} live (pose, grid, "
          f"beam) triples change cell between f32 and f64, each within "
          f"{edge_max:.3e} m of a cell edge; vs f64 plain on the f32 cells "
          f"{err64:.3e} (rtol {K12_F64_RTOL:g}), on its own cells "
          f"{err64_own:.3e}; kernel {ms:.4f} "
          f"ms, plain {plain:.4f} ms, bound {bd['bound_ms']:.6f} ms "
          f"({bd['bound_by']})")
    row = dict(max_abs_err=err, max_abs_err_f64=err64,
               max_abs_err_f64_own_cells=err64_own, flipped_triples=n_flip,
               flip_edge_m=edge_max, ms=ms, plain_ms=plain, **bd)
    card_time(jobs, f"{name} {label}", row, "card_ms", run,
              ["ndt_sgh_unpacked"])
    return row


def k9c_bound(t, lin) -> dict:
    """Bytes: the rank's K5 rows and routing tables read once, the five
    parts written; operations: 54 per routed 3x3 pair, 18 per routed
    ``A^T r``, 4 per damped diagonal entry."""
    ai, ap = lin[0], lin[3]
    ni, ns = t.ni, t.ns
    out = 9 * ni * ni + 9 * ni * ns + 9 * ns * ns + 3 * ni + 3 * ns
    tables = sum(getattr(t, k).numel() for k in ("row_ptr", "tgt_col",
                                                 "tgt_ptr", "code",
                                                 "vec_ptr", "vcode"))
    return bound(ai.shape[0] * 84 + ap.shape[0] * 48 + tables * 4 + ni
                 + out * 4, 54.0 * t.code.numel() + 18.0 * t.vcode.numel()
                 + 4.0 * 3 * ni)


def k9c_ranks(graph, n_ranks: int) -> tuple:
    """``graph`` split into ``n_ranks`` shards (phase 13's layout): the plan
    and, per rank, its tables on the graph's device, its K5 rows and its
    factor and prior masks."""
    from ndtpu_torch.dist import schur

    plan = schur.plan_partition(
        graph.bet_i.cpu().numpy(), graph.bet_j.cpu().numpy(),
        graph.bet_mask.cpu().numpy(), graph.prior_idx.cpu().numpy(),
        graph.prior_mask.cpu().numpy(), graph.poses.shape[0], n_ranks)
    ranks = []
    for rank in range(n_ranks):
        t = schur.rank_tables(plan, rank, graph.poses.device)
        loc = tuple(x[0] for x in schur.shard_factor_data_local(graph, plan,
                                                                rank))
        ranks.append((t, schur._linearize_shard(graph.poses, *loc),
                      (loc[4], loc[8])))
    return plan, ranks


def k9c_library_call(t, lin, masks):
    """One ``index_add_`` computing K9c's three matrices: the plain
    version's segment sums as one ``index_add_`` of the routed blocks
    (``A^T B`` made beforehand) into the zeroed, flat ``h_ii``, ``h_is`` and
    ``h_ss``, without the damping; K9c's yardstick (``library_ms``), not on
    any path."""
    import torch

    from ndtpu_torch.dist import schur

    (ra, la, rb, lb, vals, valid), _ = schur._local_blocks(
        *lin, masks[0], t.i_role, t.i_loc, t.j_role, t.j_loc, masks[1],
        t.p_role, t.p_loc)
    ni, ns = t.ni, t.ns
    n_ii, n_is, n_ss = 9 * ni * ni, 9 * ni * ns, 9 * ns * ns
    ii = (ra == 0) & (rb == 0) & valid
    is_ = (ra == 0) & (rb == 1) & valid
    ss = (ra == 1) & (rb == 1) & valid
    ids = torch.cat([schur._block_ids(la, lb, ni, ii),
                     schur._block_ids(la, lb, ns, is_) + n_ii,
                     schur._block_ids(la, lb, ns, ss) + n_ii + n_is])
    vv = torch.cat([vals, vals, vals])
    keep = ids < n_ii + n_is + n_ss
    ids, vv = ids[keep], vv[keep]
    return lambda: torch.zeros(n_ii + n_is + n_ss,
                               device=vv.device).index_add_(0, ids, vv)


def check_k9c(graph, n_ranks: int, lam: float, jobs=None):
    """K9c ``schur_local_assemble`` on each rank's rows of ``graph`` split
    into ``n_ranks`` shards (phase 13's layout), against its plain version
    in f32 on the card and in f64 on the CPU (each part within rtol 1e-5 of
    its max |.|), bit-equal to the plain model of its sum order
    (``schur_local_assemble_model``) and on a second launch; the plain
    segment sums' ``index_add_`` of the routed blocks (the library call,
    without the damping) timed beside it. Returns the row of the rank with
    the most interior slots (rank 0), with each rank's size and time."""
    import torch

    from ndtpu_torch.dist import schur

    plan, ranks = k9c_ranks(graph, n_ranks)
    rows = []
    for rank, (t, lin, masks) in enumerate(ranks):
        t64 = schur.rank_tables(plan, rank, "cpu")
        # Bound now: each rank's card time is read after the loop.
        run = lambda t=t, lin=lin, masks=masks: schur.schur_local_assemble(
            t, lam, *lin, *masks)
        out, again = run(), run()
        model = schur.schur_local_assemble_model(plan, rank, lam, *lin)
        ref = schur.schur_local_assemble_ref(t, lam, *lin, *masks)
        ref64 = schur.schur_local_assemble_ref(
            t64, lam, *_cpu64(lin), *(m.cpu() for m in masks))
        torch.cuda.synchronize()
        require(bits_equal(out, again), f"K9c rank {rank}: two launches "
                f"differ")
        require(bits_equal(out, model), f"K9c rank {rank}: differs from the "
                f"plain model of its sum order (schur_local_assemble_model)")
        err = _rel_check(f"K9c rank {rank} vs f32 plain", out, ref)
        err64 = _rel_check(f"K9c rank {rank} vs f64 plain", _cpu64(out),
                           ref64)
        ms = time_ms(run)
        plain = time_ms(lambda: schur.schur_local_assemble_ref(t, lam, *lin,
                                                               *masks))
        lib_fn = k9c_library_call(t, lin, masks)
        lib = time_ms(lib_fn)
        bd = k9c_bound(t, lin)
        ni, ns = t.ni, t.ns
        print(f"[smoke] K9c schur_local_assemble rank {rank}/{n_ranks} "
              f"ni={ni} ns={ns} ({t.tgt_col.numel()} target blocks, "
              f"{t.code.numel()} pairs): vs f32 plain max abs err {err:.3e}, "
              f"vs f64 plain {err64:.3e} (rtol 1e-5 of each part's max); "
              f"bit-equal to the plain model of its sum order and on a "
              f"second launch; kernel {ms:.4f} ms, plain "
              f"{plain:.4f} ms, library (index_add_ of the routed blocks, no "
              f"damping) {lib:.4f} ms, bound {bd['bound_ms']:.6f} ms "
              f"({bd['bound_by']})")
        row = dict(max_abs_err=err, max_abs_err_f64=err64, ms=ms,
                   plain_ms=plain, ni=ni, ns=ns, **bd)
        row.update(library_ms=lib, library="torch.Tensor.index_add_ of the "
                   "routed 3x3 blocks into h_ii, h_is and h_ss (flat): the "
                   "same sums without the damping")
        card_time(jobs, f"K9c schur_local_assemble rank {rank}", row,
                  "card_ms", run, ["supernodal_assemble_kernel<true"],
                  per_call=1)
        card_time(jobs, f"K9c library call rank {rank}", row,
                  "library_card_ms", lib_fn)
        rows.append(row)
    rows[0]["ranks"] = [dict(ni=r["ni"], ms=r["ms"]) for r in rows]
    return rows[0]


def b_placement_err(graph_poses, sa, sb, t_true) -> float:
    """Mean distance of session B's live keyframes in the merged graph from
    their placement by the true transform (``test_multisession_e2e.py``'s
    measure)."""
    import torch

    from ndtpu_torch.lie import se2

    na = sa.graph.capacity
    idx = torch.nonzero(sb.kf.live).squeeze(-1)
    true_b = se2.compose(t_true.expand(idx.shape[0], 3),
                         sb.graph.poses[idx])
    d = graph_poses[na + idx, :2] - true_b[:, :2]
    return float(torch.hypot(d[:, 0], d[:, 1]).mean())


def run_merge(dev, card, npz_path, jobs, keep=None, changes=None):
    """Phase 12: config 5's merge on the card at
    ``configs/config5_multisession.json``. The two sessions
    (:func:`config5_sessions`) run through ``run_slam_windowed``; then,
    with every launch counter reset just before and read just after and
    every plain version made to raise on CUDA tensors (``PLAIN_CONFIG5``,
    also around the in-process solves), the merge itself: ``global_align`` (JAX's defaults: span 8, step 1, 16
    headings, 5 coarse iterations, top 64) of B's first keyframe scan in
    A's map, the perturbed transform ``t_bad = align o [0.25, -0.2, 0.06]``
    (bench.py:622-623), ``find_inter_session_loops``, the anchor-only and
    the auto merge (``merge_graphs``) and ``merged_map_stats``. Gates:
    converged within 0.1 m / 0.02 rad of the truth and of JAX f32's
    transform; two K12 and two ``lm_ndt`` launches (one per pass), one
    gated verify, one K3; at least one inter-session loop and half JAX's
    count; the map's counts equal K3's plain version's exactly; both
    perturbed merges solved in process by PCG as the reference solves them
    (``optimize(method="pcg")``, 15 iterations, bench.py:642-649; K6g, one
    launch per ``pcg`` call, counters reset just before) with B's
    placement error at most max(0.15 m, 2 x JAX f32's), and below 0.6 x
    the anchor-only one
    where JAX f32's own run is (on this pair it is not: under the 0.06 rad
    perturbation most accepted inter-session factors sit on an
    along-corridor alias in the JAX package too, which the reference file
    records as the factors' error against the truth; the smoke prints the
    port's). Writes the graph the distributed solve takes (the sessions
    merged at the aligned transform with the inter-session factors found
    there) to ``npz_path`` and solves it in process at phase 13's 10
    iterations. Returns ``(launches, summary, that graph, its chi2 at 10
    iterations, K12's row)``; puts the sessions' inputs (``seqs``), final
    states (``sa``, ``sb``), ``t_bad`` (``t_ab``) and the merged statistics
    (``stats``) into ``keep``, for phase 15.

    Phase 12b (``changes``, :data:`CONFIG5_OVERLAP1`): the same on the
    published JSON with only those fields changed (written to a temporary
    file), every counter in the layout (``ndt_sgh_unpacked[g1]``,
    ``lm_ndt[g1l8]``, the gated verify and K3 at overlap 1), gated against
    the JAX package's merge under the same flags
    (``tests/data/torch_config5_overlap1_ref.json``): the alignment within
    max(0.1 m / 0.02 rad, 2 x JAX f32's error) of the truth and of JAX
    f32's transform, an inter-session loop wherever JAX closes one, and B's
    placement as above; no graph is written and no supernodal solve runs
    (``npz_path`` None)."""
    import dataclasses

    import torch

    from ndtpu_torch import kernels
    from ndtpu_torch.config import MatchConfig, PipelineConfig, SolverConfig
    from ndtpu_torch.dist import launch
    from ndtpu_torch.graph import solve as slv
    from ndtpu_torch.graph import supernodal as sn
    from ndtpu_torch.lie import se2
    from ndtpu_torch.loop import closure
    from ndtpu_torch.ndt import grid as ndt_grid
    from ndtpu_torch.ndt import match
    from ndtpu_torch.slam import merge, pipeline

    ref = json.loads((REF5_OVERLAP1_FILE if changes else REF5_FILE)
                     .read_text())
    j32 = ref["f32"]
    with tempfile.TemporaryDirectory(prefix="ndtpu_config5_") as tmp:
        path = Path(tmp) / "config5.json"
        path.write_text(json.dumps(layout_json(CONFIG5, changes or {})))
        cfg = PipelineConfig.from_json(str(path))
    tag = "config 5" + (f" {json.dumps(changes)}" if changes else "")
    g, g_loc = cfg.grid.overlap, cfg.loop.local_overlap
    lanes = 4 if cfg.match.compact_table else 8
    k12 = kernels.variant("ndt_sgh_unpacked", g)
    lm, k3 = kernels.variant("lm_ndt", g, lanes), kernels.variant(
        "halfcell_add", g)
    gated = kernels.variant("loop_gate_fused", g_loc, lanes)
    grouped = kernels.variant("lm_ndt_grouped", g_loc, lanes)
    seqs, t_true, _ = config5_sessions(dev)
    t_true = t_true.to(dev)
    t0 = time.perf_counter()
    sa, sb = (pipeline.run_slam_windowed(s.points, s.mask, s.odom, cfg)[0]
              for s in seqs)
    torch.cuda.synchronize()
    sessions_s = time.perf_counter() - t0
    map_a = ndt_grid.finalize(sa.stats, cfg.ndt)
    probe, probe_mask = sb.kf.points[0], sb.kf.masks[0]

    verify_counts, restore = _counting(closure,
                                       "verify_candidates_cached_flat")
    stage = {}
    try:
        with no_plain_on_card(PLAIN_CONFIG5):
            kernels.reset_launches()
            match.CALLS["match_batch_packed"] = 0
            t1 = time.perf_counter()
            res = merge.global_align(map_a, cfg.grid, probe, probe_mask)
            transform = res.transform.cpu()
            stage["align_s"] = time.perf_counter() - t1
            t_bad = se2.compose(res.transform, torch.tensor(
                [0.25, -0.2, 0.06], device=dev))
            t1 = time.perf_counter()
            loops = merge.find_inter_session_loops(
                sa.kf, sb.kf, t_bad, cfg.loop, cfg.match, ndt_cfg=cfg.ndt)
            n_loops = int(loops[0].shape[0])
            stage["loops_s"] = time.perf_counter() - t1
            t1 = time.perf_counter()
            sq = torch.diag(torch.tensor([10.0, 10.0, 20.0], device=dev))
            anchor = (torch.tensor([0], device=dev),
                      torch.tensor([0], device=dev), t_bad[None], sq[None])
            g_anchor = merge.merge_graphs(sa.graph, sb.graph, t_bad, anchor)
            g_auto = merge.merge_graphs(sa.graph, sb.graph, t_bad, loops)
            torch.cuda.synchronize()
            stage["merge_graphs_s"] = time.perf_counter() - t1
            t1 = time.perf_counter()
            stats = merge.merged_map_stats(sa.kf, sb.kf, t_bad, cfg.grid)
            torch.cuda.synchronize()
            stage["map_s"] = time.perf_counter() - t1
            launches = dict(kernels.LAUNCHES)
            calls = match.CALLS["match_batch_packed"]
    finally:
        restore()
    verifies = verify_counts["n"]

    err = se2.between(transform, t_true.cpu())
    err_j = se2.between(transform, torch.tensor(j32["transform"]))
    require(bool(res.converged), f"{tag}: the alignment did not converge")
    je = j32["transform_err"]
    lim_xy = max(0.1, 2 * float(torch.hypot(*torch.tensor(je[:2]))))
    lim_th = max(0.02, 2 * abs(je[2]))
    for name, e in (("the truth", err), ("JAX f32's transform", err_j)):
        require(float(torch.hypot(e[0], e[1])) <= lim_xy
                and abs(float(e[2])) <= lim_th,
                f"{tag}: alignment {transform.tolist()} off {name} by "
                f"{e.tolist()} ({lim_xy:g} m / {lim_th:g} rad allowed)")
    require(launches[k12] == 2 and launches[lm] == 2 == calls - verifies,
            f"{tag}: {launches[k12]} {k12} and {launches[lm]} {lm} "
            f"launches in the alignment (two each expected: one per pass)")
    require(verifies == 1 and launches[gated] == 1
            and launches[grouped] == 1 and launches["loop_gate"] == 0
            and launches["loop_lanes"] == 1,
            f"{tag}: {launches[gated]} gated verifies ({gated}) and "
            f"{launches['loop_lanes']} K15 launches for {verifies} loop "
            f"searches (one each expected)")
    require(launches[k3] == 1,
            f"{tag}: {launches[k3]} {k3} launches in merged_map_stats (one "
            f"expected)")
    least = (min(1, j32["inter_loops"]) if changes
             else max(1, 0.5 * j32["inter_loops"]))
    require(n_loops >= least,
            f"{tag}: {n_loops} inter-session loops, JAX f32 "
            f"{j32['inter_loops']} (at least {least} expected)")
    # The merged map: K3's counts equal its plain version's exactly.
    wa = se2.transform(sa.kf.poses, sa.kf.points).reshape(-1, 2)
    wb = se2.transform(se2.compose(t_bad.expand_as(sb.kf.poses),
                                   sb.kf.poses), sb.kf.points).reshape(-1, 2)
    pts = torch.cat([wa, wb])
    msk = torch.cat([(sa.kf.masks & sa.kf.live[:, None]).reshape(-1),
                     (sb.kf.masks & sb.kf.live[:, None]).reshape(-1)])
    plain = ndt_grid.halfcell_add_ref(
        ndt_grid.empty_stats(cfg.grid, torch.float32, dev), pts, msk, 1.0,
        cfg.grid)
    require(torch.equal(stats.n, plain.n),
            f"{tag}: merged_map_stats' counts differ from K3's plain "
            f"version")
    # Both merges solved in process by PCG, as the reference does
    # (bench.py:642-649), with the launch counters reset just before and
    # the pcg calls counted: one K6g launch each; B's placement.
    require(kernels.pcg_route(g_auto.poses.shape[0], g_auto.bet_i.shape[0],
                              g_auto.prior_idx.shape[0]) == "grid",
            f"{tag}: the merged graph fits K6's one block")
    counts, restore = _counting(slv, "pcg")
    t1 = time.perf_counter()
    try:
        with no_plain_on_card(PLAIN_CONFIG5):
            kernels.reset_launches()
            errs = [b_placement_err(slv.optimize(
                g, SolverConfig(max_iter=15), method="pcg").graph.poses, sa,
                sb, t_true) for g in (g_anchor, g_auto)]
            torch.cuda.synchronize()
            solve_launches = dict(kernels.LAUNCHES)
    finally:
        restore()
    stage["solves_s"] = time.perf_counter() - t1
    require(solve_launches["pcg_solve_grid"] == counts["n"] > 0
            and solve_launches["pcg_solve"] == 0,
            f"{tag}: {solve_launches['pcg_solve_grid']} K6g and "
            f"{solve_launches['pcg_solve']} K6 launches for {counts['n']} "
            f"pcg calls in the merge solves (one K6g each, no K6 expected)")
    launches = {k: v + solve_launches[k] for k, v in launches.items()}
    stage["solve_pcg_calls"] = counts["n"]
    jax_ratio = (j32["b_placement_err_auto_m"]
                 < 0.6 * j32["b_placement_err_anchor_m"])
    require(errs[1] <= max(0.15, 2 * j32["b_placement_err_auto_m"])
            and (errs[1] < 0.6 * errs[0] or not jax_ratio),
            f"{tag}: B placement error {errs[1]:.4f} m (auto) vs "
            f"{errs[0]:.4f} m (anchor only); needs <= max(0.15, 2 x JAX "
            f"f32's {j32['b_placement_err_auto_m']:.4f})"
            + (" and < 0.6 x anchor" if jax_ratio else ""))
    # Each accepted factor against the sessions placed by the truth.
    i_a, j_b, z = loops[:3]
    zt = se2.between(sa.kf.poses[i_a], se2.compose(
        t_true.expand(j_b.shape[0], 3), sb.kf.poses[j_b]))
    loop_err = torch.hypot(*(zt[:, :2] - z[:, :2]).T).cpu()
    with no_plain_on_card(PLAIN_CONFIG5):
        loops_al = merge.find_inter_session_loops(
            sa.kf, sb.kf, res.transform, cfg.loop, cfg.match,
            ndt_cfg=cfg.ndt)
        g_dist = merge.merge_graphs(sa.graph, sb.graph, res.transform,
                                    loops_al)
        if npz_path is not None:
            launch.save_graph_npz(str(npz_path), g_dist)
            sol = sn.optimize_supernodal(g_dist, SolverConfig(max_iter=10))
    chi10 = float(sol.chi2) if npz_path is not None else None
    sol_iters = int(sol.n_iter) if npz_path is not None else None
    summary = dict(
        sessions_s=sessions_s, keyframes=[int(sa.kf.n), int(sb.kf.n)],
        in_session_loops=[int(sa.n_loops), int(sb.n_loops)],
        transform=transform.tolist(), transform_err=err.tolist(),
        jax_f32_transform=j32["transform"], inter_loops=n_loops,
        jax_f32_inter_loops=j32["inter_loops"],
        inter_loop_err_m=dict(median=float(loop_err.median()),
                              p90=float(loop_err.quantile(0.9)),
                              over_0_3=int((loop_err > 0.3).sum())),
        jax_f32_inter_loop_err_m=j32["inter_loop_err_m"],
        b_placement_err_anchor_m=errs[0], b_placement_err_auto_m=errs[1],
        jax_f32_b_placement_err_m=[j32["b_placement_err_anchor_m"],
                                   j32["b_placement_err_auto_m"]],
        merged_points=int(msk.sum()), merged_stats_n=float(stats.n.sum()),
        aligned_inter_loops=int(loops_al[0].shape[0]),
        jax_f32_aligned_inter_loops=j32["aligned_inter_loops"],
        merged_poses=int(g_dist.poses.shape[0]),
        merged_factor_slots=int(g_dist.bet_i.shape[0]),
        supernodal_chi2_10=chi10, supernodal_iters_10=sol_iters,
        **({"changes": changes} if changes else {}), **stage)
    chi_txt = (f"chi2 after 10 supernodal iterations {chi10:.6e} (JAX f32 "
               f"schur {j32['schur_chi2_after']:.6e})" if chi10 is not None
               else "not solved here")
    print(f"[smoke] {tag} merge ({card}): sessions {sessions_s:.2f} s "
          f"(keyframes {summary['keyframes']}, loops "
          f"{summary['in_session_loops']}); alignment {transform.tolist()} "
          f"(truth {t_true.tolist()}, JAX f32 {j32['transform']}) in "
          f"{stage['align_s']:.3f} s; {n_loops} inter-session loops (JAX f32 "
          f"{j32['inter_loops']}) in {stage['loops_s']:.3f} s, their "
          f"error against the truth median "
          f"{summary['inter_loop_err_m']['median']:.3f} m, "
          f"{summary['inter_loop_err_m']['over_0_3']} over 0.3 m (JAX f32 "
          f"{j32['inter_loop_err_m']}); B placement "
          f"{errs[0]:.4f} m anchor-only -> {errs[1]:.4f} m auto (JAX f32 "
          f"{j32['b_placement_err_anchor_m']:.4f} -> "
          f"{j32['b_placement_err_auto_m']:.4f}); merged map "
          f"{summary['merged_points']} points in {stage['map_s']:.4f} s; "
          f"graph {summary['merged_poses']} poses, "
          f"{summary['merged_factor_slots']} factor slots; the aligned "
          f"merge ({summary['aligned_inter_loops']} inter-session loops, JAX "
          f"f32 {j32['aligned_inter_loops']}): {chi_txt}; launches "
          f"{ {k: v for k, v in launches.items() if v} }")
    # K12 at the shapes the alignment gives it: the coarse results of all
    # 4,624 hypotheses, then the 64 refined (global_align's passes, again).
    mcfg = dataclasses.replace(cfg.match, reject_tol=1e-3)
    coarse_cfg = MatchConfig(max_iter=5, tol=mcfg.tol, d2=mcfg.d2,
                             reject_tol=1e-3, init_lambda=mcfg.init_lambda,
                             step_clip=mcfg.step_clip)
    hyp = merge._hypothesis_grid(8.0, 1.0, 16, torch.float32, dev)
    h, n = hyp.shape[0], probe.shape[0]
    coarse = match.match_batch(probe.expand(h, n, 2),
                               probe_mask.expand(h, n), map_a, hyp,
                               cfg.grid, coarse_cfg).pose
    row = check_k12("coarse", coarse, probe, probe_mask, map_a, cfg.grid,
                    mcfg, jobs)
    top = merge._descending(res.grid_scores, 64)
    refined = match.match_batch(probe.expand(64, n, 2),
                                probe_mask.expand(64, n), map_a, coarse[top],
                                cfg.grid, mcfg).pose
    row["refine"] = check_k12("refine", refined, probe, probe_mask, map_a,
                              cfg.grid, mcfg, jobs)
    if keep is not None:
        keep.update(seqs=seqs, sa=sa, sb=sb, t_ab=t_bad, stats=stats)
    return launches, summary, g_dist, chi10, {k12: row}


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_distributed(dev, card, npz_path, chi10: float):
    """Phase 13: ``launch_local(2, graph_npz=..., device="cuda")``, two
    ranks on the card over gloo solving phase 12's aligned merge by
    ``optimize_schur`` (10 iterations, the reference worker's cap). Gates:
    chi^2 not rising, below max(0.5 x before, 50) (the JAX package's
    ``test_multisession_e2e.py:190``), within 2% of phase 12's in-process
    ``optimize_supernodal`` chi^2 at the same cap (both eliminate the same
    f32 normal equations exactly, in other partitions: past chi^2's noise
    floor the last iterations move it by roundoff, as config 4's f32 runs
    sit within 1.02 x JAX's); each rank one K9c and two K5 launches and
    four all-reduces per iteration, its counters reset in the rank just
    before the solve. Returns ``(launches, record)``."""
    from ndtpu_torch.dist import launch

    t0 = time.perf_counter()
    rec = launch.launch_local(2, graph_npz=str(npz_path), port=free_port(),
                              device="cuda", timeout_s=600.0)
    wall = time.perf_counter() - t0
    chi0, chi1, iters = rec["chi2_before"], rec["chi2_after"], rec["iters"]
    require(rec["num_processes"] == 2 and rec["device"] != "cpu",
            f"config 5 distributed: {rec['num_processes']} ranks on "
            f"{rec['device']}")
    require(chi1 <= chi0 and chi1 < max(0.5 * chi0, 50.0),
            f"config 5 distributed: chi2 {chi0:.6e} -> {chi1:.6e}")
    require(abs(chi1 - chi10) <= 0.02 * chi10,
            f"config 5 distributed: chi2 {chi1:.6e} vs {chi10:.6e} in "
            f"process (supernodal, same cap; 2% allowed)")
    for r in rec["ranks"]:
        require(r["iters"] == iters > 0 and r["k9c"] == iters
                and r["k5"] == 2 * iters and r["all_reduce"] == 4 * iters,
                f"config 5 distributed: rank launches {r} for {iters} "
                f"iterations (one K9c, two K5, four all-reduces each)")
    from ndtpu_torch import kernels

    launches = {k: 0 for k in kernels.LAUNCHES}
    launches["schur_local_assemble"] = int(sum(r["k9c"]
                                               for r in rec["ranks"]))
    launches["factor_linearize"] = int(sum(r["k5"] for r in rec["ranks"]))
    print(f"[smoke] config 5 distributed solve ({card}): 2 ranks on "
          f"{rec['device']} over gloo, {rec['n_poses']} pose slots, chi2 "
          f"{chi0:.6e} -> {chi1:.6e} in {iters} iterations (in process "
          f"{chi10:.6e}); optimize {rec['optimize_s']:.3f} s = "
          f"{rec['ms_per_iter']:.2f} ms/iter, all-reduce "
          f"{rec['all_reduce_ms_per_iter']:.2f} ms/iter (warm: "
          f"{rec['warm_ms_per_iter']:.2f} and "
          f"{rec['warm_all_reduce_ms_per_iter']:.2f}); solve_s (one step, "
          f"min of 9) {rec['solve_s']:.4f}, psum_s (8 floats, median of 5) "
          f"{rec['psum_s']:.5f}; launch_local {wall:.1f} s; ranks "
          f"{rec['ranks']}")
    rec["launch_local_s"] = wall
    return launches, rec


# Config 5's slab-sharded map: ``launch --task slam`` (phase 14) and the
# sharded map, registration and sessions across two ranks (phase 15).

#: The plain versions the slab path must not reach with CUDA tensors.
PLAIN_SLAB = PLAIN_CONFIG5 + (
    ("ndtpu_torch.ndt.grid", "finalize_ref"),
    ("ndtpu_torch.dist.gridmap", "slab_accumulate_ref"),
    ("ndtpu_torch.dist.gridmap", "slab_sgh_ref"))
#: Set in the environment of phase 14's ranks to a directory: the
#: ``sitecustomize.py`` the smoke writes for them makes every plain
#: version of :data:`PLAIN_SLAB` raise on CUDA tensors there for the whole
#: process, and each rank reports that in a file of that directory. Then
#: it runs the ``sitecustomize`` it shadows, where there is one (a Python
#: distribution's own).
REFUSE_PLAIN_ENV = "NDTPU_SMOKE_REFUSE_PLAIN"
_SITECUSTOMIZE = '''import importlib.machinery, importlib.util, os, sys
if os.environ.get("{env}"):
    sys.path.insert(0, {root!r})
    import chip_smoke
    chip_smoke.refuse_plain_for_good(os.environ["{env}"])
    sys.path.remove({root!r})
_s = importlib.machinery.PathFinder.find_spec("sitecustomize", [
    p for p in sys.path if os.path.abspath(p or ".") != {site!r}])
if _s is not None:
    _s.loader.exec_module(importlib.util.module_from_spec(_s))
'''
#: Tolerances of s and ss against the f64 sums on the same cells, as
#: fractions of the f64 sums of |terms| (|p| and |p p^T|): one f32
#: rounding of a value summed exactly (K10a's moments: 2^-24, with a
#: factor 2 to spare), and up to three (the halo exchange adds the
#: neighbour's rounded halo to the rounded core, whose signs may differ in
#: a cell across an axis: 2^-24 x (|A| + |B| + |A + B|)); plus, per point
#: of the cell, the fixed point's rounding (2^-33 of a cell per term,
#: times twice the map's largest |coordinate|, 64 m: under 1e-8).
K10A_RTOL, SLAB_RTOL, SLAB_ATOL_PER_POINT = 2.0 ** -23, 2.0 ** -22, 1e-8
#: ``match_slab`` against the in-process ``lm_loop`` on K12 over the same
#: map (test_dist.py:98's tolerance, m and rad).
SLAB_POSE_TOL = 5e-4
#: Where the LM on the point-sharded build's map and the LM on the K3 map
#: part ways, the K3 map's objective at the ``match_slab`` pose may exceed
#: its value at the K3 LM's pose by this fraction: ten times the largest
#: relative gap between the two maps' objectives at one pose that the
#: halo-summed cells leave (``objective_gap_max`` in phase 15's record).
SLAB_F_RTOL = 1e-3
#: Phase 15's registrations: B's keyframe scans (every k-th live one) from
#: their merged poses perturbed by N(0, SLAB_PERTURB) with ``--seed``.
SLAB_SCANS, BATCH_SCANS, SLAB_PERTURB = 16, 64, (0.3, 0.3, 0.05)
#: f32/f64 operations of K10a per (grid, point) (binning, the six
#: fixed-point terms) and per slab cell (the moments), counted from
#: ``csrc/slab_accum.cu``; of K10b per cell (``ndt_cell.cuh``).
K10A_POINT_FLOPS, K10A_CELL_FLOPS, K10B_CELL_FLOPS = 20, 30, 45


_REFUSING = []


def refuse_plain_for_good(report_dir: str):
    """Make :data:`PLAIN_SLAB` raise on CUDA tensors for the rest of this
    process (phase 14's ranks, through their ``sitecustomize.py``), and
    write ``<report_dir>/<pid>.json``: the plain versions now refusing."""
    import importlib
    import os

    ctx = no_plain_on_card(PLAIN_SLAB)
    ctx.__enter__()
    _REFUSING.append(ctx)
    on = [f"{m}.{n}" for m, n in PLAIN_SLAB
          if getattr(importlib.import_module(m), n).__name__ == "refuse"]
    Path(report_dir, f"{os.getpid()}.json").write_text(json.dumps(on))


def k10a_bound(m: int, live: int, width: int, grid) -> dict:
    """Bytes: the points (8 B) and mask (1 B) read once, the f32 slab (28 B
    a cell) written once; operations: binning per (grid, point), the six
    terms per live (grid, point), the moments per cell."""
    cells = grid.overlap * width * grid.ny
    return bound(9 * m + 28 * cells,
                 grid.overlap * m * 8 + live * K10A_POINT_FLOPS
                 + cells * K10A_CELL_FLOPS)


def check_k10a(label, points, mask, grid, x_lo: int, width: int,
               jobs=None):
    """K10a ``slab_accumulate`` on the card at ``(x_lo, width)``: bit for bit
    equal to its fixed-point model (``slab_accumulate_fixed_ref``, on the
    card), on a second launch and with the points in a random order;
    against its f32 plain version (rtol 1e-5 of each output's max) and the
    f64 sums on the same cells (:data:`K10A_RTOL`); timed beside the plain
    version and the library call, the plain version's three
    ``index_add_``. Returns the row."""
    import torch

    from ndtpu_torch import kernels
    from ndtpu_torch.dist import gridmap

    name = kernels.variant("K10a slab_accumulate", grid.overlap)
    run = lambda: gridmap.slab_accumulate(points, mask, grid, x_lo, width)
    out, again = run(), run()
    perm = torch.randperm(points.shape[0], device=points.device,
                          generator=torch.Generator(points.device).manual_seed(
                              11))
    shuffled = gridmap.slab_accumulate(points[perm], mask[perm], grid, x_lo,
                                       width)
    model = gridmap.slab_accumulate_fixed_ref(points, mask, grid, x_lo,
                                              width)
    plain = gridmap.slab_accumulate_ref(points, mask, grid, x_lo, width)
    torch.cuda.synchronize()
    require(bits_equal(out, again) and bits_equal(out, shuffled),
            f"{name} {label}: launches differ (again or permuted)")
    require(bits_equal(out, model),
            f"{name} {label}: differs from its fixed-point model")
    err = _rel_check(f"{name} {label} vs f32 plain", out, plain)
    ref64 = slab_f64(points, mask, grid, x_lo, width)
    err64 = slab_close(f"{name} {label} vs f64", out, *ref64, K10A_RTOL)
    ms = time_ms(run)
    plain_ms = time_ms(lambda: gridmap.slab_accumulate_ref(
        points, mask, grid, x_lo, width))
    _, lx, iy, live = gridmap._slab_cells(points, mask, grid, x_lo, width)
    w = live.float()
    lib_fn = lambda: gridmap._accum_local(points, w, lx, iy, width, grid)
    lib = time_ms(lib_fn)
    bd = k10a_bound(points.shape[0], int(live.sum()), width, grid)
    print(f"[smoke] {name} {label} M={points.shape[0]} "
          f"({int(live.sum())} live (grid, point) pairs) into "
          f"{grid.overlap} x {width} x {grid.ny} cells: bit-equal to its "
          f"fixed-point model, on a second "
          f"launch and permuted; vs f32 plain max abs err {err:.3e}; vs f64 "
          f"sums on the same cells {err64:.3e} (rtol {K10A_RTOL:.3g}); "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library (three "
          f"index_add_) {lib:.4f} ms, bound {bd['bound_ms']:.6f} ms "
          f"({bd['bound_by']})")
    row = dict(max_abs_err=err, max_abs_err_f64=err64, ms=ms,
               plain_ms=plain_ms, **bd)
    row.update(library_ms=lib, library="three torch.Tensor.index_add_ "
               "(n, w p, w p p^T) of the plain version, its bins and "
               "weights made beforehand")
    card_time(jobs, f"{name} {label}", row, "card_ms", run, ["slab_tile"],
              per_call=3 if points.shape[0] else 1)
    card_time(jobs, f"{name} {label} library call", row, "library_card_ms",
              lib_fn)
    return row


def slab_f64(points, mask, grid, x_lo: int, width: int):
    """The f64 sums on K10a's cells, and the f64 sums of their terms'
    magnitudes (``|p|``, ``|p p^T|``): the cells binned from the f32 points
    (as the kernel bins them), the sums over the points in f64 on the
    CPU."""
    from ndtpu_torch.dist import gridmap

    _, lx, iy, live = gridmap._slab_cells(points, mask, grid, x_lo, width)
    p64, w = points.cpu().double(), live.cpu().double()
    return (gridmap._accum_local(p64, w, lx.cpu(), iy.cpu(), width, grid),
            gridmap._accum_local(p64.abs(), w, lx.cpu(), iy.cpu(), width,
                                 grid))


def slab_close(name, out, ref, mag, rtol: float) -> float:
    """``n`` exactly, ``s`` and ``ss`` within ``rtol`` of ``mag`` (the sums
    of the terms' magnitudes) plus :data:`SLAB_ATOL_PER_POINT` per point of
    the cell, entry by entry; returns the largest abs error."""
    import torch

    out = [x.cpu().double() for x in out]
    n = ref.n.double()
    require(torch.equal(out[0], n), f"{name}: counts differ")
    worst = 0.0
    for k, (o, r, m) in enumerate(zip(out[1:], ref[1:], mag[1:]), 1):
        err = (o - r).abs()
        pts = n.reshape(n.shape + (1,) * (r.ndim - n.ndim))
        bad = err > rtol * m + SLAB_ATOL_PER_POINT * pts
        require(not bool(bad.any()), f"{name}: output {k} off by "
                f"{float(err.max()):.3e} at {int(bad.sum())} entries")
        worst = max(worst, float(err.max()))
    return worst


def k10b_records(stats):
    """``stats`` as the slab map's halo exchange hands them on
    (``dist.gridmap._exchange``): views of one contiguous ``[..., 7]``
    tensor of records ``[n, sx, sy, sxx, sxy, syx, syy]``, which K10b reads
    in place."""
    import torch

    from ndtpu_torch.ndt import grid as ndt_grid

    n, s, ss = stats
    lead = tuple(n.shape)
    rec = torch.cat([n[..., None], s, ss.reshape(lead + (4,))], -1)
    return ndt_grid.NDTStats(rec[..., 0], rec[..., 1:3],
                             rec[..., 3:].view(lead + (2, 2)))


def check_k10b(label, stats, ndt_cfg, jobs=None):
    """K10b ``finalize_cells`` (``ndt.grid.finalize`` on CUDA tensors) on
    ``stats`` as three arrays and as the slab exchange's records
    (:func:`k10b_records`, read in place): valid flags equal to its f32
    plain version's, mean and icov within rtol 1e-5 of each output's max,
    bit-identical on a second launch and across the two layouts. Returns
    the row (the three arrays' times; the records' as ``records_ms`` and
    ``records_card_ms``)."""
    import torch

    from ndtpu_torch import kernels
    from ndtpu_torch.ndt import grid as ndt_grid

    st = ndt_grid.NDTStats(*(x.contiguous() for x in stats))
    rec = k10b_records(st)
    require(kernels.finalize_inputs(*st)[0] == "arrays"
            and kernels.finalize_inputs(*rec)[0] == "records",
            f"K10b {label}: the wrapper does not read the three arrays and "
            f"the records in place")
    run = lambda: ndt_grid.finalize(st, ndt_cfg)
    run_rec = lambda: ndt_grid.finalize(rec, ndt_cfg)
    out, again, out_rec = run(), run(), run_rec()
    ref = ndt_grid.finalize_ref(st, ndt_cfg)
    torch.cuda.synchronize()
    require(bits_equal(out, again), f"K10b {label}: two launches differ")
    require(bits_equal(out_rec, out), f"K10b {label}: the records' outputs "
            f"differ from the three arrays'")
    require(torch.equal(out.valid, ref.valid),
            f"K10b {label}: valid flags differ from the plain version's")
    err = _rel_check(f"K10b {label} vs f32 plain", out, ref)
    same = bits_equal(out, ref)
    ms = time_ms(run)
    rec_ms = time_ms(run_rec)
    plain_ms = time_ms(lambda: ndt_grid.finalize_ref(st, ndt_cfg))
    cells = st.n.numel()
    bd = bound(56 * cells, K10B_CELL_FLOPS * cells)
    print(f"[smoke] K10b finalize_cells {label} {tuple(st.n.shape)} "
          f"({int(out.valid.sum())} valid): vs f32 plain max abs err "
          f"{err:.3e}{' (bit-equal)' if same else ''}, valid exact; "
          f"bit-identical on a second launch and on the records; kernel "
          f"{ms:.4f} ms (records {rec_ms:.4f}), plain {plain_ms:.4f} ms, "
          f"bound {bd['bound_ms']:.6f} ms ({bd['bound_by']})")
    row = dict(max_abs_err=err, bit_equal_to_plain=same, ms=ms,
               records_ms=rec_ms, records_bit_equal=True,
               plain_ms=plain_ms, **bd)
    card_time(jobs, f"K10b finalize_cells {label}", row, "card_ms", run,
              ["finalize_cells"], per_call=1)
    card_time(jobs, f"K10b finalize_cells {label} records", row,
              "records_card_ms", run_rec, ["finalize_cells"], per_call=1)
    return row


def k10c_bound(poses, points, mask, slab_map, grid, x_lo: int) -> dict:
    """K12's bound (:func:`k12_bound`) on the slab: the poses, the scan and
    its mask read, each distinct slab cell the run gathers (28 B) read
    once, ``[B, 15]`` written; per masked beam and pose the transform, per
    (beam, grid) the binning, per (beam, grid) in a valid owned cell the
    71 of the sums."""
    import torch

    from ndtpu_torch.dist import gridmap
    from ndtpu_torch.ndt import match as ndt_match

    b, n = poses.shape[0], points.shape[0]
    nxl = slab_map.valid.shape[1]
    x, y, _, _ = ndt_match._lane_transform(poses, points[:, 0][None],
                                           points[:, 1][None])
    ix, iy, inb = gridmap._cell_xy(torch.stack([x, y], -1), grid)
    hit = inb & (ix >= x_lo) & (ix < x_lo + nxl) & mask[None, None, :]
    g = torch.arange(grid.overlap, device=ix.device)[:, None]
    lx = (ix - x_lo).clamp(0, nxl - 1)
    v = slab_map.valid[g, lx, iy] > 0
    cell = (g * nxl + lx) * grid.ny + iy
    n_cells = int(cell[hit].unique().numel())
    flops = (b * int(mask.sum()) * (K12_BEAM_FLOPS
                                    + grid.overlap * K12_BIN_FLOPS)
             + int((hit & v).sum()) * K12_CELL_FLOPS)
    return bound(b * 12 + n * 12 + n_cells * 28 + b * 60, flops)


def check_k10c(label, poses, points, mask, slab_map, grid, x_lo: int, mcfg,
               jobs=None):
    """K10c ``slab_sgh`` against its f32 plain version on the card (each
    output within rtol 1e-5 of its max |.|: the same cells, the sums in
    another order), bit-identical on a second launch. Returns the row."""
    import torch

    from ndtpu_torch import kernels
    from ndtpu_torch.dist import gridmap

    name = kernels.variant("K10c slab_sgh", grid.overlap)
    mask_f = mask.float()
    run = lambda: gridmap.slab_sgh(poses, points, mask_f, slab_map, grid,
                                   x_lo, mcfg)
    out, again = run(), run()
    ref = gridmap.slab_sgh_ref(poses, points, mask_f, slab_map, grid, x_lo,
                               mcfg)
    torch.cuda.synchronize()
    require(bits_equal(out, again), f"{name} {label}: two launches differ")
    err = _rel_check(f"{name} {label} vs f32 plain",
                     [out[:, :3], out[:, 3:6], out[:, 6:]],
                     [ref[:, :3], ref[:, 3:6], ref[:, 6:]])
    ms = time_ms(run)
    plain_ms = time_ms(lambda: gridmap.slab_sgh_ref(
        poses, points, mask_f, slab_map, grid, x_lo, mcfg))
    bd = k10c_bound(poses, points, mask, slab_map, grid, x_lo)
    print(f"[smoke] {name} {label} B={poses.shape[0]} "
          f"N={points.shape[0]} on {grid.overlap} x "
          f"{slab_map.valid.shape[1]} x {grid.ny} cells: vs f32 plain max "
          f"abs err {err:.3e} (rtol 1e-5 of each "
          f"output's max); bit-identical on a second launch; kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
          f"{bd['bound_ms']:.6f} ms ({bd['bound_by']})")
    row = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, **bd)
    card_time(jobs, f"{name} {label}", row, "card_ms", run, ["slab_sgh"])
    return row


def run_slam_launch(dev, card):
    """Phase 14: ``launch_local(2, task="slam", device="cuda")``, the
    reference's own problem (two box-world sessions of 120 scans, one per
    rank, ``dist.launch.slam_sessions``), every plain version of
    :data:`PLAIN_SLAB` made to raise on CUDA tensors in the ranks (through
    a ``sitecustomize.py``; each rank must report it). Gates: test_launch.py:38's (more than 5
    keyframes, ATE under 0.3 m per session), and each rank's state
    bit-equal (its sha256) to an in-process ``run_slam_windowed`` of the
    same session on the card. Returns ``(launches, record)``."""
    import os

    from ndtpu_torch import kernels
    from ndtpu_torch.dist import launch
    from ndtpu_torch.slam import pipeline

    old = os.environ.get("PYTHONPATH")
    with tempfile.TemporaryDirectory(prefix="ndtpu_smoke_site_") as site:
        Path(site, "sitecustomize.py").write_text(_SITECUSTOMIZE.format(
            env=REFUSE_PLAIN_ENV, root=str(ROOT),
            site=os.path.abspath(site)))
        reports = Path(site, "refusing")
        reports.mkdir()
        os.environ["PYTHONPATH"] = os.pathsep.join(
            [site] + ([old] if old else []))
        os.environ[REFUSE_PLAIN_ENV] = str(reports)
        try:
            t0 = time.perf_counter()
            rec = launch.launch_local(2, port=free_port(), task="slam",
                                      device=dev.type, timeout_s=600.0)
            wall = time.perf_counter() - t0
        finally:
            os.environ.pop(REFUSE_PLAIN_ENV)
            if old is None:
                os.environ.pop("PYTHONPATH")
            else:
                os.environ["PYTHONPATH"] = old
        refusing = [json.loads(f.read_text()) for f in reports.iterdir()]
    want = sorted(f"{m}.{n}" for m, n in PLAIN_SLAB)
    require(len(refusing) == rec["num_processes"]
            and all(sorted(r) == want for r in refusing),
            f"slam rehearsal: {len(refusing)} of {rec['num_processes']} "
            f"ranks report their plain versions refusing CUDA tensors "
            f"({refusing})")
    require(rec["task"] == "slam" and rec["num_processes"] == 2
            and rec["device"] != "cpu",
            f"slam rehearsal: {rec['num_processes']} ranks on {rec['device']}")
    require(all(k > 5 for k in rec["keyframes"])
            and all(a < 0.3 for a in rec["ates"]),
            f"slam rehearsal: keyframes {rec['keyframes']}, ATE {rec['ates']} "
            f"(> 5 and < 0.3 m each expected)")
    cfg, seqs = launch.slam_sessions(2, rec["n_scans"])
    with no_plain_on_card(PLAIN_SLAB):
        for k, q in enumerate(seqs):
            st, _ = pipeline.run_slam_windowed(q.points.to(dev),
                                               q.mask.to(dev),
                                               q.odom.to(dev), cfg)
            require(launch.state_sha256(st) == rec["state_sha256"][k],
                    f"slam rehearsal: session {k}'s state on its rank differs "
                    f"from the in-process run on the card")
    launches = {k: 0 for k in kernels.LAUNCHES}
    for row in rec["sessions"]:
        for k, v in row["launches"].items():
            launches[k] += v
    print(f"[smoke] slam rehearsal ({card}): 2 ranks on {rec['device']}, "
          f"{rec['n_scans']} scans each: keyframes {rec['keyframes']}, ATE "
          f"{rec['ates']}; each rank's state bit-equal to the in-process run; "
          f"sessions {[r['run_s'] for r in rec['sessions']]} s, launch_local "
          f"{wall:.1f} s; launches {launches_nonzero(launches)}")
    rec["launch_local_s"] = wall
    return launches, rec


def launches_nonzero(launches) -> dict:
    return {k: v for k, v in launches.items() if v}


def slab_inputs(dev, seed: int, keep, cfg):
    """What phase 15's ranks read: the two sessions' inputs, phase 12's
    merge transform ``t_ab`` and final states' digests, both sessions' live
    keyframe points in A's frame (the replicated build's input), phase 12's
    merged statistics (K3; the dense map of ``match_batch_sharded``), the
    halo (the smallest that drops no point of either rank), and the
    registrations: :data:`SLAB_SCANS` and :data:`BATCH_SCANS` of B's live
    keyframes (every k-th), their merged poses perturbed by
    N(0, :data:`SLAB_PERTURB`) from ``seed``. Returns a dict of numpy
    arrays."""
    import numpy as np
    import torch

    from ndtpu_torch.dist import gridmap
    from ndtpu_torch.dist import launch
    from ndtpu_torch.lie import se2

    sa, sb, t_ab = keep["sa"], keep["sb"], keep["t_ab"]
    world = []
    for st, t in ((sa, None), (sb, t_ab)):
        poses = st.kf.poses if t is None else se2.compose(
            t.expand_as(st.kf.poses), st.kf.poses)
        world.append((se2.transform(poses, st.kf.points).reshape(-1, 2),
                      (st.kf.masks & st.kf.live[:, None]).reshape(-1)))
    d = 2
    halo = max(gridmap.slab_halo(p, m, cfg.grid, d, r)
               for r, (p, m) in enumerate(world))
    live_b = torch.nonzero(sb.kf.live).squeeze(-1)
    rng = np.random.default_rng(seed + 15)
    pick = {}
    for name, k in (("slab", SLAB_SCANS), ("batch", BATCH_SCANS)):
        idx = live_b[torch.linspace(0, live_b.numel() - 1, k).long()]
        truth = se2.compose(t_ab.expand(k, 3), sb.kf.poses[idx])
        noise = torch.as_tensor(rng.normal(0.0, SLAB_PERTURB, (k, 3)),
                                dtype=torch.float32, device=dev)
        pick[name] = (idx, truth + noise)
    seqs = keep["seqs"]
    cpu = lambda t: t.detach().cpu().numpy()
    out = dict(halo=halo, t_ab=cpu(t_ab),
               digest_a=launch.state_sha256(sa),
               digest_b=launch.state_sha256(sb),
               all_pts=cpu(torch.cat([world[0][0], world[1][0]])),
               all_msk=cpu(torch.cat([world[0][1], world[1][1]])),
               **{f"stats_{k}": cpu(v) for k, v in
                  zip(("n", "s", "ss"), keep["stats"])})
    for k, q in zip("ab", seqs):
        out.update({f"points_{k}": cpu(q.points), f"mask_{k}": cpu(q.mask),
                    f"odom_{k}": cpu(q.odom)})
    for name, (idx, init) in pick.items():
        out[f"{name}_idx"] = cpu(idx)
        out[f"{name}_init"] = cpu(init)
    return out


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def slab_worker(rank: int, world: int, port: int, npz: str, out: str,
                device: str = "cuda"):
    """One rank of phase 15 (``chip_smoke.py --slab-worker``): joins the
    gloo group, runs its session through ``run_sessions_sharded`` (one per
    rank; A on rank 0, B on rank 1; in phase 15b, whose inputs carry the
    config's path and the split of ``all_pts`` between the sessions, it
    takes its session's points from phase 12b instead), builds the merged
    map's slab from its own session's live keyframe points (B's moved by
    ``t_ab``) with
    ``build_slab_stats_psharded`` and from both sessions' points with
    ``build_slab_stats``, finalizes both, registers B's scans with
    ``match_slab`` on each and with ``match_batch_sharded`` (against phase
    12's merged map), every plain version of :data:`PLAIN_SLAB` raising on CUDA
    tensors, each stage's launches counted from 0, and writes
    ``<out>.<rank>.npz``."""
    import numpy as np
    import torch

    from ndtpu_torch import kernels
    from ndtpu_torch.config import PipelineConfig
    from ndtpu_torch.dist import gridmap, launch, registration, slam_dp
    from ndtpu_torch.dist import mesh as dmesh
    from ndtpu_torch.lie import se2
    from ndtpu_torch.ndt import grid as ndt_grid

    launch.initialize(f"localhost:{port}", world, rank)
    z = np.load(npz)
    cfg = PipelineConfig.from_json(str(z["config"]) if "config" in z.files
                                   else str(CONFIG5))
    bmesh, smesh = dmesh.batch_mesh(device), dmesh.space_mesh(device)
    dev = bmesh.device
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    t = lambda k: torch.as_tensor(z[k]).to(dev)
    res = {}

    def stage(name, fn):
        _sync(dev)
        torch.distributed.barrier()     # no rank waits on the other's stage
        kernels.reset_launches()
        dmesh.reset_collectives()
        t0 = time.perf_counter()
        val = fn()
        _sync(dev)
        res[f"{name}_s"] = time.perf_counter() - t0
        res[f"{name}_launches"] = json.dumps(kernels.LAUNCHES)
        res[f"{name}_collectives"] = json.dumps(dmesh.COLLECTIVES)
        return val

    with no_plain_on_card(PLAIN_SLAB):
        if "split" in z.files:      # phase 15b: the rank's points as given
            na = int(z["split"])
            own = slice(0, na) if rank == 0 else slice(na, None)
            pts, msk = t("all_pts")[own], t("all_msk")[own]
        else:
            st, _ = stage("sessions", lambda: slam_dp.run_sessions_sharded(
                bmesh, [t("points_a"), t("points_b")],
                [t("mask_a"), t("mask_b")], [t("odom_a"), t("odom_b")], cfg))
            mine = slam_dp._take(st, 0)
            res["digest"] = launch.state_sha256(mine)
            poses = mine.kf.poses
            if rank == 1:
                t_ab = t("t_ab")
                poses = se2.compose(t_ab.expand_as(poses), poses)
            pts = se2.transform(poses, mine.kf.points).reshape(-1, 2)
            msk = (mine.kf.masks & mine.kf.live[:, None]).reshape(-1)
        halo = int(z["halo"])
        ps = stage("psharded", lambda: gridmap.build_slab_stats_psharded(
            smesh, pts, msk, cfg.grid, halo=halo))
        res["ps_layout"] = kernels.finalize_inputs(*ps)[0]
        rep = stage("replicated", lambda: gridmap.build_slab_stats(
            smesh, t("all_pts"), t("all_msk"), cfg.grid))
        smap = stage("finalize", lambda: gridmap.finalize_slab(ps, cfg.ndt))
        rmap = stage("finalize_replicated",
                     lambda: gridmap.finalize_slab(rep, cfg.ndt))
        # B's scans, as their keyframe slots hold them on rank 1 and in
        # phase 12's state (the same bits).
        sidx, bidx = t("slab_idx"), t("batch_idx")
        kp, km = t("kf_points_b"), t("kf_masks_b")
        sinit, binit = t("slab_init"), t("batch_init")
        slab, slab_rep = [], []

        def registrations(m, acc):
            for i in range(sidx.numel()):
                acc.append(gridmap.match_slab(
                    smesh, kp[sidx[i]], km[sidx[i]], m, sinit[i], cfg.grid,
                    cfg.match))
        stage("match_slab", lambda: registrations(smap, slab))
        stage("match_slab_replicated", lambda: registrations(rmap, slab_rep))
        dense = ndt_grid.finalize(ndt_grid.NDTStats(
            t("stats_n"), t("stats_s"), t("stats_ss")), cfg.ndt)
        mb = stage("match_batch", lambda: registration.match_batch_sharded(
            bmesh, kp[bidx], km[bidx], dense, binit, cfg.grid, cfg.match))
    cpu = lambda x: x.detach().cpu().numpy()
    np.savez(f"{out}.{rank}.npz", **res,
             **{f"ps_{k}": cpu(v) for k, v in ps._asdict().items()},
             **{f"rep_{k}": cpu(v) for k, v in rep._asdict().items()},
             **{f"map_{k}": cpu(v) for k, v in smap._asdict().items()},
             **{f"{name}_{k}": np.stack([cpu(getattr(r, f)) for r in rs])
                for name, rs in (("slab", slab), ("slab_rep", slab_rep))
                for k, f in (("pose", "pose"), ("hess", "hessian"),
                             ("iter", "n_iter"), ("conv", "converged"))},
             mb_pose=cpu(mb.pose), mb_iter=cpu(mb.n_iter),
             mb_conv=cpu(mb.converged), halo=halo)
    launch.shutdown()


def traced_lm(ndt_map, points, mask, init, grid, mcfg) -> dict:
    """The in-process ``lm_loop`` on K12 over ``ndt_map`` from ``init``,
    traced: its result, the objective at each evaluation and the pose
    evaluated, and the LM's accept decisions (evaluation k > 0 is taken iff
    its objective is below the last taken one's, as ``lm_loop`` decides)."""
    import torch

    from ndtpu_torch.ndt import match as ndt_match

    poses, fs = [], []

    def sgh(p):
        out = tuple(x[0] for x in ndt_match.score_grad_hess_batch(
            p[None], points, mask, ndt_map, grid, mcfg))
        poses.append(p.detach().cpu())
        fs.append(float(out[0]))
        return out
    res = ndt_match.lm_loop(sgh, init, mcfg)
    taken, cur = [], 0
    for k in range(1, len(fs)):
        taken.append(fs[k] < fs[cur])
        cur = k if taken[-1] else cur
    return dict(result=res, f=fs, poses=torch.stack(poses), taken=taken)


def _objective(ndt_map, points, mask, pose, grid, mcfg) -> float:
    from ndtpu_torch.ndt import match as ndt_match

    return float(ndt_match.score_grad_hess_batch(
        pose.to(points)[None], points, mask, ndt_map, grid, mcfg)[0][0])


def slab_vs_k3(traces, got, scans, ps_stats, k3_stats, ps_map, k3_map,
               grid, cfg) -> dict:
    """``match_slab`` on the point-sharded build's map against the
    in-process LM on phase 12's K3 map. The two maps hold the same points,
    but a cell that both ranks' points reach sums two f32 partials (the
    rank's own and the neighbour's halo, each rounded: the reference's
    ``psum`` of f32 slabs) where K3 rounds one exact sum, and finalize's
    ``ss/n - mean mean^T`` magnifies that rounding in the inverse
    covariance. Where the two in-process LMs (``traces``, K12 on each map)
    take the same accept decisions, the pose is held to
    :data:`SLAB_POSE_TOL`. Where one decision differs, the smoke prints the
    first such evaluation: both maps' margins, the K3 map's margin at the
    slab run's poses, the beams there that land in cells whose statistics
    differ and those cells' largest relative inverse-covariance gap, and
    the LM of each map's statistics in f64 (plain versions on the CPU); and
    it holds the objective on the K3 map at the ``match_slab`` pose to
    within :data:`SLAB_F_RTOL` of its value at the K3 LM's pose."""
    import torch

    from ndtpu_torch.ndt import grid as ndt_grid
    from ndtpu_torch.ndt import match as ndt_match
    from ndtpu_torch.lie import se2

    f64 = torch.float64
    differ = (((ps_stats.s != k3_stats.s).flatten(2).any(-1))
              | ((ps_stats.ss != k3_stats.ss).flatten(2).any(-1)))  # [G, C]
    icov_a, icov_b = ps_map.icov.cpu(), k3_map.icov.cpu()
    gap = ((icov_a - icov_b).abs().flatten(2).amax(-1)
           / icov_b.abs().flatten(2).amax(-1).clamp(min=1e-30))
    maps64 = None
    same, flips, obj_gap = [], [], []
    for i, (a, b) in enumerate(zip(traces["slab"], traces["k3"])):
        pts, msk, x0 = scans[i]
        err = float((got[i] - b["result"].pose.cpu()).abs().max())
        f_ref = b["f"][_final(b)]
        obj_gap.append(abs(_objective(ps_map, pts, msk, b["result"].pose,
                                      grid, cfg.match) - f_ref) / abs(f_ref))
        n = min(len(a["taken"]), len(b["taken"]))
        k = next((j for j in range(n) if a["taken"][j] != b["taken"][j]),
                 None)
        if k is None:
            require(err <= SLAB_POSE_TOL,
                    f"config 5 slab: registration {i}: match_slab off the LM "
                    f"on phase 12's K3 map by {err:.3e} (> {SLAB_POSE_TOL:g})"
                    f" with the same decisions on both maps")
            same.append(err)
            continue
        e = k + 1                  # the evaluation whose decision differs
        last = lambda t: max(j for j in range(e) if j == 0
                             or t["taken"][j - 1])
        pa, pb = last(a), last(b)
        try_a, cur_a = a["poses"][e], a["poses"][pa]
        ids, inb = ndt_grid.cell_ids(se2.transform(try_a, pts.cpu()), grid)
        hit = differ.gather(1, ids) & inb & msk.cpu()[None]
        f_got = _objective(k3_map, pts, msk, got[i], grid, cfg.match)
        require(f_got <= f_ref + SLAB_F_RTOL * abs(f_ref),
                f"config 5 slab: registration {i}: the K3 map's objective "
                f"at the match_slab pose {f_got:.6f}, at the K3 LM's "
                f"{f_ref:.6f} (within {SLAB_F_RTOL:g} of it required)")
        if maps64 is None:
            maps64 = [ndt_grid.finalize(ndt_grid.NDTStats(
                *(x.to(f64) for x in st)), cfg.ndt)
                for st in (ps_stats, k3_stats)]
        r64 = [ndt_match.lm_loop(
            lambda p, m=m: tuple(x[0] for x in
                                 ndt_match.score_grad_hess_batch(
                                     p[None], pts.cpu().to(f64), msk.cpu(),
                                     m, grid, cfg.match)),
            x0.cpu().to(f64), cfg.match).pose for m in maps64]
        flips.append(dict(
            registration=i, err=err, evaluation=e,
            margin_slab=a["f"][e] - a["f"][pa],
            margin_k3=b["f"][e] - b["f"][pb],
            margin_k3_at_slab_poses=(
                _objective(k3_map, pts, msk, try_a, grid, cfg.match)
                - _objective(k3_map, pts, msk, cur_a, grid, cfg.match)),
            beams_in_differing_cells=int(hit.sum()),
            icov_rel_gap=float(torch.where(hit, gap.gather(1, ids),
                                           torch.zeros(())).max()),
            k3_objective=[f_got, f_ref],
            f64_slab_vs_k3=float((r64[0] - r64[1]).abs().max()),
            f32_vs_f64=[float((got[i].double() - r64[0]).abs().max()),
                        float((b["result"].pose.cpu().double()
                               - r64[1]).abs().max())]))
    return dict(objective_gap_max=max(obj_gap),
                cells_differing=int(differ.sum()),
                cells_icov_gap_max=float(gap[k3_map.valid.cpu() > 0].max()),
                same_decisions=len(same),
                same_max_err=max(same) if same else None, flips=flips)


def _final(trace) -> int:
    """The evaluation whose pose an LM trace ends at (the last taken)."""
    return max([0] + [j + 1 for j, t in enumerate(trace["taken"]) if t])


def run_slab(dev, card, keep, seed: int, jobs, changes=None):
    """Phase 15: config 5's sharded map at its published widths (256 x 256
    at 0.5 m, overlap 4; two ranks, 128 columns each) over two gloo ranks
    on the card (:func:`slab_worker`, started as ``chip_smoke.py
    --slab-worker``). Gates: each rank's session state bit-equal to phase
    12's in-process one; the point-sharded and the replicated slab builds
    equal (counts exactly, ``s``/``ss`` within :data:`SLAB_RTOL`), and,
    gathered, equal to phase 12's merged statistics (K3; counts exactly)
    and to the f64 sums on the same cells; the gathered slab map's valid
    flags equal to the merged map's; every ``match_slab`` result bit-equal
    on both ranks; on the point-sharded build's map within
    :data:`SLAB_POSE_TOL` of the in-process ``lm_loop`` on K12 over the
    gathered map in the dense layout, and held against the LM on phase
    12's K3 map as :func:`slab_vs_k3` sets out; on the replicated build's
    map within :data:`SLAB_POSE_TOL` of the LM on the K3 map (an
    independent dense build, as test_dist.py:98 compares);
    ``match_batch_sharded`` bit-equal per lane to the in-process
    ``match_batch``; K10a, K10b and K10c launched there. Then K10a, K10b
    and K10c against their plain versions at the ranks' shapes. Returns
    ``(launches, record, kernel rows)``.

    Phase 15b (``changes``, :data:`CONFIG5_OVERLAP1`): the same on phase
    12b's overlap-1 merge (``keep``): the ranks take their sessions' points
    from it (no sessions run), the map has one grid, K10a[g1] and K10c[g1]
    carry it, and a G = 4 K10a call of rank 0's slab shape after them
    equals its fixed-point model (its tiles and work buffer follow the
    grid count)."""
    import dataclasses

    import numpy as np
    import torch

    from ndtpu_torch import kernels
    from ndtpu_torch.config import PipelineConfig
    from ndtpu_torch.dist import gridmap
    from ndtpu_torch.ndt import grid as ndt_grid
    from ndtpu_torch.ndt import match as ndt_match

    tag = "config 5 slab" + (f" {json.dumps(changes)}" if changes else "")
    with tempfile.TemporaryDirectory(prefix="ndtpu_smoke_slab_") as tmp:
        cfg_path = Path(tmp) / "config5.json"
        cfg_path.write_text(json.dumps(layout_json(CONFIG5, changes or {})))
        cfg = PipelineConfig.from_json(str(cfg_path))
        grid = cfg.grid
        inputs = slab_inputs(dev, seed, keep, cfg)
        kf_b = keep["sb"].kf
        inputs.update(kf_points_b=kf_b.points.cpu().numpy(),
                      kf_masks_b=kf_b.masks.cpu().numpy())
        na = keep["sa"].kf.masks.numel()      # A's points lead all_pts
        if changes:
            inputs.update(config=str(cfg_path), split=na)
        npz, out = str(Path(tmp) / "in.npz"), str(Path(tmp) / "out")
        np.savez(npz, **inputs)
        port = free_port()
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--slab-worker",
             str(r), "2", str(port), npz, out, dev.type], cwd=str(ROOT),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for r in range(2)]
        try:
            outs = [p.communicate(timeout=600) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        wall = time.perf_counter() - t0
        for p, (so, se) in zip(procs, outs):
            require(p.returncode == 0, f"{tag}: worker {p.args[3]} failed "
                    f"rc={p.returncode}\n{so[-2000:]}\n{se[-4000:]}")
        ranks = [dict(np.load(f"{out}.{r}.npz")) for r in range(2)]
    halo, nxl = int(inputs["halo"]), grid.nx // 2
    k10a = kernels.variant("slab_accumulate", grid.overlap)
    k10c = kernels.variant("slab_sgh", grid.overlap)
    # Sessions: bit-equal to phase 12's (phase 15b takes 12b's).
    for r, k in enumerate("ab" if not changes else ""):
        require(str(ranks[r]["digest"]) == inputs[f"digest_{k}"],
                f"{tag}: rank {r}'s session {k.upper()} differs from "
                f"phase 12's in-process run")
    # The map: the two builds, the merged statistics, f64.
    gather = lambda key: torch.cat([torch.as_tensor(x[key]) for x in ranks],
                                   1)
    ps = gridmap.SlabStats(*(gather(f"ps_{k}") for k in ("n", "s", "ss")))
    rep = gridmap.SlabStats(*(gather(f"rep_{k}") for k in ("n", "s", "ss")))
    all_pts = torch.as_tensor(inputs["all_pts"]).to(dev)
    all_msk = torch.as_tensor(inputs["all_msk"]).to(dev)
    ref64, mag64 = slab_f64(all_pts, all_msk, grid, 0, grid.nx)
    build_err = slab_close(f"{tag}: point-sharded vs replicated", ps,
                           gridmap.SlabStats(*(x.double() for x in rep)),
                           mag64, SLAB_RTOL)
    k3 = gridmap.dense_to_slab(ndt_grid.NDTStats(*(torch.as_tensor(
        inputs[f"stats_{k}"]) for k in ("n", "s", "ss"))), grid)
    require(torch.equal(ps.n, k3.n) and torch.equal(rep.n, k3.n),
            f"{tag}: counts differ from phase 12's merged map (K3)")
    err64 = slab_close(f"{tag}: point-sharded vs f64", ps, ref64,
                       mag64, SLAB_RTOL)
    err64_rep = slab_close(f"{tag}: replicated vs f64", rep, ref64,
                           mag64, K10A_RTOL)
    smap = gridmap.SlabMap(*(gather(f"map_{k}") for k in
                             ("mean", "icov", "valid")))
    k3_dense = ndt_grid.NDTStats(*(torch.as_tensor(inputs[f"stats_{k}"])
                                   for k in ("n", "s", "ss")))
    k3_map = ndt_grid.finalize(ndt_grid.NDTStats(*(x.to(dev)
                                                   for x in k3_dense)),
                               cfg.ndt)
    require(torch.equal(smap.valid,
                        gridmap.dense_to_slab(k3_map, grid).valid.cpu()),
            f"{tag}: valid flags differ from the merged map's")
    # K10b read each rank's exchanged records in place; the same cells as
    # three arrays here give the same bits.
    require(all(str(x["ps_layout"]) == "records" for x in ranks),
            f"{tag}: K10b did not read the exchange's records in place "
            f"({[str(x['ps_layout']) for x in ranks]})")
    require(bits_equal(gridmap.finalize_slab(gridmap.SlabStats(
        *(x.to(dev) for x in ps)), cfg.ndt), gridmap.SlabMap(
            *(x.to(dev) for x in smap))),
            f"{tag}: the ranks' maps (K10b on the records) differ from K10b "
            f"on the same statistics as three arrays")
    # match_slab on both builds' maps: the same bits on both ranks. On the
    # replicated build's map against the in-process LM on K12 over phase
    # 12's K3 map, an independent dense build (test_dist.py:98's check);
    # on the point-sharded build's map against the same LM over that map
    # gathered into the dense layout (K10c against K12), and against the K3
    # map as :func:`slab_vs_k3` sets out.
    for pre in ("slab", "slab_rep"):
        for key in ("pose", "hess", "iter", "conv"):
            require(ranks[0][f"{pre}_{key}"].tobytes()
                    == ranks[1][f"{pre}_{key}"].tobytes(),
                    f"{tag}: {pre}_{key} differs between the ranks")
    ps_dense = gridmap.slab_to_dense(ps, grid)
    dense_map = ndt_grid.NDTMap(*(x.to(dev) for x in
                                  gridmap.slab_to_dense(smap, grid)))
    kp, km = keep["sb"].kf.points, keep["sb"].kf.masks
    sidx = torch.as_tensor(inputs["slab_idx"]).to(dev)
    init = torch.as_tensor(inputs["slab_init"]).to(dev)
    scans = [(kp[i], km[i], init[k]) for k, i in enumerate(sidx)]
    with no_plain_on_card(PLAIN_SLAB):
        traces = {name: [traced_lm(m, p, q, x0, grid, cfg.match)
                         for p, q, x0 in scans]
                  for name, m in (("slab", dense_map), ("k3", k3_map))}
    ref_poses = torch.stack([t["result"].pose.cpu() for t in traces["slab"]])
    ref_k3 = torch.stack([t["result"].pose.cpu() for t in traces["k3"]])
    got = torch.as_tensor(ranks[0]["slab_pose"])
    slab_err = float((got - ref_poses).abs().max())
    require(slab_err <= SLAB_POSE_TOL,
            f"{tag}: match_slab off the in-process lm_loop by "
            f"{slab_err:.3e} (> {SLAB_POSE_TOL:g})")
    rep_err = float((torch.as_tensor(ranks[0]["slab_rep_pose"])
                     - ref_k3).abs().max())
    require(rep_err <= SLAB_POSE_TOL,
            f"{tag}: match_slab on the replicated build's map off "
            f"the in-process lm_loop on phase 12's K3 map by {rep_err:.3e} "
            f"(> {SLAB_POSE_TOL:g})")
    with no_plain_on_card(PLAIN_SLAB):
        vs_k3 = slab_vs_k3(traces, got, scans, ps_dense, k3_dense, dense_map,
                           k3_map, grid, cfg)
    moved = got - torch.as_tensor(inputs["slab_init"])
    # match_batch_sharded: each rank's lanes bit-equal to match_batch.
    bidx = torch.as_tensor(inputs["batch_idx"]).to(dev)
    with no_plain_on_card(PLAIN_SLAB):
        mb = ndt_match.match_batch(kp[bidx], km[bidx], k3_map, torch.as_tensor(
            inputs["batch_init"]).to(dev), grid, cfg.match)
    half = BATCH_SCANS // 2
    for r in range(2):
        lanes = slice(r * half, (r + 1) * half)
        for key, ref in (("mb_pose", mb.pose), ("mb_iter", mb.n_iter),
                         ("mb_conv", mb.converged)):
            require(ranks[r][key].tobytes() == ref[lanes].cpu().numpy()
                    .tobytes(), f"{tag}: rank {r}'s {key} differs "
                    f"from the in-process match_batch")
    # Launches: each rank's map and registration stages.
    launches = {k: 0 for k in kernels.LAUNCHES}
    stages = ("psharded", "replicated", "finalize", "finalize_replicated",
              "match_slab", "match_slab_replicated", "match_batch")
    per_stage = {}
    for s in stages:
        per_stage[s] = [launches_nonzero(json.loads(str(x[f"{s}_launches"])))
                        for x in ranks]
        for row in per_stage[s]:
            for k, v in row.items():
                launches[k] += v
    for pre, stage in (("slab", "match_slab"),
                       ("slab_rep", "match_slab_replicated")):
        n_it = int(ranks[0][f"{pre}_iter"].sum())
        for r, x in enumerate(ranks):
            n_sgh = per_stage[stage][r].get(k10c, 0)
            n_sum = json.loads(str(x[f"{stage}_collectives"]))["all_reduce"]
            require(n_sgh == n_it + SLAB_SCANS == n_sum,
                    f"{tag}: {stage} on rank {r}: {n_sgh} K10c "
                    f"launches and {n_sum} sums for {n_it} iterations of "
                    f"{SLAB_SCANS} registrations (one each per evaluation)")
    iters = int(ranks[0]["slab_iter"].sum())
    colls = [json.loads(str(x["match_slab_collectives"])) for x in ranks]
    exch = [json.loads(str(x["psharded_collectives"])) for x in ranks]
    record = dict(
        halo=halo, nx_local=nxl, points=int(inputs["all_msk"].sum()),
        sessions_s=[float(x["sessions_s"]) for x in ranks
                    if "sessions_s" in x],
        psharded_s=[float(x["psharded_s"]) for x in ranks],
        replicated_s=[float(x["replicated_s"]) for x in ranks],
        finalize_s=[float(x["finalize_s"]) for x in ranks],
        halo_exchange_ms=[1e3 * c["exchange_s"] for c in exch],
        halo_exchange_bytes=[c["exchange_bytes"] for c in exch],
        match_slab_iters=iters,
        match_slab_ms_per_eval=[1e3 * float(x["match_slab_s"])
                                / (iters + SLAB_SCANS) for x in ranks],
        match_slab_ms_per_iter=[1e3 * float(x["match_slab_s"]) / iters
                                for x in ranks],
        match_slab_sum_share=[c["all_reduce_s"] / float(x["match_slab_s"])
                              for c, x in zip(colls, ranks)],
        match_slab_err=slab_err, match_slab_replicated_err_vs_k3_map=rep_err,
        match_slab_vs_k3_map=vs_k3,
        match_slab_converged=int(ranks[0]["slab_conv"].sum()),
        match_slab_in_process_iters=sum(int(t["result"].n_iter)
                                        for t in traces["slab"]),
        match_slab_move_m=float(moved[:, :2].norm(dim=1).max()),
        match_batch_s=[float(x["match_batch_s"]) for x in ranks],
        build_err=build_err, f64_err=err64, f64_err_replicated=err64_rep,
        launches_per_stage=per_stage, workers_s=wall)
    print(f"[smoke] {tag} ({card}): 2 ranks, {grid.overlap} x {nxl} x "
          f"{grid.ny} "
          f"cells each, halo {halo} columns (the smallest that drops no "
          f"point); sessions bit-equal to phase 12's "
          f"({record['sessions_s']} s); point-sharded build "
          f"{record['psharded_s']} s (halo exchange "
          f"{record['halo_exchange_ms']} ms, "
          f"{record['halo_exchange_bytes']} B) equal to the replicated one "
          f"(s/ss max abs diff {build_err:.3e}); counts equal to phase 12's "
          f"K3 map, s/ss vs f64 {err64:.3e} / {err64_rep:.3e}; valid flags "
          f"equal; {SLAB_SCANS} match_slab: {iters} iterations, "
          f"{record['match_slab_converged']} converged, bit-equal on both "
          f"ranks, off the in-process lm_loop on K12 by {slab_err:.3e}; on "
          f"the replicated build's map off the LM on phase 12's K3 map by "
          f"{rep_err:.3e}; "
          f"{record['match_slab_ms_per_iter']} ms per LM iteration, "
          f"{record['match_slab_ms_per_eval']} per evaluation (the SUM "
          f"{record['match_slab_sum_share']} of it); match_batch_sharded "
          f"{BATCH_SCANS} lanes bit-equal; workers {wall:.1f} s; launches "
          f"{per_stage}")
    print(f"[smoke] {tag} vs phase 12's K3 map: "
          f"{vs_k3['cells_differing']} cells whose s/ss differ (cells both "
          f"ranks' points reach: two rounded partials summed), inverse "
          f"covariances up to {vs_k3['cells_icov_gap_max']:.3e} apart, the "
          f"objectives up to {vs_k3['objective_gap_max']:.3e} apart at one "
          f"pose; {vs_k3['same_decisions']} of {SLAB_SCANS} registrations "
          f"take the same LM decisions on both maps and end within "
          f"{vs_k3['same_max_err']} of each other; where they part: "
          f"{json.dumps(vs_k3['flips'])}")
    # The kernels at the ranks' shapes: K10a at rank 0's halo-extended
    # slab of A's points, K10b on its slab, K10c at B = 1.
    k10b = "finalize_cells" + ("[g1]" if changes else "")
    rows = {k10a: check_k10a(
        "rank 0 halo-extended", all_pts[:na].contiguous(),
        all_msk[:na].contiguous(), grid, -halo, nxl + 2 * halo, jobs)}
    rows[k10a]["replicated"] = check_k10a(
        "rank 1 replicated", all_pts, all_msk, grid, nxl, nxl, jobs)
    if changes:
        # K10a's tile plan and work buffer follow the grid count: a G = 4
        # call of the same slab shape after the G = 1 calls is its own
        # model's.
        g4 = dataclasses.replace(grid, overlap=4)
        p0, m0 = all_pts[:na].contiguous(), all_msk[:na].contiguous()
        require(bits_equal(
            gridmap.slab_accumulate(p0, m0, g4, -halo, nxl + 2 * halo),
            gridmap.slab_accumulate_fixed_ref(p0, m0, g4, -halo,
                                              nxl + 2 * halo)),
            f"{tag}: a G = 4 K10a call after G = 1 ones of the same slab "
            f"shape differs from its fixed-point model")
    st0 = tuple(torch.as_tensor(ranks[0][f"ps_{k}"]).to(dev)
                for k in ("n", "s", "ss"))
    rows[k10b] = check_k10b("rank 0 slab", st0, cfg.ndt, jobs)
    rows[k10b]["dense"] = check_k10b(
        "dense merged map", tuple(torch.as_tensor(inputs[f"stats_{k}"]).to(
            dev) for k in ("n", "s", "ss")), cfg.ndt, jobs)
    # K10c at B = 1 (match_slab's shape) on each rank's slab, at the first
    # registration's result.
    for r in range(2):
        smap_r = gridmap.SlabMap(*(torch.as_tensor(ranks[r][f"map_{k}"]).to(
            dev) for k in ("mean", "icov", "valid")))
        row = check_k10c(f"rank {r}", got[:1].to(dev), kp[sidx[0]],
                         km[sidx[0]], smap_r, grid, r * nxl, cfg.match, jobs)
        if r == 0:
            rows[k10c] = row
        else:
            rows[k10c]["rank1"] = row
    return launches, record, rows


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--slab-worker", nargs=6, default=None,
                        metavar=("RANK", "WORLD", "PORT", "NPZ", "OUT",
                                 "DEVICE"),
                        help="run one rank of phase 15 (started by the "
                             "smoke itself)")
    args = parser.parse_args(argv)
    t_start = time.perf_counter()
    if args.slab_worker:
        sys.path.insert(0, str(ROOT))
        r, n, port, npz, out, device = args.slab_worker
        slab_worker(int(r), int(n), int(port), npz, out, device)
        return 0

    require((ROOT / "ndtpu_torch").is_dir() and REF_FILE.is_file()
            and REF3_FILE.is_file() and REF4_FILE.is_file()
            and REF_SERVING_FILE.is_file() and REF5_FILE.is_file()
            and REF_SERVING_LAYOUTS_FILE.is_file()
            and REF5_OVERLAP1_FILE.is_file()
            and REF1_FILE.is_file() and REF_LAYOUTS_FILE.is_file()
            and REF_SCAN_FILE.is_file() and REF_MULTILAP_FILE.is_file(),
            f"run from a checkout of the repository ({ROOT} lacks "
            f"ndtpu_torch/ or the reference files in tests/data)")
    import torch

    sys.path.insert(0, str(ROOT))
    require(torch.cuda.is_available(), "no CUDA device is available")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else ""
    require(card, f"nvidia-smi failed: {smi.stderr.strip()}")
    print(card)
    print(f"[smoke] torch {torch.__version__} CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    require(not torch.backends.cuda.matmul.allow_tf32
            and torch.get_float32_matmul_precision() == "highest",
            "TF32 matmuls are on: the supernodal step needs full f32 products")

    from ndtpu_torch import kernels
    from ndtpu_torch.config import PipelineConfig
    from ndtpu_torch.ndt import grid as ndt_grid

    secs = kernels.build()
    log = (kernels.BUILD_DIR / "build.log")
    regs = [ln.strip() for ln in log.read_text().splitlines()
            if "registers" in ln] if log.exists() else []
    print(f"[smoke] build {secs:.1f} s; " + " | ".join(regs))

    cfg = PipelineConfig.from_json(str(CONFIG2))
    seq = box_sequence(args.seed, cfg.n_beams)
    stats = map_stats(seq, cfg.grid, dev)
    table = ndt_grid.finalize_pack(stats, cfg.ndt, cfg.grid)
    # Each kernel at a large batch (512 lanes for K1, 1,024 scans for K3, as
    # a full map rebuild at keyframe capacity sees it), then at the shape one
    # window of the main path gives it (W lanes; W scans), which is the row
    # the result line reports.
    w = cfg.window
    lm2 = lm_window_args(cfg, seq, table, args.seed, dev, w)
    check_no_sync(lm2, cfg.match)
    jobs = []     # card times, read after the entry-point phases
    lm_rows = {}
    lm_rows["lm_ndt"], conv2 = check_lm("window", lm2, cfg.match, jobs)
    lm_rows["lm_ndt"]["vs_k1_spreads"] = check_lm_sums(
        cfg, PipelineConfig.from_json(str(CONFIG3)), args.seed, dev,
        layouts=[(4, 8)])
    lm_rows["lm_ndt"]["headline"] = check_lm_headline(args.seed, dev, jobs)
    check_k1(cfg, seq, table, args.seed, dev, 512, jobs)
    check_k3(cfg, seq, stats, args.seed, dev, 1024)
    cfg3 = PipelineConfig.from_json(str(CONFIG3))
    results = {**lm_rows,
               "ndt_terms": check_k1(cfg, seq, table, args.seed, dev, w,
                                     jobs),
               "halfcell_add": check_k3(cfg, seq, stats, args.seed, dev, w,
                                        jobs),
               "finalize_pack": check_k4_shapes(cfg, cfg3, seq, stats,
                                                args.seed, dev, jobs)}

    # Config 3's kernels: K8a at 256 keyframes, then at one window; K1
    # grouped, K8b and the gated verify at the verify shape
    # (max_detect_per_window x max_candidates lanes) against a full
    # 1,024-slot table cache; K8b and the gated verify also at config 5's
    # 64 candidates.
    kf = box_store(cfg3, seq, dev)
    results["halfcell_add"].update(check_k3_rebuild(cfg3, kf, dev))
    check_k8a(cfg3, seq, args.seed, dev, 256)
    results["local_tables"] = check_k8a(cfg3, seq, args.seed, dev,
                                        cfg3.window, jobs)
    results["ndt_terms_grouped"] = check_k1_grouped(
        cfg3, seq, kf, args.seed, dev,
        cfg3.loop.max_detect_per_window * cfg3.loop.max_candidates, jobs)
    c3 = cfg3.loop.max_candidates
    results["loop_gate"] = check_k8b(cfg3, seq, kf, args.seed, dev, c3, jobs)
    results["loop_gate"]["c64"] = check_k8b(cfg3, seq, kf, args.seed, dev, 64,
                                            jobs)
    results["loop_gate_fused"] = check_gated_verify(cfg3, seq, kf, args.seed,
                                                    dev, c3, jobs)
    results["loop_gate_fused"]["c64"] = check_gated_verify(
        cfg3, seq, kf, args.seed, dev, 64, jobs)
    results["lm_ndt_grouped"], conv3 = check_lm(
        "verify", lm_verify_args(cfg3, seq, kf, args.seed, dev,
                                 cfg3.loop.max_detect_per_window
                                 * cfg3.loop.max_candidates), cfg3.match,
        jobs)
    eq, lanes = conv2[0] + conv3[0], conv2[1] + conv3[1]
    require(eq >= 0.98 * lanes, f"lm_ndt: converged flags equal to the f32 "
            f"twin's on {eq}/{lanes} lanes (>= 98% required)")
    # The same kernels in the other table layouts (overlap 1, compact rows,
    # both), K3 at overlap 1.
    results.update(check_layouts(cfg, cfg3, seq, stats, kf, args.seed, dev,
                                 jobs))
    # Input preparation: K11 (the synthetic raycast) and K13 (the voxel
    # downsample) at the CLI's and serving's shapes.
    results["raycast"] = check_k11(dev, jobs)
    results["voxel_downsample"] = check_k13(dev, jobs)
    launches_vscan, results["voxel_downsample[scan]"] = check_k13_scan(dev,
                                                                      jobs)
    # K14: the window's appends at configs 2 and 3 and serving's shapes
    # (and past the capacities), its loop entry and its row write.
    results.update(check_k14(args.seed, dev, jobs))
    # K15: the loop verify's set-up at config 3's and serving's shapes,
    # with equal distances and with a full store.
    results["loop_lanes"] = check_k15(dev, args.seed, jobs)
    # K16: serving's refresh at its published capacity and the smoke's,
    # with equal staleness across the M-th place, a full store, all off.
    results["refresh_points"] = check_k16(dev, args.seed, jobs)
    # The map build is the same on every run; what the whole pipeline does
    # run to run on the draws whose ATE flipped under float atomics.
    check_frontend_twice(cfg3, box_sequence(2, cfg3.n_beams), dev)
    kept = []
    repeats = {"config3_draw2": check_repeat_runs(dev, CONFIG3, 2, keep=kept),
               "config2_draw0": check_repeat_runs(dev, CONFIG2, 0)}
    # The smoother's kernels on the graph of a real run with loops: the
    # state after config-3 draw 2, its newest poses moved.
    sm = smoother_state(kept[0], args.seed)
    del kept
    results["factor_linearize"] = check_k5(sm, cfg3, jobs)
    results["pcg_solve"] = check_k6(sm, cfg3, jobs)
    results["local_select"] = check_k7a(sm, cfg3, jobs)
    results["local_assemble"] = check_k7b(sm, cfg3, jobs)
    takes = check_incremental_takes(sm, cfg3)
    # Config 4's kernels on bench.py's 10k-pose graph (P = 64): K5 at its
    # 10,305 rows, K9a, K9b, one supernodal step against f64, and the
    # bench's BA step timing.
    c4 = config4_case(dev, args.seed)
    results["factor_linearize"]["config4"] = check_k5_config4(c4)
    results["factor_linearize"]["robust"] = check_k5r(c4)
    results["pcg_solve_grid"] = check_k6g(c4, jobs)
    results["pcg_solve_grid"]["config3"] = results["pcg_solve"].pop("grid")
    results["supernodal_assemble"], k9a_out = check_k9a(c4, jobs)
    results["schur_reduce"] = check_k9b(c4, k9a_out, jobs)
    del k9a_out
    step4 = check_supernodal_step(c4)
    ba_split = ba_step_timing(c4, card, jobs)

    launches2, counts2 = run_entry_point(dev, CONFIG2, 300, render=True)
    ate_gate(dev, CONFIG2, REF_FILE)
    launches3, counts3 = run_entry_point(dev, CONFIG3, 600)
    ate_gate(dev, CONFIG3, REF3_FILE)
    # The windowed path's host syncs per window at configs 2 and 3.
    window_syncs = {"config2": check_window_syncs(dev, CONFIG2),
                    "config3": check_window_syncs(dev, CONFIG3)}
    # Config 1 (odometry alone), then the windowed path in the other table
    # layouts through its entry point.
    launches1, config1 = run_config1(dev)
    launches_layouts, layouts = run_layouts(dev)
    # bench.py §3b's multilap at full size (phase 7d): the smoother's local
    # path, K7a and K7b, under loop load.
    launches_ml, multilap = run_multilap(dev)
    detections = counts3["detections"]
    require(counts3["full_solves"] > 0, "config 3: no full solve ran")
    require(launches3["loop_gate_fused"] == detections > 0
            and launches3["loop_gate"] == 0
            and launches2["loop_gate_fused"] == 0,
            f"config 3: {launches3['loop_gate_fused']} gated verify and "
            f"{launches3['loop_gate']} standalone gate launches for "
            f"{detections} loop-detection calls (one gated launch each, no "
            f"standalone gate, expected)")
    launches4, config4 = run_config4(dev, card)
    launches4p, config4["pcg"] = run_config4_pcg(dev, card)
    launches10k, incremental10k = run_incremental_10k(c4, card, args.seed)
    # K7a past the first design's shared memory and past the shared route,
    # each with a local-path update (phase 8d); K6g at 25,000 poses.
    (launches_sel, results["local_select[scratch]"],
     results["local_select"]["past_first_block"]) = check_k7a_past_block(
        dev, args.seed, jobs)
    results["pcg_solve_grid"]["past_25k"] = check_k6g_past(dev, args.seed)
    # Stacked serving through its entry point (phase 10), in the other
    # table layouts (phase 10b), then K6b, K3s and K4s on the state its
    # last run left (8 sessions' graphs, maps and keyframes; phase 11),
    # K3s and K4s also in the other layouts.
    phase_s = {}
    t_phase = time.perf_counter()
    check_padded_sessions(dev)
    launches8, served, state8 = run_serving(dev, card, jobs=jobs)
    results["loop_gate_fused"]["serving"] = served.pop("gated_verify")
    serving = dict(aggregate_scans_per_s=served["aggregate_scans_per_s"],
                   run_s=served["run_s"], first_run_s=served["first_run_s"],
                   sessions=serving_gates(served))
    phase_s["9-10"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()
    launches_sl, serving["layouts"] = run_serving_layouts(dev, card)
    phase_s["10b"] = time.perf_counter() - t_phase
    print(f"[smoke] serving aggregate scans/s ({card}): published layout "
          f"{served['aggregate_scans_per_s']:.1f}; "
          + "; ".join(f"{name} {r['aggregate_scans_per_s']:.1f}"
                      for name, r in serving["layouts"].items())
          + f" (phase 10b {phase_s['10b']:.1f} s)")
    from ndtpu_torch.dist import slam_dp

    t_phase = time.perf_counter()
    cfg8 = slam_dp.serving_config(PipelineConfig.from_json(str(SERVING)))
    results["pcg_solve_blocked"] = check_k6b(state8, cfg8, args.seed, jobs)
    results["factor_linearize"]["fresh_stacked"] = check_k5_stacked(state8,
                                                                    jobs)
    results["halfcell_add_stacked"] = check_k3s(state8, cfg8, jobs)
    results["finalize_pack_stacked"] = check_k4s(state8, cfg8, jobs)
    results.update(check_stacked_layouts(state8, cfg8, jobs))
    del state8
    phase_s["11"] = time.perf_counter() - t_phase
    # Config 5: the merge in process (phase 12), then the distributed solve
    # of its merged graph in two ranks (phase 13), and K9c on their rows;
    # the merge at overlap 1 (phase 12b).
    t_phase = time.perf_counter()
    keep = {}
    with tempfile.TemporaryDirectory(prefix="ndtpu_smoke_") as tmp:
        npz = Path(tmp) / "config5_merged.npz"
        launches5, merge5, g5, chi10, rows5 = run_merge(dev, card, npz, jobs,
                                                        keep)
        results.update(rows5)
        launches5d, dist5 = run_distributed(dev, card, npz, chi10)
    results["schur_local_assemble"] = check_k9c(g5, 2, 1e-3, jobs)
    del g5
    phase_s["12-13"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()
    keep1 = {}
    launches5o1, merge5o1, _, _, rows5o1 = run_merge(
        dev, card, None, jobs, keep1, changes=CONFIG5_OVERLAP1)
    results.update(rows5o1)
    phase_s["12b"] = time.perf_counter() - t_phase
    # The reference's multi-process SLAM rehearsal through ``launch --task
    # slam`` (phase 14), then config 5's slab-sharded map, sessions and
    # registrations across two ranks (phase 15) and K10a-c at its shapes,
    # and the slab map at overlap 1 on phase 12b's sessions (phase 15b).
    t_phase = time.perf_counter()
    launches14, slam14 = run_slam_launch(dev, card)
    phase_s["14"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()
    launches15, slab15, rows15 = run_slab(dev, card, keep, args.seed, jobs)
    results.update(rows15)
    del keep
    phase_s["15"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()
    launches15o1, slab15o1, rows15o1 = run_slab(
        dev, card, keep1, args.seed, jobs, changes=CONFIG5_OVERLAP1)
    results.update({k: v for k, v in rows15o1.items()
                    if k != "finalize_cells[g1]"})
    results["finalize_cells"]["overlap1"] = rows15o1["finalize_cells[g1]"]
    del keep1
    phase_s["15b"] = time.perf_counter() - t_phase
    # The per-scan path (phase 16): the CLI's scan mode at configs 2 and 3,
    # box-world draws through run_slam, the fresh-map verify, CARMEN input,
    # the voxel downsample and checkpoint resume.
    t_phase = time.perf_counter()
    launches16, scan16 = run_scan_phase(dev, jobs)
    phase_s["16"] = time.perf_counter() - t_phase
    print(f"[smoke] phase seconds: "
          + ", ".join(f"{k} {v:.1f}" for k, v in phase_s.items()))
    paths = {"config1": launches1, **launches_layouts, **launches16,
             "config2": launches2, "config3": launches3, "config4": launches4,
             "config4_pcg": launches4p, "incremental_10k": launches10k,
             "multilap": launches_ml,
             "select_past_block": launches_sel,
             "downsample_past_table": launches_vscan,
             "serving": launches8, **launches_sl, "config5": launches5,
             "config5_overlap1": launches5o1,
             "config5_dist": launches5d, "slam_launch": launches14,
             "config5_slab": launches15,
             "config5_slab_overlap1": launches15o1}
    for k in KERNELS:
        for path in k.get("paths", ()):  # K1, K8b run inside lm_ndt there
            require(paths[path][k["name"]] > 0,
                    f"{k['name']}: the {path} path launched it no time")
    launches = {k: sum(p[k] for p in paths.values()) for k in launches2}
    read_card_times(jobs)
    finish_per_iteration(results["pcg_solve"], "K6")
    finish_per_iteration(results["pcg_solve_grid"], "K6g 10k")
    finish_split(ba_split)
    del kf, jobs

    rows = [dict(name=k["name"], route="cuda", source=k["source"],
                 replaces=k["replaces"], launches=launches[k["name"]],
                 **results[k["name"]],
                 **({"runs_inside": k["inside"]} if "inside" in k else {}))
            for k in KERNELS]
    print(f"[smoke] all phases passed in "
          f"{time.perf_counter() - t_start:.1f} s")
    smoother = {"takes_checked": takes, "window_syncs": window_syncs,
                "config2": counts2, "config3": counts3,
                "incremental_10k": incremental10k}
    config4.update(step=step4, ba_solve_ms_per_iter_10k=ba_split)
    print(json.dumps({"kernels": rows, "repeat_runs": repeats,
                      "config1": config1, "layouts": layouts,
                      "smoother": smoother, "multilap": multilap,
                      "config4": config4,
                      "serving": serving,
                      "config5": {"merge": merge5, "distributed": dist5,
                                  "slam_launch": slam14, "slab": slab15,
                                  "merge_overlap1": merge5o1,
                                  "slab_overlap1": slab15o1},
                      "per_scan": scan16, "phase_s": phase_s}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"[smoke] FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
