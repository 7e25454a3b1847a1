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
   path, timed beside it) and its f32 twin ``lm_ndt_ref``;
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
   unfused route); then
   ``_window_frontend`` twice from one state (bit-equal poses and map
   tables), and box-world config-3 draw 2 and config-2 draw 0 three times
   each (their ATEs, and the first window and stage where runs part);
   then the smoother's kernels on the graph of that config-3 run (1,024
   pose and 2,048 factor slots, its newest poses moved): K5
   ``factor_linearize`` (whole graph, gathered rows, chi^2, the fresh
   window) and K7b ``local_assemble`` against their f32 plain versions at
   rtol 1e-5, K6 ``pcg_solve`` against the f32 and f64 plain solves (also
   its 0-iteration mode, one launch and no host sync per ``pcg`` call, and
   the dense library solve timed beside it), K7a ``local_select`` bit for
   bit, each bit-identical on a second launch; and ``incremental_update``
   through the kernels (no plain version reached) against the plain route
   in f32 and f64 for the local and global takes, the settled check and
   the full solve, and ``local_update`` with a K7a probe without a host
   sync; then config 4's kernels on bench.py's 10k-pose Manhattan graph
   (P = 64 shards): K5 at its 10,305 rows, K9a ``supernodal_assemble`` and
   K9b ``schur_reduce`` against their plain versions in f32 on the card and
   in f64 on the CPU (rtol 1e-5 of each target's max; bit-identical on a
   second launch), one ``supernodal_delta`` on the card against the f64
   plain route (within 2 x the f32 plain route's error), and the bench's
   ``ba_solve_ms_per_iter_10k`` (one K5 linearize + ``supernodal_delta``,
   the median of 10 host-fenced calls after a warm-up) with the step's
   card-time split;
4. config 2 through its entry point: ``ndtpu_torch.run.main`` on
   ``configs/config2_full_sequence.json``, 300 scans, ``--device cuda``,
   with every launch counter (and the counts of ``match_batch_packed``
   and loop-detection calls, the smoother's takes, full solves and PCG
   solves) reset just before and read just after;
5. the config-2 ATE gate: box-world draws 0-2 through
   ``run_slam_windowed``, against the JAX reference's ATE on the same
   sequences (``tests/data/torch_config2_box300_ref.json``) and dead
   reckoning;
6. config 3 (loop closure) through the entry point, 600 scans (the
   corridor's 120 m lap takes 480), counters reset and read as in phase 4;
7. the config-3 ATE gate against ``tests/data/torch_config3_box300_ref.json``
   (also: the port closes a loop on every draw where JAX does);
8. config 4 through its entry point: ``ndtpu_torch.solve_g2o.main``
   with ``--manhattan 10000 --shards 64`` on the card (supernodal by
   ``auto``), counters reset just before and read just after: one K9a and
   one K9b launch per LM iteration, K5 launched, chi^2 falling and the final
   chi^2 within 1.02 x the JAX package's f32 final chi^2 on the same graph
   (``tests/data/torch_config4_manhattan10k_ref.json``);
9. sessions of different lengths (:func:`check_padded_sessions`): the
   padding the serving CLI adds is inert on the card (all-masked
   ``lm_ndt`` lanes, K3s, K4s, the gated verify) and in a stacked run;
10. stacked serving through its entry point (:func:`run_serving`):
    ``ndtpu_torch.serve.main`` on ``configs/config_serving.json``, 8
    sessions x 300 scans, twice (bit-equal), counters reset just before the
    first and read just after it: per window one ``lm_ndt_grouped`` launch
    per front-end pass, K3s and K4s once per use and never per map, K6b
    ``inc_iters`` times per smoother call, no twin on CUDA tensors, no
    drop; then each session's gates against the JAX package's run of the
    same sessions (``tests/data/torch_serving8_box300_ref.json``,
    :func:`serving_gates`);
11. K6b ``pcg_solve_blocked`` (against its plain version in f32 and f64,
    rtol 1e-4 per session, an idle session at 0), K3s
    ``halfcell_add_stacked`` at the window and refresh shapes and K4s
    ``finalize_pack_stacked`` (each bit-equal to 8 single K3 / K4
    launches), all bit-identical on a second launch, on the state the
    serving run left, each timed beside the single launches it replaces;
12. config 5's merge in process (:func:`run_merge`), at
    ``configs/config5_multisession.json``: two corridor sessions
    (:func:`config5_sessions`) through ``run_slam_windowed``, then, with the
    counters reset just before and read just after, ``global_align``,
    ``find_inter_session_loops`` at a perturbed transform, the merges and
    ``merged_map_stats`` (two K12 and two ``lm_ndt`` launches, one gated
    verify, one K3), gated against the JAX package's run of the same pair
    (``tests/data/torch_config5_merge_ref.json``); K12 against its plain
    version at the alignment's two shapes;
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
    sessions' (replicated), finalizes it (K10b ``finalize_cells``),
    registers 16 of B's keyframe scans with ``match_slab`` (K10c
    ``slab_sgh`` and one SUM per evaluation) and 64 with
    ``match_batch_sharded``; gated against each other, phase 12's merged
    map (K3) and f64 sums, the in-process ``lm_loop`` on K12 and
    ``match_batch``; then K10a, K10b and K10c against their plain versions
    at the ranks' shapes;
16. every kernel launched in its entry-point phase (``lm_ndt``, K3, K4 in
    phase 4; also ``lm_ndt_grouped``, K8a and the gated verify
    ``loop_gate_fused`` in phase 6; K3s, K4s, K5, K6b, K8a and the gated
    verify in phase 10; ``lm_ndt``, K12, K3 and the gated verify in phase
    12; K9c and K5 in phase 13's ranks; K10a, K10b and K10c in phase 15's
    ranks), exactly one ``lm_ndt*`` launch per
    ``match_batch_packed`` call, and in phase 6 one gated verify per
    loop-detection call and no standalone K8b launch; K5, K7a and K7b
    launched in phases 4 and 6, K6 in phase 6 (config 2 may never take the
    global path), one ``pcg_solve`` launch per PCG solve, and a full solve
    in phase 6; K5, K9a and K9b in phase 8. K1's and K8b's own launches
    are not required there: on the main path their code runs inside
    ``lm_ndt``, and they are held to their twins in phase 3.

The second-to-last line is one JSON object with the kernels' launches
(phases 4, 6, 8, 10 and 12-15 together), errors, times and bounds, the
repeated runs' ATEs, the smoother's counts, config 4's run and step
timing, the serving run's aggregate scans/s and per-session results, and
config 5's merge, distributed solve, SLAM rehearsal and slab map; the last
line is ``{"ok": true,
"device": {...}}``.
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
#: Stacked multi-session serving: ``python -m ndtpu_torch.serve --config
#: configs/config_serving.json --sessions 8 --max-scans 300``, and the JAX
#: package's per-session results on the same 8 sessions.
SERVING = ROOT / "configs" / "config_serving.json"
SERVING_ARGS = ["--config", str(SERVING), "--sessions", "8", "--max-scans",
                "300"]
REF_SERVING_FILE = ROOT / "tests" / "data" / "torch_serving8_box300_ref.json"

#: One H100 SXM's published peaks (NVIDIA's data sheet, at 700 W): HBM
#: bytes/s and f32 FLOP/s outside the tensor cores.
HBM_BYTES_S = 3.35e12
F32_FLOP_S = 67e12
#: f32 operations per in-bounds beam per evaluation of the 11 sums, counted
#: from ``csrc/ndt_sums.cuh``: 20 for the transform, binning and
#: derivatives, 71 for each of the 4 overlap grids.
BEAM_FLOPS = 20 + 4 * 71
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

_CSRC = "ndtpu_torch/kernels/csrc/"
#: Every kernel, with the entry-point runs that must launch it (``paths``:
#: config 2, 3 and 4 are phases 4, 6 and 8), or the kernel whose launch
#: runs its code on the main path (``inside``).
KERNELS = [
    dict(name="lm_ndt", source=_CSRC + "lm_ndt.cu",
         replaces="ndtpu/ndt/match.py:308",
         paths=("config2", "config3", "config5")),
    dict(name="lm_ndt_grouped", source=_CSRC + "lm_ndt.cu",
         replaces="ndtpu/ndt/match.py:308",
         paths=("config3", "serving", "config5")),
    dict(name="ndt_terms", source=_CSRC + "ndt_terms.cu",
         replaces="ndtpu/ndt/match.py:237", inside="lm_ndt"),
    dict(name="ndt_terms_grouped", source=_CSRC + "ndt_terms.cu",
         replaces="ndtpu/ndt/grid.py:450", inside="lm_ndt_grouped"),
    dict(name="halfcell_add", source=_CSRC + "halfcell_add.cu",
         replaces="ndtpu/ndt/grid.py:161",
         paths=("config2", "config3", "config5")),
    # K3s and K4s: the serving path's map ops over all 8 sessions' maps.
    dict(name="halfcell_add_stacked", source=_CSRC + "halfcell_add.cu",
         replaces="ndtpu/dist/slam_dp.py:317", paths=("serving",)),
    dict(name="finalize_pack", source=_CSRC + "finalize_pack.cu",
         replaces="ndtpu/ndt/grid.py:232", paths=("config2", "config3")),
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
    # K6b: the stacked smoother's per-session PCGs, serving only.
    dict(name="pcg_solve_blocked", source=_CSRC + "pcg_solve.cu",
         replaces="ndtpu/graph/solve.py:215", paths=("serving",)),
    dict(name="local_select", source=_CSRC + "local_system.cu",
         replaces="ndtpu/graph/incremental.py:120",
         paths=("config2", "config3")),
    dict(name="local_assemble", source=_CSRC + "local_system.cu",
         replaces="ndtpu/dist/schur.py:318", paths=("config2", "config3")),
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
         replaces="ndtpu/ndt/grid.py:232", paths=("config5_slab",)),
    dict(name="slab_sgh", source=_CSRC + "ndt_unpacked.cu",
         replaces="ndtpu/dist/gridmap.py:189", paths=("config5_slab",)),
]


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


def _table_check(name, out, ref):
    """K4's rule: valid flags exact, the rest within 1e-5 x max(|ref|,
    1e-3 x the column's max |ref|). Returns the max abs error."""
    import torch

    require(bool(torch.isfinite(out).all()), f"{name}: non-finite table")
    valid_cols = [8 * g + 5 for g in range(4)]
    require(bool((out[..., valid_cols] == ref[..., valid_cols]).all()),
            f"{name}: valid flags differ")
    err = (out - ref).abs()
    col_max = ref.abs().reshape(-1, ref.shape[-1]).amax(0)
    tol = 1e-5 * torch.maximum(ref.abs(), 1e-3 * col_max)
    require(bool((err <= tol).all()),
            f"{name}: table off by {float((err / (tol + 1e-30)).max()):.3g} "
            f"x tol")
    return float(err.max())


def bound(n_bytes: float, n_flops: float) -> dict:
    """The least time the card could take for work that must move
    ``n_bytes`` (each input read once, each output written once) and do
    ``n_flops`` f32 operations: the larger of the two times at the H100's
    peaks. No single PyTorch call computes any of these kernels' functions,
    so ``library_ms`` is null for every row."""
    tb = n_bytes / HBM_BYTES_S * 1e3
    tf = n_flops / F32_FLOP_S * 1e3
    return dict(bound_ms=max(tb, tf),
                bound_by="bytes" if tb >= tf else "operations",
                library_ms=None)


def lane_rows(poses, px, py, mask_f, grid, group=None):
    """Keys of the quad rows the lanes gather at ``poses`` (table index x R
    + row, one per masked in-bounds beam) and each lane's count of such
    beams, by the kernels' binning."""
    import torch

    from ndtpu_torch.ndt import match

    x, y, _, _ = match._lane_transform(poses, px, py)
    wh, hh = 2 * grid.nx + 1, 2 * grid.ny + 1
    inv = 2.0 / grid.cell
    hx = torch.floor((x - grid.x0) * inv)
    hy = torch.floor((y - grid.y0) * inv)
    ok = (mask_f > 0) & (hx >= 0) & (hx < wh) & (hy >= 0) & (hy < hh)
    key = hy.long() * wh + hx.long()
    if group is not None:
        key = key + group[:, None].long() * (wh * hh)
    return key[ok], ok.sum(-1)


def k1_bound(args, group=None):
    """K1's bound: poses, beams (and ``group``) read, each distinct row
    gathered once (128 B), 11 sums written; BEAM_FLOPS per in-bounds
    beam."""
    poses, px, py, mask_f, _, grid = args[:6]
    keys, beams = lane_rows(poses, px, py, mask_f, grid, group)
    b, n = px.shape
    n_bytes = (b * 12 + b * n * 12 + keys.unique().numel() * 128 + b * 44
               + (0 if group is None else b * 4))
    return bound(n_bytes, float(beams.sum()) * BEAM_FLOPS)


def check_k1(cfg, seq, table, seed, dev, b, jobs=None):
    """K1 vs ndt_terms_ref on the card: ``b`` lanes x 360 beams."""
    import numpy as np
    import torch

    from ndtpu_torch import kernels
    from ndtpu_torch.ndt import match

    rng = np.random.default_rng(seed)
    lane = np.arange(b) % seq.points.shape[0]
    noise = rng.normal(0.0, [0.05, 0.05, 0.01], (b, 3))
    poses = (seq.gt_poses[lane].double() + torch.as_tensor(noise)).float()
    args = (poses.to(dev).contiguous(),
            seq.points[lane, :, 0].to(dev).contiguous(),
            seq.points[lane, :, 1].to(dev).contiguous(),
            seq.mask[lane].float().to(dev).contiguous(), table, cfg.grid,
            cfg.match.d2, cfg.match.exp_clip)
    out = kernels.ndt_terms(*args)
    ref = match.ndt_terms_ref(*args)
    torch.cuda.synchronize()
    err = (out - ref).abs()
    tol = 1e-3 * torch.clamp(ref.abs(), min=1.0)
    require(bool(torch.isfinite(out).all()), "K1: non-finite sums")
    require(bool((err <= tol).all()),
            f"K1: sums off by up to {float((err / tol).max()):.3g} x tolerance")
    rel = float((err / torch.clamp(ref.abs(), min=1.0)).max())
    ms = time_ms(lambda: kernels.ndt_terms(*args))
    plain = time_ms(lambda: match.ndt_terms_ref(*args))
    bd = k1_bound(args)
    print(f"[smoke] K1 ndt_terms B={b} N={seq.points.shape[1]}: max abs err "
          f"{float(err.max()):.3e}, max rel err {rel:.3e} (tol 1e-3 x "
          f"max(1,|ref|)); kernel {ms:.4f} ms, plain {plain:.4f} ms, bound "
          f"{bd['bound_ms']:.6f} ms ({bd['bound_by']})")
    row = dict(max_abs_err=float(err.max()), ms=ms, plain_ms=plain, **bd)
    card_time(jobs, f"K1 ndt_terms B={b}", row, "card_ms",
              lambda: kernels.ndt_terms(*args), ["ndt_terms_kernel"])
    return row


def card_time(jobs, label, row, key, fn, names=None):
    """``fn``'s card time (``profile_port.card_ms``) into ``row[key]``: at
    once when ``jobs`` is None, else queued in ``jobs`` for
    :func:`read_card_times`. A ``torch.profiler`` session leaves the later
    CUDA launches of the process slower, so the smoke reads card times after
    its event-timed and entry-point phases."""
    if jobs is None:
        from profile_port import card_ms

        row[key] = card_ms(fn, names)
    else:
        jobs.append((label, row, key, fn, names))


def read_card_times(jobs):
    """Run the queued card timings, one line each."""
    from profile_port import card_ms

    for label, row, key, fn, names in jobs:
        row[key] = card_ms(fn, names)
        print(f"[smoke] card time {label}: {_fmt(row[key])} per call "
              f"(torch.profiler, mean of 20)")


def _fmt(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


def bits_equal(a, b) -> bool:
    """Tensors (or tuples of them) equal bit for bit."""
    import torch

    if isinstance(a, torch.Tensor):
        raw = lambda t: t.contiguous().reshape(-1).view(torch.uint8)
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


def check_k3(cfg, seq, base, seed, dev, k):
    """K3 vs the f64 CPU twin: ``k`` x 360 points, +1 and mixed +-1."""
    import numpy as np
    import torch

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
    print(f"[smoke] K3 halfcell_add M={m}: bit-equal to the fixed-point "
          f"model, on a second launch and under permutation; +1 weights max "
          f"abs err {e1:.3e} ({w1:.3f} x tol, counts exact; f32 twin "
          f"{f1:.3f} x tol), +-1 weights max abs err {e2:.3e} ({w2:.3f} x "
          f"tol; f32 twin {f2:.3f} x tol; tol 1e-5 x per-cell magnitude); "
          f"kernel {ms1:.4f} / {ms2:.4f} ms, plain {pl1:.4f} / {pl2:.4f} ms, "
          f"bound {bd['bound_ms']:.6f} ms ({bd['bound_by']})")
    return dict(max_abs_err=max(e1, e2), ms=ms1, plain_ms=pl1, **bd,
                tol_units=max(w1, w2), f32_twin_tol_units=max(f1, f2))


def k3_bound(m: int, grid) -> dict:
    """K3's bound with unit weights: points (8 B) and mask (1 B) read, the
    28 floats of (n, s, ss) per cell read and written; ~10 operations per
    point to bin and weigh it, 140 per cell to pool 4 grids x 7 moments
    and add them. The lattice scratch is not the function's."""
    c = grid.n_cells
    return bound(m * 9 + 2 * 28 * 4 * c, 10.0 * m + 140.0 * c)


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
    print(f"[smoke] K3 halfcell_add rebuild M={m} ({int(live.sum())} live): "
          f"bit-equal to the fixed-point model, on a second launch and under "
          f"permutation; kernel {ms:.4f} ms, plain {plain:.4f} ms, bound "
          f"{bd['bound_ms']:.6f} ms ({bd['bound_by']})")
    return dict(rebuild_m=m, rebuild_ms=ms, rebuild_plain_ms=plain,
                rebuild_bound_ms=bd["bound_ms"])


def k4_bound(grid) -> dict:
    """K4's bound: (n, s, ss) read (28 floats per cell), the [R, 32] table
    written; ~40 operations to finalize each of the 4 x C cells."""
    c = grid.n_cells
    rows = (2 * grid.nx + 1) * (2 * grid.ny + 1)
    return bound(28 * 4 * c + rows * 128, 160.0 * c)


def check_k4(label, ndt_cfg, grid, stats, jobs=None):
    """K4 vs finalize_pack_ref on the card at ``grid`` (valid flags exact,
    the rest within K4's rtol 1e-5), bit-identical on a second launch;
    event, card and plain times, and the bound."""
    import torch

    from ndtpu_torch import kernels
    from ndtpu_torch.ndt import grid as ndt_grid

    run = lambda: kernels.finalize_pack(stats.n, stats.s, stats.ss, ndt_cfg,
                                        grid)
    out, again = run(), run()
    ref = ndt_grid.finalize_pack_ref(stats, ndt_cfg, grid)
    torch.cuda.synchronize()
    require(bits_equal(out, again), f"K4 {label}: two launches differ")
    err = _table_check(f"K4 {label}", out, ref)
    valid = int(ref[:, [8 * g + 5 for g in range(4)]].sum())
    ms = time_ms(run)
    plain = time_ms(lambda: ndt_grid.finalize_pack_ref(stats, ndt_cfg, grid))
    rows, bands, threads, smem = kernels.finalize_bands(grid, out.device)
    bd = k4_bound(grid)
    print(f"[smoke] K4 finalize_pack {label} R={out.shape[0]} ({bands} bands "
          f"of {rows} rows, {threads} threads and {smem} B of shared memory "
          f"each; {valid} valid "
          f"slots): bit-identical on a second launch, valid exact, max abs "
          f"err {err:.3e} (rtol 1e-5); kernel {ms:.4f} ms, plain "
          f"{plain:.4f} ms, bound {bd['bound_ms']:.6f} ms ({bd['bound_by']})")
    row = dict(max_abs_err=err, ms=ms, plain_ms=plain, rows=out.shape[0],
               **bd)
    card_time(jobs, f"K4 finalize_pack {label}", row, "card_ms", run,
              ["finalize_pack_kernel"])
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
    K8a."""
    import torch

    from ndtpu_torch.loop import closure
    from ndtpu_torch.slam.keyframes import KeyframeStore

    cap, t = cfg3.keyframe.capacity, seq.points.shape[0]
    src = torch.arange(cap) % t
    pts = seq.points[src].to(dev).contiguous()
    msk = seq.mask[src].to(dev).contiguous()
    tables = torch.zeros((cap,) + closure.local_table_shape(cfg3.loop, False),
                         dtype=torch.float32, device=dev)
    closure.write_local_tables(tables, torch.arange(cap, device=dev),
                               torch.ones(cap, dtype=torch.bool, device=dev),
                               pts, msk, cfg3.loop, cfg3.ndt)
    return KeyframeStore(poses=seq.gt_poses[src].to(dev), points=pts,
                         masks=msk, live=torch.arange(cap, device=dev) < t,
                         n=torch.tensor(t, device=dev), tables=tables)


def check_k8a(cfg3, seq, seed, dev, w):
    """K8a vs its twin: ``w`` keyframes into random slots of a ``w``-slot
    cache. (a) Points snapped to 2^-4 m, so every moment sum is exact in
    f32 and kernel and twin see the same statistics: against the twin on
    the card at K4's rtol 1e-5. (b) Points snapped to 2^-16 m (f32 and f64
    bin them alike): against the f64 twin on the CPU, valid flags exact,
    means at rtol 1e-5, and the inverse covariances' error reported (f32
    cancellation in ss/n - mean^2 on thin wall cells bounds it). (c) The
    scans as they are: bit-identical on a second launch, with each scan's
    points in a random order, and to K4 of K3's statistics of each scan.
    Timed writing into a cache allocated once, as the main path does."""
    import numpy as np
    import torch

    from ndtpu_torch import kernels
    from ndtpu_torch.loop import closure
    from ndtpu_torch.ndt import grid as ndt_grid

    rng = np.random.default_rng(seed + 4)
    lane = torch.as_tensor(rng.integers(0, seq.points.shape[0], w))
    slots = torch.as_tensor(rng.permutation(w))
    ok = torch.ones(w, dtype=torch.bool)
    shape = (w,) + closure.local_table_shape(cfg3.loop, False)
    msk = seq.mask[lane]
    lgrid = closure.local_grid_config(cfg3.loop)
    cache = torch.zeros(shape, dtype=torch.float32, device=dev)
    slot_d, ok_d, msk_d = slots.to(dev, torch.int32), ok.to(dev), msk.to(dev)

    def kernel(pts, m=msk_d):
        return kernels.local_tables(cache, slot_d, ok_d, pts, m, lgrid,
                                    cfg3.ndt)

    raw = seq.points[lane].to(dev).contiguous()
    one = kernel(raw).clone()
    two = kernel(raw).clone()
    perm = torch.as_tensor(rng.permutation(raw.shape[1]), device=dev)
    shuf = kernel(raw[:, perm].contiguous(), msk_d[:, perm].contiguous())
    torch.cuda.synchronize()
    require(bits_equal(one, two), "K8a: two launches differ")
    require(bits_equal(one, shuf), "K8a: permuted points differ")
    for k in range(w):
        st = ndt_grid.halfcell_add(
            ndt_grid.empty_stats(lgrid, torch.float32, dev), raw[k],
            msk_d[k], 1.0, lgrid)
        require(bits_equal(one[int(slots[k])],
                           ndt_grid.finalize_pack(st, cfg3.ndt, lgrid)),
                f"K8a: keyframe {k}'s table differs from K4 of K3")
    rows, bands, smem = kernels.local_bands(w, lgrid, dev)

    p4 = snap(seq.points[lane], 4).to(dev).contiguous()
    twin = lambda: closure.write_local_tables_ref(
        torch.zeros(shape, dtype=torch.float32, device=dev), slots.to(dev),
        ok.to(dev), p4, msk.to(dev), cfg3.loop, cfg3.ndt)
    out, ref = kernel(p4).clone(), twin()
    torch.cuda.synchronize()
    err4 = _table_check("K8a", out, ref)

    p16 = snap(seq.points[lane].double(), 16)
    out16 = kernel(p16.float().to(dev).contiguous()).cpu().double()
    ref64 = closure.write_local_tables_ref(
        torch.zeros(shape, dtype=torch.float64), slots, ok, p16, msk,
        cfg3.loop, cfg3.ndt)
    valid_cols = [8 * g + 5 for g in range(4)]
    require(bool((out16[..., valid_cols] == ref64[..., valid_cols]).all()),
            "K8a: valid flags differ from the f64 twin")
    mean_cols = [8 * g + k for g in range(4) for k in (0, 1)]
    icov_cols = [8 * g + k for g in range(4) for k in (2, 3, 4)]
    merr = (out16[..., mean_cols] - ref64[..., mean_cols]).abs()
    mtol = 1e-5 * torch.clamp(ref64[..., mean_cols].abs(), min=1e-3 * float(
        ref64[..., mean_cols].abs().max()))
    require(bool((merr <= mtol).all()),
            f"K8a: means off the f64 twin by {float((merr / mtol).max()):.3g}"
            f" x tol")
    ierr = (out16[..., icov_cols] - ref64[..., icov_cols]).abs()
    irel = float(ierr.max() / ref64[..., icov_cols].abs().max())
    require(bool(torch.isfinite(out16).all()), "K8a: non-finite table")
    ms = time_ms(lambda: kernel(p4))
    plain = time_ms(twin)
    # Points (8 B), mask (1 B), slot and ok read, W tables written; ~10
    # operations per point and 40 per finalized cell slot.
    n = seq.points.shape[1]
    bd = bound(w * (n * 9 + 5) + w * shape[1] * 128,
               10.0 * w * n + 40.0 * w * shape[1] * 4)
    print(f"[smoke] K8a local_tables W={w} N={seq.points.shape[1]} "
          f"({shape[1]} rows; {bands} bands of {rows} rows, {w * bands} "
          f"blocks, {smem} B of shared memory each): bit-identical on a "
          f"second launch, under permutation and to K4 of K3; vs f32 "
          f"twin (2^-4 m points) max abs err "
          f"{err4:.3e} (K4 rtol 1e-5), valid exact; vs f64 twin (2^-16 m) "
          f"valid exact, means within rtol 1e-5, icov max err "
          f"{float(ierr.max()):.3e} = {irel:.3e} of its max; kernel "
          f"{ms:.4f} ms, plain {plain:.4f} ms, bound {bd['bound_ms']:.6f} ms "
          f"({bd['bound_by']})")
    return dict(max_abs_err=err4, ms=ms, plain_ms=plain, **bd)


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
    out = kernels.ndt_terms(*args, group=g32)
    ref = match.ndt_terms_ref(*args, group=g32)
    torch.cuda.synchronize()
    err = (out - ref).abs()
    tol = 1e-3 * torch.clamp(ref.abs(), min=1.0)
    require(bool(torch.isfinite(out).all()), "K1 grouped: non-finite sums")
    require(bool((err <= tol).all()),
            f"K1 grouped: sums off by up to {float((err / tol).max()):.3g} x "
            f"tolerance")
    hit = float((ref[:, 1] > 0).float().mean())
    ms = time_ms(lambda: kernels.ndt_terms(*args, group=g32))
    plain = time_ms(lambda: match.ndt_terms_ref(*args, group=g32))
    bd = k1_bound(args, g32)
    print(f"[smoke] K1 ndt_terms grouped B={b} N={seq.points.shape[1]} "
          f"S={kf.capacity}: max abs err {float(err.max()):.3e} (tol 1e-3 x "
          f"max(1,|ref|)), {hit:.2f} of lanes see valid cells; kernel "
          f"{ms:.4f} ms, plain {plain:.4f} ms, bound {bd['bound_ms']:.6f} ms "
          f"({bd['bound_by']})")
    row = dict(max_abs_err=float(err.max()), ms=ms, plain_ms=plain, **bd)
    card_time(jobs, "K1 ndt_terms grouped", row, "card_ms",
              lambda: kernels.ndt_terms(*args, group=g32), ["ndt_terms"])
    return row


def loop_queries(cfg3, seq, kf, seed, dev, c: int):
    """``profile_port.loop_queries`` (4 queries at the end of the box-world
    lap x ``c`` candidates) and its lanes as ``closure._verify_lanes`` gives
    them: ``(loop, query, query indices, candidates, lanes)``."""
    from ndtpu_torch.loop import closure
    from profile_port import loop_queries as queries

    loop, query, qidx, cands = queries(cfg3, seq, kf, seed, dev, c)
    lanes = closure._verify_lanes(kf, *query, cands, loop, cfg3.match)
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
    kernels.reset_launches()
    one = fused()
    torch.cuda.synchronize()
    require(kernels.LAUNCHES["lm_ndt_grouped"] == 1
            and kernels.LAUNCHES["loop_gate_fused"] == 1
            and sum(kernels.LAUNCHES.values()) == 2,
            f"gated verify: launches {kernels.LAUNCHES}, expected one "
            f"lm_ndt_grouped counted as loop_gate_fused")
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
    print(f"[smoke] gated verify K=4 C={c}: one lm_ndt_grouped launch "
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
    card_time(jobs, f"gated verify C={c}, the gated lm_ndt launch", row,
              "card_ms", fused, ["lm_ndt_kernel"])
    card_time(jobs, f"gated verify C={c}, every kernel of the verify", row,
              "verify_card_ms", verify)
    card_time(jobs, f"unfused verify C={c}, every kernel of the verify", row,
              "unfused_verify_card_ms", unfused)
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
STAGES = ("_window_frontend", "_wb_loops", "_wb_appends", "_wb_smooth",
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

    from ndtpu_torch.ndt import match

    init, px, py, mask_f, table, grid, group = args
    run = lambda: match.lm_ndt(*args[:6], cfg, group)
    twin = lambda: match.lm_ndt_ref(*args[:6], cfg, group)
    composite = lambda: lm_composite(*args[:6], cfg, group)
    kres, cres, tres = run(), composite(), twin()
    torch.cuda.synchronize()
    for name in ("pose", "hessian", "score"):
        require(bool(torch.isfinite(getattr(kres, name)).all()),
                f"lm_ndt {label}: non-finite {name}")
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
                f"lm_ndt {label}: lane {lane} differs from the composite "
                f"route (n_iter {int(kres.n_iter[lane])} vs "
                f"{int(cres.n_iter[lane])}, converged "
                f"{bool(kres.converged[lane])} vs "
                f"{bool(cres.converged[lane])}) and is no accept tie: {tie}")
        print(f"[smoke] lm_ndt {label}: lane {lane} parts from the composite "
              f"route at an accept tie: iteration {tie[0]}, f {tie[1]!r}, "
              f"f2 {tie[2]!r}, |f2 - f| / |f| = {tie[3]:.3e}")
        ties += 1
    cerr = float((kres.pose - cres.pose)[same].abs().max()) \
        if bool(same.any()) else 0.0
    conv_eq = int((kres.converged == tres.converged).sum())
    both = kres.converged & tres.converged
    terr = float((kres.pose - tres.pose)[both].abs().max()) \
        if bool(both.any()) else 0.0
    require(terr <= 1e-3, f"lm_ndt {label}: poses {terr:.3e} off the f32 "
            f"twin on lanes converged in both (tol 1e-3)")
    ms = time_ms(run)
    comp_ms = time_ms(composite)
    plain = time_ms(twin)
    lb = lm_bound(args, kres)
    bd = bound(lb["n_bytes"], lb["n_flops"])
    b, n = px.shape
    its = kres.n_iter.long()
    print(f"[smoke] lm_ndt {label} B={b} N={n}: n_iter mean "
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
    card_time(jobs, f"lm_ndt {label}", row, "card_ms", run, ["lm_ndt_kernel"])
    return row, (conv_eq, b)


def lm_bound(args, kres) -> dict:
    """``lm_ndt``'s work on ``args`` as run to ``kres``: bytes (init, beams
    and group read, each distinct row gathered at the initial or final
    poses once, pose/H/score/n_iter/converged written) and operations
    ((n_iter + 1) evaluations of each lane's in-bounds beams, n_iter LM
    steps)."""
    import torch

    init, px, py, mask_f, _, grid, group = args
    keys0, _ = lane_rows(init, px, py, mask_f, grid, group)
    keys1, beams = lane_rows(kres.pose, px, py, mask_f, grid, group)
    b, n = px.shape
    rows = torch.cat([keys0, keys1]).unique().numel()
    its = kres.n_iter.long()
    return dict(n_bytes=b * 12 + b * n * 12 + rows * 128 + b * 57
                + (0 if group is None else b * 4),
                n_flops=float(((its + 1) * beams).sum()) * BEAM_FLOPS
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


def check_k5(sm, cfg3, jobs=None):
    """K5 against ``factor_linearize_ref`` (f32, on the card) on a real
    graph: the whole graph, the local path's gathered rows, chi^2 only and
    the fresh window; each array within rtol 1e-5 of its max, chi^2 and
    the window's max within rtol 1e-5; bit-identical on a second launch."""
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
          f"second launch; kernel {ms:.4f} ms, plain {plain:.4f} ms, bound "
          f"{bd['bound_ms']:.6f} ms ({bd['bound_by']})")
    row = dict(max_abs_err=err, ms=ms, plain_ms=plain, **bd)
    card_time(jobs, "K5 factor_linearize", row, "card_ms", run,
              ["linearize_"])
    return row


def check_k6(sm, cfg3, jobs=None):
    """K6 against the f32 plain ``pcg_solve_ref`` (on the card) and the f64
    plain version (CPU) on the same system. The kernel sums in another
    order than either, so it is not bit-equal to them: it passes when its
    error against f64 is <= 2 x the f32 plain version's + 1e-6 x max|x| and
    its iteration count is within 1 of the f32 plain version's. Also:
    bit-identical on a second launch, one launch per ``pcg`` call and no
    host sync in it, the 0-iteration mode (the settled check's step)
    within rtol 1e-5, and the dense library solve of the same damped
    system timed beside it."""
    import torch

    from ndtpu_torch import kernels
    from ndtpu_torch.graph import factors as fct
    from ndtpu_torch.graph import solve as slv

    g, cfg = sm.graph, cfg3.solver
    lin = fct.factor_linearize_ref(*fct._graph_args(g), cfg.huber_delta)
    lam = torch.tensor(cfg.init_lambda, dtype=torch.float32,
                       device=g.poses.device)
    run = lambda: slv.pcg_solve(g, lin, None, lam, cfg.pcg_max_iter,
                                cfg.pcg_tol)
    x, it, _ = run()
    again = run()
    xp, itp, _ = slv.pcg_solve_ref(g, lin, None, lam, cfg.pcg_max_iter,
                                   cfg.pcg_tol)
    lin64 = tuple(tuple(t.cpu().double() for t in part) for part in lin)
    x64, it64, _ = slv.pcg_solve_ref(graph_on(g, "cpu", torch.float64), lin64,
                                     None, lam.cpu().double(),
                                     cfg.pcg_max_iter, cfg.pcg_tol)
    torch.cuda.synchronize()
    require(bits_equal((x, it), again[:2]), "K6: two launches differ")
    require(bool(torch.isfinite(x).all()), "K6: x not finite")
    ek = float((x.cpu().double() - x64).abs().max())
    ep = float((xp.cpu().double() - x64).abs().max())
    xmax = float(x64.abs().max())
    require(ek <= 2.0 * ep + 1e-6 * xmax,
            f"K6: {ek:.3e} off f64, over 2 x the f32 plain version's "
            f"{ep:.3e} + 1e-6 x {xmax:.3e}")
    require(abs(int(it) - int(itp)) <= 1,
            f"K6: {int(it)} iterations, the f32 plain version {int(itp)}")
    _, it0, z0 = slv.pcg_solve(g, lin, None, 0.0, 0, cfg.pcg_tol, 1e-8)
    _, _, z0p = slv.pcg_solve_ref(g, lin, None, 0.0, 0, cfg.pcg_tol, 1e-8)
    require(int(it0) == 0, "K6: iterations with max_iter 0")
    _rel_check("K6 settled step", [z0[None]], [z0p[None]])
    before = kernels.LAUNCHES["pcg_solve"]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        slv.pcg(g, lin, lam, cfg)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    require(kernels.LAUNCHES["pcg_solve"] == before + 1,
            "K6: not one pcg_solve launch per pcg call")
    ms = time_ms(run)
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
    v, f, p = g.poses.shape[0], g.bet_i.shape[0], g.prior_idx.shape[0]
    live, n_it = int(g.bet_mask.sum()), int(it)
    live_v = int(g.pose_mask.sum())
    # Every factor's mask (1 B), a live factor's linearization and indices
    # (100 B), the priors (57 B) and the pose mask read once; x [V, 3] and
    # the two scalars written. A dead pose's rhs is 0, so its r, z, p and x
    # stay 0: only live factors and poses need the arithmetic.
    bd = bound(f + live * 100 + p * 57 + v + v * 12 + 8,
               live * (K6_SETUP_FACTOR + n_it * K6_ITER_FACTOR)
               + live_v * (K6_SETUP_POSE + n_it * K6_ITER_POSE))
    print(f"[smoke] K6 pcg_solve V={v} ({live_v} live) F={f} ({live} live): "
          f"{n_it} "
          f"iterations (f32 plain {int(itp)}, f64 {int(it64)}); vs f64 max "
          f"abs err {ek:.3e} (f32 plain {ep:.3e}; max|x| {xmax:.3e}); "
          f"bit-identical on a second launch; one launch per pcg call, no "
          f"host sync; settled step {float(z0):.6e} vs {float(z0p):.6e}; "
          f"kernel {ms:.4f} ms, plain {plain:.4f} ms, library (dense "
          f"cholesky_ex + cholesky_solve of the {3 * v} x {3 * v} damped "
          f"system: a direct solve) {lib:.4f} ms, bound {bd['bound_ms']:.6f} "
          f"ms ({bd['bound_by']})")
    row = dict(max_abs_err=ek, ms=ms, plain_ms=plain, **bd, iterations=n_it,
               plain_f32_err_vs_f64=ep)
    row.update(library_ms=lib, library="torch.linalg.cholesky_ex + "
               "torch.cholesky_solve of solve_dense's damped system: a "
               "direct solve, not the same algorithm")
    card_time(jobs, "K6 pcg_solve", row, "card_ms", run, ["pcg_solve"])
    return row


#: What K7a writes: the selection the local path reads.
SELECT_KEYS = ("ok", "pid", "in_set", "fid", "f_sel", "ri", "rj", "li", "lj",
               "rp", "lp", "p_act")


def check_k7a(sm, cfg3, jobs=None):
    """K7a bit-equal to ``local_select_ref`` (on the card) with ``since`` =
    the newest factor, none, and 40 factors back, and on a second launch;
    timed with the newest factor fresh."""
    import torch

    from ndtpu_torch.graph import incremental as inc

    g, cfg = sm.graph, cfg3.solver
    oks = []
    for since in (g.n_between - 1, None, g.n_between - 40):
        one, two = (inc.local_select(g, cfg, since) for _ in range(2))
        ref = inc.local_select_ref(g, cfg, since)
        torch.cuda.synchronize()
        for key in SELECT_KEYS:
            require(bits_equal(one[key], ref[key].to(one[key].dtype)),
                    f"K7a: {key} differs from the plain selection")
            require(bits_equal(one[key], two[key]),
                    f"K7a: {key} differs on a second launch")
        oks.append(bool(one["ok"]))
    since = g.n_between - 1
    run = lambda: inc.local_select(g, cfg, since)
    ms = time_ms(run)
    plain = time_ms(lambda: inc.local_select_ref(g, cfg, since))
    v, f, p = g.poses.shape[0], g.bet_i.shape[0], g.prior_idx.shape[0]
    sel = run()
    p_loc, f_loc = sel["p_loc"], sel["fid"].shape[0]
    # Indices and masks read (17 B per factor, 1 per pose, 9 per prior),
    # the flags and int64 outputs written; ~8 integer operations per factor
    # per pass (the sweeps and two more) and per pose, at the f32 rate.
    bd = bound(f * 17 + v + p * 9 + 16 + (1 + p_loc + f_loc + p)
               + 8 * (p_loc + 5 * f_loc + 2 * p),
               8.0 * f * (cfg.local_hops + 2) + 8.0 * v)
    print(f"[smoke] K7a local_select V={v} F={f}: bit-equal to the plain "
          f"selection and on a second launch (since = the newest factor, "
          f"none, 40 back: ok {oks}); {int(sel['in_set'].sum())} active "
          f"poses and {int(sel['f_sel'].sum())} touched factors selected; "
          f"kernel {ms:.4f} ms, "
          f"plain {plain:.4f} ms, bound {bd['bound_ms']:.6f} ms "
          f"({bd['bound_by']})")
    row = dict(max_abs_err=0.0, ms=ms, plain_ms=plain, **bd)
    card_time(jobs, "K7a local_select", row, "card_ms", run,
              ["local_select"])
    return row


def check_k7b(sm, cfg3, jobs=None):
    """K7b against ``assemble_local_ref`` (f32, on the card) on a real
    local selection (the newest factor fresh): h_ii and b_i within rtol
    1e-5 of their max, bit-identical on a second launch."""
    import torch

    from ndtpu_torch.dist import schur
    from ndtpu_torch.graph import incremental as inc

    g, cfg = sm.graph, cfg3.solver
    sel = inc.local_select(g, cfg, g.n_between - 1)
    (ai, aj, r), (ap, rp) = inc._local_lin(g, g.poses, sel, cfg.huber_delta)
    args = (sel["p_loc"], ai, aj, r, ap, rp, sel["f_sel"], sel["ri"],
            sel["li"], sel["rj"], sel["lj"], sel["p_act"], sel["rp"],
            sel["lp"])
    run = lambda: schur.assemble_local(*args)
    out, again = run(), run()
    ref = schur.assemble_local_ref(*args)
    torch.cuda.synchronize()
    require(bool(sel["ok"]), "K7b: the selection does not fit")
    require(bits_equal(out, again), "K7b: two launches differ")
    err = _rel_check("K7b", out, ref)
    ms = time_ms(run)
    plain = time_ms(lambda: schur.assemble_local_ref(*args))
    n, k, p = sel["p_loc"], ai.shape[0], ap.shape[0]
    fs = sel["f_sel"]
    ii, jj = fs & (sel["ri"] == 0), fs & (sel["rj"] == 0)
    own, both = int(ii.sum()) + int(jj.sum()), int((ii & jj).sum())
    # Blocks and selection read (117 B per row, 65 per prior), h_ii and b_i
    # written; 54 operations per 3 x 3 contribution (own and cross), 18 per
    # A^T r.
    bd = bound(k * 117 + p * 65 + 36 * n * n + 12 * n,
               54.0 * (own + 2 * both) + 18.0 * own)
    print(f"[smoke] K7b local_assemble n={n} K={k} ({int(fs.sum())} "
          f"selected, {int(sel['in_set'].sum())} interior poses): vs f32 "
          f"plain max abs err {err:.3e} (rtol 1e-5 of the max); "
          f"bit-identical on a second launch; kernel {ms:.4f} ms, plain "
          f"{plain:.4f} ms, bound {bd['bound_ms']:.6f} ms ({bd['bound_by']})")
    row = dict(max_abs_err=err, ms=ms, plain_ms=plain, **bd)
    card_time(jobs, "K7b local_assemble", row, "card_ms", run,
              ["local_assemble"])
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
    ("ndtpu_torch.loop.closure", "write_local_tables_ref"))
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
    ref = sn.supernodal_assemble_ref(plan, *_flat(lin))
    ref64 = sn.supernodal_assemble_ref(plan, *_cpu64(_flat(lin)))
    torch.cuda.synchronize()
    require(bits_equal(out, again), "K9a: two launches differ")
    err = _rel_check("K9a vs f32 plain", out, ref)
    err64 = _rel_check("K9a vs f64 plain", _cpu64(out), ref64)
    ms = time_ms(run)
    plain = time_ms(lambda: sn.supernodal_assemble_ref(plan,
                                                       *_flat(lin)))
    bd = k9a_bound(plan, lin)
    sp = plan.schur
    t = plan.routes.host
    print(f"[smoke] K9a supernodal_assemble P={sp.fac_idx.shape[0]} "
          f"ni={sp.ni} ns={sp.ns} ns_loc={plan.ns_loc} "
          f"({t['tgt_col'].size} target blocks, {t['code'].size} pairs): vs "
          f"f32 plain max abs err {err:.3e}, vs f64 plain {err64:.3e} (rtol "
          f"1e-5 of each target's max); bit-identical on a second launch; "
          f"kernel {ms:.4f} ms, plain {plain:.4f} ms, bound "
          f"{bd['bound_ms']:.6f} ms ({bd['bound_by']})")
    row = dict(max_abs_err=err, max_abs_err_f64=err64, ms=ms, plain_ms=plain,
               **bd)
    card_time(jobs, "K9a supernodal_assemble", row, "card_ms", run,
              ["supernodal_assemble"])
    return row, out


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
    ref = sn.schur_reduce_ref(plan, *args)
    ref64 = sn.schur_reduce_ref(plan, *_cpu64(args[:4]), lam)
    torch.cuda.synchronize()
    require(bool(torch.isfinite(s_part).all()), "K9b: Schur parts not finite")
    require(bits_equal(out, again), "K9b: two launches differ")
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
    lib = time_ms(lambda: flat.clone().index_add_(0, idx, src, alpha=-1.0))
    bd = k9b_bound(plan)
    print(f"[smoke] K9b schur_reduce ns={plan.schur.ns} "
          f"ns_loc={plan.ns_loc}: vs f32 plain max abs err {err:.3e}, vs f64 "
          f"plain {err64:.3e} (rtol 1e-5 of each output's max); "
          f"bit-identical on a second launch; kernel {ms:.4f} ms, plain "
          f"{plain:.4f} ms, library (index_add_ of the routed parts into a "
          f"copy of h_ss, no damping) {lib:.4f} ms, bound "
          f"{bd['bound_ms']:.6f} ms ({bd['bound_by']})")
    row = dict(max_abs_err=err, max_abs_err_f64=err64, ms=ms, plain_ms=plain,
               **bd)
    row.update(library_ms=lib, library="torch.Tensor.index_add_(alpha=-1) "
               "of the routed Schur parts into a copy of h_ss: the same sum "
               "without the damping")
    card_time(jobs, "K9b schur_reduce", row, "card_ms", run,
              ["schur_reduce"])
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
    saved = sn.supernodal_delta
    steps = 0

    def counted(*a, **k):
        nonlocal steps
        steps += 1
        return saved(*a, **k)

    sn.supernodal_delta = counted
    try:
        kernels.reset_launches()
        res = solve_g2o.main(["--manhattan", str(CONFIG4["n_poses"]),
                              "--shards", str(CONFIG4["shards"])])
        launches = dict(kernels.LAUNCHES)
    finally:
        sn.supernodal_delta = saved
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


def run_entry_point(dev, config, n_scans: int):
    """The CLI main path on ``config``, with fresh launch counters and
    counts of the loop-detection calls (``verify_candidates_cached_flat``),
    the smoother's takes (0 skip, 1 global, 2 local), its full solves and
    its PCG solves (``graph.solve.pcg_solve`` calls, one ``pcg_solve``
    launch each). Returns ``(launches, counts)``."""
    import numpy as np

    from ndtpu_torch import kernels, run
    from ndtpu_torch.config import PipelineConfig
    from ndtpu_torch.graph import incremental as inc
    from ndtpu_torch.graph import solve as slv
    from ndtpu_torch.loop import closure
    from ndtpu_torch.ndt import match

    windows = -(-n_scans // PipelineConfig.from_json(str(config)).window)
    saved = [(closure, "verify_candidates_cached_flat"),
             (inc, "incremental_update"), (slv, "optimize"),
             (slv, "pcg_solve")]
    saved = [(mod, name, getattr(mod, name)) for mod, name in saved]
    counts = dict(detections=0, full_solves=0, pcg_solves=0)
    takes = []

    def counted(fn, key):
        def inner(*a, **k):
            counts[key] += 1
            return fn(*a, **k)
        return inner

    def recorded(*a, **k):
        out = saved[1][2](*a, **k)
        takes.append(out[1])
        return out

    closure.verify_candidates_cached_flat = counted(saved[0][2], "detections")
    inc.incremental_update = recorded
    slv.optimize = counted(saved[2][2], "full_solves")
    slv.pcg_solve = counted(saved[3][2], "pcg_solves")
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
    require(traj.shape == (n_scans, 3) and bool(np.isfinite(traj).all()),
            "entry point: trajectory not finite or of the wrong shape")
    require(res["n_keyframes"] > 0, "entry point: no keyframes")
    lm = launches["lm_ndt"] + launches["lm_ndt_grouped"]
    require(lm == calls, f"entry point {config.name}: {lm} lm_ndt launches "
            f"for {calls} match_batch_packed calls (one each expected)")
    require(launches["pcg_solve"] == counts["pcg_solves"],
            f"entry point {config.name}: {launches['pcg_solve']} pcg_solve "
            f"launches for {counts['pcg_solves']} PCG solves (one each "
            f"expected)")
    codes = [int(t) for t in takes]
    counts["takes"] = {c: codes.count(c) for c in (0, 1, 2)}
    print(f"[smoke] entry point {config.name}: {n_scans} scans, "
          f"{res['scans_per_s']:.1f} scans/s ({res['seconds']:.2f} s), "
          f"keyframes={res['n_keyframes']}, loops={res['n_loops']}, ATE "
          f"{res['ate']:.4f} m, {calls} match_batch_packed calls, "
          f"{lm / windows:.2f} lm_ndt launches per window ({windows} "
          f"windows), {counts['detections']} loop-detection calls; smoother: "
          f"{len(codes)} updates, takes (0 skip, 1 global, 2 local) "
          f"{counts['takes']}, {counts['full_solves']} full solves, "
          f"{counts['pcg_solves']} PCG solves; launches {launches}")
    return launches, counts


def ate_gate(dev, config, ref_file):
    """Box-world draws 0-2 through ``run_slam_windowed`` vs the JAX
    reference's ATE (and loop count, with loop closure on)."""
    import torch

    from ndtpu_torch.config import PipelineConfig
    from ndtpu_torch.eval.ate import ate_rmse
    from ndtpu_torch.slam import pipeline

    ref = json.loads(ref_file.read_text())
    cfg = PipelineConfig.from_json(str(config))
    ates, jax_ates = [], []
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
        if cfg.use_loop_closure:
            n_loops = int(state.n_loops)
            loops = (f", loops {n_loops} (JAX {draw['jax_n_loops']})")
            require(n_loops > 0 or draw["jax_n_loops"] == 0,
                    f"ATE gate: draw {draw['seed']} closed no loop where "
                    f"JAX closed {draw['jax_n_loops']}")
        print(f"[smoke] ATE gate {config.name} draw {draw['seed']}: "
              f"{(p.shape[0] - 1) / dt:.1f} scans/s, ATE {ate:.4f} m, JAX "
              f"ATE {draw['jax_ate_m']:.4f} m{loops}, dead reckoning "
              f"{dr:.4f} m (reference {draw['dead_reckoning_ate_m']:.4f} m), "
              f"inputs {'match' if same else 'DIFFER FROM'} the reference "
              f"hashes")
        require(ate < 0.75 * draw["dead_reckoning_ate_m"],
                f"ATE gate: draw {draw['seed']} ATE {ate:.4f} m is not below "
                f"0.75 x dead reckoning {draw['dead_reckoning_ate_m']:.4f} m")
        ates.append(ate)
        jax_ates.append(draw["jax_ate_m"])
    med, jmed = statistics.median(ates), statistics.median(jax_ates)
    limit = max(0.10, 2.0 * jmed)
    print(f"[smoke] ATE gate {config.name}: median {med:.4f} m vs limit "
          f"{limit:.4f} m (max(0.10, 2 x JAX median {jmed:.4f}))")
    require(med <= limit, "ATE gate: median ATE above the limit")


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


def run_serving(dev, card):
    """Stacked serving through its entry point, twice: ``ndtpu_torch.serve
    .main`` with ``SERVING_ARGS`` (8 sessions x 300 scans of
    ``configs/config_serving.json``, 360 beams, capacity 160), every launch
    counter reset just before the first invocation and read just after it,
    with no plain twin reachable on CUDA tensors. Each invocation is one
    first run and 3 timed runs. Requires, per stacked window: one
    ``lm_ndt_grouped`` launch per front-end pass for all 8 sessions (the
    gated verifies, one per session per window, apart), one K3s launch per
    use (pass-2 maps, extend, and refresh where one fires) and two K4s,
    never a per-map K3 or K4 (K3 runs only in each session's
    ``init_slam``); at most ``inc_iters`` K6b launches (exactly that per
    smoother call) and no K6; no drop; the two invocations' trajectories
    and final states bit-equal. Returns ``(launches, summary, state)``, the
    state of the last run."""
    import dataclasses

    import torch

    from ndtpu_torch import kernels, serve
    from ndtpu_torch.config import PipelineConfig
    from ndtpu_torch.dist import slam_dp

    cfg = slam_dp.serving_config(PipelineConfig.from_json(str(SERVING)))
    counts = dict(windows=0, refreshes=0, smooths=0, runs=0)
    finals = []
    saved = [(name, getattr(slam_dp, name)) for name in
             ("_stacked_window_step", "_refresh_stacked", "_smooth_stacked",
              "run_sessions_stacked")]

    def counted(fn, key):
        def inner(*a, **k):
            counts[key] += 1
            out = fn(*a, **k)
            if key == "runs":
                finals.append(out)
            return out
        return inner

    for (name, fn), key in zip(saved, ("windows", "refreshes", "smooths",
                                       "runs")):
        setattr(slam_dp, name, counted(fn, key))
    try:
        with no_plain_on_card(PLAIN_SERVING):
            kernels.reset_launches()
            res = serve.main(SERVING_ARGS)
            launches = dict(kernels.LAUNCHES)
            first = dict(counts)
            res2 = serve.main(SERVING_ARGS)
    finally:
        for name, fn in saved:
            setattr(slam_dp, name, fn)
    torch.cuda.synchronize()
    n_s, runs, w = res["sessions"], first["runs"], first["windows"]
    passes = cfg.window_passes
    require(res["device"] == torch.cuda.get_device_name(0),
            f"serving ran on {res['device']}")
    n_scans = int(SERVING_ARGS[SERVING_ARGS.index("--max-scans") + 1])
    require(runs == 4 and w == runs * -(-(n_scans - 1) // cfg.window),
            f"serving: {runs} runs of {w} windows in all")
    verify = launches["loop_gate_fused"]
    require(launches["lm_ndt_grouped"] - verify == passes * w
            and launches["lm_ndt"] == 0,
            f"serving: {launches['lm_ndt_grouped'] - verify} front-end "
            f"lm_ndt_grouped launches for {w} windows x {passes} passes (one "
            f"each for all {n_s} sessions expected) and "
            f"{launches['lm_ndt']} shared-table launches")
    require(launches["halfcell_add_stacked"]
            == (passes - 1) * w + w + first["refreshes"]
            and launches["halfcell_add"] == n_s * runs,
            f"serving: {launches['halfcell_add_stacked']} K3s launches for "
            f"{w} windows and {first['refreshes']} refreshes, "
            f"{launches['halfcell_add']} per-map K3 launches ({n_s} per run "
            f"expected, in init_slam)")
    require(launches["finalize_pack_stacked"] == passes * w
            and launches["finalize_pack"] == 0,
            f"serving: {launches['finalize_pack_stacked']} K4s and "
            f"{launches['finalize_pack']} K4 launches for {w} windows")
    k6b = launches["pcg_solve_blocked"]
    require(k6b == cfg.solver.inc_iters * first["smooths"] > 0
            and k6b <= cfg.solver.inc_iters * w
            and launches["pcg_solve"] == 0,
            f"serving: {k6b} K6b launches for {first['smooths']} smoother "
            f"calls in {w} windows (inc_iters {cfg.solver.inc_iters}), "
            f"{launches['pcg_solve']} K6 launches")
    dropped = sum(r["dropped"] for r in res["per_session"])
    require(dropped == 0, f"serving: {dropped} keyframes/factors dropped")
    st1, st2 = finals[runs - 1][0], finals[-1][0]
    require(bits_equal(torch.as_tensor(res["traj"]),
                       torch.as_tensor(res2["traj"]))
            and bits_equal(st1.graph.poses, st2.graph.poses)
            and bits_equal(tuple(st1.stats), tuple(st2.stats)),
            "serving: two invocations differ")
    per_w = {k: v / w for k, v in launches.items() if v}
    print(f"[smoke] serving entry point (serve {' '.join(SERVING_ARGS[2:])}, "
          f"{card}): aggregate_scans_per_s {res['aggregate_scans_per_s']:.1f}"
          f" (median of {len(res['run_s'])} runs "
          f"{', '.join(f'{t:.4f}' for t in res['run_s'])} s; first run "
          f"{res['first_run_s']:.3f} s), capacity {res['capacity']}, "
          f"{w // runs} windows per run, {first['smooths']} smoother calls "
          f"and {first['refreshes']} refreshes in {runs} runs; bit-equal "
          f"across two invocations; launches per window "
          + ", ".join(f"{k} {v:.2f}" for k, v in per_w.items()))
    return launches, res, st2


def serving_gates(res):
    """Per-session gates against the JAX package's run of the same 8
    sessions (``tests/data/torch_serving8_box300_ref.json``): ATE <=
    max(0.15 m, 2 x JAX's f32 ATE of that session); ATE below 0.75 x the
    session's dead reckoning wherever JAX's f32 run is (session 4 of this
    workload drifts to ~6.6 m in JAX, at f32 and f64: the gate cannot hold
    there for a faithful port, so it is reported, not applied); a loop
    wherever JAX closes one. Prints every session's ATE, loops and the JAX
    f32 and f64 ATEs beside it (f32 basins, ROADMAP C-w1b)."""
    ref = json.loads(REF_SERVING_FILE.read_text())["sessions"]
    require(len(ref) == len(res["per_session"]),
            "serving gates: session counts differ")
    rows = []
    for rec, r in zip(res["per_session"], ref):
        k, ate, loops = rec["session"], rec["ate_m"], rec["loops"]
        j32, j64, dr = r["jax_f32"], r["jax_f64"], r["dead_reckoning_ate_m"]
        limit = max(0.15, 2.0 * j32["ate_m"])
        dr_gate = j32["ate_m"] < 0.75 * dr
        print(f"[smoke] serving session {k}: ATE {ate:.4f} m (limit "
              f"{limit:.4f}; JAX f32 {j32['ate_m']:.4f}, f64 "
              f"{j64['ate_m']:.4f}), dead reckoning {dr:.4f} m ("
              + ("gate 0.75 x" if dr_gate else
                 "not gated: JAX's own run is above 0.75 x")
              + f"), loops {loops} (JAX f32 {j32['loops']}, f64 "
              f"{j64['loops']}), keyframes {rec['keyframes']} (JAX f32 "
              f"{j32['keyframes']})")
        require(ate <= limit, f"serving session {k}: ATE {ate:.4f} m over "
                f"{limit:.4f}")
        require(not dr_gate or ate < 0.75 * dr,
                f"serving session {k}: ATE {ate:.4f} m not below 0.75 x "
                f"dead reckoning {dr:.4f} m")
        require(loops > 0 or j32["loops"] == 0,
                f"serving session {k}: no loop where JAX closed "
                f"{j32['loops']}")
        rows.append(dict(session=k, ate_m=ate, loops=loops,
                         jax_f32_ate_m=j32["ate_m"],
                         jax_f64_ate_m=j64["ate_m"], dr_gated=dr_gate))
    return rows


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
    right-hand side (its factors masked off) stays at x = 0 with no NaN.
    Timed beside the 8 single-session K6 launches it replaces (tol = 0,
    the same iteration count)."""
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
        for g, lg, lam in singles:
            kernels.pcg_solve(g.bet_i, g.bet_j, g.bet_mask, g.prior_idx,
                              g.prior_mask, g.pose_mask, lg, None, lam, it,
                              0.0)

    single()
    torch.cuda.synchronize()
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
          f"session's max); bit-identical on a second launch; an idle "
          f"session stays at 0; kernel {ms:.4f} ms, plain {plain:.4f} ms, "
          f"{s} single K6 launches {single_ms:.4f} ms, bound "
          f"{bd['bound_ms']:.6f} ms ({bd['bound_by']})")
    row = dict(max_abs_err=err64, max_abs_err_f32_plain=err32, ms=ms,
               plain_ms=plain, single_launches_ms=single_ms, sessions=s,
               iterations=it, **bd)
    card_time(jobs, "K6b pcg_solve_blocked", row, "card_ms", run,
              ["pcg_solve"])
    card_time(jobs, f"{s} single K6 launches", row,
              "single_launches_card_ms", single, ["pcg_solve"])
    return row


def _k3s_case(label, stats8, pts, msk, wt, grid, jobs):
    """One K3s shape: bit-equal to S single K3 launches and on a second
    launch; event, card, single-launch and plain times; the bound."""
    import torch

    from ndtpu_torch import kernels
    from ndtpu_torch.dist.slam_dp import _take
    from ndtpu_torch.ndt import grid as ndt_grid

    s, m = msk.shape
    per_point = isinstance(wt, torch.Tensor)
    run = lambda: kernels.halfcell_add_stacked(stats8.n, stats8.s, stats8.ss,
                                               pts, msk, wt, grid)

    def single():
        return [kernels.halfcell_add(*_take(stats8, i), pts[i], msk[i],
                                     wt[i] if per_point else wt, grid)
                for i in range(s)]

    out, again = run(), run()
    ones = tuple(torch.stack(f) for f in zip(*single()))
    torch.cuda.synchronize()
    require(bits_equal(out, again), f"K3s {label}: two launches differ")
    require(bits_equal(out, ones),
            f"K3s {label}: not bit-equal to {s} single K3 launches")
    ms = time_ms(run)
    plain = time_ms(lambda: ndt_grid.halfcell_add_stacked_ref(
        stats8, pts, msk, wt, grid))
    single_ms = time_ms(single)
    one = k3_bound(m, grid)
    bd = bound(s * (m * 9 + 2 * 28 * 4 * grid.n_cells
                    + (4 * m if per_point else 0)),
               s * (10.0 * m + 140.0 * grid.n_cells))
    print(f"[smoke] K3s halfcell_add_stacked {label} S={s} x M={m}: "
          f"bit-equal to {s} single K3 launches and on a second launch; "
          f"kernel {ms:.4f} ms, {s} single K3 {single_ms:.4f} ms, plain "
          f"{plain:.4f} ms, bound {bd['bound_ms']:.6f} ms ({bd['bound_by']}; "
          f"one map's {one['bound_ms']:.6f})")
    row = dict(max_abs_err=0.0, ms=ms, plain_ms=plain,
               single_launches_ms=single_ms, m=m, **bd)
    card_time(jobs, f"K3s halfcell_add_stacked {label}", row, "card_ms", run,
              ["halfcell", "Memset"])
    card_time(jobs, f"{s} single K3 {label}", row, "single_launches_card_ms",
              single, ["halfcell", "Memset"])
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


def check_k4s(state8, cfg, jobs=None):
    """K4s on the serving run's 8 maps (57 x 57 lattice, 3,249 rows each):
    bit-equal to 8 single K4 launches and on a second launch; valid flags
    exact and the rest within K4's rtol 1e-5 of the plain twin; timed
    beside the single launches and the twin."""
    import torch

    from ndtpu_torch import kernels
    from ndtpu_torch.dist.slam_dp import _take
    from ndtpu_torch.ndt import grid as ndt_grid

    grid, stats8 = cfg.grid, state8.stats
    s = stats8.n.shape[0]
    run = lambda: kernels.finalize_pack_stacked(stats8.n, stats8.s,
                                                stats8.ss, cfg.ndt, grid)

    def single():
        return [kernels.finalize_pack(*_take(stats8, i), cfg.ndt, grid)
                for i in range(s)]

    out, again = run(), run()
    ones = torch.stack(single())
    ref = ndt_grid.finalize_pack_stacked_ref(stats8, cfg.ndt, grid)
    torch.cuda.synchronize()
    require(bits_equal(out, again), "K4s: two launches differ")
    require(bits_equal(out, ones), f"K4s: not bit-equal to {s} single K4 "
            f"launches")
    err = max(_table_check(f"K4s map {i}", out[i], ref[i]) for i in range(s))
    ms = time_ms(run)
    plain = time_ms(lambda: ndt_grid.finalize_pack_stacked_ref(
        stats8, cfg.ndt, grid))
    single_ms = time_ms(single)
    one = k4_bound(grid)
    rows = (2 * grid.nx + 1) * (2 * grid.ny + 1)
    bd = bound(s * (28 * 4 * grid.n_cells + rows * 128),
               s * 160.0 * grid.n_cells)
    print(f"[smoke] K4s finalize_pack_stacked S={s} x R={rows}: bit-equal to "
          f"{s} single K4 launches and on a second launch, vs the twin max "
          f"abs err {err:.3e} (valid exact, rtol 1e-5); kernel {ms:.4f} ms, "
          f"{s} single K4 {single_ms:.4f} ms, plain {plain:.4f} ms, bound "
          f"{bd['bound_ms']:.6f} ms ({bd['bound_by']}; one map's "
          f"{one['bound_ms']:.6f})")
    row = dict(max_abs_err=err, ms=ms, plain_ms=plain,
               single_launches_ms=single_ms, **bd)
    card_time(jobs, "K4s finalize_pack_stacked", row, "card_ms", run,
              ["finalize_pack_kernel"])
    card_time(jobs, f"{s} single K4", row, "single_launches_card_ms", single,
              ["finalize_pack_kernel"])
    return row



# --------------------------------------------------------------------------
# Config 5: the two-session merge (phase 12) and the distributed solve
# (phase 13).

#: f32 operations of K12 per masked beam (transform, phi-derivative,
#: offsets) and per (beam, grid) (binning 6, counted from
#: ``csrc/ndt_unpacked.cu``) and per (beam, grid) in a valid in-map cell
#: (the 71 of ``csrc/ndt_sums.cuh``'s ``ndt_add_terms``).
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
    flops = (b * live * (K12_BEAM_FLOPS + 4 * K12_BIN_FLOPS)
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
    print(f"[smoke] K12 ndt_sgh_unpacked {label} B={poses.shape[0]} "
          f"N={points.shape[0]} G=4 x {grid.n_cells} cells: vs f32 plain max "
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
    card_time(jobs, f"K12 ndt_sgh_unpacked {label}", row, "card_ms", run,
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


def check_k9c(graph, n_ranks: int, lam: float, jobs=None):
    """K9c ``schur_local_assemble`` on each rank's rows of ``graph`` split
    into ``n_ranks`` shards (phase 13's layout), against its plain version
    in f32 on the card and in f64 on the CPU (each part within rtol 1e-5 of
    its max |.|), bit-identical on a second launch; the plain segment sums'
    ``index_add_`` of the routed blocks (the library call, without the
    damping) timed beside it. Returns the row of the rank with the most
    interior slots (rank 0), with each rank's size and time."""
    import torch

    from ndtpu_torch.dist import schur

    plan = schur.plan_partition(
        graph.bet_i.cpu().numpy(), graph.bet_j.cpu().numpy(),
        graph.bet_mask.cpu().numpy(), graph.prior_idx.cpu().numpy(),
        graph.prior_mask.cpu().numpy(), graph.poses.shape[0], n_ranks)
    rows = []
    for rank in range(n_ranks):
        t = schur.rank_tables(plan, rank, graph.poses.device)
        t64 = schur.rank_tables(plan, rank, "cpu")
        loc = tuple(x[0] for x in schur.shard_factor_data_local(graph, plan,
                                                                rank))
        lin = schur._linearize_shard(graph.poses, *loc)
        masks = (loc[4], loc[8])
        run = lambda: schur.schur_local_assemble(t, lam, *lin, *masks)
        out, again = run(), run()
        ref = schur.schur_local_assemble_ref(t, lam, *lin, *masks)
        ref64 = schur.schur_local_assemble_ref(
            t64, lam, *_cpu64(lin), *(m.cpu() for m in masks))
        torch.cuda.synchronize()
        require(bits_equal(out, again), f"K9c rank {rank}: two launches "
                f"differ")
        err = _rel_check(f"K9c rank {rank} vs f32 plain", out, ref)
        err64 = _rel_check(f"K9c rank {rank} vs f64 plain", _cpu64(out),
                           ref64)
        ms = time_ms(run)
        plain = time_ms(lambda: schur.schur_local_assemble_ref(t, lam, *lin,
                                                               *masks))
        # The library call: the plain version's segment sums as one
        # index_add_ of the routed blocks into the three matrices, flat.
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
        lib = time_ms(lambda: torch.zeros(n_ii + n_is + n_ss,
                                          device=vv.device).index_add_(
            0, ids, vv))
        bd = k9c_bound(t, lin)
        print(f"[smoke] K9c schur_local_assemble rank {rank}/{n_ranks} "
              f"ni={ni} ns={ns} ({t.tgt_col.numel()} target blocks, "
              f"{t.code.numel()} pairs): vs f32 plain max abs err {err:.3e}, "
              f"vs f64 plain {err64:.3e} (rtol 1e-5 of each part's max); "
              f"bit-identical on a second launch; kernel {ms:.4f} ms, plain "
              f"{plain:.4f} ms, library (index_add_ of the routed blocks, no "
              f"damping) {lib:.4f} ms, bound {bd['bound_ms']:.6f} ms "
              f"({bd['bound_by']})")
        row = dict(max_abs_err=err, max_abs_err_f64=err64, ms=ms,
                   plain_ms=plain, ni=ni, ns=ns, **bd)
        row.update(library_ms=lib, library="torch.Tensor.index_add_ of the "
                   "routed 3x3 blocks into h_ii, h_is and h_ss (flat): the "
                   "same sums without the damping")
        card_time(jobs, f"K9c schur_local_assemble rank {rank}", row,
                  "card_ms", run, ["supernodal_assemble_kernel<true>"])
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


def run_merge(dev, card, npz_path, jobs, keep=None):
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
    perturbed merges solved in process (``optimize_supernodal``, 15
    iterations; K6 takes no 2,048-pose graph) with B's placement error at
    most max(0.15 m, 2 x JAX f32's), and below 0.6 x the anchor-only one
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
    (``stats``) into ``keep``, for phase 15."""
    import dataclasses

    import torch

    from ndtpu_torch import kernels
    from ndtpu_torch.config import MatchConfig, PipelineConfig, SolverConfig
    from ndtpu_torch.dist import launch
    from ndtpu_torch.graph import supernodal as sn
    from ndtpu_torch.lie import se2
    from ndtpu_torch.loop import closure
    from ndtpu_torch.ndt import grid as ndt_grid
    from ndtpu_torch.ndt import match
    from ndtpu_torch.slam import merge, pipeline

    ref = json.loads(REF5_FILE.read_text())
    j32 = ref["f32"]
    cfg = PipelineConfig.from_json(str(CONFIG5))
    seqs, t_true, _ = config5_sessions(dev)
    t_true = t_true.to(dev)
    t0 = time.perf_counter()
    sa, sb = (pipeline.run_slam_windowed(s.points, s.mask, s.odom, cfg)[0]
              for s in seqs)
    torch.cuda.synchronize()
    sessions_s = time.perf_counter() - t0
    map_a = ndt_grid.finalize(sa.stats, cfg.ndt)
    probe, probe_mask = sb.kf.points[0], sb.kf.masks[0]

    saved = closure.verify_candidates_cached_flat
    verifies = 0

    def counted(*a, **k):
        nonlocal verifies
        verifies += 1
        return saved(*a, **k)

    closure.verify_candidates_cached_flat = counted
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
        closure.verify_candidates_cached_flat = saved

    err = se2.between(transform, t_true.cpu())
    err_j = se2.between(transform, torch.tensor(j32["transform"]))
    require(bool(res.converged), "config 5: the alignment did not converge")
    for name, e in (("the truth", err), ("JAX f32's transform", err_j)):
        require(float(torch.hypot(e[0], e[1])) <= 0.1
                and abs(float(e[2])) <= 0.02,
                f"config 5: alignment {transform.tolist()} off {name} by "
                f"{e.tolist()} (0.1 m / 0.02 rad allowed)")
    require(launches["ndt_sgh_unpacked"] == 2 and launches["lm_ndt"] == 2
            == calls - verifies,
            f"config 5: {launches['ndt_sgh_unpacked']} K12 and "
            f"{launches['lm_ndt']} lm_ndt launches in the alignment (two "
            f"each expected: one per pass)")
    require(verifies == 1 and launches["loop_gate_fused"] == 1
            and launches["lm_ndt_grouped"] == 1
            and launches["loop_gate"] == 0,
            f"config 5: {launches['loop_gate_fused']} gated verifies for "
            f"{verifies} loop searches (one expected)")
    require(launches["halfcell_add"] == 1,
            f"config 5: {launches['halfcell_add']} K3 launches in "
            f"merged_map_stats (one expected)")
    require(n_loops >= 1 and n_loops >= 0.5 * j32["inter_loops"],
            f"config 5: {n_loops} inter-session loops, JAX f32 "
            f"{j32['inter_loops']} (at least half and one expected)")
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
            "config 5: merged_map_stats' counts differ from K3's plain "
            "version")
    # Both merges solved in process; B's placement.
    t1 = time.perf_counter()
    with no_plain_on_card(PLAIN_CONFIG5):
        errs = [b_placement_err(sn.optimize_supernodal(
            g, SolverConfig(max_iter=15)).graph.poses, sa, sb, t_true)
            for g in (g_anchor, g_auto)]
    torch.cuda.synchronize()
    stage["solves_s"] = time.perf_counter() - t1
    jax_ratio = (j32["b_placement_err_auto_m"]
                 < 0.6 * j32["b_placement_err_anchor_m"])
    require(errs[1] <= max(0.15, 2 * j32["b_placement_err_auto_m"])
            and (errs[1] < 0.6 * errs[0] or not jax_ratio),
            f"config 5: B placement error {errs[1]:.4f} m (auto) vs "
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
        launch.save_graph_npz(str(npz_path), g_dist)
        sol = sn.optimize_supernodal(g_dist, SolverConfig(max_iter=10))
    chi10 = float(sol.chi2)
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
        supernodal_chi2_10=chi10, supernodal_iters_10=int(sol.n_iter),
        **stage)
    print(f"[smoke] config 5 merge ({card}): sessions {sessions_s:.2f} s "
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
          f"f32 {j32['aligned_inter_loops']}): chi2 after 10 supernodal "
          f"iterations {chi10:.6e} (JAX f32 schur "
          f"{j32['schur_chi2_after']:.6e}); launches "
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
    return launches, summary, g_dist, chi10, dict(ndt_sgh_unpacked=row)


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
    cells = 4 * width * grid.ny
    return bound(9 * m + 28 * cells, 4 * m * 8 + live * K10A_POINT_FLOPS
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

    from ndtpu_torch.dist import gridmap

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
            f"K10a {label}: launches differ (again or permuted)")
    require(bits_equal(out, model),
            f"K10a {label}: differs from its fixed-point model")
    err = _rel_check(f"K10a {label} vs f32 plain", out, plain)
    ref64 = slab_f64(points, mask, grid, x_lo, width)
    err64 = slab_close(f"K10a {label} vs f64", out, *ref64, K10A_RTOL)
    ms = time_ms(run)
    plain_ms = time_ms(lambda: gridmap.slab_accumulate_ref(
        points, mask, grid, x_lo, width))
    _, lx, iy, live = gridmap._slab_cells(points, mask, grid, x_lo, width)
    w = live.float()
    lib = time_ms(lambda: gridmap._accum_local(points, w, lx, iy, width,
                                               grid))
    bd = k10a_bound(points.shape[0], int(live.sum()), width, grid)
    print(f"[smoke] K10a slab_accumulate {label} M={points.shape[0]} "
          f"({int(live.sum())} live (grid, point) pairs) into 4 x {width} x "
          f"{grid.ny} cells: bit-equal to its fixed-point model, on a second "
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
    card_time(jobs, f"K10a slab_accumulate {label}", row, "card_ms", run,
              ["slab_scatter", "slab_moments", "Memset"])
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


def check_k10b(label, stats, ndt_cfg, jobs=None):
    """K10b ``finalize_cells`` (``ndt.grid.finalize`` on CUDA tensors) on
    ``stats`` in their layout: valid flags equal to its f32 plain version's,
    mean and icov within rtol 1e-5 of each output's max, bit-identical on a
    second launch. Returns the row."""
    import torch

    from ndtpu_torch.ndt import grid as ndt_grid

    st = ndt_grid.NDTStats(*stats)
    run = lambda: ndt_grid.finalize(st, ndt_cfg)
    out, again = run(), run()
    ref = ndt_grid.finalize_ref(st, ndt_cfg)
    torch.cuda.synchronize()
    require(bits_equal(out, again), f"K10b {label}: two launches differ")
    require(torch.equal(out.valid, ref.valid),
            f"K10b {label}: valid flags differ from the plain version's")
    err = _rel_check(f"K10b {label} vs f32 plain", out, ref)
    same = bits_equal(out, ref)
    ms = time_ms(run)
    plain_ms = time_ms(lambda: ndt_grid.finalize_ref(st, ndt_cfg))
    cells = st.n.numel()
    bd = bound(56 * cells, K10B_CELL_FLOPS * cells)
    print(f"[smoke] K10b finalize_cells {label} {tuple(st.n.shape)} "
          f"({int(out.valid.sum())} valid): vs f32 plain max abs err "
          f"{err:.3e}{' (bit-equal)' if same else ''}, valid exact; "
          f"bit-identical on a second launch; kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bound {bd['bound_ms']:.6f} ms "
          f"({bd['bound_by']})")
    row = dict(max_abs_err=err, bit_equal_to_plain=same, ms=ms,
               plain_ms=plain_ms, **bd)
    card_time(jobs, f"K10b finalize_cells {label}", row, "card_ms", run,
              ["finalize_cells"])
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
    flops = (b * int(mask.sum()) * (K12_BEAM_FLOPS + 4 * K12_BIN_FLOPS)
             + int((hit & v).sum()) * K12_CELL_FLOPS)
    return bound(b * 12 + n * 12 + n_cells * 28 + b * 60, flops)


def check_k10c(label, poses, points, mask, slab_map, grid, x_lo: int, mcfg,
               jobs=None):
    """K10c ``slab_sgh`` against its f32 plain version on the card (each
    output within rtol 1e-5 of its max |.|: the same cells, the sums in
    another order), bit-identical on a second launch. Returns the row."""
    import torch

    from ndtpu_torch.dist import gridmap

    mask_f = mask.float()
    run = lambda: gridmap.slab_sgh(poses, points, mask_f, slab_map, grid,
                                   x_lo, mcfg)
    out, again = run(), run()
    ref = gridmap.slab_sgh_ref(poses, points, mask_f, slab_map, grid, x_lo,
                               mcfg)
    torch.cuda.synchronize()
    require(bits_equal(out, again), f"K10c {label}: two launches differ")
    err = _rel_check(f"K10c {label} vs f32 plain",
                     [out[:, :3], out[:, 3:6], out[:, 6:]],
                     [ref[:, :3], ref[:, 3:6], ref[:, 6:]])
    ms = time_ms(run)
    plain_ms = time_ms(lambda: gridmap.slab_sgh_ref(
        poses, points, mask_f, slab_map, grid, x_lo, mcfg))
    bd = k10c_bound(poses, points, mask, slab_map, grid, x_lo)
    print(f"[smoke] K10c slab_sgh {label} B={poses.shape[0]} "
          f"N={points.shape[0]} on 4 x {slab_map.valid.shape[1]} x {grid.ny} "
          f"cells: vs f32 plain max abs err {err:.3e} (rtol 1e-5 of each "
          f"output's max); bit-identical on a second launch; kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
          f"{bd['bound_ms']:.6f} ms ({bd['bound_by']})")
    row = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, **bd)
    card_time(jobs, f"K10c slab_sgh {label}", row, "card_ms", run,
              ["slab_sgh"])
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
    rank; A on rank 0, B on rank 1), builds the merged map's slab from its
    own session's live keyframe points (B's moved by ``t_ab``) with
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
    cfg = PipelineConfig.from_json(str(CONFIG5))
    bmesh, smesh = dmesh.batch_mesh(device), dmesh.space_mesh(device)
    dev = bmesh.device
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    z = np.load(npz)
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
        st, _ = stage("sessions", lambda: slam_dp.run_sessions_sharded(
            bmesh, [t("points_a"), t("points_b")], [t("mask_a"), t("mask_b")],
            [t("odom_a"), t("odom_b")], cfg))
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


def run_slab(dev, card, keep, seed: int, jobs):
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
    ``(launches, record, kernel rows)``."""
    import numpy as np
    import torch

    from ndtpu_torch import kernels
    from ndtpu_torch.config import PipelineConfig
    from ndtpu_torch.dist import gridmap
    from ndtpu_torch.ndt import grid as ndt_grid
    from ndtpu_torch.ndt import match as ndt_match

    cfg = PipelineConfig.from_json(str(CONFIG5))
    grid = cfg.grid
    inputs = slab_inputs(dev, seed, keep, cfg)
    kf_b = keep["sb"].kf
    inputs.update(kf_points_b=kf_b.points.cpu().numpy(),
                  kf_masks_b=kf_b.masks.cpu().numpy())
    with tempfile.TemporaryDirectory(prefix="ndtpu_smoke_slab_") as tmp:
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
            require(p.returncode == 0, f"slab worker {p.args[3]} failed "
                    f"rc={p.returncode}\n{so[-2000:]}\n{se[-4000:]}")
        ranks = [dict(np.load(f"{out}.{r}.npz")) for r in range(2)]
    halo, nxl = int(inputs["halo"]), grid.nx // 2
    # Sessions: bit-equal to phase 12's.
    for r, k in enumerate("ab"):
        require(str(ranks[r]["digest"]) == inputs[f"digest_{k}"],
                f"config 5 slab: rank {r}'s session {k.upper()} differs from "
                f"phase 12's in-process run")
    # The map: the two builds, the merged statistics, f64.
    gather = lambda key: torch.cat([torch.as_tensor(x[key]) for x in ranks],
                                   1)
    ps = gridmap.SlabStats(*(gather(f"ps_{k}") for k in ("n", "s", "ss")))
    rep = gridmap.SlabStats(*(gather(f"rep_{k}") for k in ("n", "s", "ss")))
    all_pts = torch.as_tensor(inputs["all_pts"]).to(dev)
    all_msk = torch.as_tensor(inputs["all_msk"]).to(dev)
    ref64, mag64 = slab_f64(all_pts, all_msk, grid, 0, grid.nx)
    build_err = slab_close("config 5 slab: point-sharded vs replicated", ps,
                           gridmap.SlabStats(*(x.double() for x in rep)),
                           mag64, SLAB_RTOL)
    k3 = gridmap.dense_to_slab(ndt_grid.NDTStats(*(torch.as_tensor(
        inputs[f"stats_{k}"]) for k in ("n", "s", "ss"))), grid)
    require(torch.equal(ps.n, k3.n) and torch.equal(rep.n, k3.n),
            "config 5 slab: counts differ from phase 12's merged map (K3)")
    err64 = slab_close("config 5 slab: point-sharded vs f64", ps, ref64,
                       mag64, SLAB_RTOL)
    err64_rep = slab_close("config 5 slab: replicated vs f64", rep, ref64,
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
            "config 5 slab: valid flags differ from the merged map's")
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
                    f"config 5 slab: {pre}_{key} differs between the ranks")
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
            f"config 5 slab: match_slab off the in-process lm_loop by "
            f"{slab_err:.3e} (> {SLAB_POSE_TOL:g})")
    rep_err = float((torch.as_tensor(ranks[0]["slab_rep_pose"])
                     - ref_k3).abs().max())
    require(rep_err <= SLAB_POSE_TOL,
            f"config 5 slab: match_slab on the replicated build's map off "
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
                    .tobytes(), f"config 5 slab: rank {r}'s {key} differs "
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
            n_sgh = per_stage[stage][r].get("slab_sgh", 0)
            n_sum = json.loads(str(x[f"{stage}_collectives"]))["all_reduce"]
            require(n_sgh == n_it + SLAB_SCANS == n_sum,
                    f"config 5 slab: {stage} on rank {r}: {n_sgh} K10c "
                    f"launches and {n_sum} sums for {n_it} iterations of "
                    f"{SLAB_SCANS} registrations (one each per evaluation)")
    iters = int(ranks[0]["slab_iter"].sum())
    colls = [json.loads(str(x["match_slab_collectives"])) for x in ranks]
    exch = [json.loads(str(x["psharded_collectives"])) for x in ranks]
    record = dict(
        halo=halo, nx_local=nxl, points=int(inputs["all_msk"].sum()),
        sessions_s=[float(x["sessions_s"]) for x in ranks],
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
    print(f"[smoke] config 5 slab ({card}): 2 ranks, 4 x {nxl} x {grid.ny} "
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
    print(f"[smoke] config 5 slab vs phase 12's K3 map: "
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
    na = keep["sa"].kf.masks.numel()      # A's points lead all_pts
    rows = {"slab_accumulate": check_k10a(
        "rank 0 halo-extended", all_pts[:na].contiguous(),
        all_msk[:na].contiguous(), grid, -halo, nxl + 2 * halo, jobs)}
    rows["slab_accumulate"]["replicated"] = check_k10a(
        "rank 1 replicated", all_pts, all_msk, grid, nxl, nxl, jobs)
    st0 = tuple(torch.as_tensor(ranks[0][f"ps_{k}"]).to(dev)
                for k in ("n", "s", "ss"))
    rows["finalize_cells"] = check_k10b("rank 0 slab", st0, cfg.ndt, jobs)
    rows["finalize_cells"]["dense"] = check_k10b(
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
            rows["slab_sgh"] = row
        else:
            rows["slab_sgh"]["rank1"] = row
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
            and REF_SERVING_FILE.is_file() and REF5_FILE.is_file(),
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
    check_k1(cfg, seq, table, args.seed, dev, 512, jobs)
    check_k3(cfg, seq, stats, args.seed, dev, 1024)
    cfg3 = PipelineConfig.from_json(str(CONFIG3))
    results = {**lm_rows,
               "ndt_terms": check_k1(cfg, seq, table, args.seed, dev, w,
                                     jobs),
               "halfcell_add": check_k3(cfg, seq, stats, args.seed, dev, w),
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
                                        cfg3.window)
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
    results["supernodal_assemble"], k9a_out = check_k9a(c4, jobs)
    results["schur_reduce"] = check_k9b(c4, k9a_out, jobs)
    del k9a_out
    step4 = check_supernodal_step(c4)
    ba_split = ba_step_timing(c4, card, jobs)

    launches2, counts2 = run_entry_point(dev, CONFIG2, 300)
    ate_gate(dev, CONFIG2, REF_FILE)
    launches3, counts3 = run_entry_point(dev, CONFIG3, 600)
    ate_gate(dev, CONFIG3, REF3_FILE)
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
    # Stacked serving through its entry point, then K6b, K3s and K4s on the
    # state its last run left (8 sessions' graphs, maps and keyframes).
    check_padded_sessions(dev)
    launches8, served, state8 = run_serving(dev, card)
    serving = dict(aggregate_scans_per_s=served["aggregate_scans_per_s"],
                   run_s=served["run_s"], first_run_s=served["first_run_s"],
                   sessions=serving_gates(served))
    from ndtpu_torch.dist import slam_dp

    cfg8 = slam_dp.serving_config(PipelineConfig.from_json(str(SERVING)))
    results["pcg_solve_blocked"] = check_k6b(state8, cfg8, args.seed, jobs)
    results["halfcell_add_stacked"] = check_k3s(state8, cfg8, jobs)
    results["finalize_pack_stacked"] = check_k4s(state8, cfg8, jobs)
    del state8
    # Config 5: the merge in process (phase 12), then the distributed solve
    # of its merged graph in two ranks (phase 13), and K9c on their rows.
    keep = {}
    with tempfile.TemporaryDirectory(prefix="ndtpu_smoke_") as tmp:
        npz = Path(tmp) / "config5_merged.npz"
        launches5, merge5, g5, chi10, rows5 = run_merge(dev, card, npz, jobs,
                                                        keep)
        results.update(rows5)
        launches5d, dist5 = run_distributed(dev, card, npz, chi10)
    results["schur_local_assemble"] = check_k9c(g5, 2, 1e-3, jobs)
    del g5
    # The reference's multi-process SLAM rehearsal through ``launch --task
    # slam`` (phase 14), then config 5's slab-sharded map, sessions and
    # registrations across two ranks (phase 15) and K10a-c at its shapes.
    launches14, slam14 = run_slam_launch(dev, card)
    launches15, slab15, rows15 = run_slab(dev, card, keep, args.seed, jobs)
    results.update(rows15)
    del keep
    paths = {"config2": launches2, "config3": launches3, "config4": launches4,
             "serving": launches8, "config5": launches5,
             "config5_dist": launches5d, "slam_launch": launches14,
             "config5_slab": launches15}
    for k in KERNELS:
        for path in k.get("paths", ()):  # K1, K8b run inside lm_ndt there
            require(paths[path][k["name"]] > 0,
                    f"{k['name']}: the {path} path launched it no time")
    launches = {k: sum(p[k] for p in paths.values()) for k in launches2}
    read_card_times(jobs)
    finish_split(ba_split)
    del kf, jobs

    rows = [dict(name=k["name"], route="cuda", source=k["source"],
                 replaces=k["replaces"], launches=launches[k["name"]],
                 **results[k["name"]],
                 **({"runs_inside": k["inside"]} if "inside" in k else {}))
            for k in KERNELS]
    print(f"[smoke] all phases passed in "
          f"{time.perf_counter() - t_start:.1f} s")
    smoother = {"takes_checked": takes,
                "config2": counts2, "config3": counts3}
    config4.update(step=step4, ba_solve_ms_per_iter_10k=ba_split)
    print(json.dumps({"kernels": rows, "repeat_runs": repeats,
                      "smoother": smoother, "config4": config4,
                      "serving": serving,
                      "config5": {"merge": merge5, "distributed": dist5,
                                  "slam_launch": slam14, "slab": slab15}}))
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
