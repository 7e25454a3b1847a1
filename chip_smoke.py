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
   ``--seed``, with medians of 20 synchronized runs of kernel and twin:
   K1 ``ndt_terms`` (512 lanes, then the window's 8 lanes, x 360 beams
   against a config-2 table built from a 300-scan map), K3
   ``halfcell_add`` (1,024, then 8, scans of 360 points, against the twin in
   f64 on the CPU, all-+1 and mixed +-1 weights), K4 ``finalize_pack`` (the
   config-2 grid); then on config 3's shapes K8a ``local_tables`` (256, then
   the window's 8, keyframes), K1 grouped (64 verify lanes x 360 beams
   against a 1,024-slot table cache, random tables) and K8b ``loop_gate``
   (a real 4 x 16 verification at the end of the box-world lap);
4. config 2 through its entry point: ``ndtpu_torch.run.main`` on
   ``configs/config2_full_sequence.json``, 300 scans, ``--device cuda``,
   with every launch counter reset just before and read just after;
5. the config-2 ATE gate: box-world draws 0-2 through
   ``run_slam_windowed``, against the JAX reference's ATE on the same
   sequences (``tests/data/torch_config2_box300_ref.json``) and dead
   reckoning;
6. config 3 (loop closure) through the entry point, 600 scans (the
   corridor's 120 m lap takes 480), counters reset and read as in phase 4;
7. the config-3 ATE gate against ``tests/data/torch_config3_box300_ref.json``
   (also: the port closes a loop on every draw where JAX does);
8. every kernel launched in its entry-point phase (K1, K3, K4 in phase 4;
   all six in phase 6).

The second-to-last line is one JSON object with the kernels' launches
(phases 4 and 6 together), errors and times; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CONFIG2 = ROOT / "configs" / "config2_full_sequence.json"
CONFIG3 = ROOT / "configs" / "config3_loop_closure.json"
REF_FILE = ROOT / "tests" / "data" / "torch_config2_box300_ref.json"
REF3_FILE = ROOT / "tests" / "data" / "torch_config3_box300_ref.json"

#: The box-world scenario of bench.py's end-to-end section.
BOX = dict(half=11.0, n_scans=300, traj_half=7.0, step=0.2, max_range=20.0,
           min_range=0.1, odom_trans_std=0.04, odom_rot_std=0.01)

_CSRC = "ndtpu_torch/kernels/csrc/"
KERNELS = [
    dict(name="ndt_terms", source=_CSRC + "ndt_terms.cu",
         replaces="ndtpu/ndt/match.py:237", config2=True),
    dict(name="ndt_terms_grouped", source=_CSRC + "ndt_terms.cu",
         replaces="ndtpu/ndt/grid.py:450", config2=False),
    dict(name="halfcell_add", source=_CSRC + "halfcell_add.cu",
         replaces="ndtpu/ndt/grid.py:161", config2=True),
    dict(name="finalize_pack", source=_CSRC + "finalize_pack.cu",
         replaces="ndtpu/ndt/grid.py:232", config2=True),
    dict(name="local_tables", source=_CSRC + "local_tables.cu",
         replaces="ndtpu/loop/closure.py:84", config2=False),
    dict(name="loop_gate", source=_CSRC + "loop_gate.cu",
         replaces="ndtpu/loop/closure.py:171", config2=False),
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


def check_k1(cfg, seq, table, seed, dev, b):
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
    print(f"[smoke] K1 ndt_terms B={b} N={seq.points.shape[1]}: max abs err "
          f"{float(err.max()):.3e}, max rel err {rel:.3e} (tol 1e-3 x "
          f"max(1,|ref|)); kernel {ms:.4f} ms, plain {plain:.4f} ms")
    return dict(max_abs_err=float(err.max()), ms=ms, plain_ms=plain)


def _k3_case(cfg, base, pts, msk, weight, exact_counts):
    import torch

    from ndtpu_torch import kernels
    from ndtpu_torch.ndt import grid as ndt_grid

    grid = cfg.grid
    out = ndt_grid.halfcell_add(base, pts, msk, weight, grid)
    torch.cuda.synchronize()
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
    worst, max_err = 0.0, 0.0
    for k, (o, rf, b) in enumerate(zip(out, ref, base)):
        scale = n_abs.reshape(n_abs.shape + (1,) * (rf.dim() - 2)) * r ** k
        mag = cpu(b).abs() + scale
        err = (cpu(o) - rf).abs()
        max_err = max(max_err, float(err.max()))
        worst = max(worst, float((err / (1e-5 * mag + 1e-30)).max()))
    if exact_counts:
        require(bool((cpu(out.n) == ref.n).all()), "K3: counts not exact")
    require(worst <= 1.0, f"K3: moments off by {worst:.3g} x tolerance")
    args = (base, pts, msk, weight, grid)
    ms = time_ms(lambda: kernels.halfcell_add(
        base.n, base.s, base.ss, pts, msk, weight, grid))
    plain = time_ms(lambda: ndt_grid.halfcell_add_ref(*args))
    return max_err, worst, ms, plain


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
    e1, w1, ms1, pl1 = _k3_case(cfg, base, pts, msk, 1.0, True)
    sign = np.where(rng.random(pts.shape[0]) < 0.5, -1.0, 1.0)
    wts = torch.as_tensor(sign, dtype=torch.float32, device=dev)
    e2, w2, ms2, pl2 = _k3_case(cfg, base, pts, msk, wts, False)
    print(f"[smoke] K3 halfcell_add M={pts.shape[0]}: +1 weights max abs err "
          f"{e1:.3e} ({w1:.3f} x tol, counts exact), +-1 weights max abs err "
          f"{e2:.3e} ({w2:.3f} x tol; tol 1e-5 x per-cell magnitude); "
          f"kernel {ms1:.4f} / {ms2:.4f} ms, plain {pl1:.4f} / {pl2:.4f} ms")
    return dict(max_abs_err=max(e1, e2), ms=ms1, plain_ms=pl1)


def check_k4(cfg, stats):
    """K4 vs finalize_pack_ref on the card, config-2 grid."""
    import torch

    from ndtpu_torch import kernels
    from ndtpu_torch.ndt import grid as ndt_grid

    out = kernels.finalize_pack(stats.n, stats.s, stats.ss, cfg.ndt, cfg.grid)
    ref = ndt_grid.finalize_pack_ref(stats, cfg.ndt, cfg.grid)
    torch.cuda.synchronize()
    err = _table_check("K4", out, ref)
    ms = time_ms(lambda: kernels.finalize_pack(stats.n, stats.s, stats.ss,
                                               cfg.ndt, cfg.grid))
    plain = time_ms(lambda: ndt_grid.finalize_pack_ref(stats, cfg.ndt,
                                                       cfg.grid))
    print(f"[smoke] K4 finalize_pack R={out.shape[0]}: valid exact, max abs "
          f"err {err:.3e} (rtol 1e-5); kernel {ms:.4f} ms, plain "
          f"{plain:.4f} ms")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain)


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
    cancellation in ss/n - mean^2 on thin wall cells bounds it)."""
    import numpy as np
    import torch

    from ndtpu_torch import kernels
    from ndtpu_torch.loop import closure

    rng = np.random.default_rng(seed + 4)
    lane = torch.as_tensor(rng.integers(0, seq.points.shape[0], w))
    slots = torch.as_tensor(rng.permutation(w))
    ok = torch.ones(w, dtype=torch.bool)
    shape = (w,) + closure.local_table_shape(cfg3.loop, False)
    msk = seq.mask[lane]
    lgrid = closure.local_grid_config(cfg3.loop)

    def kernel(pts):
        return kernels.local_tables(
            torch.zeros(shape, dtype=torch.float32, device=dev),
            slots.to(dev, torch.int32), ok.to(dev), pts, msk.to(dev), lgrid,
            cfg3.ndt)

    p4 = snap(seq.points[lane], 4).to(dev).contiguous()
    twin = lambda: closure.write_local_tables_ref(
        torch.zeros(shape, dtype=torch.float32, device=dev), slots.to(dev),
        ok.to(dev), p4, msk.to(dev), cfg3.loop, cfg3.ndt)
    out, ref = kernel(p4), twin()
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
    print(f"[smoke] K8a local_tables W={w} N={seq.points.shape[1]} "
          f"({shape[1]} rows, {shape[1] * 24} B of shared memory): vs f32 "
          f"twin (2^-4 m points) max abs err "
          f"{err4:.3e} (K4 rtol 1e-5), valid exact; vs f64 twin (2^-16 m) "
          f"valid exact, means within rtol 1e-5, icov max err "
          f"{float(ierr.max()):.3e} = {irel:.3e} of its max; kernel "
          f"{ms:.4f} ms, plain {plain:.4f} ms")
    return dict(max_abs_err=err4, ms=ms, plain_ms=plain)


def check_k1_grouped(cfg3, seq, kf, seed, dev, b):
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
    print(f"[smoke] K1 ndt_terms grouped B={b} N={seq.points.shape[1]} "
          f"S={kf.capacity}: max abs err {float(err.max()):.3e} (tol 1e-3 x "
          f"max(1,|ref|)), {hit:.2f} of lanes see valid cells; kernel "
          f"{ms:.4f} ms, plain {plain:.4f} ms")
    return dict(max_abs_err=float(err.max()), ms=ms, plain_ms=plain)


def check_k8b(cfg3, seq, kf, seed, dev):
    """K8b vs ``_gate_and_pack`` (f64, CPU) on a real verification: 4
    queries at the end of the box-world lap x 16 candidates. Lanes within
    1e-4 of the score gate or of the innovation budget are masked out, so
    the flags can be held exact."""
    import numpy as np
    import torch

    from ndtpu_torch.loop import closure
    from ndtpu_torch.ndt.match import MatchResult

    loop = cfg3.loop
    rng = np.random.default_rng(seed + 3)
    q = torch.tensor([284, 288, 292, 296])
    qpose = (seq.gt_poses[q].double() + torch.as_tensor(
        rng.normal(0.0, [0.1, 0.1, 0.02], (4, 3)))).float().to(dev)
    qidx = q.to(dev)
    cands = closure.find_candidates(kf, qpose, qidx, loop)
    res, init = closure.verify_registrations(
        kf, seq.points[q].to(dev), seq.mask[q].to(dev), qpose, cands, loop,
        cfg3.match)
    r64 = MatchResult(*(a.cpu().double() if a.is_floating_point()
                        else a.cpu() for a in res))
    i64 = init.cpu().double()
    innov = torch.linalg.norm(r64.pose[..., :2] - i64[..., :2], dim=-1)
    budget = (loop.max_innovation_base + loop.max_innovation_per_kf
              * (q[:, None] - cands.idx.cpu()).abs().double())
    clear = (((r64.score - loop.score_gate).abs() >= 1e-4)
             & ((innov - budget).abs() >= 1e-4))
    cands = cands._replace(mask=cands.mask & clear.to(dev))
    c_cpu = closure.LoopCandidates(*(a.cpu() for a in cands))
    out = closure.gate_and_pack(res, cands, loop, init, qidx)
    ref = closure._gate_and_pack(r64, c_cpu, loop, i64, q)
    torch.cuda.synchronize()
    require(bool((out.accept.cpu() == ref.accept).all()),
            "K8b: accept flags differ")
    require(bool((out.innov_rej.cpu() == ref.innov_rej).all()),
            "K8b: innovation flags differ")
    require(bool(ref.accept.any()), "K8b: no lane accepted; weak check")
    err = (out.sqrt_info.cpu().double() - ref.sqrt_info).abs()
    lane_max = ref.sqrt_info.abs().amax((-2, -1), keepdim=True)
    require(bool((err <= 1e-4 * lane_max).all()),
            f"K8b: sqrt_info off by "
            f"{float((err / (1e-4 * lane_max)).max()):.3g} x tol")
    ms = time_ms(lambda: closure.gate_and_pack(res, cands, loop, init, qidx))
    plain = time_ms(lambda: closure._gate_and_pack(res, cands, loop, init,
                                                   qidx))
    print(f"[smoke] K8b loop_gate K=4 C={loop.max_candidates}: "
          f"{int(cands.mask.sum())} live lanes ({int((~clear).sum())} "
          f"masked near a gate), {int(ref.accept.sum())} accepted, "
          f"{int((r64.converged & cands.mask.cpu()).sum())} converged; flags "
          f"exact, sqrt_info max abs err {float(err.max()):.3e} (tol 1e-4 x "
          f"lane max); kernel {ms:.4f} ms, plain {plain:.4f} ms")
    return dict(max_abs_err=float(err.max()), ms=ms, plain_ms=plain)


def run_entry_point(dev, config, n_scans: int):
    """The CLI main path on ``config``, with fresh launch counters."""
    import numpy as np

    from ndtpu_torch import kernels, run

    kernels.reset_launches()
    res = run.main(["--config", str(config), "--max-scans", str(n_scans),
                    "--device", str(dev)])
    launches = dict(kernels.LAUNCHES)
    traj = res["traj"]
    require(traj.shape == (n_scans, 3) and bool(np.isfinite(traj).all()),
            "entry point: trajectory not finite or of the wrong shape")
    require(res["n_keyframes"] > 0, "entry point: no keyframes")
    print(f"[smoke] entry point {config.name}: {n_scans} scans, "
          f"{res['scans_per_s']:.1f} scans/s ({res['seconds']:.2f} s), "
          f"keyframes={res['n_keyframes']}, loops={res['n_loops']}, ATE "
          f"{res['ate']:.4f} m, launches {launches}")
    return launches


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


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    t_start = time.perf_counter()

    require((ROOT / "ndtpu_torch").is_dir() and REF_FILE.is_file()
            and REF3_FILE.is_file(),
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
    check_k1(cfg, seq, table, args.seed, dev, 512)
    check_k3(cfg, seq, stats, args.seed, dev, 1024)
    results = {"ndt_terms": check_k1(cfg, seq, table, args.seed, dev, w),
               "halfcell_add": check_k3(cfg, seq, stats, args.seed, dev, w),
               "finalize_pack": check_k4(cfg, stats)}

    # Config 3's kernels: K8a at 256 keyframes, then at one window; K1
    # grouped and K8b at the verify shape (max_detect_per_window x
    # max_candidates lanes) against a full 1,024-slot table cache.
    cfg3 = PipelineConfig.from_json(str(CONFIG3))
    kf = box_store(cfg3, seq, dev)
    check_k8a(cfg3, seq, args.seed, dev, 256)
    results["local_tables"] = check_k8a(cfg3, seq, args.seed, dev,
                                        cfg3.window)
    results["ndt_terms_grouped"] = check_k1_grouped(
        cfg3, seq, kf, args.seed, dev,
        cfg3.loop.max_detect_per_window * cfg3.loop.max_candidates)
    results["loop_gate"] = check_k8b(cfg3, seq, kf, args.seed, dev)
    del kf

    launches2 = run_entry_point(dev, CONFIG2, 300)
    ate_gate(dev, CONFIG2, REF_FILE)
    launches3 = run_entry_point(dev, CONFIG3, 600)
    ate_gate(dev, CONFIG3, REF3_FILE)
    for k in KERNELS:
        require(not k["config2"] or launches2[k["name"]] > 0,
                f"{k['name']}: the config-2 path launched it no time")
        require(launches3[k["name"]] > 0,
                f"{k['name']}: the config-3 path launched it no time")
    launches = {k: launches2[k] + launches3[k] for k in launches2}

    rows = [dict(name=k["name"], route="cuda", source=k["source"],
                 replaces=k["replaces"], launches=launches[k["name"]],
                 **results[k["name"]]) for k in KERNELS]
    print(f"[smoke] all phases passed in "
          f"{time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
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
