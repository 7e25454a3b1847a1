#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on the card.

Run from the root of a checkout, on a machine with one CUDA card::

    python3 chip_smoke.py [--seed 0]

Phases (any failure exits non-zero, and no result line is printed):

1. the card: ``torch.cuda.is_available()``, then its name and power limit
   as ``nvidia-smi`` reports them;
2. the build of the CUDA kernels from ``ndtpu_torch/kernels/csrc`` (seconds
   and the compiler's register report);
3. each kernel against its plain twin at real size, on inputs made from
   ``--seed``: K1 ``ndt_terms`` (512 lanes, then the window's 8 lanes, x 360
   beams against a config-2 table built from a 300-scan map), K3
   ``halfcell_add`` (1,024, then 8, scans of 360 points, against the twin in
   f64 on the CPU, all-+1 and mixed +-1 weights) and K4 ``finalize_pack``
   (the config-2 grid); medians of 20 synchronized runs of kernel and twin;
4. the slice through its entry point: ``ndtpu_torch.run.main`` on
   ``configs/config2_full_sequence.json``, 300 scans, ``--device cuda``,
   with every launch counter reset just before and read just after;
5. the ATE gate: box-world draws 0-2 through ``run_slam_windowed`` at the
   config-2 width, against the JAX reference's ATE on the same sequences
   (``tests/data/torch_config2_box300_ref.json``) and dead reckoning;
6. every kernel of the path launched in phase 4.

The second-to-last line is one JSON object with the kernels' launches,
errors and times; the last line is ``{"ok": true, "device": {...}}``.
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
REF_FILE = ROOT / "tests" / "data" / "torch_config2_box300_ref.json"

#: The box-world scenario of bench.py's end-to-end section.
BOX = dict(half=11.0, n_scans=300, traj_half=7.0, step=0.2, max_range=20.0,
           min_range=0.1, odom_trans_std=0.04, odom_rot_std=0.01)

KERNELS = [
    dict(name="ndt_terms", source="ndtpu_torch/kernels/csrc/ndt_terms.cu",
         replaces="ndtpu/ndt/match.py:237"),
    dict(name="halfcell_add", source="ndtpu_torch/kernels/csrc/halfcell_add.cu",
         replaces="ndtpu/ndt/grid.py:161"),
    dict(name="finalize_pack",
         source="ndtpu_torch/kernels/csrc/finalize_pack.cu",
         replaces="ndtpu/ndt/grid.py:232"),
]


class SmokeFailure(RuntimeError):
    pass


def require(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def box_sequence(seed: int, n_beams: int, device="cpu"):
    """Draw ``seed`` of the box-world scenario (port synth)."""
    from ndtpu_torch.data import synth

    world = synth.box_world(BOX["half"])
    traj = synth.rectangle_trajectory(BOX["n_scans"], half=BOX["traj_half"],
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
    pts = (torch.round(pts * 65536.0) / 65536.0).contiguous()
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
    require(bool(torch.isfinite(out).all()), "K4: non-finite table")
    valid_cols = [8 * g + 5 for g in range(4)]
    require(bool((out[:, valid_cols] == ref[:, valid_cols]).all()),
            "K4: valid flags differ")
    err = (out - ref).abs()
    lane_max = ref.abs().amax(0, keepdim=True)
    tol = 1e-5 * torch.maximum(ref.abs(), 1e-3 * lane_max)
    require(bool((err <= tol).all()),
            f"K4: table off by {float((err / (tol + 1e-30)).max()):.3g} x tol")
    ms = time_ms(lambda: kernels.finalize_pack(stats.n, stats.s, stats.ss,
                                               cfg.ndt, cfg.grid))
    plain = time_ms(lambda: ndt_grid.finalize_pack_ref(stats, cfg.ndt,
                                                       cfg.grid))
    print(f"[smoke] K4 finalize_pack R={out.shape[0]}: valid exact, max abs "
          f"err {float(err.max()):.3e} (rtol 1e-5); kernel {ms:.4f} ms, "
          f"plain {plain:.4f} ms")
    return dict(max_abs_err=float(err.max()), ms=ms, plain_ms=plain)


def run_entry_point(dev):
    """Phase 4: the CLI main path, with fresh launch counters."""
    import numpy as np

    from ndtpu_torch import kernels, run

    kernels.reset_launches()
    res = run.main(["--config", str(CONFIG2), "--max-scans", "300",
                    "--device", str(dev)])
    launches = dict(kernels.LAUNCHES)
    traj = res["traj"]
    require(traj.shape == (300, 3) and bool(np.isfinite(traj).all()),
            "entry point: trajectory not finite or of the wrong shape")
    require(res["n_keyframes"] > 0, "entry point: no keyframes")
    print(f"[smoke] entry point: 300 scans, {res['scans_per_s']:.1f} scans/s "
          f"({res['seconds']:.2f} s), keyframes={res['n_keyframes']}, "
          f"ATE {res['ate']:.4f} m, launches {launches}")
    return launches


def ate_gate(dev):
    """Phase 5: box-world draws 0-2 at config-2 width vs the JAX reference."""
    import torch

    from ndtpu_torch.config import PipelineConfig
    from ndtpu_torch.eval.ate import ate_rmse
    from ndtpu_torch.slam import pipeline

    ref = json.loads(REF_FILE.read_text())
    cfg = PipelineConfig.from_json(str(CONFIG2))
    ates, jax_ates = [], []
    for draw in ref["draws"]:
        seq = box_sequence(draw["seed"], cfg.n_beams)
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
        print(f"[smoke] ATE gate draw {draw['seed']}: "
              f"{(p.shape[0] - 1) / dt:.1f} scans/s, ATE {ate:.4f} m, JAX "
              f"ATE {draw['jax_ate_m']:.4f} m, dead reckoning {dr:.4f} m "
              f"(reference {draw['dead_reckoning_ate_m']:.4f} m), inputs "
              f"{'match' if same else 'DIFFER FROM'} the reference hashes")
        require(ate < 0.75 * draw["dead_reckoning_ate_m"],
                f"ATE gate: draw {draw['seed']} ATE {ate:.4f} m is not below "
                f"0.75 x dead reckoning {draw['dead_reckoning_ate_m']:.4f} m")
        ates.append(ate)
        jax_ates.append(draw["jax_ate_m"])
    med, jmed = statistics.median(ates), statistics.median(jax_ates)
    limit = max(0.10, 2.0 * jmed)
    print(f"[smoke] ATE gate: median {med:.4f} m vs limit {limit:.4f} m "
          f"(max(0.10, 2 x JAX median {jmed:.4f}))")
    require(med <= limit, "ATE gate: median ATE above the limit")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    require((ROOT / "ndtpu_torch").is_dir() and REF_FILE.is_file(),
            f"run from a checkout of the repository ({ROOT} lacks "
            f"ndtpu_torch/ or {REF_FILE.name})")
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

    launches = run_entry_point(dev)
    ate_gate(dev)
    for k in KERNELS:
        require(launches[k["name"]] > 0,
                f"{k['name']}: the main path launched it no time")

    rows = [dict(name=k["name"], route="cuda", source=k["source"],
                 replaces=k["replaces"], launches=launches[k["name"]],
                 **results[k["name"]]) for k in KERNELS]
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
