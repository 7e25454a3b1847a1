"""CLI runner for the port: windowed SLAM on a synthetic sequence.

Usage::

    python -m ndtpu_torch.run --config configs/config2_full_sequence.json \
        [--max-scans 300] [--device cuda] [--out-traj traj.txt] \
        [--out-metrics m.jsonl]

Port of ``ndtpu/run.py``'s windowed mode on its synthetic input (the
corridor-loop world): it prints the same stderr lines (scans/s, keyframes,
ATE/RPE, the ASCII map of grid 0), writes the trajectory as ``x y theta``
rows and per-window JSONL metrics. ``--device cuda`` (the default) runs the
map build, the quad table and registration through the CUDA kernels and
fails if there is no card; ``--device cpu`` runs the plain twins.

Configs 1-3 run (``use_loop_closure`` in the config turns on loop
closure; the stderr summary line counts the loops closed). Not in this
port yet (each raises ``NotImplementedError``): ``--dataset`` (CARMEN
input, ROADMAP A7), ``--mode scan`` (per-scan path, A8),
``--checkpoint-dir`` (A7).
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch


def _device(name: str) -> torch.device:
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: no CUDA device is available "
                           f"(use --device cpu for the plain-torch path)")
    return dev


def _build_inputs(args, cfg, device):
    from ndtpu_torch.data import synth

    n = args.max_scans or 300
    world = synth.corridor_loop_world(outer=18.0, width=5.0)
    traj = synth.rectangle_trajectory(n, half=15.0, step=0.25)
    seq = synth.make_sequence(world, traj, n_beams=cfg.n_beams,
                              max_range=cfg.max_range,
                              min_range=cfg.min_range, seed=cfg.seed,
                              odom_trans_std=0.03, odom_rot_std=0.008,
                              device=device)
    return seq.points, seq.mask, seq.odom, seq.gt_poses


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--config", required=True)
    parser.add_argument("--dataset", default=None,
                        help="CARMEN log (not in this port yet)")
    parser.add_argument("--max-scans", type=int, default=None)
    parser.add_argument("--out-traj", default=None)
    parser.add_argument("--out-metrics", default=None)
    parser.add_argument("--checkpoint-dir", default=None,
                        help="checkpointing (not in this port yet)")
    parser.add_argument("--mode", choices=("windowed", "scan"),
                        default="windowed")
    parser.add_argument("--device", default="cuda",
                        help="cuda (kernels) or cpu (plain twins)")
    args = parser.parse_args(argv)

    if args.dataset:
        raise NotImplementedError("--dataset (CARMEN input) is ROADMAP A7")
    if args.checkpoint_dir:
        raise NotImplementedError("--checkpoint-dir is ROADMAP A7")
    if args.mode == "scan":
        raise NotImplementedError("--mode scan (per-scan path) is ROADMAP A8")

    from ndtpu_torch.config import PipelineConfig
    from ndtpu_torch.eval.ate import ate_rmse, rpe
    from ndtpu_torch.ndt import grid as ndt_grid
    from ndtpu_torch.slam import pipeline
    from ndtpu_torch.utils import metrics

    cfg = PipelineConfig.from_json(args.config)
    if cfg.downsample_voxel > 0.0:
        raise NotImplementedError("downsample_voxel is ROADMAP A7 "
                                  "(data/preprocess.py)")
    device = _device(args.device)
    points, mask, odom, gt = _build_inputs(args, cfg, device)
    t_total = points.shape[0]
    print(f"[run] {t_total} scans x {points.shape[1]} beams; "
          f"loop_closure={cfg.use_loop_closure}; device={device}",
          file=sys.stderr)

    _sync(device)
    t0 = time.perf_counter()
    state = pipeline.init_slam(cfg, points[0], mask[0])
    pts_w, msk_w, odo_w, n_win = pipeline.window_inputs(points, mask, odom,
                                                        cfg.window)
    carry, outs, step_ts = (state, state.pose), [], []
    for k in range(n_win):
        td = time.perf_counter()
        carry, out = pipeline.slam_window_step(carry[0], carry[1], pts_w[k],
                                               msk_w[k], odo_w[k], cfg)
        step_ts.append(time.perf_counter() - td)
        outs.append(out)
    state = carry[0]
    _sync(device)
    dt = time.perf_counter() - t0
    scans_per_s = (t_total - 1) / dt
    print(f"[run] {scans_per_s:.1f} scans/s ({dt:.1f}s total), "
          f"keyframes={int(state.kf.n)}, loops={int(state.n_loops)}",
          file=sys.stderr)

    records = [{"window": k, "scan": 1 + k * cfg.window,
                "step_s": round(step_ts[k], 6),
                "score": float(out.score.mean()),
                "kf": int(out.is_keyframe.sum()),
                "loops": int(out.n_loops_new.sum())}
               for k, out in enumerate(outs)]
    stacked = pipeline.stack_outs(outs, t_total - 1)
    n_drop = int(stacked.n_dropped.sum())
    if n_drop:
        print(f"[run] WARNING: {n_drop} keyframe/factor append(s) dropped at "
              f"capacity — raise keyframe.capacity", file=sys.stderr)

    traj = pipeline.recover_trajectory(state, stacked)
    ate = None
    if gt is not None:
        ate = float(ate_rmse(traj, gt))
        t_rmse, r_rmse = rpe(traj, gt)
        print(f"[run] ATE {ate:.4f} m; RPE {float(t_rmse):.4f} m / "
              f"{float(r_rmse):.4f} rad", file=sys.stderr)

    traj_np = traj.detach().cpu().numpy()
    if args.out_traj:
        np.savetxt(args.out_traj, traj_np, fmt="%.6f")
        print(f"[run] trajectory -> {args.out_traj}", file=sys.stderr)
    if args.out_metrics:
        with metrics.JsonlLogger(args.out_metrics) as lg:
            for r in records:
                lg.write(r)
            lg.write({"summary": metrics.summarize_run(records)})
        print(f"[run] metrics -> {args.out_metrics}", file=sys.stderr)

    m = ndt_grid.finalize(state.stats, cfg.ndt)
    v = m.valid[0].reshape(cfg.grid.ny, cfg.grid.nx).cpu().numpy()
    print(metrics.map_to_ascii(v), file=sys.stderr)
    return dict(traj=traj_np, n_keyframes=int(state.kf.n),
                n_loops=int(state.n_loops), ate=ate,
                scans_per_s=scans_per_s, seconds=dt)


if __name__ == "__main__":
    main()
