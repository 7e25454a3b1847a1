"""CLI runner for the port: SLAM on a CARMEN log or a synthetic sequence.

Usage::

    python -m ndtpu_torch.run --config configs/config2_full_sequence.json \
        [--dataset intel.clf] [--max-scans 300] [--mode windowed|scan] \
        [--device cuda] [--out-traj traj.txt] [--out-metrics m.jsonl] \
        [--checkpoint-dir ckpts] [--checkpoint-every 100] [--resume]

Port of ``ndtpu/run.py``. With ``--dataset`` a CARMEN log is read
(``data.carmen``, the native parser where it builds); without it the
config's synthetic sequence (the corridor-loop world) is simulated on the
run's device (K11 on the card). With ``downsample_voxel > 0`` in the
config the scans are thinned first (K13 on the card) and the kept count is
printed. ``--mode windowed`` (the default) runs W scans per window step,
``--mode scan`` one ``slam_step`` per scan. It prints the same stderr
lines as the JAX package (scans/s, keyframes, loops, ATE/RPE where there
is ground truth, the ASCII map of grid 0), writes the trajectory as ``x y
theta`` rows and JSONL metrics (one record per window, or per scan).

Checkpoints: ``--checkpoint-dir`` saves the state every
``--checkpoint-every`` scans (whole windows in windowed mode; one cadence
gate per mode), namespaced ``ckpt_win_`` / ``ckpt_scan_`` so the two
modes never restore each other's states; ``--resume`` continues from the
newest one of the mode, on the run's device.

``--device cuda`` (the default) runs through the CUDA kernels and fails if
there is no card; ``--device cpu`` runs the plain twins.
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
    """``(points, mask, odom, gt_poses or None)`` on ``device``."""
    from ndtpu_torch.data import carmen, synth

    if args.dataset:
        log = carmen.read_log(args.dataset)
        pts, mask, odom = carmen.to_sequence(log, max_range=cfg.max_range,
                                             min_range=cfg.min_range)
        t = pts.shape[0] if args.max_scans is None else min(pts.shape[0],
                                                            args.max_scans)
        return tuple(torch.as_tensor(a[:t], device=device)
                     for a in (pts, mask, odom)) + (None,)
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


def _run_windowed(state, points, mask, odom, cfg, mgr, args):
    """Window steps from the newest checkpoint (with ``--resume``) to the
    end. Returns ``(state, stacked outs, records, first scan run)``."""
    from ndtpu_torch.slam import pipeline

    w = cfg.window
    pts_w, msk_w, odo_w, n_win = pipeline.window_inputs(points, mask, odom, w)
    carry, start = (state, state.pose), 0
    if args.resume and mgr is not None:
        step, restored = mgr.restore_latest(carry)
        if restored is not None:
            carry, start = restored, step + 1
            print(f"[run] resumed at window {start} (scan {1 + start * w})",
                  file=sys.stderr)
    every_win = max(1, -(-args.checkpoint_every // w))
    outs, step_ts = [], []
    for k in range(start, n_win):
        td = time.perf_counter()
        carry, out = pipeline.slam_window_step(carry[0], carry[1], pts_w[k],
                                               msk_w[k], odo_w[k], cfg)
        step_ts.append(time.perf_counter() - td)
        outs.append(out)
        if mgr is not None and (k + 1) % every_win == 0:
            mgr.maybe_save(k, carry)
    records = [{"window": k, "scan": 1 + k * w, "step_s": round(ts, 6),
                "score": float(out.score.mean()),
                "kf": int(out.is_keyframe.sum()),
                "loops": int(out.n_loops_new.sum())}
               for k, ts, out in zip(range(start, n_win), step_ts, outs)]
    stacked = pipeline.stack_outs(outs, points.shape[0] - 1 - start * w)
    return carry[0], stacked, records, 1 + start * w


def _run_scans(state, points, mask, odom, cfg, mgr, args):
    """One ``slam_step`` per scan from the newest checkpoint (with
    ``--resume``) to the end; the records are read after the loop."""
    from ndtpu_torch.slam import pipeline

    start = 1
    if args.resume and mgr is not None:
        step, restored = mgr.restore_latest(state)
        if restored is not None:
            state, start = restored, step + 1
            print(f"[run] resumed at scan {start}", file=sys.stderr)
    outs, step_ts = [], []
    for t in range(start, points.shape[0]):
        td = time.perf_counter()
        state, out = pipeline.slam_step(state, points[t], mask[t], odom[t],
                                        cfg)
        step_ts.append(time.perf_counter() - td)
        outs.append(out)
        if mgr is not None:
            mgr.maybe_save(t, state)
    stacked = pipeline.stack_scan_outs(outs)
    records = [{"scan": start + i, "step_s": round(ts, 6), "score": sc,
                "is_kf": kf, "loops": lp}
               for i, (ts, sc, kf, lp) in enumerate(zip(
                   step_ts, stacked.score.tolist(),
                   stacked.is_keyframe.tolist(),
                   stacked.n_loops_new.tolist()))]
    return state, stacked, records, start


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config", required=True)
    parser.add_argument("--dataset", default=None,
                        help="CARMEN .clf/.log file (synthetic if omitted)")
    parser.add_argument("--max-scans", type=int, default=None)
    parser.add_argument("--out-traj", default=None)
    parser.add_argument("--out-metrics", default=None)
    parser.add_argument("--checkpoint-dir", default=None)
    parser.add_argument("--checkpoint-every", type=int, default=100,
                        help="checkpoint cadence in scans (rounded up to "
                             "whole windows in windowed mode)")
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("--mode", choices=("windowed", "scan"),
                        default="windowed",
                        help="windowed: W scans per step; scan: one step "
                             "per scan")
    parser.add_argument("--device", default="cuda",
                        help="cuda (kernels) or cpu (plain twins)")
    args = parser.parse_args(argv)

    from ndtpu_torch.config import PipelineConfig
    from ndtpu_torch.eval.ate import ate_rmse, rpe
    from ndtpu_torch.ndt import grid as ndt_grid
    from ndtpu_torch.slam import pipeline
    from ndtpu_torch.utils import checkpoint as ckpt
    from ndtpu_torch.utils import metrics

    cfg = PipelineConfig.from_json(args.config)
    device = _device(args.device)
    points, mask, odom, gt = _build_inputs(args, cfg, device)
    n_kept = None
    if cfg.downsample_voxel > 0.0:
        from ndtpu_torch.data.preprocess import voxel_downsample

        mask = voxel_downsample(points, mask, cfg.downsample_voxel)
        n_kept = int(mask.sum())
        print(f"[run] voxel downsample {cfg.downsample_voxel} m: "
              f"{n_kept} points kept", file=sys.stderr)
    t_total = points.shape[0]
    print(f"[run] {t_total} scans x {points.shape[1]} beams; "
          f"loop_closure={cfg.use_loop_closure}; mode={args.mode}; "
          f"device={device}", file=sys.stderr)

    # One cadence gate per mode: windowed mode gates on the window index
    # (the manager saves every call), scan mode in the manager.
    mgr = None
    if args.checkpoint_dir:
        mgr = (ckpt.CheckpointManager(args.checkpoint_dir, every=1,
                                      prefix="ckpt_win_")
               if args.mode == "windowed" else
               ckpt.CheckpointManager(args.checkpoint_dir,
                                      every=args.checkpoint_every,
                                      prefix="ckpt_scan_"))

    _sync(device)
    t0 = time.perf_counter()
    state = pipeline.init_slam(cfg, points[0], mask[0])
    run = _run_windowed if args.mode == "windowed" else _run_scans
    state, stacked, records, first = run(state, points, mask, odom, cfg, mgr,
                                         args)
    _sync(device)
    dt = time.perf_counter() - t0
    scans_per_s = (t_total - first) / dt
    print(f"[run] {scans_per_s:.1f} scans/s ({dt:.1f}s total), "
          f"keyframes={int(state.kf.n)}, loops={int(state.n_loops)}",
          file=sys.stderr)

    n_drop = int(stacked.n_dropped.sum())
    if n_drop:
        print(f"[run] WARNING: {n_drop} keyframe/factor append(s) dropped at "
              f"capacity — raise keyframe.capacity", file=sys.stderr)

    traj = pipeline.recover_trajectory(state, stacked)
    ate = None
    if gt is not None:
        gt_run = gt[t_total - traj.shape[0]:]
        ate = float(ate_rmse(traj, gt_run))
        t_rmse, r_rmse = rpe(traj, gt_run)
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
                scans_per_s=scans_per_s, seconds=dt, n_kept=n_kept,
                state=state)


if __name__ == "__main__":
    main()
