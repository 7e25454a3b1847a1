"""Multi-session serving CLI: S concurrent SLAM sessions on one card.

Usage::

    python -m ndtpu_torch.serve --config configs/config_serving.json \\
        --sessions 8 --max-scans 300 [--capacity 0] [--out-dir out/] \\
        [--device cuda]

Port of ``ndtpu/serve.py``: S sessions, one per CARMEN log of
``--datasets`` (``data.carmen``, cut to ``--max-scans``) or S synthetic
box-world sessions (one rectangle lap each, a size and a seed per
session, simulated on the run's device: K11 on the card), run through
:func:`ndtpu_torch.dist.slam_dp.run_sessions_stacked` under
:func:`~ndtpu_torch.dist.slam_dp.serving_config`, one stacked window step at
a time. It prints one JSON summary (aggregate scans/s, and per session the
keyframes, loops, capacity drops, innovation rejections and ATE) and, with
``--out-dir``, writes ``traj_<k>.txt`` per session and
``serve_metrics.json`` (ATE only where there is ground truth: not for
logs). ``--capacity 0`` sizes the keyframe and graph
stores from the session length, as the JAX package does (160 at 300
scans); ``n_dropped`` is reported, so an undersized store shows.

Timing: one run first (the kernels' build and the allocator's warm-up
fall in it, reported as ``first_run_s``), then the median of 3 runs, each
ended by a device synchronize, each on the inputs moved by a fresh 1e-6 m
offset (as the JAX package does; the offsets come from ``cfg.seed``, so
two invocations run the same inputs). The reported state is the last
run's. ``--device cuda`` (the default) fails without a card; ``--device
cpu`` runs the plain twins.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import sys
import time

import numpy as np
import torch

__all__ = ["synthetic_sessions", "dataset_sessions", "pad_sessions",
           "auto_capacity", "trajectories", "main"]


def synthetic_sessions(cfg, sessions: int, n_scans: int, device="cpu"):
    """The serving workload's sessions on ``device``: session ``k`` laps a
    rectangle of half-size ``6 + 0.2 (k mod 10)`` m at 0.2 m steps in the
    11 m box world, seed ``cfg.seed + 20 + k``, odometry noise 0.04 m /
    0.01 rad."""
    from ndtpu_torch.data import synth

    world = synth.box_world(half=11.0)
    seqs = []
    for k in range(sessions):
        traj = synth.rectangle_trajectory(n_scans, half=6.0 + 0.2 * (k % 10),
                                          step=0.2)
        seqs.append(synth.make_sequence(
            world, traj, n_beams=cfg.n_beams, max_range=cfg.max_range,
            min_range=cfg.min_range, seed=cfg.seed + 20 + k,
            odom_trans_std=0.04, odom_rot_std=0.01, device=device))
    return seqs


def dataset_sessions(cfg, paths, max_scans, device="cpu"):
    """One session per CARMEN log (``data.carmen.read_log`` and
    ``to_sequence`` at the config's ranges, cut to ``max_scans``), on
    ``device``, without ground truth."""
    from ndtpu_torch.data import carmen, synth

    seqs = []
    for path in paths:
        pts, mask, odom = carmen.to_sequence(carmen.read_log(path),
                                             max_range=cfg.max_range,
                                             min_range=cfg.min_range)
        t = pts.shape[0] if max_scans is None else min(pts.shape[0],
                                                       max_scans)
        pts, mask, odom = (torch.as_tensor(a[:t], device=device)
                           for a in (pts, mask, odom))
        seqs.append(synth.Sequence2D(points=pts, mask=mask, odom=odom,
                                     gt_poses=None, angles=None))
    return seqs


def pad_sessions(seqs):
    """Stack sequences of different lengths: ``(points [S, T, N, 2], mask
    [S, T, N], odom [S, T, 3], lengths)``, padded to the longest with
    all-false masks and identity odometry (the matcher exits in 0
    iterations on an empty scan)."""
    lengths = [s.points.shape[0] for s in seqs]
    t_max = max(lengths)
    n = max(s.points.shape[1] for s in seqs)
    first = seqs[0].points
    points = first.new_zeros((len(seqs), t_max, n, 2))
    mask = torch.zeros((len(seqs), t_max, n), dtype=torch.bool,
                       device=first.device)
    odom = first.new_zeros((len(seqs), t_max, 3))
    for k, s in enumerate(seqs):
        t, nb = s.points.shape[:2]
        points[k, :t, :nb] = s.points
        mask[k, :t, :nb] = s.mask
        odom[k, :t] = s.odom
    return points, mask, odom, lengths


def auto_capacity(cfg, t_max: int) -> int:
    """Keyframe and graph capacity for sessions of ``t_max`` scans: ~1.5x
    the expected keyframes (the synthetic sessions land near T / 2.7),
    rounded to 32, never above the configured capacity."""
    return min(cfg.keyframe.capacity,
               max(32, int(1.5 * t_max / 2.7 + 16) // 32 * 32))


def trajectories(state8, outs8) -> torch.Tensor:
    """Every session's per-scan trajectory ``[S, T, 3]`` by the shared
    helper ``pipeline.recover_trajectory``."""
    from ndtpu_torch.dist.slam_dp import _take
    from ndtpu_torch.slam import pipeline

    return torch.stack([
        pipeline.recover_trajectory(_take(state8, k), _take(outs8, k))
        for k in range(outs8.pose.shape[0])])


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Stacked multi-session SLAM serving on one card")
    parser.add_argument("--config", required=True)
    parser.add_argument("--datasets", nargs="*", default=None,
                        help="CARMEN logs, one session each")
    parser.add_argument("--sessions", type=int, default=8,
                        help="synthetic session count")
    parser.add_argument("--max-scans", type=int, default=None)
    parser.add_argument("--out-dir", default=None)
    parser.add_argument("--capacity", type=int, default=0,
                        help="keyframe/graph capacity (0 = auto)")
    parser.add_argument("--device", default="cuda",
                        help="cuda (kernels) or cpu (plain twins)")
    args = parser.parse_args(argv)

    from ndtpu_torch.config import PipelineConfig
    from ndtpu_torch.dist import slam_dp
    from ndtpu_torch.eval.ate import ate_rmse
    from ndtpu_torch.run import _device

    cfg = PipelineConfig.from_json(args.config)
    device = _device(args.device)
    seqs = (dataset_sessions(cfg, args.datasets, args.max_scans, device)
            if args.datasets else
            synthetic_sessions(cfg, args.sessions, args.max_scans or 300,
                               device))
    points, mask, odom, lengths = pad_sessions(seqs)
    s, t_max = points.shape[:2]
    cap = args.capacity if args.capacity > 0 else auto_capacity(cfg, t_max)
    scfg = slam_dp.serving_config(cfg)
    scfg = dataclasses.replace(
        scfg, keyframe=dataclasses.replace(scfg.keyframe, capacity=cap))

    def run(pts):
        _sync(device)
        t0 = time.perf_counter()
        out = slam_dp.run_sessions_stacked(pts, mask, odom, scfg)
        _sync(device)
        return out, time.perf_counter() - t0

    (state, outs), first_s = run(points)
    rng = np.random.default_rng(cfg.seed)
    reps = []
    for _ in range(3):
        shift = torch.tensor(rng.normal(0.0, 1e-6), dtype=points.dtype,
                             device=device)
        (state, outs), dt = run(points + shift)
        reps.append(dt)
    warm_s = statistics.median(reps)
    traj = trajectories(state, outs).cpu()

    total = sum(lengths)
    summary = {"sessions": s, "scans_total": total,
               "aggregate_scans_per_s": total / warm_s,
               "run_s": reps, "first_run_s": first_s, "capacity": cap,
               "device": (torch.cuda.get_device_name(device)
                          if device.type == "cuda" else "cpu"),
               "per_session": []}
    for k in range(s):
        t_k = lengths[k]
        rec = {"session": k, "scans": t_k,
               "keyframes": int(state.kf.n[k]),
               "loops": int(state.n_loops[k]),
               "dropped": int(outs.n_dropped[k].sum()),
               "innov_rejected": int(outs.n_innov_rej[k].sum())}
        if seqs[k].gt_poses is not None:
            rec["ate_m"] = float(ate_rmse(traj[k, :t_k],
                                          seqs[k].gt_poses.to(traj)))
        summary["per_session"].append(rec)
        if args.out_dir:
            os.makedirs(args.out_dir, exist_ok=True)
            np.savetxt(os.path.join(args.out_dir, f"traj_{k}.txt"),
                       traj[k, :t_k].numpy(), fmt="%.6f")
    if args.out_dir:
        with open(os.path.join(args.out_dir, "serve_metrics.json"),
                  "w") as f:
            json.dump(summary, f, indent=2)
    dropped = sum(r["dropped"] for r in summary["per_session"])
    if dropped:
        print(f"[serve] WARNING: {dropped} keyframes/factors dropped at "
              f"capacity {cap}; raise --capacity", file=sys.stderr)
    print(json.dumps(summary))
    return dict(summary, traj=traj.numpy())


if __name__ == "__main__":
    main()
