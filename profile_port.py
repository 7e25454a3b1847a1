#!/usr/bin/env python3
"""Where the time goes in the port's windowed pipeline, on the card.

Run from the root of a checkout, on a machine with one CUDA card::

    python3 profile_port.py [--config configs/config3_loop_closure.json]
                            [--seed 0] [--runs 3] [--out FILE.json]

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
   detection (``_wb_loops``, of it the ``K*C``-lane registrations), the
   smoother (``_wb_smooth``) and the map maintenance (``_wb_maps``);
3. one run of the kernel route under ``torch.profiler``: device kernels
   per scan, the union of their busy intervals over the profiled span,
   the largest kernels by device time, ``lm_ndt``'s device time per launch,
   and the card time per call of K3 ``halfcell_add`` (memset, scatter and
   pool) and K8a ``local_tables``, by call shape (K3: the window's scans,
   the rebuild of every keyframe slot, others by point count);
4. with ``--shadow``, one more run in which every ``lm_ndt`` call is also
   made on the composite route and compared bit for bit.

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


def run_once(inputs, cfg):
    import torch

    from ndtpu_torch.slam import pipeline

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, outs = pipeline.run_slam_windowed(*inputs, cfg)
    traj = pipeline.recover_trajectory(state, outs)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, state, traj


def phase_run(inputs, cfg):
    """One run with the phases synchronized at their edges; seconds per
    phase (nested phases are also inside their parents)."""
    import torch

    from ndtpu_torch.loop import closure
    from ndtpu_torch.slam import pipeline

    spent = defaultdict(float)
    patched = [(pipeline, "_window_frontend"), (pipeline, "_wb_appends"),
               (pipeline, "_wb_loops"), (pipeline, "_wb_smooth"),
               (pipeline, "_wb_maps"), (closure, "write_local_tables"),
               (closure, "verify_registrations")]
    saved = [(mod, name, getattr(mod, name)) for mod, name in patched]

    def timed(name, fn):
        def wrapper(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            spent[name] += time.perf_counter() - t0
            return out
        return wrapper

    for mod, name, fn in saved:
        setattr(mod, name, timed(name, fn))
    try:
        wall, _, _ = run_once(inputs, cfg)
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    return wall, dict(spent)


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


def profiled_run(inputs, cfg, n_scans: int):
    """Device kernels per scan, device busy share of the profiled span,
    top kernels, lm_ndt's device time per launch, and K3's and K8a's card
    time per call by call shape."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ndtpu_torch import kernels

    k3_calls, k8a_calls = [], []
    k3, k8a = kernels.halfcell_add, kernels.local_tables

    def k3_logged(n, s, ss, points, *a):
        k3_calls.append(points.shape[0])
        return k3(n, s, ss, points, *a)

    def k8a_logged(tables, slot, *a):
        k8a_calls.append(slot.shape[0])
        return k8a(tables, slot, *a)

    kernels.halfcell_add, kernels.local_tables = k3_logged, k8a_logged
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            wall, _, _ = run_once(inputs, cfg)
    finally:
        kernels.halfcell_add, kernels.local_tables = k3, k8a
    spans, by_name, events = [], defaultdict(lambda: [0, 0.0]), []
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        a, b = e.time_range.start, e.time_range.end
        spans.append((a, b))
        events.append((a, b, e.name))
        by_name[e.name][0] += 1
        by_name[e.name][1] += (b - a) / 1e3
    spans.sort()
    events.sort()
    busy, end = 0.0, None
    for a, b in spans:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    lm = [v for k, v in by_name.items() if "lm_ndt_kernel" in k]
    lm_n = sum(v[0] for v in lm)
    return dict(
        profiled_wall_s=wall, device_events=len(spans),
        device_events_per_scan=len(spans) / n_scans,
        device_busy_ms=busy / 1e3,
        device_busy_share=busy / 1e6 / wall,
        lm_ndt_launches=lm_n,
        lm_ndt_device_ms_per_launch=(sum(v[1] for v in lm) / lm_n
                                     if lm_n else None),
        map_build=map_build_calls(events, k3_calls, k8a_calls, cfg),
        top=[dict(name=k[:80], count=v[0], ms=v[1]) for k, v in top])


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
    cfg = PipelineConfig.from_json(args.config)
    seq = box_sequence(args.seed, cfg.n_beams)
    dev = torch.device("cuda", 0)
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
    wall_p, spent = phase_run(inputs, cfg)
    shares = {k: v / wall_p for k, v in spent.items()}
    print(f"[profile] phases ({wall_p:.4f} s): " + ", ".join(
        f"{k} {v:.4f} s ({shares[k]:.1%})" for k, v in spent.items()))
    prof = profiled_run(inputs, cfg, n)
    print(f"[profile] torch.profiler: {prof['device_events']} device events "
          f"({prof['device_events_per_scan']:.1f} per scan), busy "
          f"{prof['device_busy_ms']:.2f} ms of {prof['profiled_wall_s']:.4f}"
          f" s ({prof['device_busy_share']:.1%}); lm_ndt "
          f"{prof['lm_ndt_launches']} launches, "
          f"{prof['lm_ndt_device_ms_per_launch']} ms each on the card")
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
    result = dict(card=smi, config=Path(args.config).name, seed=args.seed,
                  scans=n, wall_s=walls,
                  scans_per_s={k: [(n - 1) / w for w in v]
                               for k, v in walls.items()},
                  phase_wall_s=wall_p, phase_s=spent, profiler=prof,
                  shadow=shadow)
    print(smi)
    line = json.dumps(result)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
