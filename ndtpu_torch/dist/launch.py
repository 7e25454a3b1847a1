"""Multi-process bring-up of config 5's distributed paths, and a local launch.

Port of ``ndtpu/dist/launch.py``:

- :func:`initialize` — one ``torch.distributed`` process group per run
  (gloo, TCP rendezvous at ``--coordinator``; env fallbacks
  ``NDTPU_COORDINATOR`` / ``NDTPU_NUM_PROCESSES`` / ``NDTPU_PROCESS_ID``).
  Gloo reduces CUDA tensors too, so ranks can share one card; NCCL is for
  ranks on cards of their own, which a one-card machine cannot test
  (ROADMAP C-w9).
- :func:`launch_local` — spawn N worker processes on this machine running
  :func:`worker_main` and return rank 0's report. With ``device="cuda"``
  the parent builds the CUDA kernels first, so the ranks load one built
  library and never race on the build directory.
- ``python -m ndtpu_torch.dist.launch --num-processes N --process-id I
  [--task schur|slam] [--graph-npz G] [--device cuda|cpu] [--out F]`` —
  one worker. ``--task schur`` (the default): join the group, solve the
  pose graph by :func:`ndtpu_torch.dist.schur.optimize_schur` (each rank
  holds only its shard's factor rows), time one step and one small
  all-reduce, and have rank 0 print the report as one JSON line. ``--task
  slam``: one windowed SLAM session per process
  (``dist.slam_dp.run_sessions_sharded`` over the ``"batch"`` axis), the
  reference's sessions; each rank writes its sessions' keyframe counts,
  ATE and state digest to ``F.p<rank>``, and rank 0 merges them into one
  JSON line (and ``F``).

``--device cuda`` (the default) fails without a card, as
``ndtpu_torch.run`` does. The npz format is the JAX package's (the keys of
``PoseGraph._asdict()``, integers as int32), so a graph saved by either
package loads in the other.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

__all__ = ["initialize", "shutdown", "worker_main", "save_graph_npz",
           "load_graph_npz", "launch_local", "slam_sessions", "state_sha256"]

ROOT = Path(__file__).resolve().parents[2]


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """Join the run's gloo process group (ranks that are not all up within
    10 minutes fail); a no-op for one process."""
    import datetime

    coordinator_address = coordinator_address or os.environ.get(
        "NDTPU_COORDINATOR", "localhost:29511")
    if num_processes is None:
        num_processes = int(os.environ.get("NDTPU_NUM_PROCESSES", "1"))
    if process_id is None:
        process_id = int(os.environ.get("NDTPU_PROCESS_ID", "0"))
    if num_processes <= 1:
        return
    torch.distributed.init_process_group(
        "gloo", init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(minutes=10))


def shutdown() -> None:
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()


def _device(name: str) -> str:
    if name.startswith("cuda") and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: no CUDA device is available "
                           f"(use --device cpu for the plain-torch path)")
    return name


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def worker_main(argv=None) -> None:
    """One worker of the distributed solve (see the module docstring)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", default="localhost:29511")
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--n-poses", type=int, default=120)
    ap.add_argument("--task", choices=("schur", "slam"), default="schur")
    ap.add_argument("--graph-npz", default="",
                    help="serialized PoseGraph (save_graph_npz of either "
                         "package) to solve instead of a Manhattan world")
    ap.add_argument("--device", default="cuda",
                    help="cuda (kernels; ranks share the cards round "
                         "robin) or cpu (plain versions)")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    device = _device(args.device)
    if args.task == "slam":
        initialize(args.coordinator, args.num_processes, args.process_id)
        _slam_worker(args, device)
        shutdown()
        return

    from ndtpu_torch import kernels
    from ndtpu_torch.config import SolverConfig
    from ndtpu_torch.data import g2o
    from ndtpu_torch.dist import mesh as dmesh
    from ndtpu_torch.dist import schur
    from ndtpu_torch.graph import factors as fct

    initialize(args.coordinator, args.num_processes, args.process_id)
    mesh = dmesh.multihost_mesh(device)
    dev = mesh.device
    if dev.type == "cuda":
        torch.cuda.set_device(dev)

    # The same problem on every process (same file, or the same seed).
    if args.graph_npz:
        g = load_graph_npz(args.graph_npz, dev)
    else:
        data = g2o.manhattan_world(args.n_poses, seed=0, loop_prob=0.2)
        g = g2o.to_graph(data, dtype=torch.float32, device=dev)
        rng = np.random.default_rng(0)
        g = g._replace(poses=g.poses + torch.as_tensor(
            rng.normal(0, 0.05, tuple(g.poses.shape)), dtype=g.poses.dtype,
            device=dev))
    plan = schur.plan_partition(
        g.bet_i.cpu().numpy(), g.bet_j.cpu().numpy(),
        g.bet_mask.cpu().numpy(), g.prior_idx.cpu().numpy(),
        g.prior_mask.cpu().numpy(), int(g.poses.shape[0]),
        n_shards=mesh.size)

    chi0 = float(fct.chi2(g))
    sd = schur.shard_factor_data_local(g, plan, mesh.rank)
    _sync(dev)
    kernels.reset_launches()
    dmesh.reset_collectives()
    t0 = time.perf_counter()
    res = schur.optimize_schur(mesh, g, plan, SolverConfig(max_iter=10),
                               sd=sd)
    _sync(dev)
    solve_wall = time.perf_counter() - t0
    iters = int(res.n_iter)
    mine = dict(rank=mesh.rank, iters=iters,
                k9c=kernels.LAUNCHES["schur_local_assemble"],
                k5=kernels.LAUNCHES["factor_linearize"],
                all_reduce=dmesh.COLLECTIVES["all_reduce"],
                all_reduce_s=dmesh.COLLECTIVES["all_reduce_s"])
    chi1 = float(fct.chi2(res.graph))
    # The same solve again, warm (the first one pays the libraries' set-up).
    dmesh.reset_collectives()
    t0 = time.perf_counter()
    schur.optimize_schur(mesh, g, plan, SolverConfig(max_iter=10), sd=sd)
    _sync(dev)
    warm_wall = time.perf_counter() - t0
    warm_reduce_s = dmesh.COLLECTIVES["all_reduce_s"]

    # One distributed step (linearize, eliminate, reduce, separator solve,
    # back-substitute), its tables built once, on inputs shifted by fresh
    # 1e-6 m jiggles; the fastest of 9, as the reference reports it.
    t, loc = schur._rank_inputs(mesh, g, plan, sd)
    reduce = lambda x: dmesh.all_reduce(mesh, x)
    v = g.poses.shape[0]

    def step(poses):
        lin = schur._linearize_shard(poses, *loc)
        return schur._schur_delta_local(t, 1e-3, v, lin, loc[4], loc[8],
                                        reduce)

    step(g.poses)
    _sync(dev)
    rng_t = np.random.default_rng()
    ts = []
    for _ in range(9):
        jiggle = float(rng_t.normal(0, 1e-6))
        t1 = time.perf_counter()
        step(g.poses + jiggle)
        _sync(dev)
        ts.append(time.perf_counter() - t1)

    # The collective's floor: one 8-float all-reduce, median of 5.
    tiny = torch.ones(8, dtype=torch.float32, device=dev)
    reduce(tiny)
    ots = []
    for k in range(5):
        x = tiny + k
        _sync(dev)
        t1 = time.perf_counter()
        reduce(x)
        _sync(dev)
        ots.append(time.perf_counter() - t1)

    # Every rank's launch and reduction counts, gathered onto rank 0.
    keys = ("iters", "k9c", "k5", "all_reduce", "all_reduce_s")
    table = torch.zeros((mesh.size, len(keys)), dtype=torch.float64)
    table[mesh.rank] = torch.tensor([float(mine[k]) for k in keys],
                                    dtype=torch.float64)
    dmesh.all_reduce(mesh, table)
    if mesh.rank == 0:
        ranks = [dict(zip(keys, row)) for row in table.tolist()]
        rec = {"num_processes": mesh.size, "n_devices": mesh.size,
               "n_poses": int(g.poses.shape[0]), "chi2_before": chi0,
               "chi2_after": chi1, "iters": iters,
               "solve_s": min(ts), "psum_s": sorted(ots)[len(ots) // 2],
               "optimize_s": solve_wall,
               "ms_per_iter": 1e3 * solve_wall / max(iters, 1),
               "all_reduce_ms_per_iter":
                   1e3 * mine["all_reduce_s"] / max(iters, 1),
               "warm_ms_per_iter": 1e3 * warm_wall / max(iters, 1),
               "warm_all_reduce_ms_per_iter":
                   1e3 * warm_reduce_s / max(iters, 1),
               "device": (torch.cuda.get_device_name(dev)
                          if dev.type == "cuda" else "cpu"),
               "ranks": ranks}
        line = json.dumps(rec)
        print(line, flush=True)
        if args.out:
            Path(args.out).write_text(line)
    shutdown()


def slam_sessions(n: int, n_scans: int):
    """The ``--task slam`` rehearsal's sessions (the reference worker's):
    session ``k`` of ``n`` drives a ``rectangle_trajectory`` of half-size
    ``3.0 + 0.3 k`` m at 0.3 m steps through ``box_world(half=11)``, 120
    beams, seed ``40 + k``; with its config (28 x 28 cells of 1 m,
    keyframes every 0.5 m / 0.3 rad up to 48, loop closure, W = 8, two
    passes). Returns ``(cfg, [Sequence2D] on the CPU)``."""
    from ndtpu_torch.config import (GridConfig, KeyframeConfig, LoopConfig,
                                    PipelineConfig)
    from ndtpu_torch.data import synth

    world = synth.box_world(half=11.0)
    seqs = [synth.make_sequence(
        world, synth.rectangle_trajectory(n_scans, half=3.0 + 0.3 * k,
                                          step=0.3),
        n_beams=120, max_range=20.0, min_range=0.1, seed=40 + k,
        odom_trans_std=0.03, odom_rot_std=0.01) for k in range(n)]
    cfg = PipelineConfig(
        grid=GridConfig(x0=-14.0, y0=-14.0, cell=1.0, nx=28, ny=28,
                        overlap=4),
        keyframe=KeyframeConfig(dist_thresh=0.5, angle_thresh=0.3,
                                capacity=48),
        loop=LoopConfig(max_candidates=4, local_half_extent=6.0,
                        min_index_gap=8),
        n_beams=120, use_loop_closure=True, window=8, window_passes=2)
    return cfg, seqs


def state_sha256(tree) -> str:
    """sha256 of a state's leaves in field order (each leaf's dtype, shape
    and bytes; ``None`` as a marker): equal digests mean bit-equal
    states."""
    h = hashlib.sha256()

    def walk(x):
        if x is None:
            h.update(b"None")
        elif isinstance(x, tuple):
            for y in x:
                walk(y)
        else:
            t = x.detach().contiguous().cpu()
            h.update(f"{t.dtype}{tuple(t.shape)}".encode())
            h.update(t.reshape(-1).view(torch.uint8).numpy().tobytes())

    walk(tree)
    return h.hexdigest()


def _slam_worker(args, device: str) -> None:
    """``--task slam``: one full windowed SLAM session per process over the
    process-spanning ``"batch"`` mesh (the reference's ``_slam_worker``:
    the same sessions built on every process, each process running its
    own; no collective). Each rank writes its rows to ``<out>.p<rank>``;
    after a barrier rank 0 merges them into the report."""
    from ndtpu_torch import kernels
    from ndtpu_torch.dist import mesh as dmesh
    from ndtpu_torch.dist import slam_dp
    from ndtpu_torch.eval.ate import ate_rmse
    from ndtpu_torch.slam import pipeline

    mesh = dmesh.batch_mesh(device)
    dev = mesh.device
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    n_scans = max(24, args.n_poses)
    cfg, seqs = slam_sessions(mesh.size, n_scans)
    pts, msk, odo = (torch.stack([getattr(q, k) for q in seqs]).to(dev)
                     for k in ("points", "mask", "odom"))
    _sync(dev)
    kernels.reset_launches()
    t0 = time.perf_counter()
    st, outs = slam_dp.run_sessions_sharded(mesh, pts, msk, odo, cfg)
    _sync(dev)
    dt = time.perf_counter() - t0
    launches = {k: v for k, v in kernels.LAUNCHES.items() if v}

    mine = []
    per = st.kf.n.shape[0]
    for k in range(per):
        sess = mesh.rank * per + k
        st_k = slam_dp._take(st, k)
        traj = pipeline.recover_trajectory(st_k, slam_dp._take(outs, k))
        mine.append({"session": sess, "keyframes": int(st_k.kf.n),
                     "ate": float(ate_rmse(traj.cpu(),
                                           seqs[sess].gt_poses)),
                     "state_sha256": state_sha256(st_k), "run_s": dt,
                     "launches": launches})
    base = args.out or os.path.join(tempfile.gettempdir(),
                                    "ndtpu_torch_slam_rehearsal")
    Path(f"{base}.p{mesh.rank}").write_text(json.dumps(mine))
    if mesh.size > 1:
        torch.distributed.barrier()
    if mesh.rank == 0:
        rows = []
        for pid in range(mesh.size):
            part = Path(f"{base}.p{pid}")
            rows += json.loads(part.read_text())
            part.unlink()
        rows.sort(key=lambda r: r["session"])
        rec = {"task": "slam", "num_processes": mesh.size,
               "n_devices": mesh.size, "n_scans": n_scans,
               "compile_and_run_s": dt,
               "keyframes": [r["keyframes"] for r in rows],
               "ates": [r["ate"] for r in rows],
               "state_sha256": [r["state_sha256"] for r in rows],
               "device": (torch.cuda.get_device_name(dev)
                          if dev.type == "cuda" else "cpu"),
               "sessions": rows}
        line = json.dumps(rec)
        print(line, flush=True)
        if args.out:
            Path(args.out).write_text(line)


def save_graph_npz(path: str, graph) -> None:
    """Serialize a PoseGraph to npz (integers as int32, as the JAX package
    keeps them)."""
    from ndtpu_torch import convert

    np.savez(path, **convert.to_numpy(graph)._asdict())


def load_graph_npz(path: str, device="cpu"):
    """Inverse of :func:`save_graph_npz` (either package's file): the
    port's ``PoseGraph`` on ``device``."""
    from ndtpu_torch.graph import factors as fct

    d = np.load(path)
    out = {}
    for k in fct.PoseGraph._fields:
        a = np.asarray(d[k])
        out[k] = torch.as_tensor(a.astype(np.int64) if a.dtype.kind in "iu"
                                 else a, device=device)
    return fct.PoseGraph(**out)


def launch_local(num_processes: int = 2, n_poses: int = 120,
                 timeout_s: float = 600.0, port: int = 29511,
                 graph_npz: str = "", task: str = "schur",
                 device: str = "cuda") -> dict:
    """Spawn N local worker processes and return rank 0's report.

    Each worker is a fresh interpreter that finds the repository on its
    path; ``device="cuda"`` puts every rank on the machine's cards (round
    robin; on one card they share it), after the parent has built the
    kernels. A worker that fails or outlives ``timeout_s`` stops them all
    and raises."""
    if device.startswith("cuda"):
        _device(device)
        from ndtpu_torch import kernels
        kernels.build()
    env = dict(os.environ)
    pp = [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p]
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT)] + pp)
    out_dir = tempfile.mkdtemp(prefix="ndtpu_torch_launch_")
    out_path = os.path.join(out_dir, "rank0.json")
    procs = []
    try:
        for pid in range(num_processes):
            cmd = [sys.executable, "-m", "ndtpu_torch.dist.launch",
                    "--coordinator", f"localhost:{port}",
                    "--num-processes", str(num_processes),
                    "--process-id", str(pid), "--n-poses", str(n_poses),
                    "--task", task, "--device", device]
            if graph_npz:
                cmd += ["--graph-npz", graph_npz]
            cmd += ["--out", out_path]         # rank 0 writes the report
            procs.append(subprocess.Popen(cmd, env=env, cwd=str(ROOT),
                                          stdout=subprocess.PIPE,
                                          stderr=subprocess.PIPE, text=True))
        deadline = time.monotonic() + timeout_s
        outs = [p.communicate(timeout=max(1.0, deadline - time.monotonic()))
                for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, (so, se) in zip(procs, outs):
        if p.returncode != 0:
            raise RuntimeError(
                f"worker {p.args} failed rc={p.returncode}\n{so}\n{se}")
    with open(out_path) as f:
        rec = json.load(f)
    os.remove(out_path)
    os.rmdir(out_dir)
    return rec


if __name__ == "__main__":
    worker_main()
