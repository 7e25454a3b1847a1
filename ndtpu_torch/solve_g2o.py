"""Standalone pose-graph optimizer CLI (config 4; GTSAM's
``Pose2SLAMExample_g2o`` workflow).

Usage::

    python -m ndtpu_torch.solve_g2o input.g2o [-o optimized.g2o]
        [--method auto|dense|pcg|supernodal] [--shards 64] [--huber 0]
        [--max-iter 50] [--toro] [--manhattan N] [--seed 0]
        [--device cuda|cpu]

Port of ``ndtpu/solve_g2o.py``: reads a g2o (or TORO) 2D pose graph, or
generates an N-pose Manhattan world with ``--manhattan N`` (its poses
jittered by N(0, 0.05) from ``--seed``), optimizes it in f32 with the
chosen solver (``auto``: dense up to 2,000 poses, supernodal up to 20,000,
else PCG), prints chi^2 before and after and the time to stderr, and
writes the optimized graph as g2o with ``-o``. ``--device cuda`` (the
default) runs on the card and fails without one: K5 linearizes, the
supernodal step runs K9a and K9b, each PCG solve runs K6 (graphs that fit
one block) or K6g (larger ones: ``--manhattan 10000 --method pcg``, and
``auto`` above 20,000 poses). ``--device cpu`` runs the plain versions.
``main`` returns the run's numbers as a dict.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from ndtpu_torch.run import _device, _sync


def manhattan_data(n_poses: int, seed: int):
    """``--manhattan``'s graph: ``manhattan_world(n_poses, seed,
    loop_prob=0.1)`` with its poses jittered by N(0, 0.05) from
    ``default_rng(seed)`` (bench.py's BA graph at 10,000 poses, seed 0)."""
    from ndtpu_torch.data import g2o

    data = g2o.manhattan_world(n_poses, seed=seed, loop_prob=0.1)
    rng = np.random.default_rng(seed)
    return data._replace(
        poses=data.poses + rng.normal(0, 0.05, data.poses.shape))


def check_full_f32() -> None:
    """f32 products must stay full f32 (TF32 keeps ~3 digits): raise if
    TF32 matmuls are allowed. Nothing in the port changes either setting."""
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise RuntimeError(
            "TF32 matmuls are on (torch.backends.cuda.matmul.allow_tf32 / "
            "torch.set_float32_matmul_precision): the supernodal step needs "
            "full f32 products")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("input", nargs="?", default=None,
                    help="g2o/TORO file (omit with --manhattan)")
    ap.add_argument("-o", "--output", default=None,
                    help="write the optimized graph as g2o")
    ap.add_argument("--method", default="auto",
                    choices=("auto", "dense", "pcg", "supernodal"),
                    help="auto: dense <=2k poses, supernodal <=20k, "
                         "else pcg")
    ap.add_argument("--shards", type=int, default=64,
                    help="supernodal partition count")
    ap.add_argument("--huber", type=float, default=0.0,
                    help="Huber threshold in whitened units (0 = LS)")
    ap.add_argument("--max-iter", type=int, default=50)
    ap.add_argument("--toro", action="store_true",
                    help="input is TORO format")
    ap.add_argument("--manhattan", type=int, default=0,
                    help="generate an N-pose Manhattan world instead of "
                         "reading a file")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels; fails without a card) or cpu "
                         "(the plain versions)")
    args = ap.parse_args(argv)
    dev = _device(args.device)
    check_full_f32()

    from ndtpu_torch.config import SolverConfig
    from ndtpu_torch.data import g2o
    from ndtpu_torch.graph import factors as fct
    from ndtpu_torch.graph import solve as slv
    from ndtpu_torch.graph import supernodal as sn

    if args.manhattan:
        data = manhattan_data(args.manhattan, args.seed)
        src = f"manhattan({args.manhattan})"
    elif args.input:
        data = (g2o.read_toro(args.input) if args.toro
                else g2o.read_g2o(args.input))
        src = args.input
    else:
        ap.error("give an input file or --manhattan N")

    g = g2o.to_graph(data, dtype=torch.float32, device=dev)
    v, f = g.poses.shape[0], g.bet_i.shape[0]
    method = args.method
    if method == "auto":
        method = "dense" if v <= 2000 else (
            "supernodal" if v <= 20000 else "pcg")
    print(f"[solve_g2o] {src}: {v} poses, {f} between factors; "
          f"method={method}; device={dev}", file=sys.stderr)

    cfg = SolverConfig(max_iter=args.max_iter,
                       pcg_max_iter=max(250, args.max_iter * 10))
    chi0 = float(fct.chi2(g, args.huber))
    _sync(dev)
    t0 = time.perf_counter()
    if method == "supernodal":
        res = sn.optimize_supernodal(g, cfg, n_shards=args.shards,
                                     huber_delta=args.huber)
    else:
        res = slv.optimize(g, cfg, method=method, huber_delta=args.huber)
    chi1 = float(res.chi2)
    poses = res.graph.poses.cpu().numpy()        # host read: a real fence
    secs = time.perf_counter() - t0
    n_iter, converged = int(res.n_iter), bool(res.converged)
    print(f"[solve_g2o] chi2 {chi0:.4g} -> {chi1:.4g} in {n_iter} iters, "
          f"{secs:.2f}s (converged={converged})", file=sys.stderr)

    if args.output:
        g2o.write_g2o(args.output,
                      data._replace(poses=poses[:v].astype(np.float64)))
        print(f"[solve_g2o] optimized graph -> {args.output}",
              file=sys.stderr)
    return dict(method=method, n_poses=v, n_between=f, chi2_initial=chi0,
                chi2_final=chi1, n_iter=n_iter, converged=converged,
                seconds=secs, poses=poses)


if __name__ == "__main__":
    main()
