"""Hand-written CUDA kernels for Hopper (``sm_90a``): build, bind, launch.

Twenty kernels carry the windowed pipeline with loop closure, the
pose-graph smoother, the large-graph supernodal solve, stacked
multi-session serving, config 5's merge and distributed solve, and its
slab-sharded map (ROADMAP Queue B):

============ =============================== =================================
name         source                          replaces (JAX, lowered by XLA)
============ =============================== =================================
lm_ndt       ``csrc/lm_ndt.cu`` (K2 around   ``match._lm_run`` /
             K1)                             ``lm_loop_batch`` /
                                             ``match_batch_packed``: the
                                             whole LM loop, one launch
ndt_terms    ``csrc/ndt_terms.cu`` (K1)      ``grid.lookup_quad`` (or
                                             ``lookup_quad_grouped``) +
                                             ``match.point_terms_quad``
halfcell     ``csrc/halfcell_add.cu`` (K3)   ``grid._add_points_halfcell``
halfcell_    ``csrc/halfcell_add.cu`` (K3s)  the same over S maps (the vmaps
add_stacked                                  of ``add_points`` in
                                             ``dist/slam_dp.py``)
finalize     ``csrc/finalize_pack.cu`` (K4)  ``grid.finalize`` + ``pack_quad``
finalize_    ``csrc/finalize_pack.cu`` (K4s) the same over S maps
pack_stacked                                 (``slam_dp`` ``pack8``)
local_tables ``csrc/local_tables.cu`` (K8a)  ``closure.build_local_table``
                                             over a window's keyframes
loop_gate    ``csrc/loop_gate.cu`` (K8b)     ``closure._gate_and_pack``
factor_      ``csrc/factor_linearize.cu``    ``factors.linearize`` / ``chi2``,
linearize    (K5)                            ``incremental.fresh_residual_max``
                                             and the local path's gathered
                                             linearization and ``chi_local``
pcg_solve    ``csrc/pcg_solve.cu`` (K6)      ``solve.pcg_rhs`` (matvec,
                                             gradient, block diagonal,
                                             ``_inv3``, the loop): one launch
pcg_solve_   ``csrc/pcg_solve.cu`` (K6b)     ``solve.pcg_rhs_blocked``: S
blocked                                      sessions' PCGs, one block each
local_select ``csrc/local_system.cu`` (K7a)  ``incremental._active_probe`` +
                                             ``_local_select``
local_       ``csrc/local_system.cu`` (K7b)  ``schur.assemble_local_parts``
assemble                                     (``h_ii``, ``b_i`` only)
supernodal_  ``csrc/supernodal.cu`` (K9a)    ``supernodal._assemble_parts``
assemble
schur_reduce ``csrc/supernodal.cu`` (K9b)    ``supernodal.supernodal_delta``'s
                                             separator segment sums and
                                             damping
schur_local_ ``csrc/supernodal.cu`` (K9c)    ``dist/schur.py::
assemble                                     _schur_delta_local``'s
                                             ``assemble_local_parts`` and
                                             interior damping, per rank
ndt_sgh_     ``csrc/ndt_unpacked.cu`` (K12)  ``vmap(match.score_grad_hess)``
unpacked                                     over poses (``grid.lookup`` +
                                             ``match.point_terms``), as
                                             ``merge.global_align`` ranks
                                             its hypotheses
slab_        ``csrc/slab_accum.cu`` (K10a)   ``dist/gridmap.py::_accum_local``
accumulate                                   with ``_cell_xy`` and the slab
                                             masks of its two callers
finalize_    ``csrc/finalize_cells.cu``      ``grid.finalize`` on any layout
cells        (K10b)                          (``finalize_slab``)
slab_sgh     ``csrc/ndt_unpacked.cu`` (K10c) ``match_slab``'s per-rank terms
                                             (the 15 sums before its psum)
============ =============================== =================================

K5, K6 and K7b share the pose graph's arithmetic, ``csrc/pose_graph.cuh``
(``wrap``, the between error and Jacobians, whitening, the Huber weight,
``_inv3``, and block reductions in a fixed order): no float atomics, so
the smoother's results are the same on every launch. The graph wrappers
(``graph.factors.linearize`` / ``chi2`` / ``factor_linearize``,
``graph.solve.pcg_solve``, ``graph.incremental.local_select`` and
``fresh_residual_max``, ``dist.schur.assemble_local``,
``graph.supernodal.supernodal_assemble`` and ``schur_reduce``) send CPU
tensors to their plain versions and CUDA tensors here. K9a and K9b (and
K5 at config 4's 10k poses) carry the supernodal step; they route by tables
the host builds once per topology and sum each target in a fixed order.

K8b's steps live in ``csrc/loop_gate.cuh``, which ``lm_ndt`` also runs:
with ``gate=`` one ``lm_ndt`` launch verifies a loop window's ``K x C``
lanes and gates them (the gated verify, counted as ``lm_ndt_grouped`` and
as ``loop_gate_fused``); ``loop_gate`` alone gates registrations made
elsewhere.

K1's per-beam body and block reduction live in ``csrc/ndt_sums.cuh``;
``lm_ndt`` runs them once per LM iteration, so on the registration path K1
is not launched on its own. K3 and K8a share the map build's arithmetic,
``csrc/halfcell_fixed.cuh``: moments summed in 64-bit fixed point, so the
map statistics and the local tables are the same on every run (their plain
model is ``ndt.grid.halfcell_add_fixed_ref``). Shared-table launches count
as ``lm_ndt`` / ``ndt_terms``, grouped (per-lane table) launches as
``lm_ndt_grouped`` / ``ndt_terms_grouped``. The public wrappers
(``ndt.match.lm_ndt``, ``ndt.match.ndt_terms``, ``ndt.grid.halfcell_add``,
``ndt.grid.finalize_pack``, ``loop.closure.write_local_tables``,
``loop.closure.gate_and_pack``) send CPU tensors to their plain twins and
CUDA tensors here; nothing here falls back to a twin.

Build: the sources are compiled on first use, one ``nvcc`` per source in
parallel, into a shared library with a plain C interface (``-gencode
arch=compute_90a,code=sm_90a -O3 --fmad=false``), under
``<repo>/build/ndtpu_torch_ext/``, and bound with ``ctypes``. No PyTorch
header is compiled, so the build takes seconds.
``--fmad=false`` (and no ``--use_fast_math``) keeps every multiply and add
rounded on its own, as PyTorch's separate elementwise kernels round them:
the half-cell binning ``floor((x - x0) * inv)`` must give the twins' cells
at boundary points. Importing this module builds nothing and needs no
``nvcc``.

Each launch function checks device, dtype, shape and contiguity, launches
on PyTorch's current stream, raises if ``cudaGetLastError`` reports a
failure, and adds one to ``LAUNCHES[name]``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import NamedTuple

import torch

__all__ = ["LAUNCHES", "reset_launches", "build", "lm_ndt", "LoopGate",
           "GATE_MAX_LANES", "ndt_terms", "halfcell_add",
           "halfcell_add_stacked", "finalize_bands", "finalize_pack",
           "finalize_pack_stacked", "local_bands", "local_tables",
           "loop_gate", "factor_linearize", "fresh_residual_max",
           "pcg_solve", "pcg_solve_blocked", "local_select",
           "local_assemble", "supernodal_assemble", "schur_reduce",
           "schur_local_assemble", "ndt_sgh_unpacked", "slab_accumulate",
           "finalize_cells", "slab_sgh"]

#: Launch counts per kernel since the last :func:`reset_launches`.
LAUNCHES = {"lm_ndt": 0, "lm_ndt_grouped": 0, "ndt_terms": 0,
            "ndt_terms_grouped": 0, "halfcell_add": 0,
            "halfcell_add_stacked": 0, "finalize_pack": 0,
            "finalize_pack_stacked": 0, "local_tables": 0, "loop_gate": 0,
            "loop_gate_fused": 0, "factor_linearize": 0, "pcg_solve": 0,
            "pcg_solve_blocked": 0, "local_select": 0, "local_assemble": 0,
            "supernodal_assemble": 0, "schur_reduce": 0,
            "schur_local_assemble": 0, "ndt_sgh_unpacked": 0,
            "slab_accumulate": 0, "finalize_cells": 0, "slab_sgh": 0}

#: Shared memory one block can have on Hopper (227 KB), and what it gets
#: without ``cudaFuncSetAttribute`` (48 KB).
SMEM_MAX = 232448
SMEM_BLOCK = 49152

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "ndtpu_torch_ext"
_ARCH = "-gencode=arch=compute_90a,code=sm_90a"
_FLAGS = ["-O3", _ARCH, "-std=c++17", "--fmad=false", "-Xptxas=-v",
          "-Xcompiler", "-fPIC"]
_lib = None
_HALFCELL_SCRATCH: dict = {}     # (device index, maps, wh, hh) -> lattices
_GATE_ARRIVE: dict = {}          # (device index, K) -> int32 counters
_FINALIZE_BANDS: dict = {}       # (grid, device index) -> K4 launch shape
_SM_COUNT: dict = {}             # device index -> multiprocessors
_SLAB_SCRATCH: dict = {}         # (device index, width, ny) -> int64 sums

_P, _I, _F, _D = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                  ctypes.c_double)
_SIGNATURES = {
    "lm_ndt_launch": [_P] * 11 + [_I] * 7 + [_F] * 12 + [_P] * 6 + [_I]
                     + [_F] * 3 + [_I, _I, _P],
    "ndt_terms_launch": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                         _F, _F, _F, _F, _F, _P],
    "halfcell_add_launch": [_P, _P, _P, _F] + [_P] * 7 + [_I] * 4 + [_D] * 4
                           + [_P],
    "finalize_pack_launch": [_P] * 4 + [_I] * 6 + [_F] * 3 + [_I, _P],
    "local_tables_launch": [_P] * 5 + [_I] * 7 + [_D] * 4 + [_F] * 3
                           + [_I, _P],
    "loop_gate_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                         _F, _F, _F, _I, _P],
    "factor_linearize_launch": [_P] * 8 + [_I] * 3 + [_P] * 4 + [_I, _F]
                               + [_P] * 7,
    "pcg_solve_launch": [_P, _P, _P, _I, _P, _P, _I, _P, _I] + [_P] * 7
                        + [_F, _F, _I, _F] + [_P] * 3 + [_I, _P],
    "pcg_solve_blocked_launch": [_P, _P, _P, _I, _P, _P, _I, _P, _I]
                                + [_P] * 7 + [_I, _P, _I, _I, _P],
    "local_select_launch": [_P, _P, _P, _I, _P, _I, _P, _P, _I, _P, _P]
                           + [_I] * 7 + [_P] * 3,
    "local_assemble_launch": [_P, _P, _P, _I, _P, _P, _I] + [_P] * 8
                             + [_I, _P, _P, _P],
    "supernodal_assemble_launch": [_P] * 5 + [_I] + [_P] * 6 + [_I] * 4
                                  + [_P] * 6,
    "schur_reduce_launch": [_P] * 9 + [_F, _I, _I, _P, _P, _P],
    "schur_local_assemble_launch": [_P] * 5 + [_I] + [_P] * 7
                                   + [_F, _I, _I] + [_P] * 6,
    "ndt_sgh_unpacked_launch": [_P] * 7 + [_I] * 4 + [_F] * 5 + [_P],
    "slab_accum_launch": [_P] * 6 + [_I] * 5 + [_D] * 3 + [_P],
    "finalize_cells_launch": [_P] * 6 + [ctypes.c_longlong] + [_F] * 3
                             + [_P],
    "slab_sgh_launch": [_P] * 7 + [_I] * 6 + [_F] * 5 + [_P],
}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "are built from source on first use")
    return str(path)


def build() -> float:
    """Compile (if needed) and load the kernel library; returns seconds.

    Each ``csrc/*.cu`` is compiled to an object by its own ``nvcc``, all
    started together, then one ``nvcc -shared`` links them. The library name
    carries a hash of the sources and flags, so an edited source never loads
    a stale build. The compilers' ``-Xptxas=-v`` reports (registers, shared
    memory, spills per kernel) are kept beside it in ``build.log``.
    """
    global _lib
    if _lib is not None:
        return 0.0
    t0 = time.perf_counter()
    sources = sorted(_CSRC.glob("*.cu"))   # ``*.cuh`` are included
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for p in sorted(_CSRC.iterdir()):
        h.update(p.name.encode() + p.read_bytes())
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = BUILD_DIR / f"libndtpu_kernels_{h.hexdigest()[:16]}.so"
    if not so.exists():
        tag = f"{h.hexdigest()[:16]}.{os.getpid()}"
        objs = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in sources]
        cmds = [[_nvcc(), *_FLAGS, "-c", str(src), "-o", str(obj)]
                for src, obj in zip(sources, objs)]
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for c in cmds]
        outs = [p.communicate()[0] for p in procs]
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        link = [_nvcc(), _ARCH, "-shared", "-o", str(tmp), *map(str, objs)]
        log = [" ".join(c) + "\n" + o for c, o in zip(cmds, outs)]
        failed = [c for c, p in zip(cmds, procs) if p.returncode != 0]
        if not failed:
            proc = subprocess.run(link, capture_output=True, text=True)
            log.append(" ".join(link) + "\n" + proc.stdout + proc.stderr)
            if proc.returncode != 0:
                failed.append(link)
        (BUILD_DIR / "build.log").write_text("".join(log))
        for obj in objs:
            obj.unlink(missing_ok=True)
        if failed:
            raise RuntimeError("nvcc failed:\n" + "".join(log)[-4000:])
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    for name, args in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    lib.ndtpu_cuda_error_string.argtypes = [ctypes.c_int]
    lib.ndtpu_cuda_error_string.restype = ctypes.c_char_p
    _lib = lib
    return time.perf_counter() - t0


#: What a one-block launcher (``csrc/pose_graph.cuh``) returns when its
#: kernel's shared memory, which it computes itself, is over what a block
#: can opt in to; ``_call`` raises ``ValueError(too_big)`` for it.
_SMEM_OVER = -1


def _call(name: str, counter: str, *args, too_big: str = "") -> None:
    if _lib is None:
        build()
    err = getattr(_lib, name)(*args)
    if err == _SMEM_OVER:
        raise ValueError(f"{name}: {too_big}")
    if err != 0:
        msg = _lib.ndtpu_cuda_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")
    LAUNCHES[counter] += 1


def _check(t: torch.Tensor, what: str, dtype=torch.float32, shape=None,
           align: int = 4):
    if not t.is_cuda:
        raise ValueError(f"{what}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{what}: the kernel takes {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous tensor")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if t.data_ptr() % align:
        raise ValueError(f"{what}: the kernel reads it in {align}-byte "
                         f"vectors; pass a tensor aligned to {align} bytes")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _lattice(grid):
    if grid.overlap != 4:
        raise NotImplementedError(
            "the CUDA kernels take overlap=4 grids only; overlap=1 on the "
            "card is ROADMAP Queue B (K1/K3/K4 overlap=1 tables)")
    return 2 * grid.nx + 1, 2 * grid.ny + 1


def ndt_terms(poses, px, py, mask_f, table, grid, d2: float,
              exp_clip: float, group=None) -> torch.Tensor:
    """K1: the 11 NDT sums ``[B, 11]`` per lane (see ``csrc/ndt_terms.cu``).

    ``table`` is one shared ``[R, 32]`` table, or with ``group`` (int32
    ``[B]``) a stack ``[S, R, 32]`` of which lane ``b`` reads table
    ``group[b]`` (the kernel clamps it into ``[0, S)``)."""
    wh, hh = _lattice(grid)
    b, n = px.shape
    _check(poses, "poses", shape=(b, 3))
    _check(px, "px")
    _check(py, "py", shape=(b, n))
    _check(mask_f, "mask", shape=(b, n))
    n_tables, g_ptr, grouped = _table_args(table, group, b, wh, hh)
    counter = "ndt_terms_grouped" if grouped else "ndt_terms"
    out = torch.empty((b, 11), dtype=torch.float32, device=px.device)
    if b == 0:
        return out.zero_()
    _call("ndt_terms_launch", counter, poses.data_ptr(), px.data_ptr(),
          py.data_ptr(), mask_f.data_ptr(), table.data_ptr(), g_ptr,
          out.data_ptr(), b, n, wh, hh, wh * hh, n_tables, grid.x0, grid.y0,
          2.0 / grid.cell, d2, exp_clip, _stream(px))
    return out


def _table_args(table, group, b: int, wh: int, hh: int):
    """Check a shared ``[R, 32]`` table, or a stack ``[S, R, 32]`` with an
    int32 ``group [B]``; returns ``(n_tables, group pointer, grouped)``."""
    if group is None:
        _check(table, "table", shape=(wh * hh, 32), align=16)
        return 1, None, False
    _check(group, "group", dtype=torch.int32, shape=(b,))
    _check(table, "tables", shape=(table.shape[0], wh * hh, 32), align=16)
    return table.shape[0], group.data_ptr(), True


class LoopGate(NamedTuple):
    """The loop gate's inputs beside a verify's registrations, for the
    gated :func:`lm_ndt`: ``cand_mask`` bool ``[K, C]`` (candidate slot is
    real), ``query_idx`` int64 ``[K]``; ``innov_per_kf <= 0`` and
    ``k_budget = 0`` switch those gates off (see ``csrc/loop_gate.cuh``)."""

    cand_mask: torch.Tensor
    query_idx: torch.Tensor
    score_gate: float
    innov_base: float
    innov_per_kf: float
    k_budget: int


#: The most candidates per query the gate takes: one thread per candidate
#: within a block of ``lm_ndt`` (and of the standalone gate).
GATE_MAX_LANES = 128


def _gate_width(c: int) -> int:
    if c > GATE_MAX_LANES:
        raise ValueError(
            f"loop gate: {c} candidates per query; the gate runs one thread "
            f"per candidate within one block of {GATE_MAX_LANES} threads "
            f"(LoopConfig.max_candidates <= {GATE_MAX_LANES})")
    return c


def _gate_arrive(dev: torch.device, k: int) -> torch.Tensor:
    """The gated verify's int32 ``[K]`` arrival counters, allocated (and
    zeroed) once per (device, K) and kept: every launch leaves them at 0
    (``csrc/lm_ndt.cu``). The port launches on one stream, so two launches
    never use them at once."""
    key = (dev.index, k)
    buf = _GATE_ARRIVE.get(key)
    if buf is None:
        buf = torch.zeros(k, dtype=torch.int32, device=dev)
        _GATE_ARRIVE[key] = buf
    return buf


def lm_ndt(init_poses, px, py, mask_f, table, grid, cfg, group=None,
           gate: LoopGate | None = None):
    """K2 around K1: every lane's whole LM registration in one launch (see
    ``csrc/lm_ndt.cu``). Returns ``(pose [B,3], hessian [B,3,3], score [B],
    n_iter [B] int32, converged [B] bool)``.

    ``cfg`` is a ``MatchConfig`` (read by attribute; ``max_iter`` is the
    cap); ``table`` and ``group`` are as for :func:`ndt_terms`. With
    ``gate`` (``K`` queries x ``C <= 128`` candidates, ``B = K * C``,
    ``group`` = the candidates' indices) the same launch also gates the
    lanes as :func:`loop_gate` does, bit for bit, and three more outputs
    follow: ``accept [K, C]``, ``innov_rej [K, C]`` bool and ``sqrt_info
    [K, C, 3, 3]``. Nothing is read back to the host."""
    if gate is not None:
        _gate_width(gate.cand_mask.shape[-1])
    wh, hh = _lattice(grid)
    b, n = px.shape
    _check(init_poses, "init_poses", shape=(b, 3))
    _check(px, "px")
    _check(py, "py", shape=(b, n))
    _check(mask_f, "mask", shape=(b, n))
    n_tables, g_ptr, grouped = _table_args(table, group, b, wh, hh)
    smem = 3 * n * 4
    if smem > SMEM_MAX - 1024:
        raise ValueError(f"lm_ndt: {n} beams need {smem} B of shared memory, "
                         f"over what a block can have")
    dev = px.device
    pose = torch.empty((b, 3), dtype=torch.float32, device=dev)
    hess = torch.empty((b, 3, 3), dtype=torch.float32, device=dev)
    score = torch.empty((b,), dtype=torch.float32, device=dev)
    n_iter = torch.empty((b,), dtype=torch.int32, device=dev)
    conv = torch.empty((b,), dtype=torch.bool, device=dev)
    outs = (pose, hess, score, n_iter, conv)
    gate_args = [None] * 6 + [0, 0.0, 0.0, 0.0, 0]
    if gate is not None:
        k, c = gate.cand_mask.shape
        if not grouped or k * c != b:
            raise ValueError(f"lm_ndt: the gate takes K x C = {k} x {c} "
                             f"lanes of a grouped launch, got {b} lanes"
                             + ("" if grouped else " and no group"))
        _check(gate.cand_mask, "cand_mask", dtype=torch.bool, shape=(k, c),
               align=1)
        _check(gate.query_idx, "query_idx", dtype=torch.int64, shape=(k,))
        accept = torch.empty((k, c), dtype=torch.bool, device=dev)
        innov_rej = torch.empty((k, c), dtype=torch.bool, device=dev)
        sqrt_info = torch.empty((k, c, 3, 3), dtype=torch.float32, device=dev)
        outs += (accept, innov_rej, sqrt_info)
        gate_args = [gate.cand_mask.data_ptr(), gate.query_idx.data_ptr(),
                     accept.data_ptr(), innov_rej.data_ptr(),
                     sqrt_info.data_ptr(), _gate_arrive(dev, k).data_ptr(), c,
                     gate.score_gate, gate.innov_base, gate.innov_per_kf,
                     gate.k_budget]
    if b > 0:
        _call("lm_ndt_launch", "lm_ndt_grouped" if grouped else "lm_ndt",
              init_poses.data_ptr(), px.data_ptr(), py.data_ptr(),
              mask_f.data_ptr(), table.data_ptr(), g_ptr, pose.data_ptr(),
              hess.data_ptr(), score.data_ptr(), n_iter.data_ptr(),
              conv.data_ptr(), b, n, wh, hh, wh * hh, n_tables,
              int(cfg.max_iter), grid.x0, grid.y0, 2.0 / grid.cell, cfg.d2,
              cfg.exp_clip, cfg.tol, cfg.reject_tol, cfg.init_lambda,
              cfg.lambda_up, cfg.lambda_down, cfg.max_lambda, cfg.step_clip,
              *gate_args, smem, _stream(px))
        if gate is not None:
            LAUNCHES["loop_gate_fused"] += 1
    return outs


def _halfcell_scratch(dev: torch.device, wh: int, hh: int,
                      maps: int = 1) -> torch.Tensor:
    """K3's int64 ``[maps, hh * wh, 6]`` lattices, allocated once per
    (device, map count, lattice shape) and kept: every call zeroes them on
    its own stream first. The port runs on one stream, so two calls never
    use them at once; sessions on streams of their own would need one per
    stream (ROADMAP C-w6)."""
    key = (dev.index, maps, wh, hh)
    buf = _HALFCELL_SCRATCH.get(key)
    if buf is None:
        buf = torch.empty(maps * hh * wh * 6, dtype=torch.int64, device=dev)
        _HALFCELL_SCRATCH[key] = buf
    return buf


def halfcell_add(n, s, ss, points, mask, weight, grid):
    """K3: ``(n, s, ss) + half-cell moments of points``, as new tensors.

    ``weight`` is a Python float or an f32 ``[M]`` tensor. The moments are
    summed in 64-bit fixed point (``csrc/halfcell_fixed.cuh``), so the
    result is the same on every run and under any order of the points, and
    equals ``ndt.grid.halfcell_add_fixed_ref`` bit for bit. Each call is one
    ctypes call, which zeroes the kept lattice scratch, scatters and pools
    on the current stream, and one ``LAUNCHES["halfcell_add"]``.
    """
    wh, hh = _lattice(grid)
    c = grid.n_cells
    m = points.shape[0]
    _check(points, "points", shape=(m, 2), align=8)
    _check(mask, "mask", dtype=torch.bool, shape=(m,), align=1)
    _check(n, "stats.n", shape=(4, c))
    _check(s, "stats.s", shape=(4, c, 2))
    _check(ss, "stats.ss", shape=(4, c, 2, 2))
    if isinstance(weight, torch.Tensor):
        _check(weight, "weight", shape=(m,))
        w_ptr, w_scalar = weight.data_ptr(), 0.0
    else:
        w_ptr, w_scalar = None, float(weight)
    dev = points.device
    out = torch.empty(28 * c, dtype=torch.float32, device=dev)
    n2 = out[:4 * c].view(4, c)
    s2 = out[4 * c:12 * c].view(4, c, 2)
    ss2 = out[12 * c:].view(4, c, 2, 2)
    _call("halfcell_add_launch", "halfcell_add", points.data_ptr(),
          mask.data_ptr(), w_ptr, w_scalar,
          _halfcell_scratch(dev, wh, hh).data_ptr(), n.data_ptr(),
          s.data_ptr(), ss.data_ptr(), n2.data_ptr(), s2.data_ptr(),
          ss2.data_ptr(), 1, m, grid.nx, grid.ny, grid.x0, grid.y0,
          2.0 / grid.cell, grid.cell / 2.0, _stream(points))
    return n2, s2, ss2


def halfcell_add_stacked(n, s, ss, points, mask, weight, grid):
    """K3s: :func:`halfcell_add` for S maps in one ctypes call: statistics
    ``n [S, 4, C]``, ``s [S, 4, C, 2]``, ``ss [S, 4, C, 2, 2]``, points
    ``[S, M, 2]``, mask bool ``[S, M]``, weight a Python float or an f32
    ``[S, M]`` tensor. Map ``i`` gets exactly what :func:`halfcell_add` of
    its own points gives, bit for bit. One ``LAUNCHES
    ["halfcell_add_stacked"]`` per call."""
    wh, hh = _lattice(grid)
    c = grid.n_cells
    maps, m = mask.shape
    _check(points, "points", shape=(maps, m, 2), align=8)
    _check(mask, "mask", dtype=torch.bool, shape=(maps, m), align=1)
    _check(n, "stats.n", shape=(maps, 4, c))
    _check(s, "stats.s", shape=(maps, 4, c, 2))
    _check(ss, "stats.ss", shape=(maps, 4, c, 2, 2))
    if isinstance(weight, torch.Tensor):
        _check(weight, "weight", shape=(maps, m))
        w_ptr, w_scalar = weight.data_ptr(), 0.0
    else:
        w_ptr, w_scalar = None, float(weight)
    dev = points.device
    out = torch.empty(maps * 28 * c, dtype=torch.float32, device=dev)
    n2 = out[:maps * 4 * c].view(maps, 4, c)
    s2 = out[maps * 4 * c:maps * 12 * c].view(maps, 4, c, 2)
    ss2 = out[maps * 12 * c:].view(maps, 4, c, 2, 2)
    if maps == 0:
        return n2, s2, ss2
    _call("halfcell_add_launch", "halfcell_add_stacked",
          points.data_ptr(), mask.data_ptr(), w_ptr, w_scalar,
          _halfcell_scratch(dev, wh, hh, maps).data_ptr(), n.data_ptr(),
          s.data_ptr(), ss.data_ptr(), n2.data_ptr(), s2.data_ptr(),
          ss2.data_ptr(), maps, m, grid.nx, grid.ny, grid.x0, grid.y0,
          2.0 / grid.cell, grid.cell / 2.0, _stream(points))
    return n2, s2, ss2


def _finalize_smem(rows: int, nx: int) -> int:
    """K4's shared memory for a band of ``rows`` table rows: 4 grids x
    ``grid_stride`` cells x 32 B (``csrc/finalize_pack.cu``)."""
    cells = (rows // 2 + 1) * nx
    return 4 * (((cells + 2) & ~3) + 1) * 32


def finalize_bands(grid, device=None) -> tuple:
    """K4's launch shape on ``grid``: ``(band_rows, bands, threads, shared
    bytes)``. Bands as thin as the card holds at once (``bands`` within 8
    blocks per SM: one-row bands on an H100 at every published grid), each
    band's ``band_rows // 2 + 1`` cell rows of each of the 4 grids (32 B
    per cell) within the ``SMEM_BLOCK`` a block gets without an opt-in; one
    thread per such cell (whole warps, at most 512). A lattice so wide
    that one row needs more gets one-row bands and the opt-in (set once per
    process), up to ``SMEM_MAX``; past that it raises. ``device=None``
    checks the size only. Kept per (grid, device)."""
    key = (grid, None if device is None else device.index)
    shape = _FINALIZE_BANDS.get(key)
    if shape is not None:
        return shape
    wh, hh = _lattice(grid)
    one = _finalize_smem(1, grid.nx)
    if one > SMEM_MAX:
        raise ValueError(
            f"finalize_pack: a band of a {wh}-wide lattice needs {one} B of "
            f"shared memory, over the {SMEM_MAX} B a block can have")
    max_rows = 1
    while max_rows < hh and _finalize_smem(max_rows + 1, grid.nx) \
            <= SMEM_BLOCK:
        max_rows += 1
    resident = 1 if device is None else 8 * _sm_count(device)
    rows = min(max(1, -(-hh // resident)), max_rows)
    cells = 4 * (rows // 2 + 1) * grid.nx
    shape = (rows, -(-hh // rows), min(512, -(-cells // 32) * 32),
             _finalize_smem(rows, grid.nx))
    _FINALIZE_BANDS[key] = shape
    return shape


def finalize_pack(n, s, ss, ndt_cfg, grid) -> torch.Tensor:
    """K4: finalize every cell and write the quad table ``[R, 32]``, one
    block per band of table rows (:func:`finalize_bands`)."""
    wh, hh = _lattice(grid)
    c = grid.n_cells
    _check(n, "stats.n", shape=(4, c))
    _check(s, "stats.s", shape=(4, c, 2), align=8)
    _check(ss, "stats.ss", shape=(4, c, 2, 2), align=16)
    rows, bands, threads, smem = finalize_bands(grid, n.device)
    table = torch.empty((hh * wh, 32), dtype=torch.float32, device=n.device)
    _call("finalize_pack_launch", "finalize_pack", n.data_ptr(), s.data_ptr(),
          ss.data_ptr(), table.data_ptr(), 1, grid.nx, grid.ny, rows, bands,
          threads, float(ndt_cfg.min_pts), ndt_cfg.eig_ratio,
          ndt_cfg.eig_abs_min, smem, _stream(n))
    return table


def finalize_pack_stacked(n, s, ss, ndt_cfg, grid) -> torch.Tensor:
    """K4s: :func:`finalize_pack` of S maps in one launch (statistics with a
    leading ``S`` axis), each map cut into K4's bands; returns the tables
    ``[S, R, 32]``, table ``i`` bit-equal to :func:`finalize_pack` of map
    ``i``."""
    wh, hh = _lattice(grid)
    c = grid.n_cells
    maps = n.shape[0]
    _check(n, "stats.n", shape=(maps, 4, c))
    _check(s, "stats.s", shape=(maps, 4, c, 2), align=8)
    _check(ss, "stats.ss", shape=(maps, 4, c, 2, 2), align=16)
    table = torch.empty((maps, hh * wh, 32), dtype=torch.float32,
                        device=n.device)
    if maps == 0:
        return table
    rows, bands, threads, smem = finalize_bands(grid, n.device)
    _call("finalize_pack_launch", "finalize_pack_stacked",
          n.data_ptr(), s.data_ptr(), ss.data_ptr(), table.data_ptr(), maps,
          grid.nx, grid.ny, rows, bands, threads, float(ndt_cfg.min_pts),
          ndt_cfg.eig_ratio, ndt_cfg.eig_abs_min, smem, _stream(n))
    return table


def local_bands(w: int, grid, device) -> tuple:
    """K8a's launch shape for ``w`` keyframes on ``grid``: ``(band_rows,
    bands, shared bytes)``. Bands as thin as the card can hold at once
    (``w x bands`` blocks of 256 threads within 8 per SM; one table row
    each at a window's ``w``), each band's ``band_rows + 2`` lattice rows
    of int64 sums (48 B per half-cell) within ``SMEM_BLOCK``; raises where
    even one row does not fit. ``device=None`` checks the size only."""
    wh, hh = _lattice(grid)
    row_bytes = wh * 6 * 8
    max_rows = SMEM_BLOCK // row_bytes - 2
    if max_rows < 1:
        raise ValueError(
            f"local_tables: a band of a {wh}-wide lattice needs at least "
            f"{3 * row_bytes} B of shared memory, over the {SMEM_BLOCK} B a "
            f"block gets without an opt-in; use a smaller "
            f"LoopConfig.local_half_extent or a larger local_cell")
    resident = 1 if device is None else 8 * _sm_count(device)
    rows = min(max(1, -(-w * hh // resident)), max_rows)
    return rows, -(-hh // rows), (rows + 2) * row_bytes


def _sm_count(dev: torch.device) -> int:
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx not in _SM_COUNT:
        _SM_COUNT[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return _SM_COUNT[idx]


def local_tables(tables, slot, ok, points, mask, grid, ndt_cfg):
    """K8a: for every keyframe ``w`` with ``ok[w]``, build its local quad
    table from ``points[w]`` (sensor frame) on ``grid`` and write it into
    ``tables[slot[w]]`` in place (see ``csrc/local_tables.cu``). Returns
    ``tables``. ``slot`` is int32; slots outside the cache are skipped.
    Each table equals :func:`finalize_pack` of :func:`halfcell_add` of its
    scan on empty statistics, bit for bit, on every run."""
    wh, hh = _lattice(grid)
    local_bands(0, grid, None)       # an oversized lattice raises first
    w, n = mask.shape
    _check(points, "points", shape=(w, n, 2), align=8)
    _check(mask, "mask", dtype=torch.bool, shape=(w, n), align=1)
    _check(slot, "slot", dtype=torch.int32, shape=(w,))
    _check(ok, "ok", dtype=torch.bool, shape=(w,), align=1)
    _check(tables, "tables", shape=(tables.shape[0], wh * hh, 32), align=16)
    if w > 0:
        rows, bands, smem = local_bands(w, grid, points.device)
        _call("local_tables_launch", "local_tables", points.data_ptr(),
              mask.data_ptr(), slot.data_ptr(), ok.data_ptr(),
              tables.data_ptr(), w, n, grid.nx, grid.ny, tables.shape[0],
              rows, bands, grid.x0, grid.y0, 2.0 / grid.cell,
              grid.cell / 2.0, float(ndt_cfg.min_pts), ndt_cfg.eig_ratio,
              ndt_cfg.eig_abs_min, smem, _stream(points))
    return tables


def loop_gate(cand_mask, converged, score, pose, init, hessian, cand_idx,
              query_idx, score_gate: float, innov_base: float,
              innov_per_kf: float, k_budget: int):
    """K8b: the loop gate of ``K`` queries x ``C <= 128`` candidates over
    registrations made elsewhere (see ``csrc/loop_gate.cu``).
    ``cand_mask``/``converged`` bool ``[K, C]``, ``score [K, C]``,
    ``pose``/``init [K, C, 3]``, ``hessian [K, C, 3, 3]`` f32, ``cand_idx``
    int64 ``[K, C]``, ``query_idx`` int64 ``[K]``; ``innov_per_kf <= 0`` and
    ``k_budget = 0`` switch those gates off. Returns ``(accept, innov_rej,
    sqrt_info [K, C, 3, 3])``."""
    k, c = score.shape
    _gate_width(c)
    _check(cand_mask, "cand_mask", dtype=torch.bool, shape=(k, c), align=1)
    _check(converged, "converged", dtype=torch.bool, shape=(k, c), align=1)
    _check(score, "score")
    _check(pose, "pose", shape=(k, c, 3))
    _check(init, "init", shape=(k, c, 3))
    _check(hessian, "hessian", shape=(k, c, 3, 3))
    _check(cand_idx, "cand_idx", dtype=torch.int64, shape=(k, c))
    _check(query_idx, "query_idx", dtype=torch.int64, shape=(k,))
    dev = score.device
    accept = torch.empty((k, c), dtype=torch.bool, device=dev)
    innov_rej = torch.empty((k, c), dtype=torch.bool, device=dev)
    sqrt_info = torch.empty((k, c, 3, 3), dtype=torch.float32, device=dev)
    if k * c > 0:
        _call("loop_gate_launch", "loop_gate", cand_mask.data_ptr(),
              converged.data_ptr(), score.data_ptr(), pose.data_ptr(),
              init.data_ptr(), hessian.data_ptr(), cand_idx.data_ptr(),
              query_idx.data_ptr(), accept.data_ptr(), innov_rej.data_ptr(),
              sqrt_info.data_ptr(), k, c, score_gate, innov_base,
              innov_per_kf, k_budget, _stream(score))
    return accept, innov_rej, sqrt_info


def _check_graph(bet_i, bet_j, bet_mask, prior_idx, prior_mask):
    """The pose graph's index and mask arrays (int64 / bool, contiguous)."""
    f, p = bet_i.shape[0], prior_idx.shape[0]
    _check(bet_i, "bet_i", dtype=torch.int64, shape=(f,))
    _check(bet_j, "bet_j", dtype=torch.int64, shape=(f,))
    _check(bet_mask, "bet_mask", dtype=torch.bool, shape=(f,), align=1)
    _check(prior_idx, "prior_idx", dtype=torch.int64, shape=(p,))
    _check(prior_mask, "prior_mask", dtype=torch.bool, shape=(p,), align=1)
    return f, p


def _lin_call(poses, bet_i, bet_j, bet_z, bet_sqrt_info, row_mask, fid,
              n_between, rows, window, prior_idx, prior_z, prior_sqrt_info,
              prior_mask, huber_delta, jac):
    """One K5 call: ``(scalars [2 + 2 * blocks], f32 outputs or None)``."""
    v, f, p = poses.shape[0], bet_i.shape[0], prior_idx.shape[0]
    _check(poses, "poses", shape=(v, 3))
    _check(bet_i, "bet_i", dtype=torch.int64, shape=(f,))
    _check(bet_j, "bet_j", dtype=torch.int64, shape=(f,))
    _check(bet_z, "bet_z", shape=(f, 3))
    _check(bet_sqrt_info, "bet_sqrt_info", shape=(f, 3, 3))
    _check(prior_idx, "prior_idx", dtype=torch.int64, shape=(p,))
    _check(prior_z, "prior_z", shape=(p, 3))
    _check(prior_sqrt_info, "prior_sqrt_info", shape=(p, 3, 3))
    _check(prior_mask, "prior_mask", dtype=torch.bool, shape=(p,), align=1)
    dev = poses.device
    blocks = -(-rows // 256)
    scal = torch.empty(2 + 2 * blocks, dtype=torch.float32, device=dev)
    out = ptrs = None
    if jac:
        out = torch.empty(21 * rows + 12 * p, dtype=torch.float32, device=dev)
        ptrs = [out.data_ptr() + 4 * o for o in
                (0, 9 * rows, 18 * rows, 21 * rows, 21 * rows + 9 * p)]
    _call("factor_linearize_launch", "factor_linearize", poses.data_ptr(),
          bet_i.data_ptr(), bet_j.data_ptr(), bet_z.data_ptr(),
          bet_sqrt_info.data_ptr(), row_mask.data_ptr(),
          None if fid is None else fid.data_ptr(),
          None if n_between is None else n_between.data_ptr(), rows, window,
          f, prior_idx.data_ptr(), prior_z.data_ptr(),
          prior_sqrt_info.data_ptr(), prior_mask.data_ptr(), p,
          float(huber_delta), *(ptrs or [None] * 5), scal.data_ptr(),
          _stream(poses))
    return scal, out


def factor_linearize(poses, bet_i, bet_j, bet_z, bet_sqrt_info, row_mask,
                     prior_idx, prior_z, prior_sqrt_info, prior_mask,
                     huber_delta: float, fid=None, chi_only: bool = False):
    """K5: the whitened, Huber-weighted (``huber_delta > 0``), masked
    linearization of the between factors (every slot, or the gathered
    slots ``fid`` int64 ``[K]``) and the priors (see
    ``csrc/factor_linearize.cu``). ``row_mask`` is bool ``[F]`` (or ``[K]``
    with ``fid``), ``prior_mask`` bool ``[P]``. Returns ``((ai [K,3,3], aj,
    r [K,3]), (ap [P,3,3], rp [P,3]))``, or with ``chi_only`` only chi^2
    ``[]``, summed in a fixed order."""
    rows = bet_i.shape[0] if fid is None else fid.shape[0]
    if fid is not None:
        _check(fid, "fid", dtype=torch.int64, shape=(rows,))
    _check(row_mask, "row_mask", dtype=torch.bool, shape=(rows,), align=1)
    scal, out = _lin_call(poses, bet_i, bet_j, bet_z, bet_sqrt_info,
                          row_mask, fid, None, rows, 0, prior_idx, prior_z,
                          prior_sqrt_info, prior_mask, huber_delta,
                          not chi_only)
    if chi_only:
        return scal[0]
    p = prior_idx.shape[0]
    ai = out[:9 * rows].view(rows, 3, 3)
    aj = out[9 * rows:18 * rows].view(rows, 3, 3)
    r = out[18 * rows:21 * rows].view(rows, 3)
    ap = out[21 * rows:21 * rows + 9 * p].view(p, 3, 3)
    rp = out[21 * rows + 9 * p:].view(p, 3)
    return (ai, aj, r), (ap, rp)


def fresh_residual_max(poses, bet_i, bet_j, bet_z, bet_sqrt_info, bet_mask,
                       prior_idx, prior_z, prior_sqrt_info, prior_mask,
                       n_between, k: int):
    """K5 on the fresh window: max |whitened residual| (no Huber weight)
    over the ``k`` slots from ``clamp(n_between - k, 0, F - k)`` with
    ``bet_mask``; ``n_between`` is read on the card. Returns ``[]``."""
    f = bet_i.shape[0]
    k = min(k, f)
    _check(bet_mask, "bet_mask", dtype=torch.bool, shape=(f,), align=1)
    _check(n_between, "n_between", dtype=torch.int64, shape=())
    scal, _ = _lin_call(poses, bet_i, bet_j, bet_z, bet_sqrt_info, bet_mask,
                        None, n_between, k, k, prior_idx, prior_z,
                        prior_sqrt_info, prior_mask, 0.0, False)
    return scal[1]


def pcg_solve(bet_i, bet_j, bet_mask, prior_idx, prior_mask, pose_mask, lin,
              rhs, lam, max_iter: int, tol: float, damp_abs: float = 0.0):
    """K6: the whole PCG solve of ``(H + damping) x = rhs`` in one launch
    (see ``csrc/pcg_solve.cu``). ``lin`` is K5's ``((ai, aj, r), (ap,
    rp))``; ``rhs`` f32 ``[V, 3]`` or None for ``-gradient``; ``lam`` an
    f32 ``[]`` tensor (read on the card) or a Python float. Returns ``(x
    [V, 3], iterations [] int32, max |M^-1 rhs| [])``. Raises above the
    graph size one block's shared memory holds (the launcher sizes it)."""
    (ai, aj, r), (ap, rp) = lin
    f, p = _check_graph(bet_i, bet_j, bet_mask, prior_idx, prior_mask)
    v = pose_mask.shape[0]
    _check(pose_mask, "pose_mask", dtype=torch.bool, shape=(v,), align=1)
    _check(ai, "ai", shape=(f, 3, 3))
    _check(aj, "aj", shape=(f, 3, 3))
    _check(r, "r", shape=(f, 3))
    _check(ap, "ap", shape=(p, 3, 3))
    _check(rp, "rp", shape=(p, 3))
    if rhs is not None:
        _check(rhs, "rhs", shape=(v, 3))
    lam_ptr, lam_value = None, 0.0
    if isinstance(lam, torch.Tensor):
        _check(lam, "lam", shape=())
        lam_ptr = lam.data_ptr()
    else:
        lam_value = float(lam)
    dev = pose_mask.device
    x = torch.empty((v, 3), dtype=torch.float32, device=dev)
    ints = torch.empty((), dtype=torch.int32, device=dev)
    zmax = torch.empty((), dtype=torch.float32, device=dev)
    threads = min(1024, -(-v // 32) * 32)
    _call("pcg_solve_launch", "pcg_solve", bet_i.data_ptr(), bet_j.data_ptr(),
          bet_mask.data_ptr(), f, prior_idx.data_ptr(), prior_mask.data_ptr(),
          p, pose_mask.data_ptr(), v, ai.data_ptr(), aj.data_ptr(),
          r.data_ptr(), ap.data_ptr(), rp.data_ptr(),
          None if rhs is None else rhs.data_ptr(), lam_ptr, lam_value,
          float(damp_abs), int(max_iter), float(tol), x.data_ptr(),
          ints.data_ptr(), zmax.data_ptr(), threads, _stream(x),
          too_big=f"a graph of {v} poses and {f} factors is over the shared "
                  f"memory one block can have; graphs this large (config 4) "
                  f"are ROADMAP A10")
    return x, ints, zmax


def pcg_solve_blocked(bet_i, bet_j, bet_mask, prior_idx, prior_mask,
                      pose_mask, lin, rhs, lam, n_blocks: int,
                      max_iter: int) -> torch.Tensor:
    """K6b: ``n_blocks`` independent PCG solves of a flat graph in one
    launch, one block each (see ``csrc/pcg_solve.cu``): block ``s`` owns
    poses ``[s V, (s + 1) V)``, factor slots ``[s F, (s + 1) F)`` and prior
    slots ``[s P, (s + 1) P)``, and every index of its slots must lie in its
    own poses (``dist.slam_dp._flat_graph`` lays them out so). ``lin`` is
    K5's linearization of the flat graph, ``rhs`` f32 ``[S V, 3]`` or None
    for ``-gradient``, ``lam`` f32 ``[S]`` (read on the card). Exactly
    ``max_iter`` iterations, Krylov scalars per block. Returns ``x [S V,
    3]``. Raises if one session's solve is over the shared memory one block
    can have."""
    (ai, aj, r), (ap, rp) = lin
    f, p = _check_graph(bet_i, bet_j, bet_mask, prior_idx, prior_mask)
    v = pose_mask.shape[0]
    if n_blocks < 1 or v % n_blocks or f % n_blocks or p % n_blocks:
        raise ValueError(f"pcg_solve_blocked: {v} poses, {f} factors and {p} "
                         f"priors do not split into {n_blocks} equal blocks")
    _check(pose_mask, "pose_mask", dtype=torch.bool, shape=(v,), align=1)
    _check(ai, "ai", shape=(f, 3, 3))
    _check(aj, "aj", shape=(f, 3, 3))
    _check(r, "r", shape=(f, 3))
    _check(ap, "ap", shape=(p, 3, 3))
    _check(rp, "rp", shape=(p, 3))
    _check(lam, "lam", shape=(n_blocks,))
    if rhs is not None:
        _check(rhs, "rhs", shape=(v, 3))
    vb, fb, pb = v // n_blocks, f // n_blocks, p // n_blocks
    x = torch.empty((v, 3), dtype=torch.float32, device=pose_mask.device)
    _call("pcg_solve_blocked_launch", "pcg_solve_blocked", bet_i.data_ptr(),
          bet_j.data_ptr(), bet_mask.data_ptr(), fb, prior_idx.data_ptr(),
          prior_mask.data_ptr(), pb, pose_mask.data_ptr(), vb, ai.data_ptr(),
          aj.data_ptr(), r.data_ptr(), ap.data_ptr(), rp.data_ptr(),
          None if rhs is None else rhs.data_ptr(), lam.data_ptr(),
          int(max_iter), x.data_ptr(), n_blocks,
          min(1024, -(-vb // 32) * 32), _stream(x),
          too_big=f"a session of {vb} poses and {fb} factors is over the "
                  f"shared memory one block can have")
    return x


def local_select(bet_i, bet_j, bet_mask, pose_mask, prior_idx, prior_mask,
                 n_between, since, cfg) -> dict:
    """K7a: the k-hop active set, the fits test and the local selection in
    one launch (see ``csrc/local_system.cu``). ``cfg`` is a
    ``SolverConfig``; ``n_between`` and ``since`` (or None) int64 ``[]``
    are read on the card. Returns the selection dict of
    ``graph.incremental.local_select``: only what the local path reads."""
    f, p = _check_graph(bet_i, bet_j, bet_mask, prior_idx, prior_mask)
    v = pose_mask.shape[0]
    _check(pose_mask, "pose_mask", dtype=torch.bool, shape=(v,), align=1)
    _check(n_between, "n_between", dtype=torch.int64, shape=())
    if since is not None:
        _check(since, "since", dtype=torch.int64, shape=())
    p_loc, f_loc = min(cfg.local_poses, v), min(cfg.local_factors, f)
    dev = pose_mask.device
    flags = torch.empty(1 + p_loc + f_loc + p, dtype=torch.bool, device=dev)
    ints = torch.empty(p_loc + 5 * f_loc + 2 * p, dtype=torch.int64,
                       device=dev)
    _call("local_select_launch", "local_select", bet_i.data_ptr(),
          bet_j.data_ptr(), bet_mask.data_ptr(), f, pose_mask.data_ptr(), v,
          prior_idx.data_ptr(), prior_mask.data_ptr(), p,
          n_between.data_ptr(), None if since is None else since.data_ptr(),
          min(cfg.local_fresh_k, f), cfg.local_span_gap, cfg.local_hops,
          cfg.local_poses, cfg.local_factors, p_loc, f_loc, flags.data_ptr(),
          ints.data_ptr(), _stream(flags),
          too_big=f"a graph of {v} poses and {f} factors is over the shared "
                  f"memory one block can have")
    fl = torch.split(flags, [1, p_loc, f_loc, p])
    it = torch.split(ints, [p_loc] + [f_loc] * 5 + [p, p])
    return dict(p_loc=p_loc, ok=fl[0][0], in_set=fl[1], f_sel=fl[2],
                p_act=fl[3], pid=it[0], fid=it[1], ri=it[2], rj=it[3],
                li=it[4], lj=it[5], rp=it[6], lp=it[7])


def local_assemble(n: int, ai, aj, r, ap, rp, f_sel, ri, li, rj, lj, p_act,
                   p_role, lp):
    """K7b: the local normal equations ``(h_ii [3n, 3n], b_i [3n])`` from
    K5's gathered rows and the priors, routed by role (0 = interior) and
    local slot (see ``csrc/local_system.cu``)."""
    k, p = ai.shape[0], ap.shape[0]
    _check(ai, "ai", shape=(k, 3, 3))
    _check(aj, "aj", shape=(k, 3, 3))
    _check(r, "r", shape=(k, 3))
    _check(ap, "ap", shape=(p, 3, 3))
    _check(rp, "rp", shape=(p, 3))
    _check(f_sel, "f_sel", dtype=torch.bool, shape=(k,), align=1)
    for name, t in (("ri", ri), ("li", li), ("rj", rj), ("lj", lj)):
        _check(t, name, dtype=torch.int64, shape=(k,))
    _check(p_act, "p_act", dtype=torch.bool, shape=(p,), align=1)
    _check(p_role, "p_role", dtype=torch.int64, shape=(p,))
    _check(lp, "lp", dtype=torch.int64, shape=(p,))
    dev = ai.device
    h = torch.empty((3 * n, 3 * n), dtype=torch.float32, device=dev)
    b = torch.empty(3 * n, dtype=torch.float32, device=dev)
    _call("local_assemble_launch", "local_assemble", ai.data_ptr(),
          aj.data_ptr(), r.data_ptr(), k, ap.data_ptr(), rp.data_ptr(), p,
          f_sel.data_ptr(), ri.data_ptr(), li.data_ptr(), rj.data_ptr(),
          lj.data_ptr(), p_act.data_ptr(), p_role.data_ptr(), lp.data_ptr(),
          n, h.data_ptr(), b.data_ptr(), _stream(h),
          too_big=f"{k} gathered factors are over the shared memory one "
                  f"block can have")
    return h, b


def supernodal_assemble(ai, aj, r, ap, rp, row_ptr, tgt_col, tgt_ptr, code,
                        vec_ptr, vcode, n_shards: int, ni: int, nsl: int,
                        ns: int):
    """K9a: the partitioned normal equations ``(h_ii [P, 3ni, 3ni], h_is
    [P, 3ni, 3nsl], h_ss [3ns, 3ns], b_i [P, 3ni], b_s [3ns])`` from K5's
    blocks, routed by the plan's int32 tables (see ``csrc/supernodal.cu``
    and ``dist.schur.Routes``). One allocation holds all five."""
    f, q = ai.shape[0], ap.shape[0]
    rows = n_shards * ni + ns
    _check(ai, "ai", shape=(f, 3, 3))
    _check(aj, "aj", shape=(f, 3, 3))
    _check(r, "r", shape=(f, 3))
    _check(ap, "ap", shape=(q, 3, 3))
    _check(rp, "rp", shape=(q, 3))
    _check(row_ptr, "row_ptr", dtype=torch.int32, shape=(rows + 1,))
    _check(vec_ptr, "vec_ptr", dtype=torch.int32, shape=(rows + 1,))
    n_tgt = tgt_col.shape[0]
    _check(tgt_col, "tgt_col", dtype=torch.int32, shape=(n_tgt,))
    _check(tgt_ptr, "tgt_ptr", dtype=torch.int32, shape=(n_tgt + 1,))
    _check(code, "code", dtype=torch.int32, shape=(code.shape[0],))
    _check(vcode, "vcode", dtype=torch.int32, shape=(vcode.shape[0],))
    sizes = [n_shards * 9 * ni * ni, n_shards * 9 * ni * nsl, 9 * ns * ns,
             n_shards * 3 * ni, 3 * ns]
    out = torch.empty(sum(sizes), dtype=torch.float32, device=ai.device)
    h_ii, h_is, h_ss, b_i, b_s = torch.split(out, sizes)
    _call("supernodal_assemble_launch", "supernodal_assemble", ai.data_ptr(),
          aj.data_ptr(), r.data_ptr(), ap.data_ptr(), rp.data_ptr(), f,
          row_ptr.data_ptr(), tgt_col.data_ptr(), tgt_ptr.data_ptr(),
          code.data_ptr(), vec_ptr.data_ptr(), vcode.data_ptr(), n_shards,
          ni, nsl, ns, h_ii.data_ptr(), h_is.data_ptr(), h_ss.data_ptr(),
          b_i.data_ptr(), b_s.data_ptr(), _stream(ai))
    return (h_ii.view(n_shards, 3 * ni, 3 * ni),
            h_is.view(n_shards, 3 * ni, 3 * nsl), h_ss.view(3 * ns, 3 * ns),
            b_i.view(n_shards, 3 * ni), b_s)


def schur_reduce(s_part, rhs_part, h_ss, b_s, hold_ptr, hold_shard, hold_loc,
                 loc_of, sep_mask, lam, nsl: int):
    """K9b: ``(s_tot [3ns, 3ns], rhs_tot [3ns])``, the shards' Schur parts
    ``s_part [P, 3nsl, 3nsl]``, ``rhs_part [P, 3nsl]`` routed into the
    separator system ``h_ss``, ``b_s`` and damped by ``lam`` (a Python
    float; see ``csrc/supernodal.cu``)."""
    p = s_part.shape[0]
    ns = loc_of.shape[1]
    _check(s_part, "s_part", shape=(p, 3 * nsl, 3 * nsl))
    _check(rhs_part, "rhs_part", shape=(p, 3 * nsl))
    _check(h_ss, "h_ss", shape=(3 * ns, 3 * ns))
    _check(b_s, "b_s", shape=(3 * ns,))
    _check(hold_ptr, "hold_ptr", dtype=torch.int32, shape=(ns + 1,))
    n_hold = hold_shard.shape[0]
    _check(hold_shard, "hold_shard", dtype=torch.int32, shape=(n_hold,))
    _check(hold_loc, "hold_loc", dtype=torch.int32, shape=(n_hold,))
    _check(loc_of, "loc_of", dtype=torch.int32, shape=(p, ns))
    _check(sep_mask, "sep_mask", dtype=torch.bool, shape=(ns,), align=1)
    s_tot = torch.empty((3 * ns, 3 * ns), dtype=torch.float32,
                        device=s_part.device)
    rhs_tot = torch.empty(3 * ns, dtype=torch.float32, device=s_part.device)
    _call("schur_reduce_launch", "schur_reduce", s_part.data_ptr(),
          rhs_part.data_ptr(), h_ss.data_ptr(), b_s.data_ptr(),
          hold_ptr.data_ptr(), hold_shard.data_ptr(), hold_loc.data_ptr(),
          loc_of.data_ptr(), sep_mask.data_ptr(), float(lam), nsl, ns,
          s_tot.data_ptr(), rhs_tot.data_ptr(), _stream(s_part))
    return s_tot, rhs_tot


def schur_local_assemble(ai, aj, r, ap, rp, row_ptr, tgt_col, tgt_ptr, code,
                         vec_ptr, vcode, int_mask, lam: float, ni: int,
                         ns: int):
    """K9c: one rank's parts of the distributed Schur step, ``(h_ii [3ni,
    3ni]`` damped by ``lam`` (dead slots get 1 on the diagonal), ``h_is
    [3ni, 3ns], h_ss [3ns, 3ns], b_i [3ni], b_s [3ns])``, from the rank's
    K5 rows, routed by its one-shard tables (see ``csrc/supernodal.cu`` and
    ``dist.schur.rank_routes``). One allocation holds all five."""
    f, q = ai.shape[0], ap.shape[0]
    _check(ai, "ai", shape=(f, 3, 3))
    _check(aj, "aj", shape=(f, 3, 3))
    _check(r, "r", shape=(f, 3))
    _check(ap, "ap", shape=(q, 3, 3))
    _check(rp, "rp", shape=(q, 3))
    _check(row_ptr, "row_ptr", dtype=torch.int32, shape=(ni + ns + 1,))
    _check(vec_ptr, "vec_ptr", dtype=torch.int32, shape=(ni + ns + 1,))
    n_tgt = tgt_col.shape[0]
    _check(tgt_col, "tgt_col", dtype=torch.int32, shape=(n_tgt,))
    _check(tgt_ptr, "tgt_ptr", dtype=torch.int32, shape=(n_tgt + 1,))
    _check(code, "code", dtype=torch.int32, shape=(code.shape[0],))
    _check(vcode, "vcode", dtype=torch.int32, shape=(vcode.shape[0],))
    _check(int_mask, "int_mask", dtype=torch.bool, shape=(ni,), align=1)
    sizes = [9 * ni * ni, 9 * ni * ns, 9 * ns * ns, 3 * ni, 3 * ns]
    out = torch.empty(sum(sizes), dtype=torch.float32, device=ai.device)
    h_ii, h_is, h_ss, b_i, b_s = torch.split(out, sizes)
    _call("schur_local_assemble_launch", "schur_local_assemble",
          ai.data_ptr(), aj.data_ptr(), r.data_ptr(), ap.data_ptr(),
          rp.data_ptr(), f, row_ptr.data_ptr(), tgt_col.data_ptr(),
          tgt_ptr.data_ptr(), code.data_ptr(), vec_ptr.data_ptr(),
          vcode.data_ptr(), int_mask.data_ptr(), float(lam), ni, ns,
          h_ii.data_ptr(), h_is.data_ptr(), h_ss.data_ptr(), b_i.data_ptr(),
          b_s.data_ptr(), _stream(ai))
    return (h_ii.view(3 * ni, 3 * ni), h_is.view(3 * ni, 3 * ns),
            h_ss.view(3 * ns, 3 * ns), b_i, b_s)


def ndt_sgh_unpacked(poses, points, mask_f, mean, icov, valid, grid,
                     d2: float, exp_clip: float):
    """K12: the NDT terms of one scan ``points [N, 2]`` (``mask_f [N]``
    f32) at every pose of ``poses [B, 3]`` on an unpacked overlap-4 map
    (``mean [4, C, 2]``, ``icov [4, C, 2, 2]``, ``valid [4, C]``), one block
    per pose (see ``csrc/ndt_unpacked.cu``). Returns ``(f [B], g [B, 3],
    H [B, 3, 3], score [B])``, views of one ``[B, 14]`` allocation."""
    if grid.overlap != 4:
        raise NotImplementedError(
            "K12 takes overlap=4 maps only; overlap=1 on the card is ROADMAP "
            "Queue B (B8)")
    c = grid.n_cells
    b, n = poses.shape[0], points.shape[0]
    _check(poses, "poses", shape=(b, 3))
    _check(points, "points", shape=(n, 2), align=8)
    _check(mask_f, "mask", shape=(n,))
    _check(mean, "mean", shape=(4, c, 2), align=8)
    _check(icov, "icov", shape=(4, c, 2, 2), align=16)
    _check(valid, "valid", shape=(4, c))
    out = torch.empty((b, 14), dtype=torch.float32, device=poses.device)
    if b > 0:
        _call("ndt_sgh_unpacked_launch", "ndt_sgh_unpacked",
              poses.data_ptr(), points.data_ptr(), mask_f.data_ptr(),
              mean.data_ptr(), icov.data_ptr(), valid.data_ptr(),
              out.data_ptr(), b, n, grid.nx, grid.ny, grid.x0, grid.y0,
              grid.cell, d2, exp_clip, _stream(poses))
    return out[:, 0], out[:, 1:4], out[:, 4:13].view(b, 3, 3), out[:, 13]


def _slab_scratch(dev: torch.device, width: int, ny: int) -> torch.Tensor:
    """K10a's int64 ``[4, width, ny, 6]`` sums, allocated once per (device,
    slab shape) and kept: every call zeroes them on its own stream first,
    so two calls on one stream never overlap on them (two streams would:
    ROADMAP C-w6)."""
    key = (dev.index, width, ny)
    buf = _SLAB_SCRATCH.get(key)
    if buf is None:
        buf = torch.empty(4 * width * ny * 6, dtype=torch.int64, device=dev)
        _SLAB_SCRATCH[key] = buf
    return buf


def slab_accumulate(points, mask, grid, x_lo: int, width: int):
    """K10a: the slab statistics ``(n [4, width, ny], s [.., 2], ss [.., 2,
    2])`` of grid columns ``[x_lo, x_lo + width)`` from ``points [M, 2]``
    (f32) and ``mask [M]`` (bool), each point counted in the cell of each
    overlap grid that ``ndt.grid.cell_ids`` gives it, if that cell is in
    the map and in the slab (see ``csrc/slab_accum.cu``). Summed in 64-bit
    fixed point: the same result on every run and under any order of the
    points. One ctypes call (zero the kept scratch, scatter, moments), one
    ``LAUNCHES["slab_accumulate"]``."""
    if grid.overlap != 4:
        raise NotImplementedError(
            "K10a takes overlap=4 grids only; overlap=1 on the card is "
            "ROADMAP Queue B (B8)")
    if width < 1:
        raise ValueError(f"slab_accumulate: width {width} < 1")
    m = points.shape[0]
    _check(points, "points", shape=(m, 2), align=8)
    _check(mask, "mask", dtype=torch.bool, shape=(m,), align=1)
    dev, ny = points.device, grid.ny
    c = 4 * width * ny
    out = torch.empty(7 * c, dtype=torch.float32, device=dev)
    n = out[:c].view(4, width, ny)
    s = out[c:3 * c].view(4, width, ny, 2)
    ss = out[3 * c:].view(4, width, ny, 2, 2)
    _call("slab_accum_launch", "slab_accumulate", points.data_ptr(),
          mask.data_ptr(), _slab_scratch(dev, width, ny).data_ptr(),
          n.data_ptr(), s.data_ptr(), ss.data_ptr(), m, grid.nx, ny, x_lo,
          width, grid.x0, grid.y0, grid.cell, _stream(points))
    return n, s, ss


def finalize_cells(n, s, ss, ndt_cfg):
    """K10b: ``ndt.grid.finalize`` of statistics of any leading shape
    (``n [...]``, ``s [..., 2]``, ``ss [..., 2, 2]``, f32), one thread per
    cell: ``(mean [..., 2], icov [..., 2, 2], valid [...])``, views of one
    allocation. One ``LAUNCHES["finalize_cells"]`` per call with cells."""
    lead = tuple(n.shape)
    _check(n, "stats.n")
    _check(s, "stats.s", shape=lead + (2,), align=8)
    _check(ss, "stats.ss", shape=lead + (2, 2), align=16)
    c = n.numel()
    out = torch.empty(7 * c, dtype=torch.float32, device=n.device)
    icov = out[:4 * c].view(lead + (2, 2))
    mean = out[4 * c:6 * c].view(lead + (2,))
    valid = out[6 * c:].view(lead)
    if c > 0:
        _call("finalize_cells_launch", "finalize_cells", n.data_ptr(),
              s.data_ptr(), ss.data_ptr(), mean.data_ptr(), icov.data_ptr(),
              valid.data_ptr(), c, float(ndt_cfg.min_pts),
              ndt_cfg.eig_ratio, ndt_cfg.eig_abs_min, _stream(n))
    return mean, icov, valid


def slab_sgh(poses, points, mask_f, mean, icov, valid, grid, x_lo: int,
             d2: float, exp_clip: float) -> torch.Tensor:
    """K10c: the 15 raw NDT sums ``(f, wsum, w0sum, g [3], H [9])`` of one
    scan ``points [N, 2]`` (``mask_f [N]`` f32) at each pose of ``poses [B,
    3]`` over one rank's slab of an overlap-4 map (``mean [4, nx_local, ny,
    2]``, ``icov [.., 2, 2]``, ``valid [4, nx_local, ny]``, ix-major, grid
    columns ``[x_lo, x_lo + nx_local)``), one block per pose (see
    ``csrc/ndt_unpacked.cu``): ``[B, 15]``."""
    if grid.overlap != 4:
        raise NotImplementedError(
            "K10c takes overlap=4 maps only; overlap=1 on the card is "
            "ROADMAP Queue B (B8)")
    nxl, ny = valid.shape[1], grid.ny
    b, n = poses.shape[0], points.shape[0]
    _check(poses, "poses", shape=(b, 3))
    _check(points, "points", shape=(n, 2), align=8)
    _check(mask_f, "mask", shape=(n,))
    _check(valid, "valid", shape=(4, nxl, ny))
    _check(mean, "mean", shape=(4, nxl, ny, 2), align=8)
    _check(icov, "icov", shape=(4, nxl, ny, 2, 2), align=16)
    out = torch.empty((b, 15), dtype=torch.float32, device=poses.device)
    if b > 0:
        _call("slab_sgh_launch", "slab_sgh", poses.data_ptr(),
              points.data_ptr(), mask_f.data_ptr(), mean.data_ptr(),
              icov.data_ptr(), valid.data_ptr(), out.data_ptr(), b, n,
              grid.nx, ny, x_lo, nxl, grid.x0, grid.y0, grid.cell, d2,
              exp_clip, _stream(poses))
    return out
