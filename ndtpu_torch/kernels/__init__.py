"""Hand-written CUDA kernels for Hopper (``sm_90a``): build, bind, launch.

Twenty-six kernels carry the windowed and per-scan pipelines with loop
closure, the loop verify's set-up, the window's appends, serving's map
refresh, the pose-graph
smoother, the large-graph supernodal and PCG solves, stacked
multi-session serving, config 5's merge and distributed solve, its
slab-sharded map, and the input preparation (ROADMAP Queue B):

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
halfcell     ``csrc/halfcell_add.cu`` (K3)   ``grid._add_points_halfcell``;
                                             ``add_points`` at overlap 1
halfcell_    ``csrc/halfcell_add.cu`` (K3s)  the same over S maps (the vmaps
add_stacked                                  of ``add_points`` in
                                             ``dist/slam_dp.py``)
finalize     ``csrc/finalize_pack.cu`` (K4)  ``grid.finalize`` + ``pack_quad``
finalize_    ``csrc/finalize_pack.cu`` (K4s) the same over S maps
pack_stacked                                 (``slam_dp`` ``pack8``)
local_tables ``csrc/local_tables.cu`` (K8a)  ``closure.build_local_table``
                                             over a window's keyframes
loop_gate    ``csrc/loop_gate.cu`` (K8b)     ``closure._gate_and_pack``
factor_      ``csrc/factor_linearize.cu``    ``factors.linearize`` / ``chi2``
linearize    (K5, with the robust kinds      (``robust_weight``: huber,
             K5r)                            cauchy, tukey, geman),
                                             ``incremental.fresh_residual_max``
                                             and the local path's gathered
                                             linearization and
                                             ``chi_local``: one launch
pcg_solve    ``csrc/pcg_solve.cu`` (K6)      ``solve.pcg_rhs`` (matvec,
                                             gradient, block diagonal,
                                             ``_inv3``, the loop): one launch
                                             of one block, graphs that fit
                                             its shared memory
pcg_solve_   ``csrc/pcg_grid.cu`` (K6g)      the same past one block: one
grid                                         cooperative launch across many
                                             SMs, the graph in global memory
pcg_solve_   ``csrc/pcg_solve.cu`` (K6b)     ``solve.pcg_rhs_blocked``: S
blocked                                      sessions' PCGs, one block each
local_select ``csrc/local_system.cu`` (K7a)  ``incremental._active_probe`` +
                                             ``_local_select``: one block,
                                             the graph staged once in
                                             shared memory or, past it, in
                                             a device scratch (counted as
                                             ``local_select[scratch]``)
local_       ``csrc/local_system.cu`` (K7b)  ``schur.assemble_local_parts``
assemble                                     (``h_ii``, ``b_i`` only)
supernodal_  ``csrc/supernodal.cu`` (K9a)    ``supernodal._assemble_parts``
assemble
schur_reduce ``csrc/supernodal.cu`` (K9b)    ``supernodal.supernodal_delta``'s
                                             separator segment sums and
                                             damping: ``h_ss`` streamed,
                                             the held entries summed
schur_local_ ``csrc/supernodal.cu`` (K9c)    ``dist/schur.py::
assemble                                     _schur_delta_local``'s
                                             ``assemble_local_parts`` and
                                             interior damping, per rank
ndt_sgh_     ``csrc/ndt_unpacked.cu`` (K12)  ``vmap(match.score_grad_hess)``
unpacked                                     over poses (``grid.lookup`` +
                                             ``match.point_terms``), as
                                             ``merge.global_align`` ranks
                                             its hypotheses: one beam per
                                             thread, a beam's cells loaded
                                             before any test
slab_        ``csrc/slab_accum.cu`` (K10a)   ``dist/gridmap.py::_accum_local``
accumulate                                   with ``_cell_xy`` and the slab
                                             masks of its two callers: the
                                             pairs binned by tile, each
                                             tile summed in a cluster's
                                             shared memory
finalize_    ``csrc/finalize_cells.cu``      ``grid.finalize`` on any layout
cells        (K10b)                          (``finalize_slab``): three
                                             arrays, or the slab
                                             exchange's 7-float records
                                             read in place
slab_sgh     ``csrc/ndt_unpacked.cu`` (K10c) ``match_slab``'s per-rank terms
                                             (the 15 sums before its psum)
raycast      ``csrc/raycast.cu`` (K11)       ``synth.raycast``: the nearest
                                             ray/segment hit per (pose,
                                             beam), f64 and f32
voxel_       ``csrc/voxel_downsample.cu``    ``preprocess.voxel_downsample``:
downsample   (K13)                           one valid point per voxel, by
                                             a hash table in shared memory
                                             (past it by comparing ids,
                                             counted as
                                             ``voxel_downsample[scan]``)
window_      ``csrc/window_append.cu`` (K14) ``pipeline._wb_appends``' masked
append                                       scatters (slots, anchors, node
                                             values, odometry factors and
                                             sqrt-information) with
                                             ``_wb_extend``'s map-pose rows,
                                             for S sessions; entry points
                                             for the loop factors
                                             (``window_append[loops]``) and
                                             ``_refresh_map``'s rows
                                             (``window_append[rows]``): new
                                             arrays, one launch each
loop_lanes   ``csrc/loop_lanes.cu`` (K15)    ``closure.find_candidates`` and
                                             the lane set-up of
                                             ``verify_candidates_cached_
                                             flat`` for S x K queries:
                                             each warp's running top C of
                                             64-bit (distance, index) keys,
                                             ranked over the warps' lists,
                                             then the gated ``lm_ndt``'s
                                             lanes
refresh_     ``csrc/refresh_points.cu``      ``pipeline._refresh_map``'s
points       (K16)                           staleness, ``lax.top_k`` and
                                             weighted old / new points for
                                             S sessions: ranks counted in
                                             shared memory, one block a
                                             session
============ =============================== =================================

K5, K6, K6g and K7b share the pose graph's arithmetic,
``csrc/pose_graph.cuh`` (``wrap``, the between error and Jacobians,
whitening, the robust weights, ``_inv3``, and block reductions in a fixed
order): no float atomics, so the smoother's results are the same on every
launch. ``graph.solve.pcg_solve`` takes K6 where :func:`pcg_route` says
the graph fits one block and K6g otherwise. The graph wrappers
(``graph.factors.linearize`` / ``chi2`` / ``factor_linearize``,
``graph.solve.pcg_solve``, ``graph.incremental.local_select`` and
``fresh_residual_max``, ``dist.schur.assemble_local``,
``graph.supernodal.supernodal_assemble`` and ``schur_reduce``) send CPU
tensors to their plain versions and CUDA tensors here, as do K14's
(``slam.appends.window_append``, ``loop_append``, ``set_rows``). K9a and K9b (and
K5 at config 4's 10k poses) carry the supernodal step; they route by tables
the host builds once per topology and sum each target in a fixed order.

K8b's steps live in ``csrc/loop_gate.cuh``, which ``lm_ndt`` also runs:
with ``gate=`` one ``lm_ndt`` launch verifies a loop window's ``K x C``
lanes and gates them (the gated verify, counted as ``lm_ndt_grouped`` and
as ``loop_gate_fused``); ``loop_gate`` alone gates registrations made
elsewhere.

Table layouts (:data:`LAYOUTS`): the quad tables of K1, ``lm_ndt`` (and
the gated verify), K4 and K8a come in four layouts, G overlap grids per
row (4, or 1 at ``GridConfig.overlap = 1`` / ``LoopConfig.local_overlap =
1``) of L lanes (8, or 4 bf16-pair lanes at ``MatchConfig.compact_table``);
each layout is its own instantiation of the same device code, counted
apart (:func:`variant`: ``lm_ndt[g1l8]``, ``finalize_pack[g4l4]``, ...).
Stacked serving's K4s takes every layout too (``finalize_pack_stacked
[g1l4]``, ...). The kernels on the statistics or an unpacked map take
both overlaps, counted apart at overlap 1: K3 and K3s
(``halfcell_add[g1]``, ``halfcell_add_stacked[g1]``), and config 5's K12,
K10a and K10c (``ndt_sgh_unpacked[g1]``, ``slab_accumulate[g1]``,
``slab_sgh[g1]``).

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
           "loop_gate", "ROBUST_KINDS", "robust_code", "factor_linearize",
           "fresh_residual_max", "pcg_smem", "pcg_route", "pcg_grid_plan",
           "pcg_solve", "pcg_solve_grid", "pcg_solve_blocked", "select_smem",
           "select_route", "local_select", "assemble_scratch",
           "local_assemble",
           "supernodal_assemble", "supernodal_assemble_shape",
           "schur_reduce", "schur_local_assemble",
           "ndt_sgh_unpacked", "slab_tiles", "slab_work", "slab_accumulate",
           "FINALIZE_THREADS", "finalize_cells_threads", "finalize_inputs",
           "finalize_cells",
           "slab_spread", "slab_sgh", "raycast", "sgh_spread", "voxel_smem",
           "voxel_route", "voxel_downsample", "WINDOW_MAX", "window_append",
           "loop_append", "rows_set", "LOOP_LANES_MAX_CAP",
           "loop_lanes_check", "loop_lanes", "refresh_smem",
           "refresh_max_cap", "refresh_check",
           "refresh_points", "FRESH_MAX_WINDOW", "fresh_residual_max_stacked"]

#: The quad-table layouts ``(G, L)``: G overlap grids per row (4, or 1 at
#: ``overlap = 1``) of L lanes each (8 full, or 4 compact bf16-pair lanes at
#: ``compact_table = True``). The first is the published configs' layout.
LAYOUTS = ((4, 8), (1, 8), (4, 4), (1, 4))


def variant(name: str, grids: int, lanes: int | None = None) -> str:
    """The launch counter of kernel ``name`` in a table layout: ``name`` for
    the published layout (4 grids of 8 lanes), else ``name[g1l8]``,
    ``name[g4l4]`` or ``name[g1l4]``; K3 (``lanes=None``) has grids only:
    ``halfcell_add[g1]`` at overlap 1."""
    if lanes is None:
        return name if grids == 4 else f"{name}[g{grids}]"
    return name if (grids, lanes) == (4, 8) else f"{name}[g{grids}l{lanes}]"


#: The kernels that run in every table layout (K1, ``lm_ndt``, the gated
#: verify, K4, K4s, K8a).
_LAYOUT_KERNELS = ("lm_ndt", "lm_ndt_grouped", "ndt_terms",
                   "ndt_terms_grouped", "finalize_pack",
                   "finalize_pack_stacked", "local_tables", "loop_gate_fused")
#: The kernels that run at both overlaps, on statistics or an unpacked map
#: (K3, K3s, K12, K10a, K10c).
_GRID_KERNELS = ("halfcell_add", "halfcell_add_stacked", "ndt_sgh_unpacked",
                 "slab_accumulate", "slab_sgh")

#: Launch counts per kernel since the last :func:`reset_launches`; the
#: layout variants (:func:`variant`) count apart.
LAUNCHES = {"lm_ndt": 0, "lm_ndt_grouped": 0, "ndt_terms": 0,
            "ndt_terms_grouped": 0, "halfcell_add": 0,
            "halfcell_add_stacked": 0, "finalize_pack": 0,
            "finalize_pack_stacked": 0, "local_tables": 0, "loop_gate": 0,
            "loop_gate_fused": 0, "factor_linearize": 0, "pcg_solve": 0,
            "pcg_solve_grid": 0, "pcg_solve_blocked": 0, "local_select": 0,
            "local_select[scratch]": 0, "local_assemble": 0,
            "supernodal_assemble": 0, "schur_reduce": 0,
            "schur_local_assemble": 0, "ndt_sgh_unpacked": 0,
            "slab_accumulate": 0, "finalize_cells": 0, "slab_sgh": 0,
            "raycast": 0, "voxel_downsample": 0,
            "voxel_downsample[scan]": 0, "window_append": 0,
            "window_append[loops]": 0, "window_append[rows]": 0,
            "loop_lanes": 0, "refresh_points": 0,
            **{variant(k, 1): 0 for k in _GRID_KERNELS},
            **{variant(k, g, l): 0 for k in _LAYOUT_KERNELS
               for g, l in LAYOUTS[1:]}}

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
_LIN_ARRIVE: dict = {}           # (device index, stream) -> K5's int32 ticket
_ASM_CTL: dict = {}              # (device index, stream) -> K7b's 4 int32

_P, _I, _F, _D = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                  ctypes.c_double)
_SIGNATURES = {
    "lm_ndt_launch": [_P] * 11 + [_I] * 7 + [_F] * 12 + [_P] * 7 + [_I]
                     + [_F] * 3 + [_I] * 5 + [_P],
    "ndt_terms_launch": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                         _F, _F, _F, _F, _F, _I, _I, _P],
    "halfcell_add_launch": [_P, _P, _P, _F] + [_P] * 7 + [_I] * 4 + [_D] * 4
                           + [_I, _P],
    "finalize_pack_launch": [_P] * 4 + [_I] * 6 + [_F] * 3 + [_I] * 3
                            + [_P],
    "local_tables_launch": [_P] * 5 + [_I] * 7 + [_D] * 4 + [_F] * 3
                           + [_I] * 3 + [_P],
    "loop_gate_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                         _F, _F, _F, _I, _P],
    "factor_linearize_launch": [_P] * 8 + [_I] * 5 + [_P] * 4 + [_I, _F, _I]
                               + [_P] * 8,
    "pcg_solve_launch": [_P, _P, _P, _I, _P, _P, _I, _P, _I] + [_P] * 7
                        + [_F, _F, _I, _F] + [_P] * 5,
    "pcg_grid_launch": [_P, _P, _P, _I, _P, _P, _I, _P, _I] + [_P] * 7
                       + [_F, _F, _I, _F] + [_P] * 5 + [_I, _P],
    "pcg_grid_plan": [_I, _I, _I, ctypes.POINTER(ctypes.c_longlong)],
    "pcg_solve_blocked_launch": [_P, _P, _P, _I, _P, _P, _I, _P, _I]
                                + [_P] * 7 + [_I, _P, _P, _I, _P],
    "local_select_launch": [_P, _P, _P, _I, _P, _I, _P, _P, _I, _P, _P]
                           + [_I] * 7 + [_P] * 4,
    "local_assemble_launch": [_P, _P, _P, _I, _P, _P, _I] + [_P] * 8
                             + [_I] + [_P] * 5,
    "supernodal_assemble_launch": [_P] * 5 + [_I] + [_P] * 6 + [_I] * 4
                                  + [_P] * 6,
    "supernodal_assemble_shape": [_I, _I, _I],
    "schur_reduce_launch": [_P] * 11 + [_F, _I, _I, _P, _P, _P],
    "schur_local_assemble_launch": [_P] * 5 + [_I] + [_P] * 7
                                   + [_F, _I, _I] + [_P] * 6,
    "ndt_sgh_unpacked_launch": [_P] * 7 + [_I] * 4 + [_F] * 5
                               + [_I, _I, _P],
    "slab_accum_launch": [_P] * 6 + [_I] * 5 + [_D] * 3 + [_I] * 4 + [_P],
    "finalize_cells_launch": [_P] * 7 + [ctypes.c_longlong] + [_F] * 3
                             + [_I] * 2 + [_P],
    "slab_sgh_launch": [_P] * 7 + [_I] * 6 + [_F] * 5 + [_I] * 3 + [_P],
    "raycast_launch": [_P] * 4 + [_I] * 3 + [_D, _D, _I, _P],
    "voxel_downsample_launch": [_P] * 3 + [_I, _I, _F, _I, _I, _P],
    "window_append_launch": [_P] + [_I] * 7 + [_P],
    "loop_append_launch": [_P] + [_I] * 5 + [_P],
    "rows_set_launch": [_P] * 5 + [_I] * 4 + [_P],
    "loop_lanes_launch": [_P] + [_I] * 8 + [_F, ctypes.c_longlong, _P],
    "refresh_points_launch": [_P] + [_I] * 4 + [_F, _I, _P],
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
    """The quad table's lattice ``(wh, hh)``: the ``(2nx+1) x (2ny+1)``
    half cells at overlap 4, the ``nx x ny`` cells at overlap 1."""
    if grid.overlap == 4:
        return 2 * grid.nx + 1, 2 * grid.ny + 1
    if grid.overlap == 1:
        return grid.nx, grid.ny
    raise ValueError(f"overlap must be 1 or 4, got {grid.overlap}")


def _inv(grid) -> float:
    """The matcher's binning factor: ``1 / lattice pitch``."""
    return (2.0 if grid.overlap == 4 else 1.0) / grid.cell


def _frame(grid) -> tuple:
    """The map build's fixed-point frame ``(inv, h)``: half cells ``(2 /
    cell, cell / 2)`` at overlap 4, cells ``(1 / cell, cell)`` at overlap
    1 (``csrc/halfcell_fixed.cuh``, ``ndt.grid.halfcell_add_fixed_ref``)."""
    return _inv(grid), grid.cell / 2.0 if grid.overlap == 4 else grid.cell


def _layout(grid, compact: bool) -> tuple:
    """``(G, L)`` of a quad table on ``grid`` (:data:`LAYOUTS`)."""
    return grid.overlap, 4 if compact else 8


def ndt_terms(poses, px, py, mask_f, table, grid, d2: float,
              exp_clip: float, group=None, compact: bool = False
              ) -> torch.Tensor:
    """K1: the 11 NDT sums ``[B, 11]`` per lane (see ``csrc/ndt_terms.cu``).

    ``table`` is one shared ``[R, G*L]`` table, or with ``group`` (int32
    ``[B]``) a stack ``[S, R, G*L]`` of which lane ``b`` reads table
    ``group[b]`` (the kernel clamps it into ``[0, S)``); ``G = overlap``,
    ``L = 4`` if ``compact`` else 8."""
    wh, hh = _lattice(grid)
    gl = _layout(grid, compact)
    b, n = px.shape
    _check(poses, "poses", shape=(b, 3))
    _check(px, "px")
    _check(py, "py", shape=(b, n))
    _check(mask_f, "mask", shape=(b, n))
    n_tables, g_ptr, grouped = _table_args(table, group, b, wh, hh, gl)
    counter = variant("ndt_terms_grouped" if grouped else "ndt_terms", *gl)
    out = torch.empty((b, 11), dtype=torch.float32, device=px.device)
    if b == 0:
        return out.zero_()
    _call("ndt_terms_launch", counter, poses.data_ptr(), px.data_ptr(),
          py.data_ptr(), mask_f.data_ptr(), table.data_ptr(), g_ptr,
          out.data_ptr(), b, n, wh, hh, wh * hh, n_tables, grid.x0, grid.y0,
          _inv(grid), d2, exp_clip, *gl, _stream(px))
    return out


def _table_args(table, group, b: int, wh: int, hh: int, layout):
    """Check a shared ``[R, G*L]`` table, or a stack ``[S, R, G*L]`` with an
    int32 ``group [B]`` (rows read as 16-byte vectors); returns
    ``(n_tables, group pointer, grouped)``."""
    lanes = layout[0] * layout[1]
    if group is None:
        _check(table, "table", shape=(wh * hh, lanes), align=16)
        return 1, None, False
    _check(group, "group", dtype=torch.int32, shape=(b,))
    _check(table, "tables", shape=(table.shape[0], wh * hh, lanes), align=16)
    return table.shape[0], group.data_ptr(), True


class LoopGate(NamedTuple):
    """The loop gate's inputs beside a verify's registrations, for the
    gated :func:`lm_ndt`: ``cand_mask`` bool ``[K, C]`` (candidate slot is
    real), ``query_idx`` int64 ``[K]``; ``innov_per_kf <= 0`` and
    ``k_budget = 0`` switch those gates off (see ``csrc/loop_gate.cuh``).
    The innovation gap is ``|query_idx - candidate|``, the candidate the
    lane's ``group`` row, or ``cand_idx`` (int64 ``[K, C]``) where given
    (lanes whose rows are not the candidates', as the fresh-map verify's)."""

    cand_mask: torch.Tensor
    query_idx: torch.Tensor
    score_gate: float
    innov_base: float
    innov_per_kf: float
    k_budget: int
    cand_idx: torch.Tensor | None = None


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


#: ``lm_ndt``'s threads per lane are 128 R, one beam each; R is at most
#: this (1,024 threads).
LM_MAX_SPREAD = 8


def wide_terms_bytes(grids: int, spread: int) -> int:
    """Shared memory of the stored terms of a block of ``128 R`` threads
    (``R = spread``) at ``G = grids``: for each of the ``128 (R - 1)``
    beams a chunk stores, its ``11 x G`` terms (in 52 floats at G = 4, 12
    at G = 1) and a flag byte (``wide_terms_bytes`` of
    ``csrc/ndt_sums.cuh``; ``lm_ndt`` and K10c ``slab_sgh``)."""
    return (spread - 1) * 128 * ((208 if grids == 4 else 48) + 1)


def lm_smem(n: int, grids: int, spread: int) -> int:
    """``lm_ndt``'s dynamic shared memory for ``n`` beams at ``G = grids``
    and ``R = spread``: 12 B per beam (its x, y and mask) and the stored
    terms (:func:`wide_terms_bytes`)."""
    return 12 * n + wide_terms_bytes(grids, spread)


def lm_spread(b: int, n: int, grids: int, sms: int) -> int:
    """``R`` for ``b`` lanes of ``n`` beams on a card of ``sms``
    multiprocessors: one beam per thread, ``min(ceil(n / 128), 8)``, while
    the lanes' threads (``128 R`` each) stay within ``1,024 x sms``, down
    to 1 (K1's 128 threads) where the lanes fill the card alone; then the
    largest that fits the shared memory (:func:`lm_smem`). No result
    depends on it: the sums are K1's, bit for bit, at every R."""
    r = max(1, min(-(-n // 128), LM_MAX_SPREAD, 8 * sms // max(b, 1)))
    while r > 1 and lm_smem(n, grids, r) > SMEM_MAX - 1024:
        r -= 1
    return r


def lm_ndt(init_poses, px, py, mask_f, table, grid, cfg, group=None,
           gate: LoopGate | None = None):
    """K2 around K1: every lane's whole LM registration in one launch (see
    ``csrc/lm_ndt.cu``). Returns ``(pose [B,3], hessian [B,3,3], score [B],
    n_iter [B] int32, converged [B] bool)``.

    ``cfg`` is a ``MatchConfig`` (read by attribute; ``max_iter`` is the
    cap, ``compact_table`` the table's lanes); ``table`` and ``group`` are
    as for :func:`ndt_terms`. With
    ``gate`` (``K`` queries x ``C <= 128`` candidates, ``B = K * C``,
    ``group`` = the candidates' indices) the same launch also gates the
    lanes as :func:`loop_gate` does, bit for bit, and three more outputs
    follow: ``accept [K, C]``, ``innov_rej [K, C]`` bool and ``sqrt_info
    [K, C, 3, 3]``. Nothing is read back to the host."""
    if gate is not None:
        _gate_width(gate.cand_mask.shape[-1])
    wh, hh = _lattice(grid)
    gl = _layout(grid, cfg.compact_table)
    b, n = px.shape
    _check(init_poses, "init_poses", shape=(b, 3))
    _check(px, "px")
    _check(py, "py", shape=(b, n))
    _check(mask_f, "mask", shape=(b, n))
    n_tables, g_ptr, grouped = _table_args(table, group, b, wh, hh, gl)
    dev = px.device
    spread = lm_spread(b, n, gl[0], _sm_count(dev)) if b > 0 else 1
    smem = lm_smem(n, gl[0], spread)
    if smem > SMEM_MAX - 1024:
        raise ValueError(f"lm_ndt: {n} beams need {smem} B of shared memory "
                         f"(12 B per beam), over what a block can have")
    pose = torch.empty((b, 3), dtype=torch.float32, device=dev)
    hess = torch.empty((b, 3, 3), dtype=torch.float32, device=dev)
    score = torch.empty((b,), dtype=torch.float32, device=dev)
    n_iter = torch.empty((b,), dtype=torch.int32, device=dev)
    conv = torch.empty((b,), dtype=torch.bool, device=dev)
    outs = (pose, hess, score, n_iter, conv)
    gate_args = [None] * 7 + [0, 0.0, 0.0, 0.0, 0]
    if gate is not None:
        k, c = gate.cand_mask.shape
        if not grouped or k * c != b:
            raise ValueError(f"lm_ndt: the gate takes K x C = {k} x {c} "
                             f"lanes of a grouped launch, got {b} lanes"
                             + ("" if grouped else " and no group"))
        _check(gate.cand_mask, "cand_mask", dtype=torch.bool, shape=(k, c),
               align=1)
        _check(gate.query_idx, "query_idx", dtype=torch.int64, shape=(k,))
        if gate.cand_idx is not None:
            _check(gate.cand_idx, "cand_idx", dtype=torch.int64,
                   shape=(k, c))
        accept = torch.empty((k, c), dtype=torch.bool, device=dev)
        innov_rej = torch.empty((k, c), dtype=torch.bool, device=dev)
        sqrt_info = torch.empty((k, c, 3, 3), dtype=torch.float32, device=dev)
        outs += (accept, innov_rej, sqrt_info)
        gate_args = [gate.cand_mask.data_ptr(), gate.query_idx.data_ptr(),
                     None if gate.cand_idx is None
                     else gate.cand_idx.data_ptr(), accept.data_ptr(), innov_rej.data_ptr(),
                     sqrt_info.data_ptr(), _gate_arrive(dev, k).data_ptr(), c,
                     gate.score_gate, gate.innov_base, gate.innov_per_kf,
                     gate.k_budget]
    if b > 0:
        _call("lm_ndt_launch",
              variant("lm_ndt_grouped" if grouped else "lm_ndt", *gl),
              init_poses.data_ptr(), px.data_ptr(), py.data_ptr(),
              mask_f.data_ptr(), table.data_ptr(), g_ptr, pose.data_ptr(),
              hess.data_ptr(), score.data_ptr(), n_iter.data_ptr(),
              conv.data_ptr(), b, n, wh, hh, wh * hh, n_tables,
              int(cfg.max_iter), grid.x0, grid.y0, _inv(grid), cfg.d2,
              cfg.exp_clip, cfg.tol, cfg.reject_tol, cfg.init_lambda,
              cfg.lambda_up, cfg.lambda_down, cfg.max_lambda, cfg.step_clip,
              *gate_args, smem, *gl, spread, _stream(px))
        if gate is not None:
            LAUNCHES[variant("loop_gate_fused", *gl)] += 1
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
    """K3: ``(n, s, ss) + moments of points``, as new tensors: at overlap 4
    the half-cell scatter and the 2x2 pool into the 4 grids (statistics
    ``[4, C]``, ``[4, C, 2]``, ``[4, C, 2, 2]``), at overlap 1 the same
    scatter on the cells of the one grid, binned as ``ndt.grid.cell_ids``
    bins (statistics ``[1, C]``, ...; counted as ``halfcell_add[g1]``).

    ``weight`` is a Python float or an f32 ``[M]`` tensor. The moments are
    summed in 64-bit fixed point (``csrc/halfcell_fixed.cuh``), so the
    result is the same on every run and under any order of the points, and
    equals ``ndt.grid.halfcell_add_fixed_ref`` bit for bit. Each call is one
    ctypes call, which zeroes the kept lattice scratch, scatters and pools
    (or, at overlap 1, reconstructs each cell) on the current stream, and
    one launch count.
    """
    wh, hh = _lattice(grid)
    g, c = grid.overlap, grid.n_cells
    m = points.shape[0]
    _check(points, "points", shape=(m, 2), align=8)
    _check(mask, "mask", dtype=torch.bool, shape=(m,), align=1)
    _check(n, "stats.n", shape=(g, c))
    _check(s, "stats.s", shape=(g, c, 2))
    _check(ss, "stats.ss", shape=(g, c, 2, 2))
    if isinstance(weight, torch.Tensor):
        _check(weight, "weight", shape=(m,))
        w_ptr, w_scalar = weight.data_ptr(), 0.0
    else:
        w_ptr, w_scalar = None, float(weight)
    dev = points.device
    # ss first, then s and n: each part 16-byte aligned whatever C is.
    out = torch.empty(7 * g * c, dtype=torch.float32, device=dev)
    ss2 = out[:4 * g * c].view(g, c, 2, 2)
    s2 = out[4 * g * c:6 * g * c].view(g, c, 2)
    n2 = out[6 * g * c:].view(g, c)
    _call("halfcell_add_launch", variant("halfcell_add", g), points.data_ptr(),
          mask.data_ptr(), w_ptr, w_scalar,
          _halfcell_scratch(dev, wh, hh).data_ptr(), n.data_ptr(),
          s.data_ptr(), ss.data_ptr(), n2.data_ptr(), s2.data_ptr(),
          ss2.data_ptr(), 1, m, grid.nx, grid.ny, grid.x0, grid.y0,
          *_frame(grid), g, _stream(points))
    return n2, s2, ss2


def halfcell_add_stacked(n, s, ss, points, mask, weight, grid):
    """K3s: :func:`halfcell_add` for S maps in one ctypes call, at overlap 4
    or 1 (``G = overlap``): statistics ``n [S, G, C]``, ``s [S, G, C, 2]``,
    ``ss [S, G, C, 2, 2]``, points ``[S, M, 2]``, mask bool ``[S, M]``,
    weight a Python float or an f32 ``[S, M]`` tensor. Map ``i`` gets
    exactly what :func:`halfcell_add` of its own points gives, bit for bit.
    One ``LAUNCHES["halfcell_add_stacked"]`` (``[g1]`` at overlap 1) per
    call."""
    wh, hh = _lattice(grid)
    g, c = grid.overlap, grid.n_cells
    maps, m = mask.shape
    _check(points, "points", shape=(maps, m, 2), align=8)
    _check(mask, "mask", dtype=torch.bool, shape=(maps, m), align=1)
    _check(n, "stats.n", shape=(maps, g, c))
    _check(s, "stats.s", shape=(maps, g, c, 2))
    _check(ss, "stats.ss", shape=(maps, g, c, 2, 2))
    if isinstance(weight, torch.Tensor):
        _check(weight, "weight", shape=(maps, m))
        w_ptr, w_scalar = weight.data_ptr(), 0.0
    else:
        w_ptr, w_scalar = None, float(weight)
    dev = points.device
    # ss first, then s and n, as in halfcell_add: ss 16-byte aligned (K4s
    # reads it in 16-byte vectors) whatever S x G x C is.
    gc = maps * g * c
    out = torch.empty(7 * gc, dtype=torch.float32, device=dev)
    ss2 = out[:4 * gc].view(maps, g, c, 2, 2)
    s2 = out[4 * gc:6 * gc].view(maps, g, c, 2)
    n2 = out[6 * gc:].view(maps, g, c)
    if maps == 0:
        return n2, s2, ss2
    _call("halfcell_add_launch", variant("halfcell_add_stacked", g),
          points.data_ptr(), mask.data_ptr(), w_ptr, w_scalar,
          _halfcell_scratch(dev, wh, hh, maps).data_ptr(), n.data_ptr(),
          s.data_ptr(), ss.data_ptr(), n2.data_ptr(), s2.data_ptr(),
          ss2.data_ptr(), maps, m, grid.nx, grid.ny, grid.x0, grid.y0,
          *_frame(grid), g, _stream(points))
    return n2, s2, ss2


def _finalize_smem(rows: int, nx: int, lanes: int = 8) -> int:
    """K4's shared memory for a band of ``rows`` table rows: 4 grids x
    ``grid_stride`` cells x ``4 * lanes`` B (``csrc/finalize_pack.cu``)."""
    cells = (rows // 2 + 1) * nx
    return 4 * (((cells + 2) & ~3) + 1) * 4 * lanes


def finalize_bands(grid, device=None, compact: bool = False) -> tuple:
    """K4's launch shape on an overlap-4 ``grid``: ``(band_rows, bands,
    threads, shared bytes)``. Bands as thin as the card holds at once
    (``bands`` within 8 blocks per SM: one-row bands on an H100 at every
    published grid), each band's ``band_rows // 2 + 1`` cell rows of each
    of the 4 grids (32 B per cell, 16 B with ``compact``) within the
    ``SMEM_BLOCK`` a block gets without an opt-in; one thread per such cell
    (whole warps, at most 512). A lattice so wide that one row needs more
    gets one-row bands and the opt-in (set once per process), up to
    ``SMEM_MAX``; past that it raises. ``device=None`` checks the size
    only. Kept per (grid, device, layout). Overlap 1 needs no bands (one
    thread per cell)."""
    key = (grid, None if device is None else device.index, compact)
    shape = _FINALIZE_BANDS.get(key)
    if shape is not None:
        return shape
    wh, hh = _lattice(grid)
    lanes = 4 if compact else 8
    one = _finalize_smem(1, grid.nx, lanes)
    if one > SMEM_MAX:
        raise ValueError(
            f"finalize_pack: a band of a {wh}-wide lattice needs {one} B of "
            f"shared memory, over the {SMEM_MAX} B a block can have")
    max_rows = 1
    while max_rows < hh and _finalize_smem(max_rows + 1, grid.nx, lanes) \
            <= SMEM_BLOCK:
        max_rows += 1
    resident = 1 if device is None else 8 * _sm_count(device)
    rows = min(max(1, -(-hh // resident)), max_rows)
    cells = 4 * (rows // 2 + 1) * grid.nx
    shape = (rows, -(-hh // rows), min(512, -(-cells // 32) * 32),
             _finalize_smem(rows, grid.nx, lanes))
    _FINALIZE_BANDS[key] = shape
    return shape


def finalize_pack(n, s, ss, ndt_cfg, grid, compact: bool = False
                  ) -> torch.Tensor:
    """K4: finalize every cell and write the quad table ``[R, G*L]`` (``G =
    overlap``, ``L = 4`` if ``compact`` else 8): at overlap 4 one block per
    band of table rows (:func:`finalize_bands`), at overlap 1 one thread per
    cell (row r is cell r). Compact lanes are bf16 pairs composed as 32-bit
    words (``csrc/ndt_cell.cuh``)."""
    wh, hh = _lattice(grid)
    g, lanes = _layout(grid, compact)
    c = grid.n_cells
    _check(n, "stats.n", shape=(g, c))
    _check(s, "stats.s", shape=(g, c, 2), align=8)
    _check(ss, "stats.ss", shape=(g, c, 2, 2), align=16)
    bands = (finalize_bands(grid, n.device, compact) if g == 4
             else (0, 0, 0, 0))
    table = torch.empty((hh * wh, g * lanes), dtype=torch.float32,
                        device=n.device)
    _call("finalize_pack_launch", variant("finalize_pack", g, lanes),
          n.data_ptr(), s.data_ptr(), ss.data_ptr(), table.data_ptr(), 1,
          grid.nx, grid.ny, *bands[:3], float(ndt_cfg.min_pts),
          ndt_cfg.eig_ratio, ndt_cfg.eig_abs_min, bands[3], g, lanes,
          _stream(n))
    return table


def finalize_pack_stacked(n, s, ss, ndt_cfg, grid, compact: bool = False
                          ) -> torch.Tensor:
    """K4s: :func:`finalize_pack` of S maps in one launch (statistics with a
    leading ``S`` axis), in any layout; returns the tables ``[S, R, G*L]``,
    table ``i`` bit-equal to :func:`finalize_pack` of map ``i``: each map
    cut into K4's bands at overlap 4, one thread per cell at overlap 1."""
    wh, hh = _lattice(grid)
    g, lanes = _layout(grid, compact)
    c = grid.n_cells
    maps = n.shape[0]
    _check(n, "stats.n", shape=(maps, g, c))
    _check(s, "stats.s", shape=(maps, g, c, 2), align=8)
    _check(ss, "stats.ss", shape=(maps, g, c, 2, 2), align=16)
    table = torch.empty((maps, hh * wh, g * lanes), dtype=torch.float32,
                        device=n.device)
    if maps == 0:
        return table
    bands = (finalize_bands(grid, n.device, compact) if g == 4
             else (0, 0, 0, 0))
    _call("finalize_pack_launch", variant("finalize_pack_stacked", g, lanes),
          n.data_ptr(), s.data_ptr(), ss.data_ptr(), table.data_ptr(), maps,
          grid.nx, grid.ny, *bands[:3], float(ndt_cfg.min_pts),
          ndt_cfg.eig_ratio, ndt_cfg.eig_abs_min, bands[3], g, lanes,
          _stream(n))
    return table


def local_bands(w: int, grid, device) -> tuple:
    """K8a's launch shape for ``w`` keyframes on ``grid``: ``(band_rows,
    bands, shared bytes)``. Bands as thin as the card can hold at once
    (``w x bands`` blocks of 256 threads within 8 per SM; one table row
    each at a window's ``w``), each band's lattice rows of int64 sums (48 B
    per bin: ``band_rows + 2`` half-cell rows at overlap 4, ``band_rows``
    cell rows at overlap 1) within ``SMEM_BLOCK``; raises where even one
    row does not fit. ``device=None`` checks the size only."""
    wh, hh = _lattice(grid)
    halo = 2 if grid.overlap == 4 else 0
    row_bytes = wh * 6 * 8
    max_rows = SMEM_BLOCK // row_bytes - halo
    if max_rows < 1:
        raise ValueError(
            f"local_tables: a band of a {wh}-wide lattice needs at least "
            f"{(1 + halo) * row_bytes} B of shared memory, over the "
            f"{SMEM_BLOCK} B a block gets without an opt-in; use a smaller "
            f"LoopConfig.local_half_extent or a larger local_cell")
    resident = 1 if device is None else 8 * _sm_count(device)
    rows = min(max(1, -(-w * hh // resident)), max_rows)
    return rows, -(-hh // rows), (rows + halo) * row_bytes


def _sm_count(dev: torch.device) -> int:
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx not in _SM_COUNT:
        _SM_COUNT[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return _SM_COUNT[idx]


def local_tables(tables, slot, ok, points, mask, grid, ndt_cfg,
                 compact: bool = False):
    """K8a: for every keyframe ``w`` with ``ok[w]``, build its local quad
    table from ``points[w]`` (sensor frame) on ``grid`` (overlap 4 or 1)
    and write it into ``tables[slot[w]]`` in place, full or ``compact``
    rows (see ``csrc/local_tables.cu``). Returns ``tables``. ``slot`` is
    int32; slots outside the cache are skipped. Each table equals
    :func:`finalize_pack` of :func:`halfcell_add` of its scan on empty
    statistics, bit for bit, on every run, in every layout."""
    wh, hh = _lattice(grid)
    g, lanes = _layout(grid, compact)
    local_bands(0, grid, None)       # an oversized lattice raises first
    w, n = mask.shape
    _check(points, "points", shape=(w, n, 2), align=8)
    _check(mask, "mask", dtype=torch.bool, shape=(w, n), align=1)
    _check(slot, "slot", dtype=torch.int32, shape=(w,))
    _check(ok, "ok", dtype=torch.bool, shape=(w,), align=1)
    _check(tables, "tables", shape=(tables.shape[0], wh * hh, g * lanes),
           align=16)
    if w > 0:
        rows, bands, smem = local_bands(w, grid, points.device)
        _call("local_tables_launch", variant("local_tables", g, lanes),
              points.data_ptr(), mask.data_ptr(), slot.data_ptr(),
              ok.data_ptr(), tables.data_ptr(), w, n, grid.nx, grid.ny,
              tables.shape[0], rows, bands, grid.x0, grid.y0, *_frame(grid),
              float(ndt_cfg.min_pts), ndt_cfg.eig_ratio,
              ndt_cfg.eig_abs_min, smem, g, lanes, _stream(points))
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


#: The robust kernels of ``graph.factors.robust_weight``, in the order of
#: their codes in ``csrc/pose_graph.cuh``.
ROBUST_KINDS = ("huber", "cauchy", "tukey", "geman")


def robust_code(kind: str) -> int:
    """K5's code of the robust kernel ``kind``; raises ``ValueError`` on an
    unknown name, as ``graph.factors.robust_weight`` does."""
    if kind not in ROBUST_KINDS:
        raise ValueError(f"unknown robust kernel {kind!r}")
    return ROBUST_KINDS.index(kind)


def _lin_arrive(dev: torch.device, stream: int) -> torch.Tensor:
    """K5's int32 ticket counter on ``stream``, allocated (and zeroed) once
    per (device, stream) and kept: every launch leaves it at 0 (its last
    block resets it, ``csrc/factor_linearize.cu``), and launches on one
    stream never overlap."""
    key = (dev.index, stream)
    buf = _LIN_ARRIVE.get(key)
    if buf is None:
        buf = torch.zeros((), dtype=torch.int32, device=dev)
        _LIN_ARRIVE[key] = buf
    return buf


def _lin_call(poses, bet_i, bet_j, bet_z, bet_sqrt_info, row_mask, fid,
              n_between, rows, window, prior_idx, prior_z, prior_sqrt_info,
              prior_mask, delta, kind, jac):
    """One K5 launch: ``(scalars [3 + 2 * row blocks], f32 outputs or
    None)``; the scalars start with chi^2 and the fresh window's max."""
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
    scal = torch.empty(3 + 2 * blocks, dtype=torch.float32, device=dev)
    stream = _stream(poses)
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
          f, 0, 0, prior_idx.data_ptr(), prior_z.data_ptr(),
          prior_sqrt_info.data_ptr(), prior_mask.data_ptr(), p,
          float(delta), kind, *(ptrs or [None] * 5), scal.data_ptr(),
          _lin_arrive(dev, stream).data_ptr(), stream)
    return scal, out


def factor_linearize(poses, bet_i, bet_j, bet_z, bet_sqrt_info, row_mask,
                     prior_idx, prior_z, prior_sqrt_info, prior_mask,
                     huber_delta: float, fid=None, chi_only: bool = False,
                     robust: str = "huber"):
    """K5: the whitened, robustly weighted (``huber_delta > 0``: the
    ``robust`` kernel of :data:`ROBUST_KINDS` at threshold ``huber_delta``),
    masked linearization of the between factors (every slot, or the
    gathered slots ``fid`` int64 ``[K]``) and the priors (see
    ``csrc/factor_linearize.cu``). ``row_mask`` is bool ``[F]`` (or ``[K]``
    with ``fid``), ``prior_mask`` bool ``[P]``. Returns ``((ai [K,3,3], aj,
    r [K,3]), (ap [P,3,3], rp [P,3]))``, or with ``chi_only`` only chi^2
    ``[]``, summed in a fixed order. An unknown ``robust`` raises
    ``ValueError`` before any check or launch when it would be applied."""
    kind = robust_code(robust) if huber_delta > 0.0 else 0
    rows = bet_i.shape[0] if fid is None else fid.shape[0]
    if fid is not None:
        _check(fid, "fid", dtype=torch.int64, shape=(rows,))
    _check(row_mask, "row_mask", dtype=torch.bool, shape=(rows,), align=1)
    scal, out = _lin_call(poses, bet_i, bet_j, bet_z, bet_sqrt_info,
                          row_mask, fid, None, rows, 0, prior_idx, prior_z,
                          prior_sqrt_info, prior_mask, huber_delta, kind,
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
                        prior_sqrt_info, prior_mask, 0.0, 0, False)
    return scal[1]


#: The longest fresh window K5 takes for S sessions in one launch: one row
#: block of 256 threads a session.
FRESH_MAX_WINDOW = 256


def fresh_residual_max_stacked(poses, bet_i, bet_j, bet_z, bet_sqrt_info,
                               bet_mask, n_between, k: int):
    """K5's fresh window for ``S`` sessions in one launch: ``poses [S, V,
    3]``, ``bet_i`` / ``bet_j [S, F]`` (int64, session-local),
    ``bet_z [S, F, 3]``, ``bet_sqrt_info [S, F, 3, 3]``, ``bet_mask [S,
    F]``, ``n_between [S]`` (int64, read on the card). Row block ``s``
    takes session ``s``'s ``k`` slots (at most :data:`FRESH_MAX_WINDOW`)
    from ``clamp(n_between[s] - k, 0, F - k)``. Returns ``[S]``, each
    session's value the bits of its own :func:`fresh_residual_max`."""
    s, v = poses.shape[:2]
    f = bet_i.shape[1]
    k = min(k, f)
    if not 1 <= k <= FRESH_MAX_WINDOW:
        raise ValueError(f"fresh_residual_max_stacked: a window of {k} "
                         f"slots (1 to {FRESH_MAX_WINDOW} taken)")
    i64 = torch.int64
    _check(poses, "poses", shape=(s, v, 3))
    _check(bet_i, "bet_i", dtype=i64, shape=(s, f))
    _check(bet_j, "bet_j", dtype=i64, shape=(s, f))
    _check(bet_z, "bet_z", shape=(s, f, 3))
    _check(bet_sqrt_info, "bet_sqrt_info", shape=(s, f, 3, 3))
    _check(bet_mask, "bet_mask", dtype=torch.bool, shape=(s, f), align=1)
    _check(n_between, "n_between", dtype=i64, shape=(s,))
    dev = poses.device
    scal = torch.empty(3 + 2 * s, dtype=torch.float32, device=dev)
    stream = _stream(poses)
    _call("factor_linearize_launch", "factor_linearize", poses.data_ptr(),
          bet_i.data_ptr(), bet_j.data_ptr(), bet_z.data_ptr(),
          bet_sqrt_info.data_ptr(), bet_mask.data_ptr(), None,
          n_between.data_ptr(), k, k, f, s, v, None, None, None, None, 0,
          0.0, 0, None, None, None, None, None, scal.data_ptr(),
          _lin_arrive(dev, stream).data_ptr(), stream)
    return scal[3:3 + 2 * s:2]


def pcg_smem(v: int, f: int, p: int) -> int:
    """K6's shared memory for ``v`` poses, ``f`` factor and ``p`` prior
    slots, in bytes: ``pcg_smem`` of ``csrc/pcg_solve.cu``."""
    return 4 * (27 * v + 3 * f + 68) + 4 * (2 * v + 2 * f + p + 38) + f


def pcg_route(v: int, f: int, p: int) -> str:
    """Which kernel solves a graph of these slot counts: ``"block"`` (K6)
    where its state fits the shared memory one block can opt in to on
    Hopper (:data:`SMEM_MAX`, the test K6's launcher makes), else
    ``"grid"`` (K6g). Shapes only, never a timing."""
    return "block" if pcg_smem(v, f, p) <= SMEM_MAX else "grid"


def pcg_grid_plan(v: int, f: int, p: int) -> tuple:
    """K6g's launch on the current device for ``v`` poses, ``f`` factor
    and ``p`` prior slots: ``(blocks, float scratch, int scratch)``, the
    blocks one per 256 poses, capped by how many can be co-resident (a
    cooperative launch's limit). The sums' order follows the blocks, so
    they depend on ``v`` and the card only."""
    if _lib is None:
        build()
    sizes = (ctypes.c_longlong * 3)()
    err = _lib.pcg_grid_plan(v, f, p, sizes)
    if err != 0:
        msg = _lib.ndtpu_cuda_error_string(err).decode()
        raise RuntimeError(f"pcg_grid_plan: CUDA error {err} ({msg})")
    return tuple(sizes)


def _pcg_args(bet_i, bet_j, bet_mask, prior_idx, prior_mask, pose_mask, lin,
              rhs, lam, max_iter, tol, damp_abs):
    """K6's and K6g's checked arguments, up to the outputs, and ``(x,
    iterations, zmax)`` allocated."""
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
    out = (torch.empty((v, 3), dtype=torch.float32, device=dev),
           torch.empty((), dtype=torch.int32, device=dev),
           torch.empty((), dtype=torch.float32, device=dev))
    args = (bet_i.data_ptr(), bet_j.data_ptr(), bet_mask.data_ptr(), f,
            prior_idx.data_ptr(), prior_mask.data_ptr(), p,
            pose_mask.data_ptr(), v, ai.data_ptr(), aj.data_ptr(),
            r.data_ptr(), ap.data_ptr(), rp.data_ptr(),
            None if rhs is None else rhs.data_ptr(), lam_ptr, lam_value,
            float(damp_abs), int(max_iter), float(tol),
            *(t.data_ptr() for t in out))
    return (v, f, p), args, out


def _pcg_scratch(f: int, p: int, blocks: int, dev) -> torch.Tensor:
    """K6's and K6b's device scratch: per block, 12 floats for each of the
    ``2 f + p`` list places (a factor side's terms of the diagonal block
    and gradient in the set-up, its ``A^T y`` in the loop)."""
    return torch.empty(max(blocks * (2 * f + p) * 12, 4),
                       dtype=torch.float32, device=dev)


def pcg_solve(bet_i, bet_j, bet_mask, prior_idx, prior_mask, pose_mask, lin,
              rhs, lam, max_iter: int, tol: float, damp_abs: float = 0.0):
    """K6: the whole PCG solve of ``(H + damping) x = rhs`` in one launch
    of one block of 256 threads over the live factors and active poses
    (see ``csrc/pcg_solve.cu``). ``lin`` is K5's ``((ai, aj, r), (ap,
    rp))``; ``rhs`` f32 ``[V, 3]`` or None for ``-gradient``;
    ``lam`` an f32 ``[]`` tensor (read on the card) or a Python float.
    Returns ``(x [V, 3], iterations [] int32, max |M^-1 rhs| [])``. Raises
    above the graph size one block's shared memory holds (the launcher
    sizes it; :func:`pcg_route` says ``"grid"`` there)."""
    (v, f, p), args, out = _pcg_args(bet_i, bet_j, bet_mask, prior_idx,
                                     prior_mask, pose_mask, lin, rhs, lam,
                                     max_iter, tol, damp_abs)
    scratch = _pcg_scratch(f, p, 1, out[0].device)
    _call("pcg_solve_launch", "pcg_solve", *args, scratch.data_ptr(),
          _stream(out[0]),
          too_big=f"a graph of {v} poses and {f} factors is over the shared "
                  f"memory one block can have; K6g (pcg_solve_grid) solves "
                  f"it, and graph.solve.pcg_solve routes it there "
                  f"(pcg_route)")
    return out


def pcg_solve_grid(bet_i, bet_j, bet_mask, prior_idx, prior_mask, pose_mask,
                   lin, rhs, lam, max_iter: int, tol: float,
                   damp_abs: float = 0.0):
    """K6g: K6's solve, with K6's arguments and outputs, in one cooperative
    launch (:func:`pcg_grid_plan`), the graph in global scratch allocated
    here (see ``csrc/pcg_grid.cu``): any graph device memory holds. A
    cooperative launch the card refuses raises ``RuntimeError``."""
    (v, f, p), args, out = _pcg_args(bet_i, bet_j, bet_mask, prior_idx,
                                     prior_mask, pose_mask, lin, rhs, lam,
                                     max_iter, tol, damp_abs)
    blocks, n_float, n_int = pcg_grid_plan(v, f, p)
    dev = out[0].device
    fs = torch.empty(n_float, dtype=torch.float32, device=dev)
    ints = torch.empty(n_int, dtype=torch.int32, device=dev)
    _call("pcg_grid_launch", "pcg_solve_grid", *args, fs.data_ptr(),
          ints.data_ptr(), blocks, _stream(out[0]))
    return out


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
    scratch = _pcg_scratch(fb, pb, n_blocks, x.device)
    _call("pcg_solve_blocked_launch", "pcg_solve_blocked", bet_i.data_ptr(),
          bet_j.data_ptr(), bet_mask.data_ptr(), fb, prior_idx.data_ptr(),
          prior_mask.data_ptr(), pb, pose_mask.data_ptr(), vb, ai.data_ptr(),
          aj.data_ptr(), r.data_ptr(), ap.data_ptr(), rp.data_ptr(),
          None if rhs is None else rhs.data_ptr(), lam.data_ptr(),
          int(max_iter), x.data_ptr(), scratch.data_ptr(), n_blocks,
          _stream(x),
          too_big=f"a session of {vb} poses and {fb} factors is over the "
                  f"shared memory one block can have")
    return x


#: K7a's shared route: up to this many pose slots (16-bit endpoints and
#: local slots) and :data:`SELECT_MAX_CHUNK` factors per thread of its
#: 1,024-thread block (each thread's flags in four 32-bit registers).
SELECT_MAX_POSES = 65535
SELECT_MAX_CHUNK = 128


def select_smem(v: int, f: int, staged: int = 1) -> int:
    """K7a's shared memory on its shared route for ``v`` pose and ``f``
    factor slots, in bytes: ``select_smem`` of ``csrc/local_system.cu``
    (the pair scan's and the interval's 40 slots of 8 B, the factor mask
    as bits in 4-byte words, 3 B per pose for its local slot and its byte
    of mask and level, and with ``staged`` 4 B per factor for its packed
    endpoints). The route stages the endpoints where that fits
    :data:`SMEM_MAX`, else it keeps them in the graph (``staged=0``)."""
    return 320 + 4 * ((f + 31) // 32) + 3 * v + 4 * f * staged


def select_route(v: int, f: int) -> str:
    """Where K7a keeps its working arrays for a graph of these slot counts:
    ``"shared"`` up to :data:`SELECT_MAX_POSES` pose slots and ``128 x
    1,024`` factor slots (staged whole where :func:`select_smem` fits
    :data:`SMEM_MAX`, else the endpoints read from the graph, within
    ``select_smem(v, f, 0)``), else ``"scratch"`` (a device scratch of
    ``8 v + 2 f`` bytes, allocated per call). Both give the plain
    selection's bits; shapes only, never a timing."""
    if v <= SELECT_MAX_POSES and f <= SELECT_MAX_CHUNK * 1024:
        return "shared"
    return "scratch"


def local_select(bet_i, bet_j, bet_mask, pose_mask, prior_idx, prior_mask,
                 n_between, since, cfg) -> dict:
    """K7a: the k-hop active set, the fits test and the local selection in
    one launch of one block (see ``csrc/local_system.cu``), its working
    arrays where :func:`select_route` says (counted as ``local_select`` or
    ``local_select[scratch]``). ``cfg`` is a ``SolverConfig``;
    ``n_between`` and ``since`` (or None) int64 ``[]`` are read on the
    card. Returns the selection dict of ``graph.incremental.local_select``:
    only what the local path reads."""
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
    scratch, counter = None, "local_select"
    if select_route(v, f) == "scratch":
        scratch = torch.empty(2 * v + -(-2 * f // 4), dtype=torch.int32,
                              device=dev)
        counter = "local_select[scratch]"
    _call("local_select_launch", counter, bet_i.data_ptr(),
          bet_j.data_ptr(), bet_mask.data_ptr(), f, pose_mask.data_ptr(), v,
          prior_idx.data_ptr(), prior_mask.data_ptr(), p,
          n_between.data_ptr(), None if since is None else since.data_ptr(),
          min(cfg.local_fresh_k, f), cfg.local_span_gap, cfg.local_hops,
          cfg.local_poses, cfg.local_factors, p_loc, f_loc, flags.data_ptr(),
          ints.data_ptr(), None if scratch is None else scratch.data_ptr(),
          _stream(flags),
          too_big=f"a graph of {v} poses and {f} factors is over the shared "
                  f"memory one block can have")
    fl = torch.split(flags, [1, p_loc, f_loc, p])
    it = torch.split(ints, [p_loc] + [f_loc] * 5 + [p, p])
    return dict(p_loc=p_loc, ok=fl[0][0], in_set=fl[1], f_sel=fl[2],
                p_act=fl[3], pid=it[0], fid=it[1], ri=it[2], rj=it[3],
                li=it[4], lj=it[5], rp=it[6], lp=it[7])


def assemble_scratch(k: int, p: int, n: int) -> int:
    """int32 words of K7b's per-call device scratch for ``k`` gathered
    slots, ``p`` prior slots and ``n`` local poses: ``assemble_scratch`` of
    ``csrc/local_system.cu`` (the bucketed and the sorted contribution
    lists, two words for each of at most ``4 k + p`` contributions, and
    the ``n + 1`` bucket offsets)."""
    return 4 * (4 * k + p) + n + 1


def _asm_ctl(dev: torch.device, stream: int) -> torch.Tensor:
    """K7b's four int32 counters on ``stream`` (ticket, finished blocks,
    the build's mode, zeroed workers), allocated (and zeroed) once per
    (device, stream) and kept: every launch's last block resets them to 0,
    and launches on one stream never overlap."""
    key = (dev.index, stream)
    buf = _ASM_CTL.get(key)
    if buf is None:
        buf = torch.zeros(4, dtype=torch.int32, device=dev)
        _ASM_CTL[key] = buf
    return buf


def local_assemble(n: int, ai, aj, r, ap, rp, f_sel, ri, li, rj, lj, p_act,
                   p_role, lp):
    """K7b: the local normal equations ``(h_ii [3n, 3n], b_i [3n])`` from
    K5's gathered rows and the priors, routed by role (0 = interior) and
    local slot (see ``csrc/local_system.cu``): one launch; past 256
    contributions its lists go to a per-call scratch of
    :func:`assemble_scratch` words, so any number of gathered rows."""
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
    scratch = torch.empty(assemble_scratch(k, p, n), dtype=torch.int32,
                          device=dev)
    stream = _stream(h)
    _call("local_assemble_launch", "local_assemble", ai.data_ptr(),
          aj.data_ptr(), r.data_ptr(), k, ap.data_ptr(), rp.data_ptr(), p,
          f_sel.data_ptr(), ri.data_ptr(), li.data_ptr(), rj.data_ptr(),
          lj.data_ptr(), p_act.data_ptr(), p_role.data_ptr(), lp.data_ptr(),
          n, h.data_ptr(), b.data_ptr(), scratch.data_ptr(),
          _asm_ctl(dev, stream).data_ptr(), stream,
          too_big=f"{n} local poses' counts are over the shared memory one "
                  f"block can have (h_ii alone would be {36 * n * n} bytes)")
    return h, b


def supernodal_assemble(ai, aj, r, ap, rp, row_ptr, tgt_col, tgt_ptr, code,
                        vec_ptr, vcode, n_shards: int, ni: int, nsl: int,
                        ns: int):
    """K9a: the partitioned normal equations ``(h_ii [P, 3ni, 3ni], h_is
    [P, 3ni, 3nsl], h_ss [3ns, 3ns], b_i [P, 3ni], b_s [3ns])`` from K5's
    blocks, routed by the plan's int32 tables (see ``csrc/supernodal.cu``
    and ``dist.schur.Routes``). One allocation holds all five; the kernel
    writes every float of it once (zeros included)."""
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


def supernodal_assemble_shape(threads: int = 0, chunk: int = 0,
                              blocks_per_sm: int = 0) -> None:
    """Set K9a's and K9c's launch shape for this process: threads per
    block (32-256, a multiple of 32), floats of the chunk each block stages
    per unit of work (a multiple of 4, at most 12,288), and blocks per SM of
    a persistent grid (0: one block per unit); all three 0 restores each
    kernel's default (``csrc/supernodal.cu``). The outputs' bits do not
    depend on it. For ``profile_port.py --assemble-sweep``; nothing on a
    path calls it."""
    if _lib is None:
        build()
    if _lib.supernodal_assemble_shape(threads, chunk, blocks_per_sm):
        raise ValueError(f"supernodal_assemble_shape: no such shape "
                         f"(threads {threads}, chunk {chunk}, blocks per SM "
                         f"{blocks_per_sm})")


def schur_reduce(s_part, rhs_part, h_ss, b_s, hold_ptr, hold_shard, hold_loc,
                 loc_of, touch_ptr, touch_col, sep_mask, lam, nsl: int):
    """K9b: ``(s_tot [3ns, 3ns], rhs_tot [3ns])``, the shards' Schur parts
    ``s_part [P, 3nsl, 3nsl]``, ``rhs_part [P, 3nsl]`` routed into the
    separator system ``h_ss``, ``b_s`` and damped by ``lam`` (a Python
    float): ``h_ss`` streamed into ``s_tot``, then the entries of the held
    columns ``touch_ptr`` / ``touch_col`` summed (see
    ``csrc/supernodal.cu``). ``s_tot`` and ``rhs_tot`` are views of one
    allocation, ``s_tot`` placed at the alignment of ``h_ss`` mod 16 bytes
    (the kernel copies in 16-byte vectors)."""
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
    _check(touch_ptr, "touch_ptr", dtype=torch.int32, shape=(ns + 1,))
    _check(touch_col, "touch_col", dtype=torch.int32,
           shape=(touch_col.shape[0],))
    _check(sep_mask, "sep_mask", dtype=torch.bool, shape=(ns,), align=1)
    off = h_ss.data_ptr() % 16 // 4
    out = torch.empty(off + 9 * ns * ns + 3 * ns, dtype=torch.float32,
                      device=s_part.device)
    s_tot = out[off:off + 9 * ns * ns].view(3 * ns, 3 * ns)
    rhs_tot = out[off + 9 * ns * ns:]
    _call("schur_reduce_launch", "schur_reduce", s_part.data_ptr(),
          rhs_part.data_ptr(), h_ss.data_ptr(), b_s.data_ptr(),
          hold_ptr.data_ptr(), hold_shard.data_ptr(), hold_loc.data_ptr(),
          loc_of.data_ptr(), touch_ptr.data_ptr(), touch_col.data_ptr(),
          sep_mask.data_ptr(), float(lam), nsl, ns, s_tot.data_ptr(),
          rhs_tot.data_ptr(), _stream(s_part))
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


def sgh_spread(b: int, n: int, sms: int) -> int:
    """K12's ``R`` for ``b`` poses of one scan of ``n`` beams on a card of
    ``sms`` multiprocessors: ``128 R`` threads per pose, one beam each,
    ``min(ceil(n / 128), 8)`` while the poses' threads (``128 R`` each) stay
    within ``1,024 x sms``, down to 1 (128 threads, beams ``t, t + 128,
    ...`` each) where the poses fill the card alone (``lm_ndt``'s rule,
    :func:`lm_spread`; ``profile_port.py --sgh-sweep`` measured every R
    at config 5's coarse and refine calls). No result depends on it: the
    sums are the first design's bits at every R."""
    return max(1, min(-(-n // 128), LM_MAX_SPREAD, 8 * sms // max(b, 1)))


def ndt_sgh_unpacked(poses, points, mask_f, mean, icov, valid, grid,
                     d2: float, exp_clip: float):
    """K12: the NDT terms of one scan ``points [N, 2]`` (``mask_f [N]``
    f32) at every pose of ``poses [B, 3]`` on an unpacked map of ``G =
    overlap`` grids (``mean [G, C, 2]``, ``icov [G, C, 2, 2]``, ``valid [G,
    C]``), one block of ``128 R`` threads per pose, one beam per thread
    (:func:`sgh_spread`; see ``csrc/ndt_unpacked.cu``; counted as
    ``ndt_sgh_unpacked[g1]`` at overlap 1). Returns ``(f [B], g [B, 3],
    H [B, 3, 3], score [B])``, views of one ``[B, 14]`` allocation."""
    g, c = grid.overlap, grid.n_cells
    b, n = poses.shape[0], points.shape[0]
    _check(poses, "poses", shape=(b, 3))
    _check(points, "points", shape=(n, 2), align=8)
    _check(mask_f, "mask", shape=(n,))
    _check(mean, "mean", shape=(g, c, 2), align=8)
    _check(icov, "icov", shape=(g, c, 2, 2), align=16)
    _check(valid, "valid", shape=(g, c))
    out = torch.empty((b, 14), dtype=torch.float32, device=poses.device)
    if b > 0:
        _call("ndt_sgh_unpacked_launch", variant("ndt_sgh_unpacked", g),
              poses.data_ptr(), points.data_ptr(), mask_f.data_ptr(),
              mean.data_ptr(), icov.data_ptr(), valid.data_ptr(),
              out.data_ptr(), b, n, grid.nx, grid.ny, grid.x0, grid.y0,
              grid.cell, d2, exp_clip, g,
              sgh_spread(b, n, _sm_count(poses.device)), _stream(poses))
    return out[:, 0], out[:, 1:4], out[:, 4:13].view(b, 3, 3), out[:, 13]


#: K10a's tiles (``csrc/slab_accum.cu``): ``SLAB_TILE_CELLS`` cells of one
#: grid (their six int64 sums take 12 KB of a block's shared memory), at
#: most ``SLAB_TILE_ROWS`` rows; points per bin block. Up to
#: ``SLAB_MAX_TILES`` tiles (~6 M cells) the bin blocks keep their two int32
#: counters per tile in shared memory, past it in the work buffer.
SLAB_TILE_CELLS = 256
SLAB_TILE_ROWS = 16
SLAB_BIN_CHUNK = 2048
SLAB_MAX_TILES = (SMEM_MAX - 20 * SLAB_BIN_CHUNK - 256) // 8


class SlabTiles(NamedTuple):
    tw: int      # columns per tile (the last may have fewer)
    th: int      # rows per tile (the last may have fewer)
    nxt: int     # tiles across the slab's width
    nyt: int     # tiles across ny
    tiles: int   # grids * nxt * nyt


def slab_tiles(grids: int, width: int, ny: int) -> SlabTiles:
    """K10a's tile plan for a slab of ``grids x width x ny`` cells:
    ``slab_tile_plan`` of ``csrc/slab_accum.cu``. Tiles of ``th = min(16,
    ny rounded up to a power of two)`` rows by ``tw = 256 / th`` columns, ``nyt = ceil(ny / th)`` bands by ``nxt = ceil(width / tw)``
    strips; tile ``(g x nxt + tx) x nyt + ty`` holds columns ``[tx tw,
    (tx + 1) tw)`` and rows ``[ty th, (ty + 1) th)`` of grid ``g``, cut at
    the slab's edge. Every ``(width, ny)`` is tiled; shapes only, never a
    timing."""
    th = 1
    while th < ny and th < SLAB_TILE_ROWS:
        th *= 2
    tw = SLAB_TILE_CELLS // th
    nxt, nyt = -(-width // tw), -(-ny // th)
    return SlabTiles(tw, th, nxt, nyt, grids * nxt * nyt)


def slab_work(grids: int, m: int, tiles: int) -> int:
    """K10a's per-call int32 work buffer for ``m`` points in ``B =
    ceil(m / 2,048)`` bin blocks: each block's count per tile with the
    tile's total after them (``[tiles, B + 1]``), each block's first slot
    per tile (``[tiles, B]``), and each block's region
    of ``grids x 2,048`` slots for its pairs sorted by tile (the point's
    index) with, beside them, each pair's cell in its tile (one byte)."""
    b = -(-m // SLAB_BIN_CHUNK)
    return 2 * tiles * b + tiles + b * grids * SLAB_BIN_CHUNK * 5 // 4


def slab_accumulate(points, mask, grid, x_lo: int, width: int):
    """K10a: the slab statistics ``(n [G, width, ny], s [.., 2], ss [.., 2,
    2])`` (``G = overlap``) of grid columns ``[x_lo, x_lo + width)`` from
    ``points [M, 2]`` (f32) and ``mask [M]`` (bool), each point counted in
    the cell of each overlap grid that ``ndt.grid.cell_ids`` gives it, if
    that cell is in the map and in the slab (see ``csrc/slab_accum.cu``).
    Summed in 64-bit fixed point in the shared memory of the clusters that
    own each tile (:func:`slab_tiles`): the same result on every run and
    under any order of the points. One ctypes call (bin the pairs by tile,
    scan, sum; three kernels, one at ``M = 0``) into a per-call work
    buffer (:func:`slab_work`), one ``LAUNCHES["slab_accumulate"]``
    (``[g1]`` at overlap 1). Every slab shape and point count is taken:
    past :data:`SLAB_MAX_TILES` tiles, or past the bin blocks whose
    segment offsets fit the sum's shared memory (~56 M points), the
    kernels keep those in the work buffer instead."""
    if width < 1:
        raise ValueError(f"slab_accumulate: width {width} < 1")
    m = points.shape[0]
    _check(points, "points", shape=(m, 2), align=8)
    _check(mask, "mask", dtype=torch.bool, shape=(m,), align=1)
    dev, g, ny = points.device, grid.overlap, grid.ny
    tp = slab_tiles(g, width, ny)
    # ss first, then s and n: the kernel stores ss as float4 and s as
    # float2, aligned whatever G x width x ny is.
    c = g * width * ny
    out = torch.empty(7 * c, dtype=torch.float32, device=dev)
    ss = out[:4 * c].view(g, width, ny, 2, 2)
    s = out[4 * c:6 * c].view(g, width, ny, 2)
    n = out[6 * c:].view(g, width, ny)
    work = torch.empty(slab_work(g, m, tp.tiles), dtype=torch.int32,
                       device=dev)
    _call("slab_accum_launch", variant("slab_accumulate", g),
          points.data_ptr(), mask.data_ptr(), work.data_ptr(), n.data_ptr(),
          s.data_ptr(), ss.data_ptr(), m, grid.nx, ny, x_lo, width, grid.x0,
          grid.y0, grid.cell, g, tp.tw, tp.th, tp.tiles, _stream(points))
    return n, s, ss


#: K10b's threads per block (32, 64, 128, 256 or 512: each its own
#: instantiation); see ``profile_port.py --finalize-sweep``.
FINALIZE_THREADS = 256
_finalize_threads = FINALIZE_THREADS


def finalize_cells_threads(threads: int = 0) -> None:
    """Set K10b's threads per block for this process (0 restores
    :data:`FINALIZE_THREADS`). The outputs' bits do not depend on it. For
    ``profile_port.py --finalize-sweep``; nothing on a path calls it."""
    global _finalize_threads
    if threads not in (0, 32, 64, 128, 256, 512):
        raise ValueError(f"finalize_cells_threads: {threads} threads a "
                         f"block (32, 64, 128, 256 or 512)")
    _finalize_threads = threads or FINALIZE_THREADS


def _strides_match(t: torch.Tensor, want: tuple) -> bool:
    """``t``'s strides are ``want`` on every dimension longer than 1."""
    return all(size == 1 or got == w
               for size, got, w in zip(t.shape, t.stride(), want))


def _aligned(t: torch.Tensor, align: int) -> torch.Tensor:
    """``t`` where it is contiguous and aligned to ``align`` bytes, else a
    contiguous copy (a fresh allocation, aligned to far more)."""
    if t.is_contiguous() and t.data_ptr() % align == 0:
        return t
    return t.clone(memory_format=torch.contiguous_format)


def finalize_inputs(n, s, ss):
    """K10b's input layout for statistics ``n [...]``, ``s [..., 2]``,
    ``ss [..., 2, 2]``: ``("records", n, s, ss)`` where the three are views
    of one contiguous ``[..., 7]`` tensor of records ``[n, sx, sy, sxx,
    sxy, syx, syy]`` (``dist.gridmap._exchange``'s), which K10b reads in
    place (in f32); else ``("arrays", n, s, ss)``, each the tensor given
    where it is contiguous and aligned to its f32 vector (4, 8 and 16
    bytes), else a contiguous copy of it. Host code, any device and dtype:
    no launch."""
    lead = tuple(n.shape)
    unit = tuple(7 * x for x in torch.empty(lead, device="meta").stride())
    p, e = n.data_ptr(), n.element_size()
    if (tuple(s.shape) == lead + (2,) and tuple(ss.shape) == lead + (2, 2)
            and n.numel() > 0
            and all(t.dtype == n.dtype and t.device == n.device
                    for t in (s, ss))
            and s.untyped_storage().data_ptr()
            == ss.untyped_storage().data_ptr()
            == n.untyped_storage().data_ptr()
            and s.data_ptr() == p + e and ss.data_ptr() == p + 3 * e
            and _strides_match(n, unit) and _strides_match(s, unit + (1,))
            and _strides_match(ss, unit + (2, 1))):
        return "records", n, s, ss
    return "arrays", _aligned(n, 4), _aligned(s, 8), _aligned(ss, 16)


def finalize_cells(n, s, ss, ndt_cfg):
    """K10b: ``ndt.grid.finalize`` of statistics of any leading shape
    (``n [...]``, ``s [..., 2]``, ``ss [..., 2, 2]``, f32), in the layout
    :func:`finalize_inputs` finds (the slab exchange's records read in
    place, or three arrays), one thread per cell: ``(mean [..., 2], icov
    [..., 2, 2], valid [...])``, views of one allocation. One
    ``LAUNCHES["finalize_cells"]`` per call with cells."""
    for t, what in ((n, "stats.n"), (s, "stats.s"), (ss, "stats.ss")):
        if not t.is_cuda:
            raise ValueError(f"{what}: expected a CUDA tensor, got "
                             f"{t.device}")
    layout, n, s, ss = finalize_inputs(n, s, ss)
    lead = tuple(n.shape)
    if layout == "records" and n.dtype != torch.float32:
        raise TypeError(f"stats: the kernel takes {torch.float32}, got "
                        f"{n.dtype}")
    if layout == "arrays":
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
              s.data_ptr(), ss.data_ptr(), n.data_ptr(), mean.data_ptr(),
              icov.data_ptr(), valid.data_ptr(), c, float(ndt_cfg.min_pts),
              ndt_cfg.eig_ratio, ndt_cfg.eig_abs_min,
              int(layout == "records"), _finalize_threads, _stream(n))
    return mean, icov, valid


def slab_spread(n: int) -> int:
    """K10c's ``R`` for a scan of ``n`` beams: ``128 R`` threads per pose,
    one beam each, ``min(ceil(n / 128), 8)`` (at least 1); past ``128 x
    8`` beams the block takes them in chunks. No result depends on it: the
    sums are the first design's bits at every R."""
    return max(1, min(-(-n // 128), LM_MAX_SPREAD))


def slab_sgh(poses, points, mask_f, mean, icov, valid, grid, x_lo: int,
             d2: float, exp_clip: float) -> torch.Tensor:
    """K10c: the 15 raw NDT sums ``(f, wsum, w0sum, g [3], H [9])`` of one
    scan ``points [N, 2]`` (``mask_f [N]`` f32) at each pose of ``poses [B,
    3]`` over one rank's slab of a map of ``G = overlap`` grids (``mean [G,
    nx_local, ny, 2]``, ``icov [.., 2, 2]``, ``valid [G, nx_local, ny]``,
    ix-major, grid columns ``[x_lo, x_lo + nx_local)``), one block of ``128
    R`` threads per pose, one beam per thread (:func:`slab_spread`; see
    ``csrc/ndt_unpacked.cu``; counted as ``slab_sgh[g1]`` at overlap 1):
    ``[B, 15]``."""
    g, ny = grid.overlap, grid.ny
    nxl = valid.shape[1]
    b, n = poses.shape[0], points.shape[0]
    _check(poses, "poses", shape=(b, 3))
    _check(points, "points", shape=(n, 2), align=8)
    _check(mask_f, "mask", shape=(n,))
    _check(valid, "valid", shape=(g, nxl, ny))
    _check(mean, "mean", shape=(g, nxl, ny, 2), align=8)
    _check(icov, "icov", shape=(g, nxl, ny, 2, 2), align=16)
    out = torch.empty((b, 15), dtype=torch.float32, device=poses.device)
    spread = slab_spread(n)
    if b > 0:
        _call("slab_sgh_launch", variant("slab_sgh", g), poses.data_ptr(),
              points.data_ptr(), mask_f.data_ptr(), mean.data_ptr(),
              icov.data_ptr(), valid.data_ptr(), out.data_ptr(), b, n,
              grid.nx, ny, x_lo, nxl, grid.x0, grid.y0, grid.cell, d2,
              exp_clip, g, spread, wide_terms_bytes(g, spread),
              _stream(poses))
    return out


def raycast(poses, angles, segments, max_range: float, eps: float
            ) -> torch.Tensor:
    """K11: ranges ``[P, N]`` of the beams ``angles [N]`` from ``poses [P,
    3]`` against the wall segments ``segments [S, 2, 2]`` (all f64 or all
    f32), one block per pose and chunk of at most 256 beams, the segments
    in shared-memory tiles (any S), dividing only where a hit can win (see
    ``csrc/raycast.cu``)."""
    dt = poses.dtype
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"raycast takes float32 or float64, got {dt}")
    p, n, s = poses.shape[0], angles.shape[0], segments.shape[0]
    _check(poses, "poses", dtype=dt, shape=(p, 3))
    _check(angles, "angles", dtype=dt, shape=(n,))
    _check(segments, "segments", dtype=dt, shape=(s, 2, 2))
    out = torch.empty((p, n), dtype=dt, device=poses.device)
    if p * n > 0:
        _call("raycast_launch", "raycast", poses.data_ptr(),
              angles.data_ptr(), segments.data_ptr(), out.data_ptr(), p, n, s,
              float(max_range), float(eps), int(dt == torch.float64),
              _stream(poses))
    return out


def voxel_smem(n: int, route: str = "table") -> int:
    """K13's shared memory per block for a scan of ``n`` points, in bytes
    (``voxel_smem`` of ``csrc/voxel_downsample.cu``): on the table route 4
    B of id and two 4-byte table slots a point, on the scan route 4 B of
    id a point."""
    return 12 * n if route == "table" else 4 * n


def voxel_route(n: int) -> str:
    """K13's route for scans of ``n`` points, one block of 256 threads a
    scan on either: ``"table"`` where the scan's ids and table fit
    :data:`SMEM_MAX` (n <= 19,370), else ``"scan"`` (n <= 58,112; the
    wrapper raises past it). Both give the plain mask's bits."""
    return "scan" if voxel_smem(n) > SMEM_MAX else "table"


def voxel_downsample(points, mask, voxel: float) -> torch.Tensor:
    """K13: the thinned mask ``[T, N]`` of scans ``points [T, N, 2]`` (f32)
    with ``mask [T, N]`` (bool): per scan the lowest-index valid point of
    each ``voxel`` cell, on the route of :func:`voxel_route` (see
    ``csrc/voxel_downsample.cu``; the scan route counted as
    ``voxel_downsample[scan]``). Raises ``ValueError`` when a scan's N
    int32 ids do not fit a block's shared memory (N > 58,112)."""
    t, n = mask.shape
    _check(points, "points", shape=(t, n, 2), align=8)
    _check(mask, "mask", dtype=torch.bool, shape=(t, n), align=1)
    keep = torch.empty((t, n), dtype=torch.bool, device=points.device)
    if t * n > 0:
        route = voxel_route(n)
        _call("voxel_downsample_launch",
              "voxel_downsample" if route == "table"
              else "voxel_downsample[scan]",
              points.data_ptr(), mask.data_ptr(), keep.data_ptr(), t, n,
              float(voxel), int(route == "scan"), SMEM_MAX, _stream(points),
              too_big=f"{n} points per scan do not fit a block's "
                      f"{SMEM_MAX} bytes of shared memory (4 B each)")
    return keep


#: K14's longest window: one warp computes a window's slots by ballots.
WINDOW_MAX = 32


def _addresses(tensors) -> ctypes.Array:
    """The tensors' device addresses as a host array of 64-bit words (the
    launcher copies them into its argument struct, in this order)."""
    return (ctypes.c_longlong * len(tensors))(*(t.data_ptr()
                                                for t in tensors))


def window_append(g_poses, pose_mask, bet_i, bet_j, bet_z, bet_sqrt_info,
                  bet_mask, n_poses, n_between, kf_poses, kf_points,
                  kf_masks, kf_live, kf_n, map_kf_poses, last_kf_idx,
                  last_kf_reg, poses, hessians, pts, msk, is_kf) -> tuple:
    """K14: the masked appends of one window of ``W`` scans for each of ``S``
    sessions (leading axis of every argument), one launch (see
    ``csrc/window_append.cu``). Graph ``g_poses [S, V, 3]``, ``pose_mask
    [S, V]``, ``bet_i``/``bet_j [S, F]`` (int64), ``bet_z [S, F, 3]``,
    ``bet_sqrt_info [S, F, 3, 3]``, ``bet_mask [S, F]``, counters ``n_poses``
    / ``n_between [S]`` (int64); keyframe store ``kf_poses [S, K, 3]``,
    ``kf_points [S, K, N, 2]``, ``kf_masks [S, K, N]``, ``kf_live [S, K]``,
    ``kf_n [S]``; ``map_kf_poses [S, M, 3]``; ``last_kf_idx [S]`` (int64),
    ``last_kf_reg [S, 3]``; the window's ``poses [S, W, 3]``, ``hessians
    [S, W, 3, 3]``, ``pts [S, W, N, 2]``, ``msk [S, W, N]``, ``is_kf [S,
    W]``. f32 values, bool masks, W <= :data:`WINDOW_MAX`. Returns new
    tensors (the inputs are not written): the 15 arrays and counters with
    the window's rows, then ``slot``, ``ok``, ``cum``, ``kslot`` ``[S, W]``,
    ``node_vals [S, W, 3]``, ``last_idx [S]``, ``lkr [S, 3]``, ``any_kf
    [S]``, ``kf_idx_out [S, W]``, ``rel_out [S, W, 3]``, ``nd_out [S, W]``
    (int32): :func:`ndtpu_torch.slam.appends.window_append_ref`'s order."""
    s, w = is_kf.shape
    v, f = g_poses.shape[1], bet_i.shape[1]
    k, n = kf_points.shape[1], kf_points.shape[2]
    m = map_kf_poses.shape[1]
    if not 1 <= w <= WINDOW_MAX:
        raise ValueError(f"window_append: a window of {w} scans (1 to "
                         f"{WINDOW_MAX} taken)")
    i64, b8 = torch.int64, torch.bool
    spec = ((g_poses, "graph.poses", None, (s, v, 3), 4),
            (pose_mask, "graph.pose_mask", b8, (s, v), 1),
            (bet_i, "graph.bet_i", i64, (s, f), 8),
            (bet_j, "graph.bet_j", i64, (s, f), 8),
            (bet_z, "graph.bet_z", None, (s, f, 3), 4),
            (bet_sqrt_info, "graph.bet_sqrt_info", None, (s, f, 3, 3), 4),
            (bet_mask, "graph.bet_mask", b8, (s, f), 1),
            (n_poses, "graph.n_poses", i64, (s,), 8),
            (n_between, "graph.n_between", i64, (s,), 8),
            (kf_poses, "kf.poses", None, (s, k, 3), 4),
            (kf_points, "kf.points", None, (s, k, n, 2), 8),
            (kf_masks, "kf.masks", b8, (s, k, n), 1),
            (kf_live, "kf.live", b8, (s, k), 1),
            (kf_n, "kf.n", i64, (s,), 8),
            (map_kf_poses, "map_kf_poses", None, (s, m, 3), 4),
            (last_kf_idx, "last_kf_idx", i64, (s,), 8),
            (last_kf_reg, "last_kf_reg", None, (s, 3), 4),
            (poses, "poses", None, (s, w, 3), 4),
            (hessians, "hessians", None, (s, w, 3, 3), 4),
            (pts, "pts", None, (s, w, n, 2), 8),
            (msk, "msk", b8, (s, w, n), 1),
            (is_kf, "is_kf", b8, (s, w), 1))
    for t, what, dt, shape, align in spec:
        _check(t, what, dtype=dt or torch.float32, shape=shape, align=align)
    ins = [t for t, *_ in spec]
    outs = [torch.empty_like(t) for t in ins[:15]]
    dev = g_poses.device
    new = lambda shape, dt=i64: torch.empty(shape, dtype=dt, device=dev)
    aux = [new((s, w)), new((s, w), b8), new((s, w)), new((s, w)),
           new((s, w, 3), torch.float32), new((s,)),
           new((s, 3), torch.float32), new((s,), b8), new((s, w)),
           new((s, w, 3), torch.float32), new((s, w), torch.int32)]
    _call("window_append_launch", "window_append",
          _addresses(ins + outs + aux), s, w, v, f, k, n, m, _stream(g_poses))
    return tuple(outs + aux)


def loop_append(bet_i, bet_j, bet_z, bet_sqrt_info, bet_mask, n_between,
                accept, loop_j, loop_z, loop_sqrt_info, innov, slot_k, sel,
                has, w: int) -> tuple:
    """K14's loop entry (counted as ``window_append[loops]``): the accepted
    loop lanes of a window's ``K`` queries x ``C`` candidates appended as
    between factors, for ``S`` sessions, one launch. Factors ``bet_i`` /
    ``bet_j [S, F]`` (int64), ``bet_z [S, F, 3]``, ``bet_sqrt_info [S, F,
    3, 3]``, ``bet_mask [S, F]``, ``n_between [S]``; lanes ``accept [S, K,
    C]`` (masked by the detect cadence), ``loop_j [S, K, C]`` (int64),
    ``loop_z [S, K, C, 3]``, ``loop_sqrt_info [S, K, C, 3, 3]``, ``innov [S,
    K, C]`` (innovation-rejected, masked likewise); per query ``slot_k``,
    ``sel [S, K]`` (int64: graph slot, scan) and ``has [S, K]``. Returns new
    tensors: the factor arrays and ``n_between``, then per scan ``nl``,
    ``ld``, ``ni [S, w]`` (int32: loops appended, dropped at capacity,
    innovation-rejected)."""
    s, kq, c = accept.shape
    f = bet_i.shape[1]
    if kq * c > 12288:
        raise ValueError(f"loop_append: {kq} x {c} lanes a session (12,288 "
                         f"taken)")
    i64, b8 = torch.int64, torch.bool
    spec = ((bet_i, "bet_i", i64, (s, f), 8), (bet_j, "bet_j", i64, (s, f), 8),
            (bet_z, "bet_z", None, (s, f, 3), 4),
            (bet_sqrt_info, "bet_sqrt_info", None, (s, f, 3, 3), 4),
            (bet_mask, "bet_mask", b8, (s, f), 1),
            (n_between, "n_between", i64, (s,), 8),
            (accept, "accept", b8, (s, kq, c), 1),
            (loop_j, "loops.j", i64, (s, kq, c), 8),
            (loop_z, "loops.z", None, (s, kq, c, 3), 4),
            (loop_sqrt_info, "loops.sqrt_info", None, (s, kq, c, 3, 3), 4),
            (innov, "innov", b8, (s, kq, c), 1),
            (slot_k, "slot_k", i64, (s, kq), 8), (sel, "sel", i64, (s, kq), 8),
            (has, "has", b8, (s, kq), 1))
    for t, what, dt, shape, align in spec:
        _check(t, what, dtype=dt or torch.float32, shape=shape, align=align)
    ins = [t for t, *_ in spec]
    outs = [torch.empty_like(t) for t in ins[:6]]
    counts = [torch.empty((s, w), dtype=torch.int32, device=bet_i.device)
              for _ in range(3)]
    _call("loop_append_launch", "window_append[loops]",
          _addresses(ins + outs + counts), s, f, kq, c, w, _stream(bet_i))
    return tuple(outs + counts)


def rows_set(dst, idx, ok, src) -> torch.Tensor:
    """K14's row entry (counted as ``window_append[rows]``): a new ``[S, R,
    C]`` f32 tensor, ``dst`` with row ``idx[s, m]`` replaced by ``src[s,
    m]`` where ``ok[s, m]`` (the last such ``m`` where indices repeat; an
    index outside ``[0, R)`` writes nothing), ``idx [S, M]`` int64, ``ok
    [S, M]`` bool, ``src [S, M, C]``; one launch."""
    s, r, c = dst.shape
    m = idx.shape[1]
    _check(dst, "dst", shape=(s, r, c))
    _check(idx, "idx", dtype=torch.int64, shape=(s, m), align=8)
    _check(ok, "ok", dtype=torch.bool, shape=(s, m), align=1)
    _check(src, "src", shape=(s, m, c))
    out = torch.empty_like(dst)
    if dst.numel() > 0:
        _call("rows_set_launch", "window_append[rows]", dst.data_ptr(),
              idx.data_ptr(), ok.data_ptr(), src.data_ptr(), out.data_ptr(),
              s, r, c, m, _stream(dst))
    return out


#: The most keyframe slots a store may have for K15's candidate search
#: (``kMaxSlots`` of ``csrc/loop_lanes.cu``). The search streams the store
#: through each warp's running top C, so its shared memory (two lists of C
#: keys for each of 8 warps, 16 KB at C = 128) does not grow with the
#: store; the limit is the largest store the card tests hold bit-equal to
#: the plain version.
LOOP_LANES_MAX_CAP = 16384


def loop_lanes_check(cap: int, c: int) -> None:
    """Raise where K15 cannot take ``c`` candidates a query over stores of
    ``cap`` slots (``c`` <= :data:`GATE_MAX_LANES` and ``cap``; ``cap`` <=
    :data:`LOOP_LANES_MAX_CAP`)."""
    _gate_width(c)
    if c > cap:
        raise ValueError(f"loop_lanes: {c} candidates from a store of {cap} "
                         f"slots")
    if cap > LOOP_LANES_MAX_CAP:
        raise ValueError(
            f"loop_lanes: a keyframe store of {cap} slots; the candidate "
            f"search takes up to {LOOP_LANES_MAX_CAP} slots "
            f"(KeyframeConfig.capacity <= {LOOP_LANES_MAX_CAP})")


def loop_lanes(kf_poses, kf_live, points, mask, poses, sel, query_index,
               radius: float, min_gap: int, c: int, stride: int = 1,
               lanes: bool = True, cand_idx=None, cand_mask=None) -> tuple:
    """K15: the loop verify's set-up for ``S x K`` queries in one launch (see
    ``csrc/loop_lanes.cu``). Stores ``kf_poses [S, cap, 3]`` (f32),
    ``kf_live [S, cap]``; windows ``points [S, W, N, 2]``, ``mask [S, W,
    N]``, ``poses [S, W, 3]``; per query its row in the window ``sel [S,
    K]`` and its index ``query_index [S, K]`` (int64). Without
    ``cand_idx`` / ``cand_mask`` (int64 / bool ``[S, K, C]``) it searches:
    the ``c`` nearest live keyframes within ``radius`` and ``min_gap`` below
    the query's index, equal distances in index order, the lowest-index
    others masked off where fewer qualify. With ``lanes`` it also writes
    the ``S K c`` lanes of the gated ``lm_ndt``: ``init [S K c, 3]``,
    ``group [S K c]`` (int32, ``s cap + idx``), ``query_idx [S K]``
    (int64, ``query_index + s cap``) and the query's scan at every
    ``stride``-th beam, ``px``, ``py``, ``mask_f [S K c, ceil(N /
    stride)]`` (``points`` and ``mask`` may be None without ``lanes``).
    Returns ``(idx, mask, dist, init, group, query_idx, px, py,
    mask_f)``: the given candidates (``dist`` None) where given, None for
    the lanes without ``lanes``."""
    s, cap = kf_live.shape
    loop_lanes_check(cap, c)
    w, k = poses.shape[1], sel.shape[1]
    n = mask.shape[2] if lanes else 1
    i64, b8, f32 = torch.int64, torch.bool, torch.float32
    spec = [(kf_poses, "kf.poses", f32, (s, cap, 3), 4),
            (kf_live, "kf.live", b8, (s, cap), 1),
            (poses, "poses", f32, (s, w, 3), 4),
            (sel, "sel", i64, (s, k), 8),
            (query_index, "query_index", i64, (s, k), 8)]
    if lanes:
        spec += [(points, "points", f32, (s, w, n, 2), 8),
                 (mask, "mask", b8, (s, w, n), 1)]
    given = cand_idx is not None
    if given:
        spec += [(cand_idx, "cand_idx", i64, (s, k, c), 8),
                 (cand_mask, "cand_mask", b8, (s, k, c), 1)]
    for t, what, dt, shape, align in spec:
        _check(t, what, dtype=dt, shape=shape, align=align)
    if stride < 1:
        raise ValueError(f"loop_lanes: beam stride {stride}")
    dev = kf_poses.device
    new = lambda shape, dt=f32: torch.empty(shape, dtype=dt, device=dev)
    cands = ((cand_idx, cand_mask, None) if given
             else (new((s, k, c), i64), new((s, k, c), b8), new((s, k, c))))
    n_out = -(-n // stride)
    b = s * k * c
    out = ((new((b, 3)), new((b,), torch.int32), new((s * k,), i64),
            new((b, n_out)), new((b, n_out)), new((b, n_out))) if lanes
           else (None,) * 6)
    if b > 0:
        ptrs = [0 if t is None else t.data_ptr()
                for t in [kf_poses, kf_live, points if lanes else None,
                          mask if lanes else None, poses, sel, query_index,
                          cand_idx, cand_mask]
                + ([None] * 3 if given else list(cands)) + list(out)]
        _call("loop_lanes_launch", "loop_lanes",
              (ctypes.c_longlong * len(ptrs))(*ptrs), s * k, k, c, w, n, cap,
              stride, n_out, radius, int(min_gap), _stream(kf_poses))
    return cands + out


def refresh_smem(cap: int, m: int) -> int:
    """K16's dynamic shared memory for stores of ``cap`` slots and ``m``
    selected keyframes a session: 8 B a candidate (at most ``min(m, 32)``
    of each 32 slots; ``max_candidates`` of ``csrc/refresh_points.cu``) and
    41 B a selected keyframe (its slot, staleness, both poses' cos, sin, x
    and y, its mask), rounded up to 16 B."""
    cand = min(cap, -(-cap // 32) * min(m, 32))
    return -(-(8 * cand + 41 * m) // 16) * 16


def refresh_max_cap(m: int) -> int:
    """The largest store K16 takes with ``m`` selected keyframes a session
    (:func:`refresh_smem` within :data:`SMEM_MAX`), or 0 where none."""
    lo, hi = 0, 1 << 24
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if mid >= m and refresh_smem(mid, m) <= SMEM_MAX:
            lo = mid
        elif mid < m:
            lo = mid
        else:
            hi = mid - 1
    return lo if lo >= m else 0


def refresh_check(cap: int, m: int, n: int) -> None:
    """Raise where K16 cannot select ``m`` of ``cap`` slots a session with
    scans of ``n`` beams: ``1 <= m <= cap``, ``m n < 2^30``, and
    :func:`refresh_smem` within one block's shared memory
    (:data:`SMEM_MAX`; :func:`refresh_max_cap` slots)."""
    if not 1 <= m <= cap:
        raise ValueError(f"refresh_points: {m} keyframes from a store of "
                         f"{cap} slots")
    if m * n >= 1 << 30:
        raise ValueError(f"refresh_points: {m} x {n} points a session")
    if refresh_smem(cap, m) > SMEM_MAX:
        raise ValueError(
            f"refresh_points: a keyframe store of {cap} slots with "
            f"refresh_top_m = {m} needs {refresh_smem(cap, m)} B of one "
            f"block's shared memory (8 B a candidate slot + 41 B a selected "
            f"keyframe; {SMEM_MAX} B taken: at most {refresh_max_cap(m)} "
            f"slots)")


def refresh_points(kf_poses, kf_live, kf_points, kf_masks, mkp, enable,
                   m: int, eps: float) -> tuple:
    """K16: ``pipeline._refresh_map``'s points for ``S`` sessions in one
    launch (see ``csrc/refresh_points.cu``). Stores ``kf_poses [S, cap,
    3]`` (f32), ``kf_live [S, cap]``, ``kf_points [S, cap, N, 2]``,
    ``kf_masks [S, cap, N]``, the poses the maps saw ``mkp [S, cap, 3]``,
    ``enable [S]`` bool or None (every session). Selects each session's
    ``m`` stalest keyframes (``lax.top_k``: equal staleness in index
    order). Returns ``(both [S, 2 m N, 2], bmsk [S, 2 m N], wts [S, 2 m N],
    sel [S, m] int64, do [S, m] bool, rows [S, m, 3])``: the selected scans
    at their old poses, then at their smoothed poses, their masks (``masks
    & live & do``) and weights (-1, then +1), ``do = stale > eps &
    enable``, and ``kf_poses[sel]``. :func:`refresh_check` raises past its
    limits before any device check."""
    s, cap, n = kf_masks.shape
    refresh_check(cap, m, n)
    f32, b8 = torch.float32, torch.bool
    spec = [(kf_poses, "kf.poses", f32, (s, cap, 3), 4),
            (kf_live, "kf.live", b8, (s, cap), 1),
            (kf_points, "kf.points", f32, (s, cap, n, 2), 8),
            (kf_masks, "kf.masks", b8, (s, cap, n), 1),
            (mkp, "map_kf_poses", f32, (s, cap, 3), 4)]
    if enable is not None:
        spec.append((enable, "enable", b8, (s,), 1))
    for t, what, dt, shape, align in spec:
        _check(t, what, dtype=dt, shape=shape, align=align)
    dev = kf_poses.device
    out = (torch.empty((s, 2 * m * n, 2), dtype=f32, device=dev),
           torch.empty((s, 2 * m * n), dtype=b8, device=dev),
           torch.empty((s, 2 * m * n), dtype=f32, device=dev),
           torch.empty((s, m), dtype=torch.int64, device=dev),
           torch.empty((s, m), dtype=b8, device=dev),
           torch.empty((s, m, 3), dtype=f32, device=dev))
    ptrs = [0 if t is None else t.data_ptr()
            for t in (kf_poses, kf_live, kf_points, kf_masks, mkp, enable)
            + out]
    smem = refresh_smem(cap, m)
    _call("refresh_points_launch", "refresh_points",
          (ctypes.c_longlong * len(ptrs))(*ptrs), s, cap, m, n, float(eps),
          smem, _stream(kf_poses),
          too_big=f"{smem} B of shared memory for a store of {cap} slots")
    return out
