"""Hand-written CUDA kernels for Hopper (``sm_90a``): build, bind, launch.

Five kernels carry the windowed pipeline with loop closure (ROADMAP
Queue B):

============ =============================== =================================
name         source                          replaces (JAX, lowered by XLA)
============ =============================== =================================
ndt_terms    ``csrc/ndt_terms.cu`` (K1)      ``grid.lookup_quad`` (or
                                             ``lookup_quad_grouped``) +
                                             ``match.point_terms_quad``
halfcell     ``csrc/halfcell_add.cu`` (K3)   ``grid._add_points_halfcell``
finalize     ``csrc/finalize_pack.cu`` (K4)  ``grid.finalize`` + ``pack_quad``
local_tables ``csrc/local_tables.cu`` (K8a)  ``closure.build_local_table``
                                             over a window's keyframes
loop_gate    ``csrc/loop_gate.cu`` (K8b)     ``closure._gate_and_pack``
============ =============================== =================================

K1 counts its shared-table launches as ``ndt_terms`` and its grouped
(per-lane table) launches as ``ndt_terms_grouped``. The public wrappers
(``ndt.match.ndt_terms``, ``ndt.grid.halfcell_add``,
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

import torch

__all__ = ["LAUNCHES", "reset_launches", "build", "ndt_terms",
           "halfcell_add", "finalize_pack", "local_tables", "loop_gate"]

#: Launch counts per kernel since the last :func:`reset_launches`.
LAUNCHES = {"ndt_terms": 0, "ndt_terms_grouped": 0, "halfcell_add": 0,
            "finalize_pack": 0, "local_tables": 0, "loop_gate": 0}

#: Shared memory one block can have on Hopper (227 KB).
SMEM_MAX = 232448

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "ndtpu_torch_ext"
_ARCH = "-gencode=arch=compute_90a,code=sm_90a"
_FLAGS = ["-O3", _ARCH, "-std=c++17", "--fmad=false", "-Xptxas=-v",
          "-Xcompiler", "-fPIC"]
_lib = None

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "ndt_terms_launch": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                         _F, _F, _F, _F, _F, _P],
    "halfcell_scatter_launch": [_P, _P, _P, _F, _P, _I, _I, _I, _F, _F, _F,
                                _P],
    "halfcell_pool_launch": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    "finalize_pack_launch": [_P, _P, _P, _P, _I, _I, _F, _F, _F, _P],
    "local_tables_launch": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F,
                            _F, _F, _F, _F, _I, _P],
    "loop_gate_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                         _F, _F, _F, _I, _P],
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


def _call(name: str, counter: str, *args) -> None:
    if _lib is None:
        build()
    err = getattr(_lib, name)(*args)
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
    if group is None:
        _check(table, "table", shape=(wh * hh, 32), align=16)
        n_tables, g_ptr, counter = 1, None, "ndt_terms"
    else:
        _check(group, "group", dtype=torch.int32, shape=(b,))
        _check(table, "tables", shape=(table.shape[0], wh * hh, 32), align=16)
        n_tables, g_ptr, counter = table.shape[0], group.data_ptr(), \
            "ndt_terms_grouped"
    out = torch.empty((b, 11), dtype=torch.float32, device=px.device)
    if b == 0:
        return out.zero_()
    _call("ndt_terms_launch", counter, poses.data_ptr(), px.data_ptr(),
          py.data_ptr(), mask_f.data_ptr(), table.data_ptr(), g_ptr,
          out.data_ptr(), b, n, wh, hh, wh * hh, n_tables, grid.x0, grid.y0,
          2.0 / grid.cell, d2, exp_clip, _stream(px))
    return out


def halfcell_add(n, s, ss, points, mask, weight, grid):
    """K3: ``(n, s, ss) + half-cell moments of points``, as new tensors.

    ``weight`` is a Python float or an f32 ``[M]`` tensor. The scatter uses
    float ``atomicAdd``, so the order of the adds, and with it the last bits
    of the moments, varies from run to run; counts of unit weights are
    exact.
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
    lattice = torch.zeros((hh * wh, 6), dtype=torch.float32, device=dev)
    if m > 0:
        _call("halfcell_scatter_launch", "halfcell_add", points.data_ptr(),
              mask.data_ptr(), w_ptr, w_scalar, lattice.data_ptr(), m, wh, hh,
              grid.x0, grid.y0, 2.0 / grid.cell, _stream(points))
    n2, s2, ss2 = torch.empty_like(n), torch.empty_like(s), torch.empty_like(ss)
    _call("halfcell_pool_launch", "halfcell_add", lattice.data_ptr(),
          n.data_ptr(), s.data_ptr(), ss.data_ptr(), n2.data_ptr(),
          s2.data_ptr(), ss2.data_ptr(), grid.nx, grid.ny, wh,
          _stream(points))
    return n2, s2, ss2


def finalize_pack(n, s, ss, ndt_cfg, grid) -> torch.Tensor:
    """K4: finalize every cell and write the quad table ``[R, 32]``."""
    wh, hh = _lattice(grid)
    c = grid.n_cells
    _check(n, "stats.n", shape=(4, c))
    _check(s, "stats.s", shape=(4, c, 2))
    _check(ss, "stats.ss", shape=(4, c, 2, 2))
    table = torch.empty((hh * wh, 32), dtype=torch.float32, device=n.device)
    _call("finalize_pack_launch", "finalize_pack", n.data_ptr(), s.data_ptr(),
          ss.data_ptr(), table.data_ptr(), grid.nx, grid.ny,
          float(ndt_cfg.min_pts), ndt_cfg.eig_ratio, ndt_cfg.eig_abs_min,
          _stream(n))
    return table


def local_tables(tables, slot, ok, points, mask, grid, ndt_cfg):
    """K8a: for every keyframe ``w`` with ``ok[w]``, build its local quad
    table from ``points[w]`` (sensor frame) on ``grid`` and write it into
    ``tables[slot[w]]`` in place (see ``csrc/local_tables.cu``). Returns
    ``tables``. ``slot`` is int32; slots outside the cache are skipped."""
    wh, hh = _lattice(grid)
    smem = wh * hh * 6 * 4
    if smem > SMEM_MAX:
        raise ValueError(
            f"local_tables: a {wh} x {hh} lattice needs {smem} B of shared "
            f"memory, over the {SMEM_MAX} B a block can have; use a smaller "
            f"LoopConfig.local_half_extent or a larger local_cell")
    w, n = mask.shape
    _check(points, "points", shape=(w, n, 2), align=8)
    _check(mask, "mask", dtype=torch.bool, shape=(w, n), align=1)
    _check(slot, "slot", dtype=torch.int32, shape=(w,))
    _check(ok, "ok", dtype=torch.bool, shape=(w,), align=1)
    _check(tables, "tables", shape=(tables.shape[0], wh * hh, 32), align=16)
    if w > 0:
        _call("local_tables_launch", "local_tables", points.data_ptr(),
              mask.data_ptr(), slot.data_ptr(), ok.data_ptr(),
              tables.data_ptr(), w, n, grid.nx, grid.ny, tables.shape[0],
              grid.x0, grid.y0, 2.0 / grid.cell, float(ndt_cfg.min_pts),
              ndt_cfg.eig_ratio, ndt_cfg.eig_abs_min, smem, _stream(points))
    return tables


def loop_gate(cand_mask, converged, score, pose, init, hessian, cand_idx,
              query_idx, score_gate: float, innov_base: float,
              innov_per_kf: float, k_budget: int):
    """K8b: the loop gate of ``K`` queries x ``C <= 32`` candidates (see
    ``csrc/loop_gate.cu``). ``cand_mask``/``converged`` bool ``[K, C]``,
    ``score [K, C]``, ``pose``/``init [K, C, 3]``, ``hessian [K, C, 3, 3]``
    f32, ``cand_idx`` int32 ``[K, C]``, ``query_idx`` int32 ``[K]``;
    ``innov_per_kf <= 0`` and ``k_budget = 0`` switch those gates off.
    Returns ``(accept, innov_rej, sqrt_info [K, C, 3, 3])``."""
    k, c = score.shape
    if c > 32:
        raise ValueError(f"loop_gate: {c} candidates per query; the kernel "
                         f"runs one warp per query (C <= 32)")
    _check(cand_mask, "cand_mask", dtype=torch.bool, shape=(k, c), align=1)
    _check(converged, "converged", dtype=torch.bool, shape=(k, c), align=1)
    _check(score, "score")
    _check(pose, "pose", shape=(k, c, 3))
    _check(init, "init", shape=(k, c, 3))
    _check(hessian, "hessian", shape=(k, c, 3, 3))
    _check(cand_idx, "cand_idx", dtype=torch.int32, shape=(k, c))
    _check(query_idx, "query_idx", dtype=torch.int32, shape=(k,))
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
