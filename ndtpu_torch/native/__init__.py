"""Native (C++) host-side components, and the fill-reducing orderings.

Port of ``ndtpu/native/__init__.py``. ``carmen_parser.cpp`` (the CARMEN
log scanner) and ``ordering.cpp`` (reverse Cuthill-McKee and greedy
minimum degree) are copies of the JAX package's sources, built with g++
on first use into ``<repo>/build/ndtpu_torch_native/`` and bound with
``ctypes``. Where g++ is missing the callers take the Python routes, as
the JAX package does: :func:`ndtpu_torch.data.carmen.read_carmen`, and
scipy's reverse Cuthill-McKee for the orderings;
:func:`ndtpu_native_available` says which runs. This is host I/O and
symbolic work, not a device kernel.

:func:`rcm_order` is scipy's reverse Cuthill-McKee (the supernodal plan's
ordering; its callers take any permutation, so no numerical result
depends on which RCM ran); :func:`amd_order` is the native greedy
minimum-degree ordering, scipy's RCM without the library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

__all__ = ["ndtpu_native_available", "load_library", "parse_carmen_native",
           "rcm_order", "amd_order"]

_HERE = Path(__file__).resolve().parent
_SOURCES = ("carmen_parser.cpp", "ordering.cpp")
BUILD_DIR = _HERE.parents[1] / "build" / "ndtpu_torch_native"
# No -march=native (the JAX package's flag): a checkout, and the build in
# it, may move between hosts of different CPUs.
_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]
_lock = threading.Lock()
_lib = None
_build_error: str | None = None


def _build() -> tuple:
    """Compile the sources (if no build of them exists) into a library whose
    name carries their hash; returns ``(path, error or None)``."""
    srcs = [_HERE / s for s in _SOURCES]
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for s in srcs:
        h.update(s.name.encode() + s.read_bytes())
    so = BUILD_DIR / f"libndtpu_native_{h.hexdigest()[:16]}.so"
    if so.exists():
        return so, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *_FLAGS, "-o", str(tmp), *map(str, srcs)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except FileNotFoundError:
        return so, "g++ not found"
    except subprocess.CalledProcessError as err:
        return so, err.stderr.decode(errors="replace")[:2000]
    except subprocess.TimeoutExpired:
        return so, "native build timed out"
    os.replace(tmp, so)
    return so, None


def load_library():
    """The ctypes library handle, building on demand; None if unavailable."""
    global _lib, _build_error
    with _lock:
        if _lib is not None or _build_error is not None:
            return _lib
        so, _build_error = _build()
        if _build_error is not None:
            return None
        lib = ctypes.CDLL(str(so))
        f32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        f64 = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
        lib.carmen_parse.restype = ctypes.c_void_p
        lib.carmen_parse.argtypes = [ctypes.c_char_p]
        lib.carmen_num_scans.argtypes = [ctypes.c_void_p]
        lib.carmen_max_beams.argtypes = [ctypes.c_void_p]
        lib.carmen_fill.argtypes = [ctypes.c_void_p, f32, ctypes.c_float,
                                    i32, f64, f64, f64]
        lib.carmen_free.argtypes = [ctypes.c_void_p]
        lib.carmen_meta.restype = ctypes.c_int
        lib.carmen_meta.argtypes = [ctypes.c_void_p, f64]
        for name in ("rcm_order", "amd_order"):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            fn.argtypes = [i32, i32, ctypes.c_int, ctypes.c_int, i32]
        _lib = lib
        return _lib


def ndtpu_native_available() -> bool:
    return load_library() is not None


def parse_carmen_native(path: str, max_range: float = 81.9):
    """Native CARMEN parse: the same ``CarmenLog`` as
    :func:`ndtpu_torch.data.carmen.read_carmen`. Raises ``RuntimeError`` if
    the library is unavailable."""
    from ndtpu_torch.data.carmen import CarmenLog

    lib = load_library()
    if lib is None:
        raise RuntimeError(f"native library unavailable: {_build_error}")
    h = lib.carmen_parse(str(path).encode())
    if not h:
        raise FileNotFoundError(path)
    try:
        t = lib.carmen_num_scans(h)
        if t == 0:
            raise ValueError(f"no laser lines found in {path}")
        mb = lib.carmen_max_beams(h)
        ranges = np.empty((t, mb), np.float32)
        n_beams = np.empty(t, np.int32)
        lp = np.empty((t, 3), np.float64)
        op = np.empty((t, 3), np.float64)
        ts = np.empty(t, np.float64)
        lib.carmen_fill(h, ranges.reshape(-1), np.float32(max_range),
                        n_beams, lp.reshape(-1), op.reshape(-1), ts)
        meta = np.empty(3, np.float64)
        has_meta = lib.carmen_meta(h, meta)
    finally:
        lib.carmen_free(h)
    sa, fv, mr = meta if has_meta else (np.nan, np.nan, np.nan)
    return CarmenLog(ranges=ranges, n_beams=n_beams, laser_pose=lp,
                     odom_pose=op, timestamps=ts, start_angle=float(sa),
                     fov=float(fv), log_max_range=float(mr))


def _scipy_rcm(ei, ej, n_vertices: int) -> np.ndarray:
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    a = coo_matrix((np.ones(len(ei)), (ei, ej)),
                   shape=(n_vertices, n_vertices))
    return np.asarray(reverse_cuthill_mckee((a + a.T).tocsr(),
                                            symmetric_mode=True), np.int32)


def rcm_order(edges_i, edges_j, n_vertices: int) -> np.ndarray:
    """Reverse Cuthill-McKee ordering (position -> vertex), int32."""
    return _scipy_rcm(np.ascontiguousarray(edges_i, np.int32),
                      np.ascontiguousarray(edges_j, np.int32), n_vertices)


def amd_order(edges_i, edges_j, n_vertices: int) -> np.ndarray:
    """Greedy minimum-degree elimination ordering (position -> vertex),
    int32; scipy's reverse Cuthill-McKee where the library is missing."""
    ei = np.ascontiguousarray(edges_i, np.int32)
    ej = np.ascontiguousarray(edges_j, np.int32)
    lib = load_library()
    if lib is not None:
        out = np.empty(n_vertices, np.int32)
        if lib.amd_order(ei, ej, len(ei), n_vertices, out) == 0:
            return out
    return _scipy_rcm(ei, ej, n_vertices)
