"""Structured metrics: JSONL records, timers, run summaries, ASCII map.

Copy of ``ndtpu/utils/metrics.py`` (numpy-only, but ``ndtpu.utils`` imports
JAX through its package ``__init__``). ``trace`` records a
``torch.profiler`` trace instead of a ``jax.profiler`` one.
"""

from __future__ import annotations

import contextlib
import json
import time
from typing import Any, IO

import numpy as np

__all__ = ["JsonlLogger", "timer", "trace", "summarize_run", "map_to_ascii"]


class JsonlLogger:
    """Append-only JSONL metrics stream."""

    def __init__(self, path: str):
        self.path = path
        self._f: IO[str] | None = None

    def __enter__(self):
        self._f = open(self.path, "a")
        return self

    def __exit__(self, *exc):
        if self._f:
            self._f.close()
            self._f = None

    def write(self, record: dict[str, Any]) -> None:
        rec = dict(record)
        rec.setdefault("ts", time.time())
        f = self._f or open(self.path, "a")
        f.write(json.dumps(rec, default=_np_default) + "\n")
        if self._f is None:
            f.close()
        else:
            f.flush()


def _np_default(x):
    if isinstance(x, (np.integer,)):
        return int(x)
    if isinstance(x, (np.floating,)):
        return float(x)
    if isinstance(x, np.ndarray):
        return x.tolist()
    return str(x)


@contextlib.contextmanager
def timer(record: dict[str, Any], key: str):
    """``with timer(rec, "match_s"): ...`` — wall-clock into the record."""
    t0 = time.perf_counter()
    yield
    record[key] = time.perf_counter() - t0


@contextlib.contextmanager
def trace(path: str):
    """CPU + CUDA trace via ``torch.profiler``, written as a Chrome trace."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(path)


def summarize_run(records: list[dict[str, Any]]) -> dict[str, Any]:
    """End-of-run summary over per-scan records."""
    if not records:
        return {}
    keys = set().union(*(r.keys() for r in records))
    out: dict[str, Any] = {"n_scans": len(records)}
    for k in keys:
        vals = [r[k] for r in records if k in r
                and isinstance(r[k], (int, float))
                and not isinstance(r[k], bool)]
        if vals:
            out[f"{k}_mean"] = float(np.mean(vals))
            out[f"{k}_p95"] = float(np.percentile(vals, 95))
    return out


def map_to_ascii(valid: np.ndarray, width: int = 64) -> str:
    """Occupancy sketch of an NDT map validity grid ``[ny, nx]`` (grid 0)."""
    v = np.asarray(valid, float)
    ny, nx = v.shape
    sx = max(1, nx // width)
    sy = max(1, ny // (width // 2))
    sub = v[::sy, ::sx]
    chars = np.where(sub > 0.5, "#", ".")
    return "\n".join("".join(row) for row in chars[::-1])
