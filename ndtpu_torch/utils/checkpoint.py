"""Checkpoint / resume for SLAM state.

Port of ``ndtpu/utils/checkpoint.py``. A state is a tree of NamedTuples
(and tuples) of tensors: the map statistics, the keyframe store with its
table cache, the pose graph, the smoother scalars. :func:`save_state`
writes its leaves in flatten order (fields in order, ``None`` skipped) as
``leaf_0 .. leaf_k`` of one ``.npz``, through a temporary file and an
atomic rename; :func:`restore_state` reads them back into the structure of
``like``, checking each leaf's shape and dtype, onto ``like``'s devices.
The restored tensors are new, so a restored state shares no table cache
with a live one (ROADMAP C-w7).
"""

from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch

__all__ = ["leaves", "save_state", "restore_state", "CheckpointManager"]


def leaves(tree: Any) -> list:
    """The tensors of a tree in flatten order (``None`` skipped)."""
    if tree is None:
        return []
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in leaves(t)]
    return [tree]


def _rebuild(like: Any, it) -> Any:
    if like is None:
        return None
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_rebuild(x, it) for x in like))
    if isinstance(like, (tuple, list)):
        return type(like)(_rebuild(x, it) for x in like)
    return next(it)


def save_state(path: str, state: Any) -> None:
    """Save a tree of tensors to ``path`` (an ``.npz``), atomically: a crash
    never leaves a torn checkpoint."""
    arrays = {f"leaf_{i}": x.detach().cpu().numpy()
              for i, x in enumerate(leaves(state))}
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


def restore_state(path: str, like: Any) -> Any:
    """Restore a tree saved by :func:`save_state`; ``like`` gives the
    structure, the shapes and dtypes each leaf must have (``ValueError``
    otherwise) and the device of each."""
    restored = []
    with np.load(path) as data:
        for i, ref in enumerate(leaves(like)):
            arr = data[f"leaf_{i}"]
            want = (tuple(ref.shape), str(ref.dtype).replace("torch.", ""))
            if (arr.shape, str(arr.dtype)) != want:
                raise ValueError(f"checkpoint leaf {i}: saved {arr.shape}/"
                                 f"{arr.dtype} vs expected {want[0]}/"
                                 f"{want[1]}")
            restored.append(torch.from_numpy(arr).to(ref.device))
    return _rebuild(like, iter(restored))


class CheckpointManager:
    """Every-K-steps checkpoint rotation (keep the newest ``keep``).

    ``prefix`` namespaces checkpoints by producer (``ckpt_win_`` for
    windowed-mode states, ``ckpt_scan_`` for per-scan ones, whose trees
    differ), so a resume only sees checkpoints of its own mode."""

    def __init__(self, directory: str, every: int = 50, keep: int = 3,
                 prefix: str = "ckpt_"):
        self.directory = directory
        self.every = every
        self.keep = keep
        self.prefix = prefix
        os.makedirs(directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"{self.prefix}{step:08d}.npz")

    def _mine(self):
        n = len(self.prefix)
        return sorted(
            f for f in os.listdir(self.directory)
            if f.startswith(self.prefix) and f.endswith(".npz")
            and f[n:n + 8].isdigit())

    def maybe_save(self, step: int, state: Any) -> bool:
        if step % self.every != 0:
            return False
        save_state(self._path(step), state)
        self._gc()
        return True

    def _gc(self) -> None:
        for f in self._mine()[: -self.keep]:
            os.remove(os.path.join(self.directory, f))

    def latest_step(self) -> int | None:
        ckpts = self._mine()
        if not ckpts:
            return None
        return int(ckpts[-1][len(self.prefix):len(self.prefix) + 8])

    def restore_latest(self, like: Any):
        step = self.latest_step()
        if step is None:
            return None, None
        return step, restore_state(self._path(step), like)
