"""Fixed-capacity keyframe store as structure-of-arrays tensors.

Port of ``ndtpu/slam/keyframes.py``. With loop closure on, ``tables`` is
the per-keyframe local-map cache ``[K, R, L]``
(``ndtpu_torch.loop.closure.local_table_shape``); it is ``None`` otherwise.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

__all__ = ["KeyframeStore", "empty_store", "add_keyframe"]


class KeyframeStore(NamedTuple):
    poses: torch.Tensor    # [K, 3] world-from-keyframe transforms
    points: torch.Tensor   # [K, N, 2] sensor-frame scan points
    masks: torch.Tensor    # [K, N] bool beam validity
    live: torch.Tensor     # [K] bool — slot holds a real keyframe
    n: torch.Tensor        # [] int64 — number of live keyframes
    # Per-keyframe local NDT quad table [K, R, L] in the keyframe's sensor
    # frame (built once at creation, never invalidated), or None.
    tables: Optional[torch.Tensor] = None

    @property
    def capacity(self) -> int:
        return self.poses.shape[0]


def empty_store(capacity: int, n_beams: int, dtype=torch.float32,
                device="cpu", table_shape=None) -> KeyframeStore:
    """``table_shape=(rows, lanes)`` allocates the local-map cache."""
    kw = dict(device=device)
    return KeyframeStore(
        poses=torch.zeros((capacity, 3), dtype=dtype, **kw),
        points=torch.zeros((capacity, n_beams, 2), dtype=dtype, **kw),
        masks=torch.zeros((capacity, n_beams), dtype=torch.bool, **kw),
        live=torch.zeros((capacity,), dtype=torch.bool, **kw),
        n=torch.zeros((), dtype=torch.long, **kw),
        tables=(None if table_shape is None else torch.zeros(
            (capacity,) + tuple(table_shape), dtype=dtype, **kw)))


def add_keyframe(kf: KeyframeStore, pose, points, mask, enabled=True,
                 table=None) -> KeyframeStore:
    """Masked append (a new store); dropped when the store is full."""
    enabled = torch.as_tensor(enabled, device=kf.n.device)
    slot = torch.clamp(kf.n, max=kf.capacity - 1)
    ok = enabled & (kf.n < kf.capacity)

    def put(arr, val):
        out = arr.clone()
        out[slot] = torch.where(ok, torch.as_tensor(val, dtype=arr.dtype,
                                                    device=arr.device),
                                arr[slot])
        return out

    live = kf.live.clone()
    live[slot] = ok | kf.live[slot]
    return KeyframeStore(poses=put(kf.poses, pose),
                         points=put(kf.points, points),
                         masks=put(kf.masks, mask), live=live,
                         n=kf.n + ok.to(torch.long),
                         tables=(None if kf.tables is None else
                                 kf.tables if table is None else
                                 put(kf.tables, table)))
