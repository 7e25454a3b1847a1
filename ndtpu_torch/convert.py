"""Move state between the JAX package and the port.

``from_numpy(tree, device)`` takes a JAX-package state (``NDTStats``,
``NDTMap``, ``KeyframeStore``, ``PoseGraph``, ``SmootherState``,
``SlamState``, ``merge.AlignResult`` or the slab map's ``SlabStats`` /
``SlabMap`` (kept in their slab layout ``[G, nx_local, ny, ...]``), nested
as it is there) whose leaves are numpy arrays (or anything ``np.asarray``
takes) and returns the port's state of the same name on ``device``.
``to_numpy(tree)`` goes back: the port's state with numpy leaves, integers
as int32 as the JAX package keeps them. Both packages can so start from
the same mid-run state. Types are matched by class name, so this module
never imports the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from ndtpu_torch.dist.gridmap import SlabMap, SlabStats
from ndtpu_torch.graph.factors import PoseGraph
from ndtpu_torch.graph.incremental import SmootherState
from ndtpu_torch.ndt.grid import NDTMap, NDTStats
from ndtpu_torch.slam.keyframes import KeyframeStore
from ndtpu_torch.slam.merge import AlignResult
from ndtpu_torch.slam.pipeline import SlamState

__all__ = ["from_numpy", "to_numpy"]

_TYPES = {cls.__name__: cls for cls in (NDTStats, NDTMap, KeyframeStore,
                                        PoseGraph, SmootherState, SlamState,
                                        AlignResult, SlabStats, SlabMap)}


def _is_state(tree) -> bool:
    return isinstance(tree, tuple) and type(tree).__name__ in _TYPES


def from_numpy(tree, device="cpu"):
    """JAX-package state (numpy leaves) -> the port's state on ``device``."""
    if tree is None:
        return None
    if _is_state(tree):
        cls = _TYPES[type(tree).__name__]
        return cls(*(from_numpy(getattr(tree, f), device)
                     for f in cls._fields))
    a = np.asarray(tree)
    t = torch.as_tensor(a.copy(), device=device)
    if a.dtype.kind in "iu":
        t = t.to(torch.long)
    return t


def to_numpy(tree):
    """The port's state -> the same structure with numpy leaves (integer
    leaves as int32, the JAX package's index type)."""
    if tree is None:
        return None
    if _is_state(tree):
        return type(tree)(*(to_numpy(x) for x in tree))
    a = tree.detach().cpu().numpy()
    if a.dtype.kind in "iu":
        a = a.astype(np.int32)
    return a
