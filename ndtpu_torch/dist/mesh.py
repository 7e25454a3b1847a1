"""The rank's place in a multi-process run, and the collective it uses.

Port of the part of ``ndtpu/dist/mesh.py`` that the distributed Schur solve
needs: :func:`multihost_mesh` (the reference's process-spanning ``Mesh``,
one device per process, the mesh axis mapping shard index to process)
returns this process's rank, the world size and its device. The
reference's ``psum`` over the mesh axis is :func:`all_reduce`, a SUM over
``torch.distributed`` (gloo: it takes CUDA tensors, so two ranks can share
one card; NCCL refuses two ranks on one device). ``batch_mesh``,
``space_mesh`` and ``grid_mesh`` are ROADMAP A11b.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import torch

__all__ = ["RankMesh", "multihost_mesh", "all_reduce", "COLLECTIVES",
           "reset_collectives"]

#: All-reduce calls and the host seconds spent in them (a gloo reduction
#: of CUDA tensors waits for them and copies through the host) since the
#: last :func:`reset_collectives`; single-rank calls are not counted.
COLLECTIVES = {"all_reduce": 0, "all_reduce_s": 0.0}


def reset_collectives() -> None:
    COLLECTIVES.update(all_reduce=0, all_reduce_s=0.0)


class RankMesh(NamedTuple):
    rank: int             # this process's shard index
    size: int             # processes (= shards)
    device: torch.device  # where this rank computes


def multihost_mesh(device="cuda") -> RankMesh:
    """This process's place after ``launch.initialize`` (rank 0 of 1 when
    no process group is up). ``"cuda"`` (the default) picks card ``rank %
    count``, so ranks share the cards round robin, and raises without a
    card; ``"cpu"`` is the plain-torch path."""
    dist = torch.distributed
    up = dist.is_available() and dist.is_initialized()
    rank, size = (dist.get_rank(), dist.get_world_size()) if up else (0, 1)
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("multihost_mesh: no CUDA device is available "
                               "(pass device='cpu' for the plain-torch path)")
        if dev.index is None:
            dev = torch.device("cuda", rank % torch.cuda.device_count())
    return RankMesh(rank, size, dev)


def all_reduce(mesh: RankMesh, t: torch.Tensor) -> torch.Tensor:
    """Sum ``t`` over the ranks in place (the reference's ``psum``) and
    return it; with one rank, ``t`` as it is."""
    if mesh.size == 1:
        return t
    t0 = time.perf_counter()
    torch.distributed.all_reduce(t)
    COLLECTIVES["all_reduce"] += 1
    COLLECTIVES["all_reduce_s"] += time.perf_counter() - t0
    return t
