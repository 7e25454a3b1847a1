"""The rank's place in a multi-process run, and the collectives it uses.

Port of ``ndtpu/dist/mesh.py``. The reference's meshes are
``jax.sharding.Mesh`` objects over devices; here every rank is one process
of a ``torch.distributed`` gloo group with one device, and a mesh is that
process's :class:`RankMesh`: its rank, the world size, its device, and the
mesh's axis names and shape.

- :func:`multihost_mesh` (the reference's process-spanning mesh, axis
  ``"space"``), :func:`batch_mesh` (axis ``"batch"``) and
  :func:`space_mesh` (axis ``"space"``) are 1D meshes over every rank;
- :func:`grid_mesh` is the 2D ``("batch", "space")`` mesh: rank ``r`` sits
  at ``(r // n_space, r % n_space)`` (the reference's row-major reshape of
  the device list), and each axis has its own ``new_group`` (the ranks of
  the rank's ``"space"`` row, and of its ``"batch"`` column).

Collectives, each a no-op over an axis of one rank:

- :func:`all_reduce` (over every rank) and :func:`psum` (over one axis):
  the reference's ``psum``, a SUM ``all_reduce`` over gloo, which takes
  CUDA tensors (it stages them through the host), so two ranks can share
  one card. NCCL refuses two ranks on one device (ROADMAP C-w9).
- :func:`ring_exchange`: the reference's two ring ``ppermute``s of
  ``gridmap.build_slab_stats_psharded`` (each rank's high halo to its right
  neighbour, its low halo to its left one, ranks ``d - 1`` and ``0``
  neighbours). gloo's ``send``/``recv`` take CPU tensors only, so the
  exchange is ONE ``all_reduce`` of a zero-filled ``[d, 2, ...]`` buffer
  in which each rank writes only its own two outgoing halos: every entry
  has one non-zero term, so the sum is exact and each rank reads its
  neighbours' halos from it with no host staging of its own. It moves
  ``d`` times the halo bytes a point-to-point exchange would, which at the
  two ranks of config 5 is twice.

:data:`COLLECTIVES` counts both kinds and the host seconds spent in them.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import torch

__all__ = ["RankMesh", "multihost_mesh", "batch_mesh", "space_mesh",
           "grid_mesh", "axis_index", "axis_size", "all_reduce", "psum",
           "ring_exchange", "COLLECTIVES", "reset_collectives"]

#: All-reduce calls (``all_reduce``, ``psum``) and ring exchanges, and the
#: host seconds spent in each (a gloo reduction of CUDA tensors waits for
#: them and copies through the host), since the last
#: :func:`reset_collectives`; calls over one rank are not counted.
COLLECTIVES = {"all_reduce": 0, "all_reduce_s": 0.0, "exchange": 0,
               "exchange_s": 0.0, "exchange_bytes": 0}


def reset_collectives() -> None:
    COLLECTIVES.update(all_reduce=0, all_reduce_s=0.0, exchange=0,
                       exchange_s=0.0, exchange_bytes=0)


class RankMesh(NamedTuple):
    rank: int             # this process's rank in the world
    size: int             # processes in the world
    device: torch.device  # where this rank computes
    axes: tuple = ("space",)  # axis names, major first
    shape: tuple = ()     # ranks per axis; () is (size,)
    groups: tuple = ()    # per axis its process group; () is the world


def _dims(mesh: RankMesh) -> tuple:
    return mesh.shape or (mesh.size,)


def _axis(mesh: RankMesh, axis: str) -> int:
    if axis not in mesh.axes:
        raise ValueError(f"the mesh has axes {mesh.axes}, not {axis!r}")
    return mesh.axes.index(axis)


def axis_size(mesh: RankMesh, axis: str) -> int:
    """Ranks along ``axis`` (the reference's ``mesh.shape[axis]``)."""
    return _dims(mesh)[_axis(mesh, axis)]


def axis_index(mesh: RankMesh, axis: str) -> int:
    """This rank's coordinate along ``axis`` (``lax.axis_index``)."""
    k, dims = _axis(mesh, axis), _dims(mesh)
    stride = 1
    for d in dims[k + 1:]:
        stride *= d
    return (mesh.rank // stride) % dims[k]


def _world():
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _device(device, rank: int) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("multihost_mesh: no CUDA device is available "
                               "(pass device='cpu' for the plain-torch path)")
        if dev.index is None:
            dev = torch.device("cuda", rank % torch.cuda.device_count())
    return dev


def _mesh_1d(device, axis: str) -> RankMesh:
    rank, size = _world()
    return RankMesh(rank, size, _device(device, rank), (axis,))


def multihost_mesh(device="cuda") -> RankMesh:
    """This process's place after ``launch.initialize`` (rank 0 of 1 when
    no process group is up), on a 1D mesh named ``"space"``. ``"cuda"``
    (the default) picks card ``rank % count``, so ranks share the cards
    round robin, and raises without a card; ``"cpu"`` is the plain-torch
    path."""
    return _mesh_1d(device, "space")


def batch_mesh(device="cuda") -> RankMesh:
    """1D mesh over every rank: axis ``"batch"`` (data parallelism over
    registrations or sessions)."""
    return _mesh_1d(device, "batch")


def space_mesh(device="cuda") -> RankMesh:
    """1D mesh over every rank: axis ``"space"`` (map slabs, pose
    shards)."""
    return _mesh_1d(device, "space")


def grid_mesh(n_batch: int, n_space: int, device="cuda") -> RankMesh:
    """2D ``("batch", "space")`` mesh over ``n_batch * n_space`` ranks (the
    world size). Every rank creates every row's and column's group, rows
    first, in the same order (``new_group`` is collective over the world),
    and keeps its own row's (``"space"``) and column's (``"batch"``)."""
    rank, size = _world()
    if n_batch * n_space != size:
        raise ValueError(f"grid_mesh({n_batch}, {n_space}) needs "
                         f"{n_batch * n_space} ranks, the world has {size}")
    dev = _device(device, rank)
    b, s = divmod(rank, n_space)
    if size == 1:
        return RankMesh(rank, size, dev, ("batch", "space"), (1, 1))
    new = torch.distributed.new_group
    rows = [new([i * n_space + j for j in range(n_space)])
            for i in range(n_batch)]
    cols = [new([i * n_space + j for i in range(n_batch)])
            for j in range(n_space)]
    return RankMesh(rank, size, dev, ("batch", "space"), (n_batch, n_space),
                    (cols[s], rows[b]))


def _group(mesh: RankMesh, axis: str):
    k = _axis(mesh, axis)
    return mesh.groups[k] if mesh.groups else None


def _sum(t: torch.Tensor, group=None) -> torch.Tensor:
    t0 = time.perf_counter()
    torch.distributed.all_reduce(t, group=group)
    COLLECTIVES["all_reduce"] += 1
    COLLECTIVES["all_reduce_s"] += time.perf_counter() - t0
    return t


def all_reduce(mesh: RankMesh, t: torch.Tensor) -> torch.Tensor:
    """Sum ``t`` over every rank in place (the reference's ``psum`` over a
    1D mesh) and return it; with one rank, ``t`` as it is."""
    return t if mesh.size == 1 else _sum(t)


def psum(mesh: RankMesh, t: torch.Tensor, axis: str) -> torch.Tensor:
    """Sum ``t`` in place over the ranks of this rank's ``axis`` group and
    return it; over an axis of one rank, ``t`` as it is."""
    return t if axis_size(mesh, axis) == 1 else _sum(t, _group(mesh, axis))


def ring_exchange(mesh: RankMesh, lo: torch.Tensor, hi: torch.Tensor,
                  axis: str):
    """The two ring ``ppermute``s along ``axis``: returns ``(from_left,
    from_right)``, the high halo ``hi`` of the rank before this one and the
    low halo ``lo`` of the rank after it (ring order: rank ``d - 1`` is
    rank 0's left neighbour). ``lo`` and ``hi`` share one shape and dtype.
    One ``all_reduce`` of a zero-filled ``[d, 2, *lo.shape]`` buffer (see
    the module docstring); over an axis of one rank, ``(hi, lo)``."""
    d = axis_size(mesh, axis)
    if d == 1:
        return hi, lo
    me = axis_index(mesh, axis)
    t0 = time.perf_counter()
    buf = torch.zeros((d, 2) + tuple(lo.shape), dtype=lo.dtype,
                      device=lo.device)
    buf[me, 0] = lo
    buf[me, 1] = hi
    torch.distributed.all_reduce(buf, group=_group(mesh, axis))
    out = buf[(me - 1) % d, 1], buf[(me + 1) % d, 0]
    COLLECTIVES["exchange"] += 1
    COLLECTIVES["exchange_s"] += time.perf_counter() - t0
    COLLECTIVES["exchange_bytes"] += buf.numel() * buf.element_size()
    return out
