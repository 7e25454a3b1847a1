"""Data-parallel NDT registration: B registrations split over a mesh axis.

Port of ``ndtpu/dist/registration.py``. B concurrent registrations
(loop-closure verification, multi-robot scan matching, serving) are split
over the ranks of the ``"batch"`` axis, the map replicated; each rank
registers its ``B/d`` lanes with ``ndt.match.match_batch`` (``pack_quad``
and one ``lm_ndt`` launch on the card). No collective: lanes are
independent. The result is the rank's slice, as the reference's
multi-process output is addressable per process; nothing gathers it.
"""

from __future__ import annotations

from ndtpu_torch.config import GridConfig, MatchConfig
from ndtpu_torch.dist import mesh as dmesh
from ndtpu_torch.ndt import match as ndt_match
from ndtpu_torch.ndt.grid import NDTMap

__all__ = ["match_batch_sharded"]


def match_batch_sharded(mesh: dmesh.RankMesh, points, mask, ndt_map: NDTMap,
                        init_poses, grid: GridConfig,
                        cfg: MatchConfig) -> ndt_match.MatchResult:
    """This rank's lanes of ``ndt.match.match_batch``: points ``[B, N, 2]``,
    mask ``[B, N]``, init_poses ``[B, 3]`` (the same on every rank), ``B``
    divisible by the ranks of ``"batch"``; returns lanes ``[r * B/d, (r + 1)
    * B/d)`` for rank ``r``."""
    d = dmesh.axis_size(mesh, "batch")
    b = points.shape[0]
    if b % d:
        raise ValueError(f"{b} registrations do not split over the {d} "
                         f"ranks of axis 'batch'")
    r, k = dmesh.axis_index(mesh, "batch"), b // d
    lanes = slice(r * k, (r + 1) * k)
    return ndt_match.match_batch(points[lanes], mask[lanes], ndt_map,
                                 init_poses[lanes], grid, cfg)
