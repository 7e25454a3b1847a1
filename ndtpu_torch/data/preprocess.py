"""Scan preprocessing beyond polar->xy: voxel-grid downsampling.

Port of ``ndtpu/data/preprocess.py``. The output is the same ``[..., N,
2]`` point array's *thinned mask* (at most one valid point per voxel), which
the map build and the matcher take as ``(points, mask)``, so no shape
changes. K13 (``csrc/voxel_downsample.cu``) carries it on the card;
:func:`voxel_downsample_ref` is the JAX package's sort-based route.
"""

from __future__ import annotations

import torch

from ndtpu_torch import kernels

__all__ = ["voxel_downsample", "voxel_downsample_ref"]

# Quantized coordinates are clipped to +-_HALF-1 cells around the scan's own
# frame (+-800 m at a 5 cm voxel), which keeps the packed id inside int32.
_HALF = 1 << 14


def voxel_downsample_ref(points, mask, voxel: float):
    """Plain twin of K13: the thinned mask ``[..., N]`` of points ``[..., N,
    2]`` with ``mask [..., N]``, keeping the lowest-index valid point of
    each occupied ``voxel x voxel`` cell. As the JAX package: int32
    quantize, clip, pack, one sentinel for invalid points, a stable sort of
    the ids, first of each run, unsort."""
    q = torch.clamp(torch.floor(points / voxel).to(torch.int32), -_HALF,
                    _HALF - 1)
    ids = (q[..., 0] + _HALF) * (2 * _HALF) + (q[..., 1] + _HALF)
    sentinel = (2 * _HALF) * (2 * _HALF)
    ids = torch.where(mask, ids, torch.full_like(ids, sentinel))
    s_ids, order = torch.sort(ids, dim=-1, stable=True)
    first = torch.cat([torch.ones_like(s_ids[..., :1], dtype=torch.bool),
                       s_ids[..., 1:] != s_ids[..., :-1]], -1)
    keep = torch.zeros_like(first).scatter(-1, order, first)
    return keep & mask


def voxel_downsample(points, mask, voxel: float):
    """K13 wrapper: keep at most one valid point per ``voxel`` cell of each
    scan (points ``[..., N, 2]``, mask ``[..., N]``; returns the thinned
    mask). CUDA tensors go to the kernel (f32, one block per scan), CPU
    tensors to :func:`voxel_downsample_ref`."""
    if not points.is_cuda:
        return voxel_downsample_ref(points, mask, voxel)
    lead = mask.shape
    n = lead[-1] if len(lead) else 0
    keep = kernels.voxel_downsample(points.reshape(-1, n, 2).contiguous(),
                                    mask.reshape(-1, n).contiguous(), voxel)
    return keep.reshape(lead)
