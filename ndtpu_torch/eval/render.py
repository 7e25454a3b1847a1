"""Map and trajectory rendering to PNG.

Port of ``ndtpu/eval/render.py``. Each valid cell's Gaussian of the
finalized NDT map is splatted as an anisotropic density blob (the
quadratic form the matcher scores against), with optional trajectory
overlays. Host numpy, no device work: the map's tensors (on any device)
and the poses (tensors or arrays) are moved to the host in f64 first. PIL
is imported only by the two PNG writers.
"""

from __future__ import annotations

import numpy as np

__all__ = ["rasterize_map", "render_map_png", "render_trajectories_png"]


def _host(x) -> np.ndarray:
    """A tensor (any device) or array as a host f64 array."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().double().numpy()
    return np.asarray(x, np.float64)


def rasterize_map(ndt_map, grid, upscale: int = 4) -> np.ndarray:
    """The NDT Gaussian mixture as an intensity image.

    ``ndt_map``: :class:`ndtpu_torch.ndt.grid.NDTMap` (dense ``[G, C,
    ...]``, any overlap); ``grid``: :class:`GridConfig`. Returns a ``[ny *
    upscale, nx * upscale]`` f64 image in [0, 1], row 0 = min y (flip for
    display). Each valid cell adds ``exp(-1/2 d^T icov d)`` on the pixels of
    the ``(3 upscale)^2`` patch about its mean, kept by a maximum over the
    cells.
    """
    mean = _host(ndt_map.mean)                         # [G, C, 2]
    icov = _host(ndt_map.icov)                         # [G, C, 2, 2]
    valid = _host(ndt_map.valid)                       # [G, C]
    g_dim = mean.shape[0]
    h, w = grid.ny * upscale, grid.nx * upscale
    img = np.zeros((h, w), np.float64)
    px_size = grid.cell / upscale
    # Pixel-centre world coordinates.
    xs = grid.x0 + (np.arange(w) + 0.5) * px_size
    ys = grid.y0 + (np.arange(h) + 0.5) * px_size
    # The patch about each cell's mean, vectorized over the cells.
    patch = 3 * upscale
    off = (np.arange(patch) - patch / 2.0 + 0.5) * px_size
    oy, ox = np.meshgrid(off, off, indexing="ij")      # [patch, patch]
    for g in range(g_dim):
        live = np.nonzero(valid[g] > 0.5)[0]
        if live.size == 0:
            continue
        mu = mean[g, live]                             # [M, 2]
        ic = icov[g, live]                             # [M, 2, 2]
        cx = np.clip(((mu[:, 0] - grid.x0) / px_size).astype(int), 0, w - 1)
        cy = np.clip(((mu[:, 1] - grid.y0) / px_size).astype(int), 0, h - 1)
        # Each patch pixel's world offset from the mean (which need not sit
        # on a pixel centre).
        mx = xs[cx][:, None, None] + ox[None] - mu[:, 0, None, None]
        my = ys[cy][:, None, None] + oy[None] - mu[:, 1, None, None]
        q = (ic[:, 0, 0, None, None] * mx * mx
             + 2.0 * ic[:, 0, 1, None, None] * mx * my
             + ic[:, 1, 1, None, None] * my * my)
        dens = np.exp(-0.5 * np.minimum(q, 40.0))      # [M, patch, patch]
        half = patch // 2
        # Scatter-max onto a padded canvas: one ufunc.at per patch offset
        # over all cells.
        padded = np.zeros((h + 2 * patch, w + 2 * patch), img.dtype)
        padded[patch:patch + h, patch:patch + w] = img
        py0 = cy - half + patch
        px0 = cx - half + patch
        for dy in range(patch):
            for dx in range(patch):
                np.maximum.at(padded, (py0 + dy, px0 + dx), dens[:, dy, dx])
        img = padded[patch:patch + h, patch:patch + w]
    return np.clip(img / max(g_dim / 2.0, 1.0) * g_dim, 0.0, 1.0)


def _world_to_px(xy: np.ndarray, grid, upscale: int):
    px_size = grid.cell / upscale
    x = ((xy[:, 0] - grid.x0) / px_size).astype(int)
    y = ((xy[:, 1] - grid.y0) / px_size).astype(int)
    return x, y


def render_map_png(ndt_map, grid, path: str, traj=None, upscale: int = 4,
                   gt=None) -> None:
    """The map (and optional trajectories) as a PNG file.

    ``traj`` / ``gt``: ``[T, >=2]`` poses, tensors or arrays (estimated:
    orange, ground truth: cyan). The image's y axis points up (row 0 = max
    y), as the world frame's.
    """
    from PIL import Image

    img = rasterize_map(ndt_map, grid, upscale)
    h, w = img.shape
    rgb = np.stack([(img * 255).astype(np.uint8)] * 3, axis=-1)

    def draw(poses, color):
        x, y = _world_to_px(_host(poses)[:, :2], grid, upscale)
        ok = (x >= 0) & (x < w) & (y >= 0) & (y < h)
        for dx in (-1, 0, 1):
            for dy in (-1, 0, 1):
                xs = np.clip(x[ok] + dx, 0, w - 1)
                ys = np.clip(y[ok] + dy, 0, h - 1)
                rgb[ys, xs] = color

    if gt is not None:
        draw(gt, (0, 200, 220))
    if traj is not None:
        draw(traj, (255, 140, 0))
    Image.fromarray(rgb[::-1]).save(path)


def render_trajectories_png(path: str, grid, upscale: int = 4, **named):
    """Named trajectories alone (no map), for a quick look at the ATE:
    ``render_trajectories_png("out.png", grid, est=poses, gt=gt_poses)``."""
    from PIL import Image

    h, w = grid.ny * upscale, grid.nx * upscale
    rgb = np.zeros((h, w, 3), np.uint8)
    palette = [(255, 140, 0), (0, 200, 220), (120, 255, 120), (255, 80, 200)]
    for k, poses in enumerate(named.values()):
        x, y = _world_to_px(_host(poses)[:, :2], grid, upscale)
        ok = (x >= 0) & (x < w) & (y >= 0) & (y < h)
        rgb[np.clip(y[ok], 0, h - 1), np.clip(x[ok], 0, w - 1)] = \
            palette[k % len(palette)]
    Image.fromarray(rgb[::-1]).save(path)
