"""ndtpu_torch.eval.render against ndtpu.eval.render: the rasterized map
(f64, within 1e-12) and the two PNGs (pixel for pixel, where PIL is
present) from the same statistics, each package finalizing them with its
own ``finalize``; and no module of the port imports PIL on import."""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndtpu.config import GridConfig as JGridConfig
from ndtpu.config import NDTMapConfig as JNDTMapConfig
from ndtpu.eval import render as jrender
from ndtpu.ndt import grid as jgrid
from ndtpu_torch import convert
from ndtpu_torch.config import GridConfig, NDTMapConfig
from ndtpu_torch.eval import render as trender
from ndtpu_torch.ndt import grid as tgrid

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
ATOL = 1e-12
UPSCALE = 2
GRIDS = {o: (GridConfig(x0=-8.0, y0=-8.0, cell=0.5, nx=32, ny=32,
                        overlap=o),
             JGridConfig(x0=-8.0, y0=-8.0, cell=0.5, nx=32, ny=32,
                         overlap=o)) for o in (4, 1)}


def _scene(seed, grid):
    """Clustered points over the grid (some off it) and a trajectory
    through it and past its edge, from ``seed``."""
    rng = np.random.default_rng(seed)
    span = grid.nx * grid.cell
    centers = rng.uniform([grid.x0, grid.y0],
                          [grid.x0 + span, grid.y0 + span], (30, 2))
    pts = centers[rng.integers(0, 30, 3000)] + rng.normal(0, 0.35, (3000, 2))
    mask = rng.random(3000) > 0.05
    t = np.linspace(0.0, 1.0, 50)
    traj = np.stack([-9.0 + 19.0 * t, 6.0 * np.sin(4.0 * t),
                     0.3 * t], -1)
    gt = traj + rng.normal(0, 0.2, traj.shape)
    return pts, mask, traj, gt


@pytest.fixture(scope="module", params=[4, 1], ids=["overlap4",
                                                    "overlap1"])
def maps(request):
    """``(grid, JAX's finalized map, the port's, traj, gt)``: both from
    JAX's f64 statistics of the scene, each finalized by its package."""
    grid, jg = GRIDS[request.param]
    pts, mask, traj, gt = _scene(11, grid)
    stats = jax.jit(lambda p, m: jgrid.build_stats(p, m, jg))(
        jnp.asarray(pts), jnp.asarray(mask))
    jmap = jax.jit(lambda s: jgrid.finalize(s, JNDTMapConfig()))(stats)
    tmap = tgrid.finalize(convert.from_numpy(stats), NDTMapConfig())
    assert int(np.asarray(jmap.valid).sum()) > 100
    return grid, jg, jmap, tmap, traj, gt


def test_rasterize_map_matches_jax(maps):
    grid, jg, jmap, tmap, _, _ = maps
    got = trender.rasterize_map(tmap, grid, UPSCALE)
    ref = jrender.rasterize_map(jmap, jg, UPSCALE)
    assert got.shape == ref.shape == (32 * UPSCALE, 32 * UPSCALE)
    assert got.dtype == np.float64
    assert int((ref > 0.05).sum()) > 200
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


def test_rasterize_map_takes_f32_tensors_and_arrays(maps):
    """The map's leaves as f32 tensors render as their f64 values would,
    and numpy leaves as tensors do."""
    grid, _, _, tmap, _, _ = maps
    f32 = tgrid.NDTMap(*(x.float() for x in tmap))
    as64 = tgrid.NDTMap(*(x.double() for x in f32))
    a = trender.rasterize_map(f32, grid, UPSCALE)
    np.testing.assert_array_equal(
        a, trender.rasterize_map(as64, grid, UPSCALE))
    np.testing.assert_array_equal(
        a, trender.rasterize_map(tgrid.NDTMap(*(x.numpy() for x in as64)),
                                 grid, UPSCALE))


def _png(path):
    from PIL import Image

    return np.asarray(Image.open(path))


def test_render_map_png_matches_jax(maps, tmp_path):
    pytest.importorskip("PIL")
    grid, jg, jmap, tmap, traj, gt = maps
    got, ref = tmp_path / "port.png", tmp_path / "jax.png"
    trender.render_map_png(tmap, grid, str(got), traj=torch.as_tensor(traj),
                           upscale=UPSCALE, gt=gt)
    jrender.render_map_png(jmap, jg, str(ref), traj=traj, upscale=UPSCALE,
                           gt=gt)
    a, b = _png(got), _png(ref)
    assert a.shape == (32 * UPSCALE, 32 * UPSCALE, 3)
    np.testing.assert_array_equal(a, b)
    assert int((a == (255, 140, 0)).all(-1).sum()) > 20


def test_render_trajectories_png_matches_jax(maps, tmp_path):
    pytest.importorskip("PIL")
    grid, jg, _, _, traj, gt = maps
    got, ref = tmp_path / "port.png", tmp_path / "jax.png"
    trender.render_trajectories_png(str(got), grid, UPSCALE,
                                    est=torch.as_tensor(traj), gt=gt,
                                    odo=torch.as_tensor(gt[::-1].copy()))
    jrender.render_trajectories_png(str(ref), jg, UPSCALE, est=traj, gt=gt,
                                    odo=gt[::-1])
    a = _png(got)
    np.testing.assert_array_equal(a, _png(ref))
    assert int(a.any(-1).sum()) > 40


_NO_PIL = """
import importlib, pkgutil, sys
sys.modules["PIL"] = None          # any "import PIL" now raises ImportError
sys.path.insert(0, {root!r})
import ndtpu_torch
names = [m.name for m in pkgutil.walk_packages(ndtpu_torch.__path__,
                                               "ndtpu_torch.")]
for name in names:
    importlib.import_module(name)
assert "ndtpu_torch.eval.render" in names
import ndtpu_torch.eval
assert ndtpu_torch.eval.render.rasterize_map
print("ok", len(names))
"""


def test_no_module_of_the_port_imports_pil():
    """Every module of ``ndtpu_torch`` imports with PIL unimportable (the
    machine with the card has none): only the PNG writers import it."""
    proc = subprocess.run([sys.executable, "-c",
                           _NO_PIL.format(root=str(ROOT))],
                          capture_output=True, text=True, timeout=300,
                          cwd=str(ROOT))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().startswith("ok")
