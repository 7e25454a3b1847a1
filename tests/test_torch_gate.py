"""The loop gate at config 5's width and K4's band sizing, on the CPU.

- The port's twins of ``verify_candidates_cached_flat`` (the CPU route:
  ``verify_registrations`` and ``_gate_and_pack``) at 64 candidates per
  query with config 5's ``LoopConfig``, per lane against
  ``ndtpu.loop.closure.verify_candidates_cached_flat`` on the same f64
  inputs: flags exact, poses, scores and sqrt information to
  ``test_torch_loop``'s tolerances.
- ``kernels.finalize_bands``: the bands cover every table row once and
  hold, in the shared memory they declare, every cell their rows read.
- The gate's refusals: more than 128 candidates per query raise before any
  device check, and the gated registration takes CUDA tensors only.
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndtpu.config import PipelineConfig as JPipelineConfig
from ndtpu.loop import closure as jclosure
from ndtpu.slam import keyframes as jkfs
from ndtpu_torch import convert, kernels
from ndtpu_torch.config import GridConfig, MatchConfig, PipelineConfig
from ndtpu_torch.data import synth as tsynth
from ndtpu_torch.loop import closure as tclosure
from ndtpu_torch.ndt import match as tmatch

torch.set_num_threads(2)

CONFIGS = Path(__file__).resolve().parents[1] / "configs"
CONFIG5 = str(CONFIGS / "config5_multisession.json")


def _t(a):
    return torch.as_tensor(np.array(a))


def _close(a, b, rtol=1e-12):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    scale = max(1.0, float(np.abs(b).max()))
    np.testing.assert_allclose(a, b, rtol=0, atol=rtol * scale)


@pytest.fixture(scope="module")
def store5():
    """Two laps of a 4 x 4 m box-world square (128 scans, 90 beams, f64),
    every scan a keyframe at a perturbed pose, with config 5's local tables
    (a 61 x 61 lattice): the JAX store and the port's copy."""
    loop = JPipelineConfig.from_json(CONFIG5).loop
    world = tsynth.box_world(11.0)
    traj = tsynth.rectangle_trajectory(128, half=2.0, step=0.25)
    s = tsynth.make_sequence(world, traj, 90, 20.0, 0.1, seed=5)
    pts, msk = s.points.double().numpy(), s.mask.numpy()
    gt = s.gt_poses.double().numpy()
    rng = np.random.default_rng(8)
    cap = n = 128
    poses = gt + rng.normal(0, [0.05, 0.05, 0.01], (cap, 3))
    ndt = JPipelineConfig.from_json(CONFIG5).ndt
    build = jax.jit(jax.vmap(lambda p, m: jclosure.build_local_table(
        p, m, loop, ndt, False)))
    tables = np.array(build(jnp.asarray(pts), jnp.asarray(msk)))
    jstore = jkfs.KeyframeStore(
        poses=jnp.asarray(poses), points=jnp.asarray(pts),
        masks=jnp.asarray(msk), live=jnp.ones(cap, bool),
        n=jnp.asarray(n, jnp.int32), tables=jnp.asarray(tables))
    return dict(jstore=jstore, tstore=convert.from_numpy(jstore), gt=gt,
                points=pts, mask=msk)


def test_verify_candidates_cached_flat_64_candidates_matches_jax(store5):
    """Config 5's LoopConfig (64 candidates, top-2 budget, innovation
    gate): 2 queries x 64 candidates, per lane against JAX."""
    loop = JPipelineConfig.from_json(CONFIG5).loop
    tloop = PipelineConfig.from_json(CONFIG5).loop
    assert loop.max_candidates == tloop.max_candidates == 64
    mcfg = JPipelineConfig.from_json(CONFIG5).match
    tmcfg = PipelineConfig.from_json(CONFIG5).match
    rng = np.random.default_rng(9)
    q = np.array([126, 80])
    qpose = store5["gt"][q] + rng.normal(0, [0.1, 0.1, 0.03], (2, 3))
    qidx = np.array([126, 80])
    qpts, qmsk = store5["points"][q], store5["mask"][q]

    @jax.jit
    def jrun(kf, p, m, qp, qi):
        cands = jax.vmap(jclosure.find_candidates,
                         in_axes=(None, 0, 0, None))(kf, qp, qi, loop)
        return cands, jclosure.verify_candidates_cached_flat(
            kf, p, m, qp, cands, loop, mcfg, qi)

    jc, jr = jrun(store5["jstore"], jnp.asarray(qpts), jnp.asarray(qmsk),
                  jnp.asarray(qpose), jnp.asarray(qidx, jnp.int32))
    kernels.reset_launches()
    tr = tclosure.detect_loops_cached_flat(store5["tstore"], _t(qpts),
                                           _t(qmsk), _t(qpose), _t(qidx),
                                           tloop, tmcfg)
    assert not any(kernels.LAUNCHES.values())
    assert tuple(tr.accept.shape) == (2, 64)
    np.testing.assert_array_equal(tr.j.numpy(), np.asarray(jc.idx))
    mask = np.asarray(jc.mask)
    assert mask[0].all() and 0 < mask[1].sum() < 64   # query 1: slots unused
    np.testing.assert_array_equal(tr.accept.numpy(), np.asarray(jr.accept))
    np.testing.assert_array_equal(tr.innov_rej.numpy(),
                                  np.asarray(jr.innov_rej))
    np.testing.assert_allclose(tr.z.numpy(), np.asarray(jr.z), rtol=0,
                               atol=1e-8)
    np.testing.assert_allclose(tr.score.numpy(), np.asarray(jr.score),
                               rtol=0, atol=1e-10)
    _close(tr.sqrt_info.numpy(), jr.sqrt_info, 1e-8)
    acc = tr.accept.numpy()
    assert acc[0].sum() >= 2 and (acc.sum(1) <= 64).all()
    # The top-2 budget binds on query 0 (more lanes pass the score gate).
    passed = (np.asarray(jr.score) >= loop.score_gate) & mask
    assert passed[0].sum() > acc[0].sum()


_CONFIG_FILES = {"config2": "config2_full_sequence",
                 "config3": "config3_loop_closure",
                 "config5": "config5_multisession"}
_GRIDS = {
    "wide_opt_in": GridConfig(x0=0.0, y0=0.0, cell=0.5, nx=600, ny=40),
    "odd_small": GridConfig(x0=0.0, y0=0.0, cell=1.0, nx=7, ny=5),
}


@pytest.mark.parametrize("name", sorted([*_CONFIG_FILES, *_GRIDS]))
def test_finalize_bands_cover_rows_and_fit_shared_memory(name):
    """Every table row in exactly one band; one thread per cell of a band
    (whole warps, at most 512); each band's cells (cell rows ``(hy - gy)
    >> 1`` of grid ``g`` for its rows ``hy``) fit its grid's region of the
    shared memory the band declares (32 B per cell), within
    ``SMEM_BLOCK`` unless one row alone needs more (then within
    ``SMEM_MAX``, by the opt-in). Configs 2, 3 and 5 at their published
    grids."""
    grid = _GRIDS.get(name) or PipelineConfig.from_json(
        str(CONFIGS / f"{_CONFIG_FILES.get(name)}.json")).grid
    rows, bands, threads, smem = kernels.finalize_bands(grid, None)
    cells = 4 * (rows // 2 + 1) * grid.nx       # one thread per cell, once
    assert threads % 32 == 0 and threads == min(512, -(-cells // 32) * 32)
    hh = 2 * grid.ny + 1
    covered = np.zeros(hh, int)
    per_grid = smem // 128                  # cells in each grid's region
    for b in range(bands):
        h0, h1 = b * rows, min(b * rows + rows, hh)
        assert h0 < h1
        covered[h0:h1] += 1
        for gy in (0, 1):
            uy = np.arange(h0, h1) - gy
            uy = uy[(uy >= 0) & (uy < 2 * grid.ny)]
            cell_rows = np.unique(uy >> 1)
            assert len(cell_rows) <= rows // 2 + 1
            assert len(cell_rows) * grid.nx <= per_grid
    assert (covered == 1).all()
    assert smem == kernels._finalize_smem(rows, grid.nx)
    if name == "wide_opt_in":
        assert rows == 1 and kernels.SMEM_BLOCK < smem <= kernels.SMEM_MAX
    else:
        assert smem <= kernels.SMEM_BLOCK
    if name == "config5":
        assert (rows, bands) == (1, 513) and smem <= 33 * 1024


def test_finalize_bands_refuse_a_lattice_no_block_holds():
    wide = GridConfig(x0=0.0, y0=0.0, cell=0.5, nx=2000, ny=10)
    with pytest.raises(ValueError, match="shared memory"):
        kernels.finalize_bands(wide, None)


def test_gate_refuses_over_128_candidates_before_device_checks():
    """C = 129: the standalone gate and the gated registration raise on
    the width (CPU tensors, so any device check would raise otherwise);
    C = 128 reaches the device check. No launch is counted."""
    k, c = 2, 129
    args = lambda c: (torch.ones((k, c), dtype=torch.bool),
                      torch.ones((k, c), dtype=torch.bool),
                      torch.zeros((k, c)), torch.zeros((k, c, 3)),
                      torch.zeros((k, c, 3)), torch.zeros((k, c, 3, 3)),
                      torch.zeros((k, c), dtype=torch.long),
                      torch.zeros(k, dtype=torch.long), 0.3, 1.0, 0.02, 2)
    kernels.reset_launches()
    with pytest.raises(ValueError, match="128"):
        kernels.loop_gate(*args(c))
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.loop_gate(*args(128))
    gate = kernels.LoopGate(torch.ones((k, c), dtype=torch.bool),
                            torch.zeros(k, dtype=torch.long), 0.3, 1.0, 0.02,
                            2)
    b, n = k * c, 8
    grid = GridConfig(x0=-4.0, y0=-4.0, cell=1.0, nx=8, ny=8)
    tables = torch.zeros((3, 17 * 17, 32))
    with pytest.raises(ValueError, match="128"):
        kernels.lm_ndt(torch.zeros((b, 3)), torch.zeros((b, n)),
                       torch.zeros((b, n)), torch.ones((b, n)), tables, grid,
                       MatchConfig(), torch.zeros(b, dtype=torch.int32), gate)
    assert not any(kernels.LAUNCHES.values())


def test_gated_registration_takes_cuda_tensors_only():
    """``match_batch_packed_gated`` has no CPU route (the CPU verify runs
    ``match_batch_packed`` and the gate's twin); it refuses CPU tensors and
    launches nothing."""
    k, c, n = 1, 4, 8
    grid = GridConfig(x0=-4.0, y0=-4.0, cell=1.0, nx=8, ny=8)
    gate = kernels.LoopGate(torch.ones((k, c), dtype=torch.bool),
                            torch.zeros(k, dtype=torch.long), 0.3, 1.0, 0.02,
                            0)
    kernels.reset_launches()
    with pytest.raises(ValueError, match="CUDA"):
        tmatch.match_batch_packed_gated(
            torch.zeros((k * c, n, 2)), torch.ones((k * c, n), dtype=bool),
            torch.zeros((3, 17 * 17, 32)), torch.zeros((k * c, 3)), grid,
            MatchConfig(), torch.zeros(k * c, dtype=torch.long), gate)
    assert not any(kernels.LAUNCHES.values())


def test_verify_cpu_route_equals_registrations_then_gate_twin(store5):
    """On the CPU, ``verify_candidates_cached_flat`` is
    ``verify_registrations`` followed by ``_gate_and_pack``, field for
    field (the route the gated launch is held to on the card)."""
    tloop = dataclasses.replace(PipelineConfig.from_json(CONFIG5).loop,
                                max_candidates=8)
    tmcfg = PipelineConfig.from_json(CONFIG5).match
    kf = store5["tstore"]
    q = torch.tensor([120, 96])
    qp = kf.poses[q]
    qpts, qmsk = kf.points[q], kf.masks[q]
    cands = tclosure.find_candidates(kf, qp, q, tloop)
    out = tclosure.verify_candidates_cached_flat(kf, qpts, qmsk, qp, cands,
                                                 tloop, tmcfg, q)
    res, init = tclosure.verify_registrations(kf, qpts, qmsk, qp, cands,
                                              tloop, tmcfg)
    ref = tclosure._gate_and_pack(res, cands, tloop, init, q)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    assert out.accept.any()
