"""The premise of the ``lm_ndt`` kernel, on the CPU in f64: each lane of
the batched LM registration depends only on its own carry, so one lane run
alone (B=1) equals the same lane in the batched run, and both equal the
JAX package's ``match_batch_packed``; for shared ``[R, L]``, per-lane
``[B, R, L]`` and grouped ``[S, R, L]`` tables, iteration caps, an
all-masked lane, a lane off the map, a zero-gradient start and the
two-phase compaction. Also: CPU tensors reach the twin and launch nothing,
and the port's config module equals the JAX package's."""

import dataclasses
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndtpu import config as jconfig
from ndtpu.config import GridConfig, MatchConfig, NDTMapConfig
from ndtpu.data import synth as jsynth
from ndtpu.lie import se2 as jse2
from ndtpu.ndt import grid as jgrid
from ndtpu.ndt import match as jmatch
from ndtpu_torch import config as tconfig
from ndtpu_torch import kernels
from ndtpu_torch.ndt import match as tmatch

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
GRID = GridConfig(x0=-14.0, y0=-14.0, cell=1.0, nx=28, ny=28, overlap=4)
NDT = NDTMapConfig()
B = 16


def _t(a):
    return torch.as_tensor(np.array(a))


@pytest.fixture(scope="module")
def lanes():
    """Three maps of the box world (scans 0-19, 6-25, 12-31 at their true
    poses) as quad tables, and 16 registrations of later scans from
    perturbed poses. Lane 3 is off the map, lane 5 has no valid beam, lane
    9's beams all fall in the empty middle of the box (zero gradient at a
    start inside the map)."""
    world = jsynth.box_world(11.0)
    traj = jsynth.rectangle_trajectory(48, half=7.0, step=0.2,
                                       dtype=jnp.float64)
    seq = jsynth.make_sequence(world, traj, n_beams=90, max_range=20.0,
                               min_range=0.1, seed=0)
    pts = np.asarray(seq.points, np.float64)
    mask = np.asarray(seq.mask)
    gt = np.asarray(traj)
    tables = []
    for lo in (0, 6, 12):
        w = np.asarray(jse2.transform(jnp.asarray(gt[lo:lo + 20]),
                                      jnp.asarray(pts[lo:lo + 20])))
        st = jgrid.build_stats(jnp.asarray(w.reshape(-1, 2)),
                               jnp.asarray(mask[lo:lo + 20].reshape(-1)),
                               GRID)
        tables.append(np.asarray(jgrid.pack_quad(jgrid.finalize(st, NDT),
                                                 GRID)))
    rng = np.random.default_rng(11)
    idx = np.arange(24, 24 + B)
    init = gt[idx] + rng.normal(0, [0.15, 0.15, 0.04], (B, 3))
    p, m = pts[idx].copy(), mask[idx].copy()
    init[3] = [40.0, 40.0, 0.0]
    m[5] = False
    ang = np.linspace(-np.pi, np.pi, p.shape[1], endpoint=False)
    p[9] = 0.5 * np.stack([np.cos(ang), np.sin(ang)], -1)
    m[9] = True
    init[9] = [0.0, 0.0, 0.3]
    group = rng.integers(0, 3, B)
    return dict(tables=np.stack(tables), group=group, pts=p, mask=m,
                init=init)


def _table(lanes, layout):
    """(JAX table, JAX group, port table, port group) for a layout."""
    q, g = lanes["tables"], lanes["group"]
    if layout == "shared":
        return q[0], None, _t(q[0]), None
    if layout == "per_lane":
        return q[g], None, _t(q[g]), None
    return q, jnp.asarray(g, jnp.int32), _t(q), _t(g).to(torch.int32)


def _close(rt, ref, tol=1e-9):
    """n_iter and converged exact; pose within ``tol`` (absolute), H and
    score within ``tol`` x max(1, the lane's largest |entry|)."""
    np.testing.assert_array_equal(rt.n_iter.numpy(), np.asarray(ref.n_iter))
    np.testing.assert_array_equal(rt.converged.numpy(),
                                  np.asarray(ref.converged))
    np.testing.assert_allclose(rt.pose.numpy(), np.asarray(ref.pose), rtol=0,
                               atol=tol)
    for a, b in [(rt.hessian.numpy(), np.asarray(ref.hessian)),
                 (rt.score.numpy(), np.asarray(ref.score))]:
        scale = np.maximum(1.0, np.abs(b).reshape(b.shape[0], -1).max(-1))
        err = np.abs(a - b).reshape(b.shape[0], -1).max(-1)
        assert np.all(err <= tol * scale), err.max()


CFGS = {"full": MatchConfig(),
        "cap4": MatchConfig(max_iter=4),            # pass 2's / verify's cap
        "two_phase": MatchConfig(phase2_width=8, phase1_iters=4)}


@pytest.mark.parametrize("variant", list(CFGS))
@pytest.mark.parametrize("layout", ["shared", "per_lane", "grouped"])
def test_lanes_are_independent(lanes, layout, variant):
    cfg = CFGS[variant]
    tj, gj, tt, gt = _table(lanes, layout)
    rj = jmatch.match_batch_packed(jnp.asarray(lanes["pts"]),
                                   jnp.asarray(lanes["mask"]),
                                   jnp.asarray(tj), jnp.asarray(lanes["init"]),
                                   GRID, cfg, group=gj)
    px, py = _t(lanes["pts"][..., 0]), _t(lanes["pts"][..., 1])
    mask_f = _t(lanes["mask"].astype(np.float64))
    init = _t(lanes["init"])
    if layout == "per_lane":     # as match_batch_packed folds it
        gt = torch.arange(B, dtype=torch.int32)
    batched = tmatch.lm_ndt_ref(init, px, py, mask_f, tt, GRID, cfg, gt)
    _close(batched, rj)
    one = [tmatch.lm_ndt_ref(init[b:b + 1], px[b:b + 1], py[b:b + 1],
                             mask_f[b:b + 1], tt, GRID, cfg,
                             None if gt is None else gt[b:b + 1])
           for b in range(B)]
    alone = tmatch.MatchResult(*(torch.cat(f) for f in zip(*one)))
    _close(alone, rj)
    _close(alone, batched)
    n_iter, conv = batched.n_iter.numpy(), batched.converged.numpy()
    assert n_iter[3] == 0 and not conv[3]          # off the map
    assert n_iter[5] == 0 and not conv[5]          # no valid beam
    assert n_iter[9] == 0 and not conv[9]          # zero gradient
    if variant == "cap4":
        assert n_iter.max() == 4 and ((n_iter == 4) & ~conv).sum() > 2
    else:
        assert conv.sum() >= B - 4


def test_cpu_tensors_reach_the_twin(lanes):
    """``match_batch_packed`` and ``lm_ndt`` on CPU tensors run
    ``lm_ndt_ref`` and launch nothing; the kernel entry point refuses CPU
    tensors."""
    _, _, tt, gt = _table(lanes, "grouped")
    px, py = _t(lanes["pts"][..., 0]), _t(lanes["pts"][..., 1])
    mask_f = _t(lanes["mask"].astype(np.float64))
    init, cfg = _t(lanes["init"]), MatchConfig(max_iter=6)
    kernels.reset_launches()
    tmatch.CALLS["match_batch_packed"] = 0
    ref = tmatch.lm_ndt_ref(init, px, py, mask_f, tt, GRID, cfg, gt)
    for res in (tmatch.lm_ndt(init, px, py, mask_f, tt, GRID, cfg, gt),
                tmatch.match_batch_packed(_t(lanes["pts"]),
                                          _t(lanes["mask"]), tt, init, GRID,
                                          cfg, group=gt)):
        for a, b in zip(res, ref):
            assert torch.equal(a, b)
    assert tmatch.CALLS["match_batch_packed"] == 1
    assert not any(kernels.LAUNCHES.values())
    assert {"lm_ndt", "lm_ndt_grouped"} <= set(kernels.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.lm_ndt(init.float(), px.float(), py.float(), mask_f.float(),
                       tt.float(), GRID, cfg, gt)


@pytest.mark.parametrize("path", sorted((ROOT / "configs").glob("*.json")),
                         ids=lambda p: p.stem)
def test_config_files_parse_alike(path, tmp_path):
    """Each ``configs/*.json`` gives the same values in both packages, and
    the port's ``to_json`` / ``from_json`` round-trip them."""
    tc = tconfig.PipelineConfig.from_json(str(path))
    assert dataclasses.asdict(tc) == dataclasses.asdict(
        jconfig.PipelineConfig.from_json(str(path)))
    out = tmp_path / "cfg.json"
    tc.to_json(str(out))
    assert tconfig.PipelineConfig.from_json(str(out)) == tc
    assert json.loads(out.read_text()) == dataclasses.asdict(tc)


@pytest.mark.parametrize("name", ["GridConfig", "NDTMapConfig", "MatchConfig",
                                  "KeyframeConfig", "LoopConfig",
                                  "SolverConfig", "PipelineConfig"])
def test_config_classes_match_field_by_field(name):
    tcls, jcls = getattr(tconfig, name), getattr(jconfig, name)
    tf, jf = dataclasses.fields(tcls), dataclasses.fields(jcls)
    assert [f.name for f in tf] == [f.name for f in jf]
    assert [str(f.type) for f in tf] == [str(f.type) for f in jf]
    assert (dataclasses.asdict(tcls()) == dataclasses.asdict(jcls()))
    assert tcls.__dataclass_params__.frozen
    if name == "GridConfig":
        assert tcls(nx=7, ny=5).n_cells == 35
    with pytest.raises(KeyError, match="unknown config field"):
        tconfig._from_dict(tcls, {"no_such_field": 1})
