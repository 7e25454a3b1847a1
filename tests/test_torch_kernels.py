"""The CUDA kernels (lm_ndt shared and grouped, K1 ndt_terms shared and
grouped, K3 halfcell_add, K4 finalize_pack, K8a local_tables, K8b
loop_gate, the gated verify that runs K8b inside lm_ndt, and the
smoother's K5 factor_linearize, K6 pcg_solve, K7a local_select and K7b
local_assemble, also through incremental_update, and config 4's K9a
supernodal_assemble and K9b schur_reduce, also through one supernodal
step, and stacked serving's K6b pcg_solve_blocked, K3s halfcell_add_stacked
and K4s finalize_pack_stacked, and config 5's K12 ndt_sgh_unpacked and
K9c schur_local_assemble, also through a one-rank optimize_schur, and the
slab map's K10a slab_accumulate, K10b finalize_cells and K10c slab_sgh,
also through a one-rank match_slab) against their plain twins, on the
card; K10a also against the plain model of its fixed-point arithmetic, bit
for bit; K3 also against the plain model of its
fixed-point arithmetic, bit for bit, K3, K4 and K8a for the same result on
every launch (K3 and K8a also under any order of the points), and the
gated verify bit for bit against lm_ndt_grouped followed by the
standalone K8b.

Every test here needs a CUDA card and skips without one (the kernels have
no CPU mode; their twins are covered by test_torch_grid / test_torch_match).
On a machine with a card (``tests/conftest.py`` imports JAX, which such a
machine may lack): ``python -m pytest --noconftest
tests/test_torch_kernels.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from ndtpu_torch import kernels
from ndtpu_torch.config import GridConfig, LoopConfig, NDTMapConfig
from ndtpu_torch.loop import closure
from ndtpu_torch.ndt import grid as tgrid
from ndtpu_torch.ndt import match as tmatch
from ndtpu_torch.ndt.match import MatchResult

torch.set_num_threads(2)

pytestmark = pytest.mark.cuda

GRID = GridConfig(x0=-12.0, y0=-12.0, cell=0.5, nx=48, ny=48, overlap=4)
NDT = NDTMapConfig()


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _points(seed, n, dev):
    """Clustered points snapped to 2^-16 m (f32 and f64 bin them alike)."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-11, 11, (60, 2))
    p = centers[rng.integers(0, 60, n)] + rng.normal(0, 0.4, (n, 2))
    p = np.round(p * 65536.0) / 65536.0
    mask = rng.random(n) > 0.05
    return (torch.as_tensor(p, dtype=torch.float32, device=dev),
            torch.as_tensor(mask, device=dev))


def _stats(dev, seed=0, n=40000):
    pts, mask = _points(seed, n, dev)
    return tgrid.halfcell_add_ref(tgrid.empty_stats(GRID, torch.float32, dev),
                                  pts, mask, 1.0, GRID)


@pytest.mark.parametrize("weights", ["ones", "signed"])
def test_halfcell_add_matches_f64_twin(dev, weights):
    base = _stats(dev, 1)
    pts, mask = _points(2, 50000, dev)
    w = 1.0 if weights == "ones" else torch.as_tensor(
        np.where(np.arange(50000) % 2 == 0, -1.0, 1.0), dtype=torch.float32,
        device=dev)
    kernels.reset_launches()
    out = tgrid.halfcell_add(base, pts, mask, w, GRID)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["halfcell_add"] == 1     # one call
    w64 = w if isinstance(w, float) else w.cpu().double()
    ref = tgrid.halfcell_add_ref(
        tgrid.NDTStats(*(t.cpu().double() for t in base)), pts.cpu().double(),
        mask.cpu(), w64, GRID)
    if weights == "ones":
        assert torch.equal(out.n.cpu().double(), ref.n)
    for o, r in zip(out, ref):
        scale = r.abs().max().item()
        torch.testing.assert_close(o.cpu().double(), r, rtol=0,
                                   atol=1e-5 * scale)


@pytest.mark.parametrize("weights", ["ones", "signed"])
def test_halfcell_add_equals_fixed_model_bit_for_bit(dev, weights):
    """K3 equals halfcell_add_fixed_ref (run on the card) bit for bit, on
    two launches and under a permutation of the points; +1 counts are
    exact against the f64 twin."""
    base = _stats(dev, 3)
    m = 50000
    pts, mask = _points(4, m, dev)
    w = 1.0 if weights == "ones" else torch.as_tensor(
        np.where(np.arange(m) % 3 == 0, -1.0, 1.0), dtype=torch.float32,
        device=dev)
    perm = torch.as_tensor(np.random.default_rng(5).permutation(m),
                           device=dev)
    wp = w if isinstance(w, float) else w[perm]
    bits = lambda st: [t.view(torch.int32) for t in st]
    kernels.reset_launches()
    runs = [tgrid.halfcell_add(base, pts, mask, w, GRID),
            tgrid.halfcell_add(base, pts, mask, w, GRID),
            tgrid.halfcell_add(base, pts[perm].contiguous(),
                               mask[perm].contiguous(), wp, GRID)]
    assert kernels.LAUNCHES["halfcell_add"] == 3
    model = tgrid.halfcell_add_fixed_ref(base, pts, mask, w, GRID)
    torch.cuda.synchronize()
    for out in runs:
        for a, b in zip(bits(out), bits(model)):
            assert torch.equal(a, b)
    if weights == "ones":
        ref = tgrid.halfcell_add_ref(
            tgrid.NDTStats(*(t.cpu().double() for t in base)),
            pts.cpu().double(), mask.cpu(), 1.0, GRID)
        assert torch.equal(runs[0].n.cpu().double(), ref.n)


def test_halfcell_add_empty_and_cancelling_calls(dev):
    """No points: the statistics come back unchanged. A +1 and a -1 copy of
    the same points in one call: unchanged bit for bit."""
    base = _stats(dev, 6)
    pts, mask = _points(7, 20000, dev)
    none = tgrid.halfcell_add(base, pts[:0], mask[:0], 1.0, GRID)
    both = torch.cat([pts, pts.flip(0)]).contiguous()
    msk = torch.cat([mask, mask.flip(0)]).contiguous()
    w = torch.cat([torch.ones(20000), -torch.ones(20000)]).to(dev)
    zero = tgrid.halfcell_add(base, both, msk, w, GRID)
    torch.cuda.synchronize()
    for out in (none, zero):
        for a, b in zip(out, base):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_finalize_pack_matches_twin(dev):
    st = _stats(dev)
    out = tgrid.finalize_pack(st, NDT, GRID)
    ref = tgrid.finalize_pack_ref(st, NDT, GRID)
    torch.cuda.synchronize()
    valid = [8 * g + 5 for g in range(4)]
    assert torch.equal(out[:, valid], ref[:, valid])
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("config", ["config2_full_sequence",
                                    "config3_loop_closure",
                                    "config5_multisession"])
def test_finalize_pack_bands_match_twin_and_repeat(dev, config):
    """K4 by bands of table rows at the published grids (R = 40,401,
    25,921 and 263,169 rows) on statistics from a seed: valid flags exact,
    the rest within rtol 1e-5 of the twin (chip_smoke's table rule), and
    bit-identical on a second launch; one launch per call."""
    import chip_smoke as cs
    from ndtpu_torch.config import PipelineConfig
    from profile_port import seeded_stats

    cfg = PipelineConfig.from_json(str(cs.ROOT / "configs" / f"{config}.json"))
    st = seeded_stats(cfg.grid, 1, dev)
    kernels.reset_launches()
    out = tgrid.finalize_pack(st, cfg.ndt, cfg.grid)
    again = tgrid.finalize_pack(st, cfg.ndt, cfg.grid)
    assert kernels.LAUNCHES["finalize_pack"] == 2
    ref = tgrid.finalize_pack_ref(st, cfg.ndt, cfg.grid)
    torch.cuda.synchronize()
    assert torch.equal(out.view(torch.int32), again.view(torch.int32))
    cs._table_check(config, out, ref)
    assert float(ref[:, [8 * g + 5 for g in range(4)]].sum()) > 0


def test_ndt_terms_matches_twin(dev):
    st = _stats(dev)
    table = tgrid.finalize_pack(st, NDT, GRID)
    rng = np.random.default_rng(3)
    b, n = 64, 360
    poses = torch.as_tensor(rng.normal(0, [2, 2, 1], (b, 3)),
                            dtype=torch.float32, device=dev)
    pts = torch.as_tensor(rng.normal(0, 6, (b, n, 2)), dtype=torch.float32,
                          device=dev)
    mask = torch.as_tensor(rng.random((b, n)) > 0.1, dtype=torch.float32,
                           device=dev)
    args = (poses, pts[..., 0].contiguous(), pts[..., 1].contiguous(), mask,
            table, GRID, 0.5, 40.0)
    out = tmatch.ndt_terms(*args)
    ref = tmatch.ndt_terms_ref(*args)
    torch.cuda.synchronize()
    assert bool(((out - ref).abs() <= 1e-3 * ref.abs().clamp(min=1)).all())


def test_kernels_refuse_f64(dev):
    st = tgrid.NDTStats(*(t.double() for t in _stats(dev)))
    with pytest.raises(TypeError, match="float32"):
        tgrid.finalize_pack(st, NDT, GRID)


def test_ndt_terms_grouped_matches_twin(dev):
    """Lane b reads table group[b] of a stack; the same sums as the twin,
    and as the shared-table kernel on that one table."""
    stack = torch.stack([tgrid.finalize_pack(_stats(dev, seed), NDT, GRID)
                         for seed in range(5)])
    rng = np.random.default_rng(4)
    b, n = 64, 360
    group = torch.as_tensor(rng.integers(0, 5, b), dtype=torch.int32,
                            device=dev)
    poses = torch.as_tensor(rng.normal(0, [2, 2, 1], (b, 3)),
                            dtype=torch.float32, device=dev)
    pts = torch.as_tensor(rng.normal(0, 6, (b, n, 2)), dtype=torch.float32,
                          device=dev)
    mask = torch.as_tensor(rng.random((b, n)) > 0.1, dtype=torch.float32,
                           device=dev)
    args = (poses, pts[..., 0].contiguous(), pts[..., 1].contiguous(), mask,
            stack, GRID, 0.5, 40.0)
    kernels.reset_launches()
    out = tmatch.ndt_terms(*args, group=group)
    assert kernels.LAUNCHES["ndt_terms_grouped"] == 1
    ref = tmatch.ndt_terms_ref(*args, group=group)
    torch.cuda.synchronize()
    assert bool(((out - ref).abs() <= 1e-3 * ref.abs().clamp(min=1)).all())
    for g in range(5):
        lanes = (group == g).nonzero().squeeze(-1)
        one = tmatch.ndt_terms(poses[lanes].contiguous(),
                               args[1][lanes].contiguous(),
                               args[2][lanes].contiguous(),
                               mask[lanes].contiguous(), stack[g], GRID, 0.5,
                               40.0)
        assert torch.equal(one, out[lanes])


@pytest.mark.parametrize("half", [8.0, 12.0, 15.0],
                         ids=["33x33", "49x49_57KB", "61x61_89KB"])
def test_local_tables_matches_twin(dev, half):
    """K8a against its f32 twin on the card, at lattices below and above
    the 48 KB default shared memory (config 3's 49 x 49 needs 57,624 B).
    Points on a 2^-4 m grid keep every moment sum exact in f32, so both
    sides finalize the same statistics; only the ``ok`` slots change."""
    loop = dataclasses.replace(LoopConfig(), local_half_extent=half)
    w, n = 12, 360
    rng = np.random.default_rng(5)
    ang = np.linspace(-np.pi, np.pi, n, endpoint=False)
    rad = rng.uniform(0.5, half * 1.3, (w, 1)) * (1 + 0.3 * np.sin(3 * ang))
    pts = np.stack([rad * np.cos(ang), rad * np.sin(ang)], -1)
    pts = torch.as_tensor(np.round(pts * 16) / 16, dtype=torch.float32,
                          device=dev)
    mask = torch.as_tensor(rng.random((w, n)) > 0.05, device=dev)
    slot = torch.as_tensor(rng.permutation(20)[:w], device=dev)
    ok = torch.as_tensor(rng.random(w) > 0.3, device=dev)
    shape = (20,) + closure.local_table_shape(loop, False)
    base = torch.randn(shape, device=dev)
    kernels.reset_launches()
    out = closure.write_local_tables(base.clone(), slot, ok, pts, mask, loop,
                                     NDT)
    assert kernels.LAUNCHES["local_tables"] == 1
    ref = closure.write_local_tables_ref(base.clone(), slot, ok, pts, mask,
                                         loop, NDT)
    torch.cuda.synchronize()
    valid = [8 * g + 5 for g in range(4)]
    assert torch.equal(out[..., valid], ref[..., valid])
    assert float(ref[slot[ok]][..., valid].sum()) > 0
    col_max = ref.abs().reshape(-1, 32).amax(0)
    tol = 1e-5 * torch.maximum(ref.abs(), 1e-3 * col_max)
    assert bool(((out - ref).abs() <= tol).all())
    untouched = torch.ones(20, dtype=torch.bool, device=dev)
    untouched[slot[ok]] = False
    assert torch.equal(out[untouched], base[untouched])


def _keyframe_scans(seed, w, n, dev, half=12.0):
    """``w`` room-like scans of ``n`` beams (sensor frame) and masks."""
    rng = np.random.default_rng(seed)
    ang = np.linspace(-np.pi, np.pi, n, endpoint=False)
    rad = rng.uniform(2.0, half, (w, 1)) * (1 + 0.3 * np.sin(3 * ang))
    pts = np.stack([rad * np.cos(ang), rad * np.sin(ang)], -1)
    pts += rng.normal(0, 0.02, pts.shape)
    return (torch.as_tensor(pts, dtype=torch.float32, device=dev),
            torch.as_tensor(rng.random((w, n)) > 0.05, device=dev))


def test_local_tables_deterministic_and_equal_to_k3_then_k4(dev):
    """K8a at config 3's window shape (W=8 keyframes x 360 beams, a 49 x 49
    lattice): enough blocks for the card's SMs; the same tables on two
    launches and under a permutation of each scan's points; each table
    equal to K4 of K3's statistics of its scan, bit for bit; valid flags
    exact and means within rtol 1e-5 against the f64 twin."""
    loop = LoopConfig(local_half_extent=12.0)
    lgrid = closure.local_grid_config(loop)
    w, n = 8, 360
    pts, mask = _keyframe_scans(8, w, n, dev)
    rows, bands, smem = kernels.local_bands(w, lgrid, dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert w * bands >= sms and smem <= kernels.SMEM_BLOCK
    shape = (w,) + closure.local_table_shape(loop, False)
    slot = torch.arange(w, device=dev)
    ok = torch.ones(w, dtype=torch.bool, device=dev)
    perm = torch.as_tensor(np.random.default_rng(9).permutation(n),
                           device=dev)
    kernels.reset_launches()
    runs = [closure.write_local_tables(torch.zeros(shape, device=dev), slot,
                                       ok, p, m, loop, NDT)
            for p, m in ((pts, mask), (pts, mask),
                         (pts[:, perm].contiguous(),
                          mask[:, perm].contiguous()))]
    assert kernels.LAUNCHES["local_tables"] == 3
    torch.cuda.synchronize()
    for out in runs[1:]:
        assert torch.equal(out.view(torch.int32), runs[0].view(torch.int32))
    for k in range(w):
        st = tgrid.halfcell_add(tgrid.empty_stats(lgrid, torch.float32, dev),
                                pts[k], mask[k], 1.0, lgrid)
        one = tgrid.finalize_pack(st, NDT, lgrid)
        assert torch.equal(runs[0][k].view(torch.int32),
                           one.view(torch.int32))
    ref = closure.write_local_tables_ref(
        torch.zeros(shape, dtype=torch.float64), slot.cpu(), ok.cpu(),
        pts.cpu().double(), mask.cpu(), loop, NDT)
    out = runs[0].cpu().double()
    valid = [8 * g + 5 for g in range(4)]
    assert torch.equal(out[..., valid], ref[..., valid])
    assert float(ref[..., valid].sum()) > 0
    means = [8 * g + k for g in range(4) for k in (0, 1)]
    mtol = 1e-5 * torch.clamp(ref[..., means].abs(),
                              min=1e-3 * float(ref[..., means].abs().max()))
    assert bool(((out[..., means] - ref[..., means]).abs() <= mtol).all())


def test_local_tables_unchanged_when_ok_masks_keyframes(dev):
    """Masking keyframes with ``ok`` leaves their slots untouched and the
    other keyframes' tables bit-identical to an all-ok launch."""
    loop = LoopConfig(local_half_extent=12.0)
    w, n = 8, 360
    pts, mask = _keyframe_scans(10, w, n, dev)
    shape = (12,) + closure.local_table_shape(loop, False)
    base = torch.randn(shape, device=dev)
    slot = torch.as_tensor([3, 0, 11, 5, 7, 1, 9, 4], device=dev)
    ok = torch.as_tensor([1, 0, 1, 1, 0, 1, 0, 1], dtype=torch.bool,
                         device=dev)
    full = closure.write_local_tables(base.clone(), slot, torch.ones_like(ok),
                                      pts, mask, loop, NDT)
    part = closure.write_local_tables(base.clone(), slot, ok, pts, mask,
                                      loop, NDT)
    torch.cuda.synchronize()
    kept = slot[ok]
    assert torch.equal(part[kept].view(torch.int32),
                       full[kept].view(torch.int32))
    untouched = torch.ones(12, dtype=torch.bool, device=dev)
    untouched[kept] = False
    assert torch.equal(part[untouched].view(torch.int32),
                       base[untouched].view(torch.int32))


def test_loop_gate_matches_f64_twin(dev):
    """K8b against _gate_and_pack in f64 at 16 candidates: score ties under
    the top-K budget, fewer than K accepted, innovation rejections and an
    accepted indefinite Hessian (its information floored, finite)."""
    _loop_gate_case(dev, 16)


def test_loop_gate_64_candidates_matches_f64_twin(dev):
    """As above at config 5's 64 candidates (two warps per query, the rank
    over shared memory)."""
    _loop_gate_case(dev, 64)


def _loop_gate_case(dev, c):
    rng = np.random.default_rng(6)
    k = 3
    a = rng.normal(size=(k, c, 3, 3))
    hess = np.einsum("kcij,kclj->kcil", a, a) + 50.0 * np.eye(3)
    hess[2, 1] = [[40.0, 0.0, 3.0], [0.0, -5.0, 0.0], [3.0, 0.0, 2.0]]
    score = rng.uniform(0.35, 0.8, (k, c))
    score[0, [1, 2, 5]] = 0.875                    # exact ties in f32
    score[0, 0] = 0.9375
    score[1] = 0.1
    score[1, 3] = 0.6
    score[2, 1] = 0.99
    conv = rng.random((k, c)) > 0.1
    conv[0, [0, 1, 2, 5]] = conv[1, 3] = conv[2, :2] = True
    mask = np.ones((k, c), bool)
    init = rng.normal(0, 1.0, (k, c, 3))
    pose = init + rng.normal(0, 0.05, (k, c, 3))
    pose[2, 0, :2] += [3.0, 0.0]
    idx = rng.integers(0, 20, (k, c))
    qidx = np.array([40, 40, 45])
    loop = dataclasses.replace(LoopConfig(), max_candidates=c)
    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32)
    res = MatchResult(pose=f32(pose), hessian=f32(hess), score=f32(score),
                      n_iter=torch.zeros((k, c), dtype=torch.int32),
                      converged=torch.as_tensor(conv))
    cands = closure.LoopCandidates(idx=torch.as_tensor(idx),
                                   mask=torch.as_tensor(mask),
                                   dist=torch.zeros((k, c)))
    on = lambda t: t.to(dev)
    kernels.reset_launches()
    out = closure.gate_and_pack(MatchResult(*map(on, res)),
                                closure.LoopCandidates(*map(on, cands)), loop,
                                on(f32(init)), on(torch.as_tensor(qidx)))
    assert kernels.LAUNCHES["loop_gate"] == 1
    ref = closure._gate_and_pack(
        MatchResult(*(t.double() if t.is_floating_point() else t
                      for t in res)), cands, loop, f32(init).double(),
        torch.as_tensor(qidx))
    torch.cuda.synchronize()
    assert torch.equal(out.accept.cpu(), ref.accept)
    assert torch.equal(out.innov_rej.cpu(), ref.innov_rej)
    assert int(ref.accept[0].sum()) == 4 and int(ref.accept[1].sum()) == 1
    assert bool(ref.innov_rej[2, 0]) and bool(ref.accept[2, 1])
    err = (out.sqrt_info.cpu().double() - ref.sqrt_info).abs()
    lane_max = ref.sqrt_info.abs().amax((-2, -1), keepdim=True)
    assert bool((err <= 1e-4 * lane_max).all())


@pytest.fixture(scope="module")
def lm_shapes():
    """The two shapes the main path gives ``lm_ndt``, on the box world: the
    config-2 window (8 lanes x 360 beams, the 100 x 100 table of a 300-scan
    map) and the config-3 verify (64 lanes grouped over the 1,024-slot
    table cache), as ``chip_smoke`` draws them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    import chip_smoke as cs
    from ndtpu_torch.config import PipelineConfig

    dev = torch.device("cuda")
    cfg2 = PipelineConfig.from_json(str(cs.CONFIG2))
    cfg3 = PipelineConfig.from_json(str(cs.CONFIG3))
    seq = cs.box_sequence(0, cfg2.n_beams)
    table = tgrid.finalize_pack(cs.map_stats(seq, cfg2.grid, dev), cfg2.ndt,
                                cfg2.grid)
    kf = cs.box_store(cfg3, seq, dev)
    k = cfg3.loop.max_detect_per_window * cfg3.loop.max_candidates
    return dict(
        window=(cs.lm_window_args(cfg2, seq, table, 0, dev, cfg2.window),
                cfg2.match),
        verify=(cs.lm_verify_args(cfg3, seq, kf, 0, dev, k), cfg3.match))


def test_lm_ndt_matches_composite_route_and_twin(lm_shapes):
    """lm_ndt against the composite route (the LM step in torch around K1:
    n_iter and converged equal on every lane, pose / H / score at rtol
    1e-5, or the lane shown to be an accept tie) and against its f32 twin
    (converged equal on >= 98% of the lanes of both shapes, poses within
    1e-3 on lanes converged in both); see chip_smoke.check_lm."""
    import chip_smoke as cs

    eq = lanes = 0
    for label, (args, cfg) in lm_shapes.items():
        kernels.reset_launches()
        row, (e, b) = cs.check_lm(label, args, cfg)
        counter = "lm_ndt" if args[6] is None else "lm_ndt_grouped"
        assert kernels.LAUNCHES[counter] >= 1
        assert row["max_abs_err"] <= 1e-3
        eq, lanes = eq + e, lanes + b
    assert eq >= 0.98 * lanes


@pytest.mark.parametrize("layout", ["shared", "per_lane", "grouped"])
def test_lm_ndt_one_launch_per_call_and_two_phases_bit_equal(lm_shapes,
                                                              layout):
    """match_batch_packed on the card: one lm_ndt launch per call for every
    table shape and phase2_width, and phase2_width 0 and 8 give bit-equal
    results."""
    if layout == "grouped":
        (init, px, py, mask_f, table, grid, group), cfg = lm_shapes["verify"]
    else:
        (init, px, py, mask_f, table, grid, group), cfg = lm_shapes["window"]
        if layout == "per_lane":
            table = table[None].expand(init.shape[0], *table.shape)
            table = table.contiguous()
    points = torch.stack([px, py], -1)
    out = []
    for width in (0, 8):
        kernels.reset_launches()
        mcfg = dataclasses.replace(cfg, phase2_width=width, phase1_iters=3)
        out.append(tmatch.match_batch_packed(points, mask_f > 0, table, init,
                                             grid, mcfg, group=group))
        torch.cuda.synchronize()
        counter = "lm_ndt" if layout == "shared" else "lm_ndt_grouped"
        assert kernels.LAUNCHES[counter] == 1
        assert sum(kernels.LAUNCHES.values()) == 1
    for a, b in zip(*out):
        assert torch.equal(a, b)
    if layout == "per_lane":     # the same table in every lane
        shared = tmatch.match_batch_packed(points, mask_f > 0, table[0], init,
                                           grid, cfg)
        for a, b in zip(shared, out[0]):
            assert torch.equal(a, b)


def test_lm_ndt_refuses_f64_and_compact(lm_shapes):
    (init, px, py, mask_f, table, grid, _), cfg = lm_shapes["window"]
    points = torch.stack([px, py], -1)
    with pytest.raises(TypeError, match="float32"):
        tmatch.match_batch_packed(points.double(), mask_f > 0,
                                  table.double(), init.double(), grid, cfg)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tmatch.match_batch_packed(points, mask_f > 0, table, init, grid,
                                  dataclasses.replace(cfg,
                                                      compact_table=True))


def test_match_batch_packed_makes_no_host_sync(lm_shapes, loop_store):
    """torch.cuda.set_sync_debug_mode("error") around one call, and around
    one gated loop verify (``verify_candidates_cached_flat``)."""
    import chip_smoke as cs

    for args, cfg in lm_shapes.values():
        if args[6] is None:
            cs.check_no_sync(args, cfg)
    cfg3, seq, kf = loop_store
    cs.gated_verify_identity(cfg3, seq, kf, 0, torch.device("cuda"), 16)


@pytest.fixture(scope="module")
def loop_store():
    """Config 3 and box-world draw 0 with its 1,024-slot keyframe cache (as
    ``chip_smoke`` builds it)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    import chip_smoke as cs
    from ndtpu_torch.config import PipelineConfig

    cfg3 = PipelineConfig.from_json(str(cs.CONFIG3))
    seq = cs.box_sequence(0, cfg3.n_beams)
    return cfg3, seq, cs.box_store(cfg3, seq, torch.device("cuda"))


@pytest.mark.parametrize("c", [16, 64])
def test_gated_verify_bit_equal_to_lm_ndt_then_loop_gate(loop_store, c):
    """One gated lm_ndt launch per verify: the five registration outputs
    and the three gate outputs bit-equal to lm_ndt_grouped followed by the
    standalone K8b on the same inputs, two gated calls in a row equal (the
    arrival counters reset), no host sync, and its gate against the f64
    twin on its own registrations (see chip_smoke.gated_verify_identity);
    config 3's 16 candidates and config 5's 64."""
    import chip_smoke as cs

    cfg3, seq, kf = loop_store
    g = cs.gated_verify_identity(cfg3, seq, kf, 0, torch.device("cuda"), c)
    assert bool(g["ref"].accept.any())


@pytest.fixture(scope="module")
def smoother():
    """The smoother's state at the end of box-world config-3 draw 2 (300
    scans, loops closed; 1,024 pose and 2,048 factor slots), its newest
    poses moved (``chip_smoke.smoother_state``), and config 3."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    import chip_smoke as cs
    from ndtpu_torch.config import PipelineConfig
    from ndtpu_torch.slam import pipeline

    cfg3 = PipelineConfig.from_json(str(cs.CONFIG3))
    seq = cs.box_sequence(2, cfg3.n_beams)
    dev = torch.device("cuda")
    state, _ = pipeline.run_slam_windowed(seq.points.to(dev),
                                          seq.mask.to(dev),
                                          seq.odom.to(dev), cfg3)
    assert int(state.n_loops) > 0
    return cs.smoother_state(state, 0), cfg3


def test_factor_linearize_matches_plain_and_repeats(smoother):
    """K5 (whole graph, gathered rows, chi^2, fresh window) against its f32
    plain version at rtol 1e-5, bit-identical on a second launch (see
    chip_smoke.check_k5)."""
    import chip_smoke as cs

    kernels.reset_launches()
    cs.check_k5(*smoother, jobs=[])
    assert kernels.LAUNCHES["factor_linearize"] >= 4


def test_pcg_solve_matches_f32_and_f64_plain(smoother):
    """K6 against the f32 and f64 plain solves (within 2 x the f32 error
    against f64, iterations within 1), bit-identical on a second launch,
    one launch and no host sync per pcg call, the 0-iteration mode (see
    chip_smoke.check_k6)."""
    import chip_smoke as cs

    row = cs.check_k6(*smoother, jobs=[])
    assert row["iterations"] > 0


def test_local_select_bit_equal_to_plain(smoother):
    """K7a equals the plain selection bit for bit and repeats (see
    chip_smoke.check_k7a)."""
    import chip_smoke as cs

    kernels.reset_launches()
    cs.check_k7a(*smoother, jobs=[])
    assert kernels.LAUNCHES["local_select"] >= 6


def test_local_assemble_matches_plain_and_repeats(smoother):
    """K7b against its f32 plain version at rtol 1e-5, bit-identical on a
    second launch (see chip_smoke.check_k7b)."""
    import chip_smoke as cs

    kernels.reset_launches()
    cs.check_k7b(*smoother, jobs=[])
    assert kernels.LAUNCHES["local_assemble"] >= 2


def test_incremental_update_through_the_kernels(smoother):
    """incremental_update on the card reaches no plain version and agrees
    with the plain route (f32 and f64) for the local and global takes, the
    settled check and the full solve; local_update with a K7a probe makes
    no host sync (see chip_smoke.check_incremental_takes)."""
    import chip_smoke as cs

    kernels.reset_launches()
    takes = cs.check_incremental_takes(*smoother)
    assert takes["global"] == 1 and takes["local"] == 2
    for name in ("factor_linearize", "pcg_solve", "local_select",
                 "local_assemble"):
        assert kernels.LAUNCHES[name] > 0, name


def _tiny_graph(dev, v, f, p=4):
    from ndtpu_torch.graph import factors as tfct

    g = tfct.empty_graph(v, p, f, torch.float32, dev)
    return g._replace(pose_mask=torch.ones(v, dtype=torch.bool, device=dev))


def test_pcg_solve_refuses_above_one_block(dev):
    """Config 4's 10k-pose graphs do not fit K6's one block: it raises,
    naming ROADMAP A10, before any launch."""
    from ndtpu_torch.graph import factors as tfct
    from ndtpu_torch.graph import solve as tslv

    g = _tiny_graph(dev, 10240, 20480)
    lin = tfct.linearize(g)
    kernels.reset_launches()
    with pytest.raises(ValueError, match="A10"):
        tslv.pcg_solve(g, lin, None, 1e-4, 10, 1e-5)
    assert kernels.LAUNCHES["pcg_solve"] == 0


def test_smoother_kernels_refuse_cpu_tensors():
    """The raw entry points take CUDA tensors only (the graph wrappers send
    CPU tensors to the plain versions before they get here)."""
    from ndtpu_torch.config import SolverConfig
    from ndtpu_torch.graph import factors as tfct

    g = _tiny_graph("cpu", 8, 16)
    args = tfct._graph_args(g)
    lin = tfct.factor_linearize_ref(*args)
    sel_args = (g.bet_i, g.bet_j, g.bet_mask, g.pose_mask, g.prior_idx,
                g.prior_mask, g.n_between, None, SolverConfig())
    calls = [
        lambda: kernels.factor_linearize(*args, 0.0),
        lambda: kernels.fresh_residual_max(*args, g.n_between, 4),
        lambda: kernels.pcg_solve(g.bet_i, g.bet_j, g.bet_mask, g.prior_idx,
                                  g.prior_mask, g.pose_mask, lin, None, 1e-4,
                                  10, 1e-5),
        lambda: kernels.local_select(*sel_args),
        lambda: kernels.local_assemble(
            2, *lin[0], *lin[1], g.bet_mask, g.bet_i, g.bet_i, g.bet_j,
            g.bet_j, g.prior_mask, g.prior_idx, g.prior_idx),
    ]
    for call in calls:
        with pytest.raises(ValueError, match="expected a CUDA tensor"):
            call()


@pytest.fixture(scope="module", params=["small", "full"])
def config4(request):
    """Config 4's graph on the card: a 600-pose Manhattan world at P = 8
    ("small") and bench.py's 10k poses at P = 64 ("full"), with its plan
    and K5's linearization (``chip_smoke.config4_case``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    import chip_smoke as cs

    n, shards = (600, 8) if request.param == "small" else (10000, 64)
    return cs.config4_case(torch.device("cuda"), 0, n, shards)


def test_supernodal_assemble_matches_plain_and_repeats(config4):
    """K9a against its plain version in f32 on the card and in f64 on the
    CPU (rtol 1e-5 of each target's max), bit-identical on a second launch
    (see chip_smoke.check_k9a)."""
    import chip_smoke as cs

    kernels.reset_launches()
    cs.check_k9a(config4, jobs=[])
    assert kernels.LAUNCHES["supernodal_assemble"] >= 2


def test_schur_reduce_matches_plain_and_repeats(config4):
    """K9b against its plain version in f32 on the card and in f64 on the
    CPU, bit-identical on a second launch (see chip_smoke.check_k9b)."""
    import chip_smoke as cs

    _, out = cs.check_k9a(config4, jobs=[])
    kernels.reset_launches()
    cs.check_k9b(config4, out, jobs=[])
    assert kernels.LAUNCHES["schur_reduce"] >= 2


def test_supernodal_step_on_the_card(config4):
    """One supernodal_delta through K5, K9a and K9b against the f64 plain
    route (within 2 x the f32 plain route's error + 1e-6 x max|delta|)."""
    import chip_smoke as cs

    kernels.reset_launches()
    cs.check_supernodal_step(config4)
    assert kernels.LAUNCHES["supernodal_assemble"] == 1
    assert kernels.LAUNCHES["schur_reduce"] == 1


def test_supernodal_kernels_refuse_cpu_tensors():
    """K9a's and K9b's raw entry points take CUDA tensors only (the graph
    wrappers send CPU tensors to the plain versions first)."""
    from ndtpu_torch.data import g2o
    from ndtpu_torch.graph import factors as tfct
    from ndtpu_torch.graph import supernodal as tsn

    g = g2o.to_graph(g2o.manhattan_world(60, seed=1), torch.float32)
    plan = tsn.plan_supernodal(g, 3)
    t = tsn.tables_on(plan, "cpu")
    (ai, aj, r), (ap, rp) = tfct.linearize(g)
    sp = plan.schur
    h = tsn.supernodal_assemble_ref(plan, ai, aj, r, ap, rp)
    nsl3 = 3 * plan.ns_loc
    calls = [
        lambda: kernels.supernodal_assemble(
            ai, aj, r, ap, rp, t.row_ptr, t.tgt_col, t.tgt_ptr, t.code,
            t.vec_ptr, t.vcode, sp.fac_idx.shape[0], sp.ni, plan.ns_loc,
            sp.ns),
        lambda: kernels.schur_reduce(
            torch.zeros(3, nsl3, nsl3), torch.zeros(3, nsl3), h[2], h[4],
            t.hold_ptr, t.hold_shard, t.hold_loc, t.loc_of, t.sep_mask,
            1e-3, plan.ns_loc),
    ]
    for call in calls:
        with pytest.raises(ValueError, match="expected a CUDA tensor"):
            call()


@pytest.fixture(scope="module")
def serving():
    """The stacked serving state on the card: 8 sessions x 120 scans of
    ``configs/config_serving.json`` under ``serving_config`` (the sessions
    of ``python -m ndtpu_torch.serve``, cut in length), and the config."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    import chip_smoke as cs
    from ndtpu_torch import serve
    from ndtpu_torch.config import PipelineConfig
    from ndtpu_torch.dist import slam_dp

    cfg = slam_dp.serving_config(PipelineConfig.from_json(str(cs.SERVING)))
    cfg = dataclasses.replace(cfg, keyframe=dataclasses.replace(
        cfg.keyframe, capacity=serve.auto_capacity(cfg, 120)))
    points, mask, odom, _ = serve.pad_sessions(
        serve.synthetic_sessions(cfg, 8, 120))
    dev = torch.device("cuda")
    with cs.no_plain_on_card(cs.PLAIN_SERVING):
        state, outs = slam_dp.run_sessions_stacked(
            points.to(dev), mask.to(dev), odom.to(dev), cfg)
    assert int(outs.n_dropped.sum()) == 0
    return state, cfg


def test_pcg_solve_blocked_matches_plain_and_repeats(serving):
    """K6b against its plain version in f32 on the card and f64 on the CPU
    (rtol 1e-4 per session), bit-identical on a second launch, an idle
    session at x = 0 (see chip_smoke.check_k6b)."""
    import chip_smoke as cs

    kernels.reset_launches()
    row = cs.check_k6b(*serving, 0, jobs=[])
    assert row["sessions"] == 8 and kernels.LAUNCHES["pcg_solve_blocked"] > 2


def test_halfcell_add_stacked_bit_equal_to_single_launches(serving):
    """K3s at the window and refresh shapes equals 8 single K3 launches
    bit for bit, and repeats (see chip_smoke.check_k3s)."""
    import chip_smoke as cs

    kernels.reset_launches()
    cs.check_k3s(*serving, jobs=[])
    assert kernels.LAUNCHES["halfcell_add_stacked"] > 4


def test_finalize_pack_stacked_bit_equal_to_single_launches(serving):
    """K4s equals 8 single K4 launches bit for bit, repeats, and matches
    the plain twin (see chip_smoke.check_k4s)."""
    import chip_smoke as cs

    kernels.reset_launches()
    cs.check_k4s(*serving, jobs=[])
    assert kernels.LAUNCHES["finalize_pack_stacked"] > 2


def test_padded_sessions_on_the_card(dev):
    """Sessions of different lengths, padded as the serving CLI pads them:
    all-masked lanes end at 0 iterations, K3s leaves an all-masked map as
    it was, K4s packs an empty map finite, the gated verify takes empty
    candidates, and a stacked run keeps its padded tail empty (see
    chip_smoke.check_padded_sessions)."""
    import chip_smoke as cs

    kernels.reset_launches()
    cs.check_padded_sessions(dev)
    assert kernels.LAUNCHES["halfcell_add_stacked"] > 0


def test_stacked_kernels_refuse_cpu_tensors():
    """K3s' and K4s' raw entry points take CUDA tensors only (the map
    wrappers send CPU tensors to their twins first; K6b's refusal is in
    test_torch_blocked_pcg)."""
    stats8 = tgrid.NDTStats(*(torch.stack([t, t]) for t in
                              tgrid.empty_stats(GRID)))
    pts = torch.zeros(2, 10, 2)
    msk = torch.ones(2, 10, dtype=torch.bool)
    calls = [
        lambda: kernels.halfcell_add_stacked(*stats8, pts, msk, 1.0, GRID),
        lambda: kernels.finalize_pack_stacked(*stats8, NDT, GRID),
    ]
    for call in calls:
        with pytest.raises(ValueError, match="expected a CUDA tensor"):
            call()


def test_ndt_sgh_unpacked_matches_plain_and_repeats(dev):
    """K12 against its plain version in f32 on the card (rtol 1e-5 of each
    output's max), bit-identical on a second launch, and against its f64
    plain version on the CPU with the beams whose cell differs between f32
    and f64 masked (each such beam within ``K12_EDGE_EPS`` of a cell edge,
    rtol ``K12_F64_RTOL``; ``chip_smoke.check_k12``), at 1,024 poses over
    a seeded map; a wholly masked scan and poses far off the map give zero
    terms."""
    import chip_smoke as cs
    from ndtpu_torch.config import MatchConfig

    ndt_map = tgrid.finalize(_stats(dev), NDT)
    pts, mask = _points(3, 360, dev)
    rng = np.random.default_rng(4)
    poses = torch.as_tensor(np.stack([rng.uniform(-2, 2, 1024),
                                      rng.uniform(-2, 2, 1024),
                                      rng.uniform(-np.pi, np.pi, 1024)], -1),
                            dtype=torch.float32, device=dev)
    kernels.reset_launches()
    cs.check_k12("test", poses, pts, mask, ndt_map, GRID, MatchConfig(),
                 jobs=[])
    assert kernels.LAUNCHES["ndt_sgh_unpacked"] >= 2
    off = poses[:8] + torch.tensor([500.0, 0.0, 0.0], device=dev)
    for p, m in ((off, mask), (poses[:8], torch.zeros_like(mask))):
        f, g, h, score = tmatch.score_grad_hess_batch(p, pts, m, ndt_map,
                                                      GRID, MatchConfig())
        for x in (f, g, h, score):
            assert bool((x == 0).all())


def test_schur_local_assemble_matches_plain_and_repeats(dev):
    """K9c on both ranks' rows of a 600-pose Manhattan graph split in two
    against its plain version in f32 on the card and in f64 on the CPU,
    bit-identical on a second launch (``chip_smoke.check_k9c``)."""
    import chip_smoke as cs
    from ndtpu_torch.data import g2o

    g = g2o.to_graph(g2o.manhattan_world(600, seed=1, loop_prob=0.2),
                     torch.float32, device=dev)
    kernels.reset_launches()
    cs.check_k9c(g, 2, 1e-3, jobs=[])
    assert kernels.LAUNCHES["schur_local_assemble"] >= 4


def test_optimize_schur_one_rank_on_the_card(dev):
    """The distributed LM loop on one rank on the card (one K9c and two K5
    launches per iteration) against the same loop in f64 on the CPU."""
    from ndtpu_torch.config import SolverConfig
    from ndtpu_torch.data import g2o
    from ndtpu_torch.dist import mesh as tmesh
    from ndtpu_torch.dist import schur as tschur

    data = g2o.manhattan_world(300, seed=2, loop_prob=0.2)
    out = {}
    for name, d, dt in (("card", dev, torch.float32),
                        ("cpu", "cpu", torch.float64)):
        g = g2o.to_graph(data, dt, device=d)
        g = g._replace(poses=g.poses + 0.02 * torch.sin(
            torch.arange(g.poses.numel(), device=d, dtype=dt)).view(-1, 3))
        plan = tschur.plan_partition(
            g.bet_i.cpu().numpy(), g.bet_j.cpu().numpy(),
            g.bet_mask.cpu().numpy(), g.prior_idx.cpu().numpy(),
            g.prior_mask.cpu().numpy(), g.poses.shape[0], 1)
        kernels.reset_launches()
        out[name] = tschur.optimize_schur(tmesh.multihost_mesh(device=d), g,
                                          plan, SolverConfig(max_iter=6))
        if name == "card":
            it = int(out[name].n_iter)
            assert kernels.LAUNCHES["schur_local_assemble"] == it
            assert kernels.LAUNCHES["factor_linearize"] == 2 * it
    assert float(out["card"].chi2) == pytest.approx(float(out["cpu"].chi2),
                                                    rel=1e-3, abs=1e-3)


def test_config5_kernels_refuse_cpu_tensors():
    """K12's and K9c's raw entry points take CUDA tensors only (the
    wrappers send CPU tensors to the plain versions first)."""
    from ndtpu_torch.data import g2o
    from ndtpu_torch.dist import schur as tschur

    ndt_map = tgrid.finalize(tgrid.empty_stats(GRID), NDT)
    pts, mask = _points(3, 64, "cpu")
    g = g2o.to_graph(g2o.manhattan_world(60, seed=1), torch.float32)
    plan = tschur.plan_partition(
        g.bet_i.numpy(), g.bet_j.numpy(), g.bet_mask.numpy(),
        g.prior_idx.numpy(), g.prior_mask.numpy(), 60, 2)
    t = tschur.rank_tables(plan, 0, "cpu")
    routes = {k: torch.as_tensor(v) for k, v in
              tschur.rank_routes(plan, 0).items()}
    loc = tuple(x[0] for x in tschur.shard_factor_data_local(g, plan, 0))
    lin = tschur._linearize_shard(g.poses, *loc)
    calls = [
        lambda: kernels.ndt_sgh_unpacked(
            torch.zeros(4, 3), pts, mask.float(), *ndt_map, GRID, 0.5, 40.0),
        lambda: kernels.schur_local_assemble(
            *lin, routes["row_ptr"], routes["tgt_col"], routes["tgt_ptr"],
            routes["code"], routes["vec_ptr"], routes["vcode"], t.int_mask,
            1e-3, t.ni, t.ns),
    ]
    for call in calls:
        with pytest.raises(ValueError, match="expected a CUDA tensor"):
            call()


@pytest.mark.parametrize("x_lo,width", [(0, 24), (21, 30), (-5, 34)])
def test_slab_accumulate_matches_model_and_plain(dev, x_lo, width):
    """K10a on an owned slab, a halo-extended one past the map's high edge
    and one past its low edge: bit for bit its fixed-point model, on a
    second launch and with the points permuted; against its f32 plain
    version and the f64 sums on the same cells
    (``chip_smoke.check_k10a``)."""
    import chip_smoke as cs

    pts, mask = _points(5, 30000, dev)
    kernels.reset_launches()
    cs.check_k10a("test", pts, mask, GRID, x_lo, width, jobs=[])
    assert kernels.LAUNCHES["slab_accumulate"] >= 3


def test_finalize_cells_matches_plain(dev):
    """K10b (``ndt.grid.finalize`` on CUDA tensors) in the dense and the
    slab layout against its f32 plain version: valid flags exact, the rest
    within rtol 1e-5 (``chip_smoke.check_k10b``); the two layouts give the
    same cells."""
    import chip_smoke as cs
    from ndtpu_torch.dist import gridmap

    stats = _stats(dev)
    slab = gridmap.dense_to_slab(stats, GRID)
    kernels.reset_launches()
    cs.check_k10b("test dense", stats, NDT, jobs=[])
    cs.check_k10b("test slab", slab, NDT, jobs=[])
    assert kernels.LAUNCHES["finalize_cells"] >= 4
    a = gridmap.dense_to_slab(tgrid.finalize(stats, NDT), GRID)
    b = gridmap.finalize_slab(slab, NDT)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_slab_sgh_matches_plain_and_match_slab_one_rank(dev):
    """K10c on each half of a seeded map against its f32 plain version
    (``chip_smoke.check_k10c``) at B = 1 and B = 64; the two halves' sums
    add up to K12's terms on the whole map; and ``match_slab`` on one rank
    (one K10c launch per evaluation, no collective) within 5e-4 of
    ``lm_loop`` on K12 over the dense map."""
    import chip_smoke as cs
    from ndtpu_torch.config import MatchConfig
    from ndtpu_torch.dist import gridmap
    from ndtpu_torch.dist import mesh as tmesh

    stats = _stats(dev)
    ndt_map = tgrid.finalize(stats, NDT)
    smap = gridmap.dense_to_slab(ndt_map, GRID)
    halves = [gridmap.SlabMap(*(x[:, 24 * r:24 * r + 24].contiguous()
                                for x in smap)) for r in range(2)]
    pts, mask = _points(3, 360, dev)
    rng = np.random.default_rng(6)
    poses = torch.as_tensor(np.stack([rng.uniform(-1, 1, 64),
                                      rng.uniform(-1, 1, 64),
                                      rng.uniform(-0.5, 0.5, 64)], -1),
                            dtype=torch.float32, device=dev)
    kernels.reset_launches()
    for r in range(2):
        for b in (1, 64):
            cs.check_k10c(f"test half {r}", poses[:b], pts, mask, halves[r],
                          GRID, 24 * r, MatchConfig(), jobs=[])
    assert kernels.LAUNCHES["slab_sgh"] >= 8
    cfg = MatchConfig()
    total = sum(gridmap.slab_sgh(poses, pts, mask, halves[r], GRID, 24 * r,
                                 cfg) for r in range(2))
    f, g, h, _ = tmatch.score_grad_hess_batch(poses, pts, mask, ndt_map,
                                              GRID, cfg)
    for got, ref in ((total[:, 0], f), (total[:, 3:6], g),
                     (total[:, 6:], h.reshape(-1, 9))):
        assert float((got - ref).abs().max()) <= 1e-4 * max(
            float(ref.abs().max()), 1.0)
    one = tmesh.RankMesh(0, 1, dev, ("space",))
    kernels.reset_launches()
    res = gridmap.match_slab(one, pts, mask, smap, poses[0], GRID, cfg)
    assert kernels.LAUNCHES["slab_sgh"] == int(res.n_iter) + 1
    ref = tmatch.lm_loop(lambda p: tuple(x[0] for x in
                                         tmatch.score_grad_hess_batch(
                                             p[None], pts, mask, ndt_map,
                                             GRID, cfg)), poses[0], cfg)
    assert float((res.pose - ref.pose).abs().max()) <= 5e-4


def test_slab_kernels_refuse_cpu_tensors():
    """K10a's, K10b's and K10c's raw entry points take CUDA tensors only
    (the wrappers send CPU tensors to the plain versions first)."""
    pts, mask = _points(3, 64, "cpu")
    stats = tgrid.empty_stats(GRID)
    m = tgrid.finalize(stats, NDT)
    slab = [x.reshape((4, 48, 48) + x.shape[2:]) for x in m]
    calls = [
        lambda: kernels.slab_accumulate(pts, mask, GRID, 0, 24),
        lambda: kernels.finalize_cells(*stats, NDT),
        lambda: kernels.slab_sgh(torch.zeros(1, 3), pts, mask.float(),
                                 *slab, GRID, 0, 0.5, 40.0),
    ]
    for call in calls:
        with pytest.raises(ValueError, match="expected a CUDA tensor"):
            call()
