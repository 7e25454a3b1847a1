"""The CUDA kernels (lm_ndt shared and grouped, K1 ndt_terms shared and
grouped, K3 halfcell_add, K4 finalize_pack, K8a local_tables, K8b
loop_gate, the gated verify that runs K8b inside lm_ndt, and the
smoother's K5 factor_linearize (also with each robust kind, K5r), K6
pcg_solve, K7a local_select and K7b local_assemble, also through
incremental_update, K6g pcg_solve_grid (the PCG past one block) at config
4's 10k poses, also through solve_g2o --method pcg and bench.py §5's
incremental updates, and config 4's K9a
supernodal_assemble and K9b schur_reduce, also through one supernodal
step (K9a also bit for bit against the plain model of its sum order,
supernodal_assemble_model, where the rows start at every offset of a
16-byte line and at several launch shapes), and stacked serving's K6b
pcg_solve_blocked, K3s halfcell_add_stacked and K4s finalize_pack_stacked (also in the other table layouts: K3s at
overlap 1, K4s in g1l8, g4l4 and g1l4), and config 5's K12
ndt_sgh_unpacked (also at overlap 1) and
K9c schur_local_assemble, also through a one-rank optimize_schur (and bit
for bit against schur_local_assemble_model, dead interior slots too), the
slab map's K10a slab_accumulate, K10b finalize_cells (also on the slab
exchange's records, bit-equal to three arrays at every block size) and
K10c slab_sgh,
also through a one-rank match_slab (K10a and K10c also at overlap 1; K10c
also past its 1,024 beams a block), and the inputs' K11 raycast and K13
voxel_downsample, also through make_sequence and the CLI's scan mode; K7b
and K11 also past the sizes their first designs refused)
against their plain twins, on the card; K9b also bit for bit against the
plain model of its sum order (schur_reduce_model); K10a also against the
plain model of its fixed-point arithmetic, bit for bit, also on slabs of
several tiles in x and y, with every point in one cell, every point
masked out and no points, on a slab past the tiles its bin blocks count in
shared memory and on 60 M points; K3 also against the plain model of its
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
    """f64 is refused; a compact table is no longer refused: it launches the
    compact instantiation (``lm_ndt[g4l4]``), once, and a full-row table
    under ``compact_table`` is refused by its shape."""
    import chip_smoke as cs

    (init, px, py, mask_f, table, grid, _), cfg = lm_shapes["window"]
    points = torch.stack([px, py], -1)
    with pytest.raises(TypeError, match="float32"):
        tmatch.match_batch_packed(points.double(), mask_f > 0,
                                  table.double(), init.double(), grid, cfg)
    ccfg = dataclasses.replace(cfg, compact_table=True)
    stats = cs.map_stats(cs.box_sequence(0, px.shape[1]), grid, px.device)
    compact = tgrid.finalize_pack(stats, NDT, grid, compact=True)
    assert compact.shape == (table.shape[0], 16)
    kernels.reset_launches()
    res = tmatch.match_batch_packed(points, mask_f > 0, compact, init, grid,
                                    ccfg)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["lm_ndt[g4l4]"] == 1
    assert sum(kernels.LAUNCHES.values()) == 1
    assert bool(torch.isfinite(res.pose).all()) and bool(res.converged.any())
    with pytest.raises(ValueError, match="expected shape"):
        tmatch.match_batch_packed(points, mask_f > 0, table, init, grid, ccfg)


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


def test_pcg_solve_scattered_slots_match_permuted(smoother):
    """K6 with the live poses and factors scattered through the slots, and
    with those slots permuted again, in six orders: each within
    pcg_vs_plain's gates against the f32 plain version on the CPU (the
    error gate on the medians over the orders; see
    chip_smoke.check_k6_scattered)."""
    import chip_smoke as cs

    kernels.reset_launches()
    row = cs.check_k6_scattered(*smoother)
    assert len(row["iterations"]) == 6 and min(row["iterations"]) > 0
    assert kernels.LAUNCHES["pcg_solve"] == 12


def test_pcg_solve_through_the_scratch(dev):
    """K6 on a 1,200-pose graph with every slot live, whose live data does
    not fit the shared memory K6's layout leaves (its loop reads through
    L1 and the device scratch), within pcg_vs_plain's gates (see
    chip_smoke.check_k6_scratch)."""
    import chip_smoke as cs

    row = cs.check_k6_scratch(dev)
    assert row["iterations"] > 0


def test_local_select_bit_equal_to_plain(smoother):
    """K7a equals the plain selection bit for bit and repeats, on the
    config-3 graph (1,024 pose slots) and on bench.py §5b's local graph
    (10,064), with ``since`` the newest factor, none and 40 back (see
    chip_smoke.check_k7a)."""
    import chip_smoke as cs

    kernels.reset_launches()
    row = cs.check_k7a(*smoother, jobs=[])
    assert kernels.LAUNCHES["local_select"] >= 12
    assert kernels.LAUNCHES["local_select[scratch]"] == 0
    assert row["pose_slots"] == 1024
    assert row["local_10k"]["pose_slots"] == 10064


def test_local_select_past_one_block_bit_equal_to_plain(dev):
    """K7a past the first design's shared memory equals the plain selection
    bit for bit and repeats: staged on the shared route at 25,064 pose
    slots, on the scratch route (``local_select[scratch]``) at 70,064,
    and with the endpoints read from the graph at 60,000 factor slots; a
    local-path incremental_update on the first two runs through the route
    within the plain route's gates (see chip_smoke.check_k7a_past_block)."""
    import chip_smoke as cs

    kernels.reset_launches()
    launches, row, shared = cs.check_k7a_past_block(dev, 0, jobs=[])
    assert row["update"]["take"] == 2 and launches["local_select"] == 0
    assert launches["local_select[scratch]"] > 0
    assert row["pose_slots"] == cs.SELECT_SCRATCH_SLOTS
    assert shared["update"]["take"] == 2 and shared["pose_slots"] == 25064
    assert shared["select_smem"] <= kernels.SMEM_MAX
    wide = shared["endpoints_in_graph"]
    assert wide["factor_slots"] == cs.SELECT_WIDE_FACTORS
    assert wide["select_smem"] > kernels.SMEM_MAX


@pytest.mark.parametrize("hops", [1, 3, 130])
def test_local_select_hops_bit_equal_to_plain(dev, hops):
    """K7a at other ``local_hops``, past the 126 hops its pose bytes record
    as levels too (a hop then splits into its flags, a barrier and the
    scatter), on config 4's Manhattan graph of 1,000 poses in 1,024 pose
    and 2,048 factor slots (see chip_smoke.k7a_case)."""
    import dataclasses as dc

    import chip_smoke as cs
    from ndtpu_torch.config import SolverConfig

    g0 = cs.config4_graph(dev, torch.float32, 0, 1000)
    g, since = cs.local_graph(g0, 1024, 2048 - g0.bet_i.shape[0])
    cfg = dc.replace(SolverConfig(**cs.ICFG_10K), local_hops=hops)
    kernels.reset_launches()
    row = cs.k7a_case(f"{hops} hops", g, cfg, since, jobs=[])
    assert kernels.LAUNCHES["local_select"] >= 6
    assert row["select_smem"] <= kernels.SMEM_MAX


def test_factor_linearize_one_launch_per_mode(smoother):
    """K5 makes one launch per call in each mode (whole graph, chi^2,
    gathered rows and their chi^2, the fresh window), by the launch counter
    and by the profiler's device operations, and is bit-identical on a
    second launch in each (see chip_smoke.check_k5_one_launch)."""
    import chip_smoke as cs

    row = cs.check_k5_one_launch(*smoother)
    assert set(row) == set(cs.k5_calls(*smoother))
    for mode, fn in cs.k5_calls(*smoother).items():
        assert row[mode]["launches_per_call"] == 1, mode
        one, two = fn(), fn()
        torch.cuda.synchronize()
        assert cs.bits_equal(one, two), mode


def test_local_assemble_matches_plain_and_repeats(smoother):
    """K7b against its f32 plain version at rtol 1e-5, bit-identical on a
    second launch (see chip_smoke.check_k7b)."""
    import chip_smoke as cs

    kernels.reset_launches()
    cs.check_k7b(*smoother, jobs=[])
    assert kernels.LAUNCHES["local_assemble"] >= 2


@pytest.mark.parametrize("k,n", [(8192, 256), (12000, 64)])
def test_local_assemble_past_the_old_slot_limit(dev, k, n):
    """K7b at 8,192 and 12,000 gathered slots (the first design held at
    most ~7,258 in shared memory) on seeded rows (``chip_smoke
    .k7b_random_args``: buckets of ~70 / ~400 places, repeated pairs)
    against its f32 plain version at rtol 1e-5, bit-identical on a second
    launch, one launch per call (see chip_smoke.k7b_case)."""
    import chip_smoke as cs

    kernels.reset_launches()
    row = cs.k7b_case(f"K={k}", cs.k7b_random_args(dev, k, n, 16))
    assert np.isfinite(row["max_abs_err"])
    assert kernels.LAUNCHES["local_assemble"] >= 2


def _mtm3(a, b):
    """``csrc/pose_graph.cuh``'s A^T B, each product and sum rounded in f32
    in its order."""
    f = np.float32
    out = np.zeros(9, f)
    for p in range(3):
        for q in range(3):
            out[3 * p + q] = (f(f(a[p] * b[q]) + f(a[3 + p] * b[3 + q]))
                              + f(a[6 + p] * b[6 + q]))
    return out


def _mtv3(a, v):
    f = np.float32
    return np.array([f(f(a[q] * v[0]) + f(a[3 + q] * v[1])) + f(a[6 + q]
                     * v[2]) for q in range(3)], f)


def test_local_assemble_empty_rows_and_one_row(dev):
    """K7b with no selected slot and no active prior: h_ii and b_i all
    zeros. With one slot whose two sides are interior at the same local
    row: its four blocks land in one column block, summed from 0 in code
    order (i-side own, i-side cross, j-side own, j-side cross), and b from
    the two own blocks' A^T r in that order, bit for bit (numpy in f32, one
    rounding per operation); nothing else is written."""
    import chip_smoke as cs
    from ndtpu_torch.dist import schur

    args = list(cs.k7b_random_args(dev, 64, 12, 2, seed=5))
    args[6] = torch.zeros_like(args[6])
    args[11] = torch.zeros_like(args[11])
    h, b = schur.assemble_local(*args)
    torch.cuda.synchronize()
    assert not bool(h.any()) and not bool(b.any())
    args[6][3] = True
    for t in (7, 9):
        args[t] = torch.zeros_like(args[t])       # both sides interior
    for t in (8, 10):
        args[t] = torch.full_like(args[t], 4)     # ... at local row 4
    h, b = schur.assemble_local(*args)
    torch.cuda.synchronize()
    ai, aj = (args[k][3].reshape(9).cpu().numpy() for k in (1, 2))
    r = args[3][3].cpu().numpy()
    acc = np.zeros(9, np.float32)
    for ga, gb in ((ai, ai), (ai, aj), (aj, aj), (aj, ai)):
        acc = acc + _mtm3(ga, gb)
    acc3 = (np.zeros(3, np.float32) + _mtv3(ai, r)) + _mtv3(aj, r)
    want_h = torch.zeros_like(h)
    want_h[12:15, 12:15] = torch.as_tensor(acc.reshape(3, 3))
    want_b = torch.zeros_like(b)
    want_b[12:15] = torch.as_tensor(acc3)
    assert cs.bits_equal((h, b), (want_h, want_b))
    hr, br = schur.assemble_local_ref(*args)
    cs._rel_check("K7b one row", (h, b), (hr, br))


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
    """Config 4's 10k-pose graphs do not fit K6's one block: the raw K6
    entry point raises, naming K6g and graph.solve.pcg_solve's route,
    before any launch; graph.solve.pcg_solve sends the graph to K6g."""
    from ndtpu_torch.graph import factors as tfct
    from ndtpu_torch.graph import solve as tslv

    g = _tiny_graph(dev, 10240, 20480)
    lin = tfct.linearize(g)
    kernels.reset_launches()
    with pytest.raises(ValueError, match="K6g .*pcg_route"):
        kernels.pcg_solve(g.bet_i, g.bet_j, g.bet_mask, g.prior_idx,
                          g.prior_mask, g.pose_mask, lin, None, 1e-4, 10,
                          1e-5)
    assert kernels.LAUNCHES["pcg_solve"] == 0
    x, it, _ = tslv.pcg_solve(g, lin, None, 1e-4, 10, 1e-5)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["pcg_solve"] == 0
    assert kernels.LAUNCHES["pcg_solve_grid"] == 1
    assert bool(torch.isfinite(x).all()) and int(it) == 0


@pytest.mark.parametrize("v,f,p", [(1024, 2048, 4), (2048, 4096, 8),
                                   (10000, 10305, 1), (160, 320, 1)])
def test_pcg_route_matches_the_launcher(dev, v, f, p):
    """kernels.pcg_route says "block" exactly where K6's launcher takes the
    graph: on the card, K6 launches there and refuses elsewhere."""
    from ndtpu_torch.graph import factors as tfct

    g = _tiny_graph(dev, v, f, p)
    lin = tfct.linearize(g)
    args = (g.bet_i, g.bet_j, g.bet_mask, g.prior_idx, g.prior_mask,
            g.pose_mask, lin, None, 1e-4, 1, 1e-5)
    if kernels.pcg_route(v, f, p) == "block":
        kernels.pcg_solve(*args)
        torch.cuda.synchronize()
    else:
        with pytest.raises(ValueError, match="K6g"):
            kernels.pcg_solve(*args)


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


@pytest.fixture(scope="module")
def graph10k():
    """Config 4's (bench.py §4's) 10k-pose graph on the card with its plan
    and K5's linearization (``chip_smoke.config4_case``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    import chip_smoke as cs

    return cs.config4_case(torch.device("cuda"), 0)


def test_factor_linearize_robust_kinds_match_plain(graph10k):
    """K5r: each robust kind on the 10k graph against its f32 and f64 plain
    versions (rtol 1e-5 of each array's max), bit-identical on a second
    launch, and tests/test_robust.py's IRLS chain on the card within its
    bounds (see chip_smoke.check_k5r)."""
    import chip_smoke as cs

    rows = cs.check_k5r(graph10k)
    assert set(rows) == {"huber", "cauchy", "tukey", "geman", "irls"}
    assert all(r["err_m"] < r["bound_m"] for r in rows["irls"].values())


def test_pcg_solve_grid_at_10k_matches_f32_and_f64_plain(graph10k):
    """K6g at 10k poses against the f32 and f64 plain solves (within 2 x
    the f32 error against f64, iterations within max(1, 2%)), bit-identical
    on a second launch, one launch and no host sync per pcg call, the
    0-iteration mode (see chip_smoke.check_k6g)."""
    import chip_smoke as cs

    row = cs.check_k6g(graph10k, jobs=[])
    assert row["iterations"] > 0 and row["grid_blocks"] >= 1


def test_pcg_solve_grid_at_25k_matches_f32_and_f64_plain(dev):
    """K6g on 25,000 poses of config 4's Manhattan graph against the f32
    and f64 plain solves (within 2 x the f32 error against f64, iterations
    within max(1, 2%)), bit-identical on a second launch (see
    chip_smoke.check_k6g_past)."""
    import chip_smoke as cs

    row = cs.check_k6g_past(dev, 0)
    assert row["iterations"] > 0


def test_pcg_solve_grid_past_one_pose_per_thread(dev):
    """K6g on a Manhattan graph of more poses than its co-resident threads
    (so each owns two, and its loop keeps no pose's state in registers)
    against the f32 and f64 plain solves, bit-identical on a second launch
    (see chip_smoke.check_k6g_past)."""
    import chip_smoke as cs

    cap = kernels.pcg_grid_plan(10 ** 7, 10 ** 7, 1)[0]
    n = 256 * cap + 1000
    assert kernels.pcg_grid_plan(n, n, 1)[0] * 256 < n
    row = cs.check_k6g_past(dev, 0, n)
    assert row["iterations"] > 0


def test_solve_g2o_pcg_through_k6g(dev):
    """solve_g2o --manhattan 10000 --method pcg on the card: one K6g launch
    per pcg call, no K6, no plain version, final chi^2 within 1.02 x the
    JAX package's f32; auto at 25,000 poses takes pcg (see
    chip_smoke.run_config4_pcg)."""
    import chip_smoke as cs

    launches, out = cs.run_config4_pcg(dev, "")
    assert launches["pcg_solve_grid"] == out["pcg_calls"]
    assert out["auto_25k"]["method"] == "pcg"


def test_incremental_updates_at_10k_on_the_card(graph10k):
    """bench.py §5's three 10k paths on the card: the active update's
    global take through K6g, the settled graph's update, §5b's local take
    through K7a/K7b, each against the f64 plain route, and
    marginal_covariance_pcg at 10k (see chip_smoke.run_incremental_10k)."""
    import chip_smoke as cs

    launches, rec = cs.run_incremental_10k(graph10k, "", 0)
    assert rec["active"]["take"] == 1 and rec["local"]["take"] == 2
    assert launches["pcg_solve_grid"] == 2


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


def test_schur_reduce_equals_ordered_model_bit_for_bit(config4):
    """K9b (``h_ss`` streamed, the held entries summed) equals
    ``schur_reduce_model``, the plain model of its sum order run on the
    card, bit for bit, on the Schur parts of the card's own step."""
    from ndtpu_torch.graph import supernodal as tsn

    plan, lam = config4["plan"], config4["lam"]
    (ai, aj, r), (ap, rp) = config4["lin"]
    h_ii, h_is, h_ss, b_i, b_s = tsn.supernodal_assemble(plan, ai, aj, r,
                                                         ap, rp)
    _, _, s_part, rhs_part = tsn.interior_parts(plan, h_ii, h_is, b_i, lam)
    kernels.reset_launches()
    out = tsn.schur_reduce(plan, s_part, rhs_part, h_ss, b_s, lam)
    model = tsn.schur_reduce_model(plan, s_part, rhs_part, h_ss, b_s, lam)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["schur_reduce"] == 1
    for a, b in zip(out, model):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_supernodal_assemble_equals_ordered_model_bit_for_bit(config4):
    """K9a (every target float written once, in 16-byte stores where a
    line lies in one span) equals ``supernodal_assemble_model``, the plain
    model of its sum order run on the card, bit for bit, in one launch."""
    from ndtpu_torch.graph import supernodal as tsn

    plan = config4["plan"]
    (ai, aj, r), (ap, rp) = config4["lin"]
    kernels.reset_launches()
    out = tsn.supernodal_assemble(plan, ai, aj, r, ap, rp)
    model = tsn.supernodal_assemble_model(plan, ai, aj, r, ap, rp)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["supernodal_assemble"] == 1
    for a, b in zip(out, model):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


#: (poses, shards) of small Manhattan plans whose (ni, nsl, ns) are all odd
#: (65, 3, 5: every span's rows start at each 4-byte offset of a 16-byte
#: line), all even (36, 4, 8) and mixed (7, 4, 15; 58, 5, 11).
ASSEMBLE_PARITY = {"odd": (200, 3), "even": (150, 4), "mixed": (60, 8),
                   "mixed 2": (240, 4)}


@pytest.mark.parametrize("case", list(ASSEMBLE_PARITY))
def test_supernodal_assemble_at_every_row_offset(dev, case):
    """K9a bit for bit its model where the block rows' spans start at any
    offset mod 16 bytes (``ni``, ``nsl`` and ``ns`` odd and even), at the
    default launch shape and at shapes that split rows over many units
    (a 4-float chunk, 32 threads, a persistent grid); bit-identical
    across shapes."""
    from ndtpu_torch.data import g2o
    from ndtpu_torch.graph import factors as tfct
    from ndtpu_torch.graph import supernodal as tsn

    n, shards = ASSEMBLE_PARITY[case]
    g = g2o.to_graph(g2o.manhattan_world(n, seed=1, loop_prob=0.2),
                     torch.float32, device=dev)
    plan = tsn.plan_supernodal(g, shards)
    (ai, aj, r), (ap, rp) = tfct.linearize(g)
    model = tsn.supernodal_assemble_model(plan, ai, aj, r, ap, rp)
    sp = plan.schur
    if case == "odd":   # rows of 9n floats: each span's rows start at
        # every offset mod 4 floats
        assert sp.ni % 2 == plan.ns_loc % 2 == sp.ns % 2 == 1
    try:
        for shape in ((0, 0, 0), (32, 4, 0), (256, 12288, 0), (64, 36, 2)):
            kernels.supernodal_assemble_shape(*shape)
            out = tsn.supernodal_assemble(plan, ai, aj, r, ap, rp)
            torch.cuda.synchronize()
            for a, b in zip(out, model):
                assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    finally:
        kernels.supernodal_assemble_shape()


@pytest.mark.parametrize("n,ranks", [(60, 3), (150, 3), (200, 3), (120, 2)])
def test_schur_local_assemble_equals_ordered_model_bit_for_bit(dev, n, ranks):
    """K9c on every rank equals ``schur_local_assemble_model`` run on the
    card, bit for bit, in one launch, ``ni`` and ``ns`` odd and even; a
    dead interior slot (60 and 150 poses over 3 ranks have them) has 1 on
    its diagonal and 0 elsewhere in its rows."""
    from ndtpu_torch.data import g2o
    from ndtpu_torch.dist import schur as tschur

    g = g2o.to_graph(g2o.manhattan_world(n, seed=1, loop_prob=0.2),
                     torch.float32, device=dev)
    plan = tschur.plan_partition(
        g.bet_i.cpu().numpy(), g.bet_j.cpu().numpy(),
        g.bet_mask.cpu().numpy(), g.prior_idx.cpu().numpy(),
        g.prior_mask.cpu().numpy(), n, ranks)
    dead_seen = 0
    for rank in range(ranks):
        t = tschur.rank_tables(plan, rank, dev)
        loc = tuple(x[0] for x in tschur.shard_factor_data_local(g, plan,
                                                                 rank))
        lin = tschur._linearize_shard(g.poses, *loc)
        kernels.reset_launches()
        out = tschur.schur_local_assemble(t, 1e-3, *lin, loc[4], loc[8])
        model = tschur.schur_local_assemble_model(plan, rank, 1e-3, *lin)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["schur_local_assemble"] == 1
        for a, b in zip(out, model):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))
        h_ii = out[0].cpu()
        for slot in np.nonzero(~np.asarray(plan.int_mask[rank]))[0]:
            rows = h_ii[3 * slot:3 * slot + 3]
            assert torch.equal(rows[:, 3 * slot:3 * slot + 3], torch.eye(3))
            assert int(torch.count_nonzero(rows)) == 3
            assert int(torch.count_nonzero(out[1][3 * slot:3 * slot + 3])) \
                == 0
            dead_seen += 1
    assert dead_seen > 0 or n in (200, 120)


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
            t.hold_ptr, t.hold_shard, t.hold_loc, t.loc_of, t.touch_ptr,
            t.touch_col, t.sep_mask, 1e-3, plan.ns_loc),
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


def test_stacked_layouts_bit_equal_to_single_launches(serving):
    """K3s at overlap 1 (the rebuild, window and refresh shapes) bit-equal
    to 8 single K3[g1] launches, to the fixed-point model and on a second
    launch; K4s in g1l8, g4l4 and g1l4 bit-equal (int32) to 8 single K4
    launches of the layout, on a second launch, and to the plain twin's
    rule (see chip_smoke.check_stacked_layouts)."""
    import chip_smoke as cs

    kernels.reset_launches()
    rows = cs.check_stacked_layouts(*serving, jobs=[])
    assert kernels.LAUNCHES[kernels.variant("halfcell_add_stacked", 1)] > 6
    for g, lanes in kernels.LAYOUTS[1:]:
        name = kernels.variant("finalize_pack_stacked", g, lanes)
        assert kernels.LAUNCHES[name] > 2 and name in rows


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


GRID1 = dataclasses.replace(GRID, overlap=1)


def _stats1(dev, seed=0, n=40000):
    pts, mask = _points(seed, n, dev)
    return tgrid.halfcell_add_ref(tgrid.empty_stats(GRID1, torch.float32,
                                                    dev), pts, mask, 1.0,
                                  GRID1)


def test_ndt_sgh_unpacked_overlap1_matches_plain_and_repeats(dev):
    """K12 at overlap 1 (``ndt_sgh_unpacked[g1]``) under the rules of the
    overlap-4 test above (``chip_smoke.check_k12``), at 1,024 poses over a
    seeded one-grid map; zero terms off the map."""
    import chip_smoke as cs
    from ndtpu_torch.config import MatchConfig

    ndt_map = tgrid.finalize(_stats1(dev), NDT)
    pts, mask = _points(3, 360, dev)
    rng = np.random.default_rng(4)
    poses = torch.as_tensor(np.stack([rng.uniform(-2, 2, 1024),
                                      rng.uniform(-2, 2, 1024),
                                      rng.uniform(-np.pi, np.pi, 1024)], -1),
                            dtype=torch.float32, device=dev)
    kernels.reset_launches()
    cs.check_k12("test g1", poses, pts, mask, ndt_map, GRID1, MatchConfig(),
                 jobs=[])
    assert kernels.LAUNCHES[kernels.variant("ndt_sgh_unpacked", 1)] >= 2
    assert kernels.LAUNCHES["ndt_sgh_unpacked"] == 0
    off = poses[:8] + torch.tensor([500.0, 0.0, 0.0], device=dev)
    for x in tmatch.score_grad_hess_batch(off, pts, mask, ndt_map, GRID1,
                                          MatchConfig()):
        assert bool((x == 0).all())


#: K12's launch cases: poses (the last the merge's coarse call) and beams
#: (past 128 x 8 = 1,024 the block takes chunks); the grids at both
#: overlaps, and one whose cell (0.3 m) is no power of two, so that its
#: quotients round.
K12_POSES = (1, 63, 64, 4624)
K12_BEAMS = (1, 127, 128, 129, 360, 1100)
K12_GRIDS = {"g4": GRID, "g1": GRID1,
             "g4 0.3 m": dataclasses.replace(GRID, cell=0.3, nx=80, ny=80)}


@pytest.mark.parametrize("grid", list(K12_GRIDS))
@pytest.mark.parametrize("n", K12_BEAMS)
def test_ndt_sgh_unpacked_one_beam_per_thread(dev, grid, n, monkeypatch):
    """K12 at 1, 63, 64 and 4,624 poses of a scan of ``n`` beams, the first
    pose throwing most beams off the map: within rtol 1e-5 of each output's
    max of its f32 plain version (``chip_smoke.check_k12``'s tolerance),
    bit-identical on a second launch, one launch a call, and bit-equal at
    every R = 1..8 (``kernels.sgh_spread`` held): the sums' order does not
    depend on the launch shape."""
    import chip_smoke as cs
    from ndtpu_torch.config import MatchConfig

    grid = K12_GRIDS[grid]
    pts0, mask0 = _points(0, 40000, dev)
    ndt_map = tgrid.finalize(tgrid.halfcell_add_ref(
        tgrid.empty_stats(grid, torch.float32, dev), pts0, mask0, 1.0, grid),
        NDT)
    pts, mask = _points(11, n, dev)
    rng = np.random.default_rng(12)
    b = max(K12_POSES)
    poses = np.stack([rng.uniform(-2, 2, b), rng.uniform(-2, 2, b),
                      rng.uniform(-np.pi, np.pi, b)], -1)
    poses[0] = (20.0, 5.0, 0.3)          # most beams past x = 12 m
    poses = torch.as_tensor(poses, dtype=torch.float32, device=dev)
    cfg = MatchConfig()
    name = kernels.variant("ndt_sgh_unpacked", grid.overlap)
    run = lambda p: tmatch.score_grad_hess_batch(p, pts, mask, ndt_map,
                                                 grid, cfg)
    for b in K12_POSES:
        p = poses[:b].contiguous()
        kernels.reset_launches()
        out, again = run(p), run(p)
        ref = tmatch.score_grad_hess_batch_ref(p, pts, mask, ndt_map, grid,
                                               cfg)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES[name] == 2
        assert cs.bits_equal(out, again)
        cs._rel_check(f"K12 B={b} N={n}", out, ref)
        if b in (64, 4624):
            for r in range(1, kernels.LM_MAX_SPREAD + 1):
                monkeypatch.setattr(kernels, "sgh_spread",
                                    lambda *a, r=r: r)
                assert cs.bits_equal(run(p), out), f"R = {r}"
            monkeypatch.undo()


def test_schur_local_assemble_past_2_31_floats(dev):
    """K9c on a rank whose ``h_ii`` stream passes 2^31 floats: a
    32,000-pose Manhattan world (loop_prob 0.02) over two ranks gives ni =
    15,982 interior poses a rank, ``h_ii`` 9 ni^2 = 2.30e9 floats (9.2 GB).
    Rank 0's parts equal ``schur_local_assemble_model`` on the card bit for
    bit, the held entries and the zeros, down to the stream's far end (the
    last interior row's damped diagonal block), in one launch."""
    from ndtpu_torch.data import g2o
    from ndtpu_torch.dist import schur as tschur

    n = 32_000
    g = g2o.to_graph(g2o.manhattan_world(n, seed=1, loop_prob=0.02),
                     torch.float32, device=dev)
    plan = tschur.plan_partition(
        g.bet_i.cpu().numpy(), g.bet_j.cpu().numpy(),
        g.bet_mask.cpu().numpy(), g.prior_idx.cpu().numpy(),
        g.prior_mask.cpu().numpy(), n, 2)
    assert 9 * plan.ni ** 2 >= 2 ** 31
    t = tschur.rank_tables(plan, 0, dev)
    loc = tuple(x[0] for x in tschur.shard_factor_data_local(g, plan, 0))
    lin = tschur._linearize_shard(g.poses, *loc)
    kernels.reset_launches()
    out = tschur.schur_local_assemble(t, 1e-3, *lin, loc[4], loc[8])
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["schur_local_assemble"] == 1
    far = out[0][-3:, -3:].clone()
    assert int(torch.count_nonzero(torch.diagonal(far))) == 3
    model = tschur.schur_local_assemble_model(plan, 0, 1e-3, *lin)
    assert torch.equal(far.view(torch.int32),
                       model[0][-3:, -3:].view(torch.int32))
    for a, b in zip(out, model):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


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


@pytest.mark.parametrize("x_lo,width", [(0, 24), (-5, 34)])
def test_slab_accumulate_overlap1_matches_model_and_plain(dev, x_lo, width):
    """K10a at overlap 1 (``slab_accumulate[g1]``) under the rules of the
    overlap-4 test above (``chip_smoke.check_k10a``)."""
    import chip_smoke as cs

    pts, mask = _points(5, 30000, dev)
    kernels.reset_launches()
    cs.check_k10a("test g1", pts, mask, GRID1, x_lo, width, jobs=[])
    assert kernels.LAUNCHES[kernels.variant("slab_accumulate", 1)] >= 3
    assert kernels.LAUNCHES["slab_accumulate"] == 0


def test_slab_accumulate_scratch_per_grid_count(dev):
    """K10a's per-call work buffer and tile plan follow the grid count: a G
    = 1 call and then a G = 4 call of the same slab shape give the G = 4
    result bit for bit (its fixed-point model; buffers sized for one grid
    would be written past their end)."""
    from ndtpu_torch.dist import gridmap

    pts, mask = _points(6, 30000, dev)
    for grid in (GRID1, GRID, GRID1):
        out = gridmap.slab_accumulate(pts, mask, grid, -3, 30)
        torch.cuda.synchronize()
        model = gridmap.slab_accumulate_fixed_ref(pts, mask, grid, -3, 30)
        for a, b in zip(out, model):
            assert a.shape[0] == grid.overlap
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))


#: A grid past one tile in both x and y (``kernels.slab_tiles``: 5 bands of
#: 16 rows, strips of 16 columns: 7 across the owned width of 100, 4
#: across the halo slab of 64).
GRID_TILED = GridConfig(x0=-20.0, y0=-20.0, cell=0.5, nx=100, ny=80,
                        overlap=4)


def _slab_cases(dev):
    """K10a's edge inputs on :data:`GRID_TILED`: seeded points over the
    whole map, every one in one cell, every one masked out, and none."""
    pts, mask = _points(8, 30000, dev)
    pts = pts * 1.6
    one = torch.full((5000, 2), 3.3, device=dev)
    return {"spread": (pts, mask),
            "one cell": (one, torch.ones(5000, dtype=torch.bool, device=dev)),
            "all masked out": (pts, torch.zeros_like(mask)),
            "no points": (pts[:0], mask[:0])}


@pytest.mark.parametrize("overlap", [4, 1])
@pytest.mark.parametrize("case", ["spread", "one cell", "all masked out",
                                  "no points"])
def test_slab_accumulate_tiles_edge_cases(dev, overlap, case):
    """K10a on a slab cut into tiles in x and y (``kernels.slab_tiles``),
    owned columns and a halo past the map's low edge, on its edge inputs:
    bit for bit its fixed-point model."""
    from ndtpu_torch.dist import gridmap

    grid = dataclasses.replace(GRID_TILED, overlap=overlap)
    pts, mask = _slab_cases(dev)[case]
    for x_lo, width in ((0, 100), (-7, 64)):
        tp = kernels.slab_tiles(overlap, width, grid.ny)
        assert tp.nxt > 1 and tp.nyt > 1
        out = gridmap.slab_accumulate(pts, mask, grid, x_lo, width)
        model = gridmap.slab_accumulate_fixed_ref(pts, mask, grid, x_lo,
                                                  width)
        torch.cuda.synchronize()
        for a, b in zip(out, model):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))
        if case == "one cell":
            assert int(out[0].sum()) == 5000 * overlap


#: A G = 4 map of 2,048 x 1,024 cells: its whole-width slab has 32,768
#: tiles, past the ``kernels.SLAB_MAX_TILES`` whose counters K10a's bin
#: blocks keep in shared memory.
GRID_WIDE = GridConfig(x0=-51.2, y0=-25.6, cell=0.05, nx=2048, ny=1024,
                       overlap=4)


def test_cell_ids_on_the_card_equal_the_cpu(dev):
    """``ndt.grid.cell_ids`` bins seeded points at 0.05 m (not a power of
    two) on the card as on the CPU, in f32 and f64, at both overlaps."""
    rng = np.random.default_rng(16)
    p = rng.uniform((-52.0, -26.0), (52.0, 26.0), (400_000, 2))
    for overlap in (4, 1):
        grid = dataclasses.replace(GRID_WIDE, overlap=overlap)
        for dt in (torch.float32, torch.float64):
            pts = torch.as_tensor(p, dtype=dt)
            ids, inb = tgrid.cell_ids(pts, grid)
            ids_c, inb_c = tgrid.cell_ids(pts.to(dev), grid)
            assert torch.equal(ids_c.cpu(), ids)
            assert torch.equal(inb_c.cpu(), inb)


def test_slab_accumulate_past_shared_counters(dev):
    """K10a on a slab of more tiles than its bin blocks' shared memory
    counts (they count in the work buffer instead), at both overlaps: bit
    for bit its fixed-point model, with the points permuted too. The model
    runs on the card, at a cell (0.05 m) that is not a power of two:
    ``ndt.grid.cell_ids`` divides by a tensor of the cell, so the card's
    plain binning is the kernel's (and the CPU's) IEEE division."""
    from ndtpu_torch.dist import gridmap

    rng = np.random.default_rng(21)
    n = 300_000
    centers = rng.uniform((-50, -25), (50, 25), (400, 2))
    p = centers[rng.integers(0, 400, n)] + rng.normal(0, 0.3, (n, 2))
    p = np.round(p * 65536.0) / 65536.0
    pts = torch.as_tensor(p, dtype=torch.float32, device=dev)
    mask = torch.as_tensor(rng.random(n) > 0.05, device=dev)
    perm = torch.as_tensor(rng.permutation(n), device=dev)
    for overlap in (4, 1):
        grid = dataclasses.replace(GRID_WIDE, overlap=overlap)
        for x_lo, width in ((0, 2048), (-3, 2000)):
            tp = kernels.slab_tiles(overlap, width, grid.ny)
            assert tp.tiles > kernels.SLAB_MAX_TILES or overlap == 1
            model = gridmap.slab_accumulate_fixed_ref(pts, mask, grid,
                                                      x_lo, width)
            for q, k in ((pts, mask), (pts[perm], mask[perm])):
                out = gridmap.slab_accumulate(q, k, grid, x_lo, width)
                for a, b in zip(out, model):
                    assert torch.equal(a.view(torch.int32),
                                       b.view(torch.int32))
            assert int(model[0].sum()) > 0.8 * overlap * n


def test_slab_accumulate_many_points(dev):
    """K10a on 60 M points, more bin blocks than the sum's shared memory
    holds the segment offsets of (it reads them from the work buffer),
    ~100 k of them masked in: bit for bit its fixed-point model of the
    masked points alone, at both overlaps."""
    from ndtpu_torch.dist import gridmap

    m = 60_000_000
    blocks = -(-m // kernels.SLAB_BIN_CHUNK)
    assert 48 * kernels.SLAB_TILE_CELLS + 4 * (2 * blocks + 1) \
        > kernels.SMEM_MAX
    gen = torch.Generator(device=dev).manual_seed(22)
    pts = torch.rand((m, 2), generator=gen, device=dev) * 26.0 - 13.0
    pts = torch.round(pts * 65536.0) / 65536.0
    mask = torch.rand(m, generator=gen, device=dev) < 100_000 / m
    for grid in (GRID, GRID1):
        for x_lo, width in ((0, 48), (-5, 34)):
            out = gridmap.slab_accumulate(pts, mask, grid, x_lo, width)
            model = gridmap.slab_accumulate_fixed_ref(
                pts[mask], mask[mask], grid, x_lo, width)
            torch.cuda.synchronize()
            for a, b in zip(out, model):
                assert torch.equal(a.view(torch.int32), b.view(torch.int32))
            assert int(model[0].sum()) > 10_000 * grid.overlap


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


def _k10b_stats(dev, lead, seed=0):
    """Seeded statistics of ``lead`` cells: 0-11 points a cell about a
    mean in [-20, 20]^2 with a random covariance (some thin, some
    degenerate), three contiguous f32 arrays on ``dev``."""
    rng = np.random.default_rng(seed)
    c = int(np.prod(lead))
    n = rng.integers(0, 12, c).astype(np.float64)
    mu = rng.uniform(-20, 20, (c, 2))
    a = rng.normal(0, 0.3, (c, 2, 2))
    a[::7, 1] = 0.0                      # rank one: the eigen floor
    cov = a @ a.transpose(0, 2, 1)
    s = n[:, None] * mu
    ss = n[:, None, None] * (cov + mu[:, :, None] * mu[:, None, :])
    f = lambda x, tail: torch.as_tensor(x.reshape(lead + tail),
                                        dtype=torch.float32, device=dev)
    return tgrid.NDTStats(f(n, ()), f(s, (2,)), f(ss, (2, 2)))


@pytest.mark.parametrize("overlap", [4, 1])
@pytest.mark.parametrize("cells", [1, 4 * 1000 + 3, 131_072])
def test_finalize_cells_records_match_arrays(dev, overlap, cells):
    """K10b on the slab exchange's records (read in place) is bit-equal to
    its launch on the same cells as three arrays, and within
    ``chip_smoke.check_k10b``'s gate of the f32 plain version, at ``cells``
    cells a grid (a record run not a multiple of 4 cells, and the slab's
    4 x 128 x 256 at overlap 4), at 32 to 512 threads a block
    (``kernels.finalize_cells_threads``)."""
    import chip_smoke as cs

    st = _k10b_stats(dev, (overlap, cells), seed=cells + overlap)
    rec = cs.k10b_records(st)
    assert kernels.finalize_inputs(*rec)[0] == "records"
    assert kernels.finalize_inputs(*st)[0] == "arrays"
    kernels.reset_launches()
    want = tgrid.finalize(st, NDT)
    got = tgrid.finalize(rec, NDT)
    assert kernels.LAUNCHES["finalize_cells"] == 2
    assert cs.bits_equal(got, want)
    ref = tgrid.finalize_ref(st, NDT)
    assert torch.equal(want.valid, ref.valid)
    assert 0 < int(want.valid.sum()) < want.valid.numel() or cells == 1
    cs._rel_check("K10b records vs f32 plain", got, ref)
    try:
        for threads in (32, 64, 128, 512):
            kernels.finalize_cells_threads(threads)
            for stats in (rec, st):
                assert cs.bits_equal(tgrid.finalize(stats, NDT),
                                     want), threads
    finally:
        kernels.finalize_cells_threads()


def test_finalize_slab_reads_the_exchanged_records(dev):
    """On one rank (no halo, no collective) ``build_slab_stats_psharded``
    hands ``finalize_slab`` the exchange's records: K10b reads them in
    place, one launch, the same bits as on copies of them as three
    arrays; and ``convert.to_numpy`` of the views is their values."""
    from ndtpu_torch import convert
    from ndtpu_torch.dist import gridmap
    from ndtpu_torch.dist import mesh as tmesh

    pts, mask = _points(5, 20000, dev)
    mesh = tmesh.RankMesh(0, 1, dev, ("space",))
    ps = gridmap.build_slab_stats_psharded(mesh, pts, mask, GRID, halo=0)
    assert kernels.finalize_inputs(*ps)[0] == "records"
    kernels.reset_launches()
    m = gridmap.finalize_slab(ps, NDT)
    assert kernels.LAUNCHES["finalize_cells"] == 1
    copies = gridmap.SlabStats(*(x.contiguous() for x in ps))
    for a, b in zip(m, gridmap.finalize_slab(copies, NDT)):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    for a, b in zip(convert.to_numpy(ps), copies):
        np.testing.assert_array_equal(a, b.cpu().numpy())
    assert int(m.valid.sum()) > 100


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


def test_slab_sgh_overlap1_matches_plain(dev):
    """K10c at overlap 1 (``slab_sgh[g1]``) on each half of a seeded
    one-grid map against its f32 plain version (``chip_smoke.check_k10c``)
    at B = 1 and B = 64; the halves' sums add up to K12[g1]'s terms on the
    whole map (within 1e-4 of each output's max)."""
    import chip_smoke as cs
    from ndtpu_torch.config import MatchConfig
    from ndtpu_torch.dist import gridmap

    ndt_map = tgrid.finalize(_stats1(dev), NDT)
    smap = gridmap.dense_to_slab(ndt_map, GRID1)
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
            cs.check_k10c(f"test g1 half {r}", poses[:b], pts, mask,
                          halves[r], GRID1, 24 * r, MatchConfig(), jobs=[])
    assert kernels.LAUNCHES[kernels.variant("slab_sgh", 1)] >= 8
    cfg = MatchConfig()
    total = sum(gridmap.slab_sgh(poses, pts, mask, halves[r], GRID1, 24 * r,
                                 cfg) for r in range(2))
    f, g, h, _ = tmatch.score_grad_hess_batch(poses, pts, mask, ndt_map,
                                              GRID1, cfg)
    for got, ref in ((total[:, 0], f), (total[:, 3:6], g),
                     (total[:, 6:], h.reshape(-1, 9))):
        assert float((got - ref).abs().max()) <= 1e-4 * max(
            float(ref.abs().max()), 1.0)


@pytest.mark.parametrize("grid", [GRID, GRID1], ids=["g4", "g1"])
@pytest.mark.parametrize("n", [360, 4000])
def test_slab_sgh_one_beam_per_thread_matches_plain(dev, grid, n):
    """K10c at config 5's N = 360 (R = 3) and past the R cap (4,000 beams:
    chunks of 1,024), at both overlaps, on each half of a seeded map and at
    B = 1 and B = 64: within rtol 1e-5 of its f32 plain version and
    bit-identical on a second launch (``chip_smoke.check_k10c``)."""
    import chip_smoke as cs
    from ndtpu_torch.config import MatchConfig
    from ndtpu_torch.dist import gridmap

    stats = _stats(dev) if grid.overlap == 4 else _stats1(dev)
    smap = gridmap.dense_to_slab(tgrid.finalize(stats, NDT), grid)
    halves = [gridmap.SlabMap(*(x[:, 24 * r:24 * r + 24].contiguous()
                                for x in smap)) for r in range(2)]
    pts, mask = _points(5, n, dev)
    rng = np.random.default_rng(7)
    poses = torch.as_tensor(np.stack([rng.uniform(-1, 1, 64),
                                      rng.uniform(-1, 1, 64),
                                      rng.uniform(-0.5, 0.5, 64)], -1),
                            dtype=torch.float32, device=dev)
    kernels.reset_launches()
    for r in range(2):
        for b in (1, 64):
            cs.check_k10c(f"test N={n} half {r}", poses[:b], pts, mask,
                          halves[r], grid, 24 * r, MatchConfig(), jobs=[])
    assert kernels.LAUNCHES[kernels.variant("slab_sgh", grid.overlap)] >= 8
    assert kernels.slab_spread(n) == (3 if n == 360 else 8)


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


# -- The other table layouts (overlap 1, compact rows, both) ------------------

LAYOUT_IDS = ["g1l8", "g4l4", "g1l4"]


@pytest.fixture(scope="module")
def layout_inputs():
    """Config 2 and 3, box-world draw 0, its config-2 map and the published
    layout's keyframe store (as ``chip_smoke.main`` builds them)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    import chip_smoke as cs
    from ndtpu_torch.config import PipelineConfig

    dev = torch.device("cuda")
    cfg2 = PipelineConfig.from_json(str(cs.CONFIG2))
    cfg3 = PipelineConfig.from_json(str(cs.CONFIG3))
    seq = cs.box_sequence(0, cfg2.n_beams)
    return dict(cfg2=cfg2, cfg3=cfg3, seq=seq, dev=dev,
                stats=cs.map_stats(seq, cfg2.grid, dev))


def test_layout_halfcell_add_overlap1(layout_inputs):
    """K3 at overlap 1 against the f64 twin (+1 and +-1 weights), bit-equal
    to its fixed-point model, on a second launch and under permutation, at
    the window and rebuild shapes (chip_smoke.check_k3 /
    check_k3_rebuild)."""
    import chip_smoke as cs

    li = layout_inputs
    c2 = cs.layout_cfg(li["cfg2"], 1, 8)
    c3 = cs.layout_cfg(li["cfg3"], 1, 8)
    row = cs.check_k3(c2, li["seq"], cs.map_stats(li["seq"], c2.grid,
                                                  li["dev"]),
                      0, li["dev"], c2.window)
    assert row["tol_units"] <= 1.0
    kf = cs.box_store(li["cfg3"], li["seq"], li["dev"])
    cs.check_k3_rebuild(c3, kf, li["dev"])


@pytest.mark.parametrize("layout", kernels.LAYOUTS[1:], ids=LAYOUT_IDS)
def test_layout_finalize_pack(layout_inputs, layout):
    """K4 in the layout against its plain version on the same f32
    statistics (compact bf16-pair lanes bit-equal as int32), bit-identical
    on a second launch, at the config-2 and config-3 maps."""
    import chip_smoke as cs

    li = layout_inputs
    for cfg in (li["cfg2"], li["cfg3"]):
        c = cs.layout_cfg(cfg, *layout)
        row = cs.check_k4("layout", c.ndt, c.grid,
                          cs.map_stats(li["seq"], c.grid, li["dev"]),
                          compact=layout[1] == 4)
        assert row["max_abs_err"] >= 0.0


@pytest.mark.parametrize("layout", kernels.LAYOUTS[1:], ids=LAYOUT_IDS)
def test_layout_local_tables(layout_inputs, layout):
    """K8a in the layout: bit-identical on a second launch, under
    permutation and to K4 of K3; against its twin on the card and in f64
    (chip_smoke.check_k8a)."""
    import chip_smoke as cs

    li = layout_inputs
    c3 = cs.layout_cfg(li["cfg3"], *layout)
    cs.check_k8a(c3, li["seq"], 0, li["dev"], c3.window)


@pytest.mark.parametrize("layout", kernels.LAYOUTS[1:], ids=LAYOUT_IDS)
def test_layout_ndt_terms_and_lm_ndt(layout_inputs, layout):
    """K1 and ``lm_ndt`` in the layout at the config-2 window shape, against
    their f32 twins (and ``lm_ndt`` against the composite route;
    chip_smoke.check_k1 / check_lm)."""
    import chip_smoke as cs

    li = layout_inputs
    c2 = cs.layout_cfg(li["cfg2"], *layout)
    stats = (cs.map_stats(li["seq"], c2.grid, li["dev"])
             if layout[0] == 1 else li["stats"])
    table = tgrid.finalize_pack(stats, c2.ndt, c2.grid, layout[1] == 4)
    cs.check_k1(c2, li["seq"], table, 0, li["dev"], c2.window)
    kernels.reset_launches()
    row, (eq, b) = cs.check_lm(
        "window", cs.lm_window_args(c2, li["seq"], table, 0, li["dev"],
                                    c2.window), c2.match)
    assert kernels.LAUNCHES[kernels.variant("lm_ndt", *layout)] >= 1
    assert eq >= b - 1 and row["max_abs_err"] <= 1e-3


@pytest.mark.parametrize("layout", kernels.LAYOUTS[1:], ids=LAYOUT_IDS)
def test_layout_grouped_and_gated_verify(layout_inputs, layout):
    """K1 grouped, ``lm_ndt`` grouped and the gated verify in the layout at
    the config-3 verify shape over a 1,024-slot cache of that layout: the
    gated launch bit-equal to ``lm_ndt_grouped`` + the standalone K8b
    (chip_smoke.check_k1_grouped / check_lm /
    check_gated_verify)."""
    import chip_smoke as cs

    li = layout_inputs
    c3 = cs.layout_cfg(li["cfg3"], *layout)
    kf = cs.box_store(c3, li["seq"], li["dev"])
    k = c3.loop.max_detect_per_window * c3.loop.max_candidates
    cs.check_k1_grouped(c3, li["seq"], kf, 0, li["dev"], k)
    row, (eq, b) = cs.check_lm(
        "verify", cs.lm_verify_args(c3, li["seq"], kf, 0, li["dev"], k),
        c3.match)
    assert eq >= 0.95 * b
    cs.check_gated_verify(c3, li["seq"], kf, 0, li["dev"],
                          c3.loop.max_candidates)


@pytest.mark.parametrize("layout", kernels.LAYOUTS,
                         ids=["g4l8"] + LAYOUT_IDS)
def test_lm_ndt_sums_bit_equal_to_k1(layout_inputs, layout):
    """lm_ndt (one beam per thread) in the layout, shared, grouped and
    gated, at 360, 720 and 1,100 beams (the last in chunks past 1,024): H
    and score at its output poses bit-equal to d2 x K1's sums there, and
    every output bit-identical on a relaunch and at R = 1 (see
    chip_smoke.check_lm_sums)."""
    import chip_smoke as cs

    li = layout_inputs
    spreads = cs.check_lm_sums(li["cfg2"], li["cfg3"], 0, li["dev"],
                               layouts=[layout])
    assert len(spreads) == 3
    assert max(r["shared"] for r in spreads.values()) == 8


def test_lm_ndt_at_the_headline_shape(dev):
    """lm_ndt at bench.py's headline shape (4,096 lanes x 720 beams): H
    bit-equal to K1's sums, a relaunch bit-identical, and against its f32
    twin on 64 lanes (see chip_smoke.check_lm_headline)."""
    import chip_smoke as cs

    row = cs.check_lm_headline(0, dev)
    assert row["batch"] == 4096 and row["converged"] > 0


def test_raycast_matches_plain(dev):
    """K11 in f64 (hits identical, within 1e-9 m) and f32 against its plain
    version, at the CLI's corridor and serving's box-world poses
    (``chip_smoke.check_k11``)."""
    import chip_smoke as cs

    row = cs.check_k11(dev)
    assert row["max_abs_err"] <= cs.K11_F64_TOL
    assert kernels.LAUNCHES["raycast"] > 0


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_raycast_past_the_old_segment_limit(dev, dtype):
    """K11 at 4,004 segments (``chip_smoke.K11_MANY``'s pillars; the first
    design held at most 1,536 in f64 in 48 KB): f64 hits identical and
    within K11_F64_TOL of the plain version, f32 within K11_F32_TOL but for
    K11_F32_OUTLIERS of the beams; bit-identical on a second launch."""
    import chip_smoke as cs
    from ndtpu_torch.data import synth

    dt = getattr(torch, dtype)
    world, poses, ang = cs.k11_inputs("pillars", dt, dev)
    assert world.segments.shape[0] > 4000
    kernels.reset_launches()
    out = synth.raycast(world, poses, ang, 20.0)
    again = synth.raycast(world, poses, ang, 20.0)
    ref = cs.raycast_cpu(world, poses, ang, 20.0)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["raycast"] == 2
    assert torch.equal(out, again)
    d = (out.cpu() - ref).abs()
    if dt == torch.float64:
        assert torch.equal(out.cpu() < 20.0, ref < 20.0)
        assert float(d.max()) <= cs.K11_F64_TOL
    else:
        assert int((d > cs.K11_F32_TOL).sum()) <= (cs.K11_F32_OUTLIERS
                                                   * d.numel())


def test_voxel_downsample_matches_plain(dev):
    """K13 bit-equal to its plain version on the CLI's 600 x 360 scans at
    three voxel sizes (``chip_smoke.check_k13``)."""
    import chip_smoke as cs

    row = cs.check_k13(dev)
    assert row["kept"]["0.5"] < row["kept"]["0.05"]


#: K13's cases: points per scan (19,370 the last the table route takes at
#: one scan a block, 58,112 the most the scan route takes) and scans.
VOXEL_CASES = {1: 9, 255: 9, 256: 9, 257: 9, 360: 600, 4096: 17,
               19370: 3, 19371: 3, 58112: 1}


@pytest.mark.parametrize("voxel", [0.001, 0.1, 5.0])
@pytest.mark.parametrize("n", list(VOXEL_CASES))
def test_voxel_downsample_routes_match_plain(dev, n, voxel):
    """K13 on ``VOXEL_CASES[n]`` seeded scans of ``n`` points (+-15 m, 10%
    masked out) at 0.001 m (nearly all ids distinct), 0.1 m and 5 m (heavy
    duplicates), on the route ``kernels.voxel_route`` gives (the table up to
    19,370 points, comparisons past it), bit-equal to
    ``voxel_downsample_ref`` built on the CPU, one launch a call counted
    under the route's name; a scan with every point invalid keeps none."""
    from ndtpu_torch.data import preprocess

    t = VOXEL_CASES[n]
    rng = np.random.default_rng(n)
    pts = rng.uniform(-15.0, 15.0, (t, n, 2)).astype(np.float32)
    mask = rng.random((t, n)) > 0.1
    mask[0] = False
    p = torch.as_tensor(pts, device=dev)
    m = torch.as_tensor(mask, device=dev)
    route = kernels.voxel_route(n)
    assert route == ("table" if n <= 19370 else "scan")
    name = "voxel_downsample" + ("" if route == "table" else "[scan]")
    kernels.reset_launches()
    out = preprocess.voxel_downsample(p, m, voxel)
    ref = preprocess.voxel_downsample_ref(p.cpu(), m.cpu(), voxel)
    assert kernels.LAUNCHES[name] == 1
    assert torch.equal(out.cpu(), ref)
    assert not bool(out[0].any())
    if voxel == 0.001:
        assert int(out.sum()) >= 0.999 * int(m.sum())


def test_make_sequence_on_the_card_equals_the_cpu(dev):
    """A box-world draw simulated on the card (K11 in f64) against the
    CPU-made one: equal, or at most 10 elements one f32 ulp apart."""
    import chip_smoke as cs

    kernels.reset_launches()
    card = cs.box_sequence(0, 360, device=dev)
    assert kernels.LAUNCHES["raycast"] == 1
    assert cs.card_vs_cpu("box draw 0", card, cs.box_sequence(0, 360)) <= 10


def test_scan_cli_on_the_card(dev):
    """``run --mode scan`` on config 3 (120 scans): one lm_ndt and one K4
    per scan, one K8a and one gated verify per keyframe, no plain version
    on CUDA tensors (``chip_smoke.run_scan_cli``)."""
    import chip_smoke as cs

    launches, out = cs.run_scan_cli(dev, cs.CONFIG3, 120)
    assert launches["lm_ndt"] == 119 and out["keyframes"] > 1


def test_scan_step_syncs_the_host_once_per_scan(dev):
    """``slam_step`` on the card: one host sync per scan (the keyframe
    test), at most two on a keyframe besides the smoother's
    (``chip_smoke.check_scan_syncs``)."""
    import chip_smoke as cs

    row = cs.check_scan_syncs(dev, n_scans=120)
    assert row["keyframes"] > 0


def test_input_kernels_refuse_cpu_tensors():
    poses = torch.zeros(2, 3, dtype=torch.float64)
    ang = torch.zeros(4, dtype=torch.float64)
    seg = torch.zeros(3, 2, 2, dtype=torch.float64)
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        kernels.raycast(poses, ang, seg, 20.0, 1e-9)
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        kernels.voxel_downsample(torch.zeros(2, 4, 2),
                                 torch.ones(2, 4, dtype=torch.bool), 0.1)


#: K14's cases (``chip_smoke.K14_CASES``' labels).
K14_LABELS = ("config2", "config3", "serving", "overflow")


@pytest.mark.parametrize("label", K14_LABELS)
def test_window_append_matches_plain(dev, label):
    """K14 against ``window_append_ref`` on the same f32 card inputs at
    configs 2 and 3, serving and full capacities: indices, masks, counters
    and copied rows bit-equal, the computed values within
    ``chip_smoke.K14_RTOL``; one launch a call; its loop entry likewise
    where the case has loop lanes (bit-equal)."""
    import chip_smoke as cs
    from ndtpu_torch.slam import appends

    i = K14_LABELS.index(label)
    _, s, cap, lanes, full = cs.K14_CASES[i]
    args = cs.k14_inputs(i, dev, s, cap, full)
    kernels.reset_launches()
    out = appends.window_append(*args)
    assert kernels.LAUNCHES["window_append"] == 1
    ref = appends.window_append_ref(*args)
    cs.k14_compare(label, out, ref, cs.K14_OUTS, cs.K14_COMPUTED)
    if full:
        assert int(out[25].sum()) > 0
    if lanes:
        largs = cs.k14_loop_inputs(i, out, lanes)
        lout = appends.loop_append(*largs, 8)
        assert kernels.LAUNCHES["window_append[loops]"] == 1
        cs.k14_compare(label, lout, appends.loop_append_ref(*largs, 8),
                       cs.K14_LOOP_OUTS)
        if full:
            assert int(lout[7].sum()) > 0


def test_window_append_single_scan_and_no_keyframe(dev):
    """K14 at W = 1 and W = 32 (its longest window), with no keyframe and
    with every scan one: bit-equal to the plain version on the integers and
    masks, the values within the tolerance."""
    import chip_smoke as cs
    from ndtpu_torch.slam import appends

    for w in (1, 32):
        for flag in (False, True):
            args = list(cs.k14_inputs(w, dev, 2, 64, False, n_beams=40,
                                      w=w))
            args[-1] = torch.full_like(args[-1], flag)
            out = appends.window_append(*args)
            ref = appends.window_append_ref(*args)
            cs.k14_compare(f"W={w}", out, ref, cs.K14_OUTS,
                           cs.K14_COMPUTED)
            assert int(out[16].sum()) == (2 * w if flag else 0)


def test_window_append_refuses_past_its_window(dev):
    import chip_smoke as cs

    args = cs.k14_inputs(0, dev, 1, 64, False, n_beams=8, w=33)
    with pytest.raises(ValueError, match="window of 33"):
        kernels.window_append(*args)


def test_rows_set_last_write_wins_and_drops_outside(dev):
    """K14's row entry: a repeated row takes the last kept write, an index
    outside the rows and a masked one write nothing."""
    rng = np.random.default_rng(0)
    dst = torch.as_tensor(rng.normal(0, 1, (2, 10, 3)), dtype=torch.float32,
                          device=dev)
    idx = torch.tensor([[3, 3, 11, -1, 5], [0, 9, 9, 2, 2]], device=dev)
    ok = torch.tensor([[True, True, True, True, False],
                       [True, True, False, False, True]], device=dev)
    src = torch.as_tensor(rng.normal(0, 1, (2, 5, 3)), dtype=torch.float32,
                          device=dev)
    out = kernels.rows_set(dst, idx, ok, src).cpu()
    ref = dst.cpu().clone()
    for s in range(2):
        for m in range(5):
            if ok[s, m] and 0 <= int(idx[s, m]) < 10:
                ref[s, int(idx[s, m])] = src[s, m].cpu()
    assert torch.equal(out, ref)


def test_rows_set_past_one_block_and_many_indices(dev):
    """K14's row entry over rows that span several blocks (1,000 rows of 3,
    341 a block) and 8,000 indices a session (repeats, out of range,
    masked): each row the last kept write that names it, as a numpy model,
    and bit-equal on a second launch."""
    rng = np.random.default_rng(1)
    s, r, c, m = 3, 1000, 3, 8000
    dst = rng.normal(0, 1, (s, r, c)).astype(np.float32)
    idx = rng.integers(-20, r + 20, (s, m))
    ok = rng.random((s, m)) < 0.3
    src = rng.normal(0, 1, (s, m, c)).astype(np.float32)
    t = lambda a: torch.as_tensor(a, device=dev)
    out = kernels.rows_set(t(dst), t(idx), t(ok), t(src))
    again = kernels.rows_set(t(dst), t(idx), t(ok), t(src))
    ref = dst.copy()
    for i in range(s):
        for q in range(m):
            if ok[i, q] and 0 <= idx[i, q] < r:
                ref[i, idx[i, q]] = src[i, q]
    assert np.array_equal(out.cpu().numpy().view(np.int32),
                          ref.view(np.int32))
    assert torch.equal(out.view(torch.int32), again.view(torch.int32))


def test_window_append_at_capacity_with_32_scans(dev):
    """K14 at its longest window (W = 32) on full capacities: the appended
    ranges of the graph, the factors and the keyframe store run into their
    capacities (slots dropped), and the loop entry's 16 x 128 lanes (past
    one ballot round of its block, and past the factor capacity) likewise:
    bit-equal to the plain version on the integers, masks and copies, the
    values within ``chip_smoke.K14_RTOL``."""
    import chip_smoke as cs
    from ndtpu_torch.slam import appends

    args = cs.k14_inputs(11, dev, 2, 1024, True, w=32)
    out = appends.window_append(*args)
    cs.k14_compare("W=32 full", out, appends.window_append_ref(*args),
                   cs.K14_OUTS, cs.K14_COMPUTED)
    assert int(out[25].sum()) > 0
    assert bool((out[7] == 1024).all())
    largs = cs.k14_loop_inputs(11, out, (16, 128), w=32)
    lout = appends.loop_append(*largs, 32)
    cs.k14_compare("loops 16 x 128", lout,
                   appends.loop_append_ref(*largs, 32), cs.K14_LOOP_OUTS)
    assert int(lout[7].sum()) > 0
    assert bool((lout[5] == 2048).all())


def test_windowed_run_launches_k14_once_a_window(dev):
    """``run_slam_windowed`` at config 3's shapes on a short box-world draw:
    one K14 append and one loop-entry launch a window, no plain version on
    CUDA tensors, and at most ``chip_smoke.WINDOW_SYNC_BUDGET`` host syncs
    a window outside the loop verify."""
    import chip_smoke as cs
    from ndtpu_torch.config import PipelineConfig
    from ndtpu_torch.slam import pipeline

    cfg = PipelineConfig.from_json(str(cs.CONFIG3))
    seq = cs.box_sequence(0, cfg.n_beams, device=dev, n_scans=121)
    kernels.reset_launches()
    with cs.no_plain_on_card(cs.PLAIN_SERVING):
        _, outs = pipeline.run_slam_windowed(seq.points, seq.mask, seq.odom,
                                             cfg)
    assert kernels.LAUNCHES["window_append"] == 15
    assert kernels.LAUNCHES["window_append[loops]"] == 15
    row = cs.check_window_syncs(dev, cs.CONFIG3)
    assert row["outside_max"] <= cs.WINDOW_SYNC_BUDGET


K15_LABELS = ("config3", "serving", "ties", "full")


@pytest.mark.parametrize("label", K15_LABELS)
def test_loop_lanes_bit_equal_to_plain(dev, label):
    """K15 against ``closure.loop_lanes_ref`` on the same f32 card inputs at
    ``chip_smoke.K15_CASES`` (config 3's and serving's shapes, equal
    distances, a full store): every output bit-equal, one launch a call;
    with the candidates given, the same lanes; the search alone, the same
    candidates."""
    import chip_smoke as cs

    i = K15_LABELS.index(label)
    args = cs.k15_inputs(i, dev, *cs.K15_CASES[i][1:])
    kernels.reset_launches()
    out = kernels.loop_lanes(*args)
    assert kernels.LAUNCHES["loop_lanes"] == 1
    ref = closure.loop_lanes_ref(*args)
    for name, a, b in zip(cs.K15_OUTS, out, ref):
        assert cs.bits_equal(a, b), name
    given = kernels.loop_lanes(*args, cand_idx=out[0], cand_mask=out[1])
    assert given[2] is None and cs.bits_equal(given[3:], out[3:])
    alone = kernels.loop_lanes(*args[:-1], lanes=False)
    assert all(x is None for x in alone[3:])
    assert cs.bits_equal(alone[:3], out[:3])
    assert bool(out[1].any()) and (label != "full" or bool(out[1].all()))


def test_loop_lanes_at_its_largest_store_and_past_it(dev):
    """K15 at ``LOOP_LANES_MAX_CAP`` slots (each warp streaming 2,048
    slots through its running top C) bit-equal to the plain version; one
    slot more raises before any launch."""
    import chip_smoke as cs

    cap = kernels.LOOP_LANES_MAX_CAP
    args = cs.k15_inputs(7, dev, 1, 2, 8, cap, 40, 1, 5.0, 25, True, False)
    out = kernels.loop_lanes(*args)
    for name, a, b in zip(cs.K15_OUTS, out, closure.loop_lanes_ref(*args)):
        assert cs.bits_equal(a, b), name
    big = cs.k15_inputs(7, dev, 1, 2, 8, cap + 1, 8, 1, 5.0, 25, False,
                        False)
    kernels.reset_launches()
    with pytest.raises(ValueError, match="slots"):
        kernels.loop_lanes(*big)
    assert kernels.LAUNCHES["loop_lanes"] == 0


@pytest.mark.parametrize("radius", [5.0, 0.6])
def test_loop_lanes_128_candidates_on_its_largest_store(dev, radius):
    """K15 at C = 128 on stores of ``LOOP_LANES_MAX_CAP`` slots (each warp
    streaming 2,048 slots into a running top 128), with ~2 C keyframes in
    the radius and with fewer than C (radius 0.6 m: the masked lanes the
    lowest-index others): the search with its lanes, the search alone and
    the lanes of given candidates, each bit-equal to the plain version."""
    import chip_smoke as cs

    cap = kernels.LOOP_LANES_MAX_CAP
    args = list(cs.k15_inputs(5, dev, 2, 2, 128, cap, 360, 2, 5.0, 25,
                              True, False))
    args[7] = radius
    out = kernels.loop_lanes(*args)
    ref = closure.loop_lanes_ref(*args)
    for name, a, b in zip(cs.K15_OUTS, out, ref):
        assert cs.bits_equal(a, b), name
    alone = kernels.loop_lanes(*args[:-1], lanes=False)
    assert cs.bits_equal(alone[:3], out[:3])
    given = kernels.loop_lanes(*args, cand_idx=out[0], cand_mask=out[1])
    assert cs.bits_equal(given[3:], out[3:])
    n_in = out[1].sum(-1)
    assert bool((n_in > 0).any())
    if radius < 1.0:
        assert bool((n_in < 128).all())
    else:
        assert bool((n_in == 128).any())


def test_fused_verify_equals_per_session_launches(dev):
    """Serving's verify of 8 sessions x 4 queries x 4 candidates (its loop
    config, 512-slot stores, beam stride 2) as one K15 and one gated
    ``lm_ndt`` launch over the flat cache, against one such call per
    session: every output bit for bit (LM lanes are independent, and the
    threads per lane change no bit)."""
    import chip_smoke as cs
    from ndtpu_torch.config import PipelineConfig
    from ndtpu_torch.dist import slam_dp
    from ndtpu_torch.slam.keyframes import KeyframeStore

    cfg = slam_dp.serving_config(PipelineConfig.from_json(str(cs.SERVING)))
    loop = cfg.loop
    s, k, cap = 8, cfg.loop.max_detect_per_window, 512
    args = cs.k15_inputs(3, dev, s, k, loop.max_candidates, cap, 360,
                         loop.verify_beam_stride, loop.radius,
                         loop.min_index_gap, False, False)
    poses, live, pts, msk, wposes, sel, qidx = args[:7]
    seq = cs.box_sequence(0, 360, device=dev)
    shape = closure.local_table_shape(loop, False)
    rows = torch.arange(s * cap, device=dev)
    scan = rows % seq.points.shape[0]
    tables = torch.zeros((s * cap,) + shape, device=dev)
    closure.write_local_tables(tables, rows, torch.ones_like(rows, dtype=bool),
                               seq.points[scan].contiguous(),
                               seq.mask[scan].contiguous(), loop, cfg.ndt)
    tables = tables.view((s, cap) + shape)
    store = lambda i, j: KeyframeStore(poses[i:j], None, None, live[i:j],
                                       None, tables[i:j])
    kernels.reset_launches()
    fused = closure.detect_loops_stacked(store(0, s), pts, msk, wposes, sel,
                                         qidx, loop, cfg.match)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["loop_lanes"] == 1
    assert kernels.LAUNCHES["loop_gate_fused"] == 1
    for i in range(s):
        one = closure.detect_loops_stacked(
            store(i, i + 1), pts[i:i + 1], msk[i:i + 1], wposes[i:i + 1],
            sel[i:i + 1], qidx[i:i + 1], loop, cfg.match)
        for name, a, b in zip(one._fields, fused, one):
            assert cs.bits_equal(a[i], b[0]), (i, name)
    assert kernels.LAUNCHES["loop_lanes"] == 1 + s


K16_LABELS = ("serving", "smoke", "ties", "full", "off")


@pytest.mark.parametrize("label", K16_LABELS)
def test_refresh_points_bit_equal_to_plain(dev, label):
    """K16 against ``pipeline.refresh_points_ref`` on the same f32 card
    inputs at ``chip_smoke.K16_CASES`` (serving's 8 x 512 slots and the
    smoke's 160, M = 12, 360 beams; equal staleness across the M-th place,
    a full store, every session off): every output bit-equal, one launch a
    call."""
    import chip_smoke as cs
    from ndtpu_torch.slam import pipeline

    i = K16_LABELS.index(label)
    args = cs.k16_inputs(i, dev, *cs.K16_CASES[i][1:])
    kernels.reset_launches()
    out = kernels.refresh_points(*args)
    assert kernels.LAUNCHES["refresh_points"] == 1
    ref = pipeline.refresh_points_ref(*args)
    for name, a, b in zip(cs.K16_OUTS, out, ref):
        assert cs.bits_equal(a, b), name
    on = int(out[4].sum())
    assert (on == 0) == (label == "off")


def test_refresh_points_at_its_largest_store_and_past_it(dev):
    """K16 at the largest store its shared memory takes at M = 12 (past the
    48 KB a block gets without opting in) bit-equal to the plain version;
    one slot more raises before any launch."""
    import chip_smoke as cs
    from ndtpu_torch.slam import pipeline

    m = 12
    cap = kernels.refresh_max_cap(m)
    args = cs.k16_inputs(7, dev, 2, cap, m, 8, True, False, "all", 0.0)
    out = kernels.refresh_points(*args)
    for name, a, b in zip(cs.K16_OUTS, out,
                          pipeline.refresh_points_ref(*args)):
        assert cs.bits_equal(a, b), name
    big = cs.k16_inputs(7, dev, 1, cap + 1, m, 8, False, False, "all", 0.0)
    kernels.reset_launches()
    with pytest.raises(ValueError, match="shared memory"):
        kernels.refresh_points(*big)
    assert kernels.LAUNCHES["refresh_points"] == 0


def test_refresh_stacked_equals_single_session_refreshes(dev):
    """Serving's refresh of 8 sessions (one K16, one K3s, one K14 row
    write) against one single-session ``_refresh_map`` a session (K16 at
    S = 1, K3, the row write), bit for bit, with one session's refresh
    off."""
    import chip_smoke as cs
    from ndtpu_torch.config import PipelineConfig
    from ndtpu_torch.dist import slam_dp
    from ndtpu_torch.slam import pipeline
    from ndtpu_torch.slam.keyframes import KeyframeStore

    cfg = slam_dp.serving_config(PipelineConfig.from_json(str(cs.SERVING)))
    poses, live, pts, msk, mkp, _, m, _ = cs.k16_inputs(
        11, dev, 8, 160, cfg.refresh_top_m, 360, False, False, "all", 0.0)
    s = poses.shape[0]
    kf8 = KeyframeStore(poses, pts, msk, live, live.sum(1), None)
    one = tgrid.empty_stats(cfg.grid, torch.float32, dev)
    stats8 = tgrid.NDTStats(*(torch.stack([f] * s).contiguous()
                              for f in one))
    enable = torch.arange(s, device=dev) != 3
    kernels.reset_launches()
    st8, mk8 = slam_dp._refresh_stacked(stats8, kf8, mkp, cfg, enable)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["refresh_points"] == 1
    assert kernels.LAUNCHES["halfcell_add_stacked"] == 1
    for i in range(s):
        st, mk = pipeline._refresh_map(
            tgrid.NDTStats(*(f[i] for f in stats8)), slam_dp._take(kf8, i),
            mkp[i], cfg, enable=enable[i])
        assert cs.bits_equal(mk8[i], mk), i
        assert cs.bits_equal(tuple(f[i] for f in st8), tuple(st)), i
    assert kernels.LAUNCHES["refresh_points"] == 1 + s
    assert cs.bits_equal(mk8[3], mkp[3])


def test_fresh_residual_max_stacked_equals_single_launches(dev):
    """K5's fresh window of 8 sessions (one launch; windows clamped at
    slot 0, inside, and at F - k) against one single-session launch a
    session, bit for bit, and within rtol 1e-5 of the f32 plain version."""
    from ndtpu_torch.dist import slam_dp
    from ndtpu_torch.graph import factors as fct
    from ndtpu_torch.graph import incremental as inc

    rng = np.random.default_rng(4)
    s, v, f = 8, 160, 320
    nb = np.array([5, 64, 100, 200, 250, 300, 319, 320])
    a = np.triu(rng.normal(0.0, 2.0, (s, f, 3, 3))) + 5 * np.eye(3)
    t = lambda x, dt=torch.float32: torch.as_tensor(x, dtype=dt, device=dev)
    g8 = fct.PoseGraph(
        poses=t(rng.normal(0.0, 3.0, (s, v, 3))),
        pose_mask=t(np.ones((s, v), bool), torch.bool),
        prior_idx=t(np.zeros((s, 4)), torch.int64),
        prior_z=t(np.zeros((s, 4, 3))),
        prior_sqrt_info=t(np.broadcast_to(np.eye(3), (s, 4, 3, 3)).copy()),
        prior_mask=t(np.zeros((s, 4), bool), torch.bool),
        bet_i=t(rng.integers(0, v, (s, f)), torch.int64),
        bet_j=t(rng.integers(0, v, (s, f)), torch.int64),
        bet_z=t(rng.normal(0.0, 1.0, (s, f, 3))), bet_sqrt_info=t(a),
        bet_mask=t((np.arange(f) < nb[:, None])
                   & (rng.random((s, f)) < 0.9), torch.bool),
        n_poses=t(np.full(s, v), torch.int64),
        n_priors=t(np.zeros(s), torch.int64),
        n_between=t(nb, torch.int64))
    kernels.reset_launches()
    out = inc.fresh_residual_max_stacked(g8)
    assert kernels.LAUNCHES["factor_linearize"] == 1
    for i in range(s):
        one = inc.fresh_residual_max(slam_dp._take(g8, i))
        assert torch.equal(out[i].view(torch.int32),
                           one.view(torch.int32)), i
    ref = inc.fresh_residual_max_stacked_ref(g8)
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=0)
    assert bool((out > 0).all())
