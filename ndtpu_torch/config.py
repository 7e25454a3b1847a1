"""Configuration dataclasses of the port: a copy of ``ndtpu/config.py``.

Every subsystem gets a frozen dataclass; the classes, their fields and
defaults, and the JSON loader are the JAX package's, field for field, so a
``configs/*.json`` file parses to the same values in both packages (the
tests hold them equal). The port keeps its own copy because it imports
nothing of the JAX package. Comments that cite measurements describe the
JAX package on its TPU.

Configs are JSON-loadable; the five BASELINE.md measurement configs live in
``configs/*.json`` and parse into :class:`PipelineConfig`.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Tuple


@dataclasses.dataclass(frozen=True)
class GridConfig:
    """Geometry of the dense NDT grid (static — fixes array shapes).

    The map covers ``[x0, x0 + nx*cell)`` x ``[y0, y0 + ny*cell)``.
    ``overlap`` selects the classic Biber/Strasser 4-shifted-grid scheme
    (4) or a single grid (1); shifted grids reduce discretization artifacts
    (SURVEY.md §4.2 "+3 shifted grids in classic 2D NDT").
    """

    x0: float = -30.0
    y0: float = -30.0
    cell: float = 1.0
    nx: int = 64
    ny: int = 64
    overlap: int = 4  # 1 or 4

    @property
    def n_cells(self) -> int:
        return self.nx * self.ny


@dataclasses.dataclass(frozen=True)
class NDTMapConfig:
    """NDT cell statistics → Gaussian finalization parameters.

    ``min_pts``: cells with fewer points have no meaningful covariance and
    are masked invalid (standard NDT practice; SURVEY.md §3.1 "NDT cell").
    ``eig_ratio``: the smaller covariance eigenvalue is clamped to
    ``eig_ratio * lambda_max`` (Magnusson 2009 regularization) so near-line
    walls stay well conditioned in f32.
    """

    min_pts: int = 3
    eig_ratio: float = 1e-3
    # Absolute eigenvalue floor: sigma_perp >= 0.1 m. A razor-thin wall
    # Gaussian (sensor noise ~cm) makes the attraction basin a few cm wide;
    # flooring at ~10% of a typical 1 m cell keeps half-meter initial-guess
    # errors inside the basin without blurring the optimum materially.
    eig_abs_min: float = 0.01


@dataclasses.dataclass(frozen=True)
class MatchConfig:
    """Gauss-Newton / Levenberg-Marquardt NDT registration parameters.

    Mirrors the capability of the reference's ``NDTMatcher::match`` iteration
    controls (SURVEY.md §4.2): damped Newton steps on the NDT score over
    (tx, ty, phi) with step control, fixed iteration cap, tolerance stop.
    """

    max_iter: int = 30
    tol: float = 1e-4           # convergence threshold on |delta|
    # A REJECTED step below this norm also stops: near the optimum the full
    # Newton step lands inside the objective's f32 noise basin and gets
    # rejected over and over while lambda ramps up — measured ~8 wasted
    # iterations per registration. A rejected sub-millimeter proposal means
    # the quadratic model sees no improvement of that scale left. At 3e-3
    # the headline batch converges 256/256 with max iters 27 (vs 30) and
    # mean 13.9 (vs 16.4) at identical pose error — and the while_loop cost
    # is max-over-batch, so the tail is what the chip pays for. The one
    # consumer that needs a finer setting is coarse-hypothesis alignment
    # (global_align): an early stop there can hand the win to a pi-flipped
    # alias in symmetric rooms, so it pins reject_tol=1e-3 explicitly.
    reject_tol: float = 3e-3
    d2: float = 0.5             # Magnusson exponent softening (0 < d2 <= 1):
                                # score = exp(-d2/2 * mahalanobis^2); d2 < 1
                                # shrinks the indefinite -a a^T Hessian term,
                                # widening the convergence basin (Magnusson
                                # 2009 d1/d2 parametrization)
    # Far from the optimum the NDT Hessian is indefinite and the raw Newton
    # step useless — every run starts by ramping lambda up from a small seed
    # (measured ~5 rejected iterations). Starting in the damped regime and
    # letting accepts decay lambda (/lambda_down per accept) is strictly
    # cheaper: easy cases reach the Newton regime in ~2 accepts anyway.
    # 1.0 (not 10) keeps the first accepted step large enough that odometry
    # ATE and global-alignment basin capture don't degrade.
    init_lambda: float = 1.0    # initial LM damping
    lambda_up: float = 10.0
    lambda_down: float = 3.0
    max_lambda: float = 1e6
    step_clip: float = 2.0      # max |translation step| (m) per iteration
    exp_clip: float = 40.0      # clamp on Mahalanobis exponent (f32 safety)
    # Compact quad table: 64 B rows (f32 means + bf16-pair icov/valid)
    # instead of 128 B — halves the table's HBM footprint at ~0.4% relative
    # icov error (pose impact 0.17 mm measured). NOTE: measured NO speed
    # change (the gather is index-rate bound, not byte bound —
    # docs/PERF.md §3); this is a memory knob for city-scale maps. Off by
    # default so f64 oracle-parity tests see bit-exact Gaussians.
    compact_table: bool = False
    # Two-phase batched LM (match_batch_packed): the while_loop pays
    # max-over-batch iterations at full width (p50=13 / max=30 measured on
    # the serving shape — ~2.2x waste). phase2_width > 0 runs phase1_iters
    # at full width, then compacts unconverged stragglers into
    # phase2_width-wide completion rounds. Identical per-element results;
    # 0 disables (single full-width loop).
    phase2_width: int = 0
    phase1_iters: int = 14


@dataclasses.dataclass(frozen=True)
class KeyframeConfig:
    """Keyframe spawning thresholds (SURVEY.md §3.1 'Keyframe manager')."""

    dist_thresh: float = 0.5    # m of translation since last keyframe
    angle_thresh: float = 0.30  # rad of rotation since last keyframe
    capacity: int = 1024        # static keyframe array capacity


@dataclasses.dataclass(frozen=True)
class LoopConfig:
    """Loop-closure candidate generation + batched verification
    (SURVEY.md §4.5)."""

    radius: float = 5.0         # candidate search radius (m)
    min_index_gap: int = 30     # min keyframe index separation
    max_candidates: int = 64    # static batch size of verifications per call
    # Accept at most this many (highest-score) verified loops per query
    # keyframe. Without a budget, every keyframe in revisited territory
    # accepts ALL nearby candidates forever (measured: 953 loop factors by
    # scan 600 of a multi-lap run), overwhelming the incremental smoother
    # and overflowing factor capacity; real systems keep loop factors
    # sparse. 0 disables the budget.
    max_accept_per_query: int = 2
    detect_every: int = 1       # run detection on every k-th keyframe only
    # Windowed pipeline: detection batch covers the first K keyframes of a
    # window (keyframes land every ~2-3 scans, so K = W/2 covers everything
    # in practice; rank-overflow keyframes skip detection for one window).
    # 0 -> detect for every scan slot (W-wide batch, ~2-3x wasted work).
    max_detect_per_window: int = 4
    score_gate: float = 0.30    # min mean per-point NDT score to accept
    # Innovation gate (perceptual-aliasing defense): reject a verified
    # loop whose implied correction ||t_match - t_init|| exceeds
    # ``max_innovation_base + max_innovation_per_kf * index_gap`` — the
    # accumulated-odometry-drift budget. On a symmetric ring corridor
    # (the MIT-Killian shape) score-gated NDT verification aliases badly:
    # measured 94% of accepted loops wrong by ~7 m (median), turning ATE
    # 2.43 (odometry) into 2.93; true re-entry corrections sit at the
    # actual drift (~2.4 m here), well inside the budget.
    # max_innovation_per_kf=0 disables the gate.
    max_innovation_base: float = 1.0
    max_innovation_per_kf: float = 0.02
    local_half_extent: float = 15.0  # half-size (m) of per-keyframe local map
    local_cell: float = 1.0
    local_overlap: int = 4
    # Verification cost knobs (flat cached path only; the fresh/oracle
    # paths always verify at full resolution). The verify gather is
    # index-rate bound (docs/PERF.md §3), so cost scales with
    # lanes x beams x LM iterations — these trade a little measurement
    # precision for serving throughput:
    # verify_max_iter: LM iteration cap for loop verification (0 = use
    # match.max_iter). Verification inits come from the current pose
    # estimate (within drift of the truth), so they converge in far fewer
    # iterations than cold registrations; the while_loop pays
    # max-over-lanes, so outlier non-matching candidates otherwise set
    # the iteration bill for everyone.
    verify_max_iter: int = 0
    # verify_beam_stride: verify on every k-th beam only (1 = all beams).
    # The factor's information comes from the subsampled registration's
    # Hessian, so the downweighting is automatic and honest.
    verify_beam_stride: int = 1


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Pose-graph solver parameters (capability of GTSAM GaussNewton/LM +
    ISAM2 iteration controls; SURVEY.md §3.2)."""

    max_iter: int = 20
    tol: float = 1e-6           # stop when |delta| below this
    init_lambda: float = 1e-4   # LM damping for the nonlinear loop
    lambda_up: float = 10.0
    lambda_down: float = 3.0
    # PCG (large sparse graphs):
    pcg_max_iter: int = 250
    pcg_tol: float = 1e-5
    # incremental smoother:
    relin_threshold: float = 0.05   # relinearize keys whose |delta| exceeds
    inc_iters: int = 2              # GN iterations per incremental update
    full_solve_every: int = 50      # periodic full batched solve
    # k-hop LOCAL update (the clique-local bounded-cost property of iSAM2,
    # VERDICT r3 weak 5): an active update solves only the poses within
    # `local_hops` factor-hops of the newest `local_fresh_k` factors,
    # boundary poses held fixed (their coupling folds into the local
    # residual). A fresh loop factor seeds its whole cycle (the index
    # interval between its endpoints) into the active set; capacities are
    # static, and overflow (a cycle or neighborhood too large to fit)
    # falls back to the global warm-started PCG update.
    # local_poses=0 disables (always global).
    # Capacity choice: slots must hold a full loop CYCLE plus its k-hop
    # fringe or loop windows fall back to global. Measured on the 1000-scan
    # multilap workload (~115-keyframe laps): 128/512 slots -> 14% of
    # windows global, 0.8% local; 256/1024 -> 0% global, every active loop
    # window local, ATE 0.074 -> 0.066 m (docs/PERF.md §4).
    local_poses: int = 256          # active-set capacity (pose slots)
    local_factors: int = 1024       # gathered-factor capacity
    local_hops: int = 2
    local_fresh_k: int = 32         # newest factors seeding the active set
    # Fresh factor with |i - j| > this => loop closure => global update.
    local_span_gap: int = 20
    # Huber robust kernel threshold (whitened units) for the pipeline
    # smoother; 0 = plain least squares. Long multi-lap runs accumulate a
    # few bad loop factors (aliased verifications that pass the score gate,
    # weighted by overconfident NDT-Hessian information); measured ATE at
    # T=1000 multi-lap: LS 1.89 m, delta=1.5 -> 0.24 m, delta=5 -> 0.075 m,
    # while T=300 is identical (0.049) for every delta incl. LS — a larger
    # delta keeps legitimate fresh-loop corrections at full weight and only
    # caps gross outliers.
    huber_delta: float = 5.0


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """One end-to-end SLAM run = one PipelineConfig (one per BASELINE config)."""

    grid: GridConfig = GridConfig()
    ndt: NDTMapConfig = NDTMapConfig()
    match: MatchConfig = MatchConfig()
    keyframe: KeyframeConfig = KeyframeConfig()
    loop: LoopConfig = LoopConfig()
    solver: SolverConfig = SolverConfig()
    n_beams: int = 360
    max_range: float = 20.0
    min_range: float = 0.1
    # Optional voxel-grid scan downsample (m); 0 disables. Applied as a mask
    # reduction (ndtpu.data.preprocess.voxel_downsample) — shapes stay static.
    downsample_voxel: float = 0.0
    use_loop_closure: bool = True
    seed: int = 0
    # Window-batched front end (run_slam_windowed / run_odometry_windowed):
    # W scans register in one batched LM dispatch against a per-window frozen
    # map; 0 < passes re-registrations refine inits + refresh the map with
    # the window's own keyframes (VERDICT r2 item 1).
    window: int = 8
    window_passes: int = 2
    # LM iteration cap for refinement passes (pass >= 2) of the windowed
    # front end; 0 = match.max_iter. Pass-2 starts from pass-1's converged
    # poses, so it needs only a few polish iterations — but the batched
    # while_loop pays max-over-lanes, and one frontier-scan straggler
    # otherwise drags every lane through ~15 sequential iterations
    # (latency, not FLOPs, is what a window costs; docs/PERF.md).
    pass2_max_iter: int = 0
    # Initialize refinement passes (pass >= 2) from the SAME scan's
    # previous-pass converged pose instead of re-chaining prev-scan pose +
    # odometry delta. The refreshed pass-2 map contains the window's own
    # keyframes placed at pass-1 poses, so the pass-1 pose is already
    # within a fraction of a cell of the pass-2 optimum — the warm start
    # cuts the sequential LM depth of the second while_loop (the serving
    # budget is latency-bound, docs/PERF.md §9).
    pass2_warm_start: bool = False
    # Register on every k-th beam only in the windowed frontend (1 = all
    # beams). The matcher is gather-row-rate bound (docs/PERF.md §3), so
    # stride k cuts the per-LM-iteration cost ~k-fold; keyframe scans are
    # stored and map-rendered at FULL resolution — only the match
    # subsamples. The registration Hessian (factor information) honestly
    # reflects the subsampled scan.
    frontend_beam_stride: int = 1
    # Odometry innovation gate (m): a registration whose translation differs
    # from its odometry-predicted init by more than this is rejected in favor
    # of the prediction. NDT's matched-mass objective pulls scans at the map
    # frontier back into map-dense territory (measured: a confident 1.8 m
    # backward jump at a window edge); odometry disagreement is the cheap,
    # reference-class gate against that. Loop-closure verification is NOT
    # gated (loops legitimately correct large drift). 0 disables.
    odom_gate: float = 1.0
    # Incremental map refresh (windowed pipeline): instead of rebuilding the
    # whole map from every keyframe whenever a loop factor lands (the
    # dominant config-3 cost: ~15 ms x ~25 windows at 300 scans), each
    # window re-places at most `refresh_top_m` keyframes whose smoothed pose
    # drifted more than `refresh_eps` from where the map last saw them —
    # NDT stats are sums, so a scan moves by subtract-at-old-pose +
    # add-at-new-pose (ndt_grid.add_points weight=-1). Settled keyframes are
    # never touched (re-rendering the whole map every window measurably
    # random-walks it: forced rebuild-every-window diverges at 27.7 m ATE
    # on the 1000-scan multilap). A full rebuild every
    # `full_rebuild_every`-th smoothing update squashes the f32
    # subtract/re-add residue. refresh_top_m=0 restores the legacy
    # rebuild-on-every-accepted-loop behavior.
    # Map maintenance policy. Default (refresh_top_m=0): full rebuild from
    # all keyframes whenever a loop factor lands — the policy that stays on
    # the good attractor across every variant tried (1000-scan multilap ATE
    # 0.064-0.081); with the half-cell scatter path the rebuild costs ~4 ms,
    # so it no longer dominates config 3. refresh_top_m>0 switches to the
    # EXPERIMENTAL incremental top-M refresh (subtract/re-add only moved
    # keyframes — ndt_grid.add_points weight=-1): algebraically equivalent
    # (unit-tested to ~1e-7) and ~2x cheaper, but the multilap scenario is
    # bistable and single boundary-point differences (e.g. a 2-pi theta
    # wrap changing cos/sin by 1 ulp) measurably flip it into a diverged
    # attractor (ATE 7.7 m). Use with care; keep eps=0 (skipping
    # sub-centimeter movers alone collapses loop acceptance 532 -> 66 and
    # diverges to 74 m).
    refresh_top_m: int = 0
    refresh_eps: float = 0.0
    full_rebuild_every: int = 64
    # Run the top-M refresh every window instead of only on loop windows
    # (legacy cadence). Not enabled by default: the loop-window cadence is
    # the empirically safe one.
    refresh_always: bool = False

    @staticmethod
    def from_json(path: str) -> "PipelineConfig":
        with open(path) as f:
            raw = json.load(f)
        return _from_dict(PipelineConfig, raw)

    def to_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(dataclasses.asdict(self), f, indent=2)


def _from_dict(cls: Any, raw: Any) -> Any:
    if not dataclasses.is_dataclass(cls):
        return raw
    fields = {f.name: f for f in dataclasses.fields(cls)}
    kwargs = {}
    for key, val in raw.items():
        if key not in fields:
            raise KeyError(f"unknown config field {key!r} for {cls.__name__}")
        ftype = fields[key].type
        sub = _DATACLASS_FIELDS.get((cls.__name__, key))
        kwargs[key] = _from_dict(sub, val) if sub is not None else val
    return cls(**kwargs)


_DATACLASS_FIELDS = {
    ("PipelineConfig", "grid"): GridConfig,
    ("PipelineConfig", "ndt"): NDTMapConfig,
    ("PipelineConfig", "match"): MatchConfig,
    ("PipelineConfig", "keyframe"): KeyframeConfig,
    ("PipelineConfig", "loop"): LoopConfig,
    ("PipelineConfig", "solver"): SolverConfig,
}
