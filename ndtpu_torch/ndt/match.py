"""Batched NDT scan registration: score / gradient / Hessian + LM iteration.

Port of ``ndtpu/ndt/match.py`` (shared ``[R, L]``, per-lane ``[B, R, L]``
and grouped ``[S, R, L]`` tables). The objective ``f(T) = -sum_i
exp(-d2/2 * d_i^T Lambda_i d_i)`` over ``T = (tx, ty, phi)`` is built from
the 11 per-lane sums of :func:`ndt_terms` and minimized by a batched
Levenberg-Marquardt loop, per lane.

On the card the whole LM loop is one kernel: :func:`match_batch_packed`
sends CUDA tensors to :func:`lm_ndt`, one launch of ``csrc/lm_ndt.cu`` per
call, in which each lane iterates to its own stop with K1's body as a
device function and nothing is read back to the host. Each lane's
trajectory depends only on its own carry, so that gives the per-lane
results of JAX's lockstep ``lax.while_loop`` and of its two-phase
compaction, whatever ``phase2_width`` is.

CPU tensors go to the plain twin :func:`lm_ndt_ref`: JAX's
``lax.while_loop`` in ``_lm_run`` as a Python loop over masked iterations.
A lane that is done is frozen (``it + active``, every carry field through
``where(active...)``), so the loop may run past the last active lane
without changing any result; it checks ``any(active)`` on the host only
every ``_SYNC_EVERY`` iterations. The twin's two-phase compaction replaces
``lax.top_k`` over 0/1 pending flags by a stable descending sort, which
orders ties by lane index exactly as ``top_k`` does; a lane counts as
pending only while it is under the iteration cap (JAX's form never ends
when more than ``phase2_width`` lanes stop at the cap unconverged).
``_SYNC_EVERY`` and the compaction are the twin's alone.

The terms on an unpacked map (``point_terms``, ``score_grad_hess``, with
``ndt.grid.lookup``) are the reference's per-pose objective; config 5's
alignment evaluates one scan at thousands of poses through
:func:`score_grad_hess_batch`, which sends CUDA tensors to K12
(``csrc/ndt_unpacked.cu``, one launch) and CPU tensors to
:func:`score_grad_hess_batch_ref`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ndtpu_torch import kernels
from ndtpu_torch.config import GridConfig, MatchConfig
from ndtpu_torch.ndt import grid as ndt_grid

__all__ = ["MatchResult", "transform_terms", "point_terms", "score_grad_hess",
           "score_grad_hess_batch", "score_grad_hess_batch_ref",
           "point_terms_quad", "solve3", "lm_loop",
           "lm_loop_batch", "match", "match_batch", "match_batch_packed",
           "match_batch_packed_gated", "match_lanes", "ndt_terms",
           "ndt_terms_ref",
           "terms_sgh", "lm_ndt", "lm_ndt_ref", "CALLS"]

_SYNC_EVERY = 4

#: Calls of :func:`match_batch_packed` (CPU and card), of
#: :func:`match_batch_packed_gated` and of :func:`match_lanes` since the
#: caller last zeroed it; on the card each call with lanes launches
#: ``lm_ndt`` once.
CALLS = {"match_batch_packed": 0}


class MatchResult(NamedTuple):
    pose: torch.Tensor       # [..., 3] optimized world-from-scan transform
    hessian: torch.Tensor    # [..., 3, 3] objective Hessian at the optimum
    score: torch.Tensor      # [...] mean per-point NDT score in [0, 1]
    n_iter: torch.Tensor     # [...] LM iterations executed (int32)
    converged: torch.Tensor  # [...] bool


def transform_terms(pose, points):
    """World points ``[N, 2]`` and their phi-derivative for a pose ``[3]``."""
    c, s = torch.cos(pose[2]), torch.sin(pose[2])
    px, py = points[..., 0], points[..., 1]
    xw = torch.stack([c * px - s * py + pose[0], s * px + c * py + pose[1]],
                     -1)
    dxdphi = torch.stack([-s * px - c * py, c * px - s * py], -1)
    return xw, dxdphi


def point_terms(pose, xw, dxdphi, mean, icov, w0, cfg: MatchConfig):
    """Per-point NDT objective terms on gathered Gaussians, reduced over
    grids and points: ``(f, g [3], H [3, 3], wsum, w0sum)``. ``pose [...,
    3]``, ``xw``/``dxdphi [..., N, 2]``, ``mean [..., G, N, 2]``, ``icov
    [..., G, N, 2, 2]``, ``w0 [..., G, N]``; leading axes batch poses."""
    d2 = cfg.d2
    d = xw[..., None, :, :] - mean                        # [..., G, N, 2]
    q = torch.einsum("...gnij,...gnj->...gni", icov, d)
    l2 = torch.sum(d * q, -1)
    e = torch.exp(-0.5 * d2 * torch.clamp(l2, 0.0, cfg.exp_clip))
    w = w0 * e
    dp = dxdphi[..., None, :, :]
    a3 = torch.sum(q * dp, -1)
    a = torch.stack([q[..., 0], q[..., 1], a3], -1)       # [..., G, N, 3]
    g = d2 * torch.einsum("...gn,...gnk->...k", w, a)
    ld = torch.einsum("...gnij,...gnj->...gni", icov, dp.expand_as(d))
    j33 = torch.sum(dp * ld, -1)
    jlj = torch.stack([
        torch.stack([icov[..., 0, 0], icov[..., 0, 1], ld[..., 0]], -1),
        torch.stack([icov[..., 0, 1], icov[..., 1, 1], ld[..., 1]], -1),
        torch.stack([ld[..., 0], ld[..., 1], j33], -1)], -2)
    rel = xw - pose[..., None, :2]                        # [..., N, 2]
    hpp = -torch.sum(q * rel[..., None, :, :], -1)
    jlj[..., 2, 2] += hpp                                 # + hpp * e33
    h_pt = jlj - d2 * a[..., :, None] * a[..., None, :]
    h = d2 * torch.einsum("...gn,...gnkl->...kl", w, h_pt)
    wsum = torch.sum(w, (-2, -1))
    return -wsum, g, h, wsum, torch.sum(w0, (-2, -1))


def score_grad_hess(pose, points, mask, ndt_map: ndt_grid.NDTMap,
                    grid: GridConfig, cfg: MatchConfig):
    """NDT objective, gradient, Hessian and mean score at ``pose [..., 3]``
    of a scan ``points [N, 2]`` (sensor frame), ``mask [N]``, on an
    unpacked map: ``(f, g [..., 3], H [..., 3, 3], score)``."""
    dt = points.dtype
    c = torch.cos(pose[..., 2])[..., None]
    s = torch.sin(pose[..., 2])[..., None]
    px, py = points[..., 0], points[..., 1]
    xw = torch.stack([c * px - s * py + pose[..., 0, None],
                      s * px + c * py + pose[..., 1, None]], -1)
    dxdphi = torch.stack([-s * px - c * py, c * px - s * py], -1)
    mean, icov, w0 = ndt_grid.lookup(ndt_map, xw, grid)
    w0 = w0 * mask.to(dt)[..., None, :]
    f, g, h, wsum, w0sum = point_terms(pose, xw, dxdphi, mean, icov, w0, cfg)
    return f, g, h, wsum / torch.clamp(w0sum, min=1.0)


#: Poses per chunk of :func:`score_grad_hess_batch_ref` (bounds its
#: ``[B, G, N, 3, 3]`` intermediates).
_SGH_CHUNK = 512


def score_grad_hess_batch_ref(poses, points, mask, ndt_map: ndt_grid.NDTMap,
                              grid: GridConfig, cfg: MatchConfig):
    """Plain version of K12: :func:`score_grad_hess` at every pose of
    ``poses [B, 3]`` for one shared scan ``points [N, 2]``, ``mask [N]``
    (JAX's ``vmap(score_grad_hess)`` over poses, as ``merge.global_align``
    calls it): ``(f [B], g [B, 3], H [B, 3, 3], score [B])``."""
    outs = [score_grad_hess(poses[i:i + _SGH_CHUNK], points, mask, ndt_map,
                            grid, cfg)
            for i in range(0, poses.shape[0], _SGH_CHUNK)]
    if not outs:
        return score_grad_hess(poses, points, mask, ndt_map, grid, cfg)
    return tuple(torch.cat(x) for x in zip(*outs))


def score_grad_hess_batch(poses, points, mask, ndt_map: ndt_grid.NDTMap,
                          grid: GridConfig, cfg: MatchConfig):
    """K12 wrapper: the NDT terms of one scan at B poses on an unpacked map.
    CUDA tensors go to the kernel (``csrc/ndt_unpacked.cu``: one block per
    pose, the scan read once per block, sums in a fixed order; f32), CPU
    tensors to :func:`score_grad_hess_batch_ref`."""
    if not points.is_cuda:
        return score_grad_hess_batch_ref(poses, points, mask, ndt_map, grid,
                                         cfg)
    return kernels.ndt_sgh_unpacked(
        poses.contiguous(), points.contiguous(),
        mask.to(points.dtype).contiguous(), ndt_map.mean.contiguous(),
        ndt_map.icov.contiguous(), ndt_map.valid.contiguous(), grid, cfg.d2,
        cfg.exp_clip)


def _quad_sums(poses, x, y, dpx, dpy, rows, w_mask, d2: float, exp_clip: float,
               overlap: int, compact: bool = False):
    """The 11 per-lane sums ``[B, 11]`` of ``point_terms_quad`` (wsum, w0sum,
    g0..g2, h00, h01, h02, h11, h12, h22), before the ``d2`` scaling."""
    dt = x.dtype
    tx, ty = poses[:, 0, None], poses[:, 1, None]
    rx, ry = x - tx, y - ty
    acc = None
    for g in range(overlap):
        if compact:
            mx, my = rows[..., g * 4 + 0], rows[..., g * 4 + 1]
            i00, i01 = ndt_grid.unpack_bf16_pair(rows[..., g * 4 + 2], dt)
            i11, vld = ndt_grid.unpack_bf16_pair(rows[..., g * 4 + 3], dt)
            w0 = vld * w_mask
        else:
            mx, my = rows[..., g * 8 + 0], rows[..., g * 8 + 1]
            i00, i01 = rows[..., g * 8 + 2], rows[..., g * 8 + 3]
            i11 = rows[..., g * 8 + 4]
            w0 = rows[..., g * 8 + 5] * w_mask
        dx, dy = x - mx, y - my
        qx = i00 * dx + i01 * dy
        qy = i01 * dx + i11 * dy
        l2 = torch.clamp(dx * qx + dy * qy, min=0.0)
        e = torch.exp(-0.5 * d2 * torch.clamp(l2, max=exp_clip))
        w = w0 * e
        a3 = qx * dpx + qy * dpy
        ldx = i00 * dpx + i01 * dpy
        ldy = i01 * dpx + i11 * dpy
        j33 = dpx * ldx + dpy * ldy
        hpp = -(qx * rx + qy * ry)
        terms = torch.stack([
            w, w0, w * qx, w * qy, w * a3,
            w * (i00 - d2 * qx * qx), w * (i01 - d2 * qx * qy),
            w * (ldx - d2 * qx * a3), w * (i11 - d2 * qy * qy),
            w * (ldy - d2 * qy * a3), w * (j33 + hpp - d2 * a3 * a3)],
            -1).sum(-2)
        acc = terms if acc is None else acc + terms
    return acc


def _assemble(sums, d2: float):
    """``(f [B], g [B,3], H [B,3,3], wsum [B], w0sum [B])`` from the sums."""
    wsum, w0sum = sums[:, 0], sums[:, 1]
    g_vec = d2 * sums[:, 2:5]
    h00, h01, h02, h11, h12, h22 = sums[:, 5:11].unbind(-1)
    h = d2 * torch.stack([torch.stack([h00, h01, h02], -1),
                          torch.stack([h01, h11, h12], -1),
                          torch.stack([h02, h12, h22], -1)], -2)
    return -wsum, g_vec, h, wsum, w0sum


def point_terms_quad(poses, x, y, dpx, dpy, rows, w_mask, cfg: MatchConfig,
                     overlap: int):
    """Batched NDT objective terms from gathered quad rows ``[B, N, G*8]``:
    ``(f [B], g [B,3], h [B,3,3], wsum [B], w0sum [B])``."""
    sums = _quad_sums(poses, x, y, dpx, dpy, rows, w_mask, cfg.d2,
                      cfg.exp_clip, overlap, cfg.compact_table)
    return _assemble(sums, cfg.d2)


def _lane_transform(poses, px, py):
    c = torch.cos(poses[:, 2])[:, None]
    s = torch.sin(poses[:, 2])[:, None]
    x = c * px - s * py + poses[:, 0, None]
    y = s * px + c * py + poses[:, 1, None]
    dpx = -s * px - c * py
    dpy = c * px - s * py
    return x, y, dpx, dpy


def ndt_terms_ref(poses, px, py, mask_f, table, grid: GridConfig, d2: float,
                  exp_clip: float, compact: bool = False, group=None):
    """Plain twin of K1: lane transform + quad-row gather + the 11 sums of
    ``point_terms_quad``, ``[B, 11]``. ``table`` is one shared ``[R, L]``
    table (``group=None``) or ``[S, R, L]`` with lane ``b`` reading table
    ``group[b]`` (``lookup_quad_grouped``)."""
    x, y, dpx, dpy = _lane_transform(poses, px, py)
    if group is None:
        rows, inb = ndt_grid.lookup_quad(table, x, y, grid)
    else:
        s, r, l = table.shape
        rows, inb = ndt_grid.lookup_quad_grouped(table.reshape(s * r, l), r,
                                                 group, x, y, grid)
    w_mask = mask_f * inb.to(px.dtype)
    return _quad_sums(poses, x, y, dpx, dpy, rows, w_mask, d2, exp_clip,
                      grid.overlap, compact)


def ndt_terms(poses, px, py, mask_f, table, grid: GridConfig, d2: float,
              exp_clip: float, compact: bool = False, group=None):
    """K1 wrapper: the 11 NDT sums ``[B, 11]`` of every lane. CUDA tensors go
    to the kernel (f32, any table layout: overlap 4 or 1, full or compact
    rows; ``group`` int32), CPU tensors to :func:`ndt_terms_ref`."""
    if not px.is_cuda:
        return ndt_terms_ref(poses, px, py, mask_f, table, grid, d2, exp_clip,
                             compact, group)
    return kernels.ndt_terms(poses.contiguous(), px.contiguous(),
                             py.contiguous(), mask_f.contiguous(), table, grid,
                             d2, exp_clip, group, compact)


def solve3(a, b):
    """Closed-form 3x3 linear solve (Cramer's rule), batched."""
    c00 = a[..., 1, 1] * a[..., 2, 2] - a[..., 1, 2] * a[..., 2, 1]
    c01 = a[..., 1, 2] * a[..., 2, 0] - a[..., 1, 0] * a[..., 2, 2]
    c02 = a[..., 1, 0] * a[..., 2, 1] - a[..., 1, 1] * a[..., 2, 0]
    det = a[..., 0, 0] * c00 + a[..., 0, 1] * c01 + a[..., 0, 2] * c02
    det = torch.where(torch.abs(det) < 1e-30, torch.full_like(det, 1e-30),
                      det)
    c10 = a[..., 0, 2] * a[..., 2, 1] - a[..., 0, 1] * a[..., 2, 2]
    c11 = a[..., 0, 0] * a[..., 2, 2] - a[..., 0, 2] * a[..., 2, 0]
    c12 = a[..., 0, 1] * a[..., 2, 0] - a[..., 0, 0] * a[..., 2, 1]
    c20 = a[..., 0, 1] * a[..., 1, 2] - a[..., 0, 2] * a[..., 1, 1]
    c21 = a[..., 0, 2] * a[..., 1, 0] - a[..., 0, 0] * a[..., 1, 2]
    c22 = a[..., 0, 0] * a[..., 1, 1] - a[..., 0, 1] * a[..., 1, 0]
    x0 = (c00 * b[..., 0] + c10 * b[..., 1] + c20 * b[..., 2]) / det
    x1 = (c01 * b[..., 0] + c11 * b[..., 1] + c21 * b[..., 2]) / det
    x2 = (c02 * b[..., 0] + c12 * b[..., 1] + c22 * b[..., 2]) / det
    return torch.stack([x0, x1, x2], -1)


def _solve_damped(h, g, lam):
    """Batched LM step: ``(H + lam |diag(H)|) delta = -g``."""
    diag = torch.clamp(torch.abs(torch.diagonal(h, dim1=-2, dim2=-1)),
                       min=1e-6)
    a = h + torch.diag_embed(lam[..., None] * diag)
    return solve3(a, -g)


class _Carry(NamedTuple):
    pose: torch.Tensor
    f: torch.Tensor
    g: torch.Tensor
    h: torch.Tensor
    score: torch.Tensor
    lam: torch.Tensor
    it: torch.Tensor
    done: torch.Tensor
    conv: torch.Tensor


def _lm_carry_init(sgh, init_poses, cfg: MatchConfig) -> _Carry:
    f0, g0, h0, s0 = sgh(init_poses)
    b = init_poses.shape[0]
    dev = init_poses.device
    lam0 = torch.full((b,), cfg.init_lambda, dtype=init_poses.dtype,
                      device=dev)
    zero_grad = torch.sum(torch.abs(g0), -1) == 0.0
    return _Carry(init_poses, f0, g0, h0, s0, lam0,
                  torch.zeros((b,), dtype=torch.int32, device=dev), zero_grad,
                  torch.zeros((b,), dtype=torch.bool, device=dev))


def _lm_trial(c: _Carry, cfg: MatchConfig, active):
    """The clipped damped step ``delta [B,3]`` and the trial pose of every
    active lane (the others keep their pose)."""
    delta = _solve_damped(c.h, c.g, c.lam)
    tn = torch.sqrt(delta[:, 0] ** 2 + delta[:, 1] ** 2)
    scale = torch.where(tn > cfg.step_clip, cfg.step_clip / tn,
                        torch.ones_like(tn))
    delta = delta * scale[:, None]
    return delta, torch.where(active[:, None], c.pose + delta, c.pose)


def _lm_body(sgh, c: _Carry, cfg: MatchConfig, max_iter: int) -> _Carry:
    active = (c.it < max_iter) & ~c.done
    delta, pose_try = _lm_trial(c, cfg, active)
    f2, g2, h2, s2 = sgh(pose_try)
    accept = active & (f2 < c.f)
    acc = accept[:, None]
    lam_n = torch.where(accept, torch.clamp(c.lam / cfg.lambda_down, min=1e-9),
                        torch.where(active, c.lam * cfg.lambda_up, c.lam))
    dnorm = torch.sqrt(torch.sum(delta * delta, -1))
    small = active & ((dnorm < cfg.tol) | (~accept & (dnorm < cfg.reject_tol)))
    stuck = active & (lam_n > cfg.max_lambda)
    return _Carry(torch.where(acc, pose_try, c.pose),
                  torch.where(accept, f2, c.f),
                  torch.where(acc, g2, c.g),
                  torch.where(accept[:, None, None], h2, c.h),
                  torch.where(accept, s2, c.score), lam_n,
                  c.it + active.to(torch.int32), c.done | small | stuck,
                  c.conv | small)


def _lm_run(sgh, carry: _Carry, cfg: MatchConfig, max_iter: int) -> _Carry:
    """Advance a batched LM carry until every lane is done or has spent
    ``max_iter`` TOTAL iterations (the per-lane counter persists across
    calls). Frozen lanes make extra iterations no-ops, so the host checks
    for activity only every ``_SYNC_EVERY`` iterations."""
    # No lane can run more than max_iter - min(it) further iterations.
    budget = max_iter - int(carry.it.min()) if carry.it.numel() else 0
    for k in range(max(0, budget)):
        if k % _SYNC_EVERY == 0 and not bool(
                ((carry.it < max_iter) & ~carry.done).any()):
            break
        carry = _lm_body(sgh, carry, cfg, max_iter)
    return carry


def _lm_result(c: _Carry) -> MatchResult:
    return MatchResult(pose=c.pose, hessian=c.h, score=c.score, n_iter=c.it,
                       converged=c.conv & (c.f < 0.0))


def lm_loop_batch(sgh, init_poses, cfg: MatchConfig) -> MatchResult:
    """Batched damped-Newton iteration with per-lane masked accept and
    convergence; ``sgh(poses [B,3]) -> (f, g, H, score)``."""
    carry = _lm_carry_init(sgh, init_poses, cfg)
    return _lm_result(_lm_run(sgh, carry, cfg, cfg.max_iter))


def lm_loop(sgh, init_pose, cfg: MatchConfig) -> MatchResult:
    """Single-pose damped-Newton (LM) loop (``ndtpu/ndt/match.py::lm_loop``)
    on an objective evaluator ``sgh(pose [3]) -> (f, g [3], H [3, 3],
    score)``: one evaluation per iteration, at the trial pose; a step
    accepted iff it lowers ``f``; the translation step clipped to
    ``step_clip``; done on a proposed step under ``tol``, a REJECTED step
    under ``reject_tol`` or the damping past ``max_lambda``; ``converged =
    small & (f < 0)``. The decisions are read on the host (one read per
    iteration, where JAX's ``while_loop`` branches on the device), so
    replicated evaluators (``dist.gridmap.match_slab``) take the same ones
    on every rank."""
    dt = init_pose.dtype
    f, g, h, score = sgh(init_pose)
    pose = init_pose
    lam = torch.tensor(cfg.init_lambda, dtype=dt, device=init_pose.device)
    it, conv = 0, False
    done = bool(torch.sum(torch.abs(g)) == 0.0)   # no valid cell: no work
    while it < cfg.max_iter and not done:
        delta = _solve_damped(h, g, lam)
        tn = torch.sqrt(delta[0] ** 2 + delta[1] ** 2)
        delta = delta * torch.where(tn > cfg.step_clip, cfg.step_clip / tn,
                                    torch.ones_like(tn))
        pose_try = pose + delta
        f2, g2, h2, s2 = sgh(pose_try)
        accept = bool(f2 < f)
        if accept:
            pose, f, g, h, score = pose_try, f2, g2, h2, s2
            lam = torch.clamp(lam / cfg.lambda_down, min=1e-9)
        else:
            lam = lam * cfg.lambda_up
        dnorm = torch.sqrt(torch.sum(delta * delta))   # tolerances in dt
        small = bool(dnorm < cfg.tol) or (not accept
                                           and bool(dnorm < cfg.reject_tol))
        done = small or bool(lam > cfg.max_lambda)
        conv = small
        it += 1
    dev = init_pose.device
    return MatchResult(pose=pose, hessian=h, score=score,
                       n_iter=torch.tensor(it, dtype=torch.int32, device=dev),
                       converged=torch.tensor(conv, device=dev) & (f < 0.0))


def terms_sgh(px, py, mask_f, table, grid: GridConfig, cfg: MatchConfig,
              group=None, terms=None):
    """``sgh(poses [B,3]) -> (f, g, H, score)`` from the 11 sums of
    ``terms`` (:func:`ndt_terms_ref` by default; :func:`ndt_terms` gives the
    composite route, K1 on the card with the LM step in torch)."""
    terms = ndt_terms_ref if terms is None else terms

    def sgh(poses):
        sums = terms(poses, px, py, mask_f, table, grid, cfg.d2, cfg.exp_clip,
                     cfg.compact_table, group)
        f, g, h, wsum, w0sum = _assemble(sums, cfg.d2)
        return f, g, h, wsum / torch.clamp(w0sum, min=1.0)
    return sgh


def lm_ndt_ref(init_poses, px, py, mask_f, table, grid: GridConfig,
               cfg: MatchConfig, group=None) -> MatchResult:
    """Plain twin of :func:`lm_ndt`: the batched masked LM loop over
    :func:`ndt_terms_ref`, with JAX's two-phase compaction when
    ``cfg.phase2_width > 0``. ``table`` is ``[R, L]`` (``group=None``) or
    ``[S, R, L]`` with lane ``b`` reading table ``group[b]``."""
    sgh = terms_sgh(px, py, mask_f, table, grid, cfg, group)
    b = init_poses.shape[0]
    c2 = cfg.phase2_width
    if c2 <= 0 or b <= c2:
        return lm_loop_batch(sgh, init_poses, cfg)

    carry = _lm_carry_init(sgh, init_poses, cfg)
    carry = _lm_run(sgh, carry, cfg, min(cfg.phase1_iters, cfg.max_iter))
    while bool((~carry.done & (carry.it < cfg.max_iter)).any()):
        # Pending = not done AND under the cap. JAX's ``top_k(~done)`` also
        # ranks capped lanes as pending, so once more than ``c2`` lanes sit
        # at the cap undone, every round picks them and the loop never ends
        # (ROADMAP C-r1). Frozen lanes are no-ops, so per-lane results are
        # the same either way.
        pending = (~carry.done & (carry.it < cfg.max_iter)).to(torch.int32)
        idx = torch.sort(pending, descending=True, stable=True).indices[:c2]
        sub = _Carry(*(x[idx] for x in carry))
        sub = _lm_run(terms_sgh(px[idx], py[idx], mask_f[idx], table, grid,
                                cfg, None if group is None else group[idx]),
                      sub, cfg, cfg.max_iter)
        fields = []
        for x, sx in zip(carry, sub):
            x = x.clone()
            x[idx] = sx
            fields.append(x)
        carry = _Carry(*fields)
    return _lm_result(carry)


def lm_ndt(init_poses, px, py, mask_f, table, grid: GridConfig,
           cfg: MatchConfig, group=None) -> MatchResult:
    """Every lane's whole LM registration: one launch of the ``lm_ndt``
    CUDA kernel for CUDA tensors (f32, any table layout: ``grid.overlap``
    4 or 1, ``cfg.compact_table`` full or compact rows; ``group`` int32),
    :func:`lm_ndt_ref` for CPU tensors. ``cfg.max_iter`` caps the
    iterations; ``phase2_width`` changes nothing on the card."""
    if not px.is_cuda:
        return lm_ndt_ref(init_poses, px, py, mask_f, table, grid, cfg, group)
    return MatchResult(*kernels.lm_ndt(
        init_poses.contiguous(), px.contiguous(), py.contiguous(),
        mask_f.contiguous(), table, grid, cfg, group))


def match_batch_packed(points, mask, table, init_poses, grid: GridConfig,
                       cfg: MatchConfig, group=None) -> MatchResult:
    """B concurrent registrations against a prebuilt quad table.

    points ``[B, N, 2]``, mask ``[B, N]``, init_poses ``[B, 3]``. ``table``
    is ``[R, L]`` (one map for every lane), ``[B, R, L]`` (lane ``b``
    registers against its own table) or, with ``group [B]``, ``[S, R, L]``
    (lane ``b`` registers against table ``group[b]``; the loop verifier
    passes the whole keyframe cache this way instead of gathering a copy).
    On the card: one ``lm_ndt`` launch, no host sync. On the CPU, with
    ``cfg.phase2_width > 0`` the lanes still pending after
    ``cfg.phase1_iters`` are compacted into ``phase2_width``-wide rounds;
    per-lane results equal the one-phase loop's.
    """
    return match_lanes(*_packed_args(points, mask, table, init_poses, group),
                       table, grid, cfg)


def match_lanes(init_poses, px, py, mask_f, group, table,
                grid: GridConfig, cfg: MatchConfig,
                gate: kernels.LoopGate | None = None):
    """:func:`match_batch_packed` on lanes already split as ``lm_ndt`` takes
    them (``px``, ``py``, ``mask_f [B, N]``, ``group`` int32 or None), as
    the loop verify's set-up (K15) writes them; counted as a
    ``match_batch_packed`` call. With ``gate``: CUDA tensors only, one
    gated ``lm_ndt`` launch, ``(MatchResult, (accept, innov_rej,
    sqrt_info))``."""
    CALLS["match_batch_packed"] += 1
    if gate is None:
        return lm_ndt(init_poses, px, py, mask_f, table, grid, cfg, group)
    if not px.is_cuda:
        raise ValueError("the gated verify takes CUDA tensors; on the CPU "
                         "use match_batch_packed and "
                         "loop.closure._gate_and_pack")
    out = kernels.lm_ndt(init_poses.contiguous(), px.contiguous(),
                         py.contiguous(), mask_f.contiguous(), table, grid,
                         cfg, group, gate)
    return MatchResult(*out[:5]), out[5:]


def _packed_args(points, mask, table, init_poses, group):
    """``(init, px, py, mask_f, group)`` of a packed call as ``lm_ndt``
    takes them (``group`` int32, or None for a shared table)."""
    dt = points.dtype
    mask_f = mask.to(dt)
    px, py = points[..., 0].contiguous(), points[..., 1].contiguous()
    b = init_poses.shape[0]
    if table.dim() == 3:
        if group is None:
            group = torch.arange(b, device=px.device)
        group = group.to(torch.int32).contiguous()
    elif group is not None:
        raise ValueError("group= requires an [S, R, L] table")
    return init_poses.to(dt), px, py, mask_f, group


def match_batch_packed_gated(points, mask, tables, init_poses,
                             grid: GridConfig, cfg: MatchConfig, group,
                             gate: kernels.LoopGate):
    """:func:`match_batch_packed` over grouped tables ``[S, R, L]`` with
    the loop gate in the same launch: CUDA tensors only, one gated
    ``lm_ndt`` launch (``kernels.lm_ndt(gate=...)``), counted as a
    ``match_batch_packed`` call; no host sync. Lanes are ``K`` queries x
    ``C`` candidates, ``group [K*C]`` the candidates' indices. Returns
    ``(MatchResult [K*C], (accept, innov_rej [K, C] bool, sqrt_info [K, C,
    3, 3]))``. On the CPU the loop verify runs :func:`match_batch_packed`
    and the gate's twin instead."""
    return match_lanes(*_packed_args(points, mask, tables, init_poses,
                                     group), tables, grid, cfg, gate)


def match_batch(points, mask, ndt_map: ndt_grid.NDTMap, init_poses,
                grid: GridConfig, cfg: MatchConfig) -> MatchResult:
    """B concurrent registrations against one shared map."""
    table = ndt_grid.pack_quad(ndt_map, grid, compact=cfg.compact_table)
    return match_batch_packed(points, mask, table, init_poses, grid, cfg)


def match(points, mask, ndt_map: ndt_grid.NDTMap, init_pose, grid: GridConfig,
          cfg: MatchConfig) -> MatchResult:
    """Register one scan ``[N, 2]`` from ``init_pose [3]``."""
    res = match_batch(points[None], mask[None], ndt_map, init_pose[None],
                      grid, cfg)
    return MatchResult(*(a[0] for a in res))
