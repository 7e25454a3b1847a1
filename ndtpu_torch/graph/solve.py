"""Pose-graph solvers: dense Gauss-Newton/LM and block-Jacobi PCG.

Port of ``ndtpu/graph/solve.py``. On the card the whole PCG solve is one
launch: of K6 (``csrc/pcg_solve.cu``: set-up, loop and stop test on the
device, in one block) where the graph fits one block's shared memory, of
K6g (``csrc/pcg_grid.cu``: the same across many SMs, cooperative) past it
(``kernels.pcg_route``); the multi-session ``pcg_rhs_blocked`` is one
launch of K6b (one block per session). On the CPU, and in ``optimize``, JAX's
``lax.while_loop`` becomes a loop of masked iterations: once a run's stop
test fires its carry is frozen, so extra iterations change nothing, and
the host checks for an early exit only every ``_SYNC_EVERY`` iterations.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ndtpu_torch import kernels
from ndtpu_torch.config import SolverConfig
from ndtpu_torch.graph import factors as fct
from ndtpu_torch.lie import se2

__all__ = ["SolveResult", "normal_equations", "hessian_matvec", "gradient",
           "block_diag_hessian", "solve_dense", "pcg", "pcg_rhs", "pcg_solve",
           "pcg_solve_ref", "pcg_rhs_blocked", "pcg_solve_blocked",
           "pcg_solve_blocked_ref", "optimize"]

_SYNC_EVERY = 10


class SolveResult(NamedTuple):
    graph: fct.PoseGraph
    chi2: torch.Tensor
    n_iter: torch.Tensor
    converged: torch.Tensor


def _apply_delta(poses, delta, mask):
    """Additive local update with angle wrap, masked to live poses."""
    new = poses + delta * mask.to(poses.dtype)[:, None]
    return torch.cat([new[:, :2], se2.wrap(new[:, 2:3])], -1)


def _btb(a, b):
    """``a^T b`` per factor: ``[F,3,3] x [F,3,3] -> [F,3,3]``."""
    return a.transpose(-1, -2) @ b


def _btv(a, v):
    """``a^T v`` per factor: ``[F,3,3] x [F,3] -> [F,3]``."""
    return (a * v[..., :, None]).sum(-2)


def _mv(a, v):
    return (a * v[..., None, :]).sum(-1)


def normal_equations(g: fct.PoseGraph, lin):
    """Dense ``H [3V, 3V]`` and ``b [3V]`` (``H delta = -b``)."""
    (ai, aj, r), (ap, rp) = lin
    v = g.poses.shape[0]
    h = torch.zeros((v, v, 3, 3), dtype=ai.dtype, device=ai.device)
    b = torch.zeros((v, 3), dtype=ai.dtype, device=ai.device)
    i, j, p = g.bet_i, g.bet_j, g.prior_idx
    h.index_put_((i, i), _btb(ai, ai), accumulate=True)
    h.index_put_((i, j), _btb(ai, aj), accumulate=True)
    h.index_put_((j, i), _btb(aj, ai), accumulate=True)
    h.index_put_((j, j), _btb(aj, aj), accumulate=True)
    h.index_put_((p, p), _btb(ap, ap), accumulate=True)
    b.index_add_(0, i, _btv(ai, r))
    b.index_add_(0, j, _btv(aj, r))
    b.index_add_(0, p, _btv(ap, rp))
    return h.permute(0, 2, 1, 3).reshape(3 * v, 3 * v), b.reshape(-1)


def hessian_matvec(g: fct.PoseGraph, lin, x):
    """Matrix-free ``H @ x`` over the factor SoA (x ``[V, 3]``)."""
    (ai, aj, r), (ap, rp) = lin
    yf = _mv(ai, x[g.bet_i]) + _mv(aj, x[g.bet_j])
    out = torch.zeros_like(x)
    out.index_add_(0, g.bet_i, _btv(ai, yf))
    out.index_add_(0, g.bet_j, _btv(aj, yf))
    yp = _mv(ap, x[g.prior_idx])
    out.index_add_(0, g.prior_idx, _btv(ap, yp))
    return out


def gradient(g: fct.PoseGraph, lin):
    """``b = A^T r`` as ``[V, 3]``."""
    (ai, aj, r), (ap, rp) = lin
    b = torch.zeros((g.poses.shape[0], 3), dtype=r.dtype, device=r.device)
    b.index_add_(0, g.bet_i, _btv(ai, r))
    b.index_add_(0, g.bet_j, _btv(aj, r))
    b.index_add_(0, g.prior_idx, _btv(ap, rp))
    return b


def block_diag_hessian(g: fct.PoseGraph, lin):
    """The ``[V, 3, 3]`` diagonal blocks of H."""
    (ai, aj, r), (ap, rp) = lin
    d = torch.zeros((g.poses.shape[0], 3, 3), dtype=r.dtype, device=r.device)
    d.index_add_(0, g.bet_i, _btb(ai, ai))
    d.index_add_(0, g.bet_j, _btb(aj, aj))
    d.index_add_(0, g.prior_idx, _btb(ap, ap))
    return d


def _inv3(a):
    """Batched closed-form 3x3 inverse (adjugate / determinant)."""
    c00 = a[..., 1, 1] * a[..., 2, 2] - a[..., 1, 2] * a[..., 2, 1]
    c01 = a[..., 1, 2] * a[..., 2, 0] - a[..., 1, 0] * a[..., 2, 2]
    c02 = a[..., 1, 0] * a[..., 2, 1] - a[..., 1, 1] * a[..., 2, 0]
    c10 = a[..., 0, 2] * a[..., 2, 1] - a[..., 0, 1] * a[..., 2, 2]
    c11 = a[..., 0, 0] * a[..., 2, 2] - a[..., 0, 2] * a[..., 2, 0]
    c12 = a[..., 0, 1] * a[..., 2, 0] - a[..., 0, 0] * a[..., 2, 1]
    c20 = a[..., 0, 1] * a[..., 1, 2] - a[..., 0, 2] * a[..., 1, 1]
    c21 = a[..., 0, 2] * a[..., 1, 0] - a[..., 0, 0] * a[..., 1, 2]
    c22 = a[..., 0, 0] * a[..., 1, 1] - a[..., 0, 1] * a[..., 1, 0]
    det = a[..., 0, 0] * c00 + a[..., 0, 1] * c01 + a[..., 0, 2] * c02
    det = torch.where(torch.abs(det) < 1e-30, torch.full_like(det, 1e-30),
                      det)
    adj = torch.stack([torch.stack([c00, c10, c20], -1),
                       torch.stack([c01, c11, c21], -1),
                       torch.stack([c02, c12, c22], -1)], -2)
    return adj / det[..., None, None]


def solve_dense(g: fct.PoseGraph, lin, lam):
    """One damped GN step by dense Cholesky; delta ``[V, 3]``."""
    h, b = normal_equations(g, lin)
    v = g.poses.shape[0]
    damp = lam * torch.clamp(torch.abs(torch.diagonal(h)), min=1e-8)
    live = g.pose_mask.to(h.dtype).repeat_interleave(3)
    hd = h + torch.diag(damp + (1.0 - live))
    l = torch.linalg.cholesky(hd)
    delta = torch.cholesky_solve(-b[:, None], l)[:, 0]
    return delta.reshape(v, 3)


def pcg(g: fct.PoseGraph, lin, lam, cfg: SolverConfig):
    """Damped-GN step by block-Jacobi preconditioned CG."""
    x, it, _ = pcg_solve(g, lin, None, lam, cfg.pcg_max_iter, cfg.pcg_tol)
    return x, it


def pcg_rhs(g: fct.PoseGraph, lin, rhs, lam, cfg: SolverConfig):
    """Solve ``(H + damping) x = rhs`` matrix-free; returns ``(x, iters)``.

    Stops at ``cfg.pcg_max_iter`` iterations or when ``|r|^2 <= (pcg_tol *
    |rhs|)^2``, exactly as the JAX ``while_loop``.
    """
    x, it, _ = pcg_solve(g, lin, rhs, lam, cfg.pcg_max_iter, cfg.pcg_tol)
    return x, it


def pcg_solve(g: fct.PoseGraph, lin, rhs, lam, max_iter: int, tol: float,
              damp_abs: float = 0.0):
    """K6 / K6g wrapper: the whole PCG solve. CUDA tensors go to a kernel
    (one launch, no host sync): K6 where ``kernels.pcg_route`` says the
    graph fits one block, K6g otherwise; CPU tensors to
    :func:`pcg_solve_ref`. ``rhs`` None means ``-gradient``. Returns ``(x
    [V, 3], iterations [] int32, max |M^-1 rhs| [])``; the last, with
    ``lam = 0``, ``damp_abs = 1e-8`` and ``max_iter = 0``, is the settled
    check's preconditioned step."""
    if not g.poses.is_cuda:
        return pcg_solve_ref(g, lin, rhs, lam, max_iter, tol, damp_abs)
    route = kernels.pcg_route(g.poses.shape[0], g.bet_i.shape[0],
                              g.prior_idx.shape[0])
    solve = kernels.pcg_solve if route == "block" else kernels.pcg_solve_grid
    return solve(g.bet_i, g.bet_j, g.bet_mask, g.prior_idx, g.prior_mask,
                 g.pose_mask, lin, rhs, lam, max_iter, tol, damp_abs)


def pcg_solve_ref(g: fct.PoseGraph, lin, rhs, lam, max_iter: int,
                  tol: float, damp_abs: float = 0.0):
    """The plain version of K6 and K6g (CPU path and oracle): a loop of masked
    iterations; once the stop test fires the carry stays frozen, as in the
    JAX ``while_loop``, and the host checks for an early exit every
    ``_SYNC_EVERY`` iterations. The damping is ``lam * max(|diag H|, 1e-8)
    + damp_abs`` (+ 1 on dead poses)."""
    if rhs is None:
        rhs = -gradient(g, lin)
    dblocks = block_diag_hessian(g, lin)
    dt = rhs.dtype
    eye = torch.eye(3, dtype=dt, device=rhs.device)
    dd = torch.abs(torch.diagonal(dblocks, dim1=-2, dim2=-1))
    damp = (lam * torch.clamp(dd, min=1e-8)
            + (damp_abs + (1.0 - g.pose_mask.to(dt)))[:, None])
    minv = _inv3(dblocks + damp[..., None] * eye)

    def amul(x):
        return hessian_matvec(g, lin, x) + damp * x

    x = torch.zeros_like(rhs)
    r = rhs
    z = _mv(minv, r)
    zmax = torch.max(torch.abs(z))
    p = z
    rz = torch.sum(r * z)
    bnorm = torch.sqrt(torch.sum(rhs * rhs))
    tol2 = (tol * torch.clamp(bnorm, min=1e-30)) ** 2
    it = torch.zeros((), dtype=torch.int32, device=rhs.device)
    for k in range(max_iter):
        active = torch.sum(r * r) > tol2
        if k % _SYNC_EVERY == 0 and not bool(active):
            break
        ap = amul(p)
        alpha = rz / torch.clamp(torch.sum(p * ap), min=1e-30)
        x_n = x + alpha * p
        r_n = r - alpha * ap
        z_n = _mv(minv, r_n)
        rz_new = torch.sum(r_n * z_n)
        beta = rz_new / torch.clamp(rz, min=1e-30)
        p_n = z_n + beta * p
        x = torch.where(active, x_n, x)
        r = torch.where(active, r_n, r)
        z = torch.where(active, z_n, z)
        p = torch.where(active, p_n, p)
        rz = torch.where(active, rz_new, rz)
        it = it + active.to(torch.int32)
    return x, it, zmax


def pcg_rhs_blocked(g: fct.PoseGraph, lin, rhs, lam, cfg: SolverConfig,
                    n_blocks: int):
    """Like :func:`pcg_rhs`, with per-block Krylov scalars, for a graph of
    ``n_blocks`` independent components laid out contiguously (the stacked
    multi-session flat graph, ``dist.slam_dp._flat_graph``): exactly
    ``n_blocks`` independent PCGs in lockstep. Global scalars would serve
    the dominant component and starve the others. ``lam`` is per pose
    ``[V, 1]``, each block's damping repeated over its poses as the JAX
    package's caller builds it (the solve reads each block's first);
    ``rhs`` None means ``-gradient``. Exactly ``cfg.pcg_max_iter``
    iterations, no tolerance stop. Returns ``(x [V, 3], cfg.pcg_max_iter
    as an int32 tensor)``."""
    lam8 = lam.reshape(n_blocks, -1)[:, 0]
    x = pcg_solve_blocked(g, lin, rhs, lam8, n_blocks, cfg.pcg_max_iter)
    return x, torch.full((), cfg.pcg_max_iter, dtype=torch.int32,
                         device=x.device)


def pcg_solve_blocked(g: fct.PoseGraph, lin, rhs, lam8, n_blocks: int,
                      max_iter: int):
    """K6b wrapper: ``n_blocks`` PCG solves with per-block scalars and
    ``lam8 [n_blocks]``. CUDA tensors go to the kernel (one launch, one
    block per component, no host sync), CPU tensors to
    :func:`pcg_solve_blocked_ref`. Returns ``x [V, 3]``."""
    if not g.poses.is_cuda:
        return pcg_solve_blocked_ref(g, lin, rhs, lam8, n_blocks, max_iter)
    return kernels.pcg_solve_blocked(g.bet_i, g.bet_j, g.bet_mask,
                                     g.prior_idx, g.prior_mask, g.pose_mask,
                                     lin, rhs, lam8.contiguous(), n_blocks,
                                     max_iter)


def pcg_solve_blocked_ref(g: fct.PoseGraph, lin, rhs, lam8, n_blocks: int,
                          max_iter: int):
    """The plain version of K6b (CPU path and oracle), ``pcg_rhs_blocked``
    as the JAX package writes it: ``damp = lam max(|diag|, 1e-8) + (1 -
    pose_mask)``, ``alpha = rz / max(p.Ap, 1e-30)``, ``beta = rz_new /
    max(rz, 1e-30)``, every dot product per block."""
    if rhs is None:
        rhs = -gradient(g, lin)
    v = rhs.shape[0]
    v_blk = v // n_blocks
    dt = rhs.dtype

    def bsum(a):                                   # [V, 3] -> [B, 1, 1]
        return a.reshape(n_blocks, v_blk * 3).sum(1)[:, None, None]

    def bexp(sc):                                  # [B, 1, 1] -> [V, 1]
        return sc.expand(n_blocks, v_blk, 1).reshape(v, 1)

    lam_v = lam8.to(dt).repeat_interleave(v_blk)[:, None]
    dblocks = block_diag_hessian(g, lin)
    eye = torch.eye(3, dtype=dt, device=rhs.device)
    dd = torch.abs(torch.diagonal(dblocks, dim1=-2, dim2=-1))
    damp = (lam_v * torch.clamp(dd, min=1e-8)
            + (1.0 - g.pose_mask.to(dt))[:, None])
    minv = _inv3(dblocks + damp[..., None] * eye)
    x = torch.zeros_like(rhs)
    r = rhs
    z = _mv(minv, r)
    p = z
    rz = bsum(r * z)
    for _ in range(max_iter):
        ap = hessian_matvec(g, lin, p) + damp * p
        alpha = rz / torch.clamp(bsum(p * ap), min=1e-30)
        x = x + bexp(alpha) * p
        r = r - bexp(alpha) * ap
        z = _mv(minv, r)
        rz_new = bsum(r * z)
        beta = rz_new / torch.clamp(rz, min=1e-30)
        p = z + bexp(beta) * p
        rz = rz_new
    return x


def optimize(g: fct.PoseGraph, cfg: SolverConfig, method: str = "dense",
             huber_delta: float = 0.0) -> SolveResult:
    """Full nonlinear LM optimization (``method``: "dense" or "pcg")."""
    dt = g.poses.dtype
    dev = g.poses.device
    chi = fct.chi2(g, huber_delta)
    lam = torch.full((), cfg.init_lambda, dtype=dt, device=dev)
    it = torch.zeros((), dtype=torch.int32, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    graph = g
    for k in range(cfg.max_iter):
        # At k = 0 nothing is done yet: the first check reads after
        # _SYNC_EVERY iterations.
        if k and k % _SYNC_EVERY == 0 and bool(done):
            break
        active = ~done
        lin = fct.linearize(graph, huber_delta)
        if method == "dense":
            delta = solve_dense(graph, lin, lam)
        else:
            delta, _ = pcg(graph, lin, lam, cfg)
        trial = graph._replace(
            poses=_apply_delta(graph.poses, delta, graph.pose_mask))
        chi_t = fct.chi2(trial, huber_delta)
        accept = active & (chi_t < chi)
        graph = graph._replace(poses=torch.where(accept, trial.poses,
                                                 graph.poses))
        chi = torch.where(accept, chi_t, chi)
        lam_n = torch.where(accept,
                            torch.clamp(lam / cfg.lambda_down, min=1e-12),
                            lam * cfg.lambda_up)
        lam = torch.where(active, lam_n, lam)
        small = torch.sqrt(torch.sum(delta * delta)) < cfg.tol
        done = done | (active & (small | (lam > 1e8)))
        it = it + active.to(torch.int32)
    return SolveResult(graph=graph, chi2=chi, n_iter=it,
                       converged=done & (lam <= 1e8))
