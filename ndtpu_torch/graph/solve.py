"""Pose-graph solvers: dense Gauss-Newton/LM and block-Jacobi PCG.

Port of ``ndtpu/graph/solve.py`` (all but the multi-session
``pcg_rhs_blocked``, ROADMAP A9). JAX's ``lax.while_loop`` in ``pcg_rhs``
and ``optimize`` becomes a loop of masked iterations: once a run's stop
test fires its carry is frozen, so extra iterations change nothing, and
the host checks for an early exit only every ``_SYNC_EVERY`` iterations.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ndtpu_torch.config import SolverConfig
from ndtpu_torch.graph import factors as fct
from ndtpu_torch.lie import se2

__all__ = ["SolveResult", "normal_equations", "hessian_matvec", "gradient",
           "block_diag_hessian", "solve_dense", "pcg", "pcg_rhs", "optimize"]

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
    return pcg_rhs(g, lin, -gradient(g, lin), lam, cfg)


def pcg_rhs(g: fct.PoseGraph, lin, rhs, lam, cfg: SolverConfig):
    """Solve ``(H + damping) x = rhs`` matrix-free; returns ``(x, iters)``.

    Stops at ``cfg.pcg_max_iter`` iterations or when ``|r|^2 <= (pcg_tol *
    |rhs|)^2``, exactly as the JAX ``while_loop``: after the stop test fires
    the carry stays frozen.
    """
    dblocks = block_diag_hessian(g, lin)
    dt = rhs.dtype
    eye = torch.eye(3, dtype=dt, device=rhs.device)
    dd = torch.abs(torch.diagonal(dblocks, dim1=-2, dim2=-1))
    damp = (lam * torch.clamp(dd, min=1e-8)
            + (1.0 - g.pose_mask.to(dt))[:, None])
    minv = _inv3(dblocks + damp[..., None] * eye)

    def amul(x):
        return hessian_matvec(g, lin, x) + damp * x

    x = torch.zeros_like(rhs)
    r = rhs
    z = _mv(minv, r)
    p = z
    rz = torch.sum(r * z)
    bnorm = torch.sqrt(torch.sum(rhs * rhs))
    tol2 = (cfg.pcg_tol * torch.clamp(bnorm, min=1e-30)) ** 2
    it = torch.zeros((), dtype=torch.int32, device=rhs.device)
    for k in range(cfg.pcg_max_iter):
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
    return x, it


def optimize(g: fct.PoseGraph, cfg: SolverConfig, method: str = "dense",
             huber_delta: float = 0.0) -> SolveResult:
    """Full nonlinear LM optimization (``method``: "dense" or "pcg")."""
    dt = g.poses.dtype
    dev = g.poses.device
    chi = fct.chi2(g, huber_delta)
    lam = torch.tensor(cfg.init_lambda, dtype=dt, device=dev)
    it = torch.zeros((), dtype=torch.int32, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    graph = g
    for k in range(cfg.max_iter):
        if k % _SYNC_EVERY == 0 and bool(done):
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
