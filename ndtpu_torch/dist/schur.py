"""Separator partitions and segment-id assembly of normal-equation parts.

Port of the pieces of ``ndtpu/dist/schur.py`` that the single-card solves
use: the host-side partition plan (``SchurPlan``, ``plan_partition``; numpy,
once per topology, array for array equal to the reference's), which the
supernodal solve (``graph/supernodal.py``) builds on, and
``assemble_local_parts`` with ``INTERIOR``/``SEPARATOR`` for the
incremental smoother's k-hop local path. The distributed Schur solve itself
is ROADMAP A11. The local path reads only ``h_ii`` and ``b_i``:
:func:`assemble_local` builds just those (K7b ``csrc/local_system.cu`` on
the card, :func:`assemble_local_ref` on the CPU); the general function
stays for the distributed solve.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ndtpu_torch import kernels

__all__ = ["INTERIOR", "SEPARATOR", "SchurPlan", "plan_partition",
           "assemble_local_parts", "assemble_local", "assemble_local_ref"]

INTERIOR, SEPARATOR = 0, 1


class SchurPlan(NamedTuple):
    """Host-built static partition plan (numpy)."""

    n_shards: int
    ni: int               # padded interior slots per shard
    ns: int               # total separator count (padded to >= 1)
    fmax: int             # padded factors per shard
    pmax: int             # padded priors per shard
    # factor assignment [S, Fmax]:
    fac_idx: np.ndarray   # index into the global between-factor arrays
    fac_mask: np.ndarray  # bool
    i_role: np.ndarray    # INTERIOR/SEPARATOR of endpoint i
    i_loc: np.ndarray     # local slot (interior) or separator slot of i
    j_role: np.ndarray
    j_loc: np.ndarray
    # prior assignment [S, Pmax]:
    pri_idx: np.ndarray
    pri_mask: np.ndarray
    p_role: np.ndarray
    p_loc: np.ndarray
    # variable maps (padded slots hold pose 0, masked):
    int_global: np.ndarray  # [S, NI] global pose index per interior slot
    int_mask: np.ndarray    # [S, NI]
    sep_global: np.ndarray  # [NS]
    sep_mask: np.ndarray    # [NS]


def plan_partition(bet_i, bet_j, bet_mask, pri_idx, pri_mask, n_poses: int,
                   n_shards: int) -> SchurPlan:
    """Contiguous-range partition of poses ``0..n_poses-1`` into
    ``n_shards``; poses touched by a factor across shards are separators,
    the rest the interiors of their shard. Each live factor goes to the
    shard of its endpoint i, each live prior to its pose's shard."""
    bet_i, bet_j = np.asarray(bet_i), np.asarray(bet_j)
    bet_mask = np.asarray(bet_mask)
    pri_idx, pri_mask = np.asarray(pri_idx), np.asarray(pri_mask)

    shard_of = np.minimum(
        np.arange(n_poses) * n_shards // max(n_poses, 1), n_shards - 1)
    cross = bet_mask & (shard_of[bet_i] != shard_of[bet_j])
    is_sep = np.zeros(n_poses, bool)
    is_sep[bet_i[cross]] = True
    is_sep[bet_j[cross]] = True

    sep_ids = np.nonzero(is_sep)[0]
    ns = max(len(sep_ids), 1)
    sep_slot = np.full(n_poses, -1, np.int64)
    sep_slot[sep_ids] = np.arange(len(sep_ids))

    interiors = [np.nonzero((shard_of == s) & ~is_sep)[0]
                 for s in range(n_shards)]
    ni = max(1, max(len(x) for x in interiors))
    int_global = np.zeros((n_shards, ni), np.int32)
    int_mask = np.zeros((n_shards, ni), bool)
    int_slot = np.full(n_poses, -1, np.int64)
    for s, ids in enumerate(interiors):
        int_global[s, : len(ids)] = ids
        int_mask[s, : len(ids)] = True
        int_slot[ids] = np.arange(len(ids))

    def role_loc(pose_ids):
        role = np.where(is_sep[pose_ids], SEPARATOR, INTERIOR)
        loc = np.where(is_sep[pose_ids], sep_slot[pose_ids],
                       int_slot[pose_ids])
        return role.astype(np.int32), np.maximum(loc, 0).astype(np.int32)

    def assign(shard, live, cols):
        per = [np.nonzero(live & (shard == s))[0] for s in range(n_shards)]
        width = max(1, max(len(x) for x in per))
        idx = np.zeros((n_shards, width), np.int32)
        mask = np.zeros((n_shards, width), bool)
        out = [np.zeros((n_shards, width), np.int32)
               for _ in range(2 * len(cols))]
        for s, ids in enumerate(per):
            k = len(ids)
            idx[s, :k] = ids
            mask[s, :k] = True
            for c, pose_ids in enumerate(cols):
                out[2 * c][s, :k], out[2 * c + 1][s, :k] = \
                    role_loc(pose_ids[ids])
        return width, idx, mask, out

    fmax, fac_idx, fac_mask, (i_role, i_loc, j_role, j_loc) = assign(
        shard_of[bet_i], bet_mask, [bet_i, bet_j])
    pmax, pri_idx_a, pri_mask_a, (p_role, p_loc) = assign(
        shard_of[np.clip(pri_idx, 0, n_poses - 1)], pri_mask, [pri_idx])

    sep_mask = np.zeros(ns, bool)
    sep_mask[: len(sep_ids)] = True
    sep_global = np.zeros(ns, np.int32)
    sep_global[: len(sep_ids)] = sep_ids
    return SchurPlan(
        n_shards=n_shards, ni=ni, ns=ns, fmax=fmax, pmax=pmax,
        fac_idx=fac_idx, fac_mask=fac_mask,
        i_role=i_role, i_loc=i_loc, j_role=j_role, j_loc=j_loc,
        pri_idx=pri_idx_a, pri_mask=pri_mask_a, p_role=p_role, p_loc=p_loc,
        int_global=int_global, int_mask=int_mask,
        sep_global=sep_global, sep_mask=sep_mask)


def _seg_sum(vals, ids, n):
    """``segment_sum`` with ids ``>= n`` dropped (routed to a spare slot)."""
    ids = torch.where(ids < n, ids, torch.full_like(ids, n))
    out = torch.zeros(n + 1, dtype=vals.dtype, device=vals.device)
    return out.index_add_(0, ids, vals)[:-1]


def _block_ids(row, col, n_cols, match):
    """Flat ids of each 3 x 3 block's entries in a ``[3 rows, 3 n_cols]``
    target; unmatched blocks go past the end (dropped)."""
    comp = torch.arange(3, device=row.device)
    row = torch.where(match, row, torch.full_like(row, -1))
    ids = ((row[:, None, None] * 3 + comp[:, None]) * (3 * n_cols)
           + col[:, None, None] * 3 + comp[None, :])
    return torch.where(match[:, None, None], ids,
                       torch.full_like(ids, 2 ** 30)).reshape(-1)


def _vec_ids(row, match):
    comp = torch.arange(3, device=row.device)
    row = torch.where(match, row, torch.full_like(row, -1))
    ids = row[:, None] * 3 + comp[None, :]
    return torch.where(match[:, None], ids,
                       torch.full_like(ids, 2 ** 30)).reshape(-1)


def _local_blocks(ai, aj, r, ap, rp, s_fac_mask, s_i_role, s_i_loc,
                  s_j_role, s_j_loc, s_pri_mask, s_p_role, s_p_loc):
    """Every 3x3 block ``G_a^T G_b`` of a local linearization with its row
    and column role and slot and its mask, and every 3-vector ``G^T r``
    likewise: ``((ra, la, rb, lb, vals, valid), (rv, lv, vecs, validv))``."""
    ra = torch.cat([s_i_role, s_i_role, s_j_role, s_j_role, s_p_role])
    la = torch.cat([s_i_loc, s_i_loc, s_j_loc, s_j_loc, s_p_loc])
    rb = torch.cat([s_i_role, s_j_role, s_i_role, s_j_role, s_p_role])
    lb = torch.cat([s_i_loc, s_j_loc, s_i_loc, s_j_loc, s_p_loc])
    ga = torch.cat([ai, ai, aj, aj, ap])
    gb = torch.cat([ai, aj, ai, aj, ap])
    valid = torch.cat([s_fac_mask] * 4 + [s_pri_mask])
    vals = (ga.transpose(-1, -2) @ gb).reshape(-1)              # [K * 9]
    res = torch.cat([r, r, rp])
    rv = torch.cat([s_i_role, s_j_role, s_p_role])
    lv = torch.cat([s_i_loc, s_j_loc, s_p_loc])
    gv = torch.cat([ai, aj, ap])
    validv = torch.cat([s_fac_mask, s_fac_mask, s_pri_mask])
    vecs = (gv * res[..., :, None]).sum(-2).reshape(-1)         # [K * 3]
    return (ra, la, rb, lb, vals, valid), (rv, lv, vecs, validv)


def assemble_local_ref(ni, *parts):
    """The plain version of K7b (CPU path and oracle): ``(h_ii [3ni, 3ni],
    b_i [3ni])`` of :func:`assemble_local_parts`, without the separator
    parts, by the same segment sums. ``parts`` are its arguments from
    ``ai`` to ``s_p_loc``."""
    (ra, la, rb, lb, vals, valid), (rv, lv, vecs, validv) = \
        _local_blocks(*parts)
    ii = (ra == INTERIOR) & (rb == INTERIOR) & valid
    h_ii = _seg_sum(vals, _block_ids(la, lb, ni, ii), ni * ni * 9)
    b_i = _seg_sum(vecs, _vec_ids(lv, (rv == INTERIOR) & validv), ni * 3)
    return h_ii.reshape(3 * ni, 3 * ni), b_i


def assemble_local(ni, ai, aj, r, ap, rp, s_fac_mask, s_i_role, s_i_loc,
                   s_j_role, s_j_loc, s_pri_mask, s_p_role, s_p_loc):
    """K7b wrapper: the local system ``(h_ii, b_i)`` of ``ni`` interior
    poses. CUDA tensors go to the kernel (no float atomics: the same on
    every launch), CPU tensors to :func:`assemble_local_ref`."""
    if not ai.is_cuda:
        return assemble_local_ref(ni, ai, aj, r, ap, rp, s_fac_mask,
                                  s_i_role, s_i_loc, s_j_role, s_j_loc,
                                  s_pri_mask, s_p_role, s_p_loc)
    return kernels.local_assemble(ni, ai, aj, r, ap, rp, s_fac_mask,
                                  s_i_role, s_i_loc, s_j_role, s_j_loc,
                                  s_pri_mask, s_p_role, s_p_loc)


def assemble_local_parts(ni, ns, ai, aj, r, ap, rp, s_fac_mask,
                         s_i_role, s_i_loc, s_j_role, s_j_loc,
                         s_pri_mask, s_p_role, s_p_loc, dt):
    """``(h_ii [3ni,3ni], h_is [3ni,3ns], h_ss [3ns,3ns], b_i [3ni],
    b_s [3ns])`` from a local linearization, each 3x3 factor block routed
    by a flat segment id into its target (no dense local matrix)."""
    (ra, la, rb, lb, vals, valid), (rv, lv, vecs, validv) = _local_blocks(
        ai, aj, r, ap, rp, s_fac_mask, s_i_role, s_i_loc, s_j_role, s_j_loc,
        s_pri_mask, s_p_role, s_p_loc)
    ii = (ra == INTERIOR) & (rb == INTERIOR) & valid
    is_ = (ra == INTERIOR) & (rb == SEPARATOR) & valid
    ss = (ra == SEPARATOR) & (rb == SEPARATOR) & valid
    h_ii = _seg_sum(vals, _block_ids(la, lb, ni, ii), ni * ni * 9)
    h_is = _seg_sum(vals, _block_ids(la, lb, ns, is_), ni * ns * 9)
    h_ss = _seg_sum(vals, _block_ids(la, lb, ns, ss), ns * ns * 9)
    b_i = _seg_sum(vecs, _vec_ids(lv, (rv == INTERIOR) & validv), ni * 3)
    b_s = _seg_sum(vecs, _vec_ids(lv, (rv == SEPARATOR) & validv), ns * 3)
    return (h_ii.reshape(3 * ni, 3 * ni), h_is.reshape(3 * ni, 3 * ns),
            h_ss.reshape(3 * ns, 3 * ns), b_i, b_s)
