"""Segment-id assembly of local normal-equation parts.

Port of the two pieces of ``ndtpu/dist/schur.py`` that the incremental
smoother's k-hop local path uses (``INTERIOR``/``SEPARATOR`` and
``assemble_local_parts``); the distributed Schur solve itself is ROADMAP
A11. The local path reads only ``h_ii`` and ``b_i``:
:func:`assemble_local` builds just those (K7b ``csrc/local_system.cu`` on
the card, :func:`assemble_local_ref` on the CPU); the general function
stays for the distributed solve.
"""

from __future__ import annotations

import torch

from ndtpu_torch import kernels

__all__ = ["INTERIOR", "SEPARATOR", "assemble_local_parts", "assemble_local",
           "assemble_local_ref"]

INTERIOR, SEPARATOR = 0, 1


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
