"""Segment-id assembly of local normal-equation parts.

Port of the two pieces of ``ndtpu/dist/schur.py`` that the incremental
smoother's k-hop local path uses (``INTERIOR``/``SEPARATOR`` and
``assemble_local_parts``); the distributed Schur solve itself is ROADMAP
A11.
"""

from __future__ import annotations

import torch

__all__ = ["INTERIOR", "SEPARATOR", "assemble_local_parts"]

INTERIOR, SEPARATOR = 0, 1


def _seg_sum(vals, ids, n):
    """``segment_sum`` with ids ``>= n`` dropped (routed to a spare slot)."""
    ids = torch.where(ids < n, ids, torch.full_like(ids, n))
    out = torch.zeros(n + 1, dtype=vals.dtype, device=vals.device)
    return out.index_add_(0, ids, vals)[:-1]


def assemble_local_parts(ni, ns, ai, aj, r, ap, rp, s_fac_mask,
                         s_i_role, s_i_loc, s_j_role, s_j_loc,
                         s_pri_mask, s_p_role, s_p_loc, dt):
    """``(h_ii [3ni,3ni], h_is [3ni,3ns], h_ss [3ns,3ns], b_i [3ni],
    b_s [3ns])`` from a local linearization, each 3x3 factor block routed
    by a flat segment id into its target (no dense local matrix)."""
    dev = ai.device
    big = 2 ** 30
    ra = torch.cat([s_i_role, s_i_role, s_j_role, s_j_role, s_p_role])
    la = torch.cat([s_i_loc, s_i_loc, s_j_loc, s_j_loc, s_p_loc])
    rb = torch.cat([s_i_role, s_j_role, s_i_role, s_j_role, s_p_role])
    lb = torch.cat([s_i_loc, s_j_loc, s_i_loc, s_j_loc, s_p_loc])
    ga = torch.cat([ai, ai, aj, aj, ap])
    gb = torch.cat([ai, aj, ai, aj, ap])
    valid = torch.cat([s_fac_mask] * 4 + [s_pri_mask])
    blocks = ga.transpose(-1, -2) @ gb                          # [K, 3, 3]
    a_comp = torch.arange(3, device=dev)[:, None]
    b_comp = torch.arange(3, device=dev)[None, :]

    def flat_ids(row, col, n_cols, match):
        row = torch.where(match, row, torch.full_like(row, -1))
        ids = ((row[:, None, None] * 3 + a_comp) * (3 * n_cols)
               + col[:, None, None] * 3 + b_comp)
        return torch.where(match[:, None, None], ids,
                           torch.full_like(ids, big)).reshape(-1)

    vals = blocks.reshape(-1)
    ii = (ra == INTERIOR) & (rb == INTERIOR) & valid
    is_ = (ra == INTERIOR) & (rb == SEPARATOR) & valid
    ss = (ra == SEPARATOR) & (rb == SEPARATOR) & valid
    h_ii = _seg_sum(vals, flat_ids(la, lb, ni, ii), ni * ni * 9)
    h_is = _seg_sum(vals, flat_ids(la, lb, ns, is_), ni * ns * 9)
    h_ss = _seg_sum(vals, flat_ids(la, lb, ns, ss), ns * ns * 9)

    res = torch.cat([r, r, rp])
    rv = torch.cat([s_i_role, s_j_role, s_p_role])
    lv = torch.cat([s_i_loc, s_j_loc, s_p_loc])
    gv = torch.cat([ai, aj, ap])
    validv = torch.cat([s_fac_mask, s_fac_mask, s_pri_mask])
    vecs = (gv * res[..., :, None]).sum(-2).reshape(-1)         # [K*3]
    comp = torch.arange(3, device=dev)[None, :]

    def vec_ids(row, match):
        row = torch.where(match, row, torch.full_like(row, -1))
        ids = row[:, None] * 3 + comp
        return torch.where(match[:, None], ids,
                           torch.full_like(ids, big)).reshape(-1)

    b_i = _seg_sum(vecs, vec_ids(lv, (rv == INTERIOR) & validv), ni * 3)
    b_s = _seg_sum(vecs, vec_ids(lv, (rv == SEPARATOR) & validv), ns * 3)
    return (h_ii.reshape(3 * ni, 3 * ni), h_is.reshape(3 * ni, 3 * ns),
            h_ss.reshape(3 * ns, 3 * ns), b_i, b_s)
