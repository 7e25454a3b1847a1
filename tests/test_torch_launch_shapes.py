"""K9a/K9c's, K12's and K13's launch shapes on the CPU, and a model of
K13's table.

- ``stream_wide`` of ``csrc/supernodal.cu``, read from the source: K9a
  and K9c keep 32-bit offsets at config 4's and config 5's sizes and take
  their 64-bit instantiation exactly where a target stream (``h_ss`` at
  15,447 separators, a rank's ``h_ii`` at 15,447 interior poses) reaches
  int's range.

- ``kernels.sgh_spread``: K12's threads per pose (128 R, one beam each)
  at config 5's calls and around the card's thread budget; the stored
  terms of every R fit one block's shared memory. No result depends on R
  (the card tests hold every R bit-equal).
- ``kernels.voxel_smem`` against the expression of
  ``csrc/voxel_downsample.cu``'s ``voxel_smem``, read from the source (as
  ``tests/test_torch_select_route.py`` reads ``select_smem``), and
  ``kernels.voxel_route`` on both sides of the table route's limit (19,370
  points a scan) and at the scan route's (58,112).
- A numpy model of the table route's arithmetic (the run heads, the
  Fibonacci home slot, linear probing, a claim or a lowered minimum per
  head in any order of the atomics, then the look-up) against
  ``voxel_downsample_ref``: the same mask at every order.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from ndtpu_torch import kernels
from ndtpu_torch.data import preprocess

SMS = 132                    # an H100 SXM's multiprocessors
ASM_CHUNKS = (2048, 4096, 12288)   # K9a's, K9c's and the sweep's largest


def _c_stream_wide():
    """``stream_wide(n, pitch, chunk)`` of ``csrc/supernodal.cu``, as
    Python."""
    src = (Path(kernels.__file__).parent / "csrc"
           / "supernodal.cu").read_text()
    expr = re.search(r"inline bool stream_wide\(long long n, int pitch, "
                     r"int chunk\) \{\s*return (.*?);", src, re.S).group(1)
    py = " ".join(expr.split()).replace("LL", "")
    return lambda n, pitch, chunk: eval(py, {}, dict(n=n, pitch=pitch,
                                                     chunk=chunk))


def _wide(n_shards, ni, nsl, ns, chunk):
    """The launcher's choice: any of the three streams (h_ii, h_is, h_ss:
    rows of 3w floats, w = 3ni, 3nsl, 3ns) wide."""
    wide = _c_stream_wide()
    return any(wide(9 * w * rows, 9 * w, chunk) for w, rows in
               ((ni, n_shards * ni), (nsl, n_shards * ni), (ns, ns)))


@pytest.mark.parametrize("chunk", ASM_CHUNKS)
def test_assemble_offsets_narrow_at_the_published_sizes(chunk):
    """32-bit offsets at config 4's 10k graph (P = 64: ni 155, nsl 51, ns
    558) and on two ranks of a 2,048-pose graph (ni 991, ns 67), up to
    15,446 separators or interior poses a rank."""
    assert not _wide(64, 155, 51, 558, chunk)
    assert not _wide(1, 991, 67, 67, chunk)
    assert not _wide(1, 10, 15446, 15446, chunk)
    assert not _wide(1, 15446, 36, 36, chunk)


@pytest.mark.parametrize("chunk", ASM_CHUNKS)
def test_assemble_offsets_wide_past_2_31_floats(chunk):
    """64-bit offsets from 15,447 separators (h_ss 9 ns^2 >= 2^31 floats)
    or interior poses on a rank (K9c's h_ii), at the card test's 32,000-pose
    rank (ni 15,982), and for K9a's h_ii at P 9 ni^2 >= 2^31."""
    assert _wide(1, 10, 15447, 15447, chunk)
    assert _wide(1, 15447, 36, 36, chunk)
    assert _wide(1, 15982, 36, 36, chunk)
    assert _wide(64, 1931, 51, 558, chunk)
    assert not _wide(64, 1930, 51, 558, chunk)


@pytest.mark.parametrize("b,n,spread", [
    (4624, 360, 1),          # config 5's coarse call: the poses fill the card
    (64, 360, 3),            # its refine call: one beam per thread
    (1, 360, 3),
    (1, 1, 1),
    (63, 129, 2),
    (64, 1100, 8),           # past 1,024 beams: chunks of 1,024
    (528, 360, 2),           # the poses' threads fill 1,024 per SM
    (1056, 360, 1),
])
def test_sgh_spread(b, n, spread):
    assert kernels.sgh_spread(b, n, SMS) == spread


def test_sgh_spread_fits_a_block():
    """Every R the wrapper can pick stores its terms within a block's
    shared memory, at both overlaps, and R never passes one beam a
    thread."""
    for g in (4, 1):
        for r in range(1, kernels.LM_MAX_SPREAD + 1):
            assert kernels.wide_terms_bytes(g, r) <= kernels.SMEM_MAX - 1024
    for b in (1, 7, 64, 100, 1000, 4624, 100_000):
        for n in (1, 100, 128, 129, 360, 1024, 5000):
            r = kernels.sgh_spread(b, n, SMS)
            assert 1 <= r <= min(-(-n // 128), kernels.LM_MAX_SPREAD)


def _c_voxel_smem():
    """``voxel_smem(n, route)`` of ``csrc/voxel_downsample.cu``, as
    Python."""
    src = (Path(kernels.__file__).parent / "csrc"
           / "voxel_downsample.cu").read_text()
    expr = re.search(r"inline long long voxel_smem\(int n, int route\) "
                     r"\{\s*return (.*?);", src, re.S).group(1)
    cond, a, b = re.fullmatch(r"(.*?) \? (.*?) : (.*)",
                              " ".join(expr.split())).groups()
    py = f"({a}) if ({cond}) else ({b})".replace("LL", "")
    return lambda n, route: eval(py, {}, dict(n=n, route=route))


@pytest.mark.parametrize("n", [1, 360, 4096, 19370, 19371, 58112])
def test_voxel_smem_matches_the_kernels_layout(n):
    c_smem = _c_voxel_smem()
    assert kernels.voxel_smem(n) == c_smem(n, 0) == 12 * n
    assert kernels.voxel_smem(n, "scan") == c_smem(n, 1) == 4 * n


@pytest.mark.parametrize("n,route", [
    (1, "table"), (360, "table"), (4096, "table"),
    (19370, "table"),        # the last that one scan's table fits
    (19371, "scan"), (58112, "scan"),
])
def test_voxel_route(n, route):
    """The table route wherever one scan's ids and table fit a block; past
    it the scan route, which fits up to 58,112 points (the wrapper raises
    past that)."""
    assert kernels.voxel_route(n) == route
    assert (kernels.voxel_smem(n) <= kernels.SMEM_MAX) == (route == "table")
    assert kernels.voxel_smem(n, "scan") <= kernels.SMEM_MAX
    assert kernels.voxel_smem(58113, "scan") > kernels.SMEM_MAX


_HALF = 1 << 14
_SENTINEL = (2 * _HALF) ** 2
_EMPTY = 0x7FFFFFFF


def _ids(points, mask, voxel):
    """The kernels' voxel ids (f32 division, floor, clip, pack)."""
    q = np.clip(np.floor(points / np.float32(voxel)), -_HALF, _HALF - 1)
    q = q.astype(np.int64) + _HALF
    return np.where(mask, q[..., 0] * 2 * _HALF + q[..., 1], _SENTINEL)


def _home(idx, cap):
    return ((idx * 2654435769) % 2 ** 32 * cap) >> 32


def _table_model(ids, rng):
    """The table route on one scan's ids (one block): each valid point
    whose predecessor has another id (a run head) claims or lowers its
    voxel's slot, in a random order of the atomics; then the heads'
    look-up."""
    n = ids.size
    cap = 2 * n
    tab = np.full(cap, _EMPTY, np.int64)
    heads = [i for i in range(n) if ids[i] != _SENTINEL and not
             (i > 0 and ids[i - 1] == ids[i])]
    for i in rng.permutation(heads):
        h = _home(ids[i], cap)
        while True:
            v = tab[h]
            if v == _EMPTY:
                tab[h] = i
                break
            if ids[v] == ids[i]:
                tab[h] = min(v, i)
                break
            h = (h + 1) % cap
    keep = np.zeros(n, bool)
    for i in heads:
        h = _home(ids[i], cap)
        while ids[tab[h]] != ids[i]:
            h = (h + 1) % cap
        keep[i] = tab[h] == i
    return keep


@pytest.mark.parametrize("voxel", [0.001, 0.1, 5.0])
@pytest.mark.parametrize("n,scans", [(1, 1), (33, 3), (360, 2), (700, 1)])
@pytest.mark.parametrize("kind", ["uniform", "sweep"])
def test_voxel_table_model_matches_plain(n, scans, voxel, kind):
    """The table route's model equals ``voxel_downsample_ref`` at three
    orders of the atomics, on seeded scans with 10% of the points masked
    out and the first scan's first half invalid: points uniform in a +-15
    m box, or a lidar-like sweep (1.2 turns of a wavy ring, so neighbouring
    beams share voxels in runs and the last fifth revisits the first)."""
    rng = np.random.default_rng(n + scans)
    if kind == "uniform":
        pts = rng.uniform(-15.0, 15.0, (scans, n, 2))
    else:
        th = np.linspace(0.0, 2.4 * np.pi, n)[None] + rng.uniform(
            0, 1, (scans, 1))
        r = 5.0 + 3.0 * np.sin(3.0 * th) + rng.normal(0, 0.01, (scans, n))
        pts = np.stack([r * np.cos(th), r * np.sin(th)], -1)
    pts = pts.astype(np.float32)
    mask = rng.random((scans, n)) > 0.1
    mask[0, :n // 2] = False
    ref = preprocess.voxel_downsample_ref(torch.as_tensor(pts),
                                          torch.as_tensor(mask), voxel)
    ids = _ids(pts, mask, voxel)
    for seed in range(3):
        rng = np.random.default_rng(seed)
        got = np.stack([_table_model(row, rng) for row in ids])
        assert np.array_equal(got, ref.numpy())
