"""``lm_ndt``'s launch shape, on the CPU: how many threads per lane
(``kernels.lm_spread``: 128 R, one beam each) and how much shared memory
(``kernels.lm_smem``) the wrapper asks for, against the kernel's own
layout read from ``csrc/ndt_sums.cuh``. No result depends on R (the sums
are K1's, bit for bit, at every R; the card tests hold that), so these
pin only the shape: one beam per thread while the lanes leave the card
room, K1's 128 threads once the lanes fill it, and never past the
shared memory one block can have.

K10c ``slab_sgh`` runs the same scheme at one pose: ``kernels.slab_spread``
(128 R threads, one beam each, R = min(ceil(n / 128), 8)) and the stored
terms of 128 (R - 1) beams with a grid-mask byte each
(``kernels.wide_terms_bytes``), the bound its launcher in
``csrc/ndt_unpacked.cu`` checks."""

import re
from pathlib import Path

import pytest

from ndtpu_torch import kernels

SMS = 132                    # an H100 SXM's multiprocessors


def _c_wide_terms_bytes():
    """``wide_terms_bytes(grids, spread)`` of ``csrc/ndt_sums.cuh``, with
    its ``wide_beam_floats``, as Python."""
    src = (Path(kernels.__file__).parent / "csrc" / "ndt_sums.cuh").read_text()
    beam = re.search(r"wide_beam_floats\(int grids\) \{\s*return (.*?);",
                     src, re.S).group(1)
    terms = re.search(r"wide_terms_bytes\(int grids, int spread\) \{\s*"
                      r"return (.*?);", src, re.S).group(1)
    beam = " ".join(beam.split()).replace("grids == 4 ? 52 : 12",
                                          "(52 if grids == 4 else 12)")
    terms = " ".join(terms.split()).replace(
        "wide_beam_floats(grids)", f"({beam})").replace("kNdtThreads", "128")
    return lambda grids, spread: eval(terms, {}, dict(grids=grids,
                                                      spread=spread))


@pytest.mark.parametrize("b,n,grids,spread", [
    (8, 360, 4, 3),          # the config-2 window: one beam per thread
    (8, 720, 4, 6),
    (8, 1100, 4, 8),         # past 1,024 beams: chunks of 1,024
    (64, 360, 4, 3),         # the config-3 verify
    (64, 360, 1, 3),
    (1, 90, 4, 1),           # fewer beams than one chunk of 128
    (528, 360, 4, 2),        # the lanes' threads fill 1,024 per SM
    (1056, 360, 4, 1),
    (4096, 720, 4, 1),       # bench.py's headline: K1's 128 threads
])
def test_lm_spread(b, n, grids, spread):
    assert kernels.lm_spread(b, n, grids, SMS) == spread
    assert kernels.lm_smem(n, grids, spread) <= kernels.SMEM_MAX - 1024


@pytest.mark.parametrize("grids", [4, 1])
@pytest.mark.parametrize("spread", range(1, kernels.LM_MAX_SPREAD + 1))
def test_lm_smem_matches_the_kernels_layout(grids, spread):
    """12 B per beam and the stored terms of 128 (R - 1) beams, as the
    kernel lays them out (``wide_terms_bytes``)."""
    c_terms = _c_wide_terms_bytes()
    for n in (1, 360, 1100):
        assert kernels.lm_smem(n, grids, spread) == 12 * n + c_terms(grids,
                                                                     spread)


@pytest.mark.parametrize("grids", [4, 1])
def test_lm_spread_stays_within_shared_memory(grids):
    """At 8 lanes R is one beam per thread, min(ceil(n / 128), 8), or the
    largest below that fits, down to 1 (K1's 12 B per beam); the wrapper
    refuses only where even R = 1 is over the limit."""
    limit = kernels.SMEM_MAX - 1024
    for n in range(1, limit // 12 + 1, 97):
        r = kernels.lm_spread(8, n, grids, SMS)
        want = min(-(-n // 128), kernels.LM_MAX_SPREAD)
        assert 1 <= r <= want and kernels.lm_smem(n, grids, r) <= limit
        assert r == want or kernels.lm_smem(n, grids, r + 1) > limit
    assert kernels.lm_spread(8, limit // 12 + 1, grids, SMS) == 1
    assert kernels.lm_smem(limit // 12 + 1, grids, 1) > limit


@pytest.mark.parametrize("n,spread", [(1, 1), (128, 1), (129, 2),
                                      (360, 3), (1024, 8), (4000, 8)])
def test_slab_spread(n, spread):
    """One beam per thread up to 8 x 128 beams (config 5's 360: R = 3),
    then chunks of 1,024; within a block's shared memory at both
    overlaps."""
    assert kernels.slab_spread(n) == spread
    for grids in (4, 1):
        assert kernels.wide_terms_bytes(grids, spread) <= kernels.SMEM_MAX


@pytest.mark.parametrize("grids", [4, 1])
@pytest.mark.parametrize("spread", range(1, kernels.LM_MAX_SPREAD + 1))
def test_slab_smem_matches_the_kernels_layout(grids, spread):
    """K10c's shared memory, the stored terms of 128 (R - 1) beams
    (``wide_terms_bytes``), is the least the launcher of
    ``csrc/ndt_unpacked.cu`` takes."""
    assert kernels.wide_terms_bytes(grids, spread) == _c_wide_terms_bytes()(
        grids, spread)
    src = (Path(kernels.__file__).parent / "csrc"
           / "ndt_unpacked.cu").read_text()
    launcher = src[src.index('extern "C" int slab_sgh_launch'):]
    assert "smem_bytes < ndtpu::wide_terms_bytes(grids, spread)" in launcher
