"""K10a slab_accumulate's host-side tile plan and work buffer, on the CPU.

``kernels.slab_tiles`` against ``slab_tile_plan`` of
``csrc/slab_accum.cu`` (its constants and shared-memory budget read from
the source, as ``tests/test_torch_select_route.py`` reads K7a's): for the
slabs phase 15 builds (rank 0's halo-extended slab at both overlaps, the
replicated one), ``profile_port.py --hot``'s, the card tests' and slabs
past one tile in y (ny beyond 16 rows) and in x, the tiles cover every
cell of the slab exactly once, each within the 256 cells whose sums the
kernel keeps in shared memory, every tile's cell index fits its byte, and
the bin and sum blocks' shared memory fits what one block can have, with
the counters and segment offsets in shared memory where they fit and in
the work buffer past that (a slab past ``SLAB_MAX_TILES``, 60 M points). No
result depends on the plan: the card tests hold K10a bit-equal to its
fixed-point model on each.
"""

import re
from pathlib import Path

import numpy as np
import pytest

from ndtpu_torch import kernels

SRC = (Path(kernels.__file__).parent / "csrc" / "slab_accum.cu").read_text()


def _const(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", SRC).group(1))


#: (G, width, ny): phase 15's rank 0 halo-extended slab at overlaps 4 and 1
#: and its replicated slab, --hot's slab, the card tests' slabs, and slabs
#: past one tile in y, in x, and both.
SHAPES = [(4, 282, 256), (1, 280, 256), (4, 128, 256), (4, 216, 256),
          (1, 216, 256), (4, 24, 48), (4, 30, 48), (4, 34, 48), (1, 34, 48),
          (4, 100, 80), (4, 64, 80), (1, 100, 80), (4, 40, 300),
          (1, 3, 1000), (1, 1, 1), (4, 1, 7), (1, 500, 9),
          (4, 2048, 1024), (4, 2000, 1024), (1, 2048, 1024)]


def test_constants_match_the_source():
    assert kernels.SLAB_TILE_CELLS == _const("kTileCells") == 256
    assert kernels.SLAB_TILE_ROWS == _const("kTileRows")
    assert kernels.SLAB_BIN_CHUNK == _const("kBinChunk")
    assert kernels.SMEM_MAX == _const("kSmemMax")
    expr = re.search(r"constexpr int kMaxTiles = (.*?);", SRC).group(1)
    c = dict(kSmemMax=kernels.SMEM_MAX, kBinChunk=kernels.SLAB_BIN_CHUNK)
    assert kernels.SLAB_MAX_TILES == eval(expr.replace("/", "//"), {}, c)


def _c_plan(grids: int, width: int, ny: int):
    """``slab_tile_plan`` as the source writes it (powers of two)."""
    cells, rows = _const("kTileCells"), _const("kTileRows")
    lh = 0
    while (1 << lh) < ny and (1 << lh) < rows:
        lh += 1
    lw = 0
    while (1 << (lw + lh)) < cells:
        lw += 1
    nxt = (width + (1 << lw) - 1) >> lw
    nyt = (ny + (1 << lh) - 1) >> lh
    return 1 << lw, 1 << lh, nxt, nyt, grids * nxt * nyt


@pytest.mark.parametrize("grids,width,ny", SHAPES)
def test_tiles_cover_the_slab_once(grids, width, ny):
    tp = kernels.slab_tiles(grids, width, ny)
    assert tuple(tp) == _c_plan(grids, width, ny)
    assert tp.tw * tp.th == kernels.SLAB_TILE_CELLS
    assert tp.th <= kernels.SLAB_TILE_ROWS
    hits = np.zeros((grids, width, ny), np.int32)
    for t in range(tp.tiles):
        g, tx, ty = t // (tp.nxt * tp.nyt), (t // tp.nyt) % tp.nxt, t % tp.nyt
        hits[g, tx * tp.tw:(tx + 1) * tp.tw, ty * tp.th:(ty + 1) * tp.th] += 1
        # The kernel's tile of a cell, (g nxt + lx / tw) nyt + iy / th, and
        # its byte-sized index in the tile.
        lx, iy = min(tx * tp.tw, width - 1), min(ty * tp.th, ny - 1)
        assert (g * tp.nxt + lx // tp.tw) * tp.nyt + iy // tp.th == t
        assert ((lx % tp.tw) * tp.th + iy % tp.th) < 256
    assert (hits == 1).all()
    # Shared memory, as the launch sizes it: the bin blocks' staged pairs
    # (an int32 and a byte each) and, up to SLAB_MAX_TILES, two counters
    # per tile; the sum blocks' tile sums, then where they fit the segment
    # offsets and first slots of the bin blocks (of 368,640 points or of
    # 60 M) and their cluster's tiles' totals (at most every tile's).
    shared_counts = tp.tiles <= kernels.SLAB_MAX_TILES
    bin_smem = (8 * tp.tiles * shared_counts
                + 5 * grids * kernels.SLAB_BIN_CHUNK + 64)
    assert bin_smem <= kernels.SMEM_MAX
    assert shared_counts == (tp.tiles <= 23_904)
    for m in (368_640, 60_000_000):
        blocks = -(-m // kernels.SLAB_BIN_CHUNK)
        seg = 4 * (2 * blocks + 1)
        stage_seg = 48 * kernels.SLAB_TILE_CELLS + seg <= kernels.SMEM_MAX
        assert stage_seg == (m < 56_000_000)
        base = 48 * kernels.SLAB_TILE_CELLS + seg * stage_seg
        assert base <= kernels.SMEM_MAX
        stage_n = base + 4 * tp.tiles <= kernels.SMEM_MAX
        assert stage_n or tp.tiles > 40_000


@pytest.mark.parametrize("m", [0, 1, 2048, 2049, 368_640, 737_280])
def test_work_buffer_holds_every_pair(m):
    """The per-call work buffer: two [tiles, blocks] matrices, the tiles'
    totals and a region of G x 2,048 slots (an int32 and a byte) per bin
    block, for every live (grid, point) pair at most."""
    for grids, width, ny in ((4, 282, 256), (1, 280, 256)):
        tiles = kernels.slab_tiles(grids, width, ny).tiles
        blocks = -(-m // kernels.SLAB_BIN_CHUNK)
        words = kernels.slab_work(grids, m, tiles)
        assert words == (2 * tiles * blocks + tiles
                         + blocks * grids * kernels.SLAB_BIN_CHUNK * 5 // 4)
        assert blocks * kernels.SLAB_BIN_CHUNK * grids >= grids * m
