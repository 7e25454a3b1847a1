// K10a slab_accumulate: the moment sums of masked points in the cells of
// an x-slab of every overlap grid (4, or 1 at overlap 1), in 64-bit fixed
// point relative to each cell (halfcell_fixed.cuh's arithmetic on full
// cells), so the slab map is the same on every run and under any order of
// the points.
//
// Replaces what XLA lowered for the TPU from ndtpu/dist/gridmap.py::
// _accum_local (:66: three segment_sums of n, w*p and w*p p^T into a local
// slab [G, nx_local, ny], ix-major) together with the per-point work of its
// callers build_slab_stats (:96-104: _cell_xy and the ownership mask) and
// build_slab_stats_psharded (:130-140: the halo-extended index, clipped,
// and its in-slab mask).
//
// The slab is grid columns [x_lo, x_lo + width) of every grid (x_lo may be
// negative and x_lo + width past nx: the halo-extended slabs of the first
// and last rank); its local flat cell id is (g * width + ix - x_lo) * ny +
// iy. A (grid, point) pair is live where the point is masked, its cell as
// ndtpu/ndt/grid.py::cell_ids computes it in f32 (halfcell_fixed.cuh's
// cell_bin: floor(((x - x0) - off) / cell), the in-bounds test on the
// unclamped index, then the clamp; grid g shifted by (g & 1, g >> 1) half
// cells, as ndtpu/ndt/grid.py::_grid_offsets :78-86 has it) is on the map
// and x_lo <= ix < x_lo + width. Its six terms are round({1, a, b, a*a,
// a*b, b*b} * 2^32), (a, b) its offset from the cell's lower corner over
// the cell size in f64; each cell's integer sums become n, s and ss about
// the origin in f64 (halfcell_moments with h = cell), each rounded to f32
// once (sxy written twice).
//
// Where the sums live: in shared memory, never in device memory. The slab
// is cut into tiles of one grid, 16 rows by 16 columns (fewer rows where
// ny is smaller; slab_tile_plan, mirrored by
// ndtpu_torch.kernels.slab_tiles), whose six int64 sums per cell take 12
// KB. One C call (slab_accum_launch) enqueues three kernels on the
// caller's stream, into a per-call int32 work buffer from the wrapper:
//   1. bin: one block per 2,048 points. Each (grid, point) pair is binned
//      to its tile and cell; the block counts its pairs per tile in shared
//      memory (a warp whose 32 pairs share a tile adds 32 once), scans the
//      counts and writes its pairs, sorted by tile, into its own region
//      (the point's index, and the cell in its tile as a byte), with its
//      count and first slot per tile in the matrices counts [tiles,
//      blocks + 1] and first [tiles, blocks] (every entry written: no
//      memset). A slab of more than kMaxTiles tiles (~6 M cells), whose
//      counters do not fit shared memory, counts and scans in the block's
//      own columns of those matrices instead (atomics in device memory on
//      entries no other block touches);
//   2. scan: one warp per tile scans its row of the counts in place (where
//      each bin block's segment starts in the tile's bucket) and writes the
//      tile's total in the row's last entry;
//   3. sum: persistent clusters of kCluster blocks, which take the tiles in
//      turn, reading each tile's row of the segment offsets from shared
//      memory where it fits (else from device memory). A tile without pairs: each rank writes its share of zero
//      cells. Up to kPairsPerBlock pairs: rank 0 alone zeroes its copy of
//      the tile's sums, adds the pairs and writes the tile. More: active =
//      min(kCluster, ceil(pairs / kPairsPerBlock)) ranks each add an equal
//      share of the bucket to their own copy, each thread a contiguous range
//      (a binary search finds its first segment) with kBatch pairs' loads
//      in flight, a run of pairs in one cell summed in registers and added
//      once (scanned points come in runs), the int64 adds made as 32-bit
//      shared atomics with the carry (add_run); after a cluster barrier
//      every rank sums its quarter of the cells over the active copies
//      (distributed shared memory) and writes them; a second barrier keeps
//      each copy until the others have read it.
// No global atomics in the sum (nor in the bin up to kMaxTiles tiles), no
// memset, no scratch kept between calls; every slab shape and point count
// the int32 indices reach is taken. Integer
// addition is associative: the sums, so every output, do not depend on the
// order of the points, of the buckets or of the atomics (bit-equal to
// ndtpu_torch.dist.gridmap.slab_accumulate_fixed_ref and to the first
// design, which added the same terms with L2 atomics into a kept scratch).
//
// What bounds it on Hopper: bytes in principle (the points read once, the
// f32 slab written once: 28 B a cell), which is far off. The per-pair work
// (binning in f32, the six terms in f64, up to eleven shared
// atomics) and each tile's chain of barriers set the pace; scanned walls
// put thousands of points in one cell, so a crowded tile's pairs are spread
// over up to kCluster SMs and the runs cut its atomics.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "halfcell_fixed.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kTileCells = 256;     // cells per tile: 12 KB of int64 sums
constexpr int kTileRows = 16;       // rows per tile, at most
constexpr int kBinThreads = 512;
constexpr int kBinChunk = 2048;     // points per bin block
constexpr int kBinPoints = kBinChunk / kBinThreads;   // per thread
constexpr int kSumThreads = 256;
constexpr int kBatch = 4;           // pairs' loads in flight per thread
constexpr int kCluster = 4;         // blocks per cluster (ranks of a tile)
constexpr int kPairsPerBlock = 1024;   // a tile's pairs per active rank
constexpr int kSmemMax = 232448;    // what one block can have
// The bin blocks' shared memory: two counters per tile and the staged
// pairs (kBinChunk * G of an int32 and a byte); past kMaxTiles tiles the
// counters go to device memory.
constexpr int kMaxTiles = (kSmemMax - 5 * 4 * kBinChunk - 256) / 8;
static_assert(kTileCells <= 256, "a pair's cell in its tile is one byte");

struct TilePlan {
  int lw, lh;          // tiles of 2^lw columns by 2^lh rows
  int nxt, nyt, tiles;
};

// Tiles of one grid: 2^lh = min(kTileRows, ny rounded up to a power of
// two) rows by 2^lw = kTileCells / 2^lh columns, nyt bands by nxt strips
// (the last of each cut at the slab's edge); grid-major, then
// column-major: tile (g * nxt + tx) * nyt + ty.
inline TilePlan slab_tile_plan(int grids, int width, int ny) {
  int lh = 0;
  while ((1 << lh) < ny && (1 << lh) < kTileRows) ++lh;
  int lw = 0;
  while ((1 << (lw + lh)) < kTileCells) ++lw;
  const int nxt = (width + (1 << lw) - 1) >> lw;
  const int nyt = (ny + (1 << lh) - 1) >> lh;
  return TilePlan{lw, lh, nxt, nyt, grids * nxt * nyt};
}

struct SlabArgs {
  float x0f, y0f, cellf, hf;   // grid origin, cell, half cell (f32 binning)
  double x0, y0, cell, inv;    // the same in f64 (fixed point), inv = 1/cell
  int nx, ny, x_lo, width;
  TilePlan tp;
};

// Grid g's fixed-point frame (halfcell_fixed.cuh's cell_frame).
__device__ __forceinline__ ndtpu::HalfcellGrid grid_frame(const SlabArgs& a,
                                                          int g) {
  return ndtpu::cell_frame(a.x0, a.y0, a.cell, a.inv, g, a.nx, a.ny);
}

// The point's cell in grid g, false where the pair is not live.
__device__ __forceinline__ bool slab_cell(const SlabArgs& a, float2 p, int g,
                                          int* lx, int* iy) {
  int ix;
  if (!ndtpu::cell_bin(p.x, p.y, a.x0f, a.y0f, (g & 1) ? a.hf : 0.f,
                       (g & 2) ? a.hf : 0.f, a.cellf, a.nx, a.ny, &ix, iy))
    return false;
  *lx = ix - a.x_lo;
  return *lx >= 0 && *lx < a.width;
}

// A warp's pairs whose tile is that of lane 0 when all 32 share it (scanned
// points mostly do): one lane takes the warp's 32 slots.
__device__ __forceinline__ bool warp_one_tile(int t) {
  const int t0 = __shfl_sync(0xffffffffu, t, 0);
  return __all_sync(0xffffffffu, t == t0) && t0 >= 0;
}

// out[j os] = in[0] + ... + in[(j - 1) is] for j < n (shared or device
// memory); blockDim.x == kBinThreads. Returns the sum of all n (every
// thread).
__device__ int block_exclusive_scan(const int* in, size_t is, int* out,
                                    size_t os, int n) {
  __shared__ int warp_sum[kBinThreads / 32];
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int per = (n + kBinThreads - 1) / kBinThreads;
  const int lo = min(n, tid * per), hi = min(n, lo + per);
  int sum = 0;
  for (int j = lo; j < hi; ++j) sum += in[j * is];
  int incl = sum;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += v;
  }
  if (lane == 31) warp_sum[w] = incl;
  __syncthreads();
  int before = 0, all = 0;
#pragma unroll
  for (int k = 0; k < kBinThreads / 32; ++k) {
    before += k < w ? warp_sum[k] : 0;
    all += warp_sum[k];
  }
  int run = before + incl - sum;
  for (int j = lo; j < hi; ++j) {
    const int c = in[j * is];
    out[j * os] = run;
    run += c;
  }
  __syncthreads();
  return all;
}

// One pass over the points: block b bins its kBinChunk points' pairs by
// tile (counts, a scan, then each pair's slot) and writes them, sorted by
// tile, to its own region of pairs [blocks, G * kBinChunk], with its count
// and first slot per tile in column b of counts [tiles, blocks + 1] and
// first [tiles, blocks]. The counters live in shared memory, or with
// kShared false (more than kMaxTiles tiles) in those columns (a template
// parameter, so that the shared copy's atomics stay shared-memory ones).
template <int G, bool kShared>
__global__ void __launch_bounds__(kBinThreads)
slab_tile_bin_kernel(const float2* __restrict__ pts,
                     const uint8_t* __restrict__ mask,
                     int* __restrict__ counts, int* __restrict__ first,
                     int* __restrict__ pairs, uint8_t* __restrict__ pair_cell,
                     int m, SlabArgs a) {
  constexpr bool shared_counts = kShared;
  extern __shared__ int smem[];
  const int tiles = a.tp.tiles, lane = threadIdx.x & 31;
  const size_t ld = gridDim.x;
  int* count_col = counts + blockIdx.x;   // stride ld + 1
  int* first_col = first + blockIdx.x;    // stride ld
  // Each tile's count (hs apart) and the slot its next pair takes (ss apart).
  int* hist = shared_counts ? smem : count_col;
  int* slot = shared_counts ? smem + tiles : first_col;
  const size_t hs = shared_counts ? 1 : ld + 1, ss = shared_counts ? 1 : ld;
  int* staged = smem + (shared_counts ? 2 * tiles : 0);   // [G * kBinChunk]
  uint8_t* staged_cell =
      reinterpret_cast<uint8_t*>(staged + G * kBinChunk);   // [G * kBinChunk]
  for (int t = threadIdx.x; t < tiles; t += kBinThreads) hist[t * hs] = 0;
  int tile[kBinPoints][G], cell[kBinPoints][G];
#pragma unroll
  for (int k = 0; k < kBinPoints; ++k) {
    const int i = blockIdx.x * kBinChunk + k * kBinThreads + threadIdx.x;
    const bool in = i < m;
    const float2 p = in ? pts[i] : make_float2(0.f, 0.f);
    const bool masked = in && mask[i];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      int lx = 0, iy = 0;
      const bool live = masked && slab_cell(a, p, g, &lx, &iy);
      tile[k][g] = live ? (g * a.tp.nxt + (lx >> a.tp.lw)) * a.tp.nyt
                              + (iy >> a.tp.lh)
                        : -1;
      cell[k][g] = ((lx & ((1 << a.tp.lw) - 1)) << a.tp.lh)
                   | (iy & ((1 << a.tp.lh) - 1));
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kBinPoints; ++k)
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int t = tile[k][g];
      if (warp_one_tile(t)) {
        if (lane == 0) atomicAdd(hist + t * hs, 32);
      } else if (t >= 0) {
        atomicAdd(hist + t * hs, 1);
      }
    }
  __syncthreads();
  const int n = block_exclusive_scan(hist, hs, slot, ss, tiles);
  // The scatter's cursors: the shared slots, whose counts and starts go to
  // the block's columns first; in device memory, the count column, set to
  // the starts and turned back into counts after the scatter.
  int* cur = shared_counts ? slot : count_col;
  const size_t cs = shared_counts ? 1 : ld + 1;
  for (int t = threadIdx.x; t < tiles; t += kBinThreads) {
    if constexpr (shared_counts) {
      count_col[t * (ld + 1)] = hist[t];
      first_col[t * ld] = slot[t];
    } else {
      count_col[t * (ld + 1)] = first_col[t * ld];
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kBinPoints; ++k)
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int t = tile[k][g];
      const int i = blockIdx.x * kBinChunk + k * kBinThreads + threadIdx.x;
      int at = 0;
      if (warp_one_tile(t)) {
        if (lane == 0) at = atomicAdd(cur + t * cs, 32);
        at = __shfl_sync(0xffffffffu, at, 0) + lane;
      } else if (t >= 0) {
        at = atomicAdd(cur + t * cs, 1);
      }
      if (t >= 0) {
        staged[at] = i;
        staged_cell[at] = (uint8_t)cell[k][g];
      }
    }
  __syncthreads();
  if constexpr (!shared_counts)
    for (int t = threadIdx.x; t < tiles; t += kBinThreads)
      count_col[t * (ld + 1)] -= first_col[t * ld];
  int* out = pairs + (size_t)blockIdx.x * G * kBinChunk;
  uint8_t* out_cell = pair_cell + (size_t)blockIdx.x * G * kBinChunk;
  for (int j = threadIdx.x; j < n; j += kBinThreads) {
    out[j] = staged[j];
    out_cell[j] = staged_cell[j];
  }
}

// Row t of counts [tiles, blocks + 1]: the exclusive scan of its first
// `blocks` entries in place (block b's first pair in the tile's bucket),
// and the tile's total in the last. One warp per tile; each lane takes a
// contiguous chunk.
__global__ void __launch_bounds__(256)
slab_tile_scan_kernel(int* __restrict__ counts, int tiles, int blocks) {
  const int t = blockIdx.x * 8 + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (t >= tiles) return;
  int* row = counts + (size_t)t * (blocks + 1);
  const int per = (blocks + 31) >> 5;
  const int lo = min(blocks, lane * per), hi = min(blocks, lo + per);
  int sum = 0;
  for (int j = lo; j < hi; ++j) sum += row[j];
  int incl = sum;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += v;
  }
  int run = incl - sum;
  for (int j = lo; j < hi; ++j) {
    const int c = row[j];
    row[j] = run;
    run += c;
  }
  if (lane == 31) row[blocks] = incl;
}

// Adds the int64 sums q to cell `cell` of sums (two 32-bit words each, low
// first) with 32-bit shared atomics (a 64-bit shared atomic add is a
// compare-and-swap loop): each low word's add returns the old low word,
// whose carry goes with the high word's add, made only where it adds
// something. Each add's carry is its own, so the words hold the sums mod
// 2^64 whatever the order of the adds. q[0] is the run's count times
// round(1 * 2^32) = 2^32: its low word is always 0.
__device__ __forceinline__ void add_run(unsigned* sums, int cell,
                                        const long long q[6]) {
  unsigned* dst = sums + 12 * cell;
  atomicAdd(dst + 1, (unsigned)((unsigned long long)q[0] >> 32));
  unsigned old[6];
#pragma unroll
  for (int k = 1; k < 6; ++k)
    old[k] = atomicAdd(dst + 2 * k, (unsigned)(unsigned long long)q[k]);
#pragma unroll
  for (int k = 1; k < 6; ++k) {
    const unsigned lo = (unsigned)(unsigned long long)q[k];
    const unsigned hi = (unsigned)((unsigned long long)q[k] >> 32)
                        + (old[k] + lo < old[k] ? 1u : 0u);
    if (hi) atomicAdd(dst + 2 * k + 1, hi);
  }
}

// Pairs [v_lo, v_hi) of a tile's bucket into sums: this thread's contiguous
// range, kBatch pairs' loads in flight before their math, a run of pairs
// in one cell summed in registers and added once. The bucket is the bin
// blocks' segments in block order: block b's holds pairs [seg_off[b],
// seg_off[b + 1]) of the bucket, from slot seg_first[b] of its region.
template <int G>
__device__ __forceinline__ void add_pairs(
    const SlabArgs& a, const float2* __restrict__ pts,
    const int* __restrict__ pairs, const uint8_t* __restrict__ pair_cell,
    const int* seg_off, const int* seg_first,
    int blocks, int v_lo, int v_hi, int g, int lx0, int iy0,
    unsigned* sums) {
  if (v_lo >= v_hi) return;
  // The segment holding v_lo: the last b with seg_off[b] <= v_lo.
  int lo = 0, hi = blocks - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (seg_off[mid] <= v_lo) lo = mid; else hi = mid - 1;
  }
  int b = lo;
  int at = b * G * kBinChunk + seg_first[b] + (v_lo - seg_off[b]);
  int seg_end = seg_off[b + 1];
  const ndtpu::HalfcellGrid fr = grid_frame(a, g);
  int cell = -1;
  long long acc[6] = {0, 0, 0, 0, 0, 0};
  for (int v0 = v_lo; v0 < v_hi; v0 += kBatch) {
    int idx[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int v = v0 + j;
      idx[j] = v < v_hi ? at : -1;
      if (v + 1 < v_hi) {
        if (v + 1 == seg_end) {
          do { ++b; } while (seg_off[b + 1] == seg_off[b]);
          at = b * G * kBinChunk + seg_first[b];
          seg_end = seg_off[b + 1];
        } else {
          ++at;
        }
      }
    }
    int cb[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      cb[j] = idx[j] >= 0 ? pair_cell[idx[j]] : 0;
      idx[j] = idx[j] >= 0 ? pairs[idx[j]] : -1;
    }
    float2 pb[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
      pb[j] = idx[j] >= 0 ? pts[idx[j]] : make_float2(0.f, 0.f);
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      if (idx[j] < 0) continue;
      const float2 p = pb[j];
      const int c = cb[j];
      long long q[6];
      ndtpu::halfcell_quantize(p.x, p.y, 1.f, a.x_lo + lx0 + (c >> a.tp.lh),
                               iy0 + (c & ((1 << a.tp.lh) - 1)), fr, q);
      if (c != cell) {
        if (cell >= 0) add_run(sums, cell, acc);
        cell = c;
#pragma unroll
        for (int k = 0; k < 6; ++k) acc[k] = q[k];
      } else {
#pragma unroll
        for (int k = 0; k < 6; ++k) acc[k] += q[k];
      }
    }
  }
  if (cell >= 0) add_run(sums, cell, acc);
}

// Cell c of tile (g, lx0, iy0): its moments from the int64 sums q (none:
// zero sums, whose moments are +0), written once; nothing where the cell
// is past the slab's edge.
__device__ __forceinline__ void write_cell(const SlabArgs& a, int g, int lx0,
                                           int iy0, int c,
                                           const long long* q,
                                           float* __restrict__ n_out,
                                           float2* __restrict__ s_out,
                                           float4* __restrict__ ss_out) {
  const int lx = lx0 + (c >> a.tp.lh), iy = iy0 + (c & ((1 << a.tp.lh) - 1));
  if (lx >= a.width || iy >= a.ny) return;
  const size_t at = ((size_t)g * a.width + lx) * a.ny + iy;
  if (q == nullptr) {
    n_out[at] = 0.f;
    s_out[at] = make_float2(0.f, 0.f);
    ss_out[at] = make_float4(0.f, 0.f, 0.f, 0.f);
    return;
  }
  double mo[6];
  ndtpu::halfcell_moments(q, a.x_lo + lx, iy, grid_frame(a, g), mo);
  n_out[at] = __double2float_rn(mo[0]);
  s_out[at] = make_float2(__double2float_rn(mo[1]), __double2float_rn(mo[2]));
  const float sxy = __double2float_rn(mo[4]);
  ss_out[at] = make_float4(__double2float_rn(mo[3]), sxy, sxy,
                           __double2float_rn(mo[5]));
}

// Persistent clusters over the tiles (cluster c takes tiles c, c +
// clusters, ...). A tile without pairs: every rank writes its share of
// zero cells. Up to kPairsPerBlock pairs: rank 0 alone sums them in its
// shared memory and writes the tile. More: `active` ranks each sum an equal
// share of the bucket into their own copy; after a cluster barrier every
// rank adds up its share of the cells over the active copies (distributed
// shared memory) and writes them; a second barrier keeps each copy until
// the others have read it. off / first: the scanned counts [tiles, blocks
// + 1] (each row's last entry the tile's total) and the first slots
// [tiles, blocks], null where there are no points. The totals of the
// cluster's tiles (`stage_n`) and a tile's rows of both (`stage_seg`) are
// read into shared memory where the host found room, else read where they
// are.
template <int G>
__global__ void __cluster_dims__(kCluster, 1, 1)
    __launch_bounds__(kSumThreads, 1024 / kSumThreads)
slab_tile_sum_kernel(const float2* __restrict__ pts,
                     const int* __restrict__ off,
                     const int* __restrict__ first,
                     const int* __restrict__ pairs,
                     const uint8_t* __restrict__ pair_cell, int blocks,
                     float* __restrict__ n_out, float2* __restrict__ s_out,
                     float4* __restrict__ ss_out, SlabArgs a, bool stage_n,
                     bool stage_seg) {
  extern __shared__ __align__(16) unsigned tile_smem[];
  unsigned* sums = tile_smem;                                     // [cells, 12]
  int* tile_n = reinterpret_cast<int*>(tile_smem + 12 * kTileCells);
  const TilePlan& tp = a.tp;
  const int clusters = gridDim.x / kCluster, cid = blockIdx.x / kCluster;
  // This cluster's tiles' totals, then a tile's offsets [B + 1] and first
  // slots [B].
  int* seg_off_s = tile_n + (stage_n ? (tp.tiles + clusters - 1) / clusters
                                     : 0);
  int* seg_first_s = seg_off_s + blocks + 1;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), tid = threadIdx.x;
  const size_t ld = (size_t)blocks + 1;
  auto total = [&](int t) { return off ? off[t * ld + blocks] : 0; };
  if (stage_n) {
    for (int j = tid; cid + j * clusters < tp.tiles; j += kSumThreads)
      tile_n[j] = total(cid + j * clusters);
    __syncthreads();
  }
  constexpr int per = kTileCells / kCluster;   // cells each rank writes
  for (int j = 0, t = cid; t < tp.tiles; ++j, t += clusters) {
    const int n = stage_n ? tile_n[j] : total(t);
    const int g = t / (tp.nxt * tp.nyt);
    const int lx0 = ((t / tp.nyt) % tp.nxt) << tp.lw;
    const int iy0 = (t % tp.nyt) << tp.lh;
    if (n == 0) {
      for (int c = rank * per + tid; c < (rank + 1) * per; c += kSumThreads)
        write_cell(a, g, lx0, iy0, c, nullptr, n_out, s_out, ss_out);
      continue;
    }
    const int active =
        min(kCluster, (n + kPairsPerBlock - 1) / kPairsPerBlock);
    if (rank < active) {
      uint4* z = reinterpret_cast<uint4*>(sums);
      for (int k = tid; k < 3 * kTileCells; k += kSumThreads)
        z[k] = make_uint4(0u, 0u, 0u, 0u);
      const int* seg_off = off + t * ld;
      const int* seg_first = first + t * (ld - 1);
      if (stage_seg)
        for (int b = tid; b <= blocks; b += kSumThreads) {
          seg_off_s[b] = seg_off[b];
          if (b < blocks) seg_first_s[b] = seg_first[b];
        }
      __syncthreads();
      const long long r_lo = (long long)n * rank / active;
      const long long r_len = (long long)n * (rank + 1) / active - r_lo;
      const int v_lo = (int)(r_lo + r_len * tid / kSumThreads);
      const int v_hi = (int)(r_lo + r_len * (tid + 1) / kSumThreads);
      // Two call sites, so that the staged one reads shared memory as such.
      if (stage_seg)
        add_pairs<G>(a, pts, pairs, pair_cell, seg_off_s, seg_first_s,
                     blocks, v_lo, v_hi, g, lx0, iy0, sums);
      else
        add_pairs<G>(a, pts, pairs, pair_cell, seg_off, seg_first, blocks,
                     v_lo, v_hi, g, lx0, iy0, sums);
      __syncthreads();
    }
    if (active == 1) {   // rank 0 alone: no other rank reads its copy
      if (rank == 0) {
        for (int c = tid; c < kTileCells; c += kSumThreads) {
          const longlong2* src =
              reinterpret_cast<const longlong2*>(sums + 12 * c);
          const longlong2 a01 = src[0], a23 = src[1], a45 = src[2];
          const long long q[6] = {a01.x, a01.y, a23.x, a23.y, a45.x, a45.y};
          write_cell(a, g, lx0, iy0, c, q, n_out, s_out, ss_out);
        }
        __syncthreads();   // before the next tile zeroes the copy
      }
      continue;
    }
    cluster.sync();   // every active copy is complete
    for (int c = rank * per + tid; c < (rank + 1) * per; c += kSumThreads) {
      long long q[6] = {0, 0, 0, 0, 0, 0};
      for (int r = 0; r < active; ++r) {
        const longlong2* src = reinterpret_cast<const longlong2*>(
            cluster.map_shared_rank(sums, r) + 12 * c);
        const longlong2 a01 = src[0], a23 = src[1], a45 = src[2];
        q[0] += a01.x; q[1] += a01.y; q[2] += a23.x;
        q[3] += a23.y; q[4] += a45.x; q[5] += a45.y;
      }
      write_cell(a, g, lx0, iy0, c, q, n_out, s_out, ss_out);
    }
    cluster.sync();   // no copy is zeroed while another rank reads it
  }
}

// Clusters of the sum that fit the card at once (queried once per G).
template <int G>
int sum_clusters(size_t smem_bytes) {
  static int n = 0;
  if (n == 0) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(kCluster * 1024, 1, 1);
    cfg.blockDim = dim3(kSumThreads, 1, 1);
    cfg.dynamicSmemBytes = smem_bytes;
    int got = 0;
    if (cudaOccupancyMaxActiveClusters(&got, slab_tile_sum_kernel<G>, &cfg)
            != cudaSuccess || got < 1) {
      cudaGetLastError();
      got = 16;
    }
    n = got;
  }
  return n;
}

template <int G>
cudaError_t launch(const float2* pts, const uint8_t* mask, int* work,
                   float* n_out, float2* s_out, float4* ss_out, int m,
                   const SlabArgs& a, cudaStream_t st) {
  const int tiles = a.tp.tiles;
  const int blocks = (m + kBinChunk - 1) / kBinChunk;
  int* counts = work;                                // [tiles, blocks + 1]
  int* first = counts + (size_t)tiles * (blocks + 1);   // [tiles, blocks]
  int* pairs = first + (size_t)tiles * blocks;       // [blocks, G * kBinChunk]
  uint8_t* pair_cell = reinterpret_cast<uint8_t*>(
      pairs + (size_t)blocks * G * kBinChunk);     // [blocks, G * kBinChunk]
  const bool shared_counts = tiles <= kMaxTiles;
  const size_t bin_smem =
      ((shared_counts ? 2 * (size_t)tiles : 0) + G * kBinChunk) * sizeof(int)
      + G * kBinChunk;
  // The sum's shared memory: a tile's sums, then (where they fit) the
  // cluster's tile totals and a tile's segment offsets and first slots.
  const size_t seg_smem = (2 * (size_t)blocks + 1) * sizeof(int);
  const bool stage_seg = kTileCells * 48 + seg_smem <= kSmemMax;
  const size_t base_smem = kTileCells * 48 + (stage_seg ? seg_smem : 0);
  cudaError_t err = cudaSuccess;
  if (m > 0) {
    auto bin = shared_counts ? slab_tile_bin_kernel<G, true>
                             : slab_tile_bin_kernel<G, false>;
    if (bin_smem > 49152)   // past the default 48 KB: opt in
      err = cudaFuncSetAttribute(bin,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)bin_smem);
    if (err != cudaSuccess) return err;
    bin<<<blocks, kBinThreads, bin_smem, st>>>(pts, mask, counts, first,
                                               pairs, pair_cell, m, a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    slab_tile_scan_kernel<<<(tiles + 7) / 8, 256, 0, st>>>(counts, tiles,
                                                            blocks);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const int clusters = min(sum_clusters<G>(base_smem + 4096), tiles);
  const size_t n_smem = (size_t)((tiles + clusters - 1) / clusters)
                        * sizeof(int);
  const bool stage_n = base_smem + n_smem <= kSmemMax;
  const size_t sum_smem = base_smem + (stage_n ? n_smem : 0);
  if (sum_smem > 49152) {
    err = cudaFuncSetAttribute(slab_tile_sum_kernel<G>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)sum_smem);
    if (err != cudaSuccess) return err;
  }
  slab_tile_sum_kernel<G><<<clusters * kCluster, kSumThreads, sum_smem,
                            st>>>(pts, m > 0 ? counts : nullptr, first,
                                  pairs, pair_cell, blocks, n_out, s_out,
                                  ss_out, a, stage_n, stage_seg);
  return cudaGetLastError();
}

}  // namespace


// points [m, 2] f32, mask [m] bool; `grids` = 4 or 1 overlap grids; n_out
// [grids, width, ny], s_out [.., 2], ss_out [.., 2, 2] f32; (tw, th,
// tiles) the caller's tile plan, which must be slab_tile_plan's; work the
// int32 [tiles * (B + 1) + tiles * B + B * grids * 2048 * 5 / 4] buffer, B
// = ceil(m / 2048).
extern "C" int slab_accum_launch(const void* pts, const void* mask,
                                 void* work, void* n_out, void* s_out,
                                 void* ss_out, int m, int nx, int ny,
                                 int x_lo, int width, double x0, double y0,
                                 double cell, int grids, int tw, int th,
                                 int tiles, void* stream) {
  if (m < 0 || nx < 1 || ny < 1 || width < 1 || (grids != 4 && grids != 1))
    return (int)cudaErrorInvalidValue;
  const TilePlan tp = slab_tile_plan(grids, width, ny);
  if ((1 << tp.lw) != tw || (1 << tp.lh) != th || tp.tiles != tiles)
    return (int)cudaErrorInvalidValue;
  const SlabArgs a{(float)x0, (float)y0, (float)cell, (float)(cell / 2.0),
                   x0, y0, cell, 1.0 / cell, nx, ny, x_lo, width, tp};
  const cudaStream_t st = (cudaStream_t)stream;
  const cudaError_t err =
      grids == 4
          ? launch<4>((const float2*)pts, (const uint8_t*)mask, (int*)work,
                      (float*)n_out, (float2*)s_out, (float4*)ss_out, m, a,
                      st)
          : launch<1>((const float2*)pts, (const uint8_t*)mask, (int*)work,
                      (float*)n_out, (float2*)s_out, (float4*)ss_out, m, a,
                      st);
  return (int)err;
}

