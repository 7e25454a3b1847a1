// K3: half-cell moment scatter + 2x2 pooling into the 4 overlap grids, in
// 64-bit fixed point (halfcell_fixed.cuh): the same statistics on every run.
// K3s: the same over S maps in one call (the stacked multi-session path).
//
// Replaces what XLA lowered for the TPU from
// ndtpu/ndt/grid.py::_add_points_halfcell (:161-203): one segment_sum of six
// moments onto the (2ny+1) x (2nx+1) half-cell lattice, then a dense 2x2
// sum-pool per shifted grid, added to the running statistics. K3s replaces
// the vmaps of add_points over the S sessions' statistics in
// ndtpu/dist/slam_dp.py (the pass-2 temporary maps :317, _wb_extend :397
// and _refresh_map :405): one call adds points [S, M, 2] into S maps.
//
// One C call (halfcell_add_launch) enqueues three things on the caller's
// stream:
//   1. cudaMemsetAsync of the int64 [hh * wh, 6] lattice scratch, which the
//      wrapper allocates once per lattice shape and keeps;
//   2. the scatter, one thread per point: binning and the six fixed-point
//      terms; lanes of a warp in one half-cell (neighbouring beams) sum
//      theirs with shuffles, and the run's last lane does six 64-bit
//      atomicAdds into the lattice (in L2). Points with zero weight
//      (masked, outside the lattice, or weight 0) add nothing;
//   3. the pool, tiled: a block owns 8 x 8 cells of all 4 grids; its 289
//      first threads load the 17 x 17 half-cells under them (the tile plus
//      a one-half-cell halo) in one pass and reconstruct each one's f64
//      moments once into shared memory, then 256 threads each pool one
//      (grid, cell) from shared memory, add it to the input statistics in
//      f64 and write the f32 result into NEW output tensors (the input
//      statistics stay valid: the pipeline registers against a temporary
//      map built on top of the window's committed one).
//
// Overlap 1 (kByCell, ndtpu/ndt/grid.py::add_points :120-160 with cell_ids
// :89-108: one segment_sum of the moments onto the ny x nx cells of the one
// grid): the same scatter at cell resolution, binned as cell_ids bins (a
// division by the cell, halfcell_fixed.cuh's cell_bin; K10a bins the same
// way) into the nx x ny lattice of fixed-point sums with h = cell; no
// pooling: a per-cell pass reconstructs each cell's f64 moments, adds the
// input statistics in f64 and rounds to f32 once into new output tensors,
// as the pool does at overlap 4.
//
// K3s: the grid's y axis of the scatter and z axis of the pool is the map
// (session) s, whose points, mask, weights, lattice slice [hh * wh, 6] and
// statistics are each shifted by s whole maps; one memset zeroes all S
// lattices. A session's sums are the same integers as its own K3 call's,
// so K3s equals S single K3 calls bit for bit.
//
// What bounds it on Hopper: at the main path's shapes (2,880 points, a
// 100 x 100 grid) the card work is a few microseconds against a bound under
// one: the memset (~2 MB), the atomics (six per point, spread over the
// lattice) and the pool's stats traffic (28 floats per cell in and out).
// Each lattice half-cell is read from L2 about once (the halo adds 1/8),
// where the former pool read it up to 16 times. The host's part of a call
// (one ctypes call, one output allocation) is the larger share. At overlap
// 1 the lattice is the nx x ny cells (about a quarter of the half-cell
// lattice) and the statistics 7 floats per cell in and out.

#include <cuda_runtime.h>
#include <stdint.h>

#include "halfcell_fixed.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 8;                 // cells per tile side
constexpr int kSpan = 2 * kTile + 1;     // half-cells per tile side (halo)
constexpr int kCells = 4 * kTile * kTile;   // (grid, cell) outputs per tile
constexpr int kPoolThreads = 320;        // one thread per tile half-cell
static_assert(kPoolThreads >= kSpan * kSpan && kPoolThreads >= kCells,
              "the pool reads its tile in one pass");

template <bool kByCell>
__global__ void __launch_bounds__(kThreads)
halfcell_scatter_kernel(const float2* __restrict__ pts,
                        const uint8_t* __restrict__ mask,
                        const float* __restrict__ weight, float wscalar,
                        unsigned long long* __restrict__ lattice, int m,
                        ndtpu::HalfcellGrid g) {
  const size_t map = blockIdx.y;             // K3s: the session
  pts += map * m;
  mask += map * m;
  if (weight != nullptr) weight += map * m;
  lattice += map * g.wh * g.hh * 6;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  long long q[6] = {0, 0, 0, 0, 0, 0};
  int cell = -1;                           // no half-cell: adds nothing
  if (i < m && mask[i]) {
    const float2 p = pts[i];
    const float w = weight != nullptr ? weight[i] : wscalar;
    int hx, hy;
    const bool in =
        kByCell ? ndtpu::cell_bin(p.x, p.y, g.x0f, g.y0f, 0.f, 0.f, g.hf,
                                  g.wh, g.hh, &hx, &hy)
                : ndtpu::halfcell_bin(p.x, p.y, g, &hx, &hy);
    if (w != 0.f && in) {
      ndtpu::halfcell_quantize(p.x, p.y, w, hx, hy, g, q);
      cell = hy * g.wh + hx;
    }
  }
  // Neighbouring beams of a scan fall in one half-cell in runs of a few
  // lanes: a segmented inclusive scan over each run (integer adds, so the
  // sums stay independent of the order), then one set of atomics per run,
  // from its last lane.
  const unsigned all = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int prev = __shfl_up_sync(all, cell, 1);
  const int next = __shfl_down_sync(all, cell, 1);
  const unsigned heads = __ballot_sync(all, lane == 0 || prev != cell);
  const int first = 31 - __clz(heads & (all >> (31 - lane)));
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      const long long v = __shfl_up_sync(all, q[k], off);
      if (lane - off >= first) q[k] += v;
    }
  }
  if (cell < 0 || (lane != 31 && next == cell)) return;
  unsigned long long* dst = lattice + (size_t)cell * 6;
#pragma unroll
  for (int k = 0; k < 6; ++k) atomicAdd(dst + k, (unsigned long long)q[k]);
}

__global__ void __launch_bounds__(kPoolThreads)
halfcell_pool_kernel(const long long* __restrict__ lattice,
                     const float* __restrict__ n_in,
                     const float* __restrict__ s_in,
                     const float* __restrict__ ss_in,
                     float* __restrict__ n_out, float* __restrict__ s_out,
                     float* __restrict__ ss_out,
                     int nx, int ny, ndtpu::HalfcellGrid g) {
  __shared__ double tile[kSpan * kSpan][6];
  const size_t map = blockIdx.z, c4 = 4 * (size_t)nx * ny;   // K3s
  lattice += map * g.wh * g.hh * 6;
  n_in += map * c4;
  n_out += map * c4;
  s_in += 2 * map * c4;
  s_out += 2 * map * c4;
  ss_in += 4 * map * c4;
  ss_out += 4 * map * c4;
  const int i0 = blockIdx.x * kTile, j0 = blockIdx.y * kTile;
  if (threadIdx.x < kSpan * kSpan) {
    const int ly = threadIdx.x / kSpan;
    const int hx = 2 * i0 + (threadIdx.x - ly * kSpan), hy = 2 * j0 + ly;
    if (hx < g.wh && hy < g.hh) {             // past the edge: never read
      const longlong2* src = reinterpret_cast<const longlong2*>(
          lattice + ((size_t)hy * g.wh + hx) * 6);
      const longlong2 a01 = src[0], a23 = src[1], a45 = src[2];
      const long long a[6] = {a01.x, a01.y, a23.x, a23.y, a45.x, a45.y};
      ndtpu::halfcell_moments(a, hx, hy, g, tile[threadIdx.x]);
    }
  }
  __syncthreads();

  if (threadIdx.x >= kCells) return;
  const int grid = threadIdx.x / (kTile * kTile);
  const int li = threadIdx.x % kTile, lj = (threadIdx.x / kTile) % kTile;
  const int i = i0 + li, j = j0 + lj;
  if (i >= nx || j >= ny) return;
  const int gx = grid & 1, gy = grid >> 1;   // shifts (0,0) (1,0) (0,1) (1,1)
  const double* r0 = tile[(2 * lj + gy) * kSpan + 2 * li + gx];
  const double* r1 = r0 + kSpan * 6;
  double p[6];
#pragma unroll
  for (int k = 0; k < 6; ++k)
    p[k] = ndtpu::halfcell_pool4(r0[k], r0[6 + k], r1[k], r1[6 + k]);
  const int t = grid * nx * ny + j * nx + i;
  n_out[t] = ndtpu::halfcell_out(n_in[t], p[0]);
  s_out[2 * t + 0] = ndtpu::halfcell_out(s_in[2 * t + 0], p[1]);
  s_out[2 * t + 1] = ndtpu::halfcell_out(s_in[2 * t + 1], p[2]);
  ss_out[4 * t + 0] = ndtpu::halfcell_out(ss_in[4 * t + 0], p[3]);
  ss_out[4 * t + 1] = ndtpu::halfcell_out(ss_in[4 * t + 1], p[4]);
  ss_out[4 * t + 2] = ndtpu::halfcell_out(ss_in[4 * t + 2], p[4]);
  ss_out[4 * t + 3] = ndtpu::halfcell_out(ss_in[4 * t + 3], p[5]);
}

// Overlap 1: one thread per (cell, map); the cell is its own bin.
__global__ void __launch_bounds__(kThreads)
cell_moments_kernel(const long long* __restrict__ lattice,
                    const float* __restrict__ n_in,
                    const float* __restrict__ s_in,
                    const float* __restrict__ ss_in,
                    float* __restrict__ n_out, float* __restrict__ s_out,
                    float* __restrict__ ss_out, ndtpu::HalfcellGrid g) {
  const int cells = g.wh * g.hh;
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= cells) return;
  const size_t i = (size_t)blockIdx.y * cells + t;   // K3s: the map
  const longlong2* src = reinterpret_cast<const longlong2*>(lattice + 6 * i);
  const longlong2 a01 = src[0], a23 = src[1], a45 = src[2];
  const long long a[6] = {a01.x, a01.y, a23.x, a23.y, a45.x, a45.y};
  const int iy = t / g.wh;
  double m[6];
  ndtpu::halfcell_moments(a, t - iy * g.wh, iy, g, m);
  n_out[i] = ndtpu::halfcell_out(n_in[i], m[0]);
  s_out[2 * i + 0] = ndtpu::halfcell_out(s_in[2 * i + 0], m[1]);
  s_out[2 * i + 1] = ndtpu::halfcell_out(s_in[2 * i + 1], m[2]);
  ss_out[4 * i + 0] = ndtpu::halfcell_out(ss_in[4 * i + 0], m[3]);
  ss_out[4 * i + 1] = ndtpu::halfcell_out(ss_in[4 * i + 1], m[4]);
  ss_out[4 * i + 2] = ndtpu::halfcell_out(ss_in[4 * i + 2], m[4]);
  ss_out[4 * i + 3] = ndtpu::halfcell_out(ss_in[4 * i + 3], m[5]);
}

}  // namespace

// `maps` maps (1 for K3, S for K3s) of `m` points each; every array is
// [maps, ...]. overlap 4: inv = 2/cell, h = cell/2 (half cells, then the
// pool); overlap 1: inv = 1/cell, h = cell (cells, then the moments).
extern "C" int halfcell_add_launch(const void* pts, const void* mask,
                                   const void* weight, float wscalar,
                                   void* lattice, const void* n_in,
                                   const void* s_in, const void* ss_in,
                                   void* n_out, void* s_out, void* ss_out,
                                   int maps, int m, int nx, int ny, double x0,
                                   double y0, double inv, double h,
                                   int overlap, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const bool cells = overlap == 1;
  if (maps < 1 || (overlap != 1 && overlap != 4))
    return (int)cudaErrorInvalidValue;
  const ndtpu::HalfcellGrid g =
      cells ? ndtpu::make_halfcell_grid(x0, y0, inv, h, nx, ny)
            : ndtpu::make_halfcell_grid(x0, y0, inv, h, 2 * nx + 1,
                                        2 * ny + 1);
  cudaError_t err = cudaMemsetAsync(
      lattice, 0, (size_t)maps * g.wh * g.hh * 6 * sizeof(long long), st);
  if (err != cudaSuccess) return (int)err;
  if (m > 0) {
    const dim3 blocks((m + kThreads - 1) / kThreads, maps);
    auto* scatter = cells ? &halfcell_scatter_kernel<true>
                          : &halfcell_scatter_kernel<false>;
    scatter<<<blocks, kThreads, 0, st>>>(
        (const float2*)pts, (const uint8_t*)mask, (const float*)weight,
        wscalar, (unsigned long long*)lattice, m, g);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (cells) {
    const dim3 blocks((nx * ny + kThreads - 1) / kThreads, maps);
    cell_moments_kernel<<<blocks, kThreads, 0, st>>>(
        (const long long*)lattice, (const float*)n_in, (const float*)s_in,
        (const float*)ss_in, (float*)n_out, (float*)s_out, (float*)ss_out,
        g);
    return (int)cudaGetLastError();
  }
  const dim3 tiles((nx + kTile - 1) / kTile, (ny + kTile - 1) / kTile, maps);
  halfcell_pool_kernel<<<tiles, kPoolThreads, 0, st>>>(
      (const long long*)lattice, (const float*)n_in, (const float*)s_in,
      (const float*)ss_in, (float*)n_out, (float*)s_out, (float*)ss_out, nx,
      ny, g);
  return (int)cudaGetLastError();
}
