// K8a: the per-keyframe local NDT quad tables of a window, written straight
// into the keyframe cache.
//
// Replaces what XLA lowered for the TPU from
// ndtpu/loop/closure.py::build_local_table (:84-98), vmapped over a
// window's scans and scattered into the cache at
// ndtpu/slam/pipeline.py:447-450: per keyframe, the half-cell moment
// scatter of its own scan in its own sensor frame on the local grid
// (grid.py::_add_points_halfcell, :161-203, on empty statistics), the 2x2
// pooling into the 4 overlap grids, finalize and pack_quad. A keyframe's
// table depends on its scan alone, so it is built once and never
// invalidated.
//
// Grid: (keyframe w) x (band of `band_rows` table rows). Nothing is written
// unless ok[w], and then the rows go to tables[slot[w]]; blocks of skipped
// keyframes exit at once. A band's table row hy reads lattice rows
// hy-1 .. hy+1 (ndt_cell.cuh: quad_slot_cell), so each block
//   1. zeroes its (band_rows + 2) lattice rows of int64 sums in dynamic
//      shared memory (the wrapper keeps this within the 48 KB a block gets
//      without an opt-in);
//   2. bins all N points of its keyframe and adds those that fall in its
//      rows with K3's fixed-point arithmetic (halfcell_fixed.cuh) as
//      shared-memory 64-bit atomics: the sums do not depend on the order
//      of the adds, so the table is the same on every run and under any
//      permutation of the points;
//   3. reconstructs each half-cell's f64 moments in place;
//   4. for each of its band's 4 x band_rows x wh (row, grid) slots, pools
//      the slot's cell in K3's order, rounds the moments to f32 as K3 does
//      on empty statistics, and finalizes and packs them with K4's device
//      code (ndt_cell.cuh), four threads per 128-byte row as float4 stores.
// So a keyframe's table equals K4 applied to K3's statistics of its scan
// on empty statistics, bit for bit.
//
// Layouts, as K4's (ndt_cell.cuh): full (kL = 8) or compact (kL = 4,
// [mu_x, mu_y, pack(i00, i01), pack(i11, valid)]) slots, and a local grid
// of overlap 4 (above) or 1 (kCells, LoopConfig.local_overlap = 1:
// closure.py::local_table_shape :73-81 and build_local_table :84-98 on one
// grid). At overlap 1 the lattice is the local grid's nx x ny cells, binned
// as K3's overlap-1 mode bins them (halfcell_fixed.cuh's cell_bin, with h
// = cell): a band is `band_rows` cell rows, which are also its table rows,
// so it holds no halo row and pools nothing; each cell's sums are rounded
// to f32 as K3 does and finalized with K4's device code.
//
// Sizes: a 24 x 24 local grid (config 3, 12 m half extent at 1 m) gives a
// 49 x 49 lattice and 2,401 table rows x 128 B = 307 KB per keyframe. The
// wrapper cuts bands as thin as the card holds at once: at W = 8, 49 bands
// of one row (392 blocks on 132 SMs), each holding 3 x 49 half-cells x
// 48 B = 7,056 B of shared memory.
//
// What bounds it on Hopper: the table writes (307 KB per keyframe) for the
// bound; in practice each block's chain of dependent steps (point loads,
// shared atomics, three barriers, the finalizes' IEEE divides and square
// roots without fast math), which thin bands keep short. Each block
// re-reads its keyframe's 360 points (3.2 KB, from L2).

#include <cuda_runtime.h>
#include <stdint.h>

#include "halfcell_fixed.cuh"
#include "ndt_cell.cuh"

namespace {

constexpr int kThreads = 256;

template <bool kCells, int kL>
__global__ void __launch_bounds__(kThreads)
local_tables_kernel(const float2* __restrict__ pts,
                    const uint8_t* __restrict__ mask,
                    const int* __restrict__ slot,
                    const uint8_t* __restrict__ ok,
                    float4* __restrict__ tables, int n, int nx, int ny,
                    int capacity, int band_rows, ndtpu::HalfcellGrid g,
                    float min_pts, float eig_ratio, float eig_abs_min) {
  extern __shared__ unsigned long long lattice[];
  const int w = blockIdx.x;
  const int s = slot[w];
  if (!ok[w] || s < 0 || s >= capacity) return;
  constexpr int kP = kL / 4;                    // float4 per slot
  const int wh = g.wh;
  const int r0 = blockIdx.y * band_rows;        // the band's table rows
  const int r1 = min(r0 + band_rows, g.hh);     // [r0, r1)
  // Lattice row of smem row 0, and the rows held: a halo row on each side
  // at overlap 4 (the pool reads them), none at overlap 1.
  const int l0 = kCells ? r0 : r0 - 1;
  const int cells = (kCells ? band_rows : band_rows + 2) * wh;
  for (int i = threadIdx.x; i < cells * 6; i += kThreads) lattice[i] = 0ull;
  __syncthreads();

  const float2* p = pts + (size_t)w * n;
  const uint8_t* m = mask + (size_t)w * n;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    if (!m[i]) continue;
    const float2 q = p[i];
    int hx, hy;
    if (kCells) {
      if (!ndtpu::cell_bin(q.x, q.y, g.x0f, g.y0f, 0.f, 0.f, g.hf, wh, g.hh,
                           &hx, &hy))
        continue;
      if (hy < r0 || hy >= r1) continue;          // outside the band's rows
    } else {
      if (!ndtpu::halfcell_bin(q.x, q.y, g, &hx, &hy)) continue;
      if (hy < l0 || hy > r1) continue;           // outside the band's rows
    }
    long long v[6];
    ndtpu::halfcell_quantize(q.x, q.y, 1.f, hx, hy, g, v);
    unsigned long long* cell = lattice + ((hy - l0) * wh + hx) * 6;
#pragma unroll
    for (int k = 0; k < 6; ++k) atomicAdd(cell + k, (unsigned long long)v[k]);
  }
  __syncthreads();

  // Reconstruct in place: each half-cell's six int64 sums become its six
  // f64 moments in the same 48 bytes (one thread per half-cell).
  double* mom = reinterpret_cast<double*>(lattice);
  for (int c = threadIdx.x; c < cells; c += kThreads) {
    const int ly = c / wh;
    long long a[6];
#pragma unroll
    for (int k = 0; k < 6; ++k) a[k] = (long long)lattice[c * 6 + k];
    double v[6];
    ndtpu::halfcell_moments(a, c - ly * wh, l0 + ly, g, v);
#pragma unroll
    for (int k = 0; k < 6; ++k) mom[c * 6 + k] = v[k];
  }
  __syncthreads();

  constexpr int kG = kCells ? 1 : 4;
  float4* table = tables + (size_t)s * wh * g.hh * kG * kP;
  if (kCells) {                    // table row = cell; no pool
    for (int c = r0 * wh + threadIdx.x; c < r1 * wh; c += kThreads) {
      const double* a = mom + (c - l0 * wh) * 6;
      float v[6];
#pragma unroll
      for (int k = 0; k < 6; ++k) v[k] = ndtpu::halfcell_out(0.f, a[k]);
      ndtpu::finalize_pack_cell<kL>(v[0], v[1], v[2], v[3], v[4], v[5],
                                    min_pts, eig_ratio, eig_abs_min,
                                    table + (size_t)c * kP);
    }
    return;
  }
  for (int t = 4 * r0 * wh + threadIdx.x; t < 4 * r1 * wh; t += kThreads) {
    float4* out = table + (size_t)t * kP;
    const int c = ndtpu::quad_slot_cell(t, nx, ny);
    if (c < 0) {
      ndtpu::store_zero_slot<kL>(out);
      continue;
    }
    const int grid = t & 3;
    const int j = c / nx;
    const int i = c - j * nx;
    const double* a = mom + ((2 * j + (grid >> 1) - l0) * wh
                             + 2 * i + (grid & 1)) * 6;
    const double* b = a + wh * 6;
    float v[6];
#pragma unroll
    for (int k = 0; k < 6; ++k)
      v[k] = ndtpu::halfcell_out(
          0.f, ndtpu::halfcell_pool4(a[k], a[6 + k], b[k], b[6 + k]));
    ndtpu::finalize_pack_cell<kL>(v[0], v[1], v[2], v[3], v[4], v[5],
                                  min_pts, eig_ratio, eig_abs_min, out);
  }
}

}  // namespace

// overlap 4: inv = 2/cell, h = cell/2 (half cells); overlap 1: inv =
// 1/cell, h = cell (cells). lanes: 8 (full) or 4 (compact) per grid.
extern "C" int local_tables_launch(const void* pts, const void* mask,
                                   const void* slot, const void* ok,
                                   void* tables, int w, int n, int nx, int ny,
                                   int capacity, int band_rows, int bands,
                                   double x0, double y0, double inv, double h,
                                   float min_pts, float eig_ratio,
                                   float eig_abs_min, int smem_bytes,
                                   int overlap, int lanes, void* stream) {
  if ((overlap != 4 && overlap != 1) || (lanes != 8 && lanes != 4))
    return (int)cudaErrorInvalidValue;
  const bool cells = overlap == 1;
  const ndtpu::HalfcellGrid g =
      cells ? ndtpu::make_halfcell_grid(x0, y0, inv, h, nx, ny)
            : ndtpu::make_halfcell_grid(x0, y0, inv, h, 2 * nx + 1,
                                        2 * ny + 1);
  auto* kernel =
      cells ? (lanes == 8 ? &local_tables_kernel<true, 8>
                          : &local_tables_kernel<true, 4>)
            : (lanes == 8 ? &local_tables_kernel<false, 8>
                          : &local_tables_kernel<false, 4>);
  kernel<<<dim3(w, bands), kThreads, smem_bytes, (cudaStream_t)stream>>>(
      (const float2*)pts, (const uint8_t*)mask, (const int*)slot,
      (const uint8_t*)ok, (float4*)tables, n, nx, ny, capacity, band_rows, g,
      min_pts, eig_ratio, eig_abs_min);
  return (int)cudaGetLastError();
}
