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
// One CTA per keyframe w; nothing is written unless ok[w], and then the
// rows go to tables[slot[w]]:
//   1. zero the (2n+1)^2 x 6 f32 moment lattice in dynamic shared memory;
//   2. threads stride over the scan's points: fx = floor((x - x0) * inv),
//      fy likewise (K3's op order; built with --fmad=false), then six
//      shared-memory atomicAdds (1, x, y, x*x, x*y, y*y);
//   3. threads stride over the table's 4 * (2n+1)^2 (row, grid) slots: the
//      slot's cell sums its 2x2 lattice block in K3's pooling order and is
//      finalized and packed by K4's device code (ndt_cell.cuh).
// The statistics never leave shared memory.
//
// Sizes: a 24 x 24 local grid (config 3, 12 m half extent at 1 m) gives a
// 49 x 49 lattice: 57,624 B of shared memory, over the 48 KB default, so
// the launcher opts the kernel in with cudaFuncSetAttribute first; the
// wrapper refuses a lattice above the 227 KB a block can have (61 x 61 =
// 89,304 B for LoopConfig's default 15 m). The table is 2,401 rows x 128 B
// = 307 KB per keyframe.
//
// What bounds it on Hopper: the table writes (307 KB per keyframe, float4
// stores, four threads per 128-byte row) and the 9,604 finalizes, each
// with two IEEE divides and sqrts; the 360-point scatter is small. Shared-
// memory atomics add in a varying order (as K3's global ones do), so the
// moments' last bits vary from run to run; counts of unit weights are
// exact.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ndt_cell.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
local_tables_kernel(const float2* __restrict__ pts,
                    const uint8_t* __restrict__ mask,
                    const int* __restrict__ slot,
                    const uint8_t* __restrict__ ok,
                    float4* __restrict__ tables, int n, int nx, int ny,
                    int capacity, float x0, float y0, float inv,
                    float min_pts, float eig_ratio, float eig_abs_min) {
  extern __shared__ float lattice[];
  const int w = blockIdx.x;
  const int s = slot[w];
  if (!ok[w] || s < 0 || s >= capacity) return;
  const int wh = 2 * nx + 1, hh = 2 * ny + 1;
  for (int i = threadIdx.x; i < wh * hh * 6; i += kThreads) lattice[i] = 0.f;
  __syncthreads();

  const float2* p = pts + (size_t)w * n;
  const uint8_t* m = mask + (size_t)w * n;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    if (!m[i]) continue;
    const float2 q = p[i];
    const float fx = floorf((q.x - x0) * inv);
    const float fy = floorf((q.y - y0) * inv);
    if (!(fx >= 0.f && fx < (float)wh && fy >= 0.f && fy < (float)hh))
      continue;
    float* cell = lattice + ((int)fy * wh + (int)fx) * 6;
    atomicAdd(cell + 0, 1.f);
    atomicAdd(cell + 1, q.x);
    atomicAdd(cell + 2, q.y);
    atomicAdd(cell + 3, q.x * q.x);
    atomicAdd(cell + 4, q.x * q.y);
    atomicAdd(cell + 5, q.y * q.y);
  }
  __syncthreads();

  float4* table = tables + (size_t)s * wh * hh * 8;
  for (int t = threadIdx.x; t < 4 * wh * hh; t += kThreads) {
    float4* out = table + (size_t)t * 2;
    const int c = ndtpu::quad_slot_cell(t, nx, ny);
    if (c < 0) {
      ndtpu::store_zero_slot(out);
      continue;
    }
    const int g = t & 3;
    const int j = c / nx;
    const int i = c - j * nx;
    const float* r0 = lattice + ((g >> 1) + 2 * j) * wh * 6 +
                      ((g & 1) + 2 * i) * 6;
    const float* r1 = r0 + wh * 6;
    float v[6];
#pragma unroll
    for (int k = 0; k < 6; ++k)
      v[k] = ((r0[k] + r0[6 + k]) + r1[k]) + r1[6 + k];
    ndtpu::finalize_pack_cell(v[0], v[1], v[2], v[3], v[4], v[5], min_pts,
                              eig_ratio, eig_abs_min, out);
  }
}

}  // namespace

extern "C" int local_tables_launch(const void* pts, const void* mask,
                                   const void* slot, const void* ok,
                                   void* tables, int w, int n, int nx, int ny,
                                   int capacity, float x0, float y0,
                                   float inv, float min_pts, float eig_ratio,
                                   float eig_abs_min, int smem_bytes,
                                   void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      local_tables_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (err != cudaSuccess) {
    cudaGetLastError();   // clear it, so the next launch's check is clean
    return (int)err;
  }
  local_tables_kernel<<<w, kThreads, smem_bytes, (cudaStream_t)stream>>>(
      (const float2*)pts, (const uint8_t*)mask, (const int*)slot,
      (const uint8_t*)ok, (float4*)tables, n, nx, ny, capacity, x0, y0, inv,
      min_pts, eig_ratio, eig_abs_min);
  return (int)cudaGetLastError();
}
