// K10b finalize_cells: the Gaussian of every NDT cell from its sums, in
// the statistics' own layout (no quad pack).
//
// Replaces what XLA lowered for the TPU from ndtpu/ndt/grid.py::finalize
// (:232-254, with _eig2x2_sym :211-229), elementwise over any leading shape,
// as ndtpu/dist/gridmap.py::finalize_slab (:167) calls it on the slab
// layout [G, nx_local, ny] and the dense one [G, C] alike.
//
// One thread per cell t: n[t], s[t] (float2), ss[t] (float4: sxx, sxy,
// syx, syy) in; ndt_cell.cuh's finalize_pack_cell (the device function K4
// and K8a run: mean, the eigenvalue-floored inverse covariance, valid, in
// the plain version's op order) into registers; mean[t] (float2), icov[t]
// (float4: i00, i01, i01, i11) and valid[t] out. Built with --fmad=false
// and without fast math, as the plain version's separate elementwise ops.
//
// What bounds it on Hopper: bytes, 28 B read and 28 B written per cell
// (the ~60 f32 operations of the eigen floor are far below the card's rate
// per byte); the loads and stores are 4-, 8- and 16-byte vectors that
// coalesce along the cells.

#include <cuda_runtime.h>

#include "ndt_cell.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
finalize_cells_kernel(const float* __restrict__ n,
                      const float2* __restrict__ s,
                      const float4* __restrict__ ss,
                      float2* __restrict__ mean, float4* __restrict__ icov,
                      float* __restrict__ valid, long long cells,
                      float min_pts, float eig_ratio, float eig_abs_min) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= cells) return;
  const float2 sv = s[t];
  const float4 q = ss[t];
  float4 cell[2];
  ndtpu::finalize_pack_cell(n[t], sv.x, sv.y, q.x, q.y, q.w, min_pts,
                            eig_ratio, eig_abs_min, cell);
  // cell = [mu_x, mu_y, i00, i01], [i11, valid, 0, 0]
  mean[t] = make_float2(cell[0].x, cell[0].y);
  icov[t] = make_float4(cell[0].z, cell[0].w, cell[0].w, cell[1].x);
  valid[t] = cell[1].y;
}

}  // namespace

// n [cells], s [cells, 2], ss [cells, 2, 2] f32 in; mean [cells, 2], icov
// [cells, 2, 2], valid [cells] f32 out.
extern "C" int finalize_cells_launch(const void* n, const void* s,
                                     const void* ss, void* mean, void* icov,
                                     void* valid, long long cells,
                                     float min_pts, float eig_ratio,
                                     float eig_abs_min, void* stream) {
  if (cells < 1) return (int)cudaErrorInvalidValue;
  const long long blocks = (cells + kThreads - 1) / kThreads;
  finalize_cells_kernel<<<(unsigned)blocks, kThreads, 0,
                          (cudaStream_t)stream>>>(
      (const float*)n, (const float2*)s, (const float4*)ss, (float2*)mean,
      (float4*)icov, (float*)valid, cells, min_pts, eig_ratio, eig_abs_min);
  return (int)cudaGetLastError();
}
