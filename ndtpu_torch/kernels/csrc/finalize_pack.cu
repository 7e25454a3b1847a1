// K4: finalize every NDT cell and write the half-cell quad table directly.
//
// Replaces what XLA lowered for the TPU from ndtpu/ndt/grid.py::finalize
// (:232-254, with _eig2x2_sym :211-229) followed by pack_quad (:336-391,
// compact=False): per-cell mean, covariance, closed-form 2x2 eigenvalues
// with the max(eig_abs_min, eig_ratio * lambda_max) floor, the inverse
// covariance, valid = n >= min_pts; then the x2 upsample, the (gx, gy)
// shift with zero rows outside grid g (pack_quad's jnp.pad), and the
// concatenation of the 4 grids into one 32-float row per half-cell.
//
// One thread per (half-cell r, grid g) writes its 8 floats
// [mu_x, mu_y, i00, i01, i11, valid, 0, 0] at table[r, 8g .. 8g+7]; four
// neighbouring threads fill one 128-byte row, so the stores coalesce. Each
// cell is finalized by the 4 threads of its 2x2 block (recomputing ~40
// flops is cheaper than a second pass). No NDTMap is materialized on the
// card path. The per-cell code lives in ndt_cell.cuh, shared with K8a.
//
// What bounds it on Hopper: the writes (5.2 MB at config 2) and the stats
// reads (~1.4 MB); the arithmetic, including two IEEE divides and sqrts per
// cell (no fast math), is minor. The op order and the 1e-20 / 1e-30 guards
// of _eig2x2_sym are kept as written.

#include <cuda_runtime.h>

#include "ndt_cell.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
finalize_pack_kernel(const float* __restrict__ n_in,
                     const float* __restrict__ s_in,
                     const float* __restrict__ ss_in,
                     float4* __restrict__ table, int nx, int ny,
                     float min_pts, float eig_ratio, float eig_abs_min) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= 4 * (2 * nx + 1) * (2 * ny + 1)) return;
  float4* out = table + (size_t)t * 2;
  const int c = ndtpu::quad_slot_cell(t, nx, ny);
  if (c < 0) {
    ndtpu::store_zero_slot(out);
    return;
  }
  const int cell = (t & 3) * nx * ny + c;
  ndtpu::finalize_pack_cell(n_in[cell], s_in[2 * cell + 0],
                            s_in[2 * cell + 1], ss_in[4 * cell + 0],
                            ss_in[4 * cell + 1], ss_in[4 * cell + 3], min_pts,
                            eig_ratio, eig_abs_min, out);
}

}  // namespace

extern "C" int finalize_pack_launch(const void* n_in, const void* s_in,
                                    const void* ss_in, void* table, int nx,
                                    int ny, float min_pts, float eig_ratio,
                                    float eig_abs_min, void* stream) {
  const int total = 4 * (2 * nx + 1) * (2 * ny + 1);
  const int blocks = (total + kThreads - 1) / kThreads;
  finalize_pack_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)n_in, (const float*)s_in, (const float*)ss_in,
      (float4*)table, nx, ny, min_pts, eig_ratio, eig_abs_min);
  return (int)cudaGetLastError();
}
