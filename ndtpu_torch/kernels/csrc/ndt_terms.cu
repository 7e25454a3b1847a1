// K1: fused quad-row gather + NDT score / gradient / Hessian sums.
//
// Replaces, on the registration hot path, what XLA lowered for the TPU from
// ndtpu/ndt/grid.py::lookup_quad (:394-413) composed with
// ndtpu/ndt/match.py::point_terms_quad (:237-295) inside
// match_batch_packed.make_sgh (:433-450); the same 11-sum reduction as the
// deleted Pallas kernel point_terms_pallas (commit 330dab0,
// ndtpu/kernels/ndt_score.py), with the gather folded in.
//
// One block per lane b, threads over beams; the per-beam body and the block
// reduction are ndtpu::ndt_lane_sums (ndt_sums.cuh), which lm_ndt.cu runs
// once per LM iteration, so the two kernels cannot drift apart. Output
// out[b, 0..10] = (wsum, w0sum, g0, g1, g2, h00, h01, h02, h11, h12, h22).
// One instantiation per table layout (kG grids x kL lanes: 4 x 8, the
// overlap-4 full rows; 1 x 8, overlap 1; 4 x 4 and 1 x 4, their compact
// bf16-pair rows, grid.py::pack_quad's compact=True).
//
// Grouped form (loop verification): with group != nullptr, lane b reads
// table group[b] of a stack of n_tables tables of rows_per_table rows each,
// i.e. row group[b] * rows_per_table + hy * wh + hx of the flat [S*R, 32]
// cache; this is ndtpu/ndt/grid.py::lookup_quad_grouped (:450), which
// match_batch_packed also uses for per-lane [B, R, L] tables (:419-431).
// group[b] is clamped into [0, n_tables), as XLA clamps an out-of-range
// gather.
//
// What bounds it on Hopper: one dependent 128-byte row gather per beam. The
// shared config-2 table (5.2 MB) stays resident in the 50 MB L2. The
// config-3 keyframe cache (315 MB at 1,024 slots) does not; each lane
// touches one 307 KB local table, so 64 lanes' working set (~20 MB) still
// fits in L2. The arithmetic (~120 flops per beam) is small. On the main
// path this body runs inside lm_ndt; K1 stays the card's 11-sum kernel.

#include <cuda_runtime.h>

#include "ndt_sums.cuh"

namespace {

using ndtpu::kNdtSums;
using ndtpu::kNdtThreads;

template <int kG, int kL>
__global__ void __launch_bounds__(kNdtThreads)
ndt_terms_kernel(const float* __restrict__ poses, const float* __restrict__ px,
                 const float* __restrict__ py, const float* __restrict__ mask,
                 const float4* __restrict__ table,
                 const int* __restrict__ group, float* __restrict__ out,
                 int n, int wh, int hh, int rows_per_table, int n_tables,
                 float x0, float y0, float inv, float d2, float exp_clip) {
  __shared__ float part[kNdtThreads / 32][kNdtSums];
  const int b = blockIdx.x;
  if (group != nullptr) {
    const int g = min(max(group[b], 0), n_tables - 1);
    table += (size_t)g * rows_per_table * ndtpu::row_float4<kG, kL>();
  }
  const size_t base = (size_t)b * n;
  const float v = ndtpu::ndt_lane_sums<kG, kL>(
      poses[3 * b + 0], poses[3 * b + 1], poses[3 * b + 2], px + base,
      py + base, mask + base, n, table, wh, hh, x0, y0, inv, d2, exp_clip,
      part);
  if (threadIdx.x < kNdtSums) out[(size_t)b * kNdtSums + threadIdx.x] = v;
}

}  // namespace

extern "C" int ndt_terms_launch(const void* poses, const void* px,
                                const void* py, const void* mask,
                                const void* table, const void* group,
                                void* out, int b, int n, int wh, int hh,
                                int rows_per_table, int n_tables, float x0,
                                float y0, float inv, float d2, float exp_clip,
                                int grids, int lanes, void* stream) {
  return ndtpu::with_layout(grids, lanes, [&](auto kg, auto kl) {
    ndt_terms_kernel<decltype(kg)::value, decltype(kl)::value>
        <<<b, kNdtThreads, 0, (cudaStream_t)stream>>>(
            (const float*)poses, (const float*)px, (const float*)py,
            (const float*)mask, (const float4*)table, (const int*)group,
            (float*)out, n, wh, hh, rows_per_table, n_tables, x0, y0, inv,
            d2, exp_clip);
    return (int)cudaGetLastError();
  });
}

extern "C" const char* ndtpu_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
