// K1: fused quad-row gather + NDT score / gradient / Hessian sums.
//
// Replaces, on the registration hot path, what XLA lowered for the TPU from
// ndtpu/ndt/grid.py::lookup_quad (:394-413) composed with
// ndtpu/ndt/match.py::point_terms_quad (:237-295) inside
// match_batch_packed.make_sgh (:433-450); the same 11-sum reduction as the
// deleted Pallas kernel point_terms_pallas (commit 330dab0,
// ndtpu/kernels/ndt_score.py), with the gather folded in.
//
// Per lane b (one block) and beam i (threads stride over beams):
//   1. transform the sensor point by the lane pose (cosf/sinf, no fast math);
//   2. half-cell index hx = floor((x - x0) * inv), hy likewise, exactly the
//      twin's op order (multiply, no division; built with --fmad=false);
//   3. load the 32-float quad row (8 x float4, 128 B) holding the Gaussians
//      of all 4 overlap grids for that half-cell;
//   4. for each grid, the Mahalanobis term, exp(-d2/2 * l2) and the 11
//      weighted sums of point_terms_quad, in its op order;
//   5. warp-shuffle + shared-memory reduction to out[b, 0..10] =
//      (wsum, w0sum, g0, g1, g2, h00, h01, h02, h11, h12, h22).
//
// Grouped form (loop verification): with group != nullptr, lane b reads
// table group[b] of a stack of n_tables tables of rows_per_table rows each,
// i.e. row group[b] * rows_per_table + hy * wh + hx of the flat [S*R, 32]
// cache; this is ndtpu/ndt/grid.py::lookup_quad_grouped (:450), which
// match_batch_packed also uses for per-lane [B, R, L] tables (:419-431).
// The verifier passes the whole keyframe cache with group = candidate
// index, so no per-lane copy of the tables is gathered. group[b] is
// clamped into [0, n_tables), as XLA clamps an out-of-range gather.
//
// What bounds it on Hopper: one dependent 128-byte row gather per beam. The
// shared config-2 table (5.2 MB) stays resident in the 50 MB L2 across the
// LM iterations. The config-3 keyframe cache (315 MB at 1,024 slots) does
// not; each lane touches one 307 KB local table, so the 64 verify lanes'
// working set (~20 MB) still fits in L2. The arithmetic (~120 flops per
// beam) is small. One block per
// lane keeps the reduction inside the block (no atomics, deterministic).
// Points that miss the lattice or are masked contribute exactly zero in the
// twin (every sum carries the factor w or w0), so they are skipped.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kSums = 11;

__global__ void __launch_bounds__(kThreads)
ndt_terms_kernel(const float* __restrict__ poses, const float* __restrict__ px,
                 const float* __restrict__ py, const float* __restrict__ mask,
                 const float4* __restrict__ table,
                 const int* __restrict__ group, float* __restrict__ out,
                 int n, int wh, int hh, int rows_per_table, int n_tables,
                 float x0, float y0, float inv, float d2, float exp_clip) {
  const int b = blockIdx.x;
  if (group != nullptr) {
    const int g = min(max(group[b], 0), n_tables - 1);
    table += (size_t)g * rows_per_table * 8;
  }
  const float tx = poses[3 * b + 0];
  const float ty = poses[3 * b + 1];
  const float c = cosf(poses[3 * b + 2]);
  const float s = sinf(poses[3 * b + 2]);
  const float nh = -0.5f * d2;

  float acc[kSums];
#pragma unroll
  for (int k = 0; k < kSums; ++k) acc[k] = 0.f;

  const size_t base = (size_t)b * n;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const float m = mask[base + i];
    if (m == 0.f) continue;
    const float sx = px[base + i];
    const float sy = py[base + i];
    const float x = c * sx - s * sy + tx;
    const float y = s * sx + c * sy + ty;
    const float hx = floorf((x - x0) * inv);
    const float hy = floorf((y - y0) * inv);
    if (!(hx >= 0.f && hx < (float)wh && hy >= 0.f && hy < (float)hh)) continue;
    const float4* row = table + ((size_t)((int)hy * wh + (int)hx)) * 8;
    const float dpx = -s * sx - c * sy;
    const float dpy = c * sx - s * sy;
    const float rx = x - tx;
    const float ry = y - ty;
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      const float4 p = __ldg(row + 2 * g);      // mu_x, mu_y, i00, i01
      const float4 q = __ldg(row + 2 * g + 1);  // i11, valid, 0, 0
      const float i00 = p.z, i01 = p.w, i11 = q.x;
      const float dx = x - p.x;
      const float dy = y - p.y;
      const float qx = i00 * dx + i01 * dy;
      const float qy = i01 * dx + i11 * dy;
      const float l2 = fmaxf(dx * qx + dy * qy, 0.f);
      const float e = expf(nh * fminf(l2, exp_clip));
      const float w0 = q.y * m;
      const float w = w0 * e;
      const float a3 = qx * dpx + qy * dpy;
      const float ldx = i00 * dpx + i01 * dpy;
      const float ldy = i01 * dpx + i11 * dpy;
      const float j33 = dpx * ldx + dpy * ldy;
      const float hpp = -(qx * rx + qy * ry);
      acc[0] += w;
      acc[1] += w0;
      acc[2] += w * qx;
      acc[3] += w * qy;
      acc[4] += w * a3;
      acc[5] += w * (i00 - d2 * qx * qx);
      acc[6] += w * (i01 - d2 * qx * qy);
      acc[7] += w * (ldx - d2 * qx * a3);
      acc[8] += w * (i11 - d2 * qy * qy);
      acc[9] += w * (ldy - d2 * qy * a3);
      acc[10] += w * (j33 + hpp - d2 * a3 * a3);
    }
  }

  __shared__ float part[kThreads / 32][kSums];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < kSums; ++k) {
    float v = acc[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) part[warp][k] = v;
  }
  __syncthreads();
  if (threadIdx.x < kSums) {
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) v += part[w][threadIdx.x];
    out[(size_t)b * kSums + threadIdx.x] = v;
  }
}

}  // namespace

extern "C" int ndt_terms_launch(const void* poses, const void* px,
                                const void* py, const void* mask,
                                const void* table, const void* group,
                                void* out, int b, int n, int wh, int hh,
                                int rows_per_table, int n_tables, float x0,
                                float y0, float inv, float d2, float exp_clip,
                                void* stream) {
  ndt_terms_kernel<<<b, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)poses, (const float*)px, (const float*)py,
      (const float*)mask, (const float4*)table, (const int*)group,
      (float*)out, n, wh, hh, rows_per_table, n_tables, x0, y0, inv, d2,
      exp_clip);
  return (int)cudaGetLastError();
}

extern "C" const char* ndtpu_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
