// Device code shared by K1 (ndt_terms.cu) and lm_ndt (lm_ndt.cu): one
// lane's 11 NDT sums at one pose, over the lane's beams, reduced over the
// block.
//
// Port of what ndtpu/ndt/match.py::match_batch_packed.make_sgh (:433-450)
// evaluates for one lane: the lane transform, the quad-row gather of
// ndtpu/ndt/grid.py::lookup_quad (:394-413) and the 11 weighted sums of
// ndtpu/ndt/match.py::point_terms_quad (:237-295), in their op order. The
// files that include this are built with --fmad=false and without fast
// math, so each multiply and add rounds on its own as PyTorch's separate
// elementwise kernels round them.
//
// Per beam i (threads stride over beams):
//   1. transform the sensor point by the pose (cosf/sinf, no fast math);
//   2. half-cell index hx = floor((x - x0) * inv), hy likewise (multiply,
//      no division: the twins' binning);
//   3. load the 32-float quad row (8 x float4, 128 B) holding the Gaussians
//      of all 4 overlap grids for that half-cell;
//   4. for each grid, the Mahalanobis term, exp(-d2/2 * l2) and the 11
//      weighted sums of point_terms_quad.
// Then warp shuffles + shared memory reduce the block's partial sums to
// (wsum, w0sum, g0, g1, g2, h00, h01, h02, h11, h12, h22). One block per
// lane keeps the reduction inside the block: no atomics, deterministic.
// Points that miss the lattice or are masked contribute exactly zero in the
// twin (every sum carries the factor w or w0), so they are skipped.

#pragma once

#include <cuda_runtime.h>

namespace ndtpu {

constexpr int kNdtThreads = 128;   // threads per lane (block)
constexpr int kNdtSums = 11;

// The lane's 11 sums at pose (tx, ty, phi). px, py, mask hold the lane's n
// sensor-frame beams (device or shared memory); table is the lane's
// [wh * hh, 32] quad table as 8 float4 per row. Every thread of the block
// must call it. part is kNdtThreads / 32 x kNdtSums floats of shared
// memory, free on entry. Thread k < kNdtSums gets sum k back, the others 0.
__device__ __forceinline__ float ndt_lane_sums(
    float tx, float ty, float phi, const float* px, const float* py,
    const float* mask, int n, const float4* __restrict__ table, int wh,
    int hh, float x0, float y0, float inv, float d2, float exp_clip,
    float (*part)[kNdtSums]) {
  const float c = cosf(phi);
  const float s = sinf(phi);
  const float nh = -0.5f * d2;

  float acc[kNdtSums];
#pragma unroll
  for (int k = 0; k < kNdtSums; ++k) acc[k] = 0.f;

  for (int i = threadIdx.x; i < n; i += kNdtThreads) {
    const float m = mask[i];
    if (m == 0.f) continue;
    const float sx = px[i];
    const float sy = py[i];
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

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < kNdtSums; ++k) {
    float v = acc[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) part[warp][k] = v;
  }
  __syncthreads();
  float v = 0.f;
  if (threadIdx.x < kNdtSums) {
#pragma unroll
    for (int w = 0; w < kNdtThreads / 32; ++w) v += part[w][threadIdx.x];
  }
  return v;
}

}  // namespace ndtpu
