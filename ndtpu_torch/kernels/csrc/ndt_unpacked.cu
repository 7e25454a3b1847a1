// K12 ndt_sgh_unpacked: the NDT objective, gradient, Hessian and score of
// one shared scan at B poses, on an unpacked NDTMap.
//
// Replaces what XLA lowered for the TPU from jax.vmap of
// ndtpu/ndt/match.py::score_grad_hess (:108) over poses, with
// ndtpu/ndt/grid.py::lookup (:288) and ndtpu/ndt/match.py::point_terms
// (:65) inside it, as ndtpu/slam/merge.py::global_align (:93-100) calls it
// to rank its hypotheses by total mass.
//
// One block per pose b, threads over the N beams of the one scan (read once
// per block from L2: no [B, N] copy). Per beam: the transform, then for
// each of the kG overlap grids (4, or 1 at overlap 1; the shifts of
// ndtpu/ndt/grid.py::_grid_offsets :78-86, (0, 0) alone at overlap 1) the
// cell index exactly as cell_ids computes it (((x - x0) - shift) / cell,
// floor, in-bounds test; the per-grid shift, unlike the quad lattice's
// shared half-cell index), a gather of the
// cell's mean (float2), inverse covariance (float4, its three unique
// entries used) and valid flag, and the 11 sums of ndt_sums.cuh's
// ndt_add_terms. A beam that is masked, out of a grid or in an invalid
// cell adds exactly zero in the plain version (w0 = 0), so it is skipped.
// The block reduces its sums in a fixed order (ndt_block_sums; no float
// atomics, so repeated launches are bit-equal), and thread 0 writes
// out[b] = (f, g0, g1, g2, H00..H22, score) with score = wsum / max(w0sum,
// 1), as score_grad_hess returns them.
//
// K10c slab_sgh (slab_sgh_kernel below) is the same body on one rank's
// x-slab of a spatially sharded map: it replaces the per-rank sgh of
// ndtpu/dist/gridmap.py::match_slab (:189-209: transform_terms, _cell_xy,
// the ownership mask mine = x_lo <= ix < x_lo + nx_local, the clipped
// ix-major gather from [G, nx_local, ny] and point_terms with w0 = valid *
// (mine & inb) * mask), before its psum. A beam outside the rank's slab
// adds exactly zero there, so it is skipped. It writes the 15 raw sums
// out[b] = (f, wsum, w0sum, g0..g2, H00..H22), the vector the reference
// psums, in the same fixed-order block reduction, so a rank's partial is
// the same on every launch. match_slab launches it once per LM evaluation
// with B = 1.
//
// Both kernels are templates on kG, the grid count of the map ([kG, C,
// ...] for K12, [kG, nx_local, ny, ...] ix-major for K10c); each is its own
// instantiation, counted apart by the wrappers (ndt_sgh_unpacked[g1],
// slab_sgh[g1]). The block reduction is the same at either kG.
//
// What bounds it on Hopper: the operations, ~300 f32 flops per in-map
// beam at kG = 4, ~90 at kG = 1 (the map, 7 MB at config 5's 4 x 65,536
// cells, stays in the 50 MB L2); the cell gathers are dependent loads, so
// latency-bound below a few thousand poses. Built with --fmad=false like
// the plain version's separate elementwise ops.

#include <cuda_runtime.h>

#include "ndt_sums.cuh"

namespace {

using ndtpu::kNdtSums;
using ndtpu::kNdtThreads;

constexpr int kOut = 14;   // f, g[3], H[3 x 3], score
constexpr int kSlabOut = 15;   // f, wsum, w0sum, g[3], H[3 x 3]

// out[0..] = (f, g, H) from the reduced sums, H symmetric in full.
__device__ __forceinline__ void write_fgh(float* o, const float* sums,
                                          float d2) {
  o[0] = -sums[0];
  o[1] = d2 * sums[2];
  o[2] = d2 * sums[3];
  o[3] = d2 * sums[4];
  const float h00 = d2 * sums[5], h01 = d2 * sums[6], h02 = d2 * sums[7];
  const float h11 = d2 * sums[8], h12 = d2 * sums[9], h22 = d2 * sums[10];
  o[4] = h00; o[5] = h01; o[6] = h02;
  o[7] = h01; o[8] = h11; o[9] = h12;
  o[10] = h02; o[11] = h12; o[12] = h22;
}

template <int kG>
__global__ void __launch_bounds__(kNdtThreads)
ndt_sgh_unpacked_kernel(const float* __restrict__ poses,
                        const float2* __restrict__ pts,
                        const float* __restrict__ mask,
                        const float2* __restrict__ mean,
                        const float4* __restrict__ icov,
                        const float* __restrict__ valid,
                        float* __restrict__ out, int n, int nx, int ny,
                        float x0, float y0, float cell, float d2,
                        float exp_clip) {
  __shared__ float part[kNdtThreads / 32][kNdtSums];
  __shared__ float sums[kNdtSums];
  const int b = blockIdx.x;
  const float tx = poses[3 * b + 0];
  const float ty = poses[3 * b + 1];
  const float phi = poses[3 * b + 2];
  const float c = cosf(phi);
  const float s = sinf(phi);
  const float nh = -0.5f * d2;
  const float h = cell / 2.f;
  const size_t n_cells = (size_t)nx * ny;

  float acc[kNdtSums];
#pragma unroll
  for (int k = 0; k < kNdtSums; ++k) acc[k] = 0.f;

  for (int i = threadIdx.x; i < n; i += kNdtThreads) {
    const float m = mask[i];
    if (m == 0.f) continue;
    const float2 p = pts[i];
    const float x = c * p.x - s * p.y + tx;
    const float y = s * p.x + c * p.y + ty;
    const float dpx = -s * p.x - c * p.y;
    const float dpy = c * p.x - s * p.y;
    const float rx = x - tx;
    const float ry = y - ty;
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      const float ox = (g & 1) ? h : 0.f;
      const float oy = (g & 2) ? h : 0.f;
      const float fx = floorf(((x - x0) - ox) / cell);
      const float fy = floorf(((y - y0) - oy) / cell);
      if (!(fx >= 0.f && fx < (float)nx && fy >= 0.f && fy < (float)ny))
        continue;
      const size_t id = g * n_cells + (size_t)((int)fy * nx + (int)fx);
      const float v = __ldg(valid + id);
      if (v == 0.f) continue;
      const float2 mu = __ldg(mean + id);
      const float4 ic = __ldg(icov + id);     // i00, i01, i10, i11
      ndtpu::ndt_add_terms(acc, x, y, dpx, dpy, rx, ry, mu.x, mu.y, ic.x,
                           ic.y, ic.w, v * m, d2, nh, exp_clip);
    }
  }
  const float v = ndtpu::ndt_block_sums(acc, part);
  if (threadIdx.x < kNdtSums) sums[threadIdx.x] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    float* o = out + (size_t)b * kOut;
    write_fgh(o, sums, d2);
    o[13] = sums[0] / fmaxf(sums[1], 1.f);
  }
}

// K10c: the rank's raw sums over its slab [kG, nx_local, ny] (ix-major),
// grid columns [x_lo, x_lo + nx_local).
template <int kG>
__global__ void __launch_bounds__(kNdtThreads)
slab_sgh_kernel(const float* __restrict__ poses,
                const float2* __restrict__ pts,
                const float* __restrict__ mask,
                const float2* __restrict__ mean,
                const float4* __restrict__ icov,
                const float* __restrict__ valid, float* __restrict__ out,
                int n, int nx, int ny, int x_lo, int nx_local, float x0,
                float y0, float cell, float d2, float exp_clip) {
  __shared__ float part[kNdtThreads / 32][kNdtSums];
  __shared__ float sums[kNdtSums];
  const int b = blockIdx.x;
  const float tx = poses[3 * b + 0];
  const float ty = poses[3 * b + 1];
  const float phi = poses[3 * b + 2];
  const float c = cosf(phi);
  const float s = sinf(phi);
  const float nh = -0.5f * d2;
  const float h = cell / 2.f;
  const size_t slab_cells = (size_t)nx_local * ny;

  float acc[kNdtSums];
#pragma unroll
  for (int k = 0; k < kNdtSums; ++k) acc[k] = 0.f;

  for (int i = threadIdx.x; i < n; i += kNdtThreads) {
    const float m = mask[i];
    if (m == 0.f) continue;
    const float2 p = pts[i];
    const float x = c * p.x - s * p.y + tx;
    const float y = s * p.x + c * p.y + ty;
    const float dpx = -s * p.x - c * p.y;
    const float dpy = c * p.x - s * p.y;
    const float rx = x - tx;
    const float ry = y - ty;
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      const float ox = (g & 1) ? h : 0.f;
      const float oy = (g & 2) ? h : 0.f;
      const float fx = floorf(((x - x0) - ox) / cell);
      const float fy = floorf(((y - y0) - oy) / cell);
      if (!(fx >= 0.f && fx < (float)nx && fy >= 0.f && fy < (float)ny))
        continue;
      const int lx = (int)fx - x_lo;
      if (lx < 0 || lx >= nx_local) continue;     // another rank's cell
      const size_t id = g * slab_cells + (size_t)lx * ny + (int)fy;
      const float v = __ldg(valid + id);
      if (v == 0.f) continue;
      const float2 mu = __ldg(mean + id);
      const float4 ic = __ldg(icov + id);     // i00, i01, i10, i11
      ndtpu::ndt_add_terms(acc, x, y, dpx, dpy, rx, ry, mu.x, mu.y, ic.x,
                           ic.y, ic.w, v * m, d2, nh, exp_clip);
    }
  }
  const float v = ndtpu::ndt_block_sums(acc, part);
  if (threadIdx.x < kNdtSums) sums[threadIdx.x] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    float o[kOut];
    write_fgh(o, sums, d2);
    float* r = out + (size_t)b * kSlabOut;
    r[0] = o[0];
    r[1] = sums[0];
    r[2] = sums[1];
#pragma unroll
    for (int k = 1; k < 13; ++k) r[2 + k] = o[k];
  }
}

}  // namespace

// `grids` = 4 or 1: the map's overlap grids ([grids, C, ...]).
extern "C" int ndt_sgh_unpacked_launch(const void* poses, const void* pts,
                                       const void* mask, const void* mean,
                                       const void* icov, const void* valid,
                                       void* out, int b, int n, int nx,
                                       int ny, float x0, float y0,
                                       float cell, float d2, float exp_clip,
                                       int grids, void* stream) {
  if (b < 1 || n < 0 || nx < 1 || ny < 1 || (grids != 4 && grids != 1))
    return (int)cudaErrorInvalidValue;
  auto* kernel = grids == 4 ? &ndt_sgh_unpacked_kernel<4>
                            : &ndt_sgh_unpacked_kernel<1>;
  kernel<<<b, kNdtThreads, 0, (cudaStream_t)stream>>>(
      (const float*)poses, (const float2*)pts, (const float*)mask,
      (const float2*)mean, (const float4*)icov, (const float*)valid,
      (float*)out, n, nx, ny, x0, y0, cell, d2, exp_clip);
  return (int)cudaGetLastError();
}

extern "C" int slab_sgh_launch(const void* poses, const void* pts,
                               const void* mask, const void* mean,
                               const void* icov, const void* valid, void* out,
                               int b, int n, int nx, int ny, int x_lo,
                               int nx_local, float x0, float y0, float cell,
                               float d2, float exp_clip, int grids,
                               void* stream) {
  if (b < 1 || n < 0 || nx < 1 || ny < 1 || nx_local < 1 ||
      (grids != 4 && grids != 1))
    return (int)cudaErrorInvalidValue;
  auto* kernel = grids == 4 ? &slab_sgh_kernel<4> : &slab_sgh_kernel<1>;
  kernel<<<b, kNdtThreads, 0, (cudaStream_t)stream>>>(
      (const float*)poses, (const float2*)pts, (const float*)mask,
      (const float2*)mean, (const float4*)icov, (const float*)valid,
      (float*)out, n, nx, ny, x_lo, nx_local, x0, y0, cell, d2, exp_clip);
  return (int)cudaGetLastError();
}
