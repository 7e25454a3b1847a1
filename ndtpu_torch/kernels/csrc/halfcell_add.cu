// K3: half-cell moment scatter + 2x2 pooling into the 4 overlap grids.
//
// Replaces what XLA lowered for the TPU from
// ndtpu/ndt/grid.py::_add_points_halfcell (:161-203): one segment_sum of six
// moments onto the (2ny+1) x (2nx+1) half-cell lattice, then a dense 2x2
// sum-pool per shifted grid, added to the running statistics.
//
// Launch 1 (scatter): one thread per point. fx = floor((x - x0) * inv) and
// fy likewise, in the twin's op order (multiply, no division; the file is
// built with --fmad=false), then atomicAdd of w, w*x, w*y, w*x*x, w*x*y,
// w*y*y into a zeroed lattice. Points with zero weight (masked, outside the
// lattice, or weight 0) add nothing in the twin and are skipped.
// Launch 2 (pool): one thread per (grid, cell) sums its 2x2 lattice block
// and writes stats + pooled into NEW output tensors (the input statistics
// stay valid: the pipeline registers against a temporary map built on top
// of the window's committed one).
//
// What bounds it on Hopper: the scatter is atomic-rate bound (six float
// atomics per point into a ~1 MB lattice that lives in L2); the pool is a
// streaming pass over ~1 MB in and ~1.3 MB out. Float atomics make the order
// of the adds, and so the last bits of the moments, vary from run to run
// (ROADMAP C-w1); unit-weight counts stay exact.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
halfcell_scatter_kernel(const float2* __restrict__ pts,
                        const uint8_t* __restrict__ mask,
                        const float* __restrict__ weight, float wscalar,
                        float* __restrict__ lattice, int m, int wh, int hh,
                        float x0, float y0, float inv) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= m || !mask[i]) return;
  const float2 p = pts[i];
  const float fx = floorf((p.x - x0) * inv);
  const float fy = floorf((p.y - y0) * inv);
  if (!(fx >= 0.f && fx < (float)wh && fy >= 0.f && fy < (float)hh)) return;
  const float w = weight != nullptr ? weight[i] : wscalar;
  if (w == 0.f) return;
  float* cell = lattice + ((size_t)((int)fy * wh + (int)fx)) * 6;
  const float wx = w * p.x;
  const float wy = w * p.y;
  atomicAdd(cell + 0, w);
  atomicAdd(cell + 1, wx);
  atomicAdd(cell + 2, wy);
  atomicAdd(cell + 3, wx * p.x);
  atomicAdd(cell + 4, wx * p.y);
  atomicAdd(cell + 5, wy * p.y);
}

__global__ void __launch_bounds__(kThreads)
halfcell_pool_kernel(const float* __restrict__ lattice,
                     const float* __restrict__ n_in,
                     const float* __restrict__ s_in,
                     const float* __restrict__ ss_in, float* __restrict__ n_out,
                     float* __restrict__ s_out, float* __restrict__ ss_out,
                     int nx, int ny, int wh) {
  const int c_total = nx * ny;
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= 4 * c_total) return;
  const int g = t / c_total;
  const int c = t - g * c_total;
  const int j = c / nx;
  const int i = c - j * nx;
  const int gx = g & 1, gy = g >> 1;   // shifts (0,0), (1,0), (0,1), (1,1)
  const float* r0 = lattice + ((size_t)(gy + 2 * j) * wh + gx + 2 * i) * 6;
  const float* r1 = r0 + (size_t)wh * 6;
  float p[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) p[k] = ((r0[k] + r0[6 + k]) + r1[k]) + r1[6 + k];
  n_out[t] = n_in[t] + p[0];
  s_out[2 * t + 0] = s_in[2 * t + 0] + p[1];
  s_out[2 * t + 1] = s_in[2 * t + 1] + p[2];
  ss_out[4 * t + 0] = ss_in[4 * t + 0] + p[3];
  ss_out[4 * t + 1] = ss_in[4 * t + 1] + p[4];
  ss_out[4 * t + 2] = ss_in[4 * t + 2] + p[4];
  ss_out[4 * t + 3] = ss_in[4 * t + 3] + p[5];
}

}  // namespace

extern "C" int halfcell_scatter_launch(const void* pts, const void* mask,
                                       const void* weight, float wscalar,
                                       void* lattice, int m, int wh, int hh,
                                       float x0, float y0, float inv,
                                       void* stream) {
  const int blocks = (m + kThreads - 1) / kThreads;
  halfcell_scatter_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float2*)pts, (const uint8_t*)mask, (const float*)weight, wscalar,
      (float*)lattice, m, wh, hh, x0, y0, inv);
  return (int)cudaGetLastError();
}

extern "C" int halfcell_pool_launch(const void* lattice, const void* n_in,
                                    const void* s_in, const void* ss_in,
                                    void* n_out, void* s_out, void* ss_out,
                                    int nx, int ny, int wh, void* stream) {
  const int total = 4 * nx * ny;
  const int blocks = (total + kThreads - 1) / kThreads;
  halfcell_pool_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)lattice, (const float*)n_in, (const float*)s_in,
      (const float*)ss_in, (float*)n_out, (float*)s_out, (float*)ss_out, nx,
      ny, wh);
  return (int)cudaGetLastError();
}
