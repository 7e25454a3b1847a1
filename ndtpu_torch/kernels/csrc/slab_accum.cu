// K10a slab_accumulate: the moment sums of masked points in the cells of
// an x-slab of every overlap grid (4, or 1 at overlap 1), in 64-bit fixed
// point relative to each
// cell (halfcell_fixed.cuh's arithmetic on full cells), so the slab map is
// the same on every run and under any order of the points.
//
// Replaces what XLA lowered for the TPU from ndtpu/dist/gridmap.py::
// _accum_local (:66: three segment_sums of n, w*p and w*p p^T into a local
// slab [G, nx_local, ny], ix-major) together with the per-point work of its
// callers build_slab_stats (:96-104: _cell_xy and the ownership mask) and
// build_slab_stats_psharded (:130-140: the halo-extended index, clipped,
// and its in-slab mask).
//
// The slab is grid columns [x_lo, x_lo + width) of every grid (x_lo may be
// negative and x_lo + width past nx: the halo-extended slabs of the first
// and last rank); its local flat cell id is (g * width + ix - x_lo) * ny +
// iy. One C call (slab_accum_launch) enqueues on the caller's stream:
//   1. cudaMemsetAsync of the int64 [G, width, ny, 6] scratch, which the
//      wrapper allocates once per (device, G, width, ny) and keeps;
//   2. the scatter, one thread per (grid, point) (grid = blockIdx.y < G;
//      grid g's shift is (g & 1, g >> 1) half cells, so at G = 1 the one
//      grid is grid 0, unshifted, as ndtpu/ndt/grid.py::_grid_offsets
//      :78-86 has it): the
//      cell as ndtpu/ndt/grid.py::cell_ids computes it in f32
//      (halfcell_fixed.cuh's cell_bin: floor(((x - x0) - off) / cell), the
//      in-bounds test on the unclamped index, then the clamp; K3 at
//      overlap 1 bins the same way), the weight mask & inb & (x_lo <= ix <
//      x_lo + width), and for a point of weight 1 the six terms
//      round({1, a, b, a*a, a*b, b*b} * 2^32), (a, b) its offset from the
//      cell's lower corner over the cell size in f64, added with 64-bit
//      integer atomics (in L2);
//   3. the moments, one thread per slab cell: halfcell_moments with the
//      cell size for h, i.e. n, s and ss about the origin in f64, each
//      rounded to f32 once, into the output n [G, width, ny], s [.., 2],
//      ss [.., 2, 2] (sxy written twice).
// Integer addition is associative: the sums do not depend on thread order.
//
// What bounds it on Hopper: bytes. The points are read once per grid (from
// L2 after the first), the scratch is zeroed and read once (48 B per cell)
// and the f32 slab written once (28 B per cell); at config 5's slab (4 x
// 216 x 256 cells with a 44-column halo, ~10^5 points) the scratch traffic
// is ~2x the output's, and the atomics (six per live (grid, point)) land on
// distinct cells mostly.

#include <cuda_runtime.h>
#include <stdint.h>

#include "halfcell_fixed.cuh"

namespace {

constexpr int kThreads = 256;

struct SlabArgs {
  float x0f, y0f, cellf, hf;   // grid origin, cell, half cell (f32 binning)
  double x0, y0, cell, inv;    // the same in f64 (fixed point), inv = 1/cell
  int nx, ny, x_lo, width;
};

// Grid g's fixed-point frame (halfcell_fixed.cuh's cell_frame).
__device__ __forceinline__ ndtpu::HalfcellGrid grid_frame(const SlabArgs& a,
                                                          int g) {
  return ndtpu::cell_frame(a.x0, a.y0, a.cell, a.inv, g, a.nx, a.ny);
}

__global__ void __launch_bounds__(kThreads)
slab_scatter_kernel(const float2* __restrict__ pts,
                    const uint8_t* __restrict__ mask,
                    unsigned long long* __restrict__ acc, int m,
                    SlabArgs a) {
  const int g = blockIdx.y;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= m || !mask[i]) return;
  const float2 p = pts[i];
  int ix, iy;
  if (!ndtpu::cell_bin(p.x, p.y, a.x0f, a.y0f, (g & 1) ? a.hf : 0.f,
                       (g & 2) ? a.hf : 0.f, a.cellf, a.nx, a.ny, &ix, &iy))
    return;
  const int lx = ix - a.x_lo;
  if (lx < 0 || lx >= a.width) return;
  long long q[6];
  ndtpu::halfcell_quantize(p.x, p.y, 1.f, ix, iy, grid_frame(a, g), q);
  unsigned long long* dst =
      acc + (((size_t)g * a.width + lx) * a.ny + iy) * 6;
#pragma unroll
  for (int k = 0; k < 6; ++k) atomicAdd(dst + k, (unsigned long long)q[k]);
}

__global__ void __launch_bounds__(kThreads)
slab_moments_kernel(const long long* __restrict__ acc,
                    float* __restrict__ n_out, float2* __restrict__ s_out,
                    float4* __restrict__ ss_out, int cells, SlabArgs a) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= cells) return;
  const int iy = t % a.ny;
  const int lx = (t / a.ny) % a.width;
  const int g = t / (a.ny * a.width);
  const longlong2* src = reinterpret_cast<const longlong2*>(acc + 6 * (size_t)t);
  const longlong2 a01 = src[0], a23 = src[1], a45 = src[2];
  const long long q[6] = {a01.x, a01.y, a23.x, a23.y, a45.x, a45.y};
  double m[6];
  ndtpu::halfcell_moments(q, a.x_lo + lx, iy, grid_frame(a, g), m);
  n_out[t] = __double2float_rn(m[0]);
  s_out[t] = make_float2(__double2float_rn(m[1]), __double2float_rn(m[2]));
  const float sxy = __double2float_rn(m[4]);
  ss_out[t] = make_float4(__double2float_rn(m[3]), sxy, sxy,
                          __double2float_rn(m[5]));
}

}  // namespace

// points [m, 2] f32, mask [m] bool; `grids` = 4 or 1 overlap grids; acc
// the int64 [grids, width, ny, 6] scratch; n_out [grids, width, ny], s_out
// [.., 2], ss_out [.., 2, 2] f32.
extern "C" int slab_accum_launch(const void* pts, const void* mask, void* acc,
                                 void* n_out, void* s_out, void* ss_out,
                                 int m, int nx, int ny, int x_lo, int width,
                                 double x0, double y0, double cell,
                                 int grids, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (m < 0 || nx < 1 || ny < 1 || width < 1 || (grids != 4 && grids != 1))
    return (int)cudaErrorInvalidValue;
  const SlabArgs a{(float)x0, (float)y0, (float)cell, (float)(cell / 2.0),
                   x0, y0, cell, 1.0 / cell, nx, ny, x_lo, width};
  const int cells = grids * width * ny;
  cudaError_t err =
      cudaMemsetAsync(acc, 0, (size_t)cells * 6 * sizeof(long long), st);
  if (err != cudaSuccess) return (int)err;
  if (m > 0) {
    const dim3 blocks((m + kThreads - 1) / kThreads, grids);
    slab_scatter_kernel<<<blocks, kThreads, 0, st>>>(
        (const float2*)pts, (const uint8_t*)mask, (unsigned long long*)acc, m,
        a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  slab_moments_kernel<<<(cells + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      (const long long*)acc, (float*)n_out, (float2*)s_out, (float4*)ss_out,
      cells, a);
  return (int)cudaGetLastError();
}
