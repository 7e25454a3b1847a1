// Device code shared by K3 (halfcell_add.cu), K8a (local_tables.cu) and
// K10a (slab_accum.cu): the moment scatter of
// ndtpu/ndt/grid.py::_add_points_halfcell (:161-203) and of add_points at
// overlap 1 (:120-160) in 64-bit fixed point, so that the map statistics do
// not depend on the order of the adds.
//
// Binning, in f32 with the twins' op order (the files that include this are
// built with --fmad=false and without fast math):
//   half cells (overlap 4): hx = floor((x - x0) * inv), inv = 2/cell, the
//     in-bounds test 0 <= hx < wh on the (2nx+1) x (2ny+1) lattice
//     (halfcell_bin);
//   cells (overlap 1, and each shifted grid of K10a's slab): ix =
//     floor(((x - x0) - ox) / cell), a division as grid.py::cell_ids
//     (:89-108) computes it, the in-bounds test on the unclamped index
//     (cell_bin). The two formulas agree at the published cells (0.5 and
//     1.0 m) but not in general; each side keeps its own.
//
// Accumulation, per point of weight w in bin (hx, hy) of a frame of bin
// size h (h = cell/2 for half cells, h = cell for cells), whose lower
// corner is (xc, yc) = (x0 + hx*h, y0 + hy*h), all in f64:
//   a = (x - xc) * inv, b = (y - yc) * inv     (bin-local, ~[0, 1)), inv = 1/h
//   q = round(w * {1, a, b, a*a, a*b, b*b} * 2^32)     (int64, nearest even)
// added with integer atomics (L2 in K3 and K10a, shared memory in K8a).
// Integer addition is associative, so the sums do not depend on thread
// order, launch shape or point order, and a -1 copy of a point cancels its
// +1 copy exactly. Each term is rounded once, by at most 2^-33 (h^2 for
// the second moments). Range: |q| <= |w| * 2^32 (|a|, |b| <= 1 up to the
// f32 binning's rounding), so the int64 sums hold while the sum of |w| over
// a bin stays below 2^30 (the pipeline's weights are +-1).
//
// Reconstruction, per bin, in f64 (N = A0 * 2^-32, Au = A1 * 2^-32, ...):
// n = N, sx = h*Au + xc*N, sxx = h^2*Auu + 2*xc*h*Au + xc^2*N, sxy =
// h^2*Auv + xc*h*Av + yc*h*Au + xc*yc*N, in the op order below; at overlap
// 4 the 2x2 pooling then sums four half-cells in f64 in K3's order (at
// overlap 1 a cell is its own bin), and the result is added to the f32
// input statistic in f64 and rounded to f32 once.
// ndtpu_torch/ndt/grid.py::halfcell_add_fixed_ref is the plain model of
// exactly these ops, at both overlaps.

#pragma once

#include <cuda_runtime.h>

namespace ndtpu {

constexpr double kFix = 4294967296.0;             // 2^32
constexpr double kUnfix = 2.3283064365386963e-10;  // 2^-32

// A fixed-point frame: bins of size h from (x0, y0), wh x hh of them.
struct HalfcellGrid {
  double x0, y0;   // lattice origin
  double inv;      // 1 / h (2 / cell for half cells, 1 / cell for cells)
  double h;        // the bin size: cell / 2, or cell
  float x0f, y0f, invf, hf;   // the same, rounded to f32, for the binning
  int wh, hh;      // lattice width and height in bins
};

inline HalfcellGrid make_halfcell_grid(double x0, double y0, double inv,
                                       double h, int wh, int hh) {
  return HalfcellGrid{x0, y0, inv, h, (float)x0, (float)y0, (float)inv,
                      (float)h, wh, hh};
}

// The frame of overlap grid g on full cells of size `cell` (h = cell, inv =
// 1 / cell): the origin shifted by (g & 1, g >> 1) half cells; nx x ny
// cells. Overlap 1 is grid 0.
__host__ __device__ inline HalfcellGrid cell_frame(double x0, double y0,
                                                   double cell, double inv,
                                                   int g, int nx, int ny) {
  const double x = x0 + ((g & 1) ? 0.5 * cell : 0.0);
  const double y = y0 + ((g & 2) ? 0.5 * cell : 0.0);
  return HalfcellGrid{x, y, inv, cell, (float)x, (float)y, (float)inv,
                      (float)cell, nx, ny};
}

// grid.py::cell_ids in f32: the cell of (x, y) in the grid shifted by (ox,
// oy), from the unshifted origin (x0f, y0f); false where the unclamped
// index is outside the nx x ny grid.
__device__ __forceinline__ bool cell_bin(float x, float y, float x0f,
                                         float y0f, float ox, float oy,
                                         float cellf, int nx, int ny, int* ix,
                                         int* iy) {
  const float fx = floorf(((x - x0f) - ox) / cellf);
  const float fy = floorf(((y - y0f) - oy) / cellf);
  if (!(fx >= 0.f && fx < (float)nx && fy >= 0.f && fy < (float)ny))
    return false;
  *ix = (int)fx;
  *iy = (int)fy;
  return true;
}

__device__ __forceinline__ bool halfcell_bin(float x, float y,
                                             const HalfcellGrid& g, int* hx,
                                             int* hy) {
  const float fx = floorf((x - g.x0f) * g.invf);
  const float fy = floorf((y - g.y0f) * g.invf);
  if (!(fx >= 0.f && fx < (float)g.wh && fy >= 0.f && fy < (float)g.hh))
    return false;
  *hx = (int)fx;
  *hy = (int)fy;
  return true;
}

// The six fixed-point terms of a point of weight w in half-cell (hx, hy).
__device__ __forceinline__ void halfcell_quantize(float x, float y, float w,
                                                  int hx, int hy,
                                                  const HalfcellGrid& g,
                                                  long long q[6]) {
  const double xc = g.x0 + (double)hx * g.h;
  const double yc = g.y0 + (double)hy * g.h;
  const double a = ((double)x - xc) * g.inv;
  const double b = ((double)y - yc) * g.inv;
  const double wd = (double)w;
  q[0] = __double2ll_rn(wd * kFix);
  q[1] = __double2ll_rn((wd * a) * kFix);
  q[2] = __double2ll_rn((wd * b) * kFix);
  q[3] = __double2ll_rn((wd * (a * a)) * kFix);
  q[4] = __double2ll_rn((wd * (a * b)) * kFix);
  q[5] = __double2ll_rn((wd * (b * b)) * kFix);
}

// Half-cell (hx, hy)'s moment sums (n, sx, sy, sxx, sxy, syy) in f64 from
// its six fixed-point sums.
__device__ __forceinline__ void halfcell_moments(const long long A[6], int hx,
                                                 int hy,
                                                 const HalfcellGrid& g,
                                                 double m[6]) {
  const double xc = g.x0 + (double)hx * g.h;
  const double yc = g.y0 + (double)hy * g.h;
  const double n = (double)A[0] * kUnfix;
  const double au = (double)A[1] * kUnfix;
  const double av = (double)A[2] * kUnfix;
  const double auu = (double)A[3] * kUnfix;
  const double auv = (double)A[4] * kUnfix;
  const double avv = (double)A[5] * kUnfix;
  const double h = g.h;
  const double h2 = h * h;
  m[0] = n;
  m[1] = h * au + xc * n;
  m[2] = h * av + yc * n;
  m[3] = (h2 * auu + ((2.0 * xc) * h) * au) + (xc * xc) * n;
  m[4] = ((h2 * auv + (xc * h) * av) + (yc * h) * au) + (xc * yc) * n;
  m[5] = (h2 * avv + ((2.0 * yc) * h) * av) + (yc * yc) * n;
}

// K3's 2x2 pooling order: ((top-left + top-right) + bottom-left) +
// bottom-right.
__device__ __forceinline__ double halfcell_pool4(double a, double b, double c,
                                                 double d) {
  return ((a + b) + c) + d;
}

// An f32 statistic plus a pooled f64 moment, rounded to f32 once.
__device__ __forceinline__ float halfcell_out(float in, double p) {
  return __double2float_rn((double)in + p);
}

}  // namespace ndtpu
