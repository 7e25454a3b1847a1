// Device code shared by K3 (halfcell_add.cu) and K8a (local_tables.cu): the
// half-cell moment scatter of ndtpu/ndt/grid.py::_add_points_halfcell
// (:161-203) in 64-bit fixed point, so that the map statistics do not depend
// on the order of the adds.
//
// Binning: hx = floor((x - x0) * inv), hy likewise, in f32 with the twins'
// op order (the files that include this are built with --fmad=false and
// without fast math), and the in-bounds test 0 <= hx < wh, 0 <= hy < hh.
//
// Accumulation, per point of weight w in half-cell (hx, hy), whose lower
// corner is (xc, yc) = (x0 + hx*h, y0 + hy*h), h = cell/2, all in f64:
//   a = (x - xc) * inv, b = (y - yc) * inv     (half-cell-local, ~[0, 1))
//   q = round(w * {1, a, b, a*a, a*b, b*b} * 2^32)     (int64, nearest even)
// added with integer atomics (L2 in K3, shared memory in K8a). Integer
// addition is associative, so the sums do not depend on thread order,
// launch shape or point order, and a -1 copy of a point cancels its +1
// copy exactly. Each term is rounded once, by at most 2^-33 (h^2 for the
// second moments). Range: |q| <= |w| * 2^32 (|a|, |b| <= 1 up to the f32
// binning's rounding), so the int64 sums hold while the sum of |w| over a
// half-cell stays below 2^30 (the pipeline's weights are +-1).
//
// Reconstruction, per half-cell, in f64 (N = A0 * 2^-32, Au = A1 * 2^-32,
// ...): n = N, sx = h*Au + xc*N, sxx = h^2*Auu + 2*xc*h*Au + xc^2*N,
// sxy = h^2*Auv + xc*h*Av + yc*h*Au + xc*yc*N, in the op order below; the
// 2x2 pooling then sums four half-cells in f64 in K3's order, and the result
// is added to the f32 input statistic in f64 and rounded to f32 once.
// ndtpu_torch/ndt/grid.py::halfcell_add_fixed_ref is the plain model of
// exactly these ops.

#pragma once

#include <cuda_runtime.h>

namespace ndtpu {

constexpr double kFix = 4294967296.0;             // 2^32
constexpr double kUnfix = 2.3283064365386963e-10;  // 2^-32

struct HalfcellGrid {
  double x0, y0;   // lattice origin
  double inv;      // 2 / cell: 1 / h
  double h;        // cell / 2
  float x0f, y0f, invf;   // the same, rounded to f32, for the binning
  int wh, hh;      // lattice width and height in half-cells
};

inline HalfcellGrid make_halfcell_grid(double x0, double y0, double inv,
                                       double h, int wh, int hh) {
  return HalfcellGrid{x0, y0, inv, h, (float)x0, (float)y0, (float)inv, wh,
                      hh};
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
