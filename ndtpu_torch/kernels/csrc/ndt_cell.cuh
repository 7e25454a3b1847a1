// Device code shared by K4 (finalize_pack.cu) and K8a (local_tables.cu):
// finalize one NDT cell from its sums and write its 8 quad-row floats.
//
// Port of ndtpu/ndt/grid.py::finalize (:232-254, with _eig2x2_sym
// :211-229) for one cell, followed by its slot of pack_quad (:336-391,
// compact=False). The op order and the 1e-20 / 1e-30 guards of
// _eig2x2_sym are kept as written; the file that includes this is built
// with --fmad=false and without fast math.

#pragma once

#include <cuda_runtime.h>

namespace ndtpu {

// Cell (within its grid) of quad-table slot t = 4 * row + g of a
// (2nx+1) x (2ny+1) half-cell lattice, or -1 where the slot lies outside
// grid g (pack_quad's zero pad). Grid g is shifted by (g & 1, g >> 1).
__device__ __forceinline__ int quad_slot_cell(int t, int nx, int ny) {
  const int wh = 2 * nx + 1;
  const int r = t >> 2;
  const int g = t & 3;
  const int hy = r / wh;
  const int hx = r - hy * wh;
  const int uy = hy - (g >> 1);   // row of grid g's x2-upsampled block
  const int ux = hx - (g & 1);
  if (uy < 0 || uy >= 2 * ny || ux < 0 || ux >= 2 * nx) return -1;
  return (uy >> 1) * nx + (ux >> 1);
}

__device__ __forceinline__ void store_zero_slot(float4* out) {
  out[0] = make_float4(0.f, 0.f, 0.f, 0.f);
  out[1] = make_float4(0.f, 0.f, 0.f, 0.f);
}

// n, (sx, sy), (sxx, sxy, syy): the cell's count, first and second moment
// sums. Writes [mu_x, mu_y, i00, i01, i11, valid, 0, 0] to out[0..1].
__device__ __forceinline__ void finalize_pack_cell(
    float n, float sx, float sy, float sxx, float sxy, float syy,
    float min_pts, float eig_ratio, float eig_abs_min, float4* out) {
  const float safe_n = fmaxf(n, 1.f);
  const float mx = sx / safe_n;
  const float my = sy / safe_n;
  const float a = sxx / safe_n - mx * mx;
  const float b = sxy / safe_n - mx * my;
  const float c = syy / safe_n - my * my;
  // _eig2x2_sym
  const float half_tr = 0.5f * (a + c);
  const float amc = a - c;
  const float d = sqrtf(fmaxf(0.25f * (amc * amc) + b * b, 0.f));
  const float l1 = half_tr + d;
  const float l2 = half_tr - d;
  const bool b_small = fabsf(b) <= 1e-20f;
  const float vx = b_small ? (a >= c ? 1.f : 0.f) : b;
  const float vy = b_small ? (a >= c ? 0.f : 1.f) : l1 - a;
  float nrm = sqrtf(vx * vx + vy * vy);
  nrm = nrm <= 1e-30f ? 1.f : nrm;
  const float v1x = vx / nrm, v1y = vy / nrm;
  // finalize
  const float lmax = fmaxf(l1, eig_abs_min);
  const float lmin = fmaxf(l2, fmaxf(eig_ratio * lmax, eig_abs_min));
  const float v2x = -v1y, v2y = v1x;
  const float i00 = v1x * v1x / lmax + v2x * v2x / lmin;
  const float i01 = v1x * v1y / lmax + v2x * v2y / lmin;
  const float i11 = v1y * v1y / lmax + v2y * v2y / lmin;
  const float valid = n >= min_pts ? 1.f : 0.f;
  out[0] = make_float4(mx, my, i00, i01);
  out[1] = make_float4(i11, valid, 0.f, 0.f);
}

}  // namespace ndtpu
