// Device code shared by K4 (finalize_pack.cu), K8a (local_tables.cu) and
// K10b (finalize_cells.cu): finalize one NDT cell from its sums and write
// its quad-row lanes.
//
// Port of ndtpu/ndt/grid.py::finalize (:232-254, with _eig2x2_sym
// :211-229) for one cell, followed by its slot of pack_quad (:336-391).
// A slot is kL lanes of one overlap grid:
//   kL = 8 (full rows):    [mu_x, mu_y, i00, i01, i11, valid, 0, 0]
//   kL = 4 (compact rows): [mu_x, mu_y, pack(i00, i01), pack(i11, valid)]
// where pack(a, b) is grid.py::_pack_bf16_pair (:317-323): a and b rounded
// to bf16 (round to nearest even, as astype(bfloat16)), a in the low half
// of the 32-bit lane, b in the high half. Such a lane is a bit pattern,
// not a number: with b = 0 (an invalid cell, or i01 = 0) it reads as an
// f32 denormal, so it is composed as a uint32 and moved only by loads and
// stores, never through float arithmetic (which may flush it).
// The op order and the 1e-20 / 1e-30 guards of _eig2x2_sym are kept as
// written; the file that includes this is built with --fmad=false and
// without fast math.

#pragma once

#include <cuda_bf16.h>
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

// A slot outside its grid (pack_quad's zero pad): kL / 4 zero float4.
template <int kL = 8>
__device__ __forceinline__ void store_zero_slot(float4* out) {
#pragma unroll
  for (int k = 0; k < kL / 4; ++k) out[k] = make_float4(0.f, 0.f, 0.f, 0.f);
}

// _pack_bf16_pair(a, b): bf16(a) in the low 16 bits, bf16(b) in the high
// 16 bits of one lane, composed as a uint32 (C-w2).
__device__ __forceinline__ float pack_bf16_pair(float a, float b) {
  const unsigned lo = __bfloat16_as_ushort(__float2bfloat16_rn(a));
  const unsigned hi = __bfloat16_as_ushort(__float2bfloat16_rn(b));
  return __uint_as_float((hi << 16) | lo);
}

// n, (sx, sy), (sxx, sxy, syy): the cell's count, first and second moment
// sums. Writes the cell's kL-lane slot to out[0 .. kL / 4).
template <int kL = 8>
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
  if constexpr (kL == 8) {
    out[0] = make_float4(mx, my, i00, i01);
    out[1] = make_float4(i11, valid, 0.f, 0.f);
  } else {
    static_assert(kL == 4, "a slot is 8 (full) or 4 (compact) lanes");
    out[0] = make_float4(mx, my, pack_bf16_pair(i00, i01),
                         pack_bf16_pair(i11, valid));
  }
}

}  // namespace ndtpu
