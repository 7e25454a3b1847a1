// Device code shared by K1 (ndt_terms.cu) and lm_ndt (lm_ndt.cu): one
// lane's 11 NDT sums at one pose, over the lane's beams, reduced over the
// block. K12 (ndt_unpacked.cu) reuses the per-Gaussian body and the block
// reduction on its own gather.
//
// Port of what ndtpu/ndt/match.py::match_batch_packed.make_sgh (:433-450)
// evaluates for one lane: the lane transform, the quad-row gather of
// ndtpu/ndt/grid.py::lookup_quad (:394-413) and the 11 weighted sums of
// ndtpu/ndt/match.py::point_terms_quad (:237-295), in their op order. The
// files that include this are built with --fmad=false and without fast
// math, so each multiply and add rounds on its own as PyTorch's separate
// elementwise kernels round them.
//
// Per beam i (ndt_beam):
//   1. transform the sensor point by the pose (cosf/sinf, no fast math);
//   2. lattice index hx = floor((x - x0) * inv), hy likewise (multiply,
//      no division: the twins' binning; inv = 2/cell on the half-cell
//      lattice of overlap 4, 1/cell on the cell grid of overlap 1);
//   3. load the quad row holding the Gaussians of all kG overlap grids for
//      that lattice slot: kG x kL floats (kG = 4 or 1 grids, kL = 8 full or
//      4 compact lanes per grid; 128, 64, 32 or 16 B);
//   4. for each grid, the Mahalanobis term, exp(-d2/2 * l2) and the 11
//      weighted terms of point_terms_quad (ndt_gauss_terms). A compact slot
//      [mu_x, mu_y, pack(i00, i01), pack(i11, valid)] is unpacked as
//      grid.py::unpack_bf16_pair does, on the lane's bits (__float_as_uint
//      of the loaded word; the low half is a, the high half b): i00 =
//      bits(u << 16), i01 = bits(u & 0xFFFF0000). The loaded word itself
//      never meets float arithmetic (it may be a denormal pattern, C-w13).
// Points that miss the lattice or are masked contribute exactly zero in the
// twin (every sum carries the factor w or w0), so they are skipped.
//
// The sum order (K1's, kept bit for bit by both evaluations below): the
// block's 128 summing threads each fold beams t, t + 128, t + 256, ... from
// 0, in that order, each beam's grids in grid order; then warp shuffles and
// the 4 warps' partials in warp order give (wsum, w0sum, g0, g1, g2, h00,
// h01, h02, h11, h12, h22). One block per lane keeps the reduction inside
// the block: no atomics, deterministic.
//   - ndt_lane_sums (K1): 128 threads, each gathers its beams in series.
//   - ndt_lane_sums_wide (lm_ndt): 128 R threads, one beam each, so all of
//     an evaluation's gathers are in flight at once. Threads 128..128R-1
//     write their beam's 11 x kG terms to shared memory (float4 stores)
//     with a flag for "no contribution"; thread t < 128 takes its own beam
//     into its sum as K1 does, then adds the stored terms of beams t +
//     128, t + 256, ... in order. The terms are stored per grid, not
//     summed over the grids: K1 adds a beam's grids into the running sum
//     one by one, and a sum over the grids first would round differently.
//     Past 128 R beams the block takes them in chunks of 128 R.
//   - K10c slab_sgh and K12 ndt_sgh_unpacked (ndt_unpacked.cu) run the
//     same scheme on a rank's slab or an unpacked map with their own
//     binning and a per-grid flag, through the stored terms' helpers and
//     the reduction below (ndt_store_terms, ndt_add_stored,
//     ndt_wide_block_sums).

#pragma once

#include <cuda_runtime.h>

#include <type_traits>

namespace ndtpu {

constexpr int kNdtThreads = 128;   // threads per lane (block)
constexpr int kNdtSums = 11;

// One Gaussian's 11 terms at a transformed beam: the beam (x, y) in the
// world, its phi-derivative (dpx, dpy) and offset (rx, ry) from the pose's
// translation; the Gaussian's mean, its inverse covariance's unique
// entries and weight w0 (valid x mask). nh = -d2 / 2.
__device__ __forceinline__ void ndt_gauss_terms(
    float* t, float x, float y, float dpx, float dpy, float rx, float ry,
    float mx, float my, float i00, float i01, float i11, float w0, float d2,
    float nh, float exp_clip) {
  const float dx = x - mx;
  const float dy = y - my;
  const float qx = i00 * dx + i01 * dy;
  const float qy = i01 * dx + i11 * dy;
  const float l2 = fmaxf(dx * qx + dy * qy, 0.f);
  const float e = expf(nh * fminf(l2, exp_clip));
  const float w = w0 * e;
  const float a3 = qx * dpx + qy * dpy;
  const float ldx = i00 * dpx + i01 * dpy;
  const float ldy = i01 * dpx + i11 * dpy;
  const float j33 = dpx * ldx + dpy * ldy;
  const float hpp = -(qx * rx + qy * ry);
  t[0] = w;
  t[1] = w0;
  t[2] = w * qx;
  t[3] = w * qy;
  t[4] = w * a3;
  t[5] = w * (i00 - d2 * qx * qx);
  t[6] = w * (i01 - d2 * qx * qy);
  t[7] = w * (ldx - d2 * qx * a3);
  t[8] = w * (i11 - d2 * qy * qy);
  t[9] = w * (ldy - d2 * qy * a3);
  t[10] = w * (j33 + hpp - d2 * a3 * a3);
}

// Each thread's 11 sums reduced over the block (kNdtThreads threads) in a
// fixed order: warp shuffles, then the warps' partials in warp order. part
// is kNdtThreads / 32 x kNdtSums floats of shared memory, free on entry.
// Thread k < kNdtSums gets sum k back, the others 0.
__device__ __forceinline__ float ndt_block_sums(const float* acc,
                                                float (*part)[kNdtSums]) {
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

// The two bf16 halves of a compact lane, as f32 (unpack_bf16_pair).
__device__ __forceinline__ float bf16_low(unsigned u) {
  return __uint_as_float(u << 16);
}
__device__ __forceinline__ float bf16_high(unsigned u) {
  return __uint_as_float(u & 0xFFFF0000u);
}

// float4 per table row of the (kG grids, kL lanes) layout.
template <int kG, int kL>
__host__ __device__ constexpr int row_float4() {
  static_assert((kG == 4 || kG == 1) && (kL == 8 || kL == 4),
                "the quad tables are 4 or 1 grids of 8 or 4 lanes");
  return kG * kL / 4;
}

// f(std::integral_constant<int, kG>, std::integral_constant<int, kL>) for
// the runtime layout (grids, lanes); cudaErrorInvalidValue for one that no
// kernel takes. The launchers instantiate their kernels through it.
template <class F>
inline int with_layout(int grids, int lanes, F&& f) {
  using G4 = std::integral_constant<int, 4>;
  using G1 = std::integral_constant<int, 1>;
  using L8 = std::integral_constant<int, 8>;
  using L4 = std::integral_constant<int, 4>;
  if (grids == 4 && lanes == 8) return f(G4{}, L8{});
  if (grids == 1 && lanes == 8) return f(G1{}, L8{});
  if (grids == 4 && lanes == 4) return f(G4{}, L4{});
  if (grids == 1 && lanes == 4) return f(G1{}, L4{});
  return (int)cudaErrorInvalidValue;
}

// One beam (sensor point (sx, sy), mask m) at the pose (c = cos phi, s =
// sin phi, tx, ty): false if it is masked or misses the lattice, else
// emit(g, t) with the 11 terms t of each grid g in grid order. table is the
// lane's [wh * hh, kG * kL] quad table as row_float4<kG, kL>() float4 per
// row.
template <int kG, int kL, class Emit>
__device__ __forceinline__ bool ndt_beam(
    float c, float s, float tx, float ty, float sx, float sy, float m,
    const float4* __restrict__ table, int wh, int hh, float x0, float y0,
    float inv, float d2, float nh, float exp_clip, Emit&& emit) {
  if (m == 0.f) return false;
  const float x = c * sx - s * sy + tx;
  const float y = s * sx + c * sy + ty;
  const float hx = floorf((x - x0) * inv);
  const float hy = floorf((y - y0) * inv);
  if (!(hx >= 0.f && hx < (float)wh && hy >= 0.f && hy < (float)hh))
    return false;
  const float4* row =
      table + ((size_t)((int)hy * wh + (int)hx)) * row_float4<kG, kL>();
  const float dpx = -s * sx - c * sy;
  const float dpy = c * sx - s * sy;
  const float rx = x - tx;
  const float ry = y - ty;
#pragma unroll
  for (int g = 0; g < kG; ++g) {
    float t[kNdtSums];
    if constexpr (kL == 8) {
      const float4 p = __ldg(row + 2 * g);      // mu_x, mu_y, i00, i01
      const float4 q = __ldg(row + 2 * g + 1);  // i11, valid, 0, 0
      ndt_gauss_terms(t, x, y, dpx, dpy, rx, ry, p.x, p.y, p.z, p.w, q.x,
                      q.y * m, d2, nh, exp_clip);
    } else {
      const float4 p = __ldg(row + g);  // mu_x, mu_y, (i00|i01), (i11|v)
      const unsigned a = __float_as_uint(p.z);
      const unsigned b = __float_as_uint(p.w);
      ndt_gauss_terms(t, x, y, dpx, dpy, rx, ry, p.x, p.y, bf16_low(a),
                      bf16_high(a), bf16_low(b), bf16_high(b) * m, d2, nh,
                      exp_clip);
    }
    emit(g, t);
  }
  return true;
}

// K1's evaluation: the lane's 11 sums at pose (tx, ty, phi). px, py, mask
// hold the lane's n sensor-frame beams (device or shared memory). The block
// is kNdtThreads threads, and every thread must call it. part is
// kNdtThreads / 32 x kNdtSums floats of shared memory, free on entry.
// Thread k < kNdtSums gets sum k back, the others 0.
template <int kG, int kL>
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
  auto add = [&](int, const float* t) {
#pragma unroll
    for (int k = 0; k < kNdtSums; ++k) acc[k] += t[k];
  };
  for (int i = threadIdx.x; i < n; i += kNdtThreads)
    ndt_beam<kG, kL>(c, s, tx, ty, px[i], py[i], mask[i], table, wh, hh, x0,
                     y0, inv, d2, nh, exp_clip, add);
  return ndt_block_sums(acc, part);
}

// ndt_lane_sums_wide's stored terms: a stored beam's grid g holds its 11
// terms at floats 12 g .. 12 g + 10 of the beam's wide_beam_floats (three
// float4 per grid; 52 floats at G = 4, so a warp's float4 stores and loads
// hit distinct banks).
__host__ __device__ constexpr int wide_beam_floats(int grids) {
  return grids == 4 ? 52 : 12;
}

// Shared memory of ndt_lane_sums_wide's stored terms for a block of 128 R
// threads: 128 (R - 1) beams of wide_beam_floats and a flag byte each.
__host__ __device__ constexpr int wide_terms_bytes(int grids, int spread) {
  return (spread - 1) * kNdtThreads * (4 * wide_beam_floats(grids) + 1);
}

// A stored beam's grid g: its 11 terms u into three float4 (the last
// float unused) at floats 12 g .. 12 g + 11 of the beam's terms.
__device__ __forceinline__ void ndt_store_terms(float4* beam, int g,
                                                const float* u) {
  beam[3 * g] = make_float4(u[0], u[1], u[2], u[3]);
  beam[3 * g + 1] = make_float4(u[4], u[5], u[6], u[7]);
  beam[3 * g + 2] = make_float4(u[8], u[9], u[10], 0.f);
}

// acc += a stored beam's grid g, term by term, as a thread adds the
// terms its own beam emits.
__device__ __forceinline__ void ndt_add_stored(float* acc,
                                               const float4* beam, int g) {
  const float4 u0 = beam[3 * g], u1 = beam[3 * g + 1], u2 = beam[3 * g + 2];
  const float u[kNdtSums] = {u0.x, u0.y, u0.z, u0.w, u1.x, u1.y,
                             u1.z, u1.w, u2.x, u2.y, u2.z};
#pragma unroll
  for (int k = 0; k < kNdtSums; ++k) acc[k] += u[k];
}

// The wide evaluations' reduction: the block's first 128 threads' 11 sums
// (acc; the other threads' are not read) over the block in
// ndt_block_sums' order, returned to every thread in out: each of the 4
// warps' shuffle tree, then lane k < 11 of every warp sums the partials of
// sum k in warp order, as ndt_block_sums' thread k does, and hands it to
// its warp. Every thread must call it; part as ndt_block_sums'.
__device__ __forceinline__ void ndt_wide_block_sums(const float* acc,
                                                    float (*part)[kNdtSums],
                                                    float out[kNdtSums]) {
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  if (t < kNdtThreads) {
#pragma unroll
    for (int k = 0; k < kNdtSums; ++k) {
      float v = acc[k];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v += __shfl_down_sync(0xffffffffu, v, off);
      if (lane == 0) part[warp][k] = v;
    }
  }
  __syncthreads();
  float mine = 0.f;
  if (lane < kNdtSums) {
#pragma unroll
    for (int w = 0; w < kNdtThreads / 32; ++w) mine += part[w][lane];
  }
#pragma unroll
  for (int k = 0; k < kNdtSums; ++k)
    out[k] = __shfl_sync(0xffffffffu, mine, k);
}

// lm_ndt's evaluation: ndt_lane_sums' 11 sums, bit for bit, with one beam
// per thread. The block is 128 R threads (R = blockDim.x / 128 <= kMaxR),
// and every thread must call it. terms (16-byte aligned, 128 (R - 1) x
// wide_beam_floats floats) and hit (128 (R - 1) bytes) are shared memory;
// part is kNdtThreads / 32 x kNdtSums floats of shared memory that no
// thread may still read from an earlier call (lm_ndt alternates two).
// Every thread gets all 11 sums in out, each summed over the 4 warps'
// partials in warp order with the additions ndt_block_sums' thread k makes
// (by lane k of each warp, then shuffled to the warp), so no broadcast
// through shared memory follows: one barrier after the stored terms (with
// R > 1) and one after the partials.
template <int kG, int kL, int kMaxR>
__device__ __forceinline__ void ndt_lane_sums_wide(
    float tx, float ty, float phi, const float* px, const float* py,
    const float* mask, int n, const float4* __restrict__ table, int wh,
    int hh, float x0, float y0, float inv, float d2, float exp_clip,
    float4* terms, unsigned char* hit, float (*part)[kNdtSums],
    float out[kNdtSums]) {
  constexpr int kBeam4 = wide_beam_floats(kG) / 4;   // float4 per beam
  const float c = cosf(phi);
  const float s = sinf(phi);
  const float nh = -0.5f * d2;
  const int t = threadIdx.x;
  const int width = kMaxR > 1 ? (int)blockDim.x : kNdtThreads;
  const int held = width - kNdtThreads;   // stored beams per chunk

  float acc[kNdtSums];
#pragma unroll
  for (int k = 0; k < kNdtSums; ++k) acc[k] = 0.f;
  auto add = [&](int, const float* u) {
#pragma unroll
    for (int k = 0; k < kNdtSums; ++k) acc[k] += u[k];
  };
  for (int c0 = 0; c0 < n; c0 += width) {
    const int i = c0 + t;
    if (kMaxR == 1 || t < kNdtThreads) {
      if (i < n)
        ndt_beam<kG, kL>(c, s, tx, ty, px[i], py[i], mask[i], table, wh, hh,
                         x0, y0, inv, d2, nh, exp_clip, add);
    } else {
      float4* mine = terms + (size_t)(t - kNdtThreads) * kBeam4;
      auto store = [&](int g, const float* u) {
        ndt_store_terms(mine, g, u);
      };
      bool on = false;
      if (i < n)
        on = ndt_beam<kG, kL>(c, s, tx, ty, px[i], py[i], mask[i], table, wh,
                              hh, x0, y0, inv, d2, nh, exp_clip, store);
      hit[t - kNdtThreads] = on ? 1 : 0;
    }
    if (kMaxR > 1 && held > 0) {
      __syncthreads();                      // the chunk's terms are stored
      if (t < kNdtThreads) {
        // Beams c0 + t + 128, c0 + t + 256, ...: stored slot j = t, t + 128.
        for (int j = t; j < held && c0 + kNdtThreads + j < n;
             j += kNdtThreads) {
          if (!hit[j]) continue;
          const float4* b = terms + (size_t)j * kBeam4;
#pragma unroll
          for (int g = 0; g < kG; ++g) ndt_add_stored(acc, b, g);
        }
      }
      if (c0 + width < n) __syncthreads();  // before the next chunk's stores
    }
  }
  ndt_wide_block_sums(acc, part, out);
}

}  // namespace ndtpu
