// The pose graph's per-factor arithmetic, shared by K5 (factor_linearize.cu),
// K6 (pcg_solve.cu) and K7b (local_system.cu), the block reductions and
// scans they use, and the one-block kernels' shared-memory opt-in.
//
// Every op is written in the order the plain versions write it
// (ndtpu_torch/lie/se2.py::wrap, ndtpu_torch/graph/factors.py:
// between_error, _between_jacobians, robust_weight, prior_error;
// ndtpu_torch/graph/solve.py::_inv3), and the sources are built with
// --fmad=false, so each multiply and add rounds on its own as PyTorch's
// elementwise kernels round them. Sums over factors and poses run in a
// fixed order (see each kernel), so a result is the same on every launch.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace ndtpu {
namespace pg {

// pi and 2 pi as f32, as PyTorch casts the Python scalars of se2.wrap.
constexpr float kPi = 3.14159265358979323846f;
constexpr float kTwoPi = 6.28318530717958647692f;

// se2.wrap: theta - 2 pi floor((theta + pi) / 2 pi), not atan2.
__device__ __forceinline__ float wrap(float t) {
  return t - kTwoPi * floorf((t + kPi) / kTwoPi);
}

// max that keeps a NaN (torch.max propagates it; fmaxf drops it).
__device__ __forceinline__ float nanmax(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// Between error e = [R_i^T (t_j - t_i) - t_z ; wrap(th_j - th_i - th_z)]
// and its Jacobians (row-major 3 x 3) with respect to pose i and pose j.
__device__ __forceinline__ void between(const float* pi, const float* pj,
                                        const float* z, float e[3],
                                        float ji[9], float jj[9]) {
  const float c = cosf(pi[2]), s = sinf(pi[2]);
  const float dx = pj[0] - pi[0];
  const float dy = pj[1] - pi[1];
  e[0] = c * dx + s * dy - z[0];
  e[1] = -s * dx + c * dy - z[1];
  e[2] = wrap(pj[2] - pi[2] - z[2]);
  const float dth_x = -s * dx + c * dy;
  const float dth_y = -c * dx - s * dy;
  ji[0] = -c;  ji[1] = -s;  ji[2] = dth_x;
  ji[3] = s;   ji[4] = -c;  ji[5] = dth_y;
  ji[6] = 0.f; ji[7] = 0.f; ji[8] = -1.f;
  jj[0] = c;   jj[1] = s;   jj[2] = 0.f;
  jj[3] = -s;  jj[4] = c;   jj[5] = 0.f;
  jj[6] = 0.f; jj[7] = 0.f; jj[8] = 1.f;
}

// Prior error [p_xy - z_xy ; wrap(p_th - z_th)].
__device__ __forceinline__ void prior_error(const float* p, const float* z,
                                            float e[3]) {
  e[0] = p[0] - z[0];
  e[1] = p[1] - z[1];
  e[2] = wrap(p[2] - z[2]);
}

// out = S @ J (3 x 3 row-major), k summed in order 0, 1, 2.
__device__ __forceinline__ void mat3(const float* s, const float* j,
                                     float out[9]) {
#pragma unroll
  for (int p = 0; p < 3; ++p)
#pragma unroll
    for (int q = 0; q < 3; ++q)
      out[3 * p + q] = s[3 * p] * j[q] + s[3 * p + 1] * j[3 + q]
                       + s[3 * p + 2] * j[6 + q];
}

// out = S @ v.
__device__ __forceinline__ void mv3(const float* s, const float* v,
                                    float out[3]) {
#pragma unroll
  for (int p = 0; p < 3; ++p)
    out[p] = s[3 * p] * v[0] + s[3 * p + 1] * v[1] + s[3 * p + 2] * v[2];
}

// out = A^T v (solve.py::_btv): out[q] = sum_k A[k][q] v[k].
__device__ __forceinline__ void mtv3(const float* a, const float* v,
                                     float out[3]) {
#pragma unroll
  for (int q = 0; q < 3; ++q)
    out[q] = a[q] * v[0] + a[3 + q] * v[1] + a[6 + q] * v[2];
}

// out = A^T B (solve.py::_btb): out[p][q] = sum_k A[k][p] B[k][q].
__device__ __forceinline__ void mtm3(const float* a, const float* b,
                                     float out[9]) {
#pragma unroll
  for (int p = 0; p < 3; ++p)
#pragma unroll
    for (int q = 0; q < 3; ++q)
      out[3 * p + q] = a[p] * b[q] + a[3 + p] * b[3 + q] + a[6 + p] * b[6 + q];
}

// The robust kernels' codes (kernels.robust_code maps the names).
constexpr int kHuber = 0, kCauchy = 1, kTukey = 2, kGeman = 3;

// IRLS sqrt-weight of a whitened residual's norm (factors.py
// robust_weight): n = max(|r|, 1e-12); huber 1 or sqrt(delta / n), cauchy
// 1 / sqrt(1 + (n / delta)^2), tukey 1 - min(n / delta, 1)^2, geman
// delta / (delta + n^2).
__device__ __forceinline__ float robust_weight(const float r[3], float delta,
                                               int kind) {
  const float n = fmaxf(sqrtf(r[0] * r[0] + r[1] * r[1] + r[2] * r[2]),
                        1e-12f);
  if (kind == kCauchy) {
    const float u = n / delta;
    return 1.f / sqrtf(1.f + u * u);
  }
  if (kind == kTukey) {
    const float u = fminf(n / delta, 1.f);
    return 1.f - u * u;
  }
  if (kind == kGeman) return delta / (delta + n * n);
  return n <= delta ? 1.f : sqrtf(delta / n);
}

// A whitened, robustly weighted (delta > 0), masked between factor: Ai, Aj,
// r as factors.py::linearize writes them (weight and mask as two
// multiplies). Also the unweighted whitened residual's largest |entry|
// (for the fresh window's max), before the mask.
__device__ __forceinline__ void linearize_between(
    const float* pi, const float* pj, const float* z, const float* sqi,
    float delta, int kind, float m, float ai[9], float aj[9], float r[3],
    float* raw_max) {
  float e[3], ji[9], jj[9];
  between(pi, pj, z, e, ji, jj);
  mat3(sqi, ji, ai);
  mat3(sqi, jj, aj);
  mv3(sqi, e, r);
  *raw_max = nanmax(nanmax(fabsf(r[0]), fabsf(r[1])), fabsf(r[2]));
  if (delta > 0.f) {
    const float w = robust_weight(r, delta, kind);
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      ai[k] = ai[k] * w;
      aj[k] = aj[k] * w;
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) r[k] = r[k] * w;
  }
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    ai[k] = ai[k] * m;
    aj[k] = aj[k] * m;
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) r[k] = r[k] * m;
}

// solve.py::_inv3: adjugate / determinant, |det| < 1e-30 -> 1e-30.
__device__ __forceinline__ void inv3(const float* a, float out[9]) {
  const float c00 = a[4] * a[8] - a[5] * a[7];
  const float c01 = a[5] * a[6] - a[3] * a[8];
  const float c02 = a[3] * a[7] - a[4] * a[6];
  const float c10 = a[2] * a[7] - a[1] * a[8];
  const float c11 = a[0] * a[8] - a[2] * a[6];
  const float c12 = a[1] * a[6] - a[0] * a[7];
  const float c20 = a[1] * a[5] - a[2] * a[4];
  const float c21 = a[2] * a[3] - a[0] * a[5];
  const float c22 = a[0] * a[4] - a[1] * a[3];
  float det = a[0] * c00 + a[1] * c01 + a[2] * c02;
  if (fabsf(det) < 1e-30f) det = 1e-30f;
  out[0] = c00 / det; out[1] = c10 / det; out[2] = c20 / det;
  out[3] = c01 / det; out[4] = c11 / det; out[5] = c21 / det;
  out[6] = c02 / det; out[7] = c12 / det; out[8] = c22 / det;
}

// ---- Block-wide collectives (blockDim.x a multiple of 32, <= 1024). ----
// Each combines the threads' values in one fixed order (a shuffle tree
// within each warp, then the warps' results in warp order: block_tree_w0
// and block_tree2_w0, the one tree they all use), so the result is the
// same on every launch. `red` is shared scratch of >= 66 floats.

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_nanmax(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = nanmax(v, __shfl_down_sync(0xffffffffu, v, o));
  return v;
}

// warp_sum, or with kMax warp_nanmax.
template <bool kMax>
__device__ __forceinline__ float warp_reduce(float v) {
  return kMax ? warp_nanmax(v) : warp_sum(v);
}

// The block's sum (with kMax its NaN-keeping max) of v: each warp's tree,
// then warp 0's tree of the warps' results. The result is in warp 0 only,
// after one barrier; the other warps return while warp 0 may still read
// red, so no thread writes red again before the next barrier.
template <bool kMax>
__device__ __forceinline__ float block_tree_w0(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  v = warp_reduce<kMax>(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float w = 0.f;
  if (warp == 0) w = warp_reduce<kMax>(lane < warps ? red[lane] : 0.f);
  return w;
}

// Two such reductions at once (*a by kMaxA, *b by kMaxB), each in
// block_tree_w0's order; results in warp 0 only, after one barrier.
template <bool kMaxA, bool kMaxB>
__device__ __forceinline__ void block_tree2_w0(float* a, float* b,
                                               float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const float va = warp_reduce<kMaxA>(*a), vb = warp_reduce<kMaxB>(*b);
  if (lane == 0) {
    red[warp] = va;
    red[32 + warp] = vb;
  }
  __syncthreads();
  if (warp == 0) {
    *a = warp_reduce<kMaxA>(lane < warps ? red[lane] : 0.f);
    *b = warp_reduce<kMaxB>(lane < warps ? red[32 + lane] : 0.f);
  }
}

// block_tree_w0's result, returned to every thread.
template <bool kMax>
__device__ __forceinline__ float block_reduce(float v, float* red) {
  v = block_tree_w0<kMax>(v, red);
  if (threadIdx.x == 0) red[32] = v;
  __syncthreads();
  const float out = red[32];
  __syncthreads();
  return out;
}

// Sum over the block, returned to every thread.
__device__ __forceinline__ float block_sum(float v, float* red) {
  return block_reduce<false>(v, red);
}

__device__ __forceinline__ float block_nanmax(float v, float* red) {
  return block_reduce<true>(v, red);
}

// Two sums at once (one round of barriers), returned to every thread.
__device__ __forceinline__ void block_sum2(float* a, float* b, float* red) {
  block_tree2_w0<false, false>(a, b, red);
  if (threadIdx.x == 0) {
    red[64] = *a;
    red[65] = *b;
  }
  __syncthreads();
  *a = red[64];
  *b = red[65];
  __syncthreads();
}

// Exclusive prefix sum of one int per thread, in thread order; `total`
// gets the block's sum. `scr` is shared scratch of >= 33 ints.
__device__ __forceinline__ int block_exclusive_scan(int v, int* total,
                                                    int* scr) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  int inc = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += u;
  }
  if (lane == 31) scr[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    int w = lane < warps ? scr[lane] : 0;
    int winc = w;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, winc, o);
      if (lane >= o) winc += u;
    }
    if (lane < warps) scr[lane] = winc - w;     // exclusive warp offsets
    if (lane == 31) scr[32] = winc;             // block total
  }
  __syncthreads();
  const int out = scr[warp] + inc - v;
  *total = scr[32];
  __syncthreads();
  return out;
}

// ---- Host side: a one-block kernel's dynamic shared memory. ----
// Each launcher computes its kernel's size itself (the layout lives only in
// its source) and calls this before the launch. Past what a block of the
// current device can opt in to (227 KB on Hopper) it returns kSmemOver,
// which the Python wrapper turns into a ValueError; else it raises the
// kernel's limit, once per size, and returns 0 or a CUDA error.
constexpr int kSmemOver = -1;

template <typename Kernel>
inline int smem_opt_in(Kernel kernel, size_t bytes, size_t* have) {
  if (bytes <= *have) return 0;
  int dev = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess && bytes > (size_t)limit) return kSmemOver;
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  *have = bytes;
  return 0;
}

}  // namespace pg
}  // namespace ndtpu
