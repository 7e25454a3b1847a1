// K5: linearize the pose graph's factors, with chi^2 and the fresh
// window's largest residual.
//
// Replaces what XLA lowered for the TPU from ndtpu/graph/factors.py::
// linearize (:225; one_bet :239, one_pri :251) with robust_weight
// (:195-218), and chi2 (:261), from
// ndtpu/graph/incremental.py::fresh_residual_max (:83), and from the
// gathered linearization and chi_local of _local_system (:231, :269).
// Per between factor: the error, its analytic Jacobians, whitening by the
// sqrt-information, the robust weight (robust_weight's four kinds: huber,
// cauchy, tukey, geman, by code) and the mask (pose_graph.cuh); per prior
// the same with an identity Jacobian and no weight.
//
// Rows: one thread per row, in blocks of 256. A row is factor slot t (the
// whole graph), fid[t] (a gathered list, the local path, with its own
// mask), or slot start + t of the fresh window (start = clamp(n_between -
// window, 0, F - window), read on the device). Each block writes its chi^2
// partial (a shuffle tree within each warp, then one over the warps'
// sums) and its largest raw residual; a second launch of one warp, in the
// same call, linearizes the priors, adds the block partials in block order
// and then the priors' in prior order, and writes the two scalars. So
// chi^2 is the same on every launch. In the chi^2-only mode (null ai) no
// Jacobian is written.
//
// What bounds it on Hopper: nothing on the card at these sizes. At config
// 2/3 capacity (F = 2,048, P = 4) a call reads ~182 KB (two endpoint
// poses, z, sqrt-info, indices and mask per row) and writes ~172 KB, ~0.1
// us at HBM rate, and does ~180 f32 operations per row; two launches'
// latency is its time, and the one-thread-per-row grid keeps the row
// arithmetic off the critical path.

#include <cuda_runtime.h>
#include <stdint.h>

#include "pose_graph.cuh"

namespace {

constexpr int kRowThreads = 256;

struct LinArgs {
  const float* poses;
  const long long* bet_i;
  const long long* bet_j;
  const float* bet_z;
  const float* bet_sqi;
  const uint8_t* row_mask;   // [rows], or bet_mask [F] in window mode
  const long long* fid;      // gathered slots, or null
  const long long* n_between;
  int rows;
  int window;                // > 0: the fresh-window mode
  int f_cap;
  const long long* prior_idx;
  const float* prior_z;
  const float* prior_sqi;
  const uint8_t* prior_mask;
  int n_priors;
  float delta;               // robust threshold; 0: no weight
  int kind;                  // robust kernel code (pose_graph.cuh)
  float* ai;                 // [rows, 9], or null (chi^2 only)
  float* aj;
  float* r;                  // [rows, 3]
  float* ap;                 // [P, 9]
  float* rp;                 // [P, 3]
  float* out;                // [2 + 2 * blocks]: chi^2, max, partials
};

__global__ void __launch_bounds__(kRowThreads)
linearize_rows_kernel(LinArgs a) {
  __shared__ float red[66];
  const int t = blockIdx.x * kRowThreads + threadIdx.x;
  float chi = 0.f, mx = 0.f;
  if (t < a.rows) {
    long long f;
    float m;
    if (a.window > 0) {
      long long st = *a.n_between - a.window;
      st = st < 0 ? 0 : st;
      st = st > a.f_cap - a.window ? a.f_cap - a.window : st;
      f = st + t;
      m = a.row_mask[f] ? 1.f : 0.f;
    } else {
      f = a.fid != nullptr ? a.fid[t] : t;
      m = a.row_mask[t] ? 1.f : 0.f;
    }
    const float* pi = a.poses + 3 * a.bet_i[f];
    const float* pj = a.poses + 3 * a.bet_j[f];
    float ai[9], aj[9], r[3], raw;
    ndtpu::pg::linearize_between(pi, pj, a.bet_z + 3 * f, a.bet_sqi + 9 * f,
                                 a.delta, a.kind, m, ai, aj, r, &raw);
    chi = r[0] * r[0] + r[1] * r[1] + r[2] * r[2];
    mx = m != 0.f ? raw : 0.f;
    if (a.ai != nullptr) {
#pragma unroll
      for (int k = 0; k < 9; ++k) {
        a.ai[9 * t + k] = ai[k];
        a.aj[9 * t + k] = aj[k];
      }
#pragma unroll
      for (int k = 0; k < 3; ++k) a.r[3 * t + k] = r[k];
    }
  }
  chi = ndtpu::pg::block_sum(chi, red);
  mx = ndtpu::pg::block_nanmax(mx, red);
  if (threadIdx.x == 0) {
    a.out[2 + 2 * blockIdx.x] = chi;
    a.out[3 + 2 * blockIdx.x] = mx;
  }
}

// One warp: the priors (one lane each, in turns of 32), then the sums.
__global__ void __launch_bounds__(32) linearize_finish_kernel(LinArgs a,
                                                              int blocks) {
  __shared__ float prior_chi[32];
  float pchi = 0.f;
  for (int base = 0; base < a.n_priors; base += 32) {
    const int k = base + threadIdx.x;
    float c = 0.f;
    if (k < a.n_priors) {
      const float m = a.prior_mask[k] ? 1.f : 0.f;
      const float* sqi = a.prior_sqi + 9 * k;
      float e[3], rp[3];
      ndtpu::pg::prior_error(a.poses + 3 * a.prior_idx[k], a.prior_z + 3 * k,
                             e);
      ndtpu::pg::mv3(sqi, e, rp);
#pragma unroll
      for (int q = 0; q < 3; ++q) rp[q] = rp[q] * m;
      c = rp[0] * rp[0] + rp[1] * rp[1] + rp[2] * rp[2];
      if (a.ap != nullptr) {
#pragma unroll
        for (int q = 0; q < 9; ++q) a.ap[9 * k + q] = sqi[q] * m;
#pragma unroll
        for (int q = 0; q < 3; ++q) a.rp[3 * k + q] = rp[q];
      }
    }
    prior_chi[threadIdx.x] = c;
    __syncwarp();
    if (threadIdx.x == 0)
      for (int q = 0; q < 32 && base + q < a.n_priors; ++q)
        pchi += prior_chi[q];
    __syncwarp();
  }
  if (threadIdx.x == 0) {
    float chi = 0.f, mx = 0.f;
    for (int b = 0; b < blocks; ++b) {
      chi += a.out[2 + 2 * b];
      mx = ndtpu::pg::nanmax(mx, a.out[3 + 2 * b]);
    }
    a.out[0] = chi + pchi;
    a.out[1] = mx;
  }
}

}  // namespace

extern "C" int factor_linearize_launch(
    const void* poses, const void* bet_i, const void* bet_j,
    const void* bet_z, const void* bet_sqi, const void* row_mask,
    const void* fid, const void* n_between, int rows, int window, int f_cap,
    const void* prior_idx, const void* prior_z, const void* prior_sqi,
    const void* prior_mask, int n_priors, float delta, int kind, void* ai,
    void* aj, void* r, void* ap, void* rp, void* out, void* stream) {
  if (rows < 0 || n_priors < 0 || kind < 0 || kind > 3 ||
      (window > 0 && (window > f_cap || rows != window)))
    return (int)cudaErrorInvalidValue;
  const LinArgs a{(const float*)poses, (const long long*)bet_i,
                  (const long long*)bet_j, (const float*)bet_z,
                  (const float*)bet_sqi, (const uint8_t*)row_mask,
                  (const long long*)fid, (const long long*)n_between, rows,
                  window, f_cap, (const long long*)prior_idx,
                  (const float*)prior_z, (const float*)prior_sqi,
                  (const uint8_t*)prior_mask, n_priors, delta, kind,
                  (float*)ai, (float*)aj, (float*)r, (float*)ap, (float*)rp,
                  (float*)out};
  const int blocks = (rows + kRowThreads - 1) / kRowThreads;
  cudaStream_t s = (cudaStream_t)stream;
  if (blocks > 0) {
    linearize_rows_kernel<<<blocks, kRowThreads, 0, s>>>(a);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  linearize_finish_kernel<<<1, 32, 0, s>>>(a, blocks);
  return (int)cudaGetLastError();
}
