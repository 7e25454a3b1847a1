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
// One launch per call: blocks 0 .. R-1 of 256 threads take the rows, one
// thread each (a row is factor slot t of the whole graph, fid[t] of a
// gathered list, the local path, with its own mask, or slot start + t of
// the fresh window, start = clamp(n_between - window, 0, F - window) read
// on the device); block R takes the priors, one thread each in turns of
// 256. The fresh window of S sessions (a block-diagonal graph stored
// session by session: F factor and V pose slots each, the factors'
// endpoints session-local) is one launch too: row block s takes session
// s's window, up to 256 slots from clamp(n_between[s] - window, 0, F -
// window), its endpoints offset by s V, and its max is that session's
// value, the same bits as the session's own launch (the last block's
// NaN-keeping max of one partial is the partial). A row block stages its
// rows' Ai, Aj and r in shared memory and writes each block's span of the
// three outputs in coalesced 16-byte vectors (the row-per-thread layout is
// a 36-byte stride), and writes its
// chi^2 partial (a shuffle tree within each warp, then one over the warps'
// sums: pose_graph.cuh's block tree, block_sum's order) and its largest
// raw residual. The prior block linearizes the priors and sums their
// chi^2 in prior order. Each block then takes a ticket (its partials
// stored, a __threadfence, an atomicAdd on the wrapper's kept counter);
// the last to arrive resets the counter to 0, reads the partials through
// L2 (__ldcg) and adds the row blocks' in block order, then the priors'
// sum, and takes the NaN-keeping max in block order. So chi^2 and the max
// are the same on every launch, and every output is the same bits as the
// two launches (a rows kernel, a one-warp finish) this design replaced. In
// the chi^2-only mode (null ai) no Jacobian is written.
//
// What bounds it on Hopper: nothing on the card at these sizes. At config
// 2/3 capacity (F = 2,048, P = 4) a call reads ~182 KB (two endpoint
// poses, z, sqrt-info, indices and mask per row) and writes ~172 KB, ~0.1
// us at HBM rate, and does ~180 f32 operations per row; a launch's latency
// and each row's chain of dependent loads (in window mode n_between, then
// the slot's indices, then its poses) are its time.

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
  int sessions;              // > 0: the fresh window of S sessions
  int pose_stride;           // V: session s's poses from s V
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
  float* out;                // [3 + 2 R]: chi^2, max, R row blocks'
                             // (chi^2, max), the priors' chi^2
  int* arrive;               // [], 0 between launches
  int row_blocks;            // R
};

// dst[0 .. n) = src[0 .. n) (src in shared memory) by the whole block:
// single floats up to dst's first 16-byte boundary, 16-byte vectors, then
// the tail.
__device__ __forceinline__ void store_span(float* dst, const float* src,
                                           int n) {
  const int head = min(n, (int)((16 - ((uintptr_t)dst & 15)) & 15) / 4);
  if ((int)threadIdx.x < head) dst[threadIdx.x] = src[threadIdx.x];
  const int body = (n - head) / 4;
  float4* d4 = reinterpret_cast<float4*>(dst + head);
  for (int i = threadIdx.x; i < body; i += blockDim.x) {
    const float* q = src + head + 4 * i;
    d4[i] = make_float4(q[0], q[1], q[2], q[3]);
  }
  for (int i = head + 4 * body + threadIdx.x; i < n; i += blockDim.x)
    dst[i] = src[i];
}

__global__ void __launch_bounds__(kRowThreads)
factor_linearize_kernel(LinArgs a) {
  __shared__ float red[66];
  __shared__ __align__(16) float stage[21 * kRowThreads];
  __shared__ bool last;
  const int b = blockIdx.x, tid = threadIdx.x, R = a.row_blocks;
  if (b < R) {
    const int t0 = a.sessions > 0 ? 0 : b * kRowThreads, t = t0 + tid;
    float chi = 0.f, mx = 0.f;
    if (t < a.rows) {
      long long f, po = 0;
      float m;
      if (a.window > 0) {
        const int sb = a.sessions > 0 ? b : 0;
        long long st = a.n_between[sb] - a.window;
        st = st < 0 ? 0 : st;
        st = st > a.f_cap - a.window ? a.f_cap - a.window : st;
        f = (long long)sb * a.f_cap + st + t;
        po = (long long)sb * a.pose_stride;
        m = a.row_mask[f] ? 1.f : 0.f;
      } else {
        f = a.fid != nullptr ? a.fid[t] : t;
        m = a.row_mask[t] ? 1.f : 0.f;
      }
      const float* pi = a.poses + 3 * (po + a.bet_i[f]);
      const float* pj = a.poses + 3 * (po + a.bet_j[f]);
      float ai[9], aj[9], r[3], raw;
      ndtpu::pg::linearize_between(pi, pj, a.bet_z + 3 * f,
                                   a.bet_sqi + 9 * f, a.delta, a.kind, m, ai,
                                   aj, r, &raw);
      chi = r[0] * r[0] + r[1] * r[1] + r[2] * r[2];
      mx = m != 0.f ? raw : 0.f;
      if (a.ai != nullptr) {
#pragma unroll
        for (int k = 0; k < 9; ++k) {
          stage[9 * tid + k] = ai[k];
          stage[9 * kRowThreads + 9 * tid + k] = aj[k];
        }
#pragma unroll
        for (int k = 0; k < 3; ++k)
          stage[18 * kRowThreads + 3 * tid + k] = r[k];
      }
    }
    // The sum and max in warp 0; the tree's barrier also completes stage.
    ndtpu::pg::block_tree2_w0<false, true>(&chi, &mx, red);
    if (a.ai != nullptr) {
      const int n = min(kRowThreads, a.rows - t0);
      store_span(a.ai + 9 * (size_t)t0, stage, 9 * n);
      store_span(a.aj + 9 * (size_t)t0, stage + 9 * kRowThreads, 9 * n);
      store_span(a.r + 3 * (size_t)t0, stage + 18 * kRowThreads, 3 * n);
    }
    if (tid == 0) {
      a.out[2 + 2 * b] = chi;
      a.out[3 + 2 * b] = mx;
    }
  } else {
    // The priors, one thread each in turns of 256; their chi^2 in prior
    // order by thread 0.
    float pchi = 0.f;
    for (int base = 0; base < a.n_priors; base += kRowThreads) {
      const int k = base + tid;
      float c = 0.f;
      if (k < a.n_priors) {
        const float m = a.prior_mask[k] ? 1.f : 0.f;
        const float* sqi = a.prior_sqi + 9 * k;
        float e[3], rp[3];
        ndtpu::pg::prior_error(a.poses + 3 * a.prior_idx[k],
                               a.prior_z + 3 * k, e);
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
      stage[tid] = c;
      __syncthreads();
      if (tid == 0)
        for (int q = 0; q < kRowThreads && base + q < a.n_priors; ++q)
          pchi += stage[q];
      __syncthreads();
    }
    if (tid == 0) a.out[2 + 2 * R] = pchi;
  }

  // The ticket: the last block to arrive adds the partials.
  if (tid == 0) {
    __threadfence();                 // this block's partials, then the count
    last = atomicAdd(a.arrive, 1) == (int)gridDim.x - 1;
    if (last) __threadfence();       // the count, then the others' partials
  }
  __syncthreads();
  if (!last) return;
  float chi = 0.f, mx = 0.f;
  // The partials, a chunk at a time into shared memory, summed in block
  // order by thread 0.
  constexpr int kChunk = 21 * kRowThreads / 2;
  for (int c0 = 0; c0 < R; c0 += kChunk) {
    const int n = min(kChunk, R - c0);
    for (int i = tid; i < 2 * n; i += kRowThreads)
      stage[i] = __ldcg(a.out + 2 + 2 * c0 + i);
    __syncthreads();
    if (tid == 0)
      for (int q = 0; q < n; ++q) {
        chi += stage[2 * q];
        mx = ndtpu::pg::nanmax(mx, stage[2 * q + 1]);
      }
    __syncthreads();
  }
  if (tid == 0) {
    a.out[0] = chi + __ldcg(a.out + 2 + 2 * R);
    a.out[1] = mx;
    *a.arrive = 0;
  }
}

}  // namespace

extern "C" int factor_linearize_launch(
    const void* poses, const void* bet_i, const void* bet_j,
    const void* bet_z, const void* bet_sqi, const void* row_mask,
    const void* fid, const void* n_between, int rows, int window, int f_cap,
    int sessions, int pose_stride, const void* prior_idx, const void* prior_z, const void* prior_sqi,
    const void* prior_mask, int n_priors, float delta, int kind, void* ai,
    void* aj, void* r, void* ap, void* rp, void* out, void* arrive,
    void* stream) {
  if (rows < 0 || n_priors < 0 || kind < 0 || kind > 3 ||
      arrive == nullptr ||
      (window > 0 && (window > f_cap || rows != window)) ||
      (sessions > 0 && (window < 1 || window > kRowThreads ||
                        pose_stride < 0)))
    return (int)cudaErrorInvalidValue;
  const int blocks = sessions > 0 ? sessions
                                  : (rows + kRowThreads - 1) / kRowThreads;
  const LinArgs a{(const float*)poses, (const long long*)bet_i,
                  (const long long*)bet_j, (const float*)bet_z,
                  (const float*)bet_sqi, (const uint8_t*)row_mask,
                  (const long long*)fid, (const long long*)n_between, rows,
                  window, f_cap, sessions, pose_stride,
                  (const long long*)prior_idx,
                  (const float*)prior_z, (const float*)prior_sqi,
                  (const uint8_t*)prior_mask, n_priors, delta, kind,
                  (float*)ai, (float*)aj, (float*)r, (float*)ap, (float*)rp,
                  (float*)out, (int*)arrive, blocks};
  factor_linearize_kernel<<<blocks + 1, kRowThreads, 0,
                            (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
