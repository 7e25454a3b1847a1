// Device code of K8b, shared by the standalone gate (loop_gate.cu) and the
// gated verify (lm_ndt.cu, kGate): the loop-closure acceptance gate and
// factor information of one query's C candidate lanes, thread c taking
// lane c.
//
// Port of ndtpu/loop/closure.py::_gate_and_pack (:171-223), with
// graph/factors.py::info_to_sqrt_info (:141-159), for one query:
//   1. accept = candidate real & registration converged & score >= gate;
//   2. innovation budget (when max_innovation_per_kf > 0): the verified
//      pose may move from its init by at most base + per_kf * |query index
//      - candidate index|; lanes past it are counted in innov_rej;
//   3. sparsity budget (k > 0): keep the lanes whose score is >= the k-th
//      largest accepted score. A lane's score is >= the k-th value exactly
//      when fewer than k lanes have a strictly larger one, so each lane
//      counts the lanes above it in a shared-memory array of the C ranked
//      scores; ties are kept as top_k's ">= kth" keeps them, and with
//      fewer than k accepted all stay;
//   4. the information: H symmetrized (0.5 * (H + H^T)), identity for
//      rejected lanes, eigenvalues clamped to [1e-3, 1e8] (cyclic Jacobi
//      sweeps on the 3 x 3 in registers, then V diag(w) V^T), + 1e-6 I,
//      closed-form Cholesky with the max(., 1e-12) clamps, R = L^T;
//   5. a lane whose sqrt-information is not finite is rejected and gets I.
// The eigenvalue floor is the guard for a lane stopped at the iteration
// cap on an indefinite Hessian (ROADMAP C-w3): without it the Cholesky
// emits huge or inf entries that poison the whole graph.
//
// The files that include this are built with --fmad=false and without
// fast math, so both routes give the same bits from the same lane inputs.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace ndtpu {

// The widest gate: one thread per candidate, within lm_ndt's block.
constexpr int kGateMaxLanes = 128;

struct GateParams {
  int c_count;            // candidates per query, <= kGateMaxLanes
  float score_gate, innov_base, innov_per_kf;
  int k_budget;           // 0: no sparsity budget
};

// One lane's inputs, as the registration left them.
struct GateLane {
  bool cand, conv;
  float score;
  float px, py;           // verified pose (translation)
  float ix, iy;           // initial pose (translation)
  long long cand_idx, query_idx;
  float h[9];             // registration Hessian, row-major
};

constexpr int kJacobiSweeps = 8;

// Cyclic Jacobi on symmetric a (3 x 3, row-major); on return the diagonal
// of a holds the eigenvalues and the columns of v the eigenvectors.
__device__ __forceinline__ void jacobi3(float a[3][3], float v[3][3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) v[i][j] = i == j ? 1.f : 0.f;
  for (int sweep = 0; sweep < kJacobiSweeps; ++sweep) {
#pragma unroll
    for (int pq = 0; pq < 3; ++pq) {
      const int p = pq == 2 ? 1 : 0;
      const int q = pq == 0 ? 1 : 2;
      const float apq = a[p][q];
      if (apq == 0.f) continue;
      const float theta = (a[q][q] - a[p][p]) / (2.f * apq);
      const float t = (theta >= 0.f ? 1.f : -1.f) /
                      (fabsf(theta) + sqrtf(theta * theta + 1.f));
      const float c = 1.f / sqrtf(t * t + 1.f);
      const float s = t * c;
      const int r = 3 - p - q;   // the third index
      const float arp = a[r][p], arq = a[r][q];
      a[p][p] -= t * apq;
      a[q][q] += t * apq;
      a[p][q] = a[q][p] = 0.f;
      a[r][p] = a[p][r] = c * arp - s * arq;
      a[r][q] = a[q][r] = s * arp + c * arq;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const float vkp = v[k][p], vkq = v[k][q];
        v[k][p] = c * vkp - s * vkq;
        v[k][q] = s * vkp + c * vkq;
      }
    }
  }
}

// The gate of one query. Every thread of the block calls it (it holds a
// barrier when k_budget > 0); thread c < p.c_count is lane c, with its
// inputs in `in`; `ranked` is shared memory of at least p.c_count floats.
// Lane c's results go to accept[c], innov_rej[c] and sqrt_info[9 c ..].
__device__ __forceinline__ void gate_query(const GateLane& in,
                                           const GateParams& p,
                                           float* ranked, uint8_t* accept,
                                           uint8_t* innov_rej,
                                           float* sqrt_info) {
  const int c = threadIdx.x;
  const bool live = c < p.c_count;
  bool acc = false, rej = false;
  if (live) {
    acc = in.cand && in.conv && in.score >= p.score_gate;
    if (p.innov_per_kf > 0.f) {
      const float dx = in.px - in.ix;
      const float dy = in.py - in.iy;
      const float innov = sqrtf(dx * dx + dy * dy);
      const float gap = (float)llabs(in.query_idx - in.cand_idx);
      const float budget = p.innov_base + p.innov_per_kf * gap;
      rej = acc && innov > budget;
      acc = acc && innov <= budget;
    }
  }
  if (p.k_budget > 0) {
    const float mine = acc ? in.score : -INFINITY;
    if (live) ranked[c] = mine;
    __syncthreads();
    int above = 0;
    for (int j = 0; j < p.c_count; ++j) above += ranked[j] > mine ? 1 : 0;
    acc = acc && above < p.k_budget;
  }
  if (!live) return;

  float a[3][3], v[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      a[i][j] = acc ? 0.5f * (in.h[3 * i + j] + in.h[3 * j + i])
                    : (i == j ? 1.f : 0.f);
  jacobi3(a, v);
  float w[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) w[k] = fminf(fmaxf(a[k][k], 1e-3f), 1e8f);
  float m[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      m[i][j] = v[i][0] * w[0] * v[j][0] + v[i][1] * w[1] * v[j][1] +
                v[i][2] * w[2] * v[j][2] + (i == j ? 1e-6f : 0.f);
  // info_to_sqrt_info
  const float l11 = sqrtf(fmaxf(m[0][0], 1e-12f));
  const float l21 = m[1][0] / l11;
  const float l31 = m[2][0] / l11;
  const float l22 = sqrtf(fmaxf(m[1][1] - l21 * l21, 1e-12f));
  const float l32 = (m[2][1] - l31 * l21) / l22;
  const float l33 = sqrtf(fmaxf(m[2][2] - l31 * l31 - l32 * l32, 1e-12f));
  const float r[9] = {l11, l21, l31, 0.f, l22, l32, 0.f, 0.f, l33};
  bool finite = true;
#pragma unroll
  for (int k = 0; k < 9; ++k) finite = finite && isfinite(r[k]);
  float* out = sqrt_info + 9 * c;
#pragma unroll
  for (int k = 0; k < 9; ++k)
    out[k] = finite ? r[k] : (k % 4 == 0 ? 1.f : 0.f);
  accept[c] = (acc && finite) ? 1 : 0;
  innov_rej[c] = rej ? 1 : 0;
}

}  // namespace ndtpu
