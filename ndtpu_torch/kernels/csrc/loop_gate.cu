// K8b: the loop-closure acceptance gate and factor information of every
// verified (query, candidate) lane.
//
// Replaces what XLA lowered for the TPU from
// ndtpu/loop/closure.py::_gate_and_pack (:171-223), vmapped over the
// window's K queries (:301-302), with graph/factors.py::info_to_sqrt_info
// (:141-159). Per query (one block) and candidate c (one thread, C <= 32,
// so one warp):
//   1. accept = candidate real & registration converged & score >= gate;
//   2. innovation budget (when max_innovation_per_kf > 0): the verified
//      pose may move from its init by at most base + per_kf * |query index
//      - candidate index|; lanes past it are counted in innov_rej;
//   3. sparsity budget (k > 0): keep the lanes whose score is >= the k-th
//      largest accepted score. A lane's score is >= the k-th value exactly
//      when fewer than k lanes have a strictly larger one, so the
//      threshold is a warp-level rank (C shuffles), ties kept as top_k's
//      ">= kth" keeps them; with fewer than k accepted, all stay;
//   4. the information: H symmetrized (0.5 * (H + H^T)), identity for
//      rejected lanes, eigenvalues clamped to [1e-3, 1e8] (cyclic Jacobi
//      sweeps on the 3 x 3 in registers, then V diag(w) V^T), + 1e-6 I,
//      closed-form Cholesky with the max(., 1e-12) clamps, R = L^T;
//   5. a lane whose sqrt-information is not finite is rejected and gets I.
// The eigenvalue floor is the guard for a lane stopped at the iteration
// cap on an indefinite Hessian (ROADMAP C-w3): without it the Cholesky
// emits huge or inf entries that poison the whole graph.
//
// What bounds it: nothing on the card. It is ~500 flops per lane on a
// handful of lanes (4 x 16 for config 3), one launch in place of the
// dozens of small PyTorch kernels (and a batched eigh) of the twin.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kSweeps = 8;

// Cyclic Jacobi on symmetric a (3 x 3, row-major); on return the diagonal
// of a holds the eigenvalues and the columns of v the eigenvectors.
__device__ void jacobi3(float a[3][3], float v[3][3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) v[i][j] = i == j ? 1.f : 0.f;
  for (int sweep = 0; sweep < kSweeps; ++sweep) {
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

__global__ void __launch_bounds__(kWarp)
loop_gate_kernel(const uint8_t* __restrict__ cand_mask,
                 const uint8_t* __restrict__ converged,
                 const float* __restrict__ score,
                 const float* __restrict__ pose,
                 const float* __restrict__ init,
                 const float* __restrict__ hess,
                 const int* __restrict__ cand_idx,
                 const int* __restrict__ query_idx,
                 uint8_t* __restrict__ accept_out,
                 uint8_t* __restrict__ innov_rej_out,
                 float* __restrict__ sqrt_info, int c_count,
                 float score_gate, float innov_base, float innov_per_kf,
                 int k_budget) {
  const int c = threadIdx.x;
  const bool live = c < c_count;
  const size_t lane = (size_t)blockIdx.x * c_count + c;
  bool acc = false, rej = false;
  float sc = 0.f;
  if (live) {
    sc = score[lane];
    acc = cand_mask[lane] && converged[lane] && sc >= score_gate;
    if (innov_per_kf > 0.f) {
      const float dx = pose[3 * lane + 0] - init[3 * lane + 0];
      const float dy = pose[3 * lane + 1] - init[3 * lane + 1];
      const float innov = sqrtf(dx * dx + dy * dy);
      const float gap = (float)abs(query_idx[blockIdx.x] - cand_idx[lane]);
      const float budget = innov_base + innov_per_kf * gap;
      rej = acc && innov > budget;
      acc = acc && innov <= budget;
    }
  }
  if (k_budget > 0) {
    const float ranked = acc ? sc : -INFINITY;
    int above = 0;
    for (int j = 0; j < kWarp; ++j) {
      const float other = __shfl_sync(0xffffffffu, ranked, j);
      above += (j < c_count && other > ranked) ? 1 : 0;
    }
    acc = acc && above < k_budget;
  }
  if (!live) return;

  float a[3][3], v[3][3];
  const float* h = hess + 9 * lane;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      a[i][j] = acc ? 0.5f * (h[3 * i + j] + h[3 * j + i])
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
  float* out = sqrt_info + 9 * lane;
#pragma unroll
  for (int k = 0; k < 9; ++k)
    out[k] = finite ? r[k] : (k % 4 == 0 ? 1.f : 0.f);
  accept_out[lane] = (acc && finite) ? 1 : 0;
  innov_rej_out[lane] = rej ? 1 : 0;
}

}  // namespace

extern "C" int loop_gate_launch(const void* cand_mask, const void* converged,
                                const void* score, const void* pose,
                                const void* init, const void* hess,
                                const void* cand_idx, const void* query_idx,
                                void* accept, void* innov_rej,
                                void* sqrt_info, int k, int c_count,
                                float score_gate, float innov_base,
                                float innov_per_kf, int k_budget,
                                void* stream) {
  loop_gate_kernel<<<k, kWarp, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)cand_mask, (const uint8_t*)converged,
      (const float*)score, (const float*)pose, (const float*)init,
      (const float*)hess, (const int*)cand_idx, (const int*)query_idx,
      (uint8_t*)accept, (uint8_t*)innov_rej, (float*)sqrt_info, c_count,
      score_gate, innov_base, innov_per_kf, k_budget);
  return (int)cudaGetLastError();
}
