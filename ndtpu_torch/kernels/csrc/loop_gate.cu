// K8b, standalone: the loop-closure acceptance gate and factor information
// of every verified (query, candidate) lane of registrations made
// elsewhere.
//
// Replaces what XLA lowered for the TPU from
// ndtpu/loop/closure.py::_gate_and_pack (:171-223), vmapped over the
// window's K queries (:301-302). One block per query, one thread per
// candidate (C <= 128, the block rounded up to whole warps); the gate's
// steps live in loop_gate.cuh, which the gated verify (lm_ndt.cu) runs
// inside the registration launch. On the main path the verify takes that
// route; this kernel is the route for a gate over registrations made
// elsewhere (closure.gate_and_pack) and the reference the fused route is
// held to, bit for bit.
//
// What bounds it: nothing on the card. It is ~800 flops per lane on a
// handful of lanes (4 x 16 for config 3); a launch's latency and the
// wrapper's checks are its time.

#include <cuda_runtime.h>
#include <stdint.h>

#include "loop_gate.cuh"

namespace {

__global__ void __launch_bounds__(ndtpu::kGateMaxLanes)
loop_gate_kernel(const uint8_t* __restrict__ cand_mask,
                 const uint8_t* __restrict__ converged,
                 const float* __restrict__ score,
                 const float* __restrict__ pose,
                 const float* __restrict__ init,
                 const float* __restrict__ hess,
                 const long long* __restrict__ cand_idx,
                 const long long* __restrict__ query_idx,
                 uint8_t* __restrict__ accept_out,
                 uint8_t* __restrict__ innov_rej_out,
                 float* __restrict__ sqrt_info, ndtpu::GateParams p) {
  __shared__ float ranked[ndtpu::kGateMaxLanes];
  const int c = threadIdx.x;
  const size_t base = (size_t)blockIdx.x * p.c_count;
  ndtpu::GateLane in{};
  if (c < p.c_count) {
    const size_t lane = base + c;
    in.cand = cand_mask[lane] != 0;
    in.conv = converged[lane] != 0;
    in.score = score[lane];
    in.px = pose[3 * lane + 0];
    in.py = pose[3 * lane + 1];
    in.ix = init[3 * lane + 0];
    in.iy = init[3 * lane + 1];
    in.cand_idx = cand_idx[lane];
    in.query_idx = query_idx[blockIdx.x];
#pragma unroll
    for (int k = 0; k < 9; ++k) in.h[k] = hess[9 * lane + k];
  }
  ndtpu::gate_query(in, p, ranked, accept_out + base, innov_rej_out + base,
                    sqrt_info + 9 * base);
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
  if (c_count < 1 || c_count > ndtpu::kGateMaxLanes)
    return (int)cudaErrorInvalidValue;
  const ndtpu::GateParams p{c_count, score_gate, innov_base, innov_per_kf,
                            k_budget};
  const int threads = (c_count + 31) / 32 * 32;
  loop_gate_kernel<<<k, threads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)cand_mask, (const uint8_t*)converged,
      (const float*)score, (const float*)pose, (const float*)init,
      (const float*)hess, (const long long*)cand_idx,
      (const long long*)query_idx, (uint8_t*)accept, (uint8_t*)innov_rej,
      (float*)sqrt_info, p);
  return (int)cudaGetLastError();
}
