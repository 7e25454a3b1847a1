// lm_ndt (Queue B K2, built around K1): one NDT registration per lane, the
// whole Levenberg-Marquardt loop in one launch.
//
// Replaces what XLA lowered for the TPU from ndtpu/ndt/match.py::_lm_run
// (:308-345, with _lm_carry_init :298 and _lm_result :348), as driven by
// lm_loop_batch (:354) and the one- and two-phase branches of
// match_batch_packed (:385-475), with the objective of make_sgh
// (:433-450). JAX runs all lanes in lockstep in one lax.while_loop (and
// compacts the stragglers in two-phase mode); each lane's trajectory
// depends only on its own carry, because every sum reduces over that lane's
// beams alone. So here each lane (one block) runs to its own stop, and the
// per-lane results are those of the lockstep loop.
//
// Per lane b, with the 11 sums S(pose) of ndtpu::ndt_lane_sums_wide
// (ndt_sums.cuh; bit for bit K1's ndt_lane_sums), f = -S0, g = d2 *
// S2..4, H = d2 * S5..10 and score = S0 / max(S1, 1):
//   init  pose = init_poses[b]; (f, g, H, score) at it; lam = init_lambda;
//         it = 0; done = (|g0| + |g1| + |g2| == 0); conv = false
//   while it < max_iter && !done:
//     diag_k = max(|H_kk|, 1e-6); A = H + lam * diag(diag)
//     delta = A^-1 (-g) by Cramer's rule in solve3's op order (det = 1e-30
//       when |det| < 1e-30); scale delta to step_clip when its translation
//       norm exceeds it; pose_try = pose + delta (no angle wrap)
//     (f2, g2, H2, s2) at pose_try; accept = f2 < f
//     lam' = accept ? max(lam * (1 / lambda_down), 1e-9) : lam * lambda_up
//     small = |delta| < tol || (!accept && |delta| < reject_tol)
//     stuck = lam' > max_lambda
//     it += 1; done |= small || stuck; conv |= small
//     on accept: pose, f, g, H, score = those of pose_try
//   out: pose, H (symmetric 3 x 3), score, n_iter = it,
//        converged = conv && f < 0
// lam / lambda_down is computed as lam * (1 / lambda_down): that is how
// PyTorch's CUDA division by a Python scalar rounds it, so the kernel and
// the composite route (the same LM step in torch around K1) agree bit for
// bit; JAX divides, which is one f32 rounding away.
//
// Layout: one block per lane, 128 R threads, one beam per thread (ndtpu::
// ndt_lane_sums_wide, ndt_sums.cuh): all of an evaluation's row gathers are
// in flight at once, and the sums at a pose stay bit-identical to K1's
// (the same summing threads fold the same beams in the same order). R =
// min(ceil(n / 128), 8) while the lanes leave the card room, down to 1
// where B x 128 threads already fill it (the wrapper chooses R; no result
// depends on it). Past 128 R beams the block takes them in chunks of 128
// R. The lane's px, py and mask are read from device memory once into
// dynamic shared memory (12 B per beam) and reused by every iteration;
// before them the stored terms (wide_terms_bytes). The table is [R, G*L]
// shared by all lanes, or with group (int32 [B], clamped into [0, S)) a
// stack [S, R, G*L]; the layout (G = 4 or 1 overlap grids, L = 8 full or
// 4 compact lanes per grid) is a template parameter of K1's body, so each
// of the four layouts is its own instantiation (and each again gated and
// ungated, and for R = 1, R <= 4 and R <= 8, which set the launch bounds
// and so the registers a thread may have) with the same LM step. Each
// evaluation ends with every thread holding all 11 sums (the warps'
// partials summed by each thread in warp order, the partials in one of two
// buffers taken in turn, so no evaluation's partials overwrite those
// another thread still reads); every thread then computes the LM step from
// them redundantly (identical inputs, identical result), so the loop
// condition is uniform and needs no broadcast. f32, built with
// --fmad=false and no fast math; no atomics, deterministic.
//
// What bounds it on Hopper: by its roofline, nothing (B = 8, N = 360: about
// 0.4 MB and 10 MFLOP, under 0.2 us). At the main path's small batches (B
// = 8 windows, 64 verify lanes) a few SMs run one lane each, so a lane's
// time is its iterations x (the latency of one evaluation), and one
// evaluation is one dependent chain: transform, row gather (128 B from L2
// at overlap 4), expf and the terms, then the fold and two barriers. With
// one beam per thread an evaluation waits on one gather, not on the three
// (at 360 beams) or six (720) that K1's 128 threads take in series, at the
// cost of 44 x G B of shared memory per stored beam and (R - 1) x 11 x G
// shared-memory loads and adds for each summing thread. At large B (bench
// .py's B = 4,096 x 720 beams) the lanes alone fill the card, the time is
// throughput, not latency, and R = 1 keeps K1's 128 threads and its
// occupancy. Thread-block clusters, which would spread one lane over 2-4
// SMs at B = 8, are untried.
//
// The gated verify (kGate = true) also runs K8b's loop gate
// (loop_gate.cuh) in the same launch, for the loop verify's K queries x C
// candidates (lane b = query b / C, candidate b % C): after thread 0 has
// written lane b's results it makes them visible device-wide
// (__threadfence) and counts the lane in arrive[q] (atomicAdd); the block
// that brings the count to C, the last of its query, gates the query's C
// lanes, C <= 128 threads of it taking one lane each, and sets arrive[q]
// back to 0 for the next launch. The traps of this last-block pattern:
// - the fence on both sides: the writer's fence sits between its stores
//   and its atomicAdd; the last block's thread 0 fences again after its
//   atomicAdd, before the barrier that tells its other threads;
// - stale L1 lines: the last block reads the other lanes' results with
//   __ldcg (cached in L2 only, where the writers' stores are), never
//   through L1, which is not coherent across SMs;
// - counters left non-zero: every block of a launch counts its lane
//   exactly once (no block leaves the kernel early), so a launch that runs
//   to its end leaves every arrive[q] at 0. A launch that is refused never
//   touches them; one that faults leaves the context unusable, and with
//   it the scratch. The wrapper keeps one scratch per (device, K) and the
//   port launches on one stream, so two launches never share the counters
//   at once.
// The ungated instantiation (front end, ungated verify) compiles to the
// kernel without the gate: the gate is an `if constexpr` block.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "loop_gate.cuh"
#include "ndt_sums.cuh"

namespace {

using ndtpu::kNdtSums;
using ndtpu::kNdtThreads;

struct LmParams {
  int n, wh, hh, rows_per_table, n_tables, max_iter;
  float x0, y0, inv, d2, exp_clip;
  float tol, reject_tol, init_lambda, lambda_up, lambda_down, max_lambda,
      step_clip;
};

// The gated verify's extra inputs and outputs (kGate only).
struct GateArgs {
  const uint8_t* cand_mask;      // [K * C] bool
  const long long* query_idx;    // [K]
  const long long* cand_idx;     // [K * C], or null: the lane's group
  uint8_t* accept;               // [K * C]
  uint8_t* innov_rej;            // [K * C]
  float* sqrt_info;              // [K * C, 3, 3]
  int* arrive;                   // [K], 0 between launches
  ndtpu::GateParams p;
};

template <bool kGate, int kG, int kL, int kMaxR>
__global__ void __launch_bounds__(kNdtThreads * kMaxR)
lm_ndt_kernel(const float* __restrict__ init_poses,
              const float* __restrict__ px, const float* __restrict__ py,
              const float* __restrict__ mask,
              const float4* __restrict__ table,
              const int* __restrict__ group, float* __restrict__ pose_out,
              float* __restrict__ hess_out, float* __restrict__ score_out,
              int* __restrict__ iter_out, unsigned char* __restrict__ conv_out,
              LmParams p, GateArgs gate) {
  // The stored terms, then sx[n], sy[n], m[n] and the terms' flags.
  extern __shared__ float4 dyn[];
  __shared__ float part[2][kNdtThreads / 32][kNdtSums];

  const int b = blockIdx.x;
  const int n = p.n;
  if (group != nullptr) {
    const int g = min(max(group[b], 0), p.n_tables - 1);
    table += (size_t)g * p.rows_per_table * ndtpu::row_float4<kG, kL>();
  }
  const int held = blockDim.x - kNdtThreads;
  float4* terms = dyn;
  float* sx = reinterpret_cast<float*>(
      terms + (size_t)held * (ndtpu::wide_beam_floats(kG) / 4));
  float* sy = sx + n;
  float* sm = sy + n;
  unsigned char* hit = reinterpret_cast<unsigned char*>(sm + n);
  const size_t base = (size_t)b * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    sx[i] = px[base + i];
    sy[i] = py[base + i];
    sm[i] = mask[base + i];
  }
  __syncthreads();

  // Sums at (tx, ty, phi) into sums[], in every thread.
  float sums[kNdtSums];
  int parity = 0;
  auto evaluate = [&](float tx, float ty, float phi) {
    ndtpu::ndt_lane_sums_wide<kG, kL, kMaxR>(
        tx, ty, phi, sx, sy, sm, n, table, p.wh, p.hh, p.x0, p.y0, p.inv,
        p.d2, p.exp_clip, terms, hit, part[parity], sums);
    parity ^= 1;
  };

  const float d2 = p.d2;
  float t0 = init_poses[3 * b + 0];
  float t1 = init_poses[3 * b + 1];
  float t2 = init_poses[3 * b + 2];
  evaluate(t0, t1, t2);
  float f = -sums[0];
  float g0 = d2 * sums[2], g1 = d2 * sums[3], g2 = d2 * sums[4];
  float h00 = d2 * sums[5], h01 = d2 * sums[6], h02 = d2 * sums[7];
  float h11 = d2 * sums[8], h12 = d2 * sums[9], h22 = d2 * sums[10];
  float score = sums[0] / fmaxf(sums[1], 1.f);
  float lam = p.init_lambda;
  const float inv_down = 1.f / p.lambda_down;
  int it = 0;
  bool done = (fabsf(g0) + fabsf(g1)) + fabsf(g2) == 0.f;
  bool conv = false;

  while (it < p.max_iter && !done) {
    // _solve_damped: (H + lam |diag H|) delta = -g, solve3's op order.
    const float a00 = h00 + lam * fmaxf(fabsf(h00), 1e-6f);
    const float a11 = h11 + lam * fmaxf(fabsf(h11), 1e-6f);
    const float a22 = h22 + lam * fmaxf(fabsf(h22), 1e-6f);
    const float a01 = h01, a02 = h02, a12 = h12;
    const float a10 = h01, a20 = h02, a21 = h12;
    const float b0 = -g0, b1 = -g1, b2 = -g2;
    const float c00 = a11 * a22 - a12 * a21;
    const float c01 = a12 * a20 - a10 * a22;
    const float c02 = a10 * a21 - a11 * a20;
    float det = a00 * c00 + a01 * c01 + a02 * c02;
    det = fabsf(det) < 1e-30f ? 1e-30f : det;
    const float c10 = a02 * a21 - a01 * a22;
    const float c11 = a00 * a22 - a02 * a20;
    const float c12 = a01 * a20 - a00 * a21;
    const float c20 = a01 * a12 - a02 * a11;
    const float c21 = a02 * a10 - a00 * a12;
    const float c22 = a00 * a11 - a01 * a10;
    float d0 = (c00 * b0 + c10 * b1 + c20 * b2) / det;
    float d1 = (c01 * b0 + c11 * b1 + c21 * b2) / det;
    float dp = (c02 * b0 + c12 * b1 + c22 * b2) / det;
    // Step control: clip the translation norm.
    const float tn = sqrtf(d0 * d0 + d1 * d1);
    const float scale = tn > p.step_clip ? p.step_clip / tn : 1.f;
    d0 = d0 * scale;
    d1 = d1 * scale;
    dp = dp * scale;
    const float u0 = t0 + d0, u1 = t1 + d1, u2 = t2 + dp;

    evaluate(u0, u1, u2);
    const float f2 = -sums[0];
    const bool accept = f2 < f;
    const float lam_n =
        accept ? fmaxf(lam * inv_down, 1e-9f) : lam * p.lambda_up;
    const float dnorm = sqrtf(d0 * d0 + d1 * d1 + dp * dp);
    const bool small =
        dnorm < p.tol || (!accept && dnorm < p.reject_tol);
    const bool stuck = lam_n > p.max_lambda;
    if (accept) {
      t0 = u0;
      t1 = u1;
      t2 = u2;
      f = f2;
      g0 = d2 * sums[2];
      g1 = d2 * sums[3];
      g2 = d2 * sums[4];
      h00 = d2 * sums[5];
      h01 = d2 * sums[6];
      h02 = d2 * sums[7];
      h11 = d2 * sums[8];
      h12 = d2 * sums[9];
      h22 = d2 * sums[10];
      score = sums[0] / fmaxf(sums[1], 1.f);
    }
    lam = lam_n;
    it += 1;
    done = done || small || stuck;
    conv = conv || small;
  }

  if (threadIdx.x == 0) {
    pose_out[3 * b + 0] = t0;
    pose_out[3 * b + 1] = t1;
    pose_out[3 * b + 2] = t2;
    float* h = hess_out + 9 * (size_t)b;
    h[0] = h00; h[1] = h01; h[2] = h02;
    h[3] = h01; h[4] = h11; h[5] = h12;
    h[6] = h02; h[7] = h12; h[8] = h22;
    score_out[b] = score;
    iter_out[b] = it;
    conv_out[b] = (conv && f < 0.f) ? 1 : 0;
  }

  if constexpr (kGate) {
    __shared__ int last;
    __shared__ float ranked[ndtpu::kGateMaxLanes];
    const int c_count = gate.p.c_count;
    const int q = b / c_count;
    if (threadIdx.x == 0) {
      __threadfence();             // lane b's results, then the count
      last = atomicAdd(gate.arrive + q, 1) == c_count - 1;
      if (last) __threadfence();   // the count, then the other lanes' reads
    }
    __syncthreads();
    if (!last) return;
    ndtpu::GateLane in{};
    const int lane = q * c_count + threadIdx.x;
    if (threadIdx.x < c_count) {
      in.cand = gate.cand_mask[lane] != 0;
      in.conv = __ldcg(conv_out + lane) != 0;
      in.score = __ldcg(score_out + lane);
      in.px = __ldcg(pose_out + 3 * lane + 0);
      in.py = __ldcg(pose_out + 3 * lane + 1);
      in.ix = init_poses[3 * lane + 0];
      in.iy = init_poses[3 * lane + 1];
      // The candidate's index, not clamped: the lane's table row, unless
      // the rows are not the candidates' (the fresh-map verify's).
      in.cand_idx = gate.cand_idx != nullptr ? gate.cand_idx[lane]
                                             : (long long)group[lane];
      in.query_idx = gate.query_idx[q];
#pragma unroll
      for (int k = 0; k < 9; ++k) in.h[k] = __ldcg(hess_out + 9 * lane + k);
    }
    const size_t base = (size_t)q * c_count;
    ndtpu::gate_query(in, gate.p, ranked, gate.accept + base,
                      gate.innov_rej + base, gate.sqrt_info + 9 * base);
    if (threadIdx.x == 0) gate.arrive[q] = 0;
  }
}

// Raise the dynamic shared-memory limit of one instantiation (> 48 KB).
template <bool kGate, int kG, int kL, int kMaxR>
cudaError_t opt_in(int smem_bytes) {
  return cudaFuncSetAttribute(lm_ndt_kernel<kGate, kG, kL, kMaxR>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem_bytes);
}

template <bool kGate, int kG, int kL, int kMaxR>
int launch(int b, int spread, int smem_bytes, cudaStream_t stream,
           const void* init_poses, const void* px, const void* py,
           const void* mask, const void* table, const void* group,
           void* pose_out, void* hess_out, void* score_out, void* iter_out,
           void* conv_out, const LmParams& p, const GateArgs& g) {
  if (smem_bytes > 48 * 1024) {   // beyond the default: opt in
    const cudaError_t err = opt_in<kGate, kG, kL, kMaxR>(smem_bytes);
    if (err != cudaSuccess) {
      cudaGetLastError();   // clear it, so the next launch's check is clean
      return (int)err;
    }
  }
  lm_ndt_kernel<kGate, kG, kL, kMaxR>
      <<<b, kNdtThreads * spread, smem_bytes, stream>>>(
          (const float*)init_poses, (const float*)px, (const float*)py,
          (const float*)mask, (const float4*)table, (const int*)group,
          (float*)pose_out, (float*)hess_out, (float*)score_out,
          (int*)iter_out, (unsigned char*)conv_out, p, g);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int lm_ndt_launch(const void* init_poses, const void* px,
                             const void* py, const void* mask,
                             const void* table, const void* group,
                             void* pose_out, void* hess_out, void* score_out,
                             void* iter_out, void* conv_out, int b, int n,
                             int wh, int hh, int rows_per_table, int n_tables,
                             int max_iter, float x0, float y0, float inv,
                             float d2, float exp_clip, float tol,
                             float reject_tol, float init_lambda,
                             float lambda_up, float lambda_down,
                             float max_lambda, float step_clip,
                             const void* cand_mask, const void* query_idx,
                             const void* cand_idx, void* accept, void* innov_rej, void* sqrt_info,
                             void* arrive, int c_count, float score_gate,
                             float innov_base, float innov_per_kf,
                             int k_budget, int smem_bytes, int grids,
                             int lanes, int spread, void* stream) {
  // arrive != null: the gated verify, b = K * c_count lanes in a grouped
  // launch (group holds the candidate indices, or cand_idx where given).
  // spread = R: 128 R threads per lane (1 <= R <= 8), smem_bytes = 12 n +
  // wide_terms_bytes(grids, R).
  const bool gated = arrive != nullptr;
  if (spread < 1 || spread > 8 ||
      smem_bytes < 12 * n + ndtpu::wide_terms_bytes(grids, spread))
    return (int)cudaErrorInvalidValue;
  if (gated && (c_count < 1 || c_count > ndtpu::kGateMaxLanes ||
                b % c_count != 0 || group == nullptr))
    return (int)cudaErrorInvalidValue;
  LmParams p{n, wh, hh, rows_per_table, n_tables, max_iter, x0, y0, inv, d2,
             exp_clip, tol, reject_tol, init_lambda, lambda_up, lambda_down,
             max_lambda, step_clip};
  const GateArgs g{(const uint8_t*)cand_mask, (const long long*)query_idx,
                   (const long long*)cand_idx, (uint8_t*)accept, (uint8_t*)innov_rej, (float*)sqrt_info,
                   (int*)arrive,
                   {c_count, score_gate, innov_base, innov_per_kf, k_budget}};
  return ndtpu::with_layout(grids, lanes, [&](auto kg, auto kl) {
    constexpr int kG = decltype(kg)::value, kL = decltype(kl)::value;
    auto pick = [&](auto wide) {
      constexpr int kMaxR = decltype(wide)::value;
      return gated ? &launch<true, kG, kL, kMaxR>
                   : &launch<false, kG, kL, kMaxR>;
    };
    auto* run = spread == 1   ? pick(std::integral_constant<int, 1>{})
                : spread <= 4 ? pick(std::integral_constant<int, 4>{})
                              : pick(std::integral_constant<int, 8>{});
    return run(b, spread, smem_bytes, (cudaStream_t)stream, init_poses, px,
               py, mask, table, group, pose_out, hess_out, score_out,
               iter_out, conv_out, p, g);
  });
}
