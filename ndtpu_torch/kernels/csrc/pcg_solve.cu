// K6: the whole block-Jacobi PCG solve of (H + damping) x = rhs, matrix
// free, in one launch; and K6b, S such solves in lockstep, one block each.
//
// K6 replaces what XLA lowered for the TPU from ndtpu/graph/solve.py::pcg_rhs
// (:167, its lax.while_loop :194-211) with hessian_matvec (:79), gradient
// (:99), block_diag_hessian (:110) and _inv3 (:121), as pcg (:158) and
// optimize (:279) call it; and the preconditioned gradient of the
// smoother's settled check (ndtpu/graph/incremental.py:399-414), which is
// the same set-up run with 0 iterations: its max |z_0| is written beside x.
//
// K6b replaces ndtpu/graph/solve.py::pcg_rhs_blocked (:215-271) as the
// stacked multi-session smoother calls it (ndtpu/dist/slam_dp.py:233): the
// flat graph of S sessions, whose session s owns poses [s V, (s + 1) V),
// factor slots [s F, (s + 1) F) and prior slots [s P, (s + 1) P). Its
// Krylov scalars (alpha, beta, the dot products) are per session, so the
// lockstep iteration is exactly S independent PCGs, and it runs exactly
// max_iter iterations with no tolerance stop. So the grid is S blocks,
// block s solving session s with the same code as K6: pointers shifted to
// its slices, flat indices less s V, its damping lam[s] read through a
// pointer (no host read). A session whose right-hand side is 0 takes
// guarded steps (alpha = 0 / max(0, 1e-30) = 0, beta likewise) and its x
// stays 0. No reduction crosses a session: that is the fault (one session
// per batch drifting 2-7 m) that global scalars cause.
//
// One block of up to 1,024 threads holds a whole solve in shared memory
// (x, r, z, p, A p, the damping and the 3 x 3 inverses per pose, the
// per-factor products y_f = Ai p_i + Aj p_j, and an incidence list per
// pose: ~158 KB at V = 1,024, F = 2,048; ~26 KB for a serving session,
// V = 160, F = 320). Thread t owns poses t, t + T, ...; every per-pose
// quantity but p is read only by its owner.
//   1. Set-up. The incidence lists (CSR over bet_i, bet_j and prior_idx,
//      live factors and priors only; dead rows of the linearization are 0)
//      are built by a counting pass, a scan and a fill with shared-memory
//      integer atomics, then each list is sorted by (factor, side), priors
//      last, so the order is fixed whatever order the atomics ran in. Each
//      owner walks its list for its diagonal block and gradient, damps the
//      block (lam read through a pointer: no host read), inverts it
//      (_inv3), and starts r = rhs (or -gradient), z = M^-1 r, p = z.
//   2. The loop, to max_iter; K6 also stops on JAX's test |r|^2 >
//      (tol |rhs|)^2, evaluated on the device: y_f for each live factor;
//      each owner sums A_f^T y_f over its list in order (no float atomics:
//      two factors between one pair add in list order), adds the priors and
//      damp * p; two block reductions per iteration (p.Ap, then r.z and r.r
//      together) in a fixed order (pose_graph.cuh). So x and the iteration
//      count are the same on every launch.
// Each launcher refuses (it computes the size and returns kSmemOver; the
// wrapper raises) a graph, or for K6b a session, whose state does not fit
// one block's shared memory. Larger graphs (config 4's 10k poses, config
// 5's merged graph) go to K6g (pcg_grid.cu), the same solve across many
// SMs: graph.solve.pcg_solve routes by kernels.pcg_route, which mirrors
// pcg_smem below and the 227 KB opt-in.
//
// What bounds it on Hopper: for the bound, the bytes of one pass (the
// linearization, ~300 KB at capacity) and ~60 f32 operations per live
// factor and 30 per pose per iteration; in practice the chain of four
// barriers per iteration on one SM (the reductions need the whole block),
// which is why the whole loop is one block rather than a launch per op.
// K6b's S blocks run on S SMs side by side, so S sessions take about the
// time of one.

#include <cuda_runtime.h>
#include <stdint.h>

#include "pose_graph.cuh"

namespace {

constexpr int kMaxThreads = 1024;

struct PcgArgs {
  const long long* bet_i;
  const long long* bet_j;
  const uint8_t* bet_mask;
  int n_fac;
  const long long* prior_idx;
  const uint8_t* prior_mask;
  int n_pri;
  const uint8_t* pose_mask;
  int n_pose;
  const float* ai;     // [F, 9]
  const float* aj;
  const float* r;      // [F, 3]
  const float* ap;     // [P, 9]
  const float* rp;     // [P, 3]
  const float* rhs;    // [V, 3], or null: -gradient
  const float* lam;    // [] ([S] for K6b), or null: lam_value
  float lam_value;
  float damp_abs;
  int max_iter;
  float tol;
  float* x;            // [V, 3]
  int* iters;          // [] (null for K6b: always max_iter)
  float* zmax;         // [] (null for K6b)
};

// K6b: session blockIdx.x's slices of the flat graph. Sizes are per
// session; the flat pose index of its pose v is the returned pose0 + v.
__device__ __forceinline__ long long session_slices(PcgArgs* a) {
  const size_t s = blockIdx.x;
  const size_t v = a->n_pose, f = a->n_fac, p = a->n_pri;
  a->bet_i += s * f;
  a->bet_j += s * f;
  a->bet_mask += s * f;
  a->prior_idx += s * p;
  a->prior_mask += s * p;
  a->pose_mask += s * v;
  a->ai += 9 * s * f;
  a->aj += 9 * s * f;
  a->r += 3 * s * f;
  a->ap += 9 * s * p;
  a->rp += 3 * s * p;
  if (a->rhs != nullptr) a->rhs += 3 * s * v;
  if (a->lam != nullptr) a->lam += s;
  a->x += 3 * s * v;
  return (long long)(s * v);
}

// Shared-memory bytes of one solve.
inline size_t pcg_smem(int v, int f, int p) {
  return 4 * (size_t)(27 * v + 3 * f + 68)
         + 4 * (size_t)(2 * v + 2 * f + p + 38) + (size_t)f;
}

__device__ __forceinline__ const float* entry_a(const PcgArgs& a, int e,
                                                int* row, bool* prior) {
  const int two_f = 2 * a.n_fac;
  if (e < two_f) {
    *row = e >> 1;
    *prior = false;
    return ((e & 1) ? a.aj : a.ai) + 9 * (size_t)(e >> 1);
  }
  *row = e - two_f;
  *prior = true;
  return a.ap + 9 * (size_t)(e - two_f);
}

template <bool kBlocked>
__global__ void __launch_bounds__(kMaxThreads)
pcg_solve_kernel(const PcgArgs args) {
  extern __shared__ float4 smem4[];
  PcgArgs a = args;
  const long long pose0 = kBlocked ? session_slices(&a) : 0;
  const int V = a.n_pose, F = a.n_fac, P = a.n_pri;
  const int T = blockDim.x, tid = threadIdx.x;
  float* x = reinterpret_cast<float*>(smem4);
  float* r = x + 3 * V;
  float* z = r + 3 * V;
  float* p = z + 3 * V;
  float* q = p + 3 * V;
  float* damp = q + 3 * V;
  float* minv = damp + 3 * V;
  float* y = minv + 9 * V;
  float* red = y + 3 * F;
  int* off = reinterpret_cast<int*>(red + 68);
  int* cnt = off + V + 1;
  int* ent = cnt + V;
  int* scr = ent + 2 * F + P;
  uint8_t* fm = reinterpret_cast<uint8_t*>(scr + 37);

  // 1a. Incidence counts of the live factors and priors.
  for (int v = tid; v < V; v += T) cnt[v] = 0;
  for (int f = tid; f < F; f += T) fm[f] = a.bet_mask[f];
  __syncthreads();
  for (int f = tid; f < F; f += T) {
    if (!fm[f]) continue;
    atomicAdd(cnt + (a.bet_i[f] - pose0), 1);
    atomicAdd(cnt + (a.bet_j[f] - pose0), 1);
  }
  for (int k = tid; k < P; k += T)
    if (a.prior_mask[k]) atomicAdd(cnt + (a.prior_idx[k] - pose0), 1);
  __syncthreads();

  // 1b. Offsets: each thread scans a contiguous chunk of poses.
  const int chunk = (V + T - 1) / T;
  const int v0 = min(tid * chunk, V), v1 = min(v0 + chunk, V);
  int mine = 0;
  for (int v = v0; v < v1; ++v) mine += cnt[v];
  int total;
  int base = ndtpu::pg::block_exclusive_scan(mine, &total, scr);
  for (int v = v0; v < v1; ++v) {
    off[v] = base;
    base += cnt[v];
    cnt[v] = 0;
  }
  if (tid == 0) off[V] = total;
  __syncthreads();

  // 1c. Fill, then sort each list by (factor, side), priors last.
  for (int f = tid; f < F; f += T) {
    if (!fm[f]) continue;
    const int i = (int)(a.bet_i[f] - pose0), j = (int)(a.bet_j[f] - pose0);
    ent[off[i] + atomicAdd(cnt + i, 1)] = 2 * f;
    ent[off[j] + atomicAdd(cnt + j, 1)] = 2 * f + 1;
  }
  for (int k = tid; k < P; k += T) {
    if (!a.prior_mask[k]) continue;
    const int i = (int)(a.prior_idx[k] - pose0);
    ent[off[i] + atomicAdd(cnt + i, 1)] = 2 * F + k;
  }
  __syncthreads();

  // 1d. Per owned pose: diagonal block, gradient, damping, M^-1, r, z, p.
  const float lam = a.lam != nullptr ? *a.lam : a.lam_value;
  float rz = 0.f, bb = 0.f, zm = 0.f;
  for (int v = tid; v < V; v += T) {
    const int e0 = off[v], e1 = off[v + 1];
    for (int e = e0 + 1; e < e1; ++e) {       // insertion sort
      const int key = ent[e];
      int k = e - 1;
      while (k >= e0 && ent[k] > key) {
        ent[k + 1] = ent[k];
        --k;
      }
      ent[k + 1] = key;
    }
    float d[9] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    float g[3] = {0.f, 0.f, 0.f};
    for (int e = e0; e < e1; ++e) {
      int row;
      bool prior;
      const float* am = entry_a(a, ent[e], &row, &prior);
      const float* res = prior ? a.rp + 3 * (size_t)row
                               : a.r + 3 * (size_t)row;
      float t9[9], t3[3];
      ndtpu::pg::mtm3(am, am, t9);
      ndtpu::pg::mtv3(am, res, t3);
#pragma unroll
      for (int k = 0; k < 9; ++k) d[k] = d[k] + t9[k];
#pragma unroll
      for (int k = 0; k < 3; ++k) g[k] = g[k] + t3[k];
    }
    const float dead = a.pose_mask[v] ? 0.f : 1.f;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float dk = lam * fmaxf(fabsf(d[4 * k]), 1e-8f)
                       + (a.damp_abs + dead);
      damp[3 * v + k] = dk;
      d[4 * k] = d[4 * k] + dk;
    }
    ndtpu::pg::inv3(d, minv + 9 * v);
    float rv[3], zv[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      rv[k] = a.rhs != nullptr ? a.rhs[3 * (size_t)v + k] : -g[k];
      x[3 * v + k] = 0.f;
      r[3 * v + k] = rv[k];
    }
    ndtpu::pg::mv3(minv + 9 * v, rv, zv);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      z[3 * v + k] = zv[k];
      p[3 * v + k] = zv[k];
      zm = ndtpu::pg::nanmax(zm, fabsf(zv[k]));
    }
    rz = rz + (rv[0] * zv[0] + rv[1] * zv[1] + rv[2] * zv[2]);
    bb = bb + (rv[0] * rv[0] + rv[1] * rv[1] + rv[2] * rv[2]);
  }
  ndtpu::pg::block_sum2(&rz, &bb, red);      // its barriers publish p
  zm = ndtpu::pg::block_nanmax(zm, red);
  const float bn = fmaxf(sqrtf(bb), 1e-30f);
  const float tol2 = (a.tol * bn) * (a.tol * bn);
  float rr = bb;

  // 2. The loop (K6b: no tolerance stop).
  int it = 0;
  while (it < a.max_iter && (kBlocked || rr > tol2)) {
    for (int f = tid; f < F; f += T) {
      if (!fm[f]) continue;
      const float* pi = p + 3 * (a.bet_i[f] - pose0);
      const float* pj = p + 3 * (a.bet_j[f] - pose0);
      float u[3], w[3];
      ndtpu::pg::mv3(a.ai + 9 * (size_t)f, pi, u);
      ndtpu::pg::mv3(a.aj + 9 * (size_t)f, pj, w);
#pragma unroll
      for (int k = 0; k < 3; ++k) y[3 * f + k] = u[k] + w[k];
    }
    __syncthreads();
    float pq = 0.f;
    for (int v = tid; v < V; v += T) {
      float acc[3] = {0.f, 0.f, 0.f};
      for (int e = off[v]; e < off[v + 1]; ++e) {
        int row;
        bool prior;
        const float* am = entry_a(a, ent[e], &row, &prior);
        float yy[3], t3[3];
        if (prior) {
          ndtpu::pg::mv3(am, p + 3 * v, yy);
        } else {
#pragma unroll
          for (int k = 0; k < 3; ++k) yy[k] = y[3 * row + k];
        }
        ndtpu::pg::mtv3(am, yy, t3);
#pragma unroll
        for (int k = 0; k < 3; ++k) acc[k] = acc[k] + t3[k];
      }
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const float qk = acc[k] + damp[3 * v + k] * p[3 * v + k];
        q[3 * v + k] = qk;
      }
      pq = pq + (p[3 * v] * q[3 * v] + p[3 * v + 1] * q[3 * v + 1]
                 + p[3 * v + 2] * q[3 * v + 2]);
    }
    pq = ndtpu::pg::block_sum(pq, red);
    const float alpha = rz / fmaxf(pq, 1e-30f);
    float rzn = 0.f, rrn = 0.f;
    for (int v = tid; v < V; v += T) {
      float rv[3], zv[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        x[3 * v + k] = x[3 * v + k] + alpha * p[3 * v + k];
        rv[k] = r[3 * v + k] - alpha * q[3 * v + k];
        r[3 * v + k] = rv[k];
      }
      ndtpu::pg::mv3(minv + 9 * v, rv, zv);
#pragma unroll
      for (int k = 0; k < 3; ++k) z[3 * v + k] = zv[k];
      rzn = rzn + (rv[0] * zv[0] + rv[1] * zv[1] + rv[2] * zv[2]);
      rrn = rrn + (rv[0] * rv[0] + rv[1] * rv[1] + rv[2] * rv[2]);
    }
    ndtpu::pg::block_sum2(&rzn, &rrn, red);
    const float beta = rzn / fmaxf(rz, 1e-30f);
    for (int v = tid; v < V; v += T) {
#pragma unroll
      for (int k = 0; k < 3; ++k)
        p[3 * v + k] = z[3 * v + k] + beta * p[3 * v + k];
    }
    rz = rzn;
    rr = rrn;
    ++it;
    __syncthreads();                          // p complete for the next y
  }

  for (int i = tid; i < 3 * V; i += T) a.x[i] = x[i];
  if (tid == 0 && !kBlocked) {
    a.iters[0] = it;
    a.zmax[0] = zm;
  }
}

// Each kernel's shared-memory limit, raised once per larger size.
size_t g_smem_opt_in = 48 * 1024;
size_t g_smem_opt_in_blocked = 48 * 1024;

bool bad_shape(int n_pose, int n_fac, int n_pri, int threads) {
  return n_pose < 1 || n_fac < 0 || n_pri < 0 || threads < 32 ||
         threads > kMaxThreads || threads % 32 != 0;
}

}  // namespace

extern "C" int pcg_solve_launch(
    const void* bet_i, const void* bet_j, const void* bet_mask, int n_fac,
    const void* prior_idx, const void* prior_mask, int n_pri,
    const void* pose_mask, int n_pose, const void* ai, const void* aj,
    const void* r, const void* ap, const void* rp, const void* rhs,
    const void* lam, float lam_value, float damp_abs, int max_iter,
    float tol, void* x, void* iters, void* zmax, int threads, void* stream) {
  if (bad_shape(n_pose, n_fac, n_pri, threads))
    return (int)cudaErrorInvalidValue;
  const size_t smem = pcg_smem(n_pose, n_fac, n_pri);
  const int err = ndtpu::pg::smem_opt_in(pcg_solve_kernel<false>, smem,
                                         &g_smem_opt_in);
  if (err != 0) return err;
  const PcgArgs a{(const long long*)bet_i, (const long long*)bet_j,
                  (const uint8_t*)bet_mask, n_fac,
                  (const long long*)prior_idx, (const uint8_t*)prior_mask,
                  n_pri, (const uint8_t*)pose_mask, n_pose, (const float*)ai,
                  (const float*)aj, (const float*)r, (const float*)ap,
                  (const float*)rp, (const float*)rhs, (const float*)lam,
                  lam_value, damp_abs, max_iter, tol, (float*)x, (int*)iters,
                  (float*)zmax};
  pcg_solve_kernel<false><<<1, threads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// K6b: n_sessions blocks; n_pose, n_fac and n_pri are per session, lam is
// [n_sessions], rhs null means -gradient.
extern "C" int pcg_solve_blocked_launch(
    const void* bet_i, const void* bet_j, const void* bet_mask, int n_fac,
    const void* prior_idx, const void* prior_mask, int n_pri,
    const void* pose_mask, int n_pose, const void* ai, const void* aj,
    const void* r, const void* ap, const void* rp, const void* rhs,
    const void* lam, int max_iter, void* x, int n_sessions, int threads,
    void* stream) {
  if (bad_shape(n_pose, n_fac, n_pri, threads) || n_sessions < 1 ||
      lam == nullptr)
    return (int)cudaErrorInvalidValue;
  const size_t smem = pcg_smem(n_pose, n_fac, n_pri);
  const int err = ndtpu::pg::smem_opt_in(pcg_solve_kernel<true>, smem,
                                         &g_smem_opt_in_blocked);
  if (err != 0) return err;
  const PcgArgs a{(const long long*)bet_i, (const long long*)bet_j,
                  (const uint8_t*)bet_mask, n_fac,
                  (const long long*)prior_idx, (const uint8_t*)prior_mask,
                  n_pri, (const uint8_t*)pose_mask, n_pose, (const float*)ai,
                  (const float*)aj, (const float*)r, (const float*)ap,
                  (const float*)rp, (const float*)rhs, (const float*)lam,
                  0.f, 0.f, max_iter, 0.f, (float*)x, nullptr, nullptr};
  pcg_solve_kernel<true><<<n_sessions, threads, smem, (cudaStream_t)stream>>>(
      a);
  return (int)cudaGetLastError();
}
