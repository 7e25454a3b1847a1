// K6g: K6's PCG solve of (H + damping) x = rhs, matrix free, in one
// cooperative launch across many SMs, for graphs past one block's shared
// memory (config 4's 10k poses, config 5's merged graph, the 10k-pose
// smoother of bench.py §5).
//
// Replaces what XLA lowered for the TPU from ndtpu/graph/solve.py::pcg_rhs
// (:167, its lax.while_loop :194-211) with hessian_matvec (:79), gradient
// (:99), block_diag_hessian (:110) and _inv3 (:121), as pcg (:158),
// optimize(method="pcg") (:279), incremental_update's global take and
// marginal_covariance_pcg (ndtpu/graph/incremental.py:65, :447) call it;
// and the settled check's preconditioned gradient (incremental.py:399-414),
// the same set-up run with 0 iterations, its max |z_0| written beside x.
//
// It computes exactly what K6 (pcg_solve.cu) computes, with the same
// arguments and outputs, but keeps nothing of the graph in shared memory:
// every per-pose and per-factor array is global scratch the wrapper
// allocates, so the size is bounded by device memory only. The grid is
// G blocks of 256 threads, all co-resident (cudaLaunchCooperativeKernel;
// G = min(ceil(V / 256), the co-resident block count) is a function of V,
// so a solve sums in the same order on every launch). Global thread t
// owns poses t, t + 256 G, ...; every per-pose quantity but p is read only
// by its owner. Phases are separated by grid.sync().
//   1. Set-up (five syncs): zero the counts; count each pose's live
//      factor sides and priors with global integer atomics; scan (each
//      block its chunk of poses, then every block adds the totals of the
//      blocks before it); fill the incidence lists with atomics; then each
//      owner sorts its list by (factor, side), priors last, so the order is
//      fixed whatever order the atomics ran in, and forms its diagonal
//      block, gradient, damping (lam read through a pointer), _inv3, r, z,
//      p and x = 0, and its partials of r.z, r.r and max |z|.
//   2. The loop, to max_iter or JAX's stop |r|^2 <= (tol |rhs|)^2, four
//      syncs an iteration: y_f = Ai p_i + Aj p_j for the live factors;
//      each owner sums A_f^T y_f over its sorted list (no float atomics),
//      adds the priors and damp * p, and its partial of p.q; x, r, z and
//      the partials of r.z and r.r; p = z + beta p.
// Reductions in a fixed order: each block reduces its threads in a fixed
// tree (pose_graph.cuh) into its own slot of the partials; after the sync
// every warp of every block adds all G slots in the same order (lanes
// strided, then an xor butterfly, whose every step adds the same two
// values in each lane). So every thread holds the same alpha, beta and
// |r|^2, and every block takes the same stop decision; a block that
// stopped alone would hang the next grid.sync. Each reduction has its own
// slots, rewritten only after two more syncs, when every block has read
// them. Data another block wrote during the launch is read with __ldcg
// (L2, not a stale L1 line). x and the iteration count are the same on
// every launch.
//
// What bounds it on Hopper: for the bound (the inputs read once, x written
// once, ~69 f32 operations per live factor and ~57 per pose an iteration),
// the operations: ~0.004 ms for 207 iterations at 10k poses. Its own
// traffic per iteration (the live factors' Ai, Aj and y, the incidence
// entries, each pose's M^-1, damping, x, r, z, p and q; ~2 MB at 10k)
// would take ~0.6 us at HBM rate and mostly stays in L2. In practice the
// four grid-wide barriers an iteration, each a round trip through L2 for
// every block, set the pace (~12 us an iteration at 10k on the H100). A
// faster design (fewer syncs, thread-block clusters) is later work.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "pose_graph.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;

struct GridArgs {
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
  const float* lam;    // [], or null: lam_value
  float lam_value;
  float damp_abs;
  int max_iter;
  float tol;
  float* x;            // [V, 3]
  int* iters;          // []
  float* zmax;         // []
  // Scratch (the wrapper's torch.empty): floats res, z, p, q, damp [V, 3],
  // minv [V, 9], y [F, 3], part [6, G]; ints off [V + 1], cnt [V],
  // ent [2F + P], tot [G].
  float* res;
  float* z;
  float* p;
  float* q;
  float* damp;
  float* minv;
  float* y;
  float* part;
  int* off;
  int* cnt;
  int* ent;
  int* tot;
};

// The scratch layout, in floats and in ints (the wrapper sizes it so).
inline size_t scratch_floats(int v, int f, int g) {
  return 24 * (size_t)v + 3 * (size_t)f + 6 * (size_t)g;
}
inline size_t scratch_ints(int v, int f, int p, int g) {
  return 2 * (size_t)v + 1 + 2 * (size_t)f + (size_t)p + (size_t)g;
}

// The sum (or NaN-keeping max) of the G block partials, the same bits in
// every thread of the grid (see the header).
__device__ __forceinline__ float grid_sum(const float* part, int g) {
  float s = 0.f;
  for (int k = threadIdx.x & 31; k < g; k += 32) s = s + __ldcg(part + k);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s = s + __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

__device__ __forceinline__ float grid_nanmax(const float* part, int g) {
  float s = 0.f;
  for (int k = threadIdx.x & 31; k < g; k += 32)
    s = ndtpu::pg::nanmax(s, __ldcg(part + k));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    s = ndtpu::pg::nanmax(s, __shfl_xor_sync(0xffffffffu, s, o));
  return s;
}

__device__ __forceinline__ const float* entry_a(const GridArgs& a, int e,
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

__device__ __forceinline__ void load3(const float* src, float out[3]) {
#pragma unroll
  for (int k = 0; k < 3; ++k) out[k] = __ldcg(src + k);
}

__global__ void __launch_bounds__(kThreads)
pcg_grid_kernel(const GridArgs a) {
  __shared__ float red[66];
  __shared__ int scr[33];
  cg::grid_group grid = cg::this_grid();
  const int V = a.n_pose, F = a.n_fac, P = a.n_pri;
  const int G = gridDim.x, T = blockDim.x, b = blockIdx.x;
  const int tid = threadIdx.x;
  const int gt = b * T + tid, gs = G * T;
  float* const pq_part = a.part + 3 * G;
  float* const rz_part = a.part + 4 * G;
  float* const rr_part = a.part + 5 * G;

  // 1a. Incidence counts of the live factors and priors.
  for (int v = gt; v < V; v += gs) a.cnt[v] = 0;
  grid.sync();
  for (int f = gt; f < F; f += gs) {
    if (!a.bet_mask[f]) continue;
    atomicAdd(a.cnt + a.bet_i[f], 1);
    atomicAdd(a.cnt + a.bet_j[f], 1);
  }
  for (int k = gt; k < P; k += gs)
    if (a.prior_mask[k]) atomicAdd(a.cnt + a.prior_idx[k], 1);
  grid.sync();

  // 1b. Offsets: block b scans its chunk of poses, thread by thread, then
  // adds the totals of the blocks before it.
  const int chunk = (V + G - 1) / G;
  const int bv0 = min(b * chunk, V), bv1 = min(bv0 + chunk, V);
  const int sub = (bv1 - bv0 + T - 1) / T;
  const int v0 = min(bv0 + tid * sub, bv1), v1 = min(v0 + sub, bv1);
  int mine = 0;
  for (int v = v0; v < v1; ++v) mine += __ldcg(a.cnt + v);
  int total;
  int base = ndtpu::pg::block_exclusive_scan(mine, &total, scr);
  if (tid == 0) a.tot[b] = total;
  grid.sync();
  int all = 0;
  for (int k = 0; k < G; ++k) {
    const int t = __ldcg(a.tot + k);
    if (k < b) base += t;
    all += t;
  }
  for (int v = v0; v < v1; ++v) {
    const int c = __ldcg(a.cnt + v);
    a.off[v] = base;
    base += c;
    a.cnt[v] = 0;
  }
  if (gt == 0) a.off[V] = all;
  grid.sync();

  // 1c. Fill (sorted per owner below).
  for (int f = gt; f < F; f += gs) {
    if (!a.bet_mask[f]) continue;
    const long long i = a.bet_i[f], j = a.bet_j[f];
    a.ent[__ldcg(a.off + i) + atomicAdd(a.cnt + i, 1)] = 2 * f;
    a.ent[__ldcg(a.off + j) + atomicAdd(a.cnt + j, 1)] = 2 * f + 1;
  }
  for (int k = gt; k < P; k += gs) {
    if (!a.prior_mask[k]) continue;
    const long long i = a.prior_idx[k];
    a.ent[__ldcg(a.off + i) + atomicAdd(a.cnt + i, 1)] = 2 * F + k;
  }
  grid.sync();

  // 1d. Per owned pose: sort its list, diagonal block, gradient, damping,
  // M^-1, r, z, p and x.
  const float lam = a.lam != nullptr ? *a.lam : a.lam_value;
  float rz = 0.f, bb = 0.f, zm = 0.f;
  for (int v = gt; v < V; v += gs) {
    const int e0 = __ldcg(a.off + v), e1 = __ldcg(a.off + v + 1);
    for (int e = e0 + 1; e < e1; ++e) {       // insertion sort
      const int key = __ldcg(a.ent + e);
      int k = e - 1;
      while (k >= e0 && __ldcg(a.ent + k) > key) {
        a.ent[k + 1] = __ldcg(a.ent + k);
        --k;
      }
      a.ent[k + 1] = key;
    }
    float d[9] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    float g[3] = {0.f, 0.f, 0.f};
    for (int e = e0; e < e1; ++e) {
      int row;
      bool prior;
      const float* am = entry_a(a, __ldcg(a.ent + e), &row, &prior);
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
      a.damp[3 * v + k] = dk;
      d[4 * k] = d[4 * k] + dk;
    }
    float mi[9];
    ndtpu::pg::inv3(d, mi);
#pragma unroll
    for (int k = 0; k < 9; ++k) a.minv[9 * (size_t)v + k] = mi[k];
    float rv[3], zv[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      rv[k] = a.rhs != nullptr ? a.rhs[3 * (size_t)v + k] : -g[k];
      a.x[3 * v + k] = 0.f;
      a.res[3 * v + k] = rv[k];
    }
    ndtpu::pg::mv3(mi, rv, zv);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      a.z[3 * v + k] = zv[k];
      a.p[3 * v + k] = zv[k];
      zm = ndtpu::pg::nanmax(zm, fabsf(zv[k]));
    }
    rz = rz + (rv[0] * zv[0] + rv[1] * zv[1] + rv[2] * zv[2]);
    bb = bb + (rv[0] * rv[0] + rv[1] * rv[1] + rv[2] * rv[2]);
  }
  ndtpu::pg::block_sum2(&rz, &bb, red);
  zm = ndtpu::pg::block_nanmax(zm, red);
  if (tid == 0) {
    a.part[b] = rz;
    a.part[G + b] = bb;
    a.part[2 * G + b] = zm;
  }
  grid.sync();                                // also publishes p
  rz = grid_sum(a.part, G);
  bb = grid_sum(a.part + G, G);
  zm = grid_nanmax(a.part + 2 * G, G);
  const float bn = fmaxf(sqrtf(bb), 1e-30f);
  const float tol2 = (a.tol * bn) * (a.tol * bn);
  float rr = bb;

  // 2. The loop.
  int it = 0;
  while (it < a.max_iter && rr > tol2) {
    for (int f = gt; f < F; f += gs) {
      if (!a.bet_mask[f]) continue;
      float pi[3], pj[3], u[3], w[3];
      load3(a.p + 3 * a.bet_i[f], pi);
      load3(a.p + 3 * a.bet_j[f], pj);
      ndtpu::pg::mv3(a.ai + 9 * (size_t)f, pi, u);
      ndtpu::pg::mv3(a.aj + 9 * (size_t)f, pj, w);
#pragma unroll
      for (int k = 0; k < 3; ++k) a.y[3 * (size_t)f + k] = u[k] + w[k];
    }
    grid.sync();
    float pq = 0.f;
    for (int v = gt; v < V; v += gs) {
      float acc[3] = {0.f, 0.f, 0.f}, pv[3];
      load3(a.p + 3 * v, pv);
      const int e1 = __ldcg(a.off + v + 1);
      for (int e = __ldcg(a.off + v); e < e1; ++e) {
        int row;
        bool prior;
        const float* am = entry_a(a, __ldcg(a.ent + e), &row, &prior);
        float yy[3], t3[3];
        if (prior) {
          ndtpu::pg::mv3(am, pv, yy);
        } else {
          load3(a.y + 3 * (size_t)row, yy);
        }
        ndtpu::pg::mtv3(am, yy, t3);
#pragma unroll
        for (int k = 0; k < 3; ++k) acc[k] = acc[k] + t3[k];
      }
      float qv[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        qv[k] = acc[k] + a.damp[3 * v + k] * pv[k];
        a.q[3 * v + k] = qv[k];
      }
      pq = pq + (pv[0] * qv[0] + pv[1] * qv[1] + pv[2] * qv[2]);
    }
    pq = ndtpu::pg::block_sum(pq, red);
    if (tid == 0) pq_part[b] = pq;
    grid.sync();
    const float alpha = rz / fmaxf(grid_sum(pq_part, G), 1e-30f);
    float rzn = 0.f, rrn = 0.f;
    for (int v = gt; v < V; v += gs) {
      float rv[3], zv[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        a.x[3 * v + k] = a.x[3 * v + k] + alpha * a.p[3 * v + k];
        rv[k] = a.res[3 * v + k] - alpha * a.q[3 * v + k];
        a.res[3 * v + k] = rv[k];
      }
      ndtpu::pg::mv3(a.minv + 9 * (size_t)v, rv, zv);
#pragma unroll
      for (int k = 0; k < 3; ++k) a.z[3 * v + k] = zv[k];
      rzn = rzn + (rv[0] * zv[0] + rv[1] * zv[1] + rv[2] * zv[2]);
      rrn = rrn + (rv[0] * rv[0] + rv[1] * rv[1] + rv[2] * rv[2]);
    }
    ndtpu::pg::block_sum2(&rzn, &rrn, red);
    if (tid == 0) {
      rz_part[b] = rzn;
      rr_part[b] = rrn;
    }
    grid.sync();
    rzn = grid_sum(rz_part, G);
    rrn = grid_sum(rr_part, G);
    const float beta = rzn / fmaxf(rz, 1e-30f);
    for (int v = gt; v < V; v += gs) {
#pragma unroll
      for (int k = 0; k < 3; ++k)
        a.p[3 * v + k] = a.z[3 * v + k] + beta * a.p[3 * v + k];
    }
    rz = rzn;
    rr = rrn;
    ++it;
    grid.sync();                              // p complete for the next y
  }

  if (gt == 0) {
    a.iters[0] = it;
    a.zmax[0] = zm;
  }
}

bool bad_shape(int n_pose, int n_fac, int n_pri, int blocks) {
  return n_pose < 1 || n_fac < 0 || n_pri < 0 || blocks < 1;
}

// Co-resident blocks of the kernel per device (its cooperative launch's
// limit), queried once.
constexpr int kMaxDevices = 64;
int g_capacity[kMaxDevices] = {0};

}  // namespace

// K6g's launch plan on the current device: sizes[0] the blocks (one per
// kThreads poses, capped by the co-resident count), sizes[1] and sizes[2]
// the float and int scratch the wrapper allocates.
extern "C" int pcg_grid_plan(int n_pose, int n_fac, int n_pri,
                             long long* sizes) {
  if (bad_shape(n_pose, n_fac, n_pri, 1)) return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && (dev < 0 || dev >= kMaxDevices))
    err = cudaErrorInvalidDevice;
  if (err == cudaSuccess && g_capacity[dev] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, pcg_grid_kernel, kThreads, 0);
    if (err == cudaSuccess) g_capacity[dev] = per_sm * sms;
  }
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  const int blocks = min((n_pose + kThreads - 1) / kThreads, g_capacity[dev]);
  sizes[0] = blocks;
  sizes[1] = (long long)scratch_floats(n_pose, n_fac, blocks);
  sizes[2] = (long long)scratch_ints(n_pose, n_fac, n_pri, blocks);
  return blocks < 1 ? (int)cudaErrorInvalidConfiguration : 0;
}

extern "C" int pcg_grid_launch(
    const void* bet_i, const void* bet_j, const void* bet_mask, int n_fac,
    const void* prior_idx, const void* prior_mask, int n_pri,
    const void* pose_mask, int n_pose, const void* ai, const void* aj,
    const void* r, const void* ap, const void* rp, const void* rhs,
    const void* lam, float lam_value, float damp_abs, int max_iter,
    float tol, void* x, void* iters, void* zmax, void* fscratch,
    void* iscratch, int blocks, void* stream) {
  if (bad_shape(n_pose, n_fac, n_pri, blocks))
    return (int)cudaErrorInvalidValue;
  const size_t v = n_pose, f = n_fac;
  float* fs = (float*)fscratch;
  int* is = (int*)iscratch;
  GridArgs a{(const long long*)bet_i, (const long long*)bet_j,
             (const uint8_t*)bet_mask, n_fac, (const long long*)prior_idx,
             (const uint8_t*)prior_mask, n_pri, (const uint8_t*)pose_mask,
             n_pose, (const float*)ai, (const float*)aj, (const float*)r,
             (const float*)ap, (const float*)rp, (const float*)rhs,
             (const float*)lam, lam_value, damp_abs, max_iter, tol,
             (float*)x, (int*)iters, (float*)zmax,
             fs, fs + 3 * v, fs + 6 * v, fs + 9 * v, fs + 12 * v,
             fs + 15 * v, fs + 24 * v, fs + 24 * v + 3 * f,
             is, is + v + 1, is + 2 * v + 1, is + 2 * v + 1 + 2 * f + n_pri};
  void* params[] = {&a};
  return (int)cudaLaunchCooperativeKernel(
      (const void*)pcg_grid_kernel, dim3(blocks), dim3(kThreads), params, 0,
      (cudaStream_t)stream);
}
