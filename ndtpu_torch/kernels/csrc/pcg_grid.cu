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
// owns poses t, t + 256 G, ...; every per-pose quantity but z and p is
// read only by its owner. The set-up's phases are separated by
// grid.sync(), the loop's by rounds of tagged partials.
//   1. Set-up (five syncs): zero the counts; count each pose's live
//      factor sides and priors with global integer atomics; scan (each
//      block its chunk of poses, then every block adds the totals of the
//      blocks before it); fill the incidence lists with atomics; then each
//      owner sorts its list by (factor, side), priors last, so the order is
//      fixed whatever order the atomics ran in, notes each place's other
//      endpoint, and forms its diagonal block, gradient, damping (lam read
//      through a pointer), _inv3, r, z, p and x = 0, and its partials of
//      r.z, r.r and max |z|.
//   2. The loop, to max_iter or JAX's stop |r|^2 <= (tol |rhs|)^2, two
//      grid-wide syncs an iteration, each one round of tagged partials
//      (put_tagged / tagged_sum below) in place of a grid.sync():
//      (A) each owner forms its pose's new direction p = z + beta p_old
//          (p = z before the first iteration) and, for each place of its
//          sorted list, the factor's y_f = A_i p_i + A_j p_j itself, the
//          other endpoint's p formed the same way from its z and p_old: the
//          same expressions, so the same bits, whoever forms them. It sums
//          A_f^T y_f over its list in list order (no float atomics; a
//          prior's at its own p), adds damp * p, writes q and its new p,
//          and its partial of p.q. p is double-buffered: an iteration
//          writes one buffer while every owner reads p_old from the other.
//          Sync.
//      (B) alpha; x, r, z and the partials of r.z and r.r. Sync. Then
//          beta and the stop test, in every thread.
//      A list's places are read four at a time, every load of a group
//      issued before its sums. Where every thread owns at most one pose
//      (G x 256 >= V: up to ~67,500 poses on an H100 at this kernel's
//      two co-resident blocks per SM), the owner keeps its
//      pose's state in registers through the loop (its list's bounds and
//      first four places, damping, M^-1, x, r, z, p and q), so (A) reads
//      only the other endpoints' z, p_old and blocks, and (B) reads
//      nothing. At 10k poses on an H100 the general loop takes ~10.7 us
//      an iteration and this path ~7.5 (profile_port.py --hot, the two
//      in turns), the same bits.
// Reductions in a fixed order: each block reduces its threads in a fixed
// tree (pose_graph.cuh) into its own slot of the partials; after the sync
// a warp of every block adds all G slots in the same order (lanes
// strided, then an xor butterfly, whose every step adds the same two
// values in each lane) and hands the sum to its block. So every thread
// holds the same alpha, beta and |r|^2, and every block takes the same
// stop decision; a block that stopped alone would hang the others' next
// wait. Each reduction has its own slots, each read by every block before
// that block writes the next phase's, which their next writer waits for.
// Data another block wrote during the launch is read with __ldcg (L2, not
// a stale L1 line). x, the iteration count and max
// |z_0| are the same on every launch, and the same bits as the four-sync
// loop this design replaced (y_f, alpha and beta by the same expressions
// and sums).
//
// What bounds it on Hopper: for the bound (the inputs read once, x written
// once, ~69 f32 operations per live factor and ~57 per pose an iteration),
// the operations: ~0.004 ms for 207 iterations at 10k poses. Its own
// traffic per iteration (each live factor's Ai and Aj read by both owners,
// the other endpoints' z and p_old, the incidence entries, each pose's
// M^-1, damping, x, r, z, p and q; ~3 MB at 10k) would take ~1 us at HBM
// rate and mostly stays in L2. In practice the grid-wide syncs, each a
// round trip through L2 for every block, and each owner's chain of
// dependent loads set the pace: two syncs an iteration, each one round
// trip of tagged partials, where the design before had four grid.sync()
// calls and a read of the partials after each.

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
  // Scratch (the wrapper's torch.empty): 64-bit words tag [3, G]; floats
  // part [3, G], res, z [V, 3], p [2, V, 3], q, damp [V, 3], minv [V, 9];
  // ints off [V + 1], cnt [V], ent [2F + P], oth [2F + P], tot [G].
  unsigned long long* tag;
  float* part;
  float* res;
  float* z;
  float* p;
  float* q;
  float* damp;
  float* minv;
  int* off;
  int* cnt;
  int* ent;
  int* oth;
  int* tot;
};

// The scratch layout, in floats and in ints (the wrapper sizes it so).
inline size_t scratch_floats(int v, int g) {
  return 27 * (size_t)v + 9 * (size_t)g;
}
inline size_t scratch_ints(int v, int f, int p, int g) {
  return 2 * (size_t)v + 1 + 2 * (2 * (size_t)f + (size_t)p) + (size_t)g;
}

// A tag no iteration has: every slot holds it until its first write.
constexpr unsigned kNoTag = 0xffffffffu;

// A list place's group size in the loop: its loads are issued together.
constexpr int kGroup = 4;

// The sum (or NaN-keeping max) of the G block partials, the same bits in
// every thread of the grid (see the header).
__device__ __forceinline__ float grid_sum(const float* part, int g) {
  float s = 0.f;
  for (int k = threadIdx.x & 31; k < g; k += 32) s = s + __ldcg(part + k);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s = s + __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

// The loop's reductions travel as tagged words: a block's partial in the
// low half of a 64-bit word, the iteration in the high half, stored by
// thread 0 with release semantics after the block's barrier, so the
// block's writes of the phase (z, p) are visible before it. A reader that
// sees the iteration's tag in every block's word (relaxed polls, then an
// acquire fence) has every partial and every block's writes: one round
// trip both synchronizes the grid and gathers the partials, where
// grid.sync() and a read of the slots took two or more.
__device__ __forceinline__ void put_tagged(unsigned long long* slot, float v,
                                           int it) {
  const unsigned long long w =
      ((unsigned long long)(unsigned)it << 32) | __float_as_uint(v);
  asm volatile("st.release.gpu.global.u64 [%0], %1;"
               :: "l"(slot), "l"(w) : "memory");
}

// The same word without release: for a partial stored just before a
// released one, which orders it (its reader spins on its tag).
__device__ __forceinline__ void put_tagged_relaxed(unsigned long long* slot,
                                                   float v, int it) {
  const unsigned long long w =
      ((unsigned long long)(unsigned)it << 32) | __float_as_uint(v);
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;"
               :: "l"(slot), "l"(w) : "memory");
}

// Warp 0: waits for the G blocks' words of iteration it and sums their
// values in grid_sum's order (the same bits in every lane); relaxed polls,
// then one acquire fence (acquire_grid) once every word is in. A word that
// never comes (a fault: every block runs the same iterations) ends the
// launch with an error after 2^24 polls (seconds) instead of hanging the
// card.
__device__ __forceinline__ float tagged_sum(const unsigned long long* slot,
                                            int g, int it) {
  float s = 0.f;
  for (int k = threadIdx.x & 31; k < g; k += 32) {
    unsigned long long w;
    unsigned polls = 0;
    do {
      asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
                   : "=l"(w) : "l"(slot + k) : "memory");
      if (++polls == (1u << 24)) __trap();
    } while ((unsigned)(w >> 32) != (unsigned)it);
    s = s + __uint_as_float((unsigned)w);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s = s + __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

// After the polls: the other blocks' writes before their released words
// are visible to this block (with the barrier that follows).
__device__ __forceinline__ void acquire_grid() {
  asm volatile("fence.acq_rel.gpu;" ::: "memory");
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

// One group of a pose's sorted list in the loop: adds A_f^T y_f of each
// place (key[m] < 0: past the list) to acc in list order, y_f = A_i p_i +
// A_j p_j with the pose's own direction pv and the other endpoint's
// formed by dir (a prior's: A_p^T A_p pv). Every load of the group is
// issued before its sums.
template <class Dir>
__device__ __forceinline__ void list_group(const GridArgs& a, const int* key,
                                           const int* oth, const float pv[3],
                                           Dir dir, float acc[3]) {
  const int two_f = 2 * a.n_fac;
  float po[kGroup][3];
#pragma unroll
  for (int m = 0; m < kGroup; ++m)
    if (key[m] >= 0 && key[m] < two_f) dir(oth[m], po[m]);
#pragma unroll
  for (int m = 0; m < kGroup; ++m) {
    if (key[m] < 0) continue;
    float yy[3], t3[3];
    const float* am;
    if (key[m] >= two_f) {
      am = a.ap + 9 * (size_t)(key[m] - two_f);
      ndtpu::pg::mv3(am, pv, yy);
    } else {
      const int f = key[m] >> 1;
      const bool side_j = key[m] & 1;
      const float* ai = a.ai + 9 * (size_t)f;
      const float* aj = a.aj + 9 * (size_t)f;
      float pi[3], pj[3], u[3], w[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        pi[k] = side_j ? po[m][k] : pv[k];
        pj[k] = side_j ? pv[k] : po[m][k];
      }
      ndtpu::pg::mv3(ai, pi, u);
      ndtpu::pg::mv3(aj, pj, w);
#pragma unroll
      for (int k = 0; k < 3; ++k) yy[k] = u[k] + w[k];
      am = side_j ? aj : ai;
    }
    ndtpu::pg::mtv3(am, yy, t3);
#pragma unroll
    for (int k = 0; k < 3; ++k) acc[k] = acc[k] + t3[k];
  }
}

// Places [g0, min(g0 + kGroup, e1)) of a list, read from the scratch.
__device__ __forceinline__ void load_group(const GridArgs& a, int g0, int e1,
                                           int key[kGroup], int oth[kGroup]) {
#pragma unroll
  for (int m = 0; m < kGroup; ++m) {
    const bool in = g0 + m < e1;
    key[m] = in ? __ldcg(a.ent + g0 + m) : -1;
    oth[m] = in ? __ldcg(a.oth + g0 + m) : 0;
  }
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
  unsigned long long* const pq_tag = a.tag;
  unsigned long long* const rz_tag = a.tag + G;
  unsigned long long* const rr_tag = a.tag + 2 * G;

  // 1a. Incidence counts of the live factors and priors; no slot tagged.
  for (int v = gt; v < V; v += gs) a.cnt[v] = 0;
  if (tid < 3) a.tag[tid * G + b] = (unsigned long long)kNoTag << 32;
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
  // M^-1, r, z, p and x. Where every thread owns at most one pose (keep),
  // its state stays in registers through the loop: its list's bounds and
  // first places, damping, M^-1, x, r, z, its direction and q.
  const float lam = a.lam != nullptr ? *a.lam : a.lam_value;
  const bool keep = gs >= V;
  float kx[3] = {0.f, 0.f, 0.f}, kr[3] = {0.f, 0.f, 0.f};
  float kz[3] = {0.f, 0.f, 0.f}, kp[3] = {0.f, 0.f, 0.f};
  float kq[3] = {0.f, 0.f, 0.f}, kd[3] = {0.f, 0.f, 0.f};
  float km[9] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  int ke0 = 0, ke1 = 0, kkey[kGroup], koth[kGroup];
#pragma unroll
  for (int m = 0; m < kGroup; ++m) {
    kkey[m] = -1;
    koth[m] = 0;
  }
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
      const int key = __ldcg(a.ent + e);
      const float* am = entry_a(a, key, &row, &prior);
      // The place's other endpoint (a prior's: the pose itself).
      a.oth[e] = prior ? v : (int)((key & 1) ? a.bet_i[row] : a.bet_j[row]);
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
    if (keep) {
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        kr[k] = rv[k];
        kz[k] = zv[k];
        kp[k] = zv[k];
        kd[k] = a.damp[3 * v + k];
      }
#pragma unroll
      for (int k = 0; k < 9; ++k) km[k] = mi[k];
      ke0 = e0;
      ke1 = e1;
      load_group(a, e0, e1, kkey, koth);
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

  // 2. The loop. p_it lives in buffer it & 1 (p_0 = z_0 in buffer 0, as
  // the set-up wrote it); p_old is the other buffer.
  float* const p0 = a.p;
  float* const p1 = a.p + 3 * (size_t)V;
  float beta = 0.f;
  int it = 0;
  while (it < a.max_iter && rr > tol2) {
    const float* const pold = (it & 1) ? p0 : p1;
    float* const pnew = (it & 1) ? p1 : p0;
    // Pose u's direction p_it, by the expression the four-sync loop used.
    auto dir = [&](int u, float out[3]) {
      if (it == 0) {
        load3(p0 + 3 * (size_t)u, out);
        return;
      }
#pragma unroll
      for (int k = 0; k < 3; ++k)
        out[k] = __ldcg(a.z + 3 * (size_t)u + k)
                 + beta * __ldcg(pold + 3 * (size_t)u + k);
    };
    // (A) q = (H + damping) p over each owner's sorted list, y_f formed
    // by the owner.
    float pq = 0.f;
    if (keep) {
      if (gt < V) {
        float pv[3], acc[3] = {0.f, 0.f, 0.f};
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          pv[k] = it == 0 ? kp[k] : kz[k] + beta * kp[k];
          if (it > 0) pnew[3 * (size_t)gt + k] = pv[k];
        }
        list_group(a, kkey, koth, pv, dir, acc);
        for (int g0 = ke0 + kGroup; g0 < ke1; g0 += kGroup) {
          int key[kGroup], oth[kGroup];
          load_group(a, g0, ke1, key, oth);
          list_group(a, key, oth, pv, dir, acc);
        }
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          kq[k] = acc[k] + kd[k] * pv[k];
          kp[k] = pv[k];
        }
        pq = pq + (pv[0] * kq[0] + pv[1] * kq[1] + pv[2] * kq[2]);
      }
    } else {
      for (int v = gt; v < V; v += gs) {
        float pv[3], acc[3] = {0.f, 0.f, 0.f};
        dir(v, pv);
        if (it > 0) {
#pragma unroll
          for (int k = 0; k < 3; ++k) pnew[3 * (size_t)v + k] = pv[k];
        }
        const int e0 = __ldcg(a.off + v), e1 = __ldcg(a.off + v + 1);
        for (int g0 = e0; g0 < e1; g0 += kGroup) {
          int key[kGroup], oth[kGroup];
          load_group(a, g0, e1, key, oth);
          list_group(a, key, oth, pv, dir, acc);
        }
        float qv[3];
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          qv[k] = acc[k] + a.damp[3 * v + k] * pv[k];
          a.q[3 * v + k] = qv[k];
        }
        pq = pq + (pv[0] * qv[0] + pv[1] * qv[1] + pv[2] * qv[2]);
      }
    }
    pq = ndtpu::pg::block_tree_w0<false>(pq, red);
    if (tid == 0) put_tagged(pq_tag + b, pq, it);
    if (tid < 32) {                          // the grid's sync and p.q
      pq = tagged_sum(pq_tag, G, it);
      acquire_grid();
      if (tid == 0) red[64] = pq;
    }
    __syncthreads();
    // (B) alpha; x, r, z; the partials of r.z and r.r.
    const float alpha = rz / fmaxf(red[64], 1e-30f);
    float rzn = 0.f, rrn = 0.f;
    if (keep) {
      if (gt < V) {
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          kx[k] = kx[k] + alpha * kp[k];
          kr[k] = kr[k] - alpha * kq[k];
        }
        ndtpu::pg::mv3(km, kr, kz);
#pragma unroll
        for (int k = 0; k < 3; ++k) a.z[3 * (size_t)gt + k] = kz[k];
        rzn = rzn + (kr[0] * kz[0] + kr[1] * kz[1] + kr[2] * kz[2]);
        rrn = rrn + (kr[0] * kr[0] + kr[1] * kr[1] + kr[2] * kr[2]);
      }
    } else {
      for (int v = gt; v < V; v += gs) {
        float rv[3], zv[3];
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          a.x[3 * v + k] = a.x[3 * v + k]
                           + alpha * __ldcg(pnew + 3 * (size_t)v + k);
          rv[k] = a.res[3 * v + k] - alpha * a.q[3 * v + k];
          a.res[3 * v + k] = rv[k];
        }
        ndtpu::pg::mv3(a.minv + 9 * (size_t)v, rv, zv);
#pragma unroll
        for (int k = 0; k < 3; ++k) a.z[3 * v + k] = zv[k];
        rzn = rzn + (rv[0] * zv[0] + rv[1] * zv[1] + rv[2] * zv[2]);
        rrn = rrn + (rv[0] * rv[0] + rv[1] * rv[1] + rv[2] * rv[2]);
      }
    }
    ndtpu::pg::block_tree2_w0<false, false>(&rzn, &rrn, red);
    if (tid == 0) {
      put_tagged_relaxed(rr_tag + b, rrn, it);
      put_tagged(rz_tag + b, rzn, it);
    }
    if (tid < 32) {                  // the grid's sync (z complete), r.z, r.r
      rzn = tagged_sum(rz_tag, G, it);
      rrn = tagged_sum(rr_tag, G, it);
      acquire_grid();
      if (tid == 0) {
        red[64] = rzn;
        red[65] = rrn;
      }
    }
    __syncthreads();
    rzn = red[64];
    rrn = red[65];
    beta = rzn / fmaxf(rz, 1e-30f);
    rz = rzn;
    rr = rrn;
    ++it;
  }
  if (keep && gt < V) {
#pragma unroll
    for (int k = 0; k < 3; ++k) a.x[3 * gt + k] = kx[k];
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
  sizes[1] = (long long)scratch_floats(n_pose, blocks);
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
  const size_t v = n_pose, g = blocks, ent = 2 * (size_t)n_fac + n_pri;
  float* fs = (float*)fscratch;
  int* is = (int*)iscratch;
  GridArgs a{(const long long*)bet_i, (const long long*)bet_j,
             (const uint8_t*)bet_mask, n_fac, (const long long*)prior_idx,
             (const uint8_t*)prior_mask, n_pri, (const uint8_t*)pose_mask,
             n_pose, (const float*)ai, (const float*)aj, (const float*)r,
             (const float*)ap, (const float*)rp, (const float*)rhs,
             (const float*)lam, lam_value, damp_abs, max_iter, tol,
             (float*)x, (int*)iters, (float*)zmax,
             (unsigned long long*)fs, fs + 6 * g, fs + 9 * g,
             fs + 9 * g + 3 * v, fs + 9 * g + 6 * v, fs + 9 * g + 12 * v,
             fs + 9 * g + 15 * v, fs + 9 * g + 18 * v,
             is, is + v + 1, is + 2 * v + 1, is + 2 * v + 1 + ent,
             is + 2 * v + 1 + 2 * ent};
  void* params[] = {&a};
  return (int)cudaLaunchCooperativeKernel(
      (const void*)pcg_grid_kernel, dim3(blocks), dim3(kThreads), params, 0,
      (cudaStream_t)stream);
}
