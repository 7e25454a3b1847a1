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
// One block of kThreads = 256 threads (fixed: no graph size or live count
// sets it, so the sums' order depends on that constant and the slot order
// alone) holds a whole solve in shared memory, and touches only the live
// work: the live factors, the live priors and the active poses.
//   1. Set-up. (a) A stable block scan compacts the live factor slots
//      (bet_mask) in slot order into lf. (b) Each pose's live incidences
//      (live factors' two sides, live priors) are counted with
//      shared-memory integer atomics, and each live factor's blocks are
//      asked into L1. (c) A second stable scan compacts the active poses
//      in slot order into act: a pose with a live incidence or a non-zero
//      right-hand side. Every other pose has no live incidence and r0 =
//      0; in the reference it stays exactly 0 in x, r, z and p and adds
//      exactly 0 to every dot product, so its x is written as 0 and it
//      takes no further part. A dead pose with a non-zero rhs is active
//      and keeps its damping's dead term. The same scan gives each active
//      pose's list offset. (d) Each list (keys 2 f + side, priors 2F + k)
//      is filled through a per-pose cursor and sorted by key, so the order
//      is fixed whatever order the atomics ran in: an owner sorts a list
//      of up to 4 entries, a warp each longer one (its lanes rank the
//      entries; a pose with many loop closures costs one pass). Each
//      factor side's list place goes to pos. (e) Each live factor's thread
//      writes its two sides' A^T A and A^T r to the scratch at their list
//      places; each owner (thread t owns active poses t, t + 256, ...)
//      sums its places in list order (a prior's terms it computes) for the
//      diagonal block and gradient, damps the block (lam read through a
//      pointer: no host read), inverts it (_inv3), and starts r = rhs (or
//      -gradient) and z = M^-1 r.
//   2. The loop, to max_iter; K6 also stops on JAX's test |r|^2 > (tol
//      |rhs|)^2, evaluated on the device. Three barriers per iteration:
//      (A) each thread takes the live factors lf[t], lf[t + 256], ...:
//          forms the new direction p = z + beta p at both ends from z and
//          the last p (beta = 0 and p = 0 before the first iteration, so
//          p = z), y = A_i p_i + A_j p_j, and writes A_i^T y and A_j^T y to
//          the scratch at the two sides' list places. Barrier.
//      (B) each owner forms its own poses' new p with the same expression
//          (so the value is bit-identical to what the factors used) and
//          sums, in list order, the A^T y of its list's first 8 places
//          (its priors among them at the new p) + damp * p; a helper
//          thread (from thread 255 down, beside the owners) each further
//          chunk of 8 places of a long list (a pose with many loop
//          closures), so no list costs more than one chunk here. Each adds its share of p.q. No float atomics: two factors
//          between one pair add in a fixed order. Warp shuffles, one
//          partial per warp. Barrier.
//      (C) every thread sums the 8 warp partials in warp order (alpha); each
//          owner adds its helpers' chunks to its q in chunk order, stores
//          the new p, and updates x, r and z and its parts of r.z and r.r.
//          Warp shuffles. Barrier. Every thread sums those partials (beta
//          and the stop test).
//      Each partial slot is written and read between two barriers that
//      every thread passes before the slot is written again, so no
//      barrier guards reuse. So x and the iteration count are the same on
//      every launch.
// A list's places are read a group at a time (8 in the loop, by the owner
// and its helpers side by side; 4 in the set-up, by the owner), every load
// of a group issued before its sums: a pose with many loop closures costs
// one round of loads per iteration, not one per place.
// Memory: pcg_smem(v, f, p) (unchanged since the first K6, so the route's
// limit stays ~1,468 poses at F = 2V) is the shared memory a graph needs;
// the launcher asks for all a block may opt in to (227 KB on Hopper). The
// layout takes at most 116 v + 14 f + 4 p + 424 B: x, r, z, p, q, the
// damping (3 floats each) and M^-1 (9) per pose slot, the list offsets,
// pos (2 per factor slot), act, lf, the list entries and each owner's
// first helper chunk as 16-bit indices (the 227 KB limit keeps 2f + p
// below 58,112), and per helper chunk (at most (2f + p) / 8) its owner and
// index and its 3 partial sums; the set-up's per-pose counts and cursors
// live in q's space. What is left holds the loop's live data when it fits
// (16 B per list place, 76 B per live factor and 36 B per prior slot:
// config 3's 97 poses and 126 factors take 13 KB): each place's A^T y,
// each live factor's A_i, A_j and poses, the priors' A, so an iteration
// touches no device memory (a copy of the loop compiled for that case
// reads them as shared memory). Where it does
// not fit (a graph near its capacity), A_i, A_j and the poses are read
// through L1 and the A^T y go through the scratch: device memory the
// wrapper allocates, 12 floats per list place (2f + p per block), written
// and read by one block, so only its own barriers order it. The set-up's
// per-place terms (48 B each) go after the loop's live data where they
// fit, else to the scratch.
// Each launcher refuses (it computes the size and returns kSmemOver; the
// wrapper raises) a graph, or for K6b a session, whose state does not fit
// one block's shared memory. Larger graphs (config 4's 10k poses, config
// 5's merged graph) go to K6g (pcg_grid.cu), the same solve across many
// SMs: graph.solve.pcg_solve routes by kernels.pcg_route, which mirrors
// pcg_smem below and the 227 KB opt-in.
//
// What bounds it on Hopper: for the bound, the bytes of one pass (the live
// linearization) and ~60 f32 operations per live factor and 30 per pose
// per iteration; in practice the chain of each iteration on one SM: three
// barriers, two rounds of warp shuffles, and the shared-memory loads of
// the factor pass and of each owner's (or helper's) places. So the block
// is no larger than the live work (on config 3's 1,024-slot graph, 97
// live poses and 126 live factors: about one factor and one pose per
// thread), a barrier ends each phase only where the next needs the
// previous one's results, each reduction is one shuffle tree and one
// barrier, and no list is walked one dependent load at a time. K6b's S
// blocks run on S SMs side by side, so S sessions take about the time of
// one.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "pose_graph.cuh"

namespace {

constexpr int kThreads = 256;              // the block, fixed
constexpr int kWarps = kThreads / 32;

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
  float4* sc;          // [2F + P, 3] float4 scratch ([S, ...] for K6b)
  int smem_bytes;      // the block's dynamic shared memory
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
  a->sc += 3 * s * (2 * f + p);
  return (long long)(s * v);
}

// Shared-memory bytes of one solve.
inline size_t pcg_smem(int v, int f, int p) {
  return 4 * (size_t)(27 * v + 3 * f + 68)
         + 4 * (size_t)(2 * v + 2 * f + p + 38) + (size_t)f;
}

// Slots of the warp partials in `red` (each kWarps floats).
constexpr int kRedRz = 0, kRedBb = 8, kRedZm = 16, kRedPq = 24, kRedRzn = 32,
              kRedRrn = 40;

// Exclusive prefix sums of two ints per thread, in thread order, with one
// barrier; `tot` gets the block's sums. `slots` is 2 kWarps ints of shared
// memory that no other scan uses.
__device__ __forceinline__ void scan2(int a, int b, int* ea, int* eb,
                                      int* ta, int* tb, int* slots) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int ia = a, ib = b;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int ua = __shfl_up_sync(0xffffffffu, ia, o);
    const int ub = __shfl_up_sync(0xffffffffu, ib, o);
    if (lane >= o) {
      ia += ua;
      ib += ub;
    }
  }
  if (lane == 31) {
    slots[warp] = ia;
    slots[kWarps + warp] = ib;
  }
  __syncthreads();
  int pa = 0, pb = 0, sa = 0, sb = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int xa = slots[w], xb = slots[kWarps + w];
    if (w < warp) {
      pa += xa;
      pb += xb;
    }
    sa += xa;
    sb += xb;
  }
  *ea = pa + ia - a;
  *eb = pb + ib - b;
  *ta = sa;
  *tb = sb;
}

// The warp partials of slot `at`, summed in warp order from 0.
__device__ __forceinline__ float warps_sum(const float* red, int at) {
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) s = s + red[at + w];
  return s;
}

// A list of more entries than this is sorted by a warp, not its owner.
constexpr int kShortList = 4;
// List places an owner reads from the scratch at once (in the set-up, three
// float4 each; in the loop, one): their loads all issued before the sums
// (a slot past the list's end reads the last place again and adds
// nothing), so a list is a few rounds of loads, not a chain of them.
constexpr int kSetupGroup = 4, kLoopGroup = 8;

__device__ __forceinline__ void insertion_sort(uint16_t* e, int n) {
  for (int i = 1; i < n; ++i) {
    const uint16_t key = e[i];
    int j = i - 1;
    while (j >= 0 && e[j] > key) {
      e[j + 1] = e[j];
      --j;
    }
    e[j + 1] = key;
  }
}

// Pose v's right-hand side is not all zero (a NaN counts as not zero).
__device__ __forceinline__ bool rhs_set(const float* rhs, int v) {
  if (rhs == nullptr) return false;
  const float* b = rhs + 3 * (size_t)v;
  return b[0] != 0.f || b[1] != 0.f || b[2] != 0.f;
}

// Ask for the line holding p in L1 (the set-up touches each live factor's
// blocks before the owners read them).
__device__ __forceinline__ void prefetch_l1(const void* p) {
  asm volatile("prefetch.global.L1 [%0];" ::"l"(p));
}

// A place's set-up terms t = (A^T A, A^T r): u's for a factor side, a
// prior's (key >= 2F) its own.
__device__ __forceinline__ void setup_terms(const PcgArgs& a, int two_f,
                                            int key, const float4 u[3],
                                            float t[12]) {
  if (key < two_f) {
    t[0] = u[0].x; t[1] = u[0].y; t[2] = u[0].z; t[3] = u[0].w;
    t[4] = u[1].x; t[5] = u[1].y; t[6] = u[1].z; t[7] = u[1].w;
    t[8] = u[2].x; t[9] = u[2].y; t[10] = u[2].z; t[11] = u[2].w;
  } else {
    const float* am = a.ap + 9 * (size_t)(key - two_f);
    ndtpu::pg::mtm3(am, am, t);
    ndtpu::pg::mtv3(am, a.rp + 3 * (size_t)(key - two_f), t + 9);
  }
}

// A place's term of q: u's A^T y for a factor side, a prior's A^T A pv.
__device__ __forceinline__ void loop_terms(const float* ap, int two_f,
                                           int key, float4 u,
                                           const float pv[3], float t[3]) {
  if (key < two_f) {
    t[0] = u.x;
    t[1] = u.y;
    t[2] = u.z;
  } else {
    const float* am = ap + 9 * (size_t)(key - two_f);
    float yy[3];
    ndtpu::pg::mv3(am, pv, yy);
    ndtpu::pg::mtv3(am, yy, t);
  }
}

// The terms of q of places [e0, e1) (at most kLoopGroup), summed in order
// into acc, their loads all issued first (a slot past e1 reads the last
// place again and adds nothing).
__device__ __forceinline__ void group_sum(const uint16_t* ent,
                                          const float4* sc, const float* ap,
                                          int two_f, int e0, int e1,
                                          const float pv[3], float acc[3]) {
  int key[kLoopGroup];
  float4 u[kLoopGroup];
#pragma unroll
  for (int l = 0; l < kLoopGroup; ++l) {
    const int el = min(e0 + l, e1 - 1);
    key[l] = ent[el];
    u[l] = sc[el];
  }
#pragma unroll
  for (int l = 0; l < kLoopGroup; ++l) {
    if (e0 + l < e1) {
      float t3[3];
      loop_terms(ap, two_f, key[l], u[l], pv, t3);
#pragma unroll
      for (int j = 0; j < 3; ++j) acc[j] = acc[j] + t3[j];
    }
  }
}

// Places past an owner's first kLoopGroup: its list's further chunks.
__device__ __forceinline__ int extra_chunks(int n) {
  return n > 0 ? (n - 1) / kLoopGroup : 0;
}

template <bool kBlocked>
__global__ void __launch_bounds__(kThreads)
pcg_solve_kernel(const PcgArgs args) {
  extern __shared__ float4 smem4[];
  PcgArgs a = args;
  const long long pose0 = kBlocked ? session_slices(&a) : 0;
  const int V = a.n_pose, F = a.n_fac, P = a.n_pri;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long* __restrict__ bet_i = a.bet_i;
  const long long* __restrict__ bet_j = a.bet_j;
  const uint8_t* __restrict__ bet_mask = a.bet_mask;
  const float* __restrict__ ai = a.ai;
  const float* __restrict__ aj = a.aj;
  const float* __restrict__ ap = a.ap;
  const float* __restrict__ rhs = a.rhs;
  float* __restrict__ x_out = a.x;
  float4* sc = a.sc;     // written and read in this launch: no __ldg
  float* x = reinterpret_cast<float*>(smem4);
  float* r = x + 3 * V;
  float* z = r + 3 * V;
  float* p = z + 3 * V;
  float* q = p + 3 * V;
  float* damp = q + 3 * V;
  float* minv = damp + 3 * V;
  uint16_t* pos = reinterpret_cast<uint16_t*>(minv + 9 * V);  // [2F]
  float* red = minv + 9 * V + F;
  const int max_chunks = (2 * F + P) / kLoopGroup;
  float* part = red + 68;                   // [max_chunks, 3]
  int* off = reinterpret_cast<int*>(part + 3 * max_chunks);
  int* scr = off + V + 1;
  uint32_t* chunk = reinterpret_cast<uint32_t*>(scr + 37);  // [max_chunks]
  uint16_t* act = reinterpret_cast<uint16_t*>(chunk + max_chunks);
  uint16_t* lf = act + V;
  uint16_t* ent = lf + F;
  uint16_t* xfirst = ent + 2 * F + P;       // [V]
  // The rest of the block's shared memory (the launcher asks for all it
  // may have) holds the loop's live data where it fits: each list
  // place's A^T y (sC, a float4 each), each live factor's A_i, A_j (sA,
  // 18 floats) and its poses i | j << 16 (sIJ).
  const int used = ((int)((char*)(xfirst + V) - (char*)smem4) + 15) & ~15;
  float4* sC = reinterpret_cast<float4*>((char*)smem4 + used);
  int* cur = reinterpret_cast<int*>(q);   // set-up only: counts, cursors,
  int* longs = cur + V;                   // the lists a warp sorts
  int* n_long = scr + 36;

  // 1a. The live factors, in slot order (each thread a contiguous chunk,
  // its mask bytes loaded together).
  const int fc = (F + kThreads - 1) / kThreads;
  const int f0 = min(tid * fc, F), f1 = min(f0 + fc, F);
  int mine = 0;
#pragma unroll 8
  for (int f = f0; f < f1; ++f) mine += __ldg(bet_mask + f) != 0;
  for (int v = tid; v < V; v += kThreads) cur[v] = 0;
  if (tid == 0) *n_long = 0;
  // Every x is 0 but the active poses', which the end overwrites (the
  // barriers between order the two writes).
  for (int i = tid; i < 3 * V; i += kThreads) x_out[i] = 0.f;
  int at, n_fac, unused0, unused1;
  scan2(mine, 0, &at, &unused0, &n_fac, &unused1, scr);
  for (int f = f0; f < f1; ++f)
    if (__ldg(bet_mask + f)) lf[at++] = (uint16_t)f;
  __syncthreads();

  // 1b. Live incidences per pose; the live factors' blocks into L1.
  for (int m = tid; m < n_fac; m += kThreads) {
    const int f = lf[m];
    prefetch_l1(ai + 9 * (size_t)f);
    prefetch_l1(aj + 9 * (size_t)f);
    prefetch_l1(a.r + 3 * (size_t)f);
    atomicAdd(cur + (int)(__ldg(bet_i + f) - pose0), 1);
    atomicAdd(cur + (int)(__ldg(bet_j + f) - pose0), 1);
  }
  for (int k = tid; k < P; k += kThreads)
    if (a.prior_mask[k]) atomicAdd(cur + (int)(a.prior_idx[k] - pose0), 1);
  __syncthreads();

  // 1c. The active poses, in slot order, with their list offsets.
  const int vc = (V + kThreads - 1) / kThreads;
  const int v0 = min(tid * vc, V), v1 = min(v0 + vc, V);
  int n_act = 0, n_inc = 0;
  for (int v = v0; v < v1; ++v) {
    const int c = cur[v];
    if (c > 0 || rhs_set(rhs, v)) {
      ++n_act;
      n_inc += c;
    }
  }
  int k_at, e_at, n_active, n_entries;
  scan2(n_act, n_inc, &k_at, &e_at, &n_active, &n_entries, scr + 2 * kWarps);
  for (int v = v0; v < v1; ++v) {
    const int c = cur[v];
    if (c > 0 || rhs_set(rhs, v)) {
      act[k_at] = (uint16_t)v;
      off[k_at++] = e_at;
      cur[v] = e_at;                // the fill's cursor
      e_at += c;
    }
  }
  if (tid == 0) off[n_active] = n_entries;
  __syncthreads();

  // 1d. Fill the lists.
  for (int m = tid; m < n_fac; m += kThreads) {
    const int f = lf[m];
    ent[atomicAdd(cur + (int)(__ldg(bet_i + f) - pose0), 1)] =
        (uint16_t)(2 * f);
    ent[atomicAdd(cur + (int)(__ldg(bet_j + f) - pose0), 1)] =
        (uint16_t)(2 * f + 1);
  }
  for (int k = tid; k < P; k += kThreads)
    if (a.prior_mask[k])
      ent[atomicAdd(cur + (int)(a.prior_idx[k] - pose0), 1)] =
          (uint16_t)(2 * F + k);
  __syncthreads();

  // 1d'. Sort each list by key: an owner its short list; a warp each
  // longer one (a pose with many loop closures), its lanes ranking the
  // entries among all of the list's (the keys of one list are distinct)
  // and writing each at its rank; past 128 entries lane 0 sorts.
  for (int k = tid; k < n_active; k += kThreads) {
    const int e0 = off[k], n = off[k + 1] - e0;
    if (n <= kShortList)
      insertion_sort(ent + e0, n);
    else
      longs[atomicAdd(n_long, 1)] = k;   // which warp sorts it: no matter
  }
  __syncthreads();
  for (int l = warp; l < *n_long; l += kWarps) {
    const int k = longs[l], e0 = off[k], n = off[k + 1] - e0;
    if (n > 4 * 32) {
      if (lane == 0) insertion_sort(ent + e0, n);
      __syncwarp();
      continue;
    }
    uint16_t key[4];
    int rank[4] = {0, 0, 0, 0};
#pragma unroll
    for (int u = 0; u < 4; ++u)
      key[u] = lane + 32 * u < n ? ent[e0 + lane + 32 * u] : 0xFFFF;
#pragma unroll 4
    for (int j = 0; j < n; ++j) {
      const uint16_t o = ent[e0 + j];
#pragma unroll
      for (int u = 0; u < 4; ++u) rank[u] += o < key[u] ? 1 : 0;
    }
    __syncwarp();
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (lane + 32 * u < n) ent[e0 + rank[u]] = key[u];
    __syncwarp();
  }
  __syncthreads();
  // Each factor side's place in the lists; the long lists' further chunks
  // (for helpers in (B)), numbered in owner order (each thread a
  // contiguous run of owners).
  for (int e = tid; e < n_entries; e += kThreads) {
    const int key = ent[e];
    if (key < 2 * F) pos[key] = (uint16_t)e;
  }
  const int kc = (n_active + kThreads - 1) / kThreads;
  const int ka = min(tid * kc, n_active), kb = min(ka + kc, n_active);
  int n_x = 0;
  for (int k = ka; k < kb; ++k) n_x += extra_chunks(off[k + 1] - off[k]);
  int x_at, n_chunks;
  scan2(n_x, 0, &x_at, &unused0, &n_chunks, &unused1, scr);
  for (int k = ka; k < kb; ++k) {
    const int nx = extra_chunks(off[k + 1] - off[k]);
    xfirst[k] = (uint16_t)x_at;
    for (int c = 1; c <= nx; ++c) chunk[x_at++] = (uint32_t)k | (c << 16);
  }
  __syncthreads();
  const bool fits =
      16 * n_entries + 76 * n_fac + 36 * P <= a.smem_bytes - used;
  float* sA = reinterpret_cast<float*>(sC + n_entries);
  float* sP = sA + 18 * n_fac;                  // the priors' A, [P, 9]
  uint32_t* sIJ = reinterpret_cast<uint32_t*>(sP + 9 * P);
  if (fits)
    for (int i = tid; i < 9 * P; i += kThreads) sP[i] = ap[i];
  // The set-up's per-place terms too, where they fit after the loop's.
  const int live_end =
      ((int)((char*)(sIJ + n_fac) - (char*)smem4) + 15) & ~15;
  float4* st = fits && 48 * n_entries <= a.smem_bytes - live_end
                   ? reinterpret_cast<float4*>((char*)smem4 + live_end)
                   : sc;

  // 1e. Each live factor's two sides' terms of the diagonal blocks and
  // the gradient (A^T A, A^T r) to the scratch at their list places; then
  // per owned active pose: its places summed in list order (a prior's
  // terms it computes) for the diagonal block and gradient, damping,
  // M^-1, r, z; p = 0 (the first direction is z + 0 p).
  for (int m = tid; m < n_fac; m += kThreads) {
    const int f = lf[m];
    const float* rf = a.r + 3 * (size_t)f;
    if (fits)
      sIJ[m] = (uint32_t)(__ldg(bet_i + f) - pose0)
               | ((uint32_t)(__ldg(bet_j + f) - pose0) << 16);
#pragma unroll
    for (int side = 0; side < 2; ++side) {
      const float* am = (side ? aj : ai) + 9 * (size_t)f;
      if (fits) {
#pragma unroll
        for (int j = 0; j < 9; ++j) sA[18 * m + 9 * side + j] = am[j];
      }
      float t9[9], t3[3];
      ndtpu::pg::mtm3(am, am, t9);
      ndtpu::pg::mtv3(am, rf, t3);
      float4* o = st + 3 * (size_t)pos[2 * f + side];
      o[0] = make_float4(t9[0], t9[1], t9[2], t9[3]);
      o[1] = make_float4(t9[4], t9[5], t9[6], t9[7]);
      o[2] = make_float4(t9[8], t3[0], t3[1], t3[2]);
    }
  }
  __syncthreads();
  const float lam = a.lam != nullptr ? *a.lam : a.lam_value;
  float rz = 0.f, bb = 0.f, zm = 0.f;
  for (int k = tid; k < n_active; k += kThreads) {
    const int v = act[k], e0 = off[k], e1 = off[k + 1];
    const float dead = a.pose_mask[v] ? 0.f : 1.f;
    float d[9] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    float g[3] = {0.f, 0.f, 0.f};
    for (int e = e0; e < e1; e += kSetupGroup) {
      int key[kSetupGroup];
      float4 u[kSetupGroup][3];
#pragma unroll
      for (int l = 0; l < kSetupGroup; ++l) {
        const int el = min(e + l, e1 - 1);
        key[l] = ent[el];
        const float4* o = st + 3 * (size_t)el;
        u[l][0] = o[0];
        u[l][1] = o[1];
        u[l][2] = o[2];
      }
#pragma unroll
      for (int l = 0; l < kSetupGroup; ++l) {
        if (e + l < e1) {
          float t[12];
          setup_terms(a, 2 * F, key[l], u[l], t);
#pragma unroll
          for (int j = 0; j < 9; ++j) d[j] = d[j] + t[j];
#pragma unroll
          for (int j = 0; j < 3; ++j) g[j] = g[j] + t[9 + j];
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float dk = lam * fmaxf(fabsf(d[4 * j]), 1e-8f)
                       + (a.damp_abs + dead);
      damp[3 * v + j] = dk;
      d[4 * j] = d[4 * j] + dk;
    }
    ndtpu::pg::inv3(d, minv + 9 * v);
    float rv[3], zv[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      rv[j] = rhs != nullptr ? rhs[3 * (size_t)v + j] : -g[j];
      x[3 * v + j] = 0.f;
      r[3 * v + j] = rv[j];
      p[3 * v + j] = 0.f;
    }
    ndtpu::pg::mv3(minv + 9 * v, rv, zv);
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      z[3 * v + j] = zv[j];
      zm = ndtpu::pg::nanmax(zm, fabsf(zv[j]));
    }
    rz = rz + (rv[0] * zv[0] + rv[1] * zv[1] + rv[2] * zv[2]);
    bb = bb + (rv[0] * rv[0] + rv[1] * rv[1] + rv[2] * rv[2]);
  }
  {
    const float wrz = ndtpu::pg::warp_sum(rz);
    const float wbb = ndtpu::pg::warp_sum(bb);
    const float wzm = ndtpu::pg::warp_nanmax(zm);
    if (lane == 0) {
      red[kRedRz + warp] = wrz;
      red[kRedBb + warp] = wbb;
      red[kRedZm + warp] = wzm;
    }
  }
  __syncthreads();
  rz = warps_sum(red, kRedRz);
  bb = warps_sum(red, kRedBb);
  zm = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) zm = ndtpu::pg::nanmax(zm, red[kRedZm + w]);
  const float bn = fmaxf(sqrtf(bb), 1e-30f);
  const float tol2 = (a.tol * bn) * (a.tol * bn);
  float rr = bb, beta = 0.f;

  // 2. The loop (K6b: no tolerance stop), in one of two copies: the live
  // data in shared memory (kLive, every address known to be shared) or
  // read through L1 and the scratch.
  int it = 0;
  auto iterate = [&](auto live) {
    constexpr bool kLive = decltype(live)::value;
    float4* cb = kLive ? sC : sc;             // the A^T y places
    const float* pa = kLive ? sP : ap;        // the priors' A
    while (it < a.max_iter && (kBlocked || rr > tol2)) {
      // (A) y at the new direction, and A_i^T y, A_j^T y to their places.
      for (int m = tid; m < n_fac; m += kThreads) {
        const int f = lf[m];
        int i, j;
        const float* am_i;
        const float* am_j;
        if (kLive) {
          const uint32_t ij = sIJ[m];
          i = (int)(ij & 0xFFFF);
          j = (int)(ij >> 16);
          am_i = sA + 18 * m;
          am_j = am_i + 9;
        } else {
          i = (int)(__ldg(bet_i + f) - pose0);
          j = (int)(__ldg(bet_j + f) - pose0);
          am_i = ai + 9 * (size_t)f;
          am_j = aj + 9 * (size_t)f;
        }
        float pi[3], pj[3], u[3], w[3], y[3], ci[3], cj[3];
  #pragma unroll
        for (int k = 0; k < 3; ++k) {
          pi[k] = z[3 * i + k] + beta * p[3 * i + k];
          pj[k] = z[3 * j + k] + beta * p[3 * j + k];
        }
        ndtpu::pg::mv3(am_i, pi, u);
        ndtpu::pg::mv3(am_j, pj, w);
  #pragma unroll
        for (int k = 0; k < 3; ++k) y[k] = u[k] + w[k];
        ndtpu::pg::mtv3(am_i, y, ci);
        ndtpu::pg::mtv3(am_j, y, cj);
        cb[pos[2 * f]] = make_float4(ci[0], ci[1], ci[2], 0.f);
        cb[pos[2 * f + 1]] = make_float4(cj[0], cj[1], cj[2], 0.f);
      }
      __syncthreads();
      // (B) q = (H + damping) p at the new p and p.q: each owner its list's
      // first kLoopGroup places, the priors among them and damp * p (into
      // q); a helper each further chunk of a long list (into part); each
      // adds its share of p.q. No thread writes p or z here.
      float pq = 0.f;
      for (int k = tid; k < n_active; k += kThreads) {
        const int v = act[k], e0 = off[k];
        const int e1 = min(off[k + 1], e0 + kLoopGroup);
        float pv[3], acc[3] = {0.f, 0.f, 0.f}, qv[3];
  #pragma unroll
        for (int j = 0; j < 3; ++j) pv[j] = z[3 * v + j] + beta * p[3 * v + j];
        if (e1 > e0) group_sum(ent, cb, pa, 2 * F, e0, e1, pv, acc);
  #pragma unroll
        for (int j = 0; j < 3; ++j) {
          qv[j] = acc[j] + damp[3 * v + j] * pv[j];
          q[3 * v + j] = qv[j];
        }
        pq = pq + (pv[0] * qv[0] + pv[1] * qv[1] + pv[2] * qv[2]);
      }
      // Helpers from the top thread down, so they run beside the owners.
      for (int c = kThreads - 1 - tid; c < n_chunks; c += kThreads) {
        const int k = chunk[c] & 0xFFFF, n = chunk[c] >> 16;
        const int v = act[k], e0 = off[k] + n * kLoopGroup;
        const int e1 = min(off[k + 1], e0 + kLoopGroup);
        float pv[3], acc[3] = {0.f, 0.f, 0.f};
  #pragma unroll
        for (int j = 0; j < 3; ++j) pv[j] = z[3 * v + j] + beta * p[3 * v + j];
        group_sum(ent, cb, pa, 2 * F, e0, e1, pv, acc);
  #pragma unroll
        for (int j = 0; j < 3; ++j) part[3 * c + j] = acc[j];
        pq = pq + (pv[0] * acc[0] + pv[1] * acc[1] + pv[2] * acc[2]);
      }
      pq = ndtpu::pg::warp_sum(pq);
      if (lane == 0) red[kRedPq + warp] = pq;
      __syncthreads();
      // (C) alpha; x, r, z and r.z, r.r.
      const float alpha = rz / fmaxf(warps_sum(red, kRedPq), 1e-30f);
      float rzn = 0.f, rrn = 0.f;
      for (int k = tid; k < n_active; k += kThreads) {
        const int v = act[k];
        const int c0 = xfirst[k], c1 = c0 + extra_chunks(off[k + 1] - off[k]);
        float pv[3], qv[3], rv[3], zv[3];
  #pragma unroll
        for (int j = 0; j < 3; ++j) {
          pv[j] = z[3 * v + j] + beta * p[3 * v + j];   // as (A) and (B) had it
          p[3 * v + j] = pv[j];
          qv[j] = q[3 * v + j];
        }
        for (int c = c0; c < c1; ++c) {        // the helpers' chunks, in order
  #pragma unroll
          for (int j = 0; j < 3; ++j) qv[j] = qv[j] + part[3 * c + j];
        }
  #pragma unroll
        for (int j = 0; j < 3; ++j) {
          x[3 * v + j] = x[3 * v + j] + alpha * pv[j];
          rv[j] = r[3 * v + j] - alpha * qv[j];
          r[3 * v + j] = rv[j];
        }
        ndtpu::pg::mv3(minv + 9 * v, rv, zv);
  #pragma unroll
        for (int j = 0; j < 3; ++j) z[3 * v + j] = zv[j];
        rzn = rzn + (rv[0] * zv[0] + rv[1] * zv[1] + rv[2] * zv[2]);
        rrn = rrn + (rv[0] * rv[0] + rv[1] * rv[1] + rv[2] * rv[2]);
      }
      rzn = ndtpu::pg::warp_sum(rzn);
      rrn = ndtpu::pg::warp_sum(rrn);
      if (lane == 0) {
        red[kRedRzn + warp] = rzn;
        red[kRedRrn + warp] = rrn;
      }
      __syncthreads();
      rzn = warps_sum(red, kRedRzn);
      beta = rzn / fmaxf(rz, 1e-30f);
      rz = rzn;
      rr = warps_sum(red, kRedRrn);
      ++it;
    }
  };
  if (fits)
    iterate(std::true_type{});
  else
    iterate(std::false_type{});

  for (int k = tid; k < n_active; k += kThreads) {
    const int v = act[k];
#pragma unroll
    for (int j = 0; j < 3; ++j) x_out[3 * (size_t)v + j] = x[3 * v + j];
  }
  if (tid == 0 && !kBlocked) {
    a.iters[0] = it;
    a.zmax[0] = zm;
  }
}

// Each kernel's shared-memory limit, raised once per larger size.
size_t g_smem_opt_in = 48 * 1024;
size_t g_smem_opt_in_blocked = 48 * 1024;

// The shared memory a launch asks for: all that one block of the current
// device may opt in to (the kernel keeps the loop's live data in what its
// layout leaves), or kSmemOver where even pcg_smem is over it.
template <typename Kernel>
long long launch_smem(Kernel kernel, size_t need, size_t* have) {
  int dev = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return -(long long)err - 2;
  }
  if (need > (size_t)limit) return ndtpu::pg::kSmemOver;
  const int e = ndtpu::pg::smem_opt_in(kernel, (size_t)limit, have);
  return e != 0 ? -(long long)e - 2 : (long long)limit;
}

// The 16-bit indices hold any graph within one block's shared memory
// (pcg_smem <= 227 KB keeps 2f + p below 58,112); refused past them.
bool bad_shape(int n_pose, int n_fac, int n_pri) {
  return n_pose < 1 || n_fac < 0 || n_pri < 0 || n_pose > 65535 ||
         2 * (long long)n_fac + n_pri > 65535;
}

}  // namespace

extern "C" int pcg_solve_launch(
    const void* bet_i, const void* bet_j, const void* bet_mask, int n_fac,
    const void* prior_idx, const void* prior_mask, int n_pri,
    const void* pose_mask, int n_pose, const void* ai, const void* aj,
    const void* r, const void* ap, const void* rp, const void* rhs,
    const void* lam, float lam_value, float damp_abs, int max_iter,
    float tol, void* x, void* iters, void* zmax, void* scratch,
    void* stream) {
  if (n_pose < 1 || n_fac < 0 || n_pri < 0) return (int)cudaErrorInvalidValue;
  const long long smem = launch_smem(pcg_solve_kernel<false>,
                                     pcg_smem(n_pose, n_fac, n_pri),
                                     &g_smem_opt_in);
  if (smem == ndtpu::pg::kSmemOver) return ndtpu::pg::kSmemOver;
  if (smem < 0) return (int)(-smem - 2);
  if (bad_shape(n_pose, n_fac, n_pri)) return (int)cudaErrorInvalidValue;
  const PcgArgs a{(const long long*)bet_i, (const long long*)bet_j,
                  (const uint8_t*)bet_mask, n_fac,
                  (const long long*)prior_idx, (const uint8_t*)prior_mask,
                  n_pri, (const uint8_t*)pose_mask, n_pose, (const float*)ai,
                  (const float*)aj, (const float*)r, (const float*)ap,
                  (const float*)rp, (const float*)rhs, (const float*)lam,
                  lam_value, damp_abs, max_iter, tol, (float*)x, (int*)iters,
                  (float*)zmax, (float4*)scratch, (int)smem};
  pcg_solve_kernel<false><<<1, kThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// K6b: n_sessions blocks; n_pose, n_fac and n_pri are per session, lam is
// [n_sessions], rhs null means -gradient.
extern "C" int pcg_solve_blocked_launch(
    const void* bet_i, const void* bet_j, const void* bet_mask, int n_fac,
    const void* prior_idx, const void* prior_mask, int n_pri,
    const void* pose_mask, int n_pose, const void* ai, const void* aj,
    const void* r, const void* ap, const void* rp, const void* rhs,
    const void* lam, int max_iter, void* x, void* scratch, int n_sessions,
    void* stream) {
  if (n_pose < 1 || n_fac < 0 || n_pri < 0 || n_sessions < 1 ||
      lam == nullptr)
    return (int)cudaErrorInvalidValue;
  const long long smem = launch_smem(pcg_solve_kernel<true>,
                                     pcg_smem(n_pose, n_fac, n_pri),
                                     &g_smem_opt_in_blocked);
  if (smem == ndtpu::pg::kSmemOver) return ndtpu::pg::kSmemOver;
  if (smem < 0) return (int)(-smem - 2);
  if (bad_shape(n_pose, n_fac, n_pri)) return (int)cudaErrorInvalidValue;
  const PcgArgs a{(const long long*)bet_i, (const long long*)bet_j,
                  (const uint8_t*)bet_mask, n_fac,
                  (const long long*)prior_idx, (const uint8_t*)prior_mask,
                  n_pri, (const uint8_t*)pose_mask, n_pose, (const float*)ai,
                  (const float*)aj, (const float*)r, (const float*)ap,
                  (const float*)rp, (const float*)rhs, (const float*)lam,
                  0.f, 0.f, max_iter, 0.f, (float*)x, nullptr, nullptr,
                  (float4*)scratch, (int)smem};
  pcg_solve_kernel<true>
      <<<n_sessions, kThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
