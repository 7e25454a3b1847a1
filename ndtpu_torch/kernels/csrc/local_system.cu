// K7: the smoother's k-hop local system. K7a selects it, K7b assembles it.
//
// K7a local_select replaces what XLA lowered for the TPU from
// ndtpu/graph/incremental.py::_active_probe (:120) and _local_select
// (:173), in one launch of one block:
//   - the fresh slice (the newest local_fresh_k slots below n_between, and
//     with `since` only those appended since; n_between and since are read
//     on the device) seeds the active set, and a fresh loop factor (index
//     gap > local_span_gap) seeds the index interval of its cycle;
//   - local_hops Jacobi sweeps: every factor's flag fa = mask & (act[i] |
//     act[j]) from the pre-sweep set, a barrier, then the scatter of fa to
//     both endpoints (0/1 stores of 1, so the order of the writes is free,
//     as an integer atomicMax would be);
//   - act &= pose_mask, the touched factors, the fits test ok (and the
//     fresh-window overflow term n_between - since <= k);
//   - the two top-k selections as stable compactions (a block scan over
//     each thread's contiguous chunk): flagged indices first in index
//     order, then the others in index order, which is exactly what
//     lax.top_k and the plain _top_flags return; then in_set, f_sel, the
//     endpoints' roles and local slots, and the priors'.
// It writes only what the local path reads: the active set, the touched
// flags and the local index map are working arrays (the plain version
// returns them too, and the CPU tests hold them against the JAX package).
// Integers only, so it equals the plain selection bit for bit. Its two
// routes (kernels.select_route, a function of the slot counts) run the
// same code on working arrays in two places: in the block's shared memory
// where select_smem(V, F) fits what a block can opt in to (227 KB on
// Hopper, up to ~19,357 pose slots at F = 2V), else in a device scratch
// of 8 V + 2 F bytes the wrapper allocates per call (the block scan's and
// the interval's 40 ints stay in shared memory). One block sees its own
// global writes after each barrier, so the scratch route needs no other
// care; its sweeps' scattered reads of act go through L1.
//
// K7b local_assemble replaces the segment-sum assembly of
// ndtpu/dist/schur.py::assemble_local_parts (:318) as _local_system (:207)
// calls it with one separator: it writes only what the local path reads,
// h_ii [3n, 3n] and b_i [3n], from the gathered factors' whitened,
// Huber-weighted blocks (K5's gathered rows) and the active priors. One
// block per local pose a owns rows 3a..3a+2 of h_ii and b_i: it writes
// them whole (zeros where no factor lands), collects the contributions to
// its rows in slot order (a block scan; within a slot side i before side
// j, its own block before the cross block; the priors last), and for each
// target column block sums them in that order. No float atomics: two
// factors between one pair add in slot order, so h_ii is the same on
// every launch.
//
// What bounds them on Hopper: K7a is integer work on ~3 K values and one
// block's barriers (a few us; past one block's shared memory, ~50 K values
// through L1 and L2); K7b's bound is writing h_ii (2.36 MB at n =
// 256, ~0.7 us at HBM rate), while its time is each block's scan over the
// 1,024 gathered slots and its handful of 3 x 3 products.

#include <cuda_runtime.h>
#include <stdint.h>

#include "pose_graph.cuh"

namespace {

constexpr int kSelThreads = 1024;
constexpr int kAsmThreads = 256;

struct SelArgs {
  const long long* bet_i;
  const long long* bet_j;
  const uint8_t* bet_mask;
  int n_fac;
  const uint8_t* pose_mask;
  int n_pose;
  const long long* prior_idx;
  const uint8_t* prior_mask;
  int n_pri;
  const long long* n_between;
  const long long* since;      // or null
  int fresh_k;                 // min(local_fresh_k, F)
  int span_gap;
  int hops;
  int max_poses;               // local_poses (the fits test)
  int max_factors;             // local_factors
  int p_loc;                   // min(local_poses, V)
  int f_loc;                   // min(local_factors, F)
  int* scratch;                // the scratch route's act, loc, fa, touch
  // uint8 outputs
  uint8_t* ok;                 // []
  uint8_t* in_set;             // [p_loc]
  uint8_t* f_sel;              // [f_loc]
  uint8_t* p_act;              // [P]
  // int64 outputs
  long long* pid;              // [p_loc]
  long long* fid;              // [f_loc]
  long long* ri;
  long long* rj;
  long long* li;
  long long* lj;
  long long* rp;               // [P]
  long long* lp;
};

// Shared-memory bytes of K7a on the shared route (select_smem(0, 0) on
// the scratch route).
inline size_t select_smem(int v, int f) {
  return 4 * (size_t)(2 * v + 40) + 2 * (size_t)f;
}

// kScratch: act, loc, fa and touch in a.scratch (device memory), not in
// shared memory.
template <bool kScratch>
__global__ void __launch_bounds__(kSelThreads)
local_select_kernel(SelArgs a) {
  extern __shared__ int smem_i[];
  const int V = a.n_pose, F = a.n_fac, T = blockDim.x, tid = threadIdx.x;
  int* act = kScratch ? a.scratch : smem_i;             // [V] 0/1
  int* loc = act + V;                                   // [V]
  int* scr = kScratch ? smem_i : loc + V;               // [36]
  int* lohi = scr + 36;                                 // [4]
  uint8_t* fa = reinterpret_cast<uint8_t*>(kScratch ? loc + V : lohi + 4);
  uint8_t* touch = fa + F;                              // [F]

  const long long nb = *a.n_between;
  const int k = a.fresh_k;
  long long st = nb - k;
  st = st < 0 ? 0 : st;
  st = st > F - k ? F - k : st;
  for (int v = tid; v < V; v += T) act[v] = 0;
  if (tid == 0) {
    lohi[0] = V;
    lohi[1] = -1;
  }
  __syncthreads();

  // Seeds: the fresh slice's endpoints; the loop factors' interval.
  for (int t = tid; t < k; t += T) {
    const long long s = st + t;
    const bool live = s < nb && (a.since == nullptr || s >= *a.since);
    if (!(a.bet_mask[s] && live)) continue;
    const int fi = (int)a.bet_i[s], fj = (int)a.bet_j[s];
    act[fi] = 1;
    act[fj] = 1;
    if (abs(fi - fj) > a.span_gap) {
      atomicMin(lohi, min(fi, fj));
      atomicMax(lohi + 1, max(fi, fj));
    }
  }
  __syncthreads();
  const int lo = lohi[0], hi = lohi[1];
  for (int v = max(lo, 0) + tid; v <= min(hi, V - 1); v += T) act[v] = 1;
  __syncthreads();

  // Jacobi sweeps: fa from the pre-sweep set, then the scatter.
  for (int h = 0; h < a.hops; ++h) {
    for (int f = tid; f < F; f += T)
      fa[f] = a.bet_mask[f] && (act[a.bet_i[f]] | act[a.bet_j[f]]);
    __syncthreads();
    for (int f = tid; f < F; f += T) {
      if (!fa[f]) continue;
      act[a.bet_i[f]] = 1;
      act[a.bet_j[f]] = 1;
    }
    __syncthreads();
  }
  for (int v = tid; v < V; v += T) act[v] = act[v] && a.pose_mask[v];
  __syncthreads();
  for (int f = tid; f < F; f += T)
    touch[f] = a.bet_mask[f] && (act[a.bet_i[f]] | act[a.bet_j[f]]);

  // Pose slots: stable compaction of act over each thread's chunk.
  {
    const int chunk = (V + T - 1) / T;
    const int v0 = min(tid * chunk, V), v1 = min(v0 + chunk, V);
    int mine = 0;
    for (int v = v0; v < v1; ++v) mine += act[v];
    int n_act;
    int run = ndtpu::pg::block_exclusive_scan(mine, &n_act, scr);
    for (int v = v0; v < v1; ++v) {
      const int pos = act[v] ? run : n_act + (v - run);
      run += act[v];
      const bool kept = pos < a.p_loc;
      loc[v] = kept ? pos : 0;
      if (kept) {
        a.pid[pos] = v;
        a.in_set[pos] = (uint8_t)act[v];
      }
    }
    if (tid == 0) lohi[2] = n_act;
  }
  __syncthreads();      // loc and touch complete

  // Factor slots: stable compaction of touch.
  {
    const int chunk = (F + T - 1) / T;
    const int f0 = min(tid * chunk, F), f1 = min(f0 + chunk, F);
    int mine = 0;
    for (int f = f0; f < f1; ++f) mine += touch[f];
    int n_touch;
    int run = ndtpu::pg::block_exclusive_scan(mine, &n_touch, scr);
    for (int f = f0; f < f1; ++f) {
      const int pos = touch[f] ? run : n_touch + (f - run);
      run += touch[f];
      if (pos >= a.f_loc) continue;
      const long long i = a.bet_i[f], j = a.bet_j[f];
      a.fid[pos] = f;
      a.f_sel[pos] = touch[f];
      a.ri[pos] = act[i] ? 0 : 1;
      a.rj[pos] = act[j] ? 0 : 1;
      a.li[pos] = loc[i];
      a.lj[pos] = loc[j];
    }
    if (tid == 0) {
      bool ok = lohi[2] <= a.max_poses && n_touch <= a.max_factors;
      if (a.since != nullptr) ok = ok && (nb - *a.since <= k);
      a.ok[0] = ok;
    }
  }
  for (int q = tid; q < a.n_pri; q += T) {
    const long long i = a.prior_idx[q];
    a.rp[q] = act[i] ? 0 : 1;
    a.p_act[q] = act[i] && a.prior_mask[q];
    a.lp[q] = loc[i];
  }
}

struct AsmArgs {
  const float* ai;             // [K, 9]
  const float* aj;
  const float* r;              // [K, 3]
  int n_rows;                  // K
  const float* ap;             // [P, 9]
  const float* rp;             // [P, 3]
  int n_pri;
  const uint8_t* f_sel;        // [K]
  const long long* ri;
  const long long* li;
  const long long* rj;
  const long long* lj;
  const uint8_t* p_act;        // [P]
  const long long* p_role;
  const long long* lp;
  int n;                       // local poses
  float* h;                    // [3n, 3n]
  float* b;                    // [3n]
};

// Shared-memory bytes of K7b.
inline size_t assemble_smem(int k, int p) {
  return 8 * (size_t)(4 * k + p) + 4 * 40;
}

// Contribution kinds: G_a^T G_b with (G_a, G_b) = (Ai, Ai), (Ai, Aj),
// (Aj, Aj), (Aj, Ai), and (Ap, Ap) for a prior (code 4K + prior).
__device__ __forceinline__ void contribution(const AsmArgs& a, int code,
                                             const float** ga,
                                             const float** gb,
                                             const float** res) {
  const int k4 = 4 * a.n_rows;
  if (code >= k4) {
    const int q = code - k4;
    *ga = *gb = a.ap + 9 * (size_t)q;
    *res = a.rp + 3 * (size_t)q;
    return;
  }
  const int s = code >> 2, kind = code & 3;
  const float* ai = a.ai + 9 * (size_t)s;
  const float* aj = a.aj + 9 * (size_t)s;
  *ga = kind < 2 ? ai : aj;
  *gb = (kind == 0 || kind == 3) ? ai : aj;
  *res = a.r + 3 * (size_t)s;
}

__global__ void __launch_bounds__(kAsmThreads)
local_assemble_kernel(AsmArgs a) {
  extern __shared__ int smem_a[];
  const int K = a.n_rows, T = blockDim.x, tid = threadIdx.x;
  const int row = blockIdx.x, n3 = 3 * a.n;
  int* ccol = smem_a;                 // [4K + P]
  int* ccode = ccol + 4 * K + a.n_pri;
  int* scr = ccode + 4 * K + a.n_pri; // [36]
  int* cnt = scr + 36;                // [1]

  float* hrow = a.h + (size_t)3 * row * n3;
  for (int i = tid; i < 3 * n3; i += T) hrow[i] = 0.f;

  // Contributions to this block's rows, in slot order.
  const int chunk = (K + T - 1) / T;
  const int s0 = min(tid * chunk, K), s1 = min(s0 + chunk, K);
  int mine = 0;
  for (int s = s0; s < s1; ++s) {
    if (!a.f_sel[s]) continue;
    const bool ii = a.ri[s] == 0, jj = a.rj[s] == 0;
    if (ii && a.li[s] == row) mine += 1 + jj;
    if (jj && a.lj[s] == row) mine += 1 + ii;
  }
  int total;
  int at = ndtpu::pg::block_exclusive_scan(mine, &total, scr);
  for (int s = s0; s < s1; ++s) {
    if (!a.f_sel[s]) continue;
    const bool ii = a.ri[s] == 0, jj = a.rj[s] == 0;
    if (ii && a.li[s] == row) {
      ccol[at] = row;
      ccode[at++] = 4 * s;
      if (jj) {
        ccol[at] = (int)a.lj[s];
        ccode[at++] = 4 * s + 1;
      }
    }
    if (jj && a.lj[s] == row) {
      ccol[at] = row;
      ccode[at++] = 4 * s + 2;
      if (ii) {
        ccol[at] = (int)a.li[s];
        ccode[at++] = 4 * s + 3;
      }
    }
  }
  if (tid == 0) {
    int m = total;
    for (int q = 0; q < a.n_pri; ++q) {
      if (a.p_act[q] && a.p_role[q] == 0 && a.lp[q] == row) {
        ccol[m] = row;
        ccode[m++] = 4 * K + q;
      }
    }
    cnt[0] = m;
  }
  __syncthreads();
  const int m_all = cnt[0];

  // b_i: the own-block contributions' A^T r, in order.
  if (tid < 3) {
    float acc = 0.f;
    for (int m = 0; m < m_all; ++m) {
      const int code = ccode[m];
      if (code < 4 * K && (code & 1)) continue;      // cross blocks
      const float *ga, *gb, *res;
      contribution(a, code, &ga, &gb, &res);
      float t3[3];
      ndtpu::pg::mtv3(ga, res, t3);
      acc = acc + t3[tid];
    }
    a.b[3 * row + tid] = acc;
  }
  // h_ii: one thread per distinct target column block, summing in order.
  for (int m = tid; m < m_all; m += T) {
    const int col = ccol[m];
    bool first = true;
    for (int u = 0; u < m && first; ++u) first = ccol[u] != col;
    if (!first) continue;
    float acc[9] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int u = m; u < m_all; ++u) {
      if (ccol[u] != col) continue;
      const float *ga, *gb, *res;
      contribution(a, ccode[u], &ga, &gb, &res);
      float t9[9];
      ndtpu::pg::mtm3(ga, gb, t9);
#pragma unroll
      for (int k = 0; k < 9; ++k) acc[k] = acc[k] + t9[k];
    }
#pragma unroll
    for (int p = 0; p < 3; ++p)
#pragma unroll
      for (int q = 0; q < 3; ++q)
        hrow[(size_t)p * n3 + 3 * col + q] = acc[3 * p + q];
  }
}

// The kernels' shared-memory limits, raised once per larger size.
size_t g_select_opt_in = 48 * 1024;
size_t g_assemble_opt_in = 48 * 1024;

}  // namespace

// scratch: null for the shared route; else the scratch route's 8 V + 2 F
// bytes, 4-byte aligned.
extern "C" int local_select_launch(
    const void* bet_i, const void* bet_j, const void* bet_mask, int n_fac,
    const void* pose_mask, int n_pose, const void* prior_idx,
    const void* prior_mask, int n_pri, const void* n_between,
    const void* since, int fresh_k, int span_gap, int hops, int max_poses,
    int max_factors, int p_loc, int f_loc, void* flags, void* ints,
    void* scratch, void* stream) {
  if (n_pose < 1 || n_fac < 1 || fresh_k < 0 || fresh_k > n_fac ||
      p_loc > n_pose || f_loc > n_fac || p_loc < 0 || f_loc < 0)
    return (int)cudaErrorInvalidValue;
  const bool global = scratch != nullptr;
  const size_t smem = global ? select_smem(0, 0)
                             : select_smem(n_pose, n_fac);
  if (!global) {
    const int err = ndtpu::pg::smem_opt_in(local_select_kernel<false>, smem,
                                           &g_select_opt_in);
    if (err != 0) return err;
  }
  // flags (uint8): ok, in_set [p_loc], f_sel [f_loc], p_act [P]; ints
  // (int64): pid [p_loc], fid, ri, rj, li, lj [f_loc], rp, lp [P].
  uint8_t* fl = (uint8_t*)flags;
  long long* in = (long long*)ints;
  SelArgs a{};
  a.bet_i = (const long long*)bet_i;
  a.bet_j = (const long long*)bet_j;
  a.bet_mask = (const uint8_t*)bet_mask;
  a.n_fac = n_fac;
  a.pose_mask = (const uint8_t*)pose_mask;
  a.n_pose = n_pose;
  a.prior_idx = (const long long*)prior_idx;
  a.prior_mask = (const uint8_t*)prior_mask;
  a.n_pri = n_pri;
  a.n_between = (const long long*)n_between;
  a.since = (const long long*)since;
  a.fresh_k = fresh_k;
  a.span_gap = span_gap;
  a.hops = hops;
  a.max_poses = max_poses;
  a.max_factors = max_factors;
  a.p_loc = p_loc;
  a.f_loc = f_loc;
  a.ok = fl;
  a.in_set = a.ok + 1;
  a.f_sel = a.in_set + p_loc;
  a.p_act = a.f_sel + f_loc;
  a.pid = in;
  a.fid = a.pid + p_loc;
  a.ri = a.fid + f_loc;
  a.rj = a.ri + f_loc;
  a.li = a.rj + f_loc;
  a.lj = a.li + f_loc;
  a.rp = a.lj + f_loc;
  a.lp = a.rp + n_pri;
  a.scratch = (int*)scratch;
  if (global)
    local_select_kernel<true><<<1, kSelThreads, smem,
                                (cudaStream_t)stream>>>(a);
  else
    local_select_kernel<false><<<1, kSelThreads, smem,
                                 (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int local_assemble_launch(
    const void* ai, const void* aj, const void* r, int n_rows,
    const void* ap, const void* rp, int n_pri, const void* f_sel,
    const void* ri, const void* li, const void* rj, const void* lj,
    const void* p_act, const void* p_role, const void* lp, int n, void* h,
    void* b, void* stream) {
  if (n < 1 || n_rows < 0 || n_pri < 0) return (int)cudaErrorInvalidValue;
  const size_t smem = assemble_smem(n_rows, n_pri);
  const int err = ndtpu::pg::smem_opt_in(local_assemble_kernel, smem,
                                         &g_assemble_opt_in);
  if (err != 0) return err;
  const AsmArgs a{(const float*)ai, (const float*)aj, (const float*)r,
                  n_rows, (const float*)ap, (const float*)rp, n_pri,
                  (const uint8_t*)f_sel, (const long long*)ri,
                  (const long long*)li, (const long long*)rj,
                  (const long long*)lj, (const uint8_t*)p_act,
                  (const long long*)p_role, (const long long*)lp, n,
                  (float*)h, (float*)b};
  local_assemble_kernel<<<n, kAsmThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
