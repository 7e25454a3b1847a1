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
//     act[j]) from the pre-sweep set, then the scatter of fa to both
//     endpoints (stores of one value, so the order of the writes is free,
//     as an integer atomicMax would be);
//   - act &= pose_mask, the touched factors, the fits test ok (and the
//     fresh-window overflow term n_between - since <= k);
//   - the two top-k selections as stable compactions (a block scan over
//     contiguous ranges of the indices): flagged indices first in index
//     order, then the others in index order, which is exactly what
//     lax.top_k and the plain _top_flags return; then in_set, f_sel, the
//     endpoints' roles and local slots, and the priors'.
// It writes only what the local path reads: the active set, the touched
// flags and the local index map are working arrays (the plain version
// returns them too, and the CPU tests hold them against the JAX package).
// Integers only, so it equals the plain selection bit for bit. Its two
// routes (kernels.select_route, a function of the slot counts):
//   - shared (up to 65,535 pose slots and 128 factors per thread of a
//     1,024-thread block): the graph is staged once, in one coalesced
//     pass, as each factor's endpoints packed into 16-bit pairs (dead
//     factors' too: the compaction writes every kept position's roles and
//     slots), the factor mask as bits (a warp ballot per 32 factors) and
//     a byte per pose (its mask and the hop that reached it); every later
//     pass (seeds, sweeps, touched flags, both compactions, priors) reads
//     shared memory and registers only. A hop is one pass and one
//     barrier: it flags from the levels below it and writes its own.
//     Each warp walks its contiguous range of factors (and of poses) 32
//     at a time, so its loads and the compactions' stores are coalesced;
//     a thread's mask and touched flags are register bit masks (no flag
//     arrays), and one block scan of a packed pair of counts gives both
//     compactions' warp offsets (ballots the places within a warp). The
//     first design's Jacobi sweeps took two barriers a hop and read the
//     graph in every pass. Where the staged layout
//     (select_smem(V, F, 1): 3 B per pose, 4 B and a bit per factor) is
//     over what a block can opt in to (227 KB on Hopper: past ~20,600
//     pose slots at F = 2V, ~32,500 at F = V), the same code reads the
//     endpoints from the graph in each pass (select_smem(V, F, 0)).
//   - scratch (past that): the first design's body with act, loc and its
//     flag bytes in a device scratch of 8 V + 2 F bytes the wrapper
//     allocates per call (the block scan's and the interval's 40 ints in
//     shared memory). One block sees its own global writes after each
//     barrier, so it needs no other care; its sweeps' scattered reads of
//     act go through L1.
//
// K7b local_assemble replaces the segment-sum assembly of
// ndtpu/dist/schur.py::assemble_local_parts (:318) as _local_system (:207)
// calls it with one separator: it writes only what the local path reads,
// h_ii [3n, 3n] and b_i [3n], from the gathered factors' whitened,
// Huber-weighted blocks (K5's gathered rows) and the active priors. One
// launch. Its first block to start builds every row's contribution list
// once (CSR by local row: integer counts, their exclusive scan, each
// contribution into its row's bucket); the other blocks own 8 rows each,
// one warp per row, and zero their rows of h_ii at once (16-byte stores).
// Each row's column blocks are summed in code order: the order of the
// slots, within a slot side i before side j and the own block before the
// cross block, the priors last, which is the order of the plain kernel
// before it (whose block rescanned every slot for its row): a bucket
// sorted by (column block, code) puts each column block's run in that
// order. Each sum starts at 0 and adds in that order, so h_ii and b_i are
// that kernel's bits; no float atomics, so every launch gives the same
// bits. Up to kSmallE contributions (the small mode: small active sets,
// where one block's chain is shorter than the rows' round trips) the
// build block keeps the buckets in shared memory and sums them itself
// once the rows are zeroed; past it the buckets go to a per-call device
// scratch and each worker warp sorts and sums its row.
// Nothing of K lives in shared memory past kSmallE: any K.
//
// What bounds them on Hopper: K7a is integer work on ~3 K values and one
// block's barriers (a few us): the first design read each factor's
// endpoints and mask from the graph again in every pass, a dependent L2 or
// L1 round trip before each pass's shared lookups, which the staged
// layout removes, and its compaction's int64 stores strode by a thread's
// chunk across the lanes. Staged, the one pass over the graph (17 B a
// factor) is bound by one SM's bandwidth from L2 (past the shared route,
// ~50 K values through L1 and L2). K7b's bound is writing h_ii (2.36 MB at n =
// 256, ~0.7 us at HBM rate). Its time is the build block's chain: the
// slots read once, shared-memory counts and cursors, one round trip for
// the factor blocks, the sums; the zeroing runs beside it on the workers.
// Past kSmallE the rows add their chain of L2 round trips (offsets,
// bucket, sorted bucket, blocks) after the build.

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

// K7a's shared route: graphs of up to kSelMaxPoses pose slots (local
// slots and packed endpoints fit 16 bits) and kSelMaxChunk factors per
// thread of the block (each thread's flags live in kSelWords registers).
constexpr int kSelWords = 4;
constexpr int kSelMaxChunk = 32 * kSelWords;
constexpr int kSelMaxPoses = 65535;

// Shared-memory bytes of K7a's shared route: the pair scan's 36 and the
// interval's 4 slots of 8 bytes, the factor mask as bits (4 B per 32
// factors), each pose's local slot (2 B) and level byte (1 B), and with
// staged = 1 each factor's packed endpoints (4 B). Staged where that fits
// what a block can opt in to; else the endpoints stay in the graph.
inline size_t select_smem(int v, int f, int staged) {
  return 320 + 4 * (((size_t)f + 31) / 32) + 3 * (size_t)v
         + 4 * (size_t)f * staged;
}

// A pose's byte on the shared route: bit 7 its mask, bits 0-6 the hop that
// reached it (0 the seeds, kUnreached none; hops past kMaxLevel are
// recorded as kMaxLevel).
constexpr int kMaskBit = 0x80, kUnreached = 0x7f, kMaxLevel = 0x7e;

// Exclusive prefix sums of two ints per thread at once, in thread order,
// with their block totals (a packed 64-bit sum: the low word's total, at
// most the factor count, never carries). scr: >= 33 shared long longs,
// read on return (a caller that writes scr again needs a barrier first).
__device__ __forceinline__ void block_scan_pair(int a, int b, int* ra,
                                                int* rb, int* ta, int* tb,
                                                long long* scr) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const long long v = ((long long)a << 32) | (unsigned)b;
  long long inc = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const long long u = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += u;
  }
  if (lane == 31) scr[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const long long w = lane < warps ? scr[lane] : 0;
    long long winc = w;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const long long u = __shfl_up_sync(0xffffffffu, winc, o);
      if (lane >= o) winc += u;
    }
    if (lane < warps) scr[lane] = winc - w;
    if (lane == 31) scr[32] = winc;
  }
  __syncthreads();
  const long long ex = scr[warp] + inc - v, tot = scr[32];
  *ra = (int)(ex >> 32);
  *rb = (int)(ex & 0xffffffffll);
  *ta = (int)(tot >> 32);
  *tb = (int)(tot & 0xffffffffll);
}

// The shared route. Warp w owns the contiguous range of 32 c factors
// from Fw = 32 c w (c = ceil(F / T)) and of 32 cv poses from Pw = 32 cv w
// (c, cv <= kSelMaxChunk) and walks each 32 at a time: lane l's round r
// is factor Fw + 32 r + l (pose Pw + 32 r + l), so every round's loads
// and stores are coalesced, a ballot gives the lanes' places within it,
// and factor f's flags (mask, touched) are bit r of the thread's kSelWords
// registers. The staging runs in the same order, so the mask bits are the
// staging's own (and one ballot word per 32 factors for the seeds).
// Each pose's byte holds its mask (kMaskBit) and the hop that reached it:
// hop h flags factor f from its endpoints' levels below h and writes
// level h where it is higher, so the flags never see the hop's own writes
// (racing threads store the same byte) and a hop is one pass and one
// barrier; "active and live" is a byte in [kMaskBit, kMaskBit |
// kMaxLevel]. Past kMaxLevel hops a hop splits into its flags, a barrier
// and the scatter. With kStaged the endpoints are staged once as 16-bit
// pairs (i | j << 16) and every pass reads shared memory only; without
// it (graphs whose endpoints do not fit beside the pose arrays) each pass
// reads them from the graph through L1.
template <bool kStaged>
__global__ void __launch_bounds__(kSelThreads)
local_select_shared_kernel(SelArgs a) {
  extern __shared__ long long smem_l[];
  const int V = a.n_pose, F = a.n_fac, T = blockDim.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const unsigned below = (1u << lane) - 1u;            // lanes before mine
  long long* scr = smem_l;                                  // [36]
  int* lohi = reinterpret_cast<int*>(smem_l + 36);          // [8]
  unsigned* mbits = reinterpret_cast<unsigned*>(smem_l + 40);
  const int n_words = (F + 31) / 32;
  uint32_t* ends = mbits + n_words;                         // [F] staged
  uint16_t* loc = reinterpret_cast<uint16_t*>(ends + (kStaged ? F : 0));
  uint8_t* act = reinterpret_cast<uint8_t*>(loc + V);
  auto ends_of = [&](int f, int* i, int* j) {
    if constexpr (kStaged) {
      const uint32_t e = ends[f];
      *i = (int)(e & 0xffffu);
      *j = (int)(e >> 16);
    } else {
      *i = (int)a.bet_i[f];
      *j = (int)a.bet_j[f];
    }
  };
  auto live_active = [&](int v) {
    const int b = act[v];
    return b >= kMaskBit && b != (kMaskBit | kUnreached);
  };
  // Level lvl for pose v where its level is higher.
  auto reach = [&](int v, int lvl) {
    const int b = act[v];
    if ((b & kUnreached) > lvl) act[v] = (uint8_t)((b & kMaskBit) | lvl);
  };

  const long long nb = *a.n_between;
  const long long since = a.since == nullptr ? 0 : *a.since;
  // The prior of slot tid, read now so that its loads overlap the staging.
  const long long prior0 = tid < a.n_pri ? a.prior_idx[tid] : 0;
  const bool prior0_on = tid < a.n_pri && a.prior_mask[tid];

  // Stage, a factor and a pose a thread a round (one SM's bandwidth from
  // L2 bounds this pass: more loads in flight a thread measured slower):
  // the endpoints, the factor mask (my bits, and a ballot word per 32
  // factors), each pose's byte (its mask, unreached).
  const int c = (F + T - 1) / T, cv = (V + T - 1) / T;
  const int Fw = 32 * c * warp, Pw = 32 * cv * warp;
  auto fac = [&](int w, int b) { return Fw + 32 * (32 * w + b) + lane; };
  unsigned msk[kSelWords];
#pragma unroll
  for (int w = 0; w < kSelWords; ++w) {
    unsigned bits = 0;
    for (int b = 0; b < 32 && 32 * w + b < max(c, cv); ++b) {
      const int r = 32 * w + b, f = fac(w, b), v = Pw + 32 * r + lane;
      bool on = false;
      if (r < c && f < F) {
        if constexpr (kStaged)
          ends[f] = ((uint32_t)a.bet_i[f] & 0xffffu) |
                    ((uint32_t)a.bet_j[f] << 16);
        on = a.bet_mask[f] != 0;
      }
      if (r < cv && v < V)
        act[v] = (uint8_t)((a.pose_mask[v] ? kMaskBit : 0) | kUnreached);
      const unsigned word = __ballot_sync(0xffffffffu, on);
      if (lane == 0 && r < c && f < F) mbits[f >> 5] = word;
      bits |= (unsigned)on << b;
    }
    msk[w] = bits;
  }
  if (tid == 0) {
    lohi[0] = V;
    lohi[1] = -1;
  }
  __syncthreads();
  const int k = a.fresh_k;
  long long st = nb - k;
  st = st < 0 ? 0 : st;
  st = st > F - k ? F - k : st;

  // Seeds (level 0): the fresh slice's endpoints; the loop factors'
  // interval.
  for (int t = tid; t < k; t += T) {
    const long long s = st + t;
    if (!(((mbits[s >> 5] >> (s & 31)) & 1u) && s < nb &&
          (a.since == nullptr || s >= since)))
      continue;
    int fi, fj;
    ends_of((int)s, &fi, &fj);
    reach(fi, 0);
    reach(fj, 0);
    if (abs(fi - fj) > a.span_gap) {
      atomicMin(lohi, min(fi, fj));
      atomicMax(lohi + 1, max(fi, fj));
    }
  }
  __syncthreads();
  const int lo = lohi[0], hi = lohi[1];
  if (lo <= hi) {                       // the same on every thread
    for (int v = max(lo, 0) + tid; v <= min(hi, V - 1); v += T) reach(v, 0);
    __syncthreads();
  }

  // Jacobi sweeps: hop h flags a live factor with an endpoint reached
  // before it (level < h; past kMaxLevel any level but kUnreached) and
  // gives its endpoints level h (at most kMaxLevel).
  for (int h = 1; h <= a.hops; ++h) {
    const bool split = h > kMaxLevel;   // the same on every thread
    const int lvl = min(h, kMaxLevel), before = min(h, kUnreached);
    unsigned fa[kSelWords];
#pragma unroll
    for (int w = 0; w < kSelWords; ++w) {
      unsigned bits = msk[w], on = 0;
      while (bits) {
        const int b = __ffs(bits) - 1;
        bits &= bits - 1;
        int i, j;
        ends_of(fac(w, b), &i, &j);
        if ((act[i] & kUnreached) < before ||
            (act[j] & kUnreached) < before) {
          if (split) {
            on |= 1u << b;
          } else {
            reach(i, lvl);
            reach(j, lvl);
          }
        }
      }
      fa[w] = on;
    }
    if (split) {
      __syncthreads();
#pragma unroll
      for (int w = 0; w < kSelWords; ++w) {
        unsigned bits = fa[w];
        while (bits) {
          const int b = __ffs(bits) - 1;
          bits &= bits - 1;
          int i, j;
          ends_of(fac(w, b), &i, &j);
          reach(i, lvl);
          reach(j, lvl);
        }
      }
    }
    __syncthreads();
  }

  // The touched factors (an endpoint active and live), my poses' count.
  unsigned tch[kSelWords];
  int n_mine_f = 0;
#pragma unroll
  for (int w = 0; w < kSelWords; ++w) {
    unsigned bits = msk[w], on = 0;
    while (bits) {
      const int b = __ffs(bits) - 1;
      bits &= bits - 1;
      int i, j;
      ends_of(fac(w, b), &i, &j);
      if (live_active(i) || live_active(j)) on |= 1u << b;
    }
    tch[w] = on;
    n_mine_f += __popc(on);
  }
  int n_mine_v = 0;
  for (int r = 0; r < cv; ++r) {
    const int v = Pw + 32 * r + lane;
    n_mine_v += v < V && live_active(v);
  }
  // The pair scan in thread order; lane 0's exclusive sums are the counts
  // of the warps before mine, the rounds' order's offsets.
  int run_v, run_f, n_act, n_touch;
  block_scan_pair(n_mine_v, n_mine_f, &run_v, &run_f, &n_act, &n_touch,
                  scr);
  run_v = __shfl_sync(0xffffffffu, run_v, 0);
  run_f = __shfl_sync(0xffffffffu, run_f, 0);

  // Pose slots: stable compaction of the active set, round by round.
  // Places past p_loc are not kept; past them (the places only grow) a
  // warp only zeroes its local slots.
  for (int r = 0; r < cv; ++r) {
    const int v = Pw + 32 * r + lane, first = v - lane;
    if (run_v >= a.p_loc && n_act + (first - run_v) >= a.p_loc) {
      if (v < V) loc[v] = 0;            // the same test on every lane
      continue;
    }
    const bool on = v < V && live_active(v);
    const unsigned bal = __ballot_sync(0xffffffffu, on);
    const int x = run_v + __popc(bal & below);          // active before v
    const int pos = on ? x : n_act + (v - x);
    run_v += __popc(bal);
    if (v < V) {
      const bool kept = pos < a.p_loc;
      loc[v] = (uint16_t)(kept ? pos : 0);
      if (kept) {
        a.pid[pos] = v;
        a.in_set[pos] = (uint8_t)on;
      }
    }
  }
  __syncthreads();      // loc complete

  // Factor slots: stable compaction of the touched flags, round by round;
  // a warp stops once both its next places are past f_loc.
#pragma unroll
  for (int w = 0; w < kSelWords; ++w) {
    for (int b = 0; b < 32 && 32 * w + b < c; ++b) {
      const int f = fac(w, b), first = f - lane;
      if (run_f >= a.f_loc && n_touch + (first - run_f) >= a.f_loc)
        break;                          // the same on every lane
      const bool on = f < F && ((tch[w] >> b) & 1u);
      const unsigned bal = __ballot_sync(0xffffffffu, on);
      const int x = run_f + __popc(bal & below);        // touched before f
      const int pos = on ? x : n_touch + (f - x);
      run_f += __popc(bal);
      if (f >= F || pos >= a.f_loc) continue;
      int i, j;
      ends_of(f, &i, &j);
      a.fid[pos] = f;
      a.f_sel[pos] = (uint8_t)on;
      a.ri[pos] = live_active(i) ? 0 : 1;
      a.rj[pos] = live_active(j) ? 0 : 1;
      a.li[pos] = loc[i];
      a.lj[pos] = loc[j];
    }
  }
  if (tid == 0) {
    bool ok = n_act <= a.max_poses && n_touch <= a.max_factors;
    if (a.since != nullptr) ok = ok && (nb - since <= k);
    a.ok[0] = ok;
  }
  for (int q = tid; q < a.n_pri; q += T) {
    const long long i = q == tid ? prior0 : a.prior_idx[q];
    const bool on = live_active((int)i);
    a.rp[q] = on ? 0 : 1;
    a.p_act[q] = on && (q == tid ? prior0_on : a.prior_mask[q] != 0);
    a.lp[q] = loc[i];
  }
}

// The scratch route (graphs past the shared route): the first design's
// body, act, loc, fa and touch in a.scratch (8 V + 2 F bytes of device
// memory), the graph's endpoints read in every pass. One block sees its
// own global writes after each barrier; the sweeps' scattered reads of act
// go through L1.
__global__ void __launch_bounds__(kSelThreads)
local_select_scratch_kernel(SelArgs a) {
  __shared__ int scr[36];
  __shared__ int lohi[4];
  const int V = a.n_pose, F = a.n_fac, T = blockDim.x, tid = threadIdx.x;
  int* act = a.scratch;                                 // [V] 0/1
  int* loc = act + V;                                   // [V]
  uint8_t* fa = reinterpret_cast<uint8_t*>(loc + V);    // [F]
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
  int2* list;                  // [4K + P] (col, code), bucketed by row
  int2* sorted;                // [4K + P] each row's bucket in key order
  int* off;                    // [n + 1] the buckets' offsets
  int* ctl;                    // [4] ticket, finished blocks, the build's
                               // mode (1 lists, 2 summed), zeroed workers
  float* h;                    // [3n, 3n]
  float* b;                    // [3n]
};

constexpr int kAsmRows = kAsmThreads / 32;   // rows per worker block
// Up to this many contributions the build block sums them itself.
constexpr int kSmallE = 256;

// Dynamic shared-memory bytes of K7b (every block gets the same): the
// build's per-row counts (n) and offsets (n + 1), its scan's 40 ints, and
// for kSmallE contributions their (column, code), 12 sums' terms, sorted
// place and row.
inline size_t assemble_smem(int n) {
  return 4 * (2 * (size_t)n + 41) + 64 * (size_t)kSmallE;
}

// The build block's shared memory.
struct AsmSmem {
  int2* list;                  // [kSmallE] (col, code), bucketed by row
  float* vals;                 // [kSmallE, 12] G_a^T G_b, then G_a^T r
  int* order;                  // [kSmallE] the sorted places' entries
  int* rowof;                  // [kSmallE]
  int* cnt;                    // [n] counts, then cursors
  int* base;                   // [n + 1] offsets
  int* scr;                    // [40]
};

__device__ __forceinline__ AsmSmem carve(int* raw, int n) {
  AsmSmem m;
  m.list = reinterpret_cast<int2*>(raw);
  m.vals = reinterpret_cast<float*>(m.list + kSmallE);
  m.order = reinterpret_cast<int*>(m.vals + 12 * kSmallE);
  m.rowof = m.order + kSmallE;
  m.cnt = m.rowof + kSmallE;
  m.base = m.cnt + n;
  m.scr = m.base + n + 1;
  return m;
}

// Ints of K7b's per-call device scratch: list and sorted (two ints per
// contribution, at most 4K + P contributions) and off (n + 1).
inline size_t assemble_scratch(int k, int p, int n) {
  return 4 * (4 * (size_t)k + p) + n + 1;
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

// A gathered slot's sides: each lands in its local row when the slot is
// selected and that endpoint is interior with a local slot in [0, n).
struct Sides {
  int li, lj;
  bool ii, jj;
};

__device__ __forceinline__ Sides sides(const AsmArgs& a, int s) {
  const bool sel = a.f_sel[s];
  const long long ri = a.ri[s], li = a.li[s], rj = a.rj[s], lj = a.lj[s];
  Sides d;
  d.ii = sel && ri == 0 && li >= 0 && li < a.n;
  d.jj = sel && rj == 0 && lj >= 0 && lj < a.n;
  d.li = (int)li;
  d.lj = (int)lj;
  return d;
}

__device__ __forceinline__ bool prior_in(const AsmArgs& a, int q) {
  const bool act = a.p_act[q];
  const long long role = a.p_role[q], l = a.lp[q];
  return act && role == 0 && l >= 0 && l < a.n;
}

// Ask L1 for a contribution's blocks (its G_a, G_b rows and residual),
// which the small mode reads after the count.
__device__ __forceinline__ void prefetch_l1(const void* p) {
  asm volatile("prefetch.global.L1 [%0];" :: "l"(p));
}

__device__ __forceinline__ void prefetch_slot(const AsmArgs& a, int s) {
  prefetch_l1(a.ai + 9 * (size_t)s);
  prefetch_l1(a.ai + 9 * (size_t)s + 8);
  prefetch_l1(a.aj + 9 * (size_t)s);
  prefetch_l1(a.aj + 9 * (size_t)s + 8);
  prefetch_l1(a.r + 3 * (size_t)s);
}

__device__ __forceinline__ unsigned long long entry_key(int2 e) {
  return ((unsigned long long)(unsigned)e.x << 32) | (unsigned)e.y;
}

__device__ __forceinline__ void release_u32(int* p, int v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;" :: "l"(p), "r"(v)
               : "memory");
}

// Polls *p (relaxed, trapping after 2^24 polls instead of hanging the
// card) until done(value). With `block`, thread 0 polls, then an acquire
// fence, and the barrier gives the whole block the other blocks' writes
// before their release; without, the calling thread only polls.
template <typename Done>
__device__ __forceinline__ unsigned wait_u32(const int* p, Done done,
                                             bool block = true) {
  __shared__ unsigned seen;
  if (!block || threadIdx.x == 0) {
    unsigned v, polls = 0;
    do {
      asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];"
                   : "=r"(v) : "l"(p) : "memory");
      if (++polls == (1u << 24)) __trap();
    } while (!done(v));
    if (!block) return v;
    asm volatile("fence.acq_rel.gpu;" ::: "memory");
    seen = v;
  }
  __syncthreads();
  return seen;
}

__device__ __forceinline__ bool own_block(int code, int k4) {
  return code >= k4 || !(code & 1);
}

// The build block: every row's contributions in one pass over the slots
// and priors: counts, their exclusive scan, then each contribution into
// its row's bucket by a shared-memory cursor (within a bucket the order
// is the cursors'; the sums sort by key). The first round's slots (kU T
// of them) and the first T priors are read once, before any count, and
// kept in registers for the placement; their blocks are asked of L1 as
// soon as the selection is known. Up to kSmallE contributions (the
// small mode) the buckets stay in shared memory and this block sums them:
// each contribution's G_a^T G_b and G_a^T r once (kU contributions a
// thread, their blocks read together), its place in its row sorted by
// (column block, code), then one thread per column block adds its run in
// that order, once every worker has zeroed its rows. Past kSmallE the
// buckets and offsets go to the device scratch for the workers.
constexpr int kU = 4;                  // slots (or contributions) a round

__device__ __forceinline__ void load_round(const AsmArgs& a, int base,
                                           Sides d[kU]) {
  const int T = blockDim.x, K = a.n_rows;
#pragma unroll
  for (int u = 0; u < kU; ++u) {
    const int s = base + u * T + threadIdx.x;
    d[u] = s < K ? sides(a, s) : Sides{0, 0, false, false};
  }
}

__device__ void build_and_sum(const AsmArgs& a, AsmSmem m) {
  const int n = a.n, K = a.n_rows, T = blockDim.x, tid = threadIdx.x;
  const bool one_round = K <= kU * T;
  Sides d[kU];
  load_round(a, 0, d);
  bool p0 = false;
  int l0 = 0;
  if (tid < a.n_pri) {
    p0 = prior_in(a, tid);
    l0 = (int)a.lp[tid];
  }
  for (int i = tid; i < n; i += T) m.cnt[i] = 0;
  __syncthreads();
  for (int base = 0; base < K; base += kU * T) {
    if (base > 0) load_round(a, base, d);
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      if (d[u].ii) atomicAdd(m.cnt + d[u].li, 1 + d[u].jj);
      if (d[u].jj) atomicAdd(m.cnt + d[u].lj, 1 + d[u].ii);
      if (one_round && (d[u].ii || d[u].jj)) prefetch_slot(a, u * T + tid);
    }
  }
  if (p0) {
    atomicAdd(m.cnt + l0, 1);
    prefetch_l1(a.ap + 9 * (size_t)tid);
    prefetch_l1(a.ap + 9 * (size_t)tid + 8);
    prefetch_l1(a.rp + 3 * (size_t)tid);
  }
  for (int q = tid + T; q < a.n_pri; q += T)
    if (prior_in(a, q)) atomicAdd(m.cnt + a.lp[q], 1);
  __syncthreads();
  int total;
  {
    const int chunk = (n + T - 1) / T;
    const int r0 = min(tid * chunk, n), r1 = min(r0 + chunk, n);
    int mine = 0;
    for (int r = r0; r < r1; ++r) mine += m.cnt[r];
    int at = ndtpu::pg::block_exclusive_scan(mine, &total, m.scr);
    for (int r = r0; r < r1; ++r) {
      const int c = m.cnt[r];
      m.base[r] = at;
      m.cnt[r] = at;                                   // the cursor
      at += c;
    }
    if (tid == 0) m.base[n] = total;
  }
  const bool small = total <= kSmallE;
  // The workers read nothing in the small mode: they may go at once.
  if (small && tid == 0)
    asm volatile("st.relaxed.gpu.global.u32 [%0], %1;" :: "l"(a.ctl + 2),
                 "r"(2) : "memory");
  int2* list = small ? m.list : a.list;
  __syncthreads();
  if (!small)
    for (int r = tid; r <= n; r += T) a.off[r] = m.base[r];
  for (int base = 0; base < K; base += kU * T) {
    if (!one_round) load_round(a, base, d);
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int s = base + u * T + tid;
      if (d[u].ii) {
        const int at = atomicAdd(m.cnt + d[u].li, 1 + d[u].jj);
        list[at] = make_int2(d[u].li, 4 * s);
        if (d[u].jj) list[at + 1] = make_int2(d[u].lj, 4 * s + 1);
        if (small) m.rowof[at] = m.rowof[at + d[u].jj] = d[u].li;
      }
      if (d[u].jj) {
        const int at = atomicAdd(m.cnt + d[u].lj, 1 + d[u].ii);
        list[at] = make_int2(d[u].lj, 4 * s + 2);
        if (d[u].ii) list[at + 1] = make_int2(d[u].li, 4 * s + 3);
        if (small) m.rowof[at] = m.rowof[at + d[u].ii] = d[u].lj;
      }
    }
  }
  for (int q = tid; q < a.n_pri; q += T) {
    const bool in = q == tid ? p0 : prior_in(a, q);
    if (!in) continue;
    const int l = q == tid ? l0 : (int)a.lp[q];
    const int at = atomicAdd(m.cnt + l, 1);
    list[at] = make_int2(l, 4 * K + q);
    if (small) m.rowof[at] = l;
  }
  __syncthreads();                     // every bucket and offset stored
  if (!small) {
    if (tid == 0) release_u32(a.ctl + 2, 1);
    return;
  }

  // The small mode. The workers' count, read early and checked after the
  // terms; each contribution's terms and its place in its row.
  unsigned zeroed = 0;
  if (tid == 0)
    asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];"
                 : "=r"(zeroed) : "l"(a.ctl + 3) : "memory");
  const int k4 = 4 * K;
  for (int e0 = 0; e0 < total; e0 += kU * T) {
    float g[kU][9], h[kU][9], v[kU][3];
    int2 me[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int e = e0 + u * T + tid;
      me[u] = e < total ? m.list[e] : make_int2(0, -1);
      if (me[u].y < 0) continue;
      const float *ga, *gb, *res;
      contribution(a, me[u].y, &ga, &gb, &res);
#pragma unroll
      for (int k = 0; k < 9; ++k) {
        g[u][k] = ga[k];
        h[u][k] = gb[k];
      }
#pragma unroll
      for (int k = 0; k < 3; ++k) v[u][k] = res[k];
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      if (me[u].y < 0) continue;
      const int e = e0 + u * T + tid;
      float* out = m.vals + 12 * e;
      ndtpu::pg::mtm3(g[u], h[u], out);
      if (own_block(me[u].y, k4)) ndtpu::pg::mtv3(g[u], v[u], out + 9);
      const int r = m.rowof[e];
      const unsigned long long key = entry_key(me[u]);
      int rank = 0;
      for (int k = m.base[r]; k < m.base[r + 1]; ++k)
        rank += entry_key(m.list[k]) < key;
      m.order[m.base[r] + rank] = e;
    }
  }
  // Zeros of b for the empty rows; h_ii's rows are the workers' to zero.
  for (int r = tid; r < n; r += T)
    if (m.base[r + 1] == m.base[r])
#pragma unroll
      for (int k = 0; k < 3; ++k) a.b[3 * r + k] = 0.f;
  if (tid == 0 && zeroed != gridDim.x - 1u)
    wait_u32(a.ctl + 3, [&](unsigned c) { return c == gridDim.x - 1u; },
             false);
  if (tid == 0) asm volatile("fence.acq_rel.gpu;" ::: "memory");
  __syncthreads();
  const int n3 = 3 * n;
  for (int p = tid; p < total; p += T) {
    const int e = m.order[p];
    const int r = m.rowof[e], col = m.list[e].x;
    if (p != m.base[r] && m.list[m.order[p - 1]].x == col) continue;
    float acc[9] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    float acc3[3] = {0.f, 0.f, 0.f};
    for (int k = p; k < m.base[r + 1]; ++k) {
      const int ek = m.order[k];
      const int2 c = m.list[ek];
      if (c.x != col) break;
      const float* t = m.vals + 12 * ek;
#pragma unroll
      for (int j = 0; j < 9; ++j) acc[j] = acc[j] + t[j];
      if (own_block(c.y, k4))
#pragma unroll
        for (int j = 0; j < 3; ++j) acc3[j] = acc3[j] + t[9 + j];
    }
    float* hb = a.h + (size_t)3 * r * n3 + 3 * (size_t)col;
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) hb[(size_t)i * n3 + j] = acc[3 * i + j];
    if (col == r)
#pragma unroll
      for (int j = 0; j < 3; ++j) a.b[3 * r + j] = acc3[j];
  }
}

// One warp: the bucket at [o, o + m) sorted by key = (column block, code), so
// each column block's contributions are adjacent and in code order, i.e.
// in the order of the slots, side i before side j, the own block before
// the cross block, the priors last. Each rank counts the smaller keys
// (the codes are distinct).
__device__ void sort_row(const AsmArgs& a, int o, int m) {
  const int lane = threadIdx.x & 31;
  const int2* in = a.list + o;
  for (int e0 = 0; e0 < m; e0 += 32) {
    const int e = e0 + lane;
    const int2 mine = e < m ? __ldcg(in + e) : make_int2(-1, -1);
    const unsigned long long key = e < m ? entry_key(mine) : ~0ull;
    int rank = 0;
    for (int d0 = 0; d0 < m; d0 += 32) {
      const unsigned long long kd =
          d0 == e0 ? key
                   : (d0 + lane < m ? entry_key(__ldcg(in + d0 + lane))
                                    : ~0ull);
#pragma unroll
      for (int j = 0; j < 32; ++j)
        rank += __shfl_sync(0xffffffffu, kd, j) < key;
    }
    if (e < m) a.sorted[o + rank] = mine;
  }
  __syncwarp();
}

// One warp: row `row`'s column blocks and b rows from its sorted bucket,
// 32 places at a time. A group (one column block) starts where the column
// changes; its head lane sums the group's lanes in order, carrying a group
// that runs on into the next 32 places. Each sum starts at 0 and adds in
// the plain kernel's order, own blocks' A^T r only into b.
__device__ void sum_row(const AsmArgs& a, int row, int o, int m) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31, n3 = 3 * a.n, k4 = 4 * a.n_rows;
  float c9[9], c3[3];
  int carry_col = -1;
#pragma unroll
  for (int k = 0; k < 9; ++k) c9[k] = 0.f;
#pragma unroll
  for (int k = 0; k < 3; ++k) c3[k] = 0.f;
  for (int k0 = 0; k0 < m; k0 += 32) {
    const bool valid = k0 + lane < m;
    const int2 e = valid ? __ldcg(a.sorted + o + k0 + lane)
                         : make_int2(-1, -1);
    const int col = e.x;
    const bool own = valid && own_block(e.y, k4);
    float v9[9], v3[3] = {0.f, 0.f, 0.f};
#pragma unroll
    for (int k = 0; k < 9; ++k) v9[k] = 0.f;
    if (valid) {
      const float *ga, *gb, *res;
      contribution(a, e.y, &ga, &gb, &res);
      ndtpu::pg::mtm3(ga, gb, v9);
      if (own) ndtpu::pg::mtv3(ga, res, v3);
    }
    int prev = __shfl_up_sync(full, col, 1);
    if (lane == 0) prev = carry_col;
    const bool start = valid && col != prev;
    const bool head = valid && (start || lane == 0);
    const unsigned bounds = __ballot_sync(full, start || !valid);
    const unsigned later = lane == 31 ? 0u : bounds & (~0u << (lane + 1));
    const int len = later ? __ffs(later) - 1 - lane : 32 - lane;
    float acc[9], acc3[3];
#pragma unroll
    for (int k = 0; k < 9; ++k) acc[k] = (start ? 0.f : c9[k]) + v9[k];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      acc3[k] = start ? 0.f : c3[k];
      if (own) acc3[k] = acc3[k] + v3[k];
    }
    const int longest = __reduce_max_sync(full, head ? len : 0);
    for (int j = 1; j < longest; ++j) {
      const bool take = head && j < len;
      const bool take3 = __shfl_down_sync(full, (int)own, j) && take;
#pragma unroll
      for (int k = 0; k < 9; ++k) {
        const float x = __shfl_down_sync(full, v9[k], j);
        if (take) acc[k] = acc[k] + x;
      }
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const float x = __shfl_down_sync(full, v3[k], j);
        if (take3) acc3[k] = acc3[k] + x;
      }
    }
    // The group reaching place k0 + 31 runs on when place k0 + 32 has its
    // column: carry it to the next round instead of writing it.
    const int next_col = k0 + 32 < m ? __ldcg(a.sorted + o + k0 + 32).x : -1;
    const bool cont = head && lane + len == 32 && next_col == col;
    const unsigned cm = __ballot_sync(full, cont);
    if (head && !cont) {
      float* hb = a.h + (size_t)3 * row * n3 + 3 * (size_t)col;
#pragma unroll
      for (int p = 0; p < 3; ++p)
#pragma unroll
        for (int q = 0; q < 3; ++q) hb[(size_t)p * n3 + q] = acc[3 * p + q];
      if (col == row)
#pragma unroll
        for (int k = 0; k < 3; ++k) a.b[3 * row + k] = acc3[k];
    }
    carry_col = -1;
    if (cm) {
      const int src = __ffs(cm) - 1;
#pragma unroll
      for (int k = 0; k < 9; ++k) c9[k] = __shfl_sync(full, acc[k], src);
#pragma unroll
      for (int k = 0; k < 3; ++k) c3[k] = __shfl_sync(full, acc3[k], src);
      carry_col = __shfl_sync(full, col, src);
    }
  }
}

// Zero a warp's 3 rows of h_ii ([9n] floats from `z`) in 16-byte stores
// where aligned.
__device__ void zero_rows(float* z, int len) {
  const int lane = threadIdx.x & 31;
  int head = (int)(((16 - ((uintptr_t)z & 15)) & 15) / 4);
  head = min(head, len);
  if (lane < head) z[lane] = 0.f;
  float4* z4 = reinterpret_cast<float4*>(z + head);
  const int n4 = (len - head) / 4;
  for (int i = lane; i < n4; i += 32) z4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i = head + 4 * n4 + lane; i < len; i += 32) z[i] = 0.f;
}

// One launch of 1 + ceil(n / kAsmRows) blocks. Each block takes a ticket
// on entry: the first (ticket 0) is the build block; the others own
// kAsmRows rows each, one warp per row. A worker zeroes its rows of h_ii
// (16-byte stores) and counts itself done, then waits for the build
// block's release (the build block is running: it took its ticket
// first). In the small mode that is all: the build block, after every
// worker has counted itself done, writes the column blocks and b. Past
// it each worker's warps sort their buckets and write their column blocks
// and b. The last block to finish resets the kept counters to 0 for the
// next launch.
__global__ void __launch_bounds__(kAsmThreads)
local_assemble_kernel(AsmArgs a) {
  extern __shared__ int smem_a[];
  __shared__ int ticket;
  const int tid = threadIdx.x, warp = tid >> 5;
  if (tid == 0) ticket = atomicAdd(a.ctl, 1);
  __syncthreads();
  if (ticket == 0) {
    build_and_sum(a, carve(smem_a, a.n));
  } else {
    const int row = (ticket - 1) * kAsmRows + warp;
    if (row < a.n)
      zero_rows(a.h + (size_t)9 * a.n * row, 9 * a.n);
    __syncthreads();
    if (tid == 0) {
      __threadfence();                 // the zeros, then the count
      atomicAdd(a.ctl + 3, 1);
    }
    const unsigned mode = wait_u32(a.ctl + 2, [](unsigned v) {
      return v != 0u;
    });
    if (mode == 1 && row < a.n) {
      const int o = __ldcg(a.off + row), m = __ldcg(a.off + row + 1) - o;
      if (m == 0) {
        if ((tid & 31) < 3) a.b[3 * row + (tid & 31)] = 0.f;
      } else {
        sort_row(a, o, m);
        sum_row(a, row, o, m);
      }
    }
  }
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    if (atomicAdd(a.ctl + 1, 1) == (int)gridDim.x - 1) {
      a.ctl[0] = 0;
      a.ctl[1] = 0;
      a.ctl[2] = 0;
      a.ctl[3] = 0;
    }
  }
}

// The kernels' shared-memory limits, raised once per larger size.
size_t g_select_staged_opt_in = 48 * 1024;
size_t g_select_unstaged_opt_in = 48 * 1024;
size_t g_assemble_opt_in = 48 * 1024;

}  // namespace

// scratch: null for the shared route (n_pose <= kSelMaxPoses and
// n_fac <= kSelMaxChunk x kSelThreads), else the scratch route's 8 V + 2 F
// bytes, 4-byte aligned. Both run one block of kSelThreads (1,024 measured
// fastest at 1,024, 10,064 and 25,064 pose slots against 256 and 512).
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
  if (!global && (n_pose > kSelMaxPoses ||
                  n_fac > kSelMaxChunk * kSelThreads))
    return (int)cudaErrorInvalidValue;
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
  cudaStream_t st = (cudaStream_t)stream;
  if (global) {
    local_select_scratch_kernel<<<1, kSelThreads, 0, st>>>(a);
    return (int)cudaGetLastError();
  }
  // The staged layout where it fits a block, else the endpoints stay in
  // the graph (select_smem(n_pose, n_fac, 0) fits any n_pose <=
  // kSelMaxPoses at n_fac <= 1,024 kSelMaxChunk).
  size_t smem = select_smem(n_pose, n_fac, 1);
  int err = ndtpu::pg::smem_opt_in(local_select_shared_kernel<true>, smem,
                                   &g_select_staged_opt_in);
  if (err == 0) {
    local_select_shared_kernel<true><<<1, kSelThreads, smem, st>>>(a);
    return (int)cudaGetLastError();
  }
  if (err != ndtpu::pg::kSmemOver) return err;
  smem = select_smem(n_pose, n_fac, 0);
  err = ndtpu::pg::smem_opt_in(local_select_shared_kernel<false>, smem,
                               &g_select_unstaged_opt_in);
  if (err != 0) return err;
  local_select_shared_kernel<false><<<1, kSelThreads, smem, st>>>(a);
  return (int)cudaGetLastError();
}

// scratch: assemble_scratch(n_rows, n_pri, n) int32 (list, sorted, off),
// allocated per call; ctl: four int32 kept at 0 between launches on one
// stream (every launch's last block resets them).
extern "C" int local_assemble_launch(
    const void* ai, const void* aj, const void* r, int n_rows,
    const void* ap, const void* rp, int n_pri, const void* f_sel,
    const void* ri, const void* li, const void* rj, const void* lj,
    const void* p_act, const void* p_role, const void* lp, int n, void* h,
    void* b, void* scratch, void* ctl, void* stream) {
  if (n < 1 || n_rows < 0 || n_pri < 0 || scratch == nullptr ||
      ctl == nullptr)
    return (int)cudaErrorInvalidValue;
  const size_t smem = assemble_smem(n);
  const int err = ndtpu::pg::smem_opt_in(local_assemble_kernel, smem,
                                         &g_assemble_opt_in);
  if (err != 0) return err;
  const size_t cap = 4 * (size_t)n_rows + n_pri;
  int* sc = (int*)scratch;
  AsmArgs a{(const float*)ai, (const float*)aj, (const float*)r,
            n_rows, (const float*)ap, (const float*)rp, n_pri,
            (const uint8_t*)f_sel, (const long long*)ri,
            (const long long*)li, (const long long*)rj,
            (const long long*)lj, (const uint8_t*)p_act,
            (const long long*)p_role, (const long long*)lp, n,
            (int2*)sc, (int2*)(sc + 2 * cap), sc + 4 * cap, (int*)ctl,
            (float*)h, (float*)b};
  const int blocks = 1 + (n + kAsmRows - 1) / kAsmRows;
  local_assemble_kernel<<<blocks, kAsmThreads, smem,
                          (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
