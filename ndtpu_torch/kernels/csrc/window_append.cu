// K14 window_append: a window's masked appends to the pose graph, the
// keyframe store and the map's keyframe poses, for S sessions in one launch.
//
// Replaces what XLA lowered for the TPU from
// ndtpu/slam/pipeline.py::_wb_appends (:361-475 without the local-table
// build and the loop verify): the keyframe slots (a cumsum over the
// window's keyframe flags), the governing and parent keyframes (a running
// max of keyframe scan indices), the node values anchored on the smoothed
// last keyframe, the odometry measurements, the odometry sqrt-information
// (graph/factors.py:127, the closed-form 3x3 Cholesky of 0.5 (H + H^T) +
// 1e-3 I), and ONE masked scatter per array, `.at[where(ok, slot,
// big)].set(v, mode="drop")` (:419-440); with it _wb_extend's write of
// map_kf_poses (:556). Two more entry points: the loop factors' append
// (:464-490: the accepted lanes' slots, their bet_* rows, n_between and the
// per-scan counts) and a masked row write (_refresh_map's map_kf_poses,
// :161).
//
// Every entry point is functional, as the JAX scatters are: it writes new
// arrays, each a copy of its input with the appended rows substituted, so
// no caller's state changes under it (the port's graph.poses, kf.poses and
// map_kf_poses alias one another at times).
//
// Layout of the append and loop entries: one grid row (blockIdx.y) per
// session. The appended rows of each array are one contiguous range that
// starts at a counter known at launch (n_poses, n_between or kf.n) and
// holds at most W rows (the loop entry: its K C lanes), its window; only
// the window waits for the window table. So the first blocks of a session
// own one array's window each: warp 0 computes the table (W <= 32 scans,
// one lane a scan: ballots give cum, the kept flags, the scans, parents
// and slots; the loop entry: the accepted lanes' ranks by ballots), its
// threads read the window's input rows (eight 16-byte units a thread in
// flight), one barrier, and the block writes the window's rows, each from
// the table (or the window's scans) where appended and from the input
// otherwise. (Reading the input before warp 0's table as well, with the
// table inlined after the reads, cost registers that the copy blocks of
// the same kernel need: 96 a thread and a 544-byte stack frame, about 2 x
// slower; measured.)
// Only the owners whose rows need the se2 arithmetic (graph poses with the
// aux, bet_z, bet_sqrt_info, kf.poses) run it before their barrier; the
// owners of the scans, masks, indices and map poses start after the
// ballots. The loop entry's per-scan counts (nl, ld, ni) are one more
// block's: its lanes' flags and queries read before the ranks are ready,
// then shared-memory atomics per scan. The other blocks copy the two
// untouched ranges of every array at once, with no barrier but one for
// their span table: a persistent grid over 16 KB chunks of the ranges
// (kBlocksPerSm a multiprocessor), 16-byte vectors, four in flight a
// thread, 32-bit offsets inside a chunk, and no division per element. The
// se2 arithmetic is the plain version's, op for op, as PyTorch runs it on
// the card (se2.cuh), so its values are the plain version's bits there.
//
// The row entry: a block's rows hold the last kept index that names them
// (a table in shared memory filled by atomicMax); the index's thread
// writes the row it won and the element threads the others, every global
// read issued before the table's barriers.
//
// What bounds it on Hopper: bytes. The keyframe scans dominate (8 B of
// points and 1 B of mask a beam and keyframe slot, read once and written
// once: ~6.6 MB a window at 1,024 slots x 360 beams); the chunked copy
// keeps 64 B in flight a thread to approach HBM's rate, and the window
// owners' dependent loads and arithmetic (~2-3 us from launch) overlap it.

#include <cuda_runtime.h>
#include <stdint.h>

#include "pose_graph.cuh"
#include "se2.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxWindow = 32;
constexpr int kBatch = 4;                        // units in flight a thread
constexpr int kChunk = 16 * kBatch * kThreads;   // bytes a block copies: 16 KB
constexpr int kBlocksPerSm = 4;
constexpr int kWinBatch = 8;                     // window units a thread
constexpr int kAppendArrays = 12;
constexpr int kLoopArrays = 5;
constexpr unsigned kFull = 0xffffffffu;
using ndtpu::se2::between;
using ndtpu::se2::compose;

// ---------------------------------------------------------------- copying

// n units from src to dst by the block's threads, kBatch loads in flight
// before their stores.
template <typename U>
__device__ __forceinline__ void copy_units(U* __restrict__ dst,
                                           const U* __restrict__ src, int n) {
  for (int u0 = threadIdx.x; u0 < n; u0 += kBatch * kThreads) {
    U v[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b)
      if (u0 + b * kThreads < n) v[b] = src[u0 + b * kThreads];
#pragma unroll
    for (int b = 0; b < kBatch; ++b)
      if (u0 + b * kThreads < n) dst[u0 + b * kThreads] = v[b];
  }
}

// n bytes from src to dst by the block: in the widest unit (up to 16 B)
// that both addresses share modulo 16, the bytes before the first such
// address of dst and after the last one singly.
__device__ void copy_bytes(char* dst, const char* src, int n) {
  const unsigned mis = (unsigned)(((uintptr_t)dst ^ (uintptr_t)src) & 15u);
  const int unit = mis == 0 ? 16 : (int)(mis & (0u - mis));
  int head = (int)((unsigned)(unit - ((uintptr_t)dst & (unit - 1)))
                   & (unsigned)(unit - 1));
  if (head > n) head = n;
  const int body = (n - head) / unit;
  for (int i = threadIdx.x; i < head; i += kThreads) dst[i] = src[i];
  char* d = dst + head;
  const char* s = src + head;
  switch (unit) {
    case 16: copy_units((uint4*)d, (const uint4*)s, body); break;
    case 8: copy_units((uint2*)d, (const uint2*)s, body); break;
    case 4: copy_units((unsigned*)d, (const unsigned*)s, body); break;
    case 2: copy_units((unsigned short*)d, (const unsigned short*)s, body);
      break;
    default: copy_units((unsigned char*)d, (const unsigned char*)s, body);
  }
  for (int i = head + body * unit + threadIdx.x; i < n; i += kThreads)
    dst[i] = src[i];
}

// One session's array: rows of rb bytes; its window is rows [lo, lo + win).
struct Arr {
  char* dst;
  const char* src;
  long long rows, lo;
  int rb;
};

__device__ __forceinline__ Arr arr(void* dst, const void* src, int s,
                                   long long rows, int rb, long long lo) {
  const long long at = (long long)s * rows * rb;
  return Arr{(char*)dst + at, (const char*)src + at, rows,
             lo < 0 ? 0 : (lo > rows ? rows : lo), rb};
}

// Blocks first .. gridDim.x - 1 of a session: the kArrays arrays of
// array_of(i) outside their windows of win rows, two spans an array, in
// chunks of kChunk bytes over the blocks.
template <int kArrays, class ArrayOf>
__device__ void copy_outside(ArrayOf array_of, long long win, int first) {
  constexpr int kSpans = 2 * kArrays;
  static_assert(kSpans <= 32, "one lane a span");
  __shared__ char* s_dst[kSpans];
  __shared__ const char* s_src[kSpans];
  __shared__ long long s_len[kSpans];
  __shared__ int s_end[kSpans];   // chunks of spans 0 .. i
  if (threadIdx.x < 32) {
    const int i = threadIdx.x;
    int chunks = 0;
    if (i < kSpans) {
      const Arr r = array_of(i >> 1);
      const long long hi = r.rows - r.lo < win ? r.rows : r.lo + win;
      const long long b0 = (i & 1) ? hi * r.rb : 0;
      const long long b1 = (i & 1) ? r.rows * r.rb : r.lo * r.rb;
      s_dst[i] = r.dst + b0;
      s_src[i] = r.src + b0;
      s_len[i] = b1 - b0;
      chunks = (int)((b1 - b0 + kChunk - 1) / kChunk);
    }
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, chunks, o);
      if (i >= o) chunks += y;
    }
    if (i < kSpans) s_end[i] = chunks;
  }
  __syncthreads();
  const int total = s_end[kSpans - 1];
  int span = 0, start = 0;
  for (int g = blockIdx.x - first; g < total; g += gridDim.x - first) {
    while (g >= s_end[span]) start = s_end[span++];
    const long long off = (long long)(g - start) * kChunk;
    const long long left = s_len[span] - off;
    copy_bytes(s_dst[span] + off, s_src[span] + off,
               (int)(left < kChunk ? left : kChunk));
  }
}

// The window's rows (dst and src at its first row, rb bytes a row, rows of
// them), in units of U: each thread reads its first kWinBatch units from
// src before the block's barrier (warp 0's table is ready after it), then
// rows j < *count take app + (pick ? pick[j] : j) stride instead.
template <typename U>
__device__ void window_units(char* dst, const char* src, int rows, int rb,
                             const int* count, const char* app,
                             const int* pick, int stride) {
  const int per = rb / (int)sizeof(U), n = rows * per;
  const int t = threadIdx.x;
  U v[kWinBatch];
#pragma unroll
  for (int b = 0; b < kWinBatch; ++b) {
    const int u = t + b * kThreads;
    if (u < n) v[b] = reinterpret_cast<const U*>(src)[u];
  }
  __syncthreads();
  const int k = *count;
  auto from = [&](int u) -> U {
    const int j = u / per;
    return reinterpret_cast<const U*>(
        app + (long long)(pick ? pick[j] : j) * stride)[u - j * per];
  };
#pragma unroll
  for (int b = 0; b < kWinBatch; ++b) {
    const int u = t + b * kThreads;
    if (u < n && u / per < k) v[b] = from(u);
  }
#pragma unroll
  for (int b = 0; b < kWinBatch; ++b) {
    const int u = t + b * kThreads;
    if (u < n) reinterpret_cast<U*>(dst)[u] = v[b];
  }
  for (int u = t + kWinBatch * kThreads; u < n; u += kThreads)
    reinterpret_cast<U*>(dst)[u] = u / per < k
        ? from(u) : reinterpret_cast<const U*>(src)[u];
}

// A block's array window: rows [lo, lo + win) within the array, the first
// *count of them appended from app (see window_units), in the widest unit
// every address and row stride allows. Holds the block's barrier, between
// its reads of the input and of the appended rows.
__device__ void copy_window(const Arr& r, long long win, const int* count,
                            const void* app, const int* pick, int stride) {
  const long long hi = r.rows - r.lo < win ? r.rows : r.lo + win;
  char* dst = r.dst + r.lo * r.rb;
  const char* src = r.src + r.lo * r.rb;
  const char* ap = (const char*)app;
  const int rows = (int)(hi - r.lo);
  const unsigned al = (unsigned)(((uintptr_t)dst | (uintptr_t)src
                                  | (uintptr_t)ap | (unsigned)r.rb
                                  | (unsigned)stride) & 15u);
  if (al == 0)
    window_units<uint4>(dst, src, rows, r.rb, count, ap, pick, stride);
  else if ((al & 7u) == 0)
    window_units<uint2>(dst, src, rows, r.rb, count, ap, pick, stride);
  else if ((al & 3u) == 0)
    window_units<unsigned>(dst, src, rows, r.rb, count, ap, pick, stride);
  else if ((al & 1u) == 0)
    window_units<unsigned short>(dst, src, rows, r.rb, count, ap, pick,
                                 stride);
  else
    window_units<unsigned char>(dst, src, rows, r.rb, count, ap, pick,
                                stride);
}

// ------------------------------------------------------------ the appends

// torch.clamp(x, min=lo): NaN stays NaN.
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x != x ? x : fmaxf(x, lo);
}

// pipeline._odom_info_sqrt: factors.info_to_sqrt_info(0.5 (H + H^T) +
// 1e-3 I), row-major upper-triangular R.
__device__ __forceinline__ void odom_sqrt_info(const float* hm, float* r) {
  float a[3][3];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      a[i][j] = 0.5f * (hm[3 * i + j] + hm[3 * j + i])
                + (i == j ? 1e-3f : 0.0f);
  const float l11 = sqrtf(clamp_min(a[0][0], 1e-12f));
  const float l21 = a[1][0] / l11;
  const float l31 = a[2][0] / l11;
  const float l22 = sqrtf(clamp_min(a[1][1] - l21 * l21, 1e-12f));
  const float l32 = (a[2][1] - l31 * l21) / l22;
  const float l33 = sqrtf(clamp_min(a[2][2] - l31 * l31 - l32 * l32,
                                    1e-12f));
  r[0] = l11; r[1] = l21; r[2] = l31;
  r[3] = 0.0f; r[4] = l22; r[5] = l32;
  r[6] = 0.0f; r[7] = 0.0f; r[8] = l33;
}

struct AppendArgs {
  // In, per session: the graph, the keyframe store, the map's keyframe
  // poses, the last keyframe (graph index, registration-time pose) and the
  // window (poses, Hessians, scans, keyframe flags).
  const float* g_poses; const bool* pose_mask;
  const long long* bet_i; const long long* bet_j; const float* bet_z;
  const float* bet_sqrt; const bool* bet_mask;
  const long long* n_poses; const long long* n_between;
  const float* kf_poses; const float2* kf_points; const bool* kf_masks;
  const bool* kf_live; const long long* kf_n; const float* mkp;
  const long long* last_kf_idx; const float* last_kf_reg;
  const float* poses; const float* hess; const float2* pts; const bool* msk;
  const bool* is_kf;
  // Out: the same arrays with the window's rows, the counters, and the
  // window's aux.
  float* o_g_poses; bool* o_pose_mask;
  long long* o_bet_i; long long* o_bet_j; float* o_bet_z; float* o_bet_sqrt;
  bool* o_bet_mask; long long* o_n_poses; long long* o_n_between;
  float* o_kf_poses; float2* o_kf_points; bool* o_kf_masks; bool* o_kf_live;
  long long* o_kf_n; float* o_mkp;
  long long* slot; bool* ok; long long* cum; long long* kslot;
  float* node_vals; long long* last_idx; float* lkr; bool* any_kf;
  long long* kf_idx_out; float* rel_out; int* nd_out;
};

struct Dims { int w, v, f, k, n, m; };

// Array i of session s: graph poses, pose mask, bet_i, bet_j, bet_z,
// bet_sqrt_info, bet_mask (windows at n_poses / n_between), kf poses,
// points, masks, live, map_kf_poses (at kf.n).
__device__ __forceinline__ Arr append_array(const AppendArgs& a,
                                            const Dims& d, int s, int i,
                                            long long n0, long long nb0,
                                            long long kn0) {
  switch (i) {
    case 0: return arr(a.o_g_poses, a.g_poses, s, d.v, 12, n0);
    case 1: return arr(a.o_pose_mask, a.pose_mask, s, d.v, 1, n0);
    case 2: return arr(a.o_bet_i, a.bet_i, s, d.f, 8, nb0);
    case 3: return arr(a.o_bet_j, a.bet_j, s, d.f, 8, nb0);
    case 4: return arr(a.o_bet_z, a.bet_z, s, d.f, 12, nb0);
    case 5: return arr(a.o_bet_sqrt, a.bet_sqrt, s, d.f, 36, nb0);
    case 6: return arr(a.o_bet_mask, a.bet_mask, s, d.f, 1, nb0);
    case 7: return arr(a.o_kf_poses, a.kf_poses, s, d.k, 12, kn0);
    case 8: return arr(a.o_kf_points, a.kf_points, s, d.k, 8 * d.n, kn0);
    case 9: return arr(a.o_kf_masks, a.kf_masks, s, d.k, d.n, kn0);
    case 10: return arr(a.o_kf_live, a.kf_live, s, d.k, 1, kn0);
    default: return arr(a.o_mkp, a.mkp, s, d.m, 12, kn0);
  }
}

__global__ void __launch_bounds__(kThreads)
window_append_kernel(AppendArgs a, Dims d) {
  const int s = blockIdx.y;
  const long long n0 = a.n_poses[s], nb0 = a.n_between[s], kn0 = a.kf_n[s];
  if (blockIdx.x >= kAppendArrays) {
    copy_outside<kAppendArrays>(
        [&](int i) { return append_array(a, d, s, i, n0, nb0, kn0); }, d.w,
        kAppendArrays);
    return;
  }
  // The window's kept keyframes by rank (slot - n_poses): their scan,
  // node value, odometry measurement, sqrt-information, parent and slot.
  // Only the owners of the graph poses (and the aux), bet_z, bet_sqrt_info
  // and kf.poses need the se2 arithmetic; the others start their copy
  // after the ballots.
  __shared__ int s_scan[kMaxWindow];
  __shared__ float s_node[kMaxWindow][3], s_z[kMaxWindow][3];
  __shared__ float s_r[kMaxWindow][9];
  __shared__ long long s_parent[kMaxWindow], s_slot[kMaxWindow];
  __shared__ int s_knew, s_nfok;
  __shared__ bool s_true;
  const bool heavy = blockIdx.x == 0 || blockIdx.x == 4 || blockIdx.x == 5
                     || blockIdx.x == 7;
  if (threadIdx.x < 32) {
    const int w = threadIdx.x;
    const bool live = w < d.w;
    const long long last = a.last_kf_idx[s];
    const bool kf = live && a.is_kf[(long long)s * d.w + w];
    const unsigned kfb = __ballot_sync(kFull, kf);
    const unsigned upto = (unsigned)((2ull << w) - 1ull);   // bits 0..w
    const int cum = __popc(kfb & upto);
    const long long slot = n0 + cum - 1;
    const bool ok = kf && slot < d.v;
    const unsigned okb = __ballot_sync(kFull, ok);
    const int knew = __popc(okb);
    const long long fslot = nb0 + cum - 1;
    const bool fok = ok && fslot < d.f;
    const int nfok = __popc(__ballot_sync(kFull, fok));
    if (ok) {
      const int j = cum - 1;
      s_scan[j] = w;
      s_parent[j] = cum > 1 ? n0 + cum - 2 : last;
      s_slot[j] = slot;
    }
    if (w == 0) {
      s_knew = knew;
      s_nfok = nfok;
      s_true = true;
    }
    if (heavy) {
      // Governing keyframe (last kept at or before w) and parent (before
      // w): their registration poses from their lanes.
      const unsigned g_bits = okb & upto, p_bits = okb & (upto >> 1);
      const int gov = g_bits ? 31 - __clz(g_bits) : -1;
      const int pgov = p_bits ? 31 - __clz(p_bits) : -1;
      const float* lkr = a.last_kf_reg + 3LL * s;
      const float* wp = a.poses + ((long long)s * d.w + w) * 3;
      float pw[3] = {0.0f, 0.0f, 0.0f}, anchor_reg[3], parent_reg[3];
      if (live)
        for (int c = 0; c < 3; ++c) pw[c] = wp[c];
      for (int c = 0; c < 3; ++c) {
        const float g = __shfl_sync(kFull, pw[c], gov < 0 ? 0 : gov);
        const float pg = __shfl_sync(kFull, pw[c], pgov < 0 ? 0 : pgov);
        anchor_reg[c] = gov >= 0 ? g : lkr[c];
        parent_reg[c] = pgov >= 0 ? pg : lkr[c];
      }
      if (live) {
        // graph.poses[last_kf_idx], clamped as JAX's gather.
        const long long li = last < 0 ? 0 : (last >= d.v ? d.v - 1 : last);
        const float* an = a.g_poses + ((long long)s * d.v + li) * 3;
        const float anchor_node[3] = {an[0], an[1], an[2]};
        float b[3], node[3], z[3], rel[3], r[9];
        between(lkr, pw, b);
        compose(anchor_node, b, node);
        between(parent_reg, pw, z);
        between(anchor_reg, pw, rel);
        odom_sqrt_info(a.hess + ((long long)s * d.w + w) * 9, r);
        if (ok) {
          const int j = cum - 1;
          for (int c = 0; c < 3; ++c) {
          s_node[j][c] = node[c];
          s_z[j][c] = z[c];
        }
          for (int c = 0; c < 9; ++c) s_r[j][c] = r[c];
        }
        if (blockIdx.x == 0) {
          const long long o = (long long)s * d.w + w;
          const int cum_ok = __popc(okb & upto);
          a.slot[o] = slot;
          a.ok[o] = ok;
          a.cum[o] = cum;
          a.kslot[o] = kn0 + cum - 1;
          a.kf_idx_out[o] = cum_ok > 0 ? n0 + cum_ok - 1 : last;
          a.nd_out[o] = (int)(kf && !ok) + (int)(ok && !fok);
          for (int c = 0; c < 3; ++c) {
            a.node_vals[3 * o + c] = node[c];
            a.rel_out[3 * o + c] = rel[c];
          }
          if (w == d.w - 1)
            for (int c = 0; c < 3; ++c) a.lkr[3 * s + c] = anchor_reg[c];
        }
      }
    }
    if (w == 0 && blockIdx.x == 0) {
      a.o_n_poses[s] = n0 + knew;
      a.o_n_between[s] = nb0 + nfok;
      a.o_kf_n[s] = kn0 + knew;
      a.last_idx[s] = knew > 0 ? n0 + knew - 1 : last;
      a.any_kf[s] = kfb != 0u;
    }
  }
  // Block i writes array i's window: the appended rows from the table, the
  // window's poses or its scans (by the kept keyframe's scan), or true.
  const int i = blockIdx.x;
  const Arr r = append_array(a, d, s, i, n0, nb0, kn0);
  const int* count = (i >= 2 && i <= 6) ? &s_nfok : &s_knew;
  const long long wscan = (long long)s * d.w;
  switch (i) {
    case 0: case 7:
      copy_window(r, d.w, count, s_node, nullptr, 12); break;
    case 2: copy_window(r, d.w, count, s_parent, nullptr, 8); break;
    case 3: copy_window(r, d.w, count, s_slot, nullptr, 8); break;
    case 4: copy_window(r, d.w, count, s_z, nullptr, 12); break;
    case 5: copy_window(r, d.w, count, s_r, nullptr, 36); break;
    case 8: copy_window(r, d.w, count, a.pts + wscan * d.n, s_scan, 8 * d.n);
      break;
    case 9: copy_window(r, d.w, count, a.msk + wscan * d.n, s_scan, d.n);
      break;
    case 11: copy_window(r, d.w, count, a.poses + 3 * wscan, s_scan, 12);
      break;
    default: copy_window(r, d.w, count, &s_true, nullptr, 0);
  }
}

// ------------------------------------------------------ the loop entry

struct LoopArgs {
  // In, per session: the factor arrays and count, and the window's loop
  // lanes (K queries x C candidates): accepted (already masked by the
  // detect cadence), candidate index, measurement and sqrt-information,
  // innovation-rejected; per query its graph slot, scan and presence.
  const long long* bet_i; const long long* bet_j; const float* bet_z;
  const float* bet_sqrt; const bool* bet_mask; const long long* n_between;
  const bool* accept; const long long* lj; const float* lz;
  const float* lsqrt; const bool* innov; const long long* slot_k;
  const long long* sel; const bool* has;
  // Out: the factor arrays and count, and per scan of the window the loops
  // appended, dropped at factor capacity, and innovation-rejected.
  long long* o_bet_i; long long* o_bet_j; float* o_bet_z; float* o_bet_sqrt;
  bool* o_bet_mask; long long* o_n_between; int* nl; int* ld; int* ni;
};

struct LoopDims { int f, kq, c, w; };

__device__ __forceinline__ Arr loop_array(const LoopArgs& a,
                                          const LoopDims& d, int s, int i,
                                          long long nb0) {
  switch (i) {
    case 0: return arr(a.o_bet_i, a.bet_i, s, d.f, 8, nb0);
    case 1: return arr(a.o_bet_j, a.bet_j, s, d.f, 8, nb0);
    case 2: return arr(a.o_bet_z, a.bet_z, s, d.f, 12, nb0);
    case 3: return arr(a.o_bet_sqrt, a.bet_sqrt, s, d.f, 36, nb0);
    default: return arr(a.o_bet_mask, a.bet_mask, s, d.f, 1, nb0);
  }
}

__global__ void __launch_bounds__(kThreads)
loop_append_kernel(LoopArgs a, LoopDims d) {
  const int s = blockIdx.y;
  const int lanes = d.kq * d.c;
  const long long nb0 = a.n_between[s];
  if (blockIdx.x > kLoopArrays) {
    copy_outside<kLoopArrays>(
        [&](int i) { return loop_array(a, d, s, i, nb0); }, lanes,
        kLoopArrays + 1);
    return;
  }
  // Blocks 0 .. kLoopArrays - 1 own a factor array's window, block
  // kLoopArrays the per-scan counts. Every one ranks the accepted lanes:
  // accepted rank -> lane and its query.
  extern __shared__ int s_dyn[];
  int* s_lane = s_dyn;
  int* s_query = s_dyn + lanes;
  int* s_cnt = s_dyn + 2 * lanes;   // [3][w]: appended, dropped, rejected
  __shared__ int s_nlok, s_acc;
  __shared__ bool s_true;
  const long long lbase = (long long)s * lanes;
  const bool counts = blockIdx.x == kLoopArrays;
  // The counting block reads its first lane's flags and query before the
  // ranks are ready.
  const int t0 = threadIdx.x;
  const long long qs0 = (long long)s * d.kq + (t0 < lanes ? t0 / d.c : 0);
  bool acc0 = false, inn0 = false, has0 = false;
  long long w0 = -1;
  if (counts && t0 < lanes) {
    acc0 = a.accept[lbase + t0];
    inn0 = a.innov[lbase + t0];
    has0 = a.has[qs0];
    w0 = a.sel[qs0];
  }
  if (threadIdx.x < 32) {
    int carry = 0;
    for (int b0 = 0; b0 < lanes; b0 += 32) {
      const int t = b0 + threadIdx.x;
      const bool acc = t < lanes && a.accept[lbase + t];
      const unsigned bits = __ballot_sync(kFull, acc);
      if (acc) {
        const int j = carry + __popc(bits & ((1u << threadIdx.x) - 1u));
        s_lane[j] = t;
        s_query[j] = t / d.c;
      }
      carry += __popc(bits);
    }
    if (threadIdx.x == 0) {
      const long long room = d.f - nb0;
      s_nlok = (int)(room <= 0 ? 0 : (carry < room ? carry : room));
      s_acc = carry;
      s_true = true;
    }
  }
  if (!counts) {
    const int i = blockIdx.x;
    const Arr r = loop_array(a, d, s, i, nb0);
    switch (i) {
      case 0: copy_window(r, lanes, &s_nlok, a.lj + lbase, s_lane, 8);
        break;
      case 1: copy_window(r, lanes, &s_nlok, a.slot_k + (long long)s * d.kq,
                          s_query, 8); break;
      case 2: copy_window(r, lanes, &s_nlok, a.lz + 3 * lbase, s_lane, 12);
        break;
      case 3: copy_window(r, lanes, &s_nlok, a.lsqrt + 9 * lbase, s_lane,
                          36); break;
      default: copy_window(r, lanes, &s_nlok, &s_true, nullptr, 0);
    }
    return;
  }
  for (int i = threadIdx.x; i < 3 * d.w; i += kThreads) s_cnt[i] = 0;
  __syncthreads();
  const int nlok = s_nlok;
  // Lanes from `cut` on were accepted past the factor capacity.
  const int cut = nlok < s_acc ? s_lane[nlok] : lanes;
  for (int t = t0; t < lanes; t += kThreads) {
    bool acc = acc0, inn = inn0, has = has0;
    long long w = w0;
    if (t != t0) {
      const long long qs = (long long)s * d.kq + t / d.c;
      acc = a.accept[lbase + t];
      inn = a.innov[lbase + t];
      has = a.has[qs];
      w = a.sel[qs];
    }
    if (!has || w < 0 || w >= d.w) continue;
    if (acc) atomicAdd(&s_cnt[(t < cut ? 0 : d.w) + w], 1);
    if (inn) atomicAdd(&s_cnt[2 * d.w + w], 1);
  }
  __syncthreads();
  const long long o = (long long)s * d.w;
  for (int w = threadIdx.x; w < d.w; w += kThreads) {
    a.nl[o + w] = s_cnt[w];
    a.ld[o + w] = s_cnt[d.w + w];
    a.ni[o + w] = s_cnt[2 * d.w + w];
  }
  if (threadIdx.x == 0) a.o_n_between[s] = nb0 + nlok;
}

// ------------------------------------------------------- the row entry

// out[s, r, :] = src[s, m, :] for the last m with ok[s, m] and idx[s, m]
// == r, else dst[s, r, :] (an index outside [0, R) writes nothing). Block
// x of session s takes rows [x rpb, (x + 1) rpb): a table of the last m
// naming each of its rows (atomicMax), then the index m's thread writes
// its row where it won it and the element threads the rows no m names.
// A thread's first kBatch elements and its first index (with its row of
// up to kRowCols values) are read before the table is built.
constexpr int kRowCols = 4;

__global__ void __launch_bounds__(kThreads)
rows_set_kernel(const float* __restrict__ dst, const long long* __restrict__ idx,
                const bool* __restrict__ ok, const float* __restrict__ src,
                float* __restrict__ out, int rows, int cols, int m,
                int rpb) {
  extern __shared__ int s_hit[];   // rpb: the last m naming the row, or -1
  const int s = blockIdx.y, t = threadIdx.x;
  const int r0 = blockIdx.x * rpb;
  const int nr = rows - r0 < rpb ? rows - r0 : rpb;
  const int n = nr * cols;
  const long long base = ((long long)s * rows + r0) * cols;
  const float* from = src + (long long)s * m * cols;
  float v[kBatch], row[kRowCols];
#pragma unroll
  for (int b = 0; b < kBatch; ++b)
    if (t + b * kThreads < n) v[b] = dst[base + t + b * kThreads];
  long long r_t = -1;   // this thread's first index's row in the block
  if (t < m) {
    const long long r = idx[(long long)s * m + t] - r0;
    if (ok[(long long)s * m + t] && r >= 0 && r < nr) r_t = r;
    if (cols <= kRowCols)
      for (int c = 0; c < cols; ++c) row[c] = from[(long long)t * cols + c];
  }
  for (int i = t; i < nr; i += kThreads) s_hit[i] = -1;
  __syncthreads();
  if (r_t >= 0) atomicMax(&s_hit[r_t], t);
  for (int q = t + kThreads; q < m; q += kThreads) {
    const long long r = idx[(long long)s * m + q] - r0;
    if (ok[(long long)s * m + q] && r >= 0 && r < nr) atomicMax(&s_hit[r], q);
  }
  __syncthreads();
#pragma unroll
  for (int b = 0; b < kBatch; ++b) {
    const int e = t + b * kThreads;
    if (e < n && s_hit[e / cols] < 0) out[base + e] = v[b];
  }
  for (int e = t + kBatch * kThreads; e < n; e += kThreads)
    if (s_hit[e / cols] < 0) out[base + e] = dst[base + e];
  if (r_t >= 0 && s_hit[r_t] == t)
    for (int c = 0; c < cols; ++c)
      out[base + r_t * cols + c] = cols <= kRowCols
          ? row[c] : from[(long long)t * cols + c];
  for (int q = t + kThreads; q < m; q += kThreads) {
    const long long r = idx[(long long)s * m + q] - r0;
    if (ok[(long long)s * m + q] && r >= 0 && r < nr && s_hit[r] == q)
      for (int c = 0; c < cols; ++c)
        out[base + r * cols + c] = from[(long long)q * cols + c];
  }
}

// Blocks a session for copying `bytes` in kChunk chunks, two spans an
// array more: at most kBlocksPerSm a multiprocessor over all sessions.
int copy_blocks(long long bytes, int spans, int sessions, int* out) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long chunks = bytes / kChunk + spans;
  long long room = (long long)kBlocksPerSm * sms / sessions;
  if (room < 1) room = 1;
  *out = (int)(chunks < room ? chunks : room);
  return 0;
}

size_t g_loop_opt_in = 48 * 1024;

}  // namespace

// ptrs: the 48 addresses of AppendArgs in its order. One block row per
// session; W <= 32.
extern "C" int window_append_launch(const long long* ptrs, int sessions,
                                    int w, int v, int f, int k, int n, int m,
                                    void* stream) {
  if (sessions < 1 || sessions > 65535 || w < 1 || w > kMaxWindow || v < 1
      || f < 1 || k < 1 || n < 1 || m < 1)
    return (int)cudaErrorInvalidValue;
  AppendArgs a;
  static_assert(sizeof(AppendArgs) == 48 * sizeof(void*), "AppendArgs");
  const void** p = reinterpret_cast<const void**>(&a);
  for (int i = 0; i < 48; ++i) p[i] = reinterpret_cast<const void*>(ptrs[i]);
  const long long bytes = 13LL * v + 65LL * f + (13LL + 9LL * n) * k
                          + 12LL * m;
  int blocks = 0;
  const int err = copy_blocks(bytes, 2 * kAppendArrays, sessions, &blocks);
  if (err != 0) return err;
  const dim3 grid(kAppendArrays + blocks, sessions);
  window_append_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      a, Dims{w, v, f, k, n, m});
  return (int)cudaGetLastError();
}

// ptrs: the 23 addresses of LoopArgs in its order; kq queries x c
// candidates a session (kq * c <= 12,288), w scans a window.
extern "C" int loop_append_launch(const long long* ptrs, int sessions, int f,
                                  int kq, int c, int w, void* stream) {
  if (sessions < 1 || sessions > 65535 || f < 1 || kq < 1 || c < 1 || w < 1
      || (long long)kq * c > 12288)
    return (int)cudaErrorInvalidValue;
  LoopArgs a;
  static_assert(sizeof(LoopArgs) == 23 * sizeof(void*), "LoopArgs");
  const void** p = reinterpret_cast<const void**>(&a);
  for (int i = 0; i < 23; ++i) p[i] = reinterpret_cast<const void*>(ptrs[i]);
  int blocks = 0;
  int err = copy_blocks(65LL * f, 2 * kLoopArrays, sessions, &blocks);
  if (err != 0) return err;
  const size_t smem = 4 * (2 * (size_t)kq * c + 3 * (size_t)w);
  err = ndtpu::pg::smem_opt_in(loop_append_kernel, smem, &g_loop_opt_in);
  if (err != 0) return err;
  const dim3 grid(kLoopArrays + 1 + blocks, sessions);
  loop_append_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      a, LoopDims{f, kq, c, w});
  return (int)cudaGetLastError();
}

// dst [S, R, C] f32, idx [S, M] int64, ok [S, M] bool, src [S, M, C] f32;
// out [S, R, C] f32.
extern "C" int rows_set_launch(const void* dst, const void* idx,
                               const void* ok, const void* src, void* out,
                               int sessions, int rows, int cols, int m,
                               void* stream) {
  if (sessions < 1 || sessions > 65535 || rows < 1 || cols < 1 || m < 0)
    return (int)cudaErrorInvalidValue;
  int rpb = kBatch * kThreads / cols;
  if (rpb < 1) rpb = 1;
  const dim3 grid((rows + rpb - 1) / rpb, sessions);
  rows_set_kernel<<<grid, kThreads, 4 * (size_t)rpb,
                    (cudaStream_t)stream>>>(
      (const float*)dst, (const long long*)idx, (const bool*)ok,
      (const float*)src, (float*)out, rows, cols, m, rpb);
  return (int)cudaGetLastError();
}
