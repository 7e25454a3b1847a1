// K15 loop_lanes: the loop verify's set-up, the candidate search of Q = S K
// queries over their sessions' keyframe stores and everything the gated
// lm_ndt takes for the Q C lanes, in one launch.
//
// Replaces what XLA lowered for the TPU from
// ndtpu/loop/closure.py::find_candidates (:101-119: one masked distance
// vector over the store and lax.top_k) and the lane set-up of
// verify_candidates_cached_flat (:285-291: init = se2.between(kf.poses[idx],
// query_pose), the K C broadcast query scans with verify_beam_stride),
// which run inside detect_loops_cached_flat's one program, vmapped over the
// sessions in serving (ndtpu/dist/slam_dp.py:362).
//
// The grid is Q x (1 + ceil(C / lpb)): block (q, 0) searches for query q
// (session s = q / K), block (q, 1 + b) writes the copies of the query's
// scan for lanes b lpb .. (b + 1) lpb - 1 (lpb: as many lanes as a block's
// 256 threads cover, a thread per 16-byte unit of a lane's row).
//
// The search. For every slot i of the session's store, d = sqrt(dx dx + dy
// dy) (dx = kf.x - query.x, as the plain version), ok = live & d <= radius
// & query_index - i >= min_index_gap, and the 64-bit key (float bits of ok
// ? d : +inf) << 32 | i. For non-negative floats the bit patterns order
// like the values, and the slot makes every key unique, so the C smallest
// keys in order are the C nearest qualifying keyframes with equal
// distances in index order, then, where fewer qualify, the lowest-index
// others with mask false: lax.top_k's order and the plain version's stable
// sort's. Each of the 8 warps streams its share of the store, 32 slots a
// round (four rounds at 1,024 slots, loaded together), and keeps its C
// smallest keys so far as a sorted list in shared memory: a round's keys
// below the list's C-th (a ballot; once the list is full most rounds have
// none) are ranked among themselves by 32 independent shuffles and placed
// at their rank (the first round) or merged into the list by position (an
// entry's place is its own index plus the count of the other side's
// smaller keys, a binary search), the list double-buffered,
// __syncwarp only.
// Every key of the C smallest overall is among its warp's C smallest, so
// after one barrier a candidate's rank is its place in its warp's list
// plus the count of smaller keys in the other warps' lists: the count of
// smaller keys in every list, its own included (branch-free binary
// searches of a fixed probe count, so that the eight overlap; the
// candidate's keyframe pose loaded before them), and the
// thread that ranks a candidate below C writes it at its rank with its
// lane's init and group. A caller may give the candidates instead
// (cand_idx / cand_mask, no search), and may ask for the search alone
// (init == null, no lanes).
//
// The lanes: lane (q, c) gets init = se2.between(kf.poses[s, idx], the
// query's pose) (se2.cuh, the plain version's bits on the card) and group
// = s cap + idx (int32: the row of the flat [S cap, R, L] table cache that
// lm_ndt reads, and the candidate index its gate takes); query_idx[q] =
// query_index + s cap, so the gate's innovation gap |query_idx - group| is
// the session's own. The query's scan at every stride-th beam as px, py
// and a float mask does not depend on the search, so the lane blocks
// write it at once, four beams a thread in 16-byte stores where the rows
// allow it. The query's scan is read through sel (its row in the window),
// so the caller gathers nothing.
//
// What bounds it on Hopper: launch and latency. Its bytes are ~13 B a slot
// read per query and 12 B a beam written per lane (~0.33 MB at config 3:
// 4 queries x 1,024 slots, 64 lanes x 360 beams), ~0.1 us at HBM rate; the
// search block's dependent steps (the query's and the slots' loads, a
// round's shuffles, the candidates' binary searches, one barrier, the
// lanes' se2) set its time, while the lane blocks write the scans. Shared
// memory: two lists of C keys a warp (128 C B: 16 KB at C = 128) and
// 2 KB, whatever the store; stores up to kMaxSlots
// (kernels.LOOP_LANES_MAX_CAP).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "se2.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxLanes = 128;       // C: kernels.GATE_MAX_LANES
constexpr int kMaxSlots = 16384;     // kernels.LOOP_LANES_MAX_CAP
constexpr int kAhead = 4;            // rounds a warp loads at once
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kNone = ~0ULL;   // above every slot's key

struct LanesArgs {
  // In: the stores, the windows' scans and poses, each query's row in its
  // window and its index; the given candidates (null: search).
  const float* kf_poses;        // [S, cap, 3]
  const bool* kf_live;          // [S, cap]
  const float2* points;         // [S, W, N]
  const bool* mask;             // [S, W, N]
  const float* poses;           // [S, W, 3]
  const long long* sel;         // [S, K]
  const long long* query_index; // [S, K]
  const long long* cand_idx;    // [S, K, C]
  const bool* cand_mask;        // [S, K, C]
  // Out: the candidates (search only), then the lanes (null: none).
  long long* idx;               // [S, K, C]
  bool* cmask;                  // [S, K, C]
  float* dist;                  // [S, K, C]
  float* init;                  // [S K C, 3]
  int* group;                   // [S K C]
  long long* query_idx;         // [S K]
  float* px;                    // [S K C, n_out]
  float* py;
  float* mask_f;
};

struct Dims {
  int k, c, w, n, cap, stride, n_out;
  int units;                    // a lane row's units: n_out / 4 or n_out
  int lpb;                      // lanes a lane block writes
  bool vec;                     // px, py, mask_f rows in 16-byte stores
  float radius;
  long long min_gap;
};

// Slot i's key from its keyframe's (x, y) and live flag, for the query at
// (qx, qy) of index qi.
__device__ __forceinline__ unsigned long long slot_key(
    const Dims& d, int i, float x, float y, bool live, float qx, float qy,
    long long qi) {
  const float dx = x - qx;
  const float dy = y - qy;
  const float dd = sqrtf(dx * dx + dy * dy);
  const bool ok = live && dd <= d.radius && qi - i >= d.min_gap;
  const float dm = ok ? dd : INFINITY;
  return ((unsigned long long)__float_as_uint(dm) << 32) | (unsigned)i;
}

// The entries of the ascending list[0, n) below key, n <= kMaxLanes: a
// branch-free binary search of a fixed count of probes, so that
// independent searches overlap.
__device__ __forceinline__ int below(const unsigned long long* list, int n,
                                     unsigned long long key) {
  int lo = 0;
#pragma unroll
  for (int step = kMaxLanes; step > 0; step >>= 1)
    if (lo + step <= n && list[lo + step - 1] < key) lo += step;
  return lo;
}

// Lane o's init (the query in the frame of the keyframe at kp) and group.
__device__ __forceinline__ void lane_pose(const LanesArgs& a, long long o,
                                          const float* kp, long long group,
                                          const float* qp) {
  ndtpu::se2::between(kp, qp, a.init + 3 * o);
  a.group[o] = (int)group;
}

// Block (q, 0): the search (or the given candidates), each candidate's
// lane init and group where it is placed.
__device__ void search_block(const LanesArgs& a, const Dims& d, int q,
                             long long store, const float* qp, long long qi) {
  extern __shared__ unsigned long long s_list[];  // [2][kWarps][C]
  __shared__ unsigned long long s_new[kWarps][32];
  __shared__ int s_cur[kWarps], s_fill[kWarps];
  const int t = threadIdx.x, c = d.c;
  const bool lanes = a.init != nullptr;
  if (t == 0 && lanes) a.query_idx[q] = qi + store;
  if (a.cand_idx != nullptr) {
    for (int j = t; j < c; j += kThreads) {
      const long long o = (long long)q * c + j, i = a.cand_idx[o];
      const long long ic = i < 0 ? 0 : (i >= d.cap ? d.cap - 1 : i);
      lane_pose(a, o, a.kf_poses + 3 * (store + ic), store + i, qp);
    }
    return;
  }
  // Each warp's running C smallest keys, `fill` of them, in list `cur`.
  const int warp = t >> 5, lane = t & 31;
  unsigned long long* mine[2] = {s_list + warp * c,
                                 s_list + (kWarps + warp) * c};
  const float qx = qp[0], qy = qp[1];
  constexpr int kRound = 32 * kWarps;
  int cur = 0, fill = 0;
  unsigned long long thr = kNone;   // the list's C-th key once it is full
  for (int b0 = warp * 32; b0 < d.cap; b0 += kAhead * kRound) {
    // The batch's slots, loaded before any of its keys is needed.
    float x[kAhead], y[kAhead];
    bool live[kAhead];
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      const int i = b0 + k * kRound + lane;
      if (i < d.cap) {
        const float* p = a.kf_poses + 3 * (store + i);
        x[k] = p[0];
        y[k] = p[1];
        live[k] = a.kf_live[store + i];
      }
    }
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      const int i = b0 + k * kRound + lane;
      const unsigned long long key =
          i < d.cap ? slot_key(d, i, x[k], y[k], live[k], qx, qy, qi) : kNone;
      const bool in = key < thr;
      const unsigned m = __ballot_sync(kFull, in);
      if (m == 0u) continue;
      int r = 0;   // rank among the round's keys that enter
#pragma unroll
      for (int l = 0; l < 32; ++l) {
        const unsigned long long z = __shfl_sync(kFull, key, l);
        r += ((m >> l) & 1u) && z < key;
      }
      const int n_in = __popc(m);
      const unsigned long long* old = mine[cur];
      unsigned long long* out = mine[cur ^ 1];
      if (fill == 0) {
        if (in && r < c) out[r] = key;
      } else {
        if (in) s_new[warp][r] = key;
        __syncwarp();
        if (in) {
          const int pos = r + below(old, fill, key);
          if (pos < c) out[pos] = key;
        }
        for (int j = lane; j < fill; j += 32) {
          const unsigned long long e = old[j];
          const int pos = j + below(s_new[warp], n_in, e);
          if (pos < c) out[pos] = e;
        }
      }
      __syncwarp();
      cur ^= 1;
      fill = fill + n_in < c ? fill + n_in : c;
      thr = fill == c ? out[c - 1] : kNone;
    }
  }
  if (lane == 0) {
    s_cur[warp] = cur;
    s_fill[warp] = fill;
  }
  __syncthreads();
  // Each candidate's rank: its place in its list plus the smaller keys of
  // the other lists; its keyframe's pose read before the searches.
  for (int u = t; u < kWarps * c; u += kThreads) {
    const int w = u / c, j = u - w * c;
    if (j >= s_fill[w]) continue;
    const unsigned long long e = s_list[(s_cur[w] * kWarps + w) * c + j];
    const long long i = (long long)(e & 0xffffffffULL);
    float kp[3];
    if (lanes)
      for (int k = 0; k < 3; ++k) kp[k] = a.kf_poses[3 * (store + i) + k];
    // Its own list counts j below it (keys are unique): no branch, so the
    // kWarps searches are independent.
    int rank = 0;
#pragma unroll
    for (int v = 0; v < kWarps; ++v)
      rank += below(s_list + (s_cur[v] * kWarps + v) * c, s_fill[v], e);
    if (rank < c) {
      const float dm = __uint_as_float((unsigned)(e >> 32));
      const long long o = (long long)q * c + rank;
      a.idx[o] = i;
      a.cmask[o] = isfinite(dm);
      a.dist[o] = dm;
      if (lanes) lane_pose(a, o, kp, store + i, qp);
    }
  }
}

// Block (q, 1 + b): lanes b lpb .. (b + 1) lpb - 1's rows of the query's
// scan at every stride-th beam, a thread a unit (four beams in 16-byte
// stores where the rows allow it, else one).
__device__ void lane_block(const LanesArgs& a, const Dims& d, int q,
                           long long scan) {
  const float2* pts = a.points + scan * d.n;
  const bool* msk = a.mask + scan * d.n;
  const int t = threadIdx.x;
  const int per = d.lpb > 1 ? d.units : kThreads;   // threads a lane
  const int c = (blockIdx.y - 1) * d.lpb + t / per;
  if (t / per >= d.lpb || c >= d.c) return;
  const long long row = ((long long)q * d.c + c) * d.n_out;
  for (int v = t % per; v < d.units; v += per) {
    if (d.vec) {
      float x[4], y[4], f[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const long long src = (long long)(4 * v + k) * d.stride;
        const float2 p = pts[src];
        x[k] = p.x;
        y[k] = p.y;
        f[k] = msk[src] ? 1.0f : 0.0f;
      }
      reinterpret_cast<float4*>(a.px + row)[v] = make_float4(x[0], x[1],
                                                             x[2], x[3]);
      reinterpret_cast<float4*>(a.py + row)[v] = make_float4(y[0], y[1],
                                                             y[2], y[3]);
      reinterpret_cast<float4*>(a.mask_f + row)[v] = make_float4(
          f[0], f[1], f[2], f[3]);
    } else {
      const long long src = (long long)v * d.stride;
      const float2 p = pts[src];
      a.px[row + v] = p.x;
      a.py[row + v] = p.y;
      a.mask_f[row + v] = msk[src] ? 1.0f : 0.0f;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
loop_lanes_kernel(LanesArgs a, Dims d) {
  const int q = blockIdx.x;
  const int s = q / d.k;
  long long row = a.sel[q];
  row = row < 0 ? 0 : (row >= d.w ? d.w - 1 : row);
  const long long scan = (long long)s * d.w + row;
  if (blockIdx.y == 0)
    search_block(a, d, q, (long long)s * d.cap, a.poses + 3 * scan,
                 a.query_index[q]);
  else
    lane_block(a, d, q, scan);
}

}  // namespace

// ptrs: the 18 addresses of LanesArgs in its order (cand_idx / cand_mask
// null to search, init .. mask_f null for the search alone, idx .. dist
// null with given candidates). q = S K queries of k a session, c <= 128
// candidates, a store of cap slots (c <= cap <= 16,384), windows of w scans
// of n beams, n_out = ceil(n / stride).
extern "C" int loop_lanes_launch(const long long* ptrs, int q, int k, int c,
                                 int w, int n, int cap, int stride,
                                 int n_out, float radius, long long min_gap,
                                 void* stream) {
  if (q < 1 || k < 1 || q % k != 0 || c < 1 || c > kMaxLanes || w < 1
      || n < 1 || cap < c || cap > kMaxSlots || stride < 1
      || n_out != (n + stride - 1) / stride)
    return (int)cudaErrorInvalidValue;
  LanesArgs a;
  static_assert(sizeof(LanesArgs) == 18 * sizeof(void*), "LanesArgs");
  const void** p = reinterpret_cast<const void**>(&a);
  for (int i = 0; i < 18; ++i) p[i] = reinterpret_cast<const void*>(ptrs[i]);
  const bool lanes = a.init != nullptr;
  const bool vec = lanes && n_out % 4 == 0
                   && ((uintptr_t)a.px | (uintptr_t)a.py
                       | (uintptr_t)a.mask_f) % 16 == 0;
  const int units = vec ? n_out / 4 : n_out;
  const int lpb = units < kThreads ? kThreads / units : 1;
  const size_t smem = a.cand_idx == nullptr
                      ? 2 * kWarps * (size_t)c * sizeof(unsigned long long)
                      : 0;
  const dim3 grid(q, lanes ? 1 + (c + lpb - 1) / lpb : 1);
  loop_lanes_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      a, Dims{k, c, w, n, cap, stride, n_out, units, lpb, vec, radius,
              min_gap});
  return (int)cudaGetLastError();
}
