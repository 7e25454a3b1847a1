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
// One block per query q (session s = q / K). The search: for every slot i
// of the session's store, d = sqrt(dx dx + dy dy) (dx = kf.x - query.x, as
// the plain version), ok = live & d <= radius & query_index - i >=
// min_index_gap, and the 64-bit key (float bits of ok ? d : +inf) << 32 | i
// in shared memory. For non-negative floats the bit patterns order like the
// values, so after a bitonic sort of the keys (ascending) the first C are
// the C nearest qualifying keyframes with equal distances in index order,
// then, where fewer qualify, the lowest-index others with mask false:
// lax.top_k's order and the plain version's stable sort's, lanes included.
// A caller may give the candidates instead (cand_idx / cand_mask, no
// search), and may ask for the search alone (init == null, no lanes).
//
// The lanes: lane (q, c) gets init = se2.between(kf.poses[s, idx], the
// query's pose) (se2.cuh, the plain version's bits on the card), group =
// s cap + idx (int32: the row of the flat [S cap, R, L] table cache that
// lm_ndt reads, and the candidate index its gate takes), and the query's
// scan at every stride-th beam as px, py and a float mask; query_idx[q] =
// query_index + s cap, so the gate's innovation gap |query_idx - group| is
// the session's own. The query's scan is read through sel (its row in the
// window), so the caller gathers nothing.
//
// What bounds it on Hopper: launch and latency. Its bytes are ~13 B a slot
// read per query and 12 B a beam written per lane (~0.33 MB at config 3:
// 4 queries x 1,024 slots, 64 lanes x 360 beams), ~0.1 us at HBM rate; a
// block's ~55 barrier-separated passes of the sort (cap 1,024) set its time.
// Shared memory: 8 B a slot of the store rounded up to a power of two, up to
// 16,384 slots (128 KB; loop_lanes_smem in kernels/__init__.py).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "pose_graph.cuh"
#include "se2.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kMaxLanes = 128;       // C: kernels.GATE_MAX_LANES
constexpr int kMaxSlots = 16384;     // cap rounded up to a power of two

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
  int k, c, w, n, cap, pow2, stride, n_out;
  float radius;
  long long min_gap;
};

__global__ void __launch_bounds__(kThreads)
loop_lanes_kernel(LanesArgs a, Dims d) {
  extern __shared__ unsigned long long s_key[];   // d.pow2 keys
  __shared__ long long s_idx[kMaxLanes];
  const int q = blockIdx.x;
  const int s = q / d.k;
  const int t = threadIdx.x;
  long long row = a.sel[q];
  row = row < 0 ? 0 : (row >= d.w ? d.w - 1 : row);
  const long long scan = (long long)s * d.w + row;
  const float* qp = a.poses + 3 * scan;
  const long long qi = a.query_index[q];
  const long long store = (long long)s * d.cap;

  if (a.cand_idx == nullptr) {
    const float qx = qp[0], qy = qp[1];
    for (int i = t; i < d.pow2; i += kThreads) {
      unsigned long long key = ~0ULL;
      if (i < d.cap) {
        const float* p = a.kf_poses + 3 * (store + i);
        const float dx = p[0] - qx;
        const float dy = p[1] - qy;
        const float dd = sqrtf(dx * dx + dy * dy);
        const bool ok = a.kf_live[store + i] && dd <= d.radius
                        && qi - i >= d.min_gap;
        const float dm = ok ? dd : INFINITY;
        key = ((unsigned long long)__float_as_uint(dm) << 32)
              | (unsigned int)i;
      }
      s_key[i] = key;
    }
    __syncthreads();
    // Bitonic sort, ascending: pass (k, j) compares each pair (lo, lo | j)
    // once, one comparator a thread.
    const int half = d.pow2 >> 1;
    for (int k = 2; k <= d.pow2; k <<= 1) {
      for (int j = k >> 1; j > 0; j >>= 1) {
        for (int u = t; u < half; u += kThreads) {
          const int lo = ((u & ~(j - 1)) << 1) | (u & (j - 1));
          const int hi = lo | j;
          const unsigned long long x = s_key[lo], y = s_key[hi];
          if ((x > y) == ((lo & k) == 0)) {
            s_key[lo] = y;
            s_key[hi] = x;
          }
        }
        __syncthreads();
      }
    }
    for (int c = t; c < d.c; c += kThreads) {
      const unsigned long long key = s_key[c];
      const float dm = __uint_as_float((unsigned int)(key >> 32));
      const long long i = (long long)(key & 0xffffffffULL);
      const long long o = (long long)q * d.c + c;
      a.idx[o] = i;
      a.cmask[o] = isfinite(dm);
      a.dist[o] = dm;
      s_idx[c] = i;
    }
  } else {
    for (int c = t; c < d.c; c += kThreads)
      s_idx[c] = a.cand_idx[(long long)q * d.c + c];
  }
  if (a.init == nullptr) return;
  __syncthreads();

  for (int c = t; c < d.c; c += kThreads) {
    const long long lane = (long long)q * d.c + c;
    const long long i = s_idx[c];
    const long long ic = i < 0 ? 0 : (i >= d.cap ? d.cap - 1 : i);
    ndtpu::se2::between(a.kf_poses + 3 * (store + ic), qp,
                        a.init + 3 * lane);
    a.group[lane] = (int)(store + i);
  }
  if (t == 0) a.query_idx[q] = qi + store;
  const float2* pts = a.points + scan * d.n;
  const bool* msk = a.mask + scan * d.n;
  const long long base = (long long)q * d.c * d.n_out;
  const int total = d.c * d.n_out;
  for (int e = t; e < total; e += kThreads) {
    const int j = e % d.n_out;
    const long long src = (long long)j * d.stride;
    const float2 p = pts[src];
    a.px[base + e] = p.x;
    a.py[base + e] = p.y;
    a.mask_f[base + e] = msk[src] ? 1.0f : 0.0f;
  }
}

size_t g_opt_in = 48 * 1024;

}  // namespace

// ptrs: the 18 addresses of LanesArgs in its order (cand_idx / cand_mask
// null to search, init .. mask_f null for the search alone, idx .. dist
// null with given candidates). q = S K queries of k a session, c <= 128
// candidates, a store of cap slots (pow2 = cap rounded up to a power of two,
// <= 16,384), windows of w scans of n beams, n_out = ceil(n / stride).
// Returns kSmemOver past what a block can opt in to.
extern "C" int loop_lanes_launch(const long long* ptrs, int q, int k, int c,
                                 int w, int n, int cap, int pow2, int stride,
                                 int n_out, float radius, long long min_gap,
                                 void* stream) {
  if (q < 1 || k < 1 || q % k != 0 || c < 1 || c > kMaxLanes || w < 1
      || n < 1 || cap < c || pow2 < cap || pow2 > kMaxSlots
      || (pow2 & (pow2 - 1)) != 0 || stride < 1
      || n_out != (n + stride - 1) / stride)
    return (int)cudaErrorInvalidValue;
  LanesArgs a;
  static_assert(sizeof(LanesArgs) == 18 * sizeof(void*), "LanesArgs");
  const void** p = reinterpret_cast<const void**>(&a);
  for (int i = 0; i < 18; ++i) p[i] = reinterpret_cast<const void*>(ptrs[i]);
  const bool search = a.cand_idx == nullptr;
  const size_t smem = search ? 8 * (size_t)pow2 : 0;
  const int err = ndtpu::pg::smem_opt_in(loop_lanes_kernel, smem, &g_opt_in);
  if (err != 0) return err;
  loop_lanes_kernel<<<q, kThreads, smem, (cudaStream_t)stream>>>(
      a, Dims{k, c, w, n, cap, pow2, stride, n_out, radius, min_gap});
  return (int)cudaGetLastError();
}
