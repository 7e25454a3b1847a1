// K16 refresh_points: the top-M map refresh's points for S sessions in one
// launch: each session's M stalest keyframes and their scans at the pose
// the map saw them at and at their smoothed pose.
//
// Replaces what XLA lowered for the TPU from ndtpu/slam/pipeline.py::
// _refresh_map (:141-159: the staleness, lax.top_k, the masks and the two
// se2.transforms before its one weighted add_points), vmapped over the
// sessions at ndtpu/dist/slam_dp.py:403-409.
//
// One block per session s. The staleness of slot i: dx = kf.x - mkp.x,
// d_xy = sqrt(dx dx + dy dy), d_th = |wrap(kf.th - mkp.th)| (se2.cuh: the
// plain version's bits on the card), stale = live ? max(d_xy, d_th) : 0
// (torch.maximum: a NaN wins). Staleness is non-negative, so its float
// bits order like the values, and the 64-bit key (bits << 32 | cap - 1 -
// i) orders the slots as lax.top_k does: the largest values first, equal
// values in index order (the plain version's stable descending sort). A
// slot's rank is the number of larger keys. Each warp takes 32 slots at a
// time and keeps as candidates those with fewer than M larger keys among
// its 32 (shuffles); every slot of the top M is a candidate, and the M
// largest keys all are, so a candidate's rank among the candidates is its
// rank where that is below M, and M or more otherwise. The candidates'
// keys go to shared memory (at most min(M, 32) of each warp's 32), each
// candidate counts the larger keys there, and rank m < M is sel[m]. Then
// per selected keyframe do = (stale > eps) & enable, its row
// (kf.poses[sel]) and the cos / sin of both poses, and per beam the two
// world points (se2.transform's order: c px - s py + x, s px + c py + y),
// the mask masks[sel] & live[sel] & do for both halves, and the weights
// -1 / +1.
//
// What bounds it on Hopper: launch and latency. At serving's 8 x 512
// slots, M = 12 and N = 360 it reads ~0.4 MB (25 B a slot, 9 B a
// selected beam) and writes ~0.9 MB (13 B a point of 2 M N), ~0.4 us at
// HBM rate; a block's passes (the warps' 32 shuffles a slot, the
// candidates' counts, at most 192^2 compares at cap 512, the points) and
// their three barriers set its time. Shared memory: 8 B a candidate and
// 41 B a selected keyframe (refresh_smem in kernels/__init__.py), at most
// what a block can opt in to.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "pose_graph.cuh"
#include "se2.cuh"

namespace {

constexpr int kThreads = 512;

struct RefreshArgs {
  // In: the S stores and the poses their maps saw; enable null: all.
  const float* kf_poses;   // [S, cap, 3]
  const bool* kf_live;     // [S, cap]
  const float2* points;    // [S, cap, N]
  const bool* masks;       // [S, cap, N]
  const float* mkp;        // [S, cap, 3]
  const bool* enable;      // [S]
  // Out.
  float2* both;            // [S, 2 M N]
  bool* bmsk;              // [S, 2 M N]
  float* wts;              // [S, 2 M N]
  long long* sel;          // [S, M]
  bool* on;                // [S, M]: do
  float* rows;             // [S, M, 3]: kf.poses[sel]
};

struct Dims {
  int cap, m, n;
  float eps;
};

// torch.maximum on floats: a NaN operand wins.
__device__ __forceinline__ float nan_max(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return fmaxf(a, b);
}

// The candidate slots a store of cap slots can have: the top M of each
// warp's 32.
__host__ __device__ __forceinline__ int max_candidates(int cap, int m) {
  const int per_warp = m < 32 ? m : 32;
  const long long n = (long long)((cap + 31) / 32) * per_warp;
  return n < cap ? (int)n : cap;
}

__global__ void __launch_bounds__(kThreads)
refresh_points_kernel(RefreshArgs a, Dims d) {
  extern __shared__ unsigned long long s_key[];   // the candidates' keys
  __shared__ int s_count;
  const int n_max = max_candidates(d.cap, d.m);
  int* s_sel = reinterpret_cast<int*>(s_key + n_max);        // [M]
  float* s_val = reinterpret_cast<float*>(s_sel + d.m);      // [M]
  float* s_tf = s_val + d.m;                                 // [M][8]
  unsigned char* s_on = reinterpret_cast<unsigned char*>(s_tf + 8 * d.m);
  const int s = blockIdx.x, t = threadIdx.x, lane = t & 31;
  const long long store = (long long)s * d.cap;
  if (t == 0) s_count = 0;
  __syncthreads();

  // Staleness keys, and each warp's candidates; the loop is uniform over a
  // warp, so the shuffles see every lane.
  for (int i0 = 0; i0 < d.cap; i0 += kThreads) {
    const int i = i0 + t;
    const bool valid = i < d.cap;
    unsigned long long key = 0;
    if (valid) {
      const float* p = a.kf_poses + 3 * (store + i);
      const float* q = a.mkp + 3 * (store + i);
      const float dx = p[0] - q[0];
      const float dy = p[1] - q[1];
      const float dxy = sqrtf(dx * dx + dy * dy);
      const float dth = fabsf(ndtpu::se2::wrap(p[2] - q[2]));
      const float st = a.kf_live[store + i] ? nan_max(dxy, dth) : 0.0f;
      key = ((unsigned long long)__float_as_uint(st) << 32)
            | (unsigned int)(d.cap - 1 - i);
    }
    int above = 0;
    for (int l = 0; l < 32; ++l) {
      const unsigned long long o = __shfl_sync(0xffffffffu, key, l);
      const int ov = __shfl_sync(0xffffffffu, (int)valid, l);
      above += (ov && o > key) ? 1 : 0;
    }
    const bool cand = valid && above < d.m;
    const unsigned int ball = __ballot_sync(0xffffffffu, cand);
    int base = 0;
    if (lane == 0 && ball != 0u) base = atomicAdd(&s_count, __popc(ball));
    base = __shfl_sync(0xffffffffu, base, 0);
    if (cand) s_key[base + __popc(ball & ((1u << lane) - 1u))] = key;
  }
  __syncthreads();

  const int n = s_count;
  for (int c = t; c < n; c += kThreads) {
    const unsigned long long k = s_key[c];
    int rank = 0;
    for (int j = 0; j < n; ++j) rank += s_key[j] > k ? 1 : 0;
    if (rank < d.m) {
      s_sel[rank] = d.cap - 1 - (int)(k & 0xffffffffULL);
      s_val[rank] = __uint_as_float((unsigned int)(k >> 32));
    }
  }
  __syncthreads();

  const bool en = a.enable == nullptr || a.enable[s];
  for (int m = t; m < d.m; m += kThreads) {
    const int i = s_sel[m];
    const bool on = s_val[m] > d.eps && en;
    const long long o = (long long)s * d.m + m;
    a.sel[o] = i;
    a.on[o] = on;
    s_on[m] = on && a.kf_live[store + i];
    const float* q = a.mkp + 3 * (store + i);
    const float* p = a.kf_poses + 3 * (store + i);
    float* tf = s_tf + 8 * m;
    tf[0] = cosf(q[2]);
    tf[1] = sinf(q[2]);
    tf[2] = q[0];
    tf[3] = q[1];
    tf[4] = cosf(p[2]);
    tf[5] = sinf(p[2]);
    tf[6] = p[0];
    tf[7] = p[1];
    a.rows[3 * o] = p[0];
    a.rows[3 * o + 1] = p[1];
    a.rows[3 * o + 2] = p[2];
  }
  __syncthreads();

  const int mn = d.m * d.n;
  const long long out = 2LL * mn * s;
  for (int e = t; e < mn; e += kThreads) {
    const int m = e / d.n;
    const long long src = (store + s_sel[m]) * d.n + (e - m * d.n);
    const float2 pt = a.points[src];
    const bool mk = a.masks[src] && s_on[m];
    const float* tf = s_tf + 8 * m;
    a.both[out + e] = make_float2(tf[0] * pt.x - tf[1] * pt.y + tf[2],
                                  tf[1] * pt.x + tf[0] * pt.y + tf[3]);
    a.both[out + mn + e] = make_float2(tf[4] * pt.x - tf[5] * pt.y + tf[6],
                                       tf[5] * pt.x + tf[4] * pt.y + tf[7]);
    a.bmsk[out + e] = mk;
    a.bmsk[out + mn + e] = mk;
    a.wts[out + e] = -1.0f;
    a.wts[out + mn + e] = 1.0f;
  }
}

size_t g_opt_in = 48 * 1024;

}  // namespace

// ptrs: the 12 addresses of RefreshArgs in its order (enable null: every
// session). s sessions of cap slots, m <= cap selected a session, n beams a
// scan, m n < 2^30; smem: 8 B a candidate (max_candidates) + 41 m bytes,
// rounded up to 16 (the wrapper's refresh_smem). Returns kSmemOver past
// what a block can opt in to.
extern "C" int refresh_points_launch(const long long* ptrs, int s, int cap,
                                     int m, int n, float eps, int smem,
                                     void* stream) {
  if (s < 1 || cap < 1 || m < 1 || m > cap || n < 1
      || (long long)m * n >= (1LL << 30)
      || smem < 8 * max_candidates(cap, m) + 41 * m)
    return (int)cudaErrorInvalidValue;
  RefreshArgs a;
  static_assert(sizeof(RefreshArgs) == 12 * sizeof(void*), "RefreshArgs");
  const void** p = reinterpret_cast<const void**>(&a);
  for (int i = 0; i < 12; ++i) p[i] = reinterpret_cast<const void*>(ptrs[i]);
  const int err = ndtpu::pg::smem_opt_in(refresh_points_kernel, (size_t)smem,
                                         &g_opt_in);
  if (err != 0) return err;
  refresh_points_kernel<<<s, kThreads, smem, (cudaStream_t)stream>>>(
      a, Dims{cap, m, n, eps});
  return (int)cudaGetLastError();
}
