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
// map_kf_poses alias one another at times). The appended rows are a
// contiguous range of each array (the slots of the kept keyframes are
// consecutive), so each output element finds its value by one subtraction:
// the rank of its row in the range selects the scan.
//
// Layout: one grid row (blockIdx.y) per session. Every block first computes
// its session's window table in warp 0 (W <= 32 scans, one lane a scan:
// ballots give cum, the kept flags and the governing keyframes), into
// shared memory; then the blocks of a session stride over its arrays' output
// elements. The se2 arithmetic is the plain version's, op for op, as
// PyTorch runs it on the card (se2.cuh), so its values are the plain
// version's bits there.
//
// What bounds it on Hopper: bytes. The keyframe scans dominate (8 B of
// points and 1 B of mask a beam and keyframe slot, read once and written
// once: ~6.6 MB a window at 1,024 slots x 360 beams).

#include <cuda_runtime.h>

#include "se2.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxWindow = 32;
using ndtpu::se2::between;
using ndtpu::se2::compose;

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

__global__ void __launch_bounds__(kThreads)
window_append_kernel(AppendArgs a, Dims d) {
  const int s = blockIdx.y;
  // The window's kept keyframes by rank (slot - n_poses): their scan,
  // node value, odometry measurement, sqrt-information, parent and slot.
  __shared__ int s_scan[kMaxWindow];
  __shared__ float s_node[kMaxWindow][3], s_z[kMaxWindow][3];
  __shared__ float s_r[kMaxWindow][9];
  __shared__ long long s_parent[kMaxWindow], s_slot[kMaxWindow];
  __shared__ int s_knew, s_nfok;
  const long long n0 = a.n_poses[s], nb0 = a.n_between[s], kn0 = a.kf_n[s];
  if (threadIdx.x < 32) {
    const int w = threadIdx.x;
    const bool live = w < d.w;
    const long long last = a.last_kf_idx[s];
    const bool kf = live && a.is_kf[(long long)s * d.w + w];
    const unsigned kfb = __ballot_sync(0xffffffffu, kf);
    const unsigned upto = (unsigned)((2ull << w) - 1ull);   // bits 0..w
    const int cum = __popc(kfb & upto);
    const long long slot = n0 + cum - 1;
    const bool ok = kf && slot < d.v;
    const unsigned okb = __ballot_sync(0xffffffffu, ok);
    const int knew = __popc(okb);
    const long long fslot = nb0 + cum - 1;
    const bool fok = ok && fslot < d.f;
    const int nfok = __popc(__ballot_sync(0xffffffffu, fok));
    // Governing keyframe (last kept at or before w) and parent (before w).
    const unsigned g_bits = okb & upto, p_bits = okb & (upto >> 1);
    const int gov = g_bits ? 31 - __clz(g_bits) : -1;
    const int pgov = p_bits ? 31 - __clz(p_bits) : -1;
    const float* lkr = a.last_kf_reg + 3LL * s;
    const float* wp = a.poses + (long long)s * d.w * 3;
    float anchor_reg[3], parent_reg[3];
    if (live) {
      for (int c = 0; c < 3; ++c) {
        anchor_reg[c] = gov >= 0 ? wp[3 * gov + c] : lkr[c];
        parent_reg[c] = pgov >= 0 ? wp[3 * pgov + c] : lkr[c];
      }
      const float pw[3] = {wp[3 * w], wp[3 * w + 1], wp[3 * w + 2]};
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
        s_scan[j] = w;
        s_parent[j] = cum > 1 ? n0 + cum - 2 : last;
        s_slot[j] = slot;
        for (int c = 0; c < 3; ++c) { s_node[j][c] = node[c]; s_z[j][c] = z[c]; }
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
    if (w == 0) {
      s_knew = knew;
      s_nfok = nfok;
      if (blockIdx.x == 0) {
        a.o_n_poses[s] = n0 + knew;
        a.o_n_between[s] = nb0 + nfok;
        a.o_kf_n[s] = kn0 + knew;
        a.last_idx[s] = knew > 0 ? n0 + knew - 1 : last;
        a.any_kf[s] = kfb != 0u;
      }
    }
  }
  __syncthreads();
  const int knew = s_knew, nfok = s_nfok;
  const long long t0 = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long step = (long long)gridDim.x * kThreads;
  // rank of row r in [lo, lo + count), or -1.
  auto rank = [](long long r, long long lo, int count) -> int {
    const long long j = r - lo;
    return (j >= 0 && j < count) ? (int)j : -1;
  };

  {  // graph.poses, pose_mask: rows n_poses + [0, k_new)
    const long long base = (long long)s * d.v;
    for (long long i = t0; i < 3LL * d.v; i += step) {
      const long long r = i / 3;
      const int j = rank(r, n0, knew);
      a.o_g_poses[3 * base + i] =
          j >= 0 ? s_node[j][i - 3 * r] : a.g_poses[3 * base + i];
    }
    for (long long r = t0; r < d.v; r += step)
      a.o_pose_mask[base + r] = rank(r, n0, knew) >= 0 || a.pose_mask[base + r];
  }
  {  // bet_*: rows n_between + [0, n_fok)
    const long long base = (long long)s * d.f;
    for (long long r = t0; r < d.f; r += step) {
      const int j = rank(r, nb0, nfok);
      a.o_bet_i[base + r] = j >= 0 ? s_parent[j] : a.bet_i[base + r];
      a.o_bet_j[base + r] = j >= 0 ? s_slot[j] : a.bet_j[base + r];
      a.o_bet_mask[base + r] = j >= 0 || a.bet_mask[base + r];
    }
    for (long long i = t0; i < 3LL * d.f; i += step) {
      const long long r = i / 3;
      const int j = rank(r, nb0, nfok);
      a.o_bet_z[3 * base + i] = j >= 0 ? s_z[j][i - 3 * r] : a.bet_z[3 * base + i];
    }
    for (long long i = t0; i < 9LL * d.f; i += step) {
      const long long r = i / 9;
      const int j = rank(r, nb0, nfok);
      a.o_bet_sqrt[9 * base + i] =
          j >= 0 ? s_r[j][i - 9 * r] : a.bet_sqrt[9 * base + i];
    }
  }
  {  // kf.poses, live, map_kf_poses: rows kf.n + [0, k_new)
    const long long base = (long long)s * d.k;
    for (long long i = t0; i < 3LL * d.k; i += step) {
      const long long r = i / 3;
      const int j = rank(r, kn0, knew);
      a.o_kf_poses[3 * base + i] =
          j >= 0 ? s_node[j][i - 3 * r] : a.kf_poses[3 * base + i];
    }
    for (long long r = t0; r < d.k; r += step)
      a.o_kf_live[base + r] = rank(r, kn0, knew) >= 0 || a.kf_live[base + r];
    const long long mbase = (long long)s * d.m;
    const float* wp = a.poses + (long long)s * d.w * 3;
    for (long long i = t0; i < 3LL * d.m; i += step) {
      const long long r = i / 3;
      const int j = rank(r, kn0, knew);
      a.o_mkp[3 * mbase + i] =
          j >= 0 ? wp[3 * s_scan[j] + (i - 3 * r)] : a.mkp[3 * mbase + i];
    }
  }
  {  // kf.points, masks: rows kf.n + [0, k_new), one beam an element
    const long long base = (long long)s * d.k * d.n;
    const long long wbase = (long long)s * d.w * d.n;
    const long long total = (long long)d.k * d.n;
    for (long long i = t0; i < total; i += step) {
      const long long r = i / d.n;
      const int j = rank(r, kn0, knew);
      if (j >= 0) {
        const long long src = wbase + (long long)s_scan[j] * d.n + (i - r * d.n);
        a.o_kf_points[base + i] = a.pts[src];
        a.o_kf_masks[base + i] = a.msk[src];
      } else {
        a.o_kf_points[base + i] = a.kf_points[base + i];
        a.o_kf_masks[base + i] = a.kf_masks[base + i];
      }
    }
  }
}

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

__global__ void __launch_bounds__(kThreads)
loop_append_kernel(LoopArgs a, LoopDims d) {
  extern __shared__ int s_lane[];   // accepted rank -> lane (L = kq * c)
  __shared__ int s_nlok;
  const int s = blockIdx.y;
  const int lanes = d.kq * d.c;
  const long long lbase = (long long)s * lanes;
  const long long nb0 = a.n_between[s];
  if (threadIdx.x < 32) {
    int carry = 0;
    for (int b0 = 0; b0 < lanes; b0 += 32) {
      const int t = b0 + threadIdx.x;
      const bool acc = t < lanes && a.accept[lbase + t];
      const unsigned bits = __ballot_sync(0xffffffffu, acc);
      if (acc) s_lane[carry + __popc(bits & ((1u << threadIdx.x) - 1u))] = t;
      carry += __popc(bits);
    }
    if (threadIdx.x == 0) {
      const long long room = d.f - nb0;
      s_nlok = (int)(room <= 0 ? 0 : (carry < room ? carry : room));
    }
  }
  __syncthreads();
  const int nlok = s_nlok;
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    a.o_n_between[s] = nb0 + nlok;
    int* nl = a.nl + (long long)s * d.w;
    int* ld = a.ld + (long long)s * d.w;
    int* ni = a.ni + (long long)s * d.w;
    for (int w = 0; w < d.w; ++w) nl[w] = ld[w] = ni[w] = 0;
    int rank = 0;
    for (int q = 0; q < d.kq; ++q) {
      int n_l = 0, n_d = 0, n_i = 0;
      for (int c = 0; c < d.c; ++c) {
        const long long t = lbase + (long long)q * d.c + c;
        if (a.accept[t]) {
          if (rank < nlok) ++n_l; else ++n_d;
          ++rank;
        }
        n_i += a.innov[t] ? 1 : 0;
      }
      if (a.has[(long long)s * d.kq + q]) {
        const long long w = a.sel[(long long)s * d.kq + q];
        nl[w] += n_l; ld[w] += n_d; ni[w] += n_i;
      }
    }
  }
  const long long t0 = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long step = (long long)gridDim.x * kThreads;
  const long long base = (long long)s * d.f;
  for (long long r = t0; r < d.f; r += step) {
    const long long j = r - nb0;
    if (j >= 0 && j < nlok) {
      const int t = s_lane[j];
      a.o_bet_i[base + r] = a.lj[lbase + t];
      a.o_bet_j[base + r] = a.slot_k[(long long)s * d.kq + t / d.c];
      a.o_bet_mask[base + r] = true;
    } else {
      a.o_bet_i[base + r] = a.bet_i[base + r];
      a.o_bet_j[base + r] = a.bet_j[base + r];
      a.o_bet_mask[base + r] = a.bet_mask[base + r];
    }
  }
  for (long long i = t0; i < 3LL * d.f; i += step) {
    const long long r = i / 3, j = r - nb0;
    a.o_bet_z[3 * base + i] = (j >= 0 && j < nlok)
        ? a.lz[3 * (lbase + s_lane[j]) + (i - 3 * r)] : a.bet_z[3 * base + i];
  }
  for (long long i = t0; i < 9LL * d.f; i += step) {
    const long long r = i / 9, j = r - nb0;
    a.o_bet_sqrt[9 * base + i] = (j >= 0 && j < nlok)
        ? a.lsqrt[9 * (lbase + s_lane[j]) + (i - 9 * r)]
        : a.bet_sqrt[9 * base + i];
  }
}

// out[s, r, :] = src[s, m, :] for the last m with ok[s, m] and idx[s, m]
// == r, else dst[s, r, :] (an index outside [0, R) writes nothing).
__global__ void __launch_bounds__(kThreads)
rows_set_kernel(const float* __restrict__ dst, const long long* __restrict__ idx,
                const bool* __restrict__ ok, const float* __restrict__ src,
                float* __restrict__ out, int rows, int cols, int m) {
  extern __shared__ long long s_idx[];   // m row indices, -1 where not ok
  const int s = blockIdx.y;
  for (int i = threadIdx.x; i < m; i += kThreads)
    s_idx[i] = ok[(long long)s * m + i] ? idx[(long long)s * m + i] : -1;
  __syncthreads();
  const long long base = (long long)s * rows * cols;
  const long long total = (long long)rows * cols;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < total;
       i += (long long)gridDim.x * kThreads) {
    const long long r = i / cols;
    int hit = -1;
    for (int q = m - 1; q >= 0 && hit < 0; --q)
      if (s_idx[q] == r) hit = q;
    out[base + i] = hit >= 0
        ? src[((long long)s * m + hit) * cols + (i - r * cols)] : dst[base + i];
  }
}

// Blocks a session: enough that each thread handles ~4 elements of its
// largest array, at most 1,024.
inline int blocks_for(long long elements) {
  long long b = (elements + 4LL * kThreads - 1) / (4LL * kThreads);
  return (int)(b < 1 ? 1 : (b > 1024 ? 1024 : b));
}

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
  long long largest = (long long)k * n;
  if (9LL * f > largest) largest = 9LL * f;
  const dim3 grid(blocks_for(largest), sessions);
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
  const dim3 grid(blocks_for(9LL * f), sessions);
  loop_append_kernel<<<grid, kThreads, 4 * kq * c, (cudaStream_t)stream>>>(
      a, LoopDims{f, kq, c, w});
  return (int)cudaGetLastError();
}

// dst [S, R, C] f32, idx [S, M] int64, ok [S, M] bool, src [S, M, C] f32;
// out [S, R, C] f32 (M <= 6,144).
extern "C" int rows_set_launch(const void* dst, const void* idx,
                               const void* ok, const void* src, void* out,
                               int sessions, int rows, int cols, int m,
                               void* stream) {
  if (sessions < 1 || sessions > 65535 || rows < 1 || cols < 1 || m < 0
      || m > 6144)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(blocks_for((long long)rows * cols), sessions);
  rows_set_kernel<<<grid, kThreads, 8 * (m > 0 ? m : 1),
                    (cudaStream_t)stream>>>(
      (const float*)dst, (const long long*)idx, (const bool*)ok,
      (const float*)src, (float*)out, rows, cols, m);
  return (int)cudaGetLastError();
}
