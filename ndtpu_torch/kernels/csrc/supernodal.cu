// The supernodal solve's two routed sums (config 4), on tables that the
// host builds once per topology (ndtpu_torch/dist/schur.py::Routes).
//
// K9a supernodal_assemble replaces ndtpu/graph/supernodal.py::
// _assemble_parts (:158): every ordered endpoint pair (i,i), (i,j), (j,i),
// (j,j) of a between factor and (p,p) of a prior adds A^T B (3 x 3) to one
// block of h_ii [P, 3ni, 3ni], h_is [P, 3ni, 3nsl] or h_ss [3ns, 3ns] by
// the roles of its endpoints, and every endpoint adds A^T r to b_i or b_s.
// The reference routes ~4F pairs by flat segment ids (a scatter-add, float
// atomics on this card). Bound: the targets' store stream, ~86 MB at 10k
// poses (P = 64) against ~1.5 MB of factor blocks and tables read, so
// bytes (~26 us at 3.35 TB/s); a few hundred thousand of the ~21 M floats
// are not zero. So every output float is written once, in one pass, in
// 16-byte stores, as a fill would write them: the targets are three flat
// streams (h_ii, h_is, h_ss; a block row's three scalar rows are
// contiguous in each) cut into chunks on 16-byte line boundaries, and one
// unit of work is one chunk. A block zeroes a staged chunk in shared
// memory once; per unit, one thread per (target, entry) of the rows the
// chunk touches sums that entry's pairs in the host's order from +0.f
// (pose_graph.cuh's mtm3, entry by entry) into the stage where it lands,
// the chunk holding a row's first float sums its A^T r (one thread per
// entry), then after a barrier the block streams the chunk out (scalar
// stores only at a stream's two ends) and restores the staged zeros. The
// stores carry the streaming hint (.cs), so the outputs do not push the
// tables and blocks out of L2. Many blocks per SM keep one chunk's
// gathers (row_ptr -> tgt_col -> tgt_ptr -> code -> blocks) behind
// another's stores; the launch shape (threads, chunk, a persistent grid)
// was chosen by profile_port.py --assemble-sweep. No float atomics, no
// fill before the launch: the result is the same on every launch and the
// first design's bits (one thread per target block summing its nine
// entries in the same order).
//
// K9b schur_reduce replaces the two segment_sums of supernodal_delta
// (:338-353) and the subtraction and damping after them (:355-361):
// s_tot = h_ss - sum_p s_part[p] + diag(lam * max(|diag h_ss|, 1e-8) + (1
// - live)), rhs_tot = b_s - sum_p rhs_part[p], each shard's part routed by
// its local separator set. Bound: bytes, h_ss read and s_tot written (2 x
// 11.2 MB at 10k poses, P = 64, ns = 558), beside which the held parts
// (~0.6 MB) and the tables are small. Almost every entry of s_tot is a
// copy: a separator row's entries that some shard holds are those whose
// column is in the union of the row's holders' local separator sets, ~5%
// at 10k poses. So one block per separator row first streams its three
// contiguous scalar rows of h_ss into s_tot with 16-byte loads and stores
// (the wrapper gives s_tot the alignment of h_ss mod 16; a scalar head and
// tail take the rest), then, after a barrier, writes each held entry's
// final value: the row's holders in shard order, the column's local slot
// from a [P, ns] map, acc from +0.f, v = h_ss - acc, and on the diagonal v
// + the damping. The held columns come from a host table (touch_ptr /
// touch_col, graph/supernodal.py::touch_table: the union above, and the
// row's own separator so that its diagonal is always written there). A copied
// entry is h_ss - 0.f, which is h_ss bit for bit: every output is the
// bits of the first design (one thread per entry running the holder loop
// for all 3 x 3ns entries of the row).
//
// K9c schur_local_assemble is K9a's body for one rank of the distributed
// Schur solve (ndtpu/dist/schur.py::_schur_delta_local, :386, with
// assemble_local_parts, :318, and the interior damping after it, :397-400):
// one shard (P = 1) whose h_is spans all ns separators (every rank holds
// the whole separator set), the rank's own K5 rows in its local factor
// slots, routed by the one-shard tables of ndtpu_torch/dist/schur.py::
// rank_routes. Under kDamp the thread that sums an interior diagonal
// entry h stages h + (lam * max(|h|, 1e-8) + (1 - live)), and a row
// without entries (a dead slot) gets it from h = 0, as the reference damps
// h_ii before the interior Cholesky: no second pass or read-back. Bound:
// bytes, the stores of h_ii [3ni, 3ni] (33 MB at ni = 960) and h_is.
//
// Arithmetic as the plain versions write it (pose_graph.cuh's mtm3/mtv3;
// --fmad=false), sums in a fixed order.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "pose_graph.cuh"

namespace {

constexpr int kSchurThreads = 256;

struct AssembleArgs {
  const float* ai;   // [F, 3, 3]
  const float* aj;
  const float* r;    // [F, 3]
  const float* ap;   // [Q, 3, 3]
  const float* rp;   // [Q, 3]
  int n_fac;
  const int* row_ptr;  // [R + 1] targets of each block row
  const int* tgt_col;  // [T]
  const int* tgt_ptr;  // [T + 1] pairs of each target
  const int* code;     // [K] 4 f + kind, or 4 F + q
  const int* vec_ptr;  // [R + 1] endpoints of each block row
  const int* vcode;    // [Kb] 2 f + side, or 2 F + q
  int n_shards, ni, nsl, ns;
  const uint8_t* int_mask;  // [P * ni] live interior slots (K9c)
  float lam;                // interior damping (K9c)
  float* h_ii;
  float* h_is;
  float* h_ss;
  float* b_i;
  float* b_s;
};

// The two 3 x 3 blocks of a pair: kind 0 (i,i), 1 (i,j), 2 (j,i), 3 (j,j).
__device__ __forceinline__ void pair_blocks(const AssembleArgs& a, int c,
                                            const float** ga,
                                            const float** gb) {
  const int f4 = 4 * a.n_fac;
  if (c >= f4) {
    *ga = *gb = a.ap + 9 * (size_t)(c - f4);
    return;
  }
  const int f = c >> 2, kind = c & 3;
  const float* ai = a.ai + 9 * (size_t)f;
  const float* aj = a.aj + 9 * (size_t)f;
  *ga = kind < 2 ? ai : aj;
  *gb = (kind & 1) ? aj : ai;
}

// An endpoint's block and residual: side 0 is i, 1 is j.
__device__ __forceinline__ void endpoint(const AssembleArgs& a, int c,
                                         const float** g,
                                         const float** res) {
  const int f2 = 2 * a.n_fac;
  if (c >= f2) {
    *g = a.ap + 9 * (size_t)(c - f2);
    *res = a.rp + 3 * (size_t)(c - f2);
    return;
  }
  const int f = c >> 1;
  *g = ((c & 1) ? a.aj : a.ai) + 9 * (size_t)f;
  *res = a.r + 3 * (size_t)f;
}

// The targets as three flat streams of floats: h_ii (interior rows, scalar
// rows of w = 3ni), h_is (interior rows, w = 3nsl) and h_ss (separator
// rows, w = 3ns). Block row r of a stream is its floats [3wr, 3w(r + 1)),
// and a target of block row `first + r` belongs to the stream when its
// column is in [col0, col0 + n_cols), at column col - col0. A stream is
// cut into chunks of `chunk` floats whose boundaries are 16-byte line
// boundaries in memory: chunk c covers stream floats [c chunk - off,
// (c + 1) chunk - off), off = the stream's first float's offset in its
// line. Stream offsets are int, or long long (kWide) where a stream
// reaches 2^31 floats (h_ss at 15,447 separators, a rank's h_ii at 15,447
// interior poses): the launcher picks by stream_wide. 64-bit offsets
// everywhere measured slower for K9a at 10k poses (more registers, 64-bit
// divisions), so the 32-bit instantiation stays for every smaller graph.
struct Stream {
  float* base;     // the stream's float 0
  int w, n_rows, first, col0, n_cols, off, chunks;
};

// Whether a stream of n floats in block rows of pitch floats needs 64-bit
// offsets: a chunk's first float, its end and a row's end past it must all
// stay in int's range.
inline bool stream_wide(long long n, int pitch, int chunk) {
  return n + chunk + pitch >= 0x7fffffffLL;
}

struct Streams {
  Stream s[3];
  int chunk;       // floats per chunk, a multiple of 4
  int rows_max;    // block rows a chunk can touch (the rows' table)
};

inline Stream make_stream(float* base, int w, int n_rows, int first,
                          int col0, int n_cols, int chunk) {
  const int off = (int)(((uintptr_t)base >> 2) & 3);
  const long long n = 3LL * w * n_rows;
  return Stream{base, w, n_rows, first, col0, n_cols, off,
                (int)((n + off + chunk - 1) / chunk)};
}

// One target entry (p, q) over its pairs [k0, k1), in the host's order
// from +0.f; four pairs at a time, their codes and then their blocks'
// entries loaded together, so a long list costs two load latencies per
// four pairs.
__device__ __forceinline__ float target_entry(const AssembleArgs& a, int k0,
                                              int k1, int p, int q) {
  float acc = 0.f;
  for (int k = k0; k < k1; k += 4) {
    float x[4][6];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (k + u < k1) {
        const float *ga, *gb;
        pair_blocks(a, __ldg(a.code + k + u), &ga, &gb);
        x[u][0] = __ldg(ga + p);     x[u][1] = __ldg(gb + q);
        x[u][2] = __ldg(ga + 3 + p); x[u][3] = __ldg(gb + 3 + q);
        x[u][4] = __ldg(ga + 6 + p); x[u][5] = __ldg(gb + 6 + q);
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (k + u < k1)   // mtm3's entry (p, q), then the running sum
        acc = acc + (x[u][0] * x[u][1] + x[u][2] * x[u][3]
                     + x[u][4] * x[u][5]);
  }
  return acc;
}

// One entry c of a row's b over its endpoints [k0, k1), in order from
// +0.f (mtv3's entry c), four at a time as target_entry.
__device__ __forceinline__ float vector_entry(const AssembleArgs& a, int k0,
                                              int k1, int c) {
  float acc = 0.f;
  for (int k = k0; k < k1; k += 4) {
    float x[4][6];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (k + u < k1) {
        const float *g, *res;
        endpoint(a, __ldg(a.vcode + k + u), &g, &res);
        x[u][0] = __ldg(g + c);     x[u][1] = __ldg(res);
        x[u][2] = __ldg(g + 3 + c); x[u][3] = __ldg(res + 1);
        x[u][4] = __ldg(g + 6 + c); x[u][5] = __ldg(res + 2);
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (k + u < k1)
        acc = acc + (x[u][0] * x[u][1] + x[u][2] * x[u][3]
                     + x[u][4] * x[u][5]);
  }
  return acc;
}

// The launch's shape: threads per block, floats of the staged chunk (a
// multiple of 4), blocks per SM of a persistent grid (0: one block per
// chunk). Each kernel's default is the fastest of profile_port.py
// --assemble-sweep on the H100 (K9a at config 4's 10k graph, K9c on a
// 2,048-pose graph's two ranks); supernodal_assemble_shape overrides both
// for the sweep.
struct AsmShape {
  int threads, chunk, blocks_per_sm;
};
constexpr int kAsmThreadsMax = 256;
constexpr int kAsmChunkMax = 12288;
constexpr AsmShape kAsmShape[2] = {{128, 2048, 0},    // K9a
                                   {128, 4096, 16}};  // K9c
AsmShape g_asm_shape[2] = {kAsmShape[0], kAsmShape[1]};

// One unit of work is one chunk of one stream: h_ii's chunks, then
// h_is's, then h_ss's. Outputs are stored with the streaming hint (.cs),
// so that the ~86 MB of them do not push the tables and blocks out of L2.
template <bool kDamp, bool kWide>
__global__ void __launch_bounds__(kAsmThreadsMax)
supernodal_assemble_kernel(AssembleArgs a, Streams ss) {
  using Off = typename std::conditional<kWide, long long, int>::type;
  extern __shared__ float4 stage4[];   // the chunk, zero between units;
  float* stage = reinterpret_cast<float*>(stage4);
  int* s_ptr = reinterpret_cast<int*>(stage + ss.chunk);   // rows' row_ptr
  float* s_dead = reinterpret_cast<float*>(s_ptr + ss.rows_max + 1);
  const int tid = threadIdx.x, T = blockDim.x, chunk = ss.chunk;
  const int n_units = ss.s[0].chunks + ss.s[1].chunks + ss.s[2].chunks;
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int j = tid; j < chunk / 4; j += T) stage4[j] = zero4;
  for (int u = blockIdx.x; u < n_units; u += gridDim.x) {
    const int which = u < ss.s[0].chunks ? 0
                      : u < ss.s[0].chunks + ss.s[1].chunks ? 1 : 2;
    // (field by field: a runtime index into the parameter would copy the
    // streams to local memory)
    const Stream st = which == 0 ? ss.s[0] : which == 1 ? ss.s[1] : ss.s[2];
    const int c = u - (which > 0 ? ss.s[0].chunks : 0)
                  - (which > 1 ? ss.s[1].chunks : 0);
    const int pitch = 3 * st.w;
    const Off n = (Off)pitch * st.n_rows;
    const Off at = (Off)c * chunk - st.off;   // stream float of stage[0]
    const Off lo = max(at, (Off)0), hi = min(at + chunk, n);
    const int r0 = (int)(lo / pitch);
    const int n_rows = (int)((hi - 1) / pitch) - r0 + 1;
    for (int j = tid; j <= n_rows; j += T) {
      s_ptr[j] = a.row_ptr[st.first + r0 + j];
      if (kDamp && which == 0 && j < n_rows)   // 1 - live, for the damping
        s_dead[j] = 1.f - (a.int_mask[r0 + j] ? 1.f : 0.f);
    }
    __syncthreads();   // also: the last unit's stream has read the stage

    // Gather: one thread per (target, entry) of the chunk's rows, the
    // target's pairs in the host's order from +0.f, into the stage where
    // it lands in the chunk. Under kDamp an interior diagonal entry h is
    // staged as h + (lam max(|h|, 1e-8) + (1 - live)); a row without
    // entries (a dead slot) from h = 0.
    const bool damp = kDamp && which == 0;   // n_shards is 1 under kDamp
    const int t0 = s_ptr[0], n9 = 9 * (s_ptr[n_rows] - t0);
    for (int e = tid; e < n9; e += T) {
      const int t = t0 + e / 9, pq = e % 9, p = pq / 3, q = pq - 3 * p;
      const int col = __ldg(a.tgt_col + t) - st.col0;
      const int k0 = __ldg(a.tgt_ptr + t), k1 = __ldg(a.tgt_ptr + t + 1);
      if (col < 0 || col >= st.n_cols) continue;
      int j = 0, j1 = n_rows - 1;   // the target's row: s_ptr[j] <= t
      while (j < j1) {
        const int mid = (j + j1 + 1) >> 1;
        if (s_ptr[mid] <= t) j = mid; else j1 = mid - 1;
      }
      const Off m = (Off)(r0 + j) * pitch + p * st.w + 3 * col + q;
      if (m < lo || m >= hi) continue;
      float h = target_entry(a, k0, k1, p, q);
      if (damp && p == q && col == r0 + j)
        h = h + (a.lam * ndtpu::pg::nanmax(fabsf(h), 1e-8f) + s_dead[j]);
      stage[m - at] = h;
    }
    const Off d0 = damp ? lo / st.w : 0, d1 = damp ? (hi - 1) / st.w : -1;
    for (Off i = d0 + tid; i <= d1; i += T) {   // scalar row i's diagonal
      const Off m = i * (st.w + 1);
      const int j = (int)(i / 3) - r0;
      if (m < lo || m >= hi || s_ptr[j + 1] > s_ptr[j]) continue;
      const float h = 0.f;
      stage[m - at] = h + (a.lam * ndtpu::pg::nanmax(fabsf(h), 1e-8f)
                           + s_dead[j]);
    }
    // Each block row's b with the chunk of h_ii or h_ss holding its first
    // float: one thread per entry, the row's endpoints in order, four at a
    // time (beside the gather: its latency is not added to the chunk's).
    if (which != 1) {
      const int rb = (int)((lo + pitch - 1) / pitch);
      const int nb = (int)((hi + pitch - 1) / pitch) - rb;
      float* b = which == 0 ? a.b_i : a.b_s;
      for (int i = T - 1 - tid; i < 3 * nb; i += T) {   // the last threads
        const int r = rb + i / 3, cc = i % 3, row = st.first + r;
        b[3 * r + cc] = vector_entry(a, a.vec_ptr[row], a.vec_ptr[row + 1],
                                     cc);
      }
    }
    __syncthreads();

    // Stream the chunk out: 16-byte stores (scalar only at the stream's
    // two ends), the staged zeros restored for the next unit.
    float* dst = st.base + at;   // 16-byte aligned
    for (int i = tid; i < chunk / 4; i += T) {
      const Off m = at + 4 * i;
      if (m >= hi) break;
      const float4 x = stage4[i];
      stage4[i] = zero4;
      if (m >= lo && m + 4 <= hi) {
        __stcs(reinterpret_cast<float4*>(dst) + i, x);
      } else {
        const float xv[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
        for (int l = 0; l < 4; ++l)
          if (m + l >= lo && m + l < hi) __stcs(dst + 4 * i + l, xv[l]);
      }
    }
  }
}

// The streams and the grid of a launch at the current shape.
template <bool kDamp>
cudaError_t launch_assemble(const AssembleArgs& a, cudaStream_t st) {
  const AsmShape shape = g_asm_shape[kDamp ? 1 : 0];
  const int threads = shape.threads, chunk = shape.chunk;
  const int n_int = a.n_shards * a.ni;
  Streams ss;
  ss.chunk = chunk;
  ss.s[0] = make_stream(a.h_ii, 3 * a.ni, n_int, 0, 0, a.ni, chunk);
  ss.s[1] = make_stream(a.h_is, 3 * a.nsl, n_int, 0, a.ni, a.nsl, chunk);
  ss.s[2] = make_stream(a.h_ss, 3 * a.ns, a.ns, n_int, 0, a.ns, chunk);
  const int w_min = 3 * std::min(std::min(a.ni, a.nsl), a.ns);
  ss.rows_max = chunk / (3 * w_min) + 2;
  const long long units = (long long)ss.s[0].chunks + ss.s[1].chunks
                          + ss.s[2].chunks;
  if (units > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  long long grid = units;
  if (shape.blocks_per_sm > 0) {
    int dev = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    const long long cap = (long long)shape.blocks_per_sm * sms;
    grid = grid < cap ? grid : cap;
  }
  bool wide = false;
  for (const Stream& s : ss.s)
    wide = wide || stream_wide(3LL * s.w * s.n_rows, 3 * s.w, chunk);
  auto* kernel = wide ? supernodal_assemble_kernel<kDamp, true>
                      : supernodal_assemble_kernel<kDamp, false>;
  const int smem = (chunk + 2 * ss.rows_max + 1) * (int)sizeof(float);
  if (smem > 48 * 1024) {   // opt in past the default
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<(unsigned)grid, threads, smem, st>>>(a, ss);
  return cudaGetLastError();
}

struct SchurArgs {
  const float* s_part;    // [P, 3nsl, 3nsl]
  const float* rhs_part;  // [P, 3nsl]
  const float* h_ss;      // [3ns, 3ns]
  const float* b_s;       // [3ns]
  const int* hold_ptr;    // [ns + 1]
  const int* hold_shard;  // [H]
  const int* hold_loc;    // [H]
  const int* loc_of;      // [P, ns], -1 where not held
  const int* touch_ptr;   // [ns + 1]
  const int* touch_col;   // [T] held separator columns of each row
  const uint8_t* sep_mask;  // [ns]
  float lam;
  int nsl, ns;
  float* s_tot;           // the alignment of h_ss mod 16
  float* rhs_tot;
};

constexpr int kCopyUnroll = 4;   // 16-byte loads in flight per thread

// dst[0, n) = src[0, n) where src and dst are equally aligned mod 16.
__device__ __forceinline__ void stream_copy(const float* __restrict__ src,
                                            float* __restrict__ dst,
                                            int n) {
  const int tid = threadIdx.x, T = blockDim.x;
  const int head = min(n, (int)(((16 - ((uintptr_t)src & 15)) & 15) >> 2));
  if (tid < head) dst[tid] = src[tid];
  const int n4 = (n - head) >> 2;
  const float4* s4 = reinterpret_cast<const float4*>(src + head);
  float4* d4 = reinterpret_cast<float4*>(dst + head);
  for (int i = tid; i < n4; i += kCopyUnroll * T) {
    float4 v[kCopyUnroll];
#pragma unroll
    for (int u = 0; u < kCopyUnroll; ++u)
      if (i + u * T < n4) v[u] = __ldg(s4 + i + u * T);
#pragma unroll
    for (int u = 0; u < kCopyUnroll; ++u)
      if (i + u * T < n4) d4[i + u * T] = v[u];
  }
  const int done = head + 4 * n4;
  if (tid < n - done) dst[done + tid] = src[done + tid];
}

__global__ void __launch_bounds__(kSchurThreads)
schur_reduce_kernel(SchurArgs a) {
  const int g1 = blockIdx.x, tid = threadIdx.x, T = blockDim.x;
  const int ns3 = 3 * a.ns, nsl3 = 3 * a.nsl;
  const size_t row0 = (size_t)3 * g1 * ns3;
  stream_copy(a.h_ss + row0, a.s_tot + row0, 3 * ns3);
  __syncthreads();   // each held entry's store below is its last
  const int h0 = a.hold_ptr[g1], h1 = a.hold_ptr[g1 + 1];
  const float dead = 1.f - (a.sep_mask[g1] ? 1.f : 0.f);
  const int t0 = a.touch_ptr[g1], nt = a.touch_ptr[g1 + 1] - t0;
  for (int e = tid; e < 9 * nt; e += T) {
    const int k = e / 9, q = e - 9 * k;
    const int rr = q / 3, cb = q - 3 * rr;
    const int g2 = a.touch_col[t0 + k], col = 3 * g2 + cb;
    float acc = 0.f;
    for (int h = h0; h < h1; ++h) {
      const int p = a.hold_shard[h];
      const int k2 = a.loc_of[(size_t)p * a.ns + g2];
      if (k2 < 0) continue;
      acc = acc + a.s_part[((size_t)p * nsl3 + 3 * a.hold_loc[h] + rr) * nsl3
                           + 3 * k2 + cb];
    }
    const size_t at = row0 + (size_t)rr * ns3 + col;
    const float hv = a.h_ss[at];
    float v = hv - acc;
    if (col == 3 * g1 + rr)
      v = v + (a.lam * ndtpu::pg::nanmax(fabsf(hv), 1e-8f) + dead);
    a.s_tot[at] = v;
  }
  if (tid < 3) {
    float acc = 0.f;
    for (int h = h0; h < h1; ++h)
      acc = acc + a.rhs_part[(size_t)a.hold_shard[h] * nsl3
                             + 3 * a.hold_loc[h] + tid];
    a.rhs_tot[3 * g1 + tid] = a.b_s[3 * g1 + tid] - acc;
  }
}

}  // namespace

extern "C" int supernodal_assemble_launch(
    const void* ai, const void* aj, const void* r, const void* ap,
    const void* rp, int n_fac, const void* row_ptr, const void* tgt_col,
    const void* tgt_ptr, const void* code, const void* vec_ptr,
    const void* vcode, int n_shards, int ni, int nsl, int ns, void* h_ii,
    void* h_is, void* h_ss, void* b_i, void* b_s, void* stream) {
  if (n_fac < 0 || n_shards < 1 || ni < 1 || nsl < 1 || ns < 1)
    return (int)cudaErrorInvalidValue;
  const AssembleArgs a{(const float*)ai, (const float*)aj, (const float*)r,
                       (const float*)ap, (const float*)rp, n_fac,
                       (const int*)row_ptr, (const int*)tgt_col,
                       (const int*)tgt_ptr, (const int*)code,
                       (const int*)vec_ptr, (const int*)vcode, n_shards, ni,
                       nsl, ns, nullptr, 0.f, (float*)h_ii, (float*)h_is,
                       (float*)h_ss, (float*)b_i, (float*)b_s};
  return (int)launch_assemble<false>(a, (cudaStream_t)stream);
}

// K9a's and K9c's launch shape (threads per block, staged floats per
// unit, blocks per SM of a persistent grid or 0 for one block per unit);
// all 0 restores each kernel's default. For a sweep of the sizes only.
extern "C" int supernodal_assemble_shape(int threads, int chunk,
                                         int blocks_per_sm) {
  if (threads == 0 && chunk == 0 && blocks_per_sm == 0) {
    g_asm_shape[0] = kAsmShape[0];
    g_asm_shape[1] = kAsmShape[1];
    return 0;
  }
  if (threads < 32 || threads > kAsmThreadsMax || threads % 32 || chunk < 4
      || chunk > kAsmChunkMax || chunk % 4 || blocks_per_sm < 0)
    return (int)cudaErrorInvalidValue;
  g_asm_shape[0] = g_asm_shape[1] = AsmShape{threads, chunk, blocks_per_sm};
  return 0;
}

extern "C" int schur_local_assemble_launch(
    const void* ai, const void* aj, const void* r, const void* ap,
    const void* rp, int n_fac, const void* row_ptr, const void* tgt_col,
    const void* tgt_ptr, const void* code, const void* vec_ptr,
    const void* vcode, const void* int_mask, float lam, int ni, int ns,
    void* h_ii, void* h_is, void* h_ss, void* b_i, void* b_s,
    void* stream) {
  if (n_fac < 0 || ni < 1 || ns < 1) return (int)cudaErrorInvalidValue;
  const AssembleArgs a{(const float*)ai, (const float*)aj, (const float*)r,
                       (const float*)ap, (const float*)rp, n_fac,
                       (const int*)row_ptr, (const int*)tgt_col,
                       (const int*)tgt_ptr, (const int*)code,
                       (const int*)vec_ptr, (const int*)vcode, 1, ni, ns, ns,
                       (const uint8_t*)int_mask, lam, (float*)h_ii,
                       (float*)h_is, (float*)h_ss, (float*)b_i, (float*)b_s};
  return (int)launch_assemble<true>(a, (cudaStream_t)stream);
}

extern "C" int schur_reduce_launch(
    const void* s_part, const void* rhs_part, const void* h_ss,
    const void* b_s, const void* hold_ptr, const void* hold_shard,
    const void* hold_loc, const void* loc_of, const void* touch_ptr,
    const void* touch_col, const void* sep_mask, float lam, int nsl, int ns,
    void* s_tot, void* rhs_tot, void* stream) {
  if (nsl < 1 || ns < 1 || ((uintptr_t)h_ss & 15) != ((uintptr_t)s_tot & 15))
    return (int)cudaErrorInvalidValue;
  const SchurArgs a{(const float*)s_part, (const float*)rhs_part,
                    (const float*)h_ss, (const float*)b_s,
                    (const int*)hold_ptr, (const int*)hold_shard,
                    (const int*)hold_loc, (const int*)loc_of,
                    (const int*)touch_ptr, (const int*)touch_col,
                    (const uint8_t*)sep_mask, lam, nsl, ns, (float*)s_tot,
                    (float*)rhs_tot};
  schur_reduce_kernel<<<ns, kSchurThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
