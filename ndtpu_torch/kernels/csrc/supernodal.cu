// The supernodal solve's two routed sums (config 4), on tables that the
// host builds once per topology (ndtpu_torch/dist/schur.py::Routes).
//
// K9a supernodal_assemble replaces ndtpu/graph/supernodal.py::
// _assemble_parts (:158): every ordered endpoint pair (i,i), (i,j), (j,i),
// (j,j) of a between factor and (p,p) of a prior adds A^T B (3 x 3) to one
// block of h_ii [P, 3ni, 3ni], h_is [P, 3ni, 3nsl] or h_ss [3ns, 3ns] by
// the roles of its endpoints, and every endpoint adds A^T r to b_i or b_s.
// The reference routes ~4F pairs by flat segment ids (a scatter-add, float
// atomics on this card). Here one block owns one block row of the targets
// (three scalar rows: an interior slot's rows of h_ii and h_is and its
// b_i, or a separator's rows of h_ss and its b_s): it zero-fills them,
// then one thread per non-zero target block sums that block's pairs in the
// host's order (pair order), and three threads sum the row's A^T r. No
// float atomics: the result is the same on every launch. Bound: the
// targets' zero fill, ~85 MB at 10k poses (P = 64) against ~1.5 MB of
// factor blocks read, so bytes (~25 us at 3.35 TB/s).
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
// rank_routes. Under kDamp each interior row's owner then adds lam *
// max(|h_ii[d, d]|, 1e-8) + (1 - live) to its three diagonal entries, as
// the reference damps h_ii before the interior Cholesky. Bound: bytes, the
// zero fill of h_ii [3ni, 3ni] (37.7 MB at ni = 1,024) and h_is.
//
// Arithmetic as the plain versions write it (pose_graph.cuh's mtm3/mtv3;
// --fmad=false), sums in a fixed order.

#include <cuda_runtime.h>
#include <stdint.h>

#include "pose_graph.cuh"

namespace {

constexpr int kAsmThreads = 128;
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

template <bool kDamp>
__global__ void __launch_bounds__(kAsmThreads)
supernodal_assemble_kernel(AssembleArgs a) {
  const int row = blockIdx.x, tid = threadIdx.x, T = blockDim.x;
  const int n_int = a.n_shards * a.ni;
  const bool interior = row < n_int;
  const int w_main = interior ? 3 * a.ni : 3 * a.ns;
  const int w_side = 3 * a.nsl;
  float* main_rows =
      interior ? a.h_ii + (size_t)3 * row * w_main
               : a.h_ss + (size_t)3 * (row - n_int) * w_main;
  float* side_rows =
      interior ? a.h_is + (size_t)3 * row * w_side : nullptr;
  float* b = interior ? a.b_i + 3 * (size_t)row
                      : a.b_s + 3 * (size_t)(row - n_int);

  // The block row's three scalar rows are contiguous in each target.
  for (int i = tid; i < 3 * w_main; i += T) main_rows[i] = 0.f;
  if (interior)
    for (int i = tid; i < 3 * w_side; i += T) side_rows[i] = 0.f;
  __syncthreads();

  if (tid < 3) {
    float acc = 0.f;
    for (int k = a.vec_ptr[row]; k < a.vec_ptr[row + 1]; ++k) {
      const float *g, *res;
      endpoint(a, a.vcode[k], &g, &res);
      float t3[3];
      ndtpu::pg::mtv3(g, res, t3);
      acc = acc + t3[tid];
    }
    b[tid] = acc;
  }
  for (int t = a.row_ptr[row] + tid; t < a.row_ptr[row + 1]; t += T) {
    float acc[9] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int k = a.tgt_ptr[t]; k < a.tgt_ptr[t + 1]; ++k) {
      const float *ga, *gb;
      pair_blocks(a, a.code[k], &ga, &gb);
      float t9[9];
      ndtpu::pg::mtm3(ga, gb, t9);
#pragma unroll
      for (int e = 0; e < 9; ++e) acc[e] = acc[e] + t9[e];
    }
    const int col = a.tgt_col[t];
    float* dst;
    int width;
    if (interior && col >= a.ni) {
      dst = side_rows + 3 * (col - a.ni);
      width = w_side;
    } else {
      dst = main_rows + 3 * col;
      width = w_main;
    }
#pragma unroll
    for (int p = 0; p < 3; ++p)
#pragma unroll
      for (int q = 0; q < 3; ++q) dst[(size_t)p * width + q] = acc[3 * p + q];
  }
  if (kDamp && interior) {
    __syncthreads();   // the diagonal block's owner has written it
    if (tid < 3) {
      float* d = main_rows + (size_t)tid * w_main + 3 * (row % a.ni) + tid;
      const float hv = *d;
      const float dead = 1.f - (a.int_mask[row] ? 1.f : 0.f);
      *d = hv + (a.lam * ndtpu::pg::nanmax(fabsf(hv), 1e-8f) + dead);
    }
  }
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
  supernodal_assemble_kernel<false><<<n_shards * ni + ns, kAsmThreads, 0,
                                      (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
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
  supernodal_assemble_kernel<true><<<ni + ns, kAsmThreads, 0,
                                     (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
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
