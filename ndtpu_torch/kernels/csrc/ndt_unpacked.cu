// K12 ndt_sgh_unpacked: the NDT objective, gradient, Hessian and score of
// one shared scan at B poses, on an unpacked NDTMap.
//
// Replaces what XLA lowered for the TPU from jax.vmap of
// ndtpu/ndt/match.py::score_grad_hess (:108) over poses, with
// ndtpu/ndt/grid.py::lookup (:288) and ndtpu/ndt/match.py::point_terms
// (:65) inside it, as ndtpu/slam/merge.py::global_align (:93-100) calls it
// to rank its hypotheses by total mass (B = 4,624 coarse, 64 refine).
//
// Per beam: the transform, then for each of the kG overlap grids (4, or 1
// at overlap 1; the shifts of ndtpu/ndt/grid.py::_grid_offsets :78-86,
// (0, 0) alone at overlap 1) the cell index exactly as cell_ids computes
// it (((x - x0) - shift) / cell, floor, in-bounds test; the per-grid shift,
// unlike the quad lattice's shared half-cell index), a gather of the cell's
// mean (float2), inverse covariance (float4, its three unique entries
// used) and valid flag, and the 11 terms of ndt_sums.cuh's
// ndt_gauss_terms. A beam that is masked, out of a grid or in an invalid
// cell adds exactly zero in the plain version (w0 = 0), so it is skipped.
// out[b] = (f, g0, g1, g2, H00..H22, score) with score = wsum / max(w0sum,
// 1), as score_grad_hess returns them.
//
// K10c slab_sgh computes the same terms on one rank's x-slab of a
// spatially sharded map: it replaces the per-rank sgh of
// ndtpu/dist/gridmap.py::match_slab (:189-209: transform_terms, _cell_xy,
// the ownership mask mine = x_lo <= ix < x_lo + nx_local, the clipped
// ix-major gather from [G, nx_local, ny] and point_terms with w0 = valid *
// (mine & inb) * mask), before its psum. A beam outside the rank's slab
// adds exactly zero there, so it is skipped. It writes the 15 raw sums
// out[b] = (f, wsum, w0sum, g0..g2, H00..H22), the vector the reference
// psums; match_slab launches it once per LM evaluation with B = 1 (N = 360
// at config 5).
//
// Both kernels run one block of 128 R threads per pose, one beam per
// thread (chunks of 128 R beams past that): each beam's kG cells are
// binned, clamped into the map and loaded together before any test, so
// all of a beam's gathers are in flight at once, and the terms of threads
// t >= 128 are stored in shared memory with a grid mask and replayed by
// thread t < 128 in the first design's order (ndt_sums.cuh's scheme for
// lm_ndt). The first design (128 threads, each walking beams t, t + 128,
// ... and their grids in series, each cell's mean and covariance loaded
// only after its valid flag) spent most of its time in that serial chain
// of dependent L2 loads: K12 refine 0.0086 ms (half the card idle at 64
// blocks). R is the wrapper's (kernels.sgh_spread for
// K12: one beam per thread while the poses leave the card room, 128
// threads per pose once they fill it; kernels.slab_spread for K10c),
// chosen by profile_port.py --sgh-sweep; no output depends on it: thread t
// folds beams t, t + 128, t + 256, ... in order, each one's counted grids
// in grid order, and ndt_wide_block_sums reduces in ndt_block_sums' order,
// so every output is the first design's bits at any R, the same on every
// launch (no float atomics).
//
// Both kernels are templates on kG, the grid count of the map ([kG, C,
// ...] for K12, [kG, nx_local, ny, ...] ix-major for K10c); each is its own
// instantiation, counted apart by the wrappers (ndt_sgh_unpacked[g1],
// slab_sgh[g1]).
//
// What bounds them on Hopper: the operations, ~300 f32 flops per in-map
// beam at kG = 4, ~90 at kG = 1 (the map, 7 MB at config 5's 4 x 65,536
// cells, stays in the 50 MB L2); below a few thousand poses the latency of
// one beam's gathers. A beam bins once per axis and shift (grid g takes
// shift g & 1 in x, g >> 1 in y), by the IEEE division of cell_ids. At
// the merge's 4,624 coarse poses the card is full at R = 1, and the call
// runs at about the first design's time; why is not known (no profiler
// read of its issue rate or stalls was made: instruction issue, ~120 SASS
// instructions a beam besides the terms of its valid grids, and its 12
// scattered gathers are the suspects). Loading the valid flags first and
// the rest only for valid cells, or capping the registers for more
// resident blocks, measured slower on edited copies. Built with
// --fmad=false like the plain version's separate elementwise ops.

#include <cuda_runtime.h>

#include "ndt_sums.cuh"

namespace {

using ndtpu::kNdtSums;
using ndtpu::kNdtThreads;

constexpr int kOut = 14;   // f, g[3], H[3 x 3], score
constexpr int kSlabOut = 15;   // f, wsum, w0sum, g[3], H[3 x 3]

// out[0..] = (f, g, H) from the reduced sums, H symmetric in full.
__device__ __forceinline__ void write_fgh(float* o, const float* sums,
                                          float d2) {
  o[0] = -sums[0];
  o[1] = d2 * sums[2];
  o[2] = d2 * sums[3];
  o[3] = d2 * sums[4];
  const float h00 = d2 * sums[5], h01 = d2 * sums[6], h02 = d2 * sums[7];
  const float h11 = d2 * sums[8], h12 = d2 * sums[9], h22 = d2 * sums[10];
  o[4] = h00; o[5] = h01; o[6] = h02;
  o[7] = h01; o[8] = h11; o[9] = h12;
  o[10] = h02; o[11] = h12; o[12] = h22;
}

// The map's frame: origin, cell and half cell (the overlap grids' shift).
struct Frame {
  float x0, y0, cell, h;
};

// floor(((v - v0) - shift) / cell), as cell_ids computes it.
__device__ __forceinline__ float cell_bin(float v, float v0, float shift,
                                          const Frame& fr) {
  return floorf(((v - v0) - shift) / fr.cell);
}

// Beam i at the pose (c, s, tx, ty) on a map of kG grids of nx x ny
// cells, of which the block holds columns [x_lo, x_lo + nx_local): the
// beam binned on each axis for the grids' two shifts (0 and h; grid g
// takes shift g & 1 in x and g >> 1 in y), every grid's cell clamped into
// the held columns and its valid flag, mean and inverse covariance loaded
// before any test, so the kG gathers are in flight together; then, in
// grid order, emit(g, t) with the 11 terms of each grid that counts (the
// beam unmasked, the cell in the map and held, valid). Returns those grids
// as a bit mask, exactly the (beam, grid) pairs the first designs added.
// The cells lie grid-major, then ix-major (kSlab: K10c's [kG, nx_local,
// ny]) or iy-major (K12's [kG, ny * nx], x_lo = 0 and nx_local = nx).
template <int kG, bool kSlab, class Emit>
__device__ __forceinline__ unsigned map_beam(
    float c, float s, float tx, float ty, const float2* __restrict__ pts,
    const float* __restrict__ mask, int i, const float2* __restrict__ mean,
    const float4* __restrict__ icov, const float* __restrict__ valid, int nx,
    int ny, int x_lo, int nx_local, const Frame& fr, float d2, float nh,
    float exp_clip, Emit&& emit) {
  constexpr int kShifts = kG == 4 ? 2 : 1;
  const float m = __ldg(mask + i);
  const float2 p = __ldg(pts + i);
  const float x = c * p.x - s * p.y + tx;
  const float y = s * p.x + c * p.y + ty;
  // Per shift: the column (clamped into the held ones, in float first, so
  // a NaN clamps to 0 and any beam has an address) and whether the beam
  // is in the map and in a held column; the row likewise.
  int lc[kShifts], iy[kShifts];
  bool in_x[kShifts], in_y[kShifts];
#pragma unroll
  for (int a = 0; a < kShifts; ++a) {
    const float fx = cell_bin(x, fr.x0, a ? fr.h : 0.f, fr);
    const float fy = cell_bin(y, fr.y0, a ? fr.h : 0.f, fr);
    const int lx = (int)fminf(fmaxf(fx, 0.f), (float)(nx - 1)) - x_lo;
    in_x[a] = fx >= 0.f && fx < (float)nx && lx >= 0 && lx < nx_local;
    in_y[a] = fy >= 0.f && fy < (float)ny;
    lc[a] = min(max(lx, 0), nx_local - 1);
    iy[a] = (int)fminf(fmaxf(fy, 0.f), (float)(ny - 1));
  }
  const size_t grid_cells = (size_t)nx_local * ny;
  bool use[kG];
  float v[kG];
  float2 mu[kG];
  float4 ic[kG];
#pragma unroll
  for (int g = 0; g < kG; ++g) {
    const int ax = g & 1, ay = g >> 1;
    use[g] = m != 0.f && in_x[ax] && in_y[ay];
    const size_t id = g * grid_cells + (size_t)(kSlab ? lc[ax] * ny + iy[ay]
                                                      : iy[ay] * nx + lc[ax]);
    v[g] = __ldg(valid + id);
    mu[g] = __ldg(mean + id);
    ic[g] = __ldg(icov + id);                  // i00, i01, i10, i11
  }
  const float dpx = -s * p.x - c * p.y;
  const float dpy = c * p.x - s * p.y;
  const float rx = x - tx;
  const float ry = y - ty;
  unsigned hit = 0;
#pragma unroll
  for (int g = 0; g < kG; ++g) {
    if (!use[g] || v[g] == 0.f) continue;
    float t[kNdtSums];
    ndtpu::ndt_gauss_terms(t, x, y, dpx, dpy, rx, ry, mu[g].x, mu[g].y,
                           ic[g].x, ic[g].y, ic[g].w, v[g] * m, d2, nh,
                           exp_clip);
    emit(g, t);
    hit |= 1u << g;
  }
  return hit;
}

// The block's 11 sums over beams [0, n) of one pose, returned to every
// thread in sums; beam(i, emit) evaluates beam i (map_beam). The block is
// 128 R threads (R = blockDim.x / 128 <= kMaxR), one beam each, in chunks
// of 128 R beams. Thread t < 128 adds its own beam's grids into its sums
// as they come; thread t >= 128 stores its beam's terms (terms: 128 (R -
// 1) beams of wide_beam_floats(kG) floats, 16-byte aligned) and its grid
// mask (128 (R - 1) bytes after them) in shared memory, and after a
// barrier thread t < 128 adds the stored beams t + 128, t + 256, ... in
// order, each one's flagged grids in grid order. So thread t folds beams
// t, t + 128, t + 256, ... with the additions, in the order and with the
// skips of the first design's 128 threads, and ndt_wide_block_sums
// reduces in its order: the first design's bits at any R. At kMaxR = 1
// (128 threads) nothing is stored and no barrier runs before the
// reduction. Every thread must call it.
template <int kG, int kMaxR, class Beam>
__device__ __forceinline__ void wide_beam_sums(int n, Beam&& beam,
                                               float4* terms,
                                               float (*part)[kNdtSums],
                                               float sums[kNdtSums]) {
  constexpr int kBeam4 = ndtpu::wide_beam_floats(kG) / 4;
  const int t = threadIdx.x;
  const int width = kMaxR > 1 ? (int)blockDim.x : kNdtThreads;
  const int held = width - kNdtThreads;
  unsigned char* hit = reinterpret_cast<unsigned char*>(
      terms + (size_t)held * kBeam4);
  float acc[kNdtSums];
#pragma unroll
  for (int k = 0; k < kNdtSums; ++k) acc[k] = 0.f;
  auto add = [&](int, const float* u) {
#pragma unroll
    for (int k = 0; k < kNdtSums; ++k) acc[k] += u[k];
  };
  for (int c0 = 0; c0 < n; c0 += width) {
    const int i = c0 + t;
    if (kMaxR == 1 || t < kNdtThreads) {
      if (i < n) beam(i, add);
    } else {
      float4* mine = terms + (size_t)(t - kNdtThreads) * kBeam4;
      auto store = [&](int g, const float* u) {
        ndtpu::ndt_store_terms(mine, g, u);
      };
      hit[t - kNdtThreads] = (unsigned char)(i < n ? beam(i, store) : 0u);
    }
    if (kMaxR > 1 && held > 0) {
      __syncthreads();                      // the chunk's terms are stored
      if (t < kNdtThreads) {
        // Beams c0 + t + 128, c0 + t + 256, ...: stored slot j = t, t + 128.
        for (int j = t; j < held && c0 + kNdtThreads + j < n;
             j += kNdtThreads) {
          const unsigned on = hit[j];
          const float4* stored = terms + (size_t)j * kBeam4;
#pragma unroll
          for (int g = 0; g < kG; ++g)
            if (on >> g & 1u) ndtpu::ndt_add_stored(acc, stored, g);
        }
      }
      if (c0 + width < n) __syncthreads();  // before the next chunk's stores
    }
  }
  ndtpu::ndt_wide_block_sums(acc, part, sums);
}

// K12 at pose blockIdx.x over the map [kG, nx * ny] (iy-major).
template <int kG, int kMaxR>
__global__ void __launch_bounds__(kNdtThreads * kMaxR)
ndt_sgh_unpacked_kernel(const float* __restrict__ poses,
                        const float2* __restrict__ pts,
                        const float* __restrict__ mask,
                        const float2* __restrict__ mean,
                        const float4* __restrict__ icov,
                        const float* __restrict__ valid,
                        float* __restrict__ out, int n, int nx, int ny,
                        Frame fr, float d2, float exp_clip) {
  extern __shared__ float4 terms[];
  __shared__ float part[kNdtThreads / 32][kNdtSums];
  const int b = blockIdx.x;
  const float tx = poses[3 * b + 0];
  const float ty = poses[3 * b + 1];
  const float phi = poses[3 * b + 2];
  const float c = cosf(phi);
  const float s = sinf(phi);
  const float nh = -0.5f * d2;
  auto beam = [&](int i, auto&& emit) {
    return map_beam<kG, false>(c, s, tx, ty, pts, mask, i, mean, icov,
                               valid, nx, ny, 0, nx, fr, d2, nh, exp_clip,
                               emit);
  };
  float sums[kNdtSums];
  wide_beam_sums<kG, kMaxR>(n, beam, terms, part, sums);
  if (threadIdx.x == 0) {
    float* o = out + (size_t)b * kOut;
    write_fgh(o, sums, d2);
    o[13] = sums[0] / fmaxf(sums[1], 1.f);
  }
}

// K10c: the rank's raw sums over its slab [kG, nx_local, ny] (ix-major),
// grid columns [x_lo, x_lo + nx_local), at pose blockIdx.x.
template <int kG, int kMaxR>
__global__ void __launch_bounds__(kNdtThreads * kMaxR)
slab_sgh_kernel(const float* __restrict__ poses,
                const float2* __restrict__ pts,
                const float* __restrict__ mask,
                const float2* __restrict__ mean,
                const float4* __restrict__ icov,
                const float* __restrict__ valid, float* __restrict__ out,
                int n, int nx, int ny, int x_lo, int nx_local, Frame fr,
                float d2, float exp_clip) {
  extern __shared__ float4 terms[];
  __shared__ float part[kNdtThreads / 32][kNdtSums];
  const int b = blockIdx.x;
  const float tx = poses[3 * b + 0];
  const float ty = poses[3 * b + 1];
  const float phi = poses[3 * b + 2];
  const float c = cosf(phi);
  const float s = sinf(phi);
  const float nh = -0.5f * d2;
  auto beam = [&](int i, auto&& emit) {
    return map_beam<kG, true>(c, s, tx, ty, pts, mask, i, mean, icov,
                              valid, nx, ny, x_lo, nx_local, fr, d2, nh,
                              exp_clip, emit);
  };
  float sums[kNdtSums];
  wide_beam_sums<kG, kMaxR>(n, beam, terms, part, sums);
  if (threadIdx.x == 0) {
    float o[kOut];
    write_fgh(o, sums, d2);
    float* r = out + (size_t)b * kSlabOut;
    r[0] = o[0];
    r[1] = sums[0];
    r[2] = sums[1];
#pragma unroll
    for (int k = 1; k < 13; ++k) r[2 + k] = o[k];
  }
}

// One instantiation's launch at 128 R threads per pose (R = spread):
// dynamic shared memory past the default 48 KB opted in first.
template <class... P, class... A>
int wide_launch(void (*kernel)(P...), int b, int spread, int smem_bytes,
                cudaStream_t stream, A... args) {
  if (smem_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) {
      cudaGetLastError();
      return (int)err;
    }
  }
  kernel<<<b, kNdtThreads * spread, smem_bytes, stream>>>(args...);
  return (int)cudaGetLastError();
}

// The instantiation for (G, R): R 1, <= 4 or <= 8 (K10c has no R = 1
// instantiation: its launches at R = 1 take the <= 4 one).
template <class K>
K pick(const K (&by)[2][3], int grids, int spread) {
  return by[grids == 4][spread == 1 ? 0 : spread <= 4 ? 1 : 2];
}

using SghKernel = decltype(&ndt_sgh_unpacked_kernel<4, 1>);
const SghKernel kSgh[2][3] = {
    {&ndt_sgh_unpacked_kernel<1, 1>, &ndt_sgh_unpacked_kernel<1, 4>,
     &ndt_sgh_unpacked_kernel<1, 8>},
    {&ndt_sgh_unpacked_kernel<4, 1>, &ndt_sgh_unpacked_kernel<4, 4>,
     &ndt_sgh_unpacked_kernel<4, 8>}};

using SlabKernel = decltype(&slab_sgh_kernel<4, 4>);
const SlabKernel kSlabSgh[2][3] = {
    {&slab_sgh_kernel<1, 4>, &slab_sgh_kernel<1, 4>, &slab_sgh_kernel<1, 8>},
    {&slab_sgh_kernel<4, 4>, &slab_sgh_kernel<4, 4>, &slab_sgh_kernel<4, 8>}};

}  // namespace

// `grids` = 4 or 1: the map's overlap grids ([grids, C, ...]); spread = R:
// 128 R threads per pose, 1 <= R <= 8 (kernels.sgh_spread), and
// wide_terms_bytes(grids, R) of dynamic shared memory.
extern "C" int ndt_sgh_unpacked_launch(const void* poses, const void* pts,
                                       const void* mask, const void* mean,
                                       const void* icov, const void* valid,
                                       void* out, int b, int n, int nx,
                                       int ny, float x0, float y0,
                                       float cell, float d2, float exp_clip,
                                       int grids, int spread, void* stream) {
  if (b < 1 || n < 0 || nx < 1 || ny < 1 || (grids != 4 && grids != 1) ||
      spread < 1 || spread > 8)
    return (int)cudaErrorInvalidValue;
  return wide_launch(pick(kSgh, grids, spread), b, spread,
                     ndtpu::wide_terms_bytes(grids, spread),
                     (cudaStream_t)stream, (const float*)poses,
                     (const float2*)pts, (const float*)mask,
                     (const float2*)mean, (const float4*)icov,
                     (const float*)valid, (float*)out, n, nx, ny,
                     Frame{x0, y0, cell, cell / 2.f}, d2, exp_clip);
}

// spread = R: 128 R threads per pose (1 <= R <= 8), smem_bytes >=
// wide_terms_bytes(grids, R) (kernels.slab_spread, kernels.wide_terms_bytes).
extern "C" int slab_sgh_launch(const void* poses, const void* pts,
                               const void* mask, const void* mean,
                               const void* icov, const void* valid, void* out,
                               int b, int n, int nx, int ny, int x_lo,
                               int nx_local, float x0, float y0, float cell,
                               float d2, float exp_clip, int grids,
                               int spread, int smem_bytes, void* stream) {
  if (b < 1 || n < 0 || nx < 1 || ny < 1 || nx_local < 1 ||
      (grids != 4 && grids != 1) || spread < 1 || spread > 8 ||
      smem_bytes < ndtpu::wide_terms_bytes(grids, spread))
    return (int)cudaErrorInvalidValue;
  return wide_launch(pick(kSlabSgh, grids, spread), b, spread,
                     smem_bytes, (cudaStream_t)stream,
                     (const float*)poses, (const float2*)pts,
                     (const float*)mask, (const float2*)mean,
                     (const float4*)icov, (const float*)valid, (float*)out, n,
                     nx, ny, x_lo, nx_local,
                     Frame{x0, y0, cell, cell / 2.f}, d2, exp_clip);
}
