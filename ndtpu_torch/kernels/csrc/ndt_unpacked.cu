// K12 ndt_sgh_unpacked: the NDT objective, gradient, Hessian and score of
// one shared scan at B poses, on an unpacked NDTMap.
//
// Replaces what XLA lowered for the TPU from jax.vmap of
// ndtpu/ndt/match.py::score_grad_hess (:108) over poses, with
// ndtpu/ndt/grid.py::lookup (:288) and ndtpu/ndt/match.py::point_terms
// (:65) inside it, as ndtpu/slam/merge.py::global_align (:93-100) calls it
// to rank its hypotheses by total mass.
//
// One block per pose b, threads over the N beams of the one scan (read once
// per block from L2: no [B, N] copy). Per beam: the transform, then for
// each of the kG overlap grids (4, or 1 at overlap 1; the shifts of
// ndtpu/ndt/grid.py::_grid_offsets :78-86, (0, 0) alone at overlap 1) the
// cell index exactly as cell_ids computes it (((x - x0) - shift) / cell,
// floor, in-bounds test; the per-grid shift, unlike the quad lattice's
// shared half-cell index), a gather of the
// cell's mean (float2), inverse covariance (float4, its three unique
// entries used) and valid flag, and the 11 sums of ndt_sums.cuh's
// ndt_add_terms. A beam that is masked, out of a grid or in an invalid
// cell adds exactly zero in the plain version (w0 = 0), so it is skipped.
// The block reduces its sums in a fixed order (ndt_block_sums; no float
// atomics, so repeated launches are bit-equal), and thread 0 writes
// out[b] = (f, g0, g1, g2, H00..H22, score) with score = wsum / max(w0sum,
// 1), as score_grad_hess returns them.
//
// K10c slab_sgh (slab_sgh_kernel below) computes the same terms on one
// rank's x-slab of a spatially sharded map: it replaces the per-rank sgh
// of ndtpu/dist/gridmap.py::match_slab (:189-209: transform_terms,
// _cell_xy, the ownership mask mine = x_lo <= ix < x_lo + nx_local, the
// clipped ix-major gather from [G, nx_local, ny] and point_terms with w0 =
// valid * (mine & inb) * mask), before its psum. A beam outside the rank's
// slab adds exactly zero there, so it is skipped. It writes the 15 raw
// sums out[b] = (f, wsum, w0sum, g0..g2, H00..H22), the vector the
// reference psums. match_slab launches it once per LM evaluation with B =
// 1 (N = 360 at config 5): one block of 128 R threads per pose, one beam
// per thread (R = min(ceil(N / 128), 8), kernels.slab_spread; chunks of
// 128 R beams past that), each beam's kG cells loaded together at clamped
// addresses before any test, and the terms of threads t >= 128 stored in
// shared memory and replayed by thread t < 128 in the first design's order
// (ndt_sums.cuh's scheme for lm_ndt, with a grid mask per stored beam): so
// a rank's partial is the first design's bits, the same on every launch.
// The first design (128 threads, each walking beams t, t + 128, ... and
// their grids in series, the cell loads behind the tests) lost most of
// its ~5-9 us to that serial chain of dependent L2 loads.
//
// Both kernels are templates on kG, the grid count of the map ([kG, C,
// ...] for K12, [kG, nx_local, ny, ...] ix-major for K10c); each is its own
// instantiation, counted apart by the wrappers (ndt_sgh_unpacked[g1],
// slab_sgh[g1]). The block reduction is the same at either kG.
//
// What bounds them on Hopper: the operations, ~300 f32 flops per in-map
// beam at kG = 4, ~90 at kG = 1 (the map, 7 MB at config 5's 4 x 65,536
// cells, stays in the 50 MB L2); the cell gathers are dependent loads, so
// latency-bound below a few thousand poses. Built with --fmad=false like
// the plain version's separate elementwise ops.

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

template <int kG>
__global__ void __launch_bounds__(kNdtThreads)
ndt_sgh_unpacked_kernel(const float* __restrict__ poses,
                        const float2* __restrict__ pts,
                        const float* __restrict__ mask,
                        const float2* __restrict__ mean,
                        const float4* __restrict__ icov,
                        const float* __restrict__ valid,
                        float* __restrict__ out, int n, int nx, int ny,
                        float x0, float y0, float cell, float d2,
                        float exp_clip) {
  __shared__ float part[kNdtThreads / 32][kNdtSums];
  __shared__ float sums[kNdtSums];
  const int b = blockIdx.x;
  const float tx = poses[3 * b + 0];
  const float ty = poses[3 * b + 1];
  const float phi = poses[3 * b + 2];
  const float c = cosf(phi);
  const float s = sinf(phi);
  const float nh = -0.5f * d2;
  const float h = cell / 2.f;
  const size_t n_cells = (size_t)nx * ny;

  float acc[kNdtSums];
#pragma unroll
  for (int k = 0; k < kNdtSums; ++k) acc[k] = 0.f;

  for (int i = threadIdx.x; i < n; i += kNdtThreads) {
    const float m = mask[i];
    if (m == 0.f) continue;
    const float2 p = pts[i];
    const float x = c * p.x - s * p.y + tx;
    const float y = s * p.x + c * p.y + ty;
    const float dpx = -s * p.x - c * p.y;
    const float dpy = c * p.x - s * p.y;
    const float rx = x - tx;
    const float ry = y - ty;
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      const float ox = (g & 1) ? h : 0.f;
      const float oy = (g & 2) ? h : 0.f;
      const float fx = floorf(((x - x0) - ox) / cell);
      const float fy = floorf(((y - y0) - oy) / cell);
      if (!(fx >= 0.f && fx < (float)nx && fy >= 0.f && fy < (float)ny))
        continue;
      const size_t id = g * n_cells + (size_t)((int)fy * nx + (int)fx);
      const float v = __ldg(valid + id);
      if (v == 0.f) continue;
      const float2 mu = __ldg(mean + id);
      const float4 ic = __ldg(icov + id);     // i00, i01, i10, i11
      ndtpu::ndt_add_terms(acc, x, y, dpx, dpy, rx, ry, mu.x, mu.y, ic.x,
                           ic.y, ic.w, v * m, d2, nh, exp_clip);
    }
  }
  const float v = ndtpu::ndt_block_sums(acc, part);
  if (threadIdx.x < kNdtSums) sums[threadIdx.x] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    float* o = out + (size_t)b * kOut;
    write_fgh(o, sums, d2);
    o[13] = sums[0] / fmaxf(sums[1], 1.f);
  }
}

// K10c's beam i at the pose (c, s, tx, ty) on the slab: every grid's cell
// binned (cell_ids' per-grid shift), clamped into the slab and its valid
// flag, mean and inverse covariance loaded before any test, so the kG
// gathers are in flight together; then, in grid order, emit(g, t) with the
// 11 terms of each grid that counts (the beam unmasked, the cell in the
// map and owned by the rank, valid). Returns those grids as a bit mask,
// exactly the (beam, grid) pairs the first design added.
template <int kG, class Emit>
__device__ __forceinline__ unsigned slab_beam(
    float c, float s, float tx, float ty, const float2* __restrict__ pts,
    const float* __restrict__ mask, int i, const float2* __restrict__ mean,
    const float4* __restrict__ icov, const float* __restrict__ valid, int nx,
    int ny, int x_lo, int nx_local, float x0, float y0, float cell, float h,
    float d2, float nh, float exp_clip, Emit&& emit) {
  const float m = __ldg(mask + i);
  const float2 p = __ldg(pts + i);
  const float x = c * p.x - s * p.y + tx;
  const float y = s * p.x + c * p.y + ty;
  const size_t slab_cells = (size_t)nx_local * ny;
  bool use[kG];
  float v[kG];
  float2 mu[kG];
  float4 ic[kG];
#pragma unroll
  for (int g = 0; g < kG; ++g) {
    const float ox = (g & 1) ? h : 0.f;
    const float oy = (g & 2) ? h : 0.f;
    const float fx = floorf(((x - x0) - ox) / cell);
    const float fy = floorf(((y - y0) - oy) / cell);
    const bool inb = fx >= 0.f && fx < (float)nx && fy >= 0.f &&
                     fy < (float)ny;
    // Clamped in float first (a NaN clamps to 0), so any beam has an
    // address in the slab; only the tests below decide what counts.
    const int ix = (int)fminf(fmaxf(fx, 0.f), (float)(nx - 1));
    const int iy = (int)fminf(fmaxf(fy, 0.f), (float)(ny - 1));
    const int lx = ix - x_lo;
    use[g] = m != 0.f && inb && lx >= 0 && lx < nx_local;
    const int lc = min(max(lx, 0), nx_local - 1);
    const size_t id = g * slab_cells + (size_t)lc * ny + iy;
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

// K10c: the rank's raw sums over its slab [kG, nx_local, ny] (ix-major),
// grid columns [x_lo, x_lo + nx_local), at pose blockIdx.x. The block is
// 128 R threads (R = blockDim.x / 128 <= kMaxR), one beam each, in chunks
// of 128 R beams. Thread t < 128 adds its own beam's grids into its sums
// as they come; thread t >= 128 stores its beam's terms (terms: 128 (R -
// 1) beams of wide_beam_floats(kG) floats, 16-byte aligned) and its grid
// mask (hit: 128 (R - 1) bytes) in shared memory, and after a barrier
// thread t < 128 adds the stored beams t + 128, t + 256, ... in order,
// each one's flagged grids in grid order. So thread t folds beams t, t +
// 128, t + 256, ... with the additions, in the order and with the skips of
// the first design's 128 threads, and ndt_wide_block_sums reduces in its
// order: the first design's bits at any R.
template <int kG, int kMaxR>
__global__ void __launch_bounds__(kNdtThreads * kMaxR)
slab_sgh_kernel(const float* __restrict__ poses,
                const float2* __restrict__ pts,
                const float* __restrict__ mask,
                const float2* __restrict__ mean,
                const float4* __restrict__ icov,
                const float* __restrict__ valid, float* __restrict__ out,
                int n, int nx, int ny, int x_lo, int nx_local, float x0,
                float y0, float cell, float d2, float exp_clip) {
  constexpr int kBeam4 = ndtpu::wide_beam_floats(kG) / 4;
  extern __shared__ float4 terms[];
  __shared__ float part[kNdtThreads / 32][kNdtSums];
  const int b = blockIdx.x, t = threadIdx.x;
  const int width = blockDim.x, held = width - kNdtThreads;
  unsigned char* hit = reinterpret_cast<unsigned char*>(
      terms + (size_t)held * kBeam4);
  const float tx = poses[3 * b + 0];
  const float ty = poses[3 * b + 1];
  const float phi = poses[3 * b + 2];
  const float c = cosf(phi);
  const float s = sinf(phi);
  const float nh = -0.5f * d2;
  const float h = cell / 2.f;

  float acc[kNdtSums];
#pragma unroll
  for (int k = 0; k < kNdtSums; ++k) acc[k] = 0.f;
  auto add = [&](int, const float* u) {
#pragma unroll
    for (int k = 0; k < kNdtSums; ++k) acc[k] += u[k];
  };
  for (int c0 = 0; c0 < n; c0 += width) {
    const int i = c0 + t;
    if (t < kNdtThreads) {
      if (i < n)
        slab_beam<kG>(c, s, tx, ty, pts, mask, i, mean, icov, valid, nx, ny,
                      x_lo, nx_local, x0, y0, cell, h, d2, nh, exp_clip,
                      add);
    } else {
      float4* mine = terms + (size_t)(t - kNdtThreads) * kBeam4;
      auto store = [&](int g, const float* u) {
        ndtpu::ndt_store_terms(mine, g, u);
      };
      unsigned on = 0;
      if (i < n)
        on = slab_beam<kG>(c, s, tx, ty, pts, mask, i, mean, icov, valid, nx,
                           ny, x_lo, nx_local, x0, y0, cell, h, d2, nh,
                           exp_clip, store);
      hit[t - kNdtThreads] = (unsigned char)on;
    }
    if (held > 0) {
      __syncthreads();                      // the chunk's terms are stored
      if (t < kNdtThreads) {
        // Beams c0 + t + 128, c0 + t + 256, ...: stored slot j = t, t + 128.
        for (int j = t; j < held && c0 + kNdtThreads + j < n;
             j += kNdtThreads) {
          const unsigned on = hit[j];
          const float4* beam = terms + (size_t)j * kBeam4;
#pragma unroll
          for (int g = 0; g < kG; ++g)
            if (on >> g & 1u) ndtpu::ndt_add_stored(acc, beam, g);
        }
      }
      if (c0 + width < n) __syncthreads();  // before the next chunk's stores
    }
  }
  float sums[kNdtSums];
  ndtpu::ndt_wide_block_sums(acc, part, sums);
  if (t == 0) {
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

// One K10c instantiation's launch: dynamic shared memory past the default
// 48 KB opted in first.
template <int kG, int kMaxR>
int slab_launch(int b, int spread, int smem_bytes, cudaStream_t stream,
                const float* poses, const float2* pts, const float* mask,
                const float2* mean, const float4* icov, const float* valid,
                float* out, int n, int nx, int ny, int x_lo, int nx_local,
                float x0, float y0, float cell, float d2, float exp_clip) {
  if (smem_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        slab_sgh_kernel<kG, kMaxR>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) {
      cudaGetLastError();
      return (int)err;
    }
  }
  slab_sgh_kernel<kG, kMaxR>
      <<<b, kNdtThreads * spread, smem_bytes, stream>>>(
          poses, pts, mask, mean, icov, valid, out, n, nx, ny, x_lo,
          nx_local, x0, y0, cell, d2, exp_clip);
  return (int)cudaGetLastError();
}

}  // namespace

// `grids` = 4 or 1: the map's overlap grids ([grids, C, ...]).
extern "C" int ndt_sgh_unpacked_launch(const void* poses, const void* pts,
                                       const void* mask, const void* mean,
                                       const void* icov, const void* valid,
                                       void* out, int b, int n, int nx,
                                       int ny, float x0, float y0,
                                       float cell, float d2, float exp_clip,
                                       int grids, void* stream) {
  if (b < 1 || n < 0 || nx < 1 || ny < 1 || (grids != 4 && grids != 1))
    return (int)cudaErrorInvalidValue;
  auto* kernel = grids == 4 ? &ndt_sgh_unpacked_kernel<4>
                            : &ndt_sgh_unpacked_kernel<1>;
  kernel<<<b, kNdtThreads, 0, (cudaStream_t)stream>>>(
      (const float*)poses, (const float2*)pts, (const float*)mask,
      (const float2*)mean, (const float4*)icov, (const float*)valid,
      (float*)out, n, nx, ny, x0, y0, cell, d2, exp_clip);
  return (int)cudaGetLastError();
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
  auto* run = grids == 4 ? (spread <= 4 ? &slab_launch<4, 4>
                                        : &slab_launch<4, 8>)
                         : (spread <= 4 ? &slab_launch<1, 4>
                                        : &slab_launch<1, 8>);
  return run(b, spread, smem_bytes, (cudaStream_t)stream,
             (const float*)poses, (const float2*)pts, (const float*)mask,
             (const float2*)mean, (const float4*)icov, (const float*)valid,
             (float*)out, n, nx, ny, x_lo, nx_local, x0, y0, cell, d2,
             exp_clip);
}
