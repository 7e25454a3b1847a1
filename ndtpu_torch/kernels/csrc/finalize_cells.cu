// K10b finalize_cells: the Gaussian of every NDT cell from its sums, in
// the statistics' own layout (no quad pack).
//
// Replaces what XLA lowered for the TPU from ndtpu/ndt/grid.py::finalize
// (:232-254, with _eig2x2_sym :211-229), elementwise over any leading shape,
// as ndtpu/dist/gridmap.py::finalize_slab (:167) calls it on the slab
// layout [G, nx_local, ny] and the dense one [G, C] alike.
//
// Two input layouts, a template parameter:
//   kArrays:  three arrays, n [cells], s [cells] (float2), ss [cells]
//             (float4: sxx, sxy, syx, syy): K3's dense statistics;
//   kRecords: one 28-byte record per cell, [n, sx, sy, sxx, sxy, syx, syy],
//             as the slab map's halo exchange packs them
//             (dist/gridmap.py::_exchange), read where they lie: no copy
//             stands between the exchange and this kernel.
//
// One thread per cell t, a grid sized to the cells (256 threads a block;
// 32 to 512 for the sweep): the cell's sums in,
// ndt_cell.cuh's finalize_pack_cell (the device function K4 and K8a run:
// mean, the eigenvalue-floored inverse covariance, valid, in the plain
// version's op order) into registers, mean[t] (float2), icov[t] (float4:
// i00, i01, i01, i11) and valid[t] out. Built with --fmad=false and
// without fast math, as the plain version's separate elementwise ops: the
// outputs have the same bits in either layout.
//
// What profile_port.py --finalize-sweep rejected while it swept them: 2
// or 4 cells a thread with every load before the first division and
// 16-byte stores of two means or four valid flags (slower: the serial
// chains of IEEE divisions did not overlap, and the grid had 2-4 x fewer
// threads to hide them), a persistent grid (no faster), and a block
// staging its run of records through shared memory with 16-byte loads
// (slower than each thread loading its own 28 bytes).
//
// What bounds it on Hopper: bytes, 28 B read and 28 B written per cell
// (the ~60 f32 operations of the eigen floor are far below the card's rate
// per byte); at the slab's 131,072 cells (half a wave) the launch, one
// load round trip and the chain of 13 divisions and square roots are most
// of its time.

#include <cuda_runtime.h>

#include "ndt_cell.cuh"

namespace {

constexpr int kArrays = 0;
constexpr int kRecords = 1;
constexpr int kRecordFloats = 7;

// kThreads a compile-time constant: a cell's index without reading the
// block size (a little faster on the dense map than blockDim.x).
template <int kLayout, int kThreads>
__global__ void __launch_bounds__(kThreads) finalize_cells_kernel(
    const float* __restrict__ n, const float2* __restrict__ s,
    const float4* __restrict__ ss, const float* __restrict__ rec,
    float2* __restrict__ mean, float4* __restrict__ icov,
    float* __restrict__ valid, long long cells, float min_pts,
    float eig_ratio, float eig_abs_min) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= cells) return;
  float cn, sx, sy, sxx, sxy, syy;
  if constexpr (kLayout == kRecords) {
    const float* r = rec + kRecordFloats * t;
    cn = r[0]; sx = r[1]; sy = r[2]; sxx = r[3]; sxy = r[4]; syy = r[6];
  } else {
    const float2 sv = s[t];
    const float4 q = ss[t];
    cn = n[t]; sx = sv.x; sy = sv.y; sxx = q.x; sxy = q.y; syy = q.w;
  }
  float4 cell[2];
  ndtpu::finalize_pack_cell(cn, sx, sy, sxx, sxy, syy, min_pts, eig_ratio,
                            eig_abs_min, cell);
  // cell = [mu_x, mu_y, i00, i01], [i11, valid, 0, 0]
  mean[t] = make_float2(cell[0].x, cell[0].y);
  icov[t] = make_float4(cell[0].z, cell[0].w, cell[0].w, cell[1].x);
  valid[t] = cell[1].y;
}

template <int kThreads>
int launch(const void* n, const void* s, const void* ss, const void* rec,
           void* mean, void* icov, void* valid, long long cells,
           float min_pts, float eig_ratio, float eig_abs_min, int layout,
           cudaStream_t stream) {
  const long long blocks = (cells + kThreads - 1) / kThreads;
  auto kernel = layout == kRecords
      ? finalize_cells_kernel<kRecords, kThreads>
      : finalize_cells_kernel<kArrays, kThreads>;
  kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(
      (const float*)n, (const float2*)s, (const float4*)ss,
      (const float*)rec, (float2*)mean, (float4*)icov, (float*)valid, cells,
      min_pts, eig_ratio, eig_abs_min);
  return (int)cudaGetLastError();
}

}  // namespace

// layout 0: n [cells], s [cells, 2], ss [cells, 2, 2] f32 (rec unused);
// layout 1: rec [cells, 7] f32 (n, s, ss unused). Out: mean [cells, 2],
// icov [cells, 2, 2], valid [cells] f32. threads per block: 32, 64, 128,
// 256 or 512.
extern "C" int finalize_cells_launch(const void* n, const void* s,
                                     const void* ss, const void* rec,
                                     void* mean, void* icov, void* valid,
                                     long long cells, float min_pts,
                                     float eig_ratio, float eig_abs_min,
                                     int layout, int threads, void* stream) {
  if (cells < 1 || (layout != kArrays && layout != kRecords))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (threads) {
#define FINALIZE_CELLS_CASE(T)                                            \
    case T:                                                               \
      return launch<T>(n, s, ss, rec, mean, icov, valid, cells, min_pts,  \
                       eig_ratio, eig_abs_min, layout, st);
    FINALIZE_CELLS_CASE(32)
    FINALIZE_CELLS_CASE(64)
    FINALIZE_CELLS_CASE(128)
    FINALIZE_CELLS_CASE(256)
    FINALIZE_CELLS_CASE(512)
#undef FINALIZE_CELLS_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}
