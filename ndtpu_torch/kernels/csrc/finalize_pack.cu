// K4: finalize every NDT cell and write the half-cell quad table directly.
// K4s: the same for S maps in one launch (the stacked multi-session path).
//
// Replaces what XLA lowered for the TPU from ndtpu/ndt/grid.py::finalize
// (:232-254, with _eig2x2_sym :211-229) followed by pack_quad (:336-391,
// compact=False): per-cell mean, covariance, closed-form 2x2 eigenvalues
// with the max(eig_abs_min, eig_ratio * lambda_max) floor, the inverse
// covariance, valid = n >= min_pts; then the x2 upsample, the (gx, gy)
// shift with zero rows outside grid g (pack_quad's jnp.pad), and the
// concatenation of the 4 grids into one 32-float row per half-cell. K4s
// replaces the vmap of both over the S sessions' statistics in
// ndtpu/dist/slam_dp.py::_frontend_stacked (pack8, :300-303).
//
// One block per band of `band_rows` whole lattice rows [h0, h1), whose
// table rows are one contiguous span of the [R, 32] table. Table row hy of
// grid g = (gx, gy) reads cell row (hy - gy) >> 1 (ndt_cell.cuh), so a band
// needs at most band_rows / 2 + 1 cell rows of each grid. The block (as
// many threads as those cells, up to 512)
//   1. finalizes each (grid, cell) of those rows once, one thread per cell,
//      reading n, (sx, sy) and (sxx, sxy, syx, syy) as one 4-, 8- and
//      16-byte load that coalesce along nx, one grid plane at a time, with
//      ndtpu::finalize_pack_cell unchanged, into a shared-memory buffer of
//      [4][grid_stride][8] floats (32 B per cell; grid_stride pads each
//      grid's region so that the 4 grids of one row sit in distinct banks);
//   2. writes the band's rows x wh x 32 floats as consecutive 16-byte
//      stores, thread q taking float4 q of the span: the upsample and the
//      shift are an index into the buffer, and slots outside grid g are
//      zero rows, as before.
// The wrapper (kernels.finalize_bands) cuts bands as thin as the card
// holds at once: one-row bands on an H100 at every published grid, so each
// cell is finalized twice (by the two bands whose rows read it) where the
// one-thread-per-slot kernel this replaces finalized it four times; a
// block has one thread per cell of its band, up to 512 (416 threads at
// config 2, 320 at config 3, 512 for config 5's 1,024 cells). On the H100
// 256-thread blocks were slower at configs 2 and 3 (two rounds of loads
// and finalizes in series) and 1,024-thread blocks at config 5; issuing a
// thread's loads of several cells before their finalizes was slower too.
//
// Layouts (kL lanes per grid slot, ndt_cell.cuh): full rows (kL = 8, 32
// floats per table row) and compact rows (kL = 4, grid.py::pack_quad's
// compact=True: [mu_x, mu_y, pack(i00, i01), pack(i11, valid)] per grid,
// 16 floats per row), the band buffer holding kL / 4 float4 per cell.
// Overlap 1 (finalize_pack_cells_kernel): the table row r is cell r of the
// one grid (pack_quad's overlap-1 branch: no upsample, no shift), one
// thread per cell finalizing it once and storing its kL lanes.
//
// K4s: blockIdx.y is the map (session) s, whose statistics and table are
// shifted by s whole maps; each map's bands are K4's, so K4s equals S
// single K4 launches bit for bit.
//
// What bounds it on Hopper: the table writes (5.2 MB at config 2, 33.7 MB
// at config 5's 513 x 513 lattice) and the statistics reads (1.4 / 7.3
// MB); the arithmetic, two IEEE divides and square roots per cell (no fast
// math) on half the cells, is minor. At configs 2 and 3 a band's chain of
// loads, finalizes, one barrier and stores sets the time, over ~1.5 blocks
// per SM; at config 5 the band's finalizes and its stores do not overlap
// within a block. The op order and the 1e-20 / 1e-30 guards of
// _eig2x2_sym are kept as written, so the table is bit-identical to the
// per-slot kernel's.

#include <cuda_runtime.h>

#include "ndt_cell.cuh"

namespace {

constexpr int kMaxThreads = 512;

// Cells of one grid's region in the buffer: at least `cells`, = 1 mod 4.
__host__ __device__ inline int grid_stride(int band_rows, int nx) {
  const int cells = (band_rows / 2 + 1) * nx;
  return ((cells + 2) & ~3) + 1;
}

// First cell row of grid g that table rows >= h0 read.
__device__ __forceinline__ int first_cell_row(int h0, int g) {
  return max(h0 - (g >> 1), 0) >> 1;
}

template <int kL>
__global__ void __launch_bounds__(kMaxThreads)
finalize_pack_kernel(const float* __restrict__ n_in,
                     const float2* __restrict__ s_in,
                     const float4* __restrict__ ss_in,
                     float4* __restrict__ table, int nx, int ny,
                     int band_rows, float min_pts, float eig_ratio,
                     float eig_abs_min) {
  constexpr int kP = kL / 4;           // float4 per cell slot
  constexpr int kRow = 4 * kP;         // float4 per table row
  extern __shared__ float4 cells[];   // [4][gs] cells x kP float4
  const int wh = 2 * nx + 1;
  const size_t map = blockIdx.y, c4 = 4 * (size_t)nx * ny;   // K4s
  n_in += map * c4;
  s_in += map * c4;
  ss_in += map * c4;
  table += map * (size_t)(2 * ny + 1) * wh * kRow;
  const int h0 = blockIdx.x * band_rows;
  const int h1 = min(h0 + band_rows, 2 * ny + 1);
  const int rows = band_rows / 2 + 1;
  const int gs = grid_stride(band_rows, nx);

  // 1. Finalize the band's cells of each grid.
  for (int t = threadIdx.x; t < 4 * rows * nx; t += blockDim.x) {
    const int g = t / (rows * nx);
    const int rem = t - g * rows * nx;
    const int lr = rem / nx;
    const int i = rem - lr * nx;
    const int j = first_cell_row(h0, g) + lr;
    const int last = min(h1 - 1 - (g >> 1), 2 * ny - 1);   // last uy read
    if (last < 0 || j > (last >> 1)) continue;
    const int cell = (g * ny + j) * nx + i;
    const float2 s = s_in[cell];
    const float4 q = ss_in[cell];
    ndtpu::finalize_pack_cell<kL>(n_in[cell], s.x, s.y, q.x, q.y, q.w,
                                  min_pts, eig_ratio, eig_abs_min,
                                  cells + kP * (g * gs + lr * nx + i));
  }
  __syncthreads();

  // 2. The band's contiguous span of table rows, 16 bytes per thread.
  float4* out = table + (size_t)h0 * wh * kRow;
  const int n4 = (h1 - h0) * wh * kRow;
  for (int q = threadIdx.x; q < n4; q += blockDim.x) {
    const int r = q / kRow;                // row of the span
    const int k = q - r * kRow;            // float4 k of the row: grid k / kP
    const int g = k / kP;
    const int ry = r / wh;
    const int uy = h0 + ry - (g >> 1);     // row of grid g's x2 block
    const int ux = r - ry * wh - (g & 1);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (uy >= 0 && uy < 2 * ny && ux >= 0 && ux < 2 * nx) {
      const int lr = (uy >> 1) - first_cell_row(h0, g);
      v = cells[kP * (g * gs + lr * nx + (ux >> 1)) + (k - g * kP)];
    }
    out[q] = v;
  }
}

// Overlap 1: one thread per (cell, map); row t of the table is cell t.
template <int kL>
__global__ void __launch_bounds__(256)
finalize_pack_cells_kernel(const float* __restrict__ n_in,
                           const float2* __restrict__ s_in,
                           const float4* __restrict__ ss_in,
                           float4* __restrict__ table, int cells,
                           float min_pts, float eig_ratio,
                           float eig_abs_min) {
  const int t = blockIdx.x * 256 + threadIdx.x;
  if (t >= cells) return;
  const size_t i = (size_t)blockIdx.y * cells + t;   // K4s: the map
  const float2 s = s_in[i];
  const float4 q = ss_in[i];
  ndtpu::finalize_pack_cell<kL>(n_in[i], s.x, s.y, q.x, q.y, q.w, min_pts,
                                eig_ratio, eig_abs_min, table + i * (kL / 4));
}

// The shared-memory opt-in above 48 KB, set once per process (per size),
// per instantiation.
int g_smem_opt_in[2] = {48 * 1024, 48 * 1024};

template <int kL>
int launch_bands(const void* n_in, const void* s_in, const void* ss_in,
                 void* table, int maps, int nx, int ny, int band_rows,
                 int bands, int threads, float min_pts, float eig_ratio,
                 float eig_abs_min, int smem_bytes, cudaStream_t stream) {
  if (band_rows < 1 || bands * band_rows < 2 * ny + 1 || threads < 32 ||
      threads > kMaxThreads ||
      smem_bytes < 4 * grid_stride(band_rows, nx) * 4 * kL)
    return (int)cudaErrorInvalidValue;
  int& opted = g_smem_opt_in[kL == 8];
  if (smem_bytes > opted) {
    const cudaError_t err = cudaFuncSetAttribute(
        finalize_pack_kernel<kL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes);
    if (err != cudaSuccess) {
      cudaGetLastError();   // clear it, so the next launch's check is clean
      return (int)err;
    }
    opted = smem_bytes;
  }
  finalize_pack_kernel<kL><<<dim3(bands, maps), threads, smem_bytes,
                             stream>>>(
      (const float*)n_in, (const float2*)s_in, (const float4*)ss_in,
      (float4*)table, nx, ny, band_rows, min_pts, eig_ratio, eig_abs_min);
  return (int)cudaGetLastError();
}

template <int kL>
int launch_cells(const void* n_in, const void* s_in, const void* ss_in,
                 void* table, int maps, int cells, float min_pts,
                 float eig_ratio, float eig_abs_min, cudaStream_t stream) {
  finalize_pack_cells_kernel<kL><<<dim3((cells + 255) / 256, maps), 256, 0,
                                   stream>>>(
      (const float*)n_in, (const float2*)s_in, (const float4*)ss_in,
      (float4*)table, cells, min_pts, eig_ratio, eig_abs_min);
  return (int)cudaGetLastError();
}

}  // namespace

// `maps` maps (1 for K4, S for K4s): statistics [maps, G, C, ...], tables
// [maps, R, G * lanes] with G = overlap (4 or 1) and lanes 8 (full) or 4
// (compact). The band arguments are read at overlap 4 only.
extern "C" int finalize_pack_launch(const void* n_in, const void* s_in,
                                    const void* ss_in, void* table, int maps,
                                    int nx, int ny, int band_rows, int bands,
                                    int threads, float min_pts,
                                    float eig_ratio, float eig_abs_min,
                                    int smem_bytes, int overlap, int lanes,
                                    void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (maps < 1 || (lanes != 8 && lanes != 4) ||
      (overlap != 4 && overlap != 1))
    return (int)cudaErrorInvalidValue;
  if (overlap == 1)
    return lanes == 8 ? launch_cells<8>(n_in, s_in, ss_in, table, maps,
                                        nx * ny, min_pts, eig_ratio,
                                        eig_abs_min, st)
                      : launch_cells<4>(n_in, s_in, ss_in, table, maps,
                                        nx * ny, min_pts, eig_ratio,
                                        eig_abs_min, st);
  return lanes == 8
             ? launch_bands<8>(n_in, s_in, ss_in, table, maps, nx, ny,
                               band_rows, bands, threads, min_pts, eig_ratio,
                               eig_abs_min, smem_bytes, st)
             : launch_bands<4>(n_in, s_in, ss_in, table, maps, nx, ny,
                               band_rows, bands, threads, min_pts, eig_ratio,
                               eig_abs_min, smem_bytes, st);
}
