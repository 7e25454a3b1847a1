// K4: finalize every NDT cell and write the half-cell quad table directly.
//
// Replaces what XLA lowered for the TPU from ndtpu/ndt/grid.py::finalize
// (:232-254, with _eig2x2_sym :211-229) followed by pack_quad (:336-391,
// compact=False): per-cell mean, covariance, closed-form 2x2 eigenvalues
// with the max(eig_abs_min, eig_ratio * lambda_max) floor, the inverse
// covariance, valid = n >= min_pts; then the x2 upsample, the (gx, gy)
// shift with zero rows outside grid g (pack_quad's jnp.pad), and the
// concatenation of the 4 grids into one 32-float row per half-cell.
//
// One thread per (half-cell r, grid g) writes its 8 floats
// [mu_x, mu_y, i00, i01, i11, valid, 0, 0] at table[r, 8g .. 8g+7]; four
// neighbouring threads fill one 128-byte row, so the stores coalesce. Each
// cell is finalized by the 4 threads of its 2x2 block (recomputing ~40
// flops is cheaper than a second pass). No NDTMap is materialized on the
// card path.
//
// What bounds it on Hopper: the writes (5.2 MB at config 2) and the stats
// reads (~1.4 MB); the arithmetic, including two IEEE divides and sqrts per
// cell (no fast math), is minor. The op order and the 1e-20 / 1e-30 guards
// of _eig2x2_sym are kept as written.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
finalize_pack_kernel(const float* __restrict__ n_in,
                     const float* __restrict__ s_in,
                     const float* __restrict__ ss_in,
                     float4* __restrict__ table, int nx, int ny,
                     float min_pts, float eig_ratio, float eig_abs_min) {
  const int wh = 2 * nx + 1, hh = 2 * ny + 1;
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= 4 * wh * hh) return;
  const int r = t >> 2;
  const int g = t & 3;
  const int hy = r / wh;
  const int hx = r - hy * wh;
  const int uy = hy - (g >> 1);   // row of grid g's x2-upsampled block
  const int ux = hx - (g & 1);
  float4* out = table + (size_t)t * 2;
  if (uy < 0 || uy >= 2 * ny || ux < 0 || ux >= 2 * nx) {
    out[0] = make_float4(0.f, 0.f, 0.f, 0.f);
    out[1] = make_float4(0.f, 0.f, 0.f, 0.f);
    return;
  }
  const int cell = g * nx * ny + (uy >> 1) * nx + (ux >> 1);
  const float n = n_in[cell];
  const float safe_n = fmaxf(n, 1.f);
  const float mx = s_in[2 * cell + 0] / safe_n;
  const float my = s_in[2 * cell + 1] / safe_n;
  const float a = ss_in[4 * cell + 0] / safe_n - mx * mx;
  const float b = ss_in[4 * cell + 1] / safe_n - mx * my;
  const float c = ss_in[4 * cell + 3] / safe_n - my * my;
  // _eig2x2_sym
  const float half_tr = 0.5f * (a + c);
  const float amc = a - c;
  const float d = sqrtf(fmaxf(0.25f * (amc * amc) + b * b, 0.f));
  const float l1 = half_tr + d;
  const float l2 = half_tr - d;
  const bool b_small = fabsf(b) <= 1e-20f;
  const float vx = b_small ? (a >= c ? 1.f : 0.f) : b;
  const float vy = b_small ? (a >= c ? 0.f : 1.f) : l1 - a;
  float nrm = sqrtf(vx * vx + vy * vy);
  nrm = nrm <= 1e-30f ? 1.f : nrm;
  const float v1x = vx / nrm, v1y = vy / nrm;
  // finalize
  const float lmax = fmaxf(l1, eig_abs_min);
  const float lmin = fmaxf(l2, fmaxf(eig_ratio * lmax, eig_abs_min));
  const float v2x = -v1y, v2y = v1x;
  const float i00 = v1x * v1x / lmax + v2x * v2x / lmin;
  const float i01 = v1x * v1y / lmax + v2x * v2y / lmin;
  const float i11 = v1y * v1y / lmax + v2y * v2y / lmin;
  const float valid = n >= min_pts ? 1.f : 0.f;
  out[0] = make_float4(mx, my, i00, i01);
  out[1] = make_float4(i11, valid, 0.f, 0.f);
}

}  // namespace

extern "C" int finalize_pack_launch(const void* n_in, const void* s_in,
                                    const void* ss_in, void* table, int nx,
                                    int ny, float min_pts, float eig_ratio,
                                    float eig_abs_min, void* stream) {
  const int total = 4 * (2 * nx + 1) * (2 * ny + 1);
  const int blocks = (total + kThreads - 1) / kThreads;
  finalize_pack_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)n_in, (const float*)s_in, (const float*)ss_in,
      (float4*)table, nx, ny, min_pts, eig_ratio, eig_abs_min);
  return (int)cudaGetLastError();
}
