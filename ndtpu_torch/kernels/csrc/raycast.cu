// K11 raycast: the range of every (pose, beam) of a synthetic scan, the
// nearest ray/segment hit over the world's wall segments.
//
// Replaces what XLA lowered for the TPU from ndtpu/data/synth.py::raycast
// (:124-144): a broadcasted intersection over [..., N, S] reduced by a min
// over the S segments. Here nothing of [T, N, S] is materialized.
//
// One thread per (pose p, beam n). The block stages every segment's start
// a[s] and direction ab[s] = b[s] - a[s] in shared memory; each thread
// walks the S segments with its running minimum in registers. The tests
// are the plain version's: |denom| >= eps, t > 1e-4, 0 <= u <= 1, and a
// miss counts as max_range; the arithmetic follows its operation order,
// so with --fmad=false (no contraction) and no fast math only the
// library's sin/cos can differ from the CPU's. Instantiated for double
// (make_sequence simulates in f64) and float.
//
// What bounds it on Hopper: operations, about 18 per (pose, beam,
// segment) in the element type (2 products and a difference for denom,
// 4 and 2 for the numerators, 2 divisions, the tests and the min); the
// bytes are the poses and angles in and the ranges out.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
raycast_kernel(const T* __restrict__ poses, const T* __restrict__ angles,
               const T* __restrict__ segments, T* __restrict__ ranges,
               int n_poses, int n_beams, int n_seg, T max_range, T eps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sa = reinterpret_cast<T*>(smem_raw);       // [S, 2] a
  T* sab = sa + 2 * n_seg;                       // [S, 2] b - a
  for (int s = threadIdx.x; s < n_seg; s += blockDim.x) {
    const T ax = segments[4 * s + 0], ay = segments[4 * s + 1];
    sa[2 * s + 0] = ax;
    sa[2 * s + 1] = ay;
    sab[2 * s + 0] = segments[4 * s + 2] - ax;
    sab[2 * s + 1] = segments[4 * s + 3] - ay;
  }
  __syncthreads();
  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= (long long)n_poses * n_beams) return;
  const int p = (int)(idx / n_beams);
  const int n = (int)(idx - (long long)p * n_beams);
  const T px = poses[3 * p + 0], py = poses[3 * p + 1];
  const T th = poses[3 * p + 2] + angles[n];
  const T dx = cos(th), dy = sin(th);
  const T small = (T)1e-4, zero = (T)0, one = (T)1;
  T best = max_range;
  for (int s = 0; s < n_seg; ++s) {
    const T abx = sab[2 * s + 0], aby = sab[2 * s + 1];
    const T aox = sa[2 * s + 0] - px, aoy = sa[2 * s + 1] - py;
    const T denom = dx * aby - dy * abx;
    const bool ok = fabs(denom) >= eps;
    const T den = ok ? denom : one;
    const T t = (aox * aby - aoy * abx) / den;
    const T u = (aox * dy - aoy * dx) / den;
    const T v = (ok && t > small && u >= zero && u <= one) ? t : max_range;
    best = (s == 0 || v < best) ? v : best;
  }
  ranges[idx] = best;
}

template <typename T>
int launch(const void* poses, const void* angles, const void* segments,
           void* ranges, int n_poses, int n_beams, int n_seg, double max_range,
           double eps, void* stream) {
  if (n_poses < 1 || n_beams < 1 || n_seg < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = 4 * sizeof(T) * (size_t)n_seg;
  if (smem > 49152) return -1;      // the wrapper raises ValueError
  const long long lanes = (long long)n_poses * n_beams;
  const long long blocks = (lanes + kThreads - 1) / kThreads;
  raycast_kernel<T><<<(unsigned)blocks, kThreads, smem,
                      (cudaStream_t)stream>>>(
      (const T*)poses, (const T*)angles, (const T*)segments, (T*)ranges,
      n_poses, n_beams, n_seg, (T)max_range, (T)eps);
  return (int)cudaGetLastError();
}

}  // namespace

// poses [P, 3], angles [N], segments [S, 2, 2] in; ranges [P, N] out; all
// f64 (f64 = 1) or all f32 (f64 = 0). Returns -1 when the S segments do
// not fit the block's 48 KB of shared memory.
extern "C" int raycast_launch(const void* poses, const void* angles,
                              const void* segments, void* ranges, int n_poses,
                              int n_beams, int n_seg, double max_range,
                              double eps, int f64, void* stream) {
  return f64 ? launch<double>(poses, angles, segments, ranges, n_poses,
                              n_beams, n_seg, max_range, eps, stream)
             : launch<float>(poses, angles, segments, ranges, n_poses,
                             n_beams, n_seg, max_range, eps, stream);
}
