// K11 raycast: the range of every (pose, beam) of a synthetic scan, the
// nearest ray/segment hit over the world's wall segments.
//
// Replaces what XLA lowered for the TPU from ndtpu/data/synth.py::raycast
// (:124-144): a broadcasted intersection over [..., N, S] reduced by a min
// over the S segments. Here nothing of [T, N, S] is materialized.
//
// One block per (pose p, chunk of at most 256 beams), one thread per beam,
// neighbouring beams in neighbouring lanes. The block stages the segments
// in shared-memory tiles of kTile, in segment order: each segment's
// direction ab = b - a, its start relative to the pose ao = a - (px, py)
// and the t numerator tn = ao.x ab.y - ao.y ab.x, which depend on the pose
// and not on the beam. Every thread walks tile after tile with its running
// minimum in registers, so the minimum sees the segments in the plain
// version's order and any S fits.
//
// The plain version, per segment: denom = dx ab.y - dy ab.x, ok = |denom|
// >= eps, t = tn / den and u = (ao.x dy - ao.y dx) / den with den = ok ?
// denom : 1, v = (ok && t > 1e-4 && 0 <= u <= 1) ? t : max_range, and
// best = (s == 0 || v < best) ? v : best. The same expressions in the same
// order here (--fmad=false, no fast math: every product, difference and
// quotient rounds as on the CPU; only the library's sin/cos may differ).
//
// Division only where a hit can win. A segment with D = |denom| >= lo =
// max(eps, 2^-60) is first tested without dividing, with sigma the sign
// of denom (so t = TN / D and u = UN / D for TN = sigma tn, UN = sigma un,
// exactly), m = 2^-40 in f64 and 2^-16 in f32, and u the unit roundoff
// (2^-53, 2^-24); RN is round to nearest, which is monotone:
//   - TN <= 0, or TN < 2^-1042 (its high word <= 0, tested on the integer
//     pipe): t <= 0, or t < 2^-982, so RN(t) > 1e-4 fails: a miss;
//   - TN >= RN(D * bm), bm = RN(best (1 + m)), kept only while 2^-60 <=
//     best <= max_range (else +inf, and +inf until segment 0 has set
//     best): then t >= best (1 + m)(1 - u)^2 >= best exactly, so RN(t) >=
//     best, and a hit cannot lower best; nor can a miss, as best <=
//     max_range;
//   - UN < -D m (D m exact, a power of two times D >= 2^-60): u < -m, so
//     RN(u) <= -m < 0: a miss (a u that rounds to -0 is |u| < 2^-1074 and
//     never rejected);
//   - UN > RN(D + D m) >= D (1 + m)(1 - u): u > 1 + u_roundoff, so RN(u)
//     >= 1 + 2 u_roundoff > 1: a miss (a u that rounds to 1 is never
//     rejected).
// m > 2u / (1 - u)^2 in both types, and no product underflows (D, bm >=
// 2^-60 give >= 2^-120, normal in f32) or, overflowing to +inf, rejects.
// A rejected segment takes the plain version's update for v = max_range:
// best = max_range where s == 0 or max_range < best (a flag kept beside
// best), which the second test leaves as it is. Every other segment (eps
// <= D < lo, and those that pass) takes the plain version's two divisions
// and tests, and |denom| < eps is the plain version's miss. So every
// range is the plain computation's bits, by this argument and not by
// measurement.
//
// What bounds it on Hopper: operations, about 18 per (pose, beam,
// segment) in the element type as the plain version counts them (2
// products and a difference for denom, 4 and 2 for the numerators, 2
// divisions, the tests and the min); the bytes are the poses and angles in
// and the ranges out. Under --fmad=false each product and sum issues
// alone, so the FP64 pipe needs about twice that bound for the same 18.
// This design takes the divisions (about 10 FP64 issue slots each) out of
// all but the few segments a beam can hit first, and the t numerator out
// of the beam loop: a rejected segment costs the denominator, one product
// and two FP64 tests (the signs are integer work), and the u numerator
// with two more tests where t passes. (Testing segments four at a time
// without branches, or two beams per thread, measured slower on the H100:
// PERF.md.)

#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kTile = 1024;

template <typename T> struct Pair;
template <> struct Pair<double> { using type = double2; };
template <> struct Pair<float> { using type = float2; };

// The rejection's relative margin m (a power of two) and the smallest
// |denom| and best it is tried with.
template <typename T> __device__ __forceinline__ T margin();
template <> __device__ __forceinline__ double margin<double>() {
  return 0x1p-40;
}
template <> __device__ __forceinline__ float margin<float>() {
  return 0x1p-16f;
}

template <typename T>
__device__ __forceinline__ T tiny() {
  return (T)0x1p-60;
}

template <typename T> __device__ __forceinline__ T infinity();
template <> __device__ __forceinline__ double infinity<double>() {
  return __longlong_as_double(0x7ff0000000000000LL);
}
template <> __device__ __forceinline__ float infinity<float>() {
  return __int_as_float(0x7f800000);
}

// x with its sign flipped where s's sign bit is set: sigma x for s =
// denom, one integer operation (denom is nonzero where it is used).
constexpr int kSignBit = (int)0x80000000u;
__device__ __forceinline__ double flip_by(double x, double s) {
  return __hiloint2double(__double2hiint(x) ^ (__double2hiint(s) & kSignBit),
                          __double2loint(x));
}
__device__ __forceinline__ float flip_by(float x, float s) {
  return __int_as_float(__float_as_int(x) ^ (__float_as_int(s) & kSignBit));
}

// x > 0 up to the subnormals, on the integer pipe: false for x <= 0 and
// for 0 < x < 2^-1042 (f64; in f32 exactly x > 0); true for +NaN.
__device__ __forceinline__ bool positive(double x) {
  return __double2hiint(x) > 0;
}
__device__ __forceinline__ bool positive(float x) {
  return __float_as_int(x) > 0;
}

// The plain version's value of one segment for one beam: its two
// divisions and tests.
template <typename T>
__device__ __forceinline__ T plain_value(T denom, T tn, T aox, T aoy, T dx,
                                         T dy, T eps, T max_range) {
  const bool ok = fabs(denom) >= eps;
  const T den = ok ? denom : (T)1;
  const T t = tn / den;
  const T u = (aox * dy - aoy * dx) / den;
  return (ok && t > (T)1e-4 && u >= (T)0 && u <= (T)1) ? t : max_range;
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
raycast_kernel(const T* __restrict__ poses, const T* __restrict__ angles,
               const T* __restrict__ segments, T* __restrict__ ranges,
               int n_beams, int n_seg, int chunks, int per, T max_range,
               T eps) {
  using T2 = typename Pair<T>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tile = n_seg < kTile ? n_seg : kTile;
  T2* s_ab = reinterpret_cast<T2*>(smem_raw);          // [tile] b - a
  T2* s_ao = s_ab + tile;                              // [tile] a - pose
  T* s_tn = reinterpret_cast<T*>(s_ao + tile);         // [tile] t numerator

  const int p = blockIdx.x / chunks;
  const int n = (blockIdx.x - p * chunks) * per + (int)threadIdx.x;
  const bool live = (int)threadIdx.x < per && n < n_beams;
  const T px = poses[3 * p + 0], py = poses[3 * p + 1];
  T dx = 0, dy = 0;
  if (live) {
    const T th = poses[3 * p + 2] + angles[n];
    dx = cos(th);
    dy = sin(th);
  }
  const T m = margin<T>(), grow = (T)1 + m, inf = infinity<T>();
  const T lo = eps > tiny<T>() ? eps : tiny<T>();
  // best's rejection bound bm (see the header) and whether best >
  // max_range (a miss then lowers it), kept beside it; bm is +inf until
  // segment 0 sets best, so it meets only the miss tests.
  auto bound = [&](T b) {
    return (b >= tiny<T>() && b <= max_range) ? b * grow : inf;
  };
  const T bm_miss = bound(max_range);
  T best = max_range, bm = inf;
  bool above = false;
  for (int s0 = 0; s0 < n_seg; s0 += kTile) {
    const int len = n_seg - s0 < kTile ? n_seg - s0 : kTile;
    __syncthreads();                     // the previous tile is consumed
    for (int i = threadIdx.x; i < len; i += blockDim.x) {
      const T* g = segments + 4 * (size_t)(s0 + i);
      const T ax = g[0], ay = g[1];
      const T abx = g[2] - ax, aby = g[3] - ay;
      const T aox = ax - px, aoy = ay - py;
      s_ab[i] = T2{abx, aby};
      s_ao[i] = T2{aox, aoy};
      s_tn[i] = aox * aby - aoy * abx;
    }
    __syncthreads();
    if (!live) continue;
    for (int i = 0; i < len; ++i) {
      const T2 ab = s_ab[i];
      const T denom = dx * ab.y - dy * ab.x;
      const T ad = fabs(denom);
      const T tn = s_tn[i];
      bool exact;
      if (ad >= lo) {
        const T tq = flip_by(tn, denom);
        exact = positive(tq) && tq < ad * bm;
        if (exact) {
          const T2 ao = s_ao[i];
          const T uq = flip_by(ao.x * dy - ao.y * dx, denom);
          const T dm = ad * m;
          exact = uq >= -dm && uq <= ad + dm;
        }
      } else {
        exact = ad >= eps;
      }
      const bool first = s0 + i == 0;
      if (exact) {
        const T2 ao = s_ao[i];
        const T v = plain_value(denom, tn, ao.x, ao.y, dx, dy, eps,
                                max_range);
        if (first || v < best) {
          best = v;
          above = v > max_range;
          bm = bound(v);
        }
      } else if (first || above) {
        best = max_range;
        above = false;
        bm = bm_miss;
      }
    }
  }
  if (live) ranges[(size_t)p * n_beams + n] = best;
}

template <typename T>
int launch(const void* poses, const void* angles, const void* segments,
           void* ranges, int n_poses, int n_beams, int n_seg, double max_range,
           double eps, void* stream) {
  if (n_poses < 1 || n_beams < 1 || n_seg < 1)
    return (int)cudaErrorInvalidValue;
  // Beams of one pose in chunks of at most kMaxThreads, as even as they
  // go, each rounded up to whole warps.
  const int chunks = (n_beams + kMaxThreads - 1) / kMaxThreads;
  const int per = (n_beams + chunks - 1) / chunks;
  const int threads = (per + 31) / 32 * 32;
  const long long blocks = (long long)n_poses * chunks;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int tile = n_seg < kTile ? n_seg : kTile;
  const size_t smem = 5 * sizeof(T) * (size_t)tile;   // <= 40 KB
  raycast_kernel<T><<<(unsigned)blocks, threads, smem,
                      (cudaStream_t)stream>>>(
      (const T*)poses, (const T*)angles, (const T*)segments, (T*)ranges,
      n_beams, n_seg, chunks, per, (T)max_range, (T)eps);
  return (int)cudaGetLastError();
}

}  // namespace

// poses [P, 3], angles [N], segments [S, 2, 2] in; ranges [P, N] out; all
// f64 (f64 = 1) or all f32 (f64 = 0). Any S: the segments pass through
// shared memory in tiles.
extern "C" int raycast_launch(const void* poses, const void* angles,
                              const void* segments, void* ranges, int n_poses,
                              int n_beams, int n_seg, double max_range,
                              double eps, int f64, void* stream) {
  return f64 ? launch<double>(poses, angles, segments, ranges, n_poses,
                              n_beams, n_seg, max_range, eps, stream)
             : launch<float>(poses, angles, segments, ranges, n_poses,
                             n_beams, n_seg, max_range, eps, stream);
}
