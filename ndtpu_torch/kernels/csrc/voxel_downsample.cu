// K13 voxel_downsample: keep at most one valid point per voxel x voxel
// cell of each scan, the lowest-index valid one.
//
// Replaces what XLA lowered for the TPU from
// ndtpu/data/preprocess.py::voxel_downsample (:24-51): an int32 quantize,
// a stable argsort of the voxel ids per scan, first-of-run flags and the
// unsort. Here no sort runs.
//
// Every point is quantized into an int32 voxel id: floor(p / voxel) per
// axis (an IEEE division, as the plain version), clipped to [-H, H - 1]
// (H = 2^14, in float before the conversion, so no value is out of int32's
// range), packed as (qx + H) * 2H + (qy + H); an invalid point gets the
// sentinel (2H)^2, which no voxel has. Point i is kept if it is valid and
// no j < i has its id: exactly the plain version's "first of each run of
// equal ids in a stable sort", so the mask has one right answer and the
// kernel gives it bit for bit, on every launch.
//
// What bounds it on Hopper: bytes (8 B of points and 1 B of mask in, 1 B
// out per point); 0.65 us for the CLI's 600 scans of 360 points. The
// first design compared each id with every earlier one (N^2 / 2 shared
// reads a scan, ~615 dependent iterations on one thread at N = 360: 0.019
// ms). The table route (voxel_downsample_table_kernel) costs O(N) a
// scan: one block of 256 threads a scan holds the scan's ids and an
// open-addressed table of 2N int32 slots in shared memory (voxel_smem: 12
// B a point). A scan's neighbouring beams share voxels, so only a point
// that heads its run of equal ids goes to the table (the others have a
// lower-index point of their id just before them): from the id's home
// slot (a Fibonacci hash) it claims the first empty slot with atomicCAS,
// or, finding a slot whose point has its id, lowers it to its own index
// with atomicMin (a claimed slot only ever holds points of one id, so its
// id is the id of whatever index it holds). After a barrier each run head
// walks from its home slot to its id's slot and is kept iff the slot holds
// its own index. Integer atomics only; which point wins does not depend
// on their order. Slower on the card, tried on edited copies: several
// scans a block (at every block width), electing one point per voxel and
// warp with __match_any_sync (a 64-bit key of scan and id), claims made in
// rounds of plain stores checked after a barrier, and claims through
// inline-PTX shared atomics. What is left is the claim's round trip
// (atomicCAS returns the slot's old value) and the look-up's probe,
// behind the ids' global loads. Past a block's shared memory (N > 19,370
// points) the scan route (voxel_downsample_scan_kernel, the first design:
// 4 B a point, N <= 58,112) takes the scans; kernels.voxel_route chooses.

#include <cuda_runtime.h>

namespace {

constexpr int kHalf = 1 << 14;
constexpr int kSentinel = (2 * kHalf) * (2 * kHalf);
constexpr int kEmpty = 0x7fffffff;   // a free slot: above every index
constexpr int kThreads = 256;   // a block, on either route

__device__ __forceinline__ int quantize(float p, float voxel) {
  float q = floorf(p / voxel);
  q = fminf(fmaxf(q, (float)-kHalf), (float)(kHalf - 1));
  return (int)q;
}

__device__ __forceinline__ int voxel_id(float2 p, bool valid, float voxel) {
  return valid ? (quantize(p.x, voxel) + kHalf) * (2 * kHalf)
                     + (quantize(p.y, voxel) + kHalf)
               : kSentinel;
}

// The home slot of an id in a table of cap slots: Fibonacci hashing, the
// high 32 bits of the product mapped onto [0, cap).
__device__ __forceinline__ int home_slot(int id, int cap) {
  return (int)__umulhi((unsigned)id * 2654435769u, (unsigned)cap);
}

// The table route: scan blockIdx.x. Shared memory: the scan's ids (n),
// then its table of 2n slots (a point index, kEmpty where free).
__global__ void __launch_bounds__(kThreads)
voxel_downsample_table_kernel(const float2* __restrict__ points,
                              const bool* __restrict__ mask,
                              bool* __restrict__ keep, int n, float voxel) {
  extern __shared__ int ids[];
  const int cap = 2 * n;
  int* tab = ids + n;
  const long long base = (long long)blockIdx.x * n;
  for (int k = threadIdx.x; k < cap; k += kThreads) tab[k] = kEmpty;
  for (int i = threadIdx.x; i < n; i += kThreads)
    ids[i] = voxel_id(points[base + i], mask[base + i], voxel);
  __syncthreads();
  // Insert: each valid point that heads its run (the point before it has
  // another id) claims or lowers its voxel's slot; the rest of a run has a
  // lower-index point of its id before it.
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int id = ids[i];
    if (id == kSentinel || (i > 0 && ids[i - 1] == id)) continue;
    for (int h = home_slot(id, cap);;) {
      const int v = atomicCAS(tab + h, kEmpty, i);
      if (v == kEmpty) break;              // claimed
      if (ids[v] == id) {                  // the voxel's slot
        if (i < v) atomicMin(tab + h, i);
        break;
      }
      if (++h == cap) h = 0;
    }
  }
  __syncthreads();
  // Look up, for run heads (the slots from an id's home to its own are all
  // claimed): kept iff the slot holds the head's own index.
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int id = ids[i];
    bool kept = false;
    if (id != kSentinel && !(i > 0 && ids[i - 1] == id)) {
      int h = home_slot(id, cap), v;
      while (ids[v = tab[h]] != id)
        if (++h == cap) h = 0;
      kept = v == i;
    }
    keep[base + i] = kept;
  }
}

// The scan route (the first design): one block per scan, the ids in shared
// memory, thread i keeps point i if it is valid and no j < i has its id
// (the scan of j in lockstep across a warp: each read a broadcast).
__global__ void __launch_bounds__(kThreads)
voxel_downsample_scan_kernel(const float2* __restrict__ points,
                             const bool* __restrict__ mask,
                             bool* __restrict__ keep, int n, float voxel) {
  extern __shared__ int ids[];
  const long long base = (long long)blockIdx.x * n;
  for (int i = threadIdx.x; i < n; i += kThreads)
    ids[i] = voxel_id(points[base + i], mask[base + i], voxel);
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int id = ids[i];
    bool first = id != kSentinel;
    for (int j = 0; first && j < i; ++j) first = ids[j] != id;
    keep[base + i] = first;
  }
}

// Shared memory of a block (bytes): route 0 (table) 4 B of id and 8 B of
// table a point, route 1 (scan) 4 B of id a point.
inline long long voxel_smem(int n, int route) {
  return route == 0 ? 12LL * n : 4LL * n;
}

}  // namespace

// points [T, N, 2] f32, mask [T, N] bool in; keep [T, N] bool out; one
// block of 256 threads a scan on route 0 (table) or 1 (scan), as
// kernels.voxel_route chooses. Returns -1 when the route's shared memory
// (voxel_smem) is over smem_max.
extern "C" int voxel_downsample_launch(const void* points, const void* mask,
                                       void* keep, int n_scans, int n,
                                       float voxel, int route, int smem_max,
                                       void* stream) {
  if (n_scans < 1 || n < 1 || (route != 0 && route != 1))
    return (int)cudaErrorInvalidValue;
  const long long smem = voxel_smem(n, route);
  if (smem > smem_max) return -1;   // the wrapper raises ValueError
  auto* kernel = route == 0 ? voxel_downsample_table_kernel
                            : voxel_downsample_scan_kernel;
  if (smem > 49152) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<n_scans, kThreads, (int)smem, (cudaStream_t)stream>>>(
      (const float2*)points, (const bool*)mask, (bool*)keep, n, voxel);
  return (int)cudaGetLastError();
}
