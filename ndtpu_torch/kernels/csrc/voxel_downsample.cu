// K13 voxel_downsample: keep at most one valid point per voxel x voxel
// cell of each scan, the lowest-index valid one.
//
// Replaces what XLA lowered for the TPU from
// ndtpu/data/preprocess.py::voxel_downsample (:24-51): an int32 quantize,
// a stable argsort of the voxel ids per scan, first-of-run flags and the
// unsort. Here no sort runs.
//
// One block per scan. The block quantizes the scan's N points into int32
// voxel ids in shared memory: floor(p / voxel) per axis, clipped to
// [-H, H - 1] (H = 2^14, in float before the conversion, so no value is
// out of int32's range), packed as (qx + H) * 2H + (qy + H); an invalid
// point gets the sentinel (2H)^2, which no voxel has. Thread i then keeps
// point i if it is valid and no j < i has its id: exactly the plain
// version's "first of each run of equal ids in a stable sort", so the
// result is deterministic and equal to it bit for bit. The scan of j runs
// in lockstep across a warp, so each shared-memory read is a broadcast.
//
// What bounds it on Hopper: bytes (8 B of points and 1 B of mask in, 1 B
// out per point); the O(N^2) id comparisons (65k per 360-beam scan) run
// from shared memory. N is limited by the block's shared memory: 4 B per
// point, 227 KB at most.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kHalf = 1 << 14;
constexpr int kSentinel = (2 * kHalf) * (2 * kHalf);

__device__ __forceinline__ int quantize(float p, float voxel) {
  float q = floorf(p / voxel);
  q = fminf(fmaxf(q, (float)-kHalf), (float)(kHalf - 1));
  return (int)q;
}

__global__ void __launch_bounds__(kThreads)
voxel_downsample_kernel(const float2* __restrict__ points,
                        const bool* __restrict__ mask, bool* __restrict__ keep,
                        int n, float voxel) {
  extern __shared__ int ids[];
  const long long base = (long long)blockIdx.x * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float2 p = points[base + i];
    ids[i] = mask[base + i]
                 ? (quantize(p.x, voxel) + kHalf) * (2 * kHalf)
                       + (quantize(p.y, voxel) + kHalf)
                 : kSentinel;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int id = ids[i];
    bool first = id != kSentinel;
    for (int j = 0; first && j < i; ++j) first = ids[j] != id;
    keep[base + i] = first;
  }
}

}  // namespace

// points [T, N, 2] f32, mask [T, N] bool in; keep [T, N] bool out.
// Returns -1 when N ids do not fit a block's shared memory.
extern "C" int voxel_downsample_launch(const void* points, const void* mask,
                                       void* keep, int n_scans, int n,
                                       float voxel, int smem_max,
                                       void* stream) {
  if (n_scans < 1 || n < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(int) * (size_t)n;
  if (smem > (size_t)smem_max) return -1;   // the wrapper raises ValueError
  if (smem > 49152) {
    const cudaError_t err = cudaFuncSetAttribute(
        voxel_downsample_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  voxel_downsample_kernel<<<n_scans, kThreads, smem, (cudaStream_t)stream>>>(
      (const float2*)points, (const bool*)mask, (bool*)keep, n, voxel);
  return (int)cudaGetLastError();
}
