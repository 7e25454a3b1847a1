// SE(2) arithmetic as PyTorch runs ndtpu_torch/lie/se2.py on the card, op
// for op, shared by K14 (window_append.cu) and K15 (loop_lanes.cu).
//
// The sources are built with --fmad=false, so each multiply and add rounds
// on its own as PyTorch's elementwise kernels round them, and a division by
// a host scalar is a product with its float reciprocal, as PyTorch computes
// it (`/ (2.0 * math.pi)` in se2.wrap): the results are the plain
// version's bits on the card.

#pragma once

#include <cuda_runtime.h>

namespace ndtpu {
namespace se2 {

// PyTorch's f32 view of math.pi and 2 * math.pi, and the reciprocal it
// multiplies by for `/ (2.0 * math.pi)`.
constexpr float kPi = 3.14159265358979323846f;
constexpr float kTwoPi = 6.28318530717958647692f;
constexpr float kInvTwoPi = 1.0f / kTwoPi;

// se2.wrap.
__device__ __forceinline__ float wrap(float t) {
  return t - kTwoPi * floorf((t + kPi) * kInvTwoPi);
}

// se2.between(a, b) = a^{-1} b.
__device__ __forceinline__ void between(const float* a, const float* b,
                                        float* out) {
  const float ca = cosf(a[2]), sa = sinf(a[2]);
  const float dx = b[0] - a[0], dy = b[1] - a[1];
  out[0] = ca * dx + sa * dy;
  out[1] = -sa * dx + ca * dy;
  out[2] = wrap(b[2] - a[2]);
}

// se2.compose(a, b) = a b.
__device__ __forceinline__ void compose(const float* a, const float* b,
                                        float* out) {
  const float ca = cosf(a[2]), sa = sinf(a[2]);
  out[0] = a[0] + ca * b[0] - sa * b[1];
  out[1] = a[1] + sa * b[0] + ca * b[1];
  out[2] = wrap(a[2] + b[2]);
}

}  // namespace se2
}  // namespace ndtpu
