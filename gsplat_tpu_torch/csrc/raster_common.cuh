// Shared by the forward and backward tile rasterizers.
//
// A splat's alpha at a pixel decides whether it passes the 1/255 cutoff, and
// a pair-pixel on either side of that cutoff changes the image and every
// gradient row behind it. So the forward kernel, the backward kernel and
// the plain PyTorch versions must agree bit for bit on it: splat_alpha
// rounds op by op (the __f*_rn intrinsics are never contracted into FMAs)
// in the order the plain versions evaluate
//   power = min(0, -0.5 (c00 dx dx + 2 c01 dx dy + c11 dy dy)),
//   alpha = min(0.99, opa exp(power)).
#pragma once

#include <cuda_runtime.h>

namespace gs {

constexpr int kTile = 16;
constexpr int kPix = kTile * kTile;
constexpr int kAttrs = 9;    // [u v c00 c01 c11 opa r g b]
constexpr int kOutRows = 5;  // forward rows [r g b T_final n_splats]
constexpr float kAlphaCutoff = 0.00392156862f;  // 1/255
constexpr float kTEps = 1e-4f;
constexpr float kAlphaMax = 0.99f;

// splat_falloff with 2 c01 and c11 dy dy computed by the caller, which
// shares them across the pixels of a row (the forward kernel).
__device__ __forceinline__ float splat_falloff_row(float c00, float c01x2,
                                                   float c11_dy_dy, float dx,
                                                   float dy) {
  const float a = __fmul_rn(__fmul_rn(c00, dx), dx);
  const float b = __fmul_rn(__fmul_rn(c01x2, dx), dy);
  const float power =
      fminf(0.0f, __fmul_rn(-0.5f, __fadd_rn(__fadd_rn(a, b), c11_dy_dy)));
  return expf(power);
}

// Gaussian falloff exp(power) of a splat at offset (dx, dy) = (u - px, v - py).
__device__ __forceinline__ float splat_falloff(float c00, float c01, float c11,
                                               float dx, float dy) {
  return splat_falloff_row(c00, __fmul_rn(2.0f, c01),
                           __fmul_rn(__fmul_rn(c11, dy), dy), dx, dy);
}

__device__ __forceinline__ float splat_alpha(float opa, float falloff) {
  return fminf(kAlphaMax, __fmul_rn(opa, falloff));
}

}  // namespace gs
