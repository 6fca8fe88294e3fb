// Packed-mode bit formats on the device: the kernels' copy of
// gsplat_tpu_torch/kernels/packing.py (itself a copy of
// gsplat_tpu/kernels/packing.py), bit for bit.
//
// The reference's default (packed) mode carries each pair's attributes as
// f16 tile-relative u, v (clamped to +-16384, subnormals decoded as 0),
// bf16 c00 c01 c11 opa (round to nearest even) and an e5s9 word of the
// bf16-rounded colour (bias 20); and each pair's gradient row as four int32
// words [du|dv, dc00|dc01, dc11|dopa] (bf16 pairs) and e5s9(dr, dg, db)
// (bias 24). Every conversion here is a round-to-nearest-even intrinsic or
// integer bit math, and no multiply is contracted, so the kernels give the
// plain versions' bits.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace gs {

constexpr int kRgbE5Bias = 20;
constexpr int kGradE5Bias = 24;
constexpr float kF16Clamp = 16384.0f;

__device__ __forceinline__ uint32_t bf16_bits(float x) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float bf16_round(float x) {
  return __uint_as_float(bf16_bits(x) << 16);
}

__device__ __forceinline__ uint32_t pack_bf16_pair(float hi, float lo) {
  return (bf16_bits(hi) << 16) | bf16_bits(lo);
}

__device__ __forceinline__ void unpack_bf16_pair(uint32_t w, float& hi, float& lo) {
  hi = __uint_as_float(w & 0xFFFF0000u);
  lo = __uint_as_float(w << 16);
}

// IEEE f16 bits -> float32: exact for normals, subnormals and zeros -> +0.
__device__ __forceinline__ float f16_bits_to_f32(uint32_t h) {
  const uint32_t expmant = h & 0x7FFFu;
  if (expmant < (1u << 10)) return 0.0f;
  return __uint_as_float(((h & 0x8000u) << 16) | ((expmant + (112u << 10)) << 13));
}

// x - origin, clamped, rounded to f16 and decoded: a tile-relative offset
// as the packed stream carries it.
__device__ __forceinline__ float f16_tile_offset(float x, float origin) {
  const float rel = fminf(fmaxf(__fsub_rn(x, origin), -kF16Clamp), kF16Clamp);
  return f16_bits_to_f32((uint32_t)__half_as_ushort(__float2half_rn(rel)));
}

// Shared-exponent word [e:5 | qr:9 | qg:9 | qb:9]: e from the bits of the
// largest |value| (0 for a zero triple), codes rint(c * 2^(7 - e + bias))
// clamped to +-255, stored offset 256.
__device__ __forceinline__ uint32_t pack_rgb_e5(float r, float g, float b, int bias) {
  const float amax = fmaxf(fmaxf(fabsf(r), fabsf(g)), fabsf(b));
  const int e = min(max((int)(__float_as_uint(amax) >> 23) - 127 + bias, 0), 31);
  const float inv_scale = __uint_as_float((uint32_t)(134 - e + bias) << 23);
  auto q = [inv_scale](float c) {
    const float qi = fminf(fmaxf(rintf(__fmul_rn(c, inv_scale)), -255.0f), 255.0f);
    return (uint32_t)((int)qi + 256);
  };
  return ((uint32_t)e << 27) | (q(r) << 18) | (q(g) << 9) | q(b);
}

__device__ __forceinline__ void unpack_rgb_e5(uint32_t w, int bias, float& r, float& g,
                                              float& b) {
  const float scale = __uint_as_float((uint32_t)(120 + (int)(w >> 27) - bias) << 23);
  r = __fmul_rn((float)((int)((w >> 18) & 0x1FFu) - 256), scale);
  g = __fmul_rn((float)((int)((w >> 9) & 0x1FFu) - 256), scale);
  b = __fmul_rn((float)((int)(w & 0x1FFu) - 256), scale);
}

// One pair's attribute row [u v c00 c01 c11 opa r g b], rounded in place as
// the packed stream carries it; u and v become offsets from the tile's
// pixel origin (x0, y0).
__device__ __forceinline__ void round_pair_attrs(float* a, float x0, float y0) {
  a[0] = f16_tile_offset(a[0], x0);
  a[1] = f16_tile_offset(a[1], y0);
#pragma unroll
  for (int k = 2; k < 9; ++k) a[k] = bf16_round(a[k]);
  const uint32_t w = pack_rgb_e5(a[6], a[7], a[8], kRgbE5Bias);
  unpack_rgb_e5(w, kRgbE5Bias, a[6], a[7], a[8]);
}

// A gradient row's four packed words.
__device__ __forceinline__ uint4 pack_grad_row(const float* g) {
  return make_uint4(pack_bf16_pair(g[0], g[1]), pack_bf16_pair(g[2], g[3]),
                    pack_bf16_pair(g[4], g[5]),
                    pack_rgb_e5(g[6], g[7], g[8], kGradE5Bias));
}

}  // namespace gs
