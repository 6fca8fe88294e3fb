// Backward tile rasterizer: back-to-front replay, one gradient row per pair.
//
// Replaces the TPU kernel gsplat_tpu/kernels/rasterize.py::rasterize_backward
// (_backward_kernel / _backward_tile) in its exact f32 mode. The TPU kernel
// walks (256 pixel x K pair) chunks with lane-axis cumulative products,
// writes only the chunks it owns and leaves the rest of its output
// uninitialised (ops/render.py masks and patches it afterwards). Here:
//
//   one CTA per 16x16 tile, 256 threads, one thread per pixel; the tile's
//   pairs are read through splat_gid into shared memory in batches of 64,
//   walked back to front from the batch that holds the tile's largest
//   n_splats (a block max over the forward's n_splats row). Each pixel
//   replays T from its T_final (T /= 1 - alpha) and keeps one scalar suffix
//   sum of w_k (c_k . dI): the image cotangent is constant per pixel, so the
//   reference's three per-colour sums collapse into one.
//
//   Each pair's nine values are summed over the 256 pixels by warp shuffles
//   (skipped when no lane of the warp touches the pair), then one partial per
//   warp goes to shared memory, and after the batch one thread per value adds
//   the 8 warp partials in warp order and writes the row. Every row of the
//   tile's range is written exactly once: rows past every pixel's n_splats
//   are written as zeros. No atomics, so a rerun gives bit-identical rows.
//
// Semantics (gsplat_tpu/ops/oracle.py::oracle_render_backward, and the TPU
// kernel's exact mode): replay only for k < n_splats(pixel) and
// alpha > 1/255 (alpha = min(0.99, opa exp(min(0, power))), rounded as the
// forward kernel and the plain versions round it: raster_common.cuh);
//   grad_alpha = (c . dI) T - S / (1 - alpha) - T_final bg sum(dI) / (1 - alpha)
// with S the suffix sum over the later splats; the 0.99 and power <= 0
// clamps are ignored in the derivative. Rows [du dv dc00 dc01 dc11 dopa dr
// dg db]; du and dv are scaled by 0.5 * the padded grid's width and height
// (scale_u, scale_v); dopa is d/d(sigmoid-ed opacity).
//
// What bounds it on an H100: FP32 issue and shuffle throughput. At the bench
// point (~5.5M pairs at 1M Gaussians, 1296x840) each replayed pair-pixel is
// ~40 FP32 operations and one exp, and each pair a warp touches costs 45
// shuffles; the replay stops at each tile's deepest n_splats, so saturated
// pixels cost nothing behind their last splat, and warps with no live pixel
// for a pair skip its shuffles.

#include <cstdint>
#include <cuda_runtime.h>

#include "raster_common.cuh"

namespace {

using gs::kAlphaCutoff;
using gs::kAttrs;
using gs::kOutRows;
using gs::kPix;
using gs::kTile;
constexpr int kWarps = kPix / 32;
constexpr int kGrads = 9;    // [du dv dc00 dc01 dc11 dopa dr dg db]
constexpr int kBatch = 64;   // pairs staged per batch
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

__global__ void __launch_bounds__(kPix)
rasterize_backward_kernel(float* __restrict__ grads,
                          const float* __restrict__ attrs,
                          const int32_t* __restrict__ splat_gid,
                          const int32_t* __restrict__ tile_start,
                          const int32_t* __restrict__ tile_count,
                          const float* __restrict__ out,
                          const float* __restrict__ d_tiles,
                          int num_tiles_x, float bg, float scale_u,
                          float scale_v) {
  __shared__ float s_attr[kAttrs][kBatch];
  __shared__ float s_part[kWarps][kGrads][kBatch];
  __shared__ int s_maxn[kWarps];
  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int start = tile_start[t];
  const int count = tile_count[t];
  const float px = (float)((t % num_tiles_x) * kTile + tid % kTile);
  const float py = (float)((t / num_tiles_x) * kTile + tid / kTile);

  const float* o = out + (int64_t)t * kOutRows * kPix + tid;
  const float t_final = o[3 * kPix];
  const int nspl = (int)o[4 * kPix];
  const float* d = d_tiles + (int64_t)t * 3 * kPix + tid;
  const float dr = d[0], dg = d[kPix], db = d[2 * kPix];
  const float bg_term = t_final * (bg * (dr + dg + db));

  // The tile's deepest splat: a block max of n_splats.
  int m = nspl;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = max(m, __shfl_xor_sync(kFull, m, off));
  if (lane == 0) s_maxn[warp] = m;
  __syncthreads();
  int maxn = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) maxn = max(maxn, s_maxn[w]);
  maxn = min(maxn, count);

  float* g_tile = grads + (int64_t)start * kGrads;
  for (int i = maxn * kGrads + tid; i < count * kGrads; i += kPix) g_tile[i] = 0.0f;

  float T = t_final;      // transmittance entering the splat being replayed
  float suffix = 0.0f;    // sum of w_j (c_j . dI) over the splats behind it
  const int nbatch = (maxn + kBatch - 1) / kBatch;
  for (int b = nbatch - 1; b >= 0; --b) {
    const int b0 = b * kBatch;
    const int nb = min(kBatch, maxn - b0);
    __syncthreads();  // the previous batch's shared rows are consumed
    if (tid < nb) {
      const float* a = attrs + (int64_t)splat_gid[start + b0 + tid] * kAttrs;
#pragma unroll
      for (int k = 0; k < kAttrs; ++k) s_attr[k][tid] = a[k];
    }
    __syncthreads();
    for (int j = nb - 1; j >= 0; --j) {
      const float c00 = s_attr[2][j], c01 = s_attr[3][j], c11 = s_attr[4][j];
      const float opa = s_attr[5][j];
      const float dx = s_attr[0][j] - px;
      const float dy = s_attr[1][j] - py;
      const float gval = gs::splat_falloff(c00, c01, c11, dx, dy);
      const float alpha = gs::splat_alpha(opa, gval);
      const bool valid = (b0 + j < nspl) && (alpha > kAlphaCutoff);
      float v[kGrads];
#pragma unroll
      for (int k = 0; k < kGrads; ++k) v[k] = 0.0f;
      if (valid) {
        const float one_minus = 1.0f - alpha;
        const float inv = 1.0f / one_minus;
        T = T / one_minus;
        const float cdi = s_attr[6][j] * dr + s_attr[7][j] * dg + s_attr[8][j] * db;
        const float w = alpha * T;
        const float grad_alpha = cdi * T - suffix * inv - bg_term * inv;
        suffix += w * cdi;
        const float gp = gval * grad_alpha * opa;  // d/d power
        v[0] = -(c00 * dx + c01 * dy) * gp;
        v[1] = -(c11 * dy + c01 * dx) * gp;
        v[2] = -0.5f * dx * dx * gp;
        v[3] = -dx * dy * gp;
        v[4] = -0.5f * dy * dy * gp;
        v[5] = gval * grad_alpha;
        v[6] = w * dr;
        v[7] = w * dg;
        v[8] = w * db;
      }
      if (__any_sync(kFull, valid)) {
#pragma unroll
        for (int k = 0; k < kGrads; ++k) v[k] = warp_sum(v[k]);
      }
      if (lane == 0) {
#pragma unroll
        for (int k = 0; k < kGrads; ++k) s_part[warp][k][j] = v[k];
      }
    }
    __syncthreads();
    float* g_batch = g_tile + (int64_t)b0 * kGrads;
    for (int i = tid; i < nb * kGrads; i += kPix) {
      const int j = i / kGrads;
      const int k = i - j * kGrads;
      float s = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += s_part[w][k][j];
      if (k == 0) s *= scale_u;
      if (k == 1) s *= scale_v;
      g_batch[i] = s;
    }
  }
}

}  // namespace

extern "C" int gs_rasterize_backward(void* grads, const void* attrs,
                                     const void* splat_gid,
                                     const void* tile_start,
                                     const void* tile_count, const void* out,
                                     const void* d_tiles, int num_tiles,
                                     int num_tiles_x, float bg, float scale_u,
                                     float scale_v, void* stream) {
  if (num_tiles > 0) {
    rasterize_backward_kernel<<<num_tiles, kPix, 0, (cudaStream_t)stream>>>(
        (float*)grads, (const float*)attrs, (const int32_t*)splat_gid,
        (const int32_t*)tile_start, (const int32_t*)tile_count,
        (const float*)out, (const float*)d_tiles, num_tiles_x, bg, scale_u,
        scale_v);
  }
  return (int)cudaGetLastError();
}
