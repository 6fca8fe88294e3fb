// Forward tile rasterizer: front-to-back alpha compositing per 16x16 tile.
//
// Replaces the TPU kernel gsplat_tpu/kernels/rasterize.py::rasterize_forward
// (_forward_kernel / _forward_tile). The TPU evaluates a whole (256 pixel x
// K pair) alpha matrix per chunk and turns the sequential transmittance into
// lane-axis cumulative products; on the GPU each thread owns one pixel and
// walks the tile's depth-sorted pairs in order, as the original CUDA
// renderer did:
//
//   one CTA per tile, 256 threads, one thread per pixel; the tile's pairs
//   are staged through shared memory in batches of 256 (each thread loads
//   one pair's attribute row through splat_gid, so no pre-gathered pair
//   stream exists); the CTA leaves as soon as every pixel is done
//   (__syncthreads_count).
//
// Semantics (gsplat_tpu/ops/oracle.py::oracle_render_forward):
//   power = min(0, -0.5 (c00 dx^2 + 2 c01 dx dy + c11 dy^2)), dx = u - px,
//   alpha = min(0.99, opa exp(power)), zeroed unless alpha > 1/255;
//   the splat whose post-T crosses 1e-4 is composited and T_final freezes
//   at that post-crossing value; n_splats counts every splat iterated while
//   the pixel is alive (sub-cutoff ones included); colour + T_final * bg.
//   Pixel centres sit at integer global coordinates. ``opa`` is already the
//   sigmoid of the logit (ops/render.py::pack_attrs). Alpha is rounded as
//   the backward kernel and the plain versions round it
//   (raster_common.cuh), so all agree on which splats pass the cutoff.
//
// What bounds it on an H100: FP32 issue and latency. At the bench point
// (~5.5M pairs at 1M Gaussians, 1296x840) the pixels' n_splats keep ~146M
// of the 1.4G pair-pixels, each 26 FP32 operations up to the 1/255 cutoff
// (expf is 10 of them) and 10 more past it, while the inputs are ~80 MB
// (chip_smoke.py counts both). Each thread's loop is a serial dependency
// chain on T, so throughput comes from many resident CTAs (256 threads and
// 9 KB of shared memory each); the shared-memory reads are broadcasts (all
// threads read the same pair), and the early exit drops the work behind
// saturated pixels.

#include <cstdint>
#include <cuda_runtime.h>

#include "raster_common.cuh"

namespace {

using gs::kAlphaCutoff;
using gs::kAttrs;
using gs::kOutRows;
using gs::kPix;
using gs::kTEps;
using gs::kTile;

__global__ void __launch_bounds__(kPix)
rasterize_forward_kernel(float* __restrict__ out,
                         const float* __restrict__ attrs,
                         const int32_t* __restrict__ splat_gid,
                         const int32_t* __restrict__ tile_start,
                         const int32_t* __restrict__ tile_count,
                         int num_tiles_x, float bg) {
  __shared__ float s_attr[kAttrs][kPix];
  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int start = tile_start[t];
  const int count = tile_count[t];
  const float px = (float)((t % num_tiles_x) * kTile + tid % kTile);
  const float py = (float)((t / num_tiles_x) * kTile + tid / kTile);

  float T = 1.0f, acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f;
  int n = 0;
  bool done = false;
  for (int b0 = 0; b0 < count; b0 += kPix) {
    // Also the barrier that frees the previous batch's shared rows.
    if (__syncthreads_count(done) == kPix) break;
    if (b0 + tid < count) {
      const float* a = attrs + (int64_t)splat_gid[start + b0 + tid] * kAttrs;
#pragma unroll
      for (int k = 0; k < kAttrs; ++k) s_attr[k][tid] = a[k];
    }
    __syncthreads();
    const int nb = min(kPix, count - b0);
    for (int j = 0; j < nb && !done; ++j) {
      ++n;
      const float dx = s_attr[0][j] - px;
      const float dy = s_attr[1][j] - py;
      float alpha = gs::splat_alpha(
          s_attr[5][j],
          gs::splat_falloff(s_attr[2][j], s_attr[3][j], s_attr[4][j], dx, dy));
      if (!(alpha > kAlphaCutoff)) alpha = 0.0f;
      const float test_T = T * (1.0f - alpha);
      if (test_T < kTEps) done = true;
      const float w = alpha * T;
      acc_r += w * s_attr[6][j];
      acc_g += w * s_attr[7][j];
      acc_b += w * s_attr[8][j];
      T = test_T;
    }
  }
  float* o = out + (int64_t)t * kOutRows * kPix + tid;
  o[0 * kPix] = acc_r + T * bg;
  o[1 * kPix] = acc_g + T * bg;
  o[2 * kPix] = acc_b + T * bg;
  o[3 * kPix] = T;
  o[4 * kPix] = (float)n;
}

}  // namespace

extern "C" int gs_rasterize_forward(void* out, const void* attrs,
                                    const void* splat_gid,
                                    const void* tile_start,
                                    const void* tile_count, int num_tiles,
                                    int num_tiles_x, float bg, void* stream) {
  if (num_tiles > 0) {
    rasterize_forward_kernel<<<num_tiles, kPix, 0, (cudaStream_t)stream>>>(
        (float*)out, (const float*)attrs, (const int32_t*)splat_gid,
        (const int32_t*)tile_start, (const int32_t*)tile_count, num_tiles_x,
        bg);
  }
  return (int)cudaGetLastError();
}
