// Forward tile rasterizer: front-to-back alpha compositing per 16x16 tile.
//
// Replaces the TPU kernel gsplat_tpu/kernels/rasterize.py::rasterize_forward
// (_forward_kernel / _forward_tile). The TPU evaluates a whole (256 pixel x
// K pair) alpha matrix per chunk and turns the sequential transmittance into
// lane-axis cumulative products; on the GPU a thread walks the tile's
// depth-sorted pairs in order for its own pixels, as the original CUDA
// renderer did.
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
// Packed mode (kPacked, the reference's default: its stream of f16/bf16/
// e5s9 words, kernels/rasterize.py:392-393): each thread rounds the pair it
// has staged as that stream carries it (packing.cuh: round_pair_attrs), u
// and v relative to the tile's origin, and the pixels take tile-local
// coordinates, so dx = u_rel - px_local as the reference computes it. The
// rounding is ~60 instructions a pair, once per staged pair; the pair loop
// is the exact mode's.
//
// What bounds it on an H100: instruction issue, not FP32. At the bench
// point (~5.4M pairs at 1M Gaussians, 1296x840) the pixels' n_splats keep
// ~146M pair-pixels, each 26 FP32 operations up to the 1/255 cutoff (expf
// is 10 of them) and 10 more past it (chip_smoke.py counts both), while
// the inputs are ~80 MB. With one pixel a thread, each pair-pixel also
// costs nine scalar shared-memory loads of the pair's attributes and the
// loop's control, about 46 instructions in all, and the SM issues shared
// loads at about a quarter of its instruction rate. So:
//
//   one CTA per tile, 64 threads, each compositing 4 neighbouring pixels
//   of a row (px + q, py), laid out as the backward kernel's: one read of a
//   pair serves 4 pixels, and dy and c11 dy dy are computed once for them.
//   A pair's row is staged as three float4s [u v c00 2c01] [c11 opa r g]
//   [b - - -], read with three 128-bit broadcast loads per pair for 4
//   pixels (9 scalar loads per pixel before); 2 c01 is folded at staging
//   (exact: a power of two), nothing else. Each pixel keeps its own T,
//   colour and count and stops updating after its crossing splat: its
//   alpha is zeroed, without a branch (a branch per pixel costs the
//   divergence handling around it). A thread stops when its 4 pixels are
//   done, and the CTA leaves when every thread is (__syncthreads_count).
//
//   Pairs are staged in batches of 64, one a thread, double-buffered with
//   cp.async (4-byte copies: a 36-byte attribute row is not 16-byte
//   aligned): the gather of batch k+1 through splat_gid runs while batch k
//   is composited, and the ids of batch k+2 are loaded into a register
//   meanwhile. One barrier a batch both publishes batch k and frees the
//   buffer of batch k-1. The two buffers are 6 KB, so shared memory leaves
//   room for the 32 resident 64-thread CTAs an SM can hold.

#include <cstdint>
#include <cuda_runtime.h>

#include "packing.cuh"
#include "raster_common.cuh"

namespace {

using gs::kAlphaCutoff;
using gs::kAttrs;
using gs::kOutRows;
using gs::kPix;
using gs::kTEps;
using gs::kTile;
constexpr int kPixPerThread = 4;  // pixels a thread composites
constexpr int kThreads = kPix / kPixPerThread;
constexpr int kBatch = kThreads;  // pairs staged per batch, one a thread

// One 4-byte cp.async, global -> shared (.ca: .cg takes only 16 bytes).
__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

template <bool kPacked>
__global__ void __launch_bounds__(kThreads)
rasterize_forward_kernel(float* __restrict__ out,
                         const float* __restrict__ attrs,
                         const int32_t* __restrict__ splat_gid,
                         const int32_t* __restrict__ tile_start,
                         const int32_t* __restrict__ tile_count,
                         int num_tiles_x, const float* __restrict__ bg_ptr) {
  // The background from device memory: a CUDA graph that replays this
  // launch sees the value of the replay, not that of the capture.
  const float bg = *bg_ptr;
  // [buffer][u v c00 2c01 | c11 opa r g | b - - -][pair of the batch]
  __shared__ float4 s_attr[2][3][kBatch];
  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int start = tile_start[t];
  const int count = tile_count[t];
  // This thread's pixels: (px + q, py) for q < kPixPerThread, global, or
  // relative to the tile's origin (x0, y0) in packed mode.
  const int tx0 = (t % num_tiles_x) * kTile, ty0 = (t / num_tiles_x) * kTile;
  const float x0 = (float)tx0, y0 = (float)ty0;
  const float px = (float)((kPacked ? 0 : tx0) + (tid * kPixPerThread) % kTile);
  const float py = (float)((kPacked ? 0 : ty0) + (tid * kPixPerThread) / kTile);

  // Gather Gaussian gid's row into this thread's slot of buffer buf.
  auto stage = [&](int buf, int gid) {
    const float* a = attrs + (int64_t)gid * kAttrs;
    float* d = reinterpret_cast<float*>(&s_attr[buf][0][tid]);
#pragma unroll
    for (int k = 0; k < 4; ++k) cp_async4(d + k, a + k);
    d = reinterpret_cast<float*>(&s_attr[buf][1][tid]);
#pragma unroll
    for (int k = 0; k < 4; ++k) cp_async4(d + k, a + 4 + k);
    cp_async4(reinterpret_cast<float*>(&s_attr[buf][2][tid]), a + 8);
  };

  if (tid < count) stage(0, splat_gid[start + tid]);
  cp_async_commit();
  int gid_next = kBatch + tid < count ? splat_gid[start + kBatch + tid] : 0;

  // A pixel is alive while T >= 1e-4: T only falls, and it freezes at the
  // post-crossing value because a dead pixel's alpha is zeroed below.
  float T[kPixPerThread], acc_r[kPixPerThread], acc_g[kPixPerThread];
  float acc_b[kPixPerThread];
  int n[kPixPerThread];
#pragma unroll
  for (int q = 0; q < kPixPerThread; ++q) {
    T[q] = 1.0f;
    acc_r[q] = acc_g[q] = acc_b[q] = 0.0f;
    n[q] = 0;
  }
  bool all_done = false;

  for (int b0 = 0, buf = 0; b0 < count; b0 += kBatch, buf ^= 1) {
    cp_async_wait_all();  // this thread's copies of the batch have landed
    if (b0 + tid < count) {
      float4& a0 = s_attr[buf][0][tid];
      if (kPacked) {
        float4& a1 = s_attr[buf][1][tid];
        float& a2 = s_attr[buf][2][tid].x;
        float a[9] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w, a2};
        gs::round_pair_attrs(a, x0, y0);
        a0 = make_float4(a[0], a[1], a[2], a[3]);
        a1 = make_float4(a[4], a[5], a[6], a[7]);
        a2 = a[8];
      }
      a0.w *= 2.0f;
    }
    // Publishes the batch and frees the other buffer (read in the batch
    // before); the CTA leaves once every thread is done.
    if (__syncthreads_count(all_done) == kThreads) break;
    if (b0 + kBatch + tid < count) stage(buf ^ 1, gid_next);
    cp_async_commit();
    if (b0 + 2 * kBatch + tid < count) gid_next = splat_gid[start + b0 + 2 * kBatch + tid];

    const int nb = min(kBatch, count - b0);
    for (int j = 0; j < nb; ++j) {
      bool alive[kPixPerThread];
      bool any = false;
#pragma unroll
      for (int q = 0; q < kPixPerThread; ++q) {
        alive[q] = T[q] >= kTEps;
        any = any || alive[q];
      }
      if (!any) break;
      const float4 a0 = s_attr[buf][0][j];  // u v c00 2c01
      const float4 a1 = s_attr[buf][1][j];  // c11 opa r g
      const float cb = s_attr[buf][2][j].x;
      const float dy = a0.y - py;
      const float c11_dy_dy = __fmul_rn(__fmul_rn(a1.x, dy), dy);
      // Branch-free over the pixels: a dead pixel gets alpha 0, which
      // leaves its T and colour exactly as they are. A pixel's n_splats is
      // the count of pairs up to its last live one.
      const int iterated = b0 + j + 1;
#pragma unroll
      for (int q = 0; q < kPixPerThread; ++q) {
        if (alive[q]) n[q] = iterated;
        const float dx = a0.x - (px + (float)q);
        float alpha = gs::splat_alpha(
            a1.y, gs::splat_falloff_row(a0.z, a0.w, c11_dy_dy, dx, dy));
        if (!(alive[q] && alpha > kAlphaCutoff)) alpha = 0.0f;
        const float w = alpha * T[q];
        acc_r[q] += w * a1.z;
        acc_g[q] += w * a1.w;
        acc_b[q] += w * cb;
        T[q] = T[q] * (1.0f - alpha);
      }
    }
    all_done = true;
#pragma unroll
    for (int q = 0; q < kPixPerThread; ++q) all_done = all_done && !(T[q] >= kTEps);
  }
  float* o = out + (int64_t)t * kOutRows * kPix + tid * kPixPerThread;
#pragma unroll
  for (int q = 0; q < kPixPerThread; ++q) {
    o[0 * kPix + q] = acc_r[q] + T[q] * bg;
    o[1 * kPix + q] = acc_g[q] + T[q] * bg;
    o[2 * kPix + q] = acc_b[q] + T[q] * bg;
    o[3 * kPix + q] = T[q];
    o[4 * kPix + q] = (float)n[q];
  }
}

}  // namespace

extern "C" int gs_rasterize_forward(void* out, const void* attrs,
                                    const void* splat_gid,
                                    const void* tile_start,
                                    const void* tile_count, int num_tiles,
                                    int num_tiles_x, const void* bg, int packed,
                                    void* stream) {
  if (num_tiles > 0) {
    auto kernel = packed ? rasterize_forward_kernel<true> : rasterize_forward_kernel<false>;
    kernel<<<num_tiles, kThreads, 0, (cudaStream_t)stream>>>(
        (float*)out, (const float*)attrs, (const int32_t*)splat_gid,
        (const int32_t*)tile_start, (const int32_t*)tile_count, num_tiles_x,
        (const float*)bg);
  }
  return (int)cudaGetLastError();
}
