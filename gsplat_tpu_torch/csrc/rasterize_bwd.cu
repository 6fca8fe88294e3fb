// Backward tile rasterizer: back-to-front replay, one gradient row per pair.
//
// Replaces the TPU kernel gsplat_tpu/kernels/rasterize.py::rasterize_backward
// (:815; _backward_kernel / _backward_tile), in both its modes. The TPU
// kernel walks (256 pixel x K pair) chunks with lane-axis cumulative
// products, writes only the chunks it owns and leaves the rest of its
// output uninitialised (ops/render.py masks and patches it afterwards).
// Here:
//
//   one CTA per 16x16 tile, 64 threads, each replaying 4 neighbouring
//   pixels of a row; the tile's pairs are read through splat_gid into
//   shared memory in batches of 64, walked back to front from the batch
//   that holds the tile's largest n_splats (a block max over the forward's
//   n_splats row); a warp skips the pairs past its own deepest n_splats.
//   Each pixel replays T from its T_final (T *= 1 / (1 - alpha), one
//   approximate reciprocal per pair, within 2 ulp as 1 - alpha >= 0.01)
//   and keeps one scalar sum of what lies behind the splat: the
//   background's share T_final bg sum(dI) plus w_k (c_k . dI) of every
//   later splat (the image cotangent is constant per pixel, so the
//   reference's three per-colour sums collapse into one).
//
// Packed mode (the reference's default). kPackedIn: each pair's attributes
// are rounded as the packed stream carries them when the batch is staged
// (packing.cuh: round_pair_attrs, u and v relative to the tile's origin)
// and the pixels take tile-local coordinates, as in the forward kernel.
// kPackOut (the reference's pack_grads, kernels/rasterize.py:147-158,
// :779): a pair's nine sums, formed exactly as the f32 rows are (by the
// same instructions: only the stores after them differ), become
// four int32 words [du|dv, dc00|dc01, dc11|dopa, e5s9(dr dg db)], written
// by one thread with one 16-byte store; rows past every n_splats get the
// words of a zero row. The reference forms those sums with bf16 matrix
// products on its MXU; here they are the f32 sums of the exact mode, then
// packed.
//
// What bounds it on an H100: instruction issue. Each replayed pair-pixel
// is 26 FP32 operations up to the 1/255 cutoff (expf is 10 of them) and 44
// more past it (chip_smoke.py counts both), and every pair's nine values
// must be summed over the tile's 256 pixels. Summing each value with a
// butterfly (5 shuffles) costs 45 shuffles per pair and warp, and the card
// issues shuffles at a quarter of the FP32 rate, so those butterflies
// would outweigh the arithmetic. Instead:
//
//   a thread sums its 4 pixels' values in registers, so the warp sums 128
//   pixels at once; and it holds the nine values of a group of 4
//   consecutive pairs of the walk (36 registers). A group with no live lane
//   in the warp is skipped; otherwise the warp reduce-scatters the 36
//   values: at each of five halving steps a lane keeps half of its partials
//   and sends the other half to its partner, so every shuffle carries a
//   distinct partial (31 shuffles leave lane L with value L summed over the
//   warp; the last 4 values take 6 more), 37 shuffles per group instead of
//   180. One partial per warp and value goes to shared memory; after the
//   batch one thread per value adds the 2 warp partials in warp order and
//   writes the row. Every row of the tile's range is written exactly once:
//   rows past every pixel's n_splats are written as zeros. The summation
//   order is fixed and there are no atomics, so a rerun gives bit-identical
//   rows.
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

#include <cstdint>
#include <cuda_runtime.h>

#include "packing.cuh"
#include "raster_common.cuh"

namespace {

using gs::kAlphaCutoff;
using gs::kAttrs;
using gs::kOutRows;
using gs::kPix;
using gs::kTile;
constexpr int kPixPerThread = 4;  // pixels a thread replays
constexpr int kThreads = kPix / kPixPerThread;
constexpr int kWarps = kThreads / 32;
constexpr int kGrads = 9;    // [du dv dc00 dc01 dc11 dopa dr dg db]
constexpr int kBatch = 64;   // pairs staged per batch
constexpr int kGroup = 4;    // pairs reduced together
constexpr int kVals = kGroup * kGrads;  // 36 = 32 + 4
constexpr unsigned kFull = 0xffffffffu;

// One halving step over x[0, 2h): lanes with bit `o` clear keep x[0, h),
// the others x[h, 2h); each adds the partner's partials of the half it
// keeps, which land in x[0, h).
template <int H>
__device__ __forceinline__ void halve(float* x, int lane, int o) {
  const bool upper = lane & o;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float send = upper ? x[i] : x[i + H];
    const float keep = upper ? x[i + H] : x[i];
    x[i] = keep + __shfl_xor_sync(kFull, send, o);
  }
}

// grads_out: (P, 9) float32 rows, or (P, 4) int32 words with kPackOut.
template <bool kPackedIn, bool kPackOut>
__global__ void __launch_bounds__(kThreads)
rasterize_backward_kernel(void* __restrict__ grads_out,
                          const float* __restrict__ attrs,
                          const int32_t* __restrict__ splat_gid,
                          const int32_t* __restrict__ tile_start,
                          const int32_t* __restrict__ tile_count,
                          const float* __restrict__ out,
                          const float* __restrict__ d_tiles,
                          int num_tiles_x, const float* __restrict__ bg_ptr,
                          float scale_u, float scale_v) {
  // A pair's attributes as three float4s [u v c00 c01] [c11 opa r g] [b]:
  // three broadcast loads a pair.
  __shared__ float4 s_attr[3][kBatch];
  __shared__ float s_part[kWarps][kBatch * kGrads];  // [warp][pair * 9 + value]
  __shared__ int s_maxn[kWarps];
  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int start = tile_start[t];
  const int count = tile_count[t];
  const float bg = *bg_ptr;  // device memory, as in the forward

  // This thread's pixels: kPixPerThread neighbours in a row of the tile,
  // (px + q, py) for q < kPixPerThread; global, or relative to the tile's
  // origin (x0, y0) with kPackedIn.
  const int tx0 = (t % num_tiles_x) * kTile, ty0 = (t / num_tiles_x) * kTile;
  const float x0 = (float)tx0, y0 = (float)ty0;
  const float px = (float)((kPackedIn ? 0 : tx0) + (tid * kPixPerThread) % kTile);
  const float py = (float)((kPackedIn ? 0 : ty0) + (tid * kPixPerThread) / kTile);
  float T[kPixPerThread], rest[kPixPerThread], dr[kPixPerThread];
  float dg[kPixPerThread], db[kPixPerThread];
  int nspl[kPixPerThread];
  int wmax = 0;
#pragma unroll
  for (int q = 0; q < kPixPerThread; ++q) {
    const int pix = tid * kPixPerThread + q;
    const float* o = out + (int64_t)t * kOutRows * kPix + pix;
    const float* d = d_tiles + (int64_t)t * 3 * kPix + pix;
    T[q] = o[3 * kPix];  // T_final: the replay starts behind the last splat
    nspl[q] = (int)o[4 * kPix];
    dr[q] = d[0];
    dg[q] = d[kPix];
    db[q] = d[2 * kPix];
    // What lies behind the splat being replayed: the background's share
    // T_final bg sum(dI), plus w_j (c_j . dI) of every splat behind it.
    rest[q] = T[q] * (bg * (dr[q] + dg[q] + db[q]));
    wmax = max(wmax, nspl[q]);
  }

  // The warp's and the tile's deepest splat: maxima of n_splats.
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    wmax = max(wmax, __shfl_xor_sync(kFull, wmax, off));
  }
  if (lane == 0) s_maxn[warp] = wmax;
  __syncthreads();
  int maxn = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) maxn = max(maxn, s_maxn[w]);
  maxn = min(maxn, count);

  float* g_tile = static_cast<float*>(grads_out) + (int64_t)start * kGrads;
  uint4* w_tile = static_cast<uint4*>(grads_out) + start;
  if (kPackOut) {
    const float zeros[kGrads] = {};
    const uint4 zero_row = gs::pack_grad_row(zeros);
    for (int j = maxn + tid; j < count; j += kThreads) w_tile[j] = zero_row;
  } else {
    for (int i = maxn * kGrads + tid; i < count * kGrads; i += kThreads) {
      g_tile[i] = 0.0f;
    }
  }

  // Where this lane's reduced values go: value `lane` of the group
  // (pair lane / 9 of the group, row lane % 9) and, on lanes 0, 8, 16, 24,
  // value 32 + lane / 8 (pair 3, row 5 + lane / 8).
  const int lo_pair = lane / kGrads, lo_row = lane % kGrads;
  const int hi_row = 5 + (lane >> 3);

  const int nbatch = (maxn + kBatch - 1) / kBatch;
  for (int b = nbatch - 1; b >= 0; --b) {
    const int b0 = b * kBatch;
    const int nb = min(kBatch, maxn - b0);
    __syncthreads();  // the previous batch's shared rows are consumed
    for (int j = tid; j < nb; j += kThreads) {
      const float* g = attrs + (int64_t)splat_gid[start + b0 + j] * kAttrs;
      float a[kAttrs];
#pragma unroll
      for (int k = 0; k < kAttrs; ++k) a[k] = g[k];
      if (kPackedIn) gs::round_pair_attrs(a, x0, y0);
      s_attr[0][j] = make_float4(a[0], a[1], a[2], a[3]);
      s_attr[1][j] = make_float4(a[4], a[5], a[6], a[7]);
      s_attr[2][j] = make_float4(a[8], 0.0f, 0.0f, 0.0f);
    }
    __syncthreads();
    for (int jt = nb - 1; jt >= 0; jt -= kGroup) {
      // Pair g of the group is jt - g (none where that is negative). A
      // group past every n_splats of the warp has no live lane: its sums
      // are zeros.
      float lo = 0.0f, hi = 0.0f;
      if (b0 + max(jt - (kGroup - 1), 0) < wmax) {
        float v[kVals];  // the thread's pixels summed in registers
        bool live = false;
#pragma unroll
        for (int g = 0; g < kGroup; ++g) {
          const int j = jt - g;
          float* vg = v + g * kGrads;
#pragma unroll
          for (int k = 0; k < kGrads; ++k) vg[k] = 0.0f;
          if (j < 0) continue;
          const float4 a0 = s_attr[0][j], a1 = s_attr[1][j];
          const float cb = s_attr[2][j].x;
          const float c00 = a0.z, c01 = a0.w, c11 = a1.x, opa = a1.y;
#pragma unroll
          for (int q = 0; q < kPixPerThread; ++q) {
            const float dx = a0.x - (px + (float)q);
            const float dy = a0.y - py;
            const float gval = gs::splat_falloff(c00, c01, c11, dx, dy);
            const float alpha = gs::splat_alpha(opa, gval);
            if ((b0 + j < nspl[q]) && (alpha > kAlphaCutoff)) {
              live = true;
              const float inv = __fdividef(1.0f, 1.0f - alpha);  // approximate
              T[q] = T[q] * inv;
              const float cdi = a1.z * dr[q] + a1.w * dg[q] + cb * db[q];
              const float w = alpha * T[q];
              const float grad_alpha = cdi * T[q] - rest[q] * inv;
              rest[q] += w * cdi;
              const float gp = gval * grad_alpha * opa;  // d/d power
              vg[0] += -(c00 * dx + c01 * dy) * gp;
              vg[1] += -(c11 * dy + c01 * dx) * gp;
              vg[2] += -0.5f * dx * dx * gp;
              vg[3] += -dx * dy * gp;
              vg[4] += -0.5f * dy * dy * gp;
              vg[5] += gval * grad_alpha;
              vg[6] += w * dr[q];
              vg[7] += w * dg[q];
              vg[8] += w * db[q];
            }
          }
        }
        if (__any_sync(kFull, live)) {
          halve<16>(v, lane, 16);
          halve<8>(v, lane, 8);
          halve<4>(v, lane, 4);
          halve<2>(v, lane, 2);
          halve<1>(v, lane, 1);
          float* x = v + 32;
          halve<2>(x, lane, 16);
          halve<1>(x, lane, 8);
#pragma unroll
          for (int off = 4; off > 0; off >>= 1) {
            x[0] += __shfl_xor_sync(kFull, x[0], off);
          }
          lo = v[0];
          hi = x[0];
        }
      }
      float* part = s_part[warp];
      if (jt - lo_pair >= 0) part[(jt - lo_pair) * kGrads + lo_row] = lo;
      if ((lane & 7) == 0 && jt - 3 >= 0) part[(jt - 3) * kGrads + hi_row] = hi;
    }
    __syncthreads();
    // Value i of the batch: the warps' partials in warp order, du and dv
    // scaled. In packed mode the sums land in s_part[0] and a thread per
    // pair packs its row.
    auto value = [&](int i) {
      float s = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += s_part[w][i];
      const int k = i % kGrads;
      if (k == 0) s *= scale_u;
      if (k == 1) s *= scale_v;
      return s;
    };
    if (kPackOut) {
      for (int i = tid; i < nb * kGrads; i += kThreads) s_part[0][i] = value(i);
      __syncthreads();
      for (int j = tid; j < nb; j += kThreads) {
        w_tile[b0 + j] = gs::pack_grad_row(&s_part[0][j * kGrads]);
      }
    } else {
      float* g_batch = g_tile + (int64_t)b0 * kGrads;
      for (int i = tid; i < nb * kGrads; i += kThreads) g_batch[i] = value(i);
    }
  }
}

}  // namespace

// packed: round the pairs' attributes as the packed stream carries them;
// pack_grads: write (P, 4) int32 words instead of (P, 9) float32 rows.
extern "C" int gs_rasterize_backward(void* grads, const void* attrs,
                                     const void* splat_gid,
                                     const void* tile_start,
                                     const void* tile_count, const void* out,
                                     const void* d_tiles, int num_tiles,
                                     int num_tiles_x, const void* bg, float scale_u,
                                     float scale_v, int packed, int pack_grads,
                                     void* stream) {
  if (num_tiles > 0) {
    auto kernel = packed ? (pack_grads ? rasterize_backward_kernel<true, true>
                                       : rasterize_backward_kernel<true, false>)
                         : (pack_grads ? rasterize_backward_kernel<false, true>
                                       : rasterize_backward_kernel<false, false>);
    kernel<<<num_tiles, kThreads, 0, (cudaStream_t)stream>>>(
        grads, (const float*)attrs, (const int32_t*)splat_gid,
        (const int32_t*)tile_start, (const int32_t*)tile_count,
        (const float*)out, (const float*)d_tiles, num_tiles_x, (const float*)bg, scale_u,
        scale_v);
  }
  return (int)cudaGetLastError();
}
