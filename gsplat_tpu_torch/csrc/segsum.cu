// Segment sum by Gaussian: per-Gaussian sums of the per-pair gradient rows.
//
// Replaces the TPU kernel gsplat_tpu/kernels/segsum.py::segment_sum_by_gid
// (:139 -> pallas_call :250, _segsum_kernel; its packed branch :108-124).
// The TPU kernel streams gid-sorted (9, P) rows in chunks (the reference
// sorts the pairs by Gaussian a second time to make that stream) and
// reduces each block of 512 Gaussians with a one-hot matrix product on the
// MXU. Here no second sort is made and nothing is gathered: the backward
// rasterizer (rasterize_bwd.cu) stores each pair's row at the pair's
// candidate index (binning's pair_cand, the tile sort's permutation), and
// binning emits its candidates Gaussian-major, so Gaussian g's rows are one
// contiguous run [pair_start[g], pair_start[g+1]), in ascending tile order,
// and neighbouring Gaussians' runs lie next to each other. A Gaussian has at
// most one pair per tile, so the run lists g's rows in the order a stable
// sort of splat_gid would: the sums below add the same rows in the same
// order as a segment sum after that sort. Each column is summed in f32, in
// run order; no atomics, each output row is written once (zeros for a
// Gaussian without pairs), so a rerun gives bit-identical sums.
//
// What bounds it on an H100: bytes. Packed rows 16 P, pair_start 4 (N+1),
// sums 36 N: ~128 MB at the 1M view (5.4M pairs, 2^20 Gaussians), 0.038 ms
// at 3.35 TB/s; f32 rows 36 P instead of 16 P. The runs are short (about 5
// rows a Gaussian at the 1M view) and of uneven length, so the work is a
// stream of small contiguous runs.
//
// Packed rows (segment_sum_packed_kernel): each pair's row is four int32
// words [du|dv, dc00|dc01, dc11|dopa, e5s9(dr dg db)] (packing.cuh), one
// 16-byte load. One thread a Gaussian, 32 neighbouring Gaussians a warp,
// so a warp walks one contiguous stretch of rows; a thread keeps kUnroll
// row loads in flight (predicated past its run's end), so a run of up to
// kUnroll rows costs one round trip, and a longer run walks on with the
// next kUnroll. Each row is unpacked (three bf16 pairs, the e5s9 colour)
// and its nine values added in run order. The block's sums go through
// shared memory, so that its 256 x 36 bytes leave in coalesced stores.
//
// f32 rows (segment_sum_kernel): 9 lanes per Gaussian, 3 Gaussians a warp
// (lanes 27-31 idle): lane k of a Gaussian's group sums column k of its
// run, so one warp load reads 3 whole rows, with kUnroll loads in flight.
//
// A run is one thread's (or group's) serial walk (the longest at the 1M
// view is printed by chip_smoke.py [10]); runs are not split, since that
// would change the summation order.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700.00 W, device time a train
// step in chip_smoke.py's profiles (--train-profile at the 1M view,
// --scale-profile at 4.25M Gaussians; PERF.md): packed 0.059 ms at 1M
// (bound 0.038) and 0.169 ms at 4.25M, where the design before it, which
// gathered each row through the inverse of the tile sort's permutation,
// took 0.167 and 0.512 ms plus 0.122 and 0.498 ms for that inverse; f32
// rows 0.098 ms at 1M (before: 0.229 + 0.122).

#include <cstdint>
#include <cuda_runtime.h>

#include "packing.cuh"

namespace {

constexpr int kRows = 9;
constexpr int kThreads = 256;
constexpr int kGroups = 3;  // f32 rows: Gaussians a warp, kRows lanes each
constexpr int kUnroll = 8;  // rows whose loads are in flight together

__global__ void __launch_bounds__(kThreads)
segment_sum_kernel(float* __restrict__ out, const float* __restrict__ rows,
                   const int32_t* __restrict__ pair_start, int n) {
  const int lane = threadIdx.x & 31;
  const int warp = (blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int g = warp * kGroups + lane / kRows;
  const int k = lane % kRows;
  if (lane >= kGroups * kRows || g >= n) return;
  const int hi = pair_start[g + 1];
  float acc = 0.0f;
  for (int c = pair_start[g]; c < hi; c += kUnroll) {
    float r[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      r[u] = c + u < hi ? rows[(int64_t)(c + u) * kRows + k] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (c + u < hi) acc += r[u];
    }
  }
  out[(int64_t)g * kRows + k] = acc;
}

__global__ void __launch_bounds__(kThreads)
segment_sum_packed_kernel(float* __restrict__ out, const uint4* __restrict__ words,
                          const int32_t* __restrict__ pair_start, int n) {
  __shared__ float s_out[kThreads * kRows];  // stride 9: no bank conflicts
  const int g0 = blockIdx.x * kThreads;
  const int g = g0 + threadIdx.x;
  float acc[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) acc[i] = 0.0f;
  if (g < n) {
    const int hi = pair_start[g + 1];
    for (int c = pair_start[g]; c < hi; c += kUnroll) {
      uint4 w[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        w[u] = c + u < hi ? words[c + u] : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (c + u >= hi) break;
        float v[kRows];
        gs::unpack_bf16_pair(w[u].x, v[0], v[1]);
        gs::unpack_bf16_pair(w[u].y, v[2], v[3]);
        gs::unpack_bf16_pair(w[u].z, v[4], v[5]);
        gs::unpack_rgb_e5(w[u].w, gs::kGradE5Bias, v[6], v[7], v[8]);
#pragma unroll
        for (int i = 0; i < kRows; ++i) acc[i] += v[i];
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kRows; ++i) s_out[threadIdx.x * kRows + i] = acc[i];
  __syncthreads();
  const int m = min(kThreads, n - g0) * kRows;
  float* o = out + (int64_t)g0 * kRows;
  for (int i = threadIdx.x; i < m; i += kThreads) o[i] = s_out[i];
}

}  // namespace

extern "C" int gs_segment_sum(void* out, const void* rows, const void* pair_start, int n,
                              void* stream) {
  if (n > 0) {
    const int warps = (n + kGroups - 1) / kGroups;
    const int blocks = (warps + kThreads / 32 - 1) / (kThreads / 32);
    segment_sum_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (float*)out, (const float*)rows, (const int32_t*)pair_start, n);
  }
  return (int)cudaGetLastError();
}

extern "C" int gs_segment_sum_packed(void* out, const void* words, const void* pair_start,
                                     int n, void* stream) {
  if (n > 0) {
    segment_sum_packed_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                                (cudaStream_t)stream>>>(
        (float*)out, (const uint4*)words, (const int32_t*)pair_start, n);
  }
  return (int)cudaGetLastError();
}
