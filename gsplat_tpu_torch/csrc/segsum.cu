// Segment sum by Gaussian id: per-Gaussian sums of the per-pair gradient rows.
//
// Replaces the TPU kernel gsplat_tpu/kernels/segsum.py::segment_sum_by_gid
// (_segsum_kernel). The TPU kernel streams the gid-sorted (9, P) rows in
// chunks and reduces each block of 512 Gaussians with a one-hot matrix
// product on the MXU. Here one thread owns one Gaussian g:
//
//   it binary-searches its run [lo, hi) of sorted_gid == g, sums
//   rows[perm[j]] for j = lo .. hi-1 in that order (the gather rides in the
//   kernel, so no permuted copy of the rows is made) and writes its row,
//   zeros for a Gaussian without pairs. The summation order is fixed, so the
//   result is deterministic.
//
// What bounds it on an H100: memory latency of the gathered 36-byte rows
// (~5.5M pairs at the bench point, ~200 MB read once) and the two binary
// searches per Gaussian (~23 dependent loads each over ~5.5M sorted ids).
// Threads of a warp own neighbouring Gaussians, so the searches share
// cache lines.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 9;
constexpr int kThreads = 256;

__device__ __forceinline__ int lower_bound(const int32_t* __restrict__ a, int lo,
                                           int hi, int key) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads)
segment_sum_kernel(float* __restrict__ out, const float* __restrict__ rows,
                   const int32_t* __restrict__ perm,
                   const int32_t* __restrict__ sorted_gid, int p, int n) {
  const int g = blockIdx.x * kThreads + threadIdx.x;
  if (g >= n) return;
  const int lo = lower_bound(sorted_gid, 0, p, g);
  const int hi = lower_bound(sorted_gid, lo, p, g + 1);
  float acc[kRows];
#pragma unroll
  for (int k = 0; k < kRows; ++k) acc[k] = 0.0f;
  for (int j = lo; j < hi; ++j) {
    const float* r = rows + (int64_t)perm[j] * kRows;
#pragma unroll
    for (int k = 0; k < kRows; ++k) acc[k] += r[k];
  }
  float* o = out + (int64_t)g * kRows;
#pragma unroll
  for (int k = 0; k < kRows; ++k) o[k] = acc[k];
}

}  // namespace

extern "C" int gs_segment_sum(void* out, const void* rows, const void* perm,
                              const void* sorted_gid, int p, int n,
                              void* stream) {
  if (n > 0) {
    segment_sum_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                         (cudaStream_t)stream>>>(
        (float*)out, (const float*)rows, (const int32_t*)perm,
        (const int32_t*)sorted_gid, p, n);
  }
  return (int)cudaGetLastError();
}
