// Segment expand: repeat record columns by per-record counts.
//
// Replaces the TPU kernel gsplat_tpu/kernels/expand.py::segment_expand
// (_expand_kernel), which binning runs twice (Gaussian -> tile rows, row ->
// tile pairs). There it is a windowed one-hot matmul on the MXU so that the
// TPU never gathers per index; here a gather is cheap, so the kernel is the
// direct definition:
//
//   out[c, s] = records[c, g]   for the g with offsets[g] <= s < offsets[g+1]
//
// One thread per output slot finds g by binary search (upper bound) over the
// exclusive offsets. Zero counts need no special case: equal consecutive
// offsets are skipped by the upper-bound search. Columns are 32-bit words,
// so int32 and float32 records share one kernel (bits are copied).
//
// What bounds it on an H100: device memory. The port expands only a few
// index columns (the callers gather attribute rows by index afterwards), so
// per slot it writes C words and reads C words plus log2(R) offsets, which
// stay in L2/L1 for neighbouring slots of one warp (they search the same
// short range). The search costs ~20 dependent loads at R = 1M records; the
// card hides that latency with many resident warps, so the design keeps a
// small block (256 threads) and no shared memory.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void segment_expand_kernel(
    uint32_t* __restrict__ out, const uint32_t* __restrict__ records,
    const int32_t* __restrict__ offsets_ext, int num_cols, int num_records,
    int total) {
  int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= total) return;
  // Largest g in [0, R) with offsets_ext[g] <= s: upper bound minus one.
  int lo = 0, hi = num_records;  // answer in [lo, hi)
  while (hi - lo > 1) {
    int mid = (lo + hi) >> 1;
    if (offsets_ext[mid] <= s) lo = mid; else hi = mid;
  }
  for (int c = 0; c < num_cols; ++c) {
    out[(int64_t)c * total + s] = records[(int64_t)c * num_records + lo];
  }
}

}  // namespace

extern "C" int gs_segment_expand(void* out, const void* records,
                                 const void* offsets_ext, int num_cols,
                                 int num_records, int total, void* stream) {
  if (total > 0) {
    const int threads = 256;
    const int blocks = (total + threads - 1) / threads;
    segment_expand_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (uint32_t*)out, (const uint32_t*)records,
        (const int32_t*)offsets_ext, num_cols, num_records, total);
  }
  return (int)cudaGetLastError();
}
