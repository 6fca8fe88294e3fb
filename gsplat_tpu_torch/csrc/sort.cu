// Stable LSD radix sort of non-negative 32-bit keys, returning the
// permutation (the stable argsort) beside the sorted keys.
//
// Replaces the TPU kernel gsplat_tpu/kernels/sort.py::sample_sort
// (sort_blocks / _sort_blocks_kernel, _partition_kernel,
// _range_sort_kernel) at its tile-sort call site. On the TPU that is a
// bitonic sample sort carrying every payload column through VMEM, because
// gathers are expensive there; here a gather is cheap, so the sort moves
// only (key, index) and the caller gathers rows with the permutation.
//
// The tile sort's candidates arrive Gaussian-major (gid ascending) and a
// Gaussian has at most one pair per tile, so a STABLE sort on the
// (tile << qd_bits | qdepth) key alone reproduces the reference's
// lexicographic (key, gid) order exactly.
//
// Each pass sorts by one 8-bit digit with three kernels:
//   1. radix_hist: per-block digit histogram (shared-memory atomics),
//      written digit-major, hist[d * num_blocks + b];
//   2. exclusive_scan: one block scans the digit-major histogram, which
//      turns it into the global output offset of (digit d, block b);
//   3. radix_scatter: each block walks its keys in order, 256 at a time,
//      ranks each key among equal digits (warp match + per-warp counts in
//      shared memory, so the rank is stable) and writes key and index.
// Key width at the bench point (1296x840, tile 16) is 13 + 16 = 29 bits:
// four passes.
//
// What bounds it on an H100: device memory traffic and the scatter's
// poorly coalesced writes. Per pass it reads the keys twice and the
// indices once and writes both (~20 bytes a key); at 5.5M keys that is
// ~110 MB a pass. The scan runs on one SM
// (a few hundred thousand counters) and is latency-bound; a decoupled
// look-back scan would remove it (later work).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;   // radix_hist / radix_scatter block size
constexpr int kItems = 16;      // keys per thread
constexpr int kTile = kThreads * kItems;  // keys per block
constexpr int kRadix = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kScanThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;

__global__ void radix_hist(const uint32_t* __restrict__ keys, int n, int shift,
                           uint32_t* __restrict__ hist, int num_blocks) {
  __shared__ uint32_t cnt[kRadix];
  cnt[threadIdx.x] = 0;
  __syncthreads();
  const int64_t base = (int64_t)blockIdx.x * kTile;
  for (int i = threadIdx.x; i < kTile; i += kThreads) {
    const int64_t idx = base + i;
    if (idx < n) atomicAdd(&cnt[(keys[idx] >> shift) & (kRadix - 1)], 1u);
  }
  __syncthreads();
  hist[(int64_t)threadIdx.x * num_blocks + blockIdx.x] = cnt[threadIdx.x];
}

// In-place exclusive scan of data[0, m) by one block of kScanThreads.
__global__ void exclusive_scan(uint32_t* __restrict__ data, int m) {
  __shared__ uint32_t warp_tot[kScanThreads / 32];
  __shared__ uint32_t carry;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (int base = 0; base < m; base += kScanThreads * 4) {
    const int i0 = base + threadIdx.x * 4;
    uint32_t v[4], ex[4], sum = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      v[k] = (i0 + k < m) ? data[i0 + k] : 0u;
      ex[k] = sum;
      sum += v[k];
    }
    uint32_t x = sum;  // warp inclusive scan of the thread sums
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t y = __shfl_up_sync(kFull, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) warp_tot[warp] = x;
    __syncthreads();
    if (warp == 0) {
      uint32_t w = warp_tot[lane];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const uint32_t y = __shfl_up_sync(kFull, w, o);
        if (lane >= o) w += y;
      }
      warp_tot[lane] = w;  // inclusive over warps
    }
    __syncthreads();
    const uint32_t prefix =
        carry + (warp == 0 ? 0u : warp_tot[warp - 1]) + (x - sum);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (i0 + k < m) data[i0 + k] = prefix + ex[k];
    }
    __syncthreads();
    if (threadIdx.x == 0) carry += warp_tot[kScanThreads / 32 - 1];
    __syncthreads();
  }
}

// vals_in == nullptr means the identity permutation (first pass).
__global__ void radix_scatter(const uint32_t* __restrict__ keys_in,
                              const int32_t* __restrict__ vals_in,
                              uint32_t* __restrict__ keys_out,
                              int32_t* __restrict__ vals_out,
                              const uint32_t* __restrict__ offsets, int n,
                              int shift, int num_blocks) {
  __shared__ uint32_t base[kRadix];
  __shared__ uint32_t warp_cnt[kWarps][kRadix];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  base[tid] = offsets[(int64_t)tid * num_blocks + blockIdx.x];
#pragma unroll
  for (int w = 0; w < kWarps; ++w) warp_cnt[w][tid] = 0;
  __syncthreads();
  const unsigned lt_mask = (1u << lane) - 1u;
  for (int j = 0; j < kItems; ++j) {
    const int64_t idx = (int64_t)blockIdx.x * kTile + j * kThreads + tid;
    const bool valid = idx < n;
    const uint32_t key = valid ? keys_in[idx] : 0u;
    // Out-of-range lanes group under the non-digit 256.
    const uint32_t digit = valid ? (key >> shift) & (kRadix - 1) : kRadix;
    const unsigned peers = __match_any_sync(kFull, digit);
    const uint32_t rank = __popc(peers & lt_mask);
    if (valid && lane == __ffs(peers) - 1) warp_cnt[warp][digit] = __popc(peers);
    __syncthreads();
    if (valid) {
      uint32_t pos = base[digit] + rank;
      for (int w = 0; w < warp; ++w) pos += warp_cnt[w][digit];
      keys_out[pos] = key;
      vals_out[pos] = vals_in ? vals_in[idx] : (int32_t)idx;
    }
    __syncthreads();
    uint32_t s = 0;  // thread tid owns digit tid
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      s += warp_cnt[w][tid];
      warp_cnt[w][tid] = 0;
    }
    base[tid] += s;
    __syncthreads();
  }
}

}  // namespace

// Sorts n keys of key_bits bits. Pass p writes buffer A when p is even and
// B when it is odd, so the result is in A after an odd number of passes
// ((key_bits + 7) / 8) and in B otherwise. hist holds 256 * num_blocks
// words, num_blocks = ceil(n / 4096). keys_in is not modified.
extern "C" int gs_radix_sort(const void* keys_in, void* keys_a, void* vals_a,
                             void* keys_b, void* vals_b, void* hist, int n,
                             int key_bits, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n > 0) {
    const int num_blocks = (n + kTile - 1) / kTile;
    const int passes = (key_bits + 7) / 8;
    const uint32_t* kin = (const uint32_t*)keys_in;
    const int32_t* vin = nullptr;
    for (int p = 0; p < passes; ++p) {
      uint32_t* kout = (uint32_t*)(p % 2 == 0 ? keys_a : keys_b);
      int32_t* vout = (int32_t*)(p % 2 == 0 ? vals_a : vals_b);
      const int shift = 8 * p;
      radix_hist<<<num_blocks, kThreads, 0, s>>>(kin, n, shift,
                                                 (uint32_t*)hist, num_blocks);
      exclusive_scan<<<1, kScanThreads, 0, s>>>((uint32_t*)hist,
                                                kRadix * num_blocks);
      radix_scatter<<<num_blocks, kThreads, 0, s>>>(
          kin, vin, kout, vout, (const uint32_t*)hist, n, shift, num_blocks);
      kin = kout;
      vin = vout;
    }
  }
  return (int)cudaGetLastError();
}
