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
// Columns are 32-bit words, so int32 and float32 records share one kernel
// (bits are copied).
//
// What bounds it on an H100: device memory, ~100 MB a frame at the bench
// point (two levels: 2^20 Gaussians -> ~2.24M rows -> ~5.4M pairs), 0.030 ms
// at 3.35 TB/s. A thread per slot that binary-searches the offsets (the
// first design) is held instead by a chain of ~21 dependent loads per slot,
// 7.6M slots a frame. This design is a merge-path load-balanced search:
//
//   The slots 0..total-1 and the run ends offsets_ext[1..R] are merged, an
//   end going first on a tie; slot s then follows exactly the ends <= s,
//   whose number is its record g. Each block owns kItems items of that
//   merged sequence, so a run that spans many blocks (a large Gaussian's
//   rows) and long stretches of zero counts (invisible Gaussians, rows with
//   no tile) cost the same as any other items. Two warps find where the
//   block's share starts and ends in both lists (a 32-ary search: 32 probes
//   a round, ~5 dependent loads at R + total ~ 7.6M). The block reads its
//   run ends into shared memory, coalesced; each thread finds its own
//   sub-diagonal there and walks its kItemsPerThread items in order, noting
//   each slot's record. Then, column by column, the block stages its
//   records' column (contiguous, coalesced) and writes its slots' words, a
//   warp to 32 neighbouring addresses. No search over global memory per
//   slot; one launch per call.
//
// At the bench point both levels take 0.057 ms of device time (the
// per-slot search took 0.166), at 8 items a thread; 4 took 0.068 and 12
// no less (PERF.md). What is left is each block's chain of
// dependent steps (search, run ends, walk, then per column records and
// slots, a barrier between each) over ~3.5 waves of blocks at level 2.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItemsPerThread = 8;
constexpr int kItems = kThreads * kItemsPerThread;  // merged items a block
constexpr unsigned kFull = 0xffffffffu;

// The number of slots among the first `diag` merged items: the smallest a
// in [lo, hi] with !(a < ends[diag - 1 - a]) (slot a does not precede the
// end beside it on the diagonal), hi if every a does. The predicate is
// true then false as a grows. Called by a whole warp: each round its lanes
// probe 32 points of [lo, hi), and the count of true probes narrows the
// interval to one gap between neighbouring probes.
__device__ int merge_path_warp(const int32_t* __restrict__ ends, long long diag,
                               int num_records, int total) {
  const int lane = threadIdx.x & 31;
  int lo = (int)max(0LL, diag - num_records);
  int hi = (int)min(diag, (long long)total);
  while (lo < hi) {
    const int q = lo + (int)(((long long)(hi - lo) * lane) >> 5);
    const bool before = q < ends[diag - 1 - q];
    const int n = __popc(__ballot_sync(kFull, before));
    const int q_last = __shfl_sync(kFull, q, (n + 31) & 31);  // lane n - 1
    const int q_next = __shfl_sync(kFull, q, n & 31);         // lane n
    if (n == 0) {
      hi = lo;
    } else {
      lo = q_last + 1;
      if (n < 32) hi = q_next;
    }
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads)
segment_expand_kernel(uint32_t* __restrict__ out, const uint32_t* __restrict__ records,
                      const int32_t* __restrict__ offsets_ext, int num_cols,
                      int num_records, int total) {
  __shared__ int32_t s_ends[kItems];    // the block's run ends
  __shared__ int32_t s_rec[kItems];     // each slot's record, from the block's first
  __shared__ uint32_t s_col[kItems + 1];  // one column of the block's records
  __shared__ int s_split[4];            // (slots, ends) before the share, and after
  const int tid = threadIdx.x, warp = tid >> 5;
  const int32_t* ends = offsets_ext + 1;

  if (warp < 2) {
    const long long diag =
        min((long long)(blockIdx.x + warp) * kItems, (long long)num_records + total);
    const int a = merge_path_warp(ends, diag, num_records, total);
    if ((tid & 31) == 0) {
      s_split[2 * warp] = a;
      s_split[2 * warp + 1] = (int)(diag - a);
    }
  }
  __syncthreads();
  const int a0 = s_split[0], b0 = s_split[1];
  const int na = s_split[2] - a0, nb = s_split[3] - b0;

  // The share's run ends, every load of a thread in flight at once.
  {
    int32_t e[kItemsPerThread];
#pragma unroll
    for (int i = 0; i < kItemsPerThread; ++i) {
      const int k = tid + i * kThreads;
      e[i] = k < nb ? ends[b0 + k] : 0;
    }
#pragma unroll
    for (int i = 0; i < kItemsPerThread; ++i) {
      const int k = tid + i * kThreads;
      if (k < nb) s_ends[k] = e[i];
    }
  }
  __syncthreads();

  // This thread's items [diag, diag + kItemsPerThread) of the share: where
  // they start in both lists, then one merge step each.
  const int n_items = na + nb;
  const int diag = min(tid * kItemsPerThread, n_items);
  int lo = max(0, diag - nb), hi = min(diag, na);
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a0 + mid < s_ends[diag - 1 - mid]) lo = mid + 1; else hi = mid;
  }
  int a = lo, b = diag - lo;
#pragma unroll
  for (int i = 0; i < kItemsPerThread; ++i) {
    if (a + b < n_items) {
      if (b < nb && (a >= na || s_ends[b] <= a0 + a)) {
        ++b;
      } else {
        s_rec[a] = b;
        ++a;
      }
    }
  }
  __syncthreads();
  if (na == 0) return;

  // Column by column: the share's records (slots reach records b0 .. b0+nb,
  // the last only if it exists), then its slots, neighbouring threads on
  // neighbouring addresses.
  const int n_rec = min(nb + 1, num_records - b0);
  for (int c = 0; c < num_cols; ++c) {
    const uint32_t* col = records + (int64_t)c * num_records + b0;
    uint32_t w[kItemsPerThread + 1];
#pragma unroll
    for (int i = 0; i <= kItemsPerThread; ++i) {
      const int k = tid + i * kThreads;
      w[i] = k < n_rec ? col[k] : 0u;
    }
#pragma unroll
    for (int i = 0; i <= kItemsPerThread; ++i) {
      const int k = tid + i * kThreads;
      if (k < n_rec) s_col[k] = w[i];
    }
    __syncthreads();
    uint32_t* dst = out + (int64_t)c * total + a0;
#pragma unroll
    for (int i = 0; i < kItemsPerThread; ++i) {
      const int k = tid + i * kThreads;
      if (k < na) dst[k] = s_col[s_rec[k]];
    }
    __syncthreads();
  }
}

}  // namespace

// Expands (num_cols, num_records) 32-bit records into (num_cols, total)
// slots by offsets_ext (num_records + 1 exclusive offsets, the last =
// total < 2^31), one block per kItems merged items (records + slots).
extern "C" int gs_segment_expand(void* out, const void* records,
                                 const void* offsets_ext, int num_cols,
                                 int num_records, int total, void* stream) {
  if (num_cols < 0 || num_records < 0 || total < 0) return (int)cudaErrorInvalidValue;
  if (total > 0 && num_cols > 0) {
    const long long merged = (long long)num_records + total;
    const int num_blocks = (int)((merged + kItems - 1) / kItems);
    segment_expand_kernel<<<num_blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (uint32_t*)out, (const uint32_t*)records, (const int32_t*)offsets_ext,
        num_cols, num_records, total);
  }
  return (int)cudaGetLastError();
}
