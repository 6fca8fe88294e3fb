// Segment sum by Gaussian: per-Gaussian sums of the per-pair gradient rows.
//
// Replaces the TPU kernel gsplat_tpu/kernels/segsum.py::segment_sum_by_gid
// (_segsum_kernel). The TPU kernel streams gid-sorted (9, P) rows in chunks
// (the reference sorts the pairs by Gaussian a second time to make that
// stream) and reduces each block of 512 Gaussians with a one-hot matrix
// product on the MXU. Here no second sort is made. Binning emits its
// candidates Gaussian-major, so Gaussian g's candidates are one run
// [pair_start[g], pair_start[g+1]), in ascending tile order; and pair_slot
// (the inverse of the stable tile sort's permutation) gives each
// candidate's row in the sorted pair list. A Gaussian has at most one pair
// per tile, so ascending tile is ascending row: the run lists g's rows in
// the order a stable sort of splat_gid would, and the sums below add the
// same rows in the same order as a segment sum after that sort.
//
//   9 lanes per Gaussian, 3 Gaussians a warp (lanes 27-31 idle): lane k of
//   Gaussian g's group sums column k of rows[pair_slot[c]] for c =
//   pair_start[g] .. pair_start[g+1]-1 in that order, so one warp load
//   reads 3 whole rows. A group takes 8 candidates at a time, predicated
//   past the run's end, so that 8 pair_slot loads and then 8 row loads are
//   in flight together and a run of up to 8 pairs costs two dependent
//   loads. No searches, no atomics: each output row is written once, zeros
//   for a Gaussian without pairs. A rerun gives bit-identical sums.
//
// What bounds it on an H100: bytes. Rows 36 P, pair_slot 4 P, pair_start
// 4 (N+1), output 36 N: ~256 MB at the bench point (~5.4M pairs, 2^20
// Gaussians), 0.076 ms at 3.35 TB/s. But the rows are gathered at random:
// Gaussian ids carry no locality, and a 36-byte row spans two 32-byte
// sectors, so device memory moves about twice the row bytes, in scattered
// sectors. On an H100 a thread per Gaussian (9 scalar loads a row, short
// runs walked one dependent load at a time) took ~0.28 ms of device time,
// in Gaussian order or in the order of the Gaussians' first rows; this
// layout ~0.23 ms (PERF.md). Several Gaussians per group did no better.
//
// Packed rows (segment_sum_packed_kernel; the reference's packed branch,
// kernels/segsum.py:108-124): each pair's row is four int32 words
// [du|dv, dc00|dc01, dc11|dopa, e5s9(dr dg db)] (packing.cuh), 16 bytes,
// one 32-byte sector. 4 lanes per Gaussian, 8 Gaussians a warp: lane k of
// a Gaussian's group reads word k of each of its rows (a warp load reads 8
// whole rows), unpacks it (two bf16 halves, or the three e5s9 channels for
// k = 3) and adds the values in f32 in run order, as the f32 kernel does.
// Bound: rows 16 P, pair_slot 4 P, pair_start 4 (N+1), output 36 N.
//
// A run is one group's serial walk (the longest at the bench point is
// printed by chip_smoke.py [10]); runs are not split, since that would
// change the summation order.
//
// inverse_permutation_kernel makes pair_slot for binning: out[perm[j]] = j
// over the tile sort's int32 permutation, one thread per slot, reading
// coalesced and writing 4-byte words at random. Bound: 8 bytes a pair,
// 0.013 ms at the bench point; it takes ~0.12 ms of device time, set by
// its 5.4M random 4-byte stores (~44G a second on an H100), not by the
// read. PyTorch's index_copy_ (its quickest scatter here) took ~0.14 ms
// plus an arange for the values. Storing the inverse from the tile sort's
// last pass, which holds both halves of each write, saves this launch and
// the read but not the stores, and it slowed the kernels after the sort:
// the train step took 0.017 ms of device time more than with this kernel,
// 0.045 ms more with an L2 evict-last hint on the stores (PERF.md).

#include <cstdint>
#include <cuda_runtime.h>

#include "packing.cuh"

namespace {

constexpr int kRows = 9;
constexpr int kThreads = 256;
constexpr int kGroups = 3;  // Gaussians a warp, kRows lanes each
constexpr int kUnroll = 8;  // candidates whose loads are in flight together

__global__ void __launch_bounds__(kThreads)
segment_sum_kernel(float* __restrict__ out, const float* __restrict__ rows,
                   const int32_t* __restrict__ pair_slot,
                   const int32_t* __restrict__ pair_start, int n) {
  const int lane = threadIdx.x & 31;
  const int warp = (blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int g = warp * kGroups + lane / kRows;
  const int k = lane % kRows;
  if (lane >= kGroups * kRows || g >= n) return;
  const int hi = pair_start[g + 1];
  float acc = 0.0f;
  for (int c = pair_start[g]; c < hi; c += kUnroll) {
    int slot[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) slot[u] = c + u < hi ? pair_slot[c + u] : 0;
    float r[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      r[u] = c + u < hi ? rows[(int64_t)slot[u] * kRows + k] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (c + u < hi) acc += r[u];
    }
  }
  out[(int64_t)g * kRows + k] = acc;
}

constexpr int kWords = 4;                  // int32 words of a packed row
constexpr int kPackedGroups = 32 / kWords;  // Gaussians a warp, a lane a word

__global__ void __launch_bounds__(kThreads)
segment_sum_packed_kernel(float* __restrict__ out, const uint32_t* __restrict__ words,
                          const int32_t* __restrict__ pair_slot,
                          const int32_t* __restrict__ pair_start, int n) {
  const int lane = threadIdx.x & 31;
  const int warp = (blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int g = warp * kPackedGroups + lane / kWords;
  const int k = lane % kWords;  // columns 2k, 2k + 1; or 6, 7, 8 for k = 3
  if (g >= n) return;
  const int hi = pair_start[g + 1];
  float acc[3] = {0.0f, 0.0f, 0.0f};
  for (int c = pair_start[g]; c < hi; c += kUnroll) {
    int slot[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) slot[u] = c + u < hi ? pair_slot[c + u] : 0;
    uint32_t w[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      w[u] = c + u < hi ? words[(int64_t)slot[u] * kWords + k] : 0u;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (c + u >= hi) continue;
      float v[3] = {0.0f, 0.0f, 0.0f};
      if (k < 3) {
        gs::unpack_bf16_pair(w[u], v[0], v[1]);
      } else {
        gs::unpack_rgb_e5(w[u], gs::kGradE5Bias, v[0], v[1], v[2]);
      }
#pragma unroll
      for (int i = 0; i < 3; ++i) acc[i] += v[i];
    }
  }
  float* o = out + (int64_t)g * kRows + 2 * k;
  o[0] = acc[0];
  o[1] = acc[1];
  if (k == 3) o[2] = acc[2];
}

__global__ void __launch_bounds__(kThreads)
inverse_permutation_kernel(int32_t* __restrict__ out,
                           const int32_t* __restrict__ perm, int p) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j < p) out[perm[j]] = j;
}

}  // namespace

extern "C" int gs_inverse_permutation(void* out, const void* perm, int p,
                                      void* stream) {
  if (p > 0) {
    inverse_permutation_kernel<<<(p + kThreads - 1) / kThreads, kThreads, 0,
                                 (cudaStream_t)stream>>>(
        (int32_t*)out, (const int32_t*)perm, p);
  }
  return (int)cudaGetLastError();
}

extern "C" int gs_segment_sum(void* out, const void* rows, const void* pair_slot,
                              const void* pair_start, int n, void* stream) {
  if (n > 0) {
    const int warps = (n + kGroups - 1) / kGroups;
    const int blocks = (warps + kThreads / 32 - 1) / (kThreads / 32);
    segment_sum_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (float*)out, (const float*)rows, (const int32_t*)pair_slot,
        (const int32_t*)pair_start, n);
  }
  return (int)cudaGetLastError();
}

extern "C" int gs_segment_sum_packed(void* out, const void* words, const void* pair_slot,
                                     const void* pair_start, int n, void* stream) {
  if (n > 0) {
    const int warps = (n + kPackedGroups - 1) / kPackedGroups;
    const int blocks = (warps + kThreads / 32 - 1) / (kThreads / 32);
    segment_sum_packed_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (float*)out, (const uint32_t*)words, (const int32_t*)pair_slot,
        (const int32_t*)pair_start, n);
  }
  return (int)cudaGetLastError();
}
