// Stable LSD radix sort of non-negative 32-bit keys, returning the
// permutation (the stable argsort) beside the sorted keys: a one-sweep
// design (Adinets and Merrill, "Onesweep", 2022).
//
// Replaces the TPU kernel gsplat_tpu/kernels/sort.py::sample_sort (:514;
// _partition_kernel, _range_sort_kernel) and sort_blocks (:211) at the
// tile sort (binning). The reference's other call site, the gradient
// regroup, has no counterpart: segsum.cu reads binning's per-Gaussian runs
// instead of sorting the pairs by Gaussian a second time. On
// the TPU that is a bitonic sample sort carrying every payload column
// through VMEM, because gathers are expensive there; here a gather is
// cheap, so the sort moves only (key, index) and the caller gathers rows
// with the permutation. The tile sort's candidates arrive Gaussian-major
// and a Gaussian has at most one pair per tile, so a STABLE sort on the
// (tile << qd_bits | qdepth) key alone reproduces the reference's
// lexicographic (key, gid) order.
//
// What bounds it on an H100: device memory, as bytes and as latency. A pass
// must read each key and index and write both (16 bytes a key; the first
// pass reads no index); the histogram reads the keys once more. So no
// pass reads the keys twice, scans on one block or scatters single 4-byte
// stores:
//
//   radix_histogram: ONE kernel reads the keys once and counts the digits
//     of every pass (shared-memory counts per block, each thread with all
//     its loads of a tile in flight, then one global atomic per block,
//     pass and digit).
//   onesweep_pass: ONE kernel per pass, no separate scan; a pass sorts on
//     a digit of at most 8 bits, and the caller's plan
//     (kernels/sort.py::sort_plan) says which bits each pass takes. A block
//     takes its tile (4096 keys) from a global atomic counter, so every
//     tile before it has started and the look-back below cannot wait on a
//     block that is not running. It ranks its keys stably: keys sit
//     warp-striped (warp, item, lane) in position order, and a warp ranks
//     one item at a time (__match_any_sync, per-warp digit counts in shared
//     memory). It publishes each digit's count (flag "aggregate"), finds
//     its global offsets by decoupled look-back (one thread per digit walks
//     back over the earlier tiles' status words until an "inclusive
//     prefix"), publishes its own inclusive prefix, stages keys and indices
//     in shared memory in digit order, and writes them out so that
//     neighbouring threads store to neighbouring addresses within each
//     digit's run. Each block scans the pass's 256 global digit counts
//     itself, beside its own counts. Between passes a key and its index
//     travel as one 8-byte pair (one load and one store each, and half the
//     partly written sectors at the edges of the digits' runs); the first
//     pass reads the keys alone, the last writes keys and indices apart.
//
// What is left is each tile's chain of latencies (loads, ranking, look-back,
// stores) with three resident blocks per SM and runs of ~16 keys a digit
// per tile at the scatter.
//
// Binning keeps the tile sort's permutation as pair_cand, and the backward
// rasterizer stores each pair's gradient row at it, so no inverse of the
// permutation is made.
//
// Launches: 1 histogram + 1 per pass, after one cudaMemsetAsync that zeroes
// the counts, the tile counters and every pass's status words.
//
// Scratch (uint32 words): [0, 1024) global digit counts of up to 4 passes;
// [1024, 1056) tile counters; then num_tiles * 256 status words per pass.
// Status word: flag in the top two bits (0 not ready, 1 aggregate,
// 2 inclusive prefix), count in the low 30, so n < 2^30.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 16;                // keys per thread
constexpr int kTile = kThreads * kItems;  // keys per block and pass
constexpr int kDigitBits = 8;
constexpr int kRadix = 1 << kDigitBits;   // == kThreads: thread d owns digit d
constexpr int kMaxPasses = 4;
constexpr int kCounterWords = 32;
constexpr int kHeadWords = kMaxPasses * kRadix + kCounterWords;
constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kAggregate = 1u << 30;
constexpr uint32_t kInclusive = 2u << 30;
constexpr uint32_t kCountMask = (1u << 30) - 1u;

struct Plan {
  int passes;
  int shift[kMaxPasses];
  int bits[kMaxPasses];
};

__device__ __forceinline__ uint32_t load_relaxed(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_relaxed(uint32_t* p, uint32_t v) {
  asm volatile("st.relaxed.gpu.global.u32 [%0], %1;" :: "l"(p), "r"(v) : "memory");
}

__global__ void __launch_bounds__(kThreads)
radix_histogram(const uint32_t* __restrict__ keys, int n, Plan plan,
                uint32_t* __restrict__ hist) {
  __shared__ uint32_t cnt[kMaxPasses][kRadix];
#pragma unroll
  for (int p = 0; p < kMaxPasses; ++p) cnt[p][threadIdx.x] = 0;
  __syncthreads();
  const int num_tiles = (n + kTile - 1) / kTile;
  for (int tile = blockIdx.x; tile < num_tiles; tile += gridDim.x) {
    // All of a thread's loads of the tile are in flight at once.
    const int64_t base = (int64_t)tile * kTile + threadIdx.x;
    uint32_t key[kItems];
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      key[i] = base + i * kThreads < n ? keys[base + i * kThreads] : 0u;
    }
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      if (base + i * kThreads >= n) break;
#pragma unroll
      for (int p = 0; p < kMaxPasses; ++p) {
        if (p < plan.passes) {
          atomicAdd(&cnt[p][(key[i] >> plan.shift[p]) & ((1u << plan.bits[p]) - 1u)],
                    1u);
        }
      }
    }
  }
  __syncthreads();
  for (int p = 0; p < plan.passes; ++p) {
    const uint32_t c = cnt[p][threadIdx.x];
    if (c) atomicAdd(&hist[p * kRadix + threadIdx.x], c);
  }
}

// kPairsIn: read (key, index) pairs from pairs_in, else keys from keys_in
// with the identity permutation (first pass). kPairsOut: write pairs to
// pairs_out, else keys and indices to keys_out and vals_out (last pass).
template <bool kPairsIn, bool kPairsOut>
__global__ void __launch_bounds__(kThreads)
onesweep_pass(const uint32_t* __restrict__ keys_in, const uint2* __restrict__ pairs_in,
              uint2* __restrict__ pairs_out, uint32_t* __restrict__ keys_out,
              int32_t* __restrict__ vals_out, const uint32_t* __restrict__ hist,
              uint32_t* status, uint32_t* tile_counter, int n, int shift, int bits) {
  __shared__ uint32_t s_keys[kTile];
  __shared__ int32_t s_vals[kTile];
  __shared__ uint32_t s_wcnt[kWarps][kRadix];  // per-warp digit counts
  __shared__ uint32_t s_local[kRadix];         // digit's first slot in s_keys
  __shared__ uint32_t s_global[kRadix];        // output index minus s_keys slot
  __shared__ uint64_t s_wsum[kWarps];
  __shared__ int s_tile;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const uint32_t mask = (1u << bits) - 1u;

  if (tid == 0) s_tile = (int)atomicAdd(tile_counter, 1u);
#pragma unroll
  for (int w = 0; w < kWarps; ++w) s_wcnt[w][tid] = 0;
  __syncthreads();
  const int tile = s_tile;
  const int64_t base = (int64_t)tile * kTile + warp * (kItems * 32) + lane;

  uint32_t key[kItems];
  int32_t val[kItems];
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int64_t idx = base + i * 32;
    if (kPairsIn) {
      const uint2 pr = idx < n ? pairs_in[idx] : make_uint2(0u, 0u);
      key[i] = pr.x;
      val[i] = (int32_t)pr.y;
    } else {
      key[i] = idx < n ? keys_in[idx] : 0u;
      val[i] = (int32_t)idx;
    }
  }

  // Stable rank within the warp, item by item: __match_any_sync finds the
  // lanes of equal digit; the group's lowest lane adds the group to the
  // warp's running count of that digit. A rank is below kItems * 32, so two
  // share a register.
  const unsigned lower = (1u << lane) - 1u;
  uint32_t rank[kItems / 2] = {};
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const bool valid = base + i * 32 < n;
    const uint32_t d = (key[i] >> shift) & mask;
    const unsigned peers = __ballot_sync(kFull, valid) & __match_any_sync(kFull, d);
    const uint32_t before = valid ? s_wcnt[warp][d] : 0u;
    __syncwarp();
    if (valid && (peers & lower) == 0) s_wcnt[warp][d] = before + __popc(peers);
    __syncwarp();
    rank[i / 2] |= (before + __popc(peers & lower)) << (16 * (i % 2));
  }
  __syncthreads();

  // Thread d: the warps' exclusive prefix of digit d, the tile's count of
  // it, published at once for the tiles behind this one.
  uint32_t count = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const uint32_t c = s_wcnt[w][tid];
    s_wcnt[w][tid] = count;
    count += c;
  }
  uint32_t* my_status = status + (int64_t)tile * kRadix + tid;
  store_relaxed(my_status, (tile == 0 ? kInclusive : kAggregate) | count);

  // Exclusive scans over the digits, both at once: the tile's counts (low
  // word: where each digit starts in s_keys) and the pass's global counts
  // (high word: where each digit starts in the output).
  const uint64_t pair = ((uint64_t)hist[tid] << 32) | count;
  uint64_t incl = pair;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint64_t y = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) s_wsum[warp] = incl;

  // Decoupled look-back: add the earlier tiles' counts of digit d until
  // one of them has published its inclusive prefix (tile 0 has).
  uint32_t prefix = 0;
  if (tile > 0) {
    for (int t = tile - 1;; --t) {
      const uint32_t* p = status + (int64_t)t * kRadix + tid;
      uint32_t s;
      do {
        s = load_relaxed(p);
      } while ((s & ~kCountMask) == 0);
      prefix += s & kCountMask;
      if (s & kInclusive) break;
    }
    store_relaxed(my_status, kInclusive | (prefix + count));
  }
  __syncthreads();
  uint64_t excl = incl - pair;
  for (int w = 0; w < warp; ++w) excl += s_wsum[w];
  const uint32_t local = (uint32_t)excl;
  s_local[tid] = local;
  s_global[tid] = (uint32_t)(excl >> 32) + prefix - local;  // mod 2^32
  __syncthreads();

  // Stage in digit order, then write each digit's run out contiguously.
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int64_t idx = base + i * 32;
    if (idx < n) {
      const uint32_t d = (key[i] >> shift) & mask;
      const uint32_t r = (rank[i / 2] >> (16 * (i % 2))) & 0xffffu;
      const uint32_t slot = s_local[d] + s_wcnt[warp][d] + r;
      s_keys[slot] = key[i];
      s_vals[slot] = val[i];
    }
  }
  __syncthreads();
  const int tile_n = min(kTile, n - tile * kTile);
  for (int j = tid; j < tile_n; j += kThreads) {
    const uint32_t k = s_keys[j];
    const uint32_t out = s_global[(k >> shift) & mask] + (uint32_t)j;
    if (kPairsOut) {
      pairs_out[out] = make_uint2(k, (uint32_t)s_vals[j]);
    } else {
      keys_out[out] = k;
      vals_out[out] = s_vals[j];
    }
  }
}

// Four blocks per SM at most: each walks over tiles, so the global atomics
// stay a few per (SM, pass, digit).
int histogram_blocks(int num_tiles) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return num_tiles < 4 * sms ? num_tiles : 4 * sms;
}

}  // namespace

// Sorts n keys (n < 2^30) into keys_out and vals_out by the caller's pass
// plan (kernels/sort.py::sort_plan): `plan` is a host array of 2 * passes
// ints, pass p's shift then its digit width, low digit first; a width is 1
// to 8 bits. Between passes the (key, index) pairs are interleaved, 8
// bytes each, in pairs_tmp (n pairs) and in keys_out/vals_out read as n
// pairs (the 8n bytes from keys_out on, which vals_out must follow), the
// last pass writing pairs_tmp's content out split. scratch holds 1056 +
// passes * num_tiles * 256 words, num_tiles = ceil(n / 4096). keys_in is
// not modified. Returns cudaErrorInvalidValue for a plan it cannot run.
extern "C" int gs_radix_sort(const void* keys_in, void* keys_out, void* vals_out,
                             void* pairs_tmp, void* scratch, int n, int passes,
                             const int* plan_in, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (passes < 1 || passes > kMaxPasses) return (int)cudaErrorInvalidValue;
  Plan plan{};
  plan.passes = passes;
  for (int p = 0; p < passes; ++p) {
    plan.shift[p] = plan_in[2 * p];
    plan.bits[p] = plan_in[2 * p + 1];
    if (plan.bits[p] < 1 || plan.bits[p] > kDigitBits || plan.shift[p] < 0 ||
        plan.shift[p] + plan.bits[p] > 32) {
      return (int)cudaErrorInvalidValue;
    }
  }
  if (n > 0) {
    const int num_tiles = (n + kTile - 1) / kTile;
    const int64_t status_words = (int64_t)num_tiles * kRadix;
    uint32_t* words = (uint32_t*)scratch;
    cudaMemsetAsync(words, 0, (kHeadWords + plan.passes * status_words) * 4, s);
    radix_histogram<<<histogram_blocks(num_tiles), kThreads, 0, s>>>(
        (const uint32_t*)keys_in, n, plan, words);
    const uint32_t* kin = (const uint32_t*)keys_in;
    uint32_t* kout = (uint32_t*)keys_out;
    int32_t* vout = (int32_t*)vals_out;
    const uint2* pin = nullptr;
    for (int p = 0; p < plan.passes; ++p) {
      const uint32_t* hist = words + p * kRadix;
      uint32_t* status = words + kHeadWords + p * status_words;
      uint32_t* counter = words + kMaxPasses * kRadix + p;
      // Counted from the last pass back, passes alternate between pairs_tmp
      // (odd) and the output buffers (even), so the last two differ.
      uint2* pout = (plan.passes - 1 - p) % 2 ? (uint2*)pairs_tmp : (uint2*)keys_out;
      const bool last = p == plan.passes - 1;
      if (p == 0 && last) {
        onesweep_pass<false, false><<<num_tiles, kThreads, 0, s>>>(
            kin, nullptr, nullptr, kout, vout, hist, status, counter, n,
            plan.shift[p], plan.bits[p]);
      } else if (p == 0) {
        onesweep_pass<false, true><<<num_tiles, kThreads, 0, s>>>(
            kin, nullptr, pout, nullptr, nullptr, hist, status, counter, n,
            plan.shift[p], plan.bits[p]);
      } else if (last) {
        onesweep_pass<true, false><<<num_tiles, kThreads, 0, s>>>(
            nullptr, pin, nullptr, kout, vout, hist, status, counter, n,
            plan.shift[p], plan.bits[p]);
      } else {
        onesweep_pass<true, true><<<num_tiles, kThreads, 0, s>>>(
            nullptr, pin, pout, nullptr, nullptr, hist, status, counter, n,
            plan.shift[p], plan.bits[p]);
      }
      pin = pout;
    }
  }
  return (int)cudaGetLastError();
}
