// The stage clock's stamp: one thread reads the card's global nanosecond
// timer into a ring of stamps (utils/profiling.py's stage clock).
//
// Replaces no TPU kernel: the reference times its stages from the host
// (gsplat_tpu/utils/profiling.py). Here a train step or a render runs as
// one CUDA graph, under one cudaGraphLaunch, so no host range can say which
// stage a device operation belongs to. A stamp sits on the stream between
// two stages; the graph captures it, and each replay writes
// times[(slot mod ring) * stamps + stamp] = %globaltimer, in ns, after the
// stream's previous work. The last stamp of a call also advances *slot, a
// device counter, so the next replay writes the next row with no host
// work. The kernel writes only the ring and the slot: nothing the step or
// the render reads.
//
// What bounds it on an H100: its launch, one thread and 8-16 bytes; inside
// a graph a node costs about the graph's launch gap between two kernels.

#include <cuda_runtime.h>

namespace {

__global__ void stage_stamp_kernel(long long* times, long long* slot, int stamp, int stamps,
                                   int ring, int advance) {
  unsigned long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  const long long s = *slot;
  times[(s % ring) * stamps + stamp] = static_cast<long long>(now);
  if (advance) *slot = s + 1;
}

}  // namespace

extern "C" int gs_stage_stamp(void* times, void* slot, int stamp, int stamps, int ring,
                              int advance, void* stream) {
  stage_stamp_kernel<<<1, 1, 0, (cudaStream_t)stream>>>((long long*)times, (long long*)slot,
                                                        stamp, stamps, ring, advance);
  return (int)cudaGetLastError();
}
