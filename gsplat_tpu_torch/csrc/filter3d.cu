// Mip-Splatting's 3D smoothing filter (ops/mip.py): the sweep over the
// training cameras that finds each Gaussian's nearest seeing camera, and the
// filter made from it, in two kernels and one memset.
//
// Replaces no TPU kernel: the reference has no Mip-Splatting. The published
// code (compute_3D_filter) loops over the cameras in PyTorch, some fifteen
// full-width passes a camera.
//
// nearest_depth_kernel: a thread holds kRowsPerThread rows (xyz) in
// registers; a block stages the camera table through shared memory, kChunk
// cameras at a time, and every thread walks them (a broadcast read), each
// camera's constants serving the thread's rows. A camera's row of the table
// (ops/mip.py::camera_table, kCols floats): R row-major, t, f_x, f_y, and the
// screen's bounds over the focal length x_lo, x_hi, y_lo, y_hi. For each:
//   x_c = ((r0 x + r1 y) + r2 z) + t0, and the same for y_c, z_c;
//   seen = z_c > 0.2 & x_c >= x_lo z_c & x_c <= x_hi z_c
//          & y_c >= y_lo z_c & y_c <= y_hi z_c;
//   best = seen ? min(best, z_c) : best.
// A dead row, and a row no camera sees, gets +inf. The block's largest
// finite depth goes to *far by an atomicMax on its bits (non-negative floats
// order as their bits; *far starts at 0, the memset).
// filter3d_finish_kernel, in place: f = (finite ? d : *far) / max f_x *
// sqrt_var on alive rows, 0 on dead rows (each block reduces the table's f_x
// column itself).
// Each step is one IEEE round-to-nearest f32 operation (the _rn intrinsics:
// no FMA contraction) in nearest_depth_plain's and filter_3d_plain's order,
// so the results are bit-equal to the plain versions'.
//
// What bounds it on an H100: operations. A test is 29 FP32 operations as
// gsbench counts them (the transform's 9 multiplies and 9 adds, the depth
// test, the four bounds' products and tests, the minimum and the select);
// 1M rows x 161 cameras is 4.7 GFLOP, 0.070 ms at 67 TFLOP/s, a peak that
// counts an FMA as two: with no FMA the issue rate caps the kernel near half
// of it. The bytes are 17 a row (xyz, the alive byte, the depth) and 9 more
// for the finish: 0.008 ms at 2^20 rows.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kRowsPerThread = 4;
constexpr int kCols = 18;
constexpr int kChunk = 512;  // cameras a block stages at a time (36 KB)
constexpr float kDepthFloor = 0.2f;

__device__ __forceinline__ float dot3(const float* r, float t, float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(r[0], x), __fmul_rn(r[1], y)),
                             __fmul_rn(r[2], z)),
                   t);
}

__global__ void __launch_bounds__(kThreads) nearest_depth_kernel(
    float* __restrict__ depth, int* __restrict__ far, const float* __restrict__ xyz,
    const uint8_t* __restrict__ alive, const float* __restrict__ cams, long long n, int count) {
  __shared__ float s_cams[kChunk * kCols];
  const long long base = static_cast<long long>(blockIdx.x) * kThreads * kRowsPerThread +
                         threadIdx.x;
  float x[kRowsPerThread], y[kRowsPerThread], z[kRowsPerThread], best[kRowsPerThread];
  bool live[kRowsPerThread];
  bool any = false;
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j) {
    const long long g = base + static_cast<long long>(j) * kThreads;
    live[j] = g < n && alive[g] != 0;
    x[j] = live[j] ? xyz[3 * g] : 0.0f;
    y[j] = live[j] ? xyz[3 * g + 1] : 0.0f;
    z[j] = live[j] ? xyz[3 * g + 2] : 0.0f;
    best[j] = INFINITY;
    any |= live[j];
  }
  if (__syncthreads_or(any)) {  // a block of dead rows walks no camera
    for (int c0 = 0; c0 < count; c0 += kChunk) {
      const int cams_here = count - c0 < kChunk ? count - c0 : kChunk;
      __syncthreads();
      for (int i = threadIdx.x; i < cams_here * kCols; i += kThreads)
        s_cams[i] = cams[static_cast<long long>(c0) * kCols + i];
      __syncthreads();
#pragma unroll 2
      for (int c = 0; c < cams_here; ++c) {
        const float* k = s_cams + c * kCols;
        const float r[9] = {k[0], k[1], k[2], k[3], k[4], k[5], k[6], k[7], k[8]};
        const float t0 = k[9], t1 = k[10], t2 = k[11];
        const float x_lo = k[14], x_hi = k[15], y_lo = k[16], y_hi = k[17];
#pragma unroll
        for (int j = 0; j < kRowsPerThread; ++j) {
          const float xc = dot3(r, t0, x[j], y[j], z[j]);
          const float yc = dot3(r + 3, t1, x[j], y[j], z[j]);
          const float zc = dot3(r + 6, t2, x[j], y[j], z[j]);
          const bool seen = (zc > kDepthFloor) & (xc >= __fmul_rn(x_lo, zc)) &
                            (xc <= __fmul_rn(x_hi, zc)) & (yc >= __fmul_rn(y_lo, zc)) &
                            (yc <= __fmul_rn(y_hi, zc));
          best[j] = seen ? fminf(best[j], zc) : best[j];
        }
      }
    }
  }
  float top = 0.0f;
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j) {
    const long long g = base + static_cast<long long>(j) * kThreads;
    if (g < n) depth[g] = best[j];
    if (best[j] < INFINITY) top = fmaxf(top, best[j]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) top = fmaxf(top, __shfl_xor_sync(0xffffffffu, top, off));
  if ((threadIdx.x & 31) == 0 && top > 0.0f) atomicMax(far, __float_as_int(top));
}

__global__ void __launch_bounds__(kThreads) filter3d_finish_kernel(
    float* __restrict__ out, const int* __restrict__ far, const uint8_t* __restrict__ alive,
    const float* __restrict__ cams, long long n, int count, float sqrt_var) {
  __shared__ float s_fmax;
  if (threadIdx.x < 32) {
    float f = 0.0f;  // the table's largest f_x (count >= 1)
    for (int c = threadIdx.x; c < count; c += 32) f = fmaxf(f, cams[static_cast<long long>(c) * kCols + 12]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) f = fmaxf(f, __shfl_xor_sync(0xffffffffu, f, off));
    if (threadIdx.x == 0) s_fmax = f;
  }
  __syncthreads();
  const float fmax_x = s_fmax, d_far = __int_as_float(*far);
  for (long long g = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; g < n;
       g += static_cast<long long>(gridDim.x) * kThreads) {
    const float d = out[g] < INFINITY ? out[g] : d_far;
    out[g] = alive[g] ? __fmul_rn(__fdiv_rn(d, fmax_x), sqrt_var) : 0.0f;
  }
}

int depth_blocks(long long n) {
  const long long rows = static_cast<long long>(kThreads) * kRowsPerThread;
  return static_cast<int>((n + rows - 1) / rows);
}

}  // namespace

// depth: (n,) f32 out; far: one int32 scratch; xyz: (n, 3) f32; alive: (n,)
// bool; cameras: (cams, kCols) f32 on the device.
extern "C" int gs_nearest_depth(void* depth, void* far, const void* xyz, const void* alive,
                                const void* cameras, long long n, int cams, void* stream) {
  if (cams < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const cudaError_t err = cudaMemsetAsync(far, 0, sizeof(int), st);
  if (err != cudaSuccess) return (int)err;
  if (n > 0)
    nearest_depth_kernel<<<depth_blocks(n), kThreads, 0, st>>>(
        (float*)depth, (int*)far, (const float*)xyz, (const uint8_t*)alive,
        (const float*)cameras, n, cams);
  return (int)cudaGetLastError();
}

// out: (n,) f32, the filter written in place; the rest as gs_nearest_depth;
// cams >= 1.
extern "C" int gs_filter_3d(void* out, void* far, const void* xyz, const void* alive,
                            const void* cameras, long long n, int cams, float sqrt_var,
                            void* stream) {
  if (cams < 1) return (int)cudaErrorInvalidValue;
  const int err = gs_nearest_depth(out, far, xyz, alive, cameras, n, cams, stream);
  if (err != 0 || n == 0) return err;
  const long long blocks = (n + kThreads - 1) / kThreads;
  filter3d_finish_kernel<<<static_cast<int>(blocks < 4096 ? blocks : 4096), kThreads, 0,
                           (cudaStream_t)stream>>>((float*)out, (const int*)far,
                                                   (const uint8_t*)alive,
                                                   (const float*)cameras, n, cams, sqrt_var);
  return (int)cudaGetLastError();
}
