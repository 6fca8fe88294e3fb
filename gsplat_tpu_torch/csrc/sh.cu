// Per-Gaussian view-dependent colour from real spherical harmonics, and its
// gradient: one forward pass and one backward pass over the capacity rows.
//
// Replaces no TPU kernel: the colour is XLA glue in the reference
// (gsplat_tpu/ops/sh.py::sh_to_rgb), which XLA fuses. In eager PyTorch the
// same function (ops/sh.py) is the view direction, sixteen basis columns
// and a stack, then a batched (1 x 15) . (15 x 3) product a row; about 78
// autograd nodes whose backward adds two more batched products and as many
// elementwise passes. These two kernels make one pass each.
//
// Forward, a row r (l_max L, a template constant 0..3):
//   d = (xyz - campos) / (|xyz - campos| + 1e-9)
//   rgb = dc * C0 + 0.5 + sum_{k=1}^{(L+1)^2-1} Y_k(d) * sh[k-1]
// with ops/sh.py's constants and terms, in f32, no clamp.
// Backward, given g = dL/drgb (any row and column stride), recomputing d and
// the basis from xyz and campos:
//   grad_dc = C0 g;  grad_sh[k-1] = Y_k g for k < (L+1)^2, 0 above (whole rows);
//   grad_Y_k = sum_c sh[k-1][c] g_c, through dY/dd to grad_d, then through the
//   normalisation: grad_xyz = grad_d / l - diff (grad_d . diff) / (|diff| l^2),
//   l = |diff| + 1e-9 (zero at L = 0, where the colour does not depend on xyz).
// campos is read from device memory, so a CUDA graph's replay takes the view's
// camera. No atomics: each row is one thread's, the results deterministic.
//
// What bounds it on an H100: bytes. The forward reads xyz, dc and 45 SH floats
// and writes rgb, 216 B a row; the backward reads xyz, sh and g and writes the
// three gradients, 408 B a row: 0.41 and 0.77 ms at 6,291,456 rows at 3.35
// TB/s. A row's 180 B of SH is not a 16-byte multiple, so a block of kRows
// rows (kRows x 180 B is) stages its rows' SH through shared memory with
// coalesced 16-byte loads, and stores grad_sh back the same way; one thread a
// row computes from shared memory (a stride of 45 floats: no bank conflicts).

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 128;        // rows, and threads, a block
constexpr int kShFloats = 45;     // 15 coefficients x 3 channels a row
constexpr int kBlockFloats = kRows * kShFloats;  // a multiple of 4

constexpr float kC0 = 0.28209479177387814f;
constexpr float kC1 = 0.4886025119029199f;
constexpr float kC2_0 = 1.0925484305920792f, kC2_1 = 1.0925484305920792f,
                kC2_2 = 0.31539156525252005f, kC2_3 = 1.0925484305920792f,
                kC2_4 = 0.5462742152960396f;
constexpr float kC3_0 = 0.5900435899266435f, kC3_1 = 2.890611442640554f,
                kC3_2 = 0.4570457994644658f, kC3_3 = 0.3731763325901154f,
                kC3_4 = 0.4570457994644658f, kC3_5 = 1.445305721320277f,
                kC3_6 = 0.5900435899266435f;

// count floats from src (16-byte aligned) into shared dst: float4s, then the tail.
__device__ __forceinline__ void stage_in(float* dst, const float* __restrict__ src, int count) {
  const int n4 = count / 4;
  for (int i = threadIdx.x; i < n4; i += kRows)
    reinterpret_cast<float4*>(dst)[i] = reinterpret_cast<const float4*>(src)[i];
  for (int i = 4 * n4 + threadIdx.x; i < count; i += kRows) dst[i] = src[i];
}

__device__ __forceinline__ void stage_out(float* __restrict__ dst, const float* src, int count) {
  const int n4 = count / 4;
  for (int i = threadIdx.x; i < n4; i += kRows)
    reinterpret_cast<float4*>(dst)[i] = reinterpret_cast<const float4*>(src)[i];
  for (int i = 4 * n4 + threadIdx.x; i < count; i += kRows) dst[i] = src[i];
}

// The view direction of a row: diff, |diff| and d = diff / (|diff| + 1e-9).
struct Dir {
  float dx, dy, dz, r, len, x, y, z;
};

__device__ __forceinline__ Dir view_dir(const float* __restrict__ xyz, long long row,
                                        const float* __restrict__ campos) {
  Dir d;
  d.dx = xyz[3 * row] - campos[0];
  d.dy = xyz[3 * row + 1] - campos[1];
  d.dz = xyz[3 * row + 2] - campos[2];
  d.r = sqrtf(d.dx * d.dx + d.dy * d.dy + d.dz * d.dz);
  d.len = d.r + 1e-9f;
  d.x = d.dx / d.len;
  d.y = d.dy / d.len;
  d.z = d.dz / d.len;
  return d;
}

// The basis Y_1 .. Y_{(L+1)^2-1} (b[0] unused: Y_0 = C0 is dc's), ops/sh.py's terms.
template <int L>
__device__ __forceinline__ void sh_basis(float x, float y, float z, float (&b)[16]) {
  if (L >= 1) {
    b[1] = kC1 * y;
    b[2] = kC1 * z;
    b[3] = kC1 * x;
  }
  if (L >= 2) {
    const float xx = x * x, yy = y * y, zz = z * z;
    b[4] = kC2_0 * x * y;
    b[5] = kC2_1 * y * z;
    b[6] = kC2_2 * (3.0f * zz - 1.0f);
    b[7] = kC2_3 * x * z;
    b[8] = kC2_4 * (xx - yy);
  }
  if (L >= 3) {
    const float xx = x * x, yy = y * y, zz = z * z;
    b[9] = kC3_0 * y * (3.0f * xx - yy);
    b[10] = kC3_1 * x * y * z;
    b[11] = kC3_2 * y * (5.0f * zz - 1.0f);
    b[12] = kC3_3 * z * (5.0f * zz - 3.0f);
    b[13] = kC3_4 * x * (5.0f * zz - 1.0f);
    b[14] = kC3_5 * z * (xx - yy);
    b[15] = kC3_6 * x * (xx - 3.0f * yy);
  }
}

// grad_d = sum_k gb[k] dY_k/dd, for k = 1 .. (L+1)^2 - 1.
template <int L>
__device__ __forceinline__ void basis_vjp(float x, float y, float z, const float (&gb)[16],
                                          float& gx, float& gy, float& gz) {
  gx = gy = gz = 0.0f;
  if (L >= 1) {
    gx += kC1 * gb[3];
    gy += kC1 * gb[1];
    gz += kC1 * gb[2];
  }
  if (L >= 2) {
    gx += kC2_0 * y * gb[4] + kC2_3 * z * gb[7] + 2.0f * kC2_4 * x * gb[8];
    gy += kC2_0 * x * gb[4] + kC2_1 * z * gb[5] - 2.0f * kC2_4 * y * gb[8];
    gz += kC2_1 * y * gb[5] + 6.0f * kC2_2 * z * gb[6] + kC2_3 * x * gb[7];
  }
  if (L >= 3) {
    const float xx = x * x, yy = y * y, zz = z * z;
    gx += 6.0f * kC3_0 * x * y * gb[9] + kC3_1 * y * z * gb[10] +
          kC3_4 * (5.0f * zz - 1.0f) * gb[13] + 2.0f * kC3_5 * x * z * gb[14] +
          3.0f * kC3_6 * (xx - yy) * gb[15];
    gy += 3.0f * kC3_0 * (xx - yy) * gb[9] + kC3_1 * x * z * gb[10] +
          kC3_2 * (5.0f * zz - 1.0f) * gb[11] - 2.0f * kC3_5 * y * z * gb[14] -
          6.0f * kC3_6 * x * y * gb[15];
    gz += kC3_1 * x * y * gb[10] + 10.0f * kC3_2 * y * z * gb[11] +
          kC3_3 * (15.0f * zz - 3.0f) * gb[12] + 10.0f * kC3_4 * x * z * gb[13] +
          kC3_5 * (xx - yy) * gb[14];
  }
}

template <int L>
__global__ void __launch_bounds__(kRows) sh_forward_kernel(
    float* __restrict__ rgb, const float* __restrict__ xyz, const float* __restrict__ dc,
    const float* __restrict__ sh, const float* __restrict__ campos, long long n) {
  constexpr int kK = (L + 1) * (L + 1);
  __shared__ float4 stage4[kBlockFloats / 4];
  float* stage = reinterpret_cast<float*>(stage4);
  const long long row0 = static_cast<long long>(blockIdx.x) * kRows;
  const int rows = static_cast<int>(min(static_cast<long long>(kRows), n - row0));
  if (L > 0) {
    stage_in(stage, sh + row0 * kShFloats, rows * kShFloats);
    __syncthreads();
  }
  if (threadIdx.x >= rows) return;
  const long long r = row0 + threadIdx.x;
  const Dir d = view_dir(xyz, r, campos);
  float b[16];
  sh_basis<L>(d.x, d.y, d.z, b);
  const float* s = stage + threadIdx.x * kShFloats;
  float acc[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int k = 1; k < kK; ++k)
#pragma unroll
    for (int c = 0; c < 3; ++c) acc[c] += b[k] * s[3 * (k - 1) + c];
#pragma unroll
  for (int c = 0; c < 3; ++c) rgb[3 * r + c] = (dc[3 * r + c] * kC0 + 0.5f) + acc[c];
}

template <int L>
__global__ void __launch_bounds__(kRows) sh_backward_kernel(
    float* __restrict__ grad_xyz, float* __restrict__ grad_dc, float* __restrict__ grad_sh,
    const float* __restrict__ g, long long g_row, long long g_col,
    const float* __restrict__ xyz, const float* __restrict__ sh,
    const float* __restrict__ campos, long long n) {
  constexpr int kK = (L + 1) * (L + 1);
  __shared__ float4 stage4[kBlockFloats / 4];
  float* stage = reinterpret_cast<float*>(stage4);
  const long long row0 = static_cast<long long>(blockIdx.x) * kRows;
  const int rows = static_cast<int>(min(static_cast<long long>(kRows), n - row0));
  if (L > 0) {
    stage_in(stage, sh + row0 * kShFloats, rows * kShFloats);
    __syncthreads();
  }
  if (threadIdx.x < rows) {
    const long long r = row0 + threadIdx.x;
    float gc[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      gc[c] = g[r * g_row + c * g_col];
      grad_dc[3 * r + c] = kC0 * gc[c];
    }
    // Each thread reads its own row of SH from the stage, then overwrites it
    // with the row's grad_sh: no other thread touches the row.
    float* s = stage + threadIdx.x * kShFloats;
    if (L > 0) {
      const Dir d = view_dir(xyz, r, campos);
      float b[16], gb[16];
      sh_basis<L>(d.x, d.y, d.z, b);
#pragma unroll
      for (int k = 1; k < kK; ++k) {
        float* sk = s + 3 * (k - 1);
        gb[k] = sk[0] * gc[0] + sk[1] * gc[1] + sk[2] * gc[2];
#pragma unroll
        for (int c = 0; c < 3; ++c) sk[c] = b[k] * gc[c];
      }
      float gx, gy, gz;
      basis_vjp<L>(d.x, d.y, d.z, gb, gx, gy, gz);
      const float dot = gx * d.dx + gy * d.dy + gz * d.dz;
      const float radial = dot / (d.r * d.len * d.len);
      grad_xyz[3 * r] = gx / d.len - d.dx * radial;
      grad_xyz[3 * r + 1] = gy / d.len - d.dy * radial;
      grad_xyz[3 * r + 2] = gz / d.len - d.dz * radial;
    } else {
#pragma unroll
      for (int c = 0; c < 3; ++c) grad_xyz[3 * r + c] = 0.0f;
    }
#pragma unroll
    for (int j = 3 * (kK - 1); j < kShFloats; ++j) s[j] = 0.0f;
  }
  __syncthreads();
  stage_out(grad_sh + row0 * kShFloats, stage, rows * kShFloats);
}

template <int L>
void launch_forward(float* rgb, const float* xyz, const float* dc, const float* sh,
                    const float* campos, long long n, cudaStream_t stream) {
  sh_forward_kernel<L><<<(n + kRows - 1) / kRows, kRows, 0, stream>>>(rgb, xyz, dc, sh, campos,
                                                                       n);
}

template <int L>
void launch_backward(float* grad_xyz, float* grad_dc, float* grad_sh, const float* g,
                     long long g_row, long long g_col, const float* xyz, const float* sh,
                     const float* campos, long long n, cudaStream_t stream) {
  sh_backward_kernel<L><<<(n + kRows - 1) / kRows, kRows, 0, stream>>>(
      grad_xyz, grad_dc, grad_sh, g, g_row, g_col, xyz, sh, campos, n);
}

}  // namespace

// rgb: (n, 3) f32 out; xyz, dc: (n, 3) f32; sh: (n, 15, 3) f32, 16-byte
// aligned; campos: (3,) f32; all contiguous, on the card; l_max 0..3.
extern "C" int gs_sh_forward(void* rgb, const void* xyz, const void* dc, const void* sh,
                             const void* campos, long long n, int l_max, void* stream) {
  if (l_max < 0 || l_max > 3) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    float* o = (float*)rgb;
    const float *x = (const float*)xyz, *d = (const float*)dc, *s = (const float*)sh,
                *c = (const float*)campos;
    cudaStream_t st = (cudaStream_t)stream;
    switch (l_max) {
      case 0: launch_forward<0>(o, x, d, s, c, n, st); break;
      case 1: launch_forward<1>(o, x, d, s, c, n, st); break;
      case 2: launch_forward<2>(o, x, d, s, c, n, st); break;
      default: launch_forward<3>(o, x, d, s, c, n, st); break;
    }
  }
  return (int)cudaGetLastError();
}

// grad_xyz, grad_dc: (n, 3) f32 out; grad_sh: (n, 15, 3) f32 out, 16-byte
// aligned; g: (n, 3) f32 at element strides g_row, g_col; xyz, sh, campos as
// for gs_sh_forward.
extern "C" int gs_sh_backward(void* grad_xyz, void* grad_dc, void* grad_sh, const void* g,
                              long long g_row, long long g_col, const void* xyz, const void* sh,
                              const void* campos, long long n, int l_max, void* stream) {
  if (l_max < 0 || l_max > 3) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    float *gx = (float*)grad_xyz, *gd = (float*)grad_dc, *gs = (float*)grad_sh;
    const float *gg = (const float*)g, *x = (const float*)xyz, *s = (const float*)sh,
                *c = (const float*)campos;
    cudaStream_t st = (cudaStream_t)stream;
    switch (l_max) {
      case 0: launch_backward<0>(gx, gd, gs, gg, g_row, g_col, x, s, c, n, st); break;
      case 1: launch_backward<1>(gx, gd, gs, gg, g_row, g_col, x, s, c, n, st); break;
      case 2: launch_backward<2>(gx, gd, gs, gg, g_row, g_col, x, s, c, n, st); break;
      default: launch_backward<3>(gx, gd, gs, gg, g_row, g_col, x, s, c, n, st); break;
    }
  }
  return (int)cudaGetLastError();
}
