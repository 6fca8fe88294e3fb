// The per-Gaussian covariance and its screen conic, and their gradient: one
// forward pass and one backward pass over the capacity rows, for plain 3DGS
// and (kMip) Mip-Splatting.
//
// Replaces no TPU kernel: the maths is XLA glue in the reference
// (gsplat_tpu/ops/projection.py::projection_jacobian, gsplat_tpu/ops/
// covariance.py), which XLA fuses. In eager PyTorch the same functions
// (ops/projection.py::projection_jacobian, ops/covariance.py, and under
// Mip-Splatting ops/mip.py's filtered_sigma and opacity_scale_3d) are some 200
// full-width column ops forward, and their autograd backward.
//
// Forward, a row (xyz_c the camera-space point, q the quaternion, s the
// log-scales, o the opacity logit, f the 3D filter under kMip; W the view's
// rotation, read from device memory so that a CUDA graph's replay takes the
// view's camera):
//   J = the pinhole Jacobian at xyz_c (x/z, y/z clamped to 1.3 tan-fov, 0 where
//       |z| < 1e-6);
//   Sigma = (R(q) diag(e^s)) (R(q) diag(e^s))^T, + f^2 I under kMip;
//   cov = J W Sigma W^T J^T + k I (k 0.3, or the 2D Mip filter's kernel);
//   conic = inv(cov); radius = [r_major r_minor sin cos ell_scale] at the cut
//   radius of the 1/255 isocontour of sigmoid(o), times under kMip the opacity
//   scale sqrt(prod s^2 / prod (s^2 + f^2)) x the 2D factor sqrt(det0 / (det1 +
//   1e-6) + 1e-6) (0 where a determinant sits at its 1e-6 floor).
// Each step is the one IEEE f32 operation its plain torch op makes (the _rn
// intrinsics: no FMA contraction), in the plain ops' order, with the library
// functions torch calls (expf, sqrtf, atan2f, sinf, cosf, logf, log1pf, ceilf)
// and torch's NaN-propagating clamps, so conic, radius and the opacity scale are
// bit-equal to the plain ops' on the card. The quaternion's squared norm is
// torch.sum's order over a row of four (norm_order).
// Backward, given the conic's gradient at any row and column stride and, under
// kMip, the opacity scale's: the forward above recomputed from the inputs (no
// intermediates saved), then the chain rule in autograd's conventions: a clamp
// passes the gradient where its input lies within its bounds, a where routes
// it, the degenerate Jacobian is zero, the 2D factor is zero where a
// determinant sits at its floor, radius carries none and the opacity logit gets
// none. Writes the gradients of xyz_c, q and s; agrees with autograd through the
// plain ops to f32 rounding.
// No atomics: each row is one thread's, the results deterministic.
//
// What bounds it on an H100: bytes, at a few hundred FP32 operations a row. The
// forward reads 44 B a row (48 under kMip) and writes 32 (36); the backward
// reads 52 (60) and writes 40. At 6,291,456 rows that is 0.143 (0.158) ms
// forward and 0.173 (0.188) ms backward at 3.35 TB/s. One thread a row:
// neighbouring threads read and write neighbouring rows, so a warp's accesses
// fill the sectors it touches. The backward's recomputation wants 80-96
// registers; kBackwardMinBlocks caps it at 64 so that more rows are in flight
// (a few bytes spill: 56-63 % of the floor at 6,291,456 rows, against 43-58 %
// uncapped).

#include <cmath>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
// Blocks of the backward an SM must hold at once: caps its registers.
constexpr int kBackwardMinBlocks = 4;

// The statics' constants as the plain ops' f32 scalars.
struct Consts {
  float fx, fy, limx, limy;  // focal lengths; 1.3 tan-fov
  float mh_dist;             // the cut radius' cap, in sigmas
  float kernel;              // the screen dilation: 0.3, or the 2D Mip filter's
  float log255;              // ln 255
};

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }
// torch.reciprocal; a Python number over a tensor is its reciprocal times the number.
__device__ __forceinline__ float rcp(float a) { return __fdiv_rn(1.0f, a); }
// torch.clamp on the card: NaN stays NaN.
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}
__device__ __forceinline__ float clamp_max(float v, float hi) {
  return isnan(v) ? v : fminf(v, hi);
}
__device__ __forceinline__ float clamp(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}

// torch.sum(q * q, dim=1) over a row of four: the reduction splits the row
// over four lanes and folds them with shuffles at offsets 2, then 1.
__device__ __forceinline__ float norm_order(float a, float b, float c, float d) {
  return add(add(a, c), add(b, d));
}

// The forward's values, in the plain ops' order, that both passes read.
struct Geometry {
  bool degenerate;                   // |z| < 1e-6: J is zero
  float x, y, zs, tx, ty, txc, tyc;  // ops/projection.py::projection_jacobian
  float rz, j00, j02, j11, j12;      // J's four entries (0 where degenerate)
  float q[4], norm, inv;             // the raw quaternion, |q|, 1 / (|q| + 1e-6)
  float n[4];                        // the normalised quaternion (w, x, y, z)
  float r[9], e[3], m[9];            // R, e^s, M = R diag(e^s)
  float s[3], f2;                    // the log-scales; f^2 under kMip
  float sig[6];                      // Sigma [xx xy xz yy yz zz] (+ f^2 I)
  float m0[3], m1[3];                // the rows of J W
  float c00, c01, c11;               // J W Sigma W^T J^T
  float cov00, cov11, inv_det;       // the dilated diagonal, 1 / det
};

template <bool kMip>
__device__ __forceinline__ void geometry(Geometry& g, long long row,
                                         const float* __restrict__ xyz_c,
                                         const float* __restrict__ quat,
                                         const float* __restrict__ scale,
                                         const float* __restrict__ filter_3d,
                                         const float* __restrict__ view, const Consts& k) {
  // ops/projection.py::projection_jacobian
  g.x = xyz_c[3 * row];
  g.y = xyz_c[3 * row + 1];
  const float z = xyz_c[3 * row + 2];
  g.degenerate = fabsf(z) < 1e-6f;
  g.zs = g.degenerate ? (z < 0.0f ? -1e-6f : 1e-6f) : z;
  g.tx = dvd(g.x, g.zs);
  g.ty = dvd(g.y, g.zs);
  g.txc = clamp(g.tx, -k.limx, k.limx);
  g.tyc = clamp(g.ty, -k.limy, k.limy);
  const float xc = mul(g.txc, g.zs), yc = mul(g.tyc, g.zs), zz = mul(g.zs, g.zs);
  g.rz = rcp(g.zs);
  g.j00 = g.degenerate ? 0.0f : mul(g.rz, k.fx);
  g.j02 = g.degenerate ? 0.0f : dvd(-mul(k.fx, xc), zz);
  g.j11 = g.degenerate ? 0.0f : mul(g.rz, k.fy);
  g.j12 = g.degenerate ? 0.0f : dvd(-mul(k.fy, yc), zz);

  // ops/covariance.py::sigma_from_quat_scale
#pragma unroll
  for (int i = 0; i < 4; ++i) g.q[i] = quat[4 * row + i];
  g.norm = sqrtf(norm_order(mul(g.q[0], g.q[0]), mul(g.q[1], g.q[1]), mul(g.q[2], g.q[2]),
                            mul(g.q[3], g.q[3])));
  g.inv = rcp(add(g.norm, 1e-6f));
#pragma unroll
  for (int i = 0; i < 4; ++i) g.n[i] = mul(g.q[i], g.inv);
  const float w = g.n[0], x = g.n[1], y = g.n[2], zq = g.n[3];
  const float x2 = mul(x, x), y2 = mul(y, y), z2 = mul(zq, zq);
  const float xy = mul(x, y), xz = mul(x, zq), yz = mul(y, zq);
  const float wx = mul(w, x), wy = mul(w, y), wz = mul(w, zq);
  g.r[0] = sub(1.0f, mul(2.0f, add(y2, z2)));
  g.r[1] = mul(2.0f, sub(xy, wz));
  g.r[2] = mul(2.0f, add(xz, wy));
  g.r[3] = mul(2.0f, add(xy, wz));
  g.r[4] = sub(1.0f, mul(2.0f, add(x2, z2)));
  g.r[5] = mul(2.0f, sub(yz, wx));
  g.r[6] = mul(2.0f, sub(xz, wy));
  g.r[7] = mul(2.0f, add(yz, wx));
  g.r[8] = sub(1.0f, mul(2.0f, add(x2, y2)));
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    g.s[j] = scale[3 * row + j];
    g.e[j] = expf(g.s[j]);
  }
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) g.m[3 * i + j] = mul(g.r[3 * i + j], g.e[j]);
  const float* m = g.m;
  auto dot = [](const float* a, const float* b) {
    return add(add(mul(a[0], b[0]), mul(a[1], b[1])), mul(a[2], b[2]));
  };
  g.sig[0] = dot(m, m);
  g.sig[1] = dot(m, m + 3);
  g.sig[2] = dot(m, m + 6);
  g.sig[3] = dot(m + 3, m + 3);
  g.sig[4] = dot(m + 3, m + 6);
  g.sig[5] = dot(m + 6, m + 6);

  if (kMip) {  // ops/mip.py::filtered_sigma
    const float f = filter_3d[row];
    g.f2 = mul(f, f);
    g.sig[0] = add(g.sig[0], g.f2);
    g.sig[3] = add(g.sig[3], g.f2);
    g.sig[5] = add(g.sig[5], g.f2);
  }

  // ops/covariance.py::_screen_cov
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    g.m0[c] = add(mul(g.j00, view[c]), mul(g.j02, view[8 + c]));
    g.m1[c] = add(mul(g.j11, view[4 + c]), mul(g.j12, view[8 + c]));
  }
  const float sxx = g.sig[0], sxy = g.sig[1], sxz = g.sig[2], syy = g.sig[3],
              syz = g.sig[4], szz = g.sig[5];
  auto sig_row = [&](const float* v, float* out) {
    out[0] = add(add(mul(sxx, v[0]), mul(sxy, v[1])), mul(sxz, v[2]));
    out[1] = add(add(mul(sxy, v[0]), mul(syy, v[1])), mul(syz, v[2]));
    out[2] = add(add(mul(sxz, v[0]), mul(syz, v[1])), mul(szz, v[2]));
  };
  float sm0[3], sm1[3];
  sig_row(g.m0, sm0);
  sig_row(g.m1, sm1);
  g.c00 = dot(g.m0, sm0);
  g.c01 = dot(g.m0, sm1);
  g.c11 = dot(g.m1, sm1);

  // ops/covariance.py::_conic_radius's conic
  g.cov00 = add(g.c00, k.kernel);
  g.cov11 = add(g.c11, k.kernel);
  g.inv_det = rcp(sub(mul(g.cov00, g.cov11), mul(g.c01, g.c01)));
}

template <bool kMip>
__global__ void __launch_bounds__(kThreads) covariance_forward_kernel(
    float* __restrict__ conic, float* __restrict__ radius, float* __restrict__ opacity_scale,
    const float* __restrict__ xyz_c, const float* __restrict__ quat,
    const float* __restrict__ scale, const float* __restrict__ opacity,
    const float* __restrict__ filter_3d, const float* __restrict__ view, Consts k, long long n) {
  const long long row = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (row >= n) return;
  Geometry g;
  geometry<kMip>(g, row, xyz_c, quat, scale, filter_3d, view, k);
  const float cov01 = g.c01;

  // The cut radius in sigmas: the 1/255 isocontour of the (filtered) opacity.
  // softplus = logaddexp(-o, 0) as torch computes it.
  const float a = -opacity[row];
  const float softplus = add(fmaxf(a, 0.0f), log1pf(expf(-fabsf(a))));
  float log_opacity_255 = sub(k.log255, softplus);
  if (kMip) {  // ops/covariance.py::mip_conic_and_radius
    const float det0 = clamp_min(sub(mul(g.c00, g.c11), mul(cov01, cov01)), 1e-6f);
    const float det1 = clamp_min(sub(mul(g.cov00, g.cov11), mul(cov01, cov01)), 1e-6f);
    float coef = sqrtf(add(dvd(det0, add(det1, 1e-6f)), 1e-6f));
    if (det0 <= 1e-6f || det1 <= 1e-6f) coef = 0.0f;
    float s2[3], s2f[3];  // ops/mip.py::opacity_scale_3d
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      s2[j] = expf(mul(2.0f, g.s[j]));
      s2f[j] = add(s2[j], g.f2);
    }
    const float os3 = sqrtf(dvd(mul(mul(s2[0], s2[1]), s2[2]), mul(mul(s2f[0], s2f[1]), s2f[2])));
    const float os = mul(os3, coef);
    opacity_scale[row] = os;
    log_opacity_255 = add(log_opacity_255, logf(os));
  }
  const float r_cut = sqrtf(clamp_min(mul(2.0f, log_opacity_255), 0.0f));

  // ops/covariance.py::_conic_radius
  const float det = sub(mul(g.cov00, g.cov11), mul(cov01, cov01));
  conic[3 * row] = mul(g.cov11, g.inv_det);
  conic[3 * row + 1] = mul(-cov01, g.inv_det);
  conic[3 * row + 2] = mul(g.cov00, g.inv_det);
  const float mid = mul(0.5f, add(g.cov00, g.cov11));
  const float lam_term = sqrtf(clamp_min(sub(mul(mid, mid), det), 0.1f));
  const float lam1 = add(mid, lam_term), lam2 = sub(mid, lam_term);
  const float cut = clamp_max(r_cut, k.mh_dist);
  const float theta = mul(0.5f, atan2f(mul(2.0f, cov01), sub(g.cov00, g.cov11)));
  const float kappa = dvd(lam1, clamp_min(lam2, 1e-12f));
  const float r_pad = sqrtf(add(mul(mul(r_cut, r_cut), add(1.0f, mul(kappa, 0.0078125f))), 0.1f));
  float* rad = radius + 5 * row;
  rad[0] = ceilf(mul(cut, sqrtf(clamp_min(lam1, 0.0f))));
  rad[1] = ceilf(mul(cut, sqrtf(clamp_min(lam2, 0.0f))));
  rad[2] = sinf(theta);
  rad[3] = cosf(theta);
  rad[4] = clamp_max(dvd(r_pad, clamp_min(cut, 1e-6f)), 2.0f);
}

template <bool kMip>
__global__ void __launch_bounds__(kThreads, kBackwardMinBlocks) covariance_backward_kernel(
    float* __restrict__ grad_xyz_c, float* __restrict__ grad_quat, float* __restrict__ grad_scale,
    const float* __restrict__ g_conic, long long g_row, long long g_col,
    const float* __restrict__ g_opacity_scale, const float* __restrict__ xyz_c,
    const float* __restrict__ quat, const float* __restrict__ scale,
    const float* __restrict__ filter_3d, const float* __restrict__ view, Consts k, long long n) {
  const long long row = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (row >= n) return;
  Geometry g;
  geometry<kMip>(g, row, xyz_c, quat, scale, filter_3d, view, k);
  const float c01 = g.c01;

  // The conic [cov11 -cov01 cov00] / det.
  const float ga = g_conic[row * g_row], gb = g_conic[row * g_row + g_col],
              gc = g_conic[row * g_row + 2 * g_col];
  const float g_inv_det = ga * g.cov11 - gb * c01 + gc * g.cov00;
  const float g_det = -g_inv_det * (g.inv_det * g.inv_det);
  float g_cov00 = gc * g.inv_det + g_det * g.cov11;
  float g_cov11 = ga * g.inv_det + g_det * g.cov00;
  float g_c01 = -gb * g.inv_det - 2.0f * g_det * c01;
  float g_c00 = 0.0f, g_c11 = 0.0f;
  float g_s3[3] = {0.0f, 0.0f, 0.0f};  // the 3D factor's part of dL/ds
  if (kMip) {  // the opacity scale os3 x coef
    const float raw0 = sub(mul(g.c00, g.c11), mul(c01, c01));
    const float raw1 = sub(mul(g.cov00, g.cov11), mul(c01, c01));
    const float det0 = clamp_min(raw0, 1e-6f), det1 = clamp_min(raw1, 1e-6f);
    const float inv_d1e = 1.0f / (det1 + 1e-6f), ratio = det0 * inv_d1e;
    const float coef_raw = sqrtf(ratio + 1e-6f);
    const bool at_floor = det0 <= 1e-6f || det1 <= 1e-6f;
    // os3 = sqrt(prod_j t_j), t_j = s2_j / (s2_j + f^2) with s2 = e^2s; its
    // derivative in s_j is os3 (1 - t_j) = os3 f^2 / (s2_j + f^2).
    float t[3], u[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float s2 = g.e[j] * g.e[j], inv = 1.0f / (s2 + g.f2);
      t[j] = s2 * inv;
      u[j] = g.f2 * inv;
    }
    const float os3 = sqrtf(t[0] * t[1] * t[2]);
    const float g_os = g_opacity_scale[row];
    const float g_u = at_floor ? 0.0f : g_os * os3 * 0.5f / coef_raw;
    const float g_raw0 = raw0 >= 1e-6f ? g_u * inv_d1e : 0.0f;
    const float g_raw1 = raw1 >= 1e-6f ? -g_u * ratio * inv_d1e : 0.0f;
    g_c00 += g_raw0 * g.c11;
    g_c11 += g_raw0 * g.c00;
    g_c01 -= 2.0f * c01 * (g_raw0 + g_raw1);
    g_cov00 += g_raw1 * g.cov11;
    g_cov11 += g_raw1 * g.cov00;
    const float g_os3 = at_floor ? 0.0f : g_os * coef_raw;
#pragma unroll
    for (int j = 0; j < 3; ++j) g_s3[j] = g_os3 * os3 * u[j];
  }
  g_c00 += g_cov00;
  g_c11 += g_cov11;

  // cov = m0 Sigma m0, m0 Sigma m1, m1 Sigma m1.
  const float* sg = g.sig;
  const float sm[9] = {sg[0], sg[1], sg[2], sg[1], sg[3], sg[4], sg[2], sg[4], sg[5]};
  float sm0[3], sm1[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    sm0[i] = sm[3 * i] * g.m0[0] + sm[3 * i + 1] * g.m0[1] + sm[3 * i + 2] * g.m0[2];
    sm1[i] = sm[3 * i] * g.m1[0] + sm[3 * i + 1] * g.m1[1] + sm[3 * i + 2] * g.m1[2];
  }
  float g_m0[3], g_m1[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    g_m0[i] = 2.0f * g_c00 * sm0[i] + g_c01 * sm1[i];
    g_m1[i] = 2.0f * g_c11 * sm1[i] + g_c01 * sm0[i];
  }
  // d/dSigma: G = g00 m0 m0^T + g01 m0 m1^T + g11 m1 m1^T; an off-diagonal entry
  // of Sigma stands at (i, j) and (j, i).
  float gm[9];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      gm[3 * i + j] = g_c00 * g.m0[i] * g.m0[j] + g_c01 * g.m0[i] * g.m1[j] +
                      g_c11 * g.m1[i] * g.m1[j];
  // S: the gradient of Sigma = M M^T as a symmetric matrix, 2 G_ii on the
  // diagonal and G_ij + G_ji off it; then dL/dM = S M.
  const float s00 = 2.0f * gm[0], s11 = 2.0f * gm[4], s22 = 2.0f * gm[8];
  const float s01 = gm[1] + gm[3], s02 = gm[2] + gm[6], s12 = gm[5] + gm[7];
  const float ss[9] = {s00, s01, s02, s01, s11, s12, s02, s12, s22};
  float g_r[9], g_e[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float gmij = ss[3 * i] * g.m[j] + ss[3 * i + 1] * g.m[3 + j] +
                         ss[3 * i + 2] * g.m[6 + j];
      g_r[3 * i + j] = gmij * g.e[j];
      g_e[j] += gmij * g.r[3 * i + j];
    }
#pragma unroll
  for (int j = 0; j < 3; ++j)
    grad_scale[3 * row + j] = g_e[j] * g.e[j] + g_s3[j];

  // R of the normalised quaternion (w, x, y, z).
  const float w = g.n[0], x = g.n[1], y = g.n[2], z = g.n[3];
  float gn[4];
  gn[0] = 2.0f * (z * (g_r[3] - g_r[1]) + y * (g_r[2] - g_r[6]) + x * (g_r[7] - g_r[5]));
  gn[1] = 2.0f * (y * (g_r[1] + g_r[3]) + z * (g_r[2] + g_r[6]) + w * (g_r[7] - g_r[5])) -
          4.0f * x * (g_r[4] + g_r[8]);
  gn[2] = 2.0f * (x * (g_r[1] + g_r[3]) + w * (g_r[2] - g_r[6]) + z * (g_r[5] + g_r[7])) -
          4.0f * y * (g_r[0] + g_r[8]);
  gn[3] = 2.0f * (w * (g_r[3] - g_r[1]) + x * (g_r[2] + g_r[6]) + y * (g_r[5] + g_r[7])) -
          4.0f * z * (g_r[0] + g_r[4]);
  // n = q / (|q| + 1e-6)
  const float g_inv = gn[0] * g.q[0] + gn[1] * g.q[1] + gn[2] * g.q[2] + gn[3] * g.q[3];
  const float g_norm = -g_inv * (g.inv * g.inv);
  const float g_sq = 0.5f * g_norm / g.norm;
#pragma unroll
  for (int i = 0; i < 4; ++i) grad_quat[4 * row + i] = gn[i] * g.inv + 2.0f * g_sq * g.q[i];

  // J: m0 = j00 W_0 + j02 W_2, m1 = j11 W_1 + j12 W_2.
  float* gx = grad_xyz_c + 3 * row;
  if (g.degenerate) {
    gx[0] = gx[1] = gx[2] = 0.0f;
    return;
  }
  float g_j00 = 0.0f, g_j02 = 0.0f, g_j11 = 0.0f, g_j12 = 0.0f;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    g_j00 += g_m0[c] * view[c];
    g_j02 += g_m0[c] * view[8 + c];
    g_j11 += g_m1[c] * view[4 + c];
    g_j12 += g_m1[c] * view[8 + c];
  }
  // j00 = fx / z, j02 = -(fx xc) / z^2 with xc = clamp(x / z) z; the same in y.
  const float rz = g.rz, rz2 = rz * rz;
  float g_z = -(g_j00 * k.fx + g_j11 * k.fy) * rz2 - 2.0f * (g_j02 * g.j02 + g_j12 * g.j12) * rz;
  const float g_xc = -g_j02 * k.fx * rz2, g_yc = -g_j12 * k.fy * rz2;
  g_z += g_xc * g.txc + g_yc * g.tyc;
  const float g_tx = (g.tx >= -k.limx && g.tx <= k.limx) ? g_xc * g.zs : 0.0f;
  const float g_ty = (g.ty >= -k.limy && g.ty <= k.limy) ? g_yc * g.zs : 0.0f;
  gx[0] = g_tx * rz;
  gx[1] = g_ty * rz;
  gx[2] = g_z - (g_tx * g.tx + g_ty * g.ty) * rz;
}

template <bool kMip>
void launch_forward(float* conic, float* radius, float* opacity_scale, const float* xyz_c,
                    const float* quat, const float* scale, const float* opacity,
                    const float* filter_3d, const float* view, const Consts& k, long long n,
                    cudaStream_t stream) {
  covariance_forward_kernel<kMip><<<(n + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      conic, radius, opacity_scale, xyz_c, quat, scale, opacity, filter_3d, view, k, n);
}

template <bool kMip>
void launch_backward(float* grad_xyz_c, float* grad_quat, float* grad_scale,
                     const float* g_conic, long long g_row, long long g_col,
                     const float* g_opacity_scale, const float* xyz_c, const float* quat,
                     const float* scale, const float* filter_3d, const float* view,
                     const Consts& k, long long n, cudaStream_t stream) {
  covariance_backward_kernel<kMip><<<(n + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      grad_xyz_c, grad_quat, grad_scale, g_conic, g_row, g_col, g_opacity_scale, xyz_c, quat,
      scale, filter_3d, view, k, n);
}

}  // namespace

// conic: (n, 3), radius: (n, 5) f32 out; opacity_scale: (n,) f32 out, or null
// for plain 3DGS; xyz_c, scale: (n, 3); quat: (n, 4); opacity: (n,); filter_3d:
// (n,) under Mip-Splatting (mip != 0), else null; view: the (4, 4) view matrix,
// row-major; all f32, contiguous, on the card. fx, fy, limx, limy, mh_dist,
// kernel and log255 as Consts.
extern "C" int gs_covariance_forward(void* conic, void* radius, void* opacity_scale,
                                     const void* xyz_c, const void* quat, const void* scale,
                                     const void* opacity, const void* filter_3d,
                                     const void* view, long long n, int mip, float fx, float fy,
                                     float limx, float limy, float mh_dist, float kernel,
                                     float log255, void* stream) {
  if (mip && (opacity_scale == nullptr || filter_3d == nullptr)) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const Consts k{fx, fy, limx, limy, mh_dist, kernel, log255};
    const float* xyz = (const float*)xyz_c;
    if (mip)
      launch_forward<true>((float*)conic, (float*)radius, (float*)opacity_scale, xyz,
                           (const float*)quat, (const float*)scale, (const float*)opacity,
                           (const float*)filter_3d, (const float*)view, k, n,
                           (cudaStream_t)stream);
    else
      launch_forward<false>((float*)conic, (float*)radius, nullptr, xyz, (const float*)quat,
                            (const float*)scale, (const float*)opacity, nullptr,
                            (const float*)view, k, n, (cudaStream_t)stream);
  }
  return (int)cudaGetLastError();
}

// grad_xyz_c, grad_scale: (n, 3); grad_quat: (n, 4) f32 out; g_conic: (n, 3) f32
// at element strides g_row, g_col; g_opacity_scale: (n,) f32 under Mip-Splatting,
// else null; the rest as for gs_covariance_forward.
extern "C" int gs_covariance_backward(void* grad_xyz_c, void* grad_quat, void* grad_scale,
                                      const void* g_conic, long long g_row, long long g_col,
                                      const void* g_opacity_scale, const void* xyz_c,
                                      const void* quat, const void* scale,
                                      const void* filter_3d, const void* view, long long n,
                                      int mip, float fx, float fy, float limx, float limy,
                                      float mh_dist, float kernel, float log255, void* stream) {
  if (mip && (g_opacity_scale == nullptr || filter_3d == nullptr))
    return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const Consts k{fx, fy, limx, limy, mh_dist, kernel, log255};
    if (mip)
      launch_backward<true>((float*)grad_xyz_c, (float*)grad_quat, (float*)grad_scale,
                            (const float*)g_conic, g_row, g_col, (const float*)g_opacity_scale,
                            (const float*)xyz_c, (const float*)quat, (const float*)scale,
                            (const float*)filter_3d, (const float*)view, k, n,
                            (cudaStream_t)stream);
    else
      launch_backward<false>((float*)grad_xyz_c, (float*)grad_quat, (float*)grad_scale,
                             (const float*)g_conic, g_row, g_col, nullptr, (const float*)xyz_c,
                             (const float*)quat, (const float*)scale, nullptr,
                             (const float*)view, k, n, (cudaStream_t)stream);
  }
  return (int)cudaGetLastError();
}
