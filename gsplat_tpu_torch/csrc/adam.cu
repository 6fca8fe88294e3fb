// Visibility-masked Adam, in place: one parameter group's step.
//
// Replaces no TPU kernel: the reference's update (gsplat_tpu/ops/adam.py,
// gsplat_tpu/train/step.py::apply_adam) is XLA glue, which XLA fuses into
// one pass a group. In eager PyTorch the same formula
// (ops/adam.py::masked_adam_update) is some fifteen elementwise kernels a
// group, each a full f32 pass with a new tensor, and three copies back into
// the state: about 54 passes of 4 bytes an element a step. This kernel makes
// one pass: it reads each stepped element's param, grad and moments once and
// writes param and moments back in place.
//
// The group is one flat f32 array of n x d elements (row r holds Gaussian
// r's d values: xyz 3, rgb 3, opacity 1, scale 3, quat 4, sh 45), and
// mask[r] (one byte) says whether row r steps. A thread takes four
// neighbouring elements, one 16-byte load of each array (the arrays are
// 16-byte aligned; a scalar tail for n x d not a multiple of 4); an
// element's row is its index / d, d a template constant for the widths
// above. A thread whose four elements all lie in rows that do not step
// reads only their mask bytes and writes nothing, so a warp over dead or
// invisible rows makes no other traffic. A thread with some live elements
// stores all four back, the others unchanged.
//
// The arithmetic is masked_adam_update's, operation for operation in its
// order, each an IEEE round-to-nearest f32 operation (the _rn intrinsics:
// no FMA contraction), as PyTorch's elementwise kernels evaluate it on the
// card: NaN -> 0; m' = B1 m + (1 - B1) g; v' = B2 v + ((1 - B2) g) g;
// m^ = m' / bias1, v^ = v' / bias2 (true divisions: bias1 and bias2 are
// device tensors, as are torch's divisors there); step = (-lr m^) /
// (sqrt(v^) + EPS); p' = p + step. The constants are the f32 roundings of
// the Python doubles torch's scalar path rounds (the wrapper passes them).
// bias1, bias2 and, for xyz, lr are read from device memory, so a CUDA
// graph's replay steps with the iteration it was given.
//
// What bounds it on an H100: bytes. A stepped element reads 16 bytes and
// writes 12, plus a byte a row of the mask: 28 x 59 x 2^20 B = 1.73 GB over
// every group at 2^20 rows with every row stepping, 0.52 ms at 3.35 TB/s;
// rows that do not step cost their mask byte.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

struct Adam {
  float b1, one_b1, b2, one_b2, eps, neg_lr;
  const float* bias1;
  const float* bias2;
  const float* lr;  // a () device tensor, or null: neg_lr is -lr
};

struct Scalars {
  float b1, one_b1, b2, one_b2, eps, neg_lr, bias1, bias2;
};

__device__ __forceinline__ Scalars load_scalars(const Adam& a) {
  return Scalars{a.b1, a.one_b1, a.b2, a.one_b2, a.eps,
                 a.lr != nullptr ? -*a.lr : a.neg_lr, *a.bias1, *a.bias2};
}

__device__ __forceinline__ void step(float& p, float g, float& m, float& v, const Scalars& s) {
  g = isnan(g) ? 0.0f : g;
  const float m2 = __fadd_rn(__fmul_rn(s.b1, m), __fmul_rn(s.one_b1, g));
  const float v2 = __fadd_rn(__fmul_rn(s.b2, v), __fmul_rn(__fmul_rn(s.one_b2, g), g));
  const float m_hat = __fdiv_rn(m2, s.bias1);
  const float v_hat = __fdiv_rn(v2, s.bias2);
  const float delta = __fdiv_rn(__fmul_rn(s.neg_lr, m_hat), __fadd_rn(__fsqrt_rn(v_hat), s.eps));
  p = __fadd_rn(p, delta);
  m = m2;
  v = v2;
}

// Element e's row: e / d, d = D when D > 0, else the runtime width.
template <int D>
__device__ __forceinline__ long long row_of(long long e, int d) {
  return e / (D > 0 ? D : d);
}

// Four elements from e0 (16-byte aligned arrays), or the scalar tail.
template <int D>
__global__ void __launch_bounds__(kThreads) masked_adam_vec4_kernel(
    float* __restrict__ p, const float* __restrict__ g, float* __restrict__ m,
    float* __restrict__ v, const uint8_t* __restrict__ mask, long long total, int d, Adam a) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long e0 = 4 * i;
  if (e0 >= total) return;
  if (e0 + 4 > total) {  // the tail: fewer than four elements, one at a time
    for (long long e = e0; e < total; ++e) {
      if (!mask[row_of<D>(e, d)]) continue;
      const Scalars s = load_scalars(a);
      float pe = p[e], me = m[e], ve = v[e];
      step(pe, g[e], me, ve, s);
      p[e] = pe, m[e] = me, v[e] = ve;
    }
    return;
  }
  const int width = D > 0 ? D : d;
  const long long r0 = row_of<D>(e0, d);
  const int col = static_cast<int>(e0 - r0 * width);
  bool live[4];
  if (D >= 3) {  // four elements span at most two rows
    const bool first = mask[r0] != 0;
    const bool second = col + 3 >= width ? mask[r0 + 1] != 0 : first;
#pragma unroll
    for (int k = 0; k < 4; ++k) live[k] = col + k < width ? first : second;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) live[k] = mask[r0 + (col + k) / width] != 0;
  }
  if (!(live[0] || live[1] || live[2] || live[3])) return;
  const Scalars s = load_scalars(a);
  float4 pv = reinterpret_cast<const float4*>(p)[i];
  const float4 gv = reinterpret_cast<const float4*>(g)[i];
  float4 mv = reinterpret_cast<const float4*>(m)[i];
  float4 vv = reinterpret_cast<const float4*>(v)[i];
  if (live[0]) step(pv.x, gv.x, mv.x, vv.x, s);
  if (live[1]) step(pv.y, gv.y, mv.y, vv.y, s);
  if (live[2]) step(pv.z, gv.z, mv.z, vv.z, s);
  if (live[3]) step(pv.w, gv.w, mv.w, vv.w, s);
  reinterpret_cast<float4*>(p)[i] = pv;
  reinterpret_cast<float4*>(m)[i] = mv;
  reinterpret_cast<float4*>(v)[i] = vv;
}

template <int D>
void launch(float* p, const float* g, float* m, float* v, const uint8_t* mask, long long total,
            int d, const Adam& a, cudaStream_t stream) {
  const long long threads = (total + 3) / 4;
  masked_adam_vec4_kernel<D><<<(threads + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      p, g, m, v, mask, total, d, a);
}

}  // namespace

// param, grad, m, v: (n, d) f32, contiguous, 16-byte aligned; mask: (n,)
// bool; bias1, bias2: () f32 device tensors; lr: a () f32 device tensor,
// or null and neg_lr.
extern "C" int gs_masked_adam(void* param, const void* grad, void* m, void* v, const void* mask,
                              long long n, int d, const void* bias1, const void* bias2,
                              const void* lr, float neg_lr, float b1, float one_b1, float b2,
                              float one_b2, float eps, void* stream) {
  const long long total = n * d;
  if (total > 0) {
    const Adam a{b1, one_b1, b2, one_b2, eps, neg_lr, (const float*)bias1, (const float*)bias2,
                 (const float*)lr};
    float* pf = (float*)param;
    const float* gf = (const float*)grad;
    float *mf = (float*)m, *vf = (float*)v;
    const uint8_t* mk = (const uint8_t*)mask;
    cudaStream_t s = (cudaStream_t)stream;
    switch (d) {
      case 1: launch<1>(pf, gf, mf, vf, mk, total, d, a, s); break;
      case 3: launch<3>(pf, gf, mf, vf, mk, total, d, a, s); break;
      case 4: launch<4>(pf, gf, mf, vf, mk, total, d, a, s); break;
      case 45: launch<45>(pf, gf, mf, vf, mk, total, d, a, s); break;
      default: launch<0>(pf, gf, mf, vf, mk, total, d, a, s); break;
    }
  }
  return (int)cudaGetLastError();
}
