// Fused optimizer update on Hopper: one launch per parameter bucket (two
// for Lamb).
//
// Replaces paddle_tpu/ops/kernels/pallas/fused_optimizer.py: the
// elementwise bucket kernel (`_pallas_elementwise_bucket` through
// `_bucket_kernel_call`, reached from `fused_apply`) and Lamb's two bucket
// passes (`_pallas_lamb_bucket`, the same `_bucket_kernel_call` twice).
// One launch updates every parameter of a bucket (one compute dtype, grad
// dtype, write-back dtype and weight decay): it unscales and clips the
// grad, runs the SGD / Momentum / Adam(W) rule, keeps every old value when
// the step is non-finite, and writes the low-precision parameter back from
// the float32 master. Lamb splits at its per-parameter norms, which the
// caller reduces in torch between the launches (a reduction order of the
// kernel's own would break fused == per-param at float32):
//   lamb_moments: the conditioned grad, the guarded new m and v, and the
//     raw tr_div = (m bc1) / (sqrt(v bc2) + eps) + wd p, written to a
//     scratch in the compute dtype (the reference's `_lamb_moments`);
//   lamb_apply: p - (lr r) tr_div with the parameter's trust ratio r read
//     once through a pointer in the chunk's row, the sentinel select and
//     the bf16 write-back (`_lamb_apply`). The reference broadcasts r per
//     element into a buffer of the bucket's size, a need of its TPU tiling.
//
// Nothing is gathered: the grid walks a device table of chunks, each a
// run of at most 64Ki elements of one parameter, as eight int64 words
// (param-or-master, grad, low-precision param or 0, state 0, state 1,
// tr_div scratch or 0, trust ratio (float32) or 0, element count). The
// masters and moments are the optimizer's own tensors, updated in place.
//
// Bound: bytes. AdamW over a bf16 parameter with a float32 master reads
// grad 2 + master 4 + m 4 + v 4 and writes master 4 + m 4 + v 4 + param 2
// bytes per element, with ~20 flops. Lamb moves 26 bytes in its first
// pass (tr_div 4 written), 14 in its second (master 4 + tr_div 4 read,
// master 4 + param 2 written) and 8 in the norms between them.
//
// Bitwise contract: each operation is one IEEE-rounded float32 operation
// (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn, __fsqrt_rn cannot be
// contracted into FMAs), rounded to the compute dtype after every step,
// in the order of the per-parameter rule in torch ops
// (paddle_tpu_torch/ops/kernels/fused_optimizer.py). Scalars arrive in one
// device vector [lr, step, inv, coeff, found, wd, inv_bc1, inv_bc2];
// python-float hyperparameters arrive as float32, as torch's scalar ops
// see them.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
__device__ __forceinline__ float ld(const T* p, long long i);
template <>
__device__ __forceinline__ float ld<float>(const float* p, long long i) {
  return p[i];
}
template <>
__device__ __forceinline__ float ld<__nv_bfloat16>(const __nv_bfloat16* p,
                                                   long long i) {
  return __bfloat162float(p[i]);
}

template <typename T>
__device__ __forceinline__ T to(float x);
template <>
__device__ __forceinline__ float to<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 to<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// round a float32 result to T (round to nearest even) and back
template <typename T>
__device__ __forceinline__ float rnd(float x);
template <>
__device__ __forceinline__ float rnd<float>(float x) { return x; }
template <>
__device__ __forceinline__ float rnd<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

enum Kind { kSgd = 0, kMomentum = 1, kAdam = 2, kLambMoments = 3,
            kLambApply = 4 };
constexpr int kRow = 8;  // int64 words per chunk-table row

// One chunk-table row: its parameter's tensors at the chunk's start.
template <typename CT, typename GT>
struct Chunk {
  CT* P;
  const GT* G;
  __nv_bfloat16* low;
  CT* S0;
  CT* S1;
  CT* T;
  const float* R;
  long long n;
  __device__ explicit Chunk(const long long* row)
      : P(reinterpret_cast<CT*>(row[0])),
        G(reinterpret_cast<const GT*>(row[1])),
        low(reinterpret_cast<__nv_bfloat16*>(row[2])),
        S0(reinterpret_cast<CT*>(row[3])),
        S1(reinterpret_cast<CT*>(row[4])),
        T(reinterpret_cast<CT*>(row[5])),
        R(reinterpret_cast<const float*>(row[6])),
        n(row[7]) {}
};

struct Hyper {
  int kind, decoupled, nesterov;
  float b1, omb1, b2, omb2, eps, mom;  // omb = 1 - b, taken in double
};

// The scalars of the vector [lr, step, inv, coeff, found, wd, inv_bc1,
// inv_bc2], each cast as the torch rule casts it.
template <typename CT, typename GT>
struct Scalars {
  float lr, inv, coeff, wd, bc1, bc2;
  bool found;
  __device__ explicit Scalars(const float* sv)
      : lr(rnd<CT>(sv[0])),
        inv(rnd<GT>(sv[2])),
        coeff(rnd<GT>(sv[3])),
        wd(rnd<CT>(sv[5])),
        bc1(rnd<CT>(sv[6])),
        bc2(rnd<CT>(sv[7])),
        found(sv[4] > 0.f) {}
};

// unscale and clip in the grad's dtype, then the cast to the compute
// dtype (GradScaler.unscale_ -> global-norm clip -> the rule's cast)
template <typename CT, typename GT>
__device__ __forceinline__ float condition(const GT* G, long long i,
                                           const Scalars<CT, GT>& sc) {
  float g = rnd<GT>(__fmul_rn(ld<GT>(G, i), sc.inv));
  g = rnd<GT>(__fmul_rn(g, sc.coeff));
  return rnd<CT>(g);
}

// Adam's moments and update direction (the torch rule's `adam_step`):
// writes the new m and v to s0, s1 and returns the update, decoupled
// weight decay included when `decoupled`.
template <typename CT>
__device__ __forceinline__ float adam_step(float p, float g, float m0,
                                           float v0, float wd, float bc1,
                                           float bc2, const Hyper& hp,
                                           bool decoupled, float& s0,
                                           float& s1) {
  if (!decoupled) g = rnd<CT>(__fadd_rn(g, rnd<CT>(__fmul_rn(wd, p))));
  s0 = rnd<CT>(__fadd_rn(rnd<CT>(__fmul_rn(hp.b1, m0)),
                         rnd<CT>(__fmul_rn(hp.omb1, g))));
  const float gg = rnd<CT>(__fmul_rn(g, g));
  s1 = rnd<CT>(__fadd_rn(rnd<CT>(__fmul_rn(hp.b2, v0)),
                         rnd<CT>(__fmul_rn(hp.omb2, gg))));
  const float num = rnd<CT>(__fmul_rn(s0, bc1));
  const float root = rnd<CT>(__fsqrt_rn(rnd<CT>(__fmul_rn(s1, bc2))));
  const float den = rnd<CT>(__fadd_rn(root, hp.eps));
  float upd = rnd<CT>(__fdiv_rn(num, den));
  if (decoupled) upd = rnd<CT>(__fadd_rn(upd, rnd<CT>(__fmul_rn(wd, p))));
  return upd;
}

template <typename CT, typename GT>
__global__ void __launch_bounds__(kThreads) fused_kernel(
    const long long* __restrict__ table, const float* __restrict__ sv,
    Hyper hp) {
  const Chunk<CT, GT> c(table + kRow * static_cast<long long>(blockIdx.x));
  CT* P = c.P;
  CT* S0 = c.S0;
  CT* S1 = c.S1;
  const Scalars<CT, GT> sc(sv);
  const float lr = sc.lr, wd = sc.wd;
  const bool found = sc.found;

  for (long long i = threadIdx.x; i < c.n; i += kThreads) {
    const float p = ld<CT>(P, i);
    float g = condition<CT, GT>(c.G, i, sc);
    float np, s0 = 0.f, s1 = 0.f;
    if (hp.kind == kAdam) {
      const float m0 = ld<CT>(S0, i), v0 = ld<CT>(S1, i);
      const float upd = adam_step<CT>(p, g, m0, v0, wd, sc.bc1, sc.bc2, hp,
                                      hp.decoupled, s0, s1);
      np = rnd<CT>(__fsub_rn(p, rnd<CT>(__fmul_rn(lr, upd))));
      if (found) {
        s0 = m0;
        s1 = v0;
      }
    } else {
      const float gw = rnd<CT>(__fadd_rn(g, rnd<CT>(__fmul_rn(wd, p))));
      float upd = gw;
      if (hp.kind == kMomentum) {
        const float v0 = ld<CT>(S0, i);
        s0 = rnd<CT>(__fadd_rn(rnd<CT>(__fmul_rn(hp.mom, v0)), gw));
        upd = hp.nesterov
                  ? rnd<CT>(__fadd_rn(gw, rnd<CT>(__fmul_rn(hp.mom, s0))))
                  : s0;
        if (found) s0 = v0;
      }
      np = rnd<CT>(__fsub_rn(p, rnd<CT>(__fmul_rn(lr, upd))));
    }
    if (found) np = p;  // a non-finite step keeps every old value bitwise
    P[i] = to<CT>(np);
    if (hp.kind != kSgd) S0[i] = to<CT>(s0);
    if (hp.kind == kAdam) S1[i] = to<CT>(s1);
    if (c.low != nullptr) c.low[i] = __float2bfloat16_rn(np);
  }
}

// Lamb, pass 1: guarded moments and the raw tr_div (Adam's chain with the
// weight decay always added to the direction).
template <typename CT, typename GT>
__global__ void __launch_bounds__(kThreads) lamb_moments_fused_kernel(
    const long long* __restrict__ table, const float* __restrict__ sv,
    Hyper hp) {
  const Chunk<CT, GT> c(table + kRow * static_cast<long long>(blockIdx.x));
  const Scalars<CT, GT> sc(sv);
  for (long long i = threadIdx.x; i < c.n; i += kThreads) {
    const float p = ld<CT>(c.P, i);
    const float g = condition<CT, GT>(c.G, i, sc);
    const float m0 = ld<CT>(c.S0, i), v0 = ld<CT>(c.S1, i);
    float s0, s1;
    const float trd =
        adam_step<CT>(p, g, m0, v0, sc.wd, sc.bc1, sc.bc2, hp, true, s0, s1);
    c.T[i] = to<CT>(trd);
    c.S0[i] = to<CT>(sc.found ? m0 : s0);
    c.S1[i] = to<CT>(sc.found ? v0 : s1);
  }
}

// Lamb, pass 2: p - (lr r) tr_div, the sentinel select, the write-back.
template <typename CT, typename GT>
__global__ void __launch_bounds__(kThreads) lamb_apply_fused_kernel(
    const long long* __restrict__ table, const float* __restrict__ sv) {
  const Chunk<CT, GT> c(table + kRow * static_cast<long long>(blockIdx.x));
  const Scalars<CT, GT> sc(sv);
  const float lrr = rnd<CT>(__fmul_rn(sc.lr, rnd<CT>(*c.R)));
  for (long long i = threadIdx.x; i < c.n; i += kThreads) {
    const float p = ld<CT>(c.P, i);
    const float np = sc.found
                         ? p
                         : rnd<CT>(__fsub_rn(
                               p, rnd<CT>(__fmul_rn(lrr, ld<CT>(c.T, i)))));
    c.P[i] = to<CT>(np);
    if (c.low != nullptr) c.low[i] = __float2bfloat16_rn(np);
  }
}

template <typename CT, typename GT>
int launch(const void* table, int nchunks, const void* sv, Hyper hp,
           cudaStream_t stream) {
  const long long* t = static_cast<const long long*>(table);
  const float* v = static_cast<const float*>(sv);
  if (hp.kind == kLambMoments)
    lamb_moments_fused_kernel<CT, GT><<<nchunks, kThreads, 0, stream>>>(
        t, v, hp);
  else if (hp.kind == kLambApply)
    lamb_apply_fused_kernel<CT, GT><<<nchunks, kThreads, 0, stream>>>(t, v);
  else
    fused_kernel<CT, GT><<<nchunks, kThreads, 0, stream>>>(t, v, hp);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype codes: 0 float32, 1 bfloat16 (compute dtype `ctype`, grad dtype
// `gtype`); kind: 0 sgd, 1 momentum, 2 adam, 3 lamb_moments, 4 lamb_apply.
extern "C" int ptt_fused_optimizer(const void* table, int nchunks,
                                   const void* svec, int kind, int ctype,
                                   int gtype, int decoupled, int nesterov,
                                   float b1, float omb1, float b2, float omb2,
                                   float eps, float mom, void* stream) {
  if (nchunks <= 0 || kind < 0 || kind > 4)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Hyper hp{kind, decoupled, nesterov, b1, omb1, b2, omb2, eps, mom};
  if (ctype == 0 && gtype == 0)
    return launch<float, float>(table, nchunks, svec, hp, s);
  if (ctype == 0 && gtype == 1)
    return launch<float, __nv_bfloat16>(table, nchunks, svec, hp, s);
  if (ctype == 1 && gtype == 0)
    return launch<__nv_bfloat16, float>(table, nchunks, svec, hp, s);
  if (ctype == 1 && gtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(table, nchunks, svec, hp, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
