// Fused optimizer update on Hopper: one launch per parameter bucket.
//
// Replaces paddle_tpu/ops/kernels/pallas/fused_optimizer.py
// (`_pallas_elementwise_bucket` through `_bucket_kernel_call`, reached
// from `fused_apply`). One launch updates every parameter of a bucket
// (one compute dtype, grad dtype, write-back dtype and weight decay): it
// unscales and clips the grad, runs the SGD / Momentum / Adam(W) rule,
// keeps every old value when the step is non-finite, and writes the
// low-precision parameter back from the float32 master.
//
// Nothing is gathered: the grid walks a device table of chunks, each a
// run of at most 64Ki elements of one parameter, as six int64 words
// (param-or-master, grad, low-precision param or 0, state 0, state 1,
// element count). The masters and moments are the optimizer's own
// tensors and are updated in place.
//
// Bound: bytes. AdamW over a bf16 parameter with a float32 master reads
// grad 2 + master 4 + m 4 + v 4 and writes master 4 + m 4 + v 4 + param 2
// bytes per element, with ~20 flops.
//
// Bitwise contract: each operation is one IEEE-rounded float32 operation
// (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn, __fsqrt_rn cannot be
// contracted into FMAs), rounded to the compute dtype after every step,
// in the order of the per-parameter rule in torch ops
// (paddle_tpu_torch/optimizer/optimizer.py). Scalars arrive in one device
// vector [lr, step, inv, coeff, found, wd, inv_bc1, inv_bc2]; python-float
// hyperparameters arrive as float32, as torch's scalar ops see them.

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

enum Kind { kSgd = 0, kMomentum = 1, kAdam = 2 };

struct Hyper {
  int kind, decoupled, nesterov;
  float b1, omb1, b2, omb2, eps, mom;  // omb = 1 - b, taken in double
};

template <typename CT, typename GT>
__global__ void __launch_bounds__(kThreads) fused_kernel(
    const long long* __restrict__ table, const float* __restrict__ sv,
    Hyper hp) {
  const long long* row = table + 6 * static_cast<long long>(blockIdx.x);
  CT* P = reinterpret_cast<CT*>(row[0]);
  const GT* G = reinterpret_cast<const GT*>(row[1]);
  __nv_bfloat16* low = reinterpret_cast<__nv_bfloat16*>(row[2]);
  CT* S0 = reinterpret_cast<CT*>(row[3]);
  CT* S1 = reinterpret_cast<CT*>(row[4]);
  const long long n = row[5];

  const float lr = rnd<CT>(sv[0]);
  const float inv = rnd<GT>(sv[2]);
  const float coeff = rnd<GT>(sv[3]);
  const bool found = sv[4] > 0.f;
  const float wd = rnd<CT>(sv[5]);
  const float bc1 = rnd<CT>(sv[6]);
  const float bc2 = rnd<CT>(sv[7]);

  for (long long i = threadIdx.x; i < n; i += kThreads) {
    const float p = ld<CT>(P, i);
    // unscale and clip in the grad's dtype, then the cast to the compute
    // dtype (GradScaler.unscale_ -> global-norm clip -> the rule's cast)
    float g = rnd<GT>(__fmul_rn(ld<GT>(G, i), inv));
    g = rnd<GT>(__fmul_rn(g, coeff));
    g = rnd<CT>(g);
    float np, s0 = 0.f, s1 = 0.f;
    if (hp.kind == kAdam) {
      const float m0 = ld<CT>(S0, i), v0 = ld<CT>(S1, i);
      if (!hp.decoupled) g = rnd<CT>(__fadd_rn(g, rnd<CT>(__fmul_rn(wd, p))));
      s0 = rnd<CT>(__fadd_rn(rnd<CT>(__fmul_rn(hp.b1, m0)),
                             rnd<CT>(__fmul_rn(hp.omb1, g))));
      const float gg = rnd<CT>(__fmul_rn(g, g));
      s1 = rnd<CT>(__fadd_rn(rnd<CT>(__fmul_rn(hp.b2, v0)),
                             rnd<CT>(__fmul_rn(hp.omb2, gg))));
      const float num = rnd<CT>(__fmul_rn(s0, bc1));
      const float root = rnd<CT>(__fsqrt_rn(rnd<CT>(__fmul_rn(s1, bc2))));
      const float den = rnd<CT>(__fadd_rn(root, hp.eps));
      float upd = rnd<CT>(__fdiv_rn(num, den));
      if (hp.decoupled)
        upd = rnd<CT>(__fadd_rn(upd, rnd<CT>(__fmul_rn(wd, p))));
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
    if (low != nullptr) low[i] = __float2bfloat16_rn(np);
  }
}

template <typename CT, typename GT>
int launch(const void* table, int nchunks, const void* sv, Hyper hp,
           cudaStream_t stream) {
  fused_kernel<CT, GT><<<nchunks, kThreads, 0, stream>>>(
      static_cast<const long long*>(table), static_cast<const float*>(sv),
      hp);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype codes: 0 float32, 1 bfloat16 (compute dtype `ctype`, grad dtype
// `gtype`); kind: 0 sgd, 1 momentum, 2 adam.
extern "C" int ptt_fused_optimizer(const void* table, int nchunks,
                                   const void* svec, int kind, int ctype,
                                   int gtype, int decoupled, int nesterov,
                                   float b1, float omb1, float b2, float omb2,
                                   float eps, float mom, void* stream) {
  if (nchunks <= 0 || kind < 0 || kind > 2)
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
