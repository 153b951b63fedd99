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
// bytes per element, with ~20 flops; Momentum over float32 moves 20. Lamb
// moves 26 bytes in its first pass (tr_div 4 written), 14 in its second
// (master 4 + tr_div 4 read, master 4 + param 2 written) and 8 in the
// norms between them.
//
// Design (memory-level parallelism, the only lever of a streaming pass):
// - each thread moves 4 consecutive elements per access (a float4 of a
//   float32 array, 8 bytes of a bf16 one) and issues kUnroll accesses of
//   every stream it reads before any arithmetic, so a thread keeps
//   kUnroll x (16 or 8) bytes per stream in flight;
// - the rule is a template parameter (and Momentum's nesterov, Adam's
//   decoupled decay), so the loop has no runtime branch on the rule and
//   reads and writes only the streams the rule has;
// - grid (rows, split): the host splits each chunk-table row over `split`
//   blocks (blockIdx.y), each taking an equal part rounded up to whole
//   sweeps of the block, so a mid-sized bucket (ResNet-50's 508 rows)
//   launches enough blocks to fill the card while the table, its upload
//   and a captured step's pre-allocated tables keep their size (a
//   persistent grid would need the same table plus a work queue);
// - a row whose pointers are not all aligned to one access (an optimizer
//   state view at an odd offset) runs the same arithmetic one element at a
//   time, inside this kernel; the host counts such rows
//   (`fused_optimizer.unaligned_rows`), and the optimizer pads its views
//   to 64 bytes, so a training bucket has none. A row's last count % 4
//   elements take that scalar path too.
// No shared memory, TMA or tensor cores: each element is read once and
// written once, and nothing is reused.
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
constexpr int kVec = 4;                     // elements a thread access
constexpr int kUnroll = 2;                  // accesses in flight a stream
constexpr int kSweep = kThreads * kVec;     // elements a block access step
constexpr int kRow = 8;                     // int64 words a table row

// -- element access ---------------------------------------------------------

__device__ __forceinline__ float ld(const float* p, long long i) {
  return p[i];
}
__device__ __forceinline__ float ld(const __nv_bfloat16* p, long long i) {
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

// four consecutive elements from element i (i a multiple of 4, the
// pointer aligned to 4 elements): one 16-byte load of float32, one 8-byte
// load of bf16 (bf16 widens to float32 exactly: its bits in the top half)
__device__ __forceinline__ void ld4(const float* p, long long i, float* o) {
  const float4 v = *reinterpret_cast<const float4*>(p + i);
  o[0] = v.x;
  o[1] = v.y;
  o[2] = v.z;
  o[3] = v.w;
}
__device__ __forceinline__ void ld4(const __nv_bfloat16* p, long long i,
                                    float* o) {
  const uint2 v = *reinterpret_cast<const uint2*>(p + i);
  o[0] = __uint_as_float(v.x << 16);
  o[1] = __uint_as_float(v.x & 0xffff0000u);
  o[2] = __uint_as_float(v.y << 16);
  o[3] = __uint_as_float(v.y & 0xffff0000u);
}

__device__ __forceinline__ void st4(float* p, long long i, const float* x) {
  *reinterpret_cast<float4*>(p + i) = make_float4(x[0], x[1], x[2], x[3]);
}
__device__ __forceinline__ unsigned bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}
__device__ __forceinline__ void st4(__nv_bfloat16* p, long long i,
                                    const float* x) {
  uint2 v;
  v.x = bf16_bits(x[0]) | (bf16_bits(x[1]) << 16);
  v.y = bf16_bits(x[2]) | (bf16_bits(x[3]) << 16);
  *reinterpret_cast<uint2*>(p + i) = v;
}

template <typename T>
__device__ __forceinline__ bool vec_aligned(const T* p) {
  return (reinterpret_cast<uintptr_t>(p) % (kVec * sizeof(T))) == 0;
}

// -- the rules --------------------------------------------------------------

enum Kind { kSgd = 0, kMomentum = 1, kAdam = 2, kLambMoments = 3,
            kLambApply = 4 };

struct Hyper {
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

// Which streams a rule reads and writes.
template <int K>
struct Streams {
  static constexpr bool grad = K != kLambApply;
  static constexpr bool s0 = K == kMomentum || K == kAdam ||
                             K == kLambMoments;
  static constexpr bool s1 = K == kAdam || K == kLambMoments;
  static constexpr bool read_t = K == kLambApply;
  static constexpr bool write_t = K == kLambMoments;
  static constexpr bool write_p = K != kLambMoments;  // and the bf16 copy
};

// unscale and clip in the grad's dtype, then the cast to the compute
// dtype (GradScaler.unscale_ -> global-norm clip -> the rule's cast)
template <typename CT, typename GT>
__device__ __forceinline__ float condition(float g,
                                           const Scalars<CT, GT>& sc) {
  g = rnd<GT>(__fmul_rn(g, sc.inv));
  g = rnd<GT>(__fmul_rn(g, sc.coeff));
  return rnd<CT>(g);
}

// Adam's moments and update direction (the torch rule's `adam_step`):
// writes the new m and v to s0, s1 and returns the update, decoupled
// weight decay included when `decoupled`.
template <typename CT, bool decoupled>
__device__ __forceinline__ float adam_step(float p, float g, float m0,
                                           float v0, float wd, float bc1,
                                           float bc2, const Hyper& hp,
                                           float& s0, float& s1) {
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

// One element of rule K (F: Momentum's nesterov, Adam's decoupled), in
// place on the values as loaded: p (param or master), g (the raw grad),
// s0, s1 (state), t (Lamb's tr_div). `lrr` is Lamb's lr * r.
template <int K, bool F, typename CT, typename GT>
__device__ __forceinline__ void element(float& p, float g, float& s0,
                                        float& s1, float& t,
                                        const Scalars<CT, GT>& sc,
                                        const Hyper& hp, float lrr) {
  if (K == kLambApply) {
    if (!sc.found) p = rnd<CT>(__fsub_rn(p, rnd<CT>(__fmul_rn(lrr, t))));
    return;
  }
  g = condition<CT, GT>(g, sc);
  if (K == kLambMoments) {
    float m, v;
    t = adam_step<CT, true>(p, g, s0, s1, sc.wd, sc.bc1, sc.bc2, hp, m, v);
    if (!sc.found) {
      s0 = m;
      s1 = v;
    }
    return;
  }
  float np;
  if (K == kAdam) {
    float m, v;
    const float upd = adam_step<CT, F>(p, g, s0, s1, sc.wd, sc.bc1, sc.bc2,
                                       hp, m, v);
    np = rnd<CT>(__fsub_rn(p, rnd<CT>(__fmul_rn(sc.lr, upd))));
    if (!sc.found) {
      s0 = m;
      s1 = v;
    }
  } else {
    const float gw = rnd<CT>(__fadd_rn(g, rnd<CT>(__fmul_rn(sc.wd, p))));
    float upd = gw;
    if (K == kMomentum) {
      const float v = rnd<CT>(__fadd_rn(rnd<CT>(__fmul_rn(hp.mom, s0)), gw));
      upd = F ? rnd<CT>(__fadd_rn(gw, rnd<CT>(__fmul_rn(hp.mom, v)))) : v;
      if (!sc.found) s0 = v;
    }
    np = rnd<CT>(__fsub_rn(p, rnd<CT>(__fmul_rn(sc.lr, upd))));
  }
  if (!sc.found) p = np;  // a non-finite step keeps every old value bitwise
}

// One block's part of a chunk-table row, its pointers advanced to the
// part's first element.
template <typename CT, typename GT>
struct Part {
  CT* __restrict__ P;
  const GT* __restrict__ G;
  __nv_bfloat16* __restrict__ low;
  CT* __restrict__ S0;
  CT* __restrict__ S1;
  CT* __restrict__ T;
  long long n;
};

// one element at i, loaded and stored one at a time
template <int K, bool F, typename CT, typename GT>
__device__ __forceinline__ void scalar_at(const Part<CT, GT>& w, long long i,
                                          const Scalars<CT, GT>& sc,
                                          const Hyper& hp, float lrr) {
  using S = Streams<K>;
  float p = ld(w.P, i), g = 0.f, s0 = 0.f, s1 = 0.f, t = 0.f;
  if (S::grad) g = ld(w.G, i);
  if (S::s0) s0 = ld(w.S0, i);
  if (S::s1) s1 = ld(w.S1, i);
  if (S::read_t) t = ld(w.T, i);
  element<K, F, CT, GT>(p, g, s0, s1, t, sc, hp, lrr);
  if (S::write_p) {
    w.P[i] = to<CT>(p);
    if (w.low != nullptr) w.low[i] = __float2bfloat16_rn(p);
  }
  if (S::s0) w.S0[i] = to<CT>(s0);
  if (S::s1) w.S1[i] = to<CT>(s1);
  if (S::write_t) w.T[i] = to<CT>(t);
}

template <int K, bool F, typename CT, typename GT>
__global__ void __launch_bounds__(kThreads) bucket_kernel(
    const long long* __restrict__ table, const float* __restrict__ sv,
    Hyper hp, int split) {
  using S = Streams<K>;
  const long long* row = table + kRow * static_cast<long long>(blockIdx.x);
  const long long n = row[7];
  // this block's part: an equal share of the row in whole sweeps
  long long part = (n + split - 1) / split;
  part = (part + kSweep - 1) / kSweep * kSweep;
  const long long lo = part * blockIdx.y;
  if (lo >= n) return;
  Part<CT, GT> w;
  w.P = reinterpret_cast<CT*>(row[0]) + lo;
  w.G = reinterpret_cast<const GT*>(row[1]) + lo;
  w.low = row[2] ? reinterpret_cast<__nv_bfloat16*>(row[2]) + lo : nullptr;
  w.S0 = reinterpret_cast<CT*>(row[3]) + lo;
  w.S1 = reinterpret_cast<CT*>(row[4]) + lo;
  w.T = reinterpret_cast<CT*>(row[5]) + lo;
  w.n = n - lo < part ? n - lo : part;
  const Scalars<CT, GT> sc(sv);
  const float lrr =
      K == kLambApply
          ? rnd<CT>(__fmul_rn(sc.lr,
                              rnd<CT>(*reinterpret_cast<const float*>(row[6]))))
          : 0.f;
  const bool aligned = vec_aligned(w.P) && (!S::grad || vec_aligned(w.G)) &&
                       (!S::s0 || vec_aligned(w.S0)) &&
                       (!S::s1 || vec_aligned(w.S1)) &&
                       (!(S::read_t || S::write_t) || vec_aligned(w.T)) &&
                       (w.low == nullptr || vec_aligned(w.low));
  long long done = 0;
  if (aligned) {
    const long long nv = w.n / kVec;          // whole 4-element accesses
    for (long long v0 = threadIdx.x; v0 < nv;
         v0 += static_cast<long long>(kThreads) * kUnroll) {
      float p[kUnroll][kVec], g[kUnroll][kVec], s0[kUnroll][kVec],
          s1[kUnroll][kVec], t[kUnroll][kVec];
      // every load of the kUnroll accesses first ...
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long v = v0 + static_cast<long long>(u) * kThreads;
        if (v < nv) {
          const long long i = v * kVec;
          ld4(w.P, i, p[u]);
          if (S::grad) ld4(w.G, i, g[u]);
          if (S::s0) ld4(w.S0, i, s0[u]);
          if (S::s1) ld4(w.S1, i, s1[u]);
          if (S::read_t) ld4(w.T, i, t[u]);
        }
      }
      // ... then the arithmetic and the stores
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long v = v0 + static_cast<long long>(u) * kThreads;
        if (v < nv) {
          const long long i = v * kVec;
#pragma unroll
          for (int e = 0; e < kVec; ++e)
            element<K, F, CT, GT>(p[u][e], S::grad ? g[u][e] : 0.f,
                                  s0[u][e], s1[u][e], t[u][e], sc, hp, lrr);
          if (S::write_p) {
            st4(w.P, i, p[u]);
            if (w.low != nullptr) st4(w.low, i, p[u]);
          }
          if (S::s0) st4(w.S0, i, s0[u]);
          if (S::s1) st4(w.S1, i, s1[u]);
          if (S::write_t) st4(w.T, i, t[u]);
        }
      }
    }
    done = nv * kVec;
  }
  // an unaligned row whole, or an aligned part's last n % 4 elements
  for (long long i = done + threadIdx.x; i < w.n; i += kThreads)
    scalar_at<K, F, CT, GT>(w, i, sc, hp, lrr);
}

template <int K, bool F, typename CT, typename GT>
int launch_rule(const long long* t, int nchunks, int split, const float* v,
                Hyper hp, cudaStream_t stream) {
  const dim3 grid(nchunks, split);
  bucket_kernel<K, F, CT, GT><<<grid, kThreads, 0, stream>>>(t, v, hp,
                                                             split);
  return static_cast<int>(cudaGetLastError());
}

template <typename CT, typename GT>
int launch(const void* table, int nchunks, int split, const void* sv,
           int kind, bool flag, Hyper hp, cudaStream_t s) {
  const long long* t = static_cast<const long long*>(table);
  const float* v = static_cast<const float*>(sv);
  switch (kind) {
    case kSgd:
      return launch_rule<kSgd, false, CT, GT>(t, nchunks, split, v, hp, s);
    case kMomentum:
      return flag ? launch_rule<kMomentum, true, CT, GT>(t, nchunks, split,
                                                         v, hp, s)
                  : launch_rule<kMomentum, false, CT, GT>(t, nchunks, split,
                                                          v, hp, s);
    case kAdam:
      return flag ? launch_rule<kAdam, true, CT, GT>(t, nchunks, split, v,
                                                     hp, s)
                  : launch_rule<kAdam, false, CT, GT>(t, nchunks, split, v,
                                                      hp, s);
    case kLambMoments:
      return launch_rule<kLambMoments, false, CT, GT>(t, nchunks, split, v,
                                                      hp, s);
    default:
      return launch_rule<kLambApply, false, CT, GT>(t, nchunks, split, v,
                                                    hp, s);
  }
}

}  // namespace

// dtype codes: 0 float32, 1 bfloat16 (compute dtype `ctype`, grad dtype
// `gtype`); kind: 0 sgd, 1 momentum, 2 adam, 3 lamb_moments, 4 lamb_apply;
// `split` blocks per chunk-table row (1 to 64).
extern "C" int ptt_fused_optimizer(const void* table, int nchunks,
                                   int split, const void* svec, int kind,
                                   int ctype, int gtype, int decoupled,
                                   int nesterov, float b1, float omb1,
                                   float b2, float omb2, float eps,
                                   float mom, void* stream) {
  if (nchunks <= 0 || split < 1 || split > 65535 || kind < 0 || kind > 4)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Hyper hp{b1, omb1, b2, omb2, eps, mom};
  const bool flag = kind == kMomentum ? nesterov != 0 : decoupled != 0;
  if (ctype == 0 && gtype == 0)
    return launch<float, float>(table, nchunks, split, svec, kind, flag, hp,
                                s);
  if (ctype == 0 && gtype == 1)
    return launch<float, __nv_bfloat16>(table, nchunks, split, svec, kind,
                                        flag, hp, s);
  if (ctype == 1 && gtype == 0)
    return launch<__nv_bfloat16, float>(table, nchunks, split, svec, kind,
                                        flag, hp, s);
  if (ctype == 1 && gtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(table, nchunks, split, svec,
                                                kind, flag, hp, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Resident blocks an SM of the current device holds for rule `kind`
// (decoupled / nesterov `flag`) at these dtypes: the occupancy that the
// split plan fills.
extern "C" int ptt_fused_optimizer_blocks_per_sm(int kind, int flag,
                                                 int ctype, int gtype) {
  int blocks = 0;
  const void* fn = nullptr;
#define PTT_FO_KERNEL(CT, GT)                                                \
  switch (kind) {                                                            \
    case kSgd: fn = (const void*)bucket_kernel<kSgd, false, CT, GT>; break;  \
    case kMomentum:                                                          \
      fn = flag ? (const void*)bucket_kernel<kMomentum, true, CT, GT>        \
                : (const void*)bucket_kernel<kMomentum, false, CT, GT>;      \
      break;                                                                 \
    case kAdam:                                                              \
      fn = flag ? (const void*)bucket_kernel<kAdam, true, CT, GT>            \
                : (const void*)bucket_kernel<kAdam, false, CT, GT>;          \
      break;                                                                 \
    case kLambMoments:                                                       \
      fn = (const void*)bucket_kernel<kLambMoments, false, CT, GT>;          \
      break;                                                                 \
    default:                                                                 \
      fn = (const void*)bucket_kernel<kLambApply, false, CT, GT>;            \
  }
  if (ctype == 0 && gtype == 0) {
    PTT_FO_KERNEL(float, float)
  } else if (ctype == 0) {
    PTT_FO_KERNEL(float, __nv_bfloat16)
  } else if (gtype == 0) {
    PTT_FO_KERNEL(__nv_bfloat16, float)
  } else {
    PTT_FO_KERNEL(__nv_bfloat16, __nv_bfloat16)
  }
#undef PTT_FO_KERNEL
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, kThreads,
                                                    0) != cudaSuccess)
    return -1;
  return blocks;
}
