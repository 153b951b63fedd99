// Flash attention on Hopper: forward, dq and dk/dv kernels.
//
// Replaces paddle_tpu/ops/kernels/pallas/flash_attention.py (`_fwd` with
// `_fwd_kernel`, `_bwd` with `_dq_kernel` and `_dkv_kernel`). Tensors are
// addressed as [batch, seq, heads, head_dim] through element strides
// (batch, head, seq; head_dim contiguous), so the caller's [b, s, h, d]
// layout and the folded [b*h, s, d] layout of `flash_block` both reach the
// kernels without a copy. lse and delta are float32 [batch, heads, sq].
//
// Every block owns 64 rows and loops over the other side in tiles of 64
// positions; nothing carries between blocks, so the grid needs no order
// and no atomics (results are the same run to run):
//   forward  block (b*h, q tile):   loops kv tiles up to the causal
//            horizon with the online softmax (m, l, acc in registers);
//   dq       block (b*h, q tile):   loops kv tiles, p = exp(s - lse),
//            ds = p * (dO.V^T - delta), dq += ds.K;
//   dk/dv    block (b*kvh, k tile): loops the G query heads of its GQA
//            group and their q tiles from the causal horizon on,
//            dv += p^T.dO, dk += ds^T.Q.
// Causal masking is right-aligned (query i sees key j iff j <= i + sk - sq),
// tiles wholly past the horizon are skipped, and a tail tile past sq or
// sk is loaded as zeros and masked, so any length works.
//
// What bounds them: operations (at b 2, s 2048, 32/8 heads, d 128, causal:
// forward 68.7 GFLOP, 0.069 ms at 989 TFLOP/s bf16, 1.03 ms at 67 TFLOP/s
// float32; dk/dv 137 GFLOP, 0.139 / 2.05 ms; dq's own product, 34 GFLOP,
// and its bytes both ~0.035 ms in bf16, 0.51 ms float32, where the dq
// kernel also recomputes s and dp: 1.54 ms for its three products).
//
// bfloat16 (flash_tc_fwd, flash_tc_dq, flash_tc_dkv) runs on the tensor
// cores through the engine of flash_wgmma.cuh: bf16 tiles streamed by
// cp.async through two stages, every product a wgmma, softmax in float32,
// the causal mask a policy that runs on boundary tiles only. Forward and
// dq grids put the last q tiles (the longest causal rows) first, and
// dk/dv's the first k tiles, so the grid's tail is short.
//
// float32 (fwd_kernel, dq_kernel, dkv_kernel) runs the same three bodies
// on the CUDA cores through the FMA engine of flash_f32.cuh: full float32
// FMA on register tiles (4 x 4 scores a thread; 8 x 4 in a forward block
// that owns two query heads of a GQA group), float32 tiles streamed by
// cp.async, the same mask policy (CausalMask below serves both engines)
// and the same grid order.

#include "flash_f32.cuh"
#include "flash_wgmma.cuh"

namespace {

constexpr int kRows = ptt::tc::kM;    // rows a block owns
constexpr int kChunk = ptt::tc::kN;   // rows of a streamed tile
static_assert(ptt::fa32::kM == kRows && ptt::fa32::kN == kChunk,
              "both engines tile by 64 x 64");

struct Lay {  // element strides of a [batch, seq, heads, head_dim] tensor
  long long b, h, s;
};

// last key position + 1 that any query row of [q0, q0 + kRows) sees
__device__ __forceinline__ int kv_horizon(int q0, int Sq, int Sk, int causal) {
  if (!causal) return Sk;
  const int last = min(q0 + kRows, Sq) - 1;
  return max(0, min(Sk, last + (Sk - Sq) + 1));
}

// right-aligned causal mask and sequence tails, for both engines; KeyRows:
// the block's rows are keys (dk/dv), else queries
template <bool KeyRows>
struct CausalMask {
  int nc, coff, causal;
  __device__ void load_cols(uint32_t, int) const {}
  __device__ void rows(int, int, int) {}
  template <int R>
  __device__ void rows(int, const int (&)[R]) {}
  __device__ bool interior(int r0, int c0, const int*) const {
    if (c0 + ptt::tc::kN > nc) return false;
    if (!causal) return true;
    return KeyRows ? r0 + ptt::tc::kM - 1 <= c0 + coff
                   : c0 + ptt::tc::kN - 1 <= r0 + coff;
  }
  __device__ bool live(int, int row, int, int col, const int*) const {
    return col < nc &&
           (!causal || (KeyRows ? row <= col + coff : col <= row + coff));
  }
};

// ---------------------------------------------------------------------------
// float32: the FMA engine (flash_f32.cuh)
// ---------------------------------------------------------------------------

// a block owns HB query heads of one GQA group (2 where the group size is
// even): grid (batch * H / HB, q tiles)
template <int D, int HB>
__global__ void __launch_bounds__(ptt::fa32::kThreads, 1) fwd_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
    Lay lq, Lay lk, Lay lv, Lay lo, int H, int KV, int Sq, int Sk, float scale,
    int causal) {
  extern __shared__ float4 f32_smem[];
  const int bi = blockIdx.x / (H / HB), h0 = blockIdx.x % (H / HB) * HB;
  const int kvh = h0 / (H / KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;  // longest rows first
  const int ntiles = (kv_horizon(q0, Sq, Sk, causal) + kChunk - 1) / kChunk;
  ptt::fa32::fwd_body<D, HB>(
      q + bi * lq.b + h0 * lq.h, lq.s, lq.h, k + bi * lk.b + kvh * lk.h,
      lk.s, v + bi * lv.b + kvh * lv.h, lv.s, o + bi * lo.b + h0 * lo.h,
      lo.s, lo.h, lse + (static_cast<long long>(bi) * H + h0) * Sq, Sq, q0,
      Sq, Sk, 0, ntiles, scale, CausalMask<false>{Sk, Sk - Sq, causal},
      reinterpret_cast<float*>(f32_smem));
}

template <int D>
__global__ void __launch_bounds__(ptt::fa32::kThreads, 1) dq_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dq, Lay lq, Lay lk, Lay lv, Lay ldo, Lay ldq, int H,
    int KV, int Sq, int Sk, float scale, int causal) {
  extern __shared__ float4 f32_smem[];
  const int bh = blockIdx.x;
  const int bi = bh / H, hi = bh % H, kvh = hi / (H / KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;
  const int ntiles = (kv_horizon(q0, Sq, Sk, causal) + kChunk - 1) / kChunk;
  const long long row0 = static_cast<long long>(bh) * Sq;
  ptt::fa32::dq_body<D>(
      q + bi * lq.b + hi * lq.h, lq.s, k + bi * lk.b + kvh * lk.h, lk.s,
      v + bi * lv.b + kvh * lv.h, lv.s, dout + bi * ldo.b + hi * ldo.h,
      ldo.s, lse + row0, delta + row0, dq + bi * ldq.b + hi * ldq.h, ldq.s,
      q0, Sq, Sk, 0, ntiles, scale, CausalMask<false>{Sk, Sk - Sq, causal},
      reinterpret_cast<float*>(f32_smem));
}

template <int D>
__global__ void __launch_bounds__(ptt::fa32::kThreads, 1) dkv_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dk, float* __restrict__ dv, Lay lq, Lay lk, Lay lv,
    Lay ldo, Lay ldk, Lay ldv, int H, int KV, int Sq, int Sk, float scale,
    int causal) {
  extern __shared__ float4 f32_smem[];
  const int G = H / KV;
  const int bi = blockIdx.x / KV, kvh = blockIdx.x % KV;
  const int k0 = blockIdx.y * kRows;  // the first k tiles see the most rows
  const int coff = Sk - Sq;
  // the first q tile whose last row sees this block's first key
  int qstart = 0;
  if (causal) {
    const int x = k0 - coff - (kChunk - 1);
    qstart = x <= 0 ? 0 : (x + kChunk - 1) / kChunk * kChunk;
  }
  const int per = qstart < Sq ? (Sq - qstart + kChunk - 1) / kChunk : 0;
  const int h0 = kvh * G;
  ptt::fa32::dkv_body<D>(
      q + bi * lq.b + h0 * lq.h, lq.s, lq.h, k + bi * lk.b + kvh * lk.h,
      lk.s, v + bi * lv.b + kvh * lv.h, lv.s, dout + bi * ldo.b + h0 * ldo.h,
      ldo.s, ldo.h, lse + (static_cast<long long>(bi) * H + h0) * Sq,
      delta + (static_cast<long long>(bi) * H + h0) * Sq, Sq,
      dk + bi * ldk.b + kvh * ldk.h, ldk.s, dv + bi * ldv.b + kvh * ldv.h,
      ldv.s, k0, Sk, Sq, qstart, per, G, scale,
      CausalMask<true>{Sq, coff, causal}, reinterpret_cast<float*>(f32_smem));
}

// ---------------------------------------------------------------------------
// bfloat16: the tensor-core engine (flash_wgmma.cuh)
// ---------------------------------------------------------------------------

using ptt::tc::bf16;

template <int D>
__global__ void __launch_bounds__(ptt::tc::kThreads, 2) flash_tc_fwd(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, bf16* __restrict__ o,
    float* __restrict__ lse, Lay lq, Lay lk, Lay lv, Lay lo, int H, int KV,
    int Sq, int Sk, float scale, int causal) {
  extern __shared__ __align__(1024) uint8_t tc_smem[];
  const int bh = blockIdx.x;
  const int bi = bh / H, hi = bh % H, kvh = hi / (H / KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;  // longest rows first
  const int ntiles = (kv_horizon(q0, Sq, Sk, causal) + kChunk - 1) / kChunk;
  ptt::tc::fwd_body<D>(q + bi * lq.b + hi * lq.h, lq.s,
                       k + bi * lk.b + kvh * lk.h, lk.s,
                       v + bi * lv.b + kvh * lv.h, lv.s,
                       o + bi * lo.b + hi * lo.h, lo.s,
                       lse + static_cast<long long>(bh) * Sq, q0, Sq, Sk, 0,
                       ntiles, scale, CausalMask<false>{Sk, Sk - Sq, causal},
                       tc_smem);
}

template <int D>
__global__ void __launch_bounds__(ptt::tc::kThreads, 2) flash_tc_dq(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dq, Lay lq, Lay lk, Lay lv, Lay ldo, Lay ldq, int H,
    int KV, int Sq, int Sk, float scale, int causal) {
  extern __shared__ __align__(1024) uint8_t tc_smem[];
  const int bh = blockIdx.x;
  const int bi = bh / H, hi = bh % H, kvh = hi / (H / KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;
  const int ntiles = (kv_horizon(q0, Sq, Sk, causal) + kChunk - 1) / kChunk;
  const long long row0 = static_cast<long long>(bh) * Sq;
  ptt::tc::dq_body<D>(q + bi * lq.b + hi * lq.h, lq.s,
                      k + bi * lk.b + kvh * lk.h, lk.s,
                      v + bi * lv.b + kvh * lv.h, lv.s,
                      dout + bi * ldo.b + hi * ldo.h, ldo.s, lse + row0,
                      delta + row0, dq + bi * ldq.b + hi * ldq.h, ldq.s, q0,
                      Sq, Sk, 0, ntiles, scale,
                      CausalMask<false>{Sk, Sk - Sq, causal}, tc_smem);
}

template <int D>
__global__ void __launch_bounds__(ptt::tc::kThreads, 2) flash_tc_dkv(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dk, bf16* __restrict__ dv, Lay lq, Lay lk, Lay lv,
    Lay ldo, Lay ldk, Lay ldv, int H, int KV, int Sq, int Sk, float scale,
    int causal) {
  extern __shared__ __align__(1024) uint8_t tc_smem[];
  const int G = H / KV;
  const int bk = blockIdx.x;
  const int bi = bk / KV, kvh = bk % KV;
  const int k0 = blockIdx.y * kRows;  // the first k tiles see the most rows
  const int coff = Sk - Sq;
  // the first q tile whose last row sees this block's first key
  int qstart = 0;
  if (causal) {
    const int x = k0 - coff - (kChunk - 1);
    qstart = x <= 0 ? 0 : (x + kChunk - 1) / kChunk * kChunk;
  }
  const int per = qstart < Sq ? (Sq - qstart + kChunk - 1) / kChunk : 0;
  const int h0 = kvh * G;
  ptt::tc::dkv_body<D>(
      q + bi * lq.b + h0 * lq.h, lq.s, lq.h, k + bi * lk.b + kvh * lk.h,
      lk.s, v + bi * lv.b + kvh * lv.h, lv.s, dout + bi * ldo.b + h0 * ldo.h,
      ldo.s, ldo.h, lse + (static_cast<long long>(bi) * H + h0) * Sq,
      delta + (static_cast<long long>(bi) * H + h0) * Sq, Sq,
      dk + bi * ldk.b + kvh * ldk.h, ldk.s, dv + bi * ldv.b + kvh * ldv.h,
      ldv.s, k0, Sk, Sq, qstart, per, G, scale,
      CausalMask<true>{Sq, coff, causal}, tc_smem);
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

Lay lay_at(const long long* s, int i) {
  return Lay{s[3 * i], s[3 * i + 1], s[3 * i + 2]};
}

template <int D, int HB>
int launch_fwd(const void* q, const void* k, const void* v, void* o,
               void* lse, const long long* st, int B, int H, int KV, int Sq,
               int Sk, float scale, int causal, cudaStream_t stream) {
  auto kern = fwd_kernel<D, HB>;
  constexpr int smem = ptt::fa32::fwd_smem<D, HB>();
  PTT_SET_SMEM(kern, smem);
  dim3 grid(B * H / HB, (Sq + kRows - 1) / kRows);
  kern<<<grid, ptt::fa32::kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(lse), lay_at(st, 0), lay_at(st, 1), lay_at(st, 2),
      lay_at(st, 3), H, KV, Sq, Sk, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq,
              const long long* st, int B, int H, int KV, int Sq, int Sk,
              float scale, int causal, cudaStream_t stream) {
  auto kern = dq_kernel<D>;
  constexpr int smem = ptt::fa32::dq_smem<D>();
  PTT_SET_SMEM(kern, smem);
  dim3 grid(B * H, (Sq + kRows - 1) / kRows);
  kern<<<grid, ptt::fa32::kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dq), lay_at(st, 0), lay_at(st, 1), lay_at(st, 2),
      lay_at(st, 3), lay_at(st, 4), H, KV, Sq, Sk, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv,
               const long long* st, int B, int H, int KV, int Sq, int Sk,
               float scale, int causal, cudaStream_t stream) {
  auto kern = dkv_kernel<D>;
  constexpr int smem = ptt::fa32::dkv_smem<D>();
  PTT_SET_SMEM(kern, smem);
  dim3 grid(B * KV, (Sk + kRows - 1) / kRows);
  kern<<<grid, ptt::fa32::kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dk), static_cast<float*>(dv), lay_at(st, 0),
      lay_at(st, 1), lay_at(st, 2), lay_at(st, 3), lay_at(st, 4),
      lay_at(st, 5), H, KV, Sq, Sk, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_fwd_tc(const void* q, const void* k, const void* v, void* o,
                  void* lse, const long long* st, int B, int H, int KV,
                  int Sq, int Sk, float scale, int causal,
                  cudaStream_t stream) {
  auto kern = flash_tc_fwd<D>;
  constexpr int smem = ptt::tc::fwd_smem<D>();
  PTT_SET_SMEM(kern, smem);
  dim3 grid(B * H, (Sq + kRows - 1) / kRows);
  kern<<<grid, ptt::tc::kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o),
      static_cast<float*>(lse), lay_at(st, 0), lay_at(st, 1), lay_at(st, 2),
      lay_at(st, 3), H, KV, Sq, Sk, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dq_tc(const void* q, const void* k, const void* v,
                 const void* dout, const void* lse, const void* delta,
                 void* dq, const long long* st, int B, int H, int KV, int Sq,
                 int Sk, float scale, int causal, cudaStream_t stream) {
  auto kern = flash_tc_dq<D>;
  constexpr int smem = ptt::tc::dq_smem<D>();
  PTT_SET_SMEM(kern, smem);
  dim3 grid(B * H, (Sq + kRows - 1) / kRows);
  kern<<<grid, ptt::tc::kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dq), lay_at(st, 0), lay_at(st, 1), lay_at(st, 2),
      lay_at(st, 3), lay_at(st, 4), H, KV, Sq, Sk, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dkv_tc(const void* q, const void* k, const void* v,
                  const void* dout, const void* lse, const void* delta,
                  void* dk, void* dv, const long long* st, int B, int H,
                  int KV, int Sq, int Sk, float scale, int causal,
                  cudaStream_t stream) {
  auto kern = flash_tc_dkv<D>;
  constexpr int smem = ptt::tc::dkv_smem<D>();
  PTT_SET_SMEM(kern, smem);
  dim3 grid(B * KV, (Sk + kRows - 1) / kRows);
  kern<<<grid, ptt::tc::kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), lay_at(st, 0),
      lay_at(st, 1), lay_at(st, 2), lay_at(st, 3), lay_at(st, 4),
      lay_at(st, 5), H, KV, Sq, Sk, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// `strides` is a host array of three element strides (batch, head, seq)
// per tensor, in argument order; dtype codes as PTT_DISPATCH.
extern "C" int ptt_flash_fwd(const void* q, const void* k, const void* v,
                             void* o, void* lse, const long long* strides,
                             int B, int H, int KV, int Sq, int Sk, int D,
                             float scale, int causal, int dtype,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PTT_FWD(DD)                                                        \
  (H / KV % 2 == 0                                                         \
       ? launch_fwd<DD, 2>(q, k, v, o, lse, strides, B, H, KV, Sq, Sk,    \
                           scale, causal, s)                               \
       : launch_fwd<DD, 1>(q, k, v, o, lse, strides, B, H, KV, Sq, Sk,    \
                           scale, causal, s))
#define PTT_FWD_TC(DD)                                                     \
  launch_fwd_tc<DD>(q, k, v, o, lse, strides, B, H, KV, Sq, Sk, scale, \
                    causal, s)
  PTT_DISPATCH(PTT_FWD, PTT_FWD_TC);
#undef PTT_FWD
#undef PTT_FWD_TC
}

extern "C" int ptt_flash_dq(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, void* dq,
                            const long long* strides, int B, int H, int KV,
                            int Sq, int Sk, int D, float scale, int causal,
                            int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PTT_DQ(DD)                                                       \
  launch_dq<DD>(q, k, v, dout, lse, delta, dq, strides, B, H, KV, Sq, Sk, \
                scale, causal, s)
#define PTT_DQ_TC(DD)                                                      \
  launch_dq_tc<DD>(q, k, v, dout, lse, delta, dq, strides, B, H, KV, Sq, \
                   Sk, scale, causal, s)
  PTT_DISPATCH(PTT_DQ, PTT_DQ_TC);
#undef PTT_DQ
#undef PTT_DQ_TC
}

extern "C" int ptt_flash_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, void* dk, void* dv,
                             const long long* strides, int B, int H, int KV,
                             int Sq, int Sk, int D, float scale, int causal,
                             int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PTT_DKV(DD)                                                      \
  launch_dkv<DD>(q, k, v, dout, lse, delta, dk, dv, strides, B, H, KV, Sq, \
                 Sk, scale, causal, s)
#define PTT_DKV_TC(DD)                                                    \
  launch_dkv_tc<DD>(q, k, v, dout, lse, delta, dk, dv, strides, B, H, KV, \
                    Sq, Sk, scale, causal, s)
  PTT_DISPATCH(PTT_DKV, PTT_DKV_TC);
#undef PTT_DKV
#undef PTT_DKV_TC
}
