// Packed (varlen) flash attention on Hopper: forward, dq and dk/dv kernels.
//
// Replaces paddle_tpu/ops/kernels/pallas/flash_varlen.py (`_fwd_kernel` via
// `_varlen_fwd_impl`, `_dq_kernel` and `_dkv_kernel` via `_varlen_bwd`).
// Sequences stay concatenated: q is [Tq, heads, head_dim], k and v are
// [Tk, kv_heads, head_dim], addressed through element strides (token,
// head; head_dim contiguous), so no transposed or padded copy is made. lse
// and delta are float32 [heads, Tq].
//
// The mask is per segment, causal top-left inside each segment: query t
// sees key u iff seg_k[u] == seg_q[t] and (not causal or pos_k[u] <=
// pos_q[t]), from per-token segment ids and positions that the wrapper
// derives from cu_seqlens on the device. Those arrays are padded to a
// multiple of 64 with ids that match nothing, so the mask also covers the
// tail tile (whose rows load as zeros and are never written).
//
// Block skip: the wrapper turns the segment ranges of the 64-token blocks
// into loop bounds, on the device: a q block walks only the k blocks whose
// segment range overlaps its own (under causal self packing none past its
// diagonal), a k block only the q blocks that overlap it. So the work
// follows the sum over documents of len^2 (len^2 / 2 causal), not T^2.
//
// Every block owns 64 rows and loops over 64-position chunks of the other
// side; nothing carries between blocks (no atomics, the same result run to
// run):
//   forward  block (q block, head):    online softmax over its k blocks;
//   dq       block (q block, head):    p = exp(s - lse), ds = p * (dp -
//            delta), dq += ds.K;
//   dk/dv    block (k block, kv head): loops the G query heads of its GQA
//            group and their q blocks, dv += p^T.dO, dk += ds^T.Q.
// A row with no live key gets out 0 and lse -1e30; p is 0 wherever the mask
// is false (selected, never multiplied), so such rows give zero grads.
//
// What bounds it: operations (4·d flops per live (query, key) pair and
// head in the forward, against a few hundred bytes per token: at the
// seed's 16384-token pack, 32/8 heads, d 128, causal, 12.7 M live pairs
// per head, the forward's 208 GFLOP take 0.21 ms at 989 TFLOP/s bf16,
// 3.1 ms at 67 TFLOP/s float32).
//
// bfloat16 (varlen_tc_fwd, varlen_tc_dq, varlen_tc_dkv) runs on the tensor
// cores through the engine of flash_wgmma.cuh, as the flash kernels do;
// the mask is a policy over the segment ids and positions (SegMask): a
// tile whose rows and columns all lie in one segment (and, causal, wholly
// below the diagonal) skips the per-element test. Each grid walks its
// blocks in the order the wrapper gives (longest run over the other side
// first), so the grid's tail is short.
//
// float32 (fwd_kernel, dq_kernel, dkv_kernel) runs the same three bodies
// on the CUDA cores through the FMA engine of flash_f32.cuh (full float32
// FMA on register tiles, tiles streamed by cp.async, a forward block over
// two query heads of a GQA group), with the same segment mask policy (four
// rows a thread there, two in the bf16 engine), the same loop bounds and
// the same block order.

#include "flash_f32.cuh"
#include "flash_wgmma.cuh"

namespace {

constexpr int kRows = ptt::tc::kM;    // tokens of a block
constexpr int kChunk = ptt::tc::kN;   // tokens of a streamed tile
static_assert(kRows == kChunk && ptt::fa32::kM == kRows &&
                  ptt::fa32::kN == kChunk,
              "q and k blocks share one size in both engines");

using ptt::tc::kColWords;

struct Lay {  // element strides of a [tokens, heads, head_dim] tensor
  long long t, h;
};

// the per-segment mask over padded segment ids and positions, for both
// engines; KeyRows: the block's rows are keys (dk/dv), else queries; R:
// rows a thread (2 in the bf16 engine, 4 in the float32 one). A column
// tile's ids and positions are the tile's column words (2 x 64 ints).
template <bool KeyRows, int R = 2>
struct SegMask {
  const int *segr, *posr, *segc, *posc;
  int causal;
  int seg_r[R], pos_r[R];                      // this thread's rows
  int seg_lo, seg_hi, pos_first, pos_last;     // the block's rows
  // by threads below 128
  __device__ void load_cols(uint32_t dst, int c0) const {
    const int t = threadIdx.x;
    if (t < 64)
      ptt::tc::load_words(dst, segc, c0, c0 + 64, t);
    else
      ptt::tc::load_words(dst + kColWords * 4, posc, c0, c0 + 64, t - 64);
  }
  __device__ void rows(int r0, int ra, int rb) {  // the bf16 engine's two
    seg_r[0] = segr[ra];
    seg_r[1] = segr[rb];
    pos_r[0] = posr[ra];
    pos_r[1] = posr[rb];
    block_rows(r0);
  }
  __device__ void rows(int r0, const int (&r)[R]) {  // the float32 one's R
#pragma unroll
    for (int i = 0; i < R; ++i) {
      seg_r[i] = segr[r[i]];
      pos_r[i] = posr[r[i]];
    }
    block_rows(r0);
  }
  __device__ void block_rows(int r0) {
    seg_lo = segr[r0];
    seg_hi = segr[r0 + ptt::tc::kM - 1];
    pos_first = posr[r0];
    pos_last = posr[r0 + ptt::tc::kM - 1];
  }
  // one segment on both sides (ids are non-decreasing) and, causal, every
  // key at or before every query
  __device__ bool interior(int, int, const int* cols) const {
    const int* pc = cols + kColWords;
    if (seg_lo != seg_hi || cols[0] != cols[63] || cols[0] != seg_lo)
      return false;
    return !causal || (KeyRows ? pos_last <= pc[0] : pc[63] <= pos_first);
  }
  __device__ bool live(int h, int, int cl, int, const int* cols) const {
    const int pc = cols[kColWords + cl];
    return seg_r[h] == cols[cl] &&
           (!causal || (KeyRows ? pos_r[h] <= pc : pc <= pos_r[h]));
  }
};

// ---------------------------------------------------------------------------
// float32: the FMA engine (flash_f32.cuh)
// ---------------------------------------------------------------------------

// a block owns HB query heads of one GQA group (2 where the group size is
// even): grid (q blocks, H / HB)
template <int D, int HB>
__global__ void __launch_bounds__(ptt::fa32::kThreads, 1) fwd_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
    const int* __restrict__ segq, const int* __restrict__ posq,
    const int* __restrict__ segk, const int* __restrict__ posk,
    const int* __restrict__ bounds, const int* __restrict__ order, Lay lq,
    Lay lk, Lay lv, Lay lo, int H, int KV, int Tq, int Tk, int nq, float scale,
    int causal) {
  extern __shared__ float4 f32_smem[];
  const int iq = order[blockIdx.x], h0 = blockIdx.y * HB;
  const int kvh = h0 / (H / KV);
  const int j0 = bounds[iq], ntiles = max(0, bounds[nq + iq] - j0 + 1);
  ptt::fa32::fwd_body<D, HB>(
      q + h0 * lq.h, lq.t, lq.h, k + kvh * lk.h, lk.t, v + kvh * lv.h, lv.t,
      o + h0 * lo.h, lo.t, lo.h, lse + static_cast<long long>(h0) * Tq, Tq,
      iq * kRows, Tq, Tk, j0 * kChunk, ntiles, scale,
      SegMask<false, 4>{segq, posq, segk, posk, causal},
      reinterpret_cast<float*>(f32_smem));
}

template <int D>
__global__ void __launch_bounds__(ptt::fa32::kThreads, 1) dq_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dq, const int* __restrict__ segq,
    const int* __restrict__ posq, const int* __restrict__ segk,
    const int* __restrict__ posk, const int* __restrict__ bounds,
    const int* __restrict__ order, Lay lq, Lay lk, Lay lv, Lay ldo, Lay ldq,
    int H, int KV, int Tq, int Tk, int nq, float scale, int causal) {
  extern __shared__ float4 f32_smem[];
  const int iq = order[blockIdx.x], hi = blockIdx.y, kvh = hi / (H / KV);
  const int j0 = bounds[iq], ntiles = max(0, bounds[nq + iq] - j0 + 1);
  const long long row0 = static_cast<long long>(hi) * Tq;
  ptt::fa32::dq_body<D>(
      q + hi * lq.h, lq.t, k + kvh * lk.h, lk.t, v + kvh * lv.h, lv.t,
      dout + hi * ldo.h, ldo.t, lse + row0, delta + row0, dq + hi * ldq.h,
      ldq.t, iq * kRows, Tq, Tk, j0 * kChunk, ntiles, scale,
      SegMask<false, 4>{segq, posq, segk, posk, causal},
      reinterpret_cast<float*>(f32_smem));
}

template <int D>
__global__ void __launch_bounds__(ptt::fa32::kThreads, 1) dkv_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dk, float* __restrict__ dv,
    const int* __restrict__ segq, const int* __restrict__ posq,
    const int* __restrict__ segk, const int* __restrict__ posk,
    const int* __restrict__ bounds, const int* __restrict__ order, Lay lq,
    Lay lk, Lay lv, Lay ldo, Lay ldk, Lay ldv, int H, int KV, int Tq, int Tk,
    int nk, float scale, int causal) {
  extern __shared__ float4 f32_smem[];
  const int G = H / KV;
  const int jk = order[blockIdx.x], kvh = blockIdx.y, h0 = kvh * G;
  const int i0 = bounds[jk], per = max(0, bounds[nk + jk] - i0 + 1);
  const long long row0 = static_cast<long long>(h0) * Tq;
  ptt::fa32::dkv_body<D>(
      q + h0 * lq.h, lq.t, lq.h, k + kvh * lk.h, lk.t, v + kvh * lv.h, lv.t,
      dout + h0 * ldo.h, ldo.t, ldo.h, lse + row0, delta + row0, Tq,
      dk + kvh * ldk.h, ldk.t, dv + kvh * ldv.h, ldv.t, jk * kRows, Tk, Tq,
      i0 * kChunk, per, G, scale,
      SegMask<true, 4>{segk, posk, segq, posq, causal},
      reinterpret_cast<float*>(f32_smem));
}

// ---------------------------------------------------------------------------
// bfloat16: the tensor-core engine (flash_wgmma.cuh)
// ---------------------------------------------------------------------------

using ptt::tc::bf16;

template <int D>
__global__ void __launch_bounds__(ptt::tc::kThreads, 2) varlen_tc_fwd(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, bf16* __restrict__ o,
    float* __restrict__ lse, const int* __restrict__ segq,
    const int* __restrict__ posq, const int* __restrict__ segk,
    const int* __restrict__ posk, const int* __restrict__ bounds,
    const int* __restrict__ order, Lay lq, Lay lk, Lay lv, Lay lo, int H,
    int KV, int Tq, int Tk, int nq, float scale, int causal) {
  extern __shared__ __align__(1024) uint8_t tc_smem[];
  const int iq = order[blockIdx.x], hi = blockIdx.y, kvh = hi / (H / KV);
  const int j0 = bounds[iq], ntiles = max(0, bounds[nq + iq] - j0 + 1);
  ptt::tc::fwd_body<D>(
      q + hi * lq.h, lq.t, k + kvh * lk.h, lk.t, v + kvh * lv.h, lv.t,
      o + hi * lo.h, lo.t, lse + static_cast<long long>(hi) * Tq, iq * kRows,
      Tq, Tk, j0 * kChunk, ntiles, scale,
      SegMask<false>{segq, posq, segk, posk, causal}, tc_smem);
}

template <int D>
__global__ void __launch_bounds__(ptt::tc::kThreads, 2) varlen_tc_dq(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dq, const int* __restrict__ segq,
    const int* __restrict__ posq, const int* __restrict__ segk,
    const int* __restrict__ posk, const int* __restrict__ bounds,
    const int* __restrict__ order, Lay lq, Lay lk, Lay lv, Lay ldo, Lay ldq,
    int H, int KV, int Tq, int Tk, int nq, float scale, int causal) {
  extern __shared__ __align__(1024) uint8_t tc_smem[];
  const int iq = order[blockIdx.x], hi = blockIdx.y, kvh = hi / (H / KV);
  const int j0 = bounds[iq], ntiles = max(0, bounds[nq + iq] - j0 + 1);
  const long long row0 = static_cast<long long>(hi) * Tq;
  ptt::tc::dq_body<D>(
      q + hi * lq.h, lq.t, k + kvh * lk.h, lk.t, v + kvh * lv.h, lv.t,
      dout + hi * ldo.h, ldo.t, lse + row0, delta + row0, dq + hi * ldq.h,
      ldq.t, iq * kRows, Tq, Tk, j0 * kChunk, ntiles, scale,
      SegMask<false>{segq, posq, segk, posk, causal}, tc_smem);
}

template <int D>
__global__ void __launch_bounds__(ptt::tc::kThreads, 2) varlen_tc_dkv(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dk, bf16* __restrict__ dv,
    const int* __restrict__ segq, const int* __restrict__ posq,
    const int* __restrict__ segk, const int* __restrict__ posk,
    const int* __restrict__ bounds, const int* __restrict__ order, Lay lq,
    Lay lk, Lay lv, Lay ldo, Lay ldk, Lay ldv, int H, int KV, int Tq, int Tk,
    int nk, float scale, int causal) {
  extern __shared__ __align__(1024) uint8_t tc_smem[];
  const int G = H / KV;
  const int jk = order[blockIdx.x], kvh = blockIdx.y, h0 = kvh * G;
  const int i0 = bounds[jk], per = max(0, bounds[nk + jk] - i0 + 1);
  const long long row0 = static_cast<long long>(h0) * Tq;
  ptt::tc::dkv_body<D>(
      q + h0 * lq.h, lq.t, lq.h, k + kvh * lk.h, lk.t, v + kvh * lv.h, lv.t,
      dout + h0 * ldo.h, ldo.t, ldo.h, lse + row0, delta + row0, Tq,
      dk + kvh * ldk.h, ldk.t, dv + kvh * ldv.h, ldv.t, jk * kRows, Tk, Tq,
      i0 * kChunk, per, G, scale,
      SegMask<true>{segk, posk, segq, posq, causal}, tc_smem);
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

Lay lay_at(const long long* s, int i) { return Lay{s[2 * i], s[2 * i + 1]}; }

struct Segs {  // per-token segment ids and positions, the loop bounds and
              // the order of the kernel's own blocks
  const int *segq, *posq, *segk, *posk, *bounds, *order;
};

int blocks(int n) { return (n + kRows - 1) / kRows; }

template <int D, int HB>
int launch_fwd(const void* q, const void* k, const void* v, void* o,
               void* lse, Segs sg, const long long* st, int H, int KV,
               int Tq, int Tk, float scale, int causal, cudaStream_t stream) {
  auto kern = fwd_kernel<D, HB>;
  constexpr int smem = ptt::fa32::fwd_smem<D, HB>();
  PTT_SET_SMEM(kern, smem);
  const int nq = blocks(Tq);
  kern<<<dim3(nq, H / HB), ptt::fa32::kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(lse), sg.segq, sg.posq, sg.segk, sg.posk,
      sg.bounds, sg.order, lay_at(st, 0), lay_at(st, 1), lay_at(st, 2),
      lay_at(st, 3), H, KV, Tq, Tk, nq, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, Segs sg,
              const long long* st, int H, int KV, int Tq, int Tk, float scale,
              int causal, cudaStream_t stream) {
  auto kern = dq_kernel<D>;
  constexpr int smem = ptt::fa32::dq_smem<D>();
  PTT_SET_SMEM(kern, smem);
  const int nq = blocks(Tq);
  kern<<<dim3(nq, H), ptt::fa32::kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dq), sg.segq, sg.posq, sg.segk, sg.posk, sg.bounds,
      sg.order, lay_at(st, 0), lay_at(st, 1), lay_at(st, 2), lay_at(st, 3),
      lay_at(st, 4), H, KV, Tq, Tk, nq, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv,
               Segs sg, const long long* st, int H, int KV, int Tq, int Tk,
               float scale, int causal, cudaStream_t stream) {
  auto kern = dkv_kernel<D>;
  constexpr int smem = ptt::fa32::dkv_smem<D>();
  PTT_SET_SMEM(kern, smem);
  const int nk = blocks(Tk);
  kern<<<dim3(nk, KV), ptt::fa32::kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dk), static_cast<float*>(dv), sg.segq, sg.posq,
      sg.segk, sg.posk, sg.bounds, sg.order, lay_at(st, 0), lay_at(st, 1),
      lay_at(st, 2), lay_at(st, 3), lay_at(st, 4), lay_at(st, 5), H, KV, Tq,
      Tk, nk, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_fwd_tc(const void* q, const void* k, const void* v, void* o,
                  void* lse, Segs sg, const long long* st, int H, int KV,
                  int Tq, int Tk, float scale, int causal,
                  cudaStream_t stream) {
  auto kern = varlen_tc_fwd<D>;
  constexpr int smem = ptt::tc::fwd_smem<D>();
  PTT_SET_SMEM(kern, smem);
  const int nq = blocks(Tq);
  kern<<<dim3(nq, H), ptt::tc::kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o),
      static_cast<float*>(lse), sg.segq, sg.posq, sg.segk, sg.posk,
      sg.bounds, sg.order, lay_at(st, 0), lay_at(st, 1), lay_at(st, 2),
      lay_at(st, 3), H, KV, Tq, Tk, nq, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dq_tc(const void* q, const void* k, const void* v,
                 const void* dout, const void* lse, const void* delta,
                 void* dq, Segs sg, const long long* st, int H, int KV,
                 int Tq, int Tk, float scale, int causal,
                 cudaStream_t stream) {
  auto kern = varlen_tc_dq<D>;
  constexpr int smem = ptt::tc::dq_smem<D>();
  PTT_SET_SMEM(kern, smem);
  const int nq = blocks(Tq);
  kern<<<dim3(nq, H), ptt::tc::kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dq), sg.segq, sg.posq, sg.segk, sg.posk, sg.bounds,
      sg.order, lay_at(st, 0), lay_at(st, 1), lay_at(st, 2), lay_at(st, 3),
      lay_at(st, 4), H, KV, Tq, Tk, nq, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dkv_tc(const void* q, const void* k, const void* v,
                  const void* dout, const void* lse, const void* delta,
                  void* dk, void* dv, Segs sg, const long long* st, int H,
                  int KV, int Tq, int Tk, float scale, int causal,
                  cudaStream_t stream) {
  auto kern = varlen_tc_dkv<D>;
  constexpr int smem = ptt::tc::dkv_smem<D>();
  PTT_SET_SMEM(kern, smem);
  const int nk = blocks(Tk);
  kern<<<dim3(nk, KV), ptt::tc::kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), sg.segq, sg.posq,
      sg.segk, sg.posk, sg.bounds, sg.order, lay_at(st, 0), lay_at(st, 1),
      lay_at(st, 2), lay_at(st, 3), lay_at(st, 4), lay_at(st, 5), H, KV, Tq,
      Tk, nk, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// `segs` points at six device arrays: seg_q, pos_q (padded to a multiple
// of 64 tokens), seg_k, pos_k (likewise), the int32 loop bounds [2, n]
// (first and last block of the other side) of the kernel's own blocks, and
// the order [n] in which the kernels walk those blocks.
// `strides` is a host array of two element strides (token, head) per
// tensor, in argument order; dtype codes as PTT_DISPATCH.
extern "C" int ptt_varlen_fwd(const void* q, const void* k, const void* v,
                              void* o, void* lse, const void* const* segs,
                              const long long* strides, int H, int KV,
                              int Tq, int Tk, int D, float scale, int causal,
                              int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Segs sg{static_cast<const int*>(segs[0]),
                static_cast<const int*>(segs[1]),
                static_cast<const int*>(segs[2]),
                static_cast<const int*>(segs[3]),
                static_cast<const int*>(segs[4]),
                static_cast<const int*>(segs[5])};
#define PTT_FWD(DD)                                                      \
  (H / KV % 2 == 0                                                       \
       ? launch_fwd<DD, 2>(q, k, v, o, lse, sg, strides, H, KV, Tq, Tk, \
                           scale, causal, s)                             \
       : launch_fwd<DD, 1>(q, k, v, o, lse, sg, strides, H, KV, Tq, Tk, \
                           scale, causal, s))
#define PTT_FWD_TC(DD)                                                    \
  launch_fwd_tc<DD>(q, k, v, o, lse, sg, strides, H, KV, Tq, Tk, scale, \
                    causal, s)
  PTT_DISPATCH(PTT_FWD, PTT_FWD_TC);
#undef PTT_FWD
#undef PTT_FWD_TC
}

extern "C" int ptt_varlen_dq(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, void* dq,
                             const void* const* segs,
                             const long long* strides, int H, int KV, int Tq,
                             int Tk, int D, float scale, int causal,
                             int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Segs sg{static_cast<const int*>(segs[0]),
                static_cast<const int*>(segs[1]),
                static_cast<const int*>(segs[2]),
                static_cast<const int*>(segs[3]),
                static_cast<const int*>(segs[4]),
                static_cast<const int*>(segs[5])};
#define PTT_DQ(DD)                                                        \
  launch_dq<DD>(q, k, v, dout, lse, delta, dq, sg, strides, H, KV, Tq, Tk, \
                scale, causal, s)
#define PTT_DQ_TC(DD)                                                       \
  launch_dq_tc<DD>(q, k, v, dout, lse, delta, dq, sg, strides, H, KV, Tq, \
                   Tk, scale, causal, s)
  PTT_DISPATCH(PTT_DQ, PTT_DQ_TC);
#undef PTT_DQ
#undef PTT_DQ_TC
}

extern "C" int ptt_varlen_dkv(const void* q, const void* k, const void* v,
                              const void* dout, const void* lse,
                              const void* delta, void* dk, void* dv,
                              const void* const* segs,
                              const long long* strides, int H, int KV,
                              int Tq, int Tk, int D, float scale, int causal,
                              int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Segs sg{static_cast<const int*>(segs[0]),
                static_cast<const int*>(segs[1]),
                static_cast<const int*>(segs[2]),
                static_cast<const int*>(segs[3]),
                static_cast<const int*>(segs[4]),
                static_cast<const int*>(segs[5])};
#define PTT_DKV(DD)                                                      \
  launch_dkv<DD>(q, k, v, dout, lse, delta, dk, dv, sg, strides, H, KV, \
                 Tq, Tk, scale, causal, s)
#define PTT_DKV_TC(DD)                                                     \
  launch_dkv_tc<DD>(q, k, v, dout, lse, delta, dk, dv, sg, strides, H, KV, \
                    Tq, Tk, scale, causal, s)
  PTT_DISPATCH(PTT_DKV, PTT_DKV_TC);
#undef PTT_DKV
#undef PTT_DKV_TC
}
