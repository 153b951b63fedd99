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
// per head, the forward's 208 GFLOP take 0.21 ms at 989 TFLOP/s bf16).
//
// bfloat16 (varlen_tc_fwd, varlen_tc_dq, varlen_tc_dkv) runs on the tensor
// cores through the engine of flash_wgmma.cuh, as the flash kernels do;
// the mask is a policy over the segment ids and positions (SegMask): a
// tile whose rows and columns all lie in one segment (and, causal, wholly
// below the diagonal) skips the per-element test. Each grid walks its
// blocks in the order the wrapper gives (longest run over the other side
// first), so the grid's tail is short.
//
// float32 keeps the first design: float32 on the CUDA cores with
// synchronous loads (fwd_kernel, dq_kernel, dkv_kernel).

#include "flash_tiles.cuh"
#include "flash_wgmma.cuh"

namespace {

using ptt::cols_times_rows;
using ptt::cols_times_tile;
using ptt::dq_smem;
using ptt::from_f32;
using ptt::fwd_smem;
using ptt::kChunk;
using ptt::kNeg;
using ptt::kPad;
using ptt::kRows;
using ptt::kRowsPerWarp;
using ptt::kThreads;
using ptt::load_tile;
using ptt::rows_dot_cols;
using ptt::warp_max;
using ptt::warp_sum;

static_assert(kRows == kChunk, "q and k blocks share one size");

struct Lay {  // element strides of a [tokens, heads, head_dim] tensor
  long long t, h;
};

// the per-segment mask of one (row, column) pair
__device__ __forceinline__ bool live(int seg_r, int pos_r, int seg_c,
                                     int pos_c, int causal) {
  return seg_r == seg_c && (!causal || pos_c <= pos_r);
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

// two blocks per SM (its shared memory allows it at D 128): the rows'
// segment ids and positions sit in shared memory, not registers
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 2) fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, float* __restrict__ lse, const int* __restrict__ segq,
    const int* __restrict__ posq, const int* __restrict__ segk,
    const int* __restrict__ posk, const int* __restrict__ bounds, Lay lq,
    Lay lk, Lay lv, Lay lo, int H, int KV, int Tq, int Tk, int nq,
    float scale, int causal) {
  constexpr int DL = D / 32;
  extern __shared__ float smem[];
  float* Qs = smem;               // [kRows][D]
  float* Kt = Qs + kRows * D;     // [D][kPad]
  float* Vs = Kt + D * kPad;      // [kChunk][D]
  __shared__ int sq[kRows], pq[kRows];

  const int iq = blockIdx.x, hi = blockIdx.y, kvh = hi / (H / KV);
  const int q0 = iq * kRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = warp * kRowsPerWarp;
  const T* kb = k + kvh * lk.h;
  const T* vb = v + kvh * lv.h;

  load_tile<T, D>(q + hi * lq.h, lq.t, q0, Tq, Qs, false);
  if (threadIdx.x < kRows) {
    sq[threadIdx.x] = segq[q0 + threadIdx.x];
    pq[threadIdx.x] = posq[q0 + threadIdx.x];
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][DL];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = kNeg;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < DL; ++i) acc[r][i] = 0.f;
  }

  const int jhi = bounds[nq + iq];
  for (int j = bounds[iq]; j <= jhi; ++j) {
    const int c0 = j * kChunk;
    __syncthreads();  // previous chunk consumed (and the Q tile written)
    load_tile<T, D>(kb, lk.t, c0, Tk, Kt, true);
    load_tile<T, D>(vb, lv.t, c0, Tk, Vs, false);
    __syncthreads();

    int sk[2], pk[2];
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      sk[jj] = segk[c0 + lane + 32 * jj];
      pk[jj] = posk[c0 + lane + 32 * jj];
    }
    float s[kRowsPerWarp][2];
    rows_dot_cols<D>(Qs, Kt, r0, lane, s);
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      bool lv2[2];
      float sv[2];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        lv2[jj] = live(sq[r0 + r], pq[r0 + r], sk[jj], pk[jj], causal);
        sv[jj] = lv2[jj] ? s[r][jj] * scale : kNeg;
      }
      const float m_new = fmaxf(m[r], warp_max(fmaxf(sv[0], sv[1])));
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
        s[r][jj] = lv2[jj] ? expf(sv[jj] - m_new) : 0.f;
      const float alpha = expf(m[r] - m_new);
      l[r] = l[r] * alpha + warp_sum(s[r][0] + s[r][1]);
      m[r] = m_new;
#pragma unroll
      for (int i = 0; i < DL; ++i) acc[r][i] *= alpha;
    }
    cols_times_rows<D>(s, Vs, lane, acc);
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int qp = q0 + r0 + r;
    if (qp >= Tq) continue;
    const float denom = l[r] == 0.f ? 1.f : l[r];
    T* dst = o + hi * lo.h + static_cast<long long>(qp) * lo.t;
#pragma unroll
    for (int i = 0; i < DL; ++i)
      dst[lane + 32 * i] = from_f32<T>(acc[r][i] / denom);
    if (lane == 0)
      lse[static_cast<long long>(hi) * Tq + qp] =
          l[r] == 0.f ? kNeg : m[r] + logf(l[r]);
  }
}

// ---------------------------------------------------------------------------
// backward: dq
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dq,
    const int* __restrict__ segq, const int* __restrict__ posq,
    const int* __restrict__ segk, const int* __restrict__ posk,
    const int* __restrict__ bounds, Lay lq, Lay lk, Lay lv, Lay ldo,
    Lay ldq, int H, int KV, int Tq, int Tk, int nq, float scale, int causal) {
  constexpr int DL = D / 32;
  extern __shared__ float smem[];
  float* Qs = smem;               // [kRows][D]
  float* dOs = Qs + kRows * D;    // [kRows][D]
  float* Kt = dOs + kRows * D;    // [D][kPad]
  float* Vt = Kt + D * kPad;      // [D][kPad]

  const int iq = blockIdx.x, hi = blockIdx.y, kvh = hi / (H / KV);
  const int q0 = iq * kRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = warp * kRowsPerWarp;
  const T* kb = k + kvh * lk.h;
  const T* vb = v + kvh * lv.h;

  load_tile<T, D>(q + hi * lq.h, lq.t, q0, Tq, Qs, false);
  load_tile<T, D>(dout + hi * ldo.h, ldo.t, q0, Tq, dOs, false);

  int sq[kRowsPerWarp], pq[kRowsPerWarp];
  float lse_r[kRowsPerWarp], del_r[kRowsPerWarp], acc[kRowsPerWarp][DL];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int qp = q0 + r0 + r;
    const long long at = static_cast<long long>(hi) * Tq + qp;
    sq[r] = segq[qp];
    pq[r] = posq[qp];
    lse_r[r] = qp < Tq ? lse[at] : 0.f;
    del_r[r] = qp < Tq ? delta[at] : 0.f;
#pragma unroll
    for (int i = 0; i < DL; ++i) acc[r][i] = 0.f;
  }

  const int jhi = bounds[nq + iq];
  for (int j = bounds[iq]; j <= jhi; ++j) {
    const int c0 = j * kChunk;
    __syncthreads();
    load_tile<T, D>(kb, lk.t, c0, Tk, Kt, true);
    load_tile<T, D>(vb, lv.t, c0, Tk, Vt, true);
    __syncthreads();

    int sk[2], pk[2];
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      sk[jj] = segk[c0 + lane + 32 * jj];
      pk[jj] = posk[c0 + lane + 32 * jj];
    }
    float s[kRowsPerWarp][2], dp[kRowsPerWarp][2];
    rows_dot_cols<D>(Qs, Kt, r0, lane, s);
    rows_dot_cols<D>(dOs, Vt, r0, lane, dp);
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const float p = live(sq[r], pq[r], sk[jj], pk[jj], causal)
                            ? expf(s[r][jj] * scale - lse_r[r])
                            : 0.f;
        s[r][jj] = p * (dp[r][jj] - del_r[r]);  // ds
      }
    }
    cols_times_tile<D>(s, Kt, lane, acc);
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int qp = q0 + r0 + r;
    if (qp >= Tq) continue;
    T* dst = dq + hi * ldq.h + static_cast<long long>(qp) * ldq.t;
#pragma unroll
    for (int i = 0; i < DL; ++i)
      dst[lane + 32 * i] = from_f32<T>(acc[r][i] * scale);
  }
}

// ---------------------------------------------------------------------------
// backward: dk / dv
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
    const int* __restrict__ segq, const int* __restrict__ posq,
    const int* __restrict__ segk, const int* __restrict__ posk,
    const int* __restrict__ bounds, Lay lq, Lay lk, Lay lv, Lay ldo,
    Lay ldk, Lay ldv, int H, int KV, int Tq, int Tk, int nk, float scale,
    int causal) {
  constexpr int DL = D / 32;
  extern __shared__ float smem[];
  float* Ks = smem;                // [kRows][D]
  float* Vs = Ks + kRows * D;      // [kRows][D]
  float* Qt = Vs + kRows * D;      // [D][kPad]
  float* dOt = Qt + D * kPad;      // [D][kPad]

  const int G = H / KV;
  const int jk = blockIdx.x, kvh = blockIdx.y;
  const int k0 = jk * kRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = warp * kRowsPerWarp;

  load_tile<T, D>(k + kvh * lk.h, lk.t, k0, Tk, Ks, false);
  load_tile<T, D>(v + kvh * lv.h, lv.t, k0, Tk, Vs, false);

  int sk[kRowsPerWarp], pk[kRowsPerWarp];
  float dka[kRowsPerWarp][DL], dva[kRowsPerWarp][DL];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    sk[r] = segk[k0 + r0 + r];
    pk[r] = posk[k0 + r0 + r];
#pragma unroll
    for (int i = 0; i < DL; ++i) dka[r][i] = dva[r][i] = 0.f;
  }

  const int ilo = bounds[jk], ihi = bounds[nk + jk];
  for (int g = 0; g < G; ++g) {
    const int hi = kvh * G + g;
    const T* qb = q + hi * lq.h;
    const T* ob = dout + hi * ldo.h;
    const long long row0 = static_cast<long long>(hi) * Tq;
    for (int i = ilo; i <= ihi; ++i) {
      const int c0 = i * kChunk;
      __syncthreads();
      load_tile<T, D>(qb, lq.t, c0, Tq, Qt, true);
      load_tile<T, D>(ob, ldo.t, c0, Tq, dOt, true);
      __syncthreads();

      // this lane's two query columns: segment, position, lse, delta
      int sc[2], pc[2];
      float lc[2], dc[2];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int qp = c0 + lane + 32 * jj;
        sc[jj] = segq[qp];
        pc[jj] = posq[qp];
        lc[jj] = qp < Tq ? lse[row0 + qp] : 0.f;
        dc[jj] = qp < Tq ? delta[row0 + qp] : 0.f;
      }
      float s[kRowsPerWarp][2], dp[kRowsPerWarp][2];
      rows_dot_cols<D>(Ks, Qt, r0, lane, s);    // s^T[key][query]
      rows_dot_cols<D>(Vs, dOt, r0, lane, dp);  // dp^T[key][query]
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const float p = live(sc[jj], pc[jj], sk[r], pk[r], causal)
                              ? expf(s[r][jj] * scale - lc[jj])
                              : 0.f;
          s[r][jj] = p;
          dp[r][jj] = p * (dp[r][jj] - dc[jj]);  // ds^T
        }
      }
      cols_times_tile<D>(s, dOt, lane, dva);
      cols_times_tile<D>(dp, Qt, lane, dka);
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int kp = k0 + r0 + r;
    if (kp >= Tk) continue;
    T* dkd = dk + kvh * ldk.h + static_cast<long long>(kp) * ldk.t;
    T* dvd = dv + kvh * ldv.h + static_cast<long long>(kp) * ldv.t;
#pragma unroll
    for (int i = 0; i < DL; ++i) {
      dkd[lane + 32 * i] = from_f32<T>(dka[r][i] * scale);
      dvd[lane + 32 * i] = from_f32<T>(dva[r][i]);
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16: the tensor-core engine (flash_wgmma.cuh)
// ---------------------------------------------------------------------------

using ptt::tc::bf16;
using ptt::tc::kColWords;

// the per-segment mask over padded segment ids and positions; KeyRows: the
// block's rows are keys (dk/dv), else queries. A column tile's ids and
// positions are the tile's column words (2 x 64 ints).
template <bool KeyRows>
struct SegMask {
  const int *segr, *posr, *segc, *posc;
  int causal;
  int seg_r[2], pos_r[2];                      // this thread's two rows
  int seg_lo, seg_hi, pos_first, pos_last;     // the block's rows
  __device__ void load_cols(uint32_t dst, int c0) const {
    const int t = threadIdx.x;
    if (t < 64)
      ptt::tc::load_words(dst, segc, c0, c0 + 64, t);
    else
      ptt::tc::load_words(dst + kColWords * 4, posc, c0, c0 + 64, t - 64);
  }
  __device__ void rows(int r0, int ra, int rb) {
    seg_r[0] = segr[ra];
    seg_r[1] = segr[rb];
    pos_r[0] = posr[ra];
    pos_r[1] = posr[rb];
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

template <typename T, int D>
int launch_fwd(const void* q, const void* k, const void* v, void* o,
               void* lse, Segs sg, const long long* st, int H, int KV,
               int Tq, int Tk, float scale, int causal, cudaStream_t stream) {
  auto kern = fwd_kernel<T, D>;
  PTT_SET_SMEM(kern, fwd_smem<D>());
  const int nq = blocks(Tq);
  kern<<<dim3(nq, H), kThreads, fwd_smem<D>(), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      sg.segq, sg.posq, sg.segk, sg.posk, sg.bounds, lay_at(st, 0),
      lay_at(st, 1), lay_at(st, 2), lay_at(st, 3), H, KV, Tq, Tk, nq, scale,
      causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, Segs sg,
              const long long* st, int H, int KV, int Tq, int Tk, float scale,
              int causal, cudaStream_t stream) {
  auto kern = dq_kernel<T, D>;
  PTT_SET_SMEM(kern, dq_smem<D>());
  const int nq = blocks(Tq);
  kern<<<dim3(nq, H), kThreads, dq_smem<D>(), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), sg.segq, sg.posq, sg.segk, sg.posk, sg.bounds,
      lay_at(st, 0), lay_at(st, 1), lay_at(st, 2), lay_at(st, 3),
      lay_at(st, 4), H, KV, Tq, Tk, nq, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv,
               Segs sg, const long long* st, int H, int KV, int Tq, int Tk,
               float scale, int causal, cudaStream_t stream) {
  auto kern = dkv_kernel<T, D>;
  PTT_SET_SMEM(kern, dq_smem<D>());  // the same four tiles as dq
  const int nk = blocks(Tk);
  kern<<<dim3(nk, KV), kThreads, dq_smem<D>(), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), sg.segq, sg.posq, sg.segk,
      sg.posk, sg.bounds, lay_at(st, 0), lay_at(st, 1), lay_at(st, 2),
      lay_at(st, 3), lay_at(st, 4), lay_at(st, 5), H, KV, Tq, Tk, nk, scale,
      causal);
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
// the order [n] in which the bfloat16 kernels walk those blocks.
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
#define PTT_FWD(T, DD)                                                    \
  launch_fwd<T, DD>(q, k, v, o, lse, sg, strides, H, KV, Tq, Tk, scale, \
                    causal, s)
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
#define PTT_DQ(T, DD)                                                        \
  launch_dq<T, DD>(q, k, v, dout, lse, delta, dq, sg, strides, H, KV, Tq, Tk, \
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
#define PTT_DKV(T, DD)                                                      \
  launch_dkv<T, DD>(q, k, v, dout, lse, delta, dk, dv, sg, strides, H, KV, \
                    Tq, Tk, scale, causal, s)
#define PTT_DKV_TC(DD)                                                     \
  launch_dkv_tc<DD>(q, k, v, dout, lse, delta, dk, dv, sg, strides, H, KV, \
                    Tq, Tk, scale, causal, s)
  PTT_DISPATCH(PTT_DKV, PTT_DKV_TC);
#undef PTT_DKV
#undef PTT_DKV_TC
}
