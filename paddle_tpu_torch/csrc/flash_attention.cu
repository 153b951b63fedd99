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
// forward 68.7 GFLOP, 0.069 ms at 989 TFLOP/s bf16; dk/dv 137 GFLOP,
// 0.139 ms; dq's own product, 34 GFLOP, and its bytes both ~0.035 ms).
//
// bfloat16 (flash_tc_fwd, flash_tc_dq, flash_tc_dkv) runs on the tensor
// cores through the engine of flash_wgmma.cuh: bf16 tiles streamed by
// cp.async through two stages, every product a wgmma, softmax in float32,
// the causal mask a policy that runs on boundary tiles only. Forward and
// dq grids put the last q tiles (the longest causal rows) first, and
// dk/dv's the first k tiles, so the grid's tail is short.
//
// float32 keeps the CUDA-core kernels (fwd_kernel, dq_kernel, dkv_kernel):
// tiles converted to float32 in shared memory, float32 FMA (warp w owns
// rows [8w, 8w+8); lane l holds the columns l and l+32 of a chunk and the
// head_dim columns l, l+32, ...). Outputs round once, to the input's dtype.

#include "flash_tiles.cuh"
#include "flash_wgmma.cuh"

namespace {

// the tile shape, loads, products and warp reductions of flash_tiles.cuh
using ptt::cols_times_rows;
using ptt::cols_times_tile;
using ptt::dkv_smem;
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

struct Lay {  // element strides of a [batch, seq, heads, head_dim] tensor
  long long b, h, s;
};

// last key position + 1 that any query row of [q0, q0 + kRows) sees
__device__ __forceinline__ int kv_horizon(int q0, int Sq, int Sk, int causal) {
  if (!causal) return Sk;
  const int last = min(q0 + kRows, Sq) - 1;
  return max(0, min(Sk, last + (Sk - Sq) + 1));
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, float* __restrict__ lse, Lay lq, Lay lk, Lay lv,
    Lay lo, int H, int KV, int Sq, int Sk, float scale, int causal) {
  constexpr int DL = D / 32;
  extern __shared__ float smem[];
  float* Qs = smem;               // [kRows][D]
  float* Kt = Qs + kRows * D;     // [D][kPad]
  float* Vs = Kt + D * kPad;      // [kChunk][D]

  const int bh = blockIdx.x;
  const int bi = bh / H, hi = bh % H, kvh = hi / (H / KV);
  const int q0 = blockIdx.y * kRows;
  const int coff = Sk - Sq;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = warp * kRowsPerWarp;
  const T* kb = k + bi * lk.b + kvh * lk.h;
  const T* vb = v + bi * lv.b + kvh * lv.h;

  load_tile<T, D>(q + bi * lq.b + hi * lq.h, lq.s, q0, Sq, Qs, false);

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][DL];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = kNeg;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < DL; ++i) acc[r][i] = 0.f;
  }

  const int kv_end = kv_horizon(q0, Sq, Sk, causal);
  for (int c0 = 0; c0 < kv_end; c0 += kChunk) {
    __syncthreads();  // previous chunk consumed (and the Q tile written)
    load_tile<T, D>(kb, lk.s, c0, Sk, Kt, true);
    load_tile<T, D>(vb, lv.s, c0, Sk, Vs, false);
    __syncthreads();

    float s[kRowsPerWarp][2];
    rows_dot_cols<D>(Qs, Kt, r0, lane, s);
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int qp = q0 + r0 + r;
      bool live[2];
      float sv[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kp = c0 + lane + 32 * j;
        live[j] = qp < Sq && kp < Sk && (!causal || kp <= qp + coff);
        sv[j] = live[j] ? s[r][j] * scale : kNeg;
      }
      const float m_new = fmaxf(m[r], warp_max(fmaxf(sv[0], sv[1])));
#pragma unroll
      for (int j = 0; j < 2; ++j) s[r][j] = live[j] ? expf(sv[j] - m_new) : 0.f;
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
    if (qp >= Sq) continue;
    const float denom = l[r] == 0.f ? 1.f : l[r];
    T* dst = o + bi * lo.b + hi * lo.h + static_cast<long long>(qp) * lo.s;
#pragma unroll
    for (int i = 0; i < DL; ++i)
      dst[lane + 32 * i] = from_f32<T>(acc[r][i] / denom);
    if (lane == 0)
      lse[static_cast<long long>(bh) * Sq + qp] =
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
    const float* __restrict__ delta, T* __restrict__ dq, Lay lq, Lay lk,
    Lay lv, Lay ldo, Lay ldq, int H, int KV, int Sq, int Sk, float scale,
    int causal) {
  constexpr int DL = D / 32;
  extern __shared__ float smem[];
  float* Qs = smem;               // [kRows][D]
  float* dOs = Qs + kRows * D;    // [kRows][D]
  float* Kt = dOs + kRows * D;    // [D][kPad]
  float* Vt = Kt + D * kPad;      // [D][kPad]

  const int bh = blockIdx.x;
  const int bi = bh / H, hi = bh % H, kvh = hi / (H / KV);
  const int q0 = blockIdx.y * kRows;
  const int coff = Sk - Sq;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = warp * kRowsPerWarp;
  const T* kb = k + bi * lk.b + kvh * lk.h;
  const T* vb = v + bi * lv.b + kvh * lv.h;

  load_tile<T, D>(q + bi * lq.b + hi * lq.h, lq.s, q0, Sq, Qs, false);
  load_tile<T, D>(dout + bi * ldo.b + hi * ldo.h, ldo.s, q0, Sq, dOs, false);

  float lse_r[kRowsPerWarp], del_r[kRowsPerWarp], acc[kRowsPerWarp][DL];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int qp = q0 + r0 + r;
    const long long at = static_cast<long long>(bh) * Sq + qp;
    lse_r[r] = qp < Sq ? lse[at] : 0.f;
    del_r[r] = qp < Sq ? delta[at] : 0.f;
#pragma unroll
    for (int i = 0; i < DL; ++i) acc[r][i] = 0.f;
  }

  const int kv_end = kv_horizon(q0, Sq, Sk, causal);
  for (int c0 = 0; c0 < kv_end; c0 += kChunk) {
    __syncthreads();
    load_tile<T, D>(kb, lk.s, c0, Sk, Kt, true);
    load_tile<T, D>(vb, lv.s, c0, Sk, Vt, true);
    __syncthreads();

    float s[kRowsPerWarp][2], dp[kRowsPerWarp][2];
    rows_dot_cols<D>(Qs, Kt, r0, lane, s);
    rows_dot_cols<D>(dOs, Vt, r0, lane, dp);
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int qp = q0 + r0 + r;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kp = c0 + lane + 32 * j;
        const bool live = qp < Sq && kp < Sk && (!causal || kp <= qp + coff);
        const float p = live ? expf(s[r][j] * scale - lse_r[r]) : 0.f;
        s[r][j] = p * (dp[r][j] - del_r[r]);  // ds
      }
    }
    cols_times_tile<D>(s, Kt, lane, acc);
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int qp = q0 + r0 + r;
    if (qp >= Sq) continue;
    T* dst = dq + bi * ldq.b + hi * ldq.h + static_cast<long long>(qp) * ldq.s;
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
    Lay lq, Lay lk, Lay lv, Lay ldo, Lay ldk, Lay ldv, int H, int KV, int Sq,
    int Sk, float scale, int causal) {
  constexpr int DL = D / 32;
  extern __shared__ float smem[];
  float* Ks = smem;                // [kRows][D]
  float* Vs = Ks + kRows * D;      // [kRows][D]
  float* Qt = Vs + kRows * D;      // [D][kPad]
  float* dOt = Qt + D * kPad;      // [D][kPad]
  float* lse_c = dOt + D * kPad;   // [kChunk]
  float* del_c = lse_c + kChunk;   // [kChunk]

  const int G = H / KV;
  const int bk = blockIdx.x;
  const int bi = bk / KV, kvh = bk % KV;
  const int k0 = blockIdx.y * kRows;
  const int coff = Sk - Sq;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = warp * kRowsPerWarp;

  load_tile<T, D>(k + bi * lk.b + kvh * lk.h, lk.s, k0, Sk, Ks, false);
  load_tile<T, D>(v + bi * lv.b + kvh * lv.h, lv.s, k0, Sk, Vs, false);

  float dka[kRowsPerWarp][DL], dva[kRowsPerWarp][DL];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
#pragma unroll
    for (int i = 0; i < DL; ++i) dka[r][i] = dva[r][i] = 0.f;
  }

  // the first q chunk whose last row sees this tile's first key
  int qstart = 0;
  if (causal) qstart = max(0, (k0 - coff) / kChunk * kChunk);
  for (int g = 0; g < G; ++g) {
    const int hi = kvh * G + g;
    const long long bh = static_cast<long long>(bi) * H + hi;
    const T* qb = q + bi * lq.b + hi * lq.h;
    const T* ob = dout + bi * ldo.b + hi * ldo.h;
    for (int c0 = qstart; c0 < Sq; c0 += kChunk) {
      if (causal && min(c0 + kChunk, Sq) - 1 + coff < k0) continue;
      __syncthreads();
      load_tile<T, D>(qb, lq.s, c0, Sq, Qt, true);
      load_tile<T, D>(ob, ldo.s, c0, Sq, dOt, true);
      if (threadIdx.x < kChunk) {
        const int qp = c0 + threadIdx.x;
        lse_c[threadIdx.x] = qp < Sq ? lse[bh * Sq + qp] : 0.f;
        del_c[threadIdx.x] = qp < Sq ? delta[bh * Sq + qp] : 0.f;
      }
      __syncthreads();

      float s[kRowsPerWarp][2], dp[kRowsPerWarp][2];
      rows_dot_cols<D>(Ks, Qt, r0, lane, s);    // s^T[key][query]
      rows_dot_cols<D>(Vs, dOt, r0, lane, dp);  // dp^T[key][query]
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const int kp = k0 + r0 + r;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int c = lane + 32 * j;
          const int qp = c0 + c;
          const bool live = qp < Sq && kp < Sk && (!causal || kp <= qp + coff);
          const float p = live ? expf(s[r][j] * scale - lse_c[c]) : 0.f;
          s[r][j] = p;
          dp[r][j] = p * (dp[r][j] - del_c[c]);  // ds^T
        }
      }
      cols_times_tile<D>(s, dOt, lane, dva);
      cols_times_tile<D>(dp, Qt, lane, dka);
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int kp = k0 + r0 + r;
    if (kp >= Sk) continue;
    T* dkd = dk + bi * ldk.b + kvh * ldk.h + static_cast<long long>(kp) * ldk.s;
    T* dvd = dv + bi * ldv.b + kvh * ldv.h + static_cast<long long>(kp) * ldv.s;
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

// right-aligned causal mask and sequence tails; KeyRows: the block's rows
// are keys (dk/dv), else queries
template <bool KeyRows>
struct CausalMask {
  int nc, coff, causal;
  __device__ void load_cols(uint32_t, int) const {}
  __device__ void rows(int, int, int) {}
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

template <typename T, int D>
int launch_fwd(const void* q, const void* k, const void* v, void* o,
               void* lse, const long long* st, int B, int H, int KV, int Sq,
               int Sk, float scale, int causal, cudaStream_t stream) {
  auto kern = fwd_kernel<T, D>;
  PTT_SET_SMEM(kern, fwd_smem<D>());
  dim3 grid(B * H, (Sq + kRows - 1) / kRows);
  kern<<<grid, kThreads, fwd_smem<D>(), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      lay_at(st, 0), lay_at(st, 1), lay_at(st, 2), lay_at(st, 3), H, KV, Sq,
      Sk, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq,
              const long long* st, int B, int H, int KV, int Sq, int Sk,
              float scale, int causal, cudaStream_t stream) {
  auto kern = dq_kernel<T, D>;
  PTT_SET_SMEM(kern, dq_smem<D>());
  dim3 grid(B * H, (Sq + kRows - 1) / kRows);
  kern<<<grid, kThreads, dq_smem<D>(), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), lay_at(st, 0), lay_at(st, 1), lay_at(st, 2),
      lay_at(st, 3), lay_at(st, 4), H, KV, Sq, Sk, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv,
               const long long* st, int B, int H, int KV, int Sq, int Sk,
               float scale, int causal, cudaStream_t stream) {
  auto kern = dkv_kernel<T, D>;
  PTT_SET_SMEM(kern, dkv_smem<D>());
  dim3 grid(B * KV, (Sk + kRows - 1) / kRows);
  kern<<<grid, kThreads, dkv_smem<D>(), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), lay_at(st, 0), lay_at(st, 1),
      lay_at(st, 2), lay_at(st, 3), lay_at(st, 4), lay_at(st, 5), H, KV, Sq,
      Sk, scale, causal);
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
#define PTT_FWD(T, DD)                                                    \
  launch_fwd<T, DD>(q, k, v, o, lse, strides, B, H, KV, Sq, Sk, scale, \
                    causal, s)
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
#define PTT_DQ(T, DD)                                                       \
  launch_dq<T, DD>(q, k, v, dout, lse, delta, dq, strides, B, H, KV, Sq, Sk, \
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
#define PTT_DKV(T, DD)                                                      \
  launch_dkv<T, DD>(q, k, v, dout, lse, delta, dk, dv, strides, B, H, KV, Sq, \
                    Sk, scale, causal, s)
#define PTT_DKV_TC(DD)                                                    \
  launch_dkv_tc<DD>(q, k, v, dout, lse, delta, dk, dv, strides, B, H, KV, \
                    Sq, Sk, scale, causal, s)
  PTT_DISPATCH(PTT_DKV, PTT_DKV_TC);
#undef PTT_DKV
#undef PTT_DKV_TC
}
