// Shared device code of the two paged-attention kernels
// (ragged_paged_attention.cu, paged_attention.cu); flash_attention.cu
// takes the tile shape, conversions and warp reductions from here too.
//
// One thread block owns one q tile of one kv head: up to kRows query rows
// (tokens x the kv head's GQA group), all of them attending the same
// row of the block table. It walks the row's kv positions in chunks of
// kChunk, up to the tile's causal horizon, and keeps the online-softmax
// state (m, l, acc) of its rows in registers. Nothing carries between
// blocks, so the grid needs no order.
//
// Each chunk of K and V is gathered through the block table into shared
// memory once and converted to float32 there (int8 pools are dequantized
// here, so device-memory reads stay at int8 bytes). All arithmetic is
// float32 on the CUDA cores; the scores and the output accumulate in
// float32 and the output is rounded once, to q's dtype.
//
// Warp w owns rows [w*8, w*8+8). Lane l holds the scores of kv columns l
// and l+32 of the chunk, and the output columns l, l+32, l+64, ... of D.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace ptt {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 8;
constexpr int kRows = kWarps * kRowsPerWarp;  // q rows of a tile: 64
constexpr int kChunk = 64;                    // kv positions per chunk
constexpr float kNeg = -1e30f;

// float32 elements of dynamic shared memory: Q tile [kRows][D],
// K chunk transposed [D][kChunk + 1] (padded: conflict-free both ways),
// V chunk [kChunk][D]
template <int D>
constexpr int smem_floats() {
  return kRows * D + D * (kChunk + 1) + kChunk * D;
}

__device__ __forceinline__ void unpack16(const uint4& u, float* out, float) {
  out[0] = __uint_as_float(u.x);
  out[1] = __uint_as_float(u.y);
  out[2] = __uint_as_float(u.z);
  out[3] = __uint_as_float(u.w);
}

__device__ __forceinline__ void unpack16(const uint4& u, float* out,
                                         __nv_bfloat16) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // little-endian: element 2i is the low half
    out[2 * i] = __uint_as_float(w[i] << 16);
    out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void unpack16(const uint4& u, float* out, int8_t) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      out[4 * i + b] = static_cast<float>(
          static_cast<int8_t>((w[i] >> (8 * b)) & 0xffu));
    }
  }
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Gather kv positions [c0, c0 + kChunk) of one kv head through the block
// table into shared memory as float32, dequantized when `scales` is set.
// Positions at or past kv_end are written as zeros (never read from the
// pool). Transposed layout [D][kChunk + 1] for K, row layout [kChunk][D]
// for V.
template <typename KT, int D>
__device__ __forceinline__ void load_chunk(
    const KT* __restrict__ pool, const float* __restrict__ scales,
    const int* __restrict__ tbl_row, int NB, int BS, int KV, int kvh, int c0,
    int kv_end, float* __restrict__ dst, bool transpose) {
  constexpr int VEC = 16 / sizeof(KT);
  constexpr int VPR = D / VEC;  // vectors per position
  for (int v = threadIdx.x; v < kChunk * VPR; v += kThreads) {
    const int p = v / VPR;
    const int d0 = (v % VPR) * VEC;
    const int pos = c0 + p;
    float vals[VEC];
    if (pos < kv_end) {
      int blk = tbl_row[pos / BS];
      blk = blk < 0 ? 0 : (blk >= NB ? NB - 1 : blk);
      const size_t slot = static_cast<size_t>(blk) * BS + pos % BS;
      const size_t base = (slot * KV + kvh) * D + d0;
      const uint4 u = *reinterpret_cast<const uint4*>(pool + base);
      unpack16(u, vals, KT());
      if (scales != nullptr) {
        const float s = scales[slot * KV + kvh];
#pragma unroll
        for (int e = 0; e < VEC; ++e) vals[e] *= s;
      }
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) vals[e] = 0.f;
    }
    if (transpose) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) dst[(d0 + e) * (kChunk + 1) + p] = vals[e];
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) dst[p * D + d0 + e] = vals[e];
    }
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Attend one tile. Query row ri = qi * G + g is token tok0 + qi, head
// kvh * G + g, at absolute position qp0 + qi; it sees kv positions
// p <= qp0 + qi with p < kv_end. Rows with qi >= qc are padding: they are
// neither read nor written. A row that sees no position writes zeros
// (l == 0 divides by 1).
template <typename QT, typename KT, int D>
__device__ void attend_tile(const QT* __restrict__ q,
                            const KT* __restrict__ k_pool,
                            const KT* __restrict__ v_pool,
                            const float* __restrict__ k_scale,
                            const float* __restrict__ v_scale,
                            const int* __restrict__ tbl_row, QT* __restrict__ out,
                            int H, int KV, int G, int NB, int BS, int kvh,
                            int tok0, int qc, int qp0, int kv_end, float scale,
                            float* smem) {
  static_assert(D % 32 == 0, "head_dim must be a multiple of 32");
  constexpr int DL = D / 32;  // output columns per lane
  float* Qs = smem;                          // [kRows][D]
  float* Kt = Qs + kRows * D;                // [D][kChunk + 1]
  float* Vs = Kt + D * (kChunk + 1);         // [kChunk][D]

  const int nrows = qc * G;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r0 = warp * kRowsPerWarp;
  const bool warp_active = r0 < nrows;

  // Q tile, rows past nrows zero
  {
    constexpr int VEC = 16 / sizeof(QT);
    constexpr int VPR = D / VEC;
    for (int v = threadIdx.x; v < kRows * VPR; v += kThreads) {
      const int ri = v / VPR;
      const int d0 = (v % VPR) * VEC;
      float vals[VEC];
      if (ri < nrows) {
        const int qi = ri / G, g = ri % G;
        const size_t base =
            (static_cast<size_t>(tok0 + qi) * H + kvh * G + g) * D + d0;
        const uint4 u = *reinterpret_cast<const uint4*>(q + base);
        unpack16(u, vals, QT());
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) vals[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) Qs[ri * D + d0 + e] = vals[e];
    }
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][DL];
  int qpos[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = kNeg;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < DL; ++i) acc[r][i] = 0.f;
    const int ri = r0 + r;
    // padding rows see nothing: position below every kv position
    qpos[r] = ri < nrows ? qp0 + ri / G : -1;
  }

  for (int c0 = 0; c0 < kv_end; c0 += kChunk) {
    __syncthreads();  // previous chunk fully consumed (and Q tile written)
    load_chunk<KT, D>(k_pool, k_scale, tbl_row, NB, BS, KV, kvh, c0, kv_end,
                      Kt, true);
    load_chunk<KT, D>(v_pool, v_scale, tbl_row, NB, BS, KV, kvh, c0, kv_end,
                      Vs, false);
    __syncthreads();
    if (!warp_active) continue;

    // scores: s[r][j] for kv column lane + 32 j
    float s[kRowsPerWarp][2];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) s[r][0] = s[r][1] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; d += 4) {
      float k0[4], k1[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        k0[e] = Kt[(d + e) * (kChunk + 1) + lane];
        k1[e] = Kt[(d + e) * (kChunk + 1) + lane + 32];
      }
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float4 qv =
            *reinterpret_cast<const float4*>(&Qs[(r0 + r) * D + d]);
        s[r][0] += qv.x * k0[0] + qv.y * k0[1] + qv.z * k0[2] + qv.w * k0[3];
        s[r][1] += qv.x * k1[0] + qv.y * k1[1] + qv.z * k1[2] + qv.w * k1[3];
      }
    }

    // online softmax; p overwrites s
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      bool live[2];
      float sv[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int pos = c0 + lane + 32 * j;
        live[j] = pos <= qpos[r] && pos < kv_end;
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

    // acc += p @ V
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll 4
      for (int cc = 0; cc < 32; ++cc) {
        const int c = 32 * j + cc;
        float v[DL];
#pragma unroll
        for (int i = 0; i < DL; ++i) v[i] = Vs[c * D + lane + 32 * i];
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) {
          const float pc = __shfl_sync(0xffffffffu, s[r][j], cc);
#pragma unroll
          for (int i = 0; i < DL; ++i) acc[r][i] += pc * v[i];
        }
      }
    }
  }

  if (!warp_active) return;
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int ri = r0 + r;
    if (ri >= nrows) continue;
    const float denom = l[r] == 0.f ? 1.f : l[r];
    const int qi = ri / G, g = ri % G;
    QT* dst = out + (static_cast<size_t>(tok0 + qi) * H + kvh * G + g) * D;
#pragma unroll
    for (int i = 0; i < DL; ++i)
      dst[lane + 32 * i] = from_f32<QT>(acc[r][i] / denom);
  }
}

}  // namespace ptt
