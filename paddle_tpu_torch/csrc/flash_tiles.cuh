// Tile loads and float32 tile products shared by the float32 flash kernels
// (flash_attention.cu over [batch, seq, heads, head_dim], flash_varlen.cu
// over the packed [tokens, heads, head_dim] layout); bfloat16 takes the
// tensor-core engine of flash_wgmma.cuh.
//
// A block of kThreads threads owns kRows rows; warp w owns rows [8w, 8w+8).
// Tiles live in shared memory as float32, either in row layout [p][D] or
// transposed [D][kPad] (padded: conflict-free both ways). Lane l holds the
// scores of columns l and l+32 of a kChunk-wide chunk and the head_dim
// columns l, l+32, ... of its rows' sums.

#pragma once

#include "paged_attention_common.cuh"

namespace ptt {

constexpr int kPad = kChunk + 1;  // transposed tile row pitch

// Rows [p0, p0 + kChunk) of one (batch, head) slice into shared memory as
// float32; rows at or past n are zeros. transpose: dst[d][p] with pitch
// kPad, else dst[p][d].
template <typename T, int D>
__device__ __forceinline__ void load_tile(const T* __restrict__ src,
                                          long long stride_s, int p0, int n,
                                          float* __restrict__ dst,
                                          bool transpose) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int VPR = D / VEC;
  for (int v = threadIdx.x; v < kChunk * VPR; v += kThreads) {
    const int p = v / VPR;
    const int d0 = (v % VPR) * VEC;
    float vals[VEC];
    if (p0 + p < n) {
      const uint4 u = *reinterpret_cast<const uint4*>(
          src + static_cast<long long>(p0 + p) * stride_s + d0);
      unpack16(u, vals, T());
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) vals[e] = 0.f;
    }
    if (transpose) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) dst[(d0 + e) * kPad + p] = vals[e];
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) dst[p * D + d0 + e] = vals[e];
    }
  }
}

// out[r][j] = sum_d A[r0 + r][d] * Bt[d][lane + 32 j]: rows of A (row
// layout, read as warp broadcasts) against the two columns of a
// transposed chunk this lane holds.
template <int D>
__device__ __forceinline__ void rows_dot_cols(const float* __restrict__ A,
                                              const float* __restrict__ Bt,
                                              int r0, int lane,
                                              float (&out)[kRowsPerWarp][2]) {
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) out[r][0] = out[r][1] = 0.f;
#pragma unroll 2
  for (int d = 0; d < D; d += 4) {
    float b0[4], b1[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      b0[e] = Bt[(d + e) * kPad + lane];
      b1[e] = Bt[(d + e) * kPad + lane + 32];
    }
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const float4 a = *reinterpret_cast<const float4*>(&A[(r0 + r) * D + d]);
      out[r][0] += a.x * b0[0] + a.y * b0[1] + a.z * b0[2] + a.w * b0[3];
      out[r][1] += a.x * b1[0] + a.y * b1[1] + a.z * b1[2] + a.w * b1[3];
    }
  }
}

// acc[r][i] += sum_c w[r][c] * Bt[(lane + 32 i)][c]: the weights a lane
// holds (columns lane, lane + 32) are shuffled to the warp, and the
// transposed chunk is read at this lane's head_dim columns.
template <int D>
__device__ __forceinline__ void cols_times_tile(
    const float (&w)[kRowsPerWarp][2], const float* __restrict__ Bt, int lane,
    float (&acc)[kRowsPerWarp][D / 32]) {
  constexpr int DL = D / 32;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
#pragma unroll 4
    for (int cc = 0; cc < 32; ++cc) {
      const int c = 32 * j + cc;
      float b[DL];
#pragma unroll
      for (int i = 0; i < DL; ++i) b[i] = Bt[(lane + 32 * i) * kPad + c];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float wc = __shfl_sync(0xffffffffu, w[r][j], cc);
#pragma unroll
        for (int i = 0; i < DL; ++i) acc[r][i] += wc * b[i];
      }
    }
  }
}

// acc[r][i] += sum_c w[r][c] * B[c][lane + 32 i] (row-layout chunk)
template <int D>
__device__ __forceinline__ void cols_times_rows(
    const float (&w)[kRowsPerWarp][2], const float* __restrict__ B, int lane,
    float (&acc)[kRowsPerWarp][D / 32]) {
  constexpr int DL = D / 32;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
#pragma unroll 4
    for (int cc = 0; cc < 32; ++cc) {
      const int c = 32 * j + cc;
      float b[DL];
#pragma unroll
      for (int i = 0; i < DL; ++i) b[i] = B[c * D + lane + 32 * i];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float wc = __shfl_sync(0xffffffffu, w[r][j], cc);
#pragma unroll
        for (int i = 0; i < DL; ++i) acc[r][i] += wc * b[i];
      }
    }
  }
}

// shared memory of the three kernel shapes, in bytes: forward (Q rows,
// K^T, V rows), dq (Q and dO rows, K^T and V^T), dk/dv (K and V rows, Q^T
// and dO^T, lse and delta of a chunk)
template <int D>
constexpr int fwd_smem() { return (kRows * D + D * kPad + kChunk * D) * 4; }
template <int D>
constexpr int dq_smem() { return (2 * kRows * D + 2 * D * kPad) * 4; }
template <int D>
constexpr int dkv_smem() {
  return (2 * kRows * D + 2 * D * kPad + 2 * kChunk) * 4;
}

}  // namespace ptt

// once per kernel instance: the attribute belongs to the function
#define PTT_SET_SMEM(kern, bytes)                                       \
  do {                                                                  \
    static bool attr_set = false;                                       \
    if (!attr_set) {                                                    \
      cudaError_t err = cudaFuncSetAttribute(                           \
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);    \
      if (err != cudaSuccess) return static_cast<int>(err);             \
      attr_set = true;                                                  \
    }                                                                   \
  } while (0)

// dtype codes: 0 float32 (CALL(T, D): the CUDA-core kernels above), 1
// bfloat16 (CALL_TC(D): the tensor-core engine of flash_wgmma.cuh); head_dim
// 64 or 128
#define PTT_DISPATCH(CALL, CALL_TC)                      \
  do {                                                   \
    if (dtype == 0 && D == 128) return CALL(float, 128); \
    if (dtype == 0 && D == 64) return CALL(float, 64);   \
    if (dtype == 1 && D == 128) return CALL_TC(128);     \
    if (dtype == 1 && D == 64) return CALL_TC(64);       \
    return static_cast<int>(cudaErrorInvalidValue);      \
  } while (0)
