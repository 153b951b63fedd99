// The pipelined float32 GEMM mainloop on Hopper's CUDA cores, shared by
// the float32 routes of the grouped GEMM (grouped_gemm.cu) and of the
// block-CSR SpMM (bcsr_spmm.cu). It plays the part gemm_wgmma.cuh plays
// for the bf16 routes; the arithmetic stays full float32 FMA (no TF32).
//
// What bounds a float32 GEMM on the H100: operations, 67 TFLOP/s of FMA
// on the CUDA cores (132 SMs x 128 lanes), so every warp instruction that
// is not an FMA costs an issue slot. The design keeps that share small:
//
// - Register tile. A block computes a TM x TN output tile (Tile below:
//   128 x 128, 64 x 128, 32 x 128 or 16 x 64). A thread keeps 4 x 4
//   sub-tiles of sums (8 x 8 at TM 64 and 128): rows ty*4 + i + si*TM/MI,
//   columns tx*4 + j + sj*64, tx < 16. Per k step it reads its A and B
//   values as float4s (4 shared loads for 64 FMAs at 8 x 8: every value
//   feeds 8 FMAs), a warp's 16 tx reading 256 contiguous bytes of B and
//   two broadcast float4s of A: conflict-free.
// - Both operands k-major in shared memory: a [kBK][TM + 4] A tile and a
//   [kBK][TN + 4] B tile a slot. An operand whose rows run along k in
//   device memory (x in BCSR, w [E, K, N] in the grouped forward) is
//   copied there by cp.async, 16 bytes where a row is 16-byte aligned,
//   else 4-byte copies (any strides); zero-filled past the edges. An
//   operand with k contiguous (x's C tile, BCSR's values, w's transposed
//   view in dx) cannot be transposed by cp.async: it is loaded into
//   registers a tile ahead (float4 where aligned, masked elements
//   otherwise) and stored transposed (Staged below).
// - A ring of kStages slots. At the top of step t one barrier makes tile
//   t visible (its cp.async copies waited, its transposed stores made a
//   step earlier) and frees the slot of tile t - 1; then the block stores
//   tile t + 1's staged registers, loads tile t + 2's into registers,
//   issues tile t + kStages - 1's copies and runs tile t's FMAs, so the
//   loads of the next tiles are in flight while it multiplies.
// - k groups (the 16-row tile): KG groups of threads, each on a ring of
//   its own, take every KG-th tile; their sums meet at the end through
//   shared memory, added in group order.
//
// The mainloop owns the slots and the FMAs; what fills a slot is the
// caller's policy, as with gemm_wgmma.cuh. For each k group it is called
// with that group's tiles, in increasing order:
//
//   void fill(float* slot, int t)  cp.async of tile t's copied operand
//        into the slot (no commit; a policy whose operands are both
//        staged does nothing);
//   void fetch(int t)              register loads of tile t's staged
//        operand(s);
//   void put(float* slot)          those registers, transposed, into the
//        slot (A at slot, B at slot + kBK * Tile<TM>::PA).
//
// Each output's sum runs over k in a fixed order: two launches give the
// same bytes (no split across blocks, no atomics).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma_common.cuh"

namespace ptt {
namespace f32 {

constexpr int kBK = 16;     // k depth of a tile
constexpr int kStages = 3;  // ring slots

// A block's geometry for an M tile of TM rows: MI x NJ sub-tiles of 4 x 4
// sums a thread (8 x 8 at TM 64 and 128, 4 x 8 at 32), 16 threads across
// the tile's 64 NJ columns, and KG k groups. The 16-row tile keeps 4 x 4 sums
// over 64 columns in two k groups: there a block row's run is the longest
// serial chain of the launch, and more, shorter chains shorten it. Row
// pitches are 4 mod 8 floats: float4 rows stay 16-byte aligned and
// Staged's transposing stores hit 32 distinct banks.
template <int TM>
struct Tile {
  static_assert(TM == 16 || TM == 32 || TM == 64 || TM == 128, "M tile");
  static constexpr int M = TM;
  static constexpr int MI = TM >= 64 ? 2 : 1;  // 4-row sub-tiles a thread
  static constexpr int NJ = TM >= 32 ? 2 : 1;  // 4-column sub-tiles
  static constexpr int KG = TM == 16 ? 2 : 1;  // k groups
  static constexpr int TN = 64 * NJ;             // output tile width
  static constexpr int NT = 16 * TM / (4 * MI);  // threads of a k group
  static constexpr int THREADS = KG * NT;
  static constexpr int MINB = 512 / THREADS;     // 128 registers a thread
  static constexpr int PA = TM + 4, PB = TN + 4;
  static constexpr int SLOT = kBK * (PA + PB);           // floats
  static constexpr int SMEM = KG * kStages * SLOT * 4;   // bytes
  static_assert(KG == 1 || (KG - 1) * TM * TN <= KG * kStages * SLOT,
                "the k groups' partial sums fit in their rings");
};

template <int TM>
using Acc = float[Tile<TM>::MI * 4][Tile<TM>::NJ * 4];

// An operand tile of R rows (along m or n) and kBK columns (along k, k
// contiguous in device memory), staged through registers and stored
// transposed into [kBK][R + 4] floats. Chunk q (4 floats) is row (q / 2)
// % R at k 4 * (2 * (q / 2R) + q % 2): a warp reads 32 contiguous bytes of
// each of 16 rows, and its stores of one k fall in 32 distinct banks.
template <int R, int NT>
struct Staged {
  static constexpr int CH = R * kBK / 4;       // chunks of the tile
  static constexpr int N = (CH + NT - 1) / NT;  // chunks a thread
  static_assert(CH % NT == 0 || NT % CH == 0, "whole rounds of chunks");
  float4 v[N];

  // rows [0, rows) and k [0, ks) of src (row stride s) are read, the rest
  // zero; vec: every row 16-byte aligned, so a whole chunk loads at once
  __device__ __forceinline__ void fetch(const float* __restrict__ src,
                                        long long s, int rows, int ks,
                                        bool vec) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int q = threadIdx.x % NT + i * NT;
      if (q >= CH) break;
      const int r = (q >> 1) % R, c = (2 * (q / (2 * R)) + (q & 1)) * 4;
      const float* p = src + r * s + c;
      if (r < rows && vec && c + 4 <= ks) {
        v[i] = __ldg(reinterpret_cast<const float4*>(p));
      } else {
        const bool ok = r < rows;
        v[i].x = ok && c < ks ? p[0] : 0.f;
        v[i].y = ok && c + 1 < ks ? p[1] : 0.f;
        v[i].z = ok && c + 2 < ks ? p[2] : 0.f;
        v[i].w = ok && c + 3 < ks ? p[3] : 0.f;
      }
    }
  }

  __device__ __forceinline__ void put(float* dst) const {
    constexpr int P = R + 4;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int q = threadIdx.x % NT + i * NT;
      if (q >= CH) break;
      const int r = (q >> 1) % R, c = (2 * (q / (2 * R)) + (q & 1)) * 4;
      dst[c * P + r] = v[i].x;
      dst[(c + 1) * P + r] = v[i].y;
      dst[(c + 2) * P + r] = v[i].z;
      dst[(c + 3) * P + r] = v[i].w;
    }
  }
};

// An operand tile of kBK rows (along k) and W columns (along m or n)
// copied by cp.async into [kBK][W + 4] floats at dst: element (k, c) is
// src[k * s_k + c * s_c], zero where k >= ks or c >= cols. vec: s_c == 1
// and every row 16-byte aligned, so whole chunks copy 16 bytes at once;
// a chunk that crosses cols, or any chunk without vec, copies elements.
template <int W, int NT>
__device__ __forceinline__ void fill_rows(uint32_t dst,
                                          const float* __restrict__ src,
                                          long long s_k, long long s_c,
                                          int ks, int cols, bool vec) {
  constexpr int CPR = W / 4;  // chunks a row
  static_assert(kBK * CPR % NT == 0, "whole rounds of chunks");
#pragma unroll
  for (int i = 0; i < kBK * CPR / NT; ++i) {
    const int q = threadIdx.x % NT + i * NT;
    const int k = q / CPR, c = (q % CPR) * 4;
    const uint32_t d = dst + (k * (W + 4) + c) * 4;
    const float* p = src + k * s_k + c * s_c;
    const bool in = k < ks && c < cols;
    if (vec && (!in || c + 4 <= cols)) {
      ptt::wg::cp_async16(d, in ? p : src, in);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = in && c + e < cols;
        ptt::wg::cp_async4(d + 4 * e, ok ? p + e * s_c : src, ok);
      }
    }
  }
}

// element e of a float4 (e a constant once the loops unroll)
__device__ __forceinline__ float lane(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// The FMAs of one slot: acc[si * 4 + i][sj * 4 + j] += A[k][row] *
// B[k][col] over the slot's kBK steps.
template <int TM>
__device__ __forceinline__ void fma_tile(
    const float* __restrict__ sA, const float* __restrict__ sB,
    Acc<TM>& acc) {
  using G = Tile<TM>;
  const float* a = sA + (threadIdx.x % G::NT / 16) * 4;
  const float* b = sB + (threadIdx.x % 16) * 4;
#pragma unroll
  for (int kk = 0; kk < kBK; ++kk) {
    float4 av[G::MI], bv[G::NJ];
#pragma unroll
    for (int si = 0; si < G::MI; ++si)
      av[si] =
          *reinterpret_cast<const float4*>(a + kk * G::PA + si * TM / G::MI);
#pragma unroll
    for (int sj = 0; sj < G::NJ; ++sj)
      bv[sj] = *reinterpret_cast<const float4*>(b + kk * G::PB + sj * 64);
#pragma unroll
    for (int i = 0; i < G::MI * 4; ++i)
#pragma unroll
      for (int j = 0; j < G::NJ * 4; ++j)
        acc[i][j] = fmaf(lane(av[i / 4], i % 4), lane(bv[j / 4], j % 4),
                         acc[i][j]);
  }
}

// -- the ring -----------------------------------------------------------------

// With KG k groups, group g runs tiles g, g + KG, ... on a ring of its
// own, all groups in step (one barrier a step), and group 0 ends with the
// sums of every group, added in group order.
template <int TM, class P>
__device__ __forceinline__ void mainloop(P& p, int ntiles, float* smem,
                                         Acc<TM>& acc) {
  using G = Tile<TM>;
  constexpr int S = kStages, D = S - 1, KG = G::KG;  // D: copies ahead
  static_assert(S >= 3, "a slot for the staged stores of tile t + 1");
  const int g = threadIdx.x / G::NT;
  float* ring = smem + g * S * G::SLOT;
  auto slot = [&](int s) { return ring + (s % S) * G::SLOT; };
  auto tile = [&](int s) { return g + s * KG; };  // the group's s-th tile
  const int steps = (ntiles + KG - 1) / KG;
  auto has = [&](int s) { return tile(s) < ntiles; };
  if (has(0)) {
    p.fetch(tile(0));
    p.put(slot(0));
  }
  if (has(1)) p.fetch(tile(1));
#pragma unroll
  for (int i = 0; i < D; ++i) {
    if (has(i)) p.fill(slot(i), tile(i));
    ptt::wg::cp_async_commit();
  }
  for (int s = 0; s < steps; ++s) {
    // every thread's copies of step s landed; step s - 1's slot is free
    ptt::wg::cp_async_wait_visible_but<D - 1>();
    if (has(s + 1)) p.put(slot(s + 1));
    if (has(s + 2)) p.fetch(tile(s + 2));
    if (has(s + D)) p.fill(slot(s + D), tile(s + D));
    ptt::wg::cp_async_commit();
    if (has(s)) fma_tile<TM>(slot(s), slot(s) + kBK * G::PA, acc);
  }
  if constexpr (KG > 1) {  // partial sums through the rings, thread-major
    constexpr int W = G::NJ * 4, E = G::MI * 4 * W;
    float* part = smem + threadIdx.x % G::NT;
    ptt::wg::cp_async_wait_visible();
    if (g > 0)
#pragma unroll
      for (int e = 0; e < E; ++e)
        part[((g - 1) * E + e) * G::NT] = acc[e / W][e % W];
    __syncthreads();
    if (g == 0)
      for (int h = 1; h < KG; ++h)
#pragma unroll
        for (int e = 0; e < E; ++e)
          acc[e / W][e % W] += part[((h - 1) * E + e) * G::NT];
  }
}

// The block's sums to device memory: row r of the tile goes to
// row_ptr(r) (nullptr: not stored), its sums while r < live and zeros
// after, column c while c < ncols; float4 stores where vec (every output
// row 16-byte aligned).
template <int TM, class RowPtr>
__device__ __forceinline__ void store_tile(
    const Acc<TM>& acc, int ncols, bool vec, int live,
    RowPtr row_ptr) {
  using G = Tile<TM>;
  if (threadIdx.x >= G::NT) return;  // k groups past the first: summed
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int si = 0; si < G::MI; ++si)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = si * TM / G::MI + ty * 4 + i;
      float* out = row_ptr(r);
      if (out == nullptr) continue;
      const bool keep = r < live;
#pragma unroll
      for (int sj = 0; sj < G::NJ; ++sj) {
        const int c = sj * 64 + tx * 4;
        const int j = sj * 4;
        const float4 v =
            keep ? make_float4(acc[si * 4 + i][j], acc[si * 4 + i][j + 1],
                               acc[si * 4 + i][j + 2], acc[si * 4 + i][j + 3])
                 : make_float4(0.f, 0.f, 0.f, 0.f);
        if (vec && c + 4 <= ncols) {
          *reinterpret_cast<float4*>(out + c) = v;
        } else {
          if (c < ncols) out[c] = v.x;
          if (c + 1 < ncols) out[c + 1] = v.y;
          if (c + 2 < ncols) out[c + 2] = v.z;
          if (c + 3 < ncols) out[c + 3] = v.w;
        }
      }
    }
}

}  // namespace f32
}  // namespace ptt
