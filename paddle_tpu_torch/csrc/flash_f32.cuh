// The float32 attention engine on Hopper's CUDA cores, shared by the flash
// kernels (flash_attention.cu, [batch, seq, heads, head_dim]) and the
// packed (varlen) kernels (flash_varlen.cu, [tokens, heads, head_dim]):
// the forward, dq and dk/dv bodies. It plays the part for float32 that
// flash_wgmma.cuh plays for bf16. The arithmetic is full float32 FMA (no
// TF32).
//
// What bounds it: operations, 67 TFLOP/s of FMA on the CUDA cores (132 SMs
// x 128 lanes), so every warp instruction that is not an FMA costs an FMA's
// issue slot. The design keeps that share small:
//
// - A block of 256 threads owns 64 rows of its side (queries in forward
//   and dq, keys in dk/dv) and streams 64-row tiles of the other side.
//   Thread t (tx = t % 16, ty = t / 16) owns rows 4 ty + i (i < 4) of every
//   product: a 4 x 4 sub-tile of the scores (columns tx + 16 j, j < 4) and
//   a 4 x D/16 sub-tile of its outputs (columns 4 (tx + 16 jj) + e). A
//   row's scores sit in the 16 lanes of one half-warp, so its max and sum
//   take 4 xor-shuffles. The forward block owns those rows in two query
//   heads of one GQA group where the group size is even (HB = 2): the
//   heads share every K and V tile, a thread keeps 8 x 4 scores and 8 x
//   D/16 outputs, and each K or V value read from shared memory feeds
//   twice the FMAs.
// - Every tile lies row-major in shared memory, float32, at a pitch of D +
//   4 floats, and is copied there by cp.async, 16 bytes a thread. The
//   scores (S = Q.K^T, dP = dO.V^T; S^T = K.Q^T, dP^T = V.dO^T in dk/dv)
//   read both tiles as float4s along head_dim: per 4-deep step a thread
//   issues 4 loads of its rows (two addresses a warp: one wavefront) and 4
//   of its columns (16 rows 4 banks apart: two wavefronts) for 64 FMAs (8
//   and 4 for 128 in the two-head forward). The second products (O +=
//   P.V, dq += dS.K; dv += P^T.dO, dk += dS^T.Q) read the same tiles as
//   rows along the kv (or q) axis: V, K, dO and Q are never stored twice
//   and never transposed, so gemm_f32.cuh's transposing Staged load and
//   its k-major fill_rows have nothing to do here.
// - Probabilities (dS) go to shared memory once a tile, laid along the
//   reduction axis: a W tile W[c][r] of pitch 64 HB + 4. A thread stores a
//   float4 of its 4 rows per column (a warp's stores fill 32 banks four
//   times over) and the second product reads W as the A operand: one
//   float4 a head (a broadcast) and D/64 float4s of the B tile per column,
//   for 4 HB x D/16 FMAs.
// - Tiles stream so that the next loads are in flight while the block
//   multiplies. dq keeps a ring of two (K, V) stages: at the top of tile t
//   one barrier makes tile t visible (its copies waited) and frees tile t
//   - 1's stage, and the block issues tile t + 1's copies before tile t's
//   products. The forward keeps one K and one V slot: K_t is copied during
//   P.V of tile t - 1, V_t during the scores of tile t. dk/dv keeps three
//   single-tile slots for Q and dO: Q_{t+1} is copied during all of tile
//   t, dO_t during S^T of tile t (a barrier waits for it before dP^T).
//   One more barrier a tile sits between the stores of W and its products.
// - The mask is a policy (template parameter, as in flash_wgmma.cuh) and
//   runs only on boundary tiles; a tile it calls interior skips the
//   per-element test. exp2 with log2(e) folded into the scale; lse stays
//   a natural log, converted once a row. Rows with no live key give out 0,
//   lse -1e30 and zero grads.
// - No atomics: dk/dv walks the G query heads of its group itself, every
//   sum runs in a fixed order, and two launches give the same bytes.
//
// Budget (shared memory; an SM has 228 KB, 227 KB a block, 1 KB reserved
// a block). A [64][D + 4] tile is 33 KB at d 128 (17 KB at d 64):
//   forward  HB Q tiles + a K and a V slot + W + column words: 166 KB at
//            d 128 with two heads (117 KB with one), 102 KB at d 64;
//   dq       Q, dO + 2 stages of (K, V) + W + words: 216 KB (120 KB);
//   dk/dv    K, V + 3 slots of Q or dO + a W for P and one for dS +
//            2 sets of words (seg, pos, lse, delta): 201 KB (121 KB).
// One block of 8 warps an SM, so a thread may hold 255 registers: the
// two-head forward's 64 sums and 32 scores stay in registers.
//
// A mask policy M (rows: the block's side; columns: the streamed side):
//   void load_cols(uint32_t dst, int c0)  cp.async of the tile's column
//        words (2 x 64 ints at dst), or nothing; called by threads below
//        128 (the bf16 engine's block);
//   void rows(int r0, const int (&r)[4])  per-block and per-thread rows;
//   bool interior(int r0, int c0, const int* cols)  every pair live;
//   bool live(int i, int row, int cl, int col, const int* cols).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_wgmma.cuh"  // load_words, kColWords, log2(e), ln 2, -1e30
#include "gemm_f32.cuh"     // lane()

namespace ptt {
namespace fa32 {

using ptt::tc::ex2;
using ptt::tc::kColWords;
using ptt::tc::kLn2;
using ptt::tc::kLog2e;
using ptt::tc::kNegBig;
using ptt::tc::load_words;
using namespace ptt::wg;

constexpr int kM = 64;          // rows a block owns
constexpr int kN = 64;          // rows of a streamed tile
constexpr int kThreads = 256;
constexpr int kPad = 4;         // floats of padding a tile row
constexpr int kMaxSmem = 232448;  // bytes a block may use

template <int D>
__host__ __device__ constexpr int tile_floats() { return kM * (D + kPad); }
// pitch of a W tile that holds NA 64-row groups
template <int NA>
__host__ __device__ constexpr int w_pitch() { return kN * NA + kPad; }
// dynamic shared memory: `tiles` [64][D + 4] tiles, `w` W tiles of NA row
// groups, `words` 64-word column arrays
template <int D, int NA = 1>
__host__ __device__ constexpr int smem_bytes(int tiles, int w, int words) {
  return (tiles * tile_floats<D>() + w * kN * w_pitch<NA>() +
          words * kColWords) * 4;
}
// forward: HB Q tiles, a K and a V slot, W, one tile's seg and pos words
template <int D, int HB>
__host__ __device__ constexpr int fwd_smem() {
  return smem_bytes<D, HB>(HB + 2, 1, 2);
}
// dq: Q, dO, two stages of (K, V), W, two stages of seg and pos words
template <int D>
__host__ __device__ constexpr int dq_smem() {
  return smem_bytes<D>(6, 1, 4);
}
// dk/dv: K, V, three Q / dO slots, W for P and for dS, two tiles' seg,
// pos, lse and delta words
template <int D>
__host__ __device__ constexpr int dkv_smem() {
  return smem_bytes<D>(5, 2, 8);
}
static_assert(dq_smem<128>() <= kMaxSmem && dkv_smem<128>() <= kMaxSmem,
              "the d 128 bodies fit one block an SM");

// -- tiles --------------------------------------------------------------------

// Rows [r0, r0 + 64) of a [n, D] float32 matrix (row stride `stride`
// elements, rows 16-byte aligned) into the [64][D + 4] tile at dst; rows at
// or past n are zero-filled.
template <int D>
__device__ __forceinline__ void load_tile(uint32_t dst,
                                          const float* __restrict__ src,
                                          long long stride, int r0, int n) {
  constexpr int CPR = D / 4;  // 16-byte chunks a row
#pragma unroll
  for (int i = 0; i < kM * CPR / kThreads; ++i) {
    const int v = threadIdx.x + i * kThreads;
    const int r = v / CPR, c = v % CPR;
    const bool ok = r0 + r < n;
    cp_async16(dst + (r * (D + kPad) + 4 * c) * 4,
               src + static_cast<long long>(ok ? r0 + r : 0) * stride + 4 * c,
               ok);
  }
}

// acc[4 h + i][j] = sum_d A_h[4 ty + i][d] * B[tx + 16 j][d]: NA
// [64][D + 4] A tiles (A_h at A + h * tile_floats) against one B tile, all
// read as float4s along d
template <int D, int NA = 1>
__device__ __forceinline__ void rows_dot(const float* __restrict__ A,
                                         const float* __restrict__ B,
                                         float (&acc)[4 * NA][4]) {
  constexpr int P = D + kPad, TF = tile_floats<D>();
  const float* a = A + (threadIdx.x / 16) * 4 * P;
  const float* b = B + (threadIdx.x % 16) * P;
#pragma unroll
  for (int i = 0; i < 4 * NA; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; d += 4) {
    float4 av[4 * NA], bv[4];
#pragma unroll
    for (int i = 0; i < 4 * NA; ++i)
      av[i] = *reinterpret_cast<const float4*>(a + (i / 4) * TF +
                                               (i % 4) * P + d);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      bv[j] = *reinterpret_cast<const float4*>(b + 16 * j * P + d);
#pragma unroll
    for (int i = 0; i < 4 * NA; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[i][j] = fmaf(av[i].x, bv[j].x, acc[i][j]);
        acc[i][j] = fmaf(av[i].y, bv[j].y, acc[i][j]);
        acc[i][j] = fmaf(av[i].z, bv[j].z, acc[i][j]);
        acc[i][j] = fmaf(av[i].w, bv[j].w, acc[i][j]);
      }
  }
}

// w[4 h + i][j] (row 4 ty + i of group h, column tx + 16 j) into the W
// tile as W[col][64 h + row]
template <int NA = 1>
__device__ __forceinline__ void put_w(float* __restrict__ W,
                                      const float (&w)[4 * NA][4]) {
  constexpr int PW = w_pitch<NA>();
  float* dst = W + (threadIdx.x % 16) * PW + (threadIdx.x / 16) * 4;
#pragma unroll
  for (int h = 0; h < NA; ++h)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(dst + 16 * j * PW + kN * h) =
          make_float4(w[4 * h][j], w[4 * h + 1][j], w[4 * h + 2][j],
                      w[4 * h + 3][j]);
}

// acc[4 h + i][4 jj + e] += sum_c W[c][64 h + 4 ty + i] * B[c][4 (tx + 16
// jj) + e]: the W tile against a [64][D + 4] tile read along its rows
template <int D, int NA = 1>
__device__ __forceinline__ void w_times(const float* __restrict__ W,
                                        const float* __restrict__ B,
                                        float (&acc)[4 * NA][D / 16]) {
  constexpr int P = D + kPad, J = D / 64, PW = w_pitch<NA>();
  const float* w = W + (threadIdx.x / 16) * 4;
  const float* b = B + (threadIdx.x % 16) * 4;
#pragma unroll 16
  for (int c = 0; c < kN; ++c) {
    float4 wv[NA], bv[J];
#pragma unroll
    for (int h = 0; h < NA; ++h)
      wv[h] = *reinterpret_cast<const float4*>(w + c * PW + kN * h);
#pragma unroll
    for (int jj = 0; jj < J; ++jj)
      bv[jj] = *reinterpret_cast<const float4*>(b + c * P + 64 * jj);
#pragma unroll
    for (int i = 0; i < 4 * NA; ++i)
#pragma unroll
      for (int jj = 0; jj < J; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[i][4 * jj + e] = fmaf(ptt::f32::lane(wv[i / 4], i % 4),
                                    ptt::f32::lane(bv[jj], e),
                                    acc[i][4 * jj + e]);
  }
}

// a row's max and sum over the 16 lanes of its half-warp
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// rows 4 h + i of acc (i < 4: row r[i], those below nr), times mul[i],
// to dst + r[i] * rs
template <int D, int NA = 1>
__device__ __forceinline__ void store_rows(float* __restrict__ dst,
                                           long long rs,
                                           const float (&acc)[4 * NA][D / 16],
                                           int h, const int (&r)[4], int nr,
                                           const float (&mul)[4]) {
  const int tx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (r[i] >= nr) continue;
    const float* a = acc[4 * h + i];
    float* row = dst + r[i] * rs + 4 * tx;
#pragma unroll
    for (int jj = 0; jj < D / 64; ++jj)
      *reinterpret_cast<float4*>(row + 64 * jj) =
          make_float4(a[4 * jj] * mul[i], a[4 * jj + 1] * mul[i],
                      a[4 * jj + 2] * mul[i], a[4 * jj + 3] * mul[i]);
  }
}

template <int R, int C>
__device__ __forceinline__ void zero(float (&acc)[R][C]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int n = 0; n < C; ++n) acc[i][n] = 0.f;
}

// Bit 4 i + j set where the mask drops the pair (row r[i], column c0 + tx
// + 16 j); no bit for an interior tile, whose pairs skip the test
template <class Mask>
__device__ __forceinline__ unsigned dead_pairs(const Mask& mask, int r0,
                                               int c0, const int (&r)[4],
                                               const int* cols) {
  unsigned dead = 0;
  if (!mask.interior(r0, c0, cols)) {
    const int tx = threadIdx.x % 16;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int cl = tx + 16 * j;
        if (!mask.live(i, r[i], cl, c0 + cl, cols)) dead |= 1u << (4 * i + j);
      }
  }
  return dead;
}

// -- forward ------------------------------------------------------------------
//
// Rows [r0, r0 + 64) of HB query heads (nr rows; head h at q + h * q_hs,
// out at o + h * o_hs, lse at lse + h * l_hs, indexed by row) against
// column tiles c_first + 64 t, t < ntiles, of k and v (nc rows), which the
// HB heads share (one GQA group): out rows and lse (natural log) of the
// rows below nr. With HB 2 a thread's scores are 8 x 4, so each K and V
// value read from shared memory feeds twice the FMAs.
//
// K and V have one slot each: K_t is copied while the block multiplies
// P.V of tile t - 1, and V_t while it computes the scores of tile t; the
// barrier before P.V (which also publishes W) waits for V_t, the one at
// the top of a tile for K_t.
template <int D, int HB, class Mask>
__device__ __forceinline__ void fwd_body(
    const float* __restrict__ q, long long q_rs, long long q_hs,
    const float* __restrict__ k, long long k_rs, const float* __restrict__ v,
    long long v_rs, float* __restrict__ o, long long o_rs, long long o_hs,
    float* __restrict__ lse, long long l_hs, int r0, int nr, int nc,
    int c_first, int ntiles, float scale, Mask mask, float* smem) {
  constexpr int TF = tile_floats<D>(), R = 4 * HB;
  float* sQ = smem;               // HB tiles
  float* sK = smem + HB * TF;
  float* sV = sK + TF;
  float* sW = sV + TF;
  int* cols = reinterpret_cast<int*>(sW + kN * w_pitch<HB>());  // 2 x 64

#pragma unroll
  for (int h = 0; h < HB; ++h)
    load_tile<D>(smem_u32(sQ + h * TF), q + h * q_hs, q_rs, r0, nr);
  if (ntiles > 0) {
    load_tile<D>(smem_u32(sK), k, k_rs, c_first, nc);
    if (threadIdx.x < 128) mask.load_cols(smem_u32(cols), c_first);
  }
  cp_async_commit();

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  int rr[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) rr[i] = r0 + 4 * ty + i;
  mask.rows(r0, rr);
  const float sl2 = scale * kLog2e;
  float acc[R][D / 16], m[R], l[R];
  zero(acc);
#pragma unroll
  for (int i = 0; i < R; ++i) m[i] = -INFINITY, l[i] = 0.f;

  for (int t = 0; t < ntiles; ++t) {
    const int c0 = c_first + t * kN;
    cp_async_wait_visible();  // K_t landed; V's slot and W are free
    load_tile<D>(smem_u32(sV), v, v_rs, c0, nc);
    cp_async_commit();

    float s[R][4];
    rows_dot<D, HB>(sQ, sK, s);
    const unsigned dead = dead_pairs(mask, r0, c0, rr, cols);  // HB heads
#pragma unroll
    for (int i = 0; i < R; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x = s[i][j] * sl2;
        if (dead >> (4 * (i % 4) + j) & 1u) x = -INFINITY;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      const float mn = fmaxf(m[i], row_max(mx));
      const float mu = mn == -INFINITY ? 0.f : mn;
      const float alpha = ex2(m[i] - mu);
      m[i] = mn;
      l[i] *= alpha;
#pragma unroll
      for (int n = 0; n < D / 16; ++n) acc[i][n] *= alpha;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = ex2(s[i][j] - mu);
        l[i] += s[i][j];
      }
    }
    put_w<HB>(sW, s);
    cp_async_wait_visible();  // V_t landed, W published; K's slot is free
    if (t + 1 < ntiles) {
      load_tile<D>(smem_u32(sK), k, k_rs, c0 + kN, nc);
      if (threadIdx.x < 128) mask.load_cols(smem_u32(cols), c0 + kN);
    }
    cp_async_commit();
    w_times<D, HB>(sW, sV, acc);
  }

#pragma unroll
  for (int h = 0; h < HB; ++h) {
    float mul[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float lt = row_sum(l[4 * h + i]);
      mul[i] = lt == 0.f ? 0.f : 1.f / lt;
      if (tx == 0 && rr[i] < nr)
        lse[h * l_hs + rr[i]] =
            lt == 0.f ? kNegBig : (m[4 * h + i] + log2f(lt)) * kLn2;
    }
    store_rows<D, HB>(o + h * o_hs, o_rs, acc, h, rr, nr, mul);
  }
}

// -- backward: dq -------------------------------------------------------------
//
// Rows [r0, r0 + 64) of q and dout against column tiles of k and v: dq
// rows (scaled) from lse and delta (float32, indexed by row).
template <int D, class Mask>
__device__ __forceinline__ void dq_body(
    const float* __restrict__ q, long long q_rs, const float* __restrict__ k,
    long long k_rs, const float* __restrict__ v, long long v_rs,
    const float* __restrict__ dout, long long do_rs,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dq, long long dq_rs, int r0, int nr, int nc,
    int c_first, int ntiles, float scale, Mask mask, float* smem) {
  constexpr int TF = tile_floats<D>();
  float* sQ = smem;
  float* sdO = smem + TF;
  auto stage = [&](int st) { return smem + (2 + 2 * st) * TF; };  // K, V
  float* sW = smem + 6 * TF;
  int* words = reinterpret_cast<int*>(sW + kN * w_pitch<1>());
  auto load_stage = [&](int c0, int st) {
    load_tile<D>(smem_u32(stage(st)), k, k_rs, c0, nc);
    load_tile<D>(smem_u32(stage(st) + TF), v, v_rs, c0, nc);
    if (threadIdx.x < 128)
      mask.load_cols(smem_u32(words + st * 2 * kColWords), c0);
  };

  load_tile<D>(smem_u32(sQ), q, q_rs, r0, nr);
  load_tile<D>(smem_u32(sdO), dout, do_rs, r0, nr);
  if (ntiles > 0) load_stage(c_first, 0);
  cp_async_commit();

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  int rr[4];
  float lse2[4], dl[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    rr[i] = r0 + 4 * ty + i;
    lse2[i] = rr[i] < nr ? lse[rr[i]] * kLog2e : 0.f;
    dl[i] = rr[i] < nr ? delta[rr[i]] : 0.f;
  }
  mask.rows(r0, rr);
  const float sl2 = scale * kLog2e;
  float acc[4][D / 16];
  zero(acc);

  for (int t = 0; t < ntiles; ++t) {
    const int st = t & 1, c0 = c_first + t * kN;
    cp_async_wait_visible();
    if (t + 1 < ntiles) load_stage(c0 + kN, st ^ 1);
    cp_async_commit();
    const float* sK = stage(st);
    const int* cols = words + st * 2 * kColWords;

    float s[4][4], dp[4][4];
    rows_dot<D>(sQ, sK, s);
    rows_dot<D>(sdO, sK + TF, dp);
    const bool full = mask.interior(r0, c0, cols);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int cl = tx + 16 * j;
        float p = ex2(fmaf(s[i][j], sl2, -lse2[i]));
        if (!full && !mask.live(i, rr[i], cl, c0 + cl, cols)) p = 0.f;
        s[i][j] = p * (dp[i][j] - dl[i]);  // ds
      }
    put_w(sW, s);
    __syncthreads();
    w_times<D>(sW, sK, acc);
  }

  const float mul[4] = {scale, scale, scale, scale};
  store_rows<D>(dq, dq_rs, acc, 0, rr, nr, mul);
}

// -- backward: dk / dv --------------------------------------------------------
//
// Rows [r0, r0 + 64) of k and v (nr rows) against, for each of the G query
// heads g of the group, column tiles c_first + 64 i (i < per_head) of q and
// dout (nc rows; head g at q + g * q_hs, dout + g * do_hs, lse and delta at
// + g * l_hs, indexed by column): dk (scaled) and dv rows. Works in the
// transposed products: s^T = K.Q^T, dp^T = V.dO^T, dv += p^T.dO,
// dk += ds^T.Q.
template <int D, class Mask>
__device__ __forceinline__ void dkv_body(
    const float* __restrict__ q, long long q_rs, long long q_hs,
    const float* __restrict__ k, long long k_rs, const float* __restrict__ v,
    long long v_rs, const float* __restrict__ dout, long long do_rs,
    long long do_hs, const float* __restrict__ lse,
    const float* __restrict__ delta, long long l_hs, float* __restrict__ dk,
    long long dk_rs, float* __restrict__ dv, long long dv_rs, int r0, int nr,
    int nc, int c_first, int per_head, int G, float scale, Mask mask,
    float* smem) {
  constexpr int TF = tile_floats<D>();
  float* sK = smem;
  float* sV = smem + TF;
  // item n (Q of tile n / 2 for even n, dO of tile n / 2 for odd n) in
  // slot n % 3
  auto slot = [&](int n) { return smem + (2 + n % 3) * TF; };
  float* sP = smem + 5 * TF;
  float* sS = sP + kN * w_pitch<1>();
  // seg, pos, lse and delta words (4 x 64) of tiles of either parity
  int* words = reinterpret_cast<int*>(sS + kN * w_pitch<1>());
  const int ntiles = G * per_head;
  // tile t: head t / per_head, first column c_first + 64 (t % per_head)
  auto col0 = [&](int t) { return c_first + (t % per_head) * kN; };
  auto load_q = [&](int t) {
    const int g = t / per_head, c0 = col0(t);
    load_tile<D>(smem_u32(slot(2 * t)), q + g * q_hs, q_rs, c0, nc);
    const uint32_t cb = smem_u32(words + (t & 1) * 4 * kColWords);
    if (threadIdx.x < 128) mask.load_cols(cb, c0);
    if (threadIdx.x < 64)
      load_words(cb + 2 * kColWords * 4, lse + g * l_hs, c0, nc, threadIdx.x);
    else if (threadIdx.x < 128)
      load_words(cb + 3 * kColWords * 4, delta + g * l_hs, c0, nc,
                 threadIdx.x - 64);
  };
  auto load_do = [&](int t) {
    load_tile<D>(smem_u32(slot(2 * t + 1)), dout + t / per_head * do_hs,
                 do_rs, col0(t), nc);
  };

  load_tile<D>(smem_u32(sK), k, k_rs, r0, nr);
  load_tile<D>(smem_u32(sV), v, v_rs, r0, nr);
  if (ntiles > 0) load_q(0);
  cp_async_commit();

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  int rr[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) rr[i] = r0 + 4 * ty + i;
  mask.rows(r0, rr);
  const float sl2 = scale * kLog2e;
  float dka[4][D / 16], dva[4][D / 16];
  zero(dka);
  zero(dva);

  for (int t = 0; t < ntiles; ++t) {
    const int c0 = col0(t);
    cp_async_wait_visible();  // Q_t landed; tile t - 1's slots are free
    load_do(t);
    cp_async_commit();
    if (t + 1 < ntiles) load_q(t + 1);
    cp_async_commit();
    const float* sQ = slot(2 * t);
    const float* sdO = slot(2 * t + 1);
    const int* cols = words + (t & 1) * 4 * kColWords;
    const float* lse_c = reinterpret_cast<const float*>(cols + 2 * kColWords);
    const float* del_c = reinterpret_cast<const float*>(cols + 3 * kColWords);

    float s[4][4], dp[4][4];
    rows_dot<D>(sK, sQ, s);          // s^T[key][query]
    cp_async_wait_visible_but<1>();  // dO_t landed (Q_{t+1} may not)
    rows_dot<D>(sV, sdO, dp);        // dp^T[key][query]
    const bool full = mask.interior(r0, c0, cols);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int cl = tx + 16 * j;
      const float lc = lse_c[cl] * kLog2e, dc = del_c[cl];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float p = ex2(fmaf(s[i][j], sl2, -lc));
        if (!full && !mask.live(i, rr[i], cl, c0 + cl, cols)) p = 0.f;
        s[i][j] = p;
        dp[i][j] = p * (dp[i][j] - dc);  // ds^T
      }
    }
    put_w(sP, s);
    put_w(sS, dp);
    __syncthreads();
    w_times<D>(sP, sdO, dva);
    w_times<D>(sS, sQ, dka);
  }

  const float one[4] = {1.f, 1.f, 1.f, 1.f};
  const float mul[4] = {scale, scale, scale, scale};
  store_rows<D>(dk, dk_rs, dka, 0, rr, nr, mul);
  store_rows<D>(dv, dv_rs, dva, 0, rr, nr, one);
}

}  // namespace fa32
}  // namespace ptt

// dtype codes: 0 float32 (CALL_F32(D): the FMA engine above), 1 bfloat16
// (CALL_TC(D): the tensor-core engine of flash_wgmma.cuh); head_dim 64 or
// 128
#define PTT_DISPATCH(CALL_F32, CALL_TC)                \
  do {                                                 \
    if (dtype == 0 && D == 128) return CALL_F32(128);  \
    if (dtype == 0 && D == 64) return CALL_F32(64);    \
    if (dtype == 1 && D == 128) return CALL_TC(128);   \
    if (dtype == 1 && D == 64) return CALL_TC(64);     \
    return static_cast<int>(cudaErrorInvalidValue);    \
  } while (0)
