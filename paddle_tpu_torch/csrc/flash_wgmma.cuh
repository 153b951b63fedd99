// The bf16 attention engine on Hopper's tensor cores, shared by the flash
// kernels (flash_attention.cu, [batch, seq, heads, head_dim]) and the
// packed (varlen) kernels (flash_varlen.cu, [tokens, heads, head_dim]):
// the forward, dq and dk/dv bodies. float32 keeps the CUDA-core kernels of
// flash_tiles.cuh.
//
// What bounds them: operations. At the training shape (b 2, s 2048, 32/8
// heads, d 128, causal) the forward does 68.7 GFLOP against ~100 MB of
// q/k/v/out (~700 flop/byte, above the card's ~295 ridge), so the design
// aims at the bf16 tensor cores:
//
// - One block is one warpgroup (128 threads) and owns 64 rows of its side
//   (queries for forward and dq, keys for dk/dv): wgmma's M. It streams
//   64-row tiles of the other side through a ring of two stages in shared
//   memory, so the next tile's copy overlaps this tile's products.
// - Loads are cp.async, 16 bytes a thread, into the 128-byte-swizzled
//   layout that wgmma reads (a [rows][D] tile is D/64 column blocks of
//   [rows][64], chunk c of row r at (c ^ r % 8) * 16). cp.async rather
//   than TMA: the wrappers take any 16-byte-aligned strides (strided
//   [b, s, h, d], the folded [b*h, s, d] of flash_block, packed [T, h, d])
//   and zero-fill rows past the end, with no tensor map to encode per call
//   and no cuTensorMapEncodeTiled to look up; a tile is 8 (d 64) or 16
//   (d 128) copies a thread, against 64 x 64 x d x 4 flops of products.
// - Operands stay bf16 in shared memory. Every product is a wgmma
//   (m64nNk16, float32 sums in registers). Shared-memory operands are
//   K-major (rows along M or N, head_dim along k) or, with wgmma's
//   B-transpose bit, MN-major (rows along k): the same swizzled tile
//   serves both, so V, K, Q and dO are never copied transposed.
//   Probabilities and dS are converted to bf16 in registers and feed the
//   next product as its A operand (the accumulator's layout is the A
//   fragment's), as two bf16 terms (hi = bf16(p), lo = bf16(p - hi)):
//   each such product runs twice, and P.V, dS.K, P^T.dO and dS^T.Q keep
//   float32-level accuracy. A single bf16 P misses the smoke's elementwise
//   limit (atol 2e-3, rtol 1e-2) in rows with few live keys, where one
//   probability near 1 rounds by up to 2^-9 of a value of V.
// - Softmax statistics (m, l, lse, delta) stay float32; exp2 with log2(e)
//   folded into the scale. Dead rows give out 0, lse -1e30, zero grads.
// - The mask is a policy (template parameter) and runs only on boundary
//   tiles; a tile it calls interior skips the per-element test.
// - Shared memory at d 128: forward 82 KB, dq 98 KB, dk/dv 99 KB: two
//   blocks per SM, so one block's softmax overlaps the other's products.
// - No atomics: dk/dv walks the G query heads of its group itself, so
//   every result is the same bit for bit from run to run.
//
// A mask policy M (rows: the block's side; columns: the streamed side):
//   void load_cols(uint32_t dst, int c0)  cp.async of the tile's column
//        words (2 x 64 ints at dst), or nothing;
//   void rows(int r0, int ra, int rb)     per-block and per-thread rows;
//   bool interior(int r0, int c0, const int* cols)  every pair live;
//   bool live(int h, int row, int cl, int col, const int* cols).

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace ptt {
namespace tc {

using bf16 = __nv_bfloat16;

constexpr int kM = 64;          // rows a block owns (wgmma's M)
constexpr int kN = 64;          // rows of a streamed tile
constexpr int kThreads = 128;   // one warpgroup
constexpr int kColWords = 64;   // words per column array of a tile
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kNegBig = -1e30f;

template <int D>
__host__ __device__ constexpr uint32_t tile_bytes() { return kN * D * 2; }
// dynamic shared memory: tiles, per-stage column words, 1024 B of slack
// to align the swizzled tiles
template <int D>
constexpr int fwd_smem() {
  return 5 * tile_bytes<D>() + 2 * 2 * kColWords * 4 + 1024;
}
template <int D>
constexpr int dq_smem() {
  return 6 * tile_bytes<D>() + 2 * 2 * kColWords * 4 + 1024;
}
template <int D>
constexpr int dkv_smem() {
  return 6 * tile_bytes<D>() + 2 * 4 * kColWords * 4 + 1024;
}

// -- copies, fences, descriptors ---------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// this thread's copies have landed; after the fence and a barrier, every
// thread's copies are visible to wgmma (the async proxy)
__device__ __forceinline__ void cp_async_wait_visible() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
}

// Rows [r0, r0 + 64) of a [n, D] bf16 matrix (row stride `stride`
// elements) into the swizzled tile at dst (1024-byte aligned); rows at or
// past n are zero-filled (r0 < n).
template <int D>
__device__ __forceinline__ void load_tile(uint32_t dst,
                                          const bf16* __restrict__ src,
                                          long long stride, int r0, int n) {
  constexpr int CPR = D / 8;  // 16-byte chunks per row
#pragma unroll
  for (int v = threadIdx.x; v < kN * CPR; v += kThreads) {
    const int r = v / CPR, c = v % CPR;
    const bool ok = r0 + r < n;
    const bf16* g =
        src + static_cast<long long>(ok ? r0 + r : r0) * stride + c * 8;
    cp_async16(dst + (c / 8) * (kN * 128) + r * 128 +
                   (((c % 8) ^ (r % 8)) << 4),
               g, ok);
  }
}

// 64 words [c0, c0 + 64) of a column array (zeros at or past n)
__device__ __forceinline__ void load_words(uint32_t dst, const void* src,
                                           int c0, int n, int lane64) {
  const bool ok = c0 + lane64 < n;
  cp_async4(dst + lane64 * 4,
            static_cast<const uint32_t*>(src) + (ok ? c0 + lane64 : 0), ok);
}

// wgmma shared-memory descriptor, 128-byte swizzle
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

// a tile as a K-major operand (its rows along M or N, head_dim along k),
// k step kk (16 columns): 8-row groups 1024 B apart
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int kk) {
  return desc(tile + (kk / 4) * (kN * 128) + (kk % 4) * 32, 16, 1024);
}

// a tile as an MN-major operand (its rows along k, head_dim along N), k
// step kk (16 rows): 64-column blocks kN * 128 B apart (LBO), 8-row groups
// 1024 B apart (SBO)
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int kk) {
  return desc(tile + kk * 16 * 128, kN * 128, 1024);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keep the compiler from moving accumulator reads across wg_wait
template <int R>
__device__ __forceinline__ void reg_fence(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// (a, b) as two bf16 terms, hi = bf16(x) and lo = bf16(x - hi): hi + lo
// is x to ~2^-17 of |x|, where hi alone is off by up to 2^-9
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<uint32_t*>(&h);
  lo = pack_bf16(a - hf.x, b - hf.y);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// -- wgmma --------------------------------------------------------------------
//
// Accumulator of m64nN: thread t (warp w = t / 32, lane l) holds rows
// 16w + l/4 (h 0) and 16w + l/4 + 8 (h 1); element i is row h = (i >> 1) & 1,
// column 8 (i >> 2) + 2 (l % 4) + (i & 1). Columns [16kk, 16kk + 16) of an
// m64n64 accumulator, packed in pairs, are the A fragment of k step kk.

// d = A.B (acc 0) or d += A.B (acc 1): m64n64k16, A and B in shared
// memory, both K-major
__device__ __forceinline__ void mma_ss_n64(float (&d)[32], uint64_t a,
                                           uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(acc));
}

// d += A.B: m64n64k16, A in registers, B in shared memory MN-major
__device__ __forceinline__ void mma_rs_n64(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d += A.B: m64n128k16, A in registers, B in shared memory MN-major
__device__ __forceinline__ void mma_rs_n128(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <int D>
__device__ __forceinline__ void mma_rs(float (&d)[D / 2],
                                       const uint32_t (&a)[4], uint64_t b);
template <>
__device__ __forceinline__ void mma_rs<64>(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t b) {
  mma_rs_n64(d, a, b);
}
template <>
__device__ __forceinline__ void mma_rs<128>(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
  mma_rs_n128(d, a, b);
}

// d = A.B^T over head_dim: A and B are 64-row tiles, both K-major
template <int D>
__device__ __forceinline__ void mma_rows(float (&d)[32], uint32_t a,
                                         uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    mma_ss_n64(d, desc_k(a, kk), desc_k(b, kk), kk);
}

// d += P.B: P a 64 x 64 float32 accumulator as the bf16 fragments of its
// two terms (split_bf16), B a 64-row tile (MN-major)
template <int D>
__device__ __forceinline__ void mma_frag(float (&d)[D / 2],
                                         const uint32_t (&hi)[4][4],
                                         const uint32_t (&lo)[4][4],
                                         uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) mma_rs<D>(d, hi[kk], desc_mn(b, kk));
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) mma_rs<D>(d, lo[kk], desc_mn(b, kk));
}

__device__ __forceinline__ int col_of(int i, int lane) {
  return 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
}

template <int D>
__device__ __forceinline__ void store_rows(bf16* __restrict__ dst,
                                           const float (&acc)[D / 2], int h,
                                           int lane, float mul) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
    *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j + 2 * (lane & 3)) =
        __floats2bfloat162_rn(acc[4 * j + 2 * h] * mul,
                              acc[4 * j + 2 * h + 1] * mul);
}

// -- forward ------------------------------------------------------------------
//
// Rows [r0, r0 + 64) of q (nr rows) against column tiles c_first + 64 t,
// t < ntiles, of k and v (nc rows): out rows and lse (natural log, float32,
// indexed by row) of the rows below nr.
template <int D, class Mask>
__device__ __forceinline__ void fwd_body(
    const bf16* __restrict__ q, long long q_rs, const bf16* __restrict__ k,
    long long k_rs, const bf16* __restrict__ v, long long v_rs,
    bf16* __restrict__ o, long long o_rs, float* __restrict__ lse, int r0,
    int nr, int nc, int c_first, int ntiles, float scale, Mask mask,
    uint8_t* smem) {
  constexpr uint32_t TB = tile_bytes<D>();
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const uint32_t raw = smem_u32(smem);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sQ = base, sCols = base + 5 * TB;
  const int* cols_all = reinterpret_cast<const int*>(smem + (sCols - raw));
  auto stage_k = [&](int st) { return base + (1 + 2 * st) * TB; };

  load_tile<D>(sQ, q, q_rs, r0, nr);
  if (ntiles > 0) {
    load_tile<D>(stage_k(0), k, k_rs, c_first, nc);
    load_tile<D>(stage_k(0) + TB, v, v_rs, c_first, nc);
    mask.load_cols(sCols, c_first);
  }
  cp_async_commit();

  const int ra = r0 + 16 * warp + lane / 4, rb = ra + 8;
  mask.rows(r0, ra, rb);
  const float sl2 = scale * kLog2e;
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int t = 0; t < ntiles; ++t) {
    const int st = t & 1, c0 = c_first + t * kN;
    cp_async_wait_visible();  // tile t landed; stage st ^ 1 is free
    if (t + 1 < ntiles) {
      load_tile<D>(stage_k(st ^ 1), k, k_rs, c0 + kN, nc);
      load_tile<D>(stage_k(st ^ 1) + TB, v, v_rs, c0 + kN, nc);
      mask.load_cols(sCols + (st ^ 1) * 2 * kColWords * 4, c0 + kN);
    }
    cp_async_commit();
    const uint32_t sK = stage_k(st), sV = sK + TB;
    const int* cols = cols_all + st * 2 * kColWords;

    float s[32];
    wg_fence();
    mma_rows<D>(s, sQ, sK);
    wg_commit();
    wg_wait();
    reg_fence(s);

    const bool full = mask.interior(r0, c0, cols);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int h = (i >> 1) & 1, cl = col_of(i, lane);
      float x = s[i] * sl2;
      if (!full && !mask.live(h, h ? rb : ra, cl, c0 + cl, cols))
        x = -INFINITY;
      s[i] = x;
      mx[h] = fmaxf(mx[h], x);
    }
    float mu[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float mn = fmaxf(m[h], quad_max(mx[h]));
      mu[h] = mn == -INFINITY ? 0.f : mn;
      const float alpha = ex2(m[h] - mu[h]);
      m[h] = mn;
      l[h] *= alpha;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        acc[4 * j + 2 * h] *= alpha;
        acc[4 * j + 2 * h + 1] *= alpha;
      }
    }
    uint32_t ph[4][4], pl[4][4];
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int h = (i >> 1) & 1;
      const float p0 = ex2(s[i] - mu[h]), p1 = ex2(s[i + 1] - mu[h]);
      l[h] += p0 + p1;
      split_bf16(p0, p1, ph[i / 8][(i % 8) / 2], pl[i / 8][(i % 8) / 2]);
    }
    wg_fence();
    mma_frag<D>(acc, ph, pl, sV);
    wg_commit();
    wg_wait();
    reg_fence(acc);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float lt = quad_sum(l[h]);
    const int row = h ? rb : ra;
    if (row >= nr) continue;
    store_rows<D>(o + row * o_rs, acc, h, lane, lt == 0.f ? 0.f : 1.f / lt);
    if ((lane & 3) == 0)
      lse[row] = lt == 0.f ? kNegBig : (m[h] + log2f(lt)) * kLn2;
  }
}

// -- backward: dq -------------------------------------------------------------
//
// Rows [r0, r0 + 64) of q and dout against column tiles of k and v: dq
// rows (scaled) from lse and delta (float32, indexed by row).
template <int D, class Mask>
__device__ __forceinline__ void dq_body(
    const bf16* __restrict__ q, long long q_rs, const bf16* __restrict__ k,
    long long k_rs, const bf16* __restrict__ v, long long v_rs,
    const bf16* __restrict__ dout, long long do_rs,
    const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dq, long long dq_rs, int r0, int nr, int nc,
    int c_first, int ntiles, float scale, Mask mask, uint8_t* smem) {
  constexpr uint32_t TB = tile_bytes<D>();
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const uint32_t raw = smem_u32(smem);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sQ = base, sdO = base + TB, sCols = base + 6 * TB;
  const int* cols_all = reinterpret_cast<const int*>(smem + (sCols - raw));
  auto stage_k = [&](int st) { return base + (2 + 2 * st) * TB; };

  load_tile<D>(sQ, q, q_rs, r0, nr);
  load_tile<D>(sdO, dout, do_rs, r0, nr);
  if (ntiles > 0) {
    load_tile<D>(stage_k(0), k, k_rs, c_first, nc);
    load_tile<D>(stage_k(0) + TB, v, v_rs, c_first, nc);
    mask.load_cols(sCols, c_first);
  }
  cp_async_commit();

  const int ra = r0 + 16 * warp + lane / 4, rb = ra + 8;
  mask.rows(r0, ra, rb);
  const float sl2 = scale * kLog2e;
  float lse2[2], dl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = h ? rb : ra;
    lse2[h] = row < nr ? lse[row] * kLog2e : 0.f;
    dl[h] = row < nr ? delta[row] : 0.f;
  }
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  for (int t = 0; t < ntiles; ++t) {
    const int st = t & 1, c0 = c_first + t * kN;
    cp_async_wait_visible();
    if (t + 1 < ntiles) {
      load_tile<D>(stage_k(st ^ 1), k, k_rs, c0 + kN, nc);
      load_tile<D>(stage_k(st ^ 1) + TB, v, v_rs, c0 + kN, nc);
      mask.load_cols(sCols + (st ^ 1) * 2 * kColWords * 4, c0 + kN);
    }
    cp_async_commit();
    const uint32_t sK = stage_k(st), sV = sK + TB;
    const int* cols = cols_all + st * 2 * kColWords;

    float s[32], dp[32];
    wg_fence();
    mma_rows<D>(s, sQ, sK);
    mma_rows<D>(dp, sdO, sV);
    wg_commit();
    wg_wait();
    reg_fence(s);
    reg_fence(dp);

    const bool full = mask.interior(r0, c0, cols);
    uint32_t dh[4][4], dlo[4][4];
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int h = (i >> 1) & 1;
      float ds[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int cl = col_of(i + e, lane);
        float p = ex2(fmaf(s[i + e], sl2, -lse2[h]));
        if (!full && !mask.live(h, h ? rb : ra, cl, c0 + cl, cols)) p = 0.f;
        ds[e] = p * (dp[i + e] - dl[h]);
      }
      split_bf16(ds[0], ds[1], dh[i / 8][(i % 8) / 2],
                 dlo[i / 8][(i % 8) / 2]);
    }
    wg_fence();
    mma_frag<D>(acc, dh, dlo, sK);
    wg_commit();
    wg_wait();
    reg_fence(acc);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = h ? rb : ra;
    if (row < nr) store_rows<D>(dq + row * dq_rs, acc, h, lane, scale);
  }
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
    const bf16* __restrict__ q, long long q_rs, long long q_hs,
    const bf16* __restrict__ k, long long k_rs, const bf16* __restrict__ v,
    long long v_rs, const bf16* __restrict__ dout, long long do_rs,
    long long do_hs, const float* __restrict__ lse,
    const float* __restrict__ delta, long long l_hs, bf16* __restrict__ dk,
    long long dk_rs, bf16* __restrict__ dv, long long dv_rs, int r0, int nr,
    int nc, int c_first, int per_head, int G, float scale, Mask mask,
    uint8_t* smem) {
  constexpr uint32_t TB = tile_bytes<D>();
  constexpr uint32_t CB = 4 * kColWords * 4;  // column bytes of a stage
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const uint32_t raw = smem_u32(smem);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sK = base, sV = base + TB, sCols = base + 6 * TB;
  const int* cols_all = reinterpret_cast<const int*>(smem + (sCols - raw));
  const int ntiles = G * per_head;
  auto stage_q = [&](int st) { return base + (2 + 2 * st) * TB; };
  // tile t: head t / per_head, first column c_first + 64 (t % per_head)
  auto load_stage = [&](int t, int st) {
    const int g = t / per_head, c0 = c_first + (t % per_head) * kN;
    load_tile<D>(stage_q(st), q + g * q_hs, q_rs, c0, nc);
    load_tile<D>(stage_q(st) + TB, dout + g * do_hs, do_rs, c0, nc);
    const uint32_t cb = sCols + st * CB;
    mask.load_cols(cb, c0);
    if (threadIdx.x < 64)
      load_words(cb + 2 * kColWords * 4, lse + g * l_hs, c0, nc, threadIdx.x);
    else
      load_words(cb + 3 * kColWords * 4, delta + g * l_hs, c0, nc,
                 threadIdx.x - 64);
  };

  load_tile<D>(sK, k, k_rs, r0, nr);
  load_tile<D>(sV, v, v_rs, r0, nr);
  if (ntiles > 0) load_stage(0, 0);
  cp_async_commit();

  const int ra = r0 + 16 * warp + lane / 4, rb = ra + 8;
  mask.rows(r0, ra, rb);
  const float sl2 = scale * kLog2e;
  float dka[D / 2], dva[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;

  for (int t = 0; t < ntiles; ++t) {
    const int st = t & 1, c0 = c_first + (t % per_head) * kN;
    cp_async_wait_visible();
    if (t + 1 < ntiles) load_stage(t + 1, st ^ 1);
    cp_async_commit();
    const uint32_t sQ = stage_q(st), sdO = sQ + TB;
    const int* cols = cols_all + st * (CB / 4);
    const float* lse_c = reinterpret_cast<const float*>(cols + 2 * kColWords);
    const float* del_c = reinterpret_cast<const float*>(cols + 3 * kColWords);

    float s[32], dp[32];
    wg_fence();
    mma_rows<D>(s, sK, sQ);
    mma_rows<D>(dp, sV, sdO);
    wg_commit();
    wg_wait();
    reg_fence(s);
    reg_fence(dp);

    const bool full = mask.interior(r0, c0, cols);
    uint32_t ph[4][4], pl[4][4], dh[4][4], dlo[4][4];
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int h = (i >> 1) & 1, cl = col_of(i, lane);
      const float2 lc = *reinterpret_cast<const float2*>(lse_c + cl);
      const float2 dc = *reinterpret_cast<const float2*>(del_c + cl);
      float p0 = ex2(fmaf(s[i], sl2, -lc.x * kLog2e));
      float p1 = ex2(fmaf(s[i + 1], sl2, -lc.y * kLog2e));
      if (!full) {
        const int row = h ? rb : ra;
        if (!mask.live(h, row, cl, c0 + cl, cols)) p0 = 0.f;
        if (!mask.live(h, row, cl + 1, c0 + cl + 1, cols)) p1 = 0.f;
      }
      const int a = i / 8, b = (i % 8) / 2;
      split_bf16(p0, p1, ph[a][b], pl[a][b]);
      split_bf16(p0 * (dp[i] - dc.x), p1 * (dp[i + 1] - dc.y), dh[a][b],
                 dlo[a][b]);
    }
    wg_fence();
    mma_frag<D>(dva, ph, pl, sdO);
    mma_frag<D>(dka, dh, dlo, sQ);
    wg_commit();
    wg_wait();
    reg_fence(dva);
    reg_fence(dka);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = h ? rb : ra;
    if (row >= nr) continue;
    store_rows<D>(dk + row * dk_rs, dka, h, lane, scale);
    store_rows<D>(dv + row * dv_rs, dva, h, lane, 1.f);
  }
}

}  // namespace tc
}  // namespace ptt
