// Weight-only int4 GEMM on Hopper: the per-channel int4 serving matmul.
//
// Replaces paddle_tpu/ops/kernels/pallas/weight_only_gemm.py
// `_pallas_int4_matmul` (:105, the Pallas kernel `_int4_gemm_kernel` :77).
// It computes what that kernel computes, not block by block:
//
//   y[m, n] = (sum_k bf16(x)[m, k] * q[k, n]) * s[n]
//
// x [m, k] bf16 (the wrapper rounds a float32 x to bf16, as the reference
// does), q the int4 codes packed as [k/2, n] int8 bytes (row 2i in the low
// nibble, row 2i+1 in the high nibble, both two's complement), s [n]
// float32 per-channel scales; the sums are float32, the scale multiplies
// the sum in float32, and y is written in bf16 or float32 (x's dtype
// before the rounding), rounded once. The reference's even/odd split of x
// into two MXU dots serves the TPU and is not carried over: both nibbles
// of a packed byte are neighbouring k values of one bf16 pair here.
//
// Unpack, exact and without a conversion per element: a byte's nibbles
// XOR 8 are u = s + 8 in 0..15; (u | 0x4300) is the bf16 of 128 + u, and
// one bf16x2 subtraction of 136 leaves s (every value on the way is an
// integer below 256, exact in bf16).
//
// Routes, picked by shape in ptt_weight_only_int4_gemm before any launch
// (ptt_weight_only_int4_gemm_plan says which):
//
// - decode, m <= 64 (the engine's decode rows, generate()'s 4), aligned
//   shapes (k % 8 == 0, n % 16 == 0, x and q 16-byte aligned): bound by
//   bytes (the packed weight: 29.4 MB for Llama-3-8B's gate projection,
//   8.8 us at 3.35 TB/s). The operands swap: the weight is wgmma's A, 64
//   output columns n per block (M), and x is B with N = m rounded up to
//   8, 16, 32 or 64, so no tensor work goes to 64-row padding. Packed
//   rows stream through a 6-stage ring of 128-deep k tiles (gemm_wgmma.cuh;
//   4 KB of weight a stage, so 20 KB in flight per block and 2-4 blocks an
//   SM). A packed byte is exactly one A-fragment register (two
//   neighbouring k of one row): a thread reads its bytes as u16 pairs
//   from shared memory (the pair is two neighbouring n, which the block
//   maps to rows r and r + 8 of the fragment) and unpacks them in
//   registers. k is split over gridDim.y slices until the grid has about
//   400 blocks (Llama-3-8B at m 16: q/o and down 64 x 8, k/v 16 x 16,
//   gate/up 224 x 2); split slices write float32 partials to a workspace
//   that int4_gemm_reduce_kernel sums in slice order (no atomics: two
//   launches give the same bytes), then scales and rounds.
// - prefill, m > 64 (the engine's 512-token steps), aligned shapes: bound
//   by operations (60.1 GFLOP for the gate projection at m 512, 0.061 ms
//   at 989 TFLOP/s). 128 x 256 output tiles, two consumer warpgroups of
//   m64n256k16 wgmma, x as the K-major A; each stage's packed [32][256]
//   weight tile is unpacked once, four bytes at a time, into a swizzled
//   MN-major bf16 B tile that wgmma reads through its transpose bit. A
//   6-stage ring of 64-deep k tiles and two B tiles: tile t unpacks while
//   the products of tile t - 1 run. The unpack is the price of int4 here:
//   it happens once per 128 rows of x, on the warps that start the
//   products. The scale lands in the epilogue, through
//   shared memory as 16-byte row stores. Grids under 100 blocks (down and
//   q/o at m 512: 16 x 4) split k in two or more the same way as decode.
// - any other shape (k % 8 or n % 16 != 0, unaligned pointers: the tests'
//   odd shapes; every Llama shape is aligned): the WMMA kernel below,
//   WMMA over nibbles unpacked into shared memory, 32-deep synchronous k
//   steps, tails masked, any even k.
//
// The packed layout [k/2, n] is the stored one: nothing is repacked
// outside the kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "gemm_wgmma.cuh"

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

// -- any shape: WMMA, synchronous 32-deep k steps -----------------------------

constexpr int kBM = 128, kBN = 128, kBK = 32, kThreads = 256;
constexpr int kPA = kBK + 8;  // pitches in elements (multiples of 8, so
constexpr int kPB = kBN + 8;  // every fragment pointer is 32-byte aligned)

struct Problem {
  const bf16* x;      // [m, k]
  const int8_t* q;    // [k / 2, n]
  const float* s;     // [n]
  void* y;            // [m, n]
  int m, n, k;
  bool vec_x, vec_q;  // 16-byte x rows, 8-byte q rows
};

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16(v);
}

// x's [kBM][kBK] tile at (m0, k0); rows past m and columns past k are zero
__device__ __forceinline__ void load_x(const Problem& p, int m0, int k0,
                                       bf16* __restrict__ sA) {
  constexpr int V = 8, CH = kBK / V;  // 8 bf16 = 16 bytes per chunk
  for (int c = threadIdx.x; c < kBM * CH; c += kThreads) {
    const int r = c / CH, c0 = (c % CH) * V;
    const int gm = m0 + r, gk = k0 + c0;
    bf16* d = sA + r * kPA + c0;
    const bf16* src = p.x + static_cast<long long>(gm) * p.k + gk;
    if (gm < p.m && p.vec_x && gk + V <= p.k) {
      *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(src);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e)
        d[e] = (gm < p.m && gk + e < p.k) ? src[e] : __float2bfloat16(0.f);
    }
  }
}

// q's packed [kBK/2][kBN] tile at (k0/2, n0), unpacked into sB [kBK][kBN]:
// packed row r gives rows 2r (low nibble) and 2r+1 (high nibble). Bytes
// past k/2 or n unpack to zero.
__device__ __forceinline__ void load_q(const Problem& p, int k0, int n0,
                                       bf16* __restrict__ sB) {
  constexpr int V = 8, CH = kBN / V;  // 8 packed bytes per chunk
  const int k2 = p.k / 2;
  for (int c = threadIdx.x; c < (kBK / 2) * CH; c += kThreads) {
    const int r = c / CH, c0 = (c % CH) * V;
    const int gr = k0 / 2 + r, gn = n0 + c0;
    const int8_t* src = p.q + static_cast<long long>(gr) * p.n + gn;
    int b[V];
    if (gr < k2 && p.vec_q && gn + V <= p.n) {
      const uint2 w = *reinterpret_cast<const uint2*>(src);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const uint32_t word = e < 4 ? w.x : w.y;
        // byte e % 4 of the word to the top, then an arithmetic shift back
        b[e] = static_cast<int>(word << (24 - 8 * (e % 4))) >> 24;
      }
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e)
        b[e] = (gr < k2 && gn + e < p.n) ? static_cast<int>(src[e]) : 0;
    }
    __align__(16) bf16 lo[V];
    __align__(16) bf16 hi[V];
#pragma unroll
    for (int e = 0; e < V; ++e) {
      lo[e] = __int2bfloat16_rn(((b[e] & 0xF) ^ 8) - 8);  // sign-extended
      hi[e] = __int2bfloat16_rn(b[e] >> 4);               // arithmetic shift
    }
    *reinterpret_cast<uint4*>(sB + (2 * r) * kPB + c0) =
        *reinterpret_cast<const uint4*>(lo);
    *reinterpret_cast<uint4*>(sB + (2 * r + 1) * kPB + c0) =
        *reinterpret_cast<const uint4*>(hi);
  }
}

template <typename TO>
__global__ void __launch_bounds__(kThreads) int4_gemm_kernel(Problem p) {
  __shared__ __align__(128) bf16 sA[kBM * kPA];
  __shared__ __align__(128) bf16 sB[kBK * kPB];
  __shared__ __align__(128) float stage[kThreads / 32][16 * 16];

  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 2, wn = warp % 2;   // a 32 x 64 patch per warp
  const bool live = m0 + wm * 32 < p.m;     // a warp past m skips the mma

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = 0; k0 < p.k; k0 += kBK) {
    load_x(p, m0, k0, sA);
    load_q(p, k0, n0, sB);
    __syncthreads();
    if (live) {
#pragma unroll
      for (int kk = 0; kk < kBK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b[4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(a[i], sA + (wm * 32 + i * 16) * kPA + kk,
                                 kPA);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          wmma::load_matrix_sync(b[j], sB + kk * kPB + wn * 64 + j * 16, kPB);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
      }
    }
    __syncthreads();
  }
  if (!live) return;

  // epilogue: each fragment through a per-warp float32 stage; a lane
  // scales and writes 8 neighbouring outputs of one row
  TO* y = static_cast<TO*>(p.y);
  float* st = stage[warp];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(st, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int r = lane / 2, c = (lane % 2) * 8;
      const int m = m0 + wm * 32 + i * 16 + r;
      const int n = n0 + wn * 64 + j * 16 + c;
      if (m < p.m) {
        TO* out = y + static_cast<long long>(m) * p.n;
#pragma unroll
        for (int e = 0; e < 8; ++e)
          if (n + e < p.n)
            out[n + e] = from_f32<TO>(st[r * 16 + c + e] * p.s[n + e]);
      }
      __syncwarp();
    }
}

bool aligned(const void* ptr, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(ptr) % bytes == 0;
}

// -- shared by the Hopper routes ----------------------------------------------

using ptt::gemm::load_k_tile;
using ptt::gemm::mainloop;
using ptt::gemm::mma_rs_k;
using ptt::gemm::mma_ss_n256;
using ptt::gemm::store_pair;
using ptt::gemm::store_wg_tile;
using ptt::gemm::wg_stage_bytes;
using ptt::wg::cp_async16;
using ptt::wg::desc_k;
using ptt::wg::desc_mn;
using ptt::wg::fence_async_smem;
using ptt::wg::reg_fence;
using ptt::wg::smem_u32;
using ptt::wg::wg_commit;
using ptt::wg::wg_fence;
using ptt::wg::wg_wait;
using ptt::wg::wg_wait_but;

struct Args {
  const bf16* x;      // [m, k]
  const int8_t* q;    // [k / 2, n]
  const float* s;     // [n]
  void* y;            // [m, n]
  float* ws;          // [slices, m, n] float32 partials (slices > 1)
  int m, n, k;
};

// two raw nibbles (two's complement) at bits 0..3 and 16..19 of u, other
// bits ignored -> the bf16x2 of their values: (nibble ^ 8) | 0x4300 is the
// bf16 of 128 + (value + 8), and one bf16x2 subtraction of 136 leaves the
// value (every step exact). The mask, the XOR and the OR are one LOP3.
__device__ __forceinline__ uint32_t nibbles_to_bf16x2(uint32_t u) {
  uint32_t v = ((u & 0x000F000Fu) ^ 0x00080008u) | 0x43004300u;
  __nv_bfloat162 h = *reinterpret_cast<__nv_bfloat162*>(&v);
  const uint32_t c136 = 0x43084308u;
  h = __hsub2(h, *reinterpret_cast<const __nv_bfloat162*>(&c136));
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ uint32_t lds_u16(uint32_t addr) {
  unsigned short v;
  asm volatile("ld.shared.u16 %0, [%1];\n" : "=h"(v) : "r"(addr));
  return v;
}

__device__ __forceinline__ uint2 lds_u64(uint32_t addr) {
  uint2 v;
  asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];\n"
               : "=r"(v.x), "=r"(v.y)
               : "r"(addr));
  return v;
}

__device__ __forceinline__ void sts_u128(uint32_t addr, uint4 v) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

// k tiles [t0, t1) of slice `slice` of `slices` over T tiles: fixed
// boundaries, so every launch sums the same ranges
__device__ __forceinline__ void slice_tiles(int T, int slice, int slices,
                                            int& t0, int& t1) {
  t0 = static_cast<int>(static_cast<long long>(T) * slice / slices);
  t1 = static_cast<int>(static_cast<long long>(T) * (slice + 1) / slices);
}

// -- decode: the weight as A, unpacked in registers ---------------------------

constexpr int kDecN = 64;       // output columns n per block (wgmma's M)
constexpr int kDecBK = 128;     // k per stage: 64 packed rows
constexpr int kDecStages = 6;
constexpr int kDecPitch = 80;   // packed row pitch: 64 bytes + 16 (the u16
                                // reads of a warp hit 32 distinct banks)
constexpr int kDecWBytes = kDecBK / 2 * kDecPitch;  // 5120

// a stage: x's [NX][128] tile (two swizzled [NX][64] column blocks), then
// the packed weight; a multiple of 1024 bytes for NX in {8, 16, 32, 64}
template <int NX>
__host__ __device__ constexpr int dec_stage_bytes() {
  return NX * kDecBK * 2 + kDecWBytes;
}
template <int NX>
__host__ __device__ constexpr int dec_smem() {
  return kDecStages * dec_stage_bytes<NX>() + 1024;
}

// the u16 at addr holds the bytes of output columns n and n + 1 of one
// packed row; a0 and a1 are their fragment registers (rows r and r + 8):
// each byte's low nibble to bits 0..3, its high nibble to bits 16..19
__device__ __forceinline__ void unpack_pair(uint32_t v, uint32_t& a0,
                                            uint32_t& a1) {
  a0 = nibbles_to_bf16x2(v | (v << 12));
  a1 = nibbles_to_bf16x2((v >> 8) | (v << 4));
}

template <int NX>
struct DecodeTiles {
  const bf16* x;
  const int8_t* q;  // column n0
  int m, k, n, ncols, kt0;
  uint32_t base;

  __device__ __forceinline__ void fill(int slot, int t) {
    const int k0 = (kt0 + t) * kDecBK;
    const uint32_t sX = base + slot * dec_stage_bytes<NX>();
    const uint32_t sW = sX + NX * kDecBK * 2;
#pragma unroll
    for (int i = 0; i < NX * 16 / 128; ++i) {
      const int v = threadIdx.x + i * 128;
      const int r = v / 16, c = v % 16;
      const bool ok = r < m && k0 + c * 8 < k;
      cp_async16(sX + (c / 8) * (NX * 128) + r * 128 +
                     (((c % 8) ^ (r % 8)) << 4),
                 ok ? x + static_cast<long long>(r) * k + k0 + c * 8 : x, ok);
    }
#pragma unroll
    for (int i = 0; i < kDecBK / 2 * 4 / 128; ++i) {
      const int v = threadIdx.x + i * 128;
      const int r = v / 4, c = v % 4, pr = k0 / 2 + r;
      const bool ok = pr < k / 2 && c * 16 < ncols;
      cp_async16(sW + r * kDecPitch + c * 16,
                 ok ? q + static_cast<long long>(pr) * n + c * 16 : q, ok);
    }
  }

  // fragment row r (warp w = r / 16, g = r % 8, h = r / 8 % 2) is output
  // column n0 + 16 w + 2 g + h: a thread's two rows are neighbouring
  // columns, one u16 of a packed row
  __device__ __forceinline__ void consume(int slot, int,
                                          float (&acc)[NX / 2]) {
    const uint32_t sX = base + slot * dec_stage_bytes<NX>();
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    const uint32_t w0 = sX + NX * kDecBK * 2 + (lane % 4) * kDecPitch +
                        warp * 16 + (lane / 4) * 2;
    uint32_t a[8][4];
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      unpack_pair(lds_u16(w0 + 8 * kk * kDecPitch), a[kk][0], a[kk][1]);
      unpack_pair(lds_u16(w0 + (8 * kk + 4) * kDecPitch), a[kk][2],
                  a[kk][3]);
    }
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) mma_rs_k<NX>(acc, a[kk], desc_k<NX>(sX, kk));
    wg_commit();
    wg_wait();
    reg_fence(acc);
  }
};

// grid (n / 64, slices); one warpgroup. slices 1: y = sum * s, rounded;
// else float32 partials to ws[slice]
template <int NX, typename TO>
__global__ void __launch_bounds__(128) int4_gemm_decode_kernel(Args a) {
  extern __shared__ uint8_t smem[];
  const int n0 = blockIdx.x * kDecN, slice = blockIdx.y, slices = gridDim.y;
  int t0, t1;
  slice_tiles((a.k + kDecBK - 1) / kDecBK, slice, slices, t0, t1);
  const uint32_t base = (smem_u32(smem) + 1023u) & ~1023u;
  DecodeTiles<NX> tiles{a.x, a.q + n0, a.m, a.k, a.n, a.n - n0, t0, base};
  float acc[NX / 2];
#pragma unroll
  for (int i = 0; i < NX / 2; ++i) acc[i] = 0.f;
  mainloop<kDecStages, 0>(tiles, t1 - t0, acc);

  // acc element i: h = (i >> 1) & 1 picks column n or n + 1, x row
  // 8 (i >> 2) + 2 (lane % 4) + (i & 1)
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int n = n0 + 16 * warp + 2 * (lane / 4);
  if (n >= a.n) return;
  const float s0 = slices == 1 ? a.s[n] : 1.f;
  const float s1 = slices == 1 ? a.s[n + 1] : 1.f;
#pragma unroll
  for (int j = 0; j < NX / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int m = 8 * j + 2 * (lane % 4) + e;
      if (m >= a.m) continue;
      const float v0 = acc[4 * j + e], v1 = acc[4 * j + 2 + e];
      const long long at = static_cast<long long>(m) * a.n + n;
      if (slices == 1)
        store_pair(static_cast<TO*>(a.y) + at, v0 * s0, v1 * s1);
      else
        store_pair(a.ws + static_cast<long long>(slice) * a.m * a.n + at, v0,
                   v1);
    }
}

// y = (sum over slices, in slice order, of ws) * s, rounded once; four
// neighbouring outputs a thread (n % 16 == 0)
template <typename TO>
__global__ void __launch_bounds__(256) int4_gemm_reduce_kernel(Args a,
                                                               int slices) {
  const long long mn = static_cast<long long>(a.m) * a.n;
  const long long i = (static_cast<long long>(blockIdx.x) * 256 +
                       threadIdx.x) * 4;
  if (i >= mn) return;
  float4 acc = *reinterpret_cast<const float4*>(a.ws + i);
  for (int sl = 1; sl < slices; ++sl) {
    const float4 p = *reinterpret_cast<const float4*>(a.ws + sl * mn + i);
    acc.x += p.x;
    acc.y += p.y;
    acc.z += p.z;
    acc.w += p.w;
  }
  const int c = static_cast<int>(i % a.n);
  TO* y = static_cast<TO*>(a.y) + i;
  store_pair(y, acc.x * a.s[c], acc.y * a.s[c + 1]);
  store_pair(y + 2, acc.z * a.s[c + 2], acc.w * a.s[c + 3]);
}

// -- prefill: x as A, the weight unpacked into a swizzled bf16 B tile -------

constexpr int kPreM = 128, kPreN = 256, kPreStages = 6, kPreThreads = 256;
constexpr int kPreBK = ptt::gemm::kBK;                  // 64
constexpr uint32_t kPreXBytes = kPreM * kPreBK * 2;     // 16 KB, A
constexpr uint32_t kPreRawBytes = kPreBK / 2 * kPreN;   // 8 KB, packed
constexpr uint32_t kPreStage = kPreXBytes + kPreRawBytes;
constexpr uint32_t kPreBBytes = kPreBK * kPreN * 2;     // 32 KB, B
// the ring, two B tiles (tile t unpacks while tile t - 1 multiplies)
constexpr int kPreSmem = kPreStages * kPreStage + 2 * kPreBBytes + 1024;
constexpr int kPreChunks = kPreBK / 2 * kPreN / 16;     // of a packed tile

// the bf16x2 pairs of four packed bytes (output columns c .. c + 3):
// lo01 / lo23 the low nibbles (k row 2i) of columns c, c + 1 / c + 2,
// c + 3; hi01 / hi23 the high nibbles (k row 2i + 1). A byte permute puts
// bytes 0 and 1 (2 and 3) at bits 0 and 16; a shift by 4 brings the high
// nibbles down.
__device__ __forceinline__ void unpack_word(uint32_t w, uint32_t& lo01,
                                            uint32_t& lo23, uint32_t& hi01,
                                            uint32_t& hi23) {
  const uint32_t b01 = __byte_perm(w, 0, 0x4140);
  const uint32_t b23 = __byte_perm(w, 0, 0x4342);
  lo01 = nibbles_to_bf16x2(b01);
  lo23 = nibbles_to_bf16x2(b23);
  hi01 = nibbles_to_bf16x2(b01 >> 4);
  hi23 = nibbles_to_bf16x2(b23 >> 4);
}

struct PrefillTiles {
  const bf16* x;     // row m0
  const int8_t* q;   // column n0
  int rows, ncols, k, n, kt0, wg;
  bool live;         // the warpgroup has a row below m
  uint32_t base;

  __device__ __forceinline__ void fill(int slot, int t) {
    const int k0 = (kt0 + t) * kPreBK;
    const uint32_t sX = base + slot * kPreStage;
    load_k_tile<kPreM, kPreThreads>(sX, x + k0, k, rows, k - k0);
    // the packed [32][256] tile in 16-byte chunks
#pragma unroll
    for (int i = 0; i < kPreChunks / kPreThreads; ++i) {
      const int v = threadIdx.x + i * kPreThreads;
      const int r = v / (kPreN / 16), c = v % (kPreN / 16);
      const int pr = k0 / 2 + r;
      const bool ok = pr < k / 2 && c * 16 < ncols;
      cp_async16(sX + kPreXBytes + r * kPreN + c * 16,
                 ok ? q + static_cast<long long>(pr) * n + c * 16 : q, ok);
    }
  }

  __device__ __forceinline__ void consume(int slot, int t,
                                          float (&acc)[kPreN / 2]) {
    const uint32_t sX = base + slot * kPreStage;
    const uint32_t sB = base + kPreStages * kPreStage + (t % 2) * kPreBBytes;
    // packed row r, columns 8 c .. 8 c + 7 -> one 8-column chunk of k
    // rows 2r and 2r + 1 of the MN-major B tile, in column block c / 8 (a
    // quarter-warp writes the eight chunks of one row: no bank conflicts)
#pragma unroll
    for (int i = 0; i < 2 * kPreChunks / kPreThreads; ++i) {
      const int v = threadIdx.x + i * kPreThreads;
      const int r = v / (kPreN / 8), c = v % (kPreN / 8);
      const uint2 w = lds_u64(sX + kPreXBytes + r * kPreN + c * 8);
      uint4 lo, hi;
      unpack_word(w.x, lo.x, lo.y, hi.x, hi.y);
      unpack_word(w.y, lo.z, lo.w, hi.z, hi.w);
      const uint32_t blk = sB + (c / 8) * (kPreBK * 128);
      const int k0r = 2 * r, k1r = 2 * r + 1;
      sts_u128(blk + k0r * 128 + (((c % 8) ^ (k0r % 8)) << 4), lo);
      sts_u128(blk + k1r * 128 + (((c % 8) ^ (k1r % 8)) << 4), hi);
    }
    fence_async_smem();
    __syncthreads();
    if (!live) return;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      mma_ss_n256<1>(acc, desc_k<kPreM>(sX + wg * 64 * 128, kk),
                     desc_mn<kPreBK>(sB, kk));
    wg_commit();
    wg_wait_but<1>();
    reg_fence(acc);
  }
};

// grid (n / 256, m / 128, slices); two warpgroups, rows 64 wg ..
template <typename TO>
__global__ void __launch_bounds__(kPreThreads, 1)
    int4_gemm_prefill_kernel(Args a) {
  extern __shared__ uint8_t smem[];
  const int n0 = blockIdx.x * kPreN, m0 = blockIdx.y * kPreM;
  const int slice = blockIdx.z, slices = gridDim.z;
  const int wg = threadIdx.x / 128;
  int t0, t1;
  slice_tiles((a.k + kPreBK - 1) / kPreBK, slice, slices, t0, t1);
  const uint32_t raw = smem_u32(smem);
  const uint32_t base = (raw + 1023u) & ~1023u;
  PrefillTiles tiles{a.x + static_cast<long long>(m0) * a.k, a.q + n0,
                     a.m - m0, a.n - n0, a.k, a.n, t0, wg,
                     m0 + 64 * wg < a.m, base};
  float acc[kPreN / 2];
#pragma unroll
  for (int i = 0; i < kPreN / 2; ++i) acc[i] = 0.f;
  mainloop<kPreStages, 1>(tiles, t1 - t0, acc);
  __syncthreads();  // every product done: the ring becomes the epilogue's

  const int ncols = a.n - n0, mw = m0 + 64 * wg;
  if (slices == 1) {
    uint8_t* stage =
        smem + (base - raw) + wg * wg_stage_bytes<TO, kPreN>();
    TO* y = static_cast<TO*>(a.y) + n0;
    const float* s = a.s + n0;
    store_wg_tile<TO, kPreN>(
        acc, stage, wg, ncols,
        [&](int, int c, float v) { return c < ncols ? v * s[c] : 0.f; },
        [&](int r) -> TO* {
          return mw + r < a.m ? y + static_cast<long long>(mw + r) * a.n
                              : nullptr;
        });
  } else {
    uint8_t* stage =
        smem + (base - raw) + wg * wg_stage_bytes<float, kPreN>();
    float* ws = a.ws + static_cast<long long>(slice) * a.m * a.n + n0;
    store_wg_tile<float, kPreN>(
        acc, stage, wg, ncols, [](int, int, float v) { return v; },
        [&](int r) -> float* {
          return mw + r < a.m ? ws + static_cast<long long>(mw + r) * a.n
                              : nullptr;
        });
  }
}

// -- routing ------------------------------------------------------------------

enum Route { kRouteWmma = 0, kRouteDecode = 1, kRoutePrefill = 2 };

int plan(int m, int n, int k, bool ptrs_aligned, int* slices) {
  *slices = 1;
  if (!ptrs_aligned || k % 8 != 0 || n % 16 != 0) return kRouteWmma;
  if (m <= 64) {
    const int tiles = (n + kDecN - 1) / kDecN, T = (k + kDecBK - 1) / kDecBK;
    while (*slices < 16 && tiles * *slices < 400 && T >= 4 * *slices)
      *slices *= 2;
    return kRouteDecode;
  }
  const int tiles = ((n + kPreN - 1) / kPreN) * ((m + kPreM - 1) / kPreM);
  const int T = (k + kPreBK - 1) / kPreBK;
  while (*slices < 8 && tiles * *slices < 100 && T >= 4 * *slices)
    *slices *= 2;
  return kRoutePrefill;
}

template <int NX, typename TO>
int launch_decode(const Args& a, int slices, cudaStream_t st) {
  auto kern = int4_gemm_decode_kernel<NX, TO>;
  PTT_SET_SMEM(kern, dec_smem<NX>());
  kern<<<dim3((a.n + kDecN - 1) / kDecN, slices), 128, dec_smem<NX>(), st>>>(
      a);
  return static_cast<int>(cudaGetLastError());
}

template <typename TO>
int launch_hopper(const Args& a, int route, int slices, cudaStream_t st) {
  int rc;
  if (route == kRouteDecode) {
    rc = a.m <= 8    ? launch_decode<8, TO>(a, slices, st)
         : a.m <= 16 ? launch_decode<16, TO>(a, slices, st)
         : a.m <= 32 ? launch_decode<32, TO>(a, slices, st)
                     : launch_decode<64, TO>(a, slices, st);
  } else {
    auto kern = int4_gemm_prefill_kernel<TO>;
    PTT_SET_SMEM(kern, kPreSmem);
    kern<<<dim3((a.n + kPreN - 1) / kPreN, (a.m + kPreM - 1) / kPreM,
                slices),
           kPreThreads, kPreSmem, st>>>(a);
    rc = static_cast<int>(cudaGetLastError());
  }
  if (rc != 0 || slices == 1) return rc;
  const long long quads = static_cast<long long>(a.m) * a.n / 4;
  int4_gemm_reduce_kernel<TO>
      <<<static_cast<unsigned>((quads + 255) / 256), 256, 0, st>>>(a, slices);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The route of an [m, k] x [k/2, n] product (0: the WMMA kernel, 1:
// decode, 2: prefill) and its k slices; ptrs_aligned: x and q both
// 16-byte aligned. A caller allocates slices * m * n float32 of workspace
// when slices > 1.
extern "C" int ptt_weight_only_int4_gemm_plan(int m, int n, int k,
                                              int ptrs_aligned,
                                              int* slices) {
  return plan(m, n, k, ptrs_aligned != 0, slices);
}

// out_dtype: 0 float32, 1 bfloat16 (ops/kernels/_build.DTYPE_CODES). x is
// bf16 [m, k], q int8 [k/2, n], s float32 [n], y [m, n], all contiguous;
// ws the workspace of the plan's slices (may be null when it has one).
// Returns the cudaError_t of the launches.
extern "C" int ptt_weight_only_int4_gemm(const void* x, const void* q,
                                         const void* s, void* y, void* ws,
                                         int m, int n, int k, int out_dtype,
                                         void* stream) {
  if (k % 2 != 0 || m <= 0 || n <= 0 || k <= 0 ||
      (out_dtype != 0 && out_dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int slices = 1;
  const int route =
      plan(m, n, k, aligned(x, 16) && aligned(q, 16), &slices);
  if (route != kRouteWmma) {
    if (slices > 1 && ws == nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
    const Args a{static_cast<const bf16*>(x), static_cast<const int8_t*>(q),
                 static_cast<const float*>(s), y, static_cast<float*>(ws),
                 m, n, k};
    return out_dtype == 1 ? launch_hopper<bf16>(a, route, slices, st)
                          : launch_hopper<float>(a, route, slices, st);
  }
  Problem p{static_cast<const bf16*>(x), static_cast<const int8_t*>(q),
            static_cast<const float*>(s), y, m, n, k, false, false};
  p.vec_x = aligned(x, 16) && k % 8 == 0;
  p.vec_q = aligned(q, 8) && n % 8 == 0;
  dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  if (out_dtype == 1)
    int4_gemm_kernel<bf16><<<grid, kThreads, 0, st>>>(p);
  else
    int4_gemm_kernel<float><<<grid, kThreads, 0, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}
