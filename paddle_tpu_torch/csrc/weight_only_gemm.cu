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
// before the rounding). The reference's even/odd split of x into two MXU
// dots serves the TPU and is not carried over: here both nibbles of a
// packed byte land in neighbouring rows of one bf16 tile.
//
// Grid (N tiles, M tiles). A block owns a 128 x 128 output tile and walks
// k in 32-deep steps: it reads the packed [16][128] tile of q once (8
// bytes a thread), sign-extends both nibbles into a [32][128] bf16 tile in
// shared memory (values -8..7 are exact in bf16), loads the [128][32] bf16
// tile of x (16-byte loads where aligned), and 8 warps, each a 32 x 64
// patch, run WMMA 16x16x16 bf16 products with float32 accumulators. The
// epilogue multiplies by s[n] and rounds once. Tails of m, n and k are
// masked (k must be even), so any shape works.
//
// What bounds it on the H100: operations at the engine's 512-token steps
// (Llama-3-8B's gate projection: 60.1 GFLOP, 0.061 ms at 989 TFLOP/s,
// against 48 MB, 0.014 ms at 3.35 TB/s), bytes at decode (the 29.4 MB of
// packed weight, 0.0088 ms). This first version is the simple one:
// synchronous loads, WMMA, no pipelining; wgmma, TMA and a split-k decode
// variant are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

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

}  // namespace

// out_dtype: 0 float32, 1 bfloat16 (ops/kernels/_build.DTYPE_CODES). x is
// bf16 [m, k], q int8 [k/2, n], s float32 [n], y [m, n], all contiguous.
// Returns the cudaError_t of the launch.
extern "C" int ptt_weight_only_int4_gemm(const void* x, const void* q,
                                         const void* s, void* y, int m, int n,
                                         int k, int out_dtype, void* stream) {
  if (k % 2 != 0 || m <= 0 || n <= 0 || k <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Problem p{static_cast<const bf16*>(x), static_cast<const int8_t*>(q),
            static_cast<const float*>(s), y, m, n, k, false, false};
  p.vec_x = aligned(x, 16) && k % 8 == 0;
  p.vec_q = aligned(q, 8) && n % 8 == 0;
  dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  if (out_dtype == 1)
    int4_gemm_kernel<bf16><<<grid, kThreads, 0, st>>>(p);
  else if (out_dtype == 0)
    int4_gemm_kernel<float><<<grid, kThreads, 0, st>>>(p);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
