// Grouped (ragged) GEMM on Hopper: the MoE expert products.
//
// Replaces paddle_tpu/ops/kernels/pallas/grouped_gemm.py `_gmm_impl` (:109)
// with its two Pallas kernels `_gmm_kernel` (:52) and `_gmm_wide_kernel`
// (:72). It computes what they compute, not block by block:
//
//   y[g, c, :] = x[g, c, :] @ w[g / gpe]   for c <  counts[g]
//   y[g, c, :] = 0                          for c >= counts[g]
//
// x [G, C, K] (K contiguous), w [E, K, N] with any element strides, so the
// backward's dx = dy @ w^T reads a transposed view of w without a copy; y is
// a new contiguous [G, C, N] tensor in x's dtype. Sums are float32 and round
// once to the output dtype. One design covers both of the reference's
// regimes (its wide-N split is about the TPU's VMEM and means nothing here).
//
// Grid (N tiles, C tiles, G). A block reads counts[g] from device memory
// (no host sync); a C tile that starts at or past counts[g] writes zeros
// and returns, so the products scale with the routed rows, not with G*C.
// In the partial tile, rows past counts[g] load as zeros and store as
// zeros. Tail tiles of C, K and N are masked, so any size works.
//
// What bounds it on the H100: bytes. At the MoE training shapes (G = E =
// 64, C = 480, K x N = 2048 x 1408, ~24.6k routed rows) one launch moves
// ~556 MB (each routed-to expert's weight once, the live x rows, the whole
// y: 0.166 ms at 3.35 TB/s) for 142 GFLOP (0.143 ms at 989 TFLOP/s bf16). This first
// version is the simple one:
//   bf16: 128 x 128 output tiles, 8 warps, each a 32 x 64 patch of WMMA
//         16x16x16 bf16 products with float32 accumulators; 32-deep K steps
//         through shared memory with synchronous 16-byte loads;
//   f32:  64 x 64 tiles, 256 threads with 4 x 4 outputs each, float32 FMA
//         on the CUDA cores (full float32: no TF32).
// TMA, wgmma and a pipelined ring of K steps are later work.

#include <mma.h>

#include <type_traits>

#include "gemm_tiles.cuh"

namespace {

using namespace nvcuda;
using ptt_gemm::aligned16;
using ptt_gemm::from_f32;
using ptt_gemm::load_tile;

struct Problem {
  const void* x;
  const void* w;
  void* y;
  const int* counts;
  int G, C, K, N, gpe;
  long long xs_g, xs_c;        // x strides (K contiguous)
  long long ws_e, ws_k, ws_n;  // w strides
  bool vec_x, vec_w;
};

// The live rows of the block's C tile (at most BM); a dead tile (one that
// starts at or past counts[g]) is zero-filled here and gives 0.
template <typename T, int BM, int BN, int NT>
__device__ __forceinline__ int tile_rows(const Problem& p, int g, int m0,
                                         int n0) {
  int cnt = p.counts[g];
  cnt = cnt < 0 ? 0 : (cnt > p.C ? p.C : cnt);
  if (m0 < cnt) return cnt - m0 < BM ? cnt - m0 : BM;
  T* y = static_cast<T*>(p.y);
  for (int i = threadIdx.x; i < BM * BN; i += NT) {
    const int m = m0 + i / BN, n = n0 + i % BN;
    if (m < p.C && n < p.N)
      y[(static_cast<long long>(g) * p.C + m) * p.N + n] = from_f32<T>(0.f);
  }
  return 0;
}

// w's K x N tile at (k0, n0) of expert e, as [BK][BN] (kColB false: row
// k, n fastest) or [BN][BK] (kColB true: for a w whose K is contiguous).
template <typename T, bool kColB, int BK, int BN, int PB, int NT>
__device__ __forceinline__ void load_w(const Problem& p, const T* we, int k0,
                                       int n0, T* sB) {
  if constexpr (kColB)
    load_tile<T, BN, BK, PB, NT>(we + k0 * p.ws_k + n0 * p.ws_n, p.ws_n,
                                 p.ws_k, p.N - n0, p.K - k0, p.vec_w, sB);
  else
    load_tile<T, BK, BN, PB, NT>(we + k0 * p.ws_k + n0 * p.ws_n, p.ws_k,
                                 p.ws_n, p.K - k0, p.N - n0, p.vec_w, sB);
}

// -- bf16: WMMA on the tensor cores ------------------------------------------

constexpr int kBM = 128, kBN = 128, kBK = 32, kThreads = 256;
constexpr int kPA = kBK + 8;   // pitches in elements (multiples of 8, so
constexpr int kPBr = kBN + 8;  // every fragment pointer is 32-byte
constexpr int kPBc = kBK + 8;  // aligned)

template <bool kColB>
__global__ void __launch_bounds__(kThreads)
    grouped_gemm_wmma_kernel(Problem p) {
  using T = __nv_bfloat16;
  constexpr int PB = kColB ? kPBc : kPBr;
  constexpr int B_ELEMS = kColB ? kBN * kPBc : kBK * kPBr;
  __shared__ __align__(128) T sA[kBM * kPA];
  __shared__ __align__(128) T sB[B_ELEMS];
  __shared__ __align__(128) float stage[kThreads / 32][16 * 16];

  const int g = blockIdx.z, m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int rows = tile_rows<T, kBM, kBN, kThreads>(p, g, m0, n0);
  if (rows == 0) return;
  const T* xg = static_cast<const T*>(p.x) + g * p.xs_g + m0 * p.xs_c;
  const T* we = static_cast<const T*>(p.w) + (g / p.gpe) * p.ws_e;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 2, wn = warp % 2;  // a 32 x 64 patch per warp
  const bool live = wm * 32 < rows;        // a warp of dead rows skips mma

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  using LayoutB = typename std::conditional<kColB, wmma::col_major,
                                            wmma::row_major>::type;
  for (int k0 = 0; k0 < p.K; k0 += kBK) {
    load_tile<T, kBM, kBK, kPA, kThreads>(xg + k0, p.xs_c, 1, rows, p.K - k0,
                                          p.vec_x, sA);
    load_w<T, kColB, kBK, kBN, PB, kThreads>(p, we, k0, n0, sB);
    __syncthreads();
    if (live) {
#pragma unroll
      for (int kk = 0; kk < kBK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> a[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, T, LayoutB> b[4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(a[i], sA + (wm * 32 + i * 16) * kPA + kk,
                                 kPA);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = wn * 64 + j * 16;
          wmma::load_matrix_sync(b[j], kColB ? sB + n * PB + kk
                                             : sB + kk * PB + n, PB);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

  // epilogue: each fragment through a per-warp float32 stage; a lane
  // writes 8 neighbouring outputs, zero past the live rows
  T* y = static_cast<T*>(p.y);
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
      if (m < p.C) {
        T* out = y + (static_cast<long long>(g) * p.C + m) * p.N;
#pragma unroll
        for (int e = 0; e < 8; ++e)
          if (n + e < p.N)
            out[n + e] = from_f32<T>(m < m0 + rows ? st[r * 16 + c + e] : 0.f);
      }
      __syncwarp();
    }
}

// -- float32: FMA on the CUDA cores -------------------------------------------

constexpr int kFM = 64, kFN = 64, kFK = 16;
constexpr int kFPA = kFK + 4;
constexpr int kFPBr = kFN + 4;
constexpr int kFPBc = kFK + 4;

template <bool kColB>
__global__ void __launch_bounds__(kThreads)
    grouped_gemm_f32_kernel(Problem p) {
  using T = float;
  constexpr int PB = kColB ? kFPBc : kFPBr;
  constexpr int B_ELEMS = kColB ? kFN * kFPBc : kFK * kFPBr;
  __shared__ __align__(16) float sA[kFM * kFPA];
  __shared__ __align__(16) float sB[B_ELEMS];

  const int g = blockIdx.z, m0 = blockIdx.y * kFM, n0 = blockIdx.x * kFN;
  const int rows = tile_rows<T, kFM, kFN, kThreads>(p, g, m0, n0);
  if (rows == 0) return;
  const T* xg = static_cast<const T*>(p.x) + g * p.xs_g + m0 * p.xs_c;
  const T* we = static_cast<const T*>(p.w) + (g / p.gpe) * p.ws_e;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;  // 4 x 4 outputs

  float acc[4][4] = {};
  for (int k0 = 0; k0 < p.K; k0 += kFK) {
    load_tile<T, kFM, kFK, kFPA, kThreads>(xg + k0, p.xs_c, 1, rows,
                                           p.K - k0, p.vec_x, sA);
    load_w<T, kColB, kFK, kFN, PB, kThreads>(p, we, k0, n0, sB);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kFK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sA[(ty * 4 + i) * kFPA + kk];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        b[j] = kColB ? sB[(tx * 4 + j) * PB + kk] : sB[kk * PB + tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* y = static_cast<float*>(p.y);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= p.C) continue;
    float* out = y + (static_cast<long long>(g) * p.C + m) * p.N;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < p.N) out[n] = m < m0 + rows ? acc[i][j] : 0.f;
    }
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (ops/kernels/_build.DTYPE_CODES). Returns
// the cudaError_t of the launch.
extern "C" int ptt_grouped_gemm(const void* x, const void* w, void* y,
                                const void* counts, int G, int C, int K,
                                int N, int gpe, long long xs_g,
                                long long xs_c, long long ws_e,
                                long long ws_k, long long ws_n, int dtype,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Problem p{x, w, y, static_cast<const int*>(counts), G, C, K, N, gpe,
            xs_g, xs_c, ws_e, ws_k, ws_n, false, false};
  const long long v = dtype == 1 ? 8 : 4;  // elements per 16 bytes
  // w's contiguous axis: N (row-major tiles), else K (column-major
  // tiles: the transposed view of dx), else neither (element loads)
  const bool col_b = ws_n != 1 && ws_k == 1;
  const long long w_other = col_b ? ws_n : ws_k;
  p.vec_x = aligned16(x) && xs_g % v == 0 && xs_c % v == 0;
  p.vec_w = aligned16(w) && ws_e % v == 0 && w_other % v == 0 &&
            (col_b || ws_n == 1);
  if (dtype == 1) {
    dim3 grid((N + kBN - 1) / kBN, (C + kBM - 1) / kBM, G);
    if (col_b)
      grouped_gemm_wmma_kernel<true><<<grid, kThreads, 0, s>>>(p);
    else
      grouped_gemm_wmma_kernel<false><<<grid, kThreads, 0, s>>>(p);
  } else if (dtype == 0) {
    dim3 grid((N + kFN - 1) / kFN, (C + kFM - 1) / kFM, G);
    if (col_b)
      grouped_gemm_f32_kernel<true><<<grid, kThreads, 0, s>>>(p);
    else
      grouped_gemm_f32_kernel<false><<<grid, kThreads, 0, s>>>(p);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
