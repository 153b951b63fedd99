// Block-CSR sparse @ dense (SpMM) on Hopper.
//
// Replaces paddle_tpu/ops/kernels/pallas/bcsr_spmm.py (`bcsr_spmm`, the
// `pallas_call` of `_kernel`). It computes
//
//   y[i*bm + r, n] = sum over p in crows[i]..crows[i+1] of
//                    sum over c < bk of values[p, r, c] * x[cols[p]*bk + c, n]
//
// for the [Mb*bm, K] matrix held as crows [Mb+1], cols [NB] (int32, on the
// device) and values [NB, bm, bk], times x [K, N] (N contiguous): y
// [Mb*bm, N] in x's dtype, sums in float32, rounded once. A block row with
// no blocks gives zeros.
//
// The reference walks a sequential grid of (N tile, nonzero block) with
// first/last flags and an accumulator revisited across each block row's
// run, pads N to 128 lanes and reads the block structure on the host: all
// TPU needs. Here each CTA owns one (M tile of a block row, N tile) and
// walks its block row's run crows[i]..crows[i+1] itself, reading it on the
// device, so no flags, no host-side row table and no order between CTAs.
// For each block it stages the [TM, bk] slice of values and the matching
// [bk, TN] slice of x in shared memory, 32 deep at a time, and accumulates
// in registers; it writes its output tile once at the end (zeros for an
// empty run). M tiles past bm, and the N and bk tails, are masked: x is
// read in place, never padded.
//
// What bounds it on the H100: operations, at Llama-3-8B's MLP shapes (a
// [14336, 4096] weight in 128 x 128 blocks, half kept, times [4096, 4096]:
// 240.5 GFLOP against 210 MB, 0.243 ms at 989 TFLOP/s bf16). This first
// version is the simple one:
//   bf16: 128 x 128 output tiles, 8 warps each a 32 x 64 patch of WMMA
//         16x16x16 bf16 products with float32 accumulators (bm and bk
//         multiples of 16), synchronous 16-byte loads;
//   f32:  64 x 64 tiles, 256 threads with 4 x 4 outputs each, float32 FMA
//         on the CUDA cores (full float32: no TF32).
// TMA, wgmma and a pipelined ring of stages are later work.

#include <mma.h>

#include "gemm_tiles.cuh"

namespace {

using namespace nvcuda;
using ptt_gemm::aligned16;
using ptt_gemm::from_f32;
using ptt_gemm::load_tile;

struct Problem {
  const int* crows;
  const int* cols;
  const void* values;
  const void* x;
  void* y;
  int bm, bk, N, mtiles;
  long long ldx;  // x's row stride, in elements
  bool vec_v, vec_x;
};

// -- bf16: WMMA on the tensor cores ------------------------------------------

constexpr int kBM = 128, kBN = 128, kBK = 32, kThreads = 256;
constexpr int kPA = kBK + 8;  // pitches in elements (multiples of 8, so
constexpr int kPB = kBN + 8;  // every fragment pointer is 32-byte aligned)

__global__ void __launch_bounds__(kThreads) bcsr_spmm_wmma_kernel(Problem p) {
  using T = __nv_bfloat16;
  __shared__ __align__(128) T sA[kBM * kPA];
  __shared__ __align__(128) T sB[kBK * kPB];
  __shared__ __align__(128) float stage[kThreads / 32][16 * 16];

  const int i = blockIdx.x / p.mtiles;                 // block row
  const int m0 = (blockIdx.x % p.mtiles) * kBM;        // row within it
  const int n0 = blockIdx.y * kBN;
  const int rows = min(kBM, p.bm - m0);
  const int first = p.crows[i], last = p.crows[i + 1];
  const T* vals = static_cast<const T*>(p.values);
  const T* x = static_cast<const T*>(p.x);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 2, wn = warp % 2;  // a 32 x 64 patch per warp
  const bool live = wm * 32 < rows;        // a warp of dead rows skips mma

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) wmma::fill_fragment(acc[a][b], 0.f);

  for (int blk = first; blk < last; ++blk) {
    const T* vb = vals + (static_cast<long long>(blk) * p.bm + m0) * p.bk;
    const T* xb = x + static_cast<long long>(p.cols[blk]) * p.bk * p.ldx + n0;
    for (int k0 = 0; k0 < p.bk; k0 += kBK) {
      load_tile<T, kBM, kBK, kPA, kThreads>(vb + k0, p.bk, 1, rows,
                                            p.bk - k0, p.vec_v, sA);
      load_tile<T, kBK, kBN, kPB, kThreads>(xb + k0 * p.ldx, p.ldx, 1,
                                            p.bk - k0, p.N - n0, p.vec_x, sB);
      __syncthreads();
      if (live) {
#pragma unroll
        for (int kk = 0; kk < kBK; kk += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> fa[2];
          wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> fb[4];
#pragma unroll
          for (int a = 0; a < 2; ++a)
            wmma::load_matrix_sync(fa[a], sA + (wm * 32 + a * 16) * kPA + kk,
                                   kPA);
#pragma unroll
          for (int b = 0; b < 4; ++b)
            wmma::load_matrix_sync(fb[b], sB + kk * kPB + wn * 64 + b * 16,
                                   kPB);
#pragma unroll
          for (int a = 0; a < 2; ++a)
#pragma unroll
            for (int b = 0; b < 4; ++b)
              wmma::mma_sync(acc[a][b], fa[a], fb[b], acc[a][b]);
        }
      }
      __syncthreads();
    }
  }

  // epilogue: each fragment through a per-warp float32 stage; a lane
  // writes 8 neighbouring outputs of a live row
  T* y = static_cast<T*>(p.y);
  float* st = stage[warp];
  const long long row0 = static_cast<long long>(i) * p.bm + m0;
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      wmma::store_matrix_sync(st, acc[a][b], 16, wmma::mem_row_major);
      __syncwarp();
      const int r = wm * 32 + a * 16 + lane / 2, c = (lane % 2) * 8;
      const int n = n0 + wn * 64 + b * 16 + c;
      if (r < rows) {
        T* out = y + (row0 + r) * p.N;
#pragma unroll
        for (int e = 0; e < 8; ++e)
          if (n + e < p.N)
            out[n + e] = from_f32<T>(st[(lane / 2) * 16 + c + e]);
      }
      __syncwarp();
    }
}

// -- float32: FMA on the CUDA cores -------------------------------------------

constexpr int kFM = 64, kFN = 64, kFK = 16;
constexpr int kFPA = kFK + 4;
constexpr int kFPB = kFN + 4;

__global__ void __launch_bounds__(kThreads) bcsr_spmm_f32_kernel(Problem p) {
  __shared__ __align__(16) float sA[kFM * kFPA];
  __shared__ __align__(16) float sB[kFK * kFPB];

  const int i = blockIdx.x / p.mtiles;
  const int m0 = (blockIdx.x % p.mtiles) * kFM;
  const int n0 = blockIdx.y * kFN;
  const int rows = min(kFM, p.bm - m0);
  const int first = p.crows[i], last = p.crows[i + 1];
  const float* vals = static_cast<const float*>(p.values);
  const float* x = static_cast<const float*>(p.x);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;  // 4 x 4 outputs

  float acc[4][4] = {};
  for (int blk = first; blk < last; ++blk) {
    const float* vb =
        vals + (static_cast<long long>(blk) * p.bm + m0) * p.bk;
    const float* xb =
        x + static_cast<long long>(p.cols[blk]) * p.bk * p.ldx + n0;
    for (int k0 = 0; k0 < p.bk; k0 += kFK) {
      load_tile<float, kFM, kFK, kFPA, kThreads>(vb + k0, p.bk, 1, rows,
                                                 p.bk - k0, p.vec_v, sA);
      load_tile<float, kFK, kFN, kFPB, kThreads>(xb + k0 * p.ldx, p.ldx, 1,
                                                 p.bk - k0, p.N - n0,
                                                 p.vec_x, sB);
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kFK; ++kk) {
        float a[4], b[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) a[u] = sA[(ty * 4 + u) * kFPA + kk];
#pragma unroll
        for (int v = 0; v < 4; ++v) b[v] = sB[kk * kFPB + tx * 4 + v];
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int v = 0; v < 4; ++v) acc[u][v] = fmaf(a[u], b[v], acc[u][v]);
      }
      __syncthreads();
    }
  }
  float* y = static_cast<float*>(p.y);
  const long long row0 = static_cast<long long>(i) * p.bm + m0;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int r = ty * 4 + u;
    if (r >= rows) continue;
    float* out = y + (row0 + r) * p.N;
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int n = n0 + tx * 4 + v;
      if (n < p.N) out[n] = acc[u][v];
    }
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (ops/kernels/_build.DTYPE_CODES); bf16
// needs bm and bk to be multiples of 16. Returns the cudaError_t of the
// launch.
extern "C" int ptt_bcsr_spmm(const void* crows, const void* cols,
                             const void* values, const void* x, void* y,
                             int Mb, int bm, int bk, int N, long long ldx,
                             int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Problem p{static_cast<const int*>(crows), static_cast<const int*>(cols),
            values, x, y, bm, bk, N, 0, ldx, false, false};
  const long long v = dtype == 1 ? 8 : 4;  // elements per 16 bytes
  p.vec_v = aligned16(values) && bk % v == 0;
  p.vec_x = aligned16(x) && ldx % v == 0;
  if (Mb <= 0 || bm <= 0 || bk <= 0 || N <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 1) {
    if (bm % 16 || bk % 16) return static_cast<int>(cudaErrorInvalidValue);
    p.mtiles = (bm + kBM - 1) / kBM;
    dim3 grid(Mb * p.mtiles, (N + kBN - 1) / kBN);
    bcsr_spmm_wmma_kernel<<<grid, kThreads, 0, s>>>(p);
  } else if (dtype == 0) {
    p.mtiles = (bm + kFM - 1) / kFM;
    dim3 grid(Mb * p.mtiles, (N + kFN - 1) / kFN);
    bcsr_spmm_f32_kernel<<<grid, kThreads, 0, s>>>(p);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
