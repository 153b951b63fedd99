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
// device, so no flags, no host-side row table and no order between CTAs;
// it writes its output tile once at the end (zeros for an empty run, no
// k tile run). x is read in place, never padded. No atomics: two launches
// give the same bytes.
//
// What bounds it on the H100: operations, at Llama-3-8B's MLP shapes (a
// [14336, 4096] weight in 128 x 128 blocks, half kept, times [4096, 4096]:
// 240.5 GFLOP against 210 MB, 0.243 ms at 989 TFLOP/s bf16), so the bf16
// design is about keeping the tensor cores fed. A block row's run is just
// a k loop whose tiles are looked up through `cols`, so it runs on the
// pipelined wgmma mainloop of gemm_wgmma.cuh, as the grouped GEMM does.
// Routes, picked in ptt_bcsr_spmm before any launch (ptt_bcsr_spmm_route
// says which):
//
// - bf16, 16-byte-aligned rows (values and x 16-byte aligned, x's row
//   stride a multiple of 8 elements): bcsr_spmm_wgmma_kernel<TM>. Its k
//   tiles are the 64-deep slices of the run's blocks in CSR order (tile t
//   is block crows[i] + t / ceil(bk/64), slice t % ceil(bk/64)); a tile
//   never straddles two blocks: A's columns and B's rows past bk are
//   zero-filled, so bk = 16 .. 48 and any bk not a multiple of 64 take the
//   same path. A is the block's [TM, 64] values slice, K-major; B the
//   matching [64, 256] rows of x, MN-major through wgmma's transpose bit
//   (the grouped GEMM forward's layout). The M tile follows the block: 64
//   rows (one consumer warpgroup) for bm <= 64, else 128 (two); rows past
//   bm load as zeros and are never stored (at bm = 16 the tensor cores do
//   4x the needed work, still under the dense product's time there). A
//   4-stage ring of cp.async copies, one wgmma group left running across
//   the barrier; the next block's column id is loaded a block ahead. The
//   epilogue stages each warpgroup's tile in shared memory and stores 16-
//   byte chunks of rows (single elements when N % 8 != 0; x's columns past
//   N inside the last 16-byte chunk are read but reach only unstored
//   columns). The grid runs block rows with the most kept blocks first
//   (the wrapper's `order`), and the N tiles of one block row back to
//   back, so a row's values are read from device memory about once.
// - bf16 otherwise: bcsr_spmm_wmma_kernel, the first design: 128 x 128
//   output tiles, 8 warps each a 32 x 64 patch of WMMA 16x16x16 products,
//   synchronous 32-deep k steps (bm and bk multiples of 16).
// - float32: bcsr_spmm_f32_kernel<TM>, full float32 FMA on the CUDA
//   cores (no TF32), so its bound is operations at 67 TFLOP/s: 3.54 ms at
//   half of `gate_proj` in 128 x 128 blocks times 4096 columns, 0.016 ms
//   for the [2048, 1024] weight in 16 x 128 blocks times 512 columns
//   (where x, re-read from L2 for every block row, weighs more). It runs
//   the run's 16-deep block slices on the pipelined mainloop of
//   gemm_f32.cuh: the values slice staged through registers and stored
//   k-major, x's rows copied by cp.async (4-byte copies where its rows
//   are not 16-byte aligned), a 3-slot ring with the next tiles' loads in
//   flight during the FMAs. The M tile follows the block: the smallest of
//   16, 32, 64 and 128 rows that holds bm (a row tail past 128), so rows
//   past bm are never computed (the first design ran 64-row tiles, 4x
//   the work at bm 16). 128 columns a tile and 8 x 8 (TM 64, 128) or 4 x
//   8 (TM 32) sums a thread; at TM 16, 64 columns, 4 x 4 sums and two k
//   groups, since there the longest block rows set the launch's time and
//   more, shorter chains shorten it. Block rows run in the wrapper's
//   `order`, as the wgmma route's do.

#include <mma.h>

#include "gemm_f32.cuh"
#include "gemm_tiles.cuh"
#include "gemm_wgmma.cuh"

namespace {

using namespace nvcuda;
using ptt_gemm::aligned16;
using ptt_gemm::from_f32;
using ptt_gemm::load_tile;

struct Problem {
  const int* crows;
  const int* cols;
  const int* order;  // block rows in launch order (the float32 route)
  const void* values;
  const void* x;
  void* y;
  int bm, bk, N, mtiles, ntiles;
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

// -- float32: FMA on the CUDA cores, on the ring of gemm_f32.cuh -------------

// The ring's policy (gemm_f32.cuh) over one block row's run, its k tiles
// the kBK-deep slices of the run's blocks in CSR order (tile t is block t
// / spb, slice t % spb; a tile never straddles two blocks, columns and
// rows past bk are zero-filled). A is the block's [TM, kBK] values slice,
// staged through registers (k contiguous); B the matching [kBK, 128] rows
// of x, copied by cp.async. fill() is called for a k group's tiles in
// increasing order, so it walks the run with its own counters and loads
// the next block's column id a block ahead of its use.
template <int TM>
struct BcsrF32Tiles {
  using G = ptt::f32::Tile<TM>;
  const float* v;       // row m0 of the run's first block
  const float* x;       // column n0 of x
  const int* cols;      // the run's column-block ids
  long long ldx, vblk;  // x's row stride; elements of one block
  int rows, bk, spb, ncols, nblk;
  bool vec_v, vec_x;
  int ft, fb, fs, col, col_next;  // the walk's tile, block, slice, ids
  ptt::f32::Staged<TM, G::NT> a;

  __device__ __forceinline__ void fetch(int t) {
    const int b = t / spb, k0 = (t - b * spb) * ptt::f32::kBK;
    a.fetch(v + b * vblk + k0, bk, rows, bk - k0, vec_v);
  }

  __device__ __forceinline__ void put(float* slot) const { a.put(slot); }

  __device__ __forceinline__ void fill(float* slot, int t) {
    for (; ft < t; ++ft)
      if (++fs == spb) {
        fs = 0;
        ++fb;
        col = col_next;
        col_next = fb + 1 < nblk ? cols[fb + 1] : 0;
      }
    const int k0 = fs * ptt::f32::kBK;
    ptt::f32::fill_rows<G::TN, G::NT>(
        ptt::wg::smem_u32(slot + ptt::f32::kBK * G::PA),
        x + (static_cast<long long>(col) * bk + k0) * ldx, ldx, 1, bk - k0,
        ncols, vec_x);
  }
};

// grid: (M tile of a block row, N tile) pairs, N fastest, block rows in
// `order`; Tile<TM>::THREADS threads. Rows past bm are never computed: the
// M tile is the smallest that holds bm (a row tail past 128).
template <int TM>
__global__ void __launch_bounds__(ptt::f32::Tile<TM>::THREADS,
                                  ptt::f32::Tile<TM>::MINB)
    bcsr_spmm_f32_kernel(Problem p) {
  using G = ptt::f32::Tile<TM>;
  extern __shared__ float4 f32_smem[];
  const int tile = blockIdx.x / p.ntiles, nt = blockIdx.x % p.ntiles;
  const int i = p.order[tile / p.mtiles];  // block row
  const int m0 = (tile % p.mtiles) * TM, n0 = nt * G::TN;
  const int rows = min(TM, p.bm - m0);
  const int first = p.crows[i], nblk = p.crows[i + 1] - first;
  const int spb = (p.bk + ptt::f32::kBK - 1) / ptt::f32::kBK;
  BcsrF32Tiles<TM> tiles{
      static_cast<const float*>(p.values) +
          (static_cast<long long>(first) * p.bm + m0) * p.bk,
      static_cast<const float*>(p.x) + n0, p.cols + first, p.ldx,
      static_cast<long long>(p.bm) * p.bk, rows, p.bk, spb, p.N - n0, nblk,
      p.vec_v, p.vec_x, 0, 0, 0, nblk > 0 ? p.cols[first] : 0,
      nblk > 1 ? p.cols[first + 1] : 0};
  ptt::f32::Acc<TM> acc = {};
  ptt::f32::mainloop<TM>(tiles, nblk * spb,
                         reinterpret_cast<float*>(f32_smem), acc);
  float* y = static_cast<float*>(p.y) +
             (static_cast<long long>(i) * p.bm + m0) * p.N + n0;
  ptt::f32::store_tile<TM>(acc, p.N - n0, p.N % 4 == 0, rows,
                           [&](int r) -> float* {
                             return r < rows
                                        ? y + static_cast<long long>(r) * p.N
                                        : nullptr;
                           });
}

// -- bf16, aligned: wgmma on the pipelined ring ------------------------------

constexpr int kTN = 256, kTStages = 4;

struct Sparse {
  const int* crows;
  const int* cols;
  const int* order;  // block rows in launch order
  const __nv_bfloat16* values;
  const __nv_bfloat16* x;
  __nv_bfloat16* y;
  int bm, bk, N, mtiles, ntiles;
  long long ldx;
};

template <int TM>
__host__ __device__ constexpr uint32_t tile_a_bytes() {
  return TM * ptt::gemm::kBK * 2;
}
template <int TM>
__host__ __device__ constexpr uint32_t stage_bytes() {
  return tile_a_bytes<TM>() + kTN * ptt::gemm::kBK * 2;
}
template <int TM>
__host__ __device__ constexpr int smem_bytes() {
  return kTStages * stage_bytes<TM>() + 1024;
}

// The ring's policy (gemm_wgmma.cuh) over one block row's run. fill() is
// called for tiles 0, 1, 2, ... in order, so it walks the run with its
// own (block, slice) counters and loads the next block's column id one
// block ahead of its use.
template <int TM>
struct BcsrTiles {
  using T = __nv_bfloat16;
  static constexpr int NT = 2 * TM;  // one warpgroup per 64 rows
  const T* v;        // row m0 of the run's first block
  const T* x;        // column n0 of x
  const int* cols;   // the run's column-block ids
  long long ldx, vblk;  // x's row stride; elements of one block
  int rows, bk, spb, ncols, nblk, wg;
  bool live;         // the warpgroup has a row below bm
  uint32_t base;
  int fb, fs, col, col_next;  // the next fill's block, slice, column ids

  __device__ __forceinline__ void fill(int slot, int) {
    // (qualified: this file's kBK is the WMMA kernel's 32-deep step)
    const int k0 = fs * ptt::gemm::kBK;
    const uint32_t sA = base + slot * stage_bytes<TM>();
    const uint32_t sB = sA + tile_a_bytes<TM>();
    ptt::gemm::load_k_tile<TM, NT>(sA, v + fb * vblk + k0, bk, rows,
                                   bk - k0);
    ptt::gemm::load_mn_tile<ptt::gemm::kBK, kTN, NT>(
        sB, x + (static_cast<long long>(col) * bk + k0) * ldx, ldx, bk - k0,
        ncols);
    if (++fs == spb) {
      fs = 0;
      ++fb;
      col = col_next;
      col_next = fb + 1 < nblk ? cols[fb + 1] : 0;
    }
  }

  __device__ __forceinline__ void consume(int slot, int,
                                          float (&acc)[kTN / 2]) {
    using namespace ptt::wg;
    if (!live) return;
    const uint32_t sA = base + slot * stage_bytes<TM>();
    const uint32_t sB = sA + tile_a_bytes<TM>();
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      ptt::gemm::mma_ss_n256<1>(acc, desc_k<TM>(sA + wg * 64 * 128, kk),
                                desc_mn<ptt::gemm::kBK>(sB, kk));
    wg_commit();
    wg_wait_but<1>();
    reg_fence(acc);
  }
};

// One warpgroup's m64n256 sums to rows that are not 16-byte aligned: the
// staging of store_wg_tile, then one element a store.
template <class RowPtr>
__device__ __forceinline__ void store_wg_tile_elems(
    const float (&acc)[kTN / 2], uint8_t* stage, int wg, int ncols,
    RowPtr row_ptr) {
  using T = __nv_bfloat16;
  constexpr int P = kTN * 2 + 16;  // row pitch in bytes, as store_wg_tile
  ptt::gemm::for_each_pair<kTN>(acc, [&](int r, int c, float v0, float v1) {
    ptt::gemm::store_pair(reinterpret_cast<T*>(stage + r * P) + c, v0, v1);
  });
  ptt::gemm::wg_barrier(wg);
  for (int v = threadIdx.x % 128; v < 64 * kTN; v += 128) {
    const int r = v / kTN, c = v % kTN;
    T* out = row_ptr(r);
    if (out != nullptr && c < ncols)
      out[c] = reinterpret_cast<const T*>(stage + r * P)[c];
  }
}

// grid: (M tile of a block row, N tile) pairs, N fastest, block rows in
// `order`; 2 * TM threads
template <int TM>
__global__ void __launch_bounds__(2 * TM, 1)
    bcsr_spmm_wgmma_kernel(Sparse p) {
  using T = __nv_bfloat16;
  extern __shared__ uint8_t smem[];
  const int tile = blockIdx.x / p.ntiles, nt = blockIdx.x % p.ntiles;
  const int ri = tile / p.mtiles;
  const int i = p.order[ri];  // block row
  const int m0 = (tile % p.mtiles) * TM, n0 = nt * kTN;
  const int rows = min(TM, p.bm - m0);
  const int first = p.crows[i], nblk = p.crows[i + 1] - first;
  const int wg = threadIdx.x / 128;
  const uint32_t raw = ptt::wg::smem_u32(smem);
  const uint32_t base = (raw + 1023u) & ~1023u;
  BcsrTiles<TM> tiles{
      p.values + (static_cast<long long>(first) * p.bm + m0) * p.bk,
      p.x + n0, p.cols + first, p.ldx,
      static_cast<long long>(p.bm) * p.bk, rows, p.bk,
      (p.bk + ptt::gemm::kBK - 1) / ptt::gemm::kBK, p.N - n0, nblk, wg,
      64 * wg < rows, base, 0, 0, nblk > 0 ? p.cols[first] : 0,
      nblk > 1 ? p.cols[first + 1] : 0};
  float acc[kTN / 2];
#pragma unroll
  for (int j = 0; j < kTN / 2; ++j) acc[j] = 0.f;
  ptt::gemm::mainloop<kTStages, 1>(tiles, nblk * tiles.spb, acc);
  __syncthreads();  // every product done: the ring becomes the epilogue's

  const int mw = 64 * wg;
  T* y = p.y + (static_cast<long long>(i) * p.bm + m0 + mw) * p.N + n0;
  auto row_ptr = [&](int r) -> T* {
    return mw + r < rows ? y + static_cast<long long>(r) * p.N : nullptr;
  };
  uint8_t* stage =
      smem + (base - raw) + wg * ptt::gemm::wg_stage_bytes<T, kTN>();
  if (p.N % 8 == 0)
    ptt::gemm::store_wg_tile<T, kTN>(
        acc, stage, wg, p.N - n0, [](int, int, float v) { return v; },
        row_ptr);
  else
    store_wg_tile_elems(acc, stage, wg, p.N - n0, row_ptr);
}

enum Route { kRouteF32 = 0, kRouteWmma = 1, kRouteWgmma = 2 };

int route(const void* values, const void* x, int bk, long long ldx,
          int dtype) {
  if (dtype != 1) return kRouteF32;
  return aligned16(values) && aligned16(x) && ldx % 8 == 0 && bk % 8 == 0
             ? kRouteWgmma
             : kRouteWmma;
}

template <int TM>
int launch_wgmma(const Sparse& p, int Mb, cudaStream_t s) {
  Sparse q = p;
  q.mtiles = (p.bm + TM - 1) / TM;
  q.ntiles = (p.N + kTN - 1) / kTN;
  PTT_SET_SMEM(bcsr_spmm_wgmma_kernel<TM>, smem_bytes<TM>());
  const long long grid = static_cast<long long>(Mb) * q.mtiles * q.ntiles;
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  bcsr_spmm_wgmma_kernel<TM><<<static_cast<unsigned>(grid), 2 * TM,
                               smem_bytes<TM>(), s>>>(q);
  return static_cast<int>(cudaGetLastError());
}

template <int TM>
int launch_f32(const Problem& p, int Mb, cudaStream_t s) {
  using G = ptt::f32::Tile<TM>;
  Problem q = p;
  q.mtiles = (p.bm + TM - 1) / TM;
  q.ntiles = (p.N + G::TN - 1) / G::TN;
  PTT_SET_SMEM(bcsr_spmm_f32_kernel<TM>, G::SMEM);
  const long long grid = static_cast<long long>(Mb) * q.mtiles * q.ntiles;
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  bcsr_spmm_f32_kernel<TM>
      <<<static_cast<unsigned>(grid), G::THREADS, G::SMEM, s>>>(q);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The kernel ptt_bcsr_spmm launches for these arguments: 0 float32 FMA,
// 1 bf16 WMMA, 2 bf16 wgmma.
extern "C" int ptt_bcsr_spmm_route(const void* values, const void* x, int bk,
                                   long long ldx, int dtype) {
  return route(values, x, bk, ldx, dtype);
}

// dtype: 0 float32, 1 bfloat16 (ops/kernels/_build.DTYPE_CODES); bf16
// needs bm and bk to be multiples of 16. order: the block rows in launch
// order ([Mb] int32 on the device, a permutation of 0 .. Mb - 1), read by
// the wgmma route only.
// Returns the cudaError_t of the launch.
extern "C" int ptt_bcsr_spmm(const void* crows, const void* cols,
                             const void* order, const void* values,
                             const void* x, void* y, int Mb, int bm, int bk,
                             int N, long long ldx, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Problem p{static_cast<const int*>(crows), static_cast<const int*>(cols),
            static_cast<const int*>(order), values, x, y, bm, bk, N, 0, 0,
            ldx, false, false};
  const long long v = dtype == 1 ? 8 : 4;  // elements per 16 bytes
  p.vec_v = aligned16(values) && bk % v == 0;
  p.vec_x = aligned16(x) && ldx % v == 0;
  if (Mb <= 0 || bm <= 0 || bk <= 0 || N <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 1) {
    if (bm % 16 || bk % 16) return static_cast<int>(cudaErrorInvalidValue);
    if (route(values, x, bk, ldx, dtype) == kRouteWgmma) {
      using T = __nv_bfloat16;
      const Sparse sp{static_cast<const int*>(crows),
                      static_cast<const int*>(cols),
                      static_cast<const int*>(order),
                      static_cast<const T*>(values), static_cast<const T*>(x),
                      static_cast<T*>(y), bm, bk, N, 0, 0, ldx};
      return bm <= 64 ? launch_wgmma<64>(sp, Mb, s)
                      : launch_wgmma<128>(sp, Mb, s);
    }
    p.mtiles = (bm + kBM - 1) / kBM;
    dim3 grid(Mb * p.mtiles, (N + kBN - 1) / kBN);
    bcsr_spmm_wmma_kernel<<<grid, kThreads, 0, s>>>(p);
  } else if (dtype == 0) {
    return bm <= 16   ? launch_f32<16>(p, Mb, s)
           : bm <= 32 ? launch_f32<32>(p, Mb, s)
           : bm <= 64 ? launch_f32<64>(p, Mb, s)
                      : launch_f32<128>(p, Mb, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
