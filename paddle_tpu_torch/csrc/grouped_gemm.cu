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
// and loads nothing, so the products scale with the routed rows, not
// with G*C. In the partial tile, rows past counts[g] load as zeros and
// store as zeros. Tail tiles of C, K and N are masked.
//
// What bounds it on the H100: at the MoE training shapes (G = E = 64, C =
// 480, K x N = 2048 x 1408, ~24.6k routed rows) one bf16 launch moves
// ~556 MB (each routed-to expert's weight once, the live x rows, the
// whole y: 0.166 ms at 3.35 TB/s) for 142 GFLOP (0.143 ms at 989 TFLOP/s
// bf16): both, nearly equally, so the bf16 design has to keep the tensor
// cores fed while it streams; float32 (below) is bound by its FMAs.
//
// Routes, picked by shape in ptt_grouped_gemm before any launch
// (ptt_grouped_gemm_route says which):
//
// - bf16, 16-byte-aligned rows (x and w 16-byte aligned, K and N and
//   every stride but w's unit one multiples of 8): grouped_gemm_wgmma_kernel,
//   on the pipelined mainloop of gemm_wgmma.cuh. 128 x 256 output tiles
//   (a tile's x rows are read once for 256 columns: the loads, from L2,
//   are what limits it, so the wide tile's 25% fewer bytes per product
//   count), two consumer warpgroups of m64n256k16 wgmma, a 4-stage ring
//   of 64-deep k tiles filled by cp.async (193 KB, one block an SM), one
//   wgmma group left running while the block passes the next barrier.
//   x's C tile is the K-major A; w's tile is MN-major in the forward ([E,
//   K, N], N contiguous) and K-major for dx (the strided w.transpose(1,
//   2) view), both through one swizzled load and wgmma's transpose bit.
//   The epilogue stages each warpgroup's tile in shared memory and stores
//   16-byte chunks of rows.
// - bf16 otherwise (rows not 16-byte aligned, w with neither axis
//   contiguous): grouped_gemm_wmma_kernel, the first design: 128 x 128
//   tiles, WMMA 16x16x16 from padded shared memory, 32-deep synchronous k
//   steps, element loads where a chunk is not aligned.
// - float32: grouped_gemm_f32_kernel, full float32 FMA on the CUDA cores
//   (no TF32), so its bound is operations at 67 TFLOP/s: ~2.0 ms for each
//   of the MoE shapes' four launches (gate/up and down, forward and dx),
//   against ~0.17 ms of bytes. It runs on the pipelined mainloop of
//   gemm_f32.cuh: 64 x 128 output tiles in the forward (128 threads; a
//   group's last C tile holds fewer dead rows than a 128-row one) and 128
//   x 128 for dx (256 threads), each thread keeping 8 x 8 sums in
//   registers (every shared value feeds 8 FMAs, read as conflict-free
//   float4s), a 3-slot ring of 16-deep k tiles with the next tiles' loads
//   in flight during the FMAs. x's C tile is staged
//   through registers and stored k-major; w's tile is copied by cp.async
//   in the forward ([E, K, N]: 16-byte copies, or 4-byte ones when
//   neither axis is contiguous) and staged like x for dx's transposed
//   view. Dead tiles and rows as above.

#include <mma.h>

#include <type_traits>

#include "gemm_f32.cuh"
#include "gemm_tiles.cuh"
#include "gemm_wgmma.cuh"

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

// -- bf16, any strides: WMMA on the tensor cores ------------------------------

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

// -- float32: FMA on the CUDA cores, on the ring of gemm_f32.cuh -------------

// The float32 tile: 64 x 128 in the forward (a group's last C tile holds
// fewer dead rows than a 128-row one), 128 x 128 for dx (its staged B
// tile needs the 256 threads of the 128-row block to stay in registers).
template <bool kColB>
using F32Tile = ptt::f32::Tile<kColB ? 128 : 64>;

// The ring's policy (gemm_f32.cuh): x's C tile is A, staged through
// registers (K contiguous); w's tile is B, copied by cp.async when its K
// axis is the row axis ([E, K, N]; element copies when neither axis is
// contiguous) or, kColB, staged like A (dx's transposed view: K
// contiguous).
template <bool kColB>
struct GmmF32Tiles {
  using G = F32Tile<kColB>;
  const float* x;  // row m0 of group g
  const float* w;  // column n0 of expert g / gpe
  long long xs, ws_k, ws_n;
  int rows, K, ncols;
  bool vec_x, vec_w;
  ptt::f32::Staged<G::M, G::NT> a;
  ptt::f32::Staged<G::TN, G::NT> b;  // kColB only

  __device__ __forceinline__ void fetch(int t) {
    const int k0 = t * ptt::f32::kBK;
    a.fetch(x + k0, xs, rows, K - k0, vec_x);
    if constexpr (kColB) b.fetch(w + k0, ws_n, ncols, K - k0, vec_w);
  }

  __device__ __forceinline__ void put(float* slot) const {
    a.put(slot);
    if constexpr (kColB) b.put(slot + ptt::f32::kBK * G::PA);
  }

  __device__ __forceinline__ void fill(float* slot, int t) {
    if constexpr (!kColB) {
      const int k0 = t * ptt::f32::kBK;
      ptt::f32::fill_rows<G::TN, G::NT>(
          ptt::wg::smem_u32(slot + ptt::f32::kBK * G::PA), w + k0 * ws_k,
          ws_k, ws_n, K - k0, ncols, vec_w);
    }
  }
};

// grid (N tiles, C tiles, G) of F32Tile output tiles, each thread 8 x 8
// sums
template <bool kColB>
__global__ void __launch_bounds__(F32Tile<kColB>::THREADS,
                                  F32Tile<kColB>::MINB)
    grouped_gemm_f32_kernel(Problem p) {
  using G = F32Tile<kColB>;
  extern __shared__ float4 f32_smem[];
  const int g = blockIdx.z, m0 = blockIdx.y * G::M, n0 = blockIdx.x * G::TN;
  const int rows = tile_rows<float, G::M, G::TN, G::THREADS>(p, g, m0, n0);
  if (rows == 0) return;
  const float* we = static_cast<const float*>(p.w) + (g / p.gpe) * p.ws_e;
  GmmF32Tiles<kColB> tiles{
      static_cast<const float*>(p.x) + g * p.xs_g + m0 * p.xs_c,
      we + n0 * p.ws_n, p.xs_c, p.ws_k, p.ws_n, rows, p.K, p.N - n0,
      p.vec_x, p.vec_w};
  ptt::f32::Acc<G::M> acc = {};
  ptt::f32::mainloop<G::M>(tiles, (p.K + ptt::f32::kBK - 1) / ptt::f32::kBK,
                           reinterpret_cast<float*>(f32_smem), acc);
  float* y = static_cast<float*>(p.y) +
             (static_cast<long long>(g) * p.C + m0) * p.N + n0;
  ptt::f32::store_tile<G::M>(acc, p.N - n0, p.N % 4 == 0, rows,
                             [&](int r) -> float* {
                               return m0 + r < p.C
                                          ? y + static_cast<long long>(r) * p.N
                                          : nullptr;
                             });
}

template <bool kColB>
int launch_f32(const Problem& p, cudaStream_t s) {
  using G = F32Tile<kColB>;
  PTT_SET_SMEM(grouped_gemm_f32_kernel<kColB>, G::SMEM);
  dim3 grid((p.N + G::TN - 1) / G::TN, (p.C + G::M - 1) / G::M, p.G);
  grouped_gemm_f32_kernel<kColB><<<grid, G::THREADS, G::SMEM, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// -- bf16, aligned: wgmma on the pipelined ring ------------------------------

constexpr int kTM = 128, kTN = 256, kTStages = 4, kTThreads = 256;
constexpr uint32_t kTTileA = kTM * ptt::gemm::kBK * 2;  // 16 KB
constexpr uint32_t kTTileB = kTN * ptt::gemm::kBK * 2;  // 32 KB
constexpr uint32_t kTStage = kTTileA + kTTileB;
constexpr int kTSmem = kTStages * kTStage + 1024;

// The ring's policy (gemm_wgmma.cuh). kKMajorB: w's tile has N rows and
// K contiguous (dx's transposed view), else K rows and N contiguous.
template <bool kKMajorB>
struct GmmTiles {
  using T = __nv_bfloat16;
  const T* x;        // row m0 of group g
  const T* w;        // column n0 of expert g / gpe
  long long xs, ws;  // x's row stride; w's stride along its other axis
  int rows, K, ncols, wg;
  bool live;         // the warpgroup has a live row
  uint32_t base;

  __device__ __forceinline__ void fill(int slot, int t) {
    const int k0 = t * ptt::gemm::kBK;
    const uint32_t sA = base + slot * kTStage, sB = sA + kTTileA;
    ptt::gemm::load_k_tile<kTM, kTThreads>(sA, x + k0, xs, rows, K - k0);
    if constexpr (kKMajorB)
      ptt::gemm::load_k_tile<kTN, kTThreads>(sB, w + k0, ws, ncols, K - k0);
    else
      ptt::gemm::load_mn_tile<ptt::gemm::kBK, kTN, kTThreads>(
          sB, w + k0 * ws, ws, K - k0, ncols);
  }

  __device__ __forceinline__ void consume(int slot, int,
                                          float (&acc)[kTN / 2]) {
    using namespace ptt::wg;
    if (!live) return;
    const uint32_t sA = base + slot * kTStage, sB = sA + kTTileA;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      ptt::gemm::mma_ss_n256<kKMajorB ? 0 : 1>(
          acc, desc_k<kTM>(sA + wg * 64 * 128, kk),
          kKMajorB ? desc_k<kTN>(sB, kk) : desc_mn<ptt::gemm::kBK>(sB, kk));
    wg_commit();
    wg_wait_but<1>();
    reg_fence(acc);
  }
};

template <bool kKMajorB>
__global__ void __launch_bounds__(kTThreads, 1)
    grouped_gemm_wgmma_kernel(Problem p) {
  using T = __nv_bfloat16;
  extern __shared__ uint8_t smem[];
  const int g = blockIdx.z, m0 = blockIdx.y * kTM, n0 = blockIdx.x * kTN;
  T* y = static_cast<T*>(p.y) + static_cast<long long>(g) * p.C * p.N + n0;
  int cnt = p.counts[g];
  cnt = cnt < 0 ? 0 : (cnt > p.C ? p.C : cnt);
  if (m0 >= cnt) {  // a dead tile: zeros, 16 bytes a store (N % 8 == 0)
#pragma unroll 4
    for (int j = 0; j < kTM * kTN / 8 / kTThreads; ++j) {
      const int i = threadIdx.x + j * kTThreads;
      const int m = m0 + i / (kTN / 8), c = (i % (kTN / 8)) * 8;
      if (m < p.C && n0 + c < p.N)
        *reinterpret_cast<uint4*>(y + static_cast<long long>(m) * p.N + c) =
            make_uint4(0, 0, 0, 0);
    }
    return;
  }
  const int rows = cnt - m0 < kTM ? cnt - m0 : kTM;
  const int wg = threadIdx.x / 128;
  const uint32_t raw = ptt::wg::smem_u32(smem);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const T* we = static_cast<const T*>(p.w) + (g / p.gpe) * p.ws_e;
  GmmTiles<kKMajorB> tiles{
      static_cast<const T*>(p.x) + g * p.xs_g + m0 * p.xs_c,
      we + n0 * (kKMajorB ? p.ws_n : 1),
      p.xs_c, kKMajorB ? p.ws_n : p.ws_k,
      rows, p.K, p.N - n0, wg, 64 * wg < rows, base};
  float acc[kTN / 2];
#pragma unroll
  for (int i = 0; i < kTN / 2; ++i) acc[i] = 0.f;
  ptt::gemm::mainloop<kTStages, 1>(tiles, (p.K + ptt::gemm::kBK - 1) /
                                           ptt::gemm::kBK, acc);
  __syncthreads();  // every product done: the ring becomes the epilogue's

  const int mw = m0 + 64 * wg;
  uint8_t* stage =
      smem + (base - raw) + wg * ptt::gemm::wg_stage_bytes<T, kTN>();
  ptt::gemm::store_wg_tile<T, kTN>(
      acc, stage, wg, p.N - n0,
      [&](int r, int, float v) { return mw + r < m0 + rows ? v : 0.f; },
      [&](int r) -> T* {
        return mw + r < p.C ? y + static_cast<long long>(mw + r) * p.N
                            : nullptr;
      });
}

enum Route { kRouteF32 = 0, kRouteWmma = 1, kRouteWgmma = 2 };

// the kernel a problem takes; col_b: w's K axis is the contiguous one
int route(const void* x, const void* w, int K, int N, long long xs_g,
          long long xs_c, long long ws_e, long long ws_k, long long ws_n,
          int dtype, bool* col_b) {
  *col_b = ws_n != 1 && ws_k == 1;
  if (dtype != 1) return kRouteF32;
  const bool rows16 = aligned16(x) && aligned16(w) && xs_g % 8 == 0 &&
                      xs_c % 8 == 0 && ws_e % 8 == 0 && K % 8 == 0 &&
                      N % 8 == 0;
  const bool unit = *col_b ? ws_n % 8 == 0 : ws_n == 1 && ws_k % 8 == 0;
  return rows16 && unit ? kRouteWgmma : kRouteWmma;
}

}  // namespace

// The kernel ptt_grouped_gemm launches for these arguments (0: float32
// FMA, 1: bf16 WMMA, 2: bf16 wgmma) and whether w's tile is K-major
// (col_b 1).
extern "C" int ptt_grouped_gemm_route(const void* x, const void* w, int K,
                                      int N, long long xs_g, long long xs_c,
                                      long long ws_e, long long ws_k,
                                      long long ws_n, int dtype,
                                      int* col_b) {
  bool cb = false;
  const int r = route(x, w, K, N, xs_g, xs_c, ws_e, ws_k, ws_n, dtype, &cb);
  *col_b = cb ? 1 : 0;
  return r;
}

// dtype: 0 float32, 1 bfloat16 (ops/kernels/_build.DTYPE_CODES). Returns
// the cudaError_t of the launch.
extern "C" int ptt_grouped_gemm(const void* x, const void* w, void* y,
                                const void* counts, int G, int C, int K,
                                int N, int gpe, long long xs_g,
                                long long xs_c, long long ws_e,
                                long long ws_k, long long ws_n, int dtype,
                                void* stream) {
  if (dtype != 0 && dtype != 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Problem p{x, w, y, static_cast<const int*>(counts), G, C, K, N, gpe,
            xs_g, xs_c, ws_e, ws_k, ws_n, false, false};
  bool col_b = false;
  const int r = route(x, w, K, N, xs_g, xs_c, ws_e, ws_k, ws_n, dtype,
                      &col_b);
  if (r == kRouteWgmma) {
    dim3 grid((N + kTN - 1) / kTN, (C + kTM - 1) / kTM, G);
    auto kern = col_b ? grouped_gemm_wgmma_kernel<true>
                      : grouped_gemm_wgmma_kernel<false>;
    if (col_b)
      PTT_SET_SMEM(grouped_gemm_wgmma_kernel<true>, kTSmem);
    else
      PTT_SET_SMEM(grouped_gemm_wgmma_kernel<false>, kTSmem);
    kern<<<grid, kTThreads, kTSmem, s>>>(p);
    return static_cast<int>(cudaGetLastError());
  }
  const long long v = dtype == 1 ? 8 : 4;  // elements per 16 bytes
  // w's contiguous axis: N (row-major tiles), else K (column-major
  // tiles: the transposed view of dx), else neither (element loads)
  const long long w_other = col_b ? ws_n : ws_k;
  p.vec_x = aligned16(x) && xs_g % v == 0 && xs_c % v == 0;
  p.vec_w = aligned16(w) && ws_e % v == 0 && w_other % v == 0 &&
            (col_b || ws_n == 1);
  if (r == kRouteWmma) {
    dim3 grid((N + kBN - 1) / kBN, (C + kBM - 1) / kBM, G);
    if (col_b)
      grouped_gemm_wmma_kernel<true><<<grid, kThreads, 0, s>>>(p);
    else
      grouped_gemm_wmma_kernel<false><<<grid, kThreads, 0, s>>>(p);
  } else {
    return col_b ? launch_f32<true>(p, s) : launch_f32<false>(p, s);
  }
  return static_cast<int>(cudaGetLastError());
}
