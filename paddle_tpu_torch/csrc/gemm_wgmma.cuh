// The pipelined GEMM mainloop on Hopper's tensor cores, shared by the bf16
// grouped GEMM (grouped_gemm.cu) and the int4 weight-only GEMM
// (weight_only_gemm.cu).
//
// What it does about what bounds a GEMM on the H100: a block streams its
// k tiles through a ring of S slots in shared memory, so while wgmma
// multiplies tile t, the copies of the next S - 1 - F tiles are in flight
// (F below). Copies are cp.async, 16 bytes a thread, into the
// 128-byte-swizzled layout that wgmma reads (wgmma_common.cuh), zero-
// filled past the edges, so tails need no second path. cp.async rather
// than TMA: the callers take any 16-byte-aligned strides (the grouped
// GEMM's transposed view of w, x with a row stride) and zero-fill rows
// past a per-group count, with no tensor map to encode per call.
//
// The mainloop is the ring; what fills a slot and what multiplies it are
// the caller's policy, as flash_wgmma.cuh takes its mask:
//
//   void fill(int slot, int t)                cp.async of k tile t into
//        ring slot `slot` (no commit);
//   void consume(int slot, int t, Acc& acc)   the products over the slot,
//        committed, then wg_wait_but<F>.
//
// F is how many of its wgmma groups a consumer leaves running when it
// returns: 0, or 1 so that the products of tile t run on while the block
// passes the barrier and starts the copies of the next tiles. One barrier
// per k tile: at the top of step t every thread's copies of tile t have
// landed and every warpgroup has finished the products of tile t - 1 - F,
// so that tile's slot takes tile t + S - 1 - F. A consumer that
// writes shared memory itself (the int4 unpack) adds its own barrier.
//
// Operands: A K-major (rows along M, a 64-deep k tile as one 128-byte
// swizzled row each); B K-major, or MN-major through wgmma's transpose
// bit, so no transposed copy is made. Sums are float32 in registers.
// Epilogues are the caller's too; store_wg_tile below stages one
// warpgroup's m64nW tile through shared memory for 16-byte row stores.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma_common.cuh"

namespace ptt {
namespace gemm {

using bf16 = __nv_bfloat16;
using namespace ptt::wg;

constexpr int kBK = 64;  // k depth of a bf16 tile: one 128-byte row

// -- the ring -----------------------------------------------------------------

template <int S, int F, class P, class Acc>
__device__ __forceinline__ void mainloop(P& p, int ntiles, Acc& acc) {
  static_assert(S >= 3 + F, "at least two tiles in flight ahead");
  constexpr int D = S - 1 - F;  // tiles in flight ahead of the consumed one
#pragma unroll
  for (int i = 0; i < D; ++i) {
    if (i < ntiles) p.fill(i, i);
    cp_async_commit();
  }
  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait_visible_but<D - 1>();  // tile t landed; a slot is free
    const int nx = t + D;
    if (nx < ntiles) p.fill(nx % S, nx);
    cp_async_commit();
    p.consume(t % S, t, acc);
  }
  wg_wait();
  reg_fence(acc);
}

// -- swizzled tile copies -----------------------------------------------------

// Loops over a tile's 16-byte chunks run a fixed count per thread (NT
// threads, the block's size), so they unroll and the address arithmetic
// of every chunk but the first folds into constants.

// A K-major tile of R rows and 64 columns at dst (1024-byte aligned):
// element (r, c) is src[r * stride + c], zero where r >= rows or c >= cols
// (cols a multiple of 8: whole 16-byte chunks).
template <int R, int NT>
__device__ __forceinline__ void load_k_tile(uint32_t dst,
                                            const bf16* __restrict__ src,
                                            long long stride, int rows,
                                            int cols) {
  static_assert(R * 8 % NT == 0, "whole rounds of chunks");
#pragma unroll
  for (int i = 0; i < R * 8 / NT; ++i) {
    const int v = threadIdx.x + i * NT;
    const int r = v / 8, c = v % 8;
    const bool ok = r < rows && c * 8 < cols;
    cp_async16(dst + r * 128 + ((c ^ (r % 8)) << 4),
               ok ? src + r * stride + c * 8 : src, ok);
  }
}

// An MN-major tile of R rows (along k) and W columns (W / 64 column blocks
// of [R][64], R * 128 bytes apart), the same masks.
template <int R, int W, int NT>
__device__ __forceinline__ void load_mn_tile(uint32_t dst,
                                             const bf16* __restrict__ src,
                                             long long stride, int rows,
                                             int cols) {
  constexpr int CPR = W / 8;
  static_assert(R * CPR % NT == 0, "whole rounds of chunks");
#pragma unroll
  for (int i = 0; i < R * CPR / NT; ++i) {
    const int v = threadIdx.x + i * NT;
    const int r = v / CPR, c = v % CPR;
    const bool ok = r < rows && c * 8 < cols;
    cp_async16(dst + (c / 8) * (R * 128) + r * 128 +
                   (((c % 8) ^ (r % 8)) << 4),
               ok ? src + r * stride + c * 8 : src, ok);
  }
}

// -- wgmma --------------------------------------------------------------------
//
// Every product accumulates (scale-d 1): callers zero their sums first.

// d += A.B: m64n256k16, A and B in shared memory, A K-major; TB is B's
// transpose bit (0: K-major, 1: MN-major)
template <int TB>
__device__ __forceinline__ void mma_ss_n256(float (&d)[128], uint64_t a,
                                            uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, "
      "%128, %129, p, 1, 1, 0, %131;\n}\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(1), "n"(TB));
}

// d += A.B: m64nNk16, A in registers (four bf16x2 per thread: rows
// 16 w + lane / 4 (+ 8), k pairs 2 (lane % 4) (+ 8)), B in shared memory
// K-major
template <int N>
__device__ __forceinline__ void mma_rs_k(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t b);

template <>
__device__ __forceinline__ void mma_rs_k<8>(float (&d)[4],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3"
      "}, "
      "{%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void mma_rs_k<16>(float (&d)[8],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void mma_rs_k<32>(float (&d)[16],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void mma_rs_k<64>(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
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

// -- epilogue -----------------------------------------------------------------
//
// Element i of a thread's m64nN sums: row 16 w + lane / 4 + 8 h (warp w of
// the warpgroup, h = (i >> 1) & 1), column 8 (i >> 2) + 2 (lane % 4) +
// (i & 1). f(row, col, v0, v1) sees each pair of neighbouring columns.
template <int N, class F>
__device__ __forceinline__ void for_each_pair(const float (&d)[N / 2], F f) {
  const int lane = threadIdx.x % 32, warp = (threadIdx.x / 32) % 4;
#pragma unroll
  for (int i = 0; i < N / 2; i += 2)
    f(16 * warp + lane / 4 + 8 * ((i >> 1) & 1),
      8 * (i >> 2) + 2 * (lane % 4), d[i], d[i + 1]);
}

__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// barrier of one warpgroup (ids 1.. : 0 is __syncthreads)
__device__ __forceinline__ void wg_barrier(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(wg + 1) : "memory");
}

template <typename TO, int W>
__host__ __device__ constexpr int wg_stage_bytes() {
  return 64 * (W * static_cast<int>(sizeof(TO)) + 16);
}

// One warpgroup's m64nW sums to device memory: val(row, col, v) gives
// the output value of each sum, row_ptr(row) the row's first output (null:
// the row is not stored); columns at or past ncols are not stored (ncols
// and each row 16-byte aligned). The tile goes through `stage`
// (wg_stage_bytes<TO, W>() of shared memory, padded rows: no bank
// conflicts) so every thread stores whole 16-byte chunks of a row.
template <typename TO, int W, class Val, class RowPtr>
__device__ __forceinline__ void store_wg_tile(const float (&acc)[W / 2],
                                              uint8_t* stage, int wg,
                                              int ncols, Val val,
                                              RowPtr row_ptr) {
  constexpr int P = W * sizeof(TO) + 16;  // row pitch in bytes
  for_each_pair<W>(acc, [&](int r, int c, float v0, float v1) {
    store_pair(reinterpret_cast<TO*>(stage + r * P) + c, val(r, c, v0),
               val(r, c + 1, v1));
  });
  wg_barrier(wg);
  constexpr int V = 16 / sizeof(TO), CPR = W / V;
  const int tid = threadIdx.x % 128;
#pragma unroll 4
  for (int i = 0; i < 64 * CPR / 128; ++i) {
    const int v = tid + i * 128;
    const int r = v / CPR, c = (v % CPR) * V;
    TO* out = row_ptr(r);
    if (out != nullptr && c < ncols)
      *reinterpret_cast<uint4*>(out + c) =
          *reinterpret_cast<const uint4*>(stage + r * P + c * sizeof(TO));
  }
}

}  // namespace gemm
}  // namespace ptt
