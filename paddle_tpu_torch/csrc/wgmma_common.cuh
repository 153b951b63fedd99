// Hopper primitives shared by the tensor-core engines: the attention
// engine (flash_wgmma.cuh) and the GEMM mainloop (gemm_wgmma.cuh); the
// float32 GEMM mainloop (gemm_f32.cuh) takes its cp.async copies and
// waits.
//
// - cp.async copies of 16 (and 4) bytes into shared memory, zero-filled
//   when the source is out of range, with their commit and waits;
// - wgmma's shared-memory descriptors for the 128-byte-swizzled layout:
//   a [rows][64] bf16 column block keeps row r's 16-byte chunk c at
//   r * 128 + ((c ^ r % 8) << 4), and a wider tile is column blocks of
//   [ROWS][64] laid ROWS * 128 bytes apart. desc_k reads such a tile
//   K-major (rows along M or N, columns along k), desc_mn MN-major (rows
//   along k, columns along M or N);
// - wgmma's fence, commit and wait, and a register fence for the sums.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace ptt {
namespace wg {

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

// the same, with up to N of this thread's newest copy groups still in
// flight
template <int N>
__device__ __forceinline__ void cp_async_wait_visible_but() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
}

// this thread's plain shared-memory stores, visible to wgmma after a
// barrier
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

// a tile of ROWS rows as a K-major operand, k step kk (16 columns):
// 8-row groups 1024 B apart
template <int ROWS>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int kk) {
  return desc(tile + (kk / 4) * (ROWS * 128) + (kk % 4) * 32, 16, 1024);
}

// a tile of ROWS rows (along k) as an MN-major operand, k step kk (16
// rows): 64-column blocks ROWS * 128 B apart (LBO), 8-row groups 1024 B
// apart (SBO)
template <int ROWS>
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int kk) {
  return desc(tile + kk * 16 * 128, ROWS * 128, 1024);
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
// the same, with up to N of the newest groups still running
template <int N>
__device__ __forceinline__ void wg_wait_but() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving accumulator reads across wg_wait
template <int R>
__device__ __forceinline__ void reg_fence(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

}  // namespace wg
}  // namespace ptt

// once per kernel instance: the attribute belongs to the function
#define PTT_SET_SMEM(kern, bytes)                                       \
  do {                                                                  \
    static bool attr_set = false;                                       \
    if (!attr_set) {                                                    \
      cudaError_t err = cudaFuncSetAttribute(                           \
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);    \
      if (err != cudaSuccess) return static_cast<int>(err);             \
      attr_set = true;                                                  \
    }                                                                   \
  } while (0)
