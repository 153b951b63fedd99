// Shared device code of the GEMM-shaped kernels (grouped_gemm.cu,
// bcsr_spmm.cu): float32 -> element conversion and a masked tile load
// from device memory into shared memory.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ptt_gemm {

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// A [R][W] tile into shared memory with row pitch P: element (r, c) is
// src[r * s_r + c * s_c], read while r < r_lim and c < c_lim, else zero.
// vec: s_c == 1 and every row 16-byte aligned, so whole 16-byte chunks
// load at once; a chunk that crosses c_lim, or any chunk without vec, is
// read element by element.
template <typename T, int R, int W, int P, int NT>
__device__ __forceinline__ void load_tile(const T* __restrict__ src,
                                          long long s_r, long long s_c,
                                          int r_lim, int c_lim, bool vec,
                                          T* __restrict__ dst) {
  constexpr int V = 16 / sizeof(T);
  constexpr int CH = W / V;
  for (int q = threadIdx.x; q < R * CH; q += NT) {
    const int r = q / CH;
    const int c0 = (q % CH) * V;
    T* d = dst + r * P + c0;
    const T* s = src + static_cast<long long>(r) * s_r;
    if (r < r_lim && vec && c0 + V <= c_lim) {
      *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(s + c0);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e)
        d[e] = (r < r_lim && c0 + e < c_lim)
                   ? s[static_cast<long long>(c0 + e) * s_c]
                   : from_f32<T>(0.f);
    }
  }
}

inline bool aligned16(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

}  // namespace ptt_gemm
