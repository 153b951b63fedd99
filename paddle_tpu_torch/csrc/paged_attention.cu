// Gang-decode paged attention on Hopper: one query token per batch row
// over the paged KV pool.
//
// Replaces paddle_tpu/ops/kernels/pallas/paged_attention.py
// (`paged_attention`, kernel `_kernel`). Block (b, h) attends row b's G
// query heads of kv head h against the blocks below context_lens[b],
// through the shared tile code (paged_attention_common.cuh) as a tile of
// one token at position context_lens[b] - 1. A row with context_len 0
// writes zeros. No int8 path, as in the reference: a quantized pool takes
// the plain dequant composite (ops/kernels/serving.py).

#include "paged_attention_common.cuh"

using namespace ptt;

template <typename QT, int D>
__global__ void __launch_bounds__(kThreads) paged_attention_kernel(
    const QT* __restrict__ q, const QT* __restrict__ k_pool,
    const QT* __restrict__ v_pool, const int* __restrict__ block_tables,
    const int* __restrict__ context_lens, QT* __restrict__ out, int H, int KV,
    int NB, int BS, int MB, float scale) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int ctx = context_lens[b];
  const int kv_end = max(0, min(ctx, MB * BS));
  attend_tile<QT, QT, D>(q, k_pool, v_pool, nullptr, nullptr,
                         block_tables + static_cast<size_t>(b) * MB, out, H,
                         KV, H / KV, NB, BS, kvh, b, 1, ctx - 1, kv_end, scale,
                         smem);
}

template <typename QT, int D>
static int launch(const void* q, const void* k_pool, const void* v_pool,
                  const void* block_tables, const void* context_lens,
                  void* out, int B, int H, int KV, int NB, int BS, int MB,
                  float scale, cudaStream_t stream) {
  auto kern = paged_attention_kernel<QT, D>;
  const int smem = smem_floats<D>() * static_cast<int>(sizeof(float));
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  kern<<<dim3(B, KV), kThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const QT*>(k_pool),
      static_cast<const QT*>(v_pool), static_cast<const int*>(block_tables),
      static_cast<const int*>(context_lens), static_cast<QT*>(out), H, KV, NB,
      BS, MB, scale);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ptt_paged_attention(const void* q, const void* k_pool,
                                   const void* v_pool,
                                   const void* block_tables,
                                   const void* context_lens, void* out, int B,
                                   int H, int KV, int D, int NB, int BS,
                                   int MB, float scale, int dtype,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // dtype codes: 0 float32, 1 bfloat16
#define PTT_LAUNCH(QT, DD)                                                    \
  return launch<QT, DD>(q, k_pool, v_pool, block_tables, context_lens, out, \
                        B, H, KV, NB, BS, MB, scale, s)
  if (dtype == 0 && D == 128) PTT_LAUNCH(float, 128);
  if (dtype == 0 && D == 64) PTT_LAUNCH(float, 64);
  if (dtype == 1 && D == 128) PTT_LAUNCH(__nv_bfloat16, 128);
  if (dtype == 1 && D == 64) PTT_LAUNCH(__nv_bfloat16, 64);
#undef PTT_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}
