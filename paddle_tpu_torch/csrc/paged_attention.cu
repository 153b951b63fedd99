// Gang-decode paged attention on Hopper: one query token per batch row
// over the paged KV pool.
//
// Replaces paddle_tpu/ops/kernels/pallas/paged_attention.py
// (`paged_attention`, kernel `_kernel`). Block (b, h) attends row b's G
// query heads of kv head h against the blocks below context_lens[b],
// through the shared tile code (paged_attention_common.cuh) as a tile of
// one token at position context_lens[b] - 1. A row with context_len 0
// writes zeros. The pool is in q's dtype, or int8 with float32 scale pools
// [NB, BS, KV], dequantized at the tile load as in the ragged kernel (the
// reference leaves an int8 gang decode to an XLA composite on its TPU; the
// port runs it here, so a CUDA tensor never takes the plain version).

#include "paged_attention_common.cuh"

using namespace ptt;

template <typename QT, typename KT, int D>
__global__ void __launch_bounds__(kThreads) paged_attention_kernel(
    const QT* __restrict__ q, const KT* __restrict__ k_pool,
    const KT* __restrict__ v_pool, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ block_tables,
    const int* __restrict__ context_lens, QT* __restrict__ out, int H, int KV,
    int NB, int BS, int MB, float scale) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int ctx = context_lens[b];
  const int kv_end = max(0, min(ctx, MB * BS));
  attend_tile<QT, KT, D>(q, k_pool, v_pool, k_scale, v_scale,
                         block_tables + static_cast<size_t>(b) * MB, out, H,
                         KV, H / KV, NB, BS, kvh, b, 1, ctx - 1, kv_end, scale,
                         smem);
}

template <typename QT, typename KT, int D>
static int launch(const void* q, const void* k_pool, const void* v_pool,
                  const void* k_scale, const void* v_scale,
                  const void* block_tables, const void* context_lens,
                  void* out, int B, int H, int KV, int NB, int BS, int MB,
                  float scale, cudaStream_t stream) {
  auto kern = paged_attention_kernel<QT, KT, D>;
  const int smem = smem_floats<D>() * static_cast<int>(sizeof(float));
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  kern<<<dim3(B, KV), kThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(k_pool),
      static_cast<const KT*>(v_pool), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale),
      static_cast<const int*>(block_tables),
      static_cast<const int*>(context_lens), static_cast<QT*>(out), H, KV, NB,
      BS, MB, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
static int dispatch(int q_dtype, int kv_dtype, const void* q,
                    const void* k_pool, const void* v_pool,
                    const void* k_scale, const void* v_scale,
                    const void* block_tables, const void* context_lens,
                    void* out, int B, int H, int KV, int NB, int BS, int MB,
                    float scale, cudaStream_t stream) {
#define PTT_LAUNCH(QT, KT)                                                   \
  return launch<QT, KT, D>(q, k_pool, v_pool, k_scale, v_scale,             \
                           block_tables, context_lens, out, B, H, KV, NB, BS, \
                           MB, scale, stream)
  // dtype codes: 0 float32, 1 bfloat16, 2 int8 (pools only)
  if (q_dtype == 0 && kv_dtype == 0) PTT_LAUNCH(float, float);
  if (q_dtype == 0 && kv_dtype == 2) PTT_LAUNCH(float, int8_t);
  if (q_dtype == 1 && kv_dtype == 1) PTT_LAUNCH(__nv_bfloat16, __nv_bfloat16);
  if (q_dtype == 1 && kv_dtype == 2) PTT_LAUNCH(__nv_bfloat16, int8_t);
#undef PTT_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int ptt_paged_attention(const void* q, const void* k_pool,
                                   const void* v_pool, const void* k_scale,
                                   const void* v_scale,
                                   const void* block_tables,
                                   const void* context_lens, void* out, int B,
                                   int H, int KV, int D, int NB, int BS,
                                   int MB, float scale, int q_dtype,
                                   int kv_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 128)
    return dispatch<128>(q_dtype, kv_dtype, q, k_pool, v_pool, k_scale,
                         v_scale, block_tables, context_lens, out, B, H, KV,
                         NB, BS, MB, scale, s);
  if (D == 64)
    return dispatch<64>(q_dtype, kv_dtype, q, k_pool, v_pool, k_scale,
                        v_scale, block_tables, context_lens, out, B, H, KV,
                        NB, BS, MB, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
