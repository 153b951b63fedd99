// Ragged paged attention on Hopper: one launch for a ragged mix of prefill
// chunks and decode rows over the paged KV pool.
//
// Replaces paddle_tpu/ops/kernels/pallas/ragged_paged_attention.py
// (`ragged_paged_attention`, kernel `_kernel`). Semantics kept:
//   - row r owns packed tokens cu[r]..cu[r+1]; its token i sits at
//     position ctx[r] - qlen[r] + i (ctx counts tokens after this step's
//     write: attention comes after the write) and sees positions <= its own;
//   - block-table entries are clamped to [0, NB-1];
//   - tokens past cu[R] (step padding) come back as exact zeros;
//   - a row that sees nothing divides by 1, not by 0;
//   - int8 pools are dequantized (k * k_scale) at the tile load;
//   - the output has q's dtype.
//
// Grid (NT, KV) with NT = R + ceil(T / TQ): a static bound on the tile
// count, so one geometry serves every prefill/decode mix of a token
// budget. Block (t, h) finds its tile's row by walking cu_q_lens itself;
// blocks past the last row's tiles zero the padding tokens. TQ = 64 / G
// tokens per tile, so a tile fills the 64 q rows of the shared tile code
// (paged_attention_common.cuh).

#include "paged_attention_common.cuh"

using namespace ptt;

template <typename QT, typename KT, int D>
__global__ void __launch_bounds__(kThreads) ragged_paged_attention_kernel(
    const QT* __restrict__ q, const KT* __restrict__ k_pool,
    const KT* __restrict__ v_pool, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ block_tables,
    const int* __restrict__ context_lens, const int* __restrict__ cu,
    QT* __restrict__ out, int T, int H, int KV, int NB, int BS, int R, int MB,
    int TQ, float scale) {
  extern __shared__ float smem[];
  __shared__ int meta[2];  // owning row (-1: padding tile), tile index
  const int t = blockIdx.x;
  const int kvh = blockIdx.y;
  const int G = H / KV;
  if (threadIdx.x == 0) {
    int seen = 0, row = -1, local = 0;
    for (int r = 0; r < R; ++r) {
      const int ql = max(cu[r + 1] - cu[r], 0);
      const int nt = (ql + TQ - 1) / TQ;
      if (t < seen + nt) {
        row = r;
        local = t - seen;
        break;
      }
      seen += nt;
    }
    meta[0] = row;
    meta[1] = row >= 0 ? local : t - seen;
  }
  __syncthreads();
  const int row = meta[0];
  const int local = meta[1];
  if (row < 0) {
    // padding tile `local` zeroes tokens [cu[R] + local*TQ, +TQ) of this
    // kv head's query heads; NT covers every token up to T
    const int first = cu[R] + local * TQ;
    const int last = min(first + TQ, T);
    if (first < 0) return;
    const int n = (last - first) * G * D;
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const int tok = first + i / (G * D);
      const int g = (i / D) % G;
      out[(static_cast<size_t>(tok) * H + kvh * G + g) * D + i % D] =
          from_f32<QT>(0.f);
    }
    return;
  }
  const int ql = cu[row + 1] - cu[row];
  const int tok0 = cu[row] + local * TQ;
  const int qc = min(min(TQ, ql - local * TQ), T - tok0);
  const int qp0 = context_lens[row] - ql + local * TQ;
  // causal horizon of the tile's last token; never past the table
  const int kv_end = max(0, min(qp0 + qc, MB * BS));
  attend_tile<QT, KT, D>(q, k_pool, v_pool, k_scale, v_scale,
                         block_tables + static_cast<size_t>(row) * MB, out, H,
                         KV, G, NB, BS, kvh, tok0, qc, qp0, kv_end, scale,
                         smem);
}

template <typename QT, typename KT, int D>
static int launch(const void* q, const void* k_pool, const void* v_pool,
                  const void* k_scale, const void* v_scale,
                  const void* block_tables, const void* context_lens,
                  const void* cu_q_lens, void* out, int T, int H, int KV,
                  int NB, int BS, int R, int MB, int NT, int TQ, float scale,
                  cudaStream_t stream) {
  auto kern = ragged_paged_attention_kernel<QT, KT, D>;
  const int smem = smem_floats<D>() * static_cast<int>(sizeof(float));
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  kern<<<dim3(NT, KV), kThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(k_pool),
      static_cast<const KT*>(v_pool), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale),
      static_cast<const int*>(block_tables),
      static_cast<const int*>(context_lens),
      static_cast<const int*>(cu_q_lens), static_cast<QT*>(out), T, H, KV, NB,
      BS, R, MB, TQ, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
static int dispatch(int q_dtype, int kv_dtype, const void* q,
                    const void* k_pool, const void* v_pool,
                    const void* k_scale, const void* v_scale,
                    const void* block_tables, const void* context_lens,
                    const void* cu_q_lens, void* out, int T, int H, int KV,
                    int NB, int BS, int R, int MB, int NT, int TQ, float scale,
                    cudaStream_t stream) {
#define PTT_LAUNCH(QT, KT)                                                   \
  return launch<QT, KT, D>(q, k_pool, v_pool, k_scale, v_scale,             \
                           block_tables, context_lens, cu_q_lens, out, T, H, \
                           KV, NB, BS, R, MB, NT, TQ, scale, stream)
  // dtype codes: 0 float32, 1 bfloat16, 2 int8 (pools only)
  if (q_dtype == 0 && kv_dtype == 0) PTT_LAUNCH(float, float);
  if (q_dtype == 0 && kv_dtype == 2) PTT_LAUNCH(float, int8_t);
  if (q_dtype == 1 && kv_dtype == 1) PTT_LAUNCH(__nv_bfloat16, __nv_bfloat16);
  if (q_dtype == 1 && kv_dtype == 2) PTT_LAUNCH(__nv_bfloat16, int8_t);
#undef PTT_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int ptt_ragged_paged_attention(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* block_tables,
    const void* context_lens, const void* cu_q_lens, void* out, int T, int H,
    int KV, int D, int NB, int BS, int R, int MB, int NT, int TQ, float scale,
    int q_dtype, int kv_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 128)
    return dispatch<128>(q_dtype, kv_dtype, q, k_pool, v_pool, k_scale,
                         v_scale, block_tables, context_lens, cu_q_lens, out,
                         T, H, KV, NB, BS, R, MB, NT, TQ, scale, s);
  if (D == 64)
    return dispatch<64>(q_dtype, kv_dtype, q, k_pool, v_pool, k_scale,
                        v_scale, block_tables, context_lens, cu_q_lens, out,
                        T, H, KV, NB, BS, R, MB, NT, TQ, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
