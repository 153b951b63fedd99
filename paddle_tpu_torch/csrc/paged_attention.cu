// Gang-decode paged attention on Hopper: one query token per batch row
// over the paged KV pool, as a split-KV pass and a merge.
//
// Replaces paddle_tpu/ops/kernels/pallas/paged_attention.py
// (`paged_attention`, kernel `_kernel`). Row b's query heads attend the
// pool positions below context_lens[b] (at most MB * BS), looked up
// through the row's block table (entries clamped to [0, NB)). A row with
// context_len 0 writes zeros. The pool is in q's dtype, or int8 with
// float32 scale pools [NB, BS, KV] (the reference leaves an int8 gang
// decode to an XLA composite on its TPU; the port runs it here, so a CUDA
// tensor never takes the plain version).
//
// What bounds it on the H100: the pool bytes. Each position costs ~4 KB
// of K and V across the kv heads (bf16, head_dim 128) for ~16 FLOP a
// byte-pair: about 4 FLOP a byte, far below the card's ~295 bf16 ops a
// byte. So the design is about memory parallelism: many blocks, each
// streaming a slice of one row's context with every warp busy. The first
// design gave each (row, kv head) one block that walked the whole context
// alone with one warp of eight live; here it is a split-KV pass, a block
// per (kv head x head group, row, split), and a merge in split order
// (paged_split.cuh, shared with the ragged kernel's decode rows). The
// wrapper's split plan picks the split length from MB, BS, B, KV and the
// SM count, never from context_lens, so no host sync.

#include "paged_split.cuh"

// Launches the split pass and the merge. part: float32 scratch of B * H *
// S * (D + 4) words; sp: positions per split (a multiple of BS and of 64,
// at most 512 * BS), s: splits, s * sp >= MB * BS, gt: query heads a
// split block serves (4 or 8) -- the wrapper's split plan, which counts
// its blocks with the same gt. Returns the cudaError_t of the launches.
extern "C" int ptt_paged_attention(const void* q, const void* k_pool,
                                   const void* v_pool, const void* k_scale,
                                   const void* v_scale,
                                   const void* block_tables,
                                   const void* context_lens, void* part,
                                   void* out, int B, int H, int KV, int D,
                                   int NB, int BS, int MB, int sp, int s,
                                   int gt, float scale, int q_dtype,
                                   int kv_dtype, void* stream) {
  using namespace ptt::dec;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || KV <= 0 || H % KV || NB <= 0 || BS <= 0 || MB < 0 ||
      !plan_ok(BS, MB, sp, s))
    return static_cast<int>(cudaErrorInvalidValue);
  const Decode a{q, k_pool, v_pool, static_cast<const float*>(k_scale),
                 static_cast<const float*>(v_scale),
                 static_cast<const int*>(block_tables),
                 static_cast<const int*>(context_lens),
                 static_cast<float*>(part), out, H, KV, H / KV, NB, BS, MB,
                 sp, s, scale * kLog2e, nullptr};
  if (D != 128 && D != 64) return static_cast<int>(cudaErrorInvalidValue);
  const int rc =
      D == 128 ? dispatch_split<128, GangRows>(q_dtype, kv_dtype, gt, a, B, st)
               : dispatch_split<64, GangRows>(q_dtype, kv_dtype, gt, a, B, st);
  if (rc) return rc;
  const dim3 grid((H + kDecWarps - 1) / kDecWarps, B);
  if (q_dtype == 0 && D == 128)
    paged_attention_merge_kernel<float, 128, GangRows>
        <<<grid, kDecThreads, 0, st>>>(a);
  else if (q_dtype == 0)
    paged_attention_merge_kernel<float, 64, GangRows>
        <<<grid, kDecThreads, 0, st>>>(a);
  else if (D == 128)
    paged_attention_merge_kernel<__nv_bfloat16, 128, GangRows>
        <<<grid, kDecThreads, 0, st>>>(a);
  else
    paged_attention_merge_kernel<__nv_bfloat16, 64, GangRows>
        <<<grid, kDecThreads, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}
