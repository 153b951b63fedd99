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
// alone with one warp of eight live; here:
//
// - paged_attention_split_kernel, grid (kv head x head group, row,
//   split): a block takes the positions [split * SP, (split + 1) * SP) of
//   one row (SP a multiple of the pool block and of the 64-position
//   chunk; the wrapper's split plan picks SP from MB, BS, B, KV and the SM
//   count, never from context_lens, so no host sync) for up to GT query
//   heads of one kv head. Its chunks of 64 positions arrive through a
//   cp.async ring of NS stages in the pool's own dtype (int8 with its
//   scales), are widened to float32 in registers, and each of the 4 warps
//   takes 16 positions of a chunk: for Q.K two lanes share a position
//   (half of head_dim each; K's rows swizzled so those reads are free of
//   bank conflicts), for P.V each lane owns head_dim / 32 output columns.
//   Each warp keeps its own online-softmax state (m, l, acc) per head; the
//   block combines them in shared memory in warp order and writes one
//   float32 partial (m, l, acc[D]) per (row, head, split). A split past
//   context_lens[b] writes l = 0 and exits.
// - paged_attention_merge_kernel, grid (head quads, row): merges a row's
//   partials in split order (the log-sum-exp rescale) and rounds once to
//   q's dtype; a row with no live split writes zeros.
//
// No atomics anywhere: two launches give the same bytes. Arithmetic is
// float32 on the CUDA cores (exp2 with log2(e) folded into the scale):
// at ~4 FLOP a byte the ALUs are not what sets the pace, so no mma.

#include <type_traits>

#include "paged_attention_common.cuh"
#include "wgmma_common.cuh"

namespace {

using ptt::kNeg;
using ptt::unpack16;
using ptt::wg::cp_async16;
using ptt::wg::cp_async4;
using ptt::wg::cp_async_commit;

constexpr int kDecWarps = 4;
constexpr int kDecThreads = kDecWarps * 32;
constexpr int kDecChunk = 64;                    // positions per stage
constexpr int kDecPerWarp = kDecChunk / kDecWarps;  // 16
constexpr int kTableCap = 512;                   // block-table ids a split
constexpr float kLog2e = 1.4426950408889634f;

struct Decode {
  const void* q;
  const void* k_pool;
  const void* v_pool;
  const float* k_scale;
  const float* v_scale;
  const int* block_tables;
  const int* context_lens;
  float* part;  // [B * H][S][D + 4]: m, l, two pad words, acc[D]
  void* out;
  int H, KV, G, NB, BS, MB, SP, S;
  float scale2;  // scale * log2(e)
};

template <typename KT>
__host__ __device__ constexpr int stages() {
  return sizeof(KT) == 4 ? 2 : 3;
}

// shared memory of the split kernel: the ring (K rows, V rows, and for
// int8 their scales), q [GT][D] in float32, the warps' P [4][GT][16], the
// split's block-table ids
template <typename KT, int D>
__host__ __device__ constexpr int stage_bytes() {
  return 2 * kDecChunk * D * static_cast<int>(sizeof(KT)) +
         (std::is_same<KT, int8_t>::value ? 2 * kDecChunk * 4 : 0);
}
template <typename KT, int D, int GT>
__host__ __device__ constexpr int split_smem_bytes() {
  return stages<KT>() * stage_bytes<KT, D>() + GT * D * 4 +
         kDecWarps * GT * kDecPerWarp * 4 + kTableCap * 4;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// N elements of one pool row at p (N * sizeof(KT) = 2, 4, 8 or 16 bytes,
// as aligned), widened to float32
template <typename KT, int N>
__device__ __forceinline__ void load_f32(const uint8_t* p, float (&out)[N]) {
  constexpr int BYTES = N * static_cast<int>(sizeof(KT));
  static_assert(BYTES == 2 || BYTES == 4 || BYTES == 8 || BYTES == 16,
                "a whole aligned word group");
  uint32_t w[BYTES >= 4 ? BYTES / 4 : 1];
  if constexpr (BYTES == 16) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    w[0] = u.x, w[1] = u.y, w[2] = u.z, w[3] = u.w;
  } else if constexpr (BYTES == 8) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    w[0] = u.x, w[1] = u.y;
  } else if constexpr (BYTES == 4) {
    w[0] = *reinterpret_cast<const uint32_t*>(p);
  } else {
    w[0] = *reinterpret_cast<const uint16_t*>(p);
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if constexpr (std::is_same<KT, float>::value) {
      out[i] = __uint_as_float(w[i]);
    } else if constexpr (std::is_same<KT, __nv_bfloat16>::value) {
      const uint32_t x = w[i / 2];  // little-endian: element 2j is low
      out[i] = __uint_as_float(i % 2 ? x & 0xffff0000u : x << 16);
    } else {
      out[i] = static_cast<float>(
          static_cast<int8_t>((w[i / 4] >> (8 * (i % 4))) & 0xffu));
    }
  }
}

// this thread's copies but the newest N groups have landed; after the
// barrier, every thread's are visible
template <int N>
__device__ __forceinline__ void cp_async_wait_sync() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
  __syncthreads();
}

// K rows are stored swizzled: chunk c of the row of chunk position pc at
// c ^ swz(pc), so the 8 lanes of a quarter-warp (4 positions x 2 halves)
// read 8 different bank groups in Q.K
template <int CPR>
__device__ __forceinline__ int k_swizzle(int pc) {
  return ((pc & 3) << 1) & (CPR - 1);
}

template <typename QT, typename KT, int D, int GT>
__global__ void __launch_bounds__(kDecThreads)
    paged_attention_split_kernel(Decode a) {
  constexpr int ITEM = static_cast<int>(sizeof(KT));
  constexpr int ROW = D * ITEM;        // bytes of one position's row
  constexpr int CPR = ROW / 16;        // its 16-byte chunks (even)
  constexpr int VEC = 16 / ITEM;       // elements of a chunk
  constexpr int EPL = D / 32;          // P.V output columns of a lane
  constexpr int NS = stages<KT>();
  constexpr int STAGE = stage_bytes<KT, D>();
  constexpr int KBYTES = kDecChunk * ROW;
  constexpr bool kQuant = std::is_same<KT, int8_t>::value;
  static_assert(CPR % 2 == 0 && kDecChunk * CPR % kDecThreads == 0,
                "whole rounds of chunks");
  extern __shared__ __align__(16) uint8_t smem[];
  float* qs = reinterpret_cast<float*>(smem + NS * STAGE);  // [GT][D]
  float* ps = qs + GT * D;                      // [warp][GT][16]
  int* tbl = reinterpret_cast<int*>(ps + kDecWarps * GT * kDecPerWarp);

  const int G = a.G, HG = (G + GT - 1) / GT;
  const int kvh = blockIdx.x / HG, g0 = (blockIdx.x % HG) * GT;
  const int gn = min(GT, G - g0);
  const int b = blockIdx.y, split = blockIdx.z;
  const int kv_end = max(0, min(a.context_lens[b], a.MB * a.BS));
  const int s0 = split * a.SP, s1 = min(s0 + a.SP, kv_end);
  // head g0 + g's record of this split; head g + 1's is S records on
  float* rec = a.part + ((static_cast<long long>(b) * a.H + kvh * G + g0) *
                             a.S + split) * (D + 4);
  const long long rec_step = static_cast<long long>(a.S) * (D + 4);
  if (s0 >= s1) {  // a split past the context: l = 0
    if (threadIdx.x < gn) {
      rec[threadIdx.x * rec_step] = kNeg;
      rec[threadIdx.x * rec_step + 1] = 0.f;
    }
    return;
  }

  // the split's block-table ids (s0 is a multiple of BS) and its q heads
  const int nblk = (s1 - s0 + a.BS - 1) / a.BS;
  const int* trow = a.block_tables + static_cast<long long>(b) * a.MB +
                    s0 / a.BS;
  for (int i = threadIdx.x; i < nblk; i += kDecThreads) {
    const int id = trow[i];
    tbl[i] = id < 0 ? 0 : (id >= a.NB ? a.NB - 1 : id);
  }
  const QT* qrow = static_cast<const QT*>(a.q) +
                   (static_cast<long long>(b) * a.H + kvh * G + g0) * D;
  for (int i = threadIdx.x; i < GT * D; i += kDecThreads)
    qs[i] = i / D < gn ? to_f32(qrow[i]) : 0.f;
  __syncthreads();

  const uint8_t* kp = static_cast<const uint8_t*>(a.k_pool);
  const uint8_t* vp = static_cast<const uint8_t*>(a.v_pool);
  const uint32_t ring = ptt::wg::smem_u32(smem);
  // chunk c (positions s0 + 64 c ..) into ring slot `slot`; positions at
  // or past s1 are zero-filled, never read
  auto fill = [&](int slot, int c) {
    const int c0 = s0 + c * kDecChunk;
    const uint32_t st = ring + slot * STAGE;
#pragma unroll
    for (int i = 0; i < 2 * kDecChunk * CPR / kDecThreads; ++i) {
      const int v = threadIdx.x + i * kDecThreads;
      const bool is_v = v >= kDecChunk * CPR;  // a constant per i
      const int w = is_v ? v - kDecChunk * CPR : v;
      const int pc = w / CPR, ch = w % CPR;
      const int pos = c0 + pc;
      const bool ok = pos < s1;
      const int rel = ok ? pos - s0 : 0;
      const long long slot_pos =
          static_cast<long long>(tbl[rel / a.BS]) * a.BS + rel % a.BS;
      const uint8_t* src = (is_v ? vp : kp) +
                           (slot_pos * a.KV + kvh) * ROW + ch * 16;
      const uint32_t dst =
          is_v ? st + KBYTES + pc * ROW + ch * 16
               : st + pc * ROW + ((ch ^ k_swizzle<CPR>(pc)) << 4);
      cp_async16(dst, ok ? src : kp, ok);
    }
    if constexpr (kQuant) {  // one scale a thread: K's 64, then V's 64
      const int pc = threadIdx.x % kDecChunk;
      const bool is_v = threadIdx.x >= kDecChunk;
      const int pos = c0 + pc;
      const bool ok = pos < s1;
      const int rel = ok ? pos - s0 : 0;
      const long long slot_pos =
          static_cast<long long>(tbl[rel / a.BS]) * a.BS + rel % a.BS;
      const float* sc = is_v ? a.v_scale : a.k_scale;
      cp_async4(st + 2 * KBYTES + threadIdx.x * 4,
                ok ? sc + slot_pos * a.KV + kvh : sc, ok);
    }
  };

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int half = lane & 1;                        // Q.K: half of D
  const int pw = warp * kDecPerWarp + (lane >> 1);  // Q.K: chunk position
  float m[GT], l[GT], acc[GT][EPL];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    m[g] = kNeg;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[g][e] = 0.f;
  }

  const int nch = (s1 - s0 + kDecChunk - 1) / kDecChunk;
#pragma unroll
  for (int i = 0; i < NS - 1; ++i) {
    if (i < nch) fill(i, i);
    cp_async_commit();
  }
  for (int c = 0; c < nch; ++c) {
    cp_async_wait_sync<NS - 2>();  // chunk c landed; slot (c - 1) free
    if (c + NS - 1 < nch) fill((c + NS - 1) % NS, c + NS - 1);
    cp_async_commit();
    const uint8_t* st = smem + (c % NS) * STAGE;
    const int pos = s0 + c * kDecChunk + pw;
    const bool live = pos < s1;

    // Q.K: this lane's half of the row (chunks 2j + half), then the pair
    float s[GT];
#pragma unroll
    for (int g = 0; g < GT; ++g) s[g] = 0.f;
    const uint8_t* krow = st + pw * ROW;
#pragma unroll
    for (int j = 0; j < CPR / 2; ++j) {
      const int ch = 2 * j + half;
      float kf[VEC];
      unpack16(*reinterpret_cast<const uint4*>(
                   krow + ((ch ^ k_swizzle<CPR>(pw)) << 4)),
               kf, KT());
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        const float* qg = qs + g * D + ch * VEC;
#pragma unroll
        for (int e = 0; e < VEC; e += 4) {
          const float4 qv = *reinterpret_cast<const float4*>(qg + e);
          s[g] += qv.x * kf[e] + qv.y * kf[e + 1] + qv.z * kf[e + 2] +
                  qv.w * kf[e + 3];
        }
      }
    }
    const float kmul =
        kQuant ? a.scale2 * reinterpret_cast<const float*>(st + 2 * KBYTES)[pw]
               : a.scale2;
    const float vmul =
        kQuant ? reinterpret_cast<const float*>(st + 2 * KBYTES)[
                     kDecChunk + pw]
               : 1.f;

    // online softmax over the warp's 16 positions (each on two lanes)
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      s[g] += __shfl_xor_sync(0xffffffffu, s[g], 1);
      const float sv = live ? s[g] * kmul : kNeg;
      float mx = sv;
#pragma unroll
      for (int o = 2; o < 32; o <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[g], mx);
      const float p = live ? exp2f(sv - m_new) : 0.f;
      float sum = p;
#pragma unroll
      for (int o = 2; o < 32; o <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      const float alpha = exp2f(m[g] - m_new);
      l[g] = l[g] * alpha + sum;
      m[g] = m_new;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[g][e] *= alpha;
      if (half == 0)
        ps[(warp * GT + g) * kDecPerWarp + (lane >> 1)] = p * vmul;
    }
    __syncwarp();

    // P.V: lane owns columns lane * EPL .. + EPL of the warp's 16 rows
    const uint8_t* vrow =
        st + KBYTES + warp * kDecPerWarp * ROW + lane * EPL * ITEM;
#pragma unroll
    for (int i0 = 0; i0 < kDecPerWarp; i0 += 4) {
      float4 pg[GT];
#pragma unroll
      for (int g = 0; g < GT; ++g)
        pg[g] = *reinterpret_cast<const float4*>(
            ps + (warp * GT + g) * kDecPerWarp + i0);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float vf[EPL];
        load_f32<KT, EPL>(vrow + (i0 + i) * ROW, vf);
#pragma unroll
        for (int g = 0; g < GT; ++g) {
          const float pv = i == 0 ? pg[g].x
                                  : (i == 1 ? pg[g].y
                                            : (i == 2 ? pg[g].z : pg[g].w));
#pragma unroll
          for (int e = 0; e < EPL; ++e) acc[g][e] += pv * vf[e];
        }
      }
    }
    __syncwarp();  // P is rewritten by the next chunk
  }

  // combine the warps' states in warp order (the ring is free: every copy
  // was waited for and consumed)
  __syncthreads();
  float* wm = reinterpret_cast<float*>(smem);  // [warp][GT]
  float* wl = wm + kDecWarps * GT;
  float* wacc = wl + kDecWarps * GT;           // [warp][GT][D]
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    if (lane == 0) {
      wm[warp * GT + g] = m[g];
      wl[warp * GT + g] = l[g];
    }
#pragma unroll
    for (int e = 0; e < EPL; ++e)
      wacc[(warp * GT + g) * D + lane * EPL + e] = acc[g][e];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < gn * D; i += kDecThreads) {
    const int g = i / D, d = i % D;
    float mx = kNeg;
#pragma unroll
    for (int w = 0; w < kDecWarps; ++w) mx = fmaxf(mx, wm[w * GT + g]);
    float lsum = 0.f, asum = 0.f;
#pragma unroll
    for (int w = 0; w < kDecWarps; ++w) {
      const float f = exp2f(wm[w * GT + g] - mx);
      lsum += f * wl[w * GT + g];
      asum += f * wacc[(w * GT + g) * D + d];
    }
    float* r = rec + g * rec_step;
    r[4 + d] = asum;
    if (d == 0) {
      r[0] = mx;
      r[1] = lsum;
    }
  }
}

// out[b, h] = sum over splits s of 2^(m_s - M) acc_s / sum of 2^(m_s - M)
// l_s, in split order, over the splits with l_s > 0; zeros if none. A warp
// a head, a lane D / 32 columns.
template <typename QT, int D>
__global__ void __launch_bounds__(kDecThreads)
    paged_attention_merge_kernel(Decode a) {
  constexpr int EPL = D / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int h = blockIdx.x * kDecWarps + warp, b = blockIdx.y;
  if (h >= a.H) return;
  const long long row = static_cast<long long>(b) * a.H + h;
  const float* rec = a.part + row * a.S * (D + 4);
  float mx = kNeg;
  for (int s = 0; s < a.S; ++s)
    if (rec[s * (D + 4) + 1] > 0.f) mx = fmaxf(mx, rec[s * (D + 4)]);
  float lsum = 0.f, acc[EPL];
#pragma unroll
  for (int e = 0; e < EPL; ++e) acc[e] = 0.f;
  for (int s = 0; s < a.S; ++s) {
    const float* r = rec + s * (D + 4);
    const float l = r[1];
    if (l > 0.f) {
      const float f = exp2f(r[0] - mx);
      lsum += f * l;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[e] += f * r[4 + lane * EPL + e];
    }
  }
  QT* out = static_cast<QT*>(a.out) + row * D + lane * EPL;
#pragma unroll
  for (int e = 0; e < EPL; ++e)
    out[e] = ptt::from_f32<QT>(lsum > 0.f ? acc[e] / lsum : 0.f);
}

template <typename QT, typename KT, int D, int GT>
int launch(const Decode& a, int B, cudaStream_t stream) {
  constexpr int smem = split_smem_bytes<KT, D, GT>();
  auto split = paged_attention_split_kernel<QT, KT, D, GT>;
  PTT_SET_SMEM(split, smem);
  const int HG = (a.G + GT - 1) / GT;
  split<<<dim3(a.KV * HG, B, a.S), kDecThreads, smem, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  paged_attention_merge_kernel<QT, D>
      <<<dim3((a.H + kDecWarps - 1) / kDecWarps, B), kDecThreads, 0,
         stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename QT, typename KT, int D>
int dispatch_gt(int gt, const Decode& a, int B, cudaStream_t stream) {
  if (gt == 4) return launch<QT, KT, D, 4>(a, B, stream);
  if (gt == 8) return launch<QT, KT, D, 8>(a, B, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int D>
int dispatch(int q_dtype, int kv_dtype, int gt, const Decode& a, int B,
             cudaStream_t stream) {
  // dtype codes: 0 float32, 1 bfloat16, 2 int8 (pools only)
  using bf16 = __nv_bfloat16;
  if (q_dtype == 0 && kv_dtype == 0)
    return dispatch_gt<float, float, D>(gt, a, B, stream);
  if (q_dtype == 0 && kv_dtype == 2)
    return dispatch_gt<float, int8_t, D>(gt, a, B, stream);
  if (q_dtype == 1 && kv_dtype == 1)
    return dispatch_gt<bf16, bf16, D>(gt, a, B, stream);
  if (q_dtype == 1 && kv_dtype == 2)
    return dispatch_gt<bf16, int8_t, D>(gt, a, B, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || KV <= 0 || H % KV || NB <= 0 || BS <= 0 || MB < 0 ||
      sp <= 0 || sp % BS || sp % kDecChunk || sp / BS > kTableCap || s <= 0 ||
      static_cast<long long>(s) * sp < static_cast<long long>(MB) * BS)
    return static_cast<int>(cudaErrorInvalidValue);
  const Decode a{q, k_pool, v_pool, static_cast<const float*>(k_scale),
                 static_cast<const float*>(v_scale),
                 static_cast<const int*>(block_tables),
                 static_cast<const int*>(context_lens),
                 static_cast<float*>(part), out, H, KV, H / KV, NB, BS, MB,
                 sp, s, scale * kLog2e};
  if (D == 128) return dispatch<128>(q_dtype, kv_dtype, gt, a, B, st);
  if (D == 64) return dispatch<64>(q_dtype, kv_dtype, gt, a, B, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
