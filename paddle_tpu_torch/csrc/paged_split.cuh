// The split-KV decode pass and its merge, shared by the gang decode
// (paged_attention.cu: one query token per batch row) and the decode rows
// of the ragged kernel (ragged_paged_attention.cu: rows of one query
// token in a packed step). One template parameter, the row policy, says
// where a row's query and output live; everything else is one code path.
//
// - paged_attention_split_kernel, grid (kv head x head group, row,
//   split): a block takes the positions [split * SP, (split + 1) * SP) of
//   one row (SP a multiple of the pool block and of the 64-position
//   chunk, from the wrapper's split plan) for up to GT query heads of one
//   kv head. Its chunks of 64 positions arrive through a cp.async ring of
//   NS stages in the pool's own dtype (int8 with its scales), are widened
//   to float32 in registers, and each of the 4 warps takes 16 positions
//   of a chunk: for Q.K two lanes share a position (half of head_dim
//   each; K's rows swizzled so those reads are free of bank conflicts),
//   for P.V each lane owns head_dim / 32 output columns. Each warp keeps
//   its own online-softmax state (m, l, acc) per head; the block combines
//   them in shared memory in warp order and writes one float32 partial
//   (m, l, acc[D]) per (row, head, split). A split past the row's context
//   writes l = 0 and exits. int8 scales fold into the scores (k_scale)
//   and into P (v_scale).
// - paged_attention_merge_kernel, grid (head quads, row): merges a row's
//   partials in split order (the log-sum-exp rescale, merge_records) and
//   rounds once to q's dtype; a row with no live split writes zeros. The
//   ragged kernel's merge runs merge_row for its decode rows and
//   merge_records for its tile pieces inside a kernel of its own.
//
// No atomics: two launches give the same bytes. Arithmetic is float32 on
// the CUDA cores (exp2 with log2(e) folded into the scale).

#pragma once

#include <type_traits>

#include "paged_attention_common.cuh"
#include "wgmma_common.cuh"

namespace ptt {
namespace dec {

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
  float* part;  // [rows * H][S][D + 4]: m, l, two pad words, acc[D]
  void* out;
  int H, KV, G, NB, BS, MB, SP, S;
  float scale2;  // scale * log2(e)
  const int* cu;  // ragged rows: cu_q_lens [R + 1]
};

// Where a decode row's query and output live, and whether the row is one.
// token(a, b) is the row's token in q and out ([tokens, H, D]), or -1 for
// a row that the split pass and the merge leave alone.
struct GangRows {  // gang decode: row b is q[b], out[b]
  __device__ static int token(const Decode&, int b) { return b; }
};
struct RaggedRows {  // ragged step: row r of one token is token cu[r]
  __device__ static int token(const Decode& a, int r) {
    const int c0 = a.cu[r];
    return a.cu[r + 1] - c0 == 1 ? c0 : -1;
  }
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

template <typename QT, typename KT, int D, int GT, class Rows>
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
  const int tok = Rows::token(a, b);
  if (tok < 0) return;
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
                   (static_cast<long long>(tok) * a.H + kvh * G + g0) * D;
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

// out[0, D) = sum over records k < n of 2^(m_k - M) acc_k / sum of
// 2^(m_k - M) l_k, in record order, over the records with l_k > 0; zeros
// if none. A record is (m, l, two pad words, acc[D]) in float32, m in
// log2 units; record k is at rec + k * stride. A lane D / 32 columns.
template <typename QT, int D>
__device__ __forceinline__ void merge_records(const float* rec,
                                              long long stride, int n,
                                              QT* out, int lane) {
  constexpr int EPL = D / 32;
  float mx = kNeg;
  for (int s = 0; s < n; ++s)
    if (rec[s * stride + 1] > 0.f) mx = fmaxf(mx, rec[s * stride]);
  float lsum = 0.f, acc[EPL];
#pragma unroll
  for (int e = 0; e < EPL; ++e) acc[e] = 0.f;
  for (int s = 0; s < n; ++s) {
    const float* r = rec + s * stride;
    const float l = r[1];
    if (l > 0.f) {  // a record with l == 0 may hold no m or acc
      const float f = exp2f(r[0] - mx);
      lsum += f * l;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[e] += f * r[4 + lane * EPL + e];
    }
  }
  out += lane * EPL;
#pragma unroll
  for (int e = 0; e < EPL; ++e)
    out[e] = ptt::from_f32<QT>(lsum > 0.f ? acc[e] / lsum : 0.f);
}

// out[b, h]: row b's split records of head h merged in split order. A
// warp a head.
template <typename QT, int D, class Rows>
__device__ __forceinline__ void merge_row(const Decode& a, int h, int b) {
  const int tok = Rows::token(a, b);
  if (h >= a.H || tok < 0) return;
  const long long row = static_cast<long long>(b) * a.H + h;
  merge_records<QT, D>(a.part + row * a.S * (D + 4), D + 4, a.S,
                       static_cast<QT*>(a.out) +
                           (static_cast<long long>(tok) * a.H + h) * D,
                       threadIdx.x % 32);
}

template <typename QT, int D, class Rows>
__global__ void __launch_bounds__(kDecThreads)
    paged_attention_merge_kernel(Decode a) {
  merge_row<QT, D, Rows>(a, blockIdx.x * kDecWarps + threadIdx.x / 32,
                         blockIdx.y);
}

// The split pass over `rows` rows: the wrapper's split plan gave a.SP,
// a.S and GT.
template <typename QT, typename KT, int D, int GT, class Rows>
int launch_split(const Decode& a, int rows, cudaStream_t stream) {
  constexpr int smem = split_smem_bytes<KT, D, GT>();
  auto split = paged_attention_split_kernel<QT, KT, D, GT, Rows>;
  PTT_SET_SMEM(split, smem);
  const int HG = (a.G + GT - 1) / GT;
  split<<<dim3(a.KV * HG, rows, a.S), kDecThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// the split pass for a (q, pool) dtype pair and head tile gt (dtype
// codes: 0 float32, 1 bfloat16, 2 int8, pools only)
template <int D, class Rows>
int dispatch_split(int q_dtype, int kv_dtype, int gt, const Decode& a,
                   int rows, cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
#define PTT_SPLIT(QT, KT)                                                \
  return gt == 4 ? launch_split<QT, KT, D, 4, Rows>(a, rows, stream)     \
                 : launch_split<QT, KT, D, 8, Rows>(a, rows, stream)
  if (gt != 4 && gt != 8) return static_cast<int>(cudaErrorInvalidValue);
  if (q_dtype == 0 && kv_dtype == 0) PTT_SPLIT(float, float);
  if (q_dtype == 0 && kv_dtype == 2) PTT_SPLIT(float, int8_t);
  if (q_dtype == 1 && kv_dtype == 1) PTT_SPLIT(bf16, bf16);
  if (q_dtype == 1 && kv_dtype == 2) PTT_SPLIT(bf16, int8_t);
#undef PTT_SPLIT
  return static_cast<int>(cudaErrorInvalidValue);
}

// the plan's arguments as the split pass takes them: sp a multiple of BS
// and of the chunk, at most kTableCap pool blocks, s * sp covering MB * BS
inline bool plan_ok(int BS, int MB, int sp, int s) {
  return sp > 0 && sp % BS == 0 && sp % kDecChunk == 0 &&
         sp / BS <= kTableCap && s > 0 &&
         static_cast<long long>(s) * sp >= static_cast<long long>(MB) * BS;
}

}  // namespace dec
}  // namespace ptt
