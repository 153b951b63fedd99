// Ragged paged attention on Hopper: one op call for a ragged mix of
// decode rows, prefill chunks and speculative verify rows over the paged
// KV pool.
//
// Replaces paddle_tpu/ops/kernels/pallas/ragged_paged_attention.py
// (`ragged_paged_attention`, kernel `_kernel`). Semantics kept:
//   - row r owns packed tokens cu[r]..cu[r+1]; its token i sits at
//     position ctx[r] - qlen[r] + i (ctx counts tokens after this step's
//     write: attention comes after the write) and sees positions <= its own;
//   - block-table entries are clamped to [0, NB-1];
//   - tokens past cu[R] (step padding) come back as exact zeros;
//   - a row that sees nothing divides by 1, not by 0;
//   - int8 pools come with float32 scales [NB, BS, KV];
//   - the output has q's dtype.
//
// The Pallas kernel walks a row's kv blocks as a sequential grid axis with
// (m, l, acc) in VMEM; carried over to Hopper, one block walks a whole
// context alone. Here every block picks its route itself from cu_q_lens
// and context_lens in device memory (no host sync), over a grid that
// depends on static quantities only (T, R, MB, BS, KV, G and the SM
// count), so one geometry serves every mix of a token budget. Three
// launches an op call (split pass, tile pass, merge), no atomics (two
// calls give the same bytes):
//
// 1. Decode rows (q_len 1, every dtype): the gang decode's split-KV pass
//    (paged_split.cuh, row policy RaggedRows: row r's query and output are
//    token cu[r]; other rows exit at once) over the plan's splits of the
//    row's context, every warp busy, int8 scales folded into the scores
//    and P.
// 2. The tile pass over rows of two or more tokens (verify rows, prefill
//    chunks). A tile is TQ = 64 / G tokens x the kv head's G query heads,
//    64 query rows; tile j of a row attends positions [0, end_j), its
//    causal horizon, in steps of 64. A tile that walks a long range alone
//    is the long pole, so the schedule (find_work, computed alike by every
//    block from cu_q_lens and context_lens) cuts every tile into pieces of
//    P = max(MP, ceil(W / E)) steps, W the steps of all tiles, MP the
//    wrapper's least piece and E a static count of extra work items (a few
//    per SM): the grid (NT + E, KV), NT =
//    R + ceil(T / TQ), always holds every piece (sum of ceil(steps / P) <=
//    tiles + W / P) and the blocks that zero the step padding, TQ tokens
//    each. A tile of one piece writes its output; the pieces of a longer
//    one write float32 records (m, l, acc) for the merge.
//    - bf16 q: ragged_paged_attention_tc_kernel, one warpgroup. Q.K^T and
//      P.V are wgmma (Q held in registers as A fragments; P as a bf16
//      hi/lo pair, as flash_wgmma.cuh does, so P.V keeps float32-level
//      accuracy), exp2 softmax in float32. K/V arrive in 64-position tiles
//      through the row's block table (the tile's 64 pool slots found a
//      step ahead of its copies) by cp.async, two stages, into the
//      128-byte swizzled layout; positions past the piece are never
//      loaded, and only boundary tiles are masked. An int8 pool's codes
//      (and scales) arrive by cp.async in a ring of their own and are
//      widened to bf16 through registers (exact: |code| <= 127); k_scale
//      multiplies the score columns, v_scale P's columns before P.V. No
//      float32 dequantized tile exists.
//    - float32 q: ragged_paged_attention_kernel, the CUDA-core tile of
//      paged_attention_common.cuh (it beats the library's float32 call).
// 3. ragged_paged_attention_merge_kernel: the decode rows' split records
//    and the tile pieces' records, each merged in order (paged_split.cuh's
//    merge_records), rounded once to q's dtype.

// What bounds it on the H100: a decode step is bytes (each row's context
// once, ~4 FLOP a byte); a prefill chunk over a long context is
// operations (a 256-token chunk at position 2048: ~640 FLOP a pool byte),
// hence the tensor cores for tiles and the split pass for decode rows.

#include <type_traits>

#include "flash_wgmma.cuh"
#include "paged_split.cuh"

namespace {

using bf16 = __nv_bfloat16;
namespace tc = ptt::tc;
using ptt::wg::cp_async16;
using ptt::wg::cp_async4;
using ptt::wg::cp_async_commit;
using ptt::wg::smem_u32;

constexpr int kTileRows = 64;  // query rows of a tile, K/V positions a step

struct Tiles {
  const void* q;
  const void* k_pool;
  const void* v_pool;
  const float* k_scale;
  const float* v_scale;
  const int* block_tables;
  const int* context_lens;
  const int* cu;
  void* out;
  float* part;  // [NT + E][KV][64][D + 4]: a piece's records by work item
  int* info;    // the tile count, then (row, tile, item0, pieces) a tile
  int T, H, KV, G, NB, BS, R, MB, TQ, E;
  int MP;  // steps a tile piece takes at least (the wrapper's MIN_PIECE)
  float scale;
};

// positions [0, end) that tile j of a row (first token c0, ql tokens,
// context c) attends: the causal horizon of its last token, never past the
// table
__device__ __forceinline__ int tile_end(const Tiles& a, int c0, int ql,
                                        int c, int j) {
  const int qc = min(min(a.TQ, ql - j * a.TQ), a.T - (c0 + j * a.TQ));
  return qc <= 0 ? 0 : max(0, min(c - ql + j * a.TQ + qc, a.MB * a.BS));
}

__device__ __forceinline__ int tile_steps(const Tiles& a, int c0, int ql,
                                          int c, int j) {
  return (tile_end(a, c0, ql, c, j) + kTileRows - 1) / kTileRows;
}

// one work item of the tile pass
struct Work {
  int row;      // the tile's row; -1: no tile (see spare)
  int tile;     // the tile's index within its row
  int piece;    // the piece's index within its tile
  int npieces;  // pieces of the tile
  int item0;    // work item of the tile's piece 0
  int steps;    // steps of a piece (P)
  int spare;    // row -1: items past the last one
  int ordinal;  // the tile's index among all tiles
  int ntiles;   // tiles of the step
};

// The schedule, found alike by every block that asks: rows of two or more
// tokens own ceil(q_len / TQ) tiles, in order; a tile of s steps is
// max(1, ceil(s / P)) pieces, P = max(MP, ceil(W / E)), W the steps
// of all tiles. Warp 0 finds work item t, a lane a row, 32 rows a round;
// then the block syncs.
__device__ void find_work(const Tiles& a, int t, Work* w) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int W = 0, ntiles = 0;
    for (int r0 = 0; r0 < a.R; r0 += 32) {
      const int r = r0 + lane;
      int wr = 0, nt = 0;
      if (r < a.R) {
        const int c0 = a.cu[r], ql = a.cu[r + 1] - c0;
        if (ql >= 2) {
          const int c = a.context_lens[r];
          nt = (ql + a.TQ - 1) / a.TQ;
          for (int j = 0; j < nt; ++j) wr += tile_steps(a, c0, ql, c, j);
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        wr += __shfl_xor_sync(~0u, wr, o);
        nt += __shfl_xor_sync(~0u, nt, o);
      }
      W += wr;
      ntiles += nt;
    }
    const int P = max(a.MP, (W + a.E - 1) / a.E);
    int items = 0, tiles = 0;  // before this round of rows
    bool found = false;
    for (int r0 = 0; r0 < a.R && !found; r0 += 32) {
      const int r = r0 + lane;
      int ni = 0, nt = 0, c0 = 0, ql = 0, c = 0;
      if (r < a.R) {
        c0 = a.cu[r];
        ql = a.cu[r + 1] - c0;
        if (ql >= 2) {
          c = a.context_lens[r];
          nt = (ql + a.TQ - 1) / a.TQ;
          for (int j = 0; j < nt; ++j)
            ni += max(1, (tile_steps(a, c0, ql, c, j) + P - 1) / P);
        }
      }
      int pi = ni, pt = nt;  // inclusive prefix sums over the lanes
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int x = __shfl_up_sync(~0u, pi, o);
        const int y = __shfl_up_sync(~0u, pt, o);
        if (lane >= o) {
          pi += x;
          pt += y;
        }
      }
      const int ei = items + pi - ni, et = tiles + pt - nt;
      const bool mine = t >= ei && t < ei + ni;
      if (mine) {
        int item = ei;
        for (int j = 0; j < nt; ++j) {
          const int n = max(1, (tile_steps(a, c0, ql, c, j) + P - 1) / P);
          if (t < item + n) {
            *w = Work{r, j, t - item, n, item, P, 0, et + j, ntiles};
            break;
          }
          item += n;
        }
      }
      found = __any_sync(~0u, mine);
      items += __shfl_sync(~0u, pi, 31);
      tiles += __shfl_sync(~0u, pt, 31);
    }
    if (!found && lane == 0)
      *w = Work{-1, 0, 0, 0, 0, P, t - items, 0, ntiles};
  }
  __syncthreads();
}

// For the merge: block (0, 0) writes the tile count, and each tile's
// piece 0 (kv head 0) its (row, tile, item0, pieces).
__device__ __forceinline__ void note_tile(const Tiles& a, const Work& w,
                                          int kvh) {
  if (kvh != 0 || threadIdx.x != 0) return;
  if (blockIdx.x == 0) a.info[0] = w.ntiles;
  if (w.row >= 0 && w.piece == 0)
    *reinterpret_cast<int4*>(a.info + 4 + 4 * w.ordinal) =
        make_int4(w.row, w.tile, w.item0, w.npieces);
}

// padding tile `index`: tokens [cu[R] + index * TQ, + TQ) of kv head
// kvh's query heads (G * D contiguous elements a token), as zeros
template <typename QT, int D>
__device__ __forceinline__ void zero_padding(const Tiles& a, int kvh,
                                             int index) {
  const int first = a.cu[a.R] + index * a.TQ;
  const int last = min(first + a.TQ, a.T);
  if (first < 0) return;
  const int per_tok = a.G * D * static_cast<int>(sizeof(QT)) / 16;
  const int n = (last - first) * per_tok;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int tok = first + i / per_tok;
    uint4* dst = reinterpret_cast<uint4*>(
        static_cast<QT*>(a.out) +
        (static_cast<long long>(tok) * a.H + kvh * a.G) * D);
    dst[i % per_tok] = make_uint4(0u, 0u, 0u, 0u);
  }
}

// a piece's rows and positions
struct Piece {
  int tok0;   // first token
  int nrows;  // live query rows: tokens x G
  int qp0;    // position of the first token
  int p0;     // positions [p0, p1) of the tile's causal range
  int p1;
};

__device__ __forceinline__ Piece piece_of(const Tiles& a, const Work& w) {
  const int c0 = a.cu[w.row], ql = a.cu[w.row + 1] - c0;
  Piece p;
  p.tok0 = c0 + w.tile * a.TQ;
  p.nrows = max(0, min(min(a.TQ, ql - w.tile * a.TQ), a.T - p.tok0)) * a.G;
  p.qp0 = a.context_lens[w.row] - ql + w.tile * a.TQ;
  p.p0 = w.piece * w.steps * kTileRows;
  p.p1 = min(p.p0 + w.steps * kTileRows,
             tile_end(a, c0, ql, a.context_lens[w.row], w.tile));
  return p;
}

// the records of work item `item`, kv head kvh (64 rows, D + 4 floats
// apart)
template <int D>
__device__ __forceinline__ float* records(const Tiles& a, int item, int kvh) {
  return a.part +
         (static_cast<long long>(item) * a.KV + kvh) * kTileRows * (D + 4);
}

// -- float32 q: the CUDA-core tile ------------------------------------------

template <typename KT, int D>
__global__ void __launch_bounds__(ptt::kThreads)
    ragged_paged_attention_kernel(Tiles a) {
  extern __shared__ float smem[];
  __shared__ Work w;
  const int kvh = blockIdx.y;
  find_work(a, blockIdx.x, &w);
  note_tile(a, w, kvh);
  if (w.row < 0) {
    zero_padding<float, D>(a, kvh, w.spare);
    return;
  }
  const Piece p = piece_of(a, w);
  ptt::attend_tile<float, KT, D>(
      static_cast<const float*>(a.q), static_cast<const KT*>(a.k_pool),
      static_cast<const KT*>(a.v_pool), a.k_scale, a.v_scale,
      a.block_tables + static_cast<long long>(w.row) * a.MB,
      static_cast<float*>(a.out), a.H, a.KV, a.G, a.NB, a.BS, kvh, p.tok0,
      p.nrows / a.G, p.qp0, p.p0, p.p1, a.scale, smem,
      w.npieces > 1 ? records<D>(a, blockIdx.x, kvh) : nullptr);
}

// -- bf16 q: the tensor-core tile --------------------------------------------

template <int D>
__host__ __device__ constexpr uint32_t raw_stage_bytes() {  // int8 K and V
  return 2 * kTileRows * D + 2 * kTileRows * 4;              // codes, scales
}

constexpr int kStages = 2;  // K/V steps: the one in use, the next in flight

// dynamic shared memory: a ring of kStages K/V bf16 tile pairs (bf16
// pool), or one bf16 pair and a ring of int8 codes; 1024 B of slack align
// the swizzled tiles (Q stays in registers)
template <typename KT, int D>
__host__ __device__ constexpr int tc_smem_bytes() {
  return std::is_same<KT, int8_t>::value
             ? 2 * tc::tile_bytes<D>() + kStages * raw_stage_bytes<D>() + 1024
             : 2 * kStages * tc::tile_bytes<D>() + 1024;
}

// byte offset of 16-byte chunk c of row r in a swizzled [64][D] bf16 tile
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return (c / 8) * (kTileRows * 128) + r * 128 + (((c % 8) ^ (r % 8)) << 4);
}

// d = A.B^T (acc 0) or d += A.B^T (acc 1): m64n64k16, A (Q) in registers
// in the A-fragment layout, B (a K tile) in shared memory K-major
__device__ __forceinline__ void mma_rs_k(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t b,
                                         int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

template <typename KT, int D>
__global__ void __launch_bounds__(tc::kThreads)
    ragged_paged_attention_tc_kernel(Tiles a) {
  constexpr bool kQuant = std::is_same<KT, int8_t>::value;
  constexpr uint32_t TB = tc::tile_bytes<D>();
  constexpr uint32_t RAW = raw_stage_bytes<D>();
  constexpr int CPR = D / 8;    // 16-byte chunks of a bf16 row
  constexpr int C8 = D / 16;    // 16-byte chunks of an int8 row
  extern __shared__ __align__(16) uint8_t tc_smem[];
  __shared__ Work w;
  __shared__ int sl[kStages][kTileRows];  // pool slots of a step's positions
  const int kvh = blockIdx.y, G = a.G;
  find_work(a, blockIdx.x, &w);
  note_tile(a, w, kvh);
  if (w.row < 0) {
    zero_padding<bf16, D>(a, kvh, w.spare);
    return;
  }
  const Piece g = piece_of(a, w);
  const int ntiles = (g.p1 - g.p0 + kTileRows - 1) / kTileRows;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int ra = 16 * warp + lane / 4, rb = ra + 8;  // this thread's rows

  // Q in registers, the A fragments of the D / 16 k steps of Q.K^T: row
  // ri is token tok0 + ri / G, head kvh * G + ri % G; rows past nrows are 0
  uint32_t qf[D / 16][4];
  {
    const bf16* q = static_cast<const bf16*>(a.q);
    const uint32_t* qa = reinterpret_cast<const uint32_t*>(
        q + (static_cast<long long>(g.tok0 + ra / G) * a.H + kvh * G +
             ra % G) * D);
    const uint32_t* qb = reinterpret_cast<const uint32_t*>(
        q + (static_cast<long long>(g.tok0 + rb / G) * a.H + kvh * G +
             rb % G) * D);
    const bool oa = ra < g.nrows && ntiles > 0;
    const bool ob = rb < g.nrows && ntiles > 0;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int c = 8 * kk + (lane & 3);  // 32-bit word of columns 16kk + 2q
      qf[kk][0] = oa ? qa[c] : 0u;
      qf[kk][1] = ob ? qb[c] : 0u;
      qf[kk][2] = oa ? qa[c + 4] : 0u;
      qf[kk][3] = ob ? qb[c + 4] : 0u;
    }
  }

  const uint32_t raw = smem_u32(tc_smem);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* gbase = tc_smem + (base - raw);  // generic address of `base`
  // bf16 pool: K/V of stage st at base + 2 st TB (+ TB); int8: one bf16
  // K/V pair at base (+ TB), the codes of stage st at base + 2 TB + st RAW
  auto stage_k = [&](int st) { return kQuant ? base : base + 2 * st * TB; };
  const uint32_t sRaw = base + 2 * TB;

  // The pool slots of step t's positions go to sl[t % kStages] before the
  // barrier that precedes its copies (threads 0..63, a position each; -1
  // at or past p1, never read); the block-table id behind them is loaded a
  // step before that, so no thread waits on the table.
  const int* trow = a.block_tables + static_cast<long long>(w.row) * a.MB;
  auto table_id = [&](int t) {
    const int pos = g.p0 + t * kTileRows + threadIdx.x;
    return threadIdx.x < kTileRows && t < ntiles && pos < g.p1
               ? trow[pos / a.BS] : 0;
  };
  auto fill_slots = [&](int t, int id) {
    if (threadIdx.x < kTileRows && t < ntiles) {
      const int pos = g.p0 + t * kTileRows + threadIdx.x;
      id = id < 0 ? 0 : (id >= a.NB ? a.NB - 1 : id);
      sl[t % kStages][threadIdx.x] = pos < g.p1 ? id * a.BS + pos % a.BS : -1;
    }
  };
#pragma unroll
  for (int t = 0; t < kStages; ++t) fill_slots(t, table_id(t));
  int next_id = table_id(kStages);
  __syncthreads();

  const KT* kp = static_cast<const KT*>(a.k_pool);
  const KT* vp = static_cast<const KT*>(a.v_pool);
  // K/V of step t into its stage (positions at or past p1 zero-filled);
  // one commit group a step, empty past the last
  auto load_kv = [&](int t) {
    if (t < ntiles) {
      const int st = t % kStages;
      const int* slots = sl[st];
      if constexpr (kQuant) {
        const uint32_t dst = sRaw + st * RAW;
        for (int v = threadIdx.x; v < kTileRows * C8; v += tc::kThreads) {
          const int r = v / C8, c = v % C8, sr = slots[r];
          const long long off =
              sr >= 0 ? (static_cast<long long>(sr) * a.KV + kvh) * D + c * 16
                      : 0;
          cp_async16(dst + r * D + c * 16, kp + off, sr >= 0);
          cp_async16(dst + kTileRows * D + r * D + c * 16, vp + off,
                     sr >= 0);
        }
        // one scale a thread: K's 64, then V's 64
        const int sr = slots[threadIdx.x % kTileRows];
        const long long off =
            sr >= 0 ? static_cast<long long>(sr) * a.KV + kvh : 0;
        cp_async4(dst + 2 * kTileRows * D + threadIdx.x * 4,
                  (threadIdx.x < kTileRows ? a.k_scale : a.v_scale) + off,
                  sr >= 0);
      } else {
        const uint32_t dK = stage_k(st);
        for (int v = threadIdx.x; v < kTileRows * CPR; v += tc::kThreads) {
          const int r = v / CPR, c = v % CPR, sr = slots[r];
          const long long off =
              sr >= 0 ? (static_cast<long long>(sr) * a.KV + kvh) * D + c * 8
                      : 0;
          cp_async16(dK + swz(r, c), kp + off, sr >= 0);
          cp_async16(dK + TB + swz(r, c), vp + off, sr >= 0);
        }
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) load_kv(t);

  const int qpos[2] = {g.qp0 + ra / G, g.qp0 + rb / G};
  const float sl2 = a.scale * tc::kLog2e;
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int t = 0; t < ntiles; ++t) {
    const int st = t % kStages, c0 = g.p0 + t * kTileRows;
    // step t landed; every thread is past step t - 1, whose stage takes
    // step t + kStages - 1
    ptt::wg::cp_async_wait_visible_but<kStages - 2>();
    load_kv(t + kStages - 1);
    // step t's slots were read by its copies (before this barrier): step
    // t + kStages takes their place
    fill_slots(t + kStages, next_id);
    next_id = table_id(t + kStages + 1);
    const uint32_t sK = stage_k(st), sV = sK + TB;
    const float* ksc = nullptr;
    const float* vsc = nullptr;
    if constexpr (kQuant) {
      // widen stage st's codes to the bf16 K/V tiles (exact), in registers
      const uint8_t* src = gbase + (sRaw - base) + st * RAW;
      for (int v = threadIdx.x; v < 2 * kTileRows * C8; v += tc::kThreads) {
        const int which = v / (kTileRows * C8), wv = v % (kTileRows * C8);
        const int r = wv / C8, c = wv % C8;
        const uint4 u = *reinterpret_cast<const uint4*>(
            src + which * kTileRows * D + r * D + c * 16);
        const uint32_t wd[4] = {u.x, u.y, u.z, u.w};
        uint32_t h[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int b = 0; b < 4; b += 2)
            h[2 * i + b / 2] = tc::pack_bf16(
                static_cast<float>(static_cast<int8_t>(wd[i] >> (8 * b))),
                static_cast<float>(
                    static_cast<int8_t>(wd[i] >> (8 * (b + 1)))));
        }
        uint8_t* tile = gbase + (sK - base) + which * TB;
        *reinterpret_cast<uint4*>(tile + swz(r, 2 * c)) =
            make_uint4(h[0], h[1], h[2], h[3]);
        *reinterpret_cast<uint4*>(tile + swz(r, 2 * c + 1)) =
            make_uint4(h[4], h[5], h[6], h[7]);
      }
      ptt::wg::fence_async_smem();
      __syncthreads();
      ksc = reinterpret_cast<const float*>(src + 2 * kTileRows * D);
      vsc = ksc + kTileRows;
    }

    float s[32];
    ptt::wg::wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      mma_rs_k(s, qf[kk], ptt::wg::desc_k<kTileRows>(sK, kk), kk);
    ptt::wg::wg_commit();
    ptt::wg::wg_wait();
    ptt::wg::reg_fence(s);

    // every (row, column) pair live: no mask
    const bool full = c0 + kTileRows - 1 <= g.qp0 &&
                      c0 + kTileRows <= g.p1;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int h = (i >> 1) & 1, cl = tc::col_of(i, lane), pos = c0 + cl;
      float x = s[i] * sl2;
      if constexpr (kQuant) x *= ksc[cl];
      if (!full && !(pos <= qpos[h] && pos < g.p1)) x = -INFINITY;
      s[i] = x;
      mx[h] = fmaxf(mx[h], x);
    }
    float mu[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float mn = fmaxf(m[h], tc::quad_max(mx[h]));
      mu[h] = mn == -INFINITY ? 0.f : mn;
      const float alpha = tc::ex2(m[h] - mu[h]);
      m[h] = mn;
      l[h] *= alpha;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        acc[4 * j + 2 * h] *= alpha;
        acc[4 * j + 2 * h + 1] *= alpha;
      }
    }
    uint32_t ph[4][4], pl[4][4];
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int h = (i >> 1) & 1;
      float p0 = tc::ex2(s[i] - mu[h]), p1 = tc::ex2(s[i + 1] - mu[h]);
      l[h] += p0 + p1;
      if constexpr (kQuant) {
        const int cl = tc::col_of(i, lane);
        p0 *= vsc[cl];
        p1 *= vsc[cl + 1];
      }
      tc::split_bf16(p0, p1, ph[i / 8][(i % 8) / 2], pl[i / 8][(i % 8) / 2]);
    }
    ptt::wg::wg_fence();
    tc::mma_frag<D>(acc, ph, pl, sV);
    ptt::wg::wg_commit();
    ptt::wg::wg_wait();
    ptt::wg::reg_fence(acc);
  }

  bf16* out = static_cast<bf16*>(a.out);
  float* rec = records<D>(a, blockIdx.x, kvh);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float lt = tc::quad_sum(l[h]);
    const int r = h ? rb : ra;
    if (r >= g.nrows) continue;
    if (w.npieces > 1) {  // this piece's record of row r
      float* dst = rec + r * (D + 4);
      if ((lane & 3) == 0) {
        dst[0] = m[h];
        dst[1] = lt;
      }
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<float2*>(dst + 4 + 8 * j + 2 * (lane & 3)) =
            make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      continue;
    }
    tc::store_rows<D>(
        out + (static_cast<long long>(g.tok0 + r / G) * a.H + kvh * G +
               r % G) * D,
        acc, h, lane, lt == 0.f ? 0.f : 1.f / lt);
  }
}

// The merge, a persistent grid of 16-warp blocks over its items: first
// (decode row r, 16 heads), a warp a head, then (tile, kv head, 16 rows)
// for each tile cut in more than one piece, a warp a row; each row's
// records merged in order. The tile pass left the tiles' pieces in a.info.
constexpr int kMergeWarps = 16;

template <typename QT, int D>
__global__ void __launch_bounds__(kMergeWarps * 32)
    ragged_paged_attention_merge_kernel(ptt::dec::Decode d, Tiles a) {
  using namespace ptt::dec;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int hq = (a.H + kMergeWarps - 1) / kMergeWarps;
  const int nd = a.R * hq, nt = a.info[0] * a.KV * 4;
  for (int item = blockIdx.x; item < nd + nt; item += gridDim.x) {
    if (item < nd) {
      merge_row<QT, D, RaggedRows>(d, item % hq * kMergeWarps + warp,
                                   item / hq);
      continue;
    }
    const int i = (item - nd) / (4 * a.KV), kvh = (item - nd) / 4 % a.KV;
    const int4 t = *reinterpret_cast<const int4*>(a.info + 4 + 4 * i);
    if (t.w < 2) continue;  // one piece: the tile pass wrote the output
    const int c0 = a.cu[t.x], ql = a.cu[t.x + 1] - c0;
    const int tok0 = c0 + t.y * a.TQ;
    const int nrows =
        max(0, min(min(a.TQ, ql - t.y * a.TQ), a.T - tok0)) * a.G;
    const int ri = (item - nd) % 4 * kMergeWarps + warp;
    if (ri >= nrows) continue;
    merge_records<QT, D>(
        records<D>(a, t.z, kvh) + ri * (D + 4),
        static_cast<long long>(a.KV) * kTileRows * (D + 4), t.w,
        static_cast<QT*>(a.out) +
            (static_cast<long long>(tok0 + ri / a.G) * a.H + kvh * a.G +
             ri % a.G) * D,
        lane);
  }
}

// the tile pass, then the merge
template <typename QT, typename KT, int D>
int launch_tiles(const ptt::dec::Decode& d, const Tiles& a, int NT,
                 cudaStream_t stream) {
  const dim3 grid(NT + a.E, a.KV);
  if constexpr (std::is_same<QT, float>::value) {
    auto kern = ragged_paged_attention_kernel<KT, D>;
    const int smem = ptt::smem_floats<D>() * static_cast<int>(sizeof(float));
    PTT_SET_SMEM(kern, smem);
    kern<<<grid, ptt::kThreads, smem, stream>>>(a);
  } else {
    auto kern = ragged_paged_attention_tc_kernel<KT, D>;
    constexpr int smem = tc_smem_bytes<KT, D>();
    PTT_SET_SMEM(kern, smem);
    kern<<<grid, tc::kThreads, smem, stream>>>(a);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // E * KV is about four blocks an SM (the wrapper's extra_items): the
  // merge takes about two
  ragged_paged_attention_merge_kernel<QT, D>
      <<<max(1, a.E * a.KV / 2), kMergeWarps * 32, 0, stream>>>(d, a);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int dispatch_tiles(int q_dtype, int kv_dtype, const ptt::dec::Decode& d,
                   const Tiles& a, int NT, cudaStream_t stream) {
  // dtype codes: 0 float32, 1 bfloat16, 2 int8 (pools only)
  if (q_dtype == 0 && kv_dtype == 0)
    return launch_tiles<float, float, D>(d, a, NT, stream);
  if (q_dtype == 0 && kv_dtype == 2)
    return launch_tiles<float, int8_t, D>(d, a, NT, stream);
  if (q_dtype == 1 && kv_dtype == 1)
    return launch_tiles<bf16, bf16, D>(d, a, NT, stream);
  if (q_dtype == 1 && kv_dtype == 2)
    return launch_tiles<bf16, int8_t, D>(d, a, NT, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Launches the split pass over the decode rows, the tile pass and the
// merge. part: float32 scratch of (R * H * s + (NT + E) * KV * 64) * (D +
// 4) + 4 * (NT + 1) words (the split records, the tile pieces', the
// tiles' table); sp, s, gt: the
// split plan (paged_split.cuh plan_ok); NT: at least R + ceil(T / TQ);
// TQ = 64 / (H / KV); E >= 1: extra work items of the tile pass; MP >= 1:
// steps a tile piece takes at least. Returns
// the cudaError_t of the launches.
extern "C" int ptt_ragged_paged_attention(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* block_tables,
    const void* context_lens, const void* cu_q_lens, void* part, void* out,
    int T, int H, int KV, int D, int NB, int BS, int R, int MB, int NT,
    int TQ, int E, int MP, int sp, int s, int gt, float scale, int q_dtype,
    int kv_dtype, void* stream) {
  using namespace ptt::dec;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (T <= 0 || R <= 0 || KV <= 0 || H % KV || NB <= 0 || BS <= 0 ||
      MB < 0 || kTileRows % (H / KV) || TQ != kTileRows / (H / KV) ||
      NT < R + (T + TQ - 1) / TQ || E < 1 || MP < 1 ||
      !plan_ok(BS, MB, sp, s) ||
      (D != 64 && D != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  const int* cu = static_cast<const int*>(cu_q_lens);
  float* split_part = static_cast<float*>(part);
  float* tile_part = split_part + static_cast<long long>(R) * H * s * (D + 4);
  const Decode d{q, k_pool, v_pool, static_cast<const float*>(k_scale),
                 static_cast<const float*>(v_scale),
                 static_cast<const int*>(block_tables),
                 static_cast<const int*>(context_lens), split_part, out, H,
                 KV, H / KV, NB, BS, MB, sp, s, scale * kLog2e, cu};
  const Tiles a{q, k_pool, v_pool, static_cast<const float*>(k_scale),
                static_cast<const float*>(v_scale),
                static_cast<const int*>(block_tables),
                static_cast<const int*>(context_lens), cu, out,
                tile_part, reinterpret_cast<int*>(
                    tile_part + static_cast<long long>(NT + E) * KV *
                                    kTileRows * (D + 4)),
                T, H, KV, H / KV, NB, BS, R, MB, TQ, E, MP, scale};
  const int rc = D == 128
                     ? dispatch_split<128, RaggedRows>(q_dtype, kv_dtype, gt,
                                                       d, R, st)
                     : dispatch_split<64, RaggedRows>(q_dtype, kv_dtype, gt,
                                                      d, R, st);
  if (rc) return rc;
  return D == 128 ? dispatch_tiles<128>(q_dtype, kv_dtype, d, a, NT, st)
                  : dispatch_tiles<64>(q_dtype, kv_dtype, d, a, NT, st);
}
