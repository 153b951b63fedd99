"""Ragged paged attention: one kernel for mixed prefill + decode.

Replaces ``paddle_tpu/ops/kernels/pallas/ragged_paged_attention.py``
(``ragged_paged_attention``, :115). Every row of a serving step
contributes ``q_len`` query tokens (1 for a decode row, the chunk size for
a prefill chunk, 1+K for a speculative verify row) and attends causally
against its own block-table slice of the shared pool.

Layout: packed ``q[T, H, D]`` segmented by ``cu_q_lens[R+1]``; row r's
token i sits at position ``context_lens[r] - q_len_r + i`` (the chunk is
already written: write-then-attend).

What bounds it on the H100: a decode row reads its whole context once
per layer (about 1 MB per 1000 positions at Llama-3-8B widths in bf16,
half that in int8) for about one multiply-add a byte; a prefill chunk
over a long context does hundreds of operations a byte. So the kernels
(``csrc/ragged_paged_attention.cu``) take two routes, each block picking
its own from ``cu_q_lens`` and ``context_lens`` on the card (no host
sync) over a grid of static quantities (T, R, MB, BS, KV, G and the SM
count): decode rows (q_len 1) go through the gang decode's split-KV pass
and merge (``csrc/paged_split.cuh``, the split plan of
``paged_attention.call_plan`` with R rows), and rows of two or more
tokens through a tile pass of 64 query rows (TQ tokens x G heads) that
runs its products on the tensor cores (``wgmma``) for bf16 q, fed by
``cp.async`` through the block table, and on the CUDA cores for float32
q; a tile with a long causal range is cut into pieces of a few 64-position
steps (``tile_schedule``). Three launches a call: the split pass, the
tile pass, one merge for both.

Beside the kernels: ``ragged_paged_attention_plain``, the same function in
plain PyTorch, row by row (each row gathers its ``ceil(ctx/BS)`` blocks
once), used for CPU tensors, by the tests and by ``chip_smoke.py``;
``ragged_paged_attention_split_plain``, a plain mirror of the kernels'
arithmetic, and ``tile_schedule``, a mirror of the tile pass's schedule
(tests and ``chip_smoke.py`` only); and ``launches``, the count of op
calls that launched the kernels.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple

import torch

from . import _build

launches = _build.LaunchCounter("ragged_paged_attention")

ROWS_PER_TILE = 64    # csrc kRows: query rows (tokens x GQA group) of a tile
HEAD_DIMS = (64, 128)
_NEG = -1e30


def _paged():
    # imported at the call: paged_attention imports this module
    from . import paged_attention
    return paged_attention


def tile_tokens(num_heads: int, num_kv_heads: int) -> int:
    """Query tokens per tile: the tile's 64 rows hold TQ tokens of G
    heads each."""
    return ROWS_PER_TILE // (num_heads // num_kv_heads)


def num_tiles(T: int, R: int, tq: int) -> int:
    """Static tile-count bound ``R + ceil(T/TQ)``: each row wastes at most
    one partial tile, so one grid serves every mix of a token budget."""
    return R + -(-T // tq)


MIN_PIECE = 4           # steps a tile piece takes at least (passed to csrc)
TILE_ITEMS_PER_SM = 4   # extra work items of the tile pass, per SM
TILE_POSITIONS = 64     # csrc kTileRows: K/V positions of a tile step


def launch_geometry(T: int, H: int, KV: int, R: int, MB: int, BS: int,
                    sms: int) -> dict:
    """The launches of an op call, from static quantities only (never
    ``cu_q_lens`` or ``context_lens``): the split pass's plan (``sp``,
    ``splits``, ``gt``: ``paged_attention.split_plan`` with R rows, the
    gang decode's), its grid ``split_grid``; the tile pass's ``tq`` tokens
    a tile, ``tiles`` (NT) and ``extra`` (E) work items, its grid
    ``tile_grid``."""
    pa = _paged()
    G = H // KV
    gt = pa.head_tile(G)
    groups = -(-G // gt)
    sp, splits = pa.split_plan(MB, BS, R, KV * groups, sms)
    tq = tile_tokens(H, KV)
    nt, extra = num_tiles(T, R, tq), extra_items(KV, sms)
    return dict(sp=sp, splits=splits, gt=gt, split_grid=(KV * groups, R,
                                                         splits),
                tq=tq, tiles=nt, extra=extra, tile_grid=(nt + extra, KV))


def extra_items(num_kv_heads: int, sms: int) -> int:
    """``E``, the tile pass's extra work items beyond ``num_tiles``: about
    ``TILE_ITEMS_PER_SM`` blocks an SM over the kv heads."""
    return -(-TILE_ITEMS_PER_SM * sms // num_kv_heads)


def tile_schedule(cu, ctx, T: int, tq: int, mb: int, bs: int,
                  extra: int) -> Tuple[int, List[Tuple[int, int, int, int]]]:
    """Mirror of the tile pass's schedule (``find_work``) over ``cu`` and
    ``ctx`` (lists): ``(P, items)``, P the steps of a piece and items the
    work items in order, each ``(row, tile, piece, pieces)``. Rows of two
    or more tokens own ``ceil(q_len / tq)`` tiles; tile j attends
    positions below :func:`tile_end`, in steps of 64; a tile of s steps
    is ``max(1, ceil(s / P))`` pieces, ``P = max(MIN_PIECE, ceil(W /
    extra))``, W the steps of all tiles. Work item ``len(items) + i`` of
    the grid zeroes tokens ``cu[R] + i * tq`` up to ``tq`` on."""
    tiles = [(r, j) for r in range(len(cu) - 1) if cu[r + 1] - cu[r] >= 2
             for j in range(-(-(cu[r + 1] - cu[r]) // tq))]
    steps = [-(-tile_end(cu, ctx, T, tq, mb, bs, r, j) // TILE_POSITIONS)
             for r, j in tiles]
    P = max(MIN_PIECE, -(-sum(steps) // extra))
    items = []
    for (r, j), s in zip(tiles, steps):
        n = max(1, -(-s // P))
        items += [(r, j, k, n) for k in range(n)]
    return P, items


def call_schedule(q, k_pool, block_tables, context_lens, cu_q_lens
                  ) -> Tuple[int, List[Tuple[int, int, int, int]]]:
    """The :func:`tile_schedule` of a call over these tensors on the card
    (reads ``cu_q_lens`` and ``context_lens`` on the host: tests and
    ``chip_smoke.py`` only)."""
    T, H, _ = q.shape
    _, BS, KV, _ = k_pool.shape
    return tile_schedule(
        [int(x) for x in cu_q_lens.tolist()],
        [int(x) for x in context_lens.tolist()], T, tile_tokens(H, KV),
        block_tables.shape[1], BS,
        extra_items(KV, _paged().sm_count(q.device)))


def tile_end(cu, ctx, T: int, tq: int, mb: int, bs: int, r: int,
             j: int) -> int:
    """Positions ``[0, end)`` that tile j of row r attends: its last
    token's causal horizon, never past the table (csrc ``tile_end``)."""
    ql = cu[r + 1] - cu[r]
    qc = min(tq, ql - j * tq, T - (cu[r] + j * tq))
    return 0 if qc <= 0 else max(0, min(ctx[r] - ql + j * tq + qc, mb * bs))


def ragged_paged_attention_plain(q, k_pool, v_pool, block_tables,
                                 context_lens, cu_q_lens, scale=None,
                                 k_scale=None, v_scale=None):
    """Plain PyTorch version, row by row. Same arguments and result as
    :func:`ragged_paged_attention`. Reads ``cu_q_lens`` and
    ``context_lens`` on the host."""
    T, H, D = q.shape
    NB, BS, KV, _ = k_pool.shape
    R, MB = block_tables.shape
    G = H // KV
    if scale is None:
        scale = D ** -0.5
    out = torch.zeros_like(q)
    cu = [int(x) for x in cu_q_lens.tolist()]
    ctx = [int(x) for x in context_lens.tolist()]
    tbl = block_tables.long().clamp(0, NB - 1)
    for r in range(R):
        ql = cu[r + 1] - cu[r]
        # positions past the table are never attended, as in the kernel
        L = min(ctx[r], MB * BS)
        if ql <= 0 or L <= 0:
            continue
        nblk = -(-L // BS)
        blocks = tbl[r, :nblk]
        k = k_pool[blocks].float()
        v = v_pool[blocks].float()
        if k_scale is not None:
            k = k * k_scale[blocks].float()[..., None]
            v = v * v_scale[blocks].float()[..., None]
        k = k.reshape(nblk * BS, KV, D)[:L]
        v = v.reshape(nblk * BS, KV, D)[:L]
        qr = q[cu[r]:cu[r + 1]].float().reshape(ql, KV, G, D)
        qpos = ctx[r] - ql + torch.arange(ql, device=q.device)
        live = (torch.arange(L, device=q.device)[None, :]
                <= qpos[:, None])                               # [ql, L]
        s = torch.einsum("qkgd,lkd->kgql", qr, k) * scale
        s = s.masked_fill(~live, _NEG)
        p = torch.exp(s - s.amax(dim=-1, keepdim=True)) * live
        l = p.sum(dim=-1, keepdim=True)
        o = torch.einsum("kgql,lkd->kgqd", p, v) / torch.where(
            l == 0, torch.ones_like(l), l)
        out[cu[r]:cu[r + 1]] = (o.permute(2, 0, 1, 3)
                                .reshape(ql, H, D).to(q.dtype))
    return out


_LOG2E = 1.4426950408889634


def ragged_paged_attention_split_plain(q, k_pool, v_pool, block_tables,
                                       context_lens, cu_q_lens, scale=None,
                                       k_scale=None, v_scale=None,
                                       sp: int = TILE_POSITIONS,
                                       piece: Optional[int] = None):
    """Plain mirror of the kernels' arithmetic. Decode rows (q_len 1) go
    through the split-KV mirror (``paged_attention_split_plain``: splits
    of ``sp`` positions, base-2 exponents, merged in split order); rows of
    two or more tokens walk their positions in pieces of ``piece`` steps
    of 64 (None: one piece), each piece with a running (m, l, acc) in
    float32 and base-2 exponents, an int8 pool's ``k_scale`` multiplying
    the score columns and ``v_scale`` P's columns before P.V, the pieces
    merged in order. Same arguments and result as
    :func:`ragged_paged_attention_plain`."""
    T, H, D = q.shape
    NB, BS, KV, _ = k_pool.shape
    R, MB = block_tables.shape
    G = H // KV
    if scale is None:
        scale = D ** -0.5
    scale2 = scale * _LOG2E
    out = torch.zeros_like(q)
    cu = [int(x) for x in cu_q_lens.tolist()]
    ctx = [int(x) for x in context_lens.tolist()]
    dec = [r for r in range(R) if cu[r + 1] - cu[r] == 1]
    if dec:
        idx = torch.tensor(dec, device=q.device)
        got = _paged().paged_attention_split_plain(
            q[[cu[r] for r in dec]][:, None].contiguous(), k_pool, v_pool,
            block_tables[idx], context_lens[idx], scale, k_scale, v_scale,
            sp=sp)
        out[[cu[r] for r in dec]] = got[:, 0]
    tbl = block_tables.long().clamp(0, NB - 1)
    neg = float("-inf")
    for r in range(R):
        ql = cu[r + 1] - cu[r]
        L = min(ctx[r], MB * BS)
        if ql < 2 or L <= 0:
            continue
        nblk = -(-L // BS)
        blocks = tbl[r, :nblk]
        k = k_pool[blocks].float().reshape(nblk * BS, KV, D)[:L]
        v = v_pool[blocks].float().reshape(nblk * BS, KV, D)[:L]
        if k_scale is not None:
            ks = k_scale[blocks].float().reshape(nblk * BS, KV)[:L]
            vs = v_scale[blocks].float().reshape(nblk * BS, KV)[:L]
        qr = q[cu[r]:cu[r + 1]].float().reshape(ql, KV, G, D)
        qpos = ctx[r] - ql + torch.arange(ql, device=q.device)
        span = L if piece is None else piece * TILE_POSITIONS
        parts = []
        for p0 in range(0, L, span):
            m = torch.full((KV, G, ql), neg, device=q.device)
            l = torch.zeros((KV, G, ql), device=q.device)
            acc = torch.zeros((KV, G, ql, D), device=q.device)
            for c0 in range(p0, min(p0 + span, L), TILE_POSITIONS):
                c1 = min(c0 + TILE_POSITIONS, L)
                s = torch.einsum("qkgd,lkd->kgql", qr, k[c0:c1]) * scale2
                if k_scale is not None:
                    s = s * ks[c0:c1].t()[:, None, None, :]
                live = (torch.arange(c0, c1, device=q.device)[None, :]
                        <= qpos[:, None])
                s = s.masked_fill(~live, neg)
                mn = torch.maximum(m, s.amax(dim=-1))
                mu = torch.where(mn == neg, torch.zeros_like(mn), mn)
                alpha = torch.exp2(m - mu)
                p = torch.exp2(s - mu[..., None])
                l = l * alpha + p.sum(dim=-1)
                if v_scale is not None:
                    p = p * vs[c0:c1].t()[:, None, None, :]
                acc = acc * alpha[..., None] + torch.einsum(
                    "kgql,lkd->kgqd", p, v[c0:c1])
                m = mn
            parts.append((m, l, acc))
        # the pieces in order, those with l > 0 (csrc merge_records)
        mx = torch.stack([torch.where(l > 0, m, torch.full_like(m, neg))
                          for m, l, _ in parts]).amax(dim=0)
        lsum = torch.zeros_like(mx)
        osum = torch.zeros_like(parts[0][2])
        for m, l, a in parts:
            f = torch.where(l > 0, torch.exp2(m - mx), torch.zeros_like(m))
            lsum = lsum + f * l
            osum = osum + f[..., None] * a
        o = osum / torch.where(lsum == 0, torch.ones_like(lsum),
                               lsum)[..., None]
        out[cu[r]:cu[r + 1]] = (o.permute(2, 0, 1, 3)
                                .reshape(ql, H, D).to(q.dtype))
    return out


def _bind(lib) -> None:
    fn = lib.ptt_ragged_paged_attention
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 15
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def check_tensors(q, k_scale, v_scale, **named) -> None:
    """Every tensor on q's device, contiguous and 16-byte aligned, and
    k_scale and v_scale given together (both paged kernels' rule)."""
    named = dict(q=q, **named)
    if k_scale is not None or v_scale is not None:
        named.update(k_scale=k_scale, v_scale=v_scale)
    for name, t in named.items():
        if t is None:
            raise ValueError(f"{name} is None: k_scale and v_scale go "
                             f"together")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def check_pools(q, k_pool, v_pool, k_scale, v_scale) -> None:
    """Both paged kernels' pool rule: pools ``[NB, BS, KV, D]`` alike with
    q's head_dim in ``HEAD_DIMS``; q float32 or bfloat16; the pools in q's
    dtype, or int8 with float32 scales ``[NB, BS, KV]``."""
    if k_pool.dim() != 4 or v_pool.shape != k_pool.shape \
            or v_pool.dtype != k_pool.dtype:
        raise ValueError(f"pools must be [NB,BS,KV,D] and alike, got "
                         f"{tuple(k_pool.shape)} {k_pool.dtype} and "
                         f"{tuple(v_pool.shape)} {v_pool.dtype}")
    NB, BS, KV, PD = k_pool.shape
    D = q.shape[-1]
    if PD != D or D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} (pool {PD}): the kernel takes "
                         f"{HEAD_DIMS}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"q dtype {q.dtype}: float32 or bfloat16")
    if k_pool.dtype == torch.int8:
        if k_scale is None:
            raise ValueError("an int8 pool needs k_scale and v_scale")
        for s in (k_scale, v_scale):
            if s.dtype != torch.float32 or tuple(s.shape) != (NB, BS, KV):
                raise ValueError(f"scales must be float32 [NB,BS,KV], got "
                                 f"{s.dtype} {tuple(s.shape)}")
    elif k_pool.dtype != q.dtype or k_scale is not None:
        raise ValueError(f"pool dtype {k_pool.dtype} with q {q.dtype}: the "
                         f"pool has q's dtype, or int8 with scales")


def _check(q, k_pool, v_pool, block_tables, context_lens, cu_q_lens,
           k_scale, v_scale) -> None:
    check_tensors(q, k_scale, v_scale, k_pool=k_pool, v_pool=v_pool,
                  block_tables=block_tables, context_lens=context_lens,
                  cu_q_lens=cu_q_lens)
    if q.dim() != 3:
        raise ValueError(f"q must be [T,H,D], got {tuple(q.shape)}")
    check_pools(q, k_pool, v_pool, k_scale, v_scale)
    T, H, _ = q.shape
    KV = k_pool.shape[2]
    if H % KV or ROWS_PER_TILE % (H // KV):
        raise ValueError(f"H={H}, KV={KV}: the GQA group must divide "
                         f"{ROWS_PER_TILE}")
    R = block_tables.shape[0]
    for name, t, shape in (("block_tables", block_tables, None),
                           ("context_lens", context_lens, (R,)),
                           ("cu_q_lens", cu_q_lens, (R + 1,))):
        if t.dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got {t.dtype}")
        if shape is not None and tuple(t.shape) != shape:
            raise ValueError(f"{name} shape {tuple(t.shape)} != {shape}")
    if block_tables.dim() != 2 or R < 1 or T < 1:
        raise ValueError("block_tables must be [R>=1, MB] and T >= 1")


def ragged_paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, block_tables: torch.Tensor,
                           context_lens: torch.Tensor,
                           cu_q_lens: torch.Tensor,
                           scale: Optional[float] = None,
                           k_scale: Optional[torch.Tensor] = None,
                           v_scale: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """q ``[T, H, D]`` packed over rows; pools ``[NB, BS, KV, D]``
    (q's dtype, or int8 with float32 ``k_scale``/``v_scale``
    ``[NB, BS, KV]``); block_tables ``[R, MB]`` int32; context_lens
    ``[R]`` visible tokens per row after this step's write; cu_q_lens
    ``[R+1]``. Returns ``[T, H, D]`` in q's dtype; tokens past
    ``cu_q_lens[R]`` are zeros.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernels (split pass, merge, tile pass) or raises."""
    if q.device.type == "cpu":
        return ragged_paged_attention_plain(
            q, k_pool, v_pool, block_tables, context_lens, cu_q_lens,
            scale, k_scale, v_scale)
    if q.device.type != "cuda":
        raise ValueError(f"ragged_paged_attention: no kernel for {q.device}")
    _check(q, k_pool, v_pool, block_tables, context_lens, cu_q_lens,
           k_scale, v_scale)
    T, H, D = q.shape
    NB, BS, KV, _ = k_pool.shape
    R, MB = block_tables.shape
    if scale is None:
        scale = D ** -0.5
    geo = launch_geometry(T, H, KV, R, MB, BS,
                          _paged().sm_count(q.device))
    nt, extra, splits = geo["tiles"], geo["extra"], geo["splits"]
    lib = _build.load("ragged_paged_attention", _bind)
    out = torch.empty_like(q)
    part = torch.empty((R * H * splits + (nt + extra) * KV * TILE_POSITIONS)
                       * (D + 4) + 4 * (nt + 1), dtype=torch.float32,
                       device=q.device)
    codes = _build.DTYPE_CODES
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.ptt_ragged_paged_attention(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            k_scale.data_ptr() if k_scale is not None else None,
            v_scale.data_ptr() if v_scale is not None else None,
            block_tables.data_ptr(), context_lens.data_ptr(),
            cu_q_lens.data_ptr(), part.data_ptr(), out.data_ptr(),
            T, H, KV, D, NB, BS, R, MB, nt, geo["tq"], extra, MIN_PIECE,
            geo["sp"],
            splits, geo["gt"], float(scale), codes[_dtype_name(q)],
            codes[_dtype_name(k_pool)], stream)
    if rc != 0:
        raise RuntimeError(f"ragged_paged_attention kernel launch failed: "
                           f"cudaError {rc}")
    launches.add()
    return out


def kv_bytes_read(context_lens, cu_q_lens, block_size: int, num_kv_heads: int,
                  head_dim: int, kv_itemsize: int, quantized: bool) -> int:
    """Pool bytes one call must read at least: each row with query tokens
    reads K and V for its ``context_len`` positions (plus the float32
    scales of an int8 pool). The bytes side of the kernel's bound."""
    ctx = [int(x) for x in context_lens.tolist()]
    cu = [int(x) for x in cu_q_lens.tolist()]
    per_pos = num_kv_heads * (head_dim * kv_itemsize + (4 if quantized
                                                        else 0))
    return sum(2 * per_pos * c for r, c in enumerate(ctx)
               if cu[r + 1] > cu[r] and c > 0)


def attention_flops(context_lens, cu_q_lens, num_heads: int,
                    head_dim: int) -> int:
    """Multiply-adds x2 of QK^T and PV over the positions each query token
    sees (its causal prefix). The operations side of the bound."""
    ctx = [int(x) for x in context_lens.tolist()]
    cu = [int(x) for x in cu_q_lens.tolist()]
    total = 0
    for r, c in enumerate(ctx):
        ql = cu[r + 1] - cu[r]
        if ql <= 0:
            continue
        # token i sees c - ql + i + 1 positions
        seen = ql * (c - ql + 1) + ql * (ql - 1) // 2
        total += 4 * num_heads * head_dim * max(seen, 0)
    return total


__all__ = ["ragged_paged_attention", "ragged_paged_attention_plain",
           "ragged_paged_attention_split_plain", "launches", "tile_tokens",
           "num_tiles", "extra_items", "launch_geometry", "tile_schedule",
           "call_schedule", "tile_end", "kv_bytes_read", "attention_flops",
           "check_tensors", "check_pools"]
