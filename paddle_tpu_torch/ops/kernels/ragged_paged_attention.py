"""Ragged paged attention: one kernel for mixed prefill + decode.

Replaces ``paddle_tpu/ops/kernels/pallas/ragged_paged_attention.py``
(``ragged_paged_attention``, :115). Every row of a serving step
contributes ``q_len`` query tokens (1 for a decode row, the chunk size for
a prefill chunk, 1+K for a speculative verify row) and attends causally
against its own block-table slice of the shared pool.

Layout: packed ``q[T, H, D]`` segmented by ``cu_q_lens[R+1]``; row r's
token i sits at position ``context_lens[r] - q_len_r + i`` (the chunk is
already written: write-then-attend).

What bounds it on the H100: the KV bytes it reads. A decode step reads
every live row's whole context once per layer (about 1 MB per 1000
tokens of context per layer at Llama-3-8B widths in bf16, half that in
int8), at 3.35 TB/s; the attention arithmetic per KV byte is low. The
kernel (``csrc/ragged_paged_attention.cu``) reads each pool block of a
(q tile, kv head) once and serves all of the tile's query rows and GQA
heads from shared memory, dequantizes int8 blocks after they arrive, and
skips every block past the tile's causal horizon. This first version does
its arithmetic in float32 on the CUDA cores and loads synchronously; a
decode row fills only G of a tile's 64 rows. Tensor cores (``wgmma``), TMA
and a pipelined load are later work.

Beside the kernel: ``ragged_paged_attention_plain``, the same function in
plain PyTorch, row by row (each row gathers its ``ceil(ctx/BS)`` blocks
once), used for CPU tensors, by the tests and by ``chip_smoke.py``; and
``launches``, the count of kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build

launches = _build.LaunchCounter("ragged_paged_attention")

ROWS_PER_TILE = 64    # csrc kRows: query rows (tokens x GQA group) of a tile
HEAD_DIMS = (64, 128)
_NEG = -1e30


def tile_tokens(num_heads: int, num_kv_heads: int) -> int:
    """Query tokens per tile: the tile's 64 rows hold TQ tokens of G
    heads each."""
    return ROWS_PER_TILE // (num_heads // num_kv_heads)


def num_tiles(T: int, R: int, tq: int) -> int:
    """Static tile-count bound ``R + ceil(T/TQ)``: each row wastes at most
    one partial tile, so one grid serves every mix of a token budget."""
    return R + -(-T // tq)


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


def _bind(lib) -> None:
    fn = lib.ptt_ragged_paged_attention
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 10
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
    kernel or raises."""
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
    tq = tile_tokens(H, KV)
    if scale is None:
        scale = D ** -0.5
    lib = _build.load("ragged_paged_attention", _bind)
    out = torch.empty_like(q)
    codes = _build.DTYPE_CODES
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.ptt_ragged_paged_attention(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            k_scale.data_ptr() if k_scale is not None else None,
            v_scale.data_ptr() if v_scale is not None else None,
            block_tables.data_ptr(), context_lens.data_ptr(),
            cu_q_lens.data_ptr(), out.data_ptr(),
            T, H, KV, D, NB, BS, R, MB, num_tiles(T, R, tq), tq,
            float(scale), codes[_dtype_name(q)], codes[_dtype_name(k_pool)],
            stream)
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
           "launches", "tile_tokens", "num_tiles", "kv_bytes_read",
           "attention_flops", "check_tensors", "check_pools"]
