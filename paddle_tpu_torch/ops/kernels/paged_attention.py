"""Gang-decode paged attention: one query token per batch row over the
paged KV pool.

Replaces ``paddle_tpu/ops/kernels/pallas/paged_attention.py``
(``paged_attention``, :76), the decode attention of
``generate(cache_type="paged")``. Blocks at or past ``context_len`` are
skipped; a row with ``context_len`` 0 returns zeros.

What bounds it on the H100: the KV bytes it reads, each row's context
once per layer at 3.35 TB/s, with about one multiply-add per byte. The
kernel (``csrc/paged_attention.cu``; its bodies are in
``csrc/paged_split.cuh``, shared with the ragged kernel's decode rows) is
a split-KV pass and a merge: the split pass gives each (kv head, row,
split) one block, which streams
``SP`` positions of the row's context (whole pool blocks) through a
``cp.async`` ring in the pool's own dtype, serves all G query heads of
the group with every warp busy, and writes a float32 partial (m, l,
acc); the merge combines a row's partials in split order and rounds once
to q's dtype. ``split_plan`` picks ``SP`` and the split count from what
the host knows (MB, BS, B, KV and the card's SM count), never from
``context_lens``, so a call never waits for the card. An int8 pool comes
with float32 scale pools ``[NB, BS, KV]`` and is widened in registers
after the int8 bytes arrive. (The reference sends an int8 gang decode to
an XLA composite, recording ``kv_int8_gang_pallas``; here a CUDA tensor
launches the kernel for every pool dtype.)

Beside the kernel: ``paged_attention_plain``, the same function in plain
PyTorch, used for CPU tensors, by the tests and by ``chip_smoke.py``;
``paged_attention_split_plain``, a plain mirror of the split pass and the
merge (tests and ``chip_smoke.py`` only); and ``launches``, the count of
kernel calls (one per call: the split pass and its merge).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

from . import _build
from ._build import sm_count
from .ragged_paged_attention import (ROWS_PER_TILE, _dtype_name,
                                     check_pools, check_tensors,
                                     ragged_paged_attention_plain)

launches = _build.LaunchCounter("paged_attention")


def paged_attention_plain(q, k_pool, v_pool, block_tables, context_lens,
                          scale=None, k_scale=None, v_scale=None):
    """Plain PyTorch version: each batch row is a ragged row of one token
    at position ``context_len - 1``. Takes an int8 pool with scales too."""
    B = q.shape[0]
    cu = torch.arange(B + 1, dtype=torch.int32, device=q.device)
    out = ragged_paged_attention_plain(
        q[:, 0], k_pool, v_pool, block_tables, context_lens, cu, scale,
        k_scale, v_scale)
    return out[:, None]


SPLIT_CHUNK = 64        # csrc kDecChunk: positions of one ring stage
SPLIT_TABLE_CAP = 512   # csrc kTableCap: block-table ids of one split
SPLIT_BLOCKS_PER_SM = 16
MAX_SPLITS = 64
_LOG2E = 1.4426950408889634


@functools.lru_cache(maxsize=256)
def split_plan(mb: int, bs: int, batch: int, kv_groups: int, sms: int
               ) -> Tuple[int, int]:
    """``(sp, splits)``: positions per split and the split count for a
    block table of ``mb`` blocks of ``bs`` positions, ``batch`` rows and
    ``kv_groups`` blocks per (row, split) on a card of ``sms`` SMs. About
    ``SPLIT_BLOCKS_PER_SM`` blocks an SM when every row is full (a short
    row's later splits exit at once); ``sp`` is a multiple of ``bs`` and
    of the 64-position chunk, holds at most ``SPLIT_TABLE_CAP`` pool
    blocks, and ``splits * sp`` covers ``mb * bs``."""
    def cdiv(a, b):
        return -(-a // b)

    unit = math.lcm(SPLIT_CHUNK, bs)
    total = mb * bs
    if total <= 0:
        return unit, 1
    want = cdiv(SPLIT_BLOCKS_PER_SM * sms, max(1, batch * kv_groups))
    splits = max(1, min(want, MAX_SPLITS, cdiv(total, unit)))
    while True:
        sp = cdiv(cdiv(total, splits), unit) * unit
        if sp // bs <= SPLIT_TABLE_CAP:
            return sp, cdiv(total, sp)
        splits += 1


def head_tile(group: int) -> int:
    """Query heads one split block serves (the kernel's ``GT``, passed to
    the C entry): 4 for GQA groups of at most 4, else 8."""
    return 4 if group <= 4 else 8


def call_plan(q: torch.Tensor, k_pool: torch.Tensor,
              block_tables: torch.Tensor) -> Tuple[int, int]:
    """The ``(sp, splits)`` a call over these tensors launches with: the
    gang decode's (q ``[B, 1, H, D]``) and the ragged kernel's decode rows
    (q ``[T, H, D]``), one split block per (row of ``block_tables``, kv
    head x head group, split)."""
    H = q.shape[-2]
    _, BS, KV, _ = k_pool.shape
    G = H // KV
    rows, mb = block_tables.shape
    return split_plan(mb, BS, rows, KV * -(-G // head_tile(G)),
                      sm_count(q.device))


def paged_attention_split_plain(q, k_pool, v_pool, block_tables,
                                context_lens, scale=None, k_scale=None,
                                v_scale=None, sp: int = SPLIT_CHUNK):
    """Plain mirror of the kernel's arithmetic: each row's positions in
    splits of ``sp``, each split's (m, l, acc) in float32 with base-2
    exponents (``log2(e)`` folded into the scale), merged in split order.
    Same arguments and result as :func:`paged_attention_plain`."""
    B, _, H, D = q.shape
    NB, BS, KV, _ = k_pool.shape
    MB = block_tables.shape[1]
    G = H // KV
    if scale is None:
        scale = D ** -0.5
    scale2 = scale * _LOG2E
    out = torch.zeros((B, 1, H, D), dtype=torch.float32, device=q.device)
    tbl = block_tables.long().clamp(0, NB - 1)
    for b, ctx in enumerate(context_lens.tolist()):
        L = min(ctx, MB * BS)
        if L <= 0:
            continue
        nblk = -(-L // BS)
        blocks = tbl[b, :nblk]
        k = k_pool[blocks].float()
        v = v_pool[blocks].float()
        ks = vs = None
        if k_scale is not None:
            ks = k_scale[blocks].float().reshape(nblk * BS, KV)[:L]
            vs = v_scale[blocks].float().reshape(nblk * BS, KV)[:L]
        k = k.reshape(nblk * BS, KV, D)[:L]
        v = v.reshape(nblk * BS, KV, D)[:L]
        qb = q[b, 0].float().reshape(KV, G, D)
        parts = []
        for s0 in range(0, L, sp):
            kk, vv = k[s0:s0 + sp], v[s0:s0 + sp]
            s = torch.einsum("kgd,lkd->kgl", qb, kk) * scale2
            p_v = None
            if ks is not None:
                s = s * ks[s0:s0 + sp].t()[:, None, :]
                p_v = vs[s0:s0 + sp].t()[:, None, :]
            m = s.amax(dim=-1)                                  # [KV, G]
            p = torch.exp2(s - m[..., None])
            l = p.sum(dim=-1)
            if p_v is not None:
                p = p * p_v
            parts.append((m, l, torch.einsum("kgl,lkd->kgd", p, vv)))
        mx = torch.stack([m for m, _, _ in parts]).amax(dim=0)
        lsum = torch.zeros_like(mx)
        acc = torch.zeros((KV, G, D), dtype=torch.float32, device=q.device)
        for m, l, a in parts:
            f = torch.exp2(m - mx)
            lsum = lsum + f * l
            acc = acc + f[..., None] * a
        out[b, 0] = (acc / lsum[..., None]).reshape(H, D)
    return out.to(q.dtype)


def _bind(lib) -> None:
    fn = lib.ptt_paged_attention
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 10
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int


def _check(q, k_pool, v_pool, block_tables, context_lens, k_scale,
           v_scale) -> None:
    check_tensors(q, k_scale, v_scale, k_pool=k_pool, v_pool=v_pool,
                  block_tables=block_tables, context_lens=context_lens)
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"q must be [B,1,H,D], got {tuple(q.shape)}")
    check_pools(q, k_pool, v_pool, k_scale, v_scale)
    B, _, H, _ = q.shape
    KV = k_pool.shape[2]
    if H % KV or H // KV > ROWS_PER_TILE:
        raise ValueError(f"H={H}, KV={KV}: the GQA group must divide H and "
                         f"be at most {ROWS_PER_TILE}")
    if block_tables.dtype != torch.int32 or block_tables.dim() != 2 \
            or block_tables.shape[0] != B:
        raise ValueError("block_tables must be int32 [B, MB]")
    if context_lens.dtype != torch.int32 or tuple(context_lens.shape) != (B,):
        raise ValueError("context_lens must be int32 [B]")


def paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                    v_pool: torch.Tensor, block_tables: torch.Tensor,
                    context_lens: torch.Tensor,
                    scale: Optional[float] = None,
                    k_scale: Optional[torch.Tensor] = None,
                    v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q ``[B, 1, H, D]``; pools ``[NB, BS, KV, D]`` (q's dtype, or int8
    with float32 ``k_scale``/``v_scale`` ``[NB, BS, KV]``); block_tables
    ``[B, MB]`` int32; context_lens ``[B]`` int32. Returns
    ``[B, 1, H, D]``.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel or raises."""
    if q.device.type == "cpu":
        return paged_attention_plain(q, k_pool, v_pool, block_tables,
                                     context_lens, scale, k_scale, v_scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: no kernel for {q.device}")
    _check(q, k_pool, v_pool, block_tables, context_lens, k_scale, v_scale)
    B, _, H, D = q.shape
    NB, BS, KV, _ = k_pool.shape
    MB = block_tables.shape[1]
    if scale is None:
        scale = D ** -0.5
    sp, splits = call_plan(q, k_pool, block_tables)
    lib = _build.load("paged_attention", _bind)
    out = torch.empty_like(q)
    part = torch.empty(B * H * splits * (D + 4), dtype=torch.float32,
                       device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.ptt_paged_attention(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            k_scale.data_ptr() if k_scale is not None else None,
            v_scale.data_ptr() if v_scale is not None else None,
            block_tables.data_ptr(), context_lens.data_ptr(),
            part.data_ptr(), out.data_ptr(), B, H, KV, D, NB, BS, MB, sp,
            splits, head_tile(H // KV), float(scale), _build.DTYPE_CODES[_dtype_name(q)],
            _build.DTYPE_CODES[_dtype_name(k_pool)], stream)
    if rc != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: "
                           f"cudaError {rc}")
    launches.add()
    return out
