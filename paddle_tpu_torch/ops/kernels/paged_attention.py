"""Gang-decode paged attention: one query token per batch row over the
paged KV pool.

Replaces ``paddle_tpu/ops/kernels/pallas/paged_attention.py``
(``paged_attention``, :76), the decode attention of
``generate(cache_type="paged")``. Blocks at or past ``context_len`` are
skipped; a row with ``context_len`` 0 returns zeros.

What bounds it on the H100: the KV bytes it reads, each row's context
once per layer at 3.35 TB/s, with about one multiply-add per byte. The
kernel (``csrc/paged_attention.cu``) gives each (batch row, kv head) one
block, which reads each of the row's pool blocks once and serves all G
query heads of the group from shared memory. It shares its tile code with
the ragged kernel; like it, this first version computes in float32 on the
CUDA cores with synchronous loads. An int8 pool comes with float32 scale
pools ``[NB, BS, KV]`` and is dequantized in shared memory after the
int8 bytes arrive, as in the ragged kernel. (The reference sends an int8
gang decode to an XLA composite, recording ``kv_int8_gang_pallas``; here a
CUDA tensor launches the kernel for every pool dtype.)
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build
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


def _bind(lib) -> None:
    fn = lib.ptt_paged_attention
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
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
    lib = _build.load("paged_attention", _bind)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.ptt_paged_attention(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            k_scale.data_ptr() if k_scale is not None else None,
            v_scale.data_ptr() if v_scale is not None else None,
            block_tables.data_ptr(), context_lens.data_ptr(), out.data_ptr(),
            B, H, KV, D, NB, BS, MB, float(scale),
            _build.DTYPE_CODES[_dtype_name(q)],
            _build.DTYPE_CODES[_dtype_name(k_pool)], stream)
    if rc != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: "
                           f"cudaError {rc}")
    launches.add()
    return out
