"""Serving-path ops: paged KV-cache writes, attention routing, sampling.

Counterparts in ``paddle_tpu/ops/kernels/serving.py``:
``paged_cache_write`` (:102), ``paged_cache_write_q`` (:116),
``_ragged_composite``/``ragged_paged_attention`` (:200, :236),
``_filter_logits`` (:278), ``sample_logits`` (:296),
``sample_logits_keyed`` (:309).

The pool writes update the pool IN PLACE (``index_copy_``) where the JAX
package, whose arrays are immutable, rebuilt the pool; they return the
pool all the same so callers read like the reference.

Attention routing: a CUDA tensor goes to the kernel, a CPU tensor to its
plain version (decided inside each kernel's wrapper). There is no tensor
parallel branch in the port yet.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..dispatcher import register_kernel
from . import paged_attention as _pa
from . import ragged_paged_attention as _rpa
from .quant_common import INT8_BOUND, absmax_scale, quantize_symmetric


def paged_cache_write(pool: torch.Tensor, new: torch.Tensor,
                      slot_ids: torch.Tensor) -> torch.Tensor:
    """pool ``[NB, BS, ...]``; new ``[B, S, ...]``; slot_ids ``[B*S]``
    (flat ``block*BS + offset`` per token, row-major over (B, S)) ->
    pool, with every token written into its slot in place."""
    nb, bs = pool.shape[0], pool.shape[1]
    flat = pool.view(nb * bs, *pool.shape[2:])
    ids = slot_ids.reshape(-1).long()
    flat.index_copy_(0, ids, new.reshape(ids.numel(), *pool.shape[2:])
                     .to(pool.dtype))
    return pool


def paged_cache_write_q(pool: torch.Tensor, scale_pool: torch.Tensor,
                        new: torch.Tensor, slot_ids: torch.Tensor):
    """Quantize-on-append write: pool ``[NB, BS, KV, D]`` int8,
    scale_pool ``[NB, BS, KV]`` float32, new ``[B, S, KV, D]``.

    Each token's scale is the absmax of its own ``[D]`` vector per kv
    head, so quantization is a pure function of the token's values: every
    chunking schedule writes the same pool bytes. Returns
    ``(pool, scale_pool)``, both written in place."""
    flat_new = new.reshape(-1, *new.shape[2:]).float()
    scales = absmax_scale(flat_new, axis=-1)                   # [B*S, KV]
    q = quantize_symmetric(flat_new, scales[..., None], INT8_BOUND)
    paged_cache_write(pool, q, slot_ids)
    paged_cache_write(scale_pool, scales, slot_ids)
    return pool, scale_pool


@register_kernel("ragged_paged_attention")
def ragged_paged_attention(q, k_pool, v_pool, block_tables, context_lens,
                           cu_q_lens, k_scale=None, v_scale=None,
                           scale=None):
    """ONE call for a ragged mix of prefill chunks and decode rows over
    the paged pool. Arguments as the reference op; the kernel module's
    wrapper routes by device."""
    return _rpa.ragged_paged_attention(
        q, k_pool, v_pool, block_tables, context_lens, cu_q_lens, scale,
        k_scale=k_scale, v_scale=v_scale)


@register_kernel("paged_attention")
def paged_attention(q, k_pool, v_pool, block_tables, context_lens,
                    k_scale=None, v_scale=None, scale=None):
    """Decode attention over the paged pool, q ``[B, 1, H, D]``, over a
    pool in q's dtype or an int8 pool with its scales. The kernel module's
    wrapper routes by device."""
    return _pa.paged_attention(q, k_pool, v_pool, block_tables,
                               context_lens, scale, k_scale=k_scale,
                               v_scale=v_scale)


def _filter_logits(logits: torch.Tensor, temperature: float, top_k: int,
                   top_p: float) -> torch.Tensor:
    """Temperature/top-k/top-p filtering shared by both sampling heads."""
    logits = logits.float() / max(temperature, 1e-6)
    V = logits.shape[-1]
    if top_k and top_k < V:
        kth = torch.sort(logits, dim=-1).values[:, -top_k][:, None]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    if top_p < 1.0:
        sorted_l = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_l, dim=-1), dim=-1)
        # smallest set with cumulative prob >= top_p (keep at least 1)
        cutoff_idx = (cum < top_p).sum(dim=-1)
        cutoff = torch.gather(sorted_l, -1, cutoff_idx[:, None])
        logits = logits.masked_fill(logits < cutoff, float("-inf"))
    return logits


def sample_logits(logits: torch.Tensor, temperature: float = 1.0,
                  top_k: int = 0, top_p: float = 1.0,
                  generator: Optional[torch.Generator] = None
                  ) -> torch.Tensor:
    """logits ``[B, V]`` -> ``[B]`` int32: argmax at temperature 0, else a
    filtered categorical draw from ``generator``."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    probs = torch.softmax(_filter_logits(logits, temperature, top_k, top_p),
                          dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
        torch.int32)


# -- counter-based streams for the serving engine ---------------------------
# The reference keys each request's draws with threefry (engine seed folded
# with the request id, then the token index). The port cannot reproduce
# threefry's bits; it keeps the property that matters: a draw is a pure
# function of (engine seed, rid, token index) and never of the row a
# request happens to occupy. Held to the reference at temperature 0 only.

_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for int64 ``x`` in [0, 2**32), without overflow."""
    lo, hi = x & 0xFFFF, x >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & _M32


def _fmix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3's 32-bit finalizer on int64 tensors holding uint32 values."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def request_key(seed: int, rid: int) -> tuple:
    """Two uint32 words of request ``rid``'s private stream under engine
    ``seed`` (host side)."""
    s = torch.tensor([seed & _M32, (seed >> 32) & _M32, rid & _M32],
                     dtype=torch.int64)
    a = _fmix32(s[0] ^ _fmix32((s[2] + 0x9E3779B9) & _M32))
    b = _fmix32(s[1] ^ _fmix32(a ^ 0x7F4A7C15))
    return int(a), int(b)


def _gumbel(keys: torch.Tensor, stream_pos: torch.Tensor,
            V: int) -> torch.Tensor:
    """Gumbel noise ``[B, V]``: element (r, v) is a hash of (keys[r],
    stream_pos[r], v)."""
    k0, k1 = keys[:, 0:1].long(), keys[:, 1:2].long()
    x = _fmix32(k0 ^ _mul32(stream_pos.long()[:, None] & _M32, 0x9E3779B1))
    x = _fmix32(x ^ k1)
    vocab = torch.arange(V, device=keys.device, dtype=torch.int64)[None, :]
    x = _fmix32(x ^ _mul32(vocab, 0x85EBCA77))
    u = ((x >> 8).double() + 0.5) / float(1 << 24)             # (0, 1)
    return (-torch.log(-torch.log(u))).float()


def sample_logits_keyed(logits: torch.Tensor, keys: torch.Tensor,
                        stream_pos: torch.Tensor, temperature: float = 1.0,
                        top_k: int = 0, top_p: float = 1.0) -> torch.Tensor:
    """Per-row keyed sampling for the serving engine: logits ``[B, V]``,
    keys ``[B, 2]`` (each row's private stream, from
    :func:`request_key`), stream_pos ``[B]`` (the row's token index) ->
    ``[B]`` int32. Argmax at temperature 0; otherwise a Gumbel-max draw
    whose noise is a pure function of (key, token index)."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    filt = _filter_logits(logits, temperature, top_k, top_p)
    g = _gumbel(keys, stream_pos, filt.shape[-1])
    return torch.argmax(filt + g, dim=-1).to(torch.int32)
