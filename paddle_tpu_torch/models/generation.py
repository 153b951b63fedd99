"""KV caches (contiguous and paged) and the ``generate()`` loop.

Counterpart of ``paddle_tpu/models/generation.py``: ``KVCache`` (:25),
``kv_pool_blocks`` (:49), ``PagedKVCache`` (:71) and
``GenerationMixin.generate`` (:306), whose default cache is the
contiguous one, as in the reference.

``KVCache`` holds ``[B, max_len, KV, head_dim]`` per layer; its writes
and its attention are the registry's ``cache_write`` and
``cache_attention`` (the composite attention over the whole cache, with
the caller's ``attn_mask``). ``PagedKVCache`` is a host-side block
allocator over device block pools ``[num_blocks, block_size, KV,
head_dim]`` per layer; sequences share it and blocks are recycled on
release. Writes update the caches in place.

One difference from the reference: the reference's paged prefill attends
with dense causal attention over the prompt it stashed; here an unmasked
paged prefill attends through the pool with the ragged kernel (each
batch row a ragged row of ``s`` tokens), so the port calls no library
attention. A masked paged prefill takes the composite over the stashed
prompt, as the reference's does (:280-290); a masked paged decode raises
as the reference's does (:291-296).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from .. import flags as _flags
from ..core.device import dtype_of, resolve_device
from ..ops.kernels import nn as K
from ..ops.kernels import serving as S

_STORE = {"bf16": "bfloat16", "bfloat16": "bfloat16", "int8": "int8"}


def _store_dtype(kv_dtype: Optional[str], dtype: str) -> str:
    if kv_dtype in (None, "", "auto"):
        return dtype
    if kv_dtype not in _STORE:
        raise ValueError(
            f"unsupported kv_dtype {kv_dtype!r}: expected 'auto', 'bf16' "
            f"or 'int8' (FLAGS_kv_cache_dtype)")
    return _STORE[kv_dtype]


class KVCache:
    """Contiguous per-layer cache ``[B, max_len, KV, head_dim]`` on
    ``device`` (None: the CUDA card, raising when there is none)."""

    def __init__(self, num_layers: int, batch: int, max_len: int,
                 num_kv_heads: int, head_dim: int, dtype="float32",
                 device=None):
        self.max_len = max_len
        self.device = resolve_device(device)
        shape = (batch, max_len, num_kv_heads, head_dim)
        tdt = dtype_of(dtype)
        self.k = [torch.zeros(shape, dtype=tdt, device=self.device)
                  for _ in range(num_layers)]
        self.v = [torch.zeros(shape, dtype=tdt, device=self.device)
                  for _ in range(num_layers)]

    def nbytes(self) -> int:
        """Device bytes of the K and V caches of every layer."""
        return sum(t.numel() * t.element_size() for t in self.k + self.v)

    def update(self, layer: int, k_new: torch.Tensor, v_new: torch.Tensor,
               pos):
        """Write k/v at ``[:, pos:pos+S]``; returns the full caches."""
        S.cache_write(self.k[layer], k_new, pos)
        S.cache_write(self.v[layer], v_new, pos)
        return self.k[layer], self.v[layer]

    def attend(self, layer: int, q: torch.Tensor, pos,
               attn_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        return S.cache_attention(q, self.k[layer], self.v[layer], pos,
                                 attn_mask)


def kv_pool_blocks(kv_pool_bytes: int, block_size: int, num_kv_heads: int,
                   head_dim: int, num_layers: int, dtype="float32",
                   kv_dtype: str = "auto") -> int:
    """Blocks a fixed device-memory byte budget buys at a storage regime:
    int8 nearly doubles the block count for the same bytes, its float32
    scale rows included in the denominator."""
    store = _store_dtype(kv_dtype, dtype)
    itemsize = torch.empty((), dtype=dtype_of(store)).element_size()
    per_tok = 2 * num_kv_heads * head_dim * itemsize
    if store == "int8":
        per_tok += 2 * num_kv_heads * 4       # f32 scale per token slot
    return max(1, int(kv_pool_bytes) // (per_tok * num_layers * block_size))


class PagedKVCache:
    """Block-pool cache with per-sequence block tables.

    Pools ``[num_blocks, block_size, KV, head_dim]`` per layer, on
    ``device`` (None: the CUDA card, raising when there is none).
    ``kv_dtype`` "auto" stores at the compute dtype, "bf16" in
    bfloat16, "int8" quantizes on append with per-token-slot, per-kv-head
    float32 scales ``[NB, BS, KV]`` riding the block table."""

    def __init__(self, num_layers: int, batch: int, num_blocks: int,
                 block_size: int, num_kv_heads: int, head_dim: int,
                 max_blocks_per_seq: int, dtype="float32",
                 kv_dtype: str = "auto", device=None):
        self.block_size = block_size
        self.num_layers = num_layers
        self.device = resolve_device(device)
        store = _store_dtype(kv_dtype, dtype)
        self.quantized = store == "int8"
        self.kv_dtype = store
        shape = (num_blocks, block_size, num_kv_heads, head_dim)
        tdt = dtype_of(store)
        self.k = [torch.zeros(shape, dtype=tdt, device=self.device)
                  for _ in range(num_layers)]
        self.v = [torch.zeros(shape, dtype=tdt, device=self.device)
                  for _ in range(num_layers)]
        if self.quantized:
            sshape = shape[:3]
            self.k_scale = [torch.zeros(sshape, dtype=torch.float32,
                                        device=self.device)
                            for _ in range(num_layers)]
            self.v_scale = [torch.zeros(sshape, dtype=torch.float32,
                                        device=self.device)
                            for _ in range(num_layers)]
        else:
            self.k_scale = self.v_scale = None
        self._free = list(range(num_blocks - 1, -1, -1))
        self.block_tables = np.zeros((batch, max_blocks_per_seq), np.int32)
        self.context_lens = np.zeros((batch,), np.int32)
        # blocks handed to each sequence so far (all layers share a table)
        self._allocated = np.zeros((batch,), np.int32)
        self._slots: Optional[torch.Tensor] = None   # this forward's slots
        self._dev_meta = None                        # its tables/lens/cu
        # (layer, k, v) of the prefill layer just written: only the masked
        # prefill's attend reads it, and attend drops it
        self._last_kv: Optional[tuple] = None
        # the gang engine's hook: when set, s == 1 updates write to these
        # per-row slots and leave the allocator and the lengths to the
        # engine, which owns both
        self._decode_override: Optional[torch.Tensor] = None

    def set_decode_override(self, slots: Optional[torch.Tensor]) -> None:
        self._decode_override = slots

    def write(self, layer: int, k_new: torch.Tensor, v_new: torch.Tensor,
              slots: torch.Tensor):
        """THE pool write: int8 quantize-on-append or the plain write."""
        if self.quantized:
            S.paged_cache_write_q(self.k[layer], self.k_scale[layer], k_new,
                                  slots)
            S.paged_cache_write_q(self.v[layer], self.v_scale[layer], v_new,
                                  slots)
        else:
            S.paged_cache_write(self.k[layer], k_new, slots)
            S.paged_cache_write(self.v[layer], v_new, slots)
        return self.k[layer], self.v[layer]

    def scale_kwargs(self, layer: int) -> dict:
        """Dequant-scale kwargs for the attention ops (empty unless int8)."""
        if not self.quantized:
            return {}
        return dict(k_scale=self.k_scale[layer], v_scale=self.v_scale[layer])

    def kv_bytes_per_token(self) -> int:
        """Device bytes one token's K and V take across all layers, the
        int8 pool's float32 scales included (the
        ``serving.kv.bytes_per_token`` gauge)."""
        kv, d = self.k[0].shape[2], self.k[0].shape[3]
        per = 2 * kv * d * self.k[0].element_size()
        if self.quantized:
            per += 2 * kv * 4                     # [NB, BS, KV] f32 x2
        return per * self.num_layers

    # -- host-side allocator -------------------------------------------------
    def alloc_slots(self, seq: int, pos0: int, n: int,
                    alloc_block: Optional[Callable[[], int]] = None
                    ) -> np.ndarray:
        """Flat write slots for ``n`` tokens at ``pos0..pos0+n-1``,
        allocating new blocks as needed (``alloc_block`` overrides the
        free-list pop: the serving engine's prefix-cache-aware
        allocator)."""
        if n <= 0:
            return np.empty((0,), np.int64)
        blk_hi = (pos0 + n - 1) // self.block_size
        if blk_hi >= self.block_tables.shape[1]:
            raise RuntimeError(
                f"PagedKVCache: position {pos0 + n - 1} needs block "
                f"{blk_hi} but max_blocks_per_seq="
                f"{self.block_tables.shape[1]}")
        while self._allocated[seq] <= blk_hi:
            if alloc_block is not None:
                blk = alloc_block()
            elif self._free:
                blk = self._free.pop()
            else:
                raise RuntimeError("PagedKVCache: block pool exhausted")
            self.block_tables[seq, self._allocated[seq]] = blk
            self._allocated[seq] += 1
        pos = pos0 + np.arange(n)
        return (self.block_tables[seq, pos // self.block_size]
                .astype(np.int64) * self.block_size
                + pos % self.block_size)

    def _ensure_block(self, seq: int, pos: int) -> int:
        """The pool block holding ``pos`` of ``seq``, allocated if new."""
        self.alloc_slots(seq, pos, 1)
        return int(self.block_tables[seq, pos // self.block_size])

    def release(self, seq: int):
        used = int(self._allocated[seq])
        self._free.extend(int(b) for b in self.block_tables[seq, :used])
        self.block_tables[seq, :] = 0
        self.context_lens[seq] = 0
        self._allocated[seq] = 0

    def write_token(self, layer: int, seq_positions: np.ndarray,
                    k_new: torch.Tensor, v_new: torch.Tensor) -> None:
        """Write one token per sequence at its current position (the
        reference's :225); lengths advance at the first layer's write, so
        every layer's attend sees the token."""
        slots = np.concatenate([self.alloc_slots(b, int(p), 1)
                                for b, p in enumerate(seq_positions)])
        self.write(layer, k_new, v_new,
                   torch.from_numpy(slots).to(self.device))
        if layer == 0:
            for b, p in enumerate(seq_positions):
                self.context_lens[b] = max(self.context_lens[b], int(p) + 1)

    # -- model-facing interface (generate() and the gang engine) -------------
    def update(self, layer: int, k_new: torch.Tensor, v_new: torch.Tensor,
               pos) -> None:
        """Write ``[b, s]`` new tokens at positions ``pos..pos+s-1`` of
        every sequence (with the decode override: at its slots, ``pos``
        unread). Slots and the device copies of the tables are computed
        once per forward, at layer 0."""
        b, s = k_new.shape[0], k_new.shape[1]
        if layer == 0:
            if self._decode_override is not None and s == 1:
                self._slots = self._decode_override
            else:
                p0 = int(pos)
                slots = np.stack([self.alloc_slots(seq, p0, s)
                                  for seq in range(b)])
                self._slots = torch.from_numpy(slots.reshape(-1)).to(
                    self.device)
                self.context_lens[:] = np.maximum(self.context_lens, p0 + s)
            self._dev_meta = (
                torch.from_numpy(self.block_tables).to(self.device),
                torch.from_numpy(self.context_lens.copy()).to(self.device),
                torch.arange(0, (b + 1) * s, s, dtype=torch.int32,
                             device=self.device))
        self._last_kv = (layer, k_new, v_new) if s > 1 else None
        self.write(layer, k_new, v_new, self._slots)

    def attend(self, layer: int, q: torch.Tensor, pos=None,
               attn_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Decode (``s == 1``): the gang-decode kernel (a mask raises).
        Prefill from position 0 (``s > 1``): the ragged kernel, one row
        per sequence; with ``attn_mask``, the composite attention over the
        stashed prompt K/V with the mask and the causal mask."""
        tables, lens, cu = self._dev_meta
        b, s, h, d = q.shape
        if s == 1:
            if attn_mask is not None:
                raise NotImplementedError(
                    "PagedKVCache decode attention has no attn_mask input "
                    "(context_lens bound what each sequence attends to); "
                    "left-padded batches need the contiguous KVCache")
            return S.paged_attention(q, self.k[layer], self.v[layer], tables,
                                     lens, **self.scale_kwargs(layer))
        last, self._last_kv = self._last_kv, None
        if int(pos) != 0 or last is None or last[0] != layer:
            raise NotImplementedError(
                "PagedKVCache prefill attends only the freshly written "
                "prompt (pos 0); chunked prefill runs in the serving engine")
        if attn_mask is not None:
            _, k_new, v_new = last
            return K.scaled_dot_product_attention(
                q, k_new, v_new, attn_mask=attn_mask, is_causal=True)
        out = S.ragged_paged_attention(
            q.reshape(b * s, h, d), self.k[layer], self.v[layer], tables,
            lens, cu, **self.scale_kwargs(layer))
        return out.reshape(b, s, h, d)


class GenerationMixin:
    """Decode loop. The model must accept ``forward(input_ids, cache=...,
    start_pos=...)`` and return logits."""

    @torch.no_grad()
    def generate(self, input_ids: torch.Tensor, max_new_tokens: int = 32,
                 temperature: float = 1.0, top_k: int = 0,
                 top_p: float = 1.0, eos_token_id: Optional[int] = None,
                 max_cache_len: Optional[int] = None,
                 cache_type: str = "contiguous", block_size: int = 64,
                 generator: Optional[torch.Generator] = None
                 ) -> torch.Tensor:
        """Greedy (temperature 0) or sampled decoding. ``cache_type=
        "contiguous"`` (the default) runs over the dense ``KVCache`` (the
        composite attention over the whole cache); ``"paged"`` over the
        block pool (bulk prefill through the ragged kernel, then one
        gang-decode attention per layer and token). ``input_ids`` ``[b,
        s]`` -> ``[b, s + new]`` int32 on the model's device. Sampling
        draws from ``generator`` (default: the port's generator for the
        model's device, as the reference draws from its global one)."""
        if cache_type not in ("contiguous", "paged"):
            raise ValueError(f"cache_type must be 'contiguous' or 'paged', "
                             f"got {cache_type!r}")
        cfg = self.config
        device = self.device
        input_ids = input_ids.to(device=device, dtype=torch.int32)
        b, s = input_ids.shape
        total = s + max_new_tokens
        if max_cache_len is not None and max_cache_len < total:
            raise ValueError(
                f"max_cache_len={max_cache_len} < prompt+max_new_tokens="
                f"{total}: the cache would wrap and corrupt decoding")
        if total > cfg.max_position_embeddings:
            raise ValueError(
                f"prompt+max_new_tokens={total} exceeds "
                f"max_position_embeddings={cfg.max_position_embeddings} "
                f"(rope table would clamp positions)")
        kv_dtype = _flags.get_flag("kv_cache_dtype")
        head_dim = cfg.hidden_size // cfg.num_attention_heads
        if cache_type == "paged":
            mb = -(-(max_cache_len or total) // block_size)
            cache = PagedKVCache(
                cfg.num_hidden_layers, b, num_blocks=b * mb,
                block_size=block_size, num_kv_heads=cfg.num_key_value_heads,
                head_dim=head_dim, max_blocks_per_seq=mb, dtype=cfg.dtype,
                kv_dtype=kv_dtype, device=device)
        else:
            if kv_dtype == "int8":
                S.record_fallback(
                    "kv", "kv_int8_dense_cache",
                    "contiguous KVCache has no quantized layout; "
                    "cache stays at the compute dtype")
            cache = KVCache(cfg.num_hidden_layers, b, max_cache_len or total,
                            cfg.num_key_value_heads, head_dim,
                            dtype=cfg.dtype, device=device)
        sample = dict(temperature=temperature, top_k=top_k, top_p=top_p,
                      generator=generator)
        tokens = [input_ids]
        finished = torch.zeros((b,), dtype=torch.bool, device=device)
        logits = self(input_ids, cache=cache, start_pos=0)
        next_tok = S.sample_logits(logits[:, -1, :], **sample)
        for step in range(max_new_tokens):
            if eos_token_id is not None:
                # finished rows emit eos forever (padding), never samples
                next_tok = torch.where(finished, eos_token_id, next_tok).to(
                    torch.int32)
                finished |= next_tok == eos_token_id
            tokens.append(next_tok.reshape(b, 1))
            if eos_token_id is not None and bool(finished.all()):
                break
            if step == max_new_tokens - 1:
                break
            logits = self(tokens[-1], cache=cache, start_pos=s + step)
            next_tok = S.sample_logits(logits[:, -1, :], **sample)
        return torch.cat(tokens, dim=1)
