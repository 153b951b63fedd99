"""Continuous batching over the paged KV cache: the ragged serving loop.

Counterpart of ``paddle_tpu/models/serving.py``: ``QueueFull``,
``Request``, ``PrefixCache`` (:198), ``_RaggedView`` (:298) and
``ContinuousBatchingEngine`` (:324), with the same behaviour:

- **One ragged step.** Every scheduler step packs a fixed ``token_budget``
  of tokens (one per decoding row plus fixed-size prefill chunks of the
  admitted prompts) into ONE model call over the shared pool; each layer
  makes one ``ragged_paged_attention`` call, decode rows and prefill
  chunks together.
- **Token-budget admission.** A request waits until a row slot and enough
  pool blocks for its worst case (prompt + max_new_tokens, minus the
  prefix-cached head) are free, so decode never exhausts the pool.
  Head-of-line starvation preempts the LIFO victim (recompute on resume).
- **Prefix cache.** Full prompt blocks are content-hashed (chained sha256)
  and published after being written; a later request sharing the head
  acquires them by refcount. A write into a tracked block copies it to a
  fresh block first (copy-on-write).
- **Speculative verify rows and the int8 pool**, as in the reference.
- **Schedule-independent sampling.** Each request samples through its own
  counter-based stream keyed on (engine seed, rid, token index).

- **One CUDA graph per engine geometry.** The reference packs a fixed
  ``token_budget`` "so XLA compiles the step once and every mix of
  prefill/decode replays it" (:9-15). Here the model call, the sample-row
  gather and ``sample_logits_keyed`` are captured once (the engine's
  first step: a warm-up on a side stream, then the capture) and every
  later step replays them. The graph reads static device buffers (ids,
  positions, write slots, block tables, lens, cu, sample rows, keys,
  stream positions), filled each step from ONE pinned host staging
  buffer by one copy, every element rewritten: a padding token's write
  slot is the trash slot again in each step. Host scheduling, prefix-
  cache copy-on-write and the ``nxt.cpu()`` read stay outside the graph.
  The key is the geometry (``token_budget``, ``max_batch``, the ``spec_k``
  lanes, ``kv_dtype``, the sampling settings) and the flags that route
  kernels. A replay adds the launches its capture recorded to the kernel
  counters. ``FLAGS_step_capture=0`` runs the same step eagerly (a
  deliberate difference: the reference has no eager engine step); a
  capture failure raises. On the CPU the step runs eagerly and counts as
  a replay of its first step's stand-in capture.

Metrics, tracing and the perf ledger of the reference wait for a later
slice; the engine keeps plain integer counters on itself
(``steps``, ``preempt_count``, ``stats``, ``capture_stats``).
``GangScheduledEngine`` waits too.
"""

from __future__ import annotations

import hashlib
import threading
import time
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .. import flags as _flags
from ..ops.kernels import serving as S
from .generation import PagedKVCache, kv_pool_blocks
from .speculative import NGramProposer

__all__ = ["Request", "ContinuousBatchingEngine", "PrefixCache",
           "QueueFull"]


class QueueFull(RuntimeError):
    """Admission queue is at ``max_queue``: the server must shed load
    explicitly instead of buffering without bound.

    ``retry_after_hint`` (seconds, None before any request was admitted)
    is the median observed queue wait."""

    def __init__(self, msg: str,
                 retry_after_hint: Optional[float] = None):
        super().__init__(msg)
        self.retry_after_hint = retry_after_hint


@dataclass
class Request:
    rid: int
    prompt: np.ndarray                 # [L] int32
    max_new_tokens: int
    out_tokens: List[int] = field(default_factory=list)
    slot: Optional[int] = None
    done: bool = False
    admit_order: int = -1              # LIFO preemption victim choice
    preemptions: int = 0
    # -- occupancy state (reset on preemption) -------------------------------
    ctx: int = 0                       # tokens written to the pool
    target: int = 0                    # prefill target length
    full_seq: Optional[np.ndarray] = None
    block_hashes: List[bytes] = field(default_factory=list)
    key_data: Optional[np.ndarray] = None   # private sampling stream [2]
    t_arrive: float = 0.0
    t_first: Optional[float] = None
    t_done: Optional[float] = None
    _registered_upto: int = 0          # prompt blocks published to the cache


class PrefixCache:
    """Content-addressed sharing of full prompt blocks.

    A block's key is the CHAINED hash of its tokens and every token
    before it, so equal keys imply equal KV content. Refcounts track the
    active holders; blocks whose count drops to zero stay warm in an
    evictable FIFO until `evict_one` hands them back to the allocator.
    Registration is first-writer-wins."""

    def __init__(self):
        self._map: Dict[bytes, int] = {}     # chain digest -> block id
        self._hash_of: Dict[int, bytes] = {}  # block id -> chain digest
        self._ref: Dict[int, int] = {}       # block id -> active holders
        self._evictable: "OrderedDict[int, None]" = OrderedDict()

    def __len__(self) -> int:
        return len(self._map)

    def tracked(self, block: int) -> bool:
        return block in self._ref

    def ref(self, block: int) -> int:
        return self._ref.get(block, 0)

    @property
    def evictable(self) -> int:
        return len(self._evictable)

    def lookup(self, hashes: List[bytes]) -> List[int]:
        """Longest cached prefix: block ids for the leading hashes."""
        out = []
        for h in hashes:
            b = self._map.get(h)
            if b is None:
                break
            out.append(b)
        return out

    def acquire(self, block: int) -> None:
        self._ref[block] += 1
        self._evictable.pop(block, None)

    def register(self, h: bytes, block: int) -> bool:
        if h in self._map:
            return False
        self._map[h] = block
        self._hash_of[block] = h
        self._ref[block] = 1
        return True

    def release_block(self, block: int) -> bool:
        """Drop one hold. True when the block is cache-tracked (the
        caller must then NOT return it to the free list)."""
        if block not in self._ref:
            return False
        self._ref[block] -= 1
        if self._ref[block] <= 0:
            self._ref[block] = 0
            self._evictable[block] = None
        return True

    def evict_one(self) -> Optional[int]:
        """Reclaim the oldest zero-ref cached block for reuse."""
        if not self._evictable:
            return None
        block, _ = self._evictable.popitem(last=False)
        del self._map[self._hash_of.pop(block)]
        del self._ref[block]
        return block


class _RaggedView:
    """Cache facade for ONE ragged step: per-token write slots were
    precomputed by the scheduler, and attention is the single
    ragged_paged_attention call over the pool."""

    def __init__(self, cache: PagedKVCache, slots: torch.Tensor,
                 tables: torch.Tensor, lens: torch.Tensor, cu: torch.Tensor):
        self._c = cache
        self._slots = slots
        self._tables = tables
        self._lens = lens
        self._cu = cu

    def update(self, layer: int, k_new, v_new, pos):
        return self._c.write(layer, k_new, v_new, self._slots)

    def attend(self, layer: int, q: torch.Tensor, pos=None) -> torch.Tensor:
        b, s, h, d = q.shape
        out = S.ragged_paged_attention(
            q.reshape(s, h, d), self._c.k[layer], self._c.v[layer],
            self._tables, self._lens, self._cu,
            **self._c.scale_kwargs(layer))
        return out.reshape(b, s, h, d)


class _StepBuffers:
    """The ragged step's static device inputs, views into ONE device byte
    buffer, and the pinned host staging buffer of the same layout that
    one copy moves to it each step."""

    def __init__(self, B: int, R: int, L: int, MB: int,
                 device: torch.device):
        fields = (("ids", (1, B), torch.int32), ("pos", (1, B), torch.int32),
                  ("slot", (B,), torch.int64), ("tables", (R, MB),
                                                torch.int32),
                  ("lens", (R,), torch.int32), ("cu", (R + 1,), torch.int32),
                  ("sample_idx", (R * L,), torch.int64),
                  ("keys", (R * L, 2), torch.int64),
                  ("stream_pos", (R * L,), torch.int64))
        spans, off = [], 0
        for name, shape, dt in fields:
            n = int(np.prod(shape)) * torch.tensor([], dtype=dt).element_size()
            spans.append((name, shape, dt, off, n))
            off += -(-n // 16) * 16            # 16-byte aligned fields
        pin = device.type == "cuda"
        self.host = torch.zeros(off, dtype=torch.uint8, pin_memory=pin)
        self.dev = torch.zeros(off, dtype=torch.uint8, device=device)
        self.np: Dict[str, np.ndarray] = {}
        self.t: Dict[str, torch.Tensor] = {}
        for name, shape, dt, o, n in spans:
            self.np[name] = self.host[o:o + n].view(dt).view(shape).numpy()
            self.t[name] = self.dev[o:o + n].view(dt).view(shape)

    def upload(self) -> None:
        """Host staging -> device, one copy. The previous step's copy has
        finished (each step ends reading its sampled tokens back), so
        the staging buffer is free to rewrite."""
        self.dev.copy_(self.host, non_blocking=True)


class ContinuousBatchingEngine:
    """Ragged continuous batching: chunked prefill + decode in one model
    call per step over the paged pool, with prefix-cache block sharing.

    ``token_budget`` fixes the packed token count per step; it must cover
    at least one token per row (``max_batch``). ``prefill_chunk`` is the
    fixed chunk size long prompts are sliced into. The pool lives on the
    model's device."""

    def __init__(self, model, max_batch: int,
                 num_blocks: Optional[int] = None,
                 block_size: int = 64,
                 max_blocks_per_seq: Optional[int] = None,
                 eos_token_id: Optional[int] = None,
                 temperature: float = 0.0, top_k: int = 0,
                 top_p: float = 1.0, preempt_after: Optional[int] = None,
                 token_budget: Optional[int] = None,
                 prefill_chunk: Optional[int] = None,
                 enable_prefix_cache: bool = True, seed: int = 0,
                 max_queue: Optional[int] = None,
                 on_finish=None, kv_dtype: Optional[str] = None,
                 speculative_k: Optional[int] = None,
                 kv_pool_bytes: Optional[int] = None):
        cfg = model.config
        self.model = model
        self.device = model.device
        self.eos = eos_token_id
        self.sampling = dict(temperature=temperature, top_k=top_k,
                             top_p=top_p)
        if kv_dtype is None:
            kv_dtype = _flags.get_flag("kv_cache_dtype")
        head_dim = cfg.hidden_size // cfg.num_attention_heads
        if num_blocks is None:
            # pool sized in BYTES: int8 buys ~2x blocks per byte, and the
            # admission math below is all in blocks
            if kv_pool_bytes is None:
                raise ValueError(
                    "pass num_blocks or kv_pool_bytes to size the pool")
            num_blocks = kv_pool_blocks(
                kv_pool_bytes, block_size, cfg.num_key_value_heads, head_dim,
                cfg.num_hidden_layers, dtype=cfg.dtype, kv_dtype=kv_dtype)
        mb = max_blocks_per_seq or (
            -(-cfg.max_position_embeddings // block_size))
        self.cache = PagedKVCache(
            cfg.num_hidden_layers, max_batch, num_blocks=num_blocks,
            block_size=block_size, num_kv_heads=cfg.num_key_value_heads,
            head_dim=head_dim, max_blocks_per_seq=mb, dtype=cfg.dtype,
            kv_dtype=kv_dtype, device=self.device)
        # speculative decoding: K draft tokens per decode row, verified as
        # one q_len=K+1 ragged row out of the leftover token budget.
        # Acceptance is EXACT-MATCH against the row's keyed sample at each
        # stream position, so spec-on output equals spec-off output
        if speculative_k is None:
            speculative_k = int(_flags.get_flag("speculative_k"))
        self.spec_k = max(0, int(speculative_k))
        self.proposer = NGramProposer() if self.spec_k else None
        self.block_size = block_size
        self.max_batch = max_batch
        self.prefill_chunk = prefill_chunk or block_size
        self.token_budget = token_budget or (max_batch + self.prefill_chunk)
        if self.token_budget < max_batch:
            raise ValueError(
                f"token_budget={self.token_budget} < max_batch={max_batch}:"
                f" decode rows alone would not fit one step")
        self.enable_prefix_cache = enable_prefix_cache
        # one reserved block absorbs the writes of step-padding tokens
        self._trash_slot = self.cache._free.pop() * block_size
        self._total_blocks = num_blocks - 1
        self._pc = PrefixCache()
        self.slots: List[Optional[Request]] = [None] * max_batch
        self.pending: deque[Request] = deque()
        self.results: Dict[int, Request] = {}
        self.tok = np.zeros((max_batch,), np.int32)
        self._next_rid = 0
        self._admit_seq = 0
        self.steps = 0
        self.preempt_after = preempt_after
        self._head_waited = 0
        self.preempt_count = 0
        self.seed = seed
        self.max_queue = max_queue
        self.on_finish = on_finish
        # drain hook: a paused engine keeps stepping its in-flight rows
        # but admits nothing new
        self.admission_paused = False
        self.finish_cv = threading.Condition()
        self._queue_waits: List[float] = []
        # plain counters in place of the reference's metrics registry
        self.stats = dict.fromkeys(
            ("step_tokens", "generated_tokens", "prefill_tokens", "admitted",
             "finished", "rejected", "prefix_hit_blocks",
             "prefix_miss_blocks", "prefix_evictions", "cow_copies",
             "spec_proposed", "spec_accepted", "spec_verify_rows"), 0)
        # the step graph: static buffers, one graph per key (see module
        # docstring)
        self._buf = _StepBuffers(self.token_budget, max_batch,
                                 self.spec_k + 1,
                                 self.cache.block_tables.shape[1],
                                 self.device)
        self._graphs: Dict[tuple, Any] = {}
        self._stream = None
        self.capture_stats = dict(captures=0, replays=0, eager_steps=0,
                                  capture_s=0.0, pool_bytes=0)

    # -- request intake ------------------------------------------------------
    def add_request(self, prompt, max_new_tokens: int = 32) -> int:
        """Queue a request; returns its rid (which keys its sampling
        stream). Raises ``QueueFull`` at ``max_queue`` pending."""
        if (self.max_queue is not None
                and len(self.pending) >= self.max_queue):
            self.stats["rejected"] += 1
            waits = self._queue_waits
            raise QueueFull(
                f"admission queue is full ({len(self.pending)}/"
                f"{self.max_queue} pending): shed load or retry later",
                retry_after_hint=(float(np.median(waits))
                                  if waits else None))
        rid = self._next_rid
        req = Request(rid, np.asarray(prompt, np.int32).reshape(-1),
                      max_new_tokens)
        if len(req.prompt) == 0:
            raise ValueError("empty prompt: there is no token to prefill, "
                             "so no logits exist to sample from")
        mb = self.cache.block_tables.shape[1]
        if self._blocks_needed(req) > min(self._total_blocks, mb):
            raise ValueError(
                f"request needs {self._blocks_needed(req)} blocks but the "
                f"pool has {self._total_blocks} and a sequence may hold at "
                f"most max_blocks_per_seq={mb}: it could never be admitted")
        req.t_arrive = time.time()
        # sha256 chain digests, NOT builtin hash(): a collision would
        # silently serve another request's KV blocks
        h = b""
        for bi in range(len(req.prompt) // self.block_size):
            h = hashlib.sha256(
                h + req.prompt[bi * self.block_size:
                               (bi + 1) * self.block_size].tobytes()
            ).digest()
            req.block_hashes.append(h)
        req.key_data = np.asarray(S.request_key(self.seed, rid), np.int64)
        self._next_rid += 1
        self.pending.append(req)
        self.results[rid] = req
        return rid

    def _blocks_needed(self, req: Request) -> int:
        return -(-(len(req.prompt) + req.max_new_tokens)
                 // self.block_size)

    # -- pool accounting -----------------------------------------------------
    def _free_effective(self) -> int:
        """Allocatable blocks: the free list plus warm cached blocks with
        no active holder."""
        return len(self.cache._free) + self._pc.evictable

    def _outstanding_reservation(self) -> int:
        """Blocks the ACTIVE sequences may still claim."""
        return sum(self._blocks_needed(r)
                   - int(self.cache._allocated[r.slot])
                   for r in self.slots if r is not None)

    def _alloc_block(self) -> int:
        if self.cache._free:
            return self.cache._free.pop()
        blk = self._pc.evict_one()
        if blk is None:
            raise RuntimeError("PagedKVCache: block pool exhausted")
        self.stats["prefix_evictions"] += 1
        return blk

    def _ensure_writable(self, i: int, blk_idx: int) -> None:
        """Copy-on-write: a write into a cache-tracked block would mutate
        content other holders still reference; copy it to a fresh private
        block first. Defensive: the scheduler only appends past the
        block-aligned shared head."""
        blk = int(self.cache.block_tables[i, blk_idx])
        if not self._pc.tracked(blk):
            return
        fresh = self._alloc_block()
        pools = [self.cache.k, self.cache.v]
        if self.cache.quantized:
            # the per-token-slot scale rows move with their block
            pools += [self.cache.k_scale, self.cache.v_scale]
        for pool in pools:
            for layer in range(self.cache.num_layers):
                pool[layer][fresh].copy_(pool[layer][blk])
        self.cache.block_tables[i, blk_idx] = fresh
        self._pc.release_block(blk)
        self.stats["cow_copies"] += 1

    def _write_slots(self, i: int, pos0: int, n: int) -> np.ndarray:
        if n > 0 and pos0 % self.block_size:
            self._ensure_writable(i, pos0 // self.block_size)
        return self.cache.alloc_slots(i, pos0, n, self._alloc_block)

    # -- admission -----------------------------------------------------------
    def _admit(self):
        if self.admission_paused:
            return
        for i in range(self.max_batch):
            if not self.pending:
                return
            if self.slots[i] is not None:
                continue
            req = self.pending[0]
            full = (np.concatenate([req.prompt,
                                    np.asarray(req.out_tokens[:-1],
                                               np.int32)])
                    if req.out_tokens else req.prompt)
            target = len(full)
            hits = (self._pc.lookup(req.block_hashes)
                    if self.enable_prefix_cache else [])
            # never share the whole target: the last token must be
            # recomputed so its logits exist to sample from
            n_use = min(len(hits), max(0, (target - 1) // self.block_size))
            # shared blocks with no active holder leave the evictable set,
            # so they consume allocatable headroom like fresh ones
            evict_take = sum(1 for b in hits[:n_use]
                             if self._pc.ref(b) == 0)
            need = self._blocks_needed(req) - n_use + evict_take
            if need > self._free_effective() - self._outstanding_reservation():
                return                 # reservation: wait for reclaims
            self.pending.popleft()
            self._head_waited = 0
            if req.admit_order == -1:
                self._queue_waits.append(time.time() - req.t_arrive)
            req.slot = i
            req.admit_order = self._admit_seq
            self._admit_seq += 1
            self.slots[i] = req
            req.full_seq = full
            req.target = target
            req._registered_upto = n_use   # shared head: already published
            for bi in range(n_use):
                self._pc.acquire(hits[bi])
                self.cache.block_tables[i, bi] = hits[bi]
            self.cache._allocated[i] = n_use
            req.ctx = n_use * self.block_size
            self.cache.context_lens[i] = req.ctx
            self.stats["admitted"] += 1
            self.stats["prefix_hit_blocks"] += n_use
            self.stats["prefix_miss_blocks"] += max(
                0, len(req.prompt) // self.block_size - n_use)

    # -- lifecycle -----------------------------------------------------------
    @property
    def num_active(self) -> int:
        return sum(1 for r in self.slots if r is not None)

    def _release_slot(self, i: int):
        used = int(self.cache._allocated[i])
        for blk in self.cache.block_tables[i, :used]:
            blk = int(blk)
            if not self._pc.release_block(blk):
                self.cache._free.append(blk)
        self.cache.block_tables[i, :] = 0
        self.cache.context_lens[i] = 0
        self.cache._allocated[i] = 0
        self.slots[i] = None
        self.tok[i] = 0

    def _preempt_lifo(self):
        """Evict the most-recently-admitted sequence and requeue it right
        behind the starved head (recompute on resume; its private sampling
        stream makes the resumed output identical)."""
        victim = max((r for r in self.slots if r is not None),
                     key=lambda r: r.admit_order, default=None)
        if victim is None:
            return
        self._release_slot(victim.slot)
        victim.slot = None
        victim.ctx = 0
        victim.full_seq = None      # rebuilt at re-admission
        victim.preemptions += 1
        self.preempt_count += 1
        self.pending.insert(1, victim)

    def _register_blocks(self, req: Request, i: int, new_ctx: int):
        """Publish freshly completed FULL prompt blocks to the prefix
        cache (never the recomputed tail of a resumed request)."""
        if not self.enable_prefix_cache:
            return
        hi = min(new_ctx, len(req.prompt)) // self.block_size
        for bi in range(req._registered_upto, hi):
            self._pc.register(req.block_hashes[bi],
                              int(self.cache.block_tables[i, bi]))
        req._registered_upto = max(req._registered_upto, hi)

    def _append_token(self, req: Request, i: int, tok: int, now: float,
                      finished: List[Request]):
        req.out_tokens.append(tok)
        self.stats["generated_tokens"] += 1
        if req.t_first is None:
            req.t_first = now
        self.tok[i] = tok
        if (len(req.out_tokens) >= req.max_new_tokens
                or (self.eos is not None and tok == self.eos)):
            req.done = True
            req.t_done = now
            self._release_slot(i)
            req.slot = None
            req.full_seq = None
            self.stats["finished"] += 1
            finished.append(req)

    # -- the ragged step -----------------------------------------------------
    @torch.no_grad()
    def step(self) -> List[Request]:
        """Admit, then run ONE ragged mixed prefill+decode batch. Returns
        the requests that finished during this step."""
        self._admit()
        if self.pending and self.preempt_after is not None \
                and not self.admission_paused:
            self._head_waited += 1
            if self._head_waited > self.preempt_after:
                self._preempt_lifo()
                self._head_waited = 0
                self._admit()
        if self.num_active == 0:
            return []

        B, R = self.token_budget, self.max_batch
        # fixed-size prefill chunks, round-robin by admission order, into
        # the budget left after every decoding row's token
        decode_rows = [i for i, r in enumerate(self.slots)
                       if r is not None and r.ctx >= r.target]
        prefill_rows = sorted(
            (i for i, r in enumerate(self.slots)
             if r is not None and r.ctx < r.target),
            key=lambda i: self.slots[i].admit_order)
        grants = dict.fromkeys(prefill_rows, 0)
        left = B - len(decode_rows)
        while left > 0:
            gave = False
            for i in prefill_rows:
                req = self.slots[i]
                g = min(self.prefill_chunk, req.target - req.ctx - grants[i],
                        left)
                if g > 0:
                    grants[i] += g
                    left -= g
                    gave = True
                if left <= 0:
                    break
            if not gave:
                break

        # speculative drafts out of the LEFTOVER budget; the emission cap
        # keeps write positions inside the admission-time worst case
        drafts: Dict[int, np.ndarray] = {}
        if self.spec_k and left > 0:
            for i in decode_rows:
                req = self.slots[i]
                cap = min(self.spec_k,
                          req.max_new_tokens - len(req.out_tokens) - 1,
                          left)
                if cap <= 0:
                    continue
                # a proposal depends ONLY on this request's own tokens
                hist = np.concatenate(
                    [req.prompt, np.asarray(req.out_tokens, np.int32)])
                d = self.proposer.propose(hist, cap)
                if len(d):
                    drafts[i] = np.asarray(d, np.int32)
                    left -= len(d)
                if left <= 0:
                    break

        # L sample lanes per row: lane j of a verify row samples stream
        # position len(out)+j from the logits of packed token t+j
        L = self.spec_k + 1
        ids = np.zeros((B,), np.int32)
        pos = np.zeros((B,), np.int32)
        slot_vec = np.full((B,), self._trash_slot, np.int64)
        qlen = np.zeros((R,), np.int32)
        lens = np.zeros((R,), np.int32)
        sample_idx = np.zeros((R * L,), np.int64)
        stream_pos = np.zeros((R * L,), np.int64)
        keys = np.zeros((R * L, 2), np.int64)
        post = []                      # (row, is_decode, n) commit plan
        t = 0
        for i in range(R):
            req = self.slots[i]
            if req is None:
                continue
            if req.ctx >= req.target:           # decode / verify row
                d = drafts.get(i)
                n = 1 + (0 if d is None else len(d))
                ids[t] = self.tok[i]
                if n > 1:
                    ids[t + 1:t + n] = d
                pos[t:t + n] = np.arange(req.ctx, req.ctx + n)
                slot_vec[t:t + n] = self._write_slots(i, req.ctx, n)
                qlen[i] = n
                lens[i] = req.ctx + n
                sample_idx[i * L:(i + 1) * L] = t   # spare lanes: dup t
                sample_idx[i * L:i * L + n] = np.arange(t, t + n)
                stream_pos[i * L:i * L + n] = (len(req.out_tokens)
                                               + np.arange(n))
                keys[i * L:(i + 1) * L] = req.key_data
                post.append((i, True, n))
                t += n
            else:                                           # prefill chunk
                n = grants.get(i, 0)
                lens[i] = req.ctx + n
                if n == 0:
                    continue
                ids[t:t + n] = req.full_seq[req.ctx:req.ctx + n]
                pos[t:t + n] = np.arange(req.ctx, req.ctx + n)
                slot_vec[t:t + n] = self._write_slots(i, req.ctx, n)
                qlen[i] = n
                if req.ctx + n == req.target and not req.out_tokens:
                    sample_idx[i * L] = t + n - 1  # first tok: last logits
                    stream_pos[i * L] = 0
                    keys[i * L] = req.key_data
                post.append((i, False, n))
                t += n
        cu = np.zeros((R + 1,), np.int32)
        np.cumsum(qlen, out=cu[1:])

        # every element of every static buffer, rewritten
        hb = self._buf.np
        hb["ids"][0] = ids
        hb["pos"][0] = pos
        hb["slot"][:] = slot_vec
        hb["tables"][:] = self.cache.block_tables
        hb["lens"][:] = lens
        hb["cu"][:] = cu
        hb["sample_idx"][:] = sample_idx
        hb["keys"][:] = keys
        hb["stream_pos"][:] = stream_pos
        self._buf.upload()
        if _flags.get_flag("step_capture"):
            nxt = self._graph_step()
        else:
            self.capture_stats["eager_steps"] += 1
            nxt = self._forward()
        sampled = nxt.cpu().numpy().reshape(-1)
        self.steps += 1
        self.stats["step_tokens"] += t
        now = time.time()
        finished: List[Request] = []
        for i, is_decode, n in post:
            req = self.slots[i]
            if is_decode:
                # exact-match verify: draft j is accepted iff it equals
                # the keyed sample at its stream position; the first
                # mismatch invalidates everything after it
                d = drafts.get(i)
                nd = n - 1
                base = i * L
                a = 0
                while a < nd and int(sampled[base + a]) == int(d[a]):
                    a += 1
                if nd:
                    self.stats["spec_proposed"] += nd
                    self.stats["spec_accepted"] += a
                    self.stats["spec_verify_rows"] += 1
                # rejected-draft KV rows are garbage: context_lens hides
                # them and the next step overwrites those slots
                req.ctx += 1 + a
                self.cache.context_lens[i] = req.ctx
                for j in range(a + 1):
                    self._append_token(req, i, int(sampled[base + j]),
                                       now, finished)
                    if req.done:
                        break
            else:
                req.ctx += n
                self.cache.context_lens[i] = req.ctx
                self.stats["prefill_tokens"] += n
                self._register_blocks(req, i, req.ctx)
                if req.ctx == req.target:
                    if req.out_tokens:  # resumed: next input pre-sampled
                        self.tok[i] = req.out_tokens[-1]
                    else:
                        self._append_token(req, i, int(sampled[i * L]),
                                           now, finished)
        if self.on_finish is not None:
            for req in finished:
                self.results.pop(req.rid, None)
                self.on_finish(req)
        if finished:
            with self.finish_cv:
                self.finish_cv.notify_all()
        return finished

    # -- the step graph ------------------------------------------------------
    def _forward(self) -> torch.Tensor:
        """The model call, the sample-row gather and the keyed sampler
        over the static buffers: what the graph captures."""
        t = self._buf.t
        view = _RaggedView(self.cache, t["slot"], t["tables"], t["lens"],
                           t["cu"])
        logits = self.model(t["ids"], cache=view, start_pos=t["pos"])
        lrows = logits.reshape(self.token_budget, -1).index_select(
            0, t["sample_idx"])
        return S.sample_logits_keyed(lrows, t["keys"], t["stream_pos"],
                                     **self.sampling)

    def _graph_key(self) -> tuple:
        routes = tuple(sorted((k, v) for k, v in _flags._VALUES.items()
                              if k not in ("step_capture", "multi_step")))
        return (self.token_budget, self.max_batch, self.spec_k + 1,
                self.cache.kv_dtype, tuple(sorted(self.sampling.items())),
                routes)

    def _graph_step(self) -> torch.Tensor:
        from ..jit import step_capture as sc
        key = self._graph_key()
        ent = self._graphs.get(key)
        if ent is None:
            return self._capture_step(key)
        out = ent.replay(self._forward)
        self.capture_stats["replays"] += 1
        sc.capture_counters["replays"] += 1
        return out

    def _capture_step(self, key) -> torch.Tensor:
        """The geometry's first step: a warm-up over the static buffers
        (on the capture's side stream: every kernel library loads and
        sets its attributes before the capture), which is this step's
        result and its launches, then the capture, which runs nothing.
        Raises if the capture fails."""
        from ..jit import step_capture as sc
        cuda = self.device.type == "cuda"
        if cuda and self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        before = sc._counter_state()
        with sc.on_stream(self._stream if cuda else None):
            out = self._forward()
        if cuda:
            try:
                graph = sc.capture_graph(self._forward, self._stream)
            except (sc.CaptureAbort, torch.cuda.OutOfMemoryError) as e:
                raise RuntimeError(f"serving step capture failed: {e}") \
                    from e
            self.capture_stats["capture_s"] += graph.capture_s
            self.capture_stats["pool_bytes"] += graph.pool_bytes
        else:       # the CPU: the warm-up's launches stand for the graph's
            graph = sc.Graph(None, None, sc._counter_delta(before))
        self._graphs[key] = graph
        self.capture_stats["captures"] += 1
        sc.capture_counters["captures"] += 1
        return out

    def pop_result(self, rid: int,
                   timeout: Optional[float] = None) -> Optional[Request]:
        """Retire a finished request from ``results``. With ``timeout``,
        block on the finish condition until the request completes or the
        deadline passes."""
        if timeout is None:
            req = self.results.get(rid)
            if req is None or not req.done:
                return None
            return self.results.pop(rid)
        deadline = time.monotonic() + float(timeout)
        with self.finish_cv:
            while True:
                req = self.results.get(rid)
                if req is not None and req.done:
                    return self.results.pop(rid)
                left = deadline - time.monotonic()
                if left <= 0:
                    return None
                self.finish_cv.wait(timeout=left)

    def run(self) -> Dict[int, List[int]]:
        """Drive until every request (queued + active) completes (a
        paused engine only drains its in-flight rows)."""
        out: Dict[int, List[int]] = {}
        while ((self.pending and not self.admission_paused)
               or self.num_active):
            for req in self.step():
                out[req.rid] = req.out_tokens
        for rid, req in self.results.items():
            out.setdefault(rid, req.out_tokens)
        return out
