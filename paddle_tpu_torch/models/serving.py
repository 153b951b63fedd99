"""Continuous batching over the paged KV cache: the ragged serving loop,
and the gang-scheduled engine it replaced.

Counterpart of ``paddle_tpu/models/serving.py``: ``QueueFull``,
``Request``, ``PrefixCache`` (:198), ``_SlotView`` (:271), ``_RaggedView``
(:298), ``ContinuousBatchingEngine`` (:324) and ``GangScheduledEngine``
(:1009), with the same behaviour:

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

- **Operability.** Scheduler state (queue depth, active rows, prefill
  backlog, free blocks, prefix-cache hits and evictions, preemptions,
  speculation) publishes through ``observability.registry()`` under the
  reference's ``serving.*`` names (:81-141), with tenant-labelled
  children of the admission counters; TTFT, TPOT and queue wait land in
  histograms; each request's queue, prefill and decode phases and each
  step are spans (``observability.tracing``). All of it is taken on the
  host around the step (a captured step's replay included), never
  inside the graph. The reference's perf ledger (``FLAGS_perf_attribution``)
  is not ported: that flag raises (ROADMAP.md, A9).
- **The gang-scheduled engine** (``GangScheduledEngine``): batch-1
  prefill of an admitted request into its slot (the ragged kernel over
  the slot's blocks), then one gang-decode step of every row
  (``paged_attention``, one call a layer); inactive rows write to a
  reserved trash block; LIFO preemption with recompute on resume. It
  runs eagerly, as the reference's does (its prefill shapes vary). It is
  the baseline and the equivalence reference of the ragged engine.
"""

from __future__ import annotations

import hashlib
import threading
import time
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import flags as _flags
from ..observability import metrics as _metrics_mod
from ..observability import tracing as _tracing
from ..ops.kernels import serving as S
from .generation import PagedKVCache, kv_pool_blocks
from .speculative import NGramProposer

__all__ = ["Request", "ContinuousBatchingEngine", "GangScheduledEngine",
           "PrefixCache", "QueueFull"]


class QueueFull(RuntimeError):
    """Admission queue is at ``max_queue``: the server must shed load
    explicitly instead of buffering without bound.

    ``retry_after_hint`` (seconds, None before any request was admitted)
    is the median observed queue wait, read off the
    ``serving.queue_wait_seconds`` histogram."""

    def __init__(self, msg: str,
                 retry_after_hint: Optional[float] = None):
        super().__init__(msg)
        self.retry_after_hint = retry_after_hint


_M = _metrics_mod.registry()
_M_STEPS = _M.counter(
    "serving.steps", "ragged scheduler steps executed")
_M_STEP_TOKENS = _M.counter(
    "serving.step_tokens", "packed tokens processed (prefill + decode)")
_M_GEN_TOKENS = _M.counter(
    "serving.generated_tokens", "tokens sampled and emitted to requests")
_M_PREFILL_TOKENS = _M.counter(
    "serving.prefill_tokens", "prompt tokens prefilled (chunked)")
_M_ADMITTED = _M.counter(
    "serving.admitted", "requests admitted to a row slot")
_M_FINISHED = _M.counter(
    "serving.finished", "requests completed (eos / max_new_tokens)")
_M_PREEMPTIONS = _M.counter(
    "serving.preemptions", "LIFO preemptions (head-of-line starvation)")
_M_QUEUE = _M.gauge(
    "serving.queue_depth", "requests waiting for admission")
_M_ACTIVE = _M.gauge(
    "serving.active_rows", "row slots occupied by live requests")
_M_BACKLOG = _M.gauge(
    "serving.prefill_backlog_tokens",
    "prompt tokens admitted but not yet prefilled")
_M_FREE = _M.gauge(
    "serving.free_blocks", "allocatable pool blocks (free + evictable)")
_M_PC_HIT = _M.counter(
    "serving.prefix_cache.hit_blocks", "prompt blocks served from cache")
_M_PC_MISS = _M.counter(
    "serving.prefix_cache.miss_blocks", "full prompt blocks recomputed")
_M_PC_SHARED = _M.counter(
    "serving.prefix_cache.shared_tokens",
    "prompt tokens whose KV was shared instead of recomputed")
_M_PC_EVICT = _M.counter(
    "serving.prefix_cache.evictions",
    "cached blocks reclaimed by the allocator")
_M_COW = _M.counter(
    "serving.cow_copies", "copy-on-write block copies before a shared write")
_M_TTFT = _M.histogram(
    "serving.ttft_seconds", "request arrival -> first emitted token")
_M_TPOT = _M.histogram(
    "serving.tpot_seconds", "mean inter-token time after the first token")
_M_QWAIT = _M.histogram(
    "serving.queue_wait_seconds", "request arrival -> row-slot admission")
_M_REJECTED = _M.counter(
    "serving.rejected", "requests rejected at intake (queue full)")
_M_KV_BPT = _M.gauge(
    "serving.kv.bytes_per_token",
    "HBM bytes one token's K+V occupies across all layers (int8 pool "
    "includes its f32 scale bytes) — the decode bandwidth denominator")
_M_KV_DEQ = _M.counter(
    "serving.kv.dequant_blocks",
    "pool blocks dequantized inside attention tile loads (int8 pool)")
_M_SPEC_PROP = _M.counter(
    "serving.spec.proposed", "draft tokens packed into verify rows")
_M_SPEC_ACC = _M.counter(
    "serving.spec.accepted", "draft tokens accepted by exact-match verify")
_M_SPEC_REJ = _M.counter(
    "serving.spec.rejected", "draft tokens rejected at verify")
_M_SPEC_ROWS = _M.counter(
    "serving.spec.verify_rows", "decode rows that carried draft tokens")

# per-tenant children of the admission counters, cached so the hot path
# pays one dict hit instead of the registry lock. Tenant cardinality is
# the caller's contract: billing/SLO attribution labels, not a request id
_TENANT_COUNTERS: Dict[Tuple[str, str], Any] = {}


def _inc_tenant(name: str, tenant: Optional[str]) -> None:
    if tenant is None:
        return
    key = (name, tenant)
    c = _TENANT_COUNTERS.get(key)
    if c is None:
        c = _M.counter(name, labels={"tenant": tenant})
        _TENANT_COUNTERS[key] = c
    c.inc()


def _host_read(t: torch.Tensor) -> np.ndarray:
    """A step's one host sync, the sampled tokens' read: a frame of its
    own, so a host stack parked in it reads as a device call
    (``observability/debug.py``)."""
    return t.cpu().numpy().reshape(-1)


# held by an engine step while it captures or replays its graph (see
# ContinuousBatchingEngine._graph_step)
_GRAPH_LOCK = threading.RLock()


def _no_perf_attribution() -> None:
    if _flags.get_flag("perf_attribution"):
        raise NotImplementedError(
            "FLAGS_perf_attribution: the executable ledger "
            "(observability/perf.py) is not ported yet (ROADMAP.md, A9)")


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
    n_replayed: int = 0                # tokens emitted by a previous process
    tenant: Optional[str] = None       # labels the admission counters
    _registered_upto: int = 0          # prompt blocks published to the cache
    # -- tracing: the ambient trace context at intake plus perf_counter_ns
    # edge stamps, so the engine records the request's queue, prefill and
    # decode phases as RETROACTIVE spans
    trace_id: int = 0
    span_parent: int = 0
    t_arrive_ns: int = 0
    t_admit_ns: int = 0
    t_first_ns: int = 0


def _req_trace(req: "Request"):
    return (req.trace_id, req.span_parent) if req.trace_id else None


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


class _SlotView:
    """Batch-1 cache facade targeting ONE slot of the shared pool (the
    gang engine's prefill): the model's prefill pass runs unchanged, its
    writes land in the slot's block table, and it attends through the
    ragged kernel over the slot's blocks (one ragged row). The engine
    passes no mask, so a mask raises."""

    def __init__(self, cache: PagedKVCache, slot: int):
        self._c = cache
        self._slot = slot
        self._meta = None

    def update(self, layer: int, k_new, v_new, pos):
        c, slot, n = self._c, self._slot, k_new.shape[1]
        if layer == 0:
            p0 = int(pos)
            dev = c.device
            self._slots = torch.from_numpy(
                c.alloc_slots(slot, p0, n)).to(dev)
            self._meta = (
                torch.from_numpy(c.block_tables[slot:slot + 1]).to(dev),
                torch.tensor([p0 + n], dtype=torch.int32, device=dev),
                torch.tensor([0, n], dtype=torch.int32, device=dev))
        c.write(layer, k_new, v_new, self._slots)
        return c.k[layer], c.v[layer]

    def attend(self, layer: int, q: torch.Tensor, pos=None,
               attn_mask=None) -> torch.Tensor:
        if attn_mask is not None:
            raise NotImplementedError(
                "the gang engine's slot prefill has no attn_mask input: "
                "the slot's context length bounds what it attends to")
        b, s, h, d = q.shape
        tables, lens, cu = self._meta
        out = S.ragged_paged_attention(
            q.reshape(s, h, d), self._c.k[layer], self._c.v[layer], tables,
            lens, cu, **self._c.scale_kwargs(layer))
        return out.reshape(b, s, h, d)


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

    def attend(self, layer: int, q: torch.Tensor, pos=None,
               attn_mask=None) -> torch.Tensor:
        if attn_mask is not None:
            raise NotImplementedError(
                "the ragged step has no attn_mask input: context_lens and "
                "cu_q_lens bound what each packed token attends to")
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
                 kv_pool_bytes: Optional[int] = None,
                 resume_by_decode: bool = False):
        _no_perf_attribution()
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
        _M_KV_BPT.set(self.cache.kv_bytes_per_token())
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
        # how a resumed row (journal replay, preemption) rebuilds the KV of
        # its committed tokens: False prefills them with the prompt (the
        # reference's recompute); True prefills the prompt only and feeds
        # them back one a step as decode rows, discarding the samples.
        # The card's ragged kernel takes decode rows through its split
        # pass and longer rows through its tile pass, whose float sums
        # differ, so only the decode route rebuilds the bytes the
        # uninterrupted run wrote, and only then do the resumed row's
        # later tokens equal that run's at any temperature
        self.resume_by_decode = bool(resume_by_decode)
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
    def add_request(self, prompt, max_new_tokens: int = 32, *,
                    rid: Optional[int] = None,
                    out_tokens: Optional[List[int]] = None,
                    tenant: Optional[str] = None) -> int:
        """Queue a request; returns its rid (which keys its sampling
        stream). Raises ``QueueFull`` at ``max_queue`` pending NEW
        requests. ``rid`` / ``out_tokens`` re-admit a request a previous
        process journaled: it keeps its ORIGINAL rid (its sampling stream
        folds it) and resumes from its committed tokens like a preempted
        row (recompute on resume), observing no TTFT or TPOT. ``tenant``
        also counts the admission or rejection on a tenant-labelled child
        of the serving counters."""
        if rid is None:
            # the queue bound governs NEW traffic only: a replayed request
            # was already acknowledged by a previous process
            if (self.max_queue is not None
                    and len(self.pending) >= self.max_queue):
                _M_REJECTED.inc()
                _inc_tenant("serving.rejected", tenant)
                raise QueueFull(
                    f"admission queue is full ({len(self.pending)}/"
                    f"{self.max_queue} pending): shed load or retry later",
                    retry_after_hint=_M_QWAIT.quantile(0.5))
            rid = self._next_rid
        elif rid in self.results:
            raise ValueError(f"rid {rid} already journaled to this engine")
        self._next_rid = max(self._next_rid, rid + 1)
        req = Request(rid, np.asarray(prompt, np.int32).reshape(-1),
                      max_new_tokens, tenant=tenant)
        if out_tokens:
            if len(out_tokens) >= max_new_tokens:
                raise ValueError(
                    f"resumed request {rid} already has {len(out_tokens)} "
                    f"of max_new_tokens={max_new_tokens} tokens: nothing "
                    f"left to generate (load it from the journal instead)")
            req.out_tokens = [int(t) for t in out_tokens]
            # replayed tokens were emitted by a previous process: this one
            # must not observe their TTFT or TPOT
            req.t_first = time.time()
            req.n_replayed = len(req.out_tokens)
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
        req.t_arrive_ns = _tracing.now_ns()
        tc = _tracing.current()
        if tc is not None:
            req.trace_id, req.span_parent = tc
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
        _M_PC_EVICT.inc()
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
        _M_COW.inc()

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
                    if req.out_tokens and not self.resume_by_decode
                    else req.prompt)
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
                # first admission only: a re-admission's arrival-to-now
                # span includes its decode residency, which is no wait
                _M_QWAIT.observe(time.time() - req.t_arrive)
                req.t_admit_ns = _tracing.now_ns()
                _tracing.record_span(
                    "serving.queue", req.t_arrive_ns, req.t_admit_ns,
                    trace=_req_trace(req), attrs={"rid": req.rid})
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
            _M_ADMITTED.inc()
            _inc_tenant("serving.admitted", req.tenant)
            if n_use:
                _M_PC_HIT.inc(n_use)
                _M_PC_SHARED.inc(n_use * self.block_size)
            _M_PC_MISS.inc(max(0, len(req.prompt) // self.block_size
                               - n_use))

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
        _M_PREEMPTIONS.inc()
        _tracing.instant("serving.preempt", trace=_req_trace(victim),
                         attrs={"rid": victim.rid,
                                "preemptions": victim.preemptions})
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
        _M_GEN_TOKENS.inc()
        if req.t_first is None:
            req.t_first = now
            _M_TTFT.observe(now - req.t_arrive)
            req.t_first_ns = _tracing.now_ns()
            # slot admission -> first token: with serving.queue before it
            # and serving.step beside it, TTFT decomposes on one timeline
            _tracing.record_span(
                "serving.prefill",
                req.t_admit_ns or req.t_arrive_ns, req.t_first_ns,
                trace=_req_trace(req), attrs={"rid": req.rid})
            _tracing.instant("serving.first_token", trace=_req_trace(req),
                             attrs={"rid": req.rid})
        self.tok[i] = tok
        if (len(req.out_tokens) >= req.max_new_tokens
                or (self.eos is not None and tok == self.eos)):
            req.done = True
            req.t_done = now
            # a resumed row skips TPOT as it skips TTFT: part of its count
            # was emitted by another process
            if len(req.out_tokens) > 1 and req.n_replayed == 0:
                _M_TPOT.observe((now - req.t_first)
                                / (len(req.out_tokens) - 1))
            self._release_slot(i)
            req.slot = None
            req.full_seq = None
            _M_FINISHED.inc()
            _tracing.record_span(
                "serving.decode",
                req.t_first_ns or req.t_admit_ns or req.t_arrive_ns,
                _tracing.now_ns(), trace=_req_trace(req),
                attrs={"rid": req.rid, "tokens": len(req.out_tokens)})
            _tracing.instant("serving.finish", trace=_req_trace(req),
                             attrs={"rid": req.rid})
            finished.append(req)

    def _refeeding(self, req: Request) -> bool:
        """A decode row whose input this step is a committed token other
        than the last (``resume_by_decode``): its KV is rebuilt, not
        sampled on."""
        return req.ctx - len(req.prompt) < len(req.out_tokens) - 1

    # -- the ragged step -----------------------------------------------------
    @torch.no_grad()
    def step(self) -> List[Request]:
        """Admit, then run ONE ragged mixed prefill+decode batch. Returns
        the requests that finished during this step."""
        _no_perf_attribution()
        self._admit()
        if self.pending and self.preempt_after is not None \
                and not self.admission_paused:
            self._head_waited += 1
            if self._head_waited > self.preempt_after:
                self._preempt_lifo()
                self._head_waited = 0
                self._admit()
        _M_QUEUE.set(len(self.pending))
        _M_ACTIVE.set(self.num_active)
        _M_BACKLOG.set(sum(r.target - r.ctx for r in self.slots
                           if r is not None and r.ctx < r.target))
        _M_FREE.set(self._free_effective())
        if self.num_active == 0:
            return []

        B, R, bs = self.token_budget, self.max_batch, self.block_size
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
                if self._refeeding(req):
                    continue
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
        t0_ns = _tracing.now_ns()
        self._buf.upload()
        if _flags.get_flag("step_capture"):
            nxt = self._graph_step()
        else:
            self.capture_stats["eager_steps"] += 1
            nxt = self._forward()
        sampled = _host_read(nxt)
        self.steps += 1
        _M_STEPS.inc()
        _M_STEP_TOKENS.inc(t)
        # retroactive, untraced (one step serves many requests): the
        # upload through the host read of the sampled tokens
        _tracing.record_span(
            "serving.step", t0_ns, _tracing.now_ns(),
            attrs={"tokens": t, "decode_rows": len(decode_rows),
                   "prefill_rows": len(prefill_rows)})
        if self.cache.quantized:
            # every attended block is dequantized in the tile loads
            _M_KV_DEQ.inc(sum((int(lens[i]) + bs - 1) // bs
                              for i, _, _ in post)
                          * self.cache.num_layers)
        now = time.time()
        finished: List[Request] = []
        for i, is_decode, n in post:
            req = self.slots[i]
            if is_decode and self._refeeding(req):
                # a committed token fed back: its sample is discarded and
                # the next committed token is the row's next input
                req.ctx += 1
                self.cache.context_lens[i] = req.ctx
                self.tok[i] = req.out_tokens[req.ctx - len(req.prompt)]
            elif is_decode:
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
                    _M_SPEC_PROP.inc(nd)
                    _M_SPEC_ACC.inc(a)
                    _M_SPEC_REJ.inc(nd - a)
                    _M_SPEC_ROWS.inc()
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
                _M_PREFILL_TOKENS.inc(n)
                _tracing.instant(
                    "serving.prefill_chunk", trace=_req_trace(req),
                    attrs={"rid": req.rid, "tokens": n, "ctx": req.ctx})
                self._register_blocks(req, i, req.ctx)
                if req.ctx == req.target:
                    if req.out_tokens:  # resumed: next input pre-sampled
                        # (by decode: the first committed token, fed back)
                        self.tok[i] = req.out_tokens[
                            0 if self.resume_by_decode else -1]
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
        routes = tuple(sorted(
            (k, v) for k, v in _flags._VALUES.items()
            if k not in ("step_capture", "multi_step")
            and k not in _flags.OBSERVABILITY_FLAGS))
        return (self.token_budget, self.max_batch, self.spec_k + 1,
                self.cache.kv_dtype, tuple(sorted(self.sampling.items())),
                routes)

    def _graph_step(self) -> torch.Tensor:
        from ..jit import step_capture as sc
        key = self._graph_key()
        # engines of one process stepping on threads of their own (the
        # fleet's thread replicas): a capture rolls the launch counters
        # back to where they stood before it and records its own advance,
        # so no other engine may capture or replay (which adds its
        # capture's launches) meanwhile. A replay only enqueues the graph:
        # the lock is held for the host's enqueue, not the card's work
        with _GRAPH_LOCK:
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


class GangScheduledEngine:
    """The PREVIOUS execution model, kept as the baseline and the
    equivalence reference of the ragged engine: an admitted request
    prefills alone at batch 1 into its slot (``_SlotView``), and every
    decode step gang-schedules the whole batch, one token a row, through
    the gang-decode kernel (``paged_attention``, one call a layer) over
    the shared pool. Eager: the prefill shapes vary with each prompt, as
    in the reference, which compiles no step either.

    Rows without a request write their token to a reserved trash block
    and attend over nothing. Admission reserves a request's worst case
    (prompt + max_new_tokens) in blocks; a head of the queue that waited
    ``preempt_after`` steps preempts the LIFO victim, which re-prefills
    its prompt and generated tokens when readmitted. The pool lives on the
    model's device."""

    def __init__(self, model, max_batch: int, num_blocks: int,
                 block_size: int = 64,
                 max_blocks_per_seq: Optional[int] = None,
                 eos_token_id: Optional[int] = None,
                 temperature: float = 0.0, top_k: int = 0,
                 top_p: float = 1.0, preempt_after: Optional[int] = None):
        _no_perf_attribution()
        cfg = model.config
        self.model = model
        self.device = model.device
        self.eos = eos_token_id
        self.sampling = dict(temperature=temperature, top_k=top_k,
                             top_p=top_p)
        mb = max_blocks_per_seq or (
            -(-cfg.max_position_embeddings // block_size))
        self.cache = PagedKVCache(
            cfg.num_hidden_layers, max_batch, num_blocks=num_blocks,
            block_size=block_size, num_kv_heads=cfg.num_key_value_heads,
            head_dim=cfg.hidden_size // cfg.num_attention_heads,
            max_blocks_per_seq=mb, dtype=cfg.dtype,
            kv_dtype=str(_flags.get_flag("kv_cache_dtype")),
            device=self.device)
        if int(_flags.get_flag("speculative_k")) > 0:
            # the gang decode is strictly one token a row; speculation
            # exists only in the ragged engine
            S.record_fallback("spec", "spec_gang_engine",
                              "gang-scheduled engine ignores speculative_k")
        self.block_size = block_size
        self.max_batch = max_batch
        # one reserved block absorbs the writes of inactive rows
        self._trash_slot = self.cache._free.pop() * block_size
        self.slots: List[Optional[Request]] = [None] * max_batch
        self.pending: deque[Request] = deque()
        self.results: Dict[int, Request] = {}
        self.tok = np.zeros((max_batch, 1), np.int32)
        self.pos = np.zeros((max_batch,), np.int32)
        self._next_rid = 0
        self._admit_seq = 0
        self.steps = 0
        self.prefills = 0
        self.preempt_after = preempt_after
        self._head_waited = 0
        self.preempt_count = 0

    # -- request intake ------------------------------------------------------
    def add_request(self, prompt, max_new_tokens: int = 32) -> int:
        rid = self._next_rid
        self._next_rid += 1
        req = Request(rid, np.asarray(prompt, np.int32).reshape(-1),
                      max_new_tokens)
        total_pool = (len(self.cache._free)
                      + int(self.cache._allocated.sum()))
        if self._blocks_needed(req) > total_pool:
            raise ValueError(
                f"request needs {self._blocks_needed(req)} blocks but the "
                f"pool only has {total_pool}: it could never be admitted")
        self.pending.append(req)
        self.results[rid] = req
        return rid

    def _blocks_needed(self, req: Request) -> int:
        return -(-(len(req.prompt) + req.max_new_tokens)
                 // self.block_size)

    def _outstanding_reservation(self) -> int:
        return sum(self._blocks_needed(r)
                   - int(self.cache._allocated[r.slot])
                   for r in self.slots if r is not None)

    @torch.no_grad()
    def _admit(self):
        for i in range(self.max_batch):
            if not self.pending:
                return
            if self.slots[i] is not None:
                continue
            req = self.pending[0]
            if (self._blocks_needed(req)
                    > len(self.cache._free)
                    - self._outstanding_reservation()):
                return                 # reservation: wait for reclaims
            self.pending.popleft()
            self._head_waited = 0
            req.slot = i
            req.admit_order = self._admit_seq
            self._admit_seq += 1
            self.slots[i] = req
            # a preempted request resumes by re-prefilling its prompt and
            # what it generated (recompute on resume)
            full = (np.concatenate([req.prompt,
                                    np.asarray(req.out_tokens[:-1],
                                               np.int32)])
                    if req.out_tokens else req.prompt)
            ids = torch.from_numpy(full.reshape(1, -1)).to(self.device)
            logits = self.model(ids, cache=_SlotView(self.cache, i),
                                start_pos=0)
            self.prefills += 1
            if req.out_tokens:
                # resumed: the next input token was sampled already
                self.tok[i, 0] = req.out_tokens[-1]
            else:
                nxt = S.sample_logits(logits[:, -1, :], **self.sampling)
                first = int(nxt.reshape(-1)[0])
                req.out_tokens.append(first)
                self.tok[i, 0] = first
            self.cache.context_lens[i] = len(full)
            self.pos[i] = len(full)
            self._finish_if_done(req)

    def _finish_if_done(self, req: Request) -> bool:
        if (len(req.out_tokens) >= req.max_new_tokens
                or (self.eos is not None and req.out_tokens
                    and req.out_tokens[-1] == self.eos)):
            req.done = True
            self._release_slot(req.slot)
            return True
        return False

    def _release_slot(self, i: int):
        self.cache.release(i)
        self.slots[i] = None
        self.pos[i] = 0
        self.tok[i, 0] = 0

    # -- the gang-scheduled loop ---------------------------------------------
    @property
    def num_active(self) -> int:
        return sum(1 for r in self.slots if r is not None)

    def _preempt_lifo(self):
        victim = max((r for r in self.slots if r is not None),
                     key=lambda r: r.admit_order, default=None)
        if victim is None:
            return
        self._release_slot(victim.slot)
        victim.slot = None
        victim.preemptions += 1
        self.preempt_count += 1
        self.pending.insert(1, victim)  # right behind the starved head

    @torch.no_grad()
    def step(self) -> List[Request]:
        """Admit, then one decode step for every active slot. Returns the
        requests that finished during this step."""
        _no_perf_attribution()
        self._admit()
        if self.pending and self.preempt_after is not None:
            self._head_waited += 1
            if self._head_waited > self.preempt_after:
                self._preempt_lifo()
                self._head_waited = 0
                self._admit()
        if self.num_active == 0:
            return []
        # per-row write slots: active rows append at pos; inactive rows
        # overwrite the reserved trash block
        slot_vec = np.full((self.max_batch,), self._trash_slot, np.int64)
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            p = int(self.pos[i])
            blk = self.cache._ensure_block(i, p)
            slot_vec[i] = blk * self.block_size + p % self.block_size
            self.cache.context_lens[i] = p + 1  # visible to the attend
        dev = self.device
        self.cache.set_decode_override(torch.from_numpy(slot_vec).to(dev))
        try:
            logits = self.model(
                torch.from_numpy(self.tok).to(dev), cache=self.cache,
                start_pos=torch.from_numpy(self.pos).to(dev))
            nxt = S.sample_logits(logits[:, -1, :], **self.sampling)
        finally:
            self.cache.set_decode_override(None)
        self.steps += 1
        sampled = _host_read(nxt)
        finished = []
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            tok = int(sampled[i])
            req.out_tokens.append(tok)
            self.pos[i] += 1
            self.tok[i, 0] = tok
            if self._finish_if_done(req):
                finished.append(req)
        return finished

    def run(self) -> Dict[int, List[int]]:
        """Drive until every request (queued + active) completes."""
        while self.pending or self.num_active:
            self.step()
        return {rid: r.out_tokens for rid, r in self.results.items()}
