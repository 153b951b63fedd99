"""Prefix-cache warm-start: snapshot published prefix blocks, preload
them into a relaunched server's pool.

Counterpart of ``paddle_tpu/serving/resilience/warm_cache.py``, over the
port's ``PagedKVCache``, whose ``k`` / ``v`` / ``k_scale`` / ``v_scale``
are lists of raw tensors on the card. The on-disk generation is the
reference's (``gen-<n>-<uid>/``: ``blocks.npz`` + ``meta.json`` +
``COMMITTED``; bf16 as its 2-byte pattern in ``uint16``; the reference's
dtype names in ``meta.json``), so a generation written by either package
preloads in the other.

The prefix cache maps sha256 *chain digests* of full prompt blocks to
pool block ids -- content-addressed, so a snapshot is just ``digest ->
KV block bytes`` with no reference to the dead process's block
numbering. On drain (and periodically) the tracked blocks are gathered
on the card, copied to the host and written as one committed generation;
on relaunch the newest committed generation is preloaded into freshly
allocated pool blocks through the port's ``paged_cache_write`` and
registered *evictable* -- warm capacity the allocator may reclaim, so
preloading never steals admission headroom. Recovered requests and new
traffic sharing those prompt heads then prefill from warm blocks instead
of recomputing them.

A geometry/dtype mismatch (different block size, kv heads, head dim,
storage regime or model fingerprint) refuses the preload rather than
serving another model's KV.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import time
import uuid
from typing import Optional

import numpy as np
import torch

from ...observability import flight_recorder as _flight
from ...observability import metrics as _metrics
from ...ops.dispatcher import call_op
from ...utils.durability import (fsync_write, latest_committed,
                                 read_committed_marker,
                                 write_committed_marker)

__all__ = ["snapshot_prefix_cache", "load_prefix_cache",
           "last_generation"]

_GEN_PREFIX = "gen-"
# incarnation fencing, same rationale as the journal's seg-<n>-<uid>: a
# wedged-then-unwedged previous process resuming from the same
# last_generation() must land its snapshot in its OWN directory, never
# interleave fsync_write renames inside one the relaunch is writing
_UID = uuid.uuid4().hex[:8]
# how long an UNCOMMITTED generation dir is presumed to be a live
# concurrent writer's in-flight snapshot rather than crash debris
_PRUNE_GRACE_S = 900.0

_M_SNAPSHOTS = _metrics.registry().counter(
    "serving.resilience.snapshots",
    help="prefix-cache snapshot generations committed")
_M_WARM = _metrics.registry().gauge(
    "serving.resilience.warm_blocks",
    help="prefix blocks preloaded warm at the last relaunch")


_record = _flight.record_event


def _dtype_name(dtype) -> str:
    """The reference's (numpy's) name of a dtype: ``"bfloat16"``, not
    ``"torch.bfloat16"``; a name passes through."""
    return str(dtype).removeprefix("torch.")


def _host_bytes(t: torch.Tensor) -> np.ndarray:
    """``t`` on the host as numpy: bf16 as its raw 16 bits (``uint16``,
    never through float32), other dtypes as themselves."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).cpu().numpy().view(np.uint16)
    return t.cpu().numpy()


def _model_fingerprint(model) -> str:
    """Cheap weights identity: config fields + strided probes of
    several parameters spread through the model (always including the
    first and last). A contiguous head-of-first-param slice would miss
    fine-tunes that freeze the embedding table or never touch row 0;
    strided sampling across layers catches any realistic weight update
    for a few KB copied to the host -- no full-model digest on the drain
    path. Each probe is one gather on the card and one copy to the host,
    and hashes the reference's bytes (bf16 as its 2-byte pattern), so
    both packages give one digest for the same weights."""
    h = hashlib.sha256()
    cfg = getattr(model, "config", None)
    if cfg is not None:
        h.update(repr(sorted(
            (k, v) for k, v in vars(cfg).items()
            if isinstance(v, (int, float, str, bool, type(None))))).encode())
    params = list(model.parameters())
    if params:
        picks = sorted({0, len(params) - 1,
                        *range(0, len(params),
                               max(1, len(params) // 8))})
        with torch.no_grad():
            for idx in picks:
                flat = params[idx].detach().reshape(-1)
                stride = max(1, int(flat.shape[0]) // 64)
                probe = flat[::stride][:64].contiguous()
                h.update(_host_bytes(probe).tobytes())
    return h.hexdigest()


def _meta(engine) -> dict:
    c = engine.cache
    pool = c.k[0]
    # serving weights are frozen: probe the model ONCE per engine, not
    # on every periodic snapshot (and not on the drain deadline path)
    fp = getattr(engine, "_warm_model_fp", None)
    if fp is None:
        fp = engine._warm_model_fp = _model_fingerprint(engine.model)
    return {
        "block_size": int(c.block_size),
        "num_layers": int(c.num_layers),
        "kv_heads": int(pool.shape[2]),
        "head_dim": int(pool.shape[3]),
        "dtype": _dtype_name(pool.dtype),
        # storage regime, not just element type: an int8 snapshot is
        # meaningless without its scales and a float snapshot has none,
        # so EITHER direction of mismatch must refuse -- the any-differing-
        # key check in load_prefix_cache covers both
        "kv_dtype": _dtype_name(c.kv_dtype),
        "model_fingerprint": fp,
    }


def last_generation(root: str) -> int:
    """Highest generation number present under ``root`` (committed or
    not), 0 when none: a relaunched server must continue the sequence,
    never rewrite an already-COMMITTED generation in place."""
    last = 0
    try:
        names = os.listdir(root)
    except OSError:
        return 0
    for name in names:
        if name.startswith(_GEN_PREFIX):
            try:
                last = max(last,
                           int(name[len(_GEN_PREFIX):].split("-")[0]))
            except ValueError:
                continue
    return last


def snapshot_prefix_cache(engine, root: str, gen: int,
                          keep: int = 2) -> Optional[str]:
    """Serialize every published prefix block (chain digest -> KV bytes,
    all layers) as one committed generation under ``root``. Returns the
    generation path, or None when the cache is empty."""
    pc = engine._pc
    # INSERTION order, not digest order: prefill publishes ascending
    # block indices, so a child's digest registers after its parent's --
    # a prefix of this list stays parent-closed and a truncated preload
    # doesn't waste pool blocks on children unreachable via lookup()
    items = list(pc._map.items())          # (digest, block id)
    if not items:
        return None
    digests = [d.hex() for d, _ in items]
    cache = engine.cache
    # gather the tracked blocks ON THE CARD before the copy: this runs on
    # the SIGTERM drain deadline, and a real pool is GB-sized while the
    # warm set is a handful of blocks
    ids = torch.as_tensor([b for _, b in items], dtype=torch.long,
                          device=cache.k[0].device)
    tags = [("k", cache.k), ("v", cache.v)]
    if cache.quantized:
        # int8 blocks are unusable without their per-token-slot scales:
        # the scale rows ride the snapshot under ks_/vs_ keys and replay
        # through the same paged_cache_write path on preload
        tags += [("ks", cache.k_scale), ("vs", cache.v_scale)]
    payload = {}
    with torch.no_grad():
        for tag, pools in tags:
            for layer in range(cache.num_layers):
                payload[f"{tag}_{layer}"] = _host_bytes(
                    pools[layer].index_select(0, ids))
    dtype_name = ("bfloat16" if cache.k[0].dtype == torch.bfloat16
                  else payload["k_0"].dtype.name)
    meta = _meta(engine)
    meta["payload_dtype"] = dtype_name
    meta["digests"] = digests
    path = os.path.join(root, f"{_GEN_PREFIX}{int(gen):08d}-{_UID}")
    os.makedirs(path, exist_ok=True)
    fsync_write(os.path.join(path, "blocks.npz"),
                lambda f: np.savez(f, **payload))
    fsync_write(os.path.join(path, "meta.json"),
                lambda f: f.write(json.dumps(meta).encode()))
    write_committed_marker(path, step=int(gen), blocks=len(items))
    _prune(root, keep)
    _M_SNAPSHOTS.inc()
    _record("serving.resilience.snapshot", (path, len(items)))
    return path


def _prune(root: str, keep: int) -> None:
    """Keep the newest ``keep`` committed generations; drop older
    committed ones and stale uncommitted debris. An uncommitted dir
    younger than the grace window is left alone: it may be a CONCURRENT
    incarnation's snapshot mid-write (the uid-fenced zombie scenario) --
    deleting it under the writer would crash a healthy server's
    fsync_write, not clean up debris."""
    committed = []
    try:
        names = os.listdir(root)
    except OSError:
        return
    now = time.time()
    for name in names:
        if not name.startswith(_GEN_PREFIX):
            continue
        sub = os.path.join(root, name)
        if not os.path.isdir(sub):
            continue
        if read_committed_marker(sub) is not None:
            committed.append(sub)
        else:
            try:
                fresh = now - os.path.getmtime(sub) < _PRUNE_GRACE_S
            except OSError:
                fresh = False          # already gone: nothing to keep
            if not fresh:
                shutil.rmtree(sub, ignore_errors=True)
    committed.sort(reverse=True)
    for sub in committed[keep:]:
        shutil.rmtree(sub, ignore_errors=True)


def _rows_to(host: np.ndarray, payload_dtype: Optional[str],
             device) -> torch.Tensor:
    """A payload array back on the card in its pool dtype (bf16 from its
    16 bits)."""
    if payload_dtype == "bfloat16":
        return torch.from_numpy(host.view(np.int16)).to(device).view(
            torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(host)).to(device)


def load_prefix_cache(engine, root: str) -> int:
    """Preload the newest committed snapshot generation into the
    engine's pool: each digest gets a fresh block, its KV bytes land
    through the port's ``paged_cache_write``, and the block registers in
    the prefix cache *evictable* (zero active holders) -- warm, but
    reclaimable, so admission headroom is unchanged. Returns the number
    of blocks preloaded (0 when no snapshot exists, geometry mismatches,
    or the pool has no room)."""
    path = latest_committed(root)
    if path is None:
        return 0
    try:
        with open(os.path.join(path, "meta.json"), encoding="utf-8") as f:
            meta = json.load(f)
    except OSError:
        return 0
    want = _meta(engine)
    if any(meta.get(k) != v for k, v in want.items()):
        _record("serving.resilience.warm_mismatch",
                (path, {k: (meta.get(k), v) for k, v in want.items()
                        if meta.get(k) != v}))
        return 0
    digests = [bytes.fromhex(d) for d in meta["digests"]]
    try:
        z = np.load(os.path.join(path, "blocks.npz"))
    except OSError:
        return 0
    cache = engine.cache
    with z:    # release the zip handle: _prune may rotate this gen away
        if z["k_0"].shape[0] != len(digests):
            # meta and payload disagree -- refuse, don't crash mid-init
            _record("serving.resilience.warm_mismatch",
                    (path, {"digests": len(digests),
                            "payload_blocks": int(z["k_0"].shape[0])}))
            return 0
        # never drain the free list completely: admissions come first
        n = min(len(digests), max(0, len(cache._free) - engine.max_batch))
        if n <= 0:
            _M_WARM.set(0.0)
            return 0
        blocks = [cache._free.pop() for _ in range(n)]
        bs = cache.block_size
        dev = cache.k[0].device
        slot_np = (np.asarray(blocks, np.int64)[:, None] * bs
                   + np.arange(bs)[None, :]).reshape(-1)
        slots = torch.as_tensor(slot_np, dtype=torch.int32, device=dev)
        tags = [("k", cache.k, meta.get("payload_dtype")),
                ("v", cache.v, meta.get("payload_dtype"))]
        if cache.quantized:
            # kv_dtype matched above, so the snapshot carries ks_/vs_
            # scale rows: the same one-scatter write, [BS, KV] trailing
            tags += [("ks", cache.k_scale, None), ("vs", cache.v_scale, None)]
        with torch.no_grad():
            for tag, pools, pdt in tags:
                for layer in range(cache.num_layers):
                    host = z[f"{tag}_{layer}"][:n]
                    rows = _rows_to(host, pdt, dev).reshape(
                        1, n * bs, *host.shape[2:])
                    pools[layer] = call_op("paged_cache_write",
                                           pools[layer], rows, slots)
    preloaded = 0
    for digest, block in zip(digests[:n], blocks):
        if engine._pc.register(digest, block):
            engine._pc.release_block(block)  # zero holders: warm+evictable
            preloaded += 1
        else:
            # digest already tracked (second preload, or the engine
            # served traffic first): hand the block straight back or
            # it leaks out of the pool forever
            cache._free.append(block)
    _M_WARM.set(float(preloaded))
    _record("serving.resilience.warm_start", (path, preloaded))
    return preloaded
