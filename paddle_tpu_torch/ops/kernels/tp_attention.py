"""Attention under tensor parallelism: counters and the fallback taxonomy.

Counterpart of ``paddle_tpu/ops/kernels/pallas/tp_attention.py``
(``TP_FALLBACK_REASONS`` :133-141, ``record_fallback``, the
``tp_attention.sharded`` / ``tp_attention.fallback`` counters, and the
entries ``sharded_flash_attention`` :201 / ``sharded_flash_varlen``
:242). The reference wraps its Pallas kernel in a ``shard_map`` over the
mesh's head axis. The port is one process per rank: the column-parallel
q/k/v projections already leave each rank its own ``hq / tp`` query and
``hk / tp`` kv heads, GQA groups intact (head blocks are contiguous, so
rank r's query heads map onto exactly its kv heads). So the registry's
``flash_attention`` and ``flash_attn_unpadded`` (``ops/kernels/nn.py``)
keep their one path, the ported flash or varlen kernels on the local
heads, and add one to ``tp_attention.sharded`` (:func:`count_sharded`)
where :func:`current_tp_context` is set; no collective is needed.

The global head counts are checked where the model is built
(:func:`tp_reason`): where ``hq % tp`` or ``hk % tp`` is not 0 the
reference falls back to its composite. The port's Llama then keeps q/k/v
whole on every rank, records the same taxonomy key and counter through
:func:`record_fallback`, and runs the flash kernels on all the heads
inside :func:`head_replicated`, which counts no sharded call (ROADMAP.md
§C). The reference records once per traced specialization, the port once
per call.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional, Tuple

from ...observability import flight_recorder as _flight
from ...observability import metrics as _metrics

_M_SHARDED = _metrics.registry().counter(
    "tp_attention.sharded",
    "attention calls under tensor parallelism that ran the kernels on "
    "the rank's own heads")
_M_FALLBACK = _metrics.registry().counter(
    "tp_attention.fallback",
    "attention calls under tensor parallelism whose heads do not cut "
    "over the ranks (run head-replicated)")

# the reference's frozen taxonomy, key for key; the port records only
# the two ``*_indivisible`` keys (Llama's attention, where it is built)
TP_FALLBACK_REASONS = frozenset({
    "flags_off",             # FLAGS_use_pallas_kernels disabled
    "heads_indivisible",     # num_heads % tp != 0
    "kv_heads_indivisible",  # kv_heads % tp != 0 (GQA replication)
    "shard_unsupported",     # the local shard is outside the kernels' cases
    "head_dim_mismatch",     # paged: q head_dim != pool head_dim
    "ring_head_replicated",  # ring attention running head-replicated
    "ragged_rows_replicated",  # ragged serving: rows stay replicated
})


_local = threading.local()


def current_tp_context():
    """``(model-parallel group, tp degree)`` under tensor parallelism
    (``fleet.mp_layers.tp_attention_context``), else None: also inside
    :func:`head_replicated`, where q/k/v hold every head."""
    if getattr(_local, "replicated", False):
        return None
    from ...distributed.fleet.mp_layers import tp_attention_context
    return tp_attention_context()


@contextlib.contextmanager
def head_replicated():
    """Attention calls inside hold every head on every rank: they are not
    counted as sharded."""
    prev = getattr(_local, "replicated", False)
    _local.replicated = True
    try:
        yield
    finally:
        _local.replicated = prev


def count_sharded() -> None:
    """One attention call under tensor parallelism on this rank's heads."""
    _M_SHARDED.inc()


def record_fallback(kind: str, key: str, reason: str) -> None:
    """Count a composite fallback under tensor parallelism and write it
    into the flight recorder. ``key`` must be a member of
    ``TP_FALLBACK_REASONS``; ``reason`` carries the shapes and degrees."""
    if key not in TP_FALLBACK_REASONS:
        raise ValueError(
            f"unregistered tp_attention fallback reason {key!r}: add it to "
            f"TP_FALLBACK_REASONS")
    _M_FALLBACK.inc()
    if _flight.enabled():
        _flight.recorder().record(f"tp_attention.fallback[{kind}]",
                                  (reason,), key)


def tp_reason(tp: int, hq: int, hk: int) -> Optional[Tuple[str, str]]:
    """``(taxonomy key, detail)`` where the global head counts do not cut
    over ``tp`` ranks, else None."""
    if hq % tp:
        return ("heads_indivisible",
                f"num_heads {hq} not divisible by tp degree {tp}")
    if hk % tp:
        return ("kv_heads_indivisible",
                f"kv_heads {hk} not divisible by tp degree {tp} "
                f"(GQA replication)")
    return None


def counters() -> dict:
    """``{"sharded": n, "fallback": n}``, the process-wide counts."""
    return {"sharded": _M_SHARDED.value, "fallback": _M_FALLBACK.value}
