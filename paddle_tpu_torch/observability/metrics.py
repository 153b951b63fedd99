"""Process-wide metrics registry: counters, gauges, timing histograms.

Counterpart of ``paddle_tpu/observability/metrics.py``, the same classes,
names, label rules, delta wire format and dumpers: instruments stay
registered for the life of the process, an increment takes one
uncontended lock, and a disabled registry (``FLAGS_metrics=False``)
reduces every increment to one flag read.

* Every instrument guards its mutation with its own ``threading.Lock``,
  so counts stay exact under threads.
* Gauges may wrap a callback (``fn=...``) evaluated only at snapshot
  time: how the device readings publish at no cost on the hot path.
* Snapshots are plain dicts; :meth:`MetricsRegistry.dump_json` and
  :meth:`MetricsRegistry.dump_prometheus` render them. Prometheus names
  are the metric names with characters outside ``[a-zA-Z0-9_:]`` mapped
  to ``_`` and a ``paddle_`` prefix.

The reference's ambient gauges read JAX (live arrays, device count) and
a ``jax.monitoring`` listener counts XLA compiles. Here the gauges read
torch's caching allocator on the current card and
``torch.cuda.device_count()``; there is no compile listener, so
``jit.compiles`` and ``jit.compile_seconds`` are not registered.
"""

from __future__ import annotations

import bisect
import json
import re
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from .. import flags as _flags

# the on/off switch: one dict read on the disabled path
_V = _flags._VALUES


# The framework's frozen metric taxonomy, the reference's: every name the
# framework itself registers (ops teams scrape these). USER code may
# register any name it likes; this set governs framework sources only
# (tests/test_torch_observability.py checks the port's registrations
# against it). Adding a metric = adding it here first.
METRIC_NAMES = frozenset({
    # ops/dispatcher.py
    "dispatch.count", "dispatch.bind_fast", "dispatch.bind_slow",
    "dispatch.exec_cache.hits", "dispatch.exec_cache.misses",
    "dispatch.exec_cache.size",
    # autograd/engine.py
    "autograd.backward.count", "autograd.fused.plan_seconds",
    "autograd.fused.exec_seconds", "autograd.fused.primed",
    "autograd.fused.hit", "autograd.fused.fallback",
    "autograd.fused.compile", "autograd.fused.bypass",
    # static/executor.py
    "executor.runs", "executor.compiles", "executor.scope_vars",
    # distributed/collective.py
    "distributed.collective_calls",
    # ops/kernels/pallas/tp_attention.py (+ aot.py readers)
    "tp_attention.sharded", "tp_attention.fallback",
    # optimizer/optimizer.py (fused megakernel route)
    "optimizer.fused.buckets", "optimizer.fused.updates",
    "optimizer.fused.fallbacks",
    # jit/step_capture.py
    "step_capture.probes", "step_capture.captures",
    "step_capture.replays", "step_capture.fallbacks",
    "step_capture.bypass", "step_capture.invalidations",
    "step_capture.static_screened",
    # jit/multi_step.py (K-step block capture)
    "multi_step.blocks", "multi_step.replays", "multi_step.fallbacks",
    "multi_step.tail_steps",
    # distributed/resilience/checkpointer.py
    "checkpoint.snapshot_seconds", "checkpoint.write_seconds",
    "checkpoint.committed", "checkpoint.aborted",
    # distributed/resilience/trainer.py
    "resilience.preemptions", "resilience.rank_deaths",
    "resilience.restores", "resilience.resume_step",
    # distributed/resilience/anomaly.py + trainer.py (numerical faults)
    "anomaly.nonfinite_steps", "anomaly.skipped_updates",
    "anomaly.loss_spikes", "anomaly.rewinds", "anomaly.rewind_seconds",
    # models/serving.py (ragged continuous-batching engine)
    "serving.steps", "serving.step_tokens", "serving.generated_tokens",
    "serving.prefill_tokens", "serving.admitted", "serving.finished",
    "serving.preemptions", "serving.queue_depth", "serving.active_rows",
    "serving.prefill_backlog_tokens", "serving.free_blocks",
    "serving.prefix_cache.hit_blocks", "serving.prefix_cache.miss_blocks",
    "serving.prefix_cache.shared_tokens", "serving.prefix_cache.evictions",
    "serving.cow_copies", "serving.ttft_seconds", "serving.tpot_seconds",
    "serving.queue_wait_seconds", "serving.rejected",
    # int8 paged KV pool + speculative decoding (models/serving.py,
    # ops/kernels/serving.py)
    "serving.kv.bytes_per_token", "serving.kv.dequant_blocks",
    "serving.kv.fallback", "serving.spec.proposed",
    "serving.spec.accepted", "serving.spec.rejected",
    "serving.spec.verify_rows", "serving.spec.fallback",
    # serving/resilience/ (request journal + replay, drain, warm-start)
    "serving.resilience.journal_records",
    "serving.resilience.journal_flushes",
    "serving.resilience.journal_compactions",
    "serving.resilience.replayed_requests",
    "serving.resilience.replayed_tokens",
    "serving.resilience.recovered_finished",
    "serving.resilience.drains", "serving.resilience.drain_seconds",
    "serving.resilience.snapshots", "serving.resilience.warm_blocks",
    "serving.resilience.step_hangs",
    # serving/fleet/ (multi-replica router: health, failover, shedding)
    "fleet.replicas_ready", "fleet.replicas_dead", "fleet.queue_depth",
    "fleet.submitted", "fleet.completed", "fleet.retries", "fleet.sheds",
    "fleet.rerouted_requests", "fleet.replica_deaths", "fleet.drains",
    "fleet.restarts", "fleet.affinity_hits", "fleet.handoff_seconds",
    "fleet.replica_state",
    # observability/exporter.py (scrape-time RED SLIs + self-instrumentation)
    "fleet.sli.availability", "fleet.sli.shed_rate",
    "fleet.sli.ttft_p99_seconds", "fleet.sli.tpot_p99_seconds",
    "telemetry.scrapes", "telemetry.scrape_seconds",
    # observability/tracing.py (end-to-end span subsystem)
    "tracing.spans", "tracing.events",
    # observability/incident.py (incident forensics plane)
    "incident.recorded", "incident.dropped", "incident.write_seconds",
    # observability/perf.py (executable ledger + step decomposition)
    "perf.samples", "perf.regression", "perf.ledger.dropped",
    "perf.executable.calls", "perf.executable.wall_seconds",
    "perf.executable.device_seconds", "perf.executable.flops_per_s",
    "perf.executable.bytes_per_s", "perf.executable.mfu",
    "perf.step.seconds", "perf.step.data_wait_seconds",
    "perf.step.host_dispatch_seconds", "perf.step.device_seconds",
    "perf.step.other_seconds",
    # this module's ambient gauges (+ the reference's compile listener)
    "device.live_array_bytes", "device.live_arrays", "device.count",
    "jit.compiles", "jit.compile_seconds",
    # jit/exec_store.py — the persistent executable cache
    "jit.cache.hits", "jit.cache.misses", "jit.cache.load_seconds",
    "jit.cache.bytes",
})

# default histogram bounds: geometric, 1µs .. ~67s — sized for wall-time
# observations in seconds (compile times, backward plan/exec times)
_TIMING_BOUNDS = tuple(1e-6 * 2 ** i for i in range(27))

# Labels: instruments may carry a small frozen label set
# (``labels={"replica": "r0", "tenant": "acme"}``). A labeled
# instrument is an ordinary child of its *family* (the bare name): same
# class, own lock, registered under the rendered key ``name{k="v"}``.
# Exposition emits one HELP/TYPE pair per family and one sample line
# per child. Label sets freeze at registration time into sorted
# (key, value) str tuples; the cap keeps cardinality honest — fleet
# attribution needs replica + tenant, not a dimension explosion.
_MAX_LABELS = 4


def _freeze_labels(labels) -> Tuple[Tuple[str, str], ...]:
    if not labels:
        return ()
    if len(labels) > _MAX_LABELS:
        raise ValueError(
            f"at most {_MAX_LABELS} labels per instrument, got {len(labels)}")
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _label_value(v: str) -> str:
    # Prometheus label-value escaping; also used for registry keys so a
    # rendered key is exactly the exposition series identity
    return v.replace("\\", r"\\").replace("\n", r"\n").replace('"', r'\"')


def _label_suffix(lt: Tuple[Tuple[str, str], ...],
                  extra: Optional[Tuple[str, str]] = None) -> str:
    pairs = list(lt) + ([extra] if extra is not None else [])
    if not pairs:
        return ""
    return "{" + ",".join(f'{k}="{_label_value(v)}"' for k, v in pairs) + "}"


class Counter:
    """Monotonic counter. ``inc`` is the hot-path API."""

    kind = "counter"
    __slots__ = ("name", "help", "labels", "_n", "_lock")

    def __init__(self, name: str, help: str = "",
                 labels: Tuple[Tuple[str, str], ...] = ()):
        self.name = name
        self.help = help
        self.labels = labels  # frozen ((key, value), ...); () = unlabeled
        self._n = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> None:
        if _V["metrics"]:
            with self._lock:
                self._n += n

    @property
    def value(self) -> int:
        return self._n

    def _reset(self) -> None:
        with self._lock:
            self._n = 0

    def snapshot(self) -> Dict[str, Any]:
        s = {"type": "counter", "value": self._n}
        if self.labels:
            s["name"] = self.name
            s["labels"] = dict(self.labels)
        return s


class Gauge:
    """Point-in-time value: ``set()`` it, or construct with ``fn=`` to
    evaluate lazily at snapshot time (zero hot-path cost)."""

    kind = "gauge"
    __slots__ = ("name", "help", "labels", "_v", "_fn", "_lock")

    def __init__(self, name: str, help: str = "",
                 fn: Optional[Callable[[], float]] = None,
                 labels: Tuple[Tuple[str, str], ...] = ()):
        self.name = name
        self.help = help
        self.labels = labels
        self._v = 0.0
        self._fn = fn
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        if _V["metrics"]:
            with self._lock:
                self._v = v

    @property
    def value(self) -> Optional[float]:
        if self._fn is not None:
            try:
                return self._fn()
            except Exception:
                return None  # callback gauges must never break a dump
        return self._v

    def _reset(self) -> None:
        with self._lock:
            self._v = 0.0

    def snapshot(self) -> Dict[str, Any]:
        s = {"type": "gauge", "value": self.value}
        if self.labels:
            s["name"] = self.name
            s["labels"] = dict(self.labels)
        return s


class Histogram:
    """Fixed-bound histogram with count/sum/min/max, tuned for timing
    observations in seconds (geometric 1µs..67s default bounds)."""

    kind = "histogram"
    __slots__ = ("name", "help", "labels", "_bounds", "_buckets", "_count",
                 "_sum", "_min", "_max", "_lock")

    def __init__(self, name: str, help: str = "",
                 bounds: Optional[Tuple[float, ...]] = None,
                 labels: Tuple[Tuple[str, str], ...] = ()):
        self.name = name
        self.help = help
        self.labels = labels
        self._bounds = tuple(bounds) if bounds is not None else _TIMING_BOUNDS
        self._buckets = [0] * (len(self._bounds) + 1)
        self._count = 0
        self._sum = 0.0
        self._min = None
        self._max = None
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        if not _V["metrics"]:
            return
        i = bisect.bisect_left(self._bounds, v)
        with self._lock:
            self._buckets[i] += 1
            self._count += 1
            self._sum += v
            if self._min is None or v < self._min:
                self._min = v
            if self._max is None or v > self._max:
                self._max = v

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def quantile(self, q: float) -> Optional[float]:
        """Upper-bound estimate of the ``q``-quantile: the smallest
        bucket bound whose cumulative count reaches ``q * count``,
        clamped to the observed max (the overflow bucket has no finite
        bound). None when nothing has been observed. Coarse by design —
        bounds are geometric — but monotone and cheap, which is what a
        retry-after hint or an SLO gate needs."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        with self._lock:
            if self._count == 0:
                return None
            need = q * self._count
            cum = 0
            for i, n in enumerate(self._buckets):
                cum += n
                if cum >= need and n:
                    if i < len(self._bounds):
                        return min(self._bounds[i], self._max)
                    return self._max
            return self._max

    def _reset(self) -> None:
        with self._lock:
            self._buckets = [0] * (len(self._bounds) + 1)
            self._count = 0
            self._sum = 0.0
            self._min = None
            self._max = None

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            nonzero = [(le, n) for le, n in zip(
                self._bounds + (float("inf"),), self._buckets) if n]
            s = {"type": "histogram", "count": self._count,
                 "sum": self._sum, "min": self._min, "max": self._max,
                 "avg": (self._sum / self._count) if self._count else None,
                 "buckets": nonzero}
        if self.labels:
            s["name"] = self.name
            s["labels"] = dict(self.labels)
        return s


class MetricsRegistry:
    """Name -> instrument map. get-or-create semantics: registering the
    same (name, labels) twice returns the existing instrument
    (kind-checked across the whole family — a counter family cannot
    grow a gauge child)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, Any] = {}   # rendered key -> instrument
        self._family_kind: Dict[str, type] = {}  # bare name -> class

    def _get_or_create(self, cls, name, labels=None, **kwargs):
        lt = _freeze_labels(labels)
        key = name + _label_suffix(lt)
        with self._lock:
            m = self._metrics.get(key)
            if m is not None:
                if not isinstance(m, cls):
                    raise TypeError(
                        f"metric '{key}' already registered as {m.kind}")
                return m
            fam = self._family_kind.get(name)
            if fam is not None and fam is not cls:
                raise TypeError(
                    f"metric family '{name}' already registered as "
                    f"{fam.kind}")
            m = cls(name, labels=lt, **kwargs)
            self._metrics[key] = m
            self._family_kind[name] = cls
            return m

    def counter(self, name: str, help: str = "",
                labels: Optional[Dict[str, str]] = None) -> Counter:
        return self._get_or_create(Counter, name, labels=labels, help=help)

    def gauge(self, name: str, help: str = "",
              fn: Optional[Callable[[], float]] = None,
              labels: Optional[Dict[str, str]] = None) -> Gauge:
        return self._get_or_create(Gauge, name, labels=labels, help=help,
                                   fn=fn)

    def histogram(self, name: str, help: str = "",
                  bounds: Optional[Tuple[float, ...]] = None,
                  labels: Optional[Dict[str, str]] = None) -> Histogram:
        return self._get_or_create(Histogram, name, labels=labels, help=help,
                                   bounds=bounds)

    def get(self, name: str, labels: Optional[Dict[str, str]] = None):
        return self._metrics.get(name + _label_suffix(_freeze_labels(labels)))

    def children(self, name: str) -> List[Any]:
        """Every instrument of the family ``name`` (unlabeled parent
        first, labeled children in label order)."""
        with self._lock:
            kids = [m for m in self._metrics.values() if m.name == name]
        return sorted(kids, key=lambda m: m.labels)

    def names(self) -> List[str]:
        return list(self._metrics)

    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        """Point-in-time plain-dict view of every instrument (callback
        gauges are evaluated here)."""
        with self._lock:
            items = list(self._metrics.items())
        return {name: m.snapshot() for name, m in items}

    def reset(self) -> None:
        """Zero every instrument's VALUE (definitions stay registered).
        Test/bench hygiene only — production counters are monotonic."""
        with self._lock:
            items = list(self._metrics.values())
        for m in items:
            m._reset()

    # -- mergeable deltas -----------------------------------------------------
    #
    # The fleet wire format: a worker calls delta_update(state) at each
    # heartbeat and ships the (usually tiny) result; the router calls
    # merge_delta(delta, labels={"replica": name}) to fold it into
    # labeled children of its own registry. Counters ship increments
    # (merge adds), gauges ship current values (merge overwrites),
    # histograms ship changed buckets by index (merge adds bucket-wise,
    # same bounds required). Callback gauges are skipped — they are
    # recomputable wherever a registry lives and may be expensive.

    def delta_update(self, state: Dict[str, Any],
                     prefixes: Optional[Tuple[str, ...]] = None
                     ) -> Dict[str, Any]:
        """Compact delta of every instrument's change since the last
        call with the same ``state`` dict (mutated in place). Only
        instruments whose name starts with one of ``prefixes`` are
        considered when given. Returns {} when nothing moved."""
        with self._lock:
            items = list(self._metrics.items())
        out: Dict[str, Any] = {}
        for key, m in items:
            if prefixes is not None and not m.name.startswith(prefixes):
                continue
            rec = None
            if isinstance(m, Counter):
                with m._lock:
                    n = m._n
                prev = state.get(key, 0)
                if n < prev:
                    state[key] = n   # instrument was reset: reseed, ship
                    continue         # nothing (a negative increment would
                                     # corrupt the merged child)
                if n != prev:
                    state[key] = n
                    rec = {"k": "c", "n": m.name, "v": n - prev}
            elif isinstance(m, Gauge):
                if m._fn is not None:
                    continue
                with m._lock:
                    v = m._v
                if state.get(key, 0.0) != v:
                    state[key] = v
                    rec = {"k": "g", "n": m.name, "v": v}
            else:  # Histogram
                with m._lock:
                    buckets = list(m._buckets)
                    cnt, tot = m._count, m._sum
                    mn, mx = m._min, m._max
                pb, pc, ps = state.get(key, (None, 0, 0.0))
                if cnt < pc:         # reset since last delta: reseed quietly
                    state[key] = (buckets, cnt, tot)
                    continue
                # never-observed histograms (cnt == pc == 0) ship
                # nothing — cold replicas must not emit empty series
                # the SLI joins would divide by
                if cnt != pc:
                    if pb is None:
                        pb = [0] * len(buckets)
                    db = [[i, b - p] for i, (b, p)
                          in enumerate(zip(buckets, pb)) if b != p]
                    rec = {"k": "h", "n": m.name, "c": cnt - pc,
                           "s": tot - ps, "b": db, "mn": mn, "mx": mx}
                    if m._bounds != _TIMING_BOUNDS:
                        rec["bd"] = list(m._bounds)
                    state[key] = (buckets, cnt, tot)
            if rec is not None:
                if m.labels:
                    rec["l"] = dict(m.labels)
                out[key] = rec
        return out

    def merge_delta(self, delta: Dict[str, Any],
                    labels: Optional[Dict[str, str]] = None) -> None:
        """Fold a :meth:`delta_update` result into this registry,
        get-or-creating children under ``labels`` (merged over any
        labels the record itself carries). Writes go straight to the
        instrument internals under the child lock — merging is
        control-plane work and must land even when ``FLAGS_metrics``
        is off locally. Histogram merges require identical bounds
        (ValueError otherwise)."""
        extra = dict(labels or {})
        for rec in delta.values():
            lab = dict(rec.get("l") or {})
            lab.update(extra)
            name, child_labels = rec["n"], (lab or None)
            if rec["k"] == "c":
                c = self.counter(name, labels=child_labels)
                with c._lock:
                    c._n += int(rec["v"])
            elif rec["k"] == "g":
                g = self.gauge(name, labels=child_labels)
                with g._lock:
                    g._v = rec["v"]
            else:
                bounds = tuple(rec["bd"]) if "bd" in rec else None
                h = self.histogram(name, labels=child_labels, bounds=bounds)
                if h._bounds != (bounds if bounds is not None
                                 else _TIMING_BOUNDS):
                    raise ValueError(
                        f"histogram '{name}': cannot merge across "
                        f"differing bounds")
                with h._lock:
                    for i, dn in rec["b"]:
                        h._buckets[i] += dn
                    h._count += rec["c"]
                    h._sum += rec["s"]
                    if rec["mn"] is not None and (
                            h._min is None or rec["mn"] < h._min):
                        h._min = rec["mn"]
                    if rec["mx"] is not None and (
                            h._max is None or rec["mx"] > h._max):
                        h._max = rec["mx"]

    # -- dumpers --------------------------------------------------------------

    def dump_json(self, indent: Optional[int] = None) -> str:
        return json.dumps(self.snapshot(), indent=indent, default=str)

    def dump_prometheus(self) -> str:
        """Prometheus text exposition format (0.0.4).

        Families come out in deterministic sorted order: one HELP/TYPE
        pair per family, then one sample per child (unlabeled parent
        first, labeled children in label order). Counters emit both the
        bare-name sample (compat with pre-label scrapers) and the
        spec's ``_total``-suffixed sample. HELP text is escaped per the
        format (``\\`` then newline)."""
        # One critical section covers the instrument list AND its
        # metadata: snapshotting first and re-locking for metas would
        # let a registration land between the two acquisitions and
        # yield a sample with no TYPE line.
        with self._lock:
            items = list(self._metrics.items())
        fams: Dict[str, List[Any]] = {}
        for _key, m in items:
            fams.setdefault(m.name, []).append(m)
        lines: List[str] = []
        for name in sorted(fams, key=_prom_name):
            children = sorted(fams[name], key=lambda m: m.labels)
            pname = "paddle_" + _prom_name(name)
            kind = children[0].kind
            help_ = next((c.help for c in children if c.help), "")
            if help_:
                esc = help_.replace("\\", r"\\").replace("\n", r"\n")
                lines.append(f"# HELP {pname} {esc}")
            lines.append(f"# TYPE {pname} {kind}")
            for c in children:
                s = c.snapshot()
                lab = _label_suffix(c.labels)
                if kind == "counter":
                    lines.append(f"{pname}{lab} {s['value']}")
                    lines.append(f"{pname}_total{lab} {s['value']}")
                elif kind == "gauge":
                    if s["value"] is not None:
                        lines.append(f"{pname}{lab} {_prom_num(s['value'])}")
                else:  # histogram: cumulative le buckets + _sum/_count
                    cum = 0
                    seen_inf = False
                    for le, n in s["buckets"]:
                        cum += n
                        inf = le == float("inf")
                        seen_inf = seen_inf or inf
                        le_s = "+Inf" if inf else _prom_num(le)
                        blab = _label_suffix(c.labels, ("le", le_s))
                        lines.append(f"{pname}_bucket{blab} {cum}")
                    # the snapshot elides zero buckets, so a zero-count
                    # inf bucket needs an explicit +Inf close
                    if not seen_inf:
                        blab = _label_suffix(c.labels, ("le", "+Inf"))
                        lines.append(f"{pname}_bucket{blab} {s['count']}")
                    lines.append(f"{pname}_sum{lab} {_prom_num(s['sum'])}")
                    lines.append(f"{pname}_count{lab} {s['count']}")
        return "\n".join(lines) + "\n"


def _prom_name(name: str) -> str:
    return re.sub(r"[^a-zA-Z0-9_:]", "_", name)


def _prom_num(v) -> str:
    f = float(v)
    return repr(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


def format_metrics(snapshot: Dict[str, Dict[str, Any]],
                   title: str = "Metrics") -> str:
    """A snapshot as a human-readable table."""
    rows = []
    for name in sorted(snapshot):
        s = snapshot[name]
        if s["type"] == "histogram":
            avg = s["avg"]
            val = (f"count={s['count']} sum={s['sum']:.6f}s"
                   + (f" avg={avg * 1e6:.1f}us" if avg is not None else ""))
        else:
            v = s["value"]
            val = "-" if v is None else (
                f"{v:.4g}" if isinstance(v, float) else str(v))
        rows.append((name, s["type"], val))
    name_w = max([len("Name")] + [len(r[0]) for r in rows]) + 2
    hdr = f"{'Name':<{name_w}}{'Type':<12}Value"
    width = max(len(hdr), *(name_w + 12 + len(r[2]) for r in rows)) \
        if rows else len(hdr)
    lines = ["-" * width, title, "-" * width, hdr, "-" * width]
    for n, t, v in rows:
        lines.append(f"{n:<{name_w}}{t:<12}{v}")
    lines.append("-" * width)
    return "\n".join(lines)


# -- process-wide registry -----------------------------------------------------

_REGISTRY = MetricsRegistry()


def registry() -> MetricsRegistry:
    return _REGISTRY


# -- ambient gauges: the card's memory and device count ----------------------

def _allocator_stat(key: str) -> float:
    """A statistic of torch's caching allocator on the current card (0
    before CUDA is initialized or where there is none)."""
    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return 0.0
    return float(torch.cuda.memory_stats().get(key, 0))


_REGISTRY.gauge(
    "device.live_array_bytes",
    help="bytes of live tensors on the current card (torch's caching "
         "allocator)",
    fn=lambda: _allocator_stat("allocated_bytes.all.current"))
_REGISTRY.gauge(
    "device.live_arrays",
    help="live allocations on the current card (torch's caching allocator)",
    fn=lambda: _allocator_stat("active.all.current"))
_REGISTRY.gauge("device.count", help="visible accelerator devices",
                fn=lambda: float(torch.cuda.device_count()))
