"""End-to-end tracing: request and step spans over a bounded ring.

Counterpart of ``paddle_tpu/observability/tracing.py``, with the same
API, span taxonomy and Chrome-trace export:

* a **span** is ``(trace_id, span_id, parent_id, name, t0..t1, events,
  attrs)``; completed spans land in a bounded per-process ring (one slot
  assignment, lock-free under the GIL), gated by ``FLAGS_tracing`` (one
  flag read when off);
* the ambient trace context propagates through **contextvars**: a span
  opened inside another becomes its child; across threads only when
  carried explicitly (:func:`activate`);
* **cross-process** propagation is explicit: :func:`inject` serializes
  the ambient context into two hex words, :func:`extract` +
  :func:`activate` re-establish it on the other side;
* export is **Chrome-trace JSON** (:func:`dump_trace`, for
  ``chrome://tracing`` / Perfetto), also handed to a sink
  (:func:`set_span_sink`) and dumped next to the flight recorder on an
  uncaught exception (:func:`_crash_dump`).

The span-name taxonomy is FROZEN (:data:`SPAN_NAMES`, the reference's):
runtime validation rejects unregistered names.

The reference also records a ``jit.compile`` span for every XLA compile
through a ``jax.monitoring`` listener; the port compiles no XLA program
and has no such listener.

Span phases for one served request::

    serving.queue      arrival -> row-slot admission
    serving.prefill    admission -> first token
    serving.decode     first token -> finish
    serving.step       one engine step (host schedule + model + sample)
"""

from __future__ import annotations

import contextvars
import itertools
import json
import os
import sys
import threading
import time
from typing import Any, Dict, IO, List, Optional, Tuple

from .. import flags as _flags
from . import metrics as _metrics

__all__ = [
    "SPAN_NAMES", "Span", "span", "start_span", "record_span", "instant",
    "event", "activate", "deactivate", "current", "current_trace_id",
    "inject", "extract", "enabled", "now_ns", "dump_trace", "to_chrome",
    "set_span_sink", "clear", "active_spans",
]

# one dict read on the disabled path
_V = _flags._VALUES

_M_SPANS = _metrics.registry().counter(
    "tracing.spans", help="completed spans recorded into the tracing ring")
_M_EVENTS = _metrics.registry().counter(
    "tracing.events", help="span events + instants recorded")


# The framework's frozen span taxonomy (the reference's): every span and
# span-event name the framework records. Runtime validation below
# rejects any other. USER code may trace any name it likes through the
# same calls only after adding it here.
SPAN_NAMES = frozenset({
    # serving/fleet/router.py — one request through the fleet
    "fleet.submit",            # span: submit -> durable ack on a replica
    "fleet.queue_full",        # event: a candidate refused admission
    "fleet.retry",             # event: all candidates full -> backoff round
    "fleet.shed",              # event: FleetShed raised (SLO / deadline)
    "fleet.replica_dead",      # event: READY->DEAD transition observed
    "fleet.failover",          # event: victim request settled from the log
    "fleet.handoff",           # event: parked request re-placed on survivor
    "fleet.drain",             # event: rolling-drain step
    "fleet.restart",           # event: replica restart initiated
    # serving/resilience/ — durability edges
    "serving.admit",           # span: admission incl. the durable journal ack
    "serving.journal_fsync",   # span: journal flush (tmp+fsync+rename)
    "serving.recover",         # span: journal load + replay re-admission
    "serving.drain",           # span: finish-or-journal-and-preempt drain
    "serving.step_hang",       # event: watchdog fired on a wedged step
    # models/serving.py — the ragged engine's per-request phases
    "serving.step",            # span: ONE ragged mixed prefill+decode step
    "serving.queue",           # span (retro): arrival -> row-slot admission
    "serving.prefill",         # span (retro): slot admission -> first token
    "serving.decode",          # span (retro): first token -> finish
    "serving.prefill_chunk",   # event: one prefill chunk committed
    "serving.first_token",     # event: the TTFT edge
    "serving.finish",          # event: request finished
    "serving.preempt",         # event: LIFO preemption victim
    # jit/step_capture.py — the training step
    "step_capture.capture",    # span: trace+lower+compile of a whole step
    "step_capture.replay",     # span: one captured-executable replay
    "step_capture.multi",      # span: one K-step block (capture or replay)
    # optimizer/optimizer.py
    "optimizer.update",        # span: one eager/traced optimizer.step()
    "optimizer.fused_update",  # span: the fused megakernel route's
    #                            bucketed apply inside optimizer.step()
    # distributed/resilience/
    "anomaly.verdict",         # event: non-OK AnomalyDetector verdict
    "checkpoint.snapshot",     # span: foreground device->host snapshot
    "checkpoint.commit",       # span: background serialize+fsync+commit
    # observability/incident.py — forensic bundle assembly
    "observability.incident",  # span: one incident bundle commit
    # observability/perf.py — retro step-decomposition segments laid
    # over each recorded step's interval
    "perf.step.data_wait",     # span (retro): blocked on the data pipeline
    "perf.step.host_dispatch",  # span (retro): step call -> async launch out
    "perf.step.device",        # span (retro): launch -> results host-visible
    "perf.step.other",         # span (retro): remainder (callbacks, logging)
    # the reference's jax.monitoring listener (none in the port)
    "jit.compile",             # span (retro): one XLA backend compile
    # jit/exec_store.py — the persistent executable cache
    "jit.cache.load",          # span: deserialize one cached executable
})

_EVENTS_MAX = 256             # per-span event cap (rings bound everything else)

now_ns = time.perf_counter_ns

# ambient (trace_id, span_id) — None outside any activated span
_CTX: contextvars.ContextVar = contextvars.ContextVar(
    "paddle_tpu_torch_trace", default=None)

# span ids: per-process random base + GIL-atomic counter — unique within
# a trace even when the parent process and a worker share it
_SID_BASE = int.from_bytes(os.urandom(8), "big") & ((1 << 63) - 1)
_SID_SEQ = itertools.count(1)

# live (unfinished) spans for the crash dump; plain dict ops are atomic
# under the GIL, so no lock on the span hot path
_ACTIVE: Dict[int, "Span"] = {}

# optional sink for completed spans (a profiler may merge them into its
# chrome trace while a record window is open)
_SINK = None


def enabled() -> bool:
    return bool(_V["tracing"])


def _new_trace_id() -> int:
    tid = int.from_bytes(os.urandom(8), "big") & ((1 << 63) - 1)
    return tid or 1            # 0 means "untraced" everywhere


def _new_span_id() -> int:
    return (_SID_BASE + next(_SID_SEQ)) & ((1 << 63) - 1)


def _check_name(name: str) -> None:
    if name not in SPAN_NAMES:
        raise ValueError(
            f"unregistered span name {name!r} — add it to "
            f"observability.tracing.SPAN_NAMES (frozen so timelines and "
            f"dashboards cannot fork)")


class Span:
    """One traced interval. Context-manager or explicit :meth:`end` —
    the explicit form serves cross-step phases a caller holds open (a
    request's life is not one stack frame). ``kind`` is ``"span"`` or
    ``"instant"`` (zero-duration point records share the ring)."""

    __slots__ = ("name", "trace_id", "span_id", "parent_id", "t0_ns",
                 "t1_ns", "tid", "attrs", "events", "kind", "_token",
                 "_ended")

    def __init__(self, name: str, trace_id: int, parent_id: int,
                 attrs: Optional[Dict[str, Any]] = None,
                 t0_ns: Optional[int] = None, kind: str = "span"):
        _check_name(name)
        self.name = name
        self.trace_id = trace_id
        self.span_id = _new_span_id()
        self.parent_id = parent_id
        self.t0_ns = now_ns() if t0_ns is None else t0_ns
        self.t1_ns: Optional[int] = None
        self.tid = threading.get_ident()
        self.attrs = attrs
        self.events: Optional[List[tuple]] = None
        self.kind = kind
        self._token = None
        self._ended = False

    # -- context --------------------------------------------------------------
    @property
    def context(self) -> Tuple[int, int]:
        """(trace_id, span_id) — what a child would inherit."""
        return (self.trace_id, self.span_id)

    def set(self, **attrs: Any) -> "Span":
        """Attach/overwrite attributes (rendered as chrome ``args``)."""
        if self.attrs is None:
            self.attrs = attrs
        else:
            self.attrs.update(attrs)
        return self

    def event(self, name: str, **attrs: Any) -> None:
        """Timestamped point annotation on THIS span (chrome ``"i"``)."""
        _check_name(name)
        evs = self.events
        if evs is None:
            evs = self.events = []
        if len(evs) < _EVENTS_MAX:
            evs.append((now_ns(), name, attrs or None))
            _M_EVENTS.inc()

    # -- lifecycle ------------------------------------------------------------
    def end(self) -> None:
        if self._ended:
            return
        self._ended = True
        self.t1_ns = now_ns()
        _ACTIVE.pop(self.span_id, None)
        if self._token is not None:
            _CTX.reset(self._token)
            self._token = None
        _ring().append(self)
        _M_SPANS.inc()
        sink = _SINK
        if sink is not None:
            try:
                sink(self)
            except Exception:
                pass       # a profiler-side bug must not break the traced path

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, *exc) -> bool:
        self.end()
        return False


class _NoopSpan:
    """The disabled path: every API returns this singleton; every method
    is a no-op, so a gated-off span costs one flag read + one call."""

    __slots__ = ()
    name = ""
    trace_id = 0
    span_id = 0
    parent_id = 0
    context = (0, 0)

    def set(self, **attrs):
        return self

    def event(self, name, **attrs):
        pass

    def end(self):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _NoopSpan()


# -- the bounded ring ---------------------------------------------------------

class _Ring:
    """Fixed-capacity ring of finished spans/instants — the flight
    recorder's lock-free discipline (one slot assignment per append)."""

    __slots__ = ("_ring", "_i")

    def __init__(self, capacity: int):
        self._ring: List[Optional[Span]] = [None] * max(1, int(capacity))
        self._i = 0

    def append(self, sp: Span) -> None:
        i = self._i
        self._i = i + 1
        ring = self._ring
        ring[i % len(ring)] = sp

    def entries(self) -> List[Span]:
        return sorted((e for e in self._ring if e is not None),
                      key=lambda s: s.t0_ns)

    def clear(self) -> None:
        self._ring = [None] * len(self._ring)
        self._i = 0

    @property
    def total(self) -> int:
        return self._i


_RING: Optional[_Ring] = None
_RING_LOCK = threading.Lock()


def _ring() -> _Ring:
    global _RING
    r = _RING
    if r is None:
        with _RING_LOCK:
            r = _RING
            if r is None:
                r = _RING = _Ring(int(_flags.get_flag("tracing_ring_size")))
    return r


def _on_ring_size(value) -> None:
    # swap wholesale: unlike the flight recorder nobody holds a direct
    # reference to the ring object, so replacement (keeping the newest
    # entries) is simpler than in-place surgery
    global _RING
    old = _RING
    if old is None:
        return
    fresh = _Ring(int(value))
    for sp in old.entries()[-max(1, int(value)):]:
        fresh.append(sp)
    _RING = fresh


_flags.on_set("tracing_ring_size", _on_ring_size)


def clear() -> None:
    """Drop every recorded span and instant (test/bench hygiene)."""
    if _RING is not None:
        _RING.clear()
    _ACTIVE.clear()


def active_spans() -> List[Span]:
    """Live (started, not ended) spans — what a crash dump adds."""
    return sorted(_ACTIVE.values(), key=lambda s: s.t0_ns)


# -- span creation ------------------------------------------------------------

def _parent(trace) -> Tuple[int, int]:
    """(trace_id, parent_span_id) from an explicit carrier or ambient."""
    if trace is not None:
        return int(trace[0]), int(trace[1])
    ctx = _CTX.get()
    if ctx is not None:
        return ctx
    return (_new_trace_id(), 0)


def span(name: str, *, trace=None, attrs=None):
    """Open an ACTIVATED span: it becomes the ambient context (children
    opened inside — same thread, or via an awaited contextvars copy —
    parent onto it) until :meth:`Span.end` restores the previous one.
    Use as a context manager. ``trace`` overrides the ambient parent
    with an explicit ``(trace_id, span_id)`` carrier."""
    if not _V["tracing"]:
        return _NOOP
    tid, parent = _parent(trace)
    sp = Span(name, tid, parent, attrs)
    _ACTIVE[sp.span_id] = sp
    sp._token = _CTX.set((tid, sp.span_id))
    return sp


def start_span(name: str, *, trace=None, attrs=None):
    """Open a NON-activating span (no contextvar mutation): for phases a
    caller holds across steps/threads and ends explicitly."""
    if not _V["tracing"]:
        return _NOOP
    tid, parent = _parent(trace)
    sp = Span(name, tid, parent, attrs)
    _ACTIVE[sp.span_id] = sp
    return sp


def record_span(name: str, t0_ns: int, t1_ns: int, *, trace=None,
                attrs=None) -> None:
    """Record a RETROACTIVE span from explicit perf_counter_ns stamps —
    for phases whose edges were observed before their duration was known
    (queue wait, prefill -> first token). ``trace=None`` means untraced
    (trace_id 0), NOT the ambient: phase segments always name their
    request explicitly."""
    if not _V["tracing"]:
        return
    tid, parent = (int(trace[0]), int(trace[1])) if trace is not None \
        else (0, 0)
    sp = Span(name, tid, parent, attrs, t0_ns=t0_ns)
    sp.t1_ns = t1_ns
    sp._ended = True
    _ring().append(sp)
    _M_SPANS.inc()
    sink = _SINK
    if sink is not None:
        try:
            sink(sp)
        except Exception:
            pass  # a profiler-side bug must not break the traced path


def instant(name: str, *, trace=None, attrs=None) -> None:
    """Record a point event straight into the ring (chrome ``"i"``) —
    for decisions with no natural open span (a failover settling a
    request whose submit span closed long ago). ``trace=None`` attaches
    to the ambient context if any, else records untraced."""
    if not _V["tracing"]:
        return
    if trace is not None:
        tid, parent = int(trace[0]), int(trace[1])
    else:
        ctx = _CTX.get()
        tid, parent = ctx if ctx is not None else (0, 0)
    sp = Span(name, tid, parent, attrs, kind="instant")
    sp.t1_ns = sp.t0_ns
    sp._ended = True
    _ring().append(sp)
    _M_EVENTS.inc()


def event(name: str, **attrs: Any) -> None:
    """Annotate the ambient ACTIVE span (falls back to an untraced
    instant when no span is active)."""
    if not _V["tracing"]:
        return
    ctx = _CTX.get()
    if ctx is not None:
        sp = _ACTIVE.get(ctx[1])
        if sp is not None:
            sp.event(name, **attrs)
            return
    instant(name, attrs=attrs or None)


# -- propagation --------------------------------------------------------------

def current() -> Optional[Tuple[int, int]]:
    """The ambient (trace_id, span_id), or None."""
    return _CTX.get()


def current_trace_id() -> int:
    ctx = _CTX.get()
    return ctx[0] if ctx is not None else 0


def activate(trace) -> Optional[contextvars.Token]:
    """Make an explicit (trace_id, span_id) carrier the ambient context;
    returns a token for :func:`deactivate`. The worker side of
    cross-process/cross-thread propagation."""
    if not _V["tracing"] or trace is None:
        return None
    return _CTX.set((int(trace[0]), int(trace[1])))


def deactivate(token: Optional[contextvars.Token]) -> None:
    if token is not None:
        _CTX.reset(token)


def inject() -> Optional[List[str]]:
    """The ambient context as two hex words for a wire frame (the fleet
    submit op's ``"tc"`` field); None when untraced/disabled."""
    if not _V["tracing"]:
        return None
    ctx = _CTX.get()
    if ctx is None:
        return None
    return [f"{ctx[0]:016x}", f"{ctx[1]:016x}"]


def extract(carrier) -> Optional[Tuple[int, int]]:
    """Parse :func:`inject`'s wire form back into a carrier tuple."""
    if not carrier:
        return None
    try:
        return (int(carrier[0], 16), int(carrier[1], 16))
    except (ValueError, TypeError, IndexError):
        return None            # a torn/foreign frame must not kill serving


# -- span sink ---------------------------------------------------------------

def set_span_sink(fn) -> None:
    """Install/remove (None) a callable receiving every completed Span.
    A profiler may set one while a record window is open, so spans land
    in its chrome trace alongside op/host events."""
    global _SINK
    _SINK = fn


# -- export -------------------------------------------------------------------

def _chrome_args(sp: Span) -> Dict[str, Any]:
    args: Dict[str, Any] = {}
    if sp.trace_id:
        args["trace_id"] = f"{sp.trace_id:016x}"
    if sp.kind == "span":
        args["span_id"] = f"{sp.span_id:016x}"
    if sp.parent_id:
        args["parent_id"] = f"{sp.parent_id:016x}"
    if sp.attrs:
        args.update(sp.attrs)
    return args


def to_chrome(extra_spans=()) -> Dict[str, Any]:
    """Ring + active spans as a Chrome-trace dict (``traceEvents`` with
    ``"X"`` duration and ``"i"`` instant phases, µs timestamps — the
    schema torch.profiler's Chrome export uses)."""
    pid = os.getpid()
    trace: List[Dict[str, Any]] = []
    now = now_ns()
    spans = list(_ring().entries()) if _RING is not None or enabled() else []
    live = active_spans()
    for sp in itertools.chain(spans, live, extra_spans):
        args = _chrome_args(sp)
        if sp.kind == "instant":
            trace.append({"name": sp.name, "ph": "i", "s": "t", "pid": pid,
                          "tid": sp.tid, "ts": sp.t0_ns / 1e3,
                          "cat": "Trace", "args": args})
            continue
        t1 = sp.t1_ns
        if t1 is None:         # still open: clip to now, mark active
            t1 = now
            args["active"] = True
        trace.append({"name": sp.name, "ph": "X", "pid": pid,
                      "tid": sp.tid, "ts": sp.t0_ns / 1e3,
                      "dur": (t1 - sp.t0_ns) / 1e3,
                      "cat": "Trace", "args": args})
        for ts, ev_name, ev_attrs in (sp.events or ()):
            trace.append({"name": ev_name, "ph": "i", "s": "t", "pid": pid,
                          "tid": sp.tid, "ts": ts / 1e3, "cat": "Trace",
                          "args": dict(ev_attrs or {},
                                       trace_id=f"{sp.trace_id:016x}",
                                       parent_id=f"{sp.span_id:016x}")})
    return {"traceEvents": trace, "displayTimeUnit": "ms"}


def dump_trace(file: Optional[Any] = None, indent: Optional[int] = None
               ) -> str:
    """Chrome-trace JSON of everything recorded (plus live spans).
    ``file`` may be a path or a writable; the JSON string is returned
    either way — ``json.loads``-able, loadable in chrome://tracing."""
    s = json.dumps(to_chrome(), indent=indent)
    if isinstance(file, str):
        with open(file, "w") as f:
            f.write(s)
    elif file is not None:
        file.write(s)
    return s


# -- crash dump (chained from flight_recorder._crash_dump) --------------------

def _crash_dump() -> None:
    """On uncaught exception: land the trace next to the flight
    recorder. ``FLAGS_tracing_path`` set → full Chrome-trace JSON there;
    otherwise a short human-readable span listing (active spans + newest
    completed) to stderr — a JSON blob over a traceback helps nobody."""
    if not _V["tracing"]:
        return
    live = active_spans()
    total = _RING.total if _RING is not None else 0
    if not live and total == 0:
        return
    path = str(_flags.get_flag("tracing_path") or "")
    if path:
        dump_trace(path)
        sys.stderr.write(
            f"[paddle_tpu_torch tracing] dumped {total} spans "
            f"(+{len(live)} active) to {path}\n")
        return
    ents = _ring().entries()[-16:]
    sys.stderr.write(
        f"[paddle_tpu_torch tracing] {len(live)} active spans, "
        f"last {len(ents)} of {total} completed (newest last):\n")
    for sp in ents:
        dur = (sp.t1_ns - sp.t0_ns) / 1e6 if sp.t1_ns is not None else 0.0
        sys.stderr.write(
            f"  trace={sp.trace_id:016x} {sp.kind} {sp.name} "
            f"dur={dur:.3f}ms\n")
    for sp in live:
        sys.stderr.write(
            f"  trace={sp.trace_id:016x} ACTIVE {sp.name} "
            f"started {(now_ns() - sp.t0_ns) / 1e6:.3f}ms ago\n")
    sys.stderr.flush()
