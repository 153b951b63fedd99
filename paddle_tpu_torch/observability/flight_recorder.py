"""Always-on flight recorder: a post-mortem record of recent op dispatches.

Counterpart of ``paddle_tpu/observability/flight_recorder.py``: a bounded
ring holds the last N op dispatches (op name, a key, the recording
thread), so a crash report answers "what was the process doing?" without
a profiler attached.

Recording is gated by ``FLAGS_flight_recorder`` (default on) and costs one
ring-slot assignment a dispatch; the gate is one flag read. The recording
site is the port's op choke point (``ops/dispatcher.py:hooked``), where
the reference's ``call_op`` records, before the op runs, so the op that
raised is the newest entry. Where the reference records every op's
input shapes and dtypes, the port adds them to an op's entry only when
the op raises (:meth:`FlightRecorder.set_args_info`): the ops on the
failing call stack carry them, and a dispatch that succeeds pays no
shape read. A captured step (``jit.CapturedStep``, the
serving engine's step graph) records at its capture only: a replay runs
no Python. The ring dumps

* on an uncaught exception (a chained ``sys.excepthook`` installed when
  ``paddle_tpu_torch.observability`` is imported, writing to
  ``FLAGS_flight_recorder_path`` or stderr), and
* on :meth:`FlightRecorder.dump`.
"""

from __future__ import annotations

import sys
import threading
import time
from typing import Any, IO, List, Optional, Tuple

from .. import flags as _flags

_V = _flags._VALUES


class FlightRecorder:
    """Fixed-capacity ring of dispatch records.

    The hot-path :meth:`record` is intentionally lock-free: under the
    GIL a slot assignment is atomic, and a (rare) racing pair of
    threads can at worst interleave sequence numbers — acceptable for a
    post-mortem aid, and ~3x cheaper than taking a lock per dispatch.
    """

    __slots__ = ("_ring", "_cap", "_i")

    def __init__(self, capacity: int = 256):
        if capacity < 1:
            raise ValueError(f"flight recorder capacity must be >=1, "
                             f"got {capacity}")
        self._ring: List[Optional[tuple]] = [None] * capacity
        self._cap = capacity
        self._i = 0

    @property
    def capacity(self) -> int:
        return self._cap

    @property
    def total_recorded(self) -> int:
        return self._i

    def record(self, op_name: str, args_info: Optional[tuple],
               cache_key: Any = None) -> int:
        """Hot path: one tuple build + one ring-slot assignment. Returns
        the entry's sequence number.

        Indexes a LOCAL snapshot of the ring by its own length (not
        ``self._cap``) so a concurrent :meth:`resize` — which swaps
        ``_ring`` and ``_cap`` in two steps — can never produce an
        out-of-bounds slot."""
        i = self._i
        self._i = i + 1
        ring = self._ring
        ring[i % len(ring)] = (
            i, time.time(), threading.get_ident(), op_name, args_info,
            cache_key)
        return i

    def set_args_info(self, seq: int, args_info: tuple) -> None:
        """Put ``args_info`` into entry ``seq`` if the ring still holds
        it (the choke point's record of an op that raised)."""
        ring = self._ring
        slot = seq % len(ring)
        e = ring[slot]
        if e is not None and e[0] == seq:
            ring[slot] = e[:4] + (args_info,) + e[5:]

    def entries(self) -> List[tuple]:
        """Recorded entries, oldest (lowest sequence number) first.

        Entry: ``(seq, unix_time, thread_ident, op_name, args_info,
        cache_key)`` where ``args_info`` is a tuple of per-input
        ``(shape, dtype)`` pairs (or a bare marker for non-array args),
        or None for an op that did not raise.
        Sorting by the per-entry sequence number (instead of inferring
        order from the write index) stays correct across :meth:`resize`
        and racing writer threads.
        """
        return sorted((e for e in self._ring if e is not None),
                      key=lambda e: e[0])

    def clear(self) -> None:
        self._ring = [None] * self._cap
        self._i = 0

    def resize(self, capacity: int) -> None:
        """Re-pack the newest entries into a ring of the new capacity.

        Kept entries retain their sequence numbers; the write index is
        advanced to the first value past the newest kept sequence whose
        ring slot lands just after the kept block, so future writes
        evict oldest-first (sequence numbers may skip, never repeat)."""
        if capacity < 1:
            raise ValueError(f"flight recorder capacity must be >=1, "
                             f"got {capacity}")
        kept = self.entries()[-capacity:]
        ring: List[Optional[tuple]] = [None] * capacity
        ring[:len(kept)] = kept
        base = (kept[-1][0] + 1) if kept else 0
        self._ring = ring
        self._cap = capacity
        self._i = base + (len(kept) - base) % capacity

    def dump(self, file: Optional[IO[str]] = None) -> List[tuple]:
        """Write a human-readable dump (stderr by default); returns the
        entries so callers can post-process."""
        f = file if file is not None else sys.stderr
        ents = self.entries()
        n = len(ents)
        # the ambient trace_id (tracing.py) correlates this op-level ring
        # with the request/step span timeline in a crash report
        from . import tracing as _tracing
        tid = _tracing.current_trace_id()
        tid_s = f" trace_id={tid:016x}" if tid else ""
        f.write(f"[paddle_tpu_torch flight recorder] last {n} of "
                f"{self._i} op dispatches{tid_s} (newest last):\n")
        for seq, ts, tid, op, args_info, key in ents:
            args_s = ", ".join(_fmt_arg(a) for a in args_info) \
                if args_info else "-"
            key_s = "" if key is None else f" key={_fmt_key(key)}"
            f.write(f"  #{seq} t={ts:.6f} thread={tid} op={op} "
                    f"args=({args_s}){key_s}\n")
        f.flush()
        return ents


def _fmt_arg(a) -> str:
    if isinstance(a, tuple) and len(a) == 2:
        shape, dtype = a
        if isinstance(shape, tuple):
            dims = "x".join(map(str, shape)) if shape else "scalar"
            return f"{dims}:{str(dtype).removeprefix('torch.')}"
    return str(a)


def _fmt_key(key, limit: int = 120) -> str:
    s = repr(key)
    return s if len(s) <= limit else s[:limit - 3] + "..."


# -- process-wide recorder ----------------------------------------------------

_RECORDER: Optional[FlightRecorder] = None
_LOCK = threading.Lock()


def recorder() -> FlightRecorder:
    """The process-wide ring, created on first use with
    ``FLAGS_flight_recorder_size`` slots (a later ``set_flags`` on that
    flag resizes the live ring in place)."""
    global _RECORDER
    r = _RECORDER
    if r is None:
        with _LOCK:
            r = _RECORDER
            if r is None:
                cap = max(1, int(_flags.get_flag("flight_recorder_size")))
                r = _RECORDER = FlightRecorder(cap)
    return r


def _on_size_flag(value) -> None:
    # callers may hold the singleton, so the ring is resized IN PLACE
    rec = _RECORDER
    if rec is not None and rec.capacity != max(1, int(value)):
        rec.resize(max(1, int(value)))


_flags.on_set("flight_recorder_size", _on_size_flag)


def enabled() -> bool:
    return bool(_V["flight_recorder"])


def record_event(event: str, info: tuple) -> None:
    """Record a non-op EVENT (resilience transitions, drains,
    recoveries) — the shared shim for subsystems that annotate the op
    stream, so each doesn't carry a private enabled()-guarded copy."""
    if enabled():
        recorder().record(event, info, None)


def dump(file: Optional[IO[str]] = None) -> List[tuple]:
    """Dump the process-wide recorder (explicit ``dump()`` API)."""
    return recorder().dump(file)


# -- crash dump hook ----------------------------------------------------------

_prev_excepthook = None
_installed = False


def _crash_dump() -> None:
    rec = _RECORDER
    if rec is None or not _V["flight_recorder"] or rec.total_recorded == 0:
        return
    path = str(_flags.get_flag("flight_recorder_path") or "")
    if path:
        with open(path, "a") as f:
            rec.dump(f)
        sys.stderr.write(
            f"[paddle_tpu_torch flight recorder] dumped {min(rec.total_recorded, rec.capacity)} "
            f"dispatches to {path}\n")
    else:
        rec.dump(sys.stderr)


def _excepthook(exc_type, exc_value, exc_tb) -> None:
    # Ctrl-C / sys.exit are deliberate, not crashes: dumping 256 dispatch
    # records over the traceback would bury the one line that matters
    if not issubclass(exc_type, (KeyboardInterrupt, SystemExit)):
        try:
            _crash_dump()
        except Exception:
            pass  # the original traceback must always still print
        try:
            from . import tracing as _tracing
            _tracing._crash_dump()
        except Exception:
            pass  # same contract: the traceback outranks the span dump
        try:
            from . import incident as _incident
            _incident._crash_incident(exc_type, exc_value)
        except Exception:
            pass  # bundling is best-effort; the traceback still prints
    (_prev_excepthook or sys.__excepthook__)(exc_type, exc_value, exc_tb)


def install_excepthook() -> None:
    """Chain the crash dump in front of the current sys.excepthook
    (idempotent)."""
    global _prev_excepthook, _installed
    if _installed:
        return
    _installed = True
    _prev_excepthook = sys.excepthook
    sys.excepthook = _excepthook
