"""IncidentRecorder: one committed forensic bundle per terminal event.

Counterpart of ``paddle_tpu/observability/incident.py``. Every failure
detector of the port's serving stack -- the step-hang watchdog, the fleet
router's death-transition failover, the crash excepthook, ``/debugz``'s
manual trigger -- would otherwise leave the operator disconnected
artifacts (trace ring, flight recorder, metrics, journal) and, on the
``hang_exit`` path, none at all. This module assembles ONE bundle per
incident::

    <root>/incident-<step>-<uid>/
        incident.json   kind, step, trace_id, attrs, flags fingerprint
                        + values, python/torch/CUDA versions and the
                        card, pid
        stacks.json     classified all-thread host stacks (debug.py)
        stacks.txt      the same, human-readable
        trace.json      the tracing ring as Chrome-trace JSON
        flight.txt      flight-recorder tail
        metrics.json    full metrics-registry snapshot
        journal.json    journal watermarks (serving triggers only)
        COMMITTED       the durability marker -- readers resolve only
                        committed bundles, a writer killed mid-dump
                        leaves invisible debris, never a torn bundle

The reference's files and header keys, with two differences: the
versions name torch, CUDA and the card where the reference's name jax and
jaxlib, and there is no ``perf.json`` until the executable ledger
(``observability/perf.py``) is ported (ROADMAP.md, A9).

Discipline:

* **Taxonomy.** ``kind`` must be a member of the frozen
  :data:`INCIDENT_KINDS` (the reference's), validated at record time.
* **Gating.** ``FLAGS_incident_recorder=False`` short-circuits
  :func:`record_incident` to a single flag read.
* **Rate limit.** At most one bundle per kind per
  ``FLAGS_incident_rate_limit_s`` (a flapping sentinel must not fill
  the disk); suppressed triggers count into ``incident.dropped``.
* **Retention.** After each commit, committed bundles beyond the
  newest ``FLAGS_incident_keep`` are pruned.
* **Synchronous.** Assembly runs on the caller's thread -- the
  ``hang_exit`` path records the bundle and then dies; there is no
  background writer to lose a race against ``os._exit``.

Roots resolve in order: an explicit ``root=`` at the call site (the
engine and the router pass their own ``<root>/incidents``), then
``FLAGS_incident_dir``, then the process-wide root from
:func:`attach_root` (first attach wins). With no root the trigger is
counted as dropped -- except callers that pass ``fallback_stderr=True``
(the die-now paths), which get the classified stacks + flight tail on
stderr instead of silence.
"""

from __future__ import annotations

import io
import json
import os
import shutil
import sys
import threading
import time
import uuid
from typing import Any, Dict, List, Optional

import torch

from .. import flags as _flags
from ..utils import durability as _durability
from . import debug as _debug
from . import flight_recorder as _flight
from . import metrics as _metrics
from . import tracing as _tracing

__all__ = ["INCIDENT_KINDS", "IncidentRecorder", "recorder",
           "record_incident", "attach_root", "recent_incidents"]

# one dict read on the disabled path
_V = _flags._VALUES

# The frozen incident taxonomy (the reference's): every kind the
# framework records, checked at record time. Adding a trigger = adding
# its kind here first.
INCIDENT_KINDS = frozenset({
    "serving.hang",           # serving step-hang watchdog fired
    "trainer.comm_timeout",   # comm watchdog flagged a wedged collective
    "trainer.rewind",         # anomaly escalation restored a generation
    "fleet.failover",         # router observed a death transition
    "perf.regression",        # perf sentinel breached its high-water mark
    "crash.exception",        # uncaught exception (chained excepthook)
    "debug.manual",           # operator-triggered via /debugz or the CLI
})

_REG = _metrics.registry()
_C_RECORDED = _REG.counter(
    "incident.recorded", help="incident bundles committed to disk")
_C_DROPPED = _REG.counter(
    "incident.dropped",
    help="incident triggers suppressed (rate limit, no root, or a "
         "bundle-assembly failure)")
_H_WRITE_SECONDS = _REG.histogram(
    "incident.write_seconds",
    help="wall time to assemble + commit one incident bundle")


def _versions() -> Dict[str, Any]:
    """Python, torch, CUDA and the card (the reference names jax and
    jaxlib here)."""
    out: Dict[str, Any] = {"python": sys.version.split()[0],
                           "torch": torch.__version__,
                           "cuda": torch.version.cuda, "card": None}
    try:
        if torch.cuda.is_available():
            out["card"] = torch.cuda.get_device_name(0)
    except Exception:
        pass               # forensics must not throw on the scan thread
    return out


def _json_bytes(obj: Any) -> bytes:
    return json.dumps(obj, indent=1, default=repr).encode()


class IncidentRecorder:
    """Assembles committed incident bundles under a root directory.

    Use the module-level :func:`record_incident` unless a test needs an
    isolated instance. All methods are thread-safe; :meth:`record` is
    synchronous by design (see module docstring)."""

    def __init__(self, root: Optional[str] = None):
        self._root = root
        self._lock = threading.Lock()
        self._last_by_kind: Dict[str, float] = {}
        # in-memory index for /debugz: survives retention pruning
        self._recent: List[Dict[str, Any]] = []

    # -- root resolution ------------------------------------------------------
    def attach_root(self, root: str) -> None:
        """Soft-attach a bundle root (first attach wins — in a fleet
        worker that is the engine's own ``<root>/incidents``)."""
        with self._lock:
            if self._root is None:
                self._root = root

    def resolve_root(self, override: Optional[str] = None) -> Optional[str]:
        if override:
            return override
        flag_dir = str(_V["incident_dir"] or "")
        return flag_dir or self._root

    # -- recording ------------------------------------------------------------
    def record(self, kind: str, *, root: Optional[str] = None,
               step: Optional[int] = None,
               attrs: Optional[Dict[str, Any]] = None,
               trace_id: Optional[int] = None,
               journal: Optional[Dict[str, Any]] = None,
               fallback_stderr: bool = False) -> Optional[str]:
        """Assemble + commit one bundle; returns its path, or None when
        the trigger was gated/suppressed. An unregistered ``kind``
        raises (the runtime half of the taxonomy check); everything
        past that point never does — a forensics failure must not take
        down the path being diagnosed."""
        if not _V["incident_recorder"]:
            # the die-now paths (hang_exit) still owe the operator an
            # attribution even with the recorder off: classified stacks
            # to stderr instead of a bundle
            if fallback_stderr:
                self._stderr_dump(kind, step, attrs)
            return None
        if kind not in INCIDENT_KINDS:
            raise ValueError(
                f"unregistered incident kind {kind!r} — add it to "
                f"observability.incident.INCIDENT_KINDS (frozen so "
                f"incident dashboards cannot fork)")
        dest = self.resolve_root(root)
        if dest is None:
            _C_DROPPED.inc()
            if fallback_stderr:
                self._stderr_dump(kind, step, attrs)
            return None
        now = time.monotonic()
        limit = float(_V["incident_rate_limit_s"])
        with self._lock:
            last = self._last_by_kind.get(kind)
            if limit > 0 and last is not None and now - last < limit:
                _C_DROPPED.inc()
                return None
            self._last_by_kind[kind] = now
        try:
            path = self._assemble(kind, dest, step, attrs, trace_id,
                                  journal)
        except Exception:
            _C_DROPPED.inc()
            if fallback_stderr:
                self._stderr_dump(kind, step, attrs)
            return None
        return path

    def _assemble(self, kind: str, dest: str, step: Optional[int],
                  attrs: Optional[Dict[str, Any]],
                  trace_id: Optional[int],
                  journal: Optional[Dict[str, Any]]) -> str:
        t0 = time.perf_counter()
        if trace_id is None:
            trace_id = _tracing.current_trace_id() or None
        with _tracing.span("observability.incident",
                           attrs={"kind": kind, "step": step}):
            uid = uuid.uuid4().hex[:8]
            bundle = os.path.join(dest, f"incident-{step or 0}-{uid}")
            os.makedirs(bundle, exist_ok=True)
            stacks = _debug.stacks_snapshot()
            header = {
                "kind": kind,
                "step": step,
                "unix_time": time.time(),
                "pid": os.getpid(),
                "trace_id": f"{trace_id:016x}" if trace_id else None,
                "attrs": attrs or {},
                "stack_classes": stacks["by_class"],
                "flags_version": _flags.version,
                "flags": dict(sorted(_V.items())),
                "versions": _versions(),
            }
            parts: Dict[str, bytes] = {
                "incident.json": _json_bytes(header),
                "stacks.json": _json_bytes(stacks),
                "stacks.txt":
                    _debug.format_stacks(stacks["stacks"]).encode(),
                "metrics.json":
                    _metrics.registry().dump_json(indent=1).encode(),
            }
            try:
                parts["trace.json"] = _tracing.dump_trace().encode()
            except Exception:
                pass           # a torn ring entry must not void the bundle
            if journal is not None:
                parts["journal.json"] = _json_bytes(journal)
            buf = io.StringIO()
            _flight.recorder().dump(buf)
            parts["flight.txt"] = buf.getvalue().encode()
            for name, payload in parts.items():
                _durability.fsync_write(
                    os.path.join(bundle, name),
                    lambda f, p=payload: f.write(p))
            _durability.write_committed_marker(
                bundle, step=step, kind=kind,
                trace_id=header["trace_id"])
            with self._lock:
                self._recent.append({
                    "kind": kind, "step": step, "path": bundle,
                    "unix_time": header["unix_time"],
                    "trace_id": header["trace_id"]})
                del self._recent[:-64]
            self._prune(dest)
        dt = time.perf_counter() - t0
        _C_RECORDED.inc()
        _H_WRITE_SECONDS.observe(dt)
        _flight.record_event("incident.recorded",
                             (kind, os.path.basename(bundle),
                              round(dt, 4)))
        return bundle

    def _prune(self, dest: str) -> None:
        keep = max(1, int(_V["incident_keep"]))
        committed: List[tuple] = []
        try:
            names = os.listdir(dest)
        except OSError:
            return
        for name in names:
            if not name.startswith("incident-"):
                continue
            sub = os.path.join(dest, name)
            md = _durability.read_committed_marker(sub)
            if md is None:
                continue
            committed.append((os.path.getmtime(sub), name, sub))
        committed.sort()
        for _mtime, _name, sub in committed[:-keep]:
            shutil.rmtree(sub, ignore_errors=True)

    # -- surfaces -------------------------------------------------------------
    def recent(self, n: int = 20) -> List[Dict[str, Any]]:
        """Newest-first in-memory index of bundles this process
        committed (the /debugz incident table)."""
        with self._lock:
            return list(reversed(self._recent[-n:]))

    def _stderr_dump(self, kind: str, step: Optional[int],
                     attrs: Optional[Dict[str, Any]]) -> None:
        """The rootless die-now path: classified stacks + flight tail
        to stderr so the wedge is attributed even with nowhere to
        commit a bundle."""
        try:
            sys.stderr.write(
                f"[paddle_tpu_torch incident] kind={kind} step={step} "
                f"attrs={attrs or {}} (no incident root attached — "
                f"stderr fallback)\n")
            sys.stderr.write(_debug.format_stacks())
            _flight.recorder().dump(sys.stderr)
            sys.stderr.flush()
        except Exception:
            pass               # best effort microseconds before _exit


# -- process-wide recorder ----------------------------------------------------

_RECORDER = IncidentRecorder()


def recorder() -> IncidentRecorder:
    return _RECORDER


def attach_root(root: str) -> None:
    """First-wins process-level bundle root (engines/trainers/routers
    attach their own ``<root>/incidents`` at construction)."""
    _RECORDER.attach_root(root)


def record_incident(kind: str, **kwargs: Any) -> Optional[str]:
    """Module-level shim over :meth:`IncidentRecorder.record` — the
    one call every trigger site uses (disabled cost: one flag read,
    paid inside :meth:`IncidentRecorder.record`)."""
    return _RECORDER.record(kind, **kwargs)


def recent_incidents(n: int = 20) -> List[Dict[str, Any]]:
    return _RECORDER.recent(n)


# -- crash excepthook trigger -------------------------------------------------

def _crash_incident(exc_type, exc_value) -> None:
    """Chained from flight_recorder._excepthook: bundle the crash when
    a root is attached (the stderr story is already covered by the
    flight-recorder + tracing crash dumps)."""
    if not _V["incident_recorder"]:
        return
    record_incident(
        "crash.exception",
        attrs={"exc_type": getattr(exc_type, "__name__", str(exc_type)),
               "exc": repr(exc_value)[:500]})
