"""paddle_tpu_torch.observability: always-on metrics, flight recorder,
tracing and the ops endpoint.

Counterpart of ``paddle_tpu/observability/`` (its ``metrics``,
``tracing``, ``flight_recorder`` and ``exporter`` modules):

* a process-wide **metrics registry** (:mod:`.metrics`) of counters,
  gauges and timing histograms, thread-safe, one flag read when disabled
  (``FLAGS_metrics=False``), with JSON (:func:`dump_json`) and
  Prometheus-text (:func:`dump_prometheus`) dumpers. The serving engines
  publish their ``serving.*`` series here;
* an **always-on flight recorder** (:mod:`.flight_recorder`): a bounded
  ring of the last N op dispatches, dumped on an uncaught exception or by
  :func:`dump_flight_recorder`, gated by ``FLAGS_flight_recorder``;
* **request and step tracing** (:mod:`.tracing`): spans propagated
  through contextvars, recorded into a bounded ring and exported as
  Chrome-trace JSON (:func:`dump_trace`), gated by ``FLAGS_tracing``;
* a **live ops endpoint** (:mod:`.exporter`): a stdlib-HTTP thread
  serving ``/metrics``, ``/healthz`` (fleet or engine readiness),
  ``/statusz``, ``/trace`` and ``/debugz``, gated by
  ``FLAGS_telemetry_port`` (-1 off, 0 a free port). On a fleet router one
  scrape shows every replica: subprocess workers piggyback registry
  deltas on their heartbeats and the router merges them under a
  ``replica="<name>"`` label;
* the **incident forensics plane** (:mod:`.debug` + :mod:`.incident`):
  on-demand all-thread host stack capture classified against the frames
  the framework owns (data wait / graph capture or nvcc build / device
  call / collective / journal fsync / lock), and an
  :class:`IncidentRecorder` that assembles ONE committed
  ``incident-<step>-<uid>/`` bundle (stacks, trace ring, flight tail,
  metrics, flags) at every terminal transition -- a serving step hang, a
  fleet failover, an uncaught exception -- gated by
  ``FLAGS_incident_recorder`` with kinds frozen in
  :data:`incident.INCIDENT_KINDS`.

The reference's ``perf.py`` (the executable ledger behind
``FLAGS_perf_attribution`` and ``/perfz``) is not ported yet (ROADMAP.md,
A9).

Typical use::

    import paddle_tpu_torch.observability as obs

    obs.registry().counter("my.counter").inc()
    print(obs.dump_prometheus())          # scrape-able text
    obs.dump_trace("trace.json")          # chrome://tracing
"""

from __future__ import annotations

from . import debug, flight_recorder, metrics, tracing  # noqa: F401
from . import incident  # noqa: F401  (uses debug + the three above)
from . import exporter  # noqa: F401  (after its siblings: it uses them all)
from .exporter import (  # noqa: F401
    TelemetryServer,
    attach_engine as attach_telemetry_engine,
    attach_fleet as attach_telemetry_fleet,
    serve as serve_telemetry,
    shutdown as shutdown_telemetry,
)
from .debug import (  # noqa: F401
    STACK_CLASSES,
    capture_stacks,
    classify_frames,
    format_stacks,
)
from .incident import (  # noqa: F401
    INCIDENT_KINDS,
    IncidentRecorder,
    attach_root as attach_incident_root,
    recent_incidents,
    record_incident,
)
from .flight_recorder import (  # noqa: F401
    FlightRecorder,
    dump as dump_flight_recorder,
    install_excepthook,
    recorder as flight_recorder_instance,
)
from .metrics import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    format_metrics,
    registry,
)
from .tracing import (  # noqa: F401
    SPAN_NAMES,
    Span,
    current_trace_id,
    dump_trace,
    event,
    instant,
    record_span,
    span,
    start_span,
)


def snapshot():
    """Point-in-time dict view of every registered metric."""
    return metrics.registry().snapshot()


def dump_json(indent=None) -> str:
    """Registry snapshot as a JSON string."""
    return metrics.registry().dump_json(indent=indent)


def dump_prometheus() -> str:
    """Registry snapshot in Prometheus text exposition format."""
    return metrics.registry().dump_prometheus()


# the crash dump must work without any user setup: chain it now
install_excepthook()

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "FlightRecorder",
    "registry", "snapshot", "dump_json", "dump_prometheus",
    "format_metrics", "flight_recorder_instance", "dump_flight_recorder",
    "install_excepthook", "metrics", "flight_recorder",
    "tracing", "SPAN_NAMES", "Span", "span", "start_span", "record_span",
    "instant", "event", "dump_trace", "current_trace_id",
    "exporter", "TelemetryServer", "serve_telemetry", "shutdown_telemetry",
    "attach_telemetry_fleet", "attach_telemetry_engine",
    "debug", "STACK_CLASSES", "capture_stacks", "classify_frames",
    "format_stacks", "incident", "INCIDENT_KINDS", "IncidentRecorder",
    "record_incident", "recent_incidents", "attach_incident_root",
]
