"""Ops endpoint: /metrics, /healthz, /statusz, /trace, /debugz over
stdlib HTTP.

Counterpart of ``paddle_tpu/observability/exporter.py``: a
zero-dependency ``http.server`` thread over the process-wide
:mod:`~paddle_tpu_torch.observability.metrics` registry -- which, on a
fleet router, already holds every subprocess replica's heartbeat-merged
engine series labelled by replica name -- with health, status, trace and
forensics views.

Endpoints:

* ``/metrics``: Prometheus text exposition (0.0.4) of the whole registry.
  With a fleet attached, the scrape-time SLIs (``fleet.sli.*``:
  availability, shed rate, per-replica TTFT/TPOT p99) are refreshed here,
  as callback gauges over existing series.
* ``/healthz``: 200/503 readiness. Fleet attached: 200 iff at least one
  replica is READY (the body lists every replica's state). Engine
  attached: 200 iff the engine's ``phase`` is ``ready`` (an engine
  without a ``phase`` counts as ready). Nothing attached: 200 (process
  alive).
* ``/statusz``: a plain-text operator page: the flag values, torch's and
  CUDA's versions and the card's name, process vitals (uptime, RSS), the
  replica table, the attached engine and the flight recorder's tail.
* ``/trace``: the tracing ring as Chrome-trace JSON
  (:func:`tracing.to_chrome`).
* ``/debugz``: live incident forensics: every thread's host stack
  classified against the frames the framework owns (``debug.py``), the
  recent-incident index, and with ``?record=1`` an on-demand committed
  incident bundle (kind ``debug.manual``).
* ``/perfz`` answers 501: the reference's ``perf.py`` behind it is not
  ported yet (ROADMAP.md, A9).

Lifecycle: ``FLAGS_telemetry_port`` is -1 (off) by default; 0 binds a free
port (tests), > 0 binds that port. :func:`attach_fleet` (called by
``ReplicaRouter.start``) and :func:`attach_engine` start the server when
the flag says so; :func:`serve` starts it explicitly. The server thread
is a daemon and is also shut down at exit. It binds 127.0.0.1 only.
"""

from __future__ import annotations

import atexit
import json
import threading
import time
import weakref
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional

import torch

from .. import flags as _flags
from . import debug as _debug
from . import flight_recorder as _flight
from . import incident as _incident
from . import metrics as _metrics
from . import tracing as _tracing

__all__ = ["serve", "shutdown", "port", "attach_fleet", "attach_engine",
           "TelemetryServer"]

_REG = _metrics.registry()
_M_SCRAPES = _REG.counter(
    "telemetry.scrapes", help="/metrics requests served")
_M_SCRAPE_SECONDS = _REG.histogram(
    "telemetry.scrape_seconds",
    help="/metrics request handling wall time (server side)")

_T_START = time.time()
NOT_PORTED = {
    "/perfz": "the performance-attribution plane (observability/perf.py) "
              "is not ported yet: ROADMAP.md, A9",
}


def _rss_bytes() -> Optional[int]:
    """Resident set size; /proc when available, ru_maxrss (a high-water
    mark, close enough for an ops page) elsewhere, None if neither."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024
    except (OSError, ValueError, IndexError):
        pass
    try:
        import resource
        return int(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss) * 1024
    except Exception:
        return None


class TelemetryServer:
    """One HTTP server thread over the process registry. Use the
    module-level :func:`serve` / :func:`attach_engine` API unless you need
    an isolated instance (tests do)."""

    def __init__(self, registry: Optional[_metrics.MetricsRegistry] = None):
        self._registry = registry or _metrics.registry()
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        # weakrefs: the exporter observes the fleet and the engine, it
        # must not keep a closed router (and its engines and KV pools)
        # alive
        self._engine = lambda: None
        self._fleet = lambda: None
        self._sli_registered = False

    # -- lifecycle ------------------------------------------------------------
    @property
    def running(self) -> bool:
        return self._httpd is not None

    @property
    def port(self) -> Optional[int]:
        return None if self._httpd is None else self._httpd.server_port

    def serve(self, port: int = 0) -> int:
        """Start (idempotent) on 127.0.0.1:``port``; 0 picks a free
        port. Returns the bound port."""
        with self._lock:
            if self._httpd is not None:
                return self._httpd.server_port
            handler = _make_handler(self)
            httpd = ThreadingHTTPServer(("127.0.0.1", int(port)), handler)
            httpd.daemon_threads = True
            thread = threading.Thread(
                target=httpd.serve_forever, daemon=True,
                name="paddle-telemetry", kwargs={"poll_interval": 0.1})
            thread.start()
            self._httpd, self._thread = httpd, thread
            return httpd.server_port

    def shutdown(self) -> None:
        with self._lock:
            httpd, thread = self._httpd, self._thread
            self._httpd = self._thread = None
        if httpd is None:
            return
        httpd.shutdown()
        httpd.server_close()
        if thread is not None:
            thread.join(timeout=5.0)

    # -- attachment -----------------------------------------------------------
    def attach_fleet(self, router) -> None:
        """Point /healthz and the fleet SLIs at ``router`` (a
        :class:`~paddle_tpu_torch.serving.fleet.router.ReplicaRouter`),
        then start the server if ``FLAGS_telemetry_port`` asks for one."""
        self._fleet = weakref.ref(router)
        self._register_fleet_slis()
        self._maybe_serve_from_flag()

    def attach_engine(self, engine) -> None:
        """Point /healthz and /statusz at one serving engine, then start
        the server if ``FLAGS_telemetry_port`` asks for one."""
        self._engine = weakref.ref(engine)
        self._maybe_serve_from_flag()

    def _maybe_serve_from_flag(self) -> None:
        port = int(_flags.get_flag("telemetry_port"))
        if port >= 0 and not self.running:
            self.serve(port)

    # -- scrape-time SLIs -----------------------------------------------------
    def _register_fleet_slis(self) -> None:
        """Availability and shed rate as callback gauges over series
        the router already maintains, evaluated only when a scrape
        snapshots them."""
        if self._sli_registered:
            return
        self._sli_registered = True
        me = weakref.ref(self)

        def _availability() -> Optional[float]:
            self_ = me()
            router = self_ and self_._fleet()
            if router is None:
                return None
            states = [h.state for h in router._health.values()]
            return states.count("ready") / max(len(states), 1)

        def _shed_rate() -> Optional[float]:
            sheds = self._registry.get("fleet.sheds")
            submitted = self._registry.get("fleet.submitted")
            if sheds is None or submitted is None:
                return None
            offered = submitted.value + sheds.value
            return sheds.value / offered if offered else 0.0

        self._registry.gauge(
            "fleet.sli.availability",
            help="fraction of fleet replicas in the READY routing set",
            fn=_availability)
        self._registry.gauge(
            "fleet.sli.shed_rate",
            help="sheds / (submitted + sheds) over the process lifetime",
            fn=_shed_rate)

    def _quantile_children(self, family: str):
        """The pure per-replica children of a latency histogram family
        as (histogram, replica_name) pairs."""
        for h in self._registry.children(family):
            labels = dict(h.labels)
            rep = labels.get("replica")
            if rep is not None and len(labels) == 1:
                yield h, rep

    def _refresh_quantile_slis(self) -> None:
        """Get-or-create a p99 gauge per replica-labelled latency
        histogram. Runs per scrape (registration is idempotent); the
        gauge's callback reads the histogram at snapshot time."""
        for h, rep in self._quantile_children("serving.ttft_seconds"):
            self._registry.gauge(
                "fleet.sli.ttft_p99_seconds",
                help="p99 TTFT per replica (derived at scrape time)",
                fn=lambda h=h: h.quantile(0.99),
                labels={"replica": rep})
        for h, rep in self._quantile_children("serving.tpot_seconds"):
            self._registry.gauge(
                "fleet.sli.tpot_p99_seconds",
                help="p99 TPOT per replica (derived at scrape time)",
                fn=lambda h=h: h.quantile(0.99),
                labels={"replica": rep})

    # -- endpoint bodies ------------------------------------------------------
    def _metrics_body(self) -> str:
        self._refresh_quantile_slis()
        return self._registry.dump_prometheus()

    def _healthz(self):
        """(status_code, body_dict)."""
        router = self._fleet()
        if router is not None:
            states = {n: h.state for n, h in router._health.items()}
            ok = any(s == "ready" for s in states.values())
            return (200 if ok else 503), {
                "status": "ok" if ok else "unavailable",
                "replicas": states}
        engine = self._engine()
        if engine is not None:
            phase = getattr(engine, "phase", "ready")
            ok = phase == "ready"
            return (200 if ok else 503), {
                "status": "ok" if ok else "unavailable", "phase": phase}
        return 200, {"status": "ok", "detail": "process alive"}

    def _statusz_body(self) -> str:
        lines: List[str] = ["paddle_tpu_torch telemetry", ""]
        rss = _rss_bytes()
        lines.append(
            f"uptime_s: {time.time() - _T_START:.1f}   rss_mb: "
            f"{'n/a' if rss is None else format(rss / 2**20, '.1f')}")
        lines.append(f"flags.version: {_flags.version}")
        for name in sorted(_flags._VALUES):
            lines.append(f"  FLAGS_{name} = {_flags._VALUES[name]!r}")
        lines.append("")
        card = (torch.cuda.get_device_name(0) if torch.cuda.is_available()
                else "none")
        lines.append(f"torch: {torch.__version__}   cuda: "
                     f"{torch.version.cuda or 'n/a'}   card: {card}")
        router = self._fleet()
        if router is not None:
            lines += ["", "replicas:"]
            for name, handle in router._replicas.items():
                st = handle.status()
                lines.append(
                    f"  {name:<12} state={router._health[name].state:<9} "
                    f"phase={st.get('phase')} qd={st.get('queue_depth')} "
                    f"beat_age_s={st.get('beat_age_s'):.3f}")
        engine = self._engine()
        if engine is not None:
            lines += ["", f"engine: {type(engine).__name__} phase="
                          f"{getattr(engine, 'phase', 'ready')} "
                          f"steps={getattr(engine, 'steps', 'n/a')} "
                          f"active={getattr(engine, 'num_active', 'n/a')}"]
        tail = _flight.recorder().entries()[-20:]
        lines += ["", f"flight recorder tail ({len(tail)} of ring):"]
        for e in tail:
            lines.append(f"  {e}")
        return "\n".join(lines) + "\n"

    def _trace_body(self) -> str:
        return json.dumps(_tracing.to_chrome())

    def _debugz_body(self, record: bool = False) -> str:
        """Live forensics page: classified all-thread stacks + the
        recent-incident index; ``record=True`` commits an on-demand
        ``debug.manual`` bundle first and reports where it landed."""
        lines: List[str] = ["paddle_tpu_torch debugz", ""]
        if record:
            path = _incident.record_incident("debug.manual")
            if path is None:
                path = ("NOT RECORDED (recorder off, rate-limited, or "
                        "no root attached)")
            lines.append(f"bundle: {path}")
            lines.append("")
        snap = _debug.stacks_snapshot()
        by_cls = ", ".join(f"{k}={v}"
                           for k, v in sorted(snap["by_class"].items()))
        lines.append(f"threads: {snap['threads']}   classes: {by_cls}")
        lines.append("")
        lines.append(_debug.format_stacks(snap["stacks"]).rstrip("\n"))
        recent = _incident.recent_incidents()
        lines += ["", f"recent incidents ({len(recent)}):"]
        for inc in recent:
            lines.append(
                f"  {inc['kind']:<20} step={inc['step']} "
                f"trace={inc['trace_id'] or '-':<17} {inc['path']}")
        if not recent:
            lines.append("  (none recorded by this process)")
        return "\n".join(lines) + "\n"


def _make_handler(server: TelemetryServer):
    class _Handler(BaseHTTPRequestHandler):
        # one ops request must never block another behind a slow reader
        timeout = 10.0
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):   # quiet: no stderr spam
            pass

        def _send(self, code: int, body: str, ctype: str) -> None:
            data = body.encode("utf-8")
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self) -> None:
            path = self.path.split("?", 1)[0]
            try:
                if path == "/metrics":
                    t0 = time.perf_counter()
                    body = server._metrics_body()
                    # Record before sending: once the client has the
                    # body, this scrape must already be counted.
                    _M_SCRAPES.inc()
                    _M_SCRAPE_SECONDS.observe(time.perf_counter() - t0)
                    self._send(200, body,
                               "text/plain; version=0.0.4; charset=utf-8")
                elif path == "/healthz":
                    code, payload = server._healthz()
                    self._send(code, json.dumps(payload) + "\n",
                               "application/json")
                elif path == "/statusz":
                    self._send(200, server._statusz_body(),
                               "text/plain; charset=utf-8")
                elif path == "/trace":
                    self._send(200, server._trace_body(),
                               "application/json")
                elif path == "/debugz":
                    query = self.path.partition("?")[2]
                    self._send(200,
                               server._debugz_body(
                                   record="record=1" in query),
                               "text/plain; charset=utf-8")
                elif path in NOT_PORTED:
                    self._send(501, NOT_PORTED[path] + "\n",
                               "text/plain; charset=utf-8")
                else:
                    self._send(404, "not found\n", "text/plain")
            except BrokenPipeError:
                pass           # scraper went away mid-response
            except Exception as e:   # an ops page must never take the
                try:                 # process (or the server thread) down
                    self._send(500, f"{type(e).__name__}: {e}\n",
                               "text/plain")
                except Exception:
                    pass

    return _Handler


# -- process-wide server -------------------------------------------------------

_SERVER = TelemetryServer()
atexit.register(_SERVER.shutdown)


def serve(port: Optional[int] = None) -> int:
    """Start the process-wide ops endpoint; returns the bound port.
    ``port=None`` takes ``FLAGS_telemetry_port`` (treating -1 as 0 so an
    explicit serve() call always binds something)."""
    if port is None:
        port = max(0, int(_flags.get_flag("telemetry_port")))
    return _SERVER.serve(port)


def shutdown() -> None:
    _SERVER.shutdown()


def port() -> Optional[int]:
    return _SERVER.port


def attach_fleet(router) -> None:
    _SERVER.attach_fleet(router)


def attach_engine(engine) -> None:
    _SERVER.attach_engine(engine)
