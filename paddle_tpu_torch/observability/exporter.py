"""Ops endpoint: /metrics, /healthz, /statusz, /trace over stdlib HTTP.

Counterpart of ``paddle_tpu/observability/exporter.py``: a
zero-dependency ``http.server`` thread over the process-wide
:mod:`~paddle_tpu_torch.observability.metrics` registry, with health,
status and trace views.

Endpoints:

* ``/metrics``: Prometheus text exposition (0.0.4) of the whole registry.
* ``/healthz``: 200/503 readiness. Engine attached: 200 iff the engine's
  ``phase`` is ``ready`` (an engine without a ``phase`` counts as
  ready). Nothing attached: 200 (process alive).
* ``/statusz``: a plain-text operator page: the flag values, torch's and
  CUDA's versions and the card's name, process vitals (uptime, RSS), the
  attached engine and the flight recorder's tail.
* ``/trace``: the tracing ring as Chrome-trace JSON
  (:func:`tracing.to_chrome`).
* ``/perfz`` and ``/debugz`` answer 501: the reference's ``perf.py``,
  ``debug.py`` and ``incident.py`` behind them are not ported yet
  (ROADMAP.md, A9).

Lifecycle: ``FLAGS_telemetry_port`` is -1 (off) by default; 0 binds a free
port (tests), > 0 binds that port. :func:`attach_engine` starts the server
when the flag says so; :func:`serve` starts it explicitly. The server
thread is a daemon and is also shut down at exit. It binds 127.0.0.1
only. :func:`attach_fleet` raises: the fleet router is not ported yet
(ROADMAP.md, A7).
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
from . import flight_recorder as _flight
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
    "/debugz": "live forensics (observability/debug.py and incident.py) "
               "are not ported yet: ROADMAP.md, A9",
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
        # a weakref: the exporter observes the engine, it must not keep
        # a closed engine (and its KV pool) alive
        self._engine = lambda: None

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
        raise NotImplementedError(
            "the fleet router (serving/fleet/) is not ported yet: "
            "ROADMAP.md, A7")

    def attach_engine(self, engine) -> None:
        """Point /healthz and /statusz at one serving engine, then start
        the server if ``FLAGS_telemetry_port`` asks for one."""
        self._engine = weakref.ref(engine)
        port = int(_flags.get_flag("telemetry_port"))
        if port >= 0 and not self.running:
            self.serve(port)

    # -- endpoint bodies ------------------------------------------------------
    def _metrics_body(self) -> str:
        return self._registry.dump_prometheus()

    def _healthz(self):
        """(status_code, body_dict)."""
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
