"""``paddle_tpu_torch.observability``'s metrics registry, flight recorder
and ops endpoint against the JAX package's ``paddle_tpu.observability``.

- The same sequence of registry calls (counters, labelled children,
  gauges with values and callbacks, histograms with default and custom
  bounds, resets, deltas merged into a second registry) gives the same
  Prometheus text, the same JSON snapshot, the same quantiles and the
  same ``format_metrics`` table in both packages, and the same errors.
- The flight recorder's ring: the same sequence numbers, ops and
  arguments kept across wrap-around and resizes, and the same dump lines
  but for the time and thread; the port's op choke point records each
  registry op before it runs, under ``FLAGS_flight_recorder`` and its
  size flag, and an op that raises adds its inputs' shapes and dtypes.
- The ops endpoint on 127.0.0.1, port 0: ``/metrics`` is the registry's
  Prometheus text, ``/healthz`` 200 (503 for an engine whose phase is
  not ready), ``/statusz`` names torch's version, ``/trace`` is the
  tracing ring's Chrome JSON, ``/perfz`` answers 501 naming ROADMAP.md's
  A9, ``/debugz`` lists the classified stacks, an unknown path 404;
  ``attach_fleet`` turns ``/healthz`` to the fleet (more in
  ``tests/test_torch_incident.py``); ``attach_engine`` under
  ``FLAGS_telemetry_port=0`` starts the process-wide server.
"""

import io
import json
import re
import sys
import urllib.request

import pytest
import torch

from paddle_tpu.observability import flight_recorder as jfr
from paddle_tpu.observability import metrics as jm
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch.observability import exporter as tex
from paddle_tpu_torch.observability import flight_recorder as tfr
from paddle_tpu_torch.observability import metrics as tm
from paddle_tpu_torch.ops.dispatcher import call_op


def _sequence(mod):
    """One sequence of registry calls; returns what it produced."""
    r = mod.MetricsRegistry()
    c = r.counter("serving.steps", "steps run")
    c.inc()
    c.inc(4)
    r.counter("serving.admitted", labels={"tenant": "b"}).inc(2)
    r.counter("serving.admitted", labels={"tenant": 'a"q'}).inc()
    r.counter("serving.admitted", "admissions").inc(7)
    g = r.gauge("serving.queue_depth", "waiting\nrequests")
    g.set(3)
    g.set(2.5)
    r.gauge("serving.free_blocks", fn=lambda: 11.0)
    r.gauge("broken", fn=lambda: 1 / 0)
    h = r.histogram("serving.ttft_seconds", "ttft")
    for v in (2e-6, 3e-4, 3e-4, 0.02, 1.5, 200.0):
        h.observe(v)
    hb = r.histogram("custom", bounds=(1.0, 2.0, 4.0),
                     labels={"replica": "r0"})
    for v in (0.5, 1.5, 3.0, 9.0):
        hb.observe(v)
    r.histogram("empty")
    qs = [h.quantile(q) for q in (0.0, 0.5, 0.9, 1.0)] + \
        [hb.quantile(0.5), r.get("empty").quantile(0.5)]
    errors = []
    for fn in (lambda: r.gauge("serving.steps"),
               lambda: r.gauge("serving.admitted", labels={"tenant": "c"}),
               lambda: r.counter("x", labels={str(i): "v"
                                              for i in range(5)}),
               lambda: h.quantile(1.5)):
        try:
            fn()
        except (TypeError, ValueError) as e:
            errors.append((type(e).__name__, str(e)))
    state = {}
    d1 = r.delta_update(state)
    c.inc(2)
    h.observe(0.5)
    d2 = r.delta_update(state, prefixes=("serving.",))
    merged = mod.MetricsRegistry()
    merged.merge_delta(d1, labels={"replica": "r1"})
    merged.merge_delta(d2, labels={"replica": "r1"})
    prom, snap = r.dump_prometheus(), json.loads(r.dump_json())
    table = mod.format_metrics(r.snapshot())
    children = [m.labels for m in r.children("serving.admitted")]
    r.reset()
    return dict(prom=prom, snap=snap, qs=qs, errors=errors, d1=d1, d2=d2,
                merged=merged.dump_prometheus(), table=table,
                children=children, after_reset=r.dump_prometheus(),
                names=r.names())


def test_registry_sequence_equals_reference():
    want, got = _sequence(jm), _sequence(tm)
    assert set(got) == set(want)
    for key in want:
        assert got[key] == want[key], key


def test_registry_disabled_is_a_no_op():
    r = tm.MetricsRegistry()
    c, h = r.counter("a"), r.histogram("b")
    tflags.set_flags({"metrics": False})
    try:
        c.inc()
        h.observe(1.0)
        r.gauge("g").set(5)
    finally:
        tflags.set_flags({"metrics": True})
    assert c.value == 0 and h.count == 0 and r.get("g").value == 0.0


def test_device_gauges_read_torch():
    snap = obs.snapshot()
    assert snap["device.count"]["value"] == float(torch.cuda.device_count())
    assert snap["device.live_array_bytes"]["value"] >= 0.0
    assert "jit.compiles" not in snap


def _ring(mod):
    fr = mod.FlightRecorder(4)
    for i in range(6):
        fr.record(f"op{i}", (((2, i), "float32"), "marker"), ("k", i))
    a = [(e[0], e[3], e[4], e[5]) for e in fr.entries()]
    fr.resize(2)
    b = [(e[0], e[3]) for e in fr.entries()]
    fr.resize(5)
    fr.record("late", (), None)
    c = [(e[0], e[3]) for e in fr.entries()]
    buf = io.StringIO()
    fr.dump(buf)
    lines = [re.sub(r" t=\S+ thread=\d+", "", ln)
             for ln in buf.getvalue().splitlines()[1:]]
    errors = []
    for fn in (lambda: mod.FlightRecorder(0), lambda: fr.resize(0)):
        try:
            fn()
        except ValueError as e:
            errors.append(str(e))
    fr.clear()
    return a, b, c, lines, errors, fr.entries(), fr.capacity


def test_flight_recorder_ring_equals_reference():
    assert _ring(tfr) == _ring(jfr)


def test_choke_point_records_registry_ops():
    rec = tfr.recorder()
    x = torch.ones(2, 3)
    call_op("relu", x)
    e = rec.entries()[-1]
    assert e[3] == "relu" and e[4] is None
    # an op that raises adds its inputs' shapes and dtypes to its entry
    with pytest.raises(RuntimeError):
        call_op("matmul", x, x.to(torch.float64))
    e = rec.entries()[-1]
    assert e[3] == "matmul" and e[4] == (((2, 3), torch.float32),
                                         ((2, 3), torch.float64))
    buf = io.StringIO()
    rec.dump(buf)
    assert "op=matmul args=(2x3:float32, 2x3:float64)" in buf.getvalue()
    n = rec.total_recorded
    tflags.set_flags({"flight_recorder": False})
    try:
        call_op("relu", x)
    finally:
        tflags.set_flags({"flight_recorder": True})
    assert rec.total_recorded == n
    cap = rec.capacity
    tflags.set_flags({"flight_recorder_size": 3})
    try:
        assert tfr.recorder() is rec and rec.capacity == 3
        for _ in range(5):
            call_op("tanh", x)
        assert [e[3] for e in rec.entries()] == ["tanh"] * 3
    finally:
        tflags.set_flags({"flight_recorder_size": cap})
    assert rec.capacity == cap


def test_excepthook_is_chained():
    """The port's crash dump is in sys.excepthook's chain (in front of
    the reference's, or behind it when the JAX package chained later)."""
    assert tfr._installed
    hook, seen = sys.excepthook, []
    while hook in (tfr._excepthook, jfr._excepthook) and hook not in seen:
        seen.append(hook)
        hook = (tfr._prev_excepthook if hook is tfr._excepthook
                else jfr._prev_excepthook)
    assert tfr._excepthook in seen


# no proxy: the requests stay on the loopback whatever the environment
_OPENER = urllib.request.build_opener(urllib.request.ProxyHandler({}))


def _get(port, path):
    try:
        with _OPENER.open(f"http://127.0.0.1:{port}{path}",
                          timeout=10) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


class _Engine:
    def __init__(self, phase):
        self.phase = phase
        self.steps = 3
        self.num_active = 1


def test_exporter_endpoints():
    reg = tm.MetricsRegistry()
    reg.counter("serving.steps", "steps").inc(3)
    srv = tex.TelemetryServer(reg)
    port = srv.serve(0)
    try:
        assert srv.running and srv.port == port and srv.serve(0) == port
        code, body = _get(port, "/metrics")
        assert code == 200 and body == reg.dump_prometheus()
        assert "paddle_serving_steps_total 3" in body
        assert _get(port, "/healthz") == (
            200, json.dumps({"status": "ok", "detail": "process alive"})
            + "\n")
        code, body = _get(port, "/statusz")
        assert code == 200 and f"torch: {torch.__version__}" in body
        assert "FLAGS_tracing = True" in body
        with obs.span("serving.admit", attrs={"rid": 5}):
            pass
        code, body = _get(port, "/trace")
        names = [e["name"] for e in json.loads(body)["traceEvents"]]
        assert code == 200 and "serving.admit" in names
        code, body = _get(port, "/perfz")
        assert code == 501 and "A9" in body
        code, body = _get(port, "/debugz")
        assert code == 200 and "threads:" in body
        assert _get(port, "/nope")[0] == 404
        eng = _Engine("draining")
        srv.attach_engine(eng)
        code, body = _get(port, "/healthz")
        assert code == 503 and json.loads(body)["phase"] == "draining"
        eng.phase = "ready"
        assert _get(port, "/healthz")[0] == 200
        assert "engine: _Engine phase=ready steps=3" in _get(port,
                                                              "/statusz")[1]
        fleet = type("Fleet", (), {})()
        fleet._health = {"r0": type("H", (), {"state": "dead"})()}
        fleet._replicas = {}
        srv.attach_fleet(fleet)
        code, body = _get(port, "/healthz")
        assert code == 503 and json.loads(body)["replicas"] == {"r0": "dead"}
    finally:
        srv.shutdown()
    assert not srv.running and srv.port is None


def test_attach_engine_starts_the_server_from_the_flag():
    tflags.set_flags({"telemetry_port": 0})
    eng = _Engine("ready")
    try:
        obs.attach_telemetry_engine(eng)
        port = tex.port()
        assert port is not None
        assert _get(port, "/healthz")[0] == 200
    finally:
        obs.shutdown_telemetry()
        tflags.set_flags({"telemetry_port": -1})
    assert tex.port() is None
