"""The incident forensics plane (``observability/debug.py`` and
``incident.py``) and ``/debugz`` against the JAX package's.

- ``classify_frames`` names each class from synthetic stacks of the
  port's own frames (a CUDA-graph capture or the kernels' nvcc build, the
  host waiting on the card, the port's DataLoader), and gives the
  reference's class for the frames both packages share (journal fsync,
  lock wait, idle helpers, queues).
- A bundle has the reference's files and header keys, less ``perf.json``
  (the executable ledger is not ported); its versions name torch, CUDA
  and the card.
- The rate limit, ``incident_keep`` and the flag off (one flag read, no
  file), the root resolution, the taxonomy check, and the crash
  excepthook's bundle.
- ``/debugz`` with and without ``record=1``; ``attach_fleet`` points
  ``/healthz`` at a router.
"""

import json
import os
import threading
import urllib.error
import urllib.request

import pytest

from paddle_tpu import flags as jflags
from paddle_tpu.observability import debug as jdebug
from paddle_tpu.observability import incident as jincident
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch.observability import debug as tdebug
from paddle_tpu_torch.observability import exporter as texporter
from paddle_tpu_torch.observability import flight_recorder as tflight
from paddle_tpu_torch.observability import incident as tincident
from paddle_tpu_torch.observability import metrics as tmetrics
from paddle_tpu_torch.utils.durability import read_committed_marker

TORCH = "/site-packages/torch"
PORT = "/repo/paddle_tpu_torch"
PY = "/usr/lib/python3.12"
OUTER = (f"{PORT}/serving/fleet/replica.py", 180, "_loop")

# (class, innermost-first frames) of the port's own stacks
PORT_STACKS = {
    "graph_capture": ("jit_compile", [
        (f"{TORCH}/cuda/graphs.py", 90, "capture_end"),
        (f"{PORT}/jit/step_capture.py", 370, "capture_graph"),
        (f"{PORT}/models/serving.py", 1040, "_capture_step"), OUTER]),
    "capture_sync": ("jit_compile", [
        (f"{TORCH}/cuda/__init__.py", 980, "synchronize"),
        (f"{PORT}/jit/step_capture.py", 344, "capture_graph"), OUTER]),
    "nvcc_build": ("jit_compile", [
        (f"{PY}/subprocess.py", 1264, "wait"),
        (f"{PORT}/ops/kernels/_build.py", 119, "build_all"), OUTER]),
    "library_load": ("jit_compile", [
        (f"{PY}/ctypes/__init__.py", 379, "__init__"),
        (f"{PORT}/ops/kernels/_build.py", 135, "load"),
        (f"{PORT}/ops/kernels/ragged_paged_attention.py", 400,
         "ragged_paged_attention"), OUTER]),
    "host_read": ("device_call", [
        (f"{PORT}/models/serving.py", 85, "_host_read"),
        (f"{PORT}/models/serving.py", 930, "step"), OUTER]),
    "synchronize": ("device_call", [
        (f"{TORCH}/cuda/__init__.py", 980, "synchronize"),
        (f"{PORT}/serving/resilience/engine.py", 400, "step"), OUTER]),
    "event_sync": ("device_call", [
        (f"{TORCH}/cuda/streams.py", 220, "synchronize"),
        ("/repo/chip_smoke.py", 470, "time_ms"), OUTER]),
    "graph_replay": ("device_call", [
        (f"{TORCH}/cuda/graphs.py", 100, "replay"),
        (f"{PORT}/jit/step_capture.py", 300, "replay"),
        (f"{PORT}/models/serving.py", 1010, "_graph_step"), OUTER]),
    "dataloader": ("data_wait", [
        (f"{PY}/threading.py", 355, "wait"),
        (f"{PORT}/io/__init__.py", 600, "__next__"), OUTER]),
    "journal": ("journal_fsync", [
        (f"{PY}/threading.py", 120, "acquire"),
        (f"{PORT}/utils/durability.py", 52, "fsync_write"),
        (f"{PORT}/serving/resilience/journal.py", 190, "flush"), OUTER]),
    "sleep": ("other", [
        (f"{PORT}/models/llama.py", 200, "forward"), OUTER]),
}

# frames both packages share: the reference's class is the port's
NEUTRAL = {
    "journal_fsync": [("/x/paddle_tpu_torch/utils/durability.py", 52,
                       "fsync_write"), OUTER],
    "journal_flush_under_lock": [
        ("/usr/lib/python3.12/threading.py", 120, "acquire"),
        ("/x/paddle_tpu/serving/resilience/journal.py", 190, "flush"),
        OUTER],
    "lock_wait": [("/usr/lib/python3.12/threading.py", 355, "wait"),
                  ("/x/app.py", 10, "main")],
    "join": [("/usr/lib/python3.12/threading.py", 1147,
              "_wait_for_tstate_lock"), ("/x/app.py", 10, "main")],
    "idle_exporter": [
        ("/usr/lib/python3.12/threading.py", 355, "wait"),
        ("/x/paddle_tpu_torch/observability/exporter.py", 120, "serve")],
    "idle_selectors": [
        ("/usr/lib/python3.12/threading.py", 355, "wait"),
        ("/usr/lib/python3.12/selectors.py", 415, "select")],
    "queue_get": [("/usr/lib/python3.12/threading.py", 355, "wait"),
                  ("/usr/lib/python3.12/queue.py", 180, "get"),
                  ("/x/app.py", 10, "main")],
    "empty": [],
    "plain": [("/x/app.py", 3, "f"), ("/x/app.py", 10, "main")],
}


@pytest.mark.parametrize("case", sorted(PORT_STACKS))
def test_port_frames_classify(case):
    cls, frames = PORT_STACKS[case]
    assert tdebug.classify_frames(frames) == cls
    assert cls in tdebug.STACK_CLASSES


@pytest.mark.parametrize("case", sorted(NEUTRAL))
def test_shared_frames_classify_as_the_reference(case):
    frames = NEUTRAL[case]
    assert tdebug.classify_frames(frames) == jdebug.classify_frames(frames)


def test_vocabulary_is_the_reference_and_capture_is_live():
    assert tdebug.STACK_CLASSES == jdebug.STACK_CLASSES
    snap = tdebug.stacks_snapshot()
    me = [s for s in snap["stacks"] if s["current"]]
    assert len(me) == 1 and snap["threads"] == len(snap["stacks"])
    assert sum(snap["by_class"].values()) == snap["threads"]
    text = tdebug.format_stacks(snap["stacks"])
    assert "<- capturing" in text and text.startswith(f"{snap['threads']} ")


def test_capture_names_a_parked_thread():
    ev, ready = threading.Event(), threading.Event()

    def park():
        ready.set()
        ev.wait(30.0)
    t = threading.Thread(target=park, name="parked-worker", daemon=True)
    t.start()
    ready.wait()
    try:
        (s,) = [s for s in tdebug.capture_stacks()
                if s["name"] == "parked-worker"]
        assert s["class"] == "lock_wait" and not s["current"]
    finally:
        ev.set()
        t.join()


# -- bundles ---------------------------------------------------------------------

@pytest.fixture
def no_rate_limit():
    saved = tflags.get_flag("incident_rate_limit_s")
    jsaved = jflags.get_flags(["FLAGS_incident_rate_limit_s"])
    tflags.set_flags({"incident_rate_limit_s": 0.0})
    jflags.set_flags({"FLAGS_incident_rate_limit_s": 0.0})
    yield
    tflags.set_flags({"incident_rate_limit_s": saved})
    jflags.set_flags(jsaved)


def _bundle(rec, root, **kw):
    path = rec.record("serving.hang", root=str(root), step=7,
                      attrs={"stalled_s": 1.5}, trace_id=0xABC,
                      journal={"watermarks": {"3": 4}}, **kw)
    assert path is not None
    return path


def test_bundle_has_the_reference_files_and_keys_but_perf(tmp_path,
                                                          no_rate_limit):
    got = _bundle(tincident.IncidentRecorder(), tmp_path / "port")
    want = _bundle(jincident.IncidentRecorder(), tmp_path / "ref")
    files = {p: sorted(os.listdir(p)) for p in (got, want)}
    assert files[got] == sorted(set(files[want]) - {"perf.json"})
    hdr = json.load(open(os.path.join(got, "incident.json")))
    ref = json.load(open(os.path.join(want, "incident.json")))
    assert sorted(hdr) == sorted(ref)
    assert {k: hdr[k] for k in ("kind", "step", "trace_id", "attrs")} == \
        {k: ref[k] for k in ("kind", "step", "trace_id", "attrs")}
    assert set(hdr["versions"]) == {"python", "torch", "cuda", "card"}
    assert hdr["flags"]["incident_recorder"] is True
    assert read_committed_marker(got) == read_committed_marker(want)
    assert os.path.basename(got).startswith("incident-7-")
    assert json.load(open(os.path.join(got, "journal.json"))) == \
        {"watermarks": {"3": 4}}
    stacks = json.load(open(os.path.join(got, "stacks.json")))
    assert hdr["stack_classes"] == stacks["by_class"]
    assert json.load(open(os.path.join(got, "metrics.json")))


def test_rate_limit_keep_and_flag_off(tmp_path):
    reg = tmetrics.registry()
    dropped = reg.get("incident.dropped")
    saved = {n: tflags.get_flag(n) for n in (
        "incident_rate_limit_s", "incident_keep", "incident_recorder")}
    rec = tincident.IncidentRecorder()
    try:
        tflags.set_flags({"incident_rate_limit_s": 3600.0})
        assert rec.record("debug.manual", root=str(tmp_path)) is not None
        d0 = dropped.value
        assert rec.record("debug.manual", root=str(tmp_path)) is None
        assert dropped.value == d0 + 1
        assert rec.record("fleet.failover", root=str(tmp_path)) is not None
        tflags.set_flags({"incident_rate_limit_s": 0.0,
                          "incident_keep": 2})
        for _ in range(3):
            rec.record("debug.manual", root=str(tmp_path))
        assert len([d for d in os.listdir(tmp_path)
                    if d.startswith("incident-")]) == 2
        assert len(rec.recent()) == 5       # the index keeps what pruned
        tflags.set_flags({"incident_recorder": False})
        n = len(os.listdir(tmp_path))
        d0 = dropped.value
        assert rec.record("debug.manual", root=str(tmp_path)) is None
        assert len(os.listdir(tmp_path)) == n and dropped.value == d0
        with pytest.raises(ValueError, match="unregistered"):
            tflags.set_flags({"incident_recorder": True})
            rec.record("debug.typo", root=str(tmp_path))
    finally:
        tflags.set_flags(saved)


def test_root_resolution_and_the_rootless_drop(tmp_path, no_rate_limit):
    rec = tincident.IncidentRecorder()
    dropped = tmetrics.registry().get("incident.dropped")
    d0 = dropped.value
    assert rec.record("debug.manual") is None and dropped.value == d0 + 1
    rec.attach_root(str(tmp_path / "first"))
    rec.attach_root(str(tmp_path / "second"))       # first attach wins
    assert rec.record("debug.manual").startswith(str(tmp_path / "first"))
    tflags.set_flags({"incident_dir": str(tmp_path / "flag")})
    try:
        assert rec.record("debug.manual").startswith(str(tmp_path / "flag"))
        assert rec.record("debug.manual", root=str(tmp_path / "own")) \
            .startswith(str(tmp_path / "own"))
    finally:
        tflags.set_flags({"incident_dir": ""})


def test_crash_excepthook_commits_a_bundle(tmp_path, no_rate_limit,
                                           capsys):
    tflags.set_flags({"incident_dir": str(tmp_path)})
    try:
        try:
            raise KeyError("lost the pool")
        except KeyError as e:
            tflight._excepthook(type(e), e, e.__traceback__)
    finally:
        tflags.set_flags({"incident_dir": ""})
    (b,) = [d for d in os.listdir(tmp_path) if d.startswith("incident-")]
    hdr = json.load(open(tmp_path / b / "incident.json"))
    assert hdr["kind"] == "crash.exception"
    assert hdr["attrs"]["exc_type"] == "KeyError"
    assert "lost the pool" in capsys.readouterr().err   # the traceback


# -- the endpoint ----------------------------------------------------------------

def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=10.0) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


class _Health:
    def __init__(self, state):
        self.state = state


class _Handle:
    def status(self):
        return {"phase": "ready", "queue_depth": 2, "beat_age_s": 0.01}


class _Router:
    def __init__(self, states):
        self._health = {n: _Health(s) for n, s in states.items()}
        self._replicas = {n: _Handle() for n in states}


def test_debugz_and_attach_fleet(tmp_path, no_rate_limit):
    reg = tmetrics.MetricsRegistry()
    srv = texporter.TelemetryServer(reg)
    port = srv.serve(0)
    tflags.set_flags({"incident_dir": str(tmp_path)})
    try:
        code, body = _get(port, "/debugz")
        assert code == 200 and "threads:" in body
        assert "paddle-telemetry" in body and "recent incidents" in body
        code, body = _get(port, "/debugz?record=1")
        assert code == 200
        path = body.split("bundle: ", 1)[1].split("\n", 1)[0]
        assert path.startswith(str(tmp_path))
        assert read_committed_marker(path)["kind"] == "debug.manual"
        assert "debug.manual" in _get(port, "/debugz")[1]
        assert _get(port, "/perfz")[0] == 501
        router = _Router({"r0": "ready", "r1": "dead"})
        srv.attach_fleet(router)
        code, body = _get(port, "/healthz")
        assert code == 200 and json.loads(body) == {
            "status": "ok", "replicas": {"r0": "ready", "r1": "dead"}}
        assert "r1           state=dead" in _get(port, "/statusz")[1]
        router._health["r0"].state = "draining"
        assert _get(port, "/healthz")[0] == 503
        snap = reg.snapshot()
        assert snap["fleet.sli.availability"]["value"] == 0.0
        assert snap["fleet.sli.shed_rate"]["value"] is None
    finally:
        tflags.set_flags({"incident_dir": ""})
        srv.shutdown()
