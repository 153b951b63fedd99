"""Subprocess replica worker: ``python -m paddle_tpu_torch.serving.fleet.worker``.

Counterpart of ``paddle_tpu/serving/fleet/worker.py``, with the same
JSON-lines protocol. One engine replica behind it. The model factory
chooses the device: a factory that builds on ``cuda`` where there is no
card raises, and the worker dies with it (it never serves on the CPU in
its stead). The FIRST stdin line
is the config::

    {"root": ..., "factory": "module:callable",   # builds the model
     "engine": {...},          # ResilientServingEngine kwargs
     "max_queue": int|null,    # handle-level non-handoff bound
     "hb_interval_s": 0.2, "step_sleep_s": 0.0}

then ops, one per line: ``{"op":"submit","gid":G,"prompt":[...],
"n":N,"handoff":bool,"toks":[...]?,"tc":[hex,hex]?,"tn":str?}`` |
``{"op":"drain"}`` | ``{"op":"stop"}``. ``tc`` is the router's trace
context (observability.tracing.inject): the worker re-activates it
around the admission so one trace_id spans both processes. ``tn`` is
the submitting tenant — it labels the engine's admission counters. Events go
to stdout, one JSON per line:

* ``{"ev":"ready","phase":...}`` — warmup (the step graph's capture)
  or recovery done; the parent's health machine flips STARTING→READY on it
* ``{"ev":"hb","phase":...,"qd":N,"m":{...}?}`` — periodic heartbeat;
  ``m`` (present only when something moved) is the registry delta
  since the previous beat (``metrics.MetricsRegistry.delta_update``
  over the ``serving.*``/``jit.*``/``perf.*`` families) — the parent
  merges it
  into its own registry labeled by replica name, so a router scrape
  shows every replica's engine series, and a SIGKILLed replica's
  counters survive as their last-merged values
* ``{"ev":"ack","gid":G}`` — admission DURABLY journaled (the router's
  exactly-once ack point); ``{"ev":"full","gid":G,"hint":h}`` —
  bounded admission refused, hint = median observed queue wait
* ``{"ev":"finish","gid":G,"toks":[...],"ttft":...,"tpot":...}``
* ``{"ev":"drained"}`` — drain committed; exit 64 follows

stdin EOF means the parent died: drain and exit (an orphaned replica
must not serve forever). A SIGKILL needs no protocol — the parent sees
process death, and the journal under ``root`` is the handoff artifact.

Exit codes mirror the chaos-worker convention: 0 completed/stopped,
64 drained.
"""

from __future__ import annotations

import importlib
import json
import os
import queue
import sys
import threading
import time


def _build_model(spec: str):
    mod, _, attr = spec.partition(":")
    return getattr(importlib.import_module(mod), attr)()


def _dump_trace_file(root: str) -> None:
    """Land this replica's span ring as ``<root>/trace.json`` on clean
    exit, next to the journal — the router-side merge/debug artifact
    (a SIGKILLed replica leaves no dump, exactly like its journal tail:
    the survivors' dumps carry the handed-off trace)."""
    from ...observability import tracing
    try:
        if tracing.enabled():
            tracing.dump_trace(os.path.join(root, "trace.json"))
    except OSError:
        pass               # the dump is advisory; exit codes stay honest


def main() -> int:
    cfg = json.loads(sys.stdin.readline())
    hb_interval = float(cfg.get("hb_interval_s", 0.2))
    step_sleep = float(cfg.get("step_sleep_s", 0.0))
    max_queue = cfg.get("max_queue")

    from ...models.serving import QueueFull
    from ...observability import metrics as _metrics
    from ...observability import tracing as _tracing
    from ..resilience.engine import ResilientServingEngine
    from .replica import _finish_timing

    finish_meta = {}
    eng = ResilientServingEngine(
        _build_model(cfg["factory"]), cfg["root"],
        finish_hook=lambda req: finish_meta.__setitem__(
            req.rid, _finish_timing(req)),
        **cfg.get("engine", {}))

    ops: "queue.Queue" = queue.Queue()

    def read_ops() -> None:
        for line in sys.stdin:
            try:
                ops.put(json.loads(line))
            except ValueError:
                continue   # torn/garbage line: skip, don't die serving
        ops.put({"op": "drain", "_eof": True})

    threading.Thread(target=read_ops, daemon=True,
                     name="fleet-worker-stdin").start()

    def emit(ev) -> None:
        # a dead parent (stdin EOF -> orphan drain) leaves stdout a
        # broken pipe: events are advisory — the journal under root is
        # the durable record — so drop them rather than crash out of
        # the shutdown path. Redirect to devnull so the interpreter's
        # exit-time stdout flush cannot re-raise and turn the
        # documented exit code (64) into 120.
        try:
            sys.stdout.write(json.dumps(ev) + "\n")
            sys.stdout.flush()
        except (BrokenPipeError, ValueError, OSError):
            try:
                sys.stdout.close()
            except Exception:
                pass       # the pipe is already broken; close is best-effort
            sys.stdout = open(os.devnull, "w")

    def flush_finished() -> None:
        for rid in list(eng.outputs):
            toks = eng.pop_output(rid)
            if toks is None:
                continue
            ttft, tpot = finish_meta.pop(rid, (None, None))
            emit({"ev": "finish", "gid": rid, "toks": toks,
                  "ttft": ttft, "tpot": tpot})

    # metric piggyback state: one dict per process lifetime, mutated by
    # delta_update so each beat ships only what moved since the last
    hb_state: dict = {}
    hb_prefixes = ("serving.", "jit.", "perf.")

    def hb_event() -> dict:
        ev = {"ev": "hb", "phase": eng.phase,
              "qd": len(eng.engine.pending)}
        delta = _metrics.registry().delta_update(hb_state, hb_prefixes)
        if delta:
            ev["m"] = delta
        return ev

    eng.warmup()
    emit({"ev": "ready", "phase": eng.phase})
    # recovery may have loaded finished outputs straight from the
    # journal — deliver them before any traffic arrives
    flush_finished()

    last_hb = 0.0
    while True:
        drain_req = stop_req = False
        while True:
            try:
                op = ops.get_nowait()
            except queue.Empty:
                break
            kind = op.get("op")
            if kind == "submit":
                gid = int(op["gid"])
                handoff = bool(op.get("handoff")) or bool(op.get("toks"))
                if (not handoff and max_queue is not None
                        and len(eng.engine.pending) >= max_queue):
                    qw = _metrics.registry().get(
                        "serving.queue_wait_seconds")
                    emit({"ev": "full", "gid": gid,
                          "hint": qw.quantile(0.5)
                          if qw is not None else None})
                    continue
                # re-establish the router's trace context (the "tc"
                # frame field) so this admission's spans — and the
                # request's whole engine-side life — carry ITS trace_id
                tc_tok = _tracing.activate(_tracing.extract(op.get("tc")))
                try:
                    eng.add_request(op["prompt"],
                                    max_new_tokens=int(op["n"]),
                                    rid=gid,
                                    out_tokens=op.get("toks") or None,
                                    tenant=op.get("tn"))
                except QueueFull as e:
                    emit({"ev": "full", "gid": gid,
                          "hint": e.retry_after_hint})
                    continue
                finally:
                    _tracing.deactivate(tc_tok)
                emit({"ev": "ack", "gid": gid})
            elif kind == "drain":
                drain_req = True
            elif kind == "stop":
                stop_req = True
        if stop_req:
            emit(hb_event())   # final delta: land the tail counters
            eng.close()
            _dump_trace_file(cfg["root"])
            return 0
        if drain_req:
            eng.drain()
            flush_finished()
            emit(hb_event())
            emit({"ev": "drained"})
            eng.close()
            _dump_trace_file(cfg["root"])
            return 64
        if eng.has_work:
            eng.step()
            flush_finished()
            if step_sleep:
                time.sleep(step_sleep)
        else:
            time.sleep(0.005)
        now = time.monotonic()
        if now - last_hb >= hb_interval:
            last_hb = now
            emit(hb_event())


if __name__ == "__main__":
    sys.exit(main())
