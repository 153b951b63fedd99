"""Replica transports: a uniform handle over thread- or subprocess-
hosted ResilientServingEngine workers.

Counterpart of ``paddle_tpu/serving/fleet/replica.py``
(``ThreadReplicaHandle``, ``SubprocessReplicaHandle``, ``FinishedInfo``,
``ReplicaUnavailable``); the subprocess worker is
``python -m paddle_tpu_torch.serving.fleet.worker``.

The router speaks one small verb set — ``submit`` / ``pop_finished`` /
``status`` / ``drain`` / ``kill`` / ``restart`` — and never touches an
engine directly. Two transports implement it:

* :class:`ThreadReplicaHandle` hosts the engine on a worker thread in
  this process (replicas may share one model; each engine has its own KV
  pool and step graph). Cheap enough that tests run real multi-replica
  fleets on the CPU; ``kill()`` stops the worker at
  a step boundary WITHOUT flushing the journal, so the unflushed tail
  is lost exactly as a SIGKILL would lose it (and ``pop_finished``
  returns nothing from a killed incarnation — a dead process delivers
  no outputs; the journal on disk is all that survives).
* :class:`SubprocessReplicaHandle` hosts the engine in a child process
  behind a JSON-lines stdin/stdout protocol (ops: submit/drain/stop;
  events: ready/hb/ack/full/finish/drained — see ``worker.py``).
  ``kill()`` is a genuine ``SIGKILL``: the chaos tranche uses this to
  prove failover byte-identity against a mid-stream process death,
  not a simulation of one.

Admission bounds live HERE, not in the inner engine: the router always
submits under an explicit global id, and the engine's rid-given path
deliberately bypasses ``max_queue`` (journal replays must never
bounce). The handle re-imposes the bound on non-handoff traffic and
raises the same :class:`~paddle_tpu_torch.models.serving.QueueFull` with the
engine's queue-wait-derived ``retry_after_hint``.
"""

from __future__ import annotations

import contextlib
import json
import os
import signal
import subprocess
import sys
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

from ...models.serving import QueueFull
from ...observability import flight_recorder as _flight
from ...observability import metrics as _metrics
from ...observability import tracing as _tracing
from ..resilience.engine import ResilientServingEngine

__all__ = ["FinishedInfo", "ReplicaHandle", "ReplicaUnavailable",
           "ThreadReplicaHandle", "SubprocessReplicaHandle"]


# the directory that holds the paddle_tpu_torch package
_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))))


class ReplicaUnavailable(RuntimeError):
    """The transport cannot take this submit (process dead, pipe
    broken, worker stopped). The router marks the replica DEAD and
    tries the next candidate — this is a routing signal, not an
    application error."""


@dataclass
class FinishedInfo:
    """One completed request as delivered by a replica. ``ttft_s`` /
    ``tpot_s`` are None when this incarnation cannot vouch for them
    (output recovered from the journal, or a handed-off tail)."""
    gid: int
    tokens: List[int]
    ttft_s: Optional[float] = None
    tpot_s: Optional[float] = None


def _finish_timing(req) -> tuple:
    """(ttft, tpot) from a finished Request's timestamps; None where a
    replay makes the local clock meaningless."""
    ttft = None
    if req.t_first is not None and not req.n_replayed:
        ttft = req.t_first - req.t_arrive
    tpot = None
    n_local = len(req.out_tokens) - req.n_replayed
    if req.t_done is not None and req.t_first is not None and n_local > 1:
        tpot = (req.t_done - req.t_first) / (n_local - 1)
    return ttft, tpot


class ReplicaHandle:
    """Uniform transport verbs; see module docstring. ``name`` is the
    router-visible identity (rendezvous hashing keys on it), ``root``
    the on-disk state dir whose ``journal/`` failover reads."""

    name: str
    root: str

    def start(self) -> None:
        raise NotImplementedError

    def submit(self, gid: int, prompt, max_new_tokens: int, *,
               out_tokens: Optional[List[int]] = None,
               handoff: bool = False,
               tenant: Optional[str] = None) -> None:
        """Admit under the router's global id. Raises ``QueueFull``
        (bounded admission, non-handoff only) or ``ReplicaUnavailable``
        (transport gone). Returning normally means the request is
        DURABLY journaled on the replica — the router's ack point.
        ``tenant`` labels the engine's admission counters."""
        raise NotImplementedError

    def pop_finished(self) -> List["FinishedInfo"]:
        raise NotImplementedError

    def status(self) -> Dict[str, Any]:
        """Non-blocking snapshot: ``alive``, ``phase``, ``queue_depth``,
        ``beat_age_s``. Feeds ``ReplicaHealth.observe``."""
        raise NotImplementedError

    def drain(self) -> float:
        raise NotImplementedError

    def kill(self) -> None:
        raise NotImplementedError

    def stop(self) -> None:
        raise NotImplementedError

    def restart(self, fresh_root: bool = False) -> None:
        raise NotImplementedError


class ThreadReplicaHandle(ReplicaHandle):
    """In-process replica: a worker thread steps a
    ResilientServingEngine; all engine access serializes on one lock.

    ``model_factory`` is called per incarnation (restart builds a fresh
    engine; the model may be shared by returning the same object —
    serving weights are frozen). ``max_queue`` bounds NON-handoff
    admission at the handle (see module docstring); remaining
    ``engine_kwargs`` pass through to ResilientServingEngine.
    """

    def __init__(self, name: str, model_factory: Callable[[], Any],
                 root: str, *, max_queue: Optional[int] = None,
                 idle_wait_s: float = 0.005, **engine_kwargs: Any):
        self.name = name
        self.root = root
        self._base_root = root
        self._factory = model_factory
        self._max_queue = max_queue
        self._idle_wait_s = float(idle_wait_s)
        self._engine_kwargs = dict(engine_kwargs)
        self.eng = None
        self._lock = threading.RLock()
        # callers other than the worker loop waiting for the lock: the
        # loop hands it over after a step instead of taking it back at
        # once (a lock is not fair: a loop that re-takes it between steps
        # starves a submit until the replica runs out of work)
        self._waiters = 0
        self._waiters_lock = threading.Lock()
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._killed = False
        self._thread: Optional[threading.Thread] = None
        self._finish_meta: Dict[int, tuple] = {}
        self._beat = (time.monotonic(), "starting", 0)
        self._incarnation = 0

    # -- worker loop ---------------------------------------------------------
    def _loop(self) -> None:
        eng = self.eng
        # pay the step graph's capture off the router's submit path; a replica
        # recovering journaled work warms up by serving it instead
        # (warmup() no-ops) and flips to ready on its first real step
        eng.warmup()
        while not self._stop.is_set():
            self._beat = (time.monotonic(), eng.phase,
                          len(eng.engine.pending))
            if self._killed:
                # SIGKILL semantics at a step boundary: exit with NO
                # flush/drain — the journal's unflushed tail is lost,
                # replay must regenerate it
                return
            stepped = False
            with self._lock:
                if self._killed or self._stop.is_set() or eng.drained:
                    return
                if eng.has_work:
                    eng.step()
                    stepped = True
            if not stepped:
                self._wake.wait(timeout=self._idle_wait_s)
                self._wake.clear()
            while self._waiters and not self._stop.is_set():
                time.sleep(0)

    @contextlib.contextmanager
    def _held(self):
        """The engine lock, for a caller other than the worker loop."""
        with self._waiters_lock:
            self._waiters += 1
        with self._lock:
            with self._waiters_lock:
                self._waiters -= 1
            yield

    def start(self) -> None:
        self._stop.clear()
        self._killed = False
        self._finish_meta = {}
        self.eng = ResilientServingEngine(
            self._factory(), self.root,
            finish_hook=self._on_req_finish, **self._engine_kwargs)
        self._beat = (time.monotonic(), self.eng.phase,
                      len(self.eng.engine.pending))
        self._thread = threading.Thread(
            target=self._loop, daemon=True,
            name=f"fleet-replica-{self.name}")
        self._thread.start()

    def _on_req_finish(self, req) -> None:
        self._finish_meta[req.rid] = _finish_timing(req)

    # -- verbs ---------------------------------------------------------------
    def submit(self, gid: int, prompt, max_new_tokens: int, *,
               out_tokens: Optional[List[int]] = None,
               handoff: bool = False,
               tenant: Optional[str] = None) -> None:
        if self._killed or self.eng is None or self._stop.is_set():
            raise ReplicaUnavailable(
                f"replica {self.name} is not accepting work")
        with self._held():
            if self._killed or self.eng.drained:
                raise ReplicaUnavailable(
                    f"replica {self.name} is not accepting work")
            if (not handoff and self._max_queue is not None
                    and len(self.eng.engine.pending) >= self._max_queue):
                qw = _metrics.registry().get("serving.queue_wait_seconds")
                raise QueueFull(
                    f"admission queue is full "
                    f"({len(self.eng.engine.pending)}/{self._max_queue} "
                    f"pending): shed load or retry later",
                    retry_after_hint=(qw.quantile(0.5)
                                      if qw is not None else None))
            self.eng.add_request(prompt, max_new_tokens=max_new_tokens,
                                 rid=gid, out_tokens=out_tokens,
                                 tenant=tenant)
        self._wake.set()

    def pop_finished(self) -> List[FinishedInfo]:
        out: List[FinishedInfo] = []
        if self.eng is None or self._killed:
            # a killed incarnation delivers nothing: only its on-disk
            # journal survives (failover reads that) — handing out its
            # in-memory outputs would overstate what a real SIGKILL
            # leaves behind
            return out
        with self._held():
            for rid in list(self.eng.outputs):
                toks = self.eng.pop_output(rid)
                if toks is None:
                    continue
                ttft, tpot = self._finish_meta.pop(rid, (None, None))
                out.append(FinishedInfo(rid, toks, ttft, tpot))
        return out

    def status(self) -> Dict[str, Any]:
        thread_up = self._thread is not None and self._thread.is_alive()
        ts, phase, qd = self._beat
        return {
            "alive": thread_up and not self._killed,
            "phase": phase,
            "queue_depth": qd,
            "beat_age_s": time.monotonic() - ts,
        }

    def drain(self) -> float:
        """Stop the worker at a step boundary, then run the engine's
        drain (finish-or-journal-and-preempt within its deadline) on
        the calling thread."""
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=60.0)
            if self._thread.is_alive():
                # wedged inside eng.step() and still holding the lock:
                # acquiring it here would hang the whole rolling drain.
                # Surface as a transport failure so the router fails
                # this replica over instead.
                raise ReplicaUnavailable(
                    f"replica {self.name} worker did not stop for "
                    f"drain (wedged mid-step)")
        with self._lock:
            return self.eng.drain()

    def kill(self) -> None:
        self._killed = True
        self._wake.set()

    def stop(self) -> None:
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=60.0)
        if self.eng is not None and not self._killed:
            self.eng.close()

    def restart(self, fresh_root: bool = False) -> None:
        """Bring up a fresh incarnation. Same root ⇒ it recovers its
        own journal (rolling drain). ``fresh_root`` ⇒ empty journal —
        REQUIRED after the router has handed this replica's work to
        survivors, or the restart would replay requests a survivor is
        already serving (duplicate generation, double delivery)."""
        self._stop.set()
        self._wake.set()
        if self._thread is not None and self._thread.is_alive():
            self._thread.join(timeout=60.0)
        if self.eng is not None and not self._killed:
            self.eng.close()
        self._incarnation += 1
        if fresh_root:
            self.root = f"{self._base_root}-r{self._incarnation}"
        self.start()


class SubprocessReplicaHandle(ReplicaHandle):
    """Out-of-process replica: ``python -m paddle_tpu_torch.serving.fleet.
    worker`` hosts the engine; this handle owns the pipes. One reader
    thread turns child events into handle state; ``submit`` writes an
    op and waits (bounded) for the matching ack. ``kill()`` sends a
    real SIGKILL — the chaos tranche's whole point.

    ``config`` is the worker's JSON config minus ``root`` (which this
    handle owns): ``factory`` ("module:callable" building the model in
    the child, on the device it chooses), ``engine``
    (ResilientServingEngine kwargs), ``max_queue``, ``hb_interval_s``,
    ``step_sleep_s``. The child imports this package from where the
    parent does (its directory leads ``PYTHONPATH``).
    """

    def __init__(self, name: str, root: str, config: Dict[str, Any], *,
                 ack_timeout_s: float = 30.0,
                 spawn_env: Optional[Dict[str, str]] = None):
        self.name = name
        self.root = root
        self._base_root = root
        self._config = dict(config)
        self._ack_timeout_s = float(ack_timeout_s)
        self._spawn_env = spawn_env
        self._proc: Optional[subprocess.Popen] = None
        self._reader: Optional[threading.Thread] = None
        self._cv = threading.Condition()
        self._acks: Dict[int, Dict[str, Any]] = {}
        self._finished: List[FinishedInfo] = []
        self._beat = (time.monotonic(), "starting", 0)
        self._killed = False
        self._drained = threading.Event()
        self._stderr_f = None
        self._incarnation = 0

    def start(self) -> None:
        self._killed = False
        self._drained.clear()
        self._acks = {}
        # _finished deliberately survives incarnations: finishes the
        # reader buffered but the router has not popped (e.g. flushed
        # during a drain, then restart) are real deliveries — clearing
        # them here would lose them for good on a fresh_root restart,
        # where no journal replay can re-produce them. Same-root
        # replays re-deliver too; the router's _delivered set dedupes.
        os.makedirs(self.root, exist_ok=True)
        env = dict(os.environ if self._spawn_env is None
                   else self._spawn_env)
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (_PKG_ROOT, env.get("PYTHONPATH")) if p)
        self._stderr_f = open(os.path.join(
            self.root, f"worker-{self._incarnation}.log"), "ab")
        self._proc = subprocess.Popen(
            [sys.executable, "-m", "paddle_tpu_torch.serving.fleet.worker"],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=self._stderr_f, env=env, text=True)
        cfg = dict(self._config)
        cfg["root"] = self.root
        self._proc.stdin.write(json.dumps(cfg) + "\n")
        self._proc.stdin.flush()
        self._beat = (time.monotonic(), "starting", 0)
        self._reader = threading.Thread(
            target=self._read_events, daemon=True,
            name=f"fleet-reader-{self.name}")
        self._reader.start()

    def _read_events(self) -> None:
        proc = self._proc
        for line in proc.stdout:        # EOF on child death ends this
            try:
                ev = json.loads(line)
            except ValueError:
                continue                # torn line at a kill boundary
            kind = ev.get("ev")
            if kind == "hb" or kind == "ready":
                self._beat = (time.monotonic(),
                              ev.get("phase", "ready"),
                              int(ev.get("qd", 0)))
                if "m" in ev:
                    # fold the replica's engine-series delta into OUR
                    # registry under its name: one scrape of the router
                    # process shows the whole fleet, and these merged
                    # values are exactly what survives a SIGKILL
                    try:
                        _metrics.registry().merge_delta(
                            ev["m"], labels={"replica": self.name})
                    except Exception as e:
                        # a malformed delta must not kill the reader —
                        # that would look like replica death to health
                        _flight.record_event(
                            "fleet.hb_merge_error",
                            (self.name, type(e).__name__, str(e)))
            elif kind == "ack" or kind == "full":
                with self._cv:
                    self._acks[int(ev["gid"])] = ev
                    self._cv.notify_all()
            elif kind == "finish":
                fi = FinishedInfo(int(ev["gid"]),
                                  [int(t) for t in ev["toks"]],
                                  ev.get("ttft"), ev.get("tpot"))
                with self._cv:
                    self._finished.append(fi)
            elif kind == "drained":
                self._drained.set()

    # -- verbs ---------------------------------------------------------------
    def submit(self, gid: int, prompt, max_new_tokens: int, *,
               out_tokens: Optional[List[int]] = None,
               handoff: bool = False,
               tenant: Optional[str] = None) -> None:
        if not self.status()["alive"]:
            raise ReplicaUnavailable(
                f"replica {self.name} process is not running")
        op = {"op": "submit", "gid": int(gid),
              "prompt": [int(t) for t in prompt],
              "n": int(max_new_tokens), "handoff": bool(handoff)}
        if out_tokens:
            op["toks"] = [int(t) for t in out_tokens]
        if tenant is not None:
            op["tn"] = str(tenant)
        tc = _tracing.inject()
        if tc is not None:
            # carry the router's ambient trace context across the
            # process boundary: the worker re-activates it around
            # add_request, so the child's spans share our trace_id
            op["tc"] = tc
        try:
            self._proc.stdin.write(json.dumps(op) + "\n")
            self._proc.stdin.flush()
        except (BrokenPipeError, OSError) as e:
            raise ReplicaUnavailable(
                f"replica {self.name} pipe is gone: {e}") from e
        deadline = time.monotonic() + self._ack_timeout_s
        with self._cv:
            while gid not in self._acks:
                left = deadline - time.monotonic()
                if left <= 0 or self._proc.poll() is not None:
                    raise ReplicaUnavailable(
                        f"replica {self.name} never acked gid {gid}")
                self._cv.wait(timeout=min(left, 0.25))
            ev = self._acks.pop(gid)
        if ev["ev"] == "full":
            raise QueueFull(
                f"replica {self.name} admission queue is full: shed "
                f"load or retry later",
                retry_after_hint=ev.get("hint"))

    def pop_finished(self) -> List[FinishedInfo]:
        if self._killed:
            return []
        with self._cv:
            out, self._finished = self._finished, []
        return out

    def status(self) -> Dict[str, Any]:
        alive = (self._proc is not None and self._proc.poll() is None
                 and not self._killed)
        ts, phase, qd = self._beat
        return {"alive": alive, "phase": phase, "queue_depth": qd,
                "beat_age_s": time.monotonic() - ts}

    def drain(self) -> float:
        t0 = time.monotonic()
        try:
            self._proc.stdin.write(json.dumps({"op": "drain"}) + "\n")
            self._proc.stdin.flush()
        except (BrokenPipeError, OSError) as e:
            raise ReplicaUnavailable(
                f"replica {self.name} pipe is gone: {e}") from e
        if not self._drained.wait(timeout=120.0):
            raise ReplicaUnavailable(
                f"replica {self.name} did not confirm drain")
        try:
            self._proc.wait(timeout=30.0)
        except subprocess.TimeoutExpired:
            self._proc.kill()
        return time.monotonic() - t0

    def kill(self) -> None:
        self._killed = True
        if self._proc is not None and self._proc.poll() is None:
            os.kill(self._proc.pid, signal.SIGKILL)
            try:
                self._proc.wait(timeout=30.0)
            except subprocess.TimeoutExpired:
                pass  # the reaper owes us nothing; poll() stays truthful

    def stop(self) -> None:
        if self._proc is None:
            return
        if self._proc.poll() is None:
            try:
                self._proc.stdin.write(json.dumps({"op": "stop"}) + "\n")
                self._proc.stdin.flush()
                self._proc.wait(timeout=30.0)
            except (BrokenPipeError, OSError,
                    subprocess.TimeoutExpired):
                self._proc.kill()
        if self._reader is not None:
            self._reader.join(timeout=5.0)
        if self._stderr_f is not None:
            self._stderr_f.close()
            self._stderr_f = None

    def restart(self, fresh_root: bool = False) -> None:
        if self._proc is not None and self._proc.poll() is None:
            self.stop()
        if self._reader is not None:
            self._reader.join(timeout=5.0)
        if self._stderr_f is not None:
            self._stderr_f.close()
            self._stderr_f = None
        self._incarnation += 1
        if fresh_root:
            self.root = f"{self._base_root}-r{self._incarnation}"
        self.start()
