"""ReplicaRouter: affinity routing, exactly-once failover, SLO shedding.

Counterpart of ``paddle_tpu/serving/fleet/router.py`` (``ReplicaRouter``,
``FleetShed``, ``_affinity_digest``, ``_rendezvous_order``).

One router instance owns the fleet: it assigns every request a GLOBAL
id (``gid``) that is the engine rid on whichever replica serves it.
All replicas run the SAME engine seed, and the sampling streams fold
only (seed, rid, token index) — and every row's arithmetic is its own
(the ragged kernel's sums never depend on the other rows of a step, and
a resumed row rebuilds its committed tokens' KV by the decode route) —
so a request's token stream is a pure function of its gid, independent
of which replica generates which suffix. That is the whole failover story: re-admit under the same gid
with the dead journal's committed watermark, get the same bytes.

**Routing.** The affinity key is the sha256 chain digest of the
prompt's FIRST full block (the deepest digest would scatter prompts
sharing a system-prompt head but differing in tails — exactly the
requests that want to share KV). Highest-random-weight (rendezvous)
hashing orders the READY replicas per key: stable under membership
change, no token ring to rebalance, and every prompt family has a
deterministic fallback order when its first choice is full.

**Admission.** ``submit`` tries candidates in rendezvous order; a
``QueueFull`` moves to the next; when all READY replicas refuse, it
backs off (jittered exponential, capped) and retries until the submit
deadline, polling the fleet meanwhile so finishes can free slots. On
deadline it raises :class:`FleetShed` with ``retry_after_s`` from the
replicas' own queue-wait hints — reject-with-retry-after instead of
unbounded queueing, which is what keeps TTFT p99 bounded at overload.

**Failover.** ``poll`` feeds transport status through each replica's
health machine; the poll that transitions a replica into DEAD loads
its journal from disk and settles every outstanding request exactly
once: journal says finished (or watermark hit ``max_new_tokens``, or
the tail is eos) → deliver straight from the log; otherwise re-submit
to a survivor with the watermark. Requests with no READY survivor park
and re-place on later polls.

**Rolling drain.** One replica at a time: mark DRAINING (out of the
routing set) → drain (in-flight rows finish or journal-and-preempt) →
restart on the SAME root (its own journal replays the preempted work —
handing it to survivors AND replaying it would serve it twice) → wait
READY → next. Zero dropped requests by construction.
"""

from __future__ import annotations

import hashlib
import os
import random
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ...observability import flight_recorder as _flight
from ...observability import incident as _incident
from ...observability import metrics as _metrics
from ...observability import tracing as _tracing
from ..resilience.journal import RequestJournal
from .health import STATE_CODES, ReplicaHealth, ReplicaState
from .replica import FinishedInfo, QueueFull, ReplicaHandle, \
    ReplicaUnavailable

__all__ = ["ReplicaRouter", "FleetShed"]

_M = _metrics.registry()
_M_READY = _M.gauge(
    "fleet.replicas_ready", help="replicas in the READY routing set")
_M_DEAD = _M.gauge(
    "fleet.replicas_dead", help="replicas currently DEAD")
_M_FLEET_QUEUE = _M.gauge(
    "fleet.queue_depth", help="queued requests summed over the fleet")
_M_SUBMITTED = _M.counter(
    "fleet.submitted", help="requests durably admitted somewhere")
_M_COMPLETED = _M.counter(
    "fleet.completed", help="requests delivered to the router")
_M_RETRIES = _M.counter(
    "fleet.retries", help="submit backoff rounds (all candidates full)")
_M_SHEDS = _M.counter(
    "fleet.sheds", help="submits refused with FleetShed (SLO shedding)")
_M_REROUTED = _M.counter(
    "fleet.rerouted_requests",
    help="journaled requests handed off to a survivor after a death")
_M_DEATHS = _M.counter(
    "fleet.replica_deaths", help="READY->DEAD transitions observed")
_M_DRAINS = _M.counter(
    "fleet.drains", help="rolling-deploy drains completed")
_M_RESTARTS = _M.counter(
    "fleet.restarts", help="replica restarts initiated by the router")
_M_AFF_HITS = _M.counter(
    "fleet.affinity_hits",
    help="submits landing on their first-choice affinity replica")
_M_HANDOFF = _M.histogram(
    "fleet.handoff_seconds",
    help="death detection -> every victim request settled or parked")

_record = _flight.record_event


class FleetShed(RuntimeError):
    """The fleet refuses this request right now (every READY replica
    full past the submit deadline, or the SLO estimate says queueing
    would blow TTFT). ``retry_after_s`` is the backoff the caller
    should surface (HTTP 429 Retry-After)."""

    def __init__(self, msg: str, retry_after_s: Optional[float] = None):
        super().__init__(msg)
        self.retry_after_s = retry_after_s


@dataclass
class _Outstanding:
    gid: int
    prompt: List[int]
    max_new_tokens: int
    replica: str
    t_submit: float
    handoffs: int = 0
    # the submit span's (trace_id, span_id): failover re-activates it
    # around the re-submission so the replayed request keeps its
    # ORIGINAL trace across replicas and processes
    trace: Optional[Tuple[int, int]] = None


def _affinity_digest(prompt, block_size: int) -> bytes:
    """The prompt's FIRST full-block chain digest (byte-compatible with
    the engine's prefix-cache hashing); short prompts key on their full
    content. First block, not deepest: two prompts sharing a system
    head but differing later MUST land together for the KV to be warm."""
    p = np.asarray(prompt, np.int32).reshape(-1)
    head = p[:block_size] if len(p) >= block_size else p
    return hashlib.sha256(head.tobytes()).digest()


def _rendezvous_order(key: bytes, names: Sequence[str]) -> List[str]:
    """Highest-random-weight order of ``names`` for this key."""
    return sorted(names,
                  key=lambda n: hashlib.sha256(key + n.encode()).digest(),
                  reverse=True)


class ReplicaRouter:
    """Route an open-loop request stream over a fleet of
    :class:`ReplicaHandle` replicas. See the module docstring for the
    routing/failover/shedding contract.

    ``block_size`` must match the replicas' engine block size (the
    affinity digest reproduces the engine's block hashing);
    ``eos_token_id`` (if the engines use one) lets failover recognize
    a journaled output that finished by eos. ``start()`` starts every
    replica; the caller then drives :meth:`poll` (or uses the blocking
    helpers) from its serve loop.
    """

    def __init__(self, replicas: Sequence[ReplicaHandle], *,
                 block_size: int = 16,
                 eos_token_id: Optional[int] = None,
                 heartbeat_timeout_s: float = 10.0,
                 start_deadline_s: Optional[float] = None,
                 submit_deadline_s: float = 2.0,
                 backoff_base_s: float = 0.02,
                 backoff_max_s: float = 0.25,
                 slo_ttft_s: Optional[float] = None,
                 seed: int = 0):
        if not replicas:
            raise ValueError("a fleet needs at least one replica")
        names = [r.name for r in replicas]
        if len(set(names)) != len(names):
            raise ValueError(f"replica names must be unique: {names}")
        self._replicas: Dict[str, ReplicaHandle] = {
            r.name: r for r in replicas}
        self._health: Dict[str, ReplicaHealth] = {
            r.name: ReplicaHealth(
                r.name, heartbeat_timeout_s=heartbeat_timeout_s,
                start_deadline_s=start_deadline_s)
            for r in replicas}
        self._block_size = int(block_size)
        self._eos = eos_token_id
        self._submit_deadline_s = float(submit_deadline_s)
        self._backoff_base_s = float(backoff_base_s)
        self._backoff_max_s = float(backoff_max_s)
        self._slo_ttft_s = slo_ttft_s
        # private stream: jittered backoff must not perturb anyone
        # else's (or the engines') randomness
        self._rng = random.Random(seed)
        # per-replica labeled health-state gauges (fleet.replica_state):
        # registered up front so a scrape shows every replica from the
        # first poll, including ones that never get to READY
        self._state_gauges = {
            name: _M.gauge(
                "fleet.replica_state",
                help="replica health state (0 starting, 1 ready, "
                     "2 draining, 3 dead)",
                labels={"replica": name})
            for name in self._replicas}
        self._next_gid = 0
        self._outstanding: Dict[int, _Outstanding] = {}
        # (info, watermark tokens) with no READY survivor yet
        self._parked: List[Tuple[_Outstanding, List[int]]] = []
        self.outputs: Dict[int, List[int]] = {}
        self.finished_meta: Dict[int, FinishedInfo] = {}
        # every gid ever delivered: restart-on-same-root re-loads
        # already-delivered finishes from the journal, and a handoff
        # can complete on two incarnations' logs — delivery must
        # dedupe to stay exactly-once from the caller's view
        self._delivered: set = set()
        self.requests: Dict[int, Tuple[List[int], int]] = {}
        self.rerouted_requests = 0
        self.sheds = 0
        self.retries = 0
        # delivery timestamps inside the SLO gate's sliding window:
        # the service-rate half of the queue-wait estimate (see
        # _est_queue_wait_s — windowed so the gate decays when the
        # fleet catches up, router-side so it sees subprocess fleets)
        self._slo_window_s = 5.0
        self._completions: deque = deque(maxlen=512)
        # router-side incident bundles land beside the replica roots
        # (their common parent), so a failover's router bundle and the
        # victim's own hang/crash bundle sit in one tree
        any_root = next(iter(self._replicas.values())).root
        self._incident_root = os.path.join(
            os.path.dirname(os.path.abspath(any_root)), "incidents")

    @property
    def dropped_requests(self) -> int:
        """Acked requests the router is no longer tracking anywhere —
        not delivered, not outstanding, not parked. Zero by the
        exactly-once construction; anything else is a router bug, and
        the bench/tests assert on it."""
        tracked = set(self._outstanding)
        tracked.update(info.gid for info, _ in self._parked)
        return sum(1 for g in self.requests
                   if g not in self._delivered and g not in tracked)

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> None:
        for r in self._replicas.values():
            r.start()
        # ops plane: register the fleet's scrape-time SLIs and (when
        # FLAGS_telemetry_port says so) start the /metrics·/healthz·
        # /statusz·/trace endpoint in this process
        from ...observability import exporter as _exporter
        _exporter.attach_fleet(self)

    def close(self) -> None:
        for r in self._replicas.values():
            try:
                r.stop()
            except ReplicaUnavailable:
                continue   # already dead: nothing to stop


    def wait_ready(self, timeout_s: float = 180.0,
                   min_ready: Optional[int] = None) -> int:
        """Block until ``min_ready`` (default: all) replicas are READY.
        Returns the READY count; raises on timeout — a fleet that never
        becomes ready is a deployment error, not a routing state."""
        want = len(self._replicas) if min_ready is None else min_ready
        deadline = time.monotonic() + timeout_s
        while True:
            self.poll()
            n = len(self._ready_names())
            if n >= want:
                return n
            if time.monotonic() >= deadline:
                raise RuntimeError(
                    f"only {n}/{want} replicas READY after {timeout_s}s")
            time.sleep(0.02)

    def _ready_names(self) -> List[str]:
        return [n for n, h in self._health.items()
                if h.state == ReplicaState.READY]

    # -- submit --------------------------------------------------------------
    def submit(self, prompt, max_new_tokens: int = 32, *,
               deadline_s: Optional[float] = None,
               tenant: Optional[str] = None) -> int:
        """Admit one request somewhere READY; returns its gid once the
        admission is DURABLY journaled on that replica. Raises
        :class:`FleetShed` instead of queueing past the deadline
        (``deadline_s`` overrides the router default per call — latency-
        tier traffic can shed earlier than batch traffic). ``tenant``
        rides the submit span and labels the serving engine's admission
        counters on whichever replica takes the request."""
        t0 = time.monotonic()
        deadline = t0 + (self._submit_deadline_s if deadline_s is None
                         else float(deadline_s))
        hints: List[float] = []
        attempt = 0
        key = _affinity_digest(prompt, self._block_size)
        # ACTIVATED root span: handle.submit below runs inside it, so
        # the replica's admission (same thread or via the injected
        # frame) parents onto THIS trace — the one id that follows the
        # request through every process it touches
        with _tracing.span("fleet.submit") as _sp:
            if tenant is not None:
                _sp.set(tenant=tenant)
            while True:
                ready = self._ready_names()
                if ready:
                    est = self._est_queue_wait_s()
                    if (self._slo_ttft_s is not None and est is not None
                            and est > self._slo_ttft_s):
                        self._shed(hints, est)
                    order = _rendezvous_order(key, ready)
                    for pick, name in enumerate(order):
                        gid = self._next_gid
                        try:
                            self._replicas[name].submit(
                                gid, prompt, max_new_tokens,
                                tenant=tenant)
                        except QueueFull as e:
                            _sp.event("fleet.queue_full", replica=name)
                            if e.retry_after_hint:
                                hints.append(float(e.retry_after_hint))
                            continue
                        except ReplicaUnavailable:
                            # transport died under us. poll() only fails
                            # over on a died-NOW transition, and observe()
                            # reports (DEAD, False) for a replica already
                            # DEAD — so if this mark performs the
                            # transition, settle the victim's journaled
                            # work here or it never gets settled at all
                            if self._health[name].mark_dead():
                                self._failover(name)
                            continue
                        self._next_gid = gid + 1
                        self._outstanding[gid] = _Outstanding(
                            gid, [int(t) for t in prompt],
                            int(max_new_tokens), name, time.monotonic(),
                            trace=(_sp.context if _sp.trace_id else None))
                        self.requests[gid] = ([int(t) for t in prompt],
                                              int(max_new_tokens))
                        _M_SUBMITTED.inc()
                        if pick == 0:
                            _M_AFF_HITS.inc()
                        _sp.set(gid=gid, replica=name, pick=pick)
                        return gid
                attempt += 1
                now = time.monotonic()
                if now >= deadline:
                    self._shed(hints, None)
                self.retries += 1
                _M_RETRIES.inc()
                _sp.event("fleet.retry", attempt=attempt)
                # poll while waiting: finishes free slots, deaths fail over
                self.poll()
                sleep = min(self._backoff_max_s,
                            self._backoff_base_s * (2 ** (attempt - 1)))
                sleep *= 0.5 + self._rng.random()          # jitter
                time.sleep(max(0.0, min(sleep, deadline - now)))

    def _shed(self, hints: List[float], est: Optional[float]) -> None:
        self.sheds += 1
        _M_SHEDS.inc()
        after = max(hints) if hints else (est if est is not None
                                          else self._backoff_max_s)
        # annotates the ambient fleet.submit span (submit is the only
        # caller), so a shed trace shows WHY: deadline vs SLO estimate
        _tracing.event("fleet.shed", retry_after_s=round(after, 4),
                       slo_est=None if est is None else round(est, 4))
        raise FleetShed(
            f"fleet is at capacity: retry after ~{after:.3f}s",
            retry_after_s=after)

    def _est_queue_wait_s(self) -> Optional[float]:
        """Expected wait if admitted now: fleet queue depth over the
        recent delivery rate. Both halves are router-side and windowed
        on purpose — the engines' ``serving.queue_wait_seconds``
        histogram is cumulative over the process lifetime (one
        sustained overload would poison its median and shed forever
        after recovery) and lives in the CHILD for subprocess fleets,
        where the parent's registry is empty. None until the window
        holds enough deliveries to mean anything."""
        now = time.monotonic()
        comps = self._completions
        while comps and now - comps[0] > self._slo_window_s:
            comps.popleft()
        if len(comps) < 8:
            return None
        rate = len(comps) / max(now - comps[0], 1e-3)
        # a DEAD replica's snapshot is its last heartbeat — counting
        # that stale depth would double the work failover already
        # moved onto the survivors' queues
        qdepth = sum(
            int(self._replicas[n].status().get("queue_depth") or 0)
            for n, h in self._health.items()
            if h.state != ReplicaState.DEAD)
        return qdepth / rate

    # -- poll / delivery -----------------------------------------------------
    def poll(self) -> List[FinishedInfo]:
        """Drain finishes from every replica, advance health, fail over
        any replica that died since the last poll, re-place parked
        work. Call from the serve loop; submit() also calls it while
        backing off."""
        done: List[FinishedInfo] = []
        now = time.monotonic()
        died: List[str] = []
        qdepth = 0
        for name, handle in self._replicas.items():
            for fi in handle.pop_finished():
                if fi.gid in self._delivered:
                    continue          # exactly-once: see _delivered
                self._delivered.add(fi.gid)
                self.outputs[fi.gid] = fi.tokens
                self.finished_meta[fi.gid] = fi
                self._outstanding.pop(fi.gid, None)
                self._completions.append(now)
                _M_COMPLETED.inc()
                done.append(fi)
            st = handle.status()
            qdepth += int(st.get("queue_depth") or 0)
            _, died_now = self._health[name].observe(st, now)
            if died_now:
                died.append(name)
        for name in died:
            self._failover(name)
        if self._parked:
            self._place_parked()
        states = [h.state for h in self._health.values()]
        _M_READY.set(float(states.count(ReplicaState.READY)))
        _M_DEAD.set(float(states.count(ReplicaState.DEAD)))
        _M_FLEET_QUEUE.set(float(qdepth))
        for name, h in self._health.items():
            self._state_gauges[name].set(float(STATE_CODES[h.state]))
        return done

    def pop_output(self, gid: int,
                   timeout: Optional[float] = None) -> Optional[List[int]]:
        """Deliver one finished output (poll-driven when ``timeout`` is
        given). The output stays in :attr:`outputs` too until popped."""
        if gid in self.outputs:
            return self.outputs.pop(gid)
        if timeout is None:
            return None
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            self.poll()
            if gid in self.outputs:
                return self.outputs.pop(gid)
            time.sleep(0.005)
        return None

    def drain_all(self, timeout_s: float = 300.0) -> None:
        """Poll until every outstanding request has been delivered
        (test/bench convenience — a server would just keep polling)."""
        deadline = time.monotonic() + timeout_s
        while self._outstanding or self._parked:
            if time.monotonic() >= deadline:
                raise RuntimeError(
                    f"{len(self._outstanding)} outstanding + "
                    f"{len(self._parked)} parked after {timeout_s}s")
            self.poll()
            time.sleep(0.005)

    # -- failover ------------------------------------------------------------
    def _failover(self, name: str) -> None:
        """Settle every request outstanding on a dead replica exactly
        once from its on-disk journal: finished → deliver from the log;
        unfinished → re-submit the committed watermark to a survivor."""
        _M_DEATHS.inc()
        t0 = time.monotonic()
        victims = sorted((o for o in self._outstanding.values()
                          if o.replica == name), key=lambda o: o.gid)
        _record("fleet.replica_death", (name, len(victims)))
        _tracing.instant("fleet.replica_dead",
                         attrs={"replica": name, "victims": len(victims)})
        if not victims:
            _incident.record_incident(
                "fleet.failover", root=self._incident_root,
                attrs={"replica": name, "victims": 0})
            _M_HANDOFF.observe(time.monotonic() - t0)
            return
        state = RequestJournal(
            os.path.join(self._replicas[name].root, "journal")).load()
        for info in victims:
            rec = state.requests.get(info.gid)
            toks = list(rec.tokens) if rec is not None else []
            finished = rec is not None and (
                rec.finished
                or len(toks) >= info.max_new_tokens
                or (self._eos is not None and toks
                    and toks[-1] == self._eos))
            if finished:
                # completed before death, output never delivered: the
                # journal IS the output — re-generating it anywhere
                # would be the at-least-twice bug this layer exists
                # to prevent
                if info.gid not in self._delivered:
                    self._delivered.add(info.gid)
                    self.outputs[info.gid] = toks
                    self.finished_meta[info.gid] = FinishedInfo(
                        info.gid, toks)
                    self._completions.append(time.monotonic())
                    _M_COMPLETED.inc()
                self._outstanding.pop(info.gid, None)
                _tracing.instant(
                    "fleet.failover", trace=info.trace,
                    attrs={"gid": info.gid, "replica": name,
                           "disposition": "delivered_from_journal"})
            else:
                self._parked.append((info, toks))
                _tracing.instant(
                    "fleet.failover", trace=info.trace,
                    attrs={"gid": info.gid, "replica": name,
                           "disposition": "parked",
                           "watermark": len(toks)})
        self._place_parked()
        # router-side failover incident: carries every victim's trace
        # id so this bundle correlates with the dead replica's own
        # journal/bundle (the victim submit spans share those ids)
        traced = [o.trace for o in victims if o.trace is not None]
        _incident.record_incident(
            "fleet.failover", root=self._incident_root,
            trace_id=traced[0][0] if traced else None,
            attrs={"replica": name, "victims": len(victims),
                   "victim_gids": [o.gid for o in victims],
                   "victim_traces": [f"{t[0]:016x}" for t in traced]})
        _M_HANDOFF.observe(time.monotonic() - t0)

    def _place_parked(self) -> None:
        """Re-submit parked (dead-replica) requests to READY survivors
        under their ORIGINAL gids with the journaled watermark. A
        handoff bypasses the admission bound: the request was durably
        acked already — bouncing it would drop an acked request."""
        ready = self._ready_names()
        if not ready:
            return
        still: List[Tuple[_Outstanding, List[int]]] = []
        for info, toks in self._parked:
            key = _affinity_digest(info.prompt, self._block_size)
            placed = False
            # re-activate the ORIGINAL submit trace around the
            # re-submission: the survivor's admission spans carry the
            # request's one trace_id, not a fresh root
            _tok = _tracing.activate(info.trace)
            try:
                for name in _rendezvous_order(key, ready):
                    try:
                        self._replicas[name].submit(
                            info.gid, info.prompt, info.max_new_tokens,
                            out_tokens=toks or None, handoff=True)
                    except (QueueFull, ReplicaUnavailable):
                        continue
                    info.replica = name
                    info.handoffs += 1
                    self.rerouted_requests += 1
                    _M_REROUTED.inc()
                    _record("fleet.handoff",
                            (info.gid, name, len(toks)))
                    _tracing.instant(
                        "fleet.handoff", trace=info.trace,
                        attrs={"gid": info.gid, "replica": name,
                               "watermark": len(toks)})
                    placed = True
                    break
            finally:
                _tracing.deactivate(_tok)
            if not placed:
                still.append((info, toks))
        self._parked = still

    # -- rolling deploy ------------------------------------------------------
    def rolling_drain(self, ready_timeout_s: float = 180.0) -> None:
        """Drain + restart every replica, one at a time, losing no
        requests: DRAINING leaves the routing set, in-flight work
        finishes or journals-and-preempts, and the restart ON THE SAME
        ROOT replays the preempted remainder itself (survivor handoff
        here would double-serve it). Waits for READY before moving on,
        polling so the rest of the fleet keeps delivering."""
        for name in list(self._replicas):
            handle = self._replicas[name]
            health = self._health[name]
            if health.state == ReplicaState.DEAD:
                continue               # deploys don't resurrect: restart policy owns that
            health.mark_draining()
            self.poll()
            try:
                handle.drain()
            except ReplicaUnavailable:
                # the drain found the replica dead or wedged: settle
                # its journaled work on survivors instead of deploying
                # it (restart policy owns resurrection, same as DEAD
                # replicas skipped above)
                if health.mark_dead():
                    self._failover(name)
                continue
            _M_DRAINS.inc()
            _record("fleet.drain", (name,))
            _tracing.instant("fleet.drain", attrs={"replica": name})
            handle.restart()           # same root: recovers own journal
            health.reset()
            _M_RESTARTS.inc()
            _tracing.instant("fleet.restart", attrs={"replica": name})
            deadline = time.monotonic() + ready_timeout_s
            ok = False
            while time.monotonic() < deadline:
                self.poll()
                if health.state == ReplicaState.READY:
                    ok = True
                    break
                if health.state == ReplicaState.DEAD:
                    break              # failover already settled its work
                time.sleep(0.02)
            if not ok and health.state != ReplicaState.DEAD:
                raise RuntimeError(
                    f"replica {name} not READY {ready_timeout_s}s after "
                    f"rolling restart")
