"""ResilientServingEngine: journal + replay, drain-on-SIGTERM,
prefix-cache warm-start around :class:`ContinuousBatchingEngine`.

Counterpart of ``paddle_tpu/serving/resilience/engine.py``
(``ResilientServingEngine``, ``ServingAction``), with the same recovery,
intake, ``warmup``, ``pop_output``, ``drain``, ``phase``, step-hang
watchdog (its ``serving.hang`` incident) and ``hang_exit``. Two
differences: the inner engine rebuilds a resumed row's committed tokens
as decode rows (``resume_by_decode``: on the card only that route
rebuilds the bytes the uninterrupted run wrote, so replay stays
byte-identical at any temperature), and ``exec_store_dir`` raises: the
persistent executable store is not ported yet (ROADMAP.md, A9).

The serving twin of ``distributed/resilience``'s ResilientTrainer. A
SIGKILL'd server loses every in-flight request and its entire paged KV
pool — but the engine was built so none of that needs checkpointing:

* every admission (prompt, sampling config, engine seed, rid,
  max_new_tokens) and every committed output watermark is journaled
  through :class:`RequestJournal` (the commit protocol of
  ``utils/durability.py``, so a torn journal is never loadable). Replay after relaunch re-admits each
  unfinished request with its ORIGINAL rid and watermark; the
  schedule-independent per-request sampling streams then regenerate the
  remaining tokens **byte-identically** — KV is re-derived (the
  engine's preemption path), never snapshotted. Finished outputs
  load straight from the log.
* SIGTERM (a preemption notice) triggers :meth:`drain` via
  ``PreemptionHandler``: admission stops, in-flight rows finish — or
  are journaled-and-preempted when the deadline lands — the journal
  flushes + commits, and the prefix cache snapshots for warm-start.
* a step-hang watchdog flags a wedged step (a stuck device call, a
  deadlocked host thread) into the same journal→restart recovery: the
  journal is already durable up to the last flush, so the relaunch
  replays exactly like a kill.

Lifecycle actions mirror ``TrainerAction``: the serve loop polls once
per step and exits on ``DRAINED`` (clean, journal committed) or
``RESTART`` (hang — relaunch and recover).
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from ...models.serving import ContinuousBatchingEngine
from ...observability import flight_recorder as _flight
from ...observability import incident as _incident
from ...observability import metrics as _metrics
from ...observability import tracing as _tracing
from .journal import RequestJournal
from .warm_cache import (_model_fingerprint, last_generation,
                         load_prefix_cache, snapshot_prefix_cache)

__all__ = ["ResilientServingEngine", "ServingAction"]

_M_REPLAYED = _metrics.registry().counter(
    "serving.resilience.replayed_requests",
    help="unfinished journaled requests re-admitted after relaunch")
_M_REPLAYED_TOKENS = _metrics.registry().counter(
    "serving.resilience.replayed_tokens",
    help="already-committed output tokens restored into replayed requests")
_M_RECOVERED = _metrics.registry().counter(
    "serving.resilience.recovered_finished",
    help="finished requests whose outputs loaded straight from the journal")
_M_DRAINS = _metrics.registry().counter(
    "serving.resilience.drains", help="drain-on-SIGTERM completions")
_M_DRAIN_SECONDS = _metrics.registry().histogram(
    "serving.resilience.drain_seconds",
    help="wall time of each drain (stop admission -> committed journal)")
_M_HANGS = _metrics.registry().counter(
    "serving.resilience.step_hangs",
    help="step-hang watchdog firings (journal->restart recovery)")


_record = _flight.record_event


class ServingAction:
    CONTINUE = "continue"
    DRAINED = "drained"       # SIGTERM: journal committed, cache snapshotted
    RESTART = "restart"       # step hang: relaunch + replay the journal
    COMPLETED = "completed"


class ResilientServingEngine:
    """Wrap a :class:`ContinuousBatchingEngine` with durable recovery.

    ``root`` holds ``journal/`` (the request WAL) and ``warmcache/``
    (prefix-block snapshot generations). Construction RECOVERS: an
    existing journal's config (seed, sampling, eos) overrides the
    caller's so replay is byte-identical, finished outputs land in
    :attr:`outputs`, unfinished requests re-admit with their original
    rid + committed watermark, and the newest committed warm-cache
    generation preloads into the pool.

    ``engine_kwargs`` pass through to ``ContinuousBatchingEngine``
    (``max_queue`` gives bounded admission; the wrapper owns
    ``on_finish`` for retirement + journaling).
    """

    def __init__(self, model, root: str, *,
                 warm_start: bool = True,
                 journal_flush_every: int = 4,
                 snapshot_every: int = 0,
                 drain_deadline_s: float = 30.0,
                 step_timeout_s: Optional[float] = None,
                 first_step_timeout_s: Optional[float] = None,
                 hang_exit: bool = False,
                 install_signal: bool = False,
                 elastic=None, signum: Optional[int] = None,
                 finish_hook: Optional[Callable[[Any], None]] = None,
                 exec_store_dir: Optional[str] = None,
                 **engine_kwargs: Any):
        self.root = root
        self.journal = RequestJournal(os.path.join(root, "journal"))
        self.warm_root = os.path.join(root, "warmcache")
        # incident bundles land NEXT TO the journal: the relaunch (or
        # the operator) finds the hang attribution in the same root the
        # recovery reads. Also soft-attached process-wide so rootless
        # triggers (crash excepthook, /debugz) have somewhere to commit.
        self._incident_root = os.path.join(root, "incidents")
        _incident.attach_root(self._incident_root)
        self.drain_deadline_s = float(drain_deadline_s)
        self.journal_flush_every = max(1, int(journal_flush_every))
        self.snapshot_every = max(0, int(snapshot_every))
        self.outputs: Dict[int, List[int]] = {}
        self.drained = False
        self._draining = False
        # fleet transport side-channel: called with each finished Request
        # (timing fields included) right after its output journals —
        # outputs[] only carries tokens, but a router's SLO accounting
        # needs TTFT/TPOT per finish
        self._finish_hook = finish_hook
        self.replayed_requests = 0
        self.recovered_finished = 0
        self.warm_blocks = 0
        # finished requests whose output was DELIVERED (pop_output):
        # the next rewrite-on-snapshot compaction drops them from the WAL
        self._retired: set = set()

        if exec_store_dir:
            # ignoring it would hide that every relaunch captures its
            # step graph anew
            raise NotImplementedError(
                "ResilientServingEngine(exec_store_dir=): the persistent "
                "executable store (jit/exec_store.py) is not ported yet "
                "(ROADMAP.md, A9)")
        state = self.journal.load()
        model_fp = _model_fingerprint(model)
        if state.config is not None:
            # replay against DIFFERENT weights would splice two models'
            # tokens into one output with no error — refuse up front,
            # like the warm cache refuses its preload
            journaled_fp = state.config.get("model_fp")
            if journaled_fp is not None and journaled_fp != model_fp:
                raise RuntimeError(
                    f"journal at {self.journal.root} was written by a "
                    f"different model (weights fingerprint mismatch): "
                    f"replaying it here would corrupt the journaled "
                    f"outputs — point the relaunch at the original "
                    f"weights or a fresh root")
            # journal identity wins: byte-identical replay needs the
            # original seed and sampling config, whatever the relaunch
            # command line says
            engine_kwargs["seed"] = int(state.config["seed"])
            engine_kwargs.update(state.config.get("sampling", {}))
            # including eos=None: a relaunch flag ADDING an eos would
            # truncate replayed outputs below their committed watermarks
            eos = state.config.get("eos")
            engine_kwargs["eos_token_id"] = (None if eos is None
                                             else int(eos))
        engine_kwargs.setdefault("resume_by_decode", True)
        self.engine = ContinuousBatchingEngine(
            model, on_finish=self._on_finish, **engine_kwargs)
        self.engine._warm_model_fp = model_fp   # _meta()'s memo
        # committed watermark per live rid (what the journal already has)
        self._watermark: Dict[int, int] = {}
        self._steps_since_flush = 0
        self._last_snap_step = 0
        self._snap_ok_step = -1    # last step a snapshot actually LANDED
        # continue the on-disk sequence: rewriting an already-COMMITTED
        # generation in place would tear it under its live marker
        self._snapshot_gen = last_generation(self.warm_root)
        self._last_progress = time.monotonic()
        if state.config is None:
            self.journal.append({
                "t": "config", "seed": self.engine.seed,
                "sampling": dict(self.engine.sampling),
                "eos": self.engine.eos, "model_fp": model_fp})
            # config flushes with the first admission (no empty segment)
        else:
            self.journal.uncommit()   # about to append: drain marker stale
            self._recover(state, warm_start)

        self._hang = threading.Event()
        self._hang_exit = hang_exit
        self._watchdog: Optional[threading.Thread] = None
        self._watchdog_stop = threading.Event()
        if step_timeout_s is not None:
            # an incarnation's FIRST step pays the step graph's capture
            # and the first load of the kernel libraries, so a
            # steady-state timeout would os._exit a healthy relaunch into
            # a permanent crash loop: capture → watchdog kill → relaunch
            # → same capture. By
            # default (first_step_timeout_s=None) the pre-first-step
            # window is exempt entirely: it is the NOT_READY health
            # phase (see :attr:`phase`) — readiness gating is the
            # router's job, not a guessed grace multiplier. An explicit
            # first_step_timeout_s still caps the capture for
            # deployments that want a hard bound.
            self._start_watchdog(
                float(step_timeout_s),
                None if first_step_timeout_s is None
                else float(first_step_timeout_s))
        self.handler = None
        if install_signal:
            from ...distributed.fleet.elastic import PreemptionHandler
            self.handler = PreemptionHandler(elastic).install(signum)

    # -- recovery ------------------------------------------------------------
    def _recover(self, state, warm_start: bool) -> None:
        with _tracing.span("serving.recover") as _sp:
            self._recover_inner(state, warm_start)
            _sp.set(replayed=self.replayed_requests,
                    finished=self.recovered_finished)

    def _recover_inner(self, state, warm_start: bool) -> None:
        if warm_start:
            self.warm_blocks = load_prefix_cache(self.engine, self.warm_root)
        for rec in sorted(state.requests.values(), key=lambda r: r.rid):
            if rec.finished:
                self.outputs[rec.rid] = list(rec.tokens)
                self.recovered_finished += 1
                _M_RECOVERED.inc()
                # finished rids never pass through add_request, but the
                # engine's counter must still advance past them: a
                # reused rid would journal a SECOND admit record and
                # clobber this durably-acked output on the next relaunch
                self.engine._next_rid = max(self.engine._next_rid,
                                            rec.rid + 1)
                continue
            self.engine.add_request(rec.prompt,
                                    max_new_tokens=rec.max_new_tokens,
                                    rid=rec.rid,
                                    out_tokens=rec.tokens or None)
            self._watermark[rec.rid] = len(rec.tokens)
            self.replayed_requests += 1
            _M_REPLAYED.inc()
            _M_REPLAYED_TOKENS.inc(len(rec.tokens))
        _record("serving.resilience.recover",
                (self.journal.root, self.replayed_requests,
                 self.recovered_finished, self.warm_blocks))

    # -- intake --------------------------------------------------------------
    def add_request(self, prompt, max_new_tokens: int = 32, *,
                    rid: Optional[int] = None,
                    out_tokens: Optional[List[int]] = None,
                    tenant: Optional[str] = None) -> int:
        """Admit + journal durably: the flushed admission record is the
        ack point — a request this method returned an rid for survives
        any crash. Raises ``QueueFull`` when bounded admission rejects
        (nothing is journaled for a rejected request).

        ``rid``/``out_tokens`` are the CROSS-replica handoff hooks
        (serving/fleet): a router re-routing a dead replica's journaled
        request admits it here under its original rid with the dead
        journal's committed watermark — same-seed sampling streams then
        continue the output byte-identically, and THIS journal records
        the inherited tokens so a second failure replays from the full
        watermark, not from zero. A rid-given admission bypasses the
        queue bound exactly like local journal replay: it was already
        durably acked somewhere."""
        if self.drained:
            raise RuntimeError("engine is drained: relaunch to serve")
        # ACTIVATED span: the inner Request captures this context (its
        # queue/prefill/decode phases join the trace) and the journal's
        # fsync span nests under it — together they place the durable
        # ack point on the request's timeline
        with _tracing.span("serving.admit") as _sp:
            if tenant is not None:
                _sp.set(tenant=tenant)
            rid = self.engine.add_request(prompt,
                                          max_new_tokens=max_new_tokens,
                                          rid=rid, out_tokens=out_tokens,
                                          tenant=tenant)
            self.journal.append({
                "t": "admit", "rid": rid,
                "prompt": [int(x)
                           for x in self.engine.results[rid].prompt],
                "max_new_tokens": int(max_new_tokens)})
            if out_tokens:
                self.journal.append({
                    "t": "tokens", "rid": rid, "from": 0,
                    "toks": [int(t) for t in out_tokens]})
            self.journal.flush()
            _sp.set(rid=rid, resumed=bool(out_tokens))
        self._watermark[rid] = len(out_tokens) if out_tokens else 0
        return rid

    def warmup(self) -> bool:
        """Pay the step graph's capture before serving traffic:
        run one throwaway single-token request straight through the
        INNER engine with journaling and finish hand-off detached —
        a journaled warmup would write a finish record with no matching
        admit (an integrity error on the next replay), and its output
        must not surface as a served result. No-op (False) unless the
        engine is completely idle with zero steps served — a recovering
        replica warms up by serving its replayed work instead."""
        if (self.drained or self.engine.steps > 0
                or self.engine.num_active > 0 or self.engine.pending):
            return False
        hook = self.engine.on_finish
        self.engine.on_finish = None
        try:
            rid = self.engine.add_request([1, 1], max_new_tokens=1)
            while not self.engine.results[rid].done:
                self.engine.step()
            self.engine.results.pop(rid, None)
        finally:
            self.engine.on_finish = hook
        self._last_progress = time.monotonic()
        return True

    # -- finished hand-off ---------------------------------------------------
    def _on_finish(self, req) -> None:
        self.outputs[req.rid] = list(req.out_tokens)
        self._journal_tokens(req)
        # buffered: step() flushes ONE segment for however many rows
        # finished this step, not one fsync dance per callback
        self.journal.append({"t": "finish", "rid": req.rid})
        self._watermark.pop(req.rid, None)
        if self._finish_hook is not None:
            try:
                self._finish_hook(req)
            except Exception as e:
                # a transport/observer bug must not poison the journal
                # path: the finish record above is already appended, so
                # delivery + replay stay correct without the hook
                _record("serving.resilience.finish_hook_error",
                        (type(e).__name__, str(e)))

    def pop_output(self, rid: int,
                   timeout: Optional[float] = None) -> Optional[List[int]]:
        """Retire a delivered output from host memory and mark it for
        the next journal compaction, which drops its records from disk
        (and from recovery time) too. Mirrors the inner engine's
        ``pop_result``: a long-running server pops what it has sent.
        With ``timeout``, block on the engine's finish condition until
        the output lands or the deadline passes — pollers on another
        thread wait instead of busy-spinning."""
        if timeout is not None and rid not in self.outputs:
            deadline = time.monotonic() + float(timeout)
            with self.engine.finish_cv:
                while rid not in self.outputs:
                    left = deadline - time.monotonic()
                    if left <= 0:
                        break
                    self.engine.finish_cv.wait(timeout=left)
        out = self.outputs.pop(rid, None)
        if out is not None:
            self._retired.add(rid)
        return out

    def _journal_tokens(self, req) -> None:
        have = self._watermark.get(req.rid, 0)
        if len(req.out_tokens) > have:
            self.journal.append({
                "t": "tokens", "rid": req.rid, "from": have,
                "toks": [int(t) for t in req.out_tokens[have:]]})
            self._watermark[req.rid] = len(req.out_tokens)

    # -- the resilient step --------------------------------------------------
    def step(self) -> list:
        """One engine step + watermark journaling (flushed every
        ``journal_flush_every`` steps) + optional periodic warm-cache
        snapshot. Returns the requests that finished this step."""
        if self.drained:
            # stepping would append segments under the COMMITTED marker,
            # falsifying the 'cleanly drained' certificate
            raise RuntimeError("engine is drained: relaunch to serve")
        finished = self.engine.step()
        for rid in list(self._watermark):
            req = self.engine.results.get(rid)
            if req is not None:
                self._journal_tokens(req)
        self._steps_since_flush += 1
        # a finish is worth flushing immediately: it loads straight
        # from the log after a crash, no regeneration needed
        if finished or self._steps_since_flush >= self.journal_flush_every:
            self.journal.flush()
            self._steps_since_flush = 0
        # engine.steps freezes on idle steps, so gate on PROGRESS too:
        # a parked multiple of snapshot_every must not re-fire a full
        # gather + host copy + fsync snapshot on every idle serve-loop tick
        if (self.snapshot_every
                and self.engine.steps > self._last_snap_step
                and self.engine.steps % self.snapshot_every == 0):
            self._last_snap_step = self.engine.steps
            if self.snapshot() is not None:
                self._snap_ok_step = self.engine.steps
        self._last_progress = time.monotonic()
        return finished

    def snapshot(self) -> Optional[str]:
        self._snapshot_gen += 1
        try:
            path = snapshot_prefix_cache(self.engine, self.warm_root,
                                         self._snapshot_gen)
        except OSError as e:
            # a failed snapshot only costs warmth, never correctness —
            # e.g. a zombie incarnation's prune raced this write; the
            # serve loop must not die for it
            _record("serving.resilience.snapshot_failed",
                    (type(e).__name__, str(e)))
            path = None
        # rewrite-on-snapshot journal compaction: retired (finished +
        # delivered) requests leave the WAL, bounding disk growth and
        # recovery time on a long retire-heavy stream. Skipped when
        # there is nothing to drop AND the segment count is small — a
        # compaction pass rewrites the whole WAL, which is pure I/O tax
        # when it would drop nothing
        if self._retired or len(self.journal._segment_names()) > 64:
            # snapshot the set first: pop_output is poller-thread API,
            # so a rid retired DURING the slow compaction I/O must stay
            # marked for the next pass, not vanish in a blanket clear
            done = set(self._retired)
            try:
                dropped = self.journal.compact(done)
                self._retired -= done   # their records are off disk now
                if dropped:
                    _record("serving.resilience.journal_compacted",
                            (dropped, self.journal._next_seg))
            except OSError as e:
                # disk hiccup: the un-compacted journal stays fully
                # valid; keep the retired set for the next attempt
                _record("serving.resilience.compact_failed",
                        (type(e).__name__, str(e)))
        # snapshot wall time (device gather + fsyncs) is PROGRESS, not
        # a wedged step: don't let the watchdog charge it as a hang
        self._last_progress = time.monotonic()
        return path

    # -- poll / serve loop ---------------------------------------------------
    @property
    def phase(self) -> str:
        """Health phase for the fleet router's state machine:
        ``not_ready`` (no step served yet — the first step pays the step
        graph's capture, so a router must hold traffic), ``ready``,
        ``draining`` (drain in progress), ``drained``."""
        if self.drained:
            return "drained"
        if self._draining:
            return "draining"
        if self.engine.steps == 0:
            return "not_ready"
        return "ready"

    @property
    def has_work(self) -> bool:
        # queued requests are not workable under paused admission (the
        # inner run() guards the same way): counting them would make a
        # post-drain run() busy-loop on no-op steps forever
        pending = (bool(self.engine.pending)
                   and not self.engine.admission_paused)
        return pending or self.engine.num_active > 0

    def poll(self) -> str:
        """Call once per step: routes a pending SIGTERM into
        :meth:`drain` and a watchdog hang into RESTART."""
        if self._hang.is_set():
            return ServingAction.RESTART
        if self.handler is not None and self.handler.process():
            self.drain()
            return ServingAction.DRAINED
        return ServingAction.CONTINUE

    def run(self) -> str:
        """Drive until every journaled request completes, a SIGTERM
        drains, or the watchdog flags a hang."""
        if self.drained:
            return ServingAction.DRAINED
        while self.has_work:
            action = self.poll()
            if action != ServingAction.CONTINUE:
                return action
            self.step()
        self.journal.flush()
        return ServingAction.COMPLETED

    # -- drain ---------------------------------------------------------------
    def drain(self, deadline_s: Optional[float] = None) -> float:
        """Stop admission; let in-flight rows finish within the deadline
        (journaling watermarks as they go); journal-and-preempt whatever
        remains; flush + COMMIT the journal; snapshot the prefix cache.
        Returns the drain wall time. Idempotent."""
        if self.drained:
            return 0.0
        deadline = self.drain_deadline_s if deadline_s is None \
            else float(deadline_s)
        t0 = time.monotonic()
        _sp_drain = _tracing.start_span("serving.drain")
        self._draining = True
        # the watchdog's job is over: this IS the clean exit, and the
        # commit+snapshot tail below must not be misread as a hang
        # (with hang_exit that would os._exit a server mid-drain)
        self._watchdog_stop.set()
        self.engine.admission_paused = True
        while (self.engine.num_active > 0
               and time.monotonic() - t0 < deadline):
            self.step()
        # journal-and-preempt the survivors: their watermarks are
        # already current (step() journals each one), the relaunch
        # re-derives their KV by prefill
        remaining = self.engine.num_active
        self.journal.commit(drained=True, remaining=remaining)
        # skip the final snapshot only when a periodic one SUCCEEDED at
        # this very step count — the state would be identical, and the
        # device gather + fsync dance is on the preemption deadline (a
        # failed or skipped periodic attempt must not forfeit the
        # warm-start this drain exists to produce)
        if (not self.snapshot_every
                or self.engine.steps != self._snap_ok_step):
            self.snapshot()
        self.drained = True
        dt = time.monotonic() - t0
        _sp_drain.set(remaining=remaining,
                      pending=len(self.engine.pending)).end()
        _M_DRAINS.inc()
        _M_DRAIN_SECONDS.observe(dt)
        _record("serving.resilience.drain",
                (round(dt, 3), remaining, len(self.engine.pending)))
        return dt

    # -- step-hang watchdog --------------------------------------------------
    def _journal_watermarks(self) -> Dict[str, Any]:
        """Cheap journal state for an incident bundle: per-rid committed
        watermarks, buffered-but-unflushed record count and the on-disk
        segment cursor — what the post-restart replay will see vs what
        the hang lost. Read-only and allocation-light (safe on the
        watchdog scan thread microseconds before ``os._exit``)."""
        try:
            return {
                "watermarks": dict(self._watermark),
                "outputs_delivered": len(self.outputs),
                "pending_records": self.journal.pending_records,
                "next_segment": self.journal._next_seg,
            }
        except Exception:
            return {}          # forensics must not throw on the scan thread

    def _start_watchdog(self, timeout_s: float,
                        first_step_timeout_s: Optional[float]) -> None:
        def scan():
            while not self._watchdog_stop.wait(min(timeout_s / 4, 1.0)):
                if not self.has_work:
                    self._last_progress = time.monotonic()
                    continue
                if self.engine.steps == 0 and first_step_timeout_s is None:
                    # NOT_READY: the first step's capture window is
                    # health-gated (routers withhold traffic until
                    # phase == ready), not hang-policed — a fixed grace
                    # multiplier either kills slow cold captures or
                    # ignores real steady-state hangs for 10x too long
                    self._last_progress = time.monotonic()
                    continue
                limit = (timeout_s if self.engine.steps > 0
                         else first_step_timeout_s)
                if time.monotonic() - self._last_progress > limit:
                    if not self._hang.is_set():
                        self._hang.set()
                        _M_HANGS.inc()
                        stalled = round(time.monotonic()
                                        - self._last_progress, 3)
                        _record("serving.resilience.step_hang", (stalled,))
                        _tracing.instant("serving.step_hang",
                                         attrs={"stalled_s": stalled})
                        # attribute the wedge WHILE it is still wedged:
                        # the classified all-thread stacks in the bundle
                        # say device call vs data wait vs lock, which a
                        # post-restart log line never can. Synchronous on
                        # this scan thread — with hang_exit the process
                        # dies in the next statement, and the stderr
                        # fallback keeps the attribution when the
                        # recorder is off.
                        _incident.record_incident(
                            "serving.hang", root=self._incident_root,
                            step=self.engine.steps,
                            attrs={"stalled_s": stalled,
                                   "hang_exit": self._hang_exit},
                            journal=self._journal_watermarks(),
                            fallback_stderr=self._hang_exit)
                    if self._hang_exit:
                        # the main thread is wedged inside a device call
                        # and can never poll(): the journal already holds
                        # every admission + the last flushed watermarks,
                        # so dying here IS the recovery path — the
                        # launcher relaunches and replay regenerates the
                        # lost tail byte-identically
                        os._exit(75)
                    return
        self._watchdog = threading.Thread(target=scan, daemon=True,
                                          name="serving-watchdog")
        self._watchdog.start()

    def close(self) -> None:
        """Flush the journal, detach the watchdog + signal handler
        (test/notebook hygiene; a real server just exits)."""
        self.journal.flush()
        self._watchdog_stop.set()
        if self._watchdog is not None:
            self._watchdog.join(timeout=2.0)
            self._watchdog = None
        if self.handler is not None:
            self.handler.uninstall()
            self.handler = None
