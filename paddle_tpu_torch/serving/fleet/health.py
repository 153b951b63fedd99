"""Per-replica health state machine: STARTING → READY → DRAINING → DEAD.

Counterpart of ``paddle_tpu/serving/fleet/health.py``: the same states,
transitions and ``fleet.replica_state`` codes.

The router never asks a replica "are you healthy?" synchronously — a
wedged replica would hang the question. Instead each transport handle
publishes a cheap status snapshot (alive?, engine phase, queue depth,
heartbeat age) and the router feeds it through :meth:`ReplicaHealth.
observe` once per poll. The state machine is deliberately one-way
except through explicit operator verbs:

* ``STARTING``: process up, first step (its graph capture) not served —
  the engine's ``not_ready`` phase. The router routes NO traffic here; this
  replaces a watchdog grace multiplier (readiness gating
  instead of hang-policing, see ``resilience/engine.py``).
* ``READY``: serving. The only state submit() routes to.
* ``DRAINING``: router-imposed (rolling deploy). Excluded from routing;
  in-flight work finishes or journals-and-preempts. Cleared by
  :meth:`reset` after restart.
* ``DEAD``: transport gone, heartbeat stale past the timeout, engine
  phase stopped, or start deadline blown. Sticky — a zombie that
  resumes beating must not silently resurrect after the router has
  handed its work off (exactly-once would become at-least-twice);
  only an explicit :meth:`reset` (restart) returns it to STARTING.

``observe`` returns ``(state, died_now)`` — ``died_now`` is True on
exactly the poll that transitioned into DEAD, so failover fires once.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional, Tuple

__all__ = ["ReplicaState", "ReplicaHealth", "STATE_CODES"]


class ReplicaState:
    STARTING = "starting"
    READY = "ready"
    DRAINING = "draining"
    DEAD = "dead"


# numeric encoding for the per-replica ``fleet.replica_state`` gauge
# (Prometheus samples are numbers; dashboards map the code back).
# Ordered by "distance from serving": 1 is the only routable state.
STATE_CODES = {
    ReplicaState.READY: 1,
    ReplicaState.STARTING: 0,
    ReplicaState.DRAINING: 2,
    ReplicaState.DEAD: 3,
}


class ReplicaHealth:
    """Health record for one replica, driven by status snapshots."""

    def __init__(self, name: str, *,
                 heartbeat_timeout_s: float = 5.0,
                 start_deadline_s: Optional[float] = None,
                 clock=time.monotonic):
        self.name = name
        self.heartbeat_timeout_s = float(heartbeat_timeout_s)
        self.start_deadline_s = (None if start_deadline_s is None
                                 else float(start_deadline_s))
        self._clock = clock
        self.state = ReplicaState.STARTING
        self._born = clock()

    # -- operator verbs ------------------------------------------------------
    def mark_draining(self) -> None:
        """Router-imposed: rolling deploy takes this replica out of the
        routing set. A DEAD replica stays dead (it cannot drain)."""
        if self.state != ReplicaState.DEAD:
            self.state = ReplicaState.DRAINING

    def mark_dead(self) -> bool:
        """Force DEAD (e.g. the transport raised on submit). Returns
        True iff this call performed the transition."""
        died = self.state != ReplicaState.DEAD
        self.state = ReplicaState.DEAD
        return died

    def reset(self) -> None:
        """A fresh incarnation is coming up (restart): back to STARTING
        with a fresh start deadline."""
        self.state = ReplicaState.STARTING
        self._born = self._clock()

    # -- snapshot-driven transitions -----------------------------------------
    def observe(self, status: Dict[str, Any],
                now: Optional[float] = None) -> Tuple[str, bool]:
        """Feed one transport status snapshot; returns ``(state,
        died_now)``. ``status`` keys: ``alive`` (bool), ``phase``
        (engine phase string or None), ``beat_age_s`` (seconds since
        the replica last made observable progress)."""
        if now is None:
            now = self._clock()
        if self.state == ReplicaState.DEAD:
            return self.state, False
        prev = self.state
        alive = bool(status.get("alive"))
        phase = status.get("phase")
        beat_age = status.get("beat_age_s")
        if not alive:
            self.state = ReplicaState.DEAD
        elif self.state == ReplicaState.STARTING:
            # the whole STARTING window is one graph capture with no
            # step progress to beat about — staleness here is policed
            # by the start deadline, not the steady-state heartbeat
            if phase == "ready":
                self.state = ReplicaState.READY
            elif (self.start_deadline_s is not None
                    and now - self._born > self.start_deadline_s):
                # a replica that never finishes its first step is as
                # gone as a crashed one: stop waiting, hand its work off
                self.state = ReplicaState.DEAD
        elif (beat_age is not None
                and beat_age > self.heartbeat_timeout_s):
            self.state = ReplicaState.DEAD
        elif self.state == ReplicaState.READY and phase == "not_ready":
            # the engine object was swapped under us without a reset():
            # treat like a restart in progress, stop routing to it
            self.state = ReplicaState.STARTING
            self._born = now
        return self.state, (self.state == ReplicaState.DEAD
                            and prev != ReplicaState.DEAD)
