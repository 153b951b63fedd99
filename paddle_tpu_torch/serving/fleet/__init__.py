"""Fleet serving: a multi-replica router above ResilientServingEngine.

Counterpart of ``paddle_tpu/serving/fleet/``. The resilient engine makes
ONE engine unkillable; this package makes the SERVICE survive. A :class:`ReplicaRouter` spreads an open-loop arrival
stream over N engine replicas behind a uniform :class:`ReplicaHandle`
transport (thread-hosted for tests/benches, subprocess-hosted for real
isolation + SIGKILL chaos), session-affine on the prompt's prefix-block
digest chain so shared system prompts land where their KV is warm.

The robustness contract, built on the single-engine primitives:

* **exactly-once retry.** Every replica journals each admission before
  acking (the durable-ack point) and commits output watermarks as it
  generates. When a replica dies, the router loads its journal from
  disk: requests the log shows finished are delivered straight from the
  log; unfinished ones re-submit to a survivor under their ORIGINAL
  global id with the committed watermark as ``out_tokens`` — and since
  every replica shares one engine seed and the sampling streams fold
  only (seed, rid, token index), the survivor continues the output
  **byte-identically** at temperature>0. Never zero times, never twice.
* **health-driven failover.** STARTING → READY → DRAINING → DEAD per
  replica, fed by transport heartbeats and the engine's NOT_READY
  phase; the router sends no traffic to a replica that has not served
  its first step (its graph capture), and failover fires once per
  death.
* **SLO-aware load shedding.** Per-replica admission bounds surface as
  ``QueueFull`` with a queue-wait-derived ``retry_after_hint``; the
  router retries across replicas under a deadline with jittered
  backoff, then sheds (:class:`FleetShed` carrying ``retry_after_s``)
  instead of queueing without bound — TTFT p99 stays bounded under
  overload because excess arrivals are refused, not buffered.
* **rolling drain.** One replica at a time: drain (journal-and-preempt)
  → restart in place (its own journal replays the preempted work) →
  wait READY → next. Zero dropped requests, fleet keeps serving.
"""

from .health import ReplicaHealth, ReplicaState
from .replica import (FinishedInfo, ReplicaHandle, ReplicaUnavailable,
                      SubprocessReplicaHandle, ThreadReplicaHandle)
from .router import FleetShed, ReplicaRouter

__all__ = ["ReplicaRouter", "FleetShed", "ReplicaHandle",
           "ThreadReplicaHandle", "SubprocessReplicaHandle",
           "FinishedInfo", "ReplicaHealth", "ReplicaState",
           "ReplicaUnavailable"]
