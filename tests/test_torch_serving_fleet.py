"""The fleet router (``paddle_tpu_torch.serving.fleet``) against the JAX
package's, at a tiny size (2 layers, hidden 64, ``block_size=16``).

Held across the packages: ``ReplicaHealth`` walks the same states for the
same events on a fake clock, and the affinity digest and the rendezvous
order are equal for the same prompts and names. Held within the port, on
thread-hosted replicas of the tiny Llama at temperature 0.9: the fleet's
outputs equal one engine serving every request under its global id, byte
for byte; each prompt family lands on one replica; a replica killed
mid-stream fails over exactly once (its journal settles every victim, one
``fleet.failover`` bundle carries the victims' trace ids); a rolling
drain racing live submits drops nothing; a burst against a bounded queue
sheds with ``retry_after_s``; ``/healthz`` follows the fleet. Then two
subprocess replicas (``python -m paddle_tpu_torch.serving.fleet.worker``)
on the CPU, one SIGKILLed after its first acks; and a worker whose model
factory asks for the card where there is none dies rather than serve on
the CPU.
"""

import json
import os
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from paddle_tpu.serving.fleet import ReplicaHealth as JHealth
from paddle_tpu.serving.fleet import router as jrouter
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch.models import ContinuousBatchingEngine
from paddle_tpu_torch.observability import exporter as texporter
from paddle_tpu_torch.serving.fleet import (FleetShed, ReplicaHealth,
                                            ReplicaRouter, ReplicaState,
                                            SubprocessReplicaHandle,
                                            ThreadReplicaHandle)
from paddle_tpu_torch.serving.fleet import router as trouter
from paddle_tpu_torch.utils.durability import read_committed_marker

import _torch_fleet_models

TESTS = os.path.dirname(os.path.abspath(__file__))
ENG = dict(max_batch=4, num_blocks=64, block_size=16, temperature=0.9,
           seed=17)


@pytest.fixture(scope="module")
def model():
    return _torch_fleet_models.build_tiny()


def _families(n_fam=3, per=2, rng_seed=3, bs=16):
    """``per`` prompts each of ``n_fam`` families (a shared first block,
    tails of their own), interleaved."""
    rng = np.random.RandomState(rng_seed)
    heads = [rng.randint(0, 128, bs).tolist() for _ in range(n_fam)]
    return [heads[f] + rng.randint(0, 128, 3 + 2 * i).tolist()
            for i in range(per) for f in range(n_fam)]


def _fleet(model, tmp_path, n=2, max_queue=None, eng=None, **router_kw):
    e = {**ENG, **(eng or {})}
    reps = [ThreadReplicaHandle(f"rep{i}", lambda: model,
                                str(tmp_path / f"rep{i}"),
                                max_queue=max_queue,
                                journal_flush_every=1, **e)
            for i in range(n)]
    router = ReplicaRouter(reps, block_size=e["block_size"], **router_kw)
    router.start()
    router.wait_ready(timeout_s=60.0)
    return router, reps


def _one_engine(model, requests):
    """The oracle: one engine serving every request under its gid."""
    eng = ContinuousBatchingEngine(model, **ENG)
    for gid in sorted(requests):
        p, n = requests[gid]
        eng.add_request(p, max_new_tokens=n, rid=gid)
    eng.run()
    return {g: list(eng.results[g].out_tokens) for g in requests}


def _assert_byte_identical(router, model):
    want = _one_engine(model, router.requests)
    assert {g: list(router.outputs[g]) for g in router.requests} == want


# -- the routing primitives and the health machine, across the packages ---------

def test_affinity_and_rendezvous_equal_reference():
    rng = np.random.RandomState(0)
    names = [f"replica-{i}" for i in range(5)]
    for n in (1, 3, 15, 16, 17, 40):
        p = rng.randint(0, 128256, n).tolist()
        for bs in (16, 64):
            k = trouter._affinity_digest(p, bs)
            assert k == jrouter._affinity_digest(p, bs)
            assert trouter._rendezvous_order(k, names) == \
                jrouter._rendezvous_order(k, names)
            assert trouter._rendezvous_order(k, names[1:3]) == \
                jrouter._rendezvous_order(k, names[1:3])


class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


# (advance s, action): a status snapshot, or an operator verb
HEALTH_SCRIPT = [
    (0.0, {"alive": True, "phase": "not_ready", "beat_age_s": 50.0}),
    (1.0, {"alive": True, "phase": "ready", "beat_age_s": 0.1}),
    (1.0, {"alive": True, "phase": "ready", "beat_age_s": 0.5}),
    (1.0, {"alive": True, "phase": "not_ready", "beat_age_s": 0.1}),
    (1.0, {"alive": True, "phase": "ready", "beat_age_s": 0.1}),
    (0.0, "mark_draining"),
    (1.0, {"alive": True, "phase": "ready", "beat_age_s": 0.1}),
    (0.0, "reset"),
    (30.0, {"alive": True, "phase": "not_ready", "beat_age_s": 9.0}),
    (0.0, {"alive": True, "phase": "ready", "beat_age_s": 0.1}),
    (1.0, {"alive": True, "phase": "ready", "beat_age_s": 7.5}),
    (1.0, {"alive": True, "phase": "ready", "beat_age_s": 0.1}),
    (0.0, "mark_draining"),
    (0.0, "reset"),
    (25.0, {"alive": True, "phase": "not_ready", "beat_age_s": 0.1}),
    (0.0, "reset"),
    (1.0, {"alive": False, "phase": "ready", "beat_age_s": 0.1}),
    (1.0, "mark_dead"),
    (0.0, "reset"),
    (0.0, "mark_dead"),
]


@pytest.mark.parametrize("deadline", [None, 20.0])
def test_health_walks_the_reference_states(deadline):
    trails = []
    for cls in (ReplicaHealth, JHealth):
        clock = _Clock()
        h = cls("r", heartbeat_timeout_s=5.0, start_deadline_s=deadline,
                clock=clock)
        trail = []
        for dt, act in HEALTH_SCRIPT:
            clock.t += dt
            if isinstance(act, str):
                trail.append((act, getattr(h, act)(), h.state))
            else:
                trail.append(h.observe(act))
        trails.append(trail)
    assert trails[0] == trails[1]
    assert ("mark_dead", False, ReplicaState.DEAD) in trails[0]


# -- thread replicas of the tiny Llama -------------------------------------------

def test_two_replicas_byte_identical_and_families_together(model,
                                                           tmp_path):
    router, reps = _fleet(model, tmp_path)
    try:
        prompts = _families()
        gids = [router.submit(p, max_new_tokens=6) for p in prompts]
        placed = {g: router._outstanding[g].replica for g in gids}
        router.drain_all(timeout_s=60.0)
        assert router.dropped_requests == 0
        _assert_byte_identical(router, model)
        heads = {}
        for g, p in zip(gids, prompts):
            heads.setdefault(tuple(p[:16]), set()).add(placed[g])
        assert all(len(r) == 1 for r in heads.values())
        for r in reps:            # every replica replayed its step graph
            st = r.eng.engine.capture_stats
            assert st["captures"] == 1 and st["eager_steps"] == 0
    finally:
        router.close()


def test_kill_fails_over_exactly_once_with_a_bundle(model, tmp_path):
    saved = tflags.get_flag("incident_rate_limit_s")
    tflags.set_flags({"incident_rate_limit_s": 0.0})
    router, reps = _fleet(model, tmp_path)
    try:
        gids = [router.submit(p, max_new_tokens=8)
                for p in _families(3, 2, rng_seed=11)]
        victim = router._outstanding[gids[-1]].replica
        traces = {f"{o.trace[0]:016x}" for o in router._outstanding.values()
                  if o.replica == victim and o.trace is not None}
        assert traces
        next(r for r in reps if r.name == victim).kill()
        delivered = []
        deadline = time.monotonic() + 60.0
        while router._outstanding or router._parked:
            assert time.monotonic() < deadline
            delivered += [f.gid for f in router.poll()]
            time.sleep(0.005)
        assert sorted(delivered) == sorted(set(delivered))  # once each
        assert router.rerouted_requests >= 1
        assert router.dropped_requests == 0
        _assert_byte_identical(router, model)
    finally:
        router.close()
        tflags.set_flags({"incident_rate_limit_s": saved})
    inc = tmp_path / "incidents"
    bundles = [inc / d for d in os.listdir(inc) if d.startswith("incident-")]
    assert len(bundles) == 1
    assert read_committed_marker(str(bundles[0]))["kind"] == "fleet.failover"
    hdr = json.loads((bundles[0] / "incident.json").read_text())
    assert hdr["attrs"]["replica"] == victim
    assert set(hdr["attrs"]["victim_traces"]) == traces
    assert hdr["trace_id"] in traces


def test_rolling_drain_racing_submits_drops_nothing(model, tmp_path):
    router, reps = _fleet(model, tmp_path, submit_deadline_s=30.0)
    try:
        prompts = _families(3, 3, rng_seed=21)
        for p in prompts[:5]:
            router.submit(p, max_new_tokens=8)
        drained = []
        real = reps[0].restart

        def restart_and_submit(*a, **k):
            real(*a, **k)
            drained.append(router.submit(prompts[5], max_new_tokens=8))
        reps[0].restart = restart_and_submit
        router.rolling_drain(ready_timeout_s=60.0)
        for p in prompts[6:]:
            router.submit(p, max_new_tokens=8)
        router.drain_all(timeout_s=60.0)
        assert drained and all(r._incarnation == 1 for r in reps)
        assert router.dropped_requests == 0
        assert len(router.outputs) == len(prompts)
        _assert_byte_identical(router, model)
    finally:
        router.close()


def test_burst_sheds_with_retry_after(model, tmp_path):
    router, _ = _fleet(model, tmp_path, max_queue=1,
                       eng=dict(max_batch=1, num_blocks=32))
    try:
        shed, admitted = [], []
        for p in _families(4, 3, rng_seed=5):
            try:
                admitted.append(router.submit(p, max_new_tokens=32,
                                              deadline_s=0.0))
            except FleetShed as e:
                assert e.retry_after_s is not None and e.retry_after_s > 0
                shed.append(p)
        assert shed and admitted
        router.drain_all(timeout_s=60.0)
        assert router.sheds == len(shed) and router.dropped_requests == 0
        _assert_byte_identical(router, model)
    finally:
        router.close()


def _http_get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=10.0) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def test_healthz_and_slis_follow_the_fleet(model, tmp_path):
    tflags.set_flags({"telemetry_port": 0})
    try:
        router, reps = _fleet(model, tmp_path)
        try:
            port = texporter.port()
            code, body = _http_get(port, "/healthz")
            assert code == 200 and json.loads(body)["replicas"] == {
                "rep0": "ready", "rep1": "ready"}
            assert "paddle_fleet_sli_availability 1" in \
                _http_get(port, "/metrics")[1]
            assert "replicas:" in _http_get(port, "/statusz")[1]
            for r in reps:
                r.kill()
            router.poll()
            code, body = _http_get(port, "/healthz")
            assert code == 503
            assert set(json.loads(body)["replicas"].values()) == {"dead"}
        finally:
            router.close()
    finally:
        tflags.set_flags({"telemetry_port": -1})


# -- subprocess replicas ---------------------------------------------------------

def _sub_config(factory):
    return {"factory": f"_torch_fleet_models:{factory}",
            "engine": {**ENG, "journal_flush_every": 1},
            "max_queue": 8, "hb_interval_s": 0.1, "step_sleep_s": 0.02}


SUB_TIMEOUT_S = 55.0      # the subprocess test's own limit, start to end


def test_subprocess_sigkill_survivor_finishes_byte_identical(model,
                                                             tmp_path):
    end = time.monotonic() + SUB_TIMEOUT_S
    env = dict(os.environ, PYTHONPATH=TESTS)
    reps = [SubprocessReplicaHandle(f"sub{i}", str(tmp_path / f"sub{i}"),
                                    _sub_config("build_tiny"),
                                    spawn_env=env)
            for i in range(2)]
    router = ReplicaRouter(reps, block_size=ENG["block_size"],
                           heartbeat_timeout_s=5.0, submit_deadline_s=20.0)
    try:
        router.start()
        router.wait_ready(timeout_s=end - 25.0 - time.monotonic())
        gids = [router.submit(p, max_new_tokens=8)
                for p in _families(3, 2, rng_seed=13)]
        victim = router._outstanding[gids[-1]].replica
        next(r for r in reps if r.name == victim).kill()      # SIGKILL
        router.drain_all(timeout_s=end - time.monotonic())
        assert router.rerouted_requests >= 1
        assert router.dropped_requests == 0
        _assert_byte_identical(router, model)
    finally:
        router.close()


def test_worker_asked_for_the_card_raises_rather_than_serve(tmp_path):
    env = dict(os.environ, PYTHONPATH=TESTS)
    rep = SubprocessReplicaHandle("cuda0", str(tmp_path / "c"),
                                  _sub_config("build_on_cuda"),
                                  spawn_env=env)
    rep.start()
    try:
        rc = rep._proc.wait(timeout=45.0)
        assert rc != 0 and not rep.status()["alive"]
        log = (tmp_path / "c" / "worker-0.log").read_text()
        assert "CUDA" in log
    finally:
        rep.stop()
