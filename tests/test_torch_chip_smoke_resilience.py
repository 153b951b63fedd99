"""``chip_smoke.py``'s ``serve_resilient`` and ``serve_fleet`` phases,
rehearsed on the CPU at a tiny size (the 2-layer float32 Llama of
``_torch_fleet_models``, prompts of 40-120 tokens in four families,
24 new tokens, 16-token blocks, small pools, a burst of 32) with the script's card calls stubbed: the
resilient engine against the plain one (tokens, ragged launches and host
syncs a step), kill -> replay, drain -> warm start over a bf16 and an int8
pool (the preload bit for bit, a prefix hit), a held step's
``serving.hang`` bundle naming the host's wait on the card, the thread
fleet (kill, rolling drain, burst) and the subprocess fleet with a
SIGKILL. The phases' checks are what a failing run would trip on the
card."""

import importlib.util
import os
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch.models import serving as serving_mod
from paddle_tpu_torch.ops.kernels import paged_attention as pa
from paddle_tpu_torch.ops.kernels import ragged_paged_attention as rpa

import _torch_fleet_models

ROOT = Path(__file__).resolve().parents[1]
TESTS = str(Path(__file__).resolve().parent)


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_resilience_under_test", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _make_requests(cfg, seed, n=16, shared_prefix=32):
    rng = np.random.RandomState(seed)
    prompts = [rng.randint(0, cfg.vocab_size, int(m)).astype(np.int32)
               for m in rng.randint(40, 121, n)]
    prompts[-1] = np.concatenate([prompts[0][:shared_prefix],
                                  prompts[-1][shared_prefix:]])
    return prompts


@pytest.fixture
def on_cpu(smoke, monkeypatch):
    """The card calls as no-ops (a held step waits in the engine's host
    read, as on the card), the kernels' wrappers counting the launch the
    card would make, the script's sizes cut."""
    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", lambda m: None)
    monkeypatch.setattr(pa, "sm_count", lambda device: 132)
    real = rpa.ragged_paged_attention

    def bumped(*a, **k):
        rpa.launches.add()
        return real(*a, **k)
    monkeypatch.setattr(rpa, "ragged_paged_attention", bumped)
    hold = []
    read = serving_mod._host_read
    ns = {"_hold": hold, "_read": read, "time": time}
    exec(compile("def _host_read(t):\n"
                 "    if _hold:\n"
                 "        time.sleep(_hold.pop())\n"
                 "    return _read(t)\n", serving_mod.__file__, "exec"), ns)
    monkeypatch.setattr(serving_mod, "_host_read", ns["_host_read"])
    monkeypatch.setattr(torch.cuda, "_sleep", hold.append)
    monkeypatch.setattr(smoke, "sleep_cycles", lambda torch, s: s)
    monkeypatch.setattr(smoke, "CARD", "cpu")
    monkeypatch.setattr(smoke, "make_requests", _make_requests)
    monkeypatch.setattr(smoke, "SERVE_KW", dict(
        max_batch=16, block_size=16, token_budget=64, prefill_chunk=32,
        kv_pool_bytes=4 << 20))
    monkeypatch.setattr(smoke, "FLEET_SUB_POOL", 2 << 20)
    monkeypatch.setattr(smoke, "RESILIENT_NEW", 24)
    monkeypatch.setattr(smoke, "FLEET_BURST", 32)
    monkeypatch.setattr(smoke, "FLEET_FACTORY",
                        "_torch_fleet_models:build_tiny")
    monkeypatch.setattr(smoke, "fleet_model",
                        lambda torch, seed, device:
                        _torch_fleet_models.build_tiny())
    monkeypatch.setenv("PYTHONPATH", TESTS)
    # the tiny model's ops are too small to share out: one thread here and
    # in the workers keeps them from spinning against other test processes
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    # other files of this process may have recorded a hang or a failover
    # inside the default 30 s; on the card these phases record the first
    saved = tflags.get_flag("incident_rate_limit_s")
    tflags.set_flags({"incident_rate_limit_s": 0.0})
    fleet_run = smoke.fleet_run

    def card_paced(*a, max_queue=None, **k):
        """The burst's replicas step at a card's pace (a step of the tiny
        model on the CPU takes a few ms, the 8B model's on the card tens),
        so a burst outruns them as it does there."""
        router, reps = fleet_run(*a, max_queue=max_queue, **k)
        if max_queue is not None:
            for r in reps:
                inner = r.eng.engine
                step = inner.step

                def paced(step=step):
                    time.sleep(0.01)
                    return step()
                inner.step = paced
        return router, reps
    monkeypatch.setattr(smoke, "fleet_run", card_paced)
    yield smoke
    tflags.set_flags({"incident_rate_limit_s": saved})
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def model():
    return _torch_fleet_models.build_tiny()


def test_serve_resilient_phase_on_the_cpu(on_cpu, model):
    report = {}
    res, want = on_cpu.phase_serve_resilient(torch, 0, report, model)
    assert len(want) == 16 and all(len(t) == 24 for t in want.values())
    un = res["uninterrupted"]
    assert un["resilient"]["ragged_per_step"] == \
        un["plain"]["ragged_per_step"] == 2           # one a layer
    assert un["resilient"]["journal_flushes"] > 0
    assert res["replay"]["replayed_requests"] > 0
    assert res["replay"]["recovered_finished"] >= 2
    for kv in ("bf16", "int8"):
        w = res["warm"][kv]
        assert w["warm_blocks"] > 0 and w["prefix_hit_blocks"] >= 2
    assert res["hang"]["stack_classes"]["device_call"] >= 1
    assert "perf.json" not in res["hang"]["files"]
    assert res["launches"]["ragged_paged_attention"] > 0
    assert report["serve_resilient"] is res


def test_serve_fleet_phase_on_the_cpu(on_cpu, model):
    prompts = on_cpu.family_requests(model.config, 0)
    one = serving_mod.ContinuousBatchingEngine(
        model, temperature=on_cpu.RESILIENT_T, seed=on_cpu.RESILIENT_SEED,
        **on_cpu.SERVE_KW)
    for i, p in enumerate(prompts):
        one.add_request(p, max_new_tokens=24, rid=i)
    one.run()
    want = {i: list(one.results[i].out_tokens) for i in range(16)}
    report = {}
    res = on_cpu.phase_serve_fleet(torch, 0, report, model, want)
    th = res["threads"]
    assert th["kill"]["rerouted"] >= 1 and th["kill"]["bundle_victims"] >= 1
    assert th["burst"]["shed"] > 0 and th["burst"]["served"] > 0
    assert th["rolling_drain"]["drained"] == [1, 1]
    sub = res["subprocesses"]
    assert sub["rerouted"] >= 1 and sub["failover_s"] >= 0
    assert set(sub["spawn_to_ready_s"]) == {"p0", "p1"}
