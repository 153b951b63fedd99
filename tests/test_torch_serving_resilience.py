"""Serving resilience (``paddle_tpu_torch.serving.resilience``) against the
JAX package's, at a tiny size (2 layers, hidden 64, ``block_size=16``).

Both packages get the same weights (``from_jax_state_dict``) and the same
requests (numpy, seeded). Held across the packages: the weights
fingerprint, kill -> replay outputs at temperature 0, a journal the
reference wrote replaying in the port to the reference's tokens, warm-
cache generations preloading both ways (bf16 and int8 pools, the KV bytes
equal, a prefix hit), the refusals with the reference's messages. Held
within the port: kill -> replay byte-identical at temperature 0.9, drain
(admission stops, preemption at the deadline, the journal committed),
bounded admission's ``QueueFull`` hint, the watchdog's NOT_READY window
and its ``serving.hang`` bundle, SIGTERM into the drain, and the
``exec_store_dir`` refusal.
"""

import json
import os
import signal
import time

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import LlamaConfig as JConfig
from paddle_tpu.models import LlamaForCausalLM as JModel
from paddle_tpu.observability.metrics import registry as jregistry
from paddle_tpu.serving.resilience import ResilientServingEngine as JEngine
from paddle_tpu.serving.resilience import warm_cache as jwarm
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch.distributed.fleet import PreemptionHandler
from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                     QueueFull, from_jax_state_dict)
from paddle_tpu_torch.observability import STACK_CLASSES, registry
from paddle_tpu_torch.serving.resilience import (ResilientServingEngine,
                                                 ServingAction)
from paddle_tpu_torch.serving.resilience import warm_cache as twarm
from paddle_tpu_torch.utils.durability import read_committed_marker

from _torch_ref_state import reference_executables_dropped  # noqa: F401

CFG = dict(vocab_size=128, hidden_size=64, intermediate_size=160,
           num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
           max_position_embeddings=256)
ENG = dict(max_batch=4, num_blocks=64, block_size=16, temperature=0.9,
           seed=17)
GREEDY = dict(ENG, temperature=0.0)


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jm = JModel(JConfig(**CFG))
    jm.eval()
    tm = LlamaForCausalLM(LlamaConfig(**CFG), device="cpu")
    from_jax_state_dict(tm, {k: np.asarray(v._data)
                             for k, v in jm.state_dict().items()})
    return jm, tm


def _requests(n=4, head_blocks=0, rng_seed=0, bs=16):
    rng = np.random.RandomState(rng_seed)
    head = rng.randint(0, 128, head_blocks * bs).tolist()
    return [head + rng.randint(0, 128, 4 + 2 * i).tolist()
            for i in range(n)]


def _counter(name):
    return registry().get(name).value


def _run(cls, model, root, prompts, max_new=6, **kw):
    eng = cls(model, root, **{**ENG, **kw})
    for p in prompts:
        eng.add_request(p, max_new_tokens=max_new)
    assert eng.run() == ServingAction.COMPLETED
    out = {r: [int(t) for t in v] for r, v in eng.outputs.items()}
    eng.close()
    return out


def _killed(cls, model, root, prompts, steps, max_new=6, **kw):
    """Admit, step ``steps`` times, flushing every step, then drop the
    engine with no drain or close (the image of a SIGKILL)."""
    eng = cls(model, root, journal_flush_every=1, **{**ENG, **kw})
    for p in prompts:
        eng.add_request(p, max_new_tokens=max_new)
    for _ in range(steps):
        eng.step()
    partial = {r.rid: len(r.out_tokens) for r in eng.engine.results.values()}
    del eng
    return partial


def _replayed(cls, model, root, **kw):
    eng = cls(model, root, **{**ENG, **kw})
    counts = (eng.replayed_requests, eng.recovered_finished)
    assert eng.run() == ServingAction.COMPLETED
    out = {r: [int(t) for t in v] for r, v in eng.outputs.items()}
    eng.close()
    return out, counts


# -- the weights fingerprint -----------------------------------------------------

def test_fingerprints_equal_across_packages(models):
    jm, tm = models
    assert twarm._model_fingerprint(tm) == jwarm._model_fingerprint(jm)
    # bf16 weights hash their 16 bits in both
    jbf = JModel(JConfig(**dict(CFG, dtype="bfloat16")))
    bf = LlamaForCausalLM(LlamaConfig(**dict(CFG, dtype="bfloat16")),
                          device="cpu")
    from_jax_state_dict(bf, {k: np.asarray(v._data)
                             for k, v in jbf.state_dict().items()})
    assert twarm._model_fingerprint(bf) == jwarm._model_fingerprint(jbf)
    assert twarm._model_fingerprint(bf) != twarm._model_fingerprint(tm)


# -- replay ----------------------------------------------------------------------

@pytest.mark.parametrize("steps", [2, 5])
def test_replay_is_byte_identical_at_temperature_09(models, tmp_path,
                                                    steps):
    """Killed mid-stream, relaunched on the same root: the sampled
    outputs equal an uninterrupted run's, the finished ones loaded from
    the log."""
    _, tm = models
    prompts = _requests(4)
    want = _run(ResilientServingEngine, tm, str(tmp_path / "ref"), prompts)
    partial = _killed(ResilientServingEngine, tm, str(tmp_path / "j"),
                      prompts, steps)
    assert any(0 < v < 6 for v in partial.values())       # mid-stream
    got, (replayed, finished) = _replayed(ResilientServingEngine, tm,
                                          str(tmp_path / "j"))
    assert got == want
    assert replayed + finished == 4 and replayed > 0


def test_kill_replay_equals_reference_at_temperature_0(models, tmp_path):
    jm, tm = models
    prompts = _requests(3, head_blocks=1, rng_seed=5)
    outs = {}
    for cls, m in ((JEngine, jm), (ResilientServingEngine, tm)):
        root = str(tmp_path / cls.__module__.split(".")[0])
        _killed(cls, m, root, prompts, 3, temperature=0.0)
        outs[cls], _ = _replayed(cls, m, root, temperature=0.0)
    assert outs[ResilientServingEngine] == outs[JEngine]
    # a journal the reference wrote replays in the port to its tokens
    root = str(tmp_path / "cross")
    partial = _killed(JEngine, jm, root, prompts, 3, temperature=0.0)
    assert any(v > 0 for v in partial.values())
    got, (replayed, _) = _replayed(ResilientServingEngine, tm, root,
                                   temperature=0.0)
    assert replayed > 0 and got == outs[JEngine]


def test_journal_refuses_other_weights_with_reference_message(models,
                                                              tmp_path):
    jm, tm = models
    other = LlamaForCausalLM(LlamaConfig(**CFG), device="cpu",
                             generator=torch.Generator().manual_seed(9))
    msgs = {}
    for name, cls, m in (("ref", JEngine, jm),
                         ("port", ResilientServingEngine, tm)):
        root = str(tmp_path / name)
        e = cls(m, root, **ENG)
        e.add_request([1, 2, 3], max_new_tokens=2)
        del e
        wrong = other if name == "port" else JModel(JConfig(**CFG))
        with pytest.raises(RuntimeError, match="fingerprint mismatch") as e:
            cls(wrong, root, **ENG)
        msgs[name] = str(e.value).replace(root, "<root>")
    assert msgs["port"] == msgs["ref"]


# -- drain -----------------------------------------------------------------------

def test_drain_stops_admission_preempts_and_commits(models, tmp_path):
    _, tm = models
    prompts = _requests(3)
    want = _run(ResilientServingEngine, tm, str(tmp_path / "ref"), prompts,
                max_new=8)
    e1 = ResilientServingEngine(tm, str(tmp_path / "d"), **ENG)
    for p in prompts:
        e1.add_request(p, max_new_tokens=8)
    e1.step()
    e1.step()
    d0 = _counter("serving.resilience.drains")
    e1.drain(deadline_s=0.0)
    assert _counter("serving.resilience.drains") == d0 + 1
    assert e1.engine.admission_paused and e1.phase == "drained"
    md = e1.journal.committed_marker()
    assert md["drained"] is True and md["remaining"] > 0
    with pytest.raises(RuntimeError, match="drained"):
        e1.add_request([1], max_new_tokens=1)
    assert e1.run() == ServingAction.DRAINED
    e1.close()
    got, (replayed, _) = _replayed(ResilientServingEngine, tm,
                                   str(tmp_path / "d"))
    assert replayed == md["remaining"] and got == want


def test_generous_deadline_finishes_in_flight(models, tmp_path):
    _, tm = models
    e1 = ResilientServingEngine(tm, str(tmp_path / "d"), **ENG)
    for p in _requests(2):
        e1.add_request(p, max_new_tokens=3)
    e1.step()
    assert e1.drain(deadline_s=60.0) < 60.0
    assert e1.journal.committed_marker()["remaining"] == 0
    e1.close()
    e2 = ResilientServingEngine(tm, str(tmp_path / "d"), **ENG)
    assert not e2.has_work and e2.recovered_finished == 2
    e2.close()


def test_sigterm_to_this_process_drains(models, tmp_path):
    _, tm = models
    e1 = ResilientServingEngine(tm, str(tmp_path / "s"),
                                install_signal=True, **ENG)
    try:
        for p in _requests(2):
            e1.add_request(p, max_new_tokens=3)
        assert e1.poll() == ServingAction.CONTINUE
        os.kill(os.getpid(), signal.SIGTERM)
        assert e1.run() == ServingAction.DRAINED
        assert e1.drained and e1.journal.committed_marker()["drained"]
    finally:
        e1.close()
    assert signal.getsignal(signal.SIGTERM) is not e1.handler


def test_preemption_handler_takes_no_manager_yet():
    with pytest.raises(NotImplementedError, match="A8"):
        PreemptionHandler(object())


# -- warm cache ------------------------------------------------------------------

def _pool_blocks(eng, tag, layer, blocks):
    """Pool rows of ``blocks`` as numpy (bf16 as its 16 bits)."""
    c = eng.engine.cache
    pools = {"k": c.k, "v": c.v, "ks": c.k_scale, "vs": c.v_scale}[tag]
    p = pools[layer]
    if isinstance(p, torch.Tensor):
        return twarm._host_bytes(p[torch.as_tensor(blocks)])
    a = np.asarray(p._data)[np.asarray(blocks)]
    return a.view(np.uint16) if str(a.dtype) == "bfloat16" else a


@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("writer", ["reference", "port"])
def test_warm_generation_preloads_in_the_other_package(models, tmp_path,
                                                       kv, writer):
    """One package serves a shared head and snapshots; the other
    preloads the generation: every tracked block's K/V (and an int8
    pool's scales) bit for bit the snapshot's, and a request on the head
    hits the prefix cache."""
    jm, tm = models
    pk = {"reference": (JEngine, jm), "port": (ResilientServingEngine, tm)}
    wcls, wm = pk[writer]
    rcls, rm = pk["port" if writer == "reference" else "reference"]
    root = str(tmp_path / "w")
    kw = dict(GREEDY, kv_dtype=kv)
    prompts = _requests(3, head_blocks=3, rng_seed=3)
    e1 = wcls(wm, root, **kw)
    for p in prompts:
        e1.add_request(p, max_new_tokens=4)
    e1.run()
    assert e1.snapshot() is not None
    e1.close()
    gen = twarm.latest_committed(e1.warm_root)
    meta = json.load(open(os.path.join(gen, "meta.json")))
    assert meta["dtype"] == ("int8" if kv == "int8" else "bfloat16")
    z = np.load(os.path.join(gen, "blocks.npz"))

    e2 = rcls(rm, root, **kw)
    assert e2.warm_blocks == len(meta["digests"]) >= 3
    pc = e2.engine._pc
    blocks = [pc._map[bytes.fromhex(d)] for d in meta["digests"]]
    tags = ("k", "v", "ks", "vs") if kv == "int8" else ("k", "v")
    for tag in tags:
        for layer in range(CFG["num_hidden_layers"]):
            got = _pool_blocks(e2, tag, layer, blocks)
            want = z[f"{tag}_{layer}"]
            assert got.tobytes() == want.tobytes(), (tag, layer)
    reg = registry() if rcls is ResilientServingEngine else jregistry()
    hit0 = reg.get("serving.prefix_cache.hit_blocks").value
    e2.add_request(prompts[0][:48] + [1, 2, 3], max_new_tokens=2)
    e2.run()
    assert reg.get("serving.prefix_cache.hit_blocks").value >= hit0 + 3
    e2.close()


def test_warm_start_gives_identical_output_and_hits(models, tmp_path):
    _, tm = models
    prompts = _requests(3, head_blocks=3, rng_seed=3)
    root = str(tmp_path / "w")
    cold = _run(ResilientServingEngine, tm, str(tmp_path / "cold"),
                [prompts[0][:48] + [7, 7]], max_new=4)
    e1 = ResilientServingEngine(tm, root, **ENG)
    for p in prompts:
        e1.add_request(p, max_new_tokens=4)
    e1.run()
    e1.drain()                                # commits a generation
    e1.close()
    hit0 = _counter("serving.prefix_cache.hit_blocks")
    e2 = ResilientServingEngine(tm, root, warm_start=True, **ENG)
    assert e2.warm_blocks >= 3
    rid = e2.add_request(prompts[0][:48] + [7, 7], max_new_tokens=4)
    e2.run()
    assert _counter("serving.prefix_cache.hit_blocks") >= hit0 + 2
    # the warm request samples rid 3's stream; the cold run's was rid 0
    assert len(e2.outputs[rid]) == 4 and len(cold[0]) == 4
    e2.close()


@pytest.mark.parametrize("change", ["block_size", "kv_dtype", "weights"])
def test_meta_mismatch_refuses_preload(models, tmp_path, change):
    _, tm = models
    root = str(tmp_path / "w")
    e1 = ResilientServingEngine(tm, root, **GREEDY)
    for p in _requests(2, head_blocks=2, rng_seed=3):
        e1.add_request(p, max_new_tokens=2)
    e1.run()
    e1.snapshot()
    e1.close()
    kw, model = dict(GREEDY), tm
    if change == "block_size":
        kw["block_size"] = 8
    elif change == "kv_dtype":
        kw["kv_dtype"] = "int8"
    else:
        model = LlamaForCausalLM(LlamaConfig(**CFG), device="cpu",
                                 generator=torch.Generator().manual_seed(3))
    eng = ResilientServingEngine(model, str(tmp_path / "fresh"), **kw)
    free = len(eng.engine.cache._free)
    assert twarm.load_prefix_cache(eng.engine, e1.warm_root) == 0
    assert len(eng.engine.cache._free) == free         # nothing taken
    eng.close()


# -- bounded admission, the watchdog, the refusals -------------------------------

def test_queue_full_carries_the_wait_hint(models, tmp_path):
    _, tm = models
    e1 = ResilientServingEngine(tm, str(tmp_path / "q"), max_queue=1,
                                **ENG)
    e1.add_request([1, 2, 3], max_new_tokens=2)
    e1.run()                                  # one queue wait observed
    e1.add_request([4, 5], max_new_tokens=2)
    recs = e1.journal.pending_records
    with pytest.raises(QueueFull) as e:
        e1.add_request([6], max_new_tokens=2)
    h = registry().get("serving.queue_wait_seconds")
    assert e.value.retry_after_hint == h.quantile(0.5) is not None
    assert e1.journal.pending_records == recs      # nothing journaled
    e1.close()


def test_watchdog_spares_not_ready_then_commits_hang_bundle(models,
                                                            tmp_path):
    _, tm = models
    saved = tflags.get_flag("incident_rate_limit_s")
    tflags.set_flags({"incident_rate_limit_s": 0.0})
    root = str(tmp_path / "h")
    try:
        e1 = ResilientServingEngine(tm, root, step_timeout_s=0.2, **ENG)
        e1.add_request([3, 1, 4], max_new_tokens=4)
        time.sleep(0.6)                   # stalled before the first step
        assert e1.phase == "not_ready"
        assert e1.poll() == ServingAction.CONTINUE
        e1.step()
        assert e1.phase == "ready"
        deadline = time.time() + 5.0
        while (e1.poll() != ServingAction.RESTART
               and time.time() < deadline):
            time.sleep(0.05)              # the "wedged" step
        assert e1.poll() == ServingAction.RESTART
        e1.close()
    finally:
        tflags.set_flags({"incident_rate_limit_s": saved})
    inc = os.path.join(root, "incidents")
    (bundle,) = [os.path.join(inc, d) for d in os.listdir(inc)
                 if d.startswith("incident-")]
    assert read_committed_marker(bundle)["kind"] == "serving.hang"
    hdr = json.load(open(os.path.join(bundle, "incident.json")))
    assert hdr["attrs"]["stalled_s"] >= 0.2 and hdr["step"] == 1
    assert set(hdr["stack_classes"]) <= STACK_CLASSES
    # the main thread sat in time.sleep under the test: "other"
    assert hdr["stack_classes"].get("other", 0) >= 1
    jr = json.load(open(os.path.join(bundle, "journal.json")))
    assert "watermarks" in jr and "next_segment" in jr
    # recovered like a kill
    got, (replayed, _) = _replayed(ResilientServingEngine, tm, root)
    assert replayed == 1 and len(got[0]) == 4


def test_exec_store_dir_raises_naming_a9(models, tmp_path):
    _, tm = models
    with pytest.raises(NotImplementedError, match="A9"):
        ResilientServingEngine(tm, str(tmp_path / "x"),
                               exec_store_dir=str(tmp_path / "store"),
                               **ENG)


def test_warmup_pays_the_capture_and_serves_nothing(models, tmp_path):
    _, tm = models
    e1 = ResilientServingEngine(tm, str(tmp_path / "u"), **ENG)
    assert e1.phase == "not_ready"
    assert e1.warmup() is True and e1.phase == "ready"
    assert e1.engine.capture_stats["captures"] == 1 and not e1.outputs
    assert e1.warmup() is False
    rid = e1.add_request([5, 6, 7], max_new_tokens=3)
    e1.run()
    assert len(e1.outputs[rid]) == 3
    e1.close()
    e2 = ResilientServingEngine(tm, str(tmp_path / "u"), **ENG)
    assert e2.recovered_finished == 1 and not e2.has_work
    e2.close()
