"""The ragged engine's ``serving.*`` series and ``add_request(rid=,
out_tokens=, tenant=)`` against the JAX package's engine, at a tiny size.

The same requests (numpy, seeded) go through both packages' ragged
engines over the same weights (``from_jax_state_dict``). Each package's
process-wide registry is read before and after: every ``serving.*``
counter moves by the same amount, every gauge ends at the same value and
every histogram counts the same observations, in each scenario (plain,
a prefix-cache hit, LIFO preemption, speculative decoding, an int8 pool,
chunked prefill, a full queue, tenants and journal replay). Held within
the port: ``QueueFull.retry_after_hint`` is the queue-wait histogram's
median, the captured step publishes the same series as the eager one,
and ``FLAGS_metrics=0`` leaves every series as it was.
"""

import importlib

import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu import flags as jflags
from paddle_tpu.models import LlamaConfig as JConfig
from paddle_tpu.models import LlamaForCausalLM as JModel
from paddle_tpu.models.serving import ContinuousBatchingEngine as JEngine
from paddle_tpu.models.serving import QueueFull as JQueueFull
from paddle_tpu.observability import metrics as jmetrics
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch.models import (ContinuousBatchingEngine, LlamaConfig,
                                     LlamaForCausalLM, QueueFull,
                                     from_jax_state_dict)
from paddle_tpu_torch.observability import metrics as tmetrics

import _torch_ref_state
from _torch_ref_state import (  # noqa: F401  (an autouse fixture)
    plant_loaded_executables, reference_executables_dropped)

CFG = dict(vocab_size=128, hidden_size=64, intermediate_size=160,
           num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
           max_position_embeddings=128)


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jm = JModel(JConfig(**CFG))
    jm.eval()
    tm = LlamaForCausalLM(LlamaConfig(**CFG), device="cpu")
    from_jax_state_dict(tm, {k: np.asarray(v._data)
                             for k, v in jm.state_dict().items()})
    return jm, tm


def _prompts(seed, lens):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 128, n).tolist() for n in lens]


# the ragged engine's series (the reference's ``models/serving.py:84-141``)
# and the serving fallback counters (``ops/kernels/serving.py:42-49``); the
# reference's registry may also hold other modules' ``serving.*`` series
ENGINE_SERIES = frozenset({
    "serving.steps", "serving.step_tokens", "serving.generated_tokens",
    "serving.prefill_tokens", "serving.admitted", "serving.finished",
    "serving.preemptions", "serving.queue_depth", "serving.active_rows",
    "serving.prefill_backlog_tokens", "serving.free_blocks",
    "serving.prefix_cache.hit_blocks", "serving.prefix_cache.miss_blocks",
    "serving.prefix_cache.shared_tokens", "serving.prefix_cache.evictions",
    "serving.cow_copies", "serving.ttft_seconds", "serving.tpot_seconds",
    "serving.queue_wait_seconds", "serving.rejected",
    "serving.kv.bytes_per_token", "serving.kv.dequant_blocks",
    "serving.kv.fallback", "serving.spec.proposed", "serving.spec.accepted",
    "serving.spec.rejected", "serving.spec.verify_rows",
    "serving.spec.fallback"})


def _serving(registry):
    """Every ``serving.*`` instrument's reading: a counter's value, a
    gauge's value, a histogram's count."""
    out = {}
    for key, s in registry.snapshot().items():
        if key.startswith("serving."):
            out[key] = s["count"] if s["type"] == "histogram" else s["value"]
    return out


def _delta(before, after, registry):
    kinds = {k: s["type"] for k, s in registry.snapshot().items()}
    return {k: (v if kinds[k] == "gauge" else v - before.get(k, 0))
            for k, v in after.items()}


def _moved(before, after):
    """The series whose reading changed between the two readings (a new
    one from 0): what the engines run between them moved, whatever other
    series the process-wide registry holds."""
    return {k for k, v in after.items() if (v or 0) != (before.get(k) or 0)}


HEAD = _prompts(9, [40])[0]
SCENARIOS = {
    "plain": dict(lens=(5, 9, 7, 20, 3), n_new=6, kw={}),
    "prefix_hit": dict(prompts=[HEAD + [1, 2], HEAD + [5]], n_new=4, kw={},
                       one_by_one=True),
    "preemption": dict(prompts=[[3, 4, 5], [9, 8, 7]], n_new=24,
                       kw=dict(max_batch=2, num_blocks=4,
                               preempt_after=4)),
    "speculative": dict(prompts=[[3, 4, 5, 6] * 4, [9, 8, 7] * 5 + [1]],
                        n_new=10, kw=dict(speculative_k=3,
                                          token_budget=24)),
    "int8": dict(lens=(6, 17, 4), n_new=5, kw=dict(kv_dtype="int8")),
    "chunked": dict(lens=(41, 4), n_new=6,
                    kw=dict(max_batch=2, prefill_chunk=8, token_budget=10)),
}


def _drive(cls, model, sc, tenants=None):
    kw = dict(max_batch=4, num_blocks=64, block_size=16, temperature=0.0)
    kw.update(sc["kw"])
    eng = cls(model, **kw)
    prompts = sc.get("prompts") or _prompts(1, sc["lens"])
    rids, out = [], {}
    for i, p in enumerate(prompts):
        t = None if tenants is None else tenants[i % len(tenants)]
        rids.append(eng.add_request(p, max_new_tokens=sc["n_new"],
                                    tenant=t))
        if sc.get("one_by_one"):
            out.update(eng.run())
    out.update(eng.run())
    return [[int(t) for t in out[r]] for r in rids], eng


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_serving_series_equal_reference(models, name):
    jm, tm = models
    sc = SCENARIOS[name]
    jr, tr = jmetrics.registry(), tmetrics.registry()
    j0, t0 = _serving(jr), _serving(tr)
    want, jeng = _drive(JEngine, jm, sc)
    got, teng = _drive(ContinuousBatchingEngine, tm, sc)
    assert got == want
    jd = _delta(j0, _serving(jr), jr)
    td = _delta(t0, _serving(tr), tr)
    # the resilient engine's ``serving.resilience.*`` series register when
    # ``paddle_tpu_torch.serving`` is imported (another file of this worker)
    assert {k for k in td if "{" not in k and not k.startswith(
        "serving.resilience.")} == ENGINE_SERIES <= set(jd)
    assert {k: td[k] for k in ENGINE_SERIES} == \
        {k: jd[k] for k in ENGINE_SERIES}
    # the scenario moved what it is about
    moved = {"prefix_hit": "serving.prefix_cache.hit_blocks",
             "preemption": "serving.preemptions",
             "speculative": "serving.spec.proposed",
             "int8": "serving.kv.dequant_blocks",
             "chunked": "serving.prefill_tokens",
             "plain": "serving.ttft_seconds"}[name]
    assert td[moved] > 0
    assert td["serving.finished"] == td["serving.ttft_seconds"] == len(got)


def test_tenants_and_rejections_equal_reference(models):
    jm, tm = models
    prompts = _prompts(2, (5, 6, 7))
    res = {}
    for cls, qf, reg in ((JEngine, JQueueFull, jmetrics.registry()),
                         (ContinuousBatchingEngine, QueueFull,
                          tmetrics.registry())):
        before = _serving(reg)
        eng = cls(jm if cls is JEngine else tm, max_batch=2, num_blocks=32,
                  block_size=16, temperature=0.0, max_queue=2)
        eng.add_request(prompts[0], 3, tenant="acme")
        eng.add_request(prompts[1], 3, tenant="zeta")
        # the hint is the queue-wait p50 at the rejection (the run below
        # adds this engine's waits, which may move it a bucket)
        p50 = reg.get("serving.queue_wait_seconds").quantile(0.5) \
            if cls is ContinuousBatchingEngine else None
        with pytest.raises(qf) as e:
            eng.add_request(prompts[2], 3, tenant="acme")
        hint = e.value.retry_after_hint
        eng.run()
        after = _serving(reg)
        res[cls] = (_delta(before, after, reg), {
            k for k in _moved(before, after) if "{" in k},
            [r.out_tokens for r in eng.results.values()])
        if cls is ContinuousBatchingEngine:
            assert hint == p50
    (jd, kids, jt), (td, tkids, tt) = res[JEngine], \
        res[ContinuousBatchingEngine]
    assert [[int(x) for x in r] for r in jt] == tt
    assert tkids == kids
    assert kids == {'serving.admitted{tenant="acme"}',
                    'serving.admitted{tenant="zeta"}',
                    'serving.rejected{tenant="acme"}'}
    assert {k: td[k] for k in kids} == {k: jd[k] for k in kids} == {
        'serving.admitted{tenant="acme"}': 1,
        'serving.admitted{tenant="zeta"}': 1,
        'serving.rejected{tenant="acme"}': 1}
    assert td["serving.rejected"] == jd["serving.rejected"] == 1


def test_survives_gauges_another_replica_left(models):
    """The order that failed in a whole run: ``tests/test_perf_attribution.py``
    merges a worker's ``serving.*`` delta into the reference's registry
    under ``replica="repT"`` (``merge_delta``), which leaves labelled gauges
    (free blocks, active rows) at non-zero values for the rest of the
    process. Planted here the same way: the tenants test counts only the
    labelled series its own engines moved."""
    jm, _ = models
    reg = jmetrics.registry()
    _drive(JEngine, jm, SCENARIOS["plain"])     # gauges with values
    reg.merge_delta(reg.delta_update({}, ("serving.",)),
                    labels={"replica": "planted"})
    planted = [k for k, v in _serving(reg).items()
               if 'replica="planted"' in k and v]
    assert 'serving.free_blocks{replica="planted"}' in planted
    try:
        test_tenants_and_rejections_equal_reference(models)
    finally:
        for k in list(reg._metrics):
            if 'replica="planted"' in k:
                del reg._metrics[k]


def test_retry_after_hint_is_the_queue_wait_median(models):
    _, tm = models
    eng = ContinuousBatchingEngine(tm, max_batch=1, num_blocks=32,
                                   block_size=16, max_queue=1)
    eng.add_request([1, 2, 3], 2)
    eng.run()
    eng.add_request([4, 5, 6], 2)
    with pytest.raises(QueueFull) as e:
        eng.add_request([7, 8], 2)
    h = tmetrics.registry().get("serving.queue_wait_seconds")
    assert e.value.retry_after_hint is not None
    assert e.value.retry_after_hint == h.quantile(0.5)


@pytest.mark.parametrize("cut", [1, 4])
def test_journal_replay_equals_reference(models, cut):
    """A request resumed from its first ``cut`` tokens under its original
    rid finishes with the uninterrupted run's tokens, observes no TTFT or
    TPOT, and moves the series as the reference's does."""
    jm, tm = models
    prompt = _prompts(3, [11])[0]
    res = {}
    for cls, model, reg in ((JEngine, jm, jmetrics.registry()),
                            (ContinuousBatchingEngine, tm,
                             tmetrics.registry())):
        kw = dict(max_batch=2, num_blocks=32, block_size=16,
                  temperature=0.0)
        full = cls(model, **kw)
        full.add_request(prompt, 8, rid=7)
        want = [int(t) for t in full.run()[7]]
        before = _serving(reg)
        eng = cls(model, **kw)
        eng.add_request(prompt, 8, rid=7, out_tokens=want[:cut])
        got = [int(t) for t in eng.run()[7]]
        assert eng._next_rid == 8
        with pytest.raises(ValueError, match="already journaled"):
            eng.add_request(prompt, 8, rid=7)
        with pytest.raises(ValueError, match="nothing left"):
            eng.add_request(prompt, 8, rid=9, out_tokens=want)
        res[cls] = got, want, _delta(before, _serving(reg), reg)
    (jg, jw, jd), (tg, tw, td) = res[JEngine], res[ContinuousBatchingEngine]
    assert tg == tw == jg == jw
    assert {k: td[k] for k in ENGINE_SERIES} == \
        {k: jd[k] for k in ENGINE_SERIES}
    assert td["serving.ttft_seconds"] == td["serving.tpot_seconds"] == 0
    assert td["serving.generated_tokens"] == 8 - cut


def test_metrics_flag_off_leaves_every_series(models):
    _, tm = models
    reg = tmetrics.registry()
    before = reg.snapshot()
    tflags.set_flags({"metrics": False})
    try:
        eng = ContinuousBatchingEngine(tm, max_batch=2, num_blocks=32,
                                       block_size=16, temperature=0.0)
        for p in _prompts(4, (5, 9)):
            eng.add_request(p, 3)
        eng.run()
    finally:
        tflags.set_flags({"metrics": True})
    after = reg.snapshot()
    assert {k: v for k, v in after.items() if k.startswith("serving.")} == \
        {k: v for k, v in before.items() if k.startswith("serving.")}


def test_captured_and_eager_steps_publish_alike(models):
    """The step graph's replay (a stand-in on the CPU) and the eager step
    move the series by the same amounts."""
    _, tm = models
    reg = tmetrics.registry()
    deltas = []
    for capture in (True, False):
        tflags.set_flags({"step_capture": capture})
        try:
            b = _serving(reg)
            _drive(ContinuousBatchingEngine, tm, SCENARIOS["plain"])
            d = _delta(b, _serving(reg), reg)
        finally:
            tflags.set_flags({"step_capture": True})
        deltas.append({k: v for k, v in d.items() if "{" not in k})
    assert deltas[0] == deltas[1]
    assert deltas[0]["serving.steps"] > 1


def test_port_registers_only_frozen_names():
    """Every name the port's framework code registers is in the frozen
    taxonomy (``metrics.METRIC_NAMES``), as the reference requires of its
    own sources."""
    import paddle_tpu_torch.models.serving  # noqa: F401  (registers)
    import paddle_tpu_torch.observability.exporter  # noqa: F401
    names = {m.name for m in (tmetrics.registry().get(k) for k in
                              tmetrics.registry().names())}
    framework = {n for n in names if not n.startswith(("my.", "test."))}
    assert framework - tmetrics.METRIC_NAMES == set()
    assert tmetrics.METRIC_NAMES == jmetrics.METRIC_NAMES


def test_survives_executables_a_warm_start_left(models, tmp_path):
    """The order that failed: a file that warm-starts the reference from
    a disk store (``tests/test_exec_store.py``) and then this file in one
    worker. The state is planted here (the preemption scenario's
    executables loaded from disk) and shown to break the reference's
    engine; the function the start-up fixture runs makes the scenario
    equal again; and every file that runs the reference's tiny Llama
    carries that fixture, so removing it from one fails here."""
    jm, _ = models
    sc = SCENARIOS["preemption"]
    planted = plant_loaded_executables(str(tmp_path),
                                       lambda: _drive(JEngine, jm, sc))
    assert "8 shards" in str(planted)
    with pytest.raises(Exception, match="8 shards"):
        _drive(JEngine, jm, sc)
    _torch_ref_state.drop_reference_executables()
    test_serving_series_equal_reference(models, "preemption")
    missing = [name for name in _torch_ref_state.FILES if getattr(
        importlib.import_module(name), "reference_executables_dropped",
        None) is not _torch_ref_state.reference_executables_dropped]
    assert missing == []
