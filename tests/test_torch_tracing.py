"""``paddle_tpu_torch.observability.tracing`` against the JAX package's
``paddle_tpu.observability.tracing``.

- The same sequence of calls (activated and non-activating spans, nested
  children, retroactive spans, instants, span events, explicit carriers,
  inject / extract) gives the same span tree and the same Chrome-trace
  JSON in both packages, apart from ids and times: ids are compared by
  the relation they express (which span is whose parent, which spans
  share a trace).
- The same requests through both packages' ragged engines, inside one
  activated span, record the same spans and instants: each request's
  ``serving.queue`` / ``serving.prefill`` / ``serving.decode`` phases under
  the ambient trace, ``serving.first_token`` / ``serving.finish`` /
  ``serving.prefill_chunk`` / ``serving.preempt`` instants, one untraced
  ``serving.step`` span a step with its token counts (the reference's
  ``jit.compile`` spans, which the port has no compiler to record, left
  out).
- ``FLAGS_tracing=0`` records nothing; the ring keeps its newest entries
  when ``FLAGS_tracing_ring_size`` shrinks; the frozen span taxonomy is
  the reference's and rejects other names.
"""

import json

import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.models import LlamaConfig as JConfig
from paddle_tpu.models import LlamaForCausalLM as JModel
from paddle_tpu.models.serving import ContinuousBatchingEngine as JEngine
from paddle_tpu.observability import tracing as jtr
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch.models import (ContinuousBatchingEngine, LlamaConfig,
                                     LlamaForCausalLM, from_jax_state_dict)
from paddle_tpu_torch.observability import tracing as ttr

CFG = dict(vocab_size=128, hidden_size=64, intermediate_size=160,
           num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
           max_position_embeddings=128)


def _normalize(chrome, drop=("jit.compile",)):
    """Chrome events with ids replaced by their order of first
    appearance and times, pids and tids dropped."""
    ids = {}

    def rel(v):
        return ids.setdefault(v, f"#{len(ids)}")
    out = []
    for ev in chrome["traceEvents"]:
        if ev["name"] in drop:
            continue
        args = dict(ev["args"])
        for k in ("trace_id", "span_id", "parent_id"):
            if k in args:
                args[k] = rel(args[k])
        out.append((ev["name"], ev["ph"], ev.get("s"), ev["cat"],
                    json.dumps(args, sort_keys=True)))
    return out


def _calls(tr):
    tr.clear()
    with tr.span("fleet.submit", attrs={"rid": 1}) as root:
        root.set(replica="r0")
        root.event("fleet.queue_full", tries=2)
        with tr.span("serving.admit") as child:
            tr.event("fleet.retry", n=1)
            carrier = tr.inject()
            assert tr.current() == child.context
        held = tr.start_span("serving.drain", attrs={"k": 1})
        tr.instant("fleet.shed", attrs={"why": "slo"})
    held.end()
    held.end()                      # ending twice records once
    ctx = tr.extract(carrier)
    tok = tr.activate(ctx)
    tr.instant("fleet.failover")
    with tr.span("serving.recover"):
        pass
    tr.deactivate(tok)
    t0 = tr.now_ns()
    tr.record_span("serving.queue", t0 - 1000, t0, trace=ctx,
                   attrs={"rid": 1})
    tr.record_span("serving.step", t0 - 500, t0, attrs={"tokens": 3})
    tr.event("fleet.drain")         # no ambient span: an untraced instant
    live = tr.start_span("checkpoint.commit")
    chrome = tr.to_chrome()
    errors = []
    for fn in (lambda: tr.span("no.such.span"),
               lambda: tr.instant("no.such.event")):
        try:
            fn()
        except ValueError as e:
            errors.append(str(e))
    live.end()
    bad = [tr.extract(x) for x in (None, ["zz", "1"], ["1"])]
    return _normalize(chrome), errors, bad, json.loads(tr.dump_trace()) \
        is not None


def test_call_sequence_equals_reference():
    got, want = _calls(ttr), _calls(jtr)
    assert got == want
    names = [e[0] for e in got[0]]
    assert names.count("serving.admit") == 1 and "checkpoint.commit" in names


def test_span_taxonomy_is_the_reference():
    assert ttr.SPAN_NAMES == jtr.SPAN_NAMES


def test_tracing_off_records_nothing():
    ttr.clear()
    tflags.set_flags({"tracing": False})
    try:
        with ttr.span("serving.admit") as sp:
            sp.event("fleet.retry")
        ttr.instant("fleet.shed")
        ttr.record_span("serving.step", 0, 1)
        assert ttr.inject() is None and ttr.current() is None
    finally:
        tflags.set_flags({"tracing": True})
    assert ttr.to_chrome()["traceEvents"] == []


def test_ring_keeps_the_newest_when_it_shrinks():
    ttr.clear()
    size = tflags.get_flag("tracing_ring_size")
    for i in range(6):
        ttr.instant("fleet.retry", attrs={"i": i})
    tflags.set_flags({"tracing_ring_size": 4})
    try:
        kept = [e["args"]["i"] for e in ttr.to_chrome()["traceEvents"]]
        assert kept == [2, 3, 4, 5]
        ttr.instant("fleet.retry", attrs={"i": 6})
        kept = [e["args"]["i"] for e in ttr.to_chrome()["traceEvents"]]
        assert kept == [3, 4, 5, 6]
    finally:
        tflags.set_flags({"tracing_ring_size": size})
    ttr.clear()


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jm = JModel(JConfig(**CFG))
    jm.eval()
    tm = LlamaForCausalLM(LlamaConfig(**CFG), device="cpu")
    from_jax_state_dict(tm, {k: np.asarray(v._data)
                             for k, v in jm.state_dict().items()})
    return jm, tm


@pytest.mark.parametrize("preempt", [False, True])
def test_engine_spans_equal_reference(models, preempt):
    jm, tm = models
    rng = np.random.RandomState(4)
    prompts = ([[3, 4, 5], [9, 8, 7]] if preempt else
               [rng.randint(0, 128, n).tolist() for n in (5, 23, 9)])
    kw = (dict(max_batch=2, num_blocks=4, preempt_after=4, n_new=24)
          if preempt else dict(max_batch=2, num_blocks=32, n_new=5,
                               prefill_chunk=8, token_budget=12))
    n_new = kw.pop("n_new")
    runs = []
    for cls, model, tr in ((JEngine, jm, jtr),
                           (ContinuousBatchingEngine, tm, ttr)):
        tr.clear()
        eng = cls(model, block_size=16, temperature=0.0, **kw)
        with tr.span("fleet.submit"):
            for p in prompts:
                eng.add_request(p, max_new_tokens=n_new)
        eng.run()
        events = _normalize(tr.to_chrome())
        runs.append((sorted(events), eng.steps))
        tr.clear()
    (want, jsteps), (got, tsteps) = runs
    assert tsteps == jsteps
    assert got == want
    names = [e[0] for e in got]
    assert names.count("serving.step") == tsteps
    assert names.count("serving.queue") == names.count(
        "serving.first_token") == len(prompts)
    if preempt:
        assert "serving.preempt" in names
