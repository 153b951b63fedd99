"""The port's ``GangScheduledEngine`` against the JAX package's, at a tiny
size.

The JAX model's seeded weights move across with ``from_jax_state_dict``;
both packages see the same prompts (numpy, seeded). Held to the
reference: the gang engine's greedy tokens, token for token, on the
prompts of ``tests/test_continuous_batching.py:163-192`` and under LIFO
preemption with recompute on resume (the same preemption count); over an
int8 pool, the reference's ragged engine's tokens (see
``test_gang_int8_matches_reference_ragged``). Held within the
port: the ragged engine with chunked prefill equals the gang engine in
float32, the gang engine equals ``generate()`` over either cache, the
rows without a request write only the trash block, and
``FLAGS_speculative_k`` counts ``spec_gang_engine``."""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import flags as jflags
from paddle_tpu.models import LlamaConfig as JConfig
from paddle_tpu.models import LlamaForCausalLM as JModel
from paddle_tpu.models.serving import ContinuousBatchingEngine as JRagged
from paddle_tpu.models.serving import GangScheduledEngine as JGang
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch.models import (ContinuousBatchingEngine,
                                     GangScheduledEngine, LlamaConfig,
                                     LlamaForCausalLM, from_jax_state_dict)
from paddle_tpu_torch.observability import flight_recorder, registry

from _torch_ref_state import reference_executables_dropped  # noqa: F401

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


def _run(engine_cls, model, prompts, n_new, **kw):
    eng = engine_cls(model, **kw)
    rids = [eng.add_request(p, max_new_tokens=n_new) for p in prompts]
    res = eng.run()
    return [[int(t) for t in res[r]] for r in rids], eng


def _cases(case):
    return (_prompts(7, (5, 9)) if case == "two_rows"
            else _prompts(0, (5, 9, 7, 20, 3)))


@pytest.mark.parametrize("case", ["two_rows", "queued"])
def test_gang_greedy_matches_reference_gang(models, case):
    """Seed 7's prompts (5, 9) of the reference's gang test, and five
    prompts through two rows (slots refill as requests finish)."""
    jm, tm = models
    prompts = _cases(case)
    kw = dict(max_batch=2, num_blocks=32, block_size=16, temperature=0.0)
    want, _ = _run(JGang, jm, prompts, 6, **kw)
    got, eng = _run(GangScheduledEngine, tm, prompts, 6, **kw)
    assert got == want
    assert eng.prefills == len(prompts)


@pytest.mark.parametrize("case", ["two_rows", "queued"])
def test_gang_int8_matches_reference_ragged(models, case):
    """Over an int8 pool the port's gang prefill attends the quantized
    pool (the ragged kernel), as both packages' ragged engines do; the
    reference's gang prefill attends the unquantized prompt K/V, so its
    tokens drift from its own ragged engine's (in ``two_rows`` at the
    second request's fourth token). The port's gang engine is held to
    the reference's ragged engine."""
    jm, tm = models
    prompts = _cases(case)
    kw = dict(max_batch=2, num_blocks=32, block_size=16, temperature=0.0)
    jflags.set_flags({"kv_cache_dtype": "int8"})
    tflags.set_flags({"kv_cache_dtype": "int8"})
    try:
        want, _ = _run(JRagged, jm, prompts, 6, **kw)
        got, eng = _run(GangScheduledEngine, tm, prompts, 6, **kw)
    finally:
        jflags.set_flags({"kv_cache_dtype": "auto"})
        tflags.set_flags({"kv_cache_dtype": "auto"})
    assert eng.cache.quantized
    assert got == want


def test_ragged_with_chunked_prefill_equals_gang(models):
    """``tests/test_continuous_batching.py:175-192`` in the port: a prompt
    longer than the chunk prefills across steps beside the other row's
    decode; float32 tokens unchanged."""
    _, tm = models
    rng = np.random.RandomState(2)
    long_p = rng.randint(0, 128, 41).tolist()
    short_p = rng.randint(0, 128, 4).tolist()
    eng = ContinuousBatchingEngine(
        tm, max_batch=2, num_blocks=32, block_size=16, temperature=0.0,
        prefill_chunk=8, token_budget=10)
    a = eng.add_request(short_p, max_new_tokens=12)
    b = eng.add_request(long_p, max_new_tokens=6)
    results = eng.run()
    gang = GangScheduledEngine(tm, max_batch=2, num_blocks=32,
                               block_size=16, temperature=0.0)
    ga = gang.add_request(short_p, max_new_tokens=12)
    gb = gang.add_request(long_p, max_new_tokens=6)
    want = gang.run()
    assert results[a] == want[ga]
    assert results[b] == want[gb]


@pytest.mark.parametrize("cache_type", ["contiguous", "paged"])
def test_gang_equals_generate(models, cache_type):
    _, tm = models
    prompts = _prompts(7, (5, 9))
    got, _ = _run(GangScheduledEngine, tm, prompts, 5, max_batch=2,
                  num_blocks=32, block_size=16)
    for p, toks in zip(prompts, got):
        out = tm.generate(torch.tensor([p]), max_new_tokens=5,
                          temperature=0.0, cache_type=cache_type,
                          block_size=16)
        assert out[0, len(p):].tolist() == toks


def test_lifo_preemption_resumes_identically(models):
    """``tests/test_continuous_batching.py:130-144`` for the gang engine:
    a pool of 4 blocks (one the trash block) holds one request at a time;
    ``preempt_after=4`` evicts the LIFO row, which re-prefills its prompt
    and tokens when readmitted. Tokens and the preemption count equal the
    reference gang engine's, and the unconstrained run's tokens."""
    jm, tm = models
    prompts = [[3, 4, 5], [9, 8, 7]]
    kw = dict(max_batch=2, num_blocks=4, block_size=16, temperature=0.0,
              preempt_after=4)
    want, jeng = _run(JGang, jm, prompts, 24, **kw)
    got, eng = _run(GangScheduledEngine, tm, prompts, 24, **kw)
    assert eng.preempt_count >= 1
    assert eng.preempt_count == jeng.preempt_count
    assert eng.prefills == jeng.prefills > len(prompts)
    assert got == want
    free, _ = _run(GangScheduledEngine, tm, prompts, 24, max_batch=2,
                   num_blocks=32, block_size=16)
    assert got == free


def test_inactive_rows_write_only_the_trash_block(models):
    """One request in a two-row engine: each decode step writes the idle
    row's token into the reserved block and nowhere else."""
    _, tm = models
    eng = GangScheduledEngine(tm, max_batch=2, num_blocks=8, block_size=16)
    trash = eng._trash_slot // 16
    assert trash not in eng.cache._free
    eng.add_request(_prompts(3, [6])[0], max_new_tokens=4)
    eng.step()                        # admit + prefill + one decode step
    row = [int(b) for b in eng.cache.block_tables[0,
                                                  :eng.cache._allocated[0]]]
    assert trash not in row
    for pool in eng.cache.k + eng.cache.v:
        used = pool.abs().sum(dim=(1, 2, 3)) > 0
        assert {i for i in range(8) if used[i]} == set(row) | {trash}
        # the idle row wrote one token at the trash block's first offset
        assert bool(pool[trash, 0].abs().sum() > 0)
        assert float(pool[trash, 1:].abs().sum()) == 0.0
    eng.run()


def test_speculative_flag_counts_spec_gang_engine(models):
    _, tm = models
    fallback = registry().get("serving.spec.fallback")
    before = fallback.value
    tflags.set_flags({"speculative_k": 3})
    try:
        eng = GangScheduledEngine(tm, max_batch=1, num_blocks=8,
                                  block_size=16)
    finally:
        tflags.set_flags({"speculative_k": 0})
    assert fallback.value == before + 1
    last = flight_recorder.recorder().entries()[-1]
    assert last[3] == "serving.fallback[spec]"
    assert last[5] == "spec_gang_engine"
    # and the engine decodes one token a row all the same
    eng.add_request([1, 2, 3], max_new_tokens=3)
    assert len(eng.run()[0]) == 3


def test_perf_attribution_raises(models):
    _, tm = models
    tflags.set_flags({"perf_attribution": True})
    try:
        for cls in (GangScheduledEngine, ContinuousBatchingEngine):
            with pytest.raises(NotImplementedError, match="A9"):
                cls(tm, max_batch=1, num_blocks=8, block_size=16)
    finally:
        tflags.set_flags({"perf_attribution": False})


def test_slot_prefill_refuses_a_mask(models):
    """The engine's slot prefill attends through the ragged kernel over
    the slot's context and keeps no prompt K/V, so a mask raises."""
    from paddle_tpu_torch.models.serving import _SlotView
    _, tm = models
    eng = GangScheduledEngine(tm, max_batch=2, num_blocks=8, block_size=16)
    ids = torch.from_numpy(np.asarray(_prompts(4, [6]), np.int32))
    view = _SlotView(eng.cache, 1)
    assert tuple(tm(ids, cache=view, start_pos=0).shape) == (1, 6, 128)
    with pytest.raises(NotImplementedError, match="attn_mask"):
        tm(ids, attn_mask=torch.ones(1, 1, 6, 6, dtype=torch.bool),
           cache=_SlotView(eng.cache, 0), start_pos=0)
