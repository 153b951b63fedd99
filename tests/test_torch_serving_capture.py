"""The engine's static-buffer step (``ContinuousBatchingEngine`` under
``FLAGS_step_capture``; on the CPU each step after the first is the
capture's stand-in replay) against the reference engine, at a tiny size.

The JAX model's seeded weights move across with ``from_jax_state_dict``;
both engines serve the same prompts at temperature 0. Held to the
reference, token for token, through:

- prefill chunks and decode (a budget smaller than the prompts, so long
  prompts take several steps);
- speculative verify rows (``speculative_k=2`` over repeating prompts, so
  the n-gram drafts are proposed and verified);
- a preemption (a pool too small for every admitted request's worst
  case, ``preempt_after=1``: the head starves and the LIFO victim is
  recomputed);
- the int8 pool.

Held within the port: one capture per engine, every other step a replay,
no eager step; the eager step (``FLAGS_step_capture=0``) gives the same
tokens; and the padding regression: after every step, each token slot
past the step's packed tokens writes to the trash slot, also in steps
that follow a fuller one (every element of the static buffers is
rewritten each step).
"""

import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.models import LlamaConfig as JConfig
from paddle_tpu.models import LlamaForCausalLM as JModel
from paddle_tpu.models.serving import ContinuousBatchingEngine as JEngine
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch.observability import registry
from paddle_tpu_torch.models import (ContinuousBatchingEngine, LlamaConfig,
                                     LlamaForCausalLM, from_jax_state_dict)

CFG = dict(vocab_size=128, hidden_size=64, intermediate_size=160,
           num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
           max_position_embeddings=256)


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jm = JModel(JConfig(**CFG))
    jm.eval()
    tm = LlamaForCausalLM(LlamaConfig(**CFG), device="cpu")
    from_jax_state_dict(tm, {k: np.asarray(v._data)
                             for k, v in jm.state_dict().items()})
    return jm, tm


@pytest.fixture(autouse=True)
def _flags():
    tflags.set_flags({"step_capture": True})
    yield
    tflags.set_flags({"step_capture": True})


def _prompts(seed, lens, repeat=False):
    rng = np.random.RandomState(seed)
    out = []
    for n in lens:
        if repeat:    # a short motif over and over: n-gram drafts hit
            motif = rng.randint(0, 128, 4).tolist()
            out.append((motif * (n // 4 + 1))[:n])
        else:
            out.append(rng.randint(0, 128, n).tolist())
    return out


SCENARIOS = {
    "prefill_decode": dict(lens=(5, 40, 23, 70, 3), n_new=8,
                           kw=dict(max_batch=4, num_blocks=64,
                                   token_budget=24, prefill_chunk=16)),
    "speculative": dict(lens=(12, 20, 16), n_new=10, repeat=True,
                        kw=dict(max_batch=4, num_blocks=64,
                                speculative_k=2, token_budget=24,
                                prefill_chunk=16)),
    "preemption": dict(lens=(40, 40, 40), n_new=20,
                       kw=dict(max_batch=3, num_blocks=12,
                               preempt_after=1, token_budget=20,
                               prefill_chunk=16)),
    "int8_pool": dict(lens=(9, 30, 17), n_new=6,
                      kw=dict(max_batch=4, num_blocks=64, kv_dtype="int8")),
}


def _port(tm, prompts, n_new, kw, watch=None):
    eng = ContinuousBatchingEngine(tm, block_size=16, temperature=0.0, **kw)
    rids = [eng.add_request(p, max_new_tokens=n_new) for p in prompts]
    while eng.pending or eng.num_active:
        eng.step()
        if watch is not None:
            watch(eng)
    return [list(eng.results[r].out_tokens) for r in rids], eng


def _ref(jm, prompts, n_new, kw):
    eng = JEngine(jm, block_size=16, temperature=0.0, **kw)
    rids = [eng.add_request(p, max_new_tokens=n_new) for p in prompts]
    res = eng.run()
    return [[int(t) for t in res[r]] for r in rids]


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_captured_engine_matches_reference_engine(models, name):
    jm, tm = models
    sc = SCENARIOS[name]
    prompts = _prompts(1, sc["lens"], sc.get("repeat", False))
    want = _ref(jm, prompts, sc["n_new"], dict(sc["kw"]))
    verify_rows = registry().get("serving.spec.verify_rows")
    before = verify_rows.value
    got, eng = _port(tm, prompts, sc["n_new"], dict(sc["kw"]))
    assert got == want
    c = eng.capture_stats
    assert (c["captures"], c["replays"], c["eager_steps"]) == \
        (1, eng.steps - 1, 0)
    if name == "speculative":
        assert verify_rows.value > before
    if name == "preemption":
        assert eng.preempt_count > 0
    tflags.set_flags({"step_capture": False})
    eager, eng_e = _port(tm, prompts, sc["n_new"], dict(sc["kw"]))
    assert eager == got and eng_e.capture_stats["eager_steps"] == eng_e.steps


def test_padding_tokens_write_the_trash_slot_every_step(models):
    _, tm = models
    prompts = _prompts(2, (50, 6, 33, 4))
    packed = []

    def watch(eng):
        hb = eng._buf.np
        n = int(hb["cu"][-1])
        packed.append(n)
        assert (hb["slot"][n:] == eng._trash_slot).all(), \
            (eng.steps, n, hb["slot"][n:])
        assert (hb["ids"][0, n:] == 0).all() and (hb["pos"][0, n:] == 0).all()
        # the device buffers are the staging buffer's copy
        assert (eng._buf.t["slot"].numpy() == hb["slot"]).all()

    _port(tm, prompts, 5, dict(max_batch=4, num_blocks=64, token_budget=32,
                               prefill_chunk=16), watch=watch)
    # a fuller step came first and emptier ones followed
    assert max(packed) == 32 and packed[-1] < 32
    assert any(a > b for a, b in zip(packed, packed[1:]))
