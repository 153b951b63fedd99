"""The port's Llama serving path against the JAX package, at a tiny size.

The JAX model's own seeded weights move across with
``from_jax_state_dict``; both packages then see the same prompts (numpy,
seeded). Held to the reference:

- prefill logits, atol 1e-4 (float32; attention and matmuls sum in
  another order in the two packages);
- greedy tokens of the ragged engine, token for token, with the pool at
  the compute dtype and with the int8 pool (the JAX engine runs its
  Pallas ragged kernel in interpret mode).

Held within the port: ragged engine == paged ``generate()``, spec-on ==
spec-off, prefix cache on == off, and sampled (temperature > 0) output
independent of ``max_batch``/``token_budget``. Entry points raise
without a device when no GPU is present.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.models import LlamaConfig as JConfig
from paddle_tpu.models import LlamaForCausalLM as JModel
from paddle_tpu.models.serving import ContinuousBatchingEngine as JEngine
from paddle_tpu_torch.models import (ContinuousBatchingEngine, LlamaConfig,
                                     LlamaForCausalLM, from_jax_state_dict)
from paddle_tpu_torch.models.generation import PagedKVCache
from paddle_tpu_torch.observability import registry

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
    state = {k: np.asarray(v._data) for k, v in jm.state_dict().items()}
    from_jax_state_dict(tm, state)
    return jm, tm


def _prompts(seed, lens):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 128, n).tolist() for n in lens]


def _port_run(tm, prompts, n_new, **kw):
    kw.setdefault("num_blocks", 64)
    kw.setdefault("block_size", 16)
    eng = ContinuousBatchingEngine(tm, max_batch=kw.pop("max_batch", 4),
                                   **kw)
    rids = [eng.add_request(p, max_new_tokens=n_new) for p in prompts]
    res = eng.run()
    return [list(res[r]) for r in rids], eng


def _jax_run(jm, prompts, n_new, **kw):
    eng = JEngine(jm, max_batch=4, num_blocks=64, block_size=16,
                  temperature=0.0, **kw)
    rids = [eng.add_request(p, max_new_tokens=n_new) for p in prompts]
    res = eng.run()
    return [[int(t) for t in res[r]] for r in rids]


def test_weights_and_rotary_tables_carry_over(models):
    jm, tm = models
    fresh = LlamaForCausalLM(LlamaConfig(**CFG), device="cpu")
    jstate = jm.state_dict()
    for name, t in tm.state_dict().items():
        np.testing.assert_array_equal(t.numpy(), np.asarray(jstate[name]._data))
    # the port's own rotary tables agree with the reference's (float32
    # cos/sin of arguments up to 127: a few ulps)
    for name in ("llama.layers.0.self_attn.rotary.cos_cached",
                 "llama.layers.1.self_attn.rotary.sin_cached"):
        np.testing.assert_allclose(fresh.state_dict()[name].numpy(),
                                   np.asarray(jstate[name]._data),
                                   atol=1e-5, rtol=0)
    with pytest.raises(ValueError, match="shape mismatch"):
        bad = {k: np.asarray(v._data) for k, v in jstate.items()}
        bad["lm_head.weight"] = bad["lm_head.weight"][:, :3]
        from_jax_state_dict(fresh, bad)


def test_prefill_logits_match_reference(models):
    jm, tm = models
    ids = np.asarray(_prompts(1, [12])[0], np.int32)[None]
    want = np.asarray(jm(Tensor(jnp.asarray(ids)))._data)
    cache = PagedKVCache(2, 1, num_blocks=1, block_size=16, num_kv_heads=2,
                         head_dim=16, max_blocks_per_seq=1, device="cpu")
    got = tm(torch.from_numpy(ids), cache=cache, start_pos=0).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("kv_dtype", ["auto", "int8"])
def test_engine_greedy_matches_reference_engine(models, kv_dtype):
    jm, tm = models
    prompts = _prompts(0, (5, 9, 7, 20, 3))
    want = _jax_run(jm, prompts, 6, kv_dtype=kv_dtype)
    got, eng = _port_run(tm, prompts, 6, temperature=0.0, kv_dtype=kv_dtype)
    assert eng.cache.quantized == (kv_dtype == "int8")
    assert got == want


def test_engine_matches_paged_generate(models):
    _, tm = models
    prompts = _prompts(2, (5, 9, 18))
    got, _ = _port_run(tm, prompts, 7, temperature=0.0)
    for p, toks in zip(prompts, got):
        out = tm.generate(torch.tensor([p]), max_new_tokens=7,
                          temperature=0.0, cache_type="paged", block_size=16)
        assert out.dtype == torch.int32
        assert out[0, len(p):].tolist() == toks


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_speculative_equals_plain_decode(models, temperature):
    _, tm = models
    # repetitive prompts give the n-gram proposer drafts to verify
    prompts = [[3, 4, 5, 6] * 4, [9, 8, 7] * 5 + [1], _prompts(3, [11])[0]]
    base, _ = _port_run(tm, prompts, 12, temperature=temperature, seed=5)
    proposed = registry().get("serving.spec.proposed")
    before = proposed.value
    spec, eng = _port_run(tm, prompts, 12, temperature=temperature, seed=5,
                          speculative_k=3, token_budget=24)
    assert proposed.value > before
    assert spec == base


def test_prefix_cache_changes_only_the_work(models):
    _, tm = models
    head = _prompts(4, [40])[0]
    prompts = [head + [1, 2, 3], head + [7, 7]]

    def run(enable):
        eng = ContinuousBatchingEngine(tm, max_batch=2, num_blocks=32,
                                       block_size=16, temperature=0.0,
                                       enable_prefix_cache=enable)
        hit = registry().get("serving.prefix_cache.hit_blocks")
        before = hit.value
        a = eng.add_request(prompts[0], max_new_tokens=5)
        eng.run()
        b = eng.add_request(prompts[1], max_new_tokens=5)
        res = eng.run()
        return [res[a], res[b]], hit.value - before

    on, hits = run(True)
    off, no_hits = run(False)
    assert hits == 2 and no_hits == 0
    assert on == off


def test_sampling_is_schedule_independent(models):
    _, tm = models
    prompts = _prompts(5, (6, 13, 4, 9))
    a, _ = _port_run(tm, prompts, 8, temperature=0.9, top_k=20, seed=7)
    b, _ = _port_run(tm, prompts, 8, temperature=0.9, top_k=20, seed=7,
                     max_batch=2, token_budget=6, prefill_chunk=4)
    assert a == b
    c, _ = _port_run(tm, prompts, 8, temperature=0.9, top_k=20, seed=8)
    assert c != a


def test_engine_behaviour_edges(models):
    _, tm = models
    eng = ContinuousBatchingEngine(tm, max_batch=2, num_blocks=4,
                                   block_size=16, temperature=0.0,
                                   max_queue=1)
    with pytest.raises(ValueError, match="could never be admitted"):
        eng.add_request(list(range(100)), max_new_tokens=30)
    with pytest.raises(ValueError, match="empty prompt"):
        eng.add_request([], max_new_tokens=4)
    rid = eng.add_request([1, 2, 3], max_new_tokens=3)
    from paddle_tpu_torch.models import QueueFull
    with pytest.raises(QueueFull):
        eng.add_request([4, 5], max_new_tokens=3)
    eng.admission_paused = True
    assert eng.step() == [] and len(eng.pending) == 1
    eng.admission_paused = False
    eng.run()
    assert eng.pop_result(rid).done and eng.pop_result(rid) is None
    assert len(eng.cache._free) == 3     # every block back, trash kept


def test_preempted_request_resumes_identically(models):
    _, tm = models
    want, _ = _port_run(tm, [[3, 4, 5], [9, 8, 7]], 24, temperature=0.0)
    eng = ContinuousBatchingEngine(tm, max_batch=2, num_blocks=4,
                                   block_size=16, temperature=0.0,
                                   preempt_after=4)
    a = eng.add_request([3, 4, 5], max_new_tokens=24)
    b = eng.add_request([9, 8, 7], max_new_tokens=24)
    res = eng.run()
    assert [res[a], res[b]] == want


def test_entry_points_need_a_device_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device exists")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LlamaForCausalLM(LlamaConfig(**CFG))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PagedKVCache(2, 1, num_blocks=1, block_size=16, num_kv_heads=2,
                     head_dim=16, max_blocks_per_seq=1)


def test_no_cache_forward_waits_for_flash_attention(models, monkeypatch):
    # the no-cache forward no longer waits: it attends through the flash
    # path (one call per layer) and its logits equal a cache prefill's
    from paddle_tpu_torch.ops.kernels import nn as tnn
    _, tm = models
    calls = []
    real = tnn._fa.flash_attention
    monkeypatch.setattr(tnn._fa, "flash_attention",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    ids = torch.from_numpy(np.asarray(_prompts(3, [12]), np.int32))
    with torch.no_grad():
        got = tm(ids)
    assert len(calls) == CFG["num_hidden_layers"]
    cache = PagedKVCache(CFG["num_hidden_layers"], 1, num_blocks=4,
                         block_size=16, num_kv_heads=2, head_dim=16,
                         max_blocks_per_seq=4, dtype="float32",
                         device="cpu")
    want = tm(ids, cache=cache, start_pos=0)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=0)
