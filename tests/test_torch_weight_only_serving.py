"""Weight-only quantized serving in the port against the JAX package, on
the tiny Llama of ``test_torch_llama_serving.py``.

The JAX model's seeded weights move across with ``from_jax_state_dict``;
then both packages run ``quantize_for_inference`` on their own model, with
``weight_only_int4`` per channel and with ``weight_only_int8`` in groups
of 32. Held to the reference:

- every ``qweight`` and ``weight_scale`` bitwise equal; the LM head stays
  a ``Linear``; ``layers x 7`` ``WeightOnlyLinear``s, whose buffers are no
  parameters;
- the JAX quantized ``state_dict`` loads into a quantized port skeleton
  and gives the same logits as the port's own quantized model, bit for
  bit;
- prefill logits within 1e-4 (float32; both round every linear's input to
  bf16 and sum exact products in float32, in another order);
- greedy tokens of the port's engine equal the JAX engine's.

The JAX per-channel int4 route cannot run under ``jax.jit`` on this CPU
(its XLA refuses the bf16 x bf16 -> float32 dot), so the int4 JAX model
runs under ``jax.disable_jit()``; the int8 one runs jitted.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.models import LlamaConfig as JConfig
from paddle_tpu.models import LlamaForCausalLM as JModel
from paddle_tpu.models.serving import ContinuousBatchingEngine as JEngine
from paddle_tpu.nn import quant as jquant
from paddle_tpu_torch.models import (ContinuousBatchingEngine, LlamaConfig,
                                     LlamaForCausalLM, from_jax_state_dict)
from paddle_tpu_torch.models.generation import PagedKVCache
from paddle_tpu_torch.nn import Linear, quant as tquant

from _torch_ref_state import reference_executables_dropped  # noqa: F401

CFG = dict(vocab_size=128, hidden_size=64, intermediate_size=160,
           num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
           max_position_embeddings=128)
ALGOS = {"int4": ("weight_only_int4", -1), "int8_g32": ("weight_only_int8",
                                                        32)}
PROMPTS = [[5, 17, 99, 3, 64], [1, 2, 3, 4, 5, 6, 7, 8, 9], [120, 7, 7]]


def _jax_ctx(name):
    """int4 runs the JAX model eagerly; int8 jitted."""
    return jax.disable_jit() if name == "int4" else contextlib.nullcontext()


def _state(jm):
    return {k: np.asarray(v._data) for k, v in jm.state_dict().items()}


def _port_logits(tm, ids):
    cache = PagedKVCache(2, 1, num_blocks=1, block_size=16, num_kv_heads=2,
                         head_dim=16, max_blocks_per_seq=1, device="cpu")
    return tm(torch.from_numpy(ids), cache=cache, start_pos=0).numpy()


@pytest.fixture(scope="module", params=sorted(ALGOS))
def quantized(request):
    algo, gs = ALGOS[request.param]
    paddle.seed(0)
    jm = JModel(JConfig(**CFG))
    jm.eval()
    tm = LlamaForCausalLM(LlamaConfig(**CFG), device="cpu")
    from_jax_state_dict(tm, _state(jm))
    jquant.quantize_for_inference(jm, algo, group_size=gs)
    tquant.quantize_for_inference(tm, algo, group_size=gs)
    return request.param, jm, tm


def test_quantized_buffers_bitwise_and_layout(quantized):
    name, jm, tm = quantized
    algo, gs = ALGOS[name]
    jstate = _state(jm)
    tstate = tm.state_dict()
    assert set(tstate) == set(jstate)
    qnames = [k for k in tstate if k.endswith((".qweight", ".weight_scale"))]
    assert len(qnames) == 2 * 7 * CFG["num_hidden_layers"]
    for k in qnames:
        assert tstate[k].dtype == (torch.int8 if k.endswith("qweight")
                                   else torch.float32)
        np.testing.assert_array_equal(tstate[k].numpy(), jstate[k])
    layers = [m for m in tm.modules()
              if isinstance(m, tquant.WeightOnlyLinear)]
    assert len(layers) == 7 * CFG["num_hidden_layers"]
    assert all(m.weight_dtype == algo[-4:] and m.group_size == gs
               for m in layers)
    assert isinstance(tm.lm_head, Linear)
    assert not any(isinstance(m, Linear) for m in tm.llama.modules())
    # quantized weights are buffers: no grads, not among the parameters
    params = {n for n, _ in tm.named_parameters()}
    assert not any(k in params for k in qnames)


def test_jax_quantized_state_dict_loads_into_a_skeleton(quantized):
    name, jm, tm = quantized
    algo, gs = ALGOS[name]
    skeleton = LlamaForCausalLM(LlamaConfig(**CFG), device="cpu",
                                generator=torch.Generator().manual_seed(9))
    tquant.quantize_for_inference(skeleton, algo, group_size=gs)
    from_jax_state_dict(skeleton, _state(jm))
    ids = np.asarray([PROMPTS[1]], np.int32)
    np.testing.assert_array_equal(_port_logits(skeleton, ids),
                                  _port_logits(tm, ids))


def test_prefill_logits_match_reference(quantized):
    name, jm, tm = quantized
    ids = np.asarray([np.arange(12) * 7 % 128], np.int32)
    with _jax_ctx(name):
        want = np.asarray(jm(Tensor(jnp.asarray(ids)))._data)
    got = _port_logits(tm, ids)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_engine_greedy_matches_reference_engine(quantized):
    name, jm, tm = quantized
    with _jax_ctx(name):
        eng = JEngine(jm, max_batch=4, num_blocks=64, block_size=16,
                      temperature=0.0)
        rids = [eng.add_request(p, max_new_tokens=5) for p in PROMPTS]
        res = eng.run()
        want = [[int(t) for t in res[r]] for r in rids]
    teng = ContinuousBatchingEngine(tm, max_batch=4, num_blocks=64,
                                    block_size=16, temperature=0.0)
    rids = [teng.add_request(p, max_new_tokens=5) for p in PROMPTS]
    res = teng.run()
    assert [list(res[r]) for r in rids] == want
    # and the port's paged generate() agrees with its engine
    for p, toks in zip(PROMPTS, want):
        out = tm.generate(torch.tensor([p]), max_new_tokens=5,
                          temperature=0.0, cache_type="paged", block_size=16)
        assert out[0, len(p):].tolist() == toks
