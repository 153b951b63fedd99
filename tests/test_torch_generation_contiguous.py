"""The contiguous ``KVCache``, ``generate(cache_type="contiguous")`` and
fault C9 (a cached forward dropped ``attn_mask``), against the JAX
package at a tiny size.

The JAX model's seeded weights move across with ``from_jax_state_dict``;
both packages see the same ids and masks (numpy, seeded). Held to the
reference:

- ``generate()`` greedy tokens over the contiguous cache (the default
  in both packages), token for token, and equal to the paged cache's;
- a masked prefill through ``KVCache`` and through ``PagedKVCache``: the
  logits at atol 1e-4 (float32; attention and matmuls sum in another
  order in the two packages), over a left-padding mask (additive, -1e9 at
  the pads, so no query row is masked whole) and a bool one;
- a masked paged decode raises ``NotImplementedError`` in both;
- an int8 ``FLAGS_kv_cache_dtype`` records ``kv_int8_dense_cache``
  (``serving.kv.fallback``) and keeps the contiguous cache at the
  compute dtype.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import flags as jflags
from paddle_tpu.core.tensor import Tensor as JTensor
from paddle_tpu.models import LlamaConfig as JConfig
from paddle_tpu.models import LlamaForCausalLM as JModel
from paddle_tpu.models.generation import KVCache as JKVCache
from paddle_tpu.models.generation import PagedKVCache as JPaged
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch.models import (KVCache, LlamaConfig, LlamaForCausalLM,
                                     PagedKVCache, from_jax_state_dict)
from paddle_tpu_torch.observability import flight_recorder, registry

from _torch_ref_state import reference_executables_dropped  # noqa: F401

CFG = dict(vocab_size=128, hidden_size=64, intermediate_size=160,
           num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
           max_position_embeddings=128)
KV, D, LAYERS = 2, 16, 2


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jm = JModel(JConfig(**CFG))
    jm.eval()
    tm = LlamaForCausalLM(LlamaConfig(**CFG), device="cpu")
    from_jax_state_dict(tm, {k: np.asarray(v._data)
                             for k, v in jm.state_dict().items()})
    return jm, tm


def _ids(seed, b, s):
    return np.random.RandomState(seed).randint(0, 128, (b, s)).astype(
        np.int32)


def _pad_mask(b, s, t, pads, kind):
    """Left padding: row r's first ``pads[r]`` keys are pads. ``kind``
    "float" is additive (0 keep, -1e9 pad), "bool" keeps with True, its
    pad query rows keeping their own key so none is masked whole."""
    keep = np.ones((b, 1, s, t), bool)
    for r, p in enumerate(pads):
        keep[r, :, :, :p] = False
        if kind == "bool":
            for i in range(min(p, s)):
                keep[r, :, i, i] = True
    if kind == "float":
        return np.where(keep, 0.0, -1e9).astype(np.float32)
    return keep


@pytest.mark.parametrize("shape", [(1, 5), (2, 9)])
def test_generate_contiguous_matches_reference(models, shape):
    jm, tm = models
    ids = _ids(1, *shape)
    want = np.asarray(jm.generate(JTensor(jnp.asarray(ids)),
                                  max_new_tokens=6, temperature=0.0)._data)
    got = tm.generate(torch.from_numpy(ids), max_new_tokens=6,
                      temperature=0.0)
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    paged = tm.generate(torch.from_numpy(ids), max_new_tokens=6,
                        temperature=0.0, cache_type="paged", block_size=16)
    np.testing.assert_array_equal(paged.numpy(), want)


def _masked_prefill(model, cache, ids, mask, jax_side):
    if jax_side:
        return np.asarray(model(
            JTensor(jnp.asarray(ids)), attn_mask=JTensor(jnp.asarray(mask)),
            cache=cache, start_pos=JTensor(jnp.asarray(0, jnp.int32)))._data)
    return model(torch.from_numpy(ids), attn_mask=torch.from_numpy(mask),
                 cache=cache, start_pos=0).numpy()


@pytest.mark.parametrize("kind", ["float", "bool"])
def test_masked_prefill_through_kvcache_matches_reference(models, kind):
    """C9: the mask reaches ``cache_attention`` (over the whole cache of
    ``max_len`` 16, past the 9 prompt positions)."""
    jm, tm = models
    ids = _ids(2, 2, 9)
    mask = _pad_mask(2, 9, 16, (3, 0), kind)
    want = _masked_prefill(jm, JKVCache(LAYERS, 2, 16, KV, D), ids, mask,
                           True)
    got = _masked_prefill(tm, KVCache(LAYERS, 2, 16, KV, D, device="cpu"),
                          ids, mask, False)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    # the mask matters: the padded row's logits move without it
    plain = tm(torch.from_numpy(ids), cache=KVCache(
        LAYERS, 2, 16, KV, D, device="cpu"), start_pos=0).numpy()
    assert np.abs(plain[0] - got[0]).max() > 1e-2
    np.testing.assert_allclose(plain[1], got[1], atol=1e-5, rtol=0)


@pytest.mark.parametrize("kind", ["float", "bool"])
def test_masked_prefill_through_paged_cache_matches_reference(models, kind):
    """C9: a masked paged prefill attends the stashed prompt K/V with the
    mask and the causal mask (the composite), as the reference's does."""
    jm, tm = models
    ids = _ids(3, 2, 9)
    mask = _pad_mask(2, 9, 9, (4, 1), kind)
    kw = dict(num_blocks=2, block_size=16, num_kv_heads=KV, head_dim=D,
              max_blocks_per_seq=1)
    want = _masked_prefill(jm, JPaged(LAYERS, 2, **kw), ids, mask, True)
    cache = PagedKVCache(LAYERS, 2, device="cpu", **kw)
    got = _masked_prefill(tm, cache, ids, mask, False)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    plain = tm(torch.from_numpy(ids), cache=PagedKVCache(
        LAYERS, 2, device="cpu", **kw), start_pos=0).numpy()
    assert np.abs(plain - got).max() > 1e-2
    # the pool holds the prompt's K/V whatever the mask
    assert all(bool(torch.isfinite(t).all()) and float(t.abs().sum()) > 0
               for t in cache.k + cache.v)


def test_masked_paged_decode_raises_in_both(models):
    jm, tm = models
    ids = _ids(4, 1, 5)
    kw = dict(num_blocks=1, block_size=16, num_kv_heads=KV, head_dim=D,
              max_blocks_per_seq=1)
    jc = JPaged(LAYERS, 1, **kw)
    tc = PagedKVCache(LAYERS, 1, device="cpu", **kw)
    jm(JTensor(jnp.asarray(ids)), cache=jc,
       start_pos=JTensor(jnp.asarray(0, jnp.int32)))
    tm(torch.from_numpy(ids), cache=tc, start_pos=0)
    nxt = np.asarray([[7]], np.int32)
    mask = np.ones((1, 1, 1, 16), bool)
    with pytest.raises(NotImplementedError, match="attn_mask"):
        jm(JTensor(jnp.asarray(nxt)), attn_mask=JTensor(jnp.asarray(mask)),
           cache=jc, start_pos=JTensor(jnp.asarray(5, jnp.int32)))
    with pytest.raises(NotImplementedError, match="attn_mask"):
        tm(torch.from_numpy(nxt), attn_mask=torch.from_numpy(mask),
           cache=tc, start_pos=5)


def test_unmasked_paged_prefill_keeps_the_ragged_kernel(models, monkeypatch):
    """Without a mask the paged prefill stays on the ragged route."""
    _, tm = models
    from paddle_tpu_torch.ops.kernels import serving as S
    calls = []
    real = S.ragged_paged_attention

    def spy(*a, **k):
        calls.append(a[0].shape)
        return real(*a, **k)
    monkeypatch.setattr(S, "ragged_paged_attention", spy)
    kw = dict(num_blocks=1, block_size=16, num_kv_heads=KV, head_dim=D,
              max_blocks_per_seq=1)
    tm(torch.from_numpy(_ids(5, 1, 7)), cache=PagedKVCache(
        LAYERS, 1, device="cpu", **kw), start_pos=0)
    assert len(calls) == LAYERS
    mask = _pad_mask(1, 7, 7, (2,), "float")
    tm(torch.from_numpy(_ids(5, 1, 7)), attn_mask=torch.from_numpy(mask),
       cache=PagedKVCache(LAYERS, 1, device="cpu", **kw), start_pos=0)
    assert len(calls) == LAYERS


@pytest.mark.parametrize("masked", [False, True])
def test_paged_prefill_keeps_no_prompt_kv(models, masked):
    """The prompt K/V that a masked prefill attends is held for one layer
    at a time: after the forward, masked or not, the cache keeps none of
    it beside the pool."""
    _, tm = models
    kw = dict(num_blocks=1, block_size=16, num_kv_heads=KV, head_dim=D,
              max_blocks_per_seq=1)
    cache = PagedKVCache(LAYERS, 1, device="cpu", **kw)
    seen = []
    attend = cache.attend

    def spy(layer, q, pos=None, attn_mask=None):
        seen.append(cache._last_kv[0])
        return attend(layer, q, pos, attn_mask)
    cache.attend = spy
    mask = (torch.from_numpy(_pad_mask(1, 7, 7, (2,), "float"))
            if masked else None)
    tm(torch.from_numpy(_ids(5, 1, 7)), attn_mask=mask, cache=cache,
       start_pos=0)
    assert seen == list(range(LAYERS)) and cache._last_kv is None


def test_int8_contiguous_records_the_dense_cache_fallback(models):
    jm, tm = models
    ids = _ids(6, 1, 4)
    fallback = registry().get("serving.kv.fallback")
    before, seq0 = fallback.value, flight_recorder.recorder().total_recorded
    jflags.set_flags({"kv_cache_dtype": "int8"})
    tflags.set_flags({"kv_cache_dtype": "int8"})
    try:
        want = np.asarray(jm.generate(JTensor(jnp.asarray(ids)),
                                      max_new_tokens=3,
                                      temperature=0.0)._data)
        got = tm.generate(torch.from_numpy(ids), max_new_tokens=3,
                          temperature=0.0)
    finally:
        jflags.set_flags({"kv_cache_dtype": "auto"})
        tflags.set_flags({"kv_cache_dtype": "auto"})
    assert fallback.value == before + 1
    recorded = [e for e in flight_recorder.recorder().entries()
                if e[0] >= seq0 and e[3].startswith("serving.fallback")]
    assert [(e[3], e[5]) for e in recorded] == [
        ("serving.fallback[kv]", "kv_int8_dense_cache")]
    # the cache stayed at the compute dtype: the reference's tokens
    np.testing.assert_array_equal(got.numpy(), want)


def test_kvcache_layout_and_bytes():
    c = KVCache(3, 2, 10, KV, D, dtype="bfloat16", device="cpu")
    assert len(c.k) == len(c.v) == 3
    assert tuple(c.k[0].shape) == (2, 10, KV, D)
    assert c.k[0].dtype == torch.bfloat16
    assert c.nbytes() == 2 * 3 * 2 * 10 * KV * D * 2
