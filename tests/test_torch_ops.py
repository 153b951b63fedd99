"""The PyTorch port's plain serving ops against the JAX package's kernels.

Same inputs (numpy, seeded) through ``paddle_tpu.ops.kernels`` and
``paddle_tpu_torch.ops.kernels``; float32 results agree within atol 1e-6
(one or two float32 ulps at these magnitudes: both sides round the same
operations in the same order). int8 codes match exactly except at exact
.5 ties of x/scale, where the two divisions may land on either side; those
are counted and bounded.

Quantization scales are held to the reference's ops as they run, jitted:
XLA turns ``absmax / bound`` into ``absmax * float32(1/bound)``, which
differs from the eager JAX function by an ulp on about 4% of scales. The
int8 KV write is held bit for bit (codes and scales) against
``jax.jit(paged_cache_write_q_kernel)`` over 4096 tokens.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.kernels import nn as jnn
from paddle_tpu.ops.kernels import serving as jsv
from paddle_tpu.ops.kernels.pallas import quant_common as jqc
from paddle_tpu_torch.ops.kernels import nn as tnn
from paddle_tpu_torch.ops.kernels import quant_common as tqc
from paddle_tpu_torch.ops.kernels import serving as tsv

ATOL = 1e-6


def _np(x):
    return np.asarray(x, np.float32)


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


class TestNN:
    def test_rms_norm_f32(self):
        rng = np.random.RandomState(0)
        x = rng.randn(2, 5, 64).astype(np.float32)
        w = rng.randn(64).astype(np.float32)
        want = _np(jnn.rms_norm(jnp.asarray(x), jnp.asarray(w), epsilon=1e-6))
        got = tnn.rms_norm(_t(x), _t(w), epsilon=1e-6).numpy()
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)

    def test_rms_norm_bf16_casts_like_reference(self):
        # mean in f32, cast to bf16, then the bf16 weight multiply: the
        # same roundings on both sides, so results agree to one bf16 ulp
        rng = np.random.RandomState(1)
        x = rng.randn(3, 64).astype(np.float32)
        w = rng.randn(64).astype(np.float32)
        want = jnn.rms_norm(jnp.asarray(x, jnp.bfloat16),
                            jnp.asarray(w, jnp.bfloat16))
        got = tnn.rms_norm(_t(x).bfloat16(), _t(w).bfloat16())
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(), _np(want),
                                   atol=0, rtol=2 ** -7)

    def test_rope_f32(self):
        rng = np.random.RandomState(2)
        q = rng.randn(2, 7, 4, 16).astype(np.float32)
        k = rng.randn(2, 7, 2, 16).astype(np.float32)
        inv = 1.0 / (10000.0 ** (np.arange(0, 16, 2, dtype=np.float32) / 16))
        emb = np.concatenate([np.outer(np.arange(128), inv)] * 2, -1)
        cos, sin = np.cos(emb).astype(np.float32), np.sin(emb).astype(
            np.float32)
        pos = rng.randint(0, 128, (2, 7)).astype(np.int32)
        jq, jk = jnn.rope(jnp.asarray(q), jnp.asarray(k), cos=jnp.asarray(cos),
                          sin=jnp.asarray(sin), position_ids=jnp.asarray(pos))
        tq, tk = tnn.rope(_t(q), _t(k), _t(cos), _t(sin), _t(pos))
        np.testing.assert_allclose(tq.numpy(), _np(jq), atol=ATOL, rtol=0)
        np.testing.assert_allclose(tk.numpy(), _np(jk), atol=ATOL, rtol=0)

    def test_swiglu_and_linear_and_embedding(self):
        rng = np.random.RandomState(3)
        x = rng.randn(4, 6, 32).astype(np.float32)
        y = rng.randn(4, 6, 32).astype(np.float32)
        np.testing.assert_allclose(
            tnn.swiglu(_t(x), _t(y)).numpy(),
            _np(jnn.swiglu(jnp.asarray(x), jnp.asarray(y))), atol=ATOL,
            rtol=0)
        w = rng.randn(32, 8).astype(np.float32)
        # x @ W over 32 terms: float32 sums in another order
        np.testing.assert_allclose(
            tnn.linear(_t(x), _t(w)).numpy(),
            _np(jnn.linear(jnp.asarray(x), jnp.asarray(w))), atol=1e-5,
            rtol=1e-5)
        table = rng.randn(50, 8).astype(np.float32)
        ids = rng.randint(0, 50, (3, 5)).astype(np.int32)
        np.testing.assert_array_equal(
            tnn.embedding(_t(ids), _t(table)).numpy(),
            _np(jnn.embedding(jnp.asarray(ids), jnp.asarray(table))))


def _tie_count(x, scales):
    r = np.asarray(x, np.float64) / np.maximum(np.asarray(scales, np.float64),
                                               tqc.EPS)
    return int(np.sum(np.abs(np.abs(r - np.trunc(r)) - 0.5) < 1e-4))


class TestQuant:
    def test_absmax_quantize_dequantize(self):
        rng = np.random.RandomState(4)
        x = (rng.randn(16, 4, 32) * 3).astype(np.float32)
        x[3, 1] = 0.0                                   # all-zero group
        js = _np(jax.jit(jqc.absmax_scale, static_argnums=1)(
            jnp.asarray(x), -1))
        ts = tqc.absmax_scale(_t(x), axis=-1).numpy()
        np.testing.assert_array_equal(ts, js)
        jq = np.asarray(jqc.quantize_symmetric(jnp.asarray(x), js[..., None]))
        tq = tqc.quantize_symmetric(_t(x), _t(ts)[..., None]).numpy()
        assert tq.dtype == np.int8
        mismatch = int(np.sum(jq != tq))
        assert mismatch <= _tie_count(x, js[..., None])
        assert np.abs(jq.astype(int) - tq.astype(int)).max() <= 1
        assert (tq[3, 1] == 0).all()
        np.testing.assert_allclose(
            tqc.dequantize_symmetric(_t(jq), _t(js)[..., None]).numpy(),
            _np(jqc.dequantize_symmetric(jnp.asarray(jq), js[..., None])),
            atol=ATOL, rtol=0)


class TestCacheWrite:
    def test_paged_cache_write(self):
        rng = np.random.RandomState(5)
        pool = rng.randn(8, 4, 2, 16).astype(np.float32)
        new = rng.randn(2, 3, 2, 16).astype(np.float32)
        slots = rng.permutation(32)[:6].astype(np.int32)
        want = _np(jsv.paged_cache_write_kernel(
            jnp.asarray(pool), jnp.asarray(new), jnp.asarray(slots)))
        tpool = _t(pool.copy())
        got = tsv.paged_cache_write(tpool, _t(new), _t(slots))
        assert got is tpool                      # written in place
        np.testing.assert_array_equal(got.numpy(), want)

    def test_paged_cache_write_q(self):
        rng = np.random.RandomState(6)
        pool = np.zeros((8, 4, 2, 16), np.int8)
        spool = np.zeros((8, 4, 2), np.float32)
        new = (rng.randn(2, 5, 2, 16) * 2).astype(np.float32)
        slots = rng.permutation(32)[:10].astype(np.int32)
        jp, js = jsv.paged_cache_write_q_kernel(
            jnp.asarray(pool), jnp.asarray(spool), jnp.asarray(new),
            jnp.asarray(slots))
        tp, ts = tsv.paged_cache_write_q(_t(pool.copy()), _t(spool.copy()),
                                         _t(new), _t(slots))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        jp, tp = np.asarray(jp), tp.numpy()
        flat_s = np.asarray(js).reshape(-1, 2)[slots]
        ties = _tie_count(new.reshape(-1, 2, 16), flat_s[..., None])
        assert int(np.sum(jp != tp)) <= ties
        assert np.abs(jp.astype(int) - tp.astype(int)).max() <= 1

    def test_paged_cache_write_q_bitwise_against_jitted_reference(self):
        # the reference engine writes the int8 pool through its jitted op:
        # over 4096 tokens x 8 kv heads the scales and the codes are equal
        # bit for bit (a division by 127 gives 1514 other scales of the 32768)
        rng = np.random.RandomState(10)
        B, S, KV, D = 2, 2048, 8, 128
        nb, bs = 80, 64
        pool = np.zeros((nb, bs, KV, D), np.int8)
        spool = np.zeros((nb, bs, KV), np.float32)
        new = rng.randn(B, S, KV, D).astype(np.float32)
        slots = rng.permutation(nb * bs)[:B * S].astype(np.int32)
        jp, js = jax.jit(jsv.paged_cache_write_q_kernel)(
            jnp.asarray(pool), jnp.asarray(spool), jnp.asarray(new),
            jnp.asarray(slots))
        tp, ts = tsv.paged_cache_write_q(_t(pool), _t(spool), _t(new),
                                         _t(slots))
        np.testing.assert_array_equal(ts.numpy().view(np.int32),
                                      np.asarray(js).view(np.int32))
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))


class TestSampling:
    def test_greedy_keyed_and_plain(self):
        rng = np.random.RandomState(7)
        logits = rng.randn(6, 50).astype(np.float32)
        keys = rng.randint(0, 2 ** 31, (6, 2)).astype(np.uint32)
        pos = np.arange(6, dtype=np.int32)
        want = np.asarray(jsv.sample_logits_keyed_kernel(
            jnp.asarray(logits), jnp.asarray(keys), jnp.asarray(pos),
            temperature=0.0))
        got = tsv.sample_logits_keyed(_t(logits), _t(keys.astype(np.int64)),
                                      _t(pos), temperature=0.0)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(
            tsv.sample_logits(_t(logits), temperature=0.0).numpy(), want)

    def test_keyed_draw_is_independent_of_row_position(self):
        # a row's draw is a pure function of (key, token index, logits):
        # permuting the rows permutes the draws
        rng = np.random.RandomState(8)
        logits = _t(rng.randn(8, 40).astype(np.float32))
        keys = torch.tensor([tsv.request_key(3, rid) for rid in range(8)])
        pos = _t(rng.randint(0, 100, 8).astype(np.int64))
        a = tsv.sample_logits_keyed(logits, keys, pos, temperature=0.9,
                                    top_k=10)
        perm = torch.from_numpy(rng.permutation(8))
        b = tsv.sample_logits_keyed(logits[perm], keys[perm], pos[perm],
                                    temperature=0.9, top_k=10)
        np.testing.assert_array_equal(a[perm].numpy(), b.numpy())

    @pytest.mark.parametrize("top_k,top_p", [(0, 1.0), (3, 1.0), (0, 0.7)])
    def test_keyed_draws_follow_the_filtered_softmax(self, top_k, top_p):
        # 4000 draws of one row over token indices: the empirical
        # frequencies sit within 0.03 of the filtered softmax (binomial
        # std <= 0.008 at n=4000)
        logits = torch.tensor([[2.0, 1.0, 0.5, 0.0, -1.0]])
        n = 4000
        key = torch.tensor([tsv.request_key(11, 5)]).repeat(n, 1)
        draws = tsv.sample_logits_keyed(
            logits.repeat(n, 1), key, torch.arange(n), temperature=1.0,
            top_k=top_k, top_p=top_p)
        want = torch.softmax(tsv._filter_logits(logits, 1.0, top_k, top_p),
                             -1)[0].numpy()
        freq = np.bincount(draws.numpy(), minlength=5) / n
        np.testing.assert_allclose(freq, want, atol=0.03)

    def test_filter_logits_matches_reference(self):
        rng = np.random.RandomState(9)
        logits = rng.randn(4, 30).astype(np.float32)
        for tk, tp in ((5, 1.0), (0, 0.8), (7, 0.6)):
            want = _np(jsv._filter_logits(jnp.asarray(logits), 0.7, tk, tp))
            got = tsv._filter_logits(_t(logits), 0.7, tk, tp).numpy()
            np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
            fin = np.isfinite(want)
            np.testing.assert_allclose(got[fin], want[fin], atol=ATOL,
                                       rtol=0)
