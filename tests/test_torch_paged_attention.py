"""The port's plain gang-decode paged attention against the JAX package.

``paged_attention_plain`` (what a CPU tensor takes and what the CUDA
kernel is held to on the card) against the JAX Pallas kernel
(``pallas/paged_attention.py``, interpret mode on the CPU), including a
row with context_len 0 (zeros) and GQA; the int8 pool's route (the plain
dequant version, as the reference's composite) against the JAX op.
Tolerance float32 atol/rtol 2e-5 (float32 sums in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.kernels.pallas import paged_attention as jpa
from paddle_tpu.ops.kernels.pallas import quant_common as jqc
from paddle_tpu.ops.kernels.serving import paged_attention_kernel
from paddle_tpu_torch.ops.kernels import paged_attention as tpa
from paddle_tpu_torch.ops.kernels import serving as tsv

F32 = dict(atol=2e-5, rtol=2e-5)


def _decode_layout(rng, ctxs, bs=16, nb=40, mb=5, kv=2, h=4, d=32):
    B = len(ctxs)
    tbl = np.zeros((B, mb), np.int32)
    perm = rng.permutation(np.arange(1, nb))
    nxt = 0
    for b, c in enumerate(ctxs):
        n = -(-c // bs)
        tbl[b, :n] = perm[nxt:nxt + n]
        nxt += n
    q = rng.randn(B, 1, h, d).astype(np.float32)
    kp = rng.randn(nb, bs, kv, d).astype(np.float32)
    vp = rng.randn(nb, bs, kv, d).astype(np.float32)
    return q, kp, vp, tbl, np.asarray(ctxs, np.int32)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("ctxs,kv,h", [
    ([5, 17, 33, 1], 2, 4),
    ([0, 40, 16, 80], 2, 4),          # context_len 0 row returns zeros
    ([9, 64, 3], 1, 8),               # G = 8
])
def test_plain_matches_pallas(ctxs, kv, h):
    rng = np.random.RandomState(sum(ctxs))
    args = _decode_layout(rng, ctxs, kv=kv, h=h)
    want = np.asarray(jpa.paged_attention(*[jnp.asarray(a) for a in args]))
    got = tpa.paged_attention_plain(*[_t(a) for a in args])
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, **F32)
    for b, c in enumerate(ctxs):
        if c == 0:
            assert np.abs(got.numpy()[b]).max() == 0.0


def test_routing_cpu_takes_plain_and_counts_no_launch():
    rng = np.random.RandomState(3)
    args = [_t(a) for a in _decode_layout(rng, [7, 20])]
    before = tpa.launches.count
    a = tsv.paged_attention(*args)
    assert tpa.launches.count == before
    torch.testing.assert_close(a, tpa.paged_attention_plain(*args), rtol=0,
                               atol=0)


def test_int8_pool_routes_to_plain_dequant_like_reference():
    rng = np.random.RandomState(4)
    q, kp, vp, tbl, ctx = _decode_layout(rng, [5, 30, 12])
    ks = np.asarray(jqc.absmax_scale(jnp.asarray(kp), axis=-1))
    vs = np.asarray(jqc.absmax_scale(jnp.asarray(vp), axis=-1))
    kq = np.asarray(jqc.quantize_symmetric(jnp.asarray(kp), ks[..., None]))
    vq = np.asarray(jqc.quantize_symmetric(jnp.asarray(vp), vs[..., None]))
    want = np.asarray(paged_attention_kernel(
        *[jnp.asarray(a) for a in (q, kq, vq, tbl, ctx)],
        k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs)))
    got = tsv.paged_attention(*[_t(a) for a in (q, kq, vq, tbl, ctx)],
                              k_scale=_t(ks), v_scale=_t(vs))
    np.testing.assert_allclose(got.numpy(), want, **F32)
