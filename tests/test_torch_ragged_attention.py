"""The port's plain ragged paged attention against the JAX package.

The plain version (``paddle_tpu_torch.ops.kernels.ragged_paged_attention
.ragged_paged_attention_plain``) is what a CPU tensor takes and what the
CUDA kernel is held to on the card. Here it is held to the JAX Pallas
kernel (interpret mode on the CPU) and to the JAX composite
``_ragged_composite`` on the same seeded inputs, over decode-only,
prefill-only and mixed layouts, GQA, step padding, bf16 and int8 pools.

Tolerances: float32 atol/rtol 2e-5 (both accumulate in float32; the
order of the sums differs); bf16 outputs atol/rtol 1e-2 (both compute in
float32 from the same bf16 inputs and round once: one bf16 ulp).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.kernels.pallas import quant_common as jqc
from paddle_tpu.ops.kernels.pallas import ragged_paged_attention as jrpa
from paddle_tpu.ops.kernels.serving import _ragged_composite
from paddle_tpu_torch.ops.kernels import ragged_paged_attention as trpa
from paddle_tpu_torch.ops.kernels import serving as tsv

F32 = dict(atol=2e-5, rtol=2e-5)
BF16 = dict(atol=1e-2, rtol=1e-2)


def _layout(rng, qlens, ctxs, T, bs=16, nb=32, mb=6, kv=2, h=4, d=32):
    """Random pool + block tables realizing (qlens, ctxs); rows own
    disjoint blocks. numpy (q, k_pool, v_pool, tbl, ctx, cu)."""
    R = len(qlens)
    assert sum(qlens) <= T
    cu = np.concatenate([[0], np.cumsum(qlens)]).astype(np.int32)
    tbl = np.zeros((R, mb), np.int32)
    nxt = 1
    for r in range(R):
        for b in range(-(-ctxs[r] // bs)):
            tbl[r, b] = nxt
            nxt += 1
    assert nxt <= nb
    q = rng.randn(T, h, d).astype(np.float32)
    kp = rng.randn(nb, bs, kv, d).astype(np.float32)
    vp = rng.randn(nb, bs, kv, d).astype(np.float32)
    return q, kp, vp, tbl, np.asarray(ctxs, np.int32), cu


def _jax(fn, *arrays, **kw):
    out = fn(*[jnp.asarray(a) for a in arrays],
             **{k: jnp.asarray(v) for k, v in kw.items()})
    return np.asarray(out, np.float32)


def _torch(*arrays, **kw):
    out = trpa.ragged_paged_attention_plain(
        *[torch.from_numpy(np.array(a)) for a in arrays],
        **{k: torch.from_numpy(np.array(v)) for k, v in kw.items()})
    return out


LAYOUTS = {
    "mixed": ([1, 12, 10, 1], [20, 12, 37, 49], 32, {}),
    "mixed_offsets": ([8, 1, 1, 16], [8, 30, 1, 16], 32, {}),
    "decode_only": ([1, 1, 1, 1], [5, 17, 33, 1], 32, {}),
    "prefill_only": ([24, 8, 0, 0], [24, 8, 0, 0], 32, {}),
    "gqa_4": ([1, 9], [40, 9], 16, dict(kv=2, h=8)),
    "padding": ([1, 3, 0, 0], [9, 3, 0, 0], 24, {}),
}


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_plain_matches_pallas_and_composite(name):
    qlens, ctxs, T, kw = LAYOUTS[name]
    rng = np.random.RandomState(sorted(LAYOUTS).index(name))
    args = _layout(rng, qlens, ctxs, T, **kw)
    cu = args[-1]
    got = _torch(*args)
    assert got.dtype == torch.float32
    got = got.numpy()
    pallas = _jax(jrpa.ragged_paged_attention, *args)
    comp = _jax(_ragged_composite, *args)
    n = cu[-1]
    np.testing.assert_allclose(got[:n], pallas[:n], **F32)
    np.testing.assert_allclose(got[:n], comp[:n], **F32)
    # step padding: exact zeros, as the Pallas kernel returns
    assert np.abs(got[n:]).max(initial=0.0) == 0.0
    np.testing.assert_array_equal(got[n:], pallas[n:])


def test_bf16_keeps_dtype_and_matches_pallas():
    rng = np.random.RandomState(4)
    q, kp, vp, tbl, ctx, cu = _layout(rng, [1, 10], [33, 10], 16)
    jargs = [jnp.asarray(a, jnp.bfloat16) for a in (q, kp, vp)]
    want = np.asarray(jrpa.ragged_paged_attention(
        *jargs, jnp.asarray(tbl), jnp.asarray(ctx), jnp.asarray(cu)),
        np.float32)
    targs = [torch.from_numpy(a).bfloat16() for a in (q, kp, vp)]
    got = trpa.ragged_paged_attention_plain(
        *targs, torch.from_numpy(tbl), torch.from_numpy(ctx),
        torch.from_numpy(cu))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy()[:cu[-1]], want[:cu[-1]],
                               **BF16)


@pytest.mark.parametrize("name", ["mixed", "mixed_offsets"])
def test_int8_pool_matches_pallas_and_composite(name):
    qlens, ctxs, T, kw = LAYOUTS[name]
    rng = np.random.RandomState(7)
    q, kp, vp, tbl, ctx, cu = _layout(rng, qlens, ctxs, T, **kw)
    ks = np.asarray(jqc.absmax_scale(jnp.asarray(kp), axis=-1))
    vs = np.asarray(jqc.absmax_scale(jnp.asarray(vp), axis=-1))
    kq = np.asarray(jqc.quantize_symmetric(jnp.asarray(kp), ks[..., None]))
    vq = np.asarray(jqc.quantize_symmetric(jnp.asarray(vp), vs[..., None]))
    got = _torch(q, kq, vq, tbl, ctx, cu, k_scale=ks, v_scale=vs).numpy()
    pallas = _jax(jrpa.ragged_paged_attention, q, kq, vq, tbl, ctx, cu,
                  k_scale=ks, v_scale=vs)
    comp = _jax(_ragged_composite, q, kq, vq, tbl, ctx, cu, k_scale=ks,
                v_scale=vs)
    n = cu[-1]
    np.testing.assert_allclose(got[:n], pallas[:n], **F32)
    np.testing.assert_allclose(got[:n], comp[:n], **F32)
    assert np.abs(got[n:]).max(initial=0.0) == 0.0


def test_routing_cpu_takes_plain_and_counts_no_launch():
    rng = np.random.RandomState(9)
    args = [torch.from_numpy(a) for a in
            _layout(rng, [1, 12], [17, 12], 16)]
    before = trpa.launches.count
    a = tsv.ragged_paged_attention(*args)
    b = trpa.ragged_paged_attention_plain(*args)
    assert trpa.launches.count == before
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_wrapper_raises_on_a_device_without_kernel():
    q = torch.empty((4, 4, 32), device="meta")
    pool = torch.empty((8, 16, 2, 32), device="meta")
    tbl = torch.empty((1, 2), dtype=torch.int32, device="meta")
    lens = torch.empty((1,), dtype=torch.int32, device="meta")
    cu = torch.empty((2,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        trpa.ragged_paged_attention(q, pool, pool, tbl, lens, cu)


def test_bound_counts():
    # positions seen per token and pool bytes of the kernel's bound
    ctx = torch.tensor([5, 12, 0], dtype=torch.int32)
    cu = torch.tensor([0, 1, 4, 4], dtype=torch.int32)
    # row 0: one token seeing 5; row 1: 3 tokens at 9, 10, 11 seeing
    # 10 + 11 + 12; row 2 empty
    assert trpa.attention_flops(ctx, cu, 4, 8) == 4 * 4 * 8 * (5 + 33)
    assert trpa.kv_bytes_read(ctx, cu, 16, 2, 8, 2, False) == \
        2 * 2 * 8 * 2 * (5 + 12)
    assert trpa.kv_bytes_read(ctx, cu, 16, 2, 8, 1, True) == \
        2 * 2 * (8 + 4) * (5 + 12)
    assert trpa.num_tiles(512, 16, trpa.tile_tokens(32, 8)) == 16 + 32
