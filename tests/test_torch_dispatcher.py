"""The port's op registry (``paddle_tpu_torch.ops.dispatcher``) against the
JAX package's (``paddle_tpu.ops.dispatcher``): every op of the port's
table has the reference schema's argument names and defaults, its kernel
takes them by name, ``call_op`` and the top-level exports give the
reference op's results on the same inputs (float32, atol 2e-5 for
attention, 1e-5 for the products and the CE), a stray ``name=`` keyword is
dropped and an unknown op raises ``KeyError``."""

import inspect

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch
from paddle_tpu.ops import dispatcher as rdisp
from paddle_tpu_torch.ops import dispatcher as tdisp

OPS = sorted(tdisp.SCHEMA)


def _ref_schema(name):
    return [(p.name, p.default if (p.has_default or p.optional)
             else tdisp.REQUIRED) for p in rdisp.OPS[name].params]


@pytest.mark.parametrize("name", OPS)
def test_schema_equals_reference(name):
    assert list(tdisp.SCHEMA[name]) == _ref_schema(name)
    if name in tdisp.INPLACE:       # the reference's takes (x, *args)
        return
    ref_sig = inspect.signature(rdisp.get_op(name))
    assert tdisp.signature(name) == ref_sig


@pytest.mark.parametrize("name", OPS)
def test_kernel_takes_every_argument_by_name(name):
    kernel = tdisp.KERNELS[name]
    inspect.signature(kernel).bind(**{n: None for n, _ in
                                      tdisp.SCHEMA[name]})
    # the top-level export is the op on the Paddle surface (Tensor
    # results), or tensor_api's function over it, the package's own
    # ``einsum(equation, *operands)``, the inplace function; the fft and
    # signal ops have none (``paddle_tpu_torch.fft`` is the module)
    top = getattr(paddle_tpu_torch, name, None)
    if name in tdisp.NAMESPACED:
        assert not callable(top)
    else:
        assert top is tdisp.public_op(name) or \
            name in paddle_tpu_torch.tensor_api.__all__ or \
            name in tdisp.INPLACE or name == "einsum"
    assert tdisp.public_op(name).__wrapped_op__ is tdisp.get_op(name)


def test_unknown_op_raises_key_error():
    with pytest.raises(KeyError, match="no_such_op"):
        tdisp.call_op("no_such_op", 1)
    with pytest.raises(KeyError):
        tdisp.get_op("moe_ffn")         # not in the port's table yet


def test_unknown_keyword_raises_type_error():
    x = torch.zeros(2, 3)
    with pytest.raises(TypeError):
        tdisp.call_op("fused_softmax_ce", x, torch.zeros(2).long(), bogus=1)


def _varlen_inputs(seed, lens, h, hk, d):
    rng = np.random.RandomState(seed)
    t = sum(lens)
    cu = np.cumsum([0] + lens).astype(np.int32)
    q, k, v = ((rng.randn(t, n, d) * 0.3).astype(np.float32)
               for n in (h, hk, hk))
    return q, k, v, cu


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("hk", [1, 4])
def test_flash_attn_unpadded_equals_reference_op(causal, hk):
    q, k, v, cu = _varlen_inputs(hk, [37, 91, 1, 0, 128, 60], 4, hk, 32)
    kw = dict(max_seqlen_q=128, max_seqlen_k=128, scale=0.0, causal=causal,
              name="attn")
    # the reference's call_op takes the op name as a keyword too, so its
    # op function receives the name= keyword
    want = rdisp.get_op("flash_attn_unpadded")(
        *(paddle.to_tensor(x) for x in (q, k, v, cu, cu)), **kw).numpy()
    args = [torch.from_numpy(x) for x in (q, k, v, cu, cu)]
    got = tdisp.call_op("flash_attn_unpadded", *args, **kw)
    top = paddle_tpu_torch.flash_attn_unpadded(*args, **kw)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=1e-6)
    assert torch.equal(got, top)


def test_flash_attn_unpadded_op_grads_equal_the_function():
    """The registry adds nothing to the autograd graph: grads through
    ``call_op`` (int64 cu_seqlens, cast by the op) equal those of the
    kernel module's function, bit for bit."""
    q, k, v, cu = _varlen_inputs(3, [50, 78], 4, 2, 32)
    w = torch.from_numpy(np.random.RandomState(4).randn(128, 4, 32)
                         .astype(np.float32))
    grads = []
    for via_op in (True, False):
        t = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
        if via_op:
            cu64 = torch.from_numpy(cu).long()
            out = tdisp.call_op("flash_attn_unpadded", *t, cu64, cu64,
                                causal=True)
        else:
            from paddle_tpu_torch.ops.kernels import flash_varlen as fv
            c = torch.from_numpy(cu)
            out = fv.flash_attn_unpadded(*t, c, c, causal=True)
        (out * w).sum().backward()
        grads.append([x.grad for x in t])
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_flash_attention_equals_reference_op():
    rng = np.random.RandomState(5)
    q = rng.randn(2, 128, 4, 32).astype(np.float32)
    k, v = (rng.randn(2, 128, 2, 32).astype(np.float32) for _ in range(2))
    want = paddle.flash_attention(*(paddle.to_tensor(x) for x in (q, k, v)),
                                  is_causal=True, name="fa").numpy()
    got = tdisp.call_op("flash_attention",
                        *(torch.from_numpy(x) for x in (q, k, v)),
                        is_causal=True, name="fa")
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=1e-6)


def test_fused_softmax_ce_equals_reference_call_op():
    rng = np.random.RandomState(6)
    logits = rng.randn(3, 7, 50).astype(np.float32)
    labels = rng.randint(0, 50, (3, 7)).astype(np.int32)
    labels[0, 2] = -100
    want = rdisp.call_op("fused_softmax_ce", paddle.to_tensor(logits),
                         paddle.to_tensor(labels)).numpy()
    got = paddle_tpu_torch.fused_softmax_ce(torch.from_numpy(logits),
                                            torch.from_numpy(labels))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_grouped_gemm_equals_reference_call_op():
    rng = np.random.RandomState(7)
    x = rng.randn(4, 16, 32).astype(np.float32)
    w = rng.randn(2, 32, 24).astype(np.float32)
    counts = np.array([16, 5, 0, 9], np.int32)
    want = rdisp.call_op("grouped_gemm", paddle.to_tensor(x),
                         paddle.to_tensor(w), paddle.to_tensor(counts),
                         groups_per_expert=2).numpy()
    got = tdisp.call_op("grouped_gemm", torch.from_numpy(x),
                        torch.from_numpy(w), torch.from_numpy(counts),
                        groups_per_expert=2)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_weight_quantize_equals_reference_call_op():
    w = np.random.RandomState(8).randn(64, 48).astype(np.float32)
    want = rdisp.call_op("weight_quantize", paddle.to_tensor(w),
                         algo="weight_only_int8")
    got = tdisp.call_op("weight_quantize", torch.from_numpy(w),
                        algo="weight_only_int8", name="wq")
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
