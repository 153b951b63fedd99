"""The op forms of ``ops.yaml:577-620`` that run on one device
(``ops/kernels/extra_misc.py``: the eleven functional optimizer updates,
amp's two ops, the local ``c_*`` ops, the fused ops and
``memory_efficient_attention``) and the quantization ops ``fake_quantize``
and ``llm_int8_linear`` (``ops/kernels/quant.py``) against the JAX
package's ops, on the CPU, through ``tests/_torch_op_check.py``: one
parametrised case an entry (the optimizers also with a float16 param and
a float32 master), forward and, where the reference differentiates the
op, the VJP of the floating inputs.

Tolerances: atol / rtol 1e-5 (float32); 1e-3 where the param is float16
(one float16 ulp at 1 is 9.8e-4); ``llm_int8_linear`` at k = 4096 exactly
(the int8 product accumulates in int32 on both sides).
``memory_efficient_attention`` with dropout is held by its invariants
(the draws are not the reference's).
"""

import numpy as np
import pytest
import torch

from paddle_tpu.ops import dispatcher as rdisp
from paddle_tpu.core.tensor import Tensor as RTensor
import paddle_tpu_torch
from paddle_tpu_torch.core.device import set_device
from paddle_tpu_torch.ops import dispatcher as tdisp

from _torch_op_check import check_op

EW = dict(atol=1e-5, rtol=1e-5)
HALF = dict(atol=1e-3, rtol=1e-3)


@pytest.fixture(autouse=True)
def _on_cpu():
    set_device("cpu")
    yield
    set_device(None)


def normal(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def uniform(lo, hi, *shape, seed=0):
    return np.random.RandomState(seed).uniform(lo, hi, shape).astype(
        np.float32)


def one(v):
    return np.array([v], np.float32)


P, G = normal(4, 6), normal(4, 6, seed=1) * 0.1
M1, M2 = normal(4, 6, seed=2) * 0.01, uniform(0, 1e-3, 4, 6, seed=3)
LR = one(0.01)


def _optimizer_cases():
    """Each rule over a float32 param; each op's first case also over a
    float16 param with a float32 master (``multi_precision``)."""
    pows = [one(0.9 ** 3), one(0.999 ** 3)]
    rules = {
        "sgd_op": ("sgd_op", [P, LR, G], {}),
        "momentum_op": ("momentum_op", [P, G, M1, LR], dict(
            mu=0.9, regularization_method="l2_decay",
            regularization_coeff=1e-4, rescale_grad=0.5)),
        "momentum_op_nesterov": ("momentum_op", [P, G, M1, LR],
                                 dict(use_nesterov=True)),
        "adam_op": ("adam_op", [P, G, LR, M1, M2, *pows], {}),
        "adamw_op": ("adamw_op", [P, G, LR, M1, M2, *pows],
                     dict(coeff=0.1, lr_ratio=0.5)),
        "adamw_op_no_decay": ("adamw_op", [P, G, LR, M1, M2, *pows],
                              dict(with_decay=False)),
        "adagrad_op": ("adagrad_op", [P, G, M2, LR], {}),
        "adadelta_op": ("adadelta_op", [P, G, M2,
                                        uniform(0, 1e-3, 4, 6, seed=4), LR],
                        {}),
        "adamax_op": ("adamax_op", [P, G, LR, M1, np.abs(M1), pows[0]], {}),
        "rmsprop_op": ("rmsprop_op", [P, M2, G, M1, LR], dict(momentum=0.9)),
        "rmsprop_op_centered": ("rmsprop_op", [P, M2, G, M1, LR, M1 * 0.1],
                                dict(centered=True)),
        "lamb_op": ("lamb_op", [P, G, LR, M1, M2, *pows],
                    dict(weight_decay=0.01)),
        "asgd_op": ("asgd_op", [P, G, LR, M1, normal(4, 6, seed=5) * 0.1,
                                np.array([3.0], np.float32)], {}),
        "rprop_op": ("rprop_op", [P, G, np.where(normal(4, 6, seed=6) > 0,
                                                  G, -G),
                                  uniform(0.001, 0.01, 4, 6, seed=7)],
                     dict(learning_rate_range=[1e-4, 5e-3],
                          etas=[0.4, 1.3])),
    }
    # where master_param sits in each op's arguments
    master_at = {"sgd_op": 3, "momentum_op": 4, "adam_op": 7, "adamw_op": 7,
                 "adagrad_op": 4, "adadelta_op": 5, "adamax_op": 6,
                 "rmsprop_op": 6, "lamb_op": 7, "asgd_op": 6,
                 "rprop_op": 4}
    c = {}
    for case, (op, args, kw) in rules.items():
        c[case] = (op, list(args), kw, EW)
        if case != op:
            continue
        half = [P.astype(np.float16)] + list(args[1:])
        half += [None] * (master_at[op] - len(half))
        half.insert(master_at[op], P)
        c[f"{case}_master"] = (op, half, dict(kw, multi_precision=True),
                               HALF)
    return c


def _cases():
    c = _optimizer_cases()
    # amp
    xs = [normal(3, 4) * 8, normal(5, seed=1) * 8]
    bad = [xs[0], np.array([1.0, np.inf, 2.0, 3.0, 4.0], np.float32)]
    c["check_finite_and_unscale_op"] = (
        "check_finite_and_unscale_op", [xs, one(1024.0)], {}, EW)
    c["check_finite_and_unscale_op_inf"] = (
        "check_finite_and_unscale_op", [bad, one(1024.0)], {}, EW)
    i32 = lambda v: np.array([v], np.int32)  # noqa: E731
    for tag, found, good, bad_n in (("grow", False, 999, 0),
                                    ("good", False, 5, 1),
                                    ("shrink", True, 3, 1),
                                    ("bad", True, 0, 0)):
        c[f"update_loss_scaling_op_{tag}"] = (
            "update_loss_scaling_op", [xs, np.array(found), one(1024.0),
                                       i32(good), i32(bad_n)], {}, EW)
    c["update_loss_scaling_op_stop"] = (
        "update_loss_scaling_op", [xs, np.array(True), one(1024.0), i32(3),
                                   i32(1)], dict(stop_update=True), EW)
    # the c_* ops
    c["c_identity"] = ("c_identity", [normal(3, 4)], {}, EW)
    c["c_concat"] = ("c_concat", [normal(3, 4)], dict(nranks=2), EW)
    c["c_embedding"] = ("c_embedding", [
        normal(6, 4), np.array([[8, 9, 13], [14, 7, 10]], np.int64)],
        dict(start_index=8), EW)
    # fused ops
    scores = normal(2, 3, 5, 5)
    c["fused_softmax_mask"] = ("fused_softmax_mask", [
        scores, np.where(normal(2, 1, 5, 5, seed=1) > 0, 0.0, -1e4).astype(
            np.float32)], {}, EW)
    c["fused_softmax_mask_upper_triangle"] = (
        "fused_softmax_mask_upper_triangle", [scores], {}, EW)
    c["fused_gemm_epilogue"] = ("fused_gemm_epilogue", [
        normal(4, 6), normal(6, 5, seed=1), normal(5, seed=2)],
        dict(activation="gelu"), EW)
    c["fused_gemm_epilogue_trans"] = ("fused_gemm_epilogue", [
        normal(6, 4), normal(5, 6, seed=1), normal(5, seed=2)],
        dict(trans_x=True, trans_y=True, activation="relu"), EW)
    for act in ("gelu", "relu", "swiglu", "identity"):
        c[f"fused_bias_act_{act}"] = ("fused_bias_act", [
            normal(3, 8), normal(8, seed=1)], dict(act_method=act), EW)
    c["fused_linear_param_grad_add"] = ("fused_linear_param_grad_add", [
        normal(2, 3, 4), normal(2, 3, 5, seed=1), normal(4, 5, seed=2),
        normal(5, seed=3)], {}, EW)
    c["fused_linear_param_grad_add_no_bias"] = (
        "fused_linear_param_grad_add", [normal(6, 4), normal(6, 5, seed=1)],
        dict(has_bias=False), EW)
    q, k, v = (normal(2, 6, 4, 8, seed=s) for s in range(3))
    c["memory_efficient_attention"] = ("memory_efficient_attention", [
        q, normal(2, 6, 2, 8, seed=1), normal(2, 6, 2, 8, seed=2)],
        dict(is_causal=True), EW)
    c["memory_efficient_attention_mask"] = ("memory_efficient_attention", [
        q, k, v, normal(2, 4, 6, 6, seed=3)], dict(scale=0.2), EW)
    # quantization
    x = normal(4, 8)
    c["fake_quantize"] = ("fake_quantize", [x, np.array(1.5, np.float32)],
                          {}, EW)
    c["fake_quantize_4bit"] = ("fake_quantize", [x, np.abs(x).max()[None]],
                               dict(bit_length=4), EW)
    return c


CASES = _cases()


@pytest.mark.parametrize("case", sorted(CASES))
def test_entry(case):
    name, args, kw, tol = CASES[case]
    check_op(name, args, kw, **tol)


def _int8_case(m, k, n, seed, outliers=()):
    rng = np.random.RandomState(seed)
    x = rng.randn(m, k).astype(np.float32)
    for c in outliers:
        x[0, c] = 9.0
    w = rng.randint(-127, 128, (k, n)).astype(np.int8)
    sc = rng.uniform(0.001, 0.01, n).astype(np.float32)
    b = rng.randn(n).astype(np.float32)
    return x, w, sc, b


def test_llm_int8_linear_with_outliers():
    x, w, sc, b = _int8_case(5, 64, 16, 0, outliers=(3, 40))
    check_op("llm_int8_linear", [x, w, b, sc], {}, atol=1e-5, rtol=1e-5)


def test_llm_int8_linear_k4096_accumulates_exactly():
    """k = 4096 with every product at its largest: the int8 product's
    partial sums reach 127**2 * 4096 > 2**24, past float32's exact
    integers, and the result equals the reference's bit for bit."""
    rng = np.random.RandomState(1)
    k = 4096
    x = np.abs(rng.randn(4, k)).astype(np.float32) + 1.0
    x[:, ::2] = 2.0                  # the row's abs-max: xq 127 there
    w = np.full((k, 8), 127, np.int8)
    w[::7] = rng.randint(-127, 128, (len(w[::7]), 8))
    sc = np.full(8, 0.01, np.float32)
    want = rdisp.call_op("llm_int8_linear", RTensor(x), RTensor(w),
                         weight_scale=RTensor(sc)).numpy()
    got = tdisp.call_op("llm_int8_linear", torch.from_numpy(x),
                        torch.from_numpy(w), weight_scale=torch.from_numpy(sc))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    from paddle_tpu_torch.ops.kernels.quant import _int8_product
    xq = torch.from_numpy(rng.randint(0, 128, (4, k)).astype(np.int8))
    xq[:, ::2] = 127
    exact = xq.numpy().astype(np.int64) @ w.astype(np.int64)
    assert np.abs(exact).max() > 2 ** 24
    got_i = _int8_product(xq, torch.from_numpy(w))
    assert got_i.dtype == torch.int32
    np.testing.assert_array_equal(got_i.numpy(), exact)


def test_memory_efficient_attention_dropout_draws_from_the_port():
    """Dropout 0.1: a fresh draw each call from the port's generator,
    repeated under ``seed``; the kept probabilities scaled by 1 / 0.9."""
    q, k, v = (torch.from_numpy(normal(2, 16, 4, 8, seed=s))
               for s in range(3))
    plain = tdisp.call_op("memory_efficient_attention", q, k, v)
    paddle_tpu_torch.seed(5)
    a = tdisp.call_op("memory_efficient_attention", q, k, v, dropout_p=0.1)
    b = tdisp.call_op("memory_efficient_attention", q, k, v, dropout_p=0.1)
    paddle_tpu_torch.seed(5)
    a2 = tdisp.call_op("memory_efficient_attention", q, k, v, dropout_p=0.1)
    assert torch.equal(a, a2) and not torch.equal(a, b)
    assert not torch.allclose(a, plain)
    assert abs(float(a.mean() - plain.mean())) < 0.1
    zeros = torch.zeros(1, 64, 1, 64)
    eye = torch.eye(64)[None, :, None, :]      # out[i, j] = probs[i, j]
    kept = tdisp.call_op("memory_efficient_attention", zeros, zeros, eye,
                         dropout_p=0.1)
    share = float((kept != 0).float().mean())
    assert 0.87 < share < 0.93
    torch.testing.assert_close(kept[kept != 0],
                               torch.full_like(kept[kept != 0],
                                               1 / 64 / 0.9))


def test_update_loss_scaling_zeroes_xs_on_found():
    xs = [torch.from_numpy(normal(3, 4))]
    out = tdisp.call_op("update_loss_scaling_op", xs, torch.tensor(True),
                        torch.tensor([8.0]), torch.tensor([5], dtype=torch.int32),
                        torch.tensor([1], dtype=torch.int32),
                        decr_every_n_nan_or_inf=2)
    assert bool((out[0] == 0).all())
    assert float(out[1]) == 4.0 and int(out[2]) == 0 and int(out[3]) == 0
    assert out[2].dtype == out[3].dtype == torch.int32


def test_every_entry_has_a_case():
    from paddle_tpu_torch.ops.kernels import extra_misc, quant
    section = {
        "sgd_op", "momentum_op", "adam_op", "adamw_op", "adagrad_op",
        "adadelta_op", "adamax_op", "rmsprop_op", "lamb_op", "asgd_op",
        "rprop_op", "check_finite_and_unscale_op", "update_loss_scaling_op",
        "c_identity", "c_concat", "c_embedding", "fused_softmax_mask",
        "fused_softmax_mask_upper_triangle", "fused_gemm_epilogue",
        "fused_bias_act", "fused_linear_param_grad_add",
        "memory_efficient_attention"}
    assert len(section) == 22
    assert section <= {n for n, k in tdisp.KERNELS.items()
                       if k.__module__ == extra_misc.__name__}
    assert {"fake_quantize", "llm_int8_linear"} <= {
        n for n, k in tdisp.KERNELS.items() if k.__module__ == quant.__name__}
    covered = {v[0] for v in CASES.values()} | {"llm_int8_linear"}
    assert section | {"fake_quantize", "llm_int8_linear"} <= covered
    assert section <= set(dir(paddle_tpu_torch))
