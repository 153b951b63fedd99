"""The inplace family of the port against the JAX package's.

Every inplace op of ``ops.yaml`` (the 103 rows of ``:628-657`` and
``:728-808``; ``subtract_`` is listed twice) as a ``Tensor`` method and a
top-level function, held to the reference's module-level op on the same
numpy input (``tests/_torch_both.py``):

- the values (float32 atol 1e-5, rtol 1e-5; ints and bools exactly), and
  the result's dtype kind (a comparison turns the tensor into bools, as
  the reference rebinds it);
- ``x.op_(...) is x``, and ``inplace_version`` up by one;
- the leaf guard: on a leaf that requires grad each raises ``ValueError``
  ("inplace strategy") while grad is on, in both packages, and runs under
  ``no_grad``;
- autograd through an inplace op on an intermediate (``tanh_``,
  ``where_``, ``multiply_``, ``reshape_``), as
  ``tests/test_api_surface.py:269-299``: the grads equal the reference's.

The random fills (``normal_``, ``uniform_``, ``cauchy_``, ``geometric_``,
``exponential_``) are held by shape, dtype and support, not values.
"""

import numpy as np
import pytest

import paddle_tpu
import paddle_tpu_torch
from _torch_both import assert_both, assert_tree, run_both
from paddle_tpu_torch.ops.dispatcher import INPLACE

RNG = np.random.RandomState(0)
UNIT = RNG.uniform(0.1, 0.9, (3, 4)).astype(np.float32)   # (0, 1) domain
POS = RNG.uniform(0.5, 3.0, (3, 4)).astype(np.float32)
SIGNED = RNG.uniform(-2.0, 2.0, (3, 4)).astype(np.float32)
INTS = RNG.randint(1, 40, (3, 4)).astype(np.int32)
INTS2 = RNG.randint(1, 6, (3, 4)).astype(np.int32)
BOOLS = RNG.rand(3, 4) > 0.5
BOOLS2 = RNG.rand(3, 4) > 0.5
VEC = RNG.uniform(0.5, 1.5, (6,)).astype(np.float32)


def T(a):
    return ("tensor", a)


# op -> (x, args, kwargs)
UNARY_UNIT = ("exp_", "sqrt_", "rsqrt_", "tanh_", "sigmoid_", "relu_",
              "floor_", "ceil_", "round_", "trunc_", "reciprocal_",
              "erfinv_", "abs_", "acos_", "asin_", "atan_", "atanh_", "cos_",
              "cosh_", "digamma_", "erf_", "expm1_", "frac_", "gammaln_",
              "i0_", "lgamma_", "log_", "log10_", "log2_", "logit_", "neg_",
              "sin_", "sinh_", "square_", "tan_", "log1p_", "nan_to_num_",
              "asinh_", "zero_", "t_", "flatten_", "tril_", "triu_")
BINARY_POS = ("add_", "subtract_", "multiply_", "divide_", "remainder_",
              "floor_divide_", "floor_mod_", "mod_", "copysign_", "hypot_",
              "gammainc_", "gammaincc_", "equal_", "greater_equal_",
              "greater_than_", "less_equal_", "less_than_", "not_equal_")
BITWISE = ("bitwise_and_", "bitwise_or_", "bitwise_xor_",
           "bitwise_left_shift_", "bitwise_right_shift_", "gcd_", "lcm_")
LOGICAL = ("logical_and_", "logical_or_", "logical_xor_")
CASES = {name: (UNIT, (), {}) for name in UNARY_UNIT}
CASES.update({name: (POS, (T(np.roll(POS, 1)),), {})
              for name in BINARY_POS})
CASES.update({name: (INTS, (T(INTS2),), {}) for name in BITWISE})
CASES.update({name: (BOOLS, (T(BOOLS2),), {}) for name in LOGICAL})
CASES.update({
    "acosh_": (POS + 1.0, (), {}),
    "bitwise_not_": (INTS, (), {}),
    "logical_not_": (BOOLS, (), {}),
    "clip_": (SIGNED, (), {"min": -0.5, "max": 0.7}),
    "scale_": (SIGNED, (), {"scale": 2.0, "bias": 1.0}),
    "pow_": (POS, (2.0,), {}),
    "lerp_": (POS, (T(SIGNED), T(UNIT)), {}),
    "ldexp_": (SIGNED, (T(np.float32(INTS2)),), {}),
    "addmm_": (SIGNED[:, :3], (T(SIGNED), T(POS.T.copy())),
               {"beta": 0.5, "alpha": 2.0}),
    "cast_": (SIGNED, ("int32",), {}),
    "cumprod_": (POS, (), {"dim": 1}),
    "cumsum_": (VEC, (), {}),
    "reshape_": (SIGNED, ([4, 3],), {}),
    "squeeze_": (SIGNED[:, None, :], (), {"axis": 1}),
    "unsqueeze_": (SIGNED, (), {"axis": 0}),
    "transpose_": (SIGNED, ([1, 0],), {}),
    "masked_fill_": (SIGNED, (T(BOOLS),), {"value": 3.0}),
    "masked_scatter_": (SIGNED, (T(BOOLS), T(POS * 10)), {}),
    "index_fill_": (SIGNED, (T(np.array([0, 2], np.int64)),),
                    {"axis": 0, "value": -1.0}),
    "index_put_": (SIGNED, ([T(np.array([0, 2], np.int64)),
                             T(np.array([1, 3], np.int64))],
                            T(np.array([5.0, 6.0], np.float32))), {}),
    "put_along_axis_": (SIGNED, (T(np.array([[0], [2], [1]], np.int64)),
                                 T(np.full((3, 1), 7.0, np.float32)), 1),
                        {}),
    "scatter_": (SIGNED, (T(np.array([2, 0], np.int64)),
                          T(np.ones((2, 4), np.float32))), {}),
    "multigammaln_": (POS + 1.0, (2,), {}),
    "polygamma_": (POS, (1,), {}),
    "renorm_": (SIGNED, (2.0, 0, 1.0), {}),
    "fill_": (SIGNED, (), {"value": 2.5}),
})
RANDOM_FILLS = {
    "normal_": ((), {}, None), "uniform_": ((), {}, (-1.0, 1.0)),
    "cauchy_": ((), {}, None), "geometric_": ((), {}, (0.0, None)),
    "exponential_": ((), {}, (0.0, None)),
}


def test_every_inplace_op_has_a_case():
    import yaml
    import os
    rows = yaml.safe_load(open(os.path.join(
        os.path.dirname(paddle_tpu.__file__), "ops", "ops.yaml")))
    names = [r["op"] for r in rows if r.get("inplace_of")]
    assert len(names) == 103 and set(names) == set(INPLACE)
    assert set(CASES) | set(RANDOM_FILLS) == set(INPLACE)


def _make(P, v):
    if isinstance(v, tuple) and len(v) == 2 and v[0] == "tensor":
        return P.to_tensor(v[1])
    if isinstance(v, list):
        return [_make(P, a) for a in v]
    return v


def _run(name, method):
    x0, args, kw = CASES[name]

    def fn(P):
        x = P.to_tensor(x0)
        v0 = x.inplace_version
        a = [_make(P, v) for v in args]
        if method and P is paddle_tpu_torch:
            out = getattr(x, name)(*a, **kw)
        else:
            out = getattr(P, name)(x, *a, **kw)
        return [x, out is x, x.inplace_version - v0]
    return fn


@pytest.mark.parametrize("method", [True, False], ids=["method", "function"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_inplace_op_matches_reference(name, method):
    ref, port = run_both(_run(name, method))
    assert port[1] is True and port[2] == 1, port[1:]
    assert ref[2] == 1
    assert_tree(port[0], ref[0], atol=1e-5, rtol=1e-5)
    kinds = {np.asarray(port[0]).dtype.kind, np.asarray(ref[0]).dtype.kind}
    assert len(kinds) == 1 or kinds <= {"i", "u"}, kinds


@pytest.mark.parametrize("name", sorted(RANDOM_FILLS))
def test_random_fill_keeps_shape_dtype_and_support(name):
    args, kw, support = RANDOM_FILLS[name]
    P = paddle_tpu_torch
    P.set_device("cpu")
    P.seed(4)
    x = P.zeros([64, 32])
    v0 = x.inplace_version
    assert getattr(x, name)(*args, **kw) is x
    assert x.inplace_version == v0 + 1 and x.shape == [64, 32]
    assert x.dtype == P.float32 and np.unique(x.numpy()).size > 1000
    y = P.zeros([64, 32])
    assert getattr(P, name)(y, *args, **kw) is y
    if support is not None:
        lo, hi = support
        assert x.numpy().min() >= lo and (hi is None or x.numpy().max() <= hi)


FLOAT_OPS = sorted(n for n, (x0, _, _) in CASES.items()
                   if x0.dtype == np.float32) + sorted(RANDOM_FILLS)


@pytest.mark.parametrize("name", FLOAT_OPS)
def test_leaf_guard(name):
    x0, args, kw = CASES.get(name, (UNIT, (), {}))
    if name in RANDOM_FILLS:
        args, kw = RANDOM_FILLS[name][:2]
    for P in (paddle_tpu, paddle_tpu_torch):
        paddle_tpu_torch.set_device("cpu")
        x = P.to_tensor(x0, stop_gradient=False)
        a = [_make(P, v) for v in args]
        with pytest.raises(ValueError, match="inplace strategy"):
            getattr(P, name)(x, *a, **kw)
        with P.no_grad():
            assert getattr(P, name)(x, *a, **kw) is x


def _through(name):
    def fn(P):
        w = P.to_tensor(np.array([1.0, 2.0, 3.0, 4.0], np.float32),
                        stop_gradient=False)
        h = w * 2.0
        if name == "tanh_":
            P.tanh_(h)
        elif name == "where_":
            P.where_(P.to_tensor(np.array([True, False, True, False])), h,
                     P.to_tensor(np.full(4, 9.0, np.float32)))
        elif name == "multiply_":
            h.multiply_(w)
        elif name == "reshape_":
            h.reshape_([2, 2])
        loss = (h * h).sum()
        loss.backward()
        return [h, loss, w.grad, h.stop_gradient]
    return fn


@pytest.mark.parametrize("name", ["tanh_", "where_", "multiply_",
                                  "reshape_"])
def test_autograd_through_inplace_on_an_intermediate(name):
    assert_both(_through(name), atol=1e-5, rtol=1e-5)


def test_where_inplace_leaf_guard():
    P = paddle_tpu_torch
    P.set_device("cpu")
    x = P.to_tensor([1.0], stop_gradient=False)
    with pytest.raises(ValueError, match="inplace strategy"):
        P.where_(P.to_tensor([True]), x, P.to_tensor([2.0]))


def test_inplace_on_a_plain_tensor_stays_plain():
    """Torch in, torch out: the top-level inplace function on a plain
    tensor writes it and returns it, still a plain tensor."""
    import torch
    x = torch.tensor([0.5, 1.0])
    out = paddle_tpu_torch.tanh_(x)
    assert out is x and type(x) is torch.Tensor
    np.testing.assert_allclose(x.numpy(), np.tanh([0.5, 1.0]), rtol=1e-6)
    y = torch.ones(2, 3)
    assert paddle_tpu_torch.reshape_(y, [3, 2]) is y
    assert type(y) is torch.Tensor and tuple(y.shape) == (3, 2)
