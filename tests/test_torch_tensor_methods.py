"""The port's Tensor methods and the ops behind them, against the JAX
package.

- Every ``method: true`` row of ``ops.yaml`` is a method of
  ``paddle_tpu_torch.Tensor``, and so is every other tensor-first op of the
  port's registry, with Paddle's meaning over torch's inherited one.
- The method form equals the function form, bit for bit, for every op
  that takes one tensor and nothing else required, and for a set of ops
  with arguments.
- The 54 method ops this slice adds (``math_ext.py`` / ``extra_math.py``),
  ``fill`` and the 9 deterministic ops of ``ops.yaml:809-818`` go through
  ``tests/_torch_op_check.py``: values, and where the reference
  differentiates the op the VJP of every floating input, float32 at atol
  1e-5 (rtol 1e-5) unless a case states its own. ``gammainc`` /
  ``gammaincc`` are checked forward there and for their gradient with
  respect to ``y`` apart: torch has no gradient with respect to ``x``.
"""

import numpy as np
import pytest
import torch

import paddle_tpu_torch
from _torch_op_check import check_op
from paddle_tpu.ops import dispatcher as rdisp
from paddle_tpu_torch.ops import dispatcher as tdisp

P = paddle_tpu_torch


def rnd(*shape, seed=0, lo=-2.0, hi=2.0):
    return np.random.RandomState(seed).uniform(lo, hi, shape).astype(
        np.float32)


def pos(*shape, seed=0):
    return rnd(*shape, seed=seed, lo=0.5, hi=3.0)


def ints(*shape, seed=0, lo=0, hi=10):
    return np.random.RandomState(seed).randint(lo, hi, shape).astype(
        np.int32)


def test_every_method_row_is_a_tensor_method():
    rows = [n for n, s in rdisp.OPS.items() if s.method]
    assert len(rows) == 201
    missing = [n for n in rows if not callable(getattr(P.Tensor, n, None))]
    assert missing == []
    for n in rows:
        # the Paddle op, not torch's inherited method of the same name
        assert getattr(P.Tensor, n) is not getattr(torch.Tensor, n, None), n


def test_every_tensor_first_op_is_a_method():
    from paddle_tpu_torch.core.tensor import TORCH_OWNED
    for name in tdisp.SCHEMA:
        if name in tdisp.NOT_TENSOR_FIRST or name in TORCH_OWNED:
            continue
        assert callable(getattr(P.Tensor, name)), name


def test_paddle_meanings_win_on_a_tensor():
    P.set_device("cpu")
    x = P.to_tensor(rnd(2, 3, 4))
    assert x.shape == [2, 3, 4] and x.size == 24 and x.ndim == 3
    assert x.transpose([2, 0, 1]).shape == [4, 2, 3]
    assert x.reshape([6, 4]).shape == [6, 4]
    assert x.flatten(1, 2).shape == [2, 12]
    assert x.sum(axis=1).shape == [2, 4]
    assert x.mean(axis=[0, 2], keepdim=True).shape == [1, 3, 1]
    assert isinstance(x.max(axis=0), P.Tensor)
    assert [t.shape for t in x.split(2, axis=2)] == [[2, 3, 2]] * 2
    assert x.T.shape == [4, 3, 2]
    assert x.expand([5, 2, 3, 4]).shape == [5, 2, 3, 4]
    assert x.numel().item() == 24


UNARY = sorted(n for n, s in tdisp.SCHEMA.items()
               if s and s[0][0] == "x" and all(d is not tdisp.REQUIRED
                                               for _, d in s[1:])
               and n not in tdisp.NOT_TENSOR_FIRST)
SKIP_METHOD_CHECK = {
    "bernoulli", "poisson", "shuffle", "shuffle_batch", "standard_gamma",
    "multinomial", "normal_like", "uniform_like", "exponential",
    "cauchy_like", "geometric_like", "rrelu", "dropout", "pca_lowrank",
    "gumbel_softmax",      # random: the same draw would need a reseed
    "set_value"}           # Tensor's own (Paddle's: assign a value)


def _input(name):
    if name.startswith(("bitwise", "gcd", "lcm")) or name in ("bincount",):
        return ints(6, seed=1, lo=1)
    if name in ("logical_not", "as_complex"):
        return rnd(3, 2) > 0 if name == "logical_not" else rnd(3, 2)
    if name in ("cholesky", "inverse"):
        a = rnd(3, 3)
        return (a @ a.T + 3 * np.eye(3)).astype(np.float32)
    return pos(3, 4)


@pytest.mark.parametrize("name", [n for n in UNARY
                                  if n not in SKIP_METHOD_CHECK])
def test_method_form_equals_function_form(name):
    P.set_device("cpu")
    x = P.to_tensor(_input(name))
    # the fft and signal ops' function form lives in their namespaces
    fn = tdisp.public_op(name) if name in tdisp.NAMESPACED else \
        getattr(P, name)
    try:
        want = fn(x)
    except Exception as e:                    # the op refuses this input:
        with pytest.raises(type(e)):          # so must the method
            getattr(x, name)()
        return
    got = getattr(x, name)()
    for g, w in zip(*(o if isinstance(o, (tuple, list)) else (o,)
                      for o in (got, want))):
        assert isinstance(g, P.Tensor)
        assert torch.equal(g, w) or (g.isnan() == w.isnan()).all(), name


@pytest.mark.parametrize("name,args,kw", [
    ("matmul", (rnd(4, 2),), {"transpose_x": False}),
    ("add", (rnd(3, 4),), {}), ("pow", (2.0,), {}),
    ("gather", (np.array([2, 0]),), {"axis": 1}),
    ("topk", (2,), {"axis": -1}), ("clip", (), {"min": 0.5, "max": 1.0}),
    ("kthvalue", (2,), {}), ("quantile", (0.3,), {"axis": 1}),
    ("take", (np.array([0, 5, 11]),), {}), ("rot90", (), {"k": 3}),
    ("tensor_split", ([1, 3],), {"axis": 1}),
    ("index_fill", (np.array([1]),), {"axis": 0, "value": 7.0}),
])
def test_method_form_with_arguments(name, args, kw):
    P.set_device("cpu")
    x = P.to_tensor(pos(3, 4))
    a = [P.to_tensor(v) if isinstance(v, np.ndarray) else v for v in args]
    got, want = getattr(x, name)(*a, **kw), getattr(P, name)(x, *a, **kw)
    for g, w in zip(*(o if isinstance(o, (tuple, list)) else (o,)
                      for o in (got, want))):
        assert torch.equal(g, w)


TOL = dict(atol=1e-5, rtol=1e-5)
X34, P34, S34 = rnd(3, 4), pos(3, 4), rnd(3, 4, seed=2)
CASES = {
    "quantile": ("quantile", [X34], dict(q=[0.2, 0.75], axis=1), TOL),
    "quantile_all": ("quantile", [X34], dict(q=0.4), TOL),
    "quantile_keepdim": ("quantile", [X34], dict(
        q=0.5, axis=0, keepdim=True, interpolation="nearest"), TOL),
    # positions at .5 (q (n - 1) = 0.5, 1.5): JAX rounds them down
    "quantile_nearest_half": ("quantile", [X34], dict(
        q=[0.25, 0.75], axis=0, interpolation="nearest"), TOL),
    "kthvalue": ("kthvalue", [X34], dict(k=2, axis=1), TOL),
    "kthvalue_ties": ("kthvalue", [np.float32([[1, 3, 1, 2], [2, 2, 5,
                                                              2]])],
                      dict(k=2, axis=1, keepdim=True), TOL),
    "mode": ("mode", [np.float32([[1, 3, 1, 2, 3], [2, 2, 5, 5, 0]])], {},
             TOL),
    "mode_axis0": ("mode", [np.float32([[1, 3], [1, 2], [2, 3]])],
                   dict(axis=0, keepdim=True), TOL),
    "count_nonzero": ("count_nonzero",
                      [np.float32([[0, 1, 2], [0, 0, 3]])], dict(axis=1),
                      TOL),
    "count_nonzero_all": ("count_nonzero",
                          [np.float32([[0, 1, 2], [0, 0, 3]])], {}, TOL),
    "logcumsumexp": ("logcumsumexp", [X34], dict(axis=1), TOL),
    "logcumsumexp_flat": ("logcumsumexp", [X34], {}, TOL),
    "renorm": ("renorm", [X34], dict(p=2.0, axis=0, max_norm=1.5), TOL),
    "diff": ("diff", [X34], dict(n=2, axis=1), TOL),
    "heaviside": ("heaviside", [np.float32([[-1, 0, 2], [0, 3, -2]]),
                                rnd(2, 3, seed=3)], {}, TOL),
    "copysign": ("copysign", [X34, S34], {}, TOL),
    "deg2rad": ("deg2rad", [X34 * 90], {}, TOL),
    "rad2deg": ("rad2deg", [X34], {}, dict(atol=1e-4, rtol=1e-5)),
    "nan_to_num": ("nan_to_num", [np.float32([1, np.nan, np.inf,
                                              -np.inf])],
                   dict(nan=2.0, posinf=9.0), TOL),
    "ldexp": ("ldexp", [X34, np.float32(ints(3, 4, lo=-3, hi=4))], {}, TOL),
    "logit": ("logit", [rnd(3, 4, lo=0.05, hi=0.95)], {}, TOL),
    "logit_eps": ("logit", [rnd(3, 4, lo=0.0, hi=1.0)], dict(eps=0.1),
                  TOL),
    "signbit": ("signbit", [X34], {}, TOL),
    "sgn": ("sgn", [np.float32([-2, 0, 3])], {}, TOL),
    "isneginf": ("isneginf", [np.float32([-np.inf, 1, np.inf])], {}, TOL),
    "isposinf": ("isposinf", [np.float32([-np.inf, 1, np.inf])], {}, TOL),
    "isreal": ("isreal", [X34], {}, TOL),
    "i0": ("i0", [X34], {}, TOL), "i0e": ("i0e", [X34], {}, TOL),
    "i1": ("i1", [X34], {}, TOL), "i1e": ("i1e", [X34], {}, TOL),
    "frexp": ("frexp", [X34 * 10], {}, TOL),
    "take": ("take", [X34, np.array([[0, 11], [-1, 5]], np.int64)], {}, TOL),
    "take_wrap": ("take", [X34, np.array([13, -14], np.int64)],
                  dict(mode="wrap"), TOL),
    "take_clip": ("take", [X34, np.array([13, -14], np.int64)],
                  dict(mode="clip"), TOL),
    "bucketize": ("bucketize", [X34, np.float32([-1, 0, 0.5, 1.5])],
                  dict(right=True), TOL),
    "index_fill": ("index_fill", [X34, np.array([0, 2], np.int64)],
                   dict(axis=1, value=-3.0), TOL),
    "masked_scatter": ("masked_scatter", [X34, rnd(3, 4, seed=4) > 0,
                                          rnd(12, seed=5)], {}, TOL),
    "masked_scatter_short": ("masked_scatter", [X34, np.ones((3, 4), bool),
                                                rnd(5, seed=5)], {}, TOL),
    "rot90": ("rot90", [rnd(2, 3, 4)], dict(k=-1, axes=[1, 2]), TOL),
    "unflatten": ("unflatten", [rnd(2, 12)], dict(axis=1, shape=[3, -1]),
                  TOL),
    "expand_as": ("expand_as", [rnd(1, 4), X34], {}, TOL),
    "view_as": ("view_as", [X34, rnd(4, 3)], {}, TOL),
    "increment": ("increment", [X34], dict(value=2.5), TOL),
    "tensor_split": ("tensor_split", [rnd(7, 2)], dict(num_or_indices=3),
                     TOL),
    "tensor_split_idx": ("tensor_split", [rnd(2, 7)],
                         dict(num_or_indices=[2, 5], axis=1), TOL),
    "hsplit": ("hsplit", [rnd(2, 6)], dict(num_or_indices=3), TOL),
    "vsplit": ("vsplit", [rnd(6, 2)], dict(num_or_indices=[1, 4]), TOL),
    "dsplit": ("dsplit", [rnd(2, 2, 4)], dict(num_or_indices=2), TOL),
    "fill_diagonal": ("fill_diagonal", [rnd(3, 5)],
                      dict(value=9.0, offset=1), TOL),
    "fill_diagonal_wrap": ("fill_diagonal", [rnd(7, 3)],
                           dict(value=9.0, wrap=True), TOL),
    "fill_diagonal_3d": ("fill_diagonal", [rnd(3, 3, 3)], dict(value=1.0),
                         TOL),
    "gammaln": ("gammaln", [P34], {}, TOL),
    "gammainc": ("gammainc", [P34, pos(3, 4, seed=1)], {},
                 dict(TOL, grad=False)),
    "gammaincc": ("gammaincc", [P34, pos(3, 4, seed=1)], {},
                  dict(TOL, grad=False)),
    "polygamma": ("polygamma", [P34], dict(n=2), dict(atol=1e-4,
                                                       rtol=1e-5)),
    "multigammaln": ("multigammaln", [P34 + 1.0], dict(p=3), TOL),
    "nextafter": ("nextafter", [X34, S34], {}, dict(atol=0, rtol=0)),
    "nanmedian": ("nanmedian", [np.float32([[1, np.nan, 3, 4],
                                            [2, 8, np.nan, np.nan]])],
                  dict(axis=1), TOL),
    "nanmedian_all": ("nanmedian", [X34], dict(keepdim=True), TOL),
    "bitwise_left_shift": ("bitwise_left_shift", [ints(3, 4),
                                                  ints(3, 4, seed=1, hi=4)],
                           {}, TOL),
    "bitwise_right_shift": ("bitwise_right_shift",
                            [ints(3, 4, lo=-50, hi=50),
                             ints(3, 4, seed=1, hi=4)], {}, TOL),
    "fmax": ("fmax", [np.float32([1, np.nan, 3]),
                      np.float32([2, 1, np.nan])], {}, TOL),
    "fmin": ("fmin", [X34, S34], {}, TOL),
    "reverse": ("reverse", [rnd(2, 3, 4)], dict(axis=[0, 2]), TOL),
    "reverse_all": ("reverse", [X34], {}, TOL),
    "index_sample": ("index_sample", [X34, np.array([[0, 3], [1, 1],
                                                     [2, 0]], np.int64)],
                     {}, TOL),
    "index_put": ("index_put", [X34, [np.array([0, 2], np.int64),
                                      np.array([1, 3], np.int64)],
                                np.float32([5, 6])], {}, TOL),
    "index_put_acc": ("index_put", [X34, [np.array([0, 2], np.int64)],
                                    rnd(2, 4, seed=6)],
                      dict(accumulate=True), TOL),
    "as_strided": ("as_strided", [X34], dict(shape=[2, 3], stride=[4, 1],
                                             offset=1), TOL),
    "as_strided_overlap": ("as_strided", [X34], dict(shape=[3, 3],
                                                     stride=[2, 1]), TOL),
    "tensor_unfold": ("tensor_unfold", [rnd(2, 7)], dict(axis=1, size=3,
                                                         step=2), TOL),
    "fill": ("fill", [X34], dict(value=1.5), TOL),
    # ops.yaml:809-818 (pca_lowrank draws: tests/test_torch_random.py)
    "tensordot_impl": ("tensordot_impl", [rnd(2, 3, 4), rnd(4, 3, 5)],
                       dict(axes_x=[1, 2], axes_y=[1, 0]), TOL),
    "tensordot_size1": ("tensordot_impl", [rnd(2, 1), rnd(3, 2)],
                        dict(axes_x=[1], axes_y=[0]), TOL),
    "inner": ("inner", [X34, rnd(5, 4)], {}, TOL),
    "pdist": ("pdist", [rnd(5, 3)], {}, TOL),
    "pdist_p1": ("pdist", [rnd(5, 3)], dict(p=1.0), TOL),
    "pdist_inf": ("pdist", [rnd(5, 3)], dict(p=float("inf")), TOL),
    "cumulative_trapezoid": ("cumulative_trapezoid", [X34], dict(dx=0.5),
                             TOL),
    "cumulative_trapezoid_x": ("cumulative_trapezoid",
                               [X34, np.float32([0, 1, 3, 6])], {}, TOL),
    "combinations": ("combinations", [rnd(5)], dict(r=3), TOL),
    "combinations_repl": ("combinations", [rnd(3)],
                          dict(with_replacement=True), TOL),
    "diagonal_scatter": ("diagonal_scatter", [X34, rnd(3)],
                         dict(offset=1), TOL),
    "select_scatter": ("select_scatter", [X34, rnd(3)],
                       dict(axis=1, index=2), TOL),
    "slice_scatter": ("slice_scatter", [X34, rnd(3, 2)],
                      dict(axes=[1], starts=[0], ends=[4], strides=[2]),
                      TOL),
    "scatter_nd": ("scatter_nd", [np.array([[1], [3], [1]], np.int64),
                                  rnd(3, 2)], dict(shape=[5, 2]), TOL),
}
NEW_OPS = {
    "quantile", "kthvalue", "mode", "count_nonzero", "logcumsumexp",
    "renorm", "diff", "heaviside", "copysign", "deg2rad", "rad2deg",
    "nan_to_num", "ldexp", "logit", "signbit", "sgn", "isneginf",
    "isposinf", "isreal", "i0", "i0e", "i1", "i1e", "frexp", "take",
    "bucketize", "index_fill", "masked_scatter", "rot90", "unflatten",
    "expand_as", "view_as", "increment", "tensor_split", "hsplit",
    "vsplit", "dsplit", "fill_diagonal", "gammaln", "gammainc", "gammaincc",
    "polygamma", "multigammaln", "nextafter", "nanmedian",
    "bitwise_left_shift", "bitwise_right_shift", "fmax", "fmin", "reverse",
    "index_sample", "index_put", "as_strided", "tensor_unfold", "fill",
    "tensordot_impl", "inner", "pdist", "cumulative_trapezoid",
    "combinations", "diagonal_scatter", "select_scatter", "slice_scatter",
    "scatter_nd"}


def test_every_new_op_has_a_case():
    assert len(NEW_OPS) == 64
    assert NEW_OPS - {v[0] for v in CASES.values()} == set()


@pytest.mark.parametrize("case", sorted(CASES))
def test_op_matches_reference(case):
    name, args, kw, tol = CASES[case]
    check_op(name, args, kw, **tol)


@pytest.mark.parametrize("name", ["gammainc", "gammaincc"])
def test_gamma_inc_grad_with_respect_to_y(name):
    """d/dy of P(x, y) and Q(x, y) against jax.grad, float32 atol 1e-5."""
    import jax
    import jax.numpy as jnp
    x, y = pos(3, 4), pos(3, 4, seed=1)
    fn = getattr(jax.scipy.special, name)
    want = jax.grad(lambda b: fn(jnp.asarray(x), b).sum())(jnp.asarray(y))
    ty = torch.from_numpy(y).requires_grad_()
    tdisp.call_op(name, torch.from_numpy(x), ty).sum().backward()
    np.testing.assert_allclose(ty.grad.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_long_tail_functions_match_reference():
    from _torch_both import assert_both

    def fn(Q):
        x = Q.to_tensor(rnd(3, 4))
        y = Q.to_tensor(rnd(4, 5, seed=1))
        h, edges = Q.histogramdd(Q.to_tensor(rnd(20, 2)), bins=3)
        return [Q.mm(x, y), Q.tensordot(x, y, axes=1),
                Q.tensordot(Q.to_tensor(rnd(2, 3, 4)),
                            Q.to_tensor(rnd(3, 4, 2)), axes=[[1, 2],
                                                             [0, 1]]),
                Q.broadcast_shape([3, 1], [1, 4]), Q.rank(x), Q.tolist(x),
                Q.view(x, [4, 3]), Q.clone(x), Q.is_complex(x),
                Q.is_floating_point(x), Q.is_integer(x),
                Q.triu_indices(3, 4, 1), Q.floor_mod(x, 0.7), h, edges,
                Q.view(Q.to_tensor(np.arange(12, dtype=np.int16)
                                   .reshape(3, 4)), "int32").shape]
    assert_both(fn, atol=1e-5, rtol=1e-5)
