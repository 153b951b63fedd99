"""The port's ``Tensor`` class against the JAX package's.

``paddle_tpu_torch.Tensor`` is a ``torch.Tensor`` subclass with Paddle's
surface. Held to the reference through the same user code on the same
numpy inputs (``tests/_torch_both.py``), float32 exact unless stated:

- ``to_tensor`` (lists, numpy arrays, scalars, ``dtype=``, float64 to the
  default dtype), ``Tensor(data)``, ``is_tensor``;
- the properties (``shape`` a list, ``size`` the element count, ``ndim``,
  ``dtype`` names, ``T``, ``stop_gradient``, ``is_leaf``,
  ``inplace_version``, ``name``, ``persistable``, ``place``);
- the conversions (``numpy()``, ``item()``, ``tolist()``, ``astype`` /
  ``cast``, ``to(...)``, ``clone``, ``detach``; bfloat16 ``numpy()`` widens
  to float32 in the port: a deliberate difference);
- ``__getitem__`` forms, ``__setitem__`` and its guard;
- the dunders and their promotion (the result dtypes' kinds agree; the
  port's ints are int64 where the reference's are int32);
- the dtypes (``set_default_dtype``, ``iinfo`` / ``finfo``) and Places.

Torch's own Python code never sees a ``Tensor``: ``__torch_function__``
unwraps it, so ``F.batch_norm`` (which calls ``input.size()``) runs.
"""

import copy
import pickle

import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu_torch
from _torch_both import assert_both, run_both

P = paddle_tpu_torch


@pytest.fixture(autouse=True)
def _cpu():
    prev = P.get_device()
    P.set_device("cpu")
    yield
    P.set_device(prev)


def rnd(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def dname(dt):
    return str(np.dtype(dt)) if not isinstance(dt, torch.dtype) else \
        str(dt).replace("torch.", "")


def test_to_tensor_forms_match_reference():
    def fn(Q):
        outs = [Q.to_tensor([1.5, 2.0]), Q.to_tensor(3.0),
                Q.to_tensor(np.arange(6, dtype=np.float64).reshape(2, 3)),
                Q.to_tensor([[1, 2], [3, 4]], dtype="float32"),
                Q.to_tensor([True, False]), Q.to_tensor(rnd(2, 2))]
        return [(o, dname(o.dtype), o.stop_gradient, list(o.shape))
                for o in outs]
    ref, port = run_both(fn)
    for (pv, pd, ps, psh), (rv, rd, rs, rsh) in zip(port, ref):
        np.testing.assert_array_equal(pv, rv)
        assert (pd, ps, psh) == (rd, rs, rsh)


def test_to_tensor_copies_and_ints_are_int64():
    a = np.array([1, 2, 3])
    t = P.to_tensor(a)
    a[0] = 9
    assert t.tolist() == [1, 2, 3] and t.dtype == P.int64
    s = torch.ones(2)
    u = P.to_tensor(s, stop_gradient=False)
    s.add_(1)
    assert u.tolist() == [1.0, 1.0] and u.is_leaf and not u.stop_gradient
    assert isinstance(P.Tensor([1.0, 2.0]), P.Tensor)
    assert P.is_tensor(u) and P.is_tensor(s) and not P.is_tensor(a)


def test_properties_match_reference():
    def fn(Q):
        x = Q.to_tensor(rnd(2, 3, 4), stop_gradient=False)
        y = x * 2.0
        return dict(shape=x.shape, size=x.size, ndim=x.ndim,
                    dtype=dname(x.dtype), T=x.T, Tshape=x.T.shape,
                    sg=(x.stop_gradient, y.stop_gradient),
                    leaf=(x.is_leaf, y.is_leaf), version=x.inplace_version,
                    name=x.name, persistable=x.persistable, len=len(x))
    assert_both(fn)


def test_place_and_places():
    x = P.to_tensor([1.0])
    assert x.place == P.CPUPlace() and x.place.is_cpu_place()
    assert repr(P.CUDAPlace(1)) == "Place(gpu:1)"
    assert P.CUDAPlace(0).is_gpu_place() and P.CUDAPlace(0) != P.CPUPlace()
    assert P.CUDAPinnedPlace().is_cuda_pinned_place()
    P.set_device(P.CPUPlace())
    assert P.zeros([1]).place == P.CPUPlace()
    assert P.device_count() == torch.cuda.device_count()
    assert P.is_compiled_with_cuda() == torch.cuda.is_available()


def test_conversions_match_reference():
    def fn(Q):
        x = Q.to_tensor(rnd(2, 3))
        return [x.numpy(), x[0, 1].item(), x.tolist(), x.astype("int32"),
                x.cast("float64"), x.to("cpu"), x.clone(),
                x.detach(), Q.to_tensor(2.5).item(), float(x[1, 2]),
                int(Q.to_tensor(7)), bool(Q.to_tensor(1.0))]
    assert_both(fn)


def test_numpy_reads_a_copy_and_widens_bfloat16():
    x = P.to_tensor([1.5, 2.25], dtype="bfloat16")
    a = x.numpy()
    assert a.dtype == np.float32 and a.tolist() == [1.5, 2.25]
    a[0] = 0
    assert x.tolist() == [1.5, 2.25]
    y = P.to_tensor([1.0], stop_gradient=False) * 3.0
    assert y.numpy().tolist() == [3.0]          # no detach() needed
    z = P.to_tensor([1.0, 2.0])
    assert z.to("float64").dtype == P.float64
    assert z.to(P.CPUPlace(), "int32").dtype == P.int32
    assert z.to(device="cpu", dtype=P.float16).dtype == P.float16


def test_getitem_forms_match_reference():
    def fn(Q):
        x = Q.to_tensor(np.arange(24, dtype=np.float32).reshape(2, 3, 4))
        return [x[1], x[:, 1:3], x[..., ::2], x[0, :, -1], x[:, ::-1],
                x[Q.to_tensor(np.array([1, 0]))], x[x > 10.0],
                x[None, 0].shape]
    assert_both(fn)


def test_setitem_matches_reference_and_guards_nonleaf():
    def fn(Q):
        x = Q.to_tensor(np.zeros((3, 4), np.float32))
        x[1] = 5.0
        x[:, 2] = Q.to_tensor(np.array([1.0, 2.0, 3.0], np.float32))
        x[0, 0] = np.float32(7.0)
        w = Q.to_tensor([1.0, 2.0], stop_gradient=False)
        w[0] = 4.0                      # a leaf: allowed, grad unchanged
        return [x, x.inplace_version, w, w.stop_gradient]
    assert_both(fn)
    for Q in (paddle_tpu, P):
        y = Q.to_tensor([1.0, 2.0], stop_gradient=False) * 2.0
        with pytest.raises(RuntimeError, match="non-leaf"):
            y[0] = 1.0


# C12: slices with a negative step, alone and beside other index forms
NEGATIVE_STEP_WRITES = {
    "rows_by_minus_two": ((6, 2), lambda Q: (slice(None, None, -2),),
                          lambda Q: Q.zeros([3, 2])),
    "int_then_reversed": ((3, 10), lambda Q: (1, slice(None, None, -2)),
                          lambda Q: Q.to_tensor(np.arange(5, dtype=np.float32)
                                                + 100)),
    "from_the_end": ((6, 5), lambda Q: (slice(-1, -7, -2),),
                     lambda Q: Q.to_tensor(np.arange(15, dtype=np.float32)
                                           .reshape(3, 5))),
    "both_axes_scalar": ((4, 5), lambda Q: (slice(None, None, -1),
                                            slice(3, 0, -2)),
                         lambda Q: 9.0),
    "ellipsis_and_broadcast": ((2, 3, 4), lambda Q: (Ellipsis,
                                                     slice(2, None, -1)),
                               lambda Q: Q.to_tensor(np.float32([1, 2, 3]))),
}


@pytest.mark.parametrize("case", sorted(NEGATIVE_STEP_WRITES))
def test_setitem_negative_step_matches_reference(case):
    shape, index, value = NEGATIVE_STEP_WRITES[case]

    def fn(Q):
        x = Q.to_tensor(np.arange(np.prod(shape), dtype=np.float32)
                        .reshape(shape))
        x[index(Q)] = value(Q)
        return x
    assert_both(fn)


def test_setitem_negative_step_keeps_the_nonleaf_guard():
    y = P.to_tensor([1.0, 2.0, 3.0], stop_gradient=False) * 2.0
    with pytest.raises(RuntimeError, match="non-leaf"):
        y[::-2] = 0.0


OPERANDS = {
    "f32": lambda Q: Q.to_tensor(np.float32([[1.5, -2.0], [3.0, 0.5]])),
    "i32": lambda Q: Q.to_tensor(np.int32([[3, -2], [5, 7]])),
    "bool": lambda Q: Q.to_tensor(np.array([[True, False], [True, True]])),
    "int": lambda Q: 2,
    "float": lambda Q: 0.5,
}
ARITH = ["+", "-", "*", "/", "**", "//", "%"]
COMPARE = ["==", "!=", "<", "<=", ">", ">="]
PAIRS = [("f32", "f32"), ("f32", "int"), ("f32", "float"), ("i32", "float"),
         ("i32", "i32"), ("int", "f32"), ("float", "i32"), ("i32", "f32")]


# the reference has no reflected // and %: a Python number first there
CASES = [(op, a, b) for op in ARITH + COMPARE for a, b in PAIRS
         if not (op in ("//", "%") and a in ("int", "float"))] + [
             ("@", "f32", "f32")]


@pytest.mark.parametrize("op,a,b", CASES,
                         ids=[f"{a}{op}{b}" for op, a, b in CASES])
def test_dunders_and_promotion_match_reference(op, a, b):
    def fn(Q):
        x, y = OPERANDS[a](Q), OPERANDS[b](Q)
        out = eval(f"x {op} y")
        return [out, np.asarray(out).dtype.kind if not isinstance(
            out, (int, float)) else type(out).__name__]
    ref, port = run_both(fn)
    np.testing.assert_allclose(np.asarray(port[0], np.float64),
                               np.asarray(ref[0], np.float64), rtol=1e-6,
                               atol=1e-6)
    assert port[1] == ref[1] or {port[1], ref[1]} <= {"i", "u"}


@pytest.mark.parametrize("op", ["&", "|", "^"])
def test_bitwise_dunders_match_reference(op):
    def fn(Q):
        x, y = OPERANDS["bool"](Q), Q.to_tensor(np.array([[False, True],
                                                         [True, False]]))
        i, j = OPERANDS["i32"](Q), Q.to_tensor(np.int32([[1, 6], [4, 2]]))
        return [eval(f"x {op} y"), eval(f"i {op} j"), ~x, -i, abs(i)]
    assert_both(fn)


def test_dunder_results_are_tensors_and_keep_autograd():
    x = P.to_tensor([2.0], stop_gradient=False)
    for y in (x + 1, 1 - x, x * x, 2.0 / x, x ** 2, 3 ** x, -x, abs(x),
              np.float32(2.0) * x, x @ x):
        assert isinstance(y, P.Tensor) and not y.stop_gradient
    assert isinstance(x == 2.0, P.Tensor) and (x == 2.0).dtype == P.bool
    assert hash(x) == id(x) and x in {x: 1}


def test_dtypes_match_reference():
    for n in ("float32", "bfloat16", "float16", "float64", "int8", "int16",
              "int32", "int64", "uint8", "complex64"):
        assert getattr(P, n) is getattr(torch, n)
    assert P.bool is torch.bool
    for dt in ("int8", "int16", "int32", "uint8"):
        r, p = paddle_tpu.iinfo(dt), P.iinfo(dt)
        assert (p.bits, p.min, p.max) == (r.bits, int(r.min), int(r.max))
    for dt in ("float32", "bfloat16", "float16"):
        r, p = paddle_tpu.finfo(dt), P.finfo(dt)
        assert (p.bits, p.eps, p.max, p.tiny) == (
            r.bits, float(r.eps), float(r.max), float(r.tiny))
    assert P.get_default_dtype() == P.float32
    P.set_default_dtype("float64")
    try:
        assert P.to_tensor(1.5).dtype == P.float64
        assert P.rand([2]).dtype == P.float64
    finally:
        P.set_default_dtype("float32")
    with pytest.raises(ValueError):
        P.set_default_dtype("int32")


def test_torch_code_never_sees_a_tensor():
    x = P.to_tensor(rnd(4, 3, 5, 5))
    out = torch.nn.functional.batch_norm(x, None, None, training=True)
    assert isinstance(out, P.Tensor) and out.shape == [4, 3, 5, 5]
    assert isinstance(torch.stack([x, x]), P.Tensor)
    parts = torch.split(x, 2)              # torch's meaning via torch's API
    assert [p.shape for p in parts] == [[2, 3, 5, 5]] * 2
    y = x.contiguous()
    assert y is x or isinstance(y, P.Tensor)
    assert x.mul_(1.0) is x                # torch's inplace method: self


def test_stop_gradient_on_a_nonleaf_view_cuts_the_graph():
    x = P.to_tensor([1.0, 2.0, 3.0], stop_gradient=False)
    v = (x * 2.0)[1:]
    v.stop_gradient = True
    assert v.stop_gradient and v.is_leaf
    w = P.to_tensor([1.0, 1.0], stop_gradient=False)
    (v * w).sum().backward()
    assert x.grad is None and w.grad.tolist() == [4.0, 6.0]


def test_deepcopy_pickle_and_repr():
    x = P.to_tensor([1.0, 2.0], stop_gradient=False)
    x.name = "w"
    y = copy.deepcopy(x)
    assert isinstance(y, P.Tensor) and y.name == "w" and not y.stop_gradient
    z = pickle.loads(pickle.dumps(x))
    assert isinstance(z, P.Tensor) and z.tolist() == [1.0, 2.0]
    assert "shape=[2]" in repr(x) and "stop_gradient=False" in repr(x)


def test_parameter_paddle_properties():
    lin = P.nn.Linear(3, 2)
    w = lin.weight
    assert w.shape == torch.Size([3, 2])     # torch's meaning on a Parameter
    assert not w.stop_gradient and w.place == P.CPUPlace()
    w.name = "fc.w"
    assert w.name == "fc.w" and w.persistable
    v0 = w.inplace_version
    w.set_value(np.ones((3, 2), np.float32))
    assert w.inplace_version == v0 + 1 and w.numpy().sum() == 6.0
    lin(P.to_tensor(rnd(4, 3))).sum().backward()
    assert w.grad is not None
    w.clear_gradient()
    assert w.grad is None
    w.stop_gradient = True
    assert not w.requires_grad
