"""``paddle_tpu_torch.save`` / ``load`` (``framework``) and
``hapi.Model.save`` / ``load`` against the reference's
``paddle_tpu.framework`` (fault C13 of ROADMAP.md: files did not cross).

- a ``Linear(3, 2)`` ``.pdparams`` written by either package loads in the
  other to the same values, through ``framework.load`` and through
  ``hapi.Model.load``; ``.pdopt`` (AdamW after one step, whose state keys
  agree in both packages) the same way;
- a structure with numpy arrays, ints and strings beside tensors comes
  back as it was saved, in both loaders;
- upstream Paddle's forms load: ``(name, ndarray)`` tuples, the LoDTensor
  ``eval`` reduction and big params split under ``UnpackBigParamInfor@@``;
- ``safe_load=True`` refuses a file that asks for a foreign global, which
  a plain ``load`` (the reference's trust model) reads;
- a bfloat16 tensor is written as float32; the reference's numpy
  bfloat16 arrays load through the trusting reader only (their dtype is
  the global ``ml_dtypes.bfloat16``).
"""

import collections
import os
import pickle

import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu_torch
from paddle_tpu.hapi import Model as JModel
from paddle_tpu_torch import framework
from paddle_tpu_torch.hapi import Model


@pytest.fixture(autouse=True)
def _on_cpu():
    paddle_tpu_torch.set_device("cpu")
    yield
    paddle_tpu_torch.set_device(None)


def _ref_linear(seed=0):
    paddle_tpu.seed(seed)
    return paddle_tpu.nn.Linear(3, 2)


def _port_linear(seed=1):
    paddle_tpu_torch.seed(seed)
    return paddle_tpu_torch.nn.Linear(3, 2)


def _np(v):
    return np.asarray(v.numpy() if hasattr(v, "numpy") else v)


def _same_state(a, b):
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(_np(a[k]), _np(b[k]), err_msg=k)


X = np.linspace(-1, 1, 12, dtype=np.float32).reshape(4, 3)


def _ref_stepped():
    net = _ref_linear()
    opt = paddle_tpu.optimizer.AdamW(learning_rate=0.1,
                                     parameters=net.parameters())
    (net(paddle_tpu.to_tensor(X)) ** 2).sum().backward()
    opt.step()
    return net, opt


def _port_stepped():
    net = _port_linear()
    opt = paddle_tpu_torch.optimizer.AdamW(learning_rate=0.1,
                                           parameters=net.parameters())
    (net(paddle_tpu_torch.to_tensor(X)) ** 2).sum().backward()
    opt.step()
    return net, opt


def _same_opt_state(a, b):
    assert int(a["step"]) == int(b["step"])
    assert len(a["states"]) == len(b["states"])
    for sa, sb in zip(a["states"], b["states"]):
        assert set(sa) == set(sb)
        for k in sa:
            np.testing.assert_array_equal(_np(sa[k]), _np(sb[k]))


def test_reference_pdparams_loads_in_the_port(tmp_path):
    net = _ref_linear()
    path = str(tmp_path / "ref.pdparams")
    paddle_tpu.save(net.state_dict(), path)
    got = paddle_tpu_torch.load(path)
    assert all(isinstance(v, paddle_tpu_torch.Tensor) for v in got.values())
    _same_state(got, net.state_dict())
    arrays = framework.load(path, return_numpy=True)
    assert all(isinstance(v, np.ndarray) for v in arrays.values())
    _same_state(arrays, net.state_dict())


def test_port_pdparams_loads_in_the_reference(tmp_path):
    net = _port_linear()
    path = str(tmp_path / "port.pdparams")
    paddle_tpu_torch.save(net.state_dict(), path)
    got = paddle_tpu.load(path)
    assert all(isinstance(v, paddle_tpu.Tensor) for v in got.values())
    _same_state(got, {k: v.detach() for k, v in net.state_dict().items()})
    _same_state(paddle_tpu_torch.load(path), net.state_dict())


def test_reference_model_files_load_through_model_load(tmp_path):
    net, opt = _ref_stepped()
    jm = JModel(net)
    jm.prepare(opt, paddle_tpu.nn.MSELoss())
    base = str(tmp_path / "ref" / "ckpt")
    jm.save(base)
    assert os.path.exists(base + ".pdparams") and \
        os.path.exists(base + ".pdopt")
    pnet = _port_linear(seed=7)
    popt = paddle_tpu_torch.optimizer.AdamW(learning_rate=0.1,
                                            parameters=pnet.parameters())
    m = Model(pnet)
    m.prepare(popt, paddle_tpu_torch.nn.MSELoss())
    m.load(base)
    _same_state(pnet.state_dict(), net.state_dict())
    _same_opt_state(popt.state_dict(), opt.state_dict())


def test_port_model_files_load_through_reference_model_load(tmp_path):
    net, opt = _port_stepped()
    m = Model(net)
    m.prepare(opt, paddle_tpu_torch.nn.MSELoss())
    base = str(tmp_path / "port" / "ckpt")
    m.save(base)
    jnet = _ref_linear(seed=7)
    jopt = paddle_tpu.optimizer.AdamW(learning_rate=0.1,
                                      parameters=jnet.parameters())
    jm = JModel(jnet)
    jm.prepare(jopt, paddle_tpu.nn.MSELoss())
    jm.load(base)
    _same_state(jnet.state_dict(),
                {k: v.detach() for k, v in net.state_dict().items()})
    _same_opt_state(jopt.state_dict(), opt.state_dict())
    # and back into the port, whose Model.load reads its own files too
    pnet = _port_linear(seed=9)
    Model(pnet).load(base, reset_optimizer=True)
    _same_state(pnet.state_dict(), net.state_dict())


def test_structure_round_trips_in_both_loaders(tmp_path):
    t = paddle_tpu_torch.to_tensor(np.arange(6, dtype=np.float32)
                                   .reshape(2, 3))
    obj = {"w": t, "arr": np.arange(4), "n": 3, "name": "x",
           "nested": [t, (np.ones(2, np.float32), 2.5)]}
    path = str(tmp_path / "obj.pdparams")
    framework.save(obj, path)
    for got in (framework.load(path), paddle_tpu.load(path)):
        assert isinstance(got["arr"], np.ndarray)
        np.testing.assert_array_equal(got["arr"], np.arange(4))
        assert got["n"] == 3 and got["name"] == "x"
        np.testing.assert_array_equal(_np(got["w"]), t.numpy())
        np.testing.assert_array_equal(_np(got["nested"][0]), t.numpy())
        assert isinstance(got["nested"][1][0], np.ndarray)
    assert isinstance(framework.load(path)["w"], paddle_tpu_torch.Tensor)


class _Varbase:
    """Upstream Paddle's ``reduce_varbase``: a tensor pickles as
    ``(tuple, ((name, ndarray),))``."""

    def __init__(self, name, arr):
        self.name, self.arr = name, arr

    def __reduce__(self):
        return tuple, ((self.name, self.arr),)


class _LoD:
    """Upstream's ``reduce_LoDTensor``: ``(eval, ('data', {'data': a}))``."""

    def __init__(self, arr):
        self.arr = arr

    def __reduce__(self):
        return eval, ("data", {"data": self.arr})


@pytest.mark.parametrize("protocol", [2, 4])
def test_upstream_forms_load(tmp_path, protocol):
    rng = np.random.RandomState(0)
    w, b, big = (rng.randn(3, 2).astype(np.float32),
                 rng.randn(2).astype(np.float32),
                 rng.randn(4, 5).astype(np.float32))
    flat = big.reshape(-1)
    obj = {"linear.weight": _Varbase("linear_0.w_0", w),
           "linear.bias": _LoD(b),
           "big@@.0": flat[:12], "big@@.1": _Varbase("big", flat[12:]),
           "UnpackBigParamInfor@@": {"big": {
               "OriginShape": (4, 5), "slices": ["big@@.0", "big@@.1"]}}}
    path = str(tmp_path / "upstream.pdparams")
    with open(path, "wb") as f:
        pickle.dump(obj, f, protocol=protocol)
    got = paddle_tpu_torch.load(path)
    assert set(got) == {"linear.weight", "linear.bias", "big"}
    assert got["linear.weight"].name == "linear_0.w_0"
    for k, want in (("linear.weight", w), ("linear.bias", b), ("big", big)):
        assert isinstance(got[k], paddle_tpu_torch.Tensor)
        np.testing.assert_array_equal(got[k].numpy(), want)
        np.testing.assert_array_equal(
            _np(paddle_tpu.load(path)[k]), want)
    arrays = paddle_tpu_torch.load(path, return_numpy=True)
    np.testing.assert_array_equal(arrays["big"], big)


def test_safe_load_refuses_a_foreign_global(tmp_path):
    path = str(tmp_path / "foreign.pdparams")
    with open(path, "wb") as f:
        pickle.dump({"w": np.ones(2), "c": collections.Counter("ab")}, f)
    with pytest.raises(pickle.UnpicklingError, match="disallowed global"):
        paddle_tpu_torch.load(path, safe_load=True)
    with pytest.raises(pickle.UnpicklingError, match="disallowed global"):
        paddle_tpu.load(path, safe_load=True)
    got = paddle_tpu_torch.load(path)
    assert got["c"] == collections.Counter("ab")


def test_eval_reduction_refuses_other_expressions(tmp_path):
    class Evil:
        def __reduce__(self):
            return eval, ("1 + 1",)
    path = str(tmp_path / "evil.pdparams")
    with open(path, "wb") as f:
        pickle.dump(Evil(), f)
    with pytest.raises(pickle.UnpicklingError, match="refusing eval"):
        paddle_tpu_torch.load(path)


def test_bfloat16_is_written_as_float32(tmp_path):
    t = torch.tensor([1.5, -2.25, 3.0], dtype=torch.bfloat16)
    path = str(tmp_path / "bf16.pdparams")
    paddle_tpu_torch.save({"t": t}, path)
    got = paddle_tpu_torch.load(path, return_numpy=True)["t"]
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, t.float().numpy())
    ref = paddle_tpu.load(path)["t"]
    np.testing.assert_array_equal(_np(ref), t.float().numpy())


def test_reference_bfloat16_file_needs_the_trusting_reader(tmp_path):
    # the reference writes numpy bfloat16 (its dtype pickles as the global
    # ml_dtypes.bfloat16): read through the fallback, refused by safe_load
    pytest.importorskip("ml_dtypes")
    x = paddle_tpu.to_tensor(np.float32([1.5, -2.0, 0.25])).astype(
        "bfloat16")
    path = str(tmp_path / "ref_bf16.pdparams")
    paddle_tpu.save({"x": x}, path)
    got = paddle_tpu_torch.load(path)["x"]
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), [1.5, -2.0, 0.25])
    with pytest.raises(pickle.UnpicklingError, match="ml_dtypes"):
        paddle_tpu_torch.load(path, safe_load=True)
