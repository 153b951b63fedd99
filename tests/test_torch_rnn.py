"""The port's recurrences (``ops/kernels/rnn.py``: ``lstm_layer``,
``gru_layer``, ``simple_rnn_layer``) and recurrent layers (``nn/rnn.py``:
``LSTM``, ``GRU``, ``SimpleRNN`` and their cells) against the JAX
package's, on the CPU.

The ops through ``tests/_torch_op_check.py``: outputs, final states and
the grads of x, the weights, the biases and the initial states, with and
without ``lens`` and ``reverse`` (in-range reversal), float32 atol 1e-5
(the port adds the hoisted input projection in another order). The layers
built in both packages from one seed, the reference's weights loaded
through ``models.from_jax_state_dict``: 2 layers, bidirectional,
batch-major and time-major, with ``sequence_length``; outputs, final
states and every parameter grad (atol 1e-5). Also the layout against
torch's own ``nn.LSTM`` with the same weights (cuDNN's layer on the card:
the yardstick of ``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
from paddle_tpu.core.tensor import Tensor
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.core.device import set_device
from paddle_tpu_torch.models import from_jax_state_dict

from _torch_op_check import check_op

TOL = dict(atol=1e-5, rtol=1e-5)
T, B, I, H = 6, 3, 4, 5
LENS = np.array([6, 2, 4], np.int32)


@pytest.fixture(autouse=True)
def _on_cpu():
    set_device("cpu")
    yield
    set_device(None)


def _n(*shape, seed=0, scale=0.5):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _op_args(gates, with_c):
    args = [_n(T, B, I), _n(gates * H, I, seed=1), _n(gates * H, H, seed=2),
            _n(gates * H, seed=3), _n(gates * H, seed=4), _n(B, H, seed=5)]
    if with_c:
        args.append(_n(B, H, seed=6))
    return args


MODES = {"plain": (None, False), "lens": (LENS, False),
         "reverse": (None, True), "lens_reverse": (LENS, True)}


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("op", ["lstm_layer", "gru_layer", "simple_rnn_tanh",
                                "simple_rnn_relu"])
def test_recurrence_op_matches_reference(op, mode):
    lens, reverse = MODES[mode]
    kw = dict(reverse=reverse)
    if op == "lstm_layer":
        args = _op_args(4, True)
    elif op == "gru_layer":
        args = _op_args(3, False)
    else:
        args = _op_args(1, False)
        kw["activation"] = op.rsplit("_", 1)[1]
        op = "simple_rnn_layer"
    check_op(op, args + [lens], kw, **TOL)


def _pair(name, *args, **kw):
    paddle.seed(0)
    jl = getattr(jnn, name)(*args, **kw)
    tl = getattr(tnn, name)(*args, **kw)
    from_jax_state_dict(tl, {k: np.asarray(v._data)
                             for k, v in jl.state_dict().items()})
    return jl, tl


def _leaves(out):
    if isinstance(out, (list, tuple)):
        return [x for o in out for x in _leaves(o)]
    return [out]


def _run_both(jl, tl, inputs, **kw):
    """Forward both with ``inputs`` (numpy; the first one differentiated),
    backpropagate one cotangent per output; returns ``(ref, port)`` each
    ``(outputs, x grad, {param: grad})``."""
    jx = [Tensor(a, stop_gradient=i > 0 or a.dtype != np.float32)
          for i, a in enumerate(inputs)]
    tx = [torch.from_numpy(a.copy()) for a in inputs]
    tx[0].requires_grad_(True)
    jkw = {k: Tensor(v) for k, v in kw.items()}
    tkw = {k: torch.from_numpy(v.copy()) for k, v in kw.items()}
    jout, tout = _leaves(jl(*jx, **jkw)), _leaves(tl(*tx, **tkw))
    rng = np.random.RandomState(7)
    cts = [rng.randn(*o.shape).astype(np.float32) for o in jout]
    sum(((o * Tensor(c)).sum() for o, c in zip(jout, cts)),
        Tensor(np.float32(0))).backward()
    sum((o * torch.from_numpy(c)).sum() for o, c in zip(tout, cts)) \
        .backward()
    ref = ([o.numpy() for o in jout], jx[0].grad.numpy(),
           {n: p.grad.numpy() for n, p in jl.named_parameters()})
    port = ([o.detach().numpy() for o in tout], tx[0].grad.numpy(),
            {n: p.grad.numpy() for n, p in tl.named_parameters()})
    return ref, port


def _assert_same(ref, port):
    assert len(ref[0]) == len(port[0])
    for a, b in zip(port[0], ref[0]):
        np.testing.assert_allclose(a, b, **TOL)
    np.testing.assert_allclose(port[1], ref[1], **TOL)
    assert set(port[2]) == set(ref[2])
    for n in ref[2]:
        np.testing.assert_allclose(port[2][n], ref[2][n], err_msg=n, **TOL)


LAYERS = {
    "lstm_bi_2layer": ("LSTM", dict(num_layers=2, direction="bidirect")),
    "lstm_time_major": ("LSTM", dict(num_layers=2, direction="bidirect",
                                     time_major=True)),
    "gru_bi_2layer": ("GRU", dict(num_layers=2, direction="bidirect")),
    "gru_time_major": ("GRU", dict(time_major=True)),
    "simple_rnn_bi": ("SimpleRNN", dict(num_layers=2,
                                        direction="bidirectional")),
    "simple_rnn_relu": ("SimpleRNN", dict(activation="relu",
                                          time_major=True)),
}


@pytest.mark.parametrize("lengths", [False, True], ids=["full", "lengths"])
@pytest.mark.parametrize("case", sorted(LAYERS))
def test_rnn_layer_matches_reference(case, lengths):
    name, kw = LAYERS[case]
    jl, tl = _pair(name, I, H, **kw)
    shape = (T, B, I) if kw.get("time_major") else (B, T, I)
    extra = dict(sequence_length=LENS) if lengths else {}
    _assert_same(*_run_both(jl, tl, [_n(*shape, seed=9)], **extra))


@pytest.mark.parametrize("name", ["LSTMCell", "GRUCell", "SimpleRNNCell"])
@pytest.mark.parametrize("given", [False, True], ids=["zero", "states"])
def test_cell_matches_reference(name, given):
    jl, tl = _pair(name, I, H)
    x = _n(B, I, seed=11)
    if not given:
        _assert_same(*_run_both(jl, tl, [x]))
        return
    h, c = _n(B, H, seed=12), _n(B, H, seed=13)
    jst = (Tensor(h), Tensor(c)) if name == "LSTMCell" else Tensor(h)
    tst = (torch.from_numpy(h), torch.from_numpy(c)) \
        if name == "LSTMCell" else torch.from_numpy(h)
    want = _leaves(jl(Tensor(x), jst))
    got = _leaves(tl(torch.from_numpy(x), tst))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.detach().numpy(), b.numpy(), **TOL)


def test_lstm_layout_equals_torch_lstm():
    """The port's LSTM and torch's ``nn.LSTM`` over the same weights (the
    yardstick the card's smoke compares with cuDNN's)."""
    set_device("cpu")
    lstm = tnn.LSTM(I, H, num_layers=2, direction="bidirect")
    ref = torch.nn.LSTM(I, H, num_layers=2, bidirectional=True,
                        batch_first=True)
    ref.load_state_dict({k: v.detach().clone()
                         for k, v in lstm.named_parameters()})
    x = torch.from_numpy(_n(B, T, I, seed=14))
    out, (h, c) = lstm(x)
    want, (hw, cw) = ref(x)
    for a, b in ((out, want), (h, hw), (c, cw)):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


def test_lstm_inter_layer_dropout_draws_from_the_port_generator():
    from paddle_tpu_torch.nn.initializer import seed
    lstm = tnn.LSTM(I, H, num_layers=2, dropout=0.5)
    x = torch.from_numpy(_n(B, T, I, seed=15))
    state = torch.random.get_rng_state()
    seed(1)
    a = lstm(x)[0]
    seed(1)
    b = lstm(x)[0]
    c = lstm(x)[0]
    lstm.eval()
    d = lstm(x)[0]
    e = lstm(x)[0]
    assert torch.equal(torch.random.get_rng_state(), state)
    assert torch.equal(a, b) and not torch.equal(b, c)
    assert torch.equal(d, e)
