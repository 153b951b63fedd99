"""``paddle_tpu_torch.quantization`` against the JAX package's, on the
CPU: the same nets (a small conv net and ``resnet18`` at 32 x 32), the
reference's weights carried across with ``models.from_jax_state_dict``.

- QAT with the default ``QuantConfig`` (activations ``EMAObserver``,
  weights ``AbsmaxObserver``, 8 bits), two eager Momentum steps (lr 0.01,
  momentum 0.9, L2 1e-4) in train mode. The small net end to end: losses
  within rtol 1e-4, every observer's scale within rtol 1e-5. ResNet-18
  layer by layer (each quantized layer of the port's run against the
  reference's on the same input, weights and observer state: output
  within 1e-4 of its largest value, new scales within rtol 1e-6): end to
  end a float32 difference in a convolution moves an activation across a
  rounding boundary of its quantization, and the abs-max observers carry
  it from layer to layer.
- PTQ: calibration on two batches, ``convert``; the int8 weights equal
  the reference's exactly, the dequantization scales within rtol 1e-6,
  the converted net's eval logits within 1e-4.
- An observer inside a step that ``TrainStep`` or ``jit_step`` probes
  raises the reference's ``RuntimeError``, word for word.
- ``quantize(inplace=False)`` leaves the given model as it was; the
  wrapped layers are children in torch's module tree (``parameters()``,
  ``state_dict()`` under ``<name>.inner``).
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as JO
from paddle_tpu import quantization as jq
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.vision import models as jmodels
import paddle_tpu_torch
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import quantization as tq
from paddle_tpu_torch.core.device import set_device
from paddle_tpu_torch.models import from_jax_state_dict
from paddle_tpu_torch.optimizer import Momentum
from paddle_tpu_torch.vision import models as tmodels

LOSS_RTOL, SCALE_RTOL, LOGIT_TOL = 1e-4, 1e-5, 1e-4
LR, MOMENTUM, L2 = 0.01, 0.9, 1e-4


@pytest.fixture(autouse=True)
def _on_cpu():
    set_device("cpu")
    yield
    set_device(None)


def _small(nn):
    class Small(nn.Layer):
        def __init__(self):
            super().__init__()
            self.conv = nn.Conv2D(3, 8, 3, padding=1)
            self.bn = nn.BatchNorm2D(8)
            self.relu = nn.ReLU()
            self.pool = nn.MaxPool2D(2)
            self.fc = nn.Linear(8 * 16 * 16, 10)

        def forward(self, x):
            y = self.pool(self.relu(self.bn(self.conv(x))))
            return self.fc(y.reshape([y.shape[0], -1]))
    return Small()


def _pair(name):
    paddle.seed(0)
    if name == "small":
        jm, tm = _small(jnn), _small(tnn)
    else:
        jm = jmodels.resnet18(num_classes=10)
        tm = tmodels.resnet18(num_classes=10)
    from_jax_state_dict(tm, {k: np.asarray(v._data)
                             for k, v in jm.state_dict().items()})
    return jm, tm


def _batch(seed, b=4):
    rng = np.random.RandomState(seed)
    return (rng.rand(b, 3, 32, 32).astype(np.float32) - 0.5,
            rng.randint(0, 10, b).astype(np.int64))


def _scales(layers):
    return [(float(np.asarray(getattr(l.weight_quanter.scale(), "_data",
                                      l.weight_quanter.scale()))),
             float(np.asarray(getattr(l.act_quanter.scale(), "_data",
                                      l.act_quanter.scale()))))
            for l in layers]


def _jquanted(m):
    return [l for l in jq._walk(m)
            if isinstance(l, (jq.QuantedLinear, jq.QuantedConv2D))]


def _tquanted(m):
    return [l for l in m.modules()
            if isinstance(l, (tq.QuantedLinear, tq.QuantedConv2D))]


def test_qat_two_steps_track_reference():
    """The small net end to end: two eager Momentum steps, losses and every
    observer's scale."""
    from paddle_tpu.nn import functional as JF
    jm, tm = _pair("small")
    jm = jq.QAT().quantize(jm)
    tm = tq.QAT().quantize(tm)
    assert len(_jquanted(jm)) == len(_tquanted(tm)) == 2
    assert sorted(jm.state_dict()) == sorted(tm.state_dict())
    jopt = JO.Momentum(learning_rate=LR, momentum=MOMENTUM,
                       parameters=jm.parameters(), weight_decay=L2)
    topt = Momentum(learning_rate=LR, momentum=MOMENTUM,
                    parameters=tm.parameters(), weight_decay=L2)
    jl, tl = [], []
    for step in range(2):
        x, y = _batch(step)
        jloss = JF.cross_entropy(jm(Tensor(x)), Tensor(y))
        jloss.backward()
        jopt.step()
        jopt.clear_grad()
        jl.append(float(jloss.numpy()))
        tloss = torch.nn.functional.cross_entropy(tm(torch.from_numpy(x)),
                                                  torch.from_numpy(y))
        tloss.backward()
        topt.step()
        topt.clear_grad()
        tl.append(float(tloss))
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL, atol=0)
    np.testing.assert_allclose(_scales(_tquanted(tm)),
                               _scales(_jquanted(jm)), rtol=SCALE_RTOL)


def _observer_state(obs):
    v = getattr(obs, "_max", getattr(obs, "_ema", None))
    return None if v is None else v.detach().clone().numpy()


def _set_reference_state(obs, v):
    import jax.numpy as jnp
    if isinstance(obs, jq.AbsmaxObserver):
        obs._max = jnp.zeros((), jnp.float32) if v is None else \
            jnp.asarray(v)
    else:
        obs._ema = None if v is None else jnp.asarray(v)


def test_qat_resnet18_layers_track_reference_step_by_step():
    """ResNet-18 under QAT over two eager Momentum steps of the port: each
    of its 21 fake-quantized layers, at each step, against the reference's
    layer on the same input, weights and observer state (its output within
    1e-4 of the largest, both observers' new scales within rtol 1e-6).
    End to end the two nets' losses part after a few layers: a float32
    difference of a convolution's summation order (1e-7) moves one
    activation across a rounding boundary, an abs-max observer carries
    that to the next layer's step, and every activation of that layer is
    requantized on a different grid (the first loss 5.051 vs 5.297 on the
    CPU)."""
    jm, tm = _pair("resnet18")
    jm = jq.QAT().quantize(jm)
    tm = tq.QAT().quantize(tm)
    pairs = list(zip(_jquanted(jm), _tquanted(tm)))
    assert len(pairs) == 21
    seen = []

    def pre_hook(mod, args):
        seen.append([mod, args[0].detach().clone(),
                     _observer_state(mod.weight_quanter),
                     _observer_state(mod.act_quanter)])

    def post_hook(mod, args, out):
        seen[-1].append(out.detach().clone())
    hooks = [h for _, t in pairs for h in (
        t.register_forward_pre_hook(pre_hook),
        t.register_forward_hook(post_hook))]
    topt = Momentum(learning_rate=LR, momentum=MOMENTUM,
                    parameters=tm.parameters(), weight_decay=L2)
    ref_of = {id(t): j for j, t in pairs}
    import jax.numpy as jnp
    for step in range(2):
        seen.clear()
        x, y = _batch(step)
        params = {id(t): [(name, p.detach().clone()) for name, p in
                          t.inner.named_parameters()] for _, t in pairs}
        loss = torch.nn.functional.cross_entropy(tm(torch.from_numpy(x)),
                                                 torch.from_numpy(y))
        assert len(seen) == 21 and np.isfinite(float(loss))
        for t, inp, w_state, a_state, out in seen:
            j = ref_of[id(t)]
            for name, p in params[id(t)]:
                getattr(j.inner, name)._set_data(jnp.asarray(p.numpy()))
            _set_reference_state(j.weight_quanter, w_state)
            _set_reference_state(j.act_quanter, a_state)
            want = j(Tensor(inp.numpy())).numpy()
            got = out.numpy()
            assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
            np.testing.assert_allclose(
                _scales([t]), _scales([j]), rtol=1e-6)
        loss.backward()
        topt.step()
        topt.clear_grad()
    for h in hooks:
        h.remove()


@pytest.mark.parametrize("name", ["small", "resnet18"])
def test_ptq_convert_matches_reference(name):
    jm, tm = _pair(name)
    jptq, tptq = jq.PTQ(), tq.PTQ()
    jm, tm = jptq.quantize(jm), tptq.quantize(tm)
    jm.eval()
    tm.eval()
    for seed in (3, 4):
        x, _ = _batch(seed)
        jm(Tensor(x))
        with torch.no_grad():
            tm(torch.from_numpy(x))
    np.testing.assert_allclose(
        [s[1] for s in _scales(_tquanted(tm))],
        [s[1] for s in _scales(_jquanted(jm))], rtol=SCALE_RTOL)
    jptq.convert(jm)
    tptq.convert(tm)
    for jl, tl in zip(_jquanted(jm), _tquanted(tm)):
        assert tl.int8_weight.dtype == torch.int8
        np.testing.assert_array_equal(tl.int8_weight.numpy(),
                                      np.asarray(jl.int8_weight))
        np.testing.assert_allclose(tl.dequant_scale, jl.dequant_scale,
                                   rtol=1e-6)
    x, _ = _batch(5)
    want = jm(Tensor(x)).numpy()
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=LOGIT_TOL, rtol=LOGIT_TOL)


def _reference_message():
    import jax
    obs = jq.AbsmaxObserver()
    with pytest.raises(RuntimeError) as e:
        jax.jit(lambda a: obs.observe(a) or a)(jax.numpy.ones(3))
    return str(e.value)


def test_observer_raises_inside_a_captured_step():
    from paddle_tpu_torch import flags
    from paddle_tpu_torch.jit import TrainStep, jit_step
    want = _reference_message()
    _, tm = _pair("small")
    tm = tq.QAT().quantize(tm)
    opt = Momentum(learning_rate=LR, momentum=MOMENTUM,
                   parameters=tm.parameters())
    x, y = (torch.from_numpy(a) for a in _batch(0))
    step = TrainStep(tm, torch.nn.functional.cross_entropy, opt)
    flags.set_flags({"step_capture": True})
    with pytest.raises(RuntimeError) as e:
        step((x,), (y,))
    assert str(e.value) == want
    fwd = jit_step(lambda a: tm(a))
    with pytest.raises(RuntimeError) as e:
        fwd(x)
    assert str(e.value) == want
    # eagerly (capture off) the same step runs and observes
    flags.set_flags({"step_capture": False})
    try:
        loss = step((x,), (y,))
    finally:
        flags.set_flags({"step_capture": True})
    assert np.isfinite(float(loss))
    assert all(float(l.act_quanter.scale()) > 1e-6 for l in _tquanted(tm))


def test_quantize_not_inplace_leaves_the_model():
    _, tm = _pair("small")
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    q = tq.QAT().quantize(tm, inplace=False)
    assert isinstance(tm.conv, tnn.Conv2D) and isinstance(tm.fc, tnn.Linear)
    assert isinstance(q.conv, tq.QuantedConv2D)
    assert isinstance(q.fc, tq.QuantedLinear)
    assert {k.replace(".inner", "") for k in q.state_dict()} == set(before)
    ids = {id(p) for p in tm.parameters()}
    assert not ids & {id(p) for p in q.parameters()}
    q(torch.from_numpy(_batch(0)[0])).sum().backward()
    assert q.conv.inner.weight.grad is not None and tm.conv.weight.grad is None
    for k, v in tm.state_dict().items():
        assert torch.equal(v, before[k])


def test_type_config_and_functional_forms():
    cfg = tq.QuantConfig()
    cfg.add_type_config(tnn.Linear, weight=tq.FakeQuant(tq.AbsmaxObserver, 4))
    _, tm = _pair("small")
    q = tq.QAT(cfg).quantize(tm)
    assert q.fc.weight_bits == 4 and q.conv.weight_bits == 8
    x = torch.from_numpy(np.random.RandomState(0).randn(3, 5).astype(
        np.float32))
    w = torch.from_numpy(np.random.RandomState(1).randn(5, 4).astype(
        np.float32))
    got = tq.quant_linear(x, w, None, 2.0, 1.5)
    want = jq.quant_linear(Tensor(x.numpy()), Tensor(w.numpy()), None, 2.0,
                           1.5).numpy()
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    assert paddle_tpu_torch.quantization is tq
