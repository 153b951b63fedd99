"""The port's layer surface (``paddle_tpu_torch.nn``: ``Layer``, the
layers of ``nn/layers_common.py``, the initializers) against the JAX
package's (``paddle_tpu.nn``), on the CPU.

Each layer is built in both packages with the same arguments; the
reference's ``state_dict`` (numpy) loads into the port's layer through
``models.from_jax_state_dict``, which also checks that the names, shapes
and dtypes (buffers included: BatchNorm's ``_mean`` / ``_variance``) are
the reference's. Both run the same input (numpy, seeded) and backpropagate
the same cotangent. Held to the reference, float32: the output atol 1e-5
and rtol 1e-5 (sums and convolutions add in another order); the input
grad and every parameter grad within 1e-4 of the tensor's max.

Also: BatchNorm's running statistics after two training steps and its
eval output; ``Embedding(padding_idx)``'s zero grad row; ``Dropout`` in
eval, at p 0, its keep rate and scale, its mask reproduced by its
generator and torch's global generator untouched; the containers;
the ``Layer`` API (``state_dict`` names, ``set_state_dict``, the forward
pre/post hooks, ``create_parameter``, ``named_sublayers``,
``LazyGuard``, ``astype``) and torch's callers over a ``Layer``
(``functional_call``, a captured ``TrainStep``); each initializer's shape,
dtype, fan and moments against the reference's draws (the bits cannot
match JAX's threefry: the means within 6 standard errors, the standard
deviations within 3%, the bounds of the uniform and truncated draws).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.nn import initializer as JI
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.core.device import set_device
from paddle_tpu_torch.models import from_jax_state_dict
from paddle_tpu_torch.nn import initializer as TI

ATOL = RTOL = 1e-5
GRAD_REL = 1e-4


@pytest.fixture(autouse=True)
def _on_cpu():
    set_device("cpu")
    yield
    set_device(None)


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _rel(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


class _RefCeilPool(jnn.Layer):
    """The reference's pooling with ``ceil_mode``: its ``pool2d`` op (its
    ``max_pool2d`` / ``avg_pool2d`` ops ignore ``ceil_mode``)."""

    def __init__(self, name, kernel_size, stride, padding, ceil_mode=True,
                 exclusive=True):
        super().__init__()
        self.kw = dict(kernel_size=(kernel_size,) * 2, strides=(stride,) * 2,
                       paddings=(padding,) * 2, ceil_mode=ceil_mode,
                       exclusive=exclusive,
                       pooling_type="max" if name == "MaxPool2D" else "avg")

    def forward(self, x):
        from paddle_tpu.ops.dispatcher import call_op
        return call_op("pool2d", x, **self.kw)


def _pair(name, *args, **kw):
    paddle.seed(0)
    jl = _RefCeilPool(name, *args, **kw) if kw.get("ceil_mode") \
        else getattr(jnn, name)(*args, **kw)
    tl = getattr(tnn, name)(*args, **kw)
    from_jax_state_dict(tl, {k: np.asarray(v._data)
                             for k, v in jl.state_dict().items()})
    return jl, tl


def _run(jl, tl, x, seed=1):
    """Forward and backward in both packages; returns (ref, port) each
    ``(out, x grad or None, {param: grad})``."""
    floating = np.issubdtype(x.dtype, np.floating)
    jx = Tensor(x, stop_gradient=not floating)
    jout = jl(jx)
    ct = np.random.RandomState(seed).randn(*jout.shape).astype(np.float32)
    (jout * Tensor(ct)).sum().backward()
    ref = (_np(jout._data), _np(jx.grad._data) if floating else None,
           {n: _np(p.grad._data) for n, p in jl.named_parameters()})
    tx = torch.from_numpy(x.copy()).requires_grad_(floating)
    tout = tl(tx)
    (tout * torch.from_numpy(ct)).sum().backward()
    port = (tout.detach().numpy(), tx.grad.numpy() if floating else None,
            {n: p.grad.numpy() for n, p in tl.named_parameters()})
    return ref, port


def _assert_match(ref, port):
    np.testing.assert_allclose(port[0], ref[0], atol=ATOL, rtol=RTOL)
    if ref[1] is not None:
        assert _rel(port[1], ref[1]) <= GRAD_REL
    assert set(port[2]) == set(ref[2])
    for n in ref[2]:
        assert _rel(port[2][n], ref[2][n]) <= GRAD_REL, n


def _x(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


CASES = {
    "identity": (("Identity",), {}, (3, 4)),
    "linear": (("Linear", 6, 5), {}, (3, 6)),
    "linear_3d": (("Linear", 6, 5), {}, (2, 3, 6)),
    "linear_no_bias": (("Linear", 6, 5), dict(bias_attr=False), (3, 6)),
    "conv1d": (("Conv1D", 3, 4, 3), dict(stride=2, padding=1), (2, 3, 11)),
    "conv2d": (("Conv2D", 3, 4, 3), dict(padding=1), (2, 3, 7, 7)),
    "conv2d_strided_asym": (("Conv2D", 4, 6, 3),
                            dict(stride=2, padding=[1, 2, 0, 1]),
                            (2, 4, 9, 8)),
    "conv2d_groups_dilation": (("Conv2D", 4, 6, 3),
                               dict(groups=2, dilation=2, padding=2),
                               (2, 4, 9, 9)),
    "conv2d_same": (("Conv2D", 3, 4, 3), dict(stride=2, padding="SAME"),
                    (2, 3, 8, 7)),
    "conv2d_nhwc": (("Conv2D", 3, 4, 3), dict(padding=1,
                                              data_format="NHWC"),
                    (2, 6, 6, 3)),
    "conv2d_transpose": (("Conv2DTranspose", 4, 3, 3),
                         dict(stride=2, padding=1, output_padding=1),
                         (2, 4, 5, 5)),
    "conv2d_transpose_groups": (("Conv2DTranspose", 4, 6, 3),
                                dict(stride=2, padding=1, groups=2),
                                (2, 4, 5, 5)),
    "layer_norm": (("LayerNorm", 6), {}, (3, 4, 6)),
    "layer_norm_2d": (("LayerNorm", [4, 6]), {}, (3, 4, 6)),
    "rms_norm": (("RMSNorm", 6), {}, (3, 4, 6)),
    "batch_norm1d": (("BatchNorm1D", 4), {}, (6, 4)),
    "batch_norm1d_ncl": (("BatchNorm1D", 4), {}, (3, 4, 7)),
    "batch_norm2d": (("BatchNorm2D", 3), {}, (4, 3, 5, 5)),
    "batch_norm2d_nhwc": (("BatchNorm2D", 3), dict(data_format="NHWC"),
                          (4, 5, 5, 3)),
    "batch_norm3d": (("BatchNorm3D", 2), {}, (2, 2, 3, 3, 3)),
    "group_norm": (("GroupNorm", 2, 4), {}, (3, 4, 5, 5)),
    "instance_norm": (("InstanceNorm2D", 3), {}, (2, 3, 6, 6)),
    "leaky_relu": (("LeakyReLU", 0.1), {}, (3, 7)),
    "prelu": (("PReLU",), {}, (3, 7)),
    "prelu_channels": (("PReLU", 3), dict(init=0.1), (2, 3, 4)),
    "gelu_tanh": (("GELU",), dict(approximate=True), (3, 7)),
    "softmax_axis0": (("Softmax",), dict(axis=0), (3, 7)),
    "max_pool": (("MaxPool2D", 2), {}, (2, 3, 8, 8)),
    "max_pool_padded": (("MaxPool2D", 3), dict(stride=2, padding=1),
                        (2, 3, 7, 7)),
    "avg_pool": (("AvgPool2D", 2), {}, (2, 3, 8, 8)),
    "avg_pool_exclusive": (("AvgPool2D", 3), dict(stride=2, padding=1),
                           (2, 3, 7, 7)),
    "avg_pool_inclusive": (("AvgPool2D", 3),
                           dict(stride=2, padding=1, exclusive=False),
                           (2, 3, 7, 7)),
    # ceil mode (C5): held to the reference's pool2d op
    **{f"{kind}_pool_ceil_p{pad}": (
        ("MaxPool2D" if kind == "max" else "AvgPool2D", 3),
        dict(stride=2, padding=pad, ceil_mode=True,
             **({} if kind == "max" else
                {"exclusive": kind == "avg_exclusive"})), (2, 3, 8, 8))
       for kind in ("max", "avg_exclusive", "avg_inclusive")
       for pad in (0, 1)},
    "adaptive_avg_uniform": (("AdaptiveAvgPool2D", 2), {}, (2, 3, 8, 8)),
    "adaptive_avg_bins": (("AdaptiveAvgPool2D", 3), {}, (2, 3, 7, 8)),
    "adaptive_max_bins": (("AdaptiveMaxPool2D", (3, 2)), {}, (2, 3, 7, 5)),
    "flatten": (("Flatten",), {}, (2, 3, 4, 5)),
    "upsample_nearest": (("Upsample",), dict(scale_factor=2), (2, 3, 4, 5)),
    "upsample_bilinear": (("Upsample",), dict(size=(7, 9),
                                              mode="bilinear"),
                          (2, 3, 4, 5)),
    "upsample_aligned": (("Upsample",), dict(scale_factor=2,
                                             mode="bilinear",
                                             align_corners=True),
                         (2, 3, 4, 5)),
    "pad_constant": (("Pad2D", 1), dict(value=0.5), (2, 3, 4, 5)),
    "pad_reflect": (("Pad2D", [1, 2, 0, 1]), dict(mode="reflect"),
                    (2, 3, 4, 5)),
    "pad_replicate": (("Pad2D", [2, 0, 1, 1]), dict(mode="replicate"),
                      (2, 3, 4, 5)),
    "pixel_shuffle": (("PixelShuffle", 2), {}, (2, 8, 3, 3)),
}
ACTIVATIONS = ["ReLU", "ReLU6", "GELU", "SiLU", "Swish", "Mish", "Sigmoid",
               "Tanh", "Softplus", "Softsign", "Hardswish", "Hardsigmoid",
               "ELU", "SELU", "LogSigmoid", "LogSoftmax", "Softmax"]


@pytest.mark.parametrize("case", sorted(CASES))
def test_layer_matches_reference(case):
    args, kw, shape = CASES[case]
    jl, tl = _pair(*args, **kw)
    _assert_match(*_run(jl, tl, _x(*shape)))


@pytest.mark.parametrize("name", ACTIVATIONS)
def test_activation_matches_reference(name):
    jl, tl = _pair(name)
    x = _x(3, 7) * 3.0
    _assert_match(*_run(jl, tl, x))


def test_embedding_padding_idx_matches_and_its_row_takes_no_grad():
    jl, tl = _pair("Embedding", 10, 4, padding_idx=2)
    ids = np.array([[1, 2, 3], [2, 9, 0]], np.int64)
    ref, port = _run(jl, tl, ids)
    _assert_match(ref, port)
    assert not port[2]["weight"][2].any()
    assert not port[0][0, 1].any() and not port[0][1, 0].any()


def test_batch_norm_running_statistics_train_and_eval():
    jl, tl = _pair("BatchNorm2D", 3, momentum=0.8)
    for seed in range(2):
        x = _x(4, 3, 5, 5, seed=seed) * (seed + 1) + seed
        np.testing.assert_allclose(
            tl(torch.from_numpy(x)).detach().numpy(),
            _np(jl(Tensor(x))._data), atol=ATOL, rtol=RTOL)
    for name in ("_mean", "_variance"):
        np.testing.assert_allclose(getattr(tl, name).numpy(),
                                   _np(getattr(jl, name)._data),
                                   atol=1e-6, rtol=1e-6)
    # Paddle's momentum keeps 0.8 of the old value; the variance is the
    # biased batch variance
    x0 = _x(4, 3, 5, 5, seed=0)
    x1 = _x(4, 3, 5, 5, seed=1) * 2 + 1
    want = 0.8 * (0.8 * 1.0 + 0.2 * x0.var(axis=(0, 2, 3))) \
        + 0.2 * x1.var(axis=(0, 2, 3))
    np.testing.assert_allclose(tl._variance.numpy(), want, rtol=1e-5)
    jl.eval()
    tl.eval()
    _assert_match(*_run(jl, tl, _x(2, 3, 5, 5, seed=5)))


def test_dropout_modes_and_generator():
    x = np.ones((200, 100), np.float32)
    jl, tl = _pair("Dropout", 0.3)
    jl.eval()
    tl.eval()
    _assert_match(*_run(jl, tl, x))
    tl.train()
    torch_state = torch.get_rng_state()
    out = tl(torch.from_numpy(x))
    kept = (out != 0).float()
    assert abs(float(kept.mean()) - 0.7) < 0.01
    assert torch.allclose(out[out != 0], torch.tensor(1 / 0.7))
    assert torch.equal(torch.get_rng_state(), torch_state)
    gen = torch.Generator().manual_seed(4)
    a = tnn.Dropout(0.5, generator=gen)(torch.from_numpy(x))
    gen.manual_seed(4)
    b = tnn.Dropout(0.5, generator=gen)(torch.from_numpy(x))
    assert torch.equal(a, b)
    d = tnn.Dropout(0.5, axis=1, mode="downscale_in_infer",
                    generator=gen)(torch.from_numpy(x))
    assert torch.equal(d, d[:1].expand_as(d))        # one mask per column
    assert set(d.unique().tolist()) <= {0.0, 1.0}
    zero = tnn.Dropout(0.0)
    assert torch.equal(zero(torch.from_numpy(x)), torch.from_numpy(x))


def test_sequential_and_state_dict_names_equal_the_reference():
    def build(n):
        # no conv bias: BatchNorm cancels it, its true grad is zero
        return n.Sequential(n.Conv2D(3, 4, 3, padding=1, bias_attr=False),
                            n.BatchNorm2D(4),
                            n.ReLU(), n.MaxPool2D(2), n.Flatten(),
                            n.Linear(64, 5))
    paddle.seed(0)
    jl, tl = build(jnn), build(tnn)
    assert sorted(jl.state_dict()) == sorted(tl.state_dict())
    from_jax_state_dict(tl, {k: np.asarray(v._data)
                             for k, v in jl.state_dict().items()})
    _assert_match(*_run(jl, tl, _x(2, 3, 8, 8)))
    assert [n for n, _ in jl.named_sublayers()] == \
        [n for n, _ in tl.named_sublayers()]
    assert len(tl) == 6 and isinstance(tl[3], tnn.MaxPool2D)


def test_layer_list_and_parameter_list():
    ll = tnn.LayerList([tnn.Linear(2, 2)])
    ll.append(tnn.ReLU()).extend([tnn.Linear(2, 3)])
    assert len(ll) == 3 and isinstance(ll[-1], tnn.Linear)
    assert [type(m).__name__ for m in ll[:2]] == ["Linear", "Relu"]
    assert sorted(ll.state_dict()) == ["0.bias", "0.weight", "2.bias",
                                       "2.weight"]
    pl = tnn.ParameterList([tnn.Parameter(torch.zeros(2))])
    pl.append(tnn.Parameter(torch.ones(3)))
    assert len(pl) == 2 and pl[-1].shape == (3,)
    assert [n for n, _ in pl.named_parameters()] == ["0", "1"]


def test_set_state_dict_and_hooks_as_the_reference():
    paddle.seed(0)
    jl = jnn.Linear(3, 2)
    tl = tnn.Linear(3, 2)
    missing, unexpected = tl.set_state_dict(
        {"weight": np.asarray(jl.weight._data), "extra": np.zeros(1)})
    assert missing == ["bias"] and unexpected == ["extra"]
    with pytest.raises(ValueError, match="shape mismatch"):
        tl.set_state_dict({"bias": np.zeros(3, np.float32)})
    tl.load_dict({"bias": np.asarray(jl.bias._data)})
    x = np.ones((1, 3), np.float32)
    outs = []
    for layer, wrap in ((jl, Tensor), (tl, torch.from_numpy)):
        pre = layer.register_forward_pre_hook(lambda m, inp: (inp[0] * 2,))
        post = layer.register_forward_post_hook(
            lambda m, inp, out: out + 1)
        outs.append(_np(layer(wrap(x)).detach()
                        if isinstance(layer, torch.nn.Module)
                        else layer(wrap(x))._data))
        pre.remove()
        post.remove()
        outs.append(_np(layer(wrap(x)).detach()
                        if isinstance(layer, torch.nn.Module)
                        else layer(wrap(x))._data))
    np.testing.assert_allclose(outs[2], outs[0], atol=ATOL)
    np.testing.assert_allclose(outs[3], outs[1], atol=ATOL)


def test_create_parameter_and_the_torch_signatures():
    layer = tnn.Layer()
    w = layer.create_parameter((3, 4))
    b = layer.create_parameter((4,), is_bias=True)
    frozen = layer.create_parameter(
        (2,), attr=tnn.ParamAttr(initializer=TI.Constant(3.0),
                                 trainable=False))
    assert layer.create_parameter((2,), attr=False) is None
    layer.add_parameter("w", w)
    layer.add_parameter("b", b)
    layer.add_parameter("frozen", frozen)
    assert w.dtype == torch.float32 and w.trainable and not frozen.trainable
    assert torch.equal(b, torch.zeros(4))
    assert torch.equal(frozen, torch.full((2,), 3.0))
    sub = layer.add_sublayer("fc", tnn.Linear(4, 2))
    assert [n for n, _ in layer.named_parameters(include_sublayers=False)] \
        == ["w", "b", "frozen"]
    assert len(layer.parameters()) == 5
    assert layer.sublayers() == [sub]
    assert layer.sublayers(include_self=True)[0] is layer
    assert sorted(layer.state_dict(include_sublayers=False)) == \
        ["b", "frozen", "w"]
    assert "fc.weight" in layer.state_dict(keep_vars=True)
    assert layer.astype("bfloat16").w.dtype == torch.bfloat16
    layer.to(dtype="float32")
    assert sub.weight.dtype == torch.float32


def test_lazy_guard_materializes_into_the_same_parameters():
    from paddle_tpu_torch.optimizer import SGD
    with tnn.LazyGuard():
        net = tnn.Sequential(tnn.Linear(4, 3), tnn.ReLU(), tnn.Linear(3, 2))
    params = net.parameters()
    assert all(p.device.type == "meta" for p in params)
    opt = SGD(learning_rate=0.1, parameters=params)
    out = net(torch.ones(2, 4))
    assert all(p.device.type == "cpu" for p in net.parameters())
    assert all(a is b for a, b in zip(params, net.parameters()))
    out.sum().backward()
    before = net[0].weight.detach().clone()
    opt.step()
    assert not torch.equal(before, net[0].weight)


def test_torch_callers_run_over_a_layer():
    from torch.func import functional_call

    from paddle_tpu_torch import flags as tflags
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.optimizer import AdamW

    def run(capture):
        tflags.set_flags({"step_capture": capture})
        try:
            TI.seed(7)
            net = tnn.Sequential(tnn.Linear(5, 8), tnn.GELU(),
                                 tnn.LayerNorm(8), tnn.Linear(8, 1))
            opt = AdamW(learning_rate=0.01, parameters=net.parameters())
            train = TrainStep(net, tnn.MSELoss(), opt)
            x = torch.from_numpy(_x(6, 5))
            y = torch.from_numpy(_x(6, 1, seed=1))
            return net, [float(train((x,), (y,))) for _ in range(4)]
        finally:
            tflags.set_flags({"step_capture": True})

    net, lc = run(True)
    _, le = run(False)
    assert lc == le and lc[-1] < lc[0]
    params = {n: torch.zeros_like(p) for n, p in net.named_parameters()}
    out = functional_call(net, params, (torch.ones(2, 5),))
    assert torch.equal(out, torch.zeros(2, 1))


INITS = {
    "Normal": dict(mean=0.5, std=2.0),
    "TruncatedNormal": dict(mean=0.5, std=2.0),
    "Uniform": dict(low=-0.5, high=1.5),
    "XavierNormal": {},
    "XavierUniform": {},
    "KaimingNormal": {},
    "KaimingUniform": {},
    "Constant": dict(value=0.25),
}
SHAPES = [(256, 384), (64, 32, 3, 3)]


@pytest.mark.parametrize("shape", SHAPES, ids=["linear", "conv"])
@pytest.mark.parametrize("name", sorted(INITS))
def test_initializer_fan_and_moments_match_reference(name, shape):
    paddle.seed(0)
    ref = np.asarray(getattr(JI, name)(**INITS[name])(shape, "float32"))
    TI.seed(0)
    got = getattr(TI, name)(**INITS[name])(shape, "float32", "cpu")
    assert tuple(got.shape) == ref.shape and got.dtype == torch.float32
    got = got.numpy()
    n = got.size
    if name == "Constant":
        np.testing.assert_array_equal(got, ref)
        return
    assert abs(got.mean() - ref.mean()) <= 6 * ref.std() / np.sqrt(n) \
        + 1e-7
    assert abs(got.std() / ref.std() - 1) <= 0.03
    if "Uniform" in name or name == "TruncatedNormal":
        lo, hi = ref.min(), ref.max()
        span = hi - lo
        assert lo - 0.01 * span <= got.min() and got.max() <= hi + 0.01 * span
        assert got.min() < lo + 0.01 * span and got.max() > hi - 0.01 * span


def test_assign_and_param_attr_through_a_layer():
    value = _x(3, 2)
    layer = tnn.Linear(3, 2, weight_attr=tnn.ParamAttr(
        initializer=TI.Assign(value)), bias_attr=tnn.ParamAttr(
        initializer=TI.Constant(0.5)))
    np.testing.assert_array_equal(layer.weight.detach().numpy(), value)
    assert torch.equal(layer.bias, torch.full((2,), 0.5))
    with pytest.raises(ValueError, match="shape"):
        TI.Assign(value)((2, 3), "float32", "cpu")
    # Paddle's [in, out] weight: fan-in is shape[0]; a conv kernel's is
    # in/groups * kh * kw
    assert TI._fan_in_out((6, 4)) == (6, 4)
    assert TI._fan_in_out((8, 3, 5, 5)) == (75, 200)
    conv = tnn.Conv2D(3, 8, 5)
    assert float(conv.weight.abs().max()) <= np.sqrt(6 / 75)
