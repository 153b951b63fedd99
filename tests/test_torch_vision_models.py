"""The port's classification zoo (``vision/models/``) against the JAX
package's, on the CPU: each model class at its smallest input (and a
narrow width where the class takes a ``scale``), the reference's weights
and BatchNorm statistics carried across with
``models.from_jax_state_dict`` (YOLOv3 is ``test_torch_vision_yolov3.py``).

- Forward, float32, within 1e-4 (absolute and relative: the deeper nets'
  logits reach 1e2): the logits in eval mode (running statistics); the
  reference runs under ``jit.to_static``.
- Training (LeNet, ResNet-18 at 32 x 32, MobileNetV1 at 64 x 64): three
  ``TrainStep``s with ``Momentum`` (momentum 0.9, L2 decay 1e-4, lr 3e-4:
  these nets fit one random batch in a few steps, and a larger rate turns
  float32's summation order into a larger difference by the third step)
  against the reference's ``TrainStep``, in train mode (batch
  statistics), losses within rtol 1e-4, then the BatchNorm statistics the
  steps leave. The depthwise nets are held to the reference in training
  only where their last maps keep some area: at 32 x 32 MobileNetV1 and
  ShuffleNetV2 end in 1 x 1 maps whose batch statistics over 8 values
  amplify rounding (weights 4e-8 apart after one step moved ShuffleNetV2's
  next loss 3.5%).
- Every factory of the zoo builds in the port (parameters on the meta
  device, ``LazyGuard``), and ``pretrained=True`` raises, as in the
  reference.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import optimizer as JO
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu.vision import models as jmodels
from paddle_tpu_torch.core.device import set_device
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import from_jax_state_dict
from paddle_tpu_torch.optimizer import Momentum
from paddle_tpu_torch.vision import models as tmodels

ATOL = RTOL = 1e-4
LOSS_RTOL = 1e-4
LR, MOMENTUM, L2 = 3e-4, 0.9, 1e-4


@pytest.fixture(autouse=True)
def _on_cpu():
    set_device("cpu")
    yield
    set_device(None)


# name -> (factory, kwargs, input [C, H, W], batch, training (size,
# batch) or None)
MODELS = {
    "lenet": ("LeNet", {}, (1, 28, 28), 4, (28, 8)),
    "alexnet": ("alexnet", dict(num_classes=10), (3, 224, 224), 1, None),
    "resnet18": ("resnet18", dict(num_classes=10), (3, 32, 32), 4, (32, 8)),
    "resnet50": ("resnet50", dict(num_classes=10), (3, 32, 32), 2, None),
    "resnext50_32x4d": ("resnext50_32x4d", dict(num_classes=10),
                        (3, 32, 32), 2, None),
    "vgg11_bn": ("vgg11", dict(num_classes=10, batch_norm=True),
                 (3, 224, 224), 1, None),
    "mobilenet_v1": ("mobilenet_v1", dict(scale=0.25, num_classes=10),
                     (3, 32, 32), 2, (64, 8)),
    "mobilenet_v2": ("mobilenet_v2", dict(scale=0.5, num_classes=10),
                     (3, 32, 32), 2, None),
    "mobilenet_v3_small": ("mobilenet_v3_small",
                           dict(scale=0.5, num_classes=10), (3, 32, 32), 2,
                           None),
    "mobilenet_v3_large": ("mobilenet_v3_large",
                           dict(scale=0.5, num_classes=10), (3, 32, 32), 2,
                           None),
    "squeezenet1_0": ("squeezenet1_0", dict(num_classes=10), (3, 64, 64), 2,
                      None),
    "squeezenet1_1": ("squeezenet1_1", dict(num_classes=10), (3, 64, 64), 2,
                      None),
    "densenet121": ("densenet121", dict(num_classes=10), (3, 32, 32), 2,
                    None),
    "shufflenet_v2_x0_25": ("shufflenet_v2_x0_25", dict(num_classes=10),
                            (3, 32, 32), 2, None),
    "shufflenet_v2_swish": ("shufflenet_v2_swish", dict(num_classes=10),
                            (3, 32, 32), 2, None),
    "googlenet": ("googlenet", dict(num_classes=10), (3, 32, 32), 2, None),
    "inception_v3": ("inception_v3", dict(num_classes=10), (3, 75, 75), 2,
                     None),
}


def _pair(factory, kw):
    paddle.seed(0)
    jm = getattr(jmodels, factory)(**kw)
    tm = getattr(tmodels, factory)(**kw)
    from_jax_state_dict(tm, {k: np.asarray(v._data)
                             for k, v in jm.state_dict().items()})
    return jm, tm


def _images(b, shape, seed=0):
    return np.random.RandomState(seed).rand(b, *shape).astype(np.float32)


def _cross_entropy(logits, label):
    return torch.nn.functional.cross_entropy(logits, label)


def _jcross_entropy(logits, label):
    from paddle_tpu.nn import functional as JF
    return JF.cross_entropy(logits, label)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_logits_match_reference(name):
    factory, kw, shape, b, _ = MODELS[name]
    jm, tm = _pair(factory, kw)
    x = _images(b, shape)
    jm.eval()
    tm.eval()
    want = paddle.jit.to_static(jm)(Tensor(x)).numpy()
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (b, kw.get("num_classes", 10))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL, err_msg=name)


def _train_both(jm, tm, jloss, tloss, inputs, labels, steps=3, lr=LR):
    jtrain = JTrainStep(jm, jloss, JO.Momentum(
        learning_rate=lr, momentum=MOMENTUM, parameters=jm.parameters(),
        weight_decay=L2))
    ttrain = TrainStep(tm, tloss, Momentum(
        learning_rate=lr, momentum=MOMENTUM, parameters=tm.parameters(),
        weight_decay=L2))
    jl = [float(jtrain(tuple(Tensor(a) for a in inputs),
                       tuple(Tensor(a) for a in labels))._data)
          for _ in range(steps)]
    tl = [float(ttrain(tuple(torch.from_numpy(a) for a in inputs),
                       tuple(torch.from_numpy(a) for a in labels)))
          for _ in range(steps)]
    return jl, tl


def _bn_stats_match(jm, tm, what):
    jstate, tstate = jm.state_dict(), tm.state_dict()
    for name in jstate:
        if name.endswith(("_mean", "_variance")):
            np.testing.assert_allclose(tstate[name].numpy(),
                                       np.asarray(jstate[name]._data),
                                       atol=ATOL, rtol=RTOL,
                                       err_msg=f"{what}: {name}")


@pytest.mark.parametrize("name", sorted(n for n, v in MODELS.items()
                                        if v[4]))
def test_three_momentum_steps_track_reference(name):
    factory, kw, shape, _, (size, b) = MODELS[name]
    jm, tm = _pair(factory, kw)
    x = _images(b, (shape[0], size, size), seed=1)
    y = np.random.RandomState(2).randint(0, 10, b).astype(np.int64)
    jl, tl = _train_both(jm, tm, _jcross_entropy, _cross_entropy, [x], [y])
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL, atol=0, err_msg=name)
    _bn_stats_match(jm, tm, name)


# -- the whole zoo --------------------------------------------------------------

FACTORIES = sorted(n for n in tmodels.__dict__
                   if n[0].islower() and callable(tmodels.__dict__[n])
                   and n not in ("yolov3_darknet53",))


def test_zoo_lists_the_references_factories():
    ref = {n for n in jmodels.__dict__
           if n[0].islower() and callable(jmodels.__dict__[n])}
    assert set(FACTORIES) | {"yolov3_darknet53"} == ref


@pytest.mark.parametrize("name", FACTORIES)
def test_every_factory_builds_and_refuses_pretrained(name):
    from paddle_tpu_torch.nn import LazyGuard
    fn = getattr(tmodels, name)
    with LazyGuard():
        model = fn(num_classes=10)
    assert sum(p.numel() for p in model.parameters()) > 0
    with pytest.raises(RuntimeError, match="pretrained"):
        fn(pretrained=True, num_classes=10)
