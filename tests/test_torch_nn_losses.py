"""The port's loss layers (``paddle_tpu_torch.nn.loss``) and the
functional surface over the same ops (``paddle_tpu_torch.nn.functional``)
against the JAX package's, on the CPU.

Each loss is built in both packages with the same arguments and sees the
same inputs and labels (numpy, seeded); the backward of its output (times
a seeded cotangent where the reduction keeps a shape) gives the input
grad. Held to the reference, float32: the loss atol 1e-6 and rtol 1e-5,
the input grad within 1e-5 of its max (the reductions add in another
order). Covered: every reduction, hard labels ``[N]`` and ``[N, 1]``,
``ignore_index``, class weights, soft labels, label smoothing and a class
axis other than the last for ``CrossEntropyLoss``; ``NLLLoss`` with
weights and ``ignore_index``; ``SmoothL1Loss``'s ``delta``; ``BCELoss``
with a weight; ``BCEWithLogitsLoss`` with ``weight`` and ``pos_weight``;
``KLDivLoss`` over probabilities and log-probabilities and
``batchmean``. The functional names equal the reference's results on the
same inputs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
from paddle_tpu.core.tensor import Tensor
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.nn import functional as TF

ATOL, RTOL, GRAD_REL = 1e-6, 1e-5, 1e-5


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _rel(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _x(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _probs(*shape, seed=0):
    return 1.0 / (1.0 + np.exp(-_x(*shape, seed=seed)))


def _labels(n, c, seed=1, ignore=None):
    lab = np.random.RandomState(seed).randint(0, c, n).astype(np.int64)
    if ignore is not None:
        lab[::3] = ignore
    return lab


def _run(jfn, tfn, x, label, seed=2):
    jx = Tensor(x, stop_gradient=False)
    jout = jfn(jx, Tensor(label))
    ct = np.asarray(np.random.RandomState(seed).randn(*jout.shape),
                    np.float32)
    (jout * Tensor(ct)).sum().backward()
    tx = torch.from_numpy(x.copy()).requires_grad_()
    tout = tfn(tx, torch.from_numpy(label))
    (tout * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(tout.detach().numpy(), _np(jout._data),
                               atol=ATOL, rtol=RTOL)
    assert _rel(tx.grad.numpy(), _np(jx.grad._data)) <= GRAD_REL


W5 = np.array([0.5, 2.0, 1.0, 0.25, 3.0], np.float32)
SOFT = _probs(6, 5, seed=3)
SOFT = SOFT / SOFT.sum(axis=1, keepdims=True)

# name -> (layer name, kwargs (numpy weights), input, label)
CASES = {
    "ce": ("CrossEntropyLoss", {}, _x(6, 5), _labels(6, 5)),
    "ce_n1": ("CrossEntropyLoss", {}, _x(6, 5), _labels(6, 5)[:, None]),
    "ce_ignore": ("CrossEntropyLoss", dict(ignore_index=-1), _x(6, 5),
                  _labels(6, 5, ignore=-1)),
    "ce_weight": ("CrossEntropyLoss", dict(weight=W5, ignore_index=-1),
                  _x(6, 5), _labels(6, 5, ignore=-1)),
    "ce_sum": ("CrossEntropyLoss", dict(reduction="sum"), _x(6, 5),
               _labels(6, 5)),
    "ce_none": ("CrossEntropyLoss", dict(reduction="none"), _x(6, 5),
                _labels(6, 5)),
    "ce_soft": ("CrossEntropyLoss", dict(soft_label=True), _x(6, 5), SOFT),
    "ce_smoothing": ("CrossEntropyLoss", dict(label_smoothing=0.1),
                     _x(6, 5), _labels(6, 5)),
    "ce_axis1": ("CrossEntropyLoss", dict(axis=1), _x(3, 5, 4),
                 np.random.RandomState(4).randint(0, 5, (3, 1, 4))),
    "mse": ("MSELoss", {}, _x(4, 3), _x(4, 3, seed=5)),
    "mse_sum": ("MSELoss", dict(reduction="sum"), _x(4, 3), _x(4, 3, seed=5)),
    "mse_none": ("MSELoss", dict(reduction="none"), _x(4, 3),
                 _x(4, 3, seed=5)),
    "l1": ("L1Loss", {}, _x(4, 3), _x(4, 3, seed=5)),
    "l1_none": ("L1Loss", dict(reduction="none"), _x(4, 3), _x(4, 3, seed=5)),
    "smooth_l1": ("SmoothL1Loss", dict(delta=0.5), _x(4, 3) * 2,
                  _x(4, 3, seed=5)),
    "smooth_l1_sum": ("SmoothL1Loss", dict(reduction="sum"), _x(4, 3) * 2,
                      _x(4, 3, seed=5)),
    "nll": ("NLLLoss", {}, np.log(SOFT), _labels(6, 5)),
    "nll_weight_ignore": ("NLLLoss", dict(weight=W5, ignore_index=2),
                          np.log(SOFT), _labels(6, 5)),
    "nll_none": ("NLLLoss", dict(reduction="none"), np.log(SOFT),
                 _labels(6, 5)),
    "bce": ("BCELoss", {}, _probs(4, 3), _probs(4, 3, seed=6)),
    "bce_weight": ("BCELoss", dict(weight=_probs(4, 3, seed=7)),
                   _probs(4, 3), (_probs(4, 3, seed=6) > 0.5)
                   .astype(np.float32)),
    "bce_logits": ("BCEWithLogitsLoss", {}, _x(4, 3) * 3,
                   _probs(4, 3, seed=6)),
    "bce_logits_pos_weight": ("BCEWithLogitsLoss",
                              dict(pos_weight=np.array([1.0, 2.0, 0.5],
                                                       np.float32),
                                   weight=_probs(4, 3, seed=7),
                                   reduction="sum"),
                              _x(4, 3) * 3, _probs(4, 3, seed=6)),
    "kl": ("KLDivLoss", {}, np.log(SOFT), SOFT[::-1].copy()),
    "kl_batchmean": ("KLDivLoss", dict(reduction="batchmean"), np.log(SOFT),
                     SOFT[::-1].copy()),
    "kl_log_target": ("KLDivLoss", dict(log_target=True, reduction="sum"),
                      np.log(SOFT), np.log(SOFT[::-1].copy())),
}


def _kw(kw, wrap):
    return {k: wrap(v) if isinstance(v, np.ndarray) else v
            for k, v in kw.items()}


@pytest.mark.parametrize("case", sorted(CASES))
def test_loss_matches_reference(case):
    name, kw, x, label = CASES[case]
    jl = getattr(jnn, name)(**_kw(kw, Tensor))
    tl = getattr(tnn, name)(**_kw(kw, torch.from_numpy))
    _run(jl, tl, x, label)


FUNCTIONAL = {
    "cross_entropy": (dict(ignore_index=-1), _x(6, 5),
                      _labels(6, 5, ignore=-1)),
    "cross_entropy_no_softmax": (dict(use_softmax=False), SOFT,
                                 _labels(6, 5)),
    "mse_loss": ({}, _x(4, 3), _x(4, 3, seed=5)),
    "l1_loss": (dict(reduction="sum"), _x(4, 3), _x(4, 3, seed=5)),
    "smooth_l1_loss": (dict(delta=0.3), _x(4, 3), _x(4, 3, seed=5)),
    "nll_loss": ({}, np.log(SOFT), _labels(6, 5)),
    "kl_div": (dict(reduction="batchmean"), np.log(SOFT), SOFT[::-1].copy()),
    "binary_cross_entropy": ({}, _probs(4, 3), _probs(4, 3, seed=6)),
    "binary_cross_entropy_with_logits": ({}, _x(4, 3), _probs(4, 3, seed=6)),
}


@pytest.mark.parametrize("case", sorted(FUNCTIONAL))
def test_functional_loss_matches_reference(case):
    kw, x, label = FUNCTIONAL[case]
    name = case.replace("_no_softmax", "")
    _run(lambda a, b: getattr(JF, name)(a, b, **kw),
         lambda a, b: getattr(TF, name)(a, b, **kw), x, label)


@pytest.mark.parametrize("name,kw", [
    ("relu", {}), ("gelu", dict(approximate=True)), ("softmax", {}),
    ("log_softmax", dict(axis=0)), ("leaky_relu", dict(negative_slope=0.2)),
    ("hardsigmoid", {}), ("softplus", dict(beta=2.0)), ("elu", {}),
    ("swiglu", {}), ("one_hot", None), ("dropout", dict(training=False)),
    ("layer_norm", {}), ("rms_norm", {}), ("pad", dict(pad=[1, 2, 0, 1])),
    ("adaptive_avg_pool2d", dict(output_size=2)),
    ("interpolate", dict(scale_factor=2)),
])
def test_functional_ops_match_reference(name, kw):
    x = _x(2, 3, 4, 4)
    if kw is None:
        x = np.random.RandomState(0).randint(0, 5, (2, 3)).astype(np.int64)
        kw = dict(num_classes=5)
    elif name in ("layer_norm", "rms_norm", "swiglu", "relu", "gelu",
                  "softmax", "leaky_relu", "hardsigmoid", "softplus", "elu",
                  "log_softmax", "dropout"):
        x = _x(3, 8)
    want = getattr(JF, name)(Tensor(x), **kw)
    got = getattr(TF, name)(torch.from_numpy(x), **kw)
    np.testing.assert_allclose(got.numpy(), _np(want._data), atol=ATOL,
                               rtol=RTOL)
