"""paddle_tpu_torch.quantization: quantization-aware training with fake
quantization, and post-training quantization with observers.

Counterpart of ``paddle_tpu/quantization/__init__.py``: ``fake_quant``
and ``quant_linear`` over the ``fake_quantize`` op (its gradient the
straight-through estimator, ``ops/kernels/quant.py``); the observers
``AbsmaxObserver`` and ``EMAObserver``, whose state is a scalar tensor on
the observed tensor's device (an observation adds one reduction to the
card's stream and never reads the card on the host); ``FakeQuant`` and
``QuantConfig`` (``add_type_config``); the wrappers ``QuantedLinear`` and
``QuantedConv2D``; ``QAT``, which swaps each ``Linear`` and ``Conv2D`` for
its wrapper through torch's module tree (so ``parameters()``,
``state_dict()`` and an optimizer built afterwards see the wrapped
layers, their weights under ``<name>.inner``); and ``PTQ`` with
``convert`` (int8 weights and a dequantization scale).

Observers run eagerly only: inside a step that ``jit.jit_step`` or
``jit.TrainStep`` probes, warms up, captures or replays, or under a CUDA
graph capture or ``torch.compile``, ``observe()`` raises the reference's
``RuntimeError``: a captured graph would replay a stale scale. Train a
QAT model with ``FLAGS_step_capture`` off; calibrate, ``convert()``, and
only then capture.
"""

from __future__ import annotations

import copy
from typing import Dict, Optional, Type

import torch

from ..nn.layer_base import Layer
from ..nn.layers_common import Conv2D, Linear

__all__ = ["QuantConfig", "QAT", "PTQ", "AbsmaxObserver", "EMAObserver",
           "FakeQuant", "quant_linear", "QuantedLinear", "QuantedConv2D",
           "fake_quant"]


def _call_op(name, *args, **kwargs):
    from ..ops.dispatcher import call_op
    return call_op(name, *args, **kwargs)


# -- fake quant ---------------------------------------------------------------

def fake_quant(x: torch.Tensor, scale, bit_length: int = 8) -> torch.Tensor:
    """``x`` fake-quantized at ``bit_length`` bits against the abs-max
    ``scale`` (a tensor, or a number filled into one on x's device, so
    that no host copy syncs the stream), through the ``fake_quantize``
    op."""
    if not isinstance(scale, torch.Tensor):
        scale = torch.full((), float(scale), dtype=torch.float32,
                           device=x.device)
    return _call_op("fake_quantize", x, scale, bit_length=bit_length)


# -- observers ----------------------------------------------------------------

OBSERVER_TRACED_MESSAGE = (
    "quantization observers must run eagerly: observe() was called under "
    "jit/to_static tracing. Calibrate the model eagerly first, call "
    "convert(), and only then compile the quantized model.")


def _check_not_traced() -> None:
    """Observers mutate Python-held device state: a captured step would
    record this step's scale into its graph and replay it stale. Fail
    loudly instead, with the reference's message."""
    from ..jit import step_capture
    if step_capture._ACTIVE or torch.compiler.is_compiling() or (
            torch.cuda.is_available()
            and torch.cuda.is_current_stream_capturing()):
        raise RuntimeError(OBSERVER_TRACED_MESSAGE)


def _absmax(x: torch.Tensor) -> torch.Tensor:
    return x.detach().abs().amax().float()


class AbsmaxObserver:
    """The running abs-max of what it observes (the reference's
    ``observer/abs_max.py``), a scalar tensor on the observed device."""

    def __init__(self, quant_bits: int = 8):
        self.quant_bits = quant_bits
        self._max: Optional[torch.Tensor] = None

    def observe(self, x: torch.Tensor) -> None:
        _check_not_traced()
        cur = _absmax(x)
        self._max = cur if self._max is None else torch.maximum(self._max,
                                                                cur)

    def scale(self) -> torch.Tensor:
        if self._max is None:
            return torch.tensor(1e-9)
        return self._max.clamp(min=1e-9)


class EMAObserver:
    """The moving average of the observed abs-max (the reference's
    ``observer/ema.py``): the first observation, then ``rate * ema + (1 -
    rate) * cur``."""

    def __init__(self, quant_bits: int = 8, moving_rate: float = 0.9):
        self.quant_bits = quant_bits
        self.moving_rate = moving_rate
        self._ema: Optional[torch.Tensor] = None

    def observe(self, x: torch.Tensor) -> None:
        _check_not_traced()
        cur = _absmax(x)
        self._ema = cur if self._ema is None else (
            self.moving_rate * self._ema + (1 - self.moving_rate) * cur)

    def scale(self) -> torch.Tensor:
        if self._ema is None:
            return torch.tensor(1e-9)
        return self._ema.clamp(min=1e-9)


# -- config -------------------------------------------------------------------

class FakeQuant:
    """A quanter: an observer class and its bits."""

    def __init__(self, observer_cls=AbsmaxObserver, quant_bits: int = 8):
        self.observer_cls = observer_cls
        self.quant_bits = quant_bits

    def make(self):
        return self.observer_cls(self.quant_bits)


class QuantConfig:
    """Which layers get which quanters (the reference's
    ``quantization/config.py``): by default every ``Linear`` and
    ``Conv2D``, activations through an 8-bit ``EMAObserver``, weights
    through an 8-bit ``AbsmaxObserver``."""

    def __init__(self, activation: Optional[FakeQuant] = None,
                 weight: Optional[FakeQuant] = None):
        self.activation = activation or FakeQuant(EMAObserver, 8)
        self.weight = weight or FakeQuant(AbsmaxObserver, 8)
        self._type_configs: Dict[Type[torch.nn.Module], Dict] = {}

    def add_type_config(self, layer_type, activation=None, weight=None):
        self._type_configs[layer_type] = {
            "activation": activation or self.activation,
            "weight": weight or self.weight}

    def config_for(self, layer: torch.nn.Module) -> Optional[Dict]:
        for t, cfg in self._type_configs.items():
            if isinstance(layer, t):
                return cfg
        if isinstance(layer, (Linear, Conv2D)):
            return {"activation": self.activation, "weight": self.weight}
        return None


# -- the quantized layers -----------------------------------------------------

class _Quanted(Layer):
    """A layer whose weight and input are fake-quantized (QAT), whose input
    is only observed (PTQ calibration), or whose weight is int8 with a
    dequantization scale (after ``PTQ.convert``)."""

    def __init__(self, inner, cfg: Dict):
        super().__init__()
        self.inner = inner
        self.weight_quanter = cfg["weight"].make()
        self.act_quanter = cfg["activation"].make()
        self.weight_bits = cfg["weight"].quant_bits
        self.act_bits = cfg["activation"].quant_bits
        self.calibrating = False
        self.int8_weight: Optional[torch.Tensor] = None
        self.dequant_scale: Optional[float] = None

    def _apply_op(self, x, w):
        raise NotImplementedError

    def forward(self, x):
        if self.int8_weight is not None:
            return self._apply_op(x, self.int8_weight.float()
                                  * self.dequant_scale)
        if self.calibrating:
            self.act_quanter.observe(x)
            return self.inner(x)
        self.weight_quanter.observe(self.inner.weight)
        self.act_quanter.observe(x)
        w = fake_quant(self.inner.weight, self.weight_quanter.scale(),
                       self.weight_bits)
        xq = fake_quant(x, self.act_quanter.scale(), self.act_bits)
        return self._apply_op(xq, w)


class QuantedLinear(_Quanted):
    """``Linear`` with fake-quantized weight and activation."""

    def _apply_op(self, x, w):
        return _call_op("linear", x, w, self.inner.bias)


class QuantedConv2D(_Quanted):
    """``Conv2D`` with fake-quantized weight and activation."""

    def _apply_op(self, x, w):
        i = self.inner
        return _call_op("conv2d", x, w, i.bias, stride=i.stride,
                        padding=i.padding, dilation=i.dilation,
                        groups=i.groups, data_format=i.data_format)


class QAT:
    """Quantization-aware training (the reference's ``qat.py``):
    ``quantize(model)`` replaces each quantizable layer by its
    fake-quantized wrapper (on a deep copy when ``inplace`` is False)."""

    def __init__(self, config: Optional[QuantConfig] = None):
        self.config = config or QuantConfig()

    def quantize(self, model: torch.nn.Module,
                 inplace: bool = True) -> torch.nn.Module:
        if not inplace:
            model = copy.deepcopy(model)
        self._quantize_inplace(model)
        return model

    def _quantize_inplace(self, model: torch.nn.Module) -> None:
        for name, sub in list(model.named_children()):
            cfg = self.config.config_for(sub)
            if cfg is not None and isinstance(sub, Linear):
                setattr(model, name, QuantedLinear(sub, cfg))
            elif cfg is not None and isinstance(sub, Conv2D):
                setattr(model, name, QuantedConv2D(sub, cfg))
            else:
                self._quantize_inplace(sub)


def _quanted(model: torch.nn.Module):
    return [m for m in model.modules() if isinstance(m, _Quanted)]


class PTQ:
    """Post-training quantization (the reference's ``ptq.py``):
    ``quantize`` wraps the layers with their inputs observed by abs-max,
    calibration batches run through the model, then ``convert`` freezes
    each weight to int8 with a dequantization scale."""

    def __init__(self, config: Optional[QuantConfig] = None):
        self.config = config or QuantConfig(
            activation=FakeQuant(AbsmaxObserver, 8))

    def quantize(self, model: torch.nn.Module) -> torch.nn.Module:
        model = QAT(self.config).quantize(model)
        for layer in _quanted(model):
            layer.calibrating = True
        return model

    @torch.no_grad()
    def convert(self, model: torch.nn.Module) -> torch.nn.Module:
        """Each wrapped weight to ``int8_weight`` (round to nearest even of
        ``w / step``, clipped to the bits' range) and ``dequant_scale``
        (the step, a float: one host read a layer); the forward then
        runs on the dequantized weight."""
        for layer in _quanted(model):
            layer.calibrating = False
            w = layer.inner.weight.detach()
            layer.weight_quanter.observe(w)
            qmax = float(2 ** (layer.weight_bits - 1) - 1)
            step = float(layer.weight_quanter.scale()) / qmax
            # a tensor divisor: the card divides by a host scalar as a
            # product with its reciprocal, which moves rounding boundaries
            q = torch.round(w / torch.full((), step, dtype=w.dtype,
                                           device=w.device))
            layer.int8_weight = q.clamp(-qmax - 1, qmax).to(torch.int8)
            layer.dequant_scale = step
        return model


def quant_linear(x, weight, bias, scale_in, scale_w, bits: int = 8):
    """A linear over fake-quantized input and weight at given scales."""
    xq = fake_quant(x, scale_in, bits)
    wq = fake_quant(weight, scale_w, bits)
    return _call_op("linear", xq, wq, bias)
