"""nn.quant: the weight-only quantized serving surface.

Counterpart of ``paddle_tpu/nn/quant.py``: the functional wrappers
``weight_quantize``, ``weight_dequantize`` and ``weight_only_linear`` (over
``ops/kernels/quant.py``), the ``WeightOnlyLinear`` layer and
``quantize_for_inference``, which swaps a model's ``Linear``s for
``WeightOnlyLinear``s in place. A quantized model serves through the same
``ContinuousBatchingEngine`` and ``generate()``: they call the model only
through its modules. Per-channel int4 on the card runs the CUDA kernel
(``csrc/weight_only_gemm.cu``).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..core.device import DeviceLike, resolve_device
from ..ops.kernels import quant as Q
from .layers_common import Linear

weight_quantize = Q.weight_quantize
weight_dequantize = Q.weight_dequantize
weight_only_linear = Q.weight_only_linear


class WeightOnlyLinear(nn.Module):
    """Serving Linear with int8/int4 weights (dequant-in-kernel product).

    Build from a Linear with ``WeightOnlyLinear.from_linear(lin)``, or
    construct an empty skeleton (zero buffers of the derived shapes, so a
    saved quantized ``state_dict`` loads into it) and ``set_quantized``.
    ``qweight`` (int8), ``weight_scale`` (float32) and ``bias`` are
    buffers: they ride ``state_dict`` and take no grads. ``device=None``
    means the CUDA card."""

    def __init__(self, in_features: int, out_features: int,
                 weight_dtype: str = "int8", group_size: int = -1,
                 bias=None, device: DeviceLike = None):
        super().__init__()
        dev = resolve_device(device)
        self.in_features = in_features
        self.out_features = out_features
        self.weight_dtype = weight_dtype
        self.group_size = group_size
        # `bias=True` pre-registers zeros so a skeleton can load a
        # checkpoint saved from a from_linear-built layer; a tensor is
        # copied, so it never aliases a trainable parameter
        if bias is True:
            bias = torch.zeros((out_features,), dtype=torch.float32,
                               device=dev)
        elif bias is None or bias is False:
            bias = None
        else:
            bias = bias.detach().clone()
        self.register_buffer("bias", bias)
        k = in_features // 2 if weight_dtype == "int4" else in_features
        srows = in_features // group_size if group_size > 0 else None
        self.register_buffer("qweight", torch.zeros(
            (k, out_features), dtype=torch.int8, device=dev))
        self.register_buffer("weight_scale", torch.zeros(
            (srows, out_features) if srows else (out_features,),
            dtype=torch.float32, device=dev))

    @staticmethod
    def from_linear(lin: Linear, weight_dtype: str = "int8",
                    group_size: int = -1) -> "WeightOnlyLinear":
        """Quantize ``lin``'s weight on the device where it lives."""
        w = lin.weight.detach()
        q, s = weight_quantize(w, algo=f"weight_only_{weight_dtype}",
                               group_size=group_size)
        layer = WeightOnlyLinear(w.shape[0], w.shape[1], weight_dtype,
                                 group_size, bias=getattr(lin, "bias", None),
                                 device=w.device)
        layer.set_quantized(q, s)
        return layer

    def set_quantized(self, qweight: torch.Tensor,
                      weight_scale: torch.Tensor) -> None:
        self.register_buffer("qweight", qweight)
        self.register_buffer("weight_scale", weight_scale)

    def forward(self, x):
        return weight_only_linear(x, self.qweight, self.bias,
                                  self.weight_scale,
                                  weight_dtype=self.weight_dtype,
                                  group_size=self.group_size)


def quantize_for_inference(model: nn.Module, algo: str = "weight_only_int8",
                           group_size: int = -1,
                           skip: Optional[tuple] = ("lm_head",)
                           ) -> nn.Module:
    """Swap every ``Linear`` in ``model`` for a ``WeightOnlyLinear`` IN
    PLACE. ``skip`` filters by attribute name (the LM head stays high
    precision by default). Each weight is quantized on its own device, one
    at a time, and its ``Linear`` is dropped as soon as it is swapped, so
    the peak is the model plus the temporaries of one weight's
    quantization."""
    wdt = Q.weight_dtype_of(algo)

    def visit(layer: nn.Module):
        for name in list(layer._modules):
            sub = layer._modules[name]
            if isinstance(sub, Linear) and (not skip or name not in skip):
                layer._modules[name] = WeightOnlyLinear.from_linear(
                    sub, weight_dtype=wdt, group_size=group_size)
            elif sub is not None:
                visit(sub)

    with torch.no_grad():
        visit(model)
    return model
