"""The quantization ops: fake quantization for QAT and the weight-only
and LLM.int8() linears for serving.

Counterpart of ``paddle_tpu/ops/kernels/quant.py``: ``fake_quantize``
(:19-50, ``ops.yaml:420``) with its straight-through gradient;
``weight_quantize``, ``weight_dequantize`` and ``weight_only_linear``
(:54-92) over ``weight_only_gemm.py`` (the reference's layout; the CUDA
int4 kernel for per-channel int4 on the card); and ``llm_int8_linear``
(:95, ``ops.yaml:674``). Each takes the reference's arguments and is
registered as the op of the same name (``ops/dispatcher.py``:
``call_op("weight_only_linear", ...)``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ...core.device import dtype_of
from ..dispatcher import register_kernel
from . import weight_only_gemm as wog


class _FakeQuant(torch.autograd.Function):
    """``clip(round(x / step), qmin, qmax) * step``; the gradient passes
    to ``x`` where ``x / step`` lies in ``[qmin, qmax]`` (the
    straight-through estimator); ``step`` gets zeros, as in the
    reference."""

    @staticmethod
    def forward(ctx, x, step, qmin: float, qmax: float):
        q = x / step
        ctx.save_for_backward(q, step)
        ctx.bounds = (qmin, qmax)
        return torch.clamp(torch.round(q), qmin, qmax) * step

    @staticmethod
    def backward(ctx, ct):
        q, step = ctx.saved_tensors
        qmin, qmax = ctx.bounds
        return (torch.where((q >= qmin) & (q <= qmax), ct, 0.0),
                torch.zeros_like(step), None, None)


@register_kernel("fake_quantize")
def fake_quantize(x: torch.Tensor, scale: torch.Tensor,
                  bit_length: int = 8) -> torch.Tensor:
    """Symmetric fake quantization at ``bit_length`` bits: ``scale`` is
    the observed abs-max of ``x`` (a tensor, so an observer's update
    never syncs the host), the step ``max(scale / qmax, 1e-9)``. The
    division is by a tensor filled on the scale's device: the card
    divides by a host scalar as a product with its reciprocal, which
    moves a rounding boundary, and a tensor copied from the host would
    sync the stream (and break a graph capture)."""
    qmax = float(2 ** (bit_length - 1) - 1)
    step = torch.clamp(scale.to(x.dtype) / torch.full(
        (), qmax, dtype=x.dtype, device=scale.device), min=1e-9)
    return _FakeQuant.apply(x, step, -qmax - 1.0, qmax)


def weight_dtype_of(algo: str) -> str:
    """'int4' for ``weight_only_int4``, else 'int8'."""
    return "int4" if algo == "weight_only_int4" else "int8"


@register_kernel("weight_quantize")
def weight_quantize(x: torch.Tensor, algo: str = "weight_only_int8",
                    arch=80, group_size: int = -1
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """weight ``[k, n]`` -> (qweight int8 ``[k, n]`` (int4: ``[k//2, n]``
    packed), scales float32 ``[n]`` or ``[k//gs, n]``)."""
    return wog.quantize(x, weight_dtype_of(algo), int(group_size))


@register_kernel("weight_dequantize")
def weight_dequantize(x: torch.Tensor, scale: torch.Tensor,
                      algo: str = "weight_only_int8",
                      out_dtype="float32", group_size: int = -1
                      ) -> torch.Tensor:
    w = wog.dequantize(x, scale, algo == "weight_only_int4", x.shape[1])
    return w.to(dtype_of(out_dtype or "float32"))


@register_kernel("weight_only_linear")
def weight_only_linear(x: torch.Tensor, weight: torch.Tensor,
                       bias: Optional[torch.Tensor] = None,
                       weight_scale: Optional[torch.Tensor] = None,
                       weight_dtype: str = "int8", arch=80,
                       group_size: int = -1) -> torch.Tensor:
    """x ``[..., k]`` @ dequant(weight) + bias, in x's dtype: x is
    flattened to ``[m, k]`` for the product, the bias is added in the
    output dtype, and the result takes x's leading shape back."""
    lead = x.shape[:-1]
    out = wog.weight_only_matmul(x.reshape(-1, x.shape[-1]), weight,
                                 weight_scale, weight_dtype, int(group_size))
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out.reshape(*lead, out.shape[-1])


def _int8_product(xq: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``xq @ w`` of int8 ``[m, k]`` and ``[k, n]``, accumulated exactly
    in int32: on the card ``torch._int_mm`` where its shape rules hold (m
    over 16, k and n multiples of 8), else in float64, where every partial
    sum of int8 products is an integer below 2**53."""
    m, k = xq.shape
    n = w.shape[1]
    if xq.is_cuda and m > 16 and k % 8 == 0 and n % 8 == 0:
        return torch._int_mm(xq, w)
    return torch.matmul(xq.double(), w.double()).to(torch.int32)


@register_kernel("llm_int8_linear")
def llm_int8_linear(x: torch.Tensor, weight: torch.Tensor,
                    bias: Optional[torch.Tensor] = None,
                    weight_scale: Optional[torch.Tensor] = None,
                    threshold: float = 6.0) -> torch.Tensor:
    """LLM.int8(): the activation columns whose abs-max exceeds
    ``threshold`` run in float32 against the dequantized weight rows, the
    rest as an int8 x int8 product (int32 accumulation) with per-row
    activation scales. weight int8 ``[k, n]``, weight_scale float32
    ``[n]``. Both terms are always computed (the outlier term is zero
    without outliers), so no branch reads the card's data on the host."""
    lead = x.shape[:-1]
    xf = x.reshape(-1, x.shape[-1]).float()
    sc = weight_scale.float()
    outlier = xf.abs().amax(dim=0) > threshold
    x_reg = torch.where(outlier[None, :], 0.0, xf)
    x_out = torch.where(outlier[None, :], xf, 0.0)
    # a divisor filled on the device: a rounding follows (no reciprocal),
    # and no host copy syncs the stream
    row_scale = x_reg.abs().amax(dim=1).clamp(min=1e-10) / torch.full(
        (), 127.0, device=xf.device)
    xq = torch.clamp(torch.round(x_reg / row_scale[:, None]), -127, 127) \
        .to(torch.int8)
    acc = _int8_product(xq, weight.to(torch.int8))
    out = acc.float() * row_scale[:, None] * sc[None, :]
    out = out + torch.matmul(x_out, weight.float()) * sc[None, :]
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype).reshape(*lead, out.shape[-1])
