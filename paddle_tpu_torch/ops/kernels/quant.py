"""Weight-only quantization ops for serving.

Counterpart of ``paddle_tpu/ops/kernels/quant.py:54-92``:
``weight_quantize``, ``weight_dequantize`` and ``weight_only_linear``, over
``weight_only_gemm.py`` (the reference's layout; the CUDA int4 kernel for
per-channel int4 on the card). Each takes the reference's arguments and
is registered as the op of the same name (``ops/dispatcher.py``:
``call_op("weight_only_linear", ...)``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ...core.device import dtype_of
from ..dispatcher import register_kernel
from . import weight_only_gemm as wog


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
