"""Shared symmetric-absmax quantization helpers (torch functions).

Counterpart of ``paddle_tpu/ops/kernels/pallas/quant_common.py``. Used by
the int8 paged KV pool (``serving.paged_cache_write_q``, per-token-slot
scales riding the block table), by the plain versions of the attention
kernels and by the weight-only GEMMs (``weight_only_gemm.py``, per-channel
or per-group weight scales). Symmetric scheme throughout:

    scale = absmax(x, axis) * float32(1 / bound)   # bound: 127 int8, 7 int4
    q     = clip(round(x / scale), -bound, bound)
    x~    = q * scale

`EPS` guards all-zero groups (scale 0 -> divide keeps q at 0). ``round``
is half-to-even, as in the reference.
"""

from __future__ import annotations

import torch

INT8_BOUND = 127.0
INT4_BOUND = 7.0
EPS = 1e-10


def absmax_scale(x: torch.Tensor, axis: int,
                 bound: float = INT8_BOUND) -> torch.Tensor:
    """float32 scale(s) along `axis` (the axis is reduced away), as the
    reference's ops compute them: they run jitted, and XLA turns the
    division by the constant bound into a product with the bound's
    float32 reciprocal (the JAX function run eagerly divides; the two
    differ by an ulp on about 4% of scales). The reciprocal stays a
    Python float, which torch rounds to float32 for a float32 tensor: the
    same product, with no copy to the device (and so no host sync) per
    call."""
    return x.float().abs().amax(dim=axis) * (1.0 / bound)


def quantize_symmetric(x: torch.Tensor, scales: torch.Tensor,
                       bound: float = INT8_BOUND) -> torch.Tensor:
    """Round-to-nearest symmetric quantization; `scales` must broadcast
    against `x`. Returns int8 codes (int4 callers pack nibbles themselves)."""
    q = torch.round(x.float() / torch.clamp(scales, min=EPS))
    return torch.clamp(q, -bound, bound).to(torch.int8)


def dequantize_symmetric(q: torch.Tensor, scales: torch.Tensor,
                         dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Codes * scales (broadcast) -> `dtype`."""
    return (q.float() * scales.float()).to(dtype)
