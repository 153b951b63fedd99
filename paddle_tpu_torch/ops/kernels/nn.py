"""Plain tensor kernels of the Llama serving path.

Counterparts in ``paddle_tpu/ops/kernels/nn.py``: ``swiglu`` (:58),
``linear`` (:91), ``embedding`` (:99), ``rms_norm`` (:124), ``rope``
(:679). They keep the reference's order of casts, so a bf16 model rounds
at the same places in both packages.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def swiglu(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """silu(x) * y."""
    return F.silu(x) * y


def linear(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """x @ W, W in Paddle's ``[in, out]`` layout (Llama's linears have no
    bias)."""
    return torch.matmul(x, weight)


def embedding(ids: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    return weight[ids.long()]


def rms_norm(x: torch.Tensor, weight: Optional[torch.Tensor] = None,
             epsilon: float = 1e-6) -> torch.Tensor:
    """Mean of squares in float32, cast back to ``x.dtype``, then the
    weight multiply (in the weight's dtype, as the reference does)."""
    acc = x.float()
    ms = acc.square().mean(dim=-1, keepdim=True)
    out = (acc * torch.rsqrt(ms + epsilon)).to(x.dtype)
    if weight is not None:
        out = out * weight
    return out


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def rope(q: torch.Tensor, k: Optional[torch.Tensor], cos: torch.Tensor,
         sin: torch.Tensor, position_ids: torch.Tensor
         ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Rotary embedding, rotate-half (neox) style.

    q/k ``[b, s, heads, head_dim]``; cos/sin float32 tables
    ``[max_pos, head_dim]``; position_ids ``[b, s]``. The tables are
    gathered at the positions in float32 and only then cast to q's dtype,
    as the reference does."""
    c = cos[position_ids.long()][:, :, None, :].to(q.dtype)
    s = sin[position_ids.long()][:, :, None, :].to(q.dtype)
    out_q = q * c + _rotate_half(q) * s
    if k is None:
        return out_q, None
    return out_q, k * c + _rotate_half(k) * s
