"""Round-2 tranche ops of ``paddle_tpu/ops/kernels/extra_misc.py``:
``top_p_sampling`` (:468, ``ops.yaml:619``), the sampling op the serving
slice brings, and the linalg and fft extras (:498-565,
``ops.yaml:622-626``): ``matrix_rank`` (the version the reference's
registry holds: the tolerance from ``finfo(x.dtype)``, a given ``tol``
broadcast over the batch), ``lu_unpack`` (``P, L, U`` from packed LU and
1-based pivots, whatever the two flags say, as the reference), and the
``fft_c2c`` / ``fft_r2c`` / ``fft_c2r`` kernels over ``torch.fft``
(``fft_c2r`` reads its half spectrum as pocketfft does:
``linalg_fft.hermitian_half``).

``top_p_sampling`` is ``key: true`` in the reference; here its draw comes
from ``generator=``, by default the port's generator for the logits'
device (``core.generator``). The bits cannot match threefry's: the op
matches the reference by support, shape, dtype and the top-p cut.
"""

from __future__ import annotations

from typing import Optional

import torch

from ...core.generator import generator_for
from ..dispatcher import register_kernel


@register_kernel("top_p_sampling")
def top_p_sampling(x: torch.Tensor, ps: torch.Tensor, threshold=None,
                   generator: Optional[torch.Generator] = None):
    """Per-row nucleus sampling: x ``[B, V]`` logits, ps ``[B]`` each row's
    p. Keeps the smallest set of the highest logits whose probability
    reaches p (at least one), draws one id a row from it. Returns
    ``(ids [B, 1] int64, scores [B, 1] float32)``, the score being the
    drawn id's softmax probability over all the logits. ``threshold`` is
    accepted and unused, as in the reference."""
    logits = x.float()
    sorted_l = torch.sort(logits, dim=-1, descending=True).values
    cum = torch.cumsum(torch.softmax(sorted_l, dim=-1), dim=-1)
    cut_idx = (cum < ps.float().reshape(-1, 1)).sum(dim=-1, keepdim=True)
    # the reference's gather clamps an index past the end (p = 1.0 with a
    # cumulative sum that rounds below it)
    cutoff = torch.gather(sorted_l, -1,
                          cut_idx.clamp(max=logits.shape[-1] - 1))
    filt = logits.masked_fill(logits < cutoff, float("-inf"))
    g = generator_for(logits.device, generator)
    ids = torch.multinomial(torch.softmax(filt, dim=-1), 1, generator=g)
    scores = torch.gather(torch.softmax(logits, dim=-1), -1, ids)
    return ids.to(torch.int64), scores


# -- linalg extras --------------------------------------------------------------

@register_kernel("matrix_rank")
def matrix_rank(x, tol=None, hermitian=False):
    if hermitian:
        s = torch.linalg.eigvalsh(x).abs()
    else:
        from .linalg_fft import svdvals_on
        s = svdvals_on(x)
    if tol is None:
        t = s.max(dim=-1, keepdim=True).values * max(x.shape[-2:]) * \
            torch.finfo(x.dtype).eps
    else:
        t = torch.as_tensor(tol, device=s.device, dtype=s.dtype)
        while t.dim() < s.dim():
            t = t[..., None]
    return (s > t).sum(dim=-1).to(torch.int32)


@register_kernel("lu_unpack")
def lu_unpack(x, y, unpack_ludata=True, unpack_pivots=True):
    """x: packed LU ``[.., M, N]``; y: 1-based pivots ``[.., min(M, N)]``.
    Returns ``(P, L, U)`` with ``A = P @ L @ U``."""
    P, L, U = torch.lu_unpack(x, y.to(torch.int32))
    return P, L, U


# -- fft kernels ------------------------------------------------------------------

def _axes(axes):
    return tuple(int(a) for a in ([axes] if isinstance(axes, int) else axes))


@register_kernel("fft_c2c")
def fft_c2c(x, axes=(-1,), normalization="backward", forward=True):
    fn = torch.fft.fftn if forward else torch.fft.ifftn
    return fn(x, dim=_axes(axes), norm=normalization)


@register_kernel("fft_r2c")
def fft_r2c(x, axes=(-1,), normalization="backward", forward=True,
            onesided=True):
    if onesided:
        return torch.fft.rfftn(x, dim=_axes(axes), norm=normalization)
    return torch.fft.fftn(x.to(torch.complex64), dim=_axes(axes),
                          norm=normalization)


@register_kernel("fft_c2r")
def fft_c2r(x, axes=(-1,), normalization="backward", forward=False,
            last_dim_size=0):
    from .linalg_fft import hermitian_half
    dims = _axes(axes)
    n = int(last_dim_size)
    s = None if not n else \
        tuple(x.shape[d] for d in dims[:-1]) + (n,)
    x, s = hermitian_half(x, s, dims)
    return torch.fft.irfftn(x, s=s, dim=dims, norm=normalization)
