"""Grouped (ragged) GEMM: the MoE expert products.

Replaces ``paddle_tpu/ops/kernels/pallas/grouped_gemm.py``: ``_gmm_impl``
(:109, the Pallas kernels ``_gmm_kernel`` :52 and ``_gmm_wide_kernel``
:72), ``gmm_reference`` (:179), the custom VJP ``_gmm_bwd`` (:205) and the
public ``grouped_matmul`` (:222).

    grouped_matmul(x, w, counts, groups_per_expert=1) -> y
    x [G, C, K]; w [E, K, N], group g reads expert g // gpe (G = E * gpe);
    counts [G] int32, rows c >= counts[g] of y are zero; y [G, C, N].

What bounds it on the H100: bytes and operations nearly equally (the
weight of every expert with a live row, the live x rows and the whole y,
each once: ~0.17 ms per launch at the MoE training shapes, against ~0.14
ms of bf16 products). The kernels (``csrc/grouped_gemm.cu``): a block
reads ``counts[g]`` from device memory and skips a C tile past it, so
nothing syncs with the host and the products scale with the routed rows.
Sums are float32 and round once to x's dtype. bf16 with 16-byte-aligned
rows runs ``wgmma`` over a pipelined ring of ``cp.async`` tiles
(``csrc/gemm_wgmma.cuh``); other bf16 strides keep a WMMA kernel; float32
runs full float32 FMA on the CUDA cores over the pipelined ring of
``csrc/gemm_f32.cuh`` (``gmm_route`` says which).
``w`` is read through its strides, so the backward's dx reuses the kernel
on a transposed view of ``w`` without a copy.

The backward is the reference's: dx = the grouped product of dy with
``w`` transposed (through the kernel on the card); dw = the count-masked
``einsum("egck,egcn->ekn")`` with float32 sums, cast to w's dtype, left to
a library batched product as the reference leaves it to XLA. For bf16 on
the card that product takes bf16 inputs with a float32 output
(``torch.bmm(..., out_dtype=torch.float32)``: the same function as the
reference's float32 einsum over bf16 values, at the tensor cores' rate);
elsewhere it runs in float32.

Beside the kernel: ``gmm_plain``, the same function in plain PyTorch, used
for CPU tensors, by the tests and by ``chip_smoke.py``; and the launch
counter ``grouped_gemm``. The reference's auto rule (C <= 128 takes the
composite, ``:239-242``) was measured on a TPU and is not carried over:
``use_pallas=None`` means the kernel for a CUDA tensor.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build

launches = _build.LaunchCounter("grouped_gemm")

DTYPES = (torch.float32, torch.bfloat16)


def _live_rows(counts: torch.Tensor, C: int) -> torch.Tensor:
    """``[G, C]`` bool: row c of group g is live iff ``c < counts[g]``."""
    return torch.arange(C, device=counts.device)[None, :] < counts[:, None]


# -- plain version ------------------------------------------------------------

def gmm_plain(x: torch.Tensor, w: torch.Tensor, counts: torch.Tensor,
              groups_per_expert: int = 1) -> torch.Tensor:
    """The count-masked batched product (the reference's
    ``gmm_reference``): float32 sums, one rounding to x's dtype, rows at or
    past ``counts[g]`` zero."""
    rows = _live_rows(counts, x.shape[1])[..., None]
    xm = torch.where(rows, x, 0).float()
    wg = w.repeat_interleave(groups_per_expert, dim=0) \
        if groups_per_expert > 1 else w
    y = torch.bmm(xm, wg.float())
    return torch.where(rows, y, 0.0).to(x.dtype)


# -- kernel -------------------------------------------------------------------

ROUTES = ("f32_fma", "wmma", "wgmma")   # the C entry's route codes


def _bind(lib) -> None:
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ptt_grouped_gemm.argtypes = [P] * 4 + [I] * 5 + [L] * 5 + [I, P]
    lib.ptt_grouped_gemm.restype = ctypes.c_int
    lib.ptt_grouped_gemm_route.argtypes = [P, P, I, I] + [L] * 5 + [
        I, ctypes.POINTER(ctypes.c_int)]
    lib.ptt_grouped_gemm_route.restype = ctypes.c_int


def gmm_route(x: torch.Tensor, w: torch.Tensor) -> str:
    """The kernel the C entry launches for ``x @ w`` ("wgmma", "wmma" or
    "f32_fma"; "/k_major_w" when w's K axis is the contiguous one): its
    own choice, by dtype, strides and alignment (needs the built
    library)."""
    lib = _build.load("grouped_gemm", _bind)
    col_b = ctypes.c_int(0)
    code = lib.ptt_grouped_gemm_route(
        x.data_ptr(), w.data_ptr(), x.shape[2], w.shape[2], x.stride(0),
        x.stride(1), w.stride(0), w.stride(1), w.stride(2),
        _build.DTYPE_CODES[str(x.dtype).removeprefix("torch.")],
        ctypes.byref(col_b))
    return ROUTES[code] + ("/k_major_w" if col_b.value else "")


def _check(x, w, counts, gpe) -> None:
    if x.dim() != 3 or w.dim() != 3:
        raise ValueError(f"x must be [G, C, K] and w [E, K, N], got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if x.dtype not in DTYPES:
        raise ValueError(f"dtype {x.dtype}: the kernel takes {DTYPES}")
    if w.dtype != x.dtype:
        raise ValueError(f"w dtype {w.dtype} differs from x's {x.dtype}")
    G, _, K = x.shape
    E = w.shape[0]
    if w.shape[1] != K:
        raise ValueError(f"x's K {K} differs from w's {w.shape[1]}")
    if gpe < 1 or E * gpe != G:
        raise ValueError(f"G {G} is not E {E} x groups_per_expert {gpe}")
    if counts.dtype != torch.int32 or tuple(counts.shape) != (G,):
        raise ValueError(f"counts must be int32 [{G}], got {counts.dtype} "
                         f"{tuple(counts.shape)}")
    if x.device.type != "cuda":
        raise ValueError(f"grouped_gemm: no kernel for {x.device}")
    for name, t in (("w", w), ("counts", counts)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")


def gmm_kernel(x: torch.Tensor, w: torch.Tensor, counts: torch.Tensor,
               groups_per_expert: int = 1) -> torch.Tensor:
    """The kernel; same result as :func:`gmm_plain`. ``w`` may be any
    strided view; ``x`` needs its K axis contiguous (copied otherwise)."""
    _check(x, w, counts, groups_per_expert)
    if x.stride(-1) != 1:
        x = x.contiguous()
    G, C, K = x.shape
    N = w.shape[2]
    y = torch.empty((G, C, N), dtype=x.dtype, device=x.device)
    if y.numel() == 0 or K == 0:
        return y.zero_()
    lib = _build.load("grouped_gemm", _bind)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.ptt_grouped_gemm(
            x.data_ptr(), w.data_ptr(), y.data_ptr(), counts.data_ptr(),
            G, C, K, N, groups_per_expert, x.stride(0), x.stride(1),
            w.stride(0), w.stride(1), w.stride(2),
            _build.DTYPE_CODES[str(x.dtype).removeprefix("torch.")], stream)
    if rc != 0:
        raise RuntimeError(f"ptt_grouped_gemm launch failed: cudaError {rc}")
    launches.add()
    return y


# -- autograd -----------------------------------------------------------------

def grad_w(x: torch.Tensor, dy: torch.Tensor, counts: torch.Tensor,
           groups_per_expert: int, dtype: torch.dtype) -> torch.Tensor:
    """dw[e] = sum over the groups of e of xm[g]^T @ dym[g], float32 sums,
    cast to ``dtype`` (the reference's count-masked einsum)."""
    G, C, K = x.shape
    E, N = G // groups_per_expert, dy.shape[-1]
    rows = _live_rows(counts, C)[..., None]
    xm = torch.where(rows, x, 0).reshape(E, groups_per_expert * C, K)
    dym = torch.where(rows, dy, 0).reshape(E, groups_per_expert * C, N)
    if x.is_cuda and x.dtype == torch.bfloat16:
        dw = torch.bmm(xm.transpose(1, 2), dym, out_dtype=torch.float32)
    else:
        dw = torch.bmm(xm.float().transpose(1, 2), dym.float())
    return dw.to(dtype)


class _GroupedMatmul(torch.autograd.Function):
    """y = x @ w[g // gpe] per group; saves (x, w, counts). The kernel runs
    the forward and dx unless the caller asked for the plain version or x
    lies on the CPU."""

    @staticmethod
    def forward(ctx, x, w, counts, gpe, use_kernel):
        ctx.save_for_backward(x, w, counts)
        ctx.gpe = gpe
        ctx.use_kernel = use_kernel and x.device.type != "cpu"
        return (gmm_kernel if ctx.use_kernel else gmm_plain)(x, w, counts,
                                                              gpe)

    @staticmethod
    def backward(ctx, dy):
        x, w, counts = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = (gmm_kernel if ctx.use_kernel else gmm_plain)(
                dy, w.transpose(1, 2), counts, ctx.gpe)
        if ctx.needs_input_grad[1]:
            dw = grad_w(x, dy, counts, ctx.gpe, w.dtype)
        return dx, dw, None, None, None


def grouped_matmul(x: torch.Tensor, w: torch.Tensor,
                   counts: Optional[torch.Tensor] = None,
                   groups_per_expert: int = 1,
                   use_pallas: Optional[bool] = None) -> torch.Tensor:
    """Public entry. ``counts=None`` means every row of every group is
    valid. ``use_pallas=False`` asks for the plain version, as the
    reference's explicit flag does; ``None`` or ``True`` take the kernel
    for a CUDA tensor (raising on what it lacks) and the plain version for
    a CPU one."""
    G, C, _ = x.shape
    if counts is None:
        counts = torch.full((G,), C, dtype=torch.int32, device=x.device)
    elif counts.dtype != torch.int32:
        counts = counts.to(torch.int32)
    return _GroupedMatmul.apply(x, w, counts, int(groups_per_expert),
                                use_pallas is None or bool(use_pallas))
