"""Weight-only quantized GEMM: the int8/int4 serving matmul.

Replaces ``paddle_tpu/ops/kernels/pallas/weight_only_gemm.py``: ``_nibbles``
(:47), ``_unpack_int4`` (:56), ``dequantize`` (:63), ``quantize`` (:185),
``weight_only_matmul`` (:140) and the Pallas kernel ``_pallas_int4_matmul``
(:105, body ``_int4_gemm_kernel`` :77).

Layout (the reference's): a quantized weight is ``[k, n]`` int8; int4 is
``[k//2, n]`` int8, two nibbles per byte, row 2i in the low nibble and row
2i+1 in the high nibble. Scales are float32, ``[n]`` per channel or
``[k//gs, n]`` per group.

The function, on every route: x is rounded to bf16, multiplied with the
integer codes (exact in bf16 and in their products), summed in float32,
then scaled (per channel: after the sum, where the scale commutes out of
the dot; per group: the weight is dequantized group by group and rounded
to bf16 first) and cast to x's dtype.

Routes:

- per-channel int4, the serving path: the CUDA kernels
  (``csrc/weight_only_gemm.cu``) for a CUDA tensor, ``int4_matmul_plain``
  for a CPU one or when ``FLAGS_use_pallas_kernels`` is off. The C entry
  picks the route by shape (``plan``): m <= 64 (decode, bound by the
  packed weight's bytes) runs the weight as wgmma's A, unpacked in
  registers, with k split over enough blocks to fill the card and the
  slices summed in a fixed order from a float32 workspace that this
  wrapper allocates; m > 64 (prefill, bound by operations) runs 128 x 128
  wgmma tiles over a weight tile unpacked once per stage in shared
  memory; shapes whose rows are not 16-byte aligned (k % 8 or n % 16 !=
  0) keep a WMMA kernel. The scale lands on the output in the
  epilogue. The reference's ``tiles_ok`` rule (``:150-151``, a BlockSpec
  need of the TPU kernel) is dropped: every even k and any n works;
- int8 and per-group: XLA formulations in the reference, not Pallas; here
  plain torch code (a float32 product of the bf16 operands, then the
  scale).

Beside the kernel: ``int4_matmul_plain``, the reference's split-nibble
formulation (``:165-172``) in plain PyTorch, used for CPU tensors, by the
tests and by ``chip_smoke.py``; the launch counter
``weight_only_int4_gemm`` (one per call, whatever the route launches);
and ``int4_route``, the route and k slices of a product.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from ... import flags
from . import _build
from .quant_common import (INT4_BOUND, INT8_BOUND, absmax_scale,
                           dequantize_symmetric, quantize_symmetric)

launches = _build.LaunchCounter("weight_only_int4_gemm")

X_DTYPES = (torch.float32, torch.bfloat16)


def _nibbles(qweight: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``[k//2, n]`` packed bytes -> (lo, hi) int32 nibble planes, both
    sign-extended: lo = even weight rows, hi = odd rows."""
    w32 = qweight.to(torch.int32)
    lo = ((w32 & 0xF) ^ 8) - 8
    hi = w32 >> 4                    # arithmetic: the sign is kept
    return lo, hi


def _unpack_int4(qweight: torch.Tensor, n: int) -> torch.Tensor:
    """``[k//2, n]`` packed bytes -> ``[k, n]`` int8 nibble values."""
    lo, hi = _nibbles(qweight)
    return (torch.stack([lo, hi], dim=1)
            .reshape(qweight.shape[0] * 2, n).to(torch.int8))


def dequantize(qweight: torch.Tensor, scales: torch.Tensor, int4: bool,
               n: int) -> torch.Tensor:
    """Quantized weight -> float32 ``[k, n]``; the group size derives from
    the scales' row count (``[n]`` per channel, ``[k//gs, n]`` per
    group)."""
    w = _unpack_int4(qweight, n) if int4 else qweight
    k = w.shape[0]
    sc = scales.float()
    if sc.dim() == 1 or sc.shape[0] == 1:
        return dequantize_symmetric(w, sc.reshape(1, n))
    groups = sc.shape[0]
    return dequantize_symmetric(
        w.reshape(groups, k // groups, n), sc[:, None, :]).reshape(k, n)


def quantize(w: torch.Tensor, weight_dtype: str = "int8",
             group_size: int = -1) -> Tuple[torch.Tensor, torch.Tensor]:
    """float32/bf16 weight ``[k, n]`` -> (qweight, scales) in the layout
    above: symmetric absmax, per channel (``group_size=-1``) or per
    group, bitwise equal to the reference's ``weight_quantize`` op."""
    int4 = weight_dtype == "int4"
    k, n = w.shape
    if int4 and k % 2:
        raise ValueError(
            f"weight_only_int4 packs two rows per byte and requires an even "
            f"k (got k={k}); pad the weight's in_features to a multiple of 2")
    bound = INT4_BOUND if int4 else INT8_BOUND
    wf = w.float()
    if group_size > 0:
        groups = k // group_size
        wg = wf.reshape(groups, group_size, n)
        scales = absmax_scale(wg, 1, bound)                  # [groups, n]
        q = quantize_symmetric(wg, scales[:, None, :], bound).reshape(k, n)
    else:
        scales = absmax_scale(wf, 0, bound)                  # [n]
        q = quantize_symmetric(wf, scales[None, :], bound)
    if int4:
        # the byte (hi << 4) | lo as 0..255 in int32, reinterpreted as
        # int8 through uint8 (the reference's wrapping int8 shift)
        lo = q[0::2].to(torch.int32) & 0xF
        hi = q[1::2].to(torch.int32) & 0xF
        q = ((hi << 4) | lo).to(torch.uint8).view(torch.int8)  # [k//2, n]
    return q, scales


def _dot_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b over bf16-exact values with float32 sums (TF32 is off)."""
    return torch.matmul(a.float(), b.float())


# -- plain version ------------------------------------------------------------

def int4_matmul_plain(x: torch.Tensor, qweight: torch.Tensor,
                      scales: torch.Tensor) -> torch.Tensor:
    """Per-channel int4: ``(bf16(x)[:, 0::2] @ lo + bf16(x)[:, 1::2] @ hi)
    * s`` with float32 sums, cast to x's dtype (the reference's
    split-nibble formulation, ``:165-172``)."""
    n = qweight.shape[1]
    lo, hi = _nibbles(qweight)
    xb = x.to(torch.bfloat16)
    acc = _dot_f32(xb[:, 0::2], lo) + _dot_f32(xb[:, 1::2], hi)
    return (acc * scales.reshape(1, n).float()).to(x.dtype)


# -- kernel -------------------------------------------------------------------

ROUTES = ("wmma", "decode", "prefill")   # the C entry's route codes


def _bind(lib) -> None:
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.ptt_weight_only_int4_gemm.argtypes = [P] * 5 + [I] * 4 + [P]
    lib.ptt_weight_only_int4_gemm.restype = ctypes.c_int
    lib.ptt_weight_only_int4_gemm_plan.argtypes = [I] * 4 + [
        ctypes.POINTER(ctypes.c_int)]
    lib.ptt_weight_only_int4_gemm_plan.restype = ctypes.c_int


@functools.lru_cache(maxsize=None)
def _plan(m: int, n: int, k: int, aligned: bool) -> Tuple[str, int]:
    lib = _build.load("weight_only_gemm", _bind)
    slices = ctypes.c_int(1)
    code = lib.ptt_weight_only_int4_gemm_plan(m, n, k, int(aligned),
                                              ctypes.byref(slices))
    return ROUTES[code], slices.value


def int4_route(x: torch.Tensor, qweight: torch.Tensor) -> Tuple[str, int]:
    """(route, k slices) the kernel takes for ``x @ dequant(qweight)``:
    the C entry's own choice, by shape and alignment (needs the built
    library)."""
    m, k = x.shape
    return _plan(m, qweight.shape[1], k,
                 x.data_ptr() % 16 == 0 and qweight.data_ptr() % 16 == 0)


def _check(x, qweight, scales) -> None:
    if x.dim() != 2 or qweight.dim() != 2:
        raise ValueError(f"x must be [m, k] and qweight [k//2, n], got "
                         f"{tuple(x.shape)} and {tuple(qweight.shape)}")
    if x.dtype not in X_DTYPES:
        raise ValueError(f"x dtype {x.dtype}: the kernel takes {X_DTYPES}")
    if qweight.dtype != torch.int8:
        raise ValueError(f"qweight must be int8, got {qweight.dtype}")
    k, (k2, n) = x.shape[1], qweight.shape
    if k != 2 * k2:
        raise ValueError(f"x's k {k} is not twice qweight's {k2} packed rows")
    if scales.numel() != n:
        raise ValueError(f"per-channel scales must hold n={n} values, got "
                         f"{tuple(scales.shape)}")
    if x.device.type != "cuda":
        raise ValueError(f"weight_only_int4_gemm: no kernel for {x.device}")
    for name, t in (("qweight", qweight), ("scales", scales)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")


def int4_matmul_kernel(x: torch.Tensor, qweight: torch.Tensor,
                       scales: torch.Tensor) -> torch.Tensor:
    """The kernel; same function as :func:`int4_matmul_plain`. A float32 x
    is rounded to bf16 here, as the reference does; the output keeps x's
    dtype."""
    _check(x, qweight, scales)
    m, k = x.shape
    n = qweight.shape[1]
    xb = x.to(torch.bfloat16).contiguous()
    q = qweight.contiguous()
    s = scales.reshape(n).float().contiguous()
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if y.numel() == 0 or k == 0:
        return y.zero_()
    lib = _build.load("weight_only_gemm", _bind)
    _, slices = int4_route(xb, q)
    ws = torch.empty((slices, m, n), dtype=torch.float32,
                     device=x.device) if slices > 1 else None
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.ptt_weight_only_int4_gemm(
            xb.data_ptr(), q.data_ptr(), s.data_ptr(), y.data_ptr(),
            None if ws is None else ws.data_ptr(), m, n, k,
            _build.DTYPE_CODES[str(x.dtype).removeprefix("torch.")], stream)
    if rc != 0:
        raise RuntimeError(f"ptt_weight_only_int4_gemm launch failed: "
                           f"cudaError {rc}")
    launches.add()
    return y


# -- the public product ---------------------------------------------------------

def weight_only_matmul(x: torch.Tensor, qweight: torch.Tensor,
                       scales: torch.Tensor, weight_dtype: str = "int8",
                       group_size: int = -1) -> torch.Tensor:
    """x ``[m, k]`` (float32/bf16) @ dequant(qweight) -> ``[m, n]`` in x's
    dtype. Per-channel int4 launches the kernel for a CUDA tensor (raising
    on what it lacks) unless ``FLAGS_use_pallas_kernels`` is off, and takes
    the plain version for a CPU one."""
    int4 = weight_dtype == "int4"
    n = qweight.shape[1]
    per_channel = scales.dim() == 1 or scales.shape[0] == 1
    if int4 and per_channel:
        if x.device.type != "cpu" and flags.get_flag("use_pallas_kernels"):
            return int4_matmul_kernel(x, qweight, scales)
        return int4_matmul_plain(x, qweight, scales)
    q = _unpack_int4(qweight, n) if int4 else qweight
    xb = x.to(torch.bfloat16)
    if per_channel:
        acc = _dot_f32(xb, q)
        return (acc * scales.reshape(1, n).float()).to(x.dtype)
    # per group: the scales do not commute; dequantize group-wise, round
    # the weight to bf16, then the product
    w = dequantize(q, scales, False, n).to(torch.bfloat16)
    return _dot_f32(xb, w).to(x.dtype)
