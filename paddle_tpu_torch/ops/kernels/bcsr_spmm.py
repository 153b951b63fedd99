"""Block-CSR sparse @ dense matmul (SpMM).

Replaces ``paddle_tpu/ops/kernels/pallas/bcsr_spmm.py``: ``bcsr_spmm``
(:50, the ``pallas_call`` of ``_kernel`` at :93), ``bcsr_from_dense``
(:108) and the dense-reconstruction golden ``bcsr_spmm_reference``
(:130).

Layout (BCSR): the ``[M, K]`` sparse matrix is tiled into ``bm x bk``
blocks; ``crows [Mb+1]`` indexes each block row's nonzero blocks,
``cols [NB]`` holds each block's column-block id and ``values [NB, bm,
bk]`` the blocks. ``bcsr_spmm(crows, cols, values, x)`` with ``x [K, N]``
gives ``[Mb*bm, N]`` in x's dtype, float32 sums, zero rows where a block
row has no block.

What bounds it on the H100: operations at the block-pruned MLP shapes it
serves (2·bm·bk·N per kept block: 240.5 GFLOP for half of Llama-3-8B's
``gate_proj`` in 128 x 128 blocks times 4096 columns, against 210 MB).
The kernel (``csrc/bcsr_spmm.cu``) gives each CTA one (tile of a block
row, N tile); it walks its block row's run ``crows[i]..crows[i+1]`` on the
device and writes its tile once. bf16 with 16-byte-aligned rows (values
and x aligned, x's row stride a multiple of 8) runs the run's 64-deep
block slices through the pipelined ``wgmma`` ring of
``csrc/gemm_wgmma.cuh`` (64- or 128-row M tiles by ``bm``); other bf16
inputs take the first design's WMMA kernel; float32 runs full float32
FMA on the CUDA cores over the pipelined ring of ``csrc/gemm_f32.cuh``
(16-, 32-, 64- or 128-row M tiles by ``bm``). ``bcsr_route`` says which.
Both pipelined routes launch block rows with the most kept blocks first
(``row_order``). ``crows``, ``cols`` and the order go to the
device as int32; x is read in place with its N tail masked, where the
reference pads N to 128 lanes.

Beside the kernel: ``bcsr_spmm_plain``, the same function in plain
PyTorch (one float32 product per block, summed per block row with
``index_add_``), used for CPU tensors, by the tests and by
``chip_smoke.py``; ``bcsr_spmm_reference``, the reference's golden; and
``launches``, the count of kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from . import _build

launches = _build.LaunchCounter("bcsr_spmm")

DTYPES = (torch.float32, torch.bfloat16)


def bcsr_from_dense(dense: torch.Tensor, bm: int, bk: int, tol: float = 0.0
                    ) -> Tuple[np.ndarray, np.ndarray, torch.Tensor]:
    """Tile a dense ``[M, K]`` tensor into BCSR, keeping each block whose
    ``max |x| > tol``, in row-major block order. Runs on the dense's
    device; returns ``(crows [Mb+1] int64 numpy, cols [NB] int64 numpy,
    values [NB, bm, bk])``, values in the dense's dtype and device."""
    M, K = dense.shape
    if M % bm or K % bk:
        raise ValueError(f"[{M}, {K}] does not tile into {bm} x {bk} blocks")
    Mb, Kb = M // bm, K // bk
    blocks = dense.reshape(Mb, bm, Kb, bk).permute(0, 2, 1, 3)
    keep = blocks.abs().amax(dim=(2, 3)) > tol                # [Mb, Kb]
    keep_np = keep.cpu().numpy()
    crows = np.zeros(Mb + 1, np.int64)
    crows[1:] = np.cumsum(keep_np.sum(axis=1))
    cols = np.nonzero(keep_np)[1].astype(np.int64)
    return crows, cols, blocks[keep].contiguous()


def _rows_of(crows: np.ndarray) -> np.ndarray:
    """Each block's block row, in CSR order."""
    return np.repeat(np.arange(len(crows) - 1), np.diff(crows))


def bcsr_spmm_plain(crows, cols, values: torch.Tensor, x: torch.Tensor
                    ) -> torch.Tensor:
    """Plain PyTorch version: each block's ``[bk, N]`` slice of x, one
    float32 product per block, summed per block row by a float32
    ``index_add_``; x's dtype out, empty block rows zero."""
    crows, cols = np.asarray(crows), np.asarray(cols)
    NB, bm, bk = values.shape
    Mb = len(crows) - 1
    K, N = x.shape
    out = torch.zeros((Mb, bm, N), dtype=torch.float32, device=x.device)
    if NB:
        dev = x.device
        xb = x.reshape(K // bk, bk, N)[torch.from_numpy(cols).to(dev)]
        prod = torch.bmm(values.float(), xb.float())       # [NB, bm, N]
        out.index_add_(0, torch.from_numpy(_rows_of(crows)).to(dev), prod)
    return out.reshape(Mb * bm, N).to(x.dtype)


def bcsr_spmm_reference(crows, cols, values: torch.Tensor, x: torch.Tensor
                        ) -> torch.Tensor:
    """The reference's golden: the dense matrix rebuilt from the blocks,
    times x."""
    crows, cols = np.asarray(crows), np.asarray(cols)
    NB, bm, bk = values.shape
    Mb, K = len(crows) - 1, x.shape[0]
    dense = torch.zeros((Mb * bm, K), dtype=values.dtype, device=x.device)
    if NB:
        view = dense.view(Mb, bm, K // bk, bk).permute(0, 2, 1, 3)
        dev = x.device
        view[torch.from_numpy(_rows_of(crows)).to(dev),
             torch.from_numpy(cols).to(dev)] = values
    return dense @ x


# -- kernel -------------------------------------------------------------------

ROUTES = ("f32_fma", "wmma", "wgmma")   # ptt_bcsr_spmm_route's codes


def _bind(lib) -> None:
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ptt_bcsr_spmm.argtypes = [P] * 6 + [I] * 4 + [L, I, P]
    lib.ptt_bcsr_spmm.restype = I
    lib.ptt_bcsr_spmm_route.argtypes = [P, P, I, L, I]
    lib.ptt_bcsr_spmm_route.restype = I


def _dtype_code(t: torch.Tensor) -> int:
    return _build.DTYPE_CODES[str(t.dtype).removeprefix("torch.")]


def bcsr_route(values: torch.Tensor, x: torch.Tensor) -> str:
    """The kernel the C entry launches for ``values @ x`` ("wgmma", "wmma"
    or "f32_fma"): its own choice, by dtype, alignment and x's row stride
    (needs the built library)."""
    lib = _build.load("bcsr_spmm", _bind)
    return ROUTES[lib.ptt_bcsr_spmm_route(
        values.data_ptr(), x.data_ptr(), values.shape[2], x.stride(0),
        _dtype_code(x))]


def row_order(crows: np.ndarray) -> np.ndarray:
    """The block rows by kept blocks, most first (ties in row order), as
    int32: launched in this order, the grid's last CTAs are short ones."""
    return np.argsort(-np.diff(crows), kind="stable").astype(np.int32)


def device_structure(crows, cols, nb: int, kb: int, device
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``crows`` and ``cols`` checked on the host (``crows`` runs from 0 to
    ``nb`` without falling, every column id below ``kb``) and put on
    ``device`` as int32, as the kernel reads them, with the block rows'
    launch order (:func:`row_order`)."""
    crows = np.asarray(crows.cpu() if torch.is_tensor(crows) else crows)
    cols = np.asarray(cols.cpu() if torch.is_tensor(cols) else cols)
    if crows.ndim != 1 or len(crows) < 1 or crows[0] != 0 or \
            crows[-1] != nb or (np.diff(crows) < 0).any():
        raise ValueError(f"crows must run from 0 to NB={nb} without falling")
    if cols.shape != (nb,) or (nb and (cols.min() < 0 or cols.max() >= kb)):
        raise ValueError(f"cols must be [{nb}] column-block ids below {kb}")
    put = lambda a: torch.from_numpy(  # noqa: E731
        a.astype(np.int32)).to(device)
    return put(crows), put(cols), put(row_order(crows))


def _check(values, x) -> None:
    if values.dim() != 3 or x.dim() != 2:
        raise ValueError(f"values must be [NB, bm, bk] and x [K, N], got "
                         f"{tuple(values.shape)} and {tuple(x.shape)}")
    if x.dtype not in DTYPES or values.dtype != x.dtype:
        raise ValueError(f"values {values.dtype}, x {x.dtype}: the kernel "
                         f"takes {DTYPES}, both alike")
    _, bm, bk = values.shape
    if x.dtype == torch.bfloat16 and (bm % 16 or bk % 16):
        raise ValueError(f"bf16 blocks of {bm} x {bk}: the kernel needs bm "
                         f"and bk to be multiples of 16")
    if x.shape[0] % bk:
        raise ValueError(f"K={x.shape[0]} not divisible by block k={bk}")
    if values.device != x.device:
        raise ValueError(f"values on {values.device}, x on {x.device}")


def bcsr_spmm_kernel(crows_d: torch.Tensor, cols_d: torch.Tensor,
                     order_d: torch.Tensor, values: torch.Tensor,
                     x: torch.Tensor) -> torch.Tensor:
    """One kernel launch; same result as :func:`bcsr_spmm_plain`.
    ``crows_d``, ``cols_d`` and ``order_d`` are the int32 device tensors of
    :func:`device_structure`; ``x`` is read in place when its rows are
    contiguous (copied otherwise)."""
    _check(values, x)
    if x.device.type != "cuda":
        raise ValueError(f"bcsr_spmm: no kernel for {x.device}")
    for name, t in (("crows", crows_d), ("cols", cols_d), ("order", order_d)):
        if t.dtype != torch.int32 or t.device != x.device:
            raise ValueError(f"{name} must be int32 on {x.device}")
    if x.stride(-1) != 1:
        x = x.contiguous()
    values = values.contiguous()
    Mb = crows_d.shape[0] - 1
    _, bm, bk = values.shape
    N = x.shape[1]
    if tuple(order_d.shape) != (Mb,):
        raise ValueError(f"order must be [{Mb}], got {tuple(order_d.shape)}")
    y = torch.empty((Mb * bm, N), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    lib = _build.load("bcsr_spmm", _bind)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.ptt_bcsr_spmm(
            crows_d.data_ptr(), cols_d.data_ptr(), order_d.data_ptr(),
            values.data_ptr(), x.data_ptr(), y.data_ptr(), Mb, bm, bk, N,
            x.stride(0), _dtype_code(x), stream)
    if rc != 0:
        raise RuntimeError(f"bcsr_spmm kernel launch failed: cudaError {rc}")
    launches.add()
    return y


def bcsr_spmm(crows, cols, values: torch.Tensor, x: torch.Tensor
              ) -> torch.Tensor:
    """``(crows [Mb+1], cols [NB], values [NB, bm, bk]) @ x [K, N]`` ->
    ``[Mb*bm, N]`` in x's dtype. ``crows``/``cols`` as numpy arrays (or
    tensors); a CPU ``x`` takes the plain version, a CUDA ``x`` launches
    the kernel or raises."""
    if x.device.type == "cpu":
        return bcsr_spmm_plain(crows, cols, values, x)
    _check(values, x)
    structure = device_structure(crows, cols, values.shape[0],
                                 x.shape[0] // values.shape[2], x.device)
    return bcsr_spmm_kernel(*structure, values, x)


__all__ = ["bcsr_from_dense", "bcsr_route", "bcsr_spmm", "bcsr_spmm_plain",
           "bcsr_spmm_reference", "bcsr_spmm_kernel", "device_structure",
           "launches", "row_order"]
