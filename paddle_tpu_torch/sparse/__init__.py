"""Block-sparse matrices: block-CSR from a dense matrix, and its product
with a dense one.

Counterpart of the BCSR entry of ``paddle_tpu/sparse/__init__.py``
(``bcsr_from_dense`` :310, ``bcsr_matmul`` :316), with the reference's
names and arguments. ``bcsr_matmul`` returns a ``torch.Tensor`` (the port
has no Tensor class yet) and runs where ``x`` lies: on the card through
the BCSR SpMM kernel (``ops/kernels/bcsr_spmm.py``), on the CPU through
its plain version. The reference's COO/CSR tensors are not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.device import DeviceLike, resolve_device
from ..ops.kernels import bcsr_spmm as _bcsr


def bcsr_from_dense(dense, block_m: int, block_k: int, tol: float = 0.0,
                    device: DeviceLike = None):
    """Tile a dense ``[M, K]`` matrix into block-CSR, dropping the blocks
    whose ``max |x| <= tol``: ``(crows [Mb+1], cols [NB])`` as int64 numpy
    and ``values [NB, block_m, block_k]`` on the dense's device. A numpy
    ``dense`` goes to ``device`` first (the card unless told otherwise)."""
    if not torch.is_tensor(dense):
        dense = torch.as_tensor(np.asarray(dense),
                                device=resolve_device(device))
    return _bcsr.bcsr_from_dense(dense, block_m, block_k, tol)


def bcsr_matmul(crows, cols, values: torch.Tensor,
                x: torch.Tensor) -> torch.Tensor:
    """Block-CSR sparse ``[Mb*bm, K]`` @ dense ``x [K, N]`` -> ``[Mb*bm, N]``
    in x's dtype, float32 sums."""
    return _bcsr.bcsr_spmm(crows, cols, values, x)


__all__ = ["bcsr_from_dense", "bcsr_matmul"]
