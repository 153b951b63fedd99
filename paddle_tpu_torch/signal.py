"""paddle.signal: ``frame``, ``stft`` and ``istft``, the registry's
composites over the fft ops (``ops/kernels/linalg_fft.py``).

Counterpart of ``paddle_tpu/signal.py``. These names live here only, not
at the top level of the package. Each keeps the boundary rule
(``ops.dispatcher.boundary_op``).
"""

from .ops.dispatcher import boundary_op as _op

frame = _op("frame")
stft = _op("stft")
istft = _op("istft")

__all__ = ["frame", "stft", "istft"]
