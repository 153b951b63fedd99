"""paddle.fft: the registry's fft ops (``torch.fft``, cuFFT on the card).

Counterpart of ``paddle_tpu/fft.py``. These names live here only, not at
the top level of the package. Each keeps the boundary rule
(``ops.dispatcher.boundary_op``).
"""

from .ops.dispatcher import boundary_op as _op

fft = _op("fft")
ifft = _op("ifft")
rfft = _op("rfft")
irfft = _op("irfft")
hfft = _op("hfft")
ihfft = _op("ihfft")
fft2 = _op("fft2")
ifft2 = _op("ifft2")
rfft2 = _op("rfft2")
irfft2 = _op("irfft2")
fftn = _op("fftn")
ifftn = _op("ifftn")
fftshift = _op("fftshift")
ifftshift = _op("ifftshift")
fftfreq = _op("fftfreq")
rfftfreq = _op("rfftfreq")

__all__ = ["fft", "fft2", "fftfreq", "fftn", "fftshift", "hfft", "ifft",
           "ifft2", "ifftn", "ifftshift", "ihfft", "irfft", "irfft2",
           "rfft", "rfft2", "rfftfreq"]
