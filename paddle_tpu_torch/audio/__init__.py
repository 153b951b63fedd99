"""paddle.audio: the feature layers, the DSP functions, file I/O and the
classification datasets.

Counterpart of ``paddle_tpu/audio/__init__.py``: ``features``
(``Spectrogram``, ``MelSpectrogram``, ``LogMelSpectrogram``, ``MFCC``),
``functional`` (the mel scale, filter banks, the DCT, ``power_to_db``,
``get_window``), ``backends`` (``info``, ``load``, ``save``) and
``datasets`` (``ESC50``, ``TESS``).
"""

from . import backends  # noqa: F401
from . import datasets  # noqa: F401
from . import features  # noqa: F401
from . import functional  # noqa: F401
from .backends import info, load, save  # noqa: F401
from .features import (MFCC, LogMelSpectrogram,  # noqa: F401
                       MelSpectrogram, Spectrogram)

__all__ = ["functional", "features", "backends", "datasets",
           "Spectrogram", "MelSpectrogram", "LogMelSpectrogram", "MFCC",
           "info", "load", "save"]
