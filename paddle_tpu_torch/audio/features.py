"""Audio feature layers: ``Spectrogram``, ``MelSpectrogram``,
``LogMelSpectrogram`` and ``MFCC``.

Counterpart of ``paddle_tpu/audio/features.py`` (Paddle's
``audio/features/layers.py``). Each is an ``nn.Layer`` over the
registry's ``stft`` (``ops/kernels/linalg_fft.py``); its window, mel
filter bank and DCT matrix are buffers, made on the port's current device
and moved with the layer by ``.to(device)``. The input is a waveform
``[..., T]``; the outputs are ``[..., bins or n_mels or n_mfcc,
frames]``.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..nn.layer_base import Layer
from ..ops.dispatcher import get_op
from . import functional as F

__all__ = ["Spectrogram", "MelSpectrogram", "LogMelSpectrogram", "MFCC"]


class Spectrogram(Layer):
    def __init__(self, n_fft: int = 512, hop_length: Optional[int] = None,
                 win_length: Optional[int] = None, window: str = "hann",
                 power: float = 2.0, center: bool = True,
                 pad_mode: str = "reflect", dtype: str = "float32"):
        super().__init__()
        self.n_fft = n_fft
        self.hop_length = hop_length or n_fft // 4
        self.win_length = win_length or n_fft
        self.power = power
        self.center = center
        self.pad_mode = pad_mode
        self.register_buffer("fft_window", F.get_window(
            window, self.win_length, fftbins=True))

    def forward(self, x):
        spec = get_op("stft")(x, self.n_fft, hop_length=self.hop_length,
                              win_length=self.win_length,
                              window=self.fft_window, center=self.center,
                              pad_mode=self.pad_mode)
        mag = spec.abs()
        return mag if self.power == 1.0 else mag ** self.power


class MelSpectrogram(Layer):
    def __init__(self, sr: int = 22050, n_fft: int = 512,
                 hop_length: Optional[int] = None,
                 win_length: Optional[int] = None, window: str = "hann",
                 power: float = 2.0, center: bool = True,
                 pad_mode: str = "reflect", n_mels: int = 64,
                 f_min: float = 50.0, f_max: Optional[float] = None,
                 htk: bool = False, norm: str = "slaney",
                 dtype: str = "float32"):
        super().__init__()
        self.spectrogram = Spectrogram(n_fft, hop_length, win_length, window,
                                       power, center, pad_mode, dtype)
        self.register_buffer("fbank", F.compute_fbank_matrix(
            sr, n_fft, n_mels, f_min, f_max, htk, norm))

    def forward(self, x):
        return torch.matmul(self.fbank, self.spectrogram(x))


class LogMelSpectrogram(Layer):
    def __init__(self, sr: int = 22050, ref_value: float = 1.0,
                 amin: float = 1e-10, top_db: Optional[float] = None,
                 **mel_kwargs):
        super().__init__()
        self.mel = MelSpectrogram(sr=sr, **mel_kwargs)
        self.ref_value = ref_value
        self.amin = amin
        self.top_db = top_db

    def forward(self, x):
        return F._power_to_db(self.mel(x), self.ref_value, self.amin,
                              self.top_db)


class MFCC(Layer):
    def __init__(self, sr: int = 22050, n_mfcc: int = 40,
                 top_db: Optional[float] = None, **mel_kwargs):
        super().__init__()
        n_mels = mel_kwargs.get("n_mels", 64)
        self.log_mel = LogMelSpectrogram(sr=sr, top_db=top_db, **mel_kwargs)
        self.register_buffer("dct", F.create_dct(n_mfcc, n_mels))

    def forward(self, x):
        return torch.einsum("mk,...mf->...kf", self.dct, self.log_mel(x))
