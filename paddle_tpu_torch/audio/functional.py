"""Audio DSP functions: the mel scale, filter banks, the DCT, decibels and
the windows.

Counterpart of ``paddle_tpu/audio/functional.py`` (Paddle's
``audio/functional/functional.py`` and ``window.py``), a copy of its own:
the port imports nothing of the JAX package. A function that makes a
tensor from sizes alone (``compute_fbank_matrix``, ``create_dct``,
``get_window``, ``mel_frequencies``, ``fft_frequencies``) makes it on the
port's current device (``core.device.set_device``: the card unless the
caller chose the CPU), in float32. The window table holds the reference's
16 windows (``_WINDOWS``); those it computes in numpy are computed in
float64 here and rounded to float32 once.
"""

from __future__ import annotations

import math
from typing import Optional, Union

import numpy as np
import torch

from ..core.device import layer_device
from ..core.tensor import paddle_call

__all__ = ["hz_to_mel", "mel_to_hz", "mel_frequencies", "fft_frequencies",
           "compute_fbank_matrix", "create_dct", "power_to_db",
           "get_window"]

_F_SP = 200.0 / 3
_MIN_LOG_HZ = 1000.0
_MIN_LOG_MEL = _MIN_LOG_HZ / _F_SP
_LOGSTEP = math.log(6.4) / 27.0


def _hz_to_mel(f, htk):
    if htk:
        return 2595.0 * torch.log10(1.0 + f / 700.0)
    mel = f / _F_SP
    return torch.where(f >= _MIN_LOG_HZ,
                       _MIN_LOG_MEL + torch.log(f.clamp(min=1e-10)
                                                / _MIN_LOG_HZ) / _LOGSTEP,
                       mel)


def _mel_to_hz(m, htk):
    if htk:
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)
    return torch.where(m >= _MIN_LOG_MEL,
                       _MIN_LOG_HZ * torch.exp(_LOGSTEP * (m - _MIN_LOG_MEL)),
                       _F_SP * m)


def _scalar_or_tensor(fn, v, htk):
    if isinstance(v, torch.Tensor):
        return paddle_call(lambda t: fn(t.float(), htk), (v,), {})
    return float(fn(torch.tensor(float(v), dtype=torch.float32), htk))


def hz_to_mel(freq: Union[float, torch.Tensor], htk: bool = False):
    """Hertz to mel (Slaney's scale by default, HTK's with ``htk``): a
    float for a float, a tensor for a tensor."""
    return _scalar_or_tensor(_hz_to_mel, freq, htk)


def mel_to_hz(mel: Union[float, torch.Tensor], htk: bool = False):
    """Mel to hertz, the inverse of :func:`hz_to_mel`."""
    return _scalar_or_tensor(_mel_to_hz, mel, htk)


def _mel_frequencies(n_mels, f_min, f_max, htk, device):
    lo, hi = hz_to_mel(f_min, htk), hz_to_mel(f_max, htk)
    mels = torch.linspace(lo, hi, n_mels, dtype=torch.float32, device=device)
    return _mel_to_hz(mels, htk)


def mel_frequencies(n_mels: int = 64, f_min: float = 0.0,
                    f_max: float = 11025.0, htk: bool = False):
    """``n_mels`` frequencies (Hz) evenly spaced on the mel scale."""
    return _mel_frequencies(n_mels, f_min, f_max, htk, layer_device())


def fft_frequencies(sr: int, n_fft: int):
    """The ``1 + n_fft // 2`` bin centre frequencies (Hz)."""
    return torch.linspace(0, sr / 2, 1 + n_fft // 2, dtype=torch.float32,
                          device=layer_device())


def compute_fbank_matrix(sr: int, n_fft: int, n_mels: int = 64,
                         f_min: float = 0.0, f_max: Optional[float] = None,
                         htk: bool = False, norm: str = "slaney"):
    """The triangular mel filter bank ``[n_mels, 1 + n_fft // 2]``,
    Slaney-normalised by default."""
    f_max = f_max or sr / 2.0
    dev = layer_device()
    fftfreqs = torch.linspace(0, sr / 2, 1 + n_fft // 2,
                              dtype=torch.float32, device=dev)
    mel_f = _mel_frequencies(n_mels + 2, f_min, f_max, htk, dev)
    fdiff = torch.diff(mel_f)
    ramps = mel_f[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = torch.minimum(lower, upper).clamp(min=0)
    if norm == "slaney":
        enorm = 2.0 / (mel_f[2:n_mels + 2] - mel_f[:n_mels])
        weights = weights * enorm[:, None]
    return weights


def create_dct(n_mfcc: int, n_mels: int, norm: Optional[str] = "ortho"):
    """The DCT-II matrix ``[n_mels, n_mfcc]``."""
    dev = layer_device()
    n = torch.arange(n_mels, dtype=torch.float32, device=dev)
    k = torch.arange(n_mfcc, dtype=torch.float32, device=dev)[None, :]
    dct = torch.cos(math.pi / n_mels * (n[:, None] + 0.5) * k)
    if norm == "ortho":
        dct[:, 0] *= 1.0 / math.sqrt(2.0)
        dct = dct * math.sqrt(2.0 / n_mels)
    else:
        dct = dct * 2.0
    return dct


def _power_to_db(x, ref_value, amin, top_db):
    db = 10.0 * torch.log10(x.clamp(min=amin))
    db = db - 10.0 * math.log10(max(float(ref_value), amin))
    if top_db is not None:
        db = torch.maximum(db, db.max() - top_db)
    return db


def power_to_db(spect, ref_value: float = 1.0, amin: float = 1e-10,
                top_db: Optional[float] = 80.0):
    """Power to decibels, ``10 log10(max(x, amin) / ref)``; with ``top_db``
    floored at ``top_db`` under the largest value of the whole tensor."""
    return paddle_call(_power_to_db, (spect, ref_value, amin, top_db), {})


# -- windows ---------------------------------------------------------------------

_WINDOWS = {}


def _window(name):
    def deco(fn):
        _WINDOWS[name] = fn
        return fn
    return deco


def _sym(fn, n, fftbins, *args):
    """``fn(m, *args)`` over ``m = n + 1`` points, the last dropped, for
    an FFT window (periodic); over ``n`` points for a symmetric one."""
    w = fn(n + 1 if fftbins else n, *args)
    return w[:-1] if fftbins else w


@_window("hann")
def _hann(n, fftbins=True):
    return _sym(np.hanning, n, fftbins)


@_window("hamming")
def _hamming(n, fftbins=True):
    return _sym(np.hamming, n, fftbins)


@_window("blackman")
def _blackman(n, fftbins=True):
    return _sym(np.blackman, n, fftbins)


@_window("rect")
def _rect(n, fftbins=True):
    return np.ones(n)


@_window("bartlett")
def _bartlett(n, fftbins=True):
    return _sym(np.bartlett, n, fftbins)


@_window("kaiser")
def _kaiser(n, fftbins=True, beta=12.0):
    return _sym(np.kaiser, n, fftbins, beta)


def _gaussian_m(m, std):
    i = np.arange(m) - (m - 1) / 2
    return np.exp(-0.5 * (i / std) ** 2)


@_window("gaussian")
def _gaussian(n, fftbins=True, std=7.0):
    return _sym(_gaussian_m, n, fftbins, std)


def _general_gaussian_m(m, p, sig):
    i = np.arange(m) - (m - 1) / 2
    return np.exp(-0.5 * np.abs(i / sig) ** (2 * p))


@_window("general_gaussian")
def _general_gaussian(n, fftbins=True, p=1.0, sig=7.0):
    """``w[i] = exp(-0.5 |i / sig| ^ (2p))``."""
    return _sym(_general_gaussian_m, n, fftbins, p, sig)


def _general_cosine_m(m, a):
    fac = np.linspace(-np.pi, np.pi, m)
    w = np.zeros(m)
    for k, coef in enumerate(a):
        w += coef * np.cos(k * fac)
    return w


@_window("general_cosine")
def _general_cosine(n, fftbins=True, a=(0.5, 0.5)):
    return _sym(_general_cosine_m, n, fftbins, a)


@_window("general_hamming")
def _general_hamming(n, fftbins=True, alpha=0.54):
    return _general_cosine(n, fftbins, (alpha, 1.0 - alpha))


def _triang_m(m):
    i = np.arange(1, (m + 1) // 2 + 1)
    if m % 2 == 0:
        half = (2 * i - 1.0) / m
        return np.concatenate([half, half[::-1]])
    half = 2 * i / (m + 1.0)
    return np.concatenate([half, half[-2::-1]])


@_window("triang")
def _triang(n, fftbins=True):
    return _sym(_triang_m, n, fftbins)


def _bohman_m(m):
    fac = np.abs(np.linspace(-1, 1, m)[1:-1])
    mid = (1 - fac) * np.cos(np.pi * fac) + 1.0 / np.pi * np.sin(np.pi * fac)
    return np.r_[0.0, mid, 0.0]


@_window("bohman")
def _bohman(n, fftbins=True):
    return _sym(_bohman_m, n, fftbins)


def _cosine_m(m):
    return np.sin(math.pi / m * (np.arange(m) + 0.5))


@_window("cosine")
def _cosine(n, fftbins=True):
    return _sym(_cosine_m, n, fftbins)


def _tukey_m(m, alpha):
    if alpha <= 0:
        return np.ones(m)
    if alpha >= 1.0:
        return np.hanning(m)
    i = np.arange(m)
    width = int(np.floor(alpha * (m - 1) / 2.0))
    n1, n2, n3 = i[:width + 1], i[width + 1:m - width - 1], \
        i[m - width - 1:]
    w1 = 0.5 * (1 + np.cos(np.pi * (-1 + 2.0 * n1 / alpha / (m - 1))))
    w2 = np.ones(n2.shape[0])
    w3 = 0.5 * (1 + np.cos(np.pi * (-2.0 / alpha + 1
                                    + 2.0 * n3 / alpha / (m - 1))))
    return np.concatenate([w1, w2, w3])


@_window("tukey")
def _tukey(n, fftbins=True, alpha=0.5):
    return _sym(_tukey_m, n, fftbins, alpha)


def _exponential_m(m, center, tau):
    c = (m - 1) / 2 if center is None else center
    return np.exp(-np.abs(np.arange(m) - c) / tau)


@_window("exponential")
def _exponential(n, fftbins=True, center=None, tau=1.0):
    return _sym(_exponential_m, n, fftbins, center, tau)


def _taylor_m(m, nbar, sll, norm):
    b = 10.0 ** (sll / 20)
    a = np.arccosh(b) / np.pi
    s2 = nbar ** 2 / (a ** 2 + (nbar - 0.5) ** 2)
    ma = np.arange(1, nbar)
    fm = np.zeros(nbar - 1)
    signs = np.ones(max(nbar - 1, 0))
    signs[1::2] = -1
    m2 = ma * ma
    for mi in range(len(ma)):
        numer = signs[mi] * np.prod(
            1 - m2[mi] / s2 / (a ** 2 + (ma - 0.5) ** 2))
        denom = 2 * np.prod([1 - m2[mi] / m2[j]
                             for j in range(len(ma)) if j != mi])
        fm[mi] = numer / denom

    def w_of(x):
        return 1 + 2 * np.dot(
            fm, np.cos(2 * np.pi * ma[:, None] * (x - m / 2.0 + 0.5) / m))

    w = w_of(np.arange(m))
    return w / w_of((m - 1) / 2) if norm else w


@_window("taylor")
def _taylor(n, fftbins=True, nbar=4, sll=30, norm=True):
    """Taylor's window: ``nbar`` nearly constant sidelobes ``sll`` dB under
    the main lobe."""
    return _sym(_taylor_m, n, fftbins, nbar, sll, norm)


def get_window(window: Union[str, tuple], win_length: int,
               fftbins: bool = True):
    """The window ``window`` (a name, or ``(name, param, ...)``) of
    ``win_length`` points, float32, on the current device."""
    name, params = (window[0], window[1:]) if isinstance(window, tuple) \
        else (window, ())
    fn = _WINDOWS.get(name)
    if fn is None:
        raise ValueError(f"unknown window '{name}' (have {sorted(_WINDOWS)})")
    w = np.asarray(fn(win_length, fftbins, *params), np.float64)
    return torch.as_tensor(w.astype(np.float32), device=layer_device())
