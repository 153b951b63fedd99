"""Audio file I/O: ``info``, ``load`` and ``save`` over a backend registry.

Counterpart of ``paddle_tpu/audio/backends.py`` (Paddle's
``audio/backends/``: ``AudioInfo``, the ``wave`` backend over the
standard library's ``wave`` module, PCM16 WAV, and the registry). The
``soundfile`` backend is listed only where the ``soundfile`` package
imports, as in the reference. ``load`` returns a float32 CPU tensor
``[channels, time]`` (``channels_first``) and the sample rate; ``save``
takes a 2-D tensor (from any device) or array.
"""

from __future__ import annotations

import wave as _wave
from pathlib import Path
from typing import List, Optional, Tuple, Union

import numpy as np

import torch

__all__ = ["AudioInfo", "info", "load", "save",
           "list_available_backends", "get_current_backend", "set_backend"]


class AudioInfo:
    """Signal metadata (reference backends/backend.py AudioInfo)."""

    def __init__(self, sample_rate: int, num_samples: int, num_channels: int,
                 bits_per_sample: int, encoding: str):
        self.sample_rate = sample_rate
        self.num_samples = num_samples
        self.num_channels = num_channels
        self.bits_per_sample = bits_per_sample
        self.encoding = encoding

    def __repr__(self):
        return (f"AudioInfo(sample_rate={self.sample_rate}, "
                f"num_samples={self.num_samples}, "
                f"num_channels={self.num_channels}, "
                f"bits_per_sample={self.bits_per_sample}, "
                f"encoding={self.encoding!r})")


def _array(src) -> np.ndarray:
    if isinstance(src, torch.Tensor):
        return src.detach().cpu().numpy()
    return np.asarray(src)


def _open_wave(filepath):
    """→ (wave reader, file_obj, caller_owned). Caller-owned handles are
    never closed by the backend."""
    caller_owned = hasattr(filepath, "read")
    file_obj = filepath if caller_owned else open(filepath, "rb")
    try:
        f = _wave.open(file_obj)
    except (_wave.Error, EOFError):
        # EOFError: empty/truncated file — same contract as a non-WAV one
        if not caller_owned:
            file_obj.close()
        raise NotImplementedError(
            "only PCM16 WAV is supported by the 'wave' backend; install "
            "soundfile and set_backend('soundfile') for other formats")
    if f.getsampwidth() != 2:
        if not caller_owned:
            file_obj.close()
        raise NotImplementedError(
            f"only PCM16 WAV is supported by the 'wave' backend (file is "
            f"{f.getsampwidth() * 8}-bit); install soundfile and "
            f"set_backend('soundfile') for other formats")
    return f, file_obj, caller_owned


def _wave_info(filepath) -> AudioInfo:
    f, file_obj, caller_owned = _open_wave(filepath)
    try:
        return AudioInfo(sample_rate=f.getframerate(),
                         num_samples=f.getnframes(),
                         num_channels=f.getnchannels(),
                         bits_per_sample=f.getsampwidth() * 8,
                         encoding="PCM_S")
    finally:
        if not caller_owned:
            file_obj.close()


def _wave_load(filepath, frame_offset=0, num_frames=-1, normalize=True,
               channels_first=True) -> Tuple[torch.Tensor, int]:
    f, file_obj, caller_owned = _open_wave(filepath)
    try:
        channels = f.getnchannels()
        sample_rate = f.getframerate()
        total = f.getnframes()
        # read only the requested segment — a num_frames slice of an
        # hour-long file must not decode the whole recording
        if frame_offset:
            f.setpos(min(int(frame_offset), total))
        want = (total - frame_offset if num_frames == -1
                else max(int(num_frames), 0))
        raw = f.readframes(want)
    finally:
        if not caller_owned:
            file_obj.close()
    data = np.frombuffer(raw, dtype=np.int16).astype(np.float32)
    if normalize:
        data = data / 2.0 ** 15
    wavef = data.reshape(-1, channels)
    if channels_first:
        wavef = wavef.T
    return torch.from_numpy(np.ascontiguousarray(wavef)), sample_rate


def _wave_save(filepath, src, sample_rate, channels_first=True,
               encoding=None, bits_per_sample=16) -> None:
    arr = _array(src)
    if arr.ndim != 2:
        raise ValueError(f"expected a 2D (channels,time) tensor, got "
                         f"shape {arr.shape}")
    if channels_first:
        arr = arr.T  # → (time, channels)
    if bits_per_sample not in (None, 16):
        raise ValueError("the 'wave' backend only writes 16-bit PCM")
    if arr.dtype != np.int16:
        # clip before the int16 cast: a full-scale 1.0 would otherwise
        # wrap to -32768
        arr = np.clip(arr.astype(np.float32) * 2.0 ** 15,
                      -32768, 32767).astype("<h")
    with _wave.open(str(filepath), "w") as f:
        f.setnchannels(arr.shape[1])
        f.setsampwidth(2)
        f.setframerate(sample_rate)
        f.writeframes(np.ascontiguousarray(arr).tobytes())


def _soundfile_info(filepath) -> AudioInfo:
    import soundfile as sf
    i = sf.info(str(filepath))
    bits = {"PCM_16": 16, "PCM_24": 24, "PCM_32": 32, "PCM_S8": 8,
            "PCM_U8": 8, "FLOAT": 32, "DOUBLE": 64}.get(i.subtype, 16)
    return AudioInfo(sample_rate=i.samplerate, num_samples=i.frames,
                     num_channels=i.channels, bits_per_sample=bits,
                     encoding=i.subtype)


def _soundfile_load(filepath, frame_offset=0, num_frames=-1, normalize=True,
                    channels_first=True) -> Tuple[torch.Tensor, int]:
    import soundfile as sf
    stop = None if num_frames == -1 else frame_offset + num_frames
    dtype = "float32" if normalize else "int16"
    data, sample_rate = sf.read(str(filepath), start=frame_offset, stop=stop,
                                dtype=dtype, always_2d=True)
    wavef = data.astype(np.float32)
    if channels_first:
        wavef = wavef.T
    return torch.from_numpy(np.ascontiguousarray(wavef)), sample_rate


def _soundfile_save(filepath, src, sample_rate, channels_first=True,
                    encoding=None, bits_per_sample=16) -> None:
    import soundfile as sf
    arr = _array(src)
    if arr.ndim != 2:
        raise ValueError(f"expected a 2D tensor, got shape {arr.shape}")
    if channels_first:
        arr = arr.T
    subtype = {8: "PCM_S8", 16: "PCM_16", 24: "PCM_24",
               32: "PCM_32"}.get(bits_per_sample or 16, "PCM_16")
    sf.write(str(filepath), arr, sample_rate, subtype=subtype)


_BACKENDS = {
    "wave": (_wave_info, _wave_load, _wave_save),
    "soundfile": (_soundfile_info, _soundfile_load, _soundfile_save),
}


def info(filepath: Union[str, Path]) -> AudioInfo:
    """Metadata of an audio file via the current backend (reference
    backends/backend.py info)."""
    return _BACKENDS[_current_backend][0](filepath)


def load(filepath: Union[str, Path], frame_offset: int = 0,
         num_frames: int = -1, normalize: bool = True,
         channels_first: bool = True) -> Tuple[torch.Tensor, int]:
    """Load audio → (waveform, sample_rate) via the current backend
    (reference wave_backend.load). normalize=True → float32 in (-1, 1);
    False → raw int16 values (as float32, matching the reference's cast).
    channels_first=True → (channels, time). frame_offset applies with or
    without num_frames."""
    return _BACKENDS[_current_backend][1](
        filepath, frame_offset=frame_offset, num_frames=num_frames,
        normalize=normalize, channels_first=channels_first)


def save(filepath: str, src, sample_rate: int,
         channels_first: bool = True, encoding: Optional[str] = None,
         bits_per_sample: Optional[int] = 16) -> None:
    """Save a 2-D waveform tensor via the current backend (reference
    wave_backend.save; PCM16 on the 'wave' backend)."""
    _BACKENDS[_current_backend][2](
        filepath, src, sample_rate, channels_first=channels_first,
        encoding=encoding, bits_per_sample=bits_per_sample)


_current_backend = "wave"


def list_available_backends() -> List[str]:
    """reference init_backend.list_available_backends: 'wave' always;
    'soundfile' only when the optional package is importable."""
    backends = ["wave"]
    try:
        import soundfile  # noqa: F401
        backends.append("soundfile")
    except ImportError:
        pass
    return backends


def get_current_backend() -> str:
    return _current_backend


def set_backend(backend_name: str) -> None:
    global _current_backend
    if backend_name not in list_available_backends():
        raise NotImplementedError(
            f"backend '{backend_name}' unavailable "
            f"(have {list_available_backends()})")
    _current_backend = backend_name
