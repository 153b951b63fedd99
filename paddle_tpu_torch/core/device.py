"""Device resolution, Places, and the card's memory stats and sync.

Counterpart of ``paddle_tpu/core/device.py``: its implicit default
backend, its ``Place`` classes (``CPUPlace``, ``CUDAPlace(i)`` and
``CUDAPinnedPlace``; the reference's ``TPUPlace`` has none, and
``is_compiled_with_cuda`` stands for its ``is_compiled_with_tpu``),
``device_count``, ``synchronize``, the memory stats (over
``torch.cuda``), and ``Stream`` / ``Event`` (torch's CUDA streams and
events). Entry points
(`LlamaForCausalLM`, the serving engine, `generate`) run on the card unless
the caller names another device: with ``device=None`` and no CUDA device
present they raise instead of quietly falling back to the CPU.

float32 matmuls and convolutions run in full float32, never TF32: the port
is held to the float32 reference, and TF32 keeps about three decimal digits.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from .dtype import dtype_of  # noqa: F401  (re-exported)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the CUDA card, and
    raises when there is none."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available: pass device='cpu' explicitly "
                "to run the port on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)


_DEFAULT: list = [None]


def set_device(device: DeviceLike) -> None:
    """Where layers built the Paddle way (``nn.Linear(4, 8)``) put their
    parameters (the reference's ``paddle.set_device``): ``"gpu"`` /
    ``"gpu:0"`` or a ``Place`` name the CUDA card, ``"cpu"`` the CPU,
    ``None`` the default (the card)."""
    if isinstance(device, Place):
        device = device.device
    if isinstance(device, str):
        device = device.replace("gpu", "cuda")
    _DEFAULT[0] = None if device is None else torch.device(device)


def get_device() -> DeviceLike:
    """The device :func:`set_device` set (None: the card)."""
    return _DEFAULT[0]


def layer_device() -> torch.device:
    """The device a new layer's parameters go to."""
    return resolve_device(_DEFAULT[0])


def _as_device(device) -> torch.device:
    if isinstance(device, Place):
        return device.device
    if isinstance(device, str):
        device = device.replace("gpu", "cuda")
    return resolve_device(device)


class Place:
    """A device place: ``CPUPlace()``, ``CUDAPlace(i)``."""

    def __init__(self, device):
        self._device = torch.device(device)

    @property
    def device(self) -> torch.device:
        return self._device

    def get_device_id(self) -> int:
        return self._device.index or 0

    def is_cpu_place(self) -> bool:
        return self._device.type == "cpu"

    def is_gpu_place(self) -> bool:
        return self._device.type == "cuda"

    def is_cuda_pinned_place(self) -> bool:
        return False

    def __repr__(self):
        if self._device.type == "cpu":
            return "Place(cpu)"
        return f"Place(gpu:{self.get_device_id()})"

    def __eq__(self, other):
        return isinstance(other, Place) and self._device == other._device

    def __hash__(self):
        return hash(self._device)


class CPUPlace(Place):
    def __init__(self, idx: int = 0):
        super().__init__("cpu")


class CUDAPlace(Place):
    def __init__(self, idx: int = 0):
        super().__init__(torch.device("cuda", int(idx)))


class CUDAPinnedPlace(Place):
    """Page-locked host memory: a CPU place whose tensors are pinned."""

    def __init__(self):
        super().__init__("cpu")

    def is_cuda_pinned_place(self) -> bool:
        return True

    def __repr__(self):
        return "Place(gpu_pinned)"


def place_of(device: torch.device) -> Place:
    """The Place of a torch device."""
    return CPUPlace() if device.type == "cpu" else \
        CUDAPlace(device.index or 0)


def device_count() -> int:
    return torch.cuda.device_count()


def is_compiled_with_cuda() -> bool:
    return torch.cuda.is_available()


def synchronize(device=None) -> None:
    """Block until all queued work on the card finishes."""
    torch.cuda.synchronize(_as_device(device))


def memory_allocated(device=None) -> int:
    return torch.cuda.memory_allocated(_as_device(device))


def max_memory_allocated(device=None) -> int:
    return torch.cuda.max_memory_allocated(_as_device(device))


def memory_reserved(device=None) -> int:
    return torch.cuda.memory_reserved(_as_device(device))


def max_memory_reserved(device=None) -> int:
    return torch.cuda.max_memory_reserved(_as_device(device))


def empty_cache() -> None:
    torch.cuda.empty_cache()


class Stream:
    """A CUDA stream (``torch.cuda.Stream``) on ``device``."""

    def __init__(self, device=None, priority: int = 2):
        self.device = _as_device(device)
        # Paddle's priorities: 1 high, 2 normal; torch's: -1 high, 0 normal
        self.stream = torch.cuda.Stream(self.device,
                                        priority=-1 if priority == 1 else 0)

    def synchronize(self) -> None:
        self.stream.synchronize()


class Event:
    """A CUDA event (``torch.cuda.Event``)."""

    def __init__(self, enable_timing: bool = False, blocking: bool = False,
                 interprocess: bool = False):
        self.event = torch.cuda.Event(enable_timing=enable_timing,
                                      blocking=blocking,
                                      interprocess=interprocess)

    def record(self, stream: Optional[Stream] = None) -> None:
        self.event.record(None if stream is None else stream.stream)

    def synchronize(self) -> None:
        self.event.synchronize()

    def elapsed_time(self, end: "Event") -> float:
        return self.event.elapsed_time(end.event)

