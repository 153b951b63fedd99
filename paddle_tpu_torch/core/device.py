"""Device resolution for the port's entry points.

Counterpart of the JAX package's implicit default backend. Entry points
(`LlamaForCausalLM`, the serving engine, `generate`) run on the card unless
the caller names another device: with ``device=None`` and no CUDA device
present they raise instead of quietly falling back to the CPU.

float32 matmuls and convolutions run in full float32, never TF32: the port
is held to the float32 reference, and TF32 keeps about three decimal digits.
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch

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
    ``"gpu:0"`` name the CUDA card, ``"cpu"`` the CPU, ``None`` the
    default (the card)."""
    if isinstance(device, str):
        device = device.replace("gpu", "cuda")
    _DEFAULT[0] = None if device is None else torch.device(device)


def get_device() -> DeviceLike:
    """The device :func:`set_device` set (None: the card)."""
    return _DEFAULT[0]


def layer_device() -> torch.device:
    """The device a new layer's parameters go to."""
    return resolve_device(_DEFAULT[0])


def dtype_of(name) -> torch.dtype:
    """Torch dtype from the JAX package's dtype names ('float32',
    'bfloat16', 'int64', 'bool', ...), a numpy dtype or a Python type
    (``float``, ``int``, ``bool``)."""
    if isinstance(name, torch.dtype):
        return name
    py = {float: "float32", int: "int64", bool: "bool"}
    if isinstance(name, type) and name in py:
        name = py[name]
    elif not isinstance(name, str):
        name = np.dtype(name).name
    name = name.replace("paddle.", "")
    if name not in _DTYPES:
        raise ValueError(f"unsupported dtype name {name!r}")
    return _DTYPES[name]


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16, "float64": torch.float64,
           "int8": torch.int8, "uint8": torch.uint8, "int16": torch.int16,
           "int32": torch.int32, "int64": torch.int64, "bool": torch.bool,
           "complex64": torch.complex64, "complex128": torch.complex128}
