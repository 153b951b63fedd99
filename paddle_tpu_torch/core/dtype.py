"""Data types and the default dtype.

Counterpart of ``paddle_tpu/core/dtype.py``: the dtype names at the
package's top level (``float32``, ``bfloat16``, ..., ``bool``) are the
torch dtypes themselves, so ``Tensor.dtype == paddle.float32`` holds.
``convert_dtype`` takes a name, a torch dtype, a numpy dtype or a Python
type; ``set_default_dtype`` picks the float dtype that creation, random
ops and ``to_tensor`` of Python floats use; ``iinfo`` / ``finfo`` are
torch's.
"""

from __future__ import annotations

import numpy as np
import torch

bfloat16 = torch.bfloat16
float16 = torch.float16
float32 = torch.float32
float64 = torch.float64
int8 = torch.int8
int16 = torch.int16
int32 = torch.int32
int64 = torch.int64
uint8 = torch.uint8
bool_ = torch.bool
complex64 = torch.complex64
complex128 = torch.complex128

_STR2DTYPE = {
    "bfloat16": bfloat16, "bf16": bfloat16,
    "float16": float16, "fp16": float16, "half": float16,
    "float32": float32, "fp32": float32, "float": float32,
    "float64": float64, "fp64": float64, "double": float64,
    "int8": int8, "int16": int16, "int32": int32, "int": int32,
    "int64": int64, "long": int64, "uint8": uint8,
    "bool": bool_, "complex64": complex64, "complex128": complex128,
}
_PY = {float: "float32", int: "int64", bool: "bool", complex: "complex64"}
_FLOATS = (bfloat16, float16, float32, float64)

_default = [float32]


def convert_dtype(dtype):
    """A dtype spec as a torch dtype (None stays None)."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, type) and dtype in _PY:
        dtype = _PY[dtype]
    elif not isinstance(dtype, str):
        dtype = np.dtype(dtype).name
    name = dtype.replace("paddle.", "").replace("torch.", "")
    if name not in _STR2DTYPE:
        raise ValueError(f"unsupported dtype name {dtype!r}")
    return _STR2DTYPE[name]


def dtype_of(name) -> torch.dtype:
    """Torch dtype from a dtype name ('float32', 'bfloat16', 'int64',
    'bool', ...), a numpy dtype or a Python type (``float``, ``int``,
    ``bool``); raises on None."""
    if name is None:
        raise ValueError("unsupported dtype name None")
    return convert_dtype(name)


def set_default_dtype(dtype) -> None:
    dtype = convert_dtype(dtype)
    if dtype not in _FLOATS:
        raise ValueError("default dtype must be a floating point type")
    _default[0] = dtype


def get_default_dtype() -> torch.dtype:
    return _default[0]


def is_floating_point_dtype(dtype) -> bool:
    return convert_dtype(dtype).is_floating_point


def is_integer_dtype(dtype) -> bool:
    dt = convert_dtype(dtype)
    return not (dt.is_floating_point or dt.is_complex or dt == torch.bool)


def dtype_name(dtype) -> str:
    return "None" if dtype is None else str(dtype).replace("torch.", "")


def iinfo(dtype):
    """Integer type info (``bits``, ``min``, ``max``)."""
    return torch.iinfo(convert_dtype(dtype))


def finfo(dtype):
    """Float type info (``bits``, ``eps``, ``min``, ``max``, ``tiny``),
    bfloat16 included."""
    return torch.finfo(convert_dtype(dtype))
