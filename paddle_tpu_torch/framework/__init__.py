"""``paddle.save`` / ``paddle.load``: state structures in the reference's
file format.

Counterpart of ``paddle_tpu/framework/__init__.py:1-219``. A file is a
plain pickle of a (nested) state structure whose tensors were pulled to
host numpy arrays, each wrapped in a payload object so that ``load``
restores tensors and leaves the structure's own numpy arrays as they are.
``load`` reads such files, and upstream Paddle's ``.pdparams`` /
``.pdopt``: tensors reduced to ``(name, ndarray)`` tuples, LoDTensors to
``(eval, ('data', {'data': ndarray}))``, arrays over 2**30 bytes split
into ``key@@.i`` slices under an ``UnpackBigParamInfor@@`` entry. It
unpickles under an allow-listing unpickler (numpy's reconstructors and
the builtins those reducers emit); a file that asks for another global is
read by a plain unpickler unless ``safe_load=True``, the reference's
trust model.

The payload is written under the reference's own class name,
``paddle_tpu.framework._TensorPayload``, by a pickler of this module that
writes that global by name without importing it (the port imports
nothing of ``paddle_tpu``); both loaders map that name to their own
payload class. So a file of either package is the same file, and each
loads the other's with its own semantics. Upstream's ``(name, ndarray)``
form, which the reference also reads, was not chosen: both loaders turn
every bare ndarray of such a file into a tensor, so a structure holding
numpy arrays of its own would not come back as it was saved. bfloat16
tensors are written as float32 arrays (the card's machine has no numpy
bfloat16); a bfloat16 array in a reference file needs ``ml_dtypes`` to be
read.
"""

from __future__ import annotations

import collections
import _codecs
import io as _io
import os
import pickle
from typing import Any

import numpy as np
import torch

__all__ = ["save", "load"]

# the reference's payload class: the name this package writes and reads
PAYLOAD_GLOBAL = ("paddle_tpu.framework", "_TensorPayload")
_CHUNK_MARKER = "UnpackBigParamInfor@@"


class _TensorPayload:
    """Marks an array that was a tensor, so :func:`load` makes it one
    again (pickled as :data:`PAYLOAD_GLOBAL`, state ``{"array": a}``)."""

    def __init__(self, array: np.ndarray):
        self.array = array


def _host(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return np.array(t.cpu().numpy(), copy=True)


def _to_host(obj):
    if isinstance(obj, torch.Tensor):
        return _TensorPayload(_host(obj))
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


class _Writer(pickle._Pickler):
    """Python's pickler, writing :class:`_TensorPayload` as the global
    :data:`PAYLOAD_GLOBAL` (the C pickler would import that module to
    check the name)."""

    def save_global(self, obj, name=None):
        if obj is not _TensorPayload:
            return super().save_global(obj, name)
        module, qual = PAYLOAD_GLOBAL
        if self.proto >= 4:
            self.save(module)
            self.save(qual)
            self.write(pickle.STACK_GLOBAL)
        else:
            self.write(pickle.GLOBAL + f"{module}\n{qual}\n".encode())
        self.memoize(obj)


def save(obj: Any, path: str, protocol: int = 4) -> None:
    """``paddle.save``: pickles ``obj`` with its tensors as host numpy
    arrays (read from the card where they live there)."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    buf = _io.BytesIO()
    _Writer(buf, protocol=protocol).dump(_to_host(obj))
    with open(path, "wb") as f:
        f.write(buf.getbuffer())


class _SafeEval:
    """Upstream's ``reduce_LoDTensor`` target ``(eval, ('data', {'data':
    ndarray}))``: evaluating the name ``data`` in that dict gives the
    array; anything else is refused."""

    def __call__(self, expr, glb=None):
        if expr == "data" and isinstance(glb, dict) and "data" in glb:
            return glb["data"]
        raise pickle.UnpicklingError(
            f"refusing eval of {expr!r} from checkpoint")


_NUMPY = ("numpy", "numpy.core.multiarray", "numpy._core.multiarray",
          "numpy.core.numeric", "numpy._core.numeric", "numpy.dtypes")
_ALLOWED = {
    ("__builtin__", "tuple"): tuple,       # protocol 2's module name
    ("__builtin__", "eval"): _SafeEval(),
    ("builtins", "tuple"): tuple,
    ("builtins", "list"): list,
    ("builtins", "dict"): dict,
    ("builtins", "set"): set,
    ("builtins", "frozenset"): frozenset,
    ("builtins", "bytearray"): bytearray,
    ("builtins", "complex"): complex,
    ("builtins", "slice"): slice,
    ("builtins", "eval"): _SafeEval(),
    ("collections", "OrderedDict"): collections.OrderedDict,
    ("_codecs", "encode"): _codecs.encode,  # numpy's protocol-2 bytes
    PAYLOAD_GLOBAL: _TensorPayload,
}


class _CheckpointUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module in _NUMPY:
            return super().find_class(module, name)
        hit = _ALLOWED.get((module, name))
        if hit is not None:
            return hit
        raise pickle.UnpicklingError(
            f"checkpoint requests disallowed global {module}.{name}")


class _TrustingUnpickler(pickle.Unpickler):
    """The fallback for trusted files: any global, but the payload still
    maps to this package's class (no import of the reference)."""

    def find_class(self, module, name):
        if (module, name) == PAYLOAD_GLOBAL:
            return _TensorPayload
        return super().find_class(module, name)


def _pack_loaded_dict(obj):
    """Rejoin upstream's ``key@@.i`` slices (its ``io_utils.py:216``)."""
    if isinstance(obj, dict) and _CHUNK_MARKER in obj:
        removes = []
        for key, value in obj[_CHUNK_MARKER].items():
            slices = [obj[part] for part in value["slices"]]
            slices = [s[1] if isinstance(s, tuple) and len(s) == 2 else s
                      for s in slices]
            obj[key] = np.concatenate(
                [np.asarray(s) for s in slices]).reshape(
                    value["OriginShape"])
            removes += value["slices"]
        for key in removes:
            obj.pop(key)
        obj.pop(_CHUNK_MARKER)
    return obj


def _is_named_array(obj) -> bool:
    return isinstance(obj, tuple) and len(obj) == 2 \
        and isinstance(obj[0], str) and isinstance(obj[1], np.ndarray)


def _looks_upstream(obj) -> bool:
    """Upstream's unambiguous marks: a ``(name, ndarray)`` tuple or the
    big-param marker (bare arrays are no mark: ``save`` keeps them)."""
    if isinstance(obj, dict):
        return _CHUNK_MARKER in obj or any(_looks_upstream(v)
                                           for v in obj.values())
    if _is_named_array(obj):
        return True
    if isinstance(obj, (list, tuple)):
        return any(_looks_upstream(v) for v in obj)
    return False


def _has_payload(obj) -> bool:
    if isinstance(obj, _TensorPayload):
        return True
    if isinstance(obj, dict):
        return any(_has_payload(v) for v in obj.values())
    if isinstance(obj, (list, tuple)):
        return any(_has_payload(v) for v in obj)
    return False


def _tensor(arr: np.ndarray, name=None):
    from ..core.tensor import to_tensor
    t = to_tensor(arr, dtype=None if arr.dtype.name == "bfloat16"
                  else arr.dtype.name)
    if name is not None:
        t.name = name
    return t


def _restore(obj, return_numpy: bool, upstream: bool):
    """Payloads (and, in an upstream file, ``(name, ndarray)`` tuples and
    bare arrays) as tensors, or as arrays with ``return_numpy``."""
    if isinstance(obj, _TensorPayload):
        return obj.array if return_numpy else _tensor(obj.array)
    if upstream and _is_named_array(obj):
        return obj[1] if return_numpy else _tensor(obj[1], obj[0])
    if upstream and isinstance(obj, np.ndarray):
        return obj if return_numpy else _tensor(obj)
    if isinstance(obj, dict):
        return {k: _restore(v, return_numpy, upstream)
                for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_restore(v, return_numpy, upstream) for v in obj)
    return obj


def load(path: str, return_numpy: bool = False, safe_load: bool = False):
    """``paddle.load``: a file of :func:`save` (or of the reference's),
    or upstream Paddle's ``.pdparams`` / ``.pdopt``. Tensors come back on
    ``set_device``'s device (the card unless the caller chose the CPU),
    or as numpy arrays with ``return_numpy``. ``safe_load=True`` refuses a
    file that asks for a global outside the allow-list, where a trusted
    file falls back to a plain unpickler."""
    with open(path, "rb") as f:
        try:
            obj = _CheckpointUnpickler(f).load()
        except pickle.UnpicklingError as e:
            if safe_load or "disallowed global" not in str(e):
                raise
            f.seek(0)
            obj = _TrustingUnpickler(f).load()
    marked = isinstance(obj, dict) and _CHUNK_MARKER in obj
    obj = _pack_loaded_dict(obj)
    upstream = not _has_payload(obj) and (marked or _looks_upstream(obj))
    return _restore(obj, return_numpy, upstream)
