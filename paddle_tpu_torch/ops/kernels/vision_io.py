"""Vision IO ops: ``read_file`` and ``decode_jpeg`` (``ops.yaml:718-719``).

Counterparts of ``paddle_tpu/ops/kernels/vision_io.py``: the file's bytes
as a 1-D uint8 tensor, and a JPEG byte stream decoded on the host by PIL
(imported at call time) into a CHW uint8 tensor. Both are host ops
(``jit: false``): ``read_file`` puts its bytes on the port's default
device (``core.device.set_device``; the card unless the caller chose the
CPU), ``decode_jpeg`` its image on the stream's device.
"""

from __future__ import annotations

import io

import numpy as np
import torch

from ...core.device import layer_device
from ..dispatcher import register_kernel
from .manipulation import _not_captured


@register_kernel("read_file")
def _read_file(filename: str = ""):
    _not_captured("read_file")
    with open(filename, "rb") as f:
        data = f.read()
    return torch.frombuffer(bytearray(data), dtype=torch.uint8).to(
        layer_device())


@register_kernel("decode_jpeg")
def _decode_jpeg(x, mode: str = "unchanged"):
    """1-D uint8 bytes -> CHW uint8. ``mode``: "unchanged" (RGB or L kept,
    other modes made RGB), "gray" or "rgb"."""
    _not_captured("decode_jpeg")
    from PIL import Image
    raw = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)
    img = Image.open(io.BytesIO(np.asarray(raw, np.uint8).tobytes()))
    if mode == "gray":
        img = img.convert("L")
    elif mode == "rgb" and img.mode != "RGB":
        img = img.convert("RGB")
    elif mode == "unchanged" and img.mode not in ("RGB", "L"):
        img = img.convert("RGB")
    arr = np.asarray(img, np.uint8)
    arr = arr[None] if arr.ndim == 2 else arr.transpose(2, 0, 1)
    dev = x.device if isinstance(x, torch.Tensor) else layer_device()
    return torch.from_numpy(np.ascontiguousarray(arr)).to(dev)
