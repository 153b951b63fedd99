"""Load the JAX package's weights into the port.

``from_jax_state_dict(model, state)`` takes the JAX model's
``state_dict()`` as numpy arrays (``{name: np.ndarray}``; the reference's
``Layer.state_dict`` names) and copies every entry into the port module of
the same name, checking shapes and dtypes. Linear weights keep the
``[in, out]`` layout in both packages, so nothing is transposed. The
rotary ``cos_cached``/``sin_cached`` buffers are copied too.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

_NP_DTYPES = {torch.float32: ("float32",), torch.bfloat16: ("bfloat16",),
              torch.float16: ("float16",)}


def from_jax_state_dict(model: torch.nn.Module,
                        state: Dict[str, np.ndarray]) -> torch.nn.Module:
    """Copy ``state`` into ``model`` name for name. Raises on a missing or
    unexpected name, a shape mismatch, or a dtype that differs from the
    port parameter's."""
    own = model.state_dict(keep_vars=True)
    missing = sorted(set(own) - set(state))
    unexpected = sorted(set(state) - set(own))
    if missing or unexpected:
        raise KeyError(f"state_dict names differ: missing {missing[:5]}, "
                       f"unexpected {unexpected[:5]}")
    with torch.no_grad():
        for name, target in own.items():
            arr = np.asarray(state[name])
            if tuple(arr.shape) != tuple(target.shape):
                raise ValueError(f"shape mismatch for {name!r}: "
                                 f"{tuple(arr.shape)} vs "
                                 f"{tuple(target.shape)}")
            if str(arr.dtype) not in _NP_DTYPES.get(target.dtype, ()):
                raise ValueError(f"dtype mismatch for {name!r}: {arr.dtype} "
                                 f"vs {target.dtype}")
            src = (torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
                   if str(arr.dtype) == "bfloat16"
                   else torch.from_numpy(np.array(arr, copy=True)))
            target.copy_(src.to(target.device))
    return model
