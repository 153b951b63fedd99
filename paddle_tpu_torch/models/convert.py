"""Load the JAX package's weights into the port.

``from_jax_state_dict(model, state)`` takes the JAX model's
``state_dict()`` as numpy arrays (``{name: np.ndarray}``; the reference's
``Layer.state_dict`` names) and copies every entry into the port module of
the same name, checking shapes and dtypes. Linear weights keep the
``[in, out]`` layout in both packages, so nothing is transposed. The
rotary ``cos_cached``/``sin_cached`` buffers are copied too, and so are a
weight-only quantized model's int8 ``qweight`` and float32
``weight_scale`` buffers (quantize the port skeleton first with
``nn.quant.quantize_for_inference``).

The other way, for holding training to the reference name for name:
``named_grads(model)`` and ``named_optimizer_state(model, optimizer)``
give the port's grads, and its optimizer's float32 masters and moments,
as numpy arrays keyed by the same ``state_dict`` names the JAX model's
``named_parameters()`` gives.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

_NP_DTYPES = {torch.float32: ("float32",), torch.bfloat16: ("bfloat16",),
              torch.float16: ("float16",), torch.int8: ("int8",)}


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


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A float32 numpy copy (bf16 widened exactly)."""
    return t.detach().float().cpu().numpy()


def param_names(model: torch.nn.Module, params) -> List[str]:
    """The ``state_dict`` name of each tensor in ``params``."""
    by_id = {id(p): n for n, p in model.named_parameters()}
    return [by_id[id(p)] for p in params]


def named_grads(model: torch.nn.Module) -> Dict[str, np.ndarray]:
    """Every parameter's grad, by name (parameters without one are left
    out)."""
    return {n: to_numpy(p.grad) for n, p in model.named_parameters()
            if p.grad is not None}


def named_optimizer_state(model: torch.nn.Module, optimizer
                          ) -> Dict[str, Dict[str, np.ndarray]]:
    """The optimizer's per-parameter state by parameter name:
    ``{name: {"master": ..., "m": ..., "v": ...}}`` (the state keys of its
    rule; "master" only where a float32 master exists)."""
    out = {}
    names = param_names(model, optimizer._parameter_list)
    for name, st, master in zip(names, optimizer._states,
                                optimizer._masters):
        if st is None:
            continue
        d = {k: to_numpy(v) for k, v in st.items()}
        if master is not None:
            d["master"] = to_numpy(master)
        out[name] = d
    return out
