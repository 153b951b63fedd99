"""Load the JAX package's weights into the port.

``from_jax_state_dict(model, state)`` takes the JAX model's
``state_dict()`` as numpy arrays (``{name: np.ndarray}``; the reference's
``Layer.state_dict`` names) and copies every entry into the port module of
the same name, checking shapes and dtypes. Linear weights keep the
``[in, out]`` layout in both packages, so nothing is transposed. Buffers
come across too: the rotary ``cos_cached``/``sin_cached``, BatchNorm's
``_mean``/``_variance``, a weight-only quantized model's int8
``qweight`` and float32 ``weight_scale`` (quantize the port skeleton
first with ``nn.quant.quantize_for_inference``). It loads any reference
``Layer`` into its port counterpart (``nn.Linear``, ``nn.Conv2D``, ...,
``nn.Sequential`` of them), every model of the vision zoo
(``vision.models``: the ResNets, VGG, the MobileNets, ..., YOLOv3, with
their BatchNorm statistics), and the stacked Llama
(``use_scan_layers=True``: ``llama.layer_stack.stacked_{j}``).

The optimizer's state comes across too: ``from_jax_optimizer_state(
model, optimizer, state, names)`` loads the reference optimizer's
``state_dict()`` (its arrays as numpy; ``names`` the reference's parameter
names in its optimizer's order) into a port optimizer by parameter name:
the step count, the float32 masters, every state slot (ASGD's gradient
ring ``ys`` ``[batch_num, *shape]`` too) and the scheduler's state.

The other way, for holding training to the reference name for name:
``named_grads(model)`` and ``named_optimizer_state(model, optimizer)``
give the port's grads, and its optimizer's float32 masters and state
slots (whatever their shapes), as numpy arrays keyed by the same
``state_dict`` names the JAX model's ``named_parameters()`` gives.
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
            target.copy_(_tensor(arr).to(target.device))
    return model


def _tensor(arr) -> torch.Tensor:
    """A numpy array (bf16 from JAX included) as a CPU tensor."""
    arr = np.asarray(arr)
    if str(arr.dtype) == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True))


def from_jax_optimizer_state(model: torch.nn.Module, optimizer, state: Dict,
                             names: List[str]):
    """Load the JAX optimizer's ``state_dict()`` into ``optimizer`` (built
    over ``model``'s parameters) by parameter name. ``state``: ``{"step",
    "states", "masters"[, "lr"]}`` with numpy arrays, listed in the JAX
    optimizer's parameter order, whose names are ``names``. Raises on a
    name the port optimizer lacks."""
    ref_states = state.get("states") or [None] * len(names)
    ref_masters = state.get("masters") or [None] * len(names)
    if not len(names) == len(ref_states) == len(ref_masters):
        raise ValueError("names must list the JAX optimizer's parameters")
    own = param_names(model, optimizer._parameter_list)
    where = {n: i for i, n in enumerate(own)}
    missing = sorted(set(names) - set(where))
    if missing:
        raise KeyError(f"parameters the port optimizer lacks: {missing[:5]}")
    states, masters = [None] * len(own), [None] * len(own)
    for name, st, m in zip(names, ref_states, ref_masters):
        if st is not None:
            states[where[name]] = {k: _tensor(v) for k, v in st.items()}
        if m is not None:
            masters[where[name]] = _tensor(m)
    sd = {"step": int(state.get("step", 0)), "states": states,
          "masters": masters}
    if "lr" in state:
        sd["lr"] = state["lr"]
    optimizer.set_state_dict(sd)
    return optimizer


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
