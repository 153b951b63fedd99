"""Runtime flags of the ported paths.

Counterpart of the JAX package's flag registry, cut to the flags the
serving and training slices read. Same names, defaults and meanings;
``FLAGS_<name>`` in the environment overrides a default, and
:func:`set_flags` changes a value at run time.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, Tuple

_KV_CACHE_DTYPES = ("auto", "bf16", "bfloat16", "int8")


def _choice(name: str, allowed: Tuple[str, ...]) -> Callable[[Any], str]:
    def parse(value: Any) -> str:
        value = str(value)
        if value not in allowed:
            raise ValueError(f"FLAGS_{name} must be one of {allowed}, got "
                             f"{value!r}")
        return value
    return parse


def _bool(value: Any) -> bool:
    if isinstance(value, str):
        low = value.strip().lower()
        if low in ("1", "true", "yes", "on"):
            return True
        if low in ("0", "false", "no", "off", ""):
            return False
        raise ValueError(f"not a boolean flag value: {value!r}")
    return bool(value)


# name: (default, parser)
# kv_cache_dtype: paged KV pool storage for serving: 'auto' (the model's
#   compute dtype), 'bf16', or 'int8' (per-token-slot absmax scales ride
#   the block table; dequant happens at the attention kernel's tile load,
#   so device-memory reads stay at int8 bytes).
# speculative_k: draft length K of the continuous-batching engine: 0 off;
#   K > 0 drafts K tokens per decode row (n-gram self-draft) and verifies
#   them as one q_len=K+1 ragged row inside the token budget.
# fused_optimizer: the bucketed fused optimizer update: ONE kernel launch
#   per (dtype, weight-decay) bucket fusing grad unscale, global-norm
#   clip, the anomaly-sentinel select, the rule and the bf16 master
#   write-back; the per-param chain runs when off or ineligible
#   (ops/kernels/fused_optimizer.py).
# anomaly_sentinel: every optimizer update computes a device-side
#   finiteness + global-norm reduction over the grads and guards the
#   update with a select, so a non-finite step is an exact bitwise no-op;
#   the step pays one deferred host sync to keep the step count at
#   applied updates.
# use_pallas_kernels: the hand-written kernels where the reference gates
#   its Pallas kernels on this flag (the per-channel int4 weight-only
#   GEMM): off, a CUDA tensor takes the plain version.
# check_nan_inf: every op at the choke point (ops/dispatcher.py:hooked)
#   checks its floating outputs and raises FloatingPointError on a NaN or
#   an Inf (one host sync per output).
# step_capture: whole-step capture (jit/step_capture.py): a repeated
#   training step (forward, backward, clip, optimizer update) is captured
#   as ONE CUDA graph and replayed. Gates ``jit_step``, the
#   ``hapi.Model.train_batch`` auto-capture and the serving engine's step
#   graph; steps it cannot capture run eagerly with the reason counted.
#   ``TrainStep`` always captures, as the reference always compiles.
# multi_step: K > 1 makes ``hapi.Model.fit`` train in K-step blocks: ONE
#   CUDA graph runs K whole steps over a ``[K, ...]`` block the DataLoader
#   stacks (``DataLoader.fill_ring``); epoch tails and unsupported edges
#   run single-step capture. 0 (default) = off; ``jit_step(fn,
#   k_steps=K)`` ignores it.
_FLAGS: Dict[str, Tuple[Any, Callable[[Any], Any]]] = {
    "kv_cache_dtype": ("auto", _choice("kv_cache_dtype", _KV_CACHE_DTYPES)),
    "speculative_k": (0, int),
    "fused_optimizer": (True, _bool),
    "anomaly_sentinel": (False, _bool),
    "use_pallas_kernels": (True, _bool),
    "check_nan_inf": (False, _bool),
    "step_capture": (True, _bool),
    "multi_step": (0, int),
}

_VALUES: Dict[str, Any] = {
    n: parse(os.environ.get("FLAGS_" + n, d))
    for n, (d, parse) in _FLAGS.items()}


# bumped by every set_flags: capture keys fold it in, so a flag change
# re-probes instead of replaying a graph recorded under the old routes
version = 0


def _name(name: str) -> str:
    name = name.removeprefix("FLAGS_")
    if name not in _VALUES:
        raise ValueError(f"unknown flag: {name}")
    return name


def get_flag(name: str) -> Any:
    return _VALUES[_name(name)]


def get_flags(names) -> Dict[str, Any]:
    """``{"FLAGS_<name>": value}`` for a name or a list of names (the
    reference's ``paddle.get_flags``)."""
    if isinstance(names, str):
        names = [names]
    return {"FLAGS_" + _name(n): _VALUES[_name(n)] for n in names}


def set_flags(flags: Dict[str, Any]) -> None:
    global version
    for k, v in flags.items():
        k = _name(k)
        _VALUES[k] = _FLAGS[k][1](v)
    version += 1
