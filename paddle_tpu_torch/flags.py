"""Runtime flags of the serving path.

Counterpart of the JAX package's flag registry, cut to the two flags the
serving slice reads. Same names, defaults and meanings; ``FLAGS_<name>``
in the environment overrides a default, and :func:`set_flags` changes a
value at run time.
"""

from __future__ import annotations

import os
from typing import Any, Dict

_KV_CACHE_DTYPES = ("auto", "bf16", "bfloat16", "int8")

# kv_cache_dtype: paged KV pool storage for serving: 'auto' (the model's
#   compute dtype), 'bf16', or 'int8' (per-token-slot absmax scales ride
#   the block table; dequant happens at the attention kernel's tile load,
#   so device-memory reads stay at int8 bytes).
# speculative_k: draft length K of the continuous-batching engine: 0 off;
#   K > 0 drafts K tokens per decode row (n-gram self-draft) and verifies
#   them as one q_len=K+1 ragged row inside the token budget.
_DEFAULTS: Dict[str, Any] = {"kv_cache_dtype": "auto", "speculative_k": 0}


def _parse(name: str, value: Any) -> Any:
    if name == "speculative_k":
        return int(value)
    value = str(value)
    if value not in _KV_CACHE_DTYPES:
        raise ValueError(
            f"FLAGS_kv_cache_dtype must be one of {_KV_CACHE_DTYPES}, "
            f"got {value!r}")
    return value


_VALUES: Dict[str, Any] = {
    n: _parse(n, os.environ.get("FLAGS_" + n, d))
    for n, d in _DEFAULTS.items()}


def _name(name: str) -> str:
    name = name.removeprefix("FLAGS_")
    if name not in _VALUES:
        raise ValueError(f"unknown flag: {name}")
    return name


def get_flag(name: str) -> Any:
    return _VALUES[_name(name)]


def set_flags(flags: Dict[str, Any]) -> None:
    for k, v in flags.items():
        k = _name(k)
        _VALUES[k] = _parse(k, v)
