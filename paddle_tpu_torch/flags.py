"""Runtime flags of the ported paths.

Counterpart of the JAX package's flag registry, cut to the flags the
serving, training and observability slices read. Same names, defaults and
meanings; ``FLAGS_<name>`` in the environment overrides a default,
:func:`set_flags` changes a value at run time, and :func:`on_set`
registers a callback that sees each new value (the rings of
``observability/`` resize through it).
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, List, Tuple

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
# metrics: the process-wide metrics registry (observability/metrics.py):
#   counters, gauges and histograms on the serving path; False makes
#   every increment one flag read.
# flight_recorder, flight_recorder_size, flight_recorder_path: the
#   bounded ring of the last N op dispatches at the op choke point
#   (observability/flight_recorder.py), dumped to the path (stderr when
#   empty) on an uncaught exception.
# tracing, tracing_ring_size, tracing_path: request and step spans over a
#   bounded ring (observability/tracing.py), exported as Chrome-trace
#   JSON; False makes every span one flag read.
# telemetry_port: the /metrics /healthz /statusz /trace /debugz endpoint
#   (observability/exporter.py): -1 off, 0 a free port, > 0 that port.
# perf_attribution: the executable ledger of the reference's
#   observability/perf.py (and /perfz), not ported yet: True raises where
#   it would record (ROADMAP.md, A9).
# incident_recorder: the incident forensics plane
#   (observability/incident.py): on a terminal transition (a serving step
#   hang, a fleet failover, an uncaught exception, /debugz?record=1) ONE
#   committed incident-<step>-<uid>/ bundle (classified host stacks, the
#   trace ring, the flight-recorder tail, a metrics snapshot, the flags)
#   under the attached root; False makes every trigger one flag read.
# incident_dir: an explicit bundle root; empty = the root the serving
#   engine or the router attached (their own <root>/incidents).
# incident_keep: committed bundles beyond the newest K are pruned after
#   each commit.
# incident_rate_limit_s: least seconds between two bundles of one kind;
#   0 = unlimited.
# comm_timeout_s: the collective watchdog's timeout (distributed/
#   watchdog.py): an eager collective that outlives it fires the
#   watchdog's handlers and publishes the failure through the store.
_FLAGS: Dict[str, Tuple[Any, Callable[[Any], Any]]] = {
    "kv_cache_dtype": ("auto", _choice("kv_cache_dtype", _KV_CACHE_DTYPES)),
    "speculative_k": (0, int),
    "fused_optimizer": (True, _bool),
    "anomaly_sentinel": (False, _bool),
    "use_pallas_kernels": (True, _bool),
    "check_nan_inf": (False, _bool),
    "step_capture": (True, _bool),
    "multi_step": (0, int),
    "metrics": (True, _bool),
    "flight_recorder": (True, _bool),
    "flight_recorder_size": (256, int),
    "flight_recorder_path": ("", str),
    "tracing": (True, _bool),
    "tracing_ring_size": (4096, int),
    "tracing_path": ("", str),
    "telemetry_port": (-1, int),
    "perf_attribution": (False, _bool),
    "incident_recorder": (True, _bool),
    "incident_dir": ("", str),
    "incident_keep": (8, int),
    "incident_rate_limit_s": (30.0, float),
    "comm_timeout_s": (600.0, float),
}

# flags that route no kernel: a captured step's key leaves them out
OBSERVABILITY_FLAGS = frozenset({
    "metrics", "flight_recorder", "flight_recorder_size",
    "flight_recorder_path", "tracing", "tracing_ring_size", "tracing_path",
    "telemetry_port", "perf_attribution", "incident_recorder",
    "incident_dir", "incident_keep", "incident_rate_limit_s",
    "comm_timeout_s"})

_VALUES: Dict[str, Any] = {
    n: parse(os.environ.get("FLAGS_" + n, d))
    for n, (d, parse) in _FLAGS.items()}


# bumped by every set_flags: capture keys fold it in, so a flag change
# re-probes instead of replaying a graph recorded under the old routes
version = 0

_ON_SET: Dict[str, List[Callable[[Any], None]]] = {}


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


def on_set(name: str, fn: Callable[[Any], None]) -> None:
    """Call ``fn(new_value)`` after every :func:`set_flags` of ``name``."""
    _ON_SET.setdefault(_name(name), []).append(fn)


def set_flags(flags: Dict[str, Any]) -> None:
    global version
    for k, v in flags.items():
        k = _name(k)
        _VALUES[k] = _FLAGS[k][1](v)
        for fn in _ON_SET.get(k, ()):
            fn(_VALUES[k])
    version += 1
