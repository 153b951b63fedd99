"""On-demand all-thread host stack capture with hang attribution.

Counterpart of ``paddle_tpu/observability/debug.py``: the same frozen
:data:`STACK_CLASSES` vocabulary, the same precedence order and the same
``capture_stacks`` / ``classify_frames`` / ``format_stacks`` /
``stacks_snapshot`` API. The step-hang watchdog
(serving/resilience/engine.py) and the fleet's health machine can
*detect* a wedge, but detection alone only says "no progress for N
seconds" -- the diagnostic fact is WHERE the wedged thread is parked.
This module captures every thread's host stack via
``sys._current_frames`` (with a ``traceback`` fallback on interpreters
that hide frame access) and classifies each stack against the frames the
framework owns:

==================  ================================================
class               innermost owned frame
==================  ================================================
``data_wait``       DataLoader prefetch/ring fill, batch queue get
``jit_compile``     a CUDA-graph capture (``torch/cuda/graphs.py``,
                    ``jit/step_capture.py``, ``jit/multi_step.py``) or
                    the kernels' nvcc build (``ops/kernels/_build.py``)
``exec_cache_load``  kept in the frozen set and never produced: the
                    persistent executable store (``jit/exec_store.py``)
                    is not ported yet (ROADMAP.md, A9)
``device_call``     the host waiting on the card: ``torch.cuda.
                    synchronize``, an Event's or a Stream's
                    ``synchronize``, a graph's ``replay`` and the port's
                    own sync sites (the engines' ``_host_read`` of the
                    sampled tokens)
``collective``      eager collective APIs / cross-host sync
``journal_fsync``   durability fsync_write / journal flush
``lock_wait``       a ``threading`` lock/condition/event acquire
``idle``            a daemon helper parked in its own poll loop
``other``           none of the above (stack attached verbatim)
==================  ================================================

The reference's two rules that name JAX frames (XLA lowering and
compiling, ``block_until_ready`` and device execute) name the port's
frames above instead; a C++ wait under a Python frame (a ``.cpu()``, an
``.item()``) is attributed through the Python frame that called it, so
the port's sync sites are named functions. Rules apply in precedence
order, each scanned over the whole stack, so a lock acquired *inside*
the journal flush classifies as the flush (the subsystem), not the lock
(the mechanism). Capture is read-only and allocation-light -- it is safe
to call from a watchdog scan thread microseconds before ``os._exit``.
"""

from __future__ import annotations

import sys
import threading
import traceback
from typing import Any, Dict, List, Optional, Sequence, Tuple

__all__ = ["STACK_CLASSES", "capture_stacks", "classify_frames",
           "format_stacks", "stacks_snapshot"]

# the frozen attribution vocabulary (/debugz, incident bundles and the
# chaos tests key on these — same discipline as METRIC_NAMES)
STACK_CLASSES = frozenset({
    "data_wait", "jit_compile", "exec_cache_load", "device_call",
    "collective", "journal_fsync", "lock_wait", "idle", "other",
})

# (class, filename substrings, function names) — a frame matches when
# ANY listed substring is in its filename (empty tuple = any file) AND
# ANY listed function matches (empty tuple = any function). Order is
# precedence: specific subsystems before the generic lock/idle buckets.
_FRAME_RULES: Tuple[Tuple[str, Tuple[str, ...], Tuple[str, ...]], ...] = (
    ("journal_fsync", ("utils/durability", "serving/resilience/journal"),
     ("fsync_write", "fsync_dir", "flush", "commit")),
    ("collective", ("distributed/collective", "distributed/watchdog"),
     ()),
    ("data_wait", ("io/dataloader", "dataloader", "reader",
                   "paddle_tpu_torch/io/"),
     ("fill_ring", "next_batch", "_prefetch", "__next__", "get")),
    # before jit_compile: a thread parked deserializing a cached
    # executable is a cache LOAD, not a compile (no such frame until the
    # executable store is ported)
    ("exec_cache_load", ("jit/exec_store",), ()),
    # a CUDA-graph capture, or nvcc building the kernels' libraries
    # (build_all waits on one nvcc process per source) and their load
    ("jit_compile", ("torch/cuda/graphs", "jit/step_capture",
                     "jit/multi_step", "ops/kernels/_build"),
     ("capture_begin", "capture_end", "capture_graph", "_capture",
      "capture", "build_all", "load")),
    # the host waiting on the card
    ("device_call", ("torch/cuda/__init__", "torch/cuda/streams",
                     "torch/cuda/graphs", "jit/step_capture",
                     "models/serving"),
     ("synchronize", "replay", "_host_read")),
    ("data_wait", ("queue.py",), ("get", "put")),
    ("lock_wait", ("threading.py",),
     ("wait", "acquire", "_wait_for_tstate_lock", "join")),
)

# helper threads whose *outermost* frame lives in one of these files are
# parked in their own poll loop — report them as idle, not lock_wait,
# so a hang report leads with the thread that matters
_IDLE_OWNERS = ("observability/exporter", "socketserver", "selectors")


def _match(rule_files: Tuple[str, ...], rule_funcs: Tuple[str, ...],
           filename: str, func: str) -> bool:
    if rule_files and not any(s in filename for s in rule_files):
        return False
    if rule_funcs and func not in rule_funcs:
        return False
    return True


def classify_frames(frames: Sequence[Tuple[str, int, str]]) -> str:
    """Attribution class for one thread's stack — ``frames`` is
    innermost-first ``(filename, lineno, funcname)`` triples.

    Rules are tried in precedence order, each over the whole stack, so
    subsystem attribution beats mechanism: a ``queue.get`` parks its
    innermost frame in ``threading.Condition.wait``, but the thread is
    waiting on DATA, not on a lock."""
    for cls, rule_files, rule_funcs in _FRAME_RULES:
        for filename, _lineno, func in frames:
            if _match(rule_files, rule_funcs,
                      filename.replace("\\", "/"), func):
                if cls == "lock_wait" and frames:
                    outer = frames[-1][0].replace("\\", "/")
                    if any(s in outer for s in _IDLE_OWNERS):
                        return "idle"
                return cls
    return "other"


def _thread_table() -> Dict[int, threading.Thread]:
    return {t.ident: t for t in threading.enumerate() if t.ident}


def capture_stacks(max_frames: int = 40) -> List[Dict[str, Any]]:
    """Every thread's classified host stack, newest frame first.

    Returns one dict per thread: ``{"thread_id", "name", "daemon",
    "current", "class", "frames": [(file, line, func), ...]}`` —
    JSON-serializable so it lands in incident bundles verbatim. Falls
    back to a single unclassified pseudo-thread built from
    ``faulthandler`` when ``sys._current_frames`` is unavailable."""
    try:
        current = sys._current_frames()
    except (AttributeError, RuntimeError):
        return _capture_fallback()
    me = threading.get_ident()
    table = _thread_table()
    out: List[Dict[str, Any]] = []
    for ident, frame in current.items():
        frames: List[Tuple[str, int, str]] = []
        f = frame
        while f is not None and len(frames) < max_frames:
            frames.append((f.f_code.co_filename, f.f_lineno,
                           f.f_code.co_name))
            f = f.f_back
        th = table.get(ident)
        out.append({
            "thread_id": ident,
            "name": th.name if th is not None else f"thread-{ident}",
            "daemon": bool(th.daemon) if th is not None else None,
            "current": ident == me,
            "class": classify_frames(frames),
            "frames": frames,
        })
    # the capturing thread last: the wedged thread is the story
    out.sort(key=lambda d: (d["current"], d["name"]))
    return out


def _capture_fallback() -> List[Dict[str, Any]]:
    """Degraded capture path: whatever the traceback module can see of
    this thread (non-CPython interpreters without _current_frames)."""
    frames = [(fs.filename, fs.lineno, fs.name)
              for fs in reversed(traceback.extract_stack())]
    return [{
        "thread_id": threading.get_ident(),
        "name": threading.current_thread().name,
        "daemon": threading.current_thread().daemon,
        "current": True,
        "class": classify_frames(frames),
        "frames": frames,
    }]


def stacks_snapshot() -> Dict[str, Any]:
    """The /debugz payload: classified stacks plus the per-class tally
    that lets an operator read the attribution without scrolling."""
    stacks = capture_stacks()
    tally: Dict[str, int] = {}
    for s in stacks:
        tally[s["class"]] = tally.get(s["class"], 0) + 1
    return {"threads": len(stacks), "by_class": tally, "stacks": stacks}


def format_stacks(stacks: Optional[List[Dict[str, Any]]] = None,
                  max_frames: int = 12) -> str:
    """Human-readable rendering (stderr fallback dumps and /debugz)."""
    if stacks is None:
        stacks = capture_stacks()
    lines: List[str] = [f"{len(stacks)} threads:"]
    for s in stacks:
        flag = " <- capturing" if s.get("current") else ""
        lines.append(f"thread {s['name']} (id={s['thread_id']}, "
                     f"daemon={s['daemon']}) class={s['class']}{flag}")
        for filename, lineno, func in s["frames"][:max_frames]:
            lines.append(f"    {filename}:{lineno} in {func}")
        if len(s["frames"]) > max_frames:
            lines.append(f"    ... {len(s['frames']) - max_frames} "
                         f"outer frames elided")
    return "\n".join(lines) + "\n"
