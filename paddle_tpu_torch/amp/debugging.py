"""AMP debugging tools.

Counterpart of ``paddle_tpu/amp/debugging.py``: operator-stats collection
(``enable_operator_stats_collection``, ``disable_operator_stats_collection``,
``collect_operator_stats``) on the op choke point's span hook,
``TensorCheckerConfig`` with ``enable_tensor_checker`` /
``disable_tensor_checker`` on ``FLAGS_check_nan_inf``, ``check_numerics``,
and ``compare_accuracy`` over two ``.npz`` tensor dumps (the reference's
function of this module; the run comparer over tensor-stats dumps is
``amp.accuracy_compare.compare_accuracy``).

The port counts the ops that pass its choke point (``ops/dispatcher.py:
hooked``), by the reference's op names; its raw tensor arithmetic is not
counted, where the reference counts every Tensor method.
"""

from __future__ import annotations

import contextlib
import json
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import flags
from ..ops import dispatcher

_op_stats: Optional[Dict[str, Dict[str, int]]] = None
_prev_hook = None


def _stats_hook(op_name: str):
    if _op_stats is not None:
        _op_stats[op_name]["calls"] += 1
    return contextlib.nullcontext()


def enable_operator_stats_collection() -> None:
    """Start counting calls per op; the span hook in place before (e.g. a
    profiler's) is saved and put back by the disable."""
    global _op_stats, _prev_hook
    _op_stats = defaultdict(lambda: {"calls": 0})
    _prev_hook = dispatcher._OP_SPAN_HOOK
    dispatcher.set_op_span_hook(_stats_hook)


def disable_operator_stats_collection() -> Dict[str, Dict[str, int]]:
    """Stop counting; print the reference's table and return ``{op:
    {"calls": n}}``."""
    global _op_stats, _prev_hook
    dispatcher.set_op_span_hook(_prev_hook)
    _prev_hook = None
    stats = dict(_op_stats or {})
    _op_stats = None
    if stats:
        print("<------------------------------ op list "
              "------------------------------->")
        for name, s in sorted(stats.items()):
            print(f"  {name:<40} calls: {s['calls']}")
        print("<----------------------------- op count "
              f"{len(stats)} ----------------------------->")
    return stats


@contextlib.contextmanager
def collect_operator_stats():
    enable_operator_stats_collection()
    try:
        yield
    finally:
        disable_operator_stats_collection()


class TensorCheckerConfig:
    """The NaN/Inf checker's switch (the reference's subset)."""

    def __init__(self, enable: bool = True, debug_mode=None,
                 checked_op_list=None, skipped_op_list=None):
        self.enable = enable
        self.checked_op_list = checked_op_list
        self.skipped_op_list = skipped_op_list


def enable_tensor_checker(config: TensorCheckerConfig) -> None:
    flags.set_flags({"check_nan_inf": bool(config.enable)})


def disable_tensor_checker() -> None:
    flags.set_flags({"check_nan_inf": False})


def check_numerics(tensor, op_type: str = "", var_name: str = "") -> tuple:
    """``(num_nan, num_inf)``; raises ``FloatingPointError`` when either
    is non-zero."""
    data = torch.as_tensor(tensor)
    num_nan = int(torch.isnan(data).sum())
    num_inf = int(torch.isinf(data).sum())
    if num_nan or num_inf:
        raise FloatingPointError(
            f"check_numerics: {num_nan} NaN / {num_inf} Inf in "
            f"{op_type or 'tensor'} {var_name}")
    return num_nan, num_inf


def compare_accuracy(dump_path: str, another_dump_path: str,
                     output_filename: str, loss_scale: float = 1.0,
                     dump_all_tensors: bool = False) -> List[dict]:
    """Compare two ``.npz`` tensor dumps (e.g. a float32 run and a bf16
    run) tensor by tensor and write the max abs / rel diff report as
    JSON."""
    a = np.load(dump_path)
    b = np.load(another_dump_path)
    rows = []
    for key in sorted(set(a.files) & set(b.files)):
        x = np.asarray(a[key], np.float64)
        y = np.asarray(b[key], np.float64)
        if x.shape != y.shape:
            rows.append({"tensor": key, "error": "shape mismatch",
                         "a_shape": list(x.shape), "b_shape": list(y.shape)})
            continue
        diff = np.abs(x - y)
        rows.append({
            "tensor": key,
            "max_abs_diff": float(diff.max()) if diff.size else 0.0,
            "max_rel_diff": float((diff / (np.abs(x) + 1e-9)).max())
            if diff.size else 0.0,
            "a_has_nan": bool(np.isnan(x).any()),
            "b_has_nan": bool(np.isnan(y).any()),
        })
    with open(output_filename, "w") as f:
        json.dump(rows, f, indent=1)
    return rows
