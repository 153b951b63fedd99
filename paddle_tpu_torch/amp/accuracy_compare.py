"""AMP accuracy comparison: per-op tensor statistics of two runs, merged
and graded.

Counterpart of ``paddle_tpu/amp/accuracy_compare.py``: ``TensorInfo``,
``collect_tensor_infos`` (a ``TensorInfo`` per floating output of every op
at the choke point, through the dispatcher's tensor-stats hook, written as
``tensor_info.jsonl`` in the reference's format) and ``compare_accuracy``
(the same merge by ``op#k:out_i`` key, the same grades and the same JSON
report).

    with collect_tensor_infos("dump_fp32"):
        model(x)
    with amp.auto_cast(dtype="bfloat16"), collect_tensor_infos("dump_bf16"):
        model(x)
    rows = compare_accuracy("dump_fp32", "dump_bf16", "report.json")

Each statistic is a host read of the output (a sync per op): a debugging
tool.
"""

from __future__ import annotations

import contextlib
import json
import os
from collections import defaultdict
from dataclasses import asdict, dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from ..ops import dispatcher

__all__ = ["TensorInfo", "collect_tensor_infos", "compare_accuracy"]


@dataclass
class TensorInfo:
    """Statistics of one op output."""
    op_type: str
    tensor_name: str
    dtype: str
    numel: int
    max_value: float
    min_value: float
    mean_value: float
    num_inf: int
    num_nan: int
    num_zero: int

    @property
    def key(self) -> str:
        return f"{self.op_type}:{self.tensor_name}"


def _info_of(op_type: str, name: str, t: torch.Tensor
             ) -> Optional[TensorInfo]:
    if not (t.is_floating_point() or t.is_complex()):
        return None
    a = t.detach().to(torch.float64).cpu().numpy()
    finite = a[np.isfinite(a)]
    return TensorInfo(
        op_type=op_type,
        tensor_name=name,
        dtype=str(t.dtype).removeprefix("torch."),
        numel=int(a.size),
        max_value=float(finite.max()) if finite.size else float("nan"),
        min_value=float(finite.min()) if finite.size else float("nan"),
        mean_value=float(finite.mean()) if finite.size else float("nan"),
        num_inf=int(np.isinf(a).sum()),
        num_nan=int(np.isnan(a).sum()),
        num_zero=int((a == 0).sum()),
    )


@contextlib.contextmanager
def collect_tensor_infos(dump_dir: str,
                         specified_op_list: Optional[list] = None):
    """Record a TensorInfo for every op output into
    ``dump_dir/tensor_info.jsonl``. Call sites are told apart by a per-op
    sequence number (``op#k:out_i``), so two runs of the same code merge
    position by position."""
    os.makedirs(dump_dir, exist_ok=True)
    infos: List[TensorInfo] = []
    seq: Dict[str, int] = defaultdict(int)

    def hook(op_name, outs):
        if specified_op_list and op_name not in specified_op_list:
            return
        k = seq[op_name]
        seq[op_name] += 1
        for i, t in enumerate(outs):
            info = _info_of(op_name, f"{op_name}#{k}:out{i}", t)
            if info is not None:
                infos.append(info)

    prev = dispatcher._TENSOR_STATS_HOOK
    dispatcher.set_tensor_stats_hook(hook)
    try:
        yield infos
    finally:
        dispatcher.set_tensor_stats_hook(prev)
        with open(os.path.join(dump_dir, "tensor_info.jsonl"), "w") as f:
            for info in infos:
                f.write(json.dumps(asdict(info)) + "\n")


def _load_run(dump_dir: str) -> Dict[str, TensorInfo]:
    out: Dict[str, TensorInfo] = {}
    with open(os.path.join(dump_dir, "tensor_info.jsonl")) as f:
        for line in f:
            info = TensorInfo(**json.loads(line))
            out[info.key] = info
    return out


def compare_accuracy(dump_path: str, another_dump_path: str,
                     output_filename: str, loss_scale: float = 1.0,
                     dump_all_tensors: bool = False) -> List[dict]:
    """Merge two ``collect_tensor_infos`` dumps (first the float32 run,
    then the low-precision one) and write the graded report: per tensor
    ``infinite`` (the low run has more inf/nan), ``diverged`` (max, min
    or mean outside rtol/atol 1e-2 of the float32 run's), ``ok`` (left
    out unless ``dump_all_tensors``) or ``missing``."""
    ref_run = _load_run(dump_path)
    low_run = _load_run(another_dump_path)
    rows: List[dict] = []
    for key in sorted(set(ref_run) | set(low_run)):
        a, b = ref_run.get(key), low_run.get(key)
        if a is None or b is None:
            rows.append({"tensor": key, "grade": "missing",
                         "present_in": "fp32" if a else "low"})
            continue
        if (b.num_inf + b.num_nan) > (a.num_inf + a.num_nan):
            grade = "infinite"
        else:
            def close(x, y):
                if np.isnan(x) and np.isnan(y):
                    return True
                return bool(np.isclose(x, y, rtol=1e-2, atol=1e-2))

            grade = "ok" if (close(a.max_value, b.max_value)
                             and close(a.min_value, b.min_value)
                             and close(a.mean_value, b.mean_value)) \
                else "diverged"
        if grade == "ok" and not dump_all_tensors:
            continue
        rows.append({"tensor": key, "grade": grade,
                     "fp32": asdict(a), "low": asdict(b)})
    with open(output_filename, "w") as f:
        json.dump(rows, f, indent=1)
    return rows
