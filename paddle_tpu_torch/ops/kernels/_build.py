"""Build and load the port's CUDA kernels.

Every ``paddle_tpu_torch/csrc/*.cu`` is compiled at first use by ``nvcc``
for Hopper (``sm_90a``) into a shared library with a plain C interface,
and loaded with ``ctypes``. One ``nvcc`` per source, all started together.
Libraries go to ``build/paddle_tpu_torch/`` beside the package, named by
a hash of every source and header and of the flags, so an edited source is
rebuilt and an unchanged one is loaded as it is.

Nothing is built when the module is imported: the CPU tests import every
module, and a build needs ``nvcc``, which a CPU-only machine lacks.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "paddle_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "-lineinfo"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}

# every LaunchCounter made, in creation order: a captured step graph
# records each counter's advance during its capture and adds it once per
# replay (jit/step_capture.py), because a replay runs no Python
COUNTERS: List["LaunchCounter"] = []


class LaunchCounter:
    """Counts launches of one kernel: its wrapper adds one where it
    launches the kernel, and nowhere else. A CUDA graph replay adds the
    launches its capture recorded, so the count stays the launches the
    card ran."""

    def __init__(self, name: str):
        self.name = name
        self.count = 0
        COUNTERS.append(self)

    def add(self) -> None:
        self.count += 1

    def reset(self) -> None:
        self.count = 0


_sm_counts: Dict[int, int] = {}


def sm_count(device) -> int:
    """Streaming multiprocessors of the CUDA ``device`` (cached)."""
    import torch
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    if idx not in _sm_counts:
        _sm_counts[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return _sm_counts[idx]


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found: the CUDA kernels build on a machine with the "
            "CUDA toolkit (PATH or /usr/local/cuda/bin)")
    return path


def _sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _lib_path(src: Path, digest: str) -> Path:
    return BUILD_DIR / f"lib{src.stem}_{digest}.so"


def build_all() -> float:
    """Compile every source whose library is missing; returns the seconds
    spent. Raises with nvcc's output if a compile fails. Processes that
    start together (the ranks of a job) build once: the first takes the
    build directory's file lock and compiles, the others wait on it and
    find the libraries built."""
    digest = _digest()
    if all(_lib_path(s, digest).exists() for s in _sources()):
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with open(BUILD_DIR / ".build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            _compile(digest)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return time.perf_counter() - t0


def _compile(digest: str) -> None:
    todo = [s for s in _sources() if not _lib_path(s, digest).exists()]
    if not todo:
        return
    nvcc = _nvcc()
    procs = []
    for src in todo:
        out = _lib_path(src, digest)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        log = open(BUILD_DIR / f"{src.stem}.log", "w")
        cmd = [nvcc, *NVCC_FLAGS, f"-I{CSRC}", "-o", str(tmp), str(src)]
        procs.append((src, out, tmp, log,
                      subprocess.Popen(cmd, stdout=log,
                                       stderr=subprocess.STDOUT)))
    failed = []
    for src, out, tmp, log, proc in procs:
        rc = proc.wait()
        log.close()
        if rc != 0:
            failed.append((src, (BUILD_DIR / f"{src.stem}.log").read_text()))
        else:
            os.replace(tmp, out)   # atomic: a concurrent loader sees all or nothing
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(
            f"--- {s.name} ---\n{txt}" for s, txt in failed))


def load(stem: str, bind=None) -> ctypes.CDLL:
    """The library built from ``csrc/<stem>.cu``, built first if needed.
    ``bind(lib)`` sets its functions' argtypes once, at first load."""
    with _lock:
        lib = _libs.get(stem)
        if lib is None:
            build_all()
            lib = ctypes.CDLL(str(_lib_path(CSRC / f"{stem}.cu", _digest())))
            if bind is not None:
                bind(lib)
            _libs[stem] = lib
        return lib


def ptxas_report(stem: str) -> Optional[str]:
    """nvcc's -Xptxas -v lines (registers, shared memory, spills) from the
    last build of ``stem``, or None if it was not built in this tree."""
    log = BUILD_DIR / f"{stem}.log"
    return log.read_text() if log.exists() else None


# dtype codes of the C interfaces
DTYPE_CODES = {"float32": 0, "bfloat16": 1, "int8": 2}
