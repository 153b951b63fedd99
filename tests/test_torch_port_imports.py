"""The PyTorch port stands alone: no module under ``paddle_tpu_torch/``,
not ``chip_smoke.py``, no script under ``tools/``, not the card-only
kernel tests (which run where there is no JAX) and not the ranks of the
parallelism tests' launches (``tests/_torch_*_worker.py``) imports ``jax`` or
``paddle_tpu`` (an AST scan of every import statement, top level or
inside a function), and importing the port loads neither."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "paddle_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", *sorted((ROOT / "tools").glob("*.py")),
    ROOT / "tests" / "test_torch_cuda_kernels.py",
    *sorted((ROOT / "tests").glob("_torch_*_worker.py"))]
BANNED = ("jax", "jaxlib", "paddle_tpu")


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _banned(name):
    top = name.split(".")[0]
    return top in BANNED


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    bad = [n for n in _imports(path) if _banned(n)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_scan_sees_the_whole_port():
    names = {p.name for p in FILES}
    assert {"serving.py", "llama.py", "ragged_paged_attention.py",
            "paged_attention.py", "flash_attention.py", "fused_optimizer.py",
            "optimizer.py", "clip.py", "api.py", "flash_varlen.py",
            "dispatcher.py", "chip_smoke.py", "bcsr_spmm.py",
            "step_capture.py", "multi_step.py", "model.py",
            "callbacks.py", "recompute.py", "stack.py", "layer_base.py",
            "layers_common.py", "initializer.py", "loss.py",
            "functional.py", "extra_nn.py", "detection.py", "vision_io.py",
            "datasets.py", "transforms.py", "resnet.py", "yolov3.py",
            "mobilenet.py", "googlenet.py", "densenet.py",
            "shufflenetv2.py", "squeezenet.py", "vgg.py", "alexnet.py",
            "lenet.py", "metrics.py", "tracing.py", "flight_recorder.py",
            "exporter.py", "extra_misc.py", "generation.py",
            "linalg_fft.py", "extra_math.py", "graph.py", "linalg.py",
            "fft.py", "signal.py", "features.py", "backends.py",
            "durability.py", "debug.py", "incident.py", "elastic.py",
            "journal.py", "warm_cache.py", "engine.py", "health.py",
            "replica.py", "router.py", "worker.py", "ring_attention.py",
            "sequence_parallel_utils.py", "pp_layers.py",
            "meta_parallel.py", "pipeline.py", "pp_schedules.py",
            "_torch_sequence_parallel_worker.py",
            "_torch_expert_parallel_worker.py",
            "_torch_pipeline_worker.py"} <= names
    for pkg in ("sparse", "io", "hapi", "distributed", "nn", "metric",
                "vision", "vision/models", "vision/transforms",
                "observability", "audio", "text", "geometric", "utils",
                "serving", "serving/resilience", "serving/fleet",
                "distributed/fleet"):
        assert ROOT / "paddle_tpu_torch" / pkg / "__init__.py" in FILES


def test_import_loads_neither_jax_nor_reference():
    code = ("import sys, paddle_tpu_torch.models, "
            "paddle_tpu_torch.ops.kernels.serving, paddle_tpu_torch.amp, "
            "paddle_tpu_torch.jit, paddle_tpu_torch.optimizer, "
            "paddle_tpu_torch.ops.dispatcher, paddle_tpu_torch.sparse, "
            "paddle_tpu_torch.ops.kernels.bcsr_spmm, paddle_tpu_torch.io, "
            "paddle_tpu_torch.hapi, paddle_tpu_torch.jit.multi_step, "
            "paddle_tpu_torch.jit.step_capture, paddle_tpu_torch.nn, "
            "paddle_tpu_torch.nn.functional, paddle_tpu_torch.distributed, "
            "paddle_tpu_torch.vision, paddle_tpu_torch.vision.models, "
            "paddle_tpu_torch.vision.transforms, paddle_tpu_torch.metric, "
            "paddle_tpu_torch.ops.kernels.detection, "
            "paddle_tpu_torch.ops.kernels.extra_nn, "
            "paddle_tpu_torch.ops.kernels.vision_io, "
            "paddle_tpu_torch.observability, "
            "paddle_tpu_torch.observability.exporter, "
            "paddle_tpu_torch.ops.kernels.extra_misc, "
            "paddle_tpu_torch.ops.kernels.linalg_fft, "
            "paddle_tpu_torch.ops.kernels.extra_math, "
            "paddle_tpu_torch.ops.kernels.graph, paddle_tpu_torch.linalg, "
            "paddle_tpu_torch.fft, paddle_tpu_torch.signal, "
            "paddle_tpu_torch.audio, paddle_tpu_torch.audio.datasets, "
            "paddle_tpu_torch.text, paddle_tpu_torch.text.datasets, "
            "paddle_tpu_torch.geometric, paddle_tpu_torch.utils, "
            "paddle_tpu_torch.utils.durability, paddle_tpu_torch.serving, "
            "paddle_tpu_torch.serving.resilience, "
            "paddle_tpu_torch.serving.fleet, "
            "paddle_tpu_torch.serving.fleet.worker, "
            "paddle_tpu_torch.distributed.fleet, "
            "paddle_tpu_torch.observability.incident; "
            "paddle_tpu_torch.ops.dispatcher.build_ops(); "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'paddle_tpu')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
