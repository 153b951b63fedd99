"""The PyTorch port stands alone: no module under ``paddle_tpu_torch/``,
not ``chip_smoke.py`` and not the card-only kernel tests (which run
where there is no JAX) imports ``jax`` or ``paddle_tpu`` (an AST scan of
every import statement, top level or inside a function), and importing
the port loads neither."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "paddle_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "tests" / "test_torch_cuda_kernels.py"]
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
            "optimizer.py", "clip.py", "api.py", "chip_smoke.py"} <= names


def test_import_loads_neither_jax_nor_reference():
    code = ("import sys, paddle_tpu_torch.models, "
            "paddle_tpu_torch.ops.kernels.serving, paddle_tpu_torch.amp, "
            "paddle_tpu_torch.jit, paddle_tpu_torch.optimizer; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'paddle_tpu')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
