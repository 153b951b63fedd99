"""``chip_smoke.py``'s profile parts, on the CPU: ``categorize`` sorts the
port's flash and varlen kernels by the exact stems of their symbols,
checked before the matmul patterns, so a templated tensor-core kernel
never lands in "matmul" or "other". The kernel names are read from the
CUDA sources, in the form ``torch.profiler`` gives them (demangled, with
template arguments). Importing the script needs no card."""

import importlib.util
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "paddle_tpu_torch" / "csrc"


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_under_test", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _kernels(src):
    text = (CSRC / src).read_text()
    return re.findall(r"__global__ void __launch_bounds__\([^)]*\)\s+(\w+)\(",
                      text)


def _profiled(name, dtype):
    """A kernel's name as the profiler shows it."""
    args = "128" if "_tc_" in name else f"{dtype}, 128"
    return (f"void (anonymous namespace)::{name}<{args}>({dtype} const*, "
            f"{dtype} const*, {dtype} const*, (anonymous namespace)::Lay, "
            f"int, int, float, int)")


ATTENTION_SOURCES = ("flash_attention.cu", "flash_varlen.cu")


@pytest.mark.parametrize("src", ATTENTION_SOURCES)
def test_categorize_sorts_every_attention_kernel_into_flash(src):
    smoke = _smoke()
    names = _kernels(src)
    assert {"fwd_kernel", "dq_kernel", "dkv_kernel"} <= set(names)
    assert sum("_tc_" in n for n in names) == 3
    for name in names:
        dtype = "__nv_bfloat16" if "_tc_" in name else "float"
        cats = smoke.categorize({_profiled(name, dtype): 2.0}, 2.0)
        want = "flash_fwd" if "fwd" in name else "flash_bwd"
        assert cats[want] == 2.0, (name, cats)
        assert cats["unaccounted"] == 0.0


@pytest.mark.parametrize("name,part", [
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64_"
     "warpgroupsize1x1x1_execute_segment_k_off_kernel__5x_cublas", "matmul"),
    ("nvjet_tst_128x256_64x4_2x1_v_bz_coopA_NTT", "matmul"),
    ("void at::native::vectorized_elementwise_kernel<4, "
     "at::native::CUDAFunctor_add<float>>(int, float*)", "other"),
    ("void (anonymous namespace)::fused_kernel<float>(Chunk const*)",
     "fused_optimizer"),
    ("void (anonymous namespace)::int4_gemm_kernel<__nv_bfloat16>(Problem)",
     "int4_gemm"),
])
def test_categorize_keeps_the_other_parts(name, part):
    cats = _smoke().categorize({name: 1.5}, 1.5)
    assert cats[part] == 1.5 and cats["unaccounted"] == 0.0


def test_a_tensor_core_name_with_a_matmul_pattern_stays_flash():
    """The stems are checked first: a name that also carries a matmul
    pattern (a CUTLASS type among its template arguments, say) is still
    attention."""
    name = ("void (anonymous namespace)::flash_tc_dkv<128>(cutlass::gemm::"
            "GemmShape<64, 64, 16>, __nv_bfloat16 const*)")
    cats = _smoke().categorize({name: 3.0}, 3.0)
    assert cats["flash_bwd"] == 3.0 and cats["matmul"] == 0.0
