"""``chip_smoke.py``'s profile parts, on the CPU: ``categorize`` sorts the
port's flash and varlen kernels by the exact stems of their symbols,
checked before the matmul patterns, so a templated tensor-core kernel
never lands in "matmul" or "other", and every grouped-GEMM and int4-GEMM
kernel into its own part. The kernel names are read from the CUDA
sources, in the form ``torch.profiler`` gives them (demangled, with
template arguments). ``ptxas_tc_kernels`` reads the tensor-core kernels'
rows of nvcc's ``-Xptxas -v`` report, the float32 attention kernels' shared
memory as csrc/flash_f32.cuh sizes it. The scheduled mixed-precision
phase's checks: ``lr_mismatches`` passes the lr that a CPU optimizer's
fused route reads under a scheduler and catches a planted stale lr
scalar, and ``launch_pattern_errors`` passes one fused AdamW launch per
bucket per optimizer step with a flash launch per layer on every call,
and flags any other count. ``profiled_kernels`` reads a route from the
first profiler window that recorded every stem, keeps the windows that
lost one, fails when none held them all, and leaves a route with no
device time not measured. The step-capture checks: ``check_capture``
passes a token-identical run with one capture and steps - 1 replays and
fails a changed token, a replay short, a second capture, a fallback or
an eager run that captured; ``moe_spread`` holds a run inside the eager
runs' band and fails one outside it; ``bits_fingerprint`` sees one flipped
bit in float32, bf16 and int8; and the lr check passes through a captured
step's replays. Importing the script needs no card."""

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
    """The ``__global__`` names of a source and of the local headers it
    includes (the gang decode's passes live in ``paged_split.cuh``)."""
    text = (CSRC / src).read_text()
    for hdr in re.findall(r'#include "(\w+\.cuh)"', text):
        text += (CSRC / hdr).read_text()
    return re.findall(r"__global__ void __launch_bounds__\([^)]*\)\s+(\w+)\(",
                      text)


def _profiled(name, dtype):
    """A kernel's name as the profiler shows it (the float32 forward's
    second argument: the query heads a block owns)."""
    args = "128, 2" if name == "fwd_kernel" else "128"
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


GEMM_SOURCES = {"grouped_gemm.cu": ("grouped_gemm", "grouped_gemm_"),
                "weight_only_gemm.cu": ("int4_gemm", "int4_gemm_"),
                "bcsr_spmm.cu": ("bcsr_spmm", "bcsr_spmm_")}


@pytest.mark.parametrize("src", sorted(GEMM_SOURCES))
def test_categorize_sorts_every_gemm_kernel_into_its_part(src):
    """Every ``__global__`` of the GEMM sources (the wgmma routes, split-k
    and its reduction, the kernels kept for unaligned shapes, the float32
    kernels at every M tile) keeps its stem, so no name falls to the
    generic "matmul" pattern."""
    smoke = _smoke()
    part, stem = GEMM_SOURCES[src]
    names = _kernels(src)
    assert len(names) >= 3 and all(n.startswith(stem) for n in names), names
    for name in names:
        for args in ("true", "false", "16, __nv_bfloat16", "float", "16",
                     "32", "64", "128"):
            prof = (f"void (anonymous namespace)::{name}<{args}>((anonymous "
                    f"namespace)::Problem)")
            cats = smoke.categorize({prof: 1.25}, 1.25)
            assert cats[part] == 1.25 and cats["matmul"] == 0.0, (name, cats)
            assert cats["unaccounted"] == 0.0


def test_ptxas_rows_name_the_gemm_kernels():
    """``ptxas_tc_kernels`` reads registers, spills and shared memory of
    the GEMM kernels from nvcc's report (mangled names, as ptxas prints
    them), beside the attention kernels."""
    txt = "\n".join([
        "ptxas info    : Compiling entry function '_ZN40_GLOBAL__N__x_19_"
        "weight_only_gemm_cu_y23int4_gemm_decode_kernelILi16E13__nv_bfloat16"
        "EEvNS_4ArgsE' for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 66 registers, used 1 barriers",
        "ptxas info    : Compiling entry function '_ZN40_GLOBAL__N__x_15_"
        "grouped_gemm_cu_y24grouped_gemm_wmma_kernelILb1EEEvNS_7ProblemE' "
        "for 'sm_90a'",
        "    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads",
        "ptxas info    : Used 126 registers, used 1 barriers, 28672 bytes "
        "smem",
        "ptxas info    : Compiling entry function '_ZN40_GLOBAL__N__x_18_"
        "flash_attention_cu_y12flash_tc_fwdILi128EEEvPK13__nv_bfloat16' for "
        "'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 175 registers, used 1 barriers"])
    smoke = _smoke()
    rows = {r["kernel"]: r for r in smoke.ptxas_tc_kernels(txt)}
    assert set(rows) == {"int4_gemm_decode_kernel<16, bf16>",
                         "grouped_gemm_wmma_kernel<true>", "flash_tc_fwd<128>"}
    dec = rows["int4_gemm_decode_kernel<16, bf16>"]
    assert dec["registers"] == 66 and dec["spill_stores"] == 0
    assert dec["smem_bytes"] == smoke.gemm_smem_bytes(
        "int4_gemm_decode_kernel", ["16", "bf16"]) > 0
    wmma = rows["grouped_gemm_wmma_kernel<true>"]
    assert (wmma["smem_bytes"], wmma["spill_stores"], wmma["spill_loads"]) \
        == (28672, 8, 4)
    assert rows["flash_tc_fwd<128>"]["smem_bytes"] == \
        smoke.tc_smem_bytes("fwd", 128)


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


@pytest.mark.parametrize("src", ["paged_attention.cu",
                                 "ragged_paged_attention.cu"])
def test_categorize_sorts_every_paged_kernel_into_paged_attention(src):
    """Both passes of the gang decode (the split-KV pass and its merge) and
    the ragged kernels (that split pass, the tile passes, their merge)
    land in "paged_attention", whatever their template arguments."""
    smoke = _smoke()
    names = _kernels(src)
    if src == "paged_attention.cu":
        assert set(names) == set(smoke.DECODE_KERNELS)
    assert names
    for name in names:
        for args in ("__nv_bfloat16, signed char, 128, 4", "float, 64"):
            prof = (f"void (anonymous namespace)::{name}<{args}>((anonymous "
                    f"namespace)::Decode)")
            cats = smoke.categorize({prof: 0.75}, 0.75)
            assert cats["paged_attention"] == 0.75, (name, cats)
            assert cats["unaccounted"] == 0.0


def test_ptxas_rows_name_the_bcsr_and_decode_kernels():
    """The wgmma BCSR kernel and both gang-decode passes get rows
    (registers, spills, shared memory as the sources size it), int8 and
    a substituted bf16 among the template arguments."""
    txt = "\n".join([
        "ptxas info    : Compiling entry function '_ZN40_GLOBAL__N__x_12_"
        "bcsr_spmm_cu_y22bcsr_spmm_wgmma_kernelILi64EEEvNS_6SparseE' for "
        "'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 168 registers, used 1 barriers",
        "ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__x_18_"
        "paged_attention_cu_y28paged_attention_split_kernelI13__nv_bfloat16"
        "aLi128ELi4EEEvNS_6DecodeE' for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 135 registers, used 1 barriers",
        "ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__x_18_"
        "paged_attention_cu_y28paged_attention_split_kernelI13__nv_bfloat16"
        "S1_Li64ELi8EEEvNS_6DecodeE' for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 136 registers, used 1 barriers",
        "ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__x_18_"
        "paged_attention_cu_y28paged_attention_merge_kernelIfLi128EEEvNS_6"
        "DecodeE' for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 32 registers, used 0 barriers"])
    smoke = _smoke()
    rows = {r["kernel"]: r for r in smoke.ptxas_tc_kernels(txt)}
    assert set(rows) == {
        "bcsr_spmm_wgmma_kernel<64>",
        "paged_attention_split_kernel<bf16, int8, 128, 4>",
        "paged_attention_split_kernel<bf16, bf16, 64, 8>",
        "paged_attention_merge_kernel<float, 128>"}
    assert rows["bcsr_spmm_wgmma_kernel<64>"]["smem_bytes"] == \
        4 * (64 * 64 + 64 * 256) * 2 + 1024
    # int8: 3 stages of 64 K and V rows of 128 bytes and their scales, q
    # [4][128] and P [4][4][16] in float32, 512 table ids
    assert rows["paged_attention_split_kernel<bf16, int8, 128, 4>"][
        "smem_bytes"] == 3 * (2 * 64 * 128 + 512) + 4 * 128 * 4 \
        + 4 * 4 * 16 * 4 + 512 * 4
    assert rows["paged_attention_split_kernel<bf16, bf16, 64, 8>"][
        "registers"] == 136
    assert rows["paged_attention_merge_kernel<float, 128>"]["smem_bytes"] \
        == 0


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_generate_checks_hold_its_decode_calls_and_tokens(kv, monkeypatch):
    """``decode_capture`` records ``generate()``'s last-layer gang-decode
    calls, ``check_decode_calls`` holds each against the plain versions at
    the call's own split plan, and ``plain_attention_generate`` compares
    the tokens with a plain-attention ``generate()``. On the CPU both
    paths are the plain version, so the errors are 0 and every token
    agrees; a tiny Llama, prompts of 70 tokens."""
    import numpy as np
    import torch
    from paddle_tpu_torch import flags
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.ops.kernels import paged_attention as pa
    cs = _smoke()
    monkeypatch.setattr(pa, "sm_count", lambda device: 132)
    cfg = LlamaConfig(vocab_size=128, hidden_size=64, intermediate_size=160,
                      num_hidden_layers=2, num_attention_heads=4,
                      num_key_value_heads=2, max_position_embeddings=256,
                      dtype="bfloat16")
    model = LlamaForCausalLM(cfg, device="cpu",
                             generator=torch.Generator().manual_seed(0))
    ids = torch.from_numpy(np.random.RandomState(0).randint(0, 128, (4, 70)))
    flags.set_flags({"kv_cache_dtype": kv})
    try:
        with cs.decode_capture(torch, cfg.num_hidden_layers) as calls:
            out = model.generate(ids, max_new_tokens=cs.GEN_NEW_TOKENS,
                                 temperature=0.0, cache_type="paged",
                                 block_size=64)
    finally:
        flags.set_flags({"kv_cache_dtype": "auto"})
    assert pa.paged_attention.__name__ == "paged_attention"   # restored
    got = cs.check_decode_calls(torch, "generate", calls)
    steps = cs.GEN_NEW_TOKENS - 1
    assert (got["calls"], got["batch"], got["contexts"]) == (
        steps, 4, [71, 70 + steps])
    assert got["pool_dtype"] == ("int8" if kv == "int8" else "bfloat16")
    assert got["max_abs_err"] == 0.0
    assert cs.plain_attention_generate(torch, model, ids, out, kv) == dict(
        agreement=1.0, flips=[])
    # a token changed at row 1, position 75: one flip there, refused once
    # its margin is over the limit
    bad = out.clone()
    bad[1, 75] = (bad[1, 75] + 1) % cfg.vocab_size
    res = cs.plain_attention_generate(torch, model, ids, bad, kv)
    assert [(f["row"], f["position"]) for f in res["flips"]] == [(1, 75)]
    assert res["agreement"] == 1 - 1 / (4 * cs.GEN_NEW_TOKENS)
    monkeypatch.setattr(cs, "FLIP_MARGIN_MAX", 0.0)
    with pytest.raises(AssertionError, match="flips at logit margin"):
        cs.plain_attention_generate(torch, model, ids, bad, kv)


def test_ptxas_rows_name_the_ragged_kernels():
    """The ragged tensor-core tile pass gets a row with the shared memory
    its source sizes (two stages of bf16 K/V tiles; for int8 one K/V pair
    and two stages of codes and scales), and the split pass under the
    ragged row policy keeps its template arguments."""
    txt = "\n".join([
        "ptxas info    : Compiling entry function '_ZN40_GLOBAL__N__x_12_"
        "ragged_cu_y32ragged_paged_attention_tc_kernelI13__nv_bfloat16"
        "Li128EEEvNS_5TilesE' for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 219 registers, used 1 barriers",
        "ptxas info    : Compiling entry function '_ZN40_GLOBAL__N__x_12_"
        "ragged_cu_y32ragged_paged_attention_tc_kernelIaLi64EEEvNS_5TilesE'"
        " for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 167 registers, used 1 barriers",
        "ptxas info    : Compiling entry function '_ZN3ptt3dec28paged_"
        "attention_split_kernelIffLi128ELi8ENS0_10RaggedRowsEEEvNS0_6"
        "DecodeE' for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 254 registers, used 1 barriers"])
    rows = {r["kernel"]: r for r in _smoke().ptxas_tc_kernels(txt)}
    assert set(rows) == {"ragged_paged_attention_tc_kernel<bf16, 128>",
                         "ragged_paged_attention_tc_kernel<int8, 64>",
                         "paged_attention_split_kernel<float, float, 128, 8>"}
    assert rows["ragged_paged_attention_tc_kernel<bf16, 128>"][
        "smem_bytes"] == 2 * 2 * 64 * 128 * 2 + 1024
    assert rows["ragged_paged_attention_tc_kernel<int8, 64>"][
        "smem_bytes"] == 2 * 64 * 64 * 2 + 2 * (2 * 64 * 64 + 512) + 1024
    assert rows["ragged_paged_attention_tc_kernel<bf16, 128>"][
        "registers"] == 219


def test_ptxas_rows_name_the_f32_kernels():
    """Both float32 FMA kernels get rows: the grouped GEMM's (both w
    layouts) and the BCSR kernel's at each M tile, with the dynamic shared
    memory of gemm_f32.cuh's rings and the spills ptxas reports."""
    txt = "\n".join([
        "ptxas info    : Compiling entry function '_ZN48_GLOBAL__N__1a607d2d"
        "_15_grouped_gemm_cu_55035d3a23grouped_gemm_f32_kernelILb0EEEvNS_7"
        "ProblemE' for 'sm_90a'",
        "ptxas info    : Function properties for _ZN48_GLOBAL__N__1a607d2d_"
        "15_grouped_gemm_cu_55035d3a23grouped_gemm_f32_kernelILb0EEEvNS_7"
        "ProblemE",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 127 registers, used 1 barriers",
        "ptxas info    : Compiling entry function '_ZN45_GLOBAL__N__b146cf15"
        "_12_bcsr_spmm_cu_7a681df120bcsr_spmm_f32_kernelILi16EEEvNS_7Problem"
        "E' for 'sm_90a'",
        "    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads",
        "ptxas info    : Used 128 registers, used 1 barriers",
        "ptxas info    : Compiling entry function '_ZN45_GLOBAL__N__b146cf15"
        "_12_bcsr_spmm_cu_7a681df120bcsr_spmm_f32_kernelILi128EEEvNS_7Proble"
        "mE' for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 128 registers, used 1 barriers"])
    smoke = _smoke()
    rows = {r["kernel"]: r for r in smoke.ptxas_tc_kernels(txt)}
    assert set(rows) == {"grouped_gemm_f32_kernel<false>",
                         "bcsr_spmm_f32_kernel<16>",
                         "bcsr_spmm_f32_kernel<128>"}
    gmm = rows["grouped_gemm_f32_kernel<false>"]
    assert (gmm["registers"], gmm["spill_stores"]) == (127, 0)
    # the forward's 64-row tile: 3 slots of [16][68] A and [16][132] B
    assert gmm["smem_bytes"] == 3 * 16 * (68 + 132) * 4
    t16 = rows["bcsr_spmm_f32_kernel<16>"]
    assert (t16["spill_stores"], t16["spill_loads"]) == (4, 4)
    # two k groups, each 3 slots of [16][20] A and [16][68] B floats
    assert t16["smem_bytes"] == 2 * 3 * 16 * (20 + 68) * 4
    # dx's 128-row tile, as BCSR's: 3 slots of [16][132] A and B floats
    assert rows["bcsr_spmm_f32_kernel<128>"]["smem_bytes"] == \
        smoke.gemm_smem_bytes("grouped_gemm_f32_kernel", ["true"]) == \
        3 * 16 * (132 + 132) * 4


def test_ptxas_rows_name_the_f32_attention_kernels():
    """The six float32 attention kernels get rows, named by their source
    (both define fwd_kernel, dq_kernel and dkv_kernel), with the forward's
    query heads a block, the registers and spills ptxas reports and the
    dynamic shared memory of flash_f32.cuh's bodies."""
    def entry(src, n, kern, args):
        return ("ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__"
                f"4af27cb8_{len(src) + 3}_{src}_cu_c0b5d747{n}{kern}I{args}"
                "EEvPKfS2_S2_PfS3_NS_3LayES4_S4_S4_iiiifi' for 'sm_90a'")
    spill = "    {0} bytes stack frame, {0} bytes spill stores, {0} bytes " \
        "spill loads"
    txt = "\n".join([
        entry("flash_attention", 10, "fwd_kernel", "Li128ELi2E"),
        spill.format(0), "ptxas info    : Used 254 registers, used 1 barriers",
        entry("flash_attention", 9, "dq_kernel", "Li128E"),
        spill.format(0), "ptxas info    : Used 210 registers, used 1 barriers",
        entry("flash_varlen", 10, "dkv_kernel", "Li128E"),
        spill.format(0), "ptxas info    : Used 255 registers, used 1 barriers",
        entry("flash_varlen", 10, "fwd_kernel", "Li64ELi1E"),
        spill.format(8), "ptxas info    : Used 128 registers, used 1 "
        "barriers, 8 bytes cumulative stack size"])
    smoke = _smoke()
    rows = {r["kernel"]: r for r in smoke.ptxas_tc_kernels(txt)}
    assert set(rows) == {"flash_attention::fwd_kernel<128, 2>",
                         "flash_attention::dq_kernel<128>",
                         "flash_varlen::dkv_kernel<128>",
                         "flash_varlen::fwd_kernel<64, 1>"}
    fwd = rows["flash_attention::fwd_kernel<128, 2>"]
    assert (fwd["registers"], fwd["spill_stores"]) == (254, 0)
    # two Q tiles, a K and a V slot of [64][132] floats, W [64][132], and
    # 2 x 64 column words
    assert fwd["smem_bytes"] == 4 * 64 * 132 * 4 + 64 * 132 * 4 + 512
    assert rows["flash_attention::dq_kernel<128>"]["smem_bytes"] == \
        6 * 64 * 132 * 4 + 64 * 68 * 4 + 1024
    # K, V and three Q / dO slots, a W tile for P and one for dS
    assert rows["flash_varlen::dkv_kernel<128>"]["smem_bytes"] == \
        5 * 64 * 132 * 4 + 2 * 64 * 68 * 4 + 2048 == \
        smoke.f32_attn_smem_bytes("dkv", 128)
    small = rows["flash_varlen::fwd_kernel<64, 1>"]
    assert (small["spill_stores"], small["spill_loads"]) == (8, 8)
    assert small["smem_bytes"] == 3 * 64 * 68 * 4 + 64 * 68 * 4 + 512


def test_f32_attention_smem_bytes_follows_the_header():
    """``f32_attn_smem_bytes`` mirrors flash_f32.cuh's tile shape, padding
    and counts of tiles and column words (read from the header), for every
    kernel, head_dim and forward head count, each within a block's
    limit."""
    text = (CSRC / "flash_f32.cuh").read_text()
    const = {n: int(re.search(rf"constexpr int {n} = (\d+);", text).group(1))
             for n in ("kM", "kN", "kPad", "kMaxSmem")}
    words = int(re.search(r"constexpr int kColWords = (\d+);",
                          (CSRC / "flash_wgmma.cuh").read_text()).group(1))
    assert "w * kN * w_pitch<NA>()" in text
    assert "smem_bytes<D, HB>(HB + 2, 1, 2)" in text
    assert "smem_bytes<D>(6, 1, 4)" in text and \
        "smem_bytes<D>(5, 2, 8)" in text
    smoke = _smoke()
    for d in (64, 128):
        tile = const["kM"] * (d + const["kPad"]) * 4
        for hb in (1, 2):
            w = const["kN"] * (const["kN"] * hb + const["kPad"]) * 4
            assert smoke.f32_attn_smem_bytes("fwd", d, hb) == \
                (hb + 2) * tile + w + 2 * words * 4 <= const["kMaxSmem"]
        w = const["kN"] * (const["kN"] + const["kPad"]) * 4
        assert smoke.f32_attn_smem_bytes("dq", d) == \
            6 * tile + w + 4 * words * 4 <= const["kMaxSmem"]
        assert smoke.f32_attn_smem_bytes("dkv", d) == \
            5 * tile + 2 * w + 8 * words * 4 <= const["kMaxSmem"]


def test_f32_smem_bytes_follows_the_header():
    """``f32_smem_bytes`` mirrors gemm_f32.cuh's k depth, ring slots and
    tile shapes (read from the header), at every M tile."""
    text = (CSRC / "gemm_f32.cuh").read_text()
    bk = int(re.search(r"constexpr int kBK = (\d+);", text).group(1))
    stages = int(re.search(r"constexpr int kStages = (\d+);",
                           text).group(1))
    assert "KG = TM == 16 ? 2 : 1" in text and \
        "NJ = TM >= 32 ? 2 : 1" in text
    smoke = _smoke()
    for tm in (16, 32, 64, 128):
        tn, kg = (64, 2) if tm == 16 else (128, 1)
        assert smoke.f32_smem_bytes(tm) == \
            kg * stages * bk * (tm + 4 + tn + 4) * 4
        assert smoke.gemm_smem_bytes("bcsr_spmm_f32_kernel", [str(tm)]) == \
            smoke.f32_smem_bytes(tm)


@pytest.mark.parametrize("dname,bm,tm", [
    ("float32", 16, 16), ("float32", 17, 32), ("float32", 32, 32),
    ("float32", 48, 64), ("float32", 96, 128), ("float32", 128, 128),
    ("float32", 144, 128), ("bfloat16", 16, 64), ("bfloat16", 128, 128),
    ("bfloat16", 144, 128)])
def test_bcsr_tile_rows_names_the_kernel_each_block_takes(dname, bm, tm):
    """``phase_routes`` asks the profile for the BCSR kernel at the M tile
    the C entry picks for ``bm`` (ptt_bcsr_spmm)."""
    assert _smoke().bcsr_tile_rows(dname, bm) == tm


def _lr_run(monkeypatch=None, steps=6):
    """The lr each bucket's fused launch read, per optimizer step, and
    the scheduler's value, from a CPU AdamW under the smoke's schedule;
    with ``monkeypatch``, the lr scalar is never refreshed."""
    import torch

    from paddle_tpu_torch import optimizer as TO
    from paddle_tpu_torch.optimizer import lr

    smoke = _smoke()
    if monkeypatch is not None:
        monkeypatch.setattr(TO.Optimizer, "_refresh",
                            staticmethod(lambda t, value: None))
    params = [torch.nn.Parameter(torch.ones(4, 3)),
              torch.nn.Parameter(torch.ones(3))]
    opt = TO.AdamW(learning_rate=smoke.amp_schedule(lr),
                   parameters=[(f"layer.{'norm' if p.ndim == 1 else 'w'}",
                                p) for p in params],
                   apply_decay_param_fun=smoke.no_norm_decay)
    seen, want = [], []
    for _ in range(steps):
        for p in params:
            p.grad = torch.full_like(p, 0.5)
        want.append(opt.get_lr())
        opt.step()
        opt.clear_grad()
        plan = next(iter(opt._fused_plans.values()))
        seen.append([float(b.svec[0]) for b in plan.buckets])
        opt._lr.step()
    assert [b.wd for b in plan.buckets] == [0.01, 0.0]
    return smoke, seen, want


def test_lr_check_passes_the_scheduled_reads():
    smoke, seen, want = _lr_run()
    assert smoke.lr_mismatches(seen, want) == []
    assert len(set(want)) == len(want)        # a new lr every step


def test_lr_check_catches_a_stale_lr_scalar(monkeypatch):
    smoke, seen, want = _lr_run(monkeypatch)
    bad = smoke.lr_mismatches(seen, want)
    assert [b[0] for b in bad] == list(range(1, len(want)))
    assert smoke.lr_mismatches(seen[:-1], want)[-1][0] == "steps"
    assert smoke.lr_mismatches([[0.0, 1.0]], [0.0]) == [(0, [0.0, 1.0],
                                                          0.0)]


def _calls(steps, buckets, layers, accum=2):
    flash = {k: layers for k in ("flash_attention_fwd", "flash_attention_dq",
                                 "flash_attention_dkv")}
    out = []
    for i in range(steps * accum):
        c = dict(flash)
        if (i + 1) % accum == 0:
            c["fused_optimizer"] = buckets
        out.append(c)
    return out


def test_launch_pattern_passes_one_update_per_window():
    smoke = _smoke()
    assert smoke.launch_pattern_errors(_calls(3, 2, 8), 2, 2, 8) == []


@pytest.mark.parametrize("fault", ["micro_update", "missing_update",
                                   "extra_bucket", "flash_short"])
def test_launch_pattern_flags_other_counts(fault):
    smoke = _smoke()
    calls = _calls(3, 2, 8)
    if fault == "micro_update":
        calls[2]["fused_optimizer"] = 2
    elif fault == "missing_update":
        del calls[3]["fused_optimizer"]
    elif fault == "extra_bucket":
        calls[5]["fused_optimizer"] = 3
    else:
        calls[4]["flash_attention_dq"] = 7
    errs = smoke.launch_pattern_errors(calls, 2, 2, 8)
    assert len(errs) == 1



# profiler windows as ``profile_call`` returns them: every stem recorded,
# one of them lost, and no device time at all
_ROUTE = ("split_kernel", "tc_kernel", "merge_kernel")
_WINDOWS = {
    "whole": {"all_kernels": {"void split_kernel<128>()": 0.3,
                              "void tc_kernel<128>()": 0.6,
                              "void merge_kernel<128>()": 0.09}},
    "lossy": {"all_kernels": {"void merge_kernel<128>()": 0.09}},
    "empty": {"not_measured": "profiler recorded no device time"},
}


def _route(monkeypatch, windows):
    smoke = _smoke()
    seen = iter(windows)
    monkeypatch.setattr(smoke, "profile_call",
                        lambda torch, fn, n: dict(_WINDOWS[next(seen)]))
    return smoke.profiled_kernels(None, lambda: None, _ROUTE)


@pytest.mark.parametrize("windows,lossy", [
    (["whole"], 0), (["lossy", "whole"], 1), (["empty", "lossy", "whole"], 1),
    (["lossy"] * 4 + ["whole"], 4)])
def test_route_is_read_from_the_first_whole_window(monkeypatch, windows,
                                                   lossy):
    r = _route(monkeypatch, windows)
    assert len(r["kernels"]) == 3
    assert r["ms_per_call"]["void tc_kernel<128>()"] == pytest.approx(0.2)
    assert len(r.get("lossy_windows", [])) == lossy
    for w in r.get("lossy_windows", []):
        assert w["missing"] == ["split_kernel", "tc_kernel"]


@pytest.mark.parametrize("windows", [["lossy"] * 5,
                                     ["empty"] * 4 + ["lossy"]])
def test_route_that_no_window_shows_whole_fails(monkeypatch, windows):
    with pytest.raises(AssertionError, match="never ran all of"):
        _route(monkeypatch, windows)


def test_route_with_no_device_time_is_not_measured(monkeypatch):
    r = _route(monkeypatch, ["empty"] * 5)
    assert r == {"not_measured": "profiler recorded no device time"}


# -- the step-capture checks ------------------------------------------------------

def _serve_metrics(steps, captures, replays, eager_steps=0, fallbacks=0):
    m = {k: 1.0 for k in ("tokens_per_s", "step_ms_p50", "step_ms_p99",
                          "ttft_ms_p50", "ttft_ms_p99", "tpot_ms_p50",
                          "tpot_ms_p99", "peak_mem_gib")}
    m.update(steps=steps, capture=dict(captures=captures, replays=replays,
                                       eager_steps=eager_steps,
                                       fallbacks=fallbacks, capture_s=0.1,
                                       pool_bytes=1 << 20))
    return m


def test_capture_check_holds_tokens_and_counts():
    smoke = _smoke()
    outs = {0: [1, 2, 3], 1: [4, 5, 6]}
    eager = _serve_metrics(10, 0, 0, eager_steps=10)
    res = smoke.check_capture("s", _serve_metrics(10, 1, 9), outs, eager,
                              dict(outs))
    assert res["token_identical"] and res["replays"] == 9
    for bad_m, bad_outs in (
            (_serve_metrics(10, 1, 9), {0: [1, 2, 3], 1: [4, 5, 7]}),
            (_serve_metrics(10, 1, 8), outs),
            (_serve_metrics(10, 2, 8), outs),
            (_serve_metrics(10, 1, 9, fallbacks=1), outs)):
        with pytest.raises(AssertionError):
            smoke.check_capture("s", bad_m, bad_outs, eager, outs)
    with pytest.raises(AssertionError, match="eager run captured"):
        smoke.check_capture("s", _serve_metrics(10, 1, 9), outs,
                            _serve_metrics(10, 1, 9), outs)


def test_moe_spread_band():
    smoke = _smoke()
    n = smoke.MOE_EAGER_STEPS
    a = [10.0 - k for k in range(n)]
    b = [x + 1e-3 for x in a]
    eager = [dict(losses=a, tokens_per_s=1.0, step_ms_p50=1.0,
                  step_ms_p99=1.0, peak_mem_gib=1.0),
             dict(losses=b)]
    inside = [x + 1.5e-3 for x in a]
    graphs = [dict(capture_s=0.1, pool_bytes=1)]
    assert max(smoke.moe_spread(inside, eager, graphs)["outside_band"]) == 0
    with pytest.raises(AssertionError, match="outside the eager spread"):
        smoke.moe_spread([x + 5e-3 for x in a], eager, graphs)
    with pytest.raises(AssertionError):
        smoke.moe_spread(inside, eager, graphs * 2)


def test_bits_fingerprint_sees_one_ulp():
    import torch
    smoke = _smoke()
    for dt in (torch.float32, torch.bfloat16, torch.int8):
        t = torch.arange(1000).to(dt)
        u = t.clone()
        u.view(-1).view({1: torch.int8, 2: torch.int16,
                         4: torch.int32}[u.element_size()])[517] += 1
        assert smoke.bits_fingerprint(torch, [t]) == \
            smoke.bits_fingerprint(torch, [t.clone()])
        assert smoke.bits_fingerprint(torch, [t], chunk=64) != \
            smoke.bits_fingerprint(torch, [u], chunk=64)


def test_lr_check_passes_under_capture_replays():
    """The same AdamW under the schedule, stepped through a captured step:
    on the stand-in's replays each bucket's vector holds the lr that step
    read (one persistent vector a bucket)."""
    import torch

    from paddle_tpu_torch import optimizer as TO
    from paddle_tpu_torch.jit import jit_step
    from paddle_tpu_torch.optimizer import lr

    smoke = _smoke()
    w = torch.nn.Parameter(torch.ones(4, 3))
    opt = TO.AdamW(learning_rate=smoke.amp_schedule(lr), parameters=[w])

    def step(x):
        loss = (w * x).sum()
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss.detach()

    cap = jit_step(step)
    seen, want, vecs = [], [], set()
    for _ in range(6):
        want.append(opt.get_lr())
        cap(torch.full((4, 3), 0.5))
        plan = next(iter(opt._fused_plans.values()))
        seen.append([float(b.svec[0]) for b in plan.buckets])
        vecs.add(id(plan.buckets[0].svec))
        opt._lr.step()
    assert smoke.lr_mismatches(seen, want) == [] and len(vecs) == 1
