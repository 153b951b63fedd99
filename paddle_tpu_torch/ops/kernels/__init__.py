"""The port's kernels: hand-written CUDA kernels with their plain PyTorch
versions (``ragged_paged_attention``, ``paged_attention``,
``flash_attention``, ``flash_varlen``, ``fused_optimizer``, ``grouped_gemm``,
``weight_only_gemm``, ``bcsr_spmm``), and the plain tensor ops around them
(``nn``, ``serving``, ``quant_common``, ``moe``, ``quant``)."""

from . import bcsr_spmm, flash_attention, flash_varlen, fused_optimizer, \
    grouped_gemm, paged_attention, ragged_paged_attention, weight_only_gemm

# every kernel's launch counter, for code that reads or resets all counts
KERNELS = {c.name: c for c in (
    ragged_paged_attention.launches, paged_attention.launches,
    flash_attention.launches_fwd, flash_attention.launches_dq,
    flash_attention.launches_dkv, flash_varlen.launches_fwd,
    flash_varlen.launches_dq, flash_varlen.launches_dkv,
    fused_optimizer.launches, fused_optimizer.launches_lamb_moments,
    fused_optimizer.launches_lamb_apply,
    grouped_gemm.launches, weight_only_gemm.launches, bcsr_spmm.launches)}


def reset_launch_counts() -> None:
    for counter in KERNELS.values():
        counter.reset()


def launch_counts() -> dict:
    return {name: counter.count for name, counter in KERNELS.items()}
