"""The port's kernels: hand-written CUDA kernels with their plain PyTorch
versions (``ragged_paged_attention``, ``paged_attention``,
``flash_attention``, ``fused_optimizer``), and the plain tensor ops around
them (``nn``, ``serving``, ``quant_common``)."""

from . import flash_attention, fused_optimizer, paged_attention, \
    ragged_paged_attention

# every kernel's launch counter, for code that reads or resets all counts
KERNELS = {c.name: c for c in (
    ragged_paged_attention.launches, paged_attention.launches,
    flash_attention.launches_fwd, flash_attention.launches_dq,
    flash_attention.launches_dkv, fused_optimizer.launches)}


def reset_launch_counts() -> None:
    for counter in KERNELS.values():
        counter.reset()


def launch_counts() -> dict:
    return {name: counter.count for name, counter in KERNELS.items()}
