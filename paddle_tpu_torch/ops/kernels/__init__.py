"""The port's kernels: hand-written CUDA kernels with their plain PyTorch
versions (``ragged_paged_attention``, ``paged_attention``), and the plain
tensor ops of the serving path (``nn``, ``serving``, ``quant_common``)."""

from . import paged_attention, ragged_paged_attention

# every kernel of the port, for code that reads or resets all the counts
KERNEL_MODULES = {"ragged_paged_attention": ragged_paged_attention,
                  "paged_attention": paged_attention}


def reset_launch_counts() -> None:
    for mod in KERNEL_MODULES.values():
        mod.launches.reset()


def launch_counts() -> dict:
    return {name: mod.launches.count for name, mod in KERNEL_MODULES.items()}
