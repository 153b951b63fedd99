"""paddle_tpu_torch: the PyTorch + CUDA port of paddle_tpu, for NVIDIA
Hopper (H100).

This slice serves Llama through the ragged continuous-batching engine:
``models.LlamaForCausalLM``, ``models.ContinuousBatchingEngine`` and
``generate(cache_type="paged")``, with the two paged-attention kernels
written in CUDA C++ (``csrc/``). Entry points run on the CUDA card unless
the caller passes ``device=``; they never fall back to the CPU quietly.

The package imports torch, never jax, and nothing of paddle_tpu.
"""

from . import flags
from .core.device import resolve_device

__all__ = ["flags", "resolve_device"]
__version__ = "0.1.0"
