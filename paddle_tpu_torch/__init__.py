"""paddle_tpu_torch: the PyTorch + CUDA port of paddle_tpu, for NVIDIA
Hopper (H100).

It serves Llama through the ragged continuous-batching engine
(``models.ContinuousBatchingEngine``) and ``generate(cache_type="paged")``,
also with int4 weight-only linears (``nn.quant.quantize_for_inference``);
trains Llama and the DeepSeekMoE family (``models.LlamaForCausalLM``,
``models.MoEForCausalLM``) through ``jit.TrainStep`` with the fused AdamW
optimizer (selective or full recompute, list or stacked layers, a
worker-process ``io.DataLoader`` under ``hapi.Model.fit``); builds
networks the Paddle way from ``nn.Layer`` and the common layers,
initializers and losses; and exports the op registry's ops at the top level
(``flash_attn_unpadded``, ``flash_attention``, ``grouped_gemm``, ...;
``ops.dispatcher.call_op(name, ...)`` reaches the same). The TPU kernels of
those paths are CUDA C++ kernels for Hopper (``csrc/``), built at first
use. Entry points run on the CUDA card unless the caller passes
``device=`` or CPU tensors; they never fall back to the CPU quietly.

The package imports torch, never jax, and nothing of paddle_tpu.
"""

from . import flags
from .core.device import get_device, resolve_device, set_device
from .nn.initializer import seed
from .ops import dispatcher as _dispatcher

globals().update(_dispatcher.build_ops())

__all__ = ["flags", "get_device", "resolve_device", "seed", "set_device",
           *_dispatcher.SCHEMA]
__version__ = "0.1.0"
