"""paddle_tpu_torch: the PyTorch + CUDA port of paddle_tpu, for NVIDIA
Hopper (H100).

``import paddle_tpu_torch as paddle`` gives Paddle's surface: the
``Tensor`` (a ``torch.Tensor`` subclass with Paddle's methods, the inplace
family and the dunders), ``to_tensor``, the dtypes, the Places, the
autograd API (``grad``, ``no_grad``, ``set_grad_enabled``, ``autograd``
with ``jacobian`` / ``hessian`` / ``jvp`` / ``vjp`` / ``vhp``), ``seed``
and the rng-state functions, and every op of the registry at the top level
(creation, math, manipulation, search, the random ops, ...). These return
``Tensor``s; ``ops.dispatcher.call_op(name, ...)`` reaches the same ops
and returns plain tensors for plain inputs.

It serves Llama through the ragged continuous-batching engine
(``models.ContinuousBatchingEngine``), the gang-scheduled engine
(``models.GangScheduledEngine``) and ``generate()`` over the contiguous
``models.KVCache`` or the paged pool, also with int4 weight-only linears
(``nn.quant.quantize_for_inference``), and reports through
``observability`` (the metrics registry, spans, the flight recorder and
the /metrics endpoint);
trains Llama and the DeepSeekMoE family (``models.LlamaForCausalLM``,
``models.MoEForCausalLM``) through ``jit.TrainStep`` or Paddle's eager
loop with the fused AdamW optimizer (selective or full recompute, list or
stacked layers, a worker-process ``io.DataLoader`` under
``hapi.Model.fit``); trains BERT and the PP-OCR models; builds networks
the Paddle way from ``nn.Layer`` and the common layers, initializers and
losses; trains the vision zoo (``vision.models``: ResNet, YOLOv3-DarkNet53
and the rest) over ``vision.datasets`` and ``vision.transforms`` with
``metric.Accuracy``; and has the reference's ``linalg``, ``fft``,
``signal``, ``audio`` (the feature layers, the wave backend, ESC-50 and
TESS), ``text`` (CRF Viterbi decoding, the text datasets) and
``geometric`` (message passing, neighbour sampling) namespaces, the fft
and signal functions in their namespaces only; ``quantization`` trains a
model with fake-quantized weights and activations (QAT) or calibrates and
converts it to int8 weights (PTQ); ``Model``, ``summary``, ``callbacks``,
``flops`` and ``device`` are the reference's top-level names. The TPU kernels of those paths are CUDA C++ kernels for Hopper
(``csrc/``), built at first use. Entry points run on the CUDA card unless
the caller passes ``device=`` / ``set_device("cpu")`` or CPU tensors; they
never fall back to the CPU quietly. The models, criteria, layers,
``TrainStep`` and ``jit_step`` take ``Tensor``s or plain tensors and
return what they were given.

The package imports torch, never jax, and nothing of paddle_tpu.
"""

import numpy as _np

from . import flags
from .core.device import (CPUPlace, CUDAPinnedPlace, CUDAPlace, Event,
                          Place, Stream, device_count, empty_cache,
                          get_device, is_compiled_with_cuda,
                          max_memory_allocated, max_memory_reserved,
                          memory_allocated, memory_reserved, resolve_device,
                          set_device, synchronize)
from .core.dtype import (bfloat16, bool_, complex64, complex128, finfo,
                         float16, float32, float64, get_default_dtype, iinfo,
                         int8, int16, int32, int64, set_default_dtype,
                         uint8)
from .core.generator import (default_generator, get_cuda_rng_state,
                             get_rng_state, seed, set_cuda_rng_state,
                             set_rng_state)
from .core.tensor import Tensor, is_tensor, to_tensor
from .flags import get_flags, set_flags
from .ops import dispatcher as _dispatcher

globals().update(_dispatcher.build_surface())

from . import autograd  # noqa: E402
from .autograd import (enable_grad, grad, is_grad_enabled,  # noqa: E402
                       no_grad, set_grad_enabled)
from .tensor_api import *  # noqa: E402,F401,F403
from .tensor_api import __all__ as _TENSOR_API  # noqa: E402
from .tensor_api import _attach_tensor_methods  # noqa: E402

_attach_tensor_methods()

from . import (amp, distributed, hapi, io, jit, metric,  # noqa: E402
               models, nn, observability, optimizer, sparse, vision)
from . import fft, geometric, linalg, signal, text  # noqa: E402
from . import audio, framework, quantization  # noqa: E402
from .core import device  # noqa: E402,F401  (paddle.device)
from .framework import load, save  # noqa: E402
from .hapi import Model, callbacks, flops, summary  # noqa: E402
from .jit import jit_step  # noqa: E402
from .nn import LazyGuard, ParamAttr  # noqa: E402
from .nn.layer_base import Parameter  # noqa: E402

bool = bool_  # noqa: A001  (paddle.bool)
dtype = _np.dtype
shape = shape_op  # noqa: F821  (the reference's top-level name)


def einsum(equation, *operands):
    """``paddle.einsum``."""
    return _dispatcher.public_op("einsum_impl")(list(operands),
                                               equation=equation)


def normal(mean=0.0, std=1.0, shape=None):
    """Draws of normal(mean, std) of ``shape`` (``paddle.normal``)."""
    return _dispatcher.public_op("gaussian")(
        shape=[] if shape is None else shape, mean=float(mean),
        std=float(std))


__all__ = ["flags", "get_device", "resolve_device", "seed", "set_device",
           "Tensor", "to_tensor", "is_tensor", "einsum", "normal", "grad",
           "no_grad", "enable_grad", "is_grad_enabled", "set_grad_enabled",
           "autograd", "CPUPlace", "CUDAPlace", "CUDAPinnedPlace", "Place",
           "iinfo", "finfo", "get_rng_state", "set_rng_state",
           "observability",
           "get_cuda_rng_state", "set_cuda_rng_state", "default_generator",
           "fft", "signal", "linalg", "audio", "text", "geometric",
           "framework", "save", "load", "device", "quantization", "Model",
           "summary", "callbacks", "flops",
           *(n for n in _dispatcher.SCHEMA
             if n not in _dispatcher.NAMESPACED),
           *_dispatcher.INPLACE, *_TENSOR_API]
__version__ = "0.1.0"
