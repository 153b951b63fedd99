"""The Paddle autograd API on ``torch.autograd``.

Counterpart of ``paddle_tpu/autograd/engine.py``'s API: the grad modes
(:48-67), ``backward`` (:640) and ``grad`` (:784); hooks are
``Tensor.register_hook`` (``core/tensor.py``). The reference's tape, its
fused-backward planner and its GradNode records have no counterpart:
torch's engine takes their place. Grad mode is thread-local, as torch's
is. ``set_grad_enabled`` applies its mode at once, so it works both as a
plain call and as a context.
"""

from __future__ import annotations

import torch

from ..core.tensor import _Call, wrap
from . import functional  # noqa: F401
from .functional import hessian, jacobian, jvp, vhp, vjp  # noqa: F401

no_grad = torch.no_grad
enable_grad = torch.enable_grad
is_grad_enabled = torch.is_grad_enabled
set_grad_enabled = torch.set_grad_enabled
_NoSubclassTF = torch._C.DisableTorchFunctionSubclass


def _seq(v):
    return [v] if isinstance(v, torch.Tensor) else list(v)


def backward(tensors, grad_tensors=None, retain_graph: bool = False,
             create_graph: bool = False) -> None:
    """Accumulate the gradients of ``tensors`` into the leaves' ``.grad``
    (``grad_tensors`` None or a None entry: ones for a scalar); with
    ``create_graph`` the grads are differentiable again."""
    c = _Call()
    tensors = [c.unwrap(t) for t in _seq(tensors)]
    if grad_tensors is not None:
        grad_tensors = [None if g is None else c.unwrap(g)
                        for g in _seq(grad_tensors)]
    torch.autograd.backward(tensors, grad_tensors, retain_graph=retain_graph,
                            create_graph=create_graph)


def grad(outputs, inputs, grad_outputs=None, retain_graph=None,
         create_graph: bool = False, only_inputs: bool = True,
         allow_unused: bool = False, no_grad_vars=None):
    """The gradients of ``outputs`` with respect to ``inputs`` (a list,
    one per input), leaving every ``.grad`` as it was. With
    ``create_graph`` the results are differentiable again. An input the
    outputs do not reach raises unless ``allow_unused`` (then None)."""
    if no_grad_vars:
        raise NotImplementedError(
            "grad(no_grad_vars=...) is not supported: stop the gradient on "
            "those tensors before the forward instead")
    c = _Call()
    outs = [c.unwrap(t) for t in _seq(outputs)]
    ins = _seq(inputs)
    if grad_outputs is not None:
        grad_outputs = [None if g is None else c.unwrap(g)
                        for g in _seq(grad_outputs)]
    # the inputs go in as they are: an alias made now would not be in the
    # graph that made the outputs
    with _NoSubclassTF():
        res = torch.autograd.grad(outs, ins, grad_outputs,
                                  retain_graph=retain_graph,
                                  create_graph=create_graph,
                                  allow_unused=True)
    for i, g in enumerate(res):
        if g is None and not allow_unused:
            raise ValueError(
                f"The {i}th input tensor is not used in the graph of the "
                f"given outputs (set allow_unused=True to return None for "
                f"it)")
    return [None if g is None else wrap(g) for g in res]


__all__ = ["backward", "grad", "no_grad", "enable_grad", "is_grad_enabled",
           "set_grad_enabled", "jacobian", "hessian", "jvp", "vjp", "vhp",
           "functional"]
