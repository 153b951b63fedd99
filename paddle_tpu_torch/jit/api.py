"""The training step.

Counterpart of ``paddle_tpu/jit/api.py:226-480`` ``TrainStep(model,
loss_fn, optimizer, grad_accum=1, amp_level=None)``: ``train(inputs,
labels)`` runs the forward and the loss (under ``amp.auto_cast(level=
amp_level)`` when a level is given) and the backward. With ``grad_accum``
n > 1, the first n - 1 calls of each window stop there (micro steps: the
grads add up in ``.grad``, in the parameter's dtype, as the reference's
accumulation buffers do); the n-th applies the mean of the n grads, then
the optimizer's clip, then its update, and clears the grads, the
reference's order (:357-359). Each call returns that call's float32
loss.

The mean: on the fused route the grads stay summed and the optimizer's
kernel multiplies them by ``1/n`` in registers (handed over as the scale
the grads carry, as the GradScaler's deferred unscale is), so no pass
rewrites them; on the per-parameter route they are divided in place
(``g / n`` in the grad's dtype, the reference's divide). The reference
divides on both; the kernel's multiply by ``1/n`` rounds ``1/n`` to the
grad's dtype first, exact for n a power of two.

The step is captured: the reference compiles it into one XLA program
(:226), and here it is CUDA graphs (``jit/step_capture.py``) under
``FLAGS_step_capture`` (default on, as the reference always compiles;
off, the same steps run eagerly). The first call of each shape probes
eagerly, the second warms up and captures, every later one replays.
With ``grad_accum`` 1 the whole step is one graph that allocates the
grads in its own pool, as the eager step does, so capture costs no
memory the eager step does not hold. With ``grad_accum`` > 1 the graph
is split at the update: every call replays the forward and backward
(the grads add up in storage made before the capture), and the window's
last call then replays a second, small graph with the mean, the clip,
the update and the clear. Only the first graph holds a step's
activations (two graphs each holding them did not fit O1 at 8 layers on
an 80 GB card). A step the capture cannot express RAISES, naming the
reason: the reference's compile would fail too, and ``TrainStep`` has no
eager fallback. Each call returns a
clone of the graph's loss. On the CPU the capture's stand-in runs (the
body re-run as the replay). The step goes through ``optimizer.step()``,
which takes the fused kernel; the learning rate is read once per
optimizer step (``optimizer.get_lr()``, refreshed before each replay);
advancing the scheduler is the caller's, as in the reference.
"""

from __future__ import annotations

import contextlib
import weakref
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from .. import flags
from ..core.tensor import paddle_call
from .step_capture import CapturedStep


def _weak(method):
    """``method`` called through a weak reference to its object: the
    captured steps a TrainStep holds must not hold it back, or a deleted
    TrainStep would keep its graphs' memory until a garbage collection."""
    ref = weakref.WeakMethod(method)

    def call(*args, **kwargs):
        return ref()(*args, **kwargs)
    return call


class TrainStep:
    def __init__(self, model: torch.nn.Module, loss_fn: Callable, optimizer,
                 grad_accum: int = 1, amp_level: Optional[str] = None):
        if int(grad_accum) < 1:
            raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
        self.model = model
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.grad_accum = int(grad_accum)
        self.amp_level = amp_level
        self._micro = 0      # micro steps taken in the current window
        self._accum_scale: Optional[torch.Tensor] = None
        self._steps: Optional[Tuple[CapturedStep, ...]] = None

    def _amp_ctx(self):
        if self.amp_level:
            from .. import amp
            return amp.auto_cast(level=self.amp_level)
        return contextlib.nullcontext()

    def _forward_backward(self, inputs, labels) -> torch.Tensor:
        with self._amp_ctx():
            out = self.model(*inputs)
            outs = tuple(out) if isinstance(out, (list, tuple)) else (out,)
            loss = self.loss_fn(*outs, *labels)
        loss.backward()
        return loss.detach().float()

    def _whole_step(self, inputs, labels) -> torch.Tensor:
        loss = self._forward_backward(inputs, labels)
        self.optimizer.step()
        self.optimizer.clear_grad()
        return loss

    def _apply_step(self) -> None:
        self._mean_grads()
        self.optimizer.step()
        self.optimizer.clear_grad()

    def _generators(self) -> List[torch.Generator]:
        """The generators the model's layers draw from (a ``Dropout``'s
        own), registered with each graph."""
        from ..distributed.recompute import module_generators
        return module_generators(self.model)

    def graphs(self) -> List:
        """Each captured graph's capture seconds and pool bytes."""
        return [e for s in self._steps or () for e in s.graphs()]

    def __call__(self, inputs: Sequence, labels: Sequence) -> torch.Tensor:
        """One step on ``(inputs, labels)``; its loss. Paddle
        ``Tensor``s in give a ``Tensor`` out."""
        return paddle_call(self._call, (inputs, labels), {})

    def _call(self, inputs: Sequence, labels: Sequence) -> torch.Tensor:
        inputs = tuple(inputs) if isinstance(inputs, (list, tuple)) \
            else (inputs,)
        labels = tuple(labels) if isinstance(labels, (list, tuple)) \
            else (labels,)
        capture = flags.get_flag("step_capture")
        if self.grad_accum == 1:
            if not capture:
                return self._whole_step(inputs, labels)
            if self._steps is None:
                self._steps = (CapturedStep(_weak(self._whole_step),
                                            strict=True,
                                            generators=self._generators()),)
            return self._steps[0](inputs, labels)
        if self._steps is None:
            params = list(getattr(self.optimizer, "_parameter_list", ()))
            self._steps = (CapturedStep(_weak(self._forward_backward),
                                        strict=True, params=params,
                                        generators=self._generators()),
                           CapturedStep(_weak(self._apply_step),
                                        strict=True))
        micro, apply = self._steps if capture else (
            self._forward_backward, self._apply_step)
        loss = micro(inputs, labels)
        self._micro += 1
        if self._micro == self.grad_accum:
            self._micro = 0
            apply()
        return loss

    @torch.no_grad()
    def _mean_grads(self) -> None:
        """The window's summed grads to their mean: folded into the fused
        kernel's unscale where the step takes that route, else divided in
        place."""
        opt, n = self.optimizer, self.grad_accum
        if opt._pending_scale is None and opt._fused_defer_scale():
            dev = next(p.grad.device for p in opt._parameter_list
                       if p.grad is not None)
            if self._accum_scale is None or self._accum_scale.device != dev:
                self._accum_scale = torch.full((), float(n),
                                               dtype=torch.float32,
                                               device=dev)
            opt._pending_scale = self._accum_scale
            return
        for p in opt._parameter_list:
            if p.grad is not None:
                p.grad.div_(n)
