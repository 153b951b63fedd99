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

It runs eagerly: the reference compiles the whole step into one XLA
program, and capturing the step as a CUDA graph is ROADMAP A3. The
reference's compiled step applies each parameter's ``_update``; this one
goes through ``optimizer.step()``, which takes the fused kernel. The two
agree because the fused rule is the per-parameter rule (the tests hold
both routes to each other and to the reference). The learning rate is
read once per optimizer step (``optimizer.get_lr()``, a scheduler's
current value); advancing the scheduler is the caller's, as in the
reference.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional, Sequence

import torch


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

    def _amp_ctx(self):
        if self.amp_level:
            from .. import amp
            return amp.auto_cast(level=self.amp_level)
        return contextlib.nullcontext()

    def __call__(self, inputs: Sequence, labels: Sequence) -> torch.Tensor:
        inputs = tuple(inputs) if isinstance(inputs, (list, tuple)) \
            else (inputs,)
        labels = tuple(labels) if isinstance(labels, (list, tuple)) \
            else (labels,)
        with self._amp_ctx():
            out = self.model(*inputs)
            outs = tuple(out) if isinstance(out, (list, tuple)) else (out,)
            loss = self.loss_fn(*outs, *labels)
        loss.backward()
        self._micro += 1
        if self._micro < self.grad_accum:
            return loss.detach().float()
        self._micro = 0
        if self.grad_accum > 1:
            self._mean_grads()
        self.optimizer.step()
        self.optimizer.clear_grad()
        return loss.detach().float()

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
