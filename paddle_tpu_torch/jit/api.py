"""The training step.

Counterpart of ``paddle_tpu/jit/api.py:226`` ``TrainStep(model, loss_fn,
optimizer)``: ``train(inputs, labels)`` runs the forward, the loss, the
backward, the optimizer step (which applies the optimizer's grad clip)
and ``clear_grad``, and returns the float32 loss.

It runs eagerly: the reference compiles the whole step into one XLA
program, and capturing the step as a CUDA graph is ROADMAP A6. The
reference's compiled step applies each parameter's ``_update``; this one
goes through ``optimizer.step()``, which takes the fused kernel. The two
agree because the fused rule is the per-parameter rule (the tests hold
both routes to each other and to the reference).
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch


class TrainStep:
    def __init__(self, model: torch.nn.Module, loss_fn: Callable, optimizer):
        self.model = model
        self.loss_fn = loss_fn
        self.optimizer = optimizer

    def __call__(self, inputs: Sequence, labels: Sequence) -> torch.Tensor:
        inputs = tuple(inputs) if isinstance(inputs, (list, tuple)) \
            else (inputs,)
        labels = tuple(labels) if isinstance(labels, (list, tuple)) \
            else (labels,)
        out = self.model(*inputs)
        outs = tuple(out) if isinstance(out, (list, tuple)) else (out,)
        loss = self.loss_fn(*outs, *labels)
        loss.backward()
        self.optimizer.step()
        self.optimizer.clear_grad()
        return loss.detach().float()
