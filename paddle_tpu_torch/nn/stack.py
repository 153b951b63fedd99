"""LayerStack: N structurally identical blocks stored as stacked parameters.

Counterpart of ``paddle_tpu/nn/stack.py:71-176``: each parameter of the
block is ONE ``[num_layers, *block_shape]`` parameter, named
``stacked_{j}`` in the template's ``parameters()`` order, the layout the
reference's pipeline parallelism shards and its stacked checkpoints use
(``llama.layer_stack.stacked_{j}``); under the port's pipeline a stage
holds its rows and runs each chunk's with :meth:`LayerStack.run`. Where
the reference runs the block under ``lax.scan``, the port runs it once
per layer with ``torch.func.functional_call`` over per-layer views.

- Layer i's weights are drawn in the order the list model draws layer
  i's (``block_fn()`` is called once per layer, each block copied into
  its row and freed), so one seed gives both layouts the same weights;
- the template provides structure and ``forward`` only: its parameters
  are freed to the meta device and it is not registered as a submodule
  (its buffers, such as a rotary table, stay and are used as they are);
  ``train()`` / ``eval()`` and device or dtype moves reach it by hand;
- one ``unbind(0)`` per stacked parameter per forward takes the views: its
  backward stacks the layer grads once (indexing ``stacked[i]`` per layer
  would build a full-size zero grad per layer);
- ``remat`` checkpoints each block in training
  (``distributed.recompute``), with the selective policy
  (``dots_saveable``) for ``remat="selective"``; the reference's scan
  rematerializes the whole block for any truthy value.
"""

from __future__ import annotations

from typing import Callable, List

import torch
from torch import nn
from torch.func import functional_call

from ..distributed.recompute import (dots_saveable, module_generators,
                                     recompute)
from .layer_base import Layer, Parameter


def _free_parameters(module: nn.Module) -> None:
    """Replace every parameter under ``module`` by a meta tensor of its
    shape and dtype."""
    for m in module.modules():
        for name, p in list(m._parameters.items()):
            if p is not None:
                m._parameters[name] = nn.Parameter(
                    torch.empty_like(p, device="meta"),
                    requires_grad=p.requires_grad)


class LayerStack(Layer):
    """``num_layers`` blocks from ``block_fn() -> nn.Module``, stored
    stacked; ``forward(x, *shared)`` runs them in turn, each with the
    ``shared`` arguments (masks, position ids) unchanged."""

    def __init__(self, block_fn: Callable[[], nn.Module], num_layers: int,
                 remat=False):
        super().__init__()
        self.num_layers = int(num_layers)
        self.remat = remat
        template = block_fn()
        named = list(template.named_parameters())
        stacked = []
        with torch.no_grad():
            for _, p in named:
                s = torch.empty((self.num_layers,) + tuple(p.shape),
                                dtype=p.dtype, device=p.device)
                s[0].copy_(p)
                stacked.append(s)
            trainable = [p.requires_grad for _, p in named]
            _free_parameters(template)
            del named[:]
            for i in range(1, self.num_layers):
                block = block_fn()
                for s, p in zip(stacked, block.parameters()):
                    s[i].copy_(p)
                del block
        self._names = [n for n, _ in template.named_parameters()]
        for j, (s, tr) in enumerate(zip(stacked, trainable)):
            self.add_parameter(f"stacked_{j}", Parameter(s, trainable=tr))
        object.__setattr__(self, "template", template)

    def stacked_params(self) -> List[nn.Parameter]:
        return [getattr(self, f"stacked_{j}")
                for j in range(len(self._names))]

    def train(self, mode: bool = True):
        super().train(mode)
        self.template.train(mode)
        return self

    def _apply(self, fn, recurse=True):
        super()._apply(fn, recurse)
        for m in self.template.modules():
            for name, b in m._buffers.items():
                if b is not None:
                    m._buffers[name] = fn(b)
        return self

    def apply_block(self, params, x, *shared):
        """One block over ``params`` (its parameters by the template's
        names)."""
        return functional_call(self.template, params, (x,) + shared)

    def forward(self, x, *shared):
        return self.run(x, 0, self.num_layers, *shared)

    def run(self, x, start: int, stop: int, *shared):
        """Blocks ``start .. stop - 1`` in turn (a pipeline stage's chunk
        of its rows)."""
        views = [p.unbind(0) for p in self.stacked_params()]
        remat = self.remat and self.training and torch.is_grad_enabled()
        policy = dots_saveable if self.remat == "selective" else None
        gens = module_generators(self.template)
        for i in range(start, stop):
            params = {n: v[i] for n, v in zip(self._names, views)}
            if remat:
                x = recompute(self.apply_block, params, x, *shared,
                              policy=policy, generators=gens)
            else:
                x = self.apply_block(params, x, *shared)
        return x
