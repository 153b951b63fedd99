"""``paddle.DataParallel``: data parallelism with a bucketed reducer.

Counterpart of ``DataParallel`` in ``paddle_tpu/distributed/__init__.py``
(:30-45), whose GSPMD mesh reduces the grads by construction. The port is
one process per rank, so it has the reducer of upstream Paddle's
``EagerReducer``:

- at construction every parameter and buffer is broadcast from the
  group's first rank, so the replicas start equal;
- the parameters are cut into buckets, walking them in reverse (the
  order their grads arrive in a backward): ``comm_buffer_size`` MB each,
  except the bucket of the first parameters, which holds at most
  ``last_comm_buffer_size`` MB;
- a hook on each parameter's grad accumulator counts it in; when a
  bucket's last grad has arrived, the bucket's grads are flattened and
  its all-reduce starts (asynchronously);
- at the end of the backward (an autograd engine callback) every bucket
  is waited for, divided by the group's size, and written back into the
  grads: ``loss.backward()`` returns with the grads averaged over the
  group, before ``optimizer.step()``. A parameter that got no grad counts
  as zeros.

The hooks sit on the grad accumulators, not on the parameters, so the
fused optimizer (which refuses parameters with tensor hooks) keeps its
route. ``no_sync()`` turns the reducer off for an accumulation window;
``sync_grads()`` reduces the window's grads at its end where no synced
backward closes it.

A parameter marked ``no_sync`` (an expert of an expert-parallel
``MoELayer``, which holds only its rank's experts) is not all-reduced: its
grad is already the sum of every replica's loss's grad (the all-to-alls'
backward brought them). A pre-hook on its grad accumulator divides each
contribution by the group's size, so it is the mean's grad, as the
reduced grads are, in accumulation windows too.
"""

from __future__ import annotations

import contextlib
from typing import List

import torch

from ..nn.layer_base import Layer
from . import collective as C
from .topology import get_hybrid_communicate_group


def _buckets(params, comm_mb: float, last_mb: float) -> List[List[int]]:
    """Bucket indexes into ``params``, in reverse order of the list."""
    size = [p.numel() * p.element_size() for p in params]
    cap, last_cap = comm_mb * (1 << 20), last_mb * (1 << 20)
    head, n = 0, 0
    while head < len(params) and (head == 0 or n + size[head] <= last_cap):
        n += size[head]
        head += 1
    out, cur, cur_n = [], [], 0
    for i in range(len(params) - 1, head - 1, -1):
        if cur and cur_n + size[i] > cap:
            out.append(cur)
            cur, cur_n = [], 0
        cur.append(i)
        cur_n += size[i]
    if cur:
        out.append(cur)
    out.append(list(range(head - 1, -1, -1)))
    return [b for b in out if b]


class DataParallel(Layer):
    def __init__(self, layers, strategy=None, comm_buffer_size: float = 25,
                 last_comm_buffer_size: float = 1,
                 find_unused_parameters: bool = False, group=None):
        super().__init__()
        self._layers = layers
        if group is None:
            hcg = get_hybrid_communicate_group()
            group = hcg.get_data_parallel_group() if hcg is not None \
                else C._group(None)
        self.group = group
        self.find_unused_parameters = find_unused_parameters
        trainable = [p for p in layers.parameters() if p.requires_grad]
        self._params = [p for p in trainable
                        if not getattr(p, "no_sync", False)]
        self._local = [p for p in trainable if getattr(p, "no_sync", False)]
        self._enabled = group.nranks > 1
        self._nodes = []
        if not self._enabled:
            return
        src = group.ranks[0]
        with torch.no_grad():
            for t in [p for p in layers.parameters()
                      if not getattr(p, "no_sync", False)] \
                    + list(layers.buffers()):
                C.broadcast(t.data, src=src, group=group)
        scale = 1.0 / group.nranks
        for p in self._local:
            node = torch.autograd.graph.get_gradient_edge(p).node
            node.register_prehook(
                lambda go: tuple(None if g is None else g * scale
                                 for g in go))
            self._nodes.append(node)
        self.buckets = _buckets(self._params, comm_buffer_size,
                                last_comm_buffer_size)
        self._bucket_of = {i: b for b, idx in enumerate(self.buckets)
                           for i in idx}
        for i, p in enumerate(self._params):
            node = torch.autograd.graph.get_gradient_edge(p).node
            node.register_hook(self._hook(i))
            self._nodes.append(node)       # a node lives while referenced
        self._reset()

    def _reset(self):
        self._left = [len(b) for b in self.buckets]
        self._works = {}
        self._queued = False

    def _hook(self, i: int):
        def on_grad(*_):
            if not self._enabled:
                return
            if not self._queued:
                self._queued = True
                torch.autograd.Variable._execution_engine.queue_callback(
                    self._finish)
            b = self._bucket_of[i]
            self._left[b] -= 1
            if self._left[b] == 0:
                self._launch(b)
        return on_grad

    def _grad(self, i: int) -> torch.Tensor:
        p = self._params[i]
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        return p.grad

    def _launch(self, b: int) -> None:
        flat = torch.cat([self._grad(i).reshape(-1)
                          for i in self.buckets[b]])
        self._works[b] = (flat, C.all_reduce_async(flat, group=self.group))

    def _finish(self) -> None:
        try:
            for b in range(len(self.buckets)):
                if b not in self._works:
                    self._launch(b)
            for b, (flat, work) in sorted(self._works.items()):
                work.wait()
                flat.div_(self.group.nranks)
                off = 0
                for i in self.buckets[b]:
                    g = self._params[i].grad
                    g.copy_(flat[off:off + g.numel()].view_as(g))
                    off += g.numel()
        finally:
            self._reset()

    def sync_grads(self) -> None:
        """All-reduce and average every bucket now: the end of an
        accumulation window whose backwards all ran under ``no_sync()``
        (the pipeline's microbatches)."""
        if self.group.nranks > 1:
            self._finish()

    @contextlib.contextmanager
    def no_sync(self):
        """Grads accumulate locally; the next synced backward reduces
        them all."""
        prev, self._enabled = self._enabled, False
        try:
            yield
        finally:
            self._enabled = prev

    def forward(self, *inputs, **kwargs):
        return self._layers(*inputs, **kwargs)

    def state_dict(self, *args, **kwargs):
        return self._layers.state_dict(*args, **kwargs)

    def set_state_dict(self, state_dict, *args, **kwargs):
        return self._layers.set_state_dict(state_dict, *args, **kwargs)

    def __getattr__(self, name):
        try:
            return super().__getattr__(name)
        except AttributeError:
            return getattr(self._modules["_layers"], name)
