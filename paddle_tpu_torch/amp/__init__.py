"""AMP: the GradScaler.

Counterpart of ``paddle_tpu/amp/__init__.py`` (:162-352), ``GradScaler``
only: ``auto_cast`` and ``decorate`` are not ported yet (the Llama model is
built in bf16 directly).

The loss scale and the good/bad step counters are device tensors, so
scaling, unscaling, the finiteness check and the dynamic transition all
stay on the device. ``step`` makes one host sync (of ``found``) and skips
``optimizer.step()`` on a non-finite step. When the optimizer's next step
takes the fused route, ``unscale_`` leaves the grads scaled and hands the
scale to the optimizer, whose kernel applies the reciprocal in registers
(``Optimizer._fused_defer_scale``).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..optimizer import optimizer as optimizer_mod


def update_loss_scaling(found, scale, good, bad, incr_every_n_steps=1000,
                        decr_every_n_nan_or_inf=2, incr_ratio=2.0,
                        decr_ratio=0.5):
    """The dynamic loss-scale transition, on device tensors: ``(new
    scale, new good, new bad)``. The reference's
    ``update_loss_scaling_kernel`` (``ops/kernels/extra_misc.py:302``) with
    no tensors to zero and ``stop_update`` False."""
    found = found.bool()
    scale = scale.float()
    good_n = torch.where(found, 0, good.int() + 1)
    bad_n = torch.where(found, bad.int() + 1, 0)
    up = good_n >= incr_every_n_steps
    scale_up = torch.where(up, scale * float(incr_ratio), scale)
    good_n = torch.where(up, 0, good_n)
    down = bad_n >= decr_every_n_nan_or_inf
    scale_dn = torch.where(down, torch.clamp(scale * float(decr_ratio),
                                             min=1.0), scale_up)
    bad_n = torch.where(down, 0, bad_n)
    return scale_dn, good_n.int(), bad_n.int()


class GradScaler:
    """Loss scaling (reference grad_scaler.py:579). The state tensors live
    on the device of the first loss or grads it sees."""

    def __init__(self, enable: bool = True,
                 init_loss_scaling: float = 2.0 ** 15,
                 incr_ratio: float = 2.0, decr_ratio: float = 0.5,
                 incr_every_n_steps: int = 1000,
                 decr_every_n_nan_or_inf: int = 2,
                 use_dynamic_loss_scaling: bool = True):
        self._enable = enable
        self._init_scale = float(init_loss_scaling) if enable else 1.0
        self._incr_ratio, self._decr_ratio = incr_ratio, decr_ratio
        self._incr_every = incr_every_n_steps
        self._decr_every = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._scale_t: Optional[torch.Tensor] = None
        self._good_t: Optional[torch.Tensor] = None
        self._bad_t: Optional[torch.Tensor] = None
        self._found_dev = self._gnorm_dev = None
        self._found_last = False
        self._unscaled = set()

    def _state_on(self, device) -> None:
        if self._scale_t is None:
            self._scale_t = torch.full((), self._init_scale,
                                       dtype=torch.float32, device=device)
            self._good_t = torch.zeros((), dtype=torch.int32, device=device)
            self._bad_t = torch.zeros((), dtype=torch.int32, device=device)

    def scale(self, loss: torch.Tensor) -> torch.Tensor:
        if not self._enable or (not self._dynamic
                                and self._init_scale == 1.0):
            return loss
        self._state_on(loss.device)
        # in the loss's dtype: scales are powers of two, exact in bf16
        return loss * self._scale_t.to(loss.dtype)

    @torch.no_grad()
    def unscale_(self, optimizer) -> None:
        """Unscale + finite check + global norm, on the device. On the
        fused route the grads stay scaled (the kernel unscales)."""
        if not self._enable or id(optimizer) in self._unscaled:
            return
        self._unscaled.add(id(optimizer))
        grads = [p.grad for p in optimizer._parameter_list
                 if p.grad is not None]
        if not grads:
            self._found_dev = None
            self._found_last = False
            return
        self._state_on(grads[0].device)
        inv = optimizer_mod.inv_scale(self._scale_t)
        if optimizer._fused_defer_scale():
            found, gnorm = optimizer_mod.sentinel_reduce(
                optimizer_mod.conditioned(grads, inv))
            optimizer._pending_scale = self._scale_t
        else:
            for g in grads:
                g.mul_(inv.to(g.dtype))
            found, gnorm = optimizer_mod.sentinel_reduce(grads)
        self._found_dev, self._gnorm_dev = found, gnorm

    def step(self, optimizer) -> None:
        if not self._enable:
            optimizer.step()
            return
        self.unscale_(optimizer)
        found, gnorm = self._found_dev, self._gnorm_dev
        if found is not None and self._dynamic:
            self._scale_t, self._good_t, self._bad_t = update_loss_scaling(
                found, self._scale_t, self._good_t, self._bad_t,
                self._incr_every, self._decr_every, self._incr_ratio,
                self._decr_ratio)
        # the one host sync, after the scale transition is queued
        skip = bool(found > 0) if found is not None else False
        self._found_last = skip
        if not skip:
            optimizer.step()
        if found is not None:
            optimizer._stash_anomaly(found, gnorm)
            if skip:   # optimizer.step never ran: keep the ledger even
                optimizer._reconciled_skips += 1
        self._found_dev = self._gnorm_dev = None
        optimizer._pending_scale = None
        self._unscaled.discard(id(optimizer))


__all__ = ["GradScaler", "update_loss_scaling"]
