"""AMP: auto-cast, O2 decoration and the GradScaler.

Counterpart of ``paddle_tpu/amp/__init__.py``: the O1 op lists
``WHITE_LIST``/``BLACK_LIST`` (:64-76, the port's own copies),
``cast_spec``/``apply_cast_spec`` (:82-114), ``auto_cast`` and its alias
``amp_guard`` (:124-143), ``decorate`` (:146-159) and ``GradScaler``
(:162-352), with the ``debugging`` and ``accuracy_compare`` submodules.

``auto_cast`` installs the AMP hook of the op choke point
(``ops/dispatcher.py:hooked``) while it is active and restores the one
before it on exit; each op then casts its floating inputs by
``cast_spec(op name)``: at O1 a white-list op to the low dtype and a
black-list op's low-dtype inputs to float32; at O2 every op not on the
black list to the low dtype. The port's raw tensor arithmetic (residual
adds, reshapes) is not hooked; torch's type promotion gives it the dtypes
the reference's hooked Tensor methods give on the Llama path.

``decorate`` casts each model's floating parameters and buffers to the
low dtype with ``Module.to(dtype=)``, which swaps each tensor's data and
keeps the ``Parameter`` objects, so an optimizer built before it still
owns them (checked; it raises otherwise). Its float32 masters come from
``multi_precision`` at the optimizer's first step.

The loss scale and the good/bad step counters are device tensors, so
scaling, unscaling, the finiteness check and the dynamic transition all
stay on the device, updated in place (a captured graph keeps reading and
writing the same tensors). ``step`` makes one host sync (of ``found``)
and skips ``optimizer.step()`` on a non-finite step; under whole-step
capture (``jit/step_capture.py``) a sync would fail the capture, so it
runs ``optimizer.step()`` every time with ``found`` masking the update
on the device, and the optimizer's ``consume_anomaly()`` reconciles its
step count. When the optimizer's next step
takes the fused route, ``unscale_`` leaves the grads scaled and hands the
scale to the optimizer, whose kernel applies the reciprocal in registers
(``Optimizer._fused_defer_scale``).
"""

from __future__ import annotations

import contextlib
from typing import Set

import torch

from ..core.device import dtype_of
from ..ops import dispatcher
from ..optimizer import optimizer as optimizer_mod

# O1 lists (the reference's, from Paddle's amp_lists.py)
WHITE_LIST: Set[str] = {
    "matmul", "bmm", "mv", "linear", "conv2d", "conv1d", "conv2d_transpose",
    "einsum_impl", "scaled_dot_product_attention", "flash_attention", "addmm",
}
BLACK_LIST: Set[str] = {
    "exp", "log", "log2", "log10", "log1p", "expm1", "pow", "square",
    "softmax_with_cross_entropy", "cross_entropy_mean", "nll_loss",
    "binary_cross_entropy", "binary_cross_entropy_with_logits", "kl_div",
    "layer_norm", "rms_norm", "batch_norm_train", "batch_norm_infer",
    "group_norm", "instance_norm", "softmax", "log_softmax", "logsumexp",
    "mean", "sum", "norm", "cosine_similarity",
}

_state = {"enable": False, "dtype": None, "level": "O1",
          "custom_white": set(), "custom_black": set()}


def cast_spec(name):
    """The autocast decision for op ``name`` under the current AMP state:
    ``(low dtype, cast_low, black)``, or None when autocast is off."""
    if not _state["enable"]:
        return None
    white = name in WHITE_LIST or name in _state["custom_white"]
    black = name in BLACK_LIST or name in _state["custom_black"]
    if _state["level"] == "O2":
        cast_low = not black
    else:
        cast_low = white and not black
    return (_state["dtype"], cast_low, black)


def apply_cast_spec(primals, spec):
    """``primals`` with each floating tensor cast by ``spec``: to the low
    dtype when ``cast_low``, else a black-list op's low-dtype inputs to
    float32. Other values pass unchanged."""
    if spec is None:
        return primals
    low, cast_low, black = spec
    out = []
    for p in primals:
        if isinstance(p, torch.Tensor) and p.is_floating_point():
            if cast_low and p.dtype != low:
                p = p.to(low)
            elif not cast_low and black and p.dtype == low:
                p = p.to(torch.float32)
        out.append(p)
    return out


def _amp_hook(name, primals):
    return apply_cast_spec(primals, cast_spec(name))


@contextlib.contextmanager
def auto_cast(enable: bool = True, custom_white_list=None,
              custom_black_list=None, level: str = "O1",
              dtype: str = "bfloat16"):
    """Cast the inputs of the ops run inside by the O2 rule (``level``
    "O2") or else the O1 rule, as the reference does, with
    ``custom_white_list``/``custom_black_list`` added to the lists; the
    previous state and hook come back on exit."""
    prev, prev_hook = dict(_state), dispatcher._AMP_HOOK
    _state.update(enable=enable, dtype=dtype_of(dtype), level=level,
                  custom_white=set(custom_white_list or ()),
                  custom_black=set(custom_black_list or ()))
    dispatcher.set_amp_hook(_amp_hook if enable else None)
    try:
        yield
    finally:
        _state.clear()
        _state.update(prev)
        dispatcher.set_amp_hook(prev_hook)


amp_guard = auto_cast


def decorate(models=None, optimizers=None, level: str = "O2",
             dtype: str = "bfloat16", master_weight=None, save_dtype=None):
    """O2 decoration: each model's floating parameters and buffers cast
    to ``dtype`` in place (``Module.to``), the ``Parameter`` objects kept;
    the optimizers keep float32 masters (``multi_precision``). Returns
    ``models`` (and ``optimizers`` when given), as the reference does."""
    low = dtype_of(dtype)
    single = not isinstance(models, (list, tuple))
    model_list = [models] if single else list(models)
    for m in model_list:
        if m is None:
            continue
        before = list(m.parameters())
        m.to(dtype=low)
        if any(a is not b for a, b in zip(before, m.parameters())):
            raise RuntimeError("Module.to made new Parameter objects (torch."
                               "__future__ overwrite on conversion is set): "
                               "an optimizer built before decorate would "
                               "lose them")
    if optimizers is None:
        return models if single else model_list
    return (models if single else model_list), optimizers


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
        self._init_good = self._init_bad = 0
        self._scale_t = self._good_t = self._bad_t = None
        self._found_dev = self._gnorm_dev = None
        self._found_last = False
        self._unscaled = set()

    def _state_on(self, device) -> None:
        if self._scale_t is None:
            self._scale_t = torch.full((), self._init_scale,
                                       dtype=torch.float32, device=device)
            self._good_t = torch.full((), self._init_good,
                                      dtype=torch.int32, device=device)
            self._bad_t = torch.full((), self._init_bad, dtype=torch.int32,
                                     device=device)

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
            # a copy: step() moves the scale in place before the update
            optimizer._pending_scale = self._scale_t.clone()
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
            new = update_loss_scaling(
                found, self._scale_t, self._good_t, self._bad_t,
                self._incr_every, self._decr_every, self._incr_ratio,
                self._decr_ratio)
            for t, v in zip((self._scale_t, self._good_t, self._bad_t), new):
                t.copy_(v)
        if optimizer_mod._CAPTURE is not None:
            # no host sync: the update is masked by found on the device
            self._found_last = False
            optimizer._pending_found = None if found is None \
                else (found, gnorm)
            optimizer.step()
        else:
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

    def minimize(self, optimizer, scaled_loss) -> None:
        """``step`` then ``clear_grad`` (the caller ran the backward of
        ``scaled_loss``)."""
        self.step(optimizer)
        optimizer.clear_grad()

    def update(self) -> None:
        """Nothing: ``step`` already moved the scale (Paddle recipes call
        it after ``step``)."""

    def is_enable(self) -> bool:
        return self._enable

    def get_loss_scaling(self) -> float:
        if not self._enable:
            return 1.0
        if self._scale_t is None:
            return self._init_scale
        return float(self._scale_t)

    def state_dict(self):
        if not self._enable:
            return {"scale": 1.0, "good": 0, "bad": 0}
        if self._scale_t is None:
            return {"scale": self._init_scale, "good": self._init_good,
                    "bad": self._init_bad}
        return {"scale": float(self._scale_t), "good": int(self._good_t),
                "bad": int(self._bad_t)}

    def set_state_dict(self, sd) -> None:
        if not self._enable:
            return
        if self._scale_t is None:   # made on the first device seen
            self._init_scale = float(sd["scale"])
            self._init_good, self._init_bad = int(sd["good"]), int(sd["bad"])
            return
        self._scale_t.fill_(float(sd["scale"]))
        self._good_t.fill_(int(sd["good"]))
        self._bad_t.fill_(int(sd["bad"]))


from . import accuracy_compare, debugging  # noqa: E402

__all__ = ["BLACK_LIST", "GradScaler", "WHITE_LIST", "accuracy_compare",
           "amp_guard", "apply_cast_spec", "auto_cast", "cast_spec",
           "debugging", "decorate", "update_loss_scaling"]
