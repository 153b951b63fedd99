"""Functional higher-order autograd: ``jacobian``, ``hessian``, ``jvp``,
``vjp`` and ``vhp``.

Counterpart of ``paddle_tpu/autograd/functional.py`` over
``torch.autograd.functional``, with the reference's argument conventions
and output nesting: one input (a tensor, not a tuple) gives results per
output; several inputs give tuples over the inputs (inside tuples over
the outputs for ``jacobian``); ``v`` None means ones. The user function
takes and returns Paddle ``Tensor``s.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..core.tensor import Tensor, unwrap, wrap

__all__ = ["jacobian", "hessian", "jvp", "vjp", "vhp"]


def _inputs(xs):
    single = not isinstance(xs, (tuple, list))
    seq = [xs] if single else list(xs)
    return tuple(unwrap(x).detach() if isinstance(x, torch.Tensor)
                 else torch.as_tensor(x) for x in seq), single


def _pure(func: Callable, single: bool) -> Callable:
    """``func`` over plain tensors: its inputs made ``Tensor``s (aliases,
    attached to the graph), its outputs plain again."""
    def f(*ts):
        args = [t.as_subclass(Tensor) for t in ts]
        out = func(args[0]) if single else func(*args)
        return tuple(unwrap(o) for o in out) \
            if isinstance(out, (tuple, list)) else unwrap(out)
    return f


def jacobian(func: Callable, xs, create_graph: bool = False,
             allow_unused: bool = False, mode: str = "rev"):
    """d func / d xs: one input and one output give a Tensor of shape
    ``[*out_shape, *in_shape]``."""
    ins, single = _inputs(xs)
    jac = torch.autograd.functional.jacobian(
        _pure(func, single), ins[0] if single else ins,
        create_graph=create_graph, strict=False,
        vectorize=mode != "rev",
        strategy="reverse-mode" if mode == "rev" else "forward-mode")
    return wrap(jac)


def hessian(func: Callable, xs, create_graph: bool = False,
            allow_unused: bool = False):
    """d² func / d xs² of a scalar ``func``."""
    ins, single = _inputs(xs)
    pure = _pure(func, single)

    def scalar(*a):
        out = pure(*a)
        out = out[0] if isinstance(out, tuple) else out
        return out.reshape(())
    hes = torch.autograd.functional.hessian(
        scalar, ins[0] if single else ins, create_graph=create_graph)
    return wrap(hes)


def _tangents(v, ins):
    if v is None:
        return tuple(torch.ones_like(x) for x in ins)
    vs, _ = _inputs(v)
    return vs


def jvp(func: Callable, xs, v=None):
    """Forward mode: ``(func(xs), J·v)``."""
    ins, single = _inputs(xs)
    tv = _tangents(v, ins)
    out, jv = torch.autograd.functional.jvp(
        _pure(func, single), ins[0] if single else ins,
        tv[0] if single else tv)
    return wrap(out), wrap(jv)


def vjp(func: Callable, xs, v=None):
    """Reverse mode: ``(func(xs), vᵀ·J)``."""
    ins, single = _inputs(xs)
    ins = tuple(x.requires_grad_(True) for x in ins)
    with torch.enable_grad():
        out = _pure(func, single)(*ins)
        outs = out if isinstance(out, tuple) else (out,)
        cots = tuple(torch.ones_like(o) for o in outs) if v is None \
            else _inputs(v)[0]
        grads = torch.autograd.grad(outs, ins, cots, allow_unused=True)
    grads = tuple(torch.zeros_like(x) if g is None else g
                  for x, g in zip(ins, grads))
    out = tuple(o.detach() for o in outs) if isinstance(out, tuple) \
        else out.detach()
    return wrap(out), wrap(grads[0] if single else grads)


def vhp(func: Callable, xs, v=None):
    """Hessian-vector product of a scalar ``func``: ``(func(xs), H·v)``."""
    ins, single = _inputs(xs)
    pure = _pure(func, single)

    def scalar(*a):
        out = pure(*a)
        out = out[0] if isinstance(out, tuple) else out
        return out.reshape(())
    tv = _tangents(v, ins)
    out, hv = torch.autograd.functional.vhp(
        scalar, ins[0] if single else ins, tv[0] if single else tv)
    return wrap(out), wrap(hv)
