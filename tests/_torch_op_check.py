"""One op in both packages from one set of seeded numpy inputs: the
port's ``ops.dispatcher.call_op`` against the JAX package's, forward and,
for an op the reference differentiates (``backward: auto``), the VJP of
every floating input under a random cotangent, as ``tests/op_test.py``
``check_output`` / ``check_grad`` do for the reference alone.

Complex gradients: a complex output gets a complex cotangent ``ct``
(real and imaginary parts drawn from the seed). The reference's loss is
``sum(out * ct)`` (complex), whose VJP at 1 is JAX's ``vjp(ct)``; the
port's is ``Re(sum(out * ct))``, real, as torch's autograd needs. For a
real input both give the same gradient. For a complex input JAX's VJP is
the conjugate of torch's ``.grad`` (JAX transposes the bilinear pairing,
torch returns the conjugate Wirtinger derivative), so the port's gradient
is conjugated before the comparison.

Inputs: numpy arrays become tensors (a list of arrays a list of
tensors: ``concat``, ``meshgrid``, ``einsum_impl``); anything else passes
as it is. Outputs are compared by value: the port's integer outputs are
int64 where the reference's are int32, so dtypes are not compared, only
shapes and values (floats within ``atol`` / ``rtol``, the rest exactly).
"""

from __future__ import annotations

import numpy as np
import torch

from paddle_tpu.core.tensor import Tensor
from paddle_tpu.ops import dispatcher as rdisp
from paddle_tpu_torch.ops import dispatcher as tdisp


def _floating(a) -> bool:
    """A differentiable input: floating or complex."""
    return isinstance(a, np.ndarray) and (
        np.issubdtype(a.dtype, np.floating)
        or np.issubdtype(a.dtype, np.complexfloating))


def _cotangent(rng, shape, dtype):
    """A cotangent for an output of ``dtype``: complex for a complex
    output, else real; None for an integer or bool output."""
    if np.issubdtype(dtype, np.complexfloating):
        return (rng.randn(*shape) + 1j * rng.randn(*shape)).astype(
            np.complex64)
    if np.issubdtype(dtype, np.floating):
        return np.asarray(rng.randn(*shape), np.float32)
    return None


def _port_loss(p, ct):
    """The port's real loss for one output: ``Re(sum(p * ct))``."""
    prod = (p * torch.from_numpy(ct)).sum()
    return prod.real if prod.is_complex() else prod


def _port_grad(t) -> np.ndarray:
    """The port's gradient of ``t`` in JAX's convention (conjugated for a
    complex input)."""
    g = t.grad
    if g is None:
        return np.zeros(t.shape, np.complex64 if t.is_complex()
                        else np.float32)
    return (g.conj() if g.is_complex() else g).resolve_conj().numpy()


def _arrays(v):
    """The numpy arrays of one argument, in order."""
    if isinstance(v, np.ndarray):
        return [v]
    if isinstance(v, (list, tuple)) and v and all(
            isinstance(a, np.ndarray) for a in v):
        return list(v)
    return []


def _convert(v, make):
    if isinstance(v, np.ndarray):
        return make(v)
    if isinstance(v, (list, tuple)) and v and all(
            isinstance(a, np.ndarray) for a in v):
        return [make(a) for a in v]
    return v


def _leaves(out):
    if isinstance(out, (list, tuple)):
        return [x for o in out for x in _leaves(o)]
    return [out]


def _ref_np(t) -> np.ndarray:
    return np.asarray(t.numpy()) if isinstance(t, Tensor) else np.asarray(t)


def _port_np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        t = t.detach().resolve_conj()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return np.asarray(t)


def assert_values(got: np.ndarray, want: np.ndarray, atol, rtol, what=""):
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if np.issubdtype(want.dtype, np.floating) or \
            np.issubdtype(want.dtype, np.complexfloating):
        np.testing.assert_allclose(got, want, atol=atol, rtol=rtol,
                                   err_msg=what)
    else:
        np.testing.assert_array_equal(got.astype(np.int64)
                                      if got.dtype != bool else got,
                                      want.astype(np.int64)
                                      if want.dtype != bool else want,
                                      err_msg=what)


def run_ref(name, args, kwargs, grad):
    ins = []

    def make(a):
        t = Tensor(a, stop_gradient=not (grad and _floating(a)))
        ins.append(t)
        return t

    out = rdisp.call_op(name, *[_convert(a, make) for a in args], **kwargs)
    return out, ins


def run_port(name, args, kwargs, grad):
    ins = []

    def make(a):
        t = torch.from_numpy(np.array(a, copy=True))
        if grad and _floating(a):
            t.requires_grad_(True)
        ins.append(t)
        return t

    out = tdisp.call_op(name, *[_convert(a, make) for a in args], **kwargs)
    return out, ins


def check_fn(name, args, kwargs, ref_fn, *, atol, rtol=1e-6, grad=True,
             seed=0):
    """As :func:`check_op`, against ``ref_fn`` (the reference's kernel
    over jax arrays, for an op whose reference ``call_op`` cannot take
    the arguments) with its VJP from ``jax.vjp``; one output."""
    import jax
    import jax.numpy as jnp
    floats = [i for i, a in enumerate(args) if _floating(a)] if grad else []
    jargs = [jnp.asarray(a) if isinstance(a, np.ndarray) else a
             for a in args]

    def f(*fl):
        full = list(jargs)
        for i, v in zip(floats, fl):
            full[i] = v
        return ref_fn(*full, **kwargs)

    want, vjp = jax.vjp(f, *[jargs[i] for i in floats])
    p_out, p_ins = run_port(name, args, kwargs, bool(floats))
    assert_values(_port_np(p_out), np.asarray(want), atol, rtol, name)
    if not floats:
        return p_out
    ct = _cotangent(np.random.RandomState(seed + 1000), np.shape(want),
                    np.asarray(want).dtype)
    _port_loss(p_out, ct).backward()
    grads = vjp(jnp.asarray(ct))
    ports = [t for t in p_ins if t.requires_grad]
    for i, (g, t) in enumerate(zip(grads, ports)):
        assert_values(_port_grad(t), np.asarray(g), atol, rtol,
                      f"{name} grad of input {i}")
    return p_out


def check_op(name, args, kwargs=None, *, atol, rtol=1e-6, grad=None,
             grad_atol=None, seed=0, ref=None):
    """Hold the port's op ``name`` on ``args`` / ``kwargs`` to the
    reference's: values, then (``grad`` None: where the reference
    differentiates the op) the input grads under one random cotangent per
    floating output. ``ref``: ``(name, args, kwargs)`` of another
    reference op that computes the same function (the reference's
    ``pool2d`` for the pools' ``ceil_mode``). Returns the port's
    output."""
    kwargs = dict(kwargs or {})
    ref_name, ref_args, ref_kw = ref or (name, args, kwargs)
    if grad is None:
        grad = rdisp.OPS[ref_name].differentiable
    grad = grad and any(_floating(a) for v in args for a in _arrays(v))
    r_out, r_ins = run_ref(ref_name, ref_args, dict(ref_kw), grad)
    p_out, p_ins = run_port(name, args, kwargs, grad)
    r_leaves, p_leaves = _leaves(r_out), _leaves(p_out)
    assert len(r_leaves) == len(p_leaves), (name, len(r_leaves),
                                            len(p_leaves))
    for i, (r, p) in enumerate(zip(r_leaves, p_leaves)):
        assert_values(_port_np(p), _ref_np(r), atol, rtol,
                      f"{name} output {i}")
    if not grad:
        return p_out
    rng = np.random.RandomState(seed + 1000)
    r_loss, p_loss = None, None
    for r, p in zip(r_leaves, p_leaves):
        want = _ref_np(r)
        ct = _cotangent(rng, want.shape, want.dtype)
        if ct is None:
            continue
        rl = (r * Tensor(ct)).sum()
        pl = _port_loss(p, ct)
        r_loss = rl if r_loss is None else r_loss + rl
        p_loss = pl if p_loss is None else p_loss + pl
    if r_loss is None:
        return p_out
    r_loss.backward()
    if p_loss.requires_grad:      # else the port's output holds no grad path
        p_loss.backward()
    ga = atol if grad_atol is None else grad_atol
    for i, (rt, pt) in enumerate(zip(r_ins, p_ins)):
        if not pt.requires_grad:
            continue
        got = _port_grad(pt)
        want = np.zeros(pt.shape, got.dtype) if rt.grad is None \
            else _ref_np(rt.grad)
        assert_values(got, want, ga, rtol, f"{name} grad of input {i}")
    return p_out
