"""One user-level script through both packages.

``run_both(fn)`` calls ``fn(pkg)`` with the JAX package and with the port
(``import paddle_tpu_torch as paddle``, the CPU as its device), each after
``pkg.seed(0)``, and returns both results as numpy trees; ``assert_both``
compares them at a stated tolerance. A script builds its inputs with numpy
from a seed, so both packages see the same values. Integer results are
compared by value (the port's are int64 where the reference's are int32).
"""

from __future__ import annotations

import numpy as np
import torch

import paddle_tpu
import paddle_tpu_torch


def to_numpy(v):
    """A result as numpy: tensors of either package, nested in tuples,
    lists and dicts; other values as they are."""
    if isinstance(v, torch.Tensor):
        t = v.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return np.array(t.cpu().numpy())
    if isinstance(v, paddle_tpu.Tensor):
        return np.asarray(v.numpy())
    if isinstance(v, (list, tuple)):
        return type(v)(to_numpy(x) for x in v) if type(v) in (list, tuple) \
            else [to_numpy(x) for x in v]
    if isinstance(v, dict):
        return {k: to_numpy(x) for k, x in v.items()}
    return v


def run_both(fn):
    """``(fn(paddle_tpu), fn(paddle_tpu_torch))`` as numpy trees."""
    prev = paddle_tpu_torch.get_device()
    paddle_tpu_torch.set_device("cpu")
    try:
        paddle_tpu.seed(0)
        ref = to_numpy(fn(paddle_tpu))
        paddle_tpu_torch.seed(0)
        port = to_numpy(fn(paddle_tpu_torch))
    finally:
        paddle_tpu_torch.set_device(prev)
    return ref, port


def assert_tree(port, ref, atol, rtol=0.0, path="out"):
    if isinstance(ref, dict):
        assert set(port) == set(ref), path
        for k in ref:
            assert_tree(port[k], ref[k], atol, rtol, f"{path}[{k!r}]")
        return
    if isinstance(ref, (list, tuple)):
        assert isinstance(port, (list, tuple)) and len(port) == len(ref), \
            (path, port, ref)
        for i, (p, r) in enumerate(zip(port, ref)):
            assert_tree(p, r, atol, rtol, f"{path}[{i}]")
        return
    if isinstance(ref, np.ndarray) or isinstance(port, np.ndarray):
        p, r = np.asarray(port), np.asarray(ref)
        assert p.shape == r.shape, (path, p.shape, r.shape)
        if r.dtype.kind in "fc" or p.dtype.kind in "fc":
            np.testing.assert_allclose(p, r, atol=atol, rtol=rtol,
                                       err_msg=path)
        else:
            np.testing.assert_array_equal(p.astype(np.int64),
                                          r.astype(np.int64), err_msg=path)
        return
    if isinstance(ref, float) or isinstance(port, float):
        assert abs(float(port) - float(ref)) <= atol + rtol * abs(ref), \
            (path, port, ref)
        return
    assert port == ref, (path, port, ref)


def assert_both(fn, atol=1e-6, rtol=0.0):
    """Run ``fn`` through both packages and hold the port to the
    reference; returns the port's result."""
    ref, port = run_both(fn)
    assert_tree(port, ref, atol, rtol)
    return port
