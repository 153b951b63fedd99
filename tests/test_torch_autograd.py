"""The Paddle autograd API of the port against the JAX package's.

The scenarios of ``tests/test_autograd.py``, ``tests/test_double_grad.py``
and ``tests/test_autograd_functional.py``, each written once as user code
over ``paddle`` and run through both packages on the same numpy inputs
(``tests/_torch_both.py``), float32, values within atol 1e-5 / rtol 1e-5
(the products and transcendental functions round in another order);
the reference's tape there, torch's engine here. What a scenario checks
on one package only (an exception, ``stop_gradient`` of a result, a hook
handle) it checks on each.
"""

import numpy as np
import pytest

import paddle_tpu
import paddle_tpu_torch
from _torch_both import assert_both

TOL = dict(atol=1e-5, rtol=1e-5)


def f32(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _t(P, a, sg=False):
    return P.to_tensor(np.asarray(a, np.float32), stop_gradient=not sg)


# -- backward (tests/test_autograd.py) ----------------------------------------

def s_chain(P):
    x = _t(P, [2.0], True)
    (x * x * x).sum().backward()
    return x.grad


def s_fan_out(P):
    x = _t(P, [3.0], True)
    (x * 2.0 + x * 4.0).sum().backward()
    return x.grad


def s_accumulates(P):
    x = _t(P, [1.0], True)
    (x * 2.0).sum().backward()
    (x * 3.0).sum().backward()
    return x.grad


def s_stop_gradient_cuts(P):
    x = _t(P, [1.0], True)
    y = x * 2.0
    y.stop_gradient = True
    z = y * 3.0
    w = _t(P, [1.0], True)
    (z.detach() * w).sum().backward()
    return [x.grad is None, z.stop_gradient, w.grad]


def s_grad_tensor(P):
    x = _t(P, [1.0, 2.0], True)
    (x * 2.0).backward(_t(P, [1.0, 0.5]))
    return x.grad


def s_no_grad(P):
    x = _t(P, [1.0], True)
    with P.no_grad():
        y = x * 2.0
    return [y.stop_gradient, y]


def s_split_grad(P):
    x = P.to_tensor(f32(4, 6), stop_gradient=False)
    parts = P.split(x, 2, axis=1)
    (parts[0].sum() * 2.0 + parts[1].sum() * 3.0).backward()
    return x.grad


def s_broadcast_grad(P):
    x = P.to_tensor(f32(3, 4), stop_gradient=False)
    b = P.to_tensor(f32(4, seed=1), stop_gradient=False)
    (x + b).sum().backward()
    return [list(b.grad.shape), b.grad, x.grad]


def s_retain_graph(P):
    x = _t(P, [2.0], True)
    y = (x * x).sum()
    y.backward(retain_graph=True)
    y.backward()
    return x.grad


def s_paddle_grad(P):
    x = _t(P, [3.0], True)
    (g,) = P.grad((x * x).sum(), x)
    return [g, x.grad is None]


def s_grad_keeps_existing(P):
    x = _t(P, [1.0], True)
    (x * 5.0).sum().backward()
    P.grad((x * x).sum(), x)
    return x.grad


def s_hook_scales(P):
    x = _t(P, [1.0], True)
    y = x * 2.0
    x.register_hook(lambda g: g * 10.0)
    y.sum().backward()
    return x.grad


def s_hook_remove(P):
    x = _t(P, [1.0], True)
    h = x.register_hook(lambda g: g * 10.0)
    h.remove()
    (x * 2.0).sum().backward()
    return x.grad


def s_setitem(P):
    x = _t(P, [1.0, 2.0, 3.0])
    x[1] = 9.0
    return [x, x.inplace_version]


def s_hook_once(P):
    x = _t(P, [1.0], True)
    a, b = x * 1.0, x * 1.0
    x.register_hook(lambda g: g.clip(0.0, 1.0))
    (a + b).sum().backward()
    return x.grad


def s_nonleaf_hook(P):
    x = _t(P, [1.0], True)
    y = x * 1.0
    a, b = y * 1.0, y * 1.0
    y.register_hook(lambda g: g * 10.0)
    (a + b).sum().backward()
    return x.grad


def s_numpy_scalar_left(P):
    x = _t(P, [2.0], True)
    y = np.float32(0.5) * x
    y.sum().backward()
    return [isinstance(y, P.Tensor), x.grad]


# -- higher order (tests/test_double_grad.py) ---------------------------------

def s_double_poly(P):
    x = _t(P, [2.0, -1.5], True)
    (g,) = P.grad((x * x * x).sum(), x, create_graph=True)
    (g2,) = P.grad(g.sum(), x)
    return [g.stop_gradient, g, g2]


def s_double_transcendental(P):
    x = _t(P, np.linspace(-1.0, 1.0, 5), True)
    y = (P.tanh(x) * x + P.exp(-x * x)).sum()
    (g,) = P.grad(y, x, create_graph=True)
    (g2,) = P.grad(g.sum(), x)
    return [g, g2]


def s_second_grad_matmul(P):
    a = _t(P, np.arange(6).reshape(2, 3) / 7.0, True)
    b = _t(P, np.arange(12).reshape(3, 4) / 11.0, True)
    (ga,) = P.grad((P.matmul(a, b) ** 2).sum(), a, create_graph=True)
    (gb,) = P.grad((ga ** 2).sum(), b)
    return [ga, gb]


def s_triple(P):
    x = _t(P, [1.5], True)
    (g1,) = P.grad((x ** 4).sum(), x, create_graph=True)
    (g2,) = P.grad(g1.sum(), x, create_graph=True)
    (g3,) = P.grad(g2.sum(), x)
    return [g1, g2, g3]


def s_create_graph_false(P):
    x = _t(P, [3.0], True)
    (g,) = P.grad((x * x).sum(), x)
    return [g.stop_gradient, g]


def s_grad_outputs(P):
    x = _t(P, [1.0, 2.0], True)
    v = _t(P, [3.0, 5.0])
    (g,) = P.grad(x * x * x, x, grad_outputs=v, create_graph=True)
    (g2,) = P.grad(g.sum(), x)
    return [g, g2]


def s_backward_create_graph(P):
    x = _t(P, [2.0], True)
    P.autograd.backward([(x * x).sum()], [None], create_graph=True)
    (g2,) = P.grad(x.grad.sum(), x)
    return [x.grad, g2]


def s_grad_nonleaf(P):
    x = _t(P, [2.0, 3.0], True)
    y = x * 3.0
    (gy,) = P.grad((y * y).sum(), y)
    return gy


def s_grad_other_leaves(P):
    x, w = _t(P, [1.0], True), _t(P, [2.0], True)
    (g,) = P.grad((x * w).sum(), x)
    return [g, w.grad is None]


def s_unused_allowed(P):
    x, w = _t(P, [1.0], True), _t(P, [2.0], True)
    (g,) = P.grad((x * x).sum(), [w], allow_unused=True)
    return g is None


def s_grad_wrt_seed(P):
    x, v = _t(P, [1.0, 2.0], True), _t(P, [1.0, 1.0], True)
    (g,) = P.grad(x * x * x, x, grad_outputs=v, create_graph=True)
    (gv,) = P.grad(g.sum(), v)
    return gv


def s_wgan_gp(P):
    rng = np.random.RandomState(3)
    ws = [(rng.randn(*s) * 0.5).astype(np.float32)
          for s in ((4, 8), (8,), (8, 1), (1,))]

    def attr(w):
        return P.ParamAttr(initializer=P.nn.initializer.Assign(w))
    critic = P.nn.Sequential(
        P.nn.Linear(4, 8, weight_attr=attr(ws[0]), bias_attr=attr(ws[1])),
        P.nn.Tanh(),
        P.nn.Linear(8, 1, weight_attr=attr(ws[2]), bias_attr=attr(ws[3])))
    x = P.to_tensor(f32(6, 4), stop_gradient=False)
    (gx,) = P.grad(critic(x).sum(), x, create_graph=True)
    norm = (gx * gx).sum(axis=1).sqrt()
    penalty = ((norm - 1.0) ** 2).mean()
    penalty.backward()
    # the last bias does not reach the penalty: the reference's tape gives
    # it a zero grad, torch's engine leaves it None (a deliberate
    # difference, checked in test_unreached_parameter_grad_is_none)
    return [penalty] + [np.zeros(p.shape, np.float32) if p.grad is None
                        else p.grad for p in critic.parameters()]


def s_hessian_via_tape(P):
    x = _t(P, [0.3, -0.7], True)
    y = (P.sin(x) * x * x).sum()
    (g,) = P.grad(y, x, create_graph=True)
    rows = [P.grad(g[i], x, retain_graph=True)[0] for i in range(2)]
    return rows


# -- functional (tests/test_autograd_functional.py) ---------------------------

def s_jacobian_square(P):
    return P.autograd.jacobian(lambda v: v * v, _t(P, [1.0, 2.0, 3.0]))


def s_jacobian_fwd(P):
    A = np.random.RandomState(0).rand(3, 2).astype(np.float32)
    x = _t(P, np.random.RandomState(1).rand(2))
    return P.autograd.jacobian(lambda v: P.matmul(P.to_tensor(A), v), x,
                               mode="fwd")


def s_jacobian_multi_input(P):
    J = P.autograd.jacobian(lambda a, b: a * b,
                            (_t(P, [1.0, 2.0]), _t(P, [3.0, 4.0])))
    return list(J)


def s_jacobian_multi_output(P):
    J = P.autograd.jacobian(lambda v: (v * 2.0, (v * v).sum()),
                            _t(P, [1.0, 2.0]))
    return list(J)


def s_hessian_cubic(P):
    return P.autograd.hessian(lambda v: (v ** 3.0).sum(), _t(P, [1.0, 2.0]))


def s_hessian_quadratic(P):
    A = np.array([[2.0, 1.0], [1.0, 3.0]], np.float32)
    return P.autograd.hessian(
        lambda v: 0.5 * P.matmul(v.reshape([1, 2]), P.matmul(
            P.to_tensor(A), v.reshape([2, 1]))).sum(), _t(P, [1.0, -1.0]))


def s_jvp_vjp(P):
    x, v = _t(P, [0.5, 1.5, 2.5]), _t(P, [1.0, 0.0, 2.0])
    out, jv = P.autograd.jvp(lambda a: P.exp(a), x, v)
    out2, g = P.autograd.vjp(lambda a: P.sum(P.exp(a)), x)
    return [out, jv, out2, g]


def s_vjp_multi_input(P):
    out, g = P.autograd.vjp(lambda a, b: a * b + b,
                            (_t(P, [1.0, 2.0]), _t(P, [3.0, 4.0])),
                            _t(P, [1.0, -1.0]))
    return [out, list(g)]


def s_vhp(P):
    out, hv = P.autograd.vhp(lambda v: (v ** 3.0).sum(), _t(P, [1.0, 2.0]),
                             _t(P, [1.0, 1.0]))
    return [out, hv]


SCENARIOS = {f.__name__[2:]: f for f in (
    s_chain, s_fan_out, s_accumulates, s_stop_gradient_cuts, s_grad_tensor,
    s_no_grad, s_split_grad, s_broadcast_grad, s_retain_graph,
    s_paddle_grad, s_grad_keeps_existing, s_hook_scales, s_hook_remove,
    s_setitem, s_hook_once, s_nonleaf_hook, s_numpy_scalar_left,
    s_double_poly, s_double_transcendental, s_second_grad_matmul, s_triple,
    s_create_graph_false, s_grad_outputs, s_backward_create_graph,
    s_grad_nonleaf, s_grad_other_leaves, s_unused_allowed, s_grad_wrt_seed,
    s_wgan_gp, s_hessian_via_tape, s_jacobian_square, s_jacobian_fwd,
    s_jacobian_multi_input, s_jacobian_multi_output, s_hessian_cubic,
    s_hessian_quadratic, s_jvp_vjp, s_vjp_multi_input, s_vhp)}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_matches_reference(name):
    assert_both(SCENARIOS[name], **TOL)


@pytest.mark.parametrize("P", [paddle_tpu, paddle_tpu_torch],
                         ids=["reference", "port"])
def test_non_scalar_backward_needs_grad_tensor(P):
    paddle_tpu_torch.set_device("cpu")
    x = _t(P, [1.0, 2.0], True)
    with pytest.raises(RuntimeError):
        (x * 2.0).backward()


@pytest.mark.parametrize("P", [paddle_tpu, paddle_tpu_torch],
                         ids=["reference", "port"])
def test_unused_input_raises_without_allow_unused(P):
    paddle_tpu_torch.set_device("cpu")
    x, w = _t(P, [1.0], True), _t(P, [2.0], True)
    with pytest.raises(ValueError):
        P.grad((x * x).sum(), [w], allow_unused=False)


@pytest.mark.parametrize("P", [paddle_tpu, paddle_tpu_torch],
                         ids=["reference", "port"])
def test_set_grad_enabled_as_call_and_context(P):
    paddle_tpu_torch.set_device("cpu")
    x = _t(P, [1.0], True)
    with P.set_grad_enabled(False):
        assert (x * 2.0).stop_gradient
    assert not (x * 2.0).stop_gradient
    P.set_grad_enabled(False)
    try:
        assert (x * 2.0).stop_gradient
        assert not P.is_grad_enabled()
    finally:
        P.set_grad_enabled(True)
    with P.no_grad():
        with P.enable_grad():
            assert not (x * 2.0).stop_gradient


def test_grad_mode_is_thread_local():
    import threading
    paddle_tpu_torch.set_device("cpu")
    seen = []
    with paddle_tpu_torch.no_grad():
        t = threading.Thread(
            target=lambda: seen.append(paddle_tpu_torch.is_grad_enabled()))
        t.start()
        t.join()
        assert not paddle_tpu_torch.is_grad_enabled()
    assert seen == [True]


def test_grad_results_are_tensors_and_leave_grads_alone():
    P = paddle_tpu_torch
    P.set_device("cpu")
    x = _t(P, [3.0], True)
    (x * 5.0).sum().backward()
    g0 = x.grad.numpy().copy()
    (g,) = P.grad((x * x).sum(), [x])
    assert isinstance(g, P.Tensor) and g.shape == [1]
    np.testing.assert_array_equal(x.grad.numpy(), g0)


def test_unreached_parameter_grad_is_none():
    """A parameter that the differentiated output does not reach keeps
    ``grad`` None in the port (torch's engine), where the reference's tape
    writes zeros: the WGAN-GP penalty does not reach the critic's last
    bias."""
    P = paddle_tpu_torch
    P.set_device("cpu")
    lin = P.nn.Linear(8, 1)
    x = P.to_tensor(f32(6, 8), stop_gradient=False)
    (gx,) = P.grad(lin(x).sum(), x, create_graph=True)
    (gx * gx).sum().backward()
    assert lin.bias.grad is None and lin.weight.grad is not None
