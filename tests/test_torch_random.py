"""The port's random ops against the JAX package's, and fault C7.

The bits cannot match JAX's threefry streams, so each random op is held to
the reference as the initializers are (``tests/test_torch_nn_layers.py``):

- by shape, dtype kind and support, against the reference op's output on
  the same arguments;
- by moments: on 2^18 draws (2^14 for the costlier ones) the sample mean
  and standard deviation of both packages lie within the stated limits of
  the distribution's own (each limit at least 6 standard errors);
- by reproducibility: the same ``paddle.seed`` gives the same bytes, the
  next draw other bytes;
- by ``get_rng_state`` / ``set_rng_state`` round trips;
- by independence from torch's global generator: ``torch.manual_seed``
  between two seeded draws changes nothing.

C7: ``paddle_tpu_torch.seed(s)`` seeds numpy's global generator too, as
the reference's ``paddle.seed`` does, so a ``shuffle=True`` DataLoader
after ``seed(7)`` gives the reference's order, and gives it every time.
"""

import math

import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu_torch
from _torch_both import run_both, to_numpy

N = 1 << 18


def _dataset(P, n=8):
    class DS(P.io.Dataset):
        def __len__(self):
            return n

        def __getitem__(self, i):
            return np.array([i], np.int64)
    return DS()


def _epoch_order(P):
    kw = {"places": "cpu"} if P is paddle_tpu_torch else {}
    loader = P.io.DataLoader(_dataset(P), batch_size=1, shuffle=True, **kw)
    return [int(np.asarray(to_numpy(b[0] if isinstance(b, (list, tuple))
                                    else b)).ravel()[0]) for b in loader]


def test_c7_seed_fixes_the_shuffled_loader_order():
    orders = {}
    for P in (paddle_tpu, paddle_tpu_torch):
        runs = []
        for _ in range(2):
            P.seed(7)
            runs.append(_epoch_order(P))
        assert runs[0] == runs[1], (P.__name__, runs)
        orders[P.__name__] = runs[0]
    assert orders["paddle_tpu_torch"] == orders["paddle_tpu"]
    assert sorted(orders["paddle_tpu"]) == list(range(8))


# name -> (draw(P), (mean, std) of the distribution, support (lo, hi))
U = 1.0 / math.sqrt(12.0)
DRAWS = {
    "rand": (lambda P: P.rand([N]), (0.5, U), (0.0, 1.0)),
    "uniform": (lambda P: P.uniform([N], min=-2.0, max=3.0),
                (0.5, 5 * U), (-2.0, 3.0)),
    "randn": (lambda P: P.randn([N]), (0.0, 1.0), None),
    "gaussian": (lambda P: P.gaussian([N], mean=1.5, std=0.5),
                 (1.5, 0.5), None),
    "normal": (lambda P: P.normal(1.5, 0.5, [N]), (1.5, 0.5), None),
    "standard_normal": (lambda P: P.standard_normal([N]), (0.0, 1.0), None),
    "randint": (lambda P: P.randint(0, 10, [N]),
                (4.5, math.sqrt(99 / 12)), (0, 9)),
    "randint_like": (lambda P: P.randint_like(P.zeros([N], "int64"), 3, 7),
                     (4.5, math.sqrt(15 / 12)), (3, 6)),
    "randperm": (lambda P: P.randperm(1000).astype("float32"),
                 (499.5, math.sqrt((1000 ** 2 - 1) / 12)), (0, 999)),
    "bernoulli": (lambda P: P.bernoulli(P.full([N], 0.3)),
                  (0.3, math.sqrt(0.21)), (0.0, 1.0)),
    "multinomial": (lambda P: P.multinomial(
        P.to_tensor(np.array([0.1, 0.2, 0.7], np.float32)), 1 << 14,
        replacement=True).astype("float32"),
        (1.6, math.sqrt(0.2 + 0.7 * 4 - 1.6 ** 2)), (0, 2)),
    "normal_like": (lambda P: P.normal_like(P.zeros([N]), 2.0, 3.0),
                    (2.0, 3.0), None),
    "uniform_like": (lambda P: P.uniform_like(P.zeros([N]), 0.0, 2.0),
                     (1.0, 2 * U), (0.0, 2.0)),
    "exponential": (lambda P: P.exponential(P.zeros([N]), 2.0),
                    (0.5, 0.5), (0.0, None)),
    "geometric_like": (lambda P: P.geometric_like(P.zeros([N]), 0.5),
                       (1 / math.log(2), 1 / math.log(2)), (0.0, None)),
    "poisson": (lambda P: _threefry(P, lambda: P.poisson(P.full([N], 4.0))),
                (4.0, 2.0), (0.0, None)),
    "standard_gamma": (lambda P: P.standard_gamma(P.full([1 << 14], 3.0)),
                       (3.0, math.sqrt(3.0)), (0.0, None)),
    "binomial": (lambda P: P.binomial(P.full([1 << 14], 10.0),
                                      P.full([1 << 14], 0.3))
                 .astype("float32"), (3.0, math.sqrt(2.1)), (0, 10)),
    "truncated_gaussian_random": (
        lambda P: P.truncated_gaussian_random([N], mean=1.0, std=2.0),
        (1.0, 2.0 * 0.8796), (-3.0, 5.0)),
    "dirichlet": (lambda P: P.dirichlet(P.full([1 << 14, 4], 2.0))[:, 0],
                  (0.25, math.sqrt(0.25 * 0.75 / 9)), (0.0, 1.0)),
    "rrelu": (lambda P: P.rrelu(P.full([N], -1.0), 0.1, 0.3),
              (-0.2, 0.2 * U), (-0.3, -0.1)),
    "uniform_random_batch_size_like": (
        lambda P: P.uniform_random_batch_size_like(P.zeros([N, 2]), [1, 1])
        [:, 0], (0.0, 2 * U), (-1.0, 1.0)),
}
LIMIT = 6.0      # standard errors


def _threefry(P, draw):
    """The reference's ``poisson`` runs only on threefry keys, not its
    default ``FLAGS_rng_impl=rbg``: draw it under threefry."""
    if P is not paddle_tpu:
        return draw()
    P.set_flags({"FLAGS_rng_impl": "threefry2x32"})
    try:
        P.seed(0)
        return draw()
    finally:
        P.set_flags({"FLAGS_rng_impl": "rbg"})


def _stats(a):
    a = np.asarray(a, np.float64).ravel()
    return a.size, float(a.mean()), float(a.std())


@pytest.mark.parametrize("name", sorted(DRAWS))
def test_draws_match_the_reference_by_shape_support_and_moments(name):
    draw, (mu, sd), support = DRAWS[name]
    ref, port = run_both(draw)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    assert port.dtype.kind == ref.dtype.kind or {port.dtype.kind,
                                                 ref.dtype.kind} <= {"i", "u"}
    for got in (ref, port):
        n, m, s = _stats(got)
        se_mean = sd / math.sqrt(n)
        se_std = sd / math.sqrt(2 * n)
        assert abs(m - mu) < LIMIT * se_mean + 1e-6, (name, m, mu)
        # the std of a capped or discrete law is within 5% of its own
        assert abs(s - sd) < LIMIT * se_std + 0.05 * sd, (name, s, sd)
        if support is not None:
            lo, hi = support
            assert got.min() >= lo - 1e-6
            if hi is not None:
                assert got.max() <= hi + 1e-6


def test_randperm_shuffle_and_shuffle_batch_are_permutations():
    P = paddle_tpu_torch
    P.set_device("cpu")
    P.seed(1)
    assert sorted(P.randperm(50).tolist()) == list(range(50))
    x = P.to_tensor(np.arange(24, dtype=np.float32).reshape(6, 4))
    s = P.shuffle(x, axis=1)
    assert sorted(s.numpy()[0].tolist()) == [0.0, 1.0, 2.0, 3.0]
    out, idx = P.shuffle_batch(x)
    np.testing.assert_array_equal(out.numpy(), x.numpy()[idx.numpy()])
    assert idx.dtype == torch.int64


def test_multinomial_without_replacement_draws_distinct():
    P = paddle_tpu_torch
    P.set_device("cpu")
    w = P.to_tensor(np.ones((64, 10), np.float32))
    out = P.multinomial(w, 10).numpy()
    assert all(sorted(r) == list(range(10)) for r in out.tolist())


def test_pca_lowrank_recovers_the_reference_singular_values():
    """Exact for a rank-3 matrix with q = 3: U S V^T reproduces it and S
    equals the reference's (atol 1e-4)."""
    rng = np.random.RandomState(0)
    a = (rng.randn(20, 3) @ rng.randn(3, 8)).astype(np.float32)
    ref, port = run_both(lambda P: P.pca_lowrank(P.to_tensor(a), q=3,
                                                 center=False))
    np.testing.assert_allclose(port[1], ref[1], atol=1e-4, rtol=1e-5)
    u, s, v = port
    np.testing.assert_allclose(u @ np.diag(s) @ v.T, a, atol=1e-4)


def test_fused_dropout_add_matches_its_definition():
    P = paddle_tpu_torch
    P.set_device("cpu")
    x = P.to_tensor(np.ones((4, 1000), np.float32))
    y = P.to_tensor(np.full((4, 1000), 2.0, np.float32))
    out = P.fused_dropout_add(x, y, p=0.25).numpy()
    assert np.all(np.isclose(out, 2.0) | np.isclose(out, 2.0 + 1 / 0.75))
    assert abs((out > 2.5).mean() - 0.75) < 0.02
    np.testing.assert_array_equal(
        P.fused_dropout_add(x, y, p=0.25, training=False).numpy(), 3.0)


SEEDED = {
    "rand": lambda P: P.rand([257]),
    "randn": lambda P: P.randn([3, 5], dtype="float64"),
    "randint": lambda P: P.randint(-5, 5, [100]),
    "randperm": lambda P: P.randperm(64),
    "bernoulli": lambda P: P.bernoulli(P.full([100], 0.5)),
    "multinomial": lambda P: P.multinomial(P.ones([4, 6]), 3),
    "uniform_": lambda P: P.zeros([50]).uniform_(-1.0, 1.0),
    "normal_": lambda P: P.zeros([50]).normal_(),
    "exponential_": lambda P: P.zeros([50]).exponential_(),
    "cauchy_": lambda P: P.cauchy_(P.zeros([50])),
    "dropout": lambda P: P.dropout(P.ones([100]), 0.5),
}


@pytest.mark.parametrize("name", sorted(SEEDED))
def test_same_seed_same_bytes_and_torch_global_seed_changes_nothing(name):
    P = paddle_tpu_torch
    P.set_device("cpu")
    draw = SEEDED[name]
    P.seed(11)
    a, a2 = draw(P).numpy(), draw(P).numpy()
    P.seed(11)
    torch.manual_seed(12345)
    b = draw(P).numpy()
    torch.manual_seed(999)
    b2 = draw(P).numpy()
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(a2, b2)
    assert not np.array_equal(a, a2)


def test_rng_state_round_trip():
    P = paddle_tpu_torch
    P.set_device("cpu")
    P.seed(3)
    P.rand([10])
    state = P.get_rng_state()
    a = P.randn([20]).numpy()
    P.randn([5])
    P.set_rng_state(state)
    np.testing.assert_array_equal(P.randn([20]).numpy(), a)
    with pytest.raises(ValueError):
        P.set_rng_state(state * 2)
    assert P.get_cuda_rng_state() == [] or torch.cuda.is_available()


def test_explicit_generator_wins_over_the_port_generator():
    from paddle_tpu_torch.ops.kernels import random as R
    paddle_tpu_torch.set_device("cpu")
    g1 = torch.Generator().manual_seed(5)
    g2 = torch.Generator().manual_seed(5)
    paddle_tpu_torch.seed(0)
    a = R.uniform([16], generator=g1)
    paddle_tpu_torch.seed(1)
    b = R.uniform([16], generator=g2)
    assert torch.equal(a, b)


def test_creation_and_random_ops_follow_set_device():
    P = paddle_tpu_torch
    P.set_device("cpu")
    for t in (P.rand([2]), P.randint(0, 3, [2]), P.zeros([2]),
              P.to_tensor([1.0])):
        assert t.place == P.CPUPlace() and isinstance(t, P.Tensor)
    if not torch.cuda.is_available():
        P.set_device(None)
        try:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                P.rand([2])
            with pytest.raises(RuntimeError, match="no CUDA device"):
                P.to_tensor([1.0])
        finally:
            P.set_device("cpu")
