"""The port's flash attention against the JAX package's Pallas kernel.

Same inputs (numpy, seeded) through ``paddle_tpu``'s
``pallas/flash_attention.py`` (Pallas in interpret mode on the CPU, at
sequence lengths where ``fa.supported`` holds, so the kernel path runs)
and through the port's ``flash_attention`` / ``flash_block`` (their plain
versions on a CPU tensor), forward and gradients (``jax.grad`` /
``jax.vjp`` against ``torch.autograd``).

Tolerances: float32 outputs and lse atol 2e-5 (both sum in float32, the
Pallas kernel block by block with an online softmax, the port's plain
version in one softmax); float32 grads max error relative to the tensor's
max 2e-5. bfloat16: inputs rounded identically, both accumulate in float32
and round the result once, so outputs differ by at most one bf16 ulp
(rtol 2^-7, atol 1e-3 near 0) and grads by 1e-2 of the tensor's max.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.kernels import nn as jnn
from paddle_tpu.ops.kernels.pallas import flash_attention as jfa
from paddle_tpu_torch.ops.kernels import flash_attention as tfa
from paddle_tpu_torch.ops.kernels import nn as tnn

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
OUT_TOL = {"f32": dict(atol=2e-5, rtol=1e-5),
           "bf16": dict(atol=1e-3, rtol=2 ** -7)}
GRAD_TOL = {"f32": 2e-5, "bf16": 1e-2}


def _inputs(seed, b, sq, sk, h, kv, d):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, s, n, d).astype(np.float32)
            for s, n in ((sq, h), (sk, kv), (sk, kv), (sq, h))]


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _jax(q, k, v, w, causal, jdt):
    args = [jnp.asarray(x, jdt) for x in (q, k, v)]
    wj = jnp.asarray(w, jnp.float32)
    out = jfa.flash_attention(*args, causal=causal)
    grads = jax.grad(lambda a, b_, c: jnp.sum(
        jfa.flash_attention(a, b_, c, causal=causal).astype(jnp.float32)
        * wj), argnums=(0, 1, 2))(*args)
    f32 = lambda x: np.asarray(jnp.asarray(x, jnp.float32))  # noqa: E731
    return f32(out), [f32(g) for g in grads]


def _port(q, k, v, w, causal, tdt):
    args = [torch.from_numpy(x).to(tdt).requires_grad_() for x in (q, k, v)]
    out = tfa.flash_attention(*args, causal=causal)
    (out.float() * torch.from_numpy(w)).sum().backward()
    return (out.detach().float().numpy(),
            [a.grad.float().numpy() for a in args])


CASES = [  # (b, sq, sk, h, kv, d, causal)
    (1, 128, 128, 4, 4, 32, True),      # G 1
    (2, 128, 128, 4, 2, 32, True),      # G 2
    (1, 256, 256, 8, 2, 64, True),      # G 4, two 128-blocks
    (1, 128, 128, 8, 2, 64, False),
    (1, 128, 256, 4, 1, 32, True),      # causal sq < sk (right-aligned)
    (1, 256, 128, 4, 2, 32, False),     # non-causal sq > sk
]


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("case", CASES, ids=lambda c: "b{}-q{}-k{}-h{}-kv{}"
                         "-d{}-{}".format(*c[:6], "causal" if c[6]
                                          else "full"))
def test_forward_and_grads_match_pallas(case, dt):
    b, sq, sk, h, kv, d, causal = case
    assert jfa.supported((b, sq, h, d), (b, sk, kv, d), causal)
    q, k, v, w = _inputs(sq + h + kv, b, sq, sk, h, kv, d)
    jdt, tdt = DTYPES[dt]
    want, want_g = _jax(q, k, v, w, causal, jdt)
    got, got_g = _port(q, k, v, w, causal, tdt)
    np.testing.assert_allclose(got, want, **OUT_TOL[dt])
    for name, a, r in zip("qkv", got_g, want_g):
        assert _rel(a, r) < GRAD_TOL[dt], (name, _rel(a, r))


@pytest.mark.parametrize("causal", [True, False])
def test_flash_block_with_lse_cotangent_matches_pallas_vjp(causal):
    rng = np.random.RandomState(5)
    q = rng.randn(8, 128, 32).astype(np.float32)      # bh = 2 x 4 heads
    k = rng.randn(4, 128, 32).astype(np.float32)      # bh_kv = 2 x 2
    v = rng.randn(4, 128, 32).astype(np.float32)
    w_o = rng.randn(8, 128, 32).astype(np.float32)
    w_l = rng.randn(8, 128).astype(np.float32)        # nonzero dlse
    scale = 32 ** -0.5
    (jo, jl), vjp = jax.vjp(lambda a, b_, c: jfa.flash_block(
        a, b_, c, causal, scale), *map(jnp.asarray, (q, k, v)))
    jg = vjp((jnp.asarray(w_o), jnp.asarray(w_l)))
    args = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    to, tl = tfa.flash_block(*args, causal, scale)
    ((to * torch.from_numpy(w_o)).sum()
     + (tl * torch.from_numpy(w_l)).sum()).backward()
    np.testing.assert_allclose(to.detach().numpy(), np.asarray(jo),
                               **OUT_TOL["f32"])
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl),
                               **OUT_TOL["f32"])
    for a, r in zip(args, jg):
        assert _rel(a.grad.numpy(), r) < GRAD_TOL["f32"]


def test_lse_cotangent_moves_the_grads():
    # the dlse term is live: dropping it changes dq by far more than the
    # tolerance above
    rng = np.random.RandomState(6)
    q, k, v = (torch.from_numpy(rng.randn(4, 64, 16).astype(np.float32))
               .requires_grad_() for _ in range(3))
    w_l = torch.from_numpy(rng.randn(4, 64).astype(np.float32))
    out, lse = tfa.flash_block(q, k, v, True, 0.25)
    with_l, = torch.autograd.grad(out.sum() + (lse * w_l).sum(), q)
    out, lse = tfa.flash_block(q, k, v, True, 0.25)
    without, = torch.autograd.grad(out.sum(), q)
    assert _rel(with_l.numpy(), without.numpy()) > 1e-2


class TestRouting:
    """``ops/kernels/nn.flash_attention``: no mask and no dropout take the
    flash path; a mask, dropout or causal ``sq > sk`` take the composite,
    as the reference routes them."""

    def _count(self, monkeypatch):
        calls = []
        real = tnn._fa.flash_attention
        monkeypatch.setattr(tnn._fa, "flash_attention",
                            lambda *a, **kw: calls.append(1) or real(*a, **kw))
        return calls

    def _qkv(self, sq=16, sk=16):
        rng = np.random.RandomState(7)
        return [rng.randn(2, s, n, 8).astype(np.float32)
                for s, n in ((sq, 4), (sk, 2), (sk, 2))]

    def test_plain_case_takes_flash(self, monkeypatch):
        calls = self._count(monkeypatch)
        q, k, v = self._qkv()
        got = tnn.flash_attention(*map(torch.from_numpy, (q, k, v)),
                                  is_causal=True)
        assert calls == [1]
        want = jnn.flash_attention(*map(jnp.asarray, (q, k, v)),
                                   is_causal=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6)

    @pytest.mark.parametrize("kind", ["bool_mask", "float_mask", "dropout",
                                      "causal_sq_gt_sk"])
    def test_composite_cases(self, monkeypatch, kind):
        calls = self._count(monkeypatch)
        sq, sk = (16, 8) if kind == "causal_sq_gt_sk" else (16, 16)
        q, k, v = self._qkv(sq, sk)
        rng = np.random.RandomState(8)
        mask = None
        if kind == "bool_mask":
            mask = rng.rand(2, 1, sq, sk) > 0.3
            mask[..., 0] = True
        elif kind == "float_mask":
            mask = rng.randn(2, 1, sq, sk).astype(np.float32)
        kw = dict(is_causal=kind != "float_mask")
        t_kw = dict(kw, attn_mask=None if mask is None
                    else torch.from_numpy(mask))
        j_kw = dict(kw, attn_mask=None if mask is None else jnp.asarray(mask))
        if kind == "dropout":
            # the port drops from its generator (the reference's op draws
            # a fresh key); its mask is replayed below
            from paddle_tpu_torch.nn.initializer import seed
            seed(5)
            t_kw["dropout_p"] = 0.5
        got = tnn.flash_attention(*map(torch.from_numpy, (q, k, v)), **t_kw)
        assert calls == []
        want = jnn.flash_attention(*map(jnp.asarray, (q, k, v)), **j_kw)
        if kind == "dropout":
            want = self._dropped(q, k, v, np.asarray(want))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6,
                                   equal_nan=True)

    @staticmethod
    def _dropped(q, k, v, want0):
        """The causal composite with the mask the port's generator drew
        (seed 5), its probabilities held to the reference's output
        without dropout first."""
        from paddle_tpu_torch.nn.initializer import default_generator, seed
        qt, kt, vt = (torch.from_numpy(a).transpose(1, 2) for a in (q, k, v))
        kt, vt = (t.repeat_interleave(2, dim=1) for t in (kt, vt))
        logits = qt @ kt.transpose(-1, -2) * q.shape[-1] ** -0.5
        causal = torch.ones(logits.shape[-2:], dtype=torch.bool).tril()
        probs = torch.softmax(logits.masked_fill(~causal, float("-inf")), -1)
        np.testing.assert_allclose((probs @ vt).transpose(1, 2).numpy(),
                                   want0, atol=2e-6)
        seed(5)
        keep = torch.rand(probs.shape, generator=default_generator("cpu")) \
            < 0.5
        return (torch.where(keep, probs / 0.5, 0.0) @ vt).transpose(1, 2) \
            .numpy()

    @pytest.mark.parametrize("q_shape,k_shape,causal,want", [
        ((2, 16, 4, 96), (2, 16, 2, 96), True, True),    # any head_dim
        ((2, 16, 4, 8), (2, 32, 2, 8), True, True),      # causal sq < sk
        ((2, 16, 4, 8), (2, 8, 2, 8), False, True),      # non-causal sq > sk
        ((2, 16, 4, 8), (2, 8, 2, 8), True, False),      # causal sq > sk
        ((2, 16, 4, 8), (2, 16, 3, 8), False, False),    # heads do not divide
    ])
    def test_supported_decides_by_shape_only(self, q_shape, k_shape, causal,
                                             want):
        assert tfa.supported(q_shape, k_shape, causal) is want

    def test_dropout_with_generator_drops(self):
        q, k, v = map(torch.from_numpy, self._qkv())
        full = tnn.scaled_dot_product_attention(q, k, v, is_causal=True)
        g = torch.Generator().manual_seed(0)
        dropped = tnn.flash_attention(q, k, v, dropout_p=0.5,
                                      is_causal=True, generator=g)
        assert not torch.allclose(full, dropped)
