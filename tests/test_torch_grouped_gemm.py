"""The port's grouped GEMM against the JAX package's, at a small size.

Inputs are numpy arrays from a seed, handed to both packages. The JAX side
runs its Pallas kernel (``grouped_matmul(..., use_pallas=True)``, in
interpret mode on the CPU) and its dense ``gmm_reference``; the port's
``grouped_matmul`` takes its plain version for CPU tensors. Held to the
reference:

- forward, float32: atol 1e-5 (both sum in float32, in another order);
- forward, bf16: within one bf16 ulp of the reference's value (both round
  a float32 sum once);
- rows at or past ``counts[g]`` are exactly zero, groups per expert 1 and
  2, counts with empty, partial and full groups, and ``counts=None``;
- ``dx`` and ``dw`` against ``jax.grad`` of the same loss, float32, atol
  1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.kernels.pallas import grouped_gemm as jgg
from paddle_tpu_torch.ops.kernels import grouped_gemm as tgg
from paddle_tpu_torch.ops.kernels import moe as tmoe

G, C, K, N = 8, 12, 20, 36
COUNTS = {"mixed": [0, 3, 12, 7, 1, 12, 0, 5], "full": [C] * G,
          "empty": [0] * G}


def _rand(*shape, seed=0, scale=0.1):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _inputs(gpe, dtype, seed=0):
    x = _rand(G, C, K, seed=seed, scale=1.0)
    w = _rand(G // gpe, K, N, seed=seed + 1)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    return (jnp.asarray(x, jdt), jnp.asarray(w, jdt),
            torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt))


def _np(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def _within_one_bf16_ulp(got, want):
    """|got - want| <= one bf16 ulp of the larger magnitude."""
    mag = np.maximum(np.abs(got), np.abs(want))
    ulp = np.where(mag > 0, 2.0 ** (np.floor(np.log2(np.maximum(
        mag, 1e-38))) - 7), 0.0)
    return bool((np.abs(got - want) <= ulp).all())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("gpe", [1, 2])
@pytest.mark.parametrize("counts", ["mixed", "full", "empty", None])
def test_forward_matches_pallas_and_reference(counts, gpe, dtype):
    jx, jw, tx, tw = _inputs(gpe, dtype, seed=gpe)
    jc = None if counts is None else jnp.asarray(COUNTS[counts], jnp.int32)
    tc = None if counts is None else torch.tensor(COUNTS[counts],
                                                  dtype=torch.int32)
    got = tgg.grouped_matmul(tx, tw, tc, gpe).float().numpy()
    want = _np(jgg.grouped_matmul(jx, jw, jc, gpe, use_pallas=True))
    ref = _np(jgg.gmm_reference(
        jx, jw, jnp.full((G,), C, jnp.int32) if jc is None else jc, gpe))
    assert tgg.grouped_matmul(tx, tw, tc, gpe).dtype == tx.dtype
    for target in (want, ref):
        if dtype == "float32":
            np.testing.assert_allclose(got, target, atol=1e-5, rtol=0)
        else:
            assert _within_one_bf16_ulp(got, target)
    live = np.arange(C)[None, :] < np.asarray(
        COUNTS[counts] if counts else [C] * G)[:, None]
    assert (got[~live] == 0).all(), "rows past counts must be exact zeros"


def test_plain_route_and_op_entry_match_the_reference():
    jx, jw, tx, tw = _inputs(2, "float32", seed=3)
    c = COUNTS["mixed"]
    want = _np(jgg.gmm_reference(jx, jw, jnp.asarray(c, jnp.int32), 2))
    tc = torch.tensor(c, dtype=torch.int32)
    for got in (tgg.grouped_matmul(tx, tw, tc, 2, use_pallas=False),
                tgg.gmm_plain(tx, tw, tc, 2),
                tmoe.grouped_gemm(tx, tw, tc.long(), groups_per_expert=2)):
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_transposed_weight_view_needs_no_copy():
    """dx's product reads w^T as a strided view: the same values as the
    reference on a swapped copy."""
    _, jw, _, tw = _inputs(1, "float32", seed=4)
    dy = _rand(G, C, N, seed=5, scale=1.0)
    c = COUNTS["mixed"]
    wt = tw.transpose(1, 2)
    assert not wt.is_contiguous()
    got = tgg.grouped_matmul(torch.from_numpy(dy), wt,
                             torch.tensor(c, dtype=torch.int32))
    want = _np(jgg.grouped_matmul(jnp.asarray(dy), jnp.swapaxes(jw, 1, 2),
                                  jnp.asarray(c, jnp.int32), 1,
                                  use_pallas=True))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("use_pallas", [None, False])
@pytest.mark.parametrize("gpe", [1, 2])
def test_dx_and_dw_match_jax_grad(gpe, use_pallas):
    jx, jw, tx, tw = _inputs(gpe, "float32", seed=6 + gpe)
    ct = _rand(G, C, N, seed=9, scale=1.0)
    c = COUNTS["mixed"]
    jc = jnp.asarray(c, jnp.int32)
    jdx, jdw = jax.grad(
        lambda x, w: (jgg.grouped_matmul(x, w, jc, gpe, use_pallas=True)
                      * ct).sum(), argnums=(0, 1))(jx, jw)
    tx.requires_grad_()
    tw.requires_grad_()
    y = tgg.grouped_matmul(tx, tw, torch.tensor(c, dtype=torch.int32), gpe,
                           use_pallas)
    (y * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), _np(jdx), atol=1e-5, rtol=0)
    np.testing.assert_allclose(tw.grad.numpy(), _np(jdw), atol=1e-5, rtol=0)
    dead = np.arange(C)[None, :] >= np.asarray(c)[:, None]
    assert (tx.grad.numpy()[dead] == 0).all()


def test_bf16_grads_keep_dtypes_and_track_float32():
    _, _, tx, tw = _inputs(2, "bfloat16", seed=11)
    tx.requires_grad_()
    tw.requires_grad_()
    c = torch.tensor(COUNTS["mixed"], dtype=torch.int32)
    ct = torch.from_numpy(_rand(G, C, N, seed=12, scale=1.0))
    (tgg.grouped_matmul(tx, tw, c, 2).float() * ct).sum().backward()
    assert tx.grad.dtype == torch.bfloat16 and tw.grad.dtype == torch.bfloat16
    want = tgg.grad_w(tx.detach().float(), ct.bfloat16().float(), c, 2,
                      torch.float32)
    assert _within_one_bf16_ulp(tw.grad.float().numpy(), want.numpy())


def test_wrapper_refuses_a_device_without_a_kernel():
    x = torch.empty((G, C, K), device="meta")
    w = torch.empty((G, K, N), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tgg.grouped_matmul(x, w)
