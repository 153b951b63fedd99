"""The port's block-CSR SpMM against the JAX package's.

The same dense matrices and right-hand sides (numpy, seeded) go through
``paddle_tpu.ops.kernels.pallas.bcsr_spmm`` (its Pallas kernel in
interpret mode on the CPU, as ``tests/test_sparse.py`` runs it) and
``paddle_tpu.sparse``, and through the port's ``ops/kernels/bcsr_spmm.py``
and ``sparse`` (on a CPU tensor, the kernel's plain version).

Held to the reference:

- ``bcsr_from_dense``: crows, cols and values equal, with ``tol`` 0 and
  above 0 (blocks whose largest magnitude is at most ``tol`` dropped);
- ``bcsr_matmul`` / ``bcsr_spmm``: float32 within atol 1e-4 (as
  ``tests/test_sparse.py``: both sum in float32, in another order); bf16
  within 1e-2 of the output's largest magnitude (both round a float32 sum
  once to bf16, so they differ by at most one bf16 ulp, 2^-8 of it);
- the reference's three cases (an empty block row gives exact zeros, the
  public API against the dense product, an empty matrix with ``NB = 0``),
  N not a multiple of 128, and ``bm = 16, bk = 128``;
- ``bcsr_spmm_reference`` (the dense-reconstruction golden) against the
  reference's.

Held within the port: the host checks of the block structure refuse a
``crows`` that falls or ends off ``NB`` and a column id out of range; a
CUDA entry point needs ``device="cpu"`` on a machine without a card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.sparse as jsparse
from paddle_tpu.ops.kernels.pallas import bcsr_spmm as jb
from paddle_tpu_torch import sparse as tsparse
from paddle_tpu_torch.ops.kernels import bcsr_spmm as tb


def _pruned(seed, M, K, bm, bk, keep=0.5, empty_rows=(), tiny=None):
    """A dense [M, K] float32 matrix with about ``keep`` of its bm x bk
    blocks left, the block rows in ``empty_rows`` empty, and the blocks in
    ``tiny`` scaled down to 1e-3 (dropped by a tol above that)."""
    rs = np.random.RandomState(seed)
    d = rs.randn(M, K).astype(np.float32)
    mask = rs.rand(M // bm, K // bk) < keep
    for r in empty_rows:
        mask[r] = False
    scale = mask.astype(np.float32)
    for r, c in tiny or ():
        scale[r, c] = 1e-3
    return (d.reshape(M // bm, bm, K // bk, bk)
            * scale[:, None, :, None]).reshape(M, K)


def _structure_equal(a, b):
    for x, y in zip(a[:2], b[:2]):
        assert np.asarray(x).dtype == np.int64
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    np.testing.assert_array_equal(
        a[2].float().numpy(), np.asarray(jnp.asarray(b[2], jnp.float32)))


@pytest.mark.parametrize("tol", [0.0, 0.01])
@pytest.mark.parametrize("bm,bk", [(16, 128), (16, 32), (8, 16)])
def test_bcsr_from_dense_matches_reference(bm, bk, tol):
    d = _pruned(1, 64, 256, bm, bk, empty_rows=(1,), tiny=[(0, 0), (2, 1)])
    _structure_equal(tb.bcsr_from_dense(torch.from_numpy(d), bm, bk, tol),
                     jb.bcsr_from_dense(d, bm, bk, tol))
    if tol:   # the tiny blocks are gone, the rest kept
        crows, _, _ = tb.bcsr_from_dense(torch.from_numpy(d), bm, bk, tol)
        crows0, _, _ = tb.bcsr_from_dense(torch.from_numpy(d), bm, bk, 0.0)
        assert crows[-1] < crows0[-1]


def test_bcsr_from_dense_bf16_keeps_dtype():
    d = _pruned(2, 32, 128, 16, 32)
    want = jb.bcsr_from_dense(jnp.asarray(d).astype(jnp.bfloat16), 16, 32)
    got = tb.bcsr_from_dense(torch.from_numpy(d).bfloat16(), 16, 32)
    assert got[2].dtype == torch.bfloat16
    _structure_equal(got, want)


# (M, K, N, bm, bk, empty block rows); the last three are shapes the bf16
# wgmma route sees on the card: blocks of one 64-row M tile and three
# 64-deep slices, blocks of two M tiles (128 + 16 rows) and a bk that is no
# multiple of 64, and N not a multiple of 8
CASES = {
    "reference_case": (64, 256, 192, 16, 128, (2,)),
    "n_tail": (96, 256, 200, 32, 64, (0,)),
    "square_blocks": (128, 256, 64, 64, 64, ()),
    "n_one": (64, 128, 1, 16, 32, (3,)),
    "bm64_bk192": (128, 384, 72, 64, 192, (1,)),
    "bm144_bk48": (288, 192, 40, 144, 48, (0,)),
    "n_odd": (144, 128, 13, 48, 32, (2,)),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_bcsr_spmm_matches_reference_kernel(case, dtype):
    M, K, N, bm, bk, empty = CASES[case]
    d = _pruned(3, M, K, bm, bk, empty_rows=empty)
    x = np.random.RandomState(4).randn(K, N).astype(np.float32)
    jd, jx = jnp.asarray(d).astype(dtype), jnp.asarray(x).astype(dtype)
    crows, cols, vals = jb.bcsr_from_dense(jd, bm, bk)
    want = np.asarray(jb.bcsr_spmm(crows, cols, vals, jx).astype(jnp.float32))
    tdt = getattr(torch, dtype)
    tc, tcols, tvals = tb.bcsr_from_dense(torch.from_numpy(d).to(tdt), bm, bk)
    got = tb.bcsr_spmm(tc, tcols, tvals, torch.from_numpy(x).to(tdt))
    assert got.dtype == tdt and tuple(got.shape) == (M, N)
    g = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(g, want, atol=1e-4, rtol=0)
    else:
        assert np.abs(g - want).max() <= 1e-2 * np.abs(want).max()
    for r in empty:
        assert (g[r * bm:(r + 1) * bm] == 0).all()     # empty row -> zeros


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bcsr_spmm_strided_x_matches_reference_kernel(dtype):
    """x as a view whose row stride (a multiple of 8 elements) exceeds N,
    as the wgmma route reads it in place on the card."""
    M, K, N, bm, bk = 128, 192, 45, 64, 48
    d = _pruned(7, M, K, bm, bk, empty_rows=(1,))
    x = np.random.RandomState(8).randn(K, N).astype(np.float32)
    jd, jx = jnp.asarray(d).astype(dtype), jnp.asarray(x).astype(dtype)
    crows, cols, vals = jb.bcsr_from_dense(jd, bm, bk)
    want = np.asarray(jb.bcsr_spmm(crows, cols, vals, jx).astype(jnp.float32))
    tdt = getattr(torch, dtype)
    buf = torch.full((K, 56), float("nan"), dtype=tdt)
    buf[:, :N] = torch.from_numpy(x).to(tdt)
    xs = buf[:, :N]
    assert xs.stride(0) == 56 and not xs.is_contiguous()
    tc, tcols, tvals = tb.bcsr_from_dense(torch.from_numpy(d).to(tdt), bm, bk)
    g = tb.bcsr_spmm(tc, tcols, tvals, xs).float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(g, want, atol=1e-4, rtol=0)
    else:
        assert np.abs(g - want).max() <= 1e-2 * np.abs(want).max()
    assert (g[bm:2 * bm] == 0).all()


def test_row_order_puts_the_longest_runs_first():
    crows = np.array([0, 2, 2, 7, 10, 13, 14])
    order = tb.row_order(crows)
    assert order.dtype == np.int32
    assert order.tolist() == [2, 3, 4, 0, 5, 1]    # ties in row order


def test_reference_golden_matches():
    d = _pruned(5, 64, 256, 16, 128, empty_rows=(2,))
    x = np.random.RandomState(6).randn(256, 96).astype(np.float32)
    crows, cols, vals = jb.bcsr_from_dense(d, 16, 128)
    want = np.asarray(jb.bcsr_spmm_reference(crows, cols, vals,
                                             jnp.asarray(x)))
    got = tb.bcsr_spmm_reference(crows, cols,
                                 torch.from_numpy(np.array(vals)),
                                 torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)
    np.testing.assert_allclose(got.numpy(), d @ x, atol=1e-4, rtol=0)


def test_public_api_matches_reference():
    # tests/test_sparse.py's case: the top block row pruned
    rs = np.random.RandomState(1)
    d = rs.randn(32, 128).astype(np.float32)
    d[:16] = 0.0
    x = rs.randn(128, 64).astype(np.float32)
    jc, jcols, jv = jsparse.bcsr_from_dense(paddle.to_tensor(d), 16, 128)
    want = jsparse.bcsr_matmul(jc, jcols, jv, paddle.to_tensor(x)).numpy()
    tc, tcols, tv = tsparse.bcsr_from_dense(torch.from_numpy(d), 16, 128)
    got = tsparse.bcsr_matmul(tc, tcols, tv, torch.from_numpy(x))
    assert isinstance(got, torch.Tensor)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)
    np.testing.assert_allclose(got.numpy(), d @ x, atol=1e-4, rtol=0)
    assert (got[:16] == 0).all()


def test_empty_matrix():
    crows, cols, vals = tb.bcsr_from_dense(torch.zeros(32, 128), 16, 128)
    assert crows.tolist() == [0, 0, 0] and cols.size == 0
    assert tuple(vals.shape) == (0, 16, 128)
    y = tsparse.bcsr_matmul(crows, cols, vals, torch.ones(128, 8))
    jc, jcols, jv = jb.bcsr_from_dense(np.zeros((32, 128), np.float32), 16,
                                       128)
    want = np.asarray(jb.bcsr_spmm(jc, jcols, jv, jnp.ones((128, 8))))
    assert tuple(y.shape) == want.shape == (32, 8)
    assert float(y.abs().max()) == 0.0


def test_numpy_dense_needs_a_device_without_a_card():
    d = np.zeros((16, 32), np.float32)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tsparse.bcsr_from_dense(d, 16, 32)
    crows, cols, vals = tsparse.bcsr_from_dense(d, 16, 32, device="cpu")
    assert vals.device.type == "cpu" and crows.tolist() == [0, 0]


@pytest.mark.parametrize("bad", ["crows_falls", "crows_short", "col_range"])
def test_device_structure_refuses_a_broken_structure(bad):
    crows, cols = np.array([0, 2, 3]), np.array([0, 1, 1])
    if bad == "crows_falls":
        crows = np.array([0, 3, 2])
    elif bad == "crows_short":
        crows = np.array([0, 2, 2])
    else:
        cols = np.array([0, 1, 4])
    with pytest.raises(ValueError):
        tb.device_structure(crows, cols, 3, 4, "cpu")
    c, k, o = tb.device_structure(np.array([0, 2, 3]), np.array([0, 1, 1]),
                                  3, 4, "cpu")
    assert c.dtype == k.dtype == o.dtype == torch.int32
    assert o.tolist() == [0, 1]         # the launch order: row_order's


def test_kernel_refuses_a_cpu_tensor():
    structure = tb.device_structure(np.array([0, 1]), np.array([0]), 1, 1,
                                    "cpu")
    with pytest.raises(ValueError, match="no kernel"):
        tb.bcsr_spmm_kernel(*structure, torch.zeros(1, 16, 16),
                            torch.zeros(16, 4))
