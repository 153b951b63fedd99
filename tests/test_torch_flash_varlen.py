"""The port's packed (varlen) flash attention against the JAX package's.

Same inputs (numpy, seeded) through ``paddle_tpu``'s
``pallas/flash_varlen.py`` (Pallas in interpret mode on the CPU) and the
port's ``flash_varlen`` (its plain versions on a CPU tensor): forward (out
and lse), grads against ``jax.grad``, GQA, empty, length-1 and tail
segments, cross packing, rows with no live key; within the port the block
skip's loop bounds, one segment against the padded flash attention, and
no leakage between documents; the layout helpers against the reference's.

Tolerances: float32 out and lse atol 2e-5 (the reference test's), grads
atol 5e-5: both sum in float32, the Pallas kernel block by block with an
online softmax, the plain version per segment in one softmax. bfloat16
inputs are rounded identically and both round the float32 result once,
so outputs differ by at most one bf16 ulp (rtol 2^-7, atol 1e-3 near 0).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.kernels.pallas import flash_varlen as ref
from paddle_tpu_torch.ops.kernels import flash_attention as tfa
from paddle_tpu_torch.ops.kernels import flash_varlen as fv

# a length-1 and an empty segment; T = 317, not a multiple of 64 or 128
LENS = [37, 91, 1, 0, 128, 60]
H, D = 4, 32
OUT_TOL = dict(atol=2e-5, rtol=1e-6)
GRAD_ATOL = 5e-5
BF16_TOL = dict(atol=1e-3, rtol=2 ** -7)


def _cu(lens):
    return np.cumsum([0] + list(lens)).astype(np.int32)


def _inputs(seed, tq, tk, hk, h=H, d=D):
    rng = np.random.RandomState(seed)
    return [(rng.randn(t, n, d) * 0.3).astype(np.float32)
            for t, n in ((tq, h), (tk, hk), (tk, hk), (tq, h))]


def _t(*xs, dtype=torch.float32, grad=False):
    return [torch.from_numpy(x).to(dtype).requires_grad_(grad) for x in xs]


def _ref_fwd(q, k, v, cuq, cuk, causal, jdt=jnp.float32):
    """The reference kernel's (out, lse [h, Tq]) in float32 numpy."""
    args = [jnp.asarray(x, jdt) for x in (q, k, v)]
    tok = causal and ref.same_cu_layout(cuq, cuk)
    out, res = ref._varlen_fwd_impl(*args, jnp.asarray(cuq), jnp.asarray(cuk),
                                    causal, q.shape[-1] ** -0.5, tok)
    lse = np.asarray(res[4])[:, 0, :q.shape[0]]
    return np.asarray(jnp.asarray(out, jnp.float32)), lse


def _ref_grads(q, k, v, w, cuq, cuk, causal):
    cq, ck = jnp.asarray(cuq), jnp.asarray(cuk)
    wj = jnp.asarray(w)
    f = lambda a, b, c: jnp.sum(ref.flash_attn_unpadded(  # noqa: E731
        a, b, c, cq, ck, causal=causal) * wj)
    return [np.asarray(g) for g in jax.grad(f, argnums=(0, 1, 2))(
        *(jnp.asarray(x) for x in (q, k, v)))]


def _port_grads(q, k, v, w, cuq, cuk, causal):
    tq, tk, tv = _t(q, k, v, grad=True)
    out = fv.flash_attn_unpadded(tq, tk, tv, torch.from_numpy(cuq),
                                 torch.from_numpy(cuk), causal=causal)
    (out * torch.from_numpy(w)).sum().backward()
    return out.detach().numpy(), [x.grad.numpy() for x in (tq, tk, tv)]


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("G", [1, 2, 4])
def test_forward_matches_reference(causal, G):
    cu = _cu(LENS)
    q, k, v, _ = _inputs(G, cu[-1], cu[-1], H // G)
    want_out, want_lse = _ref_fwd(q, k, v, cu, cu, causal)
    out, lse = fv.flash_varlen_fwd_plain(*_t(q, k, v), torch.from_numpy(cu),
                                         torch.from_numpy(cu), causal,
                                         D ** -0.5)
    np.testing.assert_allclose(out.numpy(), want_out, **OUT_TOL)
    np.testing.assert_allclose(lse.numpy(), want_lse, **OUT_TOL)


def test_forward_bf16_within_one_ulp():
    cu = _cu(LENS)
    q, k, v, _ = _inputs(5, cu[-1], cu[-1], 2)
    want, _ = _ref_fwd(q, k, v, cu, cu, True, jnp.bfloat16)
    got = fv.flash_attn_unpadded(*_t(q, k, v, dtype=torch.bfloat16),
                                 torch.from_numpy(cu), torch.from_numpy(cu),
                                 causal=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, **BF16_TOL)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("G", [1, 4])
def test_grads_match_jax_grad(causal, G):
    cu = _cu(LENS)
    q, k, v, w = _inputs(10 + G, cu[-1], cu[-1], H // G)
    want = _ref_grads(q, k, v, w, cu, cu, causal)
    _, got = _port_grads(q, k, v, w, cu, cu, causal)
    for name, a, b in zip("qkv", got, want):
        np.testing.assert_allclose(a, b, atol=GRAD_ATOL, err_msg=f"d{name}")


def test_cross_packing_causal_matches_reference():
    """q lengths [1, 199] against k lengths [199, 1]: the token-space skip
    must not apply; the mask alone keeps pos_k <= pos_q per segment."""
    cuq, cuk = _cu([1, 199]), _cu([199, 1])
    assert not fv.same_cu_layout(torch.from_numpy(cuq), torch.from_numpy(cuk))
    q, k, v, w = _inputs(7, 200, 200, 2, h=2)
    want_out, _ = _ref_fwd(q, k, v, cuq, cuk, True)
    want = _ref_grads(q, k, v, w, cuq, cuk, True)
    out, got = _port_grads(q, k, v, w, cuq, cuk, True)
    np.testing.assert_allclose(out, want_out, **OUT_TOL)
    for name, a, b in zip("qkv", got, want):
        np.testing.assert_allclose(a, b, atol=GRAD_ATOL, err_msg=f"d{name}")


def test_rows_without_live_keys():
    """A q segment whose k segment is empty: out 0 and lse -1e30, as the
    reference gives, and zero (not NaN) grads for those rows."""
    cuq, cuk = _cu([40, 30, 20]), _cu([40, 0, 20])
    q, k, v, w = _inputs(3, 90, 60, 2)
    want_out, want_lse = _ref_fwd(q, k, v, cuq, cuk, True)
    out, lse = fv.flash_varlen_fwd_plain(*_t(q, k, v), torch.from_numpy(cuq),
                                         torch.from_numpy(cuk), True,
                                         D ** -0.5)
    np.testing.assert_allclose(out.numpy(), want_out, **OUT_TOL)
    np.testing.assert_allclose(lse.numpy(), want_lse, **OUT_TOL)
    assert not out[40:70].any() and bool((lse[:, 40:70] == -1e30).all())
    want = _ref_grads(q, k, v, w, cuq, cuk, True)
    _, got = _port_grads(q, k, v, w, cuq, cuk, True)
    assert all(np.isfinite(g).all() for g in got)
    assert not got[0][40:70].any()
    for name, a, b in zip("qkv", got, want):
        np.testing.assert_allclose(a, b, atol=GRAD_ATOL, err_msg=f"d{name}")


# -- within the port ----------------------------------------------------------

def _live_blocks(cuq, cuk, tq, tk, causal):
    """(q block, k block) pairs holding at least one live pair."""
    sq, pq = (x.numpy() for x in fv.segments(torch.from_numpy(cuq), tq))
    sk, pk = (x.numpy() for x in fv.segments(torch.from_numpy(cuk), tk))
    live = sq[:, None] == sk[None, :]
    if causal:
        live &= pk[None, :] <= pq[:, None]
    qi, ki = np.nonzero(live)
    return set(zip(qi // fv.BLOCK, ki // fv.BLOCK))


def _run_pairs(lay):
    qb, kb = lay.q_bounds.numpy(), lay.k_bounds.numpy()
    by_q = {(i, j) for i in range(qb.shape[1])
            for j in range(qb[0, i], qb[1, i] + 1)}
    by_k = {(i, j) for j in range(kb.shape[1])
            for i in range(kb[0, j], kb[1, j] + 1)}
    return by_q, by_k


PACKINGS = {
    "docs": ([300, 5, 1, 0, 130, 64, 200], None),
    "tail": ([63, 1, 66, 257], None),
    "cross": ([1, 199, 80], [199, 1, 80]),
}


@pytest.mark.parametrize("packing,tok_skip", [
    ("docs", False), ("docs", True), ("tail", False), ("tail", True),
    ("cross", False)])
def test_block_skip_changes_time_only(packing, tok_skip):
    """The kernels' loop bounds, with the causal token skip on and off,
    run every block pair that holds a live pair; dq's walk (by q block)
    and dk/dv's (by k block) are the same pairs, and they are exactly the
    reference kernel's run rule at the same block size."""
    lq, lk = PACKINGS[packing]
    cuq = _cu(lq)
    cuk = cuq if lk is None else _cu(lk)
    tq, tk = int(cuq[-1]), int(cuk[-1])
    lay = fv.varlen_layout(torch.from_numpy(cuq), torch.from_numpy(cuk),
                           tq, tk, tok_skip)
    by_q, by_k = _run_pairs(lay)
    assert by_q == by_k
    assert _live_blocks(cuq, cuk, tq, tk, causal=True) <= by_q
    if not tok_skip:
        assert _live_blocks(cuq, cuk, tq, tk, causal=False) <= by_q
    # the reference's rule over its own tables (same padding ids)
    n, b = len(cuq) - 1, fv.BLOCK
    nq, nk = -(-tq // b), -(-tk // b)
    rq = np.asarray(ref._block_ranges(ref._segments(
        jnp.asarray(cuq), tq, nq * b, n)[0], nq, b))
    rk = np.asarray(ref._block_ranges(ref._segments(
        jnp.asarray(cuk), tk, nk * b, n + 1)[0], nk, b))
    want = {(i, j) for i in range(nq) for j in range(nk)
            if rk[0, j] <= rq[1, i] and rk[1, j] >= rq[0, i]
            and (not tok_skip or j * b <= i * b + b - 1)}
    assert by_q == want


@pytest.mark.parametrize("packing,tok_skip", [
    ("docs", True), ("tail", False), ("cross", False)])
def test_blocks_walk_longest_run_first(packing, tok_skip):
    """The bf16 kernels walk each side's blocks in ``q_order``/``k_order``:
    every block once, runs over the other side non-increasing, ties in
    block order."""
    lq, lk = PACKINGS[packing]
    cuq = _cu(lq)
    cuk = cuq if lk is None else _cu(lk)
    lay = fv.varlen_layout(torch.from_numpy(cuq), torch.from_numpy(cuk),
                           int(cuq[-1]), int(cuk[-1]), tok_skip)
    for bounds, order in ((lay.q_bounds, lay.q_order),
                          (lay.k_bounds, lay.k_order)):
        run = (bounds[1] - bounds[0]).numpy()
        o = order.numpy()
        assert order.dtype == torch.int32
        assert sorted(o) == list(range(len(run)))
        assert all((run[a], b) > (run[b], a) for a, b in zip(o, o[1:]))


def test_block_skip_bounds_the_work():
    """Causal self packing of many documents walks about the sum of
    len^2 / 2, far below T^2."""
    lens = [100, 700, 33, 1200, 64, 900]
    cu = torch.from_numpy(_cu(lens))
    lay = fv.varlen_layout(cu, cu, sum(lens), sum(lens), True)
    pairs = len(_run_pairs(lay)[0]) * fv.BLOCK ** 2
    assert pairs < 2 * sum(n * n / 2 for n in lens) + 4 * fv.BLOCK * sum(lens)
    assert pairs < 0.4 * sum(lens) ** 2 / 2


def test_one_segment_equals_padded_flash_attention():
    s, hk = 150, 2
    q, k, v, w = _inputs(4, s, s, hk)
    cu = torch.tensor([0, s], dtype=torch.int32)
    tq, tk, tv = _t(q, k, v, grad=True)
    out = fv.flash_attn_unpadded(tq, tk, tv, cu, cu, causal=True)
    (out * torch.from_numpy(w)).sum().backward()
    pq, pk, pv = _t(q[None], k[None], v[None], grad=True)
    want = tfa.flash_attention(pq, pk, pv, causal=True)
    (want * torch.from_numpy(w[None])).sum().backward()
    torch.testing.assert_close(out, want[0], atol=1e-6, rtol=1e-6)
    for a, b in ((tq, pq), (tk, pk), (tv, pv)):
        torch.testing.assert_close(a.grad, b.grad[0], atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_no_leakage_between_documents(causal):
    lens = [64, 50, 77]
    cu = torch.from_numpy(_cu(lens))
    q, k, v, _ = _t(*_inputs(2, 191, 191, 2))
    o1 = fv.flash_attn_unpadded(q, k, v, cu, cu, causal=causal)
    k2, v2 = k.clone(), v.clone()
    k2[64:114], v2[64:114] = 999.0, -999.0
    o2 = fv.flash_attn_unpadded(q, k2, v2, cu, cu, causal=causal)
    assert torch.equal(o1[:64], o2[:64]) and torch.equal(o1[114:], o2[114:])
    assert not torch.allclose(o1[64:114], o2[64:114])


# -- layout helpers against the reference -----------------------------------

@pytest.mark.parametrize("pad_total,pad_id", [(None, -1), (384, -1),
                                              (384, 9)])
def test_segments_equal_reference(pad_total, pad_id):
    cu = _cu([37, 0, 91, 1, 128, 60])
    total = int(cu[-1])
    want = ref._segments(jnp.asarray(cu), total, pad_total or total, pad_id)
    got = fv.segments(torch.from_numpy(cu), total, pad_total, pad_id)
    for a, b in zip(got, want):
        assert a.dtype == torch.int32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("bsz", [64, 128])
def test_block_ranges_equal_reference(bsz):
    cu = _cu([37, 0, 91, 1, 128, 60])
    seg, _ = ref._segments(jnp.asarray(cu), 317, 384, -1)
    want = ref._block_ranges(seg, 384 // bsz, bsz)
    got = fv.block_ranges(torch.from_numpy(np.array(seg)), 384 // bsz, bsz)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_varlen_composite_equals_reference(causal):
    cuq, cuk = _cu([30, 1, 0, 70]), _cu([20, 5, 3, 72])
    q, k, v, _ = _inputs(6, 101, 100, 2)
    want = ref.varlen_composite(*(jnp.asarray(x) for x in (q, k, v)),
                                jnp.asarray(cuq), jnp.asarray(cuk),
                                causal=causal)
    got = fv.varlen_composite(*_t(q, k, v), torch.from_numpy(cuq),
                              torch.from_numpy(cuk), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OUT_TOL)


def test_same_cu_layout_equals_reference():
    a, b, c = _cu([3, 5]), _cu([3, 5]), _cu([5, 3])
    for x, y in ((a, a), (a, b), (a, c), (a, _cu([8]))):
        tx, ty = torch.from_numpy(x), torch.from_numpy(y)
        if x is y:
            ty = tx
        want = ref.same_cu_layout(jnp.asarray(x), jnp.asarray(y))
        assert fv.same_cu_layout(tx, ty) == want


def test_plain_version_checks_cu_seqlens():
    q, k, v, _ = _t(*_inputs(1, 10, 10, 2))
    bad = torch.tensor([0, 4, 9], dtype=torch.int32)   # ends before T
    with pytest.raises(ValueError, match="token count"):
        fv.flash_varlen_fwd_plain(q, k, v, bad, bad, True, 1.0)
