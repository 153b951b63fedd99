"""The gang-decode kernel's split-KV arithmetic, on the CPU.

``paged_attention_split_plain`` mirrors what the CUDA split pass and its
merge compute (each row's positions in splits of ``sp``, a float32 (m, l,
acc) per split with base-2 exponents, merged in split order). Held here
against ``paged_attention_plain`` and the JAX package's Pallas kernel
(``pallas/paged_attention.py``, interpret mode on the CPU; for an int8
pool the reference's dequant composite), at split counts 1, 2 and many,
with contexts 0, 1, exactly a split boundary and one past it, over
float32, bfloat16 and int8 pools. Tolerances: float32 atol/rtol 2e-5 (the
same sums in another order, exp2 against exp: a few float32 ulps);
bfloat16 atol 2e-3, rtol 1e-2 (both round one float32 result to bf16, so
they differ by at most one bf16 ulp, 0.78% of the value; atol covers
values near 0).

``split_plan`` (what the wrapper launches) covers every position below
``MB * BS`` exactly once, in splits of whole pool blocks and whole
64-position chunks, with at most 512 pool blocks a split.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.kernels.pallas import paged_attention as jpa
from paddle_tpu.ops.kernels.pallas import quant_common as jqc
from paddle_tpu.ops.kernels.serving import paged_attention_kernel
from paddle_tpu_torch.ops.kernels import paged_attention as tpa

F32 = dict(atol=2e-5, rtol=2e-5)
BF16 = dict(atol=2e-3, rtol=1e-2)

BS, MB = 16, 16                    # 256 positions a row
SPLITS = {"one": 256, "two": 128, "many": 64}   # positions per split
CTXS = [0, 1, 64, 65, 128, 129, 256, 200]        # 64 and 128: boundaries


def _layout(seed, ctxs=CTXS, kv=2, h=8, d=32, nb=160):
    rng = np.random.RandomState(seed)
    B = len(ctxs)
    tbl = rng.choice([-5, nb + 3], size=(B, MB)).astype(np.int32)
    perm = rng.permutation(nb)
    nxt = 0
    for b, c in enumerate(ctxs):
        n = -(-c // BS)
        tbl[b, :n] = perm[nxt:nxt + n]
        nxt += n
    q = rng.randn(B, 1, h, d).astype(np.float32)
    kp = rng.randn(nb, BS, kv, d).astype(np.float32)
    vp = rng.randn(nb, BS, kv, d).astype(np.float32)
    return q, kp, vp, tbl, np.asarray(ctxs, np.int32)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("split", sorted(SPLITS))
def test_split_mirror_float32_matches_plain_and_pallas(split):
    args = _layout(11)
    want = np.asarray(jpa.paged_attention(*[jnp.asarray(a) for a in args]))
    targs = [_t(a) for a in args]
    got = tpa.paged_attention_split_plain(*targs, sp=SPLITS[split])
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, **F32)
    torch.testing.assert_close(got, tpa.paged_attention_plain(*targs), **F32)
    assert float(got[0].abs().max()) == 0.0      # context_len 0: zeros


@pytest.mark.parametrize("split", sorted(SPLITS))
def test_split_mirror_bfloat16_matches_plain(split):
    q, kp, vp, tbl, ctx = _layout(12, h=16, kv=2)   # G 8
    targs = [_t(q).bfloat16(), _t(kp).bfloat16(), _t(vp).bfloat16(),
             _t(tbl), _t(ctx)]
    got = tpa.paged_attention_split_plain(*targs, sp=SPLITS[split])
    want = tpa.paged_attention_plain(*targs)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(), **BF16)
    # and the float32 arithmetic under the bf16 inputs against the
    # reference's
    ref = np.asarray(jpa.paged_attention(
        *[jnp.asarray(t.float().numpy()) for t in targs[:3]],
        jnp.asarray(tbl), jnp.asarray(ctx)))
    np.testing.assert_allclose(
        tpa.paged_attention_split_plain(
            *[t.float() for t in targs[:3]], targs[3], targs[4],
            sp=SPLITS[split]).numpy(), ref, **F32)


@pytest.mark.parametrize("split", sorted(SPLITS))
def test_split_mirror_int8_pool_matches_reference(split):
    q, kp, vp, tbl, ctx = _layout(13)
    ks = np.asarray(jqc.absmax_scale(jnp.asarray(kp), axis=-1))
    vs = np.asarray(jqc.absmax_scale(jnp.asarray(vp), axis=-1))
    kq = np.asarray(jqc.quantize_symmetric(jnp.asarray(kp), ks[..., None]))
    vq = np.asarray(jqc.quantize_symmetric(jnp.asarray(vp), vs[..., None]))
    want = np.asarray(paged_attention_kernel(
        *[jnp.asarray(a) for a in (q, kq, vq, tbl, ctx)],
        k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs)))
    targs = [_t(a) for a in (q, kq, vq, tbl, ctx)]
    kw = dict(k_scale=_t(ks), v_scale=_t(vs))
    got = tpa.paged_attention_split_plain(*targs, sp=SPLITS[split], **kw)
    # the reference's composite gives NaN (0 / 0) for a context_len 0 row,
    # its Pallas kernel zeros; the port gives zeros for every pool dtype
    live = ctx > 0
    np.testing.assert_allclose(got.numpy()[live], want[live], **F32)
    assert float(got[~torch.from_numpy(live)].abs().max()) == 0.0
    torch.testing.assert_close(got, tpa.paged_attention_plain(*targs, **kw),
                               **F32)


# (MB, BS, batch, kv blocks per row, SMs): the smoke's step, generate()'s
# short tables, pool blocks that are not a divisor of the 64-position
# chunk, one big batch, a table longer than the per-split cap, one SM
PLANS = [(128, 64, 16, 8, 132), (3, 64, 4, 8, 132), (40, 48, 8, 8, 132),
         (7, 128, 2, 8, 132), (64, 16, 256, 8, 132), (4096, 16, 1, 1, 132),
         (1, 16, 1, 1, 1), (100, 1, 3, 4, 132)]


@pytest.mark.parametrize("plan", PLANS, ids=[str(p) for p in PLANS])
def test_split_plan_covers_every_position_once(plan):
    mb, bs, batch, groups, sms = plan
    sp, splits = tpa.split_plan(mb, bs, batch, groups, sms)
    assert sp % bs == 0 and sp % tpa.SPLIT_CHUNK == 0
    assert sp // bs <= tpa.SPLIT_TABLE_CAP and splits >= 1
    seen = np.zeros(mb * bs, np.int64)
    for s in range(splits):
        seen[s * sp:(s + 1) * sp] += 1
    assert (seen == 1).all()
    assert (splits - 1) * sp < mb * bs <= splits * sp
    if mb * bs <= tpa.SPLIT_TABLE_CAP * bs:     # no cap in the way
        assert splits <= max(1, min(
            tpa.MAX_SPLITS, -(-tpa.SPLIT_BLOCKS_PER_SM * sms
                              // (batch * groups))))
