"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test needs an NVIDIA card and ``nvcc`` and skips
without them (the check runs inside a fixture, never at import). On the
card (the test imports torch and the port only, so no JAX is needed):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

Covers what ``chip_smoke.py`` does not: head_dim 64 and 128, GQA groups
1, 4 and 8, float32 and bfloat16 queries over float32, bfloat16 and int8
pools, block-table entries outside ``[0, NB)`` (clamped), empty rows,
step padding, and the wrappers' refusals. Tolerances: float32 outputs
atol/rtol 1e-4 (both sum in float32, in another order); bfloat16 outputs
atol 2e-3, rtol 1e-2 (both round once from float32, so they differ by at
most one bf16 ulp, at most 0.78% of the value; atol covers values near 0).
"""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops.kernels import paged_attention as pa
from paddle_tpu_torch.ops.kernels import ragged_paged_attention as rpa
from paddle_tpu_torch.ops.kernels.quant_common import (absmax_scale,
                                                       quantize_symmetric)

pytestmark = pytest.mark.cuda

TOL = {torch.float32: dict(atol=1e-4, rtol=1e-4),
       torch.bfloat16: dict(atol=2e-3, rtol=1e-2)}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _layout(dev, qlens, ctxs, T, h, kv, d, q_dtype, kv_dtype, bs=16, nb=48,
            mb=8, seed=0):
    """q, pools (+ scales for int8), tables, context_lens, cu_q_lens. Table
    entries past a row's context hold out-of-range ids, which both
    versions clamp and never read."""
    rng = np.random.RandomState(seed)
    R = len(qlens)
    cu = np.concatenate([[0], np.cumsum(qlens)]).astype(np.int32)
    tbl = rng.choice([-3, nb + 7], size=(R, mb)).astype(np.int32)
    perm = rng.permutation(nb)
    nxt = 0
    for r, c in enumerate(ctxs):
        n = -(-c // bs)
        tbl[r, :n] = perm[nxt:nxt + n]
        nxt += n
    q = torch.from_numpy(rng.randn(T, h, d).astype(np.float32))
    kp = torch.from_numpy(rng.randn(nb, bs, kv, d).astype(np.float32))
    vp = torch.from_numpy(rng.randn(nb, bs, kv, d).astype(np.float32))
    kw = {}
    if kv_dtype == torch.int8:
        ks, vs = absmax_scale(kp, -1), absmax_scale(vp, -1)
        kp, vp = (quantize_symmetric(kp, ks[..., None]),
                  quantize_symmetric(vp, vs[..., None]))
        kw = dict(k_scale=ks.to(dev), v_scale=vs.to(dev))
    else:
        kp, vp = kp.to(kv_dtype), vp.to(kv_dtype)
    put = lambda a: torch.as_tensor(a).to(dev)  # noqa: E731
    return ((q.to(q_dtype).to(dev), kp.to(dev), vp.to(dev), put(tbl),
             put(np.asarray(ctxs, np.int32)), put(cu)), kw)


RAGGED = {
    # name: (qlens, ctxs, T)
    "mixed": ([1, 20, 1, 7, 0], [90, 20, 1, 55, 0], 40),
    "decode_only": ([1, 1, 1, 1], [5, 17, 100, 64], 8),
    "prefill_offsets": ([33, 16], [60, 16], 64),
}


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("h,kv", [(8, 8), (16, 4), (32, 4)])
@pytest.mark.parametrize("q_dtype,kv_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.bfloat16, torch.int8), (torch.float32, torch.int8)],
    ids=["f32", "bf16", "bf16-int8", "f32-int8"])
@pytest.mark.parametrize("name", sorted(RAGGED))
def test_ragged_kernel_matches_plain(dev, name, q_dtype, kv_dtype, h, kv, d):
    qlens, ctxs, T = RAGGED[name]
    args, kw = _layout(dev, qlens, ctxs, T, h, kv, d, q_dtype, kv_dtype,
                       seed=sorted(RAGGED).index(name))
    before = rpa.launches.count
    got = rpa.ragged_paged_attention(*args, **kw)
    torch.cuda.synchronize()
    assert rpa.launches.count == before + 1
    want = rpa.ragged_paged_attention_plain(*args, **kw)
    assert got.dtype == q_dtype and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), **TOL[q_dtype])
    n = sum(qlens)
    assert bool((got[n:] == 0).all()), "step padding must be exact zeros"


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("h,kv", [(8, 8), (32, 8), (16, 2)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gang_decode_kernel_matches_plain(dev, dtype, h, kv, d):
    ctxs = [0, 1, 17, 64, 127, 40]
    (q, kp, vp, tbl, lens, _), _ = _layout(
        dev, [1] * len(ctxs), ctxs, len(ctxs), h, kv, d, dtype, dtype)
    q = q[:, None].contiguous()
    before = pa.launches.count
    got = pa.paged_attention(q, kp, vp, tbl, lens)
    torch.cuda.synchronize()
    assert pa.launches.count == before + 1
    want = pa.paged_attention_plain(q, kp, vp, tbl, lens)
    assert got.dtype == dtype and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
    assert bool((got[0] == 0).all()), "context_len 0 must give zeros"


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    (q, kp, vp, tbl, lens, cu), _ = _layout(
        dev, [1, 3], [9, 3], 4, 8, 2, 64, torch.bfloat16, torch.bfloat16)
    before = (rpa.launches.count, pa.launches.count)
    with pytest.raises(ValueError, match="dtype"):
        rpa.ragged_paged_attention(q.half(), kp.half(), vp.half(), tbl,
                                   lens, cu)
    with pytest.raises(ValueError, match="contiguous"):
        rpa.ragged_paged_attention(q.transpose(0, 1).contiguous()
                                   .transpose(0, 1), kp, vp, tbl, lens, cu)
    with pytest.raises(ValueError, match="int32"):
        rpa.ragged_paged_attention(q, kp, vp, tbl.long(), lens, cu)
    with pytest.raises(ValueError, match="k_scale"):
        rpa.ragged_paged_attention(q, kp.to(torch.int8), vp.to(torch.int8),
                                   tbl, lens, cu)
    with pytest.raises(ValueError, match="head_dim"):
        rpa.ragged_paged_attention(q[..., :32].contiguous(),
                                   kp[..., :32].contiguous(),
                                   vp[..., :32].contiguous(), tbl, lens, cu)
    with pytest.raises(ValueError, match="no int8 path"):
        pa.paged_attention(q[:2, None].contiguous(), kp.to(torch.int8),
                           vp.to(torch.int8), tbl, lens)
    assert (rpa.launches.count, pa.launches.count) == before
