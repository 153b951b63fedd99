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

Flash attention (forward, dq, dk/dv) over the same head_dims and groups,
causal on and off, lengths that are not multiples of the 64-row tile (the
tail is masked), ``sq < sk`` and lengths that need more tiles than the
bf16 kernels' two-stage ring holds (1000, 513 x 1100, 2049), float32 and
bfloat16, and the folded ``flash_block`` layout with an lse cotangent;
each bf16 kernel (flash and varlen) gives the same bytes on two launches. Gradients are judged by max
error relative to the tensor's max: 1e-4 in float32, 1e-2 in bfloat16
(one bf16 ulp of the largest entries). Packed (varlen) flash attention
(forward, dq, dk/dv) over the same head_dims, GQA groups 1, 4 and 8,
causal on and off, self packing with tails, a length-1 and an empty
document, a document longer than 1024 tokens, and cross packing (equal and
unequal totals), float32 and
bfloat16, with the same limits; the causal token skip on and off equal
bit for bit; rows with no live key; the op through ``call_op`` on the
card against the CPU; and the refusals (head_dim 96, float16, cu_seqlens
off the card). The fused optimizer kernel equals
its plain version bit for bit (``torch.equal``) over the four rules, with
found 0 and 1, float32 params and bf16 params with float32 masters; so do
Lamb's two passes with the trust ratios between them, over float32 and
bf16 compute and grad dtypes and found 0 and 1, and ``optimizer.Lamb``'s
fused route equals its per-param route on the card. The gang-decode
kernel over an int8 pool matches its plain version (bf16 and float32 q,
head_dim 64 and 128). The block-CSR SpMM matches its plain version over
float32 and bf16, blocks 16 x 128, 128 x 128, 32 x 16 (float32) and
48 x 32, N tails, empty block rows and an empty matrix, with one launch
per call, and refuses bf16 blocks that are not multiples of 16.
The grouped GEMM matches its plain version over float32 and bfloat16,
groups per expert 1 and 2, whole and tail C/K/N tiles, rows that are not
16-byte aligned, w contiguous, as a transposed view (dx's) and with
neither axis contiguous, and counts with empty, partial and full groups
(one pattern all empty); its autograd on the card matches the CPU's.
The int4 weight-only GEMM matches its plain version over m 1, 4, 16, 37
and 512, whole and tail k steps and n tiles, k and n that are not
multiples of 8 (element loads), float32 and bfloat16 x, with a bias and a
3-D x through ``weight_only_linear``, and with ``FLAGS_use_pallas_kernels``
off (the plain version, launching nothing).
"""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops.kernels import flash_attention as fa
from paddle_tpu_torch.ops.kernels import flash_varlen as fv
from paddle_tpu_torch.ops.kernels import fused_optimizer as fo
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


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("h,kv", [(8, 8), (32, 8)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gang_decode_int8_pool_kernel_matches_plain(dev, dtype, h, kv, d):
    ctxs = [0, 1, 17, 64, 127, 40]
    (q, kp, vp, tbl, lens, _), kw = _layout(
        dev, [1] * len(ctxs), ctxs, len(ctxs), h, kv, d, dtype, torch.int8)
    q = q[:, None].contiguous()
    before = pa.launches.count
    got = pa.paged_attention(q, kp, vp, tbl, lens, **kw)
    torch.cuda.synchronize()
    assert pa.launches.count == before + 1
    want = pa.paged_attention_plain(q, kp, vp, tbl, lens, **kw)
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
    with pytest.raises(ValueError, match="k_scale"):
        pa.paged_attention(q[:2, None].contiguous(), kp.to(torch.int8),
                           vp.to(torch.int8), tbl, lens)
    assert (rpa.launches.count, pa.launches.count) == before


# -- flash attention -----------------------------------------------------------

def _rel_err(got, want):
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max().clamp_min(1e-30))


# more tiles than the bf16 kernels' two-stage ring holds, with tails
FLASH_LENS = {"tiles": (128, 128), "tails": (100, 100), "sq<sk": (77, 200),
              "long": (1000, 1000), "long sq<sk": (513, 1100),
              "long tails": (2049, 2049)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lens", sorted(FLASH_LENS))
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("h,kv", [(4, 4), (8, 2), (16, 2)])
@pytest.mark.parametrize("d", [64, 128])
def test_flash_kernels_match_plain(dev, d, h, kv, causal, lens, dtype):
    sq, sk = FLASH_LENS[lens]
    g = torch.Generator(device=dev).manual_seed(d + h + sq)
    mk = lambda s, n: torch.randn((2, s, n, d), generator=g,  # noqa: E731
                                  device=dev).to(dtype)
    q, k, v, dout = mk(sq, h), mk(sk, kv), mk(sk, kv), mk(sq, h)
    scale = d ** -0.5
    before = (fa.launches_fwd.count, fa.launches_dq.count,
              fa.launches_dkv.count)
    out, lse = fa.flash_fwd_kernel(q, k, v, causal, scale)
    torch.cuda.synchronize()
    want, want_lse = fa.flash_fwd_plain(q, k, v, causal, scale)
    torch.testing.assert_close(out.float(), want.float(), **TOL[dtype])
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=1e-5)
    delta = (dout.float() * want.float()).sum(-1).transpose(1, 2)
    delta = delta.contiguous()
    got = fa.flash_bwd_kernel(q, k, v, dout, want_lse, delta, causal, scale)
    torch.cuda.synchronize()
    ref = fa.flash_bwd_plain(q, k, v, dout, want_lse, delta, causal, scale)
    lim = 1e-4 if dtype == torch.float32 else 1e-2
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        assert a.dtype == dtype and a.shape == b.shape
        assert _rel_err(a, b) < lim, (name, _rel_err(a, b))
    assert (fa.launches_fwd.count, fa.launches_dq.count,
            fa.launches_dkv.count) == tuple(n + 1 for n in before)


def test_flash_block_folded_layout_with_lse_cotangent(dev):
    g = torch.Generator(device=dev).manual_seed(7)
    q = torch.randn((8, 96, 64), generator=g, device=dev, requires_grad=True)
    k = torch.randn((4, 96, 64), generator=g, device=dev, requires_grad=True)
    v = torch.randn((4, 96, 64), generator=g, device=dev, requires_grad=True)
    w_o = torch.randn((8, 96, 64), generator=g, device=dev)
    w_l = torch.randn((8, 96), generator=g, device=dev)
    grads = []
    for t in ("cuda", "cpu"):
        args = [x.detach().to(t).requires_grad_() for x in (q, k, v)]
        out, lse = fa.flash_block(*args, True, 0.125)
        ((out * w_o.to(t)).sum() + (lse * w_l.to(t)).sum()).backward()
        grads.append([out.detach(), lse.detach()]
                     + [a.grad for a in args])
    for a, b in zip(*grads):
        assert _rel_err(a.cpu(), b) < 1e-4


def _same_bytes_twice(fn):
    a, b = fn(), fn()
    torch.cuda.synchronize()
    a, b = (a if isinstance(a, tuple) else (a,)), \
        (b if isinstance(b, tuple) else (b,))
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("kernel", ["fwd", "dq", "dkv"])
def test_flash_bf16_kernels_are_bitwise_run_to_run(dev, kernel):
    """No atomics and a fixed order of sums: two launches of each bf16
    kernel give the same bytes."""
    g = torch.Generator(device=dev).manual_seed(3)
    mk = lambda n: torch.randn((2, 700, n, 128), generator=g,  # noqa: E731
                               device=dev).bfloat16()
    q, k, v, dout = mk(16), mk(4), mk(4), mk(16)
    out, lse = fa.flash_fwd_kernel(q, k, v, True, 0.09)
    delta = (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    call = {"fwd": lambda: fa.flash_fwd_kernel(q, k, v, True, 0.09),
            "dq": lambda: fa.flash_dq_kernel(q, k, v, dout, lse, delta, True,
                                             0.09),
            "dkv": lambda: fa.flash_dkv_kernel(q, k, v, dout, lse, delta,
                                               True, 0.09)}[kernel]
    assert _same_bytes_twice(call)


def test_flash_wrapper_refuses_what_the_kernels_do_not_take(dev):
    q = torch.randn((1, 64, 4, 64), device=dev)
    before = fa.launches_fwd.count
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_fwd_kernel(q[..., :32], q[..., :32], q[..., :32], True, 1.0)
    with pytest.raises(ValueError, match="dtype"):
        fa.flash_fwd_kernel(q.half(), q.half(), q.half(), True, 1.0)
    with pytest.raises(ValueError, match="GQA"):
        fa.flash_fwd_kernel(q, q[:, :, :3], q[:, :, :3], True, 1.0)
    assert fa.launches_fwd.count == before


@pytest.mark.parametrize("d,dtype", [(96, torch.bfloat16),
                                     (64, torch.float16)])
def test_routing_sends_cuda_cases_the_kernels_lack_to_them_to_raise(
        dev, d, dtype):
    """The routing decides by shape only: a head_dim or dtype the kernels
    lack raises on the card instead of falling back to the composite."""
    from paddle_tpu_torch.ops.kernels import nn as knn
    q = torch.randn((1, 64, 4, d), device=dev, dtype=dtype)
    with pytest.raises(ValueError, match="head_dim|dtype"):
        knn.flash_attention(q, q, q, is_causal=True)


# -- packed (varlen) flash attention -----------------------------------------

# (q lengths, k lengths or None for self packing): tails, a length-1 and an
# empty document; cross packing with equal and with unequal totals
VARLEN_PACKS = {"docs": ([100, 1, 0, 37, 230, 64], None),
                "cross": ([1, 199, 80], [199, 1, 80]),
                "cross_tq_ne_tk": ([30, 100, 5, 0], [64, 20, 77, 9]),
                "long_doc": ([1500, 40, 300], None)}


def _varlen_inputs(dev, pack, h, kv, d, dtype, seed=0):
    lq, lk = VARLEN_PACKS[pack] if isinstance(pack, str) else pack
    cuq = torch.tensor(np.cumsum([0] + lq), dtype=torch.int32, device=dev)
    cuk = cuq if lk is None else torch.tensor(np.cumsum([0] + lk),
                                              dtype=torch.int32, device=dev)
    g = torch.Generator(device=dev).manual_seed(seed + h + d)
    mk = lambda t, n: torch.randn((t, n, d), generator=g,  # noqa: E731
                                  device=dev).to(dtype)
    tq, tk = int(cuq[-1]), int(cuk[-1])
    return mk(tq, h), mk(tk, kv), mk(tk, kv), mk(tq, h), cuq, cuk


def _varlen_counts():
    return (fv.launches_fwd.count, fv.launches_dq.count,
            fv.launches_dkv.count)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pack", sorted(VARLEN_PACKS))
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("h,kv", [(4, 4), (16, 4), (32, 4)])
@pytest.mark.parametrize("d", [64, 128])
def test_varlen_kernels_match_plain(dev, d, h, kv, causal, pack, dtype):
    q, k, v, dout, cuq, cuk = _varlen_inputs(dev, pack, h, kv, d, dtype)
    scale = d ** -0.5
    lay = fv.varlen_layout(cuq, cuk, q.shape[0], k.shape[0],
                           causal and fv.same_cu_layout(cuq, cuk))
    before = _varlen_counts()
    out, lse = fv.flash_varlen_fwd(q, k, v, lay, causal, scale)
    torch.cuda.synchronize()
    want, want_lse = fv.flash_varlen_fwd_plain(q, k, v, cuq, cuk, causal,
                                               scale)
    torch.testing.assert_close(out.float(), want.float(), **TOL[dtype])
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=1e-5)
    delta = (dout.float() * want.float()).sum(-1).transpose(0, 1)
    delta = delta.contiguous()
    got = (fv.flash_varlen_dq(q, k, v, dout, want_lse, delta, lay, causal,
                              scale),) + fv.flash_varlen_dkv(
        q, k, v, dout, want_lse, delta, lay, causal, scale)
    torch.cuda.synchronize()
    ref = fv.flash_varlen_bwd_plain(q, k, v, dout, want_lse, delta, cuq, cuk,
                                    causal, scale)
    lim = 1e-4 if dtype == torch.float32 else 1e-2
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        assert a.dtype == dtype and a.shape == b.shape
        assert _rel_err(a, b) < lim, (name, _rel_err(a, b))
    assert _varlen_counts() == tuple(n + 1 for n in before)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_varlen_token_skip_on_and_off_give_equal_results(dev, dtype):
    """The skip only leaves out blocks whose pairs are all masked, which
    add exact zeros: the results are equal bit for bit."""
    q, k, v, dout, cu, _ = _varlen_inputs(dev, "docs", 16, 4, 128, dtype)
    lse = delta = None
    res = []
    for skip in (True, False):
        lay = fv.varlen_layout(cu, cu, q.shape[0], k.shape[0], skip)
        out, lse_k = fv.flash_varlen_fwd(q, k, v, lay, True, 0.1)
        if lse is None:
            lse = lse_k
            delta = (dout.float() * out.float()).sum(-1).transpose(0, 1)
            delta = delta.contiguous()
        res.append([out, lse_k,
                    fv.flash_varlen_dq(q, k, v, dout, lse, delta, lay, True,
                                       0.1),
                    *fv.flash_varlen_dkv(q, k, v, dout, lse, delta, lay, True,
                                         0.1)])
    for a, b in zip(*res):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kernel", ["fwd", "dq", "dkv"])
def test_varlen_bf16_kernels_are_bitwise_run_to_run(dev, kernel):
    q, k, v, dout, cu, _ = _varlen_inputs(dev, "long_doc", 16, 4, 128,
                                          torch.bfloat16)
    lay = fv.varlen_layout(cu, cu, q.shape[0], k.shape[0], True)
    out, lse = fv.flash_varlen_fwd(q, k, v, lay, True, 0.09)
    delta = (dout.float() * out.float()).sum(-1).transpose(0, 1).contiguous()
    call = {"fwd": lambda: fv.flash_varlen_fwd(q, k, v, lay, True, 0.09),
            "dq": lambda: fv.flash_varlen_dq(q, k, v, dout, lse, delta, lay,
                                             True, 0.09),
            "dkv": lambda: fv.flash_varlen_dkv(q, k, v, dout, lse, delta,
                                               lay, True, 0.09)}[kernel]
    assert _same_bytes_twice(call)


def test_varlen_rows_without_live_keys_on_the_card(dev):
    q, k, v, dout, cuq, cuk = _varlen_inputs(
        dev, ([40, 30, 20], [40, 0, 20]), 8, 2, 64, torch.float32)
    args = [x.detach().requires_grad_() for x in (q, k, v)]
    out = fv.flash_attn_unpadded(*args, cuq, cuk, causal=True)
    (out * dout).sum().backward()
    assert not out[40:70].any()
    assert all(bool(torch.isfinite(a.grad).all()) for a in args)
    assert not args[0].grad[40:70].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_varlen_op_on_the_card_matches_the_cpu(dev, dtype):
    """``call_op("flash_attn_unpadded")`` forward and backward on the card
    launch each kernel once and agree with the same op on the CPU."""
    from paddle_tpu_torch.ops.dispatcher import call_op
    q, k, v, dout, cu, _ = _varlen_inputs(dev, "docs", 32, 8, 128, dtype)
    res = []
    for t in ("cuda", "cpu"):
        args = [x.detach().to(t).requires_grad_() for x in (q, k, v)]
        c = cu.to(t).long()
        before = _varlen_counts()
        out = call_op("flash_attn_unpadded", *args, c, c, 300, 300, 0.0,
                      True)
        (out.float() * dout.to(t).float()).sum().backward()
        launched = tuple(a - b for a, b in zip(_varlen_counts(), before))
        assert launched == ((1, 1, 1) if t == "cuda" else (0, 0, 0))
        res.append([out.detach()] + [a.grad for a in args])
    lim = 1e-4 if dtype == torch.float32 else 1e-2
    for a, b in zip(*res):
        assert _rel_err(a.cpu(), b) < lim


def test_varlen_wrappers_refuse_what_the_kernels_do_not_take(dev):
    q, k, v, _, cu, _ = _varlen_inputs(dev, "docs", 4, 4, 64, torch.float32)
    lay = fv.varlen_layout(cu, cu, q.shape[0], k.shape[0], True)
    before = _varlen_counts()
    with pytest.raises(ValueError, match="head_dim"):
        fv.flash_varlen_fwd(q[..., :32], k[..., :32], v[..., :32], lay, True,
                            1.0)
    with pytest.raises(ValueError, match="GQA"):
        fv.flash_varlen_fwd(q, k[:, :3], v[:, :3], lay, True, 1.0)
    with pytest.raises(ValueError, match="int32"):
        fv.flash_attn_unpadded(q, k, v, cu.cpu(), cu.cpu(), causal=True)
    assert _varlen_counts() == before


@pytest.mark.parametrize("d,dtype", [(96, torch.bfloat16),
                                     (64, torch.float16)])
def test_varlen_op_raises_for_cuda_cases_the_kernels_lack(dev, d, dtype):
    from paddle_tpu_torch.ops.dispatcher import call_op
    q = torch.randn((100, 4, d), device=dev, dtype=dtype)
    cu = torch.tensor([0, 60, 100], device=dev)
    with pytest.raises(ValueError, match="head_dim|dtype"):
        call_op("flash_attn_unpadded", q, q, q, cu, cu, causal=True)


# -- fused optimizer ---------------------------------------------------------

FUSED_RULES = {
    "sgd": ("sgd", {}),
    "momentum": ("momentum", {"momentum": 0.9, "nesterov": True}),
    "adam": ("adam", {"b1": 0.9, "b2": 0.999, "eps": 1e-8,
                      "decoupled": False}),
    "adamw": ("adam", {"b1": 0.9, "b2": 0.95, "eps": 1e-8,
                       "decoupled": True}),
}


@pytest.mark.parametrize("layout", ["f32", "bf16_master"])
@pytest.mark.parametrize("found", [0.0, 1.0])
@pytest.mark.parametrize("rule", sorted(FUSED_RULES))
def test_fused_optimizer_kernel_bitwise(dev, rule, found, layout):
    kind, cfg = FUSED_RULES[rule]
    g = torch.Generator(device=dev).manual_seed(len(rule))
    shapes = [(300, 70), (fo.CHUNK + 5,), (3,)]

    def bucket():
        master = layout == "bf16_master"
        ts, gs, ss, lows = [], [], [], []
        for shp in shapes:
            w = torch.randn(shp, generator=g, device=dev) * 0.1
            low = w.bfloat16() if master else None
            ts.append(low.float() if master else w)
            gs.append((torch.randn(shp, generator=g, device=dev)
                       * 64).to(torch.bfloat16 if master else torch.float32))
            ss.append({key: torch.rand(shp, generator=g, device=dev) * 0.1
                       for key in fo.STATE_KEYS[kind]})
            lows.append(low)
        return ts, gs, ss, lows

    a = bucket()
    b = [[t.clone() for t in a[0]], [t.clone() for t in a[1]],
         [{k: t.clone() for k, t in s.items()} for s in a[2]],
         [None if t is None else t.clone() for t in a[3]]]
    one = torch.ones((), device=dev)
    svec = fo.pack_scalars(lr=one * 1e-3, step=one * 3, inv=one / 64,
                           coeff=one * 0.75, found=one * found,
                           wd=one * 0.01, inv_bc1=one * 3.69,
                           inv_bc2=one * 1.0003)
    before = fo.launches.count
    fo.fused_bucket_kernel(kind, cfg, *a, svec)
    torch.cuda.synchronize()
    assert fo.launches.count == before + 1
    fo.fused_bucket_plain(kind, cfg, *b, svec)
    for x, y in zip(a[0] + a[3], b[0] + b[3]):
        if x is not None:
            assert torch.equal(x, y)
    for sx, sy in zip(a[2], b[2]):
        for key in sx:
            assert torch.equal(sx[key], sy[key])


def test_fused_optimizer_found_keeps_inputs_bitwise(dev):
    kind, cfg = FUSED_RULES["adamw"]
    w = torch.randn(1000, device=dev)
    low = w.bfloat16()
    master = low.float()
    grad = torch.full((1000,), float("nan"), device=dev).bfloat16()
    st = {"m": torch.rand(1000, device=dev), "v": torch.rand(1000, device=dev)}
    keep = (master.clone(), low.clone(), st["m"].clone(), st["v"].clone())
    one = torch.ones((), device=dev)
    svec = fo.pack_scalars(lr=one, step=one, inv=one, coeff=one, found=one,
                           wd=one * 0.1, inv_bc1=one * 10, inv_bc2=one * 1000)
    fo.fused_bucket_kernel(kind, cfg, [master], [grad], [st], [low], svec)
    torch.cuda.synchronize()
    for x, y in zip((master, low, st["m"], st["v"]), keep):
        assert torch.equal(x, y)


LAMB_CFG = {"b1": 0.9, "b2": 0.999, "eps": 1e-6}


def _lamb_bucket(dev, g, cdt, gdt, master):
    shapes = [(300, 70), (fo.CHUNK + 5,), (3,), (5,)]
    ts, gs, ss, lows = [], [], [], []
    for shp in shapes:
        w = torch.randn(shp, generator=g, device=dev) * 0.1
        low = w.bfloat16() if master else None
        ts.append(low.float() if master else w.to(cdt))
        gs.append((torch.randn(shp, generator=g, device=dev) * 64).to(gdt))
        ss.append({key: (torch.rand(shp, generator=g, device=dev)
                         * 0.1).to(cdt) for key in ("m", "v")})
        lows.append(low)
    ts[3].zero_()                    # a zero parameter: trust ratio 1
    return ts, gs, ss, lows


@pytest.mark.parametrize("found", [0.0, 1.0])
@pytest.mark.parametrize("layout", ["f32", "f32_bf16grad", "bf16",
                                    "bf16_master"])
def test_lamb_passes_bitwise(dev, layout, found):
    cdt = torch.bfloat16 if layout == "bf16" else torch.float32
    gdt = torch.bfloat16 if layout in ("bf16", "bf16_master",
                                       "f32_bf16grad") else torch.float32
    g = torch.Generator(device=dev).manual_seed(11)
    a = _lamb_bucket(dev, g, cdt, gdt, layout == "bf16_master")
    b = [[t.clone() for t in a[0]], [t.clone() for t in a[1]],
         [{k: t.clone() for k, t in s.items()} for s in a[2]],
         [None if t is None else t.clone() for t in a[3]]]
    orig = [t.clone() for t in a[0]]
    one = torch.ones((), device=dev)
    bc1, bc2 = fo.bias_inv(0.9, 0.999, one * 3)
    svec = fo.pack_scalars(lr=one * 1e-3, step=one * 3, inv=one / 64,
                           coeff=one * 0.5, found=one * found,
                           wd=one * 0.01, inv_bc1=bc1, inv_bc2=bc2)
    before = (fo.launches.count, fo.launches_lamb_moments.count,
              fo.launches_lamb_apply.count)
    fo.fused_bucket_kernel("lamb", LAMB_CFG, *a, svec)
    torch.cuda.synchronize()
    assert (fo.launches.count, fo.launches_lamb_moments.count,
            fo.launches_lamb_apply.count) == (before[0], before[1] + 1,
                                              before[2] + 1)
    fo.fused_bucket_plain("lamb", LAMB_CFG, *b, svec)
    for x, y in zip(a[0] + a[3], b[0] + b[3]):
        if x is not None:
            assert torch.equal(x, y)
    for sx, sy in zip(a[2], b[2]):
        for key in sx:
            assert torch.equal(sx[key], sy[key])
    # found = 1 keeps every param bitwise; a plain step moves some (a bf16
    # param moves only where the step crosses half a bf16 ulp)
    moved = [not torch.equal(x, y) for x, y in zip(a[0], orig)]
    assert not any(moved) if found else any(moved)


def test_lamb_fused_equals_per_param_on_the_card(dev):
    from paddle_tpu_torch import flags
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import Lamb
    g = torch.Generator(device=dev).manual_seed(5)
    init = [torch.randn(s, generator=g, device=dev) * 0.1
            for s in [(256, 96), (fo.CHUNK + 7,), (96,)]]
    grads = [[torch.randn(p.shape, generator=g, device=dev) for p in init]
             for _ in range(3)]
    runs = []
    try:
        for fused in (True, False):
            flags.set_flags({"fused_optimizer": fused})
            ps = [torch.nn.Parameter(p.clone().bfloat16()) for p in init]
            opt = Lamb(learning_rate=1e-3, lamb_weight_decay=0.01,
                       parameters=ps, grad_clip=ClipGradByGlobalNorm(1.0),
                       exclude_from_weight_decay_fn=lambda p: p.ndim == 1)
            for gs in grads:
                for p, gr in zip(ps, gs):
                    p.grad = gr.bfloat16()
                opt.step()
                opt.clear_grad()
            runs.append((ps, opt))
    finally:
        flags.set_flags({"fused_optimizer": True})
    (pf, of), (pp, op) = runs
    assert of._fused_last_reason is None
    for a, b in zip(pf, pp):
        assert torch.equal(a, b)
    for ma, mb in zip(of._masters, op._masters):
        assert torch.equal(ma, mb)
    for sa, sb in zip(of._states, op._states):
        assert torch.equal(sa["m"], sb["m"]) and torch.equal(sa["v"], sb["v"])


# -- block-CSR SpMM ----------------------------------------------------------

# (M, K, N, bm, bk): whole and tail N tiles, blocks of one and of several
# M tiles, bk that is not a multiple of the 32-deep step
BCSR_DIMS = {"ref_blocks": (64, 256, 192, 16, 128),
             "big_blocks": (384, 512, 300, 128, 128),
             "tall_blocks": (288, 96, 130, 144, 32),
             "odd_blocks": (96, 144, 70, 48, 48)}


def _bcsr_case(dev, dims, dtype, empty=True, keep=0.5, seed=0):
    from paddle_tpu_torch.ops.kernels import bcsr_spmm as bs
    M, K, N, bm, bk = BCSR_DIMS[dims]
    g = torch.Generator(device=dev).manual_seed(seed)
    d = torch.randn((M, K), generator=g, device=dev)
    mask = torch.rand((M // bm, K // bk), generator=g, device=dev) < keep
    if empty:
        mask[-1] = False
    d = (d.view(M // bm, bm, K // bk, bk) * mask[:, None, :, None]) \
        .view(M, K).to(dtype)
    x = torch.randn((K, N), generator=g, device=dev).to(dtype)
    return bs.bcsr_from_dense(d, bm, bk) + (x,)


@pytest.mark.parametrize("keep", [0.5, 0.0])
@pytest.mark.parametrize("dims", sorted(BCSR_DIMS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bcsr_spmm_kernel_matches_plain(dev, dtype, dims, keep):
    from paddle_tpu_torch.ops.kernels import bcsr_spmm as bs
    crows, cols, vals, x = _bcsr_case(dev, dims, dtype, keep=keep)
    before = bs.launches.count
    got = bs.bcsr_spmm(crows, cols, vals, x)
    torch.cuda.synchronize()
    assert bs.launches.count == before + 1
    want = bs.bcsr_spmm_plain(crows, cols, vals, x)
    assert got.dtype == dtype and got.shape == want.shape
    err = float((got.float() - want.float()).abs().max())
    lim = (1e-4 if dtype == torch.float32 else 1e-2) * max(
        float(want.float().abs().max()), 1.0)
    assert err <= lim, (err, lim)
    bm = vals.shape[1]
    assert bool((got[-bm:] == 0).all()), "an empty block row must be zeros"
    if keep == 0.0:
        assert cols.size == 0 and bool((got == 0).all())


def test_bcsr_spmm_wrapper_refuses_what_the_kernel_does_not_take(dev):
    from paddle_tpu_torch.ops.kernels import bcsr_spmm as bs
    crows, cols, vals, x = _bcsr_case(dev, "odd_blocks", torch.float32)
    before = bs.launches.count
    with pytest.raises(ValueError, match="multiples of 16"):
        c, k, v = bs.bcsr_from_dense(torch.zeros((16, 24), device=dev)
                                     .bfloat16(), 8, 8)
        bs.bcsr_spmm(c, k, v, torch.zeros((24, 4), device=dev).bfloat16())
    with pytest.raises(ValueError, match="dtype|float"):
        bs.bcsr_spmm(crows, cols, vals, x.half())
    with pytest.raises(ValueError, match="cols"):
        bs.bcsr_spmm(crows, cols + 100, vals, x)
    assert bs.launches.count == before


# -- grouped GEMM ------------------------------------------------------------

GMM_DIMS = {  # (C, K, N)
    "tiles": (256, 128, 256),       # whole 128 x 128 tiles, 16-byte loads
    "tails": (200, 72, 200),        # tail C, K and N tiles
    "odd": (37, 20, 30),            # rows not 16-byte aligned: element loads
}
GMM_LAYOUTS = ("contiguous", "transposed", "strided")


def _gmm_inputs(dev, dims, gpe, dtype, layout, counts_kind, seed=0):
    C, K, N = GMM_DIMS[dims]
    G = 6
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((G, C, K), generator=g, device=dev).to(dtype)
    E = G // gpe
    if layout == "contiguous":
        w = torch.randn((E, K, N), generator=g, device=dev)
    elif layout == "transposed":       # K contiguous, as dx's w^T
        w = torch.randn((E, N, K), generator=g, device=dev).transpose(1, 2)
    else:                               # neither K nor N contiguous
        w = torch.randn((E, 2 * K, 2 * N), generator=g,
                        device=dev)[:, ::2, ::2]
    w = (w * 0.05).to(dtype)
    counts = {"mixed": [0, C, 1, min(129, C), C // 2, C - 1],
              "all_empty": [0] * G, "full": [C] * G}[counts_kind]
    return x, w, torch.tensor(counts, dtype=torch.int32, device=dev)


@pytest.mark.parametrize("counts_kind", ["mixed", "all_empty", "full"])
@pytest.mark.parametrize("layout", GMM_LAYOUTS)
@pytest.mark.parametrize("dims", sorted(GMM_DIMS))
@pytest.mark.parametrize("gpe", [1, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grouped_gemm_kernel_matches_plain(dev, dtype, gpe, dims, layout,
                                           counts_kind):
    from paddle_tpu_torch.ops.kernels import grouped_gemm as gg
    x, w, counts = _gmm_inputs(dev, dims, gpe, dtype, layout, counts_kind,
                               seed=len(dims) + gpe)
    before = gg.launches.count
    got = gg.gmm_kernel(x, w, counts, gpe)
    torch.cuda.synchronize()
    assert gg.launches.count == before + 1
    want = gg.gmm_plain(x, w, counts, gpe)
    assert got.dtype == dtype and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
    dead = torch.arange(x.shape[1], device=dev)[None, :] >= counts[:, None]
    assert bool((got[dead] == 0).all()), "rows past counts must be zeros"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grouped_matmul_grads_on_the_card_match_the_cpu(dev, dtype):
    from paddle_tpu_torch.ops.kernels import grouped_gemm as gg
    x, w, counts = _gmm_inputs(dev, "tails", 2, dtype, "contiguous", "mixed")
    ct = torch.randn((6, 200, 200), device=dev)
    grads = []
    for t in ("cuda", "cpu"):
        a, b = (v.detach().to(t).requires_grad_() for v in (x, w))
        before = gg.launches.count
        y = gg.grouped_matmul(a, b, counts.to(t), 2)
        (y.float() * ct.to(t)).sum().backward()
        if t == "cuda":
            assert gg.launches.count == before + 2   # forward and dx
        grads.append((y.detach().cpu(), a.grad.cpu(), b.grad.cpu()))
    lim = 1e-4 if dtype == torch.float32 else 1e-2
    for got, want in zip(*grads):
        assert got.dtype == dtype
        assert _rel_err(got, want) < lim


def test_grouped_gemm_wrapper_refuses_what_the_kernel_does_not_take(dev):
    from paddle_tpu_torch.ops.kernels import grouped_gemm as gg
    x, w, counts = _gmm_inputs(dev, "odd", 1, torch.float32, "contiguous",
                               "mixed")
    before = gg.launches.count
    with pytest.raises(ValueError, match="dtype"):
        gg.gmm_kernel(x.half(), w.half(), counts)
    with pytest.raises(ValueError, match="int32"):
        gg.gmm_kernel(x, w, counts.long())
    with pytest.raises(ValueError, match="groups_per_expert"):
        gg.gmm_kernel(x, w, counts, 2)
    with pytest.raises(ValueError, match="dtype"):
        gg.grouped_matmul(x.half(), w.half(), counts)
    assert gg.launches.count == before


# -- int4 weight-only GEMM ------------------------------------------------------

WOG_KN = {  # (k, n)
    "tiles": (256, 384),     # whole 32-deep k steps and 128-wide n tiles
    "tails": (200, 1000),    # tail k step and n tile, vector loads
    "odd": (66, 37),         # k % 8 and n % 8 != 0: element loads
    "kv_proj": (4096, 1024),  # Llama-3-8B's k/v projection
}


def _wog_inputs(dev, m, k, n, dtype, seed=0):
    from paddle_tpu_torch.ops.kernels import weight_only_gemm as wog
    g = torch.Generator(device=dev).manual_seed(seed)
    w = torch.randn((k, n), generator=g, device=dev) * 0.02
    q, s = wog.quantize(w, "int4")
    x = torch.randn((m, k), generator=g, device=dev).to(dtype)
    return x, q, s


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kn", sorted(WOG_KN))
@pytest.mark.parametrize("m", [1, 4, 16, 37, 512])
def test_int4_gemm_kernel_matches_plain(dev, m, kn, dtype):
    from paddle_tpu_torch.ops.kernels import weight_only_gemm as wog
    k, n = WOG_KN[kn]
    x, q, s = _wog_inputs(dev, m, k, n, dtype, seed=m + k)
    before = wog.launches.count
    got = wog.weight_only_matmul(x, q, s, "int4")
    torch.cuda.synchronize()
    assert wog.launches.count == before + 1
    want = wog.int4_matmul_plain(x, q, s)
    assert got.dtype == dtype and got.shape == (m, n)
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int4_linear_with_bias_and_the_flag_on_the_card(dev, dtype):
    from paddle_tpu_torch import flags
    from paddle_tpu_torch.ops.kernels import quant, weight_only_gemm as wog
    x, q, s = _wog_inputs(dev, 2 * 45, 200, 1000, dtype, seed=3)
    x = x.reshape(2, 45, 200)
    bias = torch.randn(1000, device=dev) * 0.1
    before = wog.launches.count
    got = quant.weight_only_linear(x, q, bias, s, weight_dtype="int4")
    assert wog.launches.count == before + 1
    flags.set_flags({"use_pallas_kernels": False})
    try:
        plain = quant.weight_only_linear(x, q, bias, s, weight_dtype="int4")
    finally:
        flags.set_flags({"use_pallas_kernels": True})
    assert wog.launches.count == before + 1     # the flag's plain route
    want = wog.int4_matmul_plain(x.reshape(90, 200), q, s).reshape(
        2, 45, 1000) + bias.to(dtype)
    assert got.dtype == dtype and got.shape == (2, 45, 1000)
    torch.testing.assert_close(plain, want, rtol=0, atol=0)
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


def test_int4_gemm_wrapper_refuses_what_the_kernel_does_not_take(dev):
    from paddle_tpu_torch.ops.kernels import weight_only_gemm as wog
    x, q, s = _wog_inputs(dev, 4, 66, 37, torch.float32)
    before = wog.launches.count
    with pytest.raises(ValueError, match="dtype"):
        wog.int4_matmul_kernel(x.half(), q, s)
    with pytest.raises(ValueError, match="int8"):
        wog.int4_matmul_kernel(x, q.int(), s)
    with pytest.raises(ValueError, match="twice"):
        wog.int4_matmul_kernel(x[:, :64], q, s)
    with pytest.raises(ValueError, match="n=37"):
        wog.int4_matmul_kernel(x, q, s[:36])
    with pytest.raises(ValueError, match="is on"):
        wog.int4_matmul_kernel(x, q.cpu(), s)
    assert wog.launches.count == before
