"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test needs an NVIDIA card and ``nvcc`` and skips
without them (the check runs inside a fixture, never at import). On the
card (the test imports torch and the port only, so no JAX is needed):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

Covers what ``chip_smoke.py`` does not: head_dim 64 and 128, GQA groups
1, 4 and 8, float32 and bfloat16 queries over float32, bfloat16 and int8
pools, block-table entries outside ``[0, NB)`` (clamped), empty rows,
step padding, and the wrappers' refusals. The ragged kernels' routes at a
forced split length: decode rows at contexts 0, one split, a split
boundary and one past it (the split pass and merge), verify rows of 5
tokens, chunks and a context past the table (the tile pass, its long
tiles cut in pieces and merged), against the plain version and the plain
mirror of their arithmetic, two calls giving the same bytes; and what the
ragged wrapper refuses (a GQA group that does not divide 64, misshapen or
mistyped cu_q_lens and context_lens, a pool in another dtype, a table on
another device). Tolerances: float32 outputs
atol/rtol 1e-4 (both sum in float32, in another order); bfloat16 outputs
atol 2e-3, rtol 1e-2 (both round once from float32, so they differ by at
most one bf16 ulp, at most 0.78% of the value; atol covers values near 0).

Flash attention (forward, dq, dk/dv) over the same head_dims and groups,
causal on and off, lengths that are not multiples of the 64-row tile (the
tail is masked), ``sq < sk`` and lengths that need more tiles than the
bf16 kernels' two-stage ring holds (1000, 513 x 1100, 2049), float32 and
bfloat16, and the folded ``flash_block`` layout with an lse cotangent;
each kernel (flash and varlen, bf16 and float32) gives the same bytes on
two launches. Gradients are judged by max
error relative to the tensor's max: 1e-4 in float32, 1e-2 in bfloat16
(one bf16 ulp of the largest entries). Packed (varlen) flash attention
(forward, dq, dk/dv) over the same head_dims, GQA groups 1, 4 and 8,
causal on and off, self packing with tails, a length-1 and an empty
document, a document longer than 1024 tokens, the longest document last,
and cross packing (equal and unequal totals), float32 and
bfloat16, with the same limits; the float32 kernels under the layout's
longest-first block order and under the identity order give the same
bytes; the causal token skip on and off equal
bit for bit; rows with no live key; the op through ``call_op`` on the
card against the CPU; and the refusals (head_dim 96, float16, cu_seqlens
off the card). The fused optimizer kernel equals
its plain version bit for bit (``torch.equal``) over the four rules, with
found 0 and 1, float32 params and bf16 params with float32 masters; so do
Lamb's two passes with the trust ratios between them, over float32 and
bf16 compute and grad dtypes and found 0 and 1, and ``optimizer.Lamb``'s
fused route equals its per-param route on the card. The gang-decode
kernel over an int8 pool matches its plain version (bf16 and float32 q,
head_dim 64 and 128); its split-KV pass and merge over contexts 0, 1, a
split boundary and one past it and 2100 (many splits at the serving head
geometry) for every (q, pool) dtype pair, giving the same bytes on two
launches, and at split counts 1, 2 and many (the plan forced) with 16
query heads a kv head (two head groups). The block-CSR SpMM matches its
plain version over float32 and bf16, blocks 16 x 128, 128 x 128, 144 x
32, 48 x 48, 64 x 192, 32 x 64 and 96 x 48, N tails, empty block rows and
an empty matrix, with one launch per call, and refuses bf16 blocks that
are not multiples of 16; its float32 route at every M tile (and bk 6 and
20) gives the same bytes on two launches, with or without the row order
and for an x whose rows are not 16-byte aligned; bf16 takes the wgmma route for an x whose rows are 16-byte
aligned (a strided view read in place, NaN past N never reaching the
output) and the WMMA route for a contiguous x with N % 8 != 0, the route
asserted, the wgmma route bit for bit run to run and with or without the
row order.
The grouped GEMM matches its plain version over float32 and bfloat16,
groups per expert 1 and 2, whole and tail C/K/N tiles, K not a multiple
of the 64-deep k tile, rows that are not 16-byte aligned, w contiguous,
as a transposed view (dx's) and with neither axis contiguous, and counts
with empty, partial and full groups (one pattern all empty, one at the
edges of the 128-row C tile), C, K and N one past the float32 route's
tiles, K and N not multiples of 4; the bf16 wgmma route and the float32
route (every w layout) give the same bytes on two launches; its autograd on the card matches the CPU's. The int4
weight-only GEMM matches its plain version over m 1, 4, 16, 37, 64, 65,
200 and 512 (both sides of the decode / prefill edge, both prefill
widths), Llama-3-8B's k/v,
down and gate/up shapes (every split-k slice count), whole and tail k
steps and n tiles, k and n that are not multiples of 8 (the WMMA route),
float32 and bfloat16 x, with a bias and a 3-D x through
``weight_only_linear``, and with ``FLAGS_use_pallas_kernels`` off (the
plain version, launching nothing); each route gives the same bytes on
two launches. The quantization ops (``fake_quantize`` forward and
backward, ``quantization.quant_linear`` at numeric scales,
``llm_int8_linear`` with outliers, on both sides of ``torch._int_mm``'s
shape rules) read nothing of the card on the host: they run under
``torch.cuda.set_sync_debug_mode("error")``, and a CUDA graph captured
over them replays their eager results bit for bit.
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
        n = min(-(-c // bs), mb)   # a context past mb * bs fills the row
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


# every route of one ragged call at a forced split length of 128: decode
# rows at contexts 0, one split, a split boundary and one past it, two
# splits less one and 1500; verify rows of 5 tokens; a 200-token chunk; a
# 37-token chunk whose context runs past the table (mb * bs = 1536); an
# empty row with a context; 13 padding tokens
ROUTE_SP, ROUTE_MB, ROUTE_BS = 128, 24, 64
ROUTE_ROWS = [(1, 0), (1, 128), (1, 129), (1, 1500), (5, 5), (5, 700),
              (0, 300), (200, 1000), (1, 255), (37, 1636), (1, 64)]


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("h,kv", [(8, 8), (16, 4), (32, 4)])
@pytest.mark.parametrize("q_dtype,kv_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.bfloat16, torch.int8), (torch.float32, torch.int8)],
    ids=["f32", "bf16", "bf16-int8", "f32-int8"])
def test_ragged_routes_match_plain(dev, monkeypatch, q_dtype, kv_dtype, h,
                                   kv, d):
    """The split pass and merge (decode rows across split boundaries and
    a context of 0), the tile pass (verify rows, chunks, a context past
    the table) and the padding, against the plain version and the plain
    mirror of their arithmetic; two calls give the same bytes; one launch
    counted a call."""
    mb, bs, sp = ROUTE_MB, ROUTE_BS, ROUTE_SP
    monkeypatch.setattr(pa, "split_plan",
                        lambda *a: (sp, -(-(mb * bs) // sp)))
    qlens = [q for q, _ in ROUTE_ROWS]
    ctxs = [c for _, c in ROUTE_ROWS]
    nb = sum(min(-(-c // bs), mb) for c in ctxs) + 4
    args, kw = _layout(dev, qlens, ctxs, sum(qlens) + 13, h, kv, d, q_dtype,
                       kv_dtype, bs=bs, nb=nb, mb=mb, seed=h + d)
    before = rpa.launches.count
    got = rpa.ragged_paged_attention(*args, **kw)
    again = rpa.ragged_paged_attention(*args, **kw)
    torch.cuda.synchronize()
    assert rpa.launches.count == before + 2
    want = rpa.ragged_paged_attention_plain(*args, **kw)
    torch.testing.assert_close(got.float(), want.float(), **TOL[q_dtype])
    piece, items = rpa.call_schedule(*args[:2], *args[3:])
    assert max(n for *_, n in items) > 1, "a tile cut in pieces"
    mirror = rpa.ragged_paged_attention_split_plain(*args, sp=sp,
                                                    piece=piece, **kw)
    torch.testing.assert_close(got.float(), mirror.float(), **TOL[q_dtype])
    assert bool((got[sum(qlens):] == 0).all()), "padding must be zeros"
    assert bool((got[0] == 0).all()), "context_len 0 must give zeros"
    assert torch.equal(got, again)


def test_ragged_wrapper_refuses_what_the_kernels_do_not_take(dev):
    (q, kp, vp, tbl, lens, cu), _ = _layout(
        dev, [1, 3], [9, 3], 4, 8, 2, 64, torch.bfloat16, torch.bfloat16)
    before = rpa.launches.count
    with pytest.raises(ValueError, match="GQA group"):   # G 3: 64 % 3
        rpa.ragged_paged_attention(q[:, :6].contiguous(), kp, vp, tbl, lens,
                                   cu)
    with pytest.raises(ValueError, match="cu_q_lens"):
        rpa.ragged_paged_attention(q, kp, vp, tbl, lens, cu[:2].contiguous())
    with pytest.raises(ValueError, match="context_lens"):
        rpa.ragged_paged_attention(q, kp, vp, tbl, lens.long(), cu)
    with pytest.raises(ValueError, match="pool dtype"):
        rpa.ragged_paged_attention(q, kp.float(), vp.float(), tbl, lens, cu)
    with pytest.raises(ValueError, match="is on"):
        rpa.ragged_paged_attention(q, kp, vp, tbl.cpu(), lens, cu)
    assert rpa.launches.count == before


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


def _decode_case(dev, ctxs, dtype, kv_dtype, h=32, kv=8, d=128, bs=64,
                 mb=40, seed=0):
    nb = sum(-(-c // bs) for c in ctxs) + 4
    (q, kp, vp, tbl, lens, _), kw = _layout(
        dev, [1] * len(ctxs), ctxs, len(ctxs), h, kv, d, dtype, kv_dtype,
        bs=bs, nb=nb, mb=mb, seed=seed)
    return (q[:, None].contiguous(), kp, vp, tbl, lens), kw


@pytest.mark.parametrize("kv_dtype", ["same", "int8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gang_decode_contexts_across_splits(dev, dtype, kv_dtype):
    """Contexts 0, 1, one split, a split boundary and one past it, and the
    smoke's 2100 (many splits at the serving head geometry), every
    (q, pool) dtype pair; the split pass and its merge give the same
    bytes on two launches."""
    kvt = torch.int8 if kv_dtype == "int8" else dtype
    args, kw = _decode_case(dev, [2100] * 8, dtype, kvt)
    sp, splits = pa.call_plan(args[0], args[1], args[3])
    assert splits > 4
    ctxs = [0, 1, sp - 1, sp, sp + 1, 2 * sp, 1500, 2100]
    args, kw = _decode_case(dev, ctxs, dtype, kvt)
    assert pa.call_plan(args[0], args[1], args[3]) == (sp, splits)
    got = pa.paged_attention(*args, **kw)
    again = pa.paged_attention(*args, **kw)
    torch.cuda.synchronize()
    want = pa.paged_attention_plain(*args, **kw)
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
    assert bool((got[0] == 0).all()), "context_len 0 must give zeros"
    assert torch.equal(got, again)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("plan", ["one_split", "two_splits", "many_splits"])
def test_gang_decode_split_counts(dev, monkeypatch, plan, d):
    """The kernel at split counts 1, 2 and many (the plan forced), the
    contexts past one split, 16 query heads a kv head (two head groups);
    all within the plain version's limits."""
    mb, bs = 24, 64
    sp = {"one_split": mb * bs, "two_splits": mb * bs // 2,
          "many_splits": 64}[plan]
    monkeypatch.setattr(pa, "split_plan",
                        lambda *a: (sp, -(-(mb * bs) // sp)))
    ctxs = [700, 0, 1536, 65, 768, 769]
    args, _ = _decode_case(dev, ctxs, torch.bfloat16, torch.bfloat16, h=32,
                           kv=2, d=d, mb=mb, seed=5)   # G 16: two groups
    got = pa.paged_attention(*args)
    torch.cuda.synchronize()
    want = pa.paged_attention_plain(*args)
    torch.testing.assert_close(got.float(), want.float(),
                               **TOL[torch.bfloat16])
    assert bool((got[1] == 0).all())


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kernel", ["fwd", "dq", "dkv"])
def test_flash_kernels_are_bitwise_run_to_run(dev, kernel, dtype):
    """No atomics and a fixed order of sums: two launches of each kernel
    (the tensor-core engine's in bf16, the FMA engine's in float32) give
    the same bytes."""
    g = torch.Generator(device=dev).manual_seed(3)
    mk = lambda n: torch.randn((2, 700, n, 128), generator=g,  # noqa: E731
                               device=dev).to(dtype)
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
# empty document; cross packing with equal and with unequal totals; the
# longest document last (so the longest-first block order is no identity)
VARLEN_PACKS = {"docs": ([100, 1, 0, 37, 230, 64], None),
                "cross": ([1, 199, 80], [199, 1, 80]),
                "cross_tq_ne_tk": ([30, 100, 5, 0], [64, 20, 77, 9]),
                "long_doc": ([1500, 40, 300], None),
                "longest_last": ([30, 64, 5, 200, 1300], None)}


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kernel", ["fwd", "dq", "dkv"])
def test_varlen_kernels_are_bitwise_run_to_run(dev, kernel, dtype):
    q, k, v, dout, cu, _ = _varlen_inputs(dev, "long_doc", 16, 4, 128,
                                          dtype)
    lay = fv.varlen_layout(cu, cu, q.shape[0], k.shape[0], True)
    out, lse = fv.flash_varlen_fwd(q, k, v, lay, True, 0.09)
    delta = (dout.float() * out.float()).sum(-1).transpose(0, 1).contiguous()
    call = {"fwd": lambda: fv.flash_varlen_fwd(q, k, v, lay, True, 0.09),
            "dq": lambda: fv.flash_varlen_dq(q, k, v, dout, lse, delta, lay,
                                             True, 0.09),
            "dkv": lambda: fv.flash_varlen_dkv(q, k, v, dout, lse, delta,
                                               lay, True, 0.09)}[kernel]
    assert _same_bytes_twice(call)


@pytest.mark.parametrize("causal", [True, False])
def test_varlen_f32_kernels_read_the_block_order(dev, causal):
    """The float32 kernels walk their blocks in the layout's order (the
    longest run first, blocks of the last document here): the same layout
    with both orders replaced by the identity gives the same bytes, and
    both match the plain version."""
    q, k, v, dout, cu, _ = _varlen_inputs(dev, "longest_last", 16, 4, 128,
                                          torch.float32)
    lay = fv.varlen_layout(cu, cu, q.shape[0], k.shape[0], causal)
    assert int(lay.q_order[0]) >= (30 + 64 + 5 + 200) // 64
    ident = lay._replace(
        q_order=torch.arange(len(lay.q_order), dtype=torch.int32, device=dev),
        k_order=torch.arange(len(lay.k_order), dtype=torch.int32, device=dev))
    want, want_lse = fv.flash_varlen_fwd_plain(q, k, v, cu, cu, causal, 0.1)
    delta = (dout.float() * want.float()).sum(-1).transpose(0, 1)
    delta = delta.contiguous()
    ref = fv.flash_varlen_bwd_plain(q, k, v, dout, want_lse, delta, cu, cu,
                                    causal, 0.1)
    res = []
    for layout in (lay, ident):
        out, lse = fv.flash_varlen_fwd(q, k, v, layout, causal, 0.1)
        res.append([out, lse,
                    fv.flash_varlen_dq(q, k, v, dout, want_lse, delta, layout,
                                       causal, 0.1),
                    *fv.flash_varlen_dkv(q, k, v, dout, want_lse, delta,
                                         layout, causal, 0.1)])
    torch.cuda.synchronize()
    for a, b in zip(*res):
        assert torch.equal(a, b)
    torch.testing.assert_close(res[0][0], want, **TOL[torch.float32])
    torch.testing.assert_close(res[0][1], want_lse, atol=1e-4, rtol=1e-5)
    for a, b in zip(res[0][2:], ref):
        assert _rel_err(a, b) < 1e-4


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
    "momentum": ("momentum", {"momentum": 0.9, "nesterov": False}),
    "nesterov": ("momentum", {"momentum": 0.9, "nesterov": True}),
    "adam": ("adam", {"b1": 0.9, "b2": 0.999, "eps": 1e-8,
                      "decoupled": False}),
    "adamw": ("adam", {"b1": 0.9, "b2": 0.95, "eps": 1e-8,
                       "decoupled": True}),
    "lamb": ("lamb", {"b1": 0.9, "b2": 0.999, "eps": 1e-6}),
}
# (compute dtype, grad dtype, bf16 write-back from a float32 master)
FUSED_DTYPES = {"f32": (torch.float32, torch.float32, False),
                "f32_bf16grad": (torch.float32, torch.bfloat16, False),
                "bf16": (torch.bfloat16, torch.bfloat16, False),
                "bf16_f32grad": (torch.bfloat16, torch.float32, False),
                "bf16_master": (torch.float32, torch.bfloat16, True)}
# element counts: not multiples of 4 or 8, around a block's sweep (1024
# elements) and a split part, at and around a chunk-table row (64Ki),
# several rows
FUSED_SIZES = [1, 3, 5, 7, 1023, 1025, 4097, 24_001, fo.CHUNK - 1, fo.CHUNK,
               fo.CHUNK + 5, 3 * fo.CHUNK + 3]
# where masters and moments sit: their own allocations under the split
# plan or a forced split of 3 (part edges inside rows); views at 1, 2, 3
# elements into a flat buffer, which take the kernel's scalar path
FUSED_PLACES = {"aligned": (0, None), "split3": (0, 3), "offset1": (1, None),
                "offset2": (2, None), "offset3": (3, None)}


def _placed(x, shift):
    """A copy of ``x`` ``shift`` elements into a flat buffer of its own."""
    flat = torch.zeros(x.numel() + shift + 8, dtype=x.dtype, device=x.device)
    view = flat[shift:shift + x.numel()].view(x.shape)
    view.copy_(x)
    return view


def _fused_bucket(dev, g, kind, cdt, gdt, master, shift):
    def placed(x):
        return _placed(x, shift)

    ts, gs, ss, lows = [], [], [], []
    for n in FUSED_SIZES:
        w = torch.randn(n, generator=g, device=dev) * 0.1
        low = w.bfloat16() if master else None
        ts.append(placed(low.float() if master else w.to(cdt)))
        gs.append((torch.randn(n, generator=g, device=dev) * 64).to(gdt))
        ss.append({key: placed((torch.rand(n, generator=g, device=dev)
                                * 0.1).to(cdt))
                   for key in fo.STATE_KEYS[kind]})
        lows.append(low)
    if kind == "lamb":
        ts[-2].zero_()                # a zero parameter: trust ratio 1
    return ts, gs, ss, lows


@pytest.mark.parametrize("place", sorted(FUSED_PLACES))
@pytest.mark.parametrize("dtypes", sorted(FUSED_DTYPES))
@pytest.mark.parametrize("found", [0.0, 1.0])
@pytest.mark.parametrize("rule", sorted(FUSED_RULES))
def test_fused_optimizer_kernel_bitwise(dev, rule, found, dtypes, place,
                                        monkeypatch):
    kind, cfg = FUSED_RULES[rule]
    cdt, gdt, master = FUSED_DTYPES[dtypes]
    shift, split = FUSED_PLACES[place]
    if split is not None:
        monkeypatch.setattr(fo, "split_plan", lambda rows, sms: split)
    g = torch.Generator(device=dev).manual_seed(len(rule) + 7 * shift)
    a = _fused_bucket(dev, g, kind, cdt, gdt, master, shift)
    # the plain version's copies sit where the kernel's inputs sit: torch's
    # reductions (Lamb's norms) pick their loads by alignment
    b = [[_placed(t, shift) for t in a[0]], [t.clone() for t in a[1]],
         [{k: _placed(t, shift) for k, t in s.items()} for s in a[2]],
         [None if t is None else t.clone() for t in a[3]]]
    orig = [t.clone() for t in a[0]]
    one = torch.ones((), device=dev)
    bc1, bc2 = fo.bias_inv(0.9, 0.999, one * 3)
    svec = fo.pack_scalars(lr=one * 1e-3, step=one * 3, inv=one / 64,
                           coeff=one * 0.75, found=one * found,
                           wd=one * 0.01, inv_bc1=bc1, inv_bc2=bc2)
    counters = (fo.launches, fo.launches_lamb_moments, fo.launches_lamb_apply)
    before = [c.count for c in counters]
    unaligned = fo.unaligned_rows
    fo.fused_bucket_kernel(kind, cfg, *a, svec)
    torch.cuda.synchronize()
    passes = (0, 1, 1) if kind == "lamb" else (1, 0, 0)
    assert [c.count - n for c, n in zip(counters, before)] == list(passes)
    # every row of each pass's table (no bucket: one table a pass)
    rows = sum(-(-n // fo.CHUNK) for n in FUSED_SIZES) * sum(passes)
    assert fo.unaligned_rows - unaligned == (rows if shift else 0)
    fo.fused_bucket_plain(kind, cfg, *b, svec)
    for x, y in zip(a[0] + a[3], b[0] + b[3]):
        if x is not None:
            assert torch.equal(x, y)
    for sx, sy in zip(a[2], b[2]):
        for key in sx:
            assert torch.equal(sx[key], sy[key])
    # found = 1 keeps every param bitwise; a plain step moves some
    moved = [not torch.equal(x, y) for x, y in zip(a[0], orig)]
    assert not any(moved) if found else any(moved)


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
# M tiles, bk that is not a multiple of the 32-deep step nor of the
# wgmma route's 64-deep one, and a block deeper than one 64-deep slice;
# bm 16, 32, 48, 64, 96, 128 and 144 reach every M tile of the float32
# route (16, 32, 64, 128 rows) and its row tail past 128
BCSR_DIMS = {"ref_blocks": (64, 256, 192, 16, 128),
             "big_blocks": (384, 512, 300, 128, 128),
             "tall_blocks": (288, 96, 130, 144, 32),
             "odd_blocks": (96, 144, 70, 48, 48),
             "deep_blocks": (192, 576, 264, 64, 192),
             "bm32_blocks": (128, 320, 260, 32, 64),
             "bm96_blocks": (288, 192, 129, 96, 48)}
# float32 only (bf16 blocks are multiples of 16): bk not a multiple of 4
# (element loads of the values) nor of the 16-deep k tile
BCSR_F32_DIMS = {"thin_k_blocks": (96, 60, 100, 48, 6),
                 "bk20_blocks": (192, 100, 133, 96, 20)}


def _bcsr_case(dev, dims, dtype, empty=True, keep=0.5, seed=0):
    from paddle_tpu_torch.ops.kernels import bcsr_spmm as bs
    M, K, N, bm, bk = {**BCSR_DIMS, **BCSR_F32_DIMS}[dims]
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


def _padded_rows(x, pad=8):
    """x as a view of a wider buffer: its row stride a multiple of 8
    elements, more than N (the wgmma route reads such an x in place)."""
    K, N = x.shape
    buf = torch.full((K, -(-N // 8) * 8 + pad), float("nan"),
                     dtype=x.dtype, device=x.device)
    buf[:, :N] = x
    return buf[:, :N]


@pytest.mark.parametrize("dims", sorted(BCSR_DIMS))
def test_bcsr_spmm_bf16_routes_and_strided_x(dev, dims):
    """bf16 with 16-byte-aligned rows takes the wgmma route, x a strided
    view read in place (NaN past N in its rows must not reach the output);
    a contiguous x whose rows are not 16-byte aligned takes the WMMA
    route. Both match the plain version, empty block rows exactly zero,
    and the wgmma route gives the same bytes on two launches."""
    from paddle_tpu_torch.ops.kernels import bcsr_spmm as bs
    crows, cols, vals, x = _bcsr_case(dev, dims, torch.bfloat16, seed=3)
    want = bs.bcsr_spmm_plain(crows, cols, vals, x)
    lim = 1e-2 * max(float(want.float().abs().max()), 1.0)
    xs = _padded_rows(x)
    assert xs.stride(0) % 8 == 0 and xs.stride(0) > xs.shape[1]
    assert bs.bcsr_route(vals, xs) == "wgmma"
    before = bs.launches.count
    got = bs.bcsr_spmm(crows, cols, vals, xs)
    again = bs.bcsr_spmm(crows, cols, vals, xs)
    torch.cuda.synchronize()
    assert bs.launches.count == before + 2
    assert float((got.float() - want.float()).abs().max()) <= lim
    assert bool((got[-vals.shape[1]:] == 0).all())
    assert torch.equal(got, again)
    if x.shape[1] % 8:
        assert bs.bcsr_route(vals, x) == "wmma"
        got = bs.bcsr_spmm(crows, cols, vals, x)
        torch.cuda.synchronize()
        assert float((got.float() - want.float()).abs().max()) <= lim
    else:
        assert bs.bcsr_route(vals, x) == "wgmma"


@pytest.mark.parametrize("dims", sorted(BCSR_DIMS) + sorted(BCSR_F32_DIMS))
def test_bcsr_spmm_f32_route_bytes_order_and_unaligned_x(dev, dims):
    """The float32 route at every M tile: within 1e-4 of the plain
    version's max, empty block rows exactly zero; two launches give the
    same bytes, and so do the block rows in CSR order instead of
    ``row_order``; an x view whose rows are not 16-byte aligned (4-byte
    copies; NaN past N never reaching the output) gives them too."""
    from paddle_tpu_torch.ops.kernels import bcsr_spmm as bs
    crows, cols, vals, x = _bcsr_case(dev, dims, torch.float32, seed=5)
    assert bs.bcsr_route(vals, x) == "f32_fma"
    want = bs.bcsr_spmm_plain(crows, cols, vals, x)
    lim = 1e-4 * max(float(want.float().abs().max()), 1.0)
    crows_d, cols_d, order_d = bs.device_structure(
        crows, cols, vals.shape[0], x.shape[0] // vals.shape[2], dev)
    assert _same_bytes_twice(
        lambda: bs.bcsr_spmm_kernel(crows_d, cols_d, order_d, vals, x))
    got = bs.bcsr_spmm_kernel(crows_d, cols_d, order_d, vals, x)
    in_order = torch.arange(len(crows) - 1, dtype=torch.int32, device=dev)
    again = bs.bcsr_spmm_kernel(crows_d, cols_d, in_order, vals, x)
    K, N = x.shape
    buf = torch.full((K, N + 1 if (N + 1) % 4 else N + 2), float("nan"),
                     device=dev)
    buf[:, :N] = x
    xs = buf[:, :N]
    assert xs.stride(0) % 4 != 0
    unaligned = bs.bcsr_spmm_kernel(crows_d, cols_d, order_d, vals, xs)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= lim
    assert bool((got[-vals.shape[1]:] == 0).all())
    assert torch.equal(got, again) and torch.equal(got, unaligned)


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
    "edges": (300, 136, 264),       # K not a multiple of the 64-deep k tile
    # one row and column past the 128 x 128 tile, K past the 16-deep k
    # tile with more tiles than the float32 ring's 3 slots; K % 4 and N % 4
    # != 0 (float32 rows not 16-byte aligned: element loads and copies)
    "ring_tails": (129, 300, 257),
    "unaligned": (150, 37, 131),
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
        w = torch.randn((E, 2 * K, 2 * N), generator=g, device=dev)
    w = (w * 0.05).to(dtype)            # (an elementwise op keeps the
    if layout == "strided":             # transposed view's strides, but
        w = w[:, ::2, ::2]              # makes a strided slice contiguous)
    counts = {"mixed": [0, C, 1, min(129, C), C // 2, C - 1],
              "all_empty": [0] * G, "full": [C] * G,
              # one row short of, at and past the 128-row C tile and twice it
              "tile_edges": [min(c, C) for c in (127, 128, 129, 255, 256,
                                                 257)]}[counts_kind]
    return x, w, torch.tensor(counts, dtype=torch.int32, device=dev)


@pytest.mark.parametrize("counts_kind", ["mixed", "all_empty", "full",
                                         "tile_edges"])
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


@pytest.mark.parametrize("layout", ["contiguous", "transposed"])
@pytest.mark.parametrize("dims", ["tiles", "edges"])
def test_grouped_gemm_bf16_kernel_is_bitwise_run_to_run(dev, dims, layout):
    """The wgmma route sums in a fixed order: two launches, same bytes."""
    from paddle_tpu_torch.ops.kernels import grouped_gemm as gg
    x, w, counts = _gmm_inputs(dev, dims, 2, torch.bfloat16, layout,
                               "tile_edges")
    assert gg.gmm_route(x, w).startswith("wgmma")
    a = gg.gmm_kernel(x, w, counts, 2)
    b = gg.gmm_kernel(x, w, counts, 2)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.parametrize("layout", GMM_LAYOUTS)
@pytest.mark.parametrize("dims", sorted(GMM_DIMS))
def test_grouped_gemm_f32_kernel_is_bitwise_run_to_run(dev, dims, layout):
    """The float32 route sums in a fixed order: two launches, same bytes,
    for every w layout (cp.async rows, the staged transposed view,
    element copies)."""
    from paddle_tpu_torch.ops.kernels import grouped_gemm as gg
    x, w, counts = _gmm_inputs(dev, dims, 2, torch.float32, layout,
                               "tile_edges")
    assert gg.gmm_route(x, w).startswith("f32_fma")
    assert _same_bytes_twice(lambda: gg.gmm_kernel(x, w, counts, 2))


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
    "down": (14336, 4096),   # Llama-3-8B's down projection
    "gate_up": (4096, 14336),  # Llama-3-8B's gate and up projections
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
@pytest.mark.parametrize("m", [1, 4, 16, 37, 64, 65, 200, 512])
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


@pytest.mark.parametrize("kn,m,route", [
    ("kv_proj", 16, ("decode", 16)), ("gate_up", 4, ("decode", 2)),
    ("down", 64, ("decode", 8)), ("down", 512, ("prefill", 2)),
    ("gate_up", 65, ("prefill", 2)), ("tiles", 512, ("prefill", 2)),
    ("odd", 16, ("wmma", 1))])
def test_int4_gemm_kernel_is_bitwise_run_to_run(dev, kn, m, route):
    """Each route, split k included, sums in a fixed order (no atomics):
    two launches give the same bytes."""
    from paddle_tpu_torch.ops.kernels import weight_only_gemm as wog
    k, n = WOG_KN[kn]
    x, q, s = _wog_inputs(dev, m, k, n, torch.bfloat16, seed=7)
    assert wog.int4_route(x, q) == route
    a = wog.int4_matmul_kernel(x, q, s)
    b = wog.int4_matmul_kernel(x, q, s)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


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


def _quant_ops(dev):
    """A closure over seeded inputs running the quantization ops."""
    from paddle_tpu_torch import quantization as qz
    from paddle_tpu_torch.ops.kernels import quant
    g = torch.Generator().manual_seed(0)

    def rand(*shape):
        return torch.randn(*shape, generator=g).to(dev)
    x = rand(64, 256).requires_grad_()
    scale = x.detach().abs().amax()
    xl, wl, bl = rand(32, 256), rand(256, 128) * 0.1, rand(128)
    xi = rand(2, 16, 256)
    xi[..., 5] *= 40.0                      # an outlier column
    wi = torch.randint(-127, 128, (256, 128), generator=g,
                       dtype=torch.int8).to(dev)
    si = (rand(128).abs() + 0.1) / 127

    def run():
        y = quant.fake_quantize(x, scale, 8)
        (gx,) = torch.autograd.grad((y * y).sum(), x)
        return (y.detach(), gx,
                qz.quant_linear(xl, wl, bl, 3.0, 0.25, 8),
                quant.llm_int8_linear(xi, wi, None, si, 6.0),   # _int_mm
                quant.llm_int8_linear(xi[:, :5], wi, bl, si, 6.0))
    return run


def test_quantization_ops_never_sync_and_capture(dev):
    run = _quant_ops(dev)
    run()                                   # cuBLAS handles and workspaces
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        eager = run()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = run()
    graph.replay()
    torch.cuda.synchronize()
    for a, b in zip(eager, captured):
        assert torch.equal(a, b)
