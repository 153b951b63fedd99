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
tail is masked) and ``sq < sk``, float32 and bfloat16, and the folded
``flash_block`` layout with an lse cotangent. Gradients are judged by max
error relative to the tensor's max: 1e-4 in float32, 1e-2 in bfloat16
(one bf16 ulp of the largest entries). The fused optimizer kernel equals
its plain version bit for bit (``torch.equal``) over the four rules, with
found 0 and 1, float32 params and bf16 params with float32 masters.
"""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops.kernels import flash_attention as fa
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


# -- flash attention -----------------------------------------------------------

def _rel_err(got, want):
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max().clamp_min(1e-30))


FLASH_LENS = {"tiles": (128, 128), "tails": (100, 100), "sq<sk": (77, 200)}


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
