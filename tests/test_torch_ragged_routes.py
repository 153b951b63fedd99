"""The ragged kernels' two routes and their schedule, on the CPU.

``ragged_paged_attention_split_plain`` mirrors what the CUDA kernels
compute: decode rows (q_len 1) through the gang decode's split-KV
arithmetic (splits of ``sp`` positions, float32 (m, l, acc) with base-2
exponents, merged in split order), rows of two or more tokens in tiles
whose positions are cut into pieces of ``piece`` steps of 64 (an int8
pool's ``k_scale`` folded into the score columns and ``v_scale`` into
P's), the pieces merged in order. Here it runs at one-step pieces and
64-position splits, so every long tile and decode row is merged, and is
held against ``ragged_paged_attention_plain`` over float32, bfloat16 and
int8 pools, GQA groups 1, 4 and 8, head_dim 64 and 128 and pool blocks of
16 and 64 positions, with rows of q_len 0 (with a context), 1, 5 and a
chunk, a decode row with context 0, rows whose context runs past the
table (MB * BS) and step padding; and, over the pool dtypes and groups,
against the JAX package's Pallas kernel (interpret mode on the CPU, as
``tests/test_torch_ragged_attention.py`` runs it) and its XLA composite
``_ragged_composite``. The context-0 decode row is held to zeros and left
out of the references (the composite clamps its position to 0).

Tolerances: float32 atol/rtol 2e-5 (the same sums in another order, exp2
against exp: a few float32 ulps); bf16 outputs (bf16 and int8 pools, bf16
q) against the plain version atol 2e-3, rtol 1e-2 (both round one float32
result to bf16: at most one bf16 ulp, 0.78% of the value; atol covers
values near 0), against the JAX references atol/rtol 1e-2 (as the ragged
tests against them).

The schedule: the mirror of the tile pass's in-kernel schedule
(``tile_schedule``) and the split pass's blocks together cover every
(token, head, position) that the plain version attends exactly once, and
the padding tokens' heads exactly once; the grids come from
``launch_geometry``, which takes static quantities only and holds every
mix of a token budget; the gang decode and the ragged decode rows take
their split plan from one function.
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.kernels.pallas import quant_common as jqc
from paddle_tpu.ops.kernels.pallas import ragged_paged_attention as jrpa
from paddle_tpu.ops.kernels.serving import _ragged_composite
from paddle_tpu_torch.ops.kernels import paged_attention as tpa
from paddle_tpu_torch.ops.kernels import ragged_paged_attention as trpa

F32 = dict(atol=2e-5, rtol=2e-5)
BF16 = dict(atol=2e-3, rtol=1e-2)
BF16_REF = dict(atol=1e-2, rtol=1e-2)

# (q_len, context) rows; "past" is a context past the table (MB * BS + 40)
ROWS = [(0, 7), (1, 0), (1, 37), (5, 21), (20, 23), (1, "past"),
        (5, "past")]
PAD = 5                     # step padding tokens
MB_FOR_BS = {16: 6, 64: 3}  # 96 and 192 positions a table row
ZERO_ROW = 1                # the decode row with context 0


def _layout(seed, dtype, g, d, bs, kv=2, nb=48):
    """numpy q, pools (int8 with scales), tables, contexts, cu_q_lens."""
    rng = np.random.RandomState(seed)
    mb = MB_FOR_BS[bs]
    qlens = [q for q, _ in ROWS]
    ctxs = [mb * bs + 40 if c == "past" else c for _, c in ROWS]
    cu = np.concatenate([[0], np.cumsum(qlens)]).astype(np.int32)
    tbl = rng.randint(-3, nb + 3, size=(len(ROWS), mb)).astype(np.int32)
    q = rng.randn(int(cu[-1]) + PAD, kv * g, d).astype(np.float32)
    kp = rng.randn(nb, bs, kv, d).astype(np.float32)
    vp = rng.randn(nb, bs, kv, d).astype(np.float32)
    scales = {}
    if dtype == "int8":
        ks = np.asarray(jqc.absmax_scale(jnp.asarray(kp), axis=-1))
        vs = np.asarray(jqc.absmax_scale(jnp.asarray(vp), axis=-1))
        kp, vp = (np.asarray(jqc.quantize_symmetric(jnp.asarray(p),
                                                     s[..., None]))
                  for p, s in ((kp, ks), (vp, vs)))
        scales = dict(k_scale=ks, v_scale=vs)
    return (q, kp, vp, tbl, np.asarray(ctxs, np.int32), cu), scales


def _torch_args(arrays, scales, dtype):
    q, kp, vp, tbl, ctx, cu = (torch.from_numpy(np.array(a)) for a in arrays)
    if dtype != "float32":
        q = q.bfloat16()
    if dtype == "bfloat16":
        kp, vp = kp.bfloat16(), vp.bfloat16()
    kw = {k: torch.from_numpy(np.array(v)) for k, v in scales.items()}
    return (q, kp, vp, tbl, ctx, cu), kw


CASES = [(dt, g, d, bs) for dt in ("float32", "bfloat16", "int8")
         for g in (1, 4, 8) for d in (64, 128) for bs in (16, 64)]


@pytest.mark.parametrize("dtype,g,d,bs", CASES,
                         ids=[f"{dt}-g{g}-d{d}-bs{bs}"
                              for dt, g, d, bs in CASES])
def test_split_mirror_matches_plain(dtype, g, d, bs):
    arrays, scales = _layout(CASES.index((dtype, g, d, bs)), dtype, g, d, bs)
    args, kw = _torch_args(arrays, scales, dtype)
    want = trpa.ragged_paged_attention_plain(*args, **kw)
    got = trpa.ragged_paged_attention_split_plain(*args, sp=64, piece=1,
                                                  **kw)
    assert got.dtype == args[0].dtype
    torch.testing.assert_close(got.float(), want.float(),
                               **(F32 if dtype == "float32" else BF16))
    n = int(arrays[5][-1])
    assert bool((got[n:] == 0).all()), "step padding must be exact zeros"
    tok = int(arrays[5][ZERO_ROW])
    assert bool((got[tok] == 0).all()), "a row that sees nothing gives 0"


REF_CASES = [(dt, g) for dt in ("float32", "bfloat16", "int8")
             for g in (1, 4, 8)]


@pytest.mark.parametrize("dtype,g", REF_CASES,
                         ids=[f"{dt}-g{g}" for dt, g in REF_CASES])
def test_split_mirror_matches_pallas_and_composite(dtype, g):
    i = REF_CASES.index((dtype, g))
    d, bs = (64, 128)[i % 2], (16, 64)[i // 2 % 2]
    arrays, scales = _layout(100 + i, dtype, g, d, bs)
    args, kw = _torch_args(arrays, scales, dtype)
    got = trpa.ragged_paged_attention_split_plain(*args, sp=64, piece=1,
                                                  **kw).float().numpy()
    jt = jnp.bfloat16 if dtype != "float32" else jnp.float32
    q, kp, vp, tbl, ctx, cu = arrays
    jargs = [jnp.asarray(q, jt),
             jnp.asarray(kp, jt if dtype == "bfloat16" else None),
             jnp.asarray(vp, jt if dtype == "bfloat16" else None),
             jnp.asarray(tbl), jnp.asarray(ctx), jnp.asarray(cu)]
    jkw = {k: jnp.asarray(v) for k, v in scales.items()}
    rows = [r for r in range(len(ROWS)) if r != ZERO_ROW]
    live = np.concatenate([np.arange(cu[r], cu[r + 1]) for r in rows])
    tol = F32 if dtype == "float32" else BF16_REF
    for ref in (jrpa.ragged_paged_attention, _ragged_composite):
        want = np.asarray(ref(*jargs, **jkw), np.float32)
        np.testing.assert_allclose(got[live], want[live], **tol)


# -- the schedule ---------------------------------------------------------

def _coverage(cu, ctx, T, H, KV, MB, BS, sp, extra):
    """How often the split pass's blocks and the tile pass's work items
    (the schedule's mirror) attend each (token, head, position), and zero
    each (token, head) of the step padding."""
    tq = trpa.tile_tokens(H, KV)
    R = len(cu) - 1
    cover = np.zeros((T, H, MB * BS), np.int32)
    zeroed = np.zeros((T, H), np.int32)
    for r in range(R):        # the split pass: decode rows, split by split
        if cu[r + 1] - cu[r] != 1:
            continue
        L = max(0, min(ctx[r], MB * BS))
        for s0 in range(0, MB * BS, sp):
            cover[cu[r], :, s0:min(s0 + sp, L)] += 1
    P, items = trpa.tile_schedule(cu, ctx, T, tq, MB, BS, extra)
    geo = trpa.launch_geometry(T, H, KV, R, MB, BS, 132)
    npad = -(-(T - cu[R]) // tq)
    assert len(items) + npad <= geo["tiles"] + extra
    for row, j, k, n in items:
        ql = cu[row + 1] - cu[row]
        end = trpa.tile_end(cu, ctx, T, tq, MB, BS, row, j)
        p0, p1 = k * P * 64, min((k + 1) * P * 64, end)
        assert p0 < p1 or (n == 1 and end == 0)
        for i in range(j * tq, min((j + 1) * tq, ql)):
            qpos = ctx[row] - ql + i
            cover[cu[row] + i, :, p0:max(p0, min(p1, qpos + 1))] += 1
    for i in range(npad):
        zeroed[cu[R] + i * tq:min(cu[R] + (i + 1) * tq, T)] += 1
    return cover, zeroed


def _want(cu, ctx, T, H, MB, BS):
    """The (token, head, position) triples the plain version attends."""
    want = np.zeros((T, H, MB * BS), np.int32)
    for r in range(len(cu) - 1):
        ql = cu[r + 1] - cu[r]
        L = max(0, min(ctx[r], MB * BS))
        for i in range(ql):
            want[cu[r] + i, :, :max(0, min(L, ctx[r] - ql + i + 1))] = 1
    return want


def _mixes(seed, T, R, MB, BS):
    """A decode-only step, a prefill step and random mixes of a token
    budget T over R rows (q_len 0 to T, contexts 0 to past the table)."""
    rng = np.random.RandomState(seed)
    cap = MB * BS + 50
    out = [([1] * R, list(rng.randint(0, cap, R))),
           ([T // 2, T - T // 2] + [0] * (R - 2),
            [T // 2 + 40, T - T // 2] + list(rng.randint(0, cap, R - 2)))]
    for _ in range(3):
        cuts = np.sort(rng.randint(0, T + 1, R - 1))
        qlens = np.diff(np.concatenate([[0], cuts, [rng.randint(0, T + 1)]]))
        qlens = np.maximum(qlens, 0)
        while qlens.sum() > T:
            qlens[np.argmax(qlens)] -= 1
        ctxs = [int(q) + int(rng.randint(0, cap)) for q in qlens]
        out.append((list(qlens), ctxs))
    return out


SCHED = [(g, bs, extra) for g in (1, 4, 8) for bs in (16, 64)
         for extra in (1, 3, 66)]


@pytest.mark.parametrize("g,bs,extra", SCHED,
                         ids=[f"g{g}-bs{bs}-e{e}" for g, bs, e in SCHED])
def test_routes_cover_every_token_head_position_once(g, bs, extra):
    KV, T, R = 2, 72, 6
    H, MB = KV * g, MB_FOR_BS[bs]
    for qlens, ctxs in _mixes(SCHED.index((g, bs, extra)), T, R, MB, bs):
        cu = [0] + list(np.cumsum(qlens).astype(int))
        ctxs = [int(c) for c in ctxs]
        cover, zeroed = _coverage(cu, ctxs, T, H, KV, MB, bs, 64, extra)
        np.testing.assert_array_equal(cover, _want(cu, ctxs, T, H, MB, bs))
        pad = np.zeros((T, H), np.int32)
        pad[cu[-1]:] = 1
        np.testing.assert_array_equal(zeroed, pad)


def test_launch_geometry_takes_static_quantities_only():
    params = list(inspect.signature(trpa.launch_geometry).parameters)
    assert params == ["T", "H", "KV", "R", "MB", "BS", "sms"]
    geo = trpa.launch_geometry(512, 32, 8, 16, 128, 64, 132)
    assert geo["tile_grid"] == (48 + 66, 8) and geo["tq"] == 16
    assert geo["split_grid"] == (8, 16, geo["splits"])
    # every mix of the engine's 512-token budget fits that one geometry
    for qlens, ctxs in _mixes(7, 512, 16, 128, 64):
        cu = [0] + list(np.cumsum(qlens).astype(int))
        _, items = trpa.tile_schedule(cu, [int(c) for c in ctxs], 512, 16,
                                      128, 64, geo["extra"])
        assert len(items) + -(-(512 - cu[-1]) // 16) <= geo["tile_grid"][0]


PLANS = [(128, 64, 16, 32, 8), (40, 64, 16, 32, 8), (6, 16, 5, 8, 2),
         (24, 64, 6, 32, 2)]


@pytest.mark.parametrize("mb,bs,rows,h,kv", PLANS)
def test_gang_and_ragged_decode_share_one_split_plan(monkeypatch, mb, bs,
                                                     rows, h, kv):
    monkeypatch.setattr(tpa, "sm_count", lambda device: 132)
    d = 64
    pool = torch.empty((8, bs, kv, d))
    tbl = torch.zeros((rows, mb), dtype=torch.int32)
    gang = tpa.call_plan(torch.empty((rows, 1, h, d)), pool, tbl)
    ragged = tpa.call_plan(torch.empty((3 * rows, h, d)), pool, tbl)
    geo = trpa.launch_geometry(3 * rows, h, kv, rows, mb, bs, 132)
    assert gang == ragged == (geo["sp"], geo["splits"])
    sp, splits = gang
    assert sp % bs == 0 and sp % 64 == 0 and splits * sp >= mb * bs
    # both take it from paged_attention.split_plan
    monkeypatch.setattr(tpa, "split_plan", lambda *a: (4096, 1))
    assert tpa.call_plan(torch.empty((rows, 1, h, d)), pool, tbl) == \
        (4096, 1)
    assert trpa.launch_geometry(3 * rows, h, kv, rows, mb, bs,
                                132)["sp"] == 4096
