#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA card (H100): build its CUDA
kernels, hold each against its plain PyTorch version, run packed (varlen)
attention forward and backward through the op registry, serve Llama-3-8B
(full width and depth, random weights from a seed) through the ragged
continuous-batching engine and ``generate(cache_type="paged")``, serve it
again quantized to int4 weights through the int4 GEMM kernel, multiply
block-pruned Llama-3-8B MLP weights through ``sparse.bcsr_matmul``, train
Llama-3-8B's width (8 layers) through ``TrainStep`` with AdamW and then
with Lamb, then train DeepSeek-MoE-16B's width (5 layers) the same way as
the first through the grouped-GEMM kernel.

    python3 chip_smoke.py [--seed N] [--report PATH]

Phases (any failure raises and the script exits non-zero):

1. card and build: the card's name and power limit (nvidia-smi), then
   every ``paddle_tpu_torch/csrc/*.cu`` compiled by nvcc, one process per
   source, all started together, timed;
2. serving kernel checks at the serving path's head geometry (H=32, KV=8,
   D=128, BS=64, a 512-token step over 16 rows mixing decode rows, prefill
   chunks at several offsets, empty rows and padding tokens): each kernel
   against its plain version (the ragged kernel over bf16 and int8 pools,
   and float32; the gang-decode kernel over bf16 and int8 pools), with
   planted faults, timed with CUDA events beside its bound and one
   PyTorch library call (``scaled_dot_product_attention`` over the
   gathered, dequantized dense KV, timed here only: the port never calls
   it);
3. training kernel checks at the training shapes (b 2, s 2048, 32/8 heads,
   d 128, causal; bf16 and float32): flash forward (out, lse), dq and
   dk/dv against the plain versions, with two planted faults that the
   limits must reject, each bf16 kernel launched twice for the same bytes,
   its TFLOP/s and share of the bound, and SDPA's own error against the
   plain version under the same limits; the fused AdamW kernel over one decoder layer plus
   the embedding (743M bf16 params, float32 masters) bit for bit against
   its plain version over three steps (plain; unscale and clip; found=1,
   which must keep every input); Lamb's two kernel passes with the trust
   ratios between them over the same bucket, bit for bit against the plain
   version over the same three steps, each part timed; each timed beside
   its bound and a library yardstick (SDPA forward and backward,
   ``torch._fused_adamw_``, also beside Lamb's first pass);
   the grouped GEMM at the MoE path's shapes (64 groups of capacity 480,
   K x N 2048 x 1408 and 1408 x 2048, counts with empty, partial and full
   groups; bf16 and float32; groups per expert 1 and 2; dx through the
   transposed view of w) against its plain version, with two planted
   faults (a zeroed live C tile, group g reading expert g mod E instead of
   g // 2), timed at the path's four launch shapes beside its bound and
   ``torch.bmm`` over the count-masked buffer; the int4 weight-only GEMM
   at Llama-3-8B's four (k, n) pairs and m 1, 4, 37 and 512, plus two
   shapes with tails in m, n and k, in bf16 and float32 x, against its
   plain version, with two planted faults (the nibbles swapped, no sign
   extension), timed at gate/up and down at m 512 and 4 beside its bound,
   ``torch.mm`` over the codes unpacked to bf16 and ``torch.matmul`` over
   the bf16 weight; block-CSR SpMM through ``sparse.bcsr_from_dense`` and
   ``sparse.bcsr_matmul``, a path of its own, over Llama-3-8B's
   ``gate_proj`` and ``down_proj`` weights block-pruned in 128 x 128 blocks
   (about half kept by a mask from the seed, two block rows empty) times
   the transposed activations of 4096 tokens, bf16 and float32, and 16 x
   128 blocks at a smaller size: exactly one launch per call, the kernel
   against its plain version, three planted faults (a column id off by
   one, a run cut by one block, an empty row left unwritten), times beside
   the bound, ``torch.matmul`` over the zero-filled weight and torch's BSR
   product;
3b. packed (varlen) attention, a main path of its own, at Llama-3-8B's
   attention width (32/8 heads, d 128) over 16384 tokens of documents
   whose lengths are drawn log-uniform over 32-4096 from the seed (the
   last cut to fill), causal: bf16 and float32 self packing and a bf16
   cross packing (k documents in reverse order), each forward and backward
   through ``call_op("flash_attn_unpadded")`` and ``loss.backward()`` with
   exactly one launch of each of the three varlen kernels per call (counts
   reset before); then each kernel against its plain version (out, lse,
   dq, dk, dv), planted faults made with the plain formulation (segment
   mask dropped, lse one token off, causal bottom-right under cross
   packing), two launches of each bf16 kernel for the same bytes, the
   tiles walked and the share the mask skips, and times (with TFLOP/s and
   the share of the bound) beside the bound from the live pairs, the plain
   version, one library call (``varlen_attn`` where the installed torch
   has it, else masked SDPA; its own error against the plain version
   too) and the padded flash kernels over the same documents padded to
   batch x longest;
4. serving, the first main path: 16 requests through
   ``ContinuousBatchingEngine`` with a bf16 pool, again with an int8 pool,
   again with speculative decoding, then one paged ``generate()`` call;
   then one over an int8 pool (each ``generate()`` exactly one gang-decode
   launch per layer and decode step), all with the serving kernels' plain
   versions made to raise on a CUDA tensor; both serving kernels' launch
   counts must rise, every request must
   finish with in-vocabulary tokens, the bf16 run's peak memory must stay
   at slice 1's, and the model's last-position logits through the kernels
   must agree with the plain path's. Last, two more runs (bf16 and int8
   pools) each profile one prefill step and three decode steps with
   torch.profiler (device time by kernel and by part); their launches
   are not counted;
4b. int4 serving, after the serving model is freed: the same model from
   the same seed, its bf16 logits of one prompt, then
   ``quantize_for_inference(model, "weight_only_int4")`` on the card
   (timed; model bytes before and after); the int4 logits through the
   kernel against the plain route (``FLAGS_use_pallas_kernels`` off) and,
   without a limit, against bf16; the same 16 requests with a bf16 pool,
   with exactly 224 int4 GEMM launches per engine step (counts reset just
   before), greedy agreement with the bf16 run's tokens; a paged
   ``generate()``; a profiled run with the int4 GEMM as its own part;
5. training, the second main path, after the serving model is freed:
   ``LlamaForCausalLM`` at Llama-3-8B width with 8 layers (2.80 B params,
   bf16, float32 masters), ``LlamaPretrainingCriterion``,
   ``AdamW(lr 1e-4, weight_decay 0.01, ClipGradByGlobalNorm(1.0))``
   through ``TrainStep`` on an LCG-scrambled batch of 2 x 2048 tokens: the
   loss and layer-0 grads through the kernels vs the plain versions, then
   2 warm-up and 10 timed steps (tokens/s, step p50/p99, MFU as bench.py
   defines it, peak memory, every loss, which must be finite and fall),
   the four training kernels' launch counts (reset just before), one
   profiled step (device time by kernel and by part of the step), and a
   GradScaler step with a poisoned grad, which must be skipped with the
   params bitwise unchanged; then, with the AdamW optimizer gone, the
   same model trained on with ``Lamb(lr 1e-4, lamb_weight_decay 0.01,
   ClipGradByGlobalNorm(1.0), 1-D params excluded from decay)``: 2
   warm-up and 10 timed steps with the same metrics, exactly two Lamb
   launches per bucket per step and no AdamW launch, one profiled step;
6. MoE training, the third main path, after the Llama model is freed:
   ``MoEForCausalLM`` at DeepSeek-MoE-16B width (hidden 2048, 16 heads,
   64 routed experts of width 1408, 6 per token, 2 shared, the first layer
   dense) with 5 layers (2.855 B params, bf16), ``MoEPretrainingCriterion``
   and the same optimizer, step and batch: the loss and the first MoE
   layer's expert and router grads through the grouped-GEMM kernel vs its
   plain version (that layer's routing must be equal), then 2 warm-up and
   10 timed steps (tokens/s, step p50/p99, MFU over the active params,
   peak memory, every loss), exactly 24 grouped-GEMM launches per step,
   the choices dropped by capacity and each MoE layer's min/max counts,
   and one profiled step with the grouped GEMM as its own part.

Output: findings on earlier lines, then the ``kernels`` JSON line
(fourteen kernels), then as the last line ``{"ok": true, "device":
{...}}``. Exits
non-zero, printing no result, when no CUDA device is present or the
package is missing. A longer report goes to ``--report`` (default
``chiprun_out/chip_smoke_report.json``).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import itertools
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
BF16_FLOPS_PER_S = 989e12        # dense bf16 tensor-core peak, same source
F32_FLOPS_PER_S = 67e12          # float32 outside the tensor cores

# kernel vs plain tolerances: both accumulate in float32 and round the
# output once, so they differ by summation order (~1e-6 relative) and, in
# bf16, by at most one ulp of the final rounding (at most 2^-7 = 0.78% of
# |value|, within rtol 1e-2; atol 2e-3 covers outputs near 0, where the
# float32 sums cancel). Measured on an H100: max abs err 9.8e-4 (bf16),
# 2.0e-3 (int8 pool), 6e-7 (f32). planted_faults() shows every run that
# this limit rejects a kernel that skips one 64-position chunk or reads
# one wrong block.
TOL = {"bfloat16": dict(atol=2e-3, rtol=1e-2),
       "float32": dict(atol=1e-4, rtol=1e-4)}
# last-position logits of the 32-layer bf16 model, kernel path vs plain
# path: per-layer bf16 roundings of the attention output differ (one ulp)
# and compound through 32 random layers (measured on an H100: max abs err
# 0.23, cosine 0.9992, logit std 1.28); 0.5 is ~40% of the logits'
# spread, and the two vectors must point the same way
LOGITS_ATOL, LOGITS_MIN_COS = 0.5, 0.995
SERVE_PEAK_GIB = 23.12   # the bf16 serving run's peak before this slice
SERVING_KERNELS = ("ragged_paged_attention", "paged_attention")
TRAINING_KERNELS = ("flash_attention_fwd", "flash_attention_dq",
                    "flash_attention_dkv", "fused_optimizer")


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        else f"nvidia-smi failed: {out.stderr.strip()}"


def time_ms(torch, fn, iters: int = 10, flush=None) -> float:
    """Median CUDA-event time of ``fn()``; ``flush()`` (outside the timed
    window) evicts the L2 before each run, as a cold pool read would."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        if flush is not None:
            flush()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def bound(bytes_moved: int, flops: int, flops_rate: float):
    tb = bytes_moved / HBM_BYTES_PER_S * 1e3
    to = flops / flops_rate * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


# -- phase 2: kernel checks --------------------------------------------------

# (q_len, context_len) per row of the checked step: 10 decode rows, prefill
# chunks at offsets 0, 256, 1024 and 1900, two empty rows; 498 of 512
# tokens used, so 14 are step padding
SMOKE_ROWS = [(1, 130), (1, 513), (1, 777), (1, 1024), (1, 1500),
              (1, 2047), (1, 2100), (1, 64), (1, 1), (1, 900),
              (256, 256), (128, 384), (64, 1088), (40, 1940), (0, 0), (0, 0)]
SMOKE_T, SMOKE_NB, SMOKE_MB, SMOKE_BS = 512, 1024, 128, 64
H, KV, D = 32, 8, 128


def smoke_layout(torch, rng, dtype, dev="cuda"):
    R = len(SMOKE_ROWS)
    qlens = [q for q, _ in SMOKE_ROWS]
    ctxs = [c for _, c in SMOKE_ROWS]
    cu = np.concatenate([[0], np.cumsum(qlens)]).astype(np.int32)
    tbl = np.zeros((R, SMOKE_MB), np.int32)
    perm = rng.permutation(SMOKE_NB)
    nxt = 0
    for r, c in enumerate(ctxs):
        n = -(-c // SMOKE_BS)
        tbl[r, :n] = perm[nxt:nxt + n]   # entries past the context stay 0
        nxt += n
    g = torch.Generator(device=dev).manual_seed(int(rng.randint(1 << 30)))
    shape = (SMOKE_NB, SMOKE_BS, KV, D)
    q = torch.randn((SMOKE_T, H, D), generator=g, device=dev).to(dtype)
    kp = torch.randn(shape, generator=g, device=dev).to(dtype)
    vp = torch.randn(shape, generator=g, device=dev).to(dtype)
    put = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    return (q, kp, vp, put(tbl), put(np.asarray(ctxs, np.int32)), put(cu))


def dense_sdpa_inputs(torch, q, kp, vp, tbl, ctx, cu, ks=None, vs=None):
    """Padded dense tensors for one scaled_dot_product_attention call over
    the rows with query tokens: q [R', H, maxq, D], k/v [R', H, maxL, D]
    (kv heads repeated), bool mask [R', 1, maxq, maxL]."""
    cu_l, ctx_l = cu.tolist(), ctx.tolist()
    rows = [r for r in range(len(ctx_l)) if cu_l[r + 1] > cu_l[r]]
    maxq = max(cu_l[r + 1] - cu_l[r] for r in rows)
    maxl = max(ctx_l[r] for r in rows)
    Rp, G = len(rows), H // KV
    dt = q.dtype
    qd = torch.zeros((Rp, H, maxq, D), dtype=dt, device=q.device)
    kd = torch.zeros((Rp, H, maxl, D), dtype=dt, device=q.device)
    vd = torch.zeros_like(kd)
    mask = torch.zeros((Rp, 1, maxq, maxl), dtype=torch.bool,
                       device=q.device)
    bs = kp.shape[1]
    for i, r in enumerate(rows):
        ql, L = cu_l[r + 1] - cu_l[r], ctx_l[r]
        qd[i, :, :ql] = q[cu_l[r]:cu_l[r + 1]].transpose(0, 1)
        blocks = tbl[r, :-(-L // bs)].long()
        k = kp[blocks].float()
        v = vp[blocks].float()
        if ks is not None:
            k = k * ks[blocks][..., None]
            v = v * vs[blocks][..., None]
        k = k.reshape(-1, KV, D)[:L].to(dt)
        v = v.reshape(-1, KV, D)[:L].to(dt)
        kd[i, :, :L] = k.repeat_interleave(G, dim=1).transpose(0, 1)
        vd[i, :, :L] = v.repeat_interleave(G, dim=1).transpose(0, 1)
        qpos = L - ql + torch.arange(ql, device=q.device)
        mask[i, 0, :ql, :L] = (torch.arange(L, device=q.device)[None, :]
                               <= qpos[:, None])
        mask[i, 0, ql:, 0] = True          # padded query rows: one column
        if L == 0:
            mask[i, 0, :, 0] = True        # no context: keep SDPA finite
    return qd, kd, vd, mask


def check_close(torch, name, got, want, dtype_name, pad_from=None):
    tol = TOL[dtype_name]
    g, w = got.float(), want.float()
    if not torch.isfinite(g).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    err = (g - w).abs()
    lim = tol["atol"] + tol["rtol"] * w.abs()
    if bool((err > lim).any()):
        raise AssertionError(
            f"{name}: kernel differs from plain version: max abs err "
            f"{float(err.max())} (atol {tol['atol']}, rtol {tol['rtol']})")
    if pad_from is not None and bool((got[pad_from:] != 0).any()):
        raise AssertionError(f"{name}: step-padding tokens are not zero")
    return float(err.max())


def planted_faults(torch, name, plain, args, kw, want, lens_at, decode):
    """Two faults a kernel could make in the longest decode row (where
    outputs are smallest), produced with the plain version on altered
    inputs, must each fail ``check_close`` against ``want``: skipping the
    row's last 64-position chunk, and reading one wrong pool block halfway
    along its context. ``args[lens_at]`` is the context lengths,
    ``args[3]`` the block tables, ``decode`` a bool per row. Returns each
    fault's max abs err."""
    lens, tbl = args[lens_at], args[3]
    r = int(torch.where(decode, lens, torch.zeros_like(lens)).argmax())
    short = lens.clone()
    short[r] -= SMOKE_BS
    spare = sorted(set(range(SMOKE_NB)) - set(tbl.flatten().tolist()))[-1]
    wrong = tbl.clone()
    wrong[r, int(lens[r]) // SMOKE_BS // 2] = spare
    errs = {}
    for fault, i, t in (("drop_last_chunk", lens_at, short),
                        ("wrong_block", 3, wrong)):
        bad = plain(*args[:i], t, *args[i + 1:], **kw)
        try:
            check_close(torch, name, bad, want, "bfloat16")
        except AssertionError:
            errs[fault] = float((bad.float() - want.float()).abs().max())
            continue
        raise AssertionError(f"{name}: the tolerance passes a planted "
                             f"fault ({fault})")
    return errs


def phase_kernels(torch, seed, report):
    from paddle_tpu_torch.ops.kernels import paged_attention as pa
    from paddle_tpu_torch.ops.kernels import ragged_paged_attention as rpa
    from paddle_tpu_torch.ops.kernels.quant_common import (
        absmax_scale, quantize_symmetric)
    import torch.nn.functional as F

    rng = np.random.RandomState(seed)
    scratch = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    flush = lambda: scratch.zero_()  # noqa: E731  (> 50 MB L2)
    out = {}

    # ragged kernel, bf16 / int8 / float32 pools
    q, kp, vp, tbl, ctx, cu = smoke_layout(torch, rng, torch.bfloat16)
    pad_from = int(cu[-1])
    used = {}
    for label in ("bfloat16", "int8", "float32"):
        if label == "int8":
            ks, vs = absmax_scale(kp, -1), absmax_scale(vp, -1)
            kq = quantize_symmetric(kp, ks[..., None])
            vq = quantize_symmetric(vp, vs[..., None])
            args = (q, kq, vq, tbl, ctx, cu)
            kw = dict(k_scale=ks, v_scale=vs)
            kv_item, quant = 1, True
        elif label == "float32":
            args = (q.float(), kp.float(), vp.float(), tbl, ctx, cu)
            kw, kv_item, quant = {}, 4, False
        else:
            args = (q, kp, vp, tbl, ctx, cu)
            kw, kv_item, quant = {}, 2, False
        got = rpa.ragged_paged_attention(*args, **kw)
        torch.cuda.synchronize()
        want = rpa.ragged_paged_attention_plain(*args, **kw)
        err = check_close(torch, f"ragged[{label}]", got, want,
                          "float32" if label == "float32" else "bfloat16",
                          pad_from)
        faults = planted_faults(
            torch, f"ragged[{label}]", rpa.ragged_paged_attention_plain,
            args, kw, want, 4, (cu[1:] - cu[:-1]) == 1) \
            if label == "bfloat16" else None
        ms = time_ms(torch, lambda: rpa.ragged_paged_attention(*args, **kw),
                     flush=flush)
        plain_ms = time_ms(
            torch, lambda: rpa.ragged_paged_attention_plain(*args, **kw),
            iters=3, flush=flush)
        dq, dk, dv, mask = dense_sdpa_inputs(
            torch, args[0], args[1], args[2], tbl, ctx, cu,
            kw.get("k_scale"), kw.get("v_scale"))
        lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
            dq, dk, dv, attn_mask=mask), flush=flush)
        del dq, dk, dv, mask
        q_item = args[0].element_size()
        nbytes = (2 * args[0].numel() * q_item
                  + rpa.kv_bytes_read(ctx, cu, SMOKE_BS, KV, D, kv_item,
                                      quant)
                  + 4 * (tbl.numel() + ctx.numel() + cu.numel()))
        flops = rpa.attention_flops(ctx, cu, H, D)
        b_ms, b_by = bound(nbytes, flops, F32_FLOPS_PER_S
                           if label == "float32" else BF16_FLOPS_PER_S)
        used[label] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                           bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                           bytes=nbytes, flops=flops)
        if faults:
            used[label]["planted_fault_max_abs_err"] = faults
        log(f"ragged_paged_attention[{label}]: max_abs_err {err:.3e} "
            f"ms {ms:.4f} plain_ms {plain_ms:.3f} library_ms {lib_ms:.4f} "
            f"bound_ms {b_ms:.4f} ({b_by})"
            + (f", planted faults rejected: {faults}" if faults else ""))
    out["ragged_paged_attention"] = used

    # gang-decode kernel, bf16: 16 rows, one with context 0
    ctxs = np.array([c for _, c in SMOKE_ROWS], np.int32)
    ctxs[-1] = 0
    ctxs[-2] = 333
    B = len(ctxs)
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    qd = torch.randn((B, 1, H, D), generator=g, device="cuda").to(
        torch.bfloat16)
    lens = torch.from_numpy(ctxs).cuda()
    tbl_d = tbl.clone()
    tbl_d[-2, :6] = torch.arange(SMOKE_NB - 6, SMOKE_NB, dtype=torch.int32,
                                 device="cuda")
    args = (qd, kp, vp, tbl_d, lens)
    got = pa.paged_attention(*args)
    torch.cuda.synchronize()
    want = pa.paged_attention_plain(*args)
    err = check_close(torch, "paged_attention[bfloat16]", got, want,
                      "bfloat16")
    if bool((got[-1] != 0).any()):
        raise AssertionError("paged_attention: context_len 0 row not zero")
    faults = planted_faults(torch, "paged_attention[bfloat16]",
                            pa.paged_attention_plain, args, {}, want, 4,
                            lens > 0)
    ms = time_ms(torch, lambda: pa.paged_attention(*args), flush=flush)
    plain_ms = time_ms(torch, lambda: pa.paged_attention_plain(*args),
                       iters=3, flush=flush)
    cu1 = torch.arange(B + 1, dtype=torch.int32, device="cuda")
    keep = lens > 0
    sq, sk, sv, mask = dense_sdpa_inputs(torch, qd[:, 0], kp, vp, tbl_d, lens,
                                         cu1)
    lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
        sq, sk, sv, attn_mask=mask), flush=flush)
    del sq, sk, sv, mask
    nbytes = (2 * qd.numel() * 2
              + rpa.kv_bytes_read(lens, cu1, SMOKE_BS, KV, D, 2, False)
              + 4 * (tbl_d.numel() + B))
    flops = rpa.attention_flops(lens, cu1, H, D)
    b_ms, b_by = bound(nbytes, flops, BF16_FLOPS_PER_S)
    out["paged_attention"] = {"bfloat16": dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=lib_ms, bytes=nbytes, flops=flops,
        rows_with_context=int(keep.sum()), planted_fault_max_abs_err=faults)}
    log(f"paged_attention[bfloat16]: max_abs_err {err:.3e} ms {ms:.4f} "
        f"plain_ms {plain_ms:.3f} library_ms {lib_ms:.4f} "
        f"bound_ms {b_ms:.4f} ({b_by}), planted faults rejected: {faults}")

    # gang-decode kernel over an int8 pool: the same rows and blocks, the
    # pool quantized per token slot as the serving cache writes it
    ks, vs = absmax_scale(kp, -1), absmax_scale(vp, -1)
    args = (qd, quantize_symmetric(kp, ks[..., None]),
            quantize_symmetric(vp, vs[..., None]), tbl_d, lens)
    kw = dict(k_scale=ks, v_scale=vs)
    got = pa.paged_attention(*args, **kw)
    torch.cuda.synchronize()
    want = pa.paged_attention_plain(*args, **kw)
    err = check_close(torch, "paged_attention[int8]", got, want, "bfloat16")
    if bool((got[-1] != 0).any()):
        raise AssertionError("paged_attention[int8]: context_len 0 row not "
                             "zero")
    faults = planted_faults(torch, "paged_attention[int8]",
                            pa.paged_attention_plain, args, kw, want, 4,
                            lens > 0)
    ms = time_ms(torch, lambda: pa.paged_attention(*args, **kw), flush=flush)
    plain_ms = time_ms(torch, lambda: pa.paged_attention_plain(*args, **kw),
                       iters=3, flush=flush)
    # yardstick, timed here only: SDPA over the dequantized pool
    sq, sk, sv, mask = dense_sdpa_inputs(torch, qd[:, 0], args[1], args[2],
                                         tbl_d, lens, cu1, ks, vs)
    lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
        sq, sk, sv, attn_mask=mask), flush=flush)
    del sq, sk, sv, mask
    nbytes = (2 * qd.numel() * 2
              + rpa.kv_bytes_read(lens, cu1, SMOKE_BS, KV, D, 1, True)
              + 4 * (tbl_d.numel() + B))
    b_ms, b_by = bound(nbytes, flops, BF16_FLOPS_PER_S)
    out["paged_attention"]["int8"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=lib_ms, bytes=nbytes, flops=flops,
        planted_fault_max_abs_err=faults)
    log(f"paged_attention[int8]: max_abs_err {err:.3e} ms {ms:.4f} "
        f"plain_ms {plain_ms:.3f} library_ms {lib_ms:.4f} (SDPA over the "
        f"dequantized pool) bound_ms {b_ms:.4f} ({b_by}), planted faults "
        f"rejected: {faults}")
    del scratch
    report["kernels"] = out
    return out


# -- phase 3: the main path --------------------------------------------------

def make_requests(cfg, seed: int, n: int = 16, shared_prefix: int = 512):
    """n prompts of 128..2048 tokens from the seed; the last one shares
    the first ``shared_prefix`` tokens of the first (a prefix-cache hit)."""
    rng = np.random.RandomState(seed)
    lens = rng.randint(128, 2049, size=n)
    lens[0] = max(lens[0], shared_prefix + 64)
    prompts = [rng.randint(0, cfg.vocab_size, size=int(L)).astype(np.int32)
               for L in lens]
    prompts[-1] = np.concatenate(
        [prompts[0][:shared_prefix], prompts[-1][shared_prefix:]]
        if len(prompts[-1]) > shared_prefix else
        [prompts[0][:shared_prefix], prompts[-1]])
    return prompts


def device_activity(prof):
    """The device's own activities (kernels, copies, sets) of a profile:
    ``(name, start_us, end_us)``. CPU ops and the GPU-side annotations
    that span an op's kernels are left out, so nothing counts twice."""
    out = []
    for ev in prof.events():
        if str(ev.device_type).endswith("CPU") or \
                getattr(ev, "is_user_annotation", False) or \
                "annotation" in str(getattr(ev, "activity_type", "")).lower():
            continue
        tr = ev.time_range
        if tr.end > tr.start:
            out.append((ev.name, tr.start, tr.end))
    return out


def profile_call(torch, fn, n: int):
    """Run ``fn()`` under torch.profiler: device time by kernel (top 8,
    plus ``all_kernels``, every kernel's ms), device busy time (the union
    of the device's activity intervals), wall time and the busy share,
    each per ``n`` units of work (engine or train steps). If the profiler
    itself fails to start, stop or parse, the window is recorded as not
    measured; a failure of ``fn`` raises as anywhere else."""
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    try:
        prof.start()
    except Exception as e:   # profiler set-up only
        prof, why = None, f"{type(e).__name__}: {e}"
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if prof is None:
        return {"not_measured": why}
    try:
        prof.stop()
        acts = device_activity(prof)
    except Exception as e:   # trace collection and parsing only
        return {"not_measured": f"{type(e).__name__}: {e}"}
    if not acts:
        return {"not_measured": "profiler recorded no device time",
                "wall_ms": 1e3 * wall}
    by_name = {}
    for name, a, b in acts:
        ms, calls = by_name.get(name, (0.0, 0))
        by_name[name] = (ms + (b - a) / 1e3, calls + 1)
    busy_us, end = 0.0, float("-inf")
    for _, a, b in sorted(acts, key=lambda x: x[1]):
        if b > end:
            busy_us += b - max(a, end)
            end = b
    busy = busy_us / 1e3
    span = (max(b for _, _, b in acts) - min(a for _, a, _ in acts)) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    return {"steps": n, "wall_ms": 1e3 * wall, "device_busy_ms": busy,
            "device_busy_ms_per_step": busy / n,
            "device_span_ms": span, "busy_share_of_span": busy / span,
            "busy_share_of_wall": busy / (1e3 * wall),
            "top": [{"kernel": k[:90], "ms": ms, "calls": c}
                    for k, (ms, c) in top],
            "all_kernels": {k: ms for k, (ms, _) in by_name.items()}}


def profile_steps(torch, eng, n, outs):
    """``n`` engine steps under the profiler (see :func:`profile_call`)."""
    def run():
        for _ in range(n):
            for req in eng.step():
                outs[req.rid] = list(req.out_tokens)
    prof = profile_call(torch, run, n)
    if "all_kernels" in prof:
        prof["by_part_ms"] = categorize(prof.pop("all_kernels"),
                                        prof["device_busy_ms"])
    return prof


def serve(torch, model, prompts, new_tokens, profile=False, **engine_kw):
    """Run the engine over ``prompts`` (the last one arrives after four
    steps, once the first one's shared prefix is in the prefix cache).
    Returns (outputs by rid, metrics). With ``profile``, two windows run
    under the profiler (their steps stay out of the step percentiles, but
    the run's wall time and TTFT include them: profile in a run of its
    own)."""
    from paddle_tpu_torch.models import ContinuousBatchingEngine
    eng = ContinuousBatchingEngine(
        model, max_batch=16, block_size=64, token_budget=512,
        prefill_chunk=256, kv_pool_bytes=8 << 30, temperature=0.0,
        **engine_kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for p in prompts[:-1]:
        eng.add_request(p, max_new_tokens=new_tokens)
    step_s = []
    late = False
    outs = {}
    profiles = {}
    while eng.pending or eng.num_active or not late:
        if not late and (eng.steps >= 4
                         or not (eng.pending or eng.num_active)):
            eng.add_request(prompts[-1], max_new_tokens=new_tokens)
            late = True
        # profiled windows (their steps stay out of the step percentiles):
        # the second step (prefill chunks of every row) and, once every
        # row decodes, three decode steps
        decoding = late and not eng.pending and all(
            r.ctx >= r.target for r in eng.slots if r is not None)
        window = ("prefill" if eng.steps == 1 else
                  "decode" if decoding and eng.num_active == len(prompts)
                  else None)
        if profile and window and window not in profiles:
            profiles[window] = profile_steps(
                torch, eng, 1 if window == "prefill" else 3, outs)
            continue
        ts = time.perf_counter()
        for req in eng.step():
            outs[req.rid] = list(req.out_tokens)
        step_s.append(time.perf_counter() - ts)
    wall = time.perf_counter() - t0
    reqs = [eng.results[r] for r in sorted(eng.results)]
    ttft = [r.t_first - r.t_arrive for r in reqs]
    tpot = [(r.t_done - r.t_first) / (len(r.out_tokens) - 1) for r in reqs
            if len(r.out_tokens) > 1]
    gen = sum(len(r.out_tokens) for r in reqs)
    m = dict(requests=len(reqs), generated_tokens=gen,
             prompt_tokens=int(sum(len(p) for p in prompts)),
             wall_s=wall, tokens_per_s=gen / wall, steps=eng.steps,
             step_ms_p50=1e3 * float(np.percentile(step_s, 50)),
             step_ms_p99=1e3 * float(np.percentile(step_s, 99)),
             ttft_ms_p50=1e3 * float(np.percentile(ttft, 50)),
             ttft_ms_p99=1e3 * float(np.percentile(ttft, 99)),
             tpot_ms_p50=1e3 * float(np.percentile(tpot, 50)),
             tpot_ms_p99=1e3 * float(np.percentile(tpot, 99)),
             peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
             num_blocks=eng.cache.k[0].shape[0],
             kv_dtype=eng.cache.kv_dtype, stats=dict(eng.stats),
             profile=profiles)
    for rid, toks in outs.items():
        if len(toks) != new_tokens:
            raise AssertionError(f"request {rid} emitted {len(toks)} of "
                                 f"{new_tokens} tokens")
        if min(toks) < 0 or max(toks) >= model.config.vocab_size:
            raise AssertionError(f"request {rid}: token out of vocabulary")
    if len(outs) != len(prompts):
        raise AssertionError(f"{len(outs)} of {len(prompts)} finished")
    del eng
    torch.cuda.empty_cache()
    return outs, m


def prompt_logits(torch, model, prompt, kv="bf16", cache_cls=None):
    """Last-position float32 logits of one prompt, prefilled through a
    fresh paged cache (``cache_cls``, default ``PagedKVCache``)."""
    from paddle_tpu_torch.models.generation import PagedKVCache
    cfg = model.config
    mb = -(-len(prompt) // 64)
    cache = (cache_cls or PagedKVCache)(
        cfg.num_hidden_layers, 1, num_blocks=mb, block_size=64,
        num_kv_heads=cfg.num_key_value_heads,
        head_dim=cfg.hidden_size // cfg.num_attention_heads,
        max_blocks_per_seq=mb, dtype=cfg.dtype, kv_dtype=kv, device="cuda")
    ids = torch.from_numpy(prompt[None]).cuda()
    return model(ids, cache=cache, start_pos=0)[0, -1].float()


def cosine(torch, a, b) -> float:
    return float(torch.nn.functional.cosine_similarity(a, b, dim=0))


def logits_check(torch, model, prompt):
    """Last-position logits of one prompt through the kernels and through
    the plain attention, both on the card, with a bf16 and with an int8
    pool; and how far the int8 pool moves the logits from the bf16 one."""
    from paddle_tpu_torch.models.generation import PagedKVCache
    from paddle_tpu_torch.ops.kernels import ragged_paged_attention as rpa

    class PlainCache(PagedKVCache):
        def attend(self, layer, q, pos=None):
            tables, lens, cu = self._dev_meta
            b, s, h, d = q.shape
            return rpa.ragged_paged_attention_plain(
                q.reshape(b * s, h, d), self.k[layer], self.v[layer], tables,
                lens, cu, **self.scale_kwargs(layer)).reshape(b, s, h, d)

    out, logits = {}, {}
    for kv in ("bf16", "int8"):
        a, b = (prompt_logits(torch, model, prompt, kv, cls)
                for cls in (PagedKVCache, PlainCache))
        if not bool(torch.isfinite(a).all()):
            raise AssertionError(f"kernel-path logits ({kv}) are not finite")
        err, cos = float((a - b).abs().max()), cosine(torch, a, b)
        if err > LOGITS_ATOL or cos < LOGITS_MIN_COS:
            raise AssertionError(
                f"logits ({kv} pool): kernel vs plain path max abs err {err} "
                f"(atol {LOGITS_ATOL}), cosine {cos}")
        out[kv] = dict(max_abs_err=err, cosine=cos, std=float(b.std()),
                       argmax_equal=bool(a.argmax() == b.argmax()))
        logits[kv] = a
    a, b = logits["int8"], logits["bf16"]
    out["int8_vs_bf16"] = dict(max_abs_err=float((a - b).abs().max()),
                               cosine=cosine(torch, a, b),
                               argmax_equal=bool(a.argmax() == b.argmax()))
    return out


def agree(a, b, first=False):
    """Share of greedy tokens of run ``a`` equal to run ``b``'s, over all
    positions or over the first token of each request."""
    pairs = [(x, y) for r in a for x, y in zip(a[r][:1 if first else None],
                                               b[r])]
    return sum(x == y for x, y in pairs) / len(pairs)


@contextlib.contextmanager
def no_plain_on_card():
    """The serving kernels' plain versions raise when a CUDA tensor reaches
    them: on the card the serving path launches the kernels."""
    from paddle_tpu_torch.ops.kernels import paged_attention as pa
    from paddle_tpu_torch.ops.kernels import ragged_paged_attention as rpa
    slots = [(pa, "paged_attention_plain"),
             (pa, "ragged_paged_attention_plain"),
             (rpa, "ragged_paged_attention_plain")]
    saved = [getattr(m, name) for m, name in slots]

    def guard(name, fn):
        def call(q, *args, **kw):
            if q.is_cuda:
                raise AssertionError(f"{name}, the plain version, ran on the "
                                     f"card on the serving path")
            return fn(q, *args, **kw)
        return call
    for (m, name), fn in zip(slots, saved):
        setattr(m, name, guard(name, fn))
    try:
        yield
    finally:
        for (m, name), fn in zip(slots, saved):
            setattr(m, name, fn)


def phase_main(torch, seed, report):
    from paddle_tpu_torch import flags
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.ops import kernels

    cfg = LlamaConfig.llama3_8b()
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    model = LlamaForCausalLM(cfg, device="cuda", generator=gen)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"model: Llama-3-8B geometry, {cfg.num_hidden_layers} layers, "
        f"{n_params / 1e9:.3f} B parameters (bf16, normal std 0.02 from "
        f"seed {seed}) built in {time.perf_counter() - t0:.1f} s")
    prompts = make_requests(cfg, seed)
    main = {}

    def counted_serve(**kw):
        """serve(), with the kernel launches it made and their count per
        engine step (read off the counters without resetting them)."""
        before = kernels.launch_counts()
        outs, m = serve(torch, model, prompts, 64, **kw)
        m["launches"] = {k: n - before[k]
                         for k, n in kernels.launch_counts().items()}
        m["launches_per_step"] = {k: n / m["steps"]
                                  for k, n in m["launches"].items()}
        return outs, m

    kernels.reset_launch_counts()
    with no_plain_on_card():
        outs_bf16, main["bf16"] = counted_serve()
        # trainable params must not make serving build an autograd graph:
        # the bf16 run's peak stays at slice 1's (23.12 GiB on an H100)
        if main["bf16"]["peak_mem_gib"] > SERVE_PEAK_GIB * 1.05:
            raise AssertionError(f"serving peak "
                                 f"{main['bf16']['peak_mem_gib']} GiB is "
                                 f"over slice 1's {SERVE_PEAK_GIB} GiB")
        if main["bf16"]["stats"]["prefix_hit_blocks"] <= 0:
            raise AssertionError("the shared-prefix request did not hit the "
                                 "prefix cache")
        outs_int8, main["int8"] = counted_serve(kv_dtype="int8")
        outs_spec, main["spec_k4"] = counted_serve(speculative_k=4)
        ids = torch.from_numpy(np.stack([p[:128] for p in prompts[:4]])) \
            .cuda()
        for kv in ("bf16", "int8"):   # generate() over each pool dtype
            before = kernels.launch_counts()["paged_attention"]
            flags.set_flags({"kv_cache_dtype": kv})
            tg = time.perf_counter()
            try:
                out = model.generate(ids, max_new_tokens=16, temperature=0.0,
                                     cache_type="paged", block_size=64)
                torch.cuda.synchronize()
            finally:
                flags.set_flags({"kv_cache_dtype": "auto"})
            gang = kernels.launch_counts()["paged_attention"] - before
            main["generate" if kv == "bf16" else "generate_int8"] = dict(
                batch=4, prompt=128, new_tokens=16, kv_dtype=kv,
                wall_s=time.perf_counter() - tg, paged_attention_launches=gang)
            if tuple(out.shape) != (4, 144) or int(out.max()) >= \
                    cfg.vocab_size or int(out.min()) < 0:
                raise AssertionError(f"generate({kv}) returned "
                                     f"{tuple(out.shape)} or tokens out of "
                                     f"vocabulary")
            # one gang-decode launch per layer and decode step
            if gang != cfg.num_hidden_layers * 15:
                raise AssertionError(f"generate({kv}): {gang} paged_attention "
                                     f"launches, want "
                                     f"{cfg.num_hidden_layers * 15}")
    counts = kernels.launch_counts()
    main["launches"] = counts
    for name in SERVING_KERNELS:
        if counts[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 f"serving path")

    # greedy tokens against the bf16 run: all positions, and the first
    # token of each request (before one early flip changes the rest)
    main["greedy_token_agreement"] = dict(
        int8_vs_bf16=agree(outs_int8, outs_bf16),
        int8_vs_bf16_first=agree(outs_int8, outs_bf16, first=True),
        spec_vs_bf16=agree(outs_spec, outs_bf16))
    for k in ("bf16", "int8", "spec_k4"):
        m = main[k]
        log(f"serve[{k}]: {m['requests']} requests, "
            f"{m['prompt_tokens']} prompt + {m['generated_tokens']} "
            f"generated tokens in {m['wall_s']:.2f} s: "
            f"{m['tokens_per_s']:.1f} tok/s, step p50 "
            f"{m['step_ms_p50']:.1f} ms p99 {m['step_ms_p99']:.1f} ms, TTFT "
            f"p50 {m['ttft_ms_p50']:.0f} ms p99 {m['ttft_ms_p99']:.0f} ms, "
            f"TPOT p50 {m['tpot_ms_p50']:.1f} ms p99 {m['tpot_ms_p99']:.1f} "
            f"ms, peak {m['peak_mem_gib']:.2f} GiB, {m['num_blocks']} "
            f"blocks, launches {m['launches']} ({m['launches_per_step']} "
            f"per step), stats {m['stats']}")
    log(f"generate(paged): {main['generate']}; int8 pool: "
        f"{main['generate_int8']}")
    log(f"launches on the main path: {counts}")
    log(f"greedy agreement with the bf16 run: "
        f"{main['greedy_token_agreement']}")
    main["logits_check"] = logits_check(torch, model, prompts[1][:300])
    log(f"logits kernel vs plain: {main['logits_check']}")
    # last: profiled runs of their own (the profiler slows what follows)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CUDA]):
        torch.ones(1, device="cuda").add_(1)   # profiler warm-up
    for kv in ("bf16", "int8"):
        _, m = serve(torch, model, prompts, 64, profile=True,
                     kv_dtype=None if kv == "bf16" else "int8")
        main[f"profile_{kv}"] = m["profile"]
        for window, prof in m["profile"].items():
            log(f"profile[{kv}/{window}]: {json.dumps(prof)}")
    report["main"] = main
    return main, outs_bf16


# -- phase 3b: int4 weight-only serving ------------------------------------------

INT4_LINEARS = 7        # q, k, v, o, gate, up, down per decoder layer
# last-position logits of the int4 model, GEMM kernel route vs plain route
# (FLAGS_use_pallas_kernels off), both on the card and through the same
# attention kernels: each linear's bf16 output may differ by one ulp
# (float32 sums in another order), which compounds through 32 random layers
# as the attention kernels' ulps do in phase_main's check (measured on an
# H100: max abs err 0.26, cosine 0.9990, logit std 1.28); the same limits:
# 0.5 is ~40% of the logits' spread, and 1 - cosine may grow 5x. A wrong
# unpack moves them far more (int4 vs bf16 on these weights: cosine 0.15)
INT4_LOGITS_ATOL, INT4_LOGITS_MIN_COS = LOGITS_ATOL, LOGITS_MIN_COS


def model_bytes(model) -> int:
    """Bytes of the model's parameters and buffers (each tensor once)."""
    return sum(t.numel() * t.element_size()
               for t in list(model.parameters()) + list(model.buffers()))


def phase_int4_serve(torch, seed, report, outs_bf16):
    """Llama-3-8B from phase_main's seed, quantized to per-channel int4 on
    the card, served through the engine and generate()."""
    from paddle_tpu_torch import flags
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.nn.quant import (WeightOnlyLinear,
                                           quantize_for_inference)
    from paddle_tpu_torch.ops import kernels

    cfg = LlamaConfig.llama3_8b()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    model = LlamaForCausalLM(cfg, device="cuda", generator=gen)
    prompts = make_requests(cfg, seed)
    probe = prompts[1][:300]
    logits_bf16 = prompt_logits(torch, model, probe)
    res = {"bytes_before": model_bytes(model)}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    quantize_for_inference(model, "weight_only_int4")
    torch.cuda.synchronize()
    res.update(quantize_s=time.perf_counter() - t0,
               quantize_peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               bytes_after=model_bytes(model))
    torch.cuda.empty_cache()
    n_q = sum(isinstance(m, WeightOnlyLinear) for m in model.modules())
    if n_q != INT4_LINEARS * cfg.num_hidden_layers:
        raise AssertionError(f"{n_q} WeightOnlyLinear layers, want "
                             f"{INT4_LINEARS * cfg.num_hidden_layers}")
    log(f"int4: quantize_for_inference(weight_only_int4) of {n_q} linears "
        f"in {res['quantize_s']:.2f} s (peak {res['quantize_peak_gib']:.2f} "
        f"GiB); model {res['bytes_before'] / 1e9:.3f} GB -> "
        f"{res['bytes_after'] / 1e9:.3f} GB (parameters and buffers)")

    # logits: the kernel route against the plain route, and against bf16
    a = prompt_logits(torch, model, probe)
    flags.set_flags({"use_pallas_kernels": False})
    try:
        b = prompt_logits(torch, model, probe)
    finally:
        flags.set_flags({"use_pallas_kernels": True})
    if not bool(torch.isfinite(a).all()):
        raise AssertionError("int4 kernel-route logits are not finite")
    err, cos = float((a - b).abs().max()), cosine(torch, a, b)
    res["logits_kernel_vs_plain"] = dict(
        max_abs_err=err, cosine=cos, std=float(b.std()),
        argmax_equal=bool(a.argmax() == b.argmax()))
    if err > INT4_LOGITS_ATOL or cos < INT4_LOGITS_MIN_COS:
        raise AssertionError(
            f"int4 logits: kernel vs plain route max abs err {err} (atol "
            f"{INT4_LOGITS_ATOL}), cosine {cos}")
    res["logits_int4_vs_bf16"] = dict(
        max_abs_err=float((a - logits_bf16).abs().max()),
        cosine=cosine(torch, a, logits_bf16),
        argmax_equal=bool(a.argmax() == logits_bf16.argmax()))
    log(f"int4 logits kernel vs plain: {res['logits_kernel_vs_plain']}; "
        f"int4 vs bf16 (no limit: random weights): "
        f"{res['logits_int4_vs_bf16']}")
    del a, b, logits_bf16

    # serving: the path's counts read just before and just after
    kernels.reset_launch_counts()
    outs, m = serve(torch, model, prompts, 64)
    counts = kernels.launch_counts()
    m["launches"] = counts
    m["launches_per_step"] = {k: n / m["steps"] for k, n in counts.items()}
    want = INT4_LINEARS * cfg.num_hidden_layers * m["steps"]
    if counts["weight_only_int4_gemm"] != want:
        raise AssertionError(
            f"weight_only_int4_gemm launched {counts['weight_only_int4_gemm']}"
            f" times in {m['steps']} engine steps, want {want}")
    if counts["ragged_paged_attention"] <= 0:
        raise AssertionError("the ragged kernel was not launched")
    m["greedy_token_agreement_vs_bf16"] = dict(
        all=agree(outs, outs_bf16), first=agree(outs, outs_bf16, first=True))
    res["serve"] = m
    log(f"serve[int4]: {m['requests']} requests, {m['prompt_tokens']} prompt "
        f"+ {m['generated_tokens']} generated tokens in {m['wall_s']:.2f} s: "
        f"{m['tokens_per_s']:.1f} tok/s, step p50 {m['step_ms_p50']:.1f} ms "
        f"p99 {m['step_ms_p99']:.1f} ms, TTFT p50 {m['ttft_ms_p50']:.0f} ms "
        f"p99 {m['ttft_ms_p99']:.0f} ms, TPOT p50 {m['tpot_ms_p50']:.1f} ms "
        f"p99 {m['tpot_ms_p99']:.1f} ms, peak {m['peak_mem_gib']:.2f} GiB, "
        f"{m['num_blocks']} blocks, {m['steps']} steps, launches {counts} "
        f"({m['launches_per_step']['weight_only_int4_gemm']:.0f} int4 GEMM "
        f"per step); greedy agreement with the bf16 run "
        f"{m['greedy_token_agreement_vs_bf16']}")

    ids = torch.from_numpy(np.stack([p[:128] for p in prompts[:4]])).cuda()
    before = kernels.launch_counts()["weight_only_int4_gemm"]
    tg = time.perf_counter()
    out = model.generate(ids, max_new_tokens=16, temperature=0.0,
                         cache_type="paged", block_size=64)
    torch.cuda.synchronize()
    res["generate"] = dict(
        batch=4, prompt=128, new_tokens=16, wall_s=time.perf_counter() - tg,
        int4_gemm_launches=kernels.launch_counts()["weight_only_int4_gemm"]
        - before)
    if tuple(out.shape) != (4, 144) or int(out.max()) >= cfg.vocab_size \
            or int(out.min()) < 0 or res["generate"]["int4_gemm_launches"] \
            <= 0:
        raise AssertionError(f"int4 generate(): {tuple(out.shape)}, "
                             f"{res['generate']}")
    log(f"generate(paged, int4): {res['generate']}")
    # last: a profiled run of its own (the profiler slows what follows)
    _, mp = serve(torch, model, prompts, 64, profile=True)
    res["profile"] = mp["profile"]
    for window, prof in mp["profile"].items():
        log(f"profile[int4/{window}]: {json.dumps(prof)}")
    del model
    torch.cuda.empty_cache()
    report["int4_serve"] = res
    return res


# -- phase 4: training-path kernels -------------------------------------------

# dynamic shared memory of the bf16 attention kernels, as flash_wgmma.cuh
# sizes it: 64-row bf16 tiles (forward: Q and two stages of K and V; dq and
# dk/dv: two own tiles and two stages of two), per-stage column words and
# 1024 B of alignment slack
TC_TILES = {"fwd": (5, 2), "dq": (6, 2), "dkv": (6, 4)}


def tc_smem_bytes(kind: str, d: int) -> int:
    tiles, words = TC_TILES[kind]
    return tiles * 64 * d * 2 + 2 * words * 64 * 4 + 1024


def ptxas_tc_kernels(txt: str):
    """Registers and spills of each bf16 attention kernel in nvcc's
    ``-Xptxas -v`` report, with its dynamic shared memory."""
    rows, name = [], None
    for line in txt.splitlines():
        m = re.search(r"Compiling entry function '\w*?((?:flash|varlen)_tc_"
                      r"(fwd|dq|dkv))ILi(\d+)E", line)
        if m:
            name = dict(kernel=f"{m.group(1)}<{m.group(3)}>",
                        smem_bytes=tc_smem_bytes(m.group(2),
                                                 int(m.group(3))))
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            name.update(spill_stores=int(m.group(1)),
                        spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            name["registers"] = int(m.group(1))
            rows.append(name)
            name = None
    return rows


def bitwise_twice(torch, name, fn):
    """Two launches of a kernel give the same bytes (no atomics, a fixed
    order of sums)."""
    a, b = fn(), fn()
    torch.cuda.synchronize()
    a, b = (a if isinstance(a, tuple) else (a,)), \
        (b if isinstance(b, tuple) else (b,))
    if not all(torch.equal(x, y) for x, y in zip(a, b)):
        raise AssertionError(f"{name}: two launches give different bytes")
    return True


def library_errors(torch, dtype_name, out, grads, want_out, want_grads):
    """The library call's own error against the plain version, under the
    kernels' limits: reported, not enforced (the library is a yardstick).
    It shows what a tensor-core kernel with a single bf16 P gets."""
    tol = TOL[dtype_name]
    w = want_out.float()
    err = (out.float() - w).abs()
    res = dict(out_max_abs_err=float(err.max()),
               out_over_limit=int((err > tol["atol"] + tol["rtol"] * w.abs())
                                  .sum()))
    for n, a, b in zip(("dq", "dk", "dv"), grads, want_grads):
        res[f"{n}_rel_err"] = rel_err(torch, a, b)
    res["within_limits"] = res["out_over_limit"] == 0 and all(
        res[f"{n}_rel_err"] <= GRAD_REL_TOL[dtype_name]
        for n in ("dq", "dk", "dv"))
    return res


def achieved(ms, flops, bound_ms):
    """TFLOP/s of the products each kernel needs (forward 2, dq 3, dk/dv 4
    of the forward's flops / 2) and the share of the bound reached."""
    need = {"fwd": flops, "dq": 3 * flops // 2, "dkv": 2 * flops}
    return {kern: dict(tflops=need[kern] / (ms[kern] * 1e-3) / 1e12,
                       bound_share=bound_ms[kern] / ms[kern])
            for kern in ms}


TRAIN_B, TRAIN_S = 2, 2048
TRAIN_LAYERS = 8       # Llama-3-8B width; 32 layers of params, grads, masters
#                        and moments (16 B/param) would need ~128 GB
# flash kernel vs plain: both accumulate in float32 and round once, so a
# bf16 output or grad differs by at most one bf16 ulp (0.39% of its own
# magnitude, so at most 0.39% of the tensor's max): grads are judged by
# max error relative to the tensor's max, 1e-2 in bf16, 1e-4 in float32
# (summation order only); lse is float32 in both, atol 1e-4 + rtol 1e-5.
# planted_flash_faults() shows every run that these limits reject a
# forward that skips one causal tile and a backward that drops one kv tile.
GRAD_REL_TOL = {"bfloat16": 1e-2, "float32": 1e-4}
LSE_TOL = dict(atol=1e-4, rtol=1e-5)
# the 8-layer bf16 model's loss and layer-0 grads through the kernels vs
# through the plain versions, same weights and batch: per-layer one-ulp
# differences of the attention output compound through 8 random layers
# (measured on the H100: 1.1e-4 and 0.99972; the limits are ~10x and ~4x
# those gaps)
LOSS_ATOL, GRAD_MIN_COS = 1e-3, 0.999


def rel_err(torch, got, want) -> float:
    g, w = got.float(), want.float()
    if not bool(torch.isfinite(g).all()):
        return float("inf")
    return float((g - w).abs().max() / w.abs().max().clamp_min(1e-30))


def flash_work(b, h, kv, sq, sk, d, item, causal=True):
    """(forward flops, forward bytes, dq bytes, dk/dv bytes): the minimum
    work, each input read once and each output written once; causal counts
    only the (query, key) pairs the right-aligned mask keeps."""
    coff = sk - sq
    pairs = sum(min(sk, i + coff + 1) for i in range(sq)) if causal \
        else sq * sk
    return attn_work(b * pairs, b * sq, b * sk, h, kv, d, item)


def attn_work(pairs, nq, nk, h, kv, d, item):
    """(forward flops, forward bytes, dq bytes, dk/dv bytes) of attention
    over ``pairs`` live (query, key) pairs per head, ``nq`` query and
    ``nk`` key rows: each input read once, each output written once."""
    flops = 4 * h * pairs * d
    qb, kb = nq * h * d * item, nk * kv * d * item
    lse = h * nq * 4
    return (flops,
            2 * qb + 2 * kb + lse,       # q k v -> out, lse
            3 * qb + 2 * kb + 2 * lse,   # q k v dO lse delta -> dq
            2 * qb + 4 * kb + 2 * lse)   # q k v dO lse delta -> dk dv


def planted_flash_faults(torch, fa, q, k, v, scale, want, grads):
    """Two faults a kernel could make, produced with the plain version:
    a forward that skips the diagonal 64-key tile of the last q tile (its
    rows then attend keys [0, S-64) only), and a dk/dv that drops the
    middle 64-key tile (zeros). Each must fail the limits above."""
    S = q.shape[1]
    bad = want.clone()
    bad[:, S - 64:] = fa.flash_fwd_plain(q[:, S - 64:], k[:, :S - 64],
                                         v[:, :S - 64], False, scale)[0]
    errs = {}
    try:
        check_close(torch, "flash_fwd", bad, want, "bfloat16")
        raise AssertionError("flash_fwd: the tolerance passes a planted "
                             "fault (skipped causal tile)")
    except AssertionError as e:
        if "planted" in str(e):
            raise
        errs["skip_causal_tile"] = float((bad.float() - want.float())
                                         .abs().max())
    mid = S // 2
    for name, g in zip(("dk", "dv"), grads[1:]):
        bad = g.clone()
        bad[:, mid:mid + 64] = 0
        err = rel_err(torch, bad, g)
        if err <= GRAD_REL_TOL["bfloat16"]:
            raise AssertionError(f"flash {name}: the tolerance passes a "
                                 f"planted fault (dropped kv tile)")
        errs[f"drop_kv_tile_{name}"] = err
    return errs


def phase_flash(torch, seed, report, flush):
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    import torch.nn.functional as F

    g = torch.Generator(device="cuda").manual_seed(seed + 2)
    out = {}
    B, S = TRAIN_B, TRAIN_S
    scale = D ** -0.5
    for label, dt in (("bfloat16", torch.bfloat16),
                      ("float32", torch.float32)):
        mk = lambda n: torch.randn((B, S, n, D), generator=g,  # noqa: E731
                                   device="cuda").to(dt)
        q, k, v, dout = mk(H), mk(KV), mk(KV), mk(H)
        o, lse = fa.flash_fwd_kernel(q, k, v, True, scale)
        torch.cuda.synchronize()
        wo, wl = fa.flash_fwd_plain(q, k, v, True, scale)
        e_out = check_close(torch, f"flash_fwd[{label}]", o, wo, label)
        e_out_rel = rel_err(torch, o, wo)
        e_lse = float((lse - wl).abs().max())
        if bool(((lse - wl).abs() > LSE_TOL["atol"]
                 + LSE_TOL["rtol"] * wl.abs()).any()):
            raise AssertionError(f"flash_fwd[{label}]: lse differs by "
                                 f"{e_lse}")
        delta = (dout.float() * wo.float()).sum(-1).transpose(1, 2) \
            .contiguous()
        dq = fa.flash_dq_kernel(q, k, v, dout, wl, delta, True, scale)
        dk, dv = fa.flash_dkv_kernel(q, k, v, dout, wl, delta, True, scale)
        torch.cuda.synchronize()
        ref = fa.flash_bwd_plain(q, k, v, dout, wl, delta, True, scale)
        errs, abs_errs = {}, {}
        for name, a, b in zip(("dq", "dk", "dv"), (dq, dk, dv), ref):
            errs[name] = rel_err(torch, a, b)
            abs_errs[name] = float((a.float() - b.float()).abs().max())
            if errs[name] > GRAD_REL_TOL[label]:
                raise AssertionError(
                    f"flash {name}[{label}]: kernel differs from plain "
                    f"version: max err {errs[name]} of the tensor's max "
                    f"(limit {GRAD_REL_TOL[label]})")
        faults = planted_flash_faults(torch, fa, q, k, v, scale, wo, ref) \
            if label == "bfloat16" else None
        bitwise = label == "bfloat16" and all((
            bitwise_twice(torch, "flash_fwd", lambda: fa.flash_fwd_kernel(
                q, k, v, True, scale)),
            bitwise_twice(torch, "flash_dq", lambda: fa.flash_dq_kernel(
                q, k, v, dout, wl, delta, True, scale)),
            bitwise_twice(torch, "flash_dkv", lambda: fa.flash_dkv_kernel(
                q, k, v, dout, wl, delta, True, scale))))
        del o, lse, dq, dk, dv
        ms = {
            "fwd": time_ms(torch, lambda: fa.flash_fwd_kernel(
                q, k, v, True, scale), flush=flush),
            "dq": time_ms(torch, lambda: fa.flash_dq_kernel(
                q, k, v, dout, wl, delta, True, scale), flush=flush),
            "dkv": time_ms(torch, lambda: fa.flash_dkv_kernel(
                q, k, v, dout, wl, delta, True, scale), flush=flush)}
        plain = {
            "fwd": time_ms(torch, lambda: fa.flash_fwd_plain(
                q, k, v, True, scale), iters=3, flush=flush),
            "bwd": time_ms(torch, lambda: fa.flash_bwd_plain(
                q, k, v, dout, wl, delta, True, scale), iters=3,
                flush=flush)}
        # yardsticks, timed here only: SDPA forward, and its backward
        # alone (one autograd call over a kept graph: dq, dk, dv together)
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                      for x in (q, k, v))
        lib_fwd = time_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), flush=flush)
        lo = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                            enable_gqa=True)
        dout_t = dout.transpose(1, 2)
        lib_bwd = time_ms(torch, lambda: torch.autograd.grad(
            lo, (qt, kt, vt), dout_t, retain_graph=True), flush=flush)
        lib_err = library_errors(
            torch, label, lo.detach().transpose(1, 2),
            [x.transpose(1, 2) for x in torch.autograd.grad(
                lo, (qt, kt, vt), dout_t)], wo, ref)
        del lo, qt, kt, vt, ref
        flops, b_fwd, b_dq, b_dkv = flash_work(B, H, KV, S, S, D,
                                               q.element_size())
        rate = BF16_FLOPS_PER_S if label == "bfloat16" else F32_FLOPS_PER_S
        # minimum backward = five products (2.5x the forward's flops): dq
        # owns the dq product, dk/dv owns the recomputed s, dp, dk, dv
        bounds = {"fwd": bound(b_fwd, flops, rate),
                  "dq": bound(b_dq, flops // 2, rate),
                  "dkv": bound(b_dkv, 2 * flops, rate)}
        abs_errs["fwd"], errs["fwd"] = e_out, e_out_rel
        abs_errs["dkv"] = max(abs_errs["dk"], abs_errs["dv"])
        errs["dkv"] = max(errs["dk"], errs["dv"])
        rates = achieved(ms, flops, {n: b[0] for n, b in bounds.items()})
        res = {}
        for kern in ("fwd", "dq", "dkv"):
            res[kern] = dict(
                max_abs_err=abs_errs[kern], max_rel_err=errs[kern],
                ms=ms[kern], plain_ms=plain["fwd" if kern == "fwd"
                                            else "bwd"],
                bound_ms=bounds[kern][0], bound_by=bounds[kern][1],
                library_ms=lib_fwd if kern == "fwd" else lib_bwd,
                **rates[kern])
        res["fwd"]["lse_max_abs_err"] = e_lse
        res["fwd"]["flops"] = flops
        res["grad_errs"] = errs
        res["library_errs"] = lib_err
        res["bitwise_run_to_run"] = bitwise
        if faults:
            res["planted_fault_errs"] = faults
        out[label] = res
        log(f"flash[{label}] b{B} s{S} h{H}/{KV} d{D} causal: out max_abs_err "
            f"{e_out:.3e} lse {e_lse:.2e} rel errs {errs}; ms fwd "
            f"{ms['fwd']:.3f} dq {ms['dq']:.3f} dkv {ms['dkv']:.3f}; "
            f"TFLOP/s (share of bound) "
            + ", ".join(f"{n} {r['tflops']:.1f} ({r['bound_share']:.3f})"
                        for n, r in rates.items())
            + f"; plain fwd {plain['fwd']:.2f} bwd {plain['bwd']:.2f}; "
            f"library fwd {lib_fwd:.3f} bwd {lib_bwd:.3f}, its own errors "
            f"vs plain {lib_err}; bound fwd {bounds['fwd'][0]:.4f} dq "
            f"{bounds['dq'][0]:.4f} dkv {bounds['dkv'][0]:.4f} "
            f"({bounds['fwd'][1]})"
            + ("; two launches of each kernel give the same bytes"
               if bitwise else "")
            + (f"; planted faults rejected: {faults}" if faults else ""))
        del q, k, v, dout, wo, wl, delta
    report["kernels"]["flash_attention"] = out
    return out


# -- phase 3b: packed (varlen) attention through the op registry -------------

VARLEN_T = 16384                 # packed tokens: a batch of 8 x 2048
VARLEN_LEN = (32, 4096)          # document lengths, log-uniform, last one cut
VARLEN_KERNELS = ("flash_varlen_fwd", "flash_varlen_dq", "flash_varlen_dkv")
VARLEN_LABELS = ("bfloat16", "float32", "cross_bfloat16")


def varlen_lengths(rng, total=VARLEN_T, lo=VARLEN_LEN[0], hi=VARLEN_LEN[1]):
    """Document lengths drawn log-uniform in [lo, hi] until they fill
    ``total`` tokens; the last document is cut to fill exactly."""
    lens = []
    while sum(lens) < total:
        lens.append(int(np.exp(rng.uniform(np.log(lo), np.log(hi)))))
    lens[-1] -= sum(lens) - total
    return lens


def varlen_pairs(lq, lk) -> int:
    """Live (query, key) pairs of causal attention packed by segments, the
    mask top-left in each: sum over segments and query positions p of
    min(p + 1, len_k)."""
    return sum(sum(min(p + 1, b) for p in range(a)) for a, b in zip(lq, lk))


def varlen_library(torch, q, k, v, cu, max_len):
    """One PyTorch call for the same function, timed here only: the
    installed torch's ``torch.nn.attention.varlen.varlen_attn`` for bf16
    (flash attention takes no float32), else ``scaled_dot_product_attention``
    over [1, h, T, d] with a block-diagonal causal bool mask on the
    memory-efficient backend (kv heads repeated outside the call). Returns
    (name, differentiable inputs, call)."""
    import inspect
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    G = q.shape[1] // k.shape[1]
    try:
        from torch.nn.attention.varlen import varlen_attn
        params = inspect.signature(varlen_attn).parameters
    except ImportError:
        params = {}
    if q.dtype == torch.bfloat16 and ("window_size" in params
                                      or "is_causal" in params):
        kw = dict(window_size=(-1, 0)) if "window_size" in params \
            else dict(is_causal=True)
        if "enable_gqa" in params:
            kw["enable_gqa"] = True
        else:
            k, v = (x.repeat_interleave(G, dim=1) for x in (k, v))
        ins = [x.detach().requires_grad_() for x in (q, k, v)]
        return ("torch.nn.attention.varlen.varlen_attn", ins,
                lambda: varlen_attn(*ins, cu, cu, max_len, max_len, **kw))
    seg = torch.searchsorted(cu, torch.arange(q.shape[0], device=q.device,
                                              dtype=cu.dtype), right=True)
    pos = torch.arange(q.shape[0], device=q.device)
    mask = (seg[:, None] == seg[None, :]) & (pos[None, :] <= pos[:, None])
    ins = [x.transpose(0, 1)[None].detach().requires_grad_()
           for x in (q, k.repeat_interleave(G, dim=1),
                     v.repeat_interleave(G, dim=1))]

    def call():
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            return F.scaled_dot_product_attention(*ins, attn_mask=mask)
    return ("scaled_dot_product_attention (efficient, block-diagonal causal "
            "mask, kv heads repeated)", ins, call)


def varlen_tiles(torch, lay):
    """(64 x 64 tiles the q blocks walk, the share of them that the bf16
    kernels' causal segment mask calls interior: one segment on both
    sides, every key at or before every query)."""
    qb = lay.q_bounds.long()
    runs = (qb[1] - qb[0] + 1).clamp_min(0)
    i = torch.repeat_interleave(torch.arange(len(runs), device=qb.device),
                                runs)
    first = torch.cumsum(runs, 0) - runs
    j = qb[0][i] + torch.arange(len(i), device=qb.device) - first[i]
    sq, pq = lay.segq.view(-1, 64), lay.posq.view(-1, 64)
    sk, pk = lay.segk.view(-1, 64), lay.posk.view(-1, 64)
    inner = (sq[i, 0] == sq[i, 63]) & (sk[j, 0] == sk[j, 63]) \
        & (sq[i, 0] == sk[j, 0]) & (pk[j, 63] <= pq[i, 0])
    return int(len(i)), float(inner.float().mean()) if len(i) else 0.0


def planted_varlen_faults(torch, fv, fa, q, k, v, cuq, cuk, lq, lk, scale,
                          want, want_lse, lse, dtype_name):
    """Faults a varlen kernel could make, produced with the plain
    formulation, each of which must fail the limits: the segment mask
    dropped (one causal segment over all tokens: documents leak into each
    other), causal aligned bottom-right in each segment instead of
    top-left (only cross packing tells the two apart), and lse read one
    token off. Returns each fault's max abs err."""
    errs = {}

    def must_fail(fault, bad, ref, check):
        try:
            check(bad)
        except AssertionError:
            errs[fault] = float((bad.float() - ref.float()).abs().max())
            return
        raise AssertionError(f"flash_varlen: the tolerance passes a planted "
                             f"fault ({fault})")

    out_ok = lambda bad: check_close(  # noqa: E731
        torch, "flash_varlen_fwd", bad, want, dtype_name)
    if lq == lk:
        whole = torch.tensor([0, q.shape[0]], dtype=torch.int32,
                             device=q.device)
        must_fail("segment_mask_dropped",
                  fv.flash_varlen_fwd_plain(q, k, v, whole, whole, True,
                                            scale)[0], want, out_ok)
        shifted = lse.clone()
        shifted[:, 1:] = lse[:, :-1]

        def lse_ok(bad):
            if bool(((bad - want_lse).abs() > LSE_TOL["atol"]
                     + LSE_TOL["rtol"] * want_lse.abs()).any()):
                raise AssertionError("lse differs")
        must_fail("lse_one_token_off", shifted, want_lse, lse_ok)
    else:
        bad = torch.zeros_like(want)
        cq, ck = cuq.tolist(), cuk.tolist()
        for i in range(len(lq)):
            if lq[i] and lk[i]:
                bad[cq[i]:cq[i + 1]] = fa.flash_fwd_plain(
                    q[None, cq[i]:cq[i + 1]], k[None, ck[i]:ck[i + 1]],
                    v[None, ck[i]:ck[i + 1]], True, scale)[0][0]
        must_fail("causal_bottom_right", bad, want, out_ok)
    return errs


def phase_flash_varlen(torch, seed, report, flush):
    """Packed attention at Llama-3-8B's attention width (32/8 heads, d 128)
    over 16384 tokens of documents from ``varlen_lengths``: forward and
    backward through ``call_op("flash_attn_unpadded")`` with the launches
    counted (1 forward, 1 dq, 1 dk/dv per call), each kernel against its
    plain version, planted faults, and times beside the bound, the plain
    version, one library call and the padded flash kernels."""
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.ops.dispatcher import call_op
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.ops.kernels import flash_varlen as fv

    rng = np.random.RandomState(seed + 5)
    lens = varlen_lengths(rng)
    cases = zip(VARLEN_LABELS, (torch.bfloat16, torch.float32,
                                torch.bfloat16), (lens, lens, lens[::-1]))
    g = torch.Generator(device="cuda").manual_seed(seed + 5)
    scale = D ** -0.5
    out, launched = {"lengths": lens}, {n: 0 for n in VARLEN_KERNELS}
    for label, dt, lk in cases:
        dname = "bfloat16" if dt == torch.bfloat16 else "float32"
        mk = lambda n: torch.randn((VARLEN_T, n, D), generator=g,  # noqa: E731
                                   device="cuda").to(dt)
        q, k, v, dout = mk(H), mk(KV), mk(KV), mk(H)
        cuq = torch.tensor(np.cumsum([0] + lens), dtype=torch.int32,
                           device="cuda")
        cuk = cuq if lk is lens else torch.tensor(
            np.cumsum([0] + lk), dtype=torch.int32, device="cuda")
        max_len = max(max(lens), max(lk))

        # the main path: the op, then loss.backward(), counts reset before
        ins = [x.detach().requires_grad_() for x in (q, k, v)]
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        o_main = call_op("flash_attn_unpadded", *ins, cuq, cuk, max_len,
                         max_len, 0.0, True)
        loss = (o_main.float() * dout.float()).sum()
        loss.backward()
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        want_counts = {n: int(n in VARLEN_KERNELS) for n in counts}
        if counts != want_counts:
            raise AssertionError(f"flash_attn_unpadded[{label}]: launches "
                                 f"{counts}, want one of each varlen kernel")
        for n in VARLEN_KERNELS:
            launched[n] += counts[n]
        grads_main = [x.grad for x in ins]
        del ins, loss

        # each kernel against its plain version (comparison launches)
        tok = lk is lens
        lay = fv.varlen_layout(cuq, cuk, VARLEN_T, VARLEN_T, tok)
        o, lse = fv.flash_varlen_fwd(q, k, v, lay, True, scale)
        torch.cuda.synchronize()
        if not torch.equal(o, o_main.detach()):
            raise AssertionError(f"flash_varlen[{label}]: the op's output "
                                 f"differs from the forward kernel's")
        wo, wl = fv.flash_varlen_fwd_plain(q, k, v, cuq, cuk, True, scale)
        e_out = check_close(torch, f"flash_varlen_fwd[{label}]", o, wo, dname)
        e_out_rel = rel_err(torch, o, wo)
        e_lse = float((lse - wl).abs().max())
        if bool(((lse - wl).abs() > LSE_TOL["atol"]
                 + LSE_TOL["rtol"] * wl.abs()).any()):
            raise AssertionError(f"flash_varlen_fwd[{label}]: lse differs "
                                 f"by {e_lse}")
        delta = (dout.float() * wo.float()).sum(-1).transpose(0, 1) \
            .contiguous()
        dq = fv.flash_varlen_dq(q, k, v, dout, wl, delta, lay, True, scale)
        dk, dv = fv.flash_varlen_dkv(q, k, v, dout, wl, delta, lay, True,
                                     scale)
        torch.cuda.synchronize()
        ref = fv.flash_varlen_bwd_plain(q, k, v, dout, wl, delta, cuq, cuk,
                                        True, scale)
        errs, abs_errs = {}, {}
        for name, a, b, m in zip(("dq", "dk", "dv"), (dq, dk, dv), ref,
                                 grads_main):
            errs[name] = rel_err(torch, a, b)
            abs_errs[name] = float((a.float() - b.float()).abs().max())
            errs[f"{name}_main"] = rel_err(torch, m, b)
            if max(errs[name], errs[f"{name}_main"]) > GRAD_REL_TOL[dname]:
                raise AssertionError(
                    f"flash_varlen {name}[{label}]: kernel differs from "
                    f"plain version: max err {errs[name]} (the op's "
                    f"{errs[name + '_main']}) of the tensor's max (limit "
                    f"{GRAD_REL_TOL[dname]})")
        faults = planted_varlen_faults(torch, fv, fa, q, k, v, cuq, cuk,
                                       lens, lk, scale, wo, wl, lse, dname) \
            if dt == torch.bfloat16 else None
        bitwise = dt == torch.bfloat16 and all((
            bitwise_twice(torch, "flash_varlen_fwd",
                          lambda: fv.flash_varlen_fwd(q, k, v, lay, True,
                                                      scale)),
            bitwise_twice(torch, "flash_varlen_dq",
                          lambda: fv.flash_varlen_dq(
                              q, k, v, dout, wl, delta, lay, True, scale)),
            bitwise_twice(torch, "flash_varlen_dkv",
                          lambda: fv.flash_varlen_dkv(
                              q, k, v, dout, wl, delta, lay, True, scale))))
        del o_main, grads_main, o, dq, dk, dv

        pairs = varlen_pairs(lens, lk)
        flops, b_fwd, b_dq, b_dkv = attn_work(pairs, VARLEN_T, VARLEN_T, H,
                                              KV, D, q.element_size())
        rate = BF16_FLOPS_PER_S if dt == torch.bfloat16 else F32_FLOPS_PER_S
        bounds = {"fwd": bound(b_fwd, flops, rate),
                  "dq": bound(b_dq, flops // 2, rate),
                  "dkv": bound(b_dkv, 2 * flops, rate)}
        run = lambda f, *a: time_ms(torch, lambda: f(*a), flush=flush)  # noqa
        ms = {"fwd": run(fv.flash_varlen_fwd, q, k, v, lay, True, scale),
              "dq": run(fv.flash_varlen_dq, q, k, v, dout, wl, delta, lay,
                        True, scale),
              "dkv": run(fv.flash_varlen_dkv, q, k, v, dout, wl, delta, lay,
                         True, scale)}
        plain = {"fwd": run(fv.flash_varlen_fwd_plain, q, k, v, cuq, cuk,
                            True, scale),
                 "bwd": run(fv.flash_varlen_bwd_plain, q, k, v, dout, wl,
                            delta, cuq, cuk, True, scale)}
        lib_name, lib_in, lib_call = varlen_library(torch, q, k, v, cuq,
                                                    max_len) \
            if tok else (None, None, None)
        lib, lib_err = {}, None
        if lib_call is not None:
            lib["fwd"] = time_ms(torch, lib_call, flush=flush)
            lo = lib_call()
            ct = dout if lo.dim() == 3 else dout.transpose(0, 1)[None]
            lib["bwd"] = time_ms(torch, lambda: torch.autograd.grad(
                lo, lib_in, ct, retain_graph=True), flush=flush)
            # back to [T, heads, d]; kv heads repeated outside the call
            # sum their group's grads
            packed = lambda x, n: (x[0].transpose(0, 1) if x.dim() == 4  # noqa
                                   else x).unflatten(1, (n, -1)).sum(2)
            lgrads = torch.autograd.grad(lo, lib_in, ct)
            lib_err = library_errors(
                torch, dname, packed(lo.detach(), H),
                [packed(g_, n) for g_, n in zip(lgrads, (H, KV, KV))], wo,
                ref)
            del lo, lib_in, lib_call, lgrads
        del ref
        # the padded flash kernels over the same documents, b x max_len
        padded = {}
        if tok:
            B, S = len(lens), max(lens)
            pad = lambda x: torch.zeros(  # noqa: E731
                (B, S) + x.shape[1:], dtype=x.dtype, device=x.device)
            pq, pk, pv, pdo = pad(q), pad(k), pad(v), pad(dout)
            c = cuq.tolist()
            for i in range(B):
                for src, dst in ((q, pq), (k, pk), (v, pv), (dout, pdo)):
                    dst[i, :lens[i]] = src[c[i]:c[i + 1]]
            po, pl = fa.flash_fwd_kernel(pq, pk, pv, True, scale)
            pdel = (pdo.float() * po.float()).sum(-1).transpose(1, 2) \
                .contiguous()
            padded = {
                "shape": [B, S],
                "fwd": run(fa.flash_fwd_kernel, pq, pk, pv, True, scale),
                "dq": run(fa.flash_dq_kernel, pq, pk, pv, pdo, pl, pdel,
                          True, scale),
                "dkv": run(fa.flash_dkv_kernel, pq, pk, pv, pdo, pl, pdel,
                           True, scale)}
            del pq, pk, pv, pdo, po, pl, pdel
        abs_errs["fwd"], errs["fwd"] = e_out, e_out_rel
        abs_errs["dkv"] = max(abs_errs["dk"], abs_errs["dv"])
        errs["dkv"] = max(errs["dk"], errs["dv"])
        rates = achieved(ms, flops, {n: b[0] for n, b in bounds.items()})
        res = {}
        for kern in ("fwd", "dq", "dkv"):
            lib_ms = lib.get("fwd" if kern == "fwd" else "bwd")
            res[kern] = dict(
                max_abs_err=abs_errs[kern], max_rel_err=errs[kern],
                ms=ms[kern], plain_ms=plain["fwd" if kern == "fwd"
                                            else "bwd"],
                bound_ms=bounds[kern][0], bound_by=bounds[kern][1],
                library_ms=lib_ms, padded_flash_ms=padded.get(kern),
                **rates[kern])
        tiles, interior = varlen_tiles(torch, lay)
        res.update(lse_max_abs_err=e_lse, pairs=pairs, flops=flops,
                   tiles=tiles, interior_tile_share=interior,
                   library=lib_name, padded_shape=padded.get("shape"),
                   grad_errs=errs, planted_fault_errs=faults,
                   library_errs=lib_err, bitwise_run_to_run=bitwise)
        out[label] = res
        log(f"flash_varlen[{label}] T {VARLEN_T} ({len(lens)} docs, max "
            f"{max(lens)}) h{H}/{KV} d{D} causal: out max_abs_err "
            f"{e_out:.3e} lse {e_lse:.2e} rel errs "
            f"{ {n: round(e, 6) for n, e in errs.items()} }; launches per "
            f"call 1/1/1; ms fwd {ms['fwd']:.3f} dq {ms['dq']:.3f} dkv "
            f"{ms['dkv']:.3f}; TFLOP/s (share of bound) "
            + ", ".join(f"{n} {r['tflops']:.1f} ({r['bound_share']:.3f})"
                        for n, r in rates.items())
            + f"; plain fwd {plain['fwd']:.2f} bwd "
            f"{plain['bwd']:.2f}; bound fwd {bounds['fwd'][0]:.4f} dq "
            f"{bounds['dq'][0]:.4f} dkv {bounds['dkv'][0]:.4f} "
            f"({bounds['fwd'][1]}; {pairs} pairs, {tiles} tiles per head, "
            f"{interior:.3f} of them interior)"
            + (f"; library {lib_name}: fwd {lib['fwd']:.3f} bwd "
               f"{lib['bwd']:.3f}, its own errors vs plain {lib_err}"
               if lib else "")
            + ("; two launches of each kernel give the same bytes"
               if bitwise else "")
            + (f"; padded flash {padded['shape']}: fwd {padded['fwd']:.3f} "
               f"dq {padded['dq']:.3f} dkv {padded['dkv']:.3f}"
               if padded else "")
            + (f"; planted faults rejected: {faults}" if faults else ""))
        del q, k, v, dout, wo, wl, lse, delta, lay
        torch.cuda.empty_cache()
    out["launches"] = launched
    report["kernels"]["flash_varlen"] = out
    return out


def fused_bucket_tensors(torch, g, dev="cuda"):
    """One decoder layer's and the embedding's parameters at Llama-3-8B
    width: bf16 params, float32 masters and zero moments, bf16 grads."""
    from paddle_tpu_torch.models import LlamaConfig
    c = LlamaConfig.llama3_8b()
    hid, inter, vocab = c.hidden_size, c.intermediate_size, c.vocab_size
    kvd = c.num_key_value_heads * hid // c.num_attention_heads
    shapes = [(vocab, hid), (hid, hid), (hid, kvd), (hid, kvd), (hid, hid),
              (hid, inter), (hid, inter), (inter, hid), (hid,), (hid,)]
    lows = [(torch.randn(s, generator=g, device=dev) * 0.02).bfloat16()
            for s in shapes]
    masters = [p.float() for p in lows]
    states = [{"m": torch.zeros(s, device=dev), "v": torch.zeros(s,
                                                                 device=dev)}
              for s in shapes]
    grads = [(torch.randn(s, generator=g, device=dev) * 1e-3).bfloat16()
             for s in shapes]
    return masters, grads, states, lows


def phase_fused_optimizer(torch, seed, report, flush):
    from paddle_tpu_torch.ops.kernels import fused_optimizer as fo

    g = torch.Generator(device="cuda").manual_seed(seed + 3)
    cfg = {"b1": 0.9, "b2": 0.999, "eps": 1e-8, "decoupled": True}
    A = fused_bucket_tensors(torch, g)
    Bt = ([t.clone() for t in A[0]], A[1],
          [{k: t.clone() for k, t in s.items()} for s in A[2]],
          [t.clone() for t in A[3]])
    n = sum(t.numel() for t in A[0])
    one = torch.ones((), device="cuda")

    def svec(step, inv=1.0, coeff=1.0, found=0.0):
        st = one * step
        bc1, bc2 = fo.bias_inv(cfg["b1"], cfg["b2"], st)
        return fo.pack_scalars(lr=one * 1e-4, step=st, inv=one * inv,
                               coeff=one * coeff, found=one * found,
                               wd=one * 0.01, inv_bc1=bc1, inv_bc2=bc2)

    def flat(side):
        return side[0] + side[3] + [t for s in side[2] for t in s.values()]

    def same(tag):
        for a, b in zip(flat(A), flat(Bt)):
            if not torch.equal(a, b):
                raise AssertionError(
                    f"fused_optimizer ({tag}): kernel and plain version "
                    f"differ: {int((a != b).sum())} elements of a "
                    f"{tuple(a.shape)} tensor")

    steps = [("plain step", svec(1)),
             ("inv 1/64, coeff 0.5", svec(2, inv=1 / 64, coeff=0.5))]
    for tag, sv in steps:
        fo.fused_bucket_kernel("adam", cfg, *A, sv)
        torch.cuda.synchronize()
        fo.fused_bucket_plain("adam", cfg, *Bt, sv)
        same(tag)
    # found = 1: the kernel must leave every input as it was (Bt holds
    # them), and then the plain version too
    sv = svec(3, found=1.0)
    fo.fused_bucket_kernel("adam", cfg, *A, sv)
    torch.cuda.synchronize()
    same("found=1, kernel outputs vs inputs")
    fo.fused_bucket_plain("adam", cfg, *Bt, sv)
    same("found=1, plain")
    del Bt
    sv = svec(2, inv=1 / 64, coeff=0.5)
    # a bucket caches the chunk table (built by the warm-up call), so the
    # timed window holds the launch only, as on the training path
    bucket = fo.plan_buckets("adam", cfg, [
        (tuple(t.shape), "float32", "bfloat16", "bfloat16", 0.01)
        for t in A[0]]).buckets[0]
    ms = time_ms(torch, lambda: fo.fused_bucket_kernel(
        "adam", cfg, *A, sv, bucket), flush=flush)
    plain_ms = time_ms(torch, lambda: fo.fused_bucket_plain(
        "adam", cfg, *A, sv), iters=3, flush=flush)
    # yardstick, timed here only: torch's fused AdamW over the float32
    # masters, float32 copies of the grads and the moments; a near-equal
    # function (no bf16 write-back, no unscale/clip/sentinel channels)
    g32 = [x.float() for x in A[1]]
    steps_t = [one * 2 for _ in A[0]]
    lib_ms = time_ms(torch, lambda: torch._fused_adamw_(
        A[0], g32, [s["m"] for s in A[2]], [s["v"] for s in A[2]], [],
        steps_t, lr=1e-4, beta1=0.9, beta2=0.999, weight_decay=0.01,
        eps=1e-8, amsgrad=False, maximize=False), flush=flush)
    del g32, A
    nbytes = 28 * n
    b_ms, b_by = bound(nbytes, 20 * n, F32_FLOPS_PER_S)
    res = dict(max_abs_err=0.0, bitwise_equal=True, params=n, ms=ms,
               plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
               library_ms=lib_ms, bytes=nbytes,
               checked_steps=[t for t, _ in steps] + ["found=1"])
    log(f"fused_optimizer[adamw, {n / 1e6:.0f}M bf16 params, f32 masters]: "
        f"bitwise equal to plain over {res['checked_steps']}; ms {ms:.3f} "
        f"plain_ms {plain_ms:.2f} library_ms {lib_ms:.3f} "
        f"(torch._fused_adamw_, f32 grads, no write-back) bound_ms "
        f"{b_ms:.3f} ({b_by})")
    report["kernels"]["fused_optimizer"] = {"bfloat16": res}
    return res


LAMB_CFG = {"b1": 0.9, "b2": 0.999, "eps": 1e-6}


def phase_lamb_optimizer(torch, seed, report, flush):
    """Lamb's two kernel passes over the same 743M-param bucket as the
    AdamW check: pass 1, the trust ratios in torch, pass 2, bit for bit
    against the plain version over three steps (plain; unscale and clip;
    found = 1, which must keep every input), then each part timed."""
    from paddle_tpu_torch.ops.kernels import fused_optimizer as fo

    g = torch.Generator(device="cuda").manual_seed(seed + 6)
    A = fused_bucket_tensors(torch, g)
    Bt = ([t.clone() for t in A[0]], A[1],
          [{k: t.clone() for k, t in s.items()} for s in A[2]],
          [t.clone() for t in A[3]])
    n = sum(t.numel() for t in A[0])
    one = torch.ones((), device="cuda")

    def svec(step, inv=1.0, coeff=1.0, found=0.0):
        st = one * step
        bc1, bc2 = fo.bias_inv(LAMB_CFG["b1"], LAMB_CFG["b2"], st)
        return fo.pack_scalars(lr=one * 1e-4, step=st, inv=one * inv,
                               coeff=one * coeff, found=one * found,
                               wd=one * 0.01, inv_bc1=bc1, inv_bc2=bc2)

    def flat(side):
        return side[0] + side[3] + [t for s in side[2] for t in s.values()]

    def same(tag):
        for a, b in zip(flat(A), flat(Bt)):
            if not torch.equal(a, b):
                raise AssertionError(
                    f"lamb ({tag}): kernel and plain version differ: "
                    f"{int((a != b).sum())} elements of a {tuple(a.shape)} "
                    f"tensor")

    bucket = fo.plan_buckets("lamb", LAMB_CFG, [
        (tuple(t.shape), "float32", "bfloat16", "bfloat16", 0.01)
        for t in A[0]]).buckets[0]
    steps = [("plain step", svec(1)),
             ("inv 1/64, coeff 0.5", svec(2, inv=1 / 64, coeff=0.5))]
    for tag, sv in steps:
        fo.fused_bucket_kernel("lamb", LAMB_CFG, *A, sv, bucket)
        torch.cuda.synchronize()
        fo.fused_bucket_plain("lamb", LAMB_CFG, *Bt, sv)
        same(tag)
    sv = svec(3, found=1.0)
    fo.fused_bucket_kernel("lamb", LAMB_CFG, *A, sv, bucket)
    torch.cuda.synchronize()
    same("found=1, kernel outputs vs inputs")
    fo.fused_bucket_plain("lamb", LAMB_CFG, *Bt, sv)
    same("found=1, plain")
    del Bt
    torch.cuda.empty_cache()

    # times of each part (the bucket holds the chunk table and the
    # scratch, as on the training path)
    sv = svec(2, inv=1 / 64, coeff=0.5)
    scratch = fo.lamb_scratch(A[0], bucket)
    ms = {
        "moments": time_ms(torch, lambda: fo.launch_pass(
            "lamb_moments", "lamb", LAMB_CFG, *A, sv, bucket, scratch),
            flush=flush),
        "ratios": time_ms(torch, lambda: fo.lamb_trust_ratios(
            A[0], scratch[0], out=scratch[1]), flush=flush),
        "apply": time_ms(torch, lambda: fo.launch_pass(
            "lamb_apply", "lamb", LAMB_CFG, *A, sv, bucket, scratch),
            flush=flush),
        "step": time_ms(torch, lambda: fo.fused_bucket_kernel(
            "lamb", LAMB_CFG, *A, sv, bucket), flush=flush)}
    trs = fo.lamb_moments_plain(LAMB_CFG, A[0], A[1], A[2], sv)
    plain = {
        "moments": time_ms(torch, lambda: fo.lamb_moments_plain(
            LAMB_CFG, A[0], A[1], A[2], sv), iters=3, flush=flush),
        "apply": time_ms(torch, lambda: fo.lamb_apply_plain(
            A[0], trs, scratch[1], A[3], sv), iters=3, flush=flush)}
    del trs
    # yardstick, timed here only: no PyTorch call computes Lamb; the
    # nearest elementwise call is torch's fused AdamW over the same
    # masters, float32 copies of the grads and the moments (it stands
    # beside the first pass, which runs Adam's chain)
    g32 = [x.float() for x in A[1]]
    steps_t = [one * 2 for _ in A[0]]
    lib_ms = time_ms(torch, lambda: torch._fused_adamw_(
        A[0], g32, [s["m"] for s in A[2]], [s["v"] for s in A[2]], [],
        steps_t, lr=1e-4, beta1=0.9, beta2=0.999, weight_decay=0.01,
        eps=1e-6, amsgrad=False, maximize=False), flush=flush)
    del g32, A, scratch
    torch.cuda.empty_cache()
    # bytes per parameter, each input read once and each output written
    # once: pass 1 reads master 4, grad 2, m 4, v 4 and writes m 4, v 4,
    # tr_div 4; pass 2 reads master 4, tr_div 4 and writes master 4,
    # param 2; the whole step's inputs and outputs are 28 (row #5's rule)
    bounds = {"moments": bound(26 * n, 20 * n, F32_FLOPS_PER_S),
              "apply": bound(14 * n, 3 * n, F32_FLOPS_PER_S),
              "ratios": bound(8 * n, 4 * n, F32_FLOPS_PER_S),
              "step": bound(28 * n, 27 * n, F32_FLOPS_PER_S)}
    res = {}
    for kern, lib in (("moments", lib_ms), ("apply", None)):
        res[kern] = dict(max_abs_err=0.0, bitwise_equal=True, ms=ms[kern],
                         plain_ms=plain[kern], bound_ms=bounds[kern][0],
                         bound_by=bounds[kern][1], library_ms=lib)
    res.update(params=n, ratios_ms=ms["ratios"],
               ratios_bound_ms=bounds["ratios"][0], step_ms=ms["step"],
               step_bound_ms=bounds["step"][0],
               library="torch._fused_adamw_ (float32 grads, no write-back): "
                       "the nearest elementwise call, beside pass 1",
               checked_steps=[t for t, _ in steps] + ["found=1"])
    log(f"lamb[{n / 1e6:.0f}M bf16 params, f32 masters]: bitwise equal to "
        f"plain over {res['checked_steps']}; ms moments {ms['moments']:.3f} "
        f"ratios {ms['ratios']:.3f} apply {ms['apply']:.3f} (whole step "
        f"{ms['step']:.3f}); plain moments {plain['moments']:.2f} apply "
        f"{plain['apply']:.2f}; bound moments {bounds['moments'][0]:.3f} "
        f"ratios {bounds['ratios'][0]:.3f} apply {bounds['apply'][0]:.3f} "
        f"step {bounds['step'][0]:.3f} (bytes); library_ms {lib_ms:.3f} "
        f"(torch._fused_adamw_, the nearest elementwise call)")
    report["kernels"]["fused_optimizer_lamb"] = res
    return res


# -- phase 4b: the grouped GEMM ------------------------------------------------

# the MoE training path's shapes (DeepSeek-MoE-16B width, b 2 x s 2048 =
# 4096 tokens, 6 of 64 experts): G = E = 64 groups of capacity C =
# int(1.25 * 4096 * 6 / 64) = 480; (K, N) of the forward products, whose
# dx runs the transposed pairs through a strided view of w
MOE_E, MOE_C = 64, 480
GMM_SHAPES = {"gate_up": (2048, 1408), "down": (1408, 2048)}
GMM_TILE = 128    # the bf16 kernel's C tile (csrc/grouped_gemm.cu)


def moe_counts(rng, G, C):
    """Live rows per group as the path's routing gives them (mean t*k/E =
    384, clipped at C), with one empty group, one full group, one of a
    single row, and groups ending one row past and exactly at a C tile."""
    c = np.clip(np.rint(rng.normal(384, 64, G)), 0, C).astype(np.int32)
    c[:5] = [0, C, 1, GMM_TILE + 1, GMM_TILE]
    return c


def gmm_work(counts, G, C, K, N, E, item):
    """(flops, bytes) of one grouped product: the routed rows' products;
    the weights of every expert with a live row (the kernel reads none of
    an expert whose groups are empty), the live x rows and the whole y,
    each once."""
    live = int(counts.sum())
    experts = int((counts.reshape(E, -1).sum(1) > 0).sum())
    return (2 * live * K * N, experts * K * N * item + live * K * item
            + G * C * N * item + 4 * G)


def planted_gmm_faults(torch, gg, x, w, counts_t, want):
    """Two faults a kernel could make, produced with the plain version at
    groups per expert 2: one live C tile of a full group zeroed, and every
    group g reading expert g mod E instead of g // 2. Each must fail
    ``check_close``."""
    bad_tile = want.clone()
    bad_tile[1, GMM_TILE:2 * GMM_TILE] = 0
    bad_expert = gg.gmm_plain(x, w.repeat(2, 1, 1), counts_t, 1)
    errs = {}
    for fault, bad in (("zeroed_live_tile", bad_tile),
                       ("expert_g_not_g_div_gpe", bad_expert)):
        try:
            check_close(torch, "grouped_gemm", bad, want, "bfloat16")
        except AssertionError:
            errs[fault] = float((bad.float() - want.float()).abs().max())
            continue
        raise AssertionError(f"grouped_gemm: the tolerance passes a planted "
                             f"fault ({fault})")
    return errs


def phase_grouped_gemm(torch, seed, report, flush):
    from paddle_tpu_torch.ops.kernels import grouped_gemm as gg

    rng = np.random.RandomState(seed + 4)
    g = torch.Generator(device="cuda").manual_seed(seed + 4)
    G, C = MOE_E, MOE_C
    counts = moe_counts(rng, G, C)
    counts_t = torch.from_numpy(counts).cuda()
    dead = (torch.arange(C, device="cuda")[None, :]
            >= counts_t[:, None])
    out, faults = {}, None
    for label, dt in (("bfloat16", torch.bfloat16),
                      ("float32", torch.float32)):
        errs = {}
        for shape, (K, N) in GMM_SHAPES.items():
            x = torch.randn((G, C, K), generator=g, device="cuda").to(dt)
            dy = torch.randn((G, C, N), generator=g, device="cuda").to(dt)
            for gpe in (1, 2):
                w = (torch.randn((G // gpe, K, N), generator=g,
                                 device="cuda") * 0.02).to(dt)
                cases = [(f"{shape}/gpe{gpe}", x, w)]
                if gpe == 1:      # dx: dy @ w^T through a strided view
                    cases.append((f"{shape}/dx_transposed_w", dy,
                                  w.transpose(1, 2)))
                for name, a, b in cases:
                    got = gg.gmm_kernel(a, b, counts_t, gpe)
                    torch.cuda.synchronize()
                    want = gg.gmm_plain(a, b, counts_t, gpe)
                    errs[name] = check_close(torch, f"grouped_gemm[{label}/"
                                             f"{name}]", got, want, label)
                    if bool((got[dead] != 0).any()):
                        raise AssertionError(f"grouped_gemm[{label}/{name}]: "
                                             f"rows past counts not zero")
                    if label == "bfloat16" and shape == "gate_up" \
                            and gpe == 2:
                        faults = planted_gmm_faults(torch, gg, a, b,
                                                    counts_t, want)
                    del got, want
                del w
            del x, dy
        out[label] = {"max_abs_err_by_case": errs,
                      "max_abs_err": max(errs.values())}
    out["bfloat16"]["planted_fault_max_abs_err"] = faults

    # times at the path's four launch shapes (bf16, gpe 1): the forward
    # products and their dx through the transposed view; float32 at the
    # gate/up forward. Yardstick: torch.bmm over the count-masked buffer
    # (what gmm_reference computes: a near-equal function that spends
    # products on the dead rows), timed here only
    rows = ~dead[..., None]
    times = {}
    for label, dt in (("bfloat16", torch.bfloat16),
                      ("float32", torch.float32)):
        for shape, (K, N) in GMM_SHAPES.items():
            for launch in ("fwd", "dx"):
                if label == "float32" and (shape, launch) != ("gate_up",
                                                              "fwd"):
                    continue
                w = (torch.randn((G, K, N), generator=g, device="cuda")
                     * 0.02).to(dt)
                if launch == "fwd":
                    a, b = torch.randn((G, C, K), generator=g,
                                       device="cuda").to(dt), w
                else:
                    a, b = torch.randn((G, C, N), generator=g,
                                       device="cuda").to(dt), \
                        w.transpose(1, 2)
                am = torch.where(rows, a, 0)
                kk, nn_ = a.shape[2], b.shape[2]
                flops, nbytes = gmm_work(counts, G, C, kk, nn_, G,
                                         a.element_size())
                b_ms, b_by = bound(nbytes, flops, BF16_FLOPS_PER_S
                                   if label == "bfloat16"
                                   else F32_FLOPS_PER_S)
                times[f"{label}/{shape}/{launch}"] = dict(
                    K=kk, N=nn_,
                    ms=time_ms(torch, lambda: gg.gmm_kernel(
                        a, b, counts_t), flush=flush),
                    plain_ms=time_ms(torch, lambda: gg.gmm_plain(
                        a, b, counts_t), iters=3, flush=flush),
                    library_ms=time_ms(torch, lambda: torch.bmm(am, b),
                                       flush=flush),
                    bound_ms=b_ms, bound_by=b_by, flops=flops, bytes=nbytes)
                del w, a, b, am
    for label in out:
        head = times[f"{label}/gate_up/fwd"]
        out[label].update({k: head[k] for k in (
            "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")})
    out["times"] = times

    # dw, outside the kernel as in the reference: the route the backward
    # takes for bf16 (bf16 products, float32 output) against the float32
    # product of the same values, at the gate/up shape
    K, N = GMM_SHAPES["gate_up"]
    x = torch.randn((G, C, K), generator=g, device="cuda").bfloat16()
    dy = torch.randn((G, C, N), generator=g, device="cuda").bfloat16()
    dw = gg.grad_w(x, dy, counts_t, 1, torch.bfloat16)
    dw32 = gg.grad_w(x.float(), dy.float(), counts_t, 1, torch.float32)
    err = check_close(torch, "grad_w[bf16 vs float32]", dw, dw32,
                      "bfloat16")
    out["grad_w"] = dict(
        max_abs_err_vs_float32=err, flops=2 * G * C * K * N,
        ms=time_ms(torch, lambda: gg.grad_w(x, dy, counts_t, 1,
                                            torch.bfloat16), flush=flush),
        float32_ms=time_ms(torch, lambda: gg.grad_w(
            x.float(), dy.float(), counts_t, 1, torch.float32),
            flush=flush))
    del x, dy, dw, dw32
    log(f"grouped_gemm dw [E{G}, K{K}, N{N}] over C{C}: bf16 route "
        f"{out['grad_w']['ms']:.4f} ms, float32 route "
        f"{out['grad_w']['float32_ms']:.4f} ms, max abs err "
        f"{err:.3e} between them")
    out["counts"] = dict(sum=int(counts.sum()), min=int(counts.min()),
                         max=int(counts.max()), G=G, C=C)
    for label in ("bfloat16", "float32"):
        log(f"grouped_gemm[{label}] G{G} C{C}: max_abs_err "
            f"{out[label]['max_abs_err']:.3e} over "
            f"{sorted(out[label]['max_abs_err_by_case'])}")
    log(f"grouped_gemm: planted faults rejected: {faults}")
    for key, t in times.items():
        log(f"grouped_gemm[{key}] K{t['K']} N{t['N']} (counts sum "
            f"{int(counts.sum())}): ms {t['ms']:.4f} plain_ms "
            f"{t['plain_ms']:.3f} library_ms {t['library_ms']:.4f} (bmm, "
            f"masked buffer) bound_ms {t['bound_ms']:.4f} ({t['bound_by']})")
    report["kernels"]["grouped_gemm"] = out
    return out


# -- phase 4c: the int4 weight-only GEMM ----------------------------------------

# Llama-3-8B's linears as (k, n): q and o, k and v, gate and up, down; m:
# one row, generate()'s decode batch of 4, a ragged count, and the
# engine's 512-token step; two shapes with tails in m, n and k (the second
# with n and k % 8 != 0, so element loads)
INT4_KN = {"qo": (4096, 4096), "kv": (4096, 1024), "gate_up": (4096, 14336),
           "down": (14336, 4096)}
INT4_MS = (1, 4, 37, 512)
INT4_TAILS = ((77, 4100, 1000), (3, 330, 1001))


def int4_from_planes(torch, x, lo, hi, s):
    """The plain formulation over given nibble planes: a planted fault of
    the unpack is a change of the planes."""
    xb = x.to(torch.bfloat16)
    acc = xb[:, 0::2].float() @ lo.float() + xb[:, 1::2].float() @ hi.float()
    return (acc * s.reshape(1, -1)).to(x.dtype)


def planted_int4_faults(torch, wog, x, q, s, want):
    """Two faults an unpack could make, produced with the plain
    formulation: the nibbles swapped (row 2i read from the high nibble)
    and no sign extension (nibbles read as 0..15). Each must fail
    ``check_close``."""
    lo, hi = wog._nibbles(q)
    w32 = q.to(torch.int32)
    errs = {}
    for fault, planes in (("nibbles_swapped", (hi, lo)),
                          ("no_sign_extension", (w32 & 0xF,
                                                 (w32 >> 4) & 0xF))):
        bad = int4_from_planes(torch, x, *planes, s)
        try:
            check_close(torch, "weight_only_int4_gemm", bad, want, "bfloat16")
        except AssertionError:
            errs[fault] = float((bad.float() - want.float()).abs().max())
            continue
        raise AssertionError(f"weight_only_int4_gemm: the tolerance passes "
                             f"a planted fault ({fault})")
    return errs


def int4_work(m, k, n, x_item):
    """(flops, bytes) of one product: the packed weight, x, the scales and
    y (in x's dtype), each once."""
    return 2 * m * k * n, k // 2 * n + m * k * x_item + 4 * n + m * n * x_item


def phase_int4_gemm(torch, seed, report, flush):
    from paddle_tpu_torch.ops.kernels import weight_only_gemm as wog

    g = torch.Generator(device="cuda").manual_seed(seed + 5)
    dtypes = (("bfloat16", torch.bfloat16), ("float32", torch.float32))
    errs = {label: {} for label, _ in dtypes}
    faults, times = None, {}
    # (name, k, n, the m of each case): one weight per entry
    weights = [(name, k, n, INT4_MS) for name, (k, n) in INT4_KN.items()] \
        + [(f"tail_{m}x{k}x{n}", k, n, (m,)) for m, k, n in INT4_TAILS]
    for name, k, n, ms in weights:
        w = torch.randn((k, n), generator=g, device="cuda") * 0.02
        w16, (q, s) = w.bfloat16(), wog.quantize(w, "int4")
        del w
        for m, (label, dt) in itertools.product(ms, dtypes):
            x = torch.randn((m, k), generator=g, device="cuda").to(dt)
            got = wog.int4_matmul_kernel(x, q, s)
            torch.cuda.synchronize()
            want = wog.int4_matmul_plain(x, q, s)
            case = f"{name}/m{m}" if name in INT4_KN else name
            errs[label][case] = check_close(
                torch, f"weight_only_int4_gemm[{label}/{case}]", got, want,
                label)
            if label == "bfloat16" and name == "gate_up" and m == 512:
                faults = planted_int4_faults(torch, wog, x, q, s, want)
            del got, want
            # times: gate/up and down at m 512 and 4 in bf16, and the
            # gate/up step in float32; yardsticks, timed here only: one
            # torch.mm of bf16(x) and the codes unpacked to bf16 (unpacked
            # outside the window) with a float32 output, then the scale
            # (the same function up to summation order, reading 4x the
            # weight bytes); and torch.matmul over the bf16 weight before
            # quantization
            if name in ("gate_up", "down") and m in (4, 512) and (
                    label == "bfloat16" or (name, m) == ("gate_up", 512)):
                wq = wog._unpack_int4(q, n).bfloat16()
                xm = x if label == "bfloat16" else x.bfloat16()
                flops, nbytes = int4_work(m, k, n, x.element_size())
                b_ms, b_by = bound(nbytes, flops, BF16_FLOPS_PER_S)
                times[f"{label}/{name}/m{m}"] = dict(
                    m=m, k=k, n=n,
                    ms=time_ms(torch, lambda: wog.int4_matmul_kernel(
                        x, q, s), flush=flush),
                    plain_ms=time_ms(torch, lambda: wog.int4_matmul_plain(
                        x, q, s), iters=3, flush=flush),
                    library_ms=time_ms(torch, lambda: (torch.mm(
                        x.bfloat16(), wq, out_dtype=torch.float32)
                        * s).to(x.dtype), flush=flush),
                    library_bf16_weight_ms=time_ms(
                        torch, lambda: torch.matmul(xm, w16), flush=flush),
                    bound_ms=b_ms, bound_by=b_by, flops=flops, bytes=nbytes)
                del wq, xm
            del x
        del w16, q, s
    out = {}
    for label, _ in dtypes:
        head = times[f"{label}/gate_up/m512"]
        out[label] = dict(max_abs_err_by_case=errs[label],
                          max_abs_err=max(errs[label].values()),
                          **{k: head[k] for k in (
                              "ms", "plain_ms", "library_ms",
                              "library_bf16_weight_ms", "bound_ms",
                              "bound_by")})
        log(f"weight_only_int4_gemm[{label}]: max_abs_err "
            f"{out[label]['max_abs_err']:.3e} over {len(errs[label])} "
            f"shapes ({sorted(errs[label])})")
    out["bfloat16"]["planted_fault_max_abs_err"] = faults
    out["times"] = times
    log(f"weight_only_int4_gemm: planted faults rejected: {faults}")
    for key, t in times.items():
        log(f"weight_only_int4_gemm[{key}] k{t['k']} n{t['n']}: ms "
            f"{t['ms']:.4f} plain_ms {t['plain_ms']:.3f} library_ms "
            f"{t['library_ms']:.4f} (mm over the unpacked codes) "
            f"bf16-weight matmul {t['library_bf16_weight_ms']:.4f} bound_ms "
            f"{t['bound_ms']:.4f} ({t['bound_by']}), "
            f"{t['flops'] / t['ms'] / 1e9:.1f} TFLOP/s")
    report["kernels"]["weight_only_int4_gemm"] = out
    return out


# -- phase 4d: block-CSR SpMM through sparse.bcsr_matmul ------------------------

# Llama-3-8B's MLP weights (out x in) block-pruned in 128 x 128 blocks, about
# half kept, times the activations of a 2 x 2048 training batch transposed
# (yT = W xT); the reference test's 16 x 128 blocks at a smaller size
BCSR_TOKENS = 4096
BCSR_SHAPES = {"gate_proj": (14336, 4096, 128, 128),
               "down_proj": (4096, 14336, 128, 128),
               "blocks_16x128": (2048, 1024, 16, 128)}
BCSR_EMPTY_ROWS = (3, 17)        # block rows pruned whole
BCSR_TOL = {"bfloat16": 1e-2, "float32": 1e-4}   # of the output's max


def pruned_weight(torch, g, rng, M, K, bm, bk, dtype):
    """A normal(0, 0.02) [M, K] weight with about half of its bm x bk
    blocks zeroed by a mask from ``rng``, and BCSR_EMPTY_ROWS zeroed."""
    mask = rng.rand(M // bm, K // bk) < 0.5
    mask[list(BCSR_EMPTY_ROWS)] = False
    m = torch.from_numpy(mask).cuda()
    w = torch.randn((M, K), generator=g, device="cuda") * 0.02
    w = (w.view(M // bm, bm, K // bk, bk) * m[:, None, :, None]).view(M, K)
    return w.to(dtype)


def spmm_work(nb, bm, bk, mb, k, n, item):
    """(flops, bytes) of one call: 2·bm·bk·N per kept block; the kept
    blocks, x and y once each, and the int32 structure."""
    return (2 * nb * bm * bk * n,
            (nb * bm * bk + k * n + mb * bm * n) * item + 4 * (mb + 1 + nb))


def bcsr_check(torch, name, got, want, dtype_name, bm):
    """The kernel's output within BCSR_TOL of the plain one's max, the
    empty block rows exactly zero; returns the max abs err."""
    err = float((got.float() - want.float()).abs().max())
    lim = BCSR_TOL[dtype_name] * float(want.float().abs().max())
    if not bool(torch.isfinite(got).all()) or err > lim:
        raise AssertionError(f"{name}: kernel differs from plain version: "
                             f"max abs err {err} (limit {lim})")
    for r in BCSR_EMPTY_ROWS:
        if bool((got[r * bm:(r + 1) * bm] != 0).any()):
            raise AssertionError(f"{name}: empty block row {r} not zero")
    return err


def planted_bcsr_faults(torch, bs, crows, cols, vals, x, want, dtype_name):
    """Three faults a kernel could make, produced with the plain version,
    each of which must fail ``bcsr_check``: one block read at a column id
    off by one, a block row's run cut by its last block, and an empty
    block row left unwritten (holding another row's values)."""
    bm, Kb = vals.shape[1], x.shape[0] // vals.shape[2]
    row = int(np.argmax(np.diff(crows)))          # the longest run
    p = int(crows[row + 1]) - 1                   # its last block
    bad_cols = cols.copy()
    bad_cols[p] = (bad_cols[p] + 1) % Kb
    cut = vals.clone()
    cut[p] = 0
    unwritten = want.clone()
    r = BCSR_EMPTY_ROWS[0]
    unwritten[r * bm:(r + 1) * bm] = want[row * bm:(row + 1) * bm]
    errs = {}
    for fault, bad in (
            ("column_off_by_one",
             bs.bcsr_spmm_plain(crows, bad_cols, vals, x)),
            ("run_cut_by_one_block", bs.bcsr_spmm_plain(crows, cols, cut, x)),
            ("empty_row_not_zeroed", unwritten)):
        try:
            bcsr_check(torch, "bcsr_spmm", bad, want, dtype_name, bm)
        except AssertionError:
            errs[fault] = float((bad.float() - want.float()).abs().max())
            continue
        raise AssertionError(f"bcsr_spmm: the check passes a planted fault "
                             f"({fault})")
    return errs


def phase_bcsr(torch, seed, report, flush):
    """``sparse.bcsr_from_dense`` over block-pruned Llama-3-8B MLP weights
    and ``sparse.bcsr_matmul`` against transposed activations, the path a
    user of block-pruned weights calls: exactly one kernel launch per
    call; the kernel against its plain version (bf16 and float32); three
    planted faults; times beside the bound, the plain version, the dense
    product over the zero-filled weight and torch's own BSR product."""
    from paddle_tpu_torch import sparse
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.ops.kernels import bcsr_spmm as bs

    rng = np.random.RandomState(seed + 7)
    g = torch.Generator(device="cuda").manual_seed(seed + 7)
    out, faults, launched = {}, None, 0
    cases = [("gate_proj", "bfloat16"), ("down_proj", "bfloat16"),
             ("gate_proj", "float32"), ("blocks_16x128", "bfloat16"),
             ("blocks_16x128", "float32")]
    for shape, dname in cases:
        M, K, bm, bk = BCSR_SHAPES[shape]
        dt = getattr(torch, dname)
        N = BCSR_TOKENS if shape != "blocks_16x128" else 512
        w = pruned_weight(torch, g, rng, M, K, bm, bk, dt)
        x = torch.randn((N, K), generator=g, device="cuda").to(dt).t() \
            .contiguous()                               # [K, N]: x^T
        crows, cols, vals = sparse.bcsr_from_dense(w, bm, bk)
        # the main path: one call, counts reset just before
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        got = sparse.bcsr_matmul(crows, cols, vals, x)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        if counts != {k: int(k == "bcsr_spmm") for k in counts}:
            raise AssertionError(f"bcsr_matmul[{shape}/{dname}]: launches "
                                 f"{counts}, want one bcsr_spmm")
        launched += counts["bcsr_spmm"]
        want = bs.bcsr_spmm_plain(crows, cols, vals, x)
        label = f"{shape}/{dname}"
        err = bcsr_check(torch, f"bcsr_spmm[{label}]", got, want, dname, bm)
        if (shape, dname) == ("gate_proj", "bfloat16"):
            faults = planted_bcsr_faults(torch, bs, crows, cols, vals, x,
                                         want, dname)
        del got, want
        nb = len(cols)
        flops, nbytes = spmm_work(nb, bm, bk, M // bm, K, N,
                                  x.element_size())
        b_ms, b_by = bound(nbytes, flops, BF16_FLOPS_PER_S
                           if dname == "bfloat16" else F32_FLOPS_PER_S)
        crows_d, cols_d = bs.device_structure(crows, cols, nb, K // bk,
                                              x.device)
        ms = time_ms(torch, lambda: bs.bcsr_spmm_kernel(
            crows_d, cols_d, vals, x), flush=flush)
        plain_ms = time_ms(torch, lambda: bs.bcsr_spmm_plain(
            crows, cols, vals, x), iters=3, flush=flush)
        # yardsticks, timed here only: the dense product over the
        # zero-filled weight, and torch's block-sparse (BSR) product
        dense_ms = time_ms(torch, lambda: torch.matmul(w, x), flush=flush)
        try:
            wb = w.to_sparse_bsr((bm, bk))
            bsr_ms, bsr_err = time_ms(torch, lambda: wb @ x,
                                      flush=flush), None
            del wb
        except (RuntimeError, NotImplementedError, TypeError) as e:
            bsr_ms, bsr_err = None, f"{type(e).__name__}: {str(e)[:160]}"
        out[label] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
            bound_by=b_by, library_ms=dense_ms, library_bsr_ms=bsr_ms,
            library_bsr_error=bsr_err, blocks_kept=nb,
            blocks=(M // bm) * (K // bk), M=M, K=K, N=N, bm=bm, bk=bk,
            flops=flops, bytes=nbytes,
            tflops_per_s=flops / ms / 1e9)
        log(f"bcsr_spmm[{label}] [{M}, {K}] in {bm}x{bk} blocks, {nb} of "
            f"{out[label]['blocks']} kept, x^T [{K}, {N}]: max_abs_err "
            f"{err:.3e}; ms {ms:.4f} ({flops / ms / 1e9:.1f} TFLOP/s) "
            f"plain_ms {plain_ms:.3f} bound_ms {b_ms:.4f} ({b_by}); dense "
            f"matmul {dense_ms:.4f} ms; torch BSR "
            + (f"{bsr_ms:.4f} ms" if bsr_ms is not None else
               f"refused ({bsr_err})"))
        del w, x, vals, crows_d, cols_d
        torch.cuda.empty_cache()
    log(f"bcsr_spmm: planted faults rejected: {faults}")
    res = {"cases": out, "launches": launched,
           "planted_fault_max_abs_err": faults}
    head = out["gate_proj/bfloat16"]
    for dname in ("bfloat16", "float32"):
        res[dname] = {k: out[f"gate_proj/{dname}"][k] for k in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "library_bsr_ms")}
    res["bfloat16"].update(planted_fault_max_abs_err=faults,
                           library_bsr_error=head["library_bsr_error"])
    report["kernels"]["bcsr_spmm"] = res
    return res


# -- phase 5: training --------------------------------------------------------

@contextlib.contextmanager
def plain_flash(fa):
    """Route the flash path to its plain versions on the card."""
    saved = fa.flash_fwd, fa.flash_bwd
    fa.flash_fwd, fa.flash_bwd = fa.flash_fwd_plain, fa.flash_bwd_plain
    try:
        yield
    finally:
        fa.flash_fwd, fa.flash_bwd = saved


def lcg_ids(torch, b, s, vocab):
    """LCG-scrambled token ids, as bench.py makes them (uint32 wrap)."""
    i = torch.arange(b * s, dtype=torch.int64, device="cuda")
    return (((i * 1103515245 + 12345) & 0xFFFFFFFF) % vocab).reshape(b, s)


def kernel_vs_plain_training(torch, model, crit, ids):
    """Loss and layer-0 grads through the kernels and through the plain
    versions, same weights and batch."""
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    layer = model.llama.layers[0]
    res = []
    for plain in (False, True):
        with plain_flash(fa) if plain else contextlib.nullcontext():
            loss = crit(model(ids), ids)
            loss.backward()
        res.append((float(loss.detach()),
                    {n: p.grad.float().clone()
                     for n, p in layer.named_parameters()}))
        model.zero_grad(set_to_none=True)
        del loss
    (lk, gk), (lp, gp) = res
    cos = {n: float(torch.nn.functional.cosine_similarity(
        gk[n].flatten(), gp[n].flatten(), dim=0)) for n in gk}
    out = dict(loss_kernels=lk, loss_plain=lp, loss_abs_diff=abs(lk - lp),
               grad_cosine_min=min(cos.values()), grad_cosine=cos)
    if not (abs(lk - lp) <= LOSS_ATOL and min(cos.values()) >= GRAD_MIN_COS):
        raise AssertionError(f"training kernels vs plain: {out}")
    return out


# the port's attention kernels by the exact stems of their symbols, checked
# before any other pattern: a templated or renamed kernel must not land in
# "matmul" or "other" (bf16: the tensor-core kernels; float32: the CUDA-core
# kernels of flash_attention.cu and flash_varlen.cu)
FLASH_FWD_STEMS = ("flash_tc_fwd<", "varlen_tc_fwd<", "::fwd_kernel<")
FLASH_BWD_STEMS = ("flash_tc_dq<", "flash_tc_dkv<", "varlen_tc_dq<",
                   "varlen_tc_dkv<", "::dq_kernel<", "::dkv_kernel<")


def categorize(all_kernels, busy_ms):
    """Device ms of one step by part of the step, from every activity's
    full name; ``unaccounted`` is the busy time the parts leave out (0
    when no two activities overlap)."""
    cats = {"grouped_gemm": 0.0, "int4_gemm": 0.0, "paged_attention": 0.0,
            "flash_fwd": 0.0, "flash_bwd": 0.0, "fused_optimizer": 0.0,
            "matmul": 0.0, "other": 0.0}
    for name, ms in all_kernels.items():
        low = name.lower()
        if any(t in name for t in FLASH_FWD_STEMS):
            cats["flash_fwd"] += ms
        elif any(t in name for t in FLASH_BWD_STEMS):
            cats["flash_bwd"] += ms
        elif "grouped_gemm_" in low:
            cats["grouped_gemm"] += ms
        elif "int4_gemm_" in low:
            cats["int4_gemm"] += ms
        elif "paged_attention_kernel" in low:   # ragged and gang decode
            cats["paged_attention"] += ms
        elif "fused_kernel" in low:
            cats["fused_optimizer"] += ms
        elif any(t in low for t in ("gemm", "nvjet", "cutlass", "xmma",
                                    "sm90_")):
            cats["matmul"] += ms
        else:
            cats["other"] += ms
    cats["unaccounted"] = busy_ms - sum(cats.values())
    return cats


def phase_train(torch, seed, report):
    from paddle_tpu_torch.amp import GradScaler
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                         LlamaPretrainingCriterion)
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.optimizer import AdamW

    cfg = dataclasses.replace(LlamaConfig.llama3_8b(),
                              num_hidden_layers=TRAIN_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    model = LlamaForCausalLM(cfg, device="cuda", generator=gen)
    crit = LlamaPretrainingCriterion(cfg)
    n_params = sum(p.numel() for p in model.parameters())
    n_matmul = n_params - model.llama.embed_tokens.weight.numel()
    log(f"train model: Llama-3-8B width, {cfg.num_hidden_layers} layers, "
        f"{n_params / 1e9:.3f} B parameters (bf16, seed {seed}) built in "
        f"{time.perf_counter() - t0:.1f} s")
    ids = lcg_ids(torch, TRAIN_B, TRAIN_S, cfg.vocab_size)
    res = {"layers": cfg.num_hidden_layers, "params": n_params,
           "batch": TRAIN_B, "seq": TRAIN_S}
    res["kernel_vs_plain"] = kernel_vs_plain_training(torch, model, crit,
                                                      ids)
    log(f"train kernels vs plain (loss, layer-0 grads): "
        f"{json.dumps(res['kernel_vs_plain'])}")

    opt = AdamW(learning_rate=1e-4, weight_decay=0.01,
                parameters=model.parameters(),
                grad_clip=ClipGradByGlobalNorm(1.0))
    train = TrainStep(model, crit, opt)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    losses, step_s = [], []
    for i in range(12):            # 2 warm-up steps, then 10 timed
        ts = time.perf_counter()
        loss = train((ids,), (ids,))
        torch.cuda.synchronize()
        if i >= 2:
            step_s.append(time.perf_counter() - ts)
        losses.append(float(loss))
    counts = kernels.launch_counts()
    res["launches"] = counts
    for name in TRAINING_KERNELS:
        if counts[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 f"training path")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"training losses not finite and falling: "
                             f"{losses}")
    tok_s = TRAIN_B * TRAIN_S / float(np.mean(step_s))
    flops_tok = 6 * n_matmul + 6 * TRAIN_S * cfg.hidden_size \
        * cfg.num_hidden_layers
    res.update(losses=losses, tokens_per_s=tok_s,
               step_ms_p50=1e3 * float(np.percentile(step_s, 50)),
               step_ms_p99=1e3 * float(np.percentile(step_s, 99)),
               step_ms=[1e3 * x for x in step_s],
               mfu=tok_s * flops_tok / BF16_FLOPS_PER_S,
               flops_per_token=flops_tok,
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               optimizer_bytes_per_param=16)
    log(f"train: losses {[round(x, 4) for x in losses]}")
    log(f"train: {tok_s:.1f} tokens/s, step p50 {res['step_ms_p50']:.1f} ms "
        f"p99 {res['step_ms_p99']:.1f} ms, mfu {res['mfu']:.4f}, peak "
        f"{res['peak_mem_gib']:.2f} GiB, launches {counts}")
    prof = profile_call(torch, lambda: train((ids,), (ids,)), 1)
    if "all_kernels" in prof:
        prof["by_part_ms"] = categorize(prof.pop("all_kernels"),
                                        prof["device_busy_ms"])
    res["profile"] = prof
    log(f"train profile (one step): {json.dumps(prof)}")

    # GradScaler: a step with a poisoned grad is skipped, params bitwise
    # unchanged (a short batch: the skip does not depend on its size)
    sc = GradScaler(init_loss_scaling=2.0 ** 10)
    small = ids[:, :256]
    snap = [p.detach().clone() for p in model.parameters()]
    step_before = opt._step_count
    sc.scale(crit(model(small), small)).backward()
    next(p for p in model.parameters() if p.grad is not None) \
        .grad.view(-1)[0] = float("nan")
    sc.step(opt)
    opt.clear_grad()
    torch.cuda.synchronize()
    unchanged = all(torch.equal(a, p.detach())
                    for a, p in zip(snap, model.parameters()))
    if not (sc._found_last and unchanged and opt._step_count == step_before):
        raise AssertionError("GradScaler did not skip the poisoned step "
                             "bitwise")
    res["grad_scaler_poisoned_step"] = "skipped, params bitwise unchanged"
    log("train: GradScaler skipped the poisoned step, params bitwise "
        "unchanged")
    del snap, opt, train
    torch.cuda.empty_cache()
    res["lamb"] = train_lamb(torch, model, crit, ids, flops_tok)
    del model
    torch.cuda.empty_cache()
    report["train"] = res
    return res


LAMB_KERNELS = ("fused_optimizer_lamb_moments", "fused_optimizer_lamb_apply")


def train_lamb(torch, model, crit, ids, flops_tok):
    """The same model, after the AdamW run and with its optimizer gone,
    trained on by ``Lamb`` through ``TrainStep``: 2 warm-up and 10 timed
    steps, exactly two Lamb launches per bucket per step and no AdamW
    launch, then one profiled step."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.optimizer import Lamb

    opt = Lamb(learning_rate=1e-4, lamb_weight_decay=0.01,
               parameters=model.parameters(),
               grad_clip=ClipGradByGlobalNorm(1.0),
               exclude_from_weight_decay_fn=lambda p: p.ndim == 1)
    train = TrainStep(model, crit, opt)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    losses, step_s = [], []
    for i in range(12):            # 2 warm-up steps, then 10 timed
        ts = time.perf_counter()
        loss = train((ids,), (ids,))
        torch.cuda.synchronize()
        if i >= 2:
            step_s.append(time.perf_counter() - ts)
        losses.append(float(loss))
    counts = kernels.launch_counts()
    plan = next(iter(opt._fused_plans.values()))
    want = len(plan.buckets) * 12
    if counts["fused_optimizer"] != 0 or any(counts[k] != want
                                             for k in LAMB_KERNELS):
        raise AssertionError(f"Lamb launches {counts}: want {want} of each "
                             f"Lamb pass ({len(plan.buckets)} buckets x 12 "
                             f"steps) and no AdamW launch")
    for name in TRAINING_KERNELS[:3]:
        if counts[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 f"Lamb training path")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"Lamb training losses not finite and falling: "
                             f"{losses}")
    tok_s = TRAIN_B * TRAIN_S / float(np.mean(step_s))
    res = dict(losses=losses, tokens_per_s=tok_s,
               step_ms_p50=1e3 * float(np.percentile(step_s, 50)),
               step_ms_p99=1e3 * float(np.percentile(step_s, 99)),
               step_ms=[1e3 * x for x in step_s],
               mfu=tok_s * flops_tok / BF16_FLOPS_PER_S,
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               launches=counts, buckets=len(plan.buckets),
               bucket_params=[b.total for b in plan.buckets],
               optimizer_bytes_per_param=20)
    log(f"train[lamb]: losses {[round(x, 5) for x in losses]}")
    log(f"train[lamb]: {tok_s:.1f} tokens/s, step p50 "
        f"{res['step_ms_p50']:.1f} ms p99 {res['step_ms_p99']:.1f} ms, mfu "
        f"{res['mfu']:.4f}, peak {res['peak_mem_gib']:.2f} GiB, "
        f"{len(plan.buckets)} buckets {res['bucket_params']}, launches "
        f"{counts}")
    prof = profile_call(torch, lambda: train((ids,), (ids,)), 1)
    if "all_kernels" in prof:
        prof["by_part_ms"] = categorize(prof.pop("all_kernels"),
                                        prof["device_busy_ms"])
    res["profile"] = prof
    log(f"train[lamb] profile (one step): {json.dumps(prof)}")
    del opt, train
    return res


# -- phase 6: MoE training ------------------------------------------------------

MOE_LAYERS = 5    # the dense layer and 4 MoE layers, each with all 64
#                   experts; the published 28 layers (16.4 B params) would
#                   need 262 GB at 16 B/param
# the 5-layer bf16 model's loss and layer-1 expert and router grads through
# the grouped-GEMM kernel vs through its plain version, same weights and
# batch: layer 1's routing is equal in both runs (its input does not pass
# a grouped product); each product's bf16 output may differ by one ulp,
# which compounds through the 4 MoE layers and moves some tokens of the
# later layers to other experts (measured on the H100: loss 1.1e-4 apart,
# grads cosine >= 0.99995, layers 2-4 routed differently; the limits are
# ~10x and ~20x those gaps)
MOE_LOSS_ATOL, MOE_GRAD_MIN_COS = 1e-3, 0.999


def moe_config():
    """DeepSeek-MoE-16B at published width (huggingface.co/deepseek-ai/
    deepseek-moe-16b-base config.json), depth cut to MOE_LAYERS; routing
    keeps the JAX package's semantics (GShard capacity 1.25 with drops,
    Switch aux loss, no top-k renormalisation)."""
    from paddle_tpu_torch.models import MoEConfig
    return MoEConfig(vocab_size=102400, hidden_size=2048,
                     intermediate_size=10944, num_hidden_layers=MOE_LAYERS,
                     num_attention_heads=16, num_key_value_heads=16,
                     max_position_embeddings=4096, rms_norm_eps=1e-6,
                     rope_theta=10000.0, num_experts=64,
                     num_experts_per_tok=6, moe_intermediate_size=1408,
                     num_shared_experts=2, first_k_dense_replace=1,
                     capacity_factor=1.25, aux_loss_alpha=0.001,
                     dtype="bfloat16")


def active_matmul_params(cfg) -> int:
    """The matmul params one token passes through (bench.py:230's N for a
    sparse model): every layer's attention, the dense layers' MLP, in each
    MoE layer the router, the shared experts and top_k of the routed
    experts, and the LM head; the embedding lookup is no matmul."""
    h, hd = cfg.hidden_size, cfg.hidden_size // cfg.num_attention_heads
    attn = h * hd * (2 * cfg.num_attention_heads
                     + 2 * cfg.num_key_value_heads)
    m = cfg.moe_intermediate_size
    moe = (3 * h * m * (cfg.num_experts_per_tok + cfg.num_shared_experts)
           + h * cfg.num_experts)
    n_dense = cfg.first_k_dense_replace
    return (cfg.num_hidden_layers * attn
            + n_dense * 3 * h * cfg.intermediate_size
            + (cfg.num_hidden_layers - n_dense) * moe + h * cfg.vocab_size)


@contextlib.contextmanager
def plain_gmm(gg):
    """Route the grouped products (forward and dx) to the plain version
    on the card."""
    saved = gg.gmm_kernel
    gg.gmm_kernel = gg.gmm_plain
    try:
        yield
    finally:
        gg.gmm_kernel = saved


@contextlib.contextmanager
def record_routing(mo, routes):
    """Append each MoE layer's (idx, counts) to ``routes`` as it routes."""
    saved = mo.route_topk

    def rec(*args):
        out = saved(*args)
        routes.append((out[0].detach(), out[2].detach()))
        return out
    mo.route_topk = rec
    try:
        yield
    finally:
        mo.route_topk = saved


def routing_stats(routes, tokens, top_k):
    """Per MoE layer: choices dropped by capacity, min and max counts."""
    return [dict(dropped=tokens * top_k - int(c.sum()), min=int(c.min()),
                 max=int(c.max())) for _, c in routes]


def kernel_vs_plain_moe(torch, model, crit, ids):
    """Loss and the first MoE layer's expert and router grads through the
    grouped-GEMM kernel and through its plain version; the first MoE
    layer's routing must be equal."""
    from paddle_tpu_torch.ops.kernels import grouped_gemm as gg
    from paddle_tpu_torch.ops.kernels import moe as mo
    layer = model.model.layers[1].mlp.moe
    res = []
    for plain in (False, True):
        routes = []
        with plain_gmm(gg) if plain else contextlib.nullcontext(), \
                record_routing(mo, routes):
            loss = crit(model(ids), ids)
            loss.backward()
        res.append((float(loss.detach()),
                    {n: p.grad.float().clone()
                     for n, p in layer.named_parameters()}, routes))
        model.zero_grad(set_to_none=True)
        del loss
    (lk, gk, rk), (lp, gp, rp) = res
    cos = {n: float(torch.nn.functional.cosine_similarity(
        gk[n].flatten(), gp[n].flatten(), dim=0)) for n in gk}
    same = [bool(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]))
            for a, b in zip(rk, rp)]
    out = dict(loss_kernels=lk, loss_plain=lp, loss_abs_diff=abs(lk - lp),
               grad_cosine_min=min(cos.values()), grad_cosine=cos,
               routing_equal_by_layer=same,
               routing=routing_stats(rk, ids.numel(),
                                     model.config.num_experts_per_tok))
    if not same[0]:
        raise AssertionError("the first MoE layer routes differently through "
                             "the kernel and the plain version")
    if not (abs(lk - lp) <= MOE_LOSS_ATOL
            and min(cos.values()) >= MOE_GRAD_MIN_COS):
        raise AssertionError(f"MoE kernel vs plain: {out}")
    return out


def phase_moe_train(torch, seed, report):
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import (MoEForCausalLM,
                                         MoEPretrainingCriterion)
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.ops.kernels import moe as mo
    from paddle_tpu_torch.optimizer import AdamW

    cfg = moe_config()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    model = MoEForCausalLM(cfg, device="cuda", generator=gen)
    crit = MoEPretrainingCriterion(cfg, model)
    n_params = sum(p.numel() for p in model.parameters())
    n_active = active_matmul_params(cfg)
    n_moe = cfg.num_hidden_layers - cfg.first_k_dense_replace
    log(f"moe model: DeepSeek-MoE-16B width, {cfg.num_hidden_layers} layers "
        f"({n_moe} MoE x {cfg.num_experts} experts, top {cfg.num_experts_per_tok}"
        f", {cfg.num_shared_experts} shared), {n_params / 1e9:.3f} B params, "
        f"{n_active / 1e9:.3f} B active matmul params (bf16, seed {seed}) "
        f"built in {time.perf_counter() - t0:.1f} s")
    ids = lcg_ids(torch, TRAIN_B, TRAIN_S, cfg.vocab_size)
    res = {"layers": cfg.num_hidden_layers, "params": n_params,
           "active_matmul_params": n_active, "batch": TRAIN_B,
           "seq": TRAIN_S, "capacity": mo.moe_capacity(
               TRAIN_B * TRAIN_S, cfg.num_experts_per_tok, cfg.num_experts,
               cfg.capacity_factor)}
    res["kernel_vs_plain"] = kernel_vs_plain_moe(torch, model, crit, ids)
    log(f"moe kernels vs plain (loss, layer-1 expert and router grads, "
        f"routing): {json.dumps(res['kernel_vs_plain'])}")

    opt = AdamW(learning_rate=1e-4, weight_decay=0.01,
                parameters=model.parameters(),
                grad_clip=ClipGradByGlobalNorm(1.0))
    train = TrainStep(model, crit, opt)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    losses, step_s = [], []
    for i in range(12):            # 2 warm-up steps, then 10 timed
        ts = time.perf_counter()
        loss = train((ids,), (ids,))
        torch.cuda.synchronize()
        if i >= 2:
            step_s.append(time.perf_counter() - ts)
        losses.append(float(loss))
    counts = kernels.launch_counts()
    res["launches"] = counts
    per_step = 6 * n_moe          # 3 forward products and their 3 dx
    if counts["grouped_gemm"] != per_step * 12:
        raise AssertionError(f"grouped_gemm launched {counts['grouped_gemm']}"
                             f" times in 12 steps, want {per_step * 12}")
    for name in TRAINING_KERNELS:
        if counts[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 f"MoE training path")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"MoE training losses not finite and falling: "
                             f"{losses}")
    tok_s = TRAIN_B * TRAIN_S / float(np.mean(step_s))
    # bench.py:230's MFU with N the active matmul params:
    # 6 * N_active + 6 * seq * hidden * layers flops per token
    flops_tok = 6 * n_active + 6 * TRAIN_S * cfg.hidden_size \
        * cfg.num_hidden_layers
    res.update(losses=losses, tokens_per_s=tok_s,
               step_ms_p50=1e3 * float(np.percentile(step_s, 50)),
               step_ms_p99=1e3 * float(np.percentile(step_s, 99)),
               step_ms=[1e3 * x for x in step_s],
               mfu=tok_s * flops_tok / BF16_FLOPS_PER_S,
               flops_per_token=flops_tok,
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               grouped_gemm_launches_per_step=counts["grouped_gemm"] / 12)
    log(f"moe train: losses {[round(x, 4) for x in losses]}")
    log(f"moe train: {tok_s:.1f} tokens/s, step p50 {res['step_ms_p50']:.1f} "
        f"ms p99 {res['step_ms_p99']:.1f} ms, mfu (active params) "
        f"{res['mfu']:.4f}, peak {res['peak_mem_gib']:.2f} GiB, launches "
        f"{counts} ({res['grouped_gemm_launches_per_step']:.0f} grouped_gemm "
        f"per step)")
    routes = []
    with torch.no_grad(), record_routing(mo, routes):
        model(ids)
    res["routing_after_training"] = routing_stats(
        routes, ids.numel(), cfg.num_experts_per_tok)
    log(f"moe routing per MoE layer at step 0: "
        f"{res['kernel_vs_plain']['routing']}; after 12 steps: "
        f"{res['routing_after_training']} (dropped = choices past capacity "
        f"{res['capacity']} of {ids.numel() * cfg.num_experts_per_tok})")
    prof = profile_call(torch, lambda: train((ids,), (ids,)), 1)
    if "all_kernels" in prof:
        prof["by_part_ms"] = categorize(prof.pop("all_kernels"),
                                        prof["device_busy_ms"])
    res["profile"] = prof
    log(f"moe train profile (one step): {json.dumps(prof)}")
    del model, opt, train, crit
    torch.cuda.empty_cache()
    report["moe_train"] = res
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--report",
                    default=os.path.join("chiprun_out",
                                         "chip_smoke_report.json"))
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device: nothing to drive", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import paddle_tpu_torch  # noqa: F401
        from paddle_tpu_torch.ops.kernels import _build
    except ImportError as e:
        print(f"chip_smoke: the paddle_tpu_torch package is missing ({e})",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    report = {"card": card_line(), "torch": torch.__version__,
              "cuda": torch.version.cuda}
    log(f"card: {report['card']} (torch {torch.__version__}, CUDA "
        f"{torch.version.cuda})")
    report["build_s"] = _build.build_all()
    log(f"build: {report['build_s']:.1f} s (nvcc, sm_90a, one process per "
        f"source)")
    for stem in ("ragged_paged_attention", "paged_attention",
                 "flash_attention", "flash_varlen", "fused_optimizer",
                 "grouped_gemm", "weight_only_gemm", "bcsr_spmm"):
        txt = _build.ptxas_report(stem) or ""
        for line in txt.splitlines():
            if "registers" in line or "spill" in line:
                log(f"ptxas[{stem}]: {line.strip()}")
    report["ptxas_tc"] = [
        row for stem in ("flash_attention", "flash_varlen")
        for row in ptxas_tc_kernels(_build.ptxas_report(stem) or "")]
    for row in report["ptxas_tc"]:
        log(f"ptxas[{row['kernel']}]: {row['registers']} registers, "
            f"{row.get('spill_stores')} B spill stores, "
            f"{row.get('spill_loads')} B spill loads, "
            f"{row['smem_bytes']} B dynamic shared memory")

    kern = phase_kernels(torch, args.seed, report)
    scratch = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    flush = lambda: scratch.zero_()  # noqa: E731  (> 50 MB L2)
    flash = phase_flash(torch, args.seed, report, flush)
    varlen = phase_flash_varlen(torch, args.seed, report, flush)
    fused = phase_fused_optimizer(torch, args.seed, report, flush)
    lamb = phase_lamb_optimizer(torch, args.seed, report, flush)
    gmm = phase_grouped_gemm(torch, args.seed, report, flush)
    int4_gemm = phase_int4_gemm(torch, args.seed, report, flush)
    bcsr = phase_bcsr(torch, args.seed, report, flush)
    del scratch
    torch.cuda.empty_cache()
    main_res, outs_bf16 = phase_main(torch, args.seed, report)
    torch.cuda.empty_cache()          # the serving model is gone
    int4 = phase_int4_serve(torch, args.seed, report, outs_bf16)
    train = phase_train(torch, args.seed, report)
    torch.cuda.empty_cache()          # the Llama training model is gone
    moe = phase_moe_train(torch, args.seed, report)

    entries = []
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    sources = {
        "ragged_paged_attention": (
            "paddle_tpu_torch/csrc/ragged_paged_attention.cu",
            "paddle_tpu/ops/kernels/pallas/ragged_paged_attention.py:115"),
        "paged_attention": (
            "paddle_tpu_torch/csrc/paged_attention.cu",
            "paddle_tpu/ops/kernels/pallas/paged_attention.py:76"),
        "flash_attention_fwd": (
            "paddle_tpu_torch/csrc/flash_attention.cu",
            "paddle_tpu/ops/kernels/pallas/flash_attention.py:126"),
        "flash_attention_dq": (
            "paddle_tpu_torch/csrc/flash_attention.cu",
            "paddle_tpu/ops/kernels/pallas/flash_attention.py:264"),
        "flash_attention_dkv": (
            "paddle_tpu_torch/csrc/flash_attention.cu",
            "paddle_tpu/ops/kernels/pallas/flash_attention.py:283"),
        "flash_varlen_fwd": (
            "paddle_tpu_torch/csrc/flash_varlen.cu",
            "paddle_tpu/ops/kernels/pallas/flash_varlen.py:266"),
        "flash_varlen_dq": (
            "paddle_tpu_torch/csrc/flash_varlen.cu",
            "paddle_tpu/ops/kernels/pallas/flash_varlen.py:304"),
        "flash_varlen_dkv": (
            "paddle_tpu_torch/csrc/flash_varlen.cu",
            "paddle_tpu/ops/kernels/pallas/flash_varlen.py:331"),
        "fused_optimizer": (
            "paddle_tpu_torch/csrc/fused_optimizer.cu",
            "paddle_tpu/ops/kernels/pallas/fused_optimizer.py:279"),
        "grouped_gemm": (
            "paddle_tpu_torch/csrc/grouped_gemm.cu",
            "paddle_tpu/ops/kernels/pallas/grouped_gemm.py:109"),
        "weight_only_int4_gemm": (
            "paddle_tpu_torch/csrc/weight_only_gemm.cu",
            "paddle_tpu/ops/kernels/pallas/weight_only_gemm.py:105"),
        "fused_optimizer_lamb_moments": (
            "paddle_tpu_torch/csrc/fused_optimizer.cu",
            "paddle_tpu/ops/kernels/pallas/fused_optimizer.py:343"),
        "fused_optimizer_lamb_apply": (
            "paddle_tpu_torch/csrc/fused_optimizer.cu",
            "paddle_tpu/ops/kernels/pallas/fused_optimizer.py:357"),
        "bcsr_spmm": (
            "paddle_tpu_torch/csrc/bcsr_spmm.cu",
            "paddle_tpu/ops/kernels/pallas/bcsr_spmm.py:93")}
    per_kernel = {
        "ragged_paged_attention": kern["ragged_paged_attention"],
        "paged_attention": kern["paged_attention"],
        "flash_attention_fwd": {k: v["fwd"] for k, v in flash.items()},
        "flash_attention_dq": {k: v["dq"] for k, v in flash.items()},
        "flash_attention_dkv": {k: v["dkv"] for k, v in flash.items()},
        "flash_varlen_fwd": {k: varlen[k]["fwd"] for k in VARLEN_LABELS},
        "flash_varlen_dq": {k: varlen[k]["dq"] for k in VARLEN_LABELS},
        "flash_varlen_dkv": {k: varlen[k]["dkv"] for k in VARLEN_LABELS},
        "fused_optimizer": {"bfloat16": fused},
        "grouped_gemm": {k: gmm[k] for k in ("bfloat16", "float32")},
        "weight_only_int4_gemm": {k: int4_gemm[k]
                                  for k in ("bfloat16", "float32")},
        "fused_optimizer_lamb_moments": {"bfloat16": lamb["moments"]},
        "fused_optimizer_lamb_apply": {"bfloat16": lamb["apply"]},
        "bcsr_spmm": {k: bcsr[k] for k in ("bfloat16", "float32")}}
    # each path's launches: the serving kernels from the serving run, the
    # Llama training kernels from the Llama training run, the grouped GEMM
    # from the MoE training run, the int4 GEMM from the int4 serving run
    # (counts reset before each)
    launched = {name: main_res["launches"][name] for name in SERVING_KERNELS}
    launched.update({name: train["launches"][name]
                     for name in TRAINING_KERNELS})
    launched["grouped_gemm"] = moe["launches"]["grouped_gemm"]
    launched.update(varlen["launches"])
    launched["weight_only_int4_gemm"] = \
        int4["serve"]["launches"]["weight_only_int4_gemm"]
    launched.update({name: train["lamb"]["launches"][name]
                     for name in LAMB_KERNELS})
    launched["bcsr_spmm"] = bcsr["launches"]
    for name, per in per_kernel.items():
        head = per["bfloat16"]
        e = {"name": name, "route": "cuda", "source": sources[name][0],
             "replaces": sources[name][1], "launches": launched[name]}
        e.update({k: head[k] for k in keys})
        for extra in ("library_bf16_weight_ms", "planted_fault_max_abs_err",
                      "padded_flash_ms", "library_bsr_ms",
                      "library_bsr_error"):
            if extra in head:
                e[extra] = head[extra]
        for label, v in per.items():
            if label != "bfloat16" and isinstance(v, dict) and "ms" in v:
                e[label] = {k: v[k] for k in keys}
        entries.append(e)
    report["total_s"] = time.perf_counter() - t_start
    try:
        os.makedirs(os.path.dirname(args.report) or ".", exist_ok=True)
        with open(args.report, "w") as f:
            json.dump(report, f, indent=1)
    except OSError as e:
        log(f"report not written: {e}")
    log(f"total: {report['total_s']:.1f} s")
    print(json.dumps({"kernels": entries}), flush=True)
    log(report["card"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
