#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA card (H100): build its CUDA
kernels, hold each against its plain PyTorch version, then serve
Llama-3-8B (full width and depth, random weights from a seed) through the
ragged continuous-batching engine and ``generate(cache_type="paged")``.

    python3 chip_smoke.py [--seed N] [--report PATH]

Phases (any failure raises and the script exits non-zero):

1. card and build: the card's name and power limit (nvidia-smi), then
   every ``paddle_tpu_torch/csrc/*.cu`` compiled by nvcc, timed;
2. kernel checks at the serving path's head geometry (H=32, KV=8, D=128,
   BS=64, a 512-token step over 16 rows mixing decode rows, prefill chunks
   at several offsets, empty rows and padding tokens): each kernel against
   its plain version (bf16 and int8 pools, and float32), timed with CUDA
   events beside its bound and one PyTorch library call
   (``scaled_dot_product_attention`` over the gathered dense KV, timed here
   only: the port never calls it);
3. the main path: 16 requests through ``ContinuousBatchingEngine`` with a
   bf16 pool, again with an int8 pool, again with speculative decoding,
   then one paged ``generate()`` call; every kernel's launch count must
   rise, every request must finish with in-vocabulary tokens, and the
   model's last-position logits through the kernels must agree with the
   plain path's. Last, two more runs (bf16 and int8 pools) each profile
   one prefill step and three decode steps with torch.profiler (device
   time by kernel); their launches are not counted.

Output: findings on earlier lines, then the ``kernels`` JSON line, then as
the last line ``{"ok": true, "device": {...}}``. Exits non-zero, printing
no result, when no CUDA device is present or the package is missing.
A longer report goes to ``--report`` (default
``chiprun_out/chip_smoke_report.json``).
"""

from __future__ import annotations

import argparse
import json
import os
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


def profile_steps(torch, eng, n, outs):
    """Run ``n`` engine steps under torch.profiler: device time by kernel
    (top 8), device busy time (the union of the device's activity
    intervals), wall time and the busy share. If the profiler itself fails
    to start, stop or parse, the window is recorded as not measured; a
    failure of the engine's steps raises as anywhere else."""
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    try:
        prof.start()
    except Exception as e:   # profiler set-up only
        prof, why = None, f"{type(e).__name__}: {e}"
    t0 = time.perf_counter()
    for _ in range(n):
        for req in eng.step():
            outs[req.rid] = list(req.out_tokens)
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
                    for k, (ms, c) in top]}


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

    cfg = model.config
    ids = torch.from_numpy(prompt[None]).cuda()
    mb = -(-len(prompt) // 64)
    cos_of = lambda a, b: float(  # noqa: E731
        torch.nn.functional.cosine_similarity(a, b, dim=0))
    out, logits = {}, {}
    for kv in ("bf16", "int8"):
        res = []
        for cls in (PagedKVCache, PlainCache):
            cache = cls(cfg.num_hidden_layers, 1, num_blocks=mb,
                        block_size=64, num_kv_heads=cfg.num_key_value_heads,
                        head_dim=cfg.hidden_size // cfg.num_attention_heads,
                        max_blocks_per_seq=mb, dtype=cfg.dtype, kv_dtype=kv,
                        device="cuda")
            res.append(model(ids, cache=cache, start_pos=0)[0, -1].float())
            del cache
        a, b = res
        if not bool(torch.isfinite(a).all()):
            raise AssertionError(f"kernel-path logits ({kv}) are not finite")
        err, cos = float((a - b).abs().max()), cos_of(a, b)
        if err > LOGITS_ATOL or cos < LOGITS_MIN_COS:
            raise AssertionError(
                f"logits ({kv} pool): kernel vs plain path max abs err {err} "
                f"(atol {LOGITS_ATOL}), cosine {cos}")
        out[kv] = dict(max_abs_err=err, cosine=cos, std=float(b.std()),
                       argmax_equal=bool(a.argmax() == b.argmax()))
        logits[kv] = a
    a, b = logits["int8"], logits["bf16"]
    out["int8_vs_bf16"] = dict(max_abs_err=float((a - b).abs().max()),
                               cosine=cos_of(a, b),
                               argmax_equal=bool(a.argmax() == b.argmax()))
    return out


def phase_main(torch, seed, report):
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
    outs_bf16, main["bf16"] = counted_serve()
    if main["bf16"]["stats"]["prefix_hit_blocks"] <= 0:
        raise AssertionError("the shared-prefix request did not hit the "
                             "prefix cache")
    outs_int8, main["int8"] = counted_serve(kv_dtype="int8")
    outs_spec, main["spec_k4"] = counted_serve(speculative_k=4)
    ids = torch.from_numpy(np.stack([p[:128] for p in prompts[:4]])).cuda()
    tg = time.perf_counter()
    out = model.generate(ids, max_new_tokens=16, temperature=0.0,
                         cache_type="paged", block_size=64)
    torch.cuda.synchronize()
    main["generate"] = dict(batch=4, prompt=128, new_tokens=16,
                            wall_s=time.perf_counter() - tg)
    counts = kernels.launch_counts()
    main["launches"] = counts
    if tuple(out.shape) != (4, 144) or int(out.max()) >= cfg.vocab_size \
            or int(out.min()) < 0:
        raise AssertionError(f"generate() returned {tuple(out.shape)} or "
                             f"tokens out of vocabulary")
    for name, n in counts.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 f"main path")

    def agree(a, b, first=False):
        pairs = [(x, y) for r in a for x, y in zip(a[r][:1 if first else None],
                                                   b[r])]
        return sum(x == y for x, y in pairs) / len(pairs)

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
    log(f"generate(paged): {main['generate']}")
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
    return main


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
    log(f"build: {report['build_s']:.1f} s (nvcc, sm_90a)")
    for stem in ("ragged_paged_attention", "paged_attention"):
        txt = _build.ptxas_report(stem) or ""
        for line in txt.splitlines():
            if "registers" in line or "spill" in line:
                log(f"ptxas[{stem}]: {line.strip()}")

    kern = phase_kernels(torch, args.seed, report)
    main_res = phase_main(torch, args.seed, report)

    from paddle_tpu_torch.ops.kernels import KERNEL_MODULES
    entries = []
    sources = {"ragged_paged_attention": (
        "paddle_tpu_torch/csrc/ragged_paged_attention.cu",
        "paddle_tpu/ops/kernels/pallas/ragged_paged_attention.py:115"),
        "paged_attention": (
        "paddle_tpu_torch/csrc/paged_attention.cu",
        "paddle_tpu/ops/kernels/pallas/paged_attention.py:76")}
    for name in KERNEL_MODULES:
        per = kern[name]
        head = per["bfloat16"]
        e = {"name": name, "route": "cuda", "source": sources[name][0],
             "replaces": sources[name][1],
             "launches": main_res["launches"][name],
             "max_abs_err": head["max_abs_err"], "ms": head["ms"],
             "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
             "bound_by": head["bound_by"], "library_ms": head["library_ms"],
             "planted_fault_max_abs_err": head["planted_fault_max_abs_err"]}
        for label, v in per.items():
            if label != "bfloat16":
                e[label] = {k: v[k] for k in ("max_abs_err", "ms", "plain_ms",
                                              "bound_ms", "bound_by",
                                              "library_ms")}
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
