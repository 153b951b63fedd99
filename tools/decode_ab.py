"""Gang-decode A/B on one H100: this tree's split-KV kernel against an
older tree's ``csrc/paged_attention.cu`` (one block per row and kv head),
both behind this tree's wrapper in one process.

    python3 tools/decode_ab.py --parent DIR [--seed 0] [--out FILE]

``DIR`` is a checkout of the older tree (for example ``git archive`` of
the parent commit unpacked under ``build/``). Its kernel is built with
nvcc into ``build/decode_ab/``. Then, on Llama-3-8B from the seed
(``chip_smoke.py``'s model, prompts and ``generate()`` call: batch 4, 128
prompt tokens, 16 new tokens, bf16 and int8 pools):

- ``generate()`` wall time, parent and change in turns (parent, change,
  change, parent, parent, change), and whether their tokens are equal;
- each variant's greedy tokens against a ``generate()`` through the
  plain attention (``chip_smoke.plain_attention_generate``: agreement,
  first flips and their logit margins);
- the kernel alone at ``chip_smoke.py``'s 16-row decode shape, for split
  plans of 4 to 64 blocks an SM (``SPLIT_BLOCKS_PER_SM``), beside the
  parent's kernel: CUDA events, L2 flushed, the card held while the host
  enqueues (``chip_smoke.time_ms``).

Prints one line per measurement and writes them all as JSON to
``--out`` (default ``chiprun_out/decode_ab.json``). Needs one card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from paddle_tpu_torch import flags  # noqa: E402
from paddle_tpu_torch.ops.kernels import _build  # noqa: E402
from paddle_tpu_torch.ops.kernels import paged_attention as pa  # noqa: E402
from paddle_tpu_torch.ops.kernels.quant_common import (  # noqa: E402
    absmax_scale, quantize_symmetric)
from paddle_tpu_torch.ops.kernels.ragged_paged_attention import (  # noqa: E402
    _dtype_name)

PER_SM = (4, 8, 16, 32, 64)
TURNS = ("parent", "change", "change", "parent", "parent", "change")


def parent_kernel(parent: Path):
    """The older tree's gang-decode kernel, built from its source, behind
    the same checks and count as this tree's wrapper."""
    src = parent / "paddle_tpu_torch" / "csrc"
    out = ROOT / "build" / "decode_ab" / "libparent_paged_attention.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, f"-I{src}", "-o",
                        str(out), str(src / "paged_attention.cu")],
                       capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(r.stdout + r.stderr)
    fn = ctypes.CDLL(str(out)).ptt_paged_attention
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int

    def call(q, k_pool, v_pool, block_tables, context_lens, scale=None,
             k_scale=None, v_scale=None):
        pa._check(q, k_pool, v_pool, block_tables, context_lens, k_scale,
                  v_scale)
        B, _, H, D = q.shape
        NB, BS, KV, _ = k_pool.shape
        o = torch.empty_like(q)
        with torch.cuda.device(q.device):
            rc = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                    k_scale.data_ptr() if k_scale is not None else None,
                    v_scale.data_ptr() if v_scale is not None else None,
                    block_tables.data_ptr(), context_lens.data_ptr(),
                    o.data_ptr(), B, H, KV, D, NB, BS,
                    block_tables.shape[1],
                    float(D ** -0.5 if scale is None else scale),
                    _build.DTYPE_CODES[_dtype_name(q)],
                    _build.DTYPE_CODES[_dtype_name(k_pool)],
                    torch.cuda.current_stream(q.device).cuda_stream)
        if rc:
            raise RuntimeError(f"parent kernel: cudaError {rc}")
        pa.launches.add()
        return o
    return call


def generate_ab(model, ids, kernels, res):
    """generate() per variant in turns; tokens against the plain path."""
    change = pa.paged_attention
    for kv in ("bf16", "int8"):
        walls, outs = {}, {}
        flags.set_flags({"kv_cache_dtype": kv})
        try:
            for variant in TURNS:
                pa.paged_attention = kernels[variant]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = model.generate(ids, max_new_tokens=cs.GEN_NEW_TOKENS,
                                     temperature=0.0, cache_type="paged",
                                     block_size=64)
                torch.cuda.synchronize()
                walls.setdefault(variant, []).append(time.perf_counter() - t0)
                outs.setdefault(variant, out)
        finally:
            pa.paged_attention = change
            flags.set_flags({"kv_cache_dtype": "auto"})
        row = dict(wall_s=walls, same_tokens=bool(torch.equal(
            outs["parent"], outs["change"])))
        for variant in ("parent", "change"):
            row[f"{variant}_vs_plain"] = cs.plain_attention_generate(
                torch, model, ids, outs[variant], kv)
        res[f"generate_{kv}"] = row
        cs.log(f"generate[{kv}]: {json.dumps(row)}")


def decode_sweep(seed, parent, res):
    """The kernel at the smoke's 16-row decode shape per split plan."""
    rng = np.random.RandomState(seed)
    _, kp, vp, tbl, _, _ = cs.smoke_layout(torch, rng, torch.bfloat16)
    ctxs = np.array([c for _, c in cs.SMOKE_ROWS], np.int32)
    ctxs[-1], ctxs[-2] = 0, 333
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    qd = torch.randn((len(ctxs), 1, cs.H, cs.D), generator=g,
                     device="cuda").to(torch.bfloat16)
    lens = torch.from_numpy(ctxs).cuda()
    ks, vs = absmax_scale(kp, -1), absmax_scale(vp, -1)
    cases = {"bf16": ((qd, kp, vp, tbl, lens), {}),
             "int8": ((qd, quantize_symmetric(kp, ks[..., None]),
                       quantize_symmetric(vp, vs[..., None]), tbl, lens),
                      dict(k_scale=ks, v_scale=vs))}
    scratch = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    flush = scratch.zero_
    keep = pa.SPLIT_BLOCKS_PER_SM
    try:
        for name, (args, kw) in cases.items():
            want = pa.paged_attention_plain(*args, **kw).float()
            rows = {"parent_ms": cs.time_ms(
                torch, lambda: parent(*args, **kw), flush=flush)}
            for per_sm in PER_SM:
                pa.SPLIT_BLOCKS_PER_SM = per_sm
                pa.split_plan.cache_clear()
                err = float((pa.paged_attention(*args, **kw).float()
                             - want).abs().max())
                rows[per_sm] = dict(
                    plan=pa.call_plan(args[0], args[1], args[3]),
                    max_abs_err=err, ms=cs.time_ms(
                        torch, lambda: pa.paged_attention(*args, **kw),
                        flush=flush))
            res[f"decode_{name}"] = rows
            cs.log(f"decode[{name}] per SM: {json.dumps(rows)}")
    finally:
        pa.SPLIT_BLOCKS_PER_SM = keep
        pa.split_plan.cache_clear()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, required=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=Path,
                    default=ROOT / "chiprun_out" / "decode_ab.json")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("decode_ab: no CUDA device", file=sys.stderr)
        return 1
    cs.log(cs.card_line())
    _build.build_all()
    parent = parent_kernel(a.parent)
    res = {}
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    cfg = LlamaConfig.llama3_8b()
    model = LlamaForCausalLM(cfg, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(a.seed))
    prompts = cs.make_requests(cfg, a.seed)
    ids = torch.from_numpy(np.stack([p[:128] for p in prompts[:4]])).cuda()
    generate_ab(model, ids, {"parent": parent,
                             "change": pa.paged_attention}, res)
    del model
    torch.cuda.empty_cache()
    decode_sweep(a.seed, parent, res)
    a.out.parent.mkdir(parents=True, exist_ok=True)
    a.out.write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
