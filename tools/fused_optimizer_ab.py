"""Fused optimizer A/B on one H100: this tree's bucket kernel against an
older tree's ``csrc/fused_optimizer.cu`` (for example one block of scalar
loads per chunk-table row), both over the same tensors and chunk tables
in one process.

    python3 tools/fused_optimizer_ab.py [--parent DIR] [--seed 0] [--out FILE]

``DIR`` is a checkout of the older tree (for example ``git archive`` of
the parent commit unpacked under ``build/``); its kernel is built with
nvcc into ``build/fused_optimizer_ab/`` and called through its own C
signature (no split argument). Cases, at ``chip_smoke.py``'s shapes:

- Momentum (0.9, L2 1e-4) over ResNet-50's 161 float32 parameters, each
  tensor its own allocation;
- the same over one padded flat buffer of velocities, as the optimizer
  keeps them, and over an unpadded one (views at odd offsets: the
  change's scalar rows);
- AdamW over the 743 M-param bucket of one Llama-3-8B-width layer and the
  embedding (bf16 params and grads, float32 masters and moments);
- Lamb's two passes over that bucket.

Each case is first held bit for bit between the kernels (and the change
against the plain version), then timed in turns parent, change, change,
parent (``chip_smoke.time_ms``: CUDA events, median of 10, L2 flushed,
the card held while the host enqueues), beside ``torch._fused_sgd_`` /
``torch._fused_adamw_``. Then the change's kernel over forced split plans
(1 to 64 blocks a row) for Momentum and AdamW, the occupancy of each
pass, and variants of this tree's source built beside it (``VARIANTS``:
four accesses in flight a stream instead of two; streaming cache hints
``__ldcs`` / ``__stcs`` on every vector access), each timed in turns with
the change over the fresh Momentum, AdamW and Lamb cases. Prints one
line per measurement and writes them all as JSON to ``--out`` (default
``chiprun_out/fused_optimizer_ab.json``). Needs one card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from paddle_tpu_torch.ops.kernels import _build  # noqa: E402
from paddle_tpu_torch.ops.kernels import fused_optimizer as fo  # noqa: E402

TURNS = ("parent", "change", "change", "parent")
# text edits of this tree's csrc/fused_optimizer.cu, each built on its own
VARIANTS = {
    "unroll4": [("constexpr int kUnroll = 2;", "constexpr int kUnroll = 4;")],
    "streaming": [
        ("*reinterpret_cast<const float4*>(p + i)",
         "__ldcs(reinterpret_cast<const float4*>(p + i))"),
        ("*reinterpret_cast<const uint2*>(p + i)",
         "__ldcs(reinterpret_cast<const uint2*>(p + i))"),
        ("*reinterpret_cast<float4*>(p + i) = make_float4(x[0], x[1], x[2], "
         "x[3]);", "__stcs(reinterpret_cast<float4*>(p + i), make_float4("
         "x[0], x[1], x[2], x[3]));"),
        ("*reinterpret_cast<uint2*>(p + i) = v;",
         "__stcs(reinterpret_cast<uint2*>(p + i), v);")],
}
SPLITS = (1, 2, 4, 8, 16, 32, 64)
MOMENTUM = {"momentum": 0.9, "nesterov": False}
ADAMW = {"b1": 0.9, "b2": 0.999, "eps": 1e-8, "decoupled": True}


def parent_library(parent: Path):
    src = parent / "paddle_tpu_torch" / "csrc"
    out = ROOT / "build" / "fused_optimizer_ab" / "libparent_fused.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, f"-I{src}", "-o",
                        str(out), str(src / "fused_optimizer.cu")],
                       capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(r.stdout + r.stderr)
    fn = ctypes.CDLL(str(out)).ptt_fused_optimizer
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
                   + [ctypes.c_int] * 5 + [ctypes.c_float] * 6
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def variant_library(name: str):
    """This tree's kernel with ``VARIANTS[name]``'s edits, built beside
    it and bound as the wrapper binds its own."""
    src = (_build.CSRC / "fused_optimizer.cu").read_text()
    for old, new in VARIANTS[name]:
        if old not in src:
            raise RuntimeError(f"variant {name}: {old!r} not in the source")
        src = src.replace(old, new)
    out = ROOT / "build" / "fused_optimizer_ab" / f"{name}.cu"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(src)
    lib = out.with_suffix(".so")
    r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS,
                        f"-I{_build.CSRC}", "-o", str(lib), str(out)],
                       capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(r.stdout + r.stderr)
    cdll = ctypes.CDLL(str(lib))
    fo._bind(cdll)
    return cdll


def variant_case(tag, name, lib, kind, cfg, A, lr, wd, low, flush, res):
    """The change and a variant in turns, the variant first held bit for
    bit against the change (the wrapper pointed at its library)."""
    sv = svec_for(kind, cfg, lr, wd)
    b = plan(kind, cfg, A, low, wd)
    keep = _build.load
    own = keep("fused_optimizer", fo._bind)

    def use(which):
        _build.load = lambda stem, bind=None: which

    try:
        copy = clone(A)
        fo.fused_bucket_kernel(kind, cfg, *A, sv, b)
        use(lib)
        fo.fused_bucket_kernel(kind, cfg, *copy, sv, b)
        torch.cuda.synchronize()
        same(A, copy, f"{tag}: {name} vs change")
        del copy
        row = {}
        for turn in ("change", name, name, "change"):
            use(own if turn == "change" else lib)
            row.setdefault(f"{turn}_ms", []).append(cs.time_ms(
                torch, lambda: fo.fused_bucket_kernel(kind, cfg, *A, sv, b),
                flush=flush))
    finally:
        _build.load = keep
    res[f"{tag}_{name}"] = row
    cs.log(f"{tag} {name}: {json.dumps(row)}")


def parent_pass(fn, name, kind, cfg, A, svec, bucket, scratch=None):
    """One launch of the parent's kernel over this tree's chunk table."""
    table, n = fo._chunk_table(bucket, kind, *A, scratch)
    f = lambda key: float(cfg.get(key, 0.0))  # noqa: E731
    rc = fn(table.data_ptr(), n, svec.data_ptr(), fo.PASSES[name][0],
            _build.DTYPE_CODES[fo._dtype_name(A[0][0])],
            _build.DTYPE_CODES[fo._dtype_name(A[1][0])],
            int(bool(cfg.get("decoupled", False))),
            int(bool(cfg.get("nesterov", False))),
            f("b1"), 1.0 - f("b1"), f("b2"), 1.0 - f("b2"), f("eps"),
            f("momentum"), torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"parent kernel: cudaError {rc}")


def parent_bucket(fn, kind, cfg, A, svec, bucket):
    if kind != "lamb":
        return parent_pass(fn, kind, kind, cfg, A, svec, bucket)
    scratch = fo.lamb_scratch(A[0], bucket)
    parent_pass(fn, "lamb_moments", kind, cfg, A, svec, bucket, scratch)
    fo.lamb_trust_ratios(A[0], scratch[0], out=scratch[1])
    parent_pass(fn, "lamb_apply", kind, cfg, A, svec, bucket, scratch)


def clone(A):
    return ([t.clone() for t in A[0]], [t.clone() for t in A[1]],
            [{k: t.clone() for k, t in s.items()} for s in A[2]],
            [None if t is None else t.clone() for t in A[3]])


def flat(A):
    return A[0] + [t for t in A[3] if t is not None] + [
        t for s in A[2] for t in s.values()]


def same(a, b, tag):
    for x, y in zip(flat(a), flat(b)):
        if not torch.equal(x, y):
            raise AssertionError(f"{tag}: {int((x != y).sum())} elements "
                                 f"differ")


def svec_for(kind, cfg, lr, wd):
    one = torch.ones((), device="cuda")
    bc1, bc2 = fo.bias_inv(cfg.get("b1", 0.9), cfg.get("b2", 0.999), one * 2)
    return fo.pack_scalars(lr=one * lr, step=one * 2, inv=one / 64,
                           coeff=one * 0.5, found=one * 0, wd=one * wd,
                           inv_bc1=bc1, inv_bc2=bc2)


def plan(kind, cfg, A, low, wd):
    return fo.plan_buckets(kind, cfg, [
        (tuple(t.shape), fo._dtype_name(t), fo._dtype_name(g), low, wd)
        for t, g in zip(A[0], A[1])]).buckets[0]


def ab_case(tag, kind, cfg, A, lr, wd, low, parent, flush, res, lib=None):
    """Bit for bit: change vs plain vs parent; then the turns."""
    sv = svec_for(kind, cfg, lr, wd)
    b_change, b_parent = plan(kind, cfg, A, low, wd), plan(kind, cfg, A,
                                                           low, wd)
    copy = clone(A)
    fo.fused_bucket_kernel(kind, cfg, *A, sv, b_change)
    fo.fused_bucket_plain(kind, cfg, *copy, sv)
    torch.cuda.synchronize()
    same(A, copy, f"{tag}: change vs plain")
    row = {"params": sum(t.numel() for t in A[0])}
    if parent is not None:
        parent_bucket(parent, kind, cfg, copy, sv, b_parent)
        fo.fused_bucket_kernel(kind, cfg, *A, sv, b_change)
        torch.cuda.synchronize()
        same(A, copy, f"{tag}: change vs parent")
    del copy
    run = {"change": lambda: fo.fused_bucket_kernel(kind, cfg, *A, sv,
                                                    b_change),
           "parent": lambda: parent_bucket(parent, kind, cfg, A, sv,
                                           b_parent)}
    for turn in TURNS if parent is not None else ("change", "change"):
        row.setdefault(f"{turn}_ms", []).append(
            cs.time_ms(torch, run[turn], flush=flush))
    if lib is not None:
        row["library_ms"] = cs.time_ms(torch, lib, flush=flush)
    res[tag] = row
    cs.log(f"{tag}: {json.dumps(row)}")


def split_sweep(tag, kind, cfg, A, lr, wd, low, flush, res):
    sv = svec_for(kind, cfg, lr, wd)
    b = plan(kind, cfg, A, low, wd)
    keep = fo.split_plan
    rows = {"planned": keep(fo.table_rows(A[0])[0],
                            _build.sm_count(A[0][0].device))}
    try:
        for s in SPLITS:
            fo.split_plan = lambda r, sms, s=s: s
            rows[s] = cs.time_ms(torch, lambda: fo.fused_bucket_kernel(
                kind, cfg, *A, sv, b), flush=flush)
    finally:
        fo.split_plan = keep
    res[f"{tag}_split"] = rows
    cs.log(f"{tag} split: {json.dumps(rows)}")


def resnet50_shapes():
    from paddle_tpu_torch.vision import models
    import paddle_tpu_torch
    paddle_tpu_torch.set_device("cpu")
    try:
        return [tuple(p.shape) for p in models.resnet50().parameters()]
    finally:
        paddle_tpu_torch.set_device(None)


def momentum_bucket(shapes, g, layout):
    """params and grads their own allocations; velocities too ("fresh"),
    or views into one flat buffer, padded as the optimizer pads them
    ("padded") or at unpadded offsets ("unpadded")."""
    ps = [torch.randn(s, generator=g, device="cuda") * 0.05 for s in shapes]
    gs = [torch.randn(s, generator=g, device="cuda") * 1e-3 for s in shapes]
    if layout == "fresh":
        vs = [torch.rand(s, generator=g, device="cuda") * 1e-3
              for s in shapes]
    else:
        step = fo.STATE_ALIGN // 4 if layout == "padded" else 1
        sizes = [int(np.prod(s)) for s in shapes]
        offs = np.cumsum([0] + [-(-n // step) * step for n in sizes])
        buf = torch.rand(int(offs[-1]), generator=g, device="cuda") * 1e-3
        vs = [buf[o:o + n].view(s)
              for o, n, s in zip(offs.tolist(), sizes, shapes)]
    return ps, gs, [{"velocity": v} for v in vs], [None] * len(shapes)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=Path,
                    default=ROOT / "chiprun_out" / "fused_optimizer_ab.json")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("fused_optimizer_ab: no CUDA device", file=sys.stderr)
        return 1
    res = {"card": cs.card_line()}
    cs.log(res["card"])
    _build.build_all()
    parent = parent_library(a.parent) if a.parent else None
    scratch = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    flush = scratch.zero_
    g = torch.Generator(device="cuda").manual_seed(a.seed)
    shapes = resnet50_shapes()
    variants = {name: variant_library(name) for name in VARIANTS}
    for layout in ("fresh", "padded", "unpadded"):
        A = momentum_bucket(shapes, g, layout)
        before = fo.unaligned_rows
        bufs = [s["velocity"] for s in A[2]]
        ab_case(f"momentum_resnet50_{layout}", "momentum", MOMENTUM, A, 0.1,
                1e-4, None, parent, flush, res,
                lib=lambda: torch._fused_sgd_(
                    A[0], A[1], bufs, weight_decay=1e-4, momentum=0.9,
                    lr=0.1, dampening=0.0, nesterov=False, maximize=False,
                    is_first_step=False))
        res[f"momentum_resnet50_{layout}"]["unaligned_rows"] = \
            fo.unaligned_rows - before
        if layout == "fresh":
            split_sweep("momentum_resnet50", "momentum", MOMENTUM, A, 0.1,
                        1e-4, None, flush, res)
            for name, lib in variants.items():
                variant_case("momentum_resnet50", name, lib, "momentum",
                             MOMENTUM, A, 0.1, 1e-4, None, flush, res)
        del A, bufs
    A = cs.fused_bucket_tensors(torch, g)
    g32 = [x.float() for x in A[1]]
    steps_t = [torch.full((), 2.0, device="cuda") for _ in A[0]]
    ab_case("adamw_743m", "adam", ADAMW, A, 1e-4, 0.01, "bfloat16", parent,
            flush, res, lib=lambda: torch._fused_adamw_(
                A[0], g32, [s["m"] for s in A[2]], [s["v"] for s in A[2]],
                [], steps_t, lr=1e-4, beta1=0.9, beta2=0.999,
                weight_decay=0.01, eps=1e-8, amsgrad=False, maximize=False))
    del g32
    split_sweep("adamw_743m", "adam", ADAMW, A, 1e-4, 0.01, "bfloat16",
                flush, res)
    ab_case("lamb_743m", "lamb", cs.LAMB_CFG, A, 1e-4, 0.01, "bfloat16",
            parent, flush, res)
    for name, lib in variants.items():
        variant_case("adamw_743m", name, lib, "adam", ADAMW, A, 1e-4, 0.01,
                     "bfloat16", flush, res)
        variant_case("lamb_743m", name, lib, "lamb", cs.LAMB_CFG, A, 1e-4,
                     0.01, "bfloat16", flush, res)
    res["blocks_per_sm"] = {
        f"{name}_{c}_{gd}": fo.blocks_per_sm(name, {}, c, gd)
        for name in fo.PASSES for c in fo.DTYPES for gd in fo.DTYPES}
    cs.log(f"blocks per SM: {json.dumps(res['blocks_per_sm'])}")
    a.out.parent.mkdir(parents=True, exist_ok=True)
    a.out.write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
