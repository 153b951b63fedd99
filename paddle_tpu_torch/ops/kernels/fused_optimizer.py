"""Fused optimizer update: one kernel launch per parameter bucket.

Replaces ``paddle_tpu/ops/kernels/pallas/fused_optimizer.py``:
``plan_buckets`` (:116, host metadata only), ``fused_apply`` (:453) and
the elementwise bucket kernel (``_pallas_elementwise_bucket`` :295 via
``_bucket_kernel_call`` :279) for the rules ``sgd``, ``momentum`` and
``adam`` (``decoupled`` for AdamW). Each launch fuses the GradScaler
unscale (``inv``), the global-norm clip coefficient (``coeff``), the
rule, the anomaly-sentinel select (``found``: every output keeps its old
value bitwise) and the bf16 write-back from the float32 master. Lamb's
two bucket passes (``_pallas_lamb_bucket``) wait for the Lamb optimizer.

What bounds it on the H100: bytes. AdamW over a bf16 parameter with a
float32 master moves 28 bytes per element (grad 2 + master 4 + m 4 + v 4
read, master 4 + m 4 + v 4 + param 2 written) for ~20 flops. The kernel
(``csrc/fused_optimizer.cu``) reads each once and writes each once, in
place: where the reference gathers every parameter, grad and state of a
bucket into new flat ``(rows, 128)`` buffers each step (a TPU tiling
need), the kernel walks a device table of (pointer, count) chunks over
the optimizer's own tensors, so no second copy of anything exists.

Bitwise contract: the kernel rounds each operation separately, in the
order of :func:`rule`, so at float32 it equals the plain version (the
same rule in torch ops) bit for bit on masters, moments and bf16 params.

Beside the kernel: ``fused_bucket_plain``, the plain version (the
per-parameter rule chain in torch ops), used for CPU tensors, by the tests
and by ``chip_smoke.py``; and ``launches``, the count of kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import _build

launches = _build.LaunchCounter("fused_optimizer")

# Optimizer rules with a fused route, and their state slots. Lamb's
# layout is planned like the reference's, but its bucket passes are not
# ported: the port has no Lamb optimizer yet.
STATE_KEYS: Dict[str, Tuple[str, ...]] = {
    "sgd": (),
    "momentum": ("velocity",),
    "adam": ("m", "v"),
    "lamb": ("m", "v"),
}
KINDS = {"sgd": 0, "momentum": 1, "adam": 2}   # kernel codes
DTYPES = ("float32", "bfloat16")               # compute and grad dtypes
CHUNK = 1 << 16                                # elements per table row


class Bucket:
    """Parameters that share (compute dtype, grad dtype, write-back
    dtype, weight decay), with their offsets in the bucket's flat state."""

    __slots__ = ("ids", "offsets", "sizes", "shapes", "total", "cdtype",
                 "gdtype", "low", "wd", "table")

    def __init__(self, ids, offsets, sizes, shapes, cdtype, gdtype, low, wd):
        self.ids = tuple(ids)
        self.offsets = tuple(offsets)
        self.sizes = tuple(sizes)
        self.shapes = tuple(shapes)
        self.total = int(offsets[-1] + sizes[-1]) if sizes else 0
        self.cdtype = cdtype
        self.gdtype = gdtype
        self.low = low
        self.wd = float(wd)
        self.table = None   # (pointer key, device chunk table, rows)


class BucketPlan:
    """The bucket layout of one optimizer's parameter structure."""

    __slots__ = ("kind", "cfg", "buckets", "state_keys", "n_params")

    def __init__(self, kind: str, cfg: Dict, buckets: Sequence[Bucket],
                 n_params: int):
        self.kind = kind
        self.cfg = dict(cfg)
        self.buckets = tuple(buckets)
        self.state_keys = STATE_KEYS[kind]
        self.n_params = n_params


def plan_buckets(kind: str, cfg: Dict, specs: Sequence[Tuple]) -> BucketPlan:
    """``specs[k] = (shape, compute_dtype, grad_dtype, low_dtype_or_None,
    wd)`` for the k-th parameter. Groups by (compute dtype, grad dtype,
    write-back dtype, wd), buckets in order of their first parameter,
    offsets in parameter order: the reference's grouping exactly."""
    groups: Dict[Tuple, List[int]] = {}
    for k, (shape, cdt, gdt, low, wd) in enumerate(specs):
        groups.setdefault((str(cdt), str(gdt),
                           None if low is None else str(low),
                           float(wd)), []).append(k)
    buckets = []
    for (cdt, gdt, low, wd), ids in sorted(groups.items(),
                                           key=lambda kv: kv[1][0]):
        offsets, sizes, shapes, off = [], [], [], 0
        for k in ids:
            shape = tuple(specs[k][0])
            size = int(np.prod(shape)) if shape else 1
            offsets.append(off)
            sizes.append(size)
            shapes.append(shape)
            off += size
        buckets.append(Bucket(ids, offsets, sizes, shapes, cdt, gdt, low,
                              wd))
    return BucketPlan(kind, cfg, buckets, len(specs))


# -- the rule, in torch ops ---------------------------------------------------

def bias_inv(b1: float, b2: float, step: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(1/(1 - b1^step), 1/(1 - b2^step))`` as float32 device scalars,
    computed once per step (the reference's ``_bias_inv``)."""
    step = step.float()
    return 1.0 / (1.0 - b1 ** step), 1.0 / (1.0 - b2 ** step)


def rule(kind: str, cfg: Dict, p, g, state, lr, wd, inv_bc1=None,
         inv_bc2=None):
    """One parameter's update in its compute dtype: ``(new_p,
    new_state)``. ``g`` is already conditioned and cast to ``p.dtype``;
    ``lr``/``wd``/``inv_bc*`` are float32 device scalars, cast to the
    compute dtype first. One torch op per rounding, in the kernel's
    order (the reference's ``_rule_core``)."""
    lr = lr.to(p.dtype)
    wd = wd.to(p.dtype)
    if kind == "sgd":
        return p - lr * (g + wd * p), {}
    if kind == "momentum":
        mom = cfg["momentum"]
        gw = g + wd * p
        v = mom * state["velocity"] + gw
        upd = gw + mom * v if cfg["nesterov"] else v
        return p - lr * upd, {"velocity": v}
    if kind != "adam":
        raise ValueError(f"no fused rule for {kind!r}")
    b1, b2, eps = cfg["b1"], cfg["b2"], cfg["eps"]
    if not cfg["decoupled"]:
        g = g + wd * p
    m = b1 * state["m"] + (1 - b1) * g
    v = b2 * state["v"] + (1 - b2) * (g * g)
    upd = (m * inv_bc1.to(p.dtype)) / (
        torch.sqrt(v * inv_bc2.to(p.dtype)) + eps)
    if cfg["decoupled"]:
        upd = upd + wd * p
    return p - lr * upd, {"m": m, "v": v}


def condition_grad(g, inv=None, coeff=None):
    """The grad times ``inv`` (GradScaler unscale), then times ``coeff``
    (global-norm clip), each in the grad's dtype; None skips a multiply.
    The rule's cast to the compute dtype comes after."""
    if inv is not None:
        g = g * inv.to(g.dtype)
    if coeff is not None:
        g = g * coeff.to(g.dtype)
    return g


# -- scalars ------------------------------------------------------------------

SLOTS = ("lr", "step", "inv", "coeff", "found", "wd", "inv_bc1", "inv_bc2")


def pack_scalars(**sv) -> torch.Tensor:
    """The kernel's scalar vector ``[lr, step, inv, coeff, found, wd,
    inv_bc1, inv_bc2]``, float32 on the device, built there from device
    scalars (no host sync)."""
    return torch.stack([sv[k].float().reshape(()) for k in SLOTS])


def fused_bucket_plain(kind: str, cfg: Dict, targets, grads, states, lows,
                       svec: torch.Tensor) -> None:
    """Plain version of one bucket launch, in place: per parameter the
    conditioned grad, :func:`rule`, the sentinel select and the
    low-precision write-back. ``targets[k]`` is the float32 master (or
    the parameter itself), ``states[k]`` its state dict, ``lows[k]`` the
    bf16 parameter to write back, or None."""
    sv = dict(zip(SLOTS, svec.unbind()))
    found = sv["found"] > 0
    for p, g, s, low in zip(targets, grads, states, lows):
        gc = condition_grad(g, sv["inv"], sv["coeff"]).to(p.dtype)
        new_p, new_s = rule(kind, cfg, p, gc, s, sv["lr"], sv["wd"],
                            sv["inv_bc1"], sv["inv_bc2"])
        for key, val in new_s.items():
            s[key].copy_(torch.where(found, s[key], val))
        p.copy_(torch.where(found, p, new_p))
        if low is not None:
            low.copy_(p.to(low.dtype))


# -- the kernel ---------------------------------------------------------------

def _bind(lib) -> None:
    fn = lib.ptt_fused_optimizer
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
                   + [ctypes.c_int] * 5 + [ctypes.c_float] * 6
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def _check(kind, targets, grads, states, lows, svec) -> None:
    dev = targets[0].device
    if kind not in KINDS:
        raise ValueError(f"no fused kernel for rule {kind!r}")
    if svec.device != dev or svec.dtype != torch.float32 \
            or tuple(svec.shape) != (len(SLOTS),):
        raise ValueError(f"svec must be float32 [{len(SLOTS)}] on {dev}")
    cdt, gdt = targets[0].dtype, grads[0].dtype
    if _dtype_name(targets[0]) not in DTYPES or _dtype_name(grads[0]) \
            not in DTYPES:
        raise ValueError(f"compute dtype {cdt}, grad dtype {gdt}: the "
                         f"kernel takes {DTYPES}")
    for p, g, s, low in zip(targets, grads, states, lows):
        ts = [("param", p, cdt), ("grad", g, gdt)]
        ts += [(k, s[k], cdt) for k in STATE_KEYS[kind]]
        if low is not None:
            ts.append(("low", low, torch.bfloat16))
        for name, t, dt in ts:
            if t.device != dev or t.dtype != dt or not t.is_contiguous() \
                    or t.numel() != p.numel():
                raise ValueError(
                    f"{name}: must be a contiguous {dt} tensor of "
                    f"{p.numel()} elements on {dev}, got {t.dtype} "
                    f"{tuple(t.shape)} on {t.device}")


def chunk_rows(kind, targets, grads, states, lows) -> np.ndarray:
    """The kernel's chunk table on the host, int64 ``[n, 6]``: per run of
    at most ``CHUNK`` elements of one parameter, the addresses of its
    param (or master), grad, bf16 write-back (0 if none) and two state
    slots (0 if unused), and its element count."""
    keys = STATE_KEYS[kind]
    rows = []
    for p, g, s, low in zip(targets, grads, states, lows):
        start = np.arange(0, p.numel(), CHUNK, dtype=np.int64)

        def at(t):   # the chunks' addresses in t; a missing tensor is 0
            return np.zeros_like(start) if t is None \
                else t.data_ptr() + start * t.element_size()

        slots = [s[k] for k in keys] + [None] * (2 - len(keys))
        rows.append(np.stack([at(p), at(g), at(low), at(slots[0]),
                              at(slots[1]),
                              np.minimum(CHUNK, p.numel() - start)], axis=1))
    return np.concatenate(rows) if rows else np.zeros((0, 6), np.int64)


def _chunk_table(bucket: Optional[Bucket], kind, targets, grads, states,
                 lows) -> Tuple[torch.Tensor, int]:
    """:func:`chunk_rows` on the device, rebuilt only when a pointer moved
    (grads are new tensors after every ``clear_grad``)."""
    key = tuple(t.data_ptr() for ts in (targets, grads, lows)
                for t in ts if t is not None) + tuple(
        t.data_ptr() for s in states for t in s.values())
    if bucket is not None and bucket.table is not None \
            and bucket.table[0] == key:
        return bucket.table[1], bucket.table[2]
    host = chunk_rows(kind, targets, grads, states, lows)
    table = torch.from_numpy(host).pin_memory().to(targets[0].device,
                                                   non_blocking=True)
    if bucket is not None:
        bucket.table = (key, table, len(host))
    return table, len(host)


def fused_bucket_kernel(kind: str, cfg: Dict, targets, grads, states, lows,
                        svec: torch.Tensor, bucket: Optional[Bucket] = None
                        ) -> None:
    """One kernel launch over the bucket, in place; same result as
    :func:`fused_bucket_plain`. ``bucket`` caches the chunk table."""
    _check(kind, targets, grads, states, lows, svec)
    table, nchunks = _chunk_table(bucket, kind, targets, grads, states, lows)
    if nchunks == 0:
        return
    lib = _build.load("fused_optimizer", _bind)
    dev = targets[0].device
    f = lambda name: float(cfg.get(name, 0.0))  # noqa: E731
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.ptt_fused_optimizer(
            table.data_ptr(), nchunks, svec.data_ptr(), KINDS[kind],
            _build.DTYPE_CODES[_dtype_name(targets[0])],
            _build.DTYPE_CODES[_dtype_name(grads[0])],
            int(bool(cfg.get("decoupled", False))),
            int(bool(cfg.get("nesterov", False))),
            f("b1"), 1.0 - f("b1"), f("b2"), 1.0 - f("b2"), f("eps"),
            f("momentum"), stream)
    if rc != 0:
        raise RuntimeError(f"fused_optimizer kernel launch failed: "
                           f"cudaError {rc}")
    launches.add()


def fused_bucket(kind: str, cfg: Dict, targets, grads, states, lows,
                 svec: torch.Tensor, bucket: Optional[Bucket] = None) -> None:
    """A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel or raises."""
    dev = targets[0].device
    if dev.type == "cpu":
        return fused_bucket_plain(kind, cfg, targets, grads, states, lows,
                                  svec)
    if dev.type != "cuda":
        raise ValueError(f"fused_optimizer: no kernel for {dev}")
    return fused_bucket_kernel(kind, cfg, targets, grads, states, lows, svec,
                               bucket)


def fused_apply(plan: BucketPlan, targets, grads, states, lows, lr, step,
                inv, coeff, found, wd_list) -> None:
    """Apply one step to every bucket of ``plan``, in place. Lists are in
    the plan's parameter order; ``lr``, ``step``, ``inv``, ``coeff`` and
    ``found`` are device scalars (1, 1, 0 for inv/coeff/found when
    inactive: the multiplies and the select are then exact identities),
    ``wd_list`` one float32 device scalar per bucket."""
    if plan.kind not in KINDS:
        raise ValueError(f"no fused kernel for rule {plan.kind!r}")
    if plan.kind == "adam":
        bc1, bc2 = bias_inv(plan.cfg["b1"], plan.cfg["b2"], step)
    else:
        bc1 = bc2 = torch.ones((), dtype=torch.float32, device=step.device)
    for bucket, wd in zip(plan.buckets, wd_list):
        svec = pack_scalars(lr=lr, step=step, inv=inv, coeff=coeff,
                            found=found, wd=wd, inv_bc1=bc1, inv_bc2=bc2)
        ids = bucket.ids
        fused_bucket(plan.kind, plan.cfg, [targets[k] for k in ids],
                     [grads[k] for k in ids], [states[k] for k in ids],
                     [lows[k] for k in ids], svec, bucket)
