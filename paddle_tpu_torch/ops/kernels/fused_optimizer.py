"""Fused optimizer update: one kernel launch per parameter bucket (two
for Lamb).

Replaces ``paddle_tpu/ops/kernels/pallas/fused_optimizer.py``:
``plan_buckets`` (:116, host metadata only), ``fused_apply`` (:453), the
elementwise bucket kernel (``_pallas_elementwise_bucket`` :295 via
``_bucket_kernel_call`` :279) for the rules ``sgd``, ``momentum`` and
``adam`` (``decoupled`` for AdamW), and Lamb's two bucket passes
(``_pallas_lamb_bucket`` :329) around its per-parameter norms
(``_lamb_ratios`` :365). Each launch fuses the GradScaler unscale
(``inv``), the global-norm clip coefficient (``coeff``), the rule, the
anomaly-sentinel select (``found``: every output keeps its old value
bitwise) and the bf16 write-back from the float32 master.

Lamb is three steps: the ``lamb_moments`` kernel writes the guarded new
moments and the raw ``tr_div`` into a scratch buffer; ``lamb_trust_ratios``
reduces each parameter's ``‖p‖`` and ``‖tr_div‖`` in torch; the
``lamb_apply`` kernel reads each parameter's ratio through a pointer and
applies ``p - (lr·r)·tr_div``. The norms stay in torch so that the fused
route and the per-parameter route reduce the same tensors with the same
torch reduction (a reduction of the kernel's own would round otherwise).

What bounds it on the H100: bytes. AdamW over a bf16 parameter with a
float32 master moves 28 bytes per element (grad 2 + master 4 + m 4 + v 4
read, master 4 + m 4 + v 4 + param 2 written) for ~20 flops. Lamb moves
26 bytes in its first pass (``tr_div`` 4 written), 8 in the norms and 14
in its second pass (master 4 + ``tr_div`` 4 read, master 4 + param 2
written): 48 against the 28 its inputs and outputs need. The kernel
(``csrc/fused_optimizer.cu``) reads each once and writes each once, in
place: where the reference gathers every parameter, grad and state of a
bucket into new flat ``(rows, 128)`` buffers each step (a TPU tiling
need), the kernel walks a device table of (pointer, count) chunks over
the optimizer's own tensors, so no second copy of anything exists. Lamb's
one addition is its scratch: one buffer per bucket in the compute dtype,
kept with the plan (4 B per parameter over float32 masters), and one
float32 ratio per parameter.

How it fills the card (``csrc/fused_optimizer.cu`` has the design): each
thread moves 4 elements an access and keeps two accesses of every stream
in flight; the grid is (rows, ``split``), each chunk-table row cut into
``split`` equal parts (:func:`split_plan`: enough blocks for
``BLOCKS_PER_SM`` an SM, so a mid-sized bucket such as ResNet-50's 508
rows fills the card, a large one keeps one block a row). A row whose
pointers are not all aligned to one access runs element by element in the
same kernel; :func:`chunk_rows` counts such rows in ``unaligned_rows``
(the optimizer's state views start on ``STATE_ALIGN``-byte boundaries, so
a training bucket has none).

Bitwise contract: the kernel rounds each operation separately, in the
order of :func:`rule` (:func:`lamb_moments`, :func:`lamb_apply`), so at
float32 it equals the plain version (the same rule in torch ops) bit for
bit on masters, moments and bf16 params.

Beside the kernel: ``fused_bucket_plain``, the plain version (the
per-parameter rule chain in torch ops), used for CPU tensors, by the tests
and by ``chip_smoke.py``; and the launch counters ``fused_optimizer``
(the elementwise rules), ``fused_optimizer_lamb_moments`` and
``fused_optimizer_lamb_apply``.
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import _build

launches = _build.LaunchCounter("fused_optimizer")
launches_lamb_moments = _build.LaunchCounter("fused_optimizer_lamb_moments")
launches_lamb_apply = _build.LaunchCounter("fused_optimizer_lamb_apply")

# Optimizer rules with a fused route, and their state slots.
STATE_KEYS: Dict[str, Tuple[str, ...]] = {
    "sgd": (),
    "momentum": ("velocity",),
    "adam": ("m", "v"),
    "lamb": ("m", "v"),
}
# each rule's kernel passes, in launch order
KINDS: Dict[str, Tuple[str, ...]] = {
    "sgd": ("sgd",), "momentum": ("momentum",), "adam": ("adam",),
    "lamb": ("lamb_moments", "lamb_apply")}
PASSES = {"sgd": (0, launches), "momentum": (1, launches),       # kernel
          "adam": (2, launches),                                # codes
          "lamb_moments": (3, launches_lamb_moments),
          "lamb_apply": (4, launches_lamb_apply)}
DTYPES = ("float32", "bfloat16")               # compute and grad dtypes
CHUNK = 1 << 16                                # elements per table row
ROW = 8                                        # int64 words per table row
VEC = 4                                        # elements a kernel access
SWEEP = 256 * VEC                              # elements a block step
BLOCKS_PER_SM = 32                             # the split plan's target
# the optimizer's state and master views start on this many bytes, so
# every row of a training bucket takes the kernel's vector path
STATE_ALIGN = 64
# Lamb's tr_div segments start on 512-byte boundaries, as a new tensor
# does: torch's reductions pick their vector loads by alignment, so the
# norm of a segment then equals the per-param route's norm bit for bit
SCRATCH_ALIGN = 512


class Bucket:
    """Parameters that share (compute dtype, grad dtype, write-back
    dtype, weight decay), with their offsets in the bucket's flat state."""

    __slots__ = ("ids", "offsets", "sizes", "shapes", "total", "cdtype",
                 "gdtype", "low", "wd", "table", "scratch", "svec")

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
        self.scratch = None  # Lamb: (tr_div views, ratios), see lamb_scratch
        self.svec = None     # the scalar vector the bucket's launches read


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


def adam_step(cfg: Dict, p, g, state, wd, inv_bc1, inv_bc2,
              decoupled: bool):
    """Adam's new moments and update direction, ``(m, v, upd)``; the
    weight decay goes into the grad, or (``decoupled``) into ``upd``."""
    b1, b2, eps = cfg["b1"], cfg["b2"], cfg["eps"]
    if not decoupled:
        g = g + wd * p
    m = b1 * state["m"] + (1 - b1) * g
    v = b2 * state["v"] + (1 - b2) * (g * g)
    upd = (m * inv_bc1.to(p.dtype)) / (
        torch.sqrt(v * inv_bc2.to(p.dtype)) + eps)
    if decoupled:
        upd = upd + wd * p
    return m, v, upd


def rule(kind: str, cfg: Dict, p, g, state, lr, wd, inv_bc1=None,
         inv_bc2=None):
    """One parameter's update in its compute dtype: ``(new_p,
    new_state)``. ``g`` is already conditioned and cast to ``p.dtype``;
    ``lr``/``wd``/``inv_bc*`` are float32 device scalars, cast to the
    compute dtype first. One torch op per rounding, in the kernel's
    order (the reference's ``_rule_core``). Lamb is
    :func:`lamb_moments`, :func:`lamb_trust_ratio`, :func:`lamb_apply`."""
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
    m, v, upd = adam_step(cfg, p, g, state, wd, inv_bc1, inv_bc2,
                          cfg["decoupled"])
    return p - lr * upd, {"m": m, "v": v}


def lamb_moments(cfg: Dict, p, g, state, wd, inv_bc1, inv_bc2):
    """Lamb's first step (the reference's ``_lamb_moments``): ``(m, v,
    tr_div)`` with the raw ``tr_div = (m·bc1)/(sqrt(v·bc2)+eps) + wd·p``,
    Adam's chain with the weight decay always in the direction."""
    return adam_step(cfg, p, g, state, wd.to(p.dtype), inv_bc1, inv_bc2,
                     True)


def lamb_trust_ratios(ps, trs, out: Optional[torch.Tensor] = None):
    """Each parameter's trust ratio ``‖p‖/‖tr_div‖``, or 1 when either
    norm is 0 (the reference's ``_lamb_ratios``), in the params' dtype:
    one torch reduction of each param-shaped tensor, the norms stacked,
    then the ratio elementwise, so a parameter's ratio is the same bits
    alone or in its bucket. Written into ``out`` (the kernel's float32
    ratio buffer) when given."""
    pn = torch.stack([torch.linalg.vector_norm(p) for p in ps])
    tn = torch.stack([torch.linalg.vector_norm(t) for t in trs])
    one = torch.ones_like(tn)
    r = torch.where((pn > 0) & (tn > 0), pn / torch.where(tn > 0, tn, one),
                    one)
    return r if out is None else out.copy_(r)


def lamb_trust_ratio(p, tr_div):
    """One parameter's :func:`lamb_trust_ratios`, a 0-d tensor: the
    per-param route's call of the same helper."""
    return lamb_trust_ratios([p], [tr_div])[0]


def lamb_apply(p, tr_div, r, lr):
    """Lamb's last step (the reference's ``_lamb_apply``):
    ``p - (lr·r)·tr_div`` in p's dtype."""
    return p - (lr.to(p.dtype) * r.to(p.dtype)) * tr_div


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


def pack_scalars(out: Optional[torch.Tensor] = None, **sv) -> torch.Tensor:
    """The kernel's scalar vector ``[lr, step, inv, coeff, found, wd,
    inv_bc1, inv_bc2]``, float32 on the device, built there from device
    scalars (no host sync); written into ``out`` when given."""
    return torch.stack([sv[k].float().reshape(()) for k in SLOTS], out=out)


def _write_back(p, new_p, low, found) -> None:
    """The sentinel select into ``p`` and the low-precision write-back."""
    p.copy_(torch.where(found, p, new_p))
    if low is not None:
        low.copy_(p.to(low.dtype))


def _conditioned(g, p, sv):
    return condition_grad(g, sv["inv"], sv["coeff"]).to(p.dtype)


def lamb_moments_plain(cfg: Dict, targets, grads, states, svec
                       ) -> List[torch.Tensor]:
    """Plain version of the ``lamb_moments`` pass, in place on the
    states: the guarded new moments; returns each parameter's raw
    ``tr_div``."""
    sv = dict(zip(SLOTS, svec.unbind()))
    found = sv["found"] > 0
    trs = []
    for p, g, s in zip(targets, grads, states):
        m, v, trd = lamb_moments(cfg, p, _conditioned(g, p, sv), s, sv["wd"],
                                 sv["inv_bc1"], sv["inv_bc2"])
        s["m"].copy_(torch.where(found, s["m"], m))
        s["v"].copy_(torch.where(found, s["v"], v))
        trs.append(trd)
    return trs


def lamb_apply_plain(targets, trs, ratios, lows, svec) -> None:
    """Plain version of the ``lamb_apply`` pass, in place."""
    sv = dict(zip(SLOTS, svec.unbind()))
    for p, trd, r, low in zip(targets, trs, ratios, lows):
        _write_back(p, lamb_apply(p, trd, r, sv["lr"]), low, sv["found"] > 0)


def fused_bucket_plain(kind: str, cfg: Dict, targets, grads, states, lows,
                       svec: torch.Tensor) -> None:
    """Plain version of one bucket's launches, in place: per parameter the
    conditioned grad, :func:`rule` (for Lamb: :func:`lamb_moments_plain`,
    :func:`lamb_trust_ratios`, :func:`lamb_apply_plain`), the sentinel
    select and the low-precision write-back. ``targets[k]`` is the float32
    master (or the parameter itself), ``states[k]`` its state dict,
    ``lows[k]`` the bf16 parameter to write back, or None."""
    if kind == "lamb":
        trs = lamb_moments_plain(cfg, targets, grads, states, svec)
        lamb_apply_plain(targets, trs, lamb_trust_ratios(targets, trs), lows,
                         svec)
        return
    sv = dict(zip(SLOTS, svec.unbind()))
    found = sv["found"] > 0
    for p, g, s, low in zip(targets, grads, states, lows):
        new_p, new_s = rule(kind, cfg, p, _conditioned(g, p, sv), s,
                            sv["lr"], sv["wd"], sv["inv_bc1"], sv["inv_bc2"])
        for key, val in new_s.items():
            s[key].copy_(torch.where(found, s[key], val))
        _write_back(p, new_p, low, found)


# -- the kernel ---------------------------------------------------------------

def _bind(lib) -> None:
    fn = lib.ptt_fused_optimizer
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                    ctypes.c_void_p] + [ctypes.c_int] * 5
                   + [ctypes.c_float] * 6 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    occ = lib.ptt_fused_optimizer_blocks_per_sm
    occ.argtypes = [ctypes.c_int] * 4
    occ.restype = ctypes.c_int


def split_plan(rows: int, sms: int) -> int:
    """Blocks per chunk-table row: enough for ``BLOCKS_PER_SM`` blocks
    on each of ``sms`` SMs over ``rows`` rows, at most one per
    ``SWEEP`` elements of a full row."""
    want = -(-sms * BLOCKS_PER_SM // max(rows, 1))
    return max(1, min(CHUNK // SWEEP, want))


def blocks_per_sm(name: str, cfg: Dict, cdtype: str, gdtype: str) -> int:
    """Resident blocks an SM holds for the kernel pass ``name`` at these
    dtypes (the CUDA occupancy calculator, on the current device)."""
    lib = _build.load("fused_optimizer", _bind)
    flag = cfg.get("nesterov" if name == "momentum" else "decoupled", False)
    return lib.ptt_fused_optimizer_blocks_per_sm(
        PASSES[name][0], int(bool(flag)), _build.DTYPE_CODES[cdtype],
        _build.DTYPE_CODES[gdtype])


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


def lamb_scratch(targets, bucket: Optional[Bucket] = None):
    """A Lamb bucket's scratch, ``(tr_div views, ratios)``: one flat buffer
    in the compute dtype, viewed per parameter in its shape, each segment
    starting on a ``SCRATCH_ALIGN``-byte boundary, and one float32 trust
    ratio per parameter. Kept on ``bucket`` (made at its first step) when
    given."""
    if bucket is not None and bucket.scratch is not None:
        return bucket.scratch
    step = SCRATCH_ALIGN // targets[0].element_size()
    offsets, total = [], 0
    for t in targets:
        offsets.append(total)
        total += -(-t.numel() // step) * step
    dev = targets[0].device
    flat = torch.empty(total, dtype=targets[0].dtype, device=dev)
    scratch = ([flat[o:o + t.numel()].view(t.shape)
                for o, t in zip(offsets, targets)],
               torch.empty(len(targets), dtype=torch.float32, device=dev))
    if bucket is not None:
        bucket.scratch = scratch
    return scratch


# rows whose pointers are not all aligned to one kernel access (they run
# element by element), counted over every chunk table built
unaligned_rows = 0


def misaligned(rows: np.ndarray, csize: int, gsize: int) -> np.ndarray:
    """Per chunk-table row, whether a tensor address in it (param or
    master, grad, bf16 write-back, states, ``tr_div``) is not aligned to
    ``VEC`` elements of its dtype (``csize`` / ``gsize`` bytes for the
    compute and grad dtypes): the kernel's scalar rows."""
    size = np.array([csize, gsize, 2, csize, csize, csize], np.int64)
    return ((rows[:, :6] % (VEC * size)) != 0).any(axis=1)


def chunk_rows(kind, targets, grads, states, lows, scratch=None
               ) -> np.ndarray:
    """The kernel's chunk table on the host, int64 ``[n, ROW]``: per run of
    at most ``CHUNK`` elements of one parameter, the addresses of its
    param (or master), grad, bf16 write-back (0 if none), two state slots
    (0 if unused), Lamb's ``tr_div`` and the parameter's trust ratio (0
    without ``scratch``), and its element count. Adds the rows that
    :func:`misaligned` finds to ``unaligned_rows``."""
    global unaligned_rows
    keys = STATE_KEYS[kind]
    trs, ratios = scratch if scratch is not None \
        else ([None] * len(targets), None)
    rows = []
    for k, (p, g, s, low, tr) in enumerate(zip(targets, grads, states, lows,
                                               trs)):
        start = np.arange(0, p.numel(), CHUNK, dtype=np.int64)

        def at(t):   # the chunks' addresses in t; a missing tensor is 0
            return np.zeros_like(start) if t is None \
                else t.data_ptr() + start * t.element_size()

        slots = [s[key] for key in keys] + [None] * (2 - len(keys))
        ratio = np.full_like(start, 0 if ratios is None
                             else ratios.data_ptr() + 4 * k)
        rows.append(np.stack([at(p), at(g), at(low), at(slots[0]),
                              at(slots[1]), at(tr), ratio,
                              np.minimum(CHUNK, p.numel() - start)], axis=1))
    if not rows:
        return np.zeros((0, ROW), np.int64)
    rows = np.concatenate(rows)
    unaligned_rows += int(misaligned(rows, targets[0].element_size(),
                                     grads[0].element_size()).sum())
    return rows


def _chunk_table(bucket: Optional[Bucket], kind, targets, grads, states,
                 lows, scratch=None) -> Tuple[torch.Tensor, int]:
    """:func:`chunk_rows` on the device, rebuilt only when a pointer moved
    (grads are new tensors after every ``clear_grad``).

    Never uploaded inside a graph capture: the upload would become a graph
    node copying from a pinned host buffer the caching host allocator
    hands out again, so replays would read a garbage table. While
    ``jit/step_capture.py`` captures a step (:func:`deferred_tables`),
    the launch takes the next of the tables allocated for it before the
    capture (outside the graph's pool, whose memory earlier nodes of the
    graph reuse) and the rows are written after the capture ends; the
    graph owns the table, so no later rebuild of the bucket's own table
    frees what a replay reads. An upload during any other capture
    raises."""
    if capture_active():
        if _deferred is None:
            raise RuntimeError(
                "fused_optimizer: chunk table upload while a graph capture "
                "is active: replays would read a freed host buffer")
        host = chunk_rows(kind, targets, grads, states, lows, scratch)
        return _deferred.take(host, targets[0].device), len(host)
    if _recorded is not None:
        _recorded.append(table_rows(targets))
    extra = [] if scratch is None else scratch[0] + [scratch[1]]
    key = tuple(t.data_ptr() for ts in (targets, grads, lows, extra)
                for t in ts if t is not None) + tuple(
        t.data_ptr() for s in states for t in s.values())
    if bucket is not None and bucket.table is not None \
            and bucket.table[0] == key:
        return bucket.table[1], bucket.table[2]
    host = chunk_rows(kind, targets, grads, states, lows, scratch)
    table = torch.from_numpy(host).pin_memory().to(targets[0].device,
                                                   non_blocking=True)
    if bucket is not None:
        bucket.table = (key, table, len(host))
    return table, len(host)


def table_rows(targets) -> Tuple[int, str]:
    """``(rows, device)`` of the chunk table over ``targets``."""
    return (sum(-(-t.numel() // CHUNK) for t in targets),
            str(targets[0].device))


class _Deferred:
    """The chunk tables of one capture: allocated before it, taken in
    launch order, their rows written after it (:func:`fill_tables`)."""

    def __init__(self, spec):
        self.spare = [torch.empty((n, ROW), dtype=torch.int64, device=dev)
                      for n, dev in spec]
        self.made: List = []

    def take(self, host: np.ndarray, device) -> torch.Tensor:
        k = len(self.made)
        if k >= len(self.spare) or self.spare[k].shape[0] != len(host) \
                or self.spare[k].device != device:
            raise RuntimeError(
                f"fused_optimizer: launch {k} of the capture needs a chunk "
                f"table of {len(host)} rows on {device} that its warm-up "
                f"did not (the step's structure changed)")
        self.made.append((self.spare[k], host))
        return self.spare[k]


# set by jit/step_capture.py: the tables of the capture under way (or, on
# the CPU, of the stand-in's replay of one), and the (rows, device) of
# each table a warm-up's launches used
_deferred: Optional[_Deferred] = None
_recorded: Optional[List] = None


@contextlib.contextmanager
def deferred_tables(spec=()):
    """While a step is captured: each launch takes the next of the
    tables ``spec`` (``(rows, device)`` each, as :func:`recorded_tables`
    lists them) allocates here, before the capture; yields the
    :class:`_Deferred` for :func:`fill_tables`."""
    global _deferred
    prev, _deferred = _deferred, _Deferred(spec)
    try:
        yield _deferred
    finally:
        _deferred = prev


@contextlib.contextmanager
def recorded_tables():
    """While a step's warm-up runs: the ``(rows, device)`` of each chunk
    table its launches use, in order (the capture's ``spec``)."""
    global _recorded
    prev, _recorded = _recorded, []
    try:
        yield _recorded
    finally:
        _recorded = prev


def fill_tables(made: _Deferred) -> List[torch.Tensor]:
    """Write each taken table's rows (after its capture ended: a plain
    copy, no graph node); returns the tables, which the graph's owner
    keeps alive."""
    for table, host in made.made:
        table.copy_(torch.from_numpy(host))
    return [table for table, _ in made.made]


def capture_active() -> bool:
    """True while a step is being captured: the port's own capture, or
    any CUDA stream capture on this thread."""
    if _deferred is not None:
        return True
    return torch.cuda.is_available() and \
        torch.cuda.is_current_stream_capturing()


def launch_pass(name: str, kind: str, cfg: Dict, targets, grads, states,
                lows, svec: torch.Tensor, bucket: Optional[Bucket] = None,
                scratch=None) -> None:
    """One launch of the kernel pass ``name`` (a key of ``PASSES``) of the
    rule ``kind`` over the bucket, in place, counted on the pass's
    counter. Lamb's passes take :func:`lamb_scratch`'s ``scratch``. The
    tensors are as :func:`fused_bucket_kernel` checks them."""
    table, nchunks = _chunk_table(bucket, kind, targets, grads, states, lows,
                                  scratch)
    if nchunks == 0:
        return
    code, counter = PASSES[name]
    lib = _build.load("fused_optimizer", _bind)
    dev = targets[0].device
    f = lambda key: float(cfg.get(key, 0.0))  # noqa: E731
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.ptt_fused_optimizer(
            table.data_ptr(), nchunks,
            split_plan(nchunks, _build.sm_count(dev)), svec.data_ptr(), code,
            _build.DTYPE_CODES[_dtype_name(targets[0])],
            _build.DTYPE_CODES[_dtype_name(grads[0])],
            int(bool(cfg.get("decoupled", False))),
            int(bool(cfg.get("nesterov", False))),
            f("b1"), 1.0 - f("b1"), f("b2"), 1.0 - f("b2"), f("eps"),
            f("momentum"), stream)
    if rc != 0:
        raise RuntimeError(f"fused_optimizer kernel ({name}) launch failed: "
                           f"cudaError {rc}")
    counter.add()


def fused_bucket_kernel(kind: str, cfg: Dict, targets, grads, states, lows,
                        svec: torch.Tensor, bucket: Optional[Bucket] = None
                        ) -> None:
    """The rule's kernel launches over the bucket, in place: one, or for
    Lamb two with the trust ratios reduced between them; same result as
    :func:`fused_bucket_plain`. ``bucket`` caches the chunk table and
    Lamb's scratch."""
    _check(kind, targets, grads, states, lows, svec)
    scratch = lamb_scratch(targets, bucket) if kind == "lamb" else None
    for name in KINDS[kind]:
        if name == "lamb_apply":
            lamb_trust_ratios(targets, scratch[0], out=scratch[1])
        launch_pass(name, kind, cfg, targets, grads, states, lows, svec,
                    bucket, scratch)


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
    if plan.kind in ("adam", "lamb"):
        bc1, bc2 = bias_inv(plan.cfg["b1"], plan.cfg["b2"], step)
    else:
        bc1 = bc2 = torch.ones((), dtype=torch.float32, device=step.device)
    for bucket, wd in zip(plan.buckets, wd_list):
        # one persistent vector a bucket: a captured step's graph writes
        # and reads the same one each replay, so it also reads, after any
        # step, as what that step's launches read
        keep = bucket.svec if bucket.svec is not None \
            and bucket.svec.device == step.device else None
        svec = pack_scalars(out=keep, lr=lr, step=step, inv=inv,
                            coeff=coeff, found=found, wd=wd, inv_bc1=bc1,
                            inv_bc2=bc2)
        bucket.svec = svec
        ids = bucket.ids
        fused_bucket(plan.kind, plan.cfg, [targets[k] for k in ids],
                     [grads[k] for k in ids], [states[k] for k in ids],
                     [lows[k] for k in ids], svec, bucket)
