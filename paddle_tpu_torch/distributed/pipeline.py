"""The pipeline: schedules and the multi-process runtime that runs them.

Counterpart of ``paddle_tpu/distributed/pipeline.py``. The reference is
one program over the mesh: a ``lax.scan`` over ticks inside ``shard_map``,
activations moved by ``lax.ppermute``, the backward by JAX AD
(``pipelined_stack_forward`` :363, ``pp_schedules.pipeline_train_tables``).
The port is one process per stage, as upstream Paddle's runtime is.

- ``build_vpp_schedule`` (:184; its greedy part as :func:`vpp_apps`),
  ``vpp_bubble_fraction`` (:269) and ``microbatch`` / ``unmicrobatch``
  (:420-429) are the reference's;
- :func:`schedule_ops` turns a schedule into each stage's ordered list of
  forwards and backwards of ``(microbatch, chunk)``: for one chunk a stage
  (``v = 1``) the FThenB / 1F1B / Eager1F1B table of
  ``pp_schedules.build_fb_schedule``; for ``v > 1`` chunks (interleaved
  VPP, chunk ``k`` on stage ``k % S``) the forwards in
  ``build_vpp_schedule``'s order and the backwards in its mirror order;
- :func:`run_schedule` runs this rank's list. A forward takes the
  microbatch (the first chunk) or the activation its previous chunk's
  stage sent, runs the stage's chunk and sends the output on (the last
  chunk applies the loss, divided by the microbatch count); a backward is
  ``torch.autograd.backward(stage_out, received_grad)`` (the loss itself
  on the last chunk) and sends the input's grad back. Sends are
  asynchronous and waited for at the step's end; a receive blocks. Every
  op of a table depends only on ops of earlier ticks, so with sends that
  never block no rank waits on a rank that waits on it. Messages arrive in
  each sender's order: one that comes before it is needed is parked.

Each activation goes with a small header (its dtype and shape), so a
stage needs no shape ahead of time. The time a rank spends blocked in
receives is kept (``stats["recv_wait_s"]``), the measured idle time
beside the schedule's bubble.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import collective as C
from .pp_schedules import BWD, FWD, build_fb_schedule

_DTYPES = (torch.float32, torch.bfloat16, torch.float16, torch.float64,
           torch.int64, torch.int32)
_HEADER = 8                  # dtype code, ndim, up to 6 dims

def vpp_apps(S: int, M: int, v: int):
    """The greedy interleaved schedule's applications: ``apps[t][d]`` is
    ``(microbatch, chunk)`` or None (each tick each device runs the
    deepest ready chunk-application of its own chunks)."""
    K = S * v
    nxt = [0] * M
    avail = [0] * M
    done = [False] * M
    apps = []          # apps[t][d] = (m, k) | None
    t = 0
    while not all(done):
        row = []
        for d in range(S):
            cands = [m for m in range(M)
                     if not done[m] and nxt[m] % S == d and avail[m] <= t]
            if cands:
                m = max(cands, key=lambda mm: nxt[mm])
                k = nxt[m]
                row.append((m, k))
                nxt[m] += 1
                avail[m] = t + 1
                if nxt[m] >= K:
                    done[m] = True
            else:
                row.append(None)
        apps.append(row)
        t += 1
        if t > 4 * (M * v + S):   # safety: schedule must terminate
            raise RuntimeError("VPP schedule did not converge")
    return apps


def build_vpp_schedule(S: int, M: int, v: int):
    """Greedy interleaved schedule. Returns dict of numpy tables
    [T, S]: recv_slot, src_slot, inject_mb, chunk_sel, out_mb; plus
    T (ticks), B (buffer slots per device), and per-device busy counts."""
    K = S * v
    apps = vpp_apps(S, M, v)
    T = len(apps)

    recv_slot = np.full((T, S), -1, np.int32)
    src_slot = np.full((T, S), -1, np.int32)
    inject_mb = np.full((T, S), -1, np.int32)
    chunk_sel = np.zeros((T, S), np.int32)
    out_mb = np.full((T, S), -1, np.int32)

    # processing tick of each app, for slot lifetime tracking
    proc_tick = {}
    for tt, row in enumerate(apps):
        for d, app in enumerate(row):
            if app is not None:
                proc_tick[app] = tt

    B = 0
    for d in range(S):
        free: list = []
        released: dict = {}
        slot_of = {}
        used = 0
        for tt in range(T):
            free.extend(released.pop(tt, ()))
            # ring arrival: device d-1 processed (m, k) at tt-1 and k+1
            # lives on this device (always true: chunks advance round-robin)
            if tt > 0:
                prev = apps[tt - 1][(d - 1) % S]
                if prev is not None and prev[1] + 1 < K:
                    m, k = prev[0], prev[1] + 1
                    if free:
                        slot = free.pop()
                    else:
                        slot = used
                        used += 1
                    slot_of[(m, k)] = slot
                    recv_slot[tt, d] = slot
            app = apps[tt][d]
            if app is not None:
                m, k = app
                chunk_sel[tt, d] = k // S
                if k == 0:
                    inject_mb[tt, d] = m
                else:
                    slot = slot_of.pop((m, k))
                    src_slot[tt, d] = slot
                    released.setdefault(tt + 1, []).append(slot)
                if k == K - 1:
                    out_mb[tt, d] = m
        B = max(B, used)
    busy = [sum(1 for row in apps if row[d] is not None) for d in range(S)]
    return {"recv_slot": recv_slot, "src_slot": src_slot,
            "inject_mb": inject_mb, "chunk_sel": chunk_sel,
            "out_mb": out_mb, "T": T, "B": max(B, 1), "busy": busy}


def vpp_bubble_fraction(S: int, M: int, v: int) -> float:
    """Idle fraction of the schedule in stage-time units (chunk tick =
    1/v stage tick). v=1 reproduces the 1F1B rotation bubble
    (S-1)/(M+S-1)."""
    sched = build_vpp_schedule(S, M, v)
    total = sched["T"] * S
    work = sum(sched["busy"])
    return 1.0 - work / total


def vpp_bubble_fraction(S: int, M: int, v: int) -> float:
    """Idle fraction of the schedule in stage-time units (chunk tick =
    1/v stage tick). v=1 reproduces the 1F1B rotation bubble
    (S-1)/(M+S-1)."""
    sched = build_vpp_schedule(S, M, v)
    total = sched["T"] * S
    work = sum(sched["busy"])
    return 1.0 - work / total


def microbatch(x: torch.Tensor, num_micro: int) -> torch.Tensor:
    """[B, ...] -> [M, B/M, ...]."""
    B = x.shape[0]
    if B % num_micro:
        raise ValueError(f"batch {B} not divisible by {num_micro} "
                         f"microbatches")
    return x.reshape((num_micro, B // num_micro) + tuple(x.shape[1:]))


def unmicrobatch(x: torch.Tensor) -> torch.Tensor:
    """[M, mb, ...] -> [M*mb, ...]."""
    return x.reshape((x.shape[0] * x.shape[1],) + tuple(x.shape[2:]))


# -- each stage's ops ---------------------------------------------------------

Op = Tuple[int, str, int, int]          # (tick, "F" | "B", microbatch, chunk)


def schedule_ops(S: int, M: int, v: int = 1, kind: str = "1F1B",
                 train: bool = True) -> List[List[Op]]:
    """Each stage's ops in the order it runs them. ``train=False`` keeps
    the forwards only."""
    ops: List[List[Op]] = [[] for _ in range(S)]
    if v == 1:
        sched = build_fb_schedule(S, M, kind)
        for t in range(sched["T"]):
            for d in range(S):
                ph, m = int(sched["phase"][t, d]), int(sched["mb"][t, d])
                if ph == FWD:
                    ops[d].append((t, "F", m, d))
                elif ph == BWD and train:
                    ops[d].append((t, "B", m, d))
        if not train:          # forwards only: as soon as they can run
            ops = [[(m + d, "F", m, d) for m in range(M)] for d in range(S)]
        return ops
    apps = vpp_apps(S, M, v)
    T = len(apps)
    for t, row in enumerate(apps):
        for d, app in enumerate(row):
            if app is not None:
                ops[d].append((t, "F", app[0], app[1]))
    if train:
        for t in range(T - 1, -1, -1):
            for d, app in enumerate(apps[t]):
                if app is not None:
                    ops[d].append((2 * T - 1 - t, "B", app[0], app[1]))
    return ops


def _incoming(ops: List[List[Op]], me: int, S: int, K: int
              ) -> Dict[int, List[Tuple[str, int, int]]]:
    """For each other stage, the messages it sends this stage, in its
    order: ``("act", m, k)`` for chunk k's input, ``("grad", m, k)`` for
    chunk k's output grad."""
    seqs: Dict[int, List[Tuple[str, int, int]]] = {}
    for p in range(S):
        if p == me:
            continue
        seq = []
        for _, kind, m, k in ops[p]:
            if kind == "F" and k < K - 1 and (k + 1) % S == me:
                seq.append(("act", m, k + 1))
            elif kind == "B" and k > 0 and (k - 1) % S == me:
                seq.append(("grad", m, k - 1))
        seqs[p] = seq
    return seqs


class _Channel:
    """Sends and receives of this stage over the pp group."""

    def __init__(self, group: C.Group, ops, me: int, S: int, K: int):
        self.group, self.me, self.S = group, me, S
        self.expect = _incoming(ops, me, S, K)
        self.pos = {p: 0 for p in self.expect}
        self.parked: Dict[Tuple[str, int, int], torch.Tensor] = {}
        self.pending = []
        self.wait_s = 0.0

    def _rank(self, stage: int) -> int:
        return self.group.ranks[stage]

    def send(self, key, tensor: torch.Tensor, stage: int) -> None:
        if stage == self.me:
            self.parked[key] = tensor
            return
        t = tensor.detach().contiguous()
        if t.dtype not in _DTYPES or t.dim() > _HEADER - 2:
            raise ValueError(f"pipeline: cannot send a {t.dtype} tensor of "
                             f"{t.dim()} dims")
        head = [_DTYPES.index(t.dtype), t.dim()] + list(t.shape)
        head += [0] * (_HEADER - len(head))
        hdr = torch.tensor(head, dtype=torch.int64, device=t.device)
        dst = self._rank(stage)
        self.pending += [C.isend(hdr, dst, self.group),
                         C.isend(t, dst, self.group)]

    def recv(self, key, stage: int, device) -> torch.Tensor:
        t0 = time.perf_counter()
        while key not in self.parked:
            seq, i = self.expect[stage], self.pos[stage]
            if i >= len(seq):
                raise RuntimeError(f"pipeline: stage {self.me} waits for "
                                   f"{key} that stage {stage} never sends")
            src = self._rank(stage)
            hdr = torch.empty(_HEADER, dtype=torch.int64, device=device)
            C.recv(hdr, src, self.group)
            code, nd, *dims = hdr.tolist()
            buf = torch.empty(dims[:nd], dtype=_DTYPES[code], device=device)
            C.recv(buf, src, self.group)
            self.parked[seq[i]] = buf
            self.pos[stage] = i + 1
        self.wait_s += time.perf_counter() - t0
        return self.parked.pop(key)

    def finish(self) -> None:
        for w in self.pending:
            w.wait()
        self.pending = []


def run_schedule(stage_fn: Callable[[torch.Tensor, int], torch.Tensor],
                 loss_fn: Optional[Callable], inputs: Sequence,
                 labels: Optional[Sequence], ops: List[List[Op]], me: int,
                 S: int, v: int, group: Optional[C.Group],
                 train: bool = True, device=None) -> dict:
    """Run stage ``me``'s ops (``schedule_ops``). ``stage_fn(x, j)`` runs
    this stage's local chunk ``j`` (global chunk ``j * S + me``);
    ``inputs[m]`` / ``labels[m]`` are microbatch m's. Returns
    ``{"loss": the mean of the microbatch losses or None off the last
    chunk's stage, "outputs": the last chunk's outputs (eval),
    "recv_wait_s", "busy_s"}``."""
    K = S * v
    M = len(inputs)
    chan = _Channel(group, ops, me, S, K)
    saved: Dict[Tuple[int, int], tuple] = {}
    losses: List[torch.Tensor] = []
    outputs: Dict[int, torch.Tensor] = {}
    t_start = time.perf_counter()
    for _, kind, m, k in ops[me]:
        if kind == "F":
            if k == 0:
                x = inputs[m]
            else:
                x = chan.recv(("act", m, k), (k - 1) % S, device)
                if train and x.is_floating_point():
                    x.requires_grad_(True)
            with torch.set_grad_enabled(train):
                y = stage_fn(x, k // S)
                if k == K - 1:
                    if loss_fn is not None and labels is not None:
                        loss = loss_fn(y, labels[m])
                        losses.append(loss.detach())
                        if train:
                            saved[(m, k)] = (x, loss / M)
                    if not train:
                        outputs[m] = y.detach()
                else:
                    chan.send(("act", m, k + 1), y, (k + 1) % S)
                    if train:
                        saved[(m, k)] = (x, y)
        else:
            x, y = saved.pop((m, k))
            if k == K - 1:
                torch.autograd.backward(y)
            else:
                g = chan.recv(("grad", m, k), (k + 1) % S, device)
                torch.autograd.backward(y, g)
            if k > 0:
                chan.send(("grad", m, k - 1), x.grad, (k - 1) % S)
            del x, y
    chan.finish()
    busy = time.perf_counter() - t_start
    loss = torch.stack(losses).float().mean() if losses else None
    return {"loss": loss, "outputs": outputs, "recv_wait_s": chan.wait_s,
            "busy_s": busy}
