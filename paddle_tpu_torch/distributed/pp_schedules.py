"""Pipeline F/B schedule tables: FThenB, 1F1B, Eager1F1B, with their
bubble and peak-residency accounting.

Counterpart of ``paddle_tpu/distributed/pp_schedules.py``:
``build_fb_schedule`` (:43), ``schedule_report`` (:127) and
``resolve_schedule_mode`` (:155) are numpy and copied as they are. A
schedule is a table ``[T, S]`` of (phase, microbatch) per tick and stage.
The reference drives one ``lax.scan`` over it inside ``shard_map``
(``pipeline_train_tables``, :165); the port's stages are processes, and
the table orders each rank's forwards and backwards in the multi-process
runtime of ``distributed/pipeline.py`` (``run_schedule``).
"""

from __future__ import annotations

import numpy as np

IDLE, FWD, BWD = 0, 1, 2
SCHEDULES = ("FThenB", "1F1B", "Eager1F1B")


def build_fb_schedule(S: int, M: int, kind: str = "1F1B"):
    """Greedy event simulation of the classic schedules.

    Dependencies: F(m) on stage d needs F(m) on d-1 finished (d>0);
    B(m) on stage d needs F(m) locally + B(m) on d+1 finished (d<S-1).
    Policies (reference pipeline_scheduler_pass.py semantics):
      FThenB     — a stage never starts B before all its F are issued.
      1F1B       — warmup S-d forwards, then strictly alternate 1F/1B;
                   peak in-flight activations = min(M, S-d).
      Eager1F1B  — warmup runs one extra forward deep (recv-ahead overlap,
                   pipeline_parallel.py _forward_backward_pipeline eager
                   mode), then alternates.

    Returns dict: phase [T, S] (0/1/2), mb [T, S] (-1 or microbatch),
    T, peak_live [S] (max residual slots alive per stage), bubble
    (idle fraction over T*S*2-unit F+B work: 1 - 2M/ (T*S) since every
    stage must run M F's and M B's).
    """
    if kind not in SCHEDULES:
        raise ValueError(f"unknown schedule '{kind}' (have {SCHEDULES})")
    f_done = np.full((M, S), -1, np.int64)    # finish tick of F(m, d)
    b_done = np.full((M, S), -1, np.int64)
    nf = [0] * S                               # forwards issued per stage
    nb = [0] * S
    phase_rows, mb_rows = [], []
    t = 0
    while min(nb) < M:
        prow, mrow = [], []
        for d in range(S):
            # candidate F: next unissued microbatch whose upstream is done
            can_f = (nf[d] < M
                     and (d == 0 or f_done[nf[d], d - 1] >= 0
                          and f_done[nf[d], d - 1] < t))
            can_b = (nb[d] < M and nb[d] < nf[d]
                     and (d == S - 1 or (b_done[nb[d], d + 1] >= 0
                                         and b_done[nb[d], d + 1] < t)))
            if kind == "FThenB":
                run_f = can_f
            elif kind == "1F1B":
                warm = min(M, S - d)
                run_f = can_f and (nf[d] < warm
                                   or (nf[d] - nb[d] < warm and not can_b))
            else:  # Eager1F1B: one deeper warmup
                warm = min(M, S - d + 1)
                run_f = can_f and (nf[d] < warm
                                   or (nf[d] - nb[d] < warm and not can_b))
            if run_f:
                prow.append(FWD)
                mrow.append(nf[d])
                f_done[nf[d], d] = t
                nf[d] += 1
            elif can_b:
                prow.append(BWD)
                mrow.append(nb[d])
                b_done[nb[d], d] = t
                nb[d] += 1
            else:
                prow.append(IDLE)
                mrow.append(-1)
        phase_rows.append(prow)
        mb_rows.append(mrow)
        t += 1
        if t > 8 * (M + S) * 2:
            raise RuntimeError(f"{kind} schedule did not converge")
    phase = np.asarray(phase_rows, np.int32)
    mb = np.asarray(mb_rows, np.int32)
    T = t

    # residual-slot residency: F(m,d) allocates at its tick, B(m,d) frees
    peak_live = []
    for d in range(S):
        live = peak = 0
        for tt in range(T):
            if phase[tt, d] == FWD:
                live += 1
                peak = max(peak, live)
            elif phase[tt, d] == BWD:
                live -= 1
        peak_live.append(peak)
    bubble = 1.0 - (2.0 * M * S) / (T * S)
    return {"phase": phase, "mb": mb, "T": T,
            "peak_live": peak_live, "bubble": bubble, "kind": kind}


def schedule_report(S: int, M: int):
    """Bubble fraction + peak activation residency for every schedule
    (the numbers VERDICT r3 Next#9 asks to record)."""
    out = {}
    for kind in SCHEDULES:
        s = build_fb_schedule(S, M, kind)
        out[kind] = {"T": s["T"], "bubble": round(s["bubble"], 4),
                     "peak_live": s["peak_live"]}
    return out


def resolve_schedule_mode(default: str = "1F1B") -> str:
    """Read the fleet strategy's pipeline_configs['schedule_mode'] (the
    reference pipeline_scheduler knob); empty/unset -> `default`."""
    from . import fleet as fleet_mod
    strategy = fleet_mod.get_strategy()
    if strategy is None:
        return default
    return strategy.pipeline_configs.get("schedule_mode") or default
