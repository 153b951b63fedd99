"""Request journal: an append-only write-ahead log of serving work.

Counterpart of ``paddle_tpu/serving/resilience/journal.py``: the same
records, segment and snapshot names (``seg-<n>-<uid>.jsonl``,
``snap-<n>-<uid>.jsonl``), compaction and :class:`JournalState`, so a
journal written by either package loads in the other to an equal state.

The journal is the serving twin of the training checkpoint — except it
never snapshots KV. Because every request samples through its own
schedule-independent sampling stream (keyed on engine seed, rid and
token index), the *tokens* are the only state worth making durable:
a relaunched server re-admits each unfinished journaled request with
its original rid and already-committed output watermark, re-derives the
lost KV by prefill (recompute-on-resume, the engine's preemption path)
and regenerates the remaining tokens **byte-identically**. Finished
outputs load straight from the log.

Durability rides the commit protocol of
:mod:`paddle_tpu_torch.utils.durability`: records buffer in memory and
:meth:`flush` lands them as one immutable *segment* file via
tmp+fsync+atomic-rename. A reader only ever observes whole segments —
a torn journal is unrepresentable on disk (SIGKILL mid-write leaves a
``.tmp-`` orphan the loader ignores). :meth:`commit` additionally
writes the directory's ``COMMITTED`` marker, certifying a clean drain;
recovery works with or without it, the marker records drain hygiene.

Record grammar (one JSON object per line):

* ``{"t": "config", "seed", "sampling", "eos"}`` — engine identity a
  replay must reproduce (written once, first segment).
* ``{"t": "admit", "rid", "prompt", "max_new_tokens"}`` — flushed
  durably at admission: the journal write IS the ack point.
* ``{"t": "tokens", "rid", "from", "toks"}`` — committed output
  watermark; lags generation (losing a tail only means replay
  regenerates more, identically).
* ``{"t": "finish", "rid"}`` — terminal; the accumulated watermark is
  the full output.

Writer fencing: segment names carry a per-incarnation uid
(``seg-<n>-<uid>.jsonl``), so a wedged-then-unwedged previous process
(the step-hang recovery path relaunches OVER a possibly-still-alive
writer) can never atomically replace a segment the new incarnation
already flushed — both land, and because replay regenerates the same
tokens byte-identically, overlapping watermark records from the two
writers are validated equal and merged on load (a disagreement is a
hard integrity error: something other than this engine wrote here).

Compaction (:meth:`RequestJournal.compact`): a long-running server's
WAL would otherwise grow without bound while every record it holds is
for a request already finished AND delivered. Rewrite-on-snapshot
reduces the whole journal into ONE ``snap-<n>-<uid>.jsonl`` file (the
reduction of segments ``<= n``, with retired requests dropped), then
unlinks the superseded segment files. ``load`` applies the newest
snapshot first and only segments numbered ABOVE its coverage after it,
so a crash anywhere inside compaction is safe: before the snapshot
rename nothing changed; after it, leftover old segments are simply
ignored. Snapshot files carry the same per-incarnation uid fencing as
segments.
"""

from __future__ import annotations

import json
import os
import uuid
from typing import Any, Dict, List, Optional

from ...observability import metrics as _metrics
from ...observability import tracing as _tracing
from ...utils.durability import (COMMIT_FILE, fsync_write,
                                 read_committed_marker,
                                 write_committed_marker)

__all__ = ["RequestJournal", "JournalState", "RequestRecord"]

_SEG_PREFIX = "seg-"
_SNAP_PREFIX = "snap-"


def _seg_number(name: str) -> int:
    """Sequence number of ``seg-<n>-<uid>.jsonl`` (or the legacy
    unsuffixed ``seg-<n>.jsonl``)."""
    stem = name[len(_SEG_PREFIX):]
    return int(stem.split("-")[0].split(".")[0])


def _snap_covered(name: str) -> int:
    """Highest segment number a ``snap-<n>-<uid>.jsonl`` reduces."""
    stem = name[len(_SNAP_PREFIX):]
    return int(stem.split("-")[0].split(".")[0])

_M_RECORDS = _metrics.registry().counter(
    "serving.resilience.journal_records",
    help="journal records appended (admissions, watermarks, finishes)")
_M_FLUSHES = _metrics.registry().counter(
    "serving.resilience.journal_flushes",
    help="journal segments committed to disk (fsync + atomic rename)")
_M_COMPACTIONS = _metrics.registry().counter(
    "serving.resilience.journal_compactions",
    help="rewrite-on-snapshot compactions (segments reduced into one "
         "snapshot file, retired requests dropped)")


class RequestRecord:
    """Reduced per-request journal state."""

    __slots__ = ("rid", "prompt", "max_new_tokens", "tokens", "finished")

    def __init__(self, rid: int, prompt: List[int], max_new_tokens: int):
        self.rid = rid
        self.prompt = prompt
        self.max_new_tokens = max_new_tokens
        self.tokens: List[int] = []
        self.finished = False


class JournalState:
    """The reduction of every readable (= whole, committed) segment."""

    def __init__(self):
        self.config: Optional[Dict[str, Any]] = None
        self.requests: Dict[int, RequestRecord] = {}
        self.segments = 0

    @property
    def unfinished(self) -> List[RequestRecord]:
        return [r for r in self.requests.values() if not r.finished]

    @property
    def finished(self) -> List[RequestRecord]:
        return [r for r in self.requests.values() if r.finished]

    def apply(self, rec: Dict[str, Any]) -> None:
        t = rec.get("t")
        if t == "config":
            self.config = rec
        elif t == "admit":
            rid = int(rec["rid"])
            prompt = [int(x) for x in rec["prompt"]]
            mnt = int(rec["max_new_tokens"])
            have = self.requests.get(rid)
            if have is not None:
                # a VERBATIM duplicate admit (copied/re-applied segment)
                # is idempotent — keep the accumulated tokens, never
                # reset them — but two fenced writers assigning one rid
                # to DIFFERENT requests would silently lose a durably
                # acked prompt, so that is a hard error
                if have.prompt != prompt or have.max_new_tokens != mnt:
                    raise ValueError(
                        f"journal integrity: rid {rid} admitted twice "
                        f"with different payloads — two writers assigned "
                        f"one rid to different requests")
            else:
                self.requests[rid] = RequestRecord(rid, prompt, mnt)
        elif t == "tokens":
            req = self.requests.get(int(rec["rid"]))
            if req is None:
                raise ValueError(
                    f"journal integrity: rid {rec['rid']} has watermark "
                    f"records but no admit — segment files are missing "
                    f"(hand-pruned?)")
            start = int(rec["from"])
            toks = [int(x) for x in rec["toks"]]
            if start > len(req.tokens):
                raise ValueError(
                    f"journal integrity: rid {req.rid} watermark starts at "
                    f"{start} but {len(req.tokens)} tokens are accumulated "
                    f"— segments applied out of order or the journal "
                    f"directory was hand-edited")
            # overlap is legal (two incarnations raced a step-hang
            # relaunch) but must AGREE: replay is byte-identical, so a
            # divergence means the journal was corrupted or hand-edited
            overlap = min(len(toks), len(req.tokens) - start)
            if req.tokens[start:start + overlap] != toks[:overlap]:
                raise ValueError(
                    f"journal integrity: rid {req.rid} watermark records "
                    f"diverge at token {start} — concurrent writers must "
                    f"regenerate identically, so this journal is corrupt")
            req.tokens.extend(toks[overlap:])
        elif t == "finish":
            req = self.requests.get(int(rec["rid"]))
            if req is None:
                raise ValueError(
                    f"journal integrity: rid {rec['rid']} has a finish "
                    f"record but no admit — segment files are missing "
                    f"(hand-pruned?)")
            req.finished = True
        else:
            raise ValueError(f"journal integrity: unknown record type {t!r}")


class RequestJournal:
    """Append-only WAL over atomic segment files (see module doc)."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self._buffer: List[Dict[str, Any]] = []
        # fencing uid: this incarnation's segment files can never share
        # a name with (= atomically replace) another writer's
        self._uid = uuid.uuid4().hex[:8]
        self._next_seg = 0
        for name in self._segment_names():
            self._next_seg = max(self._next_seg, _seg_number(name) + 1)
        for name in self._snap_names():
            # a snapshot reduces segments <= n; numbering continues past it
            self._next_seg = max(self._next_seg, _snap_covered(name) + 1)

    # -- write side ----------------------------------------------------------
    def append(self, rec: Dict[str, Any]) -> None:
        """Buffer one record (durable only after :meth:`flush`)."""
        self._buffer.append(rec)
        _M_RECORDS.inc()

    def flush(self) -> None:
        """Land every buffered record as ONE immutable segment file via
        tmp+fsync+rename — all-or-nothing, never a prefix."""
        if not self._buffer:
            return
        with _tracing.span("serving.journal_fsync",
                           attrs={"records": len(self._buffer)}):
            lines = "".join(json.dumps(r, separators=(",", ":")) + "\n"
                            for r in self._buffer)
            payload = lines.encode()
            path = os.path.join(
                self.root,
                f"{_SEG_PREFIX}{self._next_seg:08d}-{self._uid}.jsonl")
            fsync_write(path, lambda f: f.write(payload))
            self._next_seg += 1
            self._buffer.clear()
            _M_FLUSHES.inc()

    def commit(self, **extra: Any) -> None:
        """Flush, then mark the journal cleanly drained (COMMITTED
        marker carrying the segment count). Recovery never requires the
        marker — segments alone are loadable — it certifies that the
        writer exited through the drain path, not a kill."""
        self.flush()
        write_committed_marker(self.root, step=self._next_seg, **extra)

    def uncommit(self) -> None:
        """Retract a stale drain marker: the relaunched server is about
        to append new segments, so 'cleanly drained at segment N' no
        longer describes this directory."""
        try:
            os.unlink(os.path.join(self.root, COMMIT_FILE))
        except OSError:
            pass

    @property
    def pending_records(self) -> int:
        return len(self._buffer)

    # -- compaction ----------------------------------------------------------
    def compact(self, drop_rids=()) -> int:
        """Rewrite-on-snapshot: reduce every readable record into ONE
        ``snap-<covered>-<uid>.jsonl`` file — dropping requests that are
        finished AND in ``drop_rids`` (retired: their output was
        delivered, nothing will ever replay them) — then unlink the
        superseded segment files and older snapshots. Returns the number
        of requests dropped.

        Crash-safe by construction: the snapshot lands via the shared
        commit protocol, and ``load`` ignores segments its coverage
        subsumes, so dying before the rename changes nothing and dying
        mid-unlink merely leaves ignorable files for the next pass."""
        self.flush()
        if self._next_seg == 0:
            return 0
        state = self.load()
        covered = self._next_seg - 1
        recs: List[Dict[str, Any]] = []
        if state.config is not None:
            recs.append(state.config)
        drop = set(int(r) for r in drop_rids)
        dropped = 0
        for rid in sorted(state.requests):
            req = state.requests[rid]
            if req.finished and rid in drop:
                dropped += 1
                continue
            recs.append({"t": "admit", "rid": req.rid,
                         "prompt": req.prompt,
                         "max_new_tokens": req.max_new_tokens})
            if req.tokens:
                recs.append({"t": "tokens", "rid": req.rid, "from": 0,
                             "toks": req.tokens})
            if req.finished:
                recs.append({"t": "finish", "rid": req.rid})
        payload = "".join(json.dumps(r, separators=(",", ":")) + "\n"
                          for r in recs).encode()
        snap = f"{_SNAP_PREFIX}{covered:08d}-{self._uid}.jsonl"
        fsync_write(os.path.join(self.root, snap),
                    lambda f: f.write(payload))
        for name in self._segment_names():
            if _seg_number(name) <= covered:
                try:
                    os.unlink(os.path.join(self.root, name))
                except OSError:
                    pass  # already gone (concurrent compaction); load
                    #       ignores it either way
        for name in self._snap_names():
            # EQUAL coverage included: a re-compaction with no new
            # segments in between (covered unchanged) must retire the
            # previous snapshot, or load()'s (covered, name) tie-break
            # would pick between the two by uid — and the stale one
            # resurrects the requests this pass just dropped
            if name != snap and _snap_covered(name) <= covered:
                try:
                    os.unlink(os.path.join(self.root, name))
                except OSError:
                    pass  # same: superseded snapshots are ignorable
        _M_COMPACTIONS.inc()
        return dropped

    # -- read side -----------------------------------------------------------
    def _segment_names(self) -> List[str]:
        try:
            names = os.listdir(self.root)
        except OSError:
            return []
        # .tmp- orphans (a writer SIGKILLed mid-fsync) are not segments
        return sorted(n for n in names
                      if n.startswith(_SEG_PREFIX) and n.endswith(".jsonl"))

    def _snap_names(self) -> List[str]:
        try:
            names = os.listdir(self.root)
        except OSError:
            return []
        return sorted(n for n in names
                      if n.startswith(_SNAP_PREFIX) and n.endswith(".jsonl"))

    def load(self) -> JournalState:
        """Reduce the newest snapshot (if any) plus every segment above
        its coverage, in order, to per-request state."""
        state = JournalState()
        covered = -1
        snaps = self._snap_names()
        if snaps:
            best = max(snaps, key=lambda n: (_snap_covered(n), n))
            covered = _snap_covered(best)
            with open(os.path.join(self.root, best), encoding="utf-8") as f:
                for line in f:
                    if line.strip():
                        state.apply(json.loads(line))
            state.segments += 1
        for name in self._segment_names():
            if _seg_number(name) <= covered:
                continue   # reduced into the snapshot already
            with open(os.path.join(self.root, name), encoding="utf-8") as f:
                for line in f:
                    if line.strip():
                        state.apply(json.loads(line))
            state.segments += 1
        return state

    def committed_marker(self) -> Optional[Dict[str, Any]]:
        return read_committed_marker(self.root)
