"""Torn-write-safe commit protocol: the serving journal, the warm-cache
snapshots and the incident bundles.

Counterpart of ``paddle_tpu/utils/durability.py``, kept as a copy of its
own (the port imports nothing of the JAX package) with the same on-disk
format, so each package reads the other's generations:

* :func:`fsync_write` — every file lands via ``<name>.tmp-<uid>`` +
  flush + fsync + atomic rename (+ directory fsync), so a reader or a
  crash at any point observes either no file or the whole file, never a
  prefix.
* :func:`write_committed_marker` / :func:`read_committed_marker` — a
  generation directory becomes visible only once its ``COMMITTED``
  marker (itself written via :func:`fsync_write`, carrying the
  step/sequence number) exists; a writer killed mid-save leaves an
  invisible directory, not a torn generation.
* :func:`latest_committed` — resolve the newest committed generation
  under a root, skipping uncommitted debris.
"""

from __future__ import annotations

import json
import os
import uuid
from typing import Any, Dict, Optional, Tuple

__all__ = [
    "COMMIT_FILE", "fsync_write", "fsync_dir", "write_committed_marker",
    "read_committed_marker", "latest_committed",
]

COMMIT_FILE = "COMMITTED"


def fsync_write(path: str, write_fn) -> None:
    """Torn-write-safe file creation: write to a ``<name>.tmp-<uid>``
    sibling, flush+fsync, then atomically rename into place. A reader
    (or a crash at any point) sees either no file or the whole file,
    never a prefix."""
    tmp = f"{path}.tmp-{uuid.uuid4().hex[:8]}"
    try:
        with open(tmp, "wb") as f:
            write_fn(f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    fsync_dir(os.path.dirname(path) or ".")


def fsync_dir(path: str) -> None:
    try:  # persist the rename itself (no-op on platforms without dir fds)
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def write_committed_marker(path: str, step: Optional[int] = None,
                           **extra: Any) -> None:
    """Write the generation's ``COMMITTED`` marker (atomic, fsynced).
    Readers resolve only directories whose marker exists, so a writer
    killed mid-save leaves an invisible directory, not a torn
    generation. ``extra`` fields ride in the marker payload."""
    payload = json.dumps({"step": step, **extra}).encode()
    fsync_write(os.path.join(path, COMMIT_FILE), lambda f: f.write(payload))


def read_committed_marker(path: str) -> Optional[Dict[str, Any]]:
    """The parsed ``COMMITTED`` marker, or None when the generation at
    ``path`` was never committed (or is still being written)."""
    try:
        with open(os.path.join(path, COMMIT_FILE), "rb") as f:
            raw = f.read()
    except OSError:
        return None
    try:
        md = json.loads(raw)
    except ValueError:
        return None
    return md if isinstance(md, dict) else None


def latest_committed(root: str) -> Optional[str]:
    """Resolve the newest COMMITTED generation under ``root``.

    Generations are subdirectories carrying a ``COMMITTED`` marker with
    a step number; uncommitted directories (a writer died mid-save, or a
    save is in flight right now) are never returned. ``root`` itself is
    returned when it is a committed single-generation directory."""
    own = read_committed_marker(root)
    if own is not None:
        return root
    best: Optional[Tuple[int, str, str]] = None
    try:
        names = os.listdir(root)
    except OSError:
        return None
    for name in names:
        sub = os.path.join(root, name)
        if not os.path.isdir(sub):
            continue
        md = read_committed_marker(sub)
        if md is None:
            continue
        step = md.get("step")
        step = int(step) if isinstance(step, (int, float)) else -1
        # tie-break on the directory name so equal/unknown steps still
        # resolve deterministically (lexicographically newest wins)
        cand = (step, name, sub)
        if best is None or cand > best:
            best = cand
    return best[2] if best is not None else None
