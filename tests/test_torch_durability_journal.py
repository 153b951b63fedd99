"""The commit protocol (``utils/durability.py``) and the request journal
(``serving/resilience/journal.py``) of the port against the JAX package's.

The same calls go through both packages, each in a directory of its own:
the files on disk (names up to the per-incarnation uid, and bytes) and
what loads back are equal. A torn segment (a writer killed mid-fsync)
never loads in either, the integrity errors are raised alike, and a
journal or a committed generation written by one package loads in the
other to an equal state.
"""

import json
import os
import re

import pytest

from paddle_tpu.serving.resilience import journal as rjournal
from paddle_tpu.utils import durability as rdur
from paddle_tpu_torch.serving.resilience import journal as tjournal
from paddle_tpu_torch.utils import durability as tdur

PKGS = {"reference": (rdur, rjournal), "port": (tdur, tjournal)}
UID = re.compile(r"-[0-9a-f]{8}(\.jsonl)$")


def _files(root):
    """Every file under ``root``: its name with the writer's uid cut,
    and its bytes."""
    out = {}
    for dirpath, _, names in os.walk(root):
        for n in names:
            path = os.path.join(dirpath, n)
            rel = UID.sub(r"\1", os.path.relpath(path, root))
            with open(path, "rb") as f:
                out[rel] = f.read()
    return out


def _state(st):
    """A JournalState as plain data."""
    return dict(config=st.config, segments=st.segments,
                requests={rid: (r.prompt, r.max_new_tokens, r.tokens,
                                r.finished)
                          for rid, r in sorted(st.requests.items())})


def _both(tmp_path, fn):
    """``fn(durability, journal, root)`` in each package; the results and
    the files each left."""
    out = {}
    for name, (dur, jr) in PKGS.items():
        root = str(tmp_path / name)
        os.makedirs(root, exist_ok=True)
        out[name] = fn(dur, jr, root), _files(root)
    return out


# -- the commit protocol ---------------------------------------------------------

def _generations(dur, jr, root):
    for step, name in ((3, "gen-a"), (7, "gen-b"), (5, "gen-c")):
        os.makedirs(os.path.join(root, name))
        dur.fsync_write(os.path.join(root, name, "data.bin"),
                        lambda f, s=step: f.write(bytes([s]) * 16))
        dur.write_committed_marker(os.path.join(root, name), step=step,
                                   blocks=step * 2)
    os.makedirs(os.path.join(root, "gen-z"))      # uncommitted debris
    dur.fsync_write(os.path.join(root, "gen-z", "data.bin"),
                    lambda f: f.write(b"torn"))
    with open(os.path.join(root, "gen-z", "data.bin.tmp-dead0000"),
              "wb") as f:
        f.write(b"x")
    latest = os.path.basename(dur.latest_committed(root))
    markers = {n: dur.read_committed_marker(os.path.join(root, n))
               for n in sorted(os.listdir(root))}
    return latest, markers


def test_generations_equal_reference(tmp_path):
    res = _both(tmp_path, _generations)
    assert res["port"] == res["reference"]
    latest, markers = res["port"][0]
    assert latest == "gen-b" and markers["gen-z"] is None
    assert markers["gen-b"] == {"step": 7, "blocks": 14}


@pytest.mark.parametrize("writer", sorted(PKGS))
def test_generation_loads_in_the_other_package(tmp_path, writer):
    dur, _ = PKGS[writer]
    _generations(dur, None, str(tmp_path))
    for name, (reader, _) in PKGS.items():
        assert os.path.basename(reader.latest_committed(str(tmp_path))) \
            == "gen-b", name
        assert reader.read_committed_marker(
            str(tmp_path / "gen-a"))["step"] == 3


def test_committed_root_is_its_own_generation(tmp_path):
    def fn(dur, jr, root):
        dur.write_committed_marker(root, step=None, drained=True)
        return dur.latest_committed(root) == root, \
            dur.read_committed_marker(root)
    res = _both(tmp_path, fn)
    assert res["port"] == res["reference"]
    assert res["port"][0] == (True, {"step": None, "drained": True})


def test_failed_write_leaves_no_file(tmp_path):
    def fn(dur, jr, root):
        def boom(f):
            f.write(b"half")
            raise OSError("disk gone")
        with pytest.raises(OSError, match="disk gone"):
            dur.fsync_write(os.path.join(root, "x.bin"), boom)
        return sorted(os.listdir(root))
    res = _both(tmp_path, fn)
    assert res["port"] == res["reference"] == ([], {})


def test_unreadable_markers_read_as_none(tmp_path):
    def fn(dur, jr, root):
        with open(os.path.join(root, dur.COMMIT_FILE), "w") as f:
            f.write("[1, 2]")
        lst = dur.read_committed_marker(root)
        with open(os.path.join(root, dur.COMMIT_FILE), "w") as f:
            f.write("{not json")
        return lst, dur.read_committed_marker(root), \
            dur.latest_committed(root)
    res = _both(tmp_path, fn)
    assert res["port"][0] == res["reference"][0] == (None, None, None)


# -- the journal -----------------------------------------------------------------

def _traffic(dur, jr, root):
    """Appends, flushes, a commit, an uncommit and two compactions."""
    j = jr.RequestJournal(root)
    j.append({"t": "config", "seed": 17, "eos": None, "model_fp": "ab",
              "sampling": {"temperature": 0.9, "top_k": 0, "top_p": 1.0}})
    for rid in range(5):
        j.append({"t": "admit", "rid": rid, "prompt": [1, 2 + rid, 3],
                  "max_new_tokens": 6})
        j.flush()
        j.append({"t": "tokens", "rid": rid, "from": 0, "toks": [4, rid]})
        if rid % 2 == 0:
            j.append({"t": "tokens", "rid": rid, "from": 2, "toks": [9]})
            j.append({"t": "finish", "rid": rid})
        j.flush()
    j.flush()                                  # nothing buffered: no file
    j.commit(drained=True, remaining=2)
    marker = j.committed_marker()
    j.uncommit()
    mid = _state(jr.RequestJournal(root).load())
    dropped = [j.compact(drop_rids={0, 1}), j.compact(drop_rids={2})]
    j.append({"t": "tokens", "rid": 3, "from": 2, "toks": [7, 7]})
    j.flush()
    return marker, mid, dropped, _state(jr.RequestJournal(root).load()), \
        j.pending_records


def test_journal_traffic_equal_reference(tmp_path):
    """The same appends, flushes and compactions give equal records on
    disk and equal states in both packages."""
    res = _both(tmp_path, _traffic)
    (got, gfiles), (want, wfiles) = res["port"], res["reference"]
    assert got == want
    assert gfiles == wfiles
    marker, mid, dropped, end, pending = got
    assert marker == {"step": 10, "drained": True, "remaining": 2}
    assert dropped == [1, 1]        # rid 1 is unfinished: never dropped
    assert sorted(end["requests"]) == [1, 3, 4]
    assert end["requests"][3][2] == [4, 3, 7, 7] and pending == 0
    assert sorted(gfiles) == ["seg-00000010.jsonl", "snap-00000009.jsonl"]


@pytest.mark.parametrize("writer", sorted(PKGS))
def test_journal_loads_in_the_other_package(tmp_path, writer):
    _, jr = PKGS[writer]
    _traffic(None, jr, str(tmp_path))
    states = {name: _state(j.RequestJournal(str(tmp_path)).load())
              for name, (_, j) in PKGS.items()}
    assert states["port"] == states["reference"]
    # and the reader continues the writer's segment numbering
    for name, (_, j) in PKGS.items():
        assert j.RequestJournal(str(tmp_path))._next_seg == 11, name


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_torn_segment_never_loads(tmp_path, pkg):
    """A writer killed mid-fsync leaves a ``.tmp-`` sibling: neither a
    segment nor a snapshot, invisible to the loader and to the
    numbering, in both packages."""
    _, jr = PKGS[pkg]
    j = jr.RequestJournal(str(tmp_path))
    j.append({"t": "admit", "rid": 0, "prompt": [1], "max_new_tokens": 2})
    j.flush()
    (tmp_path / "seg-00000001-deadbeef.jsonl.tmp-0badf00d").write_bytes(
        b'{"t": "finish", "ri')
    (tmp_path / "snap-00000005-deadbeef.jsonl.tmp-0badf00d").write_bytes(
        b'{"t": "adm')
    for name, (_, reader) in PKGS.items():
        st = reader.RequestJournal(str(tmp_path)).load()
        assert st.segments == 1 and not st.requests[0].finished, name
        assert reader.RequestJournal(str(tmp_path))._next_seg == 1, name


INTEGRITY = {
    "gap": ([{"t": "admit", "rid": 3, "prompt": [1], "max_new_tokens": 9},
             {"t": "tokens", "rid": 3, "from": 2, "toks": [8]}],
            "watermark starts at"),
    "diverge": ([{"t": "admit", "rid": 0, "prompt": [1],
                  "max_new_tokens": 8},
                 {"t": "tokens", "rid": 0, "from": 0, "toks": [5, 6]},
                 {"t": "tokens", "rid": 0, "from": 1, "toks": [99]}],
                "diverge"),
    "orphan_tokens": ([{"t": "tokens", "rid": 7, "from": 0, "toks": [1]}],
                      "no admit"),
    "orphan_finish": ([{"t": "finish", "rid": 7}], "no admit"),
    "twice": ([{"t": "admit", "rid": 0, "prompt": [1, 2],
                "max_new_tokens": 4},
               {"t": "admit", "rid": 0, "prompt": [9],
                "max_new_tokens": 4}], "admitted twice"),
    "unknown": ([{"t": "bogus"}], "unknown record type"),
}


@pytest.mark.parametrize("case", sorted(INTEGRITY))
def test_integrity_errors_equal_reference(tmp_path, case):
    recs, match = INTEGRITY[case]
    msgs = {}
    for name, (_, jr) in PKGS.items():
        j = jr.RequestJournal(str(tmp_path / name))
        for r in recs:
            j.append(r)
        j.flush()
        with pytest.raises(ValueError, match=match) as e:
            j.load()
        msgs[name] = str(e.value)
    assert msgs["port"] == msgs["reference"]


def test_zombie_writer_overlap_merges_alike(tmp_path):
    """A relaunch over a still-alive writer: both land (uid-fenced
    names), and the overlapping watermarks merge on load."""
    def fn(dur, jr, root):
        j1 = jr.RequestJournal(root)
        j1.append({"t": "admit", "rid": 0, "prompt": [1],
                   "max_new_tokens": 8})
        j1.append({"t": "tokens", "rid": 0, "from": 0, "toks": [5, 6]})
        j1.flush()
        j2 = jr.RequestJournal(root)
        j2.append({"t": "tokens", "rid": 0, "from": 2, "toks": [7, 8]})
        j2.flush()
        j1.append({"t": "tokens", "rid": 0, "from": 2, "toks": [7, 8, 9]})
        j1.flush()
        return _state(jr.RequestJournal(root).load())
    res = _both(tmp_path, fn)
    assert res["port"][0] == res["reference"][0]
    assert res["port"][0]["segments"] == 3
    assert res["port"][0]["requests"][0][2] == [5, 6, 7, 8, 9]


def test_segment_records_are_the_reference_grammar(tmp_path):
    j = tjournal.RequestJournal(str(tmp_path))
    j.append({"t": "admit", "rid": 2, "prompt": [3], "max_new_tokens": 1})
    j.flush()
    (name,) = os.listdir(str(tmp_path))
    assert re.fullmatch(r"seg-00000000-[0-9a-f]{8}\.jsonl", name)
    line = (tmp_path / name).read_text()
    assert line == json.dumps({"t": "admit", "rid": 2, "prompt": [3],
                               "max_new_tokens": 1},
                              separators=(",", ":")) + "\n"
