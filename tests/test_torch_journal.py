"""The port's request journal (``serving/journal.py``) against the
reference's: frames byte-equal for the same records, each package
replaying the other's file to equal records, the same torn-tail
truncation, the same crc boundary, the ``journal_truncate`` seam, the
fsync-batching counters and the ``pending`` fold."""
import os
import struct

import pytest

from repro.serving.faults import FaultPlan as JaxFaultPlan
from repro.serving.journal import RequestJournal as JaxJournal
from repro.serving.journal import _encode as jax_encode
from repro_torch.serving.faults import FaultPlan
from repro_torch.serving.journal import TERMINAL, TYPES, RequestJournal
from repro_torch.serving.journal import _encode

RECORDS = [
    {"type": "submit", "uid": 0, "prompt": [5, 1, 9, 511], "new_tokens": 8,
     "priority": 5, "deadline": None, "noise_seed": None, "rank": 0},
    {"type": "submit", "uid": 1, "prompt": [3], "new_tokens": 2,
     "priority": 0, "deadline": 12.625, "noise_seed": 77, "rank": 1},
    {"type": "admit", "uid": 0},
    {"type": "park", "uid": 0},
    {"type": "retry", "uid": 1, "noise_seed": 1442695040, "retries": 1},
    {"type": "admit", "uid": 1},
    {"type": "finish", "uid": 1, "tokens": [3, 17, 4]},
    {"type": "fail", "uid": 0, "code": "timeout"},
    {"type": "cancel", "uid": 2, "code": "cancelled"},
]


def _write(cls, path, records, **kw):
    j = cls(path, **kw)
    for r in records:
        j.append(r["type"], **{k: v for k, v in r.items() if k != "type"})
    j.close()
    return j


def test_record_types_match_the_reference():
    from repro.serving.journal import TERMINAL as JT, TYPES as JTY
    assert TYPES == JTY and TERMINAL == JT


@pytest.mark.parametrize("rec", RECORDS, ids=[
    f"{r['type']}{i}" for i, r in enumerate(RECORDS)])
def test_frames_byte_equal_the_reference(rec):
    """Submit with a None and a float deadline, park, retry, admit,
    finish with tokens, fail, cancel: the same bytes."""
    assert _encode(rec) == jax_encode(rec)


@pytest.mark.parametrize("writer,reader", [
    ("port", "reference"), ("reference", "port")])
def test_each_package_replays_the_others_file(tmp_path, writer, reader):
    p = str(tmp_path / "journal.wal")
    _write(RequestJournal if writer == "port" else JaxJournal, p, RECORDS)
    replay = (RequestJournal if reader == "port" else JaxJournal).replay
    assert replay(p) == RECORDS
    with open(p, "rb") as f:
        assert f.read() == b"".join(jax_encode(r) for r in RECORDS)


def test_torn_tail_truncated_at_the_references_offset(tmp_path):
    """Half a frame header past the last good record: both replays stop
    at the same record and truncate to the same size, and the file takes
    appends again."""
    sizes = []
    for cls, name in ((RequestJournal, "port"), (JaxJournal, "ref")):
        p = str(tmp_path / f"{name}.wal")
        _write(cls, p, RECORDS[:3])
        good = os.path.getsize(p)
        with open(p, "ab") as f:
            f.write(struct.pack("<II", 1 << 20, 0xDEAD)[:6])
        assert cls.replay(p) == RECORDS[:3]
        assert os.path.getsize(p) == good
        sizes.append(good)
        j = cls(p)
        j.append("finish", uid=0)
        j.close()
        assert cls.replay(p)[-1] == {"type": "finish", "uid": 0}
    assert sizes[0] == sizes[1]


@pytest.mark.parametrize("target", [0, 2, 5])
def test_crc_corruption_stops_both_replays_at_one_boundary(tmp_path, target):
    p = str(tmp_path / "journal.wal")
    _write(RequestJournal, p, RECORDS)
    with open(p, "rb") as f:
        buf = bytearray(f.read())
    off = 0
    for _ in range(target):
        (plen,) = struct.unpack_from("<I", buf, off)
        off += 8 + plen
    buf[off + 8] ^= 0xFF
    q = str(tmp_path / "copy.wal")
    for path in (p, q):
        with open(path, "wb") as f:
            f.write(buf)
    mine, ref = RequestJournal.replay(p), JaxJournal.replay(q)
    assert mine == ref == RECORDS[:target]
    assert os.path.getsize(p) == os.path.getsize(q) == off


def test_journal_truncate_seam_drops_the_last_record(tmp_path):
    p, q = str(tmp_path / "p.wal"), str(tmp_path / "q.wal")
    _write(RequestJournal, p, RECORDS[:3])
    _write(JaxJournal, q, RECORDS[:3])
    plan, jplan = (FaultPlan.parse("journal_truncate=@0"),
                   JaxFaultPlan.parse("journal_truncate=@0"))
    assert RequestJournal.replay(p, faults=plan) == JaxJournal.replay(
        q, faults=jplan) == RECORDS[:2]
    assert plan.fired == jplan.fired == {"journal_truncate": 1}
    # the tear persisted: a replay without faults sees the shorter file
    assert RequestJournal.replay(p) == RECORDS[:2]
    assert os.path.getsize(p) == os.path.getsize(q)


def test_fsync_batching_counters_match(tmp_path):
    for every in (1, 3):
        recs = [dict(RECORDS[0], uid=i, rank=i) for i in range(7)]
        mine = RequestJournal(str(tmp_path / f"p{every}.wal"),
                              fsync_every=every)
        ref = JaxJournal(str(tmp_path / f"q{every}.wal"), fsync_every=every)
        for r in recs:
            for j in (mine, ref):
                j.append(r["type"], **{k: v for k, v in r.items()
                                       if k != "type"})
            assert mine.stats_export() == ref.stats_export()
        assert mine.syncs == (7 if every == 1 else 2)
        mine.sync()
        ref.sync()
        assert mine.stats_export() == ref.stats_export()
        assert mine.stats_export()["journal_unsynced"] == 0
        mine.close()
        ref.close()
    with pytest.raises(ValueError):
        RequestJournal(str(tmp_path / "x.wal"), fsync_every=0)
    with pytest.raises(ValueError):
        mine.append("bogus", uid=1)


def test_missing_file_replays_empty(tmp_path):
    assert RequestJournal.replay(str(tmp_path / "none.wal")) == []


SCRIPTED = [
    {"type": "submit", "uid": 1, "noise_seed": None, "retries": 0},
    {"type": "submit", "uid": 2, "noise_seed": None},
    {"type": "submit", "uid": 3, "noise_seed": None},
    {"type": "submit", "uid": 4, "noise_seed": 5},
    {"type": "submit", "uid": 5},
    {"type": "admit", "uid": 1},
    {"type": "finish", "uid": 1, "tokens": [4, 2]},
    {"type": "admit", "uid": 2},
    {"type": "park", "uid": 2},
    {"type": "retry", "uid": 3, "noise_seed": 77, "retries": 1},
    {"type": "admit", "uid": 99},
    {"type": "park", "uid": 4},
    {"type": "admit", "uid": 4},
    {"type": "park", "uid": 5},
    {"type": "cancel", "uid": 5, "code": "cancelled"},
    {"type": "fail", "uid": 3, "code": "nonfinite"},
    {"type": "finish", "uid": 1, "tokens": [9]},
]


@pytest.mark.parametrize("n", [4, 9, 13, len(SCRIPTED)])
def test_pending_folds_equal_the_reference(n):
    """Every prefix of a scripted lifecycle (terminal, parked, retried,
    re-admitted, unknown and already-terminal uids) folds to the
    reference's three maps."""
    assert RequestJournal.pending(SCRIPTED[:n]) == JaxJournal.pending(
        SCRIPTED[:n])
    pending, parked, delivered = RequestJournal.pending(SCRIPTED)
    assert set(pending) == {2, 4} and set(parked) == {2}
    assert delivered[1]["tokens"] == [4, 2]
    assert delivered[3]["code"] == "nonfinite"
