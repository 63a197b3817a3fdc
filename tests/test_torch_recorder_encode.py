"""The flight recorder's memoised JSONL dump (``Recorder.dump_lines``), on
the CPU: the same lines as encoding the ring afresh, through eviction,
``clear()`` and pushes from another thread, with each record encoded once."""
import json
import sys
import threading

import pytest

from repro_torch.obs import recorder as recorder_mod
from repro_torch.obs.recorder import Recorder


def _plain(rec: Recorder):
    return [json.dumps(r) for r in rec.records()]


def _push_round(rec: Recorder, i: int):
    rec.note_elim({"eliminated": [i % 3], "segments": [[i, 1, 2]]})
    rec.round(round_no=i, mode="elim", n_shards=1, ops=[1, 2, 3], keys=[i, i + 1, i + 2],
              vals=[7, 8, 9], results=[0, 1, 0], found=[False, True, False],
              scans={0: [(i, i * 2)]} if i % 2 else None, scan_cap=4 if i % 2 else None)


@pytest.fixture
def counted(monkeypatch):
    """Counts the recorder module's ``json.dumps`` calls."""
    calls = {"n": 0}
    real = recorder_mod.json.dumps

    def dumps(*a, **kw):
        calls["n"] += 1
        return real(*a, **kw)

    monkeypatch.setattr(recorder_mod.json, "dumps", dumps)
    return calls


def _check(rec: Recorder):
    lines, _ = rec.dump_lines()
    assert [x.decode() for x in lines] == [p + "\n" for p in _plain(rec)]
    assert rec.dump_records() == _plain(rec)


def test_successive_dumps_equal_the_plain_encoding():
    rec = Recorder()
    _check(rec)
    for i in range(12):
        _push_round(rec, i)
        if i % 3 == 0:
            rec.commit(i, i + 1, rounds_absorbed=1)
            rec.transition("split", shard=0, split_key=i)
        _check(rec)


@pytest.mark.parametrize("dump_every", [1, 3, 50])
def test_eviction_keeps_the_lines_with_the_ring(dump_every):
    rec = Recorder(capacity=8)
    for i in range(40):
        _push_round(rec, i)
        if i % dump_every == 0:
            _check(rec)
            assert len(rec._lines) == len(rec.records()) <= 8
    _check(rec)
    assert [r["seq"] for r in rec.records()] == list(range(32, 40))


def test_clear_drops_every_kept_line(counted):
    rec = Recorder()
    for i in range(5):
        _push_round(rec, i)
    _check(rec)
    rec.clear()
    assert rec._lines == {} and rec.dump_lines() == ([], 0)
    for i in range(3):
        _push_round(rec, i)
    before = counted["n"]
    lines, encoded = rec.dump_lines()
    assert encoded == 3 and counted["n"] - before == 3
    assert [x.decode() for x in lines] == [p + "\n" for p in _plain(rec)]


def test_faults_pushed_from_another_thread_between_dumps():
    rec = Recorder(capacity=64)
    for i in range(30):
        _push_round(rec, i)
        t = threading.Thread(target=rec.fault, args=("segment_write", "torn"),
                             kwargs={"shard": i % 2})
        t.start()
        t.join()
        if i % 4 == 0:
            _check(rec)
    _check(rec)
    assert sum(r["kind"] == "fault" for r in rec.records()) == 30


def test_each_record_is_encoded_once_across_dumps(counted):
    rec = Recorder(capacity=16)
    pushed = 0
    for i in range(50):
        _push_round(rec, i)
        pushed += 1
        if i % 5 == 0:
            rec.commit(i, i, rounds_absorbed=1)
            pushed += 1
        before = counted["n"]
        lines, encoded = rec.dump_lines()
        new = counted["n"] - before
        assert encoded == new
        # every record pushed since the last dump, and no other
        assert new == (2 if i % 5 == 0 else 1)
        assert len(lines) == min(pushed, 16)
    assert counted["n"] == pushed
    for _ in range(3):  # dumps with nothing new encode nothing
        assert rec.dump_lines()[1] == 0
    assert counted["n"] == pushed


def test_pushing_without_a_dump_encodes_nothing(counted):
    rec = Recorder(capacity=8)
    for i in range(20):
        _push_round(rec, i)
        rec.fault("manifest_write", "eio")
        rec.commit(i, i, rounds_absorbed=1)
        rec.transition("split", shard=0)
    assert counted["n"] == 0 and rec._lines == {}


def test_dumps_racing_pushes_from_many_threads():
    """Eight threads push while the main thread dumps: no dump raises or
    mixes up lines, each thread's records keep their order, and the last
    dump equals the plain encoding of the ring."""
    rec = Recorder(capacity=256)
    n_threads, per = 8, 30000

    def push(tid):
        for i in range(per):
            rec.fault("segment_write", "eio", thread=tid, i=i)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=push, args=(t,)) for t in range(n_threads)]
        for t in threads:
            t.start()
        dumps = 0
        while any(t.is_alive() for t in threads) or dumps == 0:
            lines, _ = rec.dump_lines()
            dumps += 1
            last = {}
            for line in lines:
                r = json.loads(line)
                assert line == (json.dumps(r) + "\n").encode()
                assert r["i"] > last.get(r["thread"], -1)
                last[r["thread"]] = r["i"]
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    _check(rec)
    assert len(rec.records()) == 256
