"""The flight recorder's spans in the round engine, the durable commit's
phase spans and histograms, and the tracer's profiler ranges, clock and
thread tracks, on the CPU."""
import json
import os
import statistics

import numpy as np
import pytest
import torch

from repro_torch.core import durable
from repro_torch.core import (OP_DELETE, OP_FIND, OP_INSERT, OP_RANGE, DurableABTree, FaultPlan,
                              FaultSpec, TreeConfig, recover)
from repro_torch.obs import report, trace_export
from repro_torch.obs.recorder import Recorder
from repro_torch.obs.tracer import THREAD_TRACK0, Tracer

CFG = TreeConfig(capacity=2048, b=8, a=2, max_height=12)
COMMIT_CHILDREN = ["commit.capture", "sidecar.encode", "journal_flush", "sidecar.write",
                   "manifest_commit", "commit.gc"]
HISTS = ("commit_capture_s", "journal_flush_s", "commit_sidecar_s", "manifest_commit_s",
         "journal_gc_s")
# the round engine's phase spans, outside which the recorder's spans lie
PHASES = {"router_pack", "search_combine", "apply", "retry", "rebalance", "scan", "scan.gather",
          "scan.validate", "split_wave", "underfull_wave", "root_shrink"}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rounds(n=4, bsz=96, seed=1):
    """Mixed rounds over 256 keys: updates, finds and a few range lanes."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ops = rng.choice([OP_INSERT, OP_INSERT, OP_DELETE, OP_FIND, OP_RANGE], bsz).astype(np.int32)
        keys = rng.integers(0, 256, bsz).astype(np.int64)
        vals = np.where(ops == OP_RANGE, rng.integers(1, 40, bsz), rng.integers(0, 1000, bsz))
        out.append((ops, keys, vals.astype(np.int64)))
    return out


def _run(directory, tracer=None, recorder=True, **kw):
    t = DurableABTree(str(directory), CFG, device="cpu", **kw)
    if not recorder:
        t.recorder = Recorder(enabled=False)
    if tracer is not None:
        t.tracer = tracer
    outs = [t.apply_round(*r, scan_cap=16) for r in _rounds()]
    t.close()
    return t, outs


def _spy_dumps(monkeypatch):
    """Each sidecar dump's ring, encoded afresh: ``(seqs, plain lines)``."""
    seen = []
    real = Recorder.dump_lines

    def dump_lines(self):
        recs = self.records()
        seen.append(([r["seq"] for r in recs], [json.dumps(r) for r in recs]))
        return real(self)

    monkeypatch.setattr(Recorder, "dump_lines", dump_lines)
    return seen


def _sidecar(directory):
    """The committed sidecar's name and bytes, and the commit's index."""
    with open(os.path.join(directory, "MANIFEST")) as f:
        man = json.load(f)
    with open(os.path.join(directory, man["audit"]), "rb") as f:
        return man["audit"], f.read(), man["commit"]


def _spans(tracer, name):
    return [e for e in tracer.events if e["ph"] == "X" and e["name"] == name]


def _inside(child, parent) -> bool:
    return (child["tid"] == parent["tid"] and parent["ts"] <= child["ts"]
            and child["ts"] + child["dur"] <= parent["ts"] + parent["dur"] + 1e-3)


def _children(tracer, parent, names):
    return sorted((e for e in tracer.events
                   if e["ph"] == "X" and e["name"] in names and _inside(e, parent)),
                  key=lambda e: e["ts"])


def test_round_holds_the_recorder_and_commit_its_phases(tmp_path):
    tr = Tracer()
    t, _ = _run(tmp_path, tr)
    rounds, commits = _spans(tr, "round"), _spans(tr, "commit")
    assert len(rounds) == len(commits) == 4
    rec = [e for e in tr.events if e["name"].startswith("recorder.")]
    assert {e["name"] for e in rec} == {"recorder.elim_note", "recorder.round",
                                       "recorder.scan_phase"}
    for e in rec:  # inside a round, outside every other phase span
        assert sum(_inside(e, r) for r in rounds) == 1
        assert not any(_inside(e, p) for p in tr.events
                       if p["ph"] == "X" and p["name"] in PHASES)
    for r in rounds:
        assert [e["name"] for e in _children(tr, r, {"recorder.round"})] == ["recorder.round"]
    for c in commits:
        kids = _children(tr, c, set(COMMIT_CHILDREN))
        assert [e["name"] for e in kids] == COMMIT_CHILDREN
        assert all(a["ts"] + a["dur"] <= b["ts"] + 1e-3 for a, b in zip(kids, kids[1:]))
        assert not any(_inside(c, r) for r in rounds)
        assert c["args"]["rounds"] == 1
    write = _spans(tr, "sidecar.write")[-1]["args"]
    assert write["bytes"] > 0 and write["records"] == len(t.recorder.records()) - 1
    assert {e["tid"] for e in tr.events if e["ph"] == "X"} == {0}


def test_recorder_off_leaves_no_recorder_or_sidecar_span(tmp_path):
    tr = Tracer()
    t, _ = _run(tmp_path, tr, recorder=False)
    names = {e["name"] for e in tr.events}
    assert not {n for n in names if n.startswith(("recorder.", "sidecar."))}
    for c in _spans(tr, "commit"):
        assert [e["name"] for e in _children(tr, c, set(COMMIT_CHILDREN))] == [
            "commit.capture", "journal_flush", "manifest_commit", "commit.gc"]
    # only the journal's first commit, made while the recorder was still on
    assert len(t.metrics.histogram_values("commit_sidecar_s")) == 1


def test_tracer_off_records_nothing_and_answers_the_same(tmp_path):
    off = Tracer(enabled=False)
    t_on, on = _run(tmp_path / "on", Tracer())
    t_off, outs = _run(tmp_path / "off", off)
    assert off.events == []
    for a, b in zip(on, outs):
        assert torch.equal(a.results, b.results) and torch.equal(a.found, b.found)
        for x, y in zip(a.scan, b.scan):
            assert torch.equal(x, y)
    assert t_on.tree.items() == t_off.tree.items()
    assert t_on.recorder.records() == t_off.recorder.records()


def test_async_commit_runs_on_its_own_track(tmp_path):
    tr = Tracer()
    t, _ = _run(tmp_path, tr, commit_async=True)
    finishes = _spans(tr, "commit.finish")
    assert len(finishes) == 4
    tid = finishes[0]["tid"]
    assert tid >= THREAD_TRACK0 and {e["tid"] for e in finishes} == {tid}
    assert tr.tracks == {tid: "commit"}
    for f in finishes:
        assert [e["name"] for e in _children(tr, f, set(COMMIT_CHILDREN))] == [
            "journal_flush", "sidecar.write", "manifest_commit", "commit.gc"]
    for c in _spans(tr, "commit"):
        assert c["tid"] == 0
        assert [e["name"] for e in _children(tr, c, set(COMMIT_CHILDREN))] == [
            "commit.capture", "sidecar.encode"]
    assert {e["tid"] for e in tr.events if e["name"] == "round"} == {0}
    doc = trace_export.to_chrome_trace(tr)
    assert trace_export.validate_trace(doc) == []
    names = {e["tid"]: e["args"]["name"] for e in doc["traceEvents"] if e["name"] == "thread_name"}
    assert names == {0: "engine", 1: "shard 0", tid: "commit"}
    phases = report.report_summary(doc)["phases"]  # the engine track's table
    assert "commit.capture" in phases and "journal_flush" not in phases


@pytest.mark.parametrize("traced", [False, True])
def test_each_commit_histogram_observes_each_commit_once(tmp_path, traced):
    tr = Tracer(enabled=traced)
    t, _ = _run(tmp_path, tr)
    n = t.dstats.commits
    assert n == 5  # the journal's first commit and one a round
    for h in HISTS + ("commit_latency_s",):
        assert len(t.metrics.histogram_values(h)) == n, h
    if traced:  # the sidecar's histogram is its two spans' timed stretches
        enc, wr = _spans(tr, "sidecar.encode"), _spans(tr, "sidecar.write")
        for v, a, b in zip(t.metrics.histogram_values("commit_sidecar_s")[1:], enc, wr):
            assert 0 < v <= (a["dur"] + b["dur"]) / 1e6 + 1e-6


def test_span_starts_with_its_profiler_range(tmp_path):
    tr = Tracer()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        # the first range a process opens under the profiler pays the
        # profiler's own set-up (~1 ms) after the profiler stamped its start
        with torch.profiler.record_function("warm-up"):
            pass
        _run(tmp_path, tr)
    starts = {}
    for e in prof.profiler.kineto_results.events():
        starts.setdefault(e.name(), []).append(e.start_ns() / 1e3)
    names = ("round", "search_combine", "recorder.elim_note", "commit", "sidecar.write")
    for name in names:
        ours = sorted(e["ts"] for e in _spans(tr, name))
        theirs = sorted(starts.get(name, []))
        assert len(ours) == len(theirs) > 0, name
        # the median pair: a loaded host may preempt the thread between
        # the two stamps of a single span
        assert statistics.median(abs(a - b) for a, b in zip(ours, theirs)) < 500.0, name


def test_tracer_off_calls_no_profiler_range_or_sync(tmp_path, monkeypatch):
    calls = {"record_function": 0, "synchronize": 0}
    real = torch.profiler.record_function

    def record_function(*a, **kw):
        calls["record_function"] += 1
        return real(*a, **kw)

    def synchronize(*a, **kw):
        calls["synchronize"] += 1

    monkeypatch.setattr(torch.profiler, "record_function", record_function)
    monkeypatch.setattr(torch.cuda, "synchronize", synchronize)
    _run(tmp_path / "off")
    assert calls == {"record_function": 0, "synchronize": 0}
    _run(tmp_path / "on", Tracer())
    assert calls["record_function"] > 0 and calls["synchronize"] == 0


def test_sidecar_encodes_only_the_records_new_since_the_last_commit(tmp_path, monkeypatch):
    seen = _spy_dumps(monkeypatch)
    tr = Tracer()
    t = DurableABTree(str(tmp_path), CFG, device="cpu")
    t.tracer = tr
    for r in _rounds():
        t.apply_round(*r, scan_cap=16)
        # the file is the header, then the ring at capture encoded afresh
        _, data, idx = _sidecar(tmp_path)
        header = json.dumps({"kind": "sidecar", "commit_idx": idx, "backend": "tree",
                             "rounds": t.tree._rounds})
        assert data == "".join(x + "\n" for x in [header, *seen[-1][1]]).encode()
    t.close()
    enc, wr = _spans(tr, "sidecar.encode"), _spans(tr, "sidecar.write")
    assert len(enc) == len(wr) == len(seen) - 1 == 4  # the first commit ran untraced
    for (prev, _), (seqs, _), e, w in zip(seen[:-1], seen[1:], enc, wr):
        new = [q for q in seqs if q > max(prev, default=-1)]
        assert new and e["args"]["encoded"] == len(new) <= 3
        assert e["args"]["records"] == w["args"]["records"] == len(seqs)


def test_torn_sidecar_cuts_at_the_plain_encodings_byte(tmp_path, monkeypatch):
    seen = _spy_dumps(monkeypatch)
    plan = FaultPlan(specs=[FaultSpec(site="sidecar_write", kind="torn", commits=(3, 4),
                                      torn_frac=0.37)])
    t = DurableABTree(str(tmp_path), CFG, device="cpu", faults=plan)
    for r in _rounds(3):
        t.apply_round(*r, scan_cap=16)
    name, data, idx = _sidecar(tmp_path)
    assert idx == 3 and plan.injected == 1
    header = json.dumps({"kind": "sidecar", "commit_idx": 3, "backend": "tree", "rounds": 3})
    whole = ("\n".join([header, *seen[-1][1]]) + "\n").encode()
    assert data == whole[: max(1, int(len(whole) * 0.37))]
    t.close()
    r = recover(str(tmp_path), device="cpu")
    assert r._quarantined == [f"quarantine/{name}"] and r.forensics_records() == []
    assert os.path.exists(os.path.join(tmp_path, "quarantine", name))
    assert r.tree.items() == t.tree.items()


def test_sidecar_write_resumes_after_short_writes(tmp_path, monkeypatch):
    """A ``writev`` that takes at most two buffers and 1,000 bytes a call
    still leaves the whole file."""
    seen = _spy_dumps(monkeypatch)
    real = os.writev
    calls = []

    def writev(fd, buffers):
        assert len(buffers) <= 2
        calls.append(len(buffers))
        return real(fd, [b"".join(buffers)[:1000]])

    monkeypatch.setattr(durable, "_IOV_MAX", 2)
    monkeypatch.setattr(os, "writev", writev)
    t = DurableABTree(str(tmp_path), CFG, device="cpu")
    for r in _rounds(2):
        t.apply_round(*r, scan_cap=16)
    t.close()
    _, data, idx = _sidecar(tmp_path)
    header = json.dumps({"kind": "sidecar", "commit_idx": idx, "backend": "tree", "rounds": 2})
    assert data == ("\n".join([header, *seen[-1][1]]) + "\n").encode()
    assert len(data) > 3000 and len(calls) > len(data) // 1000
