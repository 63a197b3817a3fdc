"""The readers of the recorder's and the durable commit's spans, on
hand-made span totals and on traced rehearsals of both cells."""
import pytest

from bench import harness
from bench.test_bench_harness import DUR, UPD, rehearse

SPANS = {"seconds": {"round": 1.0, "retry": 0.3, "recorder.elim_note": 0.1,
                     "recorder.round": 0.3, "recorder.scan_phase": 0.02, "commit": 1.2,
                     "commit.capture": 0.04, "sidecar.encode": 0.2, "sidecar.write": 0.6,
                     "journal_flush": 0.2}, "rounds": 4, "round_self_s": 0.2}
WANT = {"recorder_ms": 105.0, "recorder_ms.durable": 105.0, "sidecar_ms": 200.0,
        "capture_ms": 10.0}
# what a traced run of a program without these spans gives
BEFORE = {"seconds": {"round": 1.0, "retry": 0.3, "journal_flush": 0.2,
                      "manifest_commit": 0.1}, "rounds": 4, "round_self_s": 0.2}


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_on_hand_made_spans(name):
    read = harness.reader(harness.BENCH_DIR, name)
    assert read({"spans": SPANS}) == pytest.approx(WANT[name])
    assert read({"spans": BEFORE}) is None
    assert read({"spans": dict(SPANS, rounds=0)}) is None
    assert read({}) is None


def test_sidecar_reads_either_part():
    read = harness.reader(harness.BENCH_DIR, "sidecar_ms")
    only = dict(SPANS, seconds={"sidecar.write": 0.4})
    assert read({"spans": only}) == pytest.approx(100.0)


@pytest.mark.parametrize("cell,names", [
    (UPD, {"recorder_ms"}),
    (DUR, {"recorder_ms.durable", "sidecar_ms", "capture_ms"}),
])
def test_traced_rehearsal_reports_the_new_spans(monkeypatch, cell, names):
    monkeypatch.setattr(harness, "PROFILE_MARGIN_S", 0.0)
    monkeypatch.setattr(harness, "PROFILE_ROUNDS", 1)
    monkeypatch.setattr(harness, "SPAN_ROUNDS", 2)
    res = rehearse(cell, trace=True, seconds=0.0)
    assert res["correct"], res["checks"]
    assert names <= set(res["metrics"])
    assert all(res["metrics"][n]["value"] > 0 for n in names)
