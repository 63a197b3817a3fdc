"""The port's linearizability witness (``repro_torch.obs.witness``) against
the JAX package's (``repro.obs.witness``).

Port histories from ``tests/test_witness.py``'s ``_mixed_history`` recipe
(mixed point and range rounds over duplicate keys, a fused scan + delete
and a trailing scan round), in elim and occ mode on a tree and on a
four-shard forest, must give equal reports from both witnesses: rounds,
lanes, eliminated ops, final state and every prefix state.  The port's
witness must accept a JAX-recorded history (one small JAX tree, recorded
once in a module fixture, whose tracer also gives the span names the
port's tracer must give on the same rounds).  A swapped elimination pair
and a dropped delete must be rejected by both witnesses and both CLIs."""
import collections
import copy
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as J  # noqa: E402  (enables jax x64 before any JAX input is built)
from repro.obs import witness as jw  # noqa: E402
from repro.obs.recorder import Recorder as JRecorder  # noqa: E402
from repro.obs.tracer import Tracer as JTracer  # noqa: E402

import repro_torch.core as T  # noqa: E402
from repro_torch.obs import witness as tw  # noqa: E402
from repro_torch.obs.recorder import Recorder  # noqa: E402
from repro_torch.obs.tracer import Tracer  # noqa: E402

CFG = T.TreeConfig(capacity=2048, b=8, a=2, max_height=12)
KEY_RANGE = 4096
REPORT_FIELDS = ("rounds", "lanes", "eliminated", "state", "prefix_states")
# spans only the port's forest emits (its repartition's sweep and re-insert,
# ``core/forest.py``); a tree round emits neither, in either package
PORT_ONLY_SPANS = {"shard_sweep", "shard_reinsert"}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the port's rounds run thousands of small ops,
    which oversubscribed thread pools slow by tens of times in a parallel
    test run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _holder(mode, shards):
    if shards == 1:
        h = T.ABTree(CFG, mode=mode, device="cpu")
    else:
        h = T.ABForest(n_shards=shards, cfg=CFG, mode=mode, key_space=(0, KEY_RANGE),
                       device="cpu")
    h.recorder = Recorder(capacity=100_000)
    return h


def _mixed_rounds(rng, rounds, n=64, key_range=KEY_RANGE):
    """``tests/test_witness.py``'s rounds: duplicate keys so elimination
    segments form, three range lanes a round."""
    out = []
    for _ in range(rounds):
        ops = rng.choice([T.OP_INSERT, T.OP_DELETE, T.OP_FIND], size=n,
                         p=[0.5, 0.25, 0.25]).astype(np.int32)
        keys = rng.integers(0, key_range, n).astype(np.int64)
        vals = rng.integers(1, 1000, n).astype(np.int64)
        ops[:3] = T.OP_RANGE
        keys[:3] = rng.integers(0, key_range - 64, 3)
        vals[:3] = rng.integers(1, 64, 3)
        out.append((ops, keys, vals))
    return out


def _mixed_history(mode="elim", shards=1, rounds=6, seed=0):
    h = _holder(mode, shards)
    for ops, keys, vals in _mixed_rounds(np.random.default_rng(seed), rounds):
        h.apply_round(ops, keys, vals, scan_cap=16)
    h.scan_delete_round([0], [32], cap=8)
    h.scan_round([0], [KEY_RANGE], cap=32)
    return h.recorder.records()


def _assert_reports_equal(got, want):
    for f in REPORT_FIELDS:
        assert getattr(got, f) == getattr(want, f), f
    assert got.summary() == want.summary()


@pytest.mark.parametrize("mode", ["elim", "occ"])
@pytest.mark.parametrize("shards", [1, 4])
def test_witness_reports_equal_jax(mode, shards):
    recs = _mixed_history(mode=mode, shards=shards)
    rounds = [r for r in recs if r["kind"] == "round"]
    assert rounds[-2].get("fused") == "scan_delete" and rounds[-1]["ops"][0] == T.OP_RANGE
    for prefixes in (False, True):
        got = tw.check_history(recs, collect_prefixes=prefixes)
        _assert_reports_equal(got, jw.check_history(recs, collect_prefixes=prefixes))
    assert got.rounds == len(rounds) == 8
    assert got.state and len(got.prefix_states) == got.rounds + 1
    if mode == "elim":
        assert got.eliminated > 0


@pytest.fixture(scope="module")
def jax_run():
    """One small JAX tree through mixed rounds with its recorder and tracer
    on: its history, and its spans by (name, phase, track)."""
    t = J.ABTree(J.TreeConfig(capacity=256, b=8, a=2, max_height=12))
    t.recorder = JRecorder(capacity=10_000)
    t.tracer = JTracer()
    rounds = _mixed_rounds(np.random.default_rng(5), 4, key_range=512)
    for ops, keys, vals in rounds:
        t.apply_round(ops, keys, vals, scan_cap=16)
    spans = collections.Counter((e["name"], e["ph"], e["tid"]) for e in t.tracer.events)
    return rounds, t.recorder.records(), spans


def test_port_witness_accepts_jax_history(jax_run):
    _, recs, _ = jax_run
    got = tw.check_history(recs, collect_prefixes=True)
    _assert_reports_equal(got, jw.check_history(recs, collect_prefixes=True))
    assert got.rounds == 4 and got.eliminated > 0


def test_span_names_equal_jax(jax_run):
    """The port's tracer gives JAX's spans and instants, by name, phase and
    track, on the same rounds (the port-only forest spans left out: a tree
    emits none of them), and the same history."""
    rounds, jrecs, jspans = jax_run
    t = T.ABTree(T.TreeConfig(capacity=256, b=8, a=2, max_height=12), device="cpu")
    t.recorder = Recorder(capacity=10_000)
    t.tracer = Tracer()
    for ops, keys, vals in rounds:
        t.apply_round(ops, keys, vals, scan_cap=16)
    spans = collections.Counter((e["name"], e["ph"], e["tid"]) for e in t.tracer.events
                                if e["name"] not in PORT_ONLY_SPANS)
    assert spans == jspans
    assert t.recorder.records() == jrecs


def _pair_history():
    """One annihilated insert / delete pair and a later read of its key."""
    t = _holder("elim", 1)
    t.apply_round(np.array([T.OP_INSERT, T.OP_DELETE, T.OP_INSERT], np.int32),
                  np.array([5, 5, 77], np.int64), np.array([50, 0, 700], np.int64))
    t.apply_round(np.full(2, T.OP_FIND, np.int32), np.array([5, 77], np.int64),
                  np.zeros(2, np.int64))
    return t.recorder.records()


def _swapped_pair():
    bad = copy.deepcopy(_pair_history())
    rr = next(r for r in bad if r["kind"] == "round")
    i, j = rr["ops"].index(T.OP_INSERT), rr["ops"].index(T.OP_DELETE)
    assert rr["keys"][i] == rr["keys"][j] == 5 and rr["found"][i] != rr["found"][j]
    assert rr["elim"] and rr["elim"][0]["eliminated"] == [2]
    for f in ("results", "found"):
        rr[f][i], rr[f][j] = rr[f][j], rr[f][i]
    return bad


def _dropped_delete():
    t = _holder("elim", 1)
    t.apply_round(np.full(2, T.OP_INSERT, np.int32), np.array([11, 22], np.int64),
                  np.array([110, 220], np.int64))
    t.apply_round(np.array([T.OP_DELETE], np.int32), np.array([11], np.int64),
                  np.zeros(1, np.int64))
    t.apply_round(np.full(2, T.OP_FIND, np.int32), np.array([11, 22], np.int64),
                  np.zeros(2, np.int64))
    recs = t.recorder.records()
    bad = [r for r in recs if not (r["kind"] == "round" and T.OP_DELETE in r["ops"])]
    assert len(bad) == len(recs) - 1
    return bad


@pytest.mark.parametrize("corrupt", [_swapped_pair, _dropped_delete])
def test_corrupted_history_rejected_by_both(corrupt, tmp_path, capsys):
    bad = corrupt()
    with pytest.raises(tw.WitnessError):
        tw.check_history(bad)
    with pytest.raises(jw.WitnessError):
        jw.check_history(bad)
    path = tmp_path / "bad.jsonl"
    path.write_text("".join(json.dumps(r) + "\n" for r in bad))
    assert tw.main([str(path)]) == 1
    assert "WITNESS FAILED" in capsys.readouterr().err
    assert jw.main([str(path)]) == 1
    assert "WITNESS FAILED" in capsys.readouterr().err


def test_cli_and_check_file_equal_jax(tmp_path, capsys):
    h = _holder("elim", 1)
    for ops, keys, vals in _mixed_rounds(np.random.default_rng(2), 3):
        h.apply_round(ops, keys, vals, scan_cap=16)
    path = h.recorder.export(str(tmp_path / "audit.jsonl"))
    _assert_reports_equal(tw.check_file(path), jw.check_file(path))
    assert tw.main([path]) == 0
    out = capsys.readouterr().out
    assert jw.main([path]) == 0
    assert out == capsys.readouterr().out and "witness OK" in out
    assert tw.main([path, "-q"]) == 0 and capsys.readouterr().out == ""
    missing = str(tmp_path / "missing.jsonl")
    assert tw.main([missing]) == jw.main([missing]) == 1
