"""occ mode and the rest of the scan API: the port against the JAX package.

The grow / churn / drain schedule of ``test_torch_rounds.py`` goes through
``repro.core.ABTree(mode="occ")`` and ``repro_torch.core.ABTree(mode="occ",
device="cpu")``: per-lane results, found flags and scan rows, every pool
array except the scratch row, ``take_dirty`` and the ``subround_hook``
count must be equal after every round; ``items()``, ``stats()``
(``subrounds`` included) and the flight-recorder history at the end, and
that history must pass the JAX package's witness.  ``_duplicate_ranks``
is held to JAX's on seeded and edge-case batches; ``scan_stream`` pages,
across truncation, and ``range_query`` to JAX's and ``DictOracle.range``."""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as J  # noqa: E402  (enables jax x64 before any JAX input is built)
from repro.core import rounds as jrounds  # noqa: E402
from repro.obs.witness import check_history  # noqa: E402

import repro_torch.core as T  # noqa: E402
from repro_torch.core import rounds as trounds  # noqa: E402
from repro_torch.core.oracle import check_invariants  # noqa: E402
from test_torch_rounds import CAP, CFG, _pool_diff, _scan_np, _schedule  # noqa: E402


def _rank_cases():
    rng = np.random.default_rng(5)
    ops = rng.integers(0, 4, 64).astype(np.int32)
    keys = rng.integers(0, 12, 64).astype(np.int64)
    return {
        "seeded": (ops, keys),
        "wide_keys": (rng.integers(1, 4, 200).astype(np.int32),
                      rng.choice([0, 1 << 62, (1 << 63) - 2, -(1 << 40)], 200).astype(np.int64)),
        "all_nop": (np.zeros(16, np.int32), keys[:16]),
        "all_equal": (np.full(16, T.OP_INSERT, np.int32), np.full(16, 7, np.int64)),
        "empty": (np.zeros(0, np.int32), np.zeros(0, np.int64)),
    }


@pytest.mark.parametrize("case", list(_rank_cases()))
def test_duplicate_ranks_equal_jax(case):
    ops, keys = _rank_cases()[case]
    want = jrounds._duplicate_ranks(ops, keys)
    got = trounds._duplicate_ranks(ops, keys)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def _count_hook(counter):
    def hook():
        counter[0] += 1
    return hook


@pytest.fixture(scope="module")
def run():
    jt = J.ABTree(J.TreeConfig(**CFG), mode="occ")
    tt = T.ABTree(T.TreeConfig(**CFG), mode="occ", device="cpu")
    jhooks, thooks = [0], [0]
    jt.subround_hook = _count_hook(jhooks)
    tt.subround_hook = _count_hook(thooks)
    out = dict(rounds=[], pool_diffs=[], dirty=[], hooks=[], invariant_errors=[], oracle=[])
    to = T.DictOracle()
    for r, (ops, keys, vals) in enumerate(_schedule()):
        a = jt.apply_round(ops, keys, vals, scan_cap=CAP)
        b = tt.apply_round(ops, keys, vals, scan_cap=CAP)
        out["rounds"].append(((np.asarray(a.results), np.asarray(a.found), _scan_np(a.scan)),
                              (b.results.numpy(), b.found.numpy(), _scan_np(b.scan))))
        out["pool_diffs"].append(_pool_diff(jt, tt))
        out["dirty"].append((jt.take_dirty(), tt.take_dirty()))
        out["hooks"].append((jhooks[0], thooks[0]))
        out["oracle"].append(to.apply_mixed_round(ops, keys, vals, cap=CAP)[:2])
        try:
            check_invariants(tt.state, tt.cfg)
        except AssertionError as e:
            out["invariant_errors"].append((r, str(e)))
    out.update(jt=jt, tt=tt, to=to)
    return out


def test_occ_results_and_scan_rows_equal_every_round(run):
    for r, (a, b) in enumerate(run["rounds"]):
        assert np.array_equal(a[0], b[0]), f"round {r} results"
        assert np.array_equal(a[1], b[1]), f"round {r} found"
        assert (a[2] is None) == (b[2] is None), f"round {r} scan"
        if a[2] is not None:
            assert all(np.array_equal(x, y) for x, y in zip(a[2], b[2])), f"round {r} scan rows"


def test_occ_results_equal_the_oracle(run):
    for r, ((_, b), want) in enumerate(zip(run["rounds"], run["oracle"])):
        assert np.array_equal(b[0], np.asarray(want[0], np.int64)), f"round {r}"
        assert np.array_equal(b[1], np.asarray(want[1], bool)), f"round {r}"


def test_occ_pools_equal_except_scratch_every_round(run):
    for r, diff in enumerate(run["pool_diffs"]):
        assert diff == [], f"round {r}: {diff}"


def test_occ_items_stats_and_invariants(run):
    jt, tt = run["jt"], run["tt"]
    assert tt.items() == jt.items() == run["to"].items()
    assert tt.stats() == jt.stats()
    assert tt.stats()["subrounds"] > len(run["rounds"])  # duplicate keys forced sub-rounds
    assert tt.metrics.value("occ_subrounds") == jt.metrics.value("occ_subrounds")
    assert run["invariant_errors"] == []


def test_occ_subround_hook_fires_as_in_jax(run):
    assert [t for _, t in run["hooks"]] == [j for j, _ in run["hooks"]]
    assert run["hooks"][-1][1] == run["tt"].stats()["subrounds"]


def test_take_dirty_equals_jax_every_round(run):
    for r, (a, b) in enumerate(run["dirty"]):
        assert b.dtype == a.dtype and np.array_equal(a, b), f"round {r}"
    assert run["tt"].take_dirty().size == 0


def test_occ_recorder_history_passes_jax_witness(run):
    jt, tt = run["jt"], run["tt"]
    records = [json.loads(line) for line in tt.recorder.dump_records()]
    assert records == [json.loads(line) for line in jt.recorder.dump_records()]
    assert any("occ" in r for r in records)
    report = check_history(records)
    assert report.state == run["to"].items()


STREAMS = [(0, 600, 5), (37, 412, 16), (0, 1 << 62, 64), (250, 251, 3), (590, 10, 4)]


@pytest.mark.parametrize("lo,hi,cap", STREAMS)
def test_scan_stream_pages_equal_jax(run, lo, hi, cap):
    """Cursor pages across truncation: the same pairs, in as many scan
    rounds, as the JAX tree and ``DictOracle.range``."""
    jt, tt = run["jt"], run["tt"]
    j0, t0 = jt._rounds, tt._rounds
    got = list(tt.scan_stream(lo, hi, cap=cap))
    want = list(jt.scan_stream(lo, hi, cap=cap))
    assert got == want == run["to"].range(lo, hi)
    assert tt._rounds - t0 == jt._rounds - j0


def test_scan_stream_refuses_a_nonpositive_cap(run):
    with pytest.raises(ValueError, match="cap must be positive"):
        run["tt"].scan_stream(0, 10, cap=0)


@pytest.mark.parametrize("lo,hi", [(0, 600), (120, 121), (-(1 << 63), 1 << 64), (300, 200)])
def test_range_query_equals_jax_and_oracle(run, lo, hi):
    jt, tt = run["jt"], run["tt"]
    got = T.range_query(tt, lo, hi)
    assert got == J.range_query(jt, lo, hi)
    assert got == run["to"].range(lo, hi)


def test_range_query_retries_then_raises_on_conflict():
    """A state whose versions move under every walk exhausts the retries."""
    tt = T.ABTree(T.TreeConfig(**CFG), device="cpu")
    tt.apply_round([T.OP_INSERT] * 3, [1, 2, 3], [10, 20, 30])

    class Moving:
        cfg = tt.cfg

        @property
        def state(self):
            tt.stacked = tt.stacked._replace(ver=tt.stacked.ver + 2)
            return tt.state

    with pytest.raises(T.ScanConflictError):
        T.range_query(Moving(), 0, 10, max_retries=3)
    assert T.range_query(tt, 0, 10) == [(1, 10), (2, 20), (3, 30)]
