"""Whole-round parity of the port's S = 1 elim engine with the JAX engine.

The same seeded rounds go through ``repro.core.ABTree`` and
``repro_torch.core.ABTree(device="cpu")``: mixed point and range lanes over
Zipf-skewed keys that grow the tree (splits), churn it, then delete most of
it (merges, distributes, root shrinks), with a small scan cap so scans
truncate.  Per-lane results, found flags and scan rows, ``items()``,
``stats()`` and every pool array except the scratch row must be equal after
every round; the port's ``check_invariants`` must hold; the port's flight
recorder history must pass the JAX package's linearizability witness.  A
tree grown in JAX and carried across with ``repro_torch.interop`` must then
run on in the port exactly as it runs on in JAX."""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as J  # noqa: E402  (enables jax x64 before any JAX input is built)
from repro.obs.witness import check_history  # noqa: E402

import repro_torch.core as T  # noqa: E402
from repro_torch.core.oracle import check_invariants  # noqa: E402
from repro_torch.data.workloads import zipf_keys  # noqa: E402
from repro_torch.interop import state_from_numpy, state_to_numpy  # noqa: E402

CFG = dict(capacity=256, b=8, a=2, max_height=12)
WIDTH, CAP, KEY_RANGE = 64, 6, 600
HANDOFF = 6  # round after which a JAX-grown tree is carried into the port


def _schedule(seed=11):
    """(ops, keys, vals) per round: grow, churn, then drain."""
    rng = np.random.default_rng(seed)
    present = set()
    rounds = []
    for r in range(14):
        keys = zipf_keys(rng, WIDTH, KEY_RANGE, 0.6)
        if r < 6:  # grow: splits
            pool = [T.OP_INSERT] * 5 + [T.OP_FIND, T.OP_DELETE, T.OP_RANGE]
        elif r < 9:  # churn
            pool = [T.OP_INSERT, T.OP_DELETE, T.OP_DELETE, T.OP_FIND, T.OP_RANGE]
        else:  # drain: delete what is present (merges, distributes, root shrinks)
            pool = [T.OP_DELETE] * 6 + [T.OP_RANGE]
            live = np.array(sorted(present), np.int64)
            if live.size:
                keys = rng.choice(live, size=WIDTH)
        ops = rng.choice(pool, WIDTH).astype(np.int32)
        vals = rng.integers(0, 1 << 40, WIDTH).astype(np.int64)
        rl = ops == T.OP_RANGE
        vals[rl] = rng.integers(0, 120, int(rl.sum()))  # spans; some exceed CAP matches
        if r == 4:
            vals[np.nonzero(rl)[0][:1]] = (1 << 63) - 1 - keys[np.nonzero(rl)[0][:1]]  # to the top
        for op, k in zip(ops.tolist(), keys.tolist()):
            if op == T.OP_INSERT:
                present.add(k)
            elif op == T.OP_DELETE:
                present.discard(k)
        rounds.append((ops, keys, vals))
    return rounds


def _jstate(tree):
    st = tree.state
    d = {k: np.asarray(v) for k, v in st._asdict().items() if k != "stats"}
    d["stats"] = {k: np.asarray(v) for k, v in st.stats._asdict().items()}
    return d


def _pool_diff(jtree, ttree):
    """Names of pool arrays that differ outside the scratch row (or in
    shape / the tree scalars)."""
    want = _jstate(jtree)
    got = state_to_numpy(ttree.stacked)
    bad = []
    for name, w in want.items():
        if name == "stats":
            bad += [f"stats.{k}" for k, v in w.items() if int(got["stats"][k][0]) != int(v)]
            continue
        g = got[name][0]
        if g.shape != w.shape:
            bad.append(f"{name} shape")
        elif w.ndim == 0:
            if int(g) != int(w):
                bad.append(name)
        elif not np.array_equal(g[:-1], w[:-1]):
            bad.append(name)
    return bad


def _scan_np(scan):
    return None if scan is None else tuple(np.asarray(x) for x in scan)


@pytest.fixture(scope="module")
def run():
    jt = J.ABTree(J.TreeConfig(**CFG))
    tt = T.ABTree(T.TreeConfig(**CFG), device="cpu")
    jo, to = J.DictOracle(), T.DictOracle()
    out = dict(rounds=[], pool_diffs=[], invariant_errors=[], heights=[], oracle=[],
               scan_rounds=[], handoff=[])
    handed = None
    for r, (ops, keys, vals) in enumerate(_schedule()):
        a = jt.apply_round(ops, keys, vals, scan_cap=CAP)
        b = tt.apply_round(ops, keys, vals, scan_cap=CAP)
        out["rounds"].append(((np.asarray(a.results), np.asarray(a.found), _scan_np(a.scan)),
                              (b.results.numpy(), b.found.numpy(), _scan_np(b.scan))))
        out["pool_diffs"].append(_pool_diff(jt, tt))
        try:
            check_invariants(tt.state, tt.cfg)
        except AssertionError as e:
            out["invariant_errors"].append((r, str(e)))
        out["heights"].append(int(tt.stacked.height[0]))
        out["oracle"].append((jo.apply_mixed_round(ops, keys, vals, cap=CAP),
                              to.apply_mixed_round(ops, keys, vals, cap=CAP)))
        if r == 3:  # a pure scan round through both engines
            lo = np.array([0, 50, 300, 599], np.int64)
            hi = np.array([40, 400, 301, 10**6], np.int64)
            out["scan_rounds"].append((_scan_np(jt.scan_round(lo, hi, cap=CAP)),
                                       _scan_np(tt.scan_round(lo, hi, cap=CAP))))
        if handed is not None:
            c = handed.apply_round(ops, keys, vals, scan_cap=CAP)
            out["handoff"].append(((np.asarray(a.results), np.asarray(a.found), _scan_np(a.scan)),
                                   (c.results.numpy(), c.found.numpy(), _scan_np(c.scan)),
                                   _pool_diff(jt, handed)))
        if r == HANDOFF:
            handed = T.ABTree(T.TreeConfig(*jt.cfg), device="cpu")
            handed.stacked = state_from_numpy(_jstate(jt))
            handed._scan_frontier = jt._scan_frontier
    out.update(jt=jt, tt=tt, jo=jo, to=to)
    return out


def _eq_scan(a, b):
    if a is None or b is None:
        return a is None and b is None
    return all(np.array_equal(x, y) for x, y in zip(a, b))


def test_results_and_found_equal_every_round(run):
    for r, (a, b) in enumerate(run["rounds"]):
        assert np.array_equal(a[0], b[0]), f"round {r} results"
        assert np.array_equal(a[1], b[1]), f"round {r} found"


def test_scan_rows_equal_every_round(run):
    for r, (a, b) in enumerate(run["rounds"]):
        assert _eq_scan(a[2], b[2]), f"round {r} scan rows"
    for a, b in run["scan_rounds"]:
        assert _eq_scan(a, b), "scan_round rows"


def test_pools_equal_except_scratch_every_round(run):
    for r, diff in enumerate(run["pool_diffs"]):
        assert diff == [], f"round {r}: {diff}"


def test_items_and_stats_equal(run):
    jt, tt = run["jt"], run["tt"]
    assert tt.items() == jt.items()
    assert tt.stats() == jt.stats()
    assert tt.items() == run["to"].items()


def test_port_invariants_hold_every_round(run):
    assert run["invariant_errors"] == []


def test_schedule_exercises_splits_merges_shrinks_and_truncation(run):
    tt = run["tt"]
    m = tt.metrics
    assert m.value("split_waves") > 0 and m.value("retry_passes") > 0
    assert m.value("underfull_waves") > 0
    assert m.value("root_shrinks") > 0 and run["heights"][-1] < max(run["heights"])
    truncated = [b[2][3].any() for _, b in run["rounds"] if b[2] is not None]
    assert any(truncated)


def test_port_oracle_copy_equals_jax_oracle(run):
    for r, (a, b) in enumerate(run["oracle"]):
        assert a == b, f"round {r}"


def test_recorder_history_passes_jax_witness(run):
    """The port's flight-recorder history, in the shared JSONL schema, is
    accepted by the JAX package's witness and equals the JAX recorder's."""
    jt, tt = run["jt"], run["tt"]
    records = [json.loads(line) for line in tt.recorder.dump_records()]
    report = check_history(records)
    assert report.rounds == len(run["rounds"]) + len(run["scan_rounds"])
    assert report.state == run["jo"].items()
    assert records == [json.loads(line) for line in jt.recorder.dump_records()]


def test_tree_grown_in_jax_runs_on_in_the_port(run):
    assert len(run["handoff"]) == len(run["rounds"]) - HANDOFF - 1
    for r, (a, c, diff) in enumerate(run["handoff"]):
        assert np.array_equal(a[0], c[0]) and np.array_equal(a[1], c[1]), f"handoff round {r}"
        assert _eq_scan(a[2], c[2]), f"handoff round {r} scan rows"
        assert diff == [], f"handoff round {r}: {diff}"


def test_plan_validation_and_point_api():
    t = T.ABTree(T.TreeConfig(**CFG), device="cpu")
    with pytest.raises(ValueError, match="negative span"):
        t.apply_round([T.OP_RANGE], [5], [-1])
    with pytest.raises(ValueError, match="unknown op code"):
        t.apply_round([7], [5], [1])
    assert t.apply_round([], []).results.numel() == 0
    assert t.insert(5, 50) is None and t.insert(5, 51) == 50
    assert t.find(5) == 50 and t.delete(5) == 50 and t.find(5) is None


def test_round_plan_equals_jax_build_plan():
    ops = np.array([T.OP_FIND, T.OP_RANGE, T.OP_INSERT, T.OP_NOP, T.OP_RANGE, T.OP_DELETE], np.int32)
    keys = np.array([4, 10, 7, 0, (1 << 63) - 5, 9], np.int64)
    vals = np.array([0, 5, 70, 0, 100, 0], np.int64)
    from repro_torch.core.rounds import build_plan

    want = J.build_plan(ops, keys, vals, scan_cap=16)
    got = build_plan(ops, keys, vals, scan_cap=16)
    for name in want._fields:
        w, g = getattr(want, name), getattr(got, name)
        if isinstance(w, (bool, int)):
            assert g == w, name
        else:
            assert np.array_equal(g.numpy(), np.asarray(w)), name


# ----------------------------------------------------------------------------
# scan_delete_round: one fused scan + delete-the-emitted-keys round
# ----------------------------------------------------------------------------

SWEEPS = [  # (lo, hi, cap): truncated chunks, an empty range, multi-lane
    ([0], [200], 4),
    ([0], [200], 4),
    ([150, 400], [260, 10**6], 8),
    ([250], [251], 8),
    ([0], [1 << 40], 64),
]


@pytest.fixture(scope="module")
def sweeps():
    """A tree grown by the first rounds of the schedule, then swept by
    ``scan_delete_round`` in both engines."""
    jt = J.ABTree(J.TreeConfig(**CFG))
    tt = T.ABTree(T.TreeConfig(**CFG), device="cpu")
    for ops, keys, vals in _schedule()[:7]:
        jt.apply_round(ops, keys, vals, scan_cap=CAP)
        tt.apply_round(ops, keys, vals, scan_cap=CAP)
    out = []
    for lo, hi, cap in SWEEPS:
        a = jt.scan_delete_round(lo, hi, cap=cap)
        b = tt.scan_delete_round(lo, hi, cap=cap)
        out.append((_scan_np(a), _scan_np(b), _pool_diff(jt, tt), tt.items() == jt.items()))
    return dict(jt=jt, tt=tt, out=out)


@pytest.mark.parametrize("i", range(len(SWEEPS)))
def test_scan_delete_round_equals_jax(sweeps, i):
    """Evicted rows, counts and truncation flags, the pool and the contents
    after each sweep are those of the JAX engine."""
    a, b, diff, same_items = sweeps["out"][i]
    assert _eq_scan(a, b), f"sweep {i} rows"
    assert diff == [], f"sweep {i}: {diff}"
    assert same_items


def test_scan_delete_round_sweeps_and_truncates(sweeps):
    """The sweeps did real work: the first chunks were truncated, the next
    chunk resumed past them, and every emitted key is gone."""
    out, tt = sweeps["out"], sweeps["tt"]
    first, second = out[0][1], out[1][1]
    assert bool(first[3][0]) and int(first[2][0]) == 4
    assert set(first[0][0, :4].tolist()).isdisjoint(second[0][0, : int(second[2][0])].tolist())
    assert int(out[3][1][2][0]) == 0  # an empty range deletes nothing
    emitted = {k for _, b, _, _ in out for row, n in zip(b[0], b[2]) for k in row[: int(n)].tolist()}
    assert len(emitted) > 64 and emitted.isdisjoint(tt.items())
    check_invariants(tt.state, tt.cfg)
    assert tt.stats() == sweeps["jt"].stats()


def test_scan_delete_recorder_records_equal_jax(sweeps):
    """``fused="scan_delete"`` records (range lanes, then one delete lane
    per emitted key) equal the JAX recorder's and pass its witness."""
    jt, tt = sweeps["jt"], sweeps["tt"]
    records = [json.loads(line) for line in tt.recorder.dump_records()]
    assert records == [json.loads(line) for line in jt.recorder.dump_records()]
    fused = [r for r in records if r.get("fused") == "scan_delete"]
    assert len(fused) == len(SWEEPS)
    check_history(records)
