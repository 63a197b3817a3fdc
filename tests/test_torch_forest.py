"""The port's ``ABForest`` against the JAX package's on the CPU.

The grow / churn / drain schedule of ``test_torch_rounds.py`` goes through
``repro.core.ABForest`` and ``repro_torch.core.ABForest(device="cpu")`` at
S = 1, 2 and 4 shards, in elim and occ mode, over a key space whose split
points the schedule's range lanes cross.  Per-lane results, found flags
and scan rows, every pool array of every shard except its scratch row,
``splits``, ``take_dirty``, ``stats()`` and ``stats_per_shard()`` must be
equal after every round, ``check_forest_invariants`` must hold, and the
flight-recorder histories must be equal.  A one-shard forest must equal
the port's ``ABTree``; a forest grown in JAX and carried across with
``repro_torch.interop`` must run on as it does in JAX; ``scan_stream``
must chain shard cursors as JAX's does.  The shard lifecycle is held to
JAX's in ``test_torch_forest_lifecycle.py``."""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as J  # noqa: E402  (enables jax x64 before any JAX input is built)
from repro.obs.witness import check_history  # noqa: E402

import repro_torch.core as T  # noqa: E402
from repro_torch.interop import state_from_numpy, state_to_numpy  # noqa: E402
from test_torch_rounds import CAP, CFG, KEY_RANGE, _scan_np, _schedule  # noqa: E402

ROUNDS = 9  # grow, churn and the start of the drain
HANDOFF = 4  # round after which a JAX-grown forest is carried into the port
CASES = [(s, m) for s in (1, 2, 4) for m in ("elim", "occ")]


def _jarrays(forest):
    st = forest.state
    d = {k: np.asarray(v) for k, v in st._asdict().items() if k != "stats"}
    d["stats"] = {k: np.asarray(v) for k, v in st.stats._asdict().items()}
    return d


def _pool_diff(jf, tf):
    """Names of stacked pool arrays that differ outside each shard's
    scratch row (or in shape, the per-shard scalars or the stats)."""
    want, got = _jarrays(jf), state_to_numpy(tf.state)
    bad = [f"stats.{k}" for k, v in want.pop("stats").items()
           if not np.array_equal(got["stats"][k], v)]
    for name, w in want.items():
        g = got[name]
        if g.shape != w.shape:
            bad.append(f"{name} shape")
        elif not np.array_equal(g[:, :-1] if w.ndim > 1 else g, w[:, :-1] if w.ndim > 1 else w):
            bad.append(name)
    return bad


def _out(o, port):
    if port:
        return o.results.numpy(), o.found.numpy(), _scan_np(o.scan)
    return np.asarray(o.results), np.asarray(o.found), _scan_np(o.scan)


def _eq_out(a, b):
    if not (np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])):
        return False
    if a[2] is None or b[2] is None:
        return a[2] is None and b[2] is None
    return all(np.array_equal(x, y) for x, y in zip(a[2], b[2]))


def _forests(n_shards, mode, **kw):
    jf = J.ABForest(n_shards, J.TreeConfig(**CFG), mode=mode, key_space=(0, KEY_RANGE), **kw)
    tf = T.ABForest(n_shards, T.TreeConfig(**CFG), mode=mode, key_space=(0, KEY_RANGE),
                    device="cpu", **kw)
    return jf, tf


@pytest.fixture(scope="module", params=CASES, ids=lambda c: f"S{c[0]}-{c[1]}")
def run(request):
    n_shards, mode = request.param
    jf, tf = _forests(n_shards, mode)
    to = T.DictOracle()
    out = dict(rounds=[], pools=[], dirty=[], splits=[], stats=[], invariants=[], handoff=[])
    handed = None
    for r, (ops, keys, vals) in enumerate(_schedule()[:ROUNDS]):
        a = _out(jf.apply_round(ops, keys, vals, scan_cap=CAP), False)
        b = _out(tf.apply_round(ops, keys, vals, scan_cap=CAP), True)
        want = to.apply_mixed_round(ops, keys, vals, cap=CAP)
        out["rounds"].append((a, b, want))
        out["pools"].append(_pool_diff(jf, tf))
        out["splits"].append((jf.splits, tf.splits))
        out["stats"].append((jf.stats(), tf.stats(), jf.stats_per_shard(), tf.stats_per_shard()))
        try:
            T.check_forest_invariants(tf)
        except AssertionError as e:
            out["invariants"].append((r, str(e)))
        if handed is not None:
            c = _out(handed.apply_round(ops, keys, vals, scan_cap=CAP), True)
            out["handoff"].append((a, c, _pool_diff(jf, handed)))
        out["dirty"].append((jf.take_dirty(), tf.take_dirty()))
        if handed is not None:
            out["handoff"][-1] += (out["dirty"][-1][0], handed.take_dirty())
        if r == HANDOFF:
            handed = T.ABForest(n_shards, T.TreeConfig(*jf.cfg), mode=mode, splits=jf.splits,
                                device="cpu")
            handed.state = state_from_numpy(_jarrays(jf))
            handed._scan_frontier = jf._scan_frontier
    out.update(jf=jf, tf=tf, to=to, n_shards=n_shards, mode=mode)
    return out


def test_forest_results_and_scan_rows_equal_every_round(run):
    for r, (a, b, _) in enumerate(run["rounds"]):
        assert _eq_out(a, b), f"round {r}"


def test_forest_results_equal_the_oracle(run):
    for r, (_, b, want) in enumerate(run["rounds"]):
        assert np.array_equal(b[0], np.asarray(want[0], np.int64)), f"round {r}"
        assert np.array_equal(b[1], np.asarray(want[1], bool)), f"round {r}"


def test_forest_pools_equal_except_scratch_every_round(run):
    for r, diff in enumerate(run["pools"]):
        assert diff == [], f"round {r}: {diff}"


def test_forest_splits_stats_and_dirty_equal_every_round(run):
    for r, ((js, ts), st, dirty) in enumerate(zip(run["splits"], run["stats"], run["dirty"])):
        assert np.array_equal(js, ts), f"round {r} splits"
        assert st[1] == st[0] and st[3] == st[2], f"round {r} stats"
        assert len(dirty[1]) == len(dirty[0]) == run["n_shards"]
        assert all(np.array_equal(x, y) for x, y in zip(*dirty)), f"round {r} dirty"


def test_forest_items_invariants_and_history(run):
    jf, tf = run["jf"], run["tf"]
    assert run["invariants"] == []
    assert tf.items() == jf.items() == run["to"].items()
    records = [json.loads(x) for x in tf.recorder.dump_records()]
    assert records == [json.loads(x) for x in jf.recorder.dump_records()]
    assert check_history(records).state == run["to"].items()
    n = run["n_shards"]
    for name in ("scan_sublanes", "point_lanes", "occ_subrounds", "split_waves"):
        assert tf.metrics.per_shard(name, n) == jf.metrics.per_shard(name, n), name
        assert tf.metrics.value(name) == jf.metrics.value(name), name
    assert sum(x > 0 for x in tf.metrics.per_shard("scan_sublanes", n)) == n  # every shard scanned


def test_forest_carried_from_jax_runs_on_in_the_port(run):
    assert len(run["handoff"]) == ROUNDS - HANDOFF - 1
    for r, (a, c, diff, jdirty, cdirty) in enumerate(run["handoff"]):
        assert _eq_out(a, c), f"handoff round {r}"
        assert diff == [], f"handoff round {r}: {diff}"
        assert all(np.array_equal(x, y) for x, y in zip(jdirty, cdirty)), f"handoff round {r}"


@pytest.mark.parametrize("lo,hi,cap", [(0, KEY_RANGE, 7), (140, 460, 16), (0, 1 << 62, 64)])
def test_forest_scan_stream_chains_shard_cursors(run, lo, hi, cap):
    jf, tf = run["jf"], run["tf"]
    j0, t0 = jf._rounds, tf._rounds
    got = list(tf.scan_stream(lo, hi, cap=cap))
    assert got == list(jf.scan_stream(lo, hi, cap=cap)) == run["to"].range(lo, hi)
    assert tf._rounds - t0 == jf._rounds - j0


def test_one_shard_forest_equals_the_tree():
    """S = 1: the forest runs the tree's engine on the same stack, so its
    results, pool and stats are the port's ``ABTree``'s."""
    tf = T.ABForest(1, T.TreeConfig(**CFG), device="cpu")
    tt = T.ABTree(T.TreeConfig(**CFG), device="cpu")
    for r, (ops, keys, vals) in enumerate(_schedule()[:8]):
        a = _out(tf.apply_round(ops, keys, vals, scan_cap=CAP), True)
        b = _out(tt.apply_round(ops, keys, vals, scan_cap=CAP), True)
        assert _eq_out(a, b), f"round {r}"
        got, want = state_to_numpy(tf.state), state_to_numpy(tt.stacked)
        for name, w in want.items():
            if name == "stats":
                assert all(np.array_equal(got["stats"][k], v) for k, v in w.items())
            else:
                assert np.array_equal(got[name], w), f"round {r}: {name}"
    assert tf.stats() == tt.stats() and tf.items() == tt.items()
    assert tf.splits.size == 0  # the default key space, one shard: no split point


def test_forest_argument_checks():
    with pytest.raises(ValueError, match="split points"):
        T.ABForest(3, T.TreeConfig(**CFG), splits=[5], device="cpu")
    with pytest.raises(ValueError, match="ascending"):
        T.ABForest(3, T.TreeConfig(**CFG), splits=[9, 5], device="cpu")
    with pytest.raises(ValueError, match="too small"):
        T.ABForest(4, T.TreeConfig(**CFG), key_space=(0, 3), device="cpu")
    with pytest.raises(ValueError, match="unknown mode"):
        T.ABForest(2, T.TreeConfig(**CFG), mode="fast", device="cpu")
