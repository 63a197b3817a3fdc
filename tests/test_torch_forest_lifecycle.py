"""The port's ``ABForest`` shard lifecycle against the JAX package's.

Three scenarios, driven as ``tests/test_repartition.py`` drives them, go
through both packages' forests on the CPU: an overflow split
(``max_keys_per_shard``, a load-quantile split point), a boundary rebalance
and a cold-shard merge (``auto_repartition``), each followed by live mixed
traffic.  The port must take JAX's actions, with the same
``split_hook`` / ``repartition_hook`` / ``hot_shard_hook`` calls and the
same lifecycle counters, give the same per-round outputs, end with the same
pools, contents, stats and flight-recorder history, and hold
``check_forest_invariants`` after every round."""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as J  # noqa: E402  (enables jax x64 before any JAX input is built)
from repro.obs.witness import check_history  # noqa: E402

import repro_torch.core as T  # noqa: E402
from repro_torch.obs.tracer import Tracer  # noqa: E402
from test_torch_forest import _eq_out, _out, _pool_diff  # noqa: E402

LIFE_CFG = dict(capacity=512, b=8, a=2, max_height=12)


def _life(pkg, kind):
    """One lifecycle scenario (as ``tests/test_repartition.py`` drives it)
    through ``pkg``'s forest; returns the forest, its hook calls and the
    per-round outputs."""
    calls = []
    if kind == "split":
        kw = dict(n_shards=2, key_space=(0, 400), max_keys_per_shard=130,
                  hot_shard_window=1 << 30)
    elif kind == "rebalance":
        kw = dict(n_shards=2, key_space=(0, 400), auto_repartition=True, hot_shard_window=64)
    else:
        kw = dict(n_shards=4, key_space=(0, 400), auto_repartition=True, hot_shard_window=64,
                  cold_shard_frac=0.05)
    if pkg is T:
        kw["device"] = "cpu"
    f = pkg.ABForest(cfg=pkg.TreeConfig(**LIFE_CFG), **kw)
    if pkg is T:
        f.tracer = Tracer()
    f.split_hook = lambda s: calls.append(("split", s, f.n_shards, f.splits.tolist()))
    f.repartition_hook = lambda k, a, b: calls.append((k, a, b, f.n_shards, f.splits.tolist()))
    f.hot_shard_hook = lambda s, info: calls.append(("hot", s, round(info["frac"], 6)))
    rng = np.random.default_rng({"split": 47, "rebalance": 41, "merge": 43}[kind])
    outs, invariants = [], []

    def step(ops, keys, vals=None):
        o = f.apply_round(ops, keys, vals)
        outs.append(_out(o, pkg is T))
        if pkg is T:
            try:
                T.check_forest_invariants(f)
            except AssertionError as e:
                invariants.append(str(e))

    def seed(keys):
        keys = list(keys)
        step([T.OP_INSERT] * len(keys), keys, [k * 3 for k in keys])

    if kind == "split":
        seed(range(0, 400, 4))
        for _ in range(6):
            step([T.OP_FIND] * 64, rng.integers(0, 64, 64).tolist())
        seed(range(1, 200, 2))
    elif kind == "rebalance":
        seed(range(0, 400, 2))
        for _ in range(6):
            k = np.concatenate([rng.integers(0, 100, 38), rng.integers(200, 400, 10)])
            step([T.OP_FIND] * 48, k.tolist())
    else:
        seed(range(0, 400, 2))
        for _ in range(8):
            k = np.concatenate([rng.integers(0, 100, 30), rng.integers(100, 200, 18)])
            step([T.OP_FIND] * 48, k.tolist())
    for _ in range(2):  # live mixed traffic after the restack
        ops = rng.choice([T.OP_FIND, T.OP_INSERT, T.OP_DELETE, T.OP_RANGE], 32).astype(np.int32)
        vals = np.where(ops == T.OP_RANGE, rng.integers(0, 60, 32), rng.integers(0, 1000, 32))
        step(ops, rng.integers(0, 400, 32), vals)
    return f, calls, outs, invariants


@pytest.fixture(scope="module", params=["split", "rebalance", "merge"])
def life(request):
    return request.param, _life(J, request.param), _life(T, request.param)


def test_lifecycle_takes_the_actions_of_jax(life):
    kind, (jf, jcalls, _, _), (tf, tcalls, _, _) = life
    assert tcalls == jcalls
    assert {"split": "split", "rebalance": "rebalance", "merge": "merge"}[kind] in [
        c[0] for c in tcalls]
    assert tf.n_shards == jf.n_shards and np.array_equal(tf.splits, jf.splits)
    counters = ("shard_splits", "repartitions", "boundary_moves", "shard_merges",
                "hot_shard_events")
    for name in counters:
        assert tf.metrics.value(name) == jf.metrics.value(name), name
        assert (tf.metrics.per_shard(name, tf.n_shards)
                == jf.metrics.per_shard(name, jf.n_shards)), name


def test_lifecycle_rounds_pools_and_history_equal_jax(life):
    _, (jf, _, jouts, _), (tf, _, touts, invariants) = life
    assert len(touts) == len(jouts)
    for r, (a, b) in enumerate(zip(jouts, touts)):
        assert _eq_out(a, b), f"round {r}"
    assert invariants == []
    assert _pool_diff(jf, tf) == []
    assert tf.items() == jf.items()
    assert tf.stats() == jf.stats() and tf.stats_per_shard() == jf.stats_per_shard()
    records = [json.loads(x) for x in tf.recorder.dump_records()]
    assert records == [json.loads(x) for x in jf.recorder.dump_records()]
    check_history(records)


def test_lifecycle_spans_note_each_move(life):
    """The port's tracer spans of the lifecycle: one ``shard_sweep`` and one
    ``shard_reinsert`` a move, moving the same keys, and one ``repartition``
    span an action the repartitioner consumed."""
    kind, _, (tf, _, _, _) = life
    ev = {n: [e["args"] for e in tf.tracer.events if e["name"] == n]
          for n in ("repartition", "shard_sweep", "shard_reinsert")}
    moves = sum(tf.metrics.value(n) for n in ("shard_splits", "boundary_moves", "shard_merges"))
    assert len(ev["shard_sweep"]) == len(ev["shard_reinsert"]) == moves >= 1
    assert [a["keys"] for a in ev["shard_sweep"]] == [a["keys"] for a in ev["shard_reinsert"]]
    assert all(a["rounds"] >= 1 and a["lo"] < a["hi"] for a in ev["shard_sweep"])
    assert sum(a["retry_passes"] for a in ev["shard_reinsert"]) <= tf.metrics.value("retry_passes")
    acted = [a for a in ev["repartition"] if a["action"] != "noop"]
    assert len(acted) == tf.metrics.value("repartitions")
    assert (len(acted) > 0) == (kind != "split")
    if acted:
        assert acted[-1]["n_shards"] == tf.n_shards
