"""The port's ``data/workloads.py`` helpers against the JAX package's on the
CPU: ``split_scan_round`` and ``prefill_tree``, which every tree leg of the
benchmark imports.

* ``split_scan_round`` on YCSB-E rounds: the same four arrays as JAX's, bit
  for bit and dtype for dtype; and ``tests/test_range_scan.py``'s
  fused-against-split check (``test_ycsb_e_stream_split_baseline``) on the
  port's ``ABTree``.
* ``prefill_tree``: a holder that records its ``apply_round`` calls gets
  the same calls from both packages (one round, several, a short last
  one; other fractions and seeds); on ``ABTree`` in elim and occ mode,
  ``ABForest(n_shards=4)`` and a ``DurableForest`` (its ``forest``
  prefilled and then journaled with a forced snapshot, as JAX's
  persistence leg does), ``items()``, ``stats()`` and every pool array are
  bit-equal to JAX's after the prefill, and the durable journals hold the
  same files and arrays (``test_torch_durable.assert_same_journal``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as J  # noqa: E402  (enables jax x64 before any JAX input is built)
from repro.data import workloads as jw  # noqa: E402

import repro_torch.core as T  # noqa: E402
from repro_torch.data import workloads as tw  # noqa: E402
from test_torch_durable import assert_same_journal, assert_same_state, assert_same_stats  # noqa: E402
from test_torch_forest import _pool_diff as forest_pool_diff  # noqa: E402
from test_torch_rounds import CFG, KEY_RANGE, _pool_diff  # noqa: E402

SPLIT_CAP = 32


def _ycsb_e(seed=2):
    wl = tw.WorkloadConfig(key_range=1000, dist="zipf", batch=128, seed=seed)
    return next(iter(tw.ycsb_e_stream(wl, 1, scan_frac=0.9, max_span=16)))


@pytest.mark.parametrize("seed", [2, 5])
def test_split_scan_round_equals_jax(seed):
    ops, keys, vals = _ycsb_e(seed)
    jops, jkeys, jvals = next(iter(jw.ycsb_e_stream(
        jw.WorkloadConfig(key_range=1000, dist="zipf", batch=128, seed=seed), 1,
        scan_frac=0.9, max_span=16)))
    assert all(np.array_equal(a, b) for a, b in ((ops, jops), (keys, jkeys), (vals, jvals)))
    (lo, hi), point = tw.split_scan_round(ops, keys, vals)
    (jlo, jhi), jpoint = jw.split_scan_round(ops, keys, vals)
    for got, want in zip((lo, hi, *point), (jlo, jhi, *jpoint)):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    assert 0 < lo.size < ops.size and np.all(hi > lo) and np.all(hi - lo <= 16)
    assert not np.any(point[0] == T.OP_RANGE) and point[0].shape == ops.shape


def test_split_baseline_agrees_with_the_fused_round():
    """``test_range_scan.py``'s check on the port: the split path's two
    rounds (a ``scan_round``, then the point ops) leave what the fused
    round leaves and scan what it scans."""
    ops, keys, vals = _ycsb_e()
    (lo, hi), (pops, pkeys, pvals) = tw.split_scan_round(ops, keys, vals)
    prefill = list(range(0, 1000, 3))
    cfg = T.TreeConfig(**CFG)
    t, tf = T.ABTree(cfg, device="cpu"), T.ABTree(cfg, device="cpu")
    for tree in (t, tf):
        tree.apply_round([T.OP_INSERT] * len(prefill), prefill, prefill)
    split_scan = t.scan_round(lo, hi, cap=SPLIT_CAP)
    t.apply_round(pops, pkeys, pvals)
    assert t.stats()["rounds"] == 2  # scan_round is not a combining round
    out = tf.apply_round(ops, keys, vals, scan_cap=SPLIT_CAP)
    assert tf.stats()["rounds"] == 2
    assert tf.items() == t.items()
    scan_rows = out.scan.keys.numpy()[np.asarray(ops) == T.OP_RANGE]
    np.testing.assert_array_equal(scan_rows, split_scan.keys.numpy())


class _Calls:
    """A holder that records its ``apply_round`` calls."""

    def __init__(self):
        self.calls = []

    def apply_round(self, ops, keys, vals):
        self.calls.append((ops, keys, vals))


@pytest.mark.parametrize("key_range,frac,seed", [(600, 0.5, 0), (2_048, 0.5, 0), (5_000, 0.5, 3),
                                                 (20_000, 0.5, 0), (3_000, 0.9, 1)])
def test_prefill_tree_issues_jax_rounds(key_range, frac, seed):
    """The same rounds as JAX's: widths of 1,024 lanes with a short last one,
    inserts of distinct keys whose values are the keys."""
    want, got = _Calls(), _Calls()
    jw.prefill_tree(want, jw.WorkloadConfig(key_range=key_range, seed=seed), frac)
    assert tw.prefill_tree(got, tw.WorkloadConfig(key_range=key_range, seed=seed), frac) is got
    assert len(got.calls) == len(want.calls) == -(-int(key_range * frac) // 1024)
    for g, w in zip(got.calls, want.calls):
        for a, b in zip(g, w):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    keys = np.concatenate([c[1] for c in got.calls])
    assert keys.size == np.unique(keys).size == int(key_range * frac)


def _holders(kind, tmp_path):
    jc, tc = J.TreeConfig(**CFG), T.TreeConfig(**CFG)
    space = (0, KEY_RANGE)
    if kind in ("elim", "occ"):
        return J.ABTree(jc, mode=kind), T.ABTree(tc, mode=kind, device="cpu")
    if kind == "forest":
        return (J.ABForest(4, jc, key_space=space),
                T.ABForest(4, tc, key_space=space, device="cpu"))
    return (J.DurableForest(str(tmp_path / "jax"), 4, jc, key_space=space),
            T.DurableForest(str(tmp_path / "port"), 4, tc, key_space=space, device="cpu"))


@pytest.mark.parametrize("kind", ["elim", "occ", "forest", "durable"])
def test_prefill_tree_state_equals_jax(kind, tmp_path):
    """``prefill_tree`` at ``WorkloadConfig(key_range=600)`` (300 keys) into
    each holder: items, stats and pools bit-equal to JAX's."""
    jh, th = _holders(kind, tmp_path)
    wl_j, wl_t = jw.WorkloadConfig(key_range=KEY_RANGE), tw.WorkloadConfig(key_range=KEY_RANGE)
    if kind == "durable":
        jw.prefill_tree(jh.forest, wl_j)
        tw.prefill_tree(th.forest, wl_t)
        jh._commit(force_snapshot=True)
        th._commit(force_snapshot=True)
        assert_same_state(jh, th)
        assert_same_stats(jh, th)
        assert jh.items() == th.items()
        jh.close()
        th.close()
        assert_same_journal(str(tmp_path / "jax"), str(tmp_path / "port"))
        return
    jw.prefill_tree(jh, wl_j)
    tw.prefill_tree(th, wl_t)
    assert th.stats() == jh.stats() and th.stats()["rounds"] == 1
    assert th.items() == jh.items() and len(th.items()) == KEY_RANGE // 2
    assert (forest_pool_diff if kind == "forest" else _pool_diff)(jh, th) == []
