"""The port's durable trees against the JAX package's on the CPU.

The same seeded rounds go through ``repro.core.DurableABTree`` /
``DurableForest`` and ``repro_torch.core``'s (``device="cpu"``), each into a
directory of its own.  After every round the two journals must hold the same
files: every npz array equal (``node_ids``, ``root``, ``height`` and each
persisted field, dtype included), the audit sidecars byte-equal, and the
manifests equal field by field except two that depend on bytes the
packages cannot share: ``np.savez`` stamps each zip member with the
wall-clock time it was written, so an npz file's CRC differs between two
writes of the same arrays a second apart, and with it the values of
``file_crcs`` (their keys are compared, and each package's CRCs must match
its own files) and the manifest ``checksum`` (each must verify).  The
``DurableStats`` must be equal too.  Covered: elim and occ; a tree and
forests of S = 1, 2 and 4; a shard split and a boundary rebalance; group
commit 1 and 4 (async); deltas and forced full snapshots; a pool growth.

Crash points fire at the same protocol step in both packages, and each
recovers in its own package to equal items and bit-equal state; a directory
written by either package recovers in the other to JAX's own recovery, and
two more rounds on each recovered pair write equal journals again.  The
port's recovered forensics sidecar passes the JAX package's witness.
Faults are held to JAX's in ``test_torch_faults.py``."""
import json
import os
import shutil
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as J  # noqa: E402  (enables jax x64 before any JAX input is built)
from repro.core.oracle import tree_contents as j_contents  # noqa: E402
from repro.obs.witness import check_history  # noqa: E402

import repro_torch.core as T  # noqa: E402
from repro_torch.interop import state_to_numpy  # noqa: E402

CFG = dict(capacity=512, b=8, a=2, max_height=12)
# manifest fields that depend on the npz files' bytes (see the docstring)
BYTE_DEPENDENT = ("file_crcs", "checksum")


def _mk_rounds(n_rounds=6, bsz=32, seed=0):
    """``tests/test_durable.py``'s schedule: insert/delete over 64 keys."""
    rng = np.random.default_rng(seed)
    rounds = []
    for _ in range(n_rounds):
        ops = rng.choice([J.OP_INSERT, J.OP_DELETE], bsz).tolist()
        keys = rng.integers(0, 64, bsz).tolist()
        vals = rng.integers(0, 1000, bsz).tolist()
        rounds.append((ops, keys, vals))
    return rounds


def _growth_rounds(n_rounds=5, bsz=96, seed=3):
    """Distinct inserts over a wide range: the pool of 512 rows grows."""
    rng = np.random.default_rng(seed)
    keys = rng.choice(10_000, n_rounds * bsz, replace=False)
    return [([J.OP_INSERT] * bsz, keys[i * bsz:(i + 1) * bsz].tolist(),
             rng.integers(0, 1000, bsz).tolist()) for i in range(n_rounds)]


def _split_rounds():
    """``tests/test_durable.py``'s mid-split schedule: 120 distinct inserts
    into a two-shard forest capped at 40 keys a shard."""
    rng = np.random.default_rng(23)
    ks = rng.choice(4096, size=120, replace=False).astype(np.int64)
    return [([J.OP_INSERT] * 24, ks[i:i + 24].tolist(), (ks[i:i + 24] * 3).tolist())
            for i in range(0, 120, 24)]


def _skewed_write_rounds(n_rounds=8, seed=31):
    """``tests/test_durable.py``'s rebalance schedule: 80/20 hot-prefix
    inserts on a (0, 400) two-shard key space."""
    rng = np.random.default_rng(seed)
    rounds = []
    for _ in range(n_rounds):
        keys = np.concatenate([rng.integers(0, 100, 38), rng.integers(200, 400, 10)])
        rounds.append(([J.OP_INSERT] * 48, keys.tolist(), rng.integers(0, 1000, 48).tolist()))
    return rounds


# -- building both packages' durable holders ---------------------------------


def make(pkg, d, kind="tree", **kw):
    cfg = pkg.TreeConfig(**CFG)
    hot_window = kw.pop("hot_shard_window", None)
    if pkg is T:
        kw["device"] = "cpu"
    if kind == "tree":
        return pkg.DurableABTree(d, cfg, **kw)
    out = pkg.DurableForest(d, cfg=cfg, **kw)
    if hot_window is not None:
        out.forest.hot_shard_window = hot_window
    return out


def contents(pkg, h):
    if isinstance(h, (J.DurableForest, T.DurableForest)):
        return h.items()
    if pkg is J:
        return j_contents(h.tree.state, h.tree.cfg)
    return h.tree.items()


# -- comparing journals -------------------------------------------------------


def _crc(path):
    with open(path, "rb") as f:
        return zlib.crc32(f.read()) & 0xFFFFFFFF


def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _listing(d):
    out = set()
    for root, _, files in os.walk(d):
        out |= {os.path.relpath(os.path.join(root, f), d) for f in files}
    return out


def _sidecar_by_kind(path):
    """A forensics sidecar as its header and one list a record kind,
    ``seq`` dropped (see ``assert_same_journal``)."""
    lines = [json.loads(x) for x in open(path).read().splitlines() if x]
    out = {"header": lines[0]}
    for rec in lines[1:]:
        rec.pop("seq")
        out.setdefault(rec["kind"], []).append(rec)
    return out


def assert_same_journal(dj, dt, *, torn_ok=(), async_rounds=False):
    """The two directories hold the same journal (see the module
    docstring for what is compared).  With ``async_rounds`` (rounds ran
    while a commit was in flight) the sidecars are compared a record kind
    at a time: the commit thread pushes its markers into the recorder's
    ring while later rounds run, so where they fall among the round
    records depends on thread timing, in either package."""
    names = _listing(dj)
    assert names == _listing(dt), sorted(names ^ _listing(dt))
    for name in sorted(names):
        pj, pt = os.path.join(dj, name), os.path.join(dt, name)
        base = os.path.basename(name)
        if base.startswith("MANIFEST") and not base.endswith(".tmp"):
            mj, mt = (json.load(open(p)) for p in (pj, pt))
            assert {k: v for k, v in mj.items() if k not in BYTE_DEPENDENT} == \
                {k: v for k, v in mt.items() if k not in BYTE_DEPENDENT}, name
            assert sorted(mj["file_crcs"]) == sorted(mt["file_crcs"]), name
            for d, m in ((dj, mj), (dt, mt)):
                body = {k: v for k, v in m.items() if k != "checksum"}
                assert zlib.crc32(json.dumps(body, sort_keys=True).encode()) & 0xFFFFFFFF \
                    == m["checksum"], (d, name)
                if base == "MANIFEST":
                    for fname, crc in m["file_crcs"].items():
                        if fname not in torn_ok and os.path.exists(os.path.join(d, fname)):
                            assert _crc(os.path.join(d, fname)) == crc, (d, fname)
        elif base.endswith(".npz") and base not in torn_ok:
            zj, zt = _npz(pj), _npz(pt)
            assert list(zj) == list(zt), name
            for k in zj:
                assert zj[k].dtype == zt[k].dtype and np.array_equal(zj[k], zt[k]), (name, k)
        elif base.endswith(".jsonl") and async_rounds:
            assert _sidecar_by_kind(pj) == _sidecar_by_kind(pt), name
        elif base.endswith(".jsonl"):
            assert open(pj, "rb").read() == open(pt, "rb").read(), name


def assert_same_state(jh, th):
    """Bit-equal stacked states (every field, the scratch row included)."""
    if isinstance(jh, J.DurableForest):
        jst = jh.forest.state
        tst = th.forest.state
        want = {k: np.asarray(v) for k, v in jst._asdict().items() if k != "stats"}
        wstats = {k: np.asarray(v) for k, v in jst.stats._asdict().items()}
    else:
        jst = jh.tree.state
        tst = th.tree.stacked
        want = {k: np.asarray(v)[None] for k, v in jst._asdict().items() if k != "stats"}
        wstats = {k: np.asarray(v).reshape(1) for k, v in jst.stats._asdict().items()}
    got = state_to_numpy(tst)
    for k, w in want.items():
        g = got[k]
        assert g.dtype == w.dtype and np.array_equal(g, w), k
    for k, w in wstats.items():
        assert np.array_equal(got["stats"][k], w), f"stats.{k}"


def assert_same_stats(jh, th):
    assert jh.stats() == th.stats()
    assert vars(jh.dstats) == vars(th.dstats)


# -- the cases ----------------------------------------------------------------

# name: (holder kind, constructor knobs, rounds)
CASES = {
    "tree-elim-deltas": ("tree", dict(snapshot_every=2, full_snapshot_every=2), _mk_rounds(8)),
    "tree-occ": ("tree", dict(mode="occ", snapshot_every=3), _mk_rounds(5, seed=1)),
    "tree-group4-async": ("tree", dict(snapshot_every=3, group_commit_every=4,
                                       group_commit_max_wait_s=1e9, commit_async=True),
                          _mk_rounds(9, seed=2)),
    "tree-growth": ("tree", dict(snapshot_every=3), _growth_rounds()),
    "forest-S1": ("forest", dict(n_shards=1, key_space=(0, 64), snapshot_every=3),
                  _mk_rounds(5, seed=4)),
    "forest-S2-occ": ("forest", dict(n_shards=2, mode="occ", key_space=(0, 64),
                                     snapshot_every=2), _mk_rounds(5, seed=5)),
    "forest-S4-group4": ("forest", dict(n_shards=4, key_space=(0, 64), snapshot_every=3,
                                        group_commit_every=4, group_commit_max_wait_s=1e9),
                         _mk_rounds(9, seed=6)),
    "forest-split": ("forest", dict(n_shards=2, key_space=(0, 4096), max_keys_per_shard=40,
                                    snapshot_every=10**9), _split_rounds()),
    "forest-rebalance": ("forest", dict(n_shards=2, key_space=(0, 400), auto_repartition=True,
                                        hot_shard_window=64, snapshot_every=10**9),
                         _skewed_write_rounds()),
}


_RUNS = {}


def run_case(name, tmp_path_factory):
    """One case through both packages, the journals compared after every
    round (run once a process); returns the two directories, the final
    holders and the oracle prefixes."""
    if name in _RUNS:
        return _RUNS[name]
    kind, kw, rounds = CASES[name]
    base = tmp_path_factory.mktemp(name)
    dj, dt = str(base / "jax"), str(base / "port")
    jh, th = make(J, dj, kind, **dict(kw)), make(T, dt, kind, **dict(kw))
    jh._join_commit(), th._join_commit()  # the directories as the last boundary wrote them
    assert_same_journal(dj, dt)
    o = T.DictOracle()
    prefixes = [o.items()]
    for ops, keys, vals in rounds:
        jh.apply_round(ops, keys, vals)
        th.apply_round(ops, keys, vals)
        o.apply_round(ops, keys, vals)
        prefixes.append(o.items())
        jh._join_commit(), th._join_commit()
        assert_same_journal(dj, dt)
        assert_same_stats(jh, th)
    jh.drain(), th.drain()
    assert_same_journal(dj, dt)
    assert_same_stats(jh, th)
    assert contents(T, th) == contents(J, jh) == prefixes[-1]
    _RUNS[name] = (name, dj, dt, jh, th, prefixes)
    return _RUNS[name]


@pytest.mark.parametrize("name", list(CASES))
def test_journals_equal_jax(name, tmp_path_factory):
    """Every commit wrote the same files in both packages (checked round by
    round in the fixture), and each case reached what it is there for."""
    name, dj, dt, jh, th, _ = run_case(name, tmp_path_factory)
    m = th.metrics
    files = os.listdir(dt)
    if "deltas" in name:
        assert m.value("delta_snapshots") >= 2 and m.value("full_snapshots") >= 2
    if "growth" in name:
        assert th.tree.cfg.capacity > CFG["capacity"] and m.value("full_snapshots") >= 2
    if "group4" in name:
        assert th.metrics.histogram_summary("rounds_per_commit")["max"] == 4.0
        assert th.durability_status()["group_commit_every"] == 4
    if "occ" in name:
        assert th.stats()["subrounds"] > len(CASES[name][2])
        assert th.dstats.commits > len(CASES[name][2]) + 1
    if "split" in name:
        assert th.n_shards > 2
    if "rebalance" in name:
        assert th.forest.splits.tolist() != [200]
    if name.startswith("forest"):
        assert th.forest.splits.tolist() == jh.forest.splits.tolist()
    assert any(f.endswith(".npz") for f in files)


def _recover(pkg, d, **kw):
    if pkg is T:
        kw["device"] = "cpu"
    return pkg.recover(d, **kw)


# the cases whose journals are recovered across packages: the tree through
# deltas and through a pool growth, occ on two shards, and a rebalanced
# forest (each recovery of a new shape compiles JAX's rounds anew)
CROSS = ["tree-elim-deltas", "tree-growth", "forest-S2-occ", "forest-rebalance"]


@pytest.mark.parametrize("name", CROSS)
def test_recovery_crosses_packages(name, tmp_path_factory, tmp_path):
    """A JAX directory recovered by the port equals JAX's own recovery, and
    a port directory recovered by JAX equals the port's own: state arrays
    bit-equal, items, split points and knobs.  Then two more rounds on
    each recovered pair write equal journals."""
    name, dj, dt, jh, th, prefixes = run_case(name, tmp_path_factory)
    knobs = dict(group_commit_every=2, group_commit_max_wait_s=1e9)
    more = _mk_rounds(2, seed=99)
    for src in (dj, dt):
        a, b = str(tmp_path / f"{os.path.basename(src)}-j"), str(tmp_path / f"{os.path.basename(src)}-t")
        shutil.copytree(src, a)
        shutil.copytree(src, b)
        rj, rt = _recover(J, a, **knobs), _recover(T, b, **knobs)
        assert type(rt).__name__ == type(rj).__name__
        assert_same_state(rj, rt)
        assert contents(T, rt) == contents(J, rj) == prefixes[-1]
        assert (rt.snapshot_every, rt.group_commit_every, rt._commit_idx) == \
            (rj.snapshot_every, rj.group_commit_every, rj._commit_idx)
        if isinstance(rj, J.DurableForest):
            assert rt.forest.splits.tolist() == rj.forest.splits.tolist()
            assert rt.forest.auto_repartition == rj.forest.auto_repartition
        for ops, keys, vals in more:
            rj.apply_round(ops, keys, vals)
            rt.apply_round(ops, keys, vals)
        rj.drain(), rt.drain()
        assert_same_journal(a, b)
        assert_same_state(rj, rt)
        rt.close()


STEPS = ["after_segment", "mid_manifest", "before_dirsync", "mid_group"]


def _crash_run(pkg, d, kind, kw, rounds, crash):
    h = make(pkg, d, kind, crash=crash, **dict(kw))
    o = T.DictOracle()
    prefixes = [o.items()]
    for i, (ops, keys, vals) in enumerate(rounds):
        try:
            h.apply_round(ops, keys, vals)
        except J.SimulatedCrash if pkg is J else T.SimulatedCrash:
            return i, prefixes
        o.apply_round(ops, keys, vals)
        prefixes.append(o.items())
    raise AssertionError(f"{crash} did not fire")


CRASHES = (
    [(s, "tree", dict(snapshot_every=100) if s != "mid_group" else
      dict(snapshot_every=100, group_commit_every=3, group_commit_max_wait_s=1e9),
      _mk_rounds(8, seed=2), 2) for s in STEPS]
    + [("mid_split", "forest", CASES["forest-split"][1], _split_rounds(), None),
       ("mid_repartition", "forest", CASES["forest-rebalance"][1], _skewed_write_rounds(), None)]
)


def _first_structural_round(kind, kw, rounds, tmp):
    """The round whose split / rebalance fires first (a dry run): during
    round r the commit counter stands at r + 1."""
    h = make(T, tmp, kind, **dict(kw))
    for i, (ops, keys, vals) in enumerate(rounds):
        h.apply_round(ops, keys, vals)
        m = h.metrics
        if m.value("shard_splits") or m.value("repartitions"):
            return i + 1
    raise AssertionError("the schedule made no structural change")


@pytest.mark.parametrize("case", CRASHES, ids=[c[0] for c in CRASHES])
def test_crashes_equal_jax(case, tmp_path):
    """A crash point fires at the same round and step in both packages;
    the directories left behind hold the same journal; each package
    recovers its own to equal items and bit-equal state, on a committed
    prefix; the port's sidecar passes the JAX witness and replays to the
    recovered items."""
    step, kind, kw, rounds, at = case
    if at is None:
        at = _first_structural_round(kind, kw, rounds, str(tmp_path / "dry"))
    dj, dt = str(tmp_path / "jax"), str(tmp_path / "port")
    ij, pj = _crash_run(J, dj, kind, kw, rounds, J.CrashPoint(step=step, at_commit=at))
    it, pt = _crash_run(T, dt, kind, kw, rounds, T.CrashPoint(step=step, at_commit=at))
    assert ij == it and pj == pt
    assert_same_journal(dj, dt)
    rj, rt = _recover(J, dj), _recover(T, dt)
    assert_same_state(rj, rt)
    got = contents(T, rt)
    assert got == contents(J, rj)
    if step == "before_dirsync":
        o = T.DictOracle()
        o.d = dict(pt[-1])
        o.apply_round(*rounds[it])
        assert got in (pt[-1], o.items())
    elif step == "mid_group":
        assert got == pt[(it // 3) * 3]  # the last complete group boundary
    else:
        assert got == pt[-1]
    recs = rt.forensics_records()
    assert recs and recs[0]["kind"] == "sidecar"
    assert recs == rj.forensics_records()
    rep = check_history(recs)
    assert rep.state == got
    if kind == "forest":
        T.check_forest_invariants(rt.forest)
    else:
        T.check_invariants(rt.tree.state, rt.tree.cfg)
