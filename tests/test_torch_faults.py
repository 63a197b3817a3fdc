"""The port's fault injection against the JAX package's on the CPU.

``FaultPlan`` fire schedules must be equal over a grid of ``(seed, site,
commit, shard, attempt)``, budgets and windows included: the crc32 draw is
a pure function of the hit, so one seeded plan fires at the same I/O
operations in both packages.  Then the same plans go into both packages'
durable trees on the same rounds (``tests/test_faults.py``'s scenarios):
an ``eio`` retried to success, a commit that fails every attempt and so
forces a full snapshot, a sick disk that degrades the holder and reattaches once
healed, a torn segment truncated and quarantined at recovery, and a
manifest bit flip that falls back to ``MANIFEST.prev``.  Journals (as
``test_torch_durable.py`` compares them), counters, ``durability_status``
and the flight-recorder trail must equal JAX's, and each package's
recovery must land on the same committed prefix."""
import json
import os
import shutil

import pytest

torch = pytest.importorskip("torch")

import repro.core as J  # noqa: E402  (enables jax x64 before any JAX input is built)
from repro.core import faults as jfaults  # noqa: E402

import repro_torch.core as T  # noqa: E402
from repro_torch.core import faults as tfaults  # noqa: E402
from test_torch_durable import (  # noqa: E402
    _mk_rounds,
    assert_same_journal,
    assert_same_state,
    assert_same_stats,
    contents,
    make,
)

# durability_status fields that are clocks, not counters
CLOCKS = ("pending_age_s",)


def _outcomes(pkg, plan, grid):
    out = []
    for site, commit, shard, attempt in grid:
        try:
            out.append(("ok", plan.fail(site, commit=commit, shard=shard, attempt=attempt)))
        except pkg.InjectedFault as e:
            out.append(("fault", e.kind, e.errno, str(e)))
        except pkg.SimulatedCrash as e:
            out.append(("crash", str(e)))
    return out


def _plans(pkg, seed):
    return pkg.FaultPlan(seed=seed, specs=[
        pkg.FaultSpec(site="segment_fsync", kind="eio", p=0.3),
        pkg.FaultSpec(site="segment_write", kind="torn", p=0.2, torn_frac=0.25),
        pkg.FaultSpec(site="manifest_rename", kind="rename_fail", p=0.1, commits=(3, 30)),
        pkg.FaultSpec(site="*", kind="enospc", p=0.05, times=4),
        pkg.FaultSpec(site="dir_fsync", kind="crash", p=0.02),
    ])


@pytest.mark.parametrize("seed", [0, 7, 42])
def test_fire_schedules_equal_jax(seed):
    grid = [(site, c, s, a) for site in tfaults.FAULT_SITES for c in range(40)
            for s in (-1, 0, 3) for a in (0, 1)]
    jp, tp = _plans(J, seed), _plans(T, seed)
    seen = []
    jp.on_inject = lambda site, kind: seen.append(("j", site, kind))
    tp.on_inject = lambda site, kind: seen.append(("t", site, kind))
    assert _outcomes(T, tp, grid) == _outcomes(J, jp, grid)
    assert tp.stats() == jp.stats() and tp.injected > 0
    assert [x[1:] for x in seen if x[0] == "t"] == [x[1:] for x in seen if x[0] == "j"]
    for site, c, s, a in grid[::7]:
        assert tfaults._hash_draw(seed, site, c, s, a) == jfaults._hash_draw(seed, site, c, s, a)


def test_fault_names_equal_jax():
    assert tfaults.FAULT_SITES == jfaults.FAULT_SITES
    assert tfaults.FAULT_KINDS == jfaults.FAULT_KINDS
    assert issubclass(T.InjectedFault, OSError) and issubclass(T.SimulatedCrash, RuntimeError)
    plan = tfaults.as_fault_plan(T.CrashPoint("mid_manifest", 3))
    with pytest.raises(T.SimulatedCrash, match="commit 3"):
        plan.maybe_fire("mid_manifest", 3)
    with pytest.raises(TypeError):
        tfaults.as_fault_plan(object())


def _status(h):
    return {k: v for k, v in h.durability_status().items() if k not in CLOCKS}


def _trail(h):
    return [r for r in h.recorder.records() if r["kind"] in ("fault", "commit", "transition")]


def _pair(tmp_path, specs, rounds, *, heal_after=None, more=(), **kw):
    """The same plan and rounds through both packages' durable trees; the
    journals and counters compared after every round.  ``heal_after``
    clears both plans after that many rounds (the disk healed)."""
    dj, dt = str(tmp_path / "jax"), str(tmp_path / "port")
    plans = {pkg: pkg.FaultPlan(seed=11, specs=[pkg.FaultSpec(**s) for s in specs])
             for pkg in (J, T)}
    jh = make(J, dj, faults=plans[J], commit_backoff_s=0.0, **kw)
    th = make(T, dt, faults=plans[T], commit_backoff_s=0.0, **kw)
    o = T.DictOracle()
    prefixes = [o.items()]
    for i, (ops, keys, vals) in enumerate(list(rounds) + list(more)):
        if i == heal_after:
            plans[J].clear()
            plans[T].clear()
        jh.apply_round(ops, keys, vals)
        th.apply_round(ops, keys, vals)
        o.apply_round(ops, keys, vals)
        prefixes.append(o.items())
        assert_same_stats(jh, th)
        assert _status(th) == _status(jh)
    assert plans[T].stats() == plans[J].stats()
    assert th.metrics.snapshot()["counters"] == jh.metrics.snapshot()["counters"]
    assert _trail(th) == _trail(jh)
    return dj, dt, jh, th, prefixes


def test_eio_retried_to_success_equals_jax(tmp_path):
    dj, dt, jh, th, prefixes = _pair(
        tmp_path, [dict(site="segment_fsync", kind="eio", times=2)], _mk_rounds())
    s = th.durability_status()
    assert s["commit_retries"] == 2 and not s["degraded"]
    assert th.metrics.value("fault_injected") == 2
    assert_same_journal(dj, dt)
    assert contents(T, T.recover(dt, device="cpu")) == prefixes[-1]


def test_failed_commit_forces_a_full_snapshot_equals_jax(tmp_path):
    """A commit that fails every attempt loses its dirty set, so the next
    commit writes a full snapshot, in both packages alike."""
    dj, dt, jh, th, prefixes = _pair(
        tmp_path, [dict(site="manifest_rename", kind="rename_fail", commits=(2, 3), times=2)],
        _mk_rounds(5, seed=14), snapshot_every=100, commit_retries=1)
    assert th.dstats.commit_retries == 2 and th.metrics.value("full_snapshots") == 2
    assert any("_snapshot_00000002" in f for f in os.listdir(dt))
    assert_same_journal(dj, dt)
    rj, rt = J.recover(dj), T.recover(dt, device="cpu")
    assert_same_state(rj, rt)
    assert contents(T, rt) == prefixes[-1]


def test_degrade_then_reattach_equals_jax(tmp_path):
    """A sick disk degrades both holders at the same commit (volatile
    serving, commits suspended); once healed, the same probe reattaches
    them and re-journals everything."""
    dj, dt, jh, th, prefixes = _pair(
        tmp_path, [dict(site="manifest_rename", kind="rename_fail")], _mk_rounds(8, seed=3),
        heal_after=8, more=_mk_rounds(4, seed=4), commit_retries=1, degrade_after=2,
        reattach_every=2)
    assert th.metrics.value("durability_degraded") == 1
    assert th.metrics.value("durability_reattached") == 1
    assert not th.degraded and th.dstats.commits_suspended >= 1
    assert_same_journal(dj, dt)
    rj, rt = J.recover(dj), T.recover(dt, device="cpu")
    assert_same_state(rj, rt)
    assert contents(T, rt) == prefixes[-1]
    states = [r.get("state") for r in rt.forensics_records() if r.get("event") == "durability"]
    assert "degraded" in states and "reattached" in states
    assert rt.forensics_records() == rj.forensics_records()


def test_torn_segment_quarantined_equals_jax(tmp_path):
    """A torn segment write: the journals agree but for the torn file's
    bytes; each recovery truncates at it, lands on the commit before and
    quarantines the same files; the port recovers JAX's directory the
    same way."""
    dj, dt, jh, th, prefixes = _pair(
        tmp_path, [dict(site="segment_write", kind="torn", commits=(3, 4), torn_frac=0.5)],
        _mk_rounds(6, seed=8), snapshot_every=100)
    assert_same_journal(dj, dt, torn_ok=("s0000_segment_00000003.npz",))
    cross = str(tmp_path / "jax-by-port")
    shutil.copytree(dj, cross)
    rj, rt, rx = J.recover(dj), T.recover(dt, device="cpu"), T.recover(cross, device="cpu")
    for r in (rt, rx):
        assert_same_state(rj, r)
        assert contents(T, r) == prefixes[2]
        assert r._quarantined == rj._quarantined and r._quarantined
        assert r.metrics.value("segments_quarantined") == len(r._quarantined) >= 1
    assert sorted(os.listdir(os.path.join(dt, "quarantine"))) == \
        sorted(os.listdir(os.path.join(dj, "quarantine")))
    rt.apply_round([T.OP_INSERT], [999], [123])
    assert T.recover(dt, device="cpu").tree.find(999) == 123


def test_manifest_bitflip_falls_back_equals_jax(tmp_path):
    """A tampered MANIFEST fails its checksum in both packages: each falls
    back to MANIFEST.prev, whichever package wrote the directory."""
    dj, dt, jh, th, prefixes = _pair(tmp_path, [], _mk_rounds(5, seed=10), snapshot_every=100)
    for d in (dj, dt):
        mpath = os.path.join(d, "MANIFEST")
        man = json.load(open(mpath))
        man["shards"][0]["commit"] += 1  # tamper without refreshing the checksum
        json.dump(man, open(mpath, "w"))
    for d in (dj, dt):
        a, b = str(tmp_path / f"{os.path.basename(d)}-j"), str(tmp_path / f"{os.path.basename(d)}-t")
        shutil.copytree(d, a)
        shutil.copytree(d, b)
        rj, rt = J.recover(a), T.recover(b, device="cpu")
        assert_same_state(rj, rt)
        assert contents(T, rt) == contents(J, rj) == prefixes[-2]
        assert rt._commit_idx == rj._commit_idx and not rt._manifest_good
