"""The port's serving stack against the JAX package on the CPU.

Prefix hashes bit for bit; ``PrefixIndex`` / ``SessionIndex`` (including
``evict_range``) call for call, with their trees' contents, stats and
flight-recorder histories; then ``ServeEngine``, serial and pipelined, on a
tiny dense config with 260-token prompts (one full ``PAGE`` block hashed,
so the prefix cache is hit) from the JAX engine's params carried across:
the same tokens, ``cache_hit_blocks``, ``admitted``, ``retired`` and
``ticks``.  Both packages' engines keep the reference's serving faults
(one shared cache position per step), so equal tokens include them."""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.core  # noqa: E402,F401  (jax x64 before any JAX input is built)
from repro.models.config import ModelConfig as JModelConfig  # noqa: E402
from repro.obs.witness import check_history  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402
from repro.serve import pages as jpages  # noqa: E402

from repro_torch.core import DictOracle, check_forest_invariants, check_invariants  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.serve import Request, ServeEngine  # noqa: E402
from repro_torch.serve import pages  # noqa: E402

TINY = dict(name="tiny", family="dense", n_layers=1, d_model=32, n_heads=2, n_kv=1,
            d_ff=64, vocab=64, qkv_bias=True, tie_embeddings=True, dtype="float32")


def test_prefix_hashes_bit_equal():
    rng = np.random.default_rng(0)
    assert pages.PAGE == jpages.PAGE
    for n in (0, 255, 256, 260, 700, 1024):
        toks = rng.integers(0, 151_936, n).tolist()
        assert pages.prefix_hashes(toks) == jpages.prefix_hashes(toks)
    assert pages._hash_chain(2**63 - 1, (1, 2, 3)) == jpages._hash_chain(2**63 - 1, (1, 2, 3))


def _index_script(rng):
    """(method, args) calls of a churned prefix index: publish, look up,
    evict and re-publish hot blocks."""
    hashes = [pages._hash_chain(i, (i,)) for i in range(40)]
    calls = []
    for r in range(6):
        pick = rng.choice(40, 8, replace=False).tolist()
        calls.append(("publish_batch", ([hashes[i] for i in pick], [r * 100 + i for i in pick])))
        calls.append(("lookup_batch", ([hashes[i] for i in rng.choice(40, 8).tolist()],)))
        calls.append(("evict_batch", ([hashes[i] for i in pick[:5]],)))
    return calls


# index knobs: one elim tree (the default), occ mode, a forest of two
# shards (and, for sessions, a forest that splits as ids pile up)
INDEX_KNOBS = [dict(), dict(mode="occ"), dict(shards=2)]


def _check_index(t):
    if t.tree.n_shards > 1:
        check_forest_invariants(t.tree)
    else:
        check_invariants(t.tree.state, t.tree.cfg)


def _knob_id(kw):
    return "-".join(f"{k}={v}" for k, v in kw.items())


def test_prefix_index_equals_jax():
    _prefix_index_equals_jax({})


@pytest.mark.parametrize("kw", INDEX_KNOBS[1:], ids=_knob_id)
def test_prefix_index_knobs_equal_jax(kw):
    _prefix_index_equals_jax(kw)


def _prefix_index_equals_jax(kw):
    rng = np.random.default_rng(1)
    t, j = pages.PrefixIndex(device="cpu", **kw), jpages.PrefixIndex(**kw)
    for name, args in _index_script(rng):
        assert getattr(t, name)(*args) == getattr(j, name)(*args), name
    assert t.tree.items() == j.tree.items()
    assert t.stats() == j.stats()
    assert type(t.tree).__name__ == type(j.tree).__name__ and t.tree.mode == j.tree.mode
    _check_index(t)
    records = [json.loads(x) for x in t.tree.recorder.dump_records()]
    assert records == [json.loads(x) for x in j.tree.recorder.dump_records()]


SESSION_KNOBS = INDEX_KNOBS + [dict(shards=2, key_space=(0, 64), max_keys_per_shard=20)]


def test_session_index_evict_range_equals_jax():
    """Monotone session ids, swept in chunks: each ``evict_range`` returns
    the same page ids as JAX, in as many fused scan+delete rounds."""
    _session_index_equals_jax({})


@pytest.mark.parametrize("kw", SESSION_KNOBS[1:], ids=_knob_id)
def test_session_index_knobs_evict_range_equal_jax(kw):
    """The same in occ mode and on forests, whose sweeps straddle shard
    boundaries."""
    _session_index_equals_jax(kw)


def _session_index_equals_jax(kw):
    t, j = pages.SessionIndex(device="cpu", **kw), jpages.SessionIndex(**kw)
    oracle = DictOracle()
    rids = list(range(50))
    vals = [1000 + 3 * r for r in rids]
    for a in range(0, 50, 10):
        t.publish_batch(rids[a : a + 10], vals[a : a + 10])
        j.publish_batch(rids[a : a + 10], vals[a : a + 10])
        for r, v in zip(rids[a : a + 10], vals[a : a + 10]):
            oracle.d[r] = v
    for lo, hi, cap in ((0, 23, 8), (23, 24, 8), (30, 31, 8), (24, 45, 8)):
        got = t.evict_range(lo, hi, cap=cap)
        assert got == j.evict_range(lo, hi, cap=cap)
        for r in [r for r in oracle.d if lo <= r < hi]:
            assert oracle.d.pop(r) in got
    assert t.tree.items() == j.tree.items() == oracle.items()
    assert t.stats() == j.stats()
    if t.tree.n_shards > 1:
        assert np.array_equal(t.tree.splits, j.tree.splits)
    _check_index(t)
    records = [json.loads(x) for x in t.tree.recorder.dump_records()]
    assert records == [json.loads(x) for x in j.tree.recorder.dump_records()]
    assert sum(r.get("fused") == "scan_delete" for r in records) > 4  # chunked sweeps
    check_history(records)


def test_session_forest_splits_as_ids_pile_up():
    """The capped session forest of ``SESSION_KNOBS`` re-partitioned its
    live id range, as JAX's did (the split points are held equal above)."""
    t = pages.SessionIndex(device="cpu", **SESSION_KNOBS[-1])
    t.publish_batch(list(range(50)), list(range(50)))
    assert t.tree.n_shards > 2 and t.tree.metrics.value("shard_splits") > 0


def test_durable_session_index_warm_restart_equals_jax(tmp_path):
    """``tests/test_durable.py``'s warm restart through both packages: a
    durable two-shard ``SessionIndex`` publishes and sweeps, and a second
    index on the same directory recovers it (shard count from the
    manifest) with the same lookups and journal."""
    from test_torch_durable import assert_same_journal

    dj, dt = str(tmp_path / "jax"), str(tmp_path / "port")
    kw = dict(mode="elim", shards=2, key_space=(0, 256))
    j = jpages.SessionIndex(durable_dir=dj, **kw)
    t = pages.SessionIndex(durable_dir=dt, device="cpu", **kw)
    for idx in (j, t):
        idx.publish_batch(list(range(100, 140)), list(range(40)))
    assert t.evict_range(100, 120, cap=8) == j.evict_range(100, 120, cap=8) == list(range(20))
    assert_same_journal(dj, dt)
    j2 = jpages.SessionIndex(durable_dir=dj, **kw)
    t2 = pages.SessionIndex(durable_dir=dt, device="cpu", **kw)
    assert t2.lookup_batch([119, 120, 139]) == j2.lookup_batch([119, 120, 139]) == [None, 20, 39]
    assert t2.tree.n_shards == 2 and t2.tree.items() == j2.tree.items()
    t2.close()
    with pytest.raises(ValueError, match="journaled in 'elim' mode"):
        pages.SessionIndex(durable_dir=dt, device="cpu", **{**kw, "mode": "occ"})


def _requests(n, seed):
    """260-token prompts: one full PAGE block each, most of them one hot
    prompt, so later requests hit the prefix cache."""
    rng = np.random.default_rng(seed)
    hot = rng.integers(0, 64, 260).tolist()
    out = []
    for rid in range(n):
        prompt = list(hot) if rid % 3 != 2 else rng.integers(0, 64, 260).tolist()
        out.append((rid, prompt, 3 + rid % 2))
    return out


ENGINE = dict(max_batch=2, s_max=300, n_pages=6)  # 2 pages a request: retire evicts


# (pipelined, index knobs): the serial and pipelined engines on one elim
# tree per index, and the serial engine on two-shard occ forests
ENGINE_CASES = [(False, {}), (True, {}), (False, dict(index_shards=2, index_mode="occ"))]


@pytest.fixture(scope="module", params=ENGINE_CASES,
                ids=["serial", "pipelined", "serial-2shards-occ"])
def engines(request):
    pipelined, knobs = request.param
    jcfg, tcfg = JModelConfig(**TINY), ModelConfig(**TINY)
    jeng = jengine.ServeEngine(jcfg, pipelined=pipelined, **knobs, **ENGINE)
    params = params_from_numpy(jax.tree.map(np.asarray, jeng.params))
    teng = ServeEngine(tcfg, pipelined=pipelined, device="cpu", params=params, **knobs, **ENGINE)
    for eng, req in ((jeng, jengine.Request), (teng, Request)):
        for rid, prompt, max_new in _requests(5, seed=3):
            eng.submit(req(rid=rid, prompt=prompt, max_new=max_new))
        eng.run_until_done(max_ticks=200)
    return jeng, teng


def test_engine_tokens_equal_jax(engines):
    jeng, teng = engines
    want = {r.rid: r.out for r in jeng.done}
    got = {r.rid: r.out for r in teng.done}
    assert got == want and len(got) == 5
    assert [r.rid for r in teng.done] == [r.rid for r in jeng.done]


def test_engine_counters_equal_jax(engines):
    jeng, teng = engines
    for name in ("admitted", "retired", "ticks", "decode_tokens", "cache_hit_blocks"):
        assert teng.metrics.value(name) == jeng.metrics.value(name), name
    ts, js = teng.stats(), jeng.stats()
    for key in ("cache_hit_blocks", "n_done", "pages_used", "session_scans", "rounds",
                "searches", "eliminated"):
        assert ts[key] == js[key], key
    assert ts["cache_hit_blocks"] > 0 and ts["n_done"] == 5


def test_engine_indexes_equal_jax(engines):
    jeng, teng = engines
    for name in ("index", "sessions"):
        t, j = getattr(teng, name).tree, getattr(jeng, name).tree
        assert t.items() == j.items(), name
        assert (t.n_shards, t.mode) == (j.n_shards, j.mode), name
        _check_index(getattr(teng, name))
        records = [json.loads(x) for x in t.recorder.dump_records()]
        assert records == [json.loads(x) for x in j.recorder.dump_records()], name


def test_pipelined_overlap_is_recorded(engines):
    _, teng = engines
    h = teng.metrics.histogram_summary("tick_overlap_frac")
    if teng.pipelined:
        assert h["count"] == teng.metrics.value("ticks") and h["max"] > 0.0
    else:
        assert h["count"] == 0


@pytest.fixture(scope="module")
def durable_engines(tmp_path_factory):
    """``tests/test_serve_pipeline.py``'s durable engine through both
    packages: pipelined ticks, two-shard journaled indexes, groups of four
    rounds committed on the background thread; then a warm restart of
    each on its own directory."""
    base = tmp_path_factory.mktemp("durable-engine")
    jcfg, tcfg = JModelConfig(**TINY), ModelConfig(**TINY)
    knobs = dict(pipelined=True, index_shards=2, group_commit_every=4,
                 group_commit_max_wait_s=1e9, **ENGINE)
    out = []
    for restart in (False, True):
        jeng = jengine.ServeEngine(jcfg, index_durable_dir=str(base / "jax"), **knobs)
        params = params_from_numpy(jax.tree.map(np.asarray, jeng.params))
        teng = ServeEngine(tcfg, index_durable_dir=str(base / "port"), device="cpu",
                           params=params, **knobs)
        for eng, req in ((jeng, jengine.Request), (teng, Request)):
            for rid, prompt, max_new in _requests(3 if restart else 5, seed=7 if restart else 3):
                eng.submit(req(rid=rid, prompt=prompt, max_new=max_new))
            eng.run_until_done(max_ticks=200)
        out.append((jeng, teng))
        teng.close()
    return base, out


def _by_kind(recorder):
    """A recorder's history as one list a record kind, ``seq`` dropped: the
    async commit thread pushes its commit markers while later rounds run, so
    where they fall among the round records (and every ``seq`` after them)
    depends on thread timing, in either package; each kind's own order does
    not."""
    out = {}
    for line in recorder.dump_records():
        rec = json.loads(line)
        rec.pop("seq")
        out.setdefault(rec["kind"], []).append(rec)
    return out


def _durability(eng):
    dur = eng.stats()["durability"]
    for name in ("prefix", "sessions"):
        dur[name] = {k: v for k, v in dur[name].items() if k != "pending_age_s"}
    return dur


def test_durable_engine_equals_jax(durable_engines):
    """Tokens, index histories, ``stats()["durability"]`` and journals equal
    JAX's, before and after the warm restart; the exit drain leaves no
    group pending and the session journal batched its rounds."""
    from test_torch_durable import assert_same_journal

    base, runs = durable_engines
    for jeng, teng in runs:
        assert {r.rid: r.out for r in teng.done} == {r.rid: r.out for r in jeng.done}
        for name in ("index", "sessions"):
            t, j = getattr(teng, name).tree, getattr(jeng, name).tree
            assert t.items() == j.items() and t.n_shards == j.n_shards, name
            records = _by_kind(t.recorder)
            assert records == _by_kind(j.recorder), name
            assert records["commit"] and records["round"]
        dur = _durability(teng)
        assert dur == _durability(jeng)
        assert not dur["degraded"]
        for name in ("prefix", "sessions"):
            assert dur[name]["group_commit_every"] == 4 and dur[name]["pending_rounds"] == 0
        assert dur["sessions"]["rounds_per_commit"]["max"] > 1
        assert teng.sessions.tree.commit_async  # the default when grouping
    assert runs[1][1].index.tree.forensics_records()  # the restart recovered a sidecar
    for sub in ("prefix", "sessions"):
        assert_same_journal(str(base / "jax" / sub), str(base / "port" / sub), async_rounds=True)


def test_engine_refuses_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(ModelConfig(**TINY), max_batch=1, s_max=8, n_pages=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pages.PrefixIndex()


def test_launcher_runs_on_the_cpu(capsys):
    from repro_torch.launch import serve

    serve.main(["--requests", "3", "--max-new", "2"], device="cpu")
    out = capsys.readouterr().out
    assert "completed 3 requests" in out
    stats = json.loads(out[: out.rindex("}") + 1])
    assert stats["n_done"] == 3
