"""The port's trace export, report and op audit (``repro_torch.obs``)
against the JAX package's (``repro.obs``), and the port's ``configs/abtree``.

Port traces from ``tests/test_obs.py``'s recipes (``_traced_forest_trace``:
a two-shard forest's insert round and cross-shard scan; and a
repartitioning forest's skewed rounds, whose trace also holds the port's
``shard_sweep`` / ``shard_reinsert`` spans) go through both packages'
``to_chrome_trace``, ``validate_trace``, ``report_summary``,
``render_report`` and report CLI, which must agree; ``Tracer.export`` must
write JAX's document.  A port durable tree's recovered forensics sidecar
goes through both ``forensics_summary`` / ``render_forensics``.  The op
audit runs the search and scan phases on the CPU, where it records the
plain versions' counts; a round's aten ops must be the same with the
tracer on and off."""
import ast
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core  # noqa: E402,F401  (enables jax x64 before any JAX input is built)
import repro.obs as jobs  # noqa: E402
from repro.configs import abtree as jconfigs  # noqa: E402
from repro.obs import report as jreport  # noqa: E402
from repro.obs import trace_export as jexport  # noqa: E402

import repro_torch.obs as tobs  # noqa: E402
from repro_torch.configs import abtree as tconfigs  # noqa: E402
from repro_torch.core import (  # noqa: E402
    OP_FIND,
    OP_INSERT,
    ABForest,
    ABTree,
    DurableABTree,
    TreeConfig,
    recover,
)
from repro_torch.obs import op_audit  # noqa: E402
from repro_torch.obs import report as treport  # noqa: E402
from repro_torch.obs import trace_export as texport  # noqa: E402
from repro_torch.obs.recorder import Recorder  # noqa: E402
from repro_torch.obs.tracer import Tracer  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CFG = TreeConfig(capacity=2048, b=8, a=2, max_height=12)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """These rounds run thousands of small ops; with every worker of a
    parallel test run spinning up all cores' intra-op threads, the
    oversubscribed thread pools made them take minutes (the JAX audit
    tree's one 600-key round: 267 s under a 6-worker run, 2 s alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _forest_tracer():
    """``tests/test_obs.py``'s ``_traced_forest_trace`` on the port."""
    f = ABForest(n_shards=2, cfg=CFG, key_space=(0, 4096), device="cpu")
    f.tracer = Tracer()
    rng = np.random.default_rng(4)
    keys = rng.choice(4096, size=200, replace=False).astype(np.int64)
    f.apply_round(np.full(200, OP_INSERT, np.int32), keys, keys)
    f.scan_round([0, 2048], [2048, 4096], cap=16)
    return f.tracer


def _repartition_tracer():
    """``test_report_surfaces_pack_stats_and_repartition_span``'s skewed
    rounds on the port, until a repartition fires."""
    f = ABForest(n_shards=2, cfg=CFG, key_space=(0, 400), auto_repartition=True,
                 hot_shard_window=64, device="cpu")
    f.tracer = Tracer()
    rng = np.random.default_rng(13)
    seed = np.arange(0, 400, 2, dtype=np.int64)
    f.apply_round(np.full(seed.size, OP_INSERT, np.int32), seed, seed)
    for _ in range(4):
        keys = np.concatenate([rng.integers(0, 100, 38), rng.integers(200, 400, 10)])
        f.apply_round(np.full(48, OP_FIND, np.int32), keys.astype(np.int64),
                      np.zeros(48, np.int64))
        if f.metrics.value("repartitions"):
            break
    assert f.metrics.value("repartitions") >= 1
    return f.tracer


@pytest.fixture(scope="module")
def tracers():
    return {"forest": _forest_tracer(), "repartition": _repartition_tracer()}


def test_tracer_export_writes_jax_document(tracers, tmp_path):
    """``Tracer.export`` writes what JAX's ``to_chrome_trace`` builds from
    the same events: the process and per-track thread names included."""
    for name, tr in tracers.items():
        path = tr.export(str(tmp_path / f"{name}.json"))
        want = json.loads(json.dumps(jexport.to_chrome_trace(tr)))
        doc = texport.load_trace(path)
        assert doc == want, name
        meta = [e for e in doc["traceEvents"] if e["ph"] == "M"]
        assert meta[0]["args"]["name"] == "repro round engine"
        assert {e["args"]["name"] for e in meta[1:]} >= {"engine", "shard 0", "shard 1"}


def test_to_chrome_trace_equals_jax(tracers):
    for tr in tracers.values():
        assert texport.to_chrome_trace(tr) == jexport.to_chrome_trace(tr)


_OK_EVENT = {"name": "x", "ph": "X", "ts": 0.0, "dur": 1.0, "pid": 0, "tid": 0}
MALFORMED = {
    "no_envelope": {"nope": 1},
    "not_a_dict": [1, 2],
    "events_not_a_list": {"traceEvents": {"a": 1}},
    "missing_ts_and_tid": {"traceEvents": [{"name": "x", "ph": "X", "pid": 0}]},
    "bad_ph": {"traceEvents": [{"ph": "Q"}]},
    "event_not_an_object": {"traceEvents": [3]},
    "negative_dur": {"traceEvents": [{**_OK_EVENT, "dur": -1.0}]},
    "instant_scope": {"traceEvents": [{**_OK_EVENT, "ph": "i", "s": "x"}]},
    "counter_without_args": {"traceEvents": [{**_OK_EVENT, "ph": "C"}]},
    "args_not_an_object": {"traceEvents": [{**_OK_EVENT, "args": [1]}]},
    "unnamed": {"traceEvents": [{**_OK_EVENT, "name": ""}]},
    "valid": {"traceEvents": [_OK_EVENT]},
}


@pytest.mark.parametrize("case", sorted(MALFORMED))
def test_validate_trace_equals_jax(case):
    doc = MALFORMED[case]
    errs = texport.validate_trace(doc)
    assert errs == jexport.validate_trace(doc)
    assert (errs == []) == (case == "valid")


def test_port_trace_schema(tracers):
    """``test_trace_export_schema`` on the port's forest trace: valid, every
    engine phase present, per-shard instants on tracks 1+."""
    doc = texport.to_chrome_trace(tracers["forest"])
    assert texport.validate_trace(doc) == []
    names = {e["name"] for e in doc["traceEvents"] if e["ph"] == "X"}
    assert {"round", "search_combine", "apply", "retry", "rebalance", "scan"} <= names
    assert any(e["ph"] == "i" and e["tid"] >= 1 for e in doc["traceEvents"])
    rep = {e["name"] for e in texport.to_chrome_trace(tracers["repartition"])["traceEvents"]}
    assert {"repartition", "shard_sweep", "shard_reinsert"} <= rep


def test_report_summary_and_render_equal_jax(tracers):
    for name, tr in tracers.items():
        doc = json.loads(json.dumps(texport.to_chrome_trace(tr)))
        summ = treport.report_summary(doc)
        assert summ == jreport.report_summary(doc), name
        assert treport.render_report(doc) == jreport.render_report(doc), name
        assert summ["router_pack"] is not None
    assert "repartition" in treport.render_report(
        texport.to_chrome_trace(tracers["repartition"]))


def test_report_cli_equals_jax(tracers, tmp_path, capsys):
    path = tracers["repartition"].export(str(tmp_path / "trace.json"))
    for argv in ([path], [path, "--json"]):
        assert treport.main(argv) == 0
        got = capsys.readouterr().out
        assert jreport.main(argv) == 0
        assert got == capsys.readouterr().out
    assert json.loads(got)["router_pack"]["packs"] > 0
    bad = tmp_path / "bad.json"
    bad.write_text('{"traceEvents": [{"ph": "Q"}]}')
    assert treport.main([str(bad)]) == jreport.main([str(bad)]) == 1
    assert "schema violation" in capsys.readouterr().err


def test_forensics_equal_jax(tmp_path, capsys):
    """A port durable tree's recovered sidecar (and the recorder's own
    export) through both packages' forensics summary, text and CLI."""
    d = str(tmp_path / "journal")
    t = DurableABTree(d, CFG, mode="elim", device="cpu")
    t.recorder = Recorder()
    rng = np.random.default_rng(7)
    for _ in range(4):
        ops = rng.choice([OP_INSERT, OP_INSERT, OP_FIND, 3], 48).astype(np.int32)
        keys = rng.integers(0, 64, 48).astype(np.int64)
        t.apply_round(ops, keys, rng.integers(1, 1000, 48).astype(np.int64))
    live = t.recorder.export(str(tmp_path / "audit.jsonl"))
    t.close()
    recs = recover(d, device="cpu").forensics_records()
    assert recs[0]["kind"] == "sidecar"
    for records in (recs, Recorder.load(live)):
        summ = treport.forensics_summary(records)
        assert summ == jreport.forensics_summary(records)
        assert treport.render_forensics(records) == jreport.render_forensics(records)
        assert summ["rounds"] == 4 and summ["eliminated"] > 0
    for argv in ([live], [live, "--json"]):
        assert treport.main(argv) == 0
        got = capsys.readouterr().out
        assert jreport.main(argv) == 0
        assert got == capsys.readouterr().out


def test_obs_exports_equal_jax():
    assert tobs.__all__ == jobs.__all__
    assert all(hasattr(tobs, n) for n in tobs.__all__)


# ---------------------------------------------------------------------------
# op audit
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def small_tree():
    """A small b = 8 tree grown by 64-lane rounds, and one mixed round with
    range lanes."""
    t = ABTree(CFG, device="cpu")
    rng = np.random.default_rng(8)
    for _ in range(4):
        keys = rng.integers(0, 4096, 64).astype(np.int64)
        t.apply_round(np.full(64, OP_INSERT, np.int32), keys, keys)
    ops = rng.choice([OP_INSERT, OP_FIND, 3, 4], 64).astype(np.int32)
    keys = rng.integers(0, 4096, 64).astype(np.int64)
    vals = np.where(ops == 4, rng.integers(1, 64, 64), 5).astype(np.int64)
    return t, (ops, keys, vals)


def test_audit_search_phases_on_cpu(small_tree):
    out = op_audit.audit_search_phases(device="cpu")  # JAX's audit tree and lanes
    assert set(out) == {"search", "scan_descent", "scan_phase"}
    ops = {p: op_audit.count_ops(c) for p, c in out.items()}
    # the search sorts its batch; the CPU's plain compaction is a cumsum
    # rank, so the descent has no sort; the plain range gather is a stable
    # argsort (on the card the scan phase has none: test_torch_gpu.py)
    # (each phase runs AUDIT_REPEAT times in its session)
    repeat = op_audit.AUDIT_REPEAT
    assert ops["search"]["aten::argsort"] == repeat
    op_audit.assert_no_sort(out["scan_descent"], "scan_descent")
    assert ops["scan_phase"]["aten::argsort"] == repeat
    with pytest.raises(AssertionError, match="expected no sort"):
        op_audit.assert_no_sort(out["scan_phase"], "scan_phase")
    assert all(ops[p]["aten::index"] > 0 for p in ops)
    # no kernel on the CPU: no device event, no wrapper launch
    for p, c in out.items():
        assert set(op_audit.kernel_launches(c, p).values()) == {0}
        assert set(op_audit.wrapper_launches(c, p).values()) == {0}
    # a given holder and a round with range lanes; nothing is committed
    tree, batch = small_tree
    before = [x.clone() for x in tree.stacked[:-1]]
    got = op_audit.audit_search_phases(tree, batch)
    assert op_audit.count_ops(got["scan_phase"])["aten::argsort"] == repeat
    assert all(torch.equal(a, b) for a, b in zip(before, tree.stacked[:-1]))


def test_audit_needs_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        op_audit.audit_search_phases()


def test_round_ops_equal_with_tracer_on_and_off(small_tree):
    """The port's form of ``test_obs.py``'s HLO-identity pin: tracing is
    host-side, so one round's aten ops are the same with the tracer on."""
    tree, batch = small_tree
    counts = []
    for tracer in (None, Tracer()):
        t = ABTree(tree.cfg, device="cpu")
        t.stacked = type(tree.stacked)(*(x.clone() for x in tree.stacked[:-1]),
                                       stats=type(tree.stacked.stats)(
                                           *(x.clone() for x in tree.stacked.stats)))
        if tracer is not None:
            t.tracer = tracer
        c = op_audit.profile_ops(t.apply_round, *batch)
        counts.append({k: n for k, n in c.items() if k.startswith("aten::")})
    assert counts[0] == counts[1]
    assert tracer.events and counts[0]["aten::argsort"] >= 1


# ---------------------------------------------------------------------------
# configs/abtree
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["PAPER", "TPU8", "WIDE16"])
def test_abtree_presets_equal_jax(name):
    got, want = getattr(tconfigs, name), getattr(jconfigs, name)
    assert isinstance(got, TreeConfig)
    assert got._asdict() == want._asdict()


def test_chip_smoke_takes_paper_from_the_port():
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    assigned = {t.id for node in ast.walk(tree) if isinstance(node, ast.Assign)
                for t in node.targets if isinstance(t, ast.Name)}
    assert "TREE_CFG" not in assigned
    imports = [(n.module, a.name) for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)
               for a in n.names]
    assert ("repro_torch.configs.abtree", "PAPER") in imports
