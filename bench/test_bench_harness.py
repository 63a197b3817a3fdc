"""Small rehearsals of every cell through the harness on the CPU, against the
plain reference; the faults a run can have, planted under the timed path,
must turn ``correct`` false; the control runs must fail the comparison."""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from bench import control, harness

ROOT = Path(__file__).resolve().parent.parent
SPEC = ROOT / "BENCHMARK.json"
# the benchmark's cells and those held out of it (held.json), whose files stay
CELLS = [w["name"] for name in (SPEC, ROOT / "bench" / "held.json")
         for w in json.loads(name.read_text())["workloads"]]
UPD, SCAN, DUR = "elim-2m.upd100-zipf", "elim-2m.scan95-zipf", "durable-elim-2m.upd100-zipf"
SMALL = {"key_range": 2000, "load_keys": 1000, "load_first_lanes": 128, "load_lanes": 512,
         "tree": {"capacity": 2048, "b": 11, "a": 2, "max_height": 24}}
SMALL_MIX = {"round_lanes": 128, "warmup_rounds": 1}
SEED = 2**31 + 11


def rehearse(cell, trace=False, seconds=0.3, **kw):
    return harness.run_cell(SPEC, cell, SEED, seconds, trace, device="cpu",
                            config_override=SMALL, mix_override=SMALL_MIX,
                            log=lambda msg: None, **kw)


@pytest.mark.parametrize("cell", CELLS)
def test_rehearsal_matches_reference(cell):
    res = rehearse(cell)
    assert res["correct"], res["checks"]
    assert res["attempted"] == res["rounds"] * SMALL_MIX["round_lanes"] > 0
    assert ("recovery" in res) == ("durable" in cell)
    if "durable" in cell:  # group commit 1: the crash leaves no acknowledged round pending
        assert res["crash"]["pending_rounds"] == 0 and res["crash"]["journal_files"] > 0
    assert res["failed"] == 0
    want = {m["name"] for m in harness.resolve(SPEC, cell)["end_to_end"]}
    assert set(res["metrics"]) == want
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("cell", [UPD, DUR])
def test_traced_rehearsal_reads_every_layer(monkeypatch, cell):
    monkeypatch.setattr(harness, "PROFILE_MARGIN_S", 0.0)
    monkeypatch.setattr(harness, "PROFILE_ROUNDS", 1)
    monkeypatch.setattr(harness, "SPAN_ROUNDS", 1)
    res = rehearse(cell, trace=True, seconds=0.0)
    assert res["correct"], res["checks"]
    layer = {m["name"] for m in harness.resolve(SPEC, cell)["per_layer"]}
    # the roofline reads nothing on the CPU: no kernel runs there
    assert set(res["metrics"]) == {n for n in layer if not n.startswith("tree_kernels_roofline")}
    assert res["device"]["window_s"] > 0


def _state_unchanged(orig):
    def apply_round(self, *a, **kw):
        saved, cfg = self.stacked, self.cfg
        out = orig(self, *a, **kw)
        self.stacked, self.cfg = saved, cfg
        return out
    return apply_round


def _half_batch(orig):
    def apply_round(self, ops, keys, vals=None, **kw):
        ops = ops.copy()
        ops[ops.size // 2:] = 0
        return orig(self, ops, keys, vals, **kw)
    return apply_round


def _answer_altered(orig):
    def apply_round(self, *a, **kw):
        out = orig(self, *a, **kw)
        out.results[-1] += 1
        return out
    return apply_round


def _scan_row_altered(orig):
    def apply_round(self, ops, *a, **kw):
        out = orig(self, ops, *a, **kw)
        if out.scan is not None:
            lane = int((ops == 4).nonzero()[0][0])
            out.scan.vals[lane, 0] += 1
        return out
    return apply_round


@pytest.mark.parametrize("fault,cell", [
    (_state_unchanged, UPD), (_half_batch, UPD), (_answer_altered, UPD),
    (_scan_row_altered, SCAN), (_half_batch, SCAN), (_state_unchanged, DUR),
])
def test_planted_fault_is_not_correct(monkeypatch, fault, cell):
    from repro_torch.core import ABTree

    monkeypatch.setattr(ABTree, "apply_round", fault(ABTree.apply_round))
    res = rehearse(cell)
    assert not res["correct"], res["checks"]
    assert res["failed"] > 0 or any(c["value"] for c in res["checks"].values())


def test_unjournalled_round_is_not_correct(monkeypatch):
    from repro_torch.core import DurableABTree

    orig = DurableABTree._commit
    calls = []

    def commit(self, *a, **kw):  # acknowledge every third round without its commit
        calls.append(1)
        if len(calls) % 3:
            return orig(self, *a, **kw)

    monkeypatch.setattr(DurableABTree, "_commit", commit)
    # four window rounds, however slow the host: the last acknowledged round is then
    # one whose commit was skipped, and no later commit repairs it
    res = rehearse(DUR, seconds=1e9, max_rounds=4)
    assert not res["correct"]
    assert res["checks"]["recovered_keys_wrong"]["value"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_comparison(cell):
    res = control.run_control(cell, SEED, 4, device="cpu", config_override=SMALL,
                              mix_override=SMALL_MIX, log=lambda msg: None)
    assert not res["correct"], res["checks"]
    if "durable" in cell:  # the crash fires at the group's boundary
        assert res["crash"]["pending_rounds"] == control.GROUP - 1


def test_no_module_imports_jax_or_the_jax_package():
    banned = set(harness.FORBIDDEN)
    for path in (ROOT / "bench").rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            assert not {n.split(".")[0] for n in names} & banned, (path, names)


def test_rehearsal_process_holds_no_jax():
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "from bench import harness\n"
        "res = harness.run_cell(%r, %r, 5, 0.2, False, device='cpu', config_override=%r,"
        " mix_override=%r, log=lambda m: None)\n"
        "print(res['correct'], harness.forbidden_modules())\n"
    ) % (str(ROOT), str(ROOT / "src"), str(SPEC), SCAN, SMALL, SMALL_MIX)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split("\n")[-2] == "True []"


def test_run_refuses_without_a_card(monkeypatch, capsys):
    from bench import run

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""
