"""A configuration, a mix and a per-layer metric dropped into a folder are
found by name and run, with no edit to the harness."""
import json
import shutil

import pytest

from bench import harness

from bench.test_bench_harness import SMALL

NEW_METRIC = '''"""Lanes per round of the window."""


def read(data):
    w = data["window"]
    return w["lanes"] / w["rounds"] if w["rounds"] else None
'''


def test_new_config_mix_and_metric_are_found(tmp_path, monkeypatch):
    bench = tmp_path / "bench"
    for sub in ("configs", "traffic", "metrics"):
        (bench / sub).mkdir(parents=True)
    config = json.loads((harness.BENCH_DIR / "configs" / "elim-2m.json").read_text())
    config.update(SMALL, name="tiny-tree", tree=dict(SMALL["tree"], b=8))
    (bench / "configs" / "tiny-tree.json").write_text(json.dumps(config))
    mix = {"name": "find-mix", "round_lanes": 96, "warmup_rounds": 1,
           "ops": {"find": 0.5, "insert": 0.25, "delete": 0.25},
           "keys": {op: {"dist": "uniform"} for op in ("find", "insert", "delete")}}
    (bench / "traffic" / "find-mix.json").write_text(json.dumps(mix))
    for name in ("ops_per_s", "setup_s"):
        shutil.copy(harness.BENCH_DIR / "metrics" / f"{name}.py", bench / "metrics")
    (bench / "metrics" / "lanes_per_round.py").write_text(NEW_METRIC)
    spec = {
        "configs": [{"name": "tiny-tree", "file": "bench/configs/tiny-tree.json"}],
        "workloads": [{"name": "tiny-tree.find-mix", "config": "tiny-tree",
                       "traffic": "find-mix", "chips": 1}],
        "end_to_end": [{"name": "ops_per_s", "unit": "ops/s"}, {"name": "setup_s", "unit": "s"}],
        "per_layer": [{"name": "lanes_per_round", "unit": "lanes", "moves": "ops_per_s"}],
    }
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    monkeypatch.setattr(harness, "PROFILE_MARGIN_S", 0.0)
    monkeypatch.setattr(harness, "PROFILE_ROUNDS", 1)
    monkeypatch.setattr(harness, "SPAN_ROUNDS", 1)
    for trace, seconds, want in ((False, 0.2, {"ops_per_s", "setup_s"}),
                                 (True, 0.0, {"lanes_per_round"})):
        res = harness.run_cell(tmp_path / "BENCHMARK.json", "tiny-tree.find-mix", 3, seconds, trace,
                               device="cpu", bench_dir=bench, log=lambda m: None)
        assert res["correct"], res["checks"]
        assert set(res["metrics"]) == want
    assert res["metrics"]["lanes_per_round"]["value"] == 96


@pytest.mark.parametrize("holder,args", [
    ("ABForest", {"mode": "elim", "n_shards": 2, "key_space": [0, 2000]}),
    ("DurableForest", {"mode": "elim", "n_shards": 2, "key_space": [0, 2000]}),
])
def test_forest_configuration_is_built_from_its_data(tmp_path, holder, args):
    """A forest, volatile or durable, is one more configuration file: the
    harness builds its holder, crashes and recovers it, with no edit."""
    bench = tmp_path / "bench"
    for sub in ("configs", "traffic", "metrics"):
        (bench / sub).mkdir(parents=True)
    name = "forest2-" + holder.lower()
    config = json.loads((harness.BENCH_DIR / "configs" / "durable-elim-2m.json").read_text())
    config.update(SMALL, name=name, holder=holder, args=args)
    if not holder.startswith("Durable"):
        del config["journal_arg"]
    (bench / "configs" / f"{name}.json").write_text(json.dumps(config))
    shutil.copy(harness.BENCH_DIR / "traffic" / "upd100-zipf.json", bench / "traffic")
    shutil.copy(harness.BENCH_DIR / "metrics" / "ops_per_s.py", bench / "metrics")
    cell = f"{name}.upd100-zipf"
    spec = {
        "configs": [{"name": name, "file": f"bench/configs/{name}.json"}],
        "workloads": [{"name": cell, "config": name, "traffic": "upd100-zipf", "chips": 1}],
        "end_to_end": [{"name": "ops_per_s", "unit": "ops/s"}],
        "per_layer": [],
    }
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    res = harness.run_cell(tmp_path / "BENCHMARK.json", cell, 7, 0.2, False, device="cpu",
                           bench_dir=bench, mix_override={"round_lanes": 128, "warmup_rounds": 1},
                           log=lambda m: None)
    assert res["correct"], res["checks"]
    assert ("recovery" in res) == holder.startswith("Durable")
