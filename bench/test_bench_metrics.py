"""Each metric reader, the roofline arithmetic and the trace reductions on
synthetic inputs."""
import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from bench import harness, roofline, tracing

ROOT = Path(__file__).resolve().parent.parent
# the benchmark's metrics and those held out of it (held.json)
NAMES = [m["name"] for name in ("BENCHMARK.json", "bench/held.json")
         for spec in [json.loads((ROOT / name).read_text())]
         for m in spec["end_to_end"] + spec["per_layer"]]

SPANS = {"seconds": {"round": 1.0, "search_combine": 0.2, "retry": 0.3, "rebalance": 0.1,
                     "scan": 0.05}, "rounds": 4, "round_self_s": 0.2}
DATA = {
    "setup_s": 50.0,
    "window": {"seconds": 2.0, "rounds": 4, "lanes": 400, "update_lanes": 200,
               "round_ms": [10.0, 20.0, 30.0, 40.0]},
    "counters": {"eliminated": 50, "retry_passes": 8, "flush_bytes": 4000,
                 "commit_latency_s": [0.01, 0.02, 0.03, 0.04]},
    "spans": SPANS,
    "profile": {"window_s": 2.0, "busy_s": 0.5, "least_s": {"K1": 0.001, "K3": 0.001},
                "kernels": {"K1": {"launches": 2, "device_s": 0.002},
                            "K3": {"launches": 2, "device_s": 0.008}}},
}
WANT = {
    "ops_per_s": 200.0, "round_ms_p95": 38.5, "setup_s": 50.0, "elim_pct": 25.0, "retry_passes_per_round": 2.0,
    "commit_ms": 25.0, "flush_bytes_per_op": 10.0, "device_idle_pct": 75.0,
    "tree_kernels_roofline_pct": 20.0, "round_self_ms": 50.0, "search_combine_ms": 50.0,
    "retry_ms": 75.0, "rebalance_ms": 25.0, "scan_ms": 12.5,
}


@pytest.mark.parametrize("name", NAMES)
def test_reader(name):
    read = harness.reader(harness.BENCH_DIR, name)
    assert read(DATA) == pytest.approx(WANT[name.split(".")[0]])


@pytest.mark.parametrize("name", NAMES)
def test_reader_with_nothing_to_read_returns_nothing(name):
    empty = {"window": {"seconds": 1.0, "rounds": 0, "lanes": 0, "update_lanes": 0,
                        "round_ms": []},
             "counters": {"eliminated": None, "retry_passes": None, "flush_bytes": None,
                          "commit_latency_s": None}}
    assert harness.reader(harness.BENCH_DIR, name)(empty) is None


def test_qualified_name_reads_its_base_file(tmp_path):
    (tmp_path / "metrics").mkdir()
    (tmp_path / "metrics" / "x.py").write_text("def read(data):\n    return 1.0\n")
    (tmp_path / "metrics" / "x.own.py").write_text("def read(data):\n    return 2.0\n")
    assert harness.reader(tmp_path, "x.other")({}) == 1.0
    assert harness.reader(tmp_path, "x.own")({}) == 2.0


def test_round_least_counts_distinct_nodes_once():
    shape = {"b": 11, "height": 4, "touched": [100, 100, 11, 1], "point_lanes": 100,
             "range_lanes": 0, "rows": 0, "cap": 128}
    k1_bytes, k1_ops = roofline.round_least(shape)["K1"]
    internal, leaf = 10 * 8 + 11 * 4, 11 * 8
    nodes = (1 + 11 + 100) * internal + 100 * leaf
    assert k1_bytes == 100 * 8 + nodes + 100 * 8 + 100 * 17
    assert k1_ops == 100 * 4 * 11
    assert set(roofline.round_least(shape)) == {"K1", "K3"}
    scan = dict(shape, point_lanes=0, range_lanes=10, rows=300)
    least = roofline.round_least(scan)
    assert set(least) == {"K2", "K4"}
    assert least["K4"][0] == 10 * 16 + 300 * 16 + 10 * (128 * 16 + 5)
    assert roofline.round_least_s(scan)["K4"] == pytest.approx(least["K4"][0] / 3.35e12)
    assert roofline.kernel_of("void descend_probe_kernel<8>(...)") == "K1"
    assert roofline.kernel_of("range_scan_warp_rows") == "K4"
    assert roofline.kernel_of("elementwise_kernel") is None


@pytest.mark.parametrize("points,touched", [
    # keys 0, 2, 22, 2000 at places 0, 1, 11, 1000; 5000 past the end goes to the last leaf
    ([0, 2, 22, 2000, 5000, 2, 2], [4, 3, 1]),
    ([0, 0, 0], [1, 1, 1]),  # one hot key is one path, however many lanes ask for it
    ([2 * k for k in range(0, 1331, 11)], [121, 11, 1]),  # one key a leaf: every node
])
def test_tree_shape_is_the_fullest_tree_and_its_distinct_nodes(points, touched):
    keys = np.arange(0, 2 * 1331, 2, dtype=np.int64)  # 1,331 keys: 121 leaves, 11, 1 root
    shape = roofline.tree_shape(keys, np.asarray(points, np.int64), 11)
    assert shape == {"b": 11, "height": 3, "touched": touched}


def _ev(name, lo, hi, cuda=False):
    kind = torch.autograd.DeviceType.CUDA if cuda else torch.autograd.DeviceType.CPU
    return SimpleNamespace(name=name, device_type=kind,
                           time_range=SimpleNamespace(start=lo, end=hi))


def test_reduce_profile_busy_kernels_and_labelled_gaps():
    events = [
        _ev(tracing.STRETCH, 100, 1100),
        _ev("bench:round", 100, 1100), _ev("bench:retry", 500, 1000),
        _ev("bench:retry", 500, 1000, cuda=True),  # a label's device copy: not work
        _ev("descend_probe_kernel", 150, 250, cuda=True),
        _ev("elim_combine_kernel", 200, 300, cuda=True),
        _ev("Memcpy DtoH", 600, 700, cuda=True),
        _ev("aten::sort", 0, 50, cuda=True),  # before the stretch
    ]
    p = tracing.reduce_profile(events, roofline.kernel_of)
    assert p["window_s"] == pytest.approx(1000e-6)
    assert p["busy_s"] == pytest.approx(250e-6)
    assert p["kernels"]["K1"] == {"launches": 1, "device_s": pytest.approx(100e-6)}
    assert p["kernels"]["K3"]["device_s"] == pytest.approx(100e-6)
    gaps = dict(p["idle_gaps"])
    assert gaps["retry"] == pytest.approx(400e-6)  # 700-1100: its middle is in retry
    assert gaps["round"] == pytest.approx(350e-6)  # 100-150 and 300-600
    assert tracing.reduce_profile(events[1:], roofline.kernel_of) == {}


def test_span_totals_self_time_is_round_less_its_children():
    ev = [
        {"name": "round", "ph": "X", "ts": 0, "dur": 100},
        {"name": "search_combine", "ph": "X", "ts": 10, "dur": 20},
        {"name": "retry", "ph": "X", "ts": 40, "dur": 40},
        {"name": "split_wave", "ph": "X", "ts": 50, "dur": 10},
        {"name": "journal_flush", "ph": "X", "ts": 120, "dur": 5},
        {"name": "point_lanes", "ph": "i", "ts": 15},
    ]
    s = tracing.span_totals(ev)
    assert s["rounds"] == 1
    assert s["round_self_s"] == pytest.approx(40e-6)
    assert s["seconds"]["retry"] == pytest.approx(40e-6)
