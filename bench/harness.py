"""One run of one cell: set-up (holder, load, warm-up), the measured
window, the traced stretches, recovery, and the check against the plain
reference.  ``run.py`` is the command line; the tests call ``run_cell`` on
``device="cpu"`` at small sizes.

Everything a cell needs is found by name: ``BENCHMARK.json`` names the
cell's configuration file and its mix (``traffic/<mix>.json``), and each
metric is read by ``metrics/<metric>.py``.  Nothing here changes for a new
configuration, mix or metric.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import os
import resource
import shutil
import sys
import tempfile
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import torch

from bench import roofline, tracing
from bench.check import Check
from bench.reference import Dictionary
from bench.traffic import OP_DELETE, OP_INSERT, OP_NOP, OP_RANGE, Generator, load_rounds

BENCH_DIR = Path(__file__).resolve().parent
PROFILE_ROUNDS = 4  # rounds in a traced run's profiled stretch
PROFILE_MARGIN_S = 0.5  # idle time on both sides of the stretch inside the profiler session
SPAN_ROUNDS = 3  # rounds the traced run's span stretch runs at least
CRASH_ROUNDS = 64  # rounds a durable run drives after its window until the armed crash fires
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


# ----------------------------------------------------------------------------
# finding a cell's files
# ----------------------------------------------------------------------------


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def resolve(spec_path: Path, workload: str, bench_dir: Path = BENCH_DIR) -> dict:
    """The cell ``workload`` of the benchmark file at ``spec_path``: its
    entry, configuration, mix, and the metrics it reports with and without
    tracing.  A cell held out of the benchmark (``held.json``: the same
    entries, for cells kept out until they hold a bound) resolves with the
    held metrics besides the benchmark's."""
    spec_path = Path(spec_path)
    spec = load_json(spec_path)
    cells = {w["name"]: w for w in spec["workloads"]}
    held = Path(bench_dir) / "held.json"
    if workload not in cells and held.exists():
        extra = load_json(held)
        if workload in {w["name"] for w in extra["workloads"]}:
            for k in ("workloads", "end_to_end", "per_layer"):
                spec[k] = spec[k] + extra.get(k, [])
            cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in {spec_path}")
    cell = cells[workload]
    configs = {c["name"]: c for c in spec["configs"]}
    config = load_json(spec_path.parent / configs[cell["config"]]["file"])
    mix = load_json(Path(bench_dir) / "traffic" / f"{cell['traffic']}.json")
    e2e = [m for m in spec["end_to_end"] if workload in m.get("workloads", [workload])]
    names = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"]
             if workload in m.get("workloads", [workload] if m["moves"] in names else [])]
    return {"cell": cell, "config": config, "mix": mix, "end_to_end": e2e,
            "per_layer": layer, "bench_dir": Path(bench_dir)}


def reader(bench_dir: Path, name: str) -> Callable[[dict], Optional[float]]:
    """``read`` of ``metrics/<name>.py``; a name ``<base>.<qualifier>``
    without a file of its own (one quantity split by the end-to-end
    metric its cells report) is read by ``metrics/<base>.py``."""
    path = Path(bench_dir) / "metrics" / f"{name}.py"
    if not path.exists():
        path = path.with_name(name.split(".")[0] + ".py")
    spec = importlib.util.spec_from_file_location("bench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# ----------------------------------------------------------------------------
# the program
# ----------------------------------------------------------------------------


def make_holder(config: dict, device, journal: Optional[str]):
    """The holder the configuration names, built from its data alone:
    ``holder`` is a class of ``repro_torch.core``, ``args`` its keyword
    arguments, ``tree`` the ``TreeConfig`` it takes as ``cfg``, and a
    durable configuration's ``journal_arg`` the argument that takes the
    journal's directory."""
    from repro_torch import core

    kw = dict(config.get("args", {}), device=device)
    if "tree" in config:
        kw["cfg"] = core.TreeConfig(**config["tree"])
    if journal is not None:
        kw[config["journal_arg"]] = journal
    return getattr(core, config["holder"])(**kw)


def is_durable(config: dict) -> bool:
    return "journal_arg" in config


def contents_of(holder) -> dict:
    """The holder's dictionary: its ``items()``, or, for a durable tree,
    which has none, its tree's."""
    return holder.items() if hasattr(holder, "items") else holder.tree.items()


def counters(holder) -> dict:
    st = holder.stats()
    reg = holder.metrics
    return {"eliminated": st["eliminated"], "retry_passes": reg.value("retry_passes"),
            "flush_bytes": st.get("flush_bytes"),
            "commits": len(reg.histogram_values("commit_latency_s"))}


def sync_of(device: torch.device):
    return torch.cuda.synchronize if device.type == "cuda" else (lambda: None)


# ----------------------------------------------------------------------------
# the run
# ----------------------------------------------------------------------------


class Run:
    """The rounds one run drove and what came back: every round that
    answered, and so was acknowledged, in ``history``."""

    def __init__(self):
        self.history = []  # (Round, RoundOutput | None, in_window)
        self.round_ms: List[float] = []
        self.error: Optional[str] = None

    def drive(self, holder, rnd, cap: int, sync, in_window: bool) -> Optional[float]:
        t0 = time.perf_counter()
        try:
            out = holder.apply_round(rnd.ops, rnd.keys, rnd.vals, scan_cap=cap)
            sync()
        except Exception as e:  # the round never answered: its lanes fail
            self.error = f"{type(e).__name__}: {e}"
            self.history.append((rnd, None, in_window))
            return None
        ms = (time.perf_counter() - t0) * 1e3
        self.history.append((rnd, out, in_window))
        if in_window:
            self.round_ms.append(ms)
        return ms


class Drawn:
    """Rounds of a mix drawn in set-up, ahead of the window, so that the
    window times the program alone.  A round past them is drawn when it is
    asked for, and counted in ``late``."""

    def __init__(self, gen: Generator, r0: int, n: int):
        self.gen, self.r0 = gen, r0
        self.rounds = [gen.round(r) for r in range(r0, r0 + n)]
        self.late = 0

    def round(self, r: int):
        i = r - self.r0
        if 0 <= i < len(self.rounds):
            return self.rounds[i]
        self.late += 1
        return self.gen.round(r)


def rounds_ahead(seconds: float, warmup_ms: List[float], max_rounds: Optional[int]) -> int:
    """Rounds to draw ahead of a window of ``seconds``: a quarter more than
    rounds as fast as the fastest warm-up round would fill, and the traced
    run's stretches; no more than ``max_rounds`` of them where the window
    ends there."""
    fastest = max(min(warmup_ms), 1.0) if warmup_ms else 10.0
    n = int(1.25 * seconds * 1e3 / fastest) + PROFILE_ROUNDS + SPAN_ROUNDS
    return n if max_rounds is None else min(n, max_rounds)


class Collector:
    """Collections of Python's cyclic collector and their pauses, per
    generation, while it is entered (``gc.callbacks``)."""

    def __init__(self):
        self.n = [0, 0, 0]
        self.s = [0.0, 0.0, 0.0]
        self._t0 = None

    def __call__(self, phase: str, info: dict):
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            g = info["generation"]
            self.n[g] += 1
            self.s[g] += time.perf_counter() - self._t0
            self._t0 = None

    def __enter__(self):
        gc.callbacks.append(self)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self)

    def summary(self) -> dict:
        return {"collections": list(self.n), "pause_s": list(self.s)}


def timed_window(run: Run, holder, rounds, r0: int, seconds: float, cap: int, sync,
                 max_rounds: Optional[int] = None) -> int:
    """Rounds back to back until ``seconds`` have passed (or ``max_rounds``
    rounds have run); returns the next round index."""
    w0 = time.perf_counter()
    r = r0
    while time.perf_counter() - w0 < seconds and (max_rounds is None or r - r0 < max_rounds):
        if run.drive(holder, rounds.round(r), cap, sync, True) is None:
            break
        r += 1
    return r


def traced_window(run: Run, holder, rounds, r0: int, seconds: float, cap: int, sync,
                  device: torch.device) -> tuple:
    """The traced run's window: a profiled stretch with profiler labels for
    the engine's spans, then rounds under the program's own tracer until
    ``seconds`` have passed.  Returns the next round index, the profile
    (read once the window has closed), the profiled rounds' lanes (each
    with its place in the history) and the tracer's events."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.obs.tracer import Tracer

    w0 = time.perf_counter()
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    own = holder.tracer
    holder.tracer = tracing.LabelTracer()
    shapes = []
    r = r0
    with profile(activities=activities) as prof:
        time.sleep(PROFILE_MARGIN_S)
        with torch.profiler.record_function(tracing.STRETCH):
            for _ in range(PROFILE_ROUNDS):
                rnd = rounds.round(r)
                if run.drive(holder, rnd, cap, sync, True) is None:
                    break
                out = run.history[-1][1]
                rl = rnd.ops == OP_RANGE
                rows = int(out.scan.count.numpy()[rl].sum()) if out.scan is not None else 0
                shapes.append({"at": len(run.history) - 1, "cap": cap, "rows": rows,
                               "range_lanes": int(rl.sum()),
                               "point_lanes": int(((rnd.ops != OP_NOP) & ~rl).sum())})
                r += 1
            sync()
        time.sleep(PROFILE_MARGIN_S)
    tracer = holder.tracer = Tracer()
    for _ in range(SPAN_ROUNDS):
        if run.error is not None or run.drive(holder, rounds.round(r), cap, sync, True) is None:
            break
        r += 1
    if run.error is None:
        r = timed_window(run, holder, rounds, r, max(0.0, seconds - (time.perf_counter() - w0)),
                         cap, sync)
    holder.tracer = own
    return r, prof, shapes, tracer.events


def crash(run: Run, holder, gen: Generator, r: int, cap: int, sync) -> Optional[dict]:
    """Crash a durable holder through the program's own fault plan: a
    fail-stop armed at the next manifest write, then rounds of the mix
    (after the window) until one dies in its commit.  That round never
    answered, so it stays out of the history; the rounds before it answered.
    Returns the rounds of the commit group pending before the crashing
    round, or None if no round crashed."""
    from repro_torch import core

    holder.crash = core.FaultPlan(specs=[core.FaultSpec("manifest_write", "crash", times=1)])
    for _ in range(CRASH_ROUNDS):
        pending = holder.durability_status()["pending_rounds"]
        rnd = gen.round(r)
        r += 1
        try:
            out = holder.apply_round(rnd.ops, rnd.keys, rnd.vals, scan_cap=cap)
            sync()
        except core.SimulatedCrash:
            return {"pending_rounds": pending}
        run.history.append((rnd, out, False))
    run.error = f"no crash within {CRASH_ROUNDS} rounds of arming it"
    return None


def journal_size(path: str) -> dict:
    files = nbytes = 0
    for root, _, names in os.walk(path):
        for name in names:
            files += 1
            nbytes += os.path.getsize(os.path.join(root, name))
    return {"journal_files": files, "journal_bytes": nbytes}


def run_cell(spec_path, workload: str, seed: int, seconds: float, trace: bool, *,
             device="cuda", t_start: Optional[float] = None, bench_dir: Path = BENCH_DIR,
             config_override: Optional[dict] = None, mix_override: Optional[dict] = None,
             max_rounds: Optional[int] = None, make=make_holder,
             log=lambda msg: print(msg, file=sys.stderr, flush=True)) -> dict:
    """One run of ``workload``; the result line's fields, ``checks`` last.
    ``config_override`` / ``mix_override`` replace keys of the configuration
    and the mix (the tests' small sizes), ``max_rounds`` ends the window
    after that many rounds, and ``make(config, device, journal)`` builds
    the holder (the control runs put a reference with a broken guarantee in
    the program's place)."""
    from repro_torch import core

    t_start = time.perf_counter() if t_start is None else t_start
    device = torch.device(device)
    sync = sync_of(device)
    c = resolve(spec_path, workload, bench_dir)
    config = dict(c["config"], **(config_override or {}))
    mix = dict(c["mix"], **(mix_override or {}))
    gen = Generator(seed, config, mix)
    cap = gen.scan_cap()
    durable = is_durable(config)
    journal = tempfile.mkdtemp(prefix="bench-journal-") if durable else None
    run = Run()
    data = {"cell": workload, "config": config, "mix": mix}
    shapes = []
    try:
        holder = make(config, device, journal)
        t_load = time.perf_counter()
        for rnd in load_rounds(seed, config):
            if run.drive(holder, rnd, cap, sync, False) is None:
                break
        data["load_s"] = time.perf_counter() - t_load
        warm = []
        r = 0
        while run.error is None and r < int(mix.get("warmup_rounds", 0)):
            ms = run.drive(holder, gen.round(r), cap, sync, False)
            if ms is not None:
                warm.append(ms)
            r += 1
        rounds = Drawn(gen, r, rounds_ahead(seconds, warm, max_rounds))
        sync()
        gc.collect()
        setup_s = time.perf_counter() - t_start
        log(f"{workload}: set-up {setup_s:.1f} s, {len(run.history)} rounds, "
            f"{len(rounds.rounds)} drawn ahead")
        before = counters(holder)
        with Collector() as collector:
            w0 = time.perf_counter()
            if run.error is not None:
                pass
            elif trace:
                r, profiled, shapes, span_events = traced_window(run, holder, rounds, r, seconds,
                                                                 cap, sync, device)
            else:
                r = timed_window(run, holder, rounds, r, seconds, cap, sync, max_rounds)
            window_s = time.perf_counter() - w0
        after = counters(holder) if run.error is None else before
        window = [rnd for rnd, _, inw in run.history if inw]
        lanes = int(sum(int((rnd.ops != OP_NOP).sum()) for rnd in window))
        updates = int(sum(int(((rnd.ops == OP_INSERT) | (rnd.ops == OP_DELETE)).sum())
                          for rnd in window))
        data.update(setup_s=setup_s, window={
            "seconds": window_s, "rounds": len(window), "lanes": lanes, "update_lanes": updates,
            "round_ms": list(run.round_ms), "drawn_late": rounds.late})
        data["gc"] = collector.summary()
        data["counters"] = {k: (None if after[k] is None else after[k] - before[k])
                            for k in ("eliminated", "retry_passes", "flush_bytes")}
        data["counters"]["commit_latency_s"] = (
            holder.metrics.histogram_values("commit_latency_s")[before["commits"]:] if durable else None)
        log(f"{workload}: window {window_s:.1f} s, {len(window)} rounds")
        if durable:
            if run.error is None:
                data["crash"] = crash(run, holder, gen, r, cap, sync)
            if data.get("crash") is not None:
                data["crash"].update(journal_size(journal))
        else:
            contents = contents_of(holder) if run.error is None else {}
        del holder
        gc.collect()
        if durable:
            t0 = time.perf_counter()
            try:
                rec = core.recover(journal, device=device)
                sync()
            except Exception as e:  # no acknowledged round came back
                run.error = run.error or f"recovery: {type(e).__name__}: {e}"
                contents = {}
            else:
                data["recover_s"] = time.perf_counter() - t0
                phases = dict(rec.recovery_timings)
                phases["other_s"] = data["recover_s"] - sum(phases.values())
                data["recovery"] = phases
                contents = contents_of(rec)
                rec.close()
                del rec
                gc.collect()
        peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
        if trace and run.error is None:
            data["profile"] = tracing.reduce_profile(profiled.events(), roofline.kernel_of)
            data["spans"] = tracing.span_totals(span_events)
    finally:
        if journal is not None:
            shutil.rmtree(journal, ignore_errors=True)

    t_ref = time.perf_counter()
    check = Check(Dictionary())
    at = {s["at"]: s for s in shapes}
    b = int(config["tree"]["b"])
    for i, (rnd, out, inw) in enumerate(run.history):
        if i in at:  # a profiled round: the tree it ran on, from the reference
            points = rnd.keys[(rnd.ops != OP_NOP) & (rnd.ops != OP_RANGE)]
            at[i].update(roofline.tree_shape(check.ref.sorted_items()[0], points, b))
        check.round(rnd, out, cap, inw)
    wrong_contents = check.contents(contents)
    log(f"{workload}: reference {time.perf_counter() - t_ref:.1f} s")
    if data.get("profile"):
        least = {}
        for shape in shapes:
            for k, s in roofline.round_least_s(shape).items():
                least[k] = least.get(k, 0.0) + s
        data["profile"].update(least_s=least, rounds=len(shapes))
    checks = {
        "point_lanes_wrong": {"value": check.point_wrong, "limit": 0},
        "range_lanes_wrong": {"value": check.range_wrong, "limit": 0},
        ("recovered_keys_wrong" if durable else "contents_keys_wrong"):
            {"value": wrong_contents, "limit": 0},
        "run_errors": {"value": int(run.error is not None), "limit": 0},
    }
    correct = all(v["value"] <= v["limit"] for v in checks.values())

    metrics: Dict[str, dict] = {}
    if run.error is None:
        for m in (c["per_layer"] if trace else c["end_to_end"]):
            value = reader(c["bench_dir"], m["name"])(data)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else device.type,
           "count": 1, "memory_peak_bytes": int(peak) if run.error is None else 0}
    result = {"correct": correct, "attempted": data.get("window", {}).get("lanes", 0),
              "failed": check.window_wrong, "metrics": metrics, "device": dev}
    if trace and data.get("profile"):
        dev["busy_s"] = data["profile"]["busy_s"]
        dev["window_s"] = data["profile"]["window_s"]
        result["breakdown"] = {"device_ops": data["profile"]["device_ops"],
                               "idle_gaps": data["profile"]["idle_gaps"]}
    result["workload"] = workload
    result["seed"] = seed
    result["rounds"] = data.get("window", {}).get("rounds", 0)
    result["load_s"] = data.get("load_s")
    result["drawn_late"] = data.get("window", {}).get("drawn_late", 0)
    result["gc"] = data.get("gc")
    result["host_threads"] = torch.get_num_threads()
    result["host_rss_peak_bytes"] = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    result["host_write_bytes"] = written_bytes()
    result["round_ms"] = [round(ms, 3) for ms in run.round_ms]
    if "recovery" in data:
        result["recovery"] = dict(data["recovery"], recover_s=data["recover_s"])
    if data.get("crash") is not None:
        result["crash"] = data["crash"]
    if run.error is not None:
        result["error"] = run.error
    result["checks"] = checks
    return result


def written_bytes() -> Optional[int]:
    """Bytes this process has passed to ``write`` calls (files, any
    filesystem), or None where the kernel does not say."""
    try:
        with open("/proc/self/io") as f:
            return int(next(line for line in f if line.startswith("wchar")).split()[1])
    except (OSError, StopIteration, ValueError):
        return None


def forbidden_modules() -> List[str]:
    """Top-level names of loaded modules that no run may hold."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
