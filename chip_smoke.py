#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port of the Elim-ABtree.

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py

It builds the port's four hand-written CUDA kernels from ``src/repro_torch/
csrc`` (one ``nvcc`` per source, in parallel, into ``build/``), then:

1. prints the card's name and power limit;
2. drives the port's main path, ``ABTree.apply_round`` in elim mode on one
   tree at the paper's b = 11 with int64 keys and values: prefill of half
   the key range in insert rounds of 65,536 lanes, then warm-up and measured
   mixed rounds of 16,384 lanes (Zipf(1.0) keys; 45% insert, 45% delete,
   5% find, 5% range with span uniform in [1, 64]; scan cap 128).  Every
   round is checked lane for lane against ``DictOracle.apply_mixed_round``
   and the tree against ``check_invariants`` at the end.  The launch count
   of every kernel is zeroed before the main path and read after it;
3. replays one main-path call of each kernel: kernel and plain PyTorch
   version on the same CUDA tensors must agree bit for bit; both are timed
   with CUDA events, beside the least time the card needs to move the
   call's bytes (3.35 TB/s) and, for range_scan, ``torch.topk`` over the
   masked keys as the nearest library yardstick;
4. prints ``{"ok": true, "device": {...}}`` as its last line.

Any failed check raises, so the script exits non-zero.  Without a CUDA card,
or without the repository's ``src/repro_torch`` beside it, it exits 2 and
prints no result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PREFILL_BATCH = 65_536  # lanes per prefill insert round
BATCH = 16_384  # lanes per mixed round
WARMUP, ROUNDS, TRACED_ROUNDS, RECORDER_OFF_ROUNDS = 3, 20, 3, 5
# keys are drawn from [0, KEY_RANGE) and half of it is prefilled; if the run
# outgrows its time limit this is the scale to halve, and the cut goes into
# PERF.md.
KEY_RANGE = 2_000_000
SEED = 0


def log(msg: str) -> None:
    print(f"[chip_smoke {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr, flush=True)


# ----------------------------------------------------------------------------
# main path
# ----------------------------------------------------------------------------


def mixed_round(rng, batch: int, key_range: int, zipf_keys, ops_mod):
    """One round of the skewed update-heavy mix (ycsb_e_stream's encoding
    for range lanes: key = lo, val = span)."""
    keys = zipf_keys(rng, batch, key_range, 1.0)
    u = rng.random(batch)
    ops = np.select(
        [u < 0.45, u < 0.90, u < 0.95],
        [ops_mod.OP_INSERT, ops_mod.OP_DELETE, ops_mod.OP_FIND],
        ops_mod.OP_RANGE,
    ).astype(np.int32)
    spans = rng.integers(1, 65, batch).astype(np.int64)
    vals = np.where(ops == ops_mod.OP_RANGE, spans, rng.integers(0, 1 << 40, batch)).astype(np.int64)
    return ops, keys, vals


def check_round(out, want, ops, range_code, round_name: str) -> None:
    """Lane-for-lane comparison of one round with the oracle's answer."""
    res, fnd, scans = want
    got_res = out.results.numpy()
    got_fnd = out.found.numpy()
    if not np.array_equal(got_res, np.asarray(res, np.int64)):
        bad = int(np.nonzero(got_res != np.asarray(res, np.int64))[0][0])
        raise AssertionError(f"{round_name}: lane {bad} result {got_res[bad]} != oracle {res[bad]}")
    if not np.array_equal(got_fnd, np.asarray(fnd, bool)):
        raise AssertionError(f"{round_name}: found flags differ from the oracle")
    rl = np.nonzero(ops == range_code)[0]
    if rl.size:
        cnt = out.scan.count.numpy()
        sk = out.scan.keys.numpy()
        sv = out.scan.vals.numpy()
        for i in rl.tolist():
            n = int(cnt[i])
            got = list(zip(sk[i, :n].tolist(), sv[i, :n].tolist()))
            if got != scans[i]:
                raise AssertionError(f"{round_name}: range lane {i} rows differ from the oracle")


def run_main_path(torch, core, lib, zipf_keys):
    """Prefill + mixed rounds on the card, oracle-checked.  Returns the
    run's summary and the launch arguments each kernel got in the last
    round."""
    from repro_torch.core.oracle import check_invariants
    from repro_torch.obs.recorder import Recorder
    from repro_torch.obs.tracer import NULL_TRACER, Tracer

    dev = torch.device("cuda")
    cfg = core.TreeConfig(capacity=1 << 16, b=11, a=2, max_height=24)
    rng = np.random.default_rng(SEED)
    tree = core.ABTree(cfg, mode="elim")
    oracle = core.DictOracle()
    torch.cuda.reset_peak_memory_stats(dev)
    lib.reset_counts()

    n_prefill = KEY_RANGE // 2
    prefill = rng.choice(KEY_RANGE, size=n_prefill, replace=False).astype(np.int64)
    t0 = time.perf_counter()
    for i in range(0, n_prefill, PREFILL_BATCH):
        chunk = prefill[i : i + PREFILL_BATCH]
        ops = np.full(chunk.size, core.OP_INSERT, np.int32)
        vals = rng.integers(0, 1 << 40, chunk.size).astype(np.int64)
        out = tree.apply_round(ops, chunk, vals)
        check_round(out, oracle.apply_mixed_round(ops, chunk, vals), ops, core.OP_RANGE, f"prefill {i}")
        log(f"prefill {i + chunk.size}/{n_prefill}: {time.perf_counter() - t0:.1f}s, "
            f"{int(tree.stacked.alloc.sum())} nodes")
    prefill_s = time.perf_counter() - t0

    m = tree.metrics
    counters = {n: lib.COUNTERS[n] for n in lib.SOURCES}
    recorded = {}

    def drive(n_rounds, name, record_last=False):
        """``n_rounds`` oracle-checked mixed rounds; per-round wall ms and
        structural work."""
        ms, work = [], []
        for r in range(n_rounds):
            ops, keys, vals = mixed_round(rng, BATCH, KEY_RANGE, zipf_keys, core)
            last = record_last and r == n_rounds - 1
            if last:  # record the launch arguments for the replay
                for c in counters.values():
                    c.calls = []
            before = (m.value("retry_passes"), m.value("split_waves"), m.value("underfull_waves"))
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            out = tree.apply_round(ops, keys, vals, scan_cap=128)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t1) * 1e3)
            if last:
                for cname, c in counters.items():
                    recorded[cname], c.calls = c.calls, None
            after = (m.value("retry_passes"), m.value("split_waves"), m.value("underfull_waves"))
            work.append([x - y for x, y in zip(after, before)])
            want = oracle.apply_mixed_round(ops, keys, vals, cap=128)
            check_round(out, want, ops, core.OP_RANGE, f"{name} round {r}")
        return ms, np.asarray(work, np.float64)

    def traced_breakdown(name):
        """Per-round span totals over TRACED_ROUNDS rounds with the phase
        tracer on (it fences every span, so these rounds are not timed)."""
        tree.tracer = Tracer()
        drive(TRACED_ROUNDS, name)
        phase = {}
        for ev in tree.tracer.events:
            if ev["ph"] == "X":
                phase[ev["name"]] = phase.get(ev["name"], 0.0) + ev["dur"] / 1e3 / TRACED_ROUNDS
        tree.tracer = NULL_TRACER
        return phase

    drive(WARMUP, "warm-up")
    round_ms, work = drive(ROUNDS, "measured", record_last=True)
    traced_on = traced_breakdown("traced")
    # the flight recorder is on by default (as in the JAX engine); the same
    # traffic with it off shows what it costs per round.
    tree.recorder = Recorder(enabled=False)
    round_ms_off, _ = drive(RECORDER_OFF_ROUNDS, "recorder-off")
    traced_off = traced_breakdown("traced recorder-off")
    launches = {n: c.launches for n, c in counters.items()}

    st = tree.state
    check_invariants(st, tree.cfg)
    if tree.items() != oracle.items():
        raise AssertionError("tree contents differ from the oracle after the run")
    stats = tree.stats()
    summary = {
        "config": {"b": cfg.b, "a": cfg.a, "max_height": cfg.max_height,
                   "key_range": KEY_RANGE, "prefill_keys": n_prefill,
                   "prefill_batch": PREFILL_BATCH, "batch": BATCH,
                   "warmup": WARMUP, "rounds": ROUNDS, "scan_cap": 128,
                   "mix": "45% insert, 45% delete, 5% find, 5% range span U[1,64], Zipf(1.0)"},
        "prefill_s": prefill_s,
        "ops_per_s": BATCH * len(round_ms) / (sum(round_ms) / 1e3),
        "round_ms_p50": float(np.percentile(round_ms, 50)),
        "round_ms_p99": float(np.percentile(round_ms, 99)),
        "round_ms": round_ms,
        "retry_passes_per_round": float(work[:, 0].mean()),
        "split_waves_per_round": float(work[:, 1].mean()),
        "underfull_waves_per_round": float(work[:, 2].mean()),
        "round_ms_p50_recorder_off": float(np.percentile(round_ms_off, 50)),
        "round_ms_recorder_off": round_ms_off,
        "height": int(st.height),
        "live_nodes": int(st.alloc.sum()),
        "pool_rows": int(st.alloc.shape[0]),
        "live_keys": len(oracle.d),
        "eliminated": stats["eliminated"],
        "max_memory_allocated": int(torch.cuda.max_memory_allocated(dev)),
        "launches": launches,
        "traced_rounds": TRACED_ROUNDS,
        "traced_ms_per_round": traced_on,
        "traced_ms_per_round_recorder_off": traced_off,
    }
    return summary, recorded


# ----------------------------------------------------------------------------
# kernels against their plain versions
# ----------------------------------------------------------------------------


def time_ms(torch, fn, iters: int, warmup: int = 3) -> float:
    """Per-call time of back-to-back calls issued from Python (CUDA events):
    what a caller pays, host launch cost included."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(torch, fn, iters: int = 20, reps: int = 5) -> float:
    """Device time per call: ``iters`` calls captured in one CUDA graph and
    replayed ``reps`` times, so host launch cost drops out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * reps)


def max_abs_err(torch, got, want) -> float:
    err = 0.0
    for g, w in zip(got, want):
        if not torch.equal(g, w):
            diff = (g.to(torch.float64) - w.to(torch.float64)).abs().max()
            err = max(err, float(diff))
    return err


def descend_bytes(torch, pool_keys, children, is_leaf, root, queries, max_height):
    """Bytes a descent + probe must move for these queries, each read once:
    per distinct internal row visited, its leaf flag and b-1 routers; one
    child id per distinct (row, taken index); per distinct leaf reached, its
    flag and the keys up to the last slot any of its queries must compare
    (the hit, or all b on a miss); one value per distinct (leaf, slot) hit;
    the root ids, the queries and the outputs."""
    s, n, b = pool_keys.shape
    keys_f = pool_keys.reshape(s * n, b)
    ch_f = children.reshape(s * n, b)
    leaf_f = is_leaf.reshape(-1)
    base = (torch.arange(s, device=queries.device) * n)[:, None]
    node = root.to(torch.int64)[:, None].expand(queries.shape).clone()
    internal, taken = set(), set()
    for _ in range(max_height):
        g = node + base
        lf = leaf_f[g]
        if bool(lf.all()):
            break
        idx = (keys_f[g][..., : b - 1] <= queries[..., None]).sum(-1)
        internal.update(torch.unique(g[~lf]).tolist())
        taken.update(torch.unique((g * b + idx)[~lf]).tolist())
        child = ch_f[g, idx].to(torch.int64)
        child = torch.where(child < 0, n - 1, child)
        node = torch.where(lf, node, child)
    g = (node + base).reshape(-1)
    hit = keys_f[g] == queries.reshape(-1, 1)
    found = hit.any(-1)
    slot = hit.to(torch.uint8).argmax(-1)
    leaves, inv = torch.unique(g, return_inverse=True)
    compared = torch.zeros(leaves.numel(), dtype=torch.int64, device=g.device)
    compared.scatter_reduce_(0, inv, torch.where(found, slot + 1, b), "amax")
    hits = torch.unique((g * b + slot)[found]).numel()
    pool = (len(internal) * ((b - 1) * 8 + 1) + len(taken) * 4
            + leaves.numel() + int(compared.sum()) * 8 + hits * 8)
    return pool + queries.numel() * (8 + 4 + 1 + 4 + 8) + s * 4


def kernel_report(torch, mods, summary, recorded):
    """Replay one main-path call per kernel against its plain version."""
    td_kernel, td_ref, td_ops, ec_kernel, ec_ref, rs_kernel, rs_ref = mods
    rows = []

    def entry(name, source, replaces, got, want, k_fn, p_fn, nbytes, shapes, lib_ms=None):
        err = max_abs_err(torch, got, want)
        if err != 0.0:
            raise AssertionError(f"{name}: kernel differs from its plain version (max |err| {err})")
        k_ms = graph_ms(torch, k_fn)
        rows.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": summary["launches"][name], "max_abs_err": err, "equal": True,
            "ms": k_ms, "kernel_ms": k_ms, "call_ms": time_ms(torch, k_fn, 200),
            "plain_ms": graph_ms(torch, p_fn), "plain_call_ms": time_ms(torch, p_fn, 20),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "bytes": int(nbytes), "library_ms": lib_ms, "shapes": shapes,
        })

    # K1 descend_probe: the search phase's call (first of the round)
    pk, pv, ch, lf, root, q, kw = recorded["descend_probe"][0]
    entry(
        "descend_probe", "src/repro_torch/csrc/descend_probe.cu",
        "src/repro/kernels/tree_descend/kernel.py:95",
        td_kernel.descend_probe_cuda(pk, pv, ch, lf, root, q, **kw),
        td_ref.descend_probe_ref(pk, pv, ch, lf, root, q, **kw),
        lambda: td_kernel.descend_probe_cuda(pk, pv, ch, lf, root, q, **kw),
        lambda: td_ref.descend_probe_ref(pk, pv, ch, lf, root, q, **kw),
        descend_bytes(torch, pk, ch, lf, root, q, kw["max_height"]),
        {"pool": list(pk.shape), "queries": list(q.shape)},
    )

    # K2 frontier_compact: the call with the most valid candidates
    calls = recorded["frontier_compact"]
    cand, valid, kw = max(calls, key=lambda c: int(c[1].sum()))
    f = kw["f"]
    scratch = -7  # any id: both versions are finished by the same wrapper
    entry(
        "frontier_compact", "src/repro_torch/csrc/frontier_compact.cu",
        "src/repro/kernels/tree_descend/kernel.py:187",
        td_ops.finish_compact(*td_kernel.frontier_compact_cuda(cand, valid, f), f, scratch),
        td_ops.finish_compact(*td_ref.frontier_compact_plain(cand, valid, f), f, scratch),
        lambda: td_kernel.frontier_compact_cuda(cand, valid, f),
        lambda: td_ref.frontier_compact_plain(cand, valid, f),
        cand.numel() * 5 + cand.shape[0] * (f + 1) * 4,
        {"cand": list(cand.shape), "f": f},
    )

    # K3 elim_combine: the round's combine
    ops, vals, head, p0, v0, _ = recorded["elim_combine"][0]
    entry(
        "elim_combine", "src/repro_torch/csrc/elim_combine.cu",
        "src/repro/kernels/elim_combine/kernel.py:150",
        ec_kernel.elim_combine_cuda(ops, vals, head, p0, v0),
        ec_ref.elim_combine_ref(ops, vals, head, p0, v0),
        lambda: ec_kernel.elim_combine_cuda(ops, vals, head, p0, v0),
        lambda: ec_ref.elim_combine_ref(ops, vals, head, p0, v0),
        ops.numel() * (4 + 8 + 1 + 1 + 8 + 1 + 8 + 1 + 8),
        {"ops": list(ops.shape)},
    )

    # K4 range_scan: the round's accepted gather (the last call)
    ck, cv, lo, hi, kw = recorded["range_scan"][-1]
    cap = kw["cap"]
    want = rs_ref.range_scan_ref(ck, cv, lo, hi, cap)
    emitted = int(want[2].sum())
    empty = torch.iinfo(torch.int64).max
    key_m = torch.where((ck >= lo[:, None]) & (ck < hi[:, None]) & (ck != empty), ck, empty)
    k = min(cap, ck.shape[1])
    lib_ms = graph_ms(torch, lambda: torch.topk(key_m, k, dim=1, largest=False, sorted=True))
    entry(
        "range_scan", "src/repro_torch/csrc/range_scan.cu",
        "src/repro/kernels/range_scan/kernel.py:138",
        rs_kernel.range_scan_cuda(ck, cv, lo, hi, cap=cap),
        want,
        lambda: rs_kernel.range_scan_cuda(ck, cv, lo, hi, cap=cap),
        lambda: rs_ref.range_scan_ref(ck, cv, lo, hi, cap),
        ck.numel() * 8 + ck.shape[0] * (16 + cap * 16 + 5) + emitted * 8,
        {"cand": list(ck.shape), "cap": cap},
        lib_ms=lib_ms,
    )
    for row in rows:
        if row["launches"] <= 0:
            raise AssertionError(f"{row['name']}: never launched on the main path")
    return rows


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print("chip_smoke: src/repro_torch not found beside chip_smoke.py", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch.core as core
    from repro_torch.data.workloads import zipf_keys
    from repro_torch.kernels import _lib as lib
    from repro_torch.kernels.elim_combine import kernel as ec_kernel, ref as ec_ref
    from repro_torch.kernels.range_scan import kernel as rs_kernel, ref as rs_ref
    from repro_torch.kernels.tree_descend import kernel as td_kernel, ops as td_ops, ref as td_ref

    # 1. set-up: build every kernel, name the card
    t0 = time.perf_counter()
    lib.build_all()
    log(f"kernels built in {time.perf_counter() - t0:.1f}s")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    print(f"{smi} | torch.cuda.get_device_name(0) = {kind}", flush=True)

    # 2. the main path at full width
    summary, recorded = run_main_path(torch, core, lib, zipf_keys)
    print(json.dumps({"main_path": summary, "card": smi}), flush=True)

    # 3. every kernel against its plain version at main-path shapes
    rows = kernel_report(
        torch, (td_kernel, td_ref, td_ops, ec_kernel, ec_ref, rs_kernel, rs_ref), summary, recorded
    )
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
