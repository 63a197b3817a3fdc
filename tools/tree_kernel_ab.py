#!/usr/bin/env python3
"""Old/new A/B of the tree kernels K1 (descend_probe), K2
(frontier_compact), K3 (elim_combine), K4 (range_scan) and the leaf probe
B5 (leaf_probe) on one CUDA card.

Run from the root of a checkout, on a machine with one card:

    mkdir -p build/ab/old
    for k in descend_probe frontier_compact elim_combine range_scan leaf_probe; do
      git show <commit>:src/repro_torch/csrc/$k.cu > build/ab/old/$k.cu
    done
    python3 tools/tree_kernel_ab.py --old build/ab/old

``--kernels`` picks some of the five (default all; only their sources need
be in ``--old``): the leaf probe's first design, one thread a row, is
``git show b2c7b19:src/repro_torch/csrc/leaf_probe.cu``, and
``--kernels leaf_probe`` times it alone against the build.

To time a variant of a kernel, put its edited source in the ``--old``
directory.  The tool drives ``chip_smoke.py``'s tree path once (the same
prefill and mixed rounds, each checked against the oracle) to record the
main path's K1-K4 calls, records K1's call in a serving index's prefix
lookup (``chip_smoke.py``'s serve requests published into the port's
``PrefixIndex``, b = 8, as the engine admits them, then the hot request's
lookup), and records K2's and K4's calls in a session index's sweep (the
serve requests' ids published into a ``SessionIndex``, b = 8, then one
``evict_range`` over them at its cap of 256).  B5 runs over the leaf rows
that K1 reached in those two calls (16,384 x 11 and 8 x 8, int64), as
``chip_smoke.py`` replays it.  It builds the old sources
beside the port's own build ("new"), holds both bit-equal to the plain
version on every case, and times each as CUDA-graph replays
(``chip_smoke.graph_ms``) in turns, the order reversed every other pass.
K3 is also timed on seeded inputs of other widths.  The old K1, K3 and B5
take the current entry points.  The old K2 and K4 take either the current
ones or those of their first designs (a K2 that wrote only raw slots and
row totals, a K4 that took its shared-memory width, as in commit 673b980):
an old ``range_scan`` library that exports ``range_scan_scratch_pairs``
has the current entry points, one that does not the first designs', and
the old ``frontier_compact`` is taken to be of the same sources.  An old
K2 of the first design runs together with the wrapper's old finish
(arange, compare, ``where`` against the scratch id, ``total > f``) so both
sides compute the finished triple; in a graph the scratch id is a device
tensor made beforehand, since the old wrapper's host-to-device copy cannot
be captured, and ``call_ms`` (back-to-back eager calls,
``chip_smoke.time_ms``) times the old wrapper as it was, copy included.
Either way both sides are held bit-equal to the plain version before they
are timed.
``floor_ms`` is one minimal kernel (a 1-element add) replayed the same
way.  Prints one JSON object (medians over the passes, with the card's
name and power limit), and with ``--out PATH`` also writes it there.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke  # noqa: E402

PASSES = 4
K3_WIDTHS = ((1, 1), (1, 2048), (1, 65_536), (3, 16_384))
KERNELS = ("descend_probe", "frontier_compact", "elim_combine", "range_scan", "leaf_probe")
CALL_ITERS = 200


def serve_lookup_call(torch, lib, dev):
    """K1's recorded call in the serve phase's prefix lookup: the serve
    requests' prompt blocks published into a ``PrefixIndex`` on ``dev`` as
    the engine admits them (a lookup, then a publish of the missed blocks),
    then the hot request's lookup."""
    from repro_torch.serve.pages import PrefixIndex, prefix_hashes

    from repro_torch.configs import get_config

    index = PrefixIndex(device=dev)
    page = 0
    reqs = chip_smoke.serve_requests(get_config(chip_smoke.SERVE_ARCH).vocab)
    chains = [prefix_hashes(prompt) for _, prompt, _ in reqs]
    for chain in chains:
        hashes = [h for h, _ in chain]
        hits = index.lookup_batch(hashes)
        n_hit = next((i for i, x in enumerate(hits) if x is None), len(hits))
        if hashes[n_hit:]:
            index.publish_batch(hashes[n_hit:], list(range(page, page + len(hashes) - n_hit)))
            page += len(hashes) - n_hit
    counter = lib.counter("descend_probe")
    counter.calls = []
    hot = next(c for c, (_, _, is_hot) in zip(chains, reqs) if is_hot)
    index.lookup_batch([h for h, _ in hot])
    call, counter.calls = counter.calls[0], None
    return call


def serve_sweep_calls(torch, lib, dev):
    """K2's and K4's recorded calls in the serve phase's session sweep: the
    serve requests' ids published into a ``SessionIndex`` on ``dev``, then
    one ``evict_range`` over them at its default cap (256).  Returns the K2
    call with the most valid candidates and the K4 call."""
    from repro_torch.serve.pages import SessionIndex

    index = SessionIndex(device=dev)
    rids = list(range(chip_smoke.SERVE_REQUESTS))
    index.publish_batch(rids, [10 * r for r in rids])
    counters = {n: lib.counter(n) for n in ("frontier_compact", "range_scan")}
    for c in counters.values():
        c.calls = []
    freed = index.evict_range(0, len(rids))
    calls = {n: c.calls for n, c in counters.items()}
    for c in counters.values():
        c.calls = None
    if freed != [10 * r for r in rids]:
        raise AssertionError(f"session sweep freed {freed}")
    return (max(calls["frontier_compact"], key=lambda c: int(c[1].sum())),
            calls["range_scan"][0])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", type=Path, required=True,
                    help="directory with the previous sources of the kernels to time")
    ap.add_argument("--kernels", default=",".join(KERNELS),
                    help=f"comma-separated subset of {','.join(KERNELS)}")
    ap.add_argument("--out", type=Path, help="also write the result to this JSON file")
    args = ap.parse_args(argv)
    selected = args.kernels.split(",")
    if not set(selected) <= set(KERNELS):
        ap.error(f"--kernels: unknown {sorted(set(selected) - set(KERNELS))}")

    import torch

    if not torch.cuda.is_available():
        print("tree_kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    import repro_torch.core as core
    from repro_torch.data.workloads import zipf_keys
    from repro_torch.kernels import _lib as lib
    from repro_torch.kernels.elim_combine import ref as ec_ref
    from repro_torch.kernels.range_scan import ref as rs_ref
    from repro_torch.kernels.tree_descend import ref as td_ref

    libs = lib.build_all()
    out_dir = lib.BUILD_DIR / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for kernel in selected:
        out = out_dir / f"{kernel}_old.so"
        jobs[f"{kernel}:old"] = ([lib._nvcc(), *lib.NVCC_FLAGS, "-o", str(out),
                                  str(args.old / f"{kernel}.cu")], out)
    procs = {n: subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for n, (cmd, _) in jobs.items()}
    for n, p in procs.items():
        out, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {n}:\n{out.decode(errors='replace')}")
    paths = {n: o for n, (_, o) in jobs.items()}
    paths.update({f"{k}:new": libs[k] for k in selected})

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    summary, recorded = chip_smoke.run_main_path(torch, core, lib, zipf_keys)[:2]
    dev = torch.device("cuda")

    def c_fn(path, name, argtypes):
        fn = getattr(ctypes.CDLL(str(path)), name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        return fn

    # K1: old and new through the same allocation and call
    k1_types = [lib.P] * 10 + [lib.I32] * 5 + [lib.I64, lib.P]

    def k1(fn, pk, pv, ch, lf, root, q, kw):
        s, n, b = pk.shape

        def call():
            outs = (torch.empty(q.shape, dtype=torch.int32, device=dev),
                    torch.empty(q.shape, dtype=torch.bool, device=dev),
                    torch.empty(q.shape, dtype=torch.int32, device=dev),
                    torch.empty(q.shape, dtype=torch.int64, device=dev))
            lib.check(fn(*(x.data_ptr() for x in (pk, pv, ch, lf, root, q)),
                         *(o.data_ptr() for o in outs), s, n, b, q.shape[1], kw["max_height"],
                         int(kw["notfound"]), lib.stream_of(dev)), "descend_probe")
            return outs
        return call

    k1_fns = {name.partition(":")[2]: c_fn(p, "descend_probe_launch", k1_types)
              for name, p in paths.items() if name.startswith("descend_probe:")}
    k1_cases = {"main_path": recorded["descend_probe"][0],
                "serve_lookup": serve_lookup_call(torch, lib, dev)}

    # B5: every build takes the current entry point
    def b5(path, lk, lv, lq):
        fn = c_fn(path, "leaf_probe_launch", [lib.P] * 5 + [lib.I32] * 4 + [lib.P])
        bits = {torch.int32: 32, torch.int64: 64}

        def call():
            outs = (torch.empty(lq.shape, dtype=torch.int32, device=dev),
                    torch.empty(lq.shape, dtype=lv.dtype, device=dev))
            lib.check(fn(lk.data_ptr(), lv.data_ptr(), lq.data_ptr(),
                         *(o.data_ptr() for o in outs), *lk.shape, bits[lk.dtype],
                         bits[lv.dtype], lib.stream_of(dev)), "leaf_probe")
            return outs
        return call

    # K3: each build with its own zeroed look-back scratch
    def k3(path, a):
        fn = c_fn(path, "elim_combine_launch",
                  [lib.P] * 9 + [lib.I32] * 2 + [lib.P, lib.I64, lib.P])
        words_fn = getattr(ctypes.CDLL(str(path)), "elim_combine_scratch_words")
        words_fn.argtypes, words_fn.restype = [lib.I32] * 2, lib.I64
        scratch = torch.zeros(words_fn(*a[0].shape), dtype=torch.int64, device=dev)

        def call():
            outs = tuple(torch.empty(a[0].shape, dtype=dt, device=dev)
                         for dt in (torch.bool, torch.int64, torch.bool, torch.int64))
            lib.check(fn(*(x.data_ptr() for x in a), *(o.data_ptr() for o in outs),
                         *a[0].shape, scratch.data_ptr(), scratch.numel(), lib.stream_of(dev)),
                      "elim_combine")
            return outs
        call.scratch = scratch  # alive as long as the call
        return call

    def k3_cases():
        ops, vals, head, p0, v0, _ = recorded["elim_combine"][0]
        yield "main_path", (ops, vals, head, p0, v0)
        rng = np.random.default_rng(chip_smoke.SEED)
        for rows, width in K3_WIDTHS:
            keys = np.sort(zipf_keys(rng, rows * width, chip_smoke.KEY_RANGE, 1.0)
                           .reshape(rows, width), axis=1)
            head = np.ones_like(keys, bool)
            head[:, 1:] = keys[:, 1:] != keys[:, :-1]
            seg = np.cumsum(head, axis=1) - 1
            p0 = np.take_along_axis(rng.random((rows, width)) < 0.5, seg, axis=1)
            v0 = np.take_along_axis(rng.integers(0, 1 << 40, (rows, width)), seg, axis=1)
            a = (rng.integers(0, 4, (rows, width)).astype(np.int32),
                 rng.integers(0, 1 << 40, (rows, width)).astype(np.int64), head, p0, v0)
            yield f"{rows}x{width}", tuple(torch.as_tensor(x, device=dev) for x in a)

    # K2: the old entry point wrote raw slots and row totals, which the
    # wrapper finished; the current one writes the finished triple
    def k2(path, cand, valid, kw, old, eager=False):
        bsz, m = cand.shape
        f, scratch = kw["f"], kw["scratch"]
        if old:
            fn = c_fn(path, "frontier_compact_launch", [lib.P] * 4 + [lib.I32] * 3 + [lib.P])
            fill = torch.tensor(scratch, dtype=torch.int32, device=dev)

            def call():
                raw = torch.empty((bsz, f), dtype=torch.int32, device=dev)
                total = torch.empty((bsz,), dtype=torch.int32, device=dev)
                lib.check(fn(cand.data_ptr(), valid.data_ptr(), raw.data_ptr(), total.data_ptr(),
                             bsz, m, f, lib.stream_of(dev)), "frontier_compact")
                fvalid = torch.arange(f, device=dev)[None, :] < total[:, None]
                s_id = torch.tensor(scratch, dtype=torch.int32, device=dev) if eager else fill
                return torch.where(fvalid, raw, s_id), fvalid, total > f
            return call
        fn = c_fn(path, "frontier_compact_launch", [lib.P] * 5 + [lib.I32] * 4 + [lib.P])

        def call():
            outs = (torch.empty((bsz, f), dtype=torch.int32, device=dev),
                    torch.empty((bsz, f), dtype=torch.bool, device=dev),
                    torch.empty((bsz,), dtype=torch.bool, device=dev))
            lib.check(fn(cand.data_ptr(), valid.data_ptr(), *(o.data_ptr() for o in outs),
                         bsz, m, f, scratch, lib.stream_of(dev)), "frontier_compact")
            return outs
        return call

    # K4: the old entry point took the shared-memory width C = pow2 >=
    # max(cap, 32); the current one a scratch for its block mode
    def k4(path, ck, cv, lo, hi, kw, old):
        bsz, n = ck.shape
        cap = kw["cap"]
        if old:
            fn = c_fn(path, "range_scan_launch", [lib.P] * 8 + [lib.I32] * 4 + [lib.P])
            extra, width = (), (max(32, 1 << (cap - 1).bit_length()),)
        else:
            fn = c_fn(path, "range_scan_launch", [lib.P] * 10 + [lib.I32] * 3 + [lib.P])
            pairs_fn = getattr(ctypes.CDLL(str(path)), "range_scan_scratch_pairs")
            pairs_fn.argtypes, pairs_fn.restype = [lib.I32], lib.I64
            pairs = pairs_fn(n)
            run = (torch.empty((bsz, pairs), dtype=torch.int64, device=dev),
                   torch.empty((bsz, pairs), dtype=torch.int32, device=dev))
            extra, width = tuple(r.data_ptr() for r in run), ()

        def call():
            outs = (torch.empty((bsz, cap), dtype=torch.int64, device=dev),
                    torch.empty((bsz, cap), dtype=torch.int64, device=dev),
                    torch.empty((bsz,), dtype=torch.int32, device=dev),
                    torch.empty((bsz,), dtype=torch.bool, device=dev))
            lib.check(fn(*(x.data_ptr() for x in (ck, cv, lo, hi)), *(o.data_ptr() for o in outs),
                         *extra, bsz, n, cap, *width, lib.stream_of(dev)), "range_scan")
            return outs
        call.extra = extra if old else run  # alive as long as the call
        return call

    # K2 and K4 of ``--old``: the first designs' entry points, or the current
    first = "range_scan" in selected and not hasattr(
        ctypes.CDLL(str(paths["range_scan:old"])), "range_scan_scratch_pairs")

    def first_design(name):
        return first and name.endswith(":old")

    if {"frontier_compact", "range_scan"} & set(selected):
        sweep_k2, sweep_k4 = serve_sweep_calls(torch, lib, dev)
        k2_cases = {"main_path": max(recorded["frontier_compact"], key=lambda c: int(c[1].sum())),
                    "serve_sweep": sweep_k2}
        k4_cases = {"main_path": recorded["range_scan"][-1], "serve_sweep": sweep_k4}

    def turns(fns):
        """Median graph-replay ms of each fn over PASSES passes in turns."""
        names = list(fns)
        times = {k: [] for k in names}
        for p in range(PASSES):
            for k in (names if p % 2 == 0 else names[::-1]):
                times[k].append(chip_smoke.graph_ms(torch, fns[k]))
        return {k: {"median_ms": float(np.median(v)), "ms": v} for k, v in times.items()}

    def equal(got, want):
        return all(torch.equal(g, w) for g, w in zip(got, want))

    one = torch.zeros(1, device=dev)
    result = {"card": smi, "kind": torch.cuda.get_device_name(0), "passes": PASSES,
              "old_k2_k4": "first designs" if first else "current entry points",
              "tree": {k: summary[k] for k in ("height", "live_nodes", "pool_rows")},
              "floor_ms": chip_smoke.graph_ms(torch, lambda: one.add_(1))}
    if "descend_probe" in selected:
        result["descend_probe"] = {}
    for case, call in k1_cases.items() if "descend_probe" in selected else ():
        want = td_ref.descend_probe_ref(*call[:-1], **call[-1])
        fns = {k: k1(fn, *call) for k, fn in k1_fns.items()}
        for k, fn in fns.items():
            if not equal(fn(), want):
                raise AssertionError(f"descend_probe {k} ({case}): differs from the plain version")
        result["descend_probe"][case] = {"pool": list(call[0].shape),
                                         "queries": list(call[5].shape), **turns(fns)}
    if "elim_combine" in selected:
        result["elim_combine"] = {}
    for case, a in k3_cases() if "elim_combine" in selected else ():
        want = ec_ref.elim_combine_ref(*a)
        fns = {name.partition(":")[2]: k3(p, a)
               for name, p in paths.items() if name.startswith("elim_combine:")}
        for k, fn in fns.items():
            if not equal(fn(), want):
                raise AssertionError(f"elim_combine {k} ({case}): differs from the plain version")
        result["elim_combine"][case] = {"shape": list(a[0].shape), **turns(fns)}
    if "frontier_compact" in selected:
        result["frontier_compact"] = {}
    for case, (cand, valid, kw) in k2_cases.items() if "frontier_compact" in selected else ():
        want = td_ref.frontier_compact_plain(cand, valid, kw["f"], scratch=kw["scratch"])
        fns = {name.partition(":")[2]: k2(p, cand, valid, kw, first_design(name))
               for name, p in paths.items() if name.startswith("frontier_compact:")}
        for k, fn in fns.items():
            if not equal(fn(), want):
                raise AssertionError(f"frontier_compact {k} ({case}): differs from the plain version")
        calls = {"old": k2(paths["frontier_compact:old"], cand, valid, kw, first, eager=True),
                 "new": fns["new"]}
        bsz, m = cand.shape
        result["frontier_compact"][case] = {
            "cand": [bsz, m], "f": kw["f"], "valid": int(valid.sum()), **turns(fns),
            "call_ms": {k: chip_smoke.time_ms(torch, fn, CALL_ITERS) for k, fn in calls.items()}}
        if first:  # the first design's kernel without its finish
            raw = c_fn(paths["frontier_compact:old"], "frontier_compact_launch",
                       [lib.P] * 4 + [lib.I32] * 3 + [lib.P])
            raw_out = (torch.empty((bsz, kw["f"]), dtype=torch.int32, device=dev),
                       torch.empty((bsz,), dtype=torch.int32, device=dev))
            result["frontier_compact"][case]["old_kernel_alone_ms"] = chip_smoke.graph_ms(
                torch, lambda: raw(cand.data_ptr(), valid.data_ptr(),
                                   *(o.data_ptr() for o in raw_out), bsz, m, kw["f"],
                                   lib.stream_of(dev)))
    if "range_scan" in selected:
        result["range_scan"] = {}
    for case, (ck, cv, lo, hi, kw) in k4_cases.items() if "range_scan" in selected else ():
        want = rs_ref.range_scan_ref(ck, cv, lo, hi, kw["cap"])
        fns = {name.partition(":")[2]: k4(p, ck, cv, lo, hi, kw, first_design(name))
               for name, p in paths.items() if name.startswith("range_scan:")}
        for k, fn in fns.items():
            if not equal(fn(), want):
                raise AssertionError(f"range_scan {k} ({case}): differs from the plain version")
        result["range_scan"][case] = {
            "cand": list(ck.shape), "cap": kw["cap"], "emitted": int(want[2].sum()), **turns(fns),
            "call_ms": {k: chip_smoke.time_ms(torch, fn, CALL_ITERS) for k, fn in fns.items()}}
    if "leaf_probe" in selected:
        from repro_torch.kernels.leaf_probe import ref as lp_ref

        result["leaf_probe"] = {}
        for case, call in k1_cases.items():
            lk, lv, lq = chip_smoke.leaf_rows(torch, call)[:3]
            want = lp_ref.leaf_probe_ref(lk, lv, lq)
            fns = {name.partition(":")[2]: b5(p, lk, lv, lq)
                   for name, p in paths.items() if name.startswith("leaf_probe:")}
            for k, fn in fns.items():
                if not equal(fn(), want):
                    raise AssertionError(f"leaf_probe {k} ({case}): differs from the plain version")
            result["leaf_probe"][case] = {"rows": list(lk.shape), "hits": int((want[0] >= 0).sum()),
                                          **turns(fns)}
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    t0 = time.perf_counter()
    rc = main()
    print(f"tree_kernel_ab: {time.perf_counter() - t0:.1f}s", file=sys.stderr)
    sys.exit(rc)
