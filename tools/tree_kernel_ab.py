#!/usr/bin/env python3
"""Old/new A/B of the tree kernels K1 (descend_probe) and K3 (elim_combine)
on one CUDA card.

Run from the root of a checkout, on a machine with one card:

    mkdir -p build/ab/old
    for k in descend_probe elim_combine; do
      git show <commit>:src/repro_torch/csrc/$k.cu > build/ab/old/$k.cu
    done
    python3 tools/tree_kernel_ab.py --old build/ab/old

To time a variant of a kernel, put its edited source in the ``--old``
directory.  The tool drives ``chip_smoke.py``'s tree path once (the same
prefill and mixed rounds, each checked against the oracle) to record the
main path's K1 and K3 calls, and records K1's call in a serving index's
prefix lookup: ``chip_smoke.py``'s serve requests published into the port's
``PrefixIndex`` (b = 8) as the engine admits them, then the hot request's
lookup (one query a prompt block).  It builds the old sources beside the
port's own build ("new"), holds both bit-equal to the plain version on
every case, and times each as CUDA-graph replays
(``chip_smoke.graph_ms``) in turns, the order reversed every other pass.
K3 is also timed on seeded inputs of other widths.  ``floor_ms`` is one
minimal kernel (a 1-element add) replayed the same way.  Prints one JSON
object (medians over the passes, with the card's name and power limit),
and with ``--out PATH`` also writes it there.
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", type=Path, required=True,
                    help="directory with the previous descend_probe.cu and elim_combine.cu")
    ap.add_argument("--out", type=Path, help="also write the result to this JSON file")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("tree_kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    import repro_torch.core as core
    from repro_torch.data.workloads import zipf_keys
    from repro_torch.kernels import _lib as lib
    from repro_torch.kernels.elim_combine import ref as ec_ref
    from repro_torch.kernels.tree_descend import ref as td_ref

    libs = lib.build_all()
    out_dir = lib.BUILD_DIR / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for kernel in ("descend_probe", "elim_combine"):
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
    paths["descend_probe:new"] = libs["descend_probe"]
    paths["elim_combine:new"] = libs["elim_combine"]

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    summary, recorded = chip_smoke.run_main_path(torch, core, lib, zipf_keys)
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

    # K3: the old entry point (no scratch); the current ones, each with its
    # own zeroed look-back scratch
    def k3(path, a, old):
        scratch = None
        if old:
            fn = c_fn(path, "elim_combine_launch", [lib.P] * 9 + [lib.I32] * 2 + [lib.P])
            extra = ()
        else:
            fn = c_fn(path, "elim_combine_launch",
                      [lib.P] * 9 + [lib.I32] * 2 + [lib.P, lib.I64, lib.P])
            words_fn = getattr(ctypes.CDLL(str(path)), "elim_combine_scratch_words")
            words_fn.argtypes, words_fn.restype = [lib.I32] * 2, lib.I64
            scratch = torch.zeros(words_fn(*a[0].shape), dtype=torch.int64, device=dev)
            extra = (scratch.data_ptr(), scratch.numel())

        def call():
            outs = tuple(torch.empty(a[0].shape, dtype=dt, device=dev)
                         for dt in (torch.bool, torch.int64, torch.bool, torch.int64))
            lib.check(fn(*(x.data_ptr() for x in a), *(o.data_ptr() for o in outs),
                         *a[0].shape, *extra, lib.stream_of(dev)), "elim_combine")
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
              "tree": {k: summary[k] for k in ("height", "live_nodes", "pool_rows")},
              "floor_ms": chip_smoke.graph_ms(torch, lambda: one.add_(1))}
    result["descend_probe"] = {}
    for case, call in k1_cases.items():
        want = td_ref.descend_probe_ref(*call[:-1], **call[-1])
        fns = {k: k1(fn, *call) for k, fn in k1_fns.items()}
        for k, fn in fns.items():
            if not equal(fn(), want):
                raise AssertionError(f"descend_probe {k} ({case}): differs from the plain version")
        result["descend_probe"][case] = {"pool": list(call[0].shape),
                                         "queries": list(call[5].shape), **turns(fns)}
    result["elim_combine"] = {}
    for case, a in k3_cases():
        want = ec_ref.elim_combine_ref(*a)
        fns = {name.partition(":")[2]: k3(p, a, name.endswith(":old"))
               for name, p in paths.items() if name.startswith("elim_combine:")}
        for k, fn in fns.items():
            if not equal(fn(), want):
                raise AssertionError(f"elim_combine {k} ({case}): differs from the plain version")
        result["elim_combine"][case] = {"shape": list(a[0].shape), **turns(fns)}
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
