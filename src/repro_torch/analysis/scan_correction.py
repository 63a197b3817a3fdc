"""Depth-probe correction of the port's dry-run counts (port of
``src/repro/analysis/scan_correction.py``).

In JAX the correction exists because XLA's ``cost_analysis()`` counts a
scanned layer body once.  The port counts every layer it runs, so nothing
here corrects for a scan (``scan_layers=False`` is set on the probes as JAX
sets it, and the port ignores it).  The same fit serves two purposes:

(a) a check that the dry-run counts linearly in depth: the prediction at a
    depth that was not probed must equal a trace at that depth;
(b) the route to the counts of a cell whose full-depth trace is too slow
    (xlstm-350m's train cells run the cells' loops over 4,096 steps in
    Python, layer by layer).

Each stack type is probed at 1 and 2 layers (3 probes for two-stack
archs), at the FULL width and batch on the same fake-world mesh (only depth
is reduced), through ``launch.dryrun.run_cell`` in this process, and the
linear model

    metric(counts) = out + Σ_stacks counts_i · body_i

is solved for ``out`` and the bodies; the corrected metric for the full
config is ``out + Σ L_i·body_i``.  Every probe system is square, so the
fit's residual is zero by construction: only (a) tests anything.  The
dry-run's counts are the same in one process as in a fresh one
(``analysis/roofline.py``), so the probes may share a process.

Writes ``results/scan_correction_torch.json`` (``--suite opt``:
``results/scan_correction_torch_opt.json``): cid → corrected metrics.

    python -m repro_torch.analysis.scan_correction --arch qwen2-0.5b --mesh multi
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import List, Tuple

import numpy as np

from repro_torch.configs import all_cells, get_config
from repro_torch.configs.optimized import OPTIMIZED
from repro_torch.launch.dryrun import RESULTS, run_cell

# per family: (probe override dicts, their stack-count vectors, full-count fn)


def _probe_plan(cfg) -> Tuple[List[dict], List[List[int]], List[int]]:
    fam = cfg.family
    if fam in ("dense", "vlm") or (fam == "moe" and not cfg.first_k_dense):
        probes = [{"n_layers": 1}, {"n_layers": 2}]
        counts = [[1], [2]]
        full = [cfg.n_layers]
    elif fam == "moe":  # deepseek: dense prefix + moe stack
        probes = [
            {"first_k_dense": 1, "n_layers": 2},
            {"first_k_dense": 2, "n_layers": 3},
            {"first_k_dense": 1, "n_layers": 3},
        ]
        counts = [[1, 1], [2, 1], [1, 2]]
        full = [cfg.first_k_dense, cfg.n_layers - cfg.first_k_dense]
    elif fam == "ssm":  # xlstm: mlstm + slstm stacks
        probes = [
            {"n_layers": 2, "slstm_every": 2},
            {"n_layers": 3, "slstm_every": 3},
            {"n_layers": 4, "slstm_every": 2},
        ]
        counts = [[1, 1], [2, 1], [2, 2]]
        k = cfg.slstm_every
        n_s = cfg.n_layers // k if k else 0
        full = [cfg.n_layers - n_s, n_s]
    elif fam == "hybrid":  # zamba2: mamba layers + shared-attn invocations
        probes = [
            {"n_layers": 2, "shared_attn_every": 2},
            {"n_layers": 3, "shared_attn_every": 3},
            {"n_layers": 4, "shared_attn_every": 2},
        ]
        counts = [[2, 1], [3, 1], [4, 2]]
        k = cfg.shared_attn_every
        full = [cfg.n_layers, cfg.n_layers // k if k else 0]
    elif fam == "audio":
        return [], [], []  # whisper is already unrolled (scan_layers=False)
    else:
        raise ValueError(fam)
    return probes, counts, full


def _metrics(rec) -> np.ndarray:
    return np.array(
        [
            rec["cost"]["flops"],
            rec["cost"]["bytes_accessed"],
            float(rec["collectives"]["total_bytes"]),
        ]
    )


def correct_cell(arch: str, shape_name: str, mesh_kind: str, overrides=None) -> dict:
    cfg = get_config(arch)
    if overrides:
        ov = dict(overrides)
        ov.pop("param_dtype", None)
        cfg = cfg.replace(**ov)
    probes, counts, full = _probe_plan(cfg)
    if not probes:
        return {"corrected": False, "reason": "unrolled already"}
    ys, seconds = [], []
    for pov in probes:
        o = dict(overrides or {})
        o.update(pov)
        o["scan_layers"] = False
        t0 = time.perf_counter()
        rec = run_cell(arch, shape_name, mesh_kind, overrides=o)
        seconds.append(time.perf_counter() - t0)
        ys.append(_metrics(rec))
    a = np.array([[1.0] + [float(c) for c in row] for row in counts])
    y = np.stack(ys)  # (P, 3 metrics)
    coef, *_ = np.linalg.lstsq(a, y, rcond=None)  # (1+stacks, 3)
    want = np.array([1.0] + [float(c) for c in full])
    corrected = want @ coef
    body = coef[1:]
    return {
        "corrected": True,
        "flops": float(corrected[0]),
        "bytes_accessed": float(corrected[1]),
        "collective_bytes": float(max(corrected[2], 0.0)),
        "per_stack_flops": body[:, 0].tolist(),
        "full_counts": full,
        "probe_s": seconds,
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(RESULTS, "scan_correction_torch.json"))
    ap.add_argument("--mesh", default="single")
    ap.add_argument("--suite", default="baseline", choices=["baseline", "opt"])
    ap.add_argument("--arch", default=None)
    args = ap.parse_args(argv)

    out_path = args.out if args.suite == "baseline" else args.out.replace(
        ".json", "_opt.json"
    )
    results = {}
    if os.path.exists(out_path):
        with open(out_path) as f:
            results = json.load(f)

    for arch, cfg, shape, status in all_cells():
        if status != "run":
            continue
        if args.arch and arch != args.arch:
            continue
        if args.suite == "opt" and (arch, shape.name) not in OPTIMIZED:
            continue
        cid = f"{arch}|{shape.name}|{args.mesh}"
        if cid in results:
            print(f"skip (cached): {cid}")
            continue
        ov = OPTIMIZED.get((arch, shape.name)) if args.suite == "opt" else None
        print(f"=== correcting {cid} ===", flush=True)
        try:
            results[cid] = correct_cell(arch, shape.name, args.mesh, overrides=ov)
            if results[cid].get("corrected"):
                print(f"  flops → {results[cid]['flops']:.3e}")
        except Exception as e:  # noqa: BLE001
            results[cid] = {"corrected": False, "error": f"{type(e).__name__}: {e}"}
            print(f"  FAIL {results[cid]['error']}")
        os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(results, f, indent=1)
    return results


if __name__ == "__main__":
    main()
