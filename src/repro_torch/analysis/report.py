"""Render the port's dry-run records as the §Dry-run and §Roofline tables and
a per-cell summary (port of ``src/repro/analysis/report.py``).

The records are ``results/dryrun_torch.json`` (``launch/dryrun.py``),
overlaid with ``results/scan_correction_torch.json`` when present
(``analysis/scan_correction.py``).  They are one device's counts on meta
tensors over a fake world of 256 or 512 ranks, so the headings speak of
ranks, not chips.  The roofline terms are the port's ``roofline_terms``
over the NVIDIA H100's constants; the hint rules (collective, memory,
decode, compute) are the JAX package's, their words the card's.

    python -m repro_torch.analysis.report [results/dryrun_torch.json]
"""
from __future__ import annotations

import json
import os
import sys

from repro_torch.analysis.roofline import model_flops, roofline_terms
from repro_torch.configs import SHAPES, get_config
from repro_torch.launch.dryrun import RESULTS


def load_corrections(path=os.path.join(RESULTS, "scan_correction_torch.json")):
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return {}


def corrected_record(rec: dict, corrections: dict) -> dict:
    """Overlay the depth-probe correction's metrics onto a dry-run record."""
    cid = f"{rec['arch']}|{rec['shape']}|{rec['mesh']}"
    c = corrections.get(cid)
    if not c or not c.get("corrected"):
        return rec
    out = dict(rec)
    out["cost"] = {
        "flops": c["flops"],
        "bytes_accessed": c["bytes_accessed"],
    }
    out["collectives"] = dict(rec["collectives"], total_bytes=c["collective_bytes"])
    out["scan_corrected"] = True
    return out


def _fmt_b(x: float) -> str:
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if abs(x) < 1024:
            return f"{x:.1f}{unit}"
        x /= 1024
    return f"{x:.1f}PB"


def _fmt_t(x: float) -> str:
    if x < 1e-3:
        return f"{x*1e6:.1f}µs"
    if x < 1:
        return f"{x*1e3:.2f}ms"
    return f"{x:.2f}s"


def improvement_hint(cfg, shape, dom: str) -> str:
    if dom == "collective":
        return ("overlap/reshard: hide the dominant all-gather behind the layer's compute "
                "or change param layout (NVLink)")
    if dom == "memory":
        if shape.kind == "decode":
            return "KV/cache streaming from HBM is the floor; shrink cache reads (GQA layout, quantized KV)"
        return "fuse elementwise chains / reduce remat re-reads of HBM"
    return "compute-bound: tensor-core utilization is the lever (tile alignment, bf16 matmuls)"


def dryrun_table(results: dict, mesh: str = "single") -> str:
    lines = [
        "| arch | shape | status | params | FLOPs/dev | bytes/dev | coll bytes/dev | compile s |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for cid, r in sorted(results.items()):
        if r["mesh"] != mesh:
            continue
        if r["status"] != "run":
            lines.append(
                f"| {r['arch']} | {r['shape']} | SKIP ({r['status'].split(':')[1].strip()}) | | | | | |"
            )
            continue
        lines.append(
            "| {arch} | {shape} | ok | {n:.2e} | {f:.2e} | {b} | {c} | {t} |".format(
                arch=r["arch"],
                shape=r["shape"],
                n=r.get("n_params", 0),
                f=r["cost"]["flops"],
                b=_fmt_b(r["cost"]["bytes_accessed"]),
                c=_fmt_b(r["collectives"]["total_bytes"]),
                t=r.get("lower_compile_s", 0),
            )
        )
    return "\n".join(lines)


def roofline_table(results: dict, mesh: str = "single", corrections=None) -> str:
    """``MODEL/counted``: the model's FLOPs (6·N·D or 2·N·D) over the FLOPs
    the dry-run counted on one rank times the ranks."""
    corrections = corrections if corrections is not None else load_corrections()
    lines = [
        "| arch | shape | t_compute | t_memory | t_coll | dominant | MODEL/counted | corr | next lever |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for cid, r in sorted(results.items()):
        if r["mesh"] != mesh or r["status"] != "run":
            continue
        r = corrected_record(r, corrections)
        cfg = get_config(r["arch"])
        shape = SHAPES[r["shape"]]
        t = roofline_terms(r)
        mf = model_flops(cfg, shape)
        counted_global = r["cost"]["flops"] * r["n_devices"]
        ratio = mf / counted_global if counted_global else 0.0
        lines.append(
            "| {a} | {s} | {tc} | {tm} | {tl} | **{d}** | {ratio:.2f} | {corr} | {hint} |".format(
                a=r["arch"],
                s=r["shape"],
                tc=_fmt_t(t["t_compute_s"]),
                tm=_fmt_t(t["t_memory_s"]),
                tl=_fmt_t(t["t_collective_s"]),
                d=t["dominant"],
                ratio=ratio,
                corr="✓" if r.get("scan_corrected") else "–",
                hint=improvement_hint(cfg, shape, t["dominant"]),
            )
        )
    return "\n".join(lines)


def summary(results: dict) -> dict:
    corrections = load_corrections()
    out = {}
    for cid, r in results.items():
        if r["status"] != "run" or r["mesh"] != "single":
            continue
        r = corrected_record(r, corrections)
        cfg = get_config(r["arch"])
        shape = SHAPES[r["shape"]]
        t = roofline_terms(r)
        tmax = max(t["t_compute_s"], t["t_memory_s"], t["t_collective_s"])
        frac = t["t_compute_s"] / tmax if tmax else 0.0
        out[cid] = {
            **t,
            "roofline_fraction": frac,
            "model_flops": model_flops(cfg, shape),
        }
    return out


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    path = argv[0] if argv else os.path.join(RESULTS, "dryrun_torch.json")
    with open(path) as f:
        results = json.load(f)
    print("## §Dry-run (single-pod 16×16 = 256 ranks of a fake world)\n")
    print(dryrun_table(results, "single"))
    print("\n## §Dry-run (multi-pod 2×16×16 = 512 ranks of a fake world)\n")
    print(dryrun_table(results, "multi"))
    print("\n## §Roofline (single-pod, one rank's terms on an H100)\n")
    print(roofline_table(results, "single"))


if __name__ == "__main__":
    main()
