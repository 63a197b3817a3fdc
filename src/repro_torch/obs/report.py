"""Phase/shard breakdown report from a Chrome trace-event file, plus the
crash-forensics explain-report for audit sidecars (copy of
``src/repro/obs/report.py``: the same input gives the same summary and the
same text).

    PYTHONPATH=src python -m repro_torch.obs.report trace.json
    PYTHONPATH=src python -m repro_torch.obs.report --json trace.json
    PYTHONPATH=src python -m repro_torch.obs.report journal_dir/audit_00000042.jsonl

Trace files: validates the schema first (non-zero exit on violations),
then renders two tables: total/mean duration per span name (track 0, the
engine's sequencing thread) and per-shard lane attribution (instants on
tracks 1+s).  ``--json`` emits the same summary as one machine-readable
JSON object (CI consumes this instead of scraping the tables); the
exit-code contract is unchanged.

Audit sidecars (``*.jsonl``, from the flight recorder or a recovered
journal): renders the committed-prefix explain-report — round/lane/elim
counts, occ sub-round structure, scan retries, structural transitions —
the "what did the engine decide before the crash" view.
"""
from __future__ import annotations

import argparse
import json
import sys
from collections import defaultdict

from repro_torch.obs.recorder import Recorder
from repro_torch.obs.trace_export import load_trace, validate_trace

__all__ = [
    "render_report", "report_summary", "forensics_summary", "render_forensics", "main",
]


def report_summary(doc: dict) -> dict:
    """The report's aggregates as one JSON-ready dict (the ``--json``
    surface; ``render_report`` renders exactly this)."""
    spans = defaultdict(lambda: [0, 0.0])  # name -> [count, total_us]
    shard_lanes = defaultdict(lambda: defaultdict(int))  # name -> shard -> lanes
    packs = []  # (width, real, pad_waste) per router_pack span
    for ev in doc.get("traceEvents", []):
        ph = ev.get("ph")
        tid = int(ev.get("tid", 0))
        if ph == "X" and tid == 0:
            agg = spans[ev["name"]]
            agg[0] += 1
            agg[1] += float(ev.get("dur", 0.0))
            if ev["name"] == "router_pack":
                args = ev.get("args") or {}
                if "width" in args:
                    packs.append(
                        (
                            int(args["width"]),
                            int(args.get("real", 0)),
                            float(args.get("pad_waste", 0.0)),
                        )
                    )
        elif ph == "i" and tid >= 1:
            s = tid - 1
            shard_lanes[ev["name"]][s] += int((ev.get("args") or {}).get("lanes", 0))

    out = {
        "events": len(doc.get("traceEvents", [])),
        "phases": {
            name: {
                "count": cnt,
                "total_ms": tot / 1e3,
                "mean_us": tot / max(cnt, 1),
            }
            for name, (cnt, tot) in spans.items()
        },
        "per_shard_lanes": {
            name: {str(s): n for s, n in sorted(per.items())}
            for name, per in shard_lanes.items()
        },
        "router_pack": None,
    }
    if packs:
        n = len(packs)
        out["router_pack"] = {
            "packs": n,
            "mean_width": sum(p[0] for p in packs) / n,
            "mean_real": sum(p[1] for p in packs) / n,
            "mean_pad_waste": sum(p[2] for p in packs) / n,
        }
    return out


def render_report(doc: dict) -> str:
    s = report_summary(doc)
    lines = []
    lines.append("phase breakdown (engine track)")
    lines.append(f"  {'span':<24} {'count':>7} {'total_ms':>10} {'mean_us':>10}")
    phases = sorted(s["phases"].items(), key=lambda kv: -kv[1]["total_ms"])
    for name, agg in phases:
        lines.append(
            f"  {name:<24} {agg['count']:>7} {agg['total_ms']:>10.3f} "
            f"{agg['mean_us']:>10.1f}"
        )
    if not phases:
        lines.append("  (no spans)")

    lines.append("")
    lines.append("per-shard attribution (lane counts)")
    shard_lanes = s["per_shard_lanes"]
    all_shards = sorted({int(sh) for per in shard_lanes.values() for sh in per})
    if all_shards:
        hdr = "  " + f"{'event':<24}" + "".join(
            f"{'s' + str(sh):>10}" for sh in all_shards
        )
        lines.append(hdr)
        for name in sorted(shard_lanes):
            row = f"  {name:<24}"
            for sh in all_shards:
                row += f"{shard_lanes[name].get(str(sh), 0):>10}"
            lines.append(row)
    else:
        lines.append("  (no per-shard events)")

    # ragged router packing: how much padding did shipped lane blocks carry?
    # (the gauges router_pack_width / pad_waste_frac hold the latest pack;
    # this table aggregates every pack span the trace recorded.)
    lines.append("")
    lines.append("router pack stats (ragged batching)")
    rp = s["router_pack"]
    if rp:
        lines.append(
            f"  {'packs':>7} {'mean_width':>11} {'mean_real':>10} {'mean_pad_waste':>15}"
        )
        lines.append(
            f"  {rp['packs']:>7} {rp['mean_width']:>11.1f} {rp['mean_real']:>10.1f} "
            f"{rp['mean_pad_waste']:>15.3f}"
        )
    else:
        lines.append("  (no router_pack spans)")
    return "\n".join(lines)


# ----------------------------------------------------------------------------
# forensics explain-report (audit sidecars)
# ----------------------------------------------------------------------------


def forensics_summary(records) -> dict:
    """Aggregate an audit-record stream (recorder export or recovered
    forensics sidecar) into the committed-prefix summary."""
    out = {
        "sidecar": None,
        "rounds": 0,
        "lanes": 0,
        "eliminated": 0,
        "scan_lanes": 0,
        "scan_retries": 0,
        "occ_subrounds": 0,
        "transitions": defaultdict(int),
        "faults": defaultdict(int),
        "commits": 0,
        "rounds_absorbed": 0,  # rounds carried by those commits (group commit)
        "max_group": 0,  # deepest commit group observed
        "first_round": None,
        "last_round": None,
        "modes": defaultdict(int),
    }
    for rec in records:
        kind = rec.get("kind")
        if kind == "sidecar":
            out["sidecar"] = {
                "commit_idx": rec.get("commit_idx"),
                "rounds": rec.get("rounds"),
                "backend": rec.get("backend"),
            }
        elif kind == "round":
            out["rounds"] += 1
            out["modes"][rec.get("mode", "?")] += 1
            r = rec.get("round")
            if r is not None:
                if out["first_round"] is None:
                    out["first_round"] = r
                out["last_round"] = r
            out["lanes"] += sum(1 for op in rec.get("ops", []) if op)
            out["scan_lanes"] += len(rec.get("scans") or {})
            for note in rec.get("elim") or []:
                out["eliminated"] += sum(int(x) for x in note.get("eliminated", []))
            if rec.get("occ"):
                out["occ_subrounds"] += int(rec["occ"].get("subrounds", 0))
            if rec.get("scan_phase"):
                out["scan_retries"] += int(rec["scan_phase"].get("retries", 0))
        elif kind == "transition":
            name = rec.get("event", "?")
            if rec.get("action"):
                name = f"{name}:{rec['action']}"
            if rec.get("state"):  # durability degraded / reattached
                name = f"{name}:{rec['state']}"
            out["transitions"][name] += 1
        elif kind == "fault":
            out["faults"][f"{rec.get('site', '?')}:{rec.get('fault', '?')}"] += 1
        elif kind == "commit":
            out["commits"] += 1
            absorbed = int(rec.get("rounds_absorbed", 1))
            out["rounds_absorbed"] += absorbed
            out["max_group"] = max(out["max_group"], absorbed)
    out["transitions"] = dict(out["transitions"])
    out["faults"] = dict(out["faults"])
    out["modes"] = dict(out["modes"])
    return out


def render_forensics(records) -> str:
    s = forensics_summary(records)
    lines = ["committed-prefix forensics (flight recorder)"]
    if s["sidecar"]:
        sc = s["sidecar"]
        lines.append(
            f"  sidecar: commit {sc['commit_idx']} · {sc['backend']} · "
            f"{sc['rounds']} rounds committed"
        )
    lines.append(
        f"  rounds recorded: {s['rounds']}"
        + (
            f" (round {s['first_round']} … {s['last_round']})"
            if s["first_round"] is not None
            else ""
        )
    )
    lines.append(
        f"  lanes: {s['lanes']} ({s['scan_lanes']} range)  ·  "
        f"eliminated ops: {s['eliminated']}  ·  scan retries: {s['scan_retries']}"
    )
    if s["occ_subrounds"]:
        lines.append(f"  occ sub-rounds: {s['occ_subrounds']}")
    if s["commits"]:
        depth = s["rounds_absorbed"] / s["commits"]
        lines.append(
            f"  durable commit markers: {s['commits']}  ·  "
            f"group depth: {depth:.1f} rounds/commit (max {s['max_group']})"
        )
    if s["transitions"]:
        lines.append("  structural transitions:")
        for name, n in sorted(s["transitions"].items()):
            lines.append(f"    {name:<28} {n}")
    if s["faults"]:
        lines.append("  injected faults:")
        for name, n in sorted(s["faults"].items()):
            lines.append(f"    {name:<28} {n}")
    if s["modes"]:
        modes = ", ".join(f"{m}×{n}" for m, n in sorted(s["modes"].items()))
        lines.append(f"  modes: {modes}")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.report",
        description="Validate + summarize a Chrome trace-event file, or "
        "explain an audit sidecar (.jsonl).",
    )
    ap.add_argument(
        "trace",
        help="trace JSON exported by Tracer.export, or an audit .jsonl "
        "(recorder export / forensics sidecar)",
    )
    ap.add_argument(
        "--json",
        action="store_true",
        help="emit the summary as one machine-readable JSON object",
    )
    args = ap.parse_args(argv)

    if args.trace.endswith(".jsonl"):
        try:
            records = Recorder.load(args.trace)
        except (OSError, ValueError) as e:
            print(f"unreadable audit log {args.trace}: {e}", file=sys.stderr)
            return 1
        if args.json:
            print(json.dumps({"audit": forensics_summary(records)}))
        else:
            print(f"{args.trace}: {len(records)} audit records")
            print(render_forensics(records))
        return 0

    doc = load_trace(args.trace)
    errs = validate_trace(doc)
    if errs:
        for e in errs[:20]:
            print(f"schema error: {e}", file=sys.stderr)
        print(f"{len(errs)} schema violation(s) in {args.trace}", file=sys.stderr)
        return 1
    if args.json:
        print(json.dumps({"trace": args.trace, **report_summary(doc)}))
        return 0
    print(f"{args.trace}: {len(doc.get('traceEvents', []))} events, schema OK")
    print(render_report(doc))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
