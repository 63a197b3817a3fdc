"""Chrome trace-event JSON export + schema validation (copy of
``src/repro/obs/trace_export.py``: the same tracer events give the same
document, and the same document the same violations).

The ``Tracer`` already records events in Chrome trace-event form, so
export is a dump wrapped in the standard ``{"traceEvents": [...]}``
envelope plus process/thread name metadata (``ph="M"``) naming track 0
"engine" and track ``1+s`` "shard s".  The resulting file loads directly
in Perfetto (https://ui.perfetto.dev) or ``chrome://tracing``.

``validate_trace`` is the schema check the trace tests and the report
CLI share: it verifies the envelope, the per-event required fields, and
the phase-specific fields (``dur`` on complete events, ``s`` on
instants) without any external schema library.
"""
from __future__ import annotations

import json
from typing import Dict, List

__all__ = ["to_chrome_trace", "write_chrome_trace", "validate_trace", "load_trace"]

_VALID_PH = {"X", "i", "C", "M"}


def to_chrome_trace(tracer) -> dict:
    """Build the ``{"traceEvents": [...]}`` document from a Tracer."""
    tids = sorted({int(ev.get("tid", 0)) for ev in tracer.events})
    meta: List[Dict] = [
        {
            "name": "process_name",
            "ph": "M",
            "pid": tracer.pid,
            "tid": 0,
            "args": {"name": "repro round engine"},
        }
    ]
    for tid in tids:
        meta.append(
            {
                "name": "thread_name",
                "ph": "M",
                "pid": tracer.pid,
                "tid": tid,
                "args": {"name": "engine" if tid == 0 else f"shard {tid - 1}"},
            }
        )
    return {
        "traceEvents": meta + list(tracer.events),
        "displayTimeUnit": "ms",
    }


def write_chrome_trace(path: str, tracer) -> str:
    doc = to_chrome_trace(tracer)
    with open(path, "w") as f:
        json.dump(doc, f)
    return path


def validate_trace(doc: dict) -> List[str]:
    """Return a list of schema violations (empty == valid).

    Accepts either the envelope dict or a parsed JSON file's contents.
    """
    errs: List[str] = []
    if not isinstance(doc, dict):
        return [f"trace document must be a dict, got {type(doc).__name__}"]
    evs = doc.get("traceEvents")
    if not isinstance(evs, list):
        return ["missing or non-list 'traceEvents'"]
    for i, ev in enumerate(evs):
        where = f"traceEvents[{i}]"
        if not isinstance(ev, dict):
            errs.append(f"{where}: event is not an object")
            continue
        ph = ev.get("ph")
        if ph not in _VALID_PH:
            errs.append(f"{where}: bad ph {ph!r}")
            continue
        if not isinstance(ev.get("name"), str) or not ev["name"]:
            errs.append(f"{where}: missing name")
        for field in ("pid", "tid"):
            if not isinstance(ev.get(field), int):
                errs.append(f"{where}: missing int {field}")
        if ph != "M":
            ts = ev.get("ts")
            if not isinstance(ts, (int, float)):
                errs.append(f"{where}: missing numeric ts")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                errs.append(f"{where}: complete event needs dur >= 0")
        if ph == "i" and ev.get("s") not in (None, "t", "p", "g"):
            errs.append(f"{where}: instant scope must be t/p/g")
        if ph == "C":
            args = ev.get("args")
            if not isinstance(args, dict) or not args:
                errs.append(f"{where}: counter event needs args values")
        if "args" in ev and not isinstance(ev["args"], dict):
            errs.append(f"{where}: args must be an object")
    return errs


def load_trace(path: str) -> dict:
    with open(path) as f:
        return json.load(f)
