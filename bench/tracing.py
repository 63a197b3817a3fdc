"""What a traced run records beside the program's own spans and counters.

``LabelTracer`` stands in for the program's tracer during the profiled
stretch: each span the round engine opens becomes a
``torch.profiler.record_function`` range named ``bench:<span>``, with no
fence, so the profile shows which phase the host was in without the
synchronisations the program's tracer adds.  ``reduce_profile`` turns the
profile into device busy time, kernel times by name and idle gaps labelled
by the innermost span open at their middle.  ``span_totals`` reduces the
program's ``Tracer`` events.
"""
from __future__ import annotations

import collections
from typing import Dict, List

import numpy as np
import torch

PREFIX = "bench:"
STRETCH = PREFIX + "stretch"


class _LabelSpan:
    __slots__ = ("_rf",)

    def __init__(self, name: str):
        self._rf = torch.profiler.record_function(PREFIX + name)

    def __enter__(self):
        self._rf.__enter__()
        return self

    def __exit__(self, *exc):
        return self._rf.__exit__(*exc)

    def fence(self, x):
        return x

    def note(self, **kw):
        return None


class LabelTracer:
    """The tracer interface the round engine calls, as profiler labels."""

    enabled = True

    def span(self, name: str, *, shard=None, **args):
        return _LabelSpan(name)

    def instant(self, *a, **kw):
        return None

    def counter(self, *a, **kw):
        return None

    def shard_marks(self, *a, **kw):
        return None


def _union(intervals) -> float:
    busy, end = 0.0, float("-inf")
    for lo, hi in sorted(intervals):
        if hi > end:
            busy += hi - max(lo, end)
            end = hi
    return busy


def reduce_profile(events, kernel_of, top: int = 10) -> dict:
    """Device activity inside the ``bench:stretch`` range of a profile.

    Returns ``window_s``, ``busy_s`` (union of device events), ``kernels``
    (K name -> {"launches", "device_s"}), ``device_ops`` (top names by
    device seconds) and ``idle_gaps`` (the longest gaps between device
    events, each labelled by the innermost ``bench:`` span open at its
    middle, or ``host`` where none was)."""
    cuda = torch.autograd.DeviceType.CUDA
    stretch = [e for e in events if e.name == STRETCH and e.device_type != cuda]
    if not stretch:
        return {}
    s0, s1 = stretch[0].time_range.start, stretch[0].time_range.end
    dev, labels = [], []
    for e in events:
        lo, hi = e.time_range.start, e.time_range.end
        if e.name.startswith(PREFIX):
            if e.device_type != cuda and e.name != STRETCH:
                labels.append((lo, hi, e.name[len(PREFIX):]))
            continue  # a label's device-side copy is no device work
        if e.device_type == cuda and hi > s0 and lo < s1:
            dev.append((max(lo, s0), min(hi, s1), e.name))
    busy = _union((lo, hi) for lo, hi, _ in dev)
    by_name = collections.Counter()
    kernels: Dict[str, dict] = {}
    for lo, hi, name in dev:
        by_name[name[:80]] += (hi - lo) / 1e6
        k = kernel_of(name)
        if k is not None:
            slot = kernels.setdefault(k, {"launches": 0, "device_s": 0.0})
            slot["launches"] += 1
            slot["device_s"] += (hi - lo) / 1e6
    gaps: List[tuple] = []
    end = s0
    for lo, hi, _ in sorted(dev):
        if lo > end:
            gaps.append((end, lo))
        end = max(end, hi)
    if s1 > end:
        gaps.append((end, s1))
    idle = collections.Counter()
    l0 = np.array([x[0] for x in labels], np.float64)
    l1 = np.array([x[1] for x in labels], np.float64)
    for lo, hi in gaps:
        mid = (lo + hi) / 2
        inside = np.nonzero((l0 <= mid) & (mid <= l1))[0]
        name = labels[inside[np.argmin(l1[inside] - l0[inside])]][2] if inside.size else "host"
        idle[name] += (hi - lo) / 1e6
    return {
        "window_s": (s1 - s0) / 1e6,
        "busy_s": busy / 1e6,
        "kernels": kernels,
        "device_ops": [[n, s] for n, s in by_name.most_common(top)],
        "idle_gaps": [[n, s] for n, s in idle.most_common(top)],
    }


def span_totals(events) -> dict:
    """Seconds per span name over complete events, and the self seconds of
    every ``round`` span (its duration less what spans inside it cover)."""
    spans = [e for e in events if e.get("ph") == "X"]
    total = collections.Counter()
    for e in spans:
        total[e["name"]] += e["dur"] / 1e6
    rounds = [e for e in spans if e["name"] == "round"]
    self_s = 0.0
    for rnd in rounds:
        r0, r1 = rnd["ts"], rnd["ts"] + rnd["dur"]
        inner = [(e["ts"], e["ts"] + e["dur"]) for e in spans
                 if e is not rnd and e["ts"] >= r0 and e["ts"] + e["dur"] <= r1]
        self_s += (rnd["dur"] - _union(inner)) / 1e6
    return {"seconds": dict(total), "rounds": len(rounds), "round_self_s": self_s}
