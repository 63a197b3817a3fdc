"""Per-shard metrics registry: counters, gauges, histograms, one snapshot
(numpy-only copy of ``src/repro/obs/metrics.py``).

The engine's observable state used to be scattered across host ints
(``_rounds`` / ``_scans`` / ``_scan_retries``), the durable layer's
``DurableStats`` dataclass, and the device-resident ``TreeStats``.  The
registry absorbs all of them behind one queryable surface:

  * **counters** — monotone ints, optionally attributed to a shard
    (``inc("scan_retries", 3, shard=2)`` updates both the global counter
    and shard 2's cell).  The legacy holder attributes are properties
    backed by these counters, so the two surfaces can never drift.
  * **gauges** — last-write-wins values (pool capacity, live keys).
  * **histograms** — value reservoirs with percentile summaries (fsync
    latency, serve tick latency).
  * **collectors** — callables merged into ``snapshot()`` at query time;
    holders register one that drains the device ``TreeStats`` and the
    derived rates (retries/op, elimination rate, waves/round), so reading
    the snapshot is the only device sync metrics ever cause.

Shard attribution is positional (shard index).  A forest shard split
shifts indices ≥ the insert point up by one via :meth:`insert_shard`, so
per-shard history stays attributed to the shard that did the work.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np

__all__ = ["MetricsRegistry", "RegistryBackedCounters", "engine_collector"]


def _percentile(sorted_vals: List[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    i = min(len(sorted_vals) - 1, max(0, int(round(q * (len(sorted_vals) - 1)))))
    return float(sorted_vals[i])


class MetricsRegistry:
    def __init__(self):
        self._counters: Dict[str, int] = {}
        self._shard_counters: Dict[str, Dict[int, int]] = {}
        self._gauges: Dict[str, float] = {}
        self._hists: Dict[str, List[float]] = {}
        self._collectors: List[Callable[[], dict]] = []

    # -- counters --------------------------------------------------------------

    def inc(self, name: str, n: int = 1, *, shard: Optional[int] = None) -> None:
        self._counters[name] = self._counters.get(name, 0) + int(n)
        if shard is not None:
            per = self._shard_counters.setdefault(name, {})
            per[int(shard)] = per.get(int(shard), 0) + int(n)

    def set_counter(self, name: str, value: int) -> None:
        """Absolute write — the legacy ``holder._rounds = v`` setter path."""
        self._counters[name] = int(value)

    def inc_shard(self, name: str, n: int, shard: int) -> None:
        """Per-shard attribution WITHOUT touching the global counter — for
        counters whose global total is written elsewhere (the legacy
        ``holder._scan_retries += n`` property path), so the per-shard
        cells always sum to the global value instead of doubling it."""
        per = self._shard_counters.setdefault(name, {})
        per[int(shard)] = per.get(int(shard), 0) + int(n)

    def value(self, name: str, *, shard: Optional[int] = None) -> int:
        if shard is not None:
            return self._shard_counters.get(name, {}).get(int(shard), 0)
        return self._counters.get(name, 0)

    def per_shard(self, name: str, n_shards: int) -> List[int]:
        per = self._shard_counters.get(name, {})
        return [per.get(s, 0) for s in range(n_shards)]

    # -- gauges ----------------------------------------------------------------

    def set_gauge(self, name: str, value: float) -> None:
        self._gauges[name] = float(value)

    # -- histograms ------------------------------------------------------------

    def observe(self, name: str, value: float) -> None:
        self._hists.setdefault(name, []).append(float(value))

    def histogram_summary(self, name: str) -> dict:
        vals = sorted(self._hists.get(name, []))
        return {
            "count": len(vals),
            "sum": float(np.sum(vals)) if vals else 0.0,
            "min": vals[0] if vals else 0.0,
            "max": vals[-1] if vals else 0.0,
            "p50": _percentile(vals, 0.50),
            "p90": _percentile(vals, 0.90),
            "p99": _percentile(vals, 0.99),
        }

    # -- shard lifecycle -------------------------------------------------------

    def insert_shard(self, at: int) -> None:
        """A forest shard split inserted a fresh shard at index ``at``:
        shift every per-shard cell with index ≥ ``at`` up by one so
        attribution follows the shards, not the positions."""
        for per in self._shard_counters.values():
            for s in sorted((s for s in per if s >= at), reverse=True):
                per[s + 1] = per.pop(s)

    def remove_shard(self, at: int) -> None:
        """A cold-shard merge retired the shard at index ``at``: drop its
        cells and shift every per-shard cell with index > ``at`` down by
        one so attribution keeps following the surviving shards."""
        for per in self._shard_counters.values():
            per.pop(at, None)
            for s in sorted(s for s in per if s > at):
                per[s - 1] = per.pop(s)

    # -- snapshot --------------------------------------------------------------

    def add_collector(self, fn: Callable[[], dict]) -> None:
        """``fn()`` is merged (top-level keys) into every ``snapshot()``."""
        self._collectors.append(fn)

    def snapshot(self) -> dict:
        """One queryable view of everything: raw counters, per-shard
        breakdowns, gauges, histogram summaries, plus every registered
        collector's output (device stats, derived rates)."""
        out = {
            "counters": dict(self._counters),
            "per_shard": {
                name: {str(s): v for s, v in sorted(per.items())}
                for name, per in self._shard_counters.items()
            },
            "gauges": dict(self._gauges),
            "histograms": {
                name: self.histogram_summary(name) for name in self._hists
            },
        }
        for fn in self._collectors:
            for k, v in fn().items():
                out[k] = v
        return out


class RegistryBackedCounters:
    """Mixin for round-engine holders: the legacy host counters become
    properties over the holder's ``metrics`` registry, so the legacy
    surface (``tree._rounds``, ``stats()['scan_retries']``) and the
    registry can never drift — they are one store.  ``__init__`` must set
    ``self.metrics = MetricsRegistry()`` before the first assignment."""

    @property
    def _rounds(self) -> int:
        return self.metrics.value("rounds")

    @_rounds.setter
    def _rounds(self, v: int) -> None:
        self.metrics.set_counter("rounds", v)

    @property
    def _scans(self) -> int:
        return self.metrics.value("scans")

    @_scans.setter
    def _scans(self, v: int) -> None:
        self.metrics.set_counter("scans", v)

    @property
    def _scan_retries(self) -> int:
        return self.metrics.value("scan_retries")

    @_scan_retries.setter
    def _scan_retries(self, v: int) -> None:
        self.metrics.set_counter("scan_retries", v)


def engine_collector(holder):
    """Snapshot collector for a round-engine holder: merges the holder's
    ``stats()`` dict (device TreeStats summed over shards + the legacy
    host counters) and the derived rates the engine's claims are stated
    in — retries/op, elimination rate, structural waves per round."""

    def collect() -> dict:
        st = holder.stats()
        reg = holder.metrics
        waves = reg.value("split_waves") + reg.value("underfull_waves")
        return {
            "engine": st,
            "derived": {
                "retries_per_op": st.get("scan_retries", 0)
                / max(1, st.get("scans", 0)),
                "elim_rate": st.get("eliminated", 0)
                / max(1, st.get("searches", 0)),
                "waves_per_round": waves / max(1, st.get("rounds", 0)),
            },
        }

    return collect
