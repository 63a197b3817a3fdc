"""Flight recorder: bounded ring buffer of semantic per-round audit records
(numpy-only copy of ``src/repro/obs/recorder.py``; the JSONL schema is
identical, so the JAX package's witness can audit a port history).

The tracer (``obs/tracer.py``) answers *how long* each phase took; the
recorder answers *what the engine decided*: which lanes carried which ops,
which insert/delete pairs the publishing-elimination combiner annihilated
and how a scan validation retried.  One record per executed round, in
arrival order, is enough to replay the engine's chosen linearization
through the ``DictOracle`` (``python -m repro.obs.witness`` does that).

Overhead contract:

  * **Disabled** (``enabled=False`` — the shared ``NULL_RECORDER``):
    every recording method returns immediately after one attribute check;
    nothing is allocated and nothing is retained.  Records are captured
    host-side at round boundaries from values the engine already copied to
    the host, so recording launches no device work.
  * **Enabled**: one bounded ``deque`` append of plain-python lists per
    round (the ring drops the oldest record at capacity).

Record schema (one JSON object per line in the exported ``.jsonl``; the
field-by-field contract is ``src/repro/obs/README.md``'s):

  ``{"kind": "round", "seq": int, "round": int, "mode": "elim"|"occ",
    "n_shards": int, "ops": [int], "keys": [int], "vals": [int],
    "results": [int], "found": [bool],
    "scans": {lane: [[k, v], ...]}|null, "scan_cap": int|null,
    "elim": [{"eliminated": [per-shard], "segments": [...]}]|null,
    "occ": {"subrounds": int, "active_per_subround": [int]}|null,
    "scan_phase": {"retries": int, "attempts": int}|null}``

  ``{"kind": "transition", "seq": int, "event": "split"|"merge"|
    "rebalance"|"repartition_pending", ...}``

  ``{"kind": "commit", "seq": int, "commit_idx": int, "rounds": int,
    "rounds_absorbed": int}``  (``rounds_absorbed`` > 1 marks a GROUP
    commit: that many journal rounds rode one manifest rename)

  ``{"kind": "fault", "seq": int, "site": str, "fault": "eio"|"enospc"|
    "torn"|"rename_fail"|"latency"|"crash"}``

``seq`` is the recorder's own monotone event counter; round records also
carry the holder's round number as ``round``.
"""
from __future__ import annotations

import json
from collections import deque
from typing import Deque, List, Optional

import numpy as np

__all__ = ["Recorder", "NULL_RECORDER", "DEFAULT_CAPACITY"]

# Default ring size: big enough for any crash-matrix window and the quick
# benchmarks' full histories, small enough to stay off the allocator's radar.
DEFAULT_CAPACITY = 4096


def _int_list(x) -> List[int]:
    return np.asarray(x).astype(np.int64).tolist()


class Recorder:
    """Bounded ring buffer of semantic round-audit records.

    The enabled recorder is always-on and cheap (host-side list copies of
    arrays the round engine already pulled off-device); holders construct
    one by default.  The disabled ``NULL_RECORDER`` is the zero-cost
    opt-out (assign ``Recorder(enabled=False)``) and the engine's fallback
    for holders that carry no recorder at all.
    """

    def __init__(self, enabled: bool = True, *, capacity: int = DEFAULT_CAPACITY):
        self.enabled = enabled
        self.capacity = int(capacity)
        self._records: Deque[dict] = deque(maxlen=self.capacity)
        self._seq = 0
        # per-round scratch the engine's inner phases append to; drained
        # into the next ``round()`` record (combines can run several times
        # per round in occ mode).
        self._pending_elim: List[dict] = []
        self._pending_occ: Optional[dict] = None
        self._pending_scan: Optional[dict] = None

    # -- recording -------------------------------------------------------------

    def _push(self, rec: dict) -> None:
        rec["seq"] = self._seq
        self._seq += 1
        self._records.append(rec)

    def note_elim(self, note: dict) -> None:
        """One combine's elimination summary (per-shard eliminated counts +
        multi-op key segments with their net action) — attached to the
        enclosing round record when it is emitted."""
        if not self.enabled:
            return
        self._pending_elim.append(note)

    def note_occ(self, **fields) -> None:
        """The enclosing round's occ sub-round structure."""
        if not self.enabled:
            return
        self._pending_occ = fields

    def note_scan_phase(self, **fields) -> None:
        """The enclosing round's scan-phase validation outcome (retried
        lane count, attempts taken)."""
        if not self.enabled:
            return
        self._pending_scan = fields

    def round(
        self,
        *,
        round_no: int,
        mode: str,
        n_shards: int,
        ops,
        keys,
        vals,
        results,
        found,
        scans: Optional[dict] = None,
        scan_cap: Optional[int] = None,
        fused: Optional[str] = None,
    ) -> None:
        """One executed round, lanes in arrival order.  ``results``/
        ``found`` are the engine's answers for each lane; ``scans`` maps
        range-lane index -> ascending ``[k, v]`` pairs.  Arrival order IS
        the engine's chosen linearization — the witness replays exactly
        this record through the ``DictOracle``.  Pending elim/occ/scan
        notes from the round's inner phases are drained into the record."""
        if not self.enabled:
            return
        rec = {
            "kind": "round",
            "round": int(round_no),
            "mode": mode,
            "n_shards": int(n_shards),
            "ops": _int_list(ops),
            "keys": _int_list(keys),
            "vals": _int_list(vals),
            "results": _int_list(results),
            "found": np.asarray(found).astype(bool).tolist(),
            "scans": (
                None
                if scans is None
                else {
                    str(i): [[int(k), int(v)] for k, v in rows]
                    for i, rows in scans.items()
                }
            ),
            "scan_cap": scan_cap,
            "elim": self._pending_elim or None,
            "occ": self._pending_occ,
            "scan_phase": self._pending_scan,
        }
        if fused is not None:
            rec["fused"] = fused
        self._pending_elim = []
        self._pending_occ = None
        self._pending_scan = None
        self._push(rec)

    def transition(self, event: str, **fields) -> None:
        """Forest state-machine transition: shard split, cold-merge,
        boundary rebalance, repartition trigger."""
        if not self.enabled:
            return
        rec = {"kind": "transition", "event": event}
        for k, v in fields.items():
            rec[k] = v
        self._push(rec)

    def commit(self, commit_idx: int, rounds: int, **fields) -> None:
        """Durable manifest commit marker linking the audit stream to the
        journal's commit index (crash forensics anchor)."""
        if not self.enabled:
            return
        rec = {"kind": "commit", "commit_idx": int(commit_idx), "rounds": int(rounds)}
        for k, v in fields.items():
            rec[k] = v
        self._push(rec)

    def fault(self, site: str, kind: str, **fields) -> None:
        """One injected (or detected) durability fault at a commit I/O
        site — interleaves with round/commit records so forensics show
        exactly which commit attempt the fault hit.  May be called from a
        flush-pool thread: one deque append, safe under the GIL."""
        if not self.enabled:
            return
        rec = {"kind": "fault", "site": site, "fault": kind}
        for k, v in fields.items():
            rec[k] = v
        self._push(rec)

    # -- reading ---------------------------------------------------------------

    def records(self) -> List[dict]:
        """Materialised copy of the ring's current contents (oldest first)."""
        return list(self._records)

    def snapshot(self) -> dict:
        """Summary for ``stats()`` stitching — cheap, no record payloads."""
        rounds = sum(1 for r in self._records if r.get("kind") == "round")
        return {
            "enabled": self.enabled,
            "capacity": self.capacity,
            "events": len(self._records),
            "rounds": rounds,
            "seq": self._seq,
        }

    # -- lifecycle -------------------------------------------------------------

    def clear(self) -> None:
        self._records.clear()

    def export(self, path: str) -> str:
        """Write one JSON object per line (``.jsonl``), oldest first."""
        with open(path, "w") as f:
            for rec in self._records:
                f.write(json.dumps(rec) + "\n")
        return path

    def dump_records(self) -> List[str]:
        """JSONL lines without touching the filesystem (sidecar payload)."""
        return [json.dumps(rec) for rec in self._records]

    @staticmethod
    def load(path: str) -> List[dict]:
        """Parse an exported ``.jsonl`` (or forensics sidecar) back into
        records, tolerating trailing blank lines."""
        out: List[dict] = []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if line:
                    out.append(json.loads(line))
        return out


# The disabled singleton holders fall back to when no recorder is installed.
NULL_RECORDER = Recorder(enabled=False)
