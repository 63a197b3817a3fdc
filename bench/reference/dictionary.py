"""Plain reference of one round of concurrent dictionary operations.

Semantics (the configurations' linearizability guarantee, paper §3):

* every range lane (``key = lo``, ``val = span``) reads ``[lo, lo + span)``
  of the dictionary as of round start: the <= ``cap`` smallest keys with
  their values, ascending; its result is the row count, ``found`` <=> a row;
* then the point lanes apply one by one in arrival (lane) order: ``find``
  returns the value or NOTFOUND; ``insert`` of an absent key stores it and
  returns NOTFOUND, of a present key returns the stored value and changes
  nothing; ``delete`` removes a present key and returns its value.

The dictionary is a Python ``dict``; range lanes search a sorted copy of
it, brought up to date from the keys the point lanes changed.

``broken`` names a guarantee to break, for the control runs that show the
comparison catches a fault:

* ``"range_after_writes"``: range lanes read the dictionary after the
  round's point lanes (round-start visibility broken);
* ``"round_start_reads"``: point lanes answer from the dictionary as of
  round start, as if no earlier lane of the round had run (arrival order
  broken), their writes still applied in order.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np

EMPTY = 2**63 - 1  # no key: pads scan rows; a span past the top saturates here
NOTFOUND = -(2**63)  # the result of an op that found no key
OP_NOP, OP_FIND, OP_INSERT, OP_DELETE, OP_RANGE = 0, 1, 2, 3, 4
BROKEN = (None, "range_after_writes", "round_start_reads")


class RoundAnswer(NamedTuple):
    results: np.ndarray  # (B,) int64
    found: np.ndarray  # (B,) bool
    range_lanes: np.ndarray  # (R,) lane indices of the range lanes
    count: np.ndarray  # (R,) rows returned
    truncated: np.ndarray  # (R,) bool: more keys in the interval than cap
    row_keys: np.ndarray  # (R, cap) EMPTY past count
    row_vals: np.ndarray  # (R, cap) 0 past count


class Dictionary:
    def __init__(self, broken: Optional[str] = None):
        if broken not in BROKEN:
            raise ValueError(f"unknown broken guarantee {broken!r}")
        self.broken = broken
        self.d: Dict[int, int] = {}
        self._sk = np.zeros(0, np.int64)  # sorted keys as of the last sync
        self._sv = np.zeros(0, np.int64)
        self._changed: set = set()

    def _sync(self):
        """Bring the sorted copy up to date with the dict."""
        if not self._changed:
            return
        ck = np.fromiter(sorted(self._changed), np.int64, count=len(self._changed))
        self._changed = set()
        sk, sv = self._sk, self._sv
        if sk.size:
            pos = np.searchsorted(sk, ck)
            hit = pos < sk.size
            hit[hit] = sk[pos[hit]] == ck[hit]
            sk = np.delete(sk, pos[hit])
            sv = np.delete(sv, pos[hit])
        d = self.d
        live = [k for k in ck.tolist() if k in d]
        if live:
            lk = np.asarray(live, np.int64)
            lv = np.asarray([d[k] for k in live], np.int64)
            at = np.searchsorted(sk, lk)
            sk = np.insert(sk, at, lk)
            sv = np.insert(sv, at, lv)
        self._sk, self._sv = sk, sv

    def sorted_items(self):
        """The contents as sorted (keys, vals) int64 arrays."""
        self._sync()
        return self._sk, self._sv

    def _ranges(self, lo, span, cap):
        sk, sv = self.sorted_items()
        with np.errstate(over="ignore"):
            hi = lo + span
        hi = np.where(hi < lo, EMPTY, hi)  # saturate at the top of the key space
        i0 = np.searchsorted(sk, lo, side="left")
        i1 = np.where(hi == EMPTY, sk.size, np.searchsorted(sk, hi, side="left"))
        total = i1 - i0
        count = np.minimum(total, cap)
        cols = np.arange(cap)
        idx = np.minimum(i0[:, None] + cols[None, :], max(sk.size - 1, 0))
        inside = cols[None, :] < count[:, None]
        keys = np.where(inside, sk[idx] if sk.size else EMPTY, EMPTY)
        vals = np.where(inside, sv[idx] if sv.size else 0, 0)
        return count.astype(np.int64), total > cap, keys, vals

    def _points(self, ops, keys, vals, lanes, results, found):
        d = self.d
        changed = self._changed
        reads = dict(d) if self.broken == "round_start_reads" else d
        for i, op, k, v in zip(lanes.tolist(), ops[lanes].tolist(), keys[lanes].tolist(),
                               vals[lanes].tolist()):
            r = reads.get(k)
            if r is not None:
                results[i] = r
                found[i] = True
            if op == OP_INSERT:
                if k not in d:
                    d[k] = v
                    changed.add(k)
            elif op == OP_DELETE:
                if k in d:
                    del d[k]
                    changed.add(k)
            elif op != OP_FIND:
                raise ValueError(f"bad op {op}")

    def apply_round(self, ops, keys, vals, cap: int = 128) -> RoundAnswer:
        ops = np.asarray(ops, np.int32)
        keys = np.asarray(keys, np.int64)
        vals = np.asarray(vals, np.int64)
        if np.any((ops < OP_NOP) | (ops > OP_RANGE)):
            raise ValueError("unknown op code")
        n = ops.size
        results = np.full(n, NOTFOUND, np.int64)
        found = np.zeros(n, bool)
        rl = np.nonzero(ops == OP_RANGE)[0]
        pl = np.nonzero((ops != OP_RANGE) & (ops != OP_NOP))[0]
        if np.any(vals[rl] < 0):
            raise ValueError("negative span on a range lane")
        if self.broken == "range_after_writes":
            self._points(ops, keys, vals, pl, results, found)
        if rl.size:
            count, trunc, rk, rv = self._ranges(keys[rl], vals[rl], cap)
        else:
            count = np.zeros(0, np.int64)
            trunc = np.zeros(0, bool)
            rk = np.zeros((0, cap), np.int64)
            rv = np.zeros((0, cap), np.int64)
        if self.broken != "range_after_writes":
            self._points(ops, keys, vals, pl, results, found)
        results[rl] = count
        found[rl] = count > 0
        return RoundAnswer(results, found, rl, count, trunc, rk, rv)
