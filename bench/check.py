"""The comparison that decides ``correct``: every lane of every round the
program ran (load, warm-up and window), and its contents at the end, against
the plain reference replayed over the same inputs.  All comparisons are
exact: each number compared has the limit 0."""
from __future__ import annotations

import numpy as np

from bench.reference import Dictionary


def _np(x):
    return x.numpy() if hasattr(x, "numpy") else np.asarray(x)


class Check:
    def __init__(self, reference: Dictionary):
        self.ref = reference
        self.point_wrong = 0
        self.range_wrong = 0
        self.window_wrong = 0
        self.lanes = 0

    def round(self, rnd, out, cap: int, in_window: bool) -> int:
        """Replay one round; count the program's lanes that differ.
        ``out`` is the program's ``RoundOutput``, or None if it never came
        (every lane of the round counts as wrong)."""
        ans = self.ref.apply_round(rnd.ops, rnd.keys, rnd.vals, cap)
        n = rnd.ops.size
        self.lanes += n
        if out is None:
            bad = np.ones(n, bool)
        else:
            bad = (_np(out.results) != ans.results) | (_np(out.found) != ans.found)
            rl = ans.range_lanes
            if rl.size:
                scan = out.scan
                if scan is None:
                    bad[rl] = True
                else:
                    count = _np(scan.count)[rl].astype(np.int64)
                    cols = np.arange(cap)[None, :] < ans.count[:, None]
                    keys = np.where(cols, _np(scan.keys)[rl], 0)
                    vals = np.where(cols, _np(scan.vals)[rl], 0)
                    rows_bad = ((keys != np.where(cols, ans.row_keys, 0))
                                | (vals != np.where(cols, ans.row_vals, 0))).any(axis=1)
                    bad[rl] |= (rows_bad | (count != ans.count)
                                | (_np(scan.truncated)[rl] != ans.truncated))
        is_range = np.zeros(n, bool)
        is_range[ans.range_lanes] = True
        self.point_wrong += int((bad & ~is_range).sum())
        self.range_wrong += int((bad & is_range).sum())
        if in_window:
            self.window_wrong += int(bad.sum())
        return int(bad.sum())

    def contents(self, items: dict) -> int:
        """Keys whose presence or value differs between the program's
        contents (a dict) and the reference's."""
        want = self.ref.d
        if items == want:
            return 0
        wrong = len(items.keys() ^ want.keys())
        wrong += sum(1 for k in items.keys() & want.keys() if items[k] != want[k])
        return wrong
