"""Sequential oracle + structural invariant checker (numpy-only copy of
``src/repro/core/oracle.py``).

The oracle applies a round's ops in arrival order against a plain dict —
a valid linearization of the round (all ops are concurrent), so the batched
tree's per-op results must match it exactly.  Range lanes read a sorted
snapshot taken at round start; the snapshot is kept as two int64 arrays and
searched with ``searchsorted`` (the tree's keys and values are int64), so a
mixed round over a million live keys costs one sort, not one pass per lane.

``check_invariants`` walks the array state on the host and asserts the
paper's Theorem 3.5 invariants in their batched form (relaxed (a,b)-tree
sizes, uniform leaf depth, unique keys per leaf, router sortedness and
key-range containment, parent/pidx links, size-field accuracy, no leaked
allocations).  It takes one shard's unstacked state (``ABTree.state``);
tensors are copied to the host first.
"""
from __future__ import annotations

import sys
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.abtree import (
    EMPTY,
    NOTFOUND,
    OP_DELETE,
    OP_FIND,
    OP_INSERT,
    OP_NOP,
    OP_RANGE,
)


def _host(x) -> np.ndarray:
    """A tensor (any device) or array as a numpy array."""
    return np.asarray(x.cpu()) if hasattr(x, "cpu") else np.asarray(x)


class DictOracle:
    """Reference dictionary with the paper's §3 semantics."""

    def __init__(self):
        self.d: Dict[int, int] = {}

    def _apply_point(self, op: int, k: int, v: int) -> Tuple[int, bool]:
        if op == OP_NOP:
            return NOTFOUND, False
        if op == OP_FIND:
            r = self.d.get(k)
            return (NOTFOUND if r is None else r), r is not None
        if op == OP_INSERT:
            r = self.d.get(k)
            if r is None:
                self.d[k] = v
                return NOTFOUND, False
            return r, True  # paper: insert returns the existing value
        if op == OP_DELETE:
            r = self.d.pop(k, None)
            return (NOTFOUND if r is None else r), r is not None
        raise ValueError(f"bad op {op}")

    def apply_round(
        self, ops: Sequence[int], keys: Sequence[int], vals: Sequence[int]
    ) -> Tuple[List[int], List[bool]]:
        results, found = [], []
        for op, k, v in zip(ops, keys, vals):
            r, f = self._apply_point(int(op), int(k), int(v))
            results.append(r)
            found.append(f)
        return results, found

    def _snapshot(self):
        """Sorted (keys, vals) int64 arrays of the current contents."""
        n = len(self.d)
        ks = np.fromiter(self.d.keys(), np.int64, count=n)
        vs = np.fromiter(self.d.values(), np.int64, count=n)
        order = np.argsort(ks, kind="stable")
        return ks[order], vs[order]

    def apply_mixed_round(
        self,
        ops: Sequence[int],
        keys: Sequence[int],
        vals: Sequence[int],
        cap: Optional[int] = None,
    ) -> Tuple[List[int], List[bool], List[Optional[List[Tuple[int, int]]]]]:
        """Reference semantics of one fused round: every OP_RANGE lane
        (key = lo, val = span) scans the dictionary as of round start, then
        point lanes apply in arrival order.  Returns ``(results, found,
        scans)``: ``scans[i]`` is lane i's ascending (k, v) list (clipped to
        ``cap``) or None on point lanes; a range lane's result is its match
        count and ``found`` ⇔ non-empty."""
        ops = [int(x) for x in ops]
        snap = self._snapshot() if OP_RANGE in ops else None
        results: List[int] = []
        found: List[bool] = []
        scans: List[Optional[List[Tuple[int, int]]]] = []
        for op, k, v in zip(ops, keys, vals):
            k, v = int(k), int(v)
            if op == OP_RANGE:
                if v < 0:
                    raise ValueError(f"malformed OP_RANGE lane: negative span {v}")
                lo, hi = k, min(k + v, EMPTY)
                i0, i1 = np.searchsorted(snap[0], [lo, hi], side="left")
                if hi == EMPTY:  # the top of the int64 key space is inclusive
                    i1 = snap[0].size
                if cap is not None:
                    i1 = min(i1, i0 + cap)
                items = list(zip(snap[0][i0:i1].tolist(), snap[1][i0:i1].tolist()))
                scans.append(items)
                results.append(len(items))
                found.append(bool(items))
            else:
                r, f = self._apply_point(op, k, v)
                results.append(r)
                found.append(f)
                scans.append(None)
        return results, found, scans

    def range(self, lo: int, hi: int) -> List[Tuple[int, int]]:
        """All (k, v) with lo ≤ k < hi, ascending — the linearized result a
        scan round must produce (clip to ``cap`` to compare truncated
        scans)."""
        return sorted((k, v) for k, v in self.d.items() if lo <= k < hi)

    def items(self) -> dict:
        return dict(sorted(self.d.items()))


def check_invariants(state, cfg) -> None:
    """Host walk asserting the structural invariants (module docstring).
    Raises AssertionError with a precise message on violation."""
    keys = _host(state.keys)
    children = _host(state.children)
    parent = _host(state.parent)
    pidx = _host(state.pidx)
    is_leaf = _host(state.is_leaf)
    size = _host(state.size)
    level = _host(state.level)
    alloc = _host(state.alloc)
    root = int(_host(state.root))
    height = int(_host(state.height))
    a, b = cfg.a, cfg.b

    assert alloc[root], "root not allocated"
    assert parent[root] == -1, "root has a parent"

    seen = set()
    leaf_depths = set()
    all_keys: List[int] = []

    def walk(nid: int, lo: int, hi: int, depth: int):
        assert nid >= 0, "NULL child reached"
        assert alloc[nid], f"unallocated node {nid} reachable"
        assert nid not in seen, f"node {nid} reachable twice (cycle/shared)"
        seen.add(nid)
        sz = int(size[nid])
        if is_leaf[nid]:
            leaf_depths.add(depth)
            ks = [int(k) for k in keys[nid] if int(k) != EMPTY]
            assert len(ks) == sz, f"leaf {nid}: size {sz} != #keys {len(ks)} (inv 6)"
            assert len(set(ks)) == len(ks), f"leaf {nid}: duplicate key (inv 4)"
            for k in ks:
                assert lo <= k < hi, f"leaf {nid}: key {k} outside range [{lo},{hi}) (inv 2/7)"
            assert level[nid] == 0, f"leaf {nid}: level {level[nid]} != 0"
            if nid != root:
                assert sz >= a, f"leaf {nid}: underfull size {sz} (inv 1)"
            assert sz <= b, f"leaf {nid}: overfull size {sz} (inv 1)"
            all_keys.extend(ks)
            return
        assert 2 <= sz <= b or (nid == root and 1 <= sz <= b), f"internal {nid}: bad size {sz}"
        if nid != root:
            assert sz >= a, f"internal {nid}: underfull size {sz} (inv 1)"
        routers = [int(k) for k in keys[nid, : b - 1]]
        used = routers[: sz - 1]
        assert all(used[i] < used[i + 1] for i in range(len(used) - 1)), (
            f"internal {nid}: routers not strictly sorted: {used}"
        )
        assert all(r == EMPTY for r in routers[sz - 1 :]), f"internal {nid}: stale router beyond size"
        for j in range(sz):
            c = int(children[nid, j])
            assert c >= 0, f"internal {nid}: NULL child {j}"
            assert parent[c] == nid, f"child {c}: parent {parent[c]} != {nid}"
            assert pidx[c] == j, f"child {c}: pidx {pidx[c]} != {j}"
            clo = lo if j == 0 else used[j - 1]
            chi = hi if j == sz - 1 else used[j]
            assert level[c] == level[nid] - 1, (
                f"child {c} level {level[c]} != parent level {level[nid]} - 1"
            )
            walk(c, clo, chi, depth + 1)

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(100000)
    try:
        walk(root, -(2**63), EMPTY, 0)
    finally:
        sys.setrecursionlimit(old_limit)

    assert len(leaf_depths) == 1, f"leaves at multiple depths: {leaf_depths}"
    assert leaf_depths == {height - 1}, f"height {height} inconsistent with leaf depth {leaf_depths}"
    assert len(all_keys) == len(set(all_keys)), "key present in two leaves"
    alloc_ids = set(np.nonzero(alloc)[0].tolist())
    assert alloc_ids == seen, (
        f"allocation leak: allocated-but-unreachable {sorted(alloc_ids - seen)[:10]}"
    )


def tree_contents(state, cfg) -> dict:
    """Dictionary contents by host walk (for oracle comparison)."""
    keys = _host(state.keys)
    vals = _host(state.vals)
    is_leaf = _host(state.is_leaf)
    alloc = _host(state.alloc)
    out = {}
    for nid in np.nonzero(is_leaf & alloc)[0]:
        for j in range(cfg.b):
            k = int(keys[nid, j])
            if k != EMPTY:
                assert k not in out, f"key {k} in two leaves"
                out[k] = int(vals[nid, j])
    return dict(sorted(out.items()))
