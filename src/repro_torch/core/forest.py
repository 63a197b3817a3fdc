"""ABForest: a key-partitioned forest of (a,b)-trees on the round engine
(port of ``src/repro/core/forest.py``).

Lanes on disjoint key ranges never conflict, so partitioning the key space
by split points turns one contended tree into ``n_shards`` independent
ones.  Every shard's round is the same program: the phases of
``core/rounds.py`` take the stacked ``(S, ...)`` state and ``(S, W)`` lane
blocks, so all shards run in the same kernel launches (K1 takes an
``(S, B)`` query block, K3 one row a shard, K2 and K4 shard-tagged rows).
This module holds no round execution of its own; what it adds is the
forest itself:

Representation
    One stacked ``TreeState`` whose every array carries the leading shard
    axis (``keys``: (S, N, b), ``root``: (S,), ...), on one device.

Routing (host, per round, inside ``rounds.execute_plan``)
    Point lanes go to ``shard = searchsorted(splits, key)``; OP_RANGE lanes
    split at shard boundaries into per-shard sub-lanes whose rows stitch
    back in key order.  Point lanes keep the (S, W) rectangle with
    W = pow2(max per-shard lane count); scan sub-lanes pack flat.

Load-aware repartitioning
    The router feeds per-shard routed-lane counts (the windowed hot-shard
    detector behind ``hot_shard_hook``) and a ring of recently routed keys
    (``_note_key_sample``).  With ``auto_repartition=True`` a window fire
    queues ONE pending action, consumed at a round boundary when no scan is
    in flight and no restack is running:

        IDLE --window fire (hot frac >= max(hot_shard_frac, 1.5/S))--> PENDING
        PENDING --round boundary, quiescent--> MERGE | REBALANCE --> IDLE

    REBALANCE moves the boundary between the hot shard and its colder
    neighbour to the load-weighted quantile of the sampled keys; MERGE
    retires the coldest shard (window share <= ``cold_shard_frac``) into a
    neighbour.  Either way the moved range is swept off with fused
    scan+delete rounds and re-inserted through the router, and
    ``repartition_hook(kind, a, b)`` fires after the partition changes.
    The tracer's ``repartition`` span wraps an action, and its
    ``shard_sweep`` and ``shard_reinsert`` spans each move (overflow
    splits' too), noting the keys, rounds and retry passes.

Shard overflow
    With ``max_keys_per_shard`` set, a shard growing past it is split: the
    load-weighted median (else the key median) becomes a new split point,
    the upper part is swept off, a fresh shard is restacked at ``s + 1``
    and the swept keys re-insert through the router.  ``split_hook(s)``
    fires after the restack.

Semantics are ``ABTree``'s (the same engine): a forest of any shard count
must be ``DictOracle``-equivalent.  ``device`` defaults to the CUDA card
and raises without one; tests pass ``device="cpu"``.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import rounds
from repro_torch.core.abtree import (
    EMPTY,
    KEY_MIN,
    OP_DELETE,
    OP_FIND,
    OP_INSERT,
    RoundOutput,
    ScanOutput,
    TreeConfig,
    TreeState,
    TreeStats,
    grow_pool,
    make_tree,
)
from repro_torch.kernels import _lib
from repro_torch.obs.metrics import (
    MetricsRegistry,
    RegistryBackedCounters,
    engine_collector,
)
from repro_torch.obs.recorder import Recorder
from repro_torch.obs.tracer import NULL_TRACER


def _shard(st: TreeState, s: int) -> TreeState:
    """Shard ``s`` of a stacked state as unstacked views (no copy)."""
    return TreeState(*(x[s] for x in st[:-1]), stats=TreeStats(*(x[s] for x in st.stats)))


def _stack_states(states: List[TreeState]) -> TreeState:
    """Unstacked shard states -> one stacked state (a copy)."""
    return TreeState(
        *(torch.stack(xs) for xs in zip(*(st[:-1] for st in states))),
        stats=TreeStats(*(torch.stack(xs) for xs in zip(*(st.stats for st in states)))),
    )


class ABForest(RegistryBackedCounters):
    """Key-partitioned forest of batched (a,b)-trees with ``ABTree``'s round
    API (``apply_round`` / ``scan_round`` / ``scan_delete_round`` /
    ``scan_stream``): one round across all shards per call."""

    def __init__(
        self,
        n_shards: int = 2,
        cfg: TreeConfig = TreeConfig(),
        mode: str = "elim",
        *,
        splits=None,
        key_space: Optional[Tuple[int, int]] = None,
        max_keys_per_shard: Optional[int] = None,
        hot_shard_frac: float = 0.5,
        hot_shard_window: int = 256,
        auto_repartition: bool = False,
        cold_shard_frac: float = 0.05,
        device=None,
    ):
        if mode not in ("elim", "occ"):
            raise ValueError(f"unknown mode {mode!r}")
        if not 2 <= cfg.a <= cfg.b // 2:
            raise ValueError("(a,b) requires 2 ≤ a ≤ b/2")
        if n_shards < 1:
            raise ValueError(f"n_shards must be at least 1, got {n_shards}")
        self.device = _lib.resolve_device(device, "ABForest")
        self.cfg = cfg
        self.mode = mode
        self.n_shards = int(n_shards)
        if splits is not None:
            splits = np.asarray(splits, np.int64).reshape(-1)
            if splits.size != self.n_shards - 1:
                raise ValueError(f"need {self.n_shards - 1} split points, got {splits.size}")
            if not np.all(np.diff(splits) > 0):
                raise ValueError("splits must be strictly ascending")
        else:
            lo, hi = key_space if key_space is not None else (0, 1 << 63)
            if hi - lo < self.n_shards:
                raise ValueError("key_space too small for n_shards")
            step = (hi - lo) // self.n_shards
            # Python ints: at S = 1 over the default space, step is 2**63,
            # past int64 (the JAX forest's numpy product overflows there)
            splits = np.array([lo + step * i for i in range(1, self.n_shards)], np.int64)
        self._splits = splits.astype(np.int64)
        self._rebuild_bounds()
        self.state: TreeState = make_tree(cfg, self.n_shards, self.device)
        self.max_keys_per_shard = max_keys_per_shard
        self._in_split = False
        self._scan_active = 0  # defers shard splits while a scan is in flight
        self._wave_w = 64  # pad width for structural waves
        self._scan_frontier = 8  # leaf-frontier pad width (doubles on overflow)
        # optimistic-reader hook, as on ABTree: called between a scan's
        # gather and its per-shard version validation.
        self.scan_hook = None
        # durability hook, as on ABTree: fires after every occ sub-round.
        self.subround_hook = None
        # shard-lifecycle hook: split_hook(s) fires after shard s has been
        # split and the fresh shard restacked at s + 1 (before the swept
        # keys re-insert).
        self.split_hook = None
        # telemetry: the registry backs the legacy counter properties; the
        # tracer defaults to the no-op; the flight recorder is always on.
        self.metrics = MetricsRegistry()
        self.metrics.add_collector(engine_collector(self))
        self.tracer = NULL_TRACER
        self.recorder = Recorder()
        self._rounds = 0
        self._scans = 0
        self._scan_retries = 0
        # hot-shard detection (fed by the router via _note_shard_load): over
        # each window of ``hot_shard_window`` routed lanes, a shard with
        # >= ``hot_shard_frac`` of them fires hot_shard_hook(shard, info).
        self.hot_shard_hook = None
        self.hot_shard_frac = float(hot_shard_frac)
        self.hot_shard_window = int(hot_shard_window)
        self._shard_load = np.zeros(self.n_shards, np.int64)
        # load-aware repartitioning: a window fire queues ONE pending action,
        # consumed at a quiescent round boundary.
        self.auto_repartition = bool(auto_repartition)
        self.cold_shard_frac = float(cold_shard_frac)
        self._repartition_pending = None
        # repartition_hook(kind, a, b) fires after a boundary rebalance
        # ("rebalance", hot, neighbour) or a cold-shard merge ("merge",
        # retired, survivor after the restack).
        self.repartition_hook = None
        # ring of recently routed keys: the weighted-quantile sample behind
        # load-aware split points and boundary moves.
        self._key_sample = np.zeros(4096, np.int64)
        self._key_sample_n = 0

    # -- round-engine holder protocol -------------------------------------------

    @property
    def stacked(self) -> TreeState:
        """The (S, ...) stacked state the round engine executes on: for the
        forest this is the state itself."""
        return self.state

    @stacked.setter
    def stacked(self, st: TreeState):
        self.state = st

    # -- routing ------------------------------------------------------------------

    def _rebuild_bounds(self):
        self._bounds = [KEY_MIN] + [int(x) for x in self._splits] + [EMPTY]

    def _note_shard_load(self, counts):
        """Router callback: accumulate per-shard routed-lane counts and fire
        ``hot_shard_hook(shard, info)`` when one shard dominates the current
        window.  The window resets once full either way.  With
        ``auto_repartition`` the fire also queues the pending action."""
        if self.hot_shard_hook is None and not self.auto_repartition:
            return
        if self._in_split:
            # the sweep/re-insert lanes of a split or repartition are
            # internal traffic, not offered load.
            return
        counts = np.asarray(counts, np.int64)
        if counts.size != self._shard_load.size:
            # shard count changed mid-window (shard split): restart clean
            self._shard_load = np.zeros(self.n_shards, np.int64)
        self._shard_load[: counts.size] += counts
        total = int(self._shard_load.sum())
        if total < self.hot_shard_window:
            return
        s = int(np.argmax(self._shard_load))
        frac = float(self._shard_load[s]) / total
        lanes = int(self._shard_load[s])
        win = self._shard_load.copy()
        self._shard_load[:] = 0
        # "hot" is relative to fair share: the trip point is the larger of
        # the configured frac and 1.5x fair share.
        thresh = max(self.hot_shard_frac, 1.5 / self.n_shards)
        if frac >= thresh and self.n_shards > 1:
            self.metrics.inc("hot_shard_events", shard=s)
            info = {
                "shard": s,
                "frac": frac,
                "lanes": lanes,
                "window": total,
                "bounds": (self._bounds[s], self._bounds[s + 1]),
                "window_loads": win,
            }
            if self.hot_shard_hook is not None:
                self.hot_shard_hook(s, info)
            if self.auto_repartition:
                self._repartition_pending = info
                if self.recorder.enabled:
                    self.recorder.transition(
                        "repartition_pending",
                        shard=s,
                        frac=round(float(frac), 4),
                        window_loads=[int(x) for x in win],
                    )

    def _note_key_sample(self, keys):
        """Router callback: fold routed keys (point keys and scan lower
        bounds) into the fixed-size ring behind ``_load_quantile``."""
        if self._in_split:
            return  # internal sweep/re-insert keys are not offered load
        keys = np.asarray(keys, np.int64).reshape(-1)
        if keys.size == 0:
            return
        cap = self._key_sample.size
        if keys.size >= cap:
            self._key_sample[:] = keys[-cap:]
        else:
            start = self._key_sample_n % cap
            end = start + keys.size
            if end <= cap:
                self._key_sample[start:end] = keys
            else:
                k = cap - start
                self._key_sample[start:] = keys[:k]
                self._key_sample[: end - cap] = keys[k:]
        self._key_sample_n += keys.size

    def _load_quantile(self, lo, hi, q, default=None):
        """q-quantile of the observed (routed) keys inside ``[lo, hi)``: the
        load-weighted split point; ``default`` when the sample holds fewer
        than 32 keys in range."""
        n = min(self._key_sample_n, self._key_sample.size)
        sel = self._key_sample[:n]
        sel = np.sort(sel[(sel >= lo) & (sel < hi)])
        if sel.size < 32:
            return default
        return int(sel[min(int(q * sel.size), sel.size - 1)])

    # -- public API -----------------------------------------------------------------

    def apply_round(self, ops, keys, vals=None, *, scan_cap: int = 128) -> RoundOutput:
        """One round of concurrent ops (``ABTree.apply_round``'s semantics,
        fused OP_RANGE lanes included): the router partitions lanes by key
        range, all shards run one round, and per-lane results come back
        batch-aligned.  Cross-shard range lanes stitch back in key order."""
        plan = rounds.build_plan(ops, keys, vals, scan_cap=scan_cap)
        return rounds.execute_plan(self, plan)

    def scan_round(self, lo, hi, cap: int = 128, max_retries: int = 8) -> ScanOutput:
        """Batched range scans (``ABTree.scan_round``): per query the <=
        ``cap`` smallest keys in ``[lo_i, hi_i)``, ascending, stitched
        across shards in key order."""
        return rounds.execute_scan(self, lo, hi, cap=cap, max_retries=max_retries)

    def scan_delete_round(self, lo, hi, cap: int = 128, max_retries: int = 8) -> ScanOutput:
        """ONE fused round that gathers every key in ``[lo_i, hi_i)`` (<=
        ``cap`` smallest per query, stitched across shards) and deletes
        exactly the emitted keys; keys a truncated page did not emit stay
        for the caller's next chunk."""
        return rounds.execute_scan_delete(self, lo, hi, cap=cap, max_retries=max_retries)

    def scan_stream(self, lo, hi, cap: int = 128):
        """Stream every (key, value) in ``[lo, hi)`` ascending by chaining
        per-shard cursors: each page queries only the shard holding the
        cursor, so a long cross-shard scan stays bounded at ``cap`` entries
        a round."""
        return rounds.execute_scan_stream(self, lo, hi, cap)

    def find(self, key) -> Optional[int]:
        out = self.apply_round([OP_FIND], [key])
        return int(out.results[0]) if bool(out.found[0]) else None

    def insert(self, key, val):
        out = self.apply_round([OP_INSERT], [key], [val])
        return int(out.results[0]) if bool(out.found[0]) else None

    def delete(self, key):
        out = self.apply_round([OP_DELETE], [key])
        return int(out.results[0]) if bool(out.found[0]) else None

    def items(self) -> dict:
        """Host-side snapshot of the forest's contents (sorted by key)."""
        st = self.state
        keys = st.keys.cpu().numpy()
        vals = st.vals.cpu().numpy()
        leaf = (st.is_leaf & st.alloc).cpu().numpy()
        k, v = keys[leaf].reshape(-1), vals[leaf].reshape(-1)
        live = k != EMPTY
        order = np.argsort(k[live], kind="stable")
        return dict(zip(k[live][order].tolist(), v[live][order].tolist()))

    def shard_state(self, s: int) -> TreeState:
        """Shard ``s``'s unstacked state (views): for invariant checks and a
        per-shard durability layer."""
        return _shard(self.state, s)

    def take_dirty(self) -> List[np.ndarray]:
        """Per-shard node ids dirtied since the last durable commit (then
        reset): an untouched shard has nothing to flush."""
        d = self.state.dirty.cpu().numpy()
        self.state = self.state._replace(dirty=torch.zeros_like(self.state.dirty))
        return [np.nonzero(d[s])[0].astype(np.int32) for s in range(self.n_shards)]

    def stats(self) -> dict:
        """Device counters summed over shards; ``rounds`` counts forest
        rounds (one however many shards it spans) and ``scan_retries``
        counts retried lanes."""
        agg = {k: int(v.sum()) for k, v in self.state.stats._asdict().items()}
        agg["rounds"] = self._rounds
        agg["scans"] = self._scans
        agg["scan_retries"] = self._scan_retries
        return agg

    def stats_per_shard(self) -> List[dict]:
        per = {k: v.cpu().tolist() for k, v in self.state.stats._asdict().items()}
        return [{k: int(v[s]) for k, v in per.items()} for s in range(self.n_shards)]

    @property
    def splits(self) -> np.ndarray:
        return self._splits.copy()

    # -- shard-overflow splitting ------------------------------------------------

    def _live_key_counts(self) -> np.ndarray:
        st = self.state
        return torch.where(st.is_leaf & st.alloc, st.size, 0).sum(dim=1).cpu().numpy()

    def _maybe_split_shards(self):
        self._maybe_repartition()
        if self.max_keys_per_shard is None or self._in_split or self._scan_active:
            return
        guard = 0
        while True:
            counts = self._live_key_counts()
            s = int(np.argmax(counts))
            if int(counts[s]) <= self.max_keys_per_shard:
                return
            guard += 1
            if guard >= 64:
                raise RuntimeError("shard split diverged")
            self._split_shard(s)

    def _sweep_range(self, lo: int, hi: int) -> Tuple[List[int], List[int]]:
        """Sweep every key in ``[lo, hi)`` off the forest with fused
        scan+delete rounds (the move behind overflow splits, boundary
        rebalances and cold-shard merges); returns the evicted (keys,
        vals)."""
        moved_k: List[int] = []
        moved_v: List[int] = []
        cap = max(256, self.cfg.b)
        # the bulk sweep needs a far wider leaf frontier than steady-state
        # scans; _scan_frontier is sticky, so restore it afterwards.
        frontier0 = self._scan_frontier
        with self.tracer.span("shard_sweep", lo=int(lo), hi=int(hi)) as sp:
            r0 = self._rounds
            try:
                while True:
                    out = self.scan_delete_round([lo], [hi], cap=cap)
                    n = int(out.count[0])
                    moved_k.extend(out.keys[0, :n].tolist())
                    moved_v.extend(out.vals[0, :n].tolist())
                    if not bool(out.truncated[0]):
                        break
            finally:
                self._scan_frontier = frontier0
            sp.note(keys=len(moved_k), rounds=self._rounds - r0)
        return moved_k, moved_v

    def _reinsert(self, moved_k: List[int], moved_v: List[int]):
        bs = 1024
        with self.tracer.span("shard_reinsert", keys=len(moved_k)) as sp:
            p0 = self.metrics.value("retry_passes")
            for i in range(0, len(moved_k), bs):
                ck = moved_k[i : i + bs]
                cv = moved_v[i : i + bs]
                self.apply_round(np.full(len(ck), OP_INSERT, np.int32), ck, cv)
            sp.note(retry_passes=self.metrics.value("retry_passes") - p0)

    def _split_shard(self, s: int):
        """Split shard ``s``: sweep its upper part off, restack with a fresh
        shard at ``s + 1`` and re-insert the swept keys through the router
        (which now targets the new shard).  The split point prefers the
        load-weighted median of observed keys and falls back to the shard's
        key median when the sample is thin."""
        self._in_split = True
        try:
            st = self.state
            leaf = (st.is_leaf[s] & st.alloc[s]).cpu().numpy()
            krows = st.keys[s].cpu().numpy()[leaf]
            ks = krows[krows != EMPTY]
            if ks.size < 2:
                return
            ks.sort()
            m = int(ks[ks.size // 2])  # > ks[0] >= bounds[s]; < bounds[s+1]
            lm = self._load_quantile(self._bounds[s], self._bounds[s + 1], 0.5)
            if lm is not None and int(ks[0]) < lm <= int(ks[-1]):
                m = lm  # both sides stay non-empty
            hi_bound = self._bounds[s + 1]
            moved_k, moved_v = self._sweep_range(m, hi_bound)
            per = [self.shard_state(i) for i in range(self.n_shards)]
            per.insert(s + 1, _shard(make_tree(self.cfg, 1, self.device), 0))
            self.state = _stack_states(per)
            self.n_shards += 1
            self._splits = np.insert(self._splits, s, m)
            self._rebuild_bounds()
            # keep telemetry attribution aligned with the restack
            self.metrics.inc("shard_splits", shard=s)
            self.metrics.insert_shard(s + 1)
            self._shard_load = np.zeros(self.n_shards, np.int64)
            if self.recorder.enabled:
                self.recorder.transition(
                    "split", shard=s, split_key=int(m),
                    n_shards=self.n_shards, moved=len(moved_k),
                )
            if self.split_hook is not None:
                self.split_hook(s)
            self._reinsert(moved_k, moved_v)
        finally:
            self._in_split = False

    # -- load-aware repartitioning ---------------------------------------------------

    def _maybe_repartition(self):
        """Consume the pending repartition action, if any, at a quiescent
        round boundary: prefer retiring a cold shard (window share <=
        ``cold_shard_frac``), otherwise move the hot boundary."""
        info = self._repartition_pending
        if info is None or self._in_split or self._scan_active:
            return
        self._repartition_pending = None
        if self.n_shards < 2:
            return
        win = np.asarray(info.get("window_loads"), np.int64)
        if win.size != self.n_shards:
            return  # shard count changed since detection: the signal is stale
        s = int(info["shard"])
        total = int(win.sum())
        c = int(np.argmin(win))
        with self.tracer.span("repartition", hot_shard=s, hot_frac=info["frac"],
                              window_loads=win.tolist()) as sp:
            if (
                c != s
                and total > 0
                and float(win[c]) / total <= self.cold_shard_frac
                and self._merge_cold(c)
            ):
                sp.note(action="merge", cold=c)
                # the merge restacked: the hot shard is s - 1 when the
                # retired shard sat below it.
                self.metrics.inc("repartitions", shard=s if c > s else s - 1)
                if self.recorder.enabled:
                    self.recorder.transition(
                        "repartition", action="merge", cold=c, hot_shard=s,
                        n_shards=self.n_shards,
                    )
            elif self._rebalance_boundary(s, win):
                sp.note(action="rebalance")
                self.metrics.inc("repartitions", shard=s)
                if self.recorder.enabled:
                    self.recorder.transition(
                        "repartition", action="rebalance", hot_shard=s,
                        n_shards=self.n_shards,
                    )
            else:
                sp.note(action="noop")
                if self.recorder.enabled:
                    self.recorder.transition(
                        "repartition", action="noop", hot_shard=s,
                        n_shards=self.n_shards,
                    )
            sp.note(n_shards=self.n_shards)

    def _rebalance_boundary(self, s: int, win: np.ndarray) -> bool:
        """Move the boundary between hot shard ``s`` and its colder neighbour
        ``t`` to the load-weighted quantile that would even their observed
        loads: sweep the moved range off ``s``, shift the split point and
        re-insert through the router (the keys now land on ``t``)."""
        nbrs = [t for t in (s - 1, s + 1) if 0 <= t < self.n_shards]
        if not nbrs:
            return False
        t = min(nbrs, key=lambda i: int(win[i]))
        load_s, load_t = int(win[s]), int(win[t])
        if load_s <= load_t or load_s == 0:
            return False
        phi = (load_s - load_t) / (2.0 * load_s)  # load share to hand over
        lo_b, hi_b = self._bounds[s], self._bounds[s + 1]
        q = (1.0 - phi) if t == s + 1 else phi
        m = self._load_quantile(lo_b, hi_b, q)
        if m is None or not (lo_b < m < hi_b):
            return False
        self._in_split = True
        try:
            if t == s + 1:
                moved_k, moved_v = self._sweep_range(m, hi_b)
                self._splits[s] = m
            else:
                moved_k, moved_v = self._sweep_range(lo_b, m)
                self._splits[s - 1] = m
            self._rebuild_bounds()
            self.metrics.inc("boundary_moves", shard=s)
            self._shard_load = np.zeros(self.n_shards, np.int64)
            if self.repartition_hook is not None:
                self.repartition_hook("rebalance", s, t)
            self._reinsert(moved_k, moved_v)
        finally:
            self._in_split = False
        return True

    def _merge_cold(self, c: int) -> bool:
        """Retire cold shard ``c`` into a neighbour: sweep its whole range
        off, drop it from the stack and the boundary between the pair, and
        re-insert through the router (the keys land on the survivor)."""
        nbrs = [t for t in (c - 1, c + 1) if 0 <= t < self.n_shards]
        if not nbrs:
            return False
        t = nbrs[0] if len(nbrs) == 1 else min(
            nbrs, key=lambda i: int(self._live_key_counts()[i])
        )
        if self.max_keys_per_shard is not None:
            counts = self._live_key_counts()
            if int(counts[c]) + int(counts[t]) > self.max_keys_per_shard:
                return False  # the survivor would overflow
        self._in_split = True
        try:
            moved_k, moved_v = self._sweep_range(self._bounds[c], self._bounds[c + 1])
            per = [self.shard_state(i) for i in range(self.n_shards)]
            per.pop(c)
            self.state = _stack_states(per)
            self.n_shards -= 1
            self._splits = np.delete(self._splits, c - 1 if t == c - 1 else c)
            self._rebuild_bounds()
            # re-key before attributing: remove_shard(c) pops cell c and
            # shifts the cells above it down.
            self.metrics.remove_shard(c)
            self.metrics.inc("shard_merges", shard=t if t < c else t - 1)
            self._shard_load = np.zeros(self.n_shards, np.int64)
            if self.repartition_hook is not None:
                self.repartition_hook("merge", c, t if t < c else t - 1)
            self._reinsert(moved_k, moved_v)
        finally:
            self._in_split = False
        return True

    # -- pool management ------------------------------------------------------------

    def _ensure_capacity(self, need_nodes: int):
        """Grow every shard's pool when the fullest shard has fewer than
        ``need + slack`` free nodes (stacked pools share one capacity)."""
        need = 2 * need_nodes + 4 * self.cfg.max_height + 2 * self._wave_w + 8
        n_alloc = int(self.state.alloc.sum(dim=1).max())
        cap = self.cfg.capacity
        if cap - n_alloc >= need:
            return
        self._grow(max(cap * 2, cap + need))

    def _grow(self, new_cap: int):
        self.state = grow_pool(self.state, new_cap - self.cfg.capacity)
        self.cfg = self.cfg._replace(capacity=new_cap)


def check_forest_invariants(forest: ABForest) -> None:
    """Per-shard structural invariants plus the forest's own: every key in
    shard ``s`` lies within ``[bounds[s], bounds[s+1])``."""
    from repro_torch.core.oracle import check_invariants, tree_contents

    for s in range(forest.n_shards):
        st = forest.shard_state(s)
        check_invariants(st, forest.cfg)
        lo, hi = forest._bounds[s], forest._bounds[s + 1]
        for k in tree_contents(st, forest.cfg):
            assert lo <= k < hi, f"shard {s}: key {k} outside shard range [{lo}, {hi})"
