"""Paged KV-cache management with the Elim-ABtree as the prefix/session
index: the paper's data structure doing its production job (port of
``src/repro/serve/pages.py``).

The block manager is host-side control logic (as in vLLM); device memory
holds the page pool.  Two index workloads hit the tree:

  * **prefix cache**: hash-chain of token blocks → page id.  Skewed (hot
    system prompts dominate) and update-heavy under churn: the elimination
    path collapses repeated insert/delete of hot prefixes.
  * **session index**: request/session id → page-table id, constant churn
    at request granularity.

Both run as batched rounds of the port's ``ABTree`` (or, with
``shards > 1``, its key-partitioned ``ABForest``), in elim or occ mode, so
every lookup, publish and evict round runs the ``descend_probe`` and
``elim_combine`` kernels, and every session sweep the scan kernels
(``frontier_compact``, ``range_scan``) before its delete round.  The
durable variant journals the index (``DurableForest``) so a restarted
engine recovers its prefix cache (warm restart).
"""
from __future__ import annotations

import hashlib
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.abtree import ABTree, OP_DELETE, OP_FIND, OP_INSERT, TreeConfig
from repro_torch.core.durable import DurableForest, recover_forest
from repro_torch.core.forest import ABForest

PAGE = 256  # tokens per KV page


def _hash_chain(prev: int, block_tokens: Tuple[int, ...]) -> int:
    h = hashlib.blake2b(digest_size=8)
    h.update(prev.to_bytes(8, "little", signed=False))
    h.update(np.asarray(block_tokens, np.int32).tobytes())
    # keep positive and below the tree's EMPTY sentinel
    return int.from_bytes(h.digest(), "little") >> 1


def prefix_hashes(tokens: List[int]) -> List[Tuple[int, Tuple[int, ...]]]:
    """Hash-chain per full PAGE block of the prompt."""
    out = []
    prev = 0
    for i in range(0, len(tokens) - len(tokens) % PAGE, PAGE):
        block = tuple(tokens[i : i + PAGE])
        h = _hash_chain(prev, block)
        out.append((h, block))
        prev = h
    return out


class PagedKVCache:
    """Fixed pool of KV pages + free list + per-request page tables."""

    def __init__(self, n_pages: int):
        self.n_pages = n_pages
        self.free: List[int] = list(range(n_pages))
        self.page_tables: Dict[int, List[int]] = {}
        self.ref: np.ndarray = np.zeros(n_pages, np.int32)  # prefix sharing

    def alloc(self, rid: int, n: int) -> Optional[List[int]]:
        if len(self.free) < n:
            return None
        pages = [self.free.pop() for _ in range(n)]
        for p in pages:
            self.ref[p] += 1
        self.page_tables.setdefault(rid, []).extend(pages)
        return pages

    def share(self, rid: int, pages: List[int]):
        for p in pages:
            self.ref[p] += 1
        self.page_tables.setdefault(rid, []).extend(pages)

    def release(self, rid: int):
        for p in self.page_tables.pop(rid, []):
            self.ref[p] -= 1
            if self.ref[p] == 0:
                self.free.append(p)

    @property
    def used(self) -> int:
        return self.n_pages - len(self.free)


class PrefixIndex:
    """Prefix-block hash → page id, on the port's Elim-ABtree.

    ``shards > 1`` backs the index with a key-partitioned ``ABForest``:
    every batched round routes through the forest's per-shard pipeline, so
    hot-prefix churn on one key range stops contending with the rest of the
    index.  ``key_space`` seeds the split points (default: the full 63-bit
    hash domain; session indexes pass their id range instead);
    ``max_keys_per_shard`` is the forest's overflow-split threshold.

    ``durable_dir`` backs the index with a ``DurableForest`` instead (any
    shard count, per-shard journals): every update round commits before its
    results are released (or, with ``group_commit_every`` > 1, at its
    group's boundary), and an index pointed at a directory that holds a
    ``MANIFEST`` recovers it (warm restart): shard count and split points
    come back from the manifest, and a change of mode raises
    ``ValueError``.  ``faults`` (a ``FaultPlan`` / ``CrashPoint``) is
    installed on the journal.

    ``device`` defaults to ``"cuda"`` (the tree raises without a card);
    tests pass ``device="cpu"``."""

    def __init__(
        self,
        mode: str = "elim",
        capacity: int = 1 << 14,
        *,
        shards: int = 1,
        key_space: Optional[Tuple[int, int]] = None,
        max_keys_per_shard: Optional[int] = None,
        durable_dir: Optional[str] = None,
        snapshot_every: int = 64,
        auto_repartition: bool = False,
        faults=None,
        group_commit_every: int = 1,
        group_commit_max_wait_s: float = 0.05,
        commit_async: bool = False,
        device=None,
    ):
        cfg = TreeConfig(capacity=capacity, b=8, a=2)
        key_space = key_space if key_space is not None else (0, 1 << 63)
        if durable_dir is not None:
            if os.path.exists(os.path.join(durable_dir, "MANIFEST")):
                self.tree = recover_forest(
                    durable_dir, faults=faults, group_commit_every=group_commit_every,
                    group_commit_max_wait_s=group_commit_max_wait_s,
                    commit_async=commit_async, device=device,
                )
                # shard count / splits legitimately come from the manifest
                # (the forest may have re-partitioned); a mode switch would
                # silently change the durability discipline: refuse it.
                if self.tree.forest.mode != mode:
                    raise ValueError(
                        f"durable index at {durable_dir!r} was journaled in "
                        f"{self.tree.forest.mode!r} mode; requested {mode!r}"
                    )
            else:
                self.tree = DurableForest(
                    durable_dir, n_shards=shards, cfg=cfg, mode=mode,
                    snapshot_every=snapshot_every, key_space=key_space,
                    max_keys_per_shard=max_keys_per_shard,
                    auto_repartition=auto_repartition, faults=faults,
                    group_commit_every=group_commit_every,
                    group_commit_max_wait_s=group_commit_max_wait_s,
                    commit_async=commit_async, device=device,
                )
        elif shards > 1:
            self.tree = ABForest(
                n_shards=shards, cfg=cfg, mode=mode, key_space=key_space,
                max_keys_per_shard=max_keys_per_shard,
                auto_repartition=auto_repartition, device=device,
            )
        else:
            self.tree = ABTree(cfg, mode=mode, device=device)

    def close(self):
        """Drain a durable index's pending group and stop its commit
        threads (a no-op for a volatile index)."""
        close = getattr(self.tree, "close", None)
        if close is not None:
            close()

    def lookup_batch(self, hashes: List[int]) -> List[Optional[int]]:
        if not hashes:
            return []
        out = self.tree.apply_round(
            [OP_FIND] * len(hashes), hashes, [0] * len(hashes)
        )
        res = out.results.numpy()
        fnd = out.found.numpy()
        return [int(r) if f else None for r, f in zip(res, fnd)]

    def publish_batch(self, hashes: List[int], pages: List[int]):
        if hashes:
            self.tree.apply_round([OP_INSERT] * len(hashes), hashes, pages)

    def evict_batch(self, hashes: List[int]):
        if hashes:
            self.tree.apply_round([OP_DELETE] * len(hashes), hashes, [0] * len(hashes))

    def stats(self) -> dict:
        return self.tree.stats()


class SessionIndex(PrefixIndex):
    """Session/request id → page-table id, on the batched tree.

    Batched point lookups/publishes are inherited from PrefixIndex (the
    keys are session ids rather than prefix hashes).  Session ids are
    allocated monotonically, so retired sessions pile up in a contiguous
    low range of the key space; eviction is therefore a *range* operation:
    ``evict_range`` collects AND removes every live session id in
    ``[lo, hi)`` with ONE fused scan+delete round per chunk
    (``scan_delete_round``: the round linearizes the scan before the
    round's deletes).  With ``shards > 1`` it is still one fused round per
    chunk when ``[lo, hi)`` straddles shard boundaries; since ids are
    monotone, pair ``key_space`` with ``max_keys_per_shard`` so the forest
    re-partitions the live id range.  It takes ``PrefixIndex``'s knobs,
    durability included."""

    def __init__(self, mode: str = "elim", capacity: int = 1 << 12, **kw):
        super().__init__(mode=mode, capacity=capacity, **kw)

    def evict_range(self, lo: int, hi: int, cap: int = 256) -> List[int]:
        """Evict all sessions with lo <= rid < hi: one fused scan+delete
        round per ``cap``-sized chunk (loops only when > cap sessions
        match).  Returns the evicted (rid-sorted) page-table ids for the
        caller to free."""
        freed: List[int] = []
        while True:
            out = self.tree.scan_delete_round([lo], [hi], cap=cap)
            n = int(out.count[0])
            if n == 0:
                return freed
            freed.extend(int(v) for v in out.vals[0, :n].tolist())
            if not bool(out.truncated[0]):
                return freed
