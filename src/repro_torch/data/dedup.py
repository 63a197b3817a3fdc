"""Sample dedup via the Elim-ABtree seen-key index (port of
``src/repro/data/dedup.py``).

Training pipelines dedup documents by content hash; the hash stream is
heavily skewed (boilerplate, templates), again the paper's workload.  The
index answers "seen before?" for a whole batch in one round: an insert of
an already-present hash returns the prior value (found) without a write,
and the elimination path collapses the duplicates a batch itself contains.
The tree is the port's ``ABTree``, on the CUDA card unless the caller
passes ``device="cpu"``."""
from __future__ import annotations

import hashlib
from typing import List, Sequence, Tuple

import numpy as np

from repro_torch.core.abtree import ABTree, OP_INSERT, TreeConfig


def content_hash(tokens: Sequence[int]) -> int:
    """A 63-bit key from the document's int32 token bytes (blake2b)."""
    h = hashlib.blake2b(np.asarray(tokens, np.int32).tobytes(), digest_size=8)
    return int.from_bytes(h.digest(), "little") >> 1


class DedupIndex:
    def __init__(self, capacity: int = 1 << 15, mode: str = "elim", device=None):
        self.tree = ABTree(TreeConfig(capacity=capacity), mode=mode, device=device)
        self.seen = 0
        self.dups = 0

    def filter_batch(self, docs: List[Sequence[int]]) -> Tuple[List[int], dict]:
        """Returns the indices of NEW documents; duplicates (within the batch
        or against the history) are dropped.  One insert round a batch."""
        if not docs:
            return [], {}
        hashes = [content_hash(d) for d in docs]
        out = self.tree.apply_round(
            [OP_INSERT] * len(docs), hashes, list(range(self.seen, self.seen + len(docs)))
        )
        found = out.found.cpu().numpy()
        keep = [i for i in range(len(docs)) if not found[i]]
        self.seen += len(docs)
        self.dups += int(found.sum())
        return keep, {"seen": self.seen, "duplicates": self.dups, **self.tree.stats()}
