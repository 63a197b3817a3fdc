"""Plain PyTorch versions of the tree_descend kernels.

Port of ``src/repro/kernels/tree_descend/ref.py`` over the port's stacked
pool: every per-node array carries the leading shard axis ``(S, N, ...)``
and a query block is ``(S, B)``, lane ``(s, i)`` searching shard ``s``.
The engine reaches them only through ``ops.py``, on CPU tensors.

Sentinels follow the tree: the key dtype's max is EMPTY (sorts last, never a
user key) and a NULL child (-1) is sent to the scratch row ``N - 1`` by an
explicit ``where`` (JAX reached the same row by wrapping negative gather
indices; torch raises on them instead).
"""
from __future__ import annotations

import torch


def _flat(x: torch.Tensor) -> torch.Tensor:
    """(S, N, ...) -> (S*N, ...) view: global row ``s*N + node``."""
    return x.reshape(x.shape[0] * x.shape[1], *x.shape[2:])


def _base(pool: torch.Tensor) -> torch.Tensor:
    """(S, 1) offset of each shard's rows in the flattened pool."""
    s, n = pool.shape[0], pool.shape[1]
    return (torch.arange(s, device=pool.device) * n)[:, None]


def descend_ref(
    pool_keys: torch.Tensor,  # (S, N, b) leaf keys | internal routers in [..., :b-1]
    children: torch.Tensor,  # (S, N, b) int32 child ids
    is_leaf: torch.Tensor,  # (S, N) bool
    root: torch.Tensor,  # (S,) int32
    queries: torch.Tensor,  # (S, B) key dtype
    *,
    max_height: int,
) -> torch.Tensor:
    """Root-to-leaf search: per level follow ``ptrs[#routers <= key]``
    (unused routers are EMPTY = dtype max, never counted for user keys).
    Returns (S, B) int32 leaf ids."""
    n, b = pool_keys.shape[1], pool_keys.shape[2]
    base = _base(pool_keys)
    keys_f, ch_f, leaf_f = _flat(pool_keys), _flat(children), _flat(is_leaf)
    node = root.to(torch.int64)[:, None].expand(queries.shape).clone()
    for _ in range(max_height):
        g = node + base
        routers = keys_f[g][..., : b - 1]
        idx = (routers <= queries[..., None]).sum(-1)
        child = ch_f[g, idx].to(torch.int64)
        child = torch.where(child < 0, n - 1, child)
        node = torch.where(leaf_f[g], node, child)
    return node.to(torch.int32)


def probe_ref(
    pool_keys: torch.Tensor,  # (S, N, b)
    pool_vals: torch.Tensor,  # (S, N, b)
    leaf_ids: torch.Tensor,  # (S, B) int32
    queries: torch.Tensor,  # (S, B)
    *,
    notfound: int,
):
    """Unsorted-leaf probe across the b slots; ``slot`` is the first match
    (0 when absent, masked by ``found``)."""
    g = leaf_ids.to(torch.int64) + _base(pool_keys)
    eq = _flat(pool_keys)[g] == queries[..., None]
    found = eq.any(-1)
    slot = eq.to(torch.uint8).argmax(-1)
    val = _flat(pool_vals)[g, slot]
    return found, slot.to(torch.int32), torch.where(found, val, notfound)


def descend_probe_ref(
    pool_keys, pool_vals, children, is_leaf, root, queries, *, max_height: int,
    notfound: int,
):
    """Fused plain version: descent followed by the leaf probe (the search
    phase of one round).  Returns ``(leaf, found, slot, val)``, each (S, B)."""
    leaf_ids = descend_ref(
        pool_keys, children, is_leaf, root, queries, max_height=max_height
    )
    found, slot, val = probe_ref(
        pool_keys, pool_vals, leaf_ids, queries, notfound=notfound
    )
    return leaf_ids, found, slot, val


def frontier_compact_ref(
    cand: torch.Tensor,  # (B, M) int32 candidate node ids
    valid: torch.Tensor,  # (B, M) bool
    f: int,
    *,
    scratch: int,
):
    """Stable-argsort compaction oracle: valid candidates keep their order
    and land in slots ``0..total-1``; invalid output slots hold ``scratch``.
    Returns ``(frontier (B, f) int32, valid (B, f) bool, overflow (B,))``."""
    order = torch.argsort((~valid).to(torch.uint8), dim=1, stable=True)
    frontier = torch.gather(cand, 1, order)[:, :f].to(torch.int32)
    valid_out = torch.gather(valid, 1, order)[:, :f]
    total = valid.sum(1)
    return (
        torch.where(valid_out, frontier, torch.tensor(scratch, dtype=torch.int32)),
        valid_out,
        total > f,
    )


def frontier_compact_plain(cand: torch.Tensor, valid: torch.Tensor, f: int):
    """Plain version of the compaction kernel: exclusive cumsum rank plus one
    scatter.  Returns ``(raw (B, f) int32, total (B,) int32)``; ``raw`` is
    meaningful only in slots below ``total`` (the wrapper masks the rest).
    Invalid and overflowing candidates land in an extra column ``f`` that is
    sliced off (JAX's ``.at[].set(mode="drop")``)."""
    vi = valid.to(torch.int32)
    rank = torch.cumsum(vi, dim=1, dtype=torch.int32) - vi
    total = vi.sum(1, dtype=torch.int32)
    idx = torch.where(valid, torch.clamp(rank, max=f), f).to(torch.int64)
    raw = torch.zeros((cand.shape[0], f + 1), dtype=torch.int32, device=cand.device)
    # duplicate writes happen only in the dropped column f
    raw.scatter_(1, idx, cand.to(torch.int32))
    return raw[:, :f], total
