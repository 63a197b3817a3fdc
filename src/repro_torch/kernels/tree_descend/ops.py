"""Public wrappers for tree_descend.

A CUDA tensor goes to the hand-written kernel (``kernel.py``), which either
launches or raises; a CPU tensor goes to the plain version (``ref.py``).
There is no fallback between the two and no int32 gate: Hopper handles the
tree's int64 keys natively, so the kernels take them as they are.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.tree_descend import kernel, ref


def descend_probe(
    pool_keys: torch.Tensor,  # (S, N, b) int64, EMPTY-padded keys/routers
    pool_vals: torch.Tensor,  # (S, N, b) int64
    children: torch.Tensor,  # (S, N, b) int32
    is_leaf: torch.Tensor,  # (S, N) bool
    root: torch.Tensor,  # (S,) int32
    queries: torch.Tensor,  # (S, B) int64
    *,
    max_height: int,
    notfound: int,
):
    """Fused search phase: root-to-leaf descent + unsorted-leaf probe.
    Returns ``(leaf (S, B) int32, found bool, slot int32, val int64)`` with
    ``val == notfound`` where the key is absent."""
    if _lib.on_cuda(queries):
        return kernel.descend_probe_cuda(
            pool_keys, pool_vals, children, is_leaf, root, queries,
            max_height=max_height, notfound=notfound,
        )
    return ref.descend_probe_ref(
        pool_keys, pool_vals, children, is_leaf, root, queries,
        max_height=max_height, notfound=notfound,
    )


def frontier_compact(
    cand: torch.Tensor,  # (B, M) int32 candidate node ids
    valid: torch.Tensor,  # (B, M) bool
    f: int,
    *,
    scratch: int,
):
    """Stable compaction of each row's valid candidates into a width-``f``
    frontier.  Returns ``(frontier (B, f) int32, valid (B, f) bool,
    overflow (B,))``; invalid slots hold ``scratch``.  Bit-identical to the
    argsort oracle ``ref.frontier_compact_ref``.  On the card this is one
    kernel, which writes the finished outputs."""
    if _lib.on_cuda(cand):
        return kernel.frontier_compact_cuda(cand, valid, f, scratch=scratch)
    return ref.frontier_compact_plain(cand, valid, f, scratch=scratch)
