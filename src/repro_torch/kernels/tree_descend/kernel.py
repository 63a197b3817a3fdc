"""Launchers of the tree_descend CUDA kernels (``csrc/descend_probe.cu``,
``csrc/frontier_compact.cu``).  Each checks its arguments, allocates the
outputs, launches on PyTorch's current stream and counts the launch."""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib

DESCEND_PROBE = _lib.counter("descend_probe")
FRONTIER_COMPACT = _lib.counter("frontier_compact")


def descend_probe_cuda(
    pool_keys, pool_vals, children, is_leaf, root, queries, *, max_height: int,
    notfound: int,
):
    """CUDA descent + probe over the stacked pool; see ``ref.descend_probe_ref``."""
    dev = queries.device
    s, n, b = pool_keys.shape
    bsz = queries.shape[1]
    _lib.require(pool_keys, "pool_keys", torch.int64, (s, n, b), dev)
    _lib.require(pool_vals, "pool_vals", torch.int64, (s, n, b), dev)
    _lib.require(children, "children", torch.int32, (s, n, b), dev)
    _lib.require(is_leaf, "is_leaf", torch.bool, (s, n), dev)
    _lib.require(root, "root", torch.int32, (s,), dev)
    _lib.require(queries, "queries", torch.int64, (s, bsz), dev)
    leaf = torch.empty((s, bsz), dtype=torch.int32, device=dev)
    found = torch.empty((s, bsz), dtype=torch.bool, device=dev)
    slot = torch.empty((s, bsz), dtype=torch.int32, device=dev)
    val = torch.empty((s, bsz), dtype=torch.int64, device=dev)
    fn = _lib.bind(
        "descend_probe", "descend_probe_launch",
        [_lib.P] * 10 + [_lib.I32] * 5 + [_lib.I64, _lib.P],
    )
    err = fn(
        pool_keys.data_ptr(), pool_vals.data_ptr(), children.data_ptr(),
        is_leaf.data_ptr(), root.data_ptr(), queries.data_ptr(),
        leaf.data_ptr(), found.data_ptr(), slot.data_ptr(), val.data_ptr(),
        s, n, b, bsz, max_height, int(notfound), _lib.stream_of(dev),
    )
    _lib.check(err, "descend_probe")
    DESCEND_PROBE.launched(
        (pool_keys, pool_vals, children, is_leaf, root, queries,
         dict(max_height=max_height, notfound=notfound))
    )
    return leaf, found, slot, val


def frontier_compact_cuda(cand, valid, f: int, *, scratch: int):
    """CUDA compaction, finished in the one launch: returns ``(frontier
    (B, f) int32, valid (B, f) bool, overflow (B,) bool)`` like
    ``ref.frontier_compact_plain``, slots past the row's count holding
    ``scratch``."""
    dev = cand.device
    bsz, m = cand.shape
    _lib.require(cand, "cand", torch.int32, (bsz, m), dev)
    _lib.require(valid, "valid", torch.bool, (bsz, m), dev)
    frontier = torch.empty((bsz, f), dtype=torch.int32, device=dev)
    fvalid = torch.empty((bsz, f), dtype=torch.bool, device=dev)
    overflow = torch.empty((bsz,), dtype=torch.bool, device=dev)
    fn = _lib.bind(
        "frontier_compact", "frontier_compact_launch",
        [_lib.P] * 5 + [_lib.I32] * 4 + [_lib.P],
    )
    err = fn(
        cand.data_ptr(), valid.data_ptr(), frontier.data_ptr(), fvalid.data_ptr(),
        overflow.data_ptr(), bsz, m, f, scratch, _lib.stream_of(dev),
    )
    _lib.check(err, "frontier_compact")
    FRONTIER_COMPACT.launched((cand, valid, dict(f=f, scratch=scratch)))
    return frontier, fvalid, overflow
