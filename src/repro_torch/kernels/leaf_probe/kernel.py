"""Launcher of the leaf-probe CUDA kernel (``csrc/leaf_probe.cu``): a group
of lanes a leaf row (the power of two at or above min(b, 32)), a ballot for
the first match, int32 or int64 keys and values; one launch a call."""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib

LEAF_PROBE = _lib.counter("leaf_probe")
BITS = {torch.int32: 32, torch.int64: 64}


def leaf_probe_cuda(leaf_keys, leaf_vals, queries):
    """CUDA leaf probe; see ``ref.leaf_probe_ref``.  Returns
    ``(slot (B,) int32, val (B,) in the values' dtype)``."""
    dev = queries.device
    if leaf_keys.dim() != 2:
        raise ValueError(f"leaf_probe: expected (B, b) key rows, got {tuple(leaf_keys.shape)}")
    bsz, b = leaf_keys.shape
    if leaf_keys.dtype not in BITS or leaf_vals.dtype not in BITS:
        raise TypeError(f"leaf_probe: keys {leaf_keys.dtype} / values {leaf_vals.dtype} "
                        "not supported (int32, int64)")
    _lib.require(leaf_keys, "leaf_keys", leaf_keys.dtype, (bsz, b), dev)
    _lib.require(leaf_vals, "leaf_vals", leaf_vals.dtype, (bsz, b), dev)
    _lib.require(queries, "queries", leaf_keys.dtype, (bsz,), dev)
    slot = torch.empty((bsz,), dtype=torch.int32, device=dev)
    val = torch.empty((bsz,), dtype=leaf_vals.dtype, device=dev)
    fn = _lib.bind("leaf_probe", "leaf_probe_launch", [_lib.P] * 5 + [_lib.I32] * 4 + [_lib.P])
    err = fn(
        leaf_keys.data_ptr(), leaf_vals.data_ptr(), queries.data_ptr(), slot.data_ptr(),
        val.data_ptr(), bsz, b, BITS[leaf_keys.dtype], BITS[leaf_vals.dtype],
        _lib.stream_of(dev),
    )
    _lib.check(err, "leaf_probe")
    LEAF_PROBE.launched((leaf_keys, leaf_vals, queries, {}))
    return slot, val
