"""Launcher of the elim_combine CUDA kernel (``csrc/elim_combine.cu``)."""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib

ELIM_COMBINE = _lib.counter("elim_combine")


def elim_combine_cuda(ops, vals, seg_head, present0, val0):
    """CUDA segmented combine, one block per shard row; see
    ``ref.elim_combine_ref``."""
    dev = ops.device
    s, b = ops.shape
    _lib.require(ops, "ops", torch.int32, (s, b), dev)
    _lib.require(vals, "vals", torch.int64, (s, b), dev)
    _lib.require(seg_head, "seg_head", torch.bool, (s, b), dev)
    _lib.require(present0, "present0", torch.bool, (s, b), dev)
    _lib.require(val0, "val0", torch.int64, (s, b), dev)
    before_p = torch.empty((s, b), dtype=torch.bool, device=dev)
    before_v = torch.empty((s, b), dtype=torch.int64, device=dev)
    after_p = torch.empty((s, b), dtype=torch.bool, device=dev)
    after_v = torch.empty((s, b), dtype=torch.int64, device=dev)
    fn = _lib.bind(
        "elim_combine", "elim_combine_launch", [_lib.P] * 9 + [_lib.I32] * 2 + [_lib.P]
    )
    err = fn(
        ops.data_ptr(), vals.data_ptr(), seg_head.data_ptr(), present0.data_ptr(),
        val0.data_ptr(), before_p.data_ptr(), before_v.data_ptr(),
        after_p.data_ptr(), after_v.data_ptr(), s, b, _lib.stream_of(dev),
    )
    _lib.check(err, "elim_combine")
    ELIM_COMBINE.launched((ops, vals, seg_head, present0, val0, {}))
    return before_p, before_v, after_p, after_v
