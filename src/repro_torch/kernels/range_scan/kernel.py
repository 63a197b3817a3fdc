"""Launcher of the range_scan CUDA kernel (``csrc/range_scan.cu``)."""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib

RANGE_SCAN = _lib.counter("range_scan")

# The kernel keeps 2C (key, index) pairs in shared memory, C = pow2 >=
# max(cap, 32): 24·C bytes, within the 227 KB a block may use up to C = 8192.
MAX_CAP = 8192


def _width(cap: int) -> int:
    return max(32, 1 << (int(cap) - 1).bit_length())


def range_scan_cuda(cand_keys, cand_vals, lo, hi, *, cap: int):
    """CUDA gather; see ``ref.range_scan_ref``."""
    if not 1 <= cap <= MAX_CAP:
        raise ValueError(
            f"range_scan: cap {cap} outside [1, {MAX_CAP}] (the kernel keeps "
            f"2·pow2(cap) candidates in shared memory)"
        )
    dev = cand_keys.device
    bsz, n = cand_keys.shape
    _lib.require(cand_keys, "cand_keys", torch.int64, (bsz, n), dev)
    _lib.require(cand_vals, "cand_vals", torch.int64, (bsz, n), dev)
    _lib.require(lo, "lo", torch.int64, (bsz,), dev)
    _lib.require(hi, "hi", torch.int64, (bsz,), dev)
    keys = torch.empty((bsz, cap), dtype=torch.int64, device=dev)
    vals = torch.empty((bsz, cap), dtype=torch.int64, device=dev)
    count = torch.empty((bsz,), dtype=torch.int32, device=dev)
    truncated = torch.empty((bsz,), dtype=torch.bool, device=dev)
    fn = _lib.bind(
        "range_scan", "range_scan_launch", [_lib.P] * 8 + [_lib.I32] * 4 + [_lib.P]
    )
    err = fn(
        cand_keys.data_ptr(), cand_vals.data_ptr(), lo.data_ptr(), hi.data_ptr(),
        keys.data_ptr(), vals.data_ptr(), count.data_ptr(), truncated.data_ptr(),
        bsz, n, cap, _width(cap), _lib.stream_of(dev),
    )
    _lib.check(err, "range_scan")
    RANGE_SCAN.launched((cand_keys, cand_vals, lo, hi, dict(cap=cap)))
    return keys, vals, count, truncated
