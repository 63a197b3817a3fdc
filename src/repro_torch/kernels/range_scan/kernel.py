"""Launcher of the range_scan CUDA kernel (``csrc/range_scan.cu``)."""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import _lib

RANGE_SCAN = _lib.counter("range_scan")


def range_scan_cuda(cand_keys, cand_vals, lo, hi, *, cap: int):
    """CUDA gather, any ``cap``; see ``ref.range_scan_ref``.  Rows longer
    than a warp's shared-memory slice take the kernel's block mode: two
    kernels, which sort runs of the row into a scratch buffer allocated here
    per call, then rank the matches across the runs."""
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
    pairs = _scratch_pairs(n)
    run_keys = run_idx = None  # warp mode reads no scratch
    if pairs:
        run_keys = torch.empty((bsz, pairs), dtype=torch.int64, device=dev)
        run_idx = torch.empty((bsz, pairs), dtype=torch.int32, device=dev)
    fn = _lib.bind(
        "range_scan", "range_scan_launch", [_lib.P] * 10 + [_lib.I32] * 3 + [_lib.P]
    )
    err = fn(
        cand_keys.data_ptr(), cand_vals.data_ptr(), lo.data_ptr(), hi.data_ptr(),
        keys.data_ptr(), vals.data_ptr(), count.data_ptr(), truncated.data_ptr(),
        run_keys.data_ptr() if pairs else None, run_idx.data_ptr() if pairs else None,
        bsz, n, cap, _lib.stream_of(dev),
    )
    _lib.check(err, "range_scan")
    RANGE_SCAN.launched((cand_keys, cand_vals, lo, hi, dict(cap=cap)), 2 if pairs else 1)
    return keys, vals, count, truncated


@functools.lru_cache(maxsize=None)
def _scratch_pairs(n: int) -> int:
    """Scratch pairs a row of ``n`` candidates needs; 0 in warp mode."""
    return _lib.bind("range_scan", "range_scan_scratch_pairs", [_lib.I32], restype=_lib.I64)(n)
