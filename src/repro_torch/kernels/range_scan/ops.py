"""Public wrapper for range_scan: a CUDA tensor goes to the kernel (which
launches or raises), a CPU tensor to the plain version.  Keys stay int64 on
both paths; there is no int32 gate."""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.range_scan import kernel, ref


def range_scan(
    cand_keys: torch.Tensor,  # (B, n) int64, EMPTY-padded gathered leaf slots
    cand_vals: torch.Tensor,  # (B, n) int64
    lo: torch.Tensor,  # (B,)
    hi: torch.Tensor,  # (B,)
    *,
    cap: int = 128,
):
    """Fixed-capacity ascending gather of candidate keys in [lo, hi).
    Returns ``(keys, vals, count, truncated)``; see ref.py."""
    if _lib.on_cuda(cand_keys):
        return kernel.range_scan_cuda(cand_keys, cand_vals, lo, hi, cap=cap)
    return ref.range_scan_ref(cand_keys, cand_vals, lo, hi, cap)
