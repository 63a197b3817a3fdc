"""Plain PyTorch version of the range_scan kernel (port of
``src/repro/kernels/range_scan/ref.py``).  Dtype-generic: the EMPTY
sentinel is the key dtype's max."""
from __future__ import annotations

import torch


def range_scan_ref(
    cand_keys: torch.Tensor,  # (B, n) gathered leaf slots, EMPTY-padded
    cand_vals: torch.Tensor,  # (B, n)
    lo: torch.Tensor,  # (B,) inclusive lower bound
    hi: torch.Tensor,  # (B,) exclusive upper bound
    cap: int,
):
    """Select the <= ``cap`` smallest candidate keys in [lo, hi) per row.

    Returns ``(keys (B, cap) ascending EMPTY-padded, vals (B, cap) 0 where
    the key slot is EMPTY, count (B,) int32 <= cap, truncated (B,) bool)``.
    The stable argsort breaks ties between equal keys by candidate index."""
    empty = torch.iinfo(cand_keys.dtype).max
    match = (cand_keys >= lo[:, None]) & (cand_keys < hi[:, None]) & (cand_keys != empty)
    key_m = torch.where(match, cand_keys, empty)
    order = torch.argsort(key_m, dim=1, stable=True)
    sk = torch.gather(key_m, 1, order)[:, :cap]
    sv = torch.gather(cand_vals, 1, order)[:, :cap]
    if sk.shape[1] < cap:  # fewer candidates than cap: keep the (B, cap) contract
        pad = (sk.shape[0], cap - sk.shape[1])
        sk = torch.cat([sk, torch.full(pad, empty, dtype=sk.dtype, device=sk.device)], dim=1)
        sv = torch.cat([sv, torch.zeros(pad, dtype=sv.dtype, device=sv.device)], dim=1)
    emitted = sk != empty
    total = match.sum(1).to(torch.int32)
    return (
        sk,
        torch.where(emitted, sv, torch.zeros_like(sv)),
        torch.clamp(total, max=cap),
        total > cap,
    )
