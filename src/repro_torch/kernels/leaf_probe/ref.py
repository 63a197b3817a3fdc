"""Plain PyTorch version of the leaf probe: a mirror of
``src/repro/kernels/leaf_probe/ref.py``.  For each (B, b) leaf row, the
slot of the first key equal to the row's query (int32, -1 when absent) and
the value at that slot (0 when absent, in the values' dtype)."""
from __future__ import annotations

import torch


def leaf_probe_ref(leaf_keys: torch.Tensor, leaf_vals: torch.Tensor, queries: torch.Tensor):
    eq = leaf_keys == queries[:, None]
    found = eq.any(dim=1)
    slot = eq.to(torch.uint8).argmax(dim=1)  # the first maximum: the first match
    val = torch.gather(leaf_vals, 1, slot[:, None])[:, 0]
    slot = slot.to(torch.int32)
    return (
        torch.where(found, slot, torch.full_like(slot, -1)),
        torch.where(found, val, torch.zeros_like(val)),
    )
