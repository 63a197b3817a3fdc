"""Public wrapper for the elimination combine: a CUDA tensor goes to the
kernel (which launches or raises), a CPU tensor to the plain version."""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.elim_combine import kernel, ref


def elim_combine(
    ops: torch.Tensor,  # (S, B) int32, key-sorted
    vals: torch.Tensor,  # (S, B) int64
    seg_head: torch.Tensor,  # (S, B) bool
    present0: torch.Tensor,  # (S, B) bool, broadcast per segment
    val0: torch.Tensor,  # (S, B) int64, broadcast per segment
):
    """Segmented publishing-elimination fold.  Returns
    ``(before_present, before_val, after_present, after_val)``."""
    if _lib.on_cuda(ops):
        return kernel.elim_combine_cuda(ops, vals, seg_head, present0, val0)
    return ref.elim_combine_ref(ops, vals, seg_head, present0, val0)
