"""Plain PyTorch version of the elim_combine kernel: the segmented inclusive
scan of ``core/elimination.py``'s transition composition, run as a
Hillis-Steele doubling scan along each (S, B) row (JAX used
``lax.associative_scan``; any association gives the same outputs, because
a value is only read under a CONST kind and CONST values are fixed by the
composite function)."""
from __future__ import annotations

import torch


def _shift(t, d: int, fill):
    """Each field of ``t`` moved right by ``d`` along dim 1, ``fill``'s
    fields in the first ``d`` columns."""
    return type(t)(
        *(torch.cat([f[:, :d], x[:, :-d]], dim=1) for x, f in zip(t, fill))
    )


def elim_combine_ref(ops, vals, seg_head, present0, val0):
    """Returns ``(before_present, before_val, after_present, after_val)``,
    each (S, B).  ``present0``/``val0`` must be broadcast per segment (the
    kernel's contract); ``before`` at a segment head is ``(present0,
    val0)``, elsewhere the previous op's inclusive transition applied to
    this op's ``(present0, val0)``."""
    from repro_torch.core import elimination as elim

    t = elim.op_transition(ops, vals, seg_head)
    ident = elim.identity_like(t)
    width = ops.shape[1]
    d = 1
    while d < width:
        t = elim.compose(_shift(t, d, ident), t)
        d *= 2
    after_p, after_v = elim.apply_transition(t, present0, val0)
    exc_p, exc_v = elim.apply_transition(_shift(t, 1, ident), present0, val0)
    before_p = torch.where(seg_head, present0, exc_p)
    before_v = torch.where(seg_head, val0, exc_v)
    return before_p, before_v, after_p, after_v
