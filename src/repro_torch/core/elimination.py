"""Publishing elimination as a batched combine (port of
``src/repro/core/elimination.py``; the paper's §4).

Every operation of a round is concurrent with every other, so all ops on one
key may linearize in arrival order.  Folding them over the key's pre-round
state gives each op's return value (read from the published record, not the
tree) and the key's net effect, at most ONE physical slot write.  The fold
is a segmented scan of function composition over the state machine

    state ∈ { absent } ∪ { present(v) }

    find       : id
    insert(v)  : absent → present(v)      ; present(w) → present(w)
    delete     : absent → absent          ; present(w) → absent

Every composite is a tuple ``(a_kind, a_val, p_kind, p_val)`` describing its
action on ``absent`` and on ``present(w)``, with kinds ABSENT, CONST (→
present(const)) and KEEP (→ present(w), present leg only).

The port carries the leading shard axis: every batch is ``(S, B)``, one
key-sorted row per shard.  ``eliminate_batch`` broadcasts each segment
head's state in torch, runs the scan through ``kernels/elim_combine`` (the
CUDA kernel for CUDA tensors; the JAX engine used ``lax.associative_scan``
and never called its Pallas kernel), and derives the segment-final state and
the net flags in torch.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

# Op codes (shared with abtree).
OP_NOP = 0
OP_FIND = 1
OP_INSERT = 2
OP_DELETE = 3
# Range scan [lo, lo+span).  OP_RANGE lanes never enter the combine: they
# are read-only and linearize before the round's net writes (core/rounds.py
# runs the scan phase first).
OP_RANGE = 4

KIND_ABSENT = 0
KIND_CONST = 1
KIND_KEEP = 2


def lane_masks(ops: torch.Tensor):
    """Classify a mixed batch's lanes: ``(is_point, is_range)`` masks.
    OP_NOP lanes are in neither."""
    is_range = ops == OP_RANGE
    is_point = (ops == OP_FIND) | (ops == OP_INSERT) | (ops == OP_DELETE)
    return is_point, is_range


def mask_range_lanes(ops: torch.Tensor) -> torch.Tensor:
    """OP_RANGE → OP_NOP, preserving lane positions, so op code 4 can never
    reach the combine."""
    return torch.where(ops == OP_RANGE, OP_NOP, ops).to(torch.int32)


class Transition(NamedTuple):
    """Composable transition; ``flag`` marks segment starts (once a
    boundary is crossed the left operand is discarded)."""

    a_kind: torch.Tensor  # action on absent:     KIND_ABSENT | KIND_CONST
    a_val: torch.Tensor
    p_kind: torch.Tensor  # action on present(w): KIND_ABSENT | KIND_CONST | KIND_KEEP
    p_val: torch.Tensor
    flag: torch.Tensor  # bool, True at segment starts


class EliminationResult(NamedTuple):
    """Per-op and per-segment outputs of the combine (sorted order), each
    ``(S, B)`` except ``n_eliminated`` ``(S,)``."""

    before_present: torch.Tensor  # state seen by each op (exclusive prefix)
    before_val: torch.Tensor
    after_present: torch.Tensor  # state after each op (inclusive prefix)
    after_val: torch.Tensor
    seg_head: torch.Tensor  # True at the first op of each key segment
    net_insert: torch.Tensor  # at seg head: key must be inserted (val=final)
    net_delete: torch.Tensor  # at seg head: key must be deleted
    net_overwrite: torch.Tensor  # at seg head: value must be overwritten
    final_val: torch.Tensor  # at seg head: value after the round
    n_eliminated: torch.Tensor  # update ops that required no physical write


def op_transition(op: torch.Tensor, val: torch.Tensor, is_start: torch.Tensor) -> Transition:
    """Lift one dictionary op to a Transition (find / nop: identity)."""
    is_ins = op == OP_INSERT
    is_del = op == OP_DELETE
    a_kind = torch.where(is_ins, KIND_CONST, KIND_ABSENT).to(torch.int32)
    a_val = torch.where(is_ins, val, torch.zeros_like(val))
    p_kind = torch.where(is_del, KIND_ABSENT, KIND_KEEP).to(torch.int32)
    p_val = torch.zeros_like(val)
    return Transition(a_kind, a_val, p_kind, p_val, is_start)


def identity_like(t: Transition) -> Transition:
    """The identity transition (no segment start), shaped like ``t``."""
    return Transition(
        torch.full_like(t.a_kind, KIND_ABSENT),
        torch.zeros_like(t.a_val),
        torch.full_like(t.p_kind, KIND_KEEP),
        torch.zeros_like(t.p_val),
        torch.zeros_like(t.flag),
    )


def compose(f: Transition, g: Transition) -> Transition:
    """h = g ∘ f (f happens first).  If g starts a segment, f is discarded.
    Associative: function composition + the segmented-scan flag monoid."""
    # absent leg: feed f's absent-output into g.
    f_a_present = f.a_kind != KIND_ABSENT
    g_keep = g.p_kind == KIND_KEEP
    gp_on_fa_kind = torch.where(g_keep, KIND_CONST, g.p_kind)
    gp_on_fa_val = torch.where(g_keep, f.a_val, g.p_val)
    h_a_kind = torch.where(f_a_present, gp_on_fa_kind, g.a_kind)
    h_a_val = torch.where(f_a_present, gp_on_fa_val, g.a_val)

    # present(w) leg: f(present(w)) is absent | const(f.p_val) | keep(w).
    f_p_present = f.p_kind != KIND_ABSENT
    hp_kind_fp = torch.where(
        g_keep,
        torch.where(f.p_kind == KIND_KEEP, KIND_KEEP, KIND_CONST).to(torch.int32),
        g.p_kind,
    )
    hp_val_fp = torch.where(g_keep, f.p_val, g.p_val)
    h_p_kind = torch.where(f_p_present, hp_kind_fp, g.a_kind)
    h_p_val = torch.where(f_p_present, hp_val_fp, g.a_val)

    return Transition(
        a_kind=torch.where(g.flag, g.a_kind, h_a_kind).to(torch.int32),
        a_val=torch.where(g.flag, g.a_val, h_a_val),
        p_kind=torch.where(g.flag, g.p_kind, h_p_kind).to(torch.int32),
        p_val=torch.where(g.flag, g.p_val, h_p_val),
        flag=f.flag | g.flag,
    )


def apply_transition(t: Transition, present0: torch.Tensor, val0: torch.Tensor):
    """Apply a (composed) transition to an initial state."""
    on_absent_p = t.a_kind != KIND_ABSENT
    on_absent_v = torch.where(t.a_kind == KIND_CONST, t.a_val, val0)
    on_present_p = t.p_kind != KIND_ABSENT
    on_present_v = torch.where(t.p_kind == KIND_CONST, t.p_val, val0)
    present = torch.where(present0, on_present_p, on_absent_p)
    val = torch.where(present0, on_present_v, on_absent_v)
    return present, val


def eliminate_batch(
    ops_sorted: torch.Tensor,  # (S, B) int32, key-sorted (stable ⇒ arrival order kept)
    vals_sorted: torch.Tensor,  # (S, B) int64
    seg_head: torch.Tensor,  # (S, B) bool, True at the first op of each key segment
    present0: torch.Tensor,  # (S, B) bool: pre-round presence of the op's key
    val0: torch.Tensor,  # (S, B) int64: pre-round value of the op's key
) -> EliminationResult:
    """Run the publishing-elimination combine over key-sorted rows.
    ``present0`` / ``val0`` need only be correct at segment heads."""
    from repro_torch.kernels.elim_combine.ops import elim_combine

    s, b = ops_sorted.shape
    idx = torch.arange(b, device=ops_sorted.device).expand(s, b)

    # Broadcast the segment head's initial state to every op in its segment.
    head_idx = torch.cummax(torch.where(seg_head, idx, 0), dim=1).values
    present0 = torch.gather(present0, 1, head_idx)
    val0 = torch.gather(val0, 1, head_idx)

    before_present, before_val, after_present, after_val = elim_combine(
        ops_sorted, vals_sorted, seg_head, present0, val0
    )

    # Segment-final state, surfaced at the segment head (where apply acts):
    # each op's segment end is the first segment end at or after it.
    seg_end = torch.cat([seg_head[:, 1:], torch.ones_like(seg_head[:, :1])], dim=1)
    end_idx = torch.where(seg_end, idx, b - 1)
    end_idx = torch.flip(torch.cummin(torch.flip(end_idx, [1]), dim=1).values, [1])
    final_present = torch.gather(after_present, 1, end_idx)
    final_val = torch.gather(after_val, 1, end_idx)

    net_insert = seg_head & ~present0 & final_present
    net_delete = seg_head & present0 & ~final_present
    net_overwrite = seg_head & present0 & final_present & (final_val != val0)
    n_net = (net_insert | net_delete | net_overwrite).sum(1)
    # An op is eliminated iff it would have modified the tree given the
    # state it observed but is not covered by the single net write.
    would_write = ((ops_sorted == OP_INSERT) & ~before_present) | (
        (ops_sorted == OP_DELETE) & before_present
    )
    n_eliminated = would_write.sum(1) - n_net

    return EliminationResult(
        before_present=before_present,
        before_val=before_val,
        after_present=after_present,
        after_val=after_val,
        seg_head=seg_head,
        net_insert=net_insert,
        net_delete=net_delete,
        net_overwrite=net_overwrite,
        final_val=final_val,
        n_eliminated=n_eliminated,
    )


def op_return_values(ops_sorted: torch.Tensor, res: EliminationResult, notfound: int) -> torch.Tensor:
    """Dictionary return values per §3 semantics, in sorted order: the value
    the op observed, or ⊥ (``notfound``) if absent."""
    ret = torch.where(res.before_present, res.before_val, notfound)
    return torch.where(ops_sorted == OP_NOP, notfound, ret)
