"""Op audit of the round engine's search and scan phases under
``torch.profiler`` (the port's counterpart of ``src/repro/obs/hlo_audit.py``).

A torch program has no HLO text to count ops in, so the audit counts what
the profiler saw while one phase ran: aten ops on the host, kernels on the
device.  It pins the claim JAX's audit pins: the scan descent and the scan
phase run no sort.  On the card it also checks that each phase launched its
hand-written kernels, so no plain version hides behind a phase: their
wrappers' launch counters count the launches exactly, and the profiler must
see each kernel by name:

  * ``search``       — ``rounds._phase_search_combine``: the descent and
    probe (K1, ``descend_probe_kernel``) and the combine (K3,
    ``elim_combine_kernel``), once each;
  * ``scan_descent`` — ``abtree.frontier_expand_sharded``: the frontier
    compaction (K2, ``compact_warp_rows`` / ``compact_block_row``);
  * ``scan_phase``   — ``rounds._phase_scan_flat``: K2 and the range gather
    (K4, a ``range_scan_*`` kernel).

On the CPU the wrappers take their plain versions (the range gather's is a
stable argsort), so a CPU audit records the counts and asserts nothing.
Like the tracer, the audit is host-side: a round's aten ops are the same
with the tracer on or off.
"""
from __future__ import annotations

import time
from collections import Counter
from typing import Dict, Iterable, Tuple

import numpy as np
import torch

from repro_torch.core.abtree import (
    EMPTY,
    OP_INSERT,
    OP_NOP,
    ABTree,
    TreeConfig,
    frontier_expand_sharded,
)
from repro_torch.core.rounds import (
    _pack_slots,
    _phase_scan_flat,
    _phase_search_combine,
    _pow2,
    build_plan,
)
from repro_torch.kernels import _lib
from repro_torch.obs.tracer import _has_cuda_tensor

__all__ = [
    "DEFAULT_OPS",
    "PHASE_KERNELS",
    "profile_ops",
    "count_ops",
    "kernel_launches",
    "wrapper_launches",
    "assert_no_sort",
    "audit_search_phases",
]

# aten ops worth counting in the search / scan pipeline: sorts are the
# structural cost the device descent removes; gathers, indexing and
# scatters are its indexed-load and write traffic.
DEFAULT_OPS: Tuple[str, ...] = (
    "aten::sort",
    "aten::argsort",
    "aten::gather",
    "aten::index",
    "aten::scatter",
    "aten::index_put_",
)
SORT_OPS: Tuple[str, ...] = ("aten::sort", "aten::argsort")

# The profiler keeps a device event only if its timestamp, converted to the
# host's clock, falls inside the session; late in a long process a session
# of a few milliseconds lost its first kernel (K1 of the search), and with
# a margin on both sides of the call one of 24 K2 launches was still
# missing.  So the audit runs each phase AUDIT_REPEAT times in its session,
# counts the launches exactly from the wrappers' launch counters, and asks
# the profiler only to see each kernel by name, at most as often as it ran.
DEVICE_MARGIN_S = 1.0
AUDIT_REPEAT = 3

# kernel -> (its wrapper's launch counter, substrings of its device kernels' names)
KERNELS: Dict[str, Tuple[str, Tuple[str, ...]]] = {
    "K1": ("descend_probe", ("descend_probe_kernel",)),
    "K2": ("frontier_compact", ("compact_warp_rows", "compact_block_row")),
    "K3": ("elim_combine", ("elim_combine_kernel",)),
    "K4": ("range_scan", ("range_scan_",)),
}
PHASE_KERNELS: Dict[str, Tuple[str, ...]] = {
    "search": ("K1", "K3"),
    "scan_descent": ("K2",),
    "scan_phase": ("K2", "K4"),
}
LAUNCHES = "launches:"  # prefix of the wrapper launch counts in an audit's counts


def profile_ops(fn, *args, **kw) -> Dict[str, int]:
    """Run ``fn(*args, **kw)`` once under ``torch.profiler`` and count every
    event by name: aten ops (and the runtime calls) on the host, and, when
    an argument holds a CUDA tensor, the kernels the card ran."""
    from torch.profiler import ProfilerActivity, profile

    cuda = _has_cuda_tensor(args) or _has_cuda_tensor(kw)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    if cuda:
        torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        if cuda:
            time.sleep(DEVICE_MARGIN_S)
        fn(*args, **kw)
        if cuda:
            torch.cuda.synchronize()
            time.sleep(DEVICE_MARGIN_S)
    return dict(Counter(e.name for e in prof.events()))


def count_ops(counts: Dict[str, int], ops: Iterable[str] = DEFAULT_OPS) -> Dict[str, int]:
    """The counts of ``ops`` among a profile's event counts."""
    return {op: int(counts.get(op, 0)) for op in ops}


def kernel_launches(counts: Dict[str, int], program: str) -> Dict[str, int]:
    """The profiler's device events of each hand-written kernel ``program``
    runs on the card."""
    return {
        k: sum(n for name, n in counts.items()
               if not name.startswith(LAUNCHES) and any(s in name for s in KERNELS[k][1]))
        for k in PHASE_KERNELS[program]
    }


def wrapper_launches(counts: Dict[str, int], program: str) -> Dict[str, int]:
    """The launches of each of ``program``'s kernels that their wrappers
    counted during an audit (``audit_search_phases``)."""
    return {k: int(counts.get(LAUNCHES + KERNELS[k][0], 0)) for k in PHASE_KERNELS[program]}


def assert_no_sort(counts: Dict[str, int], what: str = "program") -> None:
    n = sum(int(counts.get(op, 0)) for op in SORT_OPS)
    if n:
        raise AssertionError(
            f"{what}: expected no sort, found {n} aten::sort / aten::argsort op(s)")


def _default_holder(device):
    """The small populated tree JAX's audit lowers against (its scans at
    frontier 16) and JAX's batch."""
    t = ABTree(TreeConfig(capacity=2048, b=8, a=2, max_height=12), device=device)
    t._scan_frontier = 16
    rng = np.random.default_rng(0)
    keys = rng.choice(10**6, size=600, replace=False).astype(np.int64)
    t.apply_round(np.full(600, OP_INSERT, np.int32), keys, keys)
    batch = (
        np.full(256, OP_INSERT, np.int32),
        rng.integers(0, 10**6, 256).astype(np.int64),
        np.zeros(256, np.int64),
    )
    return t, batch


def _phase_inputs(holder, batch):
    """The search phase's packed ``(S, W)`` point lanes and the scan phase's
    ``(sid, lo, hi)`` lanes of one round, routed as ``execute_plan`` and
    ``scan_lanes`` route them (a range lane is cut to its first shard)."""
    plan = build_plan(*batch)
    ops = plan.ops.numpy()
    keys = plan.keys.numpy()
    vals = plan.vals.numpy()
    s = holder.n_shards
    pl = np.nonzero((ops != OP_NOP) & ~plan.is_range.numpy())[0]
    shard = np.searchsorted(holder._splits, keys[pl], side="right")
    w = _pow2(int(np.bincount(shard, minlength=s).max()) if pl.size else 0)
    ops_sw = np.zeros((s, w), np.int32)
    keys_sw = np.zeros((s, w), np.int64)
    vals_sw = np.zeros((s, w), np.int64)
    shard_sorted, slot_sorted, order = _pack_slots(shard, s)
    ops_sw[shard_sorted, slot_sorted] = ops[pl][order]
    keys_sw[shard_sorted, slot_sorted] = keys[pl][order]
    vals_sw[shard_sorted, slot_sorted] = vals[pl][order]

    rl = np.nonzero(plan.is_range.numpy())[0]
    cap = plan.scan_cap
    if rl.size:
        lo = plan.lo.numpy()[rl]
        sid = np.searchsorted(holder._splits, lo, side="right")
        hi = np.minimum(plan.hi.numpy()[rl], np.asarray(holder._bounds, np.int64)[sid + 1])
    else:  # JAX's audit lanes: two intervals of shard 0, cap 32
        lo = np.array([0, 10**5], np.int64)
        hi = np.array([10**4, 10**6], np.int64)
        sid = np.zeros(2, np.int64)
        cap = 32
    n = _pow2(lo.size)
    sid_w = np.zeros(n, np.int64)
    lo_w = np.full(n, EMPTY, np.int64)
    hi_w = np.full(n, EMPTY, np.int64)
    sid_w[: lo.size], lo_w[: lo.size], hi_w[: lo.size] = sid, lo, hi
    dev = holder.device
    point = tuple(torch.as_tensor(x, device=dev) for x in (ops_sw, keys_sw, vals_sw))
    scan = tuple(torch.as_tensor(x, device=dev) for x in (sid_w, lo_w, hi_w))
    return point, scan, cap


def _repeated(fn):
    """``fn`` run AUDIT_REPEAT times on the same arguments."""
    def run(*args):
        for _ in range(AUDIT_REPEAT):
            fn(*args)
    return run


def _audited(fn, *args) -> Dict[str, int]:
    """``fn``'s profile, AUDIT_REPEAT runs in one session, with the launches
    its kernels' wrappers counted under ``LAUNCHES + counter name``."""
    before = {c: _lib.counter(c).launches for c, _ in KERNELS.values()}
    counts = profile_ops(_repeated(fn), *args)
    for c, n in before.items():
        counts[LAUNCHES + c] = _lib.counter(c).launches - n
    return counts


def audit_search_phases(holder=None, batch=None, device=None) -> Dict[str, Dict[str, int]]:
    """Run the round engine's search and scan phases on ``holder``'s state
    (an ``ABTree`` or ``ABForest``; by default the small tree JAX's audit
    builds, on ``device``, which defaults to the card) over one round
    ``batch = (ops, keys, vals)`` (by default JAX's 256 inserts and two scan
    intervals), each AUDIT_REPEAT times in one profiler session, and return
    ``{program: event counts}`` for ``search``, ``scan_descent`` and
    ``scan_phase``; the counts also hold the launches each kernel's wrapper
    counted (``wrapper_launches``).  Nothing is committed to the holder.

    On the card the audit fails if ``scan_descent`` or ``scan_phase`` ran a
    sort, if a phase's kernel (``PHASE_KERNELS``) was not launched by its
    wrapper or not seen by the profiler, or if one search did not launch
    K1 and K3 once each."""
    if holder is None:
        holder, default_batch = _default_holder(_lib.resolve_device(device, "audit_search_phases"))
        batch = default_batch if batch is None else batch
    if batch is None:
        raise ValueError("audit_search_phases: a holder needs a batch")
    point, (sid, lo, hi), cap = _phase_inputs(holder, batch)
    state, cfg, frontier = holder.stacked, holder.cfg, holder._scan_frontier
    out = {
        "search": _audited(_phase_search_combine, state, point, cfg),
        "scan_descent": _audited(frontier_expand_sharded, state, cfg, sid, lo, hi, frontier),
        "scan_phase": _audited(_phase_scan_flat, state, cfg, sid, lo, hi, frontier, cap),
    }
    if holder.device.type == "cuda":
        for program in ("scan_descent", "scan_phase"):
            assert_no_sort(out[program], program)
        for program, counts in out.items():
            launched = wrapper_launches(counts, program)
            seen = kernel_launches(counts, program)
            bad = [k for k in launched if not 0 < seen[k] <= launched[k]]
            if bad:
                other = sorted(n for n in counts if not n.startswith(("aten::", "cuda", LAUNCHES)))
                raise AssertionError(
                    f"{program}: {bad} launched {launched}, seen by the profiler {seen} on the "
                    f"card; the session's other events: {other[:40]}")
        launched = wrapper_launches(out["search"], "search")
        if launched != {"K1": AUDIT_REPEAT, "K3": AUDIT_REPEAT}:
            raise AssertionError(f"search: expected one launch each of K1 and K3 a call, "
                                 f"{AUDIT_REPEAT} calls: {launched}")
    return out
