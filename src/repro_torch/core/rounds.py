"""Round engine: one (S, W) pipeline behind every round (port of
``src/repro/core/rounds.py``).

A *round* is a batch of mutually concurrent dictionary operations.  The
public ``ABTree`` entry points build a :class:`RoundPlan` (lane
classification) and hand it to :func:`execute_plan`, which sequences

    scan → search/combine → apply → retry → rebalance

  ``scan``            optimistic readers over a leaf frontier: gather
                      against a state snapshot, record every node read,
                      re-validate versions (retry on conflict).  Runs first,
                      so range lanes observe the pre-round dictionary.
  ``search/combine``  root-to-leaf descent + unsorted-leaf probe (kernel
                      ``descend_probe``), then the publishing-elimination
                      combine (kernel ``elim_combine``): all ops on one key
                      fold to <= 1 net physical write.
  ``apply``           the collapsed net writes + version bump (+2, odd
                      intermediate stamped on the ElimRecord).
  ``retry``           deferred inserts (leaf full) re-descend after the
                      splits their overflow triggered.
  ``rebalance``       relaxed-rebalancing waves (split / merge / distribute),
                      each touching <= 1 violating child per parent.

The JAX engine wrote each phase per shard and ``jax.vmap``-ed it over the
stacked state.  Here every phase function takes the stacked ``(S, ...)``
state and ``(S, W)`` lane blocks directly (the JAX ``_v_*`` wrappers and
the per-shard ``_phase_*`` kernels are one function each), so ``ABTree``
is S = 1 and ``ABForest`` (``core/forest.py``) runs the same phases on its
(S, ...) stack.

Lane classes: in ``elim`` mode a shard's point lanes run one combine; in
``occ`` mode duplicate keys force sub-rounds (duplicate rank r executes in
sub-round r, re-packed to the live lanes only).  Range lanes are served by
the scan phase; cross-shard lanes split into per-shard sub-lanes and
stitch back in key order.

Holder protocol (duck-typed, as in the JAX engine): ``stacked``, ``cfg``,
``mode``, ``n_shards``, ``device``, ``_splits`` / ``_bounds``, ``_wave_w``,
``_scan_frontier``, ``_ensure_capacity(n)``, ``scan_hook`` /
``subround_hook``, ``_rounds`` / ``_scans`` / ``_scan_retries``,
``_scan_active`` (in-flight scans defer shard splits),
``_maybe_split_shards()`` / ``_maybe_repartition()`` (forest lifecycle;
no-ops on ``ABTree``), ``metrics``, ``tracer``, ``recorder``, and the
optional router callbacks ``_note_shard_load(counts)`` /
``_note_key_sample(keys)``.

Host loops (``_split_cascade``, ``_fix_underfull_all``) copy ``size``,
``parent`` and ``alloc`` to the host every wave, exactly as the JAX engine
does.  Results come back as host (CPU) tensors: the engine assembles them in
numpy.
"""
from __future__ import annotations

from typing import List, NamedTuple

import numpy as np
import torch

from repro_torch.core import elimination as elim
from repro_torch.core.abtree import (
    EMPTY,
    INT_MAX,
    KEY_DTYPE,
    NOTFOUND,
    OP_NOP,
    OP_RANGE,
    RoundOutput,
    ScanConflictError,
    ScanOutput,
    TreeConfig,
    TreeState,
    VAL_DTYPE,
    _get,
    _leaf_rows,
    _segment_starts,
    apply_net_ops,
    frontier_expand_sharded,
    shrink_root,
    split_wave,
    underfull_wave,
)
from repro_torch.kernels.range_scan.ops import range_scan
from repro_torch.kernels.tree_descend.ops import descend_probe
from repro_torch.obs.recorder import NULL_RECORDER
from repro_torch.obs.tracer import NULL_TRACER

# ----------------------------------------------------------------------------
# telemetry accessors (host-side only)
# ----------------------------------------------------------------------------


def _tr(holder):
    t = getattr(holder, "tracer", None)
    return NULL_TRACER if t is None else t


def _metrics(holder):
    return getattr(holder, "metrics", None)


def _rec(holder):
    r = getattr(holder, "recorder", None)
    return NULL_RECORDER if r is None else r


def _np(x: torch.Tensor) -> np.ndarray:
    return x.cpu().numpy()


def _elim_note(ops_sw, ks, arrival, res) -> dict:
    """Host summary of one combine's elimination decisions: per-shard
    eliminated-op counts plus every multi-update key segment with its net
    physical action.  Built only when a recorder is enabled."""
    ks_np = _np(ks)  # (S, W) key-sorted; EMPTY on NOP lanes
    arr_np = _np(arrival)  # sorted pos -> packed lane slot
    seg_np = _np(res.seg_head)
    ni = _np(res.net_insert)
    nd = _np(res.net_delete)
    no = _np(res.net_overwrite)
    nel = _np(res.n_eliminated).reshape(-1)
    ops_np = _np(ops_sw)
    segments = []
    for s in range(ks_np.shape[0]):
        ops_sorted = ops_np[s][arr_np[s]]
        upd = (ops_sorted == elim.OP_INSERT) | (ops_sorted == elim.OP_DELETE)
        if int(upd.sum()) < 2:
            continue
        seg_id = np.cumsum(seg_np[s]) - 1
        multi = np.nonzero(np.bincount(seg_id[upd]) >= 2)[0]
        heads = np.nonzero(seg_np[s])[0]
        for g in multi.tolist():
            head = int(heads[g])
            key = int(ks_np[s][head])
            if key == EMPTY:
                continue
            in_seg = (seg_id == g) & upd
            net = (
                "insert" if ni[s][head]
                else "delete" if nd[s][head]
                else "overwrite" if no[s][head]
                else "none"
            )
            segments.append(
                {
                    "shard": int(s),
                    "key": key,
                    "lanes": arr_np[s][in_seg].astype(np.int64).tolist(),
                    "net": net,
                }
            )
    return {"eliminated": nel.astype(np.int64).tolist(), "segments": segments}


def _note_load(holder, counts):
    """Feed per-shard routed-lane counts to the holder's hot-shard detector
    (a forest concern; ``ABTree``'s is a no-op)."""
    note = getattr(holder, "_note_shard_load", None)
    if note is not None:
        note(counts)


def _note_keys(holder, keys):
    """Feed routed lane keys to the holder's key-sample reservoir (the
    forest's load-weighted split points; ``ABTree`` has none)."""
    note = getattr(holder, "_note_key_sample", None)
    if note is not None:
        note(keys)


def _note_pack(holder, tr_span, width: int, n_real: int):
    """Record one lane-pack's width + pad waste (gauges + span args)."""
    waste = (width - n_real) / width if width else 0.0
    m = _metrics(holder)
    if m is not None:
        m.set_gauge("router_pack_width", width)
        m.set_gauge("pad_waste_frac", waste)
        m.observe("pack_pad_waste", waste)
    tr_span.note(width=width, real=n_real, pad_waste=round(waste, 4))


# ----------------------------------------------------------------------------
# Round plans: lane classification
# ----------------------------------------------------------------------------


class RoundPlan(NamedTuple):
    """A classified round, built on the host once per round (host tensors:
    the engine routes and packs lanes in numpy before anything reaches the
    device)."""

    ops: torch.Tensor  # (B,) int32 — original lane opcodes
    point_ops: torch.Tensor  # (B,) int32 — OP_RANGE masked to OP_NOP
    keys: torch.Tensor  # (B,) int64
    vals: torch.Tensor  # (B,) int64 (span on range lanes)
    lo: torch.Tensor  # (B,) scan lower bounds; EMPTY on non-range lanes
    hi: torch.Tensor  # (B,) scan upper bounds; EMPTY on non-range lanes
    is_range: torch.Tensor  # (B,) bool
    has_point: bool
    has_range: bool
    n_range: int
    scan_cap: int


def build_plan(ops, keys, vals=None, *, scan_cap: int = 128) -> RoundPlan:
    """Classify one round's lanes and derive the range lanes' intervals.
    OP_RANGE lane: ``key = lo``, ``val = span`` → scans ``[lo, lo + span)``.
    Raises ``ValueError`` for negative spans and unknown op codes."""
    ops_np = np.asarray(ops, np.int32)
    keys_np = np.asarray(keys, np.int64)
    vals_np = np.zeros_like(keys_np) if vals is None else np.asarray(vals, np.int64)
    if not (ops_np.shape == keys_np.shape == vals_np.shape and ops_np.ndim == 1):
        raise ValueError("apply_round expects equal-length 1-D ops/keys/vals")
    if ops_np.size and (ops_np.min() < OP_NOP or ops_np.max() > OP_RANGE):
        bad = ops_np[(ops_np < OP_NOP) | (ops_np > OP_RANGE)][0]
        raise ValueError(f"unknown op code {int(bad)}")
    is_range_np = ops_np == OP_RANGE
    if np.any(is_range_np & (vals_np < 0)):
        lane = int(np.nonzero(is_range_np & (vals_np < 0))[0][0])
        raise ValueError(
            f"malformed OP_RANGE lane {lane}: negative span {int(vals_np[lane])} "
            f"(hi = lo + span < lo)"
        )
    n_range = int(is_range_np.sum())
    has_point = bool(np.any((ops_np > OP_NOP) & ~is_range_np))
    # hi = lo + span, saturating at EMPTY (a span past the top of the key
    # space scans everything >= lo instead of wrapping negative).
    with np.errstate(over="ignore"):
        hi_np = keys_np + vals_np
    hi_np = np.where(is_range_np & (hi_np < keys_np), EMPTY, hi_np)
    # non-range lanes scan the empty interval [EMPTY, EMPTY)
    lo_np = np.where(is_range_np, keys_np, EMPTY)
    hi_np = np.where(is_range_np, hi_np, EMPTY)
    ops_t = torch.from_numpy(ops_np)
    return RoundPlan(
        ops=ops_t,
        point_ops=elim.mask_range_lanes(ops_t),
        keys=torch.as_tensor(keys_np, dtype=KEY_DTYPE),
        vals=torch.as_tensor(vals_np, dtype=VAL_DTYPE),
        lo=torch.as_tensor(lo_np, dtype=KEY_DTYPE),
        hi=torch.as_tensor(hi_np, dtype=KEY_DTYPE),
        is_range=torch.from_numpy(is_range_np),
        has_point=has_point,
        has_range=n_range > 0,
        n_range=n_range,
        scan_cap=scan_cap,
    )


# ----------------------------------------------------------------------------
# Phase functions over the stacked state (device work; the host code below
# only sequences them)
# ----------------------------------------------------------------------------


def _phase_scan_flat(state: TreeState, cfg: TreeConfig, sid, lo, hi, frontier_cap: int, cap: int):
    """Flat ragged frontier expansion + in-range gather over the stacked
    state: one launch per level covers every shard's scan sub-lanes (lane
    ``i`` expands inside shard ``sid[i]``); the gather is the
    ``range_scan`` kernel."""
    _, ck, cv, touched, overflow = frontier_expand_sharded(state, cfg, sid, lo, hi, frontier_cap)
    keys, vals, count, truncated = range_scan(ck, cv, lo, hi, cap=cap)
    return ScanOutput(keys=keys, vals=vals, count=count, truncated=truncated), touched, overflow


def _search_leaves(state: TreeState, cfg: TreeConfig, ks):
    """The search phase proper: fused descent + probe (``descend_probe``)."""
    return descend_probe(
        state.keys, state.vals, state.children, state.is_leaf, state.root, ks,
        max_height=cfg.max_height, notfound=NOTFOUND,
    )


def _phase_search_combine(state: TreeState, batch, cfg: TreeConfig):
    """sort → descend → probe → eliminate over (S, W) lanes.  Returns the new
    state and everything apply needs plus per-op results in arrival order."""
    ops, keys, vals = batch
    bsz = ops.shape[1]
    sort_keys = torch.where(ops == OP_NOP, EMPTY, keys)
    perm = torch.argsort(sort_keys, dim=1, stable=True)
    inv = torch.empty_like(perm)
    inv.scatter_(1, perm, torch.arange(bsz, device=perm.device).expand_as(perm))
    ks = torch.gather(sort_keys, 1, perm)
    os_ = torch.gather(ops, 1, perm)
    vs = torch.gather(vals, 1, perm)
    arrival = perm.to(torch.int32)

    seg_head = _segment_starts(ks)
    leaf_ids, found, slot, val0 = _search_leaves(state, cfg, ks)

    res = elim.eliminate_batch(os_, vs, seg_head, found, torch.where(found, val0, 0))
    rets_sorted = elim.op_return_values(os_, res, NOTFOUND)
    results = torch.gather(rets_sorted, 1, inv)
    found_out = torch.gather(rets_sorted != NOTFOUND, 1, inv)

    stats = state.stats._replace(
        searches=state.stats.searches + bsz,
        eliminated=state.stats.eliminated + res.n_eliminated,
    )
    state = state._replace(stats=stats)
    return state, (ks, arrival, leaf_ids, slot, res, results, found_out)


def _phase_apply(state: TreeState, cfg: TreeConfig, ks, arrival, leaf_ids, slot, res):
    out = apply_net_ops(
        state, cfg, leaf_ids, ks, slot,
        res.net_insert, res.net_delete, res.net_overwrite, res.final_val, arrival,
    )
    return out.state, out.deferred


def _phase_retry_insert(state: TreeState, cfg: TreeConfig, ks, vals, arrival, deferred):
    """Re-descend deferred keys and retry the insert (post-split)."""
    leaf_ids, found, slot, _ = _search_leaves(state, cfg, ks)
    net_insert = deferred & ~found
    none = torch.zeros_like(deferred)
    out = apply_net_ops(state, cfg, leaf_ids, ks, slot, net_insert, none, none, vals, arrival)
    return out.state, out.deferred & deferred


def _phase_overfull_leaves(state: TreeState, cfg: TreeConfig, ks, deferred):
    """(S, W) unique sorted ids of full leaves holding deferred inserts,
    INT_MAX-padded."""
    leaf_ids = _search_leaves(state, cfg, ks)[0]
    full = deferred & (_get(state.size, _leaf_rows(state, leaf_ids)) >= cfg.b)
    ids = torch.where(full, leaf_ids, INT_MAX)
    srt = torch.sort(ids, dim=1).values
    return torch.where(_segment_starts(srt), srt, INT_MAX)


# ----------------------------------------------------------------------------
# host helpers
# ----------------------------------------------------------------------------


def _pow2(n: int) -> int:
    """Shared pad width: power of two ≥ n, floor 8."""
    return max(8, 1 << (int(n) - 1).bit_length())


def _pack_slots(shard: np.ndarray, n_shards: int):
    """Per-shard slot assignment for lane packing: ``(shard_sorted,
    slot_sorted, order)``; ``order`` stably sorts lanes by shard."""
    order = np.argsort(shard, kind="stable")
    shard_sorted = shard[order]
    starts = np.searchsorted(shard_sorted, np.arange(n_shards))
    slot_sorted = np.arange(shard_sorted.size) - starts[shard_sorted]
    return shard_sorted, slot_sorted, order


def _independent_by_parent_np(parent_row: np.ndarray, ids: np.ndarray) -> np.ndarray:
    """Keep one node per parent (lowest id first)."""
    keep, seen = [], set()
    for nid in ids.tolist():
        p = int(parent_row[nid])
        if p not in seen:
            seen.add(p)
            keep.append(int(nid))
    return np.asarray(keep, np.int32)


def _duplicate_ranks(ops_np: np.ndarray, keys_np: np.ndarray) -> np.ndarray:
    """Per-lane duplicate rank of each key (OP_NOP lanes rank 0): rank r
    executes in occ sub-round r.  A stable sort groups equal keys in
    arrival order, so a lane's rank is its offset from its key run's
    first occurrence."""
    rank = np.zeros(ops_np.shape[0], np.int32)
    idx = np.nonzero(ops_np != OP_NOP)[0]
    if idx.size == 0:
        return rank
    k = keys_np[idx]
    order = np.argsort(k, kind="stable")
    ks = k[order]
    run_start = np.searchsorted(ks, ks, side="left")
    rank[idx[order]] = (np.arange(ks.size) - run_start).astype(np.int32)
    return rank


# ----------------------------------------------------------------------------
# Phase: scan (optimistic reader; linearizes before the round's writes)
# ----------------------------------------------------------------------------


def gather_until_frontier_fits(holder, gather):
    """Run ``gather(frontier_cap) → (out, touched, overflow)``, doubling
    ``holder._scan_frontier`` until no lane overflows its leaf frontier.
    Returns (out, touched)."""
    guard = 0
    while True:
        out, touched, overflow = gather(holder._scan_frontier)
        if not bool(overflow.any()):
            return out, touched
        guard += 1
        if guard >= 32:
            raise RuntimeError("scan frontier growth diverged")
        holder._scan_frontier *= 2


def scan_lanes(holder, lo_np, hi_np, cap, *, n_scan_ops, max_retries: int = 8):
    """Split lanes ``[lo_i, hi_i)`` at shard boundaries, run one flat scan
    phase over all sub-lanes and stitch sub-lane rows back per lane in key
    order.  With S = 1 every lane is its own single sub-lane.  Returns numpy
    ``(keys (B, cap), vals, count, truncated)``."""
    n_shards = holder.n_shards
    bsz = int(lo_np.size)
    lo_np = np.asarray(lo_np, np.int64)
    hi_np = np.asarray(hi_np, np.int64)
    out_k = np.full((bsz, cap), EMPTY, np.int64)
    out_v = np.zeros((bsz, cap), np.int64)
    out_c = np.zeros((bsz,), np.int32)
    out_t = np.zeros((bsz,), bool)
    holder._scans += int(n_scan_ops)
    tr = _tr(holder)
    m = _metrics(holder)
    live = hi_np > lo_np
    comp = np.arange(n_shards)  # union-find over cross-shard-linked shards

    def _root(x):
        while comp[x] != x:
            comp[x] = comp[comp[x]]
            x = comp[x]
        return x

    with tr.span("router_pack", lanes=bsz) as pack_sp:
        s0 = np.searchsorted(holder._splits, lo_np, side="right")
        s1 = np.searchsorted(holder._splits, np.maximum(hi_np - 1, lo_np), side="right")
        multi = np.nonzero(live & (s0 < s1))[0]
        single = np.nonzero(live & (s0 == s1))[0]
        if multi.size == 0:
            lane_of = single
            sub_sid = s0[single]
            sub_lo = lo_np[single]
            sub_hi = hi_np[single]
        else:
            # cross-shard lanes split at shard boundaries; a stable
            # lane-major sort keeps each lane's sub-lanes contiguous.
            ln, sd, lo_l, hi_l = [single], [s0[single]], [lo_np[single]], [hi_np[single]]
            for i in multi.tolist():
                for s in range(int(s0[i]), int(s1[i]) + 1):
                    slo = max(int(lo_np[i]), holder._bounds[s])
                    shi = min(int(hi_np[i]), holder._bounds[s + 1])
                    if shi <= slo:
                        continue
                    ln.append(np.array([i]))
                    sd.append(np.array([s]))
                    lo_l.append(np.array([slo]))
                    hi_l.append(np.array([shi]))
                    # all of a lane's shards validate against ONE snapshot
                    comp[_root(int(s0[i]))] = _root(s)
            lane_of = np.concatenate(ln).astype(np.int64)
            sub_sid = np.concatenate(sd).astype(np.int64)
            sub_lo = np.concatenate(lo_l).astype(np.int64)
            sub_hi = np.concatenate(hi_l).astype(np.int64)
            order = np.argsort(lane_of, kind="stable")
            lane_of, sub_sid = lane_of[order], sub_sid[order]
            sub_lo, sub_hi = sub_lo[order], sub_hi[order]
        n_sub = int(sub_sid.size)
        n_per = np.bincount(sub_sid, minlength=n_shards).astype(np.int64)
        if n_sub:
            _note_pack(holder, pack_sp, _pow2(n_sub), n_sub)
    tr.shard_marks("scan.sublanes", n_per)
    _note_load(holder, n_per)
    if live.any():
        _note_keys(holder, lo_np[live])
    if m is not None:
        for s in np.nonzero(n_per)[0]:
            m.inc_shard("scan_sublanes", int(n_per[s]), int(s))
        m.inc("scan_sublanes", int(n_per.sum()))
    if n_sub == 0:
        return out_k, out_v, out_c, out_t
    groups = np.array([_root(s) for s in range(n_shards)])
    buf_k, buf_v, buf_c, buf_t = run_scan_phase(
        holder, sub_sid, sub_lo, sub_hi, cap, max_retries, groups
    )
    if multi.size == 0:
        out_k[lane_of] = buf_k
        out_v[lane_of] = buf_v
        out_c[lane_of] = buf_c
        out_t[lane_of] = buf_t
        return out_k, out_v, out_c, out_t
    with tr.span("router_stitch", lanes=bsz):
        starts = np.searchsorted(lane_of, np.arange(bsz))
        ends = np.searchsorted(lane_of, np.arange(bsz) + 1)
        for i in np.unique(lane_of).tolist():
            a, e = int(starts[i]), int(ends[i])
            if e - a == 1:
                out_k[i], out_v[i], out_c[i], out_t[i] = buf_k[a], buf_v[a], buf_c[a], buf_t[a]
                continue
            parts_k, parts_v, truncated = [], [], False
            for j in range(a, e):  # shards ascending ⇒ keys ascending
                c = int(buf_c[j])
                truncated = truncated or bool(buf_t[j])
                parts_k.append(buf_k[j, :c])
                parts_v.append(buf_v[j, :c])
            cat_k = np.concatenate(parts_k)
            cat_v = np.concatenate(parts_v)
            n = min(cat_k.size, cap)
            out_k[i, :n] = cat_k[:n]
            out_v[i, :n] = cat_v[:n]
            out_c[i] = n
            out_t[i] = truncated or cat_k.size > cap
    return out_k, out_v, out_c, out_t


def run_scan_phase(holder, sub_sid, sub_lo, sub_hi, cap, max_retries: int = 8, groups=None):
    """One flat gather over all sub-lanes + per-component version
    validation: shards linked by a cross-shard lane (``groups``) accept or
    retry together.  A retry re-packs only the pending components' lanes.
    ``scan_retries`` accrues the retried lane count; ``ScanConflictError``
    after ``max_retries``.  ``holder.scan_hook`` runs between each gather
    and its validation."""
    n_s = holder.n_shards
    dev = holder.device
    sub_sid = np.asarray(sub_sid, np.int64)
    sub_lo = np.asarray(sub_lo, np.int64)
    sub_hi = np.asarray(sub_hi, np.int64)
    n_sub = int(sub_sid.size)
    if groups is None:
        groups = np.arange(n_s)
    buf_k = np.full((n_sub, cap), EMPTY, np.int64)
    buf_v = np.zeros((n_sub, cap), np.int64)
    buf_c = np.zeros((n_sub,), np.int32)
    buf_t = np.zeros((n_sub,), bool)
    n_per_shard = np.bincount(sub_sid, minlength=n_s).astype(np.int64)
    pending = n_per_shard > 0
    cur = np.arange(n_sub)
    retried = 0
    tr = _tr(holder)
    m = _metrics(holder)
    # a scan_hook writer may push a shard past max_keys_per_shard: the split
    # (a restack to S + 1 shards) must not fire under this loop's lane
    # routing, so it waits for the next round boundary.
    holder._scan_active += 1
    try:
        with tr.span("scan", lanes=n_sub, shards=n_s) as scan_sp:
            for attempt in range(max_retries):
                w = _pow2(cur.size)
                sid_w = np.zeros(w, np.int64)
                lo_w = np.full(w, EMPTY, np.int64)
                hi_w = np.full(w, EMPTY, np.int64)
                sid_w[: cur.size] = sub_sid[cur]
                lo_w[: cur.size] = sub_lo[cur]
                hi_w[: cur.size] = sub_hi[cur]
                snap = holder.stacked
                with tr.span("scan.gather", attempt=attempt, width=w) as sp:
                    sid_t = torch.as_tensor(sid_w, device=dev)
                    lo_t = torch.as_tensor(lo_w, device=dev)
                    hi_t = torch.as_tensor(hi_w, device=dev)
                    out, touched = gather_until_frontier_fits(
                        holder,
                        lambda fc: _phase_scan_flat(snap, holder.cfg, sid_t, lo_t, hi_t, fc, cap),
                    )
                    sp.fence((out, touched))
                if holder.scan_hook is not None:
                    holder.scan_hook()
                with tr.span("scan.validate", attempt=attempt):
                    snap_ver = _np(snap.ver)
                    live_ver = _np(holder.stacked.ver)
                    touched_np = _np(touched)  # (L, w, F) per-lane ids
                    shard_ok = np.zeros(n_s, bool)
                    for s in np.nonzero(pending)[0]:
                        ids = np.unique(touched_np[:, sid_w == s, :])
                        shard_ok[s] = np.array_equal(snap_ver[s][ids], live_ver[s][ids])
                    accept = np.zeros(n_s, bool)
                    for g in np.unique(groups[pending]):
                        members = pending & (groups == g)
                        if shard_ok[members].all():
                            accept |= members
                        else:  # whole component re-gathers next attempt
                            retried += int(n_per_shard[members].sum())
                            if m is not None:
                                for s in np.nonzero(members)[0]:
                                    m.inc_shard("scan_retries", int(n_per_shard[s]), int(s))
                            tr.shard_marks(
                                "scan.retry", np.where(members, n_per_shard, 0), attempt=attempt
                            )
                if accept.any():
                    rows = np.nonzero(accept[sub_sid[cur]])[0]
                    buf_k[cur[rows]] = _np(out.keys)[rows]
                    buf_v[cur[rows]] = _np(out.vals)[rows]
                    buf_c[cur[rows]] = _np(out.count)[rows]
                    buf_t[cur[rows]] = _np(out.truncated)[rows]
                    pending &= ~accept
                if not pending.any():
                    holder._scan_retries += retried
                    scan_sp.note(retries=retried, attempts=attempt + 1)
                    rec = _rec(holder)
                    if rec.enabled:
                        rec.note_scan_phase(retries=retried, attempts=attempt + 1)
                    return buf_k, buf_v, buf_c, buf_t
                cur = cur[pending[sub_sid[cur]]]
            raise ScanConflictError(
                f"scan phase: version validation failed {max_retries} "
                f"times on shards {np.nonzero(pending)[0].tolist()}"
            )
    finally:
        holder._scan_active -= 1


def execute_scan(holder, lo, hi, cap: int = 128, max_retries: int = 8) -> ScanOutput:
    """One batched scan round: per query the <= ``cap`` smallest keys in
    ``[lo_i, hi_i)``, ascending (``ABTree.scan_round``)."""
    lo = np.atleast_1d(np.asarray(lo, np.int64))
    hi = np.atleast_1d(np.asarray(hi, np.int64))
    if lo.shape != hi.shape or lo.ndim != 1:
        raise ValueError("scan_round expects equal-length 1-D lo/hi")
    k_, v_, c_, t_ = scan_lanes(holder, lo, hi, cap, n_scan_ops=int(lo.size), max_retries=max_retries)
    rec = _rec(holder)
    if rec.enabled:
        rec.round(
            round_no=holder._rounds,
            mode=holder.mode,
            n_shards=holder.n_shards,
            ops=np.full((lo.size,), OP_RANGE, np.int32),
            keys=lo,
            vals=hi - lo,
            results=c_.astype(np.int64),
            found=c_ > 0,
            scans={i: list(zip(k_[i, : c_[i]].tolist(), v_[i, : c_[i]].tolist())) for i in range(lo.size)},
            scan_cap=cap,
            fused="scan",
        )
    # scan rounds never split shards (splits wait for the next update
    # round), but load rebalancing may act: read skew is what the hot-shard
    # window sees on scan traffic.
    holder._maybe_repartition()
    return ScanOutput(
        keys=torch.from_numpy(k_), vals=torch.from_numpy(v_),
        count=torch.from_numpy(c_), truncated=torch.from_numpy(t_),
    )


def execute_scan_stream(holder, lo, hi, cap: int):
    """Validate eagerly (a generator body would not run until the first
    ``next``), then stream ``[lo, hi)`` as cursor-chained pages."""
    if cap <= 0:
        raise ValueError(f"scan_stream: cap must be positive, got {cap}")
    return scan_stream_pages(holder, int(lo), int(hi), cap)


def scan_stream_pages(holder, cur: int, hi: int, cap: int):
    """Stream every (key, value) in ``[cur, hi)`` ascending by chaining
    per-shard cursors: each page queries only the shard holding the cursor,
    so a long cross-shard scan stays bounded at ``cap`` entries (and one
    shard's gather) a round."""
    while cur < hi:
        s = int(np.searchsorted(holder._splits, cur, side="right"))
        s_hi = min(hi, holder._bounds[s + 1])
        out = holder.scan_round([cur], [s_hi], cap=cap)
        n = int(out.count[0])
        ks = out.keys[0, :n].tolist()
        vs = out.vals[0, :n].tolist()
        yield from zip(ks, vs)
        if bool(out.truncated[0]):
            cur = ks[-1] + 1
        else:
            cur = s_hi  # shard exhausted: jump to the next shard's range


def execute_scan_delete(holder, lo, hi, cap: int = 128, max_retries: int = 8) -> ScanOutput:
    """ONE fused round that gathers every key in ``[lo_i, hi_i)`` (<= ``cap``
    smallest per query) and deletes exactly the *emitted* keys
    (``ABTree.scan_delete_round``).  Legal because the scan linearizes
    before the round's writes: the deletes target exactly the snapshot the
    scan observed.  Keys a truncated page did not emit survive for the
    caller's next chunk.  Returns the pre-delete ``ScanOutput`` (the evicted
    keys/values).  The recorder's ``fused="scan_delete"`` record is the JAX
    engine's: range lanes first, then one delete lane per emitted key."""
    lo = np.atleast_1d(np.asarray(lo, np.int64))
    hi = np.atleast_1d(np.asarray(hi, np.int64))
    if lo.shape != hi.shape or lo.ndim != 1:
        raise ValueError("scan_delete_round expects equal-length 1-D lo/hi")
    tr = _tr(holder)
    reg = _metrics(holder)
    rec = _rec(holder)
    dev = holder.device
    del_res = del_fnd = None
    with tr.span("round", lanes=int(lo.size), fused="scan_delete"):
        k_, v_, c_, t_ = scan_lanes(
            holder, lo, hi, cap, n_scan_ops=int(lo.size), max_retries=max_retries
        )
        del_keys = k_[k_ != EMPTY]
        if del_keys.size:
            n_shards = holder.n_shards
            with tr.span("router_pack", lanes=int(del_keys.size)) as pack_sp:
                shard = np.searchsorted(holder._splits, del_keys, side="right")
                counts = np.bincount(shard, minlength=n_shards)
                w = _pow2(int(counts.max()))
                ops_sw = np.full((n_shards, w), OP_NOP, np.int32)
                keys_sw = np.zeros((n_shards, w), np.int64)
                shard_sorted, slot_sorted, order = _pack_slots(shard, n_shards)
                ops_sw[shard_sorted, slot_sorted] = elim.OP_DELETE
                keys_sw[shard_sorted, slot_sorted] = del_keys[order]
                _note_pack(holder, pack_sp, n_shards * w, int(del_keys.size))
            tr.shard_marks("point_lanes", counts)
            _note_load(holder, counts)
            if reg is not None:
                reg.inc("point_lanes", int(del_keys.size))
                for s in np.nonzero(counts)[0]:
                    reg.inc_shard("point_lanes", int(counts[s]), int(s))
            holder._ensure_capacity(w)
            res_sw, fnd_sw = run_point_phases(
                holder,
                torch.as_tensor(ops_sw, device=dev),
                torch.as_tensor(keys_sw, device=dev),
                torch.zeros((n_shards, w), dtype=VAL_DTYPE, device=dev),
            )
            if rec.enabled:
                slot = np.empty(del_keys.size, np.int64)
                slot[order] = slot_sorted
                del_res = _np(res_sw)[shard, slot]
                del_fnd = _np(fnd_sw)[shard, slot]
        if rec.enabled:
            n_r = int(lo.size)
            n_d = int(del_keys.size)
            rec.round(
                round_no=holder._rounds,
                mode=holder.mode,
                n_shards=holder.n_shards,
                ops=np.concatenate(
                    [np.full((n_r,), OP_RANGE, np.int64), np.full((n_d,), elim.OP_DELETE, np.int64)]
                ),
                keys=np.concatenate([lo, del_keys.astype(np.int64)]),
                vals=np.concatenate([hi - lo, np.zeros(n_d, np.int64)]),
                results=np.concatenate(
                    [c_.astype(np.int64), del_res if del_res is not None else np.zeros(0, np.int64)]
                ),
                found=np.concatenate(
                    [c_ > 0, del_fnd if del_fnd is not None else np.zeros(0, bool)]
                ),
                scans={
                    i: list(zip(k_[i, : c_[i]].tolist(), v_[i, : c_[i]].tolist()))
                    for i in range(n_r)
                },
                scan_cap=cap,
                fused="scan_delete",
            )
        holder._rounds += 1
        holder._maybe_split_shards()
    return ScanOutput(
        keys=torch.from_numpy(k_), vals=torch.from_numpy(v_),
        count=torch.from_numpy(c_), truncated=torch.from_numpy(t_),
    )


# ----------------------------------------------------------------------------
# Phases: search/combine → apply → retry → rebalance (point lanes)
# ----------------------------------------------------------------------------


def run_point_phases(holder, ops_sw, keys_sw, vals_sw):
    """Execute the point-op pipeline in the holder's mode on one packed
    ``(S, W)`` lane block (free of OP_RANGE)."""
    if holder.mode == "elim":
        return _combine_apply(holder, ops_sw, keys_sw, vals_sw)
    return _occ_round(holder, ops_sw, keys_sw, vals_sw)


def _combine_apply(holder, ops_sw, keys_sw, vals_sw):
    """Elim-ABtree: every shard's batch runs one combine; <= 1 net write per
    key per shard."""
    tr = _tr(holder)
    with tr.span("search_combine") as sp:
        holder.stacked, pack = _phase_search_combine(
            holder.stacked, (ops_sw, keys_sw, vals_sw), holder.cfg
        )
        sp.fence(pack)
    ks, arrival, leaf_ids, slot, res, results, found = pack
    rec = _rec(holder)
    if rec.enabled:
        rec.note_elim(_elim_note(ops_sw, ks, arrival, res))
    with tr.span("apply") as sp:
        holder.stacked, deferred = _phase_apply(
            holder.stacked, holder.cfg, ks, arrival, leaf_ids, slot, res
        )
        sp.fence(holder.stacked)
    # retry and rebalance spans are emitted even when the phase has no work.
    with tr.span("retry") as sp:
        passes = _drain_deferred(holder, ks, res.final_val, arrival, deferred)
        sp.note(passes=passes)
    with tr.span("rebalance") as sp:
        waves, shrinks = _fix_underfull_all(holder)
        sp.note(waves=waves, shrinks=shrinks)
    return results, found


def _occ_round(holder, ops_sw, keys_sw, vals_sw):
    """OCC baseline: per-shard duplicate-rank sub-rounds over all shards at
    once.  A shard whose own rank budget is exhausted runs no lanes in the
    tail sub-rounds: they are not sub-rounds it executes, so its
    ``subrounds`` counter stays put.  Each sub-round re-packs only its live
    lanes (the rank-r duplicates) into a block of ``pow2(max per-shard live
    count)`` lanes, so tail sub-rounds run at width 8 and satisfied lanes
    never re-enter the search.  Every sub-round runs the elim pipeline
    (``_combine_apply``) on its block, in which all keys of a shard are
    distinct.  ``holder.subround_hook`` fires after every sub-round (the
    durable layer's per-update flush).  Returns host tensors."""
    on = _np(ops_sw)
    kn = _np(keys_sw)
    vn = _np(vals_sw)
    dev = holder.device
    n_s, w = on.shape
    rank = np.stack([_duplicate_ranks(on[s], kn[s]) for s in range(n_s)])
    # per-shard budget: rank r of a real op executes in sub-round r, so
    # shard s is live while r <= max(rank[s]).
    live = on != OP_NOP  # (S, w)
    shard_max = np.where(live.any(axis=1), np.where(live, rank, 0).max(axis=1), -1)
    n_sub = int(rank.max()) + 1
    results = np.full((n_s, w), NOTFOUND, np.int64)
    found = np.zeros((n_s, w), bool)
    tr = _tr(holder)
    reg = _metrics(holder)
    for r in range(n_sub):
        active = shard_max >= r  # (S,) shards that execute sub-round r
        m = (rank == r) & live  # (S, w) this sub-round's live lanes
        w_r = _pow2(int(m.sum(axis=1).max()))
        s_idx, pos = np.nonzero(m)  # row-major: s_idx sorted
        starts = np.searchsorted(s_idx, np.arange(n_s))
        slot = np.arange(s_idx.size) - starts[s_idx]
        sub_ops = np.full((n_s, w_r), OP_NOP, np.int32)
        sub_keys = np.zeros((n_s, w_r), np.int64)
        sub_vals = np.zeros((n_s, w_r), np.int64)
        sub_ops[s_idx, slot] = on[s_idx, pos]
        sub_keys[s_idx, slot] = kn[s_idx, pos]
        sub_vals[s_idx, slot] = vn[s_idx, pos]
        with tr.span("occ_subround", subround=r, active=int(active.sum()), width=w_r) as sp:
            if reg is not None:
                reg.set_gauge("router_pack_width", w_r)
                reg.set_gauge("pad_waste_frac", (n_s * w_r - int(s_idx.size)) / (n_s * w_r))
            sp.note(width=w_r, real=int(s_idx.size))
            sub_res, sub_found = _combine_apply(
                holder,
                torch.as_tensor(sub_ops, device=dev),
                torch.as_tensor(sub_keys, device=dev),
                torch.as_tensor(sub_vals, device=dev),
            )
        results[s_idx, pos] = _np(sub_res)[s_idx, slot]
        found[s_idx, pos] = _np(sub_found)[s_idx, slot]
        if reg is not None:
            reg.inc("occ_subrounds", int(active.sum()))
        st = holder.stacked
        holder.stacked = st._replace(stats=st.stats._replace(
            subrounds=st.stats.subrounds + torch.as_tensor(active, dtype=torch.int64, device=dev)
        ))
        if holder.subround_hook is not None:
            holder.subround_hook()
    rec = _rec(holder)
    if rec.enabled:
        rec.note_occ(
            subrounds=n_sub,
            active_per_subround=[int((shard_max >= r).sum()) for r in range(n_sub)],
        )
    return torch.from_numpy(results), torch.from_numpy(found)


def _drain_deferred(holder, ks, final_vals, arrival, deferred):
    """Retry phase: split overflowing leaves and re-apply deferred inserts
    until none remain.  Returns the pass count."""
    guard = 0
    reg = _metrics(holder)
    while bool(deferred.any()):
        guard += 1
        if guard >= 512 * holder.cfg.max_height:
            raise RuntimeError("split loop diverged")
        if reg is not None:
            reg.inc("retry_passes")
        uniq = _np(_phase_overfull_leaves(holder.stacked, holder.cfg, ks, deferred))
        per_shard = [row[row != INT_MAX].astype(np.int32) for row in uniq]
        if any(r.size for r in per_shard):
            _split_cascade(holder, per_shard)
        holder.stacked, deferred = _phase_retry_insert(
            holder.stacked, holder.cfg, ks, final_vals, arrival, deferred
        )
    return guard


def _split_cascade(holder, ids_per_shard: List[np.ndarray]):
    """Split the given full nodes, all shards per wave.  A node whose parent
    is itself full waits until the parent has split; <= 1 active node per
    parent per wave."""
    n_s = holder.n_shards
    dev = holder.device
    work = [set(int(i) for i in ids) for ids in ids_per_shard]
    guard = 0
    while any(work):
        guard += 1
        if guard >= 512 * holder.cfg.max_height * n_s:
            raise RuntimeError("split cascade diverged")
        st = holder.stacked
        size = _np(st.size)
        parent = _np(st.parent)
        alloc = _np(st.alloc)
        ready_rows: List[np.ndarray] = []
        blocked_rows: List[List[int]] = []
        for s in range(n_s):
            # prune stale entries (no longer full / no longer allocated)
            ws = {n for n in work[s] if alloc[s, n] and size[s, n] >= holder.cfg.b}
            work[s] = ws
            ready, blocked = [], []
            for n in sorted(ws):
                p = int(parent[s, n])
                if p >= 0 and size[s, p] >= holder.cfg.b:
                    blocked.append(p)
                else:
                    ready.append(n)
            if not ready:
                # all blocked: queue the blocking parents for splitting
                work[s] |= set(blocked)
                ready_rows.append(np.zeros((0,), np.int32))
                blocked_rows.append([])
                continue
            rd = _independent_by_parent_np(parent[s], np.asarray(ready, np.int32))[: holder._wave_w]
            ready_rows.append(rd)
            blocked_rows.append(blocked)
        if not any(r.size for r in ready_rows):
            continue
        holder._ensure_capacity(2 * max(int(r.size) for r in ready_rows))
        # ragged wave width: {8, wave_w} buckets, as the JAX engine.
        max_nodes = max(int(r.size) for r in ready_rows)
        w_wave = 8 if max_nodes <= 8 else holder._wave_w
        node_ids = np.zeros((n_s, w_wave), np.int32)
        active = np.zeros((n_s, w_wave), bool)
        for s, rd in enumerate(ready_rows):
            node_ids[s, : rd.size] = rd
            active[s, : rd.size] = True
        tr = _tr(holder)
        with tr.span("split_wave", wave=guard, width=w_wave) as sp:
            holder.stacked = split_wave(
                holder.stacked, holder.cfg,
                torch.as_tensor(node_ids, device=dev), torch.as_tensor(active, device=dev),
            )
            sp.fence(holder.stacked)
        reg = _metrics(holder)
        if reg is not None:
            reg.inc("split_waves")
            for s, rd in enumerate(ready_rows):
                if rd.size:
                    reg.inc("split_nodes", int(rd.size), shard=s)
        tr.shard_marks("split_wave.nodes", [int(r.size) for r in ready_rows])
        for s, rd in enumerate(ready_rows):
            for n in rd.tolist():
                work[s].discard(int(n))
            work[s] |= set(blocked_rows[s])


def _fix_underfull_all(holder):
    """Rebalance phase: merge/distribute every shard's underfull non-root
    nodes in bottom-up waves; root shrink once a shard has no actionable
    wave.  Returns (wave count, shrink count)."""
    n_s = holder.n_shards
    dev = holder.device
    tr = _tr(holder)
    reg = _metrics(holder)
    n_waves = n_shrinks = 0
    guard = 0
    while True:
        guard += 1
        if guard >= 512 * holder.cfg.max_height * n_s:
            raise RuntimeError("underfull loop diverged")
        st = holder.stacked
        alloc = _np(st.alloc)
        size = _np(st.size)
        parent = _np(st.parent)
        level = _np(st.level)
        is_leaf = _np(st.is_leaf)
        root = _np(st.root)
        sel_rows: List[np.ndarray] = []
        any_wave = False
        want_shrink = False
        for s in range(n_s):
            r = int(root[s])
            under = alloc[s] & (size[s] < holder.cfg.a) & (parent[s] >= 0)
            under[r] = False
            ids = np.nonzero(under)[0].astype(np.int32)
            actionable = ids[size[s][parent[s][ids]] >= 2] if ids.size else ids
            if actionable.size:
                lv = level[s][actionable].min()
                sel = actionable[level[s][actionable] == lv]
                sel = _independent_by_parent_np(parent[s], sel)[: holder._wave_w]
                sel_rows.append(sel)
                any_wave = True
            else:
                sel_rows.append(np.zeros((0,), np.int32))
                if (not is_leaf[s, r]) and int(size[s, r]) == 1:
                    want_shrink = True
        if any_wave:
            max_nodes = max(int(r.size) for r in sel_rows)
            w_wave = 8 if max_nodes <= 8 else holder._wave_w
            node_ids = np.zeros((n_s, w_wave), np.int32)
            active = np.zeros((n_s, w_wave), bool)
            for s, sel in enumerate(sel_rows):
                node_ids[s, : sel.size] = sel
                active[s, : sel.size] = True
            with tr.span("underfull_wave", wave=guard, width=w_wave) as sp:
                holder.stacked = underfull_wave(
                    holder.stacked, holder.cfg,
                    torch.as_tensor(node_ids, device=dev), torch.as_tensor(active, device=dev),
                )
                sp.fence(holder.stacked)
            n_waves += 1
            if reg is not None:
                reg.inc("underfull_waves")
            tr.shard_marks("underfull_wave.nodes", [int(r.size) for r in sel_rows])
            continue
        if want_shrink:
            # shrink_root's per-shard `can` guard collapses only
            # single-child internal roots.
            with tr.span("root_shrink"):
                holder.stacked = shrink_root(holder.stacked, holder.cfg)
            n_shrinks += 1
            if reg is not None:
                reg.inc("root_shrinks")
            continue
        break
    return n_waves, n_shrinks


# ----------------------------------------------------------------------------
# Plan execution
# ----------------------------------------------------------------------------


def execute_plan(holder, plan: RoundPlan) -> RoundOutput:
    """Run one round through the phase pipeline.  Range lanes gather from
    the pre-round state (scan phase first); point lanes then apply in
    arrival order per key (stable packing keeps arrival order within a
    shard).  Returns host tensors: point lanes get the §3 dictionary return
    values; range lanes their match count in ``results`` (``found`` ⇔
    non-empty) and their rows in ``RoundOutput.scan``."""
    bsz = int(plan.ops.shape[0])
    n_shards = holder.n_shards
    dev = holder.device
    if bsz == 0:
        holder._rounds += 1
        return RoundOutput(
            results=torch.full((0,), NOTFOUND, dtype=VAL_DTYPE),
            found=torch.zeros((0,), dtype=torch.bool),
            scan=None,
        )
    tr = _tr(holder)
    reg = _metrics(holder)
    with tr.span("round", lanes=bsz, shards=n_shards):
        ops_np = _np(plan.ops)
        keys_np = _np(plan.keys)
        vals_np = _np(plan.vals)
        is_range = ops_np == elim.OP_RANGE
        is_point = (ops_np == elim.OP_FIND) | (ops_np == elim.OP_INSERT) | (ops_np == elim.OP_DELETE)

        results = np.full((bsz,), NOTFOUND, np.int64)
        found = np.zeros((bsz,), bool)

        # scan phase first: range lanes linearize before the round's writes.
        scan_out = None
        if plan.has_range:
            rl = np.nonzero(is_range)[0]
            lo_np = _np(plan.lo)[rl]
            hi_np = _np(plan.hi)[rl]
            k_, v_, c_, t_ = scan_lanes(holder, lo_np, hi_np, plan.scan_cap, n_scan_ops=plan.n_range)
            keys_full = np.full((bsz, plan.scan_cap), EMPTY, np.int64)
            vals_full = np.zeros((bsz, plan.scan_cap), np.int64)
            count_full = np.zeros((bsz,), np.int32)
            trunc_full = np.zeros((bsz,), bool)
            keys_full[rl] = k_
            vals_full[rl] = v_
            count_full[rl] = c_
            trunc_full[rl] = t_
            scan_out = ScanOutput(
                keys=torch.from_numpy(keys_full),
                vals=torch.from_numpy(vals_full),
                count=torch.from_numpy(count_full),
                truncated=torch.from_numpy(trunc_full),
            )
            results[rl] = c_.astype(np.int64)
            found[rl] = c_ > 0

        # point lanes: pack per shard (stable ⇒ arrival order kept).
        if plan.has_point:
            pl = np.nonzero(is_point)[0]
            with tr.span("router_pack", lanes=int(pl.size)) as pack_sp:
                shard = np.searchsorted(holder._splits, keys_np[pl], side="right")
                counts = np.bincount(shard, minlength=n_shards)
                w = _pow2(int(counts.max()))
                ops_sw = np.full((n_shards, w), OP_NOP, np.int32)
                keys_sw = np.zeros((n_shards, w), np.int64)
                vals_sw = np.zeros((n_shards, w), np.int64)
                shard_sorted, slot_sorted, order = _pack_slots(shard, n_shards)
                ops_sw[shard_sorted, slot_sorted] = ops_np[pl][order]
                keys_sw[shard_sorted, slot_sorted] = keys_np[pl][order]
                vals_sw[shard_sorted, slot_sorted] = vals_np[pl][order]
                slot = np.empty(pl.size, np.int64)
                slot[order] = slot_sorted
                _note_pack(holder, pack_sp, n_shards * w, int(pl.size))
            tr.shard_marks("point_lanes", counts)
            _note_load(holder, counts)
            _note_keys(holder, keys_np[pl])
            if reg is not None:
                reg.inc("point_lanes", int(pl.size))
                for s in np.nonzero(counts)[0]:
                    reg.inc_shard("point_lanes", int(counts[s]), int(s))
            holder._ensure_capacity(w)
            res_sw, fnd_sw = run_point_phases(
                holder,
                torch.as_tensor(ops_sw, device=dev),
                torch.as_tensor(keys_sw, device=dev),
                torch.as_tensor(vals_sw, device=dev),
            )
            results[pl] = _np(res_sw)[shard, slot]
            found[pl] = _np(fnd_sw)[shard, slot]

        rec = _rec(holder)
        if rec.enabled:
            scans_d = None
            if scan_out is not None:
                scans_d = {
                    int(i): list(zip(k_[j, : c_[j]].tolist(), v_[j, : c_[j]].tolist()))
                    for j, i in enumerate(rl.tolist())
                }
            rec.round(
                round_no=holder._rounds,
                mode=holder.mode,
                n_shards=n_shards,
                ops=ops_np,
                keys=keys_np,
                vals=vals_np,
                results=results,
                found=found,
                scans=scans_d,
                scan_cap=plan.scan_cap,
            )
        holder._rounds += 1
        out = RoundOutput(
            results=torch.from_numpy(results),
            found=torch.from_numpy(found),
            scan=scan_out,
        )
        holder._maybe_split_shards()
    return out
