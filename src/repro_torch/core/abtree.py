"""Batched Elim-ABtree on an array-backed node pool (port of
``src/repro/core/abtree.py``).

The tree state, the device-level phase primitives (descent, probe, net-op
apply, structural waves, frontier expansion) and the ``ABTree`` holder.
Round execution lives in ``core/rounds.py``.

Every ``TreeState`` tensor carries the leading shard axis: node arrays are
``(S, N, ...)``, scalars ``(S,)``; ``ABTree`` is S = 1.  Phase primitives
take ``(S, W)`` id/lane blocks and address the pool through flat global
rows ``s * N + node`` (``_g``), so one launch covers every shard and the
forest needs no rewrite of them.  Node ids stored in the pool (children,
parent, root) stay shard-local.

Update discipline: a phase never writes its input state in place.  Each
``.at[].set`` of the JAX code becomes a clone plus an indexed write
(``_set``/``_add``), so a state object handed out earlier stays a true
snapshot (the scan phase validates versions against one).  All masked-out
lanes write the scratch row ``N - 1``, which they leave as it was.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import elimination as elim
from repro_torch.kernels import _lib
from repro_torch.kernels.tree_descend.ops import frontier_compact
from repro_torch.kernels.tree_descend.ref import descend_ref, probe_ref
from repro_torch.obs.metrics import (
    MetricsRegistry,
    RegistryBackedCounters,
    engine_collector,
)
from repro_torch.obs.recorder import Recorder
from repro_torch.obs.tracer import NULL_TRACER

# ----------------------------------------------------------------------------
# Constants & state
# ----------------------------------------------------------------------------

KEY_DTYPE = torch.int64
VAL_DTYPE = torch.int64
EMPTY = 2**63 - 1  # free-slot / unused-router sentinel (sorts last)
NOTFOUND = -(2**63)  # ⊥ return value
NULL = -1  # null node id

OP_NOP = elim.OP_NOP
OP_FIND = elim.OP_FIND
OP_INSERT = elim.OP_INSERT
OP_DELETE = elim.OP_DELETE
OP_RANGE = elim.OP_RANGE

INT_MAX = 2**31 - 1
KEY_MIN = -(2**63)  # -inf bound for leftmost child ranges


class ScanConflictError(RuntimeError):
    """An optimistic range scan failed version validation repeatedly."""


class TreeConfig(NamedTuple):
    capacity: int = 4096  # node pool size
    b: int = 8  # max keys per leaf == max children per internal
    a: int = 2  # min keys per leaf == min children per internal (a ≤ b/2)
    max_height: int = 24  # static bound for descent loops


class TreeStats(NamedTuple):
    # each (S,) int64
    slot_writes: torch.Tensor  # physical leaf slot writes (keys or vals)
    struct_ops: torch.Tensor  # split/merge/distribute sub-operations
    searches: torch.Tensor  # root-to-leaf descents (per lane)
    eliminated: torch.Tensor  # update ops eliminated (write avoided)
    rounds: torch.Tensor
    subrounds: torch.Tensor  # OCC sub-rounds executed
    scans: torch.Tensor  # range-scan ops served
    scan_retries: torch.Tensor  # scan rounds re-run after version conflicts


class TreeState(NamedTuple):
    # node pool (SoA), leading shard axis S ------------------------------------
    keys: torch.Tensor  # (S, N, b) int64 leaf keys (unsorted) | routers in [..., :b-1]
    vals: torch.Tensor  # (S, N, b) int64 leaf values
    children: torch.Tensor  # (S, N, b) int32 child ids (internal)
    parent: torch.Tensor  # (S, N) int32
    pidx: torch.Tensor  # (S, N) int32 index of node in parent.children
    is_leaf: torch.Tensor  # (S, N) bool
    size: torch.Tensor  # (S, N) int32: leaf → #keys; internal → #children
    level: torch.Tensor  # (S, N) int32: leaf = 0
    ver: torch.Tensor  # (S, N) int32: even ⇔ quiescent
    alloc: torch.Tensor  # (S, N) bool
    # per-leaf ElimRecord (paper §4.1) ------------------------------------------
    rec_key: torch.Tensor  # (S, N) int64
    rec_val: torch.Tensor  # (S, N) int64
    rec_ver: torch.Tensor  # (S, N) int32 (odd when valid)
    rec_op: torch.Tensor  # (S, N) int32
    # tree scalars ----------------------------------------------------------------
    root: torch.Tensor  # (S,) int32
    height: torch.Tensor  # (S,) int32 (#levels; 1 = single leaf)
    dirty: torch.Tensor  # (S, N) bool — touched since last durable commit
    stats: TreeStats


# Pool-row fill values per TreeState field (root/height/stats are absent:
# they pass through pool growth untouched).
_GROW_FILL = dict(
    keys=EMPTY, vals=0, children=NULL, parent=NULL, pidx=0, is_leaf=True,
    size=0, level=0, ver=0, alloc=False, rec_key=EMPTY, rec_val=0,
    rec_ver=0, rec_op=0, dirty=False,
)


def grow_pool(state: TreeState, pad_n: int) -> TreeState:
    """Append ``pad_n`` freshly initialized node rows along the node axis
    (axis 1).  The old scratch row becomes an ordinary free node (masked
    writes leave it all-initial) and the new last row takes over."""
    out = {}
    for name, val in state._asdict().items():
        if name in _GROW_FILL:
            pad_shape = val.shape[:1] + (pad_n,) + val.shape[2:]
            pad = torch.full(pad_shape, _GROW_FILL[name], dtype=val.dtype, device=val.device)
            out[name] = torch.cat([val, pad], dim=1)
        else:
            out[name] = val
    return TreeState(**out)


def make_tree(cfg: TreeConfig, n_shards: int = 1, device=None) -> TreeState:
    """A fresh stacked state: per shard ``capacity + 1`` rows, the last one
    the write-off SCRATCH row that absorbs every masked-out scatter lane.
    ``device`` defaults to the CUDA card and raises without one."""
    s, n, b = n_shards, cfg.capacity + 1, cfg.b
    device = _lib.resolve_device(device, "make_tree")

    def full(shape, value, dtype):
        return torch.full(shape, value, dtype=dtype, device=device)

    alloc = full((s, n), False, torch.bool)
    alloc[:, 0] = True  # node 0 = initial root leaf
    dirty = alloc.clone()
    zeros64 = torch.zeros((s,), dtype=torch.int64, device=device)
    return TreeState(
        keys=full((s, n, b), EMPTY, KEY_DTYPE),
        vals=full((s, n, b), 0, VAL_DTYPE),
        children=full((s, n, b), NULL, torch.int32),
        parent=full((s, n), NULL, torch.int32),
        pidx=full((s, n), 0, torch.int32),
        is_leaf=full((s, n), True, torch.bool),
        size=full((s, n), 0, torch.int32),
        level=full((s, n), 0, torch.int32),
        ver=full((s, n), 0, torch.int32),
        alloc=alloc,
        rec_key=full((s, n), EMPTY, KEY_DTYPE),
        rec_val=full((s, n), 0, VAL_DTYPE),
        rec_ver=full((s, n), 0, torch.int32),
        rec_op=full((s, n), 0, torch.int32),
        root=full((s,), 0, torch.int32),
        height=full((s,), 1, torch.int32),
        dirty=dirty,
        stats=TreeStats(*([zeros64.clone() for _ in range(8)])),
    )


def _stack_one(state: TreeState) -> TreeState:
    """One shard's bare state (node axis 0, as ``ABTree.state`` gives it) as
    a one-shard stack of views."""
    return TreeState(*(x.unsqueeze(0) for x in state[:-1]),
                     stats=TreeStats(*(x.unsqueeze(0) for x in state.stats)))


# ----------------------------------------------------------------------------
# Phase 1 over a bare state: the plain descent and leaf probe (the oracles of
# the fused search kernel, ``kernels/tree_descend/ref.py``, bound to the
# TreeState layout; the round engine searches through ``descend_probe``)
# ----------------------------------------------------------------------------


def descend(state: TreeState, keys: torch.Tensor, cfg: TreeConfig) -> torch.Tensor:
    """Root-to-leaf search of a bare state for a batch of keys -> (B,) int32
    leaf ids.  The per-level child choice mirrors the paper's ``search``:
    follow ptrs[#routers <= key]."""
    keys = torch.as_tensor(keys, dtype=KEY_DTYPE, device=state.keys.device)
    return descend_ref(state.keys[None], state.children[None], state.is_leaf[None],
                       state.root.reshape(1), keys[None], max_height=cfg.max_height)[0]


def probe(state: TreeState, leaf_ids: torch.Tensor, keys: torch.Tensor):
    """Unsorted-leaf probe of a bare state: lane-parallel compare across the
    b slots.  Returns ``(found (B,) bool, slot (B,) int32, val (B,) int64)``,
    ``val`` NOTFOUND where the key is absent."""
    keys = torch.as_tensor(keys, dtype=KEY_DTYPE, device=state.keys.device)
    found, slot, val = probe_ref(state.keys[None], state.vals[None], leaf_ids[None], keys[None],
                                 notfound=NOTFOUND)
    return found[0], slot[0], val[0]


# ----------------------------------------------------------------------------
# Flat-row addressing and functional updates over the stacked pool
# ----------------------------------------------------------------------------


def _flat(x: torch.Tensor) -> torch.Tensor:
    """(S, N, ...) -> (S*N, ...) view."""
    return x.view(x.shape[0] * x.shape[1], *x.shape[2:])


def _base(state: TreeState) -> torch.Tensor:
    """(S, 1) first global row of each shard."""
    s, n = state.size.shape
    return (torch.arange(s, device=state.size.device) * n)[:, None]


def _g(state: TreeState, ids: torch.Tensor) -> torch.Tensor:
    """Shard-local node ids (S, W[, k]) -> global flat rows (int64)."""
    base = _base(state)
    return ids.to(torch.int64) + base.view(base.shape + (1,) * (ids.dim() - 2))


def _leaf_rows(state: TreeState, leaf_ids: torch.Tensor) -> torch.Tensor:
    """Global rows of the search phase's leaf ids.  A lane whose descent
    took a NULL child carries leaf id -1 (as in JAX); it names the scratch
    row N-1, which JAX reaches by wrapping the negative index."""
    return _g(state, torch.where(leaf_ids < 0, leaf_ids + state.keys.shape[1], leaf_ids))


def _get(arr: torch.Tensor, rows: torch.Tensor, cols: Optional[torch.Tensor] = None):
    f = _flat(arr)
    return f[rows] if cols is None else f[rows, cols.to(torch.int64)]


def _set(arr: torch.Tensor, rows: torch.Tensor, val, cols: Optional[torch.Tensor] = None):
    """``arr.at[rows(, cols)].set(val)``: a new tensor; ``arr`` is untouched."""
    out = arr.clone()
    f = _flat(out)
    if cols is None:
        f[rows] = val
    else:
        f[rows, cols.to(torch.int64)] = val
    return out


def _add(arr: torch.Tensor, rows: torch.Tensor, val: torch.Tensor):
    """``arr.at[rows].add(val)`` (duplicate rows accumulate)."""
    out = arr.clone()
    _flat(out).index_put_((rows,), val.to(arr.dtype), accumulate=True)
    return out


def _max_into(arr: torch.Tensor, rows: torch.Tensor, val: torch.Tensor):
    """``arr.at[rows].max(val)``."""
    out = arr.clone()
    _flat(out).scatter_reduce_(0, rows.reshape(-1), val.to(arr.dtype).reshape(-1), "amax")
    return out


# ----------------------------------------------------------------------------
# Apply: in-place-in-spirit write of the round's net ops
# ----------------------------------------------------------------------------


class ApplyOut(NamedTuple):
    state: TreeState
    deferred: torch.Tensor  # (S, B) bool — net inserts that did not fit (leaf full)


def _segment_starts(x: torch.Tensor) -> torch.Tensor:
    """(S, B): True where a row's value differs from its left neighbour."""
    return torch.cat([torch.ones_like(x[:, :1], dtype=torch.bool), x[:, 1:] != x[:, :-1]], dim=1)


def _segmented_rank(mask: torch.Tensor, seg_id: torch.Tensor) -> torch.Tensor:
    """0-based rank of each True within its segment (junk elsewhere)."""
    m = mask.to(torch.int32)
    c = torch.cumsum(m, dim=1, dtype=torch.int32)
    seg_base = torch.where(_segment_starts(seg_id), c - m, 0)
    seg_base = torch.cummax(seg_base, dim=1).values
    return c - 1 - seg_base


def apply_net_ops(
    state: TreeState,
    cfg: TreeConfig,
    leaf_ids: torch.Tensor,  # (S, B) leaf per sorted op
    keys_sorted: torch.Tensor,
    slot_found: torch.Tensor,  # (S, B) slot of key if present
    net_insert: torch.Tensor,  # (S, B) bool (at segment heads)
    net_delete: torch.Tensor,
    net_overwrite: torch.Tensor,
    final_val: torch.Tensor,
    arrival_sorted: torch.Tensor,  # (S, B) original position (record priority)
) -> ApplyOut:
    """Apply per-key net effects.  All net flags are on distinct keys; keys
    are sorted, so ops on one leaf are contiguous."""
    b = cfg.b
    scratch = state.keys.shape[1] - 1
    gl = _leaf_rows(state, leaf_ids)
    gs = _base(state) + scratch  # (S, 1) scratch row per shard

    # deletes: blank the slot (no shifting), size -= 1.
    del_rows = torch.where(net_delete, gl, gs)
    del_slots = torch.where(net_delete, slot_found, 0)
    keys_new = _set(
        state.keys, del_rows,
        torch.where(net_delete, EMPTY, _get(state.keys, del_rows, del_slots)), del_slots,
    )
    size_new = _add(state.size, del_rows, torch.where(net_delete, -1, 0))

    # overwrites: value-only write.
    ow_rows = torch.where(net_overwrite, gl, gs)
    ow_slots = torch.where(net_overwrite, slot_found, 0)
    vals_new = _set(
        state.vals, ow_rows,
        torch.where(net_overwrite, final_val, _get(state.vals, ow_rows, ow_slots)), ow_slots,
    )

    # inserts: rank-th free slot of the leaf, ranking against the post-delete
    # keys (deletes in this round free slots first).
    ins = net_insert
    rank = _segmented_rank(ins, leaf_ids)
    free = _get(keys_new, gl) == EMPTY  # (S, B, b)
    free_order = torch.argsort((~free).to(torch.uint8), dim=2, stable=True)
    n_free = free.sum(2, dtype=torch.int32)
    fits = ins & (rank < n_free)
    ins_slot = torch.gather(free_order, 2, torch.clamp(rank, 0, b - 1).to(torch.int64)[..., None])[..., 0]

    ins_rows = torch.where(fits, gl, gs)
    ins_slots = torch.where(fits, ins_slot, 0)
    keys_new = _set(
        keys_new, ins_rows,
        torch.where(fits, keys_sorted, _get(keys_new, ins_rows, ins_slots)), ins_slots,
    )
    vals_new = _set(
        vals_new, ins_rows,
        torch.where(fits, final_val, _get(vals_new, ins_rows, ins_slots)), ins_slots,
    )
    size_new = _add(size_new, ins_rows, torch.where(fits, 1, 0))

    deferred = ins & ~fits

    # version bump: +2 per modified leaf (even ⇔ quiescent).
    modified = net_delete | net_overwrite | fits
    mod_rows = torch.where(modified, gl, gs)
    ver_bump = _max_into(torch.zeros_like(state.ver), mod_rows, modified.to(torch.int32))
    ver_bump[:, scratch] = 0
    ver_new = state.ver + 2 * ver_bump
    dirty_new = state.dirty | (ver_bump > 0)

    # publish ElimRecord: the net op with max arrival in each modified leaf is
    # the leaf's last modifier; rec_ver = new_ver - 1 (odd).
    prio = torch.where(modified, arrival_sorted.to(torch.int32), -1)
    best = _max_into(torch.full_like(state.ver, -1), mod_rows, prio)
    is_best = modified & (prio == _get(best, gl))
    rb_rows = torch.where(is_best, gl, gs)

    def publish(arr, values):
        return _set(arr, rb_rows, torch.where(is_best, values, _get(arr, rb_rows)))

    rec_key = publish(state.rec_key, keys_sorted)
    rec_val = publish(state.rec_val, final_val)
    rec_op = publish(state.rec_op, torch.where(net_delete, OP_DELETE, OP_INSERT).to(torch.int32))
    rec_ver = publish(state.rec_ver, _get(ver_new, gl) - 1)

    n_writes = (net_delete.sum(1) + net_overwrite.sum(1) + 2 * fits.sum(1)).to(torch.int64)
    stats = state.stats._replace(slot_writes=state.stats.slot_writes + n_writes)

    return ApplyOut(
        state=state._replace(
            keys=keys_new, vals=vals_new, size=size_new, ver=ver_new,
            dirty=dirty_new, rec_key=rec_key, rec_val=rec_val, rec_op=rec_op,
            rec_ver=rec_ver, stats=stats,
        ),
        deferred=deferred,
    )


# ----------------------------------------------------------------------------
# Structural waves (relaxed-rebalancing sub-operations, batched)
# ----------------------------------------------------------------------------


def _alloc_ids(state: TreeState, k: int) -> torch.Tensor:
    """(S, k) ids of k free nodes per shard (lowest ids first).  The scratch
    row is never handed out."""
    order = torch.argsort(state.alloc[:, :-1].to(torch.uint8), dim=1, stable=True)
    return order[:, :k].to(torch.int32)


def _refresh_child_links(state: TreeState, parents: torch.Tensor, cfg: TreeConfig) -> TreeState:
    """Recompute parent/pidx for all children of the given (S, W) parent ids.
    Safe with junk ids: guarded by alloc & ~is_leaf & size."""
    scratch = state.keys.shape[1] - 1
    gp = _g(state, parents)
    ch = _get(state.children, gp)  # (S, W, b)
    jj = torch.arange(cfg.b, device=ch.device, dtype=torch.int32)
    ok = (
        _get(state.alloc, gp)[..., None]
        & ~_get(state.is_leaf, gp)[..., None]
        & (jj < _get(state.size, gp)[..., None])
        & (ch >= 0)
    )
    rows = _g(state, torch.where(ok, ch, scratch))
    pp = parents.to(torch.int32)[..., None].expand(ch.shape)
    pidx_new = _set(state.pidx, rows, torch.where(ok, jj.expand(ch.shape), _get(state.pidx, rows)))
    parent_new = _set(state.parent, rows, torch.where(ok, pp, _get(state.parent, rows)))
    return state._replace(pidx=pidx_new, parent=parent_new)


def _roll(x: torch.Tensor, shift: int) -> torch.Tensor:
    return torch.roll(x, shift, dims=-1)


def split_wave(
    state: TreeState, cfg: TreeConfig, node_ids: torch.Tensor, active: torch.Tensor
) -> TreeState:
    """One wave of split sub-operations over (S, W) node ids.  Caller
    preconditions: every active node is full (size == b); its parent is not
    full (or the node is the root); at most one active node per parent."""
    w = node_ids.shape[1]
    b = cfg.b
    scratch = state.keys.shape[1] - 1
    node_ids = torch.where(active, node_ids, scratch).to(torch.int32)
    gn = _g(state, node_ids)

    new_ids = _alloc_ids(state, 2 * w)
    right_ids = torch.where(active, new_ids[:, :w], scratch).to(torch.int32)
    is_root = active & (_get(state.parent, gn) == NULL)
    newroot_ids = torch.where(is_root, new_ids[:, w:], scratch).to(torch.int32)
    gr = _g(state, right_ids)
    gnr = _g(state, newroot_ids)

    leaf = _get(state.is_leaf, gn)  # (S, W)
    lh = (b + 1) // 2
    rh = b - lh
    iota = torch.arange(b, device=node_ids.device)

    # sort node contents (leaves are unsorted; internals already sorted).
    krows = _get(state.keys, gn)
    vrows = _get(state.vals, gn)
    crows = _get(state.children, gn)
    order = torch.argsort(krows, dim=2, stable=True)
    order = torch.where(leaf[..., None], order, iota)
    ks = torch.gather(krows, 2, order)
    vs = torch.gather(vrows, 2, order)

    # leaves: left ks[:lh], right ks[lh:]; router = ks[lh] (= min right).
    leaf_lk = torch.where(iota < lh, ks, EMPTY)
    leaf_rk = torch.where(iota < rh, _roll(ks, -lh), EMPTY)
    leaf_lv = vs
    leaf_rv = _roll(vs, -lh)

    # internals: left lh children + lh-1 routers; right rh children + rh-1
    # routers; router krows[lh-1] moves up.
    int_lk = torch.where(iota < lh - 1, krows, EMPTY)
    int_rk = torch.where(iota < rh - 1, _roll(krows, -lh), EMPTY)
    int_lc = torch.where(iota < lh, crows, NULL)
    int_rc = torch.where(iota < rh, _roll(crows, -lh), NULL)

    router = torch.where(leaf, ks[..., lh], krows[..., lh - 1])

    def masked_set(arr, rows, values, act):
        m = act[..., None] if values.dim() == 3 else act
        return _set(arr, rows, torch.where(m, values, _get(arr, rows)))

    leaf3 = leaf[..., None]
    keys_new = masked_set(state.keys, gn, torch.where(leaf3, leaf_lk, int_lk), active)
    keys_new = masked_set(keys_new, gr, torch.where(leaf3, leaf_rk, int_rk), active)
    vals_new = masked_set(state.vals, gn, leaf_lv, active & leaf)
    vals_new = masked_set(vals_new, gr, leaf_rv, active & leaf)
    ch_new = masked_set(state.children, gn, int_lc, active & ~leaf)
    ch_new = masked_set(ch_new, gr, int_rc, active & ~leaf)

    size_new = _set(state.size, gn, torch.where(active, lh, _get(state.size, gn)))
    size_new = _set(size_new, gr, torch.where(active, rh, _get(size_new, gr)))
    isleaf_new = _set(state.is_leaf, gr, torch.where(active, leaf, _get(state.is_leaf, gr)))
    level_new = _set(
        state.level, gr, torch.where(active, _get(state.level, gn), _get(state.level, gr))
    )
    alloc_new = _set(state.alloc, gr, _get(state.alloc, gr) | active)
    ver_new = _add(state.ver, gn, torch.where(active, 2, 0))

    state = state._replace(
        keys=keys_new, vals=vals_new, children=ch_new, size=size_new,
        is_leaf=isleaf_new, level=level_new, alloc=alloc_new, ver=ver_new,
    )

    # grow the root where needed: a fresh internal whose single child is the node.
    state = state._replace(
        keys=_set(
            state.keys, gnr,
            torch.where(is_root[..., None], EMPTY, _get(state.keys, gnr)),
        ),
        children=_set(
            state.children, gnr,
            torch.where(is_root, node_ids, _get(state.children, gnr, torch.zeros_like(gnr))),
            torch.zeros_like(gnr),
        ),
        size=_set(state.size, gnr, torch.where(is_root, 1, _get(state.size, gnr))),
        is_leaf=_set(state.is_leaf, gnr, _get(state.is_leaf, gnr) & ~is_root),
        level=_set(
            state.level, gnr,
            torch.where(is_root, _get(state.level, gn) + 1, _get(state.level, gnr)),
        ),
        alloc=_set(state.alloc, gnr, _get(state.alloc, gnr) | is_root),
        parent=_set(state.parent, gn, torch.where(is_root, newroot_ids, _get(state.parent, gn))),
        pidx=_set(state.pidx, gn, torch.where(is_root, 0, _get(state.pidx, gn))),
    )
    any_root = is_root.any(1)
    root_new = torch.where(
        any_root, torch.where(is_root, newroot_ids, -1).max(1).values, state.root
    ).to(torch.int32)
    height_new = state.height + any_root.to(torch.int32)

    # link the right sibling into the parent: router at slot `at`, child at
    # `at+1` (tail shifted right by one).
    pids = torch.where(is_root, newroot_ids, _get(state.parent, gn))
    pids = torch.where(active, pids, scratch).to(torch.int32)
    gp = _g(state, pids)
    at = _get(state.pidx, gn)[..., None]  # (S, W, 1)
    pk = _get(state.keys, gp)
    pc = _get(state.children, gp)
    shifted_k = torch.where(iota > at, _roll(pk, 1), pk)
    shifted_k = torch.where(iota == at, router[..., None], shifted_k)
    shifted_c = torch.where(iota > at + 1, _roll(pc, 1), pc)
    shifted_c = torch.where(iota == at + 1, right_ids[..., None], shifted_c)

    keys_new = _set(state.keys, gp, torch.where(active[..., None], shifted_k, _get(state.keys, gp)))
    ch_new = _set(state.children, gp, torch.where(active[..., None], shifted_c, _get(state.children, gp)))
    size_new = _add(state.size, gp, torch.where(active, 1, 0))

    dirty_new = state.dirty
    for rows, m in ((node_ids, active), (right_ids, active), (pids, active), (newroot_ids, is_root)):
        r = _g(state, torch.where(m, rows, scratch))
        dirty_new = _set(dirty_new, r, _get(dirty_new, r) | m)

    stats = state.stats._replace(struct_ops=state.stats.struct_ops + active.sum(1))
    state = state._replace(
        keys=keys_new, children=ch_new, size=size_new, root=root_new,
        height=height_new, dirty=dirty_new, stats=stats,
    )
    # fix child links of: parents (children shifted), the split node and its
    # new right sibling (internal splits reassign grandchildren).
    state = _refresh_child_links(state, pids, cfg)
    state = _refresh_child_links(state, node_ids, cfg)
    state = _refresh_child_links(state, right_ids, cfg)
    return state


def underfull_wave(
    state: TreeState, cfg: TreeConfig, node_ids: torch.Tensor, active: torch.Tensor
) -> TreeState:
    """One wave of merge/distribute sub-operations (paper's fixUnderfull)
    over (S, W) node ids.  Caller preconditions: each active node is
    underfull, not the root, its parent has >= 2 children, <= 1 active node
    per parent."""
    b = cfg.b
    scratch = state.keys.shape[1] - 1
    node_ids = torch.where(active, node_ids, scratch).to(torch.int32)
    gn = _g(state, node_ids)
    parents = torch.where(active, _get(state.parent, gn), scratch).to(torch.int32)
    gp = _g(state, parents)
    at = torch.clamp(_get(state.pidx, gn), 0, b - 1)
    sib_at = torch.where(at == 0, 1, at - 1)  # paper: right sibling iff leftmost
    sibs = _get(state.children, gp, sib_at)
    sibs = torch.where(active, sibs, scratch).to(torch.int32)
    left_at = torch.minimum(at, sib_at)
    left_is_node = at < sib_at
    lid = torch.where(active, torch.where(left_is_node, node_ids, sibs), scratch)
    rid = torch.where(active, torch.where(left_is_node, sibs, node_ids), scratch)
    gli = _g(state, lid)
    gri = _g(state, rid)

    leaf = _get(state.is_leaf, gn)
    lsz = _get(state.size, gli)
    rsz = _get(state.size, gri)
    total = lsz + rsz
    sep = _get(state.keys, gp, left_at)  # router between the pair

    do_merge = active & (total <= b)
    do_dist = active & (total > b)

    # merged content, width 2b
    lk, lv, lc = _get(state.keys, gli), _get(state.vals, gli), _get(state.children, gli)
    rk, rv, rc = _get(state.keys, gri), _get(state.vals, gri), _get(state.children, gri)
    j2 = torch.arange(2 * b, device=node_ids.device)
    lsz3, total3 = lsz[..., None], total[..., None]

    # leaves: concat + stable sort (EMPTY last) compacts `total` sorted keys.
    cat_k = torch.cat([lk, rk], dim=2)
    cat_v = torch.cat([lv, rv], dim=2)
    ordr = torch.argsort(cat_k, dim=2, stable=True)
    leaf_mk = torch.gather(cat_k, 2, ordr)
    leaf_mv = torch.gather(cat_v, 2, ordr)

    # internals: children = lc[0:lsz] ++ rc[0:rsz];
    #            routers  = lk[0:lsz-1] ++ [sep] ++ rk[0:rsz-1].
    r_idx = torch.clamp(j2 - lsz3, 0, b - 1).to(torch.int64)
    lc2 = torch.cat([lc, torch.full_like(lc, NULL)], dim=2)
    lk2 = torch.cat([lk, torch.full_like(lk, EMPTY)], dim=2)
    int_mc = torch.where(j2 < lsz3, lc2, torch.gather(rc, 2, r_idx))
    int_mc = torch.where(j2 < total3, int_mc, NULL)
    int_mk = torch.where(
        j2 < lsz3 - 1,
        lk2,
        torch.where(j2 == lsz3 - 1, sep[..., None], torch.gather(rk, 2, r_idx)),
    )
    int_mk = torch.where(j2 < total3 - 1, int_mk, EMPTY)

    merged_k = torch.where(leaf[..., None], leaf_mk, int_mk)  # (S, W, 2b)
    merged_v = leaf_mv
    merged_c = int_mc

    def sel(act):
        return act[..., None]

    # MERGE: all content into lid; drop rid + separator from the parent.
    keys_new = _set(state.keys, gli, torch.where(sel(do_merge), merged_k[..., :b], _get(state.keys, gli)))
    vals_new = _set(state.vals, gli, torch.where(sel(do_merge & leaf), merged_v[..., :b], _get(state.vals, gli)))
    ch_new = _set(
        state.children, gli,
        torch.where(sel(do_merge & ~leaf), merged_c[..., :b], _get(state.children, gli)),
    )
    size_new = _set(state.size, gli, torch.where(do_merge, total, _get(state.size, gli)))
    ver_new = _add(state.ver, gli, torch.where(do_merge, 2, 0))
    # free rid (the paper marks unlinked nodes; we deallocate post-wave).
    alloc_new = _set(state.alloc, gri, _get(state.alloc, gri) & ~do_merge)
    b_iota = torch.arange(b, device=node_ids.device)
    keys_new = _set(keys_new, gri, torch.where(sel(do_merge), EMPTY, _get(keys_new, gri)))
    size_new = _set(size_new, gri, torch.where(do_merge, 0, _get(size_new, gri)))

    # parent: remove router at left_at and child at max(at, sib_at).
    rm_child = torch.maximum(at, sib_at)
    pk = _get(state.keys, gp)
    pc = _get(state.children, gp)
    pk_shift = torch.where(b_iota >= left_at[..., None], _roll(pk, -1), pk)
    pk_shift[..., b - 1] = EMPTY
    pc_shift = torch.where(b_iota >= rm_child[..., None], _roll(pc, -1), pc)
    pc_shift[..., b - 1] = NULL
    keys_new = _set(keys_new, gp, torch.where(sel(do_merge), pk_shift, _get(keys_new, gp)))
    ch_new = _set(ch_new, gp, torch.where(sel(do_merge), pc_shift, _get(ch_new, gp)))
    size_new = _add(size_new, gp, torch.where(do_merge, -1, 0))

    # DISTRIBUTE: split the merged content evenly; new separator up.
    ln = (total + 1) // 2
    rn = total - ln
    ln3, rn3 = ln[..., None], rn[..., None]
    shift_idx = torch.clamp(j2 + ln3, 0, 2 * b - 1).to(torch.int64)
    shift_k = torch.gather(merged_k, 2, shift_idx)
    shift_v = torch.gather(merged_v, 2, shift_idx)
    shift_c = torch.gather(merged_c, 2, shift_idx)

    # leaves: left ln keys, right rn keys; router = merged_k[ln].
    dl_k = torch.where(j2 < ln3, merged_k, EMPTY)[..., :b]
    dr_k = torch.where(j2 < rn3, shift_k, EMPTY)[..., :b]
    dl_v = merged_v[..., :b]
    dr_v = shift_v[..., :b]
    router_leaf = torch.gather(merged_k, 2, torch.clamp(ln3, 0, 2 * b - 1).to(torch.int64))[..., 0]
    # internals: left ln children (ln-1 routers); router merged_k[ln-1] up;
    # right rn children (rn-1 routers) starting at child index ln.
    di_lk = torch.where(j2 < ln3 - 1, merged_k, EMPTY)[..., :b]
    di_lc = torch.where(j2 < ln3, merged_c, NULL)[..., :b]
    di_rk = torch.where(j2 < rn3 - 1, shift_k, EMPTY)[..., :b]
    di_rc = torch.where(j2 < rn3, shift_c, NULL)[..., :b]
    router_int = torch.gather(merged_k, 2, torch.clamp(ln3 - 1, 0, 2 * b - 1).to(torch.int64))[..., 0]

    leaf3 = leaf[..., None]
    keys_new = _set(
        keys_new, gli,
        torch.where(sel(do_dist), torch.where(leaf3, dl_k, di_lk), _get(keys_new, gli)),
    )
    keys_new = _set(
        keys_new, gri,
        torch.where(sel(do_dist), torch.where(leaf3, dr_k, di_rk), _get(keys_new, gri)),
    )
    vals_new = _set(vals_new, gli, torch.where(sel(do_dist & leaf), dl_v, _get(vals_new, gli)))
    vals_new = _set(vals_new, gri, torch.where(sel(do_dist & leaf), dr_v, _get(vals_new, gri)))
    ch_new = _set(ch_new, gli, torch.where(sel(do_dist & ~leaf), di_lc, _get(ch_new, gli)))
    ch_new = _set(ch_new, gri, torch.where(sel(do_dist & ~leaf), di_rc, _get(ch_new, gri)))
    size_new = _set(size_new, gli, torch.where(do_dist, ln, _get(size_new, gli)))
    size_new = _set(size_new, gri, torch.where(do_dist, rn, _get(size_new, gri)))
    ver_new = _add(ver_new, gli, torch.where(do_dist, 2, 0))
    ver_new = _add(ver_new, gri, torch.where(do_dist, 2, 0))
    router_new = torch.where(leaf, router_leaf, router_int)
    keys_new = _set(
        keys_new, gp,
        torch.where(do_dist, router_new, _get(keys_new, gp, left_at)), left_at,
    )

    dirty_new = state.dirty
    for rows, m in ((node_ids, active), (sibs, active), (parents, active)):
        r = _g(state, torch.where(m, rows, scratch))
        dirty_new = _set(dirty_new, r, _get(dirty_new, r) | m)

    stats = state.stats._replace(struct_ops=state.stats.struct_ops + active.sum(1))
    state = state._replace(
        keys=keys_new, vals=vals_new, children=ch_new, size=size_new,
        alloc=alloc_new, ver=ver_new, dirty=dirty_new, stats=stats,
    )
    # refresh links: parents (child list shifted), lid/rid (grandchildren
    # reassigned for internal merges/distributes).
    state = _refresh_child_links(state, parents, cfg)
    state = _refresh_child_links(state, lid, cfg)
    state = _refresh_child_links(state, rid, cfg)
    return state


def shrink_root(state: TreeState, cfg: TreeConfig) -> TreeState:
    """Per shard: if the root is internal with a single child, that child
    becomes the root (paper: entry.ptrs[0] replacement in fixUnderfull)."""
    r = state.root.to(torch.int64)[:, None]  # (S, 1)
    gr = _g(state, r)
    can = ~_get(state.is_leaf, gr) & (_get(state.size, gr) == 1)
    child = _get(state.children, gr, torch.zeros_like(gr))
    child = torch.where(can, child, r.to(torch.int32))
    gc = _g(state, child)
    return state._replace(
        root=child[:, 0].to(torch.int32),
        height=state.height - can[:, 0].to(torch.int32),
        alloc=_set(state.alloc, gr, _get(state.alloc, gr) & ~can),
        size=_set(state.size, gr, torch.where(can, 0, _get(state.size, gr))),
        parent=_set(state.parent, gc, torch.where(can, NULL, _get(state.parent, gc))),
        keys=_set(state.keys, gr, torch.where(can[..., None], EMPTY, _get(state.keys, gr))),
        dirty=_set(state.dirty, gr, True),
    )


# ----------------------------------------------------------------------------
# Round outputs (produced by the core/rounds.py engine)
# ----------------------------------------------------------------------------


class ScanOutput(NamedTuple):
    keys: torch.Tensor  # (B, cap) ascending matches, EMPTY-padded
    vals: torch.Tensor  # (B, cap) values (0 where key slot is EMPTY)
    count: torch.Tensor  # (B,) int32 — entries emitted (≤ cap)
    truncated: torch.Tensor  # (B,) bool — more matches existed than cap


class RoundOutput(NamedTuple):
    results: torch.Tensor  # (B,) per-op return value (NOTFOUND = ⊥; range: #matches)
    found: torch.Tensor  # (B,) bool (range lanes: any match)
    # per-lane scan rows for mixed rounds (non-range rows scan the empty
    # interval); None when the round had no OP_RANGE lane.
    scan: Optional[ScanOutput] = None


# ----------------------------------------------------------------------------
# Range-scan phase: frontier expansion + lane-parallel gather
# ----------------------------------------------------------------------------


def frontier_expand_sharded(
    state: TreeState, cfg: TreeConfig, sid: torch.Tensor, lo: torch.Tensor,
    hi: torch.Tensor, frontier_cap: int,
):
    """Expand each lane's root into its leaf frontier (the leaves whose key
    range intersects ``[lo, hi)``) level by level over the stacked state;
    lane ``i`` expands inside shard ``sid[i]``.  Internal nodes expand to
    the children whose range intersects the interval; leaves ride along, so
    after ``max_height`` levels every frontier slot is a leaf.  Each level's
    compaction goes through ``kernels/tree_descend``'s ``frontier_compact``
    (the CUDA kernel on the card).

    Returns ``(leaves (W, F), cand_keys (W, F·b), cand_vals (W, F·b),
    touched (L, W, F), overflow (W,))``: ``touched`` holds every node id the
    expansion read (scratch-padded), the read set the optimistic reader
    validates; ``overflow`` marks lanes whose frontier exceeded F at some
    level (the caller re-runs them wider).  Padding lanes (``lo = hi =
    EMPTY``) expand into nothing past level 0."""
    bsz = lo.shape[0]
    f, b = frontier_cap, cfg.b
    n = state.keys.shape[1]
    scratch = n - 1
    dev = lo.device
    base = (sid.to(torch.int64) * n)[:, None]  # (W, 1) per-lane shard rows
    keys_f, vals_f, ch_f = _flat(state.keys), _flat(state.vals), _flat(state.children)
    leaf_f, size_f = _flat(state.is_leaf), _flat(state.size)

    frontier = torch.full((bsz, f), scratch, dtype=torch.int32, device=dev)
    frontier[:, 0] = state.root[sid.to(torch.int64)]
    valid = torch.zeros((bsz, f), dtype=torch.bool, device=dev)
    valid[:, 0] = True
    touched = torch.full((cfg.max_height, bsz, f), scratch, dtype=torch.int32, device=dev)
    overflow = torch.zeros((bsz,), dtype=torch.bool, device=dev)
    pad_lo = torch.full((bsz, f, 1), KEY_MIN, dtype=KEY_DTYPE, device=dev)
    pad_hi = torch.full((bsz, f, 1), EMPTY, dtype=KEY_DTYPE, device=dev)
    j = torch.arange(b, device=dev, dtype=torch.int32)

    for level in range(cfg.max_height):
        node = torch.where(valid, frontier, scratch)
        touched[level] = node
        g = node.to(torch.int64) + base
        leaf = leaf_f[g]  # (W, F); scratch is a leaf
        routers = keys_f[g][..., : b - 1]  # (W, F, b-1); unused = EMPTY
        sz = size_f[g]
        # child j covers [clo_j, chi_j): clo_0 = -inf, chi_{sz-1} = +inf
        # (stale routers beyond sz-1 are EMPTY, which acts as +inf).
        clo = torch.cat([pad_lo, routers], dim=2)
        chi = torch.cat([routers, pad_hi], dim=2)
        isect = (j < sz[..., None]) & (chi > lo[:, None, None]) & (clo < hi[:, None, None])
        expand = (valid & ~leaf)[..., None] & isect  # (W, F, b)
        keep = valid & leaf  # leaves ride along unchanged
        cand = torch.cat(
            [torch.where(expand, ch_f[g], scratch), torch.where(keep, frontier, scratch)[..., None]],
            dim=2,
        ).reshape(bsz, f * (b + 1))
        cand_valid = torch.cat([expand, keep[..., None]], dim=2).reshape(bsz, f * (b + 1))
        frontier, valid, of = frontier_compact(cand, cand_valid, f, scratch=scratch)
        overflow = overflow | of

    leaves = torch.where(valid, frontier, scratch)
    g = leaves.to(torch.int64) + base
    cand_keys = torch.where(valid[..., None], keys_f[g], EMPTY)
    cand_vals = vals_f[g]
    return (
        leaves,
        cand_keys.reshape(bsz, f * b),
        cand_vals.reshape(bsz, f * b),
        touched,
        overflow,
    )


def frontier_expand(
    state: TreeState, cfg: TreeConfig, lo: torch.Tensor, hi: torch.Tensor, frontier_cap: int,
):
    """:func:`frontier_expand_sharded` over a bare state (node axis 0, as
    ``ABTree.state`` gives it): each query's root expanded into the leaves
    whose key range intersects ``[lo, hi)``, every level compacted by
    ``frontier_compact`` (the CUDA kernel on the card).  Returns
    ``(leaves (B, F), cand_keys (B, F·b), cand_vals (B, F·b), touched (L,
    B, F), overflow (B,))``, as JAX's ``frontier_expand``."""
    sid = torch.zeros(lo.shape, dtype=torch.int32, device=lo.device)
    return frontier_expand_sharded(_stack_one(state), cfg, sid, lo, hi, frontier_cap)


# ----------------------------------------------------------------------------
# Host-orchestrated tree (thin wrappers over the core/rounds.py engine)
# ----------------------------------------------------------------------------


class ABTree(RegistryBackedCounters):
    """Host-orchestrated batched (a,b)-tree: the S = 1 case of the round
    engine.  Every entry point builds a round plan and runs the
    ``core/rounds.py`` phase pipeline on ``stacked``.

    ``device`` defaults to ``"cuda"``; without a card that raises (the tree
    never drops to the CPU on its own).  Tests pass ``device="cpu"``, where
    every kernel wrapper takes its plain version."""

    def __init__(self, cfg: TreeConfig = TreeConfig(), mode: str = "elim", *, device=None):
        if mode not in ("elim", "occ"):
            raise ValueError(f"unknown mode {mode!r}")
        if not 2 <= cfg.a <= cfg.b // 2:
            raise ValueError("(a,b) requires 2 ≤ a ≤ b/2")
        self.device = _lib.resolve_device(device, "ABTree")
        self.cfg = cfg
        self.mode = mode
        # unified-engine holder protocol: the single tree is a one-shard
        # forest with an unpartitioned key space (see core/rounds.py).
        self.n_shards = 1
        self._splits = np.empty((0,), np.int64)
        self._bounds = [KEY_MIN, EMPTY]
        self.stacked = make_tree(cfg, 1, self.device)
        # telemetry: the metrics registry (the one store behind the
        # ``_rounds``/``_scans``/``_scan_retries`` counter properties), the
        # host-side phase tracer (NULL_TRACER = no-op) and the always-on
        # flight recorder (``Recorder(enabled=False)`` to opt out).
        self.metrics = MetricsRegistry()
        self.metrics.add_collector(engine_collector(self))
        self.tracer = NULL_TRACER
        self.recorder = Recorder()
        self._rounds = 0
        self._scans = 0
        self._scan_retries = 0
        self._scan_active = 0
        self._wave_w = 64  # pad width for structural waves
        # durability hook: fires after every occ sub-round (each sub-round's
        # returns causally follow the previous one's, the batched analog of
        # the paper's per-update flush + fence).
        self.subround_hook = None
        # optimistic-reader hook: called between a scan's gather and its
        # version validation (tests use it to force the retry paths).
        self.scan_hook = None
        self._scan_frontier = 8  # leaf-frontier pad width (doubles on overflow)

    # -- unified-engine holder protocol ---------------------------------------

    @property
    def state(self) -> TreeState:
        """This tree's shard 0 as unstacked views (no copy)."""
        st = self.stacked
        return TreeState(
            *(x[0] for x in st[:-1]), stats=TreeStats(*(x[0] for x in st.stats))
        )

    def _maybe_split_shards(self):
        """Shard-overflow policy: the single tree never splits shards."""

    def _maybe_repartition(self):
        """Load rebalancing is a forest concern; S = 1 has one partition."""

    # -- public API -----------------------------------------------------------

    def apply_round(self, ops, keys, vals=None, *, scan_cap: int = 128) -> RoundOutput:
        """Apply one round of concurrent ops (1-D arrays, equal length);
        per-op results in arrival order.  OP_RANGE lanes (key = lo,
        val = span) scan ``[lo, lo + span)`` of the pre-round dictionary;
        their rows land in ``RoundOutput.scan`` and their ``results`` entry
        is the match count."""
        from repro_torch.core import rounds

        plan = rounds.build_plan(ops, keys, vals, scan_cap=scan_cap)
        return rounds.execute_plan(self, plan)

    def scan_round(self, lo, hi, cap: int = 128, max_retries: int = 8) -> ScanOutput:
        """One round of concurrent range scans: per query the <= ``cap``
        smallest keys in ``[lo[i], hi[i])`` with their values, ascending,
        validated against node versions (re-run on conflict)."""
        from repro_torch.core import rounds

        return rounds.execute_scan(self, lo, hi, cap=cap, max_retries=max_retries)

    def scan_delete_round(self, lo, hi, cap: int = 128, max_retries: int = 8) -> ScanOutput:
        """ONE fused round that gathers every key in ``[lo_i, hi_i)``
        (<= ``cap`` smallest per query) and deletes the gathered keys: the
        scan linearizes before the round's deletes, which target exactly the
        snapshot it observed.  Returns the pre-delete scan (the evicted
        keys/values); ``truncated`` marks queries with more matches left to
        sweep."""
        from repro_torch.core import rounds

        return rounds.execute_scan_delete(self, lo, hi, cap=cap, max_retries=max_retries)

    def scan_stream(self, lo, hi, cap: int = 128):
        """Stream every (key, value) in ``[lo, hi)`` ascending as a
        generator of successive ``cap``-bounded scan rounds, each resuming
        past the last emitted key.  Each round is validated on its own;
        entries of different rounds may straddle interleaved update rounds,
        as with any cursor over a concurrent map."""
        from repro_torch.core import rounds

        return rounds.execute_scan_stream(self, lo, hi, cap)

    def find(self, key) -> Optional[int]:
        out = self.apply_round([OP_FIND], [key])
        return int(out.results[0]) if bool(out.found[0]) else None

    def insert(self, key, val):
        out = self.apply_round([OP_INSERT], [key], [val])
        return int(out.results[0]) if bool(out.found[0]) else None

    def delete(self, key):
        out = self.apply_round([OP_DELETE], [key])
        return int(out.results[0]) if bool(out.found[0]) else None

    def items(self) -> dict:
        """Host-side snapshot of the dictionary contents (sorted by key)."""
        s = self.state
        keys = s.keys.cpu().numpy()
        vals = s.vals.cpu().numpy()
        leaf = (s.is_leaf & s.alloc).cpu().numpy()
        k, v = keys[leaf].reshape(-1), vals[leaf].reshape(-1)
        live = k != EMPTY
        order = np.argsort(k[live], kind="stable")
        return dict(zip(k[live][order].tolist(), v[live][order].tolist()))

    def take_dirty(self) -> np.ndarray:
        """Node ids dirtied since the last durable commit (then reset)."""
        d = np.nonzero(self.stacked.dirty[0].cpu().numpy())[0].astype(np.int32)
        self.stacked = self.stacked._replace(dirty=torch.zeros_like(self.stacked.dirty))
        return d

    def stats(self) -> dict:
        """Device phase counters plus the engine's host-side round/scan
        counters (``scan_retries`` counts retried lanes)."""
        s = {k: int(v.sum()) for k, v in self.stacked.stats._asdict().items()}
        s["rounds"] = self._rounds
        s["scans"] = self._scans
        s["scan_retries"] = self._scan_retries
        return s

    # -- pool management --------------------------------------------------------

    def _ensure_capacity(self, need_nodes: int):
        """Grow the pool if fewer than ``need + slack`` nodes are free (the
        2·wave_w term covers a full-width split wave's allocation)."""
        need = 2 * need_nodes + 4 * self.cfg.max_height + 2 * self._wave_w + 8
        n_alloc = int(self.stacked.alloc.sum())
        cap = self.cfg.capacity
        if cap - n_alloc >= need:
            return
        self._grow(max(cap * 2, cap + need))

    def _grow(self, new_cap: int):
        self.stacked = grow_pool(self.stacked, new_cap - self.cfg.capacity)
        self.cfg = self.cfg._replace(capacity=new_cap)


# ----------------------------------------------------------------------------
# Range queries (paper §3): an optimistic double collect over the touched
# subtree: capture versions, walk, re-validate.
# ----------------------------------------------------------------------------


def range_query(tree: "ABTree", lo: int, hi: int, max_retries: int = 8):
    """All (k, v) with lo <= k < hi, by a host walk of ``tree.state``
    validated against node versions (the paper's optimistic-reader
    discipline; a retry guards against rounds that interleave from other
    threads sharing the state).  ``ScanConflictError`` after
    ``max_retries`` failed validations."""
    cfg = tree.cfg
    for _ in range(max_retries):
        s = tree.state
        ver_before = s.ver.cpu().numpy()
        keys = s.keys.cpu().numpy()
        vals = s.vals.cpu().numpy()
        children = s.children.cpu().numpy()
        is_leaf = s.is_leaf.cpu().numpy()
        size = s.size.cpu().numpy()
        out = []
        touched = []
        stack = [int(s.root)]
        while stack:
            nid = stack.pop()
            touched.append(nid)
            if is_leaf[nid]:
                row = keys[nid]
                # bounds clamped into int64 (EMPTY is never a key)
                hit = (row != EMPTY) & (row >= max(lo, KEY_MIN)) & (row < min(hi, EMPTY))
                out.extend(zip(row[hit].tolist(), vals[nid][hit].tolist()))
                continue
            sz = int(size[nid])
            routers = keys[nid, : sz - 1].tolist()
            for j in range(sz):
                clo = KEY_MIN if j == 0 else routers[j - 1]
                chi = EMPTY if j == sz - 1 else routers[j]
                if chi > lo and clo < hi:  # the child's range meets [lo, hi)
                    stack.append(int(children[nid, j]))
        ver_after = tree.state.ver.cpu().numpy()
        if np.array_equal(ver_before[touched], ver_after[touched]):
            return sorted(out)
    raise ScanConflictError("range_query: version validation failed repeatedly")
