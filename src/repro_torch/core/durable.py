"""Durable (strictly linearizable) trees: the paper's §5 on a filesystem
journal, for the single tree and the sharded forest alike (port of
``src/repro/core/durable.py``; the on-disk format is the JAX package's, so
a directory written by either package recovers in the other).

The paper's p-OCC-ABtree persists only keys/values/pointers, ordering writes
with clwb+sfence so that (i) new nodes are persistent *before* the single
pointer that links them ("link-and-persist"), and (ii) a simple
insert/delete becomes durable exactly when its key reaches persistent
memory.  Here the persistence domain is a filesystem and the update unit is
a *round*.  The protocol maps 1:1, per shard:

  paper                           this module
  ----------------------------    ------------------------------------------
  flush new nodes (clwb+sfence)   write round segment file + fsync (one
                                  journal lane per SHARD, fsyncs issued in
                                  parallel on a persistent flush pool; an
                                  untouched shard flushes nothing)
  batch stores before the fence   GROUP COMMIT: with ``group_commit_every``
                                  > 1, rounds are *absorbed* (dirty bitmaps
                                  accumulate, zero I/O) until the group
                                  boundary (``group_commit_every`` rounds
                                  or ``group_commit_max_wait_s`` of age);
                                  then ONE commit flushes the union of the
                                  group's dirty rows and ONE rename
                                  linearizes the whole group
  write marked pointer            write MANIFEST.tmp naming every shard's
                                  snapshot + segment chain and its commit
                                  index (ONE vector commit for all shards)
  flush pointer, unmark           fsync tmp, os.replace → MANIFEST, fsync dir
                                  (with ``commit_async=True`` the boundary
                                  I/O runs on a background thread; the
                                  caller only captures host state;
                                  structural hooks and the next boundary
                                  JOIN the in-flight commit first, so
                                  journal bookkeeping stays single-writer)
  snapshot only live rows         INCREMENTAL SNAPSHOTS: a periodic
                                  "snapshot" writes only the rows dirtied
                                  since the shard's last FULL snapshot (a
                                  ``_delta_`` file that *replaces* the
                                  segment chain); a full snapshot is forced
                                  every ``full_snapshot_every`` deltas, on
                                  pool growth, on splits/repartitions, and
                                  after recovery
  recovery: walk from root,       recovery: walk the manifest generation
    rebuild size/ver/locks          ladder (``manifest_retain`` retained
                                    generations), replay each shard's
                                    chain, rebuild size/ver/dirty, restack
                                    the shards and restore the split points

The commit point (durable linearization point) is the atomic rename: a round
is in the abstract *persistent* dictionary iff its manifest committed.
Results are only released to callers after the commit, so removing the ops
of an uncommitted round from a crashed execution is legal.  Mid-restack
states never commit: occ sub-round commits are suppressed while a shard
split is sweeping/re-inserting.  Publishing elimination reduces durability
cost as in the paper: eliminated ops dirty no nodes (``flush_bytes``,
``fsyncs``).  Journal files no retained manifest references are collected
after each commit (``gc_removed``).

Failure model: fail-stop crashes (atomic rename); transient EIO / ENOSPC /
rename failures (every commit I/O step retried with backoff,
``commit_retries``); a sick disk (circuit breaker: after ``degrade_after``
failed commits the holder serves volatile, ``commits_suspended``, and every
``reattach_every``-th commit probes with a full snapshot); torn journal
writes (CRC32 of every journal file and sidecar in the manifest; replay
truncates at the first invalid record and quarantines bad files under
``quarantine/``); bit flips / torn manifests (manifest self-checksum, the
``MANIFEST.prev*`` retention ring); a crash with rounds absorbed but no
boundary commit (recovery lands on the last complete group boundary); no
consistent cut anywhere (``RecoveryError``).  Faults are injected through
``core/faults.py``: ``crash=`` / ``faults=`` accept a ``CrashPoint`` or a
``FaultPlan``.

The device.  The tree lives on the card (``device=None`` resolves to CUDA
and raises without one; tests pass ``device="cpu"``).  At a group boundary
the commit decides, for each shard, which file it writes (full snapshot,
delta, segment or none) from inputs that are settled by then (the commit
index, ``snapshot_every``, the shard's snapshot and delta bookkeeping, a
change of capacity, forced snapshots); it gathers on the device only the
rows that file holds and copies just them to the host, on the caller's
thread.  Only a full snapshot copies a whole shard.  The rest of the commit
(serialization, fsyncs, the manifest, GC) works on those numpy copies, so
the ``commit_async`` thread and the flush pool make no CUDA call, and no
later round can change a capture.  Recovery rebuilds the volatile fields
over host numpy and uploads each field once.
"""
from __future__ import annotations

import io
import json
import os
import time
import zlib
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.abtree import (
    EMPTY,
    NULL,
    ABTree,
    RoundOutput,
    ScanOutput,
    TreeConfig,
    TreeState,
    make_tree,
)
from repro_torch.core.faults import (  # noqa: F401  (re-exported, as in the JAX package)
    CrashPoint,
    FaultPlan,
    FaultSpec,
    InjectedFault,
    SimulatedCrash,
    as_fault_plan,
)
from repro_torch.core.forest import ABForest, _shard, _stack_states
from repro_torch.kernels import _lib

_PERSISTED_FIELDS = ("keys", "vals", "children", "is_leaf", "level")
# NOT persisted (volatile; rebuilt by recovery, as in the paper §5: only
# keys/values/child pointers are persistent): size (recomputed from
# keys/children), parent/pidx (rebuilt from the recovery walk), ver (reset),
# rec_* (reset), alloc (recomputed), dirty, stats.

_MANIFEST_VERSION = 3  # v3: file_crcs + checksum + per-file root/height


class RecoveryError(RuntimeError):
    """No manifest generation yields a consistent committed prefix."""


class _GenerationInvalid(Exception):
    """This manifest generation cannot produce a committed prefix
    (internal: recovery falls back to the previous generation)."""


def _resolve_faults(crash, faults) -> FaultPlan:
    """Merge the ``crash=`` argument and the ``faults=`` one into a single
    FaultPlan (either may be a CrashPoint or a FaultPlan)."""
    if faults is None:
        return as_fault_plan(crash)
    plan = as_fault_plan(faults)
    if crash is not None:
        if isinstance(crash, CrashPoint):
            plan.add_crash(crash)
        else:
            for c in as_fault_plan(crash).crashes:
                plan.add_crash(c)
    return plan


def _manifest_checksum(manifest: dict) -> int:
    """CRC32 over the canonical JSON of the manifest minus its checksum
    field, recomputable bit-exactly from the parsed manifest."""
    body = {k: v for k, v in manifest.items() if k != "checksum"}
    return zlib.crc32(json.dumps(body, sort_keys=True).encode()) & 0xFFFFFFFF


def _load_manifest(directory: str, name: str) -> Optional[dict]:
    """Parse + checksum-verify one manifest generation; None if missing,
    unparseable, or corrupt (v2 manifests have no checksum and are
    trusted)."""
    try:
        with open(os.path.join(directory, name)) as f:
            manifest = json.load(f)
    except (OSError, json.JSONDecodeError, UnicodeDecodeError):
        return None
    if "checksum" in manifest and _manifest_checksum(manifest) != manifest["checksum"]:
        return None
    return manifest


def _file_commit_idx(fname: str) -> int:
    """Commit index encoded in a journal file name
    (``{uid}_{snapshot|segment|delta}_{idx:08d}.npz``)."""
    return int(fname.rsplit("_", 1)[1].split(".")[0])


def _file_valid(path: str, crc: Optional[int]) -> bool:
    """Is this journal file's on-disk content intact?  With a recorded CRC
    (v3 manifests) the check is exact; without one (v2) a load attempt
    still catches torn/truncated zip archives."""
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        return False
    if crc is not None:
        return (zlib.crc32(data) & 0xFFFFFFFF) == crc
    try:
        with np.load(io.BytesIO(data)) as z:
            z.files
        return True
    except Exception:
        return False


def _fsync_dir(path: str):
    fd = os.open(path, os.O_RDONLY | getattr(os, "O_DIRECTORY", 0))
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _to_host(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t`` that no later round can change (on the CPU too,
    where ``.cpu()`` would return the live tensor itself)."""
    return t.detach().to("cpu", copy=True).numpy()


class _Phase:
    """One phase of a commit: its span, and on a clean exit one observation
    of its histogram (its seconds plus ``carry``, an earlier part's)."""

    __slots__ = ("_span", "_reg", "_hist", "_carry", "t0", "seconds")

    def __init__(self, span, reg, hist: Optional[str], carry: float):
        self._span, self._reg, self._hist, self._carry = span, reg, hist, carry

    def __enter__(self):
        self._span.__enter__()
        self.t0 = time.perf_counter()
        return self

    def note(self, **kw):
        self._span.note(**kw)

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self.t0
        if exc[0] is None and self._hist is not None:
            self._reg.observe(self._hist, self._carry + self.seconds)
        return self._span.__exit__(*exc)


@dataclass
class DurableStats:
    commits: int = 0
    flush_bytes: int = 0  # bytes of node images made durable
    fsyncs: int = 0
    nodes_flushed: int = 0
    gc_removed: int = 0  # journal files unlinked after losing all references
    commit_retries: int = 0  # commit attempts that failed with an I/O error
    commits_suspended: int = 0  # commits skipped while in degraded mode
    gc_skipped: int = 0  # GC unlinks skipped (file already gone / busy)


class _DurableBase:
    """The ONE commit-protocol implementation (link-and-persist at round
    granularity, per-shard journal lanes, single vector manifest).  The
    concrete classes below only bind it to their backing structure, whose
    ``stacked`` state carries the leading shard axis either way."""

    backend = ""  # "tree" | "forest"

    # -- backend surface (provided by subclasses) ------------------------------

    def _holder(self):
        """The backing round-engine holder (the ABTree or ABForest)."""
        raise NotImplementedError

    def _n_shards(self) -> int:
        raise NotImplementedError

    def _take_dirty_all(self) -> List[np.ndarray]:
        raise NotImplementedError

    def _capacity(self) -> int:
        raise NotImplementedError

    def _cfg(self) -> TreeConfig:
        raise NotImplementedError

    def _mode(self) -> str:
        raise NotImplementedError

    def _in_split_now(self) -> bool:
        return False

    def _manifest_extra(self) -> dict:
        return {}

    def _shard_roots(self) -> List[tuple]:
        """(root, height) of every shard: one host copy each of the stacked
        ``root`` and ``height``."""
        st = self._holder().stacked
        return list(zip(st.root.tolist(), st.height.tolist()))

    def _host_rows(self, s: int, rows: Optional[np.ndarray]) -> Dict[str, np.ndarray]:
        """Shard ``s``'s persisted fields on the host: the whole shard when
        ``rows`` is None (a full snapshot), else only ``rows``, gathered on
        the device first so only they cross to the host."""
        st = self._holder().stacked
        if rows is None:
            return {f: _to_host(getattr(st, f)[s]) for f in _PERSISTED_FIELDS}
        ids = torch.from_numpy(rows.astype(np.int64)).to(st.keys.device)
        return {f: _to_host(torch.index_select(getattr(st, f)[s], 0, ids))
                for f in _PERSISTED_FIELDS}

    # -- telemetry (shared with the backing holder) ----------------------------
    # The durable wrapper has no registry of its own: journal metrics land
    # in the backing holder's registry, so ``holder.metrics`` is ONE surface
    # across volatile and durable variants, and installing a tracer on the
    # wrapper also times the engine phases underneath.

    @property
    def metrics(self):
        return self._holder().metrics

    @property
    def tracer(self):
        return self._holder().tracer

    @tracer.setter
    def tracer(self, t):
        self._holder().tracer = t

    @property
    def recorder(self):
        return self._holder().recorder

    @recorder.setter
    def recorder(self, r):
        self._holder().recorder = r

    def _phase(self, name: str, hist: Optional[str] = None, carry: float = 0.0, **args) -> _Phase:
        """The commit phase ``name``, timed once for its span and ``hist``."""
        return _Phase(self.tracer.span(name, **args), self.metrics, hist, carry)

    def forensics_records(self):
        """The audit records recovered from the committed forensics sidecar
        (empty on a fresh journal): the last-K rounds of the crashed
        execution's *committed* prefix."""
        return list(getattr(self, "_forensics", []))

    # -- fault / degradation surface -------------------------------------------

    @property
    def crash(self) -> FaultPlan:
        """Alias of the fault plan (it still has ``maybe_fire``)."""
        return self.faults

    @crash.setter
    def crash(self, value):
        self.faults = as_fault_plan(value)
        self.faults.on_inject = self._on_fault_injected

    @property
    def degraded(self) -> bool:
        """True while the durability circuit breaker is open: serving
        continues on the volatile holder, commits are suspended."""
        return self._degraded

    def durability_status(self) -> dict:
        return {
            "degraded": self._degraded,
            "consecutive_failures": self._consec_failures,
            "commit_retries": self.dstats.commit_retries,
            "commits_suspended": self.dstats.commits_suspended,
            "faults_injected": self.faults.injected,
            "quarantined": list(self._quarantined),
            # group-commit surface: a stalled group is observable as
            # pending rounds that never drain / an age that keeps growing
            "group_commit_every": self.group_commit_every,
            "pending_rounds": self._group_rounds,
            "pending_age_s": (
                time.perf_counter() - self._group_start
                if self._group_start is not None
                else 0.0
            ),
            "rounds_per_commit": self.metrics.histogram_summary("rounds_per_commit"),
        }

    def _init_fault_state(self, faults: FaultPlan, commit_retries: int,
                          commit_backoff_s: float, degrade_after: int, reattach_every: int):
        self.faults = faults
        self.faults.on_inject = self._on_fault_injected
        self.commit_retries = commit_retries
        self.commit_backoff_s = commit_backoff_s
        self.degrade_after = degrade_after
        self.reattach_every = max(1, reattach_every)
        self._degraded = False
        self._consec_failures = 0
        self._degraded_skipped = 0
        self._file_crcs: Dict[str, int] = {}
        self._quarantined: List[str] = []
        self._manifest_good = True  # on-disk MANIFEST == our generation?

    def _on_fault_injected(self, site: str, kind: str):
        # May run on a flush-pool thread: counter inc + one deque append,
        # both safe under the GIL.
        self.metrics.inc("fault_injected")
        rec = getattr(self._holder(), "recorder", None)
        if rec is not None and rec.enabled:
            rec.fault(site, kind)

    def _init_commit_state(self, group_commit_every: int, group_commit_max_wait_s: float,
                           commit_async: bool, incremental_snapshots: bool,
                           full_snapshot_every: int, manifest_retain: int):
        """Group-commit / async-commit / delta-snapshot knobs and their
        runtime state (shared by fresh and recovered instances)."""
        self.group_commit_every = max(1, group_commit_every)
        self.group_commit_max_wait_s = group_commit_max_wait_s
        self.commit_async = commit_async
        self.incremental_snapshots = incremental_snapshots
        self.full_snapshot_every = max(1, full_snapshot_every)
        self.manifest_retain = max(1, manifest_retain)
        self._group_rounds = 0  # rounds absorbed since the last boundary
        self._group_start: Optional[float] = None
        self._commit_future = None  # in-flight async boundary commit
        self._flush_pool: Optional[ThreadPoolExecutor] = None
        self._commit_pool: Optional[ThreadPoolExecutor] = None
        # per-uid delta-chain bookkeeping: rows dirtied since the shard's
        # last FULL snapshot, and how many deltas that full has absorbed
        self._delta_rows: Dict[str, np.ndarray] = {}
        self._delta_count: Dict[str, int] = {}

    # -- journal lifecycle -----------------------------------------------------

    def _init_journal(self, directory: str, faults: FaultPlan, snapshot_every: int,
                      commit_retries: int = 2, commit_backoff_s: float = 0.002,
                      degrade_after: int = 3, reattach_every: int = 4,
                      group_commit_every: int = 1, group_commit_max_wait_s: float = 0.05,
                      commit_async: bool = False, incremental_snapshots: bool = True,
                      full_snapshot_every: int = 8, manifest_retain: int = 3):
        os.makedirs(directory, exist_ok=True)
        self.dir = directory
        self._init_fault_state(faults, commit_retries, commit_backoff_s, degrade_after,
                               reattach_every)
        self._init_commit_state(group_commit_every, group_commit_max_wait_s, commit_async,
                                incremental_snapshots, full_snapshot_every, manifest_retain)
        self.snapshot_every = snapshot_every
        self.dstats = DurableStats()
        self._commit_idx = 0
        uids = [f"s{i:04d}" for i in range(self._n_shards())]
        self._uids: List[str] = uids
        self._next_uid = len(uids)
        self._snapshots: Dict[str, Optional[str]] = {u: None for u in uids}
        self._segments: Dict[str, List[str]] = {u: [] for u in uids}
        self._shard_commits: Dict[str, int] = {u: -1 for u in uids}
        self._force_snapshot = set(uids)
        self._snap_capacity: Optional[int] = None
        self._forensics: List[dict] = []
        # initial durable state: commit round 0 (empty snapshots, all shards)
        self._commit(force_snapshot=True)

    def _new_shard_uid(self) -> str:
        uid = f"s{self._next_uid:04d}"
        self._next_uid += 1
        self._snapshots[uid] = None
        self._segments[uid] = []
        self._shard_commits[uid] = -1
        self._delta_rows[uid] = np.empty(0, np.int32)
        self._delta_count[uid] = 0
        return uid

    # -- commit protocol (link-and-persist) ------------------------------------

    def _commit(self, force_snapshot: bool = False):
        if self._in_split_now():
            # a shard split is mid-restack (sweep / re-insert rounds run
            # through the same engine): those intermediate states are not
            # round boundaries and must never become the durable prefix.
            return
        # -- group-commit gate: absorb this round into the pending group
        # (dirty bitmaps keep accumulating in the holder, zero I/O) and
        # return unless a boundary condition fires: the group filled, aged
        # past the deadline, needs a forced snapshot, or the breaker is
        # open (degraded bookkeeping must stay per-round).
        self._group_rounds += 1
        now = time.perf_counter()
        if self._group_start is None:
            self._group_start = now
        if (
            not force_snapshot
            and not self._degraded
            and self.group_commit_every > 1
            and self._group_rounds < self.group_commit_every
            and now - self._group_start < self.group_commit_max_wait_s
        ):
            # the only crash window with rounds pending and no I/O started:
            # dying here loses exactly the absorbed rounds; recovery lands
            # on the last complete group boundary (the previous manifest).
            self.faults.maybe_fire("mid_group", self._commit_idx)
            return
        self._commit_group(force_snapshot)

    def _commit_group(self, force_snapshot: bool = False):
        """Commit the pending group: capture host state synchronously, then
        run the link-and-persist sequence (inline, or on the background
        commit thread with ``commit_async``)."""
        reg = self.metrics
        if self._degraded:
            # circuit breaker open: serving continues on the volatile
            # holder; every reattach_every-th commit probes the disk with
            # a single full-snapshot attempt (dirty tracking was reset by
            # the failed commits, so only a snapshot is sound anyway).
            self._degraded_skipped += 1
            self.dstats.commits_suspended += 1
            reg.inc("commits_suspended")
            if self._degraded_skipped % self.reattach_every:
                return
            force_snapshot, max_attempts = True, 1
        else:
            max_attempts = 1 + max(0, self.commit_retries)
        with self.tracer.span("commit") as sp:
            # serialize with a still-flying async boundary: journal bookkeeping
            # is single-writer, so the previous commit must land first; after
            # this join every input of the per-shard file plan is settled.
            self._join_commit()
            absorbed = self._group_rounds
            self._group_rounds = 0
            self._group_start = None
            # -- synchronous capture: the file plan of every shard, and on the
            # host exactly the rows those files hold.  Everything downstream
            # reads only this dict, never the live holder (which keeps
            # mutating under async commits).
            with self._phase("commit.capture", "commit_capture_s") as ph:
                idx = self._commit_idx
                capacity = self._capacity()
                roots = self._shard_roots()
                jobs = self._plan_jobs(idx, force_snapshot, capacity, self._take_dirty_all(), roots)
            sp.note(commit=idx, rounds=absorbed)
            cap = {
                "idx": idx,
                "jobs": jobs,
                "roots": roots,
                "capacity": capacity,
                "mode": self._mode(),
                "extra": self._manifest_extra(),
                "absorbed": absorbed,
                "max_attempts": max_attempts,
                "was_degraded": self._degraded,
                "t_start": ph.t0,
                "sidecar": None,
            }
            rec = getattr(self._holder(), "recorder", None)
            if rec is not None and rec.enabled:
                # the sidecar must describe the COMMITTED prefix, not whatever
                # rounds run while an async commit is in flight: capture the
                # ring now, at the group boundary.
                with self._phase("sidecar.encode") as ph:
                    cap["sidecar"] = (int(self._holder()._rounds), rec.dump_records())
                cap["sidecar_encode_s"] = ph.seconds
            if self.commit_async and not self._degraded:
                if self._commit_pool is None:
                    self._commit_pool = ThreadPoolExecutor(max_workers=1,
                                                           thread_name_prefix="commit")
                self._commit_future = self._commit_pool.submit(self._commit_finish_async, cap)
            else:
                self._commit_finish(cap)

    def _commit_finish_async(self, cap: dict):
        """``_commit_finish`` on the commit thread, under its own span."""
        with self.tracer.span("commit.finish", commit=cap["idx"]):
            self._commit_finish(cap)

    _EMPTY_IDS = np.empty(0, np.int32)

    def _plan_jobs(self, idx: int, force_snapshot: bool, capacity: int,
                   dirty: List[np.ndarray], roots: List[tuple]) -> list:
        """Which file each shard writes at commit ``idx`` (full snapshot,
        delta, segment or none) and the host copy of its rows:
        ``(kind, shard, uid, fname, node_ids, arrays, root, height)`` per
        file.  Every attempt of the commit writes exactly these."""
        # a pool growth invalidates segment node indexing → force snapshots
        grown = self._snap_capacity != capacity
        periodic = idx % self.snapshot_every == 0
        jobs = []
        for s in range(len(dirty)):
            uid = self._uids[s]
            full = (
                force_snapshot
                or grown
                or uid in self._force_snapshot
                or self._snapshots[uid] is None
                or (
                    periodic
                    and (
                        not self.incremental_snapshots
                        or self._delta_count.get(uid, 0) >= self.full_snapshot_every
                    )
                )
            )
            if full:
                jobs.append(("snap", s, uid, f"{uid}_snapshot_{idx:08d}.npz", None,
                             self._host_rows(s, None), *roots[s]))
                continue
            if periodic and self.incremental_snapshots:
                # incremental snapshot: every row dirtied since the shard's
                # last FULL snapshot, in one ``_delta_`` file that REPLACES
                # the segment chain (replay = full + delta + later segs)
                rows = np.union1d(
                    self._delta_rows.get(uid, self._EMPTY_IDS), dirty[s]
                ).astype(np.int32)
                if rows.size:
                    jobs.append(("delta", s, uid, f"{uid}_delta_{idx:08d}.npz", rows,
                                 self._host_rows(s, rows), *roots[s]))
                # rows empty → untouched since its last full snapshot:
                # nothing to consolidate, the lane stays quiet
                continue
            if dirty[s].size:
                jobs.append(("seg", s, uid, f"{uid}_segment_{idx:08d}.npz", dirty[s],
                             self._host_rows(s, dirty[s]), *roots[s]))
            # untouched shard: its journal lane is quiet this commit
        return jobs

    def _join_commit(self):
        """Wait for the in-flight async boundary commit (if any).  Called
        before the next boundary, before structural hooks re-key the
        journal, and from ``drain()``.  A ``SimulatedCrash`` raised on the
        commit thread re-raises here (fail-stop is fail-stop)."""
        fut, self._commit_future = self._commit_future, None
        if fut is not None:
            fut.result()

    def drain(self):
        """Make every applied round durable NOW: flush the pending group
        (if any) and join the in-flight async commit: the group-commit
        analogue of the paper's explicit persist fence."""
        if self._group_rounds:
            self._commit_group()
        self._join_commit()

    def close(self):
        """Drain and shut down the persistent flush/commit pools."""
        self.drain()
        for pool in (self._flush_pool, self._commit_pool):
            if pool is not None:
                pool.shutdown(wait=True)
        self._flush_pool = self._commit_pool = None

    def _commit_finish(self, cap: dict):
        """Retry loop + breaker bookkeeping around ``_commit_once``:
        everything downstream of the synchronous capture.  Runs inline, or
        on the commit thread (``commit_async``); I/O errors never escape
        (the breaker absorbs them), only ``SimulatedCrash`` does."""
        reg = self.metrics
        idx = cap["idx"]
        manifest = None
        for attempt in range(cap["max_attempts"]):
            try:
                manifest = self._commit_once(cap, attempt)
                break
            except OSError:
                # transient fault (injected or real).  SimulatedCrash is a
                # RuntimeError and deliberately NOT caught: fail-stop means
                # dead, and recovery happens from disk.
                self.dstats.commit_retries += 1
                reg.inc("commit_retries")
                if attempt + 1 < cap["max_attempts"] and self.commit_backoff_s > 0:
                    time.sleep(self.commit_backoff_s * (2**attempt))
        rec = getattr(self._holder(), "recorder", None)
        if manifest is None:
            # this commit's dirty set is lost (taken at capture): make the
            # next successful commit a full snapshot of every shard so no
            # round can slip out of the journal.
            self._force_snapshot.update(self._uids)
            self._consec_failures += 1
            if not self._degraded and self._consec_failures >= self.degrade_after:
                self._degraded = True
                self._degraded_skipped = 0
                reg.inc("durability_degraded")
                if rec is not None and rec.enabled:
                    rec.transition("durability", state="degraded", commit=idx,
                                   failures=self._consec_failures)
            return
        was_degraded = cap["was_degraded"]
        self._degraded = False
        self._consec_failures = 0
        self._commit_idx = idx + 1
        self.dstats.commits += 1
        reg.inc("commits")
        reg.observe("rounds_per_commit", cap["absorbed"])
        if was_degraded:
            reg.inc("durability_reattached")
            if rec is not None and rec.enabled:
                rec.transition("durability", state="reattached", commit=idx)
        self._last_audit = manifest.get("audit")
        if rec is not None and rec.enabled:
            # commit marker: links the audit stream to the journal's commit
            # index (lands in the NEXT sidecar: this one is already durable,
            # matching the committed prefix exactly).
            rounds = (cap["sidecar"][0] if cap["sidecar"] is not None
                      else int(self._holder()._rounds))
            rec.commit(idx, rounds, rounds_absorbed=cap["absorbed"])
        reg.observe("commit_latency_s", time.perf_counter() - cap["t_start"])
        with self._phase("commit.gc", "journal_gc_s"):
            self._gc(manifest)

    def _commit_once(self, cap: dict, attempt: int) -> dict:
        """One attempt at the full link-and-persist sequence.  All journal
        bookkeeping is computed into candidates and installed on ``self``
        only after the rename + directory sync land, so a failed attempt
        (raise anywhere) leaves the in-memory generation exactly as
        committed, and a retry rebuilds the identical candidates."""
        reg = self.metrics
        plan = self.faults
        idx = cap["idx"]
        jobs = cap["jobs"]
        with self._phase("journal_flush", "journal_flush_s", commit=idx, files=len(jobs)):
            written = self._write_shard_files(jobs, idx, attempt)
        # candidate bookkeeping, installed only after the commit point
        snapshots = dict(self._snapshots)
        segments = {u: list(v) for u, v in self._segments.items()}
        shard_commits = dict(self._shard_commits)
        file_crcs = dict(self._file_crcs)
        delta_rows = dict(self._delta_rows)
        delta_count = dict(self._delta_count)
        for (kind, s, uid, fname, node_ids, _, _, _), (nbytes, nnodes, crc) in zip(
            jobs, written
        ):
            self.dstats.flush_bytes += nbytes
            self.dstats.fsyncs += 1
            self.dstats.nodes_flushed += nnodes
            reg.inc("flush_bytes", nbytes, shard=s)
            reg.inc("fsyncs", shard=s)
            reg.inc("nodes_flushed", nnodes, shard=s)
            if kind == "snap":
                snapshots[uid] = fname
                segments[uid] = []
                delta_rows[uid] = self._EMPTY_IDS
                delta_count[uid] = 0
                reg.inc("full_snapshots")
            elif kind == "delta":
                segments[uid] = [fname]  # supersedes the chain (and GC's it)
                delta_rows[uid] = node_ids
                delta_count[uid] = delta_count.get(uid, 0) + 1
                reg.inc("delta_snapshots")
            else:
                segments[uid].append(fname)
                delta_rows[uid] = np.union1d(
                    delta_rows.get(uid, self._EMPTY_IDS), node_ids
                ).astype(np.int32)
            shard_commits[uid] = idx
            file_crcs[fname] = crc
        plan.maybe_fire("after_segment", idx)

        # -- forensics sidecar: flush the recorder's ring next to the
        # journal BEFORE the manifest, and commit the *reference* through
        # the manifest's atomic rename: a crash anywhere in this commit
        # leaves the previous manifest pointing at the previous sidecar, so
        # the recovered sidecar always matches the committed round prefix.
        audit_ref = getattr(self, "_last_audit", None)
        if cap["sidecar"] is not None:
            rounds, records = cap["sidecar"]
            audit_ref = f"audit_{idx:08d}.jsonl"
            apath = os.path.join(self.dir, audit_ref)
            tmp_a = apath + ".tmp"
            with self._phase("sidecar.write", "commit_sidecar_s", cap["sidecar_encode_s"],
                             commit=idx, records=len(records)) as ph:
                header = json.dumps({"kind": "sidecar", "commit_idx": idx,
                                     "backend": self.backend, "rounds": rounds})
                data_a = ("\n".join([header, *records]) + "\n").encode()
                file_crcs[audit_ref] = zlib.crc32(data_a) & 0xFFFFFFFF
                torn = plan.fail("sidecar_write", commit=idx, attempt=attempt)
                if torn is not None:
                    data_a = data_a[: max(1, int(len(data_a) * torn))]
                ph.note(bytes=len(data_a))
                with open(tmp_a, "wb") as f:
                    f.write(data_a)
                    f.flush()
                    os.fsync(f.fileno())
                os.replace(tmp_a, apath)

        shard_entries = []
        referenced = set()
        for s, uid in enumerate(self._uids):
            root, height = cap["roots"][s]
            shard_entries.append({
                "uid": uid,
                "snapshot": snapshots[uid],
                "segments": segments[uid],
                "root": root,
                "height": height,
                "commit": shard_commits[uid],
            })
            if snapshots[uid]:
                referenced.add(snapshots[uid])
            referenced.update(segments[uid])
        if audit_ref:
            referenced.add(audit_ref)
        cfg = self._cfg()
        manifest = {
            "version": _MANIFEST_VERSION,
            "backend": self.backend,
            "commit": idx,
            "mode": cap["mode"],
            "snapshot_every": self.snapshot_every,
            "capacity": cap["capacity"],
            "b": cfg.b,
            "a": cfg.a,
            "max_height": cfg.max_height,
            "shards": shard_entries,
            "audit": audit_ref,
            "file_crcs": {f: c for f, c in file_crcs.items() if f in referenced},
            **cap["extra"],
        }
        manifest["checksum"] = _manifest_checksum(manifest)
        tmp = os.path.join(self.dir, "MANIFEST.tmp")
        mpath = os.path.join(self.dir, "MANIFEST")
        payload = json.dumps(manifest)
        with self._phase("manifest_commit", "manifest_commit_s", commit=idx):
            plan.fail("manifest_write", commit=idx, attempt=attempt)
            with open(tmp, "w") as f:
                f.write(payload[: len(payload) // 2])
                f.flush()
                plan.maybe_fire("mid_manifest", idx)
                f.write(payload[len(payload) // 2 :])
                f.flush()
                plan.fail("manifest_fsync", commit=idx, attempt=attempt)
                os.fsync(f.fileno())
            self.dstats.fsyncs += 1
            # retention ring: rotate MANIFEST.prev → .prev2 → … and hardlink
            # the committed manifest to MANIFEST.prev before the rename
            # replaces it, keeping ``manifest_retain`` generations (renames
            # + one link, no data writes, no extra fsync).  Skipped when
            # the on-disk MANIFEST is not our generation (recovery fell
            # back / truncated), so a known-good ring is never rotated
            # under the corrupt manifest we recovered around.
            if self._manifest_good and os.path.exists(mpath):
                for k in range(self.manifest_retain - 1, 1, -1):
                    src = mpath + (".prev" if k == 2 else f".prev{k - 1}")
                    try:
                        os.replace(src, mpath + f".prev{k}")
                    except FileNotFoundError:
                        pass
                if self.manifest_retain > 1:
                    prev = mpath + ".prev"
                    try:
                        os.unlink(prev)
                    except FileNotFoundError:
                        pass
                    os.link(mpath, prev)
            plan.fail("manifest_rename", commit=idx, attempt=attempt)
            os.replace(tmp, mpath)  # the "link" step: THE commit point
            plan.maybe_fire("before_dirsync", idx)
            plan.fail("dir_fsync", commit=idx, attempt=attempt)
            _fsync_dir(self.dir)  # the "persist" step
        self.dstats.fsyncs += 1
        reg.inc("fsyncs", 2)  # manifest file + directory entry
        # the commit point landed: install the candidate bookkeeping
        self._snapshots = snapshots
        self._segments = segments
        self._shard_commits = shard_commits
        self._file_crcs = {f: c for f, c in file_crcs.items() if f in referenced}
        self._delta_rows = delta_rows
        self._delta_count = delta_count
        self._force_snapshot.clear()
        self._snap_capacity = cap["capacity"]
        self._manifest_good = True
        return manifest

    def _pool(self) -> ThreadPoolExecutor:
        """The persistent flush pool: created once, reused by every commit
        (spinning a pool up per commit cost ~ a fsync on fast disks)."""
        if self._flush_pool is None:
            self._flush_pool = ThreadPoolExecutor(max_workers=8,
                                                  thread_name_prefix="durable-flush")
        return self._flush_pool

    def _write_shard_files(self, jobs, idx: int, attempt: int):
        """Write + fsync every shard's journal file for this commit: the
        parallel fsync lanes (one thread per shard file; a single file is
        written inline).  Every future is gathered before this returns, so
        per-file fsync/flush accounting attributes to exactly one commit
        even though the pool outlives it."""
        if len(jobs) <= 1:
            return [self._write_npz(f, ids, a, r, h, s, idx, attempt)
                    for _, s, _, f, ids, a, r, h in jobs]
        # explicit submit + gather (NOT ex.map): map's result iterator
        # cancels still-pending futures when one write raises, which would
        # make the set of I/O sites actually hit, and therefore fault
        # accounting under injection, depend on thread scheduling.  Every
        # submitted write runs to completion; the first error is re-raised
        # only after all lanes have settled.
        ex = self._pool()
        futs = [ex.submit(self._write_npz, f, ids, a, r, h, s, idx, attempt)
                for _, s, _, f, ids, a, r, h in jobs]
        results, first_err = [], None
        for fut in futs:
            try:
                results.append(fut.result())
            except (OSError, SimulatedCrash) as e:
                if first_err is None:
                    first_err = e
        if first_err is not None:
            raise first_err
        return results

    def _write_npz(self, fname: str, node_ids, arrs, root: int, height: int,
                   shard: int, commit: int, attempt: int):
        path = os.path.join(self.dir, fname)
        tmp = path + ".tmp"
        save = dict(arrs)
        if node_ids is not None:
            save["node_ids"] = node_ids
        # flush_bytes counts node-image payload only (deterministic across
        # runs; zip framing and the root/height scalars are excluded)
        nbytes = sum(a.nbytes for a in save.values())
        # root/height ride in every journal file so a truncated replay can
        # land on the root of ITS cut, not the manifest's newer one
        save["root"] = np.int32(root)
        save["height"] = np.int32(height)
        buf = io.BytesIO()
        np.savez(buf, **save)
        data = buf.getvalue()
        crc = zlib.crc32(data) & 0xFFFFFFFF  # CRC of the INTENDED bytes
        torn = self.faults.fail("segment_write", commit=commit, shard=shard, attempt=attempt)
        if torn is not None:
            # silent short write: fsync will "succeed" but the tail never
            # reached disk; only the manifest CRC can catch this later
            data = data[: max(1, int(len(data) * torn))]
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            self.faults.fail("segment_fsync", commit=commit, shard=shard, attempt=attempt)
            os.fsync(f.fileno())  # the paper's clwb+sfence of new nodes
        os.replace(tmp, path)
        nnodes = int(node_ids.size) if node_ids is not None else int(arrs["keys"].shape[0])
        return nbytes, nnodes, crc

    @staticmethod
    def _manifest_refs(manifest: dict) -> set:
        refs = set()
        for sh in manifest["shards"]:
            if sh["snapshot"]:
                refs.add(sh["snapshot"])
            refs.update(sh["segments"])
        if manifest.get("audit"):
            refs.add(manifest["audit"])
        return refs

    def _gc(self, manifest: dict):
        """Unlink journal files no RETAINED manifest generation references
        (prev-generation files survive until their generation rotates off
        the retention ring, so every fallback manifest stays replayable).
        Runs strictly after the directory sync.  A lost unlink is counted
        (``gc_skipped``), never raised."""
        referenced = self._manifest_refs(manifest)
        removed = skipped = 0
        try:
            entries = os.listdir(self.dir)
        except OSError:
            entries = []
            skipped += 1
        for name in entries:
            if name.startswith("MANIFEST.prev"):
                prev = _load_manifest(self.dir, name)
                if prev is not None:
                    referenced |= self._manifest_refs(prev)
        for fname in entries:
            is_audit = fname.endswith(".jsonl") and fname.startswith("audit_")
            is_journal = fname.endswith(".npz") and (
                "_segment_" in fname or "_snapshot_" in fname or "_delta_" in fname
            )
            if not (is_audit or is_journal) or fname in referenced:
                continue
            try:
                os.unlink(os.path.join(self.dir, fname))
                removed += 1
            except FileNotFoundError:
                skipped += 1  # already gone (recovered-over directory)
            except OSError:
                skipped += 1  # busy / transient: retried next commit
        self.dstats.gc_removed += removed
        if removed:
            self.metrics.inc("gc_removed", removed)
        if skipped:
            self.dstats.gc_skipped += skipped
            self.metrics.inc("gc_skipped", skipped)

    def _durable_stats_dict(self) -> Dict[str, int]:
        return dict(
            commits=self.dstats.commits,
            flush_bytes=self.dstats.flush_bytes,
            fsyncs=self.dstats.fsyncs,
            nodes_flushed=self.dstats.nodes_flushed,
            gc_removed=self.dstats.gc_removed,
            commit_retries=self.dstats.commit_retries,
            commits_suspended=self.dstats.commits_suspended,
            gc_skipped=self.dstats.gc_skipped,
        )


class DurableABTree(_DurableBase):
    """ABTree + round-granular link-and-persist durability: the S = 1 case
    of the per-shard journal protocol (one journal lane).  ``device``
    defaults to the CUDA card and raises without one."""

    backend = "tree"

    def __init__(
        self,
        directory: str,
        cfg: TreeConfig = TreeConfig(),
        mode: str = "elim",
        crash=None,
        snapshot_every: int = 64,
        *,
        faults=None,
        commit_retries: int = 2,
        commit_backoff_s: float = 0.002,
        degrade_after: int = 3,
        reattach_every: int = 4,
        group_commit_every: int = 1,
        group_commit_max_wait_s: float = 0.05,
        commit_async: bool = False,
        incremental_snapshots: bool = True,
        full_snapshot_every: int = 8,
        manifest_retain: int = 3,
        device=None,
    ):
        self.tree = ABTree(cfg, mode=mode, device=device)
        if mode == "occ":
            # p-OCC: per-update flush discipline → per-sub-round commits
            # (with group commit, sub-rounds are absorbed at group
            # granularity; the group boundary is the persist fence)
            self.tree.subround_hook = self._commit
        self._init_journal(
            directory, _resolve_faults(crash, faults), snapshot_every, commit_retries,
            commit_backoff_s, degrade_after, reattach_every, group_commit_every,
            group_commit_max_wait_s, commit_async, incremental_snapshots,
            full_snapshot_every, manifest_retain,
        )

    # -- backend surface -------------------------------------------------------

    def _holder(self):
        return self.tree

    def _n_shards(self) -> int:
        return 1

    def _take_dirty_all(self):
        return [self.tree.take_dirty()]

    def _capacity(self) -> int:
        return self.tree.cfg.capacity

    def _cfg(self) -> TreeConfig:
        return self.tree.cfg

    def _mode(self) -> str:
        return self.tree.mode

    # -- public API -----------------------------------------------------------

    def apply_round(self, ops, keys, vals=None, *, scan_cap: int = 128) -> RoundOutput:
        """Apply a round and make it durable.  Results are only returned
        after the commit: the durable linearization discipline.  (In occ
        mode the sub-round hook has already committed each sub-round; no
        further flush is needed.)"""
        out = self.tree.apply_round(ops, keys, vals, scan_cap=scan_cap)
        if self.tree.mode != "occ":
            self._commit()
        return out

    def stats(self) -> Dict[str, int]:
        s = self.tree.stats()
        s.update(self._durable_stats_dict())
        return s


class DurableForest(_DurableBase):
    """ABForest + per-shard link-and-persist durability: one journal lane
    per shard (independent dirty tracking, parallel fsyncs), one manifest
    committing the vector of per-shard commit indices atomically.  A shard
    split forces snapshots of exactly the two affected shards: journals are
    keyed by stable shard uids, so every other shard's segment chain
    survives the restack.  ``device`` defaults to the CUDA card."""

    backend = "forest"

    def __init__(
        self,
        directory: str,
        n_shards: int = 1,
        cfg: TreeConfig = TreeConfig(),
        mode: str = "elim",
        crash=None,
        snapshot_every: int = 64,
        *,
        splits=None,
        key_space=None,
        max_keys_per_shard: Optional[int] = None,
        auto_repartition: bool = False,
        faults=None,
        commit_retries: int = 2,
        commit_backoff_s: float = 0.002,
        degrade_after: int = 3,
        reattach_every: int = 4,
        group_commit_every: int = 1,
        group_commit_max_wait_s: float = 0.05,
        commit_async: bool = False,
        incremental_snapshots: bool = True,
        full_snapshot_every: int = 8,
        manifest_retain: int = 3,
        device=None,
    ):
        self.forest = ABForest(
            n_shards=n_shards, cfg=cfg, mode=mode, splits=splits, key_space=key_space,
            max_keys_per_shard=max_keys_per_shard, auto_repartition=auto_repartition,
            device=device,
        )
        self._wire_hooks()
        self._init_journal(
            directory, _resolve_faults(crash, faults), snapshot_every, commit_retries,
            commit_backoff_s, degrade_after, reattach_every, group_commit_every,
            group_commit_max_wait_s, commit_async, incremental_snapshots,
            full_snapshot_every, manifest_retain,
        )

    def _wire_hooks(self):
        if self.forest.mode == "occ":
            # p-OCC: per-update flush discipline → per-sub-round commits
            self.forest.subround_hook = self._commit
        self.forest.split_hook = self._on_shard_split
        self.forest.repartition_hook = self._on_repartition

    def _on_shard_split(self, s: int):
        """Journal re-keying for a shard split: the fresh shard at ``s + 1``
        gets a new uid, and both affected shards are marked for a forced
        snapshot at the next commit.  Every other uid's chain is untouched.
        An in-flight async commit reads the journal keying: it must land
        before the restack mutates it."""
        self._join_commit()
        self._uids.insert(s + 1, self._new_shard_uid())
        self._force_snapshot.add(self._uids[s])
        self.crash.maybe_fire("mid_split", self._commit_idx)

    def _on_repartition(self, kind: str, a: int, b: int):
        """Journal re-keying for a load-aware repartition.  A boundary
        rebalance keeps every shard's uid but forces both affected shards'
        snapshots; a cold-shard merge retires the dead shard's uid and
        forces the survivor's snapshot.  Either way the next manifest
        commit records the new split points."""
        self._join_commit()
        if kind == "merge":
            dead = self._uids.pop(a)
            self._snapshots.pop(dead, None)
            self._segments.pop(dead, None)
            self._shard_commits.pop(dead, None)
            self._delta_rows.pop(dead, None)
            self._delta_count.pop(dead, None)
            self._force_snapshot.discard(dead)
            self._force_snapshot.add(self._uids[b])
        else:
            self._force_snapshot.add(self._uids[a])
            self._force_snapshot.add(self._uids[b])
        self.crash.maybe_fire("mid_repartition", self._commit_idx)

    # -- backend surface -------------------------------------------------------

    def _holder(self):
        return self.forest

    def _n_shards(self) -> int:
        return self.forest.n_shards

    def _take_dirty_all(self):
        return self.forest.take_dirty()

    def _capacity(self) -> int:
        return self.forest.cfg.capacity

    def _cfg(self) -> TreeConfig:
        return self.forest.cfg

    def _mode(self) -> str:
        return self.forest.mode

    def _in_split_now(self) -> bool:
        return self.forest._in_split

    def _manifest_extra(self) -> dict:
        return {
            "splits": [int(x) for x in self.forest._splits],
            "max_keys_per_shard": self.forest.max_keys_per_shard,
            # the format's int32-gate flags: the port has no such gate (the
            # card takes int64 keys), and the gated TPU path gives the same
            # answers, so it writes false and reads either value
            "narrow": False,
            "narrow_scan": False,
            "auto_repartition": self.forest.auto_repartition,
        }

    # -- public API -----------------------------------------------------------

    @property
    def n_shards(self) -> int:
        return self.forest.n_shards

    def apply_round(self, ops, keys, vals=None, *, scan_cap: int = 128) -> RoundOutput:
        """Apply one forest round and make it durable (results released
        only after the commit).  In occ mode each sub-round has already
        committed via the hook; a shard split triggered by the round is
        journaled as forced snapshots of the two affected shards."""
        out = self.forest.apply_round(ops, keys, vals, scan_cap=scan_cap)
        if self.forest.mode != "occ":
            self._commit()
        return out

    def scan_round(self, lo, hi, cap: int = 128, max_retries: int = 8) -> ScanOutput:
        """Read-only: scans flush nothing (they dirty no nodes)."""
        return self.forest.scan_round(lo, hi, cap=cap, max_retries=max_retries)

    def scan_delete_round(self, lo, hi, cap: int = 128, max_retries: int = 8) -> ScanOutput:
        out = self.forest.scan_delete_round(lo, hi, cap=cap, max_retries=max_retries)
        if self.forest.mode != "occ":
            self._commit()
        return out

    def items(self) -> dict:
        return self.forest.items()

    def stats(self) -> Dict[str, int]:
        s = self.forest.stats()
        s.update(self._durable_stats_dict())
        return s


# ----------------------------------------------------------------------------
# Recovery
# ----------------------------------------------------------------------------


def _validate_chain(directory: str, sh: dict, crcs: Dict[str, int]) -> dict:
    """Validate one shard's journal chain against the manifest CRCs and
    build its replay plan, truncated at the first torn/invalid record.
    Segments past the first invalid one are unreachable and are marked for
    quarantine.  An invalid snapshot sinks the whole generation."""
    snap = sh["snapshot"]
    if not snap or not _file_valid(os.path.join(directory, snap), crcs.get(snap)):
        raise _GenerationInvalid(f"shard {sh['uid']}: snapshot {snap!r} invalid")
    valid: List[str] = []
    invalid: List[str] = []
    for i, seg in enumerate(sh["segments"]):
        if _file_valid(os.path.join(directory, seg), crcs.get(seg)):
            valid.append(seg)
        else:
            if "_delta_" in seg:
                # an invalid DELTA sinks the generation: its rows
                # consolidated (and GC'd) the shard's earlier segments, so
                # truncating at it would silently roll the shard back to its
                # last full snapshot; an older retained generation still
                # references the pre-consolidation chain.
                raise _GenerationInvalid(f"shard {sh['uid']}: delta {seg!r} invalid")
            invalid = sh["segments"][i:]
            break
    return {
        "entry": sh,
        "snapshot": snap,
        "snap_commit": _file_commit_idx(snap),
        "valid": valid,
        "invalid": invalid,
        "truncated": bool(invalid),
        "max_commit": _file_commit_idx(valid[-1]) if valid else _file_commit_idx(snap),
    }


def _plan_generation(directory: str, manifest: dict):
    """Validate a whole manifest generation and compute the CONSISTENT CUT:
    the highest commit index C such that every shard's state at C is
    reproducible from its validated chain.  A shard truncated at commit c
    caps C at c; every other shard is rolled back to C by dropping its
    (valid) segments past C.  A shard whose snapshot (or a delta) postdates
    C sinks the generation (fall back to MANIFEST.prev)."""
    crcs = manifest.get("file_crcs", {})
    plans = [_validate_chain(directory, sh, crcs) for sh in manifest["shards"]]
    cut = manifest["commit"]
    for p in plans:
        if p["truncated"]:
            cut = min(cut, p["max_commit"])
    for p in plans:
        if p["snap_commit"] > cut:
            raise _GenerationInvalid(
                f"shard {p['entry']['uid']}: snapshot commit "
                f"{p['snap_commit']} is past the consistent cut {cut}"
            )
        if any("_delta_" in s for s in p["valid"] if _file_commit_idx(s) > cut):
            # a delta past the cut covers commits ≤ cut whose segments it
            # consolidated away: dropping it would NOT reproduce the shard
            raise _GenerationInvalid(
                f"shard {p['entry']['uid']}: delta past the consistent cut {cut}"
            )
        p["replay"] = [s for s in p["valid"] if _file_commit_idx(s) <= cut]
        p["commit"] = _file_commit_idx(p["replay"][-1]) if p["replay"] else p["snap_commit"]
    return cut, plans


def _load_shard_plan(directory: str, plan: dict):
    """Replay one shard's validated chain on the host: snapshot, then
    surviving segments in commit order.  Root/height come from the LAST
    APPLIED file (journaled per file since manifest v3), so a truncated
    replay lands on the root of its cut; v2 journals fall back to the
    manifest values."""

    def load(fname):
        with np.load(os.path.join(directory, fname)) as z:
            return {k: z[k] for k in z.files}

    snap = load(plan["snapshot"])
    arrs = {f: snap[f].copy() for f in _PERSISTED_FIELDS}
    root = int(snap["root"]) if "root" in snap else None
    height = int(snap["height"]) if "height" in snap else None
    for seg in plan["replay"]:
        z = load(seg)
        ids = z["node_ids"]
        for f in _PERSISTED_FIELDS:
            arrs[f][ids] = z[f]
        if "root" in z:
            root, height = int(z["root"]), int(z["height"])
    if root is None:
        root, height = plan["entry"]["root"], plan["entry"]["height"]
    return arrs, root, height


def _quarantine(directory: str, fnames: List[str]) -> List[str]:
    """Move invalid journal files into ``<dir>/quarantine/``: preserved as
    forensic evidence, never silently deleted, and out of the way of future
    same-name journal writes."""
    if not fnames:
        return []
    qdir = os.path.join(directory, "quarantine")
    os.makedirs(qdir, exist_ok=True)
    moved = []
    for fname in fnames:
        try:
            os.replace(os.path.join(directory, fname), os.path.join(qdir, fname))
            moved.append(os.path.join("quarantine", fname))
        except OSError:
            pass  # already gone: nothing left to preserve
    return moved


def _reachability(children: np.ndarray, is_leaf: np.ndarray, size: np.ndarray, root: int):
    """The recovery walk from the root over host arrays, one tree level a
    step: ``alloc`` (reachable rows) and every reachable child's ``parent``
    and ``pidx``.  Each node of a tree has one parent, so the level order
    writes what the depth-first walk of the JAX package writes."""
    n = children.shape[0]
    alloc = np.zeros((n,), bool)
    parent = np.full((n,), NULL, np.int32)
    pidx = np.zeros((n,), np.int32)
    slots = np.arange(children.shape[1])
    frontier = np.array([root], np.int64)
    while frontier.size:
        frontier = frontier[frontier >= 0]
        frontier = frontier[~alloc[frontier]]
        alloc[frontier] = True
        inner = frontier[~is_leaf[frontier]]
        live = slots[None, :] < size[inner][:, None]
        kids = children[inner][live]
        parent[kids] = np.repeat(inner, live.sum(1)).astype(np.int32)
        pidx[kids] = np.broadcast_to(slots, live.shape)[live].astype(np.int32)
        frontier = kids.astype(np.int64)
    return alloc, parent, pidx


def _rebuild_host(arrs: Dict[str, np.ndarray], root: int, cfg: TreeConfig) -> Dict[str, np.ndarray]:
    """One shard's volatile fields rebuilt from its persisted arrays over
    host numpy (paper §5): size recount, then allocation and parent/pidx
    by the reachability walk from the root.  Returns every field the
    upload replaces."""
    keys = arrs["keys"]
    children = arrs["children"]
    is_leaf = arrs["is_leaf"]
    n = keys.shape[0]  # pool rows = capacity + 1 (scratch row, see make_tree)
    if n != cfg.capacity + 1:
        raise RecoveryError(f"a shard of {n} rows under a manifest of capacity {cfg.capacity}")
    size = np.zeros((n,), np.int32)
    size[is_leaf] = (keys[is_leaf] != EMPTY).sum(axis=1)
    size[~is_leaf] = (children[~is_leaf] != NULL).sum(axis=1)
    alloc, parent, pidx = _reachability(children, is_leaf, size, root)
    return dict(arrs, size=size, alloc=alloc, parent=parent, pidx=pidx)


def _upload_state(host: Dict[str, np.ndarray], root: int, height: int, cfg: TreeConfig,
                  device: torch.device) -> TreeState:
    """One shard's unstacked state on ``device``: a fresh ``make_tree``
    state (versions and records reset, dirty clear) with one upload a
    rebuilt field."""

    def up(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    state = _shard(make_tree(cfg, 1, device), 0)
    return state._replace(
        **{f: up(x) for f, x in host.items()},
        root=torch.tensor(root, dtype=torch.int32, device=device),
        height=torch.tensor(height, dtype=torch.int32, device=device),
        dirty=torch.zeros((cfg.capacity + 1,), dtype=torch.bool, device=device),
    )


def _restore_journal(out: _DurableBase, directory: str, manifest: dict,
                     shard_plans: List[dict], faults: FaultPlan, full: bool,
                     commit_retries: int, commit_backoff_s: float,
                     degrade_after: int, reattach_every: int,
                     commit_knobs: Optional[dict] = None):
    """Restore the journal bookkeeping of a recovered durable instance so it
    resumes committing where the crashed one left off: chains truncated to
    the consistent cut, invalid files quarantined, and (unless the recovery
    was full-fidelity) a forced full snapshot at the next commit plus
    ``_manifest_good = False`` so the corrupt on-disk MANIFEST is never
    hardlinked over a good ``MANIFEST.prev``."""
    from repro_torch.obs.recorder import Recorder

    out.dir = directory
    out._init_fault_state(faults, commit_retries, commit_backoff_s, degrade_after,
                          reattach_every)
    knobs = dict(group_commit_every=1, group_commit_max_wait_s=0.05, commit_async=False,
                 incremental_snapshots=True, full_snapshot_every=8, manifest_retain=3)
    knobs.update(commit_knobs or {})
    out._init_commit_state(**knobs)
    out.snapshot_every = manifest["snapshot_every"]
    out.dstats = DurableStats()
    out._commit_idx = manifest["commit"] + 1
    out._uids = [p["entry"]["uid"] for p in shard_plans]
    out._next_uid = max(int(u[1:]) for u in out._uids) + 1
    out._snapshots = {p["entry"]["uid"]: p["snapshot"] for p in shard_plans}
    out._segments = {p["entry"]["uid"]: list(p["replay"]) for p in shard_plans}
    out._shard_commits = {p["entry"]["uid"]: p["commit"] for p in shard_plans}
    out._force_snapshot = set() if full else set(out._uids)
    out._manifest_good = full
    out._snap_capacity = manifest["capacity"]
    # the rows-since-last-full bookkeeping did not survive the crash: a
    # delta written without it would silently drop rows, so force the next
    # periodic snapshot to be FULL.
    out._delta_rows = {u: out._EMPTY_IDS for u in out._uids}
    out._delta_count = {u: out.full_snapshot_every for u in out._uids}
    crcs = manifest.get("file_crcs", {})
    surviving = set(out._snapshots.values())
    for segs in out._segments.values():
        surviving.update(segs)
    out._file_crcs = {f: crcs[f] for f in surviving if f in crcs}
    bad = [f for p in shard_plans for f in p["invalid"]]
    # crash forensics: load the committed audit sidecar so recovery can
    # explain the committed round prefix.
    out._last_audit = manifest.get("audit")
    out._forensics = []
    if out._last_audit:
        apath = os.path.join(directory, out._last_audit)
        acrc = crcs.get(out._last_audit)
        intact = True
        if acrc is not None:
            try:
                with open(apath, "rb") as f:
                    intact = (zlib.crc32(f.read()) & 0xFFFFFFFF) == acrc
            except OSError:
                intact = False
        if intact:
            try:
                out._forensics = Recorder.load(apath)
            except (OSError, ValueError):
                out._forensics = []  # sidecar lost: forensics degrade, state doesn't
        else:
            bad.append(out._last_audit)  # torn sidecar: quarantine it too
            out._file_crcs.pop(out._last_audit, None)
    out._quarantined = _quarantine(directory, bad)
    if out._quarantined:
        out.metrics.inc("segments_quarantined", len(out._quarantined))


def _generation_names(directory: str) -> List[str]:
    """The manifest generation ladder, newest first: MANIFEST, then the
    retention ring (MANIFEST.prev, MANIFEST.prev2, …) as deep as files
    exist on disk."""
    names = ["MANIFEST", "MANIFEST.prev"]
    extra = []
    try:
        for f in os.listdir(directory):
            suffix = f[len("MANIFEST.prev"):] if f.startswith("MANIFEST.prev") else ""
            if suffix.isdigit():
                extra.append((int(suffix), f))
    except OSError:
        pass
    return names + [f for _, f in sorted(extra)]


def _build_recovered(directory: str, manifest: dict, shard_plans: List[dict], full: bool,
                     faults: FaultPlan, commit_retries: int, commit_backoff_s: float,
                     degrade_after: int, reattach_every: int, commit_knobs: Optional[dict],
                     device: torch.device, timings: dict):
    cfg = TreeConfig(capacity=manifest["capacity"], b=manifest["b"], a=manifest["a"],
                     max_height=manifest["max_height"])
    mode = manifest["mode"]
    t0 = time.perf_counter()
    loaded = [_load_shard_plan(directory, p) for p in shard_plans]
    t1 = time.perf_counter()
    hosts = [_rebuild_host(arrs, root, cfg) for arrs, root, _ in loaded]
    t2 = time.perf_counter()
    stacked = _stack_states([_upload_state(h, root, height, cfg, device)
                             for h, (_, root, height) in zip(hosts, loaded)])
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    timings.update(load_s=t1 - t0, walk_s=t2 - t1, upload_s=time.perf_counter() - t2)
    knobs = (commit_retries, commit_backoff_s, degrade_after, reattach_every, commit_knobs)

    if manifest["backend"] == "forest":
        out = DurableForest.__new__(DurableForest)
        forest = ABForest(
            n_shards=len(loaded), cfg=cfg, mode=mode,
            splits=np.asarray(manifest["splits"], np.int64),
            max_keys_per_shard=manifest["max_keys_per_shard"],
            auto_repartition=manifest.get("auto_repartition", False),
            device=device,
        )
        forest.state = stacked
        out.forest = forest
        _restore_journal(out, directory, manifest, shard_plans, faults, full, *knobs)
        out._wire_hooks()
        return out

    out = DurableABTree.__new__(DurableABTree)
    out.tree = ABTree(cfg, mode=mode, device=device)
    out.tree.stacked = stacked
    _restore_journal(out, directory, manifest, shard_plans, faults, full, *knobs)
    if mode == "occ":
        # a recovered p-OCC tree keeps per-sub-round durability
        out.tree.subround_hook = out._commit
    return out


def recover(directory: str, crash=None, *, faults=None, commit_retries: int = 2,
            commit_backoff_s: float = 0.002, degrade_after: int = 3,
            reattach_every: int = 4, device=None, **commit_knobs):
    """Recovery procedure (paper §5, corruption-hardened): walk the
    generation ladder (the committed MANIFEST first, then the retained
    ``MANIFEST.prev*``) and for the first checksum-valid manifest whose
    files admit a consistent cut, replay each shard's node images
    (truncating at the first torn/invalid record, quarantining bad files),
    rebuild volatile fields, and restack the shards at the recorded split
    points on ``device`` (the CUDA card by default; raises without one).
    Returns a ``DurableABTree`` or ``DurableForest`` according to what was
    journaled, fully operational: occ mode re-installs the per-sub-round
    commit hook and ``snapshot_every`` is restored from the manifest.  The
    recovered instance's ``recovery_timings`` holds the seconds of its
    phases (``plan_s`` for the manifest ladder and the CRC checks,
    ``load_s`` for the npz loads and replay, ``walk_s`` for the host
    rebuild of the volatile fields, ``upload_s`` for the upload).  Raises
    ``RecoveryError`` if no generation yields a committed prefix
    (``FileNotFoundError`` if no manifest was ever committed)."""
    device = _lib.resolve_device(device, "recover")
    plan = _resolve_faults(crash, faults)
    failures = []
    t0 = time.perf_counter()
    for name in _generation_names(directory):
        manifest = _load_manifest(directory, name)
        if manifest is None:
            failures.append(f"{name}: missing or corrupt")
            continue
        try:
            cut, shard_plans = _plan_generation(directory, manifest)
        except _GenerationInvalid as e:
            failures.append(f"{name}: {e}")
            continue
        full = (
            name == "MANIFEST"
            and cut == manifest["commit"]
            and not any(p["truncated"] for p in shard_plans)
        )
        timings = {"plan_s": time.perf_counter() - t0}
        out = _build_recovered(
            directory, manifest, shard_plans, full, plan, commit_retries, commit_backoff_s,
            degrade_after, reattach_every, commit_knobs, device, timings,
        )
        out.recovery_timings = timings
        return out
    if not os.path.exists(os.path.join(directory, "MANIFEST")):
        raise FileNotFoundError(f"no MANIFEST in {directory!r}")
    raise RecoveryError(
        f"no manifest generation in {directory!r} yields a committed prefix: "
        + "; ".join(failures)
    )


def recover_forest(directory: str, crash=None, **kwargs) -> DurableForest:
    """Typed convenience wrapper: recover a ``DurableForest`` journal."""
    out = recover(directory, crash, **kwargs)
    assert isinstance(out, DurableForest), (
        f"journal at {directory!r} is backend {out.backend!r}, not a forest"
    )
    return out
