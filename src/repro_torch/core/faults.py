"""Fault-injection failpoints for the durable path, seeded and
deterministic (port of ``src/repro/core/faults.py``, plain Python).

The paper's durability argument assumes fail-stop crashes at arbitrary
points; ``CrashPoint`` (below) injects exactly those.  A production durable
forest also faces *transient* I/O faults: EIO on fsync, ENOSPC mid-segment,
torn/short writes that a lying volatile cache "persisted", rename failures,
pathological fsync latency.  ``FaultPlan`` is the failpoint registry that
injects all of them at the named I/O sites of ``core/durable.py``, so the
retry / circuit-breaker / corruption-recovery machinery can be driven
deterministically under load.

Failpoint sites (each consulted once per I/O operation of a commit):

  ``segment_write``    serializing + writing one shard's journal file
  ``segment_fsync``    fsync of a journal file (runs on the flush pool)
  ``sidecar_write``    the audit forensics sidecar write + fsync
  ``manifest_write``   writing MANIFEST.tmp
  ``manifest_fsync``   fsync of MANIFEST.tmp
  ``manifest_rename``  the atomic os.replace (the commit point)
  ``dir_fsync``        the directory-entry fsync after the rename

Fault kinds:

  ``eio``          OSError(EIO): transient I/O error (retryable)
  ``enospc``       OSError(ENOSPC): disk full (retryable; clears when the
                   spec's ``times`` budget is exhausted)
  ``torn``         SILENT short write: the write "succeeds" but only
                   ``torn_frac`` of the bytes reach disk (models a volatile
                   cache lost after fsync returned); only meaningful at
                   ``segment_write``/``sidecar_write``; detected at
                   recovery by the journal CRCs
  ``rename_fail``  OSError(EIO) out of os.replace
  ``latency``      sleeps ``latency_s`` then succeeds (a sick-disk stall)
  ``crash``        raises SimulatedCrash (fail-stop kill at an I/O site)

Determinism: whether a spec fires NEVER depends on wall clock or thread
scheduling.  Selection is a pure function of ``(plan seed, site, commit
index, shard, attempt)``: probabilistic specs hash that tuple into a
uniform draw (the same crc32 draw as the JAX package's, so one seeded plan
fires at the same I/O operations in both), windowed specs compare the
commit index.  A seeded soak run therefore injects the identical fault
schedule on every machine, even though the per-shard journal writes run on
a thread pool.  (The only shared mutable state, the per-spec ``times``
budget, is decremented under a lock; specs used with parallel writers
should prefer commit windows over ``times`` when exact cross-thread
determinism matters.)

``CrashPoint`` is the one-shot fail-stop injector; ``FaultPlan``
generalizes it: a plan carries any number of crash points (plus fault
specs), and ``as_fault_plan`` lifts a bare ``CrashPoint`` (or ``None``)
into a plan so ``core/durable.py`` handles exactly one injection surface.
"""
from __future__ import annotations

import errno
import threading
import time
import zlib
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Tuple

__all__ = [
    "SimulatedCrash",
    "InjectedFault",
    "CrashPoint",
    "FaultSpec",
    "FaultPlan",
    "as_fault_plan",
    "FAULT_SITES",
    "FAULT_KINDS",
]

FAULT_SITES = (
    "segment_write",
    "segment_fsync",
    "sidecar_write",
    "manifest_write",
    "manifest_fsync",
    "manifest_rename",
    "dir_fsync",
)

FAULT_KINDS = ("eio", "enospc", "torn", "rename_fail", "latency", "crash")

_ERRNO = {"eio": errno.EIO, "enospc": errno.ENOSPC, "rename_fail": errno.EIO}


class SimulatedCrash(RuntimeError):
    """Fail-stop: the process is considered dead at this point.  Never
    retried; recovery happens from disk via ``recover``/``recover_forest``."""


class InjectedFault(OSError):
    """An injected transient I/O fault.  Subclasses OSError with a real
    errno so the durable layer's retry path treats injected and genuine
    disk faults identically; tests can still tell them apart by type."""

    def __init__(self, kind: str, site: str, detail: str = ""):
        super().__init__(
            _ERRNO.get(kind, errno.EIO),
            f"injected {kind} at {site}" + (f" ({detail})" if detail else ""),
        )
        self.kind = kind
        self.site = site


@dataclass
class CrashPoint:
    """Injects a fail-stop crash at the named step of the given commit index.

    Steps: ``after_segment`` (shard files flushed, manifest not yet
    written), ``mid_manifest`` (torn manifest tmp), ``before_dirsync``
    (manifest renamed, directory not yet synced), ``mid_split`` (a shard
    split restacked the forest; nothing of the surrounding round has
    committed — ``at_commit`` is the NEXT commit index at that moment),
    ``mid_repartition`` (a load-aware boundary rebalance or cold-shard
    merge just re-keyed the journals; same NEXT-commit-index convention
    as ``mid_split``), ``mid_group`` (a round was ABSORBED into a pending
    commit group — ``group_commit_every`` > 1 — and no boundary I/O has
    started; same NEXT-commit-index convention: the absorbed rounds would
    have committed as ``at_commit``, so recovery lands on the last
    complete group boundary)."""

    step: str = ""  # "after_segment" | "mid_manifest" | "before_dirsync"
    #              | "mid_split" | "mid_repartition" | "mid_group"
    at_commit: int = -1  # commit index at which to fire (-1 = never)
    _count: int = field(default=0, repr=False)

    def maybe_fire(self, step: str, commit_idx: int):
        if self.step == step and self.at_commit == commit_idx:
            raise SimulatedCrash(f"simulated crash at {step} (commit {commit_idx})")


@dataclass
class FaultSpec:
    """One failpoint rule.  Matches hits at ``site`` (or ``"*"``) whose
    commit index falls in the half-open ``commits`` window (``None`` =
    every commit); of the matching hits, fires with probability ``p``
    (deterministically hashed from the hit's identity — see module
    docstring), at most ``times`` times total (``None`` = unbounded).

    A spec with a finite ``times`` models a *transient* fault: it clears
    once the budget is spent, which is what the commit retry loop needs to
    eventually succeed."""

    site: str  # failpoint name, or "*" for every site
    kind: str  # one of FAULT_KINDS
    p: float = 1.0  # fire probability per matching hit
    commits: Optional[Tuple[int, int]] = None  # [lo, hi) commit window
    times: Optional[int] = None  # total fire budget (None = unbounded)
    latency_s: float = 0.0  # kind="latency": injected stall
    torn_frac: float = 0.5  # kind="torn": fraction of bytes that survive
    _fired: int = field(default=0, repr=False)

    def __post_init__(self):
        assert self.kind in FAULT_KINDS, f"unknown fault kind {self.kind!r}"

    def matches(self, site: str, commit: int) -> bool:
        if self.site != "*" and self.site != site:
            return False
        if self.commits is not None and not (
            self.commits[0] <= commit < self.commits[1]
        ):
            return False
        return self.times is None or self._fired < self.times


def _hash_draw(seed: int, site: str, commit: int, shard: int, attempt: int) -> float:
    """Uniform [0, 1) draw as a pure function of the hit's identity."""
    key = f"{seed}:{site}:{commit}:{shard}:{attempt}".encode()
    return (zlib.crc32(key) & 0xFFFFFFFF) / 2**32


class FaultPlan:
    """Deterministic failpoint registry for the durable path.

    ``fail(site, commit=, shard=, attempt=)`` is the single injection
    surface: it raises (``InjectedFault`` / ``SimulatedCrash``), sleeps
    (latency kind), or returns a ``torn_frac`` float the caller must apply
    to its byte payload (silent short write) — ``None`` means no fault.
    ``maybe_fire(step, commit_idx)`` is the ``CrashPoint`` passthrough for
    the protocol-step crash sites.  ``on_inject`` (if set) is called as
    ``on_inject(site, kind)`` for every injected fault — the durable layer
    hooks the ``fault_injected`` counter and the flight recorder there."""

    def __init__(
        self,
        seed: int = 0,
        specs: Optional[List[FaultSpec]] = None,
        crash: Optional[CrashPoint] = None,
    ):
        self.seed = int(seed)
        self.specs: List[FaultSpec] = list(specs or [])
        self.crashes: List[CrashPoint] = [crash] if crash is not None else []
        self.on_inject: Optional[Callable[[str, str], None]] = None
        self.injected = 0  # total faults injected (all kinds, all sites)
        self._lock = threading.Lock()

    # -- registration ----------------------------------------------------------

    def add(self, spec: FaultSpec) -> "FaultPlan":
        self.specs.append(spec)
        return self

    def add_crash(self, crash: CrashPoint) -> "FaultPlan":
        self.crashes.append(crash)
        return self

    def clear(self) -> None:
        """Drop every spec (the disk 'healed') — crash points stay."""
        with self._lock:
            self.specs = []

    @property
    def enabled(self) -> bool:
        return bool(self.specs or self.crashes)

    # -- crash-point surface (protocol steps) ----------------------------------

    def maybe_fire(self, step: str, commit_idx: int) -> None:
        for c in self.crashes:
            c.maybe_fire(step, commit_idx)

    # -- failpoint surface (I/O sites) -----------------------------------------

    def _note(self, site: str, kind: str) -> None:
        self.injected += 1
        if self.on_inject is not None:
            self.on_inject(site, kind)

    def fail(
        self, site: str, *, commit: int = -1, shard: int = -1, attempt: int = 0
    ) -> Optional[float]:
        """Consult every spec for this hit.  Raises / sleeps on a firing
        fault; returns the ``torn_frac`` for a silent torn write, else
        ``None``.  Thread-safe; selection is deterministic (see module
        docstring)."""
        if not self.specs:  # fast path: disabled plan is one attribute check
            return None
        torn: Optional[float] = None
        for spec in self.specs:
            with self._lock:
                if not spec.matches(site, commit):
                    continue
                if spec.p < 1.0 and (
                    _hash_draw(self.seed, site, commit, shard, attempt) >= spec.p
                ):
                    continue
                spec._fired += 1
            self._note(site, spec.kind)
            if spec.kind == "latency":
                time.sleep(spec.latency_s)
                continue
            if spec.kind == "torn":
                torn = spec.torn_frac if torn is None else min(torn, spec.torn_frac)
                continue
            if spec.kind == "crash":
                raise SimulatedCrash(
                    f"simulated kill at {site} (commit {commit}, shard {shard})"
                )
            raise InjectedFault(spec.kind, site, f"commit {commit}, shard {shard}")
        return torn

    def stats(self) -> dict:
        return {
            "injected": self.injected,
            "specs": [
                {"site": s.site, "kind": s.kind, "fired": s._fired}
                for s in self.specs
            ],
        }


def as_fault_plan(x) -> FaultPlan:
    """Lift the durable constructors' ``crash=`` argument — ``None``, a
    bare ``CrashPoint``, or a full ``FaultPlan`` — into a plan, so the
    commit protocol handles exactly one injection surface."""
    if x is None:
        return FaultPlan()
    if isinstance(x, FaultPlan):
        return x
    if isinstance(x, CrashPoint):
        return FaultPlan(crash=x)
    raise TypeError(f"expected CrashPoint | FaultPlan | None, got {type(x)!r}")
