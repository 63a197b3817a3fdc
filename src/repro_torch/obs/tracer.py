"""Low-overhead span tracer for the host-sequenced round engine (port of
``src/repro/obs/tracer.py``).

A span wraps one phase's launches; with tracing on, ``fence`` waits for the
device (``torch.cuda.synchronize()`` when the fenced value holds a CUDA
tensor) before the end timestamp, so the duration covers the device work,
not just the launch.

  * **Disabled** (``enabled=False``, or no tracer installed): ``span()``
    returns a shared no-op context manager and ``fence`` is the identity; no
    synchronisation is ever issued and nothing is recorded.
  * **Enabled**: one ``perf_counter`` pair + one dict append per span, plus
    the fences; each span is also a ``torch.profiler.record_function``
    range of the same name, so a profile of the same run shows it.
    Fencing serializes host and device, so an enabled tracer is a
    measurement tool, not a production default.

Timestamps (``ts``, microseconds) are on the clock the torch profiler
stamps its CPU events with (Unix time), so an exported trace lays over a
profiler trace of the same run; durations come from ``perf_counter``.

Tracks: 0 is the thread that made the tracer (the engine's sequencing
thread), ``1 + s`` shard ``s``; a span opened on another thread without a
shard goes on that thread's own track (``THREAD_TRACK0`` on), named after
the thread less a pool's worker number (the durable commit thread's is
``commit``).

Events use the Chrome trace-event model (complete events ``ph="X"``,
instants ``ph="i"``, counters ``ph="C"``); ``export`` writes them through
``obs/trace_export.py`` in the ``{"traceEvents": [...]}`` envelope, with the
process and thread names Perfetto shows.
"""
from __future__ import annotations

import re
import threading
import time
from typing import Dict, List, Optional

import torch

from repro_torch.obs.trace_export import write_chrome_trace

__all__ = ["Tracer", "NULL_TRACER", "THREAD_TRACK0"]

# first track of the threads other than the engine's (shards take 1 + s)
THREAD_TRACK0 = 1 << 20


def _now_us() -> float:
    """Now on the profiler's CPU clock (Unix time), in microseconds."""
    return time.time_ns() / 1e3


def _has_cuda_tensor(x) -> bool:
    if isinstance(x, torch.Tensor):
        return x.is_cuda
    if isinstance(x, (tuple, list)):
        return any(_has_cuda_tensor(v) for v in x)
    if isinstance(x, dict):
        return any(_has_cuda_tensor(v) for v in x.values())
    return False


class _NullSpan:
    """Shared do-nothing span: the whole disabled fast path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def fence(self, x):
        return x

    def note(self, **kw):
        return None


_NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("_tracer", "name", "shard", "args", "_t0", "_ts", "_rf")

    def __init__(self, tracer: "Tracer", name: str, shard, args: dict):
        self._tracer = tracer
        self.name = name
        self.shard = shard
        self.args = args

    def __enter__(self):
        self._rf = torch.profiler.record_function(self.name)
        self._rf.__enter__()
        self._ts = _now_us()
        self._t0 = time.perf_counter()
        return self

    def fence(self, x):
        """Wait until ``x``'s device work completes (enabled path only)."""
        if _has_cuda_tensor(x):
            torch.cuda.synchronize()
        return x

    def note(self, **kw):
        """Attach key/values to the span's args (visible in the trace)."""
        self.args.update(kw)

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        self._rf.__exit__(*exc)
        tr = self._tracer
        tr.events.append(
            {
                "name": self.name,
                "ph": "X",
                "ts": self._ts,
                "dur": (t1 - self._t0) * 1e6,
                "pid": tr.pid,
                "tid": tr._tid(self.shard),
                "args": self.args,
            }
        )
        return False


class Tracer:
    """Span/instant/counter recorder in Chrome trace-event form.  Track 0 is
    the engine's sequencing thread; track ``1 + s`` is shard ``s``; other
    threads get tracks of their own, named in ``tracks``."""

    def __init__(self, enabled: bool = True, *, pid: int = 0):
        self.enabled = enabled
        self.pid = pid
        self.events: List[Dict] = []
        self.tracks: Dict[int, str] = {}  # thread track -> its name
        self._engine = threading.get_ident()
        self._threads: Dict[int, int] = {}  # thread ident -> its track

    def _tid(self, shard) -> int:
        """The track of an event of ``shard`` opened on this thread."""
        if shard is not None:
            return 1 + int(shard)
        ident = threading.get_ident()
        if ident == self._engine:
            return 0
        tid = self._threads.get(ident)
        if tid is None:
            tid = self._threads[ident] = THREAD_TRACK0 + len(self._threads)
            self.tracks[tid] = re.sub(r"_\d+$", "", threading.current_thread().name)
        return tid

    def span(self, name: str, *, shard: Optional[int] = None, **args):
        """Context manager timing one phase: ``with tracer.span("apply") as
        sp: out = phase(...); sp.fence(out)``."""
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, shard, args)

    def instant(self, name: str, *, shard: Optional[int] = None, **args):
        """Zero-duration marker (per-shard attribution events)."""
        if not self.enabled:
            return
        self.events.append(
            {
                "name": name,
                "ph": "i",
                "s": "t",
                "ts": _now_us(),
                "pid": self.pid,
                "tid": self._tid(shard),
                "args": args,
            }
        )

    def counter(self, name: str, value, *, shard: Optional[int] = None):
        """Chrome counter-track sample (rendered as a graph in Perfetto)."""
        if not self.enabled:
            return
        self.events.append(
            {
                "name": name,
                "ph": "C",
                "ts": _now_us(),
                "pid": self.pid,
                "tid": self._tid(shard),
                "args": {"value": float(value)},
            }
        )

    def shard_marks(self, name: str, per_shard, **extra):
        """One instant per shard with non-zero work (lane counts are the
        per-shard cost signal of a phase that spans all shards)."""
        if not self.enabled:
            return
        for s, n in enumerate(per_shard):
            if int(n):
                self.instant(name, shard=s, lanes=int(n), **extra)

    def clear(self):
        """Drop the recorded events (the clock is the profiler's, and runs on)."""
        self.events.clear()

    def export(self, path: str) -> str:
        """Write the Chrome trace-event JSON file (Perfetto-loadable)."""
        return write_chrome_trace(path, self)


# The disabled singleton holders fall back to when no tracer is installed.
NULL_TRACER = Tracer(enabled=False)
