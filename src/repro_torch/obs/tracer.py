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
    the fences.  Fencing serializes host and device, so an enabled tracer is
    a measurement tool, not a production default.

Events use the Chrome trace-event model (complete events ``ph="X"``,
instants ``ph="i"``); ``export`` writes them through
``obs/trace_export.py`` in the ``{"traceEvents": [...]}`` envelope, with the
process and thread names Perfetto shows.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

import torch

from repro_torch.obs.trace_export import write_chrome_trace

__all__ = ["Tracer", "NULL_TRACER"]


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
    __slots__ = ("_tracer", "name", "shard", "args", "_t0")

    def __init__(self, tracer: "Tracer", name: str, shard, args: dict):
        self._tracer = tracer
        self.name = name
        self.shard = shard
        self.args = args

    def __enter__(self):
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
        tr = self._tracer
        tr.events.append(
            {
                "name": self.name,
                "ph": "X",
                "ts": (self._t0 - tr._epoch) * 1e6,
                "dur": (t1 - self._t0) * 1e6,
                "pid": tr.pid,
                "tid": 0 if self.shard is None else 1 + int(self.shard),
                "args": self.args,
            }
        )
        return False


class Tracer:
    """Span/instant recorder in Chrome trace-event form.  Track 0 is
    the engine's sequencing thread; track ``1 + s`` is shard ``s``."""

    def __init__(self, enabled: bool = True, *, pid: int = 0):
        self.enabled = enabled
        self.pid = pid
        self.events: List[Dict] = []
        self._epoch = time.perf_counter()

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
                "ts": (time.perf_counter() - self._epoch) * 1e6,
                "pid": self.pid,
                "tid": 0 if shard is None else 1 + int(shard),
                "args": args,
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

    def export(self, path: str) -> str:
        """Write the Chrome trace-event JSON file (Perfetto-loadable)."""
        return write_chrome_trace(path, self)


# The disabled singleton holders fall back to when no tracer is installed.
NULL_TRACER = Tracer(enabled=False)
