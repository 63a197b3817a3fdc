"""Telemetry of the port's round engine (port of ``src/repro/obs/``), all
host-side:

  * :mod:`repro_torch.obs.tracer` — ``Tracer``: span timers around every
    phase of the ``core/rounds.py`` pipeline; fences with
    ``torch.cuda.synchronize`` only when enabled.
  * :mod:`repro_torch.obs.metrics` — ``MetricsRegistry``: counters, gauges
    and histograms with per-shard attribution, ``RegistryBackedCounters``
    (the holders' legacy counters over the registry) and
    ``engine_collector``.
  * :mod:`repro_torch.obs.recorder` — ``Recorder``: the flight recorder, a
    bounded ring of semantic per-round audit records (JAX's JSONL schema).
  * :mod:`repro_torch.obs.witness` — replays a recorded history through the
    sequential ``DictOracle`` and checks that the engine's chosen
    linearization is a legal sequential history (CLI:
    ``python -m repro_torch.obs.witness audit.jsonl``).
  * :mod:`repro_torch.obs.trace_export` / :mod:`repro_torch.obs.report` —
    Chrome trace-event JSON (Perfetto-loadable) and its schema check; the
    phase / shard breakdown and the crash-forensics report (CLI:
    ``python -m repro_torch.obs.report PATH [--json]``).
  * :mod:`repro_torch.obs.op_audit` — the ``torch.profiler`` op audit of
    the search and scan phases (the port's form of JAX's HLO audit): no
    sort in the scan phases, and the hand-written kernel each phase
    launches on the card.
"""
from repro_torch.obs.metrics import (
    MetricsRegistry,
    RegistryBackedCounters,
    engine_collector,
)
from repro_torch.obs.recorder import NULL_RECORDER, Recorder
from repro_torch.obs.tracer import NULL_TRACER, Tracer

__all__ = [
    "MetricsRegistry",
    "RegistryBackedCounters",
    "Tracer",
    "NULL_TRACER",
    "Recorder",
    "NULL_RECORDER",
    "engine_collector",
]
