"""Telemetry of the port's round engine: metrics registry, phase tracer,
flight recorder."""
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.recorder import NULL_RECORDER, Recorder
from repro_torch.obs.tracer import NULL_TRACER, Tracer

__all__ = ["MetricsRegistry", "NULL_RECORDER", "NULL_TRACER", "Recorder", "Tracer"]
