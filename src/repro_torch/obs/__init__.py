"""Telemetry plane of the port: the typed metrics registry, its
Prometheus/JSONL exporters, per-frame span tracing and the flight
recorder (copies of ``repro.obs.registry``, ``export``, ``trace`` and
``recorder``)."""
from .export import (registry_snapshot, to_prometheus,
                     validate_prometheus, write_jsonl)
from .recorder import EVENT_KINDS, FlightRecorder
from .registry import (Counter, Gauge, Histogram, MetricsRegistry,
                       QuantileSketch)
from .trace import FrameTrace, Tracer, sampled

__all__ = [
    "Counter", "EVENT_KINDS", "FlightRecorder", "FrameTrace", "Gauge",
    "Histogram", "MetricsRegistry", "QuantileSketch", "Tracer",
    "registry_snapshot", "sampled", "to_prometheus",
    "validate_prometheus", "write_jsonl",
]
