"""Telemetry plane of the port: the typed metrics registry and its
Prometheus/JSONL exporters (copies of ``repro.obs.registry`` and
``repro.obs.export``).  Span tracing and the flight recorder come with
the serving runtime."""
from .export import (registry_snapshot, to_prometheus,
                     validate_prometheus, write_jsonl)
from .registry import (Counter, Gauge, Histogram, MetricsRegistry,
                       QuantileSketch)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "QuantileSketch",
    "registry_snapshot", "to_prometheus", "validate_prometheus",
    "write_jsonl",
]
