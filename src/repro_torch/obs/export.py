"""Exporters: Prometheus exposition text + JSONL snapshots.

Copy of ``repro.obs.export``: it needs no JAX, and the port keeps its own
copy so that it never imports the reference package.

The registry is the source of truth; exporters are pure read-side
walks over ``MetricsRegistry.collect()``:

- ``to_prometheus(registry)`` — the text exposition format scrapers
  expect.  Counters/gauges map directly; histograms export as
  *summaries* (``{quantile="0.5"}``/``{quantile="0.95"}`` plus
  ``_sum``/``_count``/``_max``) because the sketch's log-bins are an
  implementation detail — quantiles are the contract.
- ``validate_prometheus(text)`` — a strict structural validator used
  by CI (``benchmarks/obs_bench.py``): metric-name/label grammar,
  float-parseable values, ``# TYPE`` declared before first sample,
  no duplicate (name, labels) series.
- ``registry_snapshot(registry)`` / ``write_jsonl(...)`` — one
  JSON-able dict per call, appended as a line for offline analysis
  (``BENCH_obs.json`` carries one in CI).

Metric names here are chosen by the components (``gateway_*`` /
``stream_*`` / ``cluster_*``) and are already exposition-legal; label
*values* are arbitrary strings and get escaped.
"""
from __future__ import annotations

import json
import re
import time

from .registry import Counter, Gauge, Histogram

__all__ = ["to_prometheus", "validate_prometheus", "registry_snapshot",
           "write_jsonl"]

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>[^{}]*)\})?"
    r" (?P<value>\S+)(?: (?P<ts>-?\d+))?$")
_LABEL_RE = re.compile(
    r'^(?P<key>[a-zA-Z_][a-zA-Z0-9_]*)="(?P<val>(?:[^"\\]|\\.)*)"$')


def _escape(v) -> str:
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _label_str(pairs) -> str:
    if not pairs:
        return ""
    inner = ",".join(f'{k}="{_escape(v)}"' for k, v in pairs)
    return "{" + inner + "}"


def _fmt(v) -> str:
    # integers stay integral (Prometheus accepts both; keeps diffs
    # clean on deterministic suites), floats use repr round-trip
    f = float(v)
    return str(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


def to_prometheus(registry, *, prefix: str = "") -> str:
    """The registry in Prometheus text exposition format."""
    by_name: dict = {}
    for m in registry.collect():
        by_name.setdefault(prefix + m.name, []).append(m)
    out = []
    for name, metrics in by_name.items():
        kind = metrics[0].kind
        if kind == "histogram":
            out.append(f"# TYPE {name} summary")
            for m in metrics:
                s = m.sketch
                for q, qv in (("0.5", s.quantile(50)),
                              ("0.95", s.quantile(95))):
                    pairs = list(m.labels) + [("quantile", q)]
                    out.append(f"{name}{_label_str(pairs)} "
                               f"{_fmt(qv if s.count else 0.0)}")
                out.append(f"{name}_sum{_label_str(m.labels)} "
                           f"{_fmt(s.total)}")
                out.append(f"{name}_count{_label_str(m.labels)} "
                           f"{_fmt(s.count)}")
                out.append(f"{name}_max{_label_str(m.labels)} "
                           f"{_fmt(s.vmax if s.count else 0.0)}")
        else:
            out.append(f"# TYPE {name} {kind}")
            for m in metrics:
                out.append(f"{name}{_label_str(m.labels)} "
                           f"{_fmt(m.value)}")
    return "\n".join(out) + "\n" if out else ""


def validate_prometheus(text: str) -> int:
    """Structurally validate exposition text; returns the number of
    samples.  Raises ``ValueError`` with the offending line on any
    grammar violation, type-before-sample violation, or duplicate
    series."""
    declared: dict = {}
    seen_series = set()
    n_samples = 0
    for lineno, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) >= 3 and parts[1] == "TYPE":
                name = parts[2]
                if not _NAME_RE.match(name):
                    raise ValueError(f"line {lineno}: bad TYPE name "
                                     f"{name!r}")
                if len(parts) < 4 or parts[3] not in (
                        "counter", "gauge", "histogram", "summary",
                        "untyped"):
                    raise ValueError(f"line {lineno}: bad TYPE kind")
                declared[name] = parts[3]
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            raise ValueError(f"line {lineno}: unparseable sample "
                             f"{line!r}")
        name = m.group("name")
        base = name
        for suf in ("_sum", "_count", "_max", "_bucket"):
            if name.endswith(suf) and name[:-len(suf)] in declared:
                base = name[:-len(suf)]
                break
        if base not in declared:
            raise ValueError(f"line {lineno}: sample {name!r} before "
                             f"its # TYPE declaration")
        labels = m.group("labels")
        if labels:
            for part in labels.split(","):
                if not _LABEL_RE.match(part):
                    raise ValueError(f"line {lineno}: bad label "
                                     f"{part!r}")
        try:
            float(m.group("value"))
        except ValueError:
            raise ValueError(f"line {lineno}: non-numeric value "
                             f"{m.group('value')!r}") from None
        series = (name, labels or "")
        if series in seen_series:
            raise ValueError(f"line {lineno}: duplicate series "
                             f"{series}")
        seen_series.add(series)
        n_samples += 1
    return n_samples


def registry_snapshot(registry, *, clock=None) -> dict:
    """One JSON-able dict: every metric's current value (histograms as
    their ``state()`` summary)."""
    metrics = []
    for m in registry.collect():
        entry = {"name": m.name, "labels": m.labels_dict,
                 "kind": m.kind}
        if isinstance(m, Histogram):
            entry["value"] = m.sketch.state()
        elif isinstance(m, (Counter, Gauge)):
            entry["value"] = m.value
        metrics.append(entry)
    return {"t_s": (clock or time.time)(), "metrics": metrics}


def write_jsonl(registry, path, *, step: int = 0, clock=None) -> dict:
    """Append one snapshot line to ``path``; returns the snapshot."""
    snap = registry_snapshot(registry, clock=clock)
    snap["step"] = step
    with open(path, "a") as fh:
        fh.write(json.dumps(snap) + "\n")
    return snap
