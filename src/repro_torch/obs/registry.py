"""Typed metrics registry — ONE scoreboard for the whole serving stack.

Copy of ``repro.obs.registry``: it needs no JAX, and the port keeps its own
copy so that it never imports the reference package.

Before this module the repo's telemetry was three ad-hoc stats
dataclasses (``GatewayStats`` / ``StreamStats`` / ``ClusterStats``),
each backed by loose counter attributes scattered across the layer that
happened to own them.  The registry inverts that: every counter, gauge
and latency distribution lives HERE, keyed by ``(name, labels)``, and
the stats dataclasses become *views* — ``stats()`` reads the same
objects the hot path mutates, so the pinned conservation invariants
(``submitted == served + depth + in_flight + shed_expired [+ lost]``)
hold bit-for-bit exactly as before, while exporters
(``repro.obs.export``: Prometheus text format, JSONL snapshots) and the
``resource_signals()`` control-plane view get a uniform surface for
free (docs/OBSERVABILITY.md).

Three metric types, deliberately minimal:

- ``Counter`` — an integer that (almost always) goes up.  ``inc()``
  accepts negatives because the serving plane has *relocatable
  ledgers*: a migration moves a session's ``submitted`` count to
  another member, which is neither a serve nor a reset.
- ``Gauge`` — a float level: ``set``/``add``/``ewma`` (the EWMA form is
  what keeps always-on stage timings cheap: one multiply-add per tick,
  no samples retained).
- ``Histogram`` — a bounded **streaming quantile sketch**
  (``QuantileSketch``): exact (``numpy.percentile``-identical) below
  ``exact_cap`` samples, deterministic fixed-ratio log bins beyond.
  This replaces the per-class wait-sample deques — a long-running
  server's memory no longer depends on how many frames it has served.

Concurrency contract (same as the counters it replaced): metric
*creation* is locked; metric *mutation* is not — each metric has one
owning component that already serializes its writes under its own lock
(``queues.cond``, the server ``_lock``, the cluster lock), and
``stats()`` snapshots read under those same locks.  The registry adds
no locking to the hot path.
"""
from __future__ import annotations

import math
import threading

import numpy as np

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "QuantileSketch"]


class QuantileSketch:
    """Deterministic streaming quantile estimator with bounded memory.

    Two regimes, one contract:

    - while ``count <= exact_cap`` the raw samples are retained and
      ``quantile(q)`` is **bit-identical to** ``numpy.percentile``
      (linear interpolation) — every deterministic fake-clock suite
      lives here, so replacing the old sample deques changed no pinned
      value;
    - past ``exact_cap`` the buffer is dropped and quantiles come from
      fixed-ratio log-spaced bins (``growth`` per bin over
      ``[lo, hi]``), geometrically interpolated within the winning bin
      — relative error is bounded by the bin ratio (~``growth - 1``,
      pinned against ``numpy.percentile`` on seeded distributions in
      ``tests/test_obs.py``), and memory is O(bins), forever.

    ``sum``/``count``/``min``/``max`` are exact in both regimes (the
    pinned "terminal wait == 400 ms" style contracts read ``max``).
    Insertion order never matters: the sketch state is a pure function
    of the multiset of observed values, so replayed runs match bitwise.
    """

    __slots__ = ("lo", "hi", "growth", "exact_cap", "count", "total",
                 "vmin", "vmax", "_exact", "_bins", "_log_growth",
                 "_nbins")

    def __init__(self, *, lo: float = 1e-3, hi: float = 1e7,
                 growth: float = 1.1, exact_cap: int = 4096):
        if not (0.0 < lo < hi):
            raise ValueError("need 0 < lo < hi")
        if growth <= 1.0:
            raise ValueError("growth must be > 1")
        if exact_cap < 0:
            raise ValueError("exact_cap must be >= 0")
        self.lo = float(lo)
        self.hi = float(hi)
        self.growth = float(growth)
        self.exact_cap = int(exact_cap)
        self._log_growth = math.log(self.growth)
        # bin i covers [lo*growth^i, lo*growth^(i+1)); one underflow bin
        # (index 0 holds everything <= lo) and one overflow bin at the
        # top hold the tails, so no value is ever dropped
        self._nbins = int(math.ceil(
            math.log(self.hi / self.lo) / self._log_growth)) + 2
        self._bins = [0] * self._nbins
        self._exact: list | None = []
        self.count = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf

    # -- ingest --------------------------------------------------------------
    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.total += v
        if v < self.vmin:
            self.vmin = v
        if v > self.vmax:
            self.vmax = v
        self._bins[self._bin_of(v)] += 1
        if self._exact is not None:
            if self.count <= self.exact_cap:
                self._exact.append(v)
            else:        # bounded by construction: drop the raw samples
                self._exact = None

    def _bin_of(self, v: float) -> int:
        if v <= self.lo:
            return 0
        if v >= self.hi:
            return self._nbins - 1
        return 1 + min(self._nbins - 3,
                       int(math.log(v / self.lo) / self._log_growth))

    # -- quantiles -----------------------------------------------------------
    def quantile(self, q: float) -> float:
        """The ``q``-th percentile, ``q`` in [0, 100] (numpy
        convention).  Exact below ``exact_cap``; binned geometric
        interpolation beyond, clamped into [min, max]."""
        if self.count == 0:
            return 0.0
        if self._exact is not None:
            return float(np.percentile(
                np.asarray(self._exact, np.float64), q))
        rank = (q / 100.0) * (self.count - 1)
        cum = 0
        for i, n in enumerate(self._bins):
            if n == 0:
                continue
            if cum + n > rank:
                # geometric interpolation inside the winning bin
                frac = (rank - cum + 0.5) / n
                if i == 0:
                    est = self.lo
                else:
                    lo_edge = self.lo * self.growth ** (i - 1)
                    est = lo_edge * self.growth ** min(1.0, max(0.0, frac))
                return float(min(max(est, self.vmin), self.vmax))
            cum += n
        return float(self.vmax)

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def summary(self) -> dict:
        """The ``StreamStats.queue_wait_ms`` shape: p50/p95/mean/max
        (zeros when empty, like the deques it replaced)."""
        if self.count == 0:
            return {"p50": 0.0, "p95": 0.0, "mean": 0.0, "max": 0.0}
        return {"p50": self.quantile(50), "p95": self.quantile(95),
                "mean": self.mean, "max": float(self.vmax)}

    @property
    def exact(self) -> bool:
        """True while quantiles are still ``numpy.percentile``-exact."""
        return self._exact is not None

    def state(self) -> dict:
        """JSON-able snapshot (exporters): aggregates + regime."""
        return {"count": self.count, "sum": self.total,
                "min": self.vmin if self.count else 0.0,
                "max": self.vmax if self.count else 0.0,
                "exact": self.exact, **self.summary()}


class _Metric:
    __slots__ = ("name", "labels")

    def __init__(self, name: str, labels: tuple):
        self.name = name
        self.labels = labels       # tuple of (key, value), sorted

    @property
    def labels_dict(self) -> dict:
        return dict(self.labels)


class Counter(_Metric):
    """An owned integer.  ``inc`` may be negative — the serving plane
    relocates ledgers (migration moves a session's counts between
    members); exporters still expose it as a counter because within one
    member's lifetime it is monotone for every metric that matters."""

    __slots__ = ("value",)
    kind = "counter"

    def __init__(self, name, labels):
        super().__init__(name, labels)
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n


class Gauge(_Metric):
    """A float level: set, add, or exponentially smooth."""

    __slots__ = ("value",)
    kind = "gauge"

    def __init__(self, name, labels):
        super().__init__(name, labels)
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def add(self, d: float) -> None:
        self.value += d

    def ewma(self, v: float, alpha: float = 0.2) -> float:
        """One multiply-add: the always-on stage-timing update.  The
        first sample seeds the average (no zero-pull warmup)."""
        self.value = (float(v) if self.value == 0.0
                      else (1.0 - alpha) * self.value + alpha * float(v))
        return self.value

    def try_set_max(self, v: float) -> None:
        if v > self.value:
            self.value = float(v)


class Histogram(_Metric):
    """A named ``QuantileSketch``."""

    __slots__ = ("sketch",)
    kind = "histogram"

    def __init__(self, name, labels, **sketch_kw):
        super().__init__(name, labels)
        self.sketch = QuantileSketch(**sketch_kw)

    def observe(self, v: float) -> None:
        self.sketch.observe(v)

    def summary(self) -> dict:
        return self.sketch.summary()

    def quantile(self, q: float) -> float:
        return self.sketch.quantile(q)

    @property
    def count(self) -> int:
        return self.sketch.count


class MetricsRegistry:
    """All metrics of one serving stack, keyed by ``(name, labels)``.

    Get-or-create accessors (``counter``/``gauge``/``histogram``) are
    idempotent and type-checked: asking for an existing name with a
    different type raises instead of silently shadowing.  One registry
    is shared down a stack (gateway ⊂ server; the cluster keeps its own
    federation-level registry beside the members') — names are
    prefixed per layer (``gateway_*`` / ``stream_*`` / ``cluster_*``)
    so they never collide.
    """

    def __init__(self):
        self._metrics: dict = {}
        self._lock = threading.Lock()

    @staticmethod
    def _key(name: str, labels: dict) -> tuple:
        return (name, tuple(sorted(labels.items())))

    def _get_or_create(self, cls, name, labels, **kw):
        key = self._key(name, labels)
        m = self._metrics.get(key)
        if m is not None:
            if not isinstance(m, cls):
                raise ValueError(
                    f"metric {name!r}{dict(labels)} is a {m.kind}, "
                    f"not a {cls.kind}")
            return m
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = cls(name, key[1], **kw)
                self._metrics[key] = m
            elif not isinstance(m, cls):
                raise ValueError(
                    f"metric {name!r}{dict(labels)} is a {m.kind}, "
                    f"not a {cls.kind}")
            return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get_or_create(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get_or_create(Gauge, name, labels)

    def histogram(self, name: str, *, lo: float = 1e-3, hi: float = 1e7,
                  growth: float = 1.1, exact_cap: int = 4096,
                  **labels) -> Histogram:
        return self._get_or_create(Histogram, name, labels, lo=lo, hi=hi,
                                   growth=growth, exact_cap=exact_cap)

    # -- read side -----------------------------------------------------------
    def get(self, name: str, **labels):
        """The metric, or None — never creates."""
        return self._metrics.get(self._key(name, labels))

    def value(self, name: str, **labels):
        """Counter/gauge value (0 for an absent metric — the view
        convention: an untouched counter was never incremented)."""
        m = self.get(name, **labels)
        return 0 if m is None else m.value

    def collect(self) -> list:
        """Every metric, sorted by (name, labels) — the exporter walk.
        The list is a snapshot; the metrics it holds are live."""
        with self._lock:
            return [self._metrics[k] for k in sorted(self._metrics)]

    def __len__(self) -> int:
        return len(self._metrics)
