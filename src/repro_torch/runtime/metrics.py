"""Minimal metrics logging: JSONL sink + rolling means.

Copy of ``repro.runtime.metrics`` (pure Python), kept as the port's own
so that the port never imports the reference package.

The structured registry lives in ``repro_torch.obs`` (counters, gauges,
quantile sketches, exporters); this logger is the lightweight
*training/benchmark* sink — a JSONL line per ``log()`` call plus a
rolling window mean per key, nothing else.
"""
from __future__ import annotations

import json
import os
import time
from collections import deque


class MetricsLogger:
    """JSONL sink + rolling means.

    Parameters
    ----------
    path : append-target JSONL file (parent dirs created); ``None``
        keeps the rolling means only.
    window : samples per key retained for ``mean()``.
    clock : timestamp source for the ``t`` field — injectable so
        deterministic suites and fake-clock benchmarks stamp
        reproducible times (defaults to ``time.time``).

    Context-manager friendly: ``with MetricsLogger(p) as m: ...``
    closes the sink on exit, exceptions included.
    """

    def __init__(self, path=None, window=50, *, clock=time.time):
        self.path = path
        self.window = window
        self.clock = clock
        self.buf: dict = {}            # key -> deque(maxlen=window)
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._f = open(path, "a")
        else:
            self._f = None

    def log(self, step, **kv):
        for k, v in kv.items():
            b = self.buf.get(k)
            if b is None:
                b = self.buf[k] = deque(maxlen=self.window)
            b.append(float(v))
        if self._f:
            self._f.write(json.dumps({"step": step, "t": self.clock(),
                                      **{k: float(v)
                                         for k, v in kv.items()}}) + "\n")
            self._f.flush()

    def mean(self, key):
        """Rolling mean of the last ``window`` samples; NaN for a key
        never logged — and asking does NOT create the key (the old
        defaultdict grew an empty deque per typo'd lookup)."""
        b = self.buf.get(key)
        return sum(b) / len(b) if b else float("nan")

    def close(self):
        if self._f:
            self._f.close()
            self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
