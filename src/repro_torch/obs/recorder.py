"""Bounded flight recorder: the post-mortem trail.

Copy of ``repro.obs.recorder``: pure Python, kept as the port's own
copy so that the port never imports the reference package.

Two rings and one ledger:

- ``traces`` — the most recent finished ``FrameTrace`` spans (the
  tracer retires sampled frames here);
- ``events`` — every *anomalous* decision the serving plane takes,
  with enough attributes to reconstruct it: shed (which frame, how
  stale, against which deadline), deadline miss, preemption, retry
  (attempt, error), failover (member, sessions lost), degraded
  refusal, rate limit, queue-full rejection, hang detection, drain
  stragglers;
- ``counts`` — a cumulative per-kind tally that is **never evicted**.
  The rings are bounded (`deque(maxlen=...)`), so after a long overload
  the oldest sheds fall off the ring — but the acceptance contract
  ("reconstruct shed/failover counts exactly from a dump") is carried
  by ``counts``, which the rings merely illustrate.

``dump()`` is cheap and safe to call from any thread (one small lock —
the recorder is only touched on anomaly paths and per-sampled-frame
retirement, never per-frame when tracing is off).  The cluster calls it
automatically when a member fails (``GatewayCluster.failover_dumps``),
so the black box survives exactly the event it exists to explain.
"""
from __future__ import annotations

import json
import threading
import time
from collections import deque

__all__ = ["FlightRecorder", "EVENT_KINDS"]

# the closed vocabulary of anomalies — exporters and the dump schema
# key off these names; adding one is an API change (the reference's
# docs/OBSERVABILITY.md documents them)
EVENT_KINDS = (
    "shed", "deadline_miss", "preempt", "requeue", "retry",
    "member_failed", "failover", "member_hung", "degraded_refusal",
    "rate_limited", "queue_full", "lost_in_flight", "drain_straggler",
    "journal_replay", "migrate_out", "migrate_in",
)


class FlightRecorder:
    """Ring of recent spans + anomaly events with exact cumulative
    counts."""

    def __init__(self, *, trace_capacity: int = 256,
                 event_capacity: int = 2048, clock=time.perf_counter):
        self.trace_capacity = int(trace_capacity)
        self.event_capacity = int(event_capacity)
        self.clock = clock
        self._traces: deque = deque(maxlen=self.trace_capacity)
        self._events: deque = deque(maxlen=self.event_capacity)
        self._counts: dict = {}
        self._lock = threading.Lock()

    # -- write side ----------------------------------------------------------
    def record(self, kind: str, t_s: float | None = None, **attrs) -> None:
        """One anomalous event.  ``t_s`` defaults to the injected
        clock; attrs are kept verbatim (must be JSON-able)."""
        if t_s is None:
            t_s = self.clock()
        with self._lock:
            self._counts[kind] = self._counts.get(kind, 0) + 1
            self._events.append({"kind": kind, "t_s": t_s, **attrs})

    def keep_trace(self, trace) -> None:
        """Retire a finished ``FrameTrace`` into the span ring."""
        with self._lock:
            self._traces.append(trace)

    # -- read side -----------------------------------------------------------
    def counts(self) -> dict:
        """Cumulative per-kind event counts — exact for the whole run,
        regardless of ring eviction."""
        with self._lock:
            return dict(self._counts)

    def events(self, kind: str | None = None) -> list:
        with self._lock:
            evs = list(self._events)
        return evs if kind is None else [e for e in evs
                                         if e["kind"] == kind]

    def traces(self) -> list:
        with self._lock:
            return list(self._traces)

    def dump(self, *, reason: str = "on_demand") -> dict:
        """JSON-able snapshot of the whole black box."""
        with self._lock:
            return {
                "reason": reason,
                "t_s": self.clock(),
                "counts": dict(self._counts),
                "events": list(self._events),
                "traces": [tr.to_dict() for tr in self._traces],
                "evicted_events": max(
                    0, sum(self._counts.values()) - len(self._events)),
            }

    def dump_json(self, path=None, *, reason: str = "on_demand") -> str:
        """The dump as a JSON string; also written to ``path`` if
        given."""
        text = json.dumps(self.dump(reason=reason), default=str)
        if path is not None:
            with open(path, "w") as fh:
                fh.write(text)
        return text
