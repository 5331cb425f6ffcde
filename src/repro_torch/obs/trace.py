"""Per-frame span tracing on the injected clock.

Copy of ``repro.obs.trace``: pure Python, kept as the port's own
copy so that the port never imports the reference package.

A sampled frame accumulates one ``FrameTrace``: an ordered list of
``(event, t_s, attrs)`` stamps taken at every hop of its life —

    submit → enqueue → admit (or promote → admit) → stage →
    dispatch(shard, bucket) → collect → serve

plus the federation hops (``journal`` / ``migrate_out`` /
``migrate_in`` / ``replay``) and the terminal anomalies (``shed``,
``preempt`` records also land in the flight recorder).  Timestamps come
from whatever clock the owning component was constructed with, so on
the fake-clock suites traces are exactly reproducible and span
durations are assertable to the millisecond.

The contract that matters is the OFF path.  Tracing is disabled by
default (``sample=0.0``) and the reference pins its overhead below 2% of
serve throughput (``benchmarks/obs_bench.py``), so the design puts
*nothing* on the hot path but a single attribute test:

- the trace context rides on ``QueuedFrame.trace`` (and
  ``QueuedFrameSnapshot.trace`` across migration), defaulting to
  ``None``; every stamp site is ``if qf.trace is not None: ...`` —
  no dict lookup, no allocation, no clock read when off;
- ``Tracer.maybe_begin`` decides sampling with a **deterministic
  integer hash** of ``(sid, t)`` (no RNG, no state): the same frame is
  sampled on every member it migrates through, replays re-sample
  identically, and ``sample=1.0``/``0.0`` short-circuit without
  hashing.

Finished traces are handed to the ``FlightRecorder`` ring; live ones
are reachable from the frames that carry them.  There is deliberately
no central "active spans" table — it would need rekeying on migration
and would leak entries for shed frames.
"""
from __future__ import annotations

import time

__all__ = ["FrameTrace", "Tracer", "sampled"]

# Knuth multiplicative hash over a (sid, t) mix; 32-bit phase compared
# against sample * 2^32.  Pure function — every member/replay agrees.
_HASH_MUL = 2654435761
_SID_MIX = 1000003
_MASK32 = 0xFFFFFFFF


def sampled(sid: int, t: int, sample: float) -> bool:
    """Deterministic per-frame sampling decision, identical across
    members, migrations and journal replays."""
    if sample >= 1.0:
        return True
    if sample <= 0.0:
        return False
    h = ((sid * _SID_MIX + t + 1) * _HASH_MUL) & _MASK32
    return h < sample * (_MASK32 + 1)


class FrameTrace:
    """One frame's span: an append-only event list.

    Slotted and pickle-friendly (it crosses the ``SessionSnapshot`` /
    journal pickle boundary inside ``QueuedFrameSnapshot``), with no
    references back into live server objects.
    """

    __slots__ = ("sid", "t", "trace_id", "events")

    def __init__(self, sid: int, t: int, trace_id: str):
        self.sid = sid
        self.t = t
        self.trace_id = trace_id
        self.events: list = []   # [(name, t_s, attrs-dict-or-None)]

    def add(self, name: str, t_s: float, **attrs) -> None:
        self.events.append((name, t_s, attrs or None))

    def names(self) -> list:
        return [e[0] for e in self.events]

    def find(self, name: str):
        """First event with this name, or None."""
        for e in self.events:
            if e[0] == name:
                return e
        return None

    def span_ms(self, first: str, last: str) -> float:
        """Clock distance between two stamped events (ms)."""
        a, b = self.find(first), self.find(last)
        if a is None or b is None:
            raise KeyError(f"trace {self.trace_id} missing "
                           f"{first if a is None else last!r}")
        return (b[1] - a[1]) * 1e3

    def to_dict(self) -> dict:
        return {"trace_id": self.trace_id, "sid": self.sid, "t": self.t,
                "events": [{"name": n, "t_s": ts,
                            **({"attrs": at} if at else {})}
                           for n, ts, at in self.events]}

    # pickles cleanly, but be explicit that equality is by identity —
    # a migrated trace is the SAME span continued, not a copy to diff
    def __repr__(self):
        return (f"FrameTrace({self.trace_id}, "
                f"{'>'.join(self.names()) or 'empty'})")


class Tracer:
    """Sampling gate + trace factory for one serving stack.

    ``sample`` is the fraction of frames traced (0.0 = off, the
    default).  ``maybe_begin`` is the only entry point the submit path
    touches; when the frame loses the sampling toss it returns ``None``
    having allocated nothing.
    """

    __slots__ = ("sample", "clock", "recorder", "started", "finished")

    def __init__(self, sample: float = 0.0, *,
                 clock=time.perf_counter, recorder=None):
        if not (0.0 <= sample <= 1.0):
            raise ValueError("sample must be in [0, 1]")
        self.sample = float(sample)
        self.clock = clock
        self.recorder = recorder
        self.started = 0
        self.finished = 0

    @property
    def enabled(self) -> bool:
        return self.sample > 0.0

    def maybe_begin(self, sid: int, t: int, now: float | None = None,
                    **attrs):
        """A new ``FrameTrace`` stamped with ``submit``, or ``None``
        when the frame is not sampled (the zero-allocation path)."""
        if self.sample <= 0.0 or not sampled(sid, t, self.sample):
            return None
        tr = FrameTrace(sid, t, f"{sid:x}-{t:x}")
        tr.add("submit", self.clock() if now is None else now, **attrs)
        self.started += 1
        return tr

    def adopt(self, sid: int, t: int, name: str,
              now: float | None = None, **attrs):
        """Begin a trace at a non-submit hop — journal replay creates
        frames whose original submit already happened on the failed
        member.  Same sampling decision as the original submit."""
        if self.sample <= 0.0 or not sampled(sid, t, self.sample):
            return None
        tr = FrameTrace(sid, t, f"{sid:x}-{t:x}")
        tr.add(name, self.clock() if now is None else now, **attrs)
        self.started += 1
        return tr

    def finish(self, trace, name: str = "serve",
               now: float | None = None, **attrs) -> None:
        """Stamp the terminal event and retire the trace into the
        flight recorder (if one is attached)."""
        if trace is None:
            return
        trace.add(name, self.clock() if now is None else now, **attrs)
        self.retire(trace)

    def retire(self, trace) -> None:
        """Retire an already-terminated trace (its last hop — e.g. the
        scheduler's ``shed`` stamp — was the terminal event)."""
        if trace is None:
            return
        self.finished += 1
        if self.recorder is not None:
            self.recorder.keep_trace(trace)
