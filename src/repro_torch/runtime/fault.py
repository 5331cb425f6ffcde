"""Fault-tolerance utilities: a transient/fatal fault taxonomy with a
deterministic retry policy, failure injection (tests/chaos), straggler
detection with deadline policy, and an elastic-restart helper.

Copy of ``repro.runtime.fault``: pure Python, kept as the port's own
copy so that the port never imports the reference package.

Everything here is deterministic by construction: the injector's
probabilistic mode is seeded, the retry policy computes its backoff
schedule as a pure function of the attempt index and "waits" through an
injectable ``sleep`` (``None`` in stepped/test mode — no wall-clock
sleeps anywhere), and the straggler monitor keeps only the trailing
``window`` of step durations.
"""
from __future__ import annotations

import random
import statistics
from collections import deque
from dataclasses import dataclass, field


class TransientFault(RuntimeError):
    """A fault worth retrying — a network blip, a preempted RPC, a
    briefly unreachable member.  The fault taxonomy the cluster's
    ``RetryPolicy`` keys on: a ``TransientFault`` raised by a member
    call (submit / step / checkpoint) is retried with backoff; any
    other exception is FATAL and fails the member over immediately.
    """


def is_transient(exc: BaseException) -> bool:
    """The taxonomy predicate ``RetryPolicy`` applies."""
    return isinstance(exc, TransientFault)


@dataclass
class RetryPolicy:
    """Deterministic exponential backoff over ``TransientFault``s.

    ``call(fn)`` invokes ``fn`` up to ``max_attempts`` times total,
    retrying only transient faults (``is_transient``); the backoff
    before retry ``i`` (1-based) is ``base_s * factor**(i-1)`` capped
    at ``max_backoff_s`` — a pure function of the attempt index, no
    jitter, so a chaos test replays the exact same schedule.  The wait
    itself goes through the injectable ``sleep`` callable; the default
    ``None`` waits nothing (stepped mode — the cluster advances on an
    injected clock and must never block the step loop on wall time),
    but the schedule is still computed, reported to ``on_retry`` and
    accumulated in ``backoff_s_total``.

    Exhausting the attempts re-raises the LAST transient fault — the
    caller's fatal path (e.g. ``GatewayCluster._member_failed``) takes
    over, so a persistently "transient" member is eventually treated
    as dead rather than retried forever.
    """

    max_attempts: int = 3          # total attempts, including the first
    base_s: float = 0.05
    factor: float = 2.0
    max_backoff_s: float = 1.0
    sleep: object = None           # callable(delay_s) or None (no wait)
    retries: int = field(default=0, init=False)        # cumulative
    backoff_s_total: float = field(default=0.0, init=False)

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        if self.base_s < 0 or self.factor < 1.0 or self.max_backoff_s < 0:
            raise ValueError("backoff schedule must be non-negative and "
                             "non-decreasing (factor >= 1)")

    def backoff_s(self, retry_index: int) -> float:
        """Backoff before the ``retry_index``-th retry (1-based)."""
        return min(self.base_s * self.factor ** (retry_index - 1),
                   self.max_backoff_s)

    def call(self, fn, *, on_retry=None):
        """Run ``fn`` with retries; transient-only, capped, deterministic.

        ``on_retry(retry_index, backoff_s, exc)`` is invoked before
        each retry (the cluster counts ``ClusterStats.retries`` here).
        """
        attempt = 1
        while True:
            try:
                return fn()
            except TransientFault as e:
                if attempt >= self.max_attempts:
                    raise
                delay = self.backoff_s(attempt)
                self.retries += 1
                self.backoff_s_total += delay
                if on_retry is not None:
                    on_retry(attempt, delay, e)
                if self.sleep is not None:
                    self.sleep(delay)
                attempt += 1


class FailureInjector:
    """Deterministic chaos source for the cluster's member-call seams.

    Three independent modes, all keyed by the caller's step counter:

    - ``fail_at``: raise a FATAL ``RuntimeError`` at the named steps
      (once each — a node loss, not a poisoned step id);
    - ``transient_at``: raise ``TransientFault`` at the named steps; a
      set/sequence fires once per step, a ``{step: n}`` dict fires the
      first ``n`` attempts at that step — so a retry policy with
      ``max_attempts > n`` recovers the member and one with
      ``max_attempts <= n`` exhausts into the fatal path;
    - ``p_transient``: seeded probabilistic mode — every ``maybe_fail``
      call independently raises ``TransientFault`` with probability
      ``p`` from a private ``random.Random(seed)`` stream, so a chaos
      sweep with the same seed replays the exact same fault pattern;
    - ``hang_from``: from that step on, ``hanging(step)`` is True — the
      member is STUCK, not raising: the cluster must skip its turn and
      let heartbeat suspicion (``cluster/health.py``) detect it.
    """

    def __init__(self, fail_at=(), *, transient_at=(), p_transient: float = 0.0,
                 seed: int = 0, hang_from: int | None = None):
        if not 0.0 <= p_transient < 1.0:
            raise ValueError("p_transient must be in [0, 1)")
        self.fail_at = set(fail_at)
        if isinstance(transient_at, dict):
            self.transient_at = {int(s): int(n)
                                 for s, n in transient_at.items()}
        else:
            self.transient_at = {int(s): 1 for s in transient_at}
        self.p_transient = float(p_transient)
        self.hang_from = hang_from
        self.fired = set()
        self.transients_fired = 0
        self._rng = random.Random(seed)

    def hanging(self, step) -> bool:
        """True once the member is stuck (never raises — a hung member
        makes no progress AND reports no error)."""
        return self.hang_from is not None and step >= self.hang_from

    def maybe_fail(self, step):
        remaining = self.transient_at.get(step, 0)
        if remaining > 0:
            self.transient_at[step] = remaining - 1
            self.transients_fired += 1
            raise TransientFault(
                f"injected transient fault at step {step}")
        if self.p_transient and self._rng.random() < self.p_transient:
            self.transients_fired += 1
            raise TransientFault(
                f"injected probabilistic transient fault at step {step}")
        if step in self.fail_at and step not in self.fired:
            self.fired.add(step)
            raise RuntimeError(f"injected node failure at step {step}")


@dataclass
class StragglerEvent:
    step: int
    time_s: float
    median_s: float


class StragglerMonitor:
    """Flags steps slower than ``factor`` x trailing-median.

    On a real fleet the policy would be: re-issue the slow shard's work to
    a hot spare / drop the slow host from the next mesh (see
    checkpoint/elastic.py).  Here we record the event and expose it to the
    trainer and tests.

    Retention is bounded: only the trailing ``window`` step durations
    are kept (that is all the median ever reads) — an always-on cluster
    must not grow host state with uptime.
    """

    def __init__(self, factor=3.0, window=50, warmup=5):
        self.factor = factor
        self.window = window
        self.warmup = warmup
        self.samples = 0                       # total recorded, ever
        self.times = deque(maxlen=window)      # trailing window only
        self.events: list[StragglerEvent] = []

    def record(self, step, dt):
        if self.samples >= self.warmup:
            med = statistics.median(self.times)
            if dt > self.factor * med:
                self.events.append(StragglerEvent(step, dt, med))
        self.times.append(dt)
        self.samples += 1
        return bool(self.events and self.events[-1].step == step)
