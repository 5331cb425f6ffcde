"""Heartbeat failure detection — catching members that HANG.

Copy of ``repro.cluster.health`` (pure Python).  A member's failure
seam only fires when a member *raises*: a member whose step loop wedges
(deadlocked executor, stuck device, livelocked queue) makes no progress,
reports no error, and would hold its sessions hostage forever.  This
module closes that gap with the classic heartbeat/suspicion pattern,
deterministic on the injected clock:

- every completed member turn in ``GatewayCluster.step()`` records a
  BEAT for that member (an idle member still beats — completing a
  no-op step is progress; what a hung member cannot do is complete);
- ``suspects()`` returns every watched member whose last beat is older
  than ``suspect_after_s`` on the cluster's own timer;
- the cluster routes a suspect through the SAME ``_member_failed`` →
  checkpoint + journal-replay recovery path as a raising member, with
  a typed ``MemberHungError`` as the cause — hung and crashed members
  are indistinguishable to the sessions they held, which is the point.

No wall-clock anywhere: the monitor reads time only through the clock
it was constructed with, so chaos tests advance a fake clock and get
byte-for-byte reproducible suspicion decisions.
"""
from __future__ import annotations

__all__ = ["HeartbeatMonitor", "MemberHungError"]


class MemberHungError(RuntimeError):
    """A member stopped making progress without raising — detected by
    heartbeat suspicion, failed over like a crash (typed so postmortems
    can tell a hang from a fault)."""

    def __init__(self, name, silent_for_s: float, suspect_after_s: float):
        self.name = name
        self.silent_for_s = float(silent_for_s)
        self.suspect_after_s = float(suspect_after_s)
        super().__init__(
            f"member {name!r} hung: no heartbeat for "
            f"{silent_for_s:.3f}s (suspicion threshold "
            f"{suspect_after_s:.3f}s)")


class HeartbeatMonitor:
    """Last-beat table + suspicion threshold on an injected clock.

    Not thread-safe on its own — the owning cluster mutates it under
    its lock, like every other piece of federation state.
    """

    def __init__(self, *, suspect_after_s: float, clock, registry=None):
        if suspect_after_s <= 0:
            raise ValueError("suspect_after_s must be > 0")
        self.suspect_after_s = float(suspect_after_s)
        self._clock = clock
        self._last: dict = {}      # member -> clock at last beat
        self._beats = (registry.counter("cluster_heartbeats")
                       if registry is not None else None)

    def watch(self, name) -> None:
        """Start (or reset) monitoring — admission counts as a beat, so
        a freshly joined member gets a full suspicion window before it
        can be declared hung."""
        self._last[name] = self._clock()

    def forget(self, name) -> None:
        self._last.pop(name, None)

    def beat(self, name) -> None:
        """The member completed a step — progress, by definition."""
        if name in self._last:
            self._last[name] = self._clock()
            if self._beats is not None:
                self._beats.inc()

    def silent_for_s(self, name) -> float:
        return self._clock() - self._last[name]

    def suspects(self) -> list:
        """``[(name, silent_for_s)]`` past the threshold, name order —
        deterministic, like every other iteration in the cluster."""
        now = self._clock()
        return [(n, now - t) for n, t in sorted(self._last.items())
                if now - t > self.suspect_after_s]
