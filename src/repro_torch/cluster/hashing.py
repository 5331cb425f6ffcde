"""Deterministic consistent-hash ring — who owns a session.

Copy of ``repro.cluster.hashing``: pure Python on ``hashlib``, so every
placement equals the reference's key for key.

The federation layer (``cluster/cluster.py``) places every session on a
member gateway by hashing its cluster-wide session id onto a ring of
virtual nodes.  Everything here is a pure function of ``(members,
weights, seed)`` — keyed blake2b, no wall clock, no ``random`` — so a
test (or a second cluster replica) rebuilding the ring from the same
membership reproduces every placement decision bit-for-bit.

Why consistent hashing and not round-robin: on membership change only
the keys whose arc moved change owner — ``add`` steals arcs for the new
member and touches nobody else, ``remove`` hands the departed member's
arcs to its ring successors.  The cluster exploits exactly that:
rebalance migrates *only* sessions whose ``owner`` changed.

``set_weight`` scales a member's virtual-node count — the straggler
signal (``runtime/fault.StragglerMonitor``) biases placement away from
a slow member by shrinking its share of the hash space without evicting
what it already serves.
"""
from __future__ import annotations

import bisect
import hashlib

_SPACE = 1 << 64          # hash points are 64-bit (blake2b digest_size=8)


class HashRing:
    """Weighted consistent-hash ring over opaque member names.

    ``vnodes`` virtual nodes per unit weight smooth the arc
    distribution (at 64 the max/min owned-share ratio over a few
    members stays within ~2x); ``seed`` keys the hash so distinct
    clusters disagree about placement while one cluster is perfectly
    reproducible.
    """

    def __init__(self, members=(), *, seed: int = 0, vnodes: int = 64):
        if vnodes < 1:
            raise ValueError("vnodes must be >= 1")
        self.seed = int(seed)
        self.vnodes = vnodes
        self._weights: dict = {}
        self._points: list[int] = []       # sorted vnode hash points
        self._owners: list = []            # member at each point
        for m in members:
            self.add(m)

    def _hash(self, key: str) -> int:
        h = hashlib.blake2b(key.encode("utf-8"), digest_size=8,
                            key=self.seed.to_bytes(8, "big", signed=True))
        return int.from_bytes(h.digest(), "big")

    # -- membership ----------------------------------------------------------
    @property
    def members(self) -> list:
        return sorted(self._weights)

    def has(self, member) -> bool:
        return member in self._weights

    def weight(self, member) -> float:
        return self._weights[member]

    def add(self, member, weight: float = 1.0) -> None:
        if member in self._weights:
            raise ValueError(f"member {member!r} already on the ring")
        if weight <= 0:
            raise ValueError("weight must be > 0")
        self._weights[member] = float(weight)
        self._rebuild()

    def remove(self, member) -> None:
        if member not in self._weights:
            raise KeyError(f"member {member!r} not on the ring")
        del self._weights[member]
        self._rebuild()

    def set_weight(self, member, weight: float) -> None:
        """Rescale a member's share of the hash space (its vnode count)
        — the straggler-bias hook.  Only arcs that change hands move."""
        if member not in self._weights:
            raise KeyError(f"member {member!r} not on the ring")
        if weight <= 0:
            raise ValueError("weight must be > 0")
        self._weights[member] = float(weight)
        self._rebuild()

    def _rebuild(self) -> None:
        pts = []
        for m in sorted(self._weights):
            n = max(1, round(self.vnodes * self._weights[m]))
            pts.extend((self._hash(f"{m}#{i}"), m) for i in range(n))
        pts.sort()
        self._points = [p for p, _ in pts]
        self._owners = [m for _, m in pts]

    # -- placement -----------------------------------------------------------
    def owner(self, key):
        """The member owning ``key``'s arc: its hash point's clockwise
        successor vnode.  Raises ``KeyError`` on an empty ring."""
        if not self._points:
            raise KeyError("empty ring")
        i = bisect.bisect_right(self._points, self._hash(str(key)))
        return self._owners[i % len(self._owners)]

    def preference(self, key) -> list:
        """Distinct members in ring-walk order from ``key``'s point —
        the failover order: placement tries ``preference(key)[0]``
        first and walks on when a member refuses admission or is gone.
        Empty ring -> empty list."""
        if not self._points:
            return []
        i = bisect.bisect_right(self._points, self._hash(str(key)))
        n = len(self._owners)
        seen, out = set(), []
        for j in range(n):
            m = self._owners[(i + j) % n]
            if m not in seen:
                seen.add(m)
                out.append(m)
        return out

    def buddy(self, key, exclude=()):
        """The first member on ``key``'s ring walk not in ``exclude``
        — the deterministic replication-buddy choice
        (``cluster/replication.py``): with ``exclude=(owner,)`` this is
        the next LIVE node past the owner, which is also exactly where
        the owner's keys would land if it died, so the journal is
        already on the member most likely to inherit the session.
        ``None`` when no such member exists (single-member ring)."""
        for m in self.preference(key):
            if m not in exclude:
                return m
        return None

    def share(self) -> dict:
        """``member -> owned fraction of the hash space`` (sums to 1.0)
        — ``ClusterStats.ring_share``, and the observable the straggler
        bias moves."""
        if not self._points:
            return {}
        out = {m: 0.0 for m in self._weights}
        pts, owners = self._points, self._owners
        for i, p in enumerate(pts):
            prev = pts[i - 1] if i else pts[-1] - _SPACE
            out[owners[i]] += (p - prev) / _SPACE
        return out
