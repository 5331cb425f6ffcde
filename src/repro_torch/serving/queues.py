"""Bounded per-QoS-class ingest queues of the streaming runtime.

Copy of ``repro.serving.queues``: pure Python, kept as the port's own
copy so that the port never imports the reference package.

Clients (any thread) ``submit`` frames into one of three bounded FIFO
queues — ``INTERACTIVE`` / ``STANDARD`` / ``BULK`` — and the serving
thread drains them tick by tick through the ``TickScheduler``
(``serving/scheduler.py``).  Design rules:

- **Bounded, never silently lossy.**  A full class queue refuses the
  frame with the typed ``QueueFullError`` (backpressure to the caller)
  and counts the refusal; an accepted frame can only leave the system
  as a served ``FrameResult`` or as a *visible* shed
  (``shed_expired_locked`` — deadline long expired, dropped and
  counted, see the scheduler's shed pass).  Preempted frames re-enter
  at the FRONT of their queue with their original deadline.
- **Deterministic.**  No internal clock: every timestamp
  (``QueuedFrame.enq_s`` / ``deadline_s``) comes from the caller, so a
  fake clock reproduces every queue-wait, deadline and shed decision
  exactly (``tests/test_serving.py``).
- **One lock for all three queues.**  ``QoSQueues.cond`` is a single
  condition variable shared by every class, so the serving thread can
  sleep on "any frame arrived" and ``submit`` wakes it with one notify.
"""
from __future__ import annotations

import threading
from collections import deque
from dataclasses import dataclass

from repro_torch.api.types import FrameRequest, QoSClass
from repro_torch.obs import MetricsRegistry


class QueueFullError(RuntimeError):
    """Typed backpressure signal of ``QoSQueues.submit``: the class
    queue is at capacity.  The frame was NOT enqueued — the caller owns
    the retry/shed decision, and the refusal is counted
    (``StreamStats.rejected_full``), never silent."""

    def __init__(self, qos: QoSClass, depth: int, maxlen: int):
        self.qos = qos
        self.depth = depth
        self.maxlen = maxlen
        super().__init__(
            f"{qos.value} queue full: {depth}/{maxlen} frames waiting")


class RateLimitError(RuntimeError):
    """Typed admission-control signal of ``StreamServer.submit``: the
    session's token bucket is empty.  The frame was NOT enqueued — the
    refusal is counted (``StreamStats.rejected_rate_limited``), never
    silent, and ``retry_after_s`` tells the caller when one token will
    have refilled (exact under the injected clock)."""

    def __init__(self, sid: int, qos: QoSClass, retry_after_s: float):
        self.sid = sid
        self.qos = qos
        self.retry_after_s = retry_after_s
        super().__init__(
            f"session {sid} ({qos.value}) rate-limited: next token in "
            f"{retry_after_s:.3f}s")


@dataclass
class TokenBucket:
    """Deterministic token bucket: ``rate_per_s`` tokens/s up to
    ``burst``.  No internal clock — every ``try_take(now)`` refills from
    the caller's timestamp, so admission-control decisions are exact
    under a fake clock.  Not thread-safe on its own; the owner
    (``StreamServer``) serializes access."""

    rate_per_s: float
    burst: float
    now: float = 0.0           # clock at construction (refill anchor)

    def __post_init__(self):
        if self.rate_per_s <= 0 or self.burst < 1:
            raise ValueError("token bucket needs rate_per_s > 0 and "
                             "burst >= 1")
        self.tokens = float(self.burst)
        self._last = float(self.now)

    def _refill(self, now: float) -> None:
        if now > self._last:
            self.tokens = min(float(self.burst),
                              self.tokens + (now - self._last)
                              * self.rate_per_s)
        self._last = max(self._last, now)

    def try_take(self, now: float) -> bool:
        """Consume one token if available; never blocks."""
        self._refill(now)
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return True
        return False

    def give_back(self) -> None:
        """Refund the token of a frame the queue then refused — a
        rejected frame must not also burn rate budget."""
        self.tokens = min(float(self.burst), self.tokens + 1.0)

    def retry_after_s(self, now: float) -> float:
        """Seconds until one full token exists (0 if one does now)."""
        self._refill(now)
        if self.tokens >= 1.0:
            return 0.0
        return (1.0 - self.tokens) / self.rate_per_s


@dataclass
class QueuedFrame:
    """One frame waiting for (or staged toward) admission into a tick."""

    sid: int
    frame: FrameRequest
    qos: QoSClass
    seq: int                   # global arrival number (FIFO tiebreak)
    enq_s: float               # caller clock at submit
    deadline_s: float          # enq_s + the class deadline budget
    preemptions: int = 0       # times bumped out of a staged tick
    weight: float = 1.0        # fair-share weight of the session (DRR)
    promoted: bool = False     # staged via the aging lane (max_wait_ms)
    trace: object = None       # FrameTrace when this frame is sampled
    #                            (repro_torch.obs.trace; None on the hot path)


class ClassQueue:
    """One bounded FIFO plus its conservation counters.  Never locked on
    its own — the owning ``QoSQueues`` serializes every access.

    The counters live in the shared ``MetricsRegistry``
    (``stream_frames_submitted{class=...}`` etc.) so exporters and the
    ``StreamStats`` view read the very objects this queue mutates; the
    attribute names (``cq.submitted += 1``) are properties over those
    registry counters, preserved because migration bookkeeping and the
    scheduler write through them under ``QoSQueues.cond``."""

    __slots__ = ("qos", "maxlen", "q", "_submitted", "_rejected",
                 "_preempted", "_requeued", "_shed_expired")

    def __init__(self, qos: QoSClass, maxlen: int,
                 registry: MetricsRegistry):
        self.qos = qos
        self.maxlen = maxlen
        self.q: deque = deque()
        c = qos.value
        # frames accepted (rejections excluded); decremented when a
        # migration relocates the ledger to another member
        self._submitted = registry.counter(
            "stream_frames_submitted", qos=c)
        # QueueFullError refusals
        self._rejected = registry.counter("stream_rejected_full", qos=c)
        # frames bumped from a staged tick ... and put back (==)
        self._preempted = registry.counter("stream_preempted", qos=c)
        self._requeued = registry.counter("stream_requeued", qos=c)
        # frames dropped with deadline long past
        self._shed_expired = registry.counter("stream_shed_expired",
                                              qos=c)

    @property
    def submitted(self) -> int:
        return self._submitted.value

    @submitted.setter
    def submitted(self, v: int) -> None:
        self._submitted.value = v

    @property
    def rejected(self) -> int:
        return self._rejected.value

    @rejected.setter
    def rejected(self, v: int) -> None:
        self._rejected.value = v

    @property
    def preempted(self) -> int:
        return self._preempted.value

    @preempted.setter
    def preempted(self, v: int) -> None:
        self._preempted.value = v

    @property
    def requeued(self) -> int:
        return self._requeued.value

    @requeued.setter
    def requeued(self, v: int) -> None:
        self._requeued.value = v

    @property
    def shed_expired(self) -> int:
        return self._shed_expired.value

    @shed_expired.setter
    def shed_expired(self, v: int) -> None:
        self._shed_expired.value = v


class QoSQueues:
    """The three bounded class queues behind one condition variable.

    ``maxlen`` bounds each class queue (override per class with
    ``maxlens={QoSClass.BULK: 512, ...}``).  All mutation goes through
    methods that take ``self.cond``; ``cond`` is also the sleep/wake
    channel between client threads and the serving thread.

    Removal order invariant: frames enqueue in nondecreasing ``enq_s``
    (and, per class, nondecreasing ``deadline_s`` — one budget per
    class), preempted frames re-enter at the FRONT with their original
    deadline, and mid-queue removals (``pop_sid_locked``) preserve
    relative order — so the front of each class queue is always its
    oldest frame AND its earliest deadline.  The scheduler's shed and
    aging passes both lean on this.
    """

    def __init__(self, *, maxlen: int = 256, maxlens=None,
                 registry: MetricsRegistry | None = None):
        self.cond = threading.Condition()
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        over = maxlens or {}
        self.by_class = {q: ClassQueue(q, int(over.get(q, maxlen)),
                                       self.registry)
                         for q in QoSClass}
        self._seq = 0

    # -- producer side (any thread) ------------------------------------------
    def submit(self, sid, frame: FrameRequest, qos: QoSClass, *, now: float,
               deadline_s: float, weight: float = 1.0,
               trace=None) -> QueuedFrame:
        """Enqueue one frame; raises ``QueueFullError`` at capacity."""
        with self.cond:
            cq = self.by_class[qos]
            if len(cq.q) >= cq.maxlen:
                cq.rejected += 1
                raise QueueFullError(qos, len(cq.q), cq.maxlen)
            qf = QueuedFrame(sid=sid, frame=frame, qos=qos, seq=self._seq,
                             enq_s=now, deadline_s=deadline_s,
                             weight=weight, trace=trace)
            self._seq += 1
            if trace is not None:
                trace.add("enqueue", now, qos=qos.value,
                          depth=len(cq.q))
            cq.q.append(qf)
            cq.submitted += 1
            self.cond.notify_all()
            return qf

    # -- consumer side (serving thread; caller holds ``cond``) ---------------
    def pop_locked(self, qos: QoSClass) -> QueuedFrame | None:
        """Oldest waiting frame of the class (FIFO == EDF: every frame
        of a class carries the same deadline budget), or None."""
        cq = self.by_class[qos].q
        return cq.popleft() if cq else None

    def peek_locked(self, qos: QoSClass) -> QueuedFrame | None:
        """The class's oldest waiting frame without removing it."""
        cq = self.by_class[qos].q
        return cq[0] if cq else None

    def sids_locked(self, qos: QoSClass) -> list:
        """Sessions with waiting frames of the class, ordered by their
        oldest frame (the DRR ring order of the scheduler's STANDARD
        fill)."""
        seen, out = set(), []
        for qf in self.by_class[qos].q:
            if qf.sid not in seen:
                seen.add(qf.sid)
                out.append(qf.sid)
        return out

    def peek_sid_locked(self, qos: QoSClass, sid) -> QueuedFrame | None:
        """The session's oldest waiting frame of the class, in place."""
        for qf in self.by_class[qos].q:
            if qf.sid == sid:
                return qf
        return None

    def pop_sid_locked(self, qos: QoSClass, sid) -> QueuedFrame | None:
        """Remove and return the session's oldest waiting frame of the
        class (relative order of the remaining frames is preserved)."""
        cq = self.by_class[qos].q
        for i, qf in enumerate(cq):
            if qf.sid == sid:
                del cq[i]
                return qf
        return None

    # -- live migration ------------------------------------------------------
    def extract_session_locked(self, qos: QoSClass, sid) -> list:
        """Remove and return EVERY waiting frame of the session (oldest
        first, relative order preserved) — the migration move.  The
        frames' ledger leaves with them: ``submitted`` is decremented,
        because migration relocates accounting, it neither serves nor
        sheds (the target's ``implant_frames_locked`` re-counts them, so
        per-member conservation holds on both sides)."""
        cq = self.by_class[qos]
        out = [qf for qf in cq.q if qf.sid == sid]
        if out:
            cq.q = deque(qf for qf in cq.q if qf.sid != sid)
            cq.submitted -= len(out)
        return out

    def uncount_locked(self, qos: QoSClass, n: int) -> None:
        """Move ``n`` frames' submit ledger out of this queue set — for
        frames extracted from the scheduler's STAGED list during a
        migration (they were counted here at submit but no longer sit in
        the deque)."""
        self.by_class[qos].submitted -= n

    def implant_frames_locked(self, sid, snaps, qos: QoSClass) -> list:
        """Re-enqueue migrated frames with their ORIGINAL arrival times
        and deadlines (``QueuedFrameSnapshot``s, oldest first).  Each
        frame is inserted at its ``enq_s``-sorted position so the
        front==oldest==earliest-deadline invariant survives a merge with
        frames the target already holds, and gets a ``seq`` strictly
        between its new neighbours' (fractional when squeezed between
        two live frames) so every seq comparison — aging-lane oldest
        pick, batch sort, preemption LIFO — agrees with queue order.
        Exempt from the ``maxlen`` bound, like ``requeue_front_locked``:
        the frames already held queue slots at the source.  Counted into
        ``submitted`` (the ledger arrives with the frames)."""
        cq = self.by_class[qos]
        out = []
        for snap in snaps:
            q = cq.q
            i = len(q)
            while i > 0 and q[i - 1].enq_s > snap.enq_s:
                i -= 1
            if i == len(q):
                seq = self._seq
                self._seq += 1
            else:
                prev_seq = q[i - 1].seq if i else q[i].seq - 2.0
                seq = (prev_seq + q[i].seq) / 2.0
            qf = QueuedFrame(sid=sid, frame=snap.frame, qos=qos, seq=seq,
                             enq_s=snap.enq_s, deadline_s=snap.deadline_s,
                             preemptions=snap.preemptions,
                             weight=snap.weight, promoted=snap.promoted,
                             trace=getattr(snap, "trace", None))
            q.insert(i, qf)
            cq.submitted += 1
            out.append(qf)
        if out:
            self.cond.notify_all()
        return out

    def shed_expired_locked(self, qos: QoSClass, now: float,
                            horizon_s: float) -> list:
        """Drop (and count) every waiting frame of the class whose
        deadline expired more than ``horizon_s`` ago.  The front of the
        queue is always the earliest deadline (class invariant), so the
        sweep stops at the first survivor.  Returns the shed frames —
        the caller owns miss accounting and per-session bookkeeping;
        the drop itself is counted here (``shed_expired``) so the
        conservation snapshot (depth + shed counter, both under
        ``cond``) is atomic."""
        cq = self.by_class[qos]
        out = []
        while cq.q and now > cq.q[0].deadline_s + horizon_s:
            out.append(cq.q.popleft())
            cq.shed_expired += 1
        return out

    def requeue_front_locked(self, qf: QueuedFrame) -> None:
        """Return a preempted frame to the FRONT of its class queue with
        its original enqueue time and deadline — conservation: the
        preemption is counted, the frame is never dropped.  Re-entry is
        exempt from the maxlen bound (the frame already held a slot)."""
        cq = self.by_class[qf.qos]
        qf.preemptions += 1
        cq.q.appendleft(qf)
        cq.preempted += 1
        cq.requeued += 1

    def depth_locked(self, qos: QoSClass) -> int:
        return len(self.by_class[qos].q)

    def pending_locked(self) -> int:
        return sum(len(c.q) for c in self.by_class.values())

    # -- observability -------------------------------------------------------
    def depths(self) -> dict:
        with self.cond:
            return {q.value: len(c.q) for q, c in self.by_class.items()}

    def counters(self) -> dict:
        """{"submitted"/"rejected"/"preempted"/"requeued"/"shed_expired":
        {class: count}} — one consistent snapshot."""
        with self.cond:
            return {name: {q.value: getattr(c, name)
                           for q, c in self.by_class.items()}
                    for name in ("submitted", "rejected", "preempted",
                                 "requeued", "shed_expired")}
