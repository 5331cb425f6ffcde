"""Deadline-aware QoS tick scheduler: who rides the next tick.

Copy of ``repro.serving.scheduler``: pure Python, kept as the port's own
copy so that the port never imports the reference package.

The scheduler turns the three class queues into one tick batch in two
deterministic phases that mirror the runtime's cross-tick pipeline
(``serving/server.py``):

1. ``stage(queues, now)`` — while the PREVIOUS tick's device chains are
   still in flight, reserve up to ``max_batch`` frames: first the
   **aging lane** (frames waiting past their class ``max_wait_ms``,
   oldest arrival first, capped at ``promote_quota`` of the batch),
   then strict class priority (``INTERACTIVE`` → ``STANDARD`` →
   ``BULK``).  Within ``STANDARD`` the fill is **per-session deficit
   round-robin** (weighted by ``QueuedFrame.weight``), so one chatty
   tenant cannot monopolize the class's slots; ``INTERACTIVE`` and
   ``BULK`` stay FIFO == EDF (one deadline budget per class).
2. ``admit(queues, now)`` — immediately before launch, finalize the
   batch: first the **shed pass** (frames whose deadline expired more
   than ``shed_horizon_ms`` ago are dropped *visibly* — counted as
   sheds AND as the deadline misses they already were), then backfill
   free slots, then the **preemption pass** — while an
   ``INTERACTIVE``/``STANDARD`` frame is still waiting and the staged
   batch holds a non-promoted ``BULK`` frame, the newest-staged such
   frame is bumped back to the FRONT of its queue (original deadline
   intact, bump counted) and the waiting frame takes its slot.
   Promoted frames are preemption-immune — aging would be a no-op if
   its beneficiaries could immediately be bumped again.  Preempted
   frames re-queue; they are never dropped.

**The starvation bound.**  Under ANY sustained higher-class load, a
BULK frame's queue wait is bounded: once it has waited ``max_wait_ms``
it joins the aging lane, which drains oldest-first at
``>= max(1, promote_quota * max_batch)`` frames per tick, and the lane's
backlog is capped by the bounded queues — so

    wait  <=  max_wait_ms  +  ceil(queue_maxlen / promote_slots) ticks

(``promote_slots = max(1, int(promote_quota * max_batch))``).  The
quota is what keeps aging from inverting the starvation: promoted
frames can take at most that share of a batch, so fresh INTERACTIVE
traffic keeps the rest.  With shedding enabled the bound tightens
further — no admitted frame can be older than
``deadline_ms + shed_horizon_ms`` plus one stage→admit window, because
the shed pass runs before every fill.  Both bounds are pinned by
fake-clock tests and the sustained-overload benchmark lane.

Everything here is pure host-side Python and clock-injected: decisions
are a function of (queue contents, ``now``) only, so every policy
property — priority order, per-session EDF, aging bound, preempted-frame
conservation, shed reproducibility — is pinned by deterministic
fake-clock tests (``tests/test_serving.py``).

Wait/deadline accounting happens once per frame, at admission (or at
shed, for frames that starved in queue past the horizon): the queue
wait is ``now - enq_s`` and a deadline miss is ``now > deadline_s`` —
both against the caller's injected clock, and all counter mutation
happens inside ``queues.cond`` so a ``stats()`` snapshot is atomic.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.api.types import QoSClass
from repro_torch.obs import MetricsRegistry
from repro_torch.serving.queues import QoSQueues, QueuedFrame

# Default per-class deadline budgets (ms between submit and tick
# admission).  The INTERACTIVE budget is the paper's ~2 mel-frame
# interactivity envelope.  BULK is best-effort but NOT starvable: a
# frame waiting past its class MAX_WAIT_MS joins the aging lane and its
# wait is provably bounded (see the module docstring).
DEADLINE_MS = {
    QoSClass.INTERACTIVE: 50.0,
    QoSClass.STANDARD: 250.0,
    QoSClass.BULK: 2000.0,
}

# Default per-class aging thresholds (ms of queue wait after which a
# frame is promoted into the aging lane).  ``None`` disables aging for
# the class — INTERACTIVE is already the top priority, so promoting it
# could only reorder it against other promoted frames.
MAX_WAIT_MS = {
    QoSClass.INTERACTIVE: None,
    QoSClass.STANDARD: 2000.0,
    QoSClass.BULK: 4000.0,
}

# Admission order == preemption precedence (first is most privileged).
PRIORITY = (QoSClass.INTERACTIVE, QoSClass.STANDARD, QoSClass.BULK)

# DRR weights are clamped into this range: a zero/negative weight would
# stall the deficit loop, an enormous one would let a single quantum
# round drain the whole batch.
_WEIGHT_MIN, _WEIGHT_MAX = 0.05, 20.0


def clamp_weight(w: float) -> float:
    return float(min(max(w, _WEIGHT_MIN), _WEIGHT_MAX))


@dataclass(frozen=True)
class SchedulerCfg:
    """Tick-composition policy knobs (all deterministic).

    ``deadline_ms`` and ``max_wait_ms`` accept PARTIAL overrides: user
    dicts are merged over the module defaults in ``__post_init__``, so
    ``SchedulerCfg(deadline_ms={QoSClass.BULK: 5000.0})`` keeps the
    other classes' budgets instead of KeyError'ing on their first
    submit.
    """

    max_batch: int = 64                  # frames per tick (dispatch width)
    deadline_ms: dict = field(default_factory=dict)
    preempt_bulk: bool = True            # bump staged BULK for INT/STD
    # aging lane: per-class queue-wait threshold (ms; None = no aging)
    max_wait_ms: dict = field(default_factory=dict)
    # max share of a batch the aging lane may take (always >= 1 slot
    # when any aged frame waits — the starvation bound needs progress)
    promote_quota: float = 0.5
    # shed horizon: a waiting frame whose deadline expired more than
    # this many ms ago is dropped visibly (None = never shed — the
    # bounded queues' backpressure is then the only overload valve)
    shed_horizon_ms: float | None = None
    # DRR quantum (frames per round per unit weight) of the STANDARD
    # per-session fair fill
    drr_quantum: float = 1.0

    def __post_init__(self):
        # frozen dataclass: merge partial user overrides over the
        # defaults via object.__setattr__ (the dicts stay per-instance)
        object.__setattr__(
            self, "deadline_ms", {**DEADLINE_MS, **self.deadline_ms})
        object.__setattr__(
            self, "max_wait_ms", {**MAX_WAIT_MS, **self.max_wait_ms})
        if not 0.0 < self.promote_quota <= 1.0:
            raise ValueError("promote_quota must be in (0, 1]")
        if self.drr_quantum <= 0.0:
            raise ValueError("drr_quantum must be > 0")

    def deadline_s(self, qos: QoSClass) -> float:
        return self.deadline_ms[qos] * 1e-3

    def max_wait_s(self, qos: QoSClass) -> float | None:
        ms = self.max_wait_ms[qos]
        return None if ms is None else ms * 1e-3

    @property
    def promote_slots(self) -> int:
        """Aging-lane batch share: ``max(1, promote_quota*max_batch)``
        — at least one slot, or aged frames could never drain and the
        starvation bound would not exist."""
        return max(1, int(self.promote_quota * self.max_batch))

    @property
    def shed_horizon_s(self) -> float | None:
        return (None if self.shed_horizon_ms is None
                else self.shed_horizon_ms * 1e-3)


class TickScheduler:
    """Composes each tick's batch by class priority with an aging lane,
    per-session STANDARD fair sharing, deadline accounting, load
    shedding and BULK preemption.  Owns the staged (reserved) frames
    and the admission-side counters; the queues own the
    submit/reject/requeue/shed-count side.  Call pattern (serving
    thread only, with ``queues.cond`` NOT held — the scheduler takes
    it):

        sched.stage(queues, now)    # under the in-flight tick
        ...previous tick syncs; more frames arrive...
        batch = sched.admit(queues, now)   # shed + backfill + preemption
        dropped = sched.pop_shed()         # frames the shed pass removed
    """

    def __init__(self, cfg: SchedulerCfg | None = None, *,
                 registry: MetricsRegistry | None = None,
                 recorder=None):
        # cfg defaults to None, not a shared module-level SchedulerCfg:
        # the frozen dataclass holds mutable dicts, and a shared default
        # instance would leak mutations across servers
        self.cfg = cfg if cfg is not None else SchedulerCfg()
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        self.recorder = recorder    # FlightRecorder or None: anomaly
        #                             events (miss/shed/preempt) land
        #                             there with full decision context
        self.staged: list[QueuedFrame] = []
        # admission-side counters in the shared registry; the dict-of-
        # ints surface the tests and StreamStats read is the properties
        # below (plain snapshots over these live counters)
        self._admitted = {q.value: self.registry.counter(
            "stream_admitted", qos=q.value) for q in QoSClass}
        self._deadline_misses = {q.value: self.registry.counter(
            "stream_deadline_misses", qos=q.value) for q in QoSClass}
        self._promoted = {q.value: self.registry.counter(
            "stream_promoted", qos=q.value) for q in QoSClass}
        # bounded streaming quantile sketches -> p50/p95 queue wait per
        # class (repro_torch.obs: exact == numpy.percentile below exact_cap,
        # log-binned and O(1)-memory beyond — the old deque rings grew
        # no further but FORGOT, this forgets nothing and stays bounded)
        self.wait_hist = {q.value: self.registry.histogram(
            "stream_queue_wait_ms", qos=q.value) for q in QoSClass}
        # STANDARD fair-share state: per-session deficit counters plus
        # the tenant the ring last served (service resumes after it)
        self._drr_deficit: dict = {}
        self._drr_last = None
        self._drr_mid_turn = False   # last fill hit the batch limit
        #                              mid-turn: that tenant resumes
        #                              first, without a fresh quantum
        # frames the most recent admit's shed pass dropped, until the
        # server collects them (replaced — never grows — each admit)
        self._last_shed: list[QueuedFrame] = []

    # admission counters as the plain {class: int} dicts they always
    # were — snapshots over the registry counters, so exporters and the
    # legacy readers see the same numbers
    @property
    def admitted(self) -> dict:
        return {c: m.value for c, m in self._admitted.items()}

    @property
    def deadline_misses(self) -> dict:
        return {c: m.value for c, m in self._deadline_misses.items()}

    @property
    def promoted(self) -> dict:
        return {c: m.value for c, m in self._promoted.items()}

    # -- phase 1: reserve under the in-flight tick ---------------------------
    def stage(self, queues: QoSQueues, now: float | None = None) -> int:
        """Reserve frames up to ``max_batch``; returns how many are
        staged in total.  ``now`` feeds the aging lane (``None`` skips
        it — promotion then happens at ``admit``, which always has the
        clock); wait/deadline accounting still only happens at
        ``admit``."""
        with queues.cond:
            return self._fill_locked(queues, now)

    def _fill_locked(self, queues, now) -> int:
        if now is not None:
            self._promote_locked(queues, now)
        n0 = len(self.staged)
        for qos in PRIORITY:
            if len(self.staged) >= self.cfg.max_batch:
                break
            if qos is QoSClass.STANDARD:
                self._fill_standard_drr_locked(queues)
            else:
                while len(self.staged) < self.cfg.max_batch:
                    qf = queues.pop_locked(qos)
                    if qf is None:
                        break
                    self.staged.append(qf)
        if now is not None:
            for qf in self.staged[n0:]:
                if qf.trace is not None:
                    qf.trace.add("stage", now)
        return len(self.staged)

    def _promote_locked(self, queues, now) -> None:
        """The aging lane: stage frames waiting past their class
        ``max_wait_ms``, oldest arrival first across classes, up to
        ``promote_slots`` promoted frames in the batch.  Each class
        queue's front is its oldest frame (queue invariant), so peeking
        the three fronts finds the globally oldest aged frame."""
        quota = self.cfg.promote_slots
        n_promoted = sum(1 for f in self.staged if f.promoted)
        while (len(self.staged) < self.cfg.max_batch
               and n_promoted < quota):
            oldest, oldest_qos = None, None
            for qos in PRIORITY:
                mw = self.cfg.max_wait_s(qos)
                if mw is None:
                    continue
                qf = queues.peek_locked(qos)
                if qf is None or (now - qf.enq_s) < mw:
                    continue
                if oldest is None or qf.seq < oldest.seq:
                    oldest, oldest_qos = qf, qos
            if oldest is None:
                return
            qf = queues.pop_locked(oldest_qos)
            qf.promoted = True
            self._promoted[qf.qos.value].inc()
            if qf.trace is not None:
                qf.trace.add("promote", now,
                             waited_ms=(now - qf.enq_s) * 1e3)
            self.staged.append(qf)
            n_promoted += 1

    def _fill_standard_drr_locked(self, queues) -> None:
        """Weighted deficit round-robin across STANDARD tenants: every
        tenant with waiting frames earns ``drr_quantum * weight``
        deficit per round and spends 1 per staged frame, so over any
        backlogged interval tenants are served proportionally to their
        weights — a chatty session cannot monopolize the class.  Within
        a tenant the order stays FIFO == EDF."""
        S = QoSClass.STANDARD
        cfg = self.cfg
        while len(self.staged) < cfg.max_batch:
            ring = queues.sids_locked(S)
            if not ring:
                return
            live = set(ring)
            # classic DRR: a tenant that drained its queue resets
            self._drr_deficit = {s: d for s, d in
                                 self._drr_deficit.items() if s in live}
            if self._drr_last in live:
                i = ring.index(self._drr_last)
                if self._drr_mid_turn:
                    # last fill ran out of batch slots MID-turn: that
                    # tenant resumes first and spends its remaining
                    # deficit before anyone earns a fresh quantum —
                    # otherwise rotation re-serves the whole ring ahead
                    # of it every pass and weights collapse to 1:1
                    ring = ring[i:] + ring[:i]
                else:
                    ring = ring[i + 1:] + ring[:i + 1]
            else:
                self._drr_mid_turn = False
            progressed = False
            for sid in ring:
                if len(self.staged) >= cfg.max_batch:
                    return
                head = queues.peek_sid_locked(S, sid)
                if head is None:        # drained earlier this round
                    continue
                if not (self._drr_mid_turn and sid == self._drr_last):
                    self._drr_deficit[sid] = (
                        self._drr_deficit.get(sid, 0.0)
                        + cfg.drr_quantum * clamp_weight(head.weight))
                self._drr_mid_turn = False
                while self._drr_deficit[sid] >= 1.0:
                    if len(self.staged) >= cfg.max_batch:
                        self._drr_last = sid
                        self._drr_mid_turn = True     # turn not finished
                        return
                    qf = queues.pop_sid_locked(S, sid)
                    if qf is None:
                        self._drr_deficit[sid] = 0.0
                        break
                    self._drr_deficit[sid] -= 1.0
                    self.staged.append(qf)
                    self._drr_last = sid
                    progressed = True
            if not progressed and len(self.staged) >= cfg.max_batch:
                return

    # -- phase 2: finalize at launch -----------------------------------------
    def admit(self, queues: QoSQueues, now: float) -> list[QueuedFrame]:
        """Shed pass + backfill + preemption pass + wait/deadline
        accounting; clears and returns the staged batch (admission
        order: class priority, FIFO within).  ALL counter mutation —
        sheds, admissions, wait samples, misses — happens inside
        ``queues.cond``, so a concurrent ``stats()`` snapshot (which
        reads under the same lock) is actually atomic."""
        with queues.cond:
            self._shed_locked(queues, now)
            self._fill_locked(queues, now)
            if self.cfg.preempt_bulk:
                self._preempt_locked(queues, now)
            batch = sorted(self.staged,
                           key=lambda f: (PRIORITY.index(f.qos), f.seq))
            self.staged = []
            for qf in batch:
                cls = qf.qos.value
                self._admitted[cls].inc()
                wait_ms = (now - qf.enq_s) * 1e3
                self.wait_hist[cls].observe(wait_ms)
                missed = now > qf.deadline_s
                if missed:
                    self._deadline_misses[cls].inc()
                    if self.recorder is not None:
                        self.recorder.record(
                            "deadline_miss", now, sid=qf.sid,
                            t=qf.frame.t, qos=cls,
                            late_ms=(now - qf.deadline_s) * 1e3)
                if qf.trace is not None:
                    qf.trace.add("admit", now, wait_ms=wait_ms,
                                 missed=missed)
            return batch

    def _shed_locked(self, queues, now) -> None:
        """Real load-shedding: drop every waiting frame whose deadline
        expired more than ``shed_horizon_ms`` ago.  Each shed frame is
        counted as the deadline miss it already was (starved-in-queue
        misses were previously invisible until — if ever — admission)
        and its terminal wait is sampled, so overload shows up in the
        same percentiles the healthy path reports."""
        horizon = self.cfg.shed_horizon_s
        if horizon is None:
            self._last_shed = []
            return
        shed: list[QueuedFrame] = []
        for qos in PRIORITY:
            shed.extend(queues.shed_expired_locked(qos, now, horizon))
        for qf in shed:
            cls = qf.qos.value
            self._deadline_misses[cls].inc()
            wait_ms = (now - qf.enq_s) * 1e3
            self.wait_hist[cls].observe(wait_ms)
            if self.recorder is not None:
                self.recorder.record(
                    "shed", now, sid=qf.sid, t=qf.frame.t, qos=cls,
                    waited_ms=wait_ms,
                    expired_ms=(now - qf.deadline_s) * 1e3)
            if qf.trace is not None:
                qf.trace.add("shed", now, waited_ms=wait_ms)
        self._last_shed = shed

    def pop_shed(self) -> list[QueuedFrame]:
        """Frames the most recent ``admit`` shed (consumed: a second
        call returns [] until the next admit).  The server folds these
        into per-session accounting so closes still drain."""
        out, self._last_shed = self._last_shed, []
        return out

    def _preempt_locked(self, queues, now=None) -> None:
        """While a higher-class frame waits and the staged batch holds
        preemptible BULK frames, bump the newest-staged one (LIFO —
        least committed) back to the front of its queue and stage the
        waiting frame in its place.  Promoted frames are immune: the
        aging lane's grant must stick, or sustained INTERACTIVE load
        would re-starve BULK one preemption at a time."""
        for qos in (QoSClass.INTERACTIVE, QoSClass.STANDARD):
            while queues.depth_locked(qos):
                bulk_at = max(
                    (i for i, f in enumerate(self.staged)
                     if f.qos is QoSClass.BULK and not f.promoted),
                    default=None,
                    key=lambda i: self.staged[i].seq)
                if bulk_at is None:
                    return
                bumped = self.staged.pop(bulk_at)
                if now is not None:
                    if bumped.trace is not None:
                        bumped.trace.add("preempt", now, by=qos.value)
                    if self.recorder is not None:
                        self.recorder.record(
                            "preempt", now, sid=bumped.sid,
                            t=bumped.frame.t, qos=bumped.qos.value,
                            by=qos.value,
                            preemptions=bumped.preemptions + 1)
                queues.requeue_front_locked(bumped)
                taken = queues.pop_locked(qos)
                if now is not None and taken.trace is not None:
                    taken.trace.add("stage", now, via="preemption")
                self.staged.append(taken)

    # -- live migration ------------------------------------------------------
    def extract_session_locked(self, sid) -> list[QueuedFrame]:
        """Remove and return the session's staged (reserved-but-
        unlaunched) frames — the migration path.  Caller holds
        ``queues.cond`` and moves the frames' submit ledger with them
        (``queues.uncount_locked``); admission counters are untouched
        because these frames were never admitted."""
        out = [qf for qf in self.staged if qf.sid == sid]
        if out:
            self.staged = [qf for qf in self.staged if qf.sid != sid]
        return out

    # -- observability -------------------------------------------------------
    def staged_depths(self) -> dict:
        """Staged (reserved-but-unlaunched) frames per class — counted
        into ``StreamStats.queue_depth`` so conservation holds at every
        snapshot."""
        out = {q.value: 0 for q in QoSClass}
        for qf in self.staged:
            out[qf.qos.value] += 1
        return out

    def wait_percentiles(self) -> dict:
        """{class: {"p50","p95","mean","max"}} over the wait sketches
        (empty classes report zeros).  Exact ``numpy.percentile``
        values while a class has seen <= the sketch's ``exact_cap``
        samples; bounded-error log-bin estimates beyond — ``mean`` and
        ``max`` are exact always."""
        return {cls: h.summary() for cls, h in self.wait_hist.items()}
