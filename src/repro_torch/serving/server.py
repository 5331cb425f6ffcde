"""``StreamServer`` — the always-on streaming runtime over the gateway.

Port of ``repro.serving.server``.  Clients talk to a server that owns:

- a **background serving thread** draining bounded per-QoS-class ingest
  queues (``serving/queues.py``) — clients ``submit`` from any thread
  and get backpressure (``QueueFullError``), never silent loss;
- the **deadline-aware ``TickScheduler``** (``serving/scheduler.py``)
  composing each tick by class priority, with BULK preemption under
  load and per-class wait/deadline accounting;
- **cross-tick pipelining** over the gateway's ``tick_launch`` /
  ``tick_collect`` seam: tick t+1 is staged H2D and its bucket chains
  launched while tick t's chains are still in flight, so the dispatch
  plane never idles between ticks and ``device_syncs_per_tick`` stays 1
  (double-buffered: at most one collected-pending tick at a time).  On
  the card this overlap is real because ``tick_launch`` issues tick t's
  one device→host copy and records an event behind it, and
  ``tick_collect`` waits on that event alone — not on t+1's chains,
  which are queued on the same stream after it.

Determinism is load-bearing: the serving thread only ever runs
``step()``, which is also public — tests drive it synchronously with a
fake clock and get byte-for-byte reproducible schedules, and replaying a
recorded schedule through a plain sequential gateway gives
**bit-identical** embeddings (``tests/test_torch_serving.py``, and
``chip_smoke.py`` on the card at full width).

The serving thread runs on the gateway's device and on the CUDA stream
that was current on that device when the server was built, so a thread
that builds the server on a side stream keeps its chains there.

One serving-order caveat, by design: when a fleet refine round is due,
the server drains its pipeline first (collects tick t before launching
t+1), so refinement sees exactly the frames a sequential gateway would
have ingested by that tick — pipelining never reorders learning.
"""
from __future__ import annotations

import contextlib
import threading
from collections import deque
from dataclasses import replace

import torch

from repro_torch.api.types import (FrameRequest, QoSClass,
                                   QueuedFrameSnapshot, ResourceSignals,
                                   ServerSessionSnapshot, SessionInfo,
                                   SessionSnapshot, StreamStats)
from repro_torch.obs import FlightRecorder, Tracer, to_prometheus
from repro_torch.serving.queues import (QoSQueues,  # noqa: F401
                                        QueuedFrame, QueueFullError,
                                        RateLimitError, TokenBucket)
from repro_torch.serving.scheduler import (SchedulerCfg, TickScheduler,
                                           clamp_weight)

_UNSET = object()          # open_session(rate_limit=...) sentinel


class _ServedSession:
    """Server-side session record (the gateway keeps its own)."""

    __slots__ = ("sid", "qos", "submitted", "served", "shed", "weight",
                 "bucket", "closing", "closed")

    def __init__(self, sid, qos, *, weight=1.0, bucket=None):
        self.sid = sid
        self.qos = qos
        self.submitted = 0       # frames accepted into the queues
        self.served = 0          # frames delivered as FrameResults
        self.shed = 0            # frames visibly dropped past the horizon
        self.weight = weight     # STANDARD fair-share weight (DRR)
        self.bucket = bucket     # per-session TokenBucket (or None)
        self.closing = False     # no new submits; drain then evict
        self.closed = threading.Event()


class StreamServer:
    """Always-on serving runtime over a ``StreamSplitGateway``.

    Parameters
    ----------
    gateway : a ``StreamSplitGateway`` built with ``overlap=True`` (the
        phased tick is the pipelining seam).  The server owns the
        gateway once serving starts: all ``submit``/``tick`` traffic
        must flow through the server.
    cfg : ``SchedulerCfg`` — tick width, per-class deadline budgets,
        BULK preemption.
    queue_maxlen / queue_maxlens : bounded ingest queue capacity
        (per-class override via ``queue_maxlens``).
    pipeline : ``False`` degrades to launch+collect back-to-back (no
        cross-tick overlap) — the measured baseline knob.
    on_result : optional callable invoked with each ``FrameResult`` on
        the serving thread (keep it cheap).  With a callback installed
        results are NOT also buffered — an always-on server must not
        grow with uptime; without one they accumulate until
        ``drain_results()``, which the caller is expected to poll.
    on_shed : optional callable invoked with each shed ``QueuedFrame``
        on the serving thread, right after the shed pass folds it into
        the per-session books — a federation layer counts cluster-wide
        sheds here.  Same
        contract as ``on_result``: keep it cheap, exceptions are
        printed and swallowed.
    on_admit : optional callable invoked with the ``QueuedFrame`` the
        moment ``submit`` accepts a frame into the queues (on the
        SUBMITTING thread, past the rate-limit and capacity checks) —
        the journal-ack seam: a federation layer's replication plane
        write-ahead-journals exactly the frames the member accepted,
        with their original enqueue
        time and deadline.  Frames implanted by ``import_session`` do
        NOT fire it — their ledger (and journal entry) travelled with
        them.  Exceptions propagate to the submitter: a frame whose
        journal append failed was never durably accepted.
    clock : timing source; defaults to the gateway's injected clock so
        one fake clock drives queue waits, deadlines, rate limits and
        tick latency.
    rate_limit : optional ``(rate_per_s, burst)`` default token-bucket
        admission control applied to every session (override or disable
        per session at ``open_session``).  An exhausted bucket refuses
        the frame with the typed ``RateLimitError``, counted in
        ``StreamStats.rejected_rate_limited`` — never silent.
    schedule_keep : how many recent ticks of the admitted schedule to
        retain for ``schedule()`` replay/debugging (bounded for the
        same always-on reason).
    """

    def __init__(self, gateway, *, cfg: SchedulerCfg | None = None,
                 queue_maxlen: int = 256, queue_maxlens=None,
                 pipeline: bool = True, on_result=None, on_shed=None,
                 on_admit=None, clock=None,
                 rate_limit: tuple | None = None,
                 schedule_keep: int = 4096,
                 trace_sample: float = 0.0, recorder=None):
        if not gateway.overlap:
            raise ValueError(
                "StreamServer pipelines tick_launch/tick_collect — "
                "construct the gateway with overlap=True")
        self.gateway = gateway
        self.cfg = cfg = cfg if cfg is not None else SchedulerCfg()
        self.pipeline = pipeline
        self._clock = clock if clock is not None else gateway.clock
        # one telemetry plane for the whole stack (repro_torch.obs): the
        # gateway's registry is shared down
        # into the queues and scheduler, the flight recorder collects
        # every anomaly, and the tracer samples per-frame spans
        # (trace_sample=0.0 — the default — stamps NOTHING on the hot
        # path: frames carry trace=None and every stamp site is one
        # attribute test)
        self.registry = gateway.registry
        self.recorder = recorder if recorder is not None \
            else FlightRecorder(clock=self._clock)
        self.tracer = Tracer(trace_sample, clock=self._clock,
                             recorder=self.recorder)
        self.queues = QoSQueues(maxlen=queue_maxlen, maxlens=queue_maxlens,
                                registry=self.registry)
        self.scheduler = TickScheduler(cfg, registry=self.registry,
                                       recorder=self.recorder)
        self._on_result = on_result
        self._on_shed = on_shed
        self._on_admit = on_admit
        self._rate_limit = rate_limit
        self._sessions: dict[int, _ServedSession] = {}
        self._lock = threading.RLock()        # session table + gateway admin
        # serializes start()/stop() against each other: without it two
        # threads can both observe a dead _thread and spawn two serving
        # loops (check-then-act race)
        self._life = threading.Lock()
        # serializes step(): normally only the serving thread runs it,
        # but close_session's caller-driven fallback (no live thread)
        # may be entered from several client threads at once
        self._step_lock = threading.Lock()
        self._plan = None                     # the in-flight TickPlan
        self._plan_classes: list[str] = []    # its frames' classes
        self._plan_traces: list = []          # its frames' FrameTraces
        #                                       (parallel; None when off)
        self._results: list = []              # drained by drain_results()
        # per tick: [(sid, t), ...] — BOUNDED: an always-on server must
        # not grow host state with uptime, so only the newest
        # ``schedule_keep`` ticks are retained for replay/debugging
        self._schedule: deque = deque(maxlen=schedule_keep)
        R = self.registry
        self._pipelined_ticks = R.counter("stream_pipelined_ticks")
        self._ticks = R.counter("stream_ticks")
        self._served = {q.value: R.counter("stream_frames_served",
                                           qos=q.value) for q in QoSClass}
        # frames admitted out of the queues but not yet delivered —
        # updated under _lock inside the admit/collect transitions so
        # the StreamStats conservation invariant holds at every snapshot
        # (a Counter, not a Gauge: it is an integer level in the
        # conservation identity and must stay bit-exact)
        self._inflight = {q.value: R.counter("stream_in_flight",
                                             qos=q.value)
                          for q in QoSClass}
        # token-bucket refusals per class — admission control happens
        # before a frame touches the queues, so the counter lives here
        # (mutated and snapshotted under _lock)
        self._rate_limited = {q.value: R.counter(
            "stream_rejected_rate_limited", qos=q.value)
            for q in QoSClass}
        self._thread: threading.Thread | None = None
        self._stopping = False
        self._drain_on_stop = True
        self._closing_n = 0                   # sessions draining to close
        self._fault: BaseException | None = None   # serving-loop death
        dev = gateway.device
        self._stream = (torch.cuda.current_stream(dev)
                        if dev.type == "cuda" else None)

    # -- session lifecycle (any thread) --------------------------------------
    def open_session(self, platform="pi4",
                     qos: QoSClass = QoSClass.STANDARD, *,
                     weight: float = 1.0,
                     rate_limit=_UNSET) -> SessionInfo:
        """Admit a session (delegates to the gateway, which may raise
        the typed ``AdmissionError``).

        ``weight`` is the session's STANDARD fair-share weight (DRR;
        clamped, only meaningful for ``QoSClass.STANDARD``).
        ``rate_limit`` is a per-session ``(rate_per_s, burst)`` token
        bucket; leave unset to inherit the server default, pass ``None``
        to disable for this session."""
        limit = self._rate_limit if rate_limit is _UNSET else rate_limit
        bucket = (TokenBucket(limit[0], limit[1], now=self._clock())
                  if limit is not None else None)
        with self._lock:
            info = self.gateway.open_session(platform=platform, qos=qos)
            self._sessions[info.sid] = _ServedSession(
                info.sid, qos, weight=clamp_weight(weight), bucket=bucket)
            return info

    def close_session(self, sid, *, timeout: float | None = 30.0) -> None:
        """Graceful close: no new submits are accepted, every frame
        already accepted for the session is still served (or, with a
        shed horizon configured, visibly shed once its deadline is long
        past — never silently dropped), then the gateway evicts the
        row.  Blocks until drained when the serving thread runs (raises
        ``TimeoutError`` past ``timeout``); otherwise the caller drives
        ``step()`` to completion."""
        with self._lock:
            s = self._require(sid)
            if not s.closing:       # concurrent closers all wait below
                s.closing = True
                self._closing_n += 1
        with self.queues.cond:
            self.queues.cond.notify_all()
        t = self._thread
        if threading.current_thread() is t:
            # called ON the serving thread (e.g. from an on_result
            # callback): waiting would self-deadlock — the close is
            # marked and _process_closes completes it this same loop
            return
        if t is not None and t.is_alive():
            if not s.closed.wait(timeout):
                self._check_fault()    # the real cause, if the loop died
                raise TimeoutError(f"session {sid} did not drain in "
                                   f"{timeout}s")
        else:
            while not s.closed.is_set():
                self._check_fault()
                self.step()

    def _require(self, sid) -> _ServedSession:
        s = self._sessions.get(sid)
        if s is None:
            raise KeyError(f"session {sid} is not open")
        return s

    # -- live migration ------------------------------------------------------
    def quiesce(self) -> int:
        """Collect the in-flight tick, if any, and deliver its results —
        the migration barrier: after ``quiesce()`` no frame is between
        ``tick_launch`` and ``tick_collect``, so ``export_session`` can
        take a complete snapshot.  Returns frames delivered.  Intended
        for stepped (thread-less) operation; with the serving thread
        running, ``stop(drain=False)`` first."""
        with self._step_lock:
            return self._collect() if self._plan is not None else 0

    def export_session(self, sid) -> SessionSnapshot:
        """Freeze one session — gateway state (ring row, sync books,
        counters) PLUS the serving-side books: submitted/served/shed,
        DRR weight, token-bucket level, and every waiting frame (queued
        or staged) with its ORIGINAL arrival time and deadline.  The
        session leaves this server: its frames leave the queues with
        their ledger (per-member conservation holds on both sides of a
        migration), and the row is evicted.  Raises ``RuntimeError`` if
        an in-flight tick still holds the session's frames
        (``quiesce()`` first) and ``KeyError`` for unknown or closing
        sessions."""
        with self._step_lock:
            if self._plan is not None and any(
                    p[0] == sid for p in self._plan.pending):
                raise RuntimeError(
                    f"session {sid} has frames in the in-flight tick — "
                    "quiesce() before export_session()")
            with self.queues.cond:
                with self._lock:
                    s = self._require(sid)
                    if s.closing:
                        raise KeyError(f"session {sid} is closing")
                    staged = self.scheduler.extract_session_locked(sid)
                    if staged:
                        self.queues.uncount_locked(s.qos, len(staged))
                    queued = self.queues.extract_session_locked(s.qos, sid)
                    frames = sorted(staged + queued, key=lambda qf: qf.seq)
                    now = None      # lazy clock: only if a trace is live
                    for qf in frames:
                        if qf.trace is not None:
                            if now is None:
                                now = self._clock()
                            qf.trace.add("migrate_out", now)
                    snap = self.gateway.export_session(sid)
                    del self._sessions[sid]
                    bucket = (None if s.bucket is None else
                              (s.bucket.rate_per_s, s.bucket.burst,
                               s.bucket.tokens, s.bucket._last))
                    server = ServerSessionSnapshot(
                        submitted=s.submitted, served=s.served,
                        shed=s.shed, weight=s.weight, bucket=bucket,
                        queued=tuple(
                            QueuedFrameSnapshot(
                                frame=qf.frame, enq_s=qf.enq_s,
                                deadline_s=qf.deadline_s,
                                preemptions=qf.preemptions,
                                promoted=qf.promoted, weight=qf.weight,
                                trace=qf.trace)
                            for qf in frames))
                    return replace(snap, server=server)

    def checkpoint_session(self, sid) -> SessionSnapshot:
        """Non-destructive copy of one session — the cluster's
        failure-recovery checkpoint.  Unlike ``export_session`` the
        session KEEPS serving here, and waiting frames are NOT captured
        (a checkpoint restore resumes from the last served frame; it
        cannot resurrect a dead member's queues — the cluster counts
        those frames in ``lost_in_flight`` instead).  The snapshot's
        books are therefore SETTLED — ``submitted == served + shed``,
        ``queued=()`` — so a restored session can always drain to
        close.  Same quiesce precondition as ``export_session``."""
        with self._step_lock:
            if self._plan is not None and any(
                    p[0] == sid for p in self._plan.pending):
                raise RuntimeError(
                    f"session {sid} has frames in the in-flight tick — "
                    "quiesce() before checkpoint_session()")
            with self.queues.cond:
                with self._lock:
                    s = self._require(sid)
                    if s.closing:
                        raise KeyError(f"session {sid} is closing")
                    snap = self.gateway.export_session(sid, remove=False)
                    bucket = (None if s.bucket is None else
                              (s.bucket.rate_per_s, s.bucket.burst,
                               s.bucket.tokens, s.bucket._last))
                    server = ServerSessionSnapshot(
                        submitted=s.served + s.shed, served=s.served,
                        shed=s.shed, weight=s.weight, bucket=bucket,
                        queued=())
                    return replace(snap, server=server)

    def import_session(self, snap: SessionSnapshot) -> SessionInfo:
        """Resume an exported session here — the other half of a
        migration.  The gateway re-admits the row (same ``AdmissionError``
        surface as ``open_session``; the sid is fresh), the serving
        books and token-bucket level are restored, and the snapshot's
        waiting frames re-enter the queues at their ``enq_s``-sorted
        positions with their ORIGINAL deadlines — no re-validation, no
        rate-limit charge, no submit-count: their ledger arrived with
        them.  Returns the new ``SessionInfo``."""
        with self._step_lock:
            with self.queues.cond:
                with self._lock:
                    info = self.gateway.import_session(snap)
                    sv = snap.server
                    if sv is None:          # bare gateway-level snapshot
                        sv = ServerSessionSnapshot(
                            submitted=0, served=0, shed=0, weight=1.0)
                    if sv.bucket is not None:
                        rate, burst, tokens, last = sv.bucket
                        bucket = TokenBucket(rate, burst, now=last)
                        bucket.tokens = tokens
                    elif snap.server is None and self._rate_limit:
                        bucket = TokenBucket(self._rate_limit[0],
                                             self._rate_limit[1],
                                             now=self._clock())
                    else:
                        bucket = None
                    s = _ServedSession(info.sid, snap.qos,
                                       weight=clamp_weight(sv.weight),
                                       bucket=bucket)
                    s.submitted, s.served, s.shed = (
                        sv.submitted, sv.served, sv.shed)
                    self._sessions[info.sid] = s
                    implanted = self.queues.implant_frames_locked(
                        info.sid, sv.queued, snap.qos)
                    now = None   # lazy clock: only if a trace travelled
                    for qf in implanted:
                        if qf.trace is not None:
                            if now is None:
                                now = self._clock()
                            qf.trace.add("migrate_in", now,
                                         sid=info.sid)
                    return info

    def _check_fault(self) -> None:
        """Re-raise a serving-loop death at the caller: producers and
        waiters must fail fast, not hang on a server that will never
        serve again (the original traceback was already printed)."""
        if self._fault is not None:
            raise RuntimeError(
                "serving loop died mid-run") from self._fault

    # -- ingest (any thread) -------------------------------------------------
    def submit(self, sid, frame: FrameRequest) -> None:
        """Enqueue one frame.  Validates + converts the mel HERE (on the
        client's thread) so the serving thread never pays conversion;
        raises ``RateLimitError`` when the session's token bucket is
        empty, ``QueueFullError`` when the session's class queue is at
        capacity, and ``KeyError`` once the session is closing."""
        self._check_fault()
        with self._lock:
            s = self._require(sid)
            if s.closing:
                raise KeyError(f"session {sid} is closing")
        mel = self.gateway.validate_mel(frame.mel)   # the one validation
        if mel is not frame.mel:
            frame = replace(frame, mel=mel)
        now = self._clock()
        # count the frame BEFORE it becomes visible in the queues (and
        # roll back on refusal): _process_closes compares served + shed
        # == submitted, so an enqueued-but-uncounted frame could let a
        # racing close_session evict the row out from under it
        with self._lock:
            if s.closing:
                raise KeyError(f"session {sid} is closing")
            if s.bucket is not None and not s.bucket.try_take(now):
                self._rate_limited[s.qos.value].inc()
                self.recorder.record("rate_limited", now, sid=sid,
                                     qos=s.qos.value, t=frame.t)
                raise RateLimitError(sid, s.qos,
                                     s.bucket.retry_after_s(now))
            s.submitted += 1
        # per-frame span begins here; with sampling off (the default)
        # this is one float compare and tr stays None everywhere
        tr = self.tracer.maybe_begin(sid, frame.t, now,
                                     qos=s.qos.value) \
            if self.tracer.sample > 0.0 else None
        try:
            qf = self.queues.submit(sid, frame, s.qos, now=now,
                                    deadline_s=now
                                    + self.cfg.deadline_s(s.qos),
                                    weight=s.weight, trace=tr)
        except BaseException as e:
            with self._lock:
                s.submitted -= 1
                if s.bucket is not None:
                    s.bucket.give_back()    # a refused frame costs no budget
            if isinstance(e, QueueFullError):
                self.recorder.record("queue_full", now, sid=sid,
                                     qos=s.qos.value, t=frame.t,
                                     depth=e.depth, maxlen=e.maxlen)
            raise
        if self._on_admit is not None:
            # the journal-ack seam (a replication plane): a frame
            # is only durably accepted once its write-ahead append
            # succeeded.  On failure the frame is withdrawn (identity
            # match — QueuedFrame's field equality is meaningless) and
            # the books roll back like any other refusal; if the
            # serving thread already staged it, acceptance stands.
            try:
                self._on_admit(qf)
            except BaseException:
                withdrawn = False
                with self.queues.cond:
                    cq = self.queues.by_class[s.qos]
                    for i, x in enumerate(cq.q):
                        if x is qf:
                            del cq.q[i]
                            cq.submitted -= 1
                            withdrawn = True
                            break
                if withdrawn:
                    with self._lock:
                        s.submitted -= 1
                        if s.bucket is not None:
                            s.bucket.give_back()
                raise

    # -- the serving loop ----------------------------------------------------
    def start(self) -> "StreamServer":
        """Launch the background serving thread (idempotent, and safe
        to race: the check-and-spawn is serialized under ``_life`` so
        two callers can never start two serving loops)."""
        with self._life:
            if self._thread is not None and self._thread.is_alive():
                return self
            self._stopping = False
            self._thread = threading.Thread(target=self._loop,
                                            name="streamsplit-serve",
                                            daemon=True)
            self._thread.start()
        return self

    def stop(self, *, drain: bool = True, timeout: float | None = 60.0):
        """Stop serving.  ``drain=True`` (default) serves every queued
        frame first; ``drain=False`` collects only the in-flight tick
        and leaves the backlog measurable in ``stats().queue_depth``.
        Serialized against ``start()`` (and concurrent ``stop()``s)
        under ``_life`` — the serving thread itself never takes that
        lock, so joining under it cannot deadlock."""
        with self._life:
            self._drain_on_stop = drain
            self._stopping = True
            with self.queues.cond:
                self.queues.cond.notify_all()
            t = self._thread
            if t is not None and t is not threading.current_thread():
                t.join(timeout)
                if t.is_alive():
                    raise TimeoutError("serving thread did not stop")
            self._thread = None
            if self._fault is not None:
                # the loop died on an exception earlier (already printed
                # with traceback): surface it loudly at stop time instead
                # of letting the session end "cleanly"
                fault, self._fault = self._fault, None
                raise RuntimeError("serving loop died mid-run") from fault
        return self

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop(drain=not any(exc))

    def _on_device(self):
        """The serving thread's CUDA context: the gateway's device and the
        stream current there when the server was built (nothing on the
        CPU)."""
        ctx = contextlib.ExitStack()
        if self._stream is not None:
            ctx.enter_context(torch.cuda.device(self._stream.device))
            ctx.enter_context(torch.cuda.stream(self._stream))
        return ctx

    def _loop(self):
        with self._on_device():
            self._serve()

    def _serve(self):
        try:
            while True:
                with self.queues.cond:
                    work = (self.queues.pending_locked()
                            or self.scheduler.staged
                            or self._plan is not None
                            or self._closes_pending())
                    if self._stopping and (not work
                                           or not self._drain_on_stop):
                        break
                    if not work:
                        self.queues.cond.wait(timeout=0.05)
                        continue
                self.step()
            # never leave a launched tick dangling
            with self._step_lock:
                if self._plan is not None:
                    self._collect()
                self._process_closes()
        except BaseException as e:      # noqa: BLE001 — loop boundary
            # an unhandled serving-loop exception must not vanish with
            # the daemon thread: print it now, re-raise it at stop()
            import traceback
            traceback.print_exc()
            self._fault = e

    def step(self) -> int:
        """One serving iteration — public so deterministic tests can
        drive the exact thread loop synchronously.  Returns the number
        of frames delivered.

        Order of operations IS the pipeline:

        1. ``admit`` the staged batch (backfill + BULK preemption),
        2. launch it (``tick_launch``) — while the PREVIOUS tick's
           chains are still in flight (unless a refine round is due or
           ``pipeline=False``, in which case the previous tick collects
           first: learning order always matches the sequential
           gateway),
        3. stage the next batch under the fresh chains,
        4. collect the previous tick and deliver its results,
        5. process session closes whose frames have fully drained.
        """
        with self._step_lock:   # close_session fallbacks may race here
            return self._step_locked()

    def _step_locked(self) -> int:
        gw = self.gateway
        with self.queues.cond:                 # Condition wraps an RLock
            batch = self.scheduler.admit(self.queues, self._clock())
            shed = self.scheduler.pop_shed()
            with self._lock:                   # queue -> in-flight, atomic
                for qf in batch:
                    self._inflight[qf.qos.value].inc()
                # shed frames leave the system here: fold them into the
                # per-session books so a draining close still completes
                for qf in shed:
                    s = self._sessions.get(qf.sid)
                    if s is not None:
                        s.shed += 1
        for qf in shed:
            if qf.trace is not None:
                # the scheduler already stamped the terminal "shed";
                # hand the finished span to the flight recorder
                self.tracer.retire(qf.trace)
        if shed and self._on_shed is not None:
            for qf in shed:        # outside the locks, like on_result
                try:
                    self._on_shed(qf)
                except Exception:   # user code must not kill serving
                    import traceback
                    traceback.print_exc()
        new_plan = None
        new_classes: list[str] = []
        new_traces: list = []
        served = 0
        if batch:
            if self._plan is not None and (not self.pipeline
                                           or gw.refine_due_next_tick()):
                served += self._collect()
            for qf in batch:
                # already validated/converted at enqueue (validate_mel
                # on the client's thread) — skip the re-check here
                gw.submit_validated(qf.sid, qf.frame)
                new_classes.append(qf.qos.value)
                new_traces.append(qf.trace)
            if self._plan is not None:
                with self._lock:               # stats() reads under _lock
                    self._pipelined_ticks.inc()
            new_plan = gw.tick_launch()
            if any(tr is not None for tr in new_traces):
                # stamp dispatch with the bucket/shard the launch chose;
                # idx indexes the submission-ordered batch
                now = self._clock()
                for k, idx, _wire, _ms, sh in new_plan.launched:
                    for i in idx:
                        tr = new_traces[i]
                        if tr is not None:
                            tr.add("dispatch", now, k=int(k),
                                   shard=int(sh))
        self.scheduler.stage(self.queues, self._clock())
        if self._plan is not None:
            served += self._collect()
        self._plan, self._plan_classes = new_plan, new_classes
        self._plan_traces = new_traces
        self._process_closes()
        return served

    def _collect(self) -> int:
        plan, classes = self._plan, self._plan_classes
        traces = self._plan_traces
        self._plan, self._plan_classes, self._plan_traces = None, [], []
        results = self.gateway.tick_collect(plan)
        now = None          # lazy: no clock read unless a trace is live
        for r, tr in zip(results, traces):
            if tr is not None:
                if now is None:
                    now = self._clock()
                tr.add("collect", now)
                self.tracer.finish(tr, "serve", now, route=r.route,
                                   k=r.k, latency_ms=r.latency_ms)
        with self._lock:
            self._ticks.inc()
            self._schedule.append([(r.sid, r.t) for r in results])
            for r, cls in zip(results, classes):
                self._served[cls].inc()
                self._inflight[cls].inc(-1)
                s = self._sessions.get(r.sid)
                if s is not None:
                    s.served += 1
            if self._on_result is None:
                # buffer only when the caller drains: with a callback
                # installed, delivery happens below and an always-on
                # server must not accumulate every result forever
                self._results.extend(results)
        if self._on_result is not None:
            for r in results:
                try:
                    self._on_result(r)
                except Exception:       # user code must not kill serving
                    import traceback
                    traceback.print_exc()
        return len(results)

    def _closes_pending(self) -> bool:
        return self._closing_n > 0            # bare-int read: hot loop

    def _process_closes(self):
        if not self._closing_n:
            return
        with self._lock:
            # every accepted frame is accounted: served as a result or
            # shed visibly past the horizon — only then may the row go
            done = [s for s in self._sessions.values()
                    if s.closing and not s.closed.is_set()
                    and s.served + s.shed == s.submitted
                    and not self._in_pipeline(s.sid)]
            for s in done:
                self.gateway.close_session(s.sid)
                del self._sessions[s.sid]
                self._closing_n -= 1
                s.closed.set()

    def _in_pipeline(self, sid) -> bool:
        if self._plan is not None and any(
                p[0] == sid for p in self._plan.pending):
            return True
        return any(qf.sid == sid for qf in self.scheduler.staged)

    # -- results + observability ---------------------------------------------
    def busy(self) -> bool:
        """Queued, staged, in-flight, or closing work exists right now
        — what the serving loop's own work check sees.  Stepped drivers
        (``chip_smoke.py``, tests) loop ``step()`` on this."""
        with self.queues.cond:
            return bool(self.queues.pending_locked()
                        or self.scheduler.staged
                        or self._plan is not None
                        or self._closes_pending())

    @property
    def served_total(self) -> int:
        """Frames delivered so far — a bare counter, cheap enough to
        poll from a hot loop (``stats()`` builds percentiles; don't spin
        on it).  Raises if the serving loop died, so progress pollers
        fail fast instead of spinning forever."""
        self._check_fault()
        return sum(c.value for c in self._served.values())

    def drain_results(self) -> list:
        """All ``FrameResult``s delivered since the last drain."""
        self._check_fault()
        with self._lock:
            out, self._results = self._results, []
        return out

    def schedule(self) -> list[list[tuple]]:
        """The admitted schedule (newest ``schedule_keep`` ticks): per
        collected tick, the served ``(sid, t)`` pairs in submission
        order.  Replaying it through a sequential gateway reproduces
        every embedding bit-for-bit (``chip_smoke.py`` asserts this on
        the card)."""
        with self._lock:       # _collect appends under the same lock
            return [list(t) for t in self._schedule]

    def stats(self) -> StreamStats:
        # one consistent snapshot: queue/staged state and the
        # served/in-flight/shed counters are read under the same lock
        # pair (cond -> _lock, the loop's nesting order) that every
        # frame transition mutates them under, so the conservation
        # invariant documented on StreamStats holds at EVERY snapshot
        with self.queues.cond:
            qc = self.queues.counters()
            depth = self.queues.depths()
            staged = self.scheduler.staged_depths()
            # admission accounting (wait samples, deadline misses,
            # aged promotions) is written while step() holds the cond —
            # read it there too
            misses = dict(self.scheduler.deadline_misses)
            promoted = dict(self.scheduler.promoted)
            waits = self.scheduler.wait_percentiles()
            with self._lock:
                served = {c: m.value for c, m in self._served.items()}
                in_flight = {c: m.value
                             for c, m in self._inflight.items()}
                rate_limited = {c: m.value
                                for c, m in self._rate_limited.items()}
                ticks = self._ticks.value
                pipelined = self._pipelined_ticks.value
        t = self._thread
        return StreamStats(
            running=t is not None and t.is_alive(),
            ticks=ticks,
            pipelined_ticks=pipelined,
            frames_submitted=qc["submitted"],
            frames_served=served,
            queue_depth={c: depth[c] + staged[c] for c in depth},
            in_flight=in_flight,
            rejected_full=qc["rejected"],
            rejected_rate_limited=rate_limited,
            preempted=qc["preempted"],
            requeued=qc["requeued"],
            shed_expired=qc["shed_expired"],
            promoted=promoted,
            deadline_misses=misses,
            queue_wait_ms=waits,
            gateway=self.gateway.stats())

    def metrics(self) -> str:
        """The whole stack's registry in Prometheus text exposition
        format (gateway + queues + scheduler + server share one
        registry).  Calls ``gateway.stats()`` first so lazily-synced
        gauges (per-shard frame counts) are fresh."""
        self.gateway.stats()
        return to_prometheus(self.registry)

    def dump_trace(self, reason: str = "on_demand") -> dict:
        """Flight-recorder dump: recent sampled spans plus every
        anomalous event (shed, deadline miss, preemption, rate-limit /
        queue-full refusal) with exact cumulative counts — see
        ``repro_torch.obs.FlightRecorder.dump``."""
        return self.recorder.dump(reason=reason)

    def resource_signals(self) -> ResourceSignals:
        """Cheap load signals for adaptive policies — the same numbers
        ``stats()`` reports, but as a small fixed-shape record whose
        ``as_observation()`` vector a ``SplitPolicy`` can consume as
        features.  Safe to poll from a hot loop: no percentile lists are
        built, only registry reads."""
        with self.queues.cond:
            depth = (self.queues.pending_locked()
                     + len(self.scheduler.staged))
            capacity = sum(cq.maxlen
                           for cq in self.queues.by_class.values())
            submitted = rejected = shed = 0
            for cq in self.queues.by_class.values():
                submitted += cq.submitted
                rejected += cq.rejected
                shed += cq.shed_expired
            p95 = 0.0
            for h in self.scheduler.wait_hist.values():
                if h.count:
                    p95 = max(p95, h.summary()["p95"])
            with self._lock:
                in_flight = sum(c.value
                                for c in self._inflight.values())
                served = sum(c.value for c in self._served.values())
                limited = sum(c.value
                              for c in self._rate_limited.values())
        stage = self.registry.value("gateway_stage_ewma_ms",
                                    stage="tick")
        refused = rejected + limited
        offered = submitted + refused
        uptime = self._clock() - self.gateway._t_start
        return ResourceSignals(
            queue_depth=depth,
            queue_fill=depth / capacity if capacity else 0.0,
            in_flight=in_flight,
            wait_p95_ms=p95,
            stage_ewma_ms=stage,
            shed_rate=shed / submitted if submitted else 0.0,
            reject_rate=refused / offered if offered else 0.0,
            throughput_fps=served / uptime if uptime > 0 else 0.0)
