"""``GatewayCluster`` — self-healing multi-gateway federation.

Port of ``repro.cluster.cluster``.  One gateway serves one card's
fleet; a deployment has several.  This module federates N member
servers behind a single session API:

- **Routing**: every cluster session gets a stable global sid (gsid)
  and is placed on the member that owns it on a seeded consistent-hash
  ring (``cluster/hashing.py``).  Placement walks the ring's preference
  order past full members, so admission only fails when the whole
  cluster is out of headroom.
- **Live migration**: ``drain(member)`` (rolling restarts) and
  ``add_member`` / member failure (rebalance) move sessions between
  gateways via the ``SessionSnapshot`` seam — ring row, sync books,
  scheduler books, token-bucket level, and every waiting frame with its
  ORIGINAL deadline travel together, so a migrated stream is
  indistinguishable from one that never moved: the same split index,
  route and wire bytes, and the same embedding up to the batch
  composition of the ticks it rode in (torch's convolutions are not
  batch-invariant; ``tests/test_torch_cluster.py`` holds it at 1e-4).
- **Fault tolerance, bounded loss** (``cluster/replication.py``): with
  ``replicate=True`` every accepted frame is write-ahead-journaled on a
  deterministic buddy member (the next live ring node past the owner)
  through the member's ``on_admit`` journal-ack hook, and recovery from
  a member death is *import the last checkpoint + replay the journal's
  open entries* through the ordinary ``import_session`` seam — so
  ``lost_in_flight`` shrinks from "everything since ``snapshot_every``"
  to "frames admitted but not yet journal-acked" (at most one
  ``journal_flush_every`` window).  Whatever is still unrecoverable is
  counted — never silently dropped — in ``ClusterStats.lost_in_flight``,
  the term that keeps the cluster-wide conservation identity

      submitted == served + queue_depth + in_flight
                   + shed_expired + lost_in_flight

  true at every ``stats()`` snapshot, including across repeated
  kill → recover → kill cycles.
- **Failure detection** (``cluster/health.py``): a member that RAISES
  dies at the exception seam, as before; a member that HANGS (makes no
  progress without raising) is caught by heartbeat suspicion on the
  injected timer and routed through the same recovery path.  Transient
  faults (``runtime/fault.TransientFault``) from member submit / step /
  checkpoint calls are retried with deterministic exponential backoff
  (``RetryPolicy`` — no wall-clock sleeps) instead of executing the
  member; only exhausted retries or fatal exceptions fail it over.
- **Graceful degradation**: when live membership falls below
  ``degraded_below`` × the peak membership, the cluster turns visibly
  degraded — new sessions and BULK frames are refused with the typed
  ``ClusterDegradedError`` (counted in ``rejected_degraded``), keeping
  the survivors' headroom for the streams they already hold.  The mode
  clears itself as soon as capacity returns via ``add_member``.
  ``StragglerMonitor`` feeds a slow-member signal that shrinks the
  member's hash-space share (placement bias; nothing is evicted).

**The cluster owns its members.**  Member servers must be constructed
WITHOUT their own serving thread running; the cluster drives them
through the public ``step()`` seam — one ``cluster.step()`` steps every
live member once, deterministically, which is also why every chaos test
runs on a fake clock.  Each member's turn runs on that member's device
and CUDA stream (``StreamServer._on_device``), so the cluster's stepping
thread drives card members as their own serving thread would; every
path that steps a member (``step``, ``pump``, ``close_session``, the
stepping thread) holds the cluster lock, so no two threads ever drive
one member at once, and a member that starts its own serving thread
after joining is refused at its next turn.  All client traffic
(open/submit/close) must flow through the cluster: a frame submitted
directly to a member is invisible to the federation books and breaks
the conservation identity.

The cluster keeps its OWN books at the federation boundary (counted at
``submit`` / ``on_result`` / ``on_shed``) instead of summing member
counters: a dead member's counters vanish with it, and a migrated
session's would double-count — cluster-level accounting is the only
representation that survives both.
"""
from __future__ import annotations

import threading
import time
from dataclasses import replace

from repro_torch.api.types import (AdmissionError, ClusterDegradedError,
                                   ClusterDrainTimeout, ClusterStats,
                                   QoSClass, ServerSessionSnapshot)
from repro_torch.cluster.hashing import HashRing
from repro_torch.cluster.health import HeartbeatMonitor, MemberHungError
from repro_torch.cluster.replication import ReplicationLog
from repro_torch.obs import FlightRecorder, MetricsRegistry, to_prometheus
from repro_torch.runtime.fault import RetryPolicy, TransientFault
from repro_torch.serving.queues import QueueFullError, RateLimitError
from repro_torch.serving.server import _UNSET

__all__ = ["GatewayCluster"]

_DUMP_KEEP = 8          # newest automatic failover dumps retained


class _ClusterSession:
    """Federation-side session record: where the session lives now,
    plus the cluster's own conservation books for it (these survive
    migration and member death — member counters do not)."""

    __slots__ = ("gsid", "member", "lsid", "qos", "platform",
                 "submitted", "served", "shed", "lost")

    def __init__(self, gsid, member, lsid, qos, platform):
        self.gsid = gsid
        self.member = member       # current owner's name
        self.lsid = lsid           # sid on that member (fresh per move)
        self.qos = qos
        self.platform = platform
        self.submitted = 0
        self.served = 0
        self.shed = 0
        self.lost = 0              # counted at member death, cumulative

    @property
    def outstanding(self) -> int:
        """Frames accepted but not yet served, shed, or counted lost."""
        return self.submitted - self.served - self.shed - self.lost


class GatewayCluster:
    """Federates N ``StreamServer`` members behind one session API.

    Parameters
    ----------
    members : ``{name: StreamServer}``.  Servers must not have their
        serving thread running — the cluster steps them.
    seed / vnodes : consistent-hash ring determinism knobs
        (``cluster/hashing.py``).
    snapshot_every : take a failure-recovery checkpoint of every
        session each N cluster steps (0 disables; then a member failure
        loses its sessions entirely — still counted, never silent —
        unless ``replicate`` is on, which checkpoints at admission and
        after every move so a buddy journal always has a base to replay
        onto).
    replicate : write-ahead-journal every accepted frame on a buddy
        member (``cluster/replication.py``) and recover member deaths
        by checkpoint + journal replay.  Loss per failure is bounded by
        the unflushed journal window instead of ``snapshot_every``.
    journal_flush_every : ship pending journal entries to the buddy
        every N cluster steps (1 = each step).  The replication lag —
        and the loss bound — is at most one flush window.
    heartbeat_timeout_s : declare a member HUNG (and fail it over) when
        it completes no step for this long on the injected ``timer``
        (None disables hang detection — raising members still die at
        the exception seam).
    retry : ``runtime/fault.RetryPolicy`` for transient member faults
        at the submit/step/checkpoint seams (the default retries 3
        attempts with deterministic exponential backoff; pass ``None``
        to make every fault fatal).
    degraded_below : enter degraded mode when ``live_members <
        degraded_below * peak_members`` — new sessions and BULK frames
        get the typed ``ClusterDegradedError`` until capacity returns
        (0 disables).
    on_result : like ``StreamServer``'s — invoked with each
        ``FrameResult`` re-addressed to the global sid; without it
        results buffer until ``drain_results()``.
    injectors : ``{name: FailureInjector}`` — chaos hook; the injector
        fires at the top of that member's turn in ``step()`` (and its
        ``hanging`` window makes the cluster skip the member's turn —
        a hang is the absence of progress, not an exception).
    straggler_factory : zero-arg callable returning a fresh
        ``StragglerMonitor`` per member (None disables detection).
    straggler_weight : ring weight applied to a flagged member
        (fraction of a healthy member's hash-space share).
    timer : step-duration source for the straggler monitors, heartbeat
        suspicion and migration-pause stats (injectable for
        deterministic tests; defaults to ``time.perf_counter``).
    """

    def __init__(self, members: dict, *, seed: int = 0, vnodes: int = 64,
                 snapshot_every: int = 0, on_result=None,
                 injectors: dict | None = None,
                 replicate: bool = False, journal_flush_every: int = 1,
                 heartbeat_timeout_s: float | None = None,
                 retry=_UNSET,
                 degraded_below: float = 0.0,
                 straggler_factory=None, straggler_weight: float = 0.25,
                 timer=time.perf_counter,
                 registry: MetricsRegistry | None = None,
                 recorder: FlightRecorder | None = None):
        if not members:
            raise ValueError("a cluster needs at least one member")
        if not 0.0 < straggler_weight <= 1.0:
            raise ValueError("straggler_weight must be in (0, 1]")
        if journal_flush_every < 1:
            raise ValueError("journal_flush_every must be >= 1")
        if not 0.0 <= degraded_below <= 1.0:
            raise ValueError("degraded_below must be in [0, 1]")
        self._members: dict = {}
        self._ring = HashRing(seed=seed, vnodes=vnodes)
        self._on_result = on_result
        self._snapshot_every = int(snapshot_every)
        self._injectors = dict(injectors or {})
        self._replicate = bool(replicate)
        self._flush_every = int(journal_flush_every)
        # the federation's OWN telemetry plane (repro_torch.obs) —
        # separate from the members': a dead
        # member takes its registry down with it, the cluster's books
        # must survive.  Names are cluster_*-prefixed.
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        self.recorder = recorder if recorder is not None \
            else FlightRecorder(clock=timer)
        R = self.registry
        self._log = ReplicationLog(registry=R) if replicate else None
        self._retry = (RetryPolicy() if retry is _UNSET else retry)
        self._degraded_below = float(degraded_below)
        self._straggler_factory = straggler_factory
        self._straggler_weight = float(straggler_weight)
        self._timer = timer
        self._health = (HeartbeatMonitor(
            suspect_after_s=heartbeat_timeout_s, clock=timer, registry=R)
            if heartbeat_timeout_s is not None else None)
        self._lock = threading.RLock()
        # federation books (cumulative; survive migration + death) —
        # registry counters mutated only under the cluster lock, read
        # by stats() / the exporters as views
        def _per_class(name):
            return {q.value: R.counter(name, qos=q.value)
                    for q in QoSClass}
        self._submitted = _per_class("cluster_frames_submitted")
        self._served = _per_class("cluster_frames_served")
        self._shed = _per_class("cluster_shed_expired")
        self._lost = _per_class("cluster_lost_in_flight")
        self._rejected_full = _per_class("cluster_rejected_full")
        self._rejected_rl = _per_class("cluster_rejected_rate_limited")
        self._rejected_degraded = _per_class("cluster_rejected_degraded")
        self._sessions: dict = {}          # gsid -> _ClusterSession
        self._local: dict = {}             # (member, lsid) -> gsid
        self._orig_cb: dict = {}           # name -> pre-interpose hooks
        self._snaps: dict = {}             # gsid -> last checkpoint
        self._stragglers: dict = {}        # name -> StragglerMonitor
        self._results: list = []
        self._next_gsid = 0
        self._steps = 0
        self._migrations = R.counter("cluster_migrations")
        self._migrated_frames = R.counter("cluster_migrated_frames")
        self._migrated_bytes = R.counter("cluster_migrated_bytes")
        # full pause list stays (public migration_pauses_ms API —
        # benchmarks slice cold vs warm by move order); the sketch is
        # the bounded exporter/stats view of the same samples
        self._pause_ms: list = []
        self._pause_hist = R.histogram("cluster_migration_pause_ms")
        self._drains = R.counter("cluster_drains")
        self._failures = R.counter("cluster_member_failures")
        self._failovers = R.counter("cluster_failovers")
        #                                    sessions restored on survivors
        self._retries = R.counter("cluster_retries")
        #                                    transient faults retried away
        self._replayed_frames = R.counter("cluster_replayed_frames")
        #                                    journal entries re-queued
        self._drain_stragglers = R.counter("cluster_drain_stragglers")
        #                                    sessions stuck at stop(drain)
        self._g_sessions = R.gauge("cluster_sessions_open")
        self._g_members = R.gauge("cluster_members_live")
        # flight-recorder dumps taken automatically at member failure —
        # the black box survives exactly the event it explains (bounded:
        # newest _DUMP_KEEP kept)
        self.failover_dumps: list = []
        self._peak_members = 0             # high-water live membership
        self._drained: dict = {}           # name -> server, out of rotation
        self._dead: dict = {}              # name -> server, postmortem
        self._lost_sessions: list = []     # gsids dropped at member death
        self._thread = None
        self._stopping = False
        for name, srv in sorted(members.items()):
            self._admit_member(name, srv)

    # -- membership ----------------------------------------------------------
    def _admit_member(self, name, srv) -> None:
        if name in self._members:
            raise ValueError(f"member {name!r} already in the cluster")
        if srv.stats().running:
            raise ValueError(
                f"member {name!r} has its own serving thread — the "
                "cluster owns stepping; construct members unstarted")
        # interpose on the member's delivery callbacks: the federation
        # books count at exactly the instants the member's do, under
        # the cluster lock (step() holds it; the RLock re-enters).  The
        # originals are kept so leaving the cluster (drain, death)
        # un-wraps — a drained member that rejoins via add_member must
        # not end up double-wrapped (every frame counted twice)
        prev_r, prev_s, prev_a = (srv._on_result, srv._on_shed,
                                  srv._on_admit)
        self._orig_cb[name] = (prev_r, prev_s, prev_a)
        def on_result(r, _n=name, _p=prev_r):
            self._count_result(_n, r)
            if _p is not None:
                _p(r)
        def on_shed(qf, _n=name, _p=prev_s):
            self._count_shed(_n, qf)
            if _p is not None:
                _p(qf)
        def on_admit(qf, _n=name, _p=prev_a):
            # the journal-ack seam: write-ahead-record exactly the
            # frames the member accepted, with their admission ledger
            self._journal_admit(_n, qf)
            if _p is not None:
                _p(qf)
        srv._on_result = on_result
        srv._on_shed = on_shed
        srv._on_admit = on_admit
        self._members[name] = srv
        self._peak_members = max(self._peak_members, len(self._members))
        self._ring.add(name)
        if self._health is not None:
            self._health.watch(name)
        if self._straggler_factory is not None:
            self._stragglers[name] = self._straggler_factory()

    def _release_member(self, name):
        """Un-wrap the callbacks and detach every monitor — the common
        tail of drain (graceful) and death (not)."""
        srv = self._members.pop(name)
        srv._on_result, srv._on_shed, srv._on_admit = \
            self._orig_cb.pop(name)
        self._stragglers.pop(name, None)
        if self._health is not None:
            self._health.forget(name)
        return srv

    def add_member(self, name, srv) -> int:
        """Join a member and rebalance: ONLY sessions whose ring
        ownership moved to the newcomer migrate (the consistent-hash
        property).  Returns how many moved."""
        with self._lock:
            self._admit_member(name, srv)
            moved = self._rebalance()
            self._rehome_journals()
            return moved

    def drain(self, name) -> int:
        """Rolling-restart move: stop admission to the member (it
        leaves the ring), quiesce its in-flight tick, then migrate
        every one of its sessions — books, ring row, token bucket and
        queued frames with their original deadlines — to ring-chosen
        survivors.  No stream is dropped; the member's server object is
        parked in case it returns via ``add_member``.  Returns sessions
        migrated."""
        with self._lock:
            srv = self._members.get(name)
            if srv is None:
                raise KeyError(f"member {name!r} not in the cluster")
            homed = [g for g, cs in self._sessions.items()
                     if cs.member == name]
            if homed and len(self._members) < 2:
                raise RuntimeError(
                    "cannot drain the only member while it serves "
                    "sessions — add_member() a target first")
            if self._ring.has(name):
                self._ring.remove(name)
            srv.quiesce()
            for gsid in homed:
                self._migrate(gsid)
            self._drains.inc()
            self._drained[name] = self._release_member(name)
            self._injectors.pop(name, None)
            # journals homed on the leaving member re-ship gracefully
            # (it is alive — its data moves, nothing is cleared)
            self._rehome_journals()
            return len(homed)

    # -- degraded mode -------------------------------------------------------
    def _degraded(self) -> bool:
        return (self._degraded_below > 0.0 and self._peak_members > 0
                and len(self._members)
                < self._degraded_below * self._peak_members)

    def _refuse_degraded(self, qos: QoSClass, what: str):
        self._rejected_degraded[qos.value].inc()
        self.recorder.record("degraded_refusal", qos=qos.value,
                             what=what, live=len(self._members),
                             peak=self._peak_members)
        raise ClusterDegradedError(len(self._members), self._peak_members,
                                   self._degraded_below, what)

    # -- session API (any thread) --------------------------------------------
    def open_session(self, platform="pi4",
                     qos: QoSClass = QoSClass.STANDARD, *,
                     weight: float = 1.0, rate_limit=_UNSET):
        """Admit a session cluster-wide: place it on its ring owner,
        walking the preference order past members without headroom.
        In degraded mode new sessions are refused with the typed
        ``ClusterDegradedError`` — the survivors' headroom belongs to
        the streams they already hold.  Returns ``SessionInfo`` whose
        ``sid`` is the GLOBAL session id — valid at ``submit``/
        ``close_session`` on this cluster only."""
        with self._lock:
            if self._degraded():
                self._refuse_degraded(qos, "new session")
            gsid = self._next_gsid
            self._next_gsid += 1
            kw = {} if rate_limit is _UNSET else {"rate_limit": rate_limit}
            last = None
            for name in self._ring.preference(gsid):
                srv = self._members.get(name)
                if srv is None:
                    continue
                try:
                    info = srv.open_session(platform=platform, qos=qos,
                                            weight=weight, **kw)
                except AdmissionError as e:
                    last = e
                    continue
                cs = _ClusterSession(gsid, name, info.sid, qos, platform)
                self._sessions[gsid] = cs
                self._local[(name, info.sid)] = gsid
                if self._log is not None:
                    self._log.open(
                        gsid, self._ring.buddy(gsid, exclude=(name,)))
                # an immediate admission checkpoint: recovery must never
                # find a journal with no base to replay onto (the
                # satellite contract: lost_sessions stays empty whenever
                # a buddy holds a journal)
                if self._snapshot_every or self._replicate:
                    self._snaps[gsid] = srv.checkpoint_session(info.sid)
                return replace(info, sid=gsid)
            if last is not None:
                raise last
            raise RuntimeError("no live members in the cluster")

    def submit(self, gsid, frame) -> None:
        """Route one frame to the session's current owner.  The same
        typed refusals as ``StreamServer.submit`` (``RateLimitError``,
        ``QueueFullError``) plus the degraded-mode BULK door shed
        (``ClusterDegradedError``), all counted at the federation
        boundary; transient member faults are retried per the
        ``RetryPolicy`` before anything is refused; an accepted frame
        enters the cluster books here."""
        with self._lock:
            cs = self._require(gsid)
            if cs.qos is QoSClass.BULK and self._degraded():
                self._refuse_degraded(cs.qos, "BULK frame")
            srv = self._members[cs.member]
            try:
                self._call_member(lambda: srv.submit(cs.lsid, frame))
            except RateLimitError:
                self._rejected_rl[cs.qos.value].inc()
                raise
            except QueueFullError:
                self._rejected_full[cs.qos.value].inc()
                raise
            cs.submitted += 1
            self._submitted[cs.qos.value].inc()

    def close_session(self, gsid) -> None:
        """Graceful cluster-wide close: the owner drains every accepted
        frame (serve or visible shed), then evicts the row.  With no
        serving thread on the member, the close is driven to completion
        here via the member's caller-driven ``step()`` fallback."""
        with self._lock:
            cs = self._require(gsid)
            srv = self._members[cs.member]
            with srv._on_device():
                srv.close_session(cs.lsid)
            del self._local[(cs.member, cs.lsid)]
            del self._sessions[gsid]
            self._snaps.pop(gsid, None)
            if self._log is not None:
                self._log.close(gsid)

    def session_member(self, gsid):
        """The member currently serving the session (observability —
        tests assert who owns what across migrations)."""
        with self._lock:
            return self._require(gsid).member

    def _require(self, gsid) -> _ClusterSession:
        cs = self._sessions.get(gsid)
        if cs is None:
            raise KeyError(f"cluster session {gsid} is not open")
        return cs

    # -- retry seam ----------------------------------------------------------
    def _call_member(self, fn):
        """Run one member call under the transient-fault retry policy
        (``runtime/fault.py``): ``TransientFault``s retry with
        deterministic backoff and are counted; anything else — or an
        exhausted policy — propagates to the caller's fatal path."""
        if self._retry is None:
            return fn()
        return self._retry.call(fn, on_retry=self._count_retry)

    def _count_retry(self, attempt, backoff_s, exc) -> None:
        with self._lock:
            self._retries.inc()
            self.recorder.record("retry", attempt=attempt,
                                 backoff_s=backoff_s,
                                 error=type(exc).__name__)

    # -- federation books (member callbacks) ---------------------------------
    def _journal_admit(self, name, qf) -> None:
        if self._log is None:
            return
        with self._lock:
            gsid = self._local.get((name, qf.sid))
            if gsid is None:
                return
            self._log.record(gsid, t=qf.frame.t, frame=qf.frame,
                             enq_s=qf.enq_s, deadline_s=qf.deadline_s,
                             weight=qf.weight)
            if qf.trace is not None:       # the journal hop, in-span
                qf.trace.add("journal", qf.enq_s, gsid=gsid)

    def _count_result(self, name, r) -> None:
        with self._lock:
            gsid = self._local.get((name, r.sid))
            if gsid is None:       # not cluster-routed (shouldn't happen)
                return
            cs = self._sessions[gsid]
            cs.served += 1
            self._served[cs.qos.value].inc()
            if self._log is not None:
                self._log.settle(gsid, r.t)
            out = replace(r, sid=gsid)
            if self._on_result is None:
                self._results.append(out)
                return
        try:
            self._on_result(out)
        except Exception:          # user code must not kill stepping
            import traceback
            traceback.print_exc()

    def _count_shed(self, name, qf) -> None:
        with self._lock:
            gsid = self._local.get((name, qf.sid))
            if gsid is None:
                return
            cs = self._sessions[gsid]
            cs.shed += 1
            self._shed[cs.qos.value].inc()
            if self._log is not None:
                self._log.settle(gsid, qf.frame.t)

    def drain_results(self) -> list:
        """All ``FrameResult``s (global sids) since the last drain —
        only populated when no ``on_result`` callback is installed."""
        with self._lock:
            out, self._results = self._results, []
        return out

    # -- the stepping loop ---------------------------------------------------
    def step(self) -> int:
        """One cluster iteration: ship pending journal entries to their
        buddies (every ``journal_flush_every`` steps), then step every
        live member once (sorted name order — deterministic), with the
        chaos hooks around each turn: the member's ``FailureInjector``
        may kill it (fatal — handled as a real death), raise a
        ``TransientFault`` (retried per the policy), or HANG it (the
        turn is skipped and no heartbeat lands); its step duration
        feeds the ``StragglerMonitor`` (a flagged member's ring share
        shrinks).  After the turns, heartbeat suspicion fails over any
        member silent past the threshold, and every ``snapshot_every``
        steps each session is checkpointed for failure recovery.
        Returns frames delivered cluster-wide."""
        served = 0
        with self._lock:
            self._steps += 1
            if self._log is not None and \
                    self._steps % self._flush_every == 0:
                self._log.flush_all()
            for name in sorted(self._members):
                srv = self._members[name]
                if srv._thread is not None and srv._thread.is_alive():
                    raise RuntimeError(
                        f"member {name!r} started its own serving thread "
                        "after joining — the cluster owns stepping")
                inj = self._injectors.get(name)
                if inj is not None and inj.hanging(self._steps):
                    continue       # stuck: no progress, no beat
                t0 = self._timer()
                def turn(_srv=srv, _inj=inj):
                    if _inj is not None:
                        _inj.maybe_fail(self._steps)
                    with _srv._on_device():
                        return _srv.step()
                try:
                    served += self._call_member(turn)
                except Exception as e:      # noqa: BLE001 — death seam
                    self._member_failed(name, e)
                    continue
                if self._health is not None:
                    self._health.beat(name)
                mon = self._stragglers.get(name)
                if mon is not None and mon.record(self._steps,
                                                  self._timer() - t0):
                    if (self._ring.has(name) and self._ring.weight(name)
                            != self._straggler_weight):
                        self._ring.set_weight(name,
                                              self._straggler_weight)
            if self._health is not None:
                for name, silent in self._health.suspects():
                    if name in self._members:
                        self._member_failed(name, MemberHungError(
                            name, silent, self._health.suspect_after_s))
            if (self._snapshot_every
                    and self._steps % self._snapshot_every == 0):
                self._checkpoint_all()
        return served

    def pump(self, max_steps: int = 100_000) -> int:
        """Step until no member holds queued, staged, or in-flight work
        — the stepped-mode drain.  Returns frames delivered."""
        served = 0
        for _ in range(max_steps):
            with self._lock:
                if not any(s.busy() for s in self._members.values()):
                    return served
            served += self.step()
        raise RuntimeError(f"cluster did not drain in {max_steps} steps")

    def start(self) -> "GatewayCluster":
        """Background stepping thread (optional — tests and benchmarks
        drive ``step()``/``pump()`` directly for determinism)."""
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return self
            self._stopping = False
            self._thread = threading.Thread(target=self._loop,
                                            name="streamsplit-cluster",
                                            daemon=True)
            self._thread.start()
        return self

    def stop(self, *, drain: bool = True, timeout: float = 60.0,
             max_steps: int = 100_000):
        """Stop the stepping thread, then (``drain=True``) pump every
        member empty.  A drain that stalls — a member wedged, a stream
        that cannot finish within ``max_steps`` — no longer exits
        through an anonymous pump error: it raises the typed
        ``ClusterDrainTimeout`` naming every straggler session and its
        outstanding frame count, and the stragglers are counted into
        ``ClusterStats.drain_stragglers``."""
        self._stopping = True
        t = self._thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout)
            if t.is_alive():
                raise TimeoutError("cluster stepping thread did not stop")
        self._thread = None
        if drain:
            try:
                self.pump(max_steps)
            except RuntimeError as e:
                with self._lock:
                    strag = {g: cs.outstanding
                             for g, cs in sorted(self._sessions.items())
                             if cs.outstanding > 0}
                    self._drain_stragglers.inc(len(strag))
                    for g, n in strag.items():
                        self.recorder.record("drain_straggler", gsid=g,
                                             outstanding=n)
                raise ClusterDrainTimeout(strag, max_steps) from e
        return self

    def _loop(self):
        while not self._stopping:
            if self.step() == 0:
                with self._lock:
                    idle = not any(s.busy()
                                   for s in self._members.values())
                if idle:
                    time.sleep(0.001)

    # -- migration -----------------------------------------------------------
    def _owner_live(self, gsid):
        for name in self._ring.preference(gsid):
            if name in self._members:
                return name
        return None

    def _rebalance(self) -> int:
        """Move ONLY sessions whose ring ownership changed (membership
        or weight change) — the consistent-hash contract."""
        moved = 0
        for gsid, cs in list(self._sessions.items()):
            want = self._owner_live(gsid)
            if want is not None and want != cs.member:
                self._migrate(gsid)
                moved += 1
        return moved

    def _rehome_journal(self, gsid) -> None:
        """Keep the session's journal on a live member that is not its
        owner (the buddy invariant); a conflicting or missing buddy
        re-ships the journal, metered."""
        if self._log is None:
            return
        j = self._log.journal(gsid)
        if j is None:
            return
        cs = self._sessions[gsid]
        if (j.buddy is None or j.buddy == cs.member
                or j.buddy not in self._members):
            self._log.rehome(
                gsid, self._ring.buddy(gsid, exclude=(cs.member,)))

    def _rehome_journals(self) -> None:
        if self._log is not None:
            for gsid in list(self._sessions):
                self._rehome_journal(gsid)

    def _refresh_checkpoint(self, gsid) -> None:
        """Re-checkpoint a session on its (new) owner right after a
        move — the old checkpoint predates the move and a destructive
        snapshot must never double as one.  A freshly imported session
        has no frames in any in-flight plan, so this needs no quiesce."""
        cs = self._sessions[gsid]
        if self._snapshot_every or self._replicate:
            self._snaps[gsid] = self._members[cs.member] \
                .checkpoint_session(cs.lsid)
            if self._log is not None:
                self._log.checkpointed(gsid)
        else:
            self._snaps.pop(gsid, None)

    def _migrate(self, gsid) -> None:
        """Move one session to its ring-preferred live member: quiesce
        the source, export (books + row + queued frames leave with
        their ledger), import at the first member with headroom.  If NO
        member can take it, the session is restored onto the source and
        the admission error propagates — a failed migration never loses
        a stream."""
        cs = self._sessions[gsid]
        src_name, src = cs.member, self._members[cs.member]
        t0 = self._timer()
        src.quiesce()
        snap = src.export_session(cs.lsid)
        del self._local[(src_name, cs.lsid)]
        last = None
        for tname in self._ring.preference(gsid):
            tsrv = self._members.get(tname)
            if tsrv is None or tname == src_name:
                continue
            try:
                info = tsrv.import_session(snap)
            except AdmissionError as e:
                last = e
                continue
            cs.member, cs.lsid = tname, info.sid
            self._local[(tname, info.sid)] = gsid
            self._migrations.inc()
            moved = len(snap.server.queued) if snap.server else 0
            self._migrated_frames.inc(moved)
            self._migrated_bytes.inc(snap.nbytes)
            pause = (self._timer() - t0) * 1e3
            self._pause_ms.append(pause)
            self._pause_hist.observe(pause)
            self.recorder.record("migrate_out", gsid=gsid, src=src_name,
                                 dst=tname, frames=moved,
                                 pause_ms=pause)
            self._refresh_checkpoint(gsid)
            self._rehome_journal(gsid)
            return
        # nobody could take it: put it back where it came from
        info = src.import_session(snap)
        cs.lsid = info.sid
        self._local[(src_name, info.sid)] = gsid
        if last is not None:
            raise last
        raise RuntimeError(f"no migration target for session {gsid}")

    # -- failure recovery ----------------------------------------------------
    def _checkpoint_all(self) -> None:
        quiesced = set()
        for gsid, cs in list(self._sessions.items()):
            srv = self._members.get(cs.member)
            if srv is None:
                continue
            if cs.member not in quiesced:   # checkpoint needs no plan
                srv.quiesce()               # in flight (migration-safe)
                quiesced.add(cs.member)
            try:
                self._snaps[gsid] = self._call_member(
                    lambda _s=srv, _c=cs: _s.checkpoint_session(_c.lsid))
            except KeyError:
                continue                    # closing under us
            except TransientFault:
                continue   # retries exhausted: keep the previous
                #            checkpoint — the journal still bounds loss
            if self._log is not None:
                # the fresh checkpoint is the durable record of every
                # settled frame: those journal entries can go
                self._log.checkpointed(gsid)

    def _member_failed(self, name, exc) -> None:
        """A member died (raised) or hung (heartbeat suspicion) — the
        same recovery path either way.  Every session it homed resumes
        on a survivor from its last checkpoint; with replication, the
        buddy journal's open entries replay on top through the ordinary
        ``import_session`` implant, so only frames whose journal append
        never reached the buddy are counted into ``lost_in_flight``.
        Journals HOMED on the dead member lose their shipped data
        (cleared, re-homed — their sessions are exposed until the next
        checkpoint).  Sessions with neither checkpoint nor journal are
        dropped visibly (``lost_sessions``).  The whole recovery lands
        in the flight recorder, and an automatic dump is appended to
        ``failover_dumps`` at the end — the black box survives exactly
        the event it exists to explain."""
        self._failures.inc()
        self.recorder.record(
            "member_hung" if isinstance(exc, MemberHungError)
            else "member_failed",
            member=name, error=type(exc).__name__, detail=str(exc))
        self._dead[name] = self._release_member(name)
        self._injectors.pop(name, None)
        if self._ring.has(name):
            self._ring.remove(name)
        if self._log is not None:
            self._log.drop_member(name)
        for gsid, cs in list(self._sessions.items()):
            if cs.member != name:
                continue
            j = self._log.journal(gsid) if self._log is not None else None
            replay = j.replayable() if j is not None else []
            if j is not None:
                # pending appends die with the owner — it was the
                # shipping side of the transport
                j.entries = [e for e in j.entries if e.acked]
            lost_now = max(0, cs.outstanding - len(replay))
            cs.lost += lost_now
            self._lost[cs.qos.value].inc(lost_now)
            if lost_now:
                self.recorder.record("lost_in_flight", gsid=gsid,
                                     qos=cs.qos.value, frames=lost_now)
            del self._local[(name, cs.lsid)]
            snap = self._snaps.get(gsid)
            restored = False
            if snap is not None:
                sv = snap.server if snap.server is not None else \
                    ServerSessionSnapshot(submitted=0, served=0, shed=0,
                                          weight=1.0)
                queued = tuple(e.snapshot() for e in replay)
                resume = replace(
                    snap, server=replace(
                        sv, submitted=sv.submitted + len(queued),
                        queued=queued))
                for tname in self._ring.preference(gsid):
                    tsrv = self._members.get(tname)
                    if tsrv is None:
                        continue
                    offer = resume
                    if tsrv.tracer.enabled and queued:
                        # journal-replay trace continuity: the replayed
                        # frame keeps its ORIGINAL enqueue timestamp in
                        # the implant; its span begins (adopt, not
                        # maybe_begin — the real submit died with the
                        # owner) at the replay hop, sampled by the
                        # cluster-stable (gsid, t) decision
                        tq = tuple(
                            replace(qs, trace=tsrv.tracer.adopt(
                                gsid, qs.frame.t, "replay",
                                enq_s=qs.enq_s, member=tname))
                            for qs in queued)
                        offer = replace(resume, server=replace(
                            offer.server, queued=tq))
                    try:
                        info = tsrv.import_session(offer)
                    except AdmissionError:
                        continue
                    cs.member, cs.lsid = tname, info.sid
                    self._local[(tname, info.sid)] = gsid
                    self._failovers.inc()
                    self._replayed_frames.inc(len(queued))
                    self.recorder.record("failover", gsid=gsid,
                                         src=name, dst=tname,
                                         replayed=len(queued),
                                         lost=lost_now)
                    if queued:
                        self.recorder.record("journal_replay", gsid=gsid,
                                             dst=tname,
                                             frames=len(queued))
                    self._refresh_checkpoint(gsid)
                    self._rehome_journal(gsid)
                    restored = True
                    break
            if not restored:
                # the replayable frames found no home either: they are
                # lost WITH the session — counted, like everything here
                cs.lost += len(replay)
                self._lost[cs.qos.value].inc(len(replay))
                del self._sessions[gsid]
                self._snaps.pop(gsid, None)
                if self._log is not None:
                    self._log.close(gsid)
                self._lost_sessions.append(gsid)
                self.recorder.record("lost_in_flight", gsid=gsid,
                                     qos=cs.qos.value,
                                     frames=len(replay),
                                     session_lost=True)
        # the automatic black-box dump, AFTER every recovery decision
        # above was recorded — bounded like everything always-on
        self.failover_dumps.append(
            self.recorder.dump(reason=f"member_failed:{name}"))
        del self.failover_dumps[:-_DUMP_KEEP]

    @property
    def migration_pauses_ms(self) -> tuple:
        """Every migration pause so far, in move order (ms) — the
        percentile summary is in ``stats()``; the drain lane
        (``runtime/cluster_serve.py``) slices this to separate cold
        (first moves to a receiver) from warm steady-state pauses."""
        with self._lock:
            return tuple(self._pause_ms)

    @property
    def lost_sessions(self) -> list:
        """Global sids dropped at member death with no checkpoint to
        restore from — explicit, like every other loss here."""
        with self._lock:
            return list(self._lost_sessions)

    # -- observability -------------------------------------------------------
    def stats(self) -> ClusterStats:
        """One consistent federation snapshot — taken under the cluster
        lock, which every frame transition (submit, member step with
        its callbacks, migration, death) also holds, so the
        ``ClusterStats.conserved`` identity holds at EVERY snapshot."""
        with self._lock:
            member_stats = {n: self._members[n].stats()
                            for n in sorted(self._members)}
            depth = {q.value: 0 for q in QoSClass}
            infl = {q.value: 0 for q in QoSClass}
            for st in member_stats.values():
                for c, v in st.queue_depth.items():
                    depth[c] += v
                for c, v in st.in_flight.items():
                    infl[c] += v
            # percentiles from the registry sketch — exact (bit-identical
            # to numpy.percentile) below its exact_cap, which every
            # realistic migration count sits under
            s = self._pause_hist.summary()
            pause = {"p50": s["p50"], "p95": s["p95"], "max": s["max"]}
            self._g_sessions.set(len(self._sessions))
            self._g_members.set(len(self._members))
            def _view(d):
                return {c: m.value for c, m in d.items()}
            return ClusterStats(
                members=tuple(sorted(self._members)),
                sessions_open=len(self._sessions),
                submitted=_view(self._submitted),
                served=_view(self._served),
                queue_depth=depth,
                in_flight=infl,
                shed_expired=_view(self._shed),
                lost_in_flight=_view(self._lost),
                rejected_full=_view(self._rejected_full),
                rejected_rate_limited=_view(self._rejected_rl),
                migrations=self._migrations.value,
                migrated_frames=self._migrated_frames.value,
                migrated_bytes=self._migrated_bytes.value,
                migration_pause_ms=pause,
                drains=self._drains.value,
                failures=self._failures.value,
                ring_share=self._ring.share(),
                member_stats=member_stats,
                degraded=self._degraded(),
                failovers=self._failovers.value,
                retries=self._retries.value,
                replayed_frames=self._replayed_frames.value,
                journal_bytes=(self._log.bytes_shipped
                               if self._log is not None else 0),
                rejected_degraded=_view(self._rejected_degraded),
                drain_stragglers=self._drain_stragglers.value)

    def metrics(self) -> str:
        """The federation registry (``cluster_*`` metrics) in
        Prometheus text exposition format.  Member-level metrics live
        on each member's own registry (``member.metrics()``) — a dead
        member's series disappear with it, by design; the cluster
        series are the ones that survive."""
        with self._lock:
            self._g_sessions.set(len(self._sessions))
            self._g_members.set(len(self._members))
        return to_prometheus(self.registry)

    def dump_trace(self, reason: str = "on_demand") -> dict:
        """Flight-recorder dump of the federation black box (see also
        ``failover_dumps`` for the automatic per-failure dumps)."""
        return self.recorder.dump(reason=reason)
