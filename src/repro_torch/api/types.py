"""Typed request/response surface of the StreamSplit gateway.

Port of ``repro.api.types``, serving half: a client session
``submit``s ``FrameRequest``s, the gateway ``tick`` turns them into
``FrameResult``s, and ``GatewayStats`` is the serving plane's
scoreboard; ``StreamStats``, ``ResourceSignals`` and the server half of
a ``SessionSnapshot`` belong to the streaming runtime
(``repro_torch.serving``); ``ClusterStats`` and the two typed cluster
refusals belong to the federation (``repro_torch.cluster``).  Everything
here is a frozen dataclass of host values (numpy arrays, Python
scalars), never a tensor.
"""
from __future__ import annotations

import pickle
from dataclasses import dataclass, field
from enum import Enum

import numpy as np

from repro_torch.core.fleet_buffer import FleetFullError
from repro_torch.core.sync import SyncCfg


class QoSClass(Enum):
    """Admission class of a session.

    ``INTERACTIVE`` sessions may use every fleet row; ``STANDARD`` and
    ``BULK`` are refused progressively earlier so that headroom remains
    for latency-sensitive tenants (see ``StreamSplitGateway.open_session``).
    """

    INTERACTIVE = "interactive"
    STANDARD = "standard"
    BULK = "bulk"


class AdmissionError(FleetFullError):
    """Typed admission failure of ``open_session``: a ``FleetFullError``
    carrying the refused class and the fleet's fill at refusal time."""

    def __init__(self, qos: QoSClass, n_active: int, capacity: int):
        self.qos = qos
        self.n_active = n_active
        self.capacity = capacity
        super().__init__(
            f"admission refused for {qos.value} session: "
            f"{n_active}/{capacity} fleet rows in use")


class ClusterDegradedError(RuntimeError):
    """Typed degraded-mode refusal of a ``GatewayCluster``
    (``repro_torch.cluster``): live capacity fell below the configured
    watermark, so new sessions are refused and BULK frames are shed at
    the door — the surviving members' headroom is reserved for the
    streams they already hold.  Counted
    (``ClusterStats.rejected_degraded``), never silent; the refused
    work never enters ``submitted``, so conservation is untouched."""

    def __init__(self, live: int, expected: int, watermark: float,
                 what: str = "admission"):
        self.live = live
        self.expected = expected
        self.watermark = watermark
        super().__init__(
            f"cluster degraded: {live}/{expected} members live "
            f"(watermark {watermark:.2f}) — {what} refused until "
            "capacity recovers")


class ClusterDrainTimeout(RuntimeError):
    """Typed drain-stall summary of ``GatewayCluster.stop(drain=True)``:
    the step budget ran out with frames still outstanding.  ``stragglers``
    maps each stuck session's global sid to its outstanding frame count
    (submitted but neither served, shed, nor counted lost)."""

    def __init__(self, stragglers: dict, steps: int):
        self.stragglers = dict(stragglers)
        self.steps = steps
        super().__init__(
            f"cluster drain stalled after {steps} steps: "
            f"{len(self.stragglers)} session(s) still hold "
            f"{sum(self.stragglers.values())} outstanding frame(s) "
            f"(gsids {sorted(self.stragglers)})")


@dataclass(frozen=True)
class FrameRequest:
    """One client frame: the mel payload plus the client-side telemetry
    the split policy consumes.

    ``t`` is the session-local absolute frame index (the temporal-buffer
    key).  ``u`` / ``cpu`` are normalized to [0, 1] like the control-plane
    observation ``s_t = [U_t, R_cpu, B_net]``; ``bandwidth_mbps`` is raw
    so the lazy sync protocol can apply its Wi-Fi threshold.
    """

    t: int
    mel: np.ndarray            # (frames, n_mels) — one sample, no batch dim
    label: int = -1
    u: float = 0.5             # GMM-entropy uncertainty U_t
    cpu: float = 0.25          # edge CPU load fraction
    bandwidth_mbps: float = 10.0
    charging: bool = False     # lazy-sync weight-push eligibility


@dataclass(frozen=True)
class FrameResult:
    """What came back for one frame after the tick's bucketed dispatch."""

    sid: int
    t: int
    z: np.ndarray              # (d_embed,) l2-normalized embedding
    route: str                 # "edge" (k=L) | "server" (k=0) | "split"
    k: int                     # split index the policy chose
    wire_bytes: int            # synchronous split-link payload (0 at k=L)
    # dispatch wall-clock per frame: the tick's dispatch time over its
    # frames on the overlapped plane; per bucket under tick(profile=True)
    latency_ms: float
    bucket_size: int           # how many frames shared this dispatch
    shard: int = 0             # dispatch shard (0: the port has one)


@dataclass(frozen=True)
class SessionInfo:
    """Point-in-time snapshot of one session."""

    sid: int
    platform: str
    qos: QoSClass
    frames: int                # frames served through the gateway
    wire_bytes: int            # cumulative split-link bytes
    sync_bytes: int            # cumulative lazy-sync downlink bytes
    sync_events: int
    transitions: int           # split-index changes (atomic transitions)
    last_k: int                # -1 before the first served frame
    fill_fraction: float       # of the server-side temporal ring


@dataclass(frozen=True)
class QueuedFrameSnapshot:
    """One queued-but-unserved frame inside a ``SessionSnapshot`` —
    enough to re-enqueue it on another server with its ORIGINAL arrival
    time and deadline (migration must not grant waiting frames a fresh
    deadline budget, nor steal the wait they already paid)."""

    frame: FrameRequest
    enq_s: float               # original submit time (caller clock)
    deadline_s: float          # original deadline — survives migration
    preemptions: int = 0
    promoted: bool = False
    weight: float = 1.0
    # the frame's live FrameTrace (repro_torch.obs.trace) when it is
    # sampled — the span migrates with it (None when tracing is off)
    trace: object = None


@dataclass(frozen=True)
class ServerSessionSnapshot:
    """The streaming-runtime half of a ``SessionSnapshot``: per-session
    conservation books, fair-share weight, token-bucket level, and every
    frame still waiting in the QoS queues (oldest first)."""

    submitted: int             # frames accepted into the queues
    served: int                # frames delivered as FrameResults
    shed: int                  # frames visibly shed past the horizon
    weight: float              # STANDARD DRR fair-share weight
    # (rate_per_s, burst, tokens, last_refill_s) or None — the bucket
    # level migrates so a rate-limited tenant cannot reset its budget by
    # riding a rebalance
    bucket: tuple | None = None
    queued: tuple = ()         # QueuedFrameSnapshot, oldest first


@dataclass(frozen=True)
class SessionSnapshot:
    """Everything one session *is*, frozen and serializable — the unit
    of live migration between gateways: the gateway's per-session books,
    the lazy-sync protocol state, and the fleet ring row in the host
    representation.  ``server`` carries the streaming runtime's half
    when the session was exported from a ``StreamServer`` (None from a
    bare gateway)."""

    platform: str
    qos: QoSClass
    # gateway per-session books
    frames: int
    wire_bytes: int
    transitions: int
    last_k: int
    # lazy-sync protocol state (core/sync.py)
    sync_cfg: SyncCfg
    sync_last_gmm: int
    sync_last_weights: int
    sync_total_bytes: int
    sync_total_energy_j: float
    sync_events: tuple         # emitted SyncEvents, oldest first
    # fleet ring row (host representation; see FleetBackend.export_row)
    ring_z: np.ndarray         # (W, d) float32
    ring_t: np.ndarray         # (W,) int64, T_SENTINEL marks empty slots
    ring_label: np.ndarray     # (W,) int64
    ring_newest: int
    server: ServerSessionSnapshot | None = None
    version: int = 1

    def to_bytes(self) -> bytes:
        return pickle.dumps(self, protocol=pickle.HIGHEST_PROTOCOL)

    @staticmethod
    def from_bytes(payload: bytes) -> "SessionSnapshot":
        """Unpickles: pass only bytes this program wrote."""
        snap = pickle.loads(payload)
        if not isinstance(snap, SessionSnapshot):
            raise TypeError("payload is not a SessionSnapshot")
        return snap

    @property
    def nbytes(self) -> int:
        return len(self.to_bytes())


@dataclass(frozen=True)
class GatewayStats:
    """Aggregate serving-plane counters (one pipeline, one scoreboard)."""

    ticks: int
    frames: int
    sessions_open: int
    sessions_opened: int
    sessions_closed: int
    admission_refusals: int
    dispatches: int            # k-bucket SplitEngine dispatches issued
    wire_bytes: int
    sync_bytes: int            # lazy-sync downlink across all sessions
    sync_events: int
    refine_rounds: int
    last_refine_loss: float    # nan before the first round
    routed: dict               # route -> frame count ("edge"/"split"/"server")
    backend: str = "host"      # FleetBackend.kind
    shards: int = 1            # session shards of the fleet backend
    shard_frames: tuple = ()   # frames ingested per session shard
    dispatch_shards: int = 1   # devices the tick dispatch spreads over
    dispatch_shard_frames: tuple = ()  # frames dispatched per shard
    snapshot_h2d_bytes: int = 0  # fleet snapshot bytes copied per refine
    ingest_h2d_bytes: int = 0  # frame payload bytes moved host->device
    # the overlapped tick syncs ONCE and copies embeddings to the host
    # ONCE, however many buckets it has; both count the last tick
    device_syncs_per_tick: int = 0
    d2h_copies_per_tick: int = 0
    staged_h2d_bytes: int = 0  # cumulative mel bytes staged host->device
    uptime_s: float = 0.0      # clock() - clock() at construction
    last_tick_ms: float = 0.0  # wall-clock of the most recent tick
    sessions_exported: int = 0
    sessions_imported: int = 0

    @property
    def frames_per_dispatch(self) -> float:
        """The batching win: 1.0 is the per-frame loop; N/buckets when
        k-bucketing collapses a tick into few dispatches."""
        return self.frames / self.dispatches if self.dispatches else 0.0


@dataclass(frozen=True)
class StreamStats:
    """Point-in-time scoreboard of the streaming serving runtime
    (``repro_torch.serving.StreamServer``).

    Every per-class dict is keyed by the ``QoSClass.value`` strings
    (``"interactive"``/``"standard"``/``"bulk"``) so the whole snapshot
    is JSON-serializable as-is.  Conservation is an invariant, not a
    hope: per class, ``frames_submitted == frames_served + queue_depth
    + in_flight + shed_expired`` at every snapshot, and ``preempted ==
    requeued`` always — a preempted frame goes back to the front of its queue; a
    frame only ever leaves the system as a served ``FrameResult`` or as
    a *counted* shed (deadline expired past the configured horizon),
    never silently.  Frames refused at submit raise a typed error and
    count WITHOUT entering ``frames_submitted``: ``QueueFullError`` →
    ``rejected_full`` (bounded queue) and ``RateLimitError`` →
    ``rejected_rate_limited`` (per-session token bucket).
    """

    running: bool              # serving thread alive right now
    ticks: int                 # ticks the runtime has collected
    pipelined_ticks: int       # launched while the previous tick's chains
    #                            were still in flight (cross-tick overlap)
    frames_submitted: dict     # class -> frames accepted into the queues
    frames_served: dict        # class -> frames delivered as FrameResults
    queue_depth: dict          # class -> frames waiting (queued + staged)
    in_flight: dict            # class -> frames launched, not yet collected
    rejected_full: dict        # class -> bounded-queue refusals at submit
    rejected_rate_limited: dict  # class -> token-bucket refusals at submit
    preempted: dict            # class -> frames bumped from a staged tick
    requeued: dict             # class -> preempted frames put back (== preempted)
    shed_expired: dict         # class -> frames dropped visibly: deadline
    #                            expired past SchedulerCfg.shed_horizon_ms
    promoted: dict             # class -> frames staged via the aging lane
    #                            (waited past SchedulerCfg.max_wait_ms)
    deadline_misses: dict      # class -> frames admitted past their deadline
    #                            PLUS shed frames (starved-in-queue misses
    #                            are counted at shed time, not hidden)
    queue_wait_ms: dict        # class -> {"p50","p95","mean","max"} wait
    #                            between submit and tick admission (shed
    #                            frames sample their terminal wait too)
    gateway: GatewayStats      # the dispatch-plane scoreboard underneath


@dataclass(frozen=True)
class ClusterStats:
    """Cluster-wide scoreboard of a ``GatewayCluster``
    (``repro_torch.cluster``).

    Per-class dicts are keyed by ``QoSClass.value`` strings, like
    ``StreamStats``.  The cluster keeps its OWN conservation books at
    the federation boundary — ``submitted`` counts accepted
    ``GatewayCluster.submit`` calls, ``served``/``shed_expired`` count
    delivery/shed callbacks — so the invariant survives member death
    (a dead member's counters are unreadable; the frames it held are
    never silently forgotten, they land in ``lost_in_flight``):

        submitted == served + queue_depth + in_flight
                     + shed_expired + lost_in_flight      (per class)

    at every snapshot, where ``queue_depth``/``in_flight`` sum over the
    LIVE members.  ``conserved`` checks it.
    """

    members: tuple             # live member names, routing order
    sessions_open: int
    submitted: dict            # class -> frames accepted by the cluster
    served: dict               # class -> FrameResults delivered
    queue_depth: dict          # class -> waiting frames over live members
    in_flight: dict            # class -> launched-not-collected frames
    shed_expired: dict         # class -> visible sheds (cluster-tracked)
    lost_in_flight: dict       # class -> frames lost to member failure —
    #                            explicitly counted, never silent
    rejected_full: dict        # class -> bounded-queue refusals
    rejected_rate_limited: dict  # class -> token-bucket refusals
    migrations: int            # sessions moved between members
    migrated_frames: int       # queued frames replayed on a new owner
    migrated_bytes: int        # serialized SessionSnapshot payload bytes
    migration_pause_ms: dict   # {"p50","p95","max"} per-session pause
    drains: int                # completed drain() calls
    failures: int              # members lost and recovered from
    ring_share: dict           # member -> owned fraction of hash space
    member_stats: dict         # member -> StreamStats (live members)
    # self-healing federation (cluster/{replication,health}.py):
    degraded: bool = False     # live capacity below the watermark NOW
    failovers: int = 0         # sessions restored onto a survivor
    retries: int = 0           # transient member faults retried away
    replayed_frames: int = 0   # journal entries re-queued by failovers
    journal_bytes: int = 0     # bytes shipped over the owner->buddy seam
    rejected_degraded: dict = field(default_factory=dict)
    #                            class -> degraded-mode door refusals
    #                            (not in ``submitted``, like other rejects)
    drain_stragglers: int = 0  # sessions stuck at a stop(drain=True)
    #                            timeout (see ClusterDrainTimeout)

    @property
    def conserved(self) -> bool:
        """The cluster-wide per-class conservation identity."""
        return all(
            self.submitted[c] == self.served[c] + self.queue_depth[c]
            + self.in_flight[c] + self.shed_expired[c]
            + self.lost_in_flight[c]
            for c in (q.value for q in QoSClass))


@dataclass(frozen=True)
class ResourceSignals:
    """The serving plane's resource state as a control-plane
    observation (``StreamServer.resource_signals()``).

    This is the view the paper's RL splitter needs beside embedding
    ambiguity — "real-time resource monitoring" (the paper's §1).
    Everything is derived from the metrics registry at call time: queue
    pressure (depth over capacity), tail latency (p95 admission wait + the
    always-on EWMA stage timings), and loss pressure (shed/reject
    fraction of recent submissions).  ``as_observation()`` flattens to
    a normalized float vector shaped like the existing ``SplitPolicy``
    observation convention (each component in [0, 1] or clamped there).
    """

    queue_depth: int           # frames waiting across all classes
    queue_fill: float          # depth / total capacity, in [0, 1]
    in_flight: int             # frames launched, not yet collected
    wait_p95_ms: float         # p95 submit->admit wait (sketch)
    stage_ewma_ms: float       # EWMA tick launch+collect span
    shed_rate: float           # shed / submitted (cumulative), [0, 1]
    reject_rate: float         # refused / offered at the door, [0, 1]
    throughput_fps: float      # frames served per second of uptime

    def as_observation(self) -> "np.ndarray":
        """Normalized float32 vector for a ``SplitPolicy``: load,
        latency (saturating at 1s), and loss pressure."""
        return np.asarray(
            [min(1.0, max(0.0, self.queue_fill)),
             min(1.0, self.wait_p95_ms / 1e3),
             min(1.0, self.stage_ewma_ms / 1e3),
             min(1.0, max(0.0, self.shed_rate)),
             min(1.0, max(0.0, self.reject_rate))],
            dtype=np.float32)
