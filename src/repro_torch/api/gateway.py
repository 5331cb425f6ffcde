"""``StreamSplitGateway`` — the way to run the StreamSplit pipeline.

Port of ``repro.api.gateway`` (the sharded dispatch plane is a later
slice):

    gw = StreamSplitGateway(enc_cfg, params, policy=make_policy("rule", L))
    info = gw.open_session(platform="pi4", qos=QoSClass.STANDARD)
    gw.submit(info.sid, FrameRequest(t=0, mel=mel, u=0.3))
    results = gw.tick()          # decide -> k-bucketed dispatch -> ingest
    gw.close_session(info.sid)

The tick is an **overlapped, single-sync data plane**.  One tick:

1. the policy decides k for every pending frame, and frames with the
   same k form a bucket, padded to a power of two with its first frame;
2. the tick's mels, padded to a power of two in rows, and the int32
   gather indices of every bucket and of the reassembly travel to the
   device in ONE pinned host->device copy;
3. each bucket gathers its rows on the device (``index_select``) and
   runs edge -> wire kernel -> server on the current stream, without
   waiting;
4. one gather puts the embeddings back in submission order, one
   non-blocking copy takes them to pinned host memory and an event is
   recorded behind it — the end of ``tick_launch``; ``tick_collect``
   waits ONCE (``_block``), on that event alone, before reading them;
5. the embeddings go into the fleet rings;
6. every ``refine_every`` ticks, one fleet refine round
   (``HostFleetBackend.refine``) takes an SGD step on the shared head and
   an EM step of the optional GMM memory.

``_block`` and ``_d2h`` count every wait and every embedding copy, so
``GatewayStats.device_syncs_per_tick == 1`` and ``d2h_copies_per_tick
== 1`` are counted facts.  Because each tick waits for its own event and
not for the stream, a caller that launches tick t+1 before it collects
tick t (``StreamServer``'s pipeline) runs t+1's chains on the device
while t is delivered.  A refine round waits for its own loss and
copies its own snapshot; as in the reference, neither is on that
scoreboard (``snapshot_h2d_bytes`` counts the copy).  ``overlap=False``
keeps the per-bucket-sync dispatch as the baseline, and
``tick(profile=True)`` waits after each bucket to time it.  All
wall-clock reads go through the injectable ``clock=``.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.api.policies import SplitPolicy
from repro_torch.api.types import (AdmissionError, FrameRequest, FrameResult,
                                   GatewayStats, QoSClass, SessionInfo,
                                   SessionSnapshot)
from repro_torch.core.env import EdgeCloudEnv
from repro_torch.core.fleet_backend import HostFleetBackend
from repro_torch.core.fleet_buffer import FleetFullError, pad_pow2
from repro_torch.core.splitter import SplitEngine
from repro_torch.core.sync import LazySync, SyncCfg
from repro_torch.kernels.ops import resolve_device
from repro_torch.obs import MetricsRegistry, to_prometheus
from repro_torch.weights import to_device


class TickPlan:
    """One in-flight overlapped tick, between ``tick_launch`` and
    ``tick_collect``: the launched device chains plus the host context
    needed to deliver their results."""

    __slots__ = ("pending", "t0", "profile", "launched", "z_all", "z_host",
                 "done", "t_d0", "syncs", "d2h", "seq")

    def __init__(self, pending, t0, profile=False, seq=0):
        self.pending = pending     # [(sid, FrameRequest, mel f32)] served
        self.t0 = t0               # clock at tick_launch entry
        self.profile = profile
        self.launched = []         # (k, idx, wire bytes, bucket ms, shard)
        self.z_all = None          # (n, d) device embeddings, in flight
        self.z_host = None         # their pinned host copy, in flight
        self.done = None           # CUDA event behind that copy
        self.t_d0 = t0             # clock at dispatch start
        self.syncs = 0             # launch-phase waits (profile mode only)
        self.d2h = 0
        self.seq = seq             # launch order — collect must match

    def __len__(self):
        return len(self.pending)


class _Session:
    """Mutable per-session record (the API hands out frozen
    ``SessionInfo`` snapshots only)."""

    __slots__ = ("sid", "platform", "qos", "sync", "frames", "wire_bytes",
                 "transitions", "last_k")

    def __init__(self, sid, platform, qos, sync_cfg):
        self.sid = sid
        self.platform = platform
        self.qos = qos
        self.sync = LazySync(sync_cfg)
        self.frames = 0
        self.wire_bytes = 0
        self.transitions = 0
        self.last_k = -1


class StreamSplitGateway:
    """Session/gateway layer over the whole edge–cloud pipeline.

    Parameters
    ----------
    enc_cfg, params : the audio encoder config and its weights (port
        layout, see ``repro_torch.weights``); the weights are moved to
        ``device`` once, here.
    policy : a batched ``SplitPolicy``.
    backend : a ``FleetBackend``; defaults to a ``HostFleetBackend`` of
        ``capacity`` x ``window`` rows of ``enc_cfg.d_embed`` built from
        ``head_init`` / ``head_apply`` / ``refine_lr`` / ``seed`` on
        ``device``.  A backend that refines on another device raises.
    head_init, head_apply : optional task head for fleet refinement
        (``head_init(generator) -> params``, ``head_apply(params, z) ->
        logits``); without them the gateway serves but never refines.
    refine_every : one fleet refine round every this many ticks (0
        disables); round r's SWD draw is seeded from ``(seed, r)``.
    qos_reserve : fleet rows held back from BULK (2x) and STANDARD (1x)
        admissions; defaults to ``capacity // 8``.
    overlap : serve ticks through the overlapped single-sync plane
        (default); ``False`` syncs and copies once per bucket.
    shard_dispatch : the sharded dispatch plane is not ported; ``True``
        raises.
    clock : zero-arg callable returning seconds.
    device : where the model runs; ``"cuda"`` by default, which raises
        without a GPU — pass ``"cpu"`` for the plain PyTorch path.
    """

    def __init__(self, enc_cfg, params, *, policy: SplitPolicy,
                 backend=None, capacity=64, window=100, head_init=None,
                 head_apply=None, refine_every=0, quantize_wire=True,
                 sync_cfg=None, qos_reserve=None, refine_lr=1e-2, seed=0,
                 overlap=True, shard_dispatch=None, clock=time.perf_counter,
                 registry: MetricsRegistry | None = None, device="cuda"):
        if policy.L != enc_cfg.n_blocks:
            raise ValueError(
                f"policy action space L={policy.L} != encoder "
                f"n_blocks={enc_cfg.n_blocks}")
        if shard_dispatch:
            raise NotImplementedError(
                "shard_dispatch (per-device chains over a sharded fleet) is "
                "not ported yet: it is the sharded slice of the port")
        self.device = resolve_device(device)
        self._cuda = self.device.type == "cuda"
        self.cfg = enc_cfg
        self.params = to_device(params, self.device)
        self.policy = policy
        self.engine = SplitEngine(enc_cfg, quantize_wire=quantize_wire,
                                  device=self.device)
        if backend is None:
            backend = HostFleetBackend(
                capacity=capacity, window=window, dim=enc_cfg.d_embed,
                head_init=head_init, head_apply=head_apply, lr=refine_lr,
                seed=seed, device=self.device)
        elif backend.dim != enc_cfg.d_embed:
            raise ValueError(
                f"backend dim={backend.dim} != encoder "
                f"d_embed={enc_cfg.d_embed}")
        if backend.can_refine and backend.device != self.device:
            raise ValueError(f"backend refines on {backend.device}, the "
                             f"gateway runs on {self.device}")
        self.backend = backend
        self.sync_cfg = sync_cfg or SyncCfg()
        self.qos_reserve = (backend.capacity // 8 if qos_reserve is None
                            else qos_reserve)
        self.refine_every = refine_every
        self.overlap = overlap
        self._dispatch_shard_frames = np.zeros(1, np.int64)
        self._last_profile = None
        self._clock = clock
        self._t_start = clock()
        self._sessions: dict[int, _Session] = {}
        # (sid, request, validated float32 mel) — converted ONCE at submit
        self._pending: list[tuple[int, FrameRequest, np.ndarray]] = []
        # aggregate counters live in the registry; GatewayStats is a view
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        R = self.registry
        self._ticks = R.counter("gateway_ticks")
        self._frames = R.counter("gateway_frames")
        self._opened = R.counter("gateway_sessions_opened")
        self._closed = R.counter("gateway_sessions_closed")
        self._exported = R.counter("gateway_sessions_exported")
        self._imported = R.counter("gateway_sessions_imported")
        self._refusals = R.counter("gateway_admission_refusals")
        self._dispatches = R.counter("gateway_dispatches")
        self._wire_bytes = R.counter("gateway_wire_bytes")
        self._sync_bytes = R.counter("gateway_sync_bytes")
        self._sync_events = R.counter("gateway_sync_events")
        self._refine_rounds = R.counter("gateway_refine_rounds")
        self._last_refine_loss = float("nan")
        self._last_tick_ms = 0.0
        self._routed = {r: R.counter("gateway_routed_frames", route=r)
                        for r in ("edge", "split", "server")}
        self._shard_frames = np.zeros(backend.shards, np.int64)
        # always-on stage timings: one EWMA multiply-add per tick
        self._stage_ewma = {
            stage: R.gauge("gateway_stage_ewma_ms", stage=stage)
            for stage in ("launch", "collect", "tick")}
        self._g_last_tick_ms = R.gauge("gateway_last_tick_ms")
        self._g_syncs = R.gauge("gateway_device_syncs_per_tick")
        self._g_d2h = R.gauge("gateway_d2h_copies_per_tick")
        self._staged_h2d = R.counter("gateway_staged_h2d_bytes")
        self._tick_syncs = 0
        self._tick_d2h = 0
        # plans collect in launch order; a violation raises
        self._launch_seq = 0
        self._collect_seq = 0

    # -- session lifecycle ---------------------------------------------------
    def _admit_row(self, qos: QoSClass) -> int:
        """QoS-headroom-checked fleet-row admission shared by
        ``open_session`` and ``import_session``."""
        free = self.backend.capacity - self.backend.n_active
        need = {QoSClass.INTERACTIVE: 1,
                QoSClass.STANDARD: 1 + self.qos_reserve,
                QoSClass.BULK: 1 + 2 * self.qos_reserve}[qos]
        if free < need:
            self._refusals.inc()
            raise AdmissionError(qos, self.backend.n_active,
                                 self.backend.capacity)
        try:
            return self.backend.admit()
        except FleetFullError:
            self._refusals.inc()
            raise AdmissionError(qos, self.backend.n_active,
                                 self.backend.capacity) from None

    def open_session(self, platform="pi4",
                     qos: QoSClass = QoSClass.STANDARD) -> SessionInfo:
        """Admit a session into the fleet; raises ``AdmissionError`` (a
        ``FleetFullError``) when its QoS class finds no headroom."""
        sid = self._admit_row(qos)
        self._sessions[sid] = _Session(sid, platform, qos, self.sync_cfg)
        self._opened.inc()
        return self.session(sid)

    def session(self, sid) -> SessionInfo:
        s = self._require(sid)
        return SessionInfo(
            sid=s.sid, platform=s.platform, qos=s.qos, frames=s.frames,
            wire_bytes=s.wire_bytes, sync_bytes=s.sync.total_bytes,
            sync_events=len(s.sync.events), transitions=s.transitions,
            last_k=s.last_k, fill_fraction=self.backend.fill_fraction(sid))

    def close_session(self, sid) -> SessionInfo:
        """Evict the session.  Unserved pending frames are discarded."""
        info = self.session(sid)
        self._pending = [p for p in self._pending if p[0] != sid]
        self.backend.evict(sid)
        del self._sessions[sid]
        self._closed.inc()
        return info

    def _require(self, sid) -> _Session:
        if sid not in self._sessions:
            raise KeyError(f"session {sid} is not open")
        return self._sessions[sid]

    # -- live migration seams ---------------------------------------------------
    def export_session(self, sid, *, remove: bool = True) -> SessionSnapshot:
        """Freeze the session's books, lazy-sync state and fleet ring row
        into a ``SessionSnapshot``.  ``remove=True`` also evicts the row
        (counted in ``sessions_exported``).  Raises while the session has
        frames awaiting ``tick()``."""
        s = self._require(sid)
        if any(p[0] == sid for p in self._pending):
            raise RuntimeError(
                f"session {sid} has pending frames awaiting tick(): a "
                "snapshot taken now would silently drop them — tick first")
        ring_z, ring_t, ring_label, newest = self.backend.export_row(sid)
        snap = SessionSnapshot(
            platform=s.platform, qos=s.qos, frames=s.frames,
            wire_bytes=s.wire_bytes, transitions=s.transitions,
            last_k=s.last_k,
            sync_cfg=s.sync.cfg, sync_last_gmm=s.sync.last_gmm,
            sync_last_weights=s.sync.last_weights,
            sync_total_bytes=s.sync.total_bytes,
            sync_total_energy_j=s.sync.total_energy_j,
            sync_events=tuple(s.sync.events),
            ring_z=ring_z, ring_t=ring_t, ring_label=ring_label,
            ring_newest=newest)
        if remove:
            self.backend.evict(sid)
            del self._sessions[sid]
            self._exported.inc()
        return snap

    def import_session(self, snap: SessionSnapshot) -> SessionInfo:
        """Restore an exported session under the same QoS admission
        policy as ``open_session``; it gets a fresh local ``sid``."""
        sid = self._admit_row(snap.qos)
        s = _Session(sid, snap.platform, snap.qos, snap.sync_cfg)
        s.frames = snap.frames
        s.wire_bytes = snap.wire_bytes
        s.transitions = snap.transitions
        s.last_k = snap.last_k
        s.sync.last_gmm = snap.sync_last_gmm
        s.sync.last_weights = snap.sync_last_weights
        s.sync.total_bytes = snap.sync_total_bytes
        s.sync.total_energy_j = snap.sync_total_energy_j
        s.sync.events = list(snap.sync_events)
        self.backend.import_row(sid, snap.ring_z, snap.ring_t,
                                snap.ring_label, snap.ring_newest)
        self._sessions[sid] = s
        self._imported.inc()
        return self.session(sid)

    # -- ingest --------------------------------------------------------------
    def validate_mel(self, mel) -> np.ndarray:
        """Validate one frame's mel payload and return it as float32."""
        mel = np.asarray(mel, np.float32)
        if mel.shape != (self.cfg.frames, self.cfg.n_mels):
            raise ValueError(
                f"frame.mel shape {mel.shape} != "
                f"({self.cfg.frames}, {self.cfg.n_mels}) — submit one "
                "unbatched sample per FrameRequest")
        return mel

    def submit(self, sid, frame: FrameRequest) -> None:
        """Queue one frame for the next ``tick``; the mel is validated
        and converted to float32 here, once."""
        self._require(sid)
        self._pending.append((sid, frame, self.validate_mel(frame.mel)))

    def submit_validated(self, sid, frame: FrameRequest) -> None:
        """``submit`` minus the re-validation: ``frame.mel`` MUST already
        be a float32 ndarray of shape (frames, n_mels)."""
        self._require(sid)
        self._pending.append((sid, frame, frame.mel))

    # -- the pipeline tick ---------------------------------------------------
    def tick(self, *, profile=False) -> list[FrameResult]:
        """Decide -> k-bucketed batched dispatch -> ingest.  Returns
        results in submission order.  On the overlapped plane this is
        ``tick_collect(tick_launch())``: one staged host->device copy,
        one device sync and one device->host copy per tick.
        ``profile=True`` waits after each bucket instead, so
        ``FrameResult.latency_ms`` is per bucket."""
        if self.overlap:
            return self.tick_collect(self.tick_launch(profile=profile))
        t0 = self._clock()
        pending, self._pending = self._pending, []
        results: list[FrameResult | None] = [None] * len(pending)
        self._tick_syncs = 0
        self._tick_d2h = 0
        if pending:
            for k, idx in sorted(self._decide(pending).items()):
                self._dispatch(k, idx, pending, results)
            self._ingest_fleet(pending, np.stack([r.z for r in results]))
            self._sync_accounting(pending, now=t0)
        self._finish_tick(t0)
        return results  # type: ignore[return-value]

    def tick_launch(self, *, profile=False) -> TickPlan:
        """Launch phase of the overlapped tick: decide, stage, issue every
        bucket's chain, the reassembly and the tick's ONE embedding copy
        to the host (with an event behind it), and do the host
        bookkeeping that needs no embedding values — without waiting for
        the device.  Pass the returned plan to ``tick_collect``."""
        if not self.overlap:
            raise RuntimeError(
                "tick_launch/tick_collect phase the overlapped data plane; "
                "construct the gateway with overlap=True")
        t0 = self._clock()
        pending, self._pending = self._pending, []
        self._tick_syncs = 0
        self._tick_d2h = 0
        plan = TickPlan(pending, t0, profile, seq=self._launch_seq)
        self._launch_seq += 1
        if pending:
            self._launch_overlapped(plan, self._decide(pending))
        plan.syncs, plan.d2h = self._tick_syncs, self._tick_d2h
        self._stage_ewma["launch"].ewma((self._clock() - t0) * 1e3)
        return plan

    def tick_collect(self, plan: TickPlan) -> list[FrameResult]:
        """Collect phase: the tick's ONE device sync, on the event behind
        its own copy (a tick launched after it is not waited for), then
        results in submission order, fleet ingest and the tick counters.
        Plans collect exactly once, in launch order."""
        if plan.seq != self._collect_seq:
            raise RuntimeError(
                f"tick_collect out of launch order: plan #{plan.seq} "
                f"offered, #{self._collect_seq} expected (plans collect "
                "exactly once, oldest first)")
        self._collect_seq += 1
        self._tick_syncs, self._tick_d2h = plan.syncs, plan.d2h
        t_c0 = self._clock()
        results: list[FrameResult | None] = [None] * len(plan.pending)
        if plan.pending:
            self._collect_overlapped(plan, results)
        self._stage_ewma["collect"].ewma((self._clock() - t_c0) * 1e3)
        self._finish_tick(plan.t0)
        return results  # type: ignore[return-value]

    def _decide(self, pending):
        """Policy decision for one tick's pending frames -> {k: [frame
        indices]}.  Bandwidth is normalized exactly like the control-plane
        env, so RL policies see the feature scale they were trained on."""
        bw_norm = EdgeCloudEnv.BW_NORM
        obs = np.array([[f.u, f.cpu, min(f.bandwidth_mbps / bw_norm, 1.0)]
                        for _, f, _ in pending], np.float32)
        ks = np.clip(np.asarray(self.policy.decide(obs), np.int64),
                     0, self.cfg.n_blocks)
        buckets: dict[int, list[int]] = {}
        for i, k in enumerate(ks):
            buckets.setdefault(int(k), []).append(i)
        return buckets

    def _finish_tick(self, t0):
        """Tick epilogue: counters, the periodic fleet refine round, the
        tick latency and its gauges."""
        self._ticks.inc()
        if (self.backend.can_refine and self.refine_every
                and self._ticks.value % self.refine_every == 0
                and self.backend.n_active):
            loss, _, _ = self.backend.refine(self._refine_rounds.value)
            self._refine_rounds.inc()
            self._last_refine_loss = loss
        self._last_tick_ms = (self._clock() - t0) * 1e3
        self._g_last_tick_ms.set(self._last_tick_ms)
        self._stage_ewma["tick"].ewma(self._last_tick_ms)
        self._g_syncs.set(self._tick_syncs)
        self._g_d2h.set(self._tick_d2h)

    def refine_due_next_tick(self) -> bool:
        """True when the NEXT collected tick will run a fleet refine round
        (``_finish_tick``'s condition, ``n_active`` included)."""
        return bool(self.backend.can_refine and self.refine_every
                    and (self._ticks.value + 1) % self.refine_every == 0
                    and self.backend.n_active)

    # instrumented sync points: every wait for the device and every
    # embedding copy to the host in the dispatch plane goes through these
    def _block(self, done=None):
        """Wait for the device: for the event ``done`` when given (a
        tick's own copy), else for everything queued on the current
        stream.  A no-op on the CPU."""
        self._tick_syncs += 1
        if self._cuda:
            if done is not None:
                done.synchronize()
            else:
                torch.cuda.current_stream(self.device).synchronize()

    def _d2h(self, x):
        """Start the copy of ``x`` into pinned host memory without
        waiting; the result may be read only after a ``_block`` that
        covers it.  A CPU tensor is already on the host."""
        self._tick_d2h += 1
        if not self._cuda:
            return x
        host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        host.copy_(x, non_blocking=True)
        return host

    def _fetch(self, x) -> np.ndarray:
        """The one copy of ``x`` to the host, then the one wait, then
        the read."""
        host = self._d2h(x)
        self._block()
        return host.numpy()

    def _stage(self, pending, buckets):
        """ONE host->device copy for the whole tick.

        The pinned host buffer holds the tick's mels, padded to a power
        of two in rows with the first frame, followed by int32 gather
        indices: each bucket's rows (padded to a power of two with its
        first frame) and, last, each frame's row in the concatenated
        bucket outputs.  -> (staged mels (rows, T, M), the indices), both
        on the device, bucket gathers in ``sorted(buckets)`` order."""
        n = len(pending)
        rows = pad_pow2(n)
        T, M = self.cfg.frames, self.cfg.n_mels
        gathers = []
        pos = np.empty(n, np.int32)
        offset = 0
        for _, idx in sorted(buckets.items()):
            padded = pad_pow2(len(idx))
            gathers.append(idx + idx[:1] * (padded - len(idx)))
            pos[idx] = offset + np.arange(len(idx), dtype=np.int32)
            offset += padded
        index = np.concatenate(gathers + [pos]).astype(np.int32)
        n_mel = rows * T * M
        host = torch.empty(n_mel + index.size, dtype=torch.float32,
                           pin_memory=self._cuda)
        buf = host.numpy()
        mel = buf[:n_mel].reshape(rows, T, M)
        np.stack([m for _, _, m in pending], out=mel[:n])
        mel[n:] = mel[0]
        buf[n_mel:].view(np.int32)[:] = index
        staged = host.to(self.device, non_blocking=True)
        self._staged_h2d.inc(mel.nbytes)
        return (staged[:n_mel].view(rows, T, M),
                staged[n_mel:].view(torch.int32))

    def _launch_overlapped(self, plan, buckets):
        """Launch half of the overlapped tick: the staged copy, one
        device-side gather per bucket, every bucket's edge stage, ONE
        wire launch over all the buckets, every server stage
        (``SplitEngine.run_buckets_async``), the reassembly gather, and
        the host bookkeeping — all issued without a sync, so the host
        work hides under the device's.  ``profile=True`` runs one
        edge→wire→server chain a bucket instead, each timed to its own
        round trip."""
        pending, profile = plan.pending, plan.profile
        plan.t_d0 = self._clock()
        staged, index = self._stage(pending, buckets)
        order = sorted(buckets.items())
        mels = []
        offset = 0
        for _, idx in order:
            padded = pad_pow2(len(idx))
            mels.append(staged.index_select(0, index[offset:offset + padded]))
            offset += padded
        if profile:   # diagnostic mode: per-bucket round trips
            outs, mss = [], []
            for (k, idx), mel_b in zip(order, mels):
                t_b = self._clock()
                outs.append(self.engine.run_batch_async(self.params, mel_b,
                                                        k))
                self._block()
                mss.append((self._clock() - t_b) * 1e3 / len(idx))
        else:
            outs = self.engine.run_buckets_async(
                self.params, [(k, m) for (k, _), m in zip(order, mels)])
            mss = [None] * len(order)
        z_bufs = [z for z, _ in outs]
        for (k, idx), (_, wire), ms in zip(order, outs, mss):
            plan.launched.append((k, idx, wire, ms, 0))
        # back into submission order on the device, pad rows dropped, and
        # the tick's one copy to the host, queued behind its own chains
        # (before any later tick's) with an event to wait on
        plan.z_all = torch.cat(z_bufs).index_select(0, index[offset:])
        plan.z_host = self._d2h(plan.z_all)
        if self._cuda:
            plan.done = torch.cuda.Event()
            plan.done.record(torch.cuda.current_stream(self.device))
        for k, idx, wire, _, s in plan.launched:
            self._account_bucket(k, idx, pending, wire, shard=s)
        self._sync_accounting(pending, now=plan.t_d0)

    def _collect_overlapped(self, plan, results):
        """Collect half: the tick's one sync, on the event behind its
        copy, then ``FrameResult`` delivery and the host ring insert."""
        pending = plan.pending
        self._block(plan.done)
        z_host = plan.z_host.numpy()
        tick_ms = (self._clock() - plan.t_d0) * 1e3 / len(pending)
        self._ingest_fleet(pending, z_host)
        for k, idx, wire, ms, _s in plan.launched:
            route = self._route(k)
            for i in idx:
                sid, req, _ = pending[i]
                results[i] = FrameResult(
                    sid=sid, t=req.t, z=z_host[i], route=route, k=k,
                    wire_bytes=wire,
                    latency_ms=ms if plan.profile else tick_ms,
                    bucket_size=len(idx), shard=_s)
        if plan.profile:
            self._last_profile = self._build_profile(plan)
            for k, ms in self._last_profile["per_bucket_ms"].items():
                self.registry.gauge("gateway_profile_bucket_ms",
                                    k=str(k)).set(ms)

    def _build_profile(self, plan):
        """Per-bucket ms of a profiled plan, plus per-shard totals (one
        shard on this plane), in the reference's ``last_profile`` shape."""
        per_bucket: dict[int, float] = {}
        per_shard: dict[int, dict] = {}
        for k, idx, _wire, ms, s in plan.launched:
            total = (ms or 0.0) * len(idx)
            per_bucket[k] = per_bucket.get(k, 0.0) + total
            ps = per_shard.setdefault(
                s, {"frames": 0, "chains": 0, "ms": 0.0,
                    "per_bucket_ms": {}})
            ps["frames"] += len(idx)
            ps["chains"] += 1
            ps["ms"] += total
            ps["per_bucket_ms"][k] = ps["per_bucket_ms"].get(k, 0.0) + total
        return {"per_bucket_ms": per_bucket, "per_shard": per_shard}

    @property
    def last_profile(self):
        """Per-bucket stage timings of the most recent
        ``tick(profile=True)`` (``None`` until one runs)."""
        return self._last_profile

    def _route(self, k):
        return ("edge" if k >= self.cfg.n_blocks
                else "server" if k == 0 else "split")

    def _account_bucket(self, k, idx, pending, wire, shard=0):
        """Per-bucket serving counters + per-session accounting (host
        state only, shared by both planes)."""
        route = self._route(k)
        self._dispatches.inc()
        self._frames.inc(len(idx))
        self._wire_bytes.inc(wire * len(idx))
        self._routed[route].inc(len(idx))
        self._dispatch_shard_frames[shard] += len(idx)
        for i in idx:
            sid = pending[i][0]
            s = self._sessions[sid]
            if s.last_k >= 0 and k != s.last_k:
                s.transitions += 1
            s.last_k = k
            s.frames += 1
            s.wire_bytes += wire

    def _dispatch(self, k, idx, pending, results):
        """The per-bucket-sync dispatch (``overlap=False``): host
        staging, one ``run_batch``, one copy and one wait — per bucket."""
        t0 = self._clock()
        mel = np.stack([pending[i][2] for i in idx])
        pad = pad_pow2(len(idx))
        if pad > len(idx):   # repeat-pad, as the overlapped plane does
            mel = np.concatenate(
                [mel, np.broadcast_to(mel[:1], (pad - len(idx),)
                                      + mel.shape[1:])])
        z_dev, wire = self.engine.run_batch(self.params, mel, k)
        z = self._fetch(z_dev)[:len(idx)]
        ms = (self._clock() - t0) * 1e3 / len(idx)
        self._account_bucket(k, idx, pending, wire)
        route = self._route(k)
        for j, i in enumerate(idx):
            sid, req, _ = pending[i]
            results[i] = FrameResult(
                sid=sid, t=req.t, z=z[j], route=route, k=k,
                wire_bytes=wire, latency_ms=ms, bucket_size=len(idx))

    def _ingest_fleet(self, pending, zs):
        """Fleet ingest of the tick's submission-ordered host
        embeddings."""
        sids = np.array([sid for sid, _, _ in pending], np.int64)
        ts = np.array([f.t for _, f, _ in pending], np.int64)
        labels = np.array([f.label for _, f, _ in pending], np.int64)
        self.backend.insert_batch(sids, ts, zs[:len(pending)], labels)
        self._shard_frames += np.bincount(
            self.backend.shards_of(sids), minlength=self.backend.shards)

    def _sync_accounting(self, pending, now=0.0):
        """Per-session lazy-sync protocol accounting (host state only),
        stamped with the tick's dispatch time from ``clock=``."""
        for sid, req, _ in pending:
            s = self._sessions[sid]
            for ev in s.sync.on_frame(req.t, charging=req.charging,
                                      bandwidth_mbps=req.bandwidth_mbps,
                                      now=now):
                self._sync_bytes.inc(ev.bytes)
                self._sync_events.inc()

    # -- observability -------------------------------------------------------
    @property
    def clock(self):
        return self._clock

    @property
    def ticks(self) -> int:
        """Collected-tick count."""
        return self._ticks.value

    def stats(self) -> GatewayStats:
        """The gateway scoreboard as a frozen view over the registry."""
        for s, v in enumerate(self._shard_frames):
            self.registry.gauge("gateway_shard_frames",
                                shard=str(s)).set(int(v))
        for s, v in enumerate(self._dispatch_shard_frames):
            self.registry.gauge("gateway_dispatch_shard_frames",
                                shard=str(s)).set(int(v))
        return GatewayStats(
            ticks=self._ticks.value, frames=self._frames.value,
            sessions_open=len(self._sessions),
            sessions_opened=self._opened.value,
            sessions_closed=self._closed.value,
            admission_refusals=self._refusals.value,
            dispatches=self._dispatches.value,
            wire_bytes=self._wire_bytes.value,
            sync_bytes=self._sync_bytes.value,
            sync_events=self._sync_events.value,
            refine_rounds=self._refine_rounds.value,
            last_refine_loss=self._last_refine_loss,
            routed={r: c.value for r, c in self._routed.items()},
            backend=self.backend.kind, shards=self.backend.shards,
            shard_frames=tuple(int(v) for v in self._shard_frames),
            dispatch_shards=1,
            dispatch_shard_frames=tuple(
                int(v) for v in self._dispatch_shard_frames),
            snapshot_h2d_bytes=self.backend.snapshot_h2d_bytes,
            ingest_h2d_bytes=self.backend.ingest_h2d_bytes,
            device_syncs_per_tick=self._tick_syncs,
            d2h_copies_per_tick=self._tick_d2h,
            staged_h2d_bytes=self._staged_h2d.value,
            uptime_s=self._clock() - self._t_start,
            last_tick_ms=self._last_tick_ms,
            sessions_exported=self._exported.value,
            sessions_imported=self._imported.value)

    def metrics(self) -> str:
        """The gateway's registry in Prometheus text exposition format."""
        self.stats()                 # sync the lazy per-shard gauges
        return to_prometheus(self.registry)
