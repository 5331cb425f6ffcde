"""The federation's two lanes: a ``GatewayCluster`` of N member
``StreamServer``s under steady mixed-k load with a live ``drain()`` in
the middle of the run, and a CHAOS lane (a seeded member kill
mid-stream, frame replication off or on).

Port of ``benchmarks/cluster_serve.py``'s lanes as functions that take
``device=`` and return a dict; nothing is written to disk.

**Drain under load, N members** (``cluster_drain``).  ``spm`` sessions
per member (consistent-hash placement), every session holding a
constant uncertainty spread over every k-bucket, so its split index is
stable tick to tick.  A warm-up cycle (two rounds, a dry drain of the
victim, two rounds, the ``add_member`` rejoin, one round) exercises the
rebalance both ways; its pauses are the *cold* first-contact pauses:
the first moves onto a receiver, whose cost in the port is host work
(the first pinned staging buffers and first convolutions at the new
batch shapes of the receiver's ticks), not a compile.  Then three timed
phases of ``rounds`` rounds each:

- ``before``        — steady state, all members serving;
- ``during_drain``  — the same offered load with ``drain(victim)``
  dropped mid-round, so the victim's sessions quiesce, export and
  import onto ring-chosen survivors (books + token bucket + queued
  frames with their original deadlines) while traffic keeps flowing;
- ``after``         — steady state on the survivors.

**Chaos** (``cluster_chaos``): the ring owner of gsid 0 is killed by a
seeded ``FailureInjector`` halfway through, with ``snapshot_every=2``
checkpoints and, with ``replicate=True``, a per-step journal flush.

Hard asserts, as in the reference (an ``AssertionError`` fails the
caller): the cluster-wide conservation identity at every sampled
snapshot; in a drain zero shed, zero lost and exactly the victim's
sessions migrated with queued frames travelling; in the chaos lane one
failure, no session lost, and with replication ``lost_in_flight`` 0 and
every frame served.

**The replay oracle** (``replay_parity``): every checked session's
served stream is held against an unmigrated replay of the same frames on
one fresh gateway: ``(t, k, route, wire_bytes)`` equal, each ``(sid,
t)`` served exactly once, and ``z`` within ``Z_ATOL``.  The reference
holds ``z`` bitwise; the port cannot, since torch's convolutions are
not batch-invariant and a migrated frame rides in other ticks than the
replay's.  The oracle reports the largest ``|dz|`` and how many frames
matched bitwise.
"""
from __future__ import annotations

import time
from dataclasses import fields

import numpy as np
import torch

from repro_torch.api import (FrameRequest, ShardedFleetBackend,
                             StreamSplitGateway)
from repro_torch.cluster import FailureInjector, GatewayCluster, HashRing
from repro_torch.models.audio_encoder import AudioEncCfg, init_audio_encoder
from repro_torch.serving import SchedulerCfg, StreamServer

SESSIONS_PER_MEMBER = 4
WARMUP_ROUNDS = 2
RING_SEED = 0       # the reference lanes' ring seed
Z_ATOL = 1e-4       # replay oracle and card against CPU, as phase 2's bound


class MixedKPolicy:
    """Deterministic mixed-k policy: uncertainty quantile -> split index,
    spreading one tick over every k in [0, L] (L+1 buckets)."""

    def __init__(self, L):
        self.L = L

    def decide(self, obs_batch):
        return np.clip((obs_batch[:, 0] * (self.L + 1)).astype(np.int64),
                       0, self.L)


def mel(gsid, t, cfg):
    """Session ``gsid``'s seeded mel at frame ``t``."""
    rng = np.random.default_rng(1000 * (gsid + 1) + t)
    return rng.normal(size=(cfg.frames, cfg.n_mels)).astype(np.float32)


def request(gsid, t, cfg, us):
    return FrameRequest(t=t, mel=mel(gsid, t, cfg), u=us[gsid])


def spread_u(n):
    """``n`` constant per-session uncertainties spread over every
    k-bucket (the reference lane's permutation)."""
    return [float(u) for u in
            np.random.default_rng(3).permutation(np.linspace(0.02, 0.98, n))]


def gateway(cfg, params, capacity, device, *, fleet="host", clock=None):
    """A lane gateway on ``device``: its rings in a ``HostFleetBackend``
    (``fleet="host"``) or a one-shard ``ShardedFleetBackend`` on the
    device (``"sharded"``); ``clock`` (default the wall clock) drives its
    and its server's timing."""
    kw = {} if clock is None else {"clock": clock}
    if fleet == "sharded":
        kw["backend"] = ShardedFleetBackend(capacity=capacity, window=16,
                                            dim=cfg.d_embed, device=device)
    elif fleet != "host":
        raise ValueError(f"unknown fleet {fleet!r}")
    return StreamSplitGateway(cfg, params, policy=MixedKPolicy(cfg.n_blocks),
                              capacity=capacity, window=16, qos_reserve=0,
                              overlap=True, device=device, **kw)


def member(cfg, params, n, device, *, fleet="host", clock=None):
    """One federation member: a gateway that can hold every one of the
    ``n`` sessions, behind a server constructed UNSTARTED (the cluster
    owns stepping)."""
    return StreamServer(gateway(cfg, params, n, device, fleet=fleet,
                                clock=clock),
                        cfg=SchedulerCfg(max_batch=n), queue_maxlen=16 * n)


def pcts(ms):
    if not ms:
        return {"p50": 0.0, "p95": 0.0, "max": 0.0}
    a = np.asarray(ms, np.float64)
    return {"p50": float(np.percentile(a, 50)),
            "p95": float(np.percentile(a, 95)), "max": float(a.max())}


def _model(enc_cfg, params):
    cfg = enc_cfg if enc_cfg is not None else AudioEncCfg()
    if params is None:
        params = init_audio_encoder(cfg, torch.Generator().manual_seed(0))
    return cfg, params


def _assert_conserved(cl):
    st = cl.stats()
    assert st.conserved, (st.submitted, st.served, st.queue_depth,
                          st.in_flight, st.shed_expired, st.lost_in_flight)
    return st


def cluster_drain(members=2, *, device="cuda", enc_cfg=None, params=None,
                  rounds=8, spm=SESSIONS_PER_MEMBER, oracle=True,
                  on_member=None, fleet="host", clock=None) -> dict:
    """One drain lane over ``members`` members of ``spm`` sessions each
    (``enc_cfg`` defaults to the paper's ``AudioEncCfg()``, ``params`` to
    its weights from ``torch.Generator().manual_seed(0)``).
    ``on_member(name, server)`` sees each member as it is built
    (instrumentation).  With ``oracle`` the migrated sessions are held
    against ``replay_parity``.  ``fleet`` is each member's backend kind
    and ``clock`` its servers' timing source (``gateway``).

    -> frames/s per phase, the warm and cold migration pauses, the
    migrated sessions, frames and bytes, per timed round the host ms
    to build its frames (seeded mels, inside the frames/s as in the
    reference's lane), to submit them and of the cluster step, and for
    the caller ``results`` (every ``FrameResult``, global sids),
    ``stats`` (the final ``ClusterStats``, every session closed),
    ``homed`` (the migrated gsids), ``us`` and ``t_next``."""
    cfg, params = _model(enc_cfg, params)
    n = members * spm
    us = spread_u(n)
    results = []
    servers = {f"g{i}": member(cfg, params, n, device, fleet=fleet,
                               clock=clock)
               for i in range(members)}
    if on_member is not None:
        for name, srv in servers.items():
            on_member(name, srv)
    cl = GatewayCluster(dict(servers), seed=RING_SEED,
                        on_result=results.append)
    infos = [cl.open_session() for _ in range(n)]
    t_next = 0
    build_ms, submit_ms, step_ms = [], [], []

    def round_(*, drain=None, timed=False):
        nonlocal t_next
        t0 = time.perf_counter()
        reqs = [request(i.sid, t_next, cfg, us) for i in infos]
        t1 = time.perf_counter()
        for i, req in zip(infos, reqs):
            cl.submit(i.sid, req)
        t2 = time.perf_counter()
        if drain is not None:     # mid-round: queued frames must travel
            cl.drain(drain)
        t3 = time.perf_counter()
        cl.step()
        if timed:
            build_ms.append((t1 - t0) * 1e3)
            submit_ms.append((t2 - t1) * 1e3)
            step_ms.append((time.perf_counter() - t3) * 1e3)
        t_next += 1

    def timed(fn):
        s0 = sum(cl.stats().served.values())
        t0 = time.perf_counter()
        fn()
        cl.pump()
        dt = time.perf_counter() - t0
        st = _assert_conserved(cl)
        return (sum(st.served.values()) - s0) / dt

    victim = sorted({cl.session_member(i.sid) for i in infos})[0]
    homed = [i.sid for i in infos if cl.session_member(i.sid) == victim]

    # warm cycle: a dry drain onto the survivors, then the rejoin
    # (rebalance moves ownership straight back) — the cold pauses
    for _ in range(WARMUP_ROUNDS):
        round_()
    round_(drain=victim)
    for _ in range(WARMUP_ROUNDS):
        round_()
    assert cl.add_member(victim, servers[victim]) == len(homed)
    round_()
    cl.pump()
    st0 = _assert_conserved(cl)
    assert st0.migrations == 2 * len(homed) > 0
    cold_pause = pcts(cl.migration_pauses_ms)

    def steady():
        for _ in range(rounds):
            round_(timed=True)

    def drain_phase():
        for _ in range(rounds // 2):
            round_(timed=True)
        round_(drain=victim, timed=True)   # live: queued frames travel
        for _ in range(rounds - rounds // 2 - 1):
            round_(timed=True)

    fps_before = timed(steady)
    fps_during = timed(drain_phase)
    fps_after = timed(steady)

    st = _assert_conserved(cl)
    assert st.drains - st0.drains == 1
    assert st.migrations - st0.migrations == len(homed)
    assert st.migrated_frames - st0.migrated_frames >= len(homed)
    assert victim not in st.members
    # drained to empty: every accepted frame served, nothing shed/lost
    assert st.served == st.submitted, (st.served, st.submitted)
    assert sum(st.shed_expired.values()) == 0
    assert sum(st.lost_in_flight.values()) == 0
    total = t_next * n
    assert len(results) == total and sum(st.served.values()) == total
    warm_pause = pcts(cl.migration_pauses_ms[st0.migrations:])
    for i in infos:
        cl.close_session(i.sid)
    st_end = _assert_conserved(cl)
    assert st_end.sessions_open == 0
    out = {
        "members": members,
        "sessions": n,
        "rounds_per_phase": rounds,
        "victim": victim,
        "frames_per_s": {"before": fps_before, "during_drain": fps_during,
                         "after": fps_after},
        "migration_pause_ms": warm_pause,
        "migration_pause_cold_ms": cold_pause,
        "migrations": st.migrations - st0.migrations,
        "migrated_frames": st.migrated_frames - st0.migrated_frames,
        "migrated_bytes": st.migrated_bytes - st0.migrated_bytes,
        "build_ms": pcts(build_ms),
        "submit_ms": pcts(submit_ms),
        "step_ms": pcts(step_ms),
        "shed_expired": sum(st.shed_expired.values()),
        "lost_in_flight": sum(st.lost_in_flight.values()),
        "results": results, "stats": st_end, "homed": homed, "us": us,
        "t_next": t_next,
    }
    if oracle:
        out["parity"] = replay_parity(out, cfg, params, device=device)
    return out


def cluster_chaos(members=2, *, replicate, device="cuda", enc_cfg=None,
                  params=None, rounds=8, spm=SESSIONS_PER_MEMBER,
                  oracle=True, on_member=None, fleet="host",
                  clock=None) -> dict:
    """One seeded kill-mid-stream run: the ring owner of gsid 0 dies at
    cluster step ``WARMUP_ROUNDS + max(1, rounds // 2)``; checkpoints
    every 2 steps; with ``replicate`` every accepted frame is journaled
    on a buddy, flushed every step.  Arguments as ``cluster_drain``.

    -> the loss and recovery books, frames/s, and for the caller
    ``results``, ``stats`` (the ``ClusterStats`` after the final pump,
    sessions still open), ``homed`` (every gsid), ``us``, ``t_next``.
    Without replication the kill must lose frames; with it, none."""
    cfg, params = _model(enc_cfg, params)
    n = members * spm
    us = spread_u(n)
    names = [f"g{i}" for i in range(members)]
    # the victim is the ring owner of gsid 0 — computable before the
    # cluster exists (the ring is a pure function of membership + seed),
    # so the injector can be installed at construction
    victim = HashRing(names, seed=RING_SEED).owner(0)
    kill_step = WARMUP_ROUNDS + max(1, rounds // 2)
    results = []
    servers = {nm: member(cfg, params, n, device, fleet=fleet, clock=clock)
               for nm in names}
    if on_member is not None:
        for name, srv in servers.items():
            on_member(name, srv)
    t0 = time.perf_counter()
    cl = GatewayCluster(servers, seed=RING_SEED, snapshot_every=2,
                        replicate=replicate, on_result=results.append,
                        injectors={victim: FailureInjector(
                            fail_at=(kill_step,))})
    infos = [cl.open_session() for _ in range(n)]
    assert cl.session_member(infos[0].sid) == victim
    # every round is exactly one cluster step, so the injector's step
    # id maps 1:1 onto the round index
    for t in range(WARMUP_ROUNDS + rounds):
        for i in infos:
            cl.submit(i.sid, request(i.sid, t, cfg, us))
        cl.step()
        _assert_conserved(cl)
    cl.pump()
    dt = time.perf_counter() - t0
    t_next = WARMUP_ROUNDS + rounds
    st = _assert_conserved(cl)
    assert st.failures == 1 and victim not in st.members
    assert st.sessions_open == n and cl.lost_sessions == []
    lost = sum(st.lost_in_flight.values())
    if replicate:
        assert lost == 0                  # per-step flush: zero loss
        assert st.failovers > 0 and st.replayed_frames > 0
        assert st.served == st.submitted
        assert sum(st.shed_expired.values()) == 0
    else:
        assert lost > 0     # checkpoint-only recovery drops the backlog
    out = {
        "members": members,
        "sessions": n,
        "rounds": rounds,
        "replicate": replicate,
        "victim": victim,
        "frames_per_s": sum(st.served.values()) / dt,
        "lost_in_flight": lost,
        "failures": st.failures,
        "failovers": st.failovers,
        "replayed_frames": st.replayed_frames,
        "journal_bytes": st.journal_bytes,
        "retries": st.retries,
        "results": results, "stats": st, "homed": [i.sid for i in infos],
        "us": us, "t_next": t_next,
    }
    if oracle:
        out["parity"] = replay_parity(out, cfg, params, device=device)
    for i in infos:
        cl.close_session(i.sid)
    _assert_conserved(cl)
    return out


def replay_parity(lane: dict, enc_cfg, params, *, device="cuda") -> dict:
    """Hold every served frame of the lane's ``homed`` sessions against
    an unmigrated replay on one fresh gateway (each frame index ``t``
    of every such session in one tick): each ``(sid, t)`` served at most
    once (exactly once when nothing was lost), ``t``, ``k``, ``route``
    and ``wire_bytes`` equal, ``z`` within ``Z_ATOL``.

    -> {"sessions", "frames", "max_abs_dz", "bitwise_frames"}."""
    by_sid = {}
    for r in lane["results"]:
        assert r.t not in by_sid.setdefault(r.sid, {}), (r.sid, r.t)
        by_sid[r.sid][r.t] = r
    gsids = list(lane["homed"])
    complete = sum(lane["stats"].lost_in_flight.values()) == 0
    oracle = gateway(enc_cfg, params, len(gsids), device)
    osid = {g: oracle.open_session().sid for g in gsids}
    frames = bitwise = 0
    worst = 0.0
    for t in range(lane["t_next"]):
        for g in gsids:
            oracle.submit(osid[g], request(g, t, enc_cfg, lane["us"]))
        for g, ref in zip(gsids, oracle.tick()):
            got = by_sid.get(g, {}).get(t)
            if got is None:
                assert not complete, f"session {g} never served t={t}"
                continue
            assert (got.t, got.k, got.route, got.wire_bytes) == (
                ref.t, ref.k, ref.route, ref.wire_bytes), (g, t)
            dz = float(np.abs(got.z - ref.z).max())
            assert dz <= Z_ATOL, f"session {g} at t={t}: |dz| {dz}"
            worst = max(worst, dz)
            bitwise += bool(np.array_equal(got.z, ref.z))
            frames += 1
    return {"sessions": len(gsids), "frames": frames, "max_abs_dz": worst,
            "bitwise_frames": bitwise}


# -- books to compare across runs --------------------------------------------

_MEMBER_BOOKS = ("ticks", "pipelined_ticks", "frames_submitted",
                 "frames_served", "queue_depth", "in_flight", "rejected_full",
                 "rejected_rate_limited", "preempted", "requeued",
                 "shed_expired")
_GATEWAY_BOOKS = ("ticks", "frames", "sessions_open", "sessions_opened",
                  "sessions_closed", "admission_refusals", "dispatches",
                  "wire_bytes", "routed", "sessions_exported",
                  "sessions_imported")


def books(st, *, skip=("migration_pause_ms",)) -> dict:
    """A ``ClusterStats`` (the port's or the reference's) as a dict of
    its books, for equality across runs: every field but ``skip``, each
    member's ``StreamStats`` cut to its counts.  Left out of the member
    stats are the fields a wall clock drives (queue waits, deadline
    misses, aging-lane promotions, uptime, tick ms) and the gateway's
    byte meters of host staging, which differ between the packages by
    design."""
    out = {}
    for f in fields(st):
        if f.name in skip:
            continue
        v = getattr(st, f.name)
        if f.name == "member_stats":
            v = {m: {**{k: getattr(s, k) for k in _MEMBER_BOOKS},
                     "gateway": {k: getattr(s.gateway, k)
                                 for k in _GATEWAY_BOOKS}}
                 for m, s in v.items()}
        out[f.name] = v
    return out


def summary(lane: dict) -> dict:
    """The lane's numbers, without the results and stats objects."""
    return {k: v for k, v in lane.items()
            if k not in ("results", "stats", "homed", "us")}

