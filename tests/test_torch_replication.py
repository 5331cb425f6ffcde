"""The port's self-healing federation on the CPU: the oracles of the
reference's ``tests/test_replication.py`` — frame journaling + buddy
replication, heartbeat hang detection, deterministic retry,
degraded-mode admission and the drain-timeout summary, all on a fake
clock — plus the port against the reference: one seeded run of the
chaos lane (``runtime/cluster_serve.py`` against
``benchmarks/cluster_serve.py``), and a session carried across the two
packages field by field (``weights.session_snapshot_from_jax`` and
``session_snapshot_to_jax``) continuing its stream as the reference
continues it.

As in ``tests/test_torch_cluster.py``, the reference's bitwise replay
oracle becomes ``(sid, t, k, route, wire_bytes)`` exactly and ``z``
within ``Z_ATOL`` = 1e-4, with the largest ``|dz|`` printed.
"""
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.api import FrameRequest as JaxFrameRequest  # noqa: E402
from repro.api import QoSClass as JaxQoSClass  # noqa: E402
from repro.api import StreamSplitGateway as JaxGateway  # noqa: E402
from repro.api.types import QueuedFrameSnapshot as JaxQueued  # noqa: E402
from repro.api.types import \
    ServerSessionSnapshot as JaxServerSnap  # noqa: E402
from repro.api.types import SessionSnapshot as JaxSnapshot  # noqa: E402
from repro.core.sync import SyncCfg as JaxSyncCfg  # noqa: E402
from repro.core.sync import SyncEvent as JaxSyncEvent  # noqa: E402
from repro.models.audio_encoder import AudioEncCfg as JaxAudioEncCfg  # noqa: E402,E501
from repro.serving import SchedulerCfg as JaxSchedulerCfg  # noqa: E402
from repro.serving import StreamServer as JaxStreamServer  # noqa: E402
from repro_torch.api import QoSClass  # noqa: E402
from repro_torch.cluster import (ClusterDegradedError,  # noqa: E402
                                 ClusterDrainTimeout, FailureInjector,
                                 FrameJournal, GatewayCluster, HashRing,
                                 JournalEntry, MemberHungError,
                                 ReplicationLog, RetryPolicy)
from repro_torch.cluster.replication import entry_nbytes  # noqa: E402
from repro_torch.models.audio_encoder import init_audio_encoder  # noqa: E402
from repro_torch.runtime import cluster_serve  # noqa: E402
from repro_torch.serving import SchedulerCfg, StreamServer  # noqa: E402
from repro_torch.weights import (session_snapshot_from_jax,  # noqa: E402
                                 session_snapshot_to_jax)
from test_torch_cluster import (CFG, KW, Z_ATOL, FakeClock,  # noqa: E402
                                QuantilePolicy, _assert_conserved, _gw,
                                _hold_against_replay, _jax_params, _mel,
                                _one_torch_thread, _req, _server)

I, S, B = QoSClass.INTERACTIVE, QoSClass.STANDARD, QoSClass.BULK
L = CFG.n_blocks
_ = _one_torch_thread    # the module-scoped fixture, used here too


@pytest.fixture(scope="module")
def params():
    return init_audio_encoder(CFG, torch.Generator().manual_seed(0))


def _entry(t, *, sid=0):
    f = _req(sid, t)
    return JournalEntry(t=t, frame=f, enq_s=0.1 * t,
                        deadline_s=0.1 * t + 1.0)


# ---------------------------------------------------------------------------
# FrameJournal / ReplicationLog units
# ---------------------------------------------------------------------------

def test_journal_lifecycle_pending_acked_settled():
    j = FrameJournal(gsid=0, buddy="b")
    for t in range(4):
        j.append(_entry(t))
    assert len(j.pending()) == 4 and j.replayable() == []
    shipped = j.flush()
    assert shipped == 4 * entry_nbytes(j.entries[0]) and j.pending() == []
    assert [e.t for e in j.replayable()] == [0, 1, 2, 3]
    j.settle(0)
    j.settle(1)
    assert [e.t for e in j.replayable()] == [2, 3]
    # truncation drops ONLY acked-and-settled: the open tail survives
    assert j.truncate_settled() == 2
    assert [e.t for e in j.entries] == [2, 3]
    # a second flush ships nothing — acks are idempotent
    assert j.flush() == 0
    # the meter is the reference's: mel bytes plus a fixed overhead
    from repro.cluster.replication import entry_nbytes as jax_nbytes
    from repro.cluster.replication import JournalEntry as JaxEntry
    jf = JaxFrameRequest(t=0, mel=_mel(0, 0))
    assert entry_nbytes(j.entries[0]) == jax_nbytes(
        JaxEntry(t=0, frame=jf, enq_s=0.0, deadline_s=1.0))


def test_journal_without_buddy_never_acks():
    j = FrameJournal(gsid=0, buddy=None)
    j.append(_entry(0))
    assert j.flush() == 0                    # nowhere to ship
    assert j.pending() and j.replayable() == []


def test_journal_settle_matches_oldest_open_entry():
    j = FrameJournal(gsid=0, buddy="b")
    j.append(_entry(7))
    j.append(_entry(7))                      # same t twice (re-submit)
    j.flush()
    assert j.settle(7) and j.entries[0].settled
    assert not j.entries[1].settled          # one serve settles one entry
    assert not j.settle(99)                  # unknown t: no-op


def test_log_drop_member_clears_only_acked_entries():
    """The buddy died: entries that were SHIPPED lived there and die
    with it; pending entries never left the owner's side and survive."""
    log = ReplicationLog()
    log.open(0, "b")
    log.open(1, "c")                         # different buddy: untouched
    for t in range(3):
        log.record(0, t=t, frame=_req(0, t), enq_s=0.0, deadline_s=1.0)
        log.record(1, t=t, frame=_req(1, t), enq_s=0.0, deadline_s=1.0)
    log.flush_all()
    log.record(0, t=3, frame=_req(0, 3), enq_s=0.0, deadline_s=1.0)
    hit = log.drop_member("b")
    assert hit == [0] and log.resets == 1
    j0 = log.journal(0)
    assert j0.buddy is None
    assert [e.t for e in j0.entries] == [3]  # the pending one survives
    assert [e.t for e in log.journal(1).entries] == [0, 1, 2]
    assert log.pending_total() == 1


def test_log_rehome_keeps_entries_and_meters_reship():
    log = ReplicationLog()
    log.open(0, "b")
    log.record(0, t=0, frame=_req(0, 0), enq_s=0.0, deadline_s=1.0)
    log.flush_all()
    first = log.bytes_shipped
    assert first > 0
    log.rehome(0, "c")                       # old buddy alive: data moves
    assert log.journal(0).buddy == "c"
    assert log.bytes_shipped == 2 * first    # the re-ship is metered
    assert [e.t for e in log.journal(0).replayable()] == [0]


def test_ring_buddy_is_next_live_node_past_owner():
    r = HashRing(["a", "b", "c"], seed=3)
    for k in range(50):
        owner = r.owner(k)
        buddy = r.buddy(k, exclude=(owner,))
        assert buddy is not None and buddy != owner
        assert r.preference(k)[1] == buddy   # the failover successor
    r.remove("b")
    r.remove("c")
    assert r.buddy(0, exclude=("a",)) is None    # nobody left to hold it


# ---------------------------------------------------------------------------
# THE acceptance oracle: bounded loss + replay parity
# ---------------------------------------------------------------------------

def _chaos_run(params, *, replicate, flush_every=1, rounds=10,
               n_sessions=4, fail_at=6, seed=3, max_batch=4):
    """One seeded kill-mid-stream run; returns (cluster, infos,
    results-by-(sid, t))."""
    clock = FakeClock()
    members = {"a": _server(params, clock, max_batch=max_batch),
               "b": _server(params, clock, max_batch=max_batch)}
    cl = GatewayCluster(members, seed=seed, snapshot_every=2,
                        replicate=replicate,
                        journal_flush_every=flush_every,
                        injectors={"a": FailureInjector(fail_at=(fail_at,))},
                        timer=clock)
    infos = [cl.open_session(qos=S) for _ in range(n_sessions)]
    assert "a" in {cl.session_member(i.sid) for i in infos}
    for t in range(rounds):
        for i in infos:
            cl.submit(i.sid, _req(i.sid, t))
        clock.advance(0.01)
        cl.step()
        _assert_conserved(cl.stats())        # ...including mid-chaos
    cl.pump()
    _assert_conserved(cl.stats())
    by = {}
    for r in cl.drain_results():
        assert (r.sid, r.t) not in by        # nothing double-served
        by[(r.sid, r.t)] = r
    return cl, infos, by


def test_replication_bounds_loss_and_replays_within_bound(params):
    """Same seed, same schedule, same kill:

    - replication OFF loses the victim's post-checkpoint frames;
    - replication ON (per-step flush) loses NOTHING — every journaled
      frame replays on the survivor;
    - the recovered streams match an unfailed sequential replay of the
      same frames: ``(t, k, route, wire_bytes)`` equal, ``z`` within
      ``Z_ATOL``."""
    cl_off, _, _ = _chaos_run(params, replicate=False)
    lost_off = sum(cl_off.stats().lost_in_flight.values())
    assert lost_off > 0                      # checkpoint-only recovery

    cl_on, infos, by = _chaos_run(params, replicate=True)
    st = cl_on.stats()
    lost_on = sum(st.lost_in_flight.values())
    assert lost_on < lost_off                # the headline inequality
    assert lost_on == 0                      # per-step flush: zero loss
    assert st.failures == 1 and st.failovers > 0
    assert st.replayed_frames > 0 and st.journal_bytes > 0
    assert cl_on.lost_sessions == []
    assert sum(st.shed_expired.values()) == 0
    assert st.served == st.submitted         # every frame came out
    assert sorted(by) == sorted((i.sid, t) for i in infos
                                for t in range(10))
    _hold_against_replay(params, by, [i.sid for i in infos], 10,
                         "journal replay")

    # the cluster keeps serving after recovery
    for i in infos:
        cl_on.submit(i.sid, _req(i.sid, 99))
    cl_on.pump()
    _assert_conserved(cl_on.stats())
    for i in infos:
        cl_on.close_session(i.sid)
    _assert_conserved(cl_on.stats())


def test_flush_window_is_the_loss_bound(params):
    """With ``journal_flush_every=2`` a kill on an unflushed step loses
    EXACTLY the victim's frames admitted since the last flush — one
    window, no more (acked entries replay, pending die, all counted)."""
    # fail_at=5: flushes landed at steps 2 and 4, covering rounds 0-3;
    # round-4 admissions are still pending when the injector fires.
    cl, infos, _ = _chaos_run(params, replicate=True, flush_every=2,
                              fail_at=5, max_batch=2, n_sessions=8,
                              seed=0)
    st = cl.stats()
    lost = sum(st.lost_in_flight.values())
    homed_on_a = st.failovers                # one failover per a-session
    assert homed_on_a > 0
    assert lost == homed_on_a                # one unflushed round each
    assert cl.lost_sessions == []
    assert st.replayed_frames > 0            # the acked tail came back


# ---------------------------------------------------------------------------
# Heartbeat: hung members fail over like crashed ones
# ---------------------------------------------------------------------------

def test_hung_member_detected_and_failed_over(params):
    clock = FakeClock()
    members = {"a": _server(params, clock, max_batch=4),
               "b": _server(params, clock, max_batch=4)}
    cl = GatewayCluster(members, seed=3, replicate=True,
                        heartbeat_timeout_s=0.05,
                        injectors={"a": FailureInjector(hang_from=4)},
                        timer=clock)
    infos = [cl.open_session(qos=S) for _ in range(4)]
    assert "a" in {cl.session_member(i.sid) for i in infos}
    for t in range(8):
        for i in infos:
            cl.submit(i.sid, _req(i.sid, t))
        clock.advance(0.02)
        cl.step()
        _assert_conserved(cl.stats())
    st = cl.stats()
    assert st.failures == 1 and st.members == ("b",)
    assert st.failovers > 0 and cl.lost_sessions == []
    assert all(cl.session_member(i.sid) == "b" for i in infos)
    cl.pump()
    st = cl.stats()
    _assert_conserved(st)
    # journaled frames replayed: the hang lost at most the unflushed
    # window (here: nothing — per-step flush)
    assert sum(st.lost_in_flight.values()) == 0
    assert st.served == st.submitted
    assert any(e["kind"] == "member_hung"
               for e in cl.failover_dumps[-1]["events"])


def test_hung_member_error_is_typed():
    err = MemberHungError("a", 0.3, 0.05)
    assert err.name == "a" and "no heartbeat" in str(err)
    assert isinstance(err, RuntimeError)


def test_healthy_members_never_suspected(params):
    """An IDLE member still beats — completing a no-op step is
    progress; suspicion keys on completion, not on load."""
    clock = FakeClock()
    cl = GatewayCluster({"a": _server(params, clock),
                         "b": _server(params, clock)},
                        seed=0, heartbeat_timeout_s=0.05, timer=clock)
    for _ in range(20):                      # idle, slow clock
        clock.advance(0.04)                  # under threshold per step
        cl.step()
    assert cl.stats().failures == 0
    assert cl.stats().members == ("a", "b")


# ---------------------------------------------------------------------------
# Retry: transient faults heal, fatal ones fail over
# ---------------------------------------------------------------------------

def test_transient_member_fault_retried_not_killed(params):
    clock = FakeClock()
    members = {"a": _server(params, clock), "b": _server(params, clock)}
    cl = GatewayCluster(members, seed=3, replicate=True,
                        injectors={"a": FailureInjector(
                            transient_at={3: 2})},
                        timer=clock)
    infos = [cl.open_session(qos=S) for _ in range(4)]
    for t in range(6):
        for i in infos:
            cl.submit(i.sid, _req(i.sid, t))
        clock.advance(0.01)
        cl.step()
        _assert_conserved(cl.stats())
    cl.pump()
    st = cl.stats()
    _assert_conserved(st)
    assert st.retries == 2                   # both blips retried away
    assert st.failures == 0 and st.members == ("a", "b")
    assert st.served == st.submitted


def test_transient_exhaustion_becomes_a_failover(params):
    """More consecutive transients than the policy's budget: the retry
    wrapper re-raises and the member takes the ordinary death path —
    with replication, its sessions replay on the survivor."""
    clock = FakeClock()
    members = {"a": _server(params, clock), "b": _server(params, clock)}
    cl = GatewayCluster(members, seed=3, replicate=True,
                        retry=RetryPolicy(max_attempts=3),
                        injectors={"a": FailureInjector(
                            transient_at={3: 10})},
                        timer=clock)
    infos = [cl.open_session(qos=S) for _ in range(4)]
    for t in range(6):
        for i in infos:
            cl.submit(i.sid, _req(i.sid, t))
        clock.advance(0.01)
        cl.step()
        _assert_conserved(cl.stats())
    cl.pump()
    st = cl.stats()
    _assert_conserved(st)
    assert st.retries == 2                   # attempts 1..3, then fatal
    assert st.failures == 1 and st.members == ("b",)
    assert st.failovers > 0 and cl.lost_sessions == []


def test_retry_disabled_makes_transients_fatal(params):
    clock = FakeClock()
    members = {"a": _server(params, clock), "b": _server(params, clock)}
    cl = GatewayCluster(members, seed=3, snapshot_every=2, retry=None,
                        injectors={"a": FailureInjector(
                            transient_at={2: 1})},
                        timer=clock)
    [cl.open_session(qos=S) for _ in range(4)]
    for t in range(4):
        clock.advance(0.01)
        cl.step()
    st = cl.stats()
    assert st.retries == 0 and st.failures == 1


# ---------------------------------------------------------------------------
# Degraded mode
# ---------------------------------------------------------------------------

def test_degraded_mode_refuses_new_sessions_and_bulk(params):
    clock = FakeClock()
    members = {"a": _server(params, clock), "b": _server(params, clock)}
    cl = GatewayCluster(members, seed=3, replicate=True,
                        degraded_below=0.75,
                        injectors={"a": FailureInjector(fail_at=(4,))},
                        timer=clock)
    std = cl.open_session(qos=S)
    blk = cl.open_session(qos=B)
    assert not cl.stats().degraded           # full strength
    for t in range(4):                       # the kill lands on the
        cl.submit(std.sid, _req(std.sid, t))  # LAST step: every loop
        cl.submit(blk.sid, _req(blk.sid, t))  # submit is pre-failure
        clock.advance(0.01)
        cl.step()
    st = cl.stats()
    assert st.failures == 1 and st.degraded  # 1/2 live < 0.75 watermark
    # new sessions refused, typed
    with pytest.raises(ClusterDegradedError, match="new session"):
        cl.open_session(qos=S)
    # BULK shed at the door, typed and counted — NOT in submitted
    before = dict(cl.stats().submitted)
    with pytest.raises(ClusterDegradedError, match="BULK"):
        cl.submit(blk.sid, _req(blk.sid, 99))
    st = cl.stats()
    assert st.submitted == before            # conservation untouched
    assert st.rejected_degraded[B.value] == 1
    # the streams the cluster already holds keep full service
    cl.submit(std.sid, _req(std.sid, 99))
    cl.pump()
    _assert_conserved(cl.stats())
    # capacity returns -> degraded clears itself
    cl.add_member("c", _server(params, clock))
    st = cl.stats()
    assert not st.degraded
    cl.open_session(qos=S)                   # admission resumed
    cl.submit(blk.sid, _req(blk.sid, 100))   # BULK resumed
    cl.pump()
    _assert_conserved(cl.stats())


def test_degraded_off_by_default(params):
    clock = FakeClock()
    members = {"a": _server(params, clock), "b": _server(params, clock)}
    cl = GatewayCluster(members, seed=3, snapshot_every=2,
                        injectors={"a": FailureInjector(fail_at=(1,))},
                        timer=clock)
    cl.open_session(qos=S)
    cl.step()
    assert cl.stats().failures == 1
    assert not cl.stats().degraded           # watermark 0: never
    cl.open_session(qos=S)                   # admission unaffected


# ---------------------------------------------------------------------------
# Repeated chaos: kill -> recover -> kill, conservation at every snapshot
# ---------------------------------------------------------------------------

def test_repeated_failover_conserves_and_loses_no_sessions(params):
    """Sessions that already failed over once fail over AGAIN when
    their new home dies: the journal re-homes with them, the books
    stay conserved at every snapshot, and no session is ever dropped
    while a buddy holds its journal."""
    clock = FakeClock()
    members = {n: _server(params, clock, max_batch=4)
               for n in ("a", "b", "c")}
    cl = GatewayCluster(members, seed=3, replicate=True,
                        injectors={"a": FailureInjector(fail_at=(4,)),
                                   "b": FailureInjector(fail_at=(9,))},
                        timer=clock)
    infos = [cl.open_session(qos=S) for _ in range(6)]
    homes0 = {i.sid: cl.session_member(i.sid) for i in infos}
    assert {"a", "b"} <= set(homes0.values())    # both victims serve
    for t in range(14):
        for i in infos:
            cl.submit(i.sid, _req(i.sid, t))
        clock.advance(0.01)
        cl.step()
        _assert_conserved(cl.stats())        # EVERY snapshot, mid-chaos
        if t == 6:                           # recover capacity between
            cl.add_member("d", _server(params, clock, max_batch=4))
    cl.pump()
    st = cl.stats()
    _assert_conserved(st)
    assert st.failures == 2
    assert "a" not in st.members and "b" not in st.members
    assert st.sessions_open == 6 and cl.lost_sessions == []
    assert st.failovers > 0 and st.failovers + st.migrations >= len(
        [s for s, m in homes0.items() if m in ("a", "b")])
    assert sum(st.lost_in_flight.values()) == 0  # per-step flush
    # every stream is still live end-to-end
    for i in infos:
        cl.submit(i.sid, _req(i.sid, 99))
    cl.pump()
    st = cl.stats()
    _assert_conserved(st)
    assert st.served == st.submitted
    for i in infos:
        cl.close_session(i.sid)
    _assert_conserved(cl.stats())


# ---------------------------------------------------------------------------
# stop(drain): typed timeout summary
# ---------------------------------------------------------------------------

def test_stop_drain_timeout_names_stragglers(params):
    clock = FakeClock()
    cl = GatewayCluster({"a": _server(params, clock)}, seed=0,
                        injectors={"a": FailureInjector(hang_from=1)},
                        timer=clock)
    info = cl.open_session(qos=S)
    cl.submit(info.sid, _req(info.sid, 0))
    cl.submit(info.sid, _req(info.sid, 1))
    with pytest.raises(ClusterDrainTimeout) as ei:
        cl.stop(drain=True, max_steps=25)
    assert ei.value.stragglers == {info.sid: 2}
    assert "2 outstanding" in str(ei.value)
    assert cl.stats().drain_stragglers == 1


def test_stop_drain_clean_path_unchanged(params):
    clock = FakeClock()
    cl = GatewayCluster({"a": _server(params, clock)}, seed=0,
                        timer=clock)
    info = cl.open_session(qos=S)
    cl.submit(info.sid, _req(info.sid, 0))
    cl.stop(drain=True)                      # drains fine, no raise
    st = cl.stats()
    assert st.served == st.submitted and st.drain_stragglers == 0


# ---------------------------------------------------------------------------
# Replication plumbing through migration
# ---------------------------------------------------------------------------

def test_drain_rehomes_journals_off_the_leaving_member(params):
    clock = FakeClock()
    members = {n: _server(params, clock) for n in ("a", "b", "c")}
    cl = GatewayCluster(members, seed=5, replicate=True, timer=clock)
    infos = [cl.open_session(qos=S) for _ in range(6)]
    for t in range(2):
        for i in infos:
            cl.submit(i.sid, _req(i.sid, t))
    cl.step()                                # flush: journals acked
    victim = cl.session_member(infos[0].sid)
    cl.drain(victim)
    # every journal now lives on a live non-owner
    log = cl._log
    for i in infos:
        j = log.journal(i.sid)
        owner = cl.session_member(i.sid)
        assert j.buddy is not None
        assert j.buddy != owner and j.buddy in cl.stats().members
    cl.pump()
    _assert_conserved(cl.stats())
    assert cl.stats().served == cl.stats().submitted


# ---------------------------------------------------------------------------
# The chaos lane, port against reference
# ---------------------------------------------------------------------------

def frozen_clock():
    """A clock that never moves: the lanes' members read it instead of
    the wall clock (see ``test_chaos_lane_matches_reference``)."""
    return 0.0


def test_chaos_lane_matches_reference(monkeypatch):
    """One seeded kill-mid-stream run with replication (2 members x 4
    sessions, 4 rounds) through the reference lane's ``_chaos_once`` and
    the port's ``cluster_chaos``, on the reference's encoder weights:
    the same victim and kill, every served ``(sid, t, k, route,
    wire_bytes)`` equal, ``z`` within ``Z_ATOL``, and every
    ``ClusterStats`` book equal but the pause times — journal bytes
    included (``entry_nbytes`` has no pickle in it).

    Both lanes' members run on ``frozen_clock``.  On the wall clock a
    slow run (a loaded machine) lets frames wait past STANDARD's 2 s
    aging threshold after the failover, the aging lane then composes the
    member's ticks differently, and its gateway's ``dispatches`` book
    moves (11 against 12 with a clock that advances 0.5 s a read).  On
    a clock that never moves no frame ages, so every book — the member
    books included — is compared, and none depends on the load."""
    sys.path.insert(0, str(Path(__file__).parents[1]))
    from benchmarks import cluster_serve as ref_lane
    monkeypatch.setitem(JaxGateway.__init__.__kwdefaults__, "clock",
                        frozen_clock)
    jparams, tparams = _jax_params()
    us = cluster_serve.spread_u(8)
    cl, infos, ref_results, t_next, victim = ref_lane._chaos_once(
        replicate=True, members=2, rounds=4, spm=4,
        cfg=JaxAudioEncCfg(**KW), params=jparams, us=us)
    assert all(srv.gateway.clock is frozen_clock
               for srv in cl._members.values())
    port = cluster_serve.cluster_chaos(2, replicate=True, device="cpu",
                                       enc_cfg=CFG, params=tparams,
                                       rounds=4, clock=frozen_clock)
    assert (port["victim"], port["t_next"], port["us"]) == \
        (victim, t_next, us)
    assert cluster_serve.books(port["stats"]) == \
        cluster_serve.books(cl.stats())
    assert port["journal_bytes"] == cl.stats().journal_bytes > 0
    theirs = {(r.sid, r.t): r for r in ref_results}
    ours = {(r.sid, r.t): r for r in port["results"]}
    assert len(ours) == len(port["results"]) == len(ref_results)
    assert ours.keys() == theirs.keys()
    worst = 0.0
    for key, r in ours.items():
        j = theirs[key]
        assert (r.k, r.route, r.wire_bytes) == (j.k, j.route, j.wire_bytes)
        worst = max(worst, float(np.abs(r.z - np.asarray(j.z)).max()))
    assert worst <= Z_ATOL, worst
    print(f"chaos lane: port vs reference max |dz| {worst:.3e} over "
          f"{len(ours)} frames; port's own replay oracle {port['parity']}")
    assert port["parity"]["frames"] == len(ours)


# ---------------------------------------------------------------------------
# A session carried across the two packages
# ---------------------------------------------------------------------------

def _jax_req(sid, t):
    rng = np.random.default_rng(5000 * (sid + 1) + t)
    return JaxFrameRequest(t=t, mel=_mel(sid, t), u=float(rng.random()))


def _jax_gw(jparams, clock, **kw):
    return JaxGateway(JaxAudioEncCfg(**KW), jparams,
                      policy=QuantilePolicy(L), capacity=4, window=8,
                      qos_reserve=0, overlap=True, clock=clock, **kw)


def _jax_snapshot(d):
    """The reference's ``SessionSnapshot`` built from
    ``session_snapshot_to_jax``'s dict."""
    server = None
    if d["server"] is not None:
        server = JaxServerSnap(**{**d["server"], "queued": tuple(
            JaxQueued(frame=JaxFrameRequest(**q["frame"]),
                      **{k: v for k, v in q.items() if k != "frame"})
            for q in d["server"]["queued"])})
    return JaxSnapshot(**{**d, "qos": JaxQoSClass(d["qos"]),
                          "sync_cfg": JaxSyncCfg(**d["sync_cfg"]),
                          "sync_events": tuple(JaxSyncEvent(**e) for e in
                                               d["sync_events"]),
                          "server": server})


def _books(info):
    return (info.platform, info.qos.value, info.frames, info.wire_bytes,
            info.sync_bytes, info.sync_events, info.transitions,
            info.last_k, info.fill_fraction)


def test_session_from_reference_continues_its_stream():
    """A reference session exported mid-stream (a gateway's ring row and
    books, and a server's queued frames with their ledger) imports into
    the port's gateway and server through
    ``session_snapshot_from_jax`` and continues as the reference
    continues it: every frame's ``(t, k, route, wire_bytes)`` equal,
    ``z`` within ``Z_ATOL``, and the session's books equal."""
    jparams, tparams = _jax_params()
    clock = FakeClock()
    sync = JaxSyncCfg(t_sync_frames=3)       # a few lazy-sync events
    src = JaxStreamServer(_jax_gw(jparams, clock, sync_cfg=sync),
                          cfg=JaxSchedulerCfg(max_batch=4), clock=clock,
                          rate_limit=(1000.0, 16))
    sid = src.open_session(platform="jetson",
                           qos=JaxQoSClass.INTERACTIVE, weight=2.0).sid
    for t in range(5):
        src.submit(sid, _jax_req(sid, t))
        clock.advance(0.01)
        src.step()
    src.quiesce()
    for t in range(5, 8):                    # queued, not yet served
        src.submit(sid, _jax_req(sid, t))
    snap = src.export_session(sid)
    assert len(snap.server.queued) == 3 and snap.sync_events
    ours = session_snapshot_from_jax(snap)
    # the same fields, value for value; the pickle differs only by the
    # module names it writes
    for name in ("platform", "frames", "wire_bytes", "transitions",
                 "last_k", "sync_last_gmm", "sync_last_weights",
                 "sync_total_bytes", "sync_total_energy_j", "ring_newest"):
        assert getattr(ours, name) == getattr(snap, name), name
    for name in ("ring_z", "ring_t", "ring_label"):
        np.testing.assert_array_equal(getattr(ours, name),
                                      getattr(snap, name))
    assert ours.qos is QoSClass.INTERACTIVE
    raw = ours.to_bytes()
    assert len(raw) - 6 * raw.count(b"repro_torch.") == snap.nbytes
    # and back: the reference's own bytes
    assert _jax_snapshot(session_snapshot_to_jax(ours)).to_bytes() == \
        snap.to_bytes()

    def resume(server, snap_, req):
        seen = []
        server._on_result = seen.append
        info = server.import_session(snap_)
        for t in range(8, 12):
            server.submit(info.sid, req(sid, t))
        while server.busy():
            clock.advance(0.01)
            server.step()
        return info.sid, seen

    ref_dst = JaxStreamServer(_jax_gw(jparams, clock),
                              cfg=JaxSchedulerCfg(max_batch=4), clock=clock)
    port_dst = StreamServer(_gw(tparams, clock, capacity=4),
                            cfg=SchedulerCfg(max_batch=4), clock=clock)
    rsid, rseen = resume(ref_dst, snap, _jax_req)
    psid, pseen = resume(port_dst, ours, _req)
    assert [r.t for r in pseen] == [r.t for r in rseen] == list(range(5, 12))
    worst = 0.0
    for p, r in zip(pseen, rseen):
        assert (p.t, p.k, p.route, p.wire_bytes) == \
            (r.t, r.k, r.route, r.wire_bytes)
        worst = max(worst, float(np.abs(p.z - np.asarray(r.z)).max()))
    assert worst <= Z_ATOL, worst
    print(f"session from the reference: max |dz| {worst:.3e} over "
          f"{len(pseen)} frames")
    assert _books(port_dst.gateway.session(psid)) == \
        _books(ref_dst.gateway.session(rsid))
    ps, rs = port_dst.stats(), ref_dst.stats()
    assert ps.frames_submitted == rs.frames_submitted
    assert ps.frames_served == rs.frames_served


def test_session_to_reference_round_trip():
    """The port's session snapshot as ``session_snapshot_to_jax``'s
    plain dict: the reference's dataclasses build from it, the reference
    continues the stream as the port does, and
    ``session_snapshot_from_jax`` of those dataclasses gives the port's
    snapshot back, byte for byte."""
    jparams, tparams = _jax_params()
    clock = FakeClock()
    src = _gw(tparams, clock, capacity=4)
    sid = src.open_session(platform="m2", qos=S).sid
    for t in range(6):
        src.submit(sid, _req(sid, t))
        src.tick()
    snap = src.export_session(sid)
    d = session_snapshot_to_jax(snap)
    assert isinstance(d["qos"], str) and isinstance(d["ring_z"], np.ndarray)
    theirs = _jax_snapshot(d)
    assert session_snapshot_from_jax(theirs).to_bytes() == snap.to_bytes()
    ref_dst = _jax_gw(jparams, clock)
    port_dst = _gw(tparams, clock, capacity=4)
    rinfo = ref_dst.import_session(theirs)
    pinfo = port_dst.import_session(snap)
    assert _books(pinfo) == _books(rinfo)
    worst = 0.0
    for t in range(6, 10):
        ref_dst.submit(rinfo.sid, _jax_req(sid, t))
        port_dst.submit(pinfo.sid, _req(sid, t))
        (r,) = ref_dst.tick()
        (p,) = port_dst.tick()
        assert (p.t, p.k, p.route, p.wire_bytes) == \
            (r.t, r.k, r.route, r.wire_bytes)
        worst = max(worst, float(np.abs(p.z - np.asarray(r.z)).max()))
    assert worst <= Z_ATOL, worst
    assert _books(port_dst.session(pinfo.sid)) == \
        _books(ref_dst.session(rinfo.sid))

