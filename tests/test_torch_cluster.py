"""The port's gateway federation (``repro_torch.cluster``) on the CPU:
the oracles of the reference's ``tests/test_cluster.py`` at its tiny
encoder and fake clock — consistent-hash ring determinism and
stability, session snapshot export/import (gateway- and server-level),
the live-migration oracle, drain/rebalance conservation, and injected
member failure with ``lost_in_flight`` counted — plus the port against
the reference: the ring's placements key for key, and one seeded run of
the drain lane (``runtime/cluster_serve.py`` against
``benchmarks/cluster_serve.py``) with every served ``(sid, t, k, route,
wire_bytes)`` equal, ``z`` within 1e-4 and the ``ClusterStats`` books
equal.

The reference's migration oracle is bitwise.  The port's cannot be:
its buckets are padded to a power of two and torch's convolutions are
not batch-invariant, so a migrated frame and its unmigrated replay may
part in the last bits.  The port holds ``(sid, t, k, route,
wire_bytes)`` exactly, "served exactly once", conservation exactly, and
``z`` at ``Z_ATOL`` = 1e-4 (the bound it holds across frameworks and
card against CPU); the oracles print the largest ``|dz|`` and how many
frames matched bitwise.  ``migrated_bytes`` is the port's own pickle
length: the pickle names each class's module, so it differs from the
reference's by that length.

The reference's two tests over ``ShardedFleetBackend`` have their
counterparts here (host -> sharded and back, the int32 timestamp
check), with one more: the drain lane on members whose gateways run a
1-shard ``ShardedFleetBackend``, held against the same lane on host
members.
"""
import sys

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.cluster as jax_cluster  # noqa: E402
from repro.api import StreamSplitGateway as JaxGateway  # noqa: E402
from repro.cluster import HashRing as JaxHashRing  # noqa: E402
from repro.models.audio_encoder import AudioEncCfg as JaxAudioEncCfg  # noqa: E402,E501
from repro.models.audio_encoder import \
    init_audio_encoder as jax_init_audio_encoder  # noqa: E402
from repro_torch.api import (AdmissionError, ClusterStats,  # noqa: E402
                             FrameRequest, QoSClass, SessionSnapshot,
                             ShardedFleetBackend, StreamSplitGateway)
from repro_torch.cluster import (FailureInjector, GatewayCluster,  # noqa: E402
                                 HashRing)
from repro_torch.models.audio_encoder import (AudioEncCfg,  # noqa: E402
                                              init_audio_encoder)
from repro_torch.runtime import cluster_serve  # noqa: E402
from repro_torch.serving import (QueueFullError, SchedulerCfg,  # noqa: E402
                                 StragglerMonitor, StreamServer)
from repro_torch.weights import params_from_jax  # noqa: E402

KW = dict(widths=(8, 8), strides=(1, 1), n_mels=8, frames=8, d_embed=16,
          groups=2)
CFG = AudioEncCfg(**KW)
L = CFG.n_blocks
N_CLASSES = 4
Z_ATOL = cluster_serve.Z_ATOL
I, S, B = QoSClass.INTERACTIVE, QoSClass.STANDARD, QoSClass.BULK


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per test worker (results do not depend on
    it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params():
    return init_audio_encoder(CFG, torch.Generator().manual_seed(0))


class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


class QuantilePolicy:
    """u quantile -> split index: deterministic per frame CONTENT, so a
    frame's k is independent of batch composition and serving order."""

    def __init__(self, L):
        self.L = L

    def decide(self, obs_batch):
        return np.clip((obs_batch[:, 0] * (self.L + 1)).astype(np.int64),
                       0, self.L)


def _head():
    def head_init(generator):
        return {"w": 0.01 * torch.randn(CFG.d_embed, N_CLASSES,
                                        generator=generator)}

    def head_apply(p, z):
        return z @ p["w"]

    return head_init, head_apply


def _mel(sid, t):
    rng = np.random.default_rng(1000 * (sid + 1) + t)
    return rng.normal(size=(CFG.frames, CFG.n_mels)).astype(np.float32)


def _req(sid, t, label=-1):
    rng = np.random.default_rng(5000 * (sid + 1) + t)
    return FrameRequest(t=t, mel=_mel(sid, t), u=float(rng.random()),
                        label=label)


def _gw(params, clock, *, capacity=8, **kw):
    """A CPU gateway of the tiny encoder (``clock`` None: the real
    clock)."""
    if clock is not None:
        kw["clock"] = clock
    return StreamSplitGateway(CFG, params, policy=QuantilePolicy(L),
                              capacity=capacity, window=8, qos_reserve=0,
                              overlap=True, device="cpu", **kw)


def _server(params, clock, *, max_batch=8, **kw):
    gw_kw = {k: kw.pop(k) for k in list(kw)
             if k in ("capacity", "head_init", "head_apply", "refine_every")}
    return StreamServer(_gw(params, clock, **gw_kw),
                        cfg=SchedulerCfg(max_batch=max_batch), clock=clock,
                        **kw)


def _assert_conserved(st):
    assert st.conserved, (st.submitted, st.served, st.queue_depth,
                          st.in_flight, st.shed_expired, st.lost_in_flight)


def _assert_member_conserved(st):
    """Per-member ``StreamStats`` conservation (no lost term: a live
    member never loses frames)."""
    for c in st.frames_submitted:
        assert st.frames_submitted[c] == (
            st.frames_served[c] + st.queue_depth[c] + st.in_flight[c]
            + st.shed_expired[c]), (c, st.frames_submitted,
                                    st.frames_served, st.queue_depth,
                                    st.in_flight, st.shed_expired)


def _hold_against_replay(params, by, sids, n_frames, what):
    """Every ``(sid, t)`` served once, held against one fresh gateway
    serving that frame alone: ``t``, ``k``, ``route``, ``wire_bytes``
    equal, ``z`` within ``Z_ATOL``.  Prints the largest ``|dz|`` and
    the frames that matched bitwise."""
    oracle = _gw(params, FakeClock(), capacity=len(sids))
    worst, bitwise = 0.0, 0
    for sid in sids:
        osid = oracle.open_session().sid
        for t in range(n_frames):
            oracle.submit(osid, _req(sid, t))
            (r,) = oracle.tick()
            got = by[(sid, t)]
            assert (got.t, got.k, got.route, got.wire_bytes) == \
                (r.t, r.k, r.route, r.wire_bytes)
            dz = float(np.abs(got.z - r.z).max())
            assert dz <= Z_ATOL, (sid, t, dz)
            worst = max(worst, dz)
            bitwise += bool(np.array_equal(got.z, r.z))
    n = len(sids) * n_frames
    print(f"{what}: {n} frames, max |dz| {worst:.3e} (atol {Z_ATOL}), "
          f"{bitwise} of {n} bitwise")
    return worst, bitwise


# ---------------------------------------------------------------------------
# HashRing: determinism, consistency, weight bias — and the reference's
# placements key for key
# ---------------------------------------------------------------------------

def test_ring_deterministic_and_seeded():
    r1 = HashRing(["a", "b", "c"], seed=7)
    r2 = HashRing(["c", "a", "b"], seed=7)   # order-independent
    assert [r1.owner(k) for k in range(200)] == \
        [r2.owner(k) for k in range(200)]
    r3 = HashRing(["a", "b", "c"], seed=8)   # seed changes placement
    assert [r1.owner(k) for k in range(200)] != \
        [r3.owner(k) for k in range(200)]


def test_ring_add_moves_keys_only_to_newcomer():
    r = HashRing(["a", "b"], seed=0)
    before = {k: r.owner(k) for k in range(500)}
    r.add("c")
    moved = {k for k in before if r.owner(k) != before[k]}
    assert moved                                # c took a real share
    assert all(r.owner(k) == "c" for k in moved)


def test_ring_remove_reassigns_only_departed_keys():
    r = HashRing(["a", "b", "c"], seed=0)
    before = {k: r.owner(k) for k in range(500)}
    r.remove("c")
    for k, m in before.items():
        if m != "c":
            assert r.owner(k) == m              # survivors keep theirs


def test_ring_share_sums_to_one_and_weight_bias():
    r = HashRing(["a", "b", "c"], seed=1)
    sh = r.share()
    assert abs(sum(sh.values()) - 1.0) < 1e-9
    assert all(v > 0.05 for v in sh.values())   # vnodes smooth the arcs
    before = r.share()["b"]
    r.set_weight("b", 0.25)
    after = r.share()["b"]
    assert after < before                        # straggler bias shrinks b
    assert abs(sum(r.share().values()) - 1.0) < 1e-9


def test_ring_preference_walk_and_empty():
    r = HashRing(["a", "b", "c"], seed=2)
    for k in range(50):
        pref = r.preference(k)
        assert sorted(pref) == ["a", "b", "c"]   # all distinct members
        assert pref[0] == r.owner(k)             # owner first
    empty = HashRing()
    assert empty.preference(1) == []
    with pytest.raises(KeyError):
        empty.owner(1)
    with pytest.raises(ValueError):
        HashRing(["a"]).add("a")


@pytest.mark.parametrize("seed,vnodes,members", [
    (0, 64, ("g0", "g1")),
    (3, 64, ("a", "b", "c")),
    (7, 1, ("a", "b", "c", "d")),
    (11, 16, ("g0", "g1", "g2", "g3", "g4")),
    (-5, 128, ("alpha", "beta")),
])
def test_ring_placement_matches_reference(seed, vnodes, members):
    """1,000 keys: owner, preference walk, buddy past the owner and the
    hash-space shares equal the reference's exactly — through a weight
    change, a removal and an addition."""
    ours = HashRing(members, seed=seed, vnodes=vnodes)
    ref = JaxHashRing(members, seed=seed, vnodes=vnodes)

    def same():
        for k in range(1000):
            assert ours.owner(k) == ref.owner(k)
            assert ours.preference(k) == ref.preference(k)
            assert ours.buddy(k, exclude=(ours.owner(k),)) == \
                ref.buddy(k, exclude=(ref.owner(k),))
        assert ours.share() == ref.share()
        assert ours.members == ref.members

    same()
    for ring in (ours, ref):
        ring.set_weight(members[0], 0.25)
    same()
    for ring in (ours, ref):
        ring.remove(members[-1])
        ring.add("newcomer", weight=1.5)
    same()


# ---------------------------------------------------------------------------
# The cluster types against the reference's
# ---------------------------------------------------------------------------

def test_cluster_types_match_reference():
    from dataclasses import fields

    from repro.api import ClusterStats as JaxClusterStats
    from repro.cluster import ClusterDegradedError as JaxDegraded
    from repro.cluster import ClusterDrainTimeout as JaxDrainTimeout
    from repro_torch.api import ClusterDegradedError, ClusterDrainTimeout
    assert [(f.name, f.type) for f in fields(ClusterStats)] == \
        [(f.name, f.type) for f in fields(JaxClusterStats)]
    assert str(ClusterDegradedError(1, 2, 0.75, "BULK frame")) == \
        str(JaxDegraded(1, 2, 0.75, "BULK frame"))
    assert str(ClusterDrainTimeout({3: 2, 1: 4}, 25)) == \
        str(JaxDrainTimeout({3: 2, 1: 4}, 25))
    per = {q.value: 1 for q in QoSClass}
    zero = {q.value: 0 for q in QoSClass}
    st = ClusterStats(
        members=("a",), sessions_open=1, submitted=per, served=per,
        queue_depth=zero, in_flight=zero, shed_expired=zero,
        lost_in_flight=zero, rejected_full=zero,
        rejected_rate_limited=zero, migrations=0, migrated_frames=0,
        migrated_bytes=0, migration_pause_ms={}, drains=0, failures=0,
        ring_share={"a": 1.0}, member_stats={})
    assert st.conserved and st.rejected_degraded == {}
    assert not ClusterStats(**{**st.__dict__, "served": zero}).conserved


# ---------------------------------------------------------------------------
# SessionSnapshot: gateway-level export/import
# ---------------------------------------------------------------------------

def test_gateway_export_import_roundtrip_bits_and_books(params):
    clock = FakeClock()
    src, dst = _gw(params, clock), _gw(params, clock)
    sid = src.open_session(platform="jetson", qos=I).sid
    for t in range(5):
        src.submit(sid, _req(sid, t))
        src.tick()
    before = src.session(sid)
    snap = src.export_session(sid)
    # the exported row is the host representation, bit-exact
    assert snap.ring_t.dtype == np.int64 and snap.ring_newest == 4
    # serialization round-trips bitwise
    snap2 = SessionSnapshot.from_bytes(snap.to_bytes())
    np.testing.assert_array_equal(snap.ring_z, snap2.ring_z)
    np.testing.assert_array_equal(snap.ring_t, snap2.ring_t)
    assert snap.nbytes > 0
    # the source counted an export, not a close; the row is gone
    s = src.stats()
    assert s.sessions_exported == 1 and s.sessions_closed == 0
    assert s.sessions_open == 0
    with pytest.raises(KeyError):
        src.session(sid)
    # import restores every book the SessionInfo surfaces
    info = dst.import_session(snap2)
    after = dst.session(info.sid)
    assert after.frames == before.frames == 5
    assert after.wire_bytes == before.wire_bytes
    assert after.transitions == before.transitions
    assert after.last_k == before.last_k
    assert after.qos is I and after.platform == "jetson"
    assert after.fill_fraction == before.fill_fraction
    assert dst.stats().sessions_imported == 1
    # the stream continues where it left off
    dst.submit(info.sid, _req(sid, 5))
    (r,) = dst.tick()
    assert r.t == 5


def test_gateway_export_refuses_pending_frames(params):
    clock = FakeClock()
    gw = _gw(params, clock)
    sid = gw.open_session().sid
    gw.submit(sid, _req(sid, 0))
    with pytest.raises(RuntimeError, match="pending"):
        gw.export_session(sid)
    gw.tick()
    gw.export_session(sid)          # drained: export succeeds


def test_gateway_import_obeys_admission_policy(params):
    clock = FakeClock()
    src = _gw(params, clock, capacity=4)
    dst = _gw(params, clock, capacity=1)
    a = src.open_session(qos=B).sid
    b = src.open_session(qos=B).sid
    dst.import_session(src.export_session(a))
    with pytest.raises(AdmissionError):          # dst is full
        dst.import_session(src.export_session(b))


def test_export_import_refine_row_transfer_bit_parity(params):
    """The ring-row transfer oracle: after migrating every session, one
    refine round (the same round, so the same draws) on the destination
    gives the SAME loss and per-session losses, bitwise, as on a gateway
    whose sessions never moved."""
    head_init, head_apply = _head()
    clock = FakeClock()

    def mk():
        return _gw(params, clock, capacity=4, head_init=head_init,
                   head_apply=head_apply, refine_every=0)

    stay, src, dst = mk(), mk(), mk()
    sids_stay = [stay.open_session().sid for _ in range(3)]
    sids_src = [src.open_session().sid for _ in range(3)]
    for t in range(6):
        for i in range(3):
            stay.submit(sids_stay[i], _req(i, t, label=t % N_CLASSES))
            src.submit(sids_src[i], _req(i, t, label=t % N_CLASSES))
        stay.tick()
        src.tick()
    for i in range(3):               # migrate all three sessions
        dst.import_session(src.export_session(sids_src[i]))
    loss_stay, _, per_stay = stay.backend.refine(42)
    loss_dst, _, per_dst = dst.backend.refine(42)
    np.testing.assert_array_equal(np.asarray(loss_stay),
                                  np.asarray(loss_dst))
    np.testing.assert_array_equal(np.asarray(per_stay),
                                  np.asarray(per_dst))


def _sharded(capacity=4, **kw):
    return ShardedFleetBackend(capacity=capacity, window=8, dim=CFG.d_embed,
                               device="cpu", **kw)


def test_export_import_across_backends_host_to_sharded(params):
    """Snapshots are backend-portable: a host-ring session implants
    into a device-resident sharded fleet (sentinel remap included) and
    refines to the same loss, bitwise, as a sharded twin that served the
    stream itself."""
    head_init, head_apply = _head()
    clock = FakeClock()
    host = _gw(params, clock, capacity=4, head_init=head_init,
               head_apply=head_apply, refine_every=0)
    sharded = _gw(params, clock, refine_every=0, backend=_sharded(
        head_init=head_init, head_apply=head_apply, lr=1e-2, seed=0))
    twin = _gw(params, clock, refine_every=0, backend=_sharded(
        head_init=head_init, head_apply=head_apply, lr=1e-2, seed=0))
    sid_h = host.open_session().sid
    sid_t = twin.open_session().sid
    for t in range(5):
        host.submit(sid_h, _req(0, t, label=t % N_CLASSES))
        twin.submit(sid_t, _req(0, t, label=t % N_CLASSES))
        host.tick()
        twin.tick()
    snap = host.export_session(sid_h)
    info = sharded.import_session(snap)
    # gap slots round-trip: sentinel-remapped, not fake timestamps
    z, t_row, label, newest = sharded.backend.export_row(info.sid)
    np.testing.assert_array_equal(t_row, snap.ring_t)
    np.testing.assert_array_equal(z, snap.ring_z)
    np.testing.assert_array_equal(label, snap.ring_label)
    assert newest == snap.ring_newest
    loss_m, _, per_m = sharded.backend.refine(3)
    loss_t, _, per_t = twin.backend.refine(3)
    assert loss_m == loss_t
    np.testing.assert_array_equal(per_m, per_t)
    # and back: the sharded row implants into a host fleet unchanged
    back = _gw(params, clock, capacity=4)
    info_b = back.import_session(sharded.export_session(info.sid))
    for x, y in zip(back.backend.export_row(info_b.sid), (z, t_row, label,
                                                          newest)):
        np.testing.assert_array_equal(x, y)


def test_sharded_import_rejects_out_of_range_timestamps():
    b = ShardedFleetBackend(capacity=2, window=4, dim=3, device="cpu")
    sid = b.admit()
    t = np.full((4,), np.iinfo(np.int64).max // 2, np.int64)
    with pytest.raises(ValueError, match="int32"):
        b.import_row(sid, np.zeros((4, 3), np.float32), t,
                     np.full((4,), -1, np.int64), 1)


def test_drain_lane_on_sharded_members_matches_host_members():
    """The drain lane with every member's gateway on a 1-shard
    ``ShardedFleetBackend``: zero shed and zero lost, the replay oracle,
    and every served frame and ``ClusterStats`` book equal to the same
    lane on host-backend members (the embeddings bitwise: a 1-shard
    sharded gateway serves the host gateway's bits)."""
    kw = dict(device="cpu", enc_cfg=CFG, params=init_audio_encoder(
        CFG, torch.Generator().manual_seed(0)), rounds=4,
        clock=frozen_clock)
    lanes = {fleet: cluster_serve.cluster_drain(2, fleet=fleet, **kw)
             for fleet in ("host", "sharded")}
    host, shrd = lanes["host"], lanes["sharded"]
    assert shrd["shed_expired"] == shrd["lost_in_flight"] == 0
    assert shrd["migrations"] == host["migrations"] > 0
    assert cluster_serve.books(shrd["stats"]) == \
        cluster_serve.books(host["stats"])
    ours = {(r.sid, r.t): r for r in shrd["results"]}
    theirs = {(r.sid, r.t): r for r in host["results"]}
    assert ours.keys() == theirs.keys()
    for key, r in ours.items():
        h = theirs[key]
        assert (r.k, r.route, r.wire_bytes) == (h.k, h.route, h.wire_bytes)
        np.testing.assert_array_equal(r.z, h.z)
    assert shrd["parity"]["max_abs_dz"] <= Z_ATOL


# ---------------------------------------------------------------------------
# StreamServer-level export/import: queued frames + books migrate
# ---------------------------------------------------------------------------

def test_server_export_import_moves_queued_frames_and_books(params):
    clock = FakeClock()
    src = _server(params, clock, rate_limit=(10.0, 8))
    dst = _server(params, clock)
    sid = src.open_session(qos=S, weight=2.0).sid
    # serve two frames, then queue three more without stepping
    for t in range(2):
        src.submit(sid, _req(sid, t))
        clock.advance(0.01)
        src.step()
    src.quiesce()
    for t in range(2, 5):
        src.submit(sid, _req(sid, t))
    st_src = src.stats()
    depth_before = sum(st_src.queue_depth.values())
    snap = src.export_session(sid)
    assert snap.server is not None
    assert (snap.server.submitted, snap.server.served) == (5, 2)
    assert len(snap.server.queued) == 3
    assert snap.server.weight == 2.0
    assert snap.server.bucket is not None       # token-bucket level moves
    # the frames' ledger left with them: source conservation holds with
    # zero depth for the departed session
    st = src.stats()
    _assert_member_conserved(st)
    assert sum(st.queue_depth.values()) == depth_before - 3
    info = dst.import_session(snap)
    st = dst.stats()
    _assert_member_conserved(st)
    assert sum(st.queue_depth.values()) == 3
    # the queued frames serve on the new owner with original identity
    seen = []
    dst._on_result = seen.append
    while dst.busy():
        clock.advance(0.01)
        dst.step()
    assert [r.t for r in seen] == [2, 3, 4]
    # close drains cleanly: books balanced (5 submitted = 5 served)
    dst.close_session(info.sid)
    assert dst.stats().gateway.sessions_open == 0


def test_server_export_requires_quiesce(params):
    clock = FakeClock()
    srv = _server(params, clock)
    sid = srv.open_session().sid
    srv.submit(sid, _req(sid, 0))
    clock.advance(0.01)
    srv.step()                       # pipelined: plan now in flight
    with pytest.raises(RuntimeError, match="quiesce"):
        srv.export_session(sid)
    srv.quiesce()
    snap = srv.export_session(sid)   # in-flight collected: exports fine
    assert snap.server.served == 1


def test_server_import_merges_queued_frames_in_enq_order(params):
    """Migrated frames interleave with the target's own by ORIGINAL
    arrival time, so EDF order is preserved across migration."""
    clock = FakeClock()
    src = _server(params, clock)
    dst = _server(params, clock)
    a = src.open_session(qos=B).sid
    b = dst.open_session(qos=B).sid
    # interleaved arrivals: src at t=0.0, 0.2; dst at 0.1, 0.3
    src.submit(a, _req(a, 0))
    clock.advance(0.1)
    dst.submit(b, _req(b, 0))
    clock.advance(0.1)
    src.submit(a, _req(a, 1))
    clock.advance(0.1)
    dst.submit(b, _req(b, 1))
    snap = src.export_session(a)
    info = dst.import_session(snap)
    with dst.queues.cond:
        order = [(qf.sid, qf.frame.t, qf.enq_s)
                 for qf in dst.queues.by_class[B].q]
        seqs = [qf.seq for qf in dst.queues.by_class[B].q]
    assert [e for (_, _, e) in order] == sorted(e for (_, _, e) in order)
    assert order[0][0] == info.sid and order[0][1] == 0   # oldest first
    assert seqs == sorted(seqs)      # seq order agrees with queue order


# ---------------------------------------------------------------------------
# The live-migration oracle
# ---------------------------------------------------------------------------

def _run_cluster_stream(params, clock, *, drain_at=None, n_sessions=4,
                        n_frames=8, seed=11):
    members = {"a": _server(params, clock), "b": _server(params, clock)}
    served = []
    cl = GatewayCluster(members, seed=seed, timer=clock,
                        on_result=served.append)
    infos = [cl.open_session(qos=S) for _ in range(n_sessions)]
    for t in range(n_frames):
        if drain_at is not None and t == drain_at:
            victim = sorted({cl.session_member(i.sid) for i in infos})[0]
            moved = cl.drain(victim)
            assert moved > 0         # the drain actually migrated work
        for i in infos:
            cl.submit(i.sid, _req(i.sid, t))
        clock.advance(0.01)
        cl.step()
        _assert_conserved(cl.stats())
    cl.pump()
    _assert_conserved(cl.stats())
    for i in infos:
        cl.close_session(i.sid)
    return cl, infos, served


def test_live_migration_parity_oracle(params):
    """THE acceptance oracle: sessions snapshot-transferred between two
    gateways mid-stream serve every frame exactly once with the split
    index, route and wire bytes of the sequential single-gateway run on
    the same frames, and its embeddings within ``Z_ATOL``."""
    clock = FakeClock()
    cl, infos, served = _run_cluster_stream(params, clock, drain_at=4)
    assert cl.stats().migrations > 0
    # every (session, t) served exactly once, with original identity
    by = {}
    for r in served:
        assert (r.sid, r.t) not in by
        by[(r.sid, r.t)] = r
    sids = sorted({sid for sid, _ in by})
    assert sids == [i.sid for i in infos]
    assert sorted(by) == [(s, t) for s in sids for t in range(8)]
    _hold_against_replay(params, by, sids, 8, "live migration")


def test_drain_conserves_and_serves_queued_frames(params):
    """Queued frames at drain time are replayed on the new owner with
    their ORIGINAL deadlines — none shed, none lost, and the books
    balance: submitted == served cluster-wide after the drain."""
    clock = FakeClock()
    members = {"a": _server(params, clock), "b": _server(params, clock)}
    cl = GatewayCluster(members, seed=5, timer=clock)
    infos = [cl.open_session(qos=S) for _ in range(4)]
    # build a backlog, then drain the busier member mid-stream
    for t in range(3):
        for i in infos:
            cl.submit(i.sid, _req(i.sid, t))
    victim = cl.session_member(infos[0].sid)
    homed = [i.sid for i in infos if cl.session_member(i.sid) == victim]
    moved = cl.drain(victim)
    assert moved == len(homed)       # exactly the victim's sessions moved
    st = cl.stats()
    _assert_conserved(st)
    assert victim not in st.members
    assert st.drains == 1 and st.migrated_frames > 0
    cl.pump()
    st = cl.stats()
    _assert_conserved(st)
    assert st.served == st.submitted            # every frame served
    assert sum(st.shed_expired.values()) == 0
    assert sum(st.lost_in_flight.values()) == 0
    # the drained member can come back and take new placements
    cl.add_member(victim, _server(params, clock))
    assert victim in cl.stats().members


def test_drained_member_rejoins_without_double_counting(params):
    """``drain()`` parks the member server for reuse; ``add_member()``
    with the SAME object must re-interpose the delivery callbacks
    cleanly (not double-wrap them: every frame would count twice)."""
    clock = FakeClock()
    servers = {"a": _server(params, clock), "b": _server(params, clock)}
    cl = GatewayCluster(dict(servers), seed=5, timer=clock)
    infos = [cl.open_session(qos=S) for _ in range(4)]
    victim = cl.session_member(infos[0].sid)
    cl.drain(victim)
    # identical membership -> identical ring -> ownership reverts
    assert cl.add_member(victim, servers[victim]) > 0
    for t in range(4):
        for i in infos:
            cl.submit(i.sid, _req(i.sid, t))
        clock.advance(0.01)
        cl.step()
        _assert_conserved(cl.stats())
    cl.pump()
    st = cl.stats()
    _assert_conserved(st)
    assert st.served == st.submitted
    assert sum(st.served.values()) == 16    # once each, not twice
    for i in infos:
        cl.close_session(i.sid)


def test_drain_refuses_last_member_with_sessions(params):
    clock = FakeClock()
    cl = GatewayCluster({"a": _server(params, clock)}, timer=clock)
    cl.open_session()
    with pytest.raises(RuntimeError, match="only member"):
        cl.drain("a")


def test_add_member_rebalances_only_moved_ownership(params):
    clock = FakeClock()
    members = {"a": _server(params, clock), "b": _server(params, clock)}
    cl = GatewayCluster(members, seed=9, timer=clock)
    infos = [cl.open_session(qos=S) for _ in range(8)]
    before = {i.sid: cl.session_member(i.sid) for i in infos}
    ring_twin = HashRing(["a", "b"], seed=9)
    ring_twin.add("c")
    cl.add_member("c", _server(params, clock))
    for i in infos:
        now = cl.session_member(i.sid)
        want = ring_twin.owner(i.sid)
        if want == "c":
            assert now == "c"                   # moved to the newcomer
        else:
            assert now == before[i.sid]         # everyone else untouched
    _assert_conserved(cl.stats())


# ---------------------------------------------------------------------------
# Chaos: injected member failure, straggler bias
# ---------------------------------------------------------------------------

def test_member_failure_counts_lost_and_restores_from_checkpoint(params):
    clock = FakeClock()
    members = {"a": _server(params, clock, max_batch=4),
               "b": _server(params, clock, max_batch=4)}
    cl = GatewayCluster(members, seed=3, snapshot_every=2,
                        injectors={"a": FailureInjector(fail_at=(6,))},
                        timer=clock)
    infos = [cl.open_session(qos=S) for _ in range(4)]
    homes = {i.sid: cl.session_member(i.sid) for i in infos}
    assert "a" in homes.values()                # the victim serves work
    for t in range(10):
        for i in infos:
            cl.submit(i.sid, _req(i.sid, t))
        clock.advance(0.01)
        cl.step()
        _assert_conserved(cl.stats())           # ...including mid-chaos
    cl.pump()
    st = cl.stats()
    _assert_conserved(st)
    assert st.failures == 1 and st.members == ("b",)
    # the death was not silent: queued+in-flight frames are counted
    assert sum(st.lost_in_flight.values()) > 0
    # every session survived via its checkpoint and kept serving
    assert st.sessions_open == 4 and cl.lost_sessions == []
    assert all(cl.session_member(i.sid) == "b" for i in infos)
    # streams continue after recovery
    for i in infos:
        cl.submit(i.sid, _req(i.sid, 99))
    cl.pump()
    _assert_conserved(cl.stats())
    for i in infos:
        cl.close_session(i.sid)
    _assert_conserved(cl.stats())
    # the black box survived the event it explains
    assert len(cl.failover_dumps) == 1
    assert cl.failover_dumps[0]["reason"] == "member_failed:a"


def test_member_failure_without_checkpoints_drops_visibly(params):
    clock = FakeClock()
    members = {"a": _server(params, clock), "b": _server(params, clock)}
    cl = GatewayCluster(members, seed=3, snapshot_every=0,
                        injectors={"a": FailureInjector(fail_at=(3,))},
                        timer=clock)
    infos = [cl.open_session(qos=S) for _ in range(4)]
    victims = [i.sid for i in infos if cl.session_member(i.sid) == "a"]
    assert victims
    for t in range(5):
        for i in infos:
            try:
                cl.submit(i.sid, _req(i.sid, t))
            except KeyError:
                assert i.sid in victims         # dropped sessions refuse
        clock.advance(0.01)
        cl.step()
        _assert_conserved(cl.stats())
    st = cl.stats()
    assert sorted(cl.lost_sessions) == sorted(victims)
    assert st.sessions_open == 4 - len(victims)
    assert sum(st.lost_in_flight.values()) > 0   # explicit, never silent
    _assert_conserved(st)


def test_straggler_signal_shrinks_ring_share(params):
    """An injected step-duration source makes member a stall; the
    monitor flags it and the stepping loop shrinks a's hash-space share
    — new placements drift to b, nothing already placed is evicted."""
    clock = FakeClock()
    members = {"a": _server(params, clock), "b": _server(params, clock)}
    # timer readings per step, members in sorted order: (a.t0, a.t1,
    # b.t0, b.t1).  Six healthy 10ms steps, then a stalls for 5s.
    vals = [0.0, 0.01, 0.0, 0.01] * 6 + [0.0, 5.0, 0.0, 0.01]
    it = iter(vals)
    cl = GatewayCluster(
        members, seed=1,
        straggler_factory=lambda: StragglerMonitor(factor=3.0, window=8,
                                                   warmup=3),
        straggler_weight=0.25, timer=lambda: next(it, 0.0))
    share0 = cl.stats().ring_share["a"]
    for _ in range(7):
        cl.step()
    assert cl._stragglers["a"].events            # the stall was flagged
    assert not cl._stragglers["b"].events
    share1 = cl.stats().ring_share["a"]
    assert share1 < share0                       # placement bias applied
    assert abs(sum(cl.stats().ring_share.values()) - 1.0) < 1e-9
    # placement now prefers b (members have 8 rows each)
    homes = [cl.session_member(cl.open_session().sid) for _ in range(12)]
    assert homes.count("b") > homes.count("a")


def test_cluster_rejections_counted_at_federation_boundary(params):
    clock = FakeClock()
    cl = GatewayCluster(
        {"a": _server(params, clock, queue_maxlen=2)}, timer=clock)
    info = cl.open_session(qos=B, rate_limit=None)
    cl.submit(info.sid, _req(0, 0))
    cl.submit(info.sid, _req(0, 1))
    with pytest.raises(QueueFullError):
        cl.submit(info.sid, _req(0, 2))
    st = cl.stats()
    assert st.rejected_full["bulk"] == 1
    assert st.submitted["bulk"] == 2            # refusals never counted
    _assert_conserved(st)


def test_cluster_refuses_started_members(params):
    clock = FakeClock()
    srv = _server(params, clock)
    srv.start()
    try:
        with pytest.raises(ValueError, match="serving thread"):
            GatewayCluster({"a": srv}, timer=clock)
    finally:
        srv.stop()


def test_member_started_after_joining_is_refused_at_its_turn(params):
    """Two threads must never drive one member: a member whose own
    serving thread was started after it joined is refused at its next
    turn, typed, and not failed over as if it had died."""
    clock = FakeClock()
    srv = _server(params, clock)
    cl = GatewayCluster({"a": srv}, timer=clock)
    info = cl.open_session(qos=S)
    cl.submit(info.sid, _req(0, 0))
    srv.start()
    try:
        with pytest.raises(RuntimeError, match="own serving thread"):
            cl.step()
    finally:
        srv.stop()
    assert cl.stats().failures == 0 and cl.stats().members == ("a",)


def test_cluster_stepping_thread_serves_and_stops_drained(params):
    """``start()`` runs the cluster's own stepping thread on the real
    clock: clients submit from their thread, ``stop(drain=True)`` joins
    it and pumps every member empty, and every frame is served once."""
    members = {"a": _server(params, None), "b": _server(params, None)}
    served = []
    cl = GatewayCluster(members, seed=2, on_result=served.append)
    infos = [cl.open_session(qos=S) for _ in range(4)]
    cl.start()
    assert cl.start() is cl                      # idempotent
    for t in range(6):
        for i in infos:
            cl.submit(i.sid, _req(i.sid, t))
    cl.stop(drain=True, timeout=60.0)
    st = cl.stats()
    _assert_conserved(st)
    assert st.served == st.submitted and sum(st.served.values()) == 24
    assert sorted((r.sid, r.t) for r in served) == sorted(
        (i.sid, t) for i in infos for t in range(6))
    for i in infos:
        cl.close_session(i.sid)
    assert cl.stats().sessions_open == 0


def test_cluster_metrics_and_dump(params):
    clock = FakeClock()
    cl = GatewayCluster({"a": _server(params, clock),
                         "b": _server(params, clock)}, seed=0, timer=clock)
    info = cl.open_session(qos=S)
    cl.submit(info.sid, _req(0, 0))
    cl.pump()
    text = cl.metrics()
    assert "cluster_frames_served" in text
    assert "cluster_members_live 2" in text
    assert cl.dump_trace()["reason"] == "on_demand"


# ---------------------------------------------------------------------------
# The drain lane, port against reference
# ---------------------------------------------------------------------------

def _jax_params():
    p = jax_init_audio_encoder(JaxAudioEncCfg(**KW), jax.random.PRNGKey(0))
    return p, params_from_jax(jax.tree_util.tree_map(np.asarray, p))


def frozen_clock():
    """A member clock that never moves (see the drain lane's test)."""
    return 0.0


def test_drain_lane_matches_reference(monkeypatch):
    """One seeded drain lane (2 members x 4 sessions, 4 rounds a phase)
    through ``benchmarks/cluster_serve.py`` on the reference and
    ``runtime/cluster_serve.py`` on the port, with the reference's
    encoder weights: every served ``(sid, t, k, route, wire_bytes)``
    equal, ``z`` within ``Z_ATOL``, every ``ClusterStats`` book equal
    but the pause times and ``migrated_bytes`` (the port's pickle
    length), which equals the port's own snapshots' bytes.  Both lanes'
    members run on ``frozen_clock``, so no frame reaches an aging
    threshold however slow the machine and the member books do not
    depend on the load (``test_chaos_lane_matches_reference``)."""
    sys.path.insert(0, str(__import__("pathlib").Path(__file__).parents[1]))
    from benchmarks import cluster_serve as ref_lane
    monkeypatch.setattr(ref_lane, "DEEP_KW", KW)
    monkeypatch.setitem(JaxGateway.__init__.__kwdefaults__, "clock",
                        frozen_clock)
    made, ref_results, ref_snaps, port_snaps = [], [], [], []
    base = jax_cluster.GatewayCluster

    def record_exports(srv, into):
        export = srv.export_session

        def recorded(sid):
            snap = export(sid)
            into.append(snap)
            return snap
        srv.export_session = recorded

    class Recording(base):
        def __init__(self, members, **kw):
            cb = kw["on_result"]

            def both(r):
                ref_results.append(r)
                cb(r)
            kw["on_result"] = both
            for srv in members.values():
                record_exports(srv, ref_snaps)
            super().__init__(members, **kw)
            made.append(self)
    monkeypatch.setattr(jax_cluster, "GatewayCluster", Recording)
    ref = ref_lane.bench_cluster_drain(2, rounds=4)
    _, tparams = _jax_params()
    port = cluster_serve.cluster_drain(
        2, device="cpu", enc_cfg=CFG, params=tparams, rounds=4,
        on_member=lambda name, srv: record_exports(srv, port_snaps),
        clock=frozen_clock)
    skip = ("migration_pause_ms", "migrated_bytes")
    assert cluster_serve.books(port["stats"], skip=skip) == \
        cluster_serve.books(made[0].stats(), skip=skip)
    for key in ("members", "sessions", "migrations", "migrated_frames",
                "shed_expired", "lost_in_flight"):
        assert port[key] == ref[key], key
    # migrated_bytes: the port's own snapshots' pickles, each of which
    # is the reference's pickle of the same move but for the module
    # names ("repro_torch." where the reference writes "repro.")
    assert port["stats"].migrated_bytes == sum(s.nbytes for s in port_snaps)
    assert len(port_snaps) == len(ref_snaps) == port["stats"].migrations
    for ours, theirs in zip(port_snaps, ref_snaps):
        raw = ours.to_bytes()
        assert len(raw) - 6 * raw.count(b"repro_torch.") == theirs.nbytes
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
    parity = port["parity"]
    print(f"drain lane: port vs reference max |dz| {worst:.3e} over "
          f"{len(ours)} frames; port's own replay oracle {parity}")
    assert parity["sessions"] == len(port["homed"]) and \
        parity["max_abs_dz"] <= Z_ATOL
