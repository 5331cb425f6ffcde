"""The gateway's sharded dispatch plane (``shard_dispatch``) against the
reference (``tests/test_gateway.py``'s sharded-backend and
sharded-dispatch tests).

At one shard the sharded plane is held BITWISE against the port's
one-device overlapped plane, and a gateway over a 1-shard
``ShardedFleetBackend`` bitwise against one over the host backend, as
the reference holds its own pairs.  At 2 and 4 logical shards (a
sessions mesh naming the CPU S times) each shard's k-buckets hold other
frames than the one-device plane's buckets, and torch's convolutions
are not batch-invariant, so embeddings are held at ``Z_ATOL`` = 1e-4
(the port's recorded bound) and every ``(sid, t, k, route,
wire_bytes)`` exactly — against the reference's one-device gateway in
process (the reference pins its own sharded plane bitwise to that
plane, so no forked run is needed) and against the port's own.
"""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.api import StreamSplitGateway as JaxGateway  # noqa: E402
from repro.models import audio_encoder as jenc  # noqa: E402
from repro_torch.api import (FixedKPolicy, FrameRequest,  # noqa: E402
                             HostFleetBackend, ShardedFleetBackend,
                             StreamSplitGateway)
from repro_torch.kernels import ops as kernel_ops  # noqa: E402
from repro_torch.launch.mesh import make_sessions_mesh  # noqa: E402
from repro_torch.models import audio_encoder as enc  # noqa: E402
from repro_torch.weights import params_from_jax  # noqa: E402

SMALL = dict(widths=(16, 16, 32, 32), strides=(1, 2, 1, 2), n_mels=32,
             frames=40, d_embed=32, groups=4)
TINY = dict(widths=(8, 8, 8, 8), strides=(1, 1, 1, 1), n_mels=8, frames=8,
            d_embed=16, groups=2)
CFG = enc.AudioEncCfg(**SMALL)
L = CFG.n_blocks
N_CLASSES = 4
Z_ATOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per test worker (results do not depend on
    it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class SpreadPolicy:
    """Frame i of a tick gets k = i % (L+1): every split index."""

    def __init__(self, L):
        self.L = L

    def decide(self, obs_batch):
        return np.arange(len(obs_batch), dtype=np.int64) % (self.L + 1)


def params_of(kw):
    jcfg = jenc.AudioEncCfg(**kw)
    jp = jax.tree.map(np.asarray, jenc.init_audio_encoder(
        jcfg, jax.random.PRNGKey(0)))
    return jcfg, jp, params_from_jax(jp)


@pytest.fixture(scope="module")
def small():
    return params_of(SMALL)[2]


def _mel(rng, cfg=CFG):
    return rng.normal(size=(cfg.frames, cfg.n_mels)).astype(np.float32)


def _head():
    def head_init(generator):
        return {"w": 0.01 * torch.randn(CFG.d_embed, N_CLASSES,
                                        generator=generator)}

    def head_apply(p, z):
        return z @ p["w"]

    return head_init, head_apply


def sharded(capacity, shards=1, cfg=CFG, **kw):
    return ShardedFleetBackend(capacity=capacity, window=8, dim=cfg.d_embed,
                               mesh=make_sessions_mesh(
                                   devices=["cpu"] * shards), **kw)


def test_gateway_on_sharded_backend_bit_matches_host(small):
    """The backend seam does not change serving results: a gateway over a
    1-shard device-resident backend serves bit-identical embeddings and
    refine losses, with no snapshot copied to the device and the
    embeddings handed to the rings as device tensors."""
    head_init, head_apply = _head()

    def mk(backend=None):
        kw = dict(capacity=4, window=8, qos_reserve=0, device="cpu")
        if backend is None:
            kw.update(head_init=head_init, head_apply=head_apply)
        return StreamSplitGateway(CFG, small, policy=SpreadPolicy(L),
                                  refine_every=2, backend=backend, **kw)

    gw_h = mk()
    gw_s = mk(sharded(4, head_init=head_init, head_apply=head_apply,
                      lr=1e-2, seed=0))
    assert not gw_s.shard_dispatch      # auto: one shard, one-device plane
    rng = np.random.default_rng(8)
    sids_h = [gw_h.open_session().sid for _ in range(4)]
    sids_s = [gw_s.open_session().sid for _ in range(4)]
    for t in range(4):
        mels = [_mel(rng) for _ in range(4)]
        for gw, sids in ((gw_h, sids_h), (gw_s, sids_s)):
            for i, sid in enumerate(sids):
                gw.submit(sid, FrameRequest(t=t, mel=mels[i],
                                            label=t % N_CLASSES))
        for rh, rs in zip(gw_h.tick(), gw_s.tick()):
            np.testing.assert_array_equal(rh.z, rs.z)
            assert rh.k == rs.k and rh.wire_bytes == rs.wire_bytes
    sh, ss = gw_h.stats(), gw_s.stats()
    assert sh.refine_rounds == ss.refine_rounds == 2
    assert ss.last_refine_loss == sh.last_refine_loss  # bitwise
    assert (sh.backend, sh.shards) == ("host", 1)
    assert (ss.backend, ss.shards) == ("sharded", 1)
    assert sum(ss.shard_frames) == ss.frames == 16
    assert ss.snapshot_h2d_bytes == 0 and sh.snapshot_h2d_bytes > 0
    assert ss.ingest_h2d_bytes == 0
    assert gw_s.backend.ingest_d2d_bytes == ss.frames * CFG.d_embed * 4
    assert gw_h.session(sids_h[0]).fill_fraction == \
        gw_s.session(sids_s[0]).fill_fraction
    for a, b in zip(gw_h.backend.snapshot(), gw_s.backend.snapshot()):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("overlap", [True, False])
def test_one_device_planes_ingest_device_tensors(small, overlap):
    """Both one-device planes over a sharded backend hand the rings the
    device embeddings and leave them as the host backend's."""
    rng = np.random.default_rng(2)
    gws = [StreamSplitGateway(CFG, small, policy=SpreadPolicy(L),
                              capacity=6, window=8, qos_reserve=0,
                              overlap=overlap, device="cpu", backend=b)
           for b in (None, sharded(6))]
    sids = [[gw.open_session().sid for _ in range(5)] for gw in gws]
    for t in range(2):
        mels = [_mel(rng) for _ in range(5)]
        outs = []
        for gw, ss in zip(gws, sids):
            for i, sid in enumerate(ss):
                gw.submit(sid, FrameRequest(t=t, mel=mels[i], label=i))
            outs.append(gw.tick())
        for a, b in zip(*outs):
            np.testing.assert_array_equal(a.z, b.z)
    for a, b in zip(gws[0].backend.snapshot(), gws[1].backend.snapshot()):
        np.testing.assert_array_equal(a, b)
    assert gws[1].stats().ingest_h2d_bytes == 0


def test_shard_dispatch_one_shard_bitwise_matches_overlapped(small):
    """Forcing ``shard_dispatch`` on a 1-shard backend is the bitwise
    configuration of the sharded plane: identical results and staged
    bytes (the S=1 blocked layout IS the flat layout), one sync and one
    D2H a tick, and rings identical to the plain plane's."""
    def mk(**kw):
        return StreamSplitGateway(CFG, small, policy=SpreadPolicy(L),
                                  qos_reserve=0, backend=sharded(6),
                                  device="cpu", **kw)

    gw_a = mk()                       # plain overlapped plane (auto-off)
    gw_b = mk(shard_dispatch=True)    # sharded plane on ONE shard
    assert not gw_a.shard_dispatch and gw_b.shard_dispatch
    rng = np.random.default_rng(3)
    sa = [gw_a.open_session().sid for _ in range(5)]
    sb = [gw_b.open_session().sid for _ in range(5)]
    for t in range(3):
        mels = [_mel(rng) for _ in range(5)]
        for gw, sids in ((gw_a, sa), (gw_b, sb)):
            for i, sid in enumerate(sids):
                gw.submit(sid, FrameRequest(t=t, mel=mels[i],
                                            label=t % N_CLASSES))
        for ra, rb in zip(gw_a.tick(), gw_b.tick()):
            np.testing.assert_array_equal(ra.z, rb.z)
            assert ra.k == rb.k and ra.wire_bytes == rb.wire_bytes
    st_a, st_b = gw_a.stats(), gw_b.stats()
    assert st_b.device_syncs_per_tick == 1
    assert st_b.d2h_copies_per_tick == 1
    assert st_b.staged_h2d_bytes == st_a.staged_h2d_bytes
    assert (st_a.dispatch_shards, st_b.dispatch_shards) == (1, 1)
    assert sum(st_b.dispatch_shard_frames) == st_b.frames == 15
    assert st_b.ingest_h2d_bytes == 0
    for xa, xb in zip(gw_a.backend.snapshot(), gw_b.backend.snapshot()):
        np.testing.assert_array_equal(xa, xb)


def test_shard_dispatch_argument_validation(small):
    with pytest.raises(ValueError, match="overlap"):
        StreamSplitGateway(CFG, small, policy=FixedKPolicy(L, 1),
                           overlap=False, shard_dispatch=True,
                           backend=sharded(2), device="cpu")
    with pytest.raises(ValueError, match="device-resident"):
        StreamSplitGateway(CFG, small, policy=FixedKPolicy(L, 1),
                           shard_dispatch=True, device="cpu",
                           backend=HostFleetBackend(capacity=2, window=8,
                                                    dim=CFG.d_embed))
    assert StreamSplitGateway(CFG, small, policy=FixedKPolicy(L, 1),
                              backend=sharded(4, 2),
                              device="cpu").shard_dispatch


def test_shard_dispatch_profile_reports_per_shard(small):
    """``tick(profile=True)`` reports per-shard timings beside the
    per-bucket split on both planes (the one-device plane under shard
    0)."""
    rng = np.random.default_rng(5)

    def run_profiled(gw):
        sids = [gw.open_session().sid for _ in range(4)]
        assert gw.last_profile is None
        for sid in sids:
            gw.submit(sid, FrameRequest(t=0, mel=_mel(rng)))
        gw.tick(profile=True)
        return gw.last_profile

    prof = run_profiled(StreamSplitGateway(
        CFG, small, policy=SpreadPolicy(L), qos_reserve=0,
        shard_dispatch=True, backend=sharded(4), device="cpu"))
    assert set(prof["per_shard"]) == {0}
    ps = prof["per_shard"][0]
    assert ps["frames"] == 4
    assert ps["chains"] == len(prof["per_bucket_ms"]) == 4
    assert set(ps["per_bucket_ms"]) == set(prof["per_bucket_ms"])
    assert all(v >= 0.0 for v in prof["per_bucket_ms"].values())
    prof_h = run_profiled(StreamSplitGateway(
        CFG, small, policy=SpreadPolicy(L), capacity=4, window=8,
        qos_reserve=0, device="cpu"))
    assert set(prof_h["per_shard"]) == {0}
    assert prof_h["per_shard"][0]["frames"] == 4


@pytest.fixture(scope="module")
def tiny():
    return params_of(TINY)


@pytest.mark.parametrize("shards", [2, 4])
def test_sharded_dispatch_multi_shard_parity(tiny, shards, monkeypatch):
    """The reference's multi-device scenario at S logical shards: the
    per-shard chains serve every ``(sid, t, k, route, wire_bytes)`` of
    the reference's gateway exactly and ``z`` within ``Z_ATOL``, through
    ``tick()`` and the interleaved launch/collect seam, with one sync,
    one D2H and one staged copy a tick, one grouped wire launch a shard
    with a frame at k < L, shard-local ring ingest, idle shards, the
    misplaced-row check and per-shard profile timings."""
    jcfg, jp, tp = tiny
    cfg = enc.AudioEncCfg(**TINY)
    n = 7                                   # != 0 mod S: uneven blocks
    wire_calls = []
    grouped = kernel_ops.wire_roundtrip_grouped

    def counted(xs):
        wire_calls.append(len(xs))
        return grouped(xs)
    monkeypatch.setattr(kernel_ops, "wire_roundtrip_grouped", counted)
    ref = JaxGateway(jcfg, jp, policy=SpreadPolicy(L), capacity=8, window=8,
                     qos_reserve=0)
    own = StreamSplitGateway(cfg, tp, policy=SpreadPolicy(L), capacity=8,
                             window=8, qos_reserve=0, device="cpu")
    gw = StreamSplitGateway(cfg, tp, policy=SpreadPolicy(L),
                            backend=sharded(8, shards, cfg), qos_reserve=0,
                            device="cpu")
    assert gw.shard_dispatch, "shard_dispatch must auto-enable on S > 1"
    rng = np.random.default_rng(0)
    sr = [ref.open_session().sid for _ in range(n)]
    so = [own.open_session().sid for _ in range(n)]
    ss = [gw.open_session().sid for _ in range(n)]
    shard = gw.backend.shards_of(np.array(ss))
    worst = 0.0

    def feed(t, mels, pairs):
        for g, sids in pairs:
            for i, sid in enumerate(sids):
                g.submit(sid, FrameRequest(t=t, mel=mels[i], label=t % 3))

    def hold(want, got, ours=None):
        nonlocal worst
        assert len(want) == len(got)
        for j, (r, s) in enumerate(zip(want, got)):
            assert (r.t, r.k, r.route, r.wire_bytes) == \
                (s.t, s.k, s.route, s.wire_bytes)
            worst = max(worst, float(np.abs(np.asarray(r.z) - s.z).max()))
            if ours is not None:
                worst = max(worst, float(np.abs(ours[j].z - s.z).max()))
        assert worst <= Z_ATOL, worst

    for t in range(3):
        mels = [_mel(rng, cfg) for _ in range(n)]
        feed(t, mels, ((ref, sr), (own, so), (gw, ss)))
        del wire_calls[:]
        hold(ref.tick(), gw.tick(), own.tick())
        # one grouped launch a shard with a frame at k < L
        want = sum(1 for s in range(shards)
                   if any(i % (L + 1) < L and shard[i] == s
                          for i in range(n)))
        assert len(wire_calls) == want + 1, wire_calls   # + own's tick
    st = gw.stats()
    assert st.device_syncs_per_tick == 1 and st.d2h_copies_per_tick == 1
    block = 1 << (int(np.bincount(shard).max()) - 1).bit_length()
    assert st.staged_h2d_bytes == 3 * shards * block * cfg.frames \
        * cfg.n_mels * 4
    assert st.dispatch_shards == shards
    assert sum(st.dispatch_shard_frames) == st.frames == 3 * n
    assert all(f > 0 for f in st.dispatch_shard_frames)
    assert st.ingest_h2d_bytes == 0

    # a tick that leaves S-1 shards idle
    m = _mel(rng, cfg)
    for g, sids in ((ref, sr), (own, so), (gw, ss)):
        g.submit(sids[0], FrameRequest(t=3, mel=m, label=0))
    hold(ref.tick(), gw.tick(), own.tick())
    assert gw.stats().device_syncs_per_tick == 1

    # interleaved tick_launch/tick_collect: one sync per collected tick
    mels1 = [_mel(rng, cfg) for _ in range(n)]
    mels2 = [_mel(rng, cfg) for _ in range(n)]
    feed(4, mels1, ((gw, ss),))
    p0 = gw.tick_launch()
    feed(5, mels2, ((gw, ss),))
    p1 = gw.tick_launch()
    r0, r1 = gw.tick_collect(p0), gw.tick_collect(p1)
    assert gw.stats().device_syncs_per_tick == 1
    assert gw.stats().d2h_copies_per_tick == 1
    for t, mels, res in ((4, mels1, r0), (5, mels2, r1)):
        feed(t, mels, ((ref, sr), (own, so)))
        hold(ref.tick(), res, own.tick())

    # the placed scatter left the rings as the reference's ingest did
    # (admission order, not row index, is the cross-backend identity)
    zr, mr, lr = (np.asarray(a) for a in ref.backend.snapshot())
    zd, md, ld = gw.backend.snapshot()
    np.testing.assert_allclose(zd[np.array(ss)], zr[np.array(sr)],
                               atol=Z_ATOL)
    np.testing.assert_array_equal(md[np.array(ss)], mr[np.array(sr)])
    np.testing.assert_array_equal(ld[np.array(ss)], lr[np.array(sr)])

    # misplacing a frame on a foreign shard's block raises
    be = gw.backend
    wrong = (be.shard_of(ss[0]) + 1) % shards
    with pytest.raises(ValueError):
        be.insert_batch_placed(np.array([ss[0]]), np.array([99]),
                               torch.zeros(shards, cfg.d_embed), None,
                               np.array([wrong]))

    # per-shard profile: every shard reports its own stage timings
    feed(6, mels1, ((gw, ss),))
    gw.tick(profile=True)
    prof = gw.last_profile
    assert set(prof["per_shard"]) == set(range(shards))
    assert sum(d["frames"] for d in prof["per_shard"].values()) == n
    print(f"S={shards}: max |dz| {worst:.3e} against the reference and "
          "the one-device plane")
