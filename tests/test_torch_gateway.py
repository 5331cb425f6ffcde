"""The port's gateway tick against the reference's, and its own
contracts.

Across frameworks: same mixed-k schedule, same weights (converted with
``params_from_jax``), same mels.  Embeddings agree within atol 1e-4:
the edge activations differ in their last bits (convolutions summed in
another order), which can move one element of the INT8 wire across a .5
tie; one quantization level (scale = range/255) then reaches the
embedding, below 1e-4.  Every count — k, route, wire bytes,
bucket sizes, every ``GatewayStats`` counter, one sync and one D2H per
tick — is equal exactly.
"""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.api import StreamSplitGateway as JaxGateway  # noqa: E402
from repro.core import swd as jswd  # noqa: E402
from repro.models import audio_encoder as jenc  # noqa: E402
from repro_torch.api import (AdmissionError, FixedKPolicy,  # noqa: E402
                             FrameRequest, HostFleetBackend, QoSClass,
                             SplitPolicy, StreamSplitGateway, make_policy)
from repro_torch.api.policies import EntropyThresholdPolicy  # noqa: E402
from repro_torch.core.fleet_buffer import FleetFullError, pad_pow2  # noqa: E402
from repro_torch.core.splitter import SplitEngine  # noqa: E402
from repro_torch.models import audio_encoder as enc  # noqa: E402
from repro_torch.obs import validate_prometheus  # noqa: E402
from repro_torch.weights import head_from_jax, params_from_jax  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs files in parallel workers: one intra-op thread per
    worker keeps torch from oversubscribing the cores (results do not
    depend on it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SMALL = dict(widths=(16, 16, 32, 32), strides=(1, 2, 1, 2), n_mels=32,
             frames=40, d_embed=32, groups=4)
CFG, JCFG = enc.AudioEncCfg(**SMALL), jenc.AudioEncCfg(**SMALL)
L = CFG.n_blocks
N = 2 * (L + 1)            # every k twice -> every bucket is a real batch
Z_ATOL = 1e-4
# bucketed (padded batch) vs per-frame (B=1) embeddings inside the port:
# torch's CPU convolutions are not batch-invariant, so the same frame
# differs in its last bits between batch sizes; on these inputs no INT8
# level flips and the difference stays within this bound
BATCH_BOUND = 3e-7
COUNTERS = ("ticks", "frames", "sessions_open", "sessions_opened",
            "sessions_closed", "admission_refusals", "dispatches",
            "wire_bytes", "sync_bytes", "sync_events", "refine_rounds",
            "routed", "backend", "shards", "shard_frames", "dispatch_shards",
            "dispatch_shard_frames", "snapshot_h2d_bytes",
            "ingest_h2d_bytes", "device_syncs_per_tick",
            "d2h_copies_per_tick", "staged_h2d_bytes", "sessions_exported",
            "sessions_imported")


class SpreadPolicy:
    """Frame i gets k = i % (L+1): every split index in one tick."""

    def __init__(self, L):
        self.L = L

    def decide(self, obs_batch):
        return np.arange(len(obs_batch), dtype=np.int64) % (self.L + 1)


@pytest.fixture(scope="module")
def params():
    jp = jax.tree.map(np.asarray, jax.jit(lambda k: jenc.init_audio_encoder(
        JCFG, k))(jax.random.PRNGKey(0)))
    return jp, params_from_jax(jp)


def _mels(rng, n):
    return [rng.normal(size=(CFG.frames, CFG.n_mels)).astype(np.float32)
            for _ in range(n)]


def _frame(t, mel, i):
    # every third frame charges on a fast link, so lazy sync pushes
    return FrameRequest(t=t, mel=mel, label=i % 4, u=0.1 * (i % 10),
                        bandwidth_mbps=30.0 if i % 3 == 0 else 5.0,
                        charging=i % 3 == 0)


def _gw(tp, **kw):
    kw.setdefault("policy", SpreadPolicy(L))
    return StreamSplitGateway(CFG, tp, capacity=N, window=8, qos_reserve=0,
                              device="cpu", **kw)


def _serve(gw, sids, ticks):
    out = []
    for t, mels in enumerate(ticks):
        for i, sid in enumerate(sids):
            gw.submit(sid, _frame(t, mels[i], i))
        out.append(gw.tick())
    return out


def test_tick_matches_reference_gateway(params):
    jp, tp = params
    jgw = JaxGateway(JCFG, jp, policy=SpreadPolicy(L), capacity=N, window=8,
                     qos_reserve=0)
    gw = _gw(tp)
    rng = np.random.default_rng(11)
    ticks = [_mels(rng, N) for _ in range(3)]
    j_sids = [jgw.open_session().sid for _ in range(N)]
    sids = [gw.open_session().sid for _ in range(N)]
    assert sids == j_sids
    for jt, tt in zip(_serve(jgw, j_sids, ticks), _serve(gw, sids, ticks)):
        assert len(tt) == N
        for jr, r in zip(jt, tt):
            assert (r.sid, r.t, r.k, r.route, r.wire_bytes, r.bucket_size,
                    r.shard) == (jr.sid, jr.t, jr.k, jr.route, jr.wire_bytes,
                                 jr.bucket_size, jr.shard)
            assert r.z.dtype == np.float32 and r.z.shape == (CFG.d_embed,)
            np.testing.assert_allclose(r.z, jr.z, rtol=0, atol=Z_ATOL,
                                       err_msg=f"k={r.k}")
    js, s = jgw.stats(), gw.stats()
    for name in COUNTERS:
        assert getattr(s, name) == getattr(js, name), name
    assert s.device_syncs_per_tick == 1 and s.d2h_copies_per_tick == 1
    assert s.staged_h2d_bytes == 3 * pad_pow2(N) * CFG.frames * CFG.n_mels * 4
    assert s.sync_events > 0 and s.routed["split"] > 0
    for sid in sids:
        a, b = gw.session(sid), jgw.session(sid)
        assert (a.frames, a.wire_bytes, a.sync_bytes, a.transitions,
                a.last_k, a.fill_fraction) == \
            (b.frames, b.wire_bytes, b.sync_bytes, b.transitions,
             b.last_k, b.fill_fraction)
    (z, m, lab), (jz, jm, jlab) = gw.backend.snapshot(), \
        jgw.backend.snapshot()
    np.testing.assert_allclose(z, jz, rtol=0, atol=Z_ATOL)
    np.testing.assert_array_equal(m, jm)
    np.testing.assert_array_equal(lab, jlab)


def test_overlap_false_is_bitwise_overlap_true(params):
    _, tp = params
    gw_a, gw_s = _gw(tp), _gw(tp, overlap=False)
    rng = np.random.default_rng(3)
    ticks = [_mels(rng, N) for _ in range(2)]
    sids_a = [gw_a.open_session().sid for _ in range(N)]
    sids_s = [gw_s.open_session().sid for _ in range(N)]
    for ta, ts in zip(_serve(gw_a, sids_a, ticks), _serve(gw_s, sids_s,
                                                          ticks)):
        for ra, rs in zip(ta, ts):
            np.testing.assert_array_equal(ra.z, rs.z, err_msg=f"k={ra.k}")
            assert (ra.k, ra.wire_bytes, ra.bucket_size) == \
                (rs.k, rs.wire_bytes, rs.bucket_size)
    sa, ss = gw_a.stats(), gw_s.stats()
    assert (sa.device_syncs_per_tick, sa.d2h_copies_per_tick) == (1, 1)
    assert ss.device_syncs_per_tick == ss.d2h_copies_per_tick == L + 1
    assert ss.staged_h2d_bytes == 0
    for a, b in zip(gw_a.backend.snapshot(), gw_s.backend.snapshot()):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("quantize", [True, False])
def test_bucketed_tick_matches_per_frame_run(params, quantize):
    _, tp = params
    gw = _gw(tp, quantize_wire=quantize)
    eng = SplitEngine(CFG, quantize_wire=quantize, device="cpu")
    rng = np.random.default_rng(1)
    ticks = [_mels(rng, N) for _ in range(2)]
    sids = [gw.open_session().sid for _ in range(N)]
    worst = 0.0
    for t, results in enumerate(_serve(gw, sids, ticks)):
        assert sorted({r.k for r in results}) == list(range(L + 1))
        for i, r in enumerate(results):
            z, wire = eng.run(tp, ticks[t][i][None], r.k)
            assert wire == r.wire_bytes
            worst = max(worst, float(np.abs(z.numpy()[0] - r.z).max()))
    assert worst <= BATCH_BOUND, worst


def test_pipelined_phases_match_sequential_ticks(params):
    _, tp = params
    gw_p, gw_s = _gw(tp), _gw(tp)
    sids_p = [gw_p.open_session().sid for _ in range(N)]
    sids_s = [gw_s.open_session().sid for _ in range(N)]
    rng = np.random.default_rng(13)
    ticks = [_mels(rng, N) for _ in range(3)]

    def submit(gw, sids, t):
        for i, sid in enumerate(sids):
            gw.submit(sid, _frame(t, ticks[t][i], i))

    submit(gw_p, sids_p, 0)
    plan0 = gw_p.tick_launch()
    submit(gw_p, sids_p, 1)
    plan1 = gw_p.tick_launch()
    # each tick's one D2H copy is issued at the end of its own launch,
    # before the next tick's chains; its collect is its one wait
    for plan in (plan0, plan1):
        assert (plan.syncs, plan.d2h) == (0, 1) and plan.z_host is not None
    with pytest.raises(RuntimeError):
        gw_p.tick_collect(plan1)                 # out of launch order
    res_p = []
    for plan in (plan0, plan1):
        res_p.append(gw_p.tick_collect(plan))
        sp = gw_p.stats()
        assert sp.device_syncs_per_tick == 1 and sp.d2h_copies_per_tick == 1
    submit(gw_p, sids_p, 2)
    res_p.append(gw_p.tick())
    res_s = _serve(gw_s, sids_s, ticks)
    for tp_, ts_ in zip(res_p, res_s):
        for rp, rs in zip(tp_, ts_):
            np.testing.assert_array_equal(rp.z, rs.z)
    sp = gw_p.stats()
    assert sp.ticks == 3 and sp.device_syncs_per_tick == 1 \
        and sp.d2h_copies_per_tick == 1
    for a, b in zip(gw_p.backend.snapshot(), gw_s.backend.snapshot()):
        np.testing.assert_array_equal(a, b)


def test_profile_tick_syncs_per_bucket(params):
    _, tp = params
    clock = iter(range(10_000))
    gw = _gw(tp, clock=lambda: 0.5 * next(clock))
    rng = np.random.default_rng(12)
    sids = [gw.open_session().sid for _ in range(L + 1)]
    for sid, mel in zip(sids, _mels(rng, L + 1)):
        gw.submit(sid, FrameRequest(t=0, mel=mel))
    results = gw.tick(profile=True)
    s = gw.stats()
    assert s.device_syncs_per_tick == L + 2      # per bucket + the final wait
    assert s.d2h_copies_per_tick == 1
    assert all(r.latency_ms == 500.0 for r in results)
    assert sorted(gw.last_profile["per_bucket_ms"]) == list(range(L + 1))


def _record_stages(gw, monkeypatch):
    """Record the tick's stage calls in order: ("edge", k), ("server",
    k), ("wire", rows of each group) for a grouped wire launch and
    ("wire1", rows) for a one-batch wire."""
    from repro_torch.kernels import ops
    calls, eng = [], gw.engine
    edge, server = eng._edge_fn, eng._server_fn
    grouped, single = ops.wire_roundtrip_grouped, ops.wire_roundtrip
    monkeypatch.setattr(eng, "_edge_fn", lambda k, p, m: calls.append(
        ("edge", k)) or edge(k, p, m))
    monkeypatch.setattr(eng, "_server_fn", lambda k, p, x: calls.append(
        ("server", k)) or server(k, p, x))
    monkeypatch.setattr(ops, "wire_roundtrip_grouped", lambda xs: calls.append(
        ("wire", [x.shape[0] for x in xs])) or grouped(xs))
    monkeypatch.setattr(ops, "wire_roundtrip", lambda x: calls.append(
        ("wire1", x.shape[0])) or single(x))
    return calls


def test_tick_order_all_edges_one_wire_all_servers(params, monkeypatch):
    """The overlapped tick runs every k-bucket's edge stage, then ONE
    grouped wire over the L wired buckets (padded rows), then every
    server stage, each in k order; the profiled tick keeps a chain a
    bucket, edge -> one-batch wire -> server."""
    _, tp = params
    gw = _gw(tp)
    calls = _record_stages(gw, monkeypatch)
    rng = np.random.default_rng(14)
    sids = [gw.open_session().sid for _ in range(N)]
    _serve(gw, sids, [_mels(rng, N)])
    rows = pad_pow2(N // (L + 1))
    assert calls == ([("edge", k) for k in range(L + 1)]
                     + [("wire", [rows] * L)]
                     + [("server", k) for k in range(L)])
    calls.clear()
    for i, sid in enumerate(sids):
        gw.submit(sid, _frame(1, _mels(rng, 1)[0], i))
    gw.tick(profile=True)
    assert calls == [c for k in range(L + 1) for c in
                     [("edge", k)] + ([("wire1", rows), ("server", k)]
                                      if k < L else [])]


def test_gateway_defaults_to_cuda_and_refuses_without_it(params):
    _, tp = params
    if torch.cuda.is_available():
        assert StreamSplitGateway(CFG, tp, policy=FixedKPolicy(L, 1)) \
            .device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            StreamSplitGateway(CFG, tp, policy=FixedKPolicy(L, 1))


def test_unported_options_raise(params):
    """Options the gateway cannot honour raise as the reference's do:
    the sharded dispatch plane over a host backend (it needs a
    device-resident ``ShardedFleetBackend``), and the rl policy without
    its params."""
    _, tp = params
    with pytest.raises(ValueError, match="device-resident"):
        _gw(tp, shard_dispatch=True)
    with pytest.raises(ValueError, match="rl_params"):
        make_policy("rl", L)


N_CLASSES = 4


def _jhead_init(key):
    return {"w": 0.1 * jax.random.normal(key, (CFG.d_embed, N_CLASSES))}


def _head_apply(p, z):
    return z @ p["w"]


def _head_of(seed):
    """The reference's head for ``seed``, as the port's ``head_init``."""
    p = head_from_jax(jax.tree.map(np.asarray,
                                   _jhead_init(jax.random.PRNGKey(seed))))
    return lambda generator: p


def _gateway_draws(seed, window):
    """Round r's SWD draw of the reference gateway:
    split(fold_in(PRNGKey(seed), r)) -> (dirs, prior)."""
    def draws(r):
        kd, kp = jax.random.split(
            jax.random.fold_in(jax.random.PRNGKey(seed), r))
        return (np.array(jswd.random_directions(kd, 50, CFG.d_embed)),
                np.array(jswd.sphere_prior_samples(kp, window, CFG.d_embed)))
    return draws


def test_refine_cadence_and_due_next_tick(params):
    _, tp = params
    gw = _gw(tp, head_init=_head_of(0), head_apply=_head_apply,
             refine_every=3)
    assert gw.backend.can_refine and gw.backend.device.type == "cpu"
    assert not gw.refine_due_next_tick()             # no session yet
    gw.tick()
    assert gw.stats().refine_rounds == 0             # an empty fleet
    sids = [gw.open_session().sid for _ in range(N)]
    rng = np.random.default_rng(2)
    snapshot_bytes = sum(a.nbytes for a in gw.backend.snapshot()) \
        + gw.backend.active.nbytes
    due, rounds = [], []
    for t in range(6):
        due.append(gw.refine_due_next_tick())
        _serve(gw, sids, [_mels(rng, N)])
        s = gw.stats()
        rounds.append(s.refine_rounds)
        assert s.device_syncs_per_tick == 1 and s.d2h_copies_per_tick == 1
    # ticks 2..7 run; rounds at ticks 3 and 6
    assert due == [False, True, False, False, True, False]
    assert rounds == [0, 1, 1, 1, 2, 2]
    assert np.isfinite(s.last_refine_loss)
    assert s.snapshot_h2d_bytes == 2 * snapshot_bytes
    no_refine = _gw(tp)
    assert not no_refine.backend.can_refine
    assert np.isnan(no_refine.stats().last_refine_loss)


def test_refine_matches_reference_gateway(params):
    """Same frames, head and draws: the port's refine rounds and their
    loss match the reference gateway's.  The rings differ by the
    embeddings' atol 1e-4 (module docstring), which moves the loss by
    far less than rtol 1e-4."""
    jp, tp = params
    W = 8
    jgw = JaxGateway(JCFG, jp, policy=SpreadPolicy(L), capacity=N, window=W,
                     qos_reserve=0, head_init=_jhead_init,
                     head_apply=_head_apply, refine_every=2, seed=5)
    gw = _gw(tp, refine_every=2, backend=HostFleetBackend(
        capacity=N, window=W, dim=CFG.d_embed, head_init=_head_of(5),
        head_apply=_head_apply, seed=5, draws=_gateway_draws(5, W),
        device="cpu"))
    j_sids = [jgw.open_session().sid for _ in range(N)]
    sids = [gw.open_session().sid for _ in range(N)]
    rng = np.random.default_rng(21)
    ticks = [_mels(rng, N) for _ in range(5)]
    _serve(jgw, j_sids, ticks)
    _serve(gw, sids, ticks)
    js, s = jgw.stats(), gw.stats()
    assert s.refine_rounds == js.refine_rounds == 2
    np.testing.assert_allclose(s.last_refine_loss, js.last_refine_loss,
                               rtol=1e-4)
    assert s.snapshot_h2d_bytes == js.snapshot_h2d_bytes
    np.testing.assert_allclose(gw.backend.refiner.state.params["w"].numpy(),
                               np.asarray(jgw.backend.refiner.state.params[
                                   "w"]), rtol=1e-4, atol=1e-6)


def test_backend_on_another_device_raises(params):
    _, tp = params
    be = HostFleetBackend(capacity=4, window=8, dim=CFG.d_embed,
                          head_init=_head_of(0), head_apply=_head_apply,
                          device="cpu")
    be.device = torch.device("cuda", 0)   # as a backend built on a GPU is
    with pytest.raises(ValueError, match="refines on"):
        _gw(tp, backend=be)


def test_session_lifecycle_and_admission(params):
    _, tp = params
    gw = StreamSplitGateway(CFG, tp, policy=FixedKPolicy(L, 2), capacity=8,
                            window=8, qos_reserve=2, device="cpu")
    for _ in range(4):
        gw.open_session(qos=QoSClass.BULK)
    with pytest.raises(AdmissionError) as ei:
        gw.open_session(qos=QoSClass.BULK)
    assert isinstance(ei.value, FleetFullError)
    for _ in range(2):
        gw.open_session(qos=QoSClass.STANDARD)
    with pytest.raises(AdmissionError):
        gw.open_session(qos=QoSClass.STANDARD)
    sids = [gw.open_session(qos=QoSClass.INTERACTIVE).sid for _ in range(2)]
    with pytest.raises(AdmissionError):
        gw.open_session(qos=QoSClass.INTERACTIVE)
    assert gw.stats().admission_refusals == 3
    mel = _mels(np.random.default_rng(0), 1)[0]
    with pytest.raises(ValueError):
        gw.submit(sids[0], FrameRequest(t=0, mel=mel[None]))
    gw.submit(sids[0], FrameRequest(t=0, mel=mel, label=1))
    (r,) = gw.tick()
    assert r.k == 2 and r.route == "split"
    info = gw.close_session(sids[0])
    assert info.frames == 1 and info.last_k == 2
    with pytest.raises(KeyError):
        gw.session(sids[0])
    assert gw.open_session(qos=QoSClass.INTERACTIVE).fill_fraction == 0.0
    text = gw.metrics()
    assert validate_prometheus(text) > 0 and "gateway_ticks 1" in text


def test_export_import_session_round_trip(params):
    _, tp = params
    gw_a, gw_b = _gw(tp), _gw(tp)
    rng = np.random.default_rng(5)
    sid = gw_a.open_session(platform="m2").sid
    for t, mel in enumerate(_mels(rng, 3)):
        gw_a.submit(sid, _frame(t, mel, 0))
        gw_a.tick()
    gw_a.submit(sid, _frame(3, mel, 0))
    with pytest.raises(RuntimeError):
        gw_a.export_session(sid)                 # pending frame
    gw_a.tick()
    before = gw_a.session(sid)
    snap = type(gw_a.export_session(sid, remove=False)).from_bytes(
        gw_a.export_session(sid).to_bytes())
    info = gw_b.import_session(snap)
    assert (info.frames, info.wire_bytes, info.sync_bytes, info.last_k,
            info.fill_fraction, info.platform) == \
        (before.frames, before.wire_bytes, before.sync_bytes, before.last_k,
         before.fill_fraction, before.platform)
    assert gw_a.stats().sessions_exported == 1
    assert gw_b.stats().sessions_imported == 1


def test_policies_match_reference_kinds():
    from repro.api import make_policy as jax_make_policy
    obs = np.random.default_rng(6).random((64, 3)).astype(np.float32)
    for kind in ("edge", "server", "static", "rule", "entropy"):
        pol = make_policy(kind, L)
        assert isinstance(pol, SplitPolicy)
        np.testing.assert_array_equal(pol.decide(obs),
                                      jax_make_policy(kind, L).decide(obs))
    assert isinstance(make_policy("entropy", L), EntropyThresholdPolicy)
    with pytest.raises(ValueError):
        make_policy("nope", L)
