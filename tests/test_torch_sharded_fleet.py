"""The port's ``ShardedFleetBackend`` and its ``axis_name`` hooks against
the reference (``tests/test_fleet_backend.py``'s sharded, factory and
hook tests).

Within the port, a 1-shard sharded backend is held BITWISE against the
port's host backend (snapshots, losses, parts, per-session losses, head,
GMM memory), as the reference holds its own pair.  Across the packages
the same seeded numpy frames and the reference's own draws, head and
memory go into both (``draws=``, ``head_from_jax``, ``gmm_from_jax``),
held at rtol 1e-5 (float32 sums in another order; the memory at 1e-4,
as ``tests/test_torch_refine.py`` holds it).

Several shards run as logical shards on the CPU (a sessions mesh that
names the CPU S times).  They are held against the reference's own
multi-shard backend on forced host devices — ONE forked run of the
reference at 2 and 4 shards, shared by this module — at the reference
test's tolerances (loss and parts 1e-5, per-session losses 1e-5, head
1e-6, memory 1e-5), and against the port's unsharded backend at the
same.  The estimator hooks (pmean'd SWD, psum'd EM) are held in process
against the reference's unsharded estimator on each shard's block.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import fleet_buffer as jfb  # noqa: E402
from repro.core import gmm as jgmm  # noqa: E402
from repro.core import swd as jswd  # noqa: E402
from repro_torch.core import fleet as port_fleet  # noqa: E402
from repro_torch.core import gmm  # noqa: E402
from repro_torch.core.fleet import (FleetBuffer, FleetFullError,  # noqa: E402
                                    HostFleetBackend, ShardedFleetBackend,
                                    T_SENTINEL_DEV, make_backend)
from repro_torch.core.hybrid import HybridCfg, hybrid_loss  # noqa: E402
from repro_torch.core.swd import swd_loss  # noqa: E402
from repro_torch.distributed import (PerShard, pmax, pmean,  # noqa: E402
                                     ppermute, psum, row_blocks,
                                     sessions_sharding)
from repro_torch.launch.mesh import (make_sessions_mesh,  # noqa: E402
                                     make_test_mesh)
from repro_torch.weights import gmm_from_jax, head_from_jax  # noqa: E402

DIM, N_CLASSES = 8, 4
RTOL = 1e-5
CFG = HybridCfg()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per test worker (results do not depend on
    it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cpu_mesh(shards):
    return make_sessions_mesh(devices=["cpu"] * shards)


def jhead_init(key):
    return {"w": 0.01 * jax.random.normal(key, (DIM, N_CLASSES))}


def head_apply(p, z):
    return z @ p["w"]


def head_of(seed):
    params = head_from_jax(jax.tree.map(np.asarray,
                                        jhead_init(jax.random.PRNGKey(seed))))
    return lambda generator: params


def jdraws(key, window):
    """What the reference's fleet loss draws from ``key``."""
    kd, kp = jax.random.split(key)
    return (np.array(jswd.random_directions(kd, CFG.n_dirs, DIM)),
            np.array(jswd.sphere_prior_samples(kp, window, DIM)))


def build(cls, *, capacity=4, window=12, n_components=0, seed=0,
          shards=None, n_sessions=3, evict=1):
    """The reference test's fleet on the port: ``n_sessions`` sessions
    with per-session drops, one evicted and (with ``n_sessions`` 3) its
    dirty row re-admitted; frames keyed by admission index.  Head,
    draws and memory are the reference's."""
    kw = dict(capacity=capacity, window=window, dim=DIM,
              head_init=head_of(seed), head_apply=head_apply, lr=0.1,
              seed=seed, n_components=n_components,
              draws=lambda r: jdraws(jax.random.PRNGKey(r), window))
    if cls is ShardedFleetBackend:
        kw["mesh"] = cpu_mesh(shards or 1)
    else:
        kw["device"] = "cpu"
    b = cls(**kw)
    if n_components:
        b.memory = gmm_from_jax(jax.tree.map(np.asarray, jgmm.init_gmm(
            jax.random.PRNGKey(seed + 1), n_components, DIM)))
    rng = np.random.default_rng(0)
    sids = [b.admit() for _ in range(n_sessions)]
    for t in range(15):
        for i, sid in enumerate(sids):
            if (t + i) % 5 == 2:          # per-session drops -> gaps
                continue
            b.insert(sid, t, rng.normal(size=DIM).astype(np.float32),
                     label=t % N_CLASSES)
    b.evict(sids[evict])
    if n_sessions == 3:
        s2 = b.admit()                    # re-admit onto the dirty row
        b.insert(s2, 0, np.ones(DIM, np.float32), label=1)
    return b, sids


def assert_same_state(a, b):
    for k in a.refiner.state.params:
        assert torch.equal(a.refiner.state.params[k],
                           b.refiner.state.params[k]), k
    if a.memory is not None:
        for x, y in zip(a.memory, b.memory):
            assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# 1 shard: bitwise against the port's host backend
# ---------------------------------------------------------------------------

def test_sharded_refine_bitwise_matches_host_on_one_device():
    host, _ = build(HostFleetBackend, n_components=6)
    shrd, _ = build(ShardedFleetBackend, n_components=6)
    assert shrd.shards == 1 and shrd.kind == "sharded"
    for x, y in zip(host.snapshot(), shrd.snapshot()):
        np.testing.assert_array_equal(x, y)
        assert x.dtype == y.dtype
    for r in range(3):
        loss_h, parts_h, per_h = host.refine(r)
        loss_s, parts_s, per_s = shrd.refine(r)
        assert loss_s == loss_h, f"round {r} loss not bitwise identical"
        assert parts_s == parts_h
        np.testing.assert_array_equal(per_s, per_h)
    assert_same_state(host, shrd)


def test_sharded_refine_matches_reference_backend():
    """The same fleet and draws through the reference's 1-shard sharded
    backend and the port's: three rounds at rtol 1e-5, memory 1e-4."""
    from repro.core.fleet_backend import ShardedFleetBackend as JaxSharded
    jb = JaxSharded(capacity=4, window=12, dim=DIM, head_init=jhead_init,
                    head_apply=head_apply, lr=0.1, seed=0, n_components=6)
    rng = np.random.default_rng(0)
    sids = [jb.admit() for _ in range(3)]
    for t in range(15):
        for i, sid in enumerate(sids):
            if (t + i) % 5 == 2:
                continue
            jb.insert(sid, t, rng.normal(size=DIM).astype(np.float32),
                      label=t % N_CLASSES)
    jb.evict(sids[1])
    jb.insert(jb.admit(), 0, np.ones(DIM, np.float32), label=1)
    tb, _ = build(ShardedFleetBackend, n_components=6)
    for x, y in zip(jb.snapshot(), tb.snapshot()):
        np.testing.assert_array_equal(x, y)
    for r in range(3):
        jl, jp, jper = jb.refine(jax.random.PRNGKey(r))
        loss, parts, per = tb.refine(r)
        np.testing.assert_allclose(loss, jl, rtol=RTOL)
        np.testing.assert_allclose(per, jper, rtol=RTOL, atol=1e-7)
        for k in jp:
            np.testing.assert_allclose(parts[k], jp[k], rtol=RTOL)
    np.testing.assert_allclose(tb.refiner.state.params["w"].numpy(),
                               np.asarray(jb.refiner.state.params["w"]),
                               rtol=RTOL, atol=1e-7)
    for got, want in zip(tb.memory, jb.memory):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-7)


def test_device_resident_refine_copies_no_snapshot():
    host, _ = build(HostFleetBackend)
    shrd, _ = build(ShardedFleetBackend)
    for r in range(3):
        host.refine(r)
        shrd.refine(r)
    per_round = (host.capacity * host.window * (host.dim * 4 + 4 + 8)
                 + host.capacity)          # z f32 + mask f32 + labels i64
    assert host.snapshot_h2d_bytes == 3 * per_round
    assert shrd.snapshot_h2d_bytes == 0


# ---------------------------------------------------------------------------
# Ring semantics on the device
# ---------------------------------------------------------------------------

def test_sharded_admission_eviction_and_lazy_wipe():
    b = ShardedFleetBackend(capacity=2, window=5, dim=DIM, device="cpu")
    sid = b.admit()
    rng = np.random.default_rng(0)
    for t in range(5):
        b.insert(sid, t, rng.normal(size=DIM).astype(np.float32), label=t % 2)
    b.evict(sid)
    assert b.n_active == 0
    assert (b.z[sid] != 0.0).any()            # lazy: not wiped at evict
    z, mask, labels = b.snapshot()
    assert mask[sid].sum() == 0 and (z[sid] == 0).all() \
        and (labels[sid] == -1).all()
    with pytest.raises(KeyError):
        b.insert(sid, 6, np.ones(DIM))
    with pytest.raises(KeyError):
        b.evict(sid)
    sid2 = b.admit()                          # the deferred wipe
    assert sid2 == sid
    assert (b.z[sid2] == 0.0).all()
    assert (b.t[sid2] == T_SENTINEL_DEV).all()
    assert b.fill_fraction(sid2) == 0.0
    b.admit()
    with pytest.raises(FleetFullError):
        b.admit()


@pytest.mark.parametrize("shards", [1, 3])
def test_sharded_rows_match_reference_buffer_rows(shards):
    """Wraparound, gaps, expiry and fill fraction match the reference's
    host ``FleetBuffer`` for identical insert histories, at one shard and
    three (rows 0..2 land one a shard by least-loaded placement)."""
    ref = jfb.FleetBuffer(capacity=3, window=6, dim=2)
    dev = ShardedFleetBackend(capacity=3, window=6, dim=2,
                              mesh=cpu_mesh(shards))
    sids = [ref.admit() for _ in range(3)]
    assert sorted(dev.admit() for _ in range(3)) == sids
    rng = np.random.default_rng(1)
    for t in range(20):
        for sid in sids:
            if rng.random() < 0.3:
                continue
            z = rng.normal(size=2).astype(np.float32)
            ref.insert(sid, t + sid, z, label=t % 3)
            dev.insert(sid, t + sid, z, label=t % 3)
    for x, y in zip(ref.snapshot(), dev.snapshot()):
        np.testing.assert_array_equal(x, y)
    for sid in sids:
        assert ref.fill_fraction(sid) == dev.fill_fraction(sid)
        for x, y in zip(ref.export_row(sid), dev.export_row(sid)):
            np.testing.assert_array_equal(x, y)


def test_sharded_capacity_must_divide_shards():
    ShardedFleetBackend(capacity=3, window=4, dim=2, mesh=cpu_mesh(1))
    with pytest.raises(ValueError, match="divide"):
        ShardedFleetBackend(capacity=3, window=4, dim=2, mesh=cpu_mesh(2))


def test_make_backend_factory():
    assert make_backend("host", capacity=2, window=4, dim=2).kind == "host"
    b = make_backend("sharded", capacity=2, window=4, dim=2, device="cpu")
    assert b.kind == "sharded" and b.shards == 1
    assert make_backend("host", capacity=2, window=4, dim=2,
                        mesh=cpu_mesh(2), axis="sessions").kind == "host"
    with pytest.raises(ValueError):
        make_backend("nope")
    import repro.core.fleet as jfleet
    assert port_fleet.__all__ == jfleet.__all__


def test_sharded_insert_batch_device_arrays_move_no_payload():
    b = ShardedFleetBackend(capacity=2, window=4, dim=DIM, device="cpu")
    assert b.device_ingest
    b.admit()
    b.admit()
    b.insert_batch(np.array([0, 1]), np.array([0, 0]),
                   torch.ones(2, DIM))           # already on the device
    assert b.ingest_h2d_bytes == 0 and b.ingest_d2d_bytes == 2 * DIM * 4
    b.insert_batch(np.array([0, 1]), np.array([1, 1]),
                   np.ones((2, DIM), np.float32))
    assert b.ingest_h2d_bytes == 2 * DIM * 4     # host payload counted


def test_sharded_duplicate_slot_writes_are_last_wins_like_host():
    """Repeated indices in one scatter leave the winner undefined on the
    card: the backend folds duplicate (sid, slot) writes on the host to
    the last, with ``newest`` still the largest timestamp."""
    host = jfb.FleetBuffer(capacity=2, window=4, dim=2)
    dev = ShardedFleetBackend(capacity=2, window=4, dim=2, device="cpu")
    for b in (host, dev):
        b.admit()
        b.admit()
    sids = np.array([0, 1, 0])
    ts = np.array([5, 2, 1])
    zs = np.array([[5., 5.], [2., 2.], [1., 1.]], np.float32)
    labs = np.array([5, 2, 1])
    host.insert_batch(sids, ts, zs, labs)
    dev.insert_batch(sids, ts, zs, labs)
    np.testing.assert_array_equal(dev.z[0, 1].numpy(), host.z[0, 1])
    assert int(dev.t[0, 1]) == host.t[0, 1] == 1      # last write wins
    assert int(dev.newest[0]) == host.newest[0] == 5  # max t still seen
    for x, y in zip(host.snapshot(), dev.snapshot()):
        np.testing.assert_array_equal(x, y)


def test_backends_accept_empty_insert_batch():
    for b in (HostFleetBackend(capacity=2, window=4, dim=DIM),
              ShardedFleetBackend(capacity=2, window=4, dim=DIM,
                                  device="cpu")):
        b.admit()
        b.insert_batch(np.array([], np.int64), np.array([], np.int64),
                       np.zeros((0, DIM), np.float32))
        assert b.snapshot()[1].sum() == 0, b.kind


def test_backends_reject_memory_without_head():
    with pytest.raises(ValueError):
        HostFleetBackend(capacity=2, window=4, dim=DIM, n_components=4)
    with pytest.raises(ValueError):
        ShardedFleetBackend(capacity=2, window=4, dim=DIM, n_components=4,
                            device="cpu")


def test_sharded_backend_raises_without_a_card():
    """No fallback: the default mesh is the visible CUDA devices, and a
    mesh that names a CUDA device that is not there raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    with pytest.raises(RuntimeError, match="CUDA"):
        ShardedFleetBackend(capacity=2, window=4, dim=DIM)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_sessions_mesh(devices=["cuda:0", "cuda:0"])
    with pytest.raises(RuntimeError, match="CUDA"):
        make_sessions_mesh(2)


# ---------------------------------------------------------------------------
# insert_batch_placed: the sharded dispatch plane's blocked scatter
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shards", [1, 2])
def test_insert_batch_placed_matches_plain_scatter(shards):
    """The blocked shard-local scatter leaves the rings exactly as
    ``insert_batch``: pad rows are never read, duplicate (sid, slot)
    writes keep the LAST payload, ``newest`` sees the max timestamp."""
    rng = np.random.default_rng(0)
    a = ShardedFleetBackend(capacity=4, window=6, dim=DIM,
                            mesh=cpu_mesh(shards))
    b = ShardedFleetBackend(capacity=4, window=6, dim=DIM,
                            mesh=cpu_mesh(shards))
    for x in (a, b):
        for _ in range(3):
            x.admit()
    # three writes of (sid 0, slot 1): ts 7, 1 and 13 — ts 13's payload
    # stays and newest[0] becomes 13
    sids = np.array([0, 2, 0, 1, 0])
    ts = np.array([7, 3, 1, 2, 13])
    zs = rng.normal(size=(5, DIM)).astype(np.float32)
    labels = np.array([1, 2, 3, 4, 5])
    a.insert_batch(sids, ts, torch.from_numpy(zs), labels)
    shard = b.shards_of(sids)
    block = 8 // shards
    rows = np.empty(5, np.int64)
    for s in range(shards):
        mine = np.flatnonzero(shard == s)
        rows[mine] = s * block + np.arange(len(mine))
    blocked = np.full((8, DIM), 7.0, np.float32)   # pads: never read
    blocked[rows] = zs
    b.insert_batch_placed(sids, ts, torch.from_numpy(blocked), labels, rows)
    for f in ("z", "t", "label", "newest"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert b.ingest_d2d_bytes == a.ingest_d2d_bytes == 5 * DIM * 4
    assert b.ingest_h2d_bytes == 0
    b.insert_batch_placed(np.array([], np.int64), np.array([], np.int64),
                          b.z[:0, 0], None, np.array([], np.int64))


def test_insert_batch_placed_validates_inputs():
    b = ShardedFleetBackend(capacity=4, window=6, dim=DIM, mesh=cpu_mesh(2))
    b.admit()
    z2 = torch.zeros(2, DIM)
    with pytest.raises(TypeError):     # host payloads go via insert_batch
        b.insert_batch_placed(np.array([0]), np.array([0]),
                              np.zeros((2, DIM), np.float32), None,
                              np.array([0]))
    with pytest.raises(KeyError):      # inactive session
        b.insert_batch_placed(np.array([3]), np.array([0]), z2, None,
                              np.array([0]))
    with pytest.raises(ValueError, match="int32"):
        b.insert_batch_placed(np.array([0]), np.array([2 ** 40]), z2, None,
                              np.array([0]))
    with pytest.raises(ValueError, match="shard"):   # a foreign block
        b.insert_batch_placed(np.array([0]), np.array([9]), z2, None,
                              np.array([1]))


def test_sharded_import_row_remaps_sentinel_and_checks_int32():
    src = FleetBuffer(capacity=2, window=4, dim=3)
    b = ShardedFleetBackend(capacity=2, window=4, dim=3, device="cpu")
    sid = src.admit()
    src.insert(sid, 2, np.ones(3, np.float32), label=1)
    dst = b.admit()
    b.import_row(dst, *src.export_row(sid))
    assert int(b.t[dst, 1]) == T_SENTINEL_DEV
    for x, y in zip(src.export_row(sid), b.export_row(dst)):
        np.testing.assert_array_equal(x, y)
    t = np.full((4,), np.iinfo(np.int64).max // 2, np.int64)
    with pytest.raises(ValueError, match="int32"):
        b.import_row(dst, np.zeros((4, 3), np.float32), t,
                     np.full((4,), -1, np.int64), 1)


# ---------------------------------------------------------------------------
# Collectives and meshes
# ---------------------------------------------------------------------------

def test_collectives_one_shard_identity_and_fixed_order():
    x = torch.randn(5, generator=torch.Generator().manual_seed(0))
    for op in (psum, pmean, pmax):
        (y,) = op([x])
        assert y is x                       # the identity, bit for bit
    xs = [torch.tensor([1e8, 1.0]), torch.tensor([1.0, 2.0]),
          torch.tensor([-1e8, 3.0])]
    s = psum(xs)
    assert isinstance(s, PerShard) and len(s) == 3
    want = (xs[0] + xs[1]) + xs[2]          # shard order, left to right
    assert all(torch.equal(v, want) for v in s)
    assert torch.equal(pmean(xs)[1], want / 3)
    assert torch.equal(pmax(xs)[2], torch.tensor([1e8, 3.0]))
    tree = psum([{"a": torch.ones(2), "b": [torch.zeros(1)]}] * 2)
    assert torch.equal(tree[0]["a"], torch.full((2,), 2.0))
    moved = ppermute(xs, [(0, 1)])
    assert torch.equal(moved[1], xs[0]) and not moved[0].any() \
        and not moved[2].any()
    with pytest.raises(ValueError):
        ppermute(xs, [(0, 1), (2, 1)])


def test_meshes_name_devices_and_row_blocks():
    mesh = make_test_mesh((2, 2), ("pod", "data"), devices=["cpu"] * 4)
    assert mesh.shape == {"pod": 2, "data": 2}
    assert len(mesh.axis_devices("pod")) == 2
    assert list(mesh.devices.flat) == [torch.device("cpu")] * 4
    sm = cpu_mesh(4)
    assert sm.shape == {"sessions": 4}
    assert [sl for _, sl in sessions_sharding(sm, 8)] == row_blocks(8, 4)
    assert row_blocks(8, 4)[3] == slice(6, 8)
    with pytest.raises(ValueError):
        row_blocks(6, 4)


# ---------------------------------------------------------------------------
# The axis_name hooks against the reference's unsharded estimator
# ---------------------------------------------------------------------------

def test_sharded_swd_and_gmm_estimator_hooks():
    """pmean'd SWD == the mean of the reference's SWD of each shard's
    block (one replicated draw); psum'd EM == the reference's global EM;
    at one shard both hooks are the unsharded call bit for bit."""
    key = jax.random.PRNGKey(0)
    z = np.array(jax.random.normal(jax.random.PRNGKey(1), (64, 16)))
    kd, kp = jax.random.split(key)
    draws = (torch.from_numpy(np.array(jswd.random_directions(kd, 16, 16))),
             torch.from_numpy(np.array(
                 jswd.sphere_prior_samples(kp, 16, 16))))
    blocks = [torch.from_numpy(z[i * 16:(i + 1) * 16]) for i in range(4)]
    sharded = swd_loss(draws, blocks, n_dirs=16, axis_name="sessions")
    want = np.mean([float(jswd.swd_loss(key, z[i * 16:(i + 1) * 16],
                                        n_dirs=16)) for i in range(4)])
    assert len(sharded) == 4 and len({float(v) for v in sharded}) == 1
    np.testing.assert_allclose(float(sharded[0]), want, rtol=RTOL)
    one = swd_loss(draws, blocks[:1], n_dirs=16, axis_name="sessions")
    assert torch.equal(one[0], swd_loss(draws, blocks[0], n_dirs=16))

    st_j = jgmm.init_gmm(jax.random.PRNGKey(2), 8, 16)
    st = gmm_from_jax(jax.tree.map(np.asarray, st_j))
    upd = gmm.em_update(st, blocks, axis_name="sessions", reseed_frac=0.0)
    ref = jgmm.em_update(st_j, jnp.asarray(z), reseed_frac=0.0)
    for s in range(4):
        for a, b in zip(upd[s], ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)
    w = [torch.ones(16)] * 4
    one = gmm.em_update(st, blocks[:1], weights=w[:1], axis_name="s")[0]
    for a, b in zip(one, gmm.em_update(st, blocks[0], weights=w[0])):
        assert torch.equal(a, b)


def test_sharded_hybrid_loss_pmeans_the_sw_term():
    """``hybrid_loss(axis_name=)``: each shard's L_SW is the mean of the
    shards' L_SW on one replicated draw (the reference's ``swd_loss``
    on each block), its task and Laplacian terms its own."""
    rng = np.random.default_rng(3)
    z = rng.normal(size=(4, 6, 16)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    kd, kp = jax.random.split(key)
    draws = tuple(torch.from_numpy(np.array(a)) for a in (
        jswd.random_directions(kd, CFG.n_dirs, 16),
        jswd.sphere_prior_samples(kp, 12, 16)))
    blocks = [torch.from_numpy(z[2 * i:2 * i + 2]) for i in range(2)]
    out = hybrid_loss(draws, blocks, CFG, axis_name="sessions")
    sws = [float(jswd.swd_loss(key, z[2 * i:2 * i + 2].reshape(-1, 16),
                               n_dirs=CFG.n_dirs)) for i in range(2)]
    for s, (loss, parts) in enumerate(out):
        np.testing.assert_allclose(float(parts["sw"]), np.mean(sws),
                                   rtol=RTOL)
        own = hybrid_loss(draws, blocks[s], CFG)[1]
        assert torch.equal(parts["lap"], own["lap"])
        np.testing.assert_allclose(
            float(loss), float(parts["task"] + CFG.lam_sw * parts["sw"]
                               + CFG.lam_lap * parts["lap"]), rtol=1e-6)
    (loss1, parts1), = hybrid_loss(draws, blocks[:1], CFG,
                                   axis_name="sessions")
    loss0, parts0 = hybrid_loss(draws, blocks[0], CFG)
    assert torch.equal(loss1, loss0)


@pytest.mark.parametrize("reseed_frac", [0.2, 0.0])
def test_em_update_weights_none_is_unchanged(reseed_frac):
    """The weights hook the fleet memory rides on: ``weights=None`` is
    the unweighted update bit for bit, and all-ones weights give the
    reference's unweighted update (the memory's rtol 1e-4)."""
    st_j = jgmm.init_gmm(jax.random.PRNGKey(0), 8, DIM)
    z = np.array(jax.random.normal(jax.random.PRNGKey(1), (32, DIM)))
    st = gmm_from_jax(jax.tree.map(np.asarray, st_j))
    a = gmm.em_update(st, torch.from_numpy(z), reseed_frac=reseed_frac)
    b = gmm.em_update(st, torch.from_numpy(z), weights=None,
                      reseed_frac=reseed_frac)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    want = jgmm.em_update(st_j, jnp.asarray(z), reseed_frac=reseed_frac)
    ones = gmm.em_update(st, torch.from_numpy(z), weights=torch.ones(32),
                         reseed_frac=reseed_frac)
    for x, y in zip(ones, want):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=1e-4,
                                   atol=1e-6)


def test_em_update_zero_weights_drop_frames():
    """weights = an indicator == the update on the kept subset (the
    reference test's rtol 1e-5, atol 1e-6)."""
    st = gmm_from_jax(jax.tree.map(np.asarray, jgmm.init_gmm(
        jax.random.PRNGKey(0), 6, DIM)))
    z = torch.from_numpy(np.array(jax.random.normal(jax.random.PRNGKey(1),
                                                    (24, DIM))))
    keep = torch.zeros(24)
    keep[[0, 3, 7, 11, 20]] = 1.0
    a = gmm.em_update(st, z[keep > 0], reseed_frac=0.0)
    b = gmm.em_update(st, z, weights=keep, reseed_frac=0.0)
    for x, y in zip(a, b):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-5,
                                   atol=1e-6)


# ---------------------------------------------------------------------------
# Multi-shard: the reference's own sharded backend on forced host devices
# ---------------------------------------------------------------------------

_REFERENCE_SHARDED = """
import json, jax, numpy as np
assert len(jax.devices()) == 4
from repro.core.fleet import FleetFullError, ShardedFleetBackend

DIM, NC = 8, 4
def head_init(key): return {"w": 0.01 * jax.random.normal(key, (DIM, NC))}
def head_apply(p, z): return z @ p["w"]

def build(S):
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:S]), ("sessions",))
    b = ShardedFleetBackend(capacity=8, window=12, dim=DIM,
                            head_init=head_init, head_apply=head_apply,
                            lr=0.1, seed=0, n_components=6, mesh=mesh)
    rng = np.random.default_rng(0)
    sids = [b.admit() for _ in range(7)]
    for t in range(15):
        for i, sid in enumerate(sids):
            if (t + i) % 5 == 2:
                continue
            b.insert(sid, t, rng.normal(size=DIM).astype(np.float32),
                     label=t % NC)
    b.evict(sids[2])
    return b, sids

out = {}
for S in (2, 4):
    b, sids = build(S)
    rounds = []
    for i in range(3):
        loss, parts, per = b.refine(jax.random.PRNGKey(i))
        rounds.append([loss, parts, np.asarray(per).tolist()])
    out[S] = {"sids": [int(s) for s in sids], "rounds": rounds,
              "w": np.asarray(b.refiner.state.params["w"]).tolist(),
              "memory": [np.asarray(x).tolist() for x in b.memory]}

b = ShardedFleetBackend(capacity=64, window=4, dim=4)
sids = [b.admit() for _ in range(32)]
for sid in sids:
    if b.shard_of(sid) == 2:
        b.evict(sid)
refill = [b.admit() for _ in range(8)]
rest = [b.admit() for _ in range(64 - b.n_active)]
try:
    b.admit()
    full = False
except FleetFullError:
    full = True
out["placement"] = {"sids": [int(s) for s in sids],
                    "refill": [int(s) for s in refill],
                    "rest": [int(s) for s in rest], "full": full}
print("JSON" + json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference_sharded(subproc):
    out = subproc(_REFERENCE_SHARDED, devices=4)
    line = next(x for x in out.splitlines() if x.startswith("JSON"))
    return json.loads(line[4:])


@pytest.fixture(scope="module")
def subproc():
    from conftest import run_python
    return run_python


@pytest.mark.parametrize("shards", [2, 4])
def test_multi_shard_refine_matches_reference_sharded(reference_sharded,
                                                      shards):
    """S logical shards against the reference's S-shard backend on forced
    host devices (same placement, frames, draws, head, memory) and
    against the port's unsharded backend: the reference test's
    tolerances."""
    ref = reference_sharded[str(shards)]
    b, sids = build(ShardedFleetBackend, capacity=8, n_components=6,
                    shards=shards, n_sessions=7, evict=2)
    host, sids_h = build(HostFleetBackend, capacity=8, n_components=6,
                         n_sessions=7, evict=2)
    assert sids == ref["sids"]
    pair = [i for i in range(7) if i != 2]
    rows_s = np.array([sids[i] for i in pair])
    rows_h = np.array([sids_h[i] for i in pair])
    for r, (jl, jp, jper) in enumerate(ref["rounds"]):
        loss, parts, per = b.refine(r)
        loss_h, parts_h, per_h = host.refine(r)
        assert abs(loss - jl) < 1e-5 and abs(loss - loss_h) < 1e-5
        for k in jp:
            assert abs(parts[k] - jp[k]) < 1e-5, (r, k)
            assert abs(parts[k] - parts_h[k]) < 1e-5, (r, k)
        np.testing.assert_allclose(per, np.float32(jper), atol=1e-5)
        np.testing.assert_allclose(per[rows_s], per_h[rows_h], atol=1e-5)
    w = b.refiner.state.params["w"].numpy()
    np.testing.assert_allclose(w, np.float32(ref["w"]), atol=1e-6)
    np.testing.assert_allclose(w, host.refiner.state.params["w"].numpy(),
                               atol=1e-6)
    for got, want, h in zip(b.memory, ref["memory"], host.memory):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
        np.testing.assert_allclose(got.numpy(), h.numpy(), atol=1e-5)
    assert b.snapshot_h2d_bytes == 0 and host.snapshot_h2d_bytes > 0


def test_least_loaded_shard_placement_on_admit(reference_sharded):
    """A 4-shard fleet spreads admissions 8/8/8/8, refills a drained
    shard first, and raises ``FleetFullError`` when full — every sid the
    reference's."""
    ref = reference_sharded["placement"]
    b = ShardedFleetBackend(capacity=64, window=4, dim=4, mesh=cpu_mesh(4))
    sids = [b.admit() for _ in range(32)]
    assert sids == ref["sids"]
    assert np.bincount(b.shards_of(np.array(sids)),
                       minlength=4).tolist() == [8, 8, 8, 8]
    for sid in sids:
        if b.shard_of(sid) == 2:
            b.evict(sid)
    refill = [b.admit() for _ in range(8)]
    assert refill == ref["refill"]
    assert all(b.shard_of(s) == 2 for s in refill)
    assert [b.admit() for _ in range(64 - b.n_active)] == ref["rest"]
    assert ref["full"]
    with pytest.raises(FleetFullError):
        b.admit()
