"""The port's host fleet rings against the reference's: the same
admit/evict/ingest schedule leaves identical rings, snapshots and fill
fractions (both are host numpy, so equality is exact)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.fleet_buffer import FleetBuffer as JaxFleetBuffer  # noqa: E402
from repro_torch.core.fleet_backend import HostFleetBackend  # noqa: E402
from repro_torch.core.fleet_buffer import (T_SENTINEL, FleetBuffer,  # noqa: E402
                                           FleetFullError, as_host, pad_pow2)


@pytest.mark.parametrize("seed", range(3))
def test_fleet_buffer_matches_reference_schedule(seed):
    rng = np.random.default_rng(seed)
    cap, W, d = 6, 5, 4
    a, b = FleetBuffer(cap, W, d), JaxFleetBuffer(cap, W, d)
    t_next = {}
    for _ in range(40):
        op = rng.integers(3)
        if op == 0 and a.n_active < cap:
            sid = a.admit()
            assert sid == b.admit()
            t_next[sid] = int(rng.integers(0, 3))
        elif op == 1 and a.n_active:
            sid = int(rng.choice(np.flatnonzero(a.active)))
            a.evict(sid)
            b.evict(sid)
            del t_next[sid]
        elif a.n_active:
            sids = np.flatnonzero(a.active)
            ts = np.array([t_next[s] for s in sids])
            zs = rng.normal(size=(len(sids), d)).astype(np.float32)
            labels = rng.integers(0, 4, len(sids))
            a.insert_batch(sids, ts, torch.from_numpy(zs), labels)
            b.insert_batch(sids, ts, zs, labels)
            for s in sids:                  # gaps: skip a frame sometimes
                t_next[s] += 1 + int(rng.integers(0, 2))
        for x, y in zip(a.snapshot(), b.snapshot()):
            np.testing.assert_array_equal(x, y)
        for s in np.flatnonzero(a.active):
            assert a.fill_fraction(s) == b.fill_fraction(s)
            for x, y in zip(a.export_row(s), b.export_row(s)):
                np.testing.assert_array_equal(x, y)


def test_fleet_buffer_admit_full_and_lazy_wipe():
    buf = FleetBuffer(2, 3, 2)
    s0, s1 = buf.admit(), buf.admit()
    with pytest.raises(FleetFullError):
        buf.admit()
    buf.insert(s0, 4, np.ones(2, np.float32), label=1)
    buf.evict(s0)
    with pytest.raises(KeyError):
        buf.insert(s0, 5, np.ones(2, np.float32))
    assert buf.admit() == s0
    assert (buf.t[s0] == T_SENTINEL).all() and buf.fill_fraction(s0) == 0.0
    assert s1 == 1


def test_host_backend_serves_without_refine():
    be = HostFleetBackend(capacity=4, window=3, dim=2)
    sid = be.admit()
    be.insert_batch([sid], [0], torch.ones(1, 2))
    assert be.n_active == 1 and not be.can_refine and be.kind == "host"
    z, mask, labels = be.snapshot()
    assert mask[sid].sum() == 1 and z[sid, -1].tolist() == [1.0, 1.0]
    assert be.shards_of([0, 3]).tolist() == [0, 0]


def test_host_backend_memory_needs_a_head():
    with pytest.raises(ValueError, match="head_init"):
        HostFleetBackend(capacity=4, window=3, dim=2, n_components=4)
    be = HostFleetBackend(capacity=4, window=3, dim=2)
    assert be.device is None and be.memory is None
    with pytest.raises(RuntimeError, match="no refiner"):
        be.refine(0)


def test_helpers():
    assert [pad_pow2(n) for n in (0, 1, 2, 3, 9, 32, 33)] == \
        [1, 1, 2, 4, 16, 32, 64]
    out = as_host(torch.arange(3, dtype=torch.float32), np.float32)
    assert out.dtype == np.float32 and out.tolist() == [0.0, 1.0, 2.0]
    assert as_host([1, 2], np.int64).dtype == np.int64
