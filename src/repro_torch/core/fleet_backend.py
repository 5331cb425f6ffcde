"""The fleet data plane behind one ``FleetBackend`` seam.

Port of ``repro.core.fleet_backend``, serving half: ``HostFleetBackend``
keeps the session rings in host numpy (``FleetBuffer``).  Fleet
refinement (the reference's ``FleetRefiner`` and GMM memory) and the
device-resident ``ShardedFleetBackend`` are later slices of the port;
asking for them raises ``NotImplementedError``.

Both the reference's backends and this one are thread-safe by contract:
every state transition holds one re-entrant lock.
"""
from __future__ import annotations

import abc
import threading

import numpy as np

from repro_torch.core.fleet_buffer import FleetBuffer

REFINE_PENDING = ("fleet refinement (FleetRefiner, the hybrid loss and the "
                  "GMM memory) is not ported yet: it is the refine slice "
                  "of the PyTorch port")


class FleetBackend(abc.ABC):
    """Everything the gateway needs from the fleet data plane.

    ``capacity``/``window``/``dim`` describe the (N, W, d) session rings;
    ``shards`` is 1 on the host backend.  ``snapshot_h2d_bytes`` and
    ``ingest_h2d_bytes`` count host->device bytes moved for refinement
    and ingest (0 here: the host backend neither refines nor ingests
    on a device)."""

    capacity: int
    window: int
    dim: int
    shards: int = 1
    kind: str = "abstract"
    snapshot_h2d_bytes: int = 0
    ingest_h2d_bytes: int = 0

    def __init__(self):
        self._lock = threading.RLock()

    # -- session lifecycle ---------------------------------------------------
    @property
    @abc.abstractmethod
    def n_active(self) -> int: ...

    @abc.abstractmethod
    def admit(self) -> int: ...

    @abc.abstractmethod
    def evict(self, sid) -> None: ...

    # -- ingest --------------------------------------------------------------
    @abc.abstractmethod
    def insert(self, sid, t, z, label=-1) -> None: ...

    @abc.abstractmethod
    def insert_batch(self, sids, ts, zs, labels=None) -> None: ...

    @abc.abstractmethod
    def fill_fraction(self, sid) -> float: ...

    # -- row migration ---------------------------------------------------------
    @abc.abstractmethod
    def export_row(self, sid):
        """Copy one session's ring row out of the fleet:
        ``(z (W, d) f32, t (W,) i64, label (W,) i64, newest int)`` in the
        host representation."""

    @abc.abstractmethod
    def import_row(self, sid, z, t, label, newest) -> None:
        """Implant an exported row into an admitted session slot."""

    # -- refinement ----------------------------------------------------------
    @property
    def can_refine(self) -> bool:
        return False

    # -- observability -------------------------------------------------------
    @abc.abstractmethod
    def snapshot(self):
        """Host-side (z (N, W, d), mask (N, W), labels (N, W))."""

    def shards_of(self, sids) -> np.ndarray:
        """Which session shard each fleet row lives on (contiguous
        blocks)."""
        return np.asarray(sids, np.int64) * self.shards // self.capacity


class HostFleetBackend(FleetBackend):
    """Numpy ``FleetBuffer`` rings behind the backend seam."""

    kind = "host"

    def __init__(self, *, capacity=32, window=100, dim=128, head_init=None,
                 head_apply=None, n_components=0):
        super().__init__()
        if head_init is not None or head_apply is not None or n_components:
            raise NotImplementedError(REFINE_PENDING)
        self.capacity, self.window, self.dim = capacity, window, dim
        self.shards = 1
        self.buffer = FleetBuffer(capacity=capacity, window=window, dim=dim)

    @property
    def n_active(self):
        return self.buffer.n_active

    @property
    def active(self):
        return self.buffer.active

    def admit(self):
        with self._lock:
            return self.buffer.admit()

    def evict(self, sid):
        with self._lock:
            self.buffer.evict(sid)

    def insert(self, sid, t, z, label=-1):
        with self._lock:
            self.buffer.insert(sid, t, z, label=label)

    def insert_batch(self, sids, ts, zs, labels=None):
        with self._lock:
            self.buffer.insert_batch(sids, ts, zs, labels)

    def fill_fraction(self, sid):
        with self._lock:
            return self.buffer.fill_fraction(sid)

    def export_row(self, sid):
        with self._lock:
            return self.buffer.export_row(sid)

    def import_row(self, sid, z, t, label, newest):
        with self._lock:
            self.buffer.import_row(sid, z, t, label, newest)

    def snapshot(self):
        with self._lock:
            return self.buffer.snapshot()
