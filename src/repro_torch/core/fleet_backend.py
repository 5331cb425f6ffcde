"""The fleet data plane behind one ``FleetBackend`` seam.

Port of ``repro.core.fleet_backend``: ``HostFleetBackend`` keeps the
session rings in host numpy (``FleetBuffer``) and, given a task head,
refines it: each round copies one ``(N, W, d)`` snapshot to the device
(counted in ``snapshot_h2d_bytes``), takes one ``FleetRefiner`` step and,
with ``n_components``, one EM step of the GMM fleet memory.  The
device-resident ``ShardedFleetBackend`` is a later slice of the port.

Both the reference's backends and this one are thread-safe by contract:
every state transition holds one re-entrant lock.
"""
from __future__ import annotations

import abc
import threading

import numpy as np
import torch

from repro_torch.core import gmm
from repro_torch.core.fleet_buffer import FleetBuffer
from repro_torch.core.fleet_refiner import FleetRefiner, fetch
from repro_torch.core.hybrid import HybridCfg
from repro_torch.kernels.ops import resolve_device


class FleetBackend(abc.ABC):
    """Everything the gateway needs from the fleet data plane.

    ``capacity``/``window``/``dim`` describe the (N, W, d) session rings;
    ``shards`` is 1 on the host backend.  ``snapshot_h2d_bytes`` counts
    the fleet snapshot bytes copied host->device for refinement and
    ``ingest_h2d_bytes`` the frame payload moved host->device at ingest
    (0 on the host backend, whose rings stay on the host).  ``device``
    is where refinement runs (``None`` for a backend without a head)."""

    capacity: int
    window: int
    dim: int
    shards: int = 1
    kind: str = "abstract"
    snapshot_h2d_bytes: int = 0
    ingest_h2d_bytes: int = 0
    device = None

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
        return getattr(self, "refiner", None) is not None

    @abc.abstractmethod
    def refine(self, rnd):
        """One fleet-wide hybrid-loss step with round ``rnd``'s draws
        -> (mean active loss, mean active parts, per-session losses
        (N,))."""

    # -- observability -------------------------------------------------------
    @abc.abstractmethod
    def snapshot(self):
        """Host-side (z (N, W, d), mask (N, W), labels (N, W))."""

    def shards_of(self, sids) -> np.ndarray:
        """Which session shard each fleet row lives on (contiguous
        blocks)."""
        return np.asarray(sids, np.int64) * self.shards // self.capacity


class HostFleetBackend(FleetBackend):
    """Numpy ``FleetBuffer`` rings plus an optional ``FleetRefiner`` and
    GMM fleet memory.

    ``head_init(generator) -> params`` and ``head_apply(params, z)`` give
    the task head (``FleetRefiner``); without them the backend serves but
    never refines.  The head is drawn from a generator seeded with
    ``seed``, the memory (``gmm.init_gmm``) from one seeded with
    ``seed + 1``, and round r's SWD draw from ``(seed, r)`` unless
    ``draws(r) -> (dirs, prior)`` is given.  A caller with its own head
    returns it from ``head_init``; ``memory`` may be set to any
    ``GMMState`` on ``device`` before a round.  ``device`` (default
    ``"cuda"``, raising without a GPU) is where refinement runs."""

    kind = "host"

    def __init__(self, *, capacity=32, window=100, dim=128, head_init=None,
                 head_apply=None, cfg: HybridCfg = HybridCfg(), lr=1e-2,
                 seed=0, n_components=0, memory_decay=0.05, draws=None,
                 device="cuda"):
        super().__init__()
        if n_components and head_init is None:
            raise ValueError("fleet memory (n_components) updates ride the "
                             "refine round: pass head_init/head_apply too")
        self.capacity, self.window, self.dim = capacity, window, dim
        self.shards = 1
        self.buffer = FleetBuffer(capacity=capacity, window=window, dim=dim)
        self.refiner = None
        self.memory = None
        self.memory_decay = memory_decay
        if head_init is not None:
            self.device = resolve_device(device)
            self.refiner = FleetRefiner(head_init, head_apply, cfg=cfg, lr=lr,
                                        seed=seed, draws=draws,
                                        device=self.device)
        if n_components:
            g = torch.Generator().manual_seed(seed + 1)
            self.memory = gmm.init_gmm(g, n_components, dim).to(self.device)
        self.snapshot_h2d_bytes = 0
        self.ingest_h2d_bytes = 0

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

    def refine(self, rnd):
        """One refine round: the snapshot's copy to the device, the
        ``FleetRefiner`` step, the memory's EM step (the reference's
        ``em_update`` with ``weights=mask`` and no reseeding), then ONE
        wait for the round's loss, parts and per-session losses."""
        if self.refiner is None:
            raise RuntimeError("backend built without a head: no refiner")
        with self._lock:
            z, mask, labels = self.buffer.snapshot()
            active = self.buffer.active
            self.snapshot_h2d_bytes += (z.nbytes + mask.nbytes
                                        + labels.nbytes + active.nbytes)
            dz, dmask, dlabels, dactive = self.refiner.to_device(
                z, mask, labels, active)
            out = self.refiner.step(rnd, dz, dmask, dlabels, dactive)
            if self.memory is not None:
                self.memory = gmm.em_update(
                    self.memory, dz.reshape(-1, self.dim),
                    weights=dmask.reshape(-1), decay=self.memory_decay,
                    reseed_frac=0.0)
            return fetch(out)
