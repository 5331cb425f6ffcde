"""The fleet data plane behind one ``FleetBackend`` seam.

Port of ``repro.core.fleet_backend``:

- ``HostFleetBackend`` keeps the session rings in host numpy
  (``FleetBuffer``) and, given a task head, refines it: each round copies
  one ``(N, W, d)`` snapshot to the device (counted in
  ``snapshot_h2d_bytes``), takes one ``FleetRefiner`` step and, with
  ``n_components``, one EM step of the GMM fleet memory.
- ``ShardedFleetBackend`` keeps the rings ON the devices of a sessions
  mesh (``launch.mesh.make_sessions_mesh``), each shard's block of rows
  on its own device.  Ingest scatters in place, and a refine round reads
  the rings where they are: per shard the snapshot, the hybrid loss and
  its gradient, with the active count ``psum``'d and loss, parts and
  gradients ``pmean``'d (``distributed.sharding``), one SGD step on the
  replicated head, and the GMM memory's ``psum``'d EM step.  No fleet
  snapshot crosses the host boundary (``snapshot_h2d_bytes`` stays 0).
  On a mesh that spans a job of several processes
  (``launch.mesh.maybe_init_distributed``) each process keeps and
  refines only its own shards' rows; the collectives cross processes.

Contracts, as in the reference: a 1-shard ``ShardedFleetBackend`` is
bit-identical to ``HostFleetBackend`` (snapshots, losses, parts,
per-session losses, head, memory); several shards match the unsharded
estimator to float32 tolerance.  Both backends are thread-safe: every
state transition holds one re-entrant lock.
"""
from __future__ import annotations

import abc
import threading

import numpy as np
import torch

from repro_torch.core import gmm
from repro_torch.core.fleet_buffer import (T_SENTINEL, FleetBuffer,
                                           FleetFullError, as_host)
from repro_torch.core.fleet_refiner import (FleetRefiner, fetch,
                                            make_fleet_loss)
from repro_torch.core.hybrid import HybridCfg
from repro_torch.distributed import job as _job
from repro_torch.distributed.grad_sync import pmean_grads
from repro_torch.distributed.sharding import (SESSIONS_AXIS, pmean, psum,
                                              sessions_sharding)
from repro_torch.kernels.ops import resolve_device
from repro_torch.optim.sgd import tree_map, value_and_grad

# Device rings keep int32 frame indices: the sentinel is the int32
# minimum, far below any reachable window index -(W+1).
T_SENTINEL_DEV = int(np.iinfo(np.int32).min)
_INT32_MAX = int(np.iinfo(np.int32).max)


class FleetBackend(abc.ABC):
    """Everything the gateway needs from the fleet data plane.

    ``capacity``/``window``/``dim`` describe the (N, W, d) session rings;
    ``shards`` is 1 on the host backend and the sessions mesh's size on
    the sharded one.  ``snapshot_h2d_bytes`` counts the fleet snapshot
    bytes copied host->device for refinement, ``ingest_h2d_bytes`` the
    frame payload moved host->device at ingest (0 on the host backend,
    whose rings stay on the host) and ``ingest_d2d_bytes`` the payload
    that arrived as device tensors and never crossed the host.
    ``device_ingest`` is True when ``insert_batch`` takes device tensors
    without a host round trip.  ``device`` is where refinement runs
    (``None`` for a backend without a head)."""

    capacity: int
    window: int
    dim: int
    shards: int = 1
    kind: str = "abstract"
    device_ingest: bool = False
    snapshot_h2d_bytes: int = 0
    ingest_h2d_bytes: int = 0
    ingest_d2d_bytes: int = 0
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
        blocks) — the placement contract."""
        return np.asarray(sids, np.int64) * self.shards // self.capacity

    def shard_of(self, sid) -> int:
        return int(self.shards_of(np.array([sid]))[0])


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


def _snapshot_rows(z, t, label, newest, active, *, window):
    """Temporal-order snapshot of a block of session rows, on their
    device -> (z (n, W, d) float32, mask (n, W) float32, labels (n, W)
    int64).

    Row-local, so the same function serves the whole fleet and one
    shard's block.  The math of ``FleetBuffer.snapshot`` on the int32
    rings (``T_SENTINEL_DEV`` marks empty slots); the parity tests
    compare the two bitwise."""
    w_idx = torch.arange(window, dtype=newest.dtype, device=newest.device)
    order = (newest - window + 1)[:, None] + w_idx[None, :]      # (n, W)
    slots = order.remainder(window).long()
    valid = torch.gather(t, 1, slots) == order
    valid &= (newest >= 0)[:, None] & (active > 0)[:, None]
    gathered = torch.gather(z, 1, slots[:, :, None].expand(-1, -1,
                                                           z.shape[2]))
    zs = torch.where(valid[:, :, None], gathered, 0.0)
    labels = torch.where(valid, torch.gather(label, 1, slots), -1)
    return zs, valid.float(), labels.long()


class _Rings:
    """One shard's block of the device rings (views into its device's
    storage): z (n, W, d) float32, t and label (n, W) int32, newest (n,)
    int32, active (n,) float32."""

    __slots__ = ("z", "t", "label", "newest", "active")

    def __init__(self, z, t, label, newest, active):
        self.z, self.t, self.label = z, t, label
        self.newest, self.active = newest, active

    def wipe(self, row):
        self.z[row].zero_()
        self.t[row].fill_(T_SENTINEL_DEV)
        self.label[row].fill_(-1)
        self.newest[row].fill_(-1)


class ShardedFleetBackend(FleetBackend):
    """Device-resident fleet data plane sharded over a sessions mesh.

    ``mesh`` is a 1-D ``launch.mesh.make_sessions_mesh`` mesh along
    ``axis``; by default one shard on each visible CUDA device, or one
    shard on ``device`` when that is given.  Shard s owns the contiguous
    rows ``shards_of`` names, and its rings (z, t, label, newest, active)
    live on its device; the shards on one device share one storage, in
    shard order, so the rings of a one-device mesh are single tensors
    (``z``, ``t``, ``label``, ``newest``, ``active_dev``).

    Admission is least-loaded: a new session lands on the shard with the
    fewest active sessions (ties to the lowest shard), and within a shard
    rows go lowest-first, the host free-list order.  Eviction is O(1):
    the row is wiped on the device at its next admission.  Ingest folds
    duplicate (sid, slot) writes on the host to the last write, as numpy
    assignment keeps it, so no scatter ever sees a repeated index;
    ``newest`` takes each session's largest timestamp.

    ``refine(rnd)`` runs per shard on that shard's rows: the snapshot,
    ``make_fleet_loss(axis_name=...)`` and its gradient (the port's
    ``swd_sessions``, ``laplacian_energy`` kernels on the shard's block),
    then ``pmean`` of loss, parts and gradients, ONE SGD step on the head
    (replicated: it lives on the mesh's first device) and, with
    ``n_components``, ``gmm.em_update(axis_name=...)`` (``gmm_posterior``
    per shard).  Arguments as ``HostFleetBackend``'s.

    Across processes (a ``mesh`` that spans a joined job, as
    ``make_sessions_mesh()`` builds after ``maybe_init_distributed``),
    every process makes the same calls in the same order, as JAX's
    multi-controller model has it.  The host-side admission book stays
    whole and identical on every process; each process allocates and
    writes only its own shards' rings (``local`` lists them, and ``z``,
    ``t`` ... are their rows), and skips the other rows' writes and
    payload.  ``refine`` runs the local shards and the collectives cross
    processes: every process gets the same (loss, parts, per-session
    losses), head and memory as one process holding every shard.
    ``snapshot`` gathers every shard's rows; ``export_row`` and
    ``fill_fraction`` read only a local row.  ``shards`` stays the global
    count; every process must hold as many shards, in rank order."""

    kind = "sharded"
    device_ingest = True

    def __init__(self, *, capacity=32, window=100, dim=128, head_init=None,
                 head_apply=None, cfg: HybridCfg = HybridCfg(), lr=1e-2,
                 seed=0, n_components=0, memory_decay=0.05, draws=None,
                 mesh=None, axis=SESSIONS_AXIS, device=None):
        from repro_torch.launch.mesh import make_sessions_mesh
        super().__init__()
        if n_components and head_init is None:
            raise ValueError("fleet memory (n_components) updates ride the "
                             "refine round: pass head_init/head_apply too")
        if mesh is None:
            mesh = make_sessions_mesh(
                axis=axis, devices=None if device is None else [device])
        self.mesh, self.axis = mesh, axis
        self.shards = mesh.shape[axis]
        if capacity % self.shards:
            raise ValueError(
                f"capacity={capacity} must divide evenly over "
                f"{self.shards} session shards")
        self.capacity, self.window, self.dim = capacity, window, dim
        placed = sessions_sharding(mesh, capacity, axis)
        self.devices = [dev for dev, _ in placed]
        self.rows = capacity // self.shards
        self.owners = mesh.axis_process_ids(axis)
        counts = np.bincount(self.owners)
        if self.owners != sorted(self.owners) or counts.min() != counts.max():
            raise ValueError("the session shards must lie in rank order, as "
                             "many on every process: a mesh from "
                             f"make_sessions_mesh(), not {self.owners}")
        self.local = mesh.axis_local(axis)
        if not self.local:
            raise ValueError("this process owns no shard of the mesh")
        # each device's local shards, in shard order: their rows share one
        # storage there, so a one-device mesh keeps whole-fleet tensors
        self.shards_by_device = {}
        for s in self.local:
            self.shards_by_device.setdefault(self.devices[s], []).append(s)
        self._storage = {}
        for dev, owned in self.shards_by_device.items():
            n = len(owned) * self.rows
            self._storage[dev] = _Rings(
                torch.zeros(n, window, dim, device=dev),
                torch.full((n, window), T_SENTINEL_DEV, dtype=torch.int32,
                           device=dev),
                torch.full((n, window), -1, dtype=torch.int32, device=dev),
                torch.full((n,), -1, dtype=torch.int32, device=dev),
                torch.zeros(n, device=dev))
        self._blocks = [None] * self.shards       # another process's: None
        for s in self.local:
            dev = self.devices[s]
            j = self.shards_by_device[dev].index(s)
            local = slice(j * self.rows, (j + 1) * self.rows)
            self._blocks[s] = _Rings(*(
                getattr(self._storage[dev], f)[local]
                for f in _Rings.__slots__))
        # host-side admission bookkeeping: a lowest-row-first free list
        # per shard and per-shard active counts (least-loaded placement)
        self._active = np.zeros((capacity,), bool)
        self._dirty = np.zeros((capacity,), bool)
        self._free_by_shard = [
            list(range((s + 1) * self.rows - 1, s * self.rows - 1, -1))
            for s in range(self.shards)]
        self._shard_active = [0] * self.shards
        self.snapshot_h2d_bytes = 0
        self.ingest_h2d_bytes = 0
        self.ingest_d2d_bytes = 0
        self.refiner = None
        self.memory = None
        self.memory_decay = memory_decay
        if head_init is not None:
            self.device = self.devices[self.local[0]]
            self.refiner = FleetRefiner(head_init, head_apply, cfg=cfg, lr=lr,
                                        seed=seed, draws=draws,
                                        device=self.device)
            self._loss = make_fleet_loss(head_apply, cfg, axis_name=axis,
                                         axis_size=self.shards)
        if n_components:
            g = torch.Generator().manual_seed(seed + 1)
            self.memory = gmm.init_gmm(g, n_components, dim).to(self.device)

    # -- the rings, whole (one tensor on a one-device mesh) ------------------
    def _whole(self, field):
        """This process's rows of a ring field (every row in one
        process)."""
        if len(self._storage) == 1:
            return getattr(next(iter(self._storage.values())), field)
        first = self.devices[self.local[0]]
        return torch.cat([getattr(self._blocks[s], field).to(first)
                          for s in self.local])

    z = property(lambda self: self._whole("z"))
    t = property(lambda self: self._whole("t"))
    label = property(lambda self: self._whole("label"))
    newest = property(lambda self: self._whole("newest"))
    active_dev = property(lambda self: self._whole("active"))

    def _locate(self, sid):
        """-> (the rings of ``sid``'s shard, None on another process's;
        its row there)."""
        shard = int(sid) // self.rows
        return self._blocks[shard], int(sid) - shard * self.rows

    def _local_row(self, sid):
        blk, row = self._locate(sid)
        if blk is None:
            raise ValueError(f"session {sid} lives on process "
                             f"{self.owners[self.shard_of(sid)]}'s shard")
        return blk, row

    # -- session lifecycle ---------------------------------------------------
    @property
    def n_active(self):
        return int(self._active.sum())

    @property
    def active(self):
        return self._active

    def admit(self):
        """Least-loaded placement: the new session lands on the shard
        with the fewest active sessions (ties -> lowest shard index)."""
        with self._lock:
            ranked = [(self._shard_active[s], s)
                      for s in range(self.shards) if self._free_by_shard[s]]
            if not ranked:
                raise FleetFullError(
                    f"all {self.capacity} session rows in use")
            _, shard = min(ranked)
            sid = self._free_by_shard[shard].pop()
            self._shard_active[shard] += 1
            blk, row = self._locate(sid)
            if self._dirty[sid]:    # the deferred wipe, on the device
                if blk is not None:
                    blk.wipe(row)
                self._dirty[sid] = False
            if blk is not None:
                blk.active[row].fill_(1.0)
            self._active[sid] = True
            return sid

    def evict(self, sid):
        with self._lock:
            if not self._active[sid]:
                raise KeyError(f"session {sid} is not active")
            self._active[sid] = False
            self._dirty[sid] = True
            shard = self.shard_of(sid)
            self._free_by_shard[shard].append(sid)
            self._shard_active[shard] -= 1
            blk, row = self._locate(sid)
            if blk is not None:
                blk.active[row].fill_(0.0)

    # -- ingest --------------------------------------------------------------
    def _check_ts(self, ts):
        if len(ts) and int(ts.max()) > _INT32_MAX:
            # the device rings keep int32 frame indices; wrapping would
            # drop the session from every refine round
            raise ValueError("frame index exceeds the device ring's int32 "
                             "range; re-key session time or use "
                             "HostFleetBackend")

    def _plan(self, sids, ts, labels, rows, block):
        """The host half of a scatter: duplicate (sid, slot) writes folded
        to the last, each local shard's entries -> per shard an int32
        array ``[payload rows (m), ring cells (m), ts (m), labels (m), rows
        to advance (k), their newest (k)]`` and ``(m, k)``; None for
        another process's shard.  Shard s reads payload row ``rows[i] - s
        * block`` of its own payload (``block`` 0: every shard reads the
        whole batch)."""
        slots = ts % self.window
        keys = sids * self.window + slots
        keep = np.ones(len(sids), bool)
        if len(np.unique(keys)) < len(keys):
            last = {}
            for i, k in enumerate(keys.tolist()):
                last[k] = i
            keep[:] = False
            keep[np.fromiter(last.values(), np.int64)] = True
        shard = self.shards_of(sids)
        out = [None] * self.shards
        for s in self.local:
            mine = shard == s
            w = keep & mine
            loc = sids - s * self.rows
            adv = np.unique(loc[mine])
            tmax = np.full(len(adv), np.iinfo(np.int64).min)
            np.maximum.at(tmax, np.searchsorted(adv, loc[mine]), ts[mine])
            seg = np.concatenate([
                rows[w] - s * block, loc[w] * self.window + slots[w],
                ts[w], labels[w], adv, tmax]).astype(np.int32)
            out[s] = (seg, (int(w.sum()), len(adv)))
        return out

    def _scatter(self, s, zs, seg, m, k):
        """Shard ``s``'s scatter from its payload ``zs`` (on its device)
        and its index array ``seg`` (int32, on its device): ring cells
        are unique, so ``index_copy_`` writes each once; ``newest`` is a
        gather, a maximum and a write of unique rows."""
        if m == 0 and k == 0:
            return
        blk = self._blocks[s]
        rows, cells = seg[:m].long(), seg[m:2 * m].long()
        d = self.dim
        blk.z.view(-1, d).index_copy_(0, cells, zs.index_select(0, rows))
        blk.t.view(-1).index_copy_(0, cells, seg[2 * m:3 * m])
        blk.label.view(-1).index_copy_(0, cells, seg[3 * m:4 * m])
        adv = seg[4 * m:4 * m + k].long()
        blk.newest.index_copy_(0, adv, torch.maximum(
            blk.newest.index_select(0, adv), seg[4 * m + k:]))

    def _upload(self, plans):
        """The plans' index arrays to their shards' devices: ONE copy a
        distinct device -> one device view per shard."""
        views = [None] * self.shards
        for dev, owned in self.shards_by_device.items():
            host = torch.from_numpy(np.concatenate(
                [plans[s][0] for s in owned]))
            if dev.type == "cuda":
                host = host.pin_memory()
            flat = host.to(dev, non_blocking=True)
            off = 0
            for s in owned:
                n = len(plans[s][0])
                views[s] = flat[off:off + n]
                off += n
        return views

    def insert(self, sid, t, z, label=-1):
        z = z[None] if isinstance(z, torch.Tensor) else np.asarray(z)[None]
        self.insert_batch(np.array([sid]), np.array([t]), z,
                          np.array([label]))

    def insert_batch(self, sids, ts, zs, labels=None):
        """In-place scatter into the device rings.

        ``zs`` may be a device tensor (the payload stays on the device:
        counted in ``ingest_d2d_bytes``) or a host array (one copy to
        each shard's device, counted in ``ingest_h2d_bytes``).  Duplicate
        (sid, slot) writes keep the last, as the host buffer does."""
        with self._lock:
            sids = as_host(sids, np.int64)
            ts = as_host(ts, np.int64)
            if not self._active[sids].all():
                raise KeyError("insert_batch into inactive session")
            if len(sids) == 0:            # host-buffer contract: a no-op
                return
            self._check_ts(ts)
            labels = (np.full(len(sids), -1, np.int64) if labels is None
                      else as_host(labels, np.int64))
            rows = np.arange(len(sids))
            if len(self.local) < self.shards:
                # another process writes its shards' rows: keep this
                # process's frames, and move only their payload
                pick = np.flatnonzero(np.isin(self.shards_of(sids),
                                              self.local))
                rows = np.full(len(sids), -1)
                rows[pick] = np.arange(len(pick))
                zs = zs[torch.from_numpy(pick)] \
                    if isinstance(zs, torch.Tensor) else \
                    as_host(zs, np.float32)[pick]
            if isinstance(zs, torch.Tensor) and \
                    zs.device in self.shards_by_device:
                self.ingest_d2d_bytes += zs.shape[0] * self.dim * 4
            else:
                zs = torch.from_numpy(np.ascontiguousarray(
                    as_host(zs, np.float32)))
                self.ingest_h2d_bytes += zs.numel() * 4
            plans = self._plan(sids, ts, labels, rows, 0)
            views = self._upload(plans)
            on = {dev: zs.to(dev).float() for dev in self.shards_by_device}
            for s in self.local:
                m, k = plans[s][1]
                self._scatter(s, on[self.devices[s]], views[s], m, k)

    def place_batch(self, sids, ts, labels, rows, block):
        """Validate a tick batch already blocked per shard (``rows[i]``
        is frame i's row in an (S·block, d) layout, inside its session's
        shard's block) and plan its scatter -> the per-shard plans that
        ``scatter_placed`` takes (their index arrays on the host)."""
        sids = as_host(sids, np.int64)
        ts = as_host(ts, np.int64)
        rows = as_host(rows, np.int64)
        if not self._active[sids].all():
            raise KeyError("insert_batch into inactive session")
        self._check_ts(ts)
        if not np.array_equal(rows // block, self.shards_of(sids)):
            raise ValueError("frame placed in a row block that is not "
                             "its session's shard")
        labels = (np.full(len(sids), -1, np.int64) if labels is None
                  else as_host(labels, np.int64))
        return self._plan(sids, ts, labels, rows, block)

    def scatter_placed(self, z_blocks, plans, views, frames):
        """Apply ``place_batch``'s plans for a batch of ``frames`` frames:
        shard s's (block, d) payload ``z_blocks[s]`` and its index array
        ``views[s]``, both on shard s's device — no payload byte crosses
        a shard."""
        with self._lock:
            for s in self.local:
                m, k = plans[s][1]
                self._scatter(s, z_blocks[s], views[s], m, k)
            self.ingest_d2d_bytes += frames * self.dim * 4

    def insert_batch_placed(self, sids, ts, zs, labels, rows):
        """Shard-local scatter of a tick batch already blocked per shard.

        ``zs`` is the (R, d) device tensor of the blocked layout (R
        rows, R/S a shard, all on the mesh's one device) or the S
        per-shard (R/S, d) blocks, each on its shard's device;
        ``rows[i]`` is frame i's row in it, which must sit in the block
        of its session's shard (checked).  Rows no frame names (pads)
        are never read, and duplicate (sid, slot) writes keep the last
        frame's, as ``insert_batch``."""
        with self._lock:
            sids = as_host(sids, np.int64)
            if not self._active[sids].all():
                raise KeyError("insert_batch into inactive session")
            if len(sids) == 0:
                return
            if isinstance(zs, torch.Tensor):
                R = int(zs.shape[0])
                if R % self.shards:
                    raise ValueError(f"blocked batch of {R} rows does not "
                                     f"split over {self.shards} shards")
                if any(d != zs.device for d in self.shards_by_device):
                    raise ValueError("one blocked tensor needs every shard "
                                     "on its device: pass per-shard blocks")
                blocks = list(zs.split(R // self.shards))
            elif isinstance(zs, (list, tuple)) and all(
                    isinstance(b, torch.Tensor) for b in zs):
                blocks = list(zs)
            else:
                raise TypeError("insert_batch_placed takes the staged "
                                "device tensor; host payloads go through "
                                "insert_batch")
            block = int(blocks[0].shape[0])
            plans = self.place_batch(sids, ts, labels, rows, block)
            self.scatter_placed(blocks, plans, self._upload(plans),
                                len(sids))

    # -- row migration -------------------------------------------------------
    def export_row(self, sid):
        """Device row -> host representation (one D2H per array): int64
        timestamps with the host ``T_SENTINEL`` marking empty slots, so
        the row implants into either backend kind."""
        with self._lock:
            if not self._active[sid]:
                raise KeyError(f"session {sid} is not active")
            blk, row = self._local_row(sid)
            z = blk.z[row].cpu().numpy()
            t32 = blk.t[row].cpu().numpy()
            t = t32.astype(np.int64)
            t[t32 == T_SENTINEL_DEV] = T_SENTINEL
            label = blk.label[row].cpu().numpy().astype(np.int64)
            return z, t, label, int(blk.newest[row])

    def import_row(self, sid, z, t, label, newest):
        with self._lock:
            if not self._active[sid]:
                raise KeyError(f"session {sid} is not active")
            z = as_host(z, np.float32)
            if z.shape != (self.window, self.dim):
                raise ValueError(
                    f"row shape {z.shape} != ({self.window}, {self.dim}) "
                    "— migrating between fleets with different window/dim "
                    "is not supported")
            t = as_host(t, np.int64)
            live = t != T_SENTINEL
            self._check_ts(t[live])
            t32 = np.where(live, t, T_SENTINEL_DEV).astype(np.int32)
            blk, row = self._locate(sid)
            if blk is None:                 # another process's row
                return
            blk.z[row].copy_(torch.from_numpy(np.ascontiguousarray(z)))
            blk.t[row].copy_(torch.from_numpy(t32))
            blk.label[row].copy_(torch.from_numpy(
                as_host(label, np.int64).astype(np.int32)))
            blk.newest[row].fill_(int(newest))
            self.ingest_h2d_bytes += z.nbytes + t32.nbytes

    def fill_fraction(self, sid):
        with self._lock:
            if not self._active[sid]:
                return 0.0
            blk, row = self._local_row(sid)
            newest = int(blk.newest[row])
            if newest < 0:
                return 0.0
            order = np.arange(newest - self.window + 1, newest + 1)
            t_row = blk.t[row].cpu().numpy()
            return float((t_row[order % self.window] == order).mean())

    # -- refinement ----------------------------------------------------------
    def _snapshots(self):
        """The local shards' snapshots, in shard order."""
        return [_snapshot_rows(b.z, b.t, b.label, b.newest, b.active,
                               window=self.window)
                for b in (self._blocks[s] for s in self.local)]

    def _every_shard(self, vals, what):
        """The local shards' values -> every shard's, in shard order: as
        given in one process, else gathered from the job's processes (an
        exchange, not a collective of the round: its staging is counted
        in ``Job.staged``)."""
        if len(self.local) == self.shards:
            return vals
        return _job.exchange(vals, self.owners, what)

    def refine(self, rnd):
        """One fleet-wide step across the mesh with round ``rnd``'s draws:
        no snapshot crosses the host boundary, only the loss, the parts
        and the per-session losses come back, in ONE copy."""
        if self.refiner is None:
            raise RuntimeError("backend built without a head: no refiner")
        with self._lock:
            W, d = self.window, self.dim
            dirs, prior = self.refiner.draw(rnd, W, d)
            snaps = self._snapshots()
            actives = [self._blocks[s].active for s in self.local]
            a_total = psum([a.sum() for a in actives], self.axis)
            params = self.refiner.state.params
            outs = []
            for dev, (z, mask, labels), act, a_tot in zip(
                    [self.devices[s] for s in self.local], snaps, actives,
                    a_total):
                outs.append(value_and_grad(
                    self._loss, tree_map(lambda p: p.to(dev), params),
                    dirs.to(dev), prior.to(dev), z, mask, labels, act,
                    a_tot))
            loss = pmean([o[0][0] for o in outs], self.axis)[0]
            parts = {k: pmean([o[0][1][1][k] for o in outs], self.axis)[0]
                     for k in outs[0][0][1][1]}
            grads = pmean_grads([o[1] for o in outs], self.axis)[0]
            self.refiner.apply_grads(grads)
            if self.memory is not None:
                self.memory = gmm.em_update(
                    self.memory, [z.reshape(-1, d) for z, _, _ in snaps],
                    weights=[m.reshape(-1) for _, m, _ in snaps],
                    decay=self.memory_decay, reseed_frac=0.0,
                    axis_name=self.axis)[0]
            losses = torch.cat([x.to(self.device) for x in self._every_shard(
                [o[0][1][0] for o in outs], "refine losses")])
            return fetch((loss, parts, losses))

    # -- observability -------------------------------------------------------
    def snapshot(self):
        """Host copy of the fleet view (observability — NOT the refine
        path, which reads the rings in place)."""
        with self._lock:
            snaps = self._every_shard(self._snapshots(), "snapshot")
            return tuple(torch.cat([s[i].cpu() for s in snaps]).numpy()
                         for i in range(3))


def make_backend(kind="host", **kw) -> FleetBackend:
    """Backend factory: ``host`` (numpy rings) or ``sharded``
    (device-resident rings over a sessions mesh)."""
    if kind == "host":
        kw.pop("mesh", None)
        kw.pop("axis", None)
        return HostFleetBackend(**kw)
    if kind == "sharded":
        return ShardedFleetBackend(**kw)
    raise ValueError(f"unknown fleet backend kind: {kind!r}")
