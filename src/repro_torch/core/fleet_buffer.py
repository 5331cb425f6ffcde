"""Host-side fleet session rings: N temporal buffers in dense arrays.

Port of ``repro.core.fleet_buffer``: the rings are host numpy in both
packages, so the code carries over as it is; ``as_host`` takes torch
tensors where the reference took ``jax.Array``s.
"""
from __future__ import annotations

import numpy as np
import torch

# Timestamp sentinel: far below any reachable negative window index, so an
# empty slot can never alias a real frame index.
T_SENTINEL = -(1 << 60)


class FleetFullError(RuntimeError):
    """Raised by ``FleetBuffer.admit`` when every session row is in use."""


def as_host(x, dtype):
    """``np.asarray`` that takes torch tensors too: one device->host copy
    for a device tensor, and no second conversion copy when the dtype
    already matches."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    else:
        x = np.asarray(x)
    return x if x.dtype == dtype else x.astype(dtype)


def pad_pow2(n):
    """Next power of two (1 for n <= 1): the gateway pads its staged
    tick and every k-bucket to it, as the reference does."""
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


class FleetBuffer:
    """N temporal ring buffers packed into dense arrays.

    Each *row* is one client session: frames keyed by absolute index
    ``t`` land in slot ``t % window``, older frames expire by overwrite,
    and ``snapshot`` returns the last ``window`` frames in temporal order
    with a validity (gap) mask.  Admission hands out the lowest free row
    in O(1); eviction returns the row to the free-list in O(1) and the
    row is wiped on its next admission.
    """

    def __init__(self, capacity=32, window=100, dim=128):
        self.capacity = capacity
        self.window = window
        self.dim = dim
        self.z = np.zeros((capacity, window, dim), np.float32)
        self.t = np.full((capacity, window), T_SENTINEL, np.int64)
        self.label = np.full((capacity, window), -1, np.int64)
        self.newest = np.full((capacity,), -1, np.int64)
        self.active = np.zeros((capacity,), bool)
        self._dirty = np.zeros((capacity,), bool)      # lazy wipe-on-admit
        self._free = list(range(capacity - 1, -1, -1))  # stack: pop -> row 0

    # -- session lifecycle (O(1)) -------------------------------------------
    @property
    def n_active(self):
        return int(self.active.sum())

    def admit(self):
        """-> session row id (sid).  Raises FleetFullError when full.

        O(1) except when re-admitting onto a row left dirty by ``evict``,
        which pays the deferred O(W·d) wipe here — a new tenant never
        sees the previous tenant's frames."""
        if not self._free:
            raise FleetFullError(f"all {self.capacity} session rows in use")
        sid = self._free.pop()
        if self._dirty[sid]:
            self.z[sid] = 0.0
            self.t[sid] = T_SENTINEL
            self.label[sid] = -1
            self.newest[sid] = -1
            self._dirty[sid] = False
        self.active[sid] = True
        return sid

    def evict(self, sid):
        """Release a session row; the wipe waits for its next ``admit``
        (``snapshot`` already masks inactive rows)."""
        if not self.active[sid]:
            raise KeyError(f"session {sid} is not active")
        self.active[sid] = False
        self._dirty[sid] = True
        self._free.append(sid)

    # -- ingest --------------------------------------------------------------
    def insert(self, sid, t, z, label=-1):
        if not self.active[sid]:
            raise KeyError(f"session {sid} is not active")
        slot = t % self.window
        self.z[sid, slot] = as_host(z, np.float32)
        self.t[sid, slot] = t
        self.label[sid, slot] = label
        self.newest[sid] = max(self.newest[sid], t)

    def insert_batch(self, sids, ts, zs, labels=None):
        """Vectorized ingest of one frame per (distinct) session."""
        sids = as_host(sids, np.int64)
        ts = as_host(ts, np.int64)
        if not self.active[sids].all():
            raise KeyError("insert_batch into inactive session")
        slots = ts % self.window
        self.z[sids, slots] = as_host(zs, np.float32)
        self.t[sids, slots] = ts
        if labels is None:
            self.label[sids, slots] = -1
        else:
            self.label[sids, slots] = as_host(labels, np.int64)
        np.maximum.at(self.newest, sids, ts)

    # -- row migration --------------------------------------------------------
    def export_row(self, sid):
        """Copy one session row out of the dense rings:
        ``(z (W, d), t (W,), label (W,), newest)``.  Arrays are copies:
        the snapshot stays frozen while the row keeps serving."""
        if not self.active[sid]:
            raise KeyError(f"session {sid} is not active")
        return (self.z[sid].copy(), self.t[sid].copy(),
                self.label[sid].copy(), int(self.newest[sid]))

    def import_row(self, sid, z, t, label, newest):
        """Implant an exported row into an (already admitted) session
        slot — the exact inverse of ``export_row``."""
        if not self.active[sid]:
            raise KeyError(f"session {sid} is not active")
        if z.shape != (self.window, self.dim):
            raise ValueError(
                f"row shape {z.shape} != ({self.window}, {self.dim}) — "
                "migrating between fleets with different window/dim is "
                "not supported")
        self.z[sid] = as_host(z, np.float32)
        self.t[sid] = as_host(t, np.int64)
        self.label[sid] = as_host(label, np.int64)
        self.newest[sid] = int(newest)

    # -- snapshot ------------------------------------------------------------
    def snapshot(self):
        """-> (z (N, W, d), mask (N, W), labels (N, W)) in temporal order.

        mask=0 marks gaps, expired frames, empty sessions, and every slot
        of inactive rows."""
        N, W = self.capacity, self.window
        lo = self.newest - W + 1                       # (N,)
        order = lo[:, None] + np.arange(W)[None, :]     # (N, W)
        slots = order % W
        rows = np.arange(N)[:, None]
        valid = (self.t[rows, slots] == order)
        valid &= (self.newest >= 0)[:, None] & self.active[:, None]
        z = np.where(valid[:, :, None], self.z[rows, slots], 0.0)
        labels = np.where(valid, self.label[rows, slots], -1)
        return z.astype(np.float32), valid.astype(np.float32), labels

    def fill_fraction(self, sid):
        """Fraction of this session's window that holds live frames."""
        if not self.active[sid] or self.newest[sid] < 0:
            return 0.0
        order = np.arange(self.newest[sid] - self.window + 1,
                          self.newest[sid] + 1)
        return float((self.t[sid, order % self.window] == order).mean())
