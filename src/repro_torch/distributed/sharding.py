"""The sessions half of the reference's sharding module: the mesh the
fleet data plane shards its session rows over, the row block each shard
owns, and the collectives the reference's ``shard_map`` code calls.

Port of the fleet part of ``repro.distributed.sharding`` (the logical
axis rules of the LM modules are not here).  The reference runs one
program per device under ``shard_map``; the port runs in one process
and holds one value per shard, in shard order.  A mesh is an ordered
array of ``torch.device``s with named axes, and a device may appear
more than once: S logical shards on one card are the counterpart of the
reference's forced host devices on one CPU.

Collectives take the shards' values as a sequence, in shard order (a
tensor, or a dict/list/tuple tree of tensors, per shard), and return a
``PerShard`` list with one result per shard, each on that shard's
device.  Each reduction runs once, on the first shard's device, in
fixed shard order (``x0 + x1 + ...``), with no atomics, so it gives the
same bits on every run; at one shard each collective returns its input
unchanged.  The reductions carry autograd like any other tensor
arithmetic: a result's gradient reaches every shard's input.
"""
from __future__ import annotations

import numpy as np
import torch

# The mesh axis the fleet data plane shards the session dimension over:
# every (N, W, d) ring, its timestamp and label rings and the per-session
# masks are split on dim 0.
SESSIONS_AXIS = "sessions"


class PerShard(list):
    """One value per shard of a mesh axis, in shard order (what the
    collectives return, and what the port's ``axis_name`` forms take
    where the reference takes each shard's local value)."""


class Mesh:
    """An n-d array of ``torch.device``s with one name per axis.

    ``shape`` maps each axis name to its size, as the reference's
    ``Mesh.shape`` does; ``devices`` is the object array itself."""

    def __init__(self, devices, axis_names):
        arr = np.empty(np.shape(devices), dtype=object)
        flat = [torch.device(d) for d in np.asarray(devices,
                                                    dtype=object).flat]
        for i, d in enumerate(flat):
            arr.flat[i] = d
        if arr.ndim != len(axis_names):
            raise ValueError(f"{arr.ndim}-d device array for axes "
                             f"{tuple(axis_names)}")
        if not arr.size:
            raise ValueError("a mesh needs at least one device")
        self.devices = arr
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    def axis_devices(self, axis) -> list:
        """The devices along ``axis`` at index 0 of every other axis."""
        i = self.axis_names.index(axis)
        idx = tuple(slice(None) if j == i else 0
                    for j in range(len(self.axis_names)))
        return list(self.devices[idx])

    def __repr__(self):
        return f"Mesh({self.shape}, {list(self.devices.flat)})"


def row_blocks(n_rows: int, shards: int) -> list:
    """The contiguous block of rows each of ``shards`` shards owns:
    shard s holds rows ``[s * n/S, (s + 1) * n/S)`` -> S slices."""
    if n_rows % shards:
        raise ValueError(f"{n_rows} rows do not split evenly over "
                         f"{shards} shards")
    per = n_rows // shards
    return [slice(s * per, (s + 1) * per) for s in range(shards)]


def sessions_sharding(mesh: Mesh, n_rows: int,
                      axis: str = SESSIONS_AXIS) -> list:
    """Where fleet state of ``n_rows`` rows lives on ``mesh``: dim 0 (the
    session axis) split over ``axis``, every trailing dim (window, embed)
    whole on each shard -> one ``(device, row slice)`` per shard, in
    shard order."""
    return list(zip(mesh.axis_devices(axis),
                    row_blocks(n_rows, mesh.shape[axis])))


# -- collectives -------------------------------------------------------------

def _tree_map(fn, *trees):
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, (list, tuple)) and not isinstance(t0, PerShard):
        return type(t0)(_tree_map(fn, *parts) for parts in zip(*trees))
    return fn(*trees)


def _reduce(xs, op):
    """``op`` folded over the shards' values in shard order on the first
    shard's device -> one result per shard, on its own device."""
    xs = list(xs)
    if not xs:
        raise ValueError("a collective needs at least one shard")
    if len(xs) == 1:
        return PerShard(xs)

    def leaf(*vals):
        acc = vals[0]
        for v in vals[1:]:
            acc = op(acc, v.to(acc.device))
        return acc
    total = _tree_map(leaf, *xs)
    return PerShard(_tree_map(lambda a, x: a.to(x.device), total, x)
                    for x in xs)


def psum(xs, axis_name=None):
    """Sum over the shards (``jax.lax.psum``)."""
    return _reduce(xs, torch.add)


def pmax(xs, axis_name=None):
    """Elementwise maximum over the shards (``jax.lax.pmax``)."""
    return _reduce(xs, torch.maximum)


def pmean(xs, axis_name=None):
    """``psum`` divided by the shard count (``jax.lax.pmean``)."""
    xs = list(xs)
    if len(xs) == 1:
        return PerShard(xs)
    n = len(xs)
    return PerShard(_tree_map(lambda t: t / n, s) for s in psum(xs))


def ppermute(xs, perm, axis_name=None):
    """Send shard ``src``'s value to shard ``dst`` for each ``(src, dst)``
    of ``perm``; a shard no pair sends to gets zeros
    (``jax.lax.ppermute``)."""
    xs = list(xs)
    dsts = [d for _, d in perm]
    if len(set(dsts)) != len(dsts):
        raise ValueError(f"ppermute {perm}: a shard receives twice")
    out = PerShard(_tree_map(torch.zeros_like, x) for x in xs)
    for src, dst in perm:
        out[dst] = _tree_map(lambda a, x: a.to(x.device), xs[src], xs[dst])
    return out


__all__ = ["SESSIONS_AXIS", "Mesh", "PerShard", "row_blocks",
           "sessions_sharding", "psum", "pmax", "pmean", "ppermute"]
