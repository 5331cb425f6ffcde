"""Data-parallel training steps with explicit cross-shard gradient
synchronization, optionally *compressed* (int8 wire + error feedback).

Port of ``repro.distributed.grad_sync``.  The reference runs its step
under ``shard_map``; here a process computes each of its shards'
gradients on that shard's block of the batch, on the shard's device, and
the gradients meet through the collectives of ``distributed.sharding``
(``PerShard`` lists in shard order), across processes in a joined job.
"""
from __future__ import annotations

from repro_torch.distributed.sharding import (PerShard, pmean, psum,
                                              row_blocks)
from repro_torch.optim.compression import ErrorFeedback
from repro_torch.optim.sgd import (tree_leaves, tree_map, tree_unflatten,
                                   value_and_grad)


def pmean_grads(grads, axis_name=None):
    """Cross-shard gradient mean of the shards' gradient trees — the
    uncompressed synchronization of the sharded fleet backend's refine
    (its loss is pre-scaled by the shard count, so the mean is the
    global sum; see ``core.fleet_refiner.make_fleet_loss``)."""
    return pmean(grads, axis_name)


def psum_grads(grads, axis_name=None):
    """Cross-shard gradient sum, for losses that already carry the
    global normalization."""
    return psum(grads, axis_name)


def _structure(tree):
    if isinstance(tree, dict):
        return tuple((k, _structure(tree[k])) for k in sorted(tree))
    if isinstance(tree, (list, tuple)):
        return (type(tree).__name__,) + tuple(_structure(v) for v in tree)
    return tuple(tree.shape)


def make_compressed_dp_step(mesh, loss_fn, opt_update, *, axis="data",
                            lr=1e-3, compress=True, opt_kwargs=None):
    """``loss_fn(params, batch) -> scalar``; the batch is split over
    ``axis`` (dim 0 of every leaf, in equal blocks).

    Returns ``step(params, opt_state, ef, batch) -> (params, opt_state,
    ef)``: each shard's gradient on its block, synchronized by the int8
    ``ErrorFeedback`` all-reduce (or an exact ``pmean`` without
    ``compress``), then ONE ``opt_update`` of the replicated params
    (the port's optimizers update in place).  ``ef`` is one tree
    (``ef_init``; every shard starts from it) or the ``PerShard``
    trees a previous step returned: each shard keeps its own residual,
    as each device keeps its own buffer in the reference.  The row
    blocks are planned once for each batch tree structure.  In a joined
    job each process runs its own shards of ``axis`` on their blocks (and
    holds their residuals); every process passes the whole batch."""
    opt_kwargs = opt_kwargs or {}
    S = mesh.shape[axis]
    local = mesh.axis_local(axis)
    devices = [mesh.axis_devices(axis)[s] for s in local]
    plans = {}

    def split(batch):
        """The batch -> this process's shards' row blocks, on their
        devices."""
        key = _structure(batch)
        if key not in plans:
            plans[key] = [row_blocks(x.shape[0], S)
                          for x in tree_leaves(batch)]
        leaves = tree_leaves(batch)
        return [tree_unflatten(batch, [x[blk[s]].to(dev)
                                       for x, blk in zip(leaves, plans[key])])
                for s, dev in zip(local, devices)]

    def grad_of(params, batch):
        (_, _), grads = value_and_grad(
            lambda p, b: (loss_fn(p, b), None), params, batch)
        return tree_unflatten(params, grads)

    def step(params, opt_state, ef, batch):
        blocks = split(batch)
        grads = PerShard(grad_of(tree_map(lambda p: p.to(d), params), b)
                         for d, b in zip(devices, blocks))
        if compress:
            if not isinstance(ef, PerShard):
                ef = PerShard(tree_map(lambda t: t.to(d), ef)
                              for d in devices)
            grads, ef = ErrorFeedback.apply(grads, ef, axis_name=axis)
        else:
            grads = pmean_grads(grads, axis)
        first = tree_leaves(params)[0].device
        params, opt_state = opt_update(
            params, tree_map(lambda g: g.to(first), grads[0]), opt_state,
            lr=lr, **opt_kwargs)
        return params, opt_state, ef

    return step


def ef_init(params):
    return ErrorFeedback.init(params)


__all__ = ["pmean_grads", "psum_grads", "make_compressed_dp_step",
           "ef_init"]
