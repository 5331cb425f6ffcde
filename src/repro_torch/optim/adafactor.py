"""Adafactor (Shazeer & Stern, arXiv:1804.04235) with factored second
moments: row and column statistics for every matrix, so the optimizer's
memory is O(rows + cols) a matrix rather than Adam's two full moments.

Port of ``repro.optim.adafactor``.  State: ``stats``, a tree like the
parameters whose leaves are ``{"vr", "vc"}`` (a leaf of rank >= 2: the
mean of g² + eps over the last axis, and over the second to last) or
``{"v"}`` (rank < 2), float32, and an int32 ``step``.  Like the port's
``adamw.py`` and unlike the reference, ``adafactor_update`` updates the
parameters and the statistics IN PLACE (under ``torch.no_grad``) and
returns the same objects.  The arithmetic is the reference's: decay
``beta = 1 - t^-0.8``, the update clipped to RMS <= 1, optional decoupled
weight decay.  ``adafactor_update_placed`` is the same step on a mesh's
blocks (``runtime/trainer``'s sharded step).
"""
from __future__ import annotations

import torch

from repro_torch.optim.sgd import tree_leaves, tree_map


def _factored(shape):
    return len(shape) >= 2


def adafactor_init(params):
    """Zero float32 statistics shaped for ``params`` and step 0, on the
    parameters' device."""
    def leaf(t):
        z = dict(dtype=torch.float32, device=t.device)
        if _factored(t.shape):
            return {"vr": torch.zeros(t.shape[:-1], **z),
                    "vc": torch.zeros(t.shape[:-2] + t.shape[-1:], **z)}
        return {"v": torch.zeros(t.shape, **z)}
    step_dev = tree_leaves(params)[0].device
    return {"stats": tree_map(leaf, params),
            "step": torch.zeros((), dtype=torch.int32, device=step_dev)}


def _stat_dicts(params, stats):
    """The per-leaf statistics dicts, in ``tree_leaves(params)`` order."""
    if isinstance(params, dict):
        return [s for k in sorted(params)
                for s in _stat_dicts(params[k], stats[k])]
    if isinstance(params, (list, tuple)):
        return [s for p, st in zip(params, stats)
                for s in _stat_dicts(p, st)]
    return [stats]


@torch.no_grad()
def adafactor_update(params, grads, state, *, lr, decay=0.8, eps=1e-30,
                     clip_threshold=1.0, weight_decay=0.0):
    """One step, in place.  ``grads`` is a tree like ``params`` or the
    flat list of its leaves in ``tree_leaves`` order -> (params, state)."""
    state["step"] += 1
    t = state["step"].float()
    beta = 1.0 - t ** (-decay)          # increasing-decay schedule
    for p, g, s in zip(tree_leaves(params), tree_leaves(grads),
                       _stat_dicts(params, state["stats"]), strict=True):
        g = g.float()
        g2 = g.square() + eps
        if _factored(p.shape):
            vr, vc = s["vr"], s["vc"]
            vr.copy_(beta * vr + (1 - beta) * g2.mean(-1))
            vc.copy_(beta * vc + (1 - beta) * g2.mean(-2))
            denom = vr.mean(-1, keepdim=True)
            r = vr / denom.clamp_min(eps)
            u = g * torch.rsqrt(r)[..., None] * torch.rsqrt(vc)[..., None, :]
        else:
            v = s["v"]
            v.copy_(beta * v + (1 - beta) * g2)
            u = g * torch.rsqrt(v)
        # update clipping (RMS <= clip_threshold)
        rms = torch.sqrt(u.square().mean())
        u = u / torch.clamp_min(rms / clip_threshold, 1.0)
        if weight_decay:
            u = u + weight_decay * p.float()
        p.copy_((p.float() - lr * u).to(p.dtype))
    return params, state


@torch.no_grad()
def adafactor_update_placed(params, grads, state, *, lr, decay=0.8,
                            eps=1e-30, clip_threshold=1.0, weight_decay=0.0):
    """``adafactor_update`` on a mesh, in place: ``params`` a tree of
    ``Placed`` leaves, ``grads`` one list of per-shard blocks a leaf (in
    ``tree_leaves`` order), ``state`` as ``adafactor_init``'s with
    ``Placed`` leaves laid out by ``placed_stats_sharding``.  Every mean
    of the factored statistics and the update's RMS is taken over the
    whole leaf: each shard's partial sums psum'd over the mesh axes that
    split the reduced dims.  Replicas of a block compute the same bits.
    On a mesh that spans processes each process updates its own blocks
    (``grads`` then hold this process's shards')."""
    from repro_torch.distributed.sharding import psum_over, spec_axes

    steps = state["step"].local_blocks
    for t in steps:
        t += 1
    for leaf, gs, st in zip(tree_leaves(params), grads,
                            _stat_dicts(params, state["stats"]),
                            strict=True):
        mesh = leaf.sharding.mesh
        spec = tuple(leaf.sharding.spec) + (None,) * (
            len(leaf.shape) - len(leaf.sharding.spec))

        def total(vals, dims):
            """Sum over ``dims`` of the whole leaf, from each block's."""
            axes = spec_axes(tuple(spec[d] for d in dims))
            return psum_over(vals, mesh, axes) if axes else vals

        n = len(leaf.local_blocks)
        g = [x.float() for x in gs]
        g2 = [x.square() + eps for x in g]
        betas = [1.0 - t.float() ** (-decay) for t in steps]
        if _factored(leaf.shape):
            nd = len(leaf.shape)
            rows = total([x.sum(-1) for x in g2], (nd - 1,))
            cols = total([x.sum(-2) for x in g2], (nd - 2,))
            vr, vc = st["vr"].local_blocks, st["vc"].local_blocks
            for s in range(n):
                b = betas[s]
                vr[s].copy_(b * vr[s] + (1 - b) * (rows[s] / leaf.shape[-1]))
                vc[s].copy_(b * vc[s] + (1 - b) * (cols[s] / leaf.shape[-2]))
            denom = total([x.sum(-1, keepdim=True) for x in vr], (nd - 2,))
            u = [g[s] * torch.rsqrt(vr[s] / (denom[s] / leaf.shape[-2])
                                    .clamp_min(eps))[..., None]
                 * torch.rsqrt(vc[s])[..., None, :] for s in range(n)]
        else:
            v = st["v"].local_blocks
            for s in range(n):
                v[s].copy_(betas[s] * v[s] + (1 - betas[s]) * g2[s])
            u = [g[s] * torch.rsqrt(v[s]) for s in range(n)]
        sq = total([x.square().sum() for x in u], range(len(leaf.shape)))
        numel = leaf.shape.numel()
        for s, p in enumerate(leaf.local_blocks):
            rms = torch.sqrt(sq[s] / numel)
            us = u[s] / torch.clamp_min(rms / clip_threshold, 1.0)
            if weight_decay:
                us = us + weight_decay * p.float()
            p.copy_((p.float() - lr * us).to(p.dtype))
    return params, state


def placed_stats_sharding(sharding, shape):
    """Where a leaf's statistics live when the leaf is laid out by
    ``sharding``: ``{"vr", "vc"}`` (the leaf's spec without its last, or
    its second to last, dim) or ``{"v"}`` (the leaf's)."""
    from repro_torch.distributed.sharding import NamedSharding
    spec = tuple(sharding.spec) + (None,) * (len(shape) - len(sharding.spec))
    if _factored(shape):
        return {"vr": NamedSharding(sharding.mesh, spec[:-1]),
                "vc": NamedSharding(sharding.mesh, spec[:-2] + spec[-1:])}
    return {"v": sharding}
