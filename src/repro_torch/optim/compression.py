"""Gradient compression for cross-shard synchronization.

Port of ``repro.optim.compression``.  ``int8_psum`` is an all-reduce
with an int8 wire: the shards agree on one scale through a ``pmax``,
their payloads are int8 (summed in int32), and the sum is dequantized —
a quarter of float32's bytes on the link.  ``ErrorFeedback`` keeps the
quantization residual and adds it back the next step (EF-SGD), which
restores convergence.

The reference computes all of it in jnp, with no Pallas kernel, so it
is plain PyTorch here.  Its arithmetic is the reference's, operation by
operation: ``torch.round`` rounds half to even as ``jnp.round`` does,
values are divided by the scale (not multiplied by its reciprocal), and
the scale is ``max(amax / 127, 1e-12)``.  The ``axis_name`` forms take
the shards' values as a sequence and return a ``PerShard`` list
(``distributed.sharding``).
"""
from __future__ import annotations

import torch

from repro_torch.distributed.sharding import PerShard, pmax, pmean, psum
from repro_torch.optim.sgd import tree_leaves, tree_map, tree_unflatten


def _scale(amax):
    return torch.clamp_min(amax / 127.0, 1e-12)


def _levels(x, scale):
    return torch.clamp(torch.round(x.float() / scale), -127, 127)


def int8_psum(xs, axis_name=None):
    """All-reduce sum of the shards' tensors ``xs`` with an int8 wire
    format (one shared per-tensor scale) -> ``PerShard`` sums."""
    xs = list(xs)
    scales = [_scale(a) for a in pmax([x.float().abs().max() for x in xs])]
    q = [_levels(x, s).to(torch.int8) for x, s in zip(xs, scales)]
    total = psum([v.to(torch.int32) for v in q])
    return PerShard(t.float() * s for t, s in zip(total, scales))


def compress_decompress(x):
    """Local quantize -> dequantize (what the wire does to the tensor)."""
    scale = _scale(x.float().abs().max())
    return _levels(x, scale) * scale


class ErrorFeedback:
    """Functional error-feedback state for compressed gradient sync."""

    @staticmethod
    def init(params):
        return tree_map(lambda t: torch.zeros(t.shape, dtype=torch.float32,
                                              device=t.device), params)

    @staticmethod
    def apply(grads, ef_state, axis_name=None):
        """-> (synced grads, new error-feedback state).

        ``g' = compress(g + e)``, ``e' = (g + e) - payload``.  Without
        ``axis_name``, ``grads`` and ``ef_state`` are one tree each.  With
        it they are the shards' trees (sequences in shard order) and the
        result is two ``PerShard`` lists: every shard's payload is
        quantized against the shards' common scale (a ``pmax``) and the
        payloads are ``pmean``'d."""
        if axis_name is None:
            gs = tree_leaves(grads)
            ys = [g.float() + e for g, e in zip(gs, tree_leaves(ef_state))]
            payload = [compress_decompress(y) for y in ys]
            return (tree_unflatten(grads, [p.to(g.dtype)
                                           for g, p in zip(gs, payload)]),
                    tree_unflatten(ef_state, [y - p for y, p
                                              in zip(ys, payload)]))
        grads, ef_state = list(grads), list(ef_state)
        leaves = [tree_leaves(g) for g in grads]
        efs = [tree_leaves(e) for e in ef_state]
        synced = [[] for _ in grads]
        resid = [[] for _ in grads]
        for i in range(len(leaves[0])):
            ys = [lv[i].float() + ef[i] for lv, ef in zip(leaves, efs)]
            scales = [_scale(a) for a in pmax([y.abs().max() for y in ys])]
            payload = [_levels(y, s) * s for y, s in zip(ys, scales)]
            for s, (out, lv) in enumerate(zip(pmean(payload), leaves)):
                synced[s].append(out.to(lv[i].dtype))
                resid[s].append(ys[s] - payload[s])
        return (PerShard(tree_unflatten(g, o) for g, o in zip(grads, synced)),
                PerShard(tree_unflatten(e, r)
                         for e, r in zip(ef_state, resid)))


def wire_bytes_fp32(params):
    return sum(t.numel() * 4 for t in tree_leaves(params))


def wire_bytes_int8(params):
    return sum(t.numel() * 1 + 4 for t in tree_leaves(params))


__all__ = ["int8_psum", "compress_decompress", "ErrorFeedback",
           "wire_bytes_fp32", "wire_bytes_int8"]
