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
weight decay.
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
