"""AdamW (decoupled weight decay), the edge learner's optimizer (paper §5
uses Adam).

Port of ``repro.optim.adamw``.  State: float32 ``m`` and ``v`` shaped
like the parameters, and an int32 ``step``.  Like ``optim.sgd`` and
unlike the reference, whose update returns new arrays, ``adamw_update``
updates the parameters and the moments IN PLACE (under
``torch.no_grad``) and returns the same objects, so a training step
allocates no second copy of the model.  The arithmetic is the
reference's, with its defaults: b1 0.9, b2 0.95, eps 1e-8, no weight
decay, and the gradients scaled by ``min(1, grad_clip / ‖g‖)`` with
‖g‖ the global norm over every leaf (``grad_clip=1.0``).
"""
from __future__ import annotations

import torch

from repro_torch.optim.sgd import tree_leaves, tree_map


def adamw_init(params):
    """Zero float32 moments shaped like ``params`` and step 0, on the
    parameters' device."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    step_dev = tree_leaves(params)[0].device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=step_dev)}


@torch.no_grad()
def adamw_update(params, grads, state, *, lr, b1=0.9, b2=0.95, eps=1e-8,
                 weight_decay=0.0, grad_clip=1.0):
    """One step, in place.  ``grads`` is a tree like ``params`` or the
    flat list of its leaves in ``tree_leaves`` order -> (params, state)."""
    grads = tree_leaves(grads)
    state["step"] += 1
    if grad_clip:
        gnorm = torch.sqrt(sum(g.float().square().sum() for g in grads))
        scale = torch.clamp(grad_clip / gnorm.clamp_min(1e-9), max=1.0)
        grads = [g * scale.to(g.dtype) for g in grads]
    step = state["step"].float()
    bc1 = 1 - torch.tensor(b1, dtype=torch.float32,
                           device=step.device) ** step
    bc2 = 1 - torch.tensor(b2, dtype=torch.float32,
                           device=step.device) ** step
    for p, m, v, g in zip(tree_leaves(params), tree_leaves(state["m"]),
                          tree_leaves(state["v"]), grads, strict=True):
        g = g.float()
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g.square())
        u = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        if weight_decay:
            u = u + weight_decay * p.float()
        p.copy_((p.float() - lr * u).to(p.dtype))
    return params, state
