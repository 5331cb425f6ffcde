"""SGD with momentum (the paper's server-side optimizer, §5), and the
parameter-tree helpers the refiners take their gradients with.

Port of ``repro.optim.sgd``.  Parameters are a (possibly nested) dict or
list of tensors.  Unlike the reference, whose update returns new arrays,
``sgd_update`` updates the parameters and the momentum IN PLACE (under
``torch.no_grad``) and returns the same objects, so a refine round
allocates nothing for its step.  The arithmetic is the reference's:
``m = momentum * m + g`` then ``p = p - lr * m`` (Nesterov: ``p = p - lr *
(g + momentum * m)``).
"""
from __future__ import annotations

import torch


def tree_leaves(tree):
    """The tensors of a nested dict/list/tuple, dicts in key order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree):
    """``tree`` with ``fn`` applied to every tensor (a new container)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_unflatten(tree, leaves):
    """``tree`` with its tensors replaced, in ``tree_leaves`` order, by
    ``leaves``."""
    it = iter(leaves)

    def rec(t):
        if isinstance(t, dict):
            return {k: rec(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return type(t)(rec(v) for v in t)
        return next(it)
    return rec(tree)


def value_and_grad(fn, params, *args):
    """``fn(params, *args) -> (loss, aux)`` and the gradient of ``loss``
    with respect to ``params`` -> ``((loss detached, aux), grads)``, the
    gradients listed in ``tree_leaves(params)`` order (the counterpart of
    ``jax.value_and_grad(fn, has_aux=True)``)."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    with torch.enable_grad():
        loss, aux = fn(tree_unflatten(params, leaves), *args)
        grads = torch.autograd.grad(loss, leaves)
    return (loss.detach(), aux), list(grads)


def sgd_init(params):
    return (tree_map(torch.zeros_like, params),)


@torch.no_grad()
def sgd_update(params, grads, state, *, lr, momentum=0.9, nesterov=False):
    """One step, in place.  ``grads`` is a tree like ``params`` or the
    flat list of its leaves in ``tree_leaves`` order -> (params, state)."""
    (m,) = state
    for p, a, g in zip(tree_leaves(params), tree_leaves(m),
                       tree_leaves(grads), strict=True):
        a.mul_(momentum).add_(g)
        upd = g + momentum * a if nesterov else a
        p.sub_(lr * upd.to(p.dtype))
    return params, state
