"""Elastic scaling: lay a training state onto a different mesh.

Port of ``repro.checkpoint.elastic``.  Checkpoints are mesh-agnostic
(full arrays, ``checkpoint/manager.py``), so re-entry onto a new mesh is
laying each leaf out by the new mesh's rules: a job can restart on a
degraded fleet as long as the new mesh divides the split dims.
``largest_feasible_mesh`` picks the biggest (data, model) grid for the
devices that survive.  With ``fsdp=True`` the weights' ``embed`` dims
split over 'data' as well; a trainer under ``rules_for(...,
fsdp=True)`` takes such a state with ``Trainer.load_state``, which
re-lays the leaves its own rules lay out otherwise (the attention
projections' ``q_in``/``kv_in``, which ``make_rules`` leaves whole).  The port's mesh may name one device more than once
(logical shards of one card).
"""
from __future__ import annotations

import numpy as np

from repro_torch.distributed import sharding as shd
from repro_torch.distributed.sharding import Mesh, make_rules, param_sharding


def reshard_state(state, axes_tree, new_mesh: Mesh, *, fsdp=False):
    """Lay a state tree (tensors, or ``Placed`` leaves from another mesh,
    gathered first) onto ``new_mesh`` per its logical axes under
    ``make_rules(new_mesh, fsdp=)`` -> a tree of ``Placed`` whose blocks
    are copies, one a shard."""
    rules = make_rules(new_mesh, fsdp=fsdp)
    with shd.axis_rules(rules):
        shardings = param_sharding(axes_tree, new_mesh)
    return shd.place_tree(shd.gather_tree(state), shardings)


def largest_feasible_mesh(devices, *, model_divisors, prefer_model=None):
    """Choose (data, model) from a (possibly degraded) device list: model
    must divide the head and expert counts (callers pass the divisor
    set), data gets the rest -> a ``Mesh`` or None."""
    n = len(devices)
    candidates = sorted(model_divisors, reverse=True)
    if prefer_model in model_divisors:
        candidates = [prefer_model] + [c for c in candidates
                                       if c != prefer_model]
    for m in candidates:
        if n % m == 0 and n // m >= 1:
            arr = np.empty(n, dtype=object)
            for i, d in enumerate(devices[: (n // m) * m]):
                arr[i] = d
            return Mesh(arr.reshape(n // m, m), ("data", "model"))
    return None
