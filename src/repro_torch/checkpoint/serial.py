"""State tree <-> npz serialization.

Port of ``repro.checkpoint.serial``.  A state tree is nested dicts (keys
in sorted order), lists and tuples over tensors or numpy arrays.  Each
leaf is stored under its tree path, the keys and indices joined by
``/``: the names the reference's ``_paths`` gives the same tree (JAX's
flatten sorts dict keys too), so a checkpoint the reference's
``CheckpointManager`` wrote restores into the port and back.
"""
from __future__ import annotations

import os

import numpy as np
import torch


def _paths(tree, prefix=()):
    """-> [(path, leaf)] in the reference's flatten order."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _paths(tree[k], prefix + (str(k),))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree)
                for kv in _paths(v, prefix + (str(i),))]
    return [("/".join(prefix), tree)]


def _to_numpy(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def save_tree(path, tree):
    """Write every leaf of ``tree`` (tensors are copied to the host) to the
    npz file ``path``, atomically (a temporary name, then
    ``os.replace``)."""
    arrs = {k: _to_numpy(v) for k, v in _paths(tree)}
    tmp = path + ".tmp.npz"
    np.savez(tmp, **arrs)
    os.replace(tmp, path)


def load_tree(path, template):
    """Restore into the structure of ``template``: each leaf from the
    entry of its path, as a tensor of the template leaf's dtype on its
    device."""
    with np.load(path) as data:
        def rec(t, prefix):
            if isinstance(t, dict):
                return {k: rec(t[k], prefix + (str(k),)) for k in t}
            if isinstance(t, (list, tuple)):
                return type(t)(rec(v, prefix + (str(i),))
                               for i, v in enumerate(t))
            arr = torch.from_numpy(np.array(data["/".join(prefix)]))
            if isinstance(t, torch.Tensor):
                arr = arr.to(dtype=t.dtype, device=t.device)
            return arr
        return rec(template, ())
