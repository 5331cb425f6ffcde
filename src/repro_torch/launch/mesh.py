"""Meshes for the port's sharded paths.

Port of ``repro.launch.mesh``'s test and sessions meshes.  The
reference builds its meshes over ``jax.devices()``; here each builder
takes an explicit ``devices=`` list, which may name one device more
than once (S logical shards on one card, the counterpart of the
reference's forced host devices), and otherwise takes the visible CUDA
devices.  A CUDA device that is not there raises: nothing falls back to
fewer shards or to the CPU.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.distributed.sharding import SESSIONS_AXIS, Mesh


def _devices(n, devices):
    """``devices`` checked (every CUDA index visible), or the first
    ``n`` visible CUDA devices -> a list of ``n`` ``torch.device``s."""
    if devices is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
        if count == 0:
            raise RuntimeError("no CUDA device is visible: pass devices= "
                               "(e.g. ['cpu'] * n) for a mesh elsewhere")
        if n is None:
            n = count
        if n > count:
            raise RuntimeError(f"a mesh of {n} devices over {count} visible "
                               "CUDA devices: pass devices= to repeat one")
        return [torch.device("cuda", i) for i in range(n)]
    out = []
    for d in devices:
        d = torch.device(d)
        if d.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(f"mesh device {d}: torch sees no CUDA "
                                   "device")
            if d.index is None:
                d = torch.device("cuda", torch.cuda.current_device())
            if d.index >= torch.cuda.device_count():
                raise RuntimeError(f"mesh device {d}: only "
                                   f"{torch.cuda.device_count()} CUDA "
                                   "devices are visible")
        elif d.type != "cpu":
            raise ValueError(f"unsupported mesh device {d}")
        out.append(d)
    if n is not None and len(out) != n:
        raise ValueError(f"{len(out)} devices for a mesh of {n}")
    return out


def make_test_mesh(shape=(2, 2), axes=("data", "model"), *, devices=None):
    """A mesh of ``shape`` with axis names ``axes`` over ``devices`` (in
    row-major order; default the first prod(shape) CUDA devices)."""
    n = math.prod(shape)
    arr = np.empty(n, dtype=object)
    for i, d in enumerate(_devices(n, devices)):
        arr[i] = d
    return Mesh(arr.reshape(shape), axes)


def make_sessions_mesh(n_shards=None, *, axis=None, devices=None):
    """The 1-D mesh ``ShardedFleetBackend`` shards its rings over:
    ``n_shards`` shards (default: one per device) along ``axis``
    (default ``SESSIONS_AXIS``) over ``devices`` (default the visible
    CUDA devices)."""
    devs = _devices(n_shards, devices)
    return make_test_mesh((len(devs),), (axis or SESSIONS_AXIS,),
                          devices=devs)


__all__ = ["make_test_mesh", "make_sessions_mesh"]
