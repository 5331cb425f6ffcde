"""Meshes for the port's sharded paths, and the multi-process on-ramp.

Port of ``repro.launch.mesh``: the production, test and sessions meshes
and ``maybe_init_distributed``.  After ``maybe_init_distributed`` joined
a job of several processes, ``make_sessions_mesh()`` spans the job: each
process contributes its devices, in rank order, and owns their shards
(``Mesh.process_ids``), and the collectives of ``distributed.sharding``
cross processes (``distributed.job``).  The reference builds its meshes over
``jax.devices()``; here each builder
takes an explicit ``devices=`` list, which may name one device more
than once (S logical shards on one card, the counterpart of the
reference's forced host devices), and otherwise takes the visible CUDA
devices.  A CUDA device that is not there raises: nothing falls back to
fewer shards or to the CPU.  ``devices=["meta"] * 256`` (512 with
``multi_pod``) asks by name for the production mesh of shapes only, on
which ``launch/dryrun.py`` traces a step: the counterpart of the
reference's 512 forced host devices.
"""
from __future__ import annotations

import datetime
import math
import os
import socket

import numpy as np
import torch

from repro_torch.distributed.job import Job, current_job, set_job
from repro_torch.distributed.sharding import SESSIONS_AXIS, Mesh

# how long a rank waits to join, and a collective for every rank
TIMEOUT_S = 120.0


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
        elif d.type not in ("cpu", "meta"):
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
    CUDA devices).

    In a joined job of several processes every process calls it and the
    mesh spans the job: each process contributes ``devices`` (default its
    visible CUDA devices; ``n_shards`` counts the whole job's shards and
    must split evenly over the processes), in rank order, and owns their
    shards."""
    job = current_job()
    if job is None or job.world == 1:
        devs = _devices(n_shards, devices)
        return make_test_mesh((len(devs),), (axis or SESSIONS_AXIS,),
                              devices=devs)
    if n_shards is not None and n_shards % job.world:
        raise ValueError(f"{n_shards} session shards do not split over "
                         f"{job.world} processes")
    devs = _devices(None if n_shards is None else n_shards // job.world,
                    devices)
    import torch.distributed as dist
    everyone = [None] * job.world
    dist.all_gather_object(everyone, [str(d) for d in devs],
                           group=job.group)
    flat = np.empty(sum(map(len, everyone)), dtype=object)
    for i, d in enumerate(d for ds in everyone for d in ds):
        flat[i] = torch.device(d)
    owners = [r for r, ds in enumerate(everyone) for _ in ds]
    return Mesh(flat, (axis or SESSIONS_AXIS,), process_ids=owners)


def make_production_mesh(*, multi_pod: bool = False, devices=None):
    """16x16 ``("data", "model")``, or 2x16x16 ``("pod", "data",
    "model")`` with ``multi_pod``, over ``devices`` (default the first
    256 or 512 visible CUDA devices; fewer raise)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_test_mesh(shape, axes, devices=devices)


# process-level latch: the process group may be joined at most once
_distributed = {"initialized": False}


def cards() -> tuple:
    """This process's host name and the UUIDs of its visible CUDA
    devices."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return socket.gethostname(), [
        str(torch.cuda.get_device_properties(i).uuid) for i in range(n)]


def data_backend(places) -> str:
    """The backend for the collectives' payloads, from every rank's
    ``cards()``: ``"nccl"`` when every rank owns cards that no other rank
    sees, else ``"gloo"`` (NCCL refuses two ranks on one device, so ranks
    that share a card stage through host memory)."""
    seen = set()
    for host, uuids in places:
        if not uuids or seen & {(host, u) for u in uuids}:
            return "gloo"
        seen |= {(host, u) for u in uuids}
    return "nccl"


def _init_process_group(*, coordinator_address, num_processes, process_id,
                        dist=None):
    """Join ``torch.distributed`` at ``tcp://coordinator_address`` with an
    explicit world size and rank, over gloo, with ``TIMEOUT_S`` for the
    join and every collective; then exchange every rank's ``cards()`` and
    add an NCCL group for CUDA payloads only where ``data_backend`` allows
    one -> the ``Job``, recorded for the collectives.  A rank that cannot
    join raises; nothing retries on another backend.  ``dist`` is a seam
    for tests (default ``torch.distributed``)."""
    if dist is None:
        import torch.distributed as dist
    timeout = datetime.timedelta(seconds=TIMEOUT_S)
    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id, timeout=timeout)
    places = [None] * num_processes
    dist.all_gather_object(places, cards())
    nccl = None
    if num_processes > 1 and data_backend(places) == "nccl":
        nccl = dist.new_group(backend="nccl", timeout=timeout)
    job = Job(rank=process_id, world=num_processes, nccl=nccl)
    set_job(job)
    return job


def maybe_init_distributed(*, env=None, initialize=None) -> bool:
    """Join a multi-process job from the launcher environment, or no-op in
    a plain single-process run.

    Environment contract (the coordinator's presence turns this on)::

        REPRO_COORDINATOR    host:port of process 0's rendezvous
        REPRO_NUM_PROCESSES  total process count           (default 1)
        REPRO_PROCESS_ID     this process's index           (default 0)

    Returns True when the process joined (or had already joined) a job,
    False for the single-process no-op; idempotent per process.
    ``env``/``initialize`` are injection seams for tests (default
    ``os.environ`` and ``_init_process_group``: gloo at ``tcp://`` the
    coordinator, an NCCL group only for ranks on distinct cards, the
    ``Job`` recorded for the collectives), called as ``initialize(
    coordinator_address=, num_processes=, process_id=)``."""
    env = os.environ if env is None else env
    coordinator = env.get("REPRO_COORDINATOR")
    if not coordinator:
        return False
    if _distributed["initialized"]:
        return True
    n_proc = int(env.get("REPRO_NUM_PROCESSES", "1"))
    proc_id = int(env.get("REPRO_PROCESS_ID", "0"))
    if not 0 <= proc_id < n_proc:
        raise ValueError(
            f"REPRO_PROCESS_ID={proc_id} out of range for "
            f"REPRO_NUM_PROCESSES={n_proc}")
    init = _init_process_group if initialize is None else initialize
    init(coordinator_address=coordinator, num_processes=n_proc,
         process_id=proc_id)
    _distributed["initialized"] = True
    return True


__all__ = ["make_test_mesh", "make_sessions_mesh", "make_production_mesh",
           "maybe_init_distributed", "cards", "data_backend", "TIMEOUT_S"]
