"""The multi-process job the port's collectives cross.

The reference joins a job with ``jax.distributed.initialize`` and then
runs JAX's multi-controller model: every process runs the same program
on the same host inputs and holds only its own shards of a mesh that
spans the job.  ``launch.mesh.maybe_init_distributed`` joins the port's
counterpart and records it here as a ``Job``: this process's rank, the
world size, the gloo group the collectives use, and an NCCL group where
every rank owns cards of its own.

``exchange`` is the one transfer every cross-process collective of
``distributed.sharding`` is built on.  Each process hands it the values
of its own shards, and gets every shard's value back, each process's in
shard order, so that every process can fold them in the fixed global
shard order that one process holding every shard uses.  One flat byte
buffer a process is all-gathered: a header (a sequence number, the
collective's kind, the shard count, the payload's size and the shards'
shapes and types, as checksums) and each shard's tensors, raw.  Every
process checks every header against its own, so processes that call the
collectives in different orders fail at the first call that differs
instead of mixing payloads; a process that does not call at all fails
the others at the group's timeout.

Each tensor travels in the order of its memory (a transposed gradient
as it lies) with its dims' order, and is rebuilt with the sender's
layout: an elementwise sum or a reduction over it then runs in the
sender's order, as one process holding every shard would run it.

Over gloo a CUDA payload stages through pinned host memory: one
device->host copy of this process's shards before the transfer, one
host->device copy of the gathered buffer after.  ``Job.staged`` counts
those bytes and the exchanges' host time, apart from
``sharding.count_collectives`` (which counts a collective as one process
holding every shard would).
"""
from __future__ import annotations

import threading
import time
import zlib
from dataclasses import dataclass, field

import torch

_MAGIC = 0x5EED0C01
_HEADER = 64         # eight int64 words, the first six used
_ALIGN = 16          # every tensor's bytes start on a 16-byte boundary


@dataclass
class Job:
    """A joined job: ``rank`` of ``world`` processes.  ``group`` is the
    gloo group that carries the collectives (None: the default group),
    ``nccl`` an NCCL group that carries CUDA payloads instead, or None.
    ``staged`` counts the exchanges: ``calls``, ``d2h_bytes`` and
    ``h2d_bytes`` (the pinned staging copies over gloo), ``wire_bytes``
    (the bytes gathered into this process) and ``ms`` (host time)."""

    rank: int
    world: int
    group: object = None
    nccl: object = None
    seq: int = 0
    staged: dict = field(default_factory=lambda: {
        "calls": 0, "d2h_bytes": 0, "h2d_bytes": 0, "wire_bytes": 0,
        "ms": 0.0})
    lock: object = field(default_factory=threading.Lock, repr=False)


# the job this process joined (one a process, as torch.distributed's own
# default group)
_JOB = {"job": None}


def current_job():
    """The job this process joined, or None."""
    return _JOB["job"]


def set_job(job):
    """Record ``job`` as this process's (None: none) -> the previous."""
    prev, _JOB["job"] = _JOB["job"], job
    return prev


def rank() -> int:
    """This process's rank (0 outside a job)."""
    job = _JOB["job"]
    return 0 if job is None else job.rank


def leaves(tree) -> list:
    """The tensors of a dict/list/tuple tree, dicts in insertion order
    (the order ``sharding``'s tree maps walk)."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    if not isinstance(tree, torch.Tensor):
        raise TypeError(f"a collective takes tensors, not {type(tree)}")
    return [tree]


def rebuild(tree, new):
    """``tree`` with its tensors replaced, in ``leaves`` order, by
    ``new``."""
    it = iter(new)

    def rec(t):
        if isinstance(t, dict):
            return {k: rec(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(rec(v) for v in t)
        return next(it)
    return rec(tree)


def _code(text) -> int:
    return zlib.crc32(str(text).encode())


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _padded(n) -> int:
    return -(-n // _ALIGN) * _ALIGN


def _order(x) -> list:
    """The dims of ``x`` from outermost to innermost in memory, where
    ``x`` is dense in some order of its dims (a transposed or permuted
    tensor), else in index order."""
    perm = sorted(range(x.dim()), key=lambda d: (-x.stride(d), d))
    return perm if x.permute(perm).is_contiguous() else list(range(x.dim()))


def exchange(trees, owners, kind) -> list:
    """Every shard's value on every process of the job.

    ``trees`` are this process's shards' values (tensor trees of one
    structure, shapes and types, on this process's devices), ``owners``
    the rank owning each global shard, in global order, and ``kind`` the
    collective's name.  -> the values of every global shard, in global
    order: this process's own ``trees`` as given, the others' new
    tensors on the device of this process's first value."""
    job = _JOB["job"]
    trees = list(trees)
    counts = [0] * job.world
    for r in owners:
        counts[r] += 1
    k = len(trees)
    if counts[job.rank] != k or not k:
        raise ValueError(f"{kind}: {k} local shard values where the layout "
                         f"gives rank {job.rank} {counts[job.rank]}")
    flat = [leaves(t) for t in trees]
    # each value's tensors' dims in memory order, sent as one more tensor
    flat = [lv + [torch.tensor([d for x in lv for d in _order(x)],
                               dtype=torch.int64)] for lv in flat]
    specs = [(tuple(x.shape), x.dtype) for x in flat[0]]
    for lv in flat[1:]:
        if [(tuple(x.shape), x.dtype) for x in lv] != specs:
            raise ValueError(f"{kind}: the shards' values differ in "
                             "structure, shape or type")
    offs, per = [], 0
    for shape, dtype in specs:
        offs.append(per)
        per += _padded(torch.Size(shape).numel()
                       * torch.empty((), dtype=dtype).element_size())
    dev = flat[0][0].device if flat[0] else torch.device("cpu")
    size = _HEADER + max(counts) * per
    on_card = dev.type == "cuda"
    nccl = on_card and job.nccl is not None
    start = time.perf_counter()
    with job.lock:
        job.seq += 1
        head = torch.tensor([_MAGIC, job.seq, _code(kind), k, per,
                             _code(specs), 0, 0], dtype=torch.int64)
        payload = torch.empty(k * per, dtype=torch.uint8,
                              device=dev if on_card else "cpu")
        for j, lv in enumerate(flat):
            orders = lv[-1].tolist() + [0]
            for x, off in zip(lv, offs):
                n = _nbytes(x)
                perm, orders = orders[:x.dim()], orders[x.dim():]
                payload[j * per + off:j * per + off + n].copy_(
                    x.detach().to(dev).permute(perm).reshape(-1)
                    .view(torch.uint8))
        buf = torch.zeros(size, dtype=torch.uint8,
                          device=dev if nccl else "cpu",
                          pin_memory=on_card and not nccl)
        buf[:_HEADER].copy_(head.view(torch.uint8))
        buf[_HEADER:_HEADER + k * per].copy_(payload)
        out = torch.empty(job.world * size, dtype=buf.dtype,
                          device=buf.device, pin_memory=on_card and not nccl)
        import torch.distributed as dist
        if nccl:
            dist.all_gather_into_tensor(out, buf, group=job.nccl)
        else:
            dist.all_gather(list(out.chunk(job.world)), buf, group=job.group)
        heads = out.view(job.world, size)[:, :_HEADER].cpu().view(
            torch.int64)
        for r in range(job.world):
            want = head.clone()
            want[3] = counts[r]
            if not torch.equal(heads[r], want):
                raise RuntimeError(
                    f"collective {job.seq} ({kind}) differs across the "
                    f"job's processes: rank {r} sent header "
                    f"{heads[r].tolist()}, rank {job.rank} expected "
                    f"{want.tolist()} (every process must call the same "
                    "collectives in the same order on the same layout)")
        # every value's dims in memory order (the last tensor of each),
        # read where the gathered buffer lies before it moves
        last = offs[-1]
        orders = {(r, j): out[r * size + _HEADER + j * per + last:
                              r * size + _HEADER + j * per + last
                              + _nbytes(flat[0][-1])].view(torch.int64)
                  .tolist() for r in range(job.world)
                  for j in range(counts[r]) if r != job.rank}
        if on_card and not nccl:
            job.staged["d2h_bytes"] += k * per
            job.staged["h2d_bytes"] += out.numel()
            out = out.to(dev, non_blocking=True)
        job.staged["calls"] += 1
        job.staged["wire_bytes"] += job.world * size
        job.staged["ms"] += (time.perf_counter() - start) * 1e3
    mine = iter(trees)
    taken = [0] * job.world
    result = []
    for r in owners:
        j, taken[r] = taken[r], taken[r] + 1
        if r == job.rank:
            result.append(next(mine))
            continue
        base = r * size + _HEADER + j * per
        got = [out[base + off:base + off + _nbytes(x)].view(x.dtype)
               for x, off in zip(flat[0][:-1], offs)]
        order, new = orders[r, j], []
        for x, t in zip(flat[0][:-1], got):
            perm, order = order[:x.dim()], order[x.dim():]
            new.append(t.view([x.shape[d] for d in perm]).permute(
                sorted(range(x.dim()), key=perm.__getitem__)))
        result.append(rebuild(trees[0], new))
    return result


__all__ = ["Job", "current_job", "set_job", "rank", "leaves", "rebuild",
           "exchange"]
