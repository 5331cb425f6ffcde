"""Sharding over a mesh of devices: the reference's logical-axis rules
for the LM, the sessions mesh of the fleet data plane, where a global
value's blocks live, and the collectives the reference's ``shard_map``
code calls.

Port of ``repro.distributed.sharding``.  The reference runs one program
per device (GSPMD, or ``shard_map``); the port runs one program per
process and holds one value per shard of that process, in shard order.
A mesh is an ordered array of ``torch.device``s with named axes, and a
device may appear more than once: S logical shards on one card are the
counterpart of the reference's forced host devices on one CPU.  In a
job of several processes (``launch.mesh.maybe_init_distributed``) a mesh
also records which process owns each shard (``Mesh.process_ids``).

Logical axes: model code names each dim of a parameter or activation
("batch", "heads", "mlp", ...); a rule set (``AxisRules``, installed with
``axis_rules``) maps each name to a mesh axis, a tuple of them, or None.
``make_rules`` and ``rules_for`` build the reference's standard sets,
entry for entry.  A ``PartitionSpec`` is a tuple of those entries, one a
dim.  ``shard_slices`` gives the block of a global tensor each shard holds
under a spec, ``Placed`` is a global tensor held as those blocks, and
``shard`` re-lays a value to the spec its logical axes give (the
counterpart of ``with_sharding_constraint``); outside any rules every
annotation is a no-op.

Collectives take the shards' values as a sequence, in shard order (a
tensor, or a dict/list/tuple tree of tensors, per shard), and return a
``PerShard`` list with one result per shard, each on that shard's
device.  Each reduction runs once, on the first shard's device, in
fixed shard order (``x0 + x1 + ...``), with no atomics, so it gives the
same bits on every run; at one shard each collective returns its input
unchanged.  The collectives carry autograd like any other tensor
arithmetic: a result's gradient reaches every shard's input.
``psum_over`` and the other ``*_over`` forms run a collective within each
group of shards that differ only along the named mesh axes (a flat list
of every shard's value, in the mesh's row-major order).
``fsdp_gather_over`` is the all-gather FSDP rules need: its backward is
the reduce-scatter (the group's gradients summed in shard order, each
shard taking its block's slice), so each block's gradient comes back to
the shard that holds it.

Across processes (a joined job, ``distributed.job``), every process runs
the same program on the same host inputs, as JAX's multi-controller
model does.  A collective then takes the values of this process's
shards, in global shard order, and returns this process's shards'
results: the plain forms over every process's shards in rank order
(each process holding as many), the ``*_over`` forms and
``fsdp_gather_over`` over the shards of a mesh whose ``process_ids``
name more than one process.  Each gathers every shard's value to every
process (``job.exchange``) and runs the one-process collective on them,
so every result equals bitwise what one process holding every shard
returns at those shards.  An ``*_over`` form whose groups each lie
within one process (``Mesh.crosses``, decided from the mesh alone, so
every process decides alike) runs this process's groups where they are
and exchanges nothing.  Autograd through a collective that crosses
gathers every shard's output gradient likewise and replays the
one-process collective's backward on them, accumulating the shards'
gradients as one process's engine does for a program built shard by
shard (the last shard's first); so each shard's gradient reaches the
process that owns it, and a backward through a collective must run on
every process.  For that, each shard's result is a node of its own (a
view where the shards share a device), so its uses' gradients are summed
per shard before they reach the reduced value; and an output gradient
that is all zeros counts as none, so a process that seeds its copy of a
replicated loss with 0 (``runtime/trainer``) adds nothing.  On such a
mesh a ``Placed`` holds this process's blocks only, and its ``gather``
assembles the whole tensor on every process.

``count_collectives()`` counts the collectives run inside it: a dict of
``collective_bytes`` and, by kind (the reference's names: all-reduce,
all-gather, reduce-scatter, all-to-all, collective-permute),
``per_kind_bytes`` and ``per_kind_counts``, the counterpart of the
reference's ``hlo_analysis.summarize``.  A call counts once (an ``_over``
form's groups run one collective each, as one HLO instruction runs on
every device) with the bytes of one shard's result, as the reference
counts an instruction's result shape on one device; a collective over one
shard moves nothing and is not counted.  A collective across processes
counts as the same collective in one process would; its exchange's
staging is counted apart (``Job.staged``).  The backward of ``all_gather``,
``all_to_all`` and ``ppermute``, which autograd takes through the copies,
is not counted (the reference's HLO holds it); FSDP's reduce-scatter is.
Outside the context nothing is recorded.
"""
from __future__ import annotations

import itertools
import math
import threading
from contextlib import contextmanager

import numpy as np
import torch

from repro_torch.distributed import job as _job

# The mesh axis the fleet data plane shards the session dimension over:
# every (N, W, d) ring, its timestamp and label rings and the per-session
# masks are split on dim 0.
SESSIONS_AXIS = "sessions"


class PerShard(list):
    """One value per shard of a mesh axis, in shard order (what the
    collectives return, and what the port's ``axis_name`` forms take
    where the reference takes each shard's local value)."""


class Mesh:
    """An n-d array of ``torch.device``s with one name per axis.

    ``shape`` maps each axis name to its size, as the reference's
    ``Mesh.shape`` does; ``devices`` is the object array itself.
    ``process_ids`` (an int array of the devices' shape, default all
    zeros) names the process of a joined job that owns each shard; a
    device of another process means that process's device there."""

    def __init__(self, devices, axis_names, process_ids=None):
        arr = np.empty(np.shape(devices), dtype=object)
        flat = [torch.device(d) for d in np.asarray(devices,
                                                    dtype=object).flat]
        for i, d in enumerate(flat):
            arr.flat[i] = d
        if arr.ndim != len(axis_names):
            raise ValueError(f"{arr.ndim}-d device array for axes "
                             f"{tuple(axis_names)}")
        if not arr.size:
            raise ValueError("a mesh needs at least one device")
        self.devices = arr
        self.axis_names = tuple(axis_names)
        ids = np.zeros(arr.shape, np.int64) if process_ids is None \
            else np.asarray(process_ids, np.int64)
        if ids.shape != arr.shape:
            raise ValueError(f"process_ids {ids.shape} for devices "
                             f"{arr.shape}")
        self.process_ids = ids

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def spans(self) -> bool:
        """Whether the shards belong to more than one process."""
        return len(np.unique(self.process_ids)) > 1

    def _along(self, arr, axis) -> list:
        i = self.axis_names.index(axis)
        idx = tuple(slice(None) if j == i else 0
                    for j in range(len(self.axis_names)))
        return list(arr[idx])

    def axis_devices(self, axis) -> list:
        """The devices along ``axis`` at index 0 of every other axis."""
        return self._along(self.devices, axis)

    def axis_process_ids(self, axis) -> list:
        """The owning process of each of ``axis_devices(axis)``."""
        return [int(p) for p in self._along(self.process_ids, axis)]

    def axis_local(self, axis) -> list:
        """The indices along ``axis`` (at index 0 of every other axis) of
        the shards this process owns."""
        me = _job.rank()
        return [i for i, p in enumerate(self.axis_process_ids(axis))
                if p == me]

    def local(self) -> list:
        """The global (row-major) indices of the shards this process
        owns, in order: every shard outside a joined job."""
        me = _job.rank()
        return [i for i, p in enumerate(self.process_ids.flat) if p == me]

    def crosses(self, axes) -> bool:
        """Whether a group of ``axis_groups(self, axes)`` holds shards of
        more than one process (decided from the mesh alone, so every
        process decides alike)."""
        if not self.spans:
            return False
        ids = self.process_ids.reshape(-1)
        return any(len({int(ids[i]) for i in g}) > 1
                   for g in axis_groups(self, axes))

    def __repr__(self):
        return f"Mesh({self.shape}, {list(self.devices.flat)})"


def row_blocks(n_rows: int, shards: int) -> list:
    """The contiguous block of rows each of ``shards`` shards owns:
    shard s holds rows ``[s * n/S, (s + 1) * n/S)`` -> S slices."""
    if n_rows % shards:
        raise ValueError(f"{n_rows} rows do not split evenly over "
                         f"{shards} shards")
    per = n_rows // shards
    return [slice(s * per, (s + 1) * per) for s in range(shards)]


def sessions_sharding(mesh: Mesh, n_rows: int,
                      axis: str = SESSIONS_AXIS) -> list:
    """Where fleet state of ``n_rows`` rows lives on ``mesh``: dim 0 (the
    session axis) split over ``axis``, every trailing dim (window, embed)
    whole on each shard -> one ``(device, row slice)`` per shard, in
    shard order."""
    return list(zip(mesh.axis_devices(axis),
                    row_blocks(n_rows, mesh.shape[axis])))


# -- collectives -------------------------------------------------------------

# the record ``count_collectives`` counts into (None: not counting).  Not
# thread-local: autograd may run a backward (the FSDP reduce-scatter) on a
# thread of its own.
_COUNT = {"rec": None}


@contextmanager
def count_collectives():
    """Count the collectives run in the ``with`` block -> the dict they are
    counted into (``collective_bytes``, ``per_kind_bytes``,
    ``per_kind_counts``)."""
    prev = _COUNT["rec"]
    rec = {"collective_bytes": 0, "per_kind_bytes": {},
           "per_kind_counts": {}}
    _COUNT["rec"] = rec
    try:
        yield rec
    finally:
        _COUNT["rec"] = prev


def _nbytes(tree) -> int:
    """The bytes of the tensors of a tree (dicts, lists, tuples)."""
    if isinstance(tree, dict):
        return sum(_nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_nbytes(v) for v in tree)
    return tree.numel() * tree.element_size() \
        if isinstance(tree, torch.Tensor) else 0


def _tally(kind, shards, nbytes):
    """Count one collective of ``kind`` over ``shards`` shards whose result
    on one shard is ``nbytes()`` bytes.  Called only while counting."""
    if shards < 2:
        return
    rec, n = _COUNT["rec"], int(nbytes())
    rec["collective_bytes"] += n
    rec["per_kind_bytes"][kind] = rec["per_kind_bytes"].get(kind, 0) + n
    rec["per_kind_counts"][kind] = rec["per_kind_counts"].get(kind, 0) + 1


def _tree_map(fn, *trees):
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, (list, tuple)) and not isinstance(t0, PerShard):
        return type(t0)(_tree_map(fn, *parts) for parts in zip(*trees))
    return fn(*trees)


def _own(a, x):
    """``a`` on ``x``'s device as a node of its own (a view where the
    device is the same): each shard's result takes its own gradient, which
    reaches ``a`` once the shard's uses of it are summed, whatever the
    shards' devices."""
    return a.to(x.device) if a.device != x.device else a.view_as(a)


def _reduce(xs, op):
    """``op`` folded over the shards' values in shard order on the first
    shard's device -> one result per shard, on its own device."""
    xs = list(xs)
    if not xs:
        raise ValueError("a collective needs at least one shard")
    if len(xs) == 1:
        return PerShard(xs)

    def leaf(*vals):
        acc = vals[0]
        for v in vals[1:]:
            acc = op(acc, v.to(acc.device))
        return acc
    total = _tree_map(leaf, *xs)
    return PerShard(_tree_map(_own, total, x) for x in xs)


# -- across processes --------------------------------------------------------

# set on a thread while it runs a spanned collective's one-process form
_LOCAL = threading.local()


def _cross() -> bool:
    """Whether the plain collectives cross processes: in a job of several
    processes, outside the one-process run of a spanned collective."""
    job = _job.current_job()
    return (job is not None and job.world > 1
            and not getattr(_LOCAL, "on", False))


def _mesh_cross(mesh) -> bool:
    """Whether a collective over ``mesh``'s groups crosses processes."""
    return mesh.spans and not getattr(_LOCAL, "on", False)


def _owners(k) -> list:
    """The plain forms' layout: every process holds ``k`` shards, in rank
    order -> the rank of each global shard."""
    return [r for r in range(_job.current_job().world) for _ in range(k)]


@contextmanager
def _one_process(count=True):
    """Run collectives as one process holding every shard (counted
    unless ``count`` is False)."""
    on, rec = getattr(_LOCAL, "on", False), _COUNT["rec"]
    _LOCAL.on = True
    if not count:
        _COUNT["rec"] = None
    try:
        yield
    finally:
        _LOCAL.on, _COUNT["rec"] = on, rec


class _Plan:
    """What a spanned collective's autograd node keeps: the one-process
    collective, the layout, and the trees' structure."""

    def __init__(self, run, xs, owners, kind):
        me = _job.rank()
        self.run, self.owners, self.kind = run, owners, kind
        self.mine = [i for i, r in enumerate(owners) if r == me]
        self.in_tree, self.k = xs[0], len(xs)
        self.out_tree = None


def _split(flat, tree, k) -> list:
    n = len(flat) // k
    return [_job.rebuild(tree, flat[s * n:(s + 1) * n]) for s in range(k)]


class _Spanned(torch.autograd.Function):
    """A collective across processes under autograd: the forward gathers
    every shard's value and runs the one-process collective; the backward
    gathers every shard's output gradient, replays the one-process
    collective on the gathered inputs, and takes this process's inputs'
    gradients of ``sum_s <out_s, grad_s>`` (built shard by shard, so the
    engine accumulates the shards' terms as it does for one process)."""

    @staticmethod
    def forward(ctx, plan, *flat):
        xs = _split(flat, plan.in_tree, plan.k)
        glob = _job.exchange(xs, plan.owners, plan.kind)
        with _one_process():
            outs = plan.run(glob)
        local = [outs[i] for i in plan.mine]
        plan.out_tree = local[0]
        res, seen = [], {id(t) for t in flat}
        for o in local:
            for t in _job.leaves(o):
                if id(t) in seen:            # an output aliasing another
                    t = t.clone()
                seen.add(id(t))
                res.append(t)
        ctx.plan = plan
        ctx.glob = [_tree_map(lambda t: t.detach(), g) for g in glob]
        ctx.mark_non_differentiable(*[t for t in res
                                      if not t.is_floating_point()])
        return tuple(res)

    @staticmethod
    def backward(ctx, *grads):
        plan = ctx.plan
        like = _job.leaves(plan.out_tree)
        n = len(like)
        cots = []
        for s in range(plan.k):
            g = grads[s * n:(s + 1) * n]
            # an output with no gradient, or an all-zero one (a process
            # that seeds its copy of a replicated loss with 0), adds no
            # term: one process differentiates only the copy it returns
            none = torch.zeros((), dtype=torch.bool, device=like[0].device)
            have = torch.stack([none if x is None else x.ne(0).any()
                                for x in g]).to(torch.uint8)
            cots.append([x if x is not None else torch.zeros_like(t)
                         for x, t in zip(g, like)] + [have])
        gathered = _job.exchange(cots, plan.owners,
                                 plan.kind + " (backward)")
        ins = [[t.detach().requires_grad_(t.is_floating_point())
                for t in _job.leaves(x)] for x in ctx.glob]
        want = [t for i in plan.mine for t in ins[i]]
        with torch.enable_grad():
            with _one_process(count=False):
                outs = plan.run([_job.rebuild(x, lv)
                                 for x, lv in zip(ctx.glob, ins)])
            terms = []
            for o, c in zip(outs, gathered):
                for t, ct, h in zip(_job.leaves(o), c[:-1], c[-1].tolist()):
                    if h and t.requires_grad:
                        terms.append((t * ct).sum())
            if not terms:
                return (None,) * (1 + len(want))
            total = terms[0]
            for t in terms[1:]:
                total = total + t
            # every shard's inputs, so every group's backward runs (and
            # FSDP's reduce-scatter is counted as in one process)
            need = [t for lv in ins for t in lv if t.requires_grad]
            with _one_process():
                got = dict(zip(map(id, need), torch.autograd.grad(
                    total, need, allow_unused=True)))
        return (None,) + tuple(got.get(id(t)) for t in want)


def _span(run, xs, owners, kind):
    """``run`` (a one-process collective, over every global shard's value
    in global order) across the job: ``xs`` are this process's shards'
    values, ``owners`` the rank owning each global shard -> this
    process's shards' results (``PerShard``)."""
    xs = list(xs)
    flat = [t for x in xs for t in _job.leaves(x)]
    plan = _Plan(run, xs, owners, kind)
    if torch.is_grad_enabled() and any(t.requires_grad for t in flat):
        return PerShard(_split(_Spanned.apply(plan, *flat), plan.out_tree,
                               plan.k))
    glob = _job.exchange(xs, owners, kind)
    with _one_process():
        outs = run(glob)
    return PerShard(outs[i] for i in plan.mine)


def psum(xs, axis_name=None):
    """Sum over the shards (``jax.lax.psum``)."""
    if _cross():
        xs = list(xs)
        return _span(psum, xs, _owners(len(xs)), "psum")
    if _COUNT["rec"] is not None:
        xs = list(xs)
        _tally("all-reduce", len(xs), lambda: _nbytes(xs[0]))
    return _reduce(xs, torch.add)


def pmax(xs, axis_name=None):
    """Elementwise maximum over the shards (``jax.lax.pmax``)."""
    if _cross():
        xs = list(xs)
        return _span(pmax, xs, _owners(len(xs)), "pmax")
    if _COUNT["rec"] is not None:
        xs = list(xs)
        _tally("all-reduce", len(xs), lambda: _nbytes(xs[0]))
    return _reduce(xs, torch.maximum)


def pmean(xs, axis_name=None):
    """``psum`` divided by the shard count (``jax.lax.pmean``)."""
    xs = list(xs)
    if _cross():
        return _span(pmean, xs, _owners(len(xs)), "pmean")
    if len(xs) == 1:
        return PerShard(xs)
    n = len(xs)
    if _COUNT["rec"] is not None:
        _tally("all-reduce", n, lambda: _nbytes(xs[0]))
    return PerShard(_tree_map(lambda t: t / n, s)
                    for s in _reduce(xs, torch.add))


def ppermute(xs, perm, axis_name=None):
    """Send shard ``src``'s value to shard ``dst`` for each ``(src, dst)``
    of ``perm``; a shard no pair sends to gets zeros
    (``jax.lax.ppermute``)."""
    xs = list(xs)
    if _cross():
        return _span(lambda g: ppermute(g, perm), xs, _owners(len(xs)),
                     "ppermute")
    dsts = [d for _, d in perm]
    if len(set(dsts)) != len(dsts):
        raise ValueError(f"ppermute {perm}: a shard receives twice")
    if _COUNT["rec"] is not None:
        _tally("collective-permute", len(xs), lambda: _nbytes(xs[0]))
    out = PerShard(_tree_map(torch.zeros_like, x) for x in xs)
    for src, dst in perm:
        out[dst] = _tree_map(lambda a, x: a.to(x.device), xs[src], xs[dst])
    return out


def all_gather(xs, axis=0, *, tiled=False, axis_name=None):
    """Every shard's value on every shard (``jax.lax.all_gather``): stacked
    along a new dim ``axis`` in shard order, or concatenated along
    ``axis`` with ``tiled``."""
    xs = list(xs)
    if _cross():
        return _span(lambda g: all_gather(g, axis, tiled=tiled), xs,
                     _owners(len(xs)), "all_gather")
    if len(xs) == 1 and tiled:
        return PerShard(xs)
    join = torch.cat if tiled else torch.stack

    def leaf(*vals):
        dev = vals[0].device
        return join([v.to(dev) for v in vals], axis)
    if _COUNT["rec"] is not None:
        _tally("all-gather", len(xs), lambda: len(xs) * _nbytes(xs[0]))
    total = _tree_map(leaf, *xs)
    return PerShard(_tree_map(_own, total, x) for x in xs)


def all_to_all(xs, split_axis, concat_axis, axis_name=None):
    """``jax.lax.all_to_all`` over R shards (a tensor a shard): shard i's
    value splits into R equal chunks along ``split_axis``; chunk j goes to
    shard j, which concatenates what it receives along ``concat_axis`` in
    source order."""
    xs = list(xs)
    if _cross():
        return _span(lambda g: all_to_all(g, split_axis, concat_axis), xs,
                     _owners(len(xs)), "all_to_all")
    R = len(xs)
    if R == 1:
        return PerShard(xs)
    for x in xs:
        if x.shape[split_axis] % R:
            raise ValueError(f"all_to_all: dim {split_axis} of "
                             f"{tuple(x.shape)} does not split {R} ways")
    parts = [x.chunk(R, split_axis) for x in xs]
    if _COUNT["rec"] is not None:
        _tally("all-to-all", R, lambda: _nbytes(xs[0]))
    return PerShard(torch.cat([parts[i][j].to(xs[j].device)
                               for i in range(R)], concat_axis)
                    for j in range(R))


def axis_index(xs, axis_name=None):
    """Each shard's index along the axis (``jax.lax.axis_index``)."""
    k = len(list(xs))
    start = _job.rank() * k if _cross() else 0
    return PerShard(range(start, start + k))


# -- groups of a mesh ---------------------------------------------------------

def axis_groups(mesh, axes) -> list:
    """The shards (flat indices in the mesh's row-major order) grouped by
    their coordinates off ``axes``: each group lists the shards that
    differ only along ``axes``, ordered row-major over ``axes``."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    for a in axes:
        if a not in mesh.axis_names:
            raise ValueError(f"axis {a!r} is not in the mesh's "
                             f"{mesh.axis_names}")
    shape = mesh.devices.shape
    flat = np.arange(mesh.devices.size).reshape(shape)
    inner = [mesh.axis_names.index(a) for a in axes]
    outer = [i for i in range(len(shape)) if i not in inner]
    arr = flat.transpose(outer + inner).reshape(
        math.prod(shape[i] for i in outer) if outer else 1, -1)
    return [list(map(int, row)) for row in arr]


def _over(fn, vals, mesh, axes, kind, gathered=False):
    """``fn`` on each group of ``axis_groups(mesh, axes)``: one collective
    of ``kind`` (one shard's result the group's values stacked when
    ``gathered``, else one shard's value), whose groups' own calls are not
    counted again.  On a mesh that spans processes ``vals`` are this
    process's shards' values: a collective whose groups each lie within
    one process runs this process's groups here and exchanges nothing;
    one whose groups cross gathers every shard's value (``_span``)."""
    vals = list(vals)
    groups = axis_groups(mesh, axes)
    at = range(len(vals))
    if _mesh_cross(mesh):
        if mesh.crosses(axes):
            return _span(lambda g: _over(fn, g, mesh, axes, kind, gathered),
                         vals, list(mesh.process_ids.flat), kind)
        local = mesh.local()
        if len(vals) != len(local):
            raise ValueError(f"{kind}: {len(vals)} values for this "
                             f"process's {len(local)} shards")
        at = dict(zip(local, at))
        groups = [g for g in groups if g[0] in at]
    out = [None] * len(vals)
    rec = _COUNT["rec"]
    if rec is not None:
        R = len(groups[0])
        _tally(kind, R, lambda: (R if gathered else 1) * _nbytes(vals[0]))
    with _one_process(count=False):
        for group in groups:
            for i, v in zip(group, fn([vals[at[i]] for i in group])):
                out[at[i]] = v
    return PerShard(out)


def psum_over(vals, mesh, axes):
    """``psum`` within each group of ``axis_groups(mesh, axes)``."""
    return _over(psum, vals, mesh, axes, "all-reduce")


def pmax_over(vals, mesh, axes):
    return _over(pmax, vals, mesh, axes, "all-reduce")


def pmean_over(vals, mesh, axes):
    return _over(pmean, vals, mesh, axes, "all-reduce")


def all_gather_over(vals, mesh, axes, axis=0, *, tiled=False):
    return _over(lambda xs: all_gather(xs, axis, tiled=tiled), vals, mesh,
                 axes, "all-gather", gathered=True)


def all_to_all_over(vals, mesh, axes, split_axis, concat_axis):
    return _over(lambda xs: all_to_all(xs, split_axis, concat_axis), vals,
                 mesh, axes, "all-to-all")


class _GatherScatter(torch.autograd.Function):
    """All-gather of one group's blocks along ``dim``, a whole copy on
    each shard's device; its backward is the reduce-scatter: the copies'
    gradients summed in shard order on the first shard's device, then
    each shard takes its block's slice."""

    @staticmethod
    def forward(ctx, dim, counted, *blocks):
        ctx.dim, ctx.counted = dim, counted
        ctx.sizes = [b.shape[dim] for b in blocks]
        ctx.devices = [b.device for b in blocks]
        return tuple(torch.cat([b.to(x.device) for b in blocks], dim)
                     for x in blocks)

    @staticmethod
    def backward(ctx, *grads):
        dev = ctx.devices[0]
        total = None
        for g in grads:
            if g is not None:
                total = g.to(dev) if total is None else total + g.to(dev)
        if total is None:
            return (None,) * (2 + len(grads))
        if ctx.counted and _COUNT["rec"] is not None:
            # the first group's backward counts the reduce-scatter for all
            _tally("reduce-scatter", len(grads), lambda: total.numel()
                   * total.element_size() // len(grads))
        parts = total.split(ctx.sizes, ctx.dim)
        return (None, None) + tuple(p.to(d) for p, d in
                                    zip(parts, ctx.devices))


def fsdp_gather_over(vals, mesh, axes, dim):
    """Each shard's block of a parameter split along ``dim`` over the mesh
    ``axes`` (FSDP) -> the whole of that dim on every shard, concatenated
    in group order; the gradient of a shard's block is the sum over its
    group of the copies' gradients, in shard order, at the block's slice
    (``psum_over`` then a slice: a reduce-scatter)."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    if math.prod(mesh.shape[a] for a in axes) == 1:
        return PerShard(vals)
    if _mesh_cross(mesh) and mesh.crosses(axes):
        return _span(lambda g: fsdp_gather_over(g, mesh, axes, dim), vals,
                     list(mesh.process_ids.flat), "all-gather")
    groups = []

    def gather(xs):
        groups.append(xs)
        return _GatherScatter.apply(dim, len(groups) == 1, *xs)
    return _over(gather, vals, mesh, axes, "all-gather", gathered=True)


# ---------------------------------------------------------------------------
# Logical-axis rules
# ---------------------------------------------------------------------------

class PartitionSpec(tuple):
    """One entry a dim: a mesh axis name, a tuple of them (the dim split
    over their product, first axis major) or None (whole on every shard)
    -- ``jax.sharding.PartitionSpec``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return "PartitionSpec" + tuple.__repr__(tuple(self))


P = PartitionSpec
_CTX = threading.local()


class AxisRules:
    """A mapping logical-axis-name -> mesh axis (str | tuple | None), one
    for parameters and one for activations, and the mesh they map to."""

    def __init__(self, param_rules: dict, act_rules: dict, mesh):
        self.param_rules = dict(param_rules)
        self.act_rules = dict(act_rules)
        self.mesh = mesh

    def spec(self, axes: tuple, *, kind: str = "act") -> PartitionSpec:
        rules = self.param_rules if kind == "param" else self.act_rules
        return P(*[rules.get(a) for a in axes])


def current_rules():
    return getattr(_CTX, "rules", None)


@contextmanager
def axis_rules(rules: AxisRules):
    """Install ``rules`` on this thread for the ``with`` block."""
    prev = getattr(_CTX, "rules", None)
    _CTX.rules = rules
    try:
        yield rules
    finally:
        _CTX.rules = prev


def logical_spec(axes: tuple, *, kind: str = "act") -> PartitionSpec:
    rules = current_rules()
    if rules is None:
        return P()
    return rules.spec(axes, kind=kind)


def is_axes_leaf(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(a, (str, type(None)))
                                        for a in x)


def map_axes(fn, tree):
    """``fn`` over the leaves (tuples of logical names) of an axes tree."""
    if isinstance(tree, dict):
        return {k: map_axes(fn, v) for k, v in tree.items()}
    if is_axes_leaf(tree):
        return fn(tree)
    raise TypeError(f"not an axes tree: {tree!r}")


def param_pspecs(axes_tree):
    """Tree of PartitionSpecs for a params tree of logical-axes tuples
    (``P()`` everywhere outside any rules)."""
    rules = current_rules()
    if rules is None:
        return map_axes(lambda axes: P(), axes_tree)
    return map_axes(lambda axes: rules.spec(axes, kind="param"), axes_tree)


def entry_axes(entry) -> tuple:
    """The mesh axes one entry of a spec splits its dim over."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)



def spec_axes(spec) -> tuple:
    """Every mesh axis a spec splits a dim over."""
    return tuple(a for e in spec for a in entry_axes(e))


def shard_slices(shape, spec, mesh) -> list:
    """The block of a global tensor of ``shape`` that each shard of
    ``mesh`` holds under ``spec`` -> one tuple of slices a shard, in the
    mesh's row-major order.  A split dim must divide evenly; a spec
    shorter than the shape leaves the trailing dims whole."""
    spec = tuple(spec)
    if len(spec) > len(shape):
        raise ValueError(f"spec {spec} for a {len(shape)}-d shape")
    sizes = mesh.shape
    used = spec_axes(spec)
    if len(set(used)) != len(used):
        raise ValueError(f"spec {spec} names a mesh axis twice")
    for dim, entry in enumerate(spec):
        k = math.prod(sizes[a] for a in entry_axes(entry)) if entry else 1
        for a in entry_axes(entry):
            if a not in sizes:
                raise ValueError(f"spec {spec}: no mesh axis {a!r}")
        if shape[dim] % k:
            raise ValueError(f"dim {dim} of {tuple(shape)} does not split "
                             f"{k} ways over {entry}")
    out = []
    for coords in itertools.product(*(range(n)
                                       for n in mesh.devices.shape)):
        at = dict(zip(mesh.axis_names, coords))
        sl = []
        for dim in range(len(shape)):
            entry = spec[dim] if dim < len(spec) else None
            idx, k = 0, 1
            for a in entry_axes(entry):
                idx, k = idx * sizes[a] + at[a], k * sizes[a]
            n = shape[dim] // k
            sl.append(slice(idx * n, (idx + 1) * n))
        out.append(tuple(sl))
    return out


def param_sharding(axes_tree, mesh=None):
    """Where each parameter lives under the installed rules: a tree of
    ``(spec, mesh)`` pairs (the counterpart of a tree of
    ``NamedSharding``s), or None outside any rules."""
    rules = current_rules()
    if rules is None:
        return None
    mesh = mesh or rules.mesh
    return map_axes(lambda axes: NamedSharding(
        mesh, rules.spec(axes, kind="param")), axes_tree)


class NamedSharding:
    """A spec on a mesh: ``slices(shape)`` gives each shard's block and
    ``devices`` its device, both in the mesh's row-major order."""

    def __init__(self, mesh, spec):
        self.mesh, self.spec = mesh, PartitionSpec(*spec)

    @property
    def devices(self) -> list:
        return list(self.mesh.devices.flat)

    def slices(self, shape) -> list:
        return shard_slices(tuple(shape), self.spec, self.mesh)

    def __repr__(self):
        return f"NamedSharding({self.spec}, {self.mesh})"


class Placed:
    """A global tensor held on a mesh as one block a shard (in the mesh's
    row-major order), each the slice ``sharding.slices(shape)`` names.
    On a mesh that spans processes a process holds only its own shards'
    blocks (``local_blocks``), and None for every other shard's."""

    def __init__(self, blocks, sharding: NamedSharding, shape):
        self.blocks = list(blocks)
        self.sharding = sharding
        self.shape = torch.Size(shape)

    @classmethod
    def from_local(cls, blocks, sharding: NamedSharding, shape):
        """This process's shards' blocks (in global order) -> the
        ``Placed`` that holds them, None at every other shard."""
        out = [None] * sharding.mesh.devices.size
        local = sharding.mesh.local()
        blocks = list(blocks)
        if len(blocks) != len(local):
            raise ValueError(f"{len(blocks)} blocks for this process's "
                             f"{len(local)} shards")
        for i, b in zip(local, blocks):
            out[i] = b
        return cls(out, sharding, shape)

    @classmethod
    def put(cls, x, sharding: NamedSharding, *, copy=True):
        """``x`` (a tensor anywhere) laid out by ``sharding``: each of
        this process's blocks its own contiguous copy on its shard's
        device with ``copy`` (what a state that is updated in place
        needs), else views where the device allows (differentiable)."""
        local = sharding.mesh.local()
        slices = sharding.slices(x.shape)
        blocks = []
        for i in local:
            b = x[slices[i]].to(sharding.devices[i])
            blocks.append(b.clone(memory_format=torch.contiguous_format)
                          if copy else b)
        return cls.from_local(blocks, sharding, x.shape)

    @property
    def local_blocks(self) -> list:
        """This process's blocks, in global shard order."""
        return [b for b in self.blocks if b is not None]

    @property
    def dtype(self):
        return self.local_blocks[0].dtype

    def gather(self, device=None) -> torch.Tensor:
        """The full tensor on ``device`` (default this process's first
        shard's), assembled from one replica of each block
        (differentiable).  Across processes every process calls it and
        gets the whole tensor: the blocks are gathered (``_span``), and
        the gradient of each copy reaches the blocks' owners."""
        if any(b is None for b in self.blocks):
            mesh = self.sharding.mesh
            whole = _span(lambda g: [Placed(g, self.sharding, self.shape)
                                     .gather()] * len(g),
                          self.local_blocks, list(mesh.process_ids.flat),
                          "gather")[0]
            return whole if device is None else whole.to(device)
        device = device or self.blocks[0].device
        out = torch.zeros(self.shape, dtype=self.dtype, device=device)
        seen = set()
        for b, sl in zip(self.blocks, self.sharding.slices(self.shape)):
            key = tuple((s.start, s.stop) for s in sl)
            if key not in seen:
                seen.add(key)
                out[sl] = b.to(device)
        return out

    def relayout(self, sharding: NamedSharding, *, copy=False):
        """The same global value under another sharding (by gather and
        slice; differentiable)."""
        if (sharding.mesh is self.sharding.mesh
                and tuple(sharding.spec) == tuple(self.sharding.spec)):
            return self
        return Placed.put(self.gather(), sharding, copy=copy)

    def __repr__(self):
        return (f"Placed({tuple(self.shape)}, {self.sharding.spec}, "
                f"{len(self.local_blocks)} of {len(self.blocks)} blocks)")


def shard(x, *axes):
    """Constrain ``x`` to the layout its logical ``axes`` give under the
    installed rules: a no-op without rules; else a ``Placed`` (a tensor is
    laid out by slicing, a ``Placed`` re-laid by gather and slice)."""
    rules = current_rules()
    if rules is None:
        return x
    sharding = NamedSharding(rules.mesh, rules.spec(axes, kind="act"))
    if isinstance(x, Placed):
        return x.relayout(sharding)
    return Placed.put(x, sharding, copy=False)


def place_tree(tree, shardings, *, copy=True):
    """A tree of tensors laid out by a matching tree of
    ``NamedSharding``s -> a tree of ``Placed``."""
    if isinstance(tree, dict):
        return {k: place_tree(v, shardings[k], copy=copy)
                for k, v in tree.items()}
    return Placed.put(tree, shardings, copy=copy)


def map_placed(fn, tree):
    """``fn`` over the ``Placed`` leaves of a tree (dicts, lists, tuples;
    other leaves kept)."""
    if isinstance(tree, dict):
        return {k: map_placed(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_placed(fn, v) for v in tree)
    return fn(tree) if isinstance(tree, Placed) else tree


def local_trees(tree, shards) -> list:
    """A tree of ``Placed`` leaves -> one tree of blocks a shard of
    ``shards`` (global indices, such as ``ShardLayout.local``), shard
    s's holding each leaf's block s."""
    return [map_placed(lambda t, s=s: t.blocks[s], tree) for s in shards]


def gather_tree(tree, device=None):
    """A tree whose ``Placed`` leaves are gathered to full tensors."""
    if isinstance(tree, dict):
        return {k: gather_tree(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(gather_tree(v, device) for v in tree)
    return tree.gather(device) if isinstance(tree, Placed) else tree


# ---------------------------------------------------------------------------
# Standard rule sets.
# ---------------------------------------------------------------------------

def make_rules(mesh, *, fsdp: bool = False,
               seq_sharded: bool = False) -> AxisRules:
    """Build the standard DP/TP(/EP/SP) rules for a ('pod'?,'data','model')
    mesh.

    - batch      -> ('pod','data')  (DP; 'pod' folded in when present)
    - heads/mlp/vocab/experts -> 'model'  (TP / EP)
    - embed      -> 'data' on *params* when fsdp=True (FSDP weight shard)
    - seq        -> 'data' on activations when seq_sharded (SP, used by the
                    500k-context cells where batch==1)
    """
    axis_names = mesh.axis_names
    batch_axes = tuple(a for a in ("pod", "data") if a in axis_names)
    batch = batch_axes if len(batch_axes) > 1 else (
        batch_axes[0] if batch_axes else None)

    common = {
        "heads": "model", "kv_heads": "model", "head_dim": None,
        "mlp": "model", "vocab": "model", "experts": "model",
        "expert_mlp": None, "ssm_heads": "model", "ssm_state": None,
        "ssm_group": None, "conv": None, "layers": None, "stack": None,
        "proj": None, "classes": None,
    }
    param_rules = dict(common)
    param_rules["embed"] = "data" if fsdp else None
    param_rules["batch"] = None
    param_rules["seq"] = None

    act_rules = dict(common)
    act_rules["embed"] = None
    act_rules["batch"] = batch
    act_rules["seq"] = "data" if seq_sharded else None
    act_rules["experts"] = "model"
    return AxisRules(param_rules, act_rules, mesh)


def rules_for(mesh, cfg, *, batch=None, kind="train",
              fsdp=False) -> AxisRules:
    """Arch- and shape-aware rules for the production mesh.

    - q/kv heads shard over 'model' when the head count divides it
      (column-parallel); otherwise the projection falls back to
      *row-parallel* (contract dim over 'model', psum'd output).
    - mlp/vocab/experts always shard over 'model'.
    - fsdp=True additionally shards the weights' embed dim over 'data'.
    - decode KV caches shard kv_heads over 'model' when divisible, else
      the *sequence* dim ("kv_seq").
    - batch shards over ('pod','data') when divisible; batch=1 leaves
      batch unsharded and shards cache seq over 'data'.
    """
    ms = mesh.shape["model"]
    ds = mesh.shape.get("data", 1)
    axis_names = mesh.axis_names
    batch_axes = tuple(a for a in ("pod", "data") if a in axis_names)
    dp = 1
    for a in batch_axes:
        dp *= mesh.shape[a]
    batch_spec = (batch_axes if len(batch_axes) > 1 else batch_axes[0]) \
        if (batch is None or batch % dp == 0) and batch != 1 else None

    heads_ok = bool(getattr(cfg, "n_heads", 0)) and cfg.n_heads % ms == 0
    kv_ok = bool(getattr(cfg, "n_kv_heads", 0)) and cfg.n_kv_heads % ms == 0
    hd = getattr(cfg, "head_dim", 0) or 0
    hd_ok = hd % ds == 0 if hd else False
    small_batch = batch == 1

    param_rules = {
        "heads": "model" if heads_ok else None,
        "kv_heads": "model" if kv_ok else None,
        "q_in": (("data" if fsdp else None) if heads_ok else "model"),
        "kv_in": (("data" if fsdp else None) if kv_ok else "model"),
        "q_hd": ("data" if (fsdp and not heads_ok and hd_ok) else None),
        "kv_hd": ("data" if (fsdp and not kv_ok and hd_ok) else None),
        "o_hd": None if heads_ok else "model",
        "embed": "data" if fsdp else None,
        "mlp": "model", "vocab": "model", "experts": "model",
        "expert_mlp": None, "router": None, "ssm_heads": "model",
        "ssm_state": None, "ssm_group": None, "conv": None,
        "head_dim": None, "layers": None, "batch": None, "seq": None,
        "kv_seq": None, "classes": None,
        "stack": "pod" if "pod" in axis_names else None,
    }
    act_rules = {
        "batch": batch_spec,
        "seq": ("data" if small_batch and kind != "train" else None),
        "embed": None,
        "heads": "model" if heads_ok else None,
        "kv_heads": "model" if kv_ok else None,
        "head_dim": None, "mlp": "model", "vocab": "model",
        "experts": "model", "ssm_heads": "model", "ssm_state": None,
        "layers": None, "conv": None,
        "kv_seq": ("model" if not kv_ok else
                   ("data" if small_batch else None)),
        "classes": None,
    }
    return AxisRules(param_rules, act_rules, mesh)


class ShardLayout:
    """The shards of the installed rules' mesh as a sharded LM step sees
    them: each shard has a rank along 'model' (0 without that axis) and
    a batch group (its coordinates on the other axes), in the mesh's
    row-major order.  The ``*_model`` collectives run within each batch
    group, the ``*_batch`` ones across the batch groups of each rank.

    ``n`` counts every shard of the mesh, ``local`` lists the global
    indices of this process's (every shard outside a joined job), and
    ``rank`` and ``group`` give each local shard's rank along 'model' and
    batch group; the sharded programs run over the local shards, in that
    order, on ``device`` (the first local shard's)."""

    def __init__(self, rules: AxisRules):
        mesh = rules.mesh
        if mesh is None:
            raise ValueError("sharded rules need a mesh")
        self.rules, self.mesh = rules, mesh
        self.devices = list(mesh.devices.flat)
        self.n = len(self.devices)
        self.M = mesh.shape.get("model", 1)
        self.batch_axes = tuple(a for a in mesh.axis_names if a != "model")
        self.local = mesh.local()
        if not self.local:
            raise ValueError("this process owns no shard of the mesh")
        self.device = self.devices[self.local[0]]
        names = mesh.axis_names
        coords = list(itertools.product(*(range(k)
                                          for k in mesh.devices.shape)))
        at = [dict(zip(names, c)) for c in coords]
        self.rank = [at[i].get("model", 0) for i in self.local]
        self.group = [tuple(v for a, v in at[i].items() if a != "model")
                      for i in self.local]
        # each local shard's index along the axes ``seq`` splits over,
        # row-major over them in the rule's order (``axis_groups``' order)
        self.seq_axes = self.act_axes("seq")
        self.seq_shards = math.prod(mesh.shape[a] for a in self.seq_axes)
        self.seq_index = [0] * len(self.local)
        for a in self.seq_axes:
            self.seq_index = [j * mesh.shape[a] + at[i][a]
                              for j, i in zip(self.seq_index, self.local)]
        batch = rules.act_rules.get("batch")
        self.batch_spec = P(batch)
        self.batch_split = batch is not None

    def split(self, name) -> bool:
        """Whether the param rules put logical axis ``name`` on 'model'."""
        return self.M > 1 and self.rules.param_rules.get(name) == "model"

    def act_axes(self, name) -> tuple:
        """The mesh axes of more than one shard that the act rules split
        logical axis ``name`` over."""
        return tuple(a for a in entry_axes(self.rules.act_rules.get(name))
                     if self.mesh.shape.get(a, 1) > 1)

    def seq_starts(self, S):
        """Where the act rules split ``seq`` (at batch 1 outside training:
        over 'data') and its shards divide ``S``: each local shard's first
        position of its block of ``S / seq_shards`` -> a list; else None
        (every shard holds the whole sequence: ``shard_slices`` takes even
        blocks only, where the reference lets GSPMD pad)."""
        if not self.seq_axes or S % self.seq_shards:
            return None
        return [i * (S // self.seq_shards) for i in self.seq_index]

    def all_gather_seq(self, vals, dim):
        """Each shard's block of a sequence along ``dim`` -> the whole
        sequence on every shard, the blocks in order (an all-gather over
        the ``seq`` axes; across processes through ``_span``, bitwise one
        process holding every shard)."""
        return self._over(lambda v, m, a: all_gather_over(
            v, m, a, dim, tiled=True), vals, self.seq_axes)

    def batch_blocks(self, x, *, copy=False):
        """A batch-leading global tensor -> each shard's rows (the
        act rules' 'batch' entry; whole on every shard when it is
        None)."""
        sharding = NamedSharding(self.mesh, self.batch_spec)
        return Placed.put(x, sharding, copy=copy).local_blocks

    def gather_batch(self, xs):
        """Each local shard's rows (whole over 'model') -> the global
        tensor on the first local shard's device (one replica a block;
        across processes gathered from every process, differentiable)."""
        sharding = NamedSharding(self.mesh, self.batch_spec)
        groups = self.n // self.M if self.batch_split else 1
        shape = (xs[0].shape[0] * groups,) + tuple(xs[0].shape[1:])
        return Placed.from_local(xs, sharding, shape).gather()

    def _over(self, fn, vals, axes):
        axes = tuple(a for a in axes if a in self.mesh.axis_names)
        return PerShard(vals) if not axes else fn(vals, self.mesh, axes)

    def psum_model(self, vals):
        return self._over(psum_over, vals, ("model",))

    def pmax_model(self, vals):
        return self._over(pmax_over, vals, ("model",))

    def all_gather_model(self, vals, axis):
        return self._over(lambda v, m, a: all_gather_over(
            v, m, a, axis, tiled=True), vals, ("model",))

    def all_to_all_model(self, vals, split_axis, concat_axis):
        return self._over(lambda v, m, a: all_to_all_over(
            v, m, a, split_axis, concat_axis), vals, ("model",))

    def psum_axes(self, vals, axes):
        return self._over(psum_over, vals, axes)

    def pmax_axes(self, vals, axes):
        return self._over(pmax_over, vals, axes)

    def psum_batch(self, vals):
        """Sum over the batch groups where the batch is split (else each
        group already holds the whole batch)."""
        if not self.batch_split:
            return PerShard(vals)
        return self._over(psum_over, vals, self.batch_axes)

    def pmean_all(self, vals):
        """Mean over every shard (the reference's ``pmean`` over all mesh
        axes)."""
        return self._over(pmean_over, vals, self.mesh.axis_names)


def mesh_axis_size(name: str) -> int:
    rules = current_rules()
    if rules is None or rules.mesh is None or \
            name not in rules.mesh.axis_names:
        return 1
    return rules.mesh.shape[name]


def get_mesh():
    rules = current_rules()
    return None if rules is None else rules.mesh


__all__ = ["SESSIONS_AXIS", "Mesh", "PerShard", "row_blocks",
           "sessions_sharding", "psum", "pmax", "pmean", "ppermute",
           "all_gather", "all_to_all", "axis_index", "axis_groups",
           "count_collectives", "psum_over", "pmax_over", "pmean_over",
           "all_gather_over",
           "all_to_all_over", "fsdp_gather_over", "PartitionSpec", "P",
           "AxisRules", "current_rules", "axis_rules", "logical_spec",
           "is_axes_leaf", "map_axes", "param_pspecs", "entry_axes",
           "spec_axes", "shard_slices", "param_sharding", "NamedSharding",
           "Placed", "shard", "place_tree", "gather_tree", "map_placed",
           "local_trees", "make_rules", "rules_for", "ShardLayout",
           "mesh_axis_size", "get_mesh"]
