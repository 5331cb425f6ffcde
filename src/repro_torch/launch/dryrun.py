"""Multi-pod dry-run: trace every (arch x shape) cell's step on the
production meshes on ``meta`` tensors, say whether it fits a card, and
take the roofline terms from what the trace counts.

Port of ``repro.launch.dryrun``.  The reference lowers and compiles each
cell on 512 forced host devices and reads XLA's memory and cost analyses
and the partitioned HLO; the port traces one step of the cell, in bf16
(``dtype`` and ``param_dtype``, as the reference's), on a mesh of
``meta`` devices (``make_production_mesh(devices=["meta"] * 256)``, 512
with ``multi_pod``) under ``rules_for(mesh, cfg, batch=, kind=,
fsdp=)``: the train step with the policy's optimizer and microbatches
(``make_sharded_train_step``; AdamW, remat, hybrid off, as the
reference's ``TrainCfg``), ``lm.prefill`` over the prompt, or one
``lm.decode_step`` on a state laid out by ``decode_state_sharding``.
Each shard's block runs in lockstep with the others in one process, so
the trace sees every shard's work; the shards of a cell are symmetric,
and a shard's share is the total over the shard count.  While it traces
it counts:

- ``cost.flops``: ``torch.utils.flop_counter.FlopCounterMode``'s total
  (matrix products and attention; its formulas applied in the byte
  counter's mode) over the shard count.
- ``cost.bytes_accessed``: every aten op's input and output bytes, views
  excepted, over the shard count.  An unfused upper bound: each op
  reads and writes device memory as if nothing were fused, where the
  reference counts XLA's fused buffers.
- ``collectives``: ``distributed.sharding.count_collectives``'s bytes and
  calls by kind, one shard's result a call (the reference's
  ``hlo_analysis.summarize``).
- ``memory``: ``argument_size_in_bytes`` (params, optimizer state, state
  and data: one shard's blocks), ``output_size_in_bytes`` (what the step
  returns, a shard's), ``peak_memory_in_bytes`` (the peak of the live
  storage bytes over the step, arguments included, over the shard
  count: every storage an op makes is tracked until its last tensor
  goes; what every shard holds at once is exact, while a temporary that
  lives only inside one shard's turn of a lockstep op is divided by the
  shard count too, so that part is a lower bound) and ``fits``: that
  peak within the card's 80 GB.

Depth: the trace runs every shard's work on the host, so a cell is not
traced at its full depth.  As the reference's HLO reader counts a scan
body once, times its trip count, ``build_and_compile`` traces a few
shallow cuts of the config (``cuts``: the fewest depths whose counts of
each distinct layer kind, ``layer_counts``, are affinely independent)
and composes every count at the config's own layer counts (``compose``,
exactly, in integers).  ``lower_s`` and ``compile_s`` become ``trace_s``,
the cuts' seconds summed, and the record's ``cuts`` lists the overrides
traced.  The reference's
``--hlo`` (the partitioned HLO text, which ``hlo_analysis.py`` parses) has
no counterpart: the port has no compiled program to print, and on the
card ``torch.profiler`` takes the place of the HLO reader.  No step of a
cell reads data on the host (no ``.item()``, no data-dependent shape:
``moe_ep``'s capacities come from shapes), so every cell traces as it
runs on the card; the flash kernels, which need a card, are not reached
on ``meta`` (``attention`` takes them only for CUDA tensors) and the
plain chunked attention does the same products.

Usage (no card needed)::

  python -m repro_torch.launch.dryrun --arch qwen3-1.7b --shape train_4k
  python -m repro_torch.launch.dryrun --all               # every cell, 16x16
  python -m repro_torch.launch.dryrun --all --multi-pod   # and 2x16x16
  python -m repro_torch.runtime.roofline_report            # the tables
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
import weakref
from dataclasses import replace
from fractions import Fraction

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.configs.base import SHAPES, cells, get_config, input_specs
from repro_torch.distributed import sharding as shd
from repro_torch.launch import roofline
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import lm
from repro_torch.optim.sgd import tree_leaves
from repro_torch.runtime.trainer import (TrainCfg, init_sharded_train_state,
                                         make_sharded_train_step)

# per-arch large-scale policy: optimizer / FSDP / microbatching, the
# reference's (its microbatch counts were tuned on its own meshes)
POLICY = {
    "kimi-k2-1t-a32b": dict(optimizer="adafactor", fsdp=True, microbatches=2),
    "arctic-480b": dict(optimizer="adafactor", fsdp=True, microbatches=2),
    "llava-next-34b": dict(optimizer="adamw", fsdp=True, microbatches=2),
    "nemotron-4-15b": dict(optimizer="adamw", fsdp=True, microbatches=2),
}
DEFAULT_POLICY = dict(optimizer="adamw", fsdp=False, microbatches=1)


def policy_for(arch):
    return {**DEFAULT_POLICY, **POLICY.get(arch, {})}


def _opt_axes(optname, params_axes):
    """The logical axes of an optimizer state over params of
    ``params_axes`` (the reference's layout)."""
    if optname == "adamw":
        return {"m": params_axes, "v": params_axes, "step": ()}
    if optname == "sgd":
        return (params_axes,)
    if optname == "adafactor":
        def leaf(a):
            if len(a) >= 2:
                return {"vr": a[:-1], "vc": a[:-2] + a[-1:]}
            return {"v": a}
        return {"stats": shd.map_axes(leaf, params_axes), "step": ()}
    raise ValueError(optname)


def eval_params(cfg):
    """``init_lm``'s params as ``meta`` tensors (shapes and dtypes, no
    data) and their logical axes -> (shapes, axes)."""
    return lm.init_lm(cfg, None, with_axes=True)


def _storage_key(t):
    return t.untyped_storage()._cdata


_FUNCTIONAL: dict = {}


def _functional(func) -> bool:
    """Whether an aten op writes none of its arguments and returns fresh
    tensors (no view, no in-place or ``out=`` form)."""
    known = _FUNCTIONAL.get(func)
    if known is None:
        schema = func._schema
        known = _FUNCTIONAL[func] = (
            all(a.alias_info is None for a in schema.arguments)
            and all(r.alias_info is None for r in schema.returns)
            and all(str(r.type) == "Tensor" for r in schema.returns))
    return known


def _key(x):
    """A hashable stand-in for an op argument: a tensor by its metadata."""
    if isinstance(x, torch.Tensor):
        return (x.shape, x.stride(), x.dtype, x.device.type,
                x.storage_offset())
    if isinstance(x, (list, tuple)):
        return tuple(map(_key, x))
    if isinstance(x, dict):
        return tuple((k, _key(v)) for k, v in sorted(x.items()))
    hash(x)
    return x


class _ShapeCache(TorchDispatchMode):
    """``meta`` ops answered from their shapes: the first call of a
    functional op at given argument shapes, dtypes and strides runs its
    meta kernel, and every later one gets new empty tensors of the shapes
    that call gave.  The shards of a mesh repeat each op at the same
    shapes, and a ``meta`` kernel (often a Python reference) costs far
    more than making an empty tensor."""

    def __init__(self):
        super().__init__()
        self.seen = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if not _functional(func):
            return func(*args, **kwargs)
        try:
            key = (func, _key(args), _key(kwargs))
        except TypeError:                # an unhashable argument
            return func(*args, **kwargs)
        meta = self.seen.get(key)
        if meta is None:
            out = func(*args, **kwargs)
            if not all(t.device.type == "meta" for t in (
                    out if isinstance(out, (list, tuple)) else (out,))):
                return out
            self.seen[key] = [(tuple(t.shape), t.stride(), t.dtype)
                              for t in (out if isinstance(out, (list, tuple))
                                        else (out,))], type(out)
            return out
        specs, kind = meta
        outs = [torch.empty_strided(sh, st, dtype=dt, device="meta")
                for sh, st, dt in specs]
        return outs[0] if kind is torch.Tensor or (
            not issubclass(kind, (list, tuple))) else kind(outs)


class _Trace(TorchDispatchMode):
    """Counts the flops of every aten op that ``FlopCounterMode`` counts
    (its formulas, ``flop_registry``, in this mode: a mode of its own an
    op cost as much again), the bytes every aten op reads and writes
    (views excepted) and the bytes of live storages: each storage an op's
    output holds is live from then until the last tensor that holds it
    goes."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.live = {}            # storage -> [bytes, tensors holding it]
        self.live_bytes = 0
        self.peak = 0

    def hold(self, t):
        """Track ``t``'s storage while ``t`` lives."""
        key = _storage_key(t)
        entry = self.live.get(key)
        if entry is None:
            entry = self.live[key] = [t.untyped_storage().nbytes(), 0]
            self.live_bytes += entry[0]
            self.peak = max(self.peak, self.live_bytes)
        entry[1] += 1
        weakref.finalize(t, self._release, key)

    def _release(self, key):
        entry = self.live.get(key)
        if entry is None:
            return
        entry[1] -= 1
        if entry[1] == 0:
            self.live_bytes -= entry[0]
            del self.live[key]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        count = flop_registry.get(func._overloadpacket)
        if count is not None:
            self.flops += count(*args, **kwargs, out_val=out)
        outs = [t for t in tree_flatten(out)[0]
                if isinstance(t, torch.Tensor)]
        if not func.is_view:
            ins = [t for t in tree_flatten((args, kwargs))[0]
                   if isinstance(t, torch.Tensor)]
            self.bytes += sum(t.numel() * t.element_size()
                              for t in ins + outs)
        for t in outs:
            self.hold(t)
        return out


def _bytes(tree) -> int:
    """The bytes of the tensors of a tree (``Placed`` leaves: every
    block)."""
    total = 0
    for x in tree_leaves(tree):
        blocks = x.blocks if isinstance(x, shd.Placed) else [x]
        total += sum(b.numel() * b.element_size() for b in blocks
                     if isinstance(b, torch.Tensor))
    return total


def _tensors(tree) -> list:
    out = []
    for x in tree_leaves(tree):
        out += x.blocks if isinstance(x, shd.Placed) else [x]
    return [t for t in out if isinstance(t, torch.Tensor)]


def _data(lay, cfg, shape, dtype):
    """The cell's data inputs (``input_specs``), on the mesh's device."""
    return {k: v.to(lay.devices[0])
            for k, v in input_specs(cfg, shape, dtype=dtype).items()}


def _step(cfg, shape, pol, lay, dtype):
    """The cell's arguments and its step -> (args, fn): ``fn(*args)`` runs
    one train step, prefill or decode step on the mesh."""
    data = _data(lay, cfg, shape, dtype)
    if shape.kind == "train":
        tcfg = TrainCfg(optimizer=pol["optimizer"],
                        microbatches=pol["microbatches"], lr=1e-4,
                        total_steps=10_000, warmup=100)
        state = init_sharded_train_state(cfg, tcfg, None, lay)
        step = make_sharded_train_step(cfg, tcfg, lay)
        return ((state["params"], state["opt"], data),
                lambda p, o, b: step(p, o, b, 0)[:2])
    params = shd.place_tree(lm.init_lm(cfg, None),
                            lm.param_shardings(cfg, lay))
    if shape.kind == "prefill":
        return ((params, data), lambda p, b: lm.prefill(
            cfg, p, max_len=shape.seq_len, **b))
    state = lm.init_decode_state_sharded(lay, cfg, shape.global_batch,
                                         shape.seq_len)
    return ((params, state, data["tokens"]),
            lambda p, s, tok: lm.decode_step(cfg, p, s, tok))


def trace_cut(cfg, shape, pol, mesh) -> dict:
    """Trace one step of ``cfg`` (as it is, at its own depth) on ``mesh``
    -> its raw counts over every shard, as Python ints: ``flops``
    (``FlopCounterMode``'s formulas), ``bytes`` (every op's input and output
    bytes), ``peak`` (the live storages' peak), ``argument_bytes``,
    ``output_bytes``, ``collective_bytes``, ``per_kind_bytes`` and
    ``per_kind_counts`` (one shard's result a call); and ``trace_s``, the
    seconds it took."""
    rules = shd.rules_for(mesh, cfg, batch=shape.global_batch,
                          kind=shape.kind, fsdp=pol["fsdp"])
    t0 = time.time()
    with shd.axis_rules(rules):
        lay = shd.ShardLayout(rules)
        args, fn = _step(cfg, shape, pol, lay, cfg.dtype)
        trace = _Trace()
        arg_tensors = _tensors(args)
        with torch.no_grad():
            for t in arg_tensors:
                trace.hold(t)
        with _ShapeCache(), shd.count_collectives() as coll, trace:
            out = fn(*args)
        del arg_tensors
    return {"flops": int(trace.flops), "bytes": trace.bytes,
            "peak": trace.peak, "argument_bytes": _bytes(args),
            "output_bytes": _bytes(out),
            "collective_bytes": coll["collective_bytes"],
            "per_kind_bytes": dict(coll["per_kind_bytes"]),
            "per_kind_counts": dict(coll["per_kind_counts"]),
            "trace_s": time.time() - t0}


# ---------------------------------------------------------------------------
# Depth: each distinct layer traced in a few shallow cuts and counted by
# its number (the reference's HLO reader counts a scan body once, times its
# trip count).  Every count is affine in the layer counts: flops, bytes and
# collectives are sums over the step's ops; the peak, a maximum over the
# step, once each cut is deep enough for the piece that grows fastest with
# depth to be the one that peaks (``_least``).
# ---------------------------------------------------------------------------

def layer_counts(cfg) -> dict:
    """The config's count of each distinct layer kind: a hybrid's mamba
    layers in full groups, those of its tail and the uses of its shared
    block (``_hybrid_layout``); an SSM's mamba layers; a MoE stack's
    leading dense layers and MoE layers; an attention stack's layers (by
    ``attn_pattern``, cycled as ``layer_windows`` cycles it, where it has
    more than one kind).  A hybrid's tail is a kind of its own: a train
    step's peak, in the backward of the last shared block, holds less of a
    tail layer than of a layer before that block."""
    if cfg.family == "hybrid":
        groups, tail = lm._hybrid_layout(cfg)
        return {"mamba": cfg.n_layers - tail, "tail": tail,
                "shared": groups}
    if cfg.family == "ssm":
        return {"mamba": cfg.n_layers}
    if cfg.family == "moe":
        kd = cfg.moe.first_k_dense
        return ({"dense": kd} if kd else {}) | {"moe": cfg.n_layers - kd}
    pat = cfg.attn_pattern
    if len(set(pat)) == 1:
        return {"layers": cfg.n_layers}
    out = dict.fromkeys(pat, 0)
    for i in range(cfg.n_layers):
        out[pat[i % len(pat)]] += 1
    return out


def _depth(cfg, ovr=None) -> int:
    """The layers and shared-block uses of ``cfg`` with ``ovr``."""
    return sum(layer_counts(replace(cfg, **(ovr or {}))).values())


def _least(cfg, kind) -> int:
    """The fewest layers of a cut of ``cfg``'s ``kind`` step: where the
    peak has settled on the piece that grows with depth, as traced on
    ``meta`` meshes of every cell at 1-5 layers.  A train step's peak (every
    layer's saved input live) settles at one layer past a MoE stack's
    leading dense ones (a vlm's, whose embeds are an input, at two); a
    prefill's and an attention stack's decode step's at two (at one the
    last layer is the first); a MoE prefill's and decode step's at three
    MoE layers; an SSM's decode step's at one; a hybrid's at one group of
    one layer."""
    lo = 1 + (cfg.moe.first_k_dense if cfg.family == "moe" else 0)
    if cfg.family == "hybrid" or (cfg.family == "ssm" and kind != "prefill"):
        return 1
    if kind == "train":
        return lo + (cfg.family == "vlm")
    return lo + 1 + (cfg.family == "moe")


def _candidates(cfg, kind) -> list:
    """Shallow overrides of ``cfg`` for a ``kind`` step, shallowest first:
    ``n_layers`` from ``_least``; a hybrid's with each ``hybrid_period``
    that gives it one group or more."""
    lo = _least(cfg, kind)
    if cfg.family == "hybrid":
        ovrs = [{"n_layers": n, "hybrid_period": p}
                for n in range(lo, lo + 4) for p in range(1, n + 1)]
    else:
        ovrs = [{"n_layers": n}
                for n in range(lo, lo + 2 * len(cfg.attn_pattern) + 2)]
    return sorted(ovrs, key=lambda o: _depth(cfg, o))


def _eliminate(a, n_cols):
    """Gauss-Jordan elimination of the rows ``a`` (lists of ``Fraction``)
    over their first ``n_cols`` columns, in place -> the rank."""
    rank = 0
    for col in range(n_cols):
        piv = next((i for i in range(rank, len(a)) if a[i][col]), None)
        if piv is None:
            continue
        a[rank], a[piv] = a[piv], a[rank]
        a[rank] = [x / a[rank][col] for x in a[rank]]
        for i in range(len(a)):
            if i != rank and a[i][col]:
                a[i] = [x - a[i][col] * y for x, y in zip(a[i], a[rank])]
        rank += 1
    return rank


def _varying(cfg, ovrs) -> list:
    """The layer kinds whose count differs between the overrides ``ovrs``
    of ``cfg``.  Any other kind has one count in all of them (kimi-k2's
    leading dense layer) and falls in the part that does not depend on
    depth."""
    seen = [layer_counts(replace(cfg, **o)) for o in ovrs]
    return [k for k in layer_counts(cfg)
            if len({c.get(k, 0) for c in seen}) > 1]


def _row(cfg, kinds, ovr=None) -> list:
    """[1, each kind's count] of ``cfg`` with ``ovr``."""
    c = layer_counts(replace(cfg, **(ovr or {})))
    return [Fraction(1)] + [Fraction(c.get(k, 0)) for k in kinds]


def cuts(cfg, kind="train") -> list:
    """The cheapest shallow overrides of ``cfg`` for a ``kind`` step
    (``n_layers``, and ``hybrid_period`` for a hybrid) whose count vectors,
    with a constant term, are affinely independent and span every kind
    that the candidates vary."""
    todo = _candidates(cfg, kind)
    kinds, chosen = _varying(cfg, todo), []
    for o in todo:
        rows = [_row(cfg, kinds, c) for c in chosen + [o]]
        if _eliminate(rows, len(kinds) + 1) > len(chosen):
            chosen.append(o)
            if len(chosen) == len(kinds) + 1:
                return chosen
    raise ValueError(f"{cfg.name}: no independent cuts for {kinds}")


def compose(cfg, traced) -> dict:
    """``trace_cut``'s counts of ``cfg`` from those of its cuts: each
    field the constant plus each kind's increment times ``cfg``'s count of
    that kind (a collective kind missing from a cut counts 0 there).
    ``traced``: [(override, counts)] of ``cuts(cfg, kind)``, or of
    ``cfg``'s own depth alone (its counts as they are).  Raises
    ``ValueError`` where a composed value is negative or not an integer,
    or where a kind the cuts hold fixed has another count in ``cfg``."""
    ovrs = [o for o, _ in traced]
    kinds, want = _varying(cfg, ovrs), layer_counts(cfg)
    fixed = {k: v for k, v in layer_counts(replace(cfg, **ovrs[0])).items()
             if k not in kinds}
    if any(want.get(k, 0) != v for k, v in fixed.items()):
        raise ValueError(f"{cfg.name}: the cuts fix {fixed}, the config "
                         f"has {want}")
    # the weights w with sum_i w_i row_i == cfg's row: rows^T w = target
    rows, n = [_row(cfg, kinds, o) for o in ovrs], len(ovrs)
    a = [[rows[j][i] for j in range(n)] + [_row(cfg, kinds)[i]]
         for i in range(n)]
    if n != len(kinds) + 1 or _eliminate(a, n) < n:
        raise ValueError(f"{cfg.name}: cuts {ovrs} do not span {kinds}")
    w = [r[n] for r in a]

    def value(name, get):
        v = sum(wi * get(c) for wi, (_, c) in zip(w, traced))
        if v < 0 or v.denominator != 1:
            raise ValueError(f"{cfg.name}: composed {name} is {v}")
        return int(v)
    out = {f: value(f, lambda c: c[f])
           for f in ("flops", "bytes", "peak", "argument_bytes",
                     "output_bytes", "collective_bytes")}
    calls = {k: value(k, lambda c: c["per_kind_counts"].get(k, 0))
             for k in dict.fromkeys(k for _, c in traced
                                    for k in c["per_kind_counts"])}
    out["per_kind_counts"] = {k: v for k, v in calls.items() if v}
    out["per_kind_bytes"] = {
        k: value(k, lambda c: c["per_kind_bytes"].get(k, 0))
        for k in out["per_kind_counts"]}
    out["trace_s"] = sum(c["trace_s"] for _, c in traced)
    return out


def _own(cfg) -> dict:
    """``cfg``'s own depth as an override."""
    return {"n_layers": cfg.n_layers} | (
        {"hybrid_period": cfg.hybrid_period} if cfg.family == "hybrid"
        else {})


def plan(cfg, kind="train") -> list:
    """The overrides to trace for ``cfg``'s ``kind`` step: its cuts, or
    its own depth where it is no deeper than its deepest cut."""
    todo = cuts(cfg, kind)
    if _depth(cfg) <= max(_depth(cfg, o) for o in todo):
        return [_own(cfg)]
    return todo


def cell_config(arch, *, dtype="bfloat16", overrides=None):
    """The config a cell traces: ``arch``'s in ``dtype`` (``dtype`` and
    ``param_dtype``) with ``overrides`` (keys it lacks ignored)."""
    cfg = replace(get_config(arch), dtype=dtype, param_dtype=dtype)
    if overrides:
        cfg = replace(cfg, **{k: v for k, v in overrides.items()
                              if hasattr(cfg, k)})
    return cfg


def record(arch, shape_name, mesh, cfg, counts, ovrs) -> dict:
    """The result record of ``counts`` (``trace_cut``'s or ``compose``'s)
    of ``cfg`` on ``mesh``: the reference's keys, ``trace_s`` for its
    ``lower_s`` and ``compile_s``, and ``cuts``, ``ovrs``: the overrides
    traced.
    The parameter and model flop counts come from ``cfg``'s shapes."""
    shape = SHAPES[shape_name]
    n_chips = mesh.devices.size
    params_shapes = eval_params(cfg)[0]
    per_chip_flops = counts["flops"] / n_chips
    hbm_bytes = counts["bytes"] / n_chips
    mflops = roofline.model_flops(cfg, params_shapes, shape)
    rl = roofline.Roofline(flops=per_chip_flops, hbm_bytes=hbm_bytes,
                           coll_bytes=float(counts["collective_bytes"]),
                           model_flops=mflops, n_chips=n_chips)
    peak = counts["peak"] / n_chips
    return {
        "arch": arch, "shape": shape_name,
        "mesh": "x".join(str(s) for s in mesh.devices.shape),
        "axes": list(mesh.axis_names),
        "policy": policy_for(arch),
        "n_params": roofline.count_params(params_shapes),
        "n_params_active": roofline.active_params(cfg, params_shapes),
        "param_bytes_per_chip": int(
            sum(x.numel() * x.element_size()
                for x in roofline.leaves(params_shapes)) / n_chips),
        "trace_s": round(counts["trace_s"], 2),
        "cuts": list(ovrs),
        "memory": {"argument_size_in_bytes": int(
                       counts["argument_bytes"] / n_chips),
                   "output_size_in_bytes": int(
                       counts["output_bytes"] / n_chips),
                   "peak_memory_in_bytes": int(peak),
                   "fits": peak <= roofline.HBM_BYTES},
        "cost": {"flops": per_chip_flops, "bytes_accessed": hbm_bytes,
                 "global_flops": float(counts["flops"])},
        "collectives": {k: counts[k] for k in (
            "collective_bytes", "per_kind_bytes", "per_kind_counts")},
        "roofline": rl.as_dict(),
    }


def build_and_compile(arch, shape_name, mesh, *, dtype="bfloat16",
                      overrides=None):
    """One cell on ``mesh`` (a mesh of ``meta`` devices) at its config's
    depth, traced as ``plan`` says and composed where it took cuts -> the
    result record."""
    cfg = cell_config(arch, dtype=dtype, overrides=overrides)
    shape, pol = SHAPES[shape_name], policy_for(arch)
    todo = plan(cfg, shape.kind)
    traced = [(o, trace_cut(replace(cfg, **o), shape, pol, mesh))
              for o in todo]
    return record(arch, shape_name, mesh, cfg, compose(cfg, traced), todo)


def summary_line(rec) -> str:
    """The reference's one-line summary of a record."""
    r = rec["roofline"]
    return (f"  params {rec['n_params']/1e9:.2f}B  "
            f"trace {rec['trace_s']:.1f}s  "
            f"compute {r['compute_s']*1e3:.2f}ms  "
            f"memory {r['memory_s']*1e3:.2f}ms  "
            f"collective {r['collective_s']*1e3:.2f}ms  "
            f"bottleneck={r['bottleneck']}  "
            f"MFU<= {r['mfu_upper_bound']*100:.1f}%")


def run_cell(arch, shape_name, *, multi_pod, out_dir, overrides=None):
    mesh = make_production_mesh(multi_pod=multi_pod,
                                devices=["meta"] * (512 if multi_pod
                                                    else 256))
    tag = f"{arch}__{shape_name}__{'multi' if multi_pod else 'single'}"
    print(f"=== {tag} ===", flush=True)
    try:
        rec = build_and_compile(arch, shape_name, mesh, overrides=overrides)
    except Exception as e:   # a cell that fails is recorded, not fatal
        rec = {"arch": arch, "shape": shape_name,
               "mesh": "multi" if multi_pod else "single",
               "error": f"{type(e).__name__}: {e}",
               "trace": traceback.format_exc()[-2000:]}
        print(f"  FAILED: {rec['error']}", flush=True)
    else:
        print(summary_line(rec), flush=True)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, tag + ".json"), "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    args = ap.parse_args(argv)

    todo = cells() if args.all else [(args.arch, args.shape)]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    results = []
    for mp in meshes:
        for arch, shape_name in todo:
            results.append(run_cell(arch, shape_name, multi_pod=mp,
                                    out_dir=args.out))
    n_fail = sum("error" in r for r in results)
    print(f"\n{len(results) - n_fail}/{len(results)} cells traced OK")
    return 0 if n_fail == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
