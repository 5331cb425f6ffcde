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
  (matrix products and attention) over the shard count.
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

``lower_s`` and ``compile_s`` become ``trace_s``.  The reference's
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

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

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
    """Counts the bytes every aten op reads and writes (views excepted) and
    the bytes of live storages: each storage an op's output holds is live
    from then until the last tensor that holds it goes."""

    def __init__(self):
        super().__init__()
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
        out = func(*args, **(kwargs or {}))
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


def build_and_compile(arch, shape_name, mesh, *, dtype="bfloat16",
                      overrides=None):
    """Trace one cell on ``mesh`` (a mesh of ``meta`` devices) -> the
    result record (the reference's keys; ``trace_s`` for its ``lower_s``
    and ``compile_s``)."""
    cfg = get_config(arch)
    cfg = replace(cfg, dtype=dtype, param_dtype=dtype)
    if overrides:
        cfg = replace(cfg, **{k: v for k, v in overrides.items()
                              if hasattr(cfg, k)})
    shape = SHAPES[shape_name]
    pol = policy_for(arch)
    rules = shd.rules_for(mesh, cfg, batch=shape.global_batch,
                          kind=shape.kind, fsdp=pol["fsdp"])
    n_chips = mesh.devices.size
    t0 = time.time()
    with shd.axis_rules(rules):
        lay = shd.ShardLayout(rules)
        params_shapes = eval_params(cfg)[0]
        args, fn = _step(cfg, shape, pol, lay, dtype)
        trace, flops = _Trace(), FlopCounterMode(display=False)
        arg_tensors = _tensors(args)
        with torch.no_grad():
            for t in arg_tensors:
                trace.hold(t)
        with _ShapeCache(), shd.count_collectives() as coll, flops, trace:
            out = fn(*args)
        del arg_tensors
    trace_s = time.time() - t0
    total_flops = float(flops.get_total_flops())
    per_chip_flops = total_flops / n_chips
    hbm_bytes = trace.bytes / n_chips
    mflops = roofline.model_flops(cfg, params_shapes, shape)
    rl = roofline.Roofline(flops=per_chip_flops, hbm_bytes=hbm_bytes,
                           coll_bytes=float(coll["collective_bytes"]),
                           model_flops=mflops, n_chips=n_chips)
    peak = trace.peak / n_chips
    return {
        "arch": arch, "shape": shape_name,
        "mesh": "x".join(str(s) for s in mesh.devices.shape),
        "axes": list(mesh.axis_names),
        "policy": pol,
        "n_params": roofline.count_params(params_shapes),
        "n_params_active": roofline.active_params(cfg, params_shapes),
        "param_bytes_per_chip": int(
            sum(x.numel() * x.element_size()
                for x in roofline.leaves(params_shapes)) / n_chips),
        "trace_s": round(trace_s, 2),
        "memory": {"argument_size_in_bytes": int(_bytes(args) / n_chips),
                   "output_size_in_bytes": int(_bytes(out) / n_chips),
                   "peak_memory_in_bytes": int(peak),
                   "fits": peak <= roofline.HBM_BYTES},
        "cost": {"flops": per_chip_flops, "bytes_accessed": hbm_bytes,
                 "global_flops": total_flops},
        "collectives": {k: v for k, v in coll.items()},
        "roofline": rl.as_dict(),
    }


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
