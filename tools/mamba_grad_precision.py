"""How far a float32 LM gradient lies from the same step in float64, on
one device and on a (data 2, model 2) mesh of logical shards, leaf by leaf.

A mamba layer amplifies the rounding of its input, so the float32
gradient of a deep SSM stack is determined only to a bound that grows
with depth; two float32 runs that order their sums differently (the
mesh's psums) part by about that bound.  This prints, for each leaf, the
mesh's distance from the one-device float32 gradient and each float32
gradient's distance from the float64 one, all of the float64 leaf's max
|g| (the hybrid term off).  It runs on the CPU, at full width and a cut
depth:

    PYTHONPATH=src python tools/mamba_grad_precision.py --arch mamba2-780m \\
        --layers 12 --batch 1 --seq 256
"""
from __future__ import annotations

import argparse
from dataclasses import replace

import torch

from repro_torch.checkpoint.serial import _paths
from repro_torch.configs import base
from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import lm
from repro_torch.optim.sgd import value_and_grad
from repro_torch.runtime import trainer as tr


def _double(tree):
    if isinstance(tree, dict):
        return {k: _double(v) for k, v in tree.items()}
    return tree.double()


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="mamba2-780m")
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--seed", type=int, default=19)
    ap.add_argument("--threads", type=int, default=8)
    args = ap.parse_args()
    torch.set_num_threads(args.threads)
    cfg = replace(base.get_config(args.arch), n_layers=args.layers)
    p = lm.init_lm(cfg, torch.Generator().manual_seed(args.seed))
    toks = torch.randint(0, cfg.vocab, (args.batch, args.seq + 1),
                         generator=torch.Generator().manual_seed(args.seed))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    tcfg = tr.TrainCfg(hybrid=False)
    (l32, _), g32 = value_and_grad(tr.make_loss_fn(cfg, tcfg), p, batch, None)
    mesh = make_test_mesh((2, 2), devices=["cpu"] * 4)
    with shd.axis_rules(shd.rules_for(mesh, cfg, batch=args.batch,
                                      kind="train")):
        (lm32, _), gm32 = value_and_grad(tr.make_loss_fn(cfg, tcfg), p,
                                         batch, None)
    c64 = replace(cfg, dtype="float64", param_dtype="float64")
    real = torch.Tensor.float
    torch.Tensor.float = torch.Tensor.double   # the port's casts in float64
    try:
        (l64, _), g64 = value_and_grad(tr.make_loss_fn(c64, tcfg),
                                       _double(p), batch, None)
    finally:
        torch.Tensor.float = real
    print(f"{args.arch}, {args.layers} layers at full width, B {args.batch} "
          f"x S {args.seq}: loss float32 {l32.item():.7f}, mesh "
          f"{lm32.item():.7f}, float64 {l64.item():.7f}")
    print(f"{'leaf':40s} {'mesh-vs-one':>12s} {'one-vs-f64':>12s} "
          f"{'mesh-vs-f64':>12s}")
    for (name, _), a, b, t in zip(_paths(p), gm32, g32, g64):
        m = t.abs().max().clamp_min(1e-300)
        print(f"{name:40s} "
              f"{((a - b).abs().max() / b.abs().max()).item():12.3e} "
              f"{((b.double() - t).abs().max() / m).item():12.3e} "
              f"{((a.double() - t).abs().max() / m).item():12.3e}")


if __name__ == "__main__":
    main()
