"""LM training launcher.

    python -m repro_torch.launch.train --arch qwen1.5-0.5b --smoke --device cpu
    python -m repro_torch.launch.train --arch qwen1.5-0.5b --batch 8 --seq 1024 \
        --smoke ...                  # on one CUDA card (the default device)

Port of ``repro.launch.train``, with its flags.  ``--smoke`` runs the
reduced config (``smoke_config``) at ``--batch`` x ``--seq``; without it
the named ``--shape`` sets the global batch and sequence length.  The
reference's XLA/TPU flag set has no counterpart.  As in the reference,
with more than one device and no ``--smoke`` the launcher builds the
production mesh (``make_production_mesh(multi_pod=)``: 16 x 16, or 2 x
16 x 16 with ``--multi-pod``) and trains under ``rules_for(mesh, cfg,
batch=, kind="train")``; devices that cannot form that mesh raise, and
so does ``--multi-pod`` wherever the 512 devices are not there.
``train_4k`` (256 x 4,096 tokens) does not fit one card in float32.

It first joins a multi-process job where the environment names one
(``maybe_init_distributed``: ``REPRO_COORDINATOR``,
``REPRO_NUM_PROCESSES``, ``REPRO_PROCESS_ID``; a no-op without them), the
counterpart of the pod runtime that makes the reference's
``jax.devices()`` global.  In a joined job the production mesh spans the
job (every process contributing its devices), each process trains its
own shards, and every process prints the same final loss.
"""
from __future__ import annotations

import argparse
import contextlib

import torch


def device_count(device) -> int:
    """The devices a run on ``device``'s type can use (the CPU counts
    one)."""
    if torch.device(device).type == "cuda":
        return torch.cuda.device_count()
    return 1


def main(argv=None):
    from repro_torch.configs.base import SHAPES, get_config, smoke_config
    from repro_torch.data.tokens import random_batch
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.runtime.trainer import TrainCfg, Trainer

    joined = mesh_mod.maybe_init_distributed()

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--hybrid", action="store_true",
                    help="enable the StreamSplit hybrid aux loss")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--optimizer", default="adamw")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)
        batch, seq = args.batch, args.seq
    else:
        shape = SHAPES[args.shape]
        batch, seq = shape.global_batch, shape.seq_len

    tcfg = TrainCfg(optimizer=args.optimizer, lr=args.lr,
                    total_steps=args.steps, warmup=max(args.steps // 20, 5),
                    microbatches=args.microbatches, hybrid=args.hybrid,
                    hybrid_pool=max(seq // 16, 8))

    def data_fn(step):
        return random_batch(torch.Generator().manual_seed(step), cfg.vocab,
                            batch, seq)

    if args.multi_pod or ((joined or device_count(args.device) > 1)
                          and not args.smoke):
        mesh = mesh_mod.make_production_mesh(multi_pod=args.multi_pod)
        rules = shd.rules_for(mesh, cfg, batch=batch, kind="train")
        ctx = shd.axis_rules(rules)
    else:
        ctx = contextlib.nullcontext()

    with ctx:
        trainer = Trainer(cfg, tcfg, data_fn, ckpt_dir=args.ckpt_dir,
                          device=args.device)
        hist = trainer.run(args.steps, log_every=10)
    print(f"final loss {hist[-1]['loss']:.4f} over {len(hist)} steps")
    return hist


if __name__ == "__main__":
    main()
