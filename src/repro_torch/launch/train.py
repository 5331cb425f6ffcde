"""LM training launcher.

    python -m repro_torch.launch.train --arch qwen1.5-0.5b --smoke --device cpu
    python -m repro_torch.launch.train --arch qwen1.5-0.5b --batch 8 --seq 1024 \
        --smoke ...                  # on one CUDA card (the default device)

Port of ``repro.launch.train``, with its flags.  ``--smoke`` runs the
reduced config (``smoke_config``) at ``--batch`` x ``--seq``; without it
the named ``--shape`` sets the global batch and sequence length.  The
reference's XLA/TPU flag set has no counterpart.  Sharding waits (ROADMAP
§1 item 7): with more than one CUDA device and no ``--smoke``, or with
``--multi-pod``, the launcher raises rather than train unsharded.
``train_4k`` (256 x 4,096 tokens) does not fit one card in float32, so it
needs that item too.
"""
from __future__ import annotations

import argparse

import torch


def main(argv=None):
    from repro_torch.configs.base import SHAPES, get_config, smoke_config
    from repro_torch.data.tokens import random_batch
    from repro_torch.runtime.trainer import TrainCfg, Trainer

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

    n_dev = torch.cuda.device_count() \
        if torch.device(args.device).type == "cuda" else 1
    if args.multi_pod or (n_dev > 1 and not args.smoke):
        raise NotImplementedError(
            f"{n_dev} devices{' across pods' if args.multi_pod else ''}: "
            "sharded training is not ported yet (ROADMAP §1 item 7); run "
            "with --smoke, or on one device")

    tcfg = TrainCfg(optimizer=args.optimizer, lr=args.lr,
                    total_steps=args.steps, warmup=max(args.steps // 20, 5),
                    microbatches=args.microbatches, hybrid=args.hybrid,
                    hybrid_pool=max(seq // 16, 8))

    def data_fn(step):
        return random_batch(torch.Generator().manual_seed(step), cfg.vocab,
                            batch, seq)

    trainer = Trainer(cfg, tcfg, data_fn, ckpt_dir=args.ckpt_dir,
                      device=args.device)
    hist = trainer.run(args.steps, log_every=10)
    print(f"final loss {hist[-1]['loss']:.4f} over {len(hist)} steps")
    return hist


if __name__ == "__main__":
    main()
