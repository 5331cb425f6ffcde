#!/usr/bin/env python3
"""How far decode parts from a teacher-forced forward at full depth, on a
CPU: the rehearsal behind ``chip_smoke.py`` phase 14's bars.

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 tools/decode_bar.py [--seeds 8]
    PYTHONPATH=src python3 tools/decode_bar.py --full [--seeds 3]

For mamba2-780m (48 layers), zamba2-1.2b (38) and qwen1.5-0.5b (24) at
full depth: random weights and a random prompt from each seed, greedy
decode steps, then one forward over the prompt and the decoded tokens.
It prints, for each seed, the worst step's max |decode - forward| over
max |forward| of the logits.

Without ``--full`` the widths are narrowed so that the reference runs
too (d_model 384, 12 SSM heads, 6 attention heads, a vocabulary of
1,024; the published head shapes: SSM heads of 64, d_state 128 / 64,
chunk 128): B 4 x prompt 160, 32 steps, and the reference's own decode
against its forward on the port's weights and tokens (``lm_to_jax``).

``--full`` runs the published widths (B 1 x prompt 64, 32 steps; about
10 GB of memory for zamba2, so not on a small host) with the port only,
and a float64 run of the port on the same weights and tokens as the
truth, against which the float32 decode and forward are each measured:
where both part from it alike, the gap is float32 rounding that the
layers amplify, not a fault of either path.
"""
from __future__ import annotations

import argparse
import os
import sys
from dataclasses import replace
from functools import partial

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

from chip_smoke import float64_port, map_tree  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.models import lm  # noqa: E402

NAMES = ("mamba2-780m", "zamba2-1.2b", "qwen1.5-0.5b")
STEPS = 32


def narrowed(cfg):
    kw = dict(d_model=384, vocab=1024)
    if cfg.ssm:
        kw["ssm"] = replace(cfg.ssm, n_heads=12)
    if cfg.n_heads:
        kw.update(n_heads=6, n_kv_heads=6, d_ff=768)
    return replace(cfg, **kw)


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def decode_and_forward(cfg, p, toks, fed=None):
    """Prefill of ``toks``, STEPS decode steps (greedy, or fed the tokens
    ``fed``), then one forward over the prompt and the fed tokens ->
    (decode logits (STEPS, B, V), forward logits at those positions,
    fed tokens (B, STEPS))."""
    S = toks.shape[1]
    st, logits = lm.prefill(cfg, p, tokens=toks, max_len=S + STEPS)
    outs, fed_out = [], []
    for t in range(STEPS):
        fed_out.append(logits.argmax(-1) if fed is None else fed[:, t])
        logits, st = lm.decode_step(cfg, p, st, fed_out[-1])
        outs.append(logits)
    fed_out = torch.stack(fed_out, 1)
    h, _ = lm.forward(cfg, p, tokens=torch.cat([toks, fed_out], 1))
    tf = lm.logits_from_hidden(cfg, p, h[:, S:]).transpose(0, 1)
    return torch.stack(outs).numpy(), tf.numpy(), fed_out


def reference_run(cfg_name, p, toks, fed):
    import jax
    import jax.numpy as jnp

    from repro.configs import base as jbase
    from repro.models import lm as jlm
    from repro_torch.weights import lm_to_jax
    jc = narrowed(jbase.get_config(cfg_name))
    jp = lm_to_jax(p)
    S = toks.shape[1]
    full = np.concatenate([toks, fed], 1).astype(np.int32)
    st, _ = jax.jit(partial(jlm.prefill, jc, max_len=S + STEPS))(
        jp, tokens=jnp.asarray(full[:, :S]))
    step = jax.jit(partial(jlm.decode_step, jc))
    outs = []
    for t in range(STEPS):
        logits, st = step(jp, st, jnp.asarray(full[:, S + t]))
        outs.append(np.asarray(logits))
    h, _ = jax.jit(partial(jlm.forward, jc))(jp, tokens=jnp.asarray(full))
    tf = np.asarray(jlm.logits_from_hidden(jc, jp, h[:, S:]))
    return np.stack(outs), tf.transpose(1, 0, 2)


def worst(dec, tf):
    errs = [rel(dec[t], tf[t]) for t in range(STEPS)]
    return max(errs), int(np.argmax(errs))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=8)
    ap.add_argument("--full", action="store_true",
                    help="published widths, the port and its float64 run")
    args = ap.parse_args()
    torch.set_num_threads(8)
    B, S = (1, 64) if args.full else (4, 160)
    for name in NAMES:
        cfg = get_config(name) if args.full else narrowed(get_config(name))
        print(f"{name}: {cfg.n_layers} layers, d_model {cfg.d_model}, ssm "
              f"{cfg.ssm}, B {B} x prompt {S}, {STEPS} steps", flush=True)
        for seed in range(args.seeds):
            with torch.inference_mode():
                p = lm.init_lm(cfg, torch.Generator().manual_seed(seed))
                toks = torch.randint(
                    0, cfg.vocab, (B, S),
                    generator=torch.Generator().manual_seed(seed))
                dec, tf, fed = decode_and_forward(cfg, p, toks)
                (pw, pt) = worst(dec, tf)
                line = (f"  seed {seed}: port decode vs its forward "
                        f"{pw:.3e} (step {pt})")
                if args.full:
                    c64 = replace(cfg, dtype="float64",
                                  param_dtype="float64")
                    with float64_port():
                        dec64, tf64, _ = decode_and_forward(
                            c64, map_tree(p, torch.Tensor.double), toks, fed)
                    line += (f"; float64: decode vs forward "
                             f"{worst(dec64, tf64)[0]:.3e}, float32 "
                             f"decode vs it {worst(dec, dec64)[0]:.3e}, "
                             f"float32 forward vs it "
                             f"{worst(tf, tf64)[0]:.3e}")
            if not args.full:
                jdec, jtf = reference_run(name, p, toks.numpy(), fed.numpy())
                jw, jt = worst(jdec, jtf)
                cross = max(rel(dec[t], jdec[t]) for t in range(STEPS))
                line += (f"; reference decode vs its forward {jw:.3e} "
                         f"(step {jt}); port vs reference decode "
                         f"{cross:.3e}")
            print(line, flush=True)
            del p


if __name__ == "__main__":
    main()
