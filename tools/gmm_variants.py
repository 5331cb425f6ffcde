#!/usr/bin/env python3
"""The GMM posterior kernels against the plans their design rejected.

    python3 tools/gmm_variants.py      # from the repository root, one CUDA card

``csrc/gmm_posterior.cu`` splits d until its Mahalanobis pass has four
blocks for each SM, into at most 32 splits, multiplies each term by a
reciprocal of the variance rounded once per (c, j), and launches its
softmax pass as a programmatic dependent of the first.  This script
changes one choice at a time, each in a copy of the source compiled
beside it into ``build/gmm_variants/`` with the build's flags and
``-Xptxas -v``:

- ``splits8``, ``splits16``: at most 8 or 16 splits of d (fewer partials
  for the softmax pass to sum, longer blocks);
- ``one_block_an_sm``, ``two_blocks_an_sm``: the split aims at 1 or 2
  blocks for each SM;
- ``divide``: each term divided by the variance, as the reference writes
  it, instead of multiplied by its reciprocal;
- ``no_pdl``: the softmax pass launched after the Mahalanobis pass ends,
  not as its programmatic dependent.

For the source and each variant it prints the kernels' registers and
spills, holds them to ``chip_smoke.py`` phase 3 (failures counted and
printed, not fatal) and times the kernel at the cascade's (8, 64, 1,024),
the refine round's (25,600, 64, 128) and the edge learner's (96, 16, 128)
shapes (``device_ms``), in the order source, variants, variants reversed,
source.  Prints the card's name and power limit first.
"""
from __future__ import annotations

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

import chip_smoke as cs  # noqa: E402
from flash_bwd_variants import compile_all, use  # noqa: E402

SOURCE = "gmm_posterior.cu"
VARIANTS = {
    "splits8": {"kMaxSplits = 32;": "kMaxSplits = 8;",
                "p.splits <= 4": "p.splits <= 0"},
    "splits16": {"kMaxSplits = 32;": "kMaxSplits = 16;",
                 "p.splits <= 4": "p.splits <= 0"},
    "one_block_an_sm": {"kBlocksPerSM = 4;": "kBlocksPerSM = 1;"},
    "two_blocks_an_sm": {"kBlocksPerSM = 4;": "kBlocksPerSM = 2;"},
    "divide": {"in ? __frcp_rn(vr) : 0.0f": "in ? vr : 1.0f",
               "__fmul_rn(__fmul_rn(diff, diff), iv[k])":
               "__fdiv_rn(__fmul_rn(diff, diff), iv[k])"},
    "no_pdl": {"cfg.numAttrs = 1;": "cfg.numAttrs = 0;"},
}
SHAPES = {"cascade": (8, 64, 1024), "refine": (25600, 64, 128),
          "training": (96, 16, 128)}


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("gmm_variants.py needs a CUDA card")
    from repro_torch.kernels import build, ops
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    libs = compile_all(build, VARIANTS, "gmm_", "gmm_variants", SOURCE)
    failures = []

    def record(cond, msg):
        if not cond:
            failures.append(msg)
            print(f"  phase 3 miss: {msg}")
    cs.check = record
    dev = ops.resolve_device("cuda")
    g = torch.Generator(device=dev).manual_seed(4)
    inputs = {k: cs.gmm_inputs(g, dev, *v) for k, v in SHAPES.items()}
    for name, (lib, lines) in libs.items():
        print(f"{name}:\n  " + "\n  ".join(lines))
        use(build, lib, SOURCE)
        before = len(failures)
        cs.phase3(dev, ops)
        print(f"{name}: {len(failures) - before} phase 3 checks missed")
    names = list(libs)
    for name in names + names[::-1]:
        use(build, libs[name][0], SOURCE)
        print(f"{name}: " + "; ".join(
            f"{k} {cs.device_ms(lambda a: ops.gmm_posterior(*a), x) * 1e3:.2f}"
            f" us" for k, x in inputs.items()))


if __name__ == "__main__":
    main()
