#!/usr/bin/env python3
"""The Laplacian forward kernel against the choices its design rejected.

    python3 tools/laplacian_variants.py     # from the repository root, one CUDA card

``csrc/laplacian_energy.cu`` runs the forward with a lane per float4 of
columns walking its chunk's frames through a register ring of kRing = 5
frames, the loads of kBatch = 5 frames issued together, two 256-thread
blocks an SM, chunks sized for about kTargetWarps = 2,048 warps on the
card and at least kMinFrames = 2 frames, and a row's blocks in a cluster
of at most kMaxCluster = 8 whose blocks store their partials into the
leader's shared memory. This script changes one choice at a time, each
in a copy of the source compiled beside it into
``build/laplacian_variants/`` with the build's flags and ``-Xptxas -v``:

- ``one_block_an_sm``, ``three_blocks_an_sm``, ``four_blocks_an_sm``:
  ``__launch_bounds__`` asking for 1, 3 or 4 blocks an SM (registers
  uncapped, or at most 85 or 64);
- ``ring4``: a ring of 4 frames (k = 5 then takes two delta groups);
- ``batch10``: the loads of 10 frames issued together (more registers,
  half the batches);
- ``min_frames1``, ``min_frames4``: chunks of at least 1 or 4 frames (the
  edge learner's row: 104 or 26 chunks, clusters of 8 or 4 blocks);
- ``target_1024``, ``target_4096``: chunks sized for 1,024 or 4,096 warps;
- ``max_cluster1``, ``max_cluster2``, ``max_cluster4``: at most 1, 2 or 4
  blocks a row (longer chunks where a row's tasks would outnumber them);
- ``fma``: the squares and the weighted sum fused (``__fmaf_rn``), 3 fewer
  operations a pair and lane, other roundings;
- ``always_checked``: every pair tested (j <= J, a >= 0), where the
  source tests only walks that start within kRing frames of frame 0 or
  have fewer than kRing deltas;
- ``probe_one_pair``: one pair a step in place of K, every load kept (not
  a design: it misses phases 3 and 5), to split the kernel's time.

For the source and each variant it prints the kernels' registers and
spills, holds them to ``chip_smoke.py`` phases 3 and 5 (misses counted
and printed, not fatal) and times ``laplacian_energy`` at the refine
round's (256, 100, 128) k 5, the edge learner's (1, 104, 128) k 3 and the
LM step's (8, 16, 1,024) k 5 (``device_ms``), in the order source,
variants, variants reversed, source.  Prints the card's name and power
limit first.
"""
from __future__ import annotations

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src"), os.path.join(ROOT, "tools")]

import chip_smoke as cs  # noqa: E402
from flash_bwd_variants import compile_all, use  # noqa: E402
from swd_variants import card, held  # noqa: E402

SOURCE = "laplacian_energy.cu"
BOUNDS = ("__global__ void __launch_bounds__(kThreads, 2)\n"
          "laplacian_energy_kernel")
PAIR = ("          acc = __fadd_rn(acc, __fmul_rn(w, L::sq(zb, "
        "ring[slot])));\n")
SQ4 = ("    return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),\n"
       "                     __fadd_rn(__fmul_rn(z, z), __fmul_rn(w, w)));\n")
RING = "constexpr int kRing = 5;"
VARIANTS = {
    "one_block_an_sm": {BOUNDS: BOUNDS.replace("(kThreads, 2)",
                                               "(kThreads)")},
    "three_blocks_an_sm": {BOUNDS: BOUNDS.replace("(kThreads, 2)",
                                                  "(kThreads, 3)")},
    "four_blocks_an_sm": {BOUNDS: BOUNDS.replace("(kThreads, 2)",
                                                 "(kThreads, 4)")},
    "ring4": {RING: "constexpr int kRing = 4;"},
    "batch10": {"constexpr int kBatch = kRing;":
                "constexpr int kBatch = 2 * kRing;"},
    "min_frames1": {"constexpr int kMinFrames = 2;":
                    "constexpr int kMinFrames = 1;"},
    "min_frames4": {"constexpr int kMinFrames = 2;":
                    "constexpr int kMinFrames = 4;"},
    "target_1024": {"constexpr int kTargetWarps = 2048;":
                    "constexpr int kTargetWarps = 1024;"},
    "target_4096": {"constexpr int kTargetWarps = 2048;":
                    "constexpr int kTargetWarps = 4096;"},
    "max_cluster1": {"constexpr int kMaxCluster = 8;":
                     "constexpr int kMaxCluster = 1;"},
    "max_cluster2": {"constexpr int kMaxCluster = 8;":
                     "constexpr int kMaxCluster = 2;"},
    "max_cluster4": {"constexpr int kMaxCluster = 8;":
                     "constexpr int kMaxCluster = 4;"},
    "fma": {SQ4: "    return __fadd_rn(__fmaf_rn(y, y, __fmul_rn(x, x)),\n"
                 "                     __fmaf_rn(w, w, __fmul_rn(z, z)));\n",
            PAIR: "          acc = __fmaf_rn(w, L::sq(zb, ring[slot]), "
                  "acc);\n"},
    "always_checked": {"  if (K >= kRing && t0 >= kRing) {":
                       "  if (false) {"},
    # a probe, not a design (it misses phases 3 and 5): one pair a step in
    # place of J, the loads kept, to split the kernel's time
    "probe_one_pair": {
        "          if (CHECKED && (j > J || bp - j < 0)) continue;":
        "          if (j > 1 || (CHECKED && (j > J || bp - j < 0))) "
        "continue;"},
}


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("laplacian_variants.py needs a CUDA card")
    from repro_torch.kernels import build, ops
    print(card())
    libs = compile_all(build, VARIANTS, "laplacian_energy_kernel",
                       "laplacian_variants", SOURCE)
    dev = ops.resolve_device("cuda")
    g = torch.Generator(device=dev).manual_seed(10)
    shapes = {"refine": (cs.SESSIONS, cs.WINDOW, 128, cs.KNN),
              "edge": (1, cs.BUFFER + cs.TRAIN_BATCH, 128, cs.TRAIN_KNN),
              "lm": (cs.LM_LAP_B, cs.LM_LAP_T, cs.LM_D, cs.KNN)}
    args = {key: (cs.refine_inputs(g, dev, B, T, d, 1)[:2], k)
            for key, (B, T, d, k) in shapes.items()}
    for name, (lib, lines) in libs.items():
        print(f"{name}:\n  " + "\n  ".join(lines))
        use(build, lib, SOURCE)
        held(name, dev, ops, {"phase 3": cs.phase3, "phase 5": cs.phase5})
    def lap(a):
        return ops.laplacian_energy(*a[0], a[1])
    names = list(libs)
    for name in names + names[::-1]:
        use(build, libs[name][0], SOURCE)
        print(f"{name}: " + ", ".join(
            f"{key} {cs.device_ms(lap, a) * 1e3:.2f} us"
            for key, a in args.items()))


if __name__ == "__main__":
    main()
