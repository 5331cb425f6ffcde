#!/usr/bin/env python3
"""The flash forward kernel against the tilings its design rejected.

    python3 tools/flash_fwd_variants.py      # from the repository root, one CUDA card

``csrc/flash_attention.cu`` launches its forward at hd 64 with 64 query
rows (4 warps) and 32-key tiles, at hd 128 with 128 rows (8 warps) and
32-key tiles, every warp splitting its k and v fragments as they load,
and chains the score product over the head dim in the tensor cores.
This script changes one choice at a time, each in a copy of the source
compiled beside it into ``build/flash_fwd_variants/`` with the build's
flags and ``-Xptxas -v``:

- ``bk64``: hd 64 with 64-key tiles (96 KB of shared memory, two blocks
  an SM, against three);
- ``bq128``: hd 64 with 128 query rows (8 warps) a block;
- ``presplit``: k and v tiles split once as they land (hi in place, lo
  beside it) instead of in every warp, at hd 64 and at hd 128 (with 64
  query rows there: 128 would take 256 KB of shared memory);
- ``hd128_bq64``: hd 128 with 64 query rows (4 warps);
- ``hd128_bk64``: hd 128 with 64 query rows and 64-key tiles;
- ``rounded_scores``: the forward's score product summed 8 columns at a
  time in the tensor cores, each step joined by a rounded float32 add.

For the source and each variant it prints the forward kernels' registers
and spills, holds them to ``chip_smoke.py`` phase 9 (failures counted and
printed, not fatal) and times the kernel at both tiers' layers
(``device_ms``) beside ``scaled_dot_product_attention``, in the order
source, variants, variants reversed, source.  Prints the card's name and
power limit first.
"""
from __future__ import annotations

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

import chip_smoke as cs  # noqa: E402
from flash_bwd_variants import compile_all, use  # noqa: E402

HD64 = "launch_fwd<64, 64, 32, false>("
HD128 = "launch_fwd<128, 128, 32, false>("
VARIANTS = {
    "bk64": {HD64: "launch_fwd<64, 64, 64, false>("},
    "bq128": {HD64: "launch_fwd<64, 128, 32, false>("},
    "presplit": {HD64: "launch_fwd<64, 64, 32, true>(",
                 HD128: "launch_fwd<128, 64, 32, true>("},
    "hd128_bq64": {HD128: "launch_fwd<128, 64, 32, false>("},
    "hd128_bk64": {HD128: "launch_fwd<128, 64, 64, false>("},
    "rounded_scores": {"product_t<KD, KD>(sc, ": "product_t<KD, 1>(sc, "},
}


def fwd_times(dev, ops, sdpa):
    """{tier: kernel ms} at the two tiers' layers, and SDPA's once."""
    import torch.nn.functional as F
    g = cs.torch.Generator(device=dev).manual_seed(10)
    out = {}
    for tier, shape in cs.FLASH_TIMED.items():
        args = cs.flash_inputs(g, dev, *shape)
        out[tier] = cs.device_ms(lambda a: ops.flash_attention_fwd(*a), args)
        if tier not in sdpa:
            sdpa[tier] = cs.device_ms(lambda a: F.scaled_dot_product_attention(
                *a, is_causal=True, enable_gqa=True), args)
    return out


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("flash_fwd_variants.py needs a CUDA card")
    from repro_torch.kernels import build, ops
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    libs = compile_all(build, VARIANTS, "flash_fwd", "flash_fwd_variants")
    failures = []

    def record(cond, msg):
        if not cond:
            failures.append(msg)
            print(f"  phase 9 miss: {msg}")
    cs.check = record
    dev = ops.resolve_device("cuda")
    for name, (lib, lines) in libs.items():
        print(f"{name}:\n  " + "\n  ".join(lines))
        use(build, lib)
        before = len(failures)
        cs.phase9(dev, ops)
        print(f"{name}: {len(failures) - before} phase 9 checks missed")
    names, sdpa = list(libs), {}
    for name in names + names[::-1]:
        use(build, libs[name][0])
        times = fwd_times(dev, ops, sdpa)
        print(f"{name}: " + "; ".join(
            f"{tier} {ms * 1e3:.2f} us ({ms / sdpa[tier]:.3f}x SDPA's "
            f"{sdpa[tier] * 1e3:.2f})" for tier, ms in times.items()))


if __name__ == "__main__":
    main()
