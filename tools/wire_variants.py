#!/usr/bin/env python3
"""The grouped INT8 wire kernel against the choices its design rejected.

    python3 tools/wire_variants.py      # from the repository root, one CUDA card

``csrc/wire_roundtrip.cu`` runs every group of a launch as one 512-thread
block a row, two blocks an SM, holds a row of up to 16,384 floats in
registers (8 float4 a thread) so that it is read once, and is launched as
a programmatic dependent of the kernel before it.  This script changes
one choice at a time, each in a copy of the source compiled beside it
into ``build/wire_variants/`` with the build's flags and ``-Xptxas -v``:

- ``plain_launch``: launched after the kernel before it ends (its
  ``griddepcontrol.wait`` then returns at once);
- ``two_reads``: every row read twice (the min/max pass, then the row
  again from L2), the design before the grouped launch;
- ``threads_256``: 256 threads a block, 16 float4 a thread;
- ``threads_1024``: 1,024 threads a block, 4 float4 a thread, one block
  an SM.

For the source and each variant it prints the kernel's registers and
spills, holds it to ``chip_smoke.py`` phase 1 (misses counted and
printed, not fatal) and times ``wire_roundtrip_grouped`` over the tick's
eight buckets padded to 32 rows, alone and behind a PyTorch elementwise
kernel on each bucket (as in the tick, where the edge stage's last
kernel comes before it), with ``chip_smoke.device_ms``, in the order
source, variants, variants reversed, source.  Prints the card's name and
power limit first.
"""
from __future__ import annotations

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src"), os.path.join(ROOT, "tools")]

import chip_smoke as cs  # noqa: E402
from flash_bwd_variants import compile_all, use  # noqa: E402
from swd_variants import card, held  # noqa: E402

SOURCE = "wire_roundtrip.cu"
VARIANTS = {
    "plain_launch": {"  cfg.numAttrs = 1;\n": "  cfg.numAttrs = 0;\n"},
    "two_reads": {"  if (vec && n <= kRowMax) {": "  if (false) {"},
    "threads_256": {
        "constexpr int kThreads = 512;": "constexpr int kThreads = 256;",
        "constexpr int kUnitsPerThread = 8;":
        "constexpr int kUnitsPerThread = 16;"},
    "threads_1024": {
        "constexpr int kThreads = 512;": "constexpr int kThreads = 1024;",
        "constexpr int kUnitsPerThread = 8;":
        "constexpr int kUnitsPerThread = 4;",
        "__launch_bounds__(kThreads, 2)": "__launch_bounds__(kThreads, 1)"},
}


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("wire_variants.py needs a CUDA card")
    from repro_torch.configs.streamsplit_audio import CFG
    from repro_torch.kernels import build, ops
    print(card())
    libs = compile_all(build, VARIANTS, "wire_roundtrip", "wire_variants",
                       SOURCE)
    dev = ops.resolve_device("cuda")
    g = torch.Generator(device=dev).manual_seed(21)
    xs = [torch.randn(32, n, device=dev, generator=g)
          for n in cs.wire_widths(CFG)]

    def behind_torch_op(ys):
        return ops.wire_roundtrip_grouped([y * 1.0 for y in ys])

    def torch_op_alone(ys):
        return [y * 1.0 for y in ys]
    for name, (lib, lines) in libs.items():
        print(f"{name}:\n  " + "\n  ".join(lines))
        use(build, lib, SOURCE)
        held(name, dev, ops,
             {"phase 1": lambda dev, ops: cs.phase1(
                 CFG, dev, ops, *quant_pair())})
    ops_only = cs.device_ms(torch_op_alone, xs) * 1e3
    print(f"the eight elementwise kernels alone: {ops_only:.2f} us")
    names = list(libs)
    for name in names + names[::-1]:
        use(build, libs[name][0], SOURCE)
        alone = cs.device_ms(ops.wire_roundtrip_grouped, xs) * 1e3
        behind = cs.device_ms(behind_torch_op, xs) * 1e3
        print(f"{name}: grouped over the tick's 8 buckets {alone:.2f} us; "
              f"behind the elementwise kernels {behind:.2f} us "
              f"({behind - ops_only:.2f} more than those alone)")


def quant_pair():
    from repro_torch.quant.int8 import dequantize, quantize
    return dequantize, quantize


if __name__ == "__main__":
    main()
