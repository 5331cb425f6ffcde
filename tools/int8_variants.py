#!/usr/bin/env python3
"""The per-tensor INT8 quantize against the choices its design rejected.

    python3 tools/int8_variants.py      # from the repository root, one CUDA card

``csrc/int8_quant.cu`` quantizes up to 16,384 elements in one block of up
to 1,024 threads, x held in registers, and above that in two passes, the
second a programmatic dependent of the first; a level is one
``cvt.rni.sat.s8.f32``.  This script changes one choice at a time, each
in a copy of the source compiled beside it into ``build/int8_variants/``
with the build's flags and ``-Xptxas -v``:

- ``rint_clip``: a level as ``rintf``, the NaN-keeping clip and a select
  of 0 for NaN (the same bits in three steps);
- ``pass2_plain``: pass 2 launched after pass 1 ends;
- ``two_passes``: no one-block path, every size in two passes (the
  design before the one-block path).

The wrapper passes the partials at every size while this runs, so that
``two_passes`` has them.  For the source and each variant it holds the
kernels to ``chip_smoke.py`` phase 7 (misses counted and printed, not
fatal) and times ``int8_quantize`` at the eight per-frame boundary shapes
(each, and summed) and at 2^24 + 3 (``device_ms``), in the order source,
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

SOURCE = "int8_quant.cu"
VARIANTS = {
    "rint_clip": {
        "  int q;\n"
        '  asm("cvt.rni.sat.s8.f32 %0, %1;"\n'
        '      : "=r"(q) : "f"(__fadd_rn(__fdiv_rn(v, scale), zero)));\n'
        "  return static_cast<int8_t>(q);\n":
        "  float q = rintf(__fadd_rn(__fdiv_rn(v, scale), zero));\n"
        "  q = min_nan(max_nan(q, -128.0f), 127.0f);\n"
        "  return q != q ? 0 : static_cast<int8_t>(static_cast<int>(q));\n"},
    "pass2_plain": {"  cfg.numAttrs = 1;\n": "  cfg.numAttrs = 0;\n"},
    "two_passes": {"constexpr long long kOneBlockMax =\n"
                   "    static_cast<long long>(kOneBlockThreads) * "
                   "kOneBlockPerThread;":
                   "constexpr long long kOneBlockMax = 0;"},
}

def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("int8_variants.py needs a CUDA card")
    from repro_torch.configs.streamsplit_audio import CFG
    from repro_torch.kernels import build, int8_quant, ops
    print(card())
    int8_quant.quantize_plan = lambda n: (2, int8_quant._PARTIALS)
    libs = compile_all(build, VARIANTS, "quantize", "int8_variants", SOURCE)
    dev = ops.resolve_device("cuda")
    g = torch.Generator(device=dev).manual_seed(9)
    xs = [torch.randn(*s, device=dev, generator=g)
          for s in cs.boundary_shapes(CFG)]
    big = torch.randn(2 ** 24 + 3, device=dev, generator=g)
    for name, (lib, lines) in libs.items():
        print(f"{name}:\n  " + "\n  ".join(lines))
        use(build, lib, SOURCE)
        held(name, dev, ops,
             {"phase 7": lambda dev, ops: cs.phase7(CFG, dev, ops)})
    names = list(libs)
    for name in names + names[::-1]:
        use(build, libs[name][0], SOURCE)
        each = [cs.device_ms(ops.int8_quantize, x) * 1e3 for x in xs]
        print(f"{name}: per frame {sum(each):.2f} us ("
              + ", ".join(f"{t:.2f}" for t in each) + "); 2^24+3 "
              f"{cs.device_ms(ops.int8_quantize, big) * 1e3:.2f} us")


if __name__ == "__main__":
    main()
