#!/usr/bin/env python3
"""Device time of the INT8 kernels' min/max fold, three ways, in one call.

    python3 tools/int8_fold_compare.py      # from the repository root, one CUDA card

``csrc/wire_roundtrip.cu`` and ``csrc/int8_quant.cu`` fold min and max
with ``min_nan``/``max_nan``, the PTX ``min.NaN.f32``/``max.NaN.f32``
instructions, so a NaN element reaches scale and zero as it does in the
plain versions.  This script builds two variants of each source beside
them, into ``build/int8_fold/``:

- ``fminf``: the fold as ``fminf``/``fmaxf``, which drop NaN (and the
  wire's clip as ``fminf(fmaxf(q, -128), 127)``; ``int8_quant.cu``'s
  level is one saturating convert, which has no clip to patch);
- ``select``: NaN kept by a select on ``a != a`` around ``fminf``.

It holds the sources' kernels and the ``select`` variant bitwise against
their plain versions (``chip_smoke.py`` phases 1 and 7), then times
``wire_roundtrip`` at (32, n) for the five serving widths (summed) and
at (256, 12800), and ``int8_quantize`` at the eight per-frame boundary
shapes (summed) and at 2^24 + 3, each variant twice in the order
fminf, select, source, source, select, fminf, with ``chip_smoke``'s
``device_ms``.  Prints the card's name and power limit first.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

MIN_NAN = '  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));'
MAX_NAN = '  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));'
VARIANTS = {
    "fminf": {MIN_NAN: "  r = fminf(a, b);", MAX_NAN: "  r = fmaxf(a, b);",
              "  q = min_nan(max_nan(q, -128.0f), 127.0f);":
              "  q = fminf(fmaxf(q, -128.0f), 127.0f);"},
    "select": {MIN_NAN: "  r = a != a ? a : (b != b ? b : fminf(a, b));",
               MAX_NAN: "  r = a != a ? a : (b != b ? b : fmaxf(a, b));"},
}
SOURCES = ("wire_roundtrip.cu", "int8_quant.cu")


def variant_libs(build):
    """{variant: {source: library path}}, "source" being the sources as
    they are; the variants are compiled with the same flags, all at
    once."""
    out_dir = os.path.join(ROOT, "build", "int8_fold")
    os.makedirs(out_dir, exist_ok=True)
    jobs = {}
    for name, subs in VARIANTS.items():
        for src in SOURCES:
            text = (build.CSRC / src).read_text()
            for old, new in subs.items():
                if old in text:
                    text = text.replace(old, new)
            cu = os.path.join(out_dir, f"{name}-{src}")
            with open(cu, "w") as f:
                f.write(text)
            jobs[(name, src)] = cu

    def nvcc(cu):
        so = cu[:-3] + ".so"
        subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", so, cu],
                       check=True, capture_output=True, text=True)
        return so

    with ThreadPoolExecutor(len(jobs)) as pool:
        built = dict(zip(jobs, pool.map(nvcc, jobs.values())))
    libs = {"source": {src: str(build.build(src)) for src in SOURCES}}
    for (name, src), so in built.items():
        libs.setdefault(name, {})[src] = so
    return libs


def use(build, paths):
    """Make the kernel wrappers launch the libraries at ``paths``."""
    for src, so in paths.items():
        lib = ctypes.CDLL(so)
        for fn, (argtypes, restype) in build.SIGNATURES[src].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        build._loaded[src] = lib


def main():
    if not torch.cuda.is_available():
        cs.fail("torch sees no CUDA device")
    from repro_torch.configs.streamsplit_audio import CFG
    from repro_torch.kernels import build, ops
    from repro_torch.quant.int8 import dequantize, quantize
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip())
    dev = ops.resolve_device("cuda")
    libs = variant_libs(build)
    for name in ("source", "select"):
        use(build, libs[name])
        cs.phase1(CFG, dev, ops, dequantize, quantize)
        cs.phase7(CFG, dev, ops)
        print(f"{name}: bitwise == plain versions")
    g = torch.Generator(device=dev).manual_seed(3)
    wire_x = [torch.randn(32, n, device=dev, generator=g)
              for n in sorted(set(cs.wire_widths(CFG)))]
    wire_big = torch.randn(256, 12800, device=dev, generator=g)
    quant_x = [torch.randn(*s, device=dev, generator=g)
               for s in cs.boundary_shapes(CFG)]
    quant_big = torch.randn(2 ** 24 + 3, device=dev, generator=g)
    for name in ("fminf", "select", "source", "source", "select", "fminf"):
        use(build, libs[name])
        wire = sum(cs.device_ms(ops.wire_roundtrip, x) for x in wire_x)
        quant = sum(cs.device_ms(ops.int8_quantize, x) for x in quant_x)
        print(f"{name}: wire_roundtrip (32, n) summed over 5 widths "
              f"{wire * 1e3:.2f} us, (256, 12800) "
              f"{cs.device_ms(ops.wire_roundtrip, wire_big) * 1e3:.2f} us; "
              f"int8_quantize summed over 8 per-frame shapes "
              f"{quant * 1e3:.2f} us, 2^24+3 "
              f"{cs.device_ms(ops.int8_quantize, quant_big) * 1e3:.2f} us")


if __name__ == "__main__":
    main()
