#!/usr/bin/env python3
"""The flash backward kernels against the variants their design rejected.

    python3 tools/flash_bwd_variants.py      # from the repository root, one CUDA card

``csrc/flash_attention.cu`` makes seven choices in its backward kernels
that this script undoes one at a time, each in a copy of the source
compiled beside it into ``build/flash_bwd_variants/`` with the build's
flags and ``-Xptxas -v``:

- ``cvt``: operands rounded to TF32 by ``cvt.rna.tf32.f32`` instead of the
  two integer operations (the same bits);
- ``chained``: the sums over a whole sequence chained through the tensor
  cores' accumulator instead of a rounded float32 add a tile (dv in
  registers at hd 128, as the accumulator has to be);
- ``no_presplit``: dk/dv at hd <= 64 with every warp splitting its
  fragments as they load, instead of each streamed tile split once;
- ``dv_in_registers``: dk/dv at hd 128 with dv in registers and 32 queries
  a tile, instead of dv in shared memory and 16;
- ``dp_join_1``, ``dp_chained``: dp's sums over the head dim joined by a
  rounded add every 8 columns, or chained over all of it, instead of
  every 16;
- ``dq_one_block``: dq launch-bounded for one block an SM, which lifts
  ptxas's register cap at hd <= 64 (168, three blocks of 128 threads);
- ``dq_bk16``, ``dkv_bq16``: dq with 16-key tiles at hd 64 and 128, dk/dv
  with 16-query tiles at hd 64 (fewer registers for the score tiles).

For the source and each variant it prints the backward kernels' registers
and spills, holds them to ``chip_smoke.py`` phase 11 (failures counted and
printed, not fatal) and times dq, dk/dv and the pair at both tiers'
layers with ``chip_smoke.bwd_kernel_times``, in the order source,
variants, variants reversed, source.  Prints the card's name and power
limit first.
"""
from __future__ import annotations

import ctypes
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

import chip_smoke as cs  # noqa: E402

SOURCE = "flash_attention.cu"
ROUND_INT = "  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;\n"
TILE_SUM = """    float x[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int kk = 0; kk < K; ++kk) {
      FragB b;
      load_b(b, y, 8 * kk, 8 * nd, g, t);
      mma3(x, a[kk], b);
    }
    acc.add(nd, x);
"""
DKV_128 = "launch_bwd_dkv<128, 128, 16, false, true>("
DQ_PRODUCTS = "product_t<KD, KD, 2>(sd, {qop, oop}"
DKV_PRODUCTS = "product_t<KD, KD, 2>(sd, {kop, vop}"
DQ_BOUNDS = "__launch_bounds__(2 * BQ)\nflash_bwd_dq_kernel("
VARIANTS = {
    "cvt": {ROUND_INT: '  uint32_t r;\n  asm("cvt.rna.tf32.f32 %0, %1;" : '
                       '"=r"(r) : "f"(x));\n  return r;\n'},
    "chained": {TILE_SUM: TILE_SUM.replace(
                    "float x[4] = {0.0f, 0.0f, 0.0f, 0.0f};",
                    "float (&x)[4] = acc.v[nd];").replace(
                    "    acc.add(nd, x);\n", ""),
                DKV_128: "launch_bwd_dkv<128, 128, 16, false, false>("},
    "no_presplit": {f"launch_bwd_dkv<{hd}, 64, 32, true, false>(":
                    f"launch_bwd_dkv<{hd}, 64, 32, false, false>("
                    for hd in (16, 32, 64)},
    "dv_in_registers": {DKV_128: "launch_bwd_dkv<128, 128, 32, false, false>("},
    "dp_join_1": {DQ_PRODUCTS: DQ_PRODUCTS.replace(", 2>", ", 1>"),
                  DKV_PRODUCTS: DKV_PRODUCTS.replace(", 2>", ", 1>")},
    "dp_chained": {DQ_PRODUCTS: DQ_PRODUCTS.replace(", 2>", ">"),
                   DKV_PRODUCTS: DKV_PRODUCTS.replace(", 2>", ">")},
    "dq_one_block": {DQ_BOUNDS: DQ_BOUNDS.replace("(2 * BQ)", "(2 * BQ, 1)")},
    "dq_bk16": {"launch_bwd_dq<64, 64, 32>(": "launch_bwd_dq<64, 64, 16>(",
                "launch_bwd_dq<128, 128, 32>(": "launch_bwd_dq<128, 128, 16>("},
    "dkv_bq16": {"launch_bwd_dkv<64, 64, 32, true, false>(":
                 "launch_bwd_dkv<64, 64, 16, true, false>("},
}
ENTRY = re.compile(r"Compiling entry function '(\S+)'")


def patched(text, name, subs):
    """``text`` with every {old: new} of ``subs`` replaced (each ``old``
    must occur), ``name`` naming the variant in the error."""
    for old, new in subs.items():
        if old not in text:
            raise RuntimeError(f"{name}: the source no longer has {old!r}")
        text = text.replace(old, new)
    return text


def compile_all(build, variants=None, kernels="flash_bwd",
                out="flash_bwd_variants", source=SOURCE, suffix=""):
    """{name: (library path, ptxas lines of the kernels whose names hold
    ``kernels``)} for ``csrc/<source>`` and every variant of it
    (``VARIANTS`` unless given: {name: {old text: new text}}), each copy
    ending in ``suffix``, compiled at once into ``build/<out>/``."""
    out_dir = os.path.join(ROOT, "build", out)
    os.makedirs(out_dir, exist_ok=True)
    text = (build.CSRC / source).read_text()
    jobs = {"source": text + suffix}
    for name, subs in (VARIANTS if variants is None else variants).items():
        jobs[name] = patched(text, name, subs) + suffix

    def one(item):
        name, src_text = item
        src = os.path.join(out_dir, f"{name}.cu")
        lib = os.path.join(out_dir, f"{name}.so")
        with open(src, "w") as f:
            f.write(src_text)
        r = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v",
                            "-o", lib, src], capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{r.stderr}")
        lines, entry = [], None
        for line in r.stderr.splitlines():
            if m := ENTRY.search(line):
                entry = m.group(1) if kernels in m.group(1) else None
            elif entry and ("spill" in line or "registers" in line):
                lines.append(f"{entry[-60:]}: {line.split(':')[-1].strip()}")
        return name, (lib, lines)
    with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
        return dict(pool.map(one, jobs.items()))


def use(build, lib, source=SOURCE):
    """Make the wrappers of ``csrc/<source>`` launch from ``lib``."""
    so = ctypes.CDLL(lib)
    for fn, (argtypes, restype) in build.SIGNATURES[source].items():
        getattr(so, fn).argtypes = argtypes
        getattr(so, fn).restype = restype
    build._loaded[source] = so


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("flash_bwd_variants.py needs a CUDA card")
    from repro_torch.kernels import build, ops
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    libs = compile_all(build)
    failures = []

    def record(cond, msg):
        if not cond:
            failures.append(msg)
            print(f"  phase 11 miss: {msg}")
    cs.check = record
    dev = ops.resolve_device("cuda")
    for name, (lib, lines) in libs.items():
        print(f"{name}:\n  " + "\n  ".join(lines))
        use(build, lib)
        before = len(failures)
        cs.phase11(dev, ops)
        print(f"{name}: {len(failures) - before} phase 11 checks missed")
    names = list(libs)
    for name in names + names[::-1]:
        use(build, libs[name][0])
        times = cs.bwd_kernel_times(dev, ops)
        print(f"{name}: " + "; ".join(
            f"{tier} dq {r['flash_attention_bwd_dq']['ms'] * 1e3:.2f} us, "
            f"dk/dv {r['flash_attention_bwd_dkv']['ms'] * 1e3:.2f} us, pair "
            f"{r['flash_attention_bwd_dq']['pair_ms'] * 1e3:.2f} us"
            for tier, r in times.items()))


if __name__ == "__main__":
    main()
