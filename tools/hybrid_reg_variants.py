#!/usr/bin/env python3
"""The regularisers' backward kernel against the choices its design
rejected, and probes that split its time.

    python3 tools/hybrid_reg_variants.py     # from the repository root, one CUDA card

``csrc/hybrid_reg_bwd.cu`` tiles dz in 8 rows x 32 columns (a 256-thread
block a tile, a warp a row), stages 64 directions of the rows' weights and
of dirs at a time (the slab transposed, read as float4), and issues the
Laplacian half's loads with the staging's.  This script changes one
choice at a time, each in a copy of the source compiled beside it into
``build/hybrid_reg_variants/`` with the build's flags and ``-Xptxas -v``:

- ``threads_128``, ``threads_512``: tiles of 4 or 16 rows (blocks of 128
  or 512 threads);
- ``dir_chunk_32``: 32 directions staged at a time;
- ``lap_last``: the Laplacian half after the SW sums, its loads after the
  barriers;
- probes, not designs (they change the result, so they are timed and not
  held): ``probe_empty`` (the grid with an empty body: the launch floor),
  ``probe_no_lap`` (no Laplacian half in the fused launch),
  ``probe_no_gather`` (prior_q read at the row's own index, not by rank),
  ``probe_no_fma`` (no sums over the directions), ``probe_no_dirs`` (the
  slab not loaded).

For the source and each design it prints the kernels' registers and
spills and holds them to ``chip_smoke.py`` phase 5 (misses counted and
printed, not fatal), then times ``hybrid_reg_bwd`` and its one-half calls
``swd_rank_bwd`` and ``laplacian_energy_bwd`` at the edge learner's (1,
104, 128), M 32, k 3 and the LM step's (8, 16, 1,024), M 50, k 5
(``device_ms``), in the order source, variants, variants reversed,
source.  Prints the card's name and power limit first.
"""
from __future__ import annotations

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src"), os.path.join(ROOT, "tools")]

import chip_smoke as cs  # noqa: E402
from flash_bwd_variants import compile_all, use  # noqa: E402
from swd_variants import card, held  # noqa: E402

SOURCE = "hybrid_reg_bwd.cu"
THREADS = "constexpr int kThreads = 256;"
LAP_FIRST = ("    if (kLap && m0 == 0 && live) {\n"
             "      lap = lap_half(z, mask, g_tot, g_stride, i, j, T, d, K);\n"
             "    }\n")
STORE = ("    dz[static_cast<size_t>(i) * d + j] = kLap ? __fadd_rn(sw, lap) "
         ": sw;\n")
VARIANTS = {
    "threads_128": {THREADS: "constexpr int kThreads = 128;"},
    "threads_512": {THREADS: "constexpr int kThreads = 512;"},
    "dir_chunk_32": {"constexpr int kDirChunk = 64;":
                     "constexpr int kDirChunk = 32;"},
    "lap_last": {LAP_FIRST: "",
                 STORE: "    if (kLap) lap = lap_half(z, mask, g_tot, "
                        "g_stride, i, j, T, d, K);\n" + STORE},
    # probes, not designs (they miss phase 5): each drops one part
    "probe_empty": {
        "  const int lane = threadIdx.x % 32, rr = threadIdx.x / 32;\n":
        "  if (W > 0) return;\n"
        "  const int lane = threadIdx.x % 32, rr = threadIdx.x / 32;\n"},
    "probe_no_lap": {"    if (kLap && m0 == 0 && live) {":
                     "    if (false) {"},
    "probe_no_gather": {
        "prior_q[static_cast<size_t>(rk[s]) * M + m0 + e % mc]":
        "prior_q[static_cast<size_t>(row0 + e / mc) * M + m0 + e % mc]"},
    "probe_no_fma": {"for (int m = 0; m < m4; m += 4)":
                     "for (int m = 0; m < 0; m += 4)",
                     "for (int m = m4; m < mc; ++m) sw":
                     "for (int m = m4; m < 0; ++m) sw"},
    "probe_no_dirs": {"? dirs[static_cast<size_t>(m0 + m) * d + col0 + c]":
                      "? 1.0f"},
}


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("hybrid_reg_variants.py needs a CUDA card")
    from repro_torch.kernels import build, ops
    print(card())
    libs = compile_all(build, VARIANTS, "hybrid_reg_bwd",
                       "hybrid_reg_variants", SOURCE)
    dev = ops.resolve_device("cuda")
    g = torch.Generator(device=dev).manual_seed(22)
    args = {"edge": cs.hybrid_inputs(g, dev, ops, 1,
                                     cs.BUFFER + cs.TRAIN_BATCH, 128,
                                     cs.TRAIN_DIRS, cs.TRAIN_KNN, False),
            "lm": cs.hybrid_inputs(g, dev, ops, cs.LM_LAP_B, cs.LM_LAP_T,
                                   cs.LM_D, cs.LM_SW_DIRS, cs.KNN, True)}
    calls = {"hybrid_reg_bwd": lambda a: ops.hybrid_reg_bwd(*a),
             "swd_rank_bwd": lambda a: ops.swd_rank_bwd(*a[3:8]),
             "laplacian_energy_bwd": lambda a: ops.laplacian_energy_bwd(
                 a[0], a[1], a[8], a[2])}
    for name, (lib, lines) in libs.items():
        print(f"{name}:\n  " + "\n  ".join(lines))
        if not name.startswith("probe"):
            use(build, lib, SOURCE)
            held(name, dev, ops, {"phase 5": cs.phase5})
    names = list(libs)
    for name in names + names[::-1]:
        use(build, libs[name][0], SOURCE)
        print(f"{name}: " + ", ".join(
            f"{key} {what} {cs.device_ms(fn, a) * 1e3:.2f} us"
            for key, a in args.items() for what, fn in calls.items()))


if __name__ == "__main__":
    main()
