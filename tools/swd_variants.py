#!/usr/bin/env python3
"""The SWD kernels against the choices their design rejected.

    python3 tools/swd_variants.py      # from the repository root, one CUDA card

``csrc/swd.cu`` runs ``swd_sessions`` as one block a session whose 256
threads each keep a 7 x 4 tile of (frame, direction) sums over all of d,
two blocks an SM, and sorts each column in registers, 16 values a lane
(8 lanes a column at the refine round's W = 100); ``swd_rank_fwd`` runs a
block a direction, sorts on 32 lanes and sums the loss in a second kernel
launched as a programmatic dependent.  This script changes one choice at
a time, each in a copy of the source compiled beside it into
``build/swd_variants/`` with the build's flags and ``-Xptxas -v``:

- ``tile_4x4``, ``tile_8x4``: 4 or 8 frames a thread (64 or 128 frames a
  pass, against 112); ``tile_7x2``: 2 directions a thread (32 a pass,
  against 64);
- ``one_block_an_sm``: ``__launch_bounds__(256, 1)``, so the projection may
  take more than 128 registers;
- ``values4``, ``values8``: a column sorted 4 or 8 values a lane (32 or 16
  lanes at W = 100: more shuffle stages, fewer in a thread);
- ``rank_lanes16``, ``rank_lanes8``: ``swd_rank_fwd``'s column on 16 or 8
  lanes (8 or 16 values a lane at W = 104, fewer shuffle stages);
- ``rank_last_block``: the loss summed by the last direction block to end
  (an integer ticket that block resets), no second kernel: the patch below
  adds the ticket and the kernel's ``loss`` argument;
- ``rank_no_pdl``: the loss kernel launched after the first ends, not as
  its programmatic dependent;
- ``probe_no_staging``, ``probe_no_projection``, ``probe_no_sort``:
  ``swd_sessions`` without the copies of z and the directions, without the
  product or without the sort; not designs (they miss phase 3), but what
  each stage costs.

For the source and each variant it prints the kernels' registers and
spills and the blocks of ``swd_sessions`` an SM holds at the refine shape
(a query appended to every copy, ``OCCUPANCY``), holds them to
``chip_smoke.py`` phases 3 and 5 (misses counted and printed, not fatal)
and times ``swd_sessions`` at the refine round's (256, 100, 128), M 50,
and ``swd_rank_fwd``/``_bwd`` at the edge learner's (104, 128), M 32 and
the LM step's (128, 1,024), M 50 (``device_ms``), in the order source,
variants, variants reversed, source.  Prints the card's name and power
limit first.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import traceback

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

import chip_smoke as cs  # noqa: E402
from flash_bwd_variants import compile_all, use  # noqa: E402

SOURCE = "swd.cu"
RANK_KERNEL = ("template <int V>\n"
               "__global__ void __launch_bounds__(kRankThreads)")
# swd_rank_fwd's loss summed by the last direction block to end
RANK_LAST_BLOCK = {
    RANK_KERNEL: """\
// Whether this block is the last of the grid's to end (all threads get the
// answer; the others' partials are then visible to it), by an integer
// ticket that the last block resets to 0 for the next launch
__device__ unsigned int g_rank_ticket;

__device__ __forceinline__ bool last_to_end() {
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(&g_rank_ticket, 1u) == gridDim.x - 1;
    if (last) g_rank_ticket = 0u;
  }
  __syncthreads();
  if (last) __threadfence();
  return last;
}

""" + RANK_KERNEL,
    "int* __restrict__ rank, float* partial, int W, int d,":
    "int* __restrict__ rank, float* partial, float* loss, int W, int d,",
    "    if (tid == 0) partial[m] = acc;\n  }\n}\n":
    "    if (tid == 0) partial[m] = acc;\n  }\n"
    "  if (last_to_end() && tid == 0) {\n"
    "    sum_partials(partial, loss, M,\n"
    "                 static_cast<float>(W) * static_cast<float>(M));\n"
    "  }\n}\n",
    "x, dirs, prior_q, proj, rank, partial, W, d, M, DC, vec);":
    "x, dirs, prior_q, proj, rank, partial, loss, W, d, M, DC, vec);",
    "  if (err != cudaSuccess) return err;\n  // programmatic dependent":
    "  return err;\n  // programmatic dependent",
}
# appended to every copy: the blocks of swd_sessions an SM holds at a shape
# on the current device (-1 for a refused shape, -err for a CUDA error)
OCCUPANCY = """
extern "C" int swd_sessions_blocks_per_sm(int W, int d, int M) {
  return with_sessions(W, [&](auto k) {
    using K = decltype(k);
    if constexpr (std::is_same_v<K, std::nullptr_t>) {
      return -1;
    } else {
      int DC = 0, MG = 0, n = 0;
      size_t smem = 0;
      if (!sessions_plan(W, d, M, K::LANES * K::V, &DC, &MG, &smem)) {
        return -1;
      }
      cudaError_t err = allow_smem(swd_sessions_kernel<K::V, K::LANES>, smem);
      if (err == cudaSuccess) {
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &n, swd_sessions_kernel<K::V, K::LANES>, kThreads, smem);
      }
      return err == cudaSuccess ? n : -static_cast<int>(err);
    }
  });
}
"""
VARIANTS = {
    "tile_4x4": {"constexpr int kTR = 7;": "constexpr int kTR = 4;"},
    "tile_8x4": {"constexpr int kTR = 7;": "constexpr int kTR = 8;"},
    "tile_7x2": {"constexpr int kDirsPerPass = 64;":
                 "constexpr int kDirsPerPass = 32;"},
    "one_block_an_sm": {"__launch_bounds__(kThreads, 2)":
                        "__launch_bounds__(kThreads, 1)"},
    "values4": {"constexpr int kValuesPerLane = 16;":
                "constexpr int kValuesPerLane = 4;"},
    "values8": {"constexpr int kValuesPerLane = 16;":
                "constexpr int kValuesPerLane = 8;"},
    "rank_lanes16": {"constexpr int kRankLanes = 32;":
                     "constexpr int kRankLanes = 16;"},
    "rank_lanes8": {"constexpr int kRankLanes = 32;":
                    "constexpr int kRankLanes = 8;"},
    "rank_last_block": RANK_LAST_BLOCK,
    "rank_no_pdl": {"cfg.numAttrs = 1;": "cfg.numAttrs = 0;"},
    # probes, not designs (they miss phase 3): swd_sessions without one of
    # its three stages, to split its time
    "probe_no_staging": {
        "      stage(zs, zsrc, W, d, c0, cw, pitch, vec);\n"
        "      stage(ds, dirs + static_cast<size_t>(m0) * d, mg, d, c0, cw, "
        "pitch,\n            vec);\n": ""},
    "probe_no_projection": {
        "          project_pass(zs, ds, cols, pitch, cp, cw4, r0, g0, W, mg, "
        "c0 == 0);\n": ""},
    "probe_no_sort": {"      warp_sort<V, LANES, false>(v, unused, lane);\n":
                      ""},
}


def held(name, dev, ops, phases):
    """Run ``phases`` ({label: fn}) with ``cs.check`` counting misses ->
    the number of misses (an exception counts as one)."""
    misses = []

    def record(cond, msg):
        if not cond:
            misses.append(msg)
            print(f"  miss: {msg[:200]}")
    cs.check = record
    for label, fn in phases.items():
        try:
            fn(dev, ops)
        except Exception:                      # a refused shape, a fault
            misses.append(label)
            print(f"  {label} raised:\n" + traceback.format_exc(limit=2))
    print(f"{name}: {len(misses)} checks of phases "
          f"{', '.join(phases)} missed")
    return len(misses)


def card():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


def blocks_per_sm(build, W, d, M):
    """The appended ``OCCUPANCY`` query of the library in use."""
    fn = build._loaded[SOURCE].swd_sessions_blocks_per_sm
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_int
    return fn(W, d, M)


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("swd_variants.py needs a CUDA card")
    from repro_torch.kernels import build, ops
    print(card())
    libs = compile_all(build, VARIANTS, "swd_", "swd_variants", SOURCE,
                       OCCUPANCY)
    dev = ops.resolve_device("cuda")
    g = torch.Generator(device=dev).manual_seed(4)
    z, _, dirs, pq = cs.refine_inputs(g, dev, cs.SESSIONS, cs.WINDOW, 128,
                                      cs.N_DIRS)
    rank_in = {
        "edge": cs.swd_train_inputs(g, dev, cs.BUFFER + cs.TRAIN_BATCH, 128,
                                    cs.TRAIN_DIRS),
        "lm": cs.swd_train_inputs(g, dev, cs.LM_SW_POINTS, cs.LM_D,
                                  cs.LM_SW_DIRS)}
    one = torch.ones((), device=dev)
    for name, (lib, lines) in libs.items():
        print(f"{name}:\n  " + "\n  ".join(lines))
        use(build, lib, SOURCE)
        print(f"{name}: swd_sessions blocks an SM at the refine shape: "
              f"{blocks_per_sm(build, cs.WINDOW, 128, cs.N_DIRS)}")
        held(name, dev, ops, {"phase 3": cs.phase3, "phase 5": cs.phase5})
    names = list(libs)
    for name in names + names[::-1]:
        use(build, libs[name][0], SOURCE)
        parts = [f"sessions {cs.device_ms(lambda a: ops.swd_sessions(*a), (z, dirs, pq)) * 1e3:.2f} us"]
        for key, args in rank_in.items():
            _, proj, rank = ops.swd_rank_fwd(*args)
            fwd = cs.device_ms(lambda a: ops.swd_rank_fwd(*a), args)
            bwd = cs.device_ms(lambda a: ops.swd_rank_bwd(*a),
                               (one, proj, rank, args[2], args[1]))
            parts.append(f"rank {key} fwd {fwd * 1e3:.2f} bwd "
                         f"{bwd * 1e3:.2f} us")
        print(f"{name}: " + "; ".join(parts))


if __name__ == "__main__":
    main()
