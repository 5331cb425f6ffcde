#!/usr/bin/env python3
"""The InfoNCE kernels against the choices their design rejected.

    python3 tools/infonce_variants.py  # from the repository root, one CUDA card

``csrc/infonce_vneg.cu`` cuts each sample's negatives into the wrapper's
splits (``kernels/infonce_vneg.py`` ``splits``: about 128 blocks, at least
8 negatives a split), gives each split a block of 8 warps with 4 rows in
flight a warp, and merges the splits in a second kernel launched as a
programmatic dependent.  This script changes one choice at a time.  The
kernel's choices go into copies of the source compiled beside it into
``build/infonce_variants/`` with the build's flags and ``-Xptxas -v``:

- ``rows2``, ``rows8``: 2 or 8 rows in flight a warp;
- ``warps4``: split blocks of 4 warps;
- ``last_block``: each sample merged by the last of its splits to end (an
  integer ticket that split resets), no second kernel: the patch below
  adds the tickets and the split kernels' merge arguments;
- ``no_pdl``: the merge kernel launched after the first ends, not as its
  programmatic dependent.

The plan's choices are the wrapper's, so they run the source's library
with ``TARGET_BLOCKS`` changed: ``splits8`` (64 blocks: 8 splits of 33 at
(8, 264)), ``splits30`` (256: 30 of 9) and ``splits33`` (512, held at 8
negatives a split: 33 of 8).

For the source and each variant it prints the kernels' registers and
spills, holds them to ``chip_smoke.py`` phases 3 and 5 (misses counted and
printed, not fatal) and times the forward and the backward at the edge
learner's (8, 264, 128) (``device_ms``), in the order source, variants,
variants reversed, source.  Prints the card's name and power limit first.
"""
from __future__ import annotations

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

import chip_smoke as cs  # noqa: E402
from flash_bwd_variants import compile_all, use  # noqa: E402
from swd_variants import card, held  # noqa: E402

SOURCE = "infonce_vneg.cu"
RETURN_ON_ERROR = ("  if (err != cudaSuccess) return static_cast<int>(err);\n"
                   "  return static_cast<int>(launch_dependent(")
# each sample merged by the last of its splits to end
LAST_BLOCK = {
    "constexpr float kNegBig = -1e30f;\n": """\
constexpr float kNegBig = -1e30f;
constexpr int kMaxTickets = 4096;       // samples the ticket path takes

// one integer ticket per sample, 0 between calls (the last block resets it)
__device__ unsigned int g_tickets[kMaxTickets];

// Whether this block is the last of its sample's NS to arrive (all threads
// get the answer); the partials of the others are then visible to it
__device__ __forceinline__ bool last_to_arrive(int b, int NS) {
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(&g_tickets[b], 1u) == static_cast<unsigned>(NS - 1);
    if (last) g_tickets[b] = 0u;
  }
  __syncthreads();
  if (last) __threadfence();
  return last;
}
""",
    "infonce_fwd_split_kernel(const T* __restrict__ z,\n":
    "infonce_fwd_split_kernel(const T* __restrict__ z, const T* zp,\n"
    "                         float* loss, float* lse,\n",
    "      z, zn, part, B, N, d, NS, tau, vec);":
    "      z, zp, loss, lse, zn, part, B, N, d, NS, tau, vec);",
    "        ll;\n  }\n}\n":
    "        ll;\n  }\n"
    "  if (!last_to_arrive(b, NS) || warp != 0) return;\n"
    "  fwd_merge(part, loss, lse, b, B, NS,\n"
    "            positive(zb, zp + static_cast<size_t>(b) * d, d, lane, tau),\n"
    "            lane);\n}\n",
    "infonce_bwd_split_kernel(const T* __restrict__ z,\n":
    "infonce_bwd_split_kernel(const T* __restrict__ z, const T* zp,\n"
    "                         T* dz, T* dzp,\n",
    "      z, zn, lse, g, dzn, part, N, d, NS, tau, vec);":
    "      z, zp, dz, dzp, zn, lse, g, dzn, part, N, d, NS, tau, vec);",
    "    pb[j] = a;\n  }\n}\n":
    "    pb[j] = a;\n  }\n"
    "  if (!last_to_arrive(b, NS)) return;\n"
    "  const float p0m1 = __fsub_rn(\n"
    "      expf(__fsub_rn(block_positive(z, zp, b, d, tau), lse_b)), 1.0f);\n"
    "  bwd_dz_pos(z, dzp, b, d, c, p0m1);\n"
    "  bwd_dz(zp, part, dz, b, d, NS, c, p0m1);\n}\n",
    RETURN_ON_ERROR: RETURN_ON_ERROR.replace(
        "  if (err != cudaSuccess) return", "  return"),
    "!(tau > 0.0f);": "!(tau > 0.0f) || B > kMaxTickets;",
}
VARIANTS = {
    "rows2": {"constexpr int kRows = 4;": "constexpr int kRows = 2;"},
    "rows8": {"constexpr int kRows = 4;": "constexpr int kRows = 8;"},
    "warps4": {"constexpr int kWarps = 8;": "constexpr int kWarps = 4;"},
    "last_block": LAST_BLOCK,
    "no_pdl": {"cfg.numAttrs = 1;": "cfg.numAttrs = 0;"},
}
PLANS = {"splits8": 64, "splits30": 256, "splits33": 512}


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("infonce_variants.py needs a CUDA card")
    from repro_torch.kernels import build, infonce_vneg, ops
    print(card())
    libs = compile_all(build, VARIANTS, "infonce_", "infonce_variants",
                       SOURCE)
    dev = ops.resolve_device("cuda")
    g = torch.Generator(device=dev).manual_seed(6)
    z, zp, zn, cot = cs.infonce_inputs(g, dev, cs.TRAIN_BATCH,
                                       cs.N_SYN + cs.TRAIN_BATCH, 128)
    target = infonce_vneg.TARGET_BLOCKS
    runs = {name: (lib, target) for name, (lib, _) in libs.items()}
    runs.update({name: (libs["source"][0], blocks)
                 for name, blocks in PLANS.items()})

    def select(name):
        lib, blocks = runs[name]
        use(build, lib, SOURCE)
        infonce_vneg.TARGET_BLOCKS = blocks
    for name in runs:
        if name in libs:
            print(f"{name}:\n  " + "\n  ".join(libs[name][1]))
        select(name)
        print(f"{name}: {infonce_vneg.splits(z.shape[0], zn.shape[1])} "
              f"splits a sample")
        held(name, dev, ops, {"phase 3": cs.phase3, "phase 5": cs.phase5})
    names = list(runs)
    for name in names + names[::-1]:
        select(name)
        _, lse = ops.infonce_vneg_fwd(z, zp, zn, 0.1)
        fwd = cs.device_ms(lambda a: ops.infonce_vneg_fwd(*a, 0.1),
                           (z, zp, zn))
        bwd = cs.device_ms(lambda a: ops.infonce_vneg_bwd(*a, 0.1),
                           (z, zp, zn, lse, cot))
        print(f"{name}: fwd {fwd * 1e3:.2f} us, bwd {bwd * 1e3:.2f} us")
    infonce_vneg.TARGET_BLOCKS = target


if __name__ == "__main__":
    main()
