#!/usr/bin/env python3
"""Phase 21 of ``chip_smoke.py`` alone: phase 17 (b)'s 2-shard fleet in
one process, then the same fleet refined by 2 spawned processes on the
card, held to it.

    python3 tools/phase21_only.py        # from the repository root, one CUDA card

Prints the card's name, power limit and compute mode (two processes on
one card need ``Default``), the build's seconds, every failed check of
phase 21 (``chip_smoke.check`` is replaced by a collector, so one run
shows them all) and its readings; exits 1 if a check failed.
"""
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main():
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,"
                          "compute_mode", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout)
    print(sys.version, torch.__version__, torch.version.cuda, flush=True)
    from repro_torch.configs.streamsplit_audio import CFG
    from repro_torch.distributed.sharding import count_collectives
    from repro_torch.kernels import build, ops
    ops.resolve_device("cuda")
    t0 = time.perf_counter()
    build.build_all()
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    fails = []
    cs.check = lambda cond, msg: cond or fails.append(msg)
    be = cs.sharded_refine_backend(CFG, 2, "cuda", cs.init_linear_head)
    sids = [be.admit() for _ in range(cs.SESSIONS)]
    cs.prefill(be, np.arange(cs.SESSIONS), np.random.default_rng(1))
    cs.zero_counts(ops)
    with count_collectives() as coll:
        outs, ms = cs.refine_rounds(be, cs.SHARD_ROUNDS)
    print("one process x 2 shards launches", cs.read_counts(ops))
    two = {"sids": sids, "outs": outs, "state": cs.state_of(be),
           "collectives": coll, "round_ms": cs.pct(ms[1:])}
    launches, readings = cs.phase21(ops, two)
    print("failed checks:", *fails, sep="\n  ")
    print(json.dumps(readings))
    print("launches", launches)
    sys.exit(1 if fails else 0)


if __name__ == "__main__":
    main()
