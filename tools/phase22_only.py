#!/usr/bin/env python3
"""Phase 22 of ``chip_smoke.py`` alone: phase 12's run (phase 18's step 0
reference), phase 18 (a) and phase 19 (d)'s first decode run in one
process, then the same training and decode by 2 spawned processes, two
logical shards of the card each, held to them bit for bit.

    python3 tools/phase22_only.py          # from the repository root, one CUDA card
    python3 tools/phase22_only.py --cpu    # a rehearsal on the CPU, smoke configs

Prints the card's name, power limit and compute mode (two processes on
one card need ``Default``), the build's seconds, every failed check
(``chip_smoke.check`` is replaced by a collector, so one run shows them
all) and phase 22's readings; exits 1 if a check failed.  With ``--cpu``
the configs are the smoke ones (``smoke_config``) at B 4 x S 64 and a
16-token prompt, the CUDA calls are stubbed, the profiles and phase 18's
elastic restore are skipped, and the launch checks fail by design (CPU
tensors run each kernel's plain version): every other check holds.
"""
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def rehearse_on_cpu():
    """Point phases 12, 18, 19 and 22 at the CPU and the smoke configs."""
    from repro_torch.configs import base
    os.environ.setdefault("OMP_NUM_THREADS", "2")
    torch.set_num_threads(2)
    real = base.get_config
    base.get_config = lambda name: base.smoke_config(real(name))
    for name in ("synchronize", "empty_cache", "reset_peak_memory_stats",
                 "set_sync_debug_mode"):
        setattr(torch.cuda, name, lambda *a, **kw: None)
    torch.cuda.max_memory_allocated = lambda *a, **kw: 0
    cs.CARD = "cpu"
    cs.device_ms = lambda fn, x, reps=40, spin_cycles=0: 0.0
    cs.profile_train_lm_step = lambda tr, p50: {}
    cs.lm18_elastic = lambda *a: {}
    cs.profile_decode_step = lambda *a: {
        "syncs": 0, "h2d": 0, "d2h": 0, "launches": 0, "idle_share": 0.0}
    cs.LM_TRAIN = (("qwen1.5-0.5b", None, 4, 64, 3, 2),) + cs.LM_TRAIN[1:]
    cs.LM18_TRAIN = ("qwen1.5-0.5b", None, 4, 64, 3, 2, (2, 2))
    cs.LM19_DECODE = (("qwen3-1.7b", None, None, 4, 16, 32, 4, (2, 2)),) \
        + cs.LM19_DECODE[1:]
    return "cpu"


def main():
    cpu = "--cpu" in sys.argv[1:]
    if not cpu:
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,"
                              "compute_mode", "--format=csv,noheader"],
                             capture_output=True, text=True).stdout)
    print(sys.version, torch.__version__, torch.version.cuda, flush=True)
    from repro_torch.kernels import build, ops
    if cpu:
        dev = rehearse_on_cpu()
    else:
        dev = ops.resolve_device("cuda")
        t0 = time.perf_counter()
        build.build_all()
        print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    fails = []
    cs.check = lambda cond, msg: cond or fails.append(msg)
    t0 = time.perf_counter()
    _, p12 = cs.lm_train_run(dev, ops, *cs.LM_TRAIN[0])
    _, p18 = cs.lm18_train(dev, ops, p12["loss_first"], p12["step_ms_p50"])
    cs.lm19_decode(dev, ops, cs.LM19_DECODE[0], dict.fromkeys(ops.KERNELS,
                                                               0))
    print(f"phases 12, 18 (a), 19 (d): {time.perf_counter() - t0:.1f} s",
          flush=True)
    launches, readings = cs.phase22(ops, p18["step_ms_p50"])
    print("failed checks:", *fails, sep="\n  ")
    print(json.dumps(readings))
    print("launches", launches)
    sys.exit(1 if fails else 0)


if __name__ == "__main__":
    main()
