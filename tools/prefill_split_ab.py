"""The batch-1 prompt split over 'data' on the card: the flash forward's
query offset held and timed, phase 19 (d)'s two batch-1 runs, and their
prefill timed against another checkout's.

    python3 tools/prefill_split_ab.py               # repository root, one card
    python3 tools/prefill_split_ab.py build/parent  # and the A/B against it
    python3 tools/prefill_split_ab.py --cpu         # a CPU rehearsal

In this checkout, in one process: builds the kernels, holds the float32
and bf16 forwards with a query offset against their plain versions at
``chip_smoke.FLASH_OFFSET_CASES`` (``chip_smoke.hold_flash_offset``: the
blocks at offsets 0 and 2,048 bitwise one offset-free launch), phase 19's
flash holds and times (``hold_lm19_flash``: zamba2-1.2b's split block,
its plain version and SDPA with a boolean mask), the bf16 forward's at
that block (``lm20_offset_times``), and phase 19 (d)'s zamba2-1.2b and
mamba2-780m runs at batch 1 on (2, 2) (``lm19_decode``, every gate).
``chip_smoke.check`` is replaced by a collector, so one run shows every
failed check; exits 1 if one failed.

With a checkout (unpack the parent with ``git archive HEAD | tar -x -C
build/parent``) it then times those two runs' prefill in turns, that
checkout, this one, this one, that checkout: each turn a process of its
own that builds its checkout's kernels, lays full-width random weights
(seeded) out on (2, 2) under ``rules_for(batch=1, kind="decode")``, runs
a warm-up prefill of the 4,096-token prompt and ``TIMED`` timed ones
(host clock, each ended by a sync) and prints their ms and the flash
launches a prefill.  Prints the card's name and power limit first.  With
``--cpu`` the configs are the smoke ones (``smoke_config``), the prompt
16 tokens, the CUDA calls stubbed; the launch checks fail there by design
(CPU tensors run each kernel's plain version).
"""
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMED = 5
RUNS = ("zamba2-1.2b", "mamba2-780m")


def on_path(root):
    sys.path[:0] = [root, os.path.join(root, "src")]


def rehearse_on_cpu(cs):
    """Point the phases at the CPU and the smoke configs."""
    import torch

    from repro_torch.configs import base
    torch.set_num_threads(2)
    real = base.get_config
    base.get_config = lambda name: base.smoke_config(real(name))
    for name in ("synchronize", "empty_cache", "reset_peak_memory_stats",
                 "set_sync_debug_mode"):
        setattr(torch.cuda, name, lambda *a, **kw: None)
    torch.cuda.max_memory_allocated = lambda *a, **kw: 0
    cs.CARD = "cpu"
    cs.device_ms = lambda fn, x, reps=40, spin_cycles=0: 0.0
    cs.profile_decode_step = lambda *a: {
        "syncs": 0, "h2d": 0, "d2h": 0, "launches": 0, "idle_share": 0.0}
    cs.LM19_DECODE = tuple(
        spec[:4] + (16, 64) + spec[6:] if spec[3] == 1 else spec
        for spec in cs.LM19_DECODE)
    # the smoke configs' 4 heads of 16
    cs.LM19_FLASH_TRAIN = ((2, 4, 4, 64, 64, 16),)
    cs.LM19_FLASH_PREFILL = ((1, 4, 4, 32, 64, 16, 32),)
    return "cpu"


def batch1_specs(cs):
    return [s for s in cs.LM19_DECODE if s[0] in RUNS and s[3] == 1]


def hold(cpu):
    """This checkout's holds and phase 19 (d)'s batch-1 runs -> failed
    checks."""
    on_path(ROOT)
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import build, ops
    if cpu:
        dev = rehearse_on_cpu(cs)
    else:
        dev = ops.resolve_device("cuda")
        t0 = time.perf_counter()
        build.build_all()
        print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    fails = []
    cs.check = lambda cond, msg: cond or fails.append(msg)
    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(9)
    for dt in (torch.float32, torch.bfloat16):
        worst, ratio = cs.hold_flash_offset(g, dev, ops, dt)
        print(f"offset forward {dt}: max |err| {worst:.3e}, bf16 per-element"
              f" share {ratio:.3f}", flush=True)
    worst, times = cs.hold_lm19_flash(dev, ops)
    print(json.dumps({"lm19_flash": times, "worst": worst}), flush=True)
    if not cpu:
        print(json.dumps({"bf16_offset": cs.lm20_offset_times(
            g, dev, ops)}), flush=True)
    launches = dict.fromkeys(ops.KERNELS, 0)
    for spec in batch1_specs(cs):
        rec = cs.lm19_decode(dev, ops, spec, launches)
        rec.pop("profile", None)
        print(json.dumps({"lm19_decode": rec}), flush=True)
    print(f"holds and runs: {time.perf_counter() - t0:.1f} s")
    return fails


def time_prefills(root, cpu):
    """One turn of the A/B in ``root``'s checkout: each batch-1 run's
    prefill ms (a warm-up, then ``TIMED``) and flash launches a prefill
    -> {name: reading}."""
    on_path(root)
    import torch

    import chip_smoke as cs
    from repro_torch.distributed import sharding as shd
    from repro_torch.kernels import build, ops
    from repro_torch.models import lm
    from repro_torch.weights import lm_to_mesh
    if cpu:
        dev = rehearse_on_cpu(cs)
    else:
        dev = ops.resolve_device("cuda")
        build.build_all()
    out = {}
    for name, layers, experts, B, S, max_len, _, shape in batch1_specs(cs):
        cfg = cs.pd_config(name, layers, experts)
        params = lm.init_lm(cfg, torch.Generator(device=dev).manual_seed(29))
        toks = torch.randint(0, cfg.vocab, (B, S), device=dev,
                             generator=torch.Generator(device=dev)
                             .manual_seed(39))
        rules = shd.rules_for(cs.lm18_mesh(shape), cfg, batch=B,
                              kind="decode")
        pm = lm_to_mesh(params, cfg, rules, copy=False)
        ms = []
        with torch.inference_mode(), shd.axis_rules(rules):
            for i in range(TIMED + 1):
                ops.flash_attention_fwd.launches = 0
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                st, _ = lm.prefill(cfg, pm, tokens=toks, max_len=max_len)
                torch.cuda.synchronize()
                if i:
                    ms.append((time.perf_counter() - t0) * 1e3)
                del st
        out[name] = {"prefill_ms": ms,
                     "median_ms": statistics.median(ms),
                     "flash_launches": ops.flash_attention_fwd.launches,
                     "mesh": list(shape), "prompt": S, "max_len": max_len}
        del params, pm
        torch.cuda.empty_cache()
    return out


def main():
    args = sys.argv[1:]
    cpu = "--cpu" in args
    if "--time" in args:
        print(json.dumps(time_prefills(args[args.index("--time") + 1],
                                       cpu)))
        return
    if not cpu:
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip(), flush=True)
    fails = hold(cpu)
    other = [a for a in args if not a.startswith("--")]
    if other:
        turns = [("other", other[0]), ("this", ROOT), ("this", ROOT),
                 ("other", other[0])]
        readings = []
        for label, root in turns:
            res = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--time",
                 os.path.abspath(root)] + (["--cpu"] if cpu else []),
                capture_output=True, text=True, timeout=900)
            if res.returncode:
                print(res.stdout[-4000:], res.stderr[-4000:])
                fails.append(f"the {label} checkout's turn failed")
                continue
            got = json.loads(res.stdout.strip().splitlines()[-1])
            readings.append({"checkout": label, **got})
            print(json.dumps(readings[-1]), flush=True)
        for name in RUNS:
            for label in ("other", "this"):
                med = [r[name]["median_ms"] for r in readings
                       if r["checkout"] == label and name in r]
                print(f"{name} batch-1 prefill, {label} checkout: median ms "
                      f"of each turn {med}")
    print("failed checks:", *fails, sep="\n  ")
    sys.exit(1 if fails else 0)


if __name__ == "__main__":
    main()
