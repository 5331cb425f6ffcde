"""The dry-run's full depth on the production meshes: composed against
traced, and timed.

    python3 tools/dryrun_depth_check.py            # repository root
    python3 tools/dryrun_depth_check.py --small    # the check on (4, 4)

Host work (no card needed; ``meta`` tensors).  Three parts run at once:

- the check: qwen3-1.7b ``train_4k`` at ``CHECK_LAYERS`` layers on
  ``make_production_mesh(devices=["meta"] * 256)``, traced whole
  (``dryrun.trace_cut``) and composed from its cuts (``dryrun.cuts``: 1
  and 2 layers), three traces in a pool of one-thread worker processes;
  every count and every field of the two records must be equal;
- ``python -m repro_torch.launch.dryrun --arch qwen3-1.7b --shape
  train_4k``, the full-depth record as a user writes it (28 layers from
  its cuts), timed by the wall clock of its process;
- the same for kimi-k2-1t-a32b ``train_4k`` with ``--multi-pod`` (512
  shards; 61 layers from its 2- and 3-layer cuts).

Beside them the main process holds ``trace_cut``'s flops (the formulas
of ``FlopCounterMode`` applied in the dry-run's own mode) against
``FlopCounterMode`` itself on this host's torch, at ``COUNTER_CELLS`` on
a (4, 4) mesh.

Five single-threaded processes, so give it a host of that many cores.

Prints the card's name and power limit (``nvidia-smi``) first, each
record's cuts, ``trace_s`` and wall seconds, and a last JSON line; exits 1
if the check fails or a command fails.  ``--small`` runs the same on
16-shard meshes (a rehearsal: the CLIs still trace the production meshes'
shapes of the full configs, so it skips them).
"""
import json
import multiprocessing
import os
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
OUT = os.path.join(ROOT, "experiments", "dryrun_torch", "depth_check")
ARCH, SHAPE, CHECK_LAYERS = "qwen3-1.7b", "train_4k", 6
CLI_CELLS = (("qwen3-1.7b", "train_4k", False),
             ("kimi-k2-1t-a32b", "train_4k", True))
COUNTER_CELLS = (("qwen3-1.7b", "train_4k", 1),
                 ("arctic-480b", "train_4k", 1),
                 ("gemma2-2b", "prefill_32k", 2))


def mesh(small):
    from repro_torch.launch.mesh import make_production_mesh, make_test_mesh
    if small:
        return make_test_mesh((4, 4), devices=["meta"] * 16)
    return make_production_mesh(devices=["meta"] * 256)


def init():
    if SRC not in sys.path:
        sys.path.insert(0, SRC)
    import torch
    torch.set_num_threads(1)


def trace(args):
    """One trace of the check's config with ``ovr`` -> its counts."""
    ovr, small = args
    from dataclasses import replace
    from repro_torch.configs.base import SHAPES
    from repro_torch.launch import dryrun
    cfg = replace(dryrun.cell_config(ARCH, overrides={
        "n_layers": CHECK_LAYERS}), **ovr)
    return dryrun.trace_cut(cfg, SHAPES[SHAPE], dryrun.policy_for(ARCH),
                            mesh(small))


def counter_check():
    """``COUNTER_CELLS``' flops by ``FlopCounterMode`` and by
    ``trace_cut`` on a (4, 4) mesh -> [(cell, theirs, ours)]."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs.base import SHAPES
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import dryrun
    out, m = [], mesh(True)
    for arch, shape_name, layers in COUNTER_CELLS:
        cfg = dryrun.cell_config(arch, overrides={"n_layers": layers})
        shape, pol = SHAPES[shape_name], dryrun.policy_for(arch)
        rules = shd.rules_for(m, cfg, batch=shape.global_batch,
                              kind=shape.kind, fsdp=pol["fsdp"])
        with shd.axis_rules(rules):
            args, fn = dryrun._step(cfg, shape, pol,
                                    shd.ShardLayout(rules), cfg.dtype)
            with dryrun._ShapeCache(), FlopCounterMode(display=False) as fc:
                fn(*args)
        out.append(((arch, shape_name, layers), fc.get_total_flops(),
                    dryrun.trace_cut(cfg, shape, pol, m)["flops"]))
    return out


def card():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def start_cli(arch, shape, multi_pod):
    """The dry-run's CLI for one cell in a process of its own, awaited by a
    thread -> (the thread, a dict that gets its ``out``, ``rc``,
    ``wall_s`` and record's ``path``)."""
    os.makedirs(OUT, exist_ok=True)
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
           arch, "--shape", shape, "--out", OUT] + (
        ["--multi-pod"] if multi_pod else [])
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    tag = f"{arch}__{shape}__{'multi' if multi_pod else 'single'}"
    got = {"path": os.path.join(OUT, tag + ".json")}

    def run():
        t0 = time.perf_counter()
        p = subprocess.run(cmd, env=env, cwd=ROOT, capture_output=True,
                           text=True)
        got.update(out=p.stdout + p.stderr, rc=p.returncode,
                   wall_s=time.perf_counter() - t0)
    th = threading.Thread(target=run)
    th.start()
    return th, got


def main(argv):
    small = "--small" in argv
    init()
    from repro_torch.configs.base import SHAPES
    from repro_torch.launch import dryrun
    name = card()
    print(f"card: {name}", flush=True)
    cfg = dryrun.cell_config(ARCH, overrides={"n_layers": CHECK_LAYERS})
    cuts = dryrun.cuts(cfg, SHAPES[SHAPE].kind)
    full_ovr = {"n_layers": CHECK_LAYERS}
    clis = [] if small else [(c, start_cli(*c)) for c in CLI_CELLS]
    t0 = time.perf_counter()
    with multiprocessing.get_context("spawn").Pool(
            len(cuts) + 1, initializer=init) as pool:
        got = pool.map(trace, [(o, small) for o in cuts + [full_ovr]])
    check_s = time.perf_counter() - t0
    counted = counter_check()
    for cell, theirs, ours in counted:
        print(f"flops: {cell} on 4x4: FlopCounterMode {theirs}, trace_cut "
              f"{ours}" + ("" if theirs == ours else "  DIFFERENT"),
              flush=True)
    traced, full = list(zip(cuts, got[:-1])), got[-1]
    composed = dryrun.compose(cfg, traced)
    m = mesh(small)
    strip = lambda d: {k: v for k, v in d.items()  # noqa: E731
                       if k not in ("trace_s", "cuts")}
    same = {k: (composed[k], full[k]) for k in full if k != "trace_s"}
    bad = {k: v for k, v in same.items() if v[0] != v[1]}
    rec_c = dryrun.record(ARCH, SHAPE, m, cfg, composed, cuts)
    rec_f = dryrun.record(ARCH, SHAPE, m, cfg, full, [full_ovr])
    if strip(rec_c) != strip(rec_f):
        bad["record"] = (strip(rec_c), strip(rec_f))
    print(f"check: {ARCH} {SHAPE} at {CHECK_LAYERS} layers on "
          f"{rec_f['mesh']}: traced whole in {full['trace_s']:.1f} s, its "
          f"cuts {cuts} in " + ", ".join(
              f"{c['trace_s']:.1f}" for _, c in traced)
          + f" s (the pool {check_s:.1f} s); "
          + ("every field equal" if not bad else f"DIFFERENT: {bad}"),
          flush=True)
    result = {"card": name, "check": {
        "layers": CHECK_LAYERS, "mesh": rec_f["mesh"], "equal": not bad,
        "full_trace_s": full["trace_s"],
        "cuts": [[o, c["trace_s"]] for o, c in traced],
        "global_flops": full["flops"], "peak": full["peak"]}, "cli": []}
    result["flops_vs_counter_mode"] = [[list(c), a, b]
                                       for c, a, b in counted]
    ok = not bad and all(a == b for _, a, b in counted)
    for (arch, shape, mp), (th, got) in clis:
        th.join()
        print(got["out"].rstrip(), flush=True)
        rec = json.load(open(got["path"])) if got["rc"] == 0 else {}
        ok = ok and got["rc"] == 0 and "error" not in rec
        print(f"cli: {arch} {shape} {'multi' if mp else 'single'}: exit "
              f"{got['rc']}, {got['wall_s']:.1f} s of wall clock, cuts "
              f"{rec.get('cuts')}, trace_s {rec.get('trace_s')}", flush=True)
        result["cli"].append({
            "arch": arch, "shape": shape, "mesh": rec.get("mesh"),
            "wall_s": round(got["wall_s"], 1), "trace_s": rec.get("trace_s"),
            "cuts": rec.get("cuts"), "rc": got["rc"],
            "peak_memory_in_bytes": rec.get("memory", {}).get(
                "peak_memory_in_bytes"),
            "flops": rec.get("cost", {}).get("flops")})
    result["ok"] = ok
    print(json.dumps(result), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
