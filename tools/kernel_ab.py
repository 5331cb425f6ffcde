#!/usr/bin/env python3
"""The hybrid regularisers' backward of this tree against another
checkout's, timed in turns in one call.

    python3 tools/kernel_ab.py OTHER     # from the repository root, one CUDA card

OTHER is a checkout of the repository whose ``csrc/swd.cu`` and
``csrc/laplacian_energy.cu`` still carry their own backward kernels
(``swd_rank_bwd_f32``, ``laplacian_energy_bwd_f32``), for instance the
commit before ``csrc/hybrid_reg_bwd.cu``, unpacked with ``git archive``
into a git-ignored directory.  The script builds those two sources with
this tree's flags into ``build/kernel_ab/`` and, at the edge learner's
(1, 104, 128), M 32, k 3 and the LM step's (8, 16, 1,024), M 50, k 5
(g_tot the expanded cotangent of ``tot.sum()``, as the step hands it on):

- checks that this tree's ``hybrid_reg_bwd`` gives, bitwise, OTHER's
  composition (its ``swd_rank_bwd`` and ``laplacian_energy_bwd`` added by
  torch), and each of this tree's one-half calls OTHER's kernel;
- times, with ``chip_smoke.device_ms`` (CUDA events behind a spin
  kernel), in the order OTHER, this, this, OTHER: the regularisers'
  backward as each tree launches it (OTHER: its two kernels, the add and,
  at B > 1, the copy of the expanded g_tot; this tree: one
  ``hybrid_reg_bwd``), and each half alone (OTHER's kernel, this tree's
  one-half call);
- profiles one step of the edge learner (``EdgeTrainer`` at full width,
  batch 8, 256 virtual negatives) and of the LM trainer (qwen1.5-0.5b at
  full width and depth, B 8 x S 1,024, the hybrid term on) in the same
  order, the regularisers' backward launched as each tree launches it
  (OTHER: the two terms' own autograd Functions on OTHER's kernels), and
  prints each step's device activities and their device time, the
  regularisers' backward kernels' part of it.

Prints the card's name and power limit first and each reading in µs,
then the mean of each pair.  Exits 1 if a check fails.
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

SOURCES = ("swd.cu", "laplacian_energy.cu")
_P, _I = ctypes.c_void_p, ctypes.c_int
# OTHER's two backward entry points, as its build.py declared them
OTHER_ENTRIES = {"swd.cu": ("swd_rank_bwd_f32", [_P] * 6 + [_I] * 3 + [_P]),
                 "laplacian_energy.cu": ("laplacian_energy_bwd_f32",
                                         [_P] * 4 + [_I] * 4 + [_P])}


def other_kernels(build, other):
    """OTHER's ``swd_rank_bwd`` and ``laplacian_energy_bwd`` as wrappers
    (its two sources compiled with this tree's flags, all at once)."""
    out_dir = os.path.join(ROOT, "build", "kernel_ab")
    os.makedirs(out_dir, exist_ok=True)

    def nvcc(src):
        so = os.path.join(out_dir, f"other-{src[:-3]}.so")
        cu = os.path.join(other, "src", "repro_torch", "kernels", "csrc", src)
        subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", so, cu],
                       check=True, capture_output=True, text=True)
        lib = ctypes.CDLL(so)
        name, argtypes = OTHER_ENTRIES[src]
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, _I
        return fn

    with ThreadPoolExecutor(len(SOURCES)) as pool:
        swd_bwd, lap_bwd = pool.map(nvcc, SOURCES)

    def launched(err, what):
        if err:
            raise RuntimeError(f"OTHER's {what} launch failed: error {err}")

    def swd_rank_bwd(g, proj, rank, prior_q, dirs):
        (W, M), d = prior_q.shape, dirs.shape[1]
        dx = torch.empty(W, d, device=g.device)
        launched(swd_bwd(g.data_ptr(), proj.data_ptr(), rank.data_ptr(),
                         prior_q.data_ptr(), dirs.data_ptr(), dx.data_ptr(),
                         W, d, M, cs_stream(g)), "swd_rank_bwd")
        return dx

    def laplacian_energy_bwd(z, mask, g, k):
        B, T, d = z.shape
        g = g.contiguous()              # as OTHER's autograd entry did
        dz = torch.empty_like(z)
        launched(lap_bwd(z.data_ptr(), mask.data_ptr(), g.data_ptr(),
                         dz.data_ptr(), B, T, d, int(k), cs_stream(z)),
                 "laplacian_energy_bwd")
        return dz
    return swd_rank_bwd, laplacian_energy_bwd


def cs_stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def inputs(dev, ops):
    """{label: hybrid_reg_bwd's arguments and g_tot laid out} at the two
    paths' shapes."""
    g = torch.Generator(device=dev).manual_seed(22)
    out = {
        "edge": cs.hybrid_inputs(g, dev, ops, 1, cs.BUFFER + cs.TRAIN_BATCH,
                                 128, cs.TRAIN_DIRS, cs.TRAIN_KNN, False),
        "lm": cs.hybrid_inputs(g, dev, ops, cs.LM_LAP_B, cs.LM_LAP_T,
                               cs.LM_D, cs.LM_SW_DIRS, cs.KNN, True)}
    return {label: (*a, a[8].contiguous()) for label, a in out.items()}


def calls(ops, other):
    """{tree: {what: fn(args)}}: the regularisers' backward as each tree
    launches it (g_tot as the step hands it on), and each half alone (the
    Laplacian's on g_tot laid out, so that both time the kernel alone)."""
    o_swd, o_lap = other

    def both(swd_bwd, lap_bwd):
        return lambda a: swd_bwd(*a[3:8]).view(a[0].shape) \
            + lap_bwd(a[0], a[1], a[8], a[2])
    return {
        "other": {"backward": both(o_swd, o_lap),
                  "swd half": lambda a: o_swd(*a[3:8]),
                  "laplacian half": lambda a: o_lap(a[0], a[1], a[9], a[2])},
        "this": {"backward": lambda a: ops.hybrid_reg_bwd(*a[:9]),
                 "swd half": lambda a: ops.swd_rank_bwd(*a[3:8]),
                 "laplacian half": lambda a: ops.laplacian_energy_bwd(
                     a[0], a[1], a[9], a[2])}}


def as_tree(name, other):
    """Make the hybrid term's backward launch as tree ``name`` does: OTHER
    with each term's own autograd Function (``swd_loss`` and
    ``laplacian_loss``) on OTHER's kernels, this tree with
    ``hybrid_regularisers``."""
    from repro_torch.core import hybrid
    from repro_torch.core.laplacian import laplacian_loss
    from repro_torch.core.swd import swd_loss
    from repro_torch.kernels import laplacian_energy, swd
    from repro_torch.runtime import trainer
    if not hasattr(as_tree, "this"):
        as_tree.this = (hybrid.regularisers, swd.swd_rank_bwd,
                        laplacian_energy.laplacian_energy_bwd)

    def separate(key, z_seq, *, n_dirs=50, k=5, mask=None):
        return (swd_loss(key, z_seq.reshape(-1, z_seq.shape[-1]),
                         n_dirs=n_dirs),
                laplacian_loss(z_seq, k=k, mask=mask))
    reg, swd_bwd, lap_bwd = as_tree.this if name == "this" \
        else (separate, *other)
    hybrid.regularisers = trainer.regularisers = reg
    swd.swd_rank_bwd, laplacian_energy.laplacian_energy_bwd = swd_bwd, lap_bwd


def profiled(fn):
    """One ``fn()`` under ``torch.profiler`` -> (device activities, their
    µs, the regularisers' backward kernels' µs)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [(e.name, e.time_range.elapsed_us()) for e in prof.events()
              if e.device_type == DeviceType.CUDA]
    reg = sum(us for n, us in events
              if any(k in n for k in ("hybrid_reg_bwd", "swd_rank_bwd",
                                      "laplacian_energy_bwd")))
    return len(events), sum(us for _, us in events), reg


def steps(cfg, dev):
    """-> a function of nothing that profiles one edge learner step and one
    LM step -> {label: reading}."""
    from repro_torch.configs.base import get_config
    from repro_torch.data.tokens import random_batch
    from repro_torch.runtime.edge_train import EdgeTrainer
    from repro_torch.runtime.trainer import Trainer
    edge = EdgeTrainer("streamsplit", enc_cfg=cfg, batch=cs.TRAIN_BATCH,
                       n_syn=cs.N_SYN, seed=0, device=dev)
    B, S = 8, 1024
    lm_cfg = get_config("qwen1.5-0.5b")
    lm = Trainer(lm_cfg, cs.lm_train_cfg(100, S), lambda step: random_batch(
        torch.Generator(device=dev).manual_seed(100 + step), lm_cfg.vocab, B,
        S), device=dev)

    def measure():
        out = {}
        for label, fn in (("edge step", edge.step),
                          ("LM step", lambda: lm.run(1, log_every=0))):
            fn()                                     # warm-up
            n, busy, reg = profiled(fn)
            out[f"{label} device activities"] = n
            out[f"{label} device busy"] = busy
            out[f"{label} regularisers' backward kernels"] = reg
        return out
    return measure


def main():
    if not torch.cuda.is_available() or len(sys.argv) != 2:
        sys.exit("usage: kernel_ab.py OTHER_CHECKOUT (needs a CUDA card)")
    from repro_torch.configs.streamsplit_audio import CFG
    from repro_torch.kernels import build, ops
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip())
    dev = ops.resolve_device("cuda")
    other = other_kernels(build, os.path.abspath(sys.argv[1]))
    xs = inputs(dev, ops)
    fns = calls(ops, other)
    failures = []
    for label, args in xs.items():
        got = {name: {w: f(args) for w, f in fns[name].items()}
               for name in fns}
        torch.cuda.synchronize()
        for what in fns["this"]:
            if not torch.equal(got["this"][what], got["other"][what]):
                failures.append(f"{label}: {what} differs from OTHER's")
    measure = steps(CFG, dev)
    readings = {"other": [], "this": []}
    for name in ("other", "this", "this", "other"):
        as_tree(name, other)
        t = {f"{label} {what}": cs.device_ms(f, args) * 1e3
             for label, args in xs.items()
             for what, f in fns[name].items()}
        t.update(measure())
        readings[name].append(t)
        print(f"{name}: " + ", ".join(f"{k} {v:.2f}" for k, v in t.items()))
    as_tree("this", other)
    for label in readings["this"][0]:
        m = [r[label] for r in readings["this"]]
        o = [r[label] for r in readings["other"]]
        print(f"{label}: other {o[0]:.2f} / {o[1]:.2f}, this {m[0]:.2f} / "
              f"{m[1]:.2f}; this / other {sum(m) / max(sum(o), 1e-9):.3f}")
    for f in failures:
        print(f"kernel_ab: FAIL: {f}")
    sys.exit(1 if failures else 0)


if __name__ == "__main__":
    main()
