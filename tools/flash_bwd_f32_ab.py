#!/usr/bin/env python3
"""The float32 flash backward at hd 112 (dq, dk/dv) of this tree against
another checkout's, held and timed in turns in one call.

    python3 tools/flash_bwd_f32_ab.py OTHER   # from the repository root, one CUDA card

OTHER is a checkout of the repository, for instance the parent commit
unpacked with ``git archive HEAD | tar -x -C build/parent`` (``build/`` is
git-ignored).  The script builds OTHER's ``csrc/flash_attention.cu`` with
this tree's flags into ``build/flash_bwd_f32_ab/`` and calls its
``flash_attention_bwd_dq_f32`` and ``flash_attention_bwd_dkv_f32``
through the C signatures this tree declares for them (unchanged), then:

- prints this tree's hd-112 kernels' registers and local bytes;
- holds this tree's dq and dk/dv against OTHER's and both against the
  plain backward at phase 20's float32 bar (``chip_smoke.FLASH_BWD_RTOL``
  of each gradient's max) at kimi-k2's layer (``chip_smoke.LM20_SHAPES``'
  "kimi", causal and full) and every hd-112 case of ``LM20_EDGES``, and
  this tree's bitwise from run to run;
- times, with ``chip_smoke.device_ms`` (CUDA events behind a spin kernel),
  in the order OTHER, this, this, OTHER, each kernel at kimi-k2's layer,
  causal and full, with ``scaled_dot_product_attention``'s float32
  backward (dq, dk and dv in one call; timed only, the port never calls
  it) before and after, and prints each reading in µs, the mean of each
  pair, the bound (``chip_smoke.flash_bound``) and the pair's ratio to
  SDPA's backward.

Prints the card's name and power limit first.  Exits 1 if a check fails.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

ENTRIES = ("flash_attention_bwd_dq_f32", "flash_attention_bwd_dkv_f32")


def other_kernels(build, other):
    """OTHER's float32 dq and dk/dv as wrappers (q, k, v, dO, lse, delta,
    causal) -> dq, or (dk, dv)."""
    out_dir = os.path.join(ROOT, "build", "flash_bwd_f32_ab")
    os.makedirs(out_dir, exist_ok=True)
    so = os.path.join(out_dir, "other-flash_attention.so")
    cu = os.path.join(other, "src", "repro_torch", "kernels", "csrc",
                      "flash_attention.cu")
    subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", so, cu],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(so)
    fns = {}
    for name in ENTRIES + ("flash_attention_error_string",):
        fns[name] = getattr(lib, name)
        argtypes, restype = build.SIGNATURES["flash_attention.cu"][name]
        fns[name].argtypes, fns[name].restype = argtypes, restype

    def launch(name, q, k, v, do, lse, delta, outs, causal):
        B, H, Sq, hd = q.shape
        KV, Sk = k.shape[1], k.shape[2]
        err = fns[name](q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                        *(o.data_ptr() for o in outs), B, H, KV, Sq, Sk, hd,
                        float(np.float32(1.0 / np.sqrt(hd))), int(causal),
                        build.stream_of(q))
        if err:
            msg = fns["flash_attention_error_string"](err).decode()
            raise RuntimeError(f"OTHER's {name} failed: {msg}")
        return outs

    def dq(q, k, v, do, lse, delta, causal=True):
        return launch(ENTRIES[0], q, k, v, do, lse, delta,
                      (torch.empty_like(q),), causal)[0]

    def dkv(q, k, v, do, lse, delta, causal=True):
        return launch(ENTRIES[1], q, k, v, do, lse, delta,
                      (torch.empty_like(k), torch.empty_like(v)), causal)
    return dq, dkv


def inputs(g, dev, ops, shape, causal):
    B, H, KV, Sq, Sk, hd = shape
    q, k, v = cs.flash_inputs(g, dev, *shape)
    do = torch.randn(B, H, Sq, hd, device=dev, generator=g)
    o, lse = ops.flash_attention_fwd(q, k, v, causal=causal)
    return q, k, v, do, lse, (do * o).sum(-1)


def hold(g, dev, ops, other, shape, causal, failures):
    """This tree's and OTHER's gradients at ``shape`` against each other
    and the plain backward -> the worst error of each, of the max."""
    args = inputs(g, dev, ops, shape, causal)
    this = cs.same_bits(lambda *a: (
        ops.flash_attention_bwd_dq(*a, causal=causal),
        *ops.flash_attention_bwd_dkv(*a, causal=causal)), args,
        f"this tree's backward at {shape} causal={causal}")
    theirs = (other[0](*args, causal), *other[1](*args, causal))
    plain = (ops.flash_attention_bwd_dq_ref(*args, causal),
             *ops.flash_attention_bwd_dkv_ref(*args, causal))
    torch.cuda.synchronize()
    errs = {"this vs OTHER": cs.rel_grads(this, theirs),
            "this vs plain": cs.rel_grads(this, plain),
            "OTHER vs plain": cs.rel_grads(theirs, plain)}
    # each tree is held to the bar against the plain backward, so the two
    # may differ by twice it
    bars = {"this vs OTHER": 2 * cs.FLASH_BWD_RTOL}
    for what, err in errs.items():
        if err > bars.get(what, cs.FLASH_BWD_RTOL):
            failures.append(f"{what} at {shape} causal={causal}: {err}")
    return errs


def main():
    if len(sys.argv) != 2:
        sys.exit(__doc__)
    if not torch.cuda.is_available():
        sys.exit("flash_bwd_f32_ab.py needs a CUDA card")
    import torch.nn.functional as F

    from repro_torch.kernels import build, ops
    from repro_torch.kernels.flash_attention import bwd_f32_attributes
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    dev = ops.resolve_device("cuda")
    build.build_all()
    other = other_kernels(build, os.path.abspath(sys.argv[1]))
    attrs = bwd_f32_attributes(112)
    print("this tree's hd-112 float32 backward kernels: " + ", ".join(
        f"{k} {a['registers']} registers, {a['local_bytes']} local bytes"
        for k, a in attrs.items()))
    failures = [f"{k} spills" for k, a in attrs.items() if a["local_bytes"]]
    g = torch.Generator(device=dev).manual_seed(37)
    kimi = cs.LM20_SHAPES["kimi"]
    cases = [(kimi, c) for c in (True, False)]
    cases += [(e[:6], e[6]) for e in cs.LM20_EDGES if e[5] == 112]
    worst = {}
    for shape, causal in cases:
        for what, err in hold(g, dev, ops, other, shape, causal,
                              failures).items():
            worst[what] = max(worst.get(what, 0.0), err)
        torch.cuda.empty_cache()
    print(f"held at {len(cases)} (shape, causal) cases {cases}, bar "
          f"{cs.FLASH_BWD_RTOL} of each gradient's max against the plain "
          f"backward (this vs OTHER: twice it): " + ", ".join(
              f"{k} {v:.3e}" for k, v in worst.items()))
    for causal in (True, False):
        args = inputs(g, dev, ops, kimi, causal)
        q, k, v, do = args[:4]
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        o_sdpa = F.scaled_dot_product_attention(*leaves, is_causal=causal,
                                                enable_gqa=True)

        def sdpa(a):
            return torch.autograd.grad(o_sdpa, leaves, a, retain_graph=True)
        runs = {"dq": {"OTHER": lambda a: other[0](*a, causal),
                       "this": lambda a: ops.flash_attention_bwd_dq(
                           *a, causal=causal)},
                "dkv": {"OTHER": lambda a: other[1](*a, causal),
                        "this": lambda a: ops.flash_attention_bwd_dkv(
                            *a, causal=causal)}}
        sd = [cs.device_ms(sdpa, do, reps=10)]
        readings = {n: {"OTHER": [], "this": []} for n in runs}
        for who in ("OTHER", "this", "this", "OTHER"):
            for name, fns in runs.items():
                readings[name][who].append(
                    cs.device_ms(fns[who], args, reps=20))
        sd.append(cs.device_ms(sdpa, do, reps=10))
        sdpa_us = 1e3 * sum(sd) / len(sd)
        mean = {n: {w: 1e3 * sum(r) / len(r) for w, r in by.items()}
                for n, by in readings.items()}
        what = f"kimi {kimi} causal={causal}"
        for name, by in readings.items():
            bound, by_what = cs.flash_bound(name, torch.float32, kimi,
                                            causal)
            print(f"{what} {name}: OTHER " + ", ".join(
                f"{x * 1e3:.2f}" for x in by["OTHER"]) + " us (mean "
                f"{mean[name]['OTHER']:.2f}); this " + ", ".join(
                f"{x * 1e3:.2f}" for x in by["this"]) + " us (mean "
                f"{mean[name]['this']:.2f}); bound {bound * 1e3:.2f} us "
                f"({by_what}), this at {bound * 1e3 / mean[name]['this']:.3f}"
                f" of it, {mean[name]['OTHER'] / mean[name]['this']:.3f}x "
                f"OTHER's speed")
        for who in ("OTHER", "this"):
            pair = mean["dq"][who] + mean["dkv"][who]
            print(f"{what}: {who}'s dq + dk/dv {pair:.2f} us = "
                  f"{pair / sdpa_us:.3f}x scaled_dot_product_attention's "
                  "float32 backward ("
                  f"{', '.join(f'{x * 1e3:.2f}' for x in sd)} us, mean "
                  f"{sdpa_us:.2f})")
        del args, q, k, v, do, leaves, o_sdpa
        torch.cuda.empty_cache()
    if failures:
        sys.exit("checks failed: " + "; ".join(failures))


if __name__ == "__main__":
    main()
