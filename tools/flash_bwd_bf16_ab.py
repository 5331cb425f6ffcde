#!/usr/bin/env python3
"""The bf16 flash backward (dq, dk/dv) of this tree against another
checkout's, held and timed in turns in one call.

    python3 tools/flash_bwd_bf16_ab.py OTHER   # from the repository root, one CUDA card

OTHER is a checkout of the repository, for instance the parent commit
unpacked with ``git archive HEAD | tar -x -C build/parent`` (``build/`` is
git-ignored).  The script builds OTHER's ``csrc/flash_attention.cu`` with
this tree's flags into ``build/flash_bwd_bf16_ab/`` and calls its
``flash_attention_bwd_dq_bf16`` and ``flash_attention_bwd_dkv_bf16``
through the C signatures this tree declares for them (unchanged), then:

- holds this tree's dq and dk/dv against OTHER's and both against the
  plain backward at phase 20's bar (``chip_smoke.BF16_GRAD_RTOL`` of each
  gradient's max) at ``chip_smoke.LM20_SHAPES`` (causal and full) and
  ``LM20_EDGES``;
- times, with ``chip_smoke.device_ms`` (CUDA events behind a spin kernel),
  in the order OTHER, this, this, OTHER, each kernel at the small, large
  and kimi-k2 shapes (causal), with ``scaled_dot_product_attention``'s
  bf16 backward (dq, dk and dv in one call; timed only, the port never
  calls it) before and after, and prints each reading in µs, the mean of
  each pair, the bound (``chip_smoke.flash_bound``) and the pair's ratio
  to SDPA's backward.

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

ENTRIES = ("flash_attention_bwd_dq_bf16", "flash_attention_bwd_dkv_bf16")


def other_kernels(build, other):
    """OTHER's bf16 dq and dk/dv as wrappers (q, k, v, dO, lse, delta,
    causal) -> dq, or (dk, dv)."""
    out_dir = os.path.join(ROOT, "build", "flash_bwd_bf16_ab")
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
    q, k, v = (x.to(torch.bfloat16) for x in cs.flash_inputs(g, dev, *shape))
    do = torch.randn(B, H, Sq, hd, device=dev, generator=g).to(torch.bfloat16)
    o, lse = ops.flash_attention_fwd(q, k, v, causal=causal)
    return q, k, v, do, lse, (do.float() * o.float()).sum(-1)


def hold(g, dev, ops, other, shape, causal, failures):
    """This tree's and OTHER's gradients at ``shape`` against each other
    and the plain backward -> the worst error of each, of the max."""
    args = inputs(g, dev, ops, shape, causal)
    this = (ops.flash_attention_bwd_dq(*args, causal=causal),
            *ops.flash_attention_bwd_dkv(*args, causal=causal))
    theirs = (other[0](*args, causal), *other[1](*args, causal))
    plain = (ops.flash_attention_bwd_dq_ref(*args, causal),
             *ops.flash_attention_bwd_dkv_ref(*args, causal))
    torch.cuda.synchronize()
    f = [[x.float() for x in xs] for xs in (this, theirs, plain)]
    errs = {"this vs OTHER": cs.rel_grads(f[0], f[1]),
            "this vs plain": cs.rel_grads(f[0], f[2]),
            "OTHER vs plain": cs.rel_grads(f[1], f[2])}
    for what, err in errs.items():
        if err > cs.BF16_GRAD_RTOL:
            failures.append(f"{what} at {shape} causal={causal}: {err}")
    return errs


def main():
    if len(sys.argv) != 2:
        sys.exit(__doc__)
    if not torch.cuda.is_available():
        sys.exit("flash_bwd_bf16_ab.py needs a CUDA card")
    import torch.nn.functional as F

    from repro_torch.kernels import build, ops
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    dev = ops.resolve_device("cuda")
    build.build_all()
    other = other_kernels(build, os.path.abspath(sys.argv[1]))
    g = torch.Generator(device=dev).manual_seed(31)
    failures, worst = [], {}
    cases = [(s, c) for s in cs.LM20_SHAPES.values() for c in (True, False)]
    cases += [(e[:6], e[6]) for e in cs.LM20_EDGES]
    for shape, causal in cases:
        for what, err in hold(g, dev, ops, other, shape, causal,
                              failures).items():
            worst[what] = max(worst.get(what, 0.0), err)
        torch.cuda.empty_cache()
    print(f"held at {len(cases)} (shape, causal) cases, bar "
          f"{cs.BF16_GRAD_RTOL} of each gradient's max: " + ", ".join(
              f"{k} {v:.3e}" for k, v in worst.items()))
    for tier, shape in cs.LM20_SHAPES.items():
        args = inputs(g, dev, ops, shape, True)
        q, k, v, do = args[:4]
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        o_sdpa = F.scaled_dot_product_attention(*leaves, is_causal=True,
                                                enable_gqa=True)

        def sdpa(a):
            return torch.autograd.grad(o_sdpa, leaves, a, retain_graph=True)
        runs = {"dq": {"OTHER": lambda a: other[0](*a),
                       "this": lambda a: ops.flash_attention_bwd_dq(*a)},
                "dkv": {"OTHER": lambda a: other[1](*a),
                        "this": lambda a: ops.flash_attention_bwd_dkv(*a)}}
        sd = [cs.device_ms(sdpa, do)]
        readings = {n: {"OTHER": [], "this": []} for n in runs}
        for who in ("OTHER", "this", "this", "OTHER"):
            for name, fns in runs.items():
                readings[name][who].append(cs.device_ms(fns[who], args))
        sd.append(cs.device_ms(sdpa, do))
        sdpa_us = 1e3 * sum(sd) / len(sd)
        mean = {n: {w: 1e3 * sum(r) / len(r) for w, r in by.items()}
                for n, by in readings.items()}
        for name, by in readings.items():
            bound, by_what = cs.flash_bound(name, torch.bfloat16, shape)
            print(f"{tier} {shape} {name}: OTHER " + ", ".join(
                f"{x * 1e3:.2f}" for x in by["OTHER"]) + " us (mean "
                f"{mean[name]['OTHER']:.2f}); this " + ", ".join(
                f"{x * 1e3:.2f}" for x in by["this"]) + " us (mean "
                f"{mean[name]['this']:.2f}); bound {bound * 1e3:.2f} us "
                f"({by_what}), this at {bound * 1e3 / mean[name]['this']:.3f}"
                f" of it")
        for who in ("OTHER", "this"):
            pair = mean["dq"][who] + mean["dkv"][who]
            print(f"{tier}: {who}'s dq + dk/dv {pair:.2f} us = "
                  f"{pair / sdpa_us:.3f}x scaled_dot_product_attention's "
                  f"backward ({', '.join(f'{x * 1e3:.2f}' for x in sd)} us, "
                  f"mean {sdpa_us:.2f})")
        del args, q, k, v, do, leaves, o_sdpa
        torch.cuda.empty_cache()
    if failures:
        sys.exit("checks failed: " + "; ".join(failures))


if __name__ == "__main__":
    main()
