#!/usr/bin/env python3
"""The bf16 flash forward of this tree against another checkout's, held
and timed in turns in one call.

    python3 tools/flash_fwd_bf16_ab.py OTHER   # from the repository root, one CUDA card

OTHER is a checkout of the repository, for instance the parent commit
unpacked with ``git archive HEAD | tar -x -C build/parent`` (``build/`` is
git-ignored).  The script builds OTHER's ``csrc/flash_attention.cu`` with
this tree's flags into ``build/flash_fwd_bf16_ab/`` and calls its
``flash_attention_fwd_bf16`` through the C signature this tree declares
for it (unchanged), then:

- holds this tree's forward and OTHER's against the plain version at
  phase 20's bars (``chip_smoke.fwd_hold``: o atol 3e-2, each element
  within 2^-7 |o| + 2^-8 sum p |v|, lse 1e-5), this tree's bitwise from
  run to run, at ``chip_smoke.LM20_SHAPES`` (causal and full) and
  ``LM20_EDGES``, and prints how far the two kernels' o and lse lie
  apart;
- times, with ``chip_smoke.device_ms`` (CUDA events behind a spin kernel),
  in the order OTHER, this, this, OTHER, the forward at the small, large
  and kimi-k2 shapes (causal), with ``scaled_dot_product_attention``'s
  bf16 forward (timed only, the port never calls it) before and after,
  and prints each reading in µs, the mean of each pair, the bound
  (``chip_smoke.flash_bound``) and the ratio to SDPA's forward.

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

ENTRY = "flash_attention_fwd_bf16"


def other_forward(build, other):
    """OTHER's bf16 forward as a wrapper (q, k, v, causal) -> (o, lse)."""
    out_dir = os.path.join(ROOT, "build", "flash_fwd_bf16_ab")
    os.makedirs(out_dir, exist_ok=True)
    so = os.path.join(out_dir, "other-flash_attention.so")
    cu = os.path.join(other, "src", "repro_torch", "kernels", "csrc",
                      "flash_attention.cu")
    subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", so, cu],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(so)
    fns = {}
    for name in (ENTRY, "flash_attention_error_string"):
        fns[name] = getattr(lib, name)
        argtypes, restype = build.SIGNATURES["flash_attention.cu"][name]
        fns[name].argtypes, fns[name].restype = argtypes, restype

    def fwd(q, k, v, causal=True):
        B, H, Sq, hd = q.shape
        KV, Sk = k.shape[1], k.shape[2]
        o = torch.empty_like(q)
        lse = torch.empty(B, H, Sq, dtype=torch.float32, device=q.device)
        err = fns[ENTRY](q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         o.data_ptr(), lse.data_ptr(), B, H, KV, Sq, Sk, hd,
                         float(np.float32(1.0 / np.sqrt(hd))), int(causal),
                         build.stream_of(q))
        if err:
            msg = fns["flash_attention_error_string"](err).decode()
            raise RuntimeError(f"OTHER's {ENTRY} failed: {msg}")
        return o, lse
    return fwd


def hold(g, dev, ops, other, shape, causal):
    """Both forwards at ``shape`` against the plain version and each
    other -> {what: worst reading}."""
    what = f"(B, H, KV, Sq, Sk, hd) {shape} causal={causal}"
    q, k, v = (x.to(torch.bfloat16) for x in cs.flash_inputs(g, dev, *shape))
    o, lse = cs.same_bits(
        lambda *a: ops.flash_attention_fwd(*a, causal=causal), (q, k, v),
        f"this forward at {what}")
    oo, olse = other(q, k, v, causal)
    torch.cuda.synchronize()
    mine = cs.fwd_hold(ops, q, k, v, o, lse, causal, what, "this forward")
    theirs = cs.fwd_hold(ops, q, k, v, oo, olse, causal, what,
                         "OTHER's forward")
    return {"this o": mine[0], "this lse": mine[1],
            "this element share": mine[2], "OTHER o": theirs[0],
            "OTHER lse": theirs[1], "OTHER element share": theirs[2],
            "this vs OTHER o": (o.float() - oo.float()).abs().max().item(),
            "this vs OTHER lse": (lse - olse).abs().max().item()}


def main():
    if len(sys.argv) != 2:
        sys.exit(__doc__)
    if not torch.cuda.is_available():
        sys.exit("flash_fwd_bf16_ab.py needs a CUDA card")
    import torch.nn.functional as F

    from repro_torch.kernels import build, ops
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    dev = ops.resolve_device("cuda")
    build.build_all()
    other = other_forward(build, os.path.abspath(sys.argv[1]))
    failures = []

    def record(cond, msg):
        if not cond:
            failures.append(msg)
            print(f"check failed: {msg}")
    cs.check = record
    g = torch.Generator(device=dev).manual_seed(32)
    worst = {}
    cases = [(s, c) for s in cs.LM20_SHAPES.values() for c in (True, False)]
    cases += [(e[:6], e[6]) for e in cs.LM20_EDGES]
    for shape, causal in cases:
        for what, err in hold(g, dev, ops, other, shape, causal).items():
            worst[what] = max(worst.get(what, 0.0), err)
        torch.cuda.empty_cache()
    print(f"held at {len(cases)} (shape, causal) cases (o atol "
          f"{cs.BF16_O_ATOL}, per element {cs.BF16_O_ULP} |o| + "
          f"{cs.BF16_P_RTOL} sum p |v|, lse {cs.BF16_LSE_ATOL}): " +
          ", ".join(f"{k} {v:.3e}" for k, v in worst.items()))
    for tier, shape in cs.LM20_SHAPES.items():
        qkv = tuple(x.to(torch.bfloat16)
                    for x in cs.flash_inputs(g, dev, *shape))
        runs = {"OTHER": lambda a: other(*a),
                "this": lambda a: ops.flash_attention_fwd(*a)}

        def sdpa(a):
            return F.scaled_dot_product_attention(*a, is_causal=True,
                                                  enable_gqa=True)
        sd = [cs.device_ms(sdpa, qkv)]
        readings = {"OTHER": [], "this": []}
        for who in ("OTHER", "this", "this", "OTHER"):
            readings[who].append(cs.device_ms(runs[who], qkv))
        sd.append(cs.device_ms(sdpa, qkv))
        sdpa_us = 1e3 * sum(sd) / len(sd)
        bound, by_what = cs.flash_bound("fwd", torch.bfloat16, shape)
        for who, r in readings.items():
            mean = 1e3 * sum(r) / len(r)
            print(f"{tier} {shape} forward: {who} " + ", ".join(
                f"{x * 1e3:.2f}" for x in r) + f" us (mean {mean:.2f}) = "
                f"{mean / sdpa_us:.3f}x scaled_dot_product_attention's "
                f"forward ({', '.join(f'{x * 1e3:.2f}' for x in sd)} us, "
                f"mean {sdpa_us:.2f}); bound {bound * 1e3:.2f} us "
                f"({by_what}), at {bound * 1e3 / mean:.3f} of it")
        del qkv
        torch.cuda.empty_cache()
    if failures:
        sys.exit(f"{len(failures)} checks failed")


if __name__ == "__main__":
    main()
