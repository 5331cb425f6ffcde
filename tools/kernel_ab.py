#!/usr/bin/env python3
"""This tree's INT8 quantize and Laplacian kernels against another
checkout's, timed in turns in one call.

    python3 tools/kernel_ab.py OTHER     # from the repository root, one CUDA card

OTHER is a checkout of the repository (for instance the parent commit,
unpacked with ``git archive`` into a git-ignored directory).  The script
builds OTHER's ``csrc/int8_quant.cu`` and ``csrc/laplacian_energy.cu``
with this tree's flags into ``build/kernel_ab/`` beside this tree's own,
and, loading one pair of libraries at a time into the wrappers:

- holds both against the plain versions at the timed shapes (the INT8
  kernels bitwise, the Laplacian forward within ``chip_smoke.LAP_RTOL``
  with counts exact) and checks that the kernels both trees share the
  design of, ``int8_dequantize`` and ``laplacian_energy_bwd``, give the
  same bits from both libraries, and that ``int8_quantize`` does;
- times, with ``chip_smoke.device_ms``, in the order OTHER, this, this,
  OTHER: ``int8_quantize`` and ``int8_dequantize`` at the eight per-frame
  boundary shapes (summed; ``torch.aminmax`` beside them) and at 2^24 +
  3; ``laplacian_energy`` at the refine round's (256, 100, 128) k 5, the
  edge learner's (1, 104, 128) k 3 and the LM step's (8, 16, 1,024) k 5;
  ``laplacian_energy_bwd`` at the last two;
- times the per-frame split path end to end in the same order:
  ``SplitEngine.run`` at full width on 256 frames, frame i at k = i mod 9
  (as phase 2 spreads them), its host time a frame (the run ends in a
  synchronize) and, from one more run under ``torch.profiler``, its device
  time a frame.

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

SOURCES = ("int8_quant.cu", "laplacian_energy.cu")


def libraries(build, other):
    """{"other": {source: path}, "this": {source: path}}: OTHER's sources
    compiled with this tree's flags, all at once, and this tree's built as
    the wrappers build them."""
    out_dir = os.path.join(ROOT, "build", "kernel_ab")
    os.makedirs(out_dir, exist_ok=True)

    def nvcc(src):
        so = os.path.join(out_dir, f"other-{src[:-3]}.so")
        cu = os.path.join(other, "src", "repro_torch", "kernels", "csrc", src)
        subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", so, cu],
                       check=True, capture_output=True, text=True)
        return so

    with ThreadPoolExecutor(len(SOURCES)) as pool:
        theirs = dict(zip(SOURCES, pool.map(nvcc, SOURCES)))
    return {"other": theirs,
            "this": {src: str(build.build(src)) for src in SOURCES}}


def use(build, paths, plan):
    """Make the wrappers launch the libraries at ``paths``, the quantize
    wrapper with the launch plan ``plan`` (OTHER's ``int8_quantize_f32``
    gets the partials at every size, as a checkout whose quantize runs two
    passes at every size needs them; this tree's reads them only above one
    block)."""
    from repro_torch.kernels import int8_quant
    int8_quant.quantize_plan = plan
    for src, so in paths.items():
        lib = ctypes.CDLL(so)
        for fn, (argtypes, restype) in build.SIGNATURES[src].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        build._loaded[src] = lib


def inputs(cfg, dev):
    """{label: (wrapper name, args, k)} at the timed shapes."""
    g = torch.Generator(device=dev).manual_seed(20)
    out = {}
    for k, shape in enumerate(cs.boundary_shapes(cfg)):
        out[f"quant k={k}"] = torch.randn(*shape, device=dev, generator=g)
    out["quant 2^24+3"] = torch.randn(2 ** 24 + 3, device=dev, generator=g)
    for what, (B, T, d, k) in (("refine", (cs.SESSIONS, cs.WINDOW, 128,
                                           cs.KNN)),
                               ("edge", (1, cs.BUFFER + cs.TRAIN_BATCH, 128,
                                         cs.TRAIN_KNN)),
                               ("lm", (cs.LM_LAP_B, cs.LM_LAP_T, cs.LM_D,
                                       cs.KNN))):
        z, mask, _, _ = cs.refine_inputs(g, dev, B, T, d, 1)
        out[f"lap {what}"] = (z, mask, torch.randn(B, device=dev,
                                                   generator=g), k)
    return out


def outputs(ops, xs):
    """Every kernel's outputs at the timed shapes, for the bit checks."""
    res = {}
    for label, x in xs.items():
        if label.startswith("quant"):
            qt = ops.int8_quantize(x)
            res[label] = (qt.q, qt.scale, qt.zero, ops.int8_dequantize(qt))
        else:
            z, mask, g, k = x
            res[label] = (*ops.laplacian_energy(z, mask, k),
                          ops.laplacian_energy_bwd(z, mask, g, k))
    torch.cuda.synchronize()
    return res


def hold(ops, xs, res, failures, name):
    """Each library against the plain versions."""
    for label, x in xs.items():
        if label.startswith("quant"):
            want = ops.int8_quantize_ref(x)
            got = res[label]
            ok = all(cs.same_values(a, b) for a, b in zip(got[:3], want)) \
                and cs.same_values(got[3], ops.int8_dequantize_ref(want))
        else:
            z, mask, g, k = x
            tot, cnt, dz = res[label]
            w_tot, w_cnt = ops.laplacian_energy_ref(z, mask, k)
            ok = torch.allclose(tot, w_tot, rtol=cs.LAP_RTOL, atol=0.0) \
                and torch.equal(cnt, w_cnt)
        if not ok:
            failures.append(f"{name}: {label} != plain version")


def times(ops, xs):
    """{label: device µs} of one library pair."""
    out = {}
    for label, x in xs.items():
        if label.startswith("quant"):
            out[label] = cs.device_ms(ops.int8_quantize, x) * 1e3
            out["de" + label] = cs.device_ms(
                ops.int8_dequantize, ops.int8_quantize(x)) * 1e3
        else:
            z, mask, g, k = x
            out[label] = cs.device_ms(
                lambda a: ops.laplacian_energy(*a, k), (z, mask)) * 1e3
            if not label.endswith("refine"):
                out[label + " bwd"] = cs.device_ms(
                    lambda a: ops.laplacian_energy_bwd(*a, k),
                    (z, mask, g)) * 1e3
    for pre in ("quant", "dequant"):
        out[f"{pre} per frame"] = sum(
            v for key, v in out.items() if key.startswith(f"{pre} k="))
    return out


def per_frame_path(cfg, dev):
    """-> (the frames, a function that runs them through ``SplitEngine.run``
    and returns its host ms and profiled device ms a frame)."""
    import time

    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.splitter import SplitEngine
    from repro_torch.models.audio_encoder import init_audio_encoder
    from repro_torch.weights import to_device
    params = to_device(init_audio_encoder(
        cfg, torch.Generator().manual_seed(2)), dev)
    eng = SplitEngine(cfg, device=dev)
    mels = np.random.default_rng(2).standard_normal(
        (cs.SESSIONS, 1, cfg.frames, cfg.n_mels), np.float32)
    ks = [i % (cfg.n_blocks + 1) for i in range(cs.SESSIONS)]

    def run():
        for mel, k in zip(mels, ks):
            eng.run(params, mel, k)
        torch.cuda.synchronize()

    def measure():
        run()                                   # warm-up
        t0 = time.perf_counter()
        run()
        host = (time.perf_counter() - t0) * 1e3 / len(ks)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run()
        busy = sum(e.time_range.elapsed_us() for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
        return host, busy / 1e3 / len(ks)
    return measure


def main():
    if not torch.cuda.is_available() or len(sys.argv) != 2:
        sys.exit("usage: kernel_ab.py OTHER_CHECKOUT (needs a CUDA card)")
    from repro_torch.configs.streamsplit_audio import CFG
    from repro_torch.kernels import build, ops
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip())
    from repro_torch.kernels import int8_quant
    plans = {"this": int8_quant.quantize_plan,
             "other": lambda n: (2, int8_quant._PARTIALS)}
    dev = ops.resolve_device("cuda")
    libs = libraries(build, os.path.abspath(sys.argv[1]))
    xs = inputs(CFG, dev)
    failures, res = [], {}
    for name in ("other", "this"):
        use(build, libs[name], plans[name])
        res[name] = outputs(ops, xs)
        hold(ops, xs, res[name], failures, name)
    for label in xs:
        same = res["other"][label] if label.startswith("quant") else \
            res["other"][label][2:]
        mine = res["this"][label] if label.startswith("quant") else \
            res["this"][label][2:]
        if not all(cs.same_values(a, b) for a, b in zip(same, mine)):
            failures.append(f"{label}: the two libraries' "
                            + ("quantize and dequantize" if
                               label.startswith("quant") else
                               "laplacian_energy_bwd") + " differ")
    aminmax = sum(cs.device_ms(torch.aminmax, x) for label, x in xs.items()
                  if label.startswith("quant k=")) * 1e3
    print(f"torch.aminmax per frame (8 boundary shapes, summed): "
          f"{aminmax:.2f} us")
    frames = per_frame_path(CFG, dev)
    readings = {"other": [], "this": []}
    for name in ("other", "this", "this", "other"):
        use(build, libs[name], plans[name])
        t = times(ops, xs)
        host, device = frames()
        t["per-frame path, host a frame"] = host * 1e3
        t["per-frame path, device a frame"] = device * 1e3
        readings[name].append(t)
        print(f"{name}: " + ", ".join(f"{k} {v:.2f}" for k, v in t.items()))
    for label in readings["this"][0]:
        o = [r[label] for r in readings["other"]]
        m = [r[label] for r in readings["this"]]
        print(f"{label}: other {o[0]:.2f} / {o[1]:.2f}, this {m[0]:.2f} / "
              f"{m[1]:.2f} us; this / other {sum(m) / sum(o):.3f}")
    for f in failures:
        print(f"kernel_ab: FAIL: {f}")
    sys.exit(1 if failures else 0)


if __name__ == "__main__":
    main()
