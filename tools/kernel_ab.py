#!/usr/bin/env python3
"""This tree's INT8 wire and Laplacian kernels against another
checkout's, timed in turns in one call.

    python3 tools/kernel_ab.py OTHER     # from the repository root, one CUDA card

OTHER is a checkout of the repository (for instance the parent commit,
unpacked with ``git archive`` into a git-ignored directory).  The script
builds OTHER's ``csrc/int8_quant.cu``, ``csrc/wire_roundtrip.cu`` and
``csrc/laplacian_energy.cu`` with this tree's flags into
``build/kernel_ab/`` beside this tree's own, and, loading one set of
libraries at a time into the wrappers (an entry point OTHER lacks is left
out; OTHER runs the wire as its code did: ``int8_quantize`` then
``int8_dequantize`` a frame, one ``wire_roundtrip`` launch a bucket):

- holds both against the plain versions at the timed shapes (the INT8
  kernels bitwise, the Laplacian forward within ``chip_smoke.LAP_RTOL``
  with counts exact) and checks that both libraries give the same bits:
  the quantize, the dequantize and the wire (this tree's round trip
  against OTHER's quantize + dequantize, its grouped wire against OTHER's
  launch a bucket), and ``laplacian_energy_bwd``;
- times, with ``chip_smoke.device_ms``, in the order OTHER, this, this,
  OTHER: ``int8_quantize`` and ``int8_dequantize`` at the eight per-frame
  boundary shapes (summed; ``torch.aminmax`` beside them) and at 2^24 +
  3, and a frame's wire as ``SplitEngine.run`` launches it; the tick's
  wire over its eight buckets padded to 32 rows as the tick launches it
  (this tree also one launch a bucket); ``laplacian_energy`` at the
  refine round's (256, 100, 128) k 5, the edge learner's (1, 104, 128) k
  3 and the LM step's (8, 16, 1,024) k 5; ``laplacian_energy_bwd`` at the
  last two;
- times the per-frame split path end to end in the same order:
  ``SplitEngine.run`` at full width on 256 frames, frame i at k = i mod 9
  (as phase 2 spreads them), its host time a frame (the run ends in a
  synchronize) and, from one more run under ``torch.profiler``, its device
  time a frame and the wire's part of it; and the serving tick
  (``chip_smoke.py`` phase 2's gateway, 256 sessions, k = i mod 9), this
  tree's code launching the wire as each tree does: its host p50 over 8
  ticks and, from one more tick under ``torch.profiler``, its device busy
  time and the wire's part of it.

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

SOURCES = ("int8_quant.cu", "wire_roundtrip.cu", "laplacian_energy.cu")


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
    block).  Entry points a library lacks are left undeclared."""
    from repro_torch.kernels import int8_quant
    int8_quant.quantize_plan = plan
    for src, so in paths.items():
        lib = ctypes.CDLL(so)
        for fn, (argtypes, restype) in build.SIGNATURES[src].items():
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
        build._loaded[src] = lib


def frame_wire(ops, name):
    """A frame's wire as ``SplitEngine.run`` launches it in tree ``name``:
    OTHER's quantize then dequantize, this tree's round trip."""
    from repro_torch.kernels import int8_quant
    if name == "this":
        return int8_quant.int8_quantize_roundtrip
    return lambda x: (lambda qt: (qt, ops.int8_dequantize(qt)))(
        ops.int8_quantize(x))


def tick_wire(ops, name):
    """The tick's wire as tree ``name`` launches it: one launch a bucket
    (OTHER), one grouped launch (this tree)."""
    if name == "this":
        return ops.wire_roundtrip_grouped
    return lambda xs: [ops.wire_roundtrip(x) for x in xs]


def inputs(cfg, dev):
    """{label: (wrapper name, args, k)} at the timed shapes."""
    g = torch.Generator(device=dev).manual_seed(20)
    out = {}
    for k, shape in enumerate(cs.boundary_shapes(cfg)):
        out[f"quant k={k}"] = torch.randn(*shape, device=dev, generator=g)
    out["quant 2^24+3"] = torch.randn(2 ** 24 + 3, device=dev, generator=g)
    out["wire tick"] = [torch.randn(32, n, device=dev, generator=g)
                        for n in cs.wire_widths(cfg)]
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


def outputs(ops, xs, name):
    """Every kernel's outputs at the timed shapes, for the bit checks:
    the quantize's and the dequantize's, the wire's as tree ``name``
    launches it."""
    res = {}
    for label, x in xs.items():
        if label.startswith("quant"):
            qt = ops.int8_quantize(x)
            wq, wout = frame_wire(ops, name)(x)
            res[label] = (qt.q, qt.scale, qt.zero, ops.int8_dequantize(qt),
                          wq.q, wq.scale, wq.zero, wout)
        elif label.startswith("wire"):
            res[label] = tuple(tick_wire(ops, name)(x))
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
            want = (*want, ops.int8_dequantize_ref(want))
            got = res[label]
            ok = all(cs.same_values(a, b)
                     for a, b in zip(got, want + want))
        elif label.startswith("wire"):
            ok = all(cs.same_values(a, b) for a, b in zip(
                res[label], ops.wire_roundtrip_grouped_ref(x)))
        else:
            z, mask, g, k = x
            tot, cnt, dz = res[label]
            w_tot, w_cnt = ops.laplacian_energy_ref(z, mask, k)
            ok = torch.allclose(tot, w_tot, rtol=cs.LAP_RTOL, atol=0.0) \
                and torch.equal(cnt, w_cnt)
        if not ok:
            failures.append(f"{name}: {label} != plain version")


def times(ops, xs, name):
    """{label: device µs} of one set of libraries, the wire as tree
    ``name`` launches it."""
    out = {}
    for label, x in xs.items():
        if label.startswith("quant"):
            out[label] = cs.device_ms(ops.int8_quantize, x) * 1e3
            out["de" + label] = cs.device_ms(
                ops.int8_dequantize, ops.int8_quantize(x)) * 1e3
            out["frame wire " + label] = cs.device_ms(
                frame_wire(ops, name), x) * 1e3
        elif label.startswith("wire"):
            out[label] = cs.device_ms(tick_wire(ops, name), x) * 1e3
            if name == "this":
                out[label + ", a launch a bucket"] = cs.device_ms(
                    tick_wire(ops, "other"), x) * 1e3
        else:
            z, mask, g, k = x
            out[label] = cs.device_ms(
                lambda a: ops.laplacian_energy(*a, k), (z, mask)) * 1e3
            if not label.endswith("refine"):
                out[label + " bwd"] = cs.device_ms(
                    lambda a: ops.laplacian_energy_bwd(*a, k),
                    (z, mask, g)) * 1e3
    for pre in ("quant", "dequant", "frame wire quant"):
        out[f"{pre} per frame"] = sum(
            v for key, v in out.items() if key.startswith(f"{pre} k="))
    return out


def as_tree(ops, eng, name):
    """Make ``SplitEngine`` launch the wire as tree ``name`` does: OTHER's
    frame as quantize then dequantize, its tick as one chain a bucket
    (``run_batch_async`` each, one wire launch a bucket)."""
    from repro_torch.kernels import int8_quant
    ops.int8_quantize_roundtrip = (int8_quant.int8_quantize_roundtrip
                                   if name == "this"
                                   else frame_wire(ops, "other"))
    if name == "this":
        eng.__dict__.pop("run_buckets_async", None)
    else:
        eng.run_buckets_async = lambda params, batches: [
            eng.run_batch_async(params, m, k) for k, m in batches]


def device_busy_ms(fn):
    """Device time of one ``fn()`` under ``torch.profiler`` -> (all
    kernels and copies, the wire kernels' part), ms."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
    events = [(e.name, e.time_range.elapsed_us()) for e in prof.events()
              if e.device_type == DeviceType.CUDA]
    wire = sum(us for n, us in events
               if "wire_roundtrip" in n or "quantize" in n)
    return sum(us for _, us in events) / 1e3, wire / 1e3


def paths(cfg, dev, ops):
    """-> a function of the tree's name that runs the per-frame split
    path (``SplitEngine.run`` on 256 frames) and the serving tick (phase
    2's gateway) as that tree launches the wire, and returns their host
    and device times."""
    import time

    import numpy as np

    from repro_torch.core.splitter import SplitEngine
    from repro_torch.models.audio_encoder import init_audio_encoder
    from repro_torch.weights import to_device
    host_params = init_audio_encoder(cfg, torch.Generator().manual_seed(2))
    params = to_device(host_params, dev)
    eng = SplitEngine(cfg, device=dev)
    mels = np.random.default_rng(2).standard_normal(
        (cs.SESSIONS, 1, cfg.frames, cfg.n_mels), np.float32)
    ks = [i % (cfg.n_blocks + 1) for i in range(cs.SESSIONS)]
    gw, sids = cs.gateway(cfg, host_params, "cuda")

    def run():
        for mel, k in zip(mels, ks):
            eng.run(params, mel, k)
        torch.cuda.synchronize()

    def ticks(n):
        return cs.serve(gw, sids, [mels[:, 0]] * n, timed=False)[1]

    def measure(name):
        as_tree(ops, eng, name)
        as_tree(ops, gw.engine, name)
        run()                                   # warm-up
        t0 = time.perf_counter()
        run()
        host = (time.perf_counter() - t0) * 1e3 / len(ks)
        busy, wire = device_busy_ms(run)
        ticks(1)
        secs = ticks(cs.TIMED_TICKS)
        t_busy, t_wire = device_busy_ms(lambda: ticks(1))
        return {"per-frame path, host a frame": host * 1e3,
                "per-frame path, device a frame": busy * 1e3 / len(ks),
                "per-frame path, wire device a frame": wire * 1e3 / len(ks),
                "tick p50 (ms)": float(np.percentile(secs, 50)) * 1e3,
                "tick device busy": t_busy * 1e3,
                "tick wire device": t_wire * 1e3}
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
        res[name] = outputs(ops, xs, name)
        hold(ops, xs, res[name], failures, name)
    for label in xs:
        lap = not label.startswith(("quant", "wire"))
        same, mine = (res[n][label][2:] if lap else res[n][label]
                      for n in ("other", "this"))
        if not all(cs.same_values(a, b) for a, b in zip(same, mine)):
            failures.append(f"{label}: the two libraries' "
                            + ("laplacian_energy_bwd" if lap else "wire")
                            + " differ")
    aminmax = sum(cs.device_ms(torch.aminmax, x) for label, x in xs.items()
                  if label.startswith("quant k=")) * 1e3
    print(f"torch.aminmax per frame (8 boundary shapes, summed): "
          f"{aminmax:.2f} us")
    measure = paths(CFG, dev, ops)
    readings = {"other": [], "this": []}
    for name in ("other", "this", "this", "other"):
        use(build, libs[name], plans[name])
        t = times(ops, xs, name)
        t.update(measure(name))
        readings[name].append(t)
        print(f"{name}: " + ", ".join(f"{k} {v:.2f}" for k, v in t.items()))
    for label in readings["this"][0]:
        m = [r[label] for r in readings["this"]]
        o = [r.get(label) for r in readings["other"]]
        if None in o:
            print(f"{label}: this {m[0]:.2f} / {m[1]:.2f}")
            continue
        print(f"{label}: other {o[0]:.2f} / {o[1]:.2f}, this {m[0]:.2f} / "
              f"{m[1]:.2f}; this / other {sum(m) / sum(o):.3f}")
    for f in failures:
        print(f"kernel_ab: FAIL: {f}")
    sys.exit(1 if failures else 0)


if __name__ == "__main__":
    main()
