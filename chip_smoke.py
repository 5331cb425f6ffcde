#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root, one CUDA card

It builds every hand-written CUDA kernel from ``src/repro_torch`` and
then drives the port's serving path at the paper's full encoder width.

Phase 1 holds each kernel against its plain PyTorch version on the card,
bitwise, at every shape the serving path gives it (plus constant and
outlier rows), and the wire kernel at B=1 against the per-tensor
quantize∘dequantize.

Phase 2 runs ``StreamSplitGateway`` (``AudioEncCfg()``, random weights
from a seed, a host fleet of 256 sessions x 100 frames, refine off)
with a policy that spreads k = 0..8 over the sessions: 9 buckets a tick,
each padded to 32 frames.  One warm-up tick and 8 timed ticks, with the
kernels' launch counts set to 0 just before and read just after.  It
checks results, counters and launches, compares the first tick with
``overlap=False`` on the card (bitwise) and with the same port run on
the CPU (atol 1e-4), and times each kernel at the shapes of the run.

Any failure exits non-zero.  Without a CUDA device, or outside a
checkout of the repository, it exits non-zero before printing any
result.  The line before the last is the kernels' JSON record; the last
line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
SESSIONS = 256
TIMED_TICKS = 8
# NVIDIA H100 SXM data sheet: HBM3 bandwidth and float32 (non-tensor) peak
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
BATCH_SIZES = (1, 3, 8, 32, 256)
CPU_ATOL = 1e-4


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


class SpreadPolicy:
    """Frame i of a tick gets k = i % (L+1): every split index, every
    tick, in buckets of equal size (+-1)."""

    def __init__(self, L):
        self.L = L

    def decide(self, obs_batch):
        return np.arange(len(obs_batch), dtype=np.int64) % (self.L + 1)


def wire_widths(cfg):
    """Elements per frame that cross the wire at k = 0..L-1: the raw mel
    at k=0, then the activation after block k ("SAME" convolutions keep
    ⌈t/s⌉ frames)."""
    out, t = [cfg.frames * cfg.n_mels], cfg.frames
    for w, s in zip(cfg.widths[:-1], cfg.strides[:-1]):
        t = -(-t // s)
        out.append(t * w)
    return out


def time_ms(fn, x, reps=200):
    """Mean ms per call of ``fn(x)`` over ``reps`` calls, CUDA events."""
    for _ in range(10):
        fn(x)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn(x)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase1(cfg, dev, ops, dequantize, quantize):
    """Each kernel against its plain version on the card -> max |err|."""
    g = torch.Generator(device=dev).manual_seed(0)
    worst = 0.0
    for n in sorted(set(wire_widths(cfg))):
        for B in BATCH_SIZES:
            x = torch.randn(B, n, device=dev, generator=g) * 3.0 + 1.0
            if B >= 3:
                x[0] = 1.25                  # constant row: scale floor
                x[1, 17] = 1e4               # outlier row
            got = ops.wire_roundtrip(x)
            want = ops.wire_roundtrip_ref(x)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            worst = max(worst, err)
            check(torch.equal(got, want),
                  f"wire_roundtrip != plain version at B={B}, n={n} "
                  f"(max |err| {err})")
        x = torch.randn(1, n, device=dev, generator=g)
        check(torch.equal(ops.wire_roundtrip(x), dequantize(quantize(x))),
              f"wire_roundtrip at B=1, n={n} != per-tensor round trip")
    torch.cuda.synchronize()
    print(f"phase 1: wire_roundtrip bitwise == plain version at B in "
          f"{BATCH_SIZES} x n in {sorted(set(wire_widths(cfg)))}, and == "
          f"per-tensor at B=1 (max |err| {worst})")
    return worst


def serve(gw, sids, mels_by_tick, *, timed, t0=0):
    """Submit and tick, frame indices from ``t0``; -> (results of each
    tick, tick seconds)."""
    from repro_torch.api import FrameRequest
    out, secs = [], []
    for t, mels in enumerate(mels_by_tick, start=t0):
        for i, sid in enumerate(sids):
            gw.submit(sid, FrameRequest(t=t, mel=mels[i]))
        start = time.perf_counter()
        out.append(gw.tick())
        secs.append(time.perf_counter() - start)
        if timed:
            s = gw.stats()
            check(s.device_syncs_per_tick == 1 and s.d2h_copies_per_tick == 1,
                  f"tick {t}: {s.device_syncs_per_tick} syncs, "
                  f"{s.d2h_copies_per_tick} D2H copies (want 1 and 1)")
    return out, secs


def gateway(cfg, params, device, **kw):
    from repro_torch.api import HostFleetBackend, QoSClass, StreamSplitGateway
    gw = StreamSplitGateway(
        cfg, params, policy=SpreadPolicy(cfg.n_blocks),
        backend=HostFleetBackend(capacity=SESSIONS, window=100,
                                 dim=cfg.d_embed),
        qos_reserve=0, device=device, **kw)
    sids = [gw.open_session(qos=QoSClass.INTERACTIVE).sid
            for _ in range(SESSIONS)]
    return gw, sids


def phase2(cfg, dev, ops):
    """The serving path at full width, then comparisons and one profiled
    tick -> the kernels' launch counts from the counted run."""
    from repro_torch.core.splitter import SplitEngine
    from repro_torch.models.audio_encoder import init_audio_encoder
    from repro_torch.weights import to_device
    L = cfg.n_blocks
    params = init_audio_encoder(cfg, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    mels = [rng.standard_normal((SESSIONS, cfg.frames, cfg.n_mels),
                                np.float32) for _ in range(1 + TIMED_TICKS)]
    gw, sids = gateway(cfg, params, "cuda")

    # --- the main path, counted: warm-up tick + timed ticks -------------
    for wrapper in ops.KERNELS.values():
        wrapper.launches = 0
    per_tick = []
    results, secs = [], []
    for t in range(1 + TIMED_TICKS):
        before = ops.wire_roundtrip.launches
        res, sec = serve(gw, sids, [mels[t]], timed=True, t0=t)
        results += res
        secs += sec
        per_tick.append(ops.wire_roundtrip.launches - before)
    launches = {name: w.launches for name, w in ops.KERNELS.items()}
    torch.cuda.synchronize()

    for t, res in enumerate(results):
        check(len(res) == SESSIONS, f"tick {t}: {len(res)} results")
        check([r.sid for r in res] == sids, f"tick {t}: not in submission "
              "order")
        z = np.stack([r.z for r in res])
        check(z.shape == (SESSIONS, cfg.d_embed) and np.isfinite(z).all(),
              f"tick {t}: embeddings not finite or of shape {z.shape}")
        norm_err = float(np.abs(np.linalg.norm(z, axis=1) - 1.0).max())
        check(norm_err <= 1e-5, f"tick {t}: | ||z|| - 1 | = {norm_err}")
        check(sorted({r.k for r in res}) == list(range(L + 1)),
              f"tick {t}: not every k served")
        check({r.bucket_size for r in res} <= {28, 29}, "bucket sizes")
        for r in res:
            want = 0 if r.k == L else wire_widths(cfg)[r.k] + 8
            check(r.wire_bytes == want, f"k={r.k}: wire bytes {r.wire_bytes}")
    check(per_tick == [L] * (1 + TIMED_TICKS),
          f"wire kernel launches per tick {per_tick}, want {L} (k=0..{L-1})")
    check(launches["wire_roundtrip"] == L * (1 + TIMED_TICKS),
          f"launches {launches}")
    stats = gw.stats()
    want_staged = (1 + TIMED_TICKS) * SESSIONS * cfg.frames * cfg.n_mels * 4
    check(stats.staged_h2d_bytes == want_staged,
          f"staged_h2d_bytes {stats.staged_h2d_bytes} != {want_staged}")
    check(stats.frames == (1 + TIMED_TICKS) * SESSIONS
          and stats.dispatches == (1 + TIMED_TICKS) * (L + 1), "counters")
    tick_ms = np.array(secs[1:]) * 1e3
    print(f"phase 2: {1 + TIMED_TICKS} ticks x {SESSIONS} frames at full "
          f"width, 1 sync + 1 D2H per tick, {L} wire launches per tick, "
          f"staged {stats.staged_h2d_bytes} bytes")
    print(f"tick ms p50 {np.percentile(tick_ms, 50):.3f} p95 "
          f"{np.percentile(tick_ms, 95):.3f} mean {tick_ms.mean():.3f}; "
          f"frames/s {SESSIONS / tick_ms.mean() * 1e3:.1f} "
          f"(warm-up tick {secs[0] * 1e3:.1f} ms)")

    # --- comparisons (outside the counted run) ----------------------------
    first = np.stack([r.z for r in results[0]])
    gw_sync, sids_sync = gateway(cfg, params, "cuda", overlap=False)
    (res_sync,), _ = serve(gw_sync, sids_sync, [mels[0]], timed=False)
    check(np.array_equal(np.stack([r.z for r in res_sync]), first),
          "overlap=False on the card != overlap=True")
    gw_cpu, sids_cpu = gateway(cfg, params, "cpu")
    (res_cpu,), _ = serve(gw_cpu, sids_cpu, [mels[0]], timed=False)
    cpu_err = float(np.abs(np.stack([r.z for r in res_cpu]) - first).max())
    check(cpu_err <= CPU_ATOL, f"card vs CPU max |dz| {cpu_err}")
    eng = SplitEngine(cfg, device=dev)
    p_dev = to_device(params, dev)
    frame_err = 0.0
    for i, r in enumerate(results[0]):
        z, _ = eng.run(p_dev, mels[0][i:i + 1], r.k)
        frame_err = max(frame_err, float(np.abs(z.cpu().numpy()[0]
                                                - r.z).max()))
    print(f"overlap=False == overlap=True bitwise; card vs CPU port max "
          f"|dz| {cpu_err:.3e} (atol {CPU_ATOL}); bucketed vs per-frame "
          f"SplitEngine.run max |dz| {frame_err:.3e}")
    profile_tick(gw, sids, mels[0], 1 + TIMED_TICKS, tick_ms)
    return launches


def device_ms(fn, x, reps=40, spin_cycles=200_000_000):
    """Mean device ms per call of ``fn(x)``: a spin kernel holds the
    stream while the host enqueues ``reps`` calls, so they run back to
    back and the CUDA events time the device, not the host's launch
    overhead.  Fails if the host took longer to enqueue than the spin."""
    for _ in range(3):
        fn(x)
    spin, start, end = (torch.cuda.Event(enable_timing=True)
                        for _ in range(3))
    torch.cuda.synchronize()
    spin.record()
    torch.cuda._sleep(spin_cycles)
    start.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn(x)
    host_ms = (time.perf_counter() - t0) * 1e3
    end.record()
    torch.cuda.synchronize()
    check(host_ms < spin.elapsed_time(start),
          f"enqueue of {reps} calls ({host_ms:.1f} ms) outlasted the spin")
    return start.elapsed_time(end) / reps


def profile_tick(gw, sids, mels, t, tick_ms):
    """One more tick under torch.profiler: device time by kind of kernel
    and the device's idle share of an unprofiled tick."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        serve(gw, sids, [mels], timed=False, t0=t)
    events = [(e.name, e.time_range.elapsed_us()) for e in prof.events()
              if e.device_type == DeviceType.CUDA]
    if not events:
        print("profiled tick: not measured (torch.profiler recorded no "
              "device activity)")
        return
    kinds = {"conv": 0.0, "wire": 0.0, "copy": 0.0, "other": 0.0}
    count = 0
    for name, us in events:
        low = name.lower()
        kind = ("wire" if "wire_roundtrip" in low
                else "copy" if low.startswith(("memcpy", "memset"))
                else "conv" if any(w in low for w in (
                    "conv", "xmma", "gemm", "cudnn", "winograd", "fft"))
                else "other")
        kinds[kind] += us
        count += 1
    busy_ms = sum(kinds.values()) / 1e3
    p50 = float(np.percentile(tick_ms, 50))
    print(f"profiled tick: {count} device activities, busy {busy_ms:.3f} ms "
          f"(" + ", ".join(f"{k} {v / 1e3:.3f} ms" for k, v in kinds.items())
          + f"); idle share of the unprofiled p50 tick ({p50:.3f} ms): "
          f"{1.0 - busy_ms / p50:.3f}")


def kernel_times(cfg, dev, ops):
    """Per-k wire kernel vs plain version at the serving shapes (32 rows,
    the padded bucket): device time (``device_ms``) and time per call
    (CUDA events around back-to-back calls, which the host's launch
    overhead sets when it exceeds the device time) -> per-tick sums and
    the bound."""
    bucket = 32
    g = torch.Generator(device=dev).manual_seed(1)
    tot = dict.fromkeys(("ms", "plain_ms", "call_ms", "plain_call_ms",
                         "bytes_ms", "ops_ms"), 0.0)
    for k, n in enumerate(wire_widths(cfg)):
        x = torch.randn(bucket, n, device=dev, generator=g)
        ms = device_ms(ops.wire_roundtrip, x)
        plain = device_ms(ops.wire_roundtrip_ref, x)
        call = time_ms(ops.wire_roundtrip, x)
        plain_call = time_ms(ops.wire_roundtrip_ref, x)
        nbytes = 8 * bucket * n               # read x once, write out once
        # min + max + div + add + round + 2 clamps + sub + mul per element
        nops = 9 * bucket * n
        b_ms = nbytes / HBM_BYTES_PER_S * 1e3
        o_ms = nops / FP32_OPS_PER_S * 1e3
        print(f"wire k={k} ({bucket}, {n}): device kernel {ms * 1e3:.2f} us, "
              f"plain {plain * 1e3:.2f} us; per call kernel {call * 1e3:.2f}"
              f" us, plain {plain_call * 1e3:.2f} us; bound "
              f"{max(b_ms, o_ms) * 1e3:.2f} us "
              f"({'bytes' if b_ms >= o_ms else 'operations'})")
        for key, v in (("ms", ms), ("plain_ms", plain), ("call_ms", call),
                       ("plain_call_ms", plain_call), ("bytes_ms", b_ms),
                       ("ops_ms", o_ms)):
            tot[key] += v
    print(f"wire per tick (8 launches): device kernel {tot['ms'] * 1e3:.2f} "
          f"us, plain {tot['plain_ms'] * 1e3:.2f} us; per call kernel "
          f"{tot['call_ms'] * 1e3:.2f} us, plain "
          f"{tot['plain_call_ms'] * 1e3:.2f} us")
    return tot


def main():
    if not torch.cuda.is_available():
        fail("torch sees no CUDA device")
    src = os.path.join(ROOT, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        fail(f"no src/repro_torch beside {__file__}: run it from a checkout "
             "of the repository")
    sys.path.insert(0, src)
    from repro_torch.configs.streamsplit_audio import CFG
    from repro_torch.kernels import build, ops
    from repro_torch.quant.int8 import dequantize, quantize

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip())
    dev = ops.resolve_device("cuda")
    t0 = time.perf_counter()
    libs = build.build_all()
    print(f"build: {time.perf_counter() - t0:.2f} s for "
          f"{[os.path.basename(p) for p in libs]}")

    worst = phase1(CFG, dev, ops, dequantize, quantize)
    launches = phase2(CFG, dev, ops)
    tot = kernel_times(CFG, dev, ops)
    print("kernels: " + ", ".join(f"{n} launches={c}"
                                  for n, c in launches.items()))
    bound_by = "bytes" if tot["bytes_ms"] >= tot["ops_ms"] else "operations"
    print(json.dumps({"kernels": [{
        "name": "wire_roundtrip", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/wire_roundtrip.cu",
        "replaces": "src/repro/kernels/int8_quant.py:90",
        "launches": launches["wire_roundtrip"], "max_abs_err": worst,
        "ms": tot["ms"], "plain_ms": tot["plain_ms"],
        "bound_ms": max(tot["bytes_ms"], tot["ops_ms"]),
        "bound_by": bound_by, "library_ms": None}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
