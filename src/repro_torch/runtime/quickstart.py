"""Quickstart: the StreamSplit public API in ~60 lines.

One typed surface runs the whole pipeline — open a session on the
gateway, submit frames, tick: uncertainty-driven split placement,
k-bucketed batched dispatch, INT8 wire accounting, temporal-buffer
ingest, hybrid-loss refinement and lazy sync all happen behind
``StreamSplitGateway``.

Port of ``examples/quickstart.py``: the gateway runs on ``device`` (the
card by default; ``--device cpu`` for the plain PyTorch path), and
``main`` returns the numbers it prints.  ``params`` (the encoder's, port
layout) and ``backend`` (a ``HostFleetBackend`` with its head and refine
draws) replace the seeded ones when given; ``on_tick(gw, results)`` is
called after each tick.

    PYTHONPATH=src python -m repro_torch.runtime.quickstart [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.api import (FrameRequest, QoSClass, StreamSplitGateway,
                             make_policy)
from repro_torch.models.audio_encoder import AudioEncCfg, init_audio_encoder

# A smoke-scale encoder (the paper's model family, small widths).
CFG = AudioEncCfg(widths=(16, 16, 32, 32), strides=(1, 2, 1, 2),
                  n_mels=32, frames=40, d_embed=32, groups=4)
N_CLASSES = 4
N_FRAMES = 12


def head_init(generator):
    return {"w": 0.01 * torch.randn(CFG.d_embed, N_CLASSES,
                                    generator=generator)}


def head_apply(p, z):
    return z @ p["w"]


def main(device="cuda", params=None, backend=None, on_tick=None) -> dict:
    if params is None:
        params = init_audio_encoder(CFG, torch.Generator().manual_seed(0))

    # 1. The gateway IS the pipeline: an entropy policy (the cascade's
    #    routing as a SplitPolicy) + a fleet buffer + a refiner + lazy sync
    #    in one box.
    gw = StreamSplitGateway(
        CFG, params,
        policy=make_policy("entropy", CFG.n_blocks, threshold=0.6,
                           offload_k=2),
        backend=backend, capacity=8, window=32, head_init=head_init,
        head_apply=head_apply, refine_every=4, device=device)

    # 2. Sessions are typed and QoS-classed.
    info = gw.open_session(platform="pi4", qos=QoSClass.INTERACTIVE)
    print(f"session {info.sid} open ({info.platform}, {info.qos.value})")

    # 3. Stream frames: easy (low-U) frames stay on the edge, hard ones
    #    split.
    rng = np.random.default_rng(0)
    results = []
    for t in range(N_FRAMES):
        u = 0.2 if t % 3 else 0.9          # every third frame is "hard"
        mel = rng.normal(size=(CFG.frames, CFG.n_mels)).astype(np.float32)
        gw.submit(info.sid, FrameRequest(t=t, mel=mel, label=t % N_CLASSES,
                                         u=u, cpu=0.3, bandwidth_mbps=20.0))
        (r,) = out = gw.tick()
        if on_tick is not None:
            on_tick(gw, out)
        results.append(r)
        print(f"frame {t}: U={u:.1f} -> route={r.route:6s} k={r.k} "
              f"wire={r.wire_bytes:5d} B  z[:3]={np.round(r.z[:3], 3)}")

    # 4. One scoreboard for the whole serving plane.
    s = gw.stats()
    print(f"\n{s.frames} frames in {s.dispatches} dispatches "
          f"({s.frames_per_dispatch:.1f} frames/dispatch), "
          f"routed={s.routed}, wire={s.wire_bytes / 1024:.1f} KB, "
          f"refine rounds={s.refine_rounds} (last loss "
          f"{s.last_refine_loss:.3f}), lazy sync={s.sync_bytes / 1024:.0f} KB")
    final = gw.close_session(info.sid)
    print(f"closed session {final.sid}: {final.frames} frames, "
          f"{final.transitions} atomic split transitions, "
          f"buffer fill {final.fill_fraction:.2f}")
    return {"results": results, "stats": s, "final": final}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description="the quickstart")
    ap.add_argument("--device", default="cuda")
    main(device=ap.parse_args().device)
