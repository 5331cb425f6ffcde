"""Uncertainty-routed adaptive serving through the gateway: the paper's
offload policy as a serving pattern — easy (low GMM-entropy) frames stay
fully local on the edge tier, hard frames escalate so the server runs the
deep suffix of the stack.

The ``entropy`` ``SplitPolicy`` is the cascade's threshold routing behind
the unified API: every tick the escalated frames share one padded split
dispatch and the local frames share another.

The hand-rolled ``submit``/``tick`` loop below is the diagnostic way to
drive the pipeline: it runs ``tick(profile=True)``, which waits after
each bucket, to attribute latency to each tier (one device sync a bucket
and one for the tick's copy; each escalated bucket's wire is its own
one-group ``wire_roundtrip`` launch).  To serve a fleet, use the
always-on streaming runtime, ``runtime/streaming_demo.py``.

Port of ``examples/adaptive_serving.py``: the gateway runs on ``device``
(the card by default; ``--device cpu`` for the plain PyTorch path), and
``main`` returns the numbers it prints.  ``params`` (port layout)
replaces the seeded encoder weights when given; ``on_tick(gw, results)``
is called after each tick.

    PYTHONPATH=src python -m repro_torch.runtime.adaptive_serving \\
        [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.api import FrameRequest, StreamSplitGateway, make_policy
from repro_torch.models.audio_encoder import AudioEncCfg, init_audio_encoder

CFG = AudioEncCfg(widths=(16, 16, 32, 32), strides=(1, 2, 1, 2),
                  n_mels=32, frames=40, d_embed=32, groups=4)
N_SESSIONS = 16
N_TICKS = 10
THRESHOLD = 0.7           # paper §6.5.2: offload when U_t > 0.7


def main(device="cuda", params=None, on_tick=None) -> dict:
    if params is None:
        params = init_audio_encoder(CFG, torch.Generator().manual_seed(0))
    gw = StreamSplitGateway(
        CFG, params,
        policy=make_policy("entropy", CFG.n_blocks, threshold=THRESHOLD,
                           offload_k=2),
        capacity=N_SESSIONS, window=32, qos_reserve=0, device=device)
    sids = [gw.open_session().sid for _ in range(N_SESSIONS)]
    rng = np.random.default_rng(0)

    lat = {"edge": [], "split": []}
    results = []
    for t in range(N_TICKS):
        for sid in sids:
            # bimodal uncertainty: mostly calm background, occasional
            # transients (the EcoStream-Wild regime mix)
            u = rng.uniform(0.75, 1.0) if rng.random() < 0.25 \
                else rng.uniform(0.05, 0.5)
            mel = rng.normal(size=(CFG.frames, CFG.n_mels)).astype(np.float32)
            gw.submit(sid, FrameRequest(t=t, mel=mel, u=float(u),
                                        bandwidth_mbps=20.0))
        # profile=True: per-bucket timing (one sync per bucket) so the two
        # tiers are attributable; the serving default is the overlapped
        # single-sync tick, whose latency_ms is a per-tick figure
        out = gw.tick(profile=True)
        if on_tick is not None:
            on_tick(gw, out)
        results += out
        for r in out:
            if t > 0:          # steady state: tick 0 pays the first calls
                lat[r.route].append(r.latency_ms)

    s = gw.stats()
    esc = s.routed["split"] / max(s.frames, 1)
    edge_ms, split_ms = (float(np.median(lat[k])) for k in ("edge", "split"))
    print(f"served {s.frames} frames over {s.ticks} ticks in "
          f"{s.dispatches} dispatches ({s.frames_per_dispatch:.1f} "
          f"frames/dispatch)")
    print(f"escalation rate {esc:.2f} (threshold U>{THRESHOLD}) | "
          f"edge tier {edge_ms:.2f} ms/frame | "
          f"escalated tier {split_ms:.2f} ms/frame "
          f"(median, profile mode: amortized over each bucket)")
    print(f"split-link traffic {s.wire_bytes/1024:.1f} KB — "
          f"{100*(1-esc):.0f}% of frames never ship an activation")
    for sid in sids:
        gw.close_session(sid)
    return {"results": results, "stats": s, "escalation_rate": esc,
            "edge_ms_per_frame": edge_ms, "split_ms_per_frame": split_ms}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description="adaptive serving")
    ap.add_argument("--device", default="cuda")
    main(device=ap.parse_args().device)
