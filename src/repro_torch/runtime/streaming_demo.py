"""Serve a fleet, continuously: the canonical StreamSplit entry point.

No hand-rolled ``submit``/``tick`` loop — clients stream frames into an
always-on ``StreamServer`` from their own threads and the serving thread
does the rest: bounded per-QoS-class ingest queues, a deadline-aware
tick scheduler (INTERACTIVE rides first; BULK is preempted under load
and re-queued, never dropped), and cross-tick pipelining over the
gateway's ``tick_launch``/``tick_collect`` seam — tick t+1 stages while
tick t's device chains are still in flight, with one device sync per
tick throughout (docs/STREAMING.md).

Three client tiers share one fleet here: a couple of latency-critical
INTERACTIVE microphones, a few STANDARD monitors, and a crowd of BULK
backfill uploaders that soak up whatever capacity is left.

One server is one gateway; to scale past a single gateway — and drain
one live for a rolling restart without dropping a stream — see
``runtime/cluster_demo.py`` (the ``GatewayCluster`` federation).

Port of ``examples/streaming_demo.py``: the gateway runs on ``device``
(the card by default; ``--device cpu`` for the plain PyTorch path), and
``main`` returns the numbers it prints.

    PYTHONPATH=src python -m repro_torch.runtime.streaming_demo [--device cpu]
"""
import argparse
import threading
import time

import numpy as np
import torch

from repro_torch.api import (FrameRequest, QoSClass, StreamSplitGateway,
                             make_policy)
from repro_torch.models.audio_encoder import AudioEncCfg, init_audio_encoder
from repro_torch.serving import QueueFullError, SchedulerCfg, StreamServer

CFG = AudioEncCfg(widths=(16, 16, 32, 32), strides=(1, 2, 1, 2),
                  n_mels=32, frames=40, d_embed=32, groups=4)
TIERS = {QoSClass.INTERACTIVE: 2, QoSClass.STANDARD: 4, QoSClass.BULK: 10}
FRAMES_PER_CLIENT = 40
THRESHOLD = 0.7            # paper §6.5.2: offload when U_t > 0.7


def client(server, sid, qos, rng):
    """One streaming client: capture -> submit -> (backpressure) retry."""
    for t in range(FRAMES_PER_CLIENT):
        u = rng.uniform(0.75, 1.0) if rng.random() < 0.25 \
            else rng.uniform(0.05, 0.5)
        mel = rng.normal(size=(CFG.frames, CFG.n_mels)).astype(np.float32)
        frame = FrameRequest(t=t, mel=mel, u=float(u), bandwidth_mbps=20.0)
        while True:
            try:
                server.submit(sid, frame)
                break
            except QueueFullError:        # bounded queue: typed backpressure
                time.sleep(1e-3)
        # INTERACTIVE clients pace like live mics; BULK dumps as fast as
        # admission allows
        if qos is QoSClass.INTERACTIVE:
            time.sleep(2e-3)
    server.close_session(sid)             # drains, then evicts


def main(device="cuda") -> dict:
    params = init_audio_encoder(CFG, torch.Generator().manual_seed(0))
    gw = StreamSplitGateway(
        CFG, params,
        policy=make_policy("entropy", CFG.n_blocks, threshold=THRESHOLD,
                           offload_k=2),
        capacity=32, window=32, device=device)
    # deadline budgets sized to this host's tick cadence (the defaults
    # in serving.DEADLINE_MS assume accelerator-class tick latency)
    server = StreamServer(
        gw, cfg=SchedulerCfg(max_batch=16,
                             deadline_ms={QoSClass.INTERACTIVE: 250.0,
                                          QoSClass.STANDARD: 1000.0,
                                          QoSClass.BULK: 4000.0}),
        queue_maxlen=64)

    # Warm the whole serving surface BEFORE going live: with the entropy
    # policy a tick is (edge bucket, split bucket) — tick every pow2
    # size pair once so the first call at each batch shape (convolution
    # algorithm choice, pinned staging buffers) lands here, not under
    # live traffic, where it would poison the wait percentiles
    rng = np.random.default_rng(1)
    wsid = gw.open_session().sid
    for s_lo in (0, 1, 2, 4, 8, 16):
        for s_hi in (0, 1, 2, 4, 8, 16):
            if s_lo + s_hi == 0:
                continue
            for j, u in enumerate([0.1] * s_lo + [0.9] * s_hi):
                gw.submit(wsid, FrameRequest(
                    t=j, mel=rng.normal(
                        size=(CFG.frames, CFG.n_mels)).astype(np.float32),
                    u=u))
            gw.tick()
    gw.close_session(wsid)

    threads, rng = [], np.random.default_rng(0)
    with server:                          # starts the serving thread
        for qos, count in TIERS.items():
            for _ in range(count):
                sid = server.open_session(qos=qos).sid
                threads.append(threading.Thread(
                    target=client,
                    args=(server, sid, qos,
                          np.random.default_rng(rng.integers(1 << 31)))))
        for th in threads:
            th.start()
        for th in threads:
            th.join()

    st = server.stats()
    g = st.gateway
    n_clients = sum(TIERS.values())
    print(f"served {sum(st.frames_served.values())} frames from "
          f"{n_clients} clients over {st.ticks} ticks "
          f"({st.pipelined_ticks} pipelined, "
          f"{g.device_syncs_per_tick} device sync/tick)")
    for cls in ("interactive", "standard", "bulk"):
        w = st.queue_wait_ms[cls]
        print(f"  {cls:>11}: {st.frames_served[cls]:4d} served | queue "
              f"wait p50 {w['p50']:6.2f} ms  p95 {w['p95']:6.2f} ms | "
              f"{st.deadline_misses[cls]} deadline misses | "
              f"{st.preempted[cls]} preempted (all re-queued)")
    esc = g.routed["split"] / max(g.frames, 1)
    print(f"escalation rate {esc:.2f} (threshold U>{THRESHOLD}) | "
          f"split-link traffic {g.wire_bytes / 1024:.1f} KB")
    assert sum(st.frames_served.values()) == n_clients * FRAMES_PER_CLIENT
    assert st.preempted == st.requeued    # conservation, always
    return {"served": sum(st.frames_served.values()), "ticks": st.ticks,
            "pipelined_ticks": st.pipelined_ticks,
            "device_syncs_per_tick": g.device_syncs_per_tick,
            "escalation_rate": esc,
            "queue_wait_ms": {c: dict(w) for c, w in
                              st.queue_wait_ms.items()},
            "deadline_misses": dict(st.deadline_misses),
            "preempted": dict(st.preempted)}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description="the streaming demo")
    ap.add_argument("--device", default="cuda")
    main(device=ap.parse_args().device)
