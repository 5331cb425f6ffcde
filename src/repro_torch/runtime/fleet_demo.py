"""Fleet serving demo: 32 heterogeneous simulated clients (Pi4 + M2 over
mixed network profiles) driving one gateway through the full fleet
lifecycle — QoS-classed admission -> per-client split decisions +
k-bucketed dispatch -> periodic batched refinement -> eviction.

Each client runs the calibrated edge-cloud simulator (``core/env.py``);
frames whose in-flight placement times out (drops) are never submitted,
which is exactly the gap-mask regime the Laplacian term stitches across.
The gateway refines every client session in one ``FleetRefiner`` step
per round and serves every tick's frames as a handful of padded
dispatches instead of one per frame.

Port of ``examples/fleet_demo.py``: the gateway runs on ``device`` (the
card by default; ``--device cpu`` for the plain PyTorch path), and
``main`` returns the numbers it prints.  ``params`` (the encoder's, port
layout) and ``backend`` (a ``HostFleetBackend`` with its head and refine
draws) replace the seeded ones when given; ``on_tick(gw, results)`` is
called after each tick.

    PYTHONPATH=src python -m repro_torch.runtime.fleet_demo [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.api import (FrameRequest, QoSClass, StreamSplitGateway,
                             make_policy)
from repro_torch.core.env import NET_PROFILES, EdgeCloudEnv, EnvCfg
from repro_torch.models.audio_encoder import AudioEncCfg, init_audio_encoder

CFG = AudioEncCfg(widths=(16, 16, 32, 32), strides=(1, 2, 1, 2),
                  n_mels=32, frames=40, d_embed=32, groups=4)
N_CLIENTS = 32
WINDOW = 50
N_CLASSES = 4
ROUNDS = 6
FRAMES_PER_ROUND = WINDOW // 2
REFINE_LR = 0.5


def head_init(generator):
    return {"w": 0.01 * torch.randn(CFG.d_embed, N_CLASSES,
                                    generator=generator)}


def head_apply(p, z):
    return z @ p["w"]


def main(device="cuda", params=None, backend=None, on_tick=None) -> dict:
    rng = np.random.default_rng(0)
    nets = list(NET_PROFILES)
    if params is None:
        params = init_audio_encoder(CFG, torch.Generator().manual_seed(0))
    gw = StreamSplitGateway(
        CFG, params, policy=make_policy("rule", CFG.n_blocks),
        backend=backend, capacity=N_CLIENTS, window=WINDOW,
        head_init=head_init, head_apply=head_apply,
        refine_every=FRAMES_PER_ROUND, refine_lr=REFINE_LR, qos_reserve=0,
        device=device)
    # class-conditional mel templates: the encoder is deterministic, so
    # template+noise inputs give clustered embeddings the head can learn
    templates = rng.normal(size=(N_CLASSES, CFG.frames, CFG.n_mels))

    # --- admission: a heterogeneous client population --------------------
    clients = []
    for i in range(N_CLIENTS):
        platform = "pi4" if i % 2 == 0 else "m2"
        cfg = EnvCfg(platform=platform, net=nets[i % len(nets)],
                     horizon=ROUNDS * FRAMES_PER_ROUND + 1, seed=i)
        env = EdgeCloudEnv(cfg)
        info = gw.open_session(platform=platform, qos=QoSClass.STANDARD)
        clients.append({
            "sid": info.sid,
            "env": env,
            "obs": env.reset(seed=i),
            "t": 0,
            "drops": 0,
            "last_k": env.L,   # cold start: conservative local placement
        })
    by_sid = {c["sid"]: c for c in clients}
    print(f"admitted {gw.stats().sessions_open}/{N_CLIENTS} clients "
          f"({N_CLIENTS // 2} pi4, {N_CLIENTS // 2} m2, "
          f"{len(nets)} network profiles)")

    # --- ingest + refine rounds ------------------------------------------
    results, round_losses = [], []
    for rnd in range(ROUNDS):
        for _ in range(FRAMES_PER_ROUND):
            for c in clients:
                # the in-flight block runs at the gateway's previous
                # decision (atomic transitions: a new k only applies to
                # the next block); a timeout means this frame never
                # reaches the server — a buffer gap, not an error
                c["obs"], _, _, info = c["env"].step(c["last_k"])
                c["t"] += 1
                if info["dropped"]:
                    c["drops"] += 1
                    continue
                lab = c["t"] % N_CLASSES
                mel = (templates[lab]
                       + 0.1 * rng.normal(size=templates[lab].shape))
                gw.submit(c["sid"], FrameRequest(
                    t=c["t"], mel=mel.astype(np.float32), label=lab,
                    u=float(c["obs"][0]), cpu=float(c["obs"][1]),
                    bandwidth_mbps=c["env"].bw))
            out = gw.tick()
            if on_tick is not None:
                on_tick(gw, out)
            results += out
            for r in out:
                by_sid[r.sid]["last_k"] = r.k
        s = gw.stats()
        round_losses.append(s.last_refine_loss)
        fills = [gw.session(c["sid"]).fill_fraction for c in clients]
        print(f"round {rnd}: refine loss={s.last_refine_loss:.4f} "
              f"({s.refine_rounds} rounds) | "
              f"{s.frames_per_dispatch:.1f} frames/dispatch | "
              f"routed={s.routed} | fill "
              f"min={min(fills):.2f} mean={np.mean(fills):.2f}")

    # --- eviction ---------------------------------------------------------
    total = sum(c["t"] for c in clients)
    drops = sum(c["drops"] for c in clients)
    infos = [gw.close_session(c["sid"]) for c in clients]
    s = gw.stats()
    assert s.sessions_open == 0
    transitions = float(np.mean([i.transitions for i in infos]))
    print(f"evicted all clients | {total} frames simulated, "
          f"{drops} dropped ({100 * drops / total:.1f}%) | "
          f"{s.frames} served in {s.dispatches} dispatches | "
          f"wire {s.wire_bytes / 1024:.0f} KB, "
          f"sync {s.sync_bytes / 1024:.0f} KB | "
          f"transitions/client mean={transitions:.1f}")
    return {"results": results, "stats": s, "round_losses": round_losses,
            "simulated": total, "dropped": drops,
            "transitions_mean": transitions}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description="the fleet demo")
    ap.add_argument("--device", default="cuda")
    main(device=ap.parse_args().device)
