"""The end-to-end loop: continuous StreamSplit training on a synthetic
ambient-audio stream, then serving the trained encoder through the
typed gateway API — the paper's full loop.

Port of ``examples/streamsplit_edge_train.py``.  Part 1 trains the
representation (edge learner + GMM virtual negatives + hybrid server
loss, ``runtime/edge_train.py``).  Part 2 serves the trained weights
through ``StreamSplitGateway``: the policy decides placement per frame,
frames ride k-bucketed dispatches, the split link is INT8-accounted and
lazy sync runs behind the same surface, while the calibrated edge-cloud
simulator prices each placement (latency/energy/drops).  Part 3 compares
against a server-only gateway.  The simulator's latencies, energies and
bandwidths are outputs of its Pi 4 cost model, not times of the device
the gateway runs on.

    PYTHONPATH=src python -m repro_torch.runtime.edge_loop [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.api import FrameRequest, StreamSplitGateway, make_policy
from repro_torch.core.env import EdgeCloudEnv, EnvCfg, utility_to_accuracy
from repro_torch.data.audio_stream import AudioStream, StreamCfg
from repro_torch.runtime.edge_train import (ENC, retrieval_metrics,
                                            train_representation)


def serve_stream(policy_kind, params, mels, ys, *, net="variable", seed=0,
                 device="cuda", rl_params=None, enc_cfg=ENC, on_tick=None):
    """Serve the stream through one gateway session, one frame a tick;
    returns the env summary (deployment costs) + gateway stats (measured
    pipeline) + the session's close info + the simulator's drops.

    ``rl_params`` is the ``"rl"`` policy's actor-critic and ``enc_cfg``
    the encoder's config (the example's by default).  ``on_tick(t,
    result, gateway)``, when given, is called after each tick with its one
    ``FrameResult``: a measurement hook (``chip_smoke.py`` counts each
    tick's launches through it) that changes nothing served."""
    env = EdgeCloudEnv(EnvCfg(enc=enc_cfg, net=net, horizon=len(mels)))
    gw = StreamSplitGateway(enc_cfg, params,
                            policy=make_policy(policy_kind, env.L,
                                               rl_params=rl_params),
                            capacity=2, window=100, qos_reserve=0,
                            device=device)
    sid = gw.open_session(platform="pi4").sid
    obs = env.reset(seed=seed)
    done, t, drops = False, 0, 0
    while not done:
        gw.submit(sid, FrameRequest(
            t=t, mel=mels[t], label=int(ys[t]), u=float(obs[0]),
            cpu=float(obs[1]), bandwidth_mbps=env.bw))
        (r,) = gw.tick()
        if on_tick is not None:
            on_tick(t, r, gw)
        # the decision prices the NEXT block in the simulator — the same
        # atomic-transition boundary the controller semantics define
        obs, _, done, info = env.step(r.k)
        drops += int(info["dropped"])
        t += 1
    info_s = gw.close_session(sid)
    return env.summary(), gw.stats(), info_s, drops


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--frames", type=int, default=300,
                    help="frames to serve through the gateway")
    ap.add_argument("--policy", default="rule",
                    choices=["rule", "static", "edge", "server", "entropy"])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    # 1. representation learning (the Edge Learner + Server Refiner loop)
    print(f"[1/3] training StreamSplit representation for {args.steps} "
          f"steps on the synthetic stream ...")
    res = train_representation("streamsplit", steps=args.steps, eval_n=240,
                               device=args.device)
    mAP, r1 = retrieval_metrics(res.eval_z, res.eval_y)
    print(f"      linear probe {100*res.probe_acc:.1f}%  "
          f"mAP@10 {mAP:.3f}  R@1 {100*r1:.1f}%  "
          f"(collapse |cos| {res.collapse:.2f})")

    # 2. serve the trained encoder through the gateway over a volatile link
    print(f"[2/3] serving {args.frames} frames through the gateway "
          f"({args.policy} policy, variable network)")
    stream = AudioStream(StreamCfg(seed=1))
    mels, ys, _ = stream.batch(args.frames)
    mels = np.asarray(mels[:, :ENC.frames], np.float32)
    s, st, info, drops = serve_stream(args.policy, res.params, mels, ys,
                                      device=args.device)
    print(f"      {s['lat_ms']*8:6.0f} ms/batch   "
          f"{s['kb_per_batch']:6.1f} KB/batch   "
          f"{s['energy_mj']:5.1f} mJ/frame   "
          f"drops {drops/max(st.frames, 1):.2%}  (simulated Pi 4 costs)")
    print(f"      gateway: {st.frames} frames, routed={st.routed}, "
          f"split-link {st.wire_bytes/1024:.0f} KB measured, "
          f"{info.transitions} atomic transitions, "
          f"lazy sync {st.sync_bytes/1024:.0f} KB downlink")

    # 3. headline vs the server-centric baseline, same API surface
    print("[3/3] system summary (vs server-only gateway)")
    s2, _, _, _ = serve_stream("server", res.params, mels, ys,
                               device=args.device)
    print(f"      {part3_line(s, s2)}")


def part3_line(s, s2):
    """Part 3's line: ``s`` (the policy's env summary) against ``s2``
    (server-only's)."""
    return (f"bandwidth {100*(1 - s['kb_per_batch']/s2['kb_per_batch']):.1f}"
            f"% lower   energy "
            f"{100*(1 - s['energy_mj']/s2['energy_mj']):.1f}% lower   "
            f"accuracy {utility_to_accuracy(s['utility']):.1f}% vs "
            f"{utility_to_accuracy(s2['utility']):.1f}%")


if __name__ == "__main__":
    main()
