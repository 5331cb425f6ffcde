"""Federate two gateways, drain one live, then KILL one mid-stream:
the rolling-restart + self-healing demo.

Two ``StreamServer`` members (one gateway each) behind a
``GatewayCluster`` with frame replication on: sessions place by
consistent hashing, three QoS tiers stream concurrently, and the run
hits both federation fault paths (docs/FEDERATION.md):

1. halfway through, one member is **drained for a rolling restart
   while its streams are mid-flight** — its sessions (books, token
   buckets, queued frames with their original deadlines) migrate live
   to the survivor, are served there without a gap, and the drained
   member later rejoins to take new placements;
2. then the OTHER member is **crashed without warning** — its sessions
   fail over automatically: last checkpoint + buddy journal replay
   through the same import seam, and the demo prints the
   ``lost_in_flight`` delta across the kill (zero: every accepted
   frame was journal-acked on the buddy before the crash).

The numbers to watch at the end: the cluster-wide conservation
identity ``submitted == served + depth + in_flight + shed_expired +
lost_in_flight`` (printed and asserted), the before/after lost delta,
and the migration pause percentiles — how long a stream actually
stands still while it changes gateways.

Port of ``examples/cluster_demo.py``: every member's gateway runs on
``device`` (the card by default; ``--device cpu`` for the plain PyTorch
path), and ``main`` returns the numbers it prints.  The canonical
single-server entry point is ``runtime/streaming_demo.py``.

    PYTHONPATH=src python -m repro_torch.runtime.cluster_demo [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.api import (FrameRequest, QoSClass, StreamSplitGateway,
                             make_policy)
from repro_torch.cluster import FailureInjector, GatewayCluster
from repro_torch.models.audio_encoder import AudioEncCfg, init_audio_encoder
from repro_torch.serving import SchedulerCfg, StreamServer

CFG = AudioEncCfg(widths=(16, 16, 32, 32), strides=(1, 2, 1, 2),
                  n_mels=32, frames=40, d_embed=32, groups=4)
TIERS = {QoSClass.INTERACTIVE: 2, QoSClass.STANDARD: 4, QoSClass.BULK: 6}
FRAMES_PER_CLIENT = 30
DRAIN_AT = FRAMES_PER_CLIENT // 2
THRESHOLD = 0.7            # paper §6.5.2: offload when U_t > 0.7


def member(params, n, device):
    """One federation member: a gateway big enough to absorb EVERY
    session (the survivor takes the whole fleet during the drain),
    constructed UNSTARTED — the cluster owns stepping."""
    gw = StreamSplitGateway(
        CFG, params,
        policy=make_policy("entropy", CFG.n_blocks, threshold=THRESHOLD,
                           offload_k=2),
        capacity=n, window=32, qos_reserve=0, device=device)
    return StreamServer(
        gw, cfg=SchedulerCfg(max_batch=16,
                             deadline_ms={QoSClass.INTERACTIVE: 250.0,
                                          QoSClass.STANDARD: 1000.0,
                                          QoSClass.BULK: 4000.0}),
        queue_maxlen=4 * n)


class KillSwitch(FailureInjector):
    """An injector the demo arms at runtime: the next time the cluster
    gives this member a turn, it dies — a crash, not a drain."""

    def __init__(self):
        super().__init__()
        self.armed = False

    def maybe_fail(self, step):
        if self.armed:
            self.armed = False
            raise RuntimeError(f"induced member crash at step {step}")


def main(device="cuda") -> dict:
    params = init_audio_encoder(CFG, torch.Generator().manual_seed(0))
    n = sum(TIERS.values())
    servers = {"alpha": member(params, n, device),
               "beta": member(params, n, device)}
    kills = {name: KillSwitch() for name in servers}
    cl = GatewayCluster(dict(servers), seed=0, snapshot_every=20,
                        replicate=True, injectors=dict(kills))

    sessions = [(cl.open_session(qos=qos), qos)
                for qos, count in TIERS.items() for _ in range(count)]
    placed = {name: sum(1 for info, _ in sessions
                        if cl.session_member(info.sid) == name)
              for name in servers}
    print(f"{n} sessions hash-placed across {placed}")

    rng = np.random.default_rng(0)
    drained = False
    for t in range(FRAMES_PER_CLIENT):
        for info, _ in sessions:
            u = rng.uniform(0.75, 1.0) if rng.random() < 0.25 \
                else rng.uniform(0.05, 0.5)
            mel = rng.normal(size=(CFG.frames, CFG.n_mels)).astype(
                np.float32)
            cl.submit(info.sid, FrameRequest(t=t, mel=mel, u=float(u),
                                             bandwidth_mbps=20.0))
        if t == DRAIN_AT:                  # rolling restart, LIVE: this
            victim = max(placed, key=placed.get)  # round's frames are
            moved = cl.drain(victim)              # still queued — they
            drained = True                        # travel with the move
            print(f"t={t}: drained {victim!r} mid-stream — {moved} "
                  "sessions migrated with their queued frames")
        cl.step()
        st = cl.stats()
        assert st.conserved                # at EVERY snapshot
    cl.pump()                              # drain the remaining backlog

    # the drained member comes back and is immediately placeable again
    rejoined = cl.add_member(victim, servers[victim])
    print(f"{victim!r} rejoined (rebalance moved {rejoined} sessions "
          "back)")

    # -- phase 2: kill the OTHER member cold, mid-stream ------------------
    # (the drain popped the first victim's injector; the survivor of
    # phase 1 still carries its arming switch)
    crash = next(name for name in servers if name != victim)
    lost_before = sum(cl.stats().lost_in_flight.values())
    crashed = False
    for t in range(FRAMES_PER_CLIENT, 2 * FRAMES_PER_CLIENT):
        for info, _ in sessions:
            u = rng.uniform(0.75, 1.0) if rng.random() < 0.25 \
                else rng.uniform(0.05, 0.5)
            mel = rng.normal(size=(CFG.frames, CFG.n_mels)).astype(
                np.float32)
            cl.submit(info.sid, FrameRequest(t=t, mel=mel, u=float(u),
                                             bandwidth_mbps=20.0))
        if t == FRAMES_PER_CLIENT + DRAIN_AT:
            kills[crash].armed = True      # no drain, no goodbye: the
            cl.step()                      # member dies on its turn and
            crashed = True                 # every session fails over
            st = cl.stats()
            lost_after = sum(st.lost_in_flight.values())
            failed_over = st.failovers
            print(f"t={t}: KILLED {crash!r} mid-stream — "
                  f"{st.failovers} sessions failed over "
                  f"(checkpoint + {st.replayed_frames} journal frames "
                  f"replayed); lost_in_flight {lost_before} -> "
                  f"{lost_after} (delta {lost_after - lost_before})")
        else:
            cl.step()
        assert cl.stats().conserved        # at EVERY snapshot
    cl.pump()

    for info, _ in sessions:
        cl.close_session(info.sid)
    st = cl.stats()
    assert st.conserved and drained and crashed
    assert st.failures == 1 and st.sessions_open == 0
    assert cl.lost_sessions == []          # every stream survived
    total = sum(st.served.values())
    print(f"\nserved {total} frames across the drain AND the crash "
          f"({st.migrations} migrations, {st.migrated_frames} queued "
          f"frames travelled, {st.migrated_bytes / 1024:.1f} KB; "
          f"{st.failovers} failovers, {st.journal_bytes / 1024:.1f} KB "
          "journal shipped)")
    for cls in ("interactive", "standard", "bulk"):
        print(f"  {cls:>11}: {st.served[cls]:4d} served | "
              f"{st.shed_expired[cls]} shed | "
              f"{st.lost_in_flight[cls]} lost")
    p = st.migration_pause_ms
    print(f"migration pause p50 {p['p50']:.2f} ms  p95 {p['p95']:.2f} ms "
          f"max {p['max']:.2f} ms")
    print("conserved: submitted == served + depth + in_flight "
          "+ shed + lost at every snapshot")
    # nothing dropped by the drain OR the crash: with a per-step
    # journal flush every accepted frame was buddy-acked before the
    # kill, so replay recovered the entire backlog
    assert total == n * 2 * FRAMES_PER_CLIENT
    assert sum(st.lost_in_flight.values()) == 0
    return {"served": total, "migrations": st.migrations,
            "migrated_frames": st.migrated_frames,
            "migrated_bytes": st.migrated_bytes, "failovers": failed_over,
            "replayed_frames": st.replayed_frames,
            "journal_bytes": st.journal_bytes,
            "lost_in_flight_delta": lost_after - lost_before,
            "migration_pause_ms": dict(p)}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description="the federation demo")
    ap.add_argument("--device", default="cuda")
    main(device=ap.parse_args().device)
