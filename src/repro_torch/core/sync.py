"""Lazy Synchronization protocol (paper §4.3.3).

Copy of ``repro.core.sync``: it needs no JAX, and the port keeps its own
copy so that it never imports the reference package.

Downlink: GMM parameters (<35 KB) every T_sync=100 frames.  Encoder
weights are only pushed when the device reports a charging state or a
high-bandwidth link.  The tracker accounts bytes and energy so the
evaluation includes sync overhead (the paper's +0.4 mJ/frame).
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass
class SyncCfg:
    t_sync_frames: int = 100
    t_weights_min_frames: int = 2000      # throttle weight pushes
    gmm_bytes: int = 33 * 1024
    encoder_bytes: int = 11_000_000 * 2   # ~11M params fp16
    wifi_mbps_threshold: float = 25.0
    joules_per_byte_down: float = 1.0e-6  # downlink cheaper than uplink


@dataclass
class SyncEvent:
    kind: str      # "gmm" | "weights"
    frame: int
    bytes: int
    energy_j: float
    # wall-clock of the emitting tick, from the CALLER's clock (the
    # gateway threads its injectable ``clock=`` through ``on_frame``'s
    # ``now=`` so sync timelines are deterministic under a fake clock —
    # 0.0 when the caller tracks frames only)
    at_s: float = 0.0


class LazySync:
    def __init__(self, cfg: SyncCfg = SyncCfg()):
        self.cfg = cfg
        self.last_gmm = 0
        self.last_weights = -cfg.t_weights_min_frames
        self.total_bytes = 0
        self.total_energy_j = 0.0
        self.events: list[SyncEvent] = []

    def on_frame(self, frame, *, charging=False, bandwidth_mbps=0.0,
                 now=0.0):
        out = []
        if frame - self.last_gmm >= self.cfg.t_sync_frames:
            out.append(self._emit("gmm", frame, self.cfg.gmm_bytes, now))
            self.last_gmm = frame
        if ((charging or bandwidth_mbps >= self.cfg.wifi_mbps_threshold)
                and frame - self.last_weights >= self.cfg.t_weights_min_frames):
            out.append(self._emit("weights", frame, self.cfg.encoder_bytes,
                                  now))
            self.last_weights = frame
        return out

    def _emit(self, kind, frame, nbytes, now=0.0):
        e = SyncEvent(kind, frame, nbytes,
                      nbytes * self.cfg.joules_per_byte_down, at_s=now)
        self.total_bytes += nbytes
        self.total_energy_j += e.energy_j
        self.events.append(e)
        return e

    def energy_mj_per_frame(self, frames):
        return 1e3 * self.total_energy_j / max(frames, 1)
