"""Edge–cloud discrete-event simulator for the Control Plane MDP
(paper §4.2, Appendix B).

Port of ``repro.core.env``: float64 numpy over the encoder's cost model
(``block_flops``, ``boundary_bytes``), with the same operations in the
same order and the same draws from ``self.rng``, so a port env equals the
reference's bitwise step for step.  It runs on the host by nature: it
simulates the ARM client and its link, not the server's device.

This is the *calibrated* environment: platform/network constants are fitted
to the paper's own anchors (Table 2 energy, Fig. 6 bandwidth, Fig. 7
latency) so the *policies* — PPO, rule-based, static, edge-only,
server-only — are evaluated under the paper's cost model.  Only the
ARM/4G silicon is simulated.

State   s_t = [U_t (GMM entropy, normalized), R_cpu/100, B_net (norm)]
Action  a_t = split layer k ∈ {0..L} (k<L offloads INT8 activations)
Reward  r_t = α·A_task − β·Lat/T_max − η·E/E_budget          (Eq. 12)
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.models.audio_encoder import (AudioEncCfg, block_flops,
                                              boundary_bytes)


# ---------------------------------------------------------------------------
# Platforms (calibrated to Table 2 / §6.5)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Platform:
    name: str
    flops_per_sec: float          # effective sustained f32 FLOP/s
    joules_per_flop: float        # edge compute energy
    joules_per_byte_tx: float     # uplink radio energy
    frontend_ms: float            # STFT/mel frontend latency per sample
    frontend_mj: float            # frontend energy per sample
    overhead_ms: float            # GMM update + RL inference (<2 ms, §6.2.2)


# Calibration anchors (Table 2, per 1-s sample):
#   edge-only  = 67.4 mJ  = frontend 12.4 + 55 mJ of local train compute
#   server-only= 187.2 mJ = frontend 12.4 + 174.8 mJ for 32 KB raw PCM
#     -> joules_per_byte_tx = 174.8e-3 / 32e3 = 5.46 uJ/B (4G-class radio)
#   local training = 3x fwd FLOPs (fwd+bwd) on the 0.103 GFLOP encoder
#     -> joules_per_flop = 55e-3 / 0.31e9 = 1.77e-10 J/FLOP
TRAIN_FLOP_MULT = 3.0
PI4 = Platform("pi4", flops_per_sec=6.0e9, joules_per_flop=1.77e-10,
               joules_per_byte_tx=5.46e-6, frontend_ms=3.2,
               frontend_mj=12.4, overhead_ms=2.0)

# Apple M2 (GPU/MPS path, §5): ~16x Pi throughput, higher absolute draw
# per op class than its process node suggests (unified-memory system power).
M2 = Platform("m2", flops_per_sec=1.0e11, joules_per_flop=2.2e-10,
              joules_per_byte_tx=5.46e-6, frontend_ms=0.4,
              frontend_mj=4.0, overhead_ms=0.5)

SERVER_FLOPS = 2.0e12          # per-stream share of the RTX3090 server
SERVER_BASE_MS = 8.0           # queueing + kernel launch floor
RAW_PCM_BYTES = 32_000         # 1 s @ 16 kHz, 16-bit mono (k=0 payload)
EMBED_BYTES = 128              # int8 d=128 embedding (k=L lazy-sync uplink)

PLATFORMS = {"pi4": PI4, "m2": M2}


# ---------------------------------------------------------------------------
# Network profiles (6 profiles over 4G/5G traces, §5)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class NetProfile:
    name: str
    bw_mbps: tuple       # (lo, hi) random-walk band
    rtt_ms: tuple
    loss: float          # packet loss prob (adds retransmit latency)
    volatility: float    # random-walk step scale


NET_PROFILES = {
    "stable":    NetProfile("stable", (6.0, 10.0), (30, 50), 0.00, 0.05),
    "wifi":      NetProfile("wifi", (30.0, 50.0), (10, 25), 0.00, 0.05),
    "variable":  NetProfile("variable", (3.0, 25.0), (30, 120), 0.01, 0.25),
    "congested": NetProfile("congested", (1.0, 3.0), (120, 200), 0.03, 0.15),
    "dropout":   NetProfile("dropout", (0.5, 20.0), (40, 150), 0.05, 0.45),
    "5g":        NetProfile("5g", (20.0, 50.0), (15, 40), 0.005, 0.10),
}


@dataclass(frozen=True)
class EnvCfg:
    platform: str = "pi4"
    net: str = "stable"
    enc: AudioEncCfg = AudioEncCfg()
    t_max_ms: float = 150.0       # latency budget T_max (per sample)
    e_budget_mj: float = 100.0    # per-frame energy budget
    alpha: float = 10.0           # reward weights (paper §5)
    beta: float = 5.0
    eta: float = 3.0
    horizon: int = 200            # decision steps per episode
    frames_per_step: int = 10     # T_step (≈100 ms)
    quant_bytes: int = 1          # INT8 wire format
    quant_acc_penalty: float = 0.003   # <0.3 % (paper §5)
    kappa: float = 1.3            # local-processing utility loss ∝ U_t
    # manifold-alignment factor: with near-zero offloading the edge model
    # collapses (C1) — quality q ramps from q_min to 1 as the offloaded
    # fraction approaches o_ref (Theorem 3.2: the server can stitch gaps
    # only if *some* frames arrive).
    q_min: float = 0.05
    o_ref: float = 0.10
    seed: int = 0
    # uncertainty regime mix (EcoStream-Wild §6.1.1)
    p_background: float = 0.602
    p_speech: float = 0.245
    p_transient: float = 0.153
    # cpu background-load markov chain
    cpu_load_p: float = 0.08      # P(enter loaded)
    cpu_unload_p: float = 0.25    # P(leave loaded)


class EdgeCloudEnv:
    """Gym-style env.  obs = [U, cpu, bw_norm] ∈ [0,1]³; action k ∈ 0..L."""

    BW_NORM = 50.0  # Mbps normalization

    def __init__(self, cfg: EnvCfg = EnvCfg()):
        self.cfg = cfg
        self.plat = PLATFORMS[cfg.platform]
        self.net = NET_PROFILES[cfg.net]
        enc = cfg.enc
        self.L = enc.n_blocks
        self.flops = np.array(block_flops(enc), np.float64)
        # wire payloads: k=0 raw PCM; 0<k<L INT8 activations (+fp32 option);
        # k=L the lazy-synced int8 embedding only.
        b_int8 = np.array(boundary_bytes(enc, dtype_bytes=1), np.float64)
        self.wire_int8 = np.concatenate(
            [[RAW_PCM_BYTES], b_int8[1:-1], [EMBED_BYTES]])
        b_fp32 = np.array(boundary_bytes(enc, dtype_bytes=4), np.float64)
        self.wire_fp32 = np.concatenate(
            [[RAW_PCM_BYTES], b_fp32[1:-1], [4 * EMBED_BYTES]])
        self.rng = np.random.default_rng(cfg.seed)
        self.reset()

    # -- stochastic processes ------------------------------------------------
    def _bw_step(self):
        lo, hi = self.net.bw_mbps
        drift = self.rng.normal(0, self.net.volatility) * (hi - lo)
        self.bw = float(np.clip(self.bw + drift, lo * 0.5, hi * 1.2))

    def _cpu_step(self):
        if self.cpu_loaded:
            if self.rng.random() < self.cfg.cpu_unload_p:
                self.cpu_loaded = False
        elif self.rng.random() < self.cfg.cpu_load_p:
            self.cpu_loaded = True
        base = 28.0 if not self.cpu_loaded else 82.0
        self.cpu = float(np.clip(base + self.rng.normal(0, 6.0), 5.0, 100.0))

    def _uncertainty_step(self):
        """Regime-switching U_t matching the 60/25/15 class mix: background
        hum (low H), speech (mid), transient events (high)."""
        c = self.cfg
        r = self.rng.random()
        if r < c.p_transient:
            u = self.rng.uniform(0.75, 1.0)
        elif r < c.p_transient + c.p_speech:
            u = self.rng.uniform(0.4, 0.75)
        else:
            u = self.rng.uniform(0.02, 0.3)
        # temporal smoothing — sound sources don't teleport
        self.u = 0.6 * self.u + 0.4 * u

    def reset(self, seed=None):
        if seed is not None:
            self.rng = np.random.default_rng(seed)
        lo, hi = self.net.bw_mbps
        self.bw = float(self.rng.uniform(lo, hi))
        self.cpu_loaded = False
        self.cpu = 25.0
        self.u = 0.2
        self.offload_ema = 0.25   # warm start (cold-start local policy, §4.1.2)
        self.t = 0
        self.metrics = {k: 0.0 for k in
                        ("lat_ms", "tx_bytes", "energy_mj", "utility",
                         "drops", "frames", "edge_ms", "net_ms", "server_ms")}
        return self._obs()

    def _obs(self):
        return np.array([self.u, self.cpu / 100.0,
                         min(self.bw / self.BW_NORM, 1.0)], np.float32)

    # -- cost model ----------------------------------------------------------
    def step_costs(self, k, *, quantize=True):
        """Per-sample costs for split index k under the CURRENT state.

        Local segments are *trained* (fwd+bwd = TRAIN_FLOP_MULT x fwd)."""
        c, p = self.cfg, self.plat
        cpu_slow = 1.0 + 2.2 * max(self.cpu - 30.0, 0.0) / 70.0
        edge_flops = TRAIN_FLOP_MULT * float(self.flops[:k].sum())
        edge_ms = p.frontend_ms + p.overhead_ms + \
            1e3 * edge_flops / p.flops_per_sec * cpu_slow
        wire = float((self.wire_int8 if quantize else self.wire_fp32)[k])
        if k < self.L:
            rtt = self.rng.uniform(*self.net.rtt_ms)
            retrans = 1.0 / max(1.0 - self.net.loss * 8.0, 0.25)
            net_ms = (wire * 8.0 / (self.bw * 1e6)) * 1e3 * retrans + rtt / 2.0
            srv_ms = SERVER_BASE_MS + TRAIN_FLOP_MULT * \
                1e3 * float(self.flops[k:].sum()) / SERVER_FLOPS
        else:
            net_ms, srv_ms = 0.0, 0.0   # embedding sync is async (lazy)
        energy_mj = p.frontend_mj + 1e3 * (
            edge_flops * p.joules_per_flop + wire * p.joules_per_byte_tx)
        return edge_ms, net_ms, srv_ms, wire, energy_mj

    def utility(self, k, dropped, *, quantize=True):
        """Learning-signal utility ∈ [0,1] of this sample's placement."""
        if dropped:
            return 0.0
        if k >= self.L:
            # fully local: hard (high-U) frames hurt; and without *any*
            # offloading the manifold degrades (dimensional collapse, C1)
            q = self.cfg.q_min + (1 - self.cfg.q_min) * min(
                1.0, self.offload_ema / self.cfg.o_ref)
            return q * max(0.0, 1.0 - self.cfg.kappa * self.u)
        pen = self.cfg.quant_acc_penalty if (quantize and k > 0) else 0.0
        return 1.0 - pen

    def step(self, k, *, quantize=True):
        k = int(np.clip(k, 0, self.L))
        edge_ms, net_ms, srv_ms, wire, energy_mj = self.step_costs(
            k, quantize=quantize)
        lat = edge_ms + net_ms + srv_ms
        dropped = lat > self.cfg.t_max_ms
        util = self.utility(k, dropped, quantize=quantize)
        self.offload_ema = 0.98 * self.offload_ema + 0.02 * float(k < self.L)

        m = self.metrics
        m["lat_ms"] += lat
        m["edge_ms"] += edge_ms
        m["net_ms"] += net_ms
        m["server_ms"] += srv_ms
        m["tx_bytes"] += wire
        m["energy_mj"] += energy_mj
        m["utility"] += util
        m["drops"] += float(dropped)
        m["frames"] += 1

        r = (self.cfg.alpha * util
             - self.cfg.beta * min(lat / self.cfg.t_max_ms, 2.0)
             - self.cfg.eta * min(energy_mj / self.cfg.e_budget_mj, 2.0))

        self._bw_step()
        self._cpu_step()
        self._uncertainty_step()
        self.t += 1
        done = self.t >= self.cfg.horizon
        return self._obs(), float(r), done, {
            "lat_ms": lat, "energy_mj": energy_mj, "tx_bytes": wire,
            "dropped": dropped, "utility": util}

    # -- summary -------------------------------------------------------------
    def summary(self):
        m = self.metrics
        n = max(m["frames"], 1.0)
        return {
            "lat_ms": m["lat_ms"] / n,
            "edge_ms": m["edge_ms"] / n,
            "net_ms": m["net_ms"] / n,
            "server_ms": m["server_ms"] / n,
            "kb_per_batch": m["tx_bytes"] / n * 8.0 / 1024.0,  # batch = 8
            "energy_mj": m["energy_mj"] / n,
            "utility": m["utility"] / n,
            "drop_rate": m["drops"] / n,
        }


# accuracy anchors (Fig. 8, AudioSet): utility -> linear-probe accuracy
ACC_EDGE_ONLY = 58.6
ACC_SERVER = 73.6


def utility_to_accuracy(util):
    """Map mean learning-signal utility to the paper's accuracy scale."""
    return ACC_EDGE_ONLY + (ACC_SERVER - ACC_EDGE_ONLY) * util


def battery_hours(energy_mj_per_frame, *, wh=37.0, fps=37.4):
    """10,000 mAh pack (≈37 Wh); fps calibrated to Table 2 (see DESIGN)."""
    watts = energy_mj_per_frame * 1e-3 * fps
    return wh / max(watts, 1e-9)
