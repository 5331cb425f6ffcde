"""The paper's system tables: Fig 6 (bandwidth), Fig 7 (latency), Table 2
(energy/battery), Fig 8 (accuracy, system view), Table 4 (adaptation),
Table 6 (cross-platform), Table 7 (policy transfer).

Port of ``benchmarks/system_tables.py``.  Each ``bench_*`` returns its
rows ``(name, value, derived)`` under the reference's names and
``paper:`` strings; ``run_all`` returns them all.  The latencies,
energies and bandwidths are outputs of the calibrated Pi 4 / M2 cost
model (``core/env.py``) under each policy, not times of any device.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.controller import Controller
from repro_torch.core.env import (EdgeCloudEnv, EnvCfg, battery_hours,
                                  utility_to_accuracy)
from repro_torch.runtime import control_plane as cp
from repro_torch.runtime.control_plane import (METHODS, episode_summary,
                                               method_summary,
                                               method_summary_mixed)


def bench_bandwidth():
    """Fig 6: KB per processing batch (8 clips)."""
    paper = dict(zip(METHODS, (1.0, 256, 187.2, 201.4, 124.3, 58.7)))
    rows, base = [], None
    for m in METHODS:
        s = method_summary(m, net="stable")
        if m == "Server-Only":
            base = s["kb_per_batch"]
        rows.append((f"fig6_bandwidth_kb_per_batch[{m}]", s["kb_per_batch"],
                     f"paper:{paper[m]}"))
    s = method_summary("StreamSplit", net="stable")
    red = 100 * (1 - s["kb_per_batch"] / base)
    rows.append(("fig6_bandwidth_reduction_pct[StreamSplit]", red,
                 "paper:77.1"))
    return rows


def bench_latency():
    """Fig 7: end-to-end latency/batch, stable + congested."""
    rows = []
    for net, paper_ss, paper_srv in (("stable", 127, 464),
                                     ("congested", 287, 1847)):
        srv = method_summary("Server-Only", net=net)
        ss = method_summary("StreamSplit", net=net)
        rows.append((f"fig7_latency_ms_batch[Server-Only,{net}]",
                     srv["lat_ms"] * 8, f"paper:{paper_srv}"))
        rows.append((f"fig7_latency_ms_batch[StreamSplit,{net}]",
                     ss["lat_ms"] * 8, f"paper:{paper_ss}"))
        red = 100 * (1 - ss["lat_ms"] / srv["lat_ms"])
        rows.append((f"fig7_latency_reduction_pct[{net}]", red,
                     "paper:72.6" if net == "stable" else "paper:84.5"))
        rows.append((f"fig7_breakdown_ms[StreamSplit,{net}]",
                     ss["lat_ms"] * 8,
                     f"edge:{ss['edge_ms']*8:.0f};net:{ss['net_ms']*8:.0f};"
                     f"server:{ss['server_ms']*8:.0f}"))
    return rows


def bench_energy():
    """Table 2: energy/frame + battery life on Pi 4B (10,000 mAh)."""
    paper = {"Edge-Only": (67.4, 14.8), "Server-Only": (187.2, 5.3),
             "FSL": (147.0, 6.8), "FedCL": (164.7, 6.1),
             "Rule-Based": (141.3, 7.1), "StreamSplit": (89.3, 11.2)}
    rows = []
    for m in METHODS:
        s = method_summary(m, net="stable")
        rows.append((f"table2_energy_mj[{m}]", s["energy_mj"],
                     f"paper:{paper[m][0]}"))
        rows.append((f"table2_battery_h[{m}]", battery_hours(s["energy_mj"]),
                     f"paper:{paper[m][1]}"))
    return rows


def bench_accuracy():
    """Fig 8 (system view): utility->accuracy over mixed profiles."""
    paper = {"Edge-Only": 58.6, "Server-Only": 73.6, "FSL": 66.4,
             "FedCL": 68.7, "Rule-Based": 68.2, "StreamSplit": 71.8}
    rows = []
    for m in METHODS:
        s = method_summary_mixed(m)
        rows.append((f"fig8_accuracy_pct[{m}]",
                     utility_to_accuracy(s["utility"]), f"paper:{paper[m]}"))
    # the paper's 2.2% gap is under stable conditions (Fig 8); under the
    # mixed volatile profiles StreamSplit can BEAT Server-Only (drops)
    srv = utility_to_accuracy(
        method_summary("Server-Only", net="stable")["utility"])
    ss = utility_to_accuracy(
        method_summary("StreamSplit", net="stable")["utility"])
    rows.append(("fig8_gap_to_server_pct[stable]", srv - ss, "paper:<=2.2"))
    return rows


def _adaptation_time(kind, rl_params=None, *, seed=3):
    """Time (ms of stream) for latency to recover within 1.5x of its new
    steady state after a bandwidth collapse (stable -> congested)."""
    env = EdgeCloudEnv(EnvCfg(net="stable", horizon=10 ** 9))
    ctrl = Controller(kind, env.L, rl_params=rl_params)
    obs = env.reset(seed=seed)
    for _ in range(100):
        obs, _, _, _ = env.step(ctrl.decide(obs))
    # bandwidth collapse
    env.net = type(env.net)("shock", (1.0, 2.0), (150, 200), 0.03, 0.1)
    env.bw = 1.5
    # steady-state latency under shock for this policy (oracle run)
    lat = []
    t_rec = None
    for t in range(400):
        obs, _, _, info = env.step(ctrl.decide(obs))
        lat.append(info["lat_ms"])
        if t > 30 and t_rec is None:
            recent = np.mean(lat[-5:])
            if recent < 1.2 * np.median(lat[-10:]) and \
               recent <= 1.5 * min(np.mean(lat[i:i + 5])
                                   for i in range(len(lat) - 5)):
                t_rec = t
    if t_rec is None:
        t_rec = 400
    return t_rec * 100.0  # decision interval = 100 ms


def bench_adaptation():
    """Table 4: static / rule / RL — accuracy, latency, energy, adaptation."""
    rl = cp.get_policy("pi4")
    paper = {"static": (68.7, 203, 142.6, None),
             "rule": (69.4, 156, 118.7, 4200),
             "rl": (71.8, 127, 89.3, 1200)}
    rows = []
    for kind in ("static", "rule", "rl"):
        s = method_summary_mixed(
            {"static": "FSL", "rule": "Rule-Based",
             "rl": "StreamSplit"}[kind])
        p = paper[kind]
        rows.append((f"table4_accuracy_pct[{kind}]",
                     utility_to_accuracy(s["utility"]), f"paper:{p[0]}"))
        rows.append((f"table4_latency_ms[{kind}]", s["lat_ms"] * 8,
                     f"paper:{p[1]}"))
        rows.append((f"table4_energy_mj[{kind}]", s["energy_mj"],
                     f"paper:{p[2]}"))
        if kind != "static":
            t = _adaptation_time(kind, rl_params=rl)
            rows.append((f"table4_adaptation_ms[{kind}]", t, f"paper:{p[3]}"))
    return rows


def bench_cross_platform():
    """Table 6: Pi 4B vs Apple M2 with platform-native policies."""
    paper = {"pi4": (71.8, 127, 89.3, 58.7), "m2": (73.2, 67, 78.4, 42.3)}
    rows = []
    for plat in ("pi4", "m2"):
        rl = cp.get_policy(plat)
        s = episode_summary("rl", platform=plat, net="stable",
                            rl_params=rl)
        p = paper[plat]
        rows.append((f"table6_accuracy_pct[{plat}]",
                     utility_to_accuracy(s["utility"]), f"paper:{p[0]}"))
        rows.append((f"table6_latency_ms[{plat}]", s["lat_ms"] * 8,
                     f"paper:{p[1]}"))
        rows.append((f"table6_energy_mj[{plat}]", s["energy_mj"],
                     f"paper:{p[2]}"))
        rows.append((f"table6_bandwidth_kb[{plat}]", s["kb_per_batch"],
                     f"paper:{p[3]}"))
    return rows


def bench_policy_transfer():
    """Table 7: direct cross-platform policy transfer."""
    rows = []
    for src, dst, paper_acc in (("pi4", "pi4", 71.8), ("m2", "pi4", 69.4),
                                ("m2", "m2", 73.2), ("pi4", "m2", 72.0)):
        rl = cp.get_policy(src)
        s = episode_summary("rl", platform=dst, net="stable", rl_params=rl)
        tag = "native" if src == dst else "transfer"
        rows.append((f"table7_accuracy_pct[{src}->{dst},{tag}]",
                     utility_to_accuracy(s["utility"]), f"paper:{paper_acc}"))
    return rows


def run_all():
    """Every table's rows, in the reference's order."""
    return [r for bench in (bench_bandwidth, bench_latency, bench_energy,
                            bench_accuracy, bench_adaptation,
                            bench_cross_platform, bench_policy_transfer)
            for r in bench()]

