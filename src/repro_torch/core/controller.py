"""Deployed Control Plane: maps observed state -> split index, with the
paper's *atomic transition* semantics (decisions apply only to the next
T_step block; in-flight frames are never redone or dropped).

Port of ``repro.core.controller``.  Policies:
  rl          PPO params from core/ppo.py (uncertainty-aware)
  rule        heuristic: offload iff BW > X AND CPU < Y  (Table 1/4)
  static      fixed k (Table 4's k=3)
  edge        k = L (Edge-Only baseline)
  server      k = 0 (Server-Only baseline)

The ``rl`` controller decides on a host float32 copy of its params, as
``api.policies.RLPolicy`` does: one decision is one observation, and on
the card each would cost a sync.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.ppo import greedy_action, host_params


@dataclass
class RulePolicy:
    """Offload (shallow k) iff bandwidth high AND cpu free; else local.

    Reactive: re-estimates bandwidth with an EMA over probes, which is why
    its adaptation time is ~3.5x the RL agent's (Table 4)."""
    L: int
    bw_threshold: float = 0.12     # of BW_NORM (≈6 Mbps)
    cpu_threshold: float = 0.6
    offload_k: int = 2
    ema: float = 0.0
    ema_rate: float = 0.08         # slow probe-based estimate

    def __call__(self, obs):
        u, cpu, bw = obs
        self.ema = (1 - self.ema_rate) * self.ema + self.ema_rate * bw
        if self.ema > self.bw_threshold and cpu < self.cpu_threshold:
            return self.offload_k
        return self.L


class Controller:
    def __init__(self, kind, L, *, rl_params=None, static_k=3, t_step=10):
        self.kind = kind
        self.L = L
        self.rl_params = rl_params
        self._host = None if rl_params is None else host_params(rl_params)
        self.static_k = static_k
        self.t_step = t_step
        self.rule = RulePolicy(L)
        self.current_k = static_k if kind == "static" else L
        self.frame = 0
        self.transitions = 0

    def decide(self, obs):
        """Called once per decision interval (T_step frames). Returns the k
        to apply to the NEXT block — the atomic boundary."""
        if self.kind == "rl":
            k = greedy_action(self._host, np.asarray(obs, np.float32))
        elif self.kind == "rule":
            k = self.rule(obs)
        elif self.kind == "static":
            k = self.static_k
        elif self.kind == "edge":
            k = self.L
        elif self.kind == "server":
            k = 0
        else:
            raise ValueError(self.kind)
        if k != self.current_k:
            self.transitions += 1
        self.current_k = int(k)
        return self.current_k


def run_episode(env, controller: Controller, *, quantize=True, seed=None):
    """Roll a policy through an env episode; returns env.summary()."""
    obs = env.reset(seed=seed)
    done = False
    while not done:
        k = controller.decide(obs)
        obs, _, done, _ = env.step(k, quantize=quantize)
    return env.summary()
