"""Split policies behind ONE batched interface.

Port of ``repro.api.policies``:

    decide(obs_batch (B, 3)) -> k_batch (B,)

where each observation row is the control-plane state
``[U_t, R_cpu/100, B_net]`` and each output is the split index for that
frame's dispatch.  Every policy decides on the host: the PPO actor
(``"rl"``) runs its small MLP on the CPU in float32, as the rules run
numpy, so a tick's decision never waits for the device.
"""
from __future__ import annotations

from typing import Protocol, runtime_checkable

import numpy as np
import torch

from repro_torch.core.ppo import policy_apply

# bandwidth normalization of the control-plane observation, in Mbps (the
# reference's ``EdgeCloudEnv.BW_NORM``)
BW_NORM = 50.0


@runtime_checkable
class SplitPolicy(Protocol):
    """Anything with a batched ``decide``; ``L`` bounds the action space."""

    L: int

    def decide(self, obs_batch: np.ndarray) -> np.ndarray:
        """obs_batch (B, 3) -> int k_batch (B,) with 0 <= k <= L."""
        ...


class FixedKPolicy:
    """static / edge-only (k=L) / server-only (k=0) in one class."""

    def __init__(self, L: int, k: int):
        self.L = L
        self.k = int(np.clip(k, 0, L))

    def decide(self, obs_batch):
        return np.full(len(obs_batch), self.k, np.int64)


class RulePolicy:
    """The Table 1/4 heuristic, vectorized: offload (shallow k) iff
    bandwidth high AND cpu free, else run fully local."""

    def __init__(self, L, *, bw_threshold=0.12, cpu_threshold=0.6,
                 offload_k=2):
        self.L = L
        self.bw_threshold = bw_threshold
        self.cpu_threshold = cpu_threshold
        self.offload_k = offload_k

    def decide(self, obs_batch):
        obs = np.asarray(obs_batch, np.float32)
        offload = (obs[:, 2] > self.bw_threshold) & \
                  (obs[:, 1] < self.cpu_threshold)
        return np.where(offload, self.offload_k, self.L).astype(np.int64)


class RLPolicy:
    """Greedy PPO policy (``core/ppo.py``), batched over the tick in one
    forward.  ``params`` (tensors on any device, or numpy arrays) are
    copied once to float32 CPU tensors; ``decide`` runs the actor there
    and takes the argmax, first index on a tie as ``jnp.argmax``."""

    def __init__(self, L, params):
        self.L = L
        self.params = {k: torch.as_tensor(v).detach().to("cpu",
                                                          torch.float32)
                       for k, v in params.items()}

    def decide(self, obs_batch):
        obs = torch.from_numpy(np.asarray(obs_batch, np.float32))
        with torch.no_grad():
            logits, _ = policy_apply(self.params, obs)
        return torch.argmax(logits, dim=-1).numpy().astype(np.int64)


class EntropyThresholdPolicy:
    """The cascade server's routing as a split policy (paper §6.5.2:
    offload when U_t > 0.7 regardless of platform): easy frames stay
    fully local (k=L), hard ones run a shallow edge prefix
    (k=offload_k)."""

    def __init__(self, L, *, threshold=0.7, offload_k=2):
        self.L = L
        self.threshold = threshold
        self.offload_k = offload_k

    def decide(self, obs_batch):
        obs = np.asarray(obs_batch, np.float32)
        hard = obs[:, 0] > self.threshold
        return np.where(hard, self.offload_k, self.L).astype(np.int64)


def make_policy(kind, L, *, rl_params=None, static_k=3, threshold=0.7,
                offload_k=2, bw_threshold=0.12,
                cpu_threshold=0.6) -> SplitPolicy:
    """One constructor for every placement convention.

    kind ∈ {"rl", "rule", "static", "edge", "server", "entropy"}; "rl"
    takes the actor-critic's ``rl_params`` (``core.ppo.init_policy``'s
    dict, or the reference's through ``weights.ppo_from_jax``)."""
    if kind == "rl":
        if rl_params is None:
            raise ValueError("rl policy needs rl_params")
        return RLPolicy(L, rl_params)
    if kind == "rule":
        return RulePolicy(L, bw_threshold=bw_threshold,
                          cpu_threshold=cpu_threshold, offload_k=offload_k)
    if kind == "static":
        return FixedKPolicy(L, static_k)
    if kind == "edge":
        return FixedKPolicy(L, L)
    if kind == "server":
        return FixedKPolicy(L, 0)
    if kind == "entropy":
        return EntropyThresholdPolicy(L, threshold=threshold,
                                      offload_k=offload_k)
    raise ValueError(f"unknown policy kind: {kind!r}")
