"""The PPO actor-critic of the Uncertainty-Guided Adaptive Splitter
(paper §4.2.3), forward half.

Port of ``repro.core.ppo``: the paper's lightweight policy, a two-layer
MLP whose first layer is *shared* between the policy and value heads,
over the control-plane observation ``[U_t, R_cpu, B_net]``.  This module
holds what serving needs: the config, the initialiser, the forward pass
and the greedy action.  PPO training (``gae``, the clipped update,
``train_ppo``) and its simulator come with the edge-side slice.

The actor has no kernel in the reference (three small matrix products),
and the port runs it on the host CPU in float32 (``api.policies.
RLPolicy``), so the serving tick keeps its one device sync.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class PPOCfg:
    """The reference's PPO config, cut to what the forward half reads:
    the hidden width.  The training fields come with ``train_ppo``."""
    hidden: int = 64


def init_policy(generator: torch.Generator, obs_dim, n_actions,
                hidden=PPOCfg.hidden) -> dict:
    """Random actor-critic params from ``generator``, scaled as the
    reference's (``N(0, 1) / sqrt(fan_in)``, the policy head by a further
    0.01; biases zero) -> a dict of float32 tensors on the generator's
    device.  The draws differ from ``jax.random``'s; the parity tests
    convert the reference's params with ``weights.ppo_from_jax``."""
    dev = generator.device

    def s(shape):
        return (1.0 / np.sqrt(shape[0])) * torch.randn(
            *shape, generator=generator, device=dev)

    return {
        "w1": s((obs_dim, hidden)), "b1": torch.zeros(hidden, device=dev),
        "wp": 0.01 * s((hidden, n_actions)),
        "bp": torch.zeros(n_actions, device=dev),
        "wv": s((hidden, 1)), "bv": torch.zeros(1, device=dev),
    }


def policy_apply(params, obs):
    """obs (..., obs_dim) -> (logits (..., n_actions), value (...))."""
    h = torch.tanh(obs @ params["w1"] + params["b1"])   # shared first layer
    logits = h @ params["wp"] + params["bp"]
    value = (h @ params["wv"] + params["bv"])[..., 0]
    return logits, value


def greedy_action(params, obs) -> int:
    """The argmax action of one observation (first index on a tie, as
    ``jnp.argmax``)."""
    logits, _ = policy_apply(params, torch.as_tensor(
        np.asarray(obs, np.float32)).to(params["w1"].device))
    return int(torch.argmax(logits))
