"""The control plane's policies and episodes: the cached PPO split
policies and the system-metric episode runner behind the paper's Fig 6/7
and Table 2/4/6/7 (``runtime/system_tables.py``).

Port of the policy half of ``benchmarks/common.py``.  A policy is trained
(``core/ppo.py::train_ppo``, its updates on ``device``) over the
reference's six network profiles in turn and cached as an ``.npz`` with
the reference's keys (``w1 … bv``) under ``build/repro_torch/artifacts/``,
so a file of either package loads in the other.
"""
from __future__ import annotations

import itertools
import os

import numpy as np

from repro_torch.core.controller import Controller, run_episode
from repro_torch.core.env import EdgeCloudEnv, EnvCfg
from repro_torch.core.ppo import PPO_KEYS, PPOCfg, host_params, train_ppo

ART = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir,
                   os.pardir, os.pardir, "build", "repro_torch", "artifacts")
PROFILES = ("stable", "variable", "congested", "wifi", "5g", "dropout")
ITERS = 40      # the reference's training length, the tables' policies


def policy_path(platform, iters=ITERS):
    """The cache file of ``platform``'s policy trained ``iters``
    iterations: the reference's name at its default count, another name
    at any other, so that a short run never stands in for the full one."""
    tag = "" if iters == ITERS else f"_{iters}it"
    return os.path.normpath(os.path.join(ART, f"ppo_{platform}{tag}.npz"))


def policy_factory(platform):
    """The training envs of ``platform``'s policy: each call takes the
    next of the six profiles (horizon 200, env seed the episode's index,
    counted from 0 for each factory)."""
    counter = itertools.count()

    def factory():
        i = next(counter)
        return EdgeCloudEnv(EnvCfg(platform=platform,
                                   net=PROFILES[i % len(PROFILES)],
                                   horizon=200, seed=i))

    return factory


def get_policy(platform="pi4", *, iters=ITERS, force=False, verbose=False,
               device="cuda", on_iter=None):
    """The PPO policy of ``platform`` (float32 CPU tensors): from the
    cache, or trained for ``iters`` iterations of 2,048 steps over
    ``policy_factory(platform)`` and cached at ``policy_path(platform,
    iters)``.  ``on_iter`` is a measurement hook handed to ``train_ppo``
    (``chip_smoke.py`` reads each iteration's times from it); it changes
    nothing that is trained."""
    path = policy_path(platform, iters)
    if os.path.exists(path) and not force:
        with np.load(path) as data:
            return host_params({k: data[k] for k in PPO_KEYS})
    n_actions = EdgeCloudEnv(EnvCfg(platform=platform)).L + 1
    params, _ = train_ppo(policy_factory(platform), n_actions,
                          PPOCfg(iters=iters, steps_per_iter=2048, seed=0),
                          verbose=verbose, device=device, on_iter=on_iter)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez(path, **{k: params[k].numpy() for k in PPO_KEYS})
    return params


def episode_summary(kind, *, platform="pi4", net="stable", horizon=600,
                    seed=7, rl_params=None, static_k=3, extra_kb=0.0,
                    env_overrides=None):
    """Run one policy through the calibrated env; returns summary dict.

    extra_kb models per-batch sync overhead of FSL/FedCL baselines."""
    env = EdgeCloudEnv(EnvCfg(platform=platform, net=net, horizon=horizon,
                              **(env_overrides or {})))
    ctrl = Controller(kind, env.L, rl_params=rl_params, static_k=static_k)
    s = run_episode(env, ctrl, seed=seed)
    if extra_kb:
        s["kb_per_batch"] += extra_kb
        # radio energy for the extra sync bytes
        s["energy_mj"] += extra_kb * 1024 / 8 * 5.46e-6 * 1e3
    return s


METHODS = ("Edge-Only", "Server-Only", "FSL", "FedCL", "Rule-Based",
           "StreamSplit")

# controller kind, per-batch sync overhead KB, env overrides
METHOD_MAP = {
    "Edge-Only": ("edge", 0.0, None),
    "Server-Only": ("server", 0.0, None),
    # fixed split + periodic split-weight sync
    "FSL": ("static", 130.0, None),
    # local training with *synchronized memory banks*: the bank restores
    # global negatives (no dimensional collapse -> q_min=1) but hard frames
    # still lack server refinement, and the bank sync costs bandwidth.
    "FedCL": ("edge", 200.0, {"q_min": 1.0, "o_ref": 1e-9}),
    "Rule-Based": ("rule", 0.0, None),
    "StreamSplit": ("rl", 0.0, None),
}


def method_summary(method, *, platform="pi4", net="stable", horizon=600,
                   seed=7):
    """The paper's six methods mapped onto controller kinds + overheads."""
    rl = get_policy(platform) if method == "StreamSplit" else None
    kind, extra, ovr = METHOD_MAP[method]
    return episode_summary(kind, platform=platform, net=net,
                           horizon=horizon, seed=seed, rl_params=rl,
                           extra_kb=extra, env_overrides=ovr)


def method_summary_mixed(method, *, platform="pi4", horizon=400, seed=7,
                         nets=("stable", "variable", "congested")):
    """Average over network profiles — the deployment-realistic accuracy
    comparison (differentiates static from adaptive policies)."""
    outs = [method_summary(method, platform=platform, net=n,
                           horizon=horizon, seed=seed + i)
            for i, n in enumerate(nets)]
    return {k: float(np.mean([o[k] for o in outs])) for k in outs[0]}
