"""PPO for the Uncertainty-Guided Adaptive Splitter (paper §4.2.3).

Port of ``repro.core.ppo``: PPO with the clipped objective and GAE, over
the paper's lightweight policy, a two-layer MLP whose first layer is
*shared* between the policy and value heads, on the control-plane
observation ``[U_t, R_cpu, B_net]``.  Trained offline on simulator traces
(``core/env.py``) across platforms and network profiles, deployed
label-free (state only).

The actor has no kernel in the reference (three small matrix products),
and plain torch ops serve it.  Serving runs it on the host CPU in float32
(``api.policies.RLPolicy``), so the serving tick keeps its one device
sync; ``train_ppo`` says where each part of training runs.
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.kernels.ops import resolve_device

PPO_KEYS = ("w1", "b1", "wp", "bp", "wv", "bv")
# the smallest normal float32: the floor of ``jax.random.gumbel``'s
# uniform draw, so that log(u) stays finite
_TINY = float(np.finfo(np.float32).tiny)


@dataclass(frozen=True)
class PPOCfg:
    hidden: int = 64
    lr: float = 3e-4
    gamma: float = 0.99
    lam: float = 0.95
    clip: float = 0.2
    epochs: int = 4
    minibatch: int = 256
    steps_per_iter: int = 2048
    iters: int = 40
    ent_coef: float = 0.01
    vf_coef: float = 0.5
    seed: int = 0


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


def host_params(params) -> dict:
    """``params`` (tensors on any device, or numpy arrays) as new float32
    CPU tensors, the copy the host-side actor reads."""
    return {k: torch.as_tensor(params[k]).detach().to("cpu", torch.float32)
            .clone() for k in PPO_KEYS}


def gumbel_noise(generator: torch.Generator, shape) -> torch.Tensor:
    """Gumbel draws of ``shape`` (a step's is ``(n_actions,)``) as
    ``jax.random.gumbel`` forms them: ``-log(-log(u))`` with u uniform in
    [tiny, 1)."""
    u = torch.rand(shape, generator=generator).clamp_min_(_TINY)
    return -torch.log(-torch.log(u))


def act(params, obs, gumbel):
    """The rollout's actor on one observation -> (action, log-prob,
    value).  ``jax.random.categorical(key, logits)`` is ``argmax(gumbel
    (key, logits.shape) + logits)``, so the action is the argmax of the
    step's Gumbel draw plus the logits (first index on a tie)."""
    with torch.inference_mode():
        logits, value = policy_apply(params, torch.from_numpy(obs))
        a = int(torch.argmax(torch.as_tensor(gumbel) + logits))
        logp = torch.log_softmax(logits, -1)[a]
    return a, float(logp), float(value)


def gae(rewards, values, dones, last_value, gamma, lam):
    T = len(rewards)
    adv = np.zeros(T, np.float32)
    last = 0.0
    next_v = last_value
    for t in reversed(range(T)):
        nonterm = 1.0 - dones[t]
        delta = rewards[t] + gamma * next_v * nonterm - values[t]
        last = delta + gamma * lam * nonterm * last
        adv[t] = last
        next_v = values[t]
    return adv, adv + values


def ppo_loss(params, batch, *, clip, ent_coef, vf_coef):
    """The clipped objective + value loss - entropy bonus of a minibatch
    ``{"obs", "act", "logp", "adv", "ret"}`` -> (loss, (pg, vf, ent)).
    The advantage is normalised by its population std (``jnp.std`` is
    ddof 0; ``torch.std``'s default is not)."""
    logits, value = policy_apply(params, batch["obs"])
    logp_all = torch.log_softmax(logits, -1)
    logp = torch.gather(logp_all, 1, batch["act"][:, None])[:, 0]
    ratio = torch.exp(logp - batch["logp"])
    adv = batch["adv"]
    adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
    pg = -torch.mean(torch.minimum(
        ratio * adv, torch.clamp(ratio, 1 - clip, 1 + clip) * adv))
    vf = torch.mean(torch.square(value - batch["ret"]))
    ent = -torch.mean(torch.sum(torch.exp(logp_all) * logp_all, -1))
    return pg + vf_coef * vf - ent_coef * ent, (pg, vf, ent)


def adam_init(params) -> tuple:
    """Zero moments beside ``params`` and an int32 step count on their
    device: the reference's ``(m, v, step)``."""
    def zeros():
        return {k: torch.zeros_like(v) for k, v in params.items()}
    return zeros(), zeros(), torch.zeros((), dtype=torch.int32,
                                         device=params["w1"].device)


def ppo_update(params, opt_state, batch, *, clip, ent_coef, vf_coef, lr):
    """One minibatch step: the loss's gradient by autograd, then the
    reference's inline Adam in float32 (``1 - 0.9 ** step`` formed from
    the device's step count, as XLA forms it) -> (params, opt_state,
    loss).  Nothing here reads a value back to the host."""
    leaves = {k: p.detach().requires_grad_() for k, p in params.items()}
    with torch.enable_grad():
        loss, _ = ppo_loss(leaves, batch, clip=clip, ent_coef=ent_coef,
                           vf_coef=vf_coef)
        grads = dict(zip(leaves, torch.autograd.grad(
            loss, list(leaves.values()))))
    with torch.no_grad():
        m, v, step = opt_state
        step = step + 1
        m = {k: 0.9 * m[k] + 0.1 * g for k, g in grads.items()}
        v = {k: 0.999 * v[k] + 0.001 * g * g for k, g in grads.items()}
        s = step.to(torch.float32)
        c1 = 1 - torch.pow(0.9, s)
        c2 = 1 - torch.pow(0.999, s)
        params = {k: p - lr * (m[k] / c1) / (torch.sqrt(v[k] / c2) + 1e-8)
                  for k, p in leaves.items()}
    return params, (m, v, step), loss.detach()


def ppo_epochs(params, opt_state, dbuf, cfg: PPOCfg, obs_dim):
    """Every update of one iteration on the device of ``dbuf``, the
    iteration's buffer as one float32 matrix: columns ``obs``, ``act``,
    ``logp``, ``adv``, ``ret``, then one permutation of the rows per
    epoch (the reference's shuffles).  Each minibatch is a row gather on
    the device -> (params, opt_state)."""
    T = dbuf.shape[0]
    o = obs_dim
    perms = dbuf[:, o + 4:].to(torch.int64).t().contiguous()
    for e in range(cfg.epochs):
        for s in range(0, T, cfg.minibatch):
            rows = dbuf.index_select(0, perms[e, s:s + cfg.minibatch])
            batch = {"obs": rows[:, :o], "act": rows[:, o].to(torch.int64),
                     "logp": rows[:, o + 1], "adv": rows[:, o + 2],
                     "ret": rows[:, o + 3]}
            params, opt_state, _ = ppo_update(
                params, opt_state, batch, clip=cfg.clip,
                ent_coef=cfg.ent_coef, vf_coef=cfg.vf_coef, lr=cfg.lr)
    return params, opt_state


def _flat(params):
    return torch.cat([params[k].reshape(-1) for k in PPO_KEYS])


def _unflat(flat, like):
    out, i = {}, 0
    for k in PPO_KEYS:
        n = like[k].numel()
        out[k] = flat[i:i + n].view(like[k].shape)
        i += n
    return out


def train_ppo(env_factory, n_actions, cfg: PPOCfg = PPOCfg(), *,
              obs_dim=3, verbose=False, device="cuda", params=None,
              noise=None, on_iter=None):
    """env_factory() -> fresh env (cycled across profiles by the caller).
    -> (params as float32 CPU tensors, mean episode reward per
    iteration).

    Where the work runs:
      - the rollout's actor runs on a host float32 copy of the params.
        An iteration takes ``steps_per_iter`` single observations from a
        numpy env on the host, so on the card each would cost a launch
        and a sync (``RLPolicy`` acts on the host for the same reason).
        The copy is refreshed once an iteration, after the updates: the
        reference's params change only there, so the rollout is the same;
      - the updates run on ``device`` (the card unless the caller asks
        for the CPU): the iteration's buffer and its epochs' shuffles go
        to the device in one copy, each minibatch is a row gather there,
        and nothing inside the update loop reads back to the host; the
        params come back in one device-to-host copy at the iteration's
        end.

    The draws are injectable.  ``noise(t)`` returns step t's Gumbel draw
    ``(n_actions,)`` (t counts the steps of the whole run), as the
    reference's ``jax.random.categorical`` draws it from each step's key;
    ``params`` is the initial actor-critic.  By default both come from
    one CPU generator seeded from ``cfg.seed``: ``init_policy`` first,
    then the draws, an iteration's at a time.  The numpy ``rng`` seeded
    from ``cfg.seed`` drives the episodes' reset seeds and the minibatch
    shuffles, consumed in the reference's order.

    ``on_iter(it, info)``, a measurement hook that changes nothing
    trained, is called after each iteration with its rollout (``obs``,
    ``act``, ``logp``, ``values``, ``rewards``, ``dones``, ``adv``,
    ``ret``), ``mean_reward``, ``rollout_ms`` (host clock) and
    ``update_ms`` (the updates from the buffer's copy to the
    last one: CUDA events on the card, read after the params' copy back,
    else the host clock)."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(cfg.seed)
    if params is None:
        params = init_policy(gen, obs_dim, n_actions, cfg.hidden)
    T = cfg.steps_per_iter
    if noise is None:
        block = {}

        def noise(t):
            it, i = divmod(t, T)
            if block.get("it") != it:
                block.update(it=it, draws=gumbel_noise(gen, (T, n_actions)))
            return block["draws"][i]
    host = host_params(params)
    cuda = dev.type == "cuda"
    with record_function("train_ppo.setup"):
        dparams = _unflat(_flat(host).to(dev), host)
        opt_state = adam_init(dparams)
    staging = torch.empty((T, obs_dim + 4 + cfg.epochs), dtype=torch.float32,
                          pin_memory=cuda)
    stage = staging.numpy()
    env = env_factory()
    obs = env.reset()
    history = []
    rng = np.random.default_rng(cfg.seed)
    step = 0

    for it in range(cfg.iters):
        t0 = time.perf_counter()
        with record_function("train_ppo.rollout"):
            buf = {k: np.zeros((T,) + s, np.float32) for k, s in
                   [("obs", (obs_dim,)), ("logp", ()), ("adv", ()),
                    ("ret", ())]}
            buf["act"] = np.zeros((T,), np.int32)
            rewards = np.zeros(T, np.float32)
            values = np.zeros(T, np.float32)
            dones = np.zeros(T, np.float32)
            ep_rews = []
            ep_acc = 0.0
            for t in range(T):
                a, logp, v = act(host, obs, noise(step))
                step += 1
                buf["obs"][t] = obs
                buf["act"][t] = a
                buf["logp"][t] = logp
                values[t] = v
                obs, r, done, info = env.step(a)
                rewards[t] = r
                ep_acc += r
                dones[t] = float(done)
                if done:
                    ep_rews.append(ep_acc)
                    ep_acc = 0.0
                    env = env_factory()
                    obs = env.reset(seed=int(rng.integers(1 << 31)))
            with torch.inference_mode():
                _, last_v = policy_apply(host, torch.from_numpy(obs))
            adv, ret = gae(rewards, values, dones, float(last_v),
                           cfg.gamma, cfg.lam)
            buf["adv"], buf["ret"] = adv, ret
            idx = np.arange(T)
            o = obs_dim
            stage[:, :o] = buf["obs"]
            stage[:, o] = buf["act"]
            stage[:, o + 1] = buf["logp"]
            stage[:, o + 2] = adv
            stage[:, o + 3] = ret
            for e in range(cfg.epochs):
                rng.shuffle(idx)
                stage[:, o + 4 + e] = idx
        rollout_ms = (time.perf_counter() - t0) * 1e3

        t1 = time.perf_counter()
        if cuda:
            ev0, ev1 = (torch.cuda.Event(enable_timing=True)
                        for _ in range(2))
            ev0.record()
        with record_function("train_ppo.update"):
            dbuf = staging.to(dev, non_blocking=True)
            dparams, opt_state = ppo_epochs(dparams, opt_state, dbuf, cfg,
                                            obs_dim)
        if cuda:
            ev1.record()
        with record_function("train_ppo.params_to_host"):
            host = _unflat(_flat(dparams).cpu(), host)
        update_ms = (ev0.elapsed_time(ev1) if cuda
                     else (time.perf_counter() - t1) * 1e3)
        mean_rew = float(np.mean(ep_rews)) if ep_rews else float(rewards.sum())
        history.append(mean_rew)
        if verbose:
            print(f"[ppo] iter {it:3d}  mean episode reward {mean_rew:9.2f}")
        if on_iter is not None:
            on_iter(it, {**buf, "values": values, "rewards": rewards,
                         "dones": dones, "mean_reward": mean_rew,
                         "rollout_ms": rollout_ms, "update_ms": update_ms})
    return host, history
