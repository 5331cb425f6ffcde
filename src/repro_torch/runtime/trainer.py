"""Training runtime: the LM train step (microbatch accumulation, optional
StreamSplit hybrid auxiliary loss) and a fault-tolerant loop (atomic
checkpoints, restore on failure, straggler monitoring).

Port of ``repro.runtime.trainer``.  On a CUDA device a step runs every
attention layer on the hand-written flash-attention kernels (the forward
kernel twice a layer under remat, the dq and dk/dv kernels once each) and
the hybrid term on the SWD (``swd_rank_fwd``) and temporal-Laplacian
(``laplacian_energy``) forward kernels and one backward kernel for both
(``hybrid_reg_bwd``), once each a microbatch.

Differences from the reference, each for a reason:

- Random draws.  The reference splits a ``jax.random`` key each step (and
  per microbatch) for the SW directions and prior, which a torch
  generator cannot replay.  ``train_step`` takes one key per microbatch,
  each a ``torch.Generator`` or a ``(dirs, prior)`` pair drawn elsewhere
  (as ``core.swd.draw`` takes it).  ``Trainer`` draws them from a
  generator on its own device seeded from ``(seed, step)``, so a step
  copies nothing to the card mid-step; the card's numbers are its own.
- In place.  The optimizers update the parameters and their state in
  place (``optim/``); ``train_step`` returns the same objects.
- ``init_train_state`` returns the state only: the reference's logical
  axes serve its sharding, which waits (ROADMAP §1 item 7).
- One readback.  ``Trainer`` reads a step's metrics with one
  device->host copy of them stacked, not one per metric.
- Failures.  ``Trainer.run`` restores from the last checkpoint after a
  node failure, which is what the ``failure_injector`` raises.  Any
  other error (a kernel that does not launch, say) propagates: the
  reference catches every ``RuntimeError``, which in the port would also
  retry past a kernel's failure.
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core.hybrid import regularisers
from repro_torch.core.swd import seeded_generator
from repro_torch.kernels.ops import resolve_device
from repro_torch.models import lm
from repro_torch.optim import get_optimizer
from repro_torch.optim.schedules import SCHEDULES
from repro_torch.optim.sgd import tree_leaves, value_and_grad
from repro_torch.runtime.fault import StragglerMonitor


@dataclass(frozen=True)
class TrainCfg:
    optimizer: str = "adamw"
    lr: float = 3e-4
    schedule: str = "cosine"
    warmup: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.0
    grad_clip: float = 1.0
    microbatches: int = 1
    # StreamSplit hybrid loss as a first-class training feature: pooled
    # hidden-state "frames" get the diversity (SWD) + affinity (Laplacian)
    # regularizers of Eq. 13.
    hybrid: bool = False
    hybrid_lam_sw: float = 0.1
    hybrid_lam_lap: float = 0.01
    hybrid_pool: int = 64
    seed: int = 0


class NodeFailure(RuntimeError):
    """A failure of the node a step ran on (here: what the injector
    raised); ``Trainer.run`` restores from the last checkpoint."""


def make_loss_fn(cfg, tcfg: TrainCfg):
    """-> ``loss_fn(params, batch, key) -> (loss, metrics)``; ``key`` feeds
    the hybrid term's SW draws (a generator or a ``(dirs, prior)`` pair;
    unused without the hybrid term).  The metrics are detached."""
    def loss_fn(params, batch, key):
        loss, metrics = lm.lm_loss(cfg, params, batch)
        hidden = metrics.pop("hidden")
        if tcfg.hybrid:
            B, S, d = hidden.shape
            P = tcfg.hybrid_pool
            T = S // P
            z = hidden[:, : T * P].reshape(B, T, P, d).mean(2)
            z = z / torch.linalg.vector_norm(z, dim=-1,
                                             keepdim=True).clamp_min(1e-6)
            sw, lap = regularisers(key, z.float())
            loss = loss + tcfg.hybrid_lam_sw * sw + tcfg.hybrid_lam_lap * lap
            metrics = {**metrics, "swd": sw, "lap": lap}
        return loss, {k: v.detach() for k, v in metrics.items()}
    return loss_fn


def _per_microbatch(keys, n):
    """A generator serves every microbatch in turn; else one key each."""
    if keys is None or isinstance(keys, torch.Generator):
        return [keys] * n
    keys = list(keys)
    if len(keys) != n:
        raise ValueError(f"{len(keys)} draws for {n} microbatches")
    return keys


def make_train_step(cfg, tcfg: TrainCfg):
    """-> ``train_step(params, opt_state, batch, step, keys) -> (params,
    opt_state, metrics)``: the forward, backward and optimizer update of
    one step.  ``batch`` holds tensors on the parameters' device; ``keys``
    is a ``torch.Generator`` or a list of one key per microbatch.  The
    metrics are 0-d tensors (``lr`` a float32 CPU tensor)."""
    _, opt_update = get_optimizer(tcfg.optimizer)
    loss_fn = make_loss_fn(cfg, tcfg)
    schedule = SCHEDULES[tcfg.schedule]

    def upd_kwargs():
        if tcfg.optimizer == "adamw":
            return dict(weight_decay=tcfg.weight_decay,
                        grad_clip=tcfg.grad_clip)
        if tcfg.optimizer == "sgd":
            return dict(momentum=0.9)
        return {}

    def train_step(params, opt_state, batch, step, keys=None):
        n = tcfg.microbatches
        keys = _per_microbatch(keys, n)
        if n > 1:
            grads, loss, ms = None, None, []
            for i in range(n):
                mb = {k: v.reshape((n, v.shape[0] // n) + v.shape[1:])[i]
                      for k, v in batch.items()}
                (l, m), g = value_and_grad(loss_fn, params, mb, keys[i])
                # the reference's sums start from zeros: 0 + x is x
                grads = g if grads is None else [
                    a.add_(b) for a, b in zip(grads, g)]
                loss = l if loss is None else loss + l
                ms.append(m)
            grads = [g / n for g in grads]
            loss = loss / n
            metrics = {k: torch.stack([m[k] for m in ms]).mean()
                       for k in ms[0]}
        else:
            (loss, metrics), grads = value_and_grad(loss_fn, params, batch,
                                                    keys[0])
        lr = schedule(step, peak=tcfg.lr, warmup=tcfg.warmup,
                      total=tcfg.total_steps)
        gnorm = torch.sqrt(sum(g.float().square().sum() for g in grads))
        params, opt_state = opt_update(params, grads, opt_state, lr=lr,
                                       **upd_kwargs())
        return params, opt_state, {**metrics, "loss": loss, "lr": lr,
                                   "grad_norm": gnorm}

    return train_step


def init_train_state(cfg, tcfg: TrainCfg, generator):
    """Parameters drawn from ``generator`` on its device, the optimizer's
    initial state, step 0 -> ``{"params", "opt", "step"}``."""
    params = lm.init_lm(cfg, generator)
    opt_init, _ = get_optimizer(tcfg.optimizer)
    return {"params": params, "opt": opt_init(params),
            "step": torch.zeros((), dtype=torch.int32,
                                device=tree_leaves(params)[0].device)}


def _to(batch, device):
    """A batch of tensors or numpy arrays (copied: they may be read-only)
    on ``device``."""
    return {k: (v if isinstance(v, torch.Tensor)
                else torch.from_numpy(np.array(v))).to(device)
            for k, v in batch.items()}


class Trainer:
    """Fault-tolerant loop: periodic atomic checkpoints, restore-on-failure,
    straggler detection (deadline = factor x trailing median step time).

    ``data_fn(step)`` gives a batch (tensors or numpy arrays).  The hybrid
    term's SW draws come from a generator on ``device`` seeded from
    ``(seed, step)``, drawn from by each microbatch in turn."""

    def __init__(self, cfg, tcfg: TrainCfg, data_fn, *, ckpt_dir=None,
                 ckpt_every=50, keep=3, async_ckpt=True,
                 straggler_factor=3.0, failure_injector=None, device="cuda"):
        self.device = resolve_device(device)
        self.cfg, self.tcfg = cfg, tcfg
        self.data_fn = data_fn
        self.state = self._fresh_state()
        self.train_step = make_train_step(cfg, tcfg)
        self.ckpt = (CheckpointManager(ckpt_dir, keep=keep,
                                       async_save=async_ckpt)
                     if ckpt_dir else None)
        self.ckpt_every = ckpt_every
        self.monitor = StragglerMonitor(factor=straggler_factor)
        self.failure_injector = failure_injector
        self.history = []
        self.restarts = 0
        if self.ckpt:
            restored, step = self.ckpt.restore_latest(self.state)
            if restored is not None:
                self.state = restored
                print(f"[trainer] restored checkpoint at step {step}")
        self._step = int(self.state["step"])

    def _fresh_state(self):
        return init_train_state(self.cfg, self.tcfg, torch.Generator(
            device=self.device).manual_seed(self.tcfg.seed))

    @property
    def step(self):
        return self._step

    def _one_step(self):
        step = self._step
        if self.failure_injector is not None:
            try:
                self.failure_injector.maybe_fail(step)
            except RuntimeError as e:
                raise NodeFailure(str(e)) from e
        batch = _to(self.data_fn(step), self.device)
        key = seeded_generator(self.tcfg.seed, step, self.device)
        t0 = time.perf_counter()
        params, opt, metrics = self.train_step(
            self.state["params"], self.state["opt"], batch, step, key)
        lr = float(metrics.pop("lr"))
        names = sorted(metrics)
        values = torch.stack([metrics[k].float() for k in names]).tolist()
        metrics = {**dict(zip(names, values)), "lr": lr}
        dt = time.perf_counter() - t0
        self.monitor.record(step, dt)
        self.state["params"], self.state["opt"] = params, opt
        self.state["step"].fill_(step + 1)
        self._step = step + 1
        self.history.append({"step": step, "time_s": dt, **metrics})
        if self.ckpt and (step + 1) % self.ckpt_every == 0:
            self.ckpt.save(step + 1, self.state, block=False)
        return metrics

    def run(self, n_steps, *, log_every=10, max_restarts=3):
        target = self.step + n_steps
        while self.step < target:
            try:
                m = self._one_step()
            except NodeFailure as e:
                # node failure path: restore latest committed checkpoint
                if self.restarts >= max_restarts or self.ckpt is None:
                    raise
                self.restarts += 1
                self.ckpt.wait()
                restored, step = self.ckpt.restore_latest(self.state)
                self.state = (self._fresh_state() if restored is None
                              else restored)
                self._step = int(self.state["step"])
                print(f"[trainer] FAILURE at step ~{self.step} ({e}); "
                      f"restored step {step}, restart #{self.restarts}")
                continue
            if log_every and self.step % log_every == 0:
                print(f"[trainer] step {self.step:5d} "
                      f"loss {m['loss']:.4f} lr {m['lr']:.2e}")
        if self.ckpt:
            self.ckpt.wait()
        return self.history
