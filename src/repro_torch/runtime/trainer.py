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
- ``init_train_state`` returns the state only; ``lm.param_axes(cfg)``
  gives the reference's logical axes.
- On a mesh.  Under rules with a mesh (``distributed.sharding
  .axis_rules(rules_for(mesh, cfg, batch=B, kind="train"))``), ``Trainer``
  keeps every parameter and optimizer leaf as a ``Placed`` (a block a
  shard: ``lm.param_shardings``, replicated blocks copied to each of
  their shards) and steps with ``make_sharded_train_step``: each shard
  its rows of the batch (``lm.lm_loss_sharded``), the hybrid term once a
  step on the pooled frames gathered over the data axes (as the
  reference's sees the whole batch under GSPMD), each block's gradient
  psum'd over its replicas (the data axes, and 'model' for blocks whole
  over it) in fixed shard order, so every replica of a block holds the
  same bits after the step; the global norm (clipping, ``grad_norm``) is
  taken once over the blocks, and the optimizer runs on the blocks
  (Adafactor's factored means psum'd, ``adafactor_update_placed``).
  Every family trains so, the ``ssm`` and ``hybrid`` ones with their SSM
  heads over 'model'.  Under FSDP rules (``rules_for(..., fsdp=True)``)
  the blocks are split over 'data' too: each layer gathers its blocks
  whole where it runs, the gradient comes back reduce-scattered to each
  block, and the optimizer steps the blocks as they lie.
  Checkpoints hold full arrays (``checkpoint/manager.py`` gathers and
  re-lays ``Placed`` leaves), so they are mesh-agnostic;
  ``Trainer.load_state`` takes a state laid out on another mesh or by
  other rules (``checkpoint.elastic.reshard_state``'s) into the trainer's
  own layout.
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
from repro_torch.distributed import job as _job
from repro_torch.distributed import sharding as shd
from repro_torch.core.swd import seeded_generator
from repro_torch.kernels.ops import resolve_device
from repro_torch.models import lm
from repro_torch.optim import get_optimizer
from repro_torch.optim.adafactor import (adafactor_update_placed,
                                         placed_stats_sharding)
from repro_torch.optim.schedules import SCHEDULES
from repro_torch.optim.sgd import tree_leaves, tree_unflatten, value_and_grad
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


def _pooled(hidden, P):
    """The hybrid term's frames: means of P consecutive hidden states,
    l2-normalised -> (B, S // P, d)."""
    B, S, d = hidden.shape
    T = S // P
    z = hidden[:, : T * P].reshape(B, T, P, d).mean(2)
    return z / torch.linalg.vector_norm(z, dim=-1,
                                        keepdim=True).clamp_min(1e-6)


def make_loss_fn(cfg, tcfg: TrainCfg):
    """-> ``loss_fn(params, batch, key) -> (loss, metrics)``; ``key`` feeds
    the hybrid term's SW draws (a generator or a ``(dirs, prior)`` pair;
    unused without the hybrid term).  The metrics are detached."""
    def loss_fn(params, batch, key):
        loss, metrics = lm.lm_loss(cfg, params, batch)
        hidden = metrics.pop("hidden")
        if tcfg.hybrid:
            z = _pooled(hidden, tcfg.hybrid_pool)
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


# ---------------------------------------------------------------------------
# On a mesh
# ---------------------------------------------------------------------------

def make_sharded_loss_fn(cfg, tcfg: TrainCfg, lay):
    """-> ``loss_fn(ps, batch, key) -> (loss, metrics)`` on a mesh: ``ps``
    one tree of param blocks a shard, ``batch`` each key's rows a shard;
    the loss (a 0-d tensor on the first shard's device) counts the CE and
    MoE terms once, and the hybrid term once, on the pooled frames of
    every shard gathered over the data axes."""
    def loss_fn(ps, batch, key):
        losses, m = lm.lm_loss_sharded(lay, cfg, ps, batch)
        loss = losses[0]
        metrics = {"ce": m["ce"][0], "moe_aux": m["moe_aux"][0]}
        if tcfg.hybrid:
            z = lay.gather_batch([_pooled(h, tcfg.hybrid_pool)
                                  for h in m["hidden"]])
            sw, lap = regularisers(key, z.float())
            loss = loss + tcfg.hybrid_lam_sw * sw + tcfg.hybrid_lam_lap * lap
            metrics.update(swd=sw, lap=lap)
        return loss, {k: v.detach() for k, v in metrics.items()}
    return loss_fn


def sharded_value_and_grad(fn, params, n, *args):
    """``fn(ps, *args) -> (loss, aux)`` over this process's blocks of a
    tree of ``Placed`` leaves (``n`` of them a leaf) -> ((loss detached,
    aux), grads: one list of n per-shard blocks a leaf, in
    ``tree_leaves`` order; a block the loss does not reach gets zeros).

    Across processes every process holds a copy of the loss (its first
    local shard's).  One process differentiates global shard 0's copy
    only, so the process owning shard 0 seeds its copy with 1 and every
    other one seeds 0: each still runs the whole backward, and every
    collective's backward exchange, in the same order."""
    placed = tree_leaves(params)
    leaves = [[b.detach().requires_grad_() for b in t.local_blocks]
              for t in placed]
    if any(len(bs) != n for bs in leaves):
        raise ValueError(f"{n} shards for a process holding "
                         f"{len(leaves[0])} blocks a leaf")
    flat = [b for bs in leaves for b in bs]
    ps = [tree_unflatten(params, [bs[s] for bs in leaves]) for s in range(n)]
    with torch.enable_grad():
        loss, aux = fn(ps, *args)
        seed = (torch.ones_like if placed[0].blocks[0] is not None
                else torch.zeros_like)(loss)
        gs = torch.autograd.grad(loss, flat, grad_outputs=seed,
                                 allow_unused=True)
    gs = [torch.zeros_like(b) if g is None else g for b, g in zip(flat, gs)]
    return (loss.detach(), aux), [gs[i * n:(i + 1) * n]
                                  for i in range(len(placed))]


def reduce_replicas(params, grads):
    """Each block's gradient psum'd over its replicas (the mesh axes its
    leaf's spec does not split), in fixed shard order: every replica gets
    the same bits."""
    out = []
    for t, gs in zip(tree_leaves(params), grads):
        mesh = t.sharding.mesh
        rep = tuple(a for a in mesh.axis_names
                    if a not in shd.spec_axes(t.sharding.spec))
        out.append(list(shd.psum_over(gs, mesh, rep)) if rep else gs)
    return out


def global_norm(params, grads):
    """The gradient's global norm over the blocks, each block counted once
    (its first replica), summed in fixed order on the first local
    shard's device.  Across processes each process squares and sums the
    first replicas it holds, the sums are exchanged (one ``exchange``),
    and every process folds them in the one-process order."""
    placed = tree_leaves(params)
    mesh = placed[0].sharding.mesh
    firsts = []
    for t in placed:
        seen, first = set(), []
        for i, sl in enumerate(t.sharding.slices(t.shape)):
            key = tuple((x.start, x.stop) for x in sl)
            if key not in seen:
                seen.add(key)
                first.append(i)
        firsts.append(first)
    dev = grads[0][0].device
    local = mesh.local()
    zero = torch.zeros((), device=dev)
    sums = [[gs[j].float().square().sum().to(dev) if i in first else zero
             for gs, first in zip(grads, firsts)]
            for j, i in enumerate(local)]
    if len(local) < len(placed[0].blocks):
        every = _job.exchange([torch.stack(x) for x in sums],
                              list(mesh.process_ids.flat), "global norm")
    else:
        every = sums
    total = torch.zeros((), device=dev)
    for li, first in enumerate(firsts):
        for i in first:
            total = total + every[i][li]
    return torch.sqrt(total)


def opt_shardings(optimizer, shardings, params):
    """Where the optimizer state's leaves live: laid out like the params
    (Adafactor's statistics by ``placed_stats_sharding``), its step whole
    on every shard."""
    mesh = tree_leaves(shardings)[0].mesh
    rep = shd.NamedSharding(mesh, shd.P())
    if optimizer == "adamw":
        return {"m": shardings, "v": shardings, "step": rep}
    if optimizer == "sgd":
        return (shardings,)
    if optimizer == "adafactor":
        def stats(sh, p):
            if isinstance(sh, dict):
                return {k: stats(sh[k], p[k]) for k in sh}
            return placed_stats_sharding(sh, p.shape)
        return {"stats": stats(shardings, params), "step": rep}
    raise ValueError(optimizer)


def _assemble(locals_, shardings, meta):
    """This process's shards' trees of blocks (``locals_``), a tree of
    shardings and a tree of global-shaped (meta) tensors -> a tree of
    ``Placed``."""
    if isinstance(shardings, shd.NamedSharding):
        return shd.Placed.from_local(locals_, shardings, meta.shape)
    if isinstance(shardings, dict):
        return {k: _assemble([t[k] for t in locals_], shardings[k], meta[k])
                for k in shardings}
    return type(shardings)(
        _assemble([t[i] for t in locals_], sh, m)
        for i, (sh, m) in enumerate(zip(shardings, meta)))


def _place_state(state, shardings):
    if isinstance(shardings, shd.NamedSharding):
        return shd.Placed.put(state, shardings)
    if isinstance(shardings, dict):
        return {k: _place_state(state[k], shardings[k]) for k in shardings}
    return type(shardings)(_place_state(s, sh)
                           for s, sh in zip(state, shardings))


def place_train_state(state, cfg, optimizer, lay):
    """A whole train state (``init_train_state``'s, or one converted or
    restored) laid out on ``lay``'s mesh, as ``init_sharded_train_state``
    lays out its own."""
    shardings = lm.param_shardings(cfg, lay)
    return {"params": shd.place_tree(state["params"], shardings),
            "opt": _place_state(state["opt"], opt_shardings(
                optimizer, shardings, state["params"])),
            "step": torch.as_tensor(state["step"], dtype=torch.int32).to(
                lay.device)}


def init_sharded_train_state(cfg, tcfg: TrainCfg, generator, lay):
    """``init_train_state``'s parameters (drawn whole on the generator's
    device, then laid out, one copied block a local shard) and an
    optimizer state made on each local shard's blocks (no whole copy),
    every leaf a ``Placed``."""
    shardings = lm.param_shardings(cfg, lay)
    params = shd.place_tree(lm.init_lm(cfg, generator), shardings)
    opt_init, _ = get_optimizer(tcfg.optimizer)
    meta = lm.init_lm(cfg, None)
    opt = _assemble([opt_init(p) for p in shd.local_trees(params,
                                                          lay.local)],
                    opt_shardings(tcfg.optimizer, shardings, meta),
                    opt_init(meta))
    return {"params": params, "opt": opt,
            "step": torch.zeros((), dtype=torch.int32, device=lay.device)}


def make_sharded_train_step(cfg, tcfg: TrainCfg, lay):
    """``make_train_step`` on ``lay``'s mesh: ``train_step(params,
    opt_state, batch, step, keys)`` with the params and optimizer state
    of ``init_sharded_train_state`` and a global batch (split into each
    local shard's rows here) -> (params, opt_state, metrics), in place.
    The metrics are 0-d tensors on the first local shard's device
    (``lr`` a float32 CPU tensor).  Across processes every process calls
    it on the same batch and steps its own shards' blocks."""
    _, opt_update = get_optimizer(tcfg.optimizer)
    loss_fn = make_sharded_loss_fn(cfg, tcfg, lay)
    schedule = SCHEDULES[tcfg.schedule]
    n = len(lay.local)

    def blocks(batch):
        return {k: lay.batch_blocks(v) for k, v in batch.items()}

    def train_step(params, opt_state, batch, step, keys=None):
        nm = tcfg.microbatches
        keys = _per_microbatch(keys, nm)
        if nm > 1:
            grads, loss, ms = None, None, []
            for i in range(nm):
                mb = {k: v.reshape((nm, v.shape[0] // nm) + v.shape[1:])[i]
                      for k, v in batch.items()}
                (l, m), g = sharded_value_and_grad(loss_fn, params, n,
                                                   blocks(mb), keys[i])
                grads = g if grads is None else [
                    [a.add_(b) for a, b in zip(ga, gb)]
                    for ga, gb in zip(grads, g)]
                loss = l if loss is None else loss + l
                ms.append(m)
            grads = [[g / nm for g in gs] for gs in grads]
            loss = loss / nm
            metrics = {k: torch.stack([m[k] for m in ms]).mean()
                       for k in ms[0]}
        else:
            (loss, metrics), grads = sharded_value_and_grad(
                loss_fn, params, n, blocks(batch), keys[0])
        grads = reduce_replicas(params, grads)
        lr = schedule(step, peak=tcfg.lr, warmup=tcfg.warmup,
                      total=tcfg.total_steps)
        gnorm = global_norm(params, grads)
        if tcfg.optimizer == "adafactor":
            adafactor_update_placed(params, grads, opt_state, lr=lr,
                                    weight_decay=tcfg.weight_decay)
        else:
            kw = dict(momentum=0.9) if tcfg.optimizer == "sgd" else dict(
                weight_decay=tcfg.weight_decay, grad_clip=0.0)
            if tcfg.optimizer == "adamw" and tcfg.grad_clip:
                scale = torch.clamp(tcfg.grad_clip / gnorm.clamp_min(1e-9),
                                    max=1.0)
                grads = [[g * scale.to(g.device, g.dtype) for g in gs]
                         for gs in grads]
            local_p = shd.local_trees(params, lay.local)
            local_o = shd.local_trees(opt_state, lay.local)
            for s in range(n):
                opt_update(local_p[s], [gs[s] for gs in grads], local_o[s],
                           lr=lr, **kw)
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
    ``(seed, step)``, drawn from by each microbatch in turn.

    Built under rules with a mesh (``axis_rules``), it trains on that
    mesh (``make_sharded_train_step``); ``device`` is then this process's
    first shard's device, and ``layout`` the mesh's ``ShardLayout``.  On
    a mesh that spans processes every process builds it and runs the same
    steps on its own shards; checkpoints are refused there (a process
    holds only its own blocks)."""

    def __init__(self, cfg, tcfg: TrainCfg, data_fn, *, ckpt_dir=None,
                 ckpt_every=50, keep=3, async_ckpt=True,
                 straggler_factor=3.0, failure_injector=None, device="cuda"):
        rules = shd.current_rules()
        self.layout = None if rules is None or rules.mesh is None \
            else shd.ShardLayout(rules)
        if ckpt_dir and self.layout is not None and self.layout.mesh.spans:
            raise NotImplementedError(
                "checkpoints of a train state on a mesh that spans "
                "processes: each process holds only its own blocks")
        self.device = resolve_device(device if self.layout is None
                                     else self.layout.device)
        self.cfg, self.tcfg = cfg, tcfg
        self.data_fn = data_fn
        self.state = self._fresh_state()
        self.train_step = make_train_step(cfg, tcfg) if self.layout is None \
            else make_sharded_train_step(cfg, tcfg, self.layout)
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
        gen = torch.Generator(device=self.device).manual_seed(self.tcfg.seed)
        if self.layout is not None:
            return init_sharded_train_state(self.cfg, self.tcfg, gen,
                                            self.layout)
        return init_train_state(self.cfg, self.tcfg, gen)

    @property
    def step(self):
        return self._step

    def load_state(self, state):
        """Take ``state`` (``{"params", "opt", "step"}``: whole tensors, or
        ``Placed`` leaves laid out on any mesh by any rules, such as
        ``checkpoint.elastic.reshard_state`` gives) as this trainer's,
        each leaf laid out as the trainer lays out its own (a ``Placed``
        leaf already so kept, any other re-laid by gather and slice, a
        copy) -> self."""
        def take(mine, new):
            if isinstance(mine, dict):
                return {k: take(mine[k], new[k]) for k in mine}
            if isinstance(mine, (list, tuple)):
                return type(mine)(take(a, b) for a, b in zip(mine, new))
            if isinstance(mine, shd.Placed):
                if (isinstance(new, shd.Placed)
                        and new.sharding.mesh is mine.sharding.mesh
                        and tuple(new.sharding.spec)
                        == tuple(mine.sharding.spec)):
                    return new
                whole = new.gather() if isinstance(new, shd.Placed) else \
                    torch.as_tensor(new)
                return shd.Placed.put(whole.to(mine.dtype), mine.sharding)
            whole = new.gather() if isinstance(new, shd.Placed) else \
                torch.as_tensor(new)
            return whole.to(mine.device, mine.dtype).clone()
        self.state = take(self.state, state)
        self._step = int(self.state["step"])
        return self

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
