"""Fleet refinement: one hybrid-loss step over N sessions at once.

Port of ``repro.core.fleet_refiner``; ``make_fleet_loss(axis_name=)``
is also the per-shard loss of ``ShardedFleetBackend``.  The
reference's ``vmap`` over sessions is a batch dimension here, and its
SW and Laplacian terms, which it computes in jnp, go through the
hand-written kernels ``swd_sessions`` and ``laplacian_energy``.  That is
exact for the gradient: ``z`` is the ring snapshot, data and not a
parameter, so those two terms are constants of the head's gradient and
only the CE term, plain PyTorch under autograd, reaches it.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.core.hybrid import HybridCfg
from repro_torch.core.server import masked_ce
from repro_torch.core.swd import diff_sort, seeded_draws
from repro_torch.kernels.laplacian_energy import laplacian_energy
from repro_torch.kernels.ops import resolve_device
from repro_torch.kernels.swd import swd_sessions
from repro_torch.optim.sgd import (sgd_init, sgd_update, tree_map,
                                   value_and_grad)


def make_fleet_loss(head_apply, cfg: HybridCfg, *, axis_name=None,
                    axis_size=1):
    """-> fleet_loss(params, dirs, prior, z, mask, labels, active,
    a_total=None) -> (loss, (losses (N,), parts)).

    Per session: the masked CE of ``head_apply(params, z)`` over labelled
    present frames, plus λ₁·SW against the prior's sorted slice quantiles
    plus λ₂·Laplacian over the gap-masked window.  ``dirs`` (M, d) and
    ``prior`` (W, d) are ONE draw shared by every session (common random
    numbers); session losses are averaged over active rows only.  ``z``
    must not require a gradient (the kernels have no backward).

    With ``axis_name`` the session axis is sharded and ``z``, ``mask``,
    ``labels``, ``active`` are one shard's rows: ``a_total`` must then be
    the active count ``psum``'d over the axis (each shard's
    ``active.sum()``), so every shard weights its sessions by the GLOBAL
    count, and the loss and parts are pre-scaled by ``axis_size`` (the
    axis's GLOBAL shard count, every process's shards together in a
    joined job) so that a ``pmean`` over the axis (gradients included,
    see ``distributed.grad_sync.pmean_grads``) is the global sum.  At
    ``axis_size == 1`` the psum'd count is the local one and the scaling
    is skipped, so a 1-shard mesh is bit-identical to the unsharded
    loss."""

    def fleet_loss(params, dirs, prior, z, mask, labels, active,
                   a_total=None):
        N, W, d = z.shape
        logits = head_apply(params, z.reshape(N * W, d)).reshape(N, W, -1)
        task = masked_ce(logits, labels, mask)
        prior_q = diff_sort(prior @ dirs.T, axis=0).contiguous()   # (W, M)
        sw = swd_sessions(z, dirs, prior_q)
        tot, cnt = laplacian_energy(z, mask, cfg.knn)
        lap = tot / cnt.clamp_min(1.0)
        losses = task + cfg.lam_sw * sw + cfg.lam_lap * lap
        if axis_name is None:
            a_total = active.sum()
        elif a_total is None:
            raise ValueError("the sharded fleet loss needs a_total, the "
                             "active count psum'd over the axis")
        w = active / a_total.clamp_min(1.0)
        parts = {"task": (task * w).sum(), "sw": (sw * w).sum(),
                 "lap": (lap * w).sum()}
        loss = (losses * w).sum()
        if axis_name is not None and axis_size > 1:
            # pre-scale so pmean(loss) == psum(local weighted sums): the
            # cross-shard mean-over-active-sessions estimator
            loss = loss * float(axis_size)
            parts = {k: v * float(axis_size) for k, v in parts.items()}
        return loss, (losses, parts)

    return fleet_loss


@dataclass
class FleetRefinerState:
    params: dict
    opt_state: tuple
    step: int = 0


class FleetRefiner:
    """One hybrid-loss refinement step for the whole fleet.

    ``head_init(generator) -> params`` (a dict of tensors, drawn from a
    generator seeded with ``seed``; a caller with its own params returns
    them) and ``head_apply(params, z) -> logits`` for z (B, d) are the
    shared task head; one momentum-SGD step updates it per round.

    Round ``rnd``'s SWD directions and prior come from ``draws(rnd) ->
    (dirs (M, d), prior (W, d))`` when given, else from
    ``core.swd.seeded_draws(seed, rnd, ...)``; the parity tests inject
    the reference's draws this way.  A step over N=1 equals the
    ``ServerRefiner`` step on the same draws."""

    def __init__(self, head_init, head_apply, *, cfg: HybridCfg = HybridCfg(),
                 lr=1e-2, seed=0, draws=None, device="cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.head_apply = head_apply
        self.seed = seed
        self.draws = draws
        # a copy: the SGD step updates it in place
        params = tree_map(lambda p: p.detach().to(self.device, copy=True),
                          head_init(torch.Generator().manual_seed(seed)))
        self.state = FleetRefinerState(params, sgd_init(params), 0)
        self.lr = lr
        self._loss = make_fleet_loss(head_apply, cfg)

    def draw(self, rnd, window, dim):
        """Round ``rnd``'s (dirs (M, d), prior (W, d)) on the device."""
        if self.draws is None:
            dirs, prior = seeded_draws(self.seed, rnd, self.cfg.n_dirs,
                                       window, dim)
        else:
            dirs, prior = self.draws(rnd)
        return tuple(torch.as_tensor(a, dtype=torch.float32,
                                     device=self.device).contiguous()
                     for a in (dirs, prior))

    def refine(self, rnd, fleet):
        """One fleet-wide step on ``fleet.snapshot()`` with round ``rnd``'s
        draws -> (mean active loss, mean active parts, per-session losses
        (N,))."""
        z, mask, labels = fleet.snapshot()
        return self.refine_arrays(rnd, z, mask, labels, fleet.active)

    def refine_arrays(self, rnd, z, mask, labels, active):
        """The step on a prepared snapshot (host arrays or tensors)."""
        return fetch(self.step(rnd, *self.to_device(z, mask, labels, active)))

    def to_device(self, z, mask, labels, active):
        """A snapshot as the step takes it: float32 z/mask/active and
        int64 labels on the refiner's device."""
        dev = self.device
        return (torch.as_tensor(z, dtype=torch.float32, device=dev),
                torch.as_tensor(mask, dtype=torch.float32, device=dev),
                torch.as_tensor(labels, dtype=torch.int64, device=dev),
                torch.as_tensor(active, dtype=torch.float32, device=dev))

    def step(self, rnd, z, mask, labels, active):
        """Loss, gradient and SGD step, all queued on the device without
        a wait -> (loss, parts, losses) as device tensors."""
        dirs, prior = self.draw(rnd, z.shape[1], z.shape[2])
        (loss, (losses, parts)), grads = value_and_grad(
            self._loss, self.state.params, dirs, prior, z, mask, labels,
            active)
        self.apply_grads(grads)
        return loss, parts, losses

    def apply_grads(self, grads):
        """The shared optimizer step (in place, see ``optim.sgd``)."""
        sgd_update(self.state.params, grads, self.state.opt_state,
                   lr=self.lr, momentum=0.9)
        self.state.step += 1


def fetch(out):
    """(loss, parts, losses) device tensors -> (float, {name: float},
    numpy (N,)) through ONE device->host copy."""
    loss, parts, losses = out
    host = torch.cat([torch.stack([loss, *parts.values()]).detach(),
                      losses.detach()]).cpu().numpy()
    n = 1 + len(parts)
    return (float(host[0]),
            {k: float(v) for k, v in zip(parts, host[1:n])}, host[n:])
