"""Server Refiner (paper §4.3): temporal buffer with gap tolerance plus
hybrid-loss refinement over the buffered manifold.

Port of ``repro.core.server``.  The buffer is a host ring keyed by
absolute frame index (window W=100 ≈ 1 s of context); gaps left by the
splitter or the network show up as mask=0 in the snapshot.  The refiner
is the single-session reference the fleet refiner is held to: a
``FleetRefiner`` step over one session equals a ``ServerRefiner`` step
on the same frames and draws.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.hybrid import HybridCfg, hybrid_loss
from repro_torch.kernels.ops import resolve_device
from repro_torch.optim.sgd import (sgd_init, sgd_update, tree_map,
                                   value_and_grad)


class TemporalBuffer:
    def __init__(self, window=100, dim=128):
        self.window = window
        self.dim = dim
        self.z = np.zeros((window, dim), np.float32)
        # sentinel far below any reachable negative window index
        self.t = np.full((window,), -(1 << 60), np.int64)
        self.label = np.full((window,), -1, np.int64)
        self.newest = -1

    def insert(self, t, z, label=-1):
        slot = t % self.window
        self.z[slot] = np.asarray(z, np.float32)
        self.t[slot] = t
        self.label[slot] = label
        self.newest = max(self.newest, t)

    def snapshot(self):
        """-> (z (W, d), mask (W,), labels (W,)) in temporal order, where
        mask=0 marks gaps (never filled or expired)."""
        if self.newest < 0:
            return (np.zeros((self.window, self.dim), np.float32),
                    np.zeros((self.window,), np.float32),
                    np.full((self.window,), -1, np.int64))
        order = np.arange(self.newest - self.window + 1, self.newest + 1)
        slots = order % self.window
        valid = self.t[slots] == order
        z = np.where(valid[:, None], self.z[slots], 0.0).astype(np.float32)
        labels = np.where(valid, self.label[slots], -1)
        return z, valid.astype(np.float32), labels

    @property
    def fill_fraction(self):
        return float(self.snapshot()[1].mean())


@dataclass
class RefinerState:
    params: dict
    opt_state: tuple
    step: int = 0


def masked_ce(logits, labels, mask):
    """Per-row CE over frames that are present and labelled, averaged
    over them: logits (..., W, C), labels and mask (..., W) -> (...)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    ce = -logp.gather(-1, labels.clamp_min(0)[..., None]).squeeze(-1)
    w = mask * (labels >= 0).float()
    return (ce * w).sum(-1) / w.sum(-1).clamp_min(1.0)


class ServerRefiner:
    """Optimizes L_server = L_task + λ₁ L_SW + λ₂ L_Lap over buffer
    snapshots with one momentum-SGD step per ``refine``.

    ``head_init(generator) -> params`` (a dict of tensors; a caller that
    has its params already returns them) and ``head_apply(params, z) ->
    logits`` for z (B, d) are the task head.  ``refine(key, buffer)``
    takes a ``key`` as ``core.swd.draw`` does: a ``torch.Generator`` or a
    ``(dirs, prior)`` pair."""

    def __init__(self, head_init, head_apply, *, cfg: HybridCfg = HybridCfg(),
                 lr=1e-2, seed=0, device="cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.head_apply = head_apply
        # a copy: the SGD step updates it in place
        params = tree_map(lambda p: p.detach().to(self.device, copy=True),
                          head_init(torch.Generator().manual_seed(seed)))
        self.state = RefinerState(params, sgd_init(params), 0)
        self.lr = lr

    def loss_fn(self, params, key, z, mask, labels):
        task = masked_ce(self.head_apply(params, z), labels, mask)
        reg, parts = hybrid_loss(key, z, self.cfg, mask=mask,
                                 variant="hybrid")
        # hybrid_loss's task term is 0 here (no pairs); the CE goes on top
        return task + reg, {**parts, "task": task}

    def refine(self, key, buffer: TemporalBuffer):
        dev = self.device
        z, mask, labels = (torch.as_tensor(a, device=dev)
                           for a in buffer.snapshot())
        if not isinstance(key, torch.Generator):
            key = tuple(torch.as_tensor(a, device=dev) for a in key)
        (loss, parts), grads = value_and_grad(
            self.loss_fn, self.state.params, key, z, mask, labels)
        sgd_update(self.state.params, grads, self.state.opt_state,
                   lr=self.lr, momentum=0.9)
        self.state.step += 1
        out = torch.stack([loss] + [v.detach() for v in
                                    parts.values()]).cpu()
        return float(out[0]), {k: float(v) for k, v in zip(parts, out[1:])}

