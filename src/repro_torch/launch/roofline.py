"""Three-term roofline model of one NVIDIA H100 SXM (the port's target).

  compute    = flops_per_chip / PEAK_FLOPS
  memory     = hbm_bytes_per_chip / HBM_BW
  collective = collective_bytes_per_chip / LINK_BW

Port of ``repro.launch.roofline``, whose constants are a TPU v5e's.  The
terms come from ``launch/dryrun.py``'s traced step: per-chip flops and
bytes from the step traced on ``meta`` tensors, collective bytes from
``distributed.sharding``'s counter.  ``MODEL_FLOPS`` = 6 N D (dense) or
6 N_active D (MoE) for a train step measures how much of the traced
compute is useful (it catches remat and redundancy).

``count_params``, ``active_params`` and ``model_flops`` take a tree
(dicts, lists, tuples) of tensors, ``meta`` ones included, as
``lm.init_lm(cfg, None)`` gives it.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

# NVIDIA's H100 SXM data sheet, dense (no sparsity), at the 700 W limit:
PEAK_FLOPS = 989e12       # bf16 tensor-core FLOP/s
HBM_BW = 3.35e12          # HBM3 bytes/s
# The link term: the 16 x 16 and 2 x 16 x 16 meshes span many 8-card
# hosts (DGX H100), so the binding link is the 400 Gb/s InfiniBand port
# (ConnectX-7) each card has, 50e9 bytes/s.  NVLink's 450 GB/s each way
# joins only the 8 cards of one host.
LINK_BW = 50e9            # bytes/s a card, between hosts
HBM_BYTES = 80e9          # device memory a card (80 GB)


@dataclass
class Roofline:
    flops: float               # per-chip traced flops
    hbm_bytes: float           # per-chip bytes accessed
    coll_bytes: float          # per-chip collective bytes
    model_flops: float         # global useful flops (6ND)
    n_chips: int

    @property
    def compute_s(self):
        return self.flops / PEAK_FLOPS

    @property
    def memory_s(self):
        return self.hbm_bytes / HBM_BW

    @property
    def collective_s(self):
        return self.coll_bytes / LINK_BW

    @property
    def bottleneck(self):
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_s(self):
        """Optimistic (perfect-overlap) step time = max of the terms."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flop_fraction(self):
        """MODEL_FLOPS / (global traced flops)."""
        total = self.flops * self.n_chips
        return self.model_flops / total if total else 0.0

    @property
    def mfu_upper_bound(self):
        """Model-flop utilization implied by the roofline step time."""
        denom = self.step_s * PEAK_FLOPS * self.n_chips
        return self.model_flops / denom if denom else 0.0

    def as_dict(self):
        return {
            "flops_per_chip": self.flops,
            "hbm_bytes_per_chip": self.hbm_bytes,
            "collective_bytes_per_chip": self.coll_bytes,
            "model_flops": self.model_flops,
            "n_chips": self.n_chips,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "bottleneck": self.bottleneck,
            "step_s": self.step_s,
            "useful_flop_fraction": self.useful_flop_fraction,
            "mfu_upper_bound": self.mfu_upper_bound,
        }


def leaves(tree) -> list:
    """The tensors of a tree of dicts, lists and tuples, in order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def count_params(shapes_tree) -> int:
    return sum(x.numel() for x in leaves(shapes_tree))


def active_params(cfg, params_shapes):
    """Active params per token: MoE expert weights count at top_k/E.

    Expert weights are identified by their experts dim (== cfg.moe.n_experts
    in dims 1-2 of the layer-stacked (L, E, ...) tensors)."""
    xs = leaves(params_shapes)
    total = sum(x.numel() for x in xs)
    if cfg.moe is None:
        return total
    E = cfg.moe.n_experts
    expert_sz = sum(x.numel() for x in xs
                    if x.dim() >= 3 and E in tuple(x.shape[:2]))
    return (total - expert_sz) + expert_sz * cfg.moe.top_k / E


def model_flops(cfg, params_shapes, shape_cfg):
    """6·N(_active)·D for a train step; 2·N_active per token for decode."""
    n_act = active_params(cfg, params_shapes)
    tokens = shape_cfg.global_batch * shape_cfg.seq_len
    if shape_cfg.kind == "train":
        return 6.0 * n_act * tokens
    if shape_cfg.kind == "prefill":
        return 2.0 * n_act * tokens
    # decode: one token per sequence
    return 2.0 * n_act * shape_cfg.global_batch
