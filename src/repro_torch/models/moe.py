"""Mixture-of-Experts with top-k routing.

Port of ``repro.models.moe``'s one-device path: ``moe_reference`` runs
every expert on every token (exact, no capacity drops), which is what the
reference's ``apply_moe`` takes when no mesh with a 'model' axis is
installed.  The expert-parallel path (``moe_ep``, ``_local_moe``:
``shard_map`` with a fixed-capacity all-to-all) needs several devices and
waits for ROADMAP §1 item 6; here it raises.

``jax.lax.top_k`` breaks ties by the lower index; ``_top_k`` does the same
with a stable descending sort.  The expert products are batched over the
experts' own leading axis, so no expert weight is copied into another
layout.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.common import activation, dense_init, truncated_normal

_EP_WAITS = ("expert-parallel MoE (shard_map and all-to-all over a 'model' "
             "axis) waits for ROADMAP §1 item 6 (sharded and distributed); "
             "one device takes moe_reference")


def init_moe(generator, moe_cfg, d_model, *, dtype=torch.float32):
    """Same shapes and scales as the reference's ``init_moe``; the draws
    differ (``generator=None``: shapes only, on the ``meta`` device)."""
    E, ff = moe_cfg.n_experts, moe_cfg.d_ff_expert
    s_in, s_out = 1.0 / math.sqrt(d_model), 1.0 / math.sqrt(ff)
    params = {"router": dense_init(generator, (d_model, E),
                                   dtype=torch.float32),
              "w_up": truncated_normal(generator, (E, d_model, ff), s_in,
                                       dtype)}
    if moe_cfg.gated:
        params["w_gate"] = truncated_normal(generator, (E, d_model, ff),
                                            s_in, dtype)
    params["w_down"] = truncated_normal(generator, (E, ff, d_model), s_out,
                                        dtype)
    return params


def _top_k(x, k):
    """``jax.lax.top_k`` over the last axis: the k largest, ties to the
    lower index -> (values, indices)."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def _router(p, moe_cfg, x2d):
    """x2d: (T, d) -> (top_p, top_e, probs).  Softmax-then-topk-renorm."""
    logits = x2d.float() @ p["router"]["w"]
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = _top_k(probs, moe_cfg.top_k)
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)
    return top_p, top_e, probs


def _aux_loss(moe_cfg, probs, top_e):
    """Switch-style load-balance loss: E * sum_e f_e * P_e."""
    E = moe_cfg.n_experts
    assign = F.one_hot(top_e, E).float().sum(1)      # (T, E)
    f = assign.mean(0) / moe_cfg.top_k * E
    return (f * probs.mean(0)).sum()


def moe_reference(p, moe_cfg, x):
    """x: (B, S, d).  Computes all experts on all tokens — exact ->
    (y (B, S, d), aux)."""
    B, S, d = x.shape
    x2d = x.reshape(-1, d)
    top_p, top_e, probs = _router(p, moe_cfg, x2d)
    fn = activation(moe_cfg.act)
    up = torch.matmul(x2d, p["w_up"].to(x.dtype))             # (E, T, f)
    if "w_gate" in p:
        h = fn(torch.matmul(x2d, p["w_gate"].to(x.dtype))) * up
    else:
        h = fn(up)
    y_all = torch.matmul(h, p["w_down"].to(x.dtype))          # (E, T, d)
    w_full = torch.zeros(x2d.shape[0], moe_cfg.n_experts,
                         device=x.device).scatter_add_(1, top_e, top_p)
    y = torch.einsum("te,etd->td", w_full.to(x.dtype), y_all)
    return y.reshape(B, S, d), _aux_loss(moe_cfg, probs, top_e)


def moe_ep(p, moe_cfg, x, *, cap_factor=1.25):
    """Expert-parallel MoE: not on one device (ROADMAP §1 item 6)."""
    raise NotImplementedError(_EP_WAITS)


def _local_moe(*args, **kwargs):
    """``moe_ep``'s per-device body: not on one device (ROADMAP §1 item
    6)."""
    raise NotImplementedError(_EP_WAITS)


def apply_moe(p, moe_cfg, x):
    """The MoE layer -> (y, aux).  One device has no 'model' mesh axis, so
    this is ``moe_reference``, as in the reference without a mesh."""
    return moe_reference(p, moe_cfg, x)
