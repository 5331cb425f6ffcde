"""Mixture-of-Experts with top-k routing.

Port of ``repro.models.moe``.  Two paths, as in the reference:

* ``moe_reference`` runs every expert on every token (exact, no capacity
  drops): the oracle, and what ``apply_moe`` takes without a mesh whose
  'model' axis is larger than one and divides the experts.
* ``moe_ep``, expert parallelism over the installed rules' mesh: the
  experts split over 'model', the tokens split over the batch axes and,
  where the sequence divides 'model', over 'model' too
  (``_local_moe``: a fixed-capacity dispatch, an ``all_to_all`` over
  'model', the shard's experts, the ``all_to_all`` back and the gated
  combine, GShard-style dropping); else whole over 'model'
  (``_local_moe_replicated``: each shard its own experts' contributions,
  psum'd).  The reference's ``shard_map`` bodies run once a shard here, in
  lockstep, with the collectives of ``distributed/sharding.py`` between
  their stages.  Slot order, ``CAP``, ``ECAP`` and the dropped copies are
  the reference's cumsum's; the combine sums each token's k gated copies
  in order (a gather, no scatter-add), so it has no atomics.  The
  auxiliary loss takes the expert fractions and mean probabilities
  ``pmean``'d over every shard before their product, as the reference's.
  Prefill and decode on a mesh take the same path (``lm``'s sharded
  blocks call ``apply_moe_sharded``): a decode step's one position does
  not divide 'model', so it takes ``_local_moe_replicated``.

``jax.lax.top_k`` breaks ties by the lower index; ``_top_k`` does the same
with a stable descending sort.  The expert products are batched over the
experts' own leading axis, so no expert weight is copied into another
layout.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.distributed import sharding as shd
from repro_torch.models.common import activation, dense_init, truncated_normal

def init_moe(generator, moe_cfg, d_model, *, dtype=torch.float32,
             with_axes=False):
    """Same shapes and scales as the reference's ``init_moe``; the draws
    differ (``generator=None``: shapes only, on the ``meta`` device)."""
    E, ff = moe_cfg.n_experts, moe_cfg.d_ff_expert
    s_in, s_out = 1.0 / math.sqrt(d_model), 1.0 / math.sqrt(ff)
    params, axes = {}, {}
    params["router"], axes["router"] = dense_init(
        generator, (d_model, E), ("router", "router"), dtype=torch.float32)
    params["w_up"] = truncated_normal(generator, (E, d_model, ff), s_in,
                                      dtype)
    axes["w_up"] = ("experts", "embed", "expert_mlp")
    if moe_cfg.gated:
        params["w_gate"] = truncated_normal(generator, (E, d_model, ff),
                                            s_in, dtype)
        axes["w_gate"] = ("experts", "embed", "expert_mlp")
    params["w_down"] = truncated_normal(generator, (E, ff, d_model), s_out,
                                        dtype)
    axes["w_down"] = ("experts", "expert_mlp", "embed")
    return (params, axes) if with_axes else params


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


def _expert_ffn(moe_cfg, w_up, w_gate, w_down, xb):
    """xb: (E_local, C, d) -> (E_local, C, d)."""
    fn = activation(moe_cfg.act)
    up = torch.matmul(xb, w_up.to(xb.dtype))
    h = fn(torch.matmul(xb, w_gate.to(xb.dtype))) * up \
        if w_gate is not None else fn(up)
    return torch.matmul(h, w_down.to(xb.dtype))


def _slots(ids, n, cap):
    """Position of each entry among the earlier entries with its id (the
    reference's one-hot cumsum), kept where below ``cap`` -> (pos,
    keep); ids < 0 are never kept."""
    onehot = (ids[:, None] == torch.arange(n, device=ids.device)).long()
    pos = ((onehot.cumsum(0) - 1) * onehot).sum(-1)
    return pos, (ids >= 0) & (pos < cap)


def _scatter_rows(n_rows, slot, rows):
    """A (n_rows + 1, d) buffer with ``rows`` at ``slot`` (row n_rows is
    the dump row of the dropped ones; differentiable)."""
    buf = rows.new_zeros((n_rows + 1,) + rows.shape[1:])
    return buf.index_put((slot,), rows)


def _route_all(ps, moe_cfg, x2ds):
    return [_router(p, moe_cfg, x) for p, x in zip(ps, x2ds)]


def _aux(lay, moe_cfg, routed):
    """``E * sum_e f_e P_e`` with f and P pmean'd over every shard."""
    E, k = moe_cfg.n_experts, moe_cfg.top_k
    fs = lay.pmean_all([F.one_hot(te, E).float().sum(1).mean(0)
                        for _, te, _ in routed])
    Ps = lay.pmean_all([pr.mean(0) for _, _, pr in routed])
    return [(f / k * E * P).sum() for f, P in zip(fs, Ps)]


def _local_moe(lay, ps, moe_cfg, x_locals, cap_factor):
    """The dispatch path, one ``shard_map`` body a shard: ``x_locals[s]``
    (B_l, S/R, d) are shard s's tokens, ``ps[s]`` its router and expert
    blocks -> (outputs (B_l, S/R, d), aux, dropped copies), a list each."""
    R = lay.M
    E_local = moe_cfg.n_experts // R
    k = moe_cfg.top_k
    B_l, S_l, d = x_locals[0].shape
    T = B_l * S_l
    x2ds = [x.reshape(T, d) for x in x_locals]
    routed = _route_all(ps, moe_cfg, x2ds)
    aux = _aux(lay, moe_cfg, routed)
    CAP = int(math.ceil(T * k / R * cap_factor))
    ECAP = int(math.ceil(R * CAP / E_local * cap_factor))
    send, meta = [], []
    for x2d, (top_p, top_e, _) in zip(x2ds, routed):
        eid = top_e.reshape(-1)
        gate = top_p.reshape(-1).to(x2d.dtype)
        dst = eid // E_local
        pos, keep = _slots(dst, R, CAP)
        slot = torch.where(keep, dst * CAP + pos, R * CAP)
        send_x = _scatter_rows(R * CAP, slot, x2d.repeat_interleave(k, 0))
        send_le = torch.full((R * CAP + 1,), -1, dtype=torch.long,
                             device=x2d.device).index_put(
            (slot,), eid % E_local)
        send.append((send_x[:R * CAP].reshape(R, CAP, d),
                     send_le[:R * CAP].reshape(R, CAP)))
        meta.append((slot, keep, gate))
    recv_x = lay.all_to_all_model([x for x, _ in send], 0, 0)
    recv_le = lay.all_to_all_model([le for _, le in send], 0, 0)
    rets, dropped = [], []
    for p, rx, rle, (_, keep, _) in zip(ps, recv_x, recv_le, meta):
        rx, rle = rx.reshape(R * CAP, d), rle.reshape(R * CAP)
        epos, ekeep = _slots(rle, E_local, ECAP)
        eslot = torch.where(ekeep, rle * ECAP + epos, E_local * ECAP)
        ebuf = _scatter_rows(E_local * ECAP, eslot, rx)[:-1].reshape(
            E_local, ECAP, d)
        ybuf = _expert_ffn(moe_cfg, p["w_up"], p.get("w_gate"),
                           p["w_down"], ebuf)
        ypad = torch.cat([ybuf.reshape(E_local * ECAP, d),
                          ybuf.new_zeros(1, d)])
        rets.append(torch.where(ekeep[:, None], ypad[eslot], 0.0).reshape(
            R, CAP, d))
        dropped.append((~keep).sum() + ((rle >= 0) & ~ekeep).sum())
    backs = lay.all_to_all_model(rets, 0, 0)
    outs = []
    for back, (slot, keep, gate) in zip(backs, meta):
        back = torch.cat([back.reshape(R * CAP, d), back.new_zeros(1, d)])
        contrib = torch.where(keep[:, None], back[slot], 0.0) * gate[:, None]
        outs.append(contrib.reshape(T, k, d).sum(1).reshape(B_l, S_l, d))
    return outs, aux, dropped


def _local_moe_replicated(lay, ps, moe_cfg, xs, cap_factor):
    """EP without token dispatch (tokens whole over 'model'): each shard
    its own experts' contributions, psum'd over 'model' -> (outputs,
    aux, dropped copies), a list each."""
    R = lay.M
    E_local = moe_cfg.n_experts // R
    k = moe_cfg.top_k
    B_l, S_l, d = xs[0].shape
    T = B_l * S_l
    x2ds = [x.reshape(T, d) for x in xs]
    routed = _route_all(ps, moe_cfg, x2ds)
    aux = _aux(lay, moe_cfg, routed)
    ECAP = int(math.ceil(T * k / E_local * cap_factor))
    outs, dropped = [], []
    for p, x2d, (top_p, top_e, _), rank in zip(ps, x2ds, routed, lay.rank):
        eid = top_e.reshape(-1)
        gate = top_p.reshape(-1).to(x2d.dtype)
        le = eid - rank * E_local
        mine = (le >= 0) & (le < E_local)
        epos, keep = _slots(torch.where(mine, le, -1), E_local, ECAP)
        eslot = torch.where(keep, le * ECAP + epos, E_local * ECAP)
        ebuf = _scatter_rows(E_local * ECAP, eslot,
                             x2d.repeat_interleave(k, 0))[:-1].reshape(
            E_local, ECAP, d)
        ybuf = _expert_ffn(moe_cfg, p["w_up"], p.get("w_gate"),
                           p["w_down"], ebuf)
        ypad = torch.cat([ybuf.reshape(E_local * ECAP, d),
                          ybuf.new_zeros(1, d)])
        contrib = torch.where(keep[:, None], ypad[eslot], 0.0) * gate[:, None]
        outs.append(contrib.reshape(T, k, d).sum(1).reshape(B_l, S_l, d))
        dropped.append((mine & ~keep).sum())
    return lay.psum_model(outs), aux, dropped


def moe_ep_sharded(lay, ps, moe_cfg, xs, *, cap_factor=1.25,
                   with_drops=False):
    """Expert-parallel MoE on a mesh: ``xs[s]`` shard s's rows (B_l, S, d),
    whole over 'model', ``ps[s]`` its router and expert blocks -> (outputs
    whole over 'model', aux) a list each (with ``with_drops``, also the
    copies each shard dropped).  The sequence splits over 'model' for the
    dispatch path where it divides it, and is gathered back after."""
    R = lay.M
    if moe_cfg.n_experts % R:
        raise ValueError(f"experts {moe_cfg.n_experts} must divide model "
                         f"axis {R}")
    S = xs[0].shape[1]
    if S % R == 0:
        blk = S // R
        x_loc = [x[:, r * blk:(r + 1) * blk] for x, r in zip(xs, lay.rank)]
        ys, aux, dropped = _local_moe(lay, ps, moe_cfg, x_loc, cap_factor)
        ys = lay.all_gather_model(ys, 1)
    else:
        ys, aux, dropped = _local_moe_replicated(lay, ps, moe_cfg, xs,
                                                 cap_factor)
    return (ys, aux, dropped) if with_drops else (ys, aux)


def _use_ep(rules, moe_cfg, force_reference=False) -> bool:
    """The reference's condition for the expert-parallel path."""
    return (not force_reference and rules is not None
            and rules.mesh is not None
            and "model" in rules.mesh.axis_names
            and rules.mesh.shape["model"] > 1
            and moe_cfg.n_experts % rules.mesh.shape["model"] == 0)


def _moe_axes(moe_cfg):
    return init_moe(None, moe_cfg, 1, with_axes=True)[1]


def moe_ep(p, moe_cfg, x, *, cap_factor=1.25):
    """Expert-parallel MoE under the installed rules: global ``p`` and
    ``x`` (B, S, d), batch split over the data axes -> (y (B, S, d) on
    x's device, aux), as the reference's ``moe_ep``.  The params are laid
    out by the param rules (differentiable views)."""
    rules = shd.current_rules()
    if rules is None or rules.mesh is None:
        raise ValueError("moe_ep needs logical-axis rules with a mesh "
                         "(distributed.sharding.axis_rules)")
    lay = shd.ShardLayout(rules)
    placed = shd.place_tree(p, shd.param_sharding(_moe_axes(moe_cfg)),
                            copy=False)
    ps = shd.local_trees(placed, lay.local)
    ys, aux = moe_ep_sharded(lay, ps, moe_cfg, lay.batch_blocks(x),
                             cap_factor=cap_factor)
    return lay.gather_batch(ys).to(x.device), aux[0].to(x.device)


def apply_moe_sharded(lay, ps, moe_cfg, xs, *, force_reference=False):
    """``apply_moe`` on a mesh (per-shard rows and param blocks, as
    ``moe_ep_sharded``): ``moe_ep`` where the reference's condition holds,
    else ``moe_reference`` on each shard's rows with the aux taken over
    the global batch."""
    if _use_ep(lay.rules, moe_cfg, force_reference):
        return moe_ep_sharded(lay, ps, moe_cfg, xs)
    if lay.M > 1:
        raise ValueError(f"experts {moe_cfg.n_experts} do not split over "
                         f"model axis {lay.M}")
    outs = [moe_reference(p, moe_cfg, x)[0] for p, x in zip(ps, xs)]
    routed = _route_all(ps, moe_cfg, [x.reshape(-1, x.shape[-1])
                                      for x in xs])
    return outs, _aux(lay, moe_cfg, routed)


def apply_moe(p, moe_cfg, x, *, force_reference=False):
    """The MoE layer -> (y, aux): ``moe_ep`` under rules whose mesh has a
    'model' axis larger than one that divides the experts (the
    reference's dispatch), else ``moe_reference``."""
    if _use_ep(shd.current_rules(), moe_cfg, force_reference):
        return moe_ep(p, moe_cfg, x)
    return moe_reference(p, moe_cfg, x)
