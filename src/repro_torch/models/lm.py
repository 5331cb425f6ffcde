"""LM assembly: decoder stacks for every family, over layers stacked on a
leading axis; the chunked cross-entropy loss; prefill and decode.

Port of ``repro.models.lm`` (a Python loop over the stacked layers where
the reference scans them):
  dense / vlm / audio : [norm -> attn, norm -> ffn] x L (pattern-cycled
                        windows)
  moe                 : the same with the MoE ffn (+ shared experts, a dense
                        residual; ``first_k_dense`` leading dense layers)
  ssm                 : [norm -> mamba] x L
  hybrid (zamba2)     : the mamba stack with one *shared* attn+mlp block
                        after every ``hybrid_period`` mamba layers
``decode_state_specs`` gives the decode state's logical axes, as the
reference's.

Under logical-axis rules whose mesh is installed (``distributed.sharding
.axis_rules``), ``forward``, ``chunked_ce``, ``lm_loss``, ``prefill`` and
``decode_step`` run every family on the mesh, as the reference runs them
under GSPMD: the batch over the data axes, heads, mlp, vocab, experts and
SSM heads over 'model' by the param rules (``attention.attention_sharded``,
``mlp.apply_mlp_sharded``, ``moe.apply_moe_sharded``,
``ssm.mamba_forward_sharded``), the embedding lookup and the logits
vocab-parallel (a shard's block of the table, psum'd; the CE's logsumexp
and target logit reduced over 'model' with a pmax and psums), the CE's
sums psum'd over the data axes.  Under FSDP rules (``rules_for(...,
fsdp=True)``) params are split over 'data' too and each layer's blocks
are gathered whole over it where the layer runs (inside its remat; the
gradient reduce-scattered back, ``fsdp_gather_over``).  Each shard runs
its block in lockstep with the others of its process; the reference's
``shard`` annotations are where the port's collectives sit.  On a mesh
that spans a joined job (``launch.mesh``) every process runs the same
program over its own shards only (``ShardLayout.local``, with their
ranks along 'model'), holds only their blocks of the params and the
decode state, and gathers the logits from every process, so every
process returns the same global logits (the reference's replicated
output).  The global
entry points lay the params out by ``param_axes`` (views, so gradients
reach the global tree; or take them laid out already, ``Placed``) and
gather the hidden states and logits back; ``runtime/trainer`` calls
``lm_loss_sharded`` on params it keeps laid out.  On a mesh the decode
state is a dict of ``Placed`` laid out by ``decode_state_specs`` under
the act rules (``decode_state_sharding``): kv heads over 'model', else
the cache's positions over 'model', or over 'data' at batch 1
(``attention.attention_decode_sharded``); SSM states by heads.

Prefill and decode: ``init_decode_state`` allocates the state (the KV
cache of every attention layer, the hybrid's one cache per use of its
shared block, the SSM and conv states, and ``index``, a 0-d int32 tensor
on the device); ``prefill`` fills it from a prompt and ``decode_step``
advances it by one token.  Both write into the state in place, and a
decode step reads no value on the host.

Remat: the reference wraps each layer in ``jax.checkpoint`` with the
``nothing_saveable`` policy when ``cfg.remat`` is set.  Here, when
``cfg.remat`` is set and autograd is recording, each layer runs under
``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)``: the
forward keeps only each layer's input, and the backward replays the
layer before it differentiates it.  On the card that replay runs the
flash forward kernel once more, so a training step launches it twice a
layer (and the dq and dk/dv kernels once each).  The replay gives the
same bits, so remat on and off give the same gradients.

``forward`` builds ``arange(S)`` positions when it is given none and then
tells ``attention`` so (``index_positions``): only those layers may take
the flash kernels on the card, whose causal mask is by index.  Positions
passed in take the plain path, which masks by position as the reference
does.
"""
from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from functools import lru_cache

from repro_torch.distributed import sharding as shd
from repro_torch.distributed.sharding import map_axes
from repro_torch.models import attention as attn_mod
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import (apply_dense, apply_norm, dense_init,
                                       device_of, embed_logits, embed_lookup,
                                       init_embedding, init_norm, softcap)

ATTN_FAMILIES = ("dense", "vlm", "audio", "moe")
GLOBAL_WINDOW = 1 << 30


def _stack(trees):
    """Dicts of tensors with one structure -> one dict of stacked
    tensors (a leading 'layers' axis)."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _stack_init(fn, generator, n):
    """n layers drawn one after the other from ``generator``, stacked ->
    (params, axes with a leading 'layers' name)."""
    drawn = [fn(generator) for _ in range(n)]
    return (_stack([p for p, _ in drawn]),
            map_axes(lambda a: ("layers",) + a, drawn[0][1]))


def _layers(tree, n):
    """The n layers of a stacked params dict, as a list of dicts of views
    (``unbind``: under autograd the stacked gradient is assembled once,
    not added up from n full-size ones)."""
    if isinstance(tree, dict):
        per_key = {k: _layers(v, n) for k, v in tree.items()}
        return [{k: v[i] for k, v in per_key.items()} for i in range(n)]
    return tree.unbind(0)


def _attn_layers(cfg, blocks):
    """The per-layer params of an attention stack in order: a MoE stack's
    ``first_k_dense`` dense layers, then its (or a dense stack's)
    'layers'."""
    kd = cfg.moe.first_k_dense if cfg.family == "moe" else 0
    dense = _layers(blocks["dense_layers"], kd) if kd else []
    return list(dense) + list(_layers(blocks["layers"], cfg.n_layers - kd))


def _hybrid_layout(cfg):
    """(#full groups, tail) for the hybrid mamba/shared-attn pattern."""
    p = cfg.hybrid_period
    return cfg.n_layers // p, cfg.n_layers % p


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def _init_dense_block(cfg, generator):
    dev, dt = device_of(generator), cfg.pdtype
    p, a = {}, {}
    p["ln1"], a["ln1"] = init_norm(cfg.norm, cfg.d_model, dtype=dt,
                                   device=dev, with_axes=True)
    p["attn"], a["attn"] = attn_mod.init_attention(generator, cfg, dtype=dt,
                                                   with_axes=True)
    p["ln2"], a["ln2"] = init_norm(cfg.norm, cfg.d_model, dtype=dt,
                                   device=dev, with_axes=True)
    p["mlp"], a["mlp"] = mlp_mod.init_mlp(generator, cfg.d_model, cfg.d_ff,
                                          gated=cfg.gated_mlp, dtype=dt,
                                          with_axes=True)
    return p, a


def _init_moe_block(cfg, generator):
    dev, dt = device_of(generator), cfg.pdtype
    p, a = {}, {}
    p["ln1"], a["ln1"] = init_norm(cfg.norm, cfg.d_model, dtype=dt,
                                   device=dev, with_axes=True)
    p["attn"], a["attn"] = attn_mod.init_attention(generator, cfg, dtype=dt,
                                                   with_axes=True)
    p["ln2"], a["ln2"] = init_norm(cfg.norm, cfg.d_model, dtype=dt,
                                   device=dev, with_axes=True)
    p["moe"], a["moe"] = moe_mod.init_moe(generator, cfg.moe, cfg.d_model,
                                          dtype=dt, with_axes=True)
    if cfg.moe.n_shared_experts:
        ff = cfg.moe.d_ff_expert * cfg.moe.n_shared_experts
        p["shared_mlp"], a["shared_mlp"] = mlp_mod.init_mlp(
            generator, cfg.d_model, ff, gated=cfg.gated_mlp, dtype=dt,
            with_axes=True)
    if cfg.moe.dense_residual:
        p["dense_mlp"], a["dense_mlp"] = mlp_mod.init_mlp(
            generator, cfg.d_model, cfg.d_ff, gated=cfg.gated_mlp, dtype=dt,
            with_axes=True)
    return p, a


def _init_mamba_block(cfg, generator):
    p, a = {}, {}
    p["ln"], a["ln"] = init_norm(cfg.norm, cfg.d_model, dtype=cfg.pdtype,
                                 device=device_of(generator), with_axes=True)
    p["mamba"], a["mamba"] = ssm_mod.init_mamba(
        generator, cfg.ssm, cfg.d_model, dtype=cfg.pdtype, with_axes=True)
    return p, a


def _block(cfg, p, x, attend):
    """One attention layer, dense or MoE, with ``attend(p_attn, h)`` as its
    attention (full-sequence, prefill or decode) -> (x, the MoE auxiliary
    loss or None)."""
    x = x + attend(p["attn"], apply_norm(cfg.norm, p["ln1"], x))
    h = apply_norm(cfg.norm, p["ln2"], x)
    if "moe" not in p:
        return x + mlp_mod.apply_mlp(p["mlp"], h, act=cfg.act), None
    y, aux = moe_mod.apply_moe(p["moe"], cfg.moe, h)
    for name in ("shared_mlp", "dense_mlp"):
        if name in p:
            y = y + mlp_mod.apply_mlp(p[name], h, act=cfg.act)
    return x + y, aux


def _mamba_block(cfg, p, x):
    return x + ssm_mod.mamba_forward(p["mamba"], cfg.ssm,
                                     apply_norm(cfg.norm, p["ln"], x))


def _mamba_stack(cfg, blocks, x, mamba, shared):
    """An ssm or hybrid stack: ``x = mamba(i, p_i, x)`` for each layer i
    and, in a hybrid, ``x = shared(g, x)`` after each of its G full groups
    of ``hybrid_period`` layers (the tail has no shared block)."""
    per = cfg.hybrid_period if cfg.family == "hybrid" else 0
    for i, p_l in enumerate(_layers(blocks["layers"], cfg.n_layers)):
        x = mamba(i, p_l, x)
        if per and (i + 1) % per == 0:
            x = shared((i + 1) // per - 1, x)
    return x


def _cached_stack(cfg, blocks, x, attend, mamba):
    """One pass of prefill or decode over the stack: ``attend(c, window)``
    gives the attention of the layer (or shared-block use) whose cache is
    ``c``, ``mamba(i, p_i, x)`` runs mamba layer i."""
    if cfg.family in ATTN_FAMILIES:
        for c, (p_l, w) in enumerate(zip(_attn_layers(cfg, blocks),
                                         cfg.layer_windows())):
            x, _ = _block(cfg, p_l, x, attend(c, w))
        return x
    return _mamba_stack(cfg, blocks, x, mamba, lambda g, x: _block(
        cfg, blocks["shared"], x, attend(g, GLOBAL_WINDOW))[0])


def _maybe_remat(cfg, fn):
    """``fn`` under activation checkpointing when ``cfg.remat`` is set and
    autograd is recording (the reference's ``nothing_saveable`` remat);
    else ``fn`` itself."""
    if not (cfg.remat and torch.is_grad_enabled()):
        return fn

    def remat(*args):
        # a layer draws no random numbers: no RNG state to replay
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False)
    return remat


# ---------------------------------------------------------------------------
# Model init
# ---------------------------------------------------------------------------

def init_lm(cfg, generator, *, with_axes=False):
    """Random weights drawn from ``generator`` on its device (``None``:
    shapes only, on the ``meta`` device).  Same shapes and scales as the
    reference's ``init_lm``; the draws differ.  With ``with_axes`` ->
    (params, the reference's logical-axes tree), else params."""
    dev, dt = device_of(generator), cfg.pdtype
    params, axes = {}, {}
    params["embed"], axes["embed"] = init_embedding(
        generator, cfg.vocab, cfg.d_model, dtype=dt, with_axes=True)
    dense = lambda g: _init_dense_block(cfg, g)  # noqa: E731
    mamba = lambda g: _init_mamba_block(cfg, g)  # noqa: E731
    bp, ba = {}, {}
    if cfg.family in ("dense", "vlm", "audio"):
        bp["layers"], ba["layers"] = _stack_init(dense, generator,
                                                 cfg.n_layers)
    elif cfg.family == "moe":
        kd = cfg.moe.first_k_dense
        if kd:
            bp["dense_layers"], ba["dense_layers"] = _stack_init(
                dense, generator, kd)
        bp["layers"], ba["layers"] = _stack_init(
            lambda g: _init_moe_block(cfg, g), generator, cfg.n_layers - kd)
    elif cfg.family == "ssm":
        bp["layers"], ba["layers"] = _stack_init(mamba, generator,
                                                 cfg.n_layers)
    elif cfg.family == "hybrid":
        bp["layers"], ba["layers"] = _stack_init(mamba, generator,
                                                 cfg.n_layers)
        bp["shared"], ba["shared"] = dense(generator)
    else:
        raise ValueError(cfg.family)
    params["blocks"], axes["blocks"] = bp, ba
    params["final_norm"], axes["final_norm"] = init_norm(
        cfg.norm, cfg.d_model, dtype=dt, device=dev, with_axes=True)
    if not cfg.tie_embeddings:
        params["lm_head"], axes["lm_head"] = dense_init(
            generator, (cfg.d_model, cfg.vocab), ("embed", "vocab"),
            dtype=dt)
    return (params, axes) if with_axes else params


def param_axes(cfg):
    """The reference's logical-axes tree of ``init_lm`` (no weights
    allocated)."""
    return init_lm(cfg, None, with_axes=True)[1]


def param_count(params) -> int:
    if isinstance(params, dict):
        return sum(param_count(v) for v in params.values())
    return params.numel()


# ---------------------------------------------------------------------------
# Forward (training / full-sequence)
# ---------------------------------------------------------------------------

def _embed(cfg, params, tokens, embeds):
    if embeds is not None:
        x = embeds.to(cfg.xdtype)
    else:
        x = embed_lookup(params["embed"], tokens).to(cfg.xdtype)
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=cfg.xdtype)
    return x


def forward(cfg, params, tokens=None, embeds=None, positions=None):
    """-> (hidden (B, S, d) after the final norm, aux: the MoE layers'
    summed load-balance loss, a 0-d tensor, 0 for the other families).
    Under rules with a mesh: run on the mesh (see the module's doc)."""
    lay = _layout()
    if lay is not None:
        ps = _laid_out(cfg, params, lay)
        hs, aux = forward_sharded(
            lay, cfg, ps, *_inputs(lay, tokens, embeds),
            positions=None if positions is None
            else lay.batch_blocks(positions))
        dev = (tokens if tokens is not None else embeds).device
        return lay.gather_batch(hs).to(dev), aux[0].to(dev)
    x = _embed(cfg, params, tokens, embeds)
    B, S = x.shape[:2]
    index_positions = positions is None
    if index_positions:
        positions = torch.arange(S, dtype=torch.int32,
                                 device=x.device).expand(B, S)
    aux = torch.zeros((), device=x.device)
    blocks = params["blocks"]
    block = _maybe_remat(cfg, lambda x, p_l, w: _block(
        cfg, p_l, x, lambda pa, h: attn_mod.attention(
            pa, cfg, h, positions, window=w,
            index_positions=index_positions)))
    if cfg.family in ATTN_FAMILIES:
        for p_l, w in zip(_attn_layers(cfg, blocks), cfg.layer_windows()):
            x, a = block(x, p_l, w)
            if a is not None:
                aux = aux + a
    elif cfg.family in ("ssm", "hybrid"):
        mamba = _maybe_remat(cfg, lambda x, p_l: _mamba_block(cfg, p_l, x))
        x = _mamba_stack(cfg, blocks, x, lambda i, p_l, x: mamba(x, p_l),
                         lambda g, x: block(x, blocks["shared"],
                                            GLOBAL_WINDOW)[0])
    else:
        raise ValueError(cfg.family)
    return apply_norm(cfg.norm, params["final_norm"], x), aux


def logits_from_hidden(cfg, params, h):
    if cfg.tie_embeddings:
        logits = embed_logits(params["embed"], h)
    else:
        logits = apply_dense(params["lm_head"], h)
    return softcap(logits.float(), cfg.final_softcap)


def chunked_ce(cfg, params, hidden, labels):
    """Mean next-token CE, computed in sequence chunks of
    ``cfg.loss_chunk`` so (B, S, vocab) logits are never materialized at
    once.  hidden: (B, S, d); labels: (B, S) (already shifted by the
    caller), negative labels ignored.  The reference's scan order: the
    chunks' sums added in order, then divided by max(count, 1).  Under
    rules with a mesh: vocab-parallel on the mesh."""
    lay = _layout()
    if lay is not None:
        ps = _laid_out(cfg, params, lay)
        ce = ce_sharded(lay, cfg, ps, lay.batch_blocks(hidden),
                        lay.batch_blocks(labels))
        return ce[0].to(hidden.device)
    B, S, d = hidden.shape
    c = min(cfg.loss_chunk, S)
    nc = -(-S // c)
    pad = nc * c - S
    if pad:
        hidden = torch.nn.functional.pad(hidden, (0, 0, 0, pad))
        labels = torch.nn.functional.pad(labels, (0, pad), value=-1)
    tot = torch.zeros((), device=hidden.device)
    cnt = torch.zeros((), device=hidden.device)
    for i in range(nc):
        h, lab = hidden[:, i * c:(i + 1) * c], labels[:, i * c:(i + 1) * c]
        logits = logits_from_hidden(cfg, params, h)          # (B, c, V) fp32
        lse = torch.logsumexp(logits, dim=-1)
        tgt = logits.gather(-1, lab.clamp_min(0).long()[..., None])[..., 0]
        valid = (lab >= 0).float()
        tot = tot + ((lse - tgt) * valid).sum()
        cnt = cnt + valid.sum()
    return tot / cnt.clamp_min(1.0)


def lm_loss(cfg, params, batch):
    """batch: {tokens|embeds, labels} -> (loss, metrics): the CE, plus
    ``aux_coef`` times the MoE auxiliary term for a MoE config; the
    metrics hold the CE, the auxiliary term and the final hidden
    states.  Under rules with a mesh: ``lm_loss_sharded`` on the params
    laid out, the hidden states gathered."""
    lay = _layout()
    if lay is not None:
        ps = _laid_out(cfg, params, lay)
        losses, m = lm_loss_sharded(
            lay, cfg, ps, {k: lay.batch_blocks(v) for k, v in batch.items()})
        dev = batch["labels"].device
        return losses[0].to(dev), {"ce": m["ce"][0].to(dev),
                                   "moe_aux": m["moe_aux"][0].to(dev),
                                   "hidden": lay.gather_batch(
                                       m["hidden"]).to(dev)}
    h, aux = forward(cfg, params, tokens=batch.get("tokens"),
                     embeds=batch.get("embeds"))
    ce = chunked_ce(cfg, params, h, batch["labels"])
    loss = ce
    if cfg.moe is not None:
        loss = loss + cfg.moe.aux_coef * aux
    return loss, {"ce": ce, "moe_aux": aux, "hidden": h}


# ---------------------------------------------------------------------------
# On a mesh
# ---------------------------------------------------------------------------

def _layout():
    """The installed rules' ``ShardLayout``, or None without rules or
    mesh."""
    rules = shd.current_rules()
    if rules is None or rules.mesh is None:
        return None
    return shd.ShardLayout(rules)


@lru_cache(maxsize=None)
def _cached_axes(cfg):
    return param_axes(cfg)


def param_shardings(cfg, lay):
    """Where each parameter's blocks live under ``lay``'s rules: a tree of
    ``NamedSharding``s (``param_sharding`` of ``param_axes(cfg)``), for
    every family; FSDP rules split params over 'data' too."""
    with shd.axis_rules(lay.rules):
        return shd.param_sharding(_cached_axes(cfg), lay.mesh)


_STACKS = ("layers", "dense_layers")


def _fsdp_plan(cfg, lay):
    """Where FSDP splits each parameter under ``lay``'s rules: for each
    leaf the ``(dim, axes)`` of its one dim split over mesh axes other
    than 'model' (the dim as the leaf is used: a stacked layer's without
    its leading 'layers'), else None -> a tree like the params, or None
    when no leaf is split so."""
    found = []

    def leaf(sh, stacked):
        spec = tuple(sh.spec)[1:] if stacked else tuple(sh.spec)
        for d, entry in enumerate(spec):
            axes = shd.entry_axes(entry)
            off = tuple(a for a in axes if a != "model")
            if off and math.prod(lay.mesh.shape[a] for a in off) > 1:
                if len(off) != len(axes):
                    raise NotImplementedError(f"a dim split over 'model' "
                                              f"and {off}: {sh.spec}")
                found.append(off)
                return (d, off)
        return None

    def walk(tree, stacked):
        if isinstance(tree, dict):
            return {k: walk(v, stacked or k in _STACKS)
                    for k, v in tree.items()}
        return leaf(tree, stacked)
    plan = {k: walk(v, False) for k, v in param_shardings(cfg, lay).items()}
    return plan if found else None


def _sub(plan, *keys):
    for k in keys:
        if plan is None:
            return None
        plan = plan.get(k)
    return plan


def _gather_fsdp(lay, plan, trees):
    """``trees`` one param subtree a shard, ``plan`` the matching subtree
    of ``_fsdp_plan`` -> the trees with every FSDP-split leaf gathered
    whole over its axes (``fsdp_gather_over``: the backward
    reduce-scatters)."""
    if plan is None:
        return trees
    if isinstance(plan, dict):
        sub = {k: _gather_fsdp(lay, plan[k], [t[k] for t in trees])
               for k in trees[0]}
        return [{k: sub[k][s] for k in sub} for s in range(len(trees))]
    dim, axes = plan
    return list(shd.fsdp_gather_over(trees, lay.mesh, axes, dim))


def _top(lay, plan, ps, names):
    """The top-level params ``names`` (those the model has) of each shard,
    gathered whole over the FSDP axes -> one dict a shard."""
    names = [n for n in names if n in ps[0]]
    got = {n: _gather_fsdp(lay, _sub(plan, n), [p[n] for p in ps])
           for n in names}
    return [{n: got[n][s] for n in names} for s in range(len(ps))]


def _first_leaf(tree):
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree


def _laid_out(cfg, params, lay):
    """Global params -> one tree of blocks a shard (views: gradients reach
    the global tree); params already laid out (``Placed`` leaves, as
    ``weights.lm_to_mesh`` lays them out under the same rules) -> their
    blocks."""
    if isinstance(_first_leaf(params), shd.Placed):
        return shd.local_trees(params, lay.local)
    placed = shd.place_tree(params, param_shardings(cfg, lay), copy=False)
    return shd.local_trees(placed, lay.local)


def _inputs(lay, tokens, embeds):
    return (None if tokens is None else lay.batch_blocks(tokens),
            None if embeds is None else lay.batch_blocks(embeds))


def _embed_sharded(lay, cfg, ps, tokens, embeds):
    """Each shard's rows of the embedded input: with 'vocab' over 'model'
    the shard looks up the tokens of its block of the table, zeros
    elsewhere, psum'd over 'model'.  ``ps[s]`` holds shard s's
    ``embed``, whole over the FSDP axes."""
    if embeds is not None:
        xs = [e.to(cfg.xdtype) for e in embeds]
    elif lay.split("vocab"):
        parts = []
        for p, tok, r in zip(ps, tokens, lay.rank):
            tbl = p["embed"]["table"]
            n = tbl.shape[0]
            local = tok.long() - r * n
            mine = (local >= 0) & (local < n)
            parts.append(tbl[local.clamp(0, n - 1)]
                         * mine[..., None].to(tbl.dtype))
        xs = [x.to(cfg.xdtype) for x in lay.psum_model(parts)]
    else:
        xs = [embed_lookup(p["embed"], tok).to(cfg.xdtype)
              for p, tok in zip(ps, tokens)]
    if cfg.embed_scale:
        xs = [x * torch.tensor(cfg.d_model ** 0.5, dtype=cfg.xdtype)
              for x in xs]
    return xs


def _block_sharded(lay, cfg, ps, xs, attend, starts=None):
    """``_block`` on a mesh (per-shard params, whole over the FSDP axes,
    and rows) with ``attend(p_attns, hs)`` its attention -> (rows, aux a
    shard or None).  With ``starts`` (a prompt's positions split over
    'data', ``xs[s]`` shard s's block from ``starts[s]`` on) the MoE layer
    takes the whole prompt, gathered over 'data' (the reference's
    ``moe_ep`` holds every position on each data shard: the same slots,
    drops and aux), and each shard keeps its block of the output."""
    hs = [apply_norm(cfg.norm, p["ln1"], x) for p, x in zip(ps, xs)]
    att = attend([p["attn"] for p in ps], hs)
    xs = [x + a for x, a in zip(xs, att)]
    hs = [apply_norm(cfg.norm, p["ln2"], x) for p, x in zip(ps, xs)]
    if "moe" not in ps[0]:
        ys = mlp_mod.apply_mlp_sharded(lay, [p["mlp"] for p in ps], hs,
                                       act=cfg.act)
        return [x + y for x, y in zip(xs, ys)], None
    whole = hs if starts is None else lay.all_gather_seq(hs, 1)
    ys, aux = moe_mod.apply_moe_sharded(lay, [p["moe"] for p in ps],
                                        cfg.moe, whole)
    if starts is not None:
        n = hs[0].shape[1]
        ys = [y[:, f:f + n] for y, f in zip(ys, starts)]
    for name in ("shared_mlp", "dense_mlp"):
        if name in ps[0]:
            zs = mlp_mod.apply_mlp_sharded(lay, [p[name] for p in ps], hs,
                                           act=cfg.act)
            ys = [y + z for y, z in zip(ys, zs)]
    return [x + y for x, y in zip(xs, ys)], aux


def _mamba_block_sharded(lay, cfg, ps, xs, mamba):
    """``_mamba_block`` on a mesh, ``mamba(p_mambas, hs)`` its SSM."""
    hs = [apply_norm(cfg.norm, p["ln"], x) for p, x in zip(ps, xs)]
    return [x + y for x, y in zip(xs, mamba([p["mamba"] for p in ps], hs))]


def _stack_sharded(cfg, ps, plan, xs, attend, mamba):
    """The decoder stack on a mesh: ``attend(c, window, p_ls, plan_l,
    xs) -> (xs, aux or None)`` runs attention layer (or shared-block use)
    c, ``mamba(i, p_ls, plan_l, xs) -> xs`` mamba layer i, ``p_ls`` one
    tree of the layer's blocks a shard and ``plan_l`` its FSDP plan ->
    (xs, the MoE layers' aux summed, a list, or None)."""
    pb = _sub(plan, "blocks")
    aux = None
    if cfg.family in ATTN_FAMILIES:
        kd = cfg.moe.first_k_dense if cfg.family == "moe" else 0
        per_shard = [_attn_layers(cfg, p["blocks"]) for p in ps]
        for c, w in enumerate(cfg.layer_windows()):
            xs, a = attend(c, w, [layers[c] for layers in per_shard],
                           _sub(pb, "dense_layers" if c < kd else "layers"),
                           xs)
            if a is not None:
                aux = a if aux is None else [x + y for x, y in zip(aux, a)]
        return xs, aux
    per = cfg.hybrid_period if cfg.family == "hybrid" else 0
    per_shard = [_layers(p["blocks"]["layers"], cfg.n_layers) for p in ps]
    for i in range(cfg.n_layers):
        xs = mamba(i, [layers[i] for layers in per_shard],
                   _sub(pb, "layers"), xs)
        if per and (i + 1) % per == 0:
            xs, _ = attend((i + 1) // per - 1, GLOBAL_WINDOW,
                           [p["blocks"]["shared"] for p in ps],
                           _sub(pb, "shared"), xs)
    return xs, aux


def forward_sharded(lay, cfg, ps, tokens=None, embeds=None, positions=None):
    """``forward`` on a mesh: ``ps[s]`` shard s's param blocks,
    ``tokens``/``embeds``/``positions`` its rows -> (hidden rows, whole
    over 'model'; aux), a list each.  FSDP blocks are gathered per layer,
    inside the layer's remat."""
    plan = _fsdp_plan(cfg, lay)
    xs = _embed_sharded(lay, cfg, _top(lay, plan, ps, ("embed",)), tokens,
                        embeds)
    index_positions = positions is None
    if index_positions:
        positions = [torch.arange(x.shape[1], dtype=torch.int32,
                                  device=x.device).expand(x.shape[:2])
                     for x in xs]
    block = _maybe_remat(cfg, lambda xs, p_ls, w, pl: _block_sharded(
        lay, cfg, _gather_fsdp(lay, pl, p_ls), xs,
        lambda pa, hs: attn_mod.attention_sharded(
            lay, pa, cfg, hs, positions, window=w,
            index_positions=index_positions)))
    mamba = _maybe_remat(cfg, lambda xs, p_ls, pl: _mamba_block_sharded(
        lay, cfg, _gather_fsdp(lay, pl, p_ls), xs,
        lambda pm, hs: ssm_mod.mamba_forward_sharded(lay, pm, cfg.ssm, hs)))
    xs, aux = _stack_sharded(
        cfg, ps, plan, xs,
        lambda c, w, p_ls, pl, xs: block(xs, p_ls, w, pl),
        lambda i, p_ls, pl, xs: mamba(xs, p_ls, pl))
    if aux is None:
        aux = [torch.zeros((), device=x.device) for x in xs]
    final = _top(lay, plan, ps, ("final_norm",))
    return [apply_norm(cfg.norm, f["final_norm"], x)
            for f, x in zip(final, xs)], aux


def ce_sharded(lay, cfg, ps, hidden, labels):
    """``chunked_ce`` on a mesh: ``hidden[s]``, ``labels[s]`` shard s's
    rows -> the global mean CE, one per shard.  With 'vocab' over 'model'
    each shard takes its block of the logits; the logsumexp is pmax'd
    (its max, a constant of the gradient) and psum'd over 'model', the
    target logit psum'd from the shard that holds it.  The chunks' sums
    and counts are psum'd over the data axes before the division."""
    split = lay.split("vocab")
    ps = _top(lay, _fsdp_plan(cfg, lay), ps, ("embed", "lm_head"))
    tots = []
    c = min(cfg.loss_chunk, hidden[0].shape[1])
    for h0, l0 in zip(hidden, labels):
        S = h0.shape[1]
        nc = -(-S // c)
        pad = nc * c - S
        if pad:
            h0 = torch.nn.functional.pad(h0, (0, 0, 0, pad))
            l0 = torch.nn.functional.pad(l0, (0, pad), value=-1)
        tots.append((h0, l0, nc))
    out_tot = [torch.zeros((), device=h.device) for h, _, _ in tots]
    out_cnt = [torch.zeros((), device=h.device) for h, _, _ in tots]
    for i in range(tots[0][2]):
        hs = [h[:, i * c:(i + 1) * c] for h, _, _ in tots]
        labs = [lab[:, i * c:(i + 1) * c] for _, lab, _ in tots]
        logits = [logits_from_hidden(cfg, p, h) for p, h in zip(ps, hs)]
        if split:
            m = lay.pmax_model([x.amax(-1).detach() for x in logits])
            se = lay.psum_model([torch.exp(x - mx[..., None]).sum(-1)
                                 for x, mx in zip(logits, m)])
            lse = [torch.log(a) + mx for a, mx in zip(se, m)]
            parts = []
            for x, lab, r in zip(logits, labs, lay.rank):
                n = x.shape[-1]
                local = lab.long() - r * n
                mine = (local >= 0) & (local < n)
                parts.append(x.gather(-1, local.clamp(0, n - 1)[..., None])
                             [..., 0] * mine.float())
            tgt = lay.psum_model(parts)
        else:
            lse = [torch.logsumexp(x, dim=-1) for x in logits]
            tgt = [x.gather(-1, lab.clamp_min(0).long()[..., None])[..., 0]
                   for x, lab in zip(logits, labs)]
        for s, lab in enumerate(labs):
            valid = (lab >= 0).float()
            out_tot[s] = out_tot[s] + ((lse[s] - tgt[s]) * valid).sum()
            out_cnt[s] = out_cnt[s] + valid.sum()
    tot, cnt = lay.psum_batch(out_tot), lay.psum_batch(out_cnt)
    return [t / n.clamp_min(1.0) for t, n in zip(tot, cnt)]


def lm_loss_sharded(lay, cfg, ps, batch):
    """``lm_loss`` on a mesh: ``batch`` maps each key to its rows a
    shard -> (the loss a shard, metrics: ``ce`` and ``moe_aux`` a shard,
    ``hidden`` each shard's rows)."""
    h, aux = forward_sharded(lay, cfg, ps, tokens=batch.get("tokens"),
                             embeds=batch.get("embeds"))
    ce = ce_sharded(lay, cfg, ps, h, batch["labels"])
    loss = ce
    if cfg.moe is not None:
        loss = [c + cfg.moe.aux_coef * a for c, a in zip(ce, aux)]
    return loss, {"ce": ce, "moe_aux": aux, "hidden": h}


# ---------------------------------------------------------------------------
# Decode state / prefill / decode
# ---------------------------------------------------------------------------

def init_decode_state(cfg, batch, max_len, dtype=None, device=None):
    """Zeros: ``index`` (0-d int32), and by family the KV caches ``k``,
    ``v`` (layers, B, KV, max_len, hd) (a hybrid: one per use of its shared
    block) and the SSM states ``ssm`` (layers, B, H, P, N) and ``conv``
    (layers, B, W-1, H, P).  ``dtype`` defaults to ``cfg.xdtype``."""
    dt = dtype or cfg.xdtype
    z = lambda *shape: torch.zeros(shape, dtype=dt, device=device)  # noqa
    st = {"index": torch.zeros((), dtype=torch.int32, device=device)}
    L, B = cfg.n_layers, batch
    if cfg.family in ("ssm", "hybrid"):
        s = cfg.ssm
        st["ssm"] = z(L, B, s.n_heads, s.head_dim, s.d_state)
        st["conv"] = z(L, B, s.conv_width - 1, s.n_heads, s.head_dim)
    if cfg.family in ATTN_FAMILIES or cfg.family == "hybrid":
        n = _hybrid_layout(cfg)[0] if cfg.family == "hybrid" else L
        st["k"] = z(n, B, cfg.n_kv_heads, max_len, cfg.head_dim)
        st["v"] = torch.zeros_like(st["k"])
    return st


def decode_state_specs(cfg, batch, max_len, *, kind="act"):
    """Logical axes of the decode state (for shardings), as the
    reference's."""
    ax = {"index": ()}
    if cfg.family in ATTN_FAMILIES:
        ax["k"] = ("layers", "batch", "kv_heads", "kv_seq", "head_dim")
        ax["v"] = ax["k"]
    elif cfg.family in ("ssm", "hybrid"):
        ax["ssm"] = ("layers", "batch", "ssm_heads", "head_dim", "ssm_state")
        ax["conv"] = ("layers", "batch", "conv", "ssm_heads", "head_dim")
        if cfg.family == "hybrid":
            ax["k"] = ("layers", "batch", "kv_heads", "kv_seq", "head_dim")
            ax["v"] = ax["k"]
    return ax


def decode_state_sharding(cfg, rules):
    """Where a decode state's blocks live under ``rules`` (with a mesh):
    ``decode_state_specs`` by the act rules, as the reference lays its
    state out -> a dict of ``NamedSharding``s."""
    return {k: shd.NamedSharding(rules.mesh, rules.spec(a, kind="act"))
            for k, a in decode_state_specs(cfg, None, None).items()}


def init_decode_state_sharded(lay, cfg, batch, max_len, dtype=None):
    """``init_decode_state`` on ``lay``'s mesh: zeros allocated a block a
    shard (no whole copy), laid out by ``decode_state_sharding`` -> a dict
    of ``Placed``; ``index`` one 0-d int32 copy a shard."""
    whole = init_decode_state(cfg, batch, max_len, dtype, device="meta")
    out = {}
    for k, sh in decode_state_sharding(cfg, lay.rules).items():
        t = whole[k]
        slices = sh.slices(t.shape)
        out[k] = shd.Placed.from_local(
            [torch.zeros(t[slices[i]].shape, dtype=t.dtype,
                         device=sh.devices[i]) for i in lay.local],
            sh, t.shape)
    return out


def _kv_offsets(lay, state):
    """Each local shard's first cache position (its ``kv_seq`` block's
    start), or None for a state without a cache."""
    if "k" not in state:
        return None
    k = state["k"]
    slices = k.sharding.slices(k.shape)
    return [slices[i][3].start for i in lay.local]


def _gather_logits(lay, cfg, blocks):
    """Each local shard's (B_l, vocab block) logits -> the global (B,
    vocab) on the first local shard's device: across processes gathered
    from every process, so every process returns the same logits (the
    reference's replicated output)."""
    B = blocks[0].shape[0] * (lay.n // lay.M if lay.batch_split else 1)
    spec = shd.P(lay.rules.act_rules.get("batch"),
                 "model" if lay.split("vocab") else None)
    return shd.Placed.from_local(blocks, shd.NamedSharding(lay.mesh, spec),
                                 (B, cfg.vocab)).gather()


def _last_logits(lay, cfg, ps, plan, xs):
    final = _top(lay, plan, ps, ("final_norm", "embed", "lm_head"))
    return [logits_from_hidden(cfg, f, apply_norm(
        cfg.norm, f["final_norm"], x[:, -1:]))[:, 0]
        for f, x in zip(final, xs)]


def prefill_sharded(lay, cfg, ps, state, tokens=None, embeds=None):
    """``prefill`` on a mesh into ``state`` (``init_decode_state_sharded``'s
    or one carried by ``weights.decode_state_to_mesh``), in place:
    ``ps[s]`` shard s's param blocks, ``tokens``/``embeds`` its rows
    -> each shard's last-token logits (B_l, its vocab block).

    Where the rules split ``seq`` (batch 1 outside training: over 'data',
    the reference's layout) and the data shards divide the prompt's S,
    each data shard embeds, normalises and projects only its block of S /
    D positions (``ShardLayout.seq_starts``), and runs the MLP and SSM on
    it (``ssm.mamba_forward_sharded``: the blocks pass states);
    attention takes q from the block against k and v gathered over 'data'
    (``attention.attention_prefill_sharded``), an MoE layer the gathered
    prompt (``_block_sharded``).  The last position's hidden row is
    gathered from the last block, so every shard returns the same logits.
    Where D does not divide S, every data shard runs the whole prompt:
    the same function.  Each shard keeps its block of the cache's
    positions either way."""
    plan = _fsdp_plan(cfg, lay)
    S = (tokens if tokens is not None else embeds)[0].shape[1]
    starts = lay.seq_starts(S)
    if starts is not None:
        n = S // lay.seq_shards
        tokens, embeds = (None if t is None else
                          [x[:, f:f + n] for x, f in zip(t, starts)]
                          for t in (tokens, embeds))
    xs = _embed_sharded(lay, cfg, _top(lay, plan, ps, ("embed",)), tokens,
                        embeds)
    sts = shd.local_trees(state, lay.local)
    offs = _kv_offsets(lay, state)
    for st in sts:
        st["index"].fill_(S)

    def attend(c, w, p_ls, pl, xs):
        caches = [attn_mod.KVCache(st["k"][c], st["v"][c]) for st in sts]
        return _block_sharded(
            lay, cfg, _gather_fsdp(lay, pl, p_ls), xs,
            lambda pa, hs: attn_mod.attention_prefill_sharded(
                lay, pa, cfg, hs, caches, offs, window=w, starts=starts),
            starts)

    def mamba(i, p_ls, pl, xs):
        def ssm(pm, hs):
            ys, states = ssm_mod.mamba_forward_sharded(
                lay, pm, cfg.ssm, hs, return_state=True, starts=starts)
            for st, new in zip(sts, states):
                st["ssm"][i].copy_(new.ssm)
                st["conv"][i].copy_(new.conv)
            return ys
        return _mamba_block_sharded(lay, cfg, _gather_fsdp(lay, pl, p_ls),
                                    xs, ssm)

    xs, _ = _stack_sharded(cfg, ps, plan, xs, attend, mamba)
    if starts is not None:
        xs = lay.all_gather_seq([x[:, -1:] for x in xs], 1)
    return _last_logits(lay, cfg, ps, plan, xs)


def decode_step_sharded(lay, cfg, ps, state, tokens):
    """``decode_step`` on a mesh: ``state`` a dict of ``Placed`` (as
    ``prefill_sharded`` fills it), updated in place, ``tokens[s]`` shard
    s's rows (B_l,) -> each shard's logits (B_l, its vocab block).  Each
    shard reads and advances its own copy of ``index``, on the device."""
    plan = _fsdp_plan(cfg, lay)
    xs = _embed_sharded(lay, cfg, _top(lay, plan, ps, ("embed",)),
                        [t[:, None] for t in tokens], None)
    sts = shd.local_trees(state, lay.local)
    offs = _kv_offsets(lay, state)
    idxs = [st["index"] for st in sts]
    max_len = state["k"].shape[3] if "k" in state else None

    def attend(c, w, p_ls, pl, xs):
        caches = [attn_mod.KVCache(st["k"][c], st["v"][c]) for st in sts]
        return _block_sharded(
            lay, cfg, _gather_fsdp(lay, pl, p_ls), xs,
            lambda pa, hs: attn_mod.attention_decode_sharded(
                lay, pa, cfg, hs, caches, offs, idxs, max_len, window=w))

    def mamba(i, p_ls, pl, xs):
        return _mamba_block_sharded(
            lay, cfg, _gather_fsdp(lay, pl, p_ls), xs,
            lambda pm, hs: ssm_mod.mamba_decode_sharded(
                lay, pm, cfg.ssm, hs,
                [ssm_mod.SSMState(st["ssm"][i], st["conv"][i])
                 for st in sts]))

    xs, _ = _stack_sharded(cfg, ps, plan, xs, attend, mamba)
    logits = _last_logits(lay, cfg, ps, plan, xs)
    for i in idxs:
        i.add_(1)
    return logits


def prefill(cfg, params, tokens=None, embeds=None, max_len=None):
    """Full-sequence prefill of a prompt (tokens (B, S) or embeds (B, S,
    d)) -> (decode_state for up to ``max_len`` (default S) positions with
    ``index`` = S, the last token's logits (B, vocab) float32).  A prompt
    longer than ``max_len`` raises ``ValueError``.  On the card every
    attention layer that ``attention.uses_kernel`` admits takes the flash
    kernel.  Under rules with a mesh: ``prefill_sharded``, the state a
    dict of ``Placed`` (``decode_state_sharding``), the logits gathered."""
    x0 = tokens if tokens is not None else embeds
    B, S = x0.shape[:2]
    max_len = max_len or S
    if S > max_len:
        raise ValueError(f"a prompt of {S} tokens exceeds max_len {max_len}")
    lay = _layout()
    if lay is not None:
        st = init_decode_state_sharded(lay, cfg, B, max_len)
        logits = prefill_sharded(lay, cfg, _laid_out(cfg, params, lay), st,
                                 *_inputs(lay, tokens, embeds))
        return st, _gather_logits(lay, cfg, logits).to(x0.device)
    x = _embed(cfg, params, tokens, embeds)
    st = init_decode_state(cfg, B, max_len, device=x.device)
    st["index"].fill_(S)

    def attend(c, window):
        cache = attn_mod.KVCache(st["k"][c], st["v"][c])
        return lambda pa, h: attn_mod.attention_prefill(
            pa, cfg, h, cache, window=window)[0]

    def mamba(i, p_l, x):
        h, s = ssm_mod.mamba_forward(
            p_l["mamba"], cfg.ssm, apply_norm(cfg.norm, p_l["ln"], x),
            return_state=True)
        st["ssm"][i].copy_(s.ssm)
        st["conv"][i].copy_(s.conv)
        return x + h

    x = _cached_stack(cfg, params["blocks"], x, attend, mamba)
    x_last = apply_norm(cfg.norm, params["final_norm"], x[:, -1:])
    return st, logits_from_hidden(cfg, params, x_last)[:, 0]


def decode_step(cfg, params, state, tokens):
    """One decode step.  tokens: (B,) on the state's device -> (logits
    (B, vocab) float32, state).  The state passed in is updated in place:
    the new k and v (at ``index``, clamped to ``max_len - 1``), SSM and
    conv states, and ``index`` + 1.  No value is read on the host.  Under
    rules with a mesh the state is a dict of ``Placed`` (``prefill``'s, or
    ``weights.decode_state_to_mesh``'s): ``decode_step_sharded``, the
    logits gathered."""
    lay = _layout()
    if lay is not None:
        if not isinstance(state["index"], shd.Placed):
            raise TypeError("under rules with a mesh the decode state is "
                            "laid out on it (weights.decode_state_to_mesh)")
        logits = decode_step_sharded(lay, cfg, _laid_out(cfg, params, lay),
                                     state, lay.batch_blocks(tokens))
        return _gather_logits(lay, cfg, logits).to(tokens.device), state
    x = _embed(cfg, params, tokens[:, None], None)
    idx = state["index"]

    def attend(c, window):
        cache = attn_mod.KVCache(state["k"][c], state["v"][c])
        return lambda pa, h: attn_mod.attention_decode(
            pa, cfg, h, cache, idx, window=window)[0]

    def mamba(i, p_l, x):
        h, _ = ssm_mod.mamba_decode(
            p_l["mamba"], cfg.ssm, apply_norm(cfg.norm, p_l["ln"], x),
            ssm_mod.SSMState(state["ssm"][i], state["conv"][i]))
        return x + h

    x = _cached_stack(cfg, params["blocks"], x, attend, mamba)
    x = apply_norm(cfg.norm, params["final_norm"], x)
    logits = logits_from_hidden(cfg, params, x)[:, 0]
    idx.add_(1)
    return logits, state
