"""LM assembly, the dense family: [norm -> attn, norm -> ffn] x L over
layers stacked on a leading axis, and the chunked cross-entropy loss.

Port of ``repro.models.lm`` for ``family`` in ("dense", "vlm", "audio"):
``init_lm``, ``param_count``, ``forward`` (a Python loop over the stacked
layers), ``logits_from_hidden``, ``chunked_ce`` and ``lm_loss``.  The MoE,
SSM and hybrid families and prefill/decode wait (ROADMAP §1).

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

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as attn_mod
from repro_torch.models import mlp as mlp_mod
from repro_torch.models.common import (apply_dense, apply_norm, dense_init,
                                       device_of, embed_logits, embed_lookup,
                                       init_embedding, init_norm, softcap)

DENSE_FAMILIES = ("dense", "vlm", "audio")


def _check_family(cfg):
    if cfg.family in ("moe", "ssm", "hybrid"):
        raise NotImplementedError(
            f"the port has the dense LM family only; {cfg.family!r} is still "
            "to port (ROADMAP §1)")
    if cfg.family not in DENSE_FAMILIES:
        raise ValueError(cfg.family)


def _stack(trees):
    """Dicts of tensors with one structure -> one dict of stacked
    tensors (a leading 'layers' axis)."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _stack_init(fn, generator, n):
    """n layers drawn one after the other from ``generator``, stacked."""
    return _stack([fn(generator) for _ in range(n)])


def _layers(tree, n):
    """The n layers of a stacked params dict, as a list of dicts of views
    (``unbind``: under autograd the stacked gradient is assembled once,
    not added up from n full-size ones)."""
    if isinstance(tree, dict):
        per_key = {k: _layers(v, n) for k, v in tree.items()}
        return [{k: v[i] for k, v in per_key.items()} for i in range(n)]
    return tree.unbind(0)


def _init_dense_block(cfg, generator):
    dev, dt = device_of(generator), cfg.pdtype
    return {
        "ln1": init_norm(cfg.norm, cfg.d_model, dtype=dt, device=dev),
        "attn": attn_mod.init_attention(generator, cfg, dtype=dt),
        "ln2": init_norm(cfg.norm, cfg.d_model, dtype=dt, device=dev),
        "mlp": mlp_mod.init_mlp(generator, cfg.d_model, cfg.d_ff,
                                gated=cfg.gated_mlp, dtype=dt),
    }


def _dense_block(cfg, p, x, positions, window, index_positions=False):
    h = apply_norm(cfg.norm, p["ln1"], x)
    x = x + attn_mod.attention(p["attn"], cfg, h, positions, window=window,
                               index_positions=index_positions)
    h = apply_norm(cfg.norm, p["ln2"], x)
    return x + mlp_mod.apply_mlp(p["mlp"], h, act=cfg.act)


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


def init_lm(cfg, generator):
    """Random weights drawn from ``generator`` on its device (``None``:
    shapes only, on the ``meta`` device).  Same shapes and scales as the
    reference's ``init_lm``; the draws differ."""
    _check_family(cfg)
    dev, dt = device_of(generator), cfg.pdtype
    params = {"embed": init_embedding(generator, cfg.vocab, cfg.d_model,
                                      dtype=dt)}
    params["blocks"] = {"layers": _stack_init(
        lambda g: _init_dense_block(cfg, g), generator, cfg.n_layers)}
    params["final_norm"] = init_norm(cfg.norm, cfg.d_model, dtype=dt,
                                     device=dev)
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(generator, (cfg.d_model, cfg.vocab),
                                       dtype=dt)
    return params


def param_count(params) -> int:
    if isinstance(params, dict):
        return sum(param_count(v) for v in params.values())
    return params.numel()


def forward(cfg, params, tokens=None, embeds=None, positions=None):
    """-> (hidden (B, S, d) after the final norm, aux 0.0)."""
    _check_family(cfg)
    if embeds is not None:
        x = embeds.to(cfg.xdtype)
    else:
        x = embed_lookup(params["embed"], tokens).to(cfg.xdtype)
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=cfg.xdtype)
    B, S = x.shape[:2]
    index_positions = positions is None
    if index_positions:
        positions = torch.arange(S, dtype=torch.int32,
                                 device=x.device).expand(B, S)
    windows = cfg.layer_windows()
    layers = _layers(params["blocks"]["layers"], len(windows))
    body = _maybe_remat(cfg, lambda x, p_l, w: _dense_block(
        cfg, p_l, x, positions, w, index_positions))
    for p_l, window in zip(layers, windows):
        x = body(x, p_l, window)
    return apply_norm(cfg.norm, params["final_norm"], x), 0.0


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
    chunks' sums added in order, then divided by max(count, 1)."""
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
    """batch: {tokens|embeds, labels} -> (loss, metrics); the metrics hold
    the CE, the (zero) MoE auxiliary term and the final hidden states."""
    h, aux = forward(cfg, params, tokens=batch.get("tokens"),
                     embeds=batch.get("embeds"))
    ce = chunked_ce(cfg, params, h, batch["labels"])
    return ce, {"ce": ce, "moe_aux": torch.zeros((), device=h.device),
                "hidden": h}
