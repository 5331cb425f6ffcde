"""LM assembly, the dense family: [norm -> attn, norm -> ffn] x L over
layers stacked on a leading axis.

Port of ``repro.models.lm`` for ``family`` in ("dense", "vlm", "audio"):
``init_lm``, ``param_count``, ``forward`` (a Python loop over the stacked
layers; ``remat`` is a training concern and is ignored) and
``logits_from_hidden``.  The MoE, SSM and hybrid families, the chunked CE
loss and prefill/decode wait (ROADMAP §1).
"""
from __future__ import annotations

import torch

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


def _layer(tree, i):
    """Layer i of a stacked params dict (views, no copies)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _init_dense_block(cfg, generator):
    dev, dt = device_of(generator), cfg.pdtype
    return {
        "ln1": init_norm(cfg.norm, cfg.d_model, dtype=dt, device=dev),
        "attn": attn_mod.init_attention(generator, cfg, dtype=dt),
        "ln2": init_norm(cfg.norm, cfg.d_model, dtype=dt, device=dev),
        "mlp": mlp_mod.init_mlp(generator, cfg.d_model, cfg.d_ff,
                                gated=cfg.gated_mlp, dtype=dt),
    }


def _dense_block(cfg, p, x, positions, window):
    h = apply_norm(cfg.norm, p["ln1"], x)
    x = x + attn_mod.attention(p["attn"], cfg, h, positions, window=window)
    h = apply_norm(cfg.norm, p["ln2"], x)
    return x + mlp_mod.apply_mlp(p["mlp"], h, act=cfg.act)


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
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32,
                                 device=x.device).expand(B, S)
    layers = params["blocks"]["layers"]
    for i, window in enumerate(cfg.layer_windows()):
        x = _dense_block(cfg, _layer(layers, i), x, positions, window)
    return apply_norm(cfg.norm, params["final_norm"], x), 0.0


def logits_from_hidden(cfg, params, h):
    if cfg.tie_embeddings:
        logits = embed_logits(params["embed"], h)
    else:
        logits = apply_dense(params["lm_head"], h)
    return softcap(logits.float(), cfg.final_softcap)
