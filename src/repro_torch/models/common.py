"""Shared building blocks of the LM stack: dense layers, norms, RoPE,
embeddings.

Port of ``repro.models.common``.  Everything is functional: an ``init_*``
returns a nested dict of tensors mirroring the reference's pytree (the
reference's logical-axes tree drives its sharding; the port is single
device and has none).  Random draws come from a ``torch.Generator`` and
land on its device; ``generator=None`` gives tensors on the ``meta``
device, which have shapes and no data (``lm.param_count`` at full width
without allocating).  The draws differ from ``jax.random``'s, so parity
goes through weight conversion (``repro_torch.weights``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def device_of(generator) -> torch.device:
    """Where an init puts its tensors: the generator's device, or ``meta``
    when there is no generator."""
    return torch.device("meta") if generator is None else generator.device


def truncated_normal(generator, shape, scale, dtype):
    """``scale`` times a standard normal truncated to [-2, 2], drawn in
    float32 and cast to ``dtype``."""
    w = torch.empty(shape, dtype=torch.float32, device=device_of(generator))
    if generator is not None:
        torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0,
                                    generator=generator)
    return (scale * w).to(dtype)


def dense_init(generator, shape, *, dtype=torch.float32, scale=None,
               bias=False):
    """A (possibly fused) linear weight; fan-in is the first dim unless
    ``scale`` is given.  The bias, when asked for, spans ``shape[1:]``."""
    if scale is None:
        scale = 1.0 / math.sqrt(shape[0])
    params = {"w": truncated_normal(generator, shape, scale, dtype)}
    if bias:
        params["b"] = torch.zeros(shape[1:], dtype=dtype,
                                  device=device_of(generator))
    return params


def apply_dense(p, x, contract=1):
    """x @ w over the last ``contract`` dims of x and the first
    ``contract`` of w."""
    w = p["w"].to(x.dtype)
    y = torch.tensordot(x, w, dims=(list(range(x.ndim - contract, x.ndim)),
                                    list(range(contract))))
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def init_rmsnorm(dim, *, dtype=torch.float32, device=None):
    return {"scale": torch.zeros(dim, dtype=dtype, device=device)}


def apply_rmsnorm(p, x, *, eps=1e-6):
    dt = x.dtype
    x = x.float()
    var = x.square().mean(-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    # gemma-style (1 + w): zero-init scale == identity.
    return (y * (1.0 + p["scale"].float())).to(dt)


def init_layernorm(dim, *, dtype=torch.float32, device=None):
    return {"scale": torch.ones(dim, dtype=dtype, device=device),
            "bias": torch.zeros(dim, dtype=dtype, device=device)}


def apply_layernorm(p, x, *, eps=1e-5):
    dt = x.dtype
    x = x.float()
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"].float() + p["bias"].float()).to(dt)


def init_norm(kind, dim, *, dtype=torch.float32, device=None):
    if kind == "layernorm":
        return init_layernorm(dim, dtype=dtype, device=device)
    return init_rmsnorm(dim, dtype=dtype, device=device)


def apply_norm(kind, p, x):
    if kind == "layernorm":
        return apply_layernorm(p, x)
    return apply_rmsnorm(p, x)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def rope_freqs(head_dim, theta, device=None):
    """1 / theta^(2i / hd) in float32, in the reference's order: the
    float32 exponent, then the power rounded once to float32 (taken in
    float64: torch's float32 ``pow`` is an ulp off XLA's at hd = 128, and
    an ulp of frequency shows in the angle at position 1,000), then the
    reciprocal."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent.double()).float()  # (head_dim/2,)


def apply_rope(x, positions, theta):
    """x: (..., seq, heads, head_dim); positions: (..., seq) int."""
    freqs = rope_freqs(x.shape[-1], theta, device=x.device)
    angles = positions[..., None].float() * freqs     # (..., seq, hd/2)
    cos = torch.cos(angles)[..., None, :]             # (..., seq, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Embedding
# ---------------------------------------------------------------------------

def init_embedding(generator, vocab, dim, *, dtype=torch.float32,
                   scale=None):
    scale = scale if scale is not None else 1.0
    return {"table": truncated_normal(generator, (vocab, dim), scale, dtype)}


def embed_lookup(p, tokens):
    return p["table"][tokens.long()]


def embed_logits(p, x):
    """Tied read-out: x @ table.T -> (..., vocab)."""
    return torch.einsum("...d,vd->...v", x, p["table"].to(x.dtype))


def softcap(x, cap):
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


def activation(name):
    if name == "silu":
        return F.silu
    if name == "gelu":
        return lambda x: F.gelu(x, approximate="tanh")
    if name == "relu2":  # squared ReLU (Primer / nemotron-4)
        return lambda x: F.relu(x).square()
    if name == "relu":
        return F.relu
    raise ValueError(f"unknown activation {name}")
