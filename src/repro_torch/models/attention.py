"""Grouped-query attention with qk-norm, biases, soft-capping and sliding
windows, full-sequence: the reference's dense and chunked online-softmax
paths, and the hand-written flash-attention kernel on the card.

Port of ``repro.models.attention`` (``KVCache``, ``attention_decode`` and
``attention_prefill`` wait: ROADMAP).  Shapes follow (batch, seq, heads,
head_dim); KV heads may be fewer than Q heads (GQA), Q heads grouped as
(kv_heads, q_per_kv).

On a CUDA tensor, ``attention`` sends a layer to the hand-written
flash-attention kernels through their differentiable entry
``kernels.flash_attention.flash_attention`` (the forward kernel, and the
dq and dk/dv kernels under autograd) when the configuration allows it
(``uses_kernel``: no score soft-cap, a window that masks nothing at this
length (``None`` or >= S, as the 'global' sentinel ``1 << 30`` is), a
head dim the kernel supports and float32 activations) and the caller
says the positions are the index, ``arange(S)`` on every row
(``index_positions=True``, which ``lm.forward`` passes when it built the
positions itself).  The kernel masks by index; the reference masks by
position, so any other positions (packed sequences that restart, say)
take the plain path, and the flag is taken on trust rather than read
from the tensor, which would sync the host.  Otherwise, and on the CPU,
``attention`` takes ``_attend_dense`` / ``_attend_chunked`` exactly as the
reference does.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.models.common import (apply_dense, apply_rmsnorm, apply_rope,
                                       dense_init, device_of, softcap)

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def init_attention(generator, cfg, *, dtype=torch.float32):
    """cfg needs: d_model, n_heads, n_kv_heads, head_dim, qk_norm,
    qkv_bias."""
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    params = {
        "wq": dense_init(generator, (d, h, hd), dtype=dtype,
                         bias=cfg.qkv_bias),
        "wk": dense_init(generator, (d, kv, hd), dtype=dtype,
                         bias=cfg.qkv_bias),
        "wv": dense_init(generator, (d, kv, hd), dtype=dtype,
                         bias=cfg.qkv_bias),
        "wo": dense_init(generator, (h, hd, d), dtype=dtype,
                         scale=1.0 / math.sqrt(h * hd)),
    }
    if cfg.qk_norm:
        dev = device_of(generator)
        params["q_norm"] = {"scale": torch.zeros(hd, dtype=dtype, device=dev)}
        params["k_norm"] = {"scale": torch.zeros(hd, dtype=dtype, device=dev)}
    return params


def _project_qkv(p, cfg, x, positions):
    q = apply_dense(p["wq"], x)            # (B, S, H, hd)
    k = apply_dense(p["wk"], x)            # (B, S, KV, hd)
    v = apply_dense(p["wv"], x)
    if cfg.qk_norm:
        q = apply_rmsnorm(p["q_norm"], q)
        k = apply_rmsnorm(p["k_norm"], k)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _scale(cfg):
    return (cfg.attn_scale if cfg.attn_scale is not None
            else 1.0 / math.sqrt(cfg.head_dim))


def _mask_bias(q_pos, k_pos, window):
    """(Q, K) additive mask: causal + optional sliding window."""
    keep = q_pos[:, None] >= k_pos[None, :]
    if window is not None:
        keep &= (q_pos[:, None] - k_pos[None, :]) < window
    return torch.where(keep, 0.0, NEG_INF)


def _attend_dense(cfg, q, k, v, q_pos, k_pos, window):
    """Reference einsum attention. q: (B,Sq,H,hd) k/v: (B,Sk,KV,hd)."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    qg = q.reshape(B, Sq, KV, G, hd)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg.float(),
                          k.float()) * _scale(cfg)
    scores = softcap(scores, cfg.attn_softcap)
    scores = scores + _mask_bias(q_pos, k_pos, window)[None, None, None]
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v.float())
    return out.reshape(B, Sq, H, hd).to(q.dtype)


def _attend_chunked(cfg, q, k, v, q_pos, k_pos, window, chunk):
    """Online softmax over KV chunks, the full (Sq, Sk) score matrix never
    materialized: q scaled before the product, k/v repeated to H heads,
    padded keys at position ``1 << 30`` so the causal mask drops them."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    Sk = k.shape[1]
    n_chunks = -(-Sk // chunk)
    pad = n_chunks * chunk - Sk
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        k_pos = torch.nn.functional.pad(k_pos, (0, pad), value=1 << 30)
    dt = q.dtype
    qh = q * torch.tensor(_scale(cfg), dtype=dt)          # (B, Sq, H, hd)
    k = k.repeat_interleave(G, dim=2)
    v = v.repeat_interleave(G, dim=2)
    m = torch.full((B, H, Sq), NEG_INF, device=q.device)
    l = torch.zeros(B, H, Sq, device=q.device)
    acc = torch.zeros(B, H, Sq, hd, device=q.device)
    for c in range(n_chunks):
        sl = slice(c * chunk, (c + 1) * chunk)
        s = torch.einsum("bqhd,bshd->bhqs", qh.float(), k[:, sl].float())
        s = softcap(s, cfg.attn_softcap)
        s = s + _mask_bias(q_pos, k_pos[sl], window)[None, None]
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhqs,bshd->bhqd", p.to(dt).float(), v[:, sl].float())
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)                # (B, Sq, H, hd)


def uses_kernel(cfg, window, S) -> bool:
    """The configuration rule that sends a full-sequence layer of length S
    to the flash-attention kernel on the card."""
    return (cfg.attn_softcap is None
            and (window is None or window >= S)
            and cfg.head_dim in fa.HEAD_DIMS
            and cfg.xdtype == torch.float32)


def _attend_kernel(cfg, q, k, v):
    """The kernels on (B, H, S, hd) copies of q, k, v -> (B, S, H, hd),
    differentiable in q, k and v."""
    o = fa.flash_attention(q.transpose(1, 2).contiguous(),
                           k.transpose(1, 2).contiguous(),
                           v.transpose(1, 2).contiguous(),
                           True, _scale(cfg))
    return o.transpose(1, 2)


def attention(p, cfg, x, positions, *, window=None, index_positions=False):
    """Full-sequence (training / prefill) attention.  ``index_positions``:
    the caller vouches that ``positions`` is ``arange(S)`` on every row,
    which lets the card take the flash kernels."""
    q, k, v = _project_qkv(p, cfg, x, positions)
    S = x.shape[1]
    pos1 = positions[0] if positions.ndim > 1 else positions
    if index_positions and x.is_cuda and uses_kernel(cfg, window, S):
        out = _attend_kernel(cfg, q, k, v)
    elif cfg.attn_chunk and S > cfg.attn_chunk:
        out = _attend_chunked(cfg, q, k, v, pos1, pos1, window, cfg.attn_chunk)
    else:
        out = _attend_dense(cfg, q, k, v, pos1, pos1, window)
    return apply_dense(p["wo"], out, contract=2)
