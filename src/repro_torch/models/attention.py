"""Grouped-query attention with qk-norm, biases, soft-capping and sliding
windows: full-sequence (the reference's dense and chunked online-softmax
paths, and the hand-written flash-attention kernel on the card), prefill
into a KV cache, and one-token decode over it.

Port of ``repro.models.attention``.  Shapes follow (batch, seq, heads,
head_dim); KV heads may be fewer than Q heads (GQA), Q heads grouped as
(kv_heads, q_per_kv).  The cache is (batch, kv_heads, max_len, head_dim).

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
reference does.  ``attention_prefill`` takes the same route; it builds
the positions ``arange(S)`` itself, so its prompt may take the kernel.

``attention_decode`` is the reference's masked einsum over the whole
``max_len`` cache in plain torch ops, on every device: the kernel's
causal mask is top-left aligned (row i sees keys j <= i), so one query
row over the cache would see key 0 alone.  It writes the new k and v into
the cache in place (``index_copy_`` at the index, clamped to ``max_len -
1`` as ``dynamic_update_slice`` clamps its start) and reads the index on
the device only: a step copies no cache and waits for nothing.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.models.common import (apply_dense, apply_rmsnorm, apply_rope,
                                       dense_init, device_of, softcap)

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def init_attention(generator, cfg, *, dtype=torch.float32, with_axes=False):
    """cfg needs: d_model, n_heads, n_kv_heads, head_dim, qk_norm,
    qkv_bias.  The logical axes are the reference's: ``q_in``/``kv_in``
    (the contraction, split over 'model' by the row-parallel fallback),
    ``heads``/``kv_heads`` (column-parallel), ``o_hd``."""
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    params, axes = {}, {}
    params["wq"], axes["wq"] = dense_init(
        generator, (d, h, hd), ("q_in", "heads", "q_hd"), dtype=dtype,
        bias=cfg.qkv_bias, bias_axes=("heads", "q_hd"))
    params["wk"], axes["wk"] = dense_init(
        generator, (d, kv, hd), ("kv_in", "kv_heads", "kv_hd"), dtype=dtype,
        bias=cfg.qkv_bias, bias_axes=("kv_heads", "kv_hd"))
    params["wv"], axes["wv"] = dense_init(
        generator, (d, kv, hd), ("kv_in", "kv_heads", "kv_hd"), dtype=dtype,
        bias=cfg.qkv_bias, bias_axes=("kv_heads", "kv_hd"))
    params["wo"], axes["wo"] = dense_init(
        generator, (h, hd, d), ("heads", "o_hd", "embed"), dtype=dtype,
        scale=1.0 / math.sqrt(h * hd))
    if cfg.qk_norm:
        dev = device_of(generator)
        params["q_norm"] = {"scale": torch.zeros(hd, dtype=dtype, device=dev)}
        axes["q_norm"] = {"scale": (None,)}
        params["k_norm"] = {"scale": torch.zeros(hd, dtype=dtype, device=dev)}
        axes["k_norm"] = {"scale": (None,)}
    return (params, axes) if with_axes else params


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


def _attend(cfg, q, k, v, positions, window, index_positions):
    """The route of a full-sequence layer: the kernels on the card where
    ``uses_kernel`` and ``index_positions`` allow, else the reference's
    chunked (S > ``attn_chunk``) or dense path."""
    S = q.shape[1]
    pos1 = positions[0] if positions.ndim > 1 else positions
    if index_positions and q.is_cuda and uses_kernel(cfg, window, S):
        return _attend_kernel(cfg, q, k, v)
    if cfg.attn_chunk and S > cfg.attn_chunk:
        return _attend_chunked(cfg, q, k, v, pos1, pos1, window,
                               cfg.attn_chunk)
    return _attend_dense(cfg, q, k, v, pos1, pos1, window)


def attention(p, cfg, x, positions, *, window=None, index_positions=False):
    """Full-sequence (training / prefill) attention.  ``index_positions``:
    the caller vouches that ``positions`` is ``arange(S)`` on every row,
    which lets the card take the flash kernels."""
    q, k, v = _project_qkv(p, cfg, x, positions)
    out = _attend(cfg, q, k, v, positions, window, index_positions)
    return apply_dense(p["wo"], out, contract=2)


def _kv_for_local_heads(k, v, first, n_local, G):
    """Whole k, v (B, S, KV, hd) -> the kv heads the q heads ``first ..
    first + n_local - 1`` meet (q head h meets kv head h // G), as
    (k, v) with n_local divisible by their head count."""
    idx = [(first + j) // G for j in range(n_local)]
    uniq = sorted(set(idx))
    if n_local % len(uniq) == 0 and all(
            idx.count(u) == n_local // len(uniq) for u in uniq):
        sel = uniq                      # whole groups: GQA on the block
    else:
        sel = idx                       # a kv head for every q head
    sel = torch.tensor(sel, device=k.device)
    return k.index_select(2, sel), v.index_select(2, sel)


def attention_sharded(lay, ps, cfg, xs, positions, *, window=None,
                      index_positions=False):
    """``attention`` on a mesh: ``ps[s]`` is shard s's block of the layer's
    params (``param_pspecs`` of the axes tree), ``xs[s]`` its rows (B_l, S,
    d), whole over 'model' -> each shard's output, whole over 'model'.

    Per ``rules_for``: q (k, v) is column-parallel when the head (kv head)
    count divides 'model' -- the shard's own heads -- else row-parallel:
    the shard contracts its block of d and the partial products are
    psum'd over 'model' (the bias added once, after).  Each shard's q
    heads then meet their own kv heads (replicated kv: the ones they
    index, ``h // (H / KV)``); where the heads do not divide 'model' the
    attention runs whole on every shard and ``wo`` contracts the shard's
    block of head_dim (``o_hd``).  ``wo``'s partial products are psum'd
    over 'model'.  The attention of a shard is ``_attend`` on its block,
    so on the card its heads take the flash kernels as one device's do."""
    M = lay.M
    H, KV, hd, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_model
    heads_col, kv_col = lay.split("heads"), lay.split("kv_heads")
    if M > 1 and (lay.split("q_in") == heads_col
                  or lay.split("kv_in") == kv_col):
        raise NotImplementedError(f"attention rules {lay.rules.param_rules}:"
                                  " a projection neither column- nor "
                                  "row-parallel over 'model'")

    def project(name, column):
        if column or M == 1:
            return [apply_dense(p[name], x) for p, x in zip(ps, xs)]
        blk = d // M
        part = [apply_dense({"w": p[name]["w"]},
                            x[..., r * blk:(r + 1) * blk])
                for p, x, r in zip(ps, xs, lay.rank)]
        out = lay.psum_model(part)
        if "b" in ps[0][name]:
            out = [y + p[name]["b"].to(y.dtype) for p, y in zip(ps, out)]
        return out

    qs, ks, vs = (project("wq", heads_col), project("wk", kv_col),
                  project("wv", kv_col))
    ys = []
    for s, (p, x) in enumerate(zip(ps, xs)):
        q, k, v = qs[s], ks[s], vs[s]
        B, S = x.shape[:2]
        pos = positions[s] if isinstance(positions, list) else positions
        if cfg.qk_norm:
            q = apply_rmsnorm(p["q_norm"], q)
            k = apply_rmsnorm(p["k_norm"], k)
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
        if heads_col and not kv_col and M > 1:
            Hl = H // M
            k, v = _kv_for_local_heads(k, v, lay.rank[s] * Hl, Hl, H // KV)
        out = _attend(cfg, q, k, v, pos, window, index_positions)
        if not heads_col and M > 1:             # o_hd: the head_dim block
            blk = hd // M
            r = lay.rank[s]
            out = out[..., r * blk:(r + 1) * blk]
        ys.append(apply_dense(p["wo"], out, contract=2))
    return lay.psum_model(ys)


class KVCache(NamedTuple):
    k: torch.Tensor  # (B, KV, max_len, hd)
    v: torch.Tensor
    # the index is carried at the stack level (the same for every layer)


def init_kv_cache(cfg, batch, max_len, dtype, device=None):
    shape = (batch, cfg.n_kv_heads, max_len, cfg.head_dim)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))


def attention_prefill(p, cfg, x, cache: KVCache, *, window=None):
    """Prefill: full attention over the prompt x (B, S, d) at positions
    ``arange(S)``, its k and v written into the first S positions of
    ``cache`` (in place) -> (y (B, S, d), cache).  The reference takes the
    positions and ``max_len`` and returns a new cache; here the cache (a
    layer of the decode state) is given and its length is ``max_len``."""
    B, S = x.shape[:2]
    if S > cache.k.shape[2]:
        raise ValueError(f"a prompt of {S} tokens does not fit a cache of "
                         f"{cache.k.shape[2]}")
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device).expand(B, S)
    q, k, v = _project_qkv(p, cfg, x, positions)
    out = _attend(cfg, q, k, v, positions, window, True)
    cache.k[:, :, :S].copy_(k.transpose(1, 2))
    cache.v[:, :, :S].copy_(v.transpose(1, 2))
    return apply_dense(p["wo"], out, contract=2), cache


def attention_decode(p, cfg, x, cache: KVCache, index, *, window=None):
    """Single-token decode.  x: (B, 1, d); ``cache`` holds ``max_len``
    positions; ``index`` (a 0-d int32 tensor on x's device) is the write
    position (== the number of tokens already cached).  The new k and v
    are written into ``cache`` in place -> (y (B, 1, d), cache)."""
    B = x.shape[0]
    index = torch.as_tensor(index, dtype=torch.int32, device=x.device)
    q, k, v = _project_qkv(p, cfg, x, index.reshape(1, 1).expand(B, 1))
    max_len = cache.k.shape[2]
    at = index.long().clamp(0, max_len - 1).reshape(1)
    cache.k.index_copy_(2, at, k.transpose(1, 2).to(cache.k.dtype))
    cache.v.index_copy_(2, at, v.transpose(1, 2).to(cache.v.dtype))
    KV, hd, H = cfg.n_kv_heads, cfg.head_dim, cfg.n_heads
    qg = q.reshape(B, 1, KV, H // KV, hd).float() * _scale(cfg)
    scores = torch.einsum("bqkgd,bksd->bkgqs", qg, cache.k.float())
    scores = softcap(scores, cfg.attn_softcap)
    k_pos = torch.arange(max_len, device=x.device)
    valid = k_pos <= index
    if window is not None:
        valid &= (index - k_pos) < window
    scores = torch.where(valid, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bksd->bqkgd", probs, cache.v.float())
    out = out.reshape(B, 1, H, hd).to(x.dtype)
    return apply_dense(p["wo"], out, contract=2), cache
