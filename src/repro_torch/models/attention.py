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
head dim the kernel supports (``HEAD_DIMS``: 16, 32, 64, 112, 128) and
float32 or bf16 activations, which the kernel returns o in) and the caller
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
causal mask moves only by a ``q_offset`` the host passes, and a step
reads the index on the device only.  It writes the new k and v into
the cache in place (``index_copy_`` at the index, clamped to ``max_len -
1`` as ``dynamic_update_slice`` clamps its start) and reads the index on
the device only: a step copies no cache and waits for nothing.

On a mesh (``attention_sharded``, ``attention_prefill_sharded``,
``attention_decode_sharded``) each shard holds its block of the layer's
params and of the cache, laid out by ``rules_for``: kv heads over 'model'
where they divide it, else the cache's positions (``kv_seq``) over
'model', or over 'data' at batch 1.  Decode over split positions combines
the shards' blocks as flash-decoding does (see
``attention_decode_sharded``).  A batch-1 prompt whose positions split
over 'data' (``attention_prefill_sharded``'s ``starts``) attends its q
block to k and v gathered over 'data', at its block's offset: on the card
the flash forward's ``q_offset``, here ``_attend_dense`` /
``_attend_chunked`` with ``q_pos = off + arange``, as the reference.
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
            and cfg.xdtype in fa.DTYPES)


def _attend_kernel(cfg, q, k, v, q_offset=None):
    """The kernels on (B, H, S, hd) copies of q, k, v -> (B, S, H, hd) in
    their type (float32 or bf16, as ``_attend_chunked`` returns
    ``q.dtype``), differentiable in q, k and v.  With ``q_offset`` (q a
    block of the keys' positions, from that one on) the forward kernel
    alone, which takes the offset: such a block is never differentiated,
    and asking for a gradient raises rather than drop the offset."""
    q, k, v = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    if q_offset is None:
        o = fa.flash_attention(q, k, v, True, _scale(cfg))
    elif torch.is_grad_enabled() and any(x.requires_grad
                                         for x in (q, k, v)):
        raise NotImplementedError("the flash kernels' backward takes no "
                                  "query offset: a prompt split over "
                                  "'data' is not differentiated")
    else:
        o, _ = fa.flash_attention_fwd(q, k, v, causal=True,
                                      scale=_scale(cfg), q_offset=q_offset)
    return o.transpose(1, 2)


def _attend(cfg, q, k, v, positions, window, index_positions,
            q_offset=None):
    """The route of a full-sequence layer: the kernels on the card where
    ``uses_kernel`` and ``index_positions`` allow, else the reference's
    chunked (Sk > ``attn_chunk``) or dense path.  Without ``q_offset``, q
    and k share ``positions``; with it, q holds the positions ``q_offset
    + arange(Sq)`` (``positions``) of the keys' ``arange(Sk)``."""
    Sk = k.shape[1]
    pos1 = positions[0] if positions.ndim > 1 else positions
    k_pos = pos1 if q_offset is None else torch.arange(
        Sk, dtype=pos1.dtype, device=pos1.device)
    if index_positions and q.is_cuda and uses_kernel(cfg, window, Sk):
        return _attend_kernel(cfg, q, k, v, q_offset)
    if cfg.attn_chunk and Sk > cfg.attn_chunk:
        return _attend_chunked(cfg, q, k, v, pos1, k_pos, window,
                               cfg.attn_chunk)
    return _attend_dense(cfg, q, k, v, pos1, k_pos, window)


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


def _qkv_sharded(lay, ps, cfg, xs, positions):
    """Each shard's q, k, v (qk-normed and rotated) from its rows ``xs[s]``
    (B_l, S, d), whole over 'model', at ``positions[s]``.  Per
    ``rules_for``: q (k, v) is column-parallel when the head (kv head)
    count divides 'model' -- the shard's own heads -- else row-parallel:
    the shard contracts its block of d, the partial products are psum'd
    over 'model' (the bias added once, after) and every head is on every
    shard."""
    M = lay.M
    d = cfg.d_model
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
    for s, p in enumerate(ps):
        if cfg.qk_norm:
            qs[s] = apply_rmsnorm(p["q_norm"], qs[s])
            ks[s] = apply_rmsnorm(p["k_norm"], ks[s])
        qs[s] = apply_rope(qs[s], positions[s], cfg.rope_theta)
        ks[s] = apply_rope(ks[s], positions[s], cfg.rope_theta)
    return qs, ks, vs


def _wo_sharded(lay, ps, cfg, outs):
    """``wo`` on each shard's attention output (B_l, S, Hq, hd): its own
    heads where they are column-parallel, else every head, of which it
    contracts its block of head_dim (``o_hd``); the partial products
    psum'd over 'model'."""
    ys = []
    for p, out, r in zip(ps, outs, lay.rank):
        if not lay.split("heads") and lay.M > 1:
            blk = cfg.head_dim // lay.M
            out = out[..., r * blk:(r + 1) * blk]
        ys.append(apply_dense(p["wo"], out, contract=2))
    return lay.psum_model(ys)


def _attend_sharded(lay, cfg, qs, ks, vs, positions, window,
                    index_positions, q_offsets=None):
    """Each shard's ``_attend`` on its q heads: where q is column-parallel
    and k, v are not, each q head meets the kv head it indexes.
    ``q_offsets[s]``: shard s's q block starts there (``_attend``'s
    ``q_offset``)."""
    H, KV = cfg.n_heads, cfg.n_kv_heads
    outs = []
    for s, (q, k, v) in enumerate(zip(qs, ks, vs)):
        if lay.split("heads") and not lay.split("kv_heads"):
            Hl = H // lay.M
            k, v = _kv_for_local_heads(k, v, lay.rank[s] * Hl, Hl, H // KV)
        outs.append(_attend(cfg, q, k, v, positions[s], window,
                            index_positions,
                            None if q_offsets is None else q_offsets[s]))
    return outs


def attention_sharded(lay, ps, cfg, xs, positions, *, window=None,
                      index_positions=False):
    """``attention`` on a mesh: ``ps[s]`` is shard s's block of the layer's
    params (``param_pspecs`` of the axes tree), ``xs[s]`` its rows (B_l, S,
    d), whole over 'model' -> each shard's output, whole over 'model'.

    q, k, v as ``_qkv_sharded`` makes them; each shard's q heads then meet
    their own kv heads (replicated kv: the ones they index, ``h // (H /
    KV)``); where the heads do not divide 'model' the attention runs whole
    on every shard and ``wo`` contracts the shard's block of head_dim
    (``o_hd``).  The attention of a shard is ``_attend`` on its block, so
    on the card its heads take the flash kernels as one device's do."""
    positions = positions if isinstance(positions, list) else \
        [positions] * len(xs)
    qs, ks, vs = _qkv_sharded(lay, ps, cfg, xs, positions)
    outs = _attend_sharded(lay, cfg, qs, ks, vs, positions, window,
                           index_positions)
    return _wo_sharded(lay, ps, cfg, outs)


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


def _write_at(cache, k, v, index, off=0, max_len=None):
    """The new k, v (B, 1, KV, hd) written into ``cache`` in place at the
    index clamped to ``max_len - 1``, which falls in this block of
    positions ``[off, off + T)`` or nowhere (the block keeps its bits).
    The index is read on the device only."""
    T = cache.k.shape[2]
    at = index.long().clamp(0, (max_len or T) - 1)
    if off:
        at = at - off
    new_k = k.transpose(1, 2).to(cache.k.dtype)
    new_v = v.transpose(1, 2).to(cache.v.dtype)
    if max_len is not None and T != max_len:
        inside = (at >= 0) & (at < T)
        at = at.clamp(0, T - 1)
        new_k = torch.where(inside, new_k, cache.k.index_select(
            2, at.reshape(1)))
        new_v = torch.where(inside, new_v, cache.v.index_select(
            2, at.reshape(1)))
    cache.k.index_copy_(2, at.reshape(1), new_k)
    cache.v.index_copy_(2, at.reshape(1), new_v)


def _decode_scores(cfg, q, ck, index, window, off=0):
    """q (B, 1, Hq, hd) against a cache block ck (B, KV_l, T, hd) whose
    first position is ``off`` -> the masked scores (B, KV_l, Hq / KV_l, 1,
    T): causal and windowed by the global positions ``off + arange(T)``,
    NEG_INF where masked."""
    B, _, Hq, hd = q.shape
    KV = ck.shape[1]
    qg = q.reshape(B, 1, KV, Hq // KV, hd).float() * _scale(cfg)
    scores = torch.einsum("bqkgd,bksd->bkgqs", qg, ck.float())
    scores = softcap(scores, cfg.attn_softcap)
    k_pos = torch.arange(ck.shape[2], device=q.device)
    if off:
        k_pos = k_pos + off
    valid = k_pos <= index
    if window is not None:
        valid &= (index - k_pos) < window
    return torch.where(valid, scores, NEG_INF)


def attention_decode(p, cfg, x, cache: KVCache, index, *, window=None):
    """Single-token decode.  x: (B, 1, d); ``cache`` holds ``max_len``
    positions; ``index`` (a 0-d int32 tensor on x's device) is the write
    position (== the number of tokens already cached).  The new k and v
    are written into ``cache`` in place -> (y (B, 1, d), cache)."""
    B = x.shape[0]
    index = torch.as_tensor(index, dtype=torch.int32, device=x.device)
    q, k, v = _project_qkv(p, cfg, x, index.reshape(1, 1).expand(B, 1))
    _write_at(cache, k, v, index)
    probs = torch.softmax(_decode_scores(cfg, q, cache.k, index, window),
                          dim=-1)
    out = torch.einsum("bkgqs,bksd->bqkgd", probs, cache.v.float())
    out = out.reshape(B, 1, cfg.n_heads, cfg.head_dim).to(x.dtype)
    return apply_dense(p["wo"], out, contract=2), cache


def attention_prefill_sharded(lay, ps, cfg, xs, caches, offs, *,
                              window=None, starts=None):
    """``attention_prefill`` on a mesh: ``xs[s]`` shard s's rows of the
    prompt at positions ``arange(S)``, ``caches[s]`` its block of the
    layer's cache (its kv heads where they split over 'model', else every
    kv head; the positions ``[offs[s], offs[s] + T)`` where ``kv_seq``
    splits) -> each shard's output, whole over 'model'.  Each shard
    writes the k, v of the prompt's positions that fall in its block, in
    place.

    With ``starts`` (``ShardLayout.seq_starts``: the prompt's positions
    split over 'data'), ``xs[s]`` is shard s's block of them, from
    ``starts[s]`` on: it projects q, k, v of its own positions only; k and
    v are gathered over 'data' along the sequence, and its q block meets
    the keys ``[0, starts[s] + S_l)`` under the causal mask, window and
    soft-cap of the global positions (on the card the flash forward with
    ``q_offset = starts[s]``)."""
    B, S = xs[0].shape[:2]
    first = starts or [0] * len(xs)
    positions = [torch.arange(f, f + S, dtype=torch.int32,
                              device=x.device).expand(x.shape[0], S)
                 for f, x in zip(first, xs)]
    qs, ks, vs = _qkv_sharded(lay, ps, cfg, xs, positions)
    if starts is not None:
        ks, vs = lay.all_gather_seq(ks, 1), lay.all_gather_seq(vs, 1)
        S = ks[0].shape[1]
    for cache, k, v, off in zip(caches, ks, vs, offs):
        n = max(0, min(S - off, cache.k.shape[2]))
        if n:
            cache.k[:, :, :n].copy_(k[:, off:off + n].transpose(1, 2))
            cache.v[:, :, :n].copy_(v[:, off:off + n].transpose(1, 2))
    outs = _attend_sharded(lay, cfg, qs, ks, vs, positions, window, True,
                           starts)
    return _wo_sharded(lay, ps, cfg, outs)


def attention_decode_sharded(lay, ps, cfg, xs, caches, offs, indices,
                             max_len, *, window=None):
    """``attention_decode`` on a mesh: ``xs[s]`` shard s's rows (B_l, 1,
    d), ``caches[s]`` its block of the layer's cache (as
    ``attention_prefill_sharded``'s, ``max_len`` positions in all),
    ``indices[s]`` its copy of the index -> each shard's output, whole over
    'model'.  Three layouts of the cache:

    - kv heads over 'model': each shard attends its own heads over the
      whole cache, as one device does;
    - positions (``kv_seq``) over 'model', where the kv heads do not
      divide it: every shard holds every kv head on its block of
      positions, so it takes every q head (gathered over 'model' where q
      is column-parallel);
    - positions over 'data' (batch 1), kv heads over 'model'.

    Where positions split, each shard scores its block under the global
    positions' causal mask, window and soft-cap; the row max is pmax'd
    over the split axes and each shard's ``exp`` of its scores less that
    max (0 for a wholly masked block: ``exp(NEG_INF - max)``), their sums
    and the weighted values psum'd (flash-decoding's combine).  The new
    k, v land in the one block that holds the index, read on the
    device only."""
    H, hd = cfg.n_heads, cfg.head_dim
    positions = [i.reshape(1, 1).expand(x.shape[0], 1)
                 for i, x in zip(indices, xs)]
    qs, ks, vs = _qkv_sharded(lay, ps, cfg, xs, positions)
    for cache, k, v, i, off in zip(caches, ks, vs, indices, offs):
        _write_at(cache, k, v, i, off, max_len)
    gathered = lay.split("heads") and not lay.split("kv_heads")
    if gathered:
        qs = lay.all_gather_model(qs, 2)
    scores = [_decode_scores(cfg, q, c.k, i, window, off)
              for q, c, i, off in zip(qs, caches, indices, offs)]
    seq = lay.act_axes("kv_seq")
    if seq:
        m = lay.pmax_axes([sc.amax(-1, keepdim=True) for sc in scores],
                          seq)
        e = [torch.exp(sc - mx) for sc, mx in zip(scores, m)]
        tot = lay.psum_axes([x.sum(-1, keepdim=True) for x in e], seq)
        outs = lay.psum_axes([torch.einsum("bkgqs,bksd->bqkgd", x,
                                           c.v.float())
                              for x, c in zip(e, caches)], seq)
        outs = [o / t.permute(0, 3, 1, 2, 4) for o, t in zip(outs, tot)]
    else:
        outs = [torch.einsum("bkgqs,bksd->bqkgd", torch.softmax(sc, dim=-1),
                             c.v.float()) for sc, c in zip(scores, caches)]
    ys = []
    for o, x, r in zip(outs, xs, lay.rank):
        o = o.reshape(x.shape[0], 1, -1, hd).to(x.dtype)
        if gathered:
            Hl = H // lay.M
            o = o[:, :, r * Hl:(r + 1) * Hl]
        ys.append(o)
    return _wo_sharded(lay, ps, cfg, ys)
