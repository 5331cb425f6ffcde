"""Causal (or full) softmax attention with its row logsumexp, and its
backward.

Port of ``repro.kernels.flash_attention``: the forward (``_fwd``) and the
backward (``_bwd_rule``'s two passes).  ``flash_attention_fwd(q, k, v,
causal=True, scale=None)`` -> ``(o, lse)`` for q (B, H, Sq, hd) and k, v
(B, KV, Sk, hd), with o (B, H, Sq, hd) and lse (B, H, Sq).  Query head h
reads KV head h // (H // KV), the grouping of ``models/attention.py``
(``_attend_dense``'s reshape and ``_attend_chunked``'s ``repeat``), so GQA
callers pass k and v as they are.  The causal mask is top-left aligned
(row i sees keys j <= i) and masks with -1e30, as the reference's
``flash_attention_ref`` does; ``scale`` defaults to 1/sqrt(hd).  Unlike
the TPU kernel, any Sq and Sk work.

The backward recomputes the probabilities from the forward's lse:
``flash_attention_bwd_dq`` gives dq and ``flash_attention_bwd_dkv`` gives
dk and dv (summed over each KV head's group of query heads), both from
q, k, v, dO, lse and delta = rowsum(dO * o).  ``flash_attention(q, k, v,
causal, scale)`` is the differentiable entry: a ``torch.autograd.Function``
that saves q, k, v, o and lse and calls the three wrappers on detached
tensors.

Each wrapper dispatches on its input's device.  On a CUDA tensor it
launches its hand-written kernel in ``csrc/flash_attention.cu`` or raises;
on a CPU tensor it runs its plain PyTorch version (``flash_attention_ref``;
``flash_attention_bwd_dq_ref`` and ``flash_attention_bwd_dkv_ref``, the
explicit backward), which is also what the kernel is held against on the
card.  Each wrapper counts its launches in ``<wrapper>.launches``.

All three kernels run every product on the tensor cores in 3xTF32 (three
TF32 products of split operands), which keeps float32 accuracy, not
bitwise: the forward within 2e-5 of o and 1e-5 of lse, the backward within
1e-5 of each gradient's max, of the exact float32 plain versions.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.kernels import build

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128)


def _default_scale(hd, scale):
    return 1.0 / math.sqrt(hd) if scale is None else float(scale)


def flash_attention_ref(q, k, v, causal=True, scale=None):
    """Plain version: the reference's einsum-and-softmax oracle with GQA
    (k and v repeated over each group of H // KV query heads) and the
    scores' logsumexp -> (o (B, H, Sq, hd), lse (B, H, Sq))."""
    H, hd = q.shape[1], q.shape[-1]
    G = H // k.shape[1]
    if G > 1:
        k = k.repeat_interleave(G, dim=1)
        v = v.repeat_interleave(G, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) \
        * _default_scale(hd, scale)
    if causal:
        Sq, Sk = s.shape[-2:]
        keep = (torch.arange(Sq, device=s.device)[:, None]
                >= torch.arange(Sk, device=s.device)[None, :])
        s = s.masked_fill(~keep, NEG_INF)
    o = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, dim=-1), v.float())
    return o.to(q.dtype), torch.logsumexp(s, dim=-1)


def _check_shapes(q, k, v, name="flash_attention_fwd") -> None:
    """Raise unless q (B, H, Sq, hd), k and v (B, KV, Sk, hd) fit the
    kernel: KV divides H, hd in ``HEAD_DIMS``, no empty axis."""
    if q.dim() != 4 or k.dim() != 4 or tuple(k.shape) != tuple(v.shape):
        raise ValueError(f"{name} takes q (B, H, Sq, hd), k and "
                         f"v (B, KV, Sk, hd), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, H, Sq, hd = q.shape
    Bk, KV, Sk, hdk = k.shape
    if Bk != B or hdk != hd or KV == 0 or H % KV:
        raise ValueError(f"{name}: q {tuple(q.shape)} and k/v "
                         f"{tuple(k.shape)} disagree (KV must divide H)")
    if hd not in HEAD_DIMS:
        raise ValueError(f"{name} supports head dims "
                         f"{HEAD_DIMS}, got {hd}")
    if min(B, H, Sq, Sk) == 0:
        raise ValueError(f"{name} needs non-empty inputs")


def flash_attention_fwd(q, k, v, *, causal=True, scale=None):
    """Softmax attention of q (B, H, Sq, hd) over k, v (B, KV, Sk, hd) ->
    ``(o (B, H, Sq, hd), lse (B, H, Sq))`` float32.

    Float32, contiguous inputs on one device, none requiring a gradient
    (``flash_attention`` is the differentiable entry); hd in
    ``HEAD_DIMS``.  A CUDA launch adds one to
    ``flash_attention_fwd.launches``."""
    build.check_inputs("flash_attention_fwd", q, k, v)
    _check_shapes(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal, scale)
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    lib = build.load("flash_attention.cu")
    o = torch.empty_like(q)
    lse = torch.empty(B, H, Sq, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = lib.flash_attention_fwd_f32(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), B, H, KV, Sq, Sk, hd,
            float(np.float32(_default_scale(hd, scale))), int(bool(causal)),
            build.stream_of(q))
    build.raise_on_error(lib, "flash_attention", err)
    flash_attention_fwd.launches += 1
    return o, lse


flash_attention_fwd.launches = 0


def _group(x, G):
    """k or v (B, KV, S, hd) repeated to the H = KV * G query heads."""
    return x.repeat_interleave(G, dim=1) if G > 1 else x


def _bwd_probs(q, k, v, do, lse, delta, causal, scale):
    """The recomputation both backward passes share -> (p, ds) (B, H, Sq,
    Sk): p = exp(scale q k^T - lse), masked entries at -1e30 (so p = 0),
    and ds = p * (do v^T - delta)."""
    G = q.shape[1] // k.shape[1]
    sc = _default_scale(q.shape[-1], scale)
    s = torch.einsum("bhqd,bhkd->bhqk", q * sc, _group(k, G))
    if causal:
        Sq, Sk = s.shape[-2:]
        keep = (torch.arange(Sq, device=s.device)[:, None]
                >= torch.arange(Sk, device=s.device)[None, :])
        s = s.masked_fill(~keep, NEG_INF)
    p = torch.exp(s - lse[..., None])
    dp = torch.einsum("bhqd,bhkd->bhqk", do, _group(v, G))
    return p, p * (dp - delta[..., None])


def flash_attention_bwd_dq_ref(q, k, v, do, lse, delta, causal=True,
                               scale=None):
    """Plain version of the dq kernel: dq = scale * ds k -> (B, H, Sq,
    hd)."""
    _, ds = _bwd_probs(q, k, v, do, lse, delta, causal, scale)
    G = q.shape[1] // k.shape[1]
    return torch.einsum("bhqk,bhkd->bhqd", ds, _group(k, G)) \
        * _default_scale(q.shape[-1], scale)


def flash_attention_bwd_dkv_ref(q, k, v, do, lse, delta, causal=True,
                                scale=None):
    """Plain version of the dk/dv kernel: dv = p^T do and dk = ds^T (scale
    q), each summed over the G query heads of a KV head -> (dk, dv) (B,
    KV, Sk, hd)."""
    p, ds = _bwd_probs(q, k, v, do, lse, delta, causal, scale)
    B, KV, Sk, hd = k.shape
    G = q.shape[1] // KV
    sc = _default_scale(hd, scale)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q * sc)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, do)
    return (dk.reshape(B, KV, G, Sk, hd).sum(2),
            dv.reshape(B, KV, G, Sk, hd).sum(2))


def _check_bwd(name, q, k, v, do, lse, delta) -> None:
    build.check_inputs(name, q, k, v, do, lse, delta)
    _check_shapes(q, k, v, name)
    if tuple(do.shape) != tuple(q.shape) \
            or tuple(lse.shape) != tuple(q.shape[:3]) \
            or tuple(delta.shape) != tuple(q.shape[:3]):
        raise ValueError(f"{name}: do {tuple(do.shape)}, lse "
                         f"{tuple(lse.shape)} and delta {tuple(delta.shape)} "
                         f"do not fit q {tuple(q.shape)}")


def _bwd_launch(fn, q, k, v, do, lse, delta, outs, causal, scale):
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    lib = build.load("flash_attention.cu")
    with torch.cuda.device(q.device):
        err = getattr(lib, fn)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), *(o.data_ptr() for o in outs),
            B, H, KV, Sq, Sk, hd,
            float(np.float32(_default_scale(hd, scale))), int(bool(causal)),
            build.stream_of(q))
    build.raise_on_error(lib, "flash_attention", err)


def flash_attention_bwd_dq(q, k, v, do, lse, delta, *, causal=True,
                           scale=None):
    """dq (B, H, Sq, hd) of ``flash_attention_fwd(q, k, v)`` for the
    cotangent ``do`` of o, from its ``lse`` and ``delta = (do * o).sum(-1)``
    (both (B, H, Sq)).

    Float32, contiguous inputs on one device, none requiring a gradient.
    A CUDA launch adds one to ``flash_attention_bwd_dq.launches``."""
    _check_bwd("flash_attention_bwd_dq", q, k, v, do, lse, delta)
    if q.device.type == "cpu":
        return flash_attention_bwd_dq_ref(q, k, v, do, lse, delta, causal,
                                          scale)
    dq = torch.empty_like(q)
    _bwd_launch("flash_attention_bwd_dq_f32", q, k, v, do, lse, delta, (dq,),
                causal, scale)
    flash_attention_bwd_dq.launches += 1
    return dq


flash_attention_bwd_dq.launches = 0


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, *, causal=True,
                            scale=None):
    """(dk, dv) (B, KV, Sk, hd) of ``flash_attention_fwd(q, k, v)``, as
    ``flash_attention_bwd_dq`` takes its inputs; each KV head's gradient
    sums its H // KV query heads.  A CUDA launch adds one to
    ``flash_attention_bwd_dkv.launches``."""
    _check_bwd("flash_attention_bwd_dkv", q, k, v, do, lse, delta)
    if q.device.type == "cpu":
        return flash_attention_bwd_dkv_ref(q, k, v, do, lse, delta, causal,
                                           scale)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _bwd_launch("flash_attention_bwd_dkv_f32", q, k, v, do, lse, delta,
                (dk, dv), causal, scale)
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


flash_attention_bwd_dkv.launches = 0


class _FlashAttention(torch.autograd.Function):
    """Forward ``flash_attention_fwd``, backward delta as one torch op then
    ``flash_attention_bwd_dq`` and ``flash_attention_bwd_dkv``: the
    kernels on the card, their plain versions on the CPU."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        q, k, v = q.detach(), k.detach(), v.detach()
        o, lse = flash_attention_fwd(q, k, v, causal=causal, scale=scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()
        delta = (do * o).sum(-1)
        kw = dict(causal=ctx.causal, scale=ctx.scale)
        dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw)
        dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal=True, scale=None):
    """Differentiable ``flash_attention_fwd(...)[0]`` -> o (B, H, Sq, hd):
    the gradient reaches q, k and v through the backward wrappers."""
    return _FlashAttention.apply(q, k, v, causal, scale)
