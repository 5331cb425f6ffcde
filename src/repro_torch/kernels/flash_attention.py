"""Causal (or full) softmax attention, forward only, with its row
logsumexp.

Port of the forward of ``repro.kernels.flash_attention`` (``_fwd``):
``flash_attention_fwd(q, k, v, causal=True, scale=None)`` -> ``(o, lse)``
for q (B, H, Sq, hd) and k, v (B, KV, Sk, hd), with o (B, H, Sq, hd) and
lse (B, H, Sq).  Query head h reads KV head h // (H // KV), the grouping of
``models/attention.py`` (``_attend_dense``'s reshape and
``_attend_chunked``'s ``repeat``), so GQA callers pass k and v as they are.
The causal mask is top-left aligned (row i sees keys j <= i) and masks
with -1e30, as the reference's ``flash_attention_ref`` does; ``scale``
defaults to 1/sqrt(hd).  Unlike the TPU kernel, any Sq and Sk work.

``flash_attention_fwd`` is the public wrapper.  On a CUDA tensor it
launches the hand-written kernel ``csrc/flash_attention.cu`` or raises; on
a CPU tensor it runs ``flash_attention_ref``, the plain PyTorch version,
which is also what the kernel is held against on the card.  The backward
(the TPU kernel's ``_bwd_rule``) is not ported yet.
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


def _check_shapes(q, k, v) -> None:
    """Raise unless q (B, H, Sq, hd), k and v (B, KV, Sk, hd) fit the
    kernel: KV divides H, hd in ``HEAD_DIMS``, no empty axis."""
    if q.dim() != 4 or k.dim() != 4 or tuple(k.shape) != tuple(v.shape):
        raise ValueError(f"flash_attention_fwd takes q (B, H, Sq, hd), k and "
                         f"v (B, KV, Sk, hd), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, H, Sq, hd = q.shape
    Bk, KV, Sk, hdk = k.shape
    if Bk != B or hdk != hd or KV == 0 or H % KV:
        raise ValueError(f"flash_attention_fwd: q {tuple(q.shape)} and k/v "
                         f"{tuple(k.shape)} disagree (KV must divide H)")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention_fwd supports head dims "
                         f"{HEAD_DIMS}, got {hd}")
    if min(B, H, Sq, Sk) == 0:
        raise ValueError("flash_attention_fwd needs non-empty inputs")


def flash_attention_fwd(q, k, v, *, causal=True, scale=None):
    """Softmax attention of q (B, H, Sq, hd) over k, v (B, KV, Sk, hd) ->
    ``(o (B, H, Sq, hd), lse (B, H, Sq))`` float32.

    Float32, contiguous inputs on one device, none requiring a gradient;
    hd in ``HEAD_DIMS``.  A CUDA launch adds one to
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
