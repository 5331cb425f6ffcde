"""The paper's encoder: ResNet-18-style 1D CNN over mel spectrograms with
L=8 *splittable* blocks and a d=128 projection head (§5 Reproducibility).

Port of ``repro.models.audio_encoder``.  The public functions keep the
reference's ``(B, T, C)`` layout; inside ``apply_blocks`` the activation
runs channels-first ``(B, C, T)``, the layout ``F.conv1d`` takes, and is
transposed back once at the end.  Parameters are a plain dict of
tensors: conv weights ``(Cout, Cin, K)`` (torch's layout), GroupNorm
``scale``/``bias`` ``(C,)``, head ``(Cin, d)``.  ``repro_torch.weights``
converts the reference's pytree.

GroupNorm replaces BatchNorm exactly as in the reference (BatchNorm is
undefined for streaming batch sizes).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F


@dataclass(frozen=True)
class AudioEncCfg:
    name: str = "streamsplit-audio"
    family: str = "audio_enc"
    n_mels: int = 128
    d_embed: int = 128
    widths: tuple = (64, 64, 128, 128, 256, 256, 512, 512)
    strides: tuple = (1, 2, 1, 2, 1, 2, 1, 2)
    kernel: int = 3
    groups: int = 8        # GroupNorm groups
    frames: int = 100      # 1 s @ 10 ms hop

    @property
    def n_blocks(self):
        return len(self.widths)


def _conv_init(generator, k, cin, cout):
    """Truncated normal in ±2σ, scaled by 1/√(k·cin), in torch's
    ``(Cout, Cin, K)`` layout."""
    w = torch.empty(cout, cin, k)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return w * (1.0 / math.sqrt(k * cin))


def init_audio_encoder(cfg: AudioEncCfg, generator: torch.Generator):
    """Random weights on the CPU from ``generator`` (move them with
    ``repro_torch.weights.to_device``).  Same shapes and scales as the
    reference's ``init_audio_encoder``; the draws differ, since a torch
    generator cannot replay ``jax.random``."""
    params = {"stem": {"w": _conv_init(generator, 7, cfg.n_mels,
                                       cfg.widths[0])}}
    blocks = []
    cin = cfg.widths[0]
    for w, s in zip(cfg.widths, cfg.strides):
        blk = {
            "conv1": {"w": _conv_init(generator, cfg.kernel, cin, w)},
            "gn1": {"scale": torch.ones(w), "bias": torch.zeros(w)},
            "conv2": {"w": _conv_init(generator, cfg.kernel, w, w)},
            "gn2": {"scale": torch.ones(w), "bias": torch.zeros(w)},
        }
        if s != 1 or cin != w:
            blk["proj"] = {"w": _conv_init(generator, 1, cin, w)}
        blocks.append(blk)
        cin = w
    params["blocks"] = blocks
    params["head"] = {
        "w": _conv_init(generator, 1, cin, cfg.d_embed)[:, :, 0].T
        .contiguous(),                                       # (Cin, d)
    }
    return params


def _same_pad(t, k, s):
    """XLA ``"SAME"`` padding: total = max((⌈t/s⌉−1)·s + k − t, 0), the
    smaller half on the left.  For k=3, s=2 that is (0, 1) at t=100 and
    t=50 and (1, 1) at t=25 — asymmetric, so ``padding=1`` would give
    the right shape and the wrong values."""
    total = max((-(-t // s) - 1) * s + k - t, 0)
    return total // 2, total - total // 2


def _conv1d(x, w, stride=1):
    """x: (B, Cin, T); w: (Cout, Cin, K) -> (B, Cout, ⌈T/stride⌉)."""
    x = F.pad(x, _same_pad(x.shape[-1], w.shape[-1], stride))
    return F.conv1d(x, w, stride=stride)


def _groupnorm(p, x, groups, eps=1e-5):
    """x: (B, C, T); statistics over each group's channels and all of T,
    population variance, as the reference."""
    B, C, T = x.shape
    g = x.reshape(B, groups, C // groups, T)
    mu = g.mean(dim=(2, 3), keepdim=True)
    var = g.var(dim=(2, 3), correction=0, keepdim=True)
    g = (g - mu) * torch.rsqrt(var + eps)
    return g.reshape(B, C, T) * p["scale"][:, None] + p["bias"][:, None]


def _stem(params, x):
    return torch.relu(_conv1d(x, params["stem"]["w"]))


def _block(cfg, blk, x, stride):
    h = _conv1d(x, blk["conv1"]["w"], stride)
    h = torch.relu(_groupnorm(blk["gn1"], h, cfg.groups))
    h = _conv1d(h, blk["conv2"]["w"])
    h = _groupnorm(blk["gn2"], h, cfg.groups)
    if "proj" in blk:
        x = _conv1d(x, blk["proj"]["w"], stride)
    return torch.relu(x + h)


def _ncw(x):
    return x.transpose(1, 2)


def _nwc(x):
    return x.transpose(1, 2).contiguous()


def apply_stem(cfg, params, mel):
    """mel: (B, T, n_mels) -> (B, T, widths[0])."""
    return _nwc(_stem(params, _ncw(mel)))


def apply_block(cfg, blk, x, stride):
    """One residual block on a (B, T, C) activation."""
    return _nwc(_block(cfg, blk, _ncw(x), stride))


def apply_blocks(cfg, params, x, start, end):
    """Run blocks [start, end) — the split engine's stage executor."""
    if start >= end:
        return x
    h = _ncw(x)
    for i in range(start, end):
        h = _block(cfg, params["blocks"][i], h, cfg.strides[i])
    return _nwc(h)


def apply_head(cfg, params, x):
    """(B, T', C) -> l2-normalised (B, d_embed).

    Kept in the reference's multiply-reduce form rather than
    ``pooled @ w``: each sample's accumulation order then does not
    depend on the batch size the way a GEMM's partitioning can."""
    pooled = x.mean(dim=1)
    w = params["head"]["w"]
    z = (pooled[:, :, None] * w[None, :, :]).sum(dim=1)
    return z / torch.clamp_min(torch.linalg.vector_norm(z, dim=-1,
                                                        keepdim=True), 1e-6)


def encode(cfg, params, mel, *, start=0, end=None):
    """Full path: stem -> blocks -> head (start/end for split execution)."""
    end = cfg.n_blocks if end is None else end
    x = apply_stem(cfg, params, mel) if start == 0 else mel
    x = apply_blocks(cfg, params, x, start, end)
    if end == cfg.n_blocks:
        return apply_head(cfg, params, x)
    return x  # intermediate activation (the wire payload)


def block_flops(cfg, frames=None):
    """Per-block forward FLOPs for one sample (the reference's cost
    model, ``t // s`` frames after each stride)."""
    T = frames or cfg.frames
    out = []
    cin = cfg.widths[0]
    t = T
    for w, s in zip(cfg.widths, cfg.strides):
        t_out = t // s
        f = 2 * cfg.kernel * cin * w * t_out + 2 * cfg.kernel * w * w * t_out
        if s != 1 or cin != w:
            f += 2 * cin * w * t_out
        out.append(f)
        cin, t = w, t_out
    return out


def boundary_bytes(cfg, frames=None, *, dtype_bytes=4):
    """Wire payload size (bytes/sample) if split AFTER block i (i=0 => raw
    input; i=n_blocks => embedding only).

    Like the reference this counts ``t // s`` frames after a stride, while
    "SAME" convolutions give ⌈t/s⌉: at frames=100 blocks 5..7 hold 13
    frames, not 12, so ``SplitEngine`` ships 3328 and 6656 elements at
    k=6 and k=7 where this says 3072 and 6144.  The engine's count
    (the activation's size) is the one the gateway reports."""
    T = frames or cfg.frames
    sizes = [T * cfg.n_mels * dtype_bytes]  # k=0: send raw mel
    t = T
    for w, s in zip(cfg.widths, cfg.strides):
        t = t // s
        sizes.append(t * w * dtype_bytes)
    sizes[-1] = cfg.d_embed * dtype_bytes  # after last block only z crosses
    return sizes
