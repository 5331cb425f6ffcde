"""Streaming InfoNCE over per-sample negatives (paper Eq. 10), with its
gradient: the edge learner's contrastive objective.

Port of ``repro.kernels.infonce_vneg.infonce_vneg_pallas``: for z, z_pos
(B, d) and z_neg (B, N, d), with s⁺ = z·z_pos/τ and s⁻_n = z·z_neg[n]/τ,
the per-sample loss ``logsumexp(s⁺, s⁻_1 … s⁻_N) − s⁺`` (B,).  The
Pallas kernel has no backward (the reference differentiates its jnp
twin); here the backward is a hand-written kernel too.

- ``infonce_vneg(z, z_pos, z_neg, tau)`` is the differentiable entry.
  On a CUDA tensor it is a ``torch.autograd.Function`` whose forward is
  ``infonce_vneg_fwd`` and whose backward is ``infonce_vneg_bwd``; on a
  CPU tensor it is the plain ``infonce_vneg_ref`` under ordinary
  autograd.
- ``infonce_vneg_fwd`` launches ``csrc/infonce_vneg.cu``'s forward
  (loss and the logsumexp it saves for the backward);
  ``infonce_vneg_bwd`` its backward, the explicit gradient
  dz = g/τ·((p₀ − 1)·z_pos + Σ p_n z_neg_n), dz_pos = g/τ·(p₀ − 1)·z,
  dz_neg_n = g/τ·p_n·z with p = softmax over (s⁺, s⁻).  On a CPU tensor
  each runs its plain version (``infonce_vneg_fwd_ref``,
  ``infonce_vneg_bwd_ref``), which is also what the kernel is held
  against on the card.
- Each call launches two kernels: the first over (sample, split of the
  negatives) blocks, the split plan being ``splits`` here; the second
  merges the splits in split order.

z, z_pos and z_neg are float32 or bf16 (``DTYPES``), all of one type, as
the reference's kernel takes them; loss and lse are float32, and the
backward gives dz, dz_pos and dz_neg in the inputs' type.  The kernels
read a bf16 input as it is and widen it to float32 (exact); the plain
versions upcast first.  So a bf16 call gives the bits of the float32 call
on the widened inputs, the gradients rounded once to bf16 (to nearest
even).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

DTYPES = (torch.float32, torch.bfloat16)


def infonce_vneg_fwd_ref(z, z_pos, z_neg, tau):
    """Plain version of the forward kernel (differentiable): z, z_pos
    (B, d), z_neg (B, N, d), upcast to float32 -> (loss (B,), lse (B,))."""
    z, z_pos, z_neg = z.float(), z_pos.float(), z_neg.float()
    pos = (z * z_pos).sum(-1) / tau
    negs = torch.einsum("bd,bnd->bn", z, z_neg) / tau
    lse = torch.logsumexp(torch.cat([pos[:, None], negs], dim=1), dim=1)
    return lse - pos, lse


def infonce_vneg_ref(z, z_pos, z_neg, tau):
    """Plain per-sample loss (differentiable) -> (B,)."""
    return infonce_vneg_fwd_ref(z, z_pos, z_neg, tau)[0]


def infonce_vneg_bwd_ref(z, z_pos, z_neg, lse, g, tau):
    """Plain version of the backward kernel, the explicit formula on the
    inputs upcast to float32 -> (dz (B, d), dz_pos (B, d), dz_neg (B, N,
    d)) in the inputs' type."""
    dt = z.dtype
    z, z_pos, z_neg = z.float(), z_pos.float(), z_neg.float()
    pos = (z * z_pos).sum(-1) / tau
    negs = torch.einsum("bd,bnd->bn", z, z_neg) / tau
    c = g / tau
    p0m1 = torch.exp(pos - lse) - 1.0
    p = torch.exp(negs - lse[:, None])                          # (B, N)
    dz = c[:, None] * (p0m1[:, None] * z_pos
                       + torch.einsum("bn,bnd->bd", p, z_neg))
    dz_pos = (c * p0m1)[:, None] * z
    dz_neg = (c[:, None] * p)[:, :, None] * z[:, None, :]
    return dz.to(dt), dz_pos.to(dt), dz_neg.to(dt)


# The kernels' grid: (B, splits) blocks, each split a run of consecutive
# negatives of one sample; about TARGET_BLOCKS blocks, at least
# MIN_PER_SPLIT negatives a split (16 splits of 17 at the edge learner's
# (8, 264, 128)).
TARGET_BLOCKS = 128
MIN_PER_SPLIT = 8


def splits(B, N):
    """How many splits the kernels cut each sample's N negatives into.
    Split s holds negatives [s·per, min(N, (s+1)·per)) with per =
    ceil(N / splits); the forward merges the splits' (m, l) in split
    order, the backward sums their partials of Σ p_n z_neg[n] in split
    order."""
    per = max(-(-N // max(1, TARGET_BLOCKS // B)), MIN_PER_SPLIT)
    return -(-N // per)


def _check(name, z, z_pos, z_neg):
    if z.dim() != 2 or tuple(z_pos.shape) != tuple(z.shape) \
            or z_neg.dim() != 3 or z_neg.shape[0] != z.shape[0] \
            or z_neg.shape[2] != z.shape[1]:
        raise ValueError(f"{name} takes z, z_pos (B, d) and z_neg (B, N, d), "
                         f"got {tuple(z.shape)}, {tuple(z_pos.shape)}, "
                         f"{tuple(z_neg.shape)}")
    if min(z_neg.shape) == 0:
        raise ValueError(f"{name} needs non-empty inputs")


def infonce_vneg_fwd(z, z_pos, z_neg, tau):
    """Per-sample loss and logsumexp -> ``(loss (B,), lse (B,))`` float32.

    Float32 or bf16 (all one type), contiguous inputs on one device, none
    requiring a gradient (``infonce_vneg`` is the differentiable entry).
    A CUDA launch adds one to ``infonce_vneg_fwd.launches``."""
    dt = build.input_dtype("infonce_vneg_fwd", z, DTYPES)
    build.check_inputs("infonce_vneg_fwd", z, z_pos, z_neg, dtype=dt)
    _check("infonce_vneg_fwd", z, z_pos, z_neg)
    if z.device.type == "cpu":
        return infonce_vneg_fwd_ref(z, z_pos, z_neg, tau)
    B, N, d = z_neg.shape
    lib = build.load("infonce_vneg.cu")
    ns = splits(B, N)
    loss = torch.empty(B, dtype=torch.float32, device=z.device)
    lse = torch.empty(B, dtype=torch.float32, device=z.device)
    part = torch.empty(2 * B * ns, dtype=torch.float32, device=z.device)
    with torch.cuda.device(z.device):
        err = getattr(lib, f"infonce_vneg_fwd_{build.SUFFIX[dt]}")(
            z.data_ptr(), z_pos.data_ptr(), z_neg.data_ptr(), loss.data_ptr(),
            lse.data_ptr(), part.data_ptr(), B, N, d, ns, float(tau),
            build.stream_of(z))
    build.raise_on_error(lib, "infonce_vneg", err)
    infonce_vneg_fwd.launches += 1
    return loss, lse


infonce_vneg_fwd.launches = 0


def infonce_vneg_bwd(z, z_pos, z_neg, lse, g, tau):
    """The loss's gradient for the cotangent ``g`` (B,) given the
    forward's ``lse`` -> ``(dz, dz_pos, dz_neg)`` in the inputs' type.

    z, z_pos and z_neg float32 or bf16 (one type), lse and g float32;
    contiguous, on one device.  A CUDA launch adds one to
    ``infonce_vneg_bwd.launches``."""
    dt = build.input_dtype("infonce_vneg_bwd", z, DTYPES)
    f32 = torch.float32
    build.check_inputs("infonce_vneg_bwd", z, z_pos, z_neg, lse, g,
                       dtype=(dt, dt, dt, f32, f32))
    _check("infonce_vneg_bwd", z, z_pos, z_neg)
    B, N, d = z_neg.shape
    if tuple(lse.shape) != (B,) or tuple(g.shape) != (B,):
        raise ValueError(f"infonce_vneg_bwd: lse {tuple(lse.shape)} and g "
                         f"{tuple(g.shape)} must be ({B},)")
    if z.device.type == "cpu":
        return infonce_vneg_bwd_ref(z, z_pos, z_neg, lse, g, tau)
    lib = build.load("infonce_vneg.cu")
    ns = splits(B, N)
    dz = torch.empty_like(z)
    dz_pos = torch.empty_like(z_pos)
    dz_neg = torch.empty_like(z_neg)
    part = torch.empty(B * ns * d, dtype=torch.float32, device=z.device)
    with torch.cuda.device(z.device):
        err = getattr(lib, f"infonce_vneg_bwd_{build.SUFFIX[dt]}")(
            z.data_ptr(), z_pos.data_ptr(), z_neg.data_ptr(), lse.data_ptr(),
            g.data_ptr(), dz.data_ptr(), dz_pos.data_ptr(), dz_neg.data_ptr(),
            part.data_ptr(), B, N, d, ns, float(tau), build.stream_of(z))
    build.raise_on_error(lib, "infonce_vneg", err)
    infonce_vneg_bwd.launches += 1
    return dz, dz_pos, dz_neg


infonce_vneg_bwd.launches = 0


class _InfoNCEVNeg(torch.autograd.Function):
    """The CUDA path: both directions are the hand-written kernels."""

    @staticmethod
    def forward(ctx, z, z_pos, z_neg, tau):
        z, z_pos, z_neg = (x.detach() for x in (z, z_pos, z_neg))
        loss, lse = infonce_vneg_fwd(z, z_pos, z_neg, tau)
        ctx.save_for_backward(z, z_pos, z_neg, lse)
        ctx.tau = tau
        return loss

    @staticmethod
    def backward(ctx, g):
        z, z_pos, z_neg, lse = ctx.saved_tensors
        dz, dz_pos, dz_neg = infonce_vneg_bwd(z, z_pos, z_neg, lse,
                                              g.contiguous(), ctx.tau)
        return dz, dz_pos, dz_neg, None


def infonce_vneg(z, z_pos, z_neg, tau):
    """Differentiable per-sample streaming InfoNCE -> (B,) float32.

    A CUDA tensor runs the forward and, under autograd, the backward
    kernel; a CPU tensor runs ``infonce_vneg_ref``.  Float32 or bf16 (one
    type) contiguous inputs on one device; the gradients come back in
    their type."""
    if z.device.type == "cpu":
        dt = build.input_dtype("infonce_vneg", z, DTYPES)
        if z_pos.dtype != dt or z_neg.dtype != dt:
            raise TypeError(f"infonce_vneg takes inputs of one type, got "
                            f"{z.dtype}, {z_pos.dtype}, {z_neg.dtype}")
        _check("infonce_vneg", z, z_pos, z_neg)
        return infonce_vneg_ref(z, z_pos, z_neg, tau)
    return _InfoNCEVNeg.apply(z, z_pos, z_neg, tau)
