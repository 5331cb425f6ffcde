"""The refine round's temporal Laplacian term, per buffer row.

Port of ``repro.kernels.laplacian_energy.laplacian_energy_pallas``:
``laplacian_energy(z, mask, k)`` returns the Pallas call's own per-row
outputs ``(tot, cnt)``, the masked sum of ``‖z[t+δ] − z[t]‖²`` over the
temporal k-window and its edge count.  One row's Laplacian loss is
``tot / max(cnt, 1)``; over a batch it is ``Σtot / max(Σcnt, 1)``.

``laplacian_energy`` is the public wrapper.  On a CUDA tensor it
launches the hand-written kernel ``csrc/laplacian_energy.cu`` or raises;
on a CPU tensor it runs ``laplacian_energy_ref``, the plain PyTorch
version, which is also what the kernel is held against on the card.
Neither takes a gradient.

The trainers differentiate ``tot``.  ``laplacian_energy_diff`` is the
differentiable entry of this term alone: on a CUDA tensor a
``torch.autograd.Function`` whose forward is ``laplacian_energy`` and whose
backward is ``laplacian_energy_bwd``, ``csrc/hybrid_reg_bwd.cu`` with its
Laplacian half alone (the kernel that also joins the SW term's gradient,
``kernels.hybrid_reg``), of the explicit gradient
dz_t = 2·g_b·Σ_{δ≤K} [m_t m_{t−δ}(z_t − z_{t−δ}) − m_t m_{t+δ}(z_{t+δ} − z_t)]
(K = min(k, T−1); ``cnt`` has no gradient); on a CPU tensor the plain
per-δ loop under ordinary autograd.  ``laplacian_energy_bwd_ref`` is the
backward kernel's plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build


def laplacian_energy_ref(z, mask, k):
    """Plain version: z (B, T, d), mask (B, T) -> (tot (B,), cnt (B,)),
    the reference's per-δ loop."""
    B, T, _ = z.shape
    tot = torch.zeros(B, dtype=torch.float32, device=z.device)
    cnt = torch.zeros(B, dtype=torch.float32, device=z.device)
    for delta in range(1, min(k, T - 1) + 1):
        diff = z[:, delta:] - z[:, :-delta]
        pair = mask[:, delta:] * mask[:, :-delta]
        tot = tot + (diff.square().sum(-1) * pair).sum(-1)
        cnt = cnt + pair.sum(-1)
    return tot, cnt


def laplacian_energy(z, mask, k):
    """Masked temporal Dirichlet energy of each row of ``z`` (B, T, d)
    with validity ``mask`` (B, T) over neighbours up to ``k`` apart ->
    ``(tot (B,), cnt (B,))`` float32.

    Float32, contiguous inputs on one device, none requiring a gradient.
    A CUDA launch adds one to ``laplacian_energy.launches``."""
    build.check_inputs("laplacian_energy", z, mask)
    if z.dim() != 3 or tuple(mask.shape) != tuple(z.shape[:2]):
        raise ValueError(f"laplacian_energy takes z (B, T, d) and mask "
                         f"(B, T), got {tuple(z.shape)} and "
                         f"{tuple(mask.shape)}")
    B, T, d = z.shape
    if min(B, T, d) == 0 or k < 0:
        raise ValueError("laplacian_energy needs non-empty inputs, k >= 0")
    if z.device.type == "cpu":
        return laplacian_energy_ref(z, mask, k)
    lib = build.load("laplacian_energy.cu")
    tot = torch.empty(B, dtype=torch.float32, device=z.device)
    cnt = torch.empty(B, dtype=torch.float32, device=z.device)
    with torch.cuda.device(z.device):
        err = lib.laplacian_energy_f32(z.data_ptr(), mask.data_ptr(),
                                       tot.data_ptr(), cnt.data_ptr(), B, T,
                                       d, int(k), build.stream_of(z))
    build.raise_on_error(lib, "laplacian_energy", err)
    laplacian_energy.launches += 1
    return tot, cnt


laplacian_energy.launches = 0


def laplacian_energy_bwd_ref(z, mask, g, k):
    """Plain version of the backward kernel, the explicit formula: the
    gradient of ``tot`` for the cotangent ``g`` (B,) -> dz (B, T, d)."""
    T = z.shape[1]
    dz = torch.zeros_like(z)
    for delta in range(1, min(k, T - 1) + 1):
        pair = mask[:, delta:] * mask[:, :-delta]
        w = pair[..., None] * (z[:, delta:] - z[:, :-delta])
        dz[:, delta:] += w
        dz[:, :-delta] -= w
    return 2 * g[:, None, None] * dz


def check_bwd(name, z, mask, g, k):
    """The backward's checks: z (B, T, d) and mask (B, T) float32,
    contiguous, on one device; the cotangent g (B,) float32 of any stride
    there, or None; k >= 0."""
    build.check_inputs(name, z, mask)
    if z.dim() != 3 or tuple(mask.shape) != tuple(z.shape[:2]) \
            or (g is not None and tuple(g.shape) != (z.shape[0],)):
        raise ValueError(f"{name} takes z (B, T, d), mask (B, T) and g "
                         f"(B,), got {tuple(z.shape)}, {tuple(mask.shape)} "
                         f"and {None if g is None else tuple(g.shape)}")
    if g is not None:
        if g.dtype != torch.float32:
            raise TypeError(f"{name} takes a float32 g, got {g.dtype}")
        if g.device != z.device or g.requires_grad:
            raise ValueError(f"{name}: g on {g.device} (z on {z.device}) or "
                             "requiring a gradient")
    if min(z.shape) == 0 or k < 0:
        raise ValueError(f"{name} needs non-empty inputs, k >= 0")


def laplacian_energy_bwd(z, mask, g, k):
    """The gradient of ``laplacian_energy``'s ``tot`` with respect to z for
    the cotangent ``g`` (B,) -> dz (B, T, d) float32:
    ``csrc/hybrid_reg_bwd.cu`` with its Laplacian half alone.

    Float32, contiguous z and mask on one device, g of any stride.  A CUDA
    launch adds one to ``laplacian_energy_bwd.launches``."""
    check_bwd("laplacian_energy_bwd", z, mask, g, k)
    if z.device.type == "cpu":
        return laplacian_energy_bwd_ref(z, mask, g, k)
    # imported here: kernels.hybrid_reg imports this module
    from repro_torch.kernels.hybrid_reg import launch_bwd
    B, T, d = z.shape
    dz = torch.empty_like(z)
    launch_bwd(dz, z=z, mask=mask, k=k, g_tot=g, B=B, T=T, d=d)
    laplacian_energy_bwd.launches += 1
    return dz


laplacian_energy_bwd.launches = 0


class _LaplacianEnergy(torch.autograd.Function):
    """The CUDA path: forward and backward are the hand-written kernels;
    the gradient goes to z through tot."""

    @staticmethod
    def forward(ctx, z, mask, k):
        z, mask = z.detach(), mask.detach()
        tot, cnt = laplacian_energy(z, mask, k)
        ctx.save_for_backward(z, mask)
        ctx.k = k
        ctx.mark_non_differentiable(cnt)
        return tot, cnt

    @staticmethod
    def backward(ctx, g_tot, g_cnt):
        z, mask = ctx.saved_tensors
        return laplacian_energy_bwd(z, mask, g_tot, ctx.k), None, None


def laplacian_energy_diff(z, mask, k):
    """``laplacian_energy`` with a gradient to ``z`` through ``tot`` ->
    ``(tot (B,), cnt (B,))``.  ``mask`` must not require a gradient."""
    if mask.requires_grad:
        raise ValueError("laplacian_energy_diff differentiates z only")
    if z.device.type == "cpu":
        return laplacian_energy_ref(z, mask, k)
    return _LaplacianEnergy.apply(z, mask, k)
