"""The hybrid loss's two regularisers with one backward launch.

Both regularisers of the hybrid loss read the same embeddings z (B, T,
d): the SW term (``kernels.swd``) the W = B·T rows of ``z.reshape(-1,
d)``, the temporal Laplacian (``kernels.laplacian_energy``) the B rows of
T frames.  ``hybrid_reg_bwd`` writes the sum of their gradients with
respect to z in one launch of the hand-written kernel
``csrc/hybrid_reg_bwd.cu``:

    dz[b, t] = swd_rank_bwd(g_sw, ...)[b·T + t]
               + laplacian_energy_bwd(z, mask, g_tot, k)[b, t]

with the two backward formulas of those modules, either half absent when
its cotangent is None.  ``g_tot`` is read through its stride, so the
expanded cotangent of ``tot.sum()`` needs no copy.  On a CUDA tensor the
wrapper launches the kernel or raises; on a CPU tensor it runs
``hybrid_reg_bwd_ref``, the plain version, which is also what the kernel
is held against on the card.  The kernel joins the halves with one
rounded add, so on the card dz is bitwise the two one-half launches
(``swd_rank_bwd``, ``laplacian_energy_bwd``, which launch this kernel with
one half) added by torch.

``hybrid_regularisers(z, mask, k, dirs, prior_q)`` is the differentiable
entry, a ``torch.autograd.Function``: its forward is ``swd_rank_fwd`` on
``z.reshape(-1, d)`` and ``laplacian_energy`` on z (the loss, and the
per-row ``tot`` and ``cnt``), its backward one ``hybrid_reg_bwd``.  On a
CPU tensor its wrappers run their plain versions.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.laplacian_energy import (check_bwd,
                                                  laplacian_energy,
                                                  laplacian_energy_bwd_ref)
from repro_torch.kernels.swd import (check_rank_bwd, swd_rank_bwd_ref,
                                     swd_rank_fwd)


def hybrid_reg_bwd_ref(z, mask, k, g_sw, proj, rank, prior_q, dirs, g_tot):
    """Plain version: the two plain backward formulas, added -> dz (B, T,
    d); a half whose cotangent is None is left out."""
    if g_sw is None:
        return laplacian_energy_bwd_ref(z, mask, g_tot, k)
    dx = swd_rank_bwd_ref(g_sw, proj, rank, prior_q, dirs).view(z.shape)
    if g_tot is None:
        return dx
    return dx + laplacian_energy_bwd_ref(z, mask, g_tot, k)


def launch_bwd(dz, *, z=None, mask=None, k=0, g_tot=None, g_sw=None,
               proj=None, rank=None, prior_q=None, dirs=None, B, T, d, M=0):
    """One launch of ``csrc/hybrid_reg_bwd.cu`` writing ``dz`` (B·T, d) on
    its device's current stream: the SW half where ``g_sw`` is given, the
    Laplacian half where ``g_tot`` is.  The caller has checked the
    inputs."""
    def ptr(x):
        return None if x is None else x.data_ptr()
    lib = build.load("hybrid_reg_bwd.cu")
    with torch.cuda.device(dz.device):
        err = lib.hybrid_reg_bwd_f32(
            ptr(z), ptr(mask), ptr(g_tot),
            0 if g_tot is None else g_tot.stride(0), int(k), ptr(g_sw),
            ptr(proj), ptr(rank), ptr(prior_q), ptr(dirs), dz.data_ptr(), B,
            T, d, M, build.stream_of(dz))
    build.raise_on_error(lib, "hybrid_reg_bwd", err)


def hybrid_reg_bwd(z, mask, k, g_sw, proj, rank, prior_q, dirs, g_tot):
    """The gradient of ``g_sw · swd_rank_fwd(z.reshape(-1, d), dirs,
    prior_q)[0] + Σ_b g_tot[b] · laplacian_energy(z, mask, k)[0][b]`` with
    respect to z -> dz (B, T, d) float32.

    ``g_sw`` (one float) or ``g_tot`` (B,), not both, may be None, and then
    that half is left out; ``g_tot`` may have any stride.  Float32
    (``rank`` int32), contiguous inputs on one device, none requiring a
    gradient.  A CUDA launch adds one to ``hybrid_reg_bwd.launches``."""
    if g_sw is None and g_tot is None:
        raise ValueError("hybrid_reg_bwd needs the cotangent of at least "
                         "one term")
    check_bwd("hybrid_reg_bwd", z, mask, g_tot, k)
    B, T, d = z.shape
    if g_sw is not None:
        check_rank_bwd("hybrid_reg_bwd", g_sw, proj, rank, prior_q, dirs)
        if proj.shape[0] != B * T or dirs.shape[1] != d \
                or g_sw.device != z.device:
            raise ValueError(f"hybrid_reg_bwd: z {tuple(z.shape)} on "
                             f"{z.device} against proj {tuple(proj.shape)} "
                             f"and dirs {tuple(dirs.shape)} on "
                             f"{g_sw.device}")
    if z.device.type == "cpu":
        return hybrid_reg_bwd_ref(z, mask, k, g_sw, proj, rank, prior_q,
                                  dirs, g_tot)
    dz = torch.empty_like(z)
    launch_bwd(dz, z=z, mask=mask, k=k, g_tot=g_tot, g_sw=g_sw, proj=proj,
               rank=rank, prior_q=prior_q, dirs=dirs, B=B, T=T, d=d,
               M=0 if g_sw is None else dirs.shape[0])
    hybrid_reg_bwd.launches += 1
    return dz


hybrid_reg_bwd.launches = 0


class _HybridRegularisers(torch.autograd.Function):
    """Forward: the SW and Laplacian forward kernels; backward: one
    ``hybrid_reg_bwd``.  The gradient goes to z only."""

    @staticmethod
    def forward(ctx, z, mask, k, dirs, prior_q):
        z = z.detach()
        B, T, d = z.shape
        sw, proj, rank = swd_rank_fwd(z.view(B * T, d), dirs, prior_q)
        tot, cnt = laplacian_energy(z, mask, k)
        ctx.save_for_backward(z, mask, proj, rank, prior_q, dirs)
        ctx.k = k
        ctx.mark_non_differentiable(cnt)
        ctx.set_materialize_grads(False)
        return sw, tot, cnt

    @staticmethod
    def backward(ctx, g_sw, g_tot, g_cnt):
        z, mask, proj, rank, prior_q, dirs = ctx.saved_tensors
        return hybrid_reg_bwd(z, mask, ctx.k, g_sw, proj, rank, prior_q,
                              dirs, g_tot), None, None, None, None


def hybrid_regularisers(z, mask, k, dirs, prior_q):
    """SW² of the rows of ``z`` (B, T, d) against the sorted prior
    quantiles ``prior_q`` (B·T, M) over ``dirs`` (M, d), and the temporal
    Dirichlet energy of each row of ``z`` with validity ``mask`` (B, T)
    over neighbours up to ``k`` apart -> ``(sw (), tot (B,), cnt (B,))``,
    the gradient flowing to z through ``sw`` and ``tot`` in one backward
    launch.  ``mask``, ``dirs`` and ``prior_q`` must not require a
    gradient."""
    if mask.requires_grad or dirs.requires_grad or prior_q.requires_grad:
        raise ValueError("hybrid_regularisers differentiates z only: pass "
                         "mask, dirs and prior_q that do not require a "
                         "gradient")
    if z.dim() != 3:
        raise ValueError(f"hybrid_regularisers takes z (B, T, d), got "
                         f"{tuple(z.shape)}")
    return _HybridRegularisers.apply(z, mask, k, dirs, prior_q)
