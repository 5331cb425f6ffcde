"""The refine round's sliced-Wasserstein term, one value per session.

Port of ``repro.kernels.swd_kernel.swd_pallas``, batched over the
fleet's sessions: ``swd_sessions(z, dirs, prior_q)[s]`` is the mean over
the (W, M) grid of ``(sort(z[s] @ dirs.T, axis=0) - prior_q)**2``, the SW
term of ``fleet_refiner.make_fleet_loss``.  ``prior_q`` is the prior's
projections already sorted along W (``torch.sort``, as the reference's
``ops.swd`` sorts them outside the kernel).

``swd_sessions`` is the public wrapper.  On a CUDA tensor it launches
the hand-written kernel ``csrc/swd.cu`` or raises; on a CPU tensor it
runs ``swd_sessions_ref``, the plain PyTorch version, which is also what
the kernel is held against on the card.  Neither takes a gradient: on
the refine path ``z`` is ring data, not a parameter.

The edge trainer differentiates the SW term of one point set through the
sort.  ``swd_single(x, dirs, prior_q)`` is its differentiable entry: on
a CUDA tensor a ``torch.autograd.Function`` whose forward is
``swd_rank_fwd`` (the loss, the projections and each row's rank in its
sorted column, ties broken by row index as ``torch.sort(stable=True)``
breaks them; a kernel of ``csrc/swd.cu``) and whose backward is
``swd_rank_bwd`` (dx_i = Σ_m 2g(proj_im − prior_q[rank_im, m])/(W·M) ·
dirs_m; ``csrc/hybrid_reg_bwd.cu`` with its SW half alone, the kernel that
also joins the Laplacian term's gradient, ``kernels.hybrid_reg``); on a
CPU tensor the plain
``swd_rank_fwd_ref`` under ordinary autograd.  ``swd_rank_fwd_ref`` and ``swd_rank_bwd_ref`` are
the kernels' plain versions.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build


def swd_sessions_ref(z, dirs, prior_q):
    """Plain version: z (S, W, d), dirs (M, d), prior_q (W, M) -> (S,)."""
    W, M = prior_q.shape
    srt = torch.sort(torch.matmul(z, dirs.T), dim=1, stable=True).values
    return (srt - prior_q).square().sum(dim=(1, 2)) / (W * M)


def swd_sessions(z, dirs, prior_q):
    """Per-session SW² of ``z`` (S, W, d) against the sorted prior
    quantiles ``prior_q`` (W, M) over ``dirs`` (M, d) -> (S,) float32.

    Float32, contiguous inputs on one device, none requiring a gradient.
    A CUDA launch adds one to ``swd_sessions.launches``."""
    build.check_inputs("swd_sessions", z, dirs, prior_q)
    if z.dim() != 3 or dirs.dim() != 2 or prior_q.dim() != 2:
        raise ValueError("swd_sessions takes z (S, W, d), dirs (M, d) and "
                         "prior_q (W, M)")
    S, W, d = z.shape
    M = dirs.shape[0]
    if dirs.shape[1] != d or tuple(prior_q.shape) != (W, M):
        raise ValueError(f"swd_sessions: z {tuple(z.shape)}, dirs "
                         f"{tuple(dirs.shape)}, prior_q "
                         f"{tuple(prior_q.shape)} do not agree")
    if min(S, W, d, M) == 0:
        raise ValueError("swd_sessions needs non-empty inputs")
    if z.device.type == "cpu":
        return swd_sessions_ref(z, dirs, prior_q)
    lib = build.load("swd.cu")
    out = torch.empty(S, dtype=torch.float32, device=z.device)
    with torch.cuda.device(z.device):
        err = lib.swd_sessions_f32(z.data_ptr(), dirs.data_ptr(),
                                   prior_q.data_ptr(), out.data_ptr(), S, W,
                                   d, M, build.stream_of(z))
    build.raise_on_error(lib, "swd", err)
    swd_sessions.launches += 1
    return out


swd_sessions.launches = 0


def rank_of(perm):
    """The inverse of a column-wise sorting permutation (W, M): each row's
    place in its sorted column, int32."""
    W, M = perm.shape
    rows = torch.arange(W, dtype=torch.int32, device=perm.device)
    return torch.empty(W, M, dtype=torch.int32, device=perm.device) \
        .scatter_(0, perm, rows[:, None].expand(W, M).contiguous())


def swd_rank_fwd_ref(x, dirs, prior_q):
    """Plain version of the forward kernel, differentiable in x -> (loss
    (), proj (W, M), rank (W, M) int32), ``rank[i, m]`` the place of row i
    in column m sorted ascending, ties by row index."""
    W, M = prior_q.shape
    proj = x @ dirs.T
    srt, perm = torch.sort(proj, dim=0, stable=True)
    loss = (srt - prior_q).square().sum() / (W * M)
    return loss, proj, rank_of(perm)


def swd_rank_bwd_ref(g, proj, rank, prior_q, dirs):
    """Plain version of the backward kernel, the explicit formula ->
    dx (W, d)."""
    W, M = prior_q.shape
    gp = 2 * g * (proj - prior_q.gather(0, rank.long())) / (W * M)
    return gp @ dirs


def _check_single(name, x, dirs, prior_q):
    if x.dim() != 2 or dirs.dim() != 2 or prior_q.dim() != 2 \
            or dirs.shape[1] != x.shape[1] \
            or tuple(prior_q.shape) != (x.shape[0], dirs.shape[0]):
        raise ValueError(f"{name} takes x (W, d), dirs (M, d) and prior_q "
                         f"(W, M), got {tuple(x.shape)}, "
                         f"{tuple(dirs.shape)}, {tuple(prior_q.shape)}")
    if min(*x.shape, dirs.shape[0]) == 0:
        raise ValueError(f"{name} needs non-empty inputs")


def swd_rank_fwd(x, dirs, prior_q):
    """SW² of one point set ``x`` (W, d) against the sorted prior
    quantiles ``prior_q`` (W, M) over ``dirs`` (M, d) -> ``(loss (),
    proj (W, M), rank (W, M) int32)``.

    Float32, contiguous inputs on one device, none requiring a gradient
    (``swd_single`` is the differentiable entry).  A CUDA launch adds one
    to ``swd_rank_fwd.launches``."""
    build.check_inputs("swd_rank_fwd", x, dirs, prior_q)
    _check_single("swd_rank_fwd", x, dirs, prior_q)
    if x.device.type == "cpu":
        return swd_rank_fwd_ref(x, dirs, prior_q)
    W, d = x.shape
    M = dirs.shape[0]
    lib = build.load("swd.cu")
    partial = torch.empty(M, dtype=torch.float32, device=x.device)
    loss = torch.empty((), dtype=torch.float32, device=x.device)
    proj = torch.empty(W, M, dtype=torch.float32, device=x.device)
    rank = torch.empty(W, M, dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.swd_rank_fwd_f32(x.data_ptr(), dirs.data_ptr(),
                                   prior_q.data_ptr(), loss.data_ptr(),
                                   proj.data_ptr(), rank.data_ptr(),
                                   partial.data_ptr(), W, d, M,
                                   build.stream_of(x))
    build.raise_on_error(lib, "swd", err)
    swd_rank_fwd.launches += 1
    return loss, proj, rank


swd_rank_fwd.launches = 0


def check_rank_bwd(name, g, proj, rank, prior_q, dirs):
    """The backward's checks: float32 (``rank`` int32), contiguous inputs
    on one device that agree in shape, ``g`` one float."""
    build.check_inputs(name, g, proj, prior_q, dirs)
    W, M = prior_q.shape
    if g.numel() != 1 or tuple(proj.shape) != (W, M) \
            or tuple(rank.shape) != (W, M) or dirs.dim() != 2 \
            or dirs.shape[0] != M:
        raise ValueError(f"{name}: g {tuple(g.shape)}, proj "
                         f"{tuple(proj.shape)}, rank {tuple(rank.shape)}, "
                         f"prior_q {tuple(prior_q.shape)}, dirs "
                         f"{tuple(dirs.shape)} do not agree")
    if rank.dtype != torch.int32 or rank.device != g.device \
            or not rank.is_contiguous():
        raise TypeError(f"{name} takes a contiguous int32 rank on the "
                        "inputs' device")


def swd_rank_bwd(g, proj, rank, prior_q, dirs):
    """The gradient of ``swd_rank_fwd``'s loss with respect to x for the
    cotangent ``g`` () -> dx (W, d) float32: ``csrc/hybrid_reg_bwd.cu``
    with its SW half alone.

    Float32 (``rank`` int32), contiguous inputs on one device.  A CUDA
    launch adds one to ``swd_rank_bwd.launches``."""
    check_rank_bwd("swd_rank_bwd", g, proj, rank, prior_q, dirs)
    if g.device.type == "cpu":
        return swd_rank_bwd_ref(g, proj, rank, prior_q, dirs)
    # imported here: kernels.hybrid_reg imports this module
    from repro_torch.kernels.hybrid_reg import launch_bwd
    (W, M), d = prior_q.shape, dirs.shape[1]
    dx = torch.empty(W, d, dtype=torch.float32, device=g.device)
    launch_bwd(dx, g_sw=g, proj=proj, rank=rank, prior_q=prior_q, dirs=dirs,
               B=1, T=W, d=d, M=M)
    swd_rank_bwd.launches += 1
    return dx


swd_rank_bwd.launches = 0


class _SWDSingle(torch.autograd.Function):
    """The CUDA path: both directions are the hand-written kernels; the
    gradient goes to x only (dirs and prior_q are draws)."""

    @staticmethod
    def forward(ctx, x, dirs, prior_q):
        loss, proj, rank = swd_rank_fwd(x.detach(), dirs, prior_q)
        ctx.save_for_backward(proj, rank, prior_q, dirs)
        return loss

    @staticmethod
    def backward(ctx, g):
        proj, rank, prior_q, dirs = ctx.saved_tensors
        return swd_rank_bwd(g.contiguous(), proj, rank, prior_q, dirs), \
            None, None


def swd_single(x, dirs, prior_q):
    """Differentiable SW² of ``x`` (W, d) against ``prior_q`` (W, M) over
    ``dirs`` (M, d) -> () float32, the gradient flowing to ``x`` through
    the sort.  ``dirs`` and ``prior_q`` must not require a gradient."""
    if dirs.requires_grad or prior_q.requires_grad:
        raise ValueError("swd_single differentiates x only: pass dirs and "
                         "prior_q that do not require a gradient")
    if x.device.type == "cpu":
        _check_single("swd_single", x, dirs, prior_q)
        return swd_rank_fwd_ref(x, dirs, prior_q)[0]
    return _SWDSingle.apply(x, dirs, prior_q)
