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
    per_block = lib.swd_dirs_per_block()
    partial = torch.empty(S * (-(-M // per_block)), dtype=torch.float32,
                          device=z.device)
    out = torch.empty(S, dtype=torch.float32, device=z.device)
    with torch.cuda.device(z.device):
        err = lib.swd_sessions_f32(z.data_ptr(), dirs.data_ptr(),
                                   prior_q.data_ptr(), partial.data_ptr(),
                                   out.data_ptr(), S, W, d, M,
                                   build.stream_of(z))
    build.raise_on_error(lib, "swd", err)
    swd_sessions.launches += 1
    return out


swd_sessions.launches = 0
