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
