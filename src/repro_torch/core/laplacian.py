"""Affinity metric: temporal-graph Dirichlet energy (paper §3.2, Eq.
4/6/14).

Port of ``repro.core.laplacian``.  The temporal graph connects each frame
to its k nearest temporal neighbours (|i−j| ≤ k); a validity mask drops
the edges that touch a missing frame.  ``dirichlet_energy`` on a CPU
tensor is plain PyTorch (differentiable).  On a CUDA tensor without
``weights`` it is ``Σtot / max(Σcnt, 1)`` from the hand-written kernels
(``kernels.laplacian_energy.laplacian_energy_diff``: the forward kernel,
and the backward kernel under autograd); the weighted variant, which no
kernel computes, stays plain.  The refine round reaches the same sums
through the ``laplacian_energy`` kernel.  The dense-graph utilities are
numpy, as in the reference.

Theorem 3.2's bound (Eq. 5) holds only for sparse temporal graphs,
``2k < T``; ``interpolation_error_bound`` warns on a near-complete graph.
"""
from __future__ import annotations

import warnings

import numpy as np
import torch

from repro_torch.kernels.laplacian_energy import laplacian_energy_diff


def dirichlet_energy(z, *, k=5, mask=None, weights=None):
    """(1/|E|) Σ_{(i,j)∈E} w_ij ‖z_i − z_j‖² over the temporal k-window.

    z: (T, d) or (B, T, d); mask: matching (T,)/(B, T) validity
    (1=present)."""
    if z.dim() == 2:
        z = z[None]
        if mask is not None:
            mask = mask[None]
    B, T, _ = z.shape
    z = z.float()
    mask = torch.ones(B, T, device=z.device) if mask is None \
        else mask.float()
    if z.device.type == "cuda" and weights is None:
        tot, cnt = laplacian_energy_diff(z.contiguous(),
                                         mask.detach().contiguous(), k)
        return tot.sum() / cnt.sum().clamp_min(1.0)
    total = torch.zeros((), device=z.device)
    count = torch.zeros((), device=z.device)
    for delta in range(1, min(k, T - 1) + 1):
        w = 1.0 if weights is None else weights[delta - 1]
        diff = z[:, delta:] - z[:, :-delta]
        pair = mask[:, delta:] * mask[:, :-delta]
        total = total + w * (diff.square().sum(-1) * pair).sum()
        count = count + pair.sum()
    return total / count.clamp_min(1.0)


def laplacian_loss(z, *, k=5, mask=None):
    """L_Lap (Eq. 14): the paper's name for ``dirichlet_energy``."""
    return dirichlet_energy(z, k=k, mask=mask)


# ---------------------------------------------------------------------------
# Dense-graph utilities (validation / theorem checks — numpy-scale)
# ---------------------------------------------------------------------------

def temporal_adjacency(T, k=5, mask=None):
    """Dense (T, T) adjacency of the temporal k-window graph."""
    idx = np.arange(T)
    A = (np.abs(idx[:, None] - idx[None, :]) <= k) \
        & (idx[:, None] != idx[None, :])
    A = A.astype(np.float64)
    if mask is not None:
        m = np.asarray(mask, np.float64)
        A = A * m[:, None] * m[None, :]
    return A


def graph_laplacian(A):
    return np.diag(A.sum(1)) - A


def spectral_gap(A):
    """λ₂ of the Laplacian (second-smallest eigenvalue)."""
    return float(np.linalg.eigvalsh(graph_laplacian(A))[1])


def dirichlet_energy_dense(z, A):
    """Tr(ZᵀLZ)/|E| against an explicit adjacency (oracle for tests)."""
    z = np.asarray(z, np.float64)
    e = float(np.trace(z.T @ graph_laplacian(A) @ z))
    n_edges = A.sum()  # directed count = 2|E|; energy double-counts too
    return e / max(n_edges / 1.0, 1.0) * (1.0 if n_edges else 0.0)


def neighbor_average(z, A, t):
    """ẑ_t = weighted neighbour average (Theorem 3.2's reconstruction)."""
    w = A[t]
    return (w @ z) / max(w.sum(), 1e-12)


def interpolation_error_bound(z, A, t):
    """RHS of Eq. 5: 2·α·|E| / (λ₂·|N(t)|) with α = Tr(ZᵀLZ)/|E|.

    Valid only in Theorem 3.2's sparse-graph regime ``2k < T_eff`` (the
    count of frames with any edge); outside it a ``UserWarning`` says the
    returned value is not a bound."""
    z = np.asarray(z, np.float64)
    A = np.asarray(A, np.float64)
    deg = (A > 0).sum(axis=1)
    live = np.where(deg > 0)[0]
    if live.size > 1:
        t_eff = int(live.size)
        k_est = int(deg[live[0]])
        if 2 * k_est >= t_eff:
            warnings.warn(
                "interpolation_error_bound: temporal window k="
                f"{k_est} with T={t_eff} participating frames violates "
                "Theorem 3.2's sparse-graph regime (2k < T); the graph is "
                "near-complete and the returned value is not a valid "
                "bound.", UserWarning, stacklevel=2)
    tr = float(np.trace(z.T @ graph_laplacian(A) @ z)) / 2.0
    n_edges = A.sum() / 2.0
    alpha = tr / max(n_edges, 1e-12)
    return 2.0 * alpha * n_edges / max(spectral_gap(A) * A[t].sum(), 1e-12)
