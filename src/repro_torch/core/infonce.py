"""Contrastive objectives: streaming InfoNCE (paper Eq. 10) and the
large-batch InfoNCE the server uses as L_task.

Port of ``repro.core.infonce``, plain PyTorch: ``cosine``,
``streaming_infonce`` and ``batch_infonce``.  The edge objective
``infonce_with_virtual_negatives`` comes with the edge slice, with its
kernel (``infonce_vneg``) and the GMM's virtual negatives.
"""
from __future__ import annotations

import torch


def _unit(x):
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp_min(
        1e-9)


def cosine(a, b):
    return (_unit(a) * _unit(b)).sum(-1)


def streaming_infonce(z, z_pos, z_neg, *, tau=0.1):
    """Eq. 10.  z, z_pos: (B, d); z_neg: (B, N_syn, d) virtual negatives.

    -log  exp(s⁺/τ) / (exp(s⁺/τ) + Σ_j exp(s⁻_j/τ))
    """
    pos = cosine(z, z_pos) / tau                                # (B,)
    negs = torch.einsum("bd,bnd->bn", _unit(z).float(), z_neg.float()) / tau
    logits = torch.cat([pos[:, None], negs], dim=1)
    return (torch.logsumexp(logits, dim=1) - pos).mean()


def batch_infonce(z1, z2, *, tau=0.1):
    """Standard NT-Xent over a batch (SimCLR-style, both directions).

    z1, z2: (B, d) two views; needs B > 1."""
    logits = (_unit(z1).float() @ _unit(z2).float().T) / tau
    diag = torch.arange(z1.shape[0], device=z1.device)
    l12 = -torch.log_softmax(logits, dim=1)[diag, diag].mean()
    l21 = -torch.log_softmax(logits, dim=0)[diag, diag].mean()
    return 0.5 * (l12 + l21)
