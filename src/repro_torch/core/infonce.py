"""Contrastive objectives: streaming InfoNCE (paper Eq. 10) and the
large-batch InfoNCE the server uses as L_task.

Port of ``repro.core.infonce``.  ``streaming_infonce`` goes through the
``infonce_vneg`` kernel (forward and backward on a CUDA tensor, its
plain version under autograd on a CPU tensor); ``infonce_with_virtual_
negatives`` is the edge learner's objective; ``cosine`` and
``batch_infonce`` are plain PyTorch, as their reference is plain jnp.
"""
from __future__ import annotations

import torch

from repro_torch.core import gmm as gmm_mod
from repro_torch.kernels.infonce_vneg import infonce_vneg


def _unit(x):
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp_min(
        1e-9)


def cosine(a, b):
    return (_unit(a) * _unit(b)).sum(-1)


def streaming_infonce(z, z_pos, z_neg, *, tau=0.1):
    """Eq. 10.  z, z_pos: (B, d); z_neg: (B, N_syn, d) virtual negatives.

    -log  exp(s⁺/τ) / (exp(s⁺/τ) + Σ_j exp(s⁻_j/τ))

    s⁺ is ``cosine(z, z_pos)``, the kernel's ``_unit(z)·_unit(z_pos)``;
    the negatives are taken as they are (not normalised), as in the
    reference.
    """
    zn = _unit(z.float()).contiguous()
    zpn = _unit(z_pos.float()).contiguous()
    return infonce_vneg(zn, zpn, z_neg.float().contiguous(), tau).mean()


def infonce_with_virtual_negatives(key, gmm_state, z, z_pos, *, n_syn=256,
                                   tau=0.1, boundary_tau=0.1,
                                   use_batch_negatives=True):
    """The edge objective: sample boundary-aware virtual negatives from the
    GMM, compute Eq. 10, and discard the negatives (no memory bank).

    ``key`` is a ``torch.Generator`` or a ``(gumbel, eps)`` pair
    (``gmm.draw_virtual``).  The virtual negatives carry no gradient.
    ``use_batch_negatives`` appends the other in-batch embeddings (unit
    norm) to each sample's negatives, with gradients flowing through
    them: symmetric repulsion is what keeps the loss collapse-free.  A
    sample's own slot holds ``-z_pos`` (no gradient), an always-easy
    negative."""
    z_neg = gmm_mod.sample_virtual_negatives(
        key, gmm_state, z.detach(), n_syn, tau=boundary_tau).detach()
    if use_batch_negatives:
        B = z.shape[0]
        others = _unit(z)[None].expand(B, B, z.shape[-1])
        eye = torch.eye(B, dtype=torch.bool, device=z.device)[..., None]
        filler = -z_pos.detach()[:, None, :]
        others = torch.where(eye, filler, others)
        z_neg = torch.cat([z_neg, others], dim=1)
    return streaming_infonce(z, z_pos, z_neg, tau=tau)


def batch_infonce(z1, z2, *, tau=0.1):
    """Standard NT-Xent over a batch (SimCLR-style, both directions).

    z1, z2: (B, d) two views; needs B > 1."""
    logits = (_unit(z1).float() @ _unit(z2).float().T) / tau
    diag = torch.arange(z1.shape[0], device=z1.device)
    l12 = -torch.log_softmax(logits, dim=1)[diag, diag].mean()
    l21 = -torch.log_softmax(logits, dim=0)[diag, diag].mean()
    return 0.5 * (l12 + l21)
