"""The GMM memory's posterior and entropy.

Port of ``repro.kernels.gmm_posterior.gmm_posterior_pallas``:
``gmm_posterior(z, mu, var, logpi)`` -> ``(resp (B, C), ent (B,))``, the
responsibilities p(c | z) of a diagonal GMM and their entropy in nats.
The Mahalanobis term is the direct ``Σ (z − mu)² / var`` of the refine
path's reference (``gmm.log_joint``).

``gmm_posterior`` is the public wrapper.  On a CUDA tensor it launches
the hand-written kernels of ``csrc/gmm_posterior.cu`` (a Mahalanobis pass
spread over the card, then a softmax pass: one call, one launch counted)
or raises; on a CPU tensor it runs ``gmm_posterior_ref``, the plain
PyTorch version, which is also what the kernel is held against on the
card.  Neither takes a gradient.  z is float32 or bf16 (``Z_DTYPES``),
as the reference's kernel takes it, under float32 mu, var and logpi: the
kernel reads a bf16 z as it is and widens it to float32 (exact), the plain
version upcasts it first, so a bf16 z gives the bits of the float32 call
on the widened z.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import build

LOG2PI = 1.8378770664093453
# rows of z per step of the plain version: its (rows, C, d) intermediate
# stays at 128 MB for C=64, d=128 however long the batch is
_REF_ROWS = 4096
Z_DTYPES = (torch.float32, torch.bfloat16)


def log_joint(z, mu, var, logpi):
    """log pi_c + log N(z; mu_c, diag var_c) -> (B, C), Mahalanobis in
    the direct form."""
    maha = ((z[:, None, :] - mu[None]).square() / var[None]).sum(-1)
    logdet = torch.log(var).sum(-1)
    return logpi[None] - 0.5 * (maha + logdet + z.shape[-1] * LOG2PI)


def gmm_posterior_ref(z, mu, var, logpi):
    """Plain version: z (B, d), mu and var (C, d), logpi (C,) ->
    (resp (B, C), ent (B,)); a bf16 z is upcast first."""
    z = z.float()
    resp, ent = [], []
    for z_i in torch.split(z, _REF_ROWS):
        lj = log_joint(z_i, mu, var, logpi)
        shifted = lj - lj.amax(-1, keepdim=True)
        e = torch.exp(shifted)
        s = e.sum(-1, keepdim=True)
        p = e / s
        resp.append(p)
        ent.append(-(p * (shifted - torch.log(s))).sum(-1))
    return torch.cat(resp), torch.cat(ent)


def gmm_posterior(z, mu, var, logpi):
    """Posterior responsibilities and entropy of ``z`` (B, d) under the
    diagonal GMM ``(mu, var, logpi)`` -> ``(resp (B, C), ent (B,))``
    float32.

    z float32 or bf16, mu, var and logpi float32; contiguous, on one
    device, none requiring a gradient.  A CUDA launch adds one to
    ``gmm_posterior.launches``."""
    dt = build.input_dtype("gmm_posterior", z, Z_DTYPES)
    f32 = torch.float32
    build.check_inputs("gmm_posterior", z, mu, var, logpi,
                       dtype=(dt, f32, f32, f32))
    if z.dim() != 2 or mu.dim() != 2 or tuple(var.shape) != tuple(mu.shape) \
            or tuple(logpi.shape) != (mu.shape[0],) \
            or mu.shape[1] != z.shape[1]:
        raise ValueError(f"gmm_posterior takes z (B, d), mu and var (C, d), "
                         f"logpi (C,), got {tuple(z.shape)}, "
                         f"{tuple(mu.shape)}, {tuple(var.shape)}, "
                         f"{tuple(logpi.shape)}")
    B, d = z.shape
    C = mu.shape[0]
    if min(B, C, d) == 0:
        raise ValueError("gmm_posterior needs non-empty inputs")
    if z.device.type == "cpu":
        return gmm_posterior_ref(z, mu, var, logpi)
    lib = build.load("gmm_posterior.cu")
    resp = torch.empty(B, C, dtype=torch.float32, device=z.device)
    ent = torch.empty(B, dtype=torch.float32, device=z.device)
    with torch.cuda.device(z.device):
        # the per-split partials of the Mahalanobis pass (its plan depends
        # on the shape and the card)
        scratch = torch.empty(lib.gmm_posterior_scratch_floats(B, C, d),
                              dtype=torch.float32, device=z.device)
        err = getattr(lib, f"gmm_posterior_{build.SUFFIX[dt]}")(
            z.data_ptr(), mu.data_ptr(), var.data_ptr(), logpi.data_ptr(),
            resp.data_ptr(), ent.data_ptr(), scratch.data_ptr(), B, C, d,
            float(np.float32(d * LOG2PI)), build.stream_of(z))
    build.raise_on_error(lib, "gmm_posterior", err)
    gmm_posterior.launches += 1
    return resp, ent


gmm_posterior.launches = 0
