"""Public kernel wrappers, plus the device and precision set-up every
entry point goes through.

Counterpart of ``repro.kernels.ops``.  The reference switches between
compiled and interpreted Pallas with an environment variable; the port
has no such switch.  Each wrapper dispatches on its input's device: a
CUDA tensor launches the hand-written kernel (or the wrapper raises), a
CPU tensor runs the kernel's plain PyTorch version.

The reference computes in float32, so ``resolve_device`` turns TF32 off
for cuDNN convolutions and for matrix products (cuDNN convolutions use
TF32 by default, which keeps about three decimal digits), and pins
cuDNN to deterministic algorithms with autotuning off, so the same
shapes give the same bits from run to run.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import (
    flash_attention, flash_attention_bwd_dkv, flash_attention_bwd_dkv_ref,
    flash_attention_bwd_dq, flash_attention_bwd_dq_ref, flash_attention_fwd,
    flash_attention_ref)
from repro_torch.kernels.gmm_posterior import gmm_posterior, gmm_posterior_ref
from repro_torch.kernels.hybrid_reg import (hybrid_reg_bwd, hybrid_reg_bwd_ref,
                                            hybrid_regularisers)
from repro_torch.kernels.infonce_vneg import (infonce_vneg, infonce_vneg_bwd,
                                              infonce_vneg_bwd_ref,
                                              infonce_vneg_fwd,
                                              infonce_vneg_fwd_ref,
                                              infonce_vneg_ref)
from repro_torch.kernels.int8_quant import (
    int8_dequantize, int8_dequantize_ref, int8_quantize, int8_quantize_ref,
    int8_quantize_roundtrip, int8_quantize_roundtrip_ref, wire_roundtrip,
    wire_roundtrip_grouped, wire_roundtrip_grouped_ref, wire_roundtrip_ref)
from repro_torch.kernels.laplacian_energy import (laplacian_energy,
                                                  laplacian_energy_bwd,
                                                  laplacian_energy_bwd_ref,
                                                  laplacian_energy_diff,
                                                  laplacian_energy_ref)
from repro_torch.kernels.swd import (swd_rank_bwd, swd_rank_bwd_ref,
                                     swd_rank_fwd, swd_rank_fwd_ref,
                                     swd_sessions, swd_sessions_ref,
                                     swd_single)

__all__ = ["KERNELS", "resolve_device", "set_precision",
           "wire_roundtrip", "wire_roundtrip_ref", "wire_roundtrip_grouped",
           "wire_roundtrip_grouped_ref",
           "int8_quantize", "int8_quantize_ref", "int8_quantize_roundtrip",
           "int8_quantize_roundtrip_ref", "int8_dequantize",
           "int8_dequantize_ref",
           "swd_sessions",
           "swd_sessions_ref", "laplacian_energy", "laplacian_energy_ref",
           "gmm_posterior", "gmm_posterior_ref", "infonce_vneg",
           "infonce_vneg_ref", "infonce_vneg_fwd", "infonce_vneg_fwd_ref",
           "infonce_vneg_bwd", "infonce_vneg_bwd_ref", "swd_single",
           "swd_rank_fwd", "swd_rank_fwd_ref",
           "swd_rank_bwd", "swd_rank_bwd_ref", "laplacian_energy_diff",
           "laplacian_energy_bwd", "laplacian_energy_bwd_ref",
           "hybrid_reg_bwd", "hybrid_reg_bwd_ref", "hybrid_regularisers",
           "flash_attention_fwd", "flash_attention_ref", "flash_attention",
           "flash_attention_bwd_dq", "flash_attention_bwd_dq_ref",
           "flash_attention_bwd_dkv", "flash_attention_bwd_dkv_ref"]

# every hand-written kernel's wrapper (each carries ``launches``), the
# backward kernels too; the differentiable entries (``infonce_vneg``,
# ``swd_single``, ``laplacian_energy_diff``, ``hybrid_regularisers``,
# ``flash_attention``) launch through these.  ``swd_rank_bwd`` and
# ``laplacian_energy_bwd`` launch ``hybrid_reg_bwd``'s kernel with one half,
# counted on their own wrappers
KERNELS = {"wire_roundtrip": wire_roundtrip,
           "wire_roundtrip_grouped": wire_roundtrip_grouped,
           "int8_quantize": int8_quantize,
           "int8_quantize_roundtrip": int8_quantize_roundtrip,
           "int8_dequantize": int8_dequantize,
           "swd_sessions": swd_sessions,
           "laplacian_energy": laplacian_energy,
           "gmm_posterior": gmm_posterior,
           "infonce_vneg_fwd": infonce_vneg_fwd,
           "infonce_vneg_bwd": infonce_vneg_bwd,
           "swd_rank_fwd": swd_rank_fwd,
           "swd_rank_bwd": swd_rank_bwd,
           "laplacian_energy_bwd": laplacian_energy_bwd,
           "hybrid_reg_bwd": hybrid_reg_bwd,
           "flash_attention_fwd": flash_attention_fwd,
           "flash_attention_bwd_dq": flash_attention_bwd_dq,
           "flash_attention_bwd_dkv": flash_attention_bwd_dkv}


def set_precision() -> None:
    """float32 everywhere (no TF32) and deterministic cuDNN."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False


def resolve_device(device) -> torch.device:
    """The ``device=`` argument of an entry point as a ``torch.device``.

    A CUDA device without a usable GPU raises: the port never falls back
    to the CPU on its own — a caller that wants the CPU passes
    ``device="cpu"``."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' but torch sees no CUDA device; pass "
                "device='cpu' to run the port's plain PyTorch path")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}: use 'cuda' or 'cpu'")
    set_precision()
    return dev
