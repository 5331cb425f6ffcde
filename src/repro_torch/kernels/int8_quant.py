"""The split link's fused INT8 wire stage.

Port of ``repro.kernels.int8_quant.wire_roundtrip_pallas``: per-row
``quantize∘dequantize`` of a ``(B, ...)`` batch, one row per sample.
``wire_roundtrip`` is the public wrapper.  On a CUDA tensor it launches
the hand-written kernel ``csrc/wire_roundtrip.cu`` or raises; on a CPU
tensor it runs ``wire_roundtrip_ref``, the plain PyTorch version, which
is also what the kernel is held against bitwise on the card.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.quant.int8 import levels, scale_zero


def wire_roundtrip_ref(x):
    """Plain per-row ``dequantize(quantize(row))`` over the leading
    (batch) dim -> float32, same shape as ``x``.  At B=1 it equals the
    per-tensor ``quant.int8`` round trip."""
    B = x.shape[0]
    flat = x.reshape(B, -1).to(torch.float32)
    scale, zero = scale_zero(flat.amin(dim=1, keepdim=True),
                             flat.amax(dim=1, keepdim=True))
    return ((levels(flat, scale, zero) - zero) * scale).reshape(x.shape)


def wire_roundtrip(x):
    """Fused per-row INT8 wire round trip — the wire stage of
    ``SplitEngine.run_batch_async``.

    A CUDA tensor must be contiguous float32 with a batch dim; the kernel
    runs on the current stream and ``wire_roundtrip.launches`` counts
    each launch.  A CPU tensor goes to ``wire_roundtrip_ref``.  Any other
    device raises."""
    if x.device.type == "cpu":
        return wire_roundtrip_ref(x)
    if x.device.type != "cuda":
        raise ValueError(f"wire_roundtrip: no kernel for device {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"wire_roundtrip kernel takes float32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("wire_roundtrip kernel takes a contiguous tensor")
    if x.dim() < 1 or x.numel() == 0:
        raise ValueError(f"wire_roundtrip needs a non-empty (B, ...) tensor, "
                         f"got shape {tuple(x.shape)}")
    rows = x.shape[0]
    n = x.numel() // rows
    if n >= 2 ** 31 or rows >= 2 ** 31:
        raise ValueError(f"wire_roundtrip: rows={rows}, n={n} exceed int32")
    lib = build.load("wire_roundtrip.cu")
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.wire_roundtrip_f32(x.data_ptr(), out.data_ptr(), rows, n,
                                     stream)
    if err:
        raise RuntimeError("wire_roundtrip launch failed: "
                           + lib.wire_roundtrip_error_string(err).decode())
    wire_roundtrip.launches += 1
    return out


wire_roundtrip.launches = 0
