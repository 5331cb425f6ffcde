"""The split link's INT8 wire: the fused per-row round trip and the
per-tensor quantize and dequantize.

Port of ``repro.kernels.int8_quant``:

- ``wire_roundtrip`` (``wire_roundtrip_pallas``): per-row
  ``quantize∘dequantize`` of a ``(B, ...)`` batch, one row per sample,
  the wire stage of ``SplitEngine.run_batch_async``; kernel
  ``csrc/wire_roundtrip.cu``.
- ``int8_quantize`` / ``int8_dequantize`` (``int8_quantize_pallas``,
  ``int8_dequantize_pallas``): one scale and zero for the whole tensor,
  the wire format of ``SplitEngine.run``; the int8 payload and its
  8-byte (scale, zero) header are materialised on the device, as the
  edge ships them.  Kernels in ``csrc/int8_quant.cu``.

Each public wrapper dispatches on its input's device.  On a CUDA tensor
it launches its hand-written kernel or raises; on a CPU tensor it runs
its ``*_ref``, the plain PyTorch version, which is also what the kernel
is held against bitwise on the card.  Each wrapper counts its launches
in ``<wrapper>.launches`` (one a call: ``int8_quantize``'s call is one
kernel launch up to ``ONE_BLOCK_MAX`` elements, two passes above it;
``quantize_plan`` says which).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.quant.int8 import (QTensor, dequantize, levels,
                                   quantize, scale_zero)


def wire_roundtrip_ref(x):
    """Plain per-row ``dequantize(quantize(row))`` over the leading
    (batch) dim -> float32, same shape as ``x``.  At B=1 it equals the
    per-tensor ``quant.int8`` round trip.

    It dequantizes the level as the int8 payload holds it: a NaN level
    (the +inf element of a row whose scale is +inf) converts to 0, as
    XLA's float-to-int8 conversion gives it, so that element comes back
    +inf where the reference's does."""
    B = x.shape[0]
    flat = x.reshape(B, -1).to(torch.float32)
    scale, zero = scale_zero(flat.amin(dim=1, keepdim=True),
                             flat.amax(dim=1, keepdim=True))
    q = torch.nan_to_num(levels(flat, scale, zero), nan=0.0)
    return ((q - zero) * scale).reshape(x.shape)


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


# the plain versions of the per-tensor kernels ARE the port's
# ``quant.int8`` quantize and dequantize
int8_quantize_ref = quantize
int8_dequantize_ref = dequantize


# csrc/int8_quant.cu: one block of up to 1,024 threads holds n <=
# ONE_BLOCK_MAX elements, 16 a thread, and quantizes them in one launch;
# above that, two passes whose scratch is (lo, hi) for at most kMaxBlocks
# (1,024) blocks
ONE_BLOCK_MAX = 1024 * 16
_PARTIALS = 2 * 1024


def quantize_plan(n):
    """-> (kernel launches, scratch floats) of ``int8_quantize``'s call on
    ``n`` elements: one launch and no scratch up to ``ONE_BLOCK_MAX``, two
    passes over (lo, hi) partials above it."""
    return (1, 0) if n <= ONE_BLOCK_MAX else (2, _PARTIALS)


def _non_empty(name, x):
    if x.numel() == 0:
        raise ValueError(f"{name} needs a non-empty tensor")


def int8_quantize(x) -> QTensor:
    """Per-tensor INT8 quantize of ``x`` (any shape, taken flat) ->
    ``QTensor(q int8 like x, scale () f32, zero () f32)``.

    A CUDA tensor must be contiguous float32: the kernel (one block up to
    ``ONE_BLOCK_MAX`` elements, else two passes with no host round trip
    between them) runs on the current stream, and scale and zero stay on
    the device.  A CPU tensor goes to ``int8_quantize_ref``."""
    if x.device.type == "cpu":
        return int8_quantize_ref(x)
    build.check_inputs("int8_quantize", x)
    _non_empty("int8_quantize", x)
    lib = build.load("int8_quant.cu")
    n = x.numel()
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    sz = torch.empty(2, dtype=torch.float32, device=x.device)
    _, scratch = quantize_plan(n)
    partials = (torch.empty(scratch, dtype=torch.float32, device=x.device)
                if scratch else None)
    with torch.cuda.device(x.device):
        err = lib.int8_quantize_f32(
            x.data_ptr(), q.data_ptr(),
            None if partials is None else partials.data_ptr(),
            sz.data_ptr(), n, build.stream_of(x))
    build.raise_on_error(lib, "int8_quant", err)
    int8_quantize.launches += 1
    return QTensor(q=q, scale=sz[0], zero=sz[1])


def int8_dequantize(qt: QTensor, dtype=torch.float32):
    """``(q − zero) · scale`` of a per-tensor ``QTensor`` -> ``dtype``
    (the kernel writes float32; another ``dtype`` is a cast after it).

    On the card ``q`` must be contiguous int8 and ``scale``/``zero``
    float32 scalars on its device: the kernel reads them from device
    memory.  A ``q`` on the CPU goes to ``int8_dequantize_ref``."""
    q = qt.q
    if q.device.type == "cpu":
        return int8_dequantize_ref(qt, dtype)
    build.check_inputs("int8_dequantize", q, dtype=torch.int8)
    _non_empty("int8_dequantize", q)
    for name, v in (("scale", qt.scale), ("zero", qt.zero)):
        if (v.device != q.device or v.dtype != torch.float32
                or v.numel() != 1):
            raise ValueError(f"int8_dequantize: {name} must be one float32 "
                             f"on {q.device}, got {v.dtype} {tuple(v.shape)}"
                             f" on {v.device}")
    lib = build.load("int8_quant.cu")
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = lib.int8_dequantize_f32(q.data_ptr(), qt.scale.data_ptr(),
                                      qt.zero.data_ptr(), out.data_ptr(),
                                      q.numel(), build.stream_of(q))
    build.raise_on_error(lib, "int8_quant", err)
    int8_dequantize.launches += 1
    return out if dtype == torch.float32 else out.to(dtype)


int8_quantize.launches = 0
int8_dequantize.launches = 0
