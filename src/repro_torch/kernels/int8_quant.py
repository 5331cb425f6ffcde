"""The split link's INT8 wire: the fused per-row round trip and the
per-tensor quantize and dequantize.

Port of ``repro.kernels.int8_quant``:

- ``wire_roundtrip_grouped`` (``wire_roundtrip_pallas``): per-row
  ``quantize∘dequantize`` of several ``(B_g, ...)`` batches of different
  widths in one launch, one row per sample: the serving tick's wire
  stage, all its k-buckets at once (``SplitEngine.run_buckets_async``);
  ``wire_roundtrip`` is its one-batch call (``run_batch_async``).
  Kernel ``csrc/wire_roundtrip.cu``.
- ``int8_quantize`` / ``int8_dequantize`` (``int8_quantize_pallas``,
  ``int8_dequantize_pallas``): one scale and zero for the whole tensor;
  the int8 payload and its 8-byte (scale, zero) header are materialised
  on the device, as the edge ships them.  ``int8_quantize_roundtrip``
  writes the payload, the header and their dequantized values in the
  quantize's one launch: the wire of ``SplitEngine.run``.  Kernels in
  ``csrc/int8_quant.cu``.

Each public wrapper dispatches on its input's device.  On a CUDA tensor
it launches its hand-written kernel or raises; on a CPU tensor it runs
its ``*_ref``, the plain PyTorch version, which is also what the kernel
is held against bitwise on the card.  Each wrapper counts its launches
in ``<wrapper>.launches`` (one a call: ``int8_quantize``'s call is one
kernel launch up to ``ONE_BLOCK_MAX`` elements, two passes above it;
``quantize_plan`` says which; the round trip's likewise).
"""
from __future__ import annotations

import ctypes
import math

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
    flat = x.reshape(B, math.prod(x.shape[1:])).to(torch.float32)
    scale, zero = scale_zero(flat.amin(dim=1, keepdim=True),
                             flat.amax(dim=1, keepdim=True))
    q = torch.nan_to_num(levels(flat, scale, zero), nan=0.0)
    return ((q - zero) * scale).reshape(x.shape)


def wire_roundtrip_grouped_ref(xs):
    """The plain grouped wire: ``wire_roundtrip_ref`` of each tensor."""
    return [wire_roundtrip_ref(x) for x in xs]


# csrc/wire_roundtrip.cu: a launch's group table, passed to the kernel by
# value; its layout mirrors the source's Group and GroupTable
MAX_GROUPS = 16


class _Group(ctypes.Structure):
    _fields_ = [("x", ctypes.c_void_p), ("out", ctypes.c_void_p),
                ("rows", ctypes.c_int), ("n", ctypes.c_int),
                ("first_block", ctypes.c_int), ("pad", ctypes.c_int)]


class _GroupTable(ctypes.Structure):
    _fields_ = [("g", _Group * MAX_GROUPS), ("count", ctypes.c_int)]


def group_plan(shapes):
    """The grouped wire's launch plan for tensors of ``shapes`` (each
    ``(B, ...)``) -> ``(slots, blocks)``: for each group with rows, in
    order, ``(index in shapes, rows, n, first block)``, one block a row
    and a group's blocks consecutive; and the launch's blocks.  A group
    with no rows takes no slot and no block; more than ``MAX_GROUPS``
    groups with rows, or a row of no elements, raise."""
    slots, blocks = [], 0
    for i, shape in enumerate(shapes):
        if len(shape) < 1:
            raise ValueError(f"wire_roundtrip: group {i} has no batch dim")
        rows = shape[0]
        if rows == 0:
            continue
        n = math.prod(shape[1:])
        if n == 0:
            raise ValueError(f"wire_roundtrip: group {i}'s rows are empty, "
                             f"shape {tuple(shape)}")
        if n >= 2 ** 31:
            raise ValueError(f"wire_roundtrip: group {i}: n={n} exceeds "
                             "int32")
        slots.append((i, rows, n, blocks))
        blocks += rows
    if len(slots) > MAX_GROUPS:
        raise ValueError(f"wire_roundtrip_grouped: {len(slots)} groups, at "
                         f"most {MAX_GROUPS} a launch")
    if blocks >= 2 ** 31:
        raise ValueError(f"wire_roundtrip: {blocks} rows exceed int32")
    return slots, blocks


def _check_wire_input(x):
    if x.device.type != "cuda":
        raise ValueError(f"wire_roundtrip: no kernel for device {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"wire_roundtrip kernel takes float32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("wire_roundtrip kernel takes a contiguous tensor")


def wire_roundtrip(x):
    """Fused per-row INT8 wire round trip of one ``(B, ...)`` batch — the
    wire stage of ``SplitEngine.run_batch_async``: the grouped kernel's
    launch of one group.

    A CUDA tensor must be contiguous float32 with a batch dim; the kernel
    runs on the current stream and ``wire_roundtrip.launches`` counts
    each launch.  A CPU tensor goes to ``wire_roundtrip_ref``.  Any other
    device raises."""
    if x.device.type == "cpu":
        return wire_roundtrip_ref(x)
    _check_wire_input(x)
    if x.dim() < 1 or x.numel() == 0:
        raise ValueError(f"wire_roundtrip needs a non-empty (B, ...) tensor, "
                         f"got shape {tuple(x.shape)}")
    slots, _ = group_plan([x.shape])
    _, rows, n, _ = slots[0]
    lib = build.load("wire_roundtrip.cu")
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = lib.wire_roundtrip_f32(x.data_ptr(), out.data_ptr(), rows, n,
                                     build.stream_of(x))
    build.raise_on_error(lib, "wire_roundtrip", err)
    wire_roundtrip.launches += 1
    return out


def wire_roundtrip_grouped(xs):
    """Per-row INT8 wire round trip of each of ``xs`` (a list of ``(B_g,
    ...)`` tensors of any widths) -> the list of outputs, in ONE kernel
    launch: the serving tick's wire stage over all its k-buckets.

    On the card each tensor must be contiguous float32 on one device; at
    most ``MAX_GROUPS`` of them may have rows (``group_plan``), and
    ``wire_roundtrip_grouped.launches`` counts each launch (none when no
    tensor has rows).  The group table goes to the kernel by value.  CPU
    tensors go to ``wire_roundtrip_grouped_ref``."""
    xs = list(xs)
    if not xs:
        return []
    dev = xs[0].device
    if any(x.device != dev for x in xs):
        raise ValueError("wire_roundtrip_grouped: inputs on "
                         f"{sorted({str(x.device) for x in xs})}")
    if dev.type == "cpu":
        return wire_roundtrip_grouped_ref(xs)
    for x in xs:
        _check_wire_input(x)
    slots, _ = group_plan([x.shape for x in xs])
    outs = [torch.empty_like(x) for x in xs]
    if not slots:
        return outs
    table = _GroupTable(count=len(slots))
    for s, (i, rows, n, first) in enumerate(slots):
        table.g[s] = _Group(xs[i].data_ptr(), outs[i].data_ptr(), rows, n,
                            first, 0)
    lib = build.load("wire_roundtrip.cu")
    with torch.cuda.device(dev):
        err = lib.wire_roundtrip_grouped_f32(ctypes.byref(table),
                                             build.stream_of(xs[0]))
    build.raise_on_error(lib, "wire_roundtrip", err)
    wire_roundtrip_grouped.launches += 1
    return outs


wire_roundtrip.launches = 0
wire_roundtrip_grouped.launches = 0


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


def int8_quantize_roundtrip_ref(x):
    """The plain round trip: ``(quantize(x), dequantize(quantize(x)))``."""
    qt = int8_quantize_ref(x)
    return qt, int8_dequantize_ref(qt)


def int8_quantize_roundtrip(x):
    """Per-tensor INT8 quantize of ``x`` and its dequantized values ->
    ``(QTensor, out float32 like x)``, in ``int8_quantize``'s launch (one
    up to ``ONE_BLOCK_MAX`` elements, two passes above): the payload and
    its header are still written, as the edge ships them, and ``out`` is
    what the server reads back from them — the wire of
    ``SplitEngine.run``.  Bitwise ``int8_dequantize(int8_quantize(x))``.

    A CUDA tensor must be contiguous float32; a CPU tensor goes to
    ``int8_quantize_roundtrip_ref``."""
    if x.device.type == "cpu":
        return int8_quantize_roundtrip_ref(x)
    build.check_inputs("int8_quantize_roundtrip", x)
    _non_empty("int8_quantize_roundtrip", x)
    lib = build.load("int8_quant.cu")
    n = x.numel()
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    out = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    sz = torch.empty(2, dtype=torch.float32, device=x.device)
    _, scratch = quantize_plan(n)
    partials = (torch.empty(scratch, dtype=torch.float32, device=x.device)
                if scratch else None)
    with torch.cuda.device(x.device):
        err = lib.int8_quantize_roundtrip_f32(
            x.data_ptr(), q.data_ptr(), out.data_ptr(),
            None if partials is None else partials.data_ptr(),
            sz.data_ptr(), n, build.stream_of(x))
    build.raise_on_error(lib, "int8_quant", err)
    int8_quantize_roundtrip.launches += 1
    return QTensor(q=q, scale=sz[0], zero=sz[1]), out


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
int8_quantize_roundtrip.launches = 0
int8_dequantize.launches = 0
