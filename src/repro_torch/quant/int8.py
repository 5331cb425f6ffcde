"""Asymmetric INT8 post-training quantization (paper §5): the wire format
of the split link.  Per-tensor granularity, calibration-free (min/max of
the tensor being shipped).

Port of ``repro.quant.int8``.  The reference writes the scale as
``(hi - lo) / (qmax - qmin)``, and XLA folds that division by a constant
into a multiply by its float32 reciprocal at every width (at 8 bits
``float32(1/255)``, ``0x3B808081``).  The port multiplies by the same
constant, so its levels equal the reference's bit for bit; an IEEE
division would land one level apart in some elements.  The two divisions
by ``scale`` are tensor by tensor and stay IEEE, as XLA keeps them.

Widths above 8 bits are refused: the levels would not fit the int8
payload, and what XLA's out-of-range float-to-int8 conversion gives them
is no contract.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

QMIN, QMAX = -128, 127
SCALE_FLOOR = 1e-12


def qrange(bits=8):
    """-> (qmin, qmax, float32(1 / (qmax − qmin))) of a ``bits``-wide
    signed level, 1 <= bits <= 8."""
    if not 1 <= bits <= 8:
        raise ValueError(f"quantize: bits={bits} is outside 1..8, the "
                         "widths an int8 payload holds")
    qmin, qmax = -(1 << (bits - 1)), (1 << (bits - 1)) - 1
    return qmin, qmax, float(np.float32(1.0 / (qmax - qmin)))


# float32(1/255), the constant XLA multiplies by in place of "/ 255"
INV_255 = qrange(8)[2]


class QTensor(NamedTuple):
    q: torch.Tensor        # int8 payload
    scale: torch.Tensor    # () f32
    zero: torch.Tensor     # () f32  (asymmetric zero point, float for exactness)

    @property
    def wire_bytes(self):
        return self.q.numel() + 8  # payload + scale/zero header


def scale_zero(lo, hi, bits=8):
    """The affine constants for a range [lo, hi] (any broadcastable
    shape): scale = max((hi − lo)·float32(1/(qmax − qmin)), 1e-12) and
    zero = qmin − lo/scale."""
    qmin, _, inv = qrange(bits)
    scale = torch.clamp_min((hi - lo) * inv, SCALE_FLOOR)
    return scale, qmin - lo / scale


def levels(x, scale, zero, bits=8):
    """clip(round_half_even(x/scale + zero), qmin, qmax) as float32."""
    qmin, qmax, _ = qrange(bits)
    return torch.clamp(torch.round(x / scale + zero), qmin, qmax)


def quantize(x, *, bits=8) -> QTensor:
    """Asymmetric affine quantization to int8 (per tensor), with levels
    ``bits`` wide (1..8)."""
    x = x.to(torch.float32)
    scale, zero = scale_zero(x.amin(), x.amax(), bits)
    return QTensor(q=levels(x, scale, zero, bits).to(torch.int8),
                   scale=scale, zero=zero)


def dequantize(t: QTensor, dtype=torch.float32):
    return ((t.q.to(torch.float32) - t.zero) * t.scale).to(dtype)


def fake_quant(x):
    """quantize∘dequantize in the graph, straight-through: the value is
    the round trip's, the gradient the identity's."""
    y = dequantize(quantize(x), x.dtype)
    return x + (y - x).detach()


def quant_error(x):
    """max |x − dequantize(quantize(x))|."""
    return (x - dequantize(quantize(x), x.dtype)).abs().max()
