"""Asymmetric INT8 post-training quantization (paper §5): the wire format
of the split link.  Per-tensor granularity, calibration-free (min/max of
the tensor being shipped).

Port of ``repro.quant.int8``.  The reference writes the scale as
``(hi - lo) / 255``, and XLA folds that division by a constant into a
multiply by ``float32(1/255)`` (``0x3B808081``).  The port multiplies by
the same constant, so its levels equal the reference's bit for bit; an
IEEE division by 255 would land one level apart in some elements.  The
two divisions by ``scale`` are tensor by tensor and stay IEEE, as XLA
keeps them.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

QMIN, QMAX = -128, 127
# float32(1/255), the constant XLA multiplies by in place of "/ 255"
INV_255 = float(np.float32(1.0 / 255.0))
SCALE_FLOOR = 1e-12


class QTensor(NamedTuple):
    q: torch.Tensor        # int8 payload
    scale: torch.Tensor    # () f32
    zero: torch.Tensor     # () f32  (asymmetric zero point, float for exactness)

    @property
    def wire_bytes(self):
        return self.q.numel() + 8  # payload + scale/zero header


def scale_zero(lo, hi):
    """The affine constants for a range [lo, hi] (any broadcastable
    shape): scale = max((hi − lo)·float32(1/255), 1e-12) and
    zero = −128 − lo/scale."""
    scale = torch.clamp_min((hi - lo) * INV_255, SCALE_FLOOR)
    return scale, QMIN - lo / scale


def levels(x, scale, zero):
    """clip(round_half_even(x/scale + zero), −128, 127) as float32."""
    return torch.clamp(torch.round(x / scale + zero), QMIN, QMAX)


def quantize(x) -> QTensor:
    """Asymmetric affine quantization to int8 (per tensor)."""
    x = x.to(torch.float32)
    scale, zero = scale_zero(x.amin(), x.amax())
    return QTensor(q=levels(x, scale, zero).to(torch.int8), scale=scale,
                   zero=zero)


def dequantize(t: QTensor, dtype=torch.float32):
    return ((t.q.to(torch.float32) - t.zero) * t.scale).to(dtype)
