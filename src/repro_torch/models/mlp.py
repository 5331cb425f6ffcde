"""Feed-forward blocks: gated (SwiGLU/GeGLU) and plain (squared-ReLU etc.).

Port of ``repro.models.mlp``."""
from __future__ import annotations

import math

import torch

from repro_torch.models.common import activation, apply_dense, dense_init


def init_mlp(generator, d_model, d_ff, *, gated=True, dtype=torch.float32):
    params = {"w_up": dense_init(generator, (d_model, d_ff), dtype=dtype)}
    if gated:
        params["w_gate"] = dense_init(generator, (d_model, d_ff), dtype=dtype)
    params["w_down"] = dense_init(generator, (d_ff, d_model), dtype=dtype,
                                  scale=1.0 / math.sqrt(d_ff))
    return params


def apply_mlp(p, x, *, act="silu"):
    fn = activation(act)
    up = apply_dense(p["w_up"], x)
    if "w_gate" in p:
        h = fn(apply_dense(p["w_gate"], x)) * up
    else:
        h = fn(up)
    return apply_dense(p["w_down"], h)
