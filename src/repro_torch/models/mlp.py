"""Feed-forward blocks: gated (SwiGLU/GeGLU) and plain (squared-ReLU etc.).

Port of ``repro.models.mlp``."""
from __future__ import annotations

import math

import torch

from repro_torch.models.common import activation, apply_dense, dense_init


def init_mlp(generator, d_model, d_ff, *, gated=True, dtype=torch.float32,
             with_axes=False):
    params, axes = {}, {}
    params["w_up"], axes["w_up"] = dense_init(
        generator, (d_model, d_ff), ("embed", "mlp"), dtype=dtype)
    if gated:
        params["w_gate"], axes["w_gate"] = dense_init(
            generator, (d_model, d_ff), ("embed", "mlp"), dtype=dtype)
    params["w_down"], axes["w_down"] = dense_init(
        generator, (d_ff, d_model), ("mlp", "embed"), dtype=dtype,
        scale=1.0 / math.sqrt(d_ff))
    return (params, axes) if with_axes else params


def apply_mlp(p, x, *, act="silu"):
    fn = activation(act)
    up = apply_dense(p["w_up"], x)
    if "w_gate" in p:
        h = fn(apply_dense(p["w_gate"], x)) * up
    else:
        h = fn(up)
    return apply_dense(p["w_down"], h)


def apply_mlp_sharded(lay, ps, xs, *, act="silu"):
    """``apply_mlp`` on a mesh: shard s holds the column blocks of
    ``w_up``/``w_gate`` and the row block of ``w_down`` ('mlp' over
    'model'), so ``apply_mlp`` on its block is its partial product; the
    partials are psum'd over 'model' -> each shard's output, whole over
    'model'."""
    return lay.psum_model([apply_mlp(p, x, act=act)
                           for p, x in zip(ps, xs)])
