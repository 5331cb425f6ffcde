"""Split execution engine.

``SplitEngine`` runs the paper's mechanism on the paper's model: blocks
[0, k) as the *edge stage*, the INT8 round trip of the boundary
activation (the wire payload), blocks [k, L) plus the head as the
*server stage*.  Port of ``repro.core.splitter.SplitEngine``; the
reference's pod-axis pipeline ``split_pipeline_podwise`` belongs to the
LM scaffold and is not part of this module yet.

PyTorch runs eagerly, so the reference's lazily built per-k executables
are plain calls here; switching k still happens only between whole
stage calls, never mid-block.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels.int8_quant import wire_roundtrip_ref
from repro_torch.models import audio_encoder as enc


class SplitEngine:
    """Split executor for the audio encoder on one device.

    ``params`` passed to the methods must already live on ``device``
    (``repro_torch.weights.to_device``).  Wire formats, as in the
    reference: ``run`` quantises per tensor (one scale/zero for its whole
    batch), ``run_batch`` and ``run_batch_async`` per sample — identical
    at B=1.  ``run`` goes through the per-tensor quantize and dequantize
    kernels; ``run_batch`` uses the plain per-row round trip, as the
    reference's ``run_batch`` uses its vmapped ``quantize∘dequantize``;
    ``run_batch_async`` uses the wire kernel, held bitwise against it.
    """

    def __init__(self, cfg: enc.AudioEncCfg, *, quantize_wire=True,
                 device="cuda"):
        self.cfg = cfg
        self.quantize_wire = quantize_wire
        self.device = kernel_ops.resolve_device(device)

    def _to_device(self, mel):
        if isinstance(mel, np.ndarray):
            mel = torch.from_numpy(np.asarray(mel, np.float32))
        return mel.to(self.device, torch.float32)

    def _edge_fn(self, k, params, mel):
        if k == 0:
            # k=0 is raw-input offload: the wire carries the model input and
            # the server runs the stem — matches boundary_bytes(cfg)[0].
            return mel
        x = enc.apply_stem(self.cfg, params, mel)
        x = enc.apply_blocks(self.cfg, params, x, 0, k)
        if k == self.cfg.n_blocks:
            return enc.apply_head(self.cfg, params, x)
        return x

    def _server_fn(self, k, params, x):
        if k == 0:
            x = enc.apply_stem(self.cfg, params, x)
        x = enc.apply_blocks(self.cfg, params, x, k, self.cfg.n_blocks)
        return enc.apply_head(self.cfg, params, x)

    def run(self, params, mel, k):
        """-> (embedding z, wire_bytes)."""
        L = self.cfg.n_blocks
        k = int(k)
        mel = self._to_device(mel)
        if k >= L:
            return self._edge_fn(L, params, mel), 0
        act = self._edge_fn(k, params, mel)
        if self.quantize_wire:
            # the wire as the edge ships it: the int8 payload plus its
            # (scale, zero) header, materialised on the device, and the
            # activation the server reads back from them
            wire_bytes = act.numel() + 8  # int8 payload + scale/zero header
            act = kernel_ops.int8_dequantize(kernel_ops.int8_quantize(act))
        else:
            wire_bytes = act.numel() * 4
        return self._server_fn(k, params, act), wire_bytes

    def run_batch(self, params, mel, k):
        """Run B frames that share one split index as one call per stage.

        -> (z (B, d), wire_bytes per frame): payload + the 8-byte
        scale/zero header, equal to ``run``'s on a single-frame batch.
        ``mel`` may be a host array; it is copied to the device here."""
        L = self.cfg.n_blocks
        k = int(k)
        mel = self._to_device(mel)
        if k >= L:
            return self._edge_fn(L, params, mel), 0
        act = self._edge_fn(k, params, mel)
        per_frame = act.numel() // act.shape[0]
        if self.quantize_wire:
            act = wire_roundtrip_ref(act)
            wire_bytes = per_frame + 8    # int8 payload + scale/zero header
        else:
            wire_bytes = per_frame * 4
        return self._server_fn(k, params, act), wire_bytes

    def run_batch_async(self, params, mel, k):
        """``run_batch`` on a device-resident mel batch, without any
        host round trip: returns the device embedding before it is
        computed (the caller owns the tick's single sync point).  The
        wire stage is the hand-written ``wire_roundtrip`` kernel."""
        L = self.cfg.n_blocks
        k = int(k)
        if k >= L:
            return self._edge_fn(L, params, mel), 0
        # k=0 offloads the raw input: the edge stage is the identity
        act = self._edge_fn(k, params, mel)
        per_frame = act.numel() // act.shape[0]
        if self.quantize_wire:
            act = kernel_ops.wire_roundtrip(act)
            wire_bytes = per_frame + 8    # int8 payload + scale/zero header
        else:
            wire_bytes = per_frame * 4
        return self._server_fn(k, params, act), wire_bytes

    def full(self, params, mel):
        return self._edge_fn(self.cfg.n_blocks, params, self._to_device(mel))
