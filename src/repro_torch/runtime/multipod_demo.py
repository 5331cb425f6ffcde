"""2-stage split pipeline across a mesh's 'pod' axis with an INT8 wire:
the counterpart of ``examples/multipod_split_demo.py``.

    PYTHONPATH=src python -m repro_torch.runtime.multipod_demo [--device cpu]

The mesh is (pod 2, data 2) over one device repeated four times (the
reference forces four host devices): the two pods' stages run one after
the other on it, each data block through its own pod pair.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.core.splitter import split_pipeline_podwise
from repro_torch.kernels.ops import resolve_device
from repro_torch.launch.mesh import make_test_mesh

D, M, MB = 64, 6, 8


def stage_fn(w, h):
    return torch.tanh(h @ w)


def main(device="cuda", *, W=None, x=None, out=print) -> dict:
    """Run the pipeline with an fp32 and an INT8 wire against the
    sequential stack.  ``W`` (2, D, D) and ``x`` (M, MB, D) default to
    seeded draws; the tests pass the reference example's.  -> {wire:
    {"max_err", "kb_per_microbatch"}}."""
    dev = resolve_device(device)
    mesh = make_test_mesh((2, 2), ("pod", "data"), devices=[dev] * 4)
    if W is None:
        W = 0.2 * torch.randn(2, D, D,
                              generator=torch.Generator().manual_seed(0))
    if x is None:
        x = torch.randn(M, MB, D, generator=torch.Generator().manual_seed(1))
    W, x = W.to(dev), x.to(dev)
    want = torch.tanh(torch.tanh(x @ W[0]) @ W[1])
    results = {}
    for quant in (False, True):
        got = split_pipeline_podwise(mesh, stage_fn, W, x,
                                     quantize_wire=quant, batch_axes="data")
        err = float((got - want).abs().max())
        wire = "INT8" if quant else "fp32"
        kb = x[0].numel() * (1 if quant else 4) / 1024
        results[wire] = {"max_err": err, "kb_per_microbatch": kb}
        out(f"{wire} wire: max err {err:.5f}  ({kb:.1f} KB/microbatch "
            "crosses the pod link)")
    out("microbatches stream through: pod0 computes stage0(t) while "
        "pod1 computes stage1(t-1) — the paper's split, across pods.")
    return results


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args().device)
