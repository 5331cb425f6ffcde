#!/usr/bin/env python3
"""The flash kernels' 3xTF32 sums with the tensor cores' truncation,
emulated on the CPU.

    python3 tools/tc_truncation.py      # from the repository root, no card

An ``mma.sync`` m16n8k8 TF32 adds its eight exact products to the
accumulator and rounds the sum toward zero to float32, so a chain of
them drifts with its length.  ``chain(a, b, join)`` is a dot product as
``product_t`` in ``csrc/flash_attention.cu`` runs it: both operands split
as hi = tf32(x), lo = tf32(x - hi), per 8 columns the three products
lo*hi, hi*lo, hi*hi in one truncating chain, and the chain joined to a
float32 sum by a rounded add every ``join`` steps of 8 columns (``None``:
one chain over the whole row).

``wgmma_chain(a, b, split_fn, chains)`` is the same dot product as the
float32 backward at hd 112 runs its score products on ``wgmma`` (its
``dp_turn``): the cross terms lo*hi and hi*lo of every 8 columns
first, then the hi*hi steps, in one truncating chain, or with the hi*hi
steps dealt in turn to ``chains`` chains joined in order by rounded adds.
``split_fn`` is ``split`` (hi rounded to TF32, as the kernels' split
writes it) or ``split_trunc`` (hi truncated, as the tensor cores would
read a raw float32 tile).

It prints three tables, over seeded random draws:

- dq and dk at Sq = Sk = 1, exactly 0 there, as ``chip_smoke.py`` phase
  11 measures them (against 0.1 of the largest gradient, dv = dO): the
  dp chain against the forward's o = hi(v) + lo(v) in delta;
- the same at hd 112 with dp summed as ``wgmma_chain`` sums it, by split
  and chains;
- the forward's lse of a 1,024-key row with the score chain, against
  float64.
"""
from __future__ import annotations

import numpy as np

F32 = np.float32
PHASE11_BAR = 1e-5


def tf32(x):
    """x rounded to TF32: to nearest, ties away, at mantissa bit 13."""
    x = np.ascontiguousarray(x, F32)
    return ((x.view(np.uint32) + np.uint32(0x1000))
            & np.uint32(0xffffe000)).view(F32)


def split(x):
    hi = tf32(x)
    return hi, tf32((np.asarray(x, F32) - hi).astype(F32))


def split_trunc(x):
    """hi = x with its low 13 mantissa bits dropped, lo = tf32(x - hi)."""
    x = np.ascontiguousarray(x, F32)
    hi = (x.view(np.uint32) & np.uint32(0xffffe000)).view(F32)
    return hi, tf32((x - hi).astype(F32))


def trunc32(x):
    """float64 values (in float32's normal range, or 0) to float32, rounded
    toward zero: the 29 low mantissa bits dropped."""
    x = np.ascontiguousarray(x, np.float64)
    return (x.view(np.uint64) & np.uint64(0xffffffffe0000000)).view(
        np.float64).astype(F32)


def chain(a, b, join=None):
    """sum over the last axis of a * b, as the kernels' tensor cores sum it
    (see the module docstring)."""
    (ah, al), (bh, bl) = split(a), split(b)
    steps = a.shape[-1] // 8
    join = join or steps
    total = np.zeros(a.shape[:-1], F32)
    part = np.zeros(a.shape[:-1], F32)
    for i in range(steps):
        cols = slice(8 * i, 8 * i + 8)
        for x, y in ((al, bh), (ah, bl), (ah, bh)):
            part = trunc32(part.astype(np.float64) + (
                x[..., cols].astype(np.float64) * y[..., cols]).sum(-1))
        if (i + 1) % join == 0 or i == steps - 1:
            total = (total + part).astype(F32)
            part = np.zeros(a.shape[:-1], F32)
    return total


def wgmma_chain(a, b, split_fn=split, chains=1):
    """sum over the last axis of a * b as the hd-112 float32 backward's
    wgmma sums a score product: the cross terms first, then hi*hi step i in
    chain i * chains // steps, the chains joined in order (see the module
    docstring)."""
    (ah, al), (bh, bl) = split_fn(a), split_fn(b)
    steps = a.shape[-1] // 8
    terms = [[] for _ in range(chains)]
    terms[0] = [(x, y, i) for i in range(steps)
                for x, y in ((al, bh), (ah, bl))]
    for i in range(steps):
        terms[i * chains // steps].append((ah, bh, i))
    total = None
    for chain in terms:
        part = np.zeros(a.shape[:-1], F32)
        for x, y, i in chain:
            cols = slice(8 * i, 8 * i + 8)
            part = trunc32(part.astype(np.float64) + (
                x[..., cols].astype(np.float64) * y[..., cols]).sum(-1))
        total = part if total is None else (total + part).astype(F32)
    return total


def degenerate_errors(hd, join, draws=400, seed=1, dot=None):
    """phase 11's measure of dq and dk at Sq = Sk = 1 (2 heads), one value
    a draw: max |dq|, |dk| over 0.1 max |dv|; dp summed by ``dot(do, v)``
    (default ``chain(do, v, join)``)."""
    rng = np.random.default_rng(seed)
    scale = F32(1 / np.sqrt(hd))
    out = []
    for _ in range(draws):
        q, k, v, do = (rng.standard_normal((2, hd)).astype(F32)
                       for _ in range(4))
        vh, vl = split(v)
        o = trunc32(vl.astype(np.float64) + vh)      # the forward's p v, p 1
        delta = (do * o).sum(-1, dtype=F32)
        dp = dot(do, v) if dot else chain(do, v, join)
        ds = (dp - delta).astype(F32)
        worst = max(np.abs(scale * ds[:, None] * k).max(),
                    np.abs(scale * ds[:, None] * q).max())
        out.append(worst / (0.1 * np.abs(do).max()))
    return np.array(out)


def lse_errors(hd, join, rows=8, keys=1024, draws=20, seed=2):
    """|lse - exact| of ``rows`` query rows over ``keys`` keys, the worst a
    draw, with the scores summed by ``chain``."""
    rng = np.random.default_rng(seed)
    scale = 1 / np.sqrt(hd)
    out = []
    for _ in range(draws):
        q = rng.standard_normal((rows, hd)).astype(F32)
        k = rng.standard_normal((keys, hd)).astype(F32)
        s = chain(np.broadcast_to(q[:, None], (rows, keys, hd)),
                  np.broadcast_to(k[None], (rows, keys, hd)),
                  join).astype(np.float64) * scale
        exact = (q.astype(np.float64) @ k.T.astype(np.float64)) * scale

        def lse(x):
            m = x.max(-1, keepdims=True)
            return (np.log(np.exp(x - m).sum(-1, keepdims=True)) + m)[:, 0]
        out.append(np.abs(lse(s) - lse(exact)).max())
    return np.array(out)


def main():
    print(f"dq, dk at Sq = Sk = 1 over 0.1 max |dv| (phase 11's bar "
          f"{PHASE11_BAR}), 400 draws:")
    for hd in (64, 128):
        for join in (1, 2, 4, None):
            r = degenerate_errors(hd, join)
            print(f"  hd {hd}, join {join or 'none'}: median {np.median(r):.2e}"
                  f", p90 {np.percentile(r, 90):.2e}, max {r.max():.2e}, "
                  f"share over the bar {(r > PHASE11_BAR).mean():.3f}")
    print("the same at hd 112, dp on wgmma (dp_turn's order):")
    for name, fn in (("rounded hi", split), ("truncated hi", split_trunc)):
        for chains in (1, 2, 3, 4):
            r = np.concatenate([degenerate_errors(
                112, None, draws=1000, seed=seed, dot=lambda a, b:
                wgmma_chain(a, b, fn, chains)) for seed in range(1, 5)])
            print(f"  {name}, {chains} chain(s), 4,000 draws: median "
                  f"{np.median(r):.2e}, max {r.max():.2e}, share over the "
                  f"bar {(r > PHASE11_BAR).mean():.4f}")
    print("forward lse error, 8 rows x 1,024 keys, 20 draws:")
    for hd in (64, 128):
        for join in (1, 2, None):
            r = lse_errors(hd, join)
            print(f"  hd {hd}, join {join or 'none'}: median "
                  f"{np.median(r):.2e}, max {r.max():.2e}")


if __name__ == "__main__":
    main()
