"""The float32 flash backward at hd 112 (kimi-k2's head dim), whose dq and
dk/dv kernels run their score products on ``wgmma`` fed by TMA and their
accumulation products on ``mma.sync`` (``csrc/flash_attention.cu``, the
section "float32 at hd 112 on Hopper's warpgroup tensor cores").

The kernels run only on the card (``chip_smoke.py`` phase 20 (a) holds
them against the plain backward).  Here their arithmetic is emulated on
the CPU, with the tiles, the split and the chains read from the source:

- every operand split as hi = tf32(x), lo = tf32(x - hi) (to nearest,
  ties away);
- the score products (s, dp; s^T, dp^T) as the kernels issue them:
  per 8 columns of hd one instruction whose 8 exact products join the
  accumulator truncated toward zero, the cross terms first, then hi * hi,
  dp's hi * hi steps dealt to ``kDpChains`` chains in turn, joined in
  order by rounded adds;
- the accumulation products (dq += ds k, dv += p^T dO, dk += ds^T q) a
  step of ``kStep`` rows at a time, each step a truncating chain of
  ``mma.sync`` (lo*hi, hi*lo, hi*hi per 8 rows) from 0, joined to the
  float32 sum by one rounded add, the steps in the kernels' order (keys
  ascending for dq; each KV head's query heads in turn, queries ascending,
  for dk and dv).

That emulation stays within phase 20's float32 bar (1e-5 of each
gradient's max) of ``jax.vjp`` of the reference's oracle, with GQA groups
of 8 and 7 over one KV head, causal and full, S 256 and a ragged S, while
one TF32 product misses it.  At Sq = Sk = 1, where dq and dk are exactly
0, dp summed in the kernels' chains keeps every draw under the bar, and
one chain, or a truncated hi (a raw float32 tile as the tensor cores read
it), does not.  The plain backward at hd 112 with a group of 8
matches ``jax.vjp``, and the CPU wrappers at hd 112 are the plain
versions.
"""
import importlib.util
import math
import pathlib
import re

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import flash_attention as jfa  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention_bwd_dkv, flash_attention_bwd_dkv_ref,
    flash_attention_bwd_dq, flash_attention_bwd_dq_ref, flash_attention_ref)

ROOT = pathlib.Path(__file__).resolve().parents[1]
CU = ROOT / "src" / "repro_torch" / "kernels" / "csrc" / "flash_attention.cu"
HD = 112
KERNEL_GRAD_RTOL = 1e-5  # chip_smoke.py phase 20 (a)'s float32 bar
GRAD_RTOL = 2e-5         # the plain backward against jax.vjp
F32, F64 = np.float32, np.float64


def _tf_constants():
    """kRows, kStep, kStages and kDpChains of namespace tf in the
    source."""
    src = CU.read_text()
    body = src[src.index("namespace tf {"):src.index("}  // namespace tf")]
    return {name: int(re.search(rf"constexpr int {name} = (\d+);",
                                body).group(1))
            for name in ("kRows", "kStep", "kStages", "kDpChains")}


TF = _tf_constants()


def _tc():
    """``tools/tc_truncation.py``: the split and the truncating sums."""
    path = ROOT / "tools" / "tc_truncation.py"
    spec = importlib.util.spec_from_file_location("tc_truncation", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


TC = _tc()


def _split(x, passes):
    """(hi, lo) as float64 arrays; ``passes`` 1 keeps hi alone."""
    hi, lo = TC.split(x)
    return hi.astype(F64), (lo.astype(F64) if passes == 3 else None)


def _scores(x, y, passes, chains=1):
    """x (..., M, hd) . y (..., N, hd)^T as the kernels' ``wgmma`` sum
    it: the cross terms first, then hi * hi step kk in chain kk * chains //
    steps, the chains joined in order."""
    (xh, xl), (yh, yl) = _split(x, passes), _split(y, passes)
    steps = x.shape[-1] // 8

    def mm(a, b, i):
        c = slice(8 * i, 8 * i + 8)
        return a[..., c] @ np.swapaxes(b[..., c], -1, -2)
    terms = [[] for _ in range(chains)]
    if passes == 3:
        terms[0] = [(xl, yh, i) for i in range(steps)] \
            + [(xh, yl, i) for i in range(steps)]
    for i in range(steps):
        terms[i * chains // steps].append((xh, yh, i))
    total = None
    for chain in terms:
        part = np.zeros(x.shape[:-1] + y.shape[-2:-1], F32)
        for a, b, i in chain:
            part = TC.trunc32(part.astype(F64) + mm(a, b, i))
        total = part if total is None else (total + part).astype(F32)
    return total


def _accumulate(c, y, passes, seg):
    """sum over the steps of ``kStep`` rows of c (..., M, K) . y (..., K,
    hd), the K rows in segments of ``seg`` (a query head's rows), each
    stepped from its start: each step a truncating ``mma.sync`` chain from
    0 (tc::mma3's order), joined to the float32 sum by a rounded add."""
    step = TF["kStep"]
    out = np.zeros(c.shape[:-1] + y.shape[-1:], F32)
    starts = [r for s0 in range(0, c.shape[-1], seg)
              for r in range(s0, s0 + seg, step)]
    for r0 in starts:
        r1 = min(r0 + step, seg * (r0 // seg + 1))
        (ch, cl) = _split(c[..., r0:r1], passes)
        (yh, yl) = _split(y[..., r0:r1, :], passes)
        terms = ((cl, yh), (ch, yl), (ch, yh)) if passes == 3 else ((ch, yh),)
        part = np.zeros_like(out)
        for i in range(0, ch.shape[-1], 8):
            for a, b in terms:
                part = TC.trunc32(part.astype(F64)
                                  + a[..., i:i + 8] @ b[..., i:i + 8, :])
        out = (out + part).astype(F32)
    return out


def _emulate(q, k, v, do, lse, delta, causal, passes):
    """The hd-112 kernels' dq, dk and dv (default scale) -> numpy float32."""
    B, H, Sq, d = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    G, sc = H // KV, F32(1.0 / math.sqrt(d))
    kg, vg = np.repeat(k, G, 1), np.repeat(v, G, 1)
    keep = (np.arange(Sq)[:, None] >= np.arange(Sk)[None, :]) if causal \
        else np.ones((Sq, Sk), bool)
    chains = TF["kDpChains"] if passes == 3 else 1

    def probs(s, dp, lse_, delta_, keep_):
        p = np.where(keep_, np.exp((s * sc).astype(F32) - lse_), F32(0))
        return p.astype(F32), (p * (dp - delta_)).astype(F32)
    # dq: s = q k^T and dp = dO v^T, rows the queries
    _, ds = probs(_scores(q, kg, passes),
                  _scores(do, vg, passes, chains),
                  lse[..., None], delta[..., None], keep)
    dq = (_accumulate(ds, kg, passes, Sk) * sc).astype(F32)
    # dk/dv: s^T = k q^T and dp^T = v dO^T, rows the keys, each KV head's
    # G query heads' rows in turn
    qr = q.reshape(B, KV, G * Sq, d)
    dor = do.reshape(B, KV, G * Sq, d)
    lse_r = lse.reshape(B, KV, 1, G * Sq)
    delta_r = delta.reshape(B, KV, 1, G * Sq)
    pt, dst = probs(_scores(k, qr, passes),
                    _scores(v, dor, passes, chains),
                    lse_r, delta_r, np.tile(keep.T, (1, G)))
    dk = (_accumulate(dst, qr, passes, Sq) * sc).astype(F32)
    dv = _accumulate(pt, dor, passes, Sq)
    return dq, dk, dv


def _oracle_vjp(q, k, v, do, causal):
    """jax.vjp of the reference's oracle with k and v repeated inside, so
    JAX sums the GQA groups -> (dq, dk, dv)."""
    G = q.shape[1] // k.shape[1]

    def f(q, k, v):
        return jfa.flash_attention_ref(q, jnp.repeat(k, G, axis=1),
                                       jnp.repeat(v, G, axis=1), causal)
    _, vjp = jax.vjp(f, q, k, v)
    return [np.asarray(x) for x in vjp(do)]


def _rel(gots, wants):
    """max |got - want| over max |want|, gradient by gradient, with phase
    20's floor of 0.1x the largest of the set."""
    floor = 0.1 * max(np.abs(w).max() for w in wants)
    return [float(np.abs(np.asarray(g) - w).max()
                  / max(np.abs(w).max(), floor)) for g, w in zip(gots, wants)]


def _inputs(H, KV, S, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(1, H, S, HD)).astype(F32)
    k, v = (rng.normal(size=(1, KV, S, HD)).astype(F32) for _ in range(2))
    do = rng.normal(size=q.shape).astype(F32)
    return q, k, v, do


def _worst(H, KV, S, causal, passes, seed):
    q, k, v, do = _inputs(H, KV, S, seed)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    o, lse = flash_attention_ref(tq, tk, tv, causal)
    delta = (tdo * o).sum(-1)
    got = _emulate(q, k, v, do, lse.numpy(), delta.numpy(), causal, passes)
    return max(_rel(got, _oracle_vjp(q, k, v, do, causal)))


def test_the_emulated_tiles_fit_the_card():
    """The constants the emulation reads, and the shared memory they give
    a block at hd 112 (``Smem``: four 64-row tiles, ``kStages`` stages of
    four ``kStep``-row tiles, lse and delta, 9 barriers, 1 KB of
    alignment), within the 227 KB a block can use."""
    assert (TF["kRows"], TF["kStep"]) == (64, 32)
    assert 0 < TF["kDpChains"] <= HD // 8
    tile = 4 * HD
    smem = (4 * TF["kRows"] * tile + TF["kStages"] * 4 * TF["kStep"] * tile
            + 4 * 2 * TF["kStep"] * TF["kStages"] + 8 * (3 * TF["kStages"]
                                                         + 3) + 1024)
    assert smem <= 232448, smem


@pytest.mark.parametrize("S", [256, 200])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("H,KV", [(8, 1), (7, 1)])
def test_emulated_kernels_meet_the_bar(H, KV, causal, S):
    """The kernels' 3xTF32 schedule, emulated, within 1e-5 of each
    gradient's max from ``jax.vjp`` of the oracle (the margin printed with
    ``-s``)."""
    worst = _worst(H, KV, S, causal, 3, seed=H + S + causal)
    print(f"H {H} over {KV}, S {S}, causal {causal}: {worst:.3e} of the "
          f"max (bar {KERNEL_GRAD_RTOL})")
    assert worst <= KERNEL_GRAD_RTOL, worst


@pytest.mark.parametrize("H,KV,S,causal", [(8, 1, 256, True),
                                           (7, 1, 200, False)])
def test_one_tf32_product_misses_the_bar(H, KV, S, causal):
    """The same schedule with one TF32 product (hi * hi) misses the bar,
    so phase 20 (a) would catch a kernel that dropped to plain TF32."""
    worst = _worst(H, KV, S, causal, 1, seed=H + S + causal)
    assert worst > KERNEL_GRAD_RTOL, worst


@pytest.mark.parametrize("split,chains,passes_all", [
    ("split", TF["kDpChains"], True), ("split", 1, False),
    ("split_trunc", TF["kDpChains"], False)])
def test_dp_chains_keep_degenerate_gradients_under_the_bar(split, chains,
                                                           passes_all):
    """dq and dk at Sq = Sk = 1 are exactly 0 and are measured against 0.1
    of the largest gradient.  dp summed as the kernels sum it (rounded hi,
    the hi * hi steps in ``kDpChains`` chains) keeps 1,000 draws under the
    bar; one chain, or the truncated hi of a raw float32 tile, misses on
    some."""
    errs = TC.degenerate_errors(HD, None, draws=1000, seed=HD, dot=lambda a, b:
                                TC.wgmma_chain(a, b, getattr(TC, split),
                                               chains))
    if passes_all:
        assert errs.max() <= KERNEL_GRAD_RTOL, errs.max()
    else:
        assert errs.max() > KERNEL_GRAD_RTOL, errs.max()


@pytest.mark.parametrize("causal", [True, False])
def test_plain_backward_at_hd112_matches_jax_vjp(causal):
    """``flash_attention_bwd_dq_ref`` and ``flash_attention_bwd_dkv_ref``
    at hd 112 with a group of 8 query heads over one KV head, against
    ``jax.vjp`` of the oracle (2e-5 of each gradient's max: float32 sums
    in another order)."""
    q, k, v, do = _inputs(8, 1, 96, seed=5 + causal)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    o, lse = flash_attention_ref(tq, tk, tv, causal)
    args = (tq, tk, tv, tdo, lse, (tdo * o).sum(-1))
    got = (flash_attention_bwd_dq_ref(*args, causal),
           *flash_attention_bwd_dkv_ref(*args, causal))
    assert max(_rel([x.numpy() for x in got],
                    _oracle_vjp(q, k, v, do, causal))) <= GRAD_RTOL


@pytest.mark.parametrize("causal", [True, False])
def test_cpu_wrappers_at_hd112_are_the_plain_versions(causal):
    """On CPU tensors the hd-112 float32 wrappers run the plain backward
    (bitwise) and count no launch."""
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(7, 1, 40, seed=9))
    o, lse = flash_attention_ref(q, k, v, causal)
    args = (q, k, v, do, lse, (do * o).sum(-1))
    counts = (flash_attention_bwd_dq.launches,
              flash_attention_bwd_dkv.launches)
    dq = flash_attention_bwd_dq(*args, causal=causal)
    dk, dv = flash_attention_bwd_dkv(*args, causal=causal)
    assert torch.equal(dq, flash_attention_bwd_dq_ref(*args, causal))
    for a, b in zip((dk, dv), flash_attention_bwd_dkv_ref(*args, causal)):
        assert torch.equal(a, b)
    assert (flash_attention_bwd_dq.launches,
            flash_attention_bwd_dkv.launches) == counts
