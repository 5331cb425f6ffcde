"""The bf16 flash forward's tile arithmetic, emulated on the CPU, against
the reference's oracle.

``csrc/flash_attention.cu``'s bf16 forward (``hb::flash_fwd_bf16_kernel``)
runs on the card only.  Its arithmetic is emulated here in torch float32,
tile by tile over ``kFwdBK`` keys (read from the source): the exact bf16
products summed in float32, keys past Sk and past the causal diagonal
weighing 0, the running max m in natural units (the raw max times the
scale), alpha = 2^((m_old - m) log2e), p = 2^(fma(s, scale log2e, -m
log2e)) as the kernel forms it, l = l alpha + sum p, o = o alpha + bf16(p)
v, then o rounded to bf16 once as o (1 / max(l, 1e-30)) and lse = m +
log(max(l, 1e-30)).  On the same seeded bf16 inputs that emulation is held
to ``repro.kernels.flash_attention.flash_attention_ref`` (k and v repeated
over each group of query heads) at ``chip_smoke.py`` phase 20's bars:
each element of o within 2^-7 |o| + 2^-8 sum_j p_j |v_j| of the oracle's,
lse within 1e-5 of the logsumexp of the oracle's scores.  The cases are
small forms of phase 20's edges (Sq != Sk, Sq = Sk = 1, S no multiple of
a tile, GQA, every head dim), causal and full.
"""
import math
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import flash_attention as jfa  # noqa: E402
from repro_torch.kernels import build  # noqa: E402

BF16_O_ULP, BF16_P_RTOL, LSE_ATOL = 2.0 ** -7, 2.0 ** -8, 1e-5
LOG2E = np.float32(1.4426950408889634)
# (B, H, KV, Sq, Sk, hd): phase 20's LM20_EDGES, cut to a few hundred rows
CASES = [(1, 4, 2, 70, 150, 64), (1, 2, 2, 1, 1, 112),
         (1, 4, 1, 150, 150, 128), (1, 4, 2, 77, 130, 112),
         (1, 2, 2, 130, 130, 32), (1, 2, 2, 100, 37, 16)]


def _key_tile():
    text = (build.CSRC / "flash_attention.cu").read_text()
    return int(re.search(r"constexpr int kFwdBK = (\d+)\b", text).group(1))


def _inputs(B, H, KV, Sq, Sk, hd, seed):
    """Unit-normal q, k, v rounded to bf16, as float32 numpy arrays."""
    rng = np.random.default_rng(seed)
    xs = [rng.normal(size=s).astype(np.float32)
          for s in ((B, H, Sq, hd), (B, KV, Sk, hd), (B, KV, Sk, hd))]
    return [np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
            for x in xs]


def _emulated(q, k, v, causal, BK):
    """The kernel's tile loop on float32 tensors holding bf16 values ->
    (o rounded to bf16, as float32; lse)."""
    B, H, Sq, hd = q.shape
    G, Sk = H // k.shape[1], k.shape[2]
    kg, vg = k.repeat_interleave(G, 1), v.repeat_interleave(G, 1)
    scale = np.float32(1.0 / math.sqrt(hd))
    scale2 = float(np.float32(scale * LOG2E))
    m = torch.full((B, H, Sq, 1), -1e30)
    l = torch.zeros(B, H, Sq, 1)
    o = torch.zeros(B, H, Sq, hd)
    rows = torch.arange(Sq)[:, None]
    for k0 in range(0, Sk, BK):
        s = q @ kg[:, :, k0:k0 + BK].transpose(-1, -2)
        j = torch.arange(k0, k0 + s.shape[-1])[None, :]
        if causal:
            s = torch.where(j <= rows, s, -math.inf)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True) * float(scale))
        alpha = torch.exp2((m - m_new) * float(LOG2E))
        mneg = -(m_new * float(LOG2E))
        # fmaf: the product and the sum rounded once (in float64 here)
        p = torch.exp2((s.double() * scale2 + mneg.double()).float())
        l = (l.double() * alpha.double()
             + p.sum(-1, keepdim=True).double()).float()
        o = o * alpha + p.to(torch.bfloat16).float() @ vg[:, :, k0:k0 + BK]
        m = m_new
    denom = l.clamp_min(1e-30)
    o = (o * (1.0 / denom)).to(torch.bfloat16).float()
    return o, (m + torch.log(denom))[..., 0]


def _oracle(q, k, v, causal):
    """The reference's oracle on the bf16 values (GQA by repeating k and
    v), sum_j p_j |v_j| in float32, and the scores' logsumexp."""
    G = q.shape[1] // k.shape[1]
    kg, vg = np.repeat(k, G, 1), np.repeat(v, G, 1)
    o = jfa.flash_attention_ref(*(jnp.asarray(x, jnp.bfloat16)
                                  for x in (q, kg, vg)), causal)
    pv = jfa.flash_attention_ref(jnp.asarray(q), jnp.asarray(kg),
                                 jnp.asarray(np.abs(vg)), causal)
    s = jnp.einsum("bhqd,bhkd->bhqk", q, kg) / math.sqrt(q.shape[-1])
    if causal:
        Sq, Sk = s.shape[-2:]
        s = jnp.where(jnp.arange(Sq)[:, None] >= jnp.arange(Sk)[None, :], s,
                      jfa.NEG_INF)
    lse = jax.nn.logsumexp(s, axis=-1)
    return (np.asarray(o.astype(jnp.float32)), np.asarray(pv),
            np.asarray(lse))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", CASES)
def test_emulated_tile_loop_meets_phase20_bars(shape, causal):
    q, k, v = _inputs(*shape, seed=sum(shape) + causal)
    o, lse = _emulated(*(torch.from_numpy(x) for x in (q, k, v)), causal,
                       _key_tile())
    want, pv, want_lse = _oracle(q, k, v, causal)
    share = np.abs(o.numpy() - want) / np.maximum(
        BF16_O_ULP * np.abs(want) + BF16_P_RTOL * pv, 1e-30)
    assert share.max() <= 1.0, share.max()
    np.testing.assert_allclose(lse.numpy(), want_lse, atol=LSE_ATOL, rtol=0)
