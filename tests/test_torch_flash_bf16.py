"""The flash-attention wrappers' bf16 and hd-112 ranges against the
reference, on the CPU.

The plain versions (what the wrappers run on a CPU tensor, and what the
CUDA kernels are held against on the card) take bf16 as the reference's
oracle ``repro.kernels.flash_attention.flash_attention_ref`` does: upcast,
compute in float32, round the output once.  So the port's bf16 o is held
to the oracle's within one bf16 ulp of the output's magnitude (its max
|o|: the two sum their float32 products in other orders, which may tip a
rounding, and an output near 0 carries the float32 sums' cancellation),
its lse to the float32 bars of ``test_torch_flash_attention.py``; at hd 112 (kimi-
k2's head dim) float32 is held as there.  The backward through
``flash_attention`` in bf16 against autograd through the plain forward
(upcast in both: gradients within one bf16 ulp of each gradient's max).
The bf16 kernels themselves run on the card only (``chip_smoke.py`` phase
20).
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import flash_attention as jfa  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    HEAD_DIMS, flash_attention, flash_attention_bwd_dkv,
    flash_attention_bwd_dkv_ref, flash_attention_bwd_dq,
    flash_attention_bwd_dq_ref, flash_attention_fwd, flash_attention_ref,
    variant)

BF16_ULP = 2.0 ** -7     # of a value's magnitude: bf16 keeps 8 bits
O_ATOL, LSE_ATOL = 2e-5, 1e-5

CASES = [(1, 2, 128, 128, 64, True), (2, 4, 100, 100, 112, True),
         (1, 2, 64, 96, 112, False), (2, 2, 33, 33, 128, True),
         (1, 4, 1, 1, 16, True), (1, 2, 50, 50, 32, False)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _qkv(B, H, Sq, Sk, d, seed, dtype=np.float32):
    """Unit-normal q (B, H, Sq, d), k, v (B, H, Sk, d) as numpy, rounded to
    bf16 first where asked (so both packages see the same values)."""
    rng = np.random.default_rng(seed)
    xs = [rng.normal(size=s).astype(np.float32)
          for s in ((B, H, Sq, d), (B, H, Sk, d), (B, H, Sk, d))]
    if dtype == "bf16":
        xs = [np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
              for x in xs]
    return xs


def _bf16(x):
    return torch.from_numpy(np.array(x)).to(torch.bfloat16)


@pytest.mark.parametrize("B,H,Sq,Sk,d,causal", CASES)
def test_bf16_plain_matches_reference_oracle(B, H, Sq, Sk, d, causal):
    q, k, v = _qkv(B, H, Sq, Sk, d, d + Sq, "bf16")
    want = np.asarray(jfa.flash_attention_ref(
        *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)), causal)
        .astype(jnp.float32))
    o, lse = flash_attention_fwd(_bf16(q), _bf16(k), _bf16(v),
                                 causal=causal)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    got = o.float().numpy()
    assert np.abs(got - want).max() <= BF16_ULP * np.abs(want).max()
    # lse: the float32 oracle's scores of the same (bf16) values
    s = np.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(d)
    if causal:
        s = np.where(np.arange(Sq)[:, None] >= np.arange(Sk)[None, :], s,
                     -1e30)
    m = s.max(-1, keepdims=True)
    want_lse = (m + np.log(np.exp(s - m).sum(-1, keepdims=True)))[..., 0]
    np.testing.assert_allclose(lse.numpy(), want_lse, atol=LSE_ATOL,
                               rtol=0)


@pytest.mark.parametrize("causal", [True, False])
def test_hd112_float32_matches_reference_oracle(causal):
    q, k, v = _qkv(2, 4, 70, 70, 112, 5)
    want = np.asarray(jfa.flash_attention_ref(
        *(jnp.asarray(x) for x in (q, k, v)), causal))
    o, _ = flash_attention_fwd(*(torch.from_numpy(x) for x in (q, k, v)),
                               causal=causal)
    np.testing.assert_allclose(o.numpy(), want, atol=O_ATOL, rtol=0)
    assert 112 in HEAD_DIMS and variant(torch.float32, 112) == "f32_hd112"


@pytest.mark.parametrize("d", [64, 112])
def test_bf16_backward_matches_autograd_of_plain(d):
    """``flash_attention`` in bf16 on the CPU (its plain backward: upcast,
    float32, the gradients rounded once) against torch autograd through
    ``flash_attention_ref`` (which upcasts too), GQA 4 over 2."""
    rng = np.random.default_rng(d)
    q = _bf16(rng.normal(size=(2, 4, 40, d)).astype(np.float32))
    k = _bf16(rng.normal(size=(2, 2, 40, d)).astype(np.float32))
    v = _bf16(rng.normal(size=(2, 2, 40, d)).astype(np.float32))
    do = _bf16(rng.normal(size=(2, 4, 40, d)).astype(np.float32))
    a = [x.clone().requires_grad_() for x in (q, k, v)]
    got = torch.autograd.grad(flash_attention(*a, True), a, do)
    b = [x.clone().requires_grad_() for x in (q, k, v)]
    o_ref, _ = flash_attention_ref(*(x.float() for x in b), True)
    want = torch.autograd.grad(o_ref, b, do.float())
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        assert (g.float() - w).abs().max() <= BF16_ULP * w.abs().max()
    # the two backward wrappers return the inputs' type, from float32 lse
    # and delta
    o, lse = flash_attention_fwd(q, k, v)
    delta = (do.float() * o.float()).sum(-1)
    dq = flash_attention_bwd_dq(q, k, v, do, lse, delta)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta)
    assert torch.equal(dq, flash_attention_bwd_dq_ref(q, k, v, do, lse,
                                                      delta))
    assert all(torch.equal(x, y) for x, y in zip(
        (dk, dv), flash_attention_bwd_dkv_ref(q, k, v, do, lse, delta)))
    assert {x.dtype for x in (dq, dk, dv)} == {torch.bfloat16}


@pytest.mark.parametrize("case", ["float16", "hd80", "bf16_lse"])
def test_wrappers_refuse_float16_hd80_and_bf16_statistics(case):
    """float16 and hd 80 raise in every wrapper; lse and delta must be
    float32 whatever the inputs' type."""
    hd = 80 if case == "hd80" else 16
    dt = torch.float16 if case == "float16" else torch.bfloat16
    q = torch.zeros(1, 2, 8, hd, dtype=dt)
    row = torch.zeros(1, 2, 8, dtype=torch.bfloat16 if case == "bf16_lse"
                      else torch.float32)
    err = ValueError if case == "hd80" else TypeError
    if case != "bf16_lse":
        with pytest.raises(err):
            flash_attention_fwd(q, q, q)
    for fn in (flash_attention_bwd_dq, flash_attention_bwd_dkv):
        with pytest.raises(err):
            fn(q, q, q, q, row, row)
