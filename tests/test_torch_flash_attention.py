"""The port's flash-attention forward against the reference.

``flash_attention_ref`` (the plain version of the ``flash_attention_fwd``
CUDA kernel, which the wrapper runs on a CPU tensor) is held against the
reference's oracle ``repro.kernels.flash_attention.flash_attention_ref``
at the reference's own tolerance (atol 2e-5) on the four shapes of
``tests/test_flash_attention.py``, with GQA (k and v ``jnp.repeat``ed for
the oracle), ragged lengths, Sq != Sk and S = 1; its lse against
``jax.nn.logsumexp`` of the oracle's scores (atol 1e-5).  The Pallas
``flash_attention`` itself no longer traces on this jax, so the oracle is
its plain reference.  The kernel runs only on the card (``chip_smoke.py``
phase 9).
"""
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import flash_attention as jfa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention_fwd, flash_attention_ref)

O_ATOL, LSE_ATOL = 2e-5, 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per worker of the parallel suite."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _qkv(B, H, KV, Sq, Sk, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, H, Sq, d)).astype(np.float32),
            rng.normal(size=(B, KV, Sk, d)).astype(np.float32),
            rng.normal(size=(B, KV, Sk, d)).astype(np.float32))


@functools.partial(jax.jit, static_argnums=3)
def _oracle(q, k, v, causal):
    """The reference's oracle with k and v repeated to H heads, and the
    logsumexp of its scores -> (o, lse)."""
    G = q.shape[1] // k.shape[1]
    k, v = jnp.repeat(k, G, axis=1), jnp.repeat(v, G, axis=1)
    o = jfa.flash_attention_ref(q, k, v, causal)
    s = jnp.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(q.shape[-1])
    if causal:
        Sq, Sk = s.shape[-2:]
        s = jnp.where(jnp.arange(Sq)[:, None] >= jnp.arange(Sk)[None, :], s,
                      jfa.NEG_INF)
    return o, jax.nn.logsumexp(s, axis=-1)


@pytest.mark.parametrize("B,H,KV,Sq,Sk,d,causal", [
    # the reference's own four shapes
    (2, 4, 4, 128, 128, 64, True),
    (1, 2, 2, 256, 256, 32, True),
    (2, 2, 2, 128, 256, 64, False),
    (1, 1, 1, 64, 64, 128, True),
    # GQA: 4 query heads over 2 KV heads
    (2, 4, 2, 64, 64, 16, True),
    (1, 4, 2, 48, 80, 32, False),
    # ragged: no tile divides these
    (2, 2, 2, 100, 100, 64, True),
    (1, 2, 1, 100, 37, 16, False),
    (1, 2, 2, 37, 100, 16, True),
    # a single row
    (1, 2, 2, 1, 1, 64, True),
    (2, 2, 2, 1, 9, 32, False),
])
def test_plain_matches_reference(B, H, KV, Sq, Sk, d, causal):
    q, k, v = _qkv(B, H, KV, Sq, Sk, d, seed=B * Sq + Sk + d)
    o, lse = flash_attention_ref(*(torch.from_numpy(x) for x in (q, k, v)),
                                 causal)
    want_o, want_lse = _oracle(q, k, v, causal)
    assert o.shape == (B, H, Sq, d) and lse.shape == (B, H, Sq)
    np.testing.assert_allclose(o.numpy(), np.asarray(want_o), atol=O_ATOL,
                               rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse),
                               atol=LSE_ATOL, rtol=0)


def test_scale_argument():
    """An explicit scale multiplies the scores: scale s on q equals the
    default 1/sqrt(d) on q * s * sqrt(d)."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 2, 2, 20, 20, 16, 3))
    got = flash_attention_ref(q, k, v, True, scale=0.37)
    want = flash_attention_ref(q * (0.37 * 4.0), k, v, True)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


def test_cpu_wrapper_is_the_plain_version():
    q, k, v = (torch.from_numpy(x) for x in _qkv(2, 4, 2, 30, 30, 32, 5))
    before = flash_attention_fwd.launches
    for causal in (True, False):
        got = flash_attention_fwd(q, k, v, causal=causal)
        want = flash_attention_ref(q, k, v, causal)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert flash_attention_fwd.launches == before == 0
    assert ops.KERNELS["flash_attention_fwd"] is flash_attention_fwd


@pytest.mark.parametrize("hd", [8, 48, 96, 256])
def test_unsupported_head_dims_raise(hd):
    q = torch.zeros(1, 2, 4, hd)
    with pytest.raises(ValueError, match="head dims"):
        flash_attention_fwd(q, q, q)


@pytest.mark.parametrize("dtype", [torch.float64, torch.bfloat16,
                                   torch.float16])
def test_other_dtypes_raise(dtype):
    q = torch.zeros(1, 2, 4, 16, dtype=dtype)
    with pytest.raises(TypeError):
        flash_attention_fwd(q, q, q)


@pytest.mark.parametrize("q_shape,kv_shape", [
    ((1, 4, 8, 16), (1, 3, 8, 16)),      # KV does not divide H
    ((2, 4, 8, 16), (1, 4, 8, 16)),      # batch differs
    ((1, 4, 8, 16), (1, 4, 8, 32)),      # head dims differ
    ((4, 8, 16), (4, 8, 16)),            # not 4-D
    ((1, 2, 0, 16), (1, 2, 8, 16)),      # empty
])
def test_bad_shapes_raise(q_shape, kv_shape):
    with pytest.raises(ValueError):
        flash_attention_fwd(torch.zeros(q_shape), torch.zeros(kv_shape),
                            torch.zeros(kv_shape))


def test_non_contiguous_raises():
    q = torch.zeros(1, 8, 2, 16).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention_fwd(q, q, q)


def test_refuses_devices_without_a_kernel():
    """No fallback: a tensor neither on the CPU nor on a card raises; the
    kernel's source is among those ``build`` compiles."""
    from repro_torch.kernels import build
    meta = torch.empty(1, 2, 4, 16, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        flash_attention_fwd(meta, meta, meta)
    assert "flash_attention.cu" in build.SOURCES
    assert (build.CSRC / "flash_attention.cu").exists()
