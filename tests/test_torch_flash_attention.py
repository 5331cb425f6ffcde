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

The backward: the plain backward (``flash_attention_bwd_dq_ref`` and
``flash_attention_bwd_dkv_ref``, the CUDA kernels' plain versions) against
``jax.vjp`` of the same oracle, within 2e-5 of each gradient's max |g|
(float32 sums in another order), GQA summed by JAX through the
``jnp.repeat``; the autograd entry ``flash_attention`` on the CPU against
autograd through ``flash_attention_ref`` (1e-5 of the max: the explicit
formulas against torch's own backward of the same forward).  The backward
kernels run only on the card (``chip_smoke.py`` phase 11).

All three kernels run their products on the tensor cores in 3xTF32; the
``tensor_core_numerics`` tests emulate that arithmetic on the CPU (the
backward's recomputation, and the forward's tile loop at its key tile)
and hold it to the card's tolerances, which one TF32 product misses.
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
    flash_attention, flash_attention_bwd_dkv, flash_attention_bwd_dkv_ref,
    flash_attention_bwd_dq, flash_attention_bwd_dq_ref, flash_attention_fwd,
    flash_attention_ref)

O_ATOL, LSE_ATOL = 2e-5, 1e-5
GRAD_RTOL = 2e-5         # of each gradient's max |g|, against jax.vjp
AUTOGRAD_RTOL = 1e-5     # of the max, against torch autograd of the ref


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


# ---------------------------------------------------------------------------
# backward
# ---------------------------------------------------------------------------

BWD_CASES = [
    # the reference's own four shapes, causal and not
    (2, 4, 4, 128, 128, 64, True, None),
    (1, 2, 2, 256, 256, 32, True, None),
    (2, 2, 2, 128, 256, 64, False, None),
    (1, 1, 1, 64, 64, 128, True, None),
    (1, 1, 1, 64, 64, 128, False, None),
    # GQA: 4 query heads over 2 KV heads, 8 over 2
    (2, 4, 2, 64, 64, 16, True, None),
    (1, 8, 2, 48, 80, 32, False, None),
    # ragged, Sq != Sk both ways, a single row, a custom scale
    (2, 2, 2, 100, 100, 64, True, None),
    (1, 2, 1, 100, 37, 16, False, None),
    (1, 2, 2, 37, 100, 16, True, None),
    (1, 2, 2, 1, 1, 64, True, None),
    (2, 2, 2, 1, 9, 32, False, None),
    (1, 4, 2, 70, 70, 32, True, 0.37),
]


@functools.partial(jax.jit, static_argnums=(4, 5))
def _oracle_vjp(q, k, v, do, causal, scale):
    """jax.vjp of the reference's oracle (its 1/sqrt(d) turned into
    ``scale`` by scaling q) with k and v repeated inside the function, so
    JAX sums the GQA groups -> (dq, dk, dv)."""
    G = q.shape[1] // k.shape[1]
    d = q.shape[-1]
    mult = 1.0 if scale is None else scale * math.sqrt(d)

    def f(q, k, v):
        return jfa.flash_attention_ref(q * mult, jnp.repeat(k, G, axis=1),
                                       jnp.repeat(v, G, axis=1), causal)
    _, vjp = jax.vjp(f, q, k, v)
    return vjp(do)


def _rel(gots, wants):
    """max |got - want| over max |want|, gradient by gradient.  Every
    gradient here has a max of at least 0.39x the largest of its call's
    but dq and dk at S = 1, which are exactly 0 (the softmax of one key is
    constant) and come out of the explicit formula as rounding of
    dp - delta: those are held against 0.1x the largest."""
    wants = [np.asarray(w) for w in wants]
    floor = 0.1 * max(np.abs(w).max() for w in wants)
    return [float(np.abs(np.asarray(g) - w).max()
                  / max(np.abs(w).max(), floor))
            for g, w in zip(gots, wants)]


@pytest.mark.parametrize("B,H,KV,Sq,Sk,d,causal,scale", BWD_CASES)
def test_plain_backward_matches_jax_vjp(B, H, KV, Sq, Sk, d, causal, scale):
    q, k, v = _qkv(B, H, KV, Sq, Sk, d, seed=7 * Sq + Sk + d)
    do = np.random.default_rng(Sq + 3 * d).normal(
        size=q.shape).astype(np.float32)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    o, lse = flash_attention_ref(tq, tk, tv, causal, scale)
    delta = (tdo * o).sum(-1)
    dq = flash_attention_bwd_dq_ref(tq, tk, tv, tdo, lse, delta, causal,
                                    scale)
    dk, dv = flash_attention_bwd_dkv_ref(tq, tk, tv, tdo, lse, delta, causal,
                                         scale)
    assert dq.shape == q.shape and dk.shape == k.shape \
        and dv.shape == v.shape
    errs = _rel((dq, dk, dv), _oracle_vjp(q, k, v, do, causal, scale))
    assert max(errs) <= GRAD_RTOL, errs


@pytest.mark.parametrize("B,H,KV,Sq,Sk,d,causal,scale", BWD_CASES[4:])
def test_autograd_entry_matches_autograd_of_plain(B, H, KV, Sq, Sk, d, causal,
                                                 scale):
    """On the CPU the entry's forward is the plain forward, bitwise, and its
    backward (the explicit formulas) is torch's autograd of that forward;
    no launch is counted."""
    q, k, v = (torch.from_numpy(x).requires_grad_()
               for x in _qkv(B, H, KV, Sq, Sk, d, seed=Sq + d))
    do = torch.from_numpy(np.random.default_rng(d).normal(
        size=q.shape).astype(np.float32))
    before = (flash_attention_bwd_dq.launches,
              flash_attention_bwd_dkv.launches)
    o = flash_attention(q, k, v, causal, scale)
    want_o, _ = flash_attention_ref(q, k, v, causal, scale)
    assert torch.equal(o, want_o)
    errs = _rel(torch.autograd.grad(o, (q, k, v), do),
                torch.autograd.grad(want_o, (q, k, v), do))
    assert max(errs) <= AUTOGRAD_RTOL, errs
    assert (flash_attention_bwd_dq.launches,
            flash_attention_bwd_dkv.launches) == before == (0, 0)


def test_cpu_backward_wrappers_are_the_plain_versions():
    q, k, v = (torch.from_numpy(x) for x in _qkv(2, 4, 2, 30, 30, 32, 5))
    do = torch.ones_like(q)
    o, lse = flash_attention_ref(q, k, v, True)
    delta = (do * o).sum(-1)
    args = (q, k, v, do, lse, delta)
    assert torch.equal(flash_attention_bwd_dq(*args),
                       flash_attention_bwd_dq_ref(*args))
    for a, b in zip(flash_attention_bwd_dkv(*args),
                    flash_attention_bwd_dkv_ref(*args)):
        assert torch.equal(a, b)
    assert ops.KERNELS["flash_attention_bwd_dq"] is flash_attention_bwd_dq
    assert ops.KERNELS["flash_attention_bwd_dkv"] is flash_attention_bwd_dkv
    assert ops.flash_attention is flash_attention


def _bwd_args(q_shape=(1, 4, 8, 16), kv_shape=(1, 2, 8, 16), dtype=None,
              device="cpu"):
    z = dict(dtype=dtype or torch.float32, device=device)
    q = torch.zeros(q_shape, **z)
    kv = torch.zeros(kv_shape, **z)
    return (q, kv, kv.clone(), torch.zeros(q_shape, **z),
            torch.zeros(q_shape[:3], **z), torch.zeros(q_shape[:3], **z))


@pytest.mark.parametrize("wrapper", [flash_attention_bwd_dq,
                                     flash_attention_bwd_dkv])
@pytest.mark.parametrize("dtype", [torch.float64, torch.bfloat16])
def test_backward_wrappers_refuse_other_dtypes(wrapper, dtype):
    with pytest.raises(TypeError):
        wrapper(*_bwd_args(dtype=dtype))


@pytest.mark.parametrize("wrapper", [flash_attention_bwd_dq,
                                     flash_attention_bwd_dkv])
@pytest.mark.parametrize("bad", ["kv_heads", "head_dim", "do", "lse",
                                 "delta"])
def test_backward_wrappers_refuse_bad_shapes(wrapper, bad):
    args = list(_bwd_args())
    if bad == "kv_heads":
        args[1] = args[2] = torch.zeros(1, 3, 8, 16)
    elif bad == "head_dim":
        args = list(_bwd_args((1, 4, 8, 48), (1, 2, 8, 48)))
    elif bad == "do":
        args[3] = torch.zeros(1, 4, 9, 16)
    elif bad == "lse":
        args[4] = torch.zeros(1, 4, 9)
    else:
        args[5] = torch.zeros(1, 4)
    with pytest.raises(ValueError):
        wrapper(*args)


@pytest.mark.parametrize("wrapper", [flash_attention_bwd_dq,
                                     flash_attention_bwd_dkv])
def test_backward_wrappers_refuse_devices_and_gradients(wrapper):
    """No fallback: meta tensors raise, as does an input that requires a
    gradient (the autograd entry passes detached tensors)."""
    with pytest.raises(ValueError, match="no kernel"):
        wrapper(*_bwd_args(device="meta"))
    args = list(_bwd_args())
    args[0] = args[0].requires_grad_()
    with pytest.raises(ValueError, match="gradient"):
        wrapper(*args)
    args = list(_bwd_args())
    args[3] = torch.zeros(1, 16, 8, 4).transpose(1, 3)
    with pytest.raises(ValueError, match="contiguous"):
        wrapper(*args)


# ---------------------------------------------------------------------------
# the backward kernels' numerics: 3xTF32 on the tensor cores
# ---------------------------------------------------------------------------

KERNEL_GRAD_RTOL = 1e-5  # chip_smoke.py phase 11's bar for the CUDA kernels


def _tf32(x):
    """x rounded to TF32 as the kernels round it: to nearest, ties away
    from zero, at mantissa bit 13 (``(bits + 0x1000) & 0xffffe000``)."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _mm_tf32(a, b, passes):
    """a (..., M, K) @ b (..., K, N) as the kernels' mma.sync runs it:
    each operand split as hi = tf32(x), lo = tf32(x - hi); for every 8
    steps of K the products lo*hi, hi*lo and hi*hi (``passes`` 3), or hi*hi
    alone (``passes`` 1: one TF32 product), each summed in float32 and
    added to a float32 sum."""
    ah, bh = _tf32(a), _tf32(b)
    terms = [(_tf32(a - ah), bh), (ah, _tf32(b - bh)), (ah, bh)]
    out = torch.zeros(*a.shape[:-1], b.shape[-1])
    for k0 in range(0, a.shape[-1], 8):
        for x, y in terms[3 - passes:]:
            out = out + x[..., k0:k0 + 8] @ y[..., k0:k0 + 8, :]
    return out


def _tf32_backward(q, k, v, do, lse, delta, passes):
    """The recomputation of ``flash_attention_bwd_dq_ref`` and
    ``flash_attention_bwd_dkv_ref`` (causal, default scale) with every
    product through ``_mm_tf32`` in the kernels' order: s = scale (q k^T),
    each KV head's dk and dv one sum over its G query heads' rows."""
    B, H, S, d = q.shape
    KV = k.shape[1]
    G, sc = H // KV, 1.0 / math.sqrt(d)
    kg, vg = k.repeat_interleave(G, 1), v.repeat_interleave(G, 1)
    keep = torch.ones(S, S, dtype=torch.bool).tril()
    s = _mm_tf32(q, kg.transpose(-1, -2), passes) * sc
    p = torch.where(keep, torch.exp(s - lse[..., None]), 0.0)
    ds = p * (_mm_tf32(do, vg.transpose(-1, -2), passes) - delta[..., None])
    dq = _mm_tf32(ds, kg, passes) * sc

    def by_kv_head(x):          # (B, H, Sq, Sk) -> (B, KV, Sk, G * Sq)
        return x.reshape(B, KV, G, S, S).permute(0, 1, 4, 2, 3).reshape(
            B, KV, S, G * S)
    dk = _mm_tf32(by_kv_head(ds), q.reshape(B, KV, G * S, d), passes) * sc
    dv = _mm_tf32(by_kv_head(p), do.reshape(B, KV, G * S, d), passes)
    return dq, dk, dv


@pytest.mark.parametrize("passes", [3, 1])
@pytest.mark.parametrize("d", [64, 128])
def test_tensor_core_numerics(d, passes):
    """The CUDA backward kernels run every product in 3xTF32: emulated
    here, their recomputation stays within phase 11's 1e-5 of each
    gradient's max from ``jax.vjp`` of the oracle (GQA, 4 query heads over
    2, causal, S 256), while one TF32 product (``passes`` 1) misses that
    bar, so the bar would catch a kernel that dropped to plain TF32."""
    B, H, KV, S = 1, 4, 2, 256
    q, k, v = _qkv(B, H, KV, S, S, d, seed=17 + d)
    do = np.random.default_rng(d).normal(size=q.shape).astype(np.float32)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    o, lse = flash_attention_ref(tq, tk, tv, True)
    got = _tf32_backward(tq, tk, tv, tdo, lse, (tdo * o).sum(-1), passes)
    worst = max(_rel(got, _oracle_vjp(q, k, v, do, True, None)))
    if passes == 3:
        assert worst <= KERNEL_GRAD_RTOL, worst
    else:
        assert worst > KERNEL_GRAD_RTOL, worst


# the forward kernel's key tile at each head dim (csrc/flash_attention.cu)
FWD_BK = {64: 64, 128: 32}


def _tf32_forward(q, k, v, BK, passes):
    """The forward kernel's tile loop (causal, default scale) with both
    products through ``_mm_tf32``: per key tile s = scale (q k^T), the
    online softmax's running max m and sum l, and o rescaled by alpha, then
    joined by the tile's P V in one float32 add -> (o, lse).  Tiles past a
    row's diagonal leave it as it is (alpha 1, p 0), so every row takes
    every tile, as a block's rows take its tiles."""
    B, H, S, d = q.shape
    G, sc = H // k.shape[1], 1.0 / math.sqrt(d)
    kg, vg = k.repeat_interleave(G, 1), v.repeat_interleave(G, 1)
    m = torch.full((B, H, S, 1), -1e30)
    l = torch.zeros(B, H, S, 1)
    o = torch.zeros(B, H, S, d)
    for k0 in range(0, S, BK):
        s = _mm_tf32(q, kg[:, :, k0:k0 + BK].transpose(-1, -2), passes) * sc
        keep = torch.arange(k0, k0 + s.shape[-1])[None, :] \
            <= torch.arange(S)[:, None]
        s = torch.where(keep, s, -1e30)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        o = o * alpha + _mm_tf32(p, vg[:, :, k0:k0 + BK], passes)
        m = m_new
    return o / l, (m + torch.log(l))[..., 0]


@pytest.mark.parametrize("passes", [3, 1])
@pytest.mark.parametrize("d", [64, 128])
def test_forward_tensor_core_numerics(d, passes):
    """The CUDA forward kernel runs both products in 3xTF32: emulated here
    at its key tile, o and lse stay within phase 9's o atol 2e-5 and lse
    atol 1e-5 of the oracle (GQA, 4 query heads over 2, causal, S 256),
    while one TF32 product (``passes`` 1) misses them, so phase 9 would
    catch a kernel that dropped to plain TF32."""
    B, H, KV, S = 1, 4, 2, 256
    q, k, v = _qkv(B, H, KV, S, S, d, seed=29 + d)
    o, lse = _tf32_forward(*(torch.from_numpy(x) for x in (q, k, v)),
                           FWD_BK[d], passes)
    want_o, want_lse = map(np.asarray, _oracle(q, k, v, True))
    err_o = float(np.abs(o.numpy() - want_o).max())
    err_lse = float(np.abs(lse.numpy() - want_lse).max())
    if passes == 3:
        assert err_o <= O_ATOL and err_lse <= LSE_ATOL, (err_o, err_lse)
    else:
        assert err_o > O_ATOL and err_lse > LSE_ATOL, (err_o, err_lse)


def _tc_truncation():
    """``tools/tc_truncation.py``: the kernels' tensor-core sums, with the
    truncation of each ``mma.sync``, emulated in numpy."""
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "tools" \
        / "tc_truncation.py"
    spec = importlib.util.spec_from_file_location("tc_truncation", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("join", [2, None])
@pytest.mark.parametrize("d", [64, 128])
def test_dp_join_keeps_degenerate_gradients_under_the_bar(d, join):
    """dq and dk at Sq = Sk = 1 are exactly 0, so phase 11 measures their
    rounding against 0.1 of the largest gradient.  With the tensor cores'
    truncation emulated, dp summed as the kernels sum it (a rounded add
    every 16 columns, ``join`` 2) keeps every draw under the bar, while one
    chain over the head dim (``join`` None) misses it on some draws."""
    errs = _tc_truncation().degenerate_errors(d, join, draws=100, seed=d)
    if join:
        assert errs.max() <= KERNEL_GRAD_RTOL, errs.max()
    else:
        assert errs.max() > KERNEL_GRAD_RTOL, errs.max()
