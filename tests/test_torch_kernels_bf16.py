"""The port's 16-bit inputs to the wire, INT8, GMM and InfoNCE kernels
against the reference.

The reference's Pallas kernels take bf16 input (the wire float16 too) and
widen it to float32 in the kernel; ``tests/test_kernels.py`` sweeps them
in bf16 at its own bars.  Here, at the reference's bf16 sweep shapes, the
port's plain versions (what each wrapper runs on a CPU tensor, and what
the kernel is held against on the card) go through:

- the reference's own bf16 bars against ``repro.kernels.ops`` run on the
  same bf16 values (interpret mode): INT8 levels at most 1 apart, scale
  rtol 1e-6, dequantized within 0.51 scale; gmm resp atol 3e-2, entropy
  0.15; InfoNCE atol 0.3, rtol 1e-2;
- the tighter bar, the reference run on the widened (float32) input:
  the INT8 levels, scale and zero and the wire bitwise (its jitted
  quantize), gmm and InfoNCE at the reference's float32 bars;
- the contract of the kernels: a 16-bit input gives the bits of the
  float32 call on ``x.float()`` (widening is exact), the gradients that
  result rounded to bf16;
- the bf16 gradient of ``infonce_vneg`` against ``jax.grad`` of the
  reference's ``core/infonce.py`` objective on the widened inputs;
- the wrappers' refusal of float64, integer and mixed inputs.

Inputs are made with numpy from a seed.  ``chip_smoke.py`` holds the
kernels themselves on the card (phases 1, 3, 5 and 7).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import infonce as jinfo  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.quant import int8 as jint8  # noqa: E402
from repro_torch.kernels.gmm_posterior import gmm_posterior  # noqa: E402
from repro_torch.kernels.infonce_vneg import (  # noqa: E402
    infonce_vneg, infonce_vneg_bwd, infonce_vneg_fwd)
from repro_torch.kernels.int8_quant import (  # noqa: E402
    int8_dequantize, int8_quantize, int8_quantize_roundtrip, wire_roundtrip,
    wire_roundtrip_grouped)

BF16 = torch.bfloat16
TAU = 0.1


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per worker (the suite runs files in parallel);
    results do not depend on it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sphere(rng, shape):
    z = rng.normal(size=shape).astype(np.float32)
    return z / np.linalg.norm(z, axis=-1, keepdims=True)


def _narrow(a, dtype=BF16):
    """-> (the 16-bit torch tensor, its values widened to float32 numpy)."""
    t = torch.from_numpy(np.ascontiguousarray(a)).to(dtype)
    return t, t.float().numpy()


def _jnp(wide, dtype=jnp.bfloat16):
    """The same 16-bit values in JAX (exact: they are representable)."""
    return jnp.asarray(wide).astype(dtype)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


# --- INT8 per tensor (kernels 2 and 3) ------------------------------------

_jit_quantize = jax.jit(lambda a: tuple(jint8.quantize(a)))


@pytest.mark.parametrize("shape", [(100,), (37, 91), (8, 16, 33), (5000,)])
def test_int8_bf16_sweep(shape):
    rng = np.random.default_rng(sum(shape))
    x, wide = _narrow(3.0 * rng.normal(size=shape) + 1.0)
    qt = int8_quantize(x)
    assert qt.q.dtype == torch.int8 and qt.scale.dtype == torch.float32
    # the reference's bf16 bars, against its Pallas kernel on bf16 x
    q, sc, zo = jops.int8_quantize(_jnp(wide))
    assert np.abs(qt.q.numpy().astype(np.int32)
                  - np.asarray(q).astype(np.int32)).max() <= 1
    np.testing.assert_allclose(qt.scale.item(), float(sc), rtol=1e-6)
    xd = int8_dequantize(qt)
    assert float((xd - x.float()).abs().max()) <= qt.scale.item() * 0.51 \
        + 1e-6
    # the tighter bar: the reference's jitted quantize of the widened x
    q2, sc2, zo2 = _jit_quantize(wide)
    np.testing.assert_array_equal(qt.q.numpy(), np.asarray(q2))
    assert qt.scale.item() == float(sc2) and qt.zero.item() == float(zo2)
    # the contract: bf16 x gives the bits of the float32 call on x.float()
    wq = int8_quantize(x.float())
    assert torch.equal(qt.q, wq.q) and torch.equal(qt.scale, wq.scale) \
        and torch.equal(qt.zero, wq.zero)
    (rq, out), (wrq, wout) = (int8_quantize_roundtrip(x),
                              int8_quantize_roundtrip(x.float()))
    assert out.dtype == torch.float32 and torch.equal(out, wout) \
        and torch.equal(rq.q, wrq.q)
    assert torch.equal(out, int8_dequantize(qt))


@pytest.mark.parametrize("shape", [(100,), (37, 91), (8, 16, 33), (5000,)])
@pytest.mark.parametrize("dtype", [BF16, torch.float16, torch.float32])
def test_int8_dequantize_writes_the_asked_type(shape, dtype):
    """The dequantize's ``dtype=``: the float32 value rounded to nearest
    even, as the reference's kernel writes its output type."""
    rng = np.random.default_rng(7 + sum(shape))
    x = torch.from_numpy((3.0 * rng.normal(size=shape) + 1.0)
                         .astype(np.float32))
    qt = int8_quantize(x)
    out = int8_dequantize(qt, dtype=dtype)
    assert out.dtype == dtype
    assert torch.equal(out, int8_dequantize(qt).to(dtype))
    jdt = {BF16: jnp.bfloat16, torch.float16: jnp.float16,
           torch.float32: jnp.float32}[dtype]
    want = jops.int8_dequantize(jnp.asarray(qt.q.numpy()),
                                jnp.float32(qt.scale.item()),
                                jnp.float32(qt.zero.item()), dtype=jdt)
    np.testing.assert_array_equal(out.float().numpy(),
                                  np.asarray(want).astype(np.float32))


# --- the wire (kernel 1) --------------------------------------------------

@pytest.mark.parametrize("B,shape", [(5, (16, 16)), (17, (7,)),
                                     (3, (100,)), (13, (10, 8, 4))])
@pytest.mark.parametrize("dtype", [BF16, torch.float16])
def test_wire_16bit_matches_reference_bitwise(B, shape, dtype):
    """The reference's wire casts its input to float32 and is bitwise its
    vmapped quantize∘dequantize: the port's, on the 16-bit x, equals it
    bit for bit, and equals the port's float32 call on x.float()."""
    rng = np.random.default_rng(B + sum(shape))
    x, wide = _narrow(3.0 * rng.normal(size=(B,) + shape) + 1.0, dtype)
    out = wire_roundtrip(x)
    assert out.dtype == torch.float32 and out.shape == x.shape
    jdt = jnp.bfloat16 if dtype == BF16 else jnp.float16
    np.testing.assert_array_equal(out.numpy(),
                                  np.asarray(jops.wire_roundtrip(
                                      _jnp(wide, jdt))))
    assert torch.equal(out, wire_roundtrip(x.float()))
    y = torch.from_numpy(rng.normal(size=(4, 9)).astype(np.float32)).to(dtype)
    grouped = wire_roundtrip_grouped([x, y])
    assert torch.equal(grouped[0], out)
    assert torch.equal(grouped[1], wire_roundtrip(y.float()))


# --- the GMM posterior (kernel 6) ------------------------------------------

@pytest.mark.parametrize("B,C,d", [(64, 8, 32), (200, 64, 128),
                                   (33, 16, 64), (128, 32, 256)])
def test_gmm_bf16_sweep(B, C, d):
    rng = np.random.default_rng(B + C + d)
    z, wide = _narrow(_sphere(rng, (B, d)))
    mu = (0.5 * rng.normal(size=(C, d))).astype(np.float32)
    var = rng.uniform(0.05, 0.5, size=(C, d)).astype(np.float32)
    logits = rng.normal(size=C).astype(np.float32)
    logpi = (logits - np.log(np.exp(logits).sum())).astype(np.float32)
    tm, tv, tl = (torch.from_numpy(a) for a in (mu, var, logpi))
    resp, ent = gmm_posterior(z, tm, tv, tl)
    assert resp.dtype == ent.dtype == torch.float32
    # the reference's bf16 bars, against its Pallas kernel on bf16 z
    r1, e1 = jops.gmm_posterior(_jnp(wide), mu, var, logpi, block_b=64)
    np.testing.assert_allclose(resp.numpy(), np.asarray(r1), atol=3e-2)
    np.testing.assert_allclose(ent.numpy(), np.asarray(e1), atol=0.15)
    # the tighter bar: the reference's oracle on the widened z, at its
    # float32 bars
    r2, e2 = jref.gmm_posterior_ref(wide, mu, var, logpi)
    np.testing.assert_allclose(resp.numpy(), np.asarray(r2), atol=1e-4)
    np.testing.assert_allclose(ent.numpy(), np.asarray(e2), atol=5e-4)
    # the contract: the bits of the float32 call on z.float()
    wr, we = gmm_posterior(z.float(), tm, tv, tl)
    assert torch.equal(resp, wr) and torch.equal(ent, we)


# --- streaming InfoNCE (kernels 7 and 7b) ----------------------------------

def _infonce_inputs(B, N, d):
    rng = np.random.default_rng(B * N + d)
    return [_narrow(_sphere(rng, s)) for s in ((B, d), (B, d), (B, N, d))]


@pytest.mark.parametrize("B,N,d", [(32, 64, 32), (64, 256, 128),
                                   (16, 100, 64)])
def test_infonce_bf16_sweep(B, N, d):
    (z, wz), (zp, wzp), (zn, wzn) = _infonce_inputs(B, N, d)
    loss, lse = infonce_vneg_fwd(z, zp, zn, TAU)
    assert loss.dtype == lse.dtype == torch.float32
    # the reference's bf16 bars, against its Pallas kernel on bf16 inputs
    l1 = jops.infonce_vneg(_jnp(wz), _jnp(wzp), _jnp(wzn), tau=TAU)
    np.testing.assert_allclose(loss.numpy(), np.asarray(l1), atol=0.3,
                               rtol=1e-2)
    # the tighter bar: its oracle on the widened inputs (float32, rtol 1e-5
    # as tests/test_torch_infonce_vneg.py holds the float32 path)
    l2 = jref.infonce_vneg_ref(wz, wzp, wzn, TAU)
    np.testing.assert_allclose(loss.numpy(), np.asarray(l2), rtol=1e-5)
    # the contract, forward and backward: the float32 call's bits on the
    # widened inputs, the gradients rounded once to bf16
    wl, wlse = infonce_vneg_fwd(z.float(), zp.float(), zn.float(), TAU)
    assert torch.equal(loss, wl) and torch.equal(lse, wlse)
    g = torch.from_numpy(np.random.default_rng(d).normal(size=B)
                         .astype(np.float32))
    grads = infonce_vneg_bwd(z, zp, zn, lse, g, TAU)
    wide = infonce_vneg_bwd(z.float(), zp.float(), zn.float(), lse, g, TAU)
    for a, w in zip(grads, wide):
        assert a.dtype == BF16 and torch.equal(a, w.to(BF16))
    # and against jax.grad of the oracle on the widened inputs: the float32
    # gradient within half a bf16 ulp (at most 2^-8 of each element) and
    # the float32 path's 1e-5 of the max
    jg = jax.grad(lambda a, b, c: jnp.sum(jref.infonce_vneg_ref(a, b, c, TAU)
                                          * g.numpy()),
                  argnums=(0, 1, 2))(wz, wzp, wzn)
    for a, j in zip(grads, jg):
        j = np.asarray(j, np.float64)
        err = np.abs(a.float().numpy() - j)
        assert (err <= 2.0 ** -8 * np.abs(j) + 1e-5 * np.abs(j).max()).all()


@pytest.mark.parametrize("B,N,d", [(32, 64, 32), (16, 100, 64)])
def test_infonce_bf16_gradient_matches_core_infonce(B, N, d):
    """The differentiable entry on bf16 leaves (its gradients bf16)
    against ``jax.grad`` of the reference's ``core/infonce.py``
    ``streaming_infonce`` (the mean over samples) on the widened inputs.
    That objective normalises z and z_pos first, so its z and z_pos
    gradients are the tangential parts (I - u u^T) / |x| of the raw ones;
    the inputs are bf16-rounded unit vectors (|x| within ~1e-3 of 1).
    Bar: 1e-2 of each gradient's max, which holds the normalisation's
    effect and the bf16 rounding of the gradients (at most 2^-8 of each
    element)."""
    (z, wz), (zp, wzp), (zn, wzn) = _infonce_inputs(B, N, d)
    leaves = [x.clone().requires_grad_() for x in (z, zp, zn)]
    with torch.enable_grad():
        loss = infonce_vneg(*leaves, TAU).mean()
        grads = torch.autograd.grad(loss, leaves)
    assert all(x.dtype == BF16 for x in grads)
    want_loss, want = jax.value_and_grad(
        lambda a, b, c: jinfo.streaming_infonce(a, b, c, tau=TAU),
        argnums=(0, 1, 2))(wz, wzp, wzn)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-2)

    def tangent(g, x):
        n = np.linalg.norm(x, axis=-1, keepdims=True)
        u = x / n
        return (g - (g * u).sum(-1, keepdims=True) * u) / n
    got = [tangent(grads[0].float().numpy(), wz),
           tangent(grads[1].float().numpy(), wzp), grads[2].float().numpy()]
    for name, a, b in zip(("dz", "dz_pos", "dz_neg"), got, want):
        assert _rel(a, b) <= 1e-2, name


# --- refusals ---------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float64, torch.int32])
def test_wrappers_refuse_other_types(dtype):
    x = torch.ones(4, 8, dtype=dtype)
    f = torch.ones(4, 8)
    calls = [lambda: wire_roundtrip(x),
             lambda: wire_roundtrip_grouped([x]),
             lambda: int8_quantize(x),
             lambda: int8_quantize_roundtrip(x),
             lambda: gmm_posterior(x, f[:2], f[:2], torch.zeros(2)),
             lambda: infonce_vneg_fwd(x, x, x[:, None], TAU),
             lambda: infonce_vneg(x, x, x[:, None], TAU),
             lambda: infonce_vneg_bwd(x, x, x[:, None], torch.zeros(4),
                                      torch.ones(4), TAU)]
    if dtype.is_floating_point:
        calls.append(lambda: int8_dequantize(int8_quantize(f), dtype=dtype))
    for call in calls:
        with pytest.raises(TypeError):
            call()


def test_wrappers_refuse_mixed_types():
    b = torch.ones(4, 8, dtype=BF16)
    f = torch.ones(4, 8)
    with pytest.raises(TypeError):
        wire_roundtrip_grouped([b, f])
    with pytest.raises(TypeError):
        gmm_posterior(f, b[:2], f[:2], torch.zeros(2))
    for args in ((b, f, b[:, None]), (b, b, f[:, None])):
        with pytest.raises(TypeError):
            infonce_vneg_fwd(*args, TAU)
        with pytest.raises(TypeError):
            infonce_vneg(*args, TAU)
