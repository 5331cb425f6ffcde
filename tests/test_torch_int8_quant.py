"""The port's per-tensor INT8 quantize and dequantize against the
reference, and the per-frame split path that runs them.

``int8_quantize_ref`` / ``int8_dequantize_ref`` (the plain PyTorch
versions of the CUDA kernels in ``csrc/int8_quant.cu``, which the
wrappers run on a CPU tensor) must equal the reference BITWISE: its
Pallas kernels ``int8_quantize_pallas`` / ``int8_dequantize_pallas`` in
interpret mode (as ``tests/test_kernels.py`` runs them) and its oracle
``ref.int8_quantize_ref`` under ``jit``, the form the reference runs.
Eager JAX divides by 255 where XLA multiplies by float32(1/255) under
``jit``, so the eager oracle's scale can sit one ulp away; its levels
still agree on these inputs.  On the card ``chip_smoke.py`` holds the
CUDA kernels bitwise against the same plain versions.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.splitter import SplitEngine as JaxEngine  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import audio_encoder as jenc  # noqa: E402
from repro.quant import int8 as jint8  # noqa: E402
from repro_torch.core.splitter import SplitEngine  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels.int8_quant import (  # noqa: E402
    ONE_BLOCK_MAX, int8_dequantize, int8_dequantize_ref, int8_quantize,
    int8_quantize_ref, int8_quantize_roundtrip, int8_quantize_roundtrip_ref,
    quantize_plan)
from repro_torch.models import audio_encoder as enc  # noqa: E402
from repro_torch.quant.int8 import (QTensor, dequantize,  # noqa: E402
                                    fake_quant, quant_error, quantize)
from repro_torch.weights import params_from_jax  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs files in parallel workers: one intra-op thread per
    worker keeps torch from oversubscribing the cores (results do not
    depend on it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SMALL = dict(widths=(16, 16, 32, 32), strides=(1, 2, 1, 2), n_mels=32,
             frames=40, d_embed=32, groups=4)
CFG, JCFG = enc.AudioEncCfg(**SMALL), jenc.AudioEncCfg(**SMALL)
L = CFG.n_blocks
ATOL = 1e-5
_jit_oracle = jax.jit(jref.int8_quantize_ref)


def _x(shape, seed):
    return (3.0 * np.random.default_rng(seed).normal(size=shape)
            + 1.0).astype(np.float32)


# one element of a (4097,) tensor set to each value: an outlier, and the
# non-finite values whose NaN the kernels must carry as the plain
# versions do (NaN scale and zero, every level 0)
SPECIAL = {"outlier": 1e4, "nan": np.nan, "inf": np.inf, "-inf": -np.inf}


def _case(name):
    """The reference kernel sweep's shapes, plus a constant tensor (the
    1e-12 scale floor), one outlier and one non-finite element."""
    if name == "constant":
        return np.full((7, 9), 1.25, np.float32)
    if name in SPECIAL:
        x = _x((4097,), 5)
        x[17] = SPECIAL[name]
        return x
    return _x(name, sum(name))


def _same(a, b):
    """Equal floats, NaN equal to NaN."""
    return a == b or (np.isnan(a) and np.isnan(b))


CASES = [(100,), (37, 91), (8, 16, 33), (5000,), "constant", *SPECIAL]


@pytest.mark.parametrize("case", CASES, ids=str)
def test_plain_versions_bitwise_match_reference(case):
    x = _case(case)
    q, scale, zero = jops.int8_quantize(x)          # Pallas, interpret mode
    qt = int8_quantize(torch.from_numpy(x))         # the plain version
    assert qt.q.dtype == torch.int8 and tuple(qt.q.shape) == x.shape
    assert qt.scale.dtype == torch.float32 and qt.scale.dim() == 0
    np.testing.assert_array_equal(qt.q.numpy(), np.asarray(q))
    assert _same(qt.scale.item(), float(scale))
    assert _same(qt.zero.item(), float(zero))
    oq, oscale, ozero = _jit_oracle(x)
    np.testing.assert_array_equal(qt.q.numpy(), np.asarray(oq))
    assert _same(qt.scale.item(), float(oscale))
    assert _same(qt.zero.item(), float(ozero))
    eager_q, eager_scale, _ = jref.int8_quantize_ref(x)
    np.testing.assert_array_equal(qt.q.numpy(), np.asarray(eager_q))
    assert _same(qt.scale.item(), float(eager_scale)) or \
        abs(qt.scale.item() - float(eager_scale)) <= \
        np.spacing(np.float32(eager_scale))
    # the inverse, from the same payload and header
    out = int8_dequantize(qt)
    assert out.dtype == torch.float32
    np.testing.assert_array_equal(
        out.numpy(), np.asarray(jops.int8_dequantize(q, scale, zero)))
    assert qt.wire_bytes == x.size + 8
    if case == "constant":
        np.testing.assert_array_equal(out.numpy(), x)
    if case == "nan":
        assert (qt.q == 0).all() and torch.isnan(out).all()


@pytest.mark.parametrize("case", CASES, ids=str)
def test_quantize_roundtrip_plain_version_bitwise_matches_reference(case):
    """``int8_quantize_roundtrip``'s plain version: its payload and header
    are the reference's jitted ``quantize``, its output the reference's
    ``SplitEngine._qdq_tensor`` (the per-frame wire, one executable), and
    both equal the port's own quantize and the dequantize of it."""
    x = _case(case)
    qt, out = int8_quantize_roundtrip(torch.from_numpy(x))
    q, scale, zero = _jit_quantize[8](x)
    np.testing.assert_array_equal(qt.q.numpy(), np.asarray(q))
    assert _same(qt.scale.item(), float(scale))
    assert _same(qt.zero.item(), float(zero))
    assert out.dtype == torch.float32 and tuple(out.shape) == x.shape
    np.testing.assert_array_equal(out.numpy(),
                                  np.asarray(JaxEngine(JCFG)._qdq_tensor(x)))
    want = quantize(torch.from_numpy(x))
    assert all(torch.equal(a.nan_to_num(), b.nan_to_num())
               for a, b in zip(qt, want))
    np.testing.assert_array_equal(out.numpy(), dequantize(want).numpy())


# the reference's quantize as it runs, under jit, at each width
_jit_quantize = {b: jax.jit(lambda a, b=b: tuple(jint8.quantize(a, bits=b)))
                 for b in (1, 2, 4, 6, 8)}


@pytest.mark.parametrize("bits", sorted(_jit_quantize))
@pytest.mark.parametrize("case", [(257,), (37, 91), "constant", "outlier",
                                  "nan", "inf"], ids=str)
def test_quantize_bits_bitwise_matches_reference(bits, case):
    """``quantize(x, bits=b)`` against the reference's jitted quantize at
    b in {1, 2, 4, 6, 8}: XLA multiplies by float32(1 / (qmax - qmin))
    at every width, and so does the port; levels, scale, zero and the
    dequantized values bitwise."""
    x = _case(case)
    q, scale, zero = _jit_quantize[bits](x)
    qt = quantize(torch.from_numpy(x), bits=bits)
    np.testing.assert_array_equal(qt.q.numpy(), np.asarray(q))
    assert _same(qt.scale.item(), float(scale))
    assert _same(qt.zero.item(), float(zero))
    lo, hi = -(1 << (bits - 1)), (1 << (bits - 1)) - 1
    assert lo <= int(qt.q.min()) and int(qt.q.max()) <= hi
    np.testing.assert_array_equal(
        dequantize(qt).numpy(), np.asarray(jint8.dequantize(
            jint8.QTensor(q, scale, zero))))


@pytest.mark.parametrize("bits", [0, 9, 16])
def test_quantize_refuses_widths_outside_one_to_eight(bits):
    """Above 8 bits the levels do not fit the int8 payload (the reference
    hands them to an out-of-range conversion, no contract), and below 1
    there is no level: both raise."""
    with pytest.raises(ValueError, match="bits"):
        quantize(torch.zeros(4), bits=bits)


_jit_qdq = jax.jit(lambda a: jint8.dequantize(jint8.quantize(a)))


@pytest.mark.parametrize("case", [(64,), (8, 33), (257,), "constant",
                                  "outlier"], ids=str)
def test_fake_quant_and_quant_error_match_reference(case):
    """``fake_quant`` and ``quant_error`` bitwise against the reference's
    own operations (``x + stop_gradient(y - x)``, ``max |x - y|``), each
    rounded, on its jitted quantize∘dequantize ``y``: the form the port
    follows.  The reference evaluated otherwise differs by its compiler:
    eagerly it divides by 255 (another scale), and jitted on the CPU XLA
    contracts the dequantize's multiply and the subtraction into one FMA
    (one rounding less), so the port is held to the jitted
    ``fake_quant`` within 2 ulps, and to its ``quant_error`` within 1 ulp,
    of the largest |y|: the product's rounding and the roundings after
    it."""
    x = _case(case)
    y = _jit_qdq(x)
    want = np.asarray(jnp.add(x, jax.lax.stop_gradient(jnp.subtract(y, x))))
    got = fake_quant(torch.from_numpy(x))
    assert got.dtype == torch.float32 and tuple(got.shape) == x.shape
    np.testing.assert_array_equal(got.numpy(), want)
    # the FMA skips the product's rounding (half an ulp of |y|), which may
    # be several ulps of a smaller result: held in ulps of the largest |y|
    ulp = np.spacing(np.abs(np.asarray(y)).max())
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jax.jit(jint8.fake_quant)(x)),
                               rtol=0, atol=2 * ulp)
    err = quant_error(torch.from_numpy(x))
    assert err.dim() == 0
    assert err.item() == float(jnp.max(jnp.abs(jnp.subtract(x, y))))
    assert abs(err.item() - float(jax.jit(jint8.quant_error)(x))) <= ulp


def test_fake_quant_gradient_is_straight_through_as_in_reference():
    """The gradient of sum(w * fake_quant(x)) is w, bitwise, as
    ``jax.grad`` gives it (eagerly and jitted); and that of
    sum(fake_quant(x)^2) is 2 * fake_quant(x): the identity's Jacobian."""
    x = _case((8, 33))
    w = np.random.default_rng(3).normal(size=x.shape).astype(np.float32)
    tx = torch.from_numpy(x).requires_grad_(True)
    (torch.from_numpy(w) * fake_quant(tx)).sum().backward()
    jgrad = jax.grad(lambda a: jnp.sum(w * jint8.fake_quant(a)))
    for g in (jgrad, jax.jit(jgrad)):
        np.testing.assert_array_equal(tx.grad.numpy(), np.asarray(g(x)))
    np.testing.assert_array_equal(tx.grad.numpy(), w)
    tx.grad = None
    y = fake_quant(tx)
    (y ** 2).sum().backward()
    np.testing.assert_array_equal(tx.grad.numpy(), 2 * y.detach().numpy())


def test_fake_quant_keeps_the_input_dtype():
    x = torch.from_numpy(_x((32,), 4)).to(torch.bfloat16)
    y = fake_quant(x)
    assert y.dtype == torch.bfloat16
    assert torch.equal(y, x + (dequantize(quantize(x), x.dtype) - x))


def test_dequantize_casts_to_the_asked_dtype():
    qt = int8_quantize(torch.from_numpy(_x((64,), 3)))
    out = int8_dequantize(qt, dtype=torch.bfloat16)
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, int8_dequantize_ref(qt).to(torch.bfloat16))


@pytest.fixture(scope="module")
def setup():
    jp = jax.tree.map(np.asarray, jax.jit(lambda k: jenc.init_audio_encoder(
        JCFG, k))(jax.random.PRNGKey(0)))
    mel = np.random.default_rng(1).normal(
        size=(4, CFG.frames, CFG.n_mels)).astype(np.float32)
    return jp, params_from_jax(jp), mel, JaxEngine(JCFG)


@pytest.mark.parametrize("k", range(L + 1))
def test_run_stagewise_parity_with_reference(setup, k):
    """``SplitEngine.run`` (one scale and zero for the whole 4-frame
    batch) against the reference's ``run``, stage by stage: the edge
    stage at atol 1e-5 on the same mel, the per-tensor wire bitwise on
    the reference's activation, the server stage at atol 1e-5 on the
    same received activation, and the wire bytes exactly."""
    jp, tp, mel, jeng = setup
    eng = SplitEngine(CFG, device="cpu")
    j_z, j_wire = jeng.run(jp, mel, k)
    t_z, t_wire = eng.run(tp, mel, k)
    assert t_wire == j_wire
    j_act = np.array(jeng._edge_exec(min(k, L))(jp, mel))
    t_act = eng._edge_fn(min(k, L), tp, torch.from_numpy(mel))
    np.testing.assert_allclose(t_act.numpy(), j_act, rtol=0, atol=ATOL)
    if k == L:                    # fully local: no wire, no server stage
        np.testing.assert_allclose(t_z.numpy(), np.asarray(j_z), rtol=0,
                                   atol=ATOL)
        return
    j_rx = np.array(jeng._qdq_tensor(j_act))
    t_rx = ops.int8_dequantize(ops.int8_quantize(torch.from_numpy(j_act)))
    np.testing.assert_array_equal(t_rx.numpy(), j_rx)
    j_srv = np.asarray(jeng._server_exec(k)(jp, j_rx))
    t_srv = eng._server_fn(k, tp, torch.from_numpy(j_rx))
    np.testing.assert_allclose(t_srv.numpy(), j_srv, rtol=0, atol=ATOL)


@pytest.mark.parametrize("k", range(L + 1))
def test_run_b1_equals_run_batch_async_b1(setup, k):
    """At B=1 the per-tensor wire (``run``) and the per-row wire kernel
    (``run_batch_async``) are the same function of the same edge stage:
    the embeddings are equal bitwise."""
    _, tp, mel, _ = setup
    eng = SplitEngine(CFG, device="cpu")
    a, wa = eng.run(tp, mel[:1], k)
    b, wb = eng.run_batch_async(tp, torch.from_numpy(mel[:1]), k)
    assert wa == wb
    assert torch.equal(a, b)


def test_wrappers_on_cpu_run_plain_versions_without_launching(setup):
    _, tp, mel, _ = setup
    x = torch.from_numpy(_x((3, 50), 1))
    counts = (int8_quantize, int8_quantize_roundtrip, int8_dequantize)
    before = [w.launches for w in counts]
    qt, want = int8_quantize(x), int8_quantize_ref(x)
    assert all(torch.equal(a, b) for a, b in zip(qt, want))
    assert torch.equal(int8_dequantize(qt), int8_dequantize_ref(want))
    (rq, rout), (wq, wout) = (int8_quantize_roundtrip(x),
                              int8_quantize_roundtrip_ref(x))
    assert all(torch.equal(a, b) for a, b in zip(rq, wq))
    assert torch.equal(rout, wout)
    SplitEngine(CFG, device="cpu").run(tp, mel[:2], 1)
    assert [w.launches for w in counts] == before
    for w in counts:
        assert ops.KERNELS[w.__name__] is w


def test_wrappers_refuse_devices_without_a_kernel():
    """No fallback: a tensor that is neither on the CPU nor on a card
    raises, and the card's branch builds ``csrc/int8_quant.cu`` first,
    which raises here, where there is no ``nvcc``."""
    meta = torch.empty(4, 8, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        int8_quantize(meta)
    with pytest.raises(ValueError, match="no kernel"):
        int8_quantize_roundtrip(meta)
    with pytest.raises(ValueError, match="no kernel"):
        int8_dequantize(QTensor(q=meta.to(torch.int8), scale=meta[0, 0],
                                zero=meta[0, 0]))
    assert "int8_quant.cu" in build.SOURCES
    assert (build.CSRC / "int8_quant.cu").exists()
    try:
        build.nvcc()
    except RuntimeError:
        with pytest.raises(RuntimeError, match="nvcc"):
            build.load("int8_quant.cu")


def _source_const(name):
    text = (build.CSRC / "int8_quant.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


@pytest.mark.parametrize("n,plan", [
    (1, (1, 0)), (3, (1, 0)), (5, (1, 0)), (3200, (1, 0)), (12800, (1, 0)),
    (ONE_BLOCK_MAX, (1, 0)), (ONE_BLOCK_MAX + 1, (2, 2048)),
    (2 ** 24 + 3, (2, 2048))])
def test_quantize_plan_one_launch_up_to_one_block(n, plan):
    """``int8_quantize``'s launch plan: one launch and no scratch up to one
    block's 1,024 threads x 16 floats (every per-frame boundary shape,
    3,200-12,800 elements), two passes and their (lo, hi) partials above;
    the constants are the source's own."""
    assert quantize_plan(n) == plan
    assert ONE_BLOCK_MAX == _source_const("kOneBlockThreads") * \
        _source_const("kOneBlockPerThread") == 16384
    assert plan[1] in (0, 2 * _source_const("kMaxBlocks"))
    # the full-width boundaries of SplitEngine.run at k = 0..L-1 ("SAME"
    # convolutions keep ceil(t / s) frames)
    full = enc.AudioEncCfg()
    t, sizes = full.frames, [full.frames * full.n_mels]
    for w, s in zip(full.widths[:-1], full.strides[:-1]):
        t = -(-t // s)
        sizes.append(t * w)
    assert (min(sizes), max(sizes)) == (3200, 12800)
    assert all(quantize_plan(n) == (1, 0) for n in sizes)
