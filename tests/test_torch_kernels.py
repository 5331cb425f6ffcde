"""The port's INT8 wire stage against the reference.

``wire_roundtrip_ref`` (the plain PyTorch version of the CUDA kernel,
which is what the wrapper runs on a CPU tensor) must equal the
reference's wire stage BITWISE: the Pallas kernel in interpret mode and
the jitted ``vmap(dequantize∘quantize)`` it is pinned to.  On the card
``chip_smoke.py`` holds the CUDA kernel bitwise against the same plain
version.
"""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ops as jops  # noqa: E402
from repro.quant.int8 import dequantize as jdequantize  # noqa: E402
from repro.quant.int8 import quantize as jquantize  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels.int8_quant import (wire_roundtrip,  # noqa: E402
                                            wire_roundtrip_ref)
from repro_torch.quant.int8 import (INV_255, dequantize,  # noqa: E402
                                    quantize)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs files in parallel workers: one intra-op thread per
    worker keeps torch from oversubscribing the cores (results do not
    depend on it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_vmapped = jax.jit(jax.vmap(lambda a: jdequantize(jquantize(a))))
# the reference always quantizes under jit, where XLA turns "/ 255" into
# a multiply by float32(1/255); eager JAX divides and can differ by one
# level — the port follows the jitted program
_per_tensor = jax.jit(lambda a: tuple(jquantize(a)))


def _x(B, shape, seed):
    rng = np.random.default_rng(seed)
    return (3.0 * rng.normal(size=(B,) + shape) + 1.0).astype(np.float32)


@pytest.mark.parametrize("B,shape", [(1, (40, 32)), (5, (16, 16)),
                                     (17, (7,)), (64, (16, 16)),
                                     (3, (100,)), (13, (10, 8, 4)),
                                     (2, (128,)), (33, (20, 24))])
def test_wire_ref_bitwise_matches_reference(B, shape):
    """Same sweep as the reference's own wire-kernel test."""
    x = _x(B, shape, B + sum(shape))
    port = wire_roundtrip(torch.from_numpy(x))
    assert port.dtype == torch.float32 and tuple(port.shape) == x.shape
    np.testing.assert_array_equal(port.numpy(),
                                  np.asarray(jops.wire_roundtrip(x)))
    np.testing.assert_array_equal(port.numpy(), np.asarray(_vmapped(x)))


@pytest.mark.parametrize("B,n", [(13, 3200), (8, 6400), (1, 12800),
                                 (5, 257), (3, 3328), (2, 6656)])
def test_wire_ref_bitwise_at_serving_widths(B, n):
    x = _x(B, (n,), n)
    np.testing.assert_array_equal(wire_roundtrip_ref(torch.from_numpy(x))
                                  .numpy(), np.asarray(_vmapped(x)))


def test_wire_ref_constant_and_outlier_rows():
    """A constant row hits the 1e-12 scale floor; an outlier stretches
    the range so every other element lands on a few levels."""
    x = _x(4, (300,), 7)
    x[0] = 1.25
    x[1, 17] = 1e4
    x[2] = 0.0
    port = wire_roundtrip_ref(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(port, np.asarray(_vmapped(x)))
    np.testing.assert_array_equal(port[0], x[0])


def test_wire_ref_nan_row():
    """A NaN element makes its row NaN (NaN scale and zero) and leaves the
    other rows as they were, in the reference and the port alike."""
    x = _x(3, (300,), 8)
    x[1, 17] = np.nan
    port = wire_roundtrip_ref(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(port, np.asarray(jops.wire_roundtrip(x)))
    np.testing.assert_array_equal(port, np.asarray(_vmapped(x)))
    assert np.isnan(port[1]).all() and not np.isnan(port[[0, 2]]).any()


@pytest.mark.parametrize("where", ["+inf", "-inf", "nan", "both_infs"])
def test_wire_ref_infinite_and_nan_rows(where):
    """A row with +inf, -inf or NaN: every element of the row is NaN but
    for +inf's own element, which comes back +inf (the reference
    dequantizes the level converted to int8, and NaN converts to 0); the
    other rows keep their values.  Against the Pallas wire and the jitted
    per-sample quantize∘dequantize."""
    x = _x(4, (300,), 10)
    if where in ("+inf", "both_infs"):
        x[1, 17] = np.inf
    if where in ("-inf", "both_infs"):
        x[1, 40] = -np.inf
    if where == "nan":
        x[1, 17] = np.nan
    port = wire_roundtrip_ref(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(port, np.asarray(jops.wire_roundtrip(x)))
    np.testing.assert_array_equal(port, np.asarray(_vmapped(x)))
    assert not np.isnan(port[[0, 2, 3]]).any()
    if where == "+inf":
        assert port[1, 17] == np.inf and np.isnan(np.delete(port[1], 17)).all()
    else:
        assert np.isnan(port[1]).all()


def test_wire_b1_equals_per_tensor_round_trip():
    x = _x(1, (24, 16), 9)
    t = torch.from_numpy(x)
    np.testing.assert_array_equal(wire_roundtrip_ref(t).numpy(),
                                  dequantize(quantize(t)).numpy())


@pytest.mark.parametrize("shape", [(100,), (37, 91), (8, 16, 33), (5000,),
                                   (2, 40, 32)])
def test_quantize_bitwise_matches_reference(shape):
    x = _x(1, shape, sum(shape))[0]
    q, scale, zero = _per_tensor(x)
    pt = quantize(torch.from_numpy(x))
    assert pt.q.dtype == torch.int8
    np.testing.assert_array_equal(pt.q.numpy(), np.asarray(q))
    assert pt.scale.item() == float(scale) and pt.zero.item() == float(zero)
    assert pt.wire_bytes == x.size + 8
    np.testing.assert_array_equal(
        dequantize(pt).numpy(),
        np.asarray(jax.jit(lambda a: jdequantize(jquantize(a)))(x)))


def test_scale_constant_is_float32_reciprocal_of_255():
    assert np.float32(INV_255).view(np.uint32) == 0x3B808081


def test_wrapper_on_cpu_runs_plain_version_without_launching():
    x = torch.from_numpy(_x(3, (50,), 1))
    before = wire_roundtrip.launches
    np.testing.assert_array_equal(wire_roundtrip(x).numpy(),
                                  wire_roundtrip_ref(x).numpy())
    assert wire_roundtrip.launches == before
    assert ops.KERNELS["wire_roundtrip"] is wire_roundtrip


def test_wrapper_refuses_devices_without_a_kernel():
    with pytest.raises(ValueError):
        wire_roundtrip(torch.empty(2, 8, device="meta"))


def test_build_names_library_by_source_and_flags():
    path = build.library_path("wire_roundtrip.cu")
    assert path.parent == build.BUILD_DIR and path.suffix == ".so"
    assert path == build.library_path("wire_roundtrip.cu")
    assert "-fmad=false" in build.NVCC_FLAGS
    assert "--use_fast_math" not in build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    for src in build.SOURCES:
        assert (build.CSRC / src).exists()
