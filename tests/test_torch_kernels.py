"""The port's INT8 wire stage against the reference.

``wire_roundtrip_ref`` (the plain PyTorch version of the CUDA kernel,
which is what the wrapper runs on a CPU tensor) must equal the
reference's wire stage BITWISE: the Pallas kernel in interpret mode and
the jitted ``vmap(dequantize∘quantize)`` it is pinned to.  So must the
grouped wire's plain version, bucket by bucket, at the serving tick's
eight boundary shapes.  On the card ``chip_smoke.py`` holds the CUDA
kernel (one group and many) bitwise against the same plain versions.
"""
import ctypes
import re

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ops as jops  # noqa: E402
from repro.quant.int8 import dequantize as jdequantize  # noqa: E402
from repro.quant.int8 import quantize as jquantize  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels.int8_quant import (  # noqa: E402
    MAX_GROUPS, _Group, _GroupTable, group_plan, wire_roundtrip,
    wire_roundtrip_grouped, wire_roundtrip_grouped_ref, wire_roundtrip_ref)
from repro_torch.models.audio_encoder import AudioEncCfg  # noqa: E402
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
    with pytest.raises(ValueError, match="no kernel"):
        wire_roundtrip_grouped([torch.empty(2, 8, device="meta")])
    with pytest.raises(ValueError, match="inputs on"):
        wire_roundtrip_grouped([torch.zeros(2, 8),
                                torch.empty(2, 8, device="meta")])


# --- the grouped wire: the serving tick's buckets in one launch -------------

def _tick_widths():
    """Elements a frame at k = 0..L-1 of the full-width encoder: the raw
    mel, then each block's output ("SAME" convolutions keep ceil(t/s)
    frames)."""
    cfg = AudioEncCfg()
    t, out = cfg.frames, [cfg.frames * cfg.n_mels]
    for w, s in zip(cfg.widths[:-1], cfg.strides[:-1]):
        t = -(-t // s)
        out.append(t * w)
    return out


def _special_rows(x):
    """A constant row, an outlier, NaN, +inf and -inf rows (where the
    group has them), as chip_smoke's phase 1 plants them, each at an
    element its row has."""
    flat = x.reshape(x.shape[0], -1)
    for row, (col, v) in enumerate([(None, 1.25), (17, 1e4), (5, np.nan),
                                    (11, np.inf), (7, -np.inf)]):
        if row >= x.shape[0]:
            break
        if col is None:
            flat[row] = v
        else:
            flat[row, col % flat.shape[1]] = v
    return x


@pytest.mark.parametrize("rows", [(28, 29, 28, 28, 29, 28, 28, 29),
                                  (32,) * 8, (1, 5, 3, 1, 2, 7, 1, 4)],
                         ids=["tick", "padded", "ragged"])
def test_grouped_wire_ref_bitwise_matches_reference_at_tick_shapes(rows):
    """The grouped wire's plain version over the tick's eight boundary
    shapes (n 3,200-12,800), bucket by bucket, against the reference's
    jitted per-sample quantize∘dequantize, with constant, outlier, NaN
    and infinite rows; and against the port's own per-bucket wire."""
    xs = [_special_rows(_x(B, (n,), B * n)) for B, n in
          zip(rows, _tick_widths())]
    got = wire_roundtrip_grouped([torch.from_numpy(x) for x in xs])
    assert len(got) == len(xs)
    for x, g in zip(xs, got):
        assert g.dtype == torch.float32 and tuple(g.shape) == x.shape
        np.testing.assert_array_equal(g.numpy(), np.asarray(_vmapped(x)))
        np.testing.assert_array_equal(
            g.numpy(), wire_roundtrip(torch.from_numpy(x)).numpy())


def test_grouped_wire_ref_matches_pallas_on_ragged_groups():
    """Ragged groups of several widths and shapes (B = 1 groups, a width
    off the TPU kernel's 128 lanes), against the Pallas wire kernel in
    interpret mode, group by group, with the special rows."""
    xs = [_special_rows(_x(B, shape, B + sum(shape))) for B, shape in
          [(1, (40, 32)), (5, (257,)), (3, (16, 16)), (1, (7,)),
           (6, (10, 8, 4))]]
    got = wire_roundtrip_grouped_ref([torch.from_numpy(x) for x in xs])
    for x, g in zip(xs, got):
        np.testing.assert_array_equal(g.numpy(),
                                      np.asarray(jops.wire_roundtrip(x)))


def test_grouped_wrapper_on_cpu_runs_plain_version_without_launching():
    xs = [torch.from_numpy(_x(B, (n,), n)) for B, n in [(3, 50), (1, 8)]]
    before = (wire_roundtrip.launches, wire_roundtrip_grouped.launches)
    for g, w in zip(wire_roundtrip_grouped(xs),
                    wire_roundtrip_grouped_ref(xs)):
        assert torch.equal(g, w)
    assert wire_roundtrip_grouped([]) == []
    assert (wire_roundtrip.launches, wire_roundtrip_grouped.launches) == \
        before
    assert ops.KERNELS["wire_roundtrip_grouped"] is wire_roundtrip_grouped


def _source():
    return (build.CSRC / "wire_roundtrip.cu").read_text()


def _source_const(name):
    return int(re.search(rf"constexpr int {name} = (\d+);",
                         _source()).group(1))


def test_group_plan_offsets_and_first_blocks():
    """One block a row, each group's blocks after the last one's; the
    plan of the tick's eight padded buckets is 256 blocks."""
    slots, blocks = group_plan([(28, 100, 128), (29, 3200), (1, 4, 4)])
    assert slots == [(0, 28, 12800, 0), (1, 29, 3200, 28), (2, 1, 16, 57)]
    assert blocks == 58
    slots, blocks = group_plan([(32, n) for n in _tick_widths()])
    assert [s[3] for s in slots] == [32 * i for i in range(8)]
    assert blocks == 256


def test_group_plan_skips_empty_groups():
    """A group with no rows takes no slot and no block, and comes back as
    an empty tensor; a group whose rows are empty raises."""
    slots, blocks = group_plan([(0, 64), (2, 8), (0,), (3, 5)])
    assert slots == [(1, 2, 8, 0), (3, 3, 5, 2)] and blocks == 5
    assert group_plan([(0, 8)]) == ([], 0)
    with pytest.raises(ValueError, match="empty"):
        group_plan([(2, 0)])
    with pytest.raises(ValueError, match="batch dim"):
        group_plan([()])
    outs = wire_roundtrip_grouped([torch.zeros(0, 8),
                                   torch.from_numpy(_x(2, (8,), 1))])
    assert tuple(outs[0].shape) == (0, 8)


def test_group_plan_refuses_more_than_the_maximum_group_count():
    """At most MAX_GROUPS groups with rows a launch (the source's
    kMaxGroups: the tick's eight buckets fit); empty groups do not
    count."""
    assert MAX_GROUPS == _source_const("kMaxGroups") >= 8
    group_plan([(1, 4)] * MAX_GROUPS + [(0, 4)] * 3)
    with pytest.raises(ValueError, match=f"at most {MAX_GROUPS}"):
        group_plan([(1, 4)] * (MAX_GROUPS + 1))
    with pytest.raises(ValueError, match="int32"):
        group_plan([(1, 2 ** 16, 2 ** 15)])


def test_group_table_layout_mirrors_the_source():
    """The ctypes table the wrapper packs has the layout of the source's
    Group and GroupTable (the kernel reads it as its by-value parameter),
    and every serving width fits a row held in registers."""
    text = _source()
    fields = re.search(r"struct Group \{(.*?)\};", text, re.S).group(1)
    names = re.findall(r"(\w+);", fields)
    assert names == [f for f, _ in _Group._fields_]
    assert ctypes.sizeof(_Group) == 32
    assert _GroupTable.g.offset == 0
    assert _GroupTable.count.offset == 32 * MAX_GROUPS
    assert ctypes.sizeof(_GroupTable) <= 4096          # a kernel parameter
    row_max = _source_const("kThreads") * \
        _source_const("kUnitsPerThread") * 4
    assert max(_tick_widths()) <= row_max == 16384
    assert all(n % 4 == 0 for n in _tick_widths())      # float4 rows


def test_build_names_library_by_source_and_flags():
    path = build.library_path("wire_roundtrip.cu")
    assert path.parent == build.BUILD_DIR and path.suffix == ".so"
    assert path == build.library_path("wire_roundtrip.cu")
    assert "-fmad=false" in build.NVCC_FLAGS
    assert "--use_fast_math" not in build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    for src in build.SOURCES:
        assert (build.CSRC / src).exists()
