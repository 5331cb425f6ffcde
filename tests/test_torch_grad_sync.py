"""The port's gradient compression and synchronization
(``optim/compression.py``, ``distributed/grad_sync.py``) against the
reference's ``tests/test_optim.py`` oracles and its arithmetic.

``compress_decompress``, ``ErrorFeedback.apply`` (without an axis, and
with one at a single shard under the reference's own ``shard_map``) and
``int8_psum`` at one shard are held BITWISE against the reference: both
round half to even, divide by the scale and clip, one rounded operation
after another.  At four logical shards ``int8_psum`` is held bitwise
against its definition in numpy (one shared scale from the shards' max,
an exact int32 sum), and the data-parallel step against the reference
test's bars (exact below 1e-4, compressed below 1e-3 after 200 steps).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.compat import shard_map  # noqa: E402
from repro.optim import compression as jcomp  # noqa: E402
from repro_torch.distributed import PerShard  # noqa: E402
from repro_torch.distributed.grad_sync import (ef_init,  # noqa: E402
                                               make_compressed_dp_step,
                                               pmean_grads, psum_grads)
from repro_torch.launch.mesh import make_test_mesh  # noqa: E402
from repro_torch.optim import sgd_init, sgd_update  # noqa: E402
from repro_torch.optim.compression import (ErrorFeedback,  # noqa: E402
                                           compress_decompress, int8_psum,
                                           wire_bytes_fp32, wire_bytes_int8)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per test worker (results do not depend on
    it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t_(a):
    return torch.from_numpy(np.array(a))


def one_device_map(fn, n_in):
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("data",))
    return shard_map(fn, mesh=mesh, in_specs=(P(),) * n_in, out_specs=P(),
                     check_vma=False)


def test_compress_decompress_matches_reference_bitwise():
    for i, scale in enumerate((0.1, 1.0, 1e3, 0.0)):
        x = np.asarray(jax.random.normal(jax.random.PRNGKey(i), (257,))) \
            * scale
        x[::7] = 0.5 * (np.abs(x).max() / 127.0)     # ties land on .5
        assert torch.equal(compress_decompress(t_(x)),
                           t_(jcomp.compress_decompress(jnp.asarray(x))))


def test_error_feedback_preserves_signal():
    """EF accumulates what compression drops: the sum of applied updates
    over 50 steps is the sum of raw gradients up to one step's error —
    and every step equals the reference's, bit for bit."""
    g_total = torch.zeros(64)
    applied = torch.zeros(64)
    ef = {"g": torch.zeros(64)}
    jef = {"g": jnp.zeros((64,))}
    for t in range(50):
        g = np.asarray(jax.random.normal(jax.random.PRNGKey(t), (64,))) * 0.1
        out, ef = ErrorFeedback.apply({"g": t_(g)}, ef)
        jout, jef = jcomp.ErrorFeedback.apply({"g": jnp.asarray(g)}, jef)
        assert torch.equal(out["g"], t_(jout["g"]))
        assert torch.equal(ef["g"], t_(jef["g"]))
        g_total += t_(g)
        applied += out["g"]
    assert float((g_total - applied).abs().max()) < 0.05


def test_axis_forms_at_one_shard_match_reference_bitwise():
    """With an axis of one shard ``int8_psum`` and ``ErrorFeedback.apply``
    are the reference's under its ``shard_map`` on one device, bit for
    bit, and the collectives drop out."""
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (4, 128)))
    want = one_device_map(lambda a: jcomp.int8_psum(a, "data"), 1)(x)
    (got,) = int8_psum([t_(x)], "data")
    assert torch.equal(got, t_(want))
    g = {"a": np.asarray(jax.random.normal(jax.random.PRNGKey(1), (8, 4))),
         "b": np.asarray(jax.random.normal(jax.random.PRNGKey(2), (5,)))}
    e = {k: 0.01 * v for k, v in g.items()}
    jout, jef = one_device_map(
        lambda gg, ee: jcomp.ErrorFeedback.apply(gg, ee, axis_name="data"),
        2)(g, e)
    (out,), (ef,) = ErrorFeedback.apply(
        [{k: t_(v) for k, v in g.items()}],
        [{k: t_(v) for k, v in e.items()}], axis_name="data")
    for k in g:
        assert torch.equal(out[k], t_(jout[k]))
        assert torch.equal(ef[k], t_(jef[k]))


def test_int8_psum_wire_accuracy():
    """Four shards: the int8 all-reduce is its definition bit for bit and
    within 5% of the exact sum's max (the reference test's bar)."""
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (4, 128)))
    got = int8_psum([t_(x[i:i + 1]) for i in range(4)], "data")
    assert isinstance(got, PerShard) and len(got) == 4
    scale = np.maximum(np.float32(np.abs(x).max()) / np.float32(127.0),
                       np.float32(1e-12))
    q = np.clip(np.round(x / scale), -127, 127).astype(np.int32)
    want = q.sum(0, keepdims=True).astype(np.float32) * scale
    exact = x.sum(0, keepdims=True)
    for g in got:
        np.testing.assert_array_equal(g.numpy(), want)
    rel = float(np.abs(want - exact).max() / np.abs(exact).max())
    print("rel err", rel)
    assert rel < 0.05


def test_error_feedback_four_shards_pmeans_a_common_scale():
    rng = np.random.default_rng(0)
    gs = [{"w": torch.from_numpy(rng.normal(size=(6, 3)).astype(np.float32))}
          for _ in range(4)]
    es = [ef_init(g) for g in gs]
    out, ef = ErrorFeedback.apply(gs, es, axis_name="data")
    ys = [g["w"] for g in gs]
    scale = max(float(y.abs().max()) for y in ys) / 127.0
    payload = [torch.clamp(torch.round(y / torch.tensor(scale)), -127, 127)
               * torch.tensor(scale) for y in ys]
    mean = (((payload[0] + payload[1]) + payload[2]) + payload[3]) / 4
    for o, e, y, p in zip(out, ef, ys, payload):
        torch.testing.assert_close(o["w"], mean, rtol=0, atol=1e-6)
        torch.testing.assert_close(e["w"], y - p, rtol=0, atol=1e-6)


def _quadratic():
    w_true = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (8, 4)))
    X = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (64, 8)))
    return t_(X), t_(X @ w_true)


def loss_fn(params, batch):
    r = batch["x"] @ params["w"] - batch["y"]
    return (r * r).mean()


def test_compressed_dp_matches_uncompressed():
    """int8+EF data-parallel training reaches the exact psum's optimum on
    a quadratic (4-way DP over logical shards; the reference test's bars:
    exact below 1e-4, compressed below 1e-3)."""
    mesh = make_test_mesh((4,), ("data",), devices=["cpu"] * 4)
    X, Y = _quadratic()
    outs = {}
    for compress in (False, True):
        p = {"w": torch.zeros(8, 4)}
        st = sgd_init(p)
        ef = ef_init(p)
        step = make_compressed_dp_step(mesh, loss_fn, sgd_update,
                                       axis="data", lr=0.1,
                                       compress=compress)
        for _ in range(200):
            p, st, ef = step(p, st, ef, {"x": X, "y": Y})
        outs[compress] = float(loss_fn(p, {"x": X, "y": Y}))
        if compress:
            assert isinstance(ef, PerShard) and len(ef) == 4
    print("exact", outs[False], "compressed", outs[True])
    assert outs[False] < 1e-4
    assert outs[True] < 1e-3


def test_dp_step_one_shard_is_the_plain_step():
    """At one shard the uncompressed step is ``value_and_grad`` + SGD on
    the whole batch, bit for bit, and the gradient collectives drop
    out."""
    mesh = make_test_mesh((1,), ("data",), devices=["cpu"])
    X, Y = _quadratic()
    p = {"w": torch.full((8, 4), 0.1)}
    q = {"w": torch.full((8, 4), 0.1)}
    step = make_compressed_dp_step(mesh, loss_fn, sgd_update, axis="data",
                                   lr=0.1, compress=False)
    st_p, st_q = sgd_init(p), sgd_init(q)
    step(p, st_p, ef_init(p), {"x": X, "y": Y})
    w = q["w"].clone().requires_grad_()
    (g,) = torch.autograd.grad(loss_fn({"w": w}, {"x": X, "y": Y}), [w])
    sgd_update(q, {"w": g}, st_q, lr=0.1)
    assert torch.equal(p["w"], q["w"])
    grads = [{"w": torch.ones(2)}, {"w": torch.full((2,), 3.0)}]
    assert torch.equal(pmean_grads(grads)[1]["w"], torch.full((2,), 2.0))
    assert torch.equal(psum_grads(grads)[0]["w"], torch.full((2,), 4.0))


def test_wire_bytes_match_reference():
    tree = {"a": np.zeros((8, 4), np.float32), "b": np.zeros(5, np.float32)}
    port = {k: t_(v) for k, v in tree.items()}
    assert wire_bytes_fp32(port) == jcomp.wire_bytes_fp32(tree) == 148
    assert wire_bytes_int8(port) == jcomp.wire_bytes_int8(tree) == 45
