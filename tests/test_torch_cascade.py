"""The port's cascade server against the reference's.

Both servers run the demo's tiers (qwen1.5-0.5b and qwen3-1.7b at smoke
size, ``repro.launch.serve.demo``) with the reference's weights converted
by ``lm_from_jax`` and its GMM memory by ``gmm_from_jax``, over batches of
tokens from a numpy seed.  Per batch they must route the same requests
(the ``hard`` masks equal), give the same logits (rtol 1e-5, atol 1e-5:
float32 sums in another order) and, after the first batch, the same
calibrated threshold (rtol 1e-6); their ``CascadeStats`` counts must be
equal.  The GMM's plain entropy at the cascade's width (8 x 1,024, 64
components) is held against the reference at phase 3's atol 5e-4.
"""
import dataclasses
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import gmm as jgmm  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch.core import gmm  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention_fwd  # noqa
from repro_torch.kernels.gmm_posterior import gmm_posterior  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.weights import gmm_from_jax, lm_from_jax  # noqa: E402

LOGITS_RTOL = LOGITS_ATOL = 1e-5
THRESHOLD_RTOL = 1e-6
ENT_ATOL = 5e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per worker of the parallel suite."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _servers(**kw):
    """The reference's server on the demo's tiers and the port's on the
    CPU with the same weights and GMM memory."""
    small, large = serve.demo_configs()
    jsmall = jserve.smoke_config(jserve.get_config("qwen1.5-0.5b"))
    key = jax.random.PRNGKey(0)
    sp, _ = jlm.init_lm(jsmall, key)
    jlarge = replace(jserve.smoke_config(jserve.get_config("qwen3-1.7b")),
                     vocab=jsmall.vocab, d_model=jsmall.d_model, n_layers=4)
    lp, _ = jlm.init_lm(jlarge, key)
    ref = jserve.CascadeServer(jsmall, sp, jlarge, lp, **kw)
    port = serve.CascadeServer(
        small, lm_from_jax(jax.tree.map(np.asarray, sp)), large,
        lm_from_jax(jax.tree.map(np.asarray, lp)), device="cpu", **kw)
    port.gmm = gmm_from_jax(ref.gmm)
    return ref, port


def _counts(stats):
    return (stats.served_small, stats.served_large, stats.small_batches,
            stats.large_batches)


def test_demo_configs_are_the_reference_demos():
    small, large = serve.demo_configs()
    jsmall = jserve.smoke_config(jserve.get_config("qwen1.5-0.5b"))
    assert dataclasses.asdict(small) == dataclasses.asdict(jsmall)
    assert (large.name, large.vocab, large.d_model, large.n_layers,
            large.n_kv_heads, large.qk_norm) == (
        "qwen3-1.7b", jsmall.vocab, jsmall.d_model, 4, 4, True)


@pytest.mark.parametrize("threshold,update_gmm", [("auto", True),
                                                   (0.55, False)])
def test_cascade_matches_reference(threshold, update_gmm):
    """The demo's routing ("auto", EM on: the memory sharpens and later
    batches stay easy) and a fixed threshold on a fixed memory, which
    escalates 2-5 of 6 requests a batch (large sub-batches of 2, 4, 8)."""
    ref, port = _servers(threshold=threshold)
    rng = np.random.default_rng(0)
    n_hard = []
    for i in range(6):
        toks = rng.integers(0, 256, (6, 32)).astype(np.int32)
        want, want_hard = ref.handle(jnp.asarray(toks),
                                     update_gmm=update_gmm)
        got, hard = port.handle(toks, update_gmm=update_gmm)
        assert got.dtype == np.float32 and got.shape == (6, 256)
        assert hard.dtype == bool and hard.shape == (6,)
        np.testing.assert_array_equal(hard, want_hard, err_msg=f"batch {i}")
        np.testing.assert_allclose(got, want, rtol=LOGITS_RTOL,
                                   atol=LOGITS_ATOL, err_msg=f"batch {i}")
        np.testing.assert_allclose(port.threshold, ref.threshold,
                                   rtol=THRESHOLD_RTOL)
        assert _counts(port.stats) == _counts(ref.stats)
        n_hard.append(int(hard.sum()))
    assert port.stats.served_small + port.stats.served_large == 36
    assert sum(n_hard) == port.stats.served_large
    if threshold == "auto":
        assert n_hard[0] == 2      # the first batch's own 0.75 quantile
    else:
        assert min(n_hard) >= 2
    for a, b in zip(port.gmm, gmm_from_jax(ref.gmm)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-6)
    assert flash_attention_fwd.launches == 0 and gmm_posterior.launches == 0


def test_handle_takes_a_cpu_tensor():
    _, port = _servers()
    toks = np.random.default_rng(1).integers(0, 256, (4, 16))
    _, again = _servers()
    a, ha = port.handle(torch.from_numpy(toks))
    b, hb = again.handle(toks.astype(np.int32))
    np.testing.assert_array_equal(ha, hb)
    np.testing.assert_array_equal(a, b)


def test_port_demo_routes_both_tiers():
    """As ``tests/test_serve_hybrid.py`` asserts of the reference."""
    stats = serve.demo(n_batches=6, batch=6, seq=32, device="cpu")
    assert stats.served_small + stats.served_large == 36
    assert 0.0 < stats.escalation_rate < 1.0


def test_main_runs_the_demo_without_the_flag(monkeypatch):
    """As the reference's ``__main__``: the demo runs whatever ``--demo``
    says."""
    calls = []
    monkeypatch.setattr(serve, "demo", lambda **kw: calls.append(kw) or kw)
    serve.main(["--device", "cpu"])
    serve.main(["--demo", "--device", "cpu"])
    assert calls == [{"device": "cpu"}, {"device": "cpu"}]


def test_bucket():
    assert [serve._bucket(n) for n in (1, 2, 3, 5, 8, 9)] == [
        1, 2, 4, 8, 8, 16] == [jserve._bucket(n) for n in (1, 2, 3, 5, 8, 9)]


def test_tiers_must_share_a_vocab():
    small, large = serve.demo_configs()
    with pytest.raises(AssertionError, match="vocab"):
        serve.CascadeServer(small, {}, replace(large, vocab=100), {},
                            device="cpu")


def test_entropy_at_the_cascade_width():
    """``normalized_entropy`` on the CPU (the plain version of the GMM
    kernel) at (8, 64, 1,024) against the reference."""
    rng = np.random.default_rng(2)
    state = jgmm.init_gmm(jax.random.PRNGKey(3), 64, 1024)
    z = rng.normal(size=(8, 1024)).astype(np.float32)
    z /= np.linalg.norm(z, axis=-1, keepdims=True)
    want = np.asarray(jgmm.normalized_entropy(state, jnp.asarray(z)))
    got = gmm.normalized_entropy(gmm_from_jax(state), torch.from_numpy(z))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ENT_ATOL)
    # and once the memory has moved to these frames
    state2 = jgmm.em_update(state, jnp.asarray(z))
    got2 = gmm.normalized_entropy(
        gmm.em_update(gmm_from_jax(state), torch.from_numpy(z)),
        torch.from_numpy(z))
    np.testing.assert_allclose(
        got2.numpy(), np.asarray(jgmm.normalized_entropy(state2,
                                                         jnp.asarray(z))),
        rtol=0, atol=ENT_ATOL)
