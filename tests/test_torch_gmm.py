"""The port's GMM memory against the reference.

``gmm_posterior_ref`` (the plain version of the ``gmm_posterior`` CUDA
kernel, which the wrapper runs on a CPU tensor) is held against the
reference's oracle ``ref.gmm_posterior_ref`` and the Pallas
``gmm_posterior_pallas`` in interpret mode (through
``repro.kernels.ops.gmm_posterior``, B <= 64) at the reference's own
tolerances: resp atol 1e-4, entropy atol 5e-4.  ``core/gmm.py`` starts
from the reference's own state (``weights.gmm_from_jax``) and is held
against ``repro.core.gmm`` at rtol 1e-5 for one evaluation and rtol 1e-4
after three EM steps (float32 sums in another order, compounded).
"""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import gmm as jgmm  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.core import gmm  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.gmm_posterior import (gmm_posterior,  # noqa: E402
                                               gmm_posterior_ref)
from repro_torch.weights import gmm_from_jax, gmm_to_jax  # noqa: E402

RESP_ATOL, ENT_ATOL = 1e-4, 5e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs files in parallel workers: one intra-op thread per
    worker keeps torch from oversubscribing the cores (results do not
    depend on it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sphere(rng, shape):
    z = rng.normal(size=shape).astype(np.float32)
    return z / np.linalg.norm(z, axis=-1, keepdims=True)


def _mixture(B, C, d, seed, floor):
    rng = np.random.default_rng(seed)
    mu = (0.5 * rng.normal(size=(C, d))).astype(np.float32)
    var = rng.uniform(0.05, 0.5, (C, d)).astype(np.float32)
    logpi = rng.normal(size=C).astype(np.float32)
    logpi -= np.log(np.exp(logpi).sum())
    z = _sphere(rng, (B, d))
    if floor:
        # variances at the 1e-4 floor and frames right at those means,
        # where the Pallas kernel's expanded form cancels
        var[::2] = 1e-4
        z[::3] = mu[(np.arange(0, B, 3) * 2) % C] + 1e-3 * rng.normal(
            size=(len(z[::3]), d)).astype(np.float32)
    return z, mu, var, logpi


@pytest.mark.parametrize("B,C,d,floor", [(64, 8, 32, False),
                                         (33, 16, 64, False),
                                         (40, 64, 128, False),
                                         (48, 8, 16, True),
                                         # the kernel's tiling edges: one
                                         # row, d split in ragged chunks;
                                         # the cascade's shape at the floor
                                         (1, 10, 1000, False),
                                         (8, 64, 1024, True)])
def test_gmm_posterior_matches_oracle_and_pallas(B, C, d, floor):
    z, mu, var, logpi = _mixture(B, C, d, B + C + d, floor)
    resp, ent = gmm_posterior(*map(torch.from_numpy, (z, mu, var, logpi)))
    assert resp.shape == (B, C) and ent.shape == (B,)
    o_resp, o_ent = map(np.asarray, jref.gmm_posterior_ref(z, mu, var, logpi))
    np.testing.assert_allclose(resp.numpy(), o_resp, atol=RESP_ATOL)
    np.testing.assert_allclose(ent.numpy(), o_ent, atol=ENT_ATOL)
    np.testing.assert_allclose(resp.sum(-1).numpy(), 1.0, rtol=1e-5)
    if not floor:
        p_resp, p_ent = map(np.asarray, jops.gmm_posterior(
            z, mu, var, logpi, block_b=16))
        np.testing.assert_allclose(resp.numpy(), p_resp, atol=RESP_ATOL)
        np.testing.assert_allclose(ent.numpy(), p_ent, atol=ENT_ATOL)


def test_core_gmm_matches_reference():
    C, d = 12, 16
    jst = jgmm.init_gmm(jax.random.PRNGKey(3), C, d)
    st = gmm_from_jax(jst)
    z = _sphere(np.random.default_rng(1), (30, d))
    tz = torch.from_numpy(z)
    for got, want in zip(gmm.params_of(st), jgmm.params_of(jst)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    ref = jax.jit(lambda s, z: (
        jgmm.log_joint(s, z), jgmm.responsibilities(s, z),
        jgmm.entropy(s, z), jgmm.normalized_entropy(s, z),
        jgmm.assign(s, z)))
    lj, r, h, hn, a = map(np.asarray, ref(jst, z))
    np.testing.assert_allclose(gmm.log_joint(st, tz).numpy(), lj, rtol=1e-5)
    np.testing.assert_allclose(gmm.responsibilities(st, tz).numpy(), r,
                               atol=RESP_ATOL)
    np.testing.assert_allclose(gmm.entropy(st, tz).numpy(), h, atol=ENT_ATOL)
    np.testing.assert_allclose(gmm.normalized_entropy(st, tz).numpy(), hn,
                               atol=ENT_ATOL)
    np.testing.assert_array_equal(gmm.assign(st, tz).numpy(), a)
    assert gmm.size_bytes(st) == jgmm.size_bytes(jst)
    assert (st.n_components, st.dim) == (C, d)
    for x, y in zip(gmm_to_jax(st), jst):
        np.testing.assert_array_equal(x, np.asarray(y))


def test_init_gmm_draws_unit_means():
    st = gmm.init_gmm(torch.Generator().manual_seed(0), 5, 7, var0=0.1)
    np.testing.assert_allclose(torch.linalg.vector_norm(st.s1, dim=-1), 1.0,
                               rtol=1e-6)
    np.testing.assert_allclose(st.s2 - st.s1.square(), 0.1, rtol=1e-5)
    assert st.step.dtype == torch.int32 and int(st.step) == 0


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("reseed_frac", [0.0, 0.2])
def test_em_update_matches_reference(weighted, reseed_frac):
    C, d, B = 6, 8, 40
    rng = np.random.default_rng(int(weighted) + int(10 * reseed_frac))
    jst = jst_off = jgmm.init_gmm(jax.random.PRNGKey(1), C, d)
    st = gmm_from_jax(jst)
    # a fast decay on clustered data starves components, so reseeding runs
    decay = 0.5 if reseed_frac else 0.05
    centers = _sphere(rng, (2, d))
    em = jax.jit(lambda s, z, w, frac: jgmm.em_update(
        s, z, decay=decay, reseed_frac=frac, weights=w),
        static_argnums=3)
    for _ in range(3):
        z = (centers[rng.integers(0, 2, B)]
             + 0.05 * rng.normal(size=(B, d))).astype(np.float32)
        w = (rng.random(B) > 0.3).astype(np.float32) if weighted else None
        jst = em(jst, z, w, reseed_frac)
        jst_off = em(jst_off, z, w, 0.0)
        st = gmm.em_update(st, torch.from_numpy(z), decay=decay,
                           reseed_frac=reseed_frac,
                           weights=None if w is None else torch.from_numpy(w))
    for got, want in zip(st[:3], jst[:3]):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-6)
    assert int(st.step) == int(jst.step) == 3
    # with reseed_frac the reseeding really ran (and moved the state)
    assert bool(reseed_frac) == (not np.allclose(np.asarray(jst.s1),
                                                 np.asarray(jst_off.s1)))


def test_gmm_wrapper_checks_and_counts():
    z, mu = torch.zeros(4, 3), torch.zeros(2, 3)
    var, logpi = torch.ones(2, 3), torch.zeros(2)
    before = gmm_posterior.launches
    for a, b in zip(gmm_posterior(z, mu, var, logpi),
                    gmm_posterior_ref(z, mu, var, logpi)):
        assert torch.equal(a, b)
    assert gmm_posterior.launches == before
    assert ops.KERNELS["gmm_posterior"] is gmm_posterior
    with pytest.raises(TypeError):
        gmm_posterior(z, mu, var.double(), logpi)
    with pytest.raises(ValueError):
        gmm_posterior(z, mu, var, torch.zeros(3))
    with pytest.raises(ValueError):
        gmm_posterior(z, mu.requires_grad_(), var, logpi)
    with pytest.raises(ValueError):
        gmm_posterior(z.t().contiguous().t(), mu.detach(), var, logpi)
