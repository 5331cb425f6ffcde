"""The port's temporal Laplacian term against the reference.

``laplacian_energy_ref`` (the plain version of the ``laplacian_energy``
CUDA kernel, which the wrapper runs on a CPU tensor) is held per row
against the reference's oracle ``ref.laplacian_energy_ref`` and its
batch sum against the Pallas ``laplacian_energy_pallas`` in interpret
mode (through ``repro.kernels.ops.laplacian_energy``), at rtol 1e-5 as
the reference holds its Pallas kernel: float32 sums in another order.
The edge counts are sums of 0/1 products and must be equal exactly.
``core/laplacian.py`` is held against ``repro.core.laplacian`` at 1e-5
and its dense numpy utilities exactly.  ``laplacian_energy_bwd_ref``, the
backward kernel's explicit formula, is held against autograd of the
plain forward and ``jax.grad`` of the oracle at 1e-5 of max |dz|.
"""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import laplacian as jlap  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.core import laplacian as lap  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.laplacian_energy import (  # noqa: E402
    laplacian_energy, laplacian_energy_bwd, laplacian_energy_diff,
    laplacian_energy_ref)

RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs files in parallel workers: one intra-op thread per
    worker keeps torch from oversubscribing the cores (results do not
    depend on it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(B, T, d, seed, *, masked_row=True):
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(B, T, d)).astype(np.float32)
    m = (rng.random((B, T)) > 0.3).astype(np.float32)
    if masked_row:
        m[-1] = 0.0                      # a row with no valid frame
    return z * m[..., None], m


@pytest.mark.parametrize("B,T,d,k", [(3, 16, 8, 5), (4, 50, 32, 3),
                                     (2, 10, 4, 12), (3, 7, 16, 6),
                                     (2, 1, 8, 5)])
def test_laplacian_energy_matches_oracle_and_pallas(B, T, d, k):
    z, m = _inputs(B, T, d, B * T + d + k)
    tot, cnt = laplacian_energy(torch.from_numpy(z), torch.from_numpy(m), k)
    assert tot.shape == cnt.shape == (B,) and tot.dtype == torch.float32
    oracle = jax.jit(jax.vmap(lambda a, b: jref.laplacian_energy_ref(a, b, k)))
    o_tot, o_cnt = map(np.asarray, oracle(z, m))
    np.testing.assert_allclose(tot.numpy(), o_tot, rtol=RTOL)
    np.testing.assert_array_equal(cnt.numpy(), o_cnt)
    assert tot[-1] == 0.0 and cnt[-1] == 0.0
    pallas = float(jops.laplacian_energy(z, m, k=k))
    np.testing.assert_allclose(float(tot.sum() / cnt.sum().clamp_min(1.0)),
                               pallas, rtol=RTOL)


def test_laplacian_energy_is_the_refine_term():
    """Per session, tot / max(cnt, 1) is ``laplacian_loss`` of that
    session, the reference refine round's Laplacian term."""
    z, m = _inputs(4, 20, 8, 3)
    tot, cnt = laplacian_energy_ref(torch.from_numpy(z), torch.from_numpy(m),
                                    5)
    want = jax.jit(jax.vmap(lambda a, b: jlap.laplacian_loss(a, k=5, mask=b)))
    np.testing.assert_allclose((tot / cnt.clamp_min(1.0)).numpy(),
                               np.asarray(want(z, m)), rtol=RTOL)


def test_dirichlet_energy_matches_reference():
    z, m = _inputs(3, 24, 6, 9, masked_row=False)
    w = np.linspace(1.0, 0.2, 4).astype(np.float32)
    tz, tm = torch.from_numpy(z), torch.from_numpy(m)
    ref = jax.jit(lambda z, m, w: (
        jlap.dirichlet_energy(z, k=4, mask=m, weights=w),
        jlap.dirichlet_energy(z[0], k=3, mask=m[0]),
        jlap.laplacian_loss(z, k=30)))
    cases = zip((lap.dirichlet_energy(tz, k=4, mask=tm, weights=w),
                 lap.dirichlet_energy(tz[0], k=3, mask=tm[0]),
                 lap.laplacian_loss(tz, k=30)), ref(z, m, w))
    for got, want in cases:
        np.testing.assert_allclose(float(got), float(want), rtol=RTOL)


def test_dense_utilities_match_reference():
    rng = np.random.default_rng(2)
    T, k = 12, 2
    mask = (rng.random(T) > 0.2).astype(np.float32)
    z = rng.normal(size=(T, 3))
    A, jA = lap.temporal_adjacency(T, k, mask), jlap.temporal_adjacency(
        T, k, mask)
    np.testing.assert_array_equal(A, jA)
    np.testing.assert_array_equal(lap.graph_laplacian(A),
                                  jlap.graph_laplacian(jA))
    assert lap.spectral_gap(A) == jlap.spectral_gap(jA)
    assert lap.dirichlet_energy_dense(z, A) == jlap.dirichlet_energy_dense(
        z, jA)
    np.testing.assert_array_equal(lap.neighbor_average(z, A, 5),
                                  jlap.neighbor_average(z, jA, 5))
    assert lap.interpolation_error_bound(z, A, 5) == \
        jlap.interpolation_error_bound(z, jA, 5)
    with pytest.warns(UserWarning, match="sparse-graph regime"):
        lap.interpolation_error_bound(z[:4], lap.temporal_adjacency(4, 3), 1)


def test_laplacian_wrapper_checks_and_counts():
    z, m = torch.ones(2, 6, 3), torch.ones(2, 6)
    before = laplacian_energy.launches
    for a, b in zip(laplacian_energy(z, m, 2), laplacian_energy_ref(z, m, 2)):
        assert torch.equal(a, b)
    assert laplacian_energy.launches == before
    assert ops.KERNELS["laplacian_energy"] is laplacian_energy
    with pytest.raises(TypeError):
        laplacian_energy(z, m.double(), 2)
    with pytest.raises(ValueError):
        laplacian_energy(z, torch.ones(2, 5), 2)
    with pytest.raises(ValueError):
        laplacian_energy(z.requires_grad_(), m, 2)
    with pytest.raises(ValueError):
        laplacian_energy(torch.ones(2, 6, 3, device="meta"), m, 2)


# --- the edge trainer's gradient of tot -----------------------------------

@pytest.mark.parametrize("B,T,d,k", [(1, 104, 32, 3), (3, 16, 8, 5),
                                     (2, 7, 16, 12), (2, 1, 8, 5)])
def test_laplacian_backward_formula_matches_autograd_and_jax_grad(B, T, d,
                                                                   k):
    """dz from the explicit formula against autograd of the plain
    forward's tot and ``jax.grad`` of the oracle's, for a cotangent g (B,),
    at 1e-5 relative to max |dz|; k >= T clamps, T = 1 and an all-masked
    row give zeros."""
    z, m = _inputs(B, T, d, 7 * B + T + k)
    g = np.random.default_rng(k).normal(size=B).astype(np.float32)
    tz, tm, tg = map(torch.from_numpy, (z, m, g))
    formula = laplacian_energy_bwd(tz, tm, tg, k).numpy()
    tzg = tz.clone().requires_grad_()
    with torch.enable_grad():
        tot = laplacian_energy_ref(tzg, tm, k)[0]
        # T = 1 has no edge: tot is a constant, its gradient zero
        auto, = torch.autograd.grad(tot, tzg, tg) if tot.requires_grad \
            else (torch.zeros_like(tz),)
    jg = jax.grad(lambda a: jax.numpy.sum(jax.vmap(
        lambda zb, mb: jref.laplacian_energy_ref(zb, mb, k)[0])(a, m) * g))(z)
    scale = max(np.abs(np.asarray(jg)).max(), 1e-30)
    np.testing.assert_allclose(formula, auto.numpy(), rtol=0,
                               atol=1e-5 * scale)
    np.testing.assert_allclose(formula, np.asarray(jg), rtol=0,
                               atol=1e-5 * scale)
    assert (formula[-1] == 0).all()             # the all-masked row
    if T == 1:
        assert (formula == 0).all()


def test_laplacian_diff_entry_on_cpu_and_checks():
    z, m = _inputs(2, 9, 4, 1, masked_row=False)
    tz, tm = torch.from_numpy(z), torch.from_numpy(m)
    before = laplacian_energy_bwd.launches
    for a, b in zip(laplacian_energy_diff(tz, tm, 3),
                    laplacian_energy_ref(tz, tm, 3)):
        assert torch.equal(a, b)
    laplacian_energy_bwd(tz, tm, torch.ones(2), 3)
    assert laplacian_energy_bwd.launches == before
    assert ops.KERNELS["laplacian_energy_bwd"] is laplacian_energy_bwd
    with pytest.raises(ValueError):
        laplacian_energy_diff(tz, tm.clone().requires_grad_(), 3)
    with pytest.raises(ValueError):
        laplacian_energy_bwd(tz, tm, torch.ones(3), 3)
    with pytest.raises(TypeError):
        laplacian_energy_bwd(tz, tm, torch.ones(2).double(), 3)
    with pytest.raises(ValueError):
        laplacian_energy_bwd(tz, tm, torch.ones(2), -1)
