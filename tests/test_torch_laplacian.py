"""The port's temporal Laplacian term against the reference.

``laplacian_energy_ref`` (the plain version of the ``laplacian_energy``
CUDA kernel, which the wrapper runs on a CPU tensor) is held per row
against the reference's oracle ``ref.laplacian_energy_ref`` and its
batch sum against the Pallas ``laplacian_energy_pallas`` in interpret
mode (through ``repro.kernels.ops.laplacian_energy``), at rtol 1e-5 as
the reference holds its Pallas kernel: float32 sums in another order.
The edge counts are sums of 0/1 products and must be equal exactly.
``core/laplacian.py`` is held against ``repro.core.laplacian`` at 1e-5
and its dense numpy utilities exactly.
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
    laplacian_energy, laplacian_energy_ref)

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
