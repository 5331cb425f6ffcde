"""The port's SW term against the reference.

``swd_sessions_ref`` (the plain version of the ``swd_sessions`` CUDA
kernel, which the wrapper runs on a CPU tensor) is held per session
against the reference's oracle ``ref.swd_ref`` and against the Pallas
``swd_pallas`` in interpret mode (through ``repro.kernels.ops.swd``,
N <= 64 so interpret mode stays fast), with the reference's own random
draws handed across.  Tolerance rtol 1e-4, as the reference holds its
Pallas kernel (``tests/test_kernels.py``): float32 sums in another order.
``core/swd.py`` is held against ``repro.core.swd`` at 1e-5 (same sums,
short) and its gradients through the sort at 1e-5.  On the card
``chip_smoke.py`` holds the kernel against the plain version.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import swd as jswd  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.core import swd  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.swd import swd_sessions, swd_sessions_ref  # noqa: E402

RTOL = 1e-4


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


def _draws(seed, M, N, d):
    kd, kp = jax.random.split(jax.random.PRNGKey(seed))
    return (np.array(jswd.random_directions(kd, M, d)),
            np.array(jswd.sphere_prior_samples(kp, N, d)))


def _prior_q(prior, dirs):
    return torch.sort(torch.from_numpy(prior) @ torch.from_numpy(dirs).T,
                      dim=0).values.contiguous()


@pytest.mark.parametrize("S,W,d,M", [(3, 16, 8, 4), (2, 64, 16, 50),
                                     (4, 33, 12, 9)])
def test_swd_sessions_matches_oracle_and_pallas(S, W, d, M):
    rng = np.random.default_rng(S * W + d + M)
    z = _sphere(rng, (S, W, d))
    z[0, ::5] = 0.0                    # gap frames stay in the SW term
    dirs, prior = _draws(M + W, M, W, d)
    port = swd_sessions(torch.from_numpy(z), torch.from_numpy(dirs),
                        _prior_q(prior, dirs)).numpy()
    assert port.shape == (S,) and port.dtype == np.float32
    for s in range(S):
        oracle = float(jref.swd_ref(z[s], prior, dirs))
        pallas = float(jops.swd(jax.random.PRNGKey(M + W), z[s], n_dirs=M))
        np.testing.assert_allclose(port[s], oracle, rtol=RTOL)
        np.testing.assert_allclose(port[s], pallas, rtol=RTOL)


def test_swd_sessions_zero_session_and_refine_term():
    """An inactive (all-zero) session, and the refine round's own SW term:
    mean((bitonic_diff_sort(z @ dirs.T) - prior_q)**2)."""
    rng = np.random.default_rng(4)
    W, d, M = 20, 16, 10
    z = _sphere(rng, (3, W, d))
    z[1] = 0.0
    dirs, prior = _draws(3, M, W, d)
    port = swd_sessions_ref(torch.from_numpy(z), torch.from_numpy(dirs),
                            _prior_q(prior, dirs)).numpy()
    pq = jswd.diff_sort(prior @ dirs.T, axis=0)
    want = jax.jit(jax.vmap(lambda zs: jnp.mean(jnp.square(
        jswd.bitonic_diff_sort(zs @ dirs.T) - pq))))(z)
    np.testing.assert_allclose(port, np.asarray(want), rtol=RTOL)
    np.testing.assert_allclose(port[1], float(jnp.mean(jnp.square(pq))),
                               rtol=RTOL)


def test_core_swd_matches_reference():
    rng = np.random.default_rng(5)
    N, d, M = 24, 12, 7
    x, y = _sphere(rng, (N, d)), _sphere(rng, (N, d))
    dirs, prior = _draws(7, M, N, d)
    tx, ty, td = map(torch.from_numpy, (x, y, dirs))
    np.testing.assert_allclose(float(swd.sliced_w2(tx, ty, td)),
                               float(jswd.sliced_w2(x, y, dirs)), rtol=1e-5)
    key = (torch.from_numpy(dirs), torch.from_numpy(prior))
    want = float(jswd.swd_loss(jax.random.PRNGKey(7), x, n_dirs=M))
    for fn in (swd.swd_to_uniform, swd.swd_loss):
        np.testing.assert_allclose(float(fn(key, tx, n_dirs=M)), want,
                                   rtol=1e-5)
    np.testing.assert_allclose(float(swd.wasserstein1_1d(tx[:, 0], ty[:, 0])),
                               float(jswd.wasserstein1_1d(x[:, 0], y[:, 0])),
                               rtol=1e-6)
    np.testing.assert_allclose(float(swd.mmd_rbf(tx, ty, sigma=0.7)),
                               float(jswd.mmd_rbf(x, y, sigma=0.7)),
                               rtol=1e-5, atol=1e-7)


def test_sort_values_and_gradient_match_bitonic_vjp():
    """``bitonic_diff_sort``'s custom VJP scatters the cotangent back
    through the permutation; torch.sort's autograd does the same."""
    rng = np.random.default_rng(6)
    x = rng.normal(size=(13, 5)).astype(np.float32)
    x[3, 1] = x[7, 1]                                  # a tie
    g = rng.normal(size=(13, 5)).astype(np.float32)
    val, grad = jax.jit(lambda a, ct: (lambda v, f: (v, f(ct)[0]))(
        *jax.vjp(jswd.bitonic_diff_sort, a)))(x, g)
    tx = torch.from_numpy(x).requires_grad_()
    out = swd.bitonic_diff_sort(tx)
    out.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(val))
    np.testing.assert_array_equal(swd.diff_sort(tx.detach(), axis=1).numpy(),
                                  np.asarray(jswd.diff_sort(x, axis=1)))
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(grad),
                               rtol=1e-5)


def test_draws_are_unit_norm_seeded_and_injectable():
    g = torch.Generator().manual_seed(0)
    dirs = swd.random_directions(g, 6, 9)
    prior = swd.sphere_prior_samples(g, 11, 9)
    for a in (dirs, prior):
        np.testing.assert_allclose(torch.linalg.vector_norm(a, dim=-1),
                                   1.0, rtol=1e-6)
    a, b = swd.seeded_draws(3, 2, 6, 11, 9), swd.seeded_draws(3, 2, 6, 11, 9)
    c = swd.seeded_draws(3, 5, 6, 11, 9)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])
    assert all(x is y for x, y in zip(swd.draw(a, 6, 11, 9), a))
    with pytest.raises(ValueError):
        swd.draw(a, 7, 11, 9)
    # a generator key draws the directions, then the prior
    z = torch.from_numpy(_sphere(np.random.default_rng(0), (11, 9)))
    drawn = swd.draw(torch.Generator().manual_seed(8), 6, 11, 9)
    assert float(swd.swd_loss(torch.Generator().manual_seed(8), z,
                              n_dirs=6)) == float(swd.swd_loss(drawn, z,
                                                               n_dirs=6))


def test_swd_wrapper_checks_and_counts():
    z, dirs = torch.zeros(2, 8, 4), torch.ones(3, 4)
    pq = torch.zeros(8, 3)
    before = swd_sessions.launches
    np.testing.assert_array_equal(swd_sessions(z, dirs, pq).numpy(),
                                  swd_sessions_ref(z, dirs, pq).numpy())
    assert swd_sessions.launches == before
    assert ops.KERNELS["swd_sessions"] is swd_sessions
    with pytest.raises(TypeError):
        swd_sessions(z.double(), dirs, pq)
    with pytest.raises(ValueError):
        swd_sessions(z.transpose(1, 2).contiguous().transpose(1, 2), dirs, pq)
    with pytest.raises(ValueError):
        swd_sessions(z.requires_grad_(), dirs, pq)
    with pytest.raises(ValueError):
        swd_sessions(torch.zeros(2, 8, 4, device="meta"), dirs, pq)
    with pytest.raises(ValueError):
        swd_sessions(torch.zeros(2, 8, 4), dirs, torch.zeros(7, 3))
