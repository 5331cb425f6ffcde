"""The port's SW term against the reference.

``swd_sessions_ref`` (the plain version of the ``swd_sessions`` CUDA
kernel, which the wrapper runs on a CPU tensor) is held per session
against the reference's oracle ``ref.swd_ref`` and against the Pallas
``swd_pallas`` in interpret mode (through ``repro.kernels.ops.swd``,
N <= 64 so interpret mode stays fast), with the reference's own random
draws handed across.  Tolerance rtol 1e-4, as the reference holds its
Pallas kernel (``tests/test_kernels.py``): float32 sums in another order.
``core/swd.py`` is held against ``repro.core.swd`` at 1e-5 (same sums,
short) and its gradients through the sort at 1e-5.  The edge trainer's
single-set entry: ``swd_rank_fwd_ref`` (the forward kernel's plain
version) against ``sliced_w2`` at rtol 1e-5 and its ranks exactly against
the reference's stable argsort, and ``swd_rank_bwd_ref`` (the backward
kernel's explicit formula) against autograd and ``jax.grad`` at 1e-5 of
max |dx|, with 96 tied rows as the edge trainer's cold buffer has them.
On the card ``chip_smoke.py`` holds the kernels against the plain
versions.
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
from repro_torch.kernels.swd import (swd_rank_bwd, swd_rank_fwd,  # noqa: E402
                                     swd_rank_fwd_ref, swd_sessions,
                                     swd_sessions_ref, swd_single)

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


# --- the edge trainer's differentiable SW term ----------------------------

def _single_inputs(seed, W, d, M, dup=0):
    """x (W, d) on the sphere whose first ``dup`` rows are one repeated
    row (the edge trainer's cold-start buffer), and the reference's
    draws."""
    rng = np.random.default_rng(seed)
    x = _sphere(rng, (W, d))
    if dup:
        x[:dup] = 0.0
        x[:dup, 0] = 1.0
    dirs, prior = _draws(seed, M, W, d)
    return x, dirs, prior


# the edge learner's buffer (104 rows, 96 tied), small and ragged sets,
# and the LM step's SW term: 128 pooled points at d_model 1,024, 50
# directions, with 96 tied rows
RANK_CASES = [(104, 32, 32, 96), (16, 8, 5, 0), (37, 12, 9, 10),
              (128, 1024, 50, 96)]


@pytest.mark.parametrize("W,d,M,dup", RANK_CASES)
def test_swd_rank_forward_matches_reference(W, d, M, dup):
    """The loss against ``sliced_w2`` and the ranks against the inverse of
    the reference's stable argsort, ties included (exactly)."""
    x, dirs, prior = _single_inputs(W + M, W, d, M, dup)
    loss, proj, rank = swd_rank_fwd(*map(torch.from_numpy, (x, dirs)),
                                    _prior_q(prior, dirs))
    np.testing.assert_allclose(float(loss),
                               float(jswd.sliced_w2(x, prior, dirs)),
                               rtol=1e-5)
    np.testing.assert_allclose(proj.numpy(), x @ dirs.T, rtol=1e-5,
                               atol=1e-6)
    perm = np.asarray(jnp.argsort(jnp.asarray(proj.numpy()), axis=0,
                                  stable=True))
    want = np.empty_like(perm)
    np.put_along_axis(want, perm, np.arange(W)[:, None], axis=0)
    assert rank.dtype == torch.int32
    np.testing.assert_array_equal(rank.numpy(), want)


@pytest.mark.parametrize("W,d,M,dup", RANK_CASES)
def test_swd_rank_backward_formula_matches_autograd_and_jax_grad(W, d, M,
                                                                 dup):
    """dx = Σ_m 2g(proj − prior_q[rank])/(W·M)·dirs_m against autograd
    through ``torch.sort`` and ``jax.grad`` of the reference's
    ``sliced_w2``, at 1e-5 relative to max |dx|; with 96 tied rows the
    tie order decides the gradient."""
    x, dirs, prior = _single_inputs(2 * W + M, W, d, M, dup)
    tdirs, pq = torch.from_numpy(dirs), _prior_q(prior, dirs)
    g = torch.tensor(1.7)
    _, proj, rank = swd_rank_fwd(torch.from_numpy(x), tdirs, pq)
    formula = swd_rank_bwd(g, proj, rank, pq, tdirs).numpy()
    tx = torch.from_numpy(x).requires_grad_()
    with torch.enable_grad():
        auto, = torch.autograd.grad(swd_rank_fwd_ref(tx, tdirs, pq)[0], tx,
                                    g)
    jg = jax.grad(lambda a: 1.7 * jswd.sliced_w2(a, prior, dirs))(x)
    scale = np.abs(np.asarray(jg)).max()
    assert scale > 0
    np.testing.assert_allclose(formula, auto.numpy(), rtol=0,
                               atol=1e-5 * scale)
    np.testing.assert_allclose(formula, np.asarray(jg), rtol=0,
                               atol=1e-5 * scale)


def test_swd_single_on_cpu_and_checks():
    x, dirs, prior = _single_inputs(1, 12, 6, 4, 3)
    tx, td, pq = torch.from_numpy(x), torch.from_numpy(dirs), \
        _prior_q(prior, dirs)
    before = (swd_rank_fwd.launches, swd_rank_bwd.launches)
    assert torch.equal(swd_single(tx, td, pq),
                       swd_rank_fwd_ref(tx, td, pq)[0])
    loss, proj, rank = swd_rank_fwd(tx, td, pq)
    swd_rank_bwd(torch.tensor(1.0), proj, rank, pq, td)
    assert (swd_rank_fwd.launches, swd_rank_bwd.launches) == before
    assert ops.KERNELS["swd_rank_fwd"] is swd_rank_fwd
    assert ops.KERNELS["swd_rank_bwd"] is swd_rank_bwd
    with pytest.raises(ValueError):
        swd_single(tx, td.clone().requires_grad_(), pq)
    with pytest.raises(ValueError):
        swd_rank_fwd(tx, td, pq[:-1].contiguous())
    with pytest.raises(TypeError):
        swd_rank_fwd(tx.double(), td, pq)
    with pytest.raises(TypeError):
        swd_rank_bwd(torch.tensor(1.0), proj, rank.long(), pq, td)
    with pytest.raises(ValueError):
        swd_rank_bwd(torch.ones(2), proj, rank, pq, td)


# --- the kernels' sort network, emulated ---------------------------------

def _after(a, ra, b, rb):
    return (a > b) | ((a == b) & (ra > rb))


def _warp_sort(v, r, V):
    """``csrc/swd.cu``'s ``warp_sort`` on one column of P = 32·V (value,
    row) pairs, lane l holding positions l·V .. l·V + V - 1 (v and r are
    (32, V)): the bitonic network in its ascending form, each merge of
    width k first pairing position p with p ^ (k - 1), then p with p ^ j
    for j = k/4 .. 1, the lower position keeping the smaller pair; pairs
    inside a lane compare two registers, pairs across lanes exchange
    register i (or V - 1 - i in a merge's first stage) with lane
    l ^ (stride / V)."""
    v, r = v.copy(), r.copy()
    lane = np.arange(32)[:, None]
    lv = V.bit_length() - 1

    def cas(i, p):
        a, ra, b, rb = v[:, i].copy(), r[:, i].copy(), v[:, p].copy(), \
            r[:, p].copy()
        swap = _after(a, ra, b, rb)
        v[:, i], v[:, p] = np.where(swap, b, a), np.where(swap, a, b)
        r[:, i], r[:, p] = np.where(swap, rb, ra), np.where(swap, ra, rb)

    def strides(top):
        for lj in range(top, -1, -1):
            for i in range(V):
                if not i & (1 << lj):
                    cas(i, i | (1 << lj))

    def lanes(mask, keep_min, flip):
        src = [V - 1 - i for i in range(V)] if flip else list(range(V))
        o, ro = v[lane[:, 0] ^ mask][:, src], r[lane[:, 0] ^ mask][:, src]
        take = np.where(keep_min, _after(v, r, o, ro), _after(o, ro, v, r))
        v[:], r[:] = np.where(take, o, v), np.where(take, ro, r)

    for lk in range(1, lv + 1):                     # widths k <= V
        k = 1 << lk
        for i in range(V):
            if not i & (k >> 1):
                cas(i, i ^ (k - 1))
        strides(lk - 2)
    k = 2 * V
    while k <= 32 * V:
        lanes(k // V - 1, (lane & (k // (2 * V))) == 0, True)
        j = k // 4
        while j >= V:
            lanes(j // V, (lane & (j // V)) == 0, False)
            j //= 2
        strides(lv - 1)
        k *= 2
    return v.reshape(-1), r.reshape(-1)


@pytest.mark.parametrize("V,W", [(1, 1), (1, 32), (2, 37), (4, 100),
                                 (4, 104), (16, 300), (32, 1000)])
def test_warp_sort_network_is_a_stable_sort(V, W):
    """The network, with the +3.0e38 sentinels past W, puts the W values in
    ascending order with ties broken by row: the order of
    ``torch.sort(stable=True)``, so the ranks the kernel writes are the
    plain version's.  Values drawn from 6 levels, so ties are everywhere."""
    rng = np.random.default_rng(V * 1000 + W)
    P = 32 * V
    vals = np.full(P, 3.0e38, np.float32)
    vals[:W] = rng.integers(0, 6, size=W).astype(np.float32) / 7
    v, r = _warp_sort(vals.reshape(32, V), np.arange(P).reshape(32, V), V)
    srt, perm = torch.sort(torch.from_numpy(vals[:W]), stable=True)
    np.testing.assert_array_equal(v[:W], srt.numpy())
    np.testing.assert_array_equal(r[:W], perm.numpy())
    assert (v[W:] == np.float32(3.0e38)).all()
