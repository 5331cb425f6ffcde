"""The port's virtual-negative InfoNCE (kernel 7, forward and backward)
and the edge objective against the reference.

- ``infonce_vneg_fwd_ref`` (the plain version of the forward CUDA kernel,
  which the wrapper runs on a CPU tensor) per sample against the Pallas
  ``infonce_vneg_pallas`` in interpret mode (``repro.kernels.ops``) and
  its oracle ``ref.infonce_vneg_ref``, at ``tests/test_kernels.py``'s
  float32 shapes; rtol 1e-5 (float32 sums in another order; the reference
  holds its own Pallas kernel at atol 1e-4).
- ``infonce_vneg_bwd_ref``, the backward kernel's explicit formula,
  against ``torch.autograd.grad`` of the plain forward and ``jax.grad`` of
  the oracle, at 1e-5 relative to each gradient's max |g|.
- ``sample_virtual_negatives`` with the reference's Gumbel and Gaussian
  draws injected: the components bit for bit (after checking, in JAX,
  that the Gumbel argmax is what ``jax.random.categorical`` draws), the
  negatives at rtol 1e-6.
- ``streaming_infonce`` and ``infonce_with_virtual_negatives``: value and
  gradients against the reference at 1e-5.
On the card ``chip_smoke.py`` holds both kernels against the plain
versions.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import gmm as jgmm  # noqa: E402
from repro.core import infonce as jinfo  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.core import gmm, infonce  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.infonce_vneg import (  # noqa: E402
    infonce_vneg, infonce_vneg_bwd, infonce_vneg_bwd_ref, infonce_vneg_fwd,
    infonce_vneg_fwd_ref, infonce_vneg_ref, splits)
from repro_torch.weights import gmm_from_jax  # noqa: E402

RTOL = 1e-5
TAU = 0.1


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


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("B,N,d", [(32, 64, 32), (64, 256, 128),
                                   (16, 100, 64)])
def test_forward_matches_pallas_and_oracle(B, N, d):
    rng = np.random.default_rng(B * N + d)
    z, zp, zn = _sphere(rng, (B, d)), _sphere(rng, (B, d)), \
        _sphere(rng, (B, N, d))
    loss, lse = infonce_vneg_fwd(*map(torch.from_numpy, (z, zp, zn)), TAU)
    assert loss.shape == lse.shape == (B,) and loss.dtype == torch.float32
    oracle = np.asarray(jref.infonce_vneg_ref(z, zp, zn, TAU))
    pallas = np.asarray(jops.infonce_vneg(z, zp, zn, tau=TAU))
    np.testing.assert_allclose(loss.numpy(), oracle, rtol=RTOL)
    np.testing.assert_allclose(loss.numpy(), pallas, rtol=RTOL)
    # lse − loss is s⁺
    np.testing.assert_allclose((lse - loss).numpy(), (z * zp).sum(-1) / TAU,
                               rtol=RTOL, atol=1e-5)


@pytest.mark.parametrize("B,N,d", [(8, 264, 32), (1, 1, 16), (3, 37, 24)])
def test_backward_formula_matches_autograd_and_jax_grad(B, N, d):
    """Non-unit inputs, so the formula is checked as a function of its
    arguments, not only on the sphere."""
    rng = np.random.default_rng(B + N + d)
    z, zp = rng.normal(size=(2, B, d)).astype(np.float32)
    zn = rng.normal(size=(B, N, d)).astype(np.float32)
    g = rng.normal(size=B).astype(np.float32)
    tz, tzp, tzn = (torch.from_numpy(a).requires_grad_()
                    for a in (z, zp, zn))
    with torch.enable_grad():
        auto = torch.autograd.grad(infonce_vneg_ref(tz, tzp, tzn, TAU),
                                   (tz, tzp, tzn), torch.from_numpy(g))
    _, lse = infonce_vneg_fwd_ref(*map(torch.from_numpy, (z, zp, zn)), TAU)
    formula = infonce_vneg_bwd(*map(torch.from_numpy, (z, zp, zn)), lse,
                               torch.from_numpy(g), TAU)
    jgrad = jax.grad(lambda a, b, c: jnp.sum(
        jref.infonce_vneg_ref(a, b, c, TAU) * g), argnums=(0, 1, 2))(z, zp,
                                                                     zn)
    for f, a, j in zip(formula, auto, jgrad):
        assert f.shape == a.shape
        assert _rel(f.numpy(), a.numpy()) <= RTOL
        assert _rel(f.numpy(), np.asarray(j)) <= RTOL


def test_differentiable_entry_on_cpu_is_the_plain_version():
    rng = np.random.default_rng(0)
    z, zp = (torch.from_numpy(_sphere(rng, (4, 8))).requires_grad_()
             for _ in range(2))
    zn = torch.from_numpy(_sphere(rng, (4, 5, 8))).requires_grad_()
    with torch.enable_grad():
        a = infonce_vneg(z, zp, zn, TAU)
        ga = torch.autograd.grad(a.sum(), (z, zp, zn))
        b = infonce_vneg_ref(z, zp, zn, TAU)
        gb = torch.autograd.grad(b.sum(), (z, zp, zn))
    assert torch.equal(a, b)
    assert all(torch.equal(x, y) for x, y in zip(ga, gb))


def _gmm(seed, C, d):
    """A reference GMM a few EM steps from its init, as the port's state
    and the reference's."""
    state = jgmm.init_gmm(jax.random.PRNGKey(seed), C, d)
    rng = np.random.default_rng(seed)
    em = jax.jit(lambda s, z: jgmm.em_update(s, z, decay=0.1))
    for _ in range(3):
        state = em(state, _sphere(rng, (48, d)))
    state = jax.tree.map(np.asarray, state)
    return state, gmm_from_jax(state)


def test_sample_virtual_negatives_with_injected_draws():
    B, n_syn, C, d = 6, 40, 8, 16
    jstate, state = _gmm(2, C, d)
    z = _sphere(np.random.default_rng(3), (B, d))
    key = jax.random.PRNGKey(9)
    k1, k2 = jax.random.split(key)
    logits = jgmm.boundary_logits(jstate, jgmm.assign(jstate, z))
    gumbel = jax.random.gumbel(k1, (B, n_syn, C), jnp.float32)
    eps = jax.random.normal(k2, (B, n_syn, d), jnp.float32)
    # in JAX: the categorical draw is the Gumbel argmax of its noise
    comps = jax.random.categorical(k1, logits[:, None, :], axis=-1,
                                   shape=(B, n_syn))
    np.testing.assert_array_equal(
        np.asarray(comps), np.asarray(jnp.argmax(logits[:, None, :] + gumbel,
                                                 axis=-1)))
    draws = (torch.from_numpy(np.array(gumbel)),
             torch.from_numpy(np.array(eps)))
    tz = torch.from_numpy(z)
    np.testing.assert_array_equal(
        gmm.virtual_components(state, tz, draws[0]).numpy(),
        np.asarray(comps))
    got = gmm.sample_virtual_negatives(draws, state, tz, n_syn)
    want = jgmm.sample_virtual_negatives(key, jstate, z, n_syn)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)
    bl = gmm.boundary_logits(state, gmm.assign(state, tz)).numpy()
    np.testing.assert_array_equal(np.isinf(bl), np.isinf(np.asarray(logits)))
    fin = np.isfinite(bl)
    np.testing.assert_allclose(bl[fin], np.asarray(logits)[fin], rtol=1e-6)
    # a generator draws Gumbel noise and normals of the stated shapes
    gg, ge = gmm.draw_virtual(torch.Generator().manual_seed(0), B, n_syn,
                              C, d)
    assert tuple(gg.shape) == (B, n_syn, C) and tuple(ge.shape) == (
        B, n_syn, d) and torch.isfinite(gg).all()
    with pytest.raises(ValueError):
        gmm.draw_virtual((gg, ge), B, n_syn + 1, C, d)


def test_streaming_infonce_matches_reference():
    rng = np.random.default_rng(4)
    B, N, d = 5, 30, 12
    z, zp = rng.normal(size=(2, B, d)).astype(np.float32)
    zn = _sphere(rng, (B, N, d))
    tz, tzp = (torch.from_numpy(a).requires_grad_() for a in (z, zp))
    with torch.enable_grad():
        got = infonce.streaming_infonce(tz, tzp, torch.from_numpy(zn))
        g = torch.autograd.grad(got, (tz, tzp))
    want, jg = jax.value_and_grad(
        lambda a, b: jinfo.streaming_infonce(a, b, zn), argnums=(0, 1))(z, zp)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=RTOL)
    for a, b in zip(g, jg):
        assert _rel(a.numpy(), np.asarray(b)) <= RTOL


def test_infonce_with_virtual_negatives_matches_reference():
    B, n_syn, C, d = 8, 24, 8, 16
    jstate, state = _gmm(5, C, d)
    rng = np.random.default_rng(6)
    z, zp = rng.normal(size=(2, B, d)).astype(np.float32)
    key = jax.random.PRNGKey(11)
    k1, k2 = jax.random.split(key)
    draws = (torch.from_numpy(np.array(jax.random.gumbel(
        k1, (B, n_syn, C), jnp.float32))),
        torch.from_numpy(np.array(jax.random.normal(
            k2, (B, n_syn, d), jnp.float32))))
    want, jg = jax.value_and_grad(
        lambda a, b: jinfo.infonce_with_virtual_negatives(
            key, jstate, a, b, n_syn=n_syn), argnums=(0, 1))(z, zp)
    tz, tzp = (torch.from_numpy(a).requires_grad_() for a in (z, zp))
    with torch.enable_grad():
        got = infonce.infonce_with_virtual_negatives(draws, state, tz, tzp,
                                                     n_syn=n_syn)
        g = torch.autograd.grad(got, (tz, tzp))
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=RTOL)
    for a, b in zip(g, jg):
        assert _rel(a.numpy(), np.asarray(b)) <= RTOL
    # without the in-batch negatives only the virtual ones remain
    off = infonce.infonce_with_virtual_negatives(
        draws, state, tz.detach(), tzp.detach(), n_syn=n_syn,
        use_batch_negatives=False)
    jo = jinfo.infonce_with_virtual_negatives(key, jstate, z, zp,
                                              n_syn=n_syn,
                                              use_batch_negatives=False)
    np.testing.assert_allclose(float(off), float(jo), rtol=RTOL)


def test_infonce_wrappers_check_and_count():
    z, zn = torch.ones(2, 4), torch.ones(2, 3, 4)
    g = torch.ones(2)
    before = (infonce_vneg_fwd.launches, infonce_vneg_bwd.launches)
    loss, lse = infonce_vneg_fwd(z, z, zn, TAU)
    for a, b in zip((loss, lse), infonce_vneg_fwd_ref(z, z, zn, TAU)):
        assert torch.equal(a, b)
    for a, b in zip(infonce_vneg_bwd(z, z, zn, lse, g, TAU),
                    infonce_vneg_bwd_ref(z, z, zn, lse, g, TAU)):
        assert torch.equal(a, b)
    assert (infonce_vneg_fwd.launches, infonce_vneg_bwd.launches) == before
    assert ops.KERNELS["infonce_vneg_fwd"] is infonce_vneg_fwd
    assert ops.KERNELS["infonce_vneg_bwd"] is infonce_vneg_bwd
    with pytest.raises(TypeError):
        infonce_vneg_fwd(z.double(), z, zn, TAU)
    with pytest.raises(ValueError):
        infonce_vneg_fwd(z, z, torch.ones(2, 3, 5), TAU)
    with pytest.raises(ValueError):
        infonce_vneg_fwd(z, z, torch.ones(2, 0, 4), TAU)
    with pytest.raises(ValueError):
        infonce_vneg_fwd(z.clone().requires_grad_(), z, zn, TAU)
    with pytest.raises(ValueError):
        infonce_vneg_fwd(torch.ones(2, 4, device="meta"), z, zn, TAU)
    with pytest.raises(ValueError):
        infonce_vneg_bwd(z, z, zn, lse, torch.ones(3), TAU)
    with pytest.raises(ValueError):
        infonce_vneg_fwd(z.t().contiguous().t(), z, zn, TAU)


# --- the kernels' split-then-merge order, emulated -------------------------

# csrc/infonce_vneg.cu: warps of a split's block, negatives a warp has in
# flight
WARPS, ROWS = 8, 4


def _merge(m, l, wms, wls):
    """(m, l) with the pairs (wms[i], wls[i]) in order: the max first,
    then l * exp(m - max) plus each wl * exp(wm - max) in order."""
    m_new = m
    for wm in wms:
        m_new = torch.maximum(m_new, wm)
    l = l * torch.exp(m - m_new)
    for wm, wl in zip(wms, wls):
        l = l + wl * torch.exp(wm - m_new)
    return m_new, l


def _split_ranges(N, ns):
    per = -(-N // ns)
    return [(min(N, s * per), min(N, s * per + per)) for s in range(ns)]


def _emulated_forward(z, zp, zn, tau):
    """The forward kernels' order in float32 torch: warp w of each split
    folds its negatives n0 + w, n0 + w + 8, ... into a running (m, l), a
    batch of 4 at a time; the split merges its warps in order; the second
    pass merges the splits in split order into (s+, 1) -> (loss, lse)."""
    B, N, _ = zn.shape
    s = torch.einsum("bd,bnd->bn", z, zn) / tau
    pos = (z * zp).sum(-1) / tau
    parts = []
    for n0, n1 in _split_ranges(N, splits(B, N)):
        warps = []
        for w in range(WARPS):
            wm, wl = torch.full((B,), -1e30), torch.zeros(B)
            rows = list(range(n0 + w, n1, WARPS))
            for i in range(0, len(rows), ROWS):
                batch = [s[:, n] for n in rows[i:i + ROWS]]
                wm, wl = _merge(wm, wl, batch, [torch.ones(B)] * len(batch))
            warps.append((wm, wl))
        parts.append(_merge(*warps[0], *zip(*warps[1:])))
    m, l = _merge(pos, torch.ones(B), *zip(*parts))
    lse = m + torch.log(l)
    return lse - pos, lse


def _emulated_dz(z, zp, zn, lse, g, tau):
    """The backward's dz in the kernels' order: each warp sums p_n z_neg[n]
    over its negatives, each split its warps in order, the second pass the
    splits in split order."""
    B, N, d = zn.shape
    s = torch.einsum("bd,bnd->bn", z, zn) / tau
    p = torch.exp(s - lse[:, None])
    c = g / tau
    p0m1 = torch.exp((z * zp).sum(-1) / tau - lse) - 1.0
    total = None
    for n0, n1 in _split_ranges(N, splits(B, N)):
        part = None
        for w in range(WARPS):
            acc = torch.zeros(B, d)
            for n in range(n0 + w, n1, WARPS):
                acc = acc + p[:, n, None] * zn[:, n]
            part = acc if part is None else part + acc
        total = part if total is None else total + part
    return c[:, None] * (p0m1[:, None] * zp + total)


def test_split_plan():
    """About 128 blocks of at least 8 negatives: 16 splits of 17 at the
    edge learner's (8, 264); never more splits than negatives."""
    assert splits(8, 264) == 16 and -(-264 // 16) == 17
    for B, N in ((1, 1), (8, 1), (3, 100), (8, 263), (300, 50), (1, 5000)):
        ns = splits(B, N)
        assert 1 <= ns <= N
        assert all(n1 > n0 for n0, n1 in _split_ranges(N, ns))
        assert B * ns <= max(128, B)


@pytest.mark.parametrize("B,N,d", [(8, 264, 128), (4, 1, 32), (3, 263, 32),
                                   (8, 263, 64)])
def test_split_merge_order_matches_pallas_and_oracle(B, N, d):
    """The kernels' merge order is a valid logsumexp at rtol 1e-5: N = 264
    (the path's shape), N = 1, and N not a multiple of the split."""
    ns = splits(B, N)
    if N > 1:
        assert N % -(-N // ns) != 0 or (B, N) == (8, 264)
    rng = np.random.default_rng(B * N + d)
    z, zp, zn = _sphere(rng, (B, d)), _sphere(rng, (B, d)), \
        _sphere(rng, (B, N, d))
    loss, lse = _emulated_forward(*map(torch.from_numpy, (z, zp, zn)), TAU)
    oracle = np.asarray(jref.infonce_vneg_ref(z, zp, zn, TAU))
    pallas = np.asarray(jops.infonce_vneg(z, zp, zn, tau=TAU))
    np.testing.assert_allclose(loss.numpy(), oracle, rtol=RTOL)
    np.testing.assert_allclose(loss.numpy(), pallas, rtol=RTOL)
    want_loss, want_lse = infonce_vneg_fwd_ref(
        *map(torch.from_numpy, (z, zp, zn)), TAU)
    np.testing.assert_allclose(lse.numpy(), want_lse.numpy(), rtol=RTOL)
    # the backward's split sums against jax.grad of the oracle
    g = rng.normal(size=B).astype(np.float32)
    dz = _emulated_dz(*map(torch.from_numpy, (z, zp, zn)), lse,
                      torch.from_numpy(g), TAU)
    jdz = jax.grad(lambda a: jnp.sum(jref.infonce_vneg_ref(a, zp, zn, TAU)
                                     * g))(z)
    assert _rel(dz.numpy(), np.asarray(jdz)) <= RTOL
