"""The hybrid loss's two regularisers with one backward launch
(``kernels/hybrid_reg.py``, ``csrc/hybrid_reg_bwd.cu``) against the
reference.

``hybrid_reg_bwd_ref``, the plain version the wrapper runs on a CPU
tensor, must be bitwise the two plain backward formulas added (the
kernel joins its halves with one rounded add, so on the card it is
bitwise the two one-half launches added).  ``hybrid_regularisers``, the
autograd Function, applied to CPU tensors so that its wrappers run their
plain versions, is held against ``jax.grad`` of the reference's
``lam_sw * sliced_w2(z.reshape(-1, d), prior, dirs) + lam_lap *
dirichlet_energy(z, k=k, mask=mask)`` and of each term alone, with the
reference's own draws handed across, at 1e-5 of max |dz| (float32 sums in
another order): at the edge learner's (1, 104, 128), M 32, k 3, with a
masked frame and 96 identical rows (the tie order decides the SW
gradient), and at a small (2, 16, 64), M 8, k 5.  The kernel's grid is
emulated on the host: every element of dz written exactly once, every
direction added in order, at the paths' shapes and the tiling's edges,
with the tile constants read from the source.  On the card
``chip_smoke.py`` holds the kernel against the plain version and bitwise
against the composition.
"""
import re

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import laplacian as jlap  # noqa: E402
from repro.core import swd as jswd  # noqa: E402
from repro_torch.core import hybrid  # noqa: E402
from repro_torch.core.laplacian import laplacian_loss  # noqa: E402
from repro_torch.core.swd import swd_loss  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels import hybrid_reg as hr  # noqa: E402
from repro_torch.kernels.hybrid_reg import (  # noqa: E402
    hybrid_reg_bwd, hybrid_reg_bwd_ref, hybrid_regularisers)
from repro_torch.kernels.laplacian_energy import (  # noqa: E402
    laplacian_energy_bwd, laplacian_energy_bwd_ref)
from repro_torch.kernels.swd import (swd_rank_bwd,  # noqa: E402
                                     swd_rank_bwd_ref, swd_rank_fwd_ref)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs files in parallel workers: one intra-op thread per
    worker keeps torch from oversubscribing the cores (results do not
    depend on it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# (what, B, T, d, M, k, tied rows, masked frame): the edge learner's
# buffer (96 identical rows, one frame masked) and a small LM-like step
CASES = [("edge", 1, 104, 128, 32, 3, 96, 100),
         ("small", 2, 16, 64, 8, 5, 0, None)]


def _inputs(B, T, d, M, k, dup, masked, seed):
    """z (B, T, d) on the sphere, its first ``dup`` rows (of the W = B*T)
    one repeated row, the mask with frame ``masked`` of row 0 off, and the
    reference's SW draws (dirs (M, d), prior (W, d))."""
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(B * T, d)).astype(np.float32)
    z /= np.linalg.norm(z, axis=-1, keepdims=True)
    z[:dup] = z[0]
    mask = np.ones((B, T), np.float32)
    if masked is not None:
        mask[0, masked] = 0.0
    kd, kp = jax.random.split(jax.random.PRNGKey(seed))
    dirs = np.array(jswd.random_directions(kd, M, d))
    prior = np.array(jswd.sphere_prior_samples(kp, B * T, d))
    return z.reshape(B, T, d), mask, dirs, prior


def _torch(z, mask, dirs, prior):
    tdirs = torch.from_numpy(dirs)
    pq = torch.sort(torch.from_numpy(prior) @ tdirs.T, dim=0).values
    return torch.from_numpy(z), torch.from_numpy(mask), tdirs, \
        pq.contiguous()


def _bwd_args(what, B, T, d, M, k, dup, masked):
    """The backward's inputs from the plain forward: (z, mask, k, g_sw,
    proj, rank, prior_q, dirs, g_tot)."""
    z, mask, dirs, prior = _inputs(B, T, d, M, k, dup, masked, B + T + d)
    tz, tm, tdirs, pq = _torch(z, mask, dirs, prior)
    _, proj, rank = swd_rank_fwd_ref(tz.view(B * T, d), tdirs, pq)
    g_tot = torch.from_numpy(
        np.random.default_rng(k).normal(size=B).astype(np.float32))
    return tz, tm, k, torch.tensor(0.7), proj, rank, pq, tdirs, g_tot


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_plain_version_is_the_two_plain_backwards_added(case):
    """Bitwise: ``hybrid_reg_bwd_ref`` (and the wrapper on the CPU) is
    ``swd_rank_bwd_ref(...).view(B, T, d) + laplacian_energy_bwd_ref(...)``,
    and each half alone is that half's plain backward."""
    z, mask, k, g_sw, proj, rank, pq, dirs, g_tot = _bwd_args(*case)
    sw = swd_rank_bwd_ref(g_sw, proj, rank, pq, dirs).view(z.shape)
    lap = laplacian_energy_bwd_ref(z, mask, g_tot, k)
    args = (z, mask, k, g_sw, proj, rank, pq, dirs, g_tot)
    assert torch.equal(hybrid_reg_bwd_ref(*args), sw + lap)
    assert torch.equal(hybrid_reg_bwd(*args), sw + lap)
    assert torch.equal(hybrid_reg_bwd(*args[:-1], None), sw)
    assert torch.equal(hybrid_reg_bwd(*args[:3], None, *args[4:]), lap)
    assert torch.equal(
        swd_rank_bwd(g_sw, proj, rank, pq, dirs).view(z.shape), sw)
    assert torch.equal(laplacian_energy_bwd(z, mask, g_tot, k), lap)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
@pytest.mark.parametrize("terms", ["both", "sw", "lap"])
def test_function_gradient_matches_jax_grad(case, terms):
    """The Function's gradient of lam_sw * sw + lam_lap * Σtot / max(Σcnt,
    1) (the edge learner's weights), and of each term alone, against
    ``jax.grad`` of the reference's ``sliced_w2`` and ``dirichlet_energy``
    at 1e-5 of max |dz|."""
    what, B, T, d, M, k, dup, masked = case
    z, mask, dirs, prior = _inputs(B, T, d, M, k, dup, masked, 3 * T + M)
    lam_sw = {"both": 2.0, "sw": 1.0, "lap": 0.0}[terms]
    lam_lap = {"both": 0.01, "sw": 0.0, "lap": 1.0}[terms]
    tz, tm, tdirs, pq = _torch(z, mask, dirs, prior)
    zl = tz.clone().requires_grad_()
    with torch.enable_grad():
        sw, tot, cnt = hybrid_regularisers(zl, tm, k, tdirs, pq)
        loss = 0.0
        if lam_sw:
            loss = loss + lam_sw * sw
        if lam_lap:
            loss = loss + lam_lap * tot.sum() / cnt.sum().clamp_min(1.0)
        got, = torch.autograd.grad(loss, zl)

    def ref(a):
        return lam_sw * jswd.sliced_w2(a.reshape(-1, d), prior, dirs) \
            + lam_lap * jlap.dirichlet_energy(a, k=k, mask=mask)
    want = np.asarray(jax.grad(ref)(z))
    scale = np.abs(want).max()
    assert scale > 0
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * scale)


def test_expanded_g_tot_is_read_through_its_stride(monkeypatch):
    """A stride-0 g_tot (the cotangent of ``tot.sum()``) gives the bits of
    the same values laid out; the Function hands the expanded cotangent
    to the wrapper as it arrives."""
    z, mask, k, g_sw, proj, rank, pq, dirs, _ = _bwd_args(*CASES[1])
    B = z.shape[0]
    flat = hybrid_reg_bwd(z, mask, k, g_sw, proj, rank, pq, dirs,
                          torch.full((B,), 0.3))
    expanded = torch.tensor(0.3).expand(B)
    assert expanded.stride() == (0,)
    assert torch.equal(hybrid_reg_bwd(z, mask, k, g_sw, proj, rank, pq, dirs,
                                      expanded), flat)
    assert torch.equal(laplacian_energy_bwd(z, mask, expanded, k),
                       laplacian_energy_bwd(z, mask, torch.full((B,), 0.3),
                                            k))
    seen = []

    def spy(*args):
        seen.append(args[-1])
        return hybrid_reg_bwd(*args)
    monkeypatch.setattr(hr, "hybrid_reg_bwd", spy)
    zl = z.clone().requires_grad_()
    with torch.enable_grad():
        _, tot, _ = hybrid_regularisers(zl, mask, k, dirs, pq)
        got, = torch.autograd.grad(0.3 * tot.sum(), zl)
    assert len(seen) == 1 and seen[0].stride() == (0,)
    assert torch.equal(got, laplacian_energy_bwd_ref(z, mask,
                                                     torch.full((B,), 0.3),
                                                     k))


def test_wrapper_checks_and_counts():
    z, mask, k, g_sw, proj, rank, pq, dirs, g_tot = _bwd_args(*CASES[1])
    before = (hybrid_reg_bwd.launches, swd_rank_bwd.launches,
              laplacian_energy_bwd.launches)
    args = [z, mask, k, g_sw, proj, rank, pq, dirs, g_tot]
    hybrid_reg_bwd(*args)
    zl = z.clone().requires_grad_()
    with torch.enable_grad():
        sw, tot, _ = hybrid_regularisers(zl, mask, k, dirs, pq)
        torch.autograd.grad(sw + tot.sum(), zl)
    assert (hybrid_reg_bwd.launches, swd_rank_bwd.launches,
            laplacian_energy_bwd.launches) == before
    assert ops.KERNELS["hybrid_reg_bwd"] is hybrid_reg_bwd

    def bad(i, value, exc):
        a = list(args)
        a[i] = value
        with pytest.raises(exc):
            hybrid_reg_bwd(*a)
    with pytest.raises(ValueError):
        hybrid_reg_bwd(*args[:3], None, *args[4:-1], None)
    bad(5, rank.long(), TypeError)
    bad(4, proj[:-1].contiguous(), ValueError)
    bad(8, g_tot.double(), TypeError)
    bad(8, torch.ones(3), ValueError)
    bad(2, -1, ValueError)
    bad(0, z.clone().requires_grad_(), ValueError)
    bad(7, dirs[:, :-1].contiguous(), ValueError)
    bad(3, torch.ones(2), ValueError)
    bad(0, torch.zeros(z.shape, device="meta"), ValueError)
    bad(1, mask[:, :-1].contiguous(), ValueError)
    with pytest.raises(ValueError):
        hybrid_regularisers(z, mask, k, dirs.clone().requires_grad_(), pq)
    with pytest.raises(ValueError):
        hybrid_regularisers(z[0], mask[0], k, dirs, pq)


def test_regularisers_on_the_cpu_are_swd_loss_and_laplacian_loss():
    """On a CPU tensor the helper is today's two terms under ordinary
    autograd: the same values and gradients, bitwise; so is the hybrid
    variant of ``hybrid_loss`` (2-D z and mask too)."""
    z, mask, dirs, prior = _inputs(2, 16, 64, 8, 5, 4, 3, 11)
    tz, tm = torch.from_numpy(z), torch.from_numpy(mask)
    key = (torch.from_numpy(dirs), torch.from_numpy(prior))
    for zz, mm in ((tz, tm), (tz[0], tm[0])):
        n = zz.reshape(-1, 64).shape[0]
        kk = (key[0], key[1][:n])
        a = zz.clone().requires_grad_()
        b = zz.clone().requires_grad_()
        with torch.enable_grad():
            sw, lap = hybrid.regularisers(kk, a, n_dirs=8, k=5, mask=mm)
            sw_b = swd_loss(kk, b.reshape(-1, 64), n_dirs=8)
            lap_b = laplacian_loss(b, k=5, mask=mm)
            ga, = torch.autograd.grad(sw + lap, a)
            gb, = torch.autograd.grad(sw_b + lap_b, b)
            loss, parts = hybrid.hybrid_loss(
                kk, zz, hybrid.HybridCfg(n_dirs=8), mask=mm)
        assert torch.equal(sw, sw_b) and torch.equal(lap, lap_b)
        assert torch.equal(ga, gb)
        assert torch.equal(parts["sw"], sw) and torch.equal(parts["lap"], lap)


# --- the kernel's grid, emulated -------------------------------------------

_SRC = (build.CSRC / "hybrid_reg_bwd.cu").read_text()


def _const(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", _SRC).group(1))


THREADS, COLS = _const("kThreads"), _const("kCols")
DIR_CHUNK = _const("kDirChunk")
ROWS = THREADS // 32


def _emulate_grid(B, T, d, M, k):
    """The launcher's grid and each thread's work, on the host -> (writes
    (W, d): how often each element of dz is written, the order in which
    each element's sum visits the directions (one list, every element
    alike), {row: its Laplacian neighbours' frames})."""
    W, K = B * T, min(k, T - 1)
    writes = np.zeros((W, d), np.int64)
    grid = (-(-W // ROWS), -(-d // COLS))
    assert grid[1] <= 65535 and W < 2 ** 31
    tid = np.arange(THREADS)
    lane, warp = tid % 32, tid // 32
    gp_loads = ROWS * DIR_CHUNK // THREADS
    slab_loads = DIR_CHUNK * COLS // THREADS
    visited = []
    for m0 in range(0, M, DIR_CHUNK):
        mc = min(DIR_CHUNK, M - m0)
        # the block's staging loops: each (row, direction) of gp and each
        # (column, direction) of the slab by exactly one thread's load
        e = (tid[:, None] + THREADS * np.arange(gp_loads)).ravel()
        staged = np.bincount(e[e < ROWS * mc], minlength=ROWS * mc)
        e = (tid[:, None] + THREADS * np.arange(slab_loads)).ravel()
        slab = np.bincount((e % COLS) * DIR_CHUNK + e // COLS)
        assert (staged == 1).all() and (slab == 1).all()
        assert len(slab) == COLS * DIR_CHUNK
        # each thread's sum: four directions at a time, then the rest
        m4 = mc & ~3
        order = [m for q in range(0, m4, 4) for m in range(q, q + 4)]
        visited += [m0 + m for m in order + list(range(m4, mc))]
    for bx in range(grid[0]):
        for by in range(grid[1]):
            j = by * COLS + lane
            i = bx * ROWS + warp
            ok = (i < W) & (j < d)
            np.add.at(writes, (i[ok], j[ok]), 1)
    neighbours = {}
    for i in range(W):
        t = i % T
        neighbours[i] = [t - delta for delta in range(1, K + 1)
                         if t >= delta] + \
            [t + delta for delta in range(1, K + 1) if t + delta < T]
    return writes, visited, neighbours


# (what, B, T, d, M, k): the edge learner's and the LM step's shapes, W and
# d that are not multiples of the tile, d = 127, T = 1, k >= T, more
# directions than one staged chunk
GRIDS = [("edge", 1, 104, 128, 32, 3), ("lm", 8, 16, 1024, 50, 5),
         ("ragged", 3, 7, 45, 3, 2), ("d = 127", 2, 9, 127, 8, 3),
         ("T = 1", 5, 1, 64, 4, 5), ("k >= T", 2, 6, 40, 5, 9),
         ("M past a chunk", 1, 20, 33, 2 * DIR_CHUNK + 3, 3)]


@pytest.mark.parametrize("what,B,T,d,M,k", GRIDS, ids=[g[0] for g in GRIDS])
def test_grid_writes_every_element_once(what, B, T, d, M, k):
    assert (THREADS, ROWS, COLS, DIR_CHUNK) == (256, 8, 32, 64)
    writes, visited, neighbours = _emulate_grid(B, T, d, M, k)
    assert (writes == 1).all()
    assert visited == list(range(M))
    for i, ts in neighbours.items():
        assert all(0 <= t < T for t in ts)
        assert len(ts) == sum(1 for t in range(T) if 0 < abs(t - i % T)
                              <= min(k, T - 1))
