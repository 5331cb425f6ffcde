"""The port's temporal Laplacian term against the reference.

``laplacian_energy_ref`` (the plain version of the ``laplacian_energy``
CUDA kernel, which the wrapper runs on a CPU tensor) is held per row
against the reference's oracle ``ref.laplacian_energy_ref`` and its
batch sum against the Pallas ``laplacian_energy_pallas`` in interpret
mode (through ``repro.kernels.ops.laplacian_energy``), at rtol 1e-5 as
the reference holds its Pallas kernel: float32 sums in another order.
The edge counts are sums of 0/1 products and must be equal exactly.
``core/laplacian.py`` is held against ``repro.core.laplacian`` at 1e-5
and its dense numpy utilities exactly.  The forward kernel's partition
(column lanes, chunks of frames with a halo, clusters of blocks) and its
fixed order of sums are emulated in float32 from the plan mirrored from
the source's constants, and held against the plain version (rtol 1e-5,
counts exact) and the Pallas kernel at the paths' plans and the plan's
edges.  ``laplacian_energy_bwd_ref``, the
backward kernel's explicit formula, is held against autograd of the
plain forward and ``jax.grad`` of the oracle at 1e-5 of max |dz|.
"""
import re

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import laplacian as jlap  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.core import laplacian as lap  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
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


# --- the forward kernel's partition and merge order, emulated -------------
#
# ``csrc/laplacian_energy.cu`` cuts each row into tasks (a column slice of
# 32 lanes x one chunk of frames, which owns the pairs whose later frame
# lies in it), deals them to a cluster of blocks, and sums in a fixed
# order: each lane's pairs in walk order (delta groups, later frames, then
# deltas), the lanes by an xor tree, the warps in order, the blocks in rank
# order; a warp's pair count task by task.  The emulation below repeats
# that partition and order in float32 torch, one rounded operation for each
# of the kernel's (which are all explicit _rn intrinsics, built without FMA
# contraction), with the plan mirrored from the source's constants, and is
# held against the plain version and the Pallas kernel at the paths' plans
# and the plan's edges.

_LAP_SRC = (build.CSRC / "laplacian_energy.cu").read_text()


def _const(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", _LAP_SRC)
               .group(1))


WARPS, RING = _const("kThreads") // 32, _const("kRing")
MIN_FRAMES, TARGET_WARPS = _const("kMinFrames"), _const("kTargetWarps")
MAX_CLUSTER = _const("kMaxCluster")


def _plan(B, T, d, vec=True):
    """``make_plan`` of the source -> (vec, slices, frames, chunks,
    cluster)."""
    v = 4 if vec else 1
    slices = -(-d // (32 * v))
    per_row = max(TARGET_WARPS // B, WARPS)
    chunks = max(-(-per_row // slices), 1)
    frames = max(-(-T // chunks), MIN_FRAMES)
    cap = MAX_CLUSTER * WARPS
    if slices * -(-T // frames) > cap:
        fit = max(cap // slices, 1)
        frames = max(frames, -(-T // fit))
    chunks = -(-T // frames)
    return v, slices, frames, chunks, min(-(-slices * chunks // WARPS),
                                          MAX_CLUSTER)


def _emulate(z, mask, k, plan):
    """The forward kernel's sums in its order, in float32 -> (tot, cnt)."""
    B, T, d = z.shape
    K = min(k, T - 1)
    v, slices, frames, chunks, cluster = plan
    lanes = torch.zeros(B, T, slices * 32 * v)
    lanes[..., :d] = z
    lanes = lanes.view(B, T, slices, 32, v)
    warps, tasks = cluster * WARPS, slices * chunks
    acc, pairs = torch.zeros(B, warps, 32), torch.zeros(B, warps)
    groups = [(D, min(RING, K - D)) for D in range(0, K, RING)]
    for w in range(warps):
        for task in range(w, tasks, warps):
            s, c = task % slices, task // slices
            t0 = c * frames
            t1 = min(t0 + frames, T)
            count = torch.zeros(B)
            # each group's pairs (a, b = a + D + j) with b in the chunk:
            # steps bp = b - D in order, then j = 1..J
            for D, J in groups:
                for bp in range(max(t0 - D, 0), t1 - D):
                    for j in range(1, J + 1):
                        a, b = bp - j, bp + D
                        if a < 0:
                            continue
                        wgt = mask[:, a] * mask[:, b]
                        diff = lanes[:, b, s] - lanes[:, a, s]
                        sq = diff * diff
                        share = ((sq[..., 0] + sq[..., 1])
                                 + (sq[..., 2] + sq[..., 3])) if v == 4 \
                            else sq[..., 0]
                        acc[:, w] = acc[:, w] + wgt[:, None] * share
                        count = count + wgt
            if s == 0:
                pairs[:, w] = pairs[:, w] + count
    for off in (16, 8, 4, 2, 1):
        acc = acc + acc[..., torch.arange(32) ^ off]
    acc = acc[..., 0]

    def in_order(x):                      # (B, n) -> (B,), left to right
        out = x[:, 0]
        for i in range(1, x.shape[1]):
            out = out + x[:, i]
        return out
    blocks = [(in_order(acc[:, r * WARPS:(r + 1) * WARPS]),
               in_order(pairs[:, r * WARPS:(r + 1) * WARPS]))
              for r in range(cluster)]
    return (in_order(torch.stack([t for t, _ in blocks], 1)),
            in_order(torch.stack([c for _, c in blocks], 1)))


def test_plan_at_the_paths_shapes():
    """The plans the source's header names: the refine round's rows one
    block each, the edge learner's row over a cluster of 7, the LM step's
    rows 8 slices x 8 chunks; and the scalar lanes where z is not
    float4-aligned."""
    assert (WARPS, RING, MAX_CLUSTER) == (8, 5, 8)
    assert _plan(256, 100, 128) == (4, 1, 13, 8, 1)
    assert _plan(1, 104, 128) == (4, 1, 2, 52, 7)
    assert _plan(8, 16, 1024) == (4, 8, 2, 8, 8)
    assert _plan(300, 100, 128) == (4, 1, 13, 8, 1)
    assert _plan(9, 37, 127, vec=False) == (1, 4, 3, 13, 7)
    # more tasks than a cluster's warps: longer chunks, one task a warp
    assert _plan(1, 1000, 128) == (4, 1, 16, 63, 8)
    assert _plan(4, 100, 2048) == (4, 16, 25, 4, 8)
    # T = 1: one chunk, one block
    assert _plan(16, 1, 128) == (4, 1, 2, 1, 1)


# (what, B of the plan, B of the input, T, d, k, float4 lanes): the paths'
# plans at a reduced B, the chunk's edges (T a whole number of chunks, a
# last chunk of one frame), K at and past a chunk's length and past the
# ring (three delta groups), k >= T, T = 1, k = 0, d = 127 and 2,048, a
# misaligned z (scalar lanes at d = 128), B = 1 with T = 1,000, B = 300
EMULATED = [
    ("refine", 256, 3, 100, 128, 5, True),
    ("edge", 1, 1, 104, 128, 3, True),
    ("lm", 8, 2, 16, 1024, 5, True),
    ("whole chunks", 256, 2, 64, 128, 5, True),
    ("last chunk of one frame", 256, 2, 57, 128, 5, True),
    ("edge, last chunk of one frame", 1, 1, 105, 128, 3, True),
    ("K = chunk length", 256, 2, 100, 32, 13, True),
    ("K past the ring", 256, 2, 100, 32, 20, True),
    ("k >= T", 64, 2, 16, 32, 20, True),
    ("T = 1", 16, 2, 1, 32, 5, True),
    ("k = 0", 256, 2, 20, 32, 0, True),
    ("d = 127", 9, 2, 37, 127, 3, False),
    ("d = 2,048", 4, 2, 20, 2048, 5, True),
    ("misaligned", 256, 2, 30, 128, 5, False),
    ("B = 1, T = 1,000", 1, 1, 1000, 8, 5, True),
    ("B = 300", 300, 2, 100, 64, 5, True),
]


@pytest.mark.parametrize("what,plan_b,B,T,d,k,vec", EMULATED,
                         ids=[c[0] for c in EMULATED])
def test_emulated_forward_kernel_matches_plain_and_pallas(what, plan_b, B,
                                                          T, d, k, vec):
    """The kernel's order against the plain version per row (rtol 1e-5,
    counts exact) and its batch ratio against the Pallas kernel in
    interpret mode; an all-masked row gives exactly 0."""
    z, m = _inputs(B, T, d, T + d + k, masked_row=B > 1)
    tz, tm = torch.from_numpy(z), torch.from_numpy(m)
    tot, cnt = _emulate(tz, tm, k, _plan(plan_b, T, d, vec))
    want_tot, want_cnt = laplacian_energy_ref(tz, tm, k)
    np.testing.assert_allclose(tot.numpy(), want_tot.numpy(), rtol=RTOL)
    assert torch.equal(cnt, want_cnt)
    if B > 1:
        assert tot[-1] == 0.0 and cnt[-1] == 0.0
    pallas = float(jops.laplacian_energy(z, m, k=k))
    np.testing.assert_allclose(float(tot.sum() / cnt.sum().clamp_min(1.0)),
                               pallas, rtol=RTOL)
