"""The port's edge learner against the reference (``benchmarks/edge_train.py``).

Both run the reference's small encoder ``ENC`` (widths 16,16,32,32, d=32,
97 frames) from the reference's own initial weights and GMM
(``params_from_jax``, ``gmm_from_jax``), on the same stream, with the
reference's random draws handed across: the draws of step i come from the
key ``sub`` that the reference's loop splits off at step i (``jdraws``).

- Step 0: ``make_loss("streamsplit")``'s loss and every parameter's
  gradient against ``jax.value_and_grad`` of the reference's, cold and
  warm (past cold start, the virtual term's gradient non-zero), at rtol
  1e-4 relative to each tensor's max |x|: float32 sums in another order
  through 4 residual blocks, GroupNorm and the three loss terms.
- Three steps of ``train_representation`` against the reference's loop
  (its body, with the reference's ``make_loss``, ``adamw_update`` and
  ``em_update``): the loss trajectory at rtol 1e-5, the parameters at atol
  1e-4 and the eval embeddings at atol 1e-5.  These are measured bounds
  (on the CPU: losses 2.5e-7 relative, parameters 9.9e-6, embeddings
  1.1e-6), not tolerances of the arithmetic: Adam's first step moves each
  weight by about lr·sign(g), so an element whose gradient is ~0 could
  flip sign between frameworks and move by 2·lr = 4e-3.  None does on
  these inputs.
- AdamW on identical gradients, the stream's mels bit for bit, and the
  linear probe and retrieval metrics on identical embeddings.
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:          # ``benchmarks`` is a package at the root
    sys.path.insert(0, REPO)

from benchmarks import edge_train as jet  # noqa: E402
from repro.core import gmm as jgmm  # noqa: E402
from repro.core import swd as jswd  # noqa: E402
from repro.data import audio_stream as jas  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro_torch.core import gmm  # noqa: E402
from repro_torch.data import audio_stream as tas  # noqa: E402
from repro_torch.optim.adamw import adamw_init, adamw_update  # noqa: E402
from repro_torch.optim.sgd import tree_leaves  # noqa: E402
from repro_torch.runtime import edge_train as et  # noqa: E402
from repro_torch.weights import (adamw_from_jax, adamw_to_jax,  # noqa: E402
                                 gmm_from_jax, gmm_to_jax, params_from_jax,
                                 params_to_jax)

RTOL = 1e-4
LR = 2e-3
LOSS_RTOL, PARAM_ATOL, EMBED_ATOL = 1e-5, 1e-4, 1e-5   # measured bounds
B, N_SYN, C, D = 8, 16, et.N_COMPONENTS, et.ENC.d_embed


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs files in parallel workers: one intra-op thread per
    worker keeps torch from oversubscribing the cores (results do not
    depend on it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def ref():
    """The reference's initial state and its jitted value-and-gradient."""
    params = np_tree(jet.init_audio_encoder(jet.ENC, jax.random.PRNGKey(0)))
    gmm0 = np_tree(jgmm.init_gmm(jax.random.PRNGKey(1), C, D))
    vg = jax.jit(jax.value_and_grad(jet.make_loss("streamsplit"),
                                    has_aux=True))
    return params, gmm0, vg


def subs(n, seed=0):
    """The keys the reference's loop splits off at steps 0..n-1."""
    key, out = jax.random.PRNGKey(seed), []
    for _ in range(n):
        key, sub = jax.random.split(key)
        out.append(sub)
    return out


def jdraws(sub, n_points=et.BUFFER + B):
    """What the reference draws from ``sub`` in one step: the categorical's
    Gumbel noise and the Gaussian eps of ``sample_virtual_negatives``, and
    the SWD directions and prior of ``swd_to_uniform``."""
    k1, k2 = jax.random.split(sub)
    gumbel = jax.random.gumbel(k1, (B, N_SYN, C), jnp.float32)
    eps = jax.random.normal(k2, (B, N_SYN, D), jnp.float32)
    kd, kp = jax.random.split(sub)
    dirs = jswd.random_directions(kd, 32, D)
    prior = jswd.sphere_prior_samples(kp, n_points, D)
    return tuple(map(np.array, (gumbel, eps))), \
        tuple(map(np.array, (dirs, prior)))


def ref_batch(stream, rng):
    """The reference loop's data for one step."""
    mels, _, _ = stream.batch(B)
    m1s, m2s = [], []
    for m in mels:
        a, b = jas.augment_pair(rng, m[: jet.ENC.frames])
        m1s.append(a)
        m2s.append(b)
    mask = (rng.random(B) >= 0.0).astype(np.float32)
    return np.stack(m1s), np.stack(m2s), mask


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def assert_grads(grads, jgrads):
    """Every leaf, relative to its own max |x|, in ``tree_leaves`` order
    (the reference's gradient converted to the port's layout)."""
    want = tree_leaves(params_from_jax(np_tree(jgrads)))
    assert len(grads) == len(want)
    for i, (g, w) in enumerate(zip(grads, want)):
        assert rel(g.numpy(), w.numpy()) <= RTOL, (i, rel(g.numpy(),
                                                         w.numpy()))


def unit(rng, shape):
    z = rng.normal(size=shape).astype(np.float32)
    return z / np.linalg.norm(z, axis=-1, keepdims=True)


@pytest.mark.parametrize("cold", [True, False])
def test_step0_loss_and_gradients_match_reference(ref, cold):
    params, gmm0, vg = ref
    sub = subs(1)[0]
    zbuf = np.zeros((et.BUFFER, D), np.float32)
    zbuf[:, 0] = 1.0
    if not cold:
        # past cold start: a filled buffer and a GMM fitted on it
        rng = np.random.default_rng(11)
        zbuf = unit(rng, (et.BUFFER, D))
        for _ in range(3):
            gmm0 = np_tree(jgmm.em_update(gmm0, zbuf, decay=0.1))
    m1, m2, mask = ref_batch(jas.AudioStream(jas.StreamCfg(seed=0)),
                             np.random.default_rng(0))
    (jl, _), jg = vg(params, sub, m1, m2, jgmm.GMMState(*gmm0), mask,
                     jnp.bool_(cold), zbuf)

    tr = et.EdgeTrainer("streamsplit", n_syn=N_SYN, lr=LR, device="cpu",
                        params=params_from_jax(params),
                        gmm_state=gmm_from_jax(gmm0),
                        draws=lambda step: jdraws(sub))
    tr.zbuf = torch.from_numpy(zbuf)
    tr.i = 0 if cold else et.COLD_STEPS
    loss, grads = tr.step()
    np.testing.assert_allclose(float(loss), float(jl), rtol=RTOL)
    assert_grads(grads, jg)


def test_make_loss_edge_only_matches_reference(ref):
    params = ref[0]
    m1, m2, mask = ref_batch(jas.AudioStream(jas.StreamCfg(seed=2)),
                             np.random.default_rng(2))
    jl, _ = jax.jit(jet.make_loss("edge_only"))(params, None, m1, m2, None,
                                                mask, None, None)
    tl, _ = et.make_loss("edge_only")(params_from_jax(params), None,
                                      torch.from_numpy(m1),
                                      torch.from_numpy(m2), None, None, None,
                                      None)
    np.testing.assert_allclose(float(tl), float(jl), rtol=RTOL)


def test_three_steps_track_reference(ref):
    params, gmm0, vg = ref
    steps = 3
    keys = subs(steps)
    # the reference's loop (benchmarks/edge_train.py::train_representation)
    jp, jopt, jg = params, jadamw.adamw_init(params), jgmm.GMMState(*gmm0)
    stream, rng = jas.AudioStream(jas.StreamCfg(seed=0)), \
        np.random.default_rng(0)
    zbuf = jnp.zeros((et.BUFFER, D)).at[:, 0].set(1.0)
    jlosses = []
    for i in range(steps):
        m1, m2, mask = ref_batch(stream, rng)
        (l, z1), g = vg(jp, keys[i], m1, m2, jg, mask, jnp.bool_(i < 50),
                        zbuf)
        jp, jopt = jadamw.adamw_update(jp, g, jopt, lr=LR)
        zbuf = jnp.concatenate([z1, zbuf], 0)[: et.BUFFER]
        jg = jgmm.em_update(jg, zbuf, decay=0.1)
        jlosses.append(float(l))

    res = et.train_representation(
        "streamsplit", steps=steps, eval_n=24, n_syn=N_SYN, lr=LR,
        device="cpu", params=params_from_jax(params),
        gmm_state=gmm_from_jax(gmm0), draws=lambda step: jdraws(keys[step]))
    np.testing.assert_allclose(res.losses, jlosses, rtol=LOSS_RTOL)
    got = params_to_jax(res.params)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(np_tree(jp))):
        np.testing.assert_allclose(a, b, rtol=0, atol=PARAM_ATOL)
    # the eval embeddings of the final weights, and their collapse score
    mels, ys, _ = jas.AudioStream(jas.StreamCfg(seed=100)).batch(24)
    jz = np.asarray(jet.encode(jet.ENC, jp, mels[:, : jet.ENC.frames]))
    np.testing.assert_array_equal(res.eval_y, ys)
    np.testing.assert_allclose(res.eval_z, jz, rtol=0, atol=EMBED_ATOL)
    sim = np.abs(jz @ jz.T)
    np.testing.assert_allclose(res.collapse,
                               (sim.sum() - 24) / (24 * 23), rtol=1e-5)
    assert res.eval_z.shape == (24, D) and 0.0 <= res.probe_acc <= 1.0


def test_adamw_update_matches_reference():
    rng = np.random.default_rng(3)
    params = np_tree(jet.init_audio_encoder(jet.ENC, jax.random.PRNGKey(5)))
    jp, jopt = params, jadamw.adamw_init(params)
    tp = params_from_jax(params)
    topt = adamw_init(tp)
    for step in range(3):
        # the third step's gradient is small: global norm under grad_clip
        scale = 3.0 if step < 2 else 1e-3
        jgr = jax.tree.map(
            lambda p: (scale * rng.normal(size=p.shape)).astype(np.float32),
            params)
        jp, jopt = jadamw.adamw_update(jp, jgr, jopt, lr=LR)
        adamw_update(tp, tree_leaves(params_from_jax(jgr)), topt, lr=LR)
    assert int(topt["step"]) == 3
    for got, want in ((params_to_jax(tp), np_tree(jp)),
                      (adamw_to_jax(topt)["m"], np_tree(jopt["m"])),
                      (adamw_to_jax(topt)["v"], np_tree(jopt["v"]))):
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7)
    back = adamw_from_jax(jax.tree.map(np.asarray, jopt))
    for a, b in zip(tree_leaves(back["m"]), tree_leaves(topt["m"])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-9)


def test_audio_stream_is_bitwise_the_reference():
    a, b = jas.AudioStream(jas.StreamCfg(seed=4)), \
        tas.AudioStream(tas.StreamCfg(seed=4))
    for _ in range(2):
        (jm, jy, jgrp), (tm, ty, tgrp) = a.batch(5), b.batch(5)
        np.testing.assert_array_equal(tm, jm)
        np.testing.assert_array_equal(ty, jy)
        assert tgrp == jgrp
    assert tm.shape == (5, 98, 128) and tm.dtype == np.float32
    r1, r2 = np.random.default_rng(1), np.random.default_rng(1)
    for x, y in zip(jas.augment_pair(r1, jm[0]), tas.augment_pair(r2, jm[0])):
        np.testing.assert_array_equal(x, y)
    w = a.next_sample()[0]
    np.testing.assert_array_equal(tas.mel_frontend(w), jas.mel_frontend(w))


def test_linear_probe_and_retrieval_match_reference():
    rng = np.random.default_rng(6)
    y = rng.integers(0, 5, 80)
    centers = unit(rng, (5, 16))
    z = (centers[y] + 0.3 * rng.normal(size=(80, 16))).astype(np.float32)
    assert et.linear_probe(z, y, seed=1, device="cpu") == \
        jet.linear_probe(z, y, seed=1)
    assert et.retrieval_metrics(z, y, k=5) == jet.retrieval_metrics(z, y,
                                                                    k=5)


def test_seeded_draws_and_trainer_defaults():
    """Without ``draws`` a step's draws come from a CPU generator seeded
    from (seed, step); the initial GMM and buffer are the reference's
    shapes; the entry point defaults to the card."""
    a = et.seeded_draws(0, 3, batch=B, n_syn=N_SYN, n_components=C, dim=D,
                        n_dirs=32, n_points=104)
    b = et.seeded_draws(0, 3, batch=B, n_syn=N_SYN, n_components=C, dim=D,
                        n_dirs=32, n_points=104)
    c = et.seeded_draws(0, 4, batch=B, n_syn=N_SYN, n_components=C, dim=D,
                        n_dirs=32, n_points=104)
    for x, y in zip(a[0] + a[1], b[0] + b[1]):
        assert torch.equal(x, y)
    assert not torch.equal(a[1][0], c[1][0])
    assert tuple(a[0][0].shape) == (B, N_SYN, C)
    assert tuple(a[1][1].shape) == (104, D)
    tr = et.EdgeTrainer(device="cpu")
    assert tr.gmm.n_components == C and tuple(tr.zbuf.shape) == (96, D)
    assert (tr.zbuf[:, 0] == 1).all() and (tr.zbuf[:, 1:] == 0).all()
    s0, s1, s2, step = gmm_to_jax(tr.gmm)
    assert s0.shape == (C,) and s1.shape == (C, D) and int(step) == 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            et.EdgeTrainer()
