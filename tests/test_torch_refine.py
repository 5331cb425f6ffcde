"""The port's refine round against the reference.

The reference's random draws cannot be replayed by a torch generator,
so each test hands them across: round r's ``(dirs, prior)`` are
``random_directions`` / ``sphere_prior_samples`` of ``split(key_r)``,
exactly what the reference draws from ``key_r``, and the head and the
GMM memory start from the reference's own state (``head_from_jax``,
``gmm_from_jax``).  The loss, its parts, the per-session losses and the
gradient are held at rtol 1e-5 (float32 sums in another order), the
head after SGD steps at rtol 1e-5 and the GMM state after EM steps at
rtol 1e-4 (differences compound through the responsibilities).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import fleet_backend as jfb  # noqa: E402
from repro.core import fleet_refiner as jfr  # noqa: E402
from repro.core import hybrid as jhyb  # noqa: E402
from repro.core import infonce as jinfo  # noqa: E402
from repro.core import server as jsrv  # noqa: E402
from repro.core import swd as jswd  # noqa: E402
from repro.optim import sgd as jsgd  # noqa: E402
from repro_torch.core import fleet_refiner as fr  # noqa: E402
from repro_torch.core import hybrid, infonce, server  # noqa: E402
from repro_torch.core.fleet_backend import HostFleetBackend  # noqa: E402
from repro_torch.core.fleet_buffer import FleetBuffer  # noqa: E402
from repro_torch.optim import sgd  # noqa: E402
from repro_torch.weights import (gmm_from_jax, head_from_jax,  # noqa: E402
                                 head_to_jax)

D, C = 16, 4
RTOL = 1e-5
CFG = hybrid.HybridCfg()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs files in parallel workers: one intra-op thread per
    worker keeps torch from oversubscribing the cores (results do not
    depend on it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jhead_init(key):
    k1, k2 = jax.random.split(key)
    return {"w": 0.1 * jax.random.normal(k1, (D, C)),
            "b": 0.01 * jax.random.normal(k2, (C,))}


def jhead_apply(p, z):
    return z @ p["w"] + p["b"]


def head_apply(p, z):
    return z @ p["w"] + p["b"]


def head_of(seed=0):
    """The reference's head for ``seed``, as the port's ``head_init``."""
    params = head_from_jax(jax.tree.map(np.asarray,
                                        jhead_init(jax.random.PRNGKey(seed))))
    return lambda generator: params


def jdraws(key, n):
    kd, kp = jax.random.split(key)
    return (np.array(jswd.random_directions(kd, CFG.n_dirs, D)),
            np.array(jswd.sphere_prior_samples(kp, n, D)))


def _snapshot(N, W, seed):
    rng = np.random.default_rng(seed)
    mask = (rng.random((N, W)) > 0.2).astype(np.float32)
    z = rng.normal(size=(N, W, D)).astype(np.float32) * mask[..., None]
    labels = np.where(mask > 0, rng.integers(0, C, (N, W)), -1)
    labels[:, ::3] = -1                          # sparse labels
    active = np.ones(N, bool)
    active[N // 2] = False
    z[N // 2] = 0.0
    mask[N // 2] = 0.0
    labels[N // 2] = -1
    return z, mask, labels, active


def _assert_tree_close(port, ref, rtol):
    for k, v in head_to_jax(port).items():
        np.testing.assert_allclose(v, np.asarray(ref[k]), rtol=rtol,
                                   atol=1e-7, err_msg=k)


def test_make_fleet_loss_and_gradient_match_reference():
    N, W = 5, 12
    z, mask, labels, active = _snapshot(N, W, 0)
    key = jax.random.PRNGKey(4)
    jparams = jhead_init(jax.random.PRNGKey(0))
    (jloss, (jlosses, jparts)), jgrads = jax.jit(jax.value_and_grad(
        jfr.make_fleet_loss(jhead_apply, jhyb.HybridCfg()), has_aux=True))(
            jparams, key, z, mask, labels, active.astype(np.float32))
    dirs, prior = map(torch.from_numpy, jdraws(key, W))
    params = head_of()(None)
    (loss, (losses, parts)), grads = sgd.value_and_grad(
        fr.make_fleet_loss(head_apply, CFG), params, dirs, prior,
        torch.from_numpy(z), torch.from_numpy(mask), torch.from_numpy(labels),
        torch.from_numpy(active.astype(np.float32)))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=RTOL)
    np.testing.assert_allclose(losses.detach().numpy(), np.asarray(jlosses),
                               rtol=RTOL)
    for k in jparts:
        np.testing.assert_allclose(float(parts[k].detach()), float(jparts[k]),
                                   rtol=RTOL, err_msg=k)
    for g, k in zip(grads, sorted(params)):
        np.testing.assert_allclose(g.numpy(), np.asarray(jgrads[k]),
                                   rtol=RTOL, atol=1e-7, err_msg=k)


def test_fleet_refiner_three_steps_match_reference():
    N, W = 4, 10
    z, mask, labels, active = _snapshot(N, W, 1)
    jref = jfr.FleetRefiner(jhead_init, jhead_apply, lr=0.5)
    port = fr.FleetRefiner(head_of(), head_apply, lr=0.5, device="cpu",
                           draws=lambda r: jdraws(jax.random.PRNGKey(r), W))
    for r in range(3):
        jl, jp, jper = jref.refine_arrays(jax.random.PRNGKey(r), z, mask,
                                          labels, active)
        loss, parts, per = port.refine_arrays(r, z, mask, labels, active)
        np.testing.assert_allclose(loss, jl, rtol=RTOL)
        np.testing.assert_allclose(per, jper, rtol=RTOL)
        assert parts.keys() == jp.keys()
    _assert_tree_close(port.state.params, jref.state.params, RTOL)
    assert port.state.step == jref.state.step == 3


def test_inactive_rows_are_masked_out():
    """Rows never admitted and an evicted row (its frames still in the
    ring) move neither the mean loss nor the head: the step equals the
    one-session fleet's."""
    W = 8
    fleet, single = FleetBuffer(4, W, D), FleetBuffer(1, W, D)
    sid = fleet.admit()
    gone = fleet.admit()
    single.admit()
    rng = np.random.default_rng(0)
    for t in range(W):
        z = rng.normal(size=D)
        fleet.insert(sid, t, z, label=t % C)
        single.insert(0, t, z, label=t % C)
        fleet.insert(gone, t, rng.normal(size=D), label=1)
    fleet.evict(gone)
    draws = lambda r: jdraws(jax.random.PRNGKey(r), W)  # noqa: E731
    a = fr.FleetRefiner(head_of(), head_apply, lr=0.1, device="cpu",
                        draws=draws)
    b = fr.FleetRefiner(head_of(), head_apply, lr=0.1, device="cpu",
                        draws=draws)
    loss, parts, per = a.refine(0, fleet)
    loss1, parts1, _ = b.refine(0, single)
    assert np.isfinite(per).all()
    np.testing.assert_allclose(loss, per[sid], rtol=1e-6)
    np.testing.assert_allclose(loss, loss1, rtol=1e-6)
    for k in parts:
        np.testing.assert_allclose(parts[k], parts1[k], rtol=1e-6)
    for x, y in zip(sgd.tree_leaves(a.state.params),
                    sgd.tree_leaves(b.state.params)):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-6)


def test_fleet_refiner_n1_matches_server_refiners():
    """Port FleetRefiner at N=1 == port ServerRefiner == reference
    ServerRefiner, five steps on one gappy buffer."""
    W = 32
    buf, jbuf = server.TemporalBuffer(W, D), jsrv.TemporalBuffer(W, D)
    fleet = FleetBuffer(1, W, D)
    sid = fleet.admit()
    rng = np.random.default_rng(0)
    centers = rng.normal(size=(C, D))
    for t in range(40):
        if t % 7 == 3:
            continue
        z = centers[t % C] + 0.1 * rng.normal(size=D)
        for b in (buf, jbuf):
            b.insert(t, z, label=t % C)
        fleet.insert(sid, t, z, label=t % C)
    for x, y in zip(buf.snapshot(), jbuf.snapshot()):
        np.testing.assert_array_equal(x, y)
    assert buf.fill_fraction == jbuf.fill_fraction
    jsrv_ = jsrv.ServerRefiner(jhead_init, jhead_apply, lr=0.5)
    srv = server.ServerRefiner(head_of(), head_apply, lr=0.5, device="cpu")
    flt = fr.FleetRefiner(head_of(), head_apply, lr=0.5, device="cpu",
                          draws=lambda r: jdraws(jax.random.PRNGKey(r), W))
    for i in range(5):
        jl, jp = jsrv_.refine(jax.random.PRNGKey(i), jbuf)
        sl, sp = srv.refine(jdraws(jax.random.PRNGKey(i), W), buf)
        fl, fp, _ = flt.refine(i, fleet)
        np.testing.assert_allclose(sl, jl, rtol=RTOL)
        np.testing.assert_allclose(fl, sl, rtol=RTOL)
        for k in jp:
            np.testing.assert_allclose(sp[k], jp[k], rtol=RTOL, err_msg=k)
            np.testing.assert_allclose(fp[k], sp[k], rtol=RTOL, err_msg=k)
    _assert_tree_close(srv.state.params, jsrv_.state.params, RTOL)
    _assert_tree_close(flt.state.params, jsrv_.state.params, RTOL)


def test_host_backend_refine_with_memory_matches_reference():
    N, W, K = 5, 12, 6
    jb = jfb.HostFleetBackend(capacity=N, window=W, dim=D,
                              head_init=jhead_init, head_apply=jhead_apply,
                              n_components=K, seed=3)
    tb = HostFleetBackend(capacity=N, window=W, dim=D, head_init=head_of(3),
                          head_apply=head_apply, n_components=K, seed=3,
                          draws=lambda r: jdraws(jax.random.PRNGKey(r), W),
                          device="cpu")
    tb.memory = gmm_from_jax(jax.tree.map(np.asarray, jb.memory))
    rng = np.random.default_rng(1)
    for b in (jb, tb):
        for _ in range(N - 1):
            b.admit()
    for t in range(W + 3):
        keep = np.flatnonzero(rng.random(N - 1) > 0.1)
        zs = rng.normal(size=(len(keep), D)).astype(np.float32)
        labels = rng.integers(0, C, len(keep))
        for b in (jb, tb):
            b.insert_batch(keep, np.full(len(keep), t), zs, labels)
    for r in range(2):
        jl, jp, jper = jb.refine(jax.random.PRNGKey(r))
        loss, parts, per = tb.refine(r)
        np.testing.assert_allclose(loss, jl, rtol=RTOL)
        np.testing.assert_allclose(per, jper, rtol=RTOL)
        for k in jp:
            np.testing.assert_allclose(parts[k], jp[k], rtol=RTOL, err_msg=k)
    _assert_tree_close(tb.refiner.state.params, jb.refiner.state.params, RTOL)
    for got, want in zip(tb.memory, jb.memory):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-7)
    assert tb.snapshot_h2d_bytes == jb.snapshot_h2d_bytes > 0
    assert tb.can_refine and tb.device == torch.device("cpu")


@pytest.mark.parametrize("variant", ["hybrid", "task_sw", "task_lap", "mse",
                                     "kl"])
def test_hybrid_loss_variants_match_reference(variant):
    rng = np.random.default_rng(2)
    B, T = 2, 9
    z = rng.normal(size=(B, T, D)).astype(np.float32)
    mask = (rng.random((B, T)) > 0.2).astype(np.float32)
    logits = rng.normal(size=(B * T, C)).astype(np.float32)
    labels = rng.integers(0, C, B * T)
    z_pos = rng.normal(size=(B * T, D)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    tkey = tuple(map(torch.from_numpy, jdraws(key, B * T)))
    for kw in ({"logits": logits, "labels": labels}, {"z_pos": z_pos}):
        jl, jp = jhyb.hybrid_loss(key, z, jhyb.HybridCfg(), mask=mask,
                                  variant=variant, **kw)
        tl, tp = hybrid.hybrid_loss(
            tkey, torch.from_numpy(z), CFG, mask=torch.from_numpy(mask),
            variant=variant, **{k: torch.from_numpy(v) for k, v in kw.items()})
        np.testing.assert_allclose(float(tl), float(jl), rtol=RTOL)
        assert tp.keys() == jp.keys()
        for k in jp:
            np.testing.assert_allclose(float(tp[k]), float(jp[k]), rtol=RTOL,
                                       err_msg=k)
    assert float(hybrid.task_loss(torch.from_numpy(z_pos))) == 0.0


def test_infonce_matches_reference():
    rng = np.random.default_rng(3)
    z, zp = (rng.normal(size=(6, D)).astype(np.float32) for _ in range(2))
    zn = rng.normal(size=(6, 5, D)).astype(np.float32)
    zn /= np.linalg.norm(zn, axis=-1, keepdims=True)
    tz, tzp, tzn = map(torch.from_numpy, (z, zp, zn))
    np.testing.assert_allclose(infonce.cosine(tz, tzp).numpy(),
                               np.asarray(jinfo.cosine(z, zp)), rtol=1e-5)
    np.testing.assert_allclose(
        float(infonce.streaming_infonce(tz, tzp, tzn, tau=0.2)),
        float(jinfo.streaming_infonce(z, zp, zn, tau=0.2)), rtol=1e-5)
    np.testing.assert_allclose(float(infonce.batch_infonce(tz, tzp)),
                               float(jinfo.batch_infonce(z, zp)), rtol=1e-5)


@pytest.mark.parametrize("nesterov", [False, True])
def test_sgd_matches_reference_in_place(nesterov):
    rng = np.random.default_rng(4)
    jp = {"a": jnp.asarray(rng.normal(size=(3, 2)), jnp.float32),
          "b": {"c": jnp.asarray(rng.normal(size=4), jnp.float32)}}
    tp = head_from_jax(jax.tree.map(np.asarray, jp))
    a_before = tp["a"]
    jst, tst = jsgd.sgd_init(jp), sgd.sgd_init(tp)
    for _ in range(3):
        g = {"a": rng.normal(size=(3, 2)).astype(np.float32),
             "b": {"c": rng.normal(size=4).astype(np.float32)}}
        jp, jst = jsgd.sgd_update(jp, g, jst, lr=0.1, nesterov=nesterov)
        tp, tst = sgd.sgd_update(tp, head_from_jax(g), tst, lr=0.1,
                                 nesterov=nesterov)
    assert tp["a"] is a_before                   # updated in place
    np.testing.assert_allclose(tp["a"].numpy(), np.asarray(jp["a"]),
                               rtol=1e-6)
    np.testing.assert_allclose(tp["b"]["c"].numpy(), np.asarray(jp["b"]["c"]),
                               rtol=1e-6)
