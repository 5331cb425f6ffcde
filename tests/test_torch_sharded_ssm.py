"""The port's SSM and hybrid families on a mesh (``lm.forward`` /
``lm_loss`` under ``axis_rules``, ``ssm.mamba_forward_sharded``,
``runtime/trainer.make_sharded_train_step``) against the reference's
unsharded jitted functions.  Meshes are logical shards of the CPU.

mamba2-780m and zamba2-1.2b (smoke configs: 4 SSM heads, zamba2's
shared attention+MLP block after each 2 of its 5 mamba layers) on (data
2, model 2) and (1, 4): the SSM heads over 'model' (one a shard on (1,
4)), ``wB``/``wC`` whole, ``wo`` row-parallel; the shared block's heads
column-parallel.  Weights and the AdamW state are the reference's
(``weights.py``), the batches its ``random_batch``, the hybrid term's SW
draws handed across as ``(dirs, prior)``.  Tolerances: losses rtol 1e-5,
logits, every gradient and updated leaf within 1e-4 of its leaf's max;
every replica of a block bitwise equal to the others after a step."""
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import base as jbase  # noqa: E402
from repro.core import swd as jswd  # noqa: E402
from repro.data.tokens import random_batch as jrandom_batch  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.runtime import trainer as jtr  # noqa: E402
from repro_torch.checkpoint.serial import _paths  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.launch.mesh import make_test_mesh  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.optim.sgd import tree_leaves, value_and_grad  # noqa: E402
from repro_torch.runtime import trainer as tr  # noqa: E402
from repro_torch.weights import (lm_from_jax, lm_from_mesh,  # noqa: E402
                                 lm_to_mesh, train_state_from_jax,
                                 train_state_to_jax)

LOSS_RTOL, LEAF_RTOL = 1e-5, 1e-4
B, S, POOL, LR = 4, 32, 8, 1e-3
NAMES = ("mamba2-780m", "zamba2-1.2b")
MESHES = ((2, 2), (1, 4))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _cfgs(name):
    return (jbase.smoke_config(jbase.get_config(name)),
            base.smoke_config(base.get_config(name)))


def _rules(c, shape):
    mesh = make_test_mesh(shape, devices=["cpu"] * int(np.prod(shape)))
    return shd.rules_for(mesh, c, batch=B, kind="train")


def _tbatch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _draw(key, d):
    kd, kp = jax.random.split(key)
    return (torch.from_numpy(np.array(jswd.random_directions(kd, 50, d))),
            torch.from_numpy(np.array(jswd.sphere_prior_samples(
                kp, B * (S // POOL), d))))


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    scale = np.abs(want).max()
    return np.abs(got - want).max() / (scale if scale else 1.0)


@lru_cache(maxsize=None)
def _reference(name):
    """The reference's params, batch, logits, hybrid loss, metrics and
    gradient for a smoke config (jitted once for the module)."""
    jc, c = _cfgs(name)
    jp = _np(jax.jit(lambda k: jlm.init_lm(jc, k)[0])(jax.random.PRNGKey(0)))
    batch = _np(jrandom_batch(jax.random.PRNGKey(1), c.vocab, B, S))
    key = jax.random.PRNGKey(7)
    jh, _ = jax.jit(lambda p, t: jlm.forward(jc, p, tokens=t))(
        jp, batch["tokens"])
    jlogits = np.asarray(jax.jit(lambda p, h: jlm.logits_from_hidden(
        jc, p, h))(jp, jh))
    jt = jtr.TrainCfg(hybrid=True, hybrid_pool=POOL)
    (jv, jm), jg = jax.jit(jax.value_and_grad(
        jtr.make_loss_fn(jc, jt), has_aux=True))(jp, batch, key)
    return jp, batch, key, jlogits, float(jv), _np(jm), _np(jg), jt


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("name", NAMES)
def test_forward_loss_and_gradients_match_reference(name, shape):
    """Logits, ``lm_loss`` and the gradient of the hybrid train loss on
    the mesh against the reference's unsharded jitted ones."""
    jp, batch, key, jlogits, jv, jm, jg, jt = _reference(name)
    _, c = _cfgs(name)
    p, tb = lm_from_jax(jp), _tbatch(batch)
    loss_fn = tr.make_loss_fn(c, tr.TrainCfg(hybrid=True, hybrid_pool=POOL))
    rules = _rules(c, shape)
    assert rules.param_rules["ssm_heads"] == "model"
    with shd.axis_rules(rules):
        h, aux = lm.forward(c, p, tokens=tb["tokens"])
        loss, _ = lm.lm_loss(c, p, tb)
        (v, m), g = value_and_grad(loss_fn, p, tb, _draw(key, c.d_model))
    assert float(aux) == 0.0
    assert _rel(lm.logits_from_hidden(c, p, h).detach(), jlogits) \
        <= LEAF_RTOL
    np.testing.assert_allclose(float(loss), jv - float(
        jt.hybrid_lam_sw * jm["swd"] + jt.hybrid_lam_lap * jm["lap"]),
        rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(v), jv, rtol=LOSS_RTOL)
    for k in m:
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=LOSS_RTOL,
                                   atol=1e-7, err_msg=k)
    for got, want in zip(g, jax.tree.leaves(jg)):
        assert _rel(got, want) <= LEAF_RTOL


def _replicas_equal(tree):
    for t in tree_leaves(tree):
        first = {}
        for b, sl in zip(t.blocks, t.sharding.slices(t.shape)):
            key = tuple((x.start, x.stop) for x in sl)
            assert torch.equal(first.setdefault(key, b), b)


@pytest.mark.parametrize("name,shape", [("mamba2-780m", (1, 4)),
                                        ("zamba2-1.2b", (2, 2))])
def test_train_step_matches_reference(name, shape):
    """One ``make_sharded_train_step`` (AdamW, hybrid term on) from the
    reference's state against its jitted step: metrics and every updated
    leaf; replicas bitwise; the SSM blocks each shard holds are its
    heads."""
    jc, c = _cfgs(name)
    kw = dict(lr=LR, warmup=1, total_steps=10, hybrid=True,
              hybrid_pool=POOL)
    jt, tt = jtr.TrainCfg(**kw), tr.TrainCfg(**kw)
    jstate = _np(jax.jit(lambda k: jtr.init_train_state(jc, jt, k)[0])(
        jax.random.PRNGKey(4)))
    batch = _np(jrandom_batch(jax.random.PRNGKey(10), c.vocab, B, S))
    key = jax.random.PRNGKey(20)
    jp, jo, jm = jax.jit(jtr.make_train_step(jc, jt))(
        jstate["params"], jstate["opt"], batch, jnp.int32(0), key)
    lay = shd.ShardLayout(_rules(c, shape))
    state = tr.place_train_state(train_state_from_jax(jstate), c, "adamw",
                                 lay)
    a_log = state["params"]["blocks"]["layers"]["mamba"]["A_log"]
    H = c.ssm.n_heads // shape[1]
    assert [tuple(b.shape) for b in a_log.blocks] == \
        [(c.n_layers, H)] * lay.n
    params, opt = state["params"], state["opt"]
    step = tr.make_sharded_train_step(c, tt, lay)
    params, opt, m = step(params, opt, _tbatch(batch), 0,
                          [_draw(key, c.d_model)])
    _replicas_equal(params)
    _replicas_equal(opt)
    for k in m:
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-4,
                                   atol=1e-7, err_msg=k)
    got = train_state_to_jax({"params": lm_from_mesh(params),
                              "opt": shd.gather_tree(opt), "step": 1})
    for (k, a), (_, b) in zip(_paths(got["params"]), _paths(_np(jp))):
        assert _rel(a, b) <= LEAF_RTOL, k


@pytest.mark.parametrize("shape", MESHES)
def test_mamba_block_on_a_mesh_matches_one_device(shape):
    """``mamba_forward_sharded`` (and its final states, one block of
    heads a shard) against ``mamba_forward`` on one device, and
    ``mamba_decode_sharded`` against ``mamba_decode`` from them."""
    _, c = _cfgs("mamba2-780m")
    p = lm.init_lm(c, torch.Generator().manual_seed(2))
    pm = lm._layers(p["blocks"]["layers"], c.n_layers)[0]["mamba"]
    u = torch.randn(2, 21, c.d_model, generator=torch.Generator()
                    .manual_seed(3))
    lay = shd.ShardLayout(_rules(c, shape))
    with shd.axis_rules(lay.rules):
        axes = lm.param_axes(c)["blocks"]["layers"]["mamba"]
        placed = shd.place_tree(pm, shd.param_sharding(shd.map_axes(
            lambda a: a[1:], axes)))
    ps = shd.local_trees(placed, lay.local)
    want, st = ssm.mamba_forward(pm, c.ssm, u, return_state=True)
    got, sts = ssm.mamba_forward_sharded(lay, ps, c.ssm, [u] * lay.n,
                                         return_state=True)
    H = c.ssm.n_heads // lay.M
    for s, (y, part) in enumerate(zip(got, sts)):
        assert torch.allclose(y, want, rtol=1e-5, atol=1e-5)
        r = lay.rank[s]
        assert torch.allclose(part.ssm, st.ssm[:, r * H:(r + 1) * H],
                              rtol=1e-5, atol=1e-6)
        assert torch.equal(part.conv, st.conv[:, :, r * H:(r + 1) * H])
    x1 = torch.randn(2, 1, c.d_model, generator=torch.Generator()
                     .manual_seed(4))
    want1, _ = ssm.mamba_decode(pm, c.ssm, x1, st)
    got1 = ssm.mamba_decode_sharded(lay, ps, c.ssm, [x1] * lay.n, sts)
    for s, y in enumerate(got1):
        assert torch.allclose(y, want1, rtol=1e-5, atol=1e-5)
        r = lay.rank[s]
        assert torch.allclose(sts[s].ssm, st.ssm[:, r * H:(r + 1) * H],
                              rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", NAMES)
def test_sharded_trainer_trains_and_keeps_replicas(name):
    """``Trainer`` under rules: the family's state laid out (SSM heads
    over 'model'), two steps with the hybrid term, loss finite, the first
    equal to the unsharded ``Trainer``'s, replicas bitwise, and the params
    cross onto the mesh and back bitwise."""
    _, c = _cfgs(name)
    tcfg = tr.TrainCfg(lr=1e-2, warmup=1, total_steps=4, hybrid=True,
                       hybrid_pool=POOL, seed=1)
    data = lambda step: _tbatch(_np(jrandom_batch(  # noqa: E731
        jax.random.PRNGKey(step), c.vocab, B, S)))
    plain = tr.Trainer(c, tcfg, data, device="cpu")
    hp = plain.run(2, log_every=0)
    rules = _rules(c, (2, 2))
    with shd.axis_rules(rules):
        t = tr.Trainer(c, tcfg, data, device="cpu")
    h = t.run(2, log_every=0)
    assert np.all(np.isfinite([x["loss"] for x in h]))
    np.testing.assert_allclose(h[0]["loss"], hp[0]["loss"], rtol=LOSS_RTOL)
    _replicas_equal(t.state["params"])
    _replicas_equal(t.state["opt"])
    p = plain.state["params"]
    back = lm_from_mesh(lm_to_mesh(p, c, rules))
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(back),
                                                 tree_leaves(p)))

