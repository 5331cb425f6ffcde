"""The port's LM on a mesh (``lm.forward``/``lm_loss`` under
``axis_rules``, ``runtime/trainer.make_sharded_train_step``, ``Trainer``
under rules) against the reference's unsharded jitted step, and against
the port's own unsharded step.  Meshes are logical shards of the CPU.

Weights and optimizer states are the reference's (``weights.py``), the
batches its ``random_batch``, the hybrid term's SW draws handed across
as ``(dirs, prior)`` split from the reference's keys.  Cases: the smoke
configs of qwen1.5-0.5b (qkv bias) and qwen3-1.7b (qk-norm) on (data 2,
model 2): column-parallel q, k, v; a 3-head, 1-kv-head config on (1, 2):
every projection row-parallel, the attention whole on each shard, ``wo``
over head_dim; 4 heads over 2 kv heads on (1, 4): q column-parallel, k
and v row-parallel, each shard's q head meeting its own kv head.
Tolerances: losses rtol 1e-5, every gradient and updated leaf within
1e-4 of its leaf's max, but the k bias after an update (see
``test_torch_trainer.K_BIAS``: its gradient is a cancellation that
AdamW's division amplifies), held to 3 % of the learning rate.  Every
replica of a block is bitwise equal to the others after a step."""
from dataclasses import replace

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
from repro_torch.optim.sgd import tree_leaves, value_and_grad  # noqa: E402
from repro_torch.runtime import trainer as tr  # noqa: E402
from repro_torch.weights import (lm_from_jax, lm_from_mesh,  # noqa: E402
                                 lm_to_mesh, train_state_from_jax,
                                 train_state_to_jax)

LOSS_RTOL, LEAF_RTOL = 1e-5, 1e-4
B, S, POOL, LR = 4, 32, 8, 1e-3
K_BIAS, K_BIAS_LR_FRAC = "blocks/layers/attn/wk/b", 0.03
# name: (config, overrides, mesh)
CASES = {"qwen1.5-2x2": ("qwen1.5-0.5b", {}, (2, 2)),
         "qwen3-2x2": ("qwen3-1.7b", {}, (2, 2)),
         "rowparallel-1x2": ("qwen1.5-0.5b", dict(n_heads=3, n_kv_heads=1),
                             (1, 2)),
         "kvrow-1x4": ("qwen3-1.7b", dict(n_kv_heads=2), (1, 4))}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _cfgs(case):
    name, kw, shape = CASES[case]
    jc = replace(jbase.smoke_config(jbase.get_config(name)), **kw)
    c = replace(base.smoke_config(base.get_config(name)), **kw)
    return jc, c, shape


def _rules(c, shape, batch=B):
    mesh = make_test_mesh(shape, devices=["cpu"] * int(np.prod(shape)))
    return shd.rules_for(mesh, c, batch=batch, kind="train")


def _jbatch(step, vocab):
    return _np(jrandom_batch(jax.random.PRNGKey(step), vocab, B, S))


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


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_loss_and_gradients_match_reference(case):
    """Forward logits, ``lm_loss`` and the gradient of the hybrid train
    loss on the mesh against the reference's unsharded jitted ones."""
    jc, c, shape = _cfgs(case)
    jp = _np(jlm.init_lm(jc, jax.random.PRNGKey(0))[0])
    batch, key = _jbatch(1, c.vocab), jax.random.PRNGKey(7)
    jh, _ = jax.jit(lambda p, t: jlm.forward(jc, p, tokens=t))(
        jp, batch["tokens"])
    jlogits = jlm.logits_from_hidden(jc, jp, jh)
    jt = jtr.TrainCfg(hybrid=True, hybrid_pool=POOL)
    (jv, jm), jg = jax.jit(jax.value_and_grad(
        jtr.make_loss_fn(jc, jt), has_aux=True))(jp, batch, key)
    p, tb = lm_from_jax(jp), _tbatch(batch)
    loss_fn = tr.make_loss_fn(c, tr.TrainCfg(hybrid=True, hybrid_pool=POOL))
    with shd.axis_rules(_rules(c, shape)):
        h, _ = lm.forward(c, p, tokens=tb["tokens"])
        loss, _ = lm.lm_loss(c, p, tb)
        (v, m), g = value_and_grad(loss_fn, p, tb, _draw(key, c.d_model))
    logits = lm.logits_from_hidden(c, p, h)
    assert _rel(logits.detach(), jlogits) <= LEAF_RTOL
    np.testing.assert_allclose(float(loss), float(jv) - float(
        jt.hybrid_lam_sw * jm["swd"] + jt.hybrid_lam_lap * jm["lap"]),
        rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(v), float(jv), rtol=LOSS_RTOL)
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


@pytest.mark.parametrize("case,optimizer,hybrid", [
    ("qwen1.5-2x2", "adamw", True), ("rowparallel-1x2", "adafactor", True),
    ("kvrow-1x4", "adamw", False)])
def test_train_step_matches_reference(case, optimizer, hybrid):
    """One ``make_sharded_train_step`` from the reference's state against
    its jitted step: metrics, every updated leaf; replicas bitwise."""
    jc, c, shape = _cfgs(case)
    kw = dict(optimizer=optimizer, lr=LR, warmup=1, total_steps=10,
              hybrid=hybrid, hybrid_pool=POOL)
    jt, tt = jtr.TrainCfg(**kw), tr.TrainCfg(**kw)
    jstate = _np(jtr.init_train_state(jc, jt, jax.random.PRNGKey(4))[0])
    batch, key = _jbatch(10, c.vocab), jax.random.PRNGKey(20)
    jp, jo, jm = jax.jit(jtr.make_train_step(jc, jt))(
        jstate["params"], jstate["opt"], batch, jnp.int32(0), key)
    lay = shd.ShardLayout(_rules(c, shape))
    state = tr.place_train_state(train_state_from_jax(jstate, optimizer), c,
                                 optimizer, lay)
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
                              "opt": shd.gather_tree(opt), "step": 1},
                             optimizer)
    for (k, a), (_, b) in zip(_paths(got["params"]), _paths(_np(jp))):
        if k.endswith(K_BIAS):
            assert np.abs(np.asarray(a) - b).max() <= K_BIAS_LR_FRAC * LR
        else:
            assert _rel(a, b) <= LEAF_RTOL, k


@pytest.mark.parametrize("name,shape,kw", [
    ("qwen1.5-0.5b", (2, 2), {}),
    ("qwen3-1.7b", (1, 4), dict(n_kv_heads=2)),
    ("gemma2-2b", (2, 2), {}),            # soft-caps, windows, tied vocab
    ("kimi-k2-1t-a32b", (2, 2), {}),      # moe_ep, a dense first layer
    ("qwen1.5-0.5b", (4, 1), {}),         # data-parallel only
    ("qwen1.5-0.5b", (2, 2), dict(n_heads=2, n_kv_heads=2))])
def test_sharded_matches_unsharded_port(name, shape, kw):
    """The loss and every gradient on the mesh against the port's
    unsharded step (hybrid on, a generator's draws), and bitwise from run
    to run."""
    c = replace(base.smoke_config(base.get_config(name)), **kw)
    p = lm.init_lm(c, torch.Generator().manual_seed(3))
    tb = _tbatch(_jbatch(5, c.vocab))
    loss_fn = tr.make_loss_fn(c, tr.TrainCfg(hybrid=True, hybrid_pool=POOL))
    draws = _draw(jax.random.PRNGKey(9), c.d_model)
    (v0, m0), g0 = value_and_grad(loss_fn, p, tb, draws)
    outs = []
    with shd.axis_rules(_rules(c, shape)):
        for _ in range(2):
            outs.append(value_and_grad(loss_fn, p, tb, draws))
    (v1, m1), g1 = outs[0]
    assert torch.equal(v1, outs[1][0][0])
    assert all(torch.equal(a, b) for a, b in zip(g1, outs[1][1]))
    np.testing.assert_allclose(float(v1), float(v0), rtol=LOSS_RTOL)
    for a, b in zip(g1, g0):
        assert _rel(a, b) <= LEAF_RTOL


def test_trainer_on_a_mesh_trains_and_checkpoints(tmp_path):
    """``Trainer`` built under rules keeps ``Placed`` state, trains (loss
    finite and falling over 4 steps with the hybrid term), keeps replicas
    bitwise equal, tracks the unsharded ``Trainer`` and saves full arrays
    that restore onto its layout."""
    c = base.smoke_config(base.get_config("qwen3-1.7b"))
    tcfg = tr.TrainCfg(lr=1e-2, warmup=1, total_steps=8, hybrid=True,
                       hybrid_pool=POOL, seed=1)
    data = lambda step: _tbatch(_jbatch(step, c.vocab))  # noqa: E731
    plain = tr.Trainer(c, tcfg, data, device="cpu")
    hp = plain.run(4, log_every=0)
    with shd.axis_rules(_rules(c, (2, 2))):
        t = tr.Trainer(c, tcfg, data, device="cpu",
                       ckpt_dir=str(tmp_path), ckpt_every=4,
                       async_ckpt=False)
    assert t.layout is not None and t.layout.n == 4
    h = t.run(4, log_every=0)
    losses = [x["loss"] for x in h]
    assert np.all(np.isfinite(losses)) and losses[-1] < losses[0]
    np.testing.assert_allclose(losses[0], hp[0]["loss"], rtol=LOSS_RTOL)
    _replicas_equal(t.state["params"])
    for a, b in zip(tree_leaves(lm_from_mesh(t.state["params"])),
                    tree_leaves(plain.state["params"])):
        assert _rel(a, b) <= 1e-3            # four AdamW steps apart
    from repro_torch.checkpoint.manager import CheckpointManager
    restored, step = CheckpointManager(str(tmp_path)).restore_latest(t.state)
    assert step == 4
    for (k, a), (_, b) in zip(_paths(restored), _paths(t.state)):
        if isinstance(b, shd.Placed):
            assert tuple(a.sharding.spec) == tuple(b.sharding.spec)
            assert all(torch.equal(x, y) for x, y in zip(a.blocks, b.blocks))


def test_weights_cross_onto_a_mesh_and_back():
    c = base.smoke_config(base.get_config("qwen1.5-0.5b"))
    jp = _np(jlm.init_lm(replace(jbase.smoke_config(
        jbase.get_config("qwen1.5-0.5b"))), jax.random.PRNGKey(0))[0])
    p = lm_from_jax(jp)
    placed = lm_to_mesh(p, c, _rules(c, (2, 2)))
    wq = placed["blocks"]["layers"]["attn"]["wq"]["w"]
    assert tuple(wq.sharding.spec) == (None, None, "model", None)
    assert wq.blocks[0].shape == (c.n_layers, c.d_model, 2, c.head_dim)
    back = lm_from_mesh(placed)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(back),
                                                 tree_leaves(p)))


def test_what_a_mesh_does_not_run_yet_raises():
    """The calls that raised on a mesh before the SSM and hybrid families,
    FSDP and sharded prefill and decode were ported now run and give the
    unsharded port's numbers; what a mesh still refuses is a decode state
    that is not laid out on it."""
    tok = torch.randint(0, 256, (4, 8), generator=torch.Generator()
                        .manual_seed(1))
    for name in ("mamba2-780m", "zamba2-1.2b"):
        c = base.smoke_config(base.get_config(name))
        p = lm.init_lm(c, torch.Generator().manual_seed(0))
        want, _ = lm.forward(c, p, tokens=tok)
        with shd.axis_rules(_rules(c, (1, 2))):
            got, _ = lm.forward(c, p, tokens=tok)
        assert _rel(got, want) <= LEAF_RTOL
    c = base.smoke_config(base.get_config("qwen1.5-0.5b"))
    p = lm.init_lm(c, torch.Generator().manual_seed(0))
    mesh = make_test_mesh((2, 2), devices=["cpu"] * 4)
    want, _ = lm.forward(c, p, tokens=tok)
    with shd.axis_rules(shd.rules_for(mesh, c, batch=4, fsdp=True)):
        got, _ = lm.forward(c, p, tokens=tok)
    assert _rel(got, want) <= LEAF_RTOL
    with torch.no_grad():
        st0, l0 = lm.prefill(c, p, tokens=tok)
        d0, _ = lm.decode_step(c, p, st0, tok[:, 0])
        with shd.axis_rules(_rules(c, (2, 2))):
            st, l1 = lm.prefill(c, p, tokens=tok)
            d1, _ = lm.decode_step(c, p, st, tok[:, 0])
            with pytest.raises(TypeError, match="laid out"):
                lm.decode_step(c, p, lm.init_decode_state(c, 4, 8),
                               tok[:, 0])
    assert _rel(l1, l0) <= LEAF_RTOL and _rel(d1, d0) <= LEAF_RTOL
