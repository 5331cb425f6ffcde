"""FSDP on the port's mesh: ``rules_for(..., fsdp=True)`` splits the
weights' ``embed`` dims (and ``q_in``/``kv_in`` where the heads divide
'model', ``q_hd``/``kv_hd`` where they do not) over 'data'; each layer
gathers its blocks whole where it runs and its gradient is
reduce-scattered back (``distributed.sharding.fsdp_gather_over``).
Against the reference's unsharded jitted functions, on (data 2, model 2)
logical shards of the CPU.

Cases (smoke configs): qwen1.5-0.5b (qkv bias), qwen3-1.7b (qk-norm),
nemotron-4-15b (layernorm, relu², ungated), arctic-480b (MoE with
``moe_ep``, a dense residual) and a 3-head qwen1.5 whose q heads do not
divide 'model' (q row-parallel, ``q_hd`` over 'data').  Block specs equal
the reference's ``rules.spec`` entry for entry; loss rtol 1e-5, every
gradient and updated leaf within 1e-4 of its leaf's max (the k bias after
an update held to 3 % of the learning rate, as
``test_torch_sharded_lm.py`` holds it); replicas bitwise after a step;
Adafactor with 2 microbatches as ``dryrun.POLICY`` asks; a checkpoint
resharded by ``reshard_state(..., fsdp=True)`` trains on."""
from dataclasses import replace
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import base as jbase  # noqa: E402
from repro.core import swd as jswd  # noqa: E402
from repro.data.tokens import random_batch as jrandom_batch  # noqa: E402
from repro.distributed import sharding as jshd  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.runtime import trainer as jtr  # noqa: E402
from repro_torch.checkpoint.elastic import reshard_state  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
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
K_BIAS, K_BIAS_LR_FRAC = "attn/wk/b", 0.03
SHAPE = (2, 2)
# name: (config, overrides)
CASES = {"qwen1.5": ("qwen1.5-0.5b", {}),
         "qwen3": ("qwen3-1.7b", {}),
         "nemotron": ("nemotron-4-15b", {}),
         "arctic": ("arctic-480b", {}),
         "q_hd-3heads": ("qwen1.5-0.5b", dict(n_heads=3, n_kv_heads=1))}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _cfgs(case):
    name, kw = CASES[case]
    return (replace(jbase.smoke_config(jbase.get_config(name)), **kw),
            replace(base.smoke_config(base.get_config(name)), **kw))


def _mesh(shape=SHAPE):
    return make_test_mesh(shape, devices=["cpu"] * int(np.prod(shape)))


def _rules(c, shape=SHAPE):
    return shd.rules_for(_mesh(shape), c, batch=B, kind="train", fsdp=True)


def _tbatch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _draw(key, d, rows=B):
    kd, kp = jax.random.split(key)
    return (torch.from_numpy(np.array(jswd.random_directions(kd, 50, d))),
            torch.from_numpy(np.array(jswd.sphere_prior_samples(
                kp, rows * (S // POOL), d))))


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    scale = np.abs(want).max()
    return np.abs(got - want).max() / (scale if scale else 1.0)


def _replicas_equal(tree):
    for t in tree_leaves(tree):
        if not isinstance(t, shd.Placed):
            continue
        first = {}
        for b, sl in zip(t.blocks, t.sharding.slices(t.shape)):
            key = tuple((x.start, x.stop) for x in sl)
            assert torch.equal(first.setdefault(key, b), b)


@lru_cache(maxsize=None)
def _jinit(case):
    jc, _ = _cfgs(case)
    box = {}

    def init(k):
        p, box["axes"] = jlm.init_lm(jc, k)
        return p
    return _np(jax.jit(init)(jax.random.PRNGKey(0))), box["axes"]


@pytest.mark.parametrize("case", sorted(CASES))
def test_block_specs_and_shapes_match_reference(case):
    """Each leaf's spec under FSDP rules is the reference's
    ``param_pspecs`` entry for entry, and each shard's block has the
    shape the reference's ``NamedSharding`` gives it."""
    jc, c = _cfgs(case)
    jp, jaxes = _jinit(case)
    dev = jax.devices()[0]
    jmesh = jax.sharding.Mesh(np.array([dev] * 4).reshape(SHAPE),
                              ("data", "model"))
    jrules = jshd.rules_for(jmesh, jc, batch=B, kind="train", fsdp=True)
    rules = _rules(c)
    assert rules.param_rules == jrules.param_rules
    with jshd.axis_rules(jrules):
        jspecs = jshd.param_pspecs(jaxes)
    placed = lm_to_mesh(lm_from_jax(jp), c, rules)
    n_data = 0
    jspecs = jax.tree.leaves(jspecs, is_leaf=lambda x: isinstance(
        x, jax.sharding.PartitionSpec))
    for (k, t), jspec, w in zip(_paths(placed), jspecs,
                                jax.tree.leaves(jp)):
        assert tuple(t.sharding.spec) == tuple(jspec), k
        want = jax.sharding.NamedSharding(
            jmesh, jax.sharding.PartitionSpec(*jspec)).shard_shape(w.shape)
        assert all(tuple(b.shape) == tuple(want) for b in t.blocks), k
        n_data += "data" in shd.spec_axes(t.sharding.spec)
    assert n_data > 0
    if case == "q_hd-3heads":
        assert rules.param_rules["q_hd"] == "data"
        wq = placed["blocks"]["layers"]["attn"]["wq"]["w"]
        assert tuple(wq.sharding.spec) == (None, "model", None, "data")


@lru_cache(maxsize=None)
def _reference_grads(case):
    jc, c = _cfgs(case)
    jp, _ = _jinit(case)
    batch = _np(jrandom_batch(jax.random.PRNGKey(1), c.vocab, B, S))
    key = jax.random.PRNGKey(7)
    jt = jtr.TrainCfg(hybrid=True, hybrid_pool=POOL)
    (jv, jm), jg = jax.jit(jax.value_and_grad(
        jtr.make_loss_fn(jc, jt), has_aux=True))(jp, batch, key)
    return batch, key, float(jv), _np(jm), _np(jg)


@pytest.mark.parametrize("case", sorted(CASES))
def test_fsdp_loss_and_gradients_match_reference(case):
    """``lm_loss`` and the gradient of the hybrid train loss under FSDP
    rules against the reference's unsharded jitted ones, and bitwise
    from run to run."""
    _, c = _cfgs(case)
    jp, _ = _jinit(case)
    batch, key, jv, jm, jg = _reference_grads(case)
    p, tb = lm_from_jax(jp), _tbatch(batch)
    loss_fn = tr.make_loss_fn(c, tr.TrainCfg(hybrid=True, hybrid_pool=POOL))
    draws = _draw(key, c.d_model)
    with shd.axis_rules(_rules(c)):
        runs = [value_and_grad(loss_fn, p, tb, draws) for _ in range(2)]
    (v, m), g = runs[0]
    assert torch.equal(v, runs[1][0][0])
    assert all(torch.equal(a, b) for a, b in zip(g, runs[1][1]))
    np.testing.assert_allclose(float(v), jv, rtol=LOSS_RTOL)
    for k in m:
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=LOSS_RTOL,
                                   atol=1e-7, err_msg=k)
    for (k, _), got, want in zip(_paths(p), g, jax.tree.leaves(jg)):
        assert _rel(got, want) <= LEAF_RTOL, k


@pytest.mark.parametrize("case,optimizer,microbatches", [
    ("qwen3", "adafactor", 2), ("nemotron", "adamw", 2),
    ("q_hd-3heads", "adafactor", 1)])
def test_fsdp_train_step_matches_reference(case, optimizer, microbatches):
    """One ``make_sharded_train_step`` under FSDP rules from the
    reference's state against its jitted step (``dryrun.POLICY``'s
    optimizer and microbatches): metrics, every updated leaf; replicas
    bitwise."""
    jc, c = _cfgs(case)
    kw = dict(optimizer=optimizer, lr=LR, warmup=1, total_steps=10,
              hybrid=True, hybrid_pool=POOL, microbatches=microbatches)
    jt, tt = jtr.TrainCfg(**kw), tr.TrainCfg(**kw)
    jstate = _np(jax.jit(lambda k: jtr.init_train_state(jc, jt, k)[0])(
        jax.random.PRNGKey(4)))
    batch = _np(jrandom_batch(jax.random.PRNGKey(10), c.vocab, B, S))
    key = jax.random.PRNGKey(20)
    jp, jo, jm = jax.jit(jtr.make_train_step(jc, jt))(
        jstate["params"], jstate["opt"], batch, jnp.int32(0), key)
    keys = list(jax.random.split(key, microbatches)) if microbatches > 1 \
        else [key]
    lay = shd.ShardLayout(_rules(c))
    state = tr.place_train_state(train_state_from_jax(jstate, optimizer), c,
                                 optimizer, lay)
    params, opt = state["params"], state["opt"]
    step = tr.make_sharded_train_step(c, tt, lay)
    params, opt, m = step(params, opt, _tbatch(batch), 0,
                          [_draw(k, c.d_model, B // microbatches)
                           for k in keys])
    _replicas_equal(params)
    _replicas_equal(opt)
    for k in m:
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-4,
                                   atol=1e-7, err_msg=k)
    got = train_state_to_jax({"params": lm_from_mesh(params),
                              "opt": shd.gather_tree(opt), "step": 1},
                             optimizer)
    for (k, a), (_, b) in zip(_paths(got["params"]), _paths(_np(jp))):
        if k.endswith(K_BIAS) and optimizer == "adamw":
            assert np.abs(np.asarray(a) - b).max() <= K_BIAS_LR_FRAC * LR
        else:
            assert _rel(a, b) <= LEAF_RTOL, k


def test_fsdp_moe_step_matches_the_step_without_fsdp():
    """arctic under ``dryrun.POLICY`` (Adafactor, 2 microbatches): each
    microbatch's 32 tokens a shard overflow ``moe_ep``'s capacity, which
    drops copies as the reference's dispatch does on a mesh (its
    unsharded ``moe_reference`` drops none), so the FSDP step is held
    against the same mesh's step without FSDP, where only the gather
    differs: metrics rtol 1e-5, every updated leaf 1e-4 of its max,
    replicas bitwise."""
    _, c = _cfgs("arctic")
    tt = tr.TrainCfg(optimizer="adafactor", lr=LR, warmup=1, total_steps=10,
                     hybrid=True, hybrid_pool=POOL, microbatches=2)
    batch = _tbatch(_np(jrandom_batch(jax.random.PRNGKey(10), c.vocab, B,
                                      S)))
    keys = [_draw(k, c.d_model, B // 2)
            for k in jax.random.split(jax.random.PRNGKey(20), 2)]
    state = tr.init_train_state(c, tt, torch.Generator().manual_seed(4))
    out = []
    for fsdp in (True, False):
        rules = shd.rules_for(_mesh(), c, batch=B, kind="train", fsdp=fsdp)
        lay = shd.ShardLayout(rules)
        st = tr.place_train_state(state, c, "adafactor", lay)
        params, opt, m = tr.make_sharded_train_step(c, tt, lay)(
            st["params"], st["opt"], batch, 0, keys)
        _replicas_equal(params)
        _replicas_equal(opt)
        out.append((m, lm_from_mesh(params)))
    (m1, p1), (m0, p0) = out
    for k in m0:
        np.testing.assert_allclose(float(m1[k]), float(m0[k]),
                                   rtol=LOSS_RTOL, atol=1e-7, err_msg=k)
    for (k, a), (_, b) in zip(_paths(p1), _paths(p0)):
        assert _rel(a, b) <= LEAF_RTOL, k


def test_fsdp_checkpoint_reshards_and_trains_on(tmp_path):
    """A (2, 2) FSDP ``Trainer``'s checkpoint restored whole, laid onto
    (1, 2) by ``reshard_state(..., fsdp=True)`` (bitwise what was saved,
    embed dims over 'data'), taken by a trainer under FSDP rules there
    (``Trainer.load_state``) and stepped once: the step equals the
    unsharded ``Trainer``'s from the same checkpoint."""
    _, c = _cfgs("qwen3")
    tcfg = tr.TrainCfg(lr=1e-3, warmup=1, total_steps=8, hybrid=True,
                       hybrid_pool=POOL)
    data = lambda step: _tbatch(_np(jrandom_batch(  # noqa: E731
        jax.random.PRNGKey(step), c.vocab, B, S)))
    with shd.axis_rules(_rules(c)):
        t = tr.Trainer(c, tcfg, data, device="cpu", ckpt_dir=str(tmp_path),
                       ckpt_every=2, async_ckpt=False)
    wq = t.state["params"]["blocks"]["layers"]["attn"]["wq"]["w"]
    assert tuple(wq.sharding.spec) == (None, "data", "model", None)
    t.run(2, log_every=0)
    _replicas_equal(t.state)
    plain = tr.Trainer(c, tcfg, data, device="cpu")
    restored, step = CheckpointManager(str(tmp_path)).restore_latest(
        plain.state)
    assert step == 2
    mesh2 = _mesh((1, 2))
    axes = lm.param_axes(c)
    state = {"params": reshard_state(restored["params"], axes, mesh2,
                                     fsdp=True),
             "opt": {"m": reshard_state(restored["opt"]["m"], axes, mesh2,
                                        fsdp=True),
                     "v": reshard_state(restored["opt"]["v"], axes, mesh2,
                                        fsdp=True),
                     "step": restored["opt"]["step"]},
             "step": restored["step"]}
    emb = state["params"]["embed"]["table"]
    assert tuple(emb.sharding.spec) == ("model", "data")
    for a, b in zip(tree_leaves(shd.gather_tree(state)),
                    tree_leaves(shd.gather_tree(t.state))):
        assert torch.equal(a, b)
    with shd.axis_rules(_rules(c, (1, 2))):
        t2 = tr.Trainer(c, tcfg, data, device="cpu")
    t2.load_state(state)
    assert t2.step == 2
    m2 = t2.run(1, log_every=0)[-1]
    plain.state, plain._step = restored, 2
    m1 = plain.run(1, log_every=0)[-1]
    np.testing.assert_allclose(m2["loss"], m1["loss"], rtol=LOSS_RTOL)
    for (k, a), (_, b) in zip(_paths(shd.gather_tree(t2.state["params"])),
                              _paths(plain.state["params"])):
        assert (a - b).abs().max() <= 1e-4 * b.abs().max(), k


@pytest.mark.parametrize("name", ["qwen3-1.7b", "nemotron-4-15b",
                                  "zamba2-1.2b"])
def test_full_width_fsdp_blocks_match_reference(name):
    """At the published widths on (2, 2) (no weight drawn: the
    reference's shapes from ``jax.eval_shape``, the port's on the
    ``meta`` device): every param's FSDP spec and each shard's block
    shape equal the reference's."""
    jc, c = jbase.get_config(name), base.get_config(name)
    box = {}

    def init(k):
        p, box["axes"] = jlm.init_lm(jc, k)
        return p
    shapes = jax.eval_shape(init, jax.random.PRNGKey(0))
    dev = jax.devices()[0]
    jmesh = jax.sharding.Mesh(np.array([dev] * 4).reshape(SHAPE),
                              ("data", "model"))
    jrules = jshd.rules_for(jmesh, jc, batch=B, kind="train", fsdp=True)
    with jshd.axis_rules(jrules):
        jspecs = jax.tree.leaves(jshd.param_pspecs(box["axes"]),
                                 is_leaf=lambda x: isinstance(
                                     x, jax.sharding.PartitionSpec))
    lay = shd.ShardLayout(_rules(c))
    meta = lm.init_lm(c, None)
    for (k, sh), (_, p), jspec, js in zip(
            _paths(lm.param_shardings(c, lay)), _paths(meta), jspecs,
            jax.tree.leaves(shapes)):
        assert tuple(sh.spec) == tuple(jspec), k
        want = jax.sharding.NamedSharding(jmesh, jspec).shard_shape(js.shape)
        got = {tuple(s.stop - s.start for s in sl)
               for sl in sh.slices(p.shape)}
        assert got == {tuple(want)}, k
