"""The port's logical-axis rules (``distributed/sharding.py``) against the
reference's: ``make_rules``, ``rules_for`` and ``param_pspecs`` for all
ten LM configs on fake 16 x 16 and 2 x 16 x 16 meshes (the reference's
``mesh16`` trick: one device named 256 or 512 times, enough for spec
computation), at the train, decode and batch-1 cases; ``decode_state_specs``
for every family; the axes tree of ``init_lm`` leaf for leaf; and where a
spec puts each shard's block.

The reference's axes trees come from tracing its ``init_lm`` abstractly
(``jax.eval_shape``), so the full configs are compared without drawing
their weights."""
import functools

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import base as jbase  # noqa: E402
from repro.distributed import sharding as jshd  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.launch.mesh import make_test_mesh  # noqa: E402
from repro_torch.models import lm  # noqa: E402

LM_CONFIGS = ("arctic-480b", "gemma2-2b", "kimi-k2-1t-a32b",
              "llava-next-34b", "mamba2-780m", "musicgen-large",
              "nemotron-4-15b", "qwen1.5-0.5b", "qwen3-1.7b", "zamba2-1.2b")
# (batch, kind, fsdp): a train shape, a decode shape, the batch-1 long
# context, an indivisible batch and FSDP
CASES = ((256, "train", False), (128, "decode", False), (1, "decode", False),
         (3, "prefill", False), (256, "train", True))


def _jmesh(multi_pod):
    dev = jax.devices()[0]
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return jax.sharding.Mesh(np.array([dev] * int(np.prod(shape))).reshape(
        shape), axes)


def _mesh(multi_pod):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_test_mesh(shape, axes, devices=["cpu"] * int(np.prod(shape)))


@pytest.fixture(scope="module")
def meshes():
    return {mp: (_jmesh(mp), _mesh(mp)) for mp in (False, True)}


@functools.lru_cache(maxsize=None)
def _jaxes(name, smoke=False):
    """The reference's axes tree of ``init_lm``, traced abstractly
    (``jax.eval_shape``: no weight is drawn, so the full configs too)."""
    cfg = jbase.get_config(name)
    cfg = jbase.smoke_config(cfg) if smoke else cfg
    box = {}

    def init(key):
        params, box["axes"] = jlm.init_lm(cfg, key)
        return params
    jax.eval_shape(init, jax.random.PRNGKey(0))
    return box["axes"]


def _tuples(tree):
    if isinstance(tree, dict):
        return {k: _tuples(v) for k, v in tree.items()}
    return tuple(tree)


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("fsdp,seq_sharded", [(False, False), (True, False),
                                              (False, True)])
def test_make_rules_match_reference(meshes, multi_pod, fsdp, seq_sharded):
    jm, m = meshes[multi_pod]
    want = jshd.make_rules(jm, fsdp=fsdp, seq_sharded=seq_sharded)
    got = shd.make_rules(m, fsdp=fsdp, seq_sharded=seq_sharded)
    assert got.param_rules == want.param_rules
    assert got.act_rules == want.act_rules


@pytest.mark.parametrize("name", LM_CONFIGS)
@pytest.mark.parametrize("multi_pod", [False, True])
def test_rules_for_and_param_pspecs_match_reference(meshes, name, multi_pod):
    jm, m = meshes[multi_pod]
    jcfg, cfg = jbase.get_config(name), base.get_config(name)
    jaxes = _jaxes(name)
    axes = lm.param_axes(cfg)
    for batch, kind, fsdp in CASES:
        want = jshd.rules_for(jm, jcfg, batch=batch, kind=kind, fsdp=fsdp)
        got = shd.rules_for(m, cfg, batch=batch, kind=kind, fsdp=fsdp)
        assert got.param_rules == want.param_rules, (batch, kind, fsdp)
        assert got.act_rules == want.act_rules, (batch, kind, fsdp)
        with jshd.axis_rules(want):
            jspecs = _tuples(jshd.param_pspecs(jaxes))
        with shd.axis_rules(got):
            specs = _tuples(shd.param_pspecs(axes))
        assert specs == jspecs, (batch, kind, fsdp)
        for ax in (("batch", "seq", "embed"), ("batch", "kv_heads", "kv_seq",
                                                 "head_dim")):
            assert tuple(got.spec(ax)) == tuple(want.spec(ax))


@pytest.mark.parametrize("name", LM_CONFIGS)
def test_axes_tree_matches_reference(name):
    assert lm.param_axes(base.get_config(name)) == _jaxes(name)
    cfg = base.smoke_config(base.get_config(name))
    assert lm.param_axes(cfg) == _jaxes(name, smoke=True)
    # the flag-free init still returns the params alone, in the same
    # structure as the axes
    p = lm.init_lm(cfg, None)
    assert sorted(p) == sorted(lm.param_axes(cfg))


@pytest.mark.parametrize("name", LM_CONFIGS)
def test_axes_tree_ignores_the_widths(name):
    cfg = base.get_config(name)
    assert lm.param_axes(cfg) == lm.param_axes(base.smoke_config(cfg))
    shapes = shd.map_axes(len, lm.param_axes(cfg))
    p = lm.init_lm(cfg, None)

    def ndims(t):
        return {k: ndims(v) for k, v in t.items()} if isinstance(t, dict) \
            else t.ndim
    assert ndims(p) == shapes


@pytest.mark.parametrize("name", LM_CONFIGS)
@pytest.mark.parametrize("B,max_len", [(4, 64), (1, 4096)])
def test_decode_state_specs_match_reference(name, B, max_len):
    jcfg, cfg = jbase.get_config(name), base.get_config(name)
    assert (lm.decode_state_specs(cfg, B, max_len)
            == jlm.decode_state_specs(jcfg, B, max_len))
    # one logical name a dim of the state init_decode_state makes
    st = lm.init_decode_state(base.smoke_config(cfg), B, 8, device="meta")
    specs = lm.decode_state_specs(cfg, B, 8)
    assert sorted(st) == sorted(specs)
    assert all(st[k].ndim == len(specs[k]) for k in st)


def test_reference_spot_checks(meshes):
    """The reference's own rule tests, on the port."""
    _, m = meshes[False]
    r = shd.rules_for(m, base.get_config("qwen3-1.7b"), batch=256)
    assert (r.param_rules["heads"], r.param_rules["kv_heads"],
            r.param_rules["kv_in"], r.act_rules["kv_seq"]) == (
        "model", None, "model", "model")
    r = shd.rules_for(m, base.get_config("arctic-480b"), batch=256,
                      fsdp=True)
    assert (r.param_rules["heads"], r.param_rules["q_in"],
            r.param_rules["o_hd"], r.param_rules["embed"],
            r.param_rules["q_hd"]) == (None, "model", "model", "data", "data")
    r = shd.rules_for(m, base.get_config("zamba2-1.2b"), batch=1,
                      kind="decode")
    assert (r.act_rules["batch"], r.act_rules["kv_seq"],
            r.act_rules["seq"]) == (None, "data", "data")
    r = shd.rules_for(m, base.get_config("kimi-k2-1t-a32b"), batch=256,
                      fsdp=True)
    assert r.spec(("experts", "embed", "expert_mlp"), kind="param") == \
        shd.P("model", "data", None)
    assert r.spec(("batch", "seq")) == shd.P("data", None)


def test_context_and_mesh_queries():
    assert shd.current_rules() is None and shd.get_mesh() is None
    assert shd.logical_spec(("batch",)) == shd.P()
    assert shd.mesh_axis_size("model") == 1
    x = torch.arange(6.0)
    assert shd.shard(x, "batch") is x                 # no rules: no-op
    m = make_test_mesh((2, 3), devices=["cpu"] * 6)
    rules = shd.make_rules(m)
    with shd.axis_rules(rules):
        assert shd.current_rules() is rules and shd.get_mesh() is m
        assert shd.mesh_axis_size("model") == 3
        assert shd.mesh_axis_size("pod") == 1
        assert shd.logical_spec(("batch", "mlp")) == shd.P("data", "model")
        y = shd.shard(x, "mlp")                       # a tensor: laid out
        assert isinstance(y, shd.Placed)
        assert [b.tolist() for b in y.blocks[:3]] == [[0, 1], [2, 3],
                                                        [4, 5]]
        z = shd.shard(y, "batch")                     # re-laid over data
        assert [b.tolist() for b in z.blocks] == [[0, 1, 2]] * 3 + \
            [[3, 4, 5]] * 3
        assert torch.equal(z.gather(), x)
    assert shd.current_rules() is None


def test_shard_slices_blocks_and_gather():
    m = make_test_mesh((2, 2, 2), ("pod", "data", "model"),
                       devices=["cpu"] * 8)
    x = torch.arange(8 * 6 * 4.0).reshape(8, 6, 4)
    for spec in [shd.P(("pod", "data"), "model"), shd.P(None, None, "model"),
                 shd.P("data"), shd.P(), shd.P(("data", "pod"), None,
                                              "model")]:
        p = shd.Placed.put(x, shd.NamedSharding(m, spec))
        assert len(p.blocks) == 8
        assert torch.equal(p.gather(), x)
        for b, sl in zip(p.blocks, p.sharding.slices(x.shape)):
            assert torch.equal(b, x[sl])
    # pod-major over ('pod', 'data'): shard (pod 1, data 0) holds rows 4-5
    p = shd.Placed.put(x, shd.NamedSharding(m, shd.P(("pod", "data"))))
    assert torch.equal(p.blocks[4], x[4:6])
    with pytest.raises(ValueError, match="split"):
        shd.shard_slices((3, 4), shd.P("data"), m)
    with pytest.raises(ValueError, match="twice"):
        shd.shard_slices((4, 4), shd.P("data", "data"), m)


@pytest.mark.parametrize("name", ("mamba2-780m", "zamba2-1.2b"))
@pytest.mark.parametrize("shape", [(2, 2), (1, 4)])
@pytest.mark.parametrize("batch,kind,fsdp", [(1, "decode", False),
                                              (4, "train", True)])
def test_smoke_ssm_rules_and_state_layout_match_reference(name, shape, batch,
                                                           kind, fsdp):
    """The SSM and hybrid smoke configs on small meshes, at the batch-1
    decode case and FSDP training: ``rules_for``, every param spec,
    ``decode_state_specs`` under the act rules, and the shape of each
    shard's block of ``lm.init_decode_state_sharded``'s state, against
    the reference's specs and ``NamedSharding``'s shard shapes."""
    jcfg = jbase.smoke_config(jbase.get_config(name))
    cfg = base.smoke_config(base.get_config(name))
    dev = jax.devices()[0]
    jm = jax.sharding.Mesh(np.array([dev] * int(np.prod(shape))).reshape(
        shape), ("data", "model"))
    m = make_test_mesh(shape, devices=["cpu"] * int(np.prod(shape)))
    want = jshd.rules_for(jm, jcfg, batch=batch, kind=kind, fsdp=fsdp)
    got = shd.rules_for(m, cfg, batch=batch, kind=kind, fsdp=fsdp)
    assert got.param_rules == want.param_rules
    assert got.act_rules == want.act_rules
    with jshd.axis_rules(want):
        jspecs = _tuples(jshd.param_pspecs(_jaxes(name, smoke=True)))
    with shd.axis_rules(got):
        assert _tuples(shd.param_pspecs(lm.param_axes(cfg))) == jspecs
    max_len = 32
    jaxes = jlm.decode_state_specs(jcfg, batch, max_len)
    assert lm.decode_state_specs(cfg, batch, max_len) == jaxes
    shardings = lm.decode_state_sharding(cfg, got)
    st = lm.init_decode_state_sharded(shd.ShardLayout(got), cfg, batch,
                                      max_len)
    whole = jlm.init_decode_state(jcfg, batch, max_len)
    for k, ax in jaxes.items():
        jspec = want.spec(ax, kind="act")
        assert tuple(shardings[k].spec) == tuple(jspec), k
        shape_k = jax.sharding.NamedSharding(jm, jspec).shard_shape(
            whole[k].shape)
        assert all(tuple(b.shape) == tuple(shape_k)
                   for b in st[k].blocks), k
    assert tuple(shardings["ssm"].spec)[2] == "model"
