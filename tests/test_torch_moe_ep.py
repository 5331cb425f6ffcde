"""The port's expert-parallel MoE (``models/moe.py``: ``moe_ep``,
``_local_moe``, ``_local_moe_replicated``, ``apply_moe``'s dispatch)
against the reference's ``moe_ep``, which runs under ``shard_map`` on
forced host devices in one subprocess; the port runs the same meshes as
logical shards of the CPU.  Weights and inputs are the reference's.

Cases: (2, 4) at cap_factor 8.0 (nothing drops; the reference's own
test), (1, 4) at 0.5 (copies drop: equal outputs mean the same copies
dropped), (2, 2) at the default 1.25, and S = 3 on (1, 4), which takes
the replicated path.  y within 2e-4 (the reference's bar), aux rtol
1e-4."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import MoECfg  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.launch.mesh import make_test_mesh  # noqa: E402
from repro_torch.models import moe as M  # noqa: E402

Y_ATOL, AUX_RTOL = 2e-4, 1e-4
# name: (mesh, n_experts, cap_factor, x shape)
CASES = {"nodrop": ((2, 4), 8, 8.0, (4, 8, 8)),
         "drops": ((1, 4), 4, 0.5, (2, 16, 8)),
         "default": ((2, 2), 4, 1.25, (4, 16, 8)),
         "replicated": ((1, 4), 8, 1.25, (2, 3, 8))}

REFERENCE = """
import jax, jax.numpy as jnp, numpy as np
from repro.configs.base import MoECfg
from repro.launch.mesh import make_test_mesh
from repro.distributed import sharding as shd
from repro.models import moe as M
cases = %r
out = {}
stub = type('C', (), {'n_heads': 0, 'n_kv_heads': 0, 'head_dim': 0,
                      'ssm': None})()
for i, (name, (shape, E, cap, xs)) in enumerate(sorted(cases.items())):
    cfg = MoECfg(n_experts=E, top_k=2, d_ff_expert=16, cap_factor=cap)
    p, _ = M.init_moe(jax.random.PRNGKey(i), cfg, 8)
    x = jax.random.normal(jax.random.PRNGKey(100 + i), xs)
    mesh = make_test_mesh(shape, ('data', 'model'))
    rules = shd.rules_for(mesh, stub, batch=xs[0], kind='train')
    with shd.axis_rules(rules), mesh:
        y, aux = jax.jit(lambda p, x: M.moe_ep(p, cfg, x,
                                               cap_factor=cap))(p, x)
    ref, aux_ref = M.moe_reference(p, cfg, x)
    for k, v in (('router', p['router']['w']), ('w_up', p['w_up']),
                 ('w_gate', p['w_gate']), ('w_down', p['w_down']),
                 ('x', x), ('y', y), ('aux', aux), ('ref', ref)):
        out[name + '/' + k] = np.asarray(v)
np.savez(%r, **out)
print('saved')
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    from conftest import run_python
    path = str(tmp_path_factory.mktemp("moe_ep") / "ref.npz")
    run_python(REFERENCE % (CASES, path), devices=8)
    with np.load(path) as data:
        return {k: torch.from_numpy(data[k]) for k in data.files}


def _moe(ref, name):
    p = {"router": {"w": ref[name + "/router"]},
         "w_up": ref[name + "/w_up"], "w_gate": ref[name + "/w_gate"],
         "w_down": ref[name + "/w_down"]}
    return p, ref[name + "/x"]


def _rules(shape, batch):
    mesh = make_test_mesh(shape, devices=["cpu"] * int(np.prod(shape)))
    stub = type("C", (), {"n_heads": 0, "n_kv_heads": 0, "head_dim": 0})()
    return shd.rules_for(mesh, stub, batch=batch, kind="train")


@pytest.mark.parametrize("name", sorted(CASES))
def test_moe_ep_matches_reference_moe_ep(reference, name):
    shape, E, cap, xs = CASES[name]
    cfg = MoECfg(n_experts=E, top_k=2, d_ff_expert=16, cap_factor=cap)
    p, x = _moe(reference, name)
    with shd.axis_rules(_rules(shape, xs[0])):
        y, aux = M.moe_ep(p, cfg, x, cap_factor=cap)
    err = (y - reference[name + "/y"]).abs().max().item()
    assert err <= Y_ATOL, err
    np.testing.assert_allclose(aux.item(), reference[name + "/aux"].item(),
                               rtol=AUX_RTOL)
    if name in ("nodrop", "replicated"):       # nothing drops: the oracle
        assert (y - reference[name + "/ref"]).abs().max().item() <= Y_ATOL


def test_capacity_drops_are_counted_and_change_the_output(reference):
    shape, E, cap, xs = CASES["drops"]
    cfg = MoECfg(n_experts=E, top_k=2, d_ff_expert=16, cap_factor=cap)
    p, x = _moe(reference, "drops")
    rules = _rules(shape, xs[0])
    lay = shd.ShardLayout(rules)
    with shd.axis_rules(rules):
        placed = shd.place_tree(p, shd.param_sharding(M._moe_axes(cfg)))
        ps = shd.local_trees(placed, lay.local)
        for c, want_drops in ((cap, True), (8.0, False)):
            ys, aux, dropped = M.moe_ep_sharded(
                lay, ps, cfg, lay.batch_blocks(x), cap_factor=c,
                with_drops=True)
            assert (sum(int(d) for d in dropped) > 0) == want_drops
    # the reference's output differs from the oracle where copies drop
    assert (reference["drops/y"] - reference["drops/ref"]).abs().max() > 1e-3


def test_moe_ep_gradient_matches_reference_path():
    """No copy drops at cap 8.0: the gradient through the dispatch, the
    all_to_alls and the combine equals ``moe_reference``'s."""
    cfg = MoECfg(n_experts=8, top_k=2, d_ff_expert=16)
    g = torch.Generator().manual_seed(0)
    p = M.init_moe(g, cfg, 8)
    x = torch.randn(4, 8, 8, generator=g)
    leaves = [p["router"]["w"], p["w_up"], p["w_gate"], p["w_down"]]

    def grads(fn):
        ls = [t.clone().requires_grad_() for t in leaves]
        q = {"router": {"w": ls[0]}, "w_up": ls[1], "w_gate": ls[2],
             "w_down": ls[3]}
        xx = x.clone().requires_grad_()
        y, aux = fn(q, xx)
        return torch.autograd.grad((y * y).sum() + 0.01 * aux, ls + [xx])
    want = grads(lambda q, xx: M.moe_reference(q, cfg, xx))
    with shd.axis_rules(_rules((2, 4), 4)):
        got = grads(lambda q, xx: M.moe_ep(q, cfg, xx, cap_factor=8.0))
    for a, b in zip(got, want):
        assert (a - b).abs().max() <= 1e-5 * b.abs().max()


def test_apply_moe_dispatch_and_determinism():
    cfg = MoECfg(n_experts=4, top_k=2, d_ff_expert=16)
    g = torch.Generator().manual_seed(1)
    p = M.init_moe(g, cfg, 8)
    x = torch.randn(2, 8, 8, generator=g)
    ref = M.moe_reference(p, cfg, x)
    assert all(torch.equal(a, b) for a, b in zip(M.apply_moe(p, cfg, x), ref))
    with shd.axis_rules(_rules((1, 4), 2)):
        ep = M.apply_moe(p, cfg, x)
        again = M.moe_ep(p, cfg, x)
        forced = M.apply_moe(p, cfg, x, force_reference=True)
    assert all(torch.equal(a, b) for a, b in zip(ep, again))
    assert all(torch.equal(a, b) for a, b in zip(forced, ref))
    with shd.axis_rules(_rules((4, 1), 4)):     # model 1: the reference
        assert all(torch.equal(a, b)
                   for a, b in zip(M.apply_moe(p, cfg, x), ref))
    lay = shd.ShardLayout(_rules((1, 4), 2))
    with pytest.raises(ValueError, match="divide"):
        M.moe_ep_sharded(lay, [None] * 4, MoECfg(n_experts=6, top_k=2,
                                                 d_ff_expert=4),
                         lay.batch_blocks(x))


def test_collectives_all_to_all_all_gather_axis_index():
    xs = [torch.arange(4.0).reshape(4, 1) + 10 * i for i in range(4)]
    out = shd.all_to_all(xs, 0, 0)
    for j, o in enumerate(out):
        assert o[:, 0].tolist() == [10 * i + j for i in range(4)]
    back = shd.all_to_all(out, 0, 0)
    assert all(torch.equal(a, b) for a, b in zip(back, xs))
    gathered = shd.all_gather(xs, 0, tiled=True)
    assert all(torch.equal(g, torch.cat(xs)) for g in gathered)
    assert shd.all_gather(xs)[0].shape == (4, 4, 1)
    assert list(shd.axis_index(xs)) == [0, 1, 2, 3]
    one = [torch.ones(3)]
    assert shd.all_to_all(one, 0, 0)[0] is one[0]
    assert shd.all_gather(one, 0, tiled=True)[0] is one[0]
    # autograd reaches every shard's input
    ls = [x.clone().requires_grad_() for x in xs]
    sum(o.sum() * (j + 1) for j, o in enumerate(shd.all_to_all(ls, 0, 0))
        ).backward()
    assert ls[0].grad[:, 0].tolist() == [1.0, 2.0, 3.0, 4.0]
