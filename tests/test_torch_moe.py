"""The port's Mixture-of-Experts layer (``models/moe.py``) against the
reference's ``repro.models.moe``.

Inputs come from numpy seeds; parameters are the reference's
``init_moe`` converted with ``lm_from_jax``.  Tolerance rtol 1e-5 / atol
1e-5, as in ``test_torch_lm.py``; the router's choices exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import MoECfg as JMoECfg  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch.configs.base import MoECfg  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.weights import lm_from_jax, lm_to_jax  # noqa: E402

RTOL = ATOL = 1e-5
D = 24
# the smoke configs' MoE (4 experts of 32, top 2), gated SwiGLU and a
# plain squared-ReLU expert
CFGS = {"gated": dict(n_experts=4, top_k=2, d_ff_expert=32),
        "plain": dict(n_experts=6, top_k=3, d_ff_expert=16, gated=False,
                      act="relu2")}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol)


def _params(kind, seed=0):
    jc, c = JMoECfg(**CFGS[kind]), MoECfg(**CFGS[kind])
    jp = jax.tree.map(np.asarray, jmoe.init_moe(jax.random.PRNGKey(seed), jc,
                                                D)[0])
    return jp, lm_from_jax(jp), c, jc


@pytest.mark.parametrize("kind", sorted(CFGS))
def test_init_moe_shapes(kind):
    jp, _, c, _ = _params(kind)
    mine = moe.init_moe(torch.Generator().manual_seed(0), c, D)
    assert jax.tree.map(np.shape, lm_to_jax(mine)) == jax.tree.map(
        np.shape, jp)
    meta = moe.init_moe(None, c, D)
    assert all(t.is_meta for t in (meta["w_up"], meta["w_down"],
                                   meta["router"]["w"]))
    w = mine["w_up"]
    assert w.abs().max() <= 2.0 / D ** 0.5 + 1e-6


@pytest.mark.parametrize("kind", sorted(CFGS))
def test_router(kind):
    jp, p, c, jc = _params(kind, 1)
    x = np.random.default_rng(1).normal(size=(40, D)).astype(np.float32)
    got = moe._router(p, c, _t(x))
    want = jmoe._router(jp, jc, jnp.asarray(x))
    _close(got[0], want[0])
    assert np.array_equal(got[1].numpy(), np.asarray(want[1]))
    _close(got[2], want[2])


def test_router_ties_break_to_the_lower_index():
    """Tied probabilities: ``jax.lax.top_k`` takes the lower index first,
    and so must the port (all experts tied; pairs of tied experts in
    either order around a larger one)."""
    jp, _, c, jc = _params("plain", 2)
    rng = np.random.default_rng(2)
    w = rng.normal(size=(D, 6)).astype(np.float32)
    w[:, 4] = w[:, 1]                      # experts 1 and 4 always tie
    w[:, 5] = w[:, 2]                      # and 2 and 5
    x = rng.normal(size=(64, D)).astype(np.float32)
    for router in (np.zeros((D, 6), np.float32), w):
        jp["router"]["w"] = router
        got = moe._router(lm_from_jax(jp), c, _t(x))
        want = jmoe._router(jp, jc, jnp.asarray(x))
        assert np.array_equal(got[1].numpy(), np.asarray(want[1]))
        _close(got[0], want[0])
        if not router.any():
            assert (got[1] == torch.tensor([0, 1, 2])).all()
    vals, idx = moe._top_k(torch.tensor([[1.0, 3.0, 3.0, 0.0, 3.0]]), 2)
    assert idx.tolist() == [[1, 2]] and vals.tolist() == [[3.0, 3.0]]


def test_aux_loss():
    _, _, c, jc = _params("plain")
    rng = np.random.default_rng(3)
    probs = rng.dirichlet(np.ones(6), size=50).astype(np.float32)
    top_e = np.argsort(-probs, axis=1)[:, :3].astype(np.int32)
    _close(moe._aux_loss(c, _t(probs), _t(top_e).long()),
           jmoe._aux_loss(jc, jnp.asarray(probs), jnp.asarray(top_e)))


@pytest.mark.parametrize("kind", sorted(CFGS))
def test_moe_reference(kind):
    jp, p, c, jc = _params(kind, 4)
    x = np.random.default_rng(4).normal(size=(2, 9, D)).astype(np.float32)
    want, jaux = jmoe.moe_reference(jp, jc, jnp.asarray(x))
    got, aux = moe.moe_reference(p, c, _t(x))
    _close(got, want)
    _close(aux, jaux)


def test_apply_moe_takes_the_reference_path(monkeypatch):
    """One device has no 'model' mesh axis: ``apply_moe`` is
    ``moe_reference``, as the reference's is without a mesh."""
    jp, p, c, jc = _params("gated", 5)
    x = np.random.default_rng(5).normal(size=(1, 6, D)).astype(np.float32)
    want = jmoe.apply_moe(jp, jc, jnp.asarray(x))
    calls = []
    real = moe.moe_reference
    monkeypatch.setattr(moe, "moe_reference",
                        lambda *a: calls.append(1) or real(*a))
    got = moe.apply_moe(p, c, _t(x))
    assert calls == [1]
    _close(got[0], want[0])
    _close(got[1], want[1])


@pytest.mark.parametrize("fn", ["moe_ep", "_local_moe"])
def test_expert_parallel_path_waits(fn):
    """Expert parallelism waits for a mesh: outside any rules ``moe_ep``
    raises; under rules whose mesh splits the experts over 'model' it runs
    (``_local_moe``: the dispatch path, the sequence split over 'model')
    and, at a capacity that drops nothing, gives ``moe_reference``'s
    output (``test_torch_moe_ep.py`` holds it to the reference's
    ``moe_ep``)."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_test_mesh
    _, p, c, _ = _params("gated")
    x = torch.randn(2, 4, D, generator=torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="mesh"):
        moe.moe_ep(p, c, x)
    mesh = make_test_mesh((1, 2), devices=["cpu"] * 2)
    stub = type("C", (), {"n_heads": 0, "n_kv_heads": 0, "head_dim": 0})()
    rules = shd.rules_for(mesh, stub, batch=2, kind="train")
    with shd.axis_rules(rules):
        if fn == "moe_ep":
            y, aux = moe.moe_ep(p, c, x, cap_factor=8.0)
        else:
            lay = shd.ShardLayout(rules)
            ps = shd.local_trees(shd.place_tree(p, shd.param_sharding(
                moe._moe_axes(c))), lay.local)
            blk = [x[:, :2], x[:, 2:]]              # seq over 'model'
            ys, aux, _ = moe._local_moe(lay, ps, c, blk, 8.0)
            y, aux = torch.cat(ys, 1), aux[0]
    want = moe.moe_reference(p, c, x)
    _close(y, want[0])
    _close(aux, want[1])
