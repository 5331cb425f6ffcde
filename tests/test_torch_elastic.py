"""``checkpoint/elastic.py`` against the reference's three elastic cases
(``tests/test_checkpoint.py``), on meshes of logical shards of the CPU,
and a sharded train state restored through ``CheckpointManager`` onto
another mesh, where it trains on as the unsharded state does."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.checkpoint.elastic import (largest_feasible_mesh,  # noqa
                                            reshard_state)
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.checkpoint.serial import _paths  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.data.tokens import random_batch  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.launch.mesh import make_test_mesh  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.optim.sgd import tree_leaves  # noqa: E402
from repro_torch.runtime import trainer as tr  # noqa: E402


def _cpus(n):
    return ["cpu"] * n


def _mesh8():
    return make_test_mesh((4, 2), ("data", "model"), devices=_cpus(8))


def _x_on_mesh8():
    return shd.Placed.put(torch.arange(64.0).reshape(8, 8),
                          shd.NamedSharding(_mesh8(), shd.P("data", "model")))


def test_largest_feasible_mesh_infeasible_counts():
    assert largest_feasible_mesh(list(range(7)), model_divisors={2, 4}) \
        is None
    assert largest_feasible_mesh(list(range(5)), model_divisors={2}) is None
    assert largest_feasible_mesh(list(range(4)), model_divisors=set()) \
        is None
    assert largest_feasible_mesh([], model_divisors={1}) is None


def test_largest_feasible_mesh_prefer_model_edge_cases():
    devs = _cpus(8)
    m = largest_feasible_mesh(devs, model_divisors={1, 2, 4}, prefer_model=2)
    assert m.shape == {"data": 4, "model": 2}
    m = largest_feasible_mesh(devs, model_divisors={1, 2, 4}, prefer_model=3)
    assert m.shape == {"data": 2, "model": 4}
    m = largest_feasible_mesh(devs, model_divisors={2, 3}, prefer_model=3)
    assert m.shape == {"data": 4, "model": 2}


@pytest.mark.parametrize("n,prefer,shape", [(2, 1, {"data": 2, "model": 1}),
                                            (4, 2, {"data": 2, "model": 2})])
def test_elastic_reshard_onto_fewer_devices(tmp_path, n, prefer, shape):
    """Save on (4, 2) and restore onto the survivors: (2, 1) (every split
    dim collapses onto data) or (2, 2); the values survive bit-exactly."""
    x = _x_on_mesh8()
    m = CheckpointManager(str(tmp_path))
    m.save(1, {"w": x})
    mesh = largest_feasible_mesh(_cpus(n), model_divisors={1, 2, 4},
                                 prefer_model=prefer)
    assert mesh.shape == shape
    restored, step = m.restore_latest({"w": x})
    assert step == 1
    out = reshard_state(restored, {"w": ("batch", "mlp")}, mesh)
    assert torch.equal(out["w"].gather(), torch.arange(64.0).reshape(8, 8))
    assert len(out["w"].blocks) == n
    # 'batch' is whole on params; 'mlp' splits over model
    assert tuple(out["w"].sharding.spec) == (None, "model")


def test_reshard_state_takes_placed_leaves_and_fsdp():
    x = _x_on_mesh8()
    mesh = make_test_mesh((2, 2), devices=_cpus(4))
    out = reshard_state({"w": x}, {"w": ("embed", "mlp")}, mesh, fsdp=True)
    assert tuple(out["w"].sharding.spec) == ("data", "model")
    assert torch.equal(out["w"].blocks[1], x.gather()[:4, 4:])


def test_sharded_state_restores_onto_another_mesh_and_trains_on(tmp_path):
    """A (2, 2) Trainer's checkpoint (full arrays) resharded onto (1, 2)
    by ``reshard_state``: bitwise the saved values, and one more step
    there equals the unsharded Trainer's from the same checkpoint."""
    c = base.smoke_config(base.get_config("qwen1.5-0.5b"))
    tcfg = tr.TrainCfg(lr=1e-3, warmup=1, total_steps=8)
    data = lambda step: random_batch(  # noqa: E731
        torch.Generator().manual_seed(step), c.vocab, 4, 16)
    mesh4 = make_test_mesh((2, 2), devices=_cpus(4))
    with shd.axis_rules(shd.rules_for(mesh4, c, batch=4)):
        t = tr.Trainer(c, tcfg, data, device="cpu", ckpt_dir=str(tmp_path),
                       ckpt_every=2, async_ckpt=False)
    t.run(2, log_every=0)
    mgr = CheckpointManager(str(tmp_path))
    plain = tr.Trainer(c, tcfg, data, device="cpu")
    restored, step = mgr.restore_latest(plain.state)
    assert step == 2
    mesh2 = largest_feasible_mesh(_cpus(2), model_divisors={1, 2})
    axes = lm.param_axes(c)
    state = {"params": reshard_state(restored["params"], axes, mesh2),
             "opt": {"m": reshard_state(restored["opt"]["m"], axes, mesh2),
                     "v": reshard_state(restored["opt"]["v"], axes, mesh2),
                     "step": reshard_state(restored["opt"]["step"], (),
                                           mesh2)},
             "step": restored["step"]}
    for a, b in zip(tree_leaves(shd.gather_tree(state)),
                    tree_leaves(shd.gather_tree(t.state))):
        assert torch.equal(a, b)
    with shd.axis_rules(shd.rules_for(mesh2, c, batch=4)):
        t2 = tr.Trainer(c, tcfg, data, device="cpu")
    t2.state, t2._step = state, 2
    m2 = t2.run(1, log_every=0)[-1]
    plain.state, plain._step = restored, 2
    m1 = plain.run(1, log_every=0)[-1]
    np.testing.assert_allclose(m2["loss"], m1["loss"], rtol=1e-5)
    # the k bias's gradient is a cancellation that AdamW's division
    # amplifies (test_torch_trainer.K_BIAS): held to 3 % of the lr
    for (k, a), (_, b) in zip(_paths(shd.gather_tree(t2.state["params"])),
                              _paths(plain.state["params"])):
        err = (a - b).abs().max()
        if k.endswith("attn/wk/b"):
            assert err <= 0.03 * tcfg.lr, k
        else:
            assert err <= 1e-4 * b.abs().max(), k
